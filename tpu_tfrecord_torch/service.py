"""Disaggregated data service: dispatcher, decode workers, trainer
consumers. Copy of ``tpu_tfrecord/service.py`` on the port's modules, with
the same names, wire messages, journal records and rules, so a JAX
dispatcher leases port workers and a port dispatcher leases JAX workers.

Decode CPU scales apart from the accelerator: a **dispatcher** process
owns shard -> worker leasing (``io.paths.interleave_owner`` over the alive
workers, one owner a shard) and nothing else; N **decode workers** read,
decode and pack shards (through the columnar epoch cache when started with
``--cache auto``) and stream length-framed, CRC-stamped chunks
(``service_protocol``) to the consumers; the consumer is an alternative
chunk source of ``TFRecordDataset._chunks`` (``options.service``), so
batches, positions, shuffles and everything downstream are those of a
local read. The workers are host processes and never touch CUDA.

- **Worker death**: workers heartbeat every lease TTL / 3; a worker whose
  heartbeat is older than the TTL, or that a consumer watched fail, loses
  its leases and the shard re-routes (``service.lease_reassignments``).
  Delivery is exactly-once on the consumer's side: it re-requests from
  its acked record offset and drops or slices any redelivered prefix
  (``service.redelivered_dropped``).
- **Dispatcher death**: every mutation of the books is journaled, one
  fsynced delta line (``checkpoint.durable_append``) over a durable
  snapshot line (``checkpoint.durable_write``; both live in the torch-free
  ``durable`` module, so no service process imports torch), compacted every
  ``JOURNAL_COMPACT_EVERY`` appends; a restarted dispatcher replays the
  newest consistent prefix (a torn tail is dropped; a v1 journal, one
  JSON object, replays as a snapshot) and workers re-register through
  their beat loops. A primary whose journal writes fail ``demote_after``
  times in a row, or hit the inode fence of a replaced journal
  (``service.fenced_writes``), demotes itself (``service.demotions``) and
  grants no more leases.
- **Service unreachable**: past ``service_fallback_ms`` without progress
  the consumer reads the shard locally (``service.fallbacks``), the same
  rows; later shards probe the service with one quick attempt.
- **Tenants**: leases are keyed by the dataset's decode fingerprint plus
  its shard list (``tenant_digest``), so jobs over the same data share
  one lease table and one warm worker cache. ``PartitionMap`` hashes
  tenants over K dispatchers; clients and workers parse the ``service``
  address through it.

- **Warm standby**: a dispatcher built with ``standby_of=<primary>``
  tails the primary's journal, answers lease ops with ``not_primary``,
  pings the primary, and after ``takeover_misses`` failed pings (or a
  primary that admits it stopped accepting) promotes itself: the
  generation bumps and the journal is compacted into a new inode, which
  fences a resurrected primary (``service.fenced_writes``,
  ``service.demotions``); then it binds the dead primary's address when it
  can (``service.failovers``).
- **Draining**: ``ServiceDispatcher.drain`` hands a worker's leases back
  for re-routing (``elastic.drained_leases``, planned drift and never a
  reassignment), routes around it, and tells it through its heartbeat to
  finish its streams, say ``goodbye`` (``elastic.drains``) and exit. The
  fleet scaler of ``elastic.py`` drives it.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import socket
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from tpu_tfrecord_torch import telemetry, wire
from tpu_tfrecord_torch import service_protocol as sp
from tpu_tfrecord_torch.columnar import slice_batch
from tpu_tfrecord_torch.io.paths import interleave_owner
from tpu_tfrecord_torch.metrics import METRICS, log_salvage_event, logger

PROTO_VERSION = sp.PROTO_VERSION

#: worker -> dispatcher heartbeat cadence, as a fraction of the lease TTL
#: (3 beats per TTL: one lost datagram never expires a healthy lease).
HEARTBEAT_FRACTION = 3.0

DEFAULT_LEASE_TTL_S = 10.0

#: constructed-dataset cache entries a decode worker keeps (one per job
#: digest); beyond this the oldest job's dataset is evicted.
MAX_CACHED_JOBS = 4

#: journal format version written by this code. v2 is line-oriented:
#: first line a full-state ``snapshot`` record (carrying the fencing
#: ``generation``), then one delta record per mutation, each appended
#: fsync-before-return (``checkpoint.durable_append``). Replay folds the
#: newest consistent prefix — a torn tail (host crash mid-append) is
#: dropped, never fatal. v1 (a single atomically-rewritten JSON object)
#: is still replayed for backward compatibility.
JOURNAL_VERSION = 2

#: delta appends between snapshot compactions (bounds replay cost and
#: keeps the standby's tail cheap).
JOURNAL_COMPACT_EVERY = 256

#: consecutive journal write failures before a primary demotes itself
#: (stops granting leases). An unjournaled primary is worse than a dead
#: one: a standby would take over from a stale journal.
JOURNAL_DEMOTE_AFTER = 3

#: consecutive failed primary pings before a warm standby takes over.
STANDBY_TAKEOVER_MISSES = 3

#: set by faults.install_chaos: every dispatcher-journal write consults
#: this plan under op="journal" (torn_write / sigkill / errors).
_JOURNAL_CHAOS = None


class PartitionMap:
    """The static partition map: K lease-space partitions, each a primary
    dispatcher address plus optional warm standbys, with NO coordination
    service — consumers, workers, and the ``FleetScaler`` all parse the
    same spec string and agree on ownership by rendezvous-hashing the
    tenant digest.

    Spec grammar (the ``service`` option / ``--dispatcher`` flag):

    - ``"host:port"`` — one partition, no standby (the pre-HA form);
    - ``"host:port|host:port2"`` — one partition with a warm standby;
    - ``"h:p1|h:p2,h:p3|h:p4"`` — two partitions, each with a standby;
    - ``"@/path/map.json"`` — read ``{"partitions": [["h:p", ...], ...]}``
      from a file (the fleet-config deployment shape).

    Ownership is highest-random-weight (rendezvous) hashing of
    ``tenant_digest`` over partition indices: deterministic everywhere,
    no ring state, and growing K from N to N+1 remaps only ~1/(N+1) of
    tenants."""

    def __init__(self, partitions: List[List[str]]):
        if not partitions or any(not p for p in partitions):
            raise ValueError("partition map needs >= 1 address per partition")
        self.partitions = [[str(a) for a in p] for p in partitions]
        for group in self.partitions:
            for addr in group:
                sp.parse_addr(addr)  # loud on anything that isn't host:port

    @staticmethod
    def parse(spec: str) -> "PartitionMap":
        spec = str(spec).strip()
        if spec.startswith("@"):
            with open(spec[1:], "rb") as fh:
                obj = json.loads(fh.read().decode("utf-8"))
            return PartitionMap([list(p) for p in obj["partitions"]])
        return PartitionMap(
            [
                [a.strip() for a in part.split("|") if a.strip()]
                for part in spec.split(",")
                if part.strip()
            ]
        )

    @property
    def k(self) -> int:
        return len(self.partitions)

    def partition_for(self, tenant: str) -> int:
        """Rendezvous hash: the partition whose (index, tenant) score is
        highest owns the tenant's lease space. Same inputs, same owner,
        on every consumer/worker/scaler — no coordination needed."""
        return max(
            range(len(self.partitions)),
            key=lambda i: hashlib.sha256(
                f"{i}|{tenant}".encode()
            ).digest(),
        )

    def addrs(self, partition: int) -> List[str]:
        """Primary first, then standbys, for one partition."""
        return list(self.partitions[partition])

    def to_spec(self) -> str:
        return ",".join("|".join(p) for p in self.partitions)


class _ConnTracker:
    """Live accepted-connection registry for a serving loop: ``stop`` must
    close every open connection, not just the listener — a process death
    closes all fds at once, and an in-process stop() (tests, clean
    shutdown) has to look the same to peers AND release the port for an
    immediate same-port restart."""

    def __init__(self):
        self._lock = threading.Lock()
        self._conns: set = set()

    def track(self, conn: socket.socket) -> None:
        with self._lock:
            self._conns.add(conn)

    def untrack(self, conn: socket.socket) -> None:
        with self._lock:
            self._conns.discard(conn)

    def close_all(self) -> None:
        with self._lock:
            conns = list(self._conns)
            self._conns.clear()
        for c in conns:
            try:
                c.close()
            except OSError:
                pass


class ServiceUnavailable(ConnectionError):
    """The dispatcher answered but cannot serve (e.g. no alive workers) —
    transport-shaped, so consumer retry/fallback nets handle it."""


class ServiceSpecError(RuntimeError):
    """Worker and consumer disagree about the dataset (shard list digest,
    fused-decode availability). Loud by design: divergent views of the
    data must never be papered over by a fallback."""


def shards_digest(shards) -> str:
    """Identity of the GLOBAL shard list ((path, size) pairs, discovery
    order) — consumer and worker must agree before any bytes flow."""
    blob = json.dumps(
        [(sh.path, sh.size) for sh in shards], sort_keys=True
    ).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


def build_job_spec(ds) -> Dict[str, Any]:
    """Everything a decode worker needs to reproduce this dataset's chunk
    stream byte-for-byte: source paths, the RESOLVED schema (no inference
    divergence), requested columns, decode fusions, corruption policy, and
    the global shard-list digest. Options that only change how chunks are
    produced locally (prefetch, workers, mmap, readahead, stall
    thresholds) are deliberately absent — they are the worker's own
    business."""
    opts = ds.options
    spec: Dict[str, Any] = {
        "proto": PROTO_VERSION,
        "paths": ds.source_paths,
        "columns": [f.name for f in ds.schema],
        "schema": ds._reader.schema().to_json(),
        "record_type": opts.record_type.value,
        "verify_crc": opts.verify_crc,
        "on_corrupt": opts.on_corrupt,
        "max_corrupt_records": opts.max_corrupt_records,
        "corrupt_fallback": opts.corrupt_fallback,
        "on_stall": opts.on_stall,
        "batch_size": ds.batch_size,
        "slab_bytes": ds.slab_bytes,
        "max_record_bytes": ds.max_record_bytes,
        "hash_buckets": ds.hash_buckets,
        "pack": ds.pack,
        "shards_digest": shards_digest(ds._reader.shards),
        "tenant": tenant_digest(ds),
    }
    if ds.hash_buckets or ds.pack:
        # fused decode changes which COLUMNS a chunk carries (members fold
        # into group matrices) — both sides must agree. Both routes of the
        # port fuse, as the JAX package's native route does.
        spec["fused"] = True
    return spec


def job_digest(spec: Dict[str, Any]) -> str:
    return hashlib.sha256(
        json.dumps(spec, sort_keys=True).encode()
    ).hexdigest()[:16]


def tenant_digest(ds) -> str:
    """The multi-tenant sharing key: everything that changes decoded
    chunk CONTENT (the dataset's cache fingerprint — the same identity
    the columnar epoch cache keys entries by) plus the global shard
    list. Two jobs that differ only in consumption shape (batch size,
    prefetch, workers, resume point) produce the SAME tenant and share
    one lease table and one warm cache fleet-wide; anything that changes
    the rows themselves isolates them."""
    ident = dict(ds._cache_ident())
    ident["shards"] = shards_digest(ds._reader.shards)
    return hashlib.sha256(
        json.dumps(ident, sort_keys=True).encode()
    ).hexdigest()[:16]


# ---------------------------------------------------------------------------
# Dispatcher
# ---------------------------------------------------------------------------


class _WorkerInfo:
    __slots__ = ("worker_id", "addr", "pid", "beat")

    def __init__(self, worker_id: str, addr: str, pid: int, beat: float):
        self.worker_id = worker_id
        self.addr = addr
        self.pid = pid
        self.beat = beat


class ServiceDispatcher:
    """Owns shard->worker leasing and nothing else — no data bytes ever
    flow through it. All mutable assignment state (workers, leases, done
    set, reassignment count, trace identity) is journaled on every
    mutation — one fsynced delta line via ``checkpoint.durable_append``
    over a durable snapshot line — so a crash loses at most the
    heartbeat freshness (which workers re-supply within one TTL). The
    same instance is also the partition's warm STANDBY when built with
    ``standby_of=<primary addr>``: it tails the shared journal, rejects
    lease-path ops with ``not_primary``, and promotes itself (generation
    bump = zombie fence) when the primary stops answering pings.

    Lease model: ``route`` picks the owner among the ALIVE workers with the
    interleaved assignment (``interleave_owner`` over the sorted alive
    list — the same one owner per-host shard selection uses). A re-route
    of a leased shard counts as a reassignment only when the previous
    lessee is dead or explicitly excluded by the consumer that watched it
    die; assignment drift from fleet growth is rebalancing, not failure.
    """

    def __init__(
        self,
        port: int = 0,
        host: str = "127.0.0.1",
        journal: Optional[str] = None,
        lease_ttl_s: float = DEFAULT_LEASE_TTL_S,
        clock=time.monotonic,
        standby_of: Optional[str] = None,
        partition_index: int = 0,
        generation: int = 0,
        demote_after: int = JOURNAL_DEMOTE_AFTER,
        takeover_misses: int = STANDBY_TAKEOVER_MISSES,
        ping_interval_s: Optional[float] = None,
        takeover_addr: bool = True,
    ):
        if lease_ttl_s <= 0:
            raise ValueError("lease_ttl_s must be > 0")
        if standby_of is not None and journal is None:
            raise ValueError(
                "a standby needs the primary's journal path to tail"
            )
        self.lease_ttl_s = float(lease_ttl_s)
        self.journal = journal
        self._clock = clock
        self._lock = threading.Lock()
        self._workers: Dict[str, _WorkerInfo] = {}
        self._leases: Dict[str, str] = {}  # "tenant/shard_path" -> worker_id
        self._done: Dict[str, str] = {}
        self._reassignments = 0
        # workers marked for graceful scale-down (wid -> drain-marked-at):
        # excluded from new routes, expected to goodbye once idle
        self._draining: Dict[str, float] = {}
        # tenant (decode fingerprint) -> sharing bookkeeping: which
        # consumers/jobs ride this lease table, and how many shard
        # completions the warm cache absorbed
        self._tenants: Dict[str, Dict[str, Any]] = {}
        #: written by an attached elastic.FleetScaler (or published by a
        #: remote one over the ``scaler_status`` op); surfaced in status()
        self.scaler_status: Optional[Dict[str, Any]] = None
        # -- HA state (partitioning + failover + fencing) ------------------
        self.partition_index = int(partition_index)
        self.generation = int(generation)
        #: None = acting primary; an address = warm standby tailing that
        #: primary's journal, promoting itself on heartbeat loss
        self._standby_of = str(standby_of) if standby_of is not None else None
        self._role = "standby" if standby_of is not None else "dispatcher"
        self.failed_over = False
        #: True once journal writes failed ``demote_after`` times in a row
        #: (or were fenced): a demoted primary grants NO leases — a
        #: standby promoted off the journal must never race live state
        #: that was silently running unjournaled
        self._demoted = False
        self._demote_after = max(1, int(demote_after))
        self._journal_fail_streak = 0
        #: a failed append leaves an undefined tail on disk: the next
        #: successful write must be a full snapshot compaction
        self._journal_dirty = False
        self._journal_ino: Optional[int] = None
        self._appends_since_compact = 0
        self._takeover_misses = max(1, int(takeover_misses))
        self.ping_interval_s = (
            float(ping_interval_s)
            if ping_interval_s is not None
            else min(1.0, self.lease_ttl_s / 4.0)
        )
        self._takeover_addr = bool(takeover_addr)
        self._extra_srvs: List[socket.socket] = []
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._conns = _ConnTracker()
        self._ctx = telemetry.current_context().with_role(self._role)
        if journal is not None and os.path.exists(journal):
            self._replay_journal(journal)
        if journal is not None and self._standby_of is None:
            # a PRIMARY compacts at birth: one fresh fsynced snapshot
            # carrying its generation, so standbys tail a well-formed v2
            # journal from the first byte (and a replayed v1 journal is
            # upgraded in place)
            with self._lock:
                self._compact_locked()
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, port))
        self._srv.listen(64)
        self.addr = sp.format_addr(host, self._srv.getsockname()[1])

    # -- journal ------------------------------------------------------------
    #
    # v2 layout: line 1 is a full-state ``snapshot`` record (carrying the
    # fencing generation), every later line one delta record, each landed
    # with ``checkpoint.durable_append`` (fsync before return) so committed
    # records survive a host crash. Replay folds the NEWEST CONSISTENT
    # PREFIX: a torn final line — crash or injected torn_write mid-append —
    # is dropped, and anything after an unparseable record is ignored
    # (records after a tear were written by a writer that already knew its
    # append failed; the compact-on-next-write rule below repairs the file
    # before they could exist). A v1 journal (single JSON object, no
    # ``kind``) replays as a generation-0 snapshot.

    def _replay_journal(self, path: str) -> None:
        """Restore assignment state from the journal. Journaled workers
        get a fresh heartbeat grace of one TTL — they must re-heartbeat
        (their loop re-registers on ``known: false``) or they expire
        exactly like a SIGKILLed worker. The journaled trace identity is
        re-adopted so the restarted (or promoted) dispatcher stays part
        of the same logical run. Also the standby's continuous catch-up
        path: each tail tick re-reads and re-folds (journals are snapshot
        + a bounded delta tail, so a full re-fold is cheap). Either
        package's journal replays here: the records are the same."""
        try:
            with open(path, "rb") as fh:
                data = fh.read()
        except OSError as e:
            raise RuntimeError(f"unreadable dispatcher journal {path}: {e}")
        records = self._parse_journal(data)
        now = self._clock()
        trace = None
        with self._lock:
            self._reset_state_locked()
            for obj in records:
                t = self._fold_locked(obj, now)
                if t is not None:
                    trace = t
        if isinstance(trace, dict):
            self._ctx = telemetry.adopt(
                telemetry.TraceContext.from_json(trace).with_role(self._role)
            )

    @staticmethod
    def _parse_journal(data: bytes) -> List[Dict[str, Any]]:
        """Decode journal bytes to the newest consistent record prefix.
        Empty -> no records. A whole-file JSON object (v1, written without
        a trailing newline) -> one legacy snapshot. Otherwise v2 lines:
        fold complete (newline-terminated) lines in order and STOP at the
        first torn/unparseable one — replay-to-consistent-prefix, the
        contract the truncation tests pin."""
        if not data.strip():
            return []
        try:
            whole = json.loads(data.decode("utf-8"))
        except (ValueError, UnicodeDecodeError):
            whole = None
        if isinstance(whole, dict) and whole.get("kind") is None:
            return [dict(whole, kind="snapshot")]  # v1 full-state object
        records: List[Dict[str, Any]] = []
        lines = data.split(b"\n")
        complete, tail = lines[:-1], lines[-1]
        for raw in complete:
            try:
                obj = json.loads(raw.decode("utf-8"))
            except (ValueError, UnicodeDecodeError):
                break  # mid-journal tear: keep the consistent prefix
            if not isinstance(obj, dict) or "kind" not in obj:
                break
            records.append(obj)
        # ``tail`` is bytes after the last newline: a torn final record
        # (the fsync'd newline never landed) — dropped by construction
        del tail
        return records

    def _reset_state_locked(self) -> None:
        self._workers = {}
        self._leases = {}
        self._done = {}
        self._reassignments = 0
        self._draining = {}
        self._tenants = {}

    def _tenant_fold_locked(self, tenant: str) -> Dict[str, Any]:
        info = self._tenants.get(tenant)
        if info is None:
            info = self._tenants[tenant] = {
                "consumers": set(), "jobs": set(),
                "shared_cache_hits": 0, "completions": 0,
            }
        return info

    def _fold_locked(self, obj: Dict[str, Any], now: float):
        """Apply one journal record to the assignment books. Returns the
        trace dict when the record carries one (snapshot), else None."""
        kind = obj.get("kind")
        if kind == "snapshot":
            self._reset_state_locked()
            self.generation = max(self.generation, int(obj.get("generation", 0)))
            for wid, info in dict(obj.get("workers", {})).items():
                self._workers[str(wid)] = _WorkerInfo(
                    str(wid), str(info["addr"]), int(info.get("pid", 0)), now
                )
            self._leases = {
                str(k): str(v) for k, v in dict(obj.get("leases", {})).items()
            }
            self._done = {
                str(k): str(v) for k, v in dict(obj.get("done", {})).items()
            }
            self._reassignments = int(obj.get("reassignments", 0))
            self._draining = {
                str(w): now
                for w in obj.get("draining", [])
                if str(w) in self._workers
            }
            for t, info in dict(obj.get("tenants", {})).items():
                self._tenants[str(t)] = {
                    "consumers": set(info.get("consumers", [])),
                    "jobs": set(info.get("jobs", [])),
                    "shared_cache_hits": int(info.get("shared_cache_hits", 0)),
                    "completions": int(info.get("completions", 0)),
                }
            return obj.get("trace")
        if kind == "register":
            wid = str(obj["worker_id"])
            self._workers[wid] = _WorkerInfo(
                wid, str(obj["addr"]), int(obj.get("pid", 0)), now
            )
            self._draining.pop(wid, None)
        elif kind == "drain":
            wid = str(obj["worker_id"])
            if wid in self._workers:
                self._draining[wid] = now
            for k in [k for k, v in self._leases.items() if v == wid]:
                del self._leases[k]
        elif kind == "goodbye":
            wid = str(obj["worker_id"])
            self._workers.pop(wid, None)
            self._draining.pop(wid, None)
            for k in [k for k, v in self._leases.items() if v == wid]:
                del self._leases[k]
        elif kind == "lease":
            key = str(obj["key"])
            self._leases[key] = str(obj["worker_id"])
            self._reassignments += int(obj.get("reassigned", 0))
            info = self._tenant_fold_locked(key.split("/", 1)[0])
            if obj.get("consumer") and len(info["consumers"]) < 1024:
                info["consumers"].add(str(obj["consumer"]))
            if obj.get("job") and len(info["jobs"]) < 1024:
                info["jobs"].add(str(obj["job"]))
        elif kind == "done":
            key = str(obj["key"])
            self._leases.pop(key, None)
            self._done.setdefault(key, str(obj.get("worker_id", "")))
            info = self._tenant_fold_locked(key.split("/", 1)[0])
            info["completions"] += 1
            if obj.get("cached"):
                info["shared_cache_hits"] += 1
        # unknown kinds fold to nothing: a NEWER writer's record types
        # must not break an older replayer's consistent prefix
        return None

    def _snapshot_payload_locked(self) -> Dict[str, Any]:
        return {
            "kind": "snapshot",
            "version": JOURNAL_VERSION,
            "generation": self.generation,
            "lease_ttl_s": self.lease_ttl_s,
            "partition": self.partition_index,
            "workers": {
                w.worker_id: {"addr": w.addr, "pid": w.pid}
                for w in self._workers.values()
            },
            "leases": self._leases,
            "done": self._done,
            "reassignments": self._reassignments,
            "draining": sorted(self._draining),
            "tenants": {
                t: {
                    "consumers": sorted(info["consumers"]),
                    "jobs": sorted(info["jobs"]),
                    "shared_cache_hits": info["shared_cache_hits"],
                    "completions": info["completions"],
                }
                for t, info in self._tenants.items()
            },
            "trace": self._ctx.to_json(),
        }

    def _compact_locked(self) -> None:
        """Rewrite the journal as one fresh snapshot line — durably
        (fsync-before-rename via ``checkpoint.durable_write``: a restart
        depends on journal bytes surviving a host crash) and atomically
        (``os.replace`` gives the file a NEW inode, which is the fence: a
        zombie primary's next ``durable_append`` sees the inode change and
        is rejected before any stale byte lands)."""
        from tpu_tfrecord_torch import durable

        if self.journal is None:
            return
        line = (
            json.dumps(self._snapshot_payload_locked(), sort_keys=True).encode()
            + b"\n"
        )
        plan = _JOURNAL_CHAOS
        if plan is not None:
            plan.apply_journal(self.journal, line)
        durable.durable_write(self.journal, line)
        self._journal_ino = os.stat(self.journal).st_ino
        self._appends_since_compact = 0
        self._journal_dirty = False
        self._journal_fail_streak = 0

    def _journal_event_locked(self, event: Dict[str, Any]) -> None:
        """Land one mutation record. Primaries only — a standby reads the
        journal, never writes it. Failure policy: count every failure;
        after ``demote_after`` CONSECUTIVE failures, or a single fenced
        write (the file was replaced by a promoted standby), demote — stop
        granting leases rather than keep running unjournaled under a
        standby that would recover stale state."""
        from tpu_tfrecord_torch import durable

        if self.journal is None or self._standby_of is not None or self._demoted:
            return
        try:
            if self._journal_dirty:
                # the previous append failed partway: the on-disk tail is
                # undefined, so the next durable write must be a full
                # snapshot (which also covers this event's mutation)
                self._compact_locked()
                return
            line = json.dumps(event, sort_keys=True).encode() + b"\n"
            plan = _JOURNAL_CHAOS
            if plan is not None:
                plan.apply_journal(self.journal, line)
            self._journal_ino = durable.durable_append(
                self.journal, line, expect_ino=self._journal_ino
            )
            self._journal_fail_streak = 0
            self._appends_since_compact += 1
            if self._appends_since_compact >= JOURNAL_COMPACT_EVERY:
                self._compact_locked()
        except durable.FencedWriteError as e:
            # a promoted standby owns this journal now: one stale write
            # attempt is all a zombie gets before it stops serving
            METRICS.count("service.fenced_writes")
            self._demote_locked("fenced", e)
        except OSError as e:
            METRICS.count("service.journal_errors")
            self._journal_dirty = True
            self._journal_fail_streak += 1
            logger.warning("dispatcher journal write failed: %s", e)
            if self._journal_fail_streak >= self._demote_after:
                self._demote_locked("journal_errors", e)

    def _demote_locked(self, reason: str, err: BaseException) -> None:
        if self._demoted:
            return
        self._demoted = True
        METRICS.count("service.demotions")
        logger.warning(
            "dispatcher demoted (%s): no further leases will be granted "
            "(last error: %s)", reason, err,
        )
        telemetry.instant("service.demoted", reason=reason, error=str(err))

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "ServiceDispatcher":
        t = threading.Thread(target=self._accept_loop, daemon=True)
        t.start()
        self._threads.append(t)
        if self._standby_of is not None:
            s = threading.Thread(target=self._standby_loop, daemon=True)
            s.start()
            self._threads.append(s)
        return self

    def stop(self) -> None:
        self._stop.set()
        try:
            self._srv.close()
        except OSError:
            pass
        for srv in self._extra_srvs:
            try:
                srv.close()
            except OSError:
                pass
        self._conns.close_all()
        # Wait out the accept thread: while it is blocked in accept(2) the
        # kernel keeps the listening socket's file description — and the
        # PORT — alive past close(), and a same-port restart (the
        # dispatcher-crash story) would race EADDRINUSE against its 0.2s
        # poll. Bounded: the poll timeout guarantees exit.
        for t in self._threads:
            if t is not threading.current_thread():
                t.join(timeout=2.0)

    def __enter__(self) -> "ServiceDispatcher":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def _accept_loop(self, srv: Optional[socket.socket] = None) -> None:
        srv = srv if srv is not None else self._srv
        try:
            srv.settimeout(0.2)
        except OSError:
            return  # stop() closed the listener before we first polled
        while not self._stop.is_set():
            try:
                conn, _peer = srv.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            sp.enable_nodelay(conn)
            self._conns.track(conn)
            threading.Thread(
                target=self._serve_conn, args=(conn,), daemon=True
            ).start()

    def _serve_conn(self, conn: socket.socket) -> None:
        peer = "client"
        try:
            conn.settimeout(max(1.0, self.lease_ttl_s * 4))
            while not self._stop.is_set():
                msg = sp.recv_msg(conn, peer, allow_eof=True)
                if msg is None:
                    return
                sp.send_msg(conn, self._handle(msg))
        except (OSError, sp.ProtocolError):
            return
        finally:
            self._conns.untrack(conn)
            try:
                conn.close()
            except OSError:
                pass

    # -- warm standby / failover --------------------------------------------

    def _standby_loop(self) -> None:
        """The warm-standby tick: tail the primary's journal (the
        journal replay path reused for continuous catch-up — full re-fold of
        snapshot + bounded delta tail), then ping the primary. After
        ``takeover_misses`` consecutive failed pings — or a primary that
        answers but admits it stopped accepting (demoted) — promote.
        All waits ride the stop event (the injectable-wait seam);
        cadence is ``ping_interval_s``."""
        misses = 0
        while not self._stop.wait(self.ping_interval_s):
            if self._standby_of is None:
                return  # promoted by an external call
            try:
                if os.path.exists(self.journal):
                    self._replay_journal(self.journal)
            except RuntimeError:
                pass  # transiently unreadable: keep last good fold
            if self._ping_primary():
                misses = 0
                continue
            misses += 1
            if misses >= self._takeover_misses:
                self.promote()
                return

    def _ping_primary(self) -> bool:
        addr = self._standby_of
        if addr is None:
            return True
        try:
            conn = sp.connect(addr, timeout=max(0.2, self.ping_interval_s))
            try:
                conn.settimeout(max(0.2, self.ping_interval_s))
                reply = sp.request(
                    conn, addr, {"op": "ping", "proto": PROTO_VERSION}
                )
            finally:
                try:
                    conn.close()
                except OSError:
                    pass
        except (OSError, sp.ProtocolError):
            return False
        # a primary that answers but no longer accepts (demoted after
        # journal failures, or fenced) is DOWN for takeover purposes
        return bool(reply.get("ok")) and bool(reply.get("accepting", True))

    def promote(self) -> None:
        """Standby -> acting primary. Bumps the generation and compacts
        the journal (``durable_write`` -> new inode), which IS the fence:
        the dead primary resurrected as a zombie fails its next append on
        the inode change, counts ``service.fenced_writes``, and demotes.
        Then best-effort takes over the dead primary's advertised address
        (clients that never learned the standby's address reconnect to
        the same host:port); clients that DO know it ride their partition
        map's address rotation either way."""
        with self._lock:
            if self._standby_of is None:
                return
            primary_addr = self._standby_of
            self._standby_of = None
            self._role = "dispatcher"
            self.failed_over = True
            self._demoted = False
            self.generation += 1
            try:
                self._compact_locked()
            except OSError as e:
                # promotion must not die on a journal hiccup — the next
                # mutation retries the compaction via the dirty flag
                METRICS.count("service.journal_errors")
                self._journal_dirty = True
                logger.warning("promotion compaction failed: %s", e)
        self._ctx = telemetry.adopt(self._ctx.with_role("dispatcher"))
        METRICS.count("service.failovers")
        METRICS.gauge("service.partition", float(self.partition_index))
        telemetry.instant(
            "service.failover",
            partition=self.partition_index,
            generation=self.generation,
            old_primary=primary_addr,
            addr=self.addr,
        )
        logger.warning(
            "standby took over partition %d (generation %d, old primary %s)",
            self.partition_index, self.generation, primary_addr,
        )
        if self._takeover_addr:
            self._adopt_address(primary_addr)

    def _adopt_address(self, addr: str) -> None:
        """Best-effort bind of the dead primary's advertised host:port as
        an ADDITIONAL accept socket. On the same host this succeeds the
        moment the primary's listener dies (SO_REUSEADDR); across hosts
        (or while a zombie still holds the port) it fails quietly —
        partition-map address rotation covers those clients."""
        try:
            host, port = sp.parse_addr(addr)
            srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            srv.bind((host, port))
            srv.listen(64)
        except OSError as e:
            logger.warning(
                "could not take over advertised address %s: %s", addr, e
            )
            return
        self._extra_srvs.append(srv)
        t = threading.Thread(
            target=self._accept_loop, args=(srv,), daemon=True
        )
        t.start()
        self._threads.append(t)
        telemetry.instant("service.failover", adopted_addr=addr,
                          partition=self.partition_index,
                          generation=self.generation)

    # -- request handling ---------------------------------------------------

    def _handle(self, msg: Dict[str, Any]) -> Dict[str, Any]:
        op = msg.get("op")
        if msg.get("proto", PROTO_VERSION) != PROTO_VERSION:
            return {"error": "proto_mismatch", "proto": PROTO_VERSION}
        try:
            if op in ("route", "shard_done", "drain") and not self.accepting:
                # a standby (or a demoted zombie) grants NOTHING: route
                # and completion records belong to the acting primary's
                # journal. Workers' register/heartbeat still land (the
                # standby keeps fleet freshness warm for takeover) and
                # status/ping answer honestly.
                METRICS.count("service.not_primary_rejects")
                return {
                    "error": "not_primary",
                    "role": self._role,
                    "demoted": self._demoted,
                    "primary": self._standby_of,
                }
            if op == "register_worker":
                return self._op_register(msg)
            if op == "heartbeat":
                return self._op_heartbeat(msg)
            if op == "route":
                return self._op_route(msg)
            if op == "shard_done":
                return self._op_shard_done(msg)
            if op == "goodbye":
                return self._op_goodbye(msg)
            if op == "drain":
                return {"ok": True,
                        "drained": self.drain(str(msg["worker_id"]))}
            if op == "scaler_status":
                # a federated FleetScaler running elsewhere publishes its
                # verdict here so serve-status shows it on every partition
                st = msg.get("status")
                self.scaler_status = dict(st) if isinstance(st, dict) else None
                return {"ok": True}
            if op == "status":
                return self.status()
            if op == "ping":
                return {"ok": True, "role": self._role,
                        "accepting": self.accepting,
                        "generation": self.generation}
            return {"error": f"unknown op {op!r}"}
        except (KeyError, TypeError, ValueError) as e:
            return {"error": f"malformed {op!r} request: {e}"}

    @property
    def accepting(self) -> bool:
        """Is this process the acting, non-demoted primary for its
        partition — the only state in which leases may be granted?"""
        return self._standby_of is None and not self._demoted

    def _alive_locked(self, now: float) -> List[str]:
        return sorted(
            w.worker_id
            for w in self._workers.values()
            if now - w.beat <= self.lease_ttl_s
        )

    def _op_register(self, msg: Dict[str, Any]) -> Dict[str, Any]:
        wid = str(msg["worker_id"])
        with self._lock:
            self._workers[wid] = _WorkerInfo(
                wid, str(msg["addr"]), int(msg.get("pid", 0)), self._clock()
            )
            # a re-registering worker is a FRESH worker (restart, or a
            # journal-replayed identity coming back): any old drain mark
            # belonged to its previous life
            self._draining.pop(wid, None)
            self._journal_event_locked(
                {"kind": "register", "worker_id": wid,
                 "addr": str(msg["addr"]), "pid": int(msg.get("pid", 0))}
            )
        return {
            "ok": True,
            "worker_id": wid,
            "lease_ttl_s": self.lease_ttl_s,
            "trace": self._ctx.to_json(),
        }

    def _op_heartbeat(self, msg: Dict[str, Any]) -> Dict[str, Any]:
        wid = str(msg["worker_id"])
        with self._lock:
            info = self._workers.get(wid)
            if info is not None:
                info.beat = self._clock()
            drain = wid in self._draining
        # known=False sends the worker back through register (the
        # journal-less restart path); drain=True tells the worker to
        # finish its in-flight streams, say goodbye, and exit
        return {"ok": True, "known": info is not None, "drain": drain}

    def drain(self, worker_id: str) -> bool:
        """Mark one worker draining (the elastic scale-down path): its
        current leases are handed back for re-routing (planned drift —
        never counted as a lease_reassignment), new routes exclude it,
        and its heartbeat replies carry ``drain: true`` until it says
        goodbye. Returns False for an unknown or already-draining
        worker."""
        wid = str(worker_id)
        with self._lock:
            if wid not in self._workers or wid in self._draining:
                return False
            self._draining[wid] = self._clock()
            released = [k for k, v in self._leases.items() if v == wid]
            for k in released:
                del self._leases[k]
            self._journal_event_locked({"kind": "drain", "worker_id": wid})
        if released:
            METRICS.count("elastic.drained_leases", len(released))
        telemetry.instant(
            "elastic.drain", worker=wid, released_leases=len(released)
        )
        return True

    def _op_goodbye(self, msg: Dict[str, Any]) -> Dict[str, Any]:
        """A draining worker finished its streams and is exiting cleanly:
        drop it from the books entirely (it is neither alive nor dead —
        it is GONE, the same way a finished process never joins the fleet
        doctor's dead list)."""
        wid = str(msg["worker_id"])
        with self._lock:
            known = self._workers.pop(wid, None) is not None
            was_draining = self._draining.pop(wid, None) is not None
            for k in [k for k, v in self._leases.items() if v == wid]:
                del self._leases[k]
            self._journal_event_locked({"kind": "goodbye", "worker_id": wid})
        if known and was_draining:
            METRICS.count("elastic.drains")
            telemetry.instant("elastic.drain_complete", worker=wid)
        return {"ok": True, "known": known}

    def _tenant_locked(self, msg: Dict[str, Any]) -> str:
        """Resolve the lease-table key space for one request: the
        consumer's tenant (decode fingerprint — jobs that share it share
        leases and the warm cache) with the job digest as the fallback
        for tenant-less peers. Tracks which consumers/jobs ride each
        tenant for the serve-status picture."""
        tenant = str(msg.get("tenant") or msg["job"])
        info = self._tenants.get(tenant)
        if info is None:
            info = self._tenants[tenant] = {
                "consumers": set(), "jobs": set(),
                "shared_cache_hits": 0, "completions": 0,
            }
            METRICS.count("service.tenants")
        consumer = msg.get("consumer")
        if consumer and len(info["consumers"]) < 1024:
            # bounded: every short-lived iterator mints a fresh consumer
            # id, and this census set rides the journal — a long-lived
            # dispatcher must not grow it without limit (the count
            # saturates at the cap; leases/done are the real state)
            info["consumers"].add(str(consumer))
        if msg.get("job") and len(info["jobs"]) < 1024:
            info["jobs"].add(str(msg["job"]))
        return tenant

    def _op_route(self, msg: Dict[str, Any]) -> Dict[str, Any]:
        shard_path = str(msg["path"])
        shard_index = int(msg["shard_index"])
        exclude = {str(w) for w in msg.get("exclude", [])}
        with self._lock:
            tenant = self._tenant_locked(msg)
            key = f"{tenant}/{shard_path}"
            now = self._clock()
            alive = self._alive_locked(now)
            # draining workers take no NEW shards — they are finishing
            # what they already serve; consumer-witnessed suspects next
            serving = [w for w in alive if w not in self._draining]
            candidates = [w for w in serving if w not in exclude]
            if not candidates:
                candidates = [w for w in alive if w not in exclude]
            if not candidates:
                # every alive worker is excluded: better a possibly-flaky
                # (or draining) worker than no route at all (the
                # consumer's fallback budget still bounds the pain)
                candidates = alive
            if not candidates:
                return {"error": "no_workers"}
            wid = candidates[interleave_owner(shard_index, len(candidates))]
            trace = msg.get("trace")
            if isinstance(trace, dict):
                # the dispatcher's half of the consumer's service.lease
                # span: one instant linked by the lease span's id, so the
                # merged timeline shows WHO routed this lease and when
                telemetry.instant(
                    "service.route",
                    shard=shard_path, worker=wid,
                    trace_id=trace.get("trace_id"),
                    parent_span_id=trace.get("span_id"),
                )
            prev = self._leases.get(key)
            reassigned = False
            if prev is not None and prev != wid:
                if prev not in alive or prev in exclude:
                    reassigned = True
                    self._reassignments += 1
                    METRICS.count("service.lease_reassignments")
                    telemetry.instant(
                        "service.lease_reassigned",
                        shard=shard_path, from_worker=prev, to_worker=wid,
                    )
            if prev != wid:
                self._leases[key] = wid
                self._journal_event_locked(
                    {"kind": "lease", "key": key, "worker_id": wid,
                     "reassigned": int(reassigned),
                     "consumer": msg.get("consumer"), "job": msg.get("job")}
                )
            return {
                "ok": True,
                "worker": self._workers[wid].addr,
                "worker_id": wid,
                # the dispatcher's REAL ttl, so consumers age their
                # suspect lists on the fleet's actual reassignment clock
                # rather than trusting a local option to match it
                "lease_ttl_s": self.lease_ttl_s,
            }

    def _op_shard_done(self, msg: Dict[str, Any]) -> Dict[str, Any]:
        with self._lock:
            tenant = self._tenant_locked(msg)
            key = f"{tenant}/{msg['path']}"
            wid = self._leases.pop(key, None) or str(msg.get("worker_id", ""))
            if key not in self._done:
                self._done[key] = wid
                METRICS.count("service.shards_done")
            info = self._tenants[tenant]
            info["completions"] += 1
            if msg.get("cached"):
                # the worker served this shard entirely from the warm
                # columnar cache (reported on its eof): the fleet-wide
                # pay-decode-once payoff, made countable
                info["shared_cache_hits"] += 1
                METRICS.count("service.shared_cache_hits")
            self._journal_event_locked(
                {"kind": "done", "key": key, "worker_id": wid,
                 "cached": bool(msg.get("cached")),
                 "consumer": msg.get("consumer"), "job": msg.get("job")}
            )
        return {"ok": True}

    def status(self) -> Dict[str, Any]:
        """The serve-status picture: one entry per worker (lease count,
        shards done, heartbeat age) + service totals."""
        with self._lock:
            now = self._clock()
            alive = set(self._alive_locked(now))
            done_by: Dict[str, int] = {}
            for wid in self._done.values():
                done_by[wid] = done_by.get(wid, 0) + 1
            leases_by: Dict[str, List[str]] = {}
            for key, wid in self._leases.items():
                leases_by.setdefault(wid, []).append(key.split("/", 1)[1])
            workers = [
                {
                    "worker_id": w.worker_id,
                    "addr": w.addr,
                    "pid": w.pid,
                    "alive": w.worker_id in alive,
                    "draining": w.worker_id in self._draining,
                    "heartbeat_age_s": round(now - w.beat, 3),
                    "leases": sorted(leases_by.get(w.worker_id, [])),
                    "shards_done": done_by.get(w.worker_id, 0),
                }
                for w in sorted(self._workers.values(), key=lambda w: w.worker_id)
            ]
            tenants = {
                t: {
                    "consumers": len(info["consumers"]),
                    "jobs": len(info["jobs"]),
                    "leases": sum(
                        1 for k in self._leases if k.startswith(t + "/")
                    ),
                    "shards_done": sum(
                        1 for k in self._done if k.startswith(t + "/")
                    ),
                    "completions": info["completions"],
                    "shared_cache_hits": info["shared_cache_hits"],
                }
                for t, info in sorted(self._tenants.items())
            }
            out = {
                "ok": True,
                "role": self._role,
                "addr": self.addr,
                "partition": self.partition_index,
                "generation": self.generation,
                "accepting": self._standby_of is None and not self._demoted,
                "demoted": self._demoted,
                "failed_over": self.failed_over,
                "standby_of": self._standby_of,
                "lease_ttl_s": self.lease_ttl_s,
                "workers": workers,
                "alive": len(alive),
                "draining": sorted(self._draining),
                "tenants": tenants,
                "shards_done": len(self._done),
                "active_leases": len(self._leases),
                "lease_reassignments": self._reassignments,
                "trace_id": self._ctx.trace_id,
            }
            if self.scaler_status is not None:
                out["scaler"] = self.scaler_status
            return out


# ---------------------------------------------------------------------------
# Decode worker
# ---------------------------------------------------------------------------


class DecodeWorker:
    """One decode process: registers with the dispatcher (adopting the
    dispatcher's trace as its parent, so spool snapshots and merged
    timelines correlate), heartbeats at TTL/3, and serves ``fetch``
    requests by streaming a shard's decoded chunks — through the columnar
    epoch cache when the worker has one configured (serve on hit,
    ``CachePopulator`` atomic staging on miss), exactly like a local read.

    ``options`` carries the WORKER-LOCAL knobs (cache mode/dir/budget,
    stall-guard thresholds, trace) — everything that changes decoded ROWS
    comes from the consumer's job spec instead, so a worker can serve any
    compatible job."""

    def __init__(
        self,
        dispatcher_addr: str,
        options=None,
        port: int = 0,
        host: str = "127.0.0.1",
        worker_id: Optional[str] = None,
        role: str = "decode_worker",
        drain_grace_s: float = 1.0,
        clock=time.monotonic,
        sleep=None,
    ):
        # ``dispatcher_addr`` accepts the full PartitionMap spec: a worker
        # registers with (and heartbeats) EVERY partition, one beat loop
        # per partition, rotating primary -> standby on transport failure
        # — so any partition can route work here, and a promoted standby
        # hears from the fleet within one beat
        self._partition_map = PartitionMap.parse(dispatcher_addr)
        self.dispatcher_addr = self._partition_map.addrs(0)[0]
        self._options = options
        self._role = role
        # drain completes only after the worker has been idle (no fetch
        # stream in flight) for this long continuously — a consumer that
        # just routed here must get its stream before the goodbye
        self.drain_grace_s = float(drain_grace_s)
        self._clock = clock
        self._inflight = 0
        self._idle_since = clock()
        self._inflight_lock = threading.Lock()
        self._draining = threading.Event()
        #: set once the goodbye has been sent and the worker stopped
        self.drained = threading.Event()
        self._beat_lock = threading.Lock()
        self._beat_loops_left = 0
        self._stop = threading.Event()
        self._sleep = sleep if sleep is not None else self._stop.wait
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, port))
        self._srv.listen(64)
        self.addr = sp.format_addr(host, self._srv.getsockname()[1])
        self.worker_id = worker_id or f"{host}:{self._srv.getsockname()[1]}"
        self.lease_ttl_s = DEFAULT_LEASE_TTL_S
        self._registered = threading.Event()
        self._datasets: Dict[str, Tuple[Any, Dict[str, int]]] = {}
        self._ds_lock = threading.Lock()
        self._build_lock = threading.Lock()
        self._threads: List[threading.Thread] = []
        self._conns = _ConnTracker()

    def start(self) -> "DecodeWorker":
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True
        )
        self._accept_thread.start()
        self._threads.append(self._accept_thread)
        self._beat_loops_left = self._partition_map.k
        for part in range(self._partition_map.k):
            beat = threading.Thread(
                target=self._beat_loop,
                args=(self._partition_map.addrs(part),),
                daemon=True,
            )
            beat.start()
            self._threads.append(beat)
        return self

    def stop(self) -> None:
        self._stop.set()
        try:
            self._srv.close()
        except OSError:
            pass
        self._conns.close_all()
        # free the data port deterministically (see ServiceDispatcher.stop);
        # the beat thread is NOT joined — it may be mid-RPC to a dead
        # dispatcher with a seconds-scale timeout, and it holds no port
        t = getattr(self, "_accept_thread", None)
        if t is not None and t is not threading.current_thread():
            t.join(timeout=2.0)

    def __enter__(self) -> "DecodeWorker":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def wait_registered(self, timeout: Optional[float] = None) -> bool:
        return self._registered.wait(timeout)

    # -- dispatcher side ----------------------------------------------------

    def _beat_loop(self, addrs: List[str]) -> None:
        """Register, then heartbeat at TTL/3 forever — one loop per
        PARTITION, against whichever of the partition's addresses
        (primary first, then standbys) currently answers. Any transport
        error (dispatcher crashed/restarting, primary dead awaiting
        takeover) rotates to the partition's next address, backs off, and
        retries — a restarted dispatcher answers ``known: false`` until
        we re-register, which this loop does on the next beat; a standby
        accepts register/heartbeat too, keeping fleet freshness warm for
        its takeover."""
        conn: Optional[socket.socket] = None
        registered = False
        backoff = 0.05
        addr_idx = 0
        addr = addrs[0]
        while not self._stop.is_set():
            try:
                if conn is None:
                    addr = addrs[addr_idx % len(addrs)]
                    conn = sp.connect(addr, timeout=5.0)
                if not registered:
                    reply = sp.request(
                        conn,
                        addr,
                        {
                            "op": "register_worker",
                            "proto": PROTO_VERSION,
                            "worker_id": self.worker_id,
                            "addr": self.addr,
                            "pid": os.getpid(),
                        },
                    )
                    if reply.get("error"):
                        raise ServiceUnavailable(str(reply["error"]))
                    self.lease_ttl_s = float(
                        reply.get("lease_ttl_s", DEFAULT_LEASE_TTL_S)
                    )
                    trace = reply.get("trace")
                    if isinstance(trace, dict):
                        telemetry.adopt_child_from_json(trace, role=self._role)
                    registered = True
                    self._registered.set()
                    METRICS.count("service.registrations")
                else:
                    reply = sp.request(
                        conn,
                        addr,
                        {
                            "op": "heartbeat",
                            "proto": PROTO_VERSION,
                            "worker_id": self.worker_id,
                        },
                    )
                    if not reply.get("known", False):
                        registered = False
                        continue
                    if reply.get("drain"):
                        self._draining.set()
                backoff = 0.05
                if self._draining.is_set():
                    # draining: finish in-flight streams, then goodbye.
                    # Poll fast — the beat cadence (TTL/3) would add
                    # seconds of dead air to every scale-down.
                    if self._drain_ready():
                        try:
                            sp.request(
                                conn, addr,
                                {"op": "goodbye", "proto": PROTO_VERSION,
                                 "worker_id": self.worker_id},
                            )
                        finally:
                            self._beat_loop_finished()
                        return
                    self._sleep(min(0.1, self.drain_grace_s / 2 or 0.1))
                    continue
                self._sleep(max(0.05, self.lease_ttl_s / HEARTBEAT_FRACTION))
            except (OSError, sp.ProtocolError, ServiceUnavailable):
                if conn is not None:
                    try:
                        conn.close()
                    except OSError:
                        pass
                    conn = None
                registered = False
                # next attempt tries the partition's next address (the
                # warm standby when the primary is dead); wraps around so
                # a recovered/readopted primary address is retried too
                addr_idx += 1
                self._sleep(backoff)
                backoff = min(backoff * 2, 2.0)

    def _beat_loop_finished(self) -> None:
        """One partition's drain goodbye is done; the LAST loop to finish
        marks the whole worker drained and stops it (the single-partition
        behavior, generalized)."""
        with self._beat_lock:
            self._beat_loops_left -= 1
            last = self._beat_loops_left <= 0
        if last:
            METRICS.count("service.worker_drained")
            self.drained.set()
            self.stop()

    # -- drain bookkeeping ---------------------------------------------------

    def _fetch_begin(self) -> None:
        with self._inflight_lock:
            self._inflight += 1

    def _fetch_end(self) -> None:
        with self._inflight_lock:
            self._inflight -= 1
            if self._inflight == 0:
                self._idle_since = self._clock()

    def _drain_ready(self) -> bool:
        """Drain completes once no fetch stream has been in flight for
        ``drain_grace_s`` continuously: in-flight consumers finish their
        shard, and a consumer holding a just-issued (stale) route gets
        its stream rather than a closed port. A new fetch during the
        grace resets it."""
        with self._inflight_lock:
            if self._inflight > 0:
                return False
            return self._clock() - self._idle_since >= self.drain_grace_s

    # -- data side ----------------------------------------------------------

    def _accept_loop(self) -> None:
        self._srv.settimeout(0.2)
        while not self._stop.is_set():
            try:
                conn, _peer = self._srv.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            sp.enable_nodelay(conn)
            self._conns.track(conn)
            threading.Thread(
                target=self._serve_conn, args=(conn,), daemon=True
            ).start()

    def _serve_conn(self, conn: socket.socket) -> None:
        peer = "consumer"
        try:
            # sends block under normal consumer backpressure; the timeout
            # only reaps connections whose peer is wedged outright
            conn.settimeout(300.0)
            while not self._stop.is_set():
                msg = sp.recv_msg(conn, peer, allow_eof=True)
                if msg is None:
                    return
                if msg.get("proto", PROTO_VERSION) != PROTO_VERSION:
                    # same loud rejection as the dispatcher's _handle: a
                    # version-skewed peer must never receive chunks whose
                    # section layout it would mis-parse
                    sp.send_msg(conn, {"op": "error", "kind": "proto_mismatch",
                                       "error": f"worker speaks proto "
                                       f"{PROTO_VERSION}, peer sent "
                                       f"{msg.get('proto')!r}"})
                elif msg.get("op") == "fetch":
                    # draining workers still serve: routes already steer
                    # new shards away, and rejecting a raced route would
                    # only force a retry loop — "finish the current
                    # lease" means every stream that reaches us completes
                    self._fetch_begin()
                    try:
                        if not self._handle_fetch(conn, msg, peer):
                            return
                    finally:
                        self._fetch_end()
                elif msg.get("op") == "ping":
                    sp.send_msg(conn, {"ok": True, "worker_id": self.worker_id})
                else:
                    sp.send_msg(conn, {"op": "error", "kind": "bad_request",
                                       "error": f"unknown op {msg.get('op')!r}"})
        except (OSError, sp.ProtocolError):
            return  # consumer went away — its dedupe makes this safe
        finally:
            self._conns.untrack(conn)
            try:
                conn.close()
            except OSError:
                pass

    def _dataset_for(self, spec: Dict[str, Any]):
        """Build (and cache by job digest) the dataset that reproduces the
        consumer's chunk stream, merged with this worker's own local knobs
        (epoch cache, stall thresholds)."""
        digest = job_digest(spec)
        with self._ds_lock:
            hit = self._datasets.get(digest)
            if hit is not None:
                return hit
        # One build at a time: the acceptance topology (2 consumers, same
        # job) guarantees near-simultaneous cold fetches, which must not
        # each pay the seconds-long construction; the second fetch waits
        # here and takes the cache hit (the keepalive in _handle_fetch
        # covers the wait on the consumer's deadline).
        with self._build_lock:
            with self._ds_lock:
                hit = self._datasets.get(digest)
                if hit is not None:
                    return hit
            return self._build_dataset(spec, digest)

    def _build_dataset(self, spec: Dict[str, Any], digest: str):
        from tpu_tfrecord_torch.io.dataset import TFRecordDataset
        from tpu_tfrecord_torch.options import TFRecordOptions

        base: Dict[str, Any] = {
            "record_type": spec["record_type"],
            "verify_crc": spec["verify_crc"],
            "schema": spec["schema"],
            "on_corrupt": spec["on_corrupt"],
            "max_corrupt_records": spec["max_corrupt_records"],
            "corrupt_fallback": spec["corrupt_fallback"],
            "on_stall": spec["on_stall"],
        }
        wo = self._options
        if wo is not None:
            base.update(
                cache=wo.cache,
                cache_dir=wo.cache_dir,
                cache_max_bytes=wo.cache_max_bytes,
                trace=wo.trace,
                read_deadline_ms=wo.read_deadline_ms,
                open_deadline_ms=wo.open_deadline_ms,
                hedge_after_ms=wo.hedge_after_ms,
                watchdog_timeout_ms=wo.watchdog_timeout_ms,
            )
        ds = TFRecordDataset(
            spec["paths"],
            batch_size=int(spec["batch_size"]),
            options=TFRecordOptions.from_map(base),
            columns=list(spec["columns"]),
            num_epochs=1,
            process_index=0,
            process_count=1,
            num_workers=1,
            hash_buckets=spec.get("hash_buckets") or None,
            pack=spec.get("pack") or None,
            slab_bytes=int(spec["slab_bytes"]),
            max_record_bytes=int(spec["max_record_bytes"]),
        )
        mine = shards_digest(ds._reader.shards)
        if mine != spec["shards_digest"]:
            raise ServiceSpecError(
                f"shard list diverged: worker sees digest {mine}, consumer "
                f"sent {spec['shards_digest']} — the dataset changed under "
                "the service"
            )
        want_fused = spec.get("fused")
        # both decode routes of the port hash and pack, as the native
        # decoder does (a JAX Python-route consumer does not)
        have_fused = True
        if want_fused is not None and bool(want_fused) != have_fused:
            raise ServiceSpecError(
                f"fused-decode availability diverged (consumer "
                f"fused={want_fused}, worker fused={have_fused}): chunks "
                "would carry different columns"
            )
        idx_of = {sh.path: i for i, sh in enumerate(ds.shards)}
        with self._ds_lock:
            self._datasets[digest] = (ds, idx_of)
            # LRU-ish cap: a long-lived worker serving a succession of
            # distinct jobs must not grow without bound (each entry holds
            # decoder state, shard lists, and IO scratch); insertion order
            # approximates recency well enough here because a job's
            # fetches arrive in bursts.
            while len(self._datasets) > MAX_CACHED_JOBS:
                evicted = next(iter(self._datasets))
                if evicted == digest:
                    break
                del self._datasets[evicted]
        return ds, idx_of

    def _handle_fetch(
        self, conn: socket.socket, msg: Dict[str, Any], peer: str
    ) -> bool:
        """Stream one shard from ``skip``; returns False when the
        connection is no longer usable for further requests."""
        try:
            spec = msg["spec"]
            shard_path = str(msg["shard"])
            skip = int(msg.get("skip", 0))
        except (KeyError, TypeError, ValueError) as e:
            sp.send_msg(conn, {"op": "error", "kind": "bad_request",
                               "error": f"malformed fetch: {e!r}"})
            return True
        # Liveness vs construction: the first fetch of a job pays seconds
        # of dataset construction on a loaded box, so build on the side
        # and stream `building` keepalives — the consumer's per-op recv
        # deadline then measures LIVENESS, and a cold healthy worker is
        # never mistaken for a dead one (a deadline miss here used to add
        # a spurious lease reassignment per cold worker).
        built: Dict[str, Any] = {}
        done = threading.Event()

        def _build() -> None:
            try:
                built["ds"] = self._dataset_for(spec)
            except BaseException as e:  # graftlint: swallow(error shipped to the consumer as a protocol error op)
                built["err"] = e
            finally:
                done.set()

        threading.Thread(target=_build, daemon=True).start()
        try:
            while not done.wait(0.25):
                sp.send_msg(conn, {"op": "building"})
        except OSError:
            return False  # consumer went away mid-construction
        err = built.get("err")
        if err is not None:
            if isinstance(err, ServiceSpecError):
                kind = "spec_mismatch"
            elif isinstance(err, (KeyError, TypeError, ValueError)):
                kind = "bad_request"
            else:  # dataset construction (bad paths, IO)
                kind = "io"
            sp.send_msg(conn, {"op": "error", "kind": kind, "error": str(err)})
            return True
        ds, idx_of = built["ds"]
        try:
            idx = idx_of[shard_path]
        except KeyError:
            sp.send_msg(conn, {"op": "error", "kind": "bad_request",
                               "error": f"unknown shard {shard_path!r}"})
            return True
        METRICS.count("service.fetches")
        # the worker's half of the consumer's service.lease span: the
        # consumer ships its lease span id in the fetch message, and the
        # service.serve span links back to it by parent_span_id — merged
        # traces render route -> lease -> serve -> eof as one causal chain
        trace = msg.get("trace")
        trace = trace if isinstance(trace, dict) else None
        # Will this shard be served from the warm columnar cache (zero
        # ground-truth reads)? Peeked BEFORE the stream so the eof can
        # carry it to the consumer, which forwards it on shard_done —
        # the dispatcher's per-tenant shared_cache_hits accounting.
        cached = False
        if getattr(ds, "_cache", None) is not None:
            cached = ds._cache.peek_entry(ds.shards[idx])
            if cached:
                METRICS.count("service.cache_served")
        k = 0
        try:
            with telemetry.span("service.serve", shard=shard_path) as span:
                if trace is not None:
                    span.set(
                        trace_id=trace.get("trace_id"),
                        parent_span_id=trace.get("span_id"),
                    )
                for chunk, _e, _p, start in ds._decode_shard(0, 0, idx, skip):
                    nbytes = sp.send_chunk(conn, chunk, start, k)
                    k += 1
                    METRICS.count("service.chunks_sent")
                    METRICS.count("service.bytes_sent", nbytes)
                span.set(chunks=k)
            sp.send_msg(conn, {"op": "eof", "chunks": k, "cached": cached})
            METRICS.count("service.shards_served")
            return True
        except wire.TFRecordCorruptionError as e:
            try:
                sp.send_msg(conn, {"op": "error", "kind": "corruption",
                                   "error": str(e)})
            except OSError:
                pass
            return False
        except (OSError, sp.ProtocolError) as e:
            # consumer vanished mid-stream, or the worker's own read
            # failed: if the pipe still works, tell the consumer so it can
            # try another worker rather than waiting out its deadline
            try:
                sp.send_msg(conn, {"op": "error", "kind": "io",
                                   "error": str(e)})
            except OSError:
                pass
            return False


# ---------------------------------------------------------------------------
# Consumer client
# ---------------------------------------------------------------------------


class ServiceClient:
    """The consumer side: an alternative chunk source for one iterator.
    ``shard_chunks`` yields the exact ``(chunk, epoch, pos, start)`` tuples
    ``TFRecordDataset._chunk_stream`` would have decoded locally, fetched
    from leased workers instead — with reconnect-and-dedupe on worker
    death, dispatcher-outage backoff, and the local-read fallback."""

    def __init__(self, ds):
        opts = ds.options
        self._ds = ds
        self.deadline_s = (opts.service_deadline_ms or 5000.0) / 1000.0
        fb = opts.service_fallback_ms
        self.fallback_s = fb / 1000.0 if fb is not None else None
        self._clock = ds.retry_policy.clock
        self._sleep = ds.retry_policy.sleep
        self._spec = build_job_spec(ds)
        self._job = job_digest(self._spec)
        # the multi-tenant sharing key (decode fingerprint + shard list):
        # jobs that share it share one lease table and one warm cache
        self._tenant = self._spec["tenant"]
        # the static partition map: this dataset's tenant hashes to ONE
        # owning partition; the client speaks only to that partition's
        # addresses (primary first), rotating to the standby on transport
        # failure or a not_primary reply — failover is just the existing
        # RetryPolicy backoff landing on the next address
        pm = PartitionMap.parse(opts.service)
        self.partition = pm.partition_for(self._tenant)
        self._addrs = pm.addrs(self.partition)
        self._addr_idx = 0
        self.addr = self._addrs[0]
        METRICS.gauge("service.partition", float(self.partition))
        # consumer identity for the dispatcher's per-tenant census only —
        # never part of any lease key
        self._consumer_id = (
            f"{socket.gethostname()}-{os.getpid()}-{os.urandom(3).hex()}"
        )
        self._fetch_cached = False
        self._dtype_of = ds.chunk_dtypes().__getitem__
        self._verify = opts.verify_crc
        self._global_index = {
            sh.path: i for i, sh in enumerate(ds._reader.shards)
        }
        self._disp: Optional[socket.socket] = None
        self._degraded = False
        # Worker ids this client WATCHED fail (wid -> suspected-at time),
        # remembered across shards: until the dispatcher expires the dead
        # worker's heartbeat (one lease TTL), routing would otherwise hand
        # every subsequent shard to the corpse first — one connect-fail
        # and one spurious lease_reassignment per shard. Suspicion is
        # client-scoped and self-healing three ways: the dispatcher
        # ignores exclusions that would leave no candidates, a suspect
        # that completes a shard for us is cleared, and suspicion ages out
        # after one lease TTL (by then the dispatcher's own heartbeat
        # accounting has caught a genuinely dead worker — one transient
        # hiccup must not exile a healthy worker for the client's life).
        self._suspects: Dict[str, float] = {}
        self._suspect_ttl_s = opts.service_lease_ttl_s

    def close(self) -> None:
        if self._disp is not None:
            try:
                self._disp.close()
            except OSError:
                pass
            self._disp = None

    def _rotate_addr(self) -> None:
        """Advance to the owning partition's next address (primary ->
        standby -> primary ...): the client-side half of failover. The
        wrap-around matters — a promoted standby may have adopted the
        dead primary's advertised address, so the old address is retried
        too."""
        if len(self._addrs) > 1:
            self._addr_idx = (self._addr_idx + 1) % len(self._addrs)
            self.addr = self._addrs[self._addr_idx]

    def _dispatcher_rpc(self, obj: Dict[str, Any]) -> Dict[str, Any]:
        if self._disp is None:
            try:
                s = sp.connect(self.addr, timeout=self.deadline_s)
            except OSError:
                # a refused/timed-out CONNECT must rotate too — otherwise
                # a client whose current address is the dead primary
                # retries that same corpse until its fallback budget
                # dies, never reaching the promoted standby
                self._rotate_addr()
                raise
            s.settimeout(self.deadline_s)
            self._disp = s
        try:
            reply = sp.request(self._disp, self.addr, obj)
        except (OSError, sp.ProtocolError):
            self.close()
            self._rotate_addr()
            raise
        if reply.get("error") == "not_primary":
            # an honest standby (or demoted zombie): same retry shape as
            # a dead dispatcher, but the next attempt must try the
            # partition's other address
            self.close()
            self._rotate_addr()
        return reply

    def _live_suspects(self) -> List[str]:
        now = self._clock()
        for wid in [w for w, t in self._suspects.items()
                    if now - t >= self._suspect_ttl_s]:
            del self._suspects[wid]
        return list(self._suspects)

    def _shard_done(
        self, worker_id: str, shard_path: str, cached: bool = False
    ) -> None:
        """Report one shard's completion to the partition. Accounting only
        (the consumer's own position is truth), but it rides a dispatcher
        outage as a route does: a dead primary, or a standby that has not
        promoted yet (``not_primary``), is retried through the partition's
        members with the policy's backoff for up to one lease TTL, so a
        shard completed during a failover is still in the promoted
        standby's books. A degraded client (already reading locally) tries
        once."""
        msg = {"op": "shard_done", "proto": PROTO_VERSION, "job": self._job,
               "tenant": self._tenant, "consumer": self._consumer_id,
               "path": shard_path, "worker_id": worker_id, "cached": cached}
        deadline = self._clock() + (0.0 if self._degraded else self._suspect_ttl_s)
        attempt = 0
        while True:
            try:
                if self._dispatcher_rpc(msg).get("error") != "not_primary":
                    return
            except (OSError, sp.ProtocolError):
                pass
            attempt += 1
            now = self._clock()
            if now >= deadline:
                logger.warning("shard_done of %s not reported: no accepting "
                               "member of %s", shard_path, self._addrs)
                return
            self._sleep(min(self._ds.retry_policy.backoff(min(attempt, 16)),
                            deadline - now))

    def shard_chunks(self, epoch: int, pos: int, shard_idx: int, skip: int, stop):
        """Yield one shard's chunk tuples from the resume point, exactly
        once: ``consumed`` tracks the absolute record offset acked into
        the pipeline; every retry re-requests FROM that offset and any
        redelivered prefix is dropped/sliced, so a worker death, a
        dispatcher restart, or a reconnect can duplicate nothing and skip
        nothing."""
        ds = self._ds
        shard = ds.shards[shard_idx]
        consumed = skip
        exclude: List[str] = self._live_suspects()
        budget_start = self._clock()
        attempt = 0
        while not stop.is_set():
            wid = None
            # one lease = one span: route -> lease -> serve -> eof, each
            # attempt its own child of this process's context. The span id
            # rides the route and fetch messages, so the dispatcher's
            # service.route instant and the worker's service.serve span
            # link back by parent_span_id in the merged timeline.
            ctx = telemetry.current_context().child("service.lease")
            try:
                with telemetry.span(
                    "service.lease", shard=shard.path,
                    trace_id=ctx.trace_id, span_id=ctx.span_id,
                    parent_span_id=ctx.parent_span_id,
                ) as lease:
                    reply = self._dispatcher_rpc(
                        {
                            "op": "route",
                            "proto": PROTO_VERSION,
                            "job": self._job,
                            "tenant": self._tenant,
                            "consumer": self._consumer_id,
                            "path": shard.path,
                            "shard_index": self._global_index[shard.path],
                            "exclude": exclude,
                            "trace": ctx.to_json(),
                        }
                    )
                    if reply.get("error"):
                        raise ServiceUnavailable(str(reply["error"]))
                    worker_addr, wid = (
                        str(reply["worker"]), str(reply["worker_id"])
                    )
                    lease.set(worker=wid)
                    ttl = reply.get("lease_ttl_s")
                    if ttl is not None:
                        self._suspect_ttl_s = float(ttl)
                    for item in self._fetch_shard(
                        worker_addr, shard.path, consumed, epoch, pos, stop,
                        trace=ctx,
                    ):
                        yield item
                        consumed = item[3] + item[0].num_rows
                        budget_start = self._clock()  # progress resets the budget
                        exclude = self._live_suspects()
                        attempt = 0
                # a suspect that just completed a shard for us is healthy
                self._suspects.pop(wid, None)
                self._shard_done(wid, shard.path, cached=self._fetch_cached)
                self._degraded = False
                return
            except ServiceSpecError:
                raise
            except wire.TFRecordCorruptionError:
                raise  # same outcome a local strict read would have had
            except (OSError, sp.ProtocolError, ServiceUnavailable) as e:
                METRICS.count("service.reconnects")
                if wid is not None and wid not in exclude:
                    exclude.append(wid)
                if wid is not None:
                    self._suspects[wid] = self._clock()
                attempt += 1
                now = self._clock()
                exhausted = (
                    self.fallback_s is not None
                    and now - budget_start >= self.fallback_s
                )
                if exhausted or self._degraded:
                    self._fallback(shard.path, e)
                    yield from ds._decode_shard(epoch, pos, shard_idx, consumed)
                    return
                # the policy owns backoff shape (capped exponential, full
                # jitter — M consumers losing the same worker must not
                # retry the dispatcher in lockstep), and the sleep never
                # overruns the remaining fallback budget
                delay = ds.retry_policy.backoff(min(attempt, 16))
                if self.fallback_s is not None:
                    delay = min(
                        delay, max(0.0, self.fallback_s - (now - budget_start))
                    )
                self._sleep(delay)

    def _fetch_shard(self, worker_addr, shard_path, skip, epoch, pos, stop,
                     trace=None):
        self._fetch_cached = False
        sock = sp.connect(worker_addr, timeout=self.deadline_s)
        try:
            sock.settimeout(self.deadline_s)
            msg = {"op": "fetch", "proto": PROTO_VERSION, "spec": self._spec,
                   "shard": shard_path, "skip": skip}
            if trace is not None:
                msg["trace"] = trace.to_json()
            sp.send_msg(sock, msg)
            consumed = skip
            while not stop.is_set():
                # EOF here (allow_eof=False) raises ProtocolError: a worker
                # that closes mid-shard without an `eof` message is a death
                msg = sp.recv_msg(sock, worker_addr)
                op = msg.get("op")
                if op == "chunk":
                    chunk = sp.recv_chunk_body(
                        sock, msg, worker_addr, self._dtype_of, self._verify
                    )
                    start = int(msg["start"])
                    rows = chunk.num_rows
                    METRICS.count("service.chunks_recv")
                    if rows == 0 or start + rows <= consumed:
                        METRICS.count("service.redelivered_dropped")
                        continue
                    if start < consumed:
                        # partial overlap with already-acked rows: keep
                        # only the unseen suffix
                        METRICS.count("service.redelivered_dropped")
                        chunk = slice_batch(chunk, consumed - start, rows)
                        start = consumed
                    yield chunk, epoch, pos, start
                    consumed = start + chunk.num_rows
                elif op == "building":
                    continue  # keepalive: the worker is constructing its
                    # dataset — alive, just not streaming yet
                elif op == "eof":
                    # the worker's warm-cache disclosure rides the eof;
                    # shard_chunks forwards it on shard_done
                    self._fetch_cached = bool(msg.get("cached", False))
                    return
                elif op == "error":
                    kind = msg.get("kind")
                    err = str(msg.get("error", "worker error"))
                    if kind == "corruption":
                        raise wire.TFRecordCorruptionError(err)
                    if kind == "spec_mismatch":
                        raise ServiceSpecError(err)
                    raise ServiceUnavailable(f"{worker_addr}: {err}")
                else:
                    raise sp.ProtocolError(
                        f"unexpected message {op!r} from {worker_addr}"
                    )
        finally:
            try:
                sock.close()
            except OSError:
                pass

    def _fallback(self, shard_path: str, err: BaseException) -> None:
        self._degraded = True
        METRICS.count("service.fallbacks")
        telemetry.instant("service.fallback", shard=shard_path, error=str(err))
        log_salvage_event(
            path=shard_path, kind="service_fallback", error=str(err)
        )


def fetch_status(addr: str, timeout: float = 5.0) -> Dict[str, Any]:
    """One status round trip to a dispatcher (the ``serve-status`` doctor
    subcommand's transport)."""
    sock = sp.connect(addr, timeout=timeout)
    try:
        sock.settimeout(timeout)
        return sp.request(
            sock, addr, {"op": "status", "proto": PROTO_VERSION}
        )
    finally:
        try:
            sock.close()
        except OSError:
            pass


# ---------------------------------------------------------------------------
# CLI — `python -m tpu_tfrecord_torch.service dispatcher|worker`
# ---------------------------------------------------------------------------


def _run_forever(stop_event: threading.Event) -> None:
    import signal

    def _term(_sig, _frm):
        raise SystemExit(0)

    try:
        signal.signal(signal.SIGTERM, _term)
    except ValueError:
        pass  # not the main thread (tests drive main() directly)
    try:
        # the event IS the wait seam: no bare time.sleep in a policy
        # module, and SIGTERM/stop wakes the loop immediately
        while not stop_event.wait(0.2):
            pass
    except KeyboardInterrupt:
        pass


def _spool_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--spool-dir", default=None,
                    help="telemetry spool directory (tfrecord_doctor fleet)")
    ap.add_argument("--spool-interval", type=float, default=1.0)


def _maybe_spool(args, role: str):
    if args.spool_dir is None:
        return None
    from tpu_tfrecord_torch import fleet

    fleet.acquire_spool(args.spool_dir, role=role, interval_s=args.spool_interval)
    return args.spool_dir


def _release_spool(spool) -> None:
    if spool is not None:
        from tpu_tfrecord_torch import fleet

        fleet.release_spool(spool)


def dispatcher_main(argv: List[str]) -> int:
    from tpu_tfrecord_torch.options import TFRecordOptions

    defaults = TFRecordOptions()
    ap = argparse.ArgumentParser(prog="tpu_tfrecord_torch.service dispatcher")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--journal", default=None,
                    help="assignment journal path (fsynced snapshot+delta "
                    "lines; a restarted dispatcher replays it, a warm "
                    "standby tails it)")
    ap.add_argument("--lease-ttl-s", type=float,
                    default=defaults.service_lease_ttl_s)
    ap.add_argument("--standby-of", default=None, metavar="HOST:PORT",
                    help="run as the warm standby of the primary at this "
                    "address: tail its journal (--journal must point at "
                    "the SAME file), detect death by ping loss, promote "
                    "with a bumped generation (fencing the zombie) and "
                    "take over the advertised address")
    ap.add_argument("--partition", type=int, default=0,
                    help="this dispatcher's index in the static partition "
                    "map (consumers hash tenants over it)")
    ap.add_argument("--generation", type=int, default=0,
                    help="starting fencing generation (normally 0; the "
                    "journal's replayed generation wins if higher)")
    ap.add_argument("--takeover-misses", type=int,
                    default=STANDBY_TAKEOVER_MISSES,
                    help="consecutive failed primary pings before a "
                    "standby promotes itself")
    ap.add_argument("--ping-interval", type=float, default=None,
                    help="standby ping/tail cadence in seconds (default "
                    "min(1, lease_ttl/4))")
    ap.add_argument("--no-addr-takeover", action="store_true",
                    help="do not try to bind the dead primary's advertised "
                    "address on promotion (clients rotate to the standby "
                    "address via the partition map instead)")
    ap.add_argument("--elastic", action="store_true",
                    help="run a FleetScaler (tpu_tfrecord_torch.elastic): spawn "
                    "decode-worker subprocesses on producer_bound, drain "
                    "them on consumer_bound/idle")
    ap.add_argument("--scaler-spool", default=None, metavar="DIR",
                    help="telemetry spool dir the scaler reads the cluster "
                    "verdict from (default: --spool-dir)")
    ap.add_argument("--min-workers", type=int,
                    default=defaults.elastic_min_workers)
    ap.add_argument("--max-workers", type=int, default=None,
                    help="fleet ceiling (default: the options-vocabulary "
                    "default, currently 8)")
    ap.add_argument("--scale-interval", type=float,
                    default=defaults.elastic_interval_s or 1.0)
    ap.add_argument("--hysteresis", type=int, default=2)
    ap.add_argument("--cooldown", type=float, default=5.0)
    ap.add_argument("--scaler-roles", default=None, metavar="ROLE[,ROLE]",
                    help="scope the scaler's cluster verdict to spools "
                    "stamped with these telemetry roles (e.g. 'trainer'); "
                    "default: every spooling process with an occupancy "
                    "gauge votes")
    ap.add_argument("--worker-arg", action="append", default=[],
                    metavar="ARG", help="extra CLI arg for every spawned "
                    "worker (repeatable; e.g. --worker-arg=--cache "
                    "--worker-arg=auto)")
    ap.add_argument("--partition-map", default=None, metavar="SPEC",
                    help="full PartitionMap spec spawned workers register "
                    "with (so every partition can route to them); default: "
                    "just this dispatcher's address")
    _spool_args(ap)
    args = ap.parse_args(argv)
    role = "standby" if args.standby_of else "dispatcher"
    telemetry.adopt_from_env(role=role)
    d = ServiceDispatcher(
        port=args.port, host=args.host, journal=args.journal,
        lease_ttl_s=args.lease_ttl_s,
        standby_of=args.standby_of,
        partition_index=args.partition,
        generation=args.generation,
        takeover_misses=args.takeover_misses,
        ping_interval_s=args.ping_interval,
        takeover_addr=not args.no_addr_takeover,
    ).start()
    spool = _maybe_spool(args, role)
    scaler = None
    spawner = None
    if args.elastic:
        from tpu_tfrecord_torch import elastic

        scaler_spool = args.scaler_spool or args.spool_dir
        if scaler_spool is None:
            ap.error("--elastic needs --scaler-spool (or --spool-dir): the "
                     "scaler reads the cluster verdict from a spool dir")
        if args.standby_of:
            ap.error("--elastic belongs on a PRIMARY: a standby must not "
                     "run a second scaler over the same fleet")
        spawner = elastic.subprocess_spawner(
            args.partition_map or d.addr, tuple(args.worker_arg)
        )
        max_workers = (
            args.max_workers
            if args.max_workers is not None
            else (defaults.elastic_max_workers or 8)
        )
        # under a partition map the one scaler federates: this partition
        # in-process, every other partition through a remote handle
        targets: Any = d
        if args.partition_map:
            pmap = PartitionMap.parse(args.partition_map)
            targets = [
                d if i == args.partition
                else elastic.DispatcherHandle(pmap.addrs(i))
                for i in range(pmap.k)
            ]
        scaler = elastic.FleetScaler(
            targets, spawner, spool_dir=scaler_spool,
            policy=elastic.ScalerPolicy(
                hysteresis=args.hysteresis, cooldown_s=args.cooldown,
                min_workers=args.min_workers, max_workers=max_workers,
            ),
            interval_s=args.scale_interval,
            roles=(
                [r.strip() for r in args.scaler_roles.split(",") if r.strip()]
                if args.scaler_roles else None
            ),
        ).start()
    print(json.dumps({"event": "ready", "role": role,
                      "addr": d.addr, "pid": os.getpid(),
                      "partition": d.partition_index,
                      "generation": d.generation,
                      "standby_of": args.standby_of,
                      "elastic": bool(scaler)}), flush=True)
    try:
        _run_forever(d._stop)
    finally:
        if scaler is not None:
            scaler.stop()
        d.stop()
        if spawner is not None:
            spawner.reap()
        _release_spool(spool)
    return 0


def worker_main(argv: List[str]) -> int:
    from tpu_tfrecord_torch.options import TFRecordOptions

    ap = argparse.ArgumentParser(prog="tpu_tfrecord_torch.service worker")
    ap.add_argument("--dispatcher", required=True,
                    help="dispatcher address, or a full PartitionMap spec "
                    "('h:p1|h:p2,h:p3' / '@map.json'): the worker "
                    "registers with and heartbeats EVERY partition")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--worker-id", default=None)
    ap.add_argument("--role", default="decode_worker")
    ap.add_argument("--cache", default="off", choices=("off", "auto"),
                    help="columnar epoch cache mode for this worker")
    ap.add_argument("--cache-dir", default=None)
    ap.add_argument("--cache-max-bytes", type=int, default=None)
    ap.add_argument("--drain-grace", type=float, default=1.0,
                    help="idle seconds before a draining worker says "
                    "goodbye and exits (default 1.0)")
    ap.add_argument("--fault-plan", default=None, metavar="PLAN_JSON",
                    help="install a seeded FaultPlan (tpu_tfrecord_torch.faults) "
                    "for the life of this worker — deterministic chaos on "
                    "a real fleet")
    _spool_args(ap)
    args = ap.parse_args(argv)
    telemetry.adopt_from_env(role=args.role)
    if args.fault_plan is not None:
        from tpu_tfrecord_torch.faults import FaultPlan, install_chaos

        with open(args.fault_plan) as fh:
            plan = FaultPlan.from_json(json.load(fh))
        # held for the process's whole life; process exit is the release
        install_chaos(plan).__enter__()
    opts = TFRecordOptions.from_map(
        cache=args.cache, cache_dir=args.cache_dir,
        cache_max_bytes=args.cache_max_bytes,
    )
    w = DecodeWorker(
        args.dispatcher, options=opts, port=args.port, host=args.host,
        worker_id=args.worker_id, role=args.role,
        drain_grace_s=args.drain_grace,
    ).start()
    spool = _maybe_spool(args, args.role)
    print(json.dumps({"event": "ready", "role": args.role, "addr": w.addr,
                      "worker_id": w.worker_id, "pid": os.getpid()}),
          flush=True)
    try:
        _run_forever(w._stop)
    finally:
        w.stop()
        _release_spool(spool)
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] == "dispatcher":
        return dispatcher_main(argv[1:])
    if argv and argv[0] == "worker":
        return worker_main(argv[1:])
    sys.stderr.write(
        "usage: python -m tpu_tfrecord_torch.service {dispatcher|worker} [options]\n"
    )
    return 2


if __name__ == "__main__":
    sys.exit(main())
