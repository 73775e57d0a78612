"""Deterministic chaos: seeded fault plans, their replayable ledger and the
injecting wrappers. Copy of ``tpu_tfrecord/faults.py`` (standard library
only): a ``FaultPlan`` and its JSON are the JAX package's, so one plan
file drives either package and fires the same ledger for the same calls.

``install_chaos`` patches the seams the port has: ``fs.filesystem_for``
and ``fs.local_open`` (the record read and write paths),
``io.dataset._open_local`` (the dataset's mmap route for local
uncompressed shards), the socket seam of ``service_protocol`` (connect /
recv), the HTTP client's connect seam (``httpfs._CHAOS_PLAN``) and the
serving tier's seam (``_SERVE_CHAOS``, read by
``tpu_tfrecord_torch.serving``) and the data service's journal seam
(``service._JOURNAL_CHAOS``: every dispatcher-journal append or
compaction runs ``apply_journal``). The ``http`` kinds fire at
the server side of a socket, in ``httpfs.FaultingRangeServer``.

The pipeline is held against faults that raise, and the stall-defence
layer against faults that merely hang. Both need a way to *reproduce* a
fault on demand; this module is that subsystem: a ``FaultPlan``
(JSON-serializable scenario: which ops, which paths, which call ordinals,
what kind of fault) and a ``ChaosFS`` wrapper
over any ``LocalFS``/``FsspecFS`` that executes the plan. Every injected
fault is appended to a replayable ledger, so a test (or
``tools/tfrecord_doctor.py --simulate``) can assert exactly what fired and
a bug report can ship the plan that reproduces a field failure.

Determinism contract: fault decisions depend only on (rule, per-(op, path)
call ordinal) — never on wall clock or thread scheduling. Probabilistic
rules draw from a RNG seeded by (plan.seed, rule index, ordinal), so even
concurrent readers make the same draw for the same call. Same plan + same
access pattern => byte-identical ledger.

Fault kinds:

- ``transient_error``: raise OSError for ``times`` matching calls, then heal
  (the retry-path workout).
- ``permanent_error``: raise OSError on every matching call.
- ``short_read``: cap each matching read at ``cap_bytes`` (object-store
  style partial reads; exercises every reader's refill loop).
- ``stall``: block the matching call for ``stall_ms`` — the hung-read /
  straggler-shard scenario. The wait goes through the plan's injectable
  ``sleep`` seam (default: an interruptible Event wait, released by
  ``plan.release()``), so tests bound wall time or eliminate it entirely.
- ``rename_race``: let the rename LAND, then raise (the object-store
  "copy succeeded, error surfaced anyway" race that the writer's
  landed-rename detection exists for).
- ``flaky_listing``: raise OSError from listdir/glob/walk_files (a dropped
  LIST page; discovery must retry or fail loudly, never shrink).
"""

from __future__ import annotations

import contextlib
import json
import os
import random
import signal
import threading
import time
from dataclasses import asdict, dataclass, field
from typing import Any, Dict, List, Optional

FAULT_KINDS = (
    "transient_error",
    "permanent_error",
    "short_read",
    "stall",
    "rename_race",
    "flaky_listing",
    "disconnect",
    # Dispatcher-targeted kinds (the data service's HA chaos):
    "torn_write",  # journal record torn at cap_bytes, then the write errors
    # — the host-crash-mid-append scenario journal replay must survive
    "sigkill",  # SIGKILL the CURRENT process at the matching call — the
    # primary-dies-mid-journal-write scenario (subprocess scenarios only)
    "netsplit",  # connect/recv permanently refused: the standby-partition
    # scenario, ledgered distinctly from an ordinary permanent_error
    # HTTP-request kinds (op="http"), executed by the fault-injecting
    # Range server (httpfs.serve_directory) — faults that
    # fire at the REAL socket level, not inside a wrapped file object:
    "reset",  # RST the connection mid-body (SO_LINGER 0 + close)
    "truncated_body",  # full Content-Length declared, fewer bytes sent
    "http_error",  # `status` (503/429/...) response, Retry-After honored
    "bad_content_range",  # serve range start+shift_bytes, honestly labeled
    "trickle",  # body dribbled cap_bytes per stall_ms — slow-trickle stall
    # Serving-tier kinds (op="serve"), executed by tpu_tfrecord_torch.serving
    # at its reply/recv/load seams:
    "slow_client",  # stall the server's reply to ONE client for stall_ms
    # — must block only that client's writer, never the engine tick
    "client_disconnect",  # drop the client's connection mid-generation —
    # the request's slot must free without perturbing neighbors' bytes
    "burst",  # the open-loop load generator injects burst_n extra
    # requests at the matching call — the overload-shedding scenario
)

#: ops a rule may target. ``read`` covers read()/readinto() on handles the
#: wrapped FS opened; ``open`` covers the open call itself; ``rename`` and
#: ``listdir`` cover the write/commit and discovery sides. ``connect`` and
#: ``recv`` are the SOCKET seams of the data service
#: (tpu_tfrecord_torch.service_protocol): the path a rule matches is the peer
#: address string ("host:port"); ``transient_error``/``permanent_error``
#: on connect model refused connections, ``stall`` models a hung peer
#: (bounded, same injectable sleep), ``short_read`` caps one recv (the
#: partial-segment scenario every recv loop must refill past), and
#: ``disconnect`` closes the socket mid-frame — the short-frame scenario
#: the protocol must convert into a loud ProtocolError, never into
#: truncated data. ``http`` is the request seam of the real-network
#: remote tier (httpfs): the path a rule matches is
#: ``<url path>@<range start>`` — keyed per byte offset so retries of the
#: same block get deterministic ordinals even with concurrent fetches —
#: and the HTTP-specific kinds above fire on the server's side of a real
#: TCP connection. ``connect`` rules also apply to the HTTP client's
#: connection establishment (peer "host:port"): a transient/permanent
#: error there IS connection-refused as the client observes it.
#: ``journal`` is the dispatcher-journal write seam (tpu_tfrecord.service
#: consults the installed plan around every journal append/compaction;
#: the matched path is the journal file path): ``torn_write`` lands a
#: cap_bytes prefix of the record on disk and then errors (the
#: crash-mid-append tear standby replay must absorb), ``sigkill`` kills
#: the dispatcher process at the write, and transient/permanent errors
#: exercise the journal-failure self-demotion path.
#: ``serve`` is the serving tier's seam (tpu_tfrecord_torch.serving): the path
#: a rule matches is the seam point — ``reply:<peer>`` (the server's
#: per-client writer, where ``slow_client`` stalls and
#: ``client_disconnect`` drops the connection), ``recv:<peer>`` (the
#: server's per-client reader, same kinds), and ``load`` (the open-loop
#: generator's admission call, where ``burst`` injects burst_n extra
#: requests). All on the same replayable ledger as the file/socket seams.
FAULT_OPS = ("open", "read", "rename", "listdir", "connect", "recv", "http",
             "journal", "serve")

#: kinds only the fault-injecting HTTP server executes (op="http").
HTTP_ONLY_KINDS = (
    "reset", "truncated_body", "http_error", "bad_content_range", "trickle",
)

#: every kind an ``op="http"`` rule may carry — the HTTP-only kinds plus
#: the generic ones the Range server's dispatch actually executes. A kind
#: outside this set on op="http" (short_read, disconnect, ...) would be
#: LEDGERED as fired while the server serves the object clean — the
#: silent-no-op this vocabulary check exists to refuse.
HTTP_ALLOWED_KINDS = HTTP_ONLY_KINDS + (
    "stall", "transient_error", "permanent_error",
)

#: kinds only the serving tier executes (op="serve").
SERVE_ONLY_KINDS = ("slow_client", "client_disconnect", "burst")

#: every kind an ``op="serve"`` rule may carry — serve-only kinds plus the
#: generic ones the serving seams actually execute. Anything else would be
#: ledgered as fired while the server behaves clean (the silent no-op the
#: http vocabulary check already refuses).
SERVE_ALLOWED_KINDS = SERVE_ONLY_KINDS + (
    "stall", "transient_error", "permanent_error",
)


#: set by install_chaos; the serving tier (tpu_tfrecord_torch.serving) consults
#: it at its reply/recv/load seams. Lives HERE rather than in serving.py
#: so installing chaos never has to import the jax-heavy serving module
#: (and works regardless of import order); an explicit ``fault_plan``
#: passed to a server/load-generator wins over this global.
_SERVE_CHAOS: Optional["FaultPlan"] = None


class InjectedFault(OSError):
    """Every raising fault ChaosFS injects is this OSError subclass, so the
    existing transient-retry nets treat it exactly like a real IO error
    while tests can still tell injected from organic."""


@dataclass
class FaultRule:
    """One line of a scenario: WHAT fires (kind + params), WHERE (op +
    path substring), and WHEN (from call ``ordinal`` on, at most ``times``
    firings; ``probability`` < 1.0 makes eligible calls fire by a seeded,
    ordinal-keyed coin flip)."""

    op: str
    kind: str
    path: str = ""  # substring match against the full path ("" = any)
    ordinal: int = 0  # first per-(op, path-key) call index eligible to fire
    times: Optional[int] = 1  # max firings (None = every eligible call)
    stall_ms: float = 0.0
    cap_bytes: int = 0
    probability: float = 1.0
    error: str = ""
    status: int = 503  # http_error response code (429/503/...)
    retry_after_s: float = 0.0  # Retry-After header on http_error responses
    shift_bytes: int = 64  # bad_content_range: how far the server lies
    burst_n: int = 0  # burst: extra requests the load generator injects

    def __post_init__(self) -> None:
        if self.op not in FAULT_OPS:
            raise ValueError(f"op must be one of {FAULT_OPS}, got {self.op!r}")
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"kind must be one of {FAULT_KINDS}, got {self.kind!r}"
            )
        if self.ordinal < 0:
            raise ValueError("ordinal must be >= 0")
        if self.times is not None and self.times < 1:
            raise ValueError("times must be >= 1 (or None)")
        if not (0.0 < self.probability <= 1.0):
            raise ValueError("probability must be in (0, 1]")
        if self.kind == "short_read" and self.cap_bytes < 1:
            # cap 0 would make read() return b"" — indistinguishable from
            # EOF, i.e. silent truncation instead of a short read
            raise ValueError("short_read requires cap_bytes >= 1")
        if self.kind in ("stall", "trickle") and self.stall_ms <= 0:
            raise ValueError(f"{self.kind} requires stall_ms > 0")
        if self.kind in HTTP_ONLY_KINDS and self.op != "http":
            # these describe server-side wire behavior; a rule asking a
            # file wrapper to RST a connection would silently no-op
            raise ValueError(f"kind {self.kind!r} requires op='http'")
        if self.op == "http" and self.kind not in HTTP_ALLOWED_KINDS:
            raise ValueError(
                f"op='http' supports kinds {HTTP_ALLOWED_KINDS}, got "
                f"{self.kind!r} — the Range server would ledger it as "
                "fired while serving the object clean"
            )
        if self.kind == "http_error" and not 400 <= self.status <= 599:
            raise ValueError("http_error requires a 4xx/5xx status")
        if self.kind == "bad_content_range" and self.shift_bytes == 0:
            raise ValueError("bad_content_range requires shift_bytes != 0")
        if self.kind == "torn_write":
            if self.op != "journal":
                # tearing a record mid-write is a journal-append shape;
                # on any other op it would ledger as fired and do nothing
                raise ValueError("torn_write requires op='journal'")
            if self.cap_bytes < 1:
                raise ValueError("torn_write requires cap_bytes >= 1 (how "
                                 "many record bytes land before the tear)")
        if self.kind == "netsplit" and self.op not in ("connect", "recv"):
            raise ValueError("netsplit requires op='connect' or op='recv'")
        if self.kind in SERVE_ONLY_KINDS and self.op != "serve":
            # these describe serving-tier behavior (a client's half of a
            # request/reply stream, an admission burst); on any other op
            # they would ledger as fired and do nothing
            raise ValueError(f"kind {self.kind!r} requires op='serve'")
        if self.op == "serve" and self.kind not in SERVE_ALLOWED_KINDS:
            raise ValueError(
                f"op='serve' supports kinds {SERVE_ALLOWED_KINDS}, got "
                f"{self.kind!r} — the serving seams would ledger it as "
                "fired while serving clean"
            )
        if self.kind == "slow_client" and self.stall_ms <= 0:
            raise ValueError("slow_client requires stall_ms > 0")
        if self.kind == "burst" and self.burst_n < 1:
            raise ValueError("burst requires burst_n >= 1")

    def matches_path(self, path: str) -> bool:
        return self.path in path


class FaultPlan:
    """A seeded, deterministic, JSON-round-trippable fault scenario plus the
    ledger of what actually fired.

    Thread-safe: per-(op, path) call counters and the ledger are mutated
    under one lock (the pipeline reads from worker threads). ``sleep`` and
    ``clock`` are injectable seams — the default sleep is an interruptible
    wait on the plan's release event, so a test can end every in-flight
    stall at teardown with ``plan.release()``.
    """

    def __init__(
        self,
        rules: List[FaultRule],
        seed: int = 0,
        sleep=None,
        clock=time.monotonic,
    ):
        self.rules = list(rules)
        self.seed = int(seed)
        self.clock = clock
        self._released = threading.Event()
        self.sleep = sleep if sleep is not None else self._default_sleep
        self._lock = threading.Lock()
        self._calls: Dict[tuple, int] = {}  # (op, path) -> calls so far
        self._fired: Dict[int, int] = {}  # rule index -> firings so far
        self.ledger: List[Dict[str, Any]] = []

    # -- construction / serialization ---------------------------------------

    @staticmethod
    def from_json(obj: "str | Dict[str, Any]") -> "FaultPlan":
        if isinstance(obj, str):
            obj = json.loads(obj)
        rules = [FaultRule(**r) for r in obj.get("rules", [])]
        return FaultPlan(rules, seed=int(obj.get("seed", 0)))

    def to_json(self) -> Dict[str, Any]:
        return {"seed": self.seed, "rules": [asdict(r) for r in self.rules]}

    # -- runtime ------------------------------------------------------------

    def _default_sleep(self, seconds: float) -> None:
        self._released.wait(seconds)

    def release(self) -> None:
        """End every in-flight (and future) default-sleep stall immediately
        — test teardown's escape hatch for abandoned reader threads."""
        self._released.set()

    def _coin(self, rule_idx: int, ordinal: int, p: float) -> bool:
        if p >= 1.0:
            return True
        # keyed by (seed, rule, ordinal): the same call makes the same draw
        # no matter how calls from different threads interleave (folded
        # into one int — tuple seeding is deprecated)
        key = (self.seed * 1_000_003 + rule_idx) * 1_000_003 + ordinal
        return random.Random(key).random() < p

    def decide(self, op: str, path: str) -> List[Dict[str, Any]]:
        """Record one (op, path) call and return the faults that fire on it
        (already appended to the ledger), in rule order."""
        fired: List[Dict[str, Any]] = []
        with self._lock:
            key = (op, path)
            n = self._calls.get(key, 0)
            self._calls[key] = n + 1
            for idx, rule in enumerate(self.rules):
                if rule.op != op or not rule.matches_path(path):
                    continue
                if n < rule.ordinal:
                    continue
                if rule.times is not None and self._fired.get(idx, 0) >= rule.times:
                    continue
                if not self._coin(idx, n, rule.probability):
                    continue
                self._fired[idx] = self._fired.get(idx, 0) + 1
                entry = {
                    "rule": idx,
                    "op": op,
                    "path": path,
                    "ordinal": n,
                    "kind": rule.kind,
                }
                if rule.kind in ("stall", "trickle", "slow_client"):
                    entry["stall_ms"] = rule.stall_ms
                if rule.kind == "burst":
                    entry["burst_n"] = rule.burst_n
                if rule.kind in ("short_read", "torn_write"):
                    entry["cap_bytes"] = rule.cap_bytes
                if rule.kind == "http_error":
                    entry["status"] = rule.status
                if rule.kind == "bad_content_range":
                    entry["shift_bytes"] = rule.shift_bytes
                self.ledger.append(entry)
                fired.append(dict(entry, _rule=rule))
        return fired

    def ledger_json(self) -> str:
        """Canonical one-line-per-event encoding — what the determinism
        tests byte-compare across runs."""
        with self._lock:
            return "\n".join(json.dumps(e, sort_keys=True) for e in self.ledger)

    # -- fault execution ----------------------------------------------------

    def _raise_for(self, fault: Dict[str, Any]) -> None:
        rule: FaultRule = fault["_rule"]
        msg = rule.error or (
            f"injected {rule.kind} ({fault['op']} #{fault['ordinal']} "
            f"on {fault['path']})"
        )
        raise InjectedFault(msg)

    def apply(self, op: str, path: str, size: Optional[int] = None) -> Optional[int]:
        """Run the plan for one call: stalls sleep, errors raise, short
        reads return the capped size (None = uncapped). Multiple rules may
        fire on one call (e.g. stall THEN transient error)."""
        cap: Optional[int] = None
        for fault in self.decide(op, path):
            kind = fault["kind"]
            if kind == "stall":
                self.sleep(fault["_rule"].stall_ms / 1000.0)
            elif kind == "short_read":
                c = fault["_rule"].cap_bytes
                if size is None or size < 0 or size > c:
                    cap = c if cap is None else min(cap, c)
            elif kind == "sigkill":
                self._sigkill()
            elif kind in ("transient_error", "permanent_error", "flaky_listing"):
                self._raise_for(fault)
            # rename_race is handled at the rename call site (the rename
            # must LAND before the error) — see ChaosFS.rename;
            # disconnect is socket-only — see apply_socket
        return cap

    @staticmethod
    def _sigkill() -> None:
        """The process-death fault: SIGKILL ourselves, exactly the way a
        chaos test kills a primary dispatcher — no handlers, no cleanup,
        fds closed by the kernel. Only meaningful in subprocess
        scenarios (an in-process test would kill the test runner)."""
        os.kill(os.getpid(), signal.SIGKILL)

    def apply_socket(
        self, op: str, addr: str, sock=None, size: Optional[int] = None
    ) -> Optional[int]:
        """Run the plan for one socket call (``connect``/``recv`` against
        the peer address): stalls sleep, errors raise, short reads return
        the capped recv size, and ``disconnect`` CLOSES the socket before
        raising — so the local side observes the same half-dead-peer state
        a real mid-frame death leaves behind."""
        cap: Optional[int] = None
        for fault in self.decide(op, addr):
            kind = fault["kind"]
            if kind == "stall":
                self.sleep(fault["_rule"].stall_ms / 1000.0)
            elif kind == "short_read":
                c = fault["_rule"].cap_bytes
                if size is None or size < 0 or size > c:
                    cap = c if cap is None else min(cap, c)
            elif kind == "disconnect":
                if sock is not None:
                    try:
                        sock.close()
                    except OSError:
                        pass
                self._raise_for(fault)
            elif kind == "sigkill":
                self._sigkill()
            else:
                # transient_error / permanent_error / netsplit: netsplit
                # raises identically to permanent_error but ledgers under
                # its own kind — a partitioned standby and a crashed peer
                # are different scenarios worth telling apart in a replay
                self._raise_for(fault)
        return cap

    def apply_serve(self, point: str, sock=None) -> int:
        """Run the plan for one serving-tier call (``op="serve"`` against
        the seam point — ``reply:<peer>``, ``recv:<peer>``, or ``load``):
        ``slow_client``/``stall`` sleep (the stuck-client scenario, as the
        server's per-client writer observes it), ``client_disconnect``
        CLOSES the peer socket and raises (the mid-generation hangup whose
        slot must free without perturbing neighbors), errors raise, and
        ``burst`` returns how many EXTRA requests the open-loop generator
        must inject at this call (summed across fired rules, 0 = none)."""
        burst = 0
        for fault in self.decide("serve", point):
            kind = fault["kind"]
            if kind in ("stall", "slow_client"):
                self.sleep(fault["_rule"].stall_ms / 1000.0)
            elif kind == "client_disconnect":
                if sock is not None:
                    try:
                        sock.close()
                    except OSError:
                        pass
                self._raise_for(fault)
            elif kind == "burst":
                burst += fault["_rule"].burst_n
            else:
                self._raise_for(fault)
        return burst

    def apply_journal(self, path: str, data: bytes) -> None:
        """Run the plan for one dispatcher-journal write (``op="journal"``
        against the journal path, ``data`` the full record about to land):
        stalls sleep, errors raise, ``sigkill`` kills the process, and
        ``torn_write`` writes the first ``cap_bytes`` of the record
        DIRECTLY to the journal and then raises — the bytes a host crash
        mid-append would have left behind, which replay must absorb as a
        torn tail."""
        for fault in self.decide("journal", path):
            kind = fault["kind"]
            if kind == "stall":
                self.sleep(fault["_rule"].stall_ms / 1000.0)
            elif kind == "sigkill":
                self._sigkill()
            elif kind == "torn_write":
                torn = data[: fault["_rule"].cap_bytes]
                with open(path, "ab") as fh:
                    fh.write(torn)
                    fh.flush()
                    os.fsync(fh.fileno())
                self._raise_for(fault)
            else:
                self._raise_for(fault)


class _ChaosFile:
    """Read-side fault executor for one open handle: every read()/readinto()
    routes through the plan (stalls, errors, short-read caps)."""

    def __init__(self, inner, plan: FaultPlan, path: str):
        self._inner = inner
        self._plan = plan
        self._path = path

    def read(self, size: int = -1):
        cap = self._plan.apply("read", self._path, size)
        if cap is not None and (size is None or size < 0 or size > cap):
            size = cap
        return self._inner.read(size)

    def readinto(self, b) -> int:
        # route through read() so every fault kind applies uniformly
        data = self.read(len(b))
        b[: len(data)] = data
        return len(data)

    def write(self, data):
        return self._inner.write(data)

    def close(self) -> None:
        self._inner.close()

    @property
    def closed(self):
        return self._inner.closed

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def __iter__(self):
        return iter(self._inner)


class ChaosFS:
    """Fault-injecting wrapper over any FS object (LocalFS, FsspecFS, test
    shims): ``open``/``read``/``rename``/``listdir``-family calls consult
    the plan; everything else passes through untouched."""

    def __init__(self, inner, plan: FaultPlan):
        # name kept so fs.independent_read_handles can walk the wrapper
        # chain to the wrapped backend's capability flag/protocol
        self._fs = inner
        self._plan = plan

    def open(self, path: str, mode: str):
        self._plan.apply("open", path)
        inner = self._fs.open(path, mode)
        if "r" in mode:
            return _ChaosFile(inner, self._plan, path)
        return inner

    def rename(self, src: str, dst: str) -> None:
        fired = self._plan.decide("rename", src)
        for f in fired:
            kind = f["kind"]
            if kind == "stall":
                self._plan.sleep(f["_rule"].stall_ms / 1000.0)
            elif kind in ("transient_error", "permanent_error", "flaky_listing"):
                self._plan._raise_for(f)  # fails BEFORE the rename lands
        self._fs.rename(src, dst)
        if any(f["kind"] == "rename_race" for f in fired):
            raise InjectedFault(
                f"injected rename_race: rename landed but errored ({src})"
            )

    def listdir(self, path: str):
        self._plan.apply("listdir", path)
        return self._fs.listdir(path)

    def glob(self, pattern: str):
        self._plan.apply("listdir", pattern)
        return self._fs.glob(pattern)

    def walk_files(self, root: str, keep):
        self._plan.apply("listdir", root)
        return self._fs.walk_files(root, keep)

    def __getattr__(self, name):
        return getattr(self._fs, name)


@contextlib.contextmanager
def install_chaos(plan: FaultPlan):
    """Route the port's filesystem and socket seams through ``plan`` for the
    duration of the with-block: ``fs.filesystem_for`` results are
    ChaosFS-wrapped, ``fs.local_open`` (the raw-open seam
    ``wire.open_compressed`` uses for plain paths) and
    ``io.dataset._open_local`` (the mmap route's seam) open through the
    plan, the socket seams of ``service_protocol`` consult it for ``connect`` /
    ``recv`` rules, the dispatcher's journal writes for ``journal`` rules,
    the HTTP client (``httpfs``) at every connection
    establishment for ``connect`` rules (a refused connection as the
    client sees it), and the serving tier for ``serve`` rules. Restores
    everything on exit and releases any in-flight default-sleep stalls."""
    from tpu_tfrecord_torch import fs as _fs
    from tpu_tfrecord_torch import httpfs as _httpfs
    from tpu_tfrecord_torch import service as _service
    from tpu_tfrecord_torch import service_protocol as _sp
    from tpu_tfrecord_torch.io import dataset as _dataset

    orig_filesystem_for = _fs.filesystem_for
    orig_local_open = _fs.local_open
    orig_open_local = _dataset._open_local
    orig_chaos_plan = _sp._CHAOS_PLAN
    orig_http_plan = _httpfs._CHAOS_PLAN
    orig_journal_plan = _service._JOURNAL_CHAOS
    global _SERVE_CHAOS
    orig_serve_plan = _SERVE_CHAOS

    def chaos_filesystem_for(path: str):
        return ChaosFS(orig_filesystem_for(path), plan)

    def chaos_local_open(path: str, mode: str):
        if "r" in mode:
            plan.apply("open", path)
            return _ChaosFile(orig_local_open(path, mode), plan, path)
        return orig_local_open(path, mode)

    _fs.filesystem_for = chaos_filesystem_for
    _fs.local_open = chaos_local_open
    _dataset._open_local = chaos_local_open
    _sp._CHAOS_PLAN = plan
    _httpfs._CHAOS_PLAN = plan
    _service._JOURNAL_CHAOS = plan
    _SERVE_CHAOS = plan
    try:
        yield plan
    finally:
        _fs.filesystem_for = orig_filesystem_for
        _fs.local_open = orig_local_open
        _dataset._open_local = orig_open_local
        _sp._CHAOS_PLAN = orig_chaos_plan
        _httpfs._CHAOS_PLAN = orig_http_plan
        _service._JOURNAL_CHAOS = orig_journal_plan
        _SERVE_CHAOS = orig_serve_plan
        plan.release()
