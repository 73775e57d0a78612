"""Fleet flight recorder: the telemetry spool, its aggregation and the
fleet verdict, the cross-process half of the observability plane.

Copy of ``tpu_tfrecord/fleet.py``, the same names and the same rules. The
spool file's JSON is the JAX layout (the same keys, ``SPOOL_VERSION`` 1,
``Histogram.state`` bucket for bucket), so either package's aggregator
reads either package's spool, and a directory that both spool into
merges the same in both. Three pieces:

- **Telemetry spool** (``TelemetrySpool`` / ``acquire_spool``): a process
  with ``TFRecordOptions(telemetry_spool_dir=...)`` (or a trainer under
  ``harness.trainer_spool``, or a serving replica under
  ``run_server(spool_dir=...)``) snapshots its metrics registry every
  interval: cumulative counters, stage totals, gauges and the
  log-bucketed histogram states, with a heartbeat, into one JSONL file
  per process in the spool directory. Each write rewrites the whole
  (bounded) file through a tmp file and an atomic rename, so a crash
  mid-write never leaves a truncated line. Each line is stamped with the
  writer's pid/host/role/trace id over the writer's ``_JOB_META``
  liveness-marker convention (``io.writer.job_marker_payload``). With no
  spool the feature does no work on the hot path.

- **Aggregator** (``TelemetryAggregator``): merges every process's newest
  snapshot into cluster-level counters (exact sums), latency quantiles
  (exact bucket merges: the cluster p99 of the union of observations, not
  a mean of per-process p99s), per-process gauges and a cluster
  boundness verdict; flags a process whose heartbeat went stale (killed,
  wedged, partitioned) as dead; and serves one federated Prometheus
  ``/metrics`` page with ``host``/``pid``/``role`` labels on every family.

- **Readers** (``read_spool``, ``read_spool_history``,
  ``quantiles_ms_from_states``, ``train_phase_shares``): what the SLO
  engine (``slo.py``) and the repo's ``tfrecord_doctor fleet`` / ``slo``
  / ``train`` modes read.

Counters (in the SPOOLING process's registry): ``fleet.spool_writes``
(snapshots landed), ``fleet.spool_errors`` (snapshot attempts that failed
— spooling is telemetry, it must never take the pipeline down).
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from tpu_tfrecord_torch import fs as _fs
from tpu_tfrecord_torch import telemetry
from tpu_tfrecord_torch.telemetry import (
    Histogram,
    TraceContext,
    atomic_write_bytes,
    boundness_verdict,
    quantiles_ms,
)

__all__ = [
    "SPOOL_SUFFIX",
    "DEFAULT_INTERVAL_S",
    "TelemetrySpool",
    "acquire_spool",
    "release_spool",
    "ProcessSnapshot",
    "read_spool",
    "read_spool_history",
    "FleetSnapshot",
    "TelemetryAggregator",
    "train_phase_shares",
]

#: Spool files are ``<host>-<pid>.spool.jsonl`` inside the spool dir; the
#: aggregator globs on the suffix, everything else in the dir is ignored.
SPOOL_SUFFIX = ".spool.jsonl"

#: Snapshot cadence when the option doesn't set one.
DEFAULT_INTERVAL_S = 1.0

#: Bounded per-process snapshot history (the newest line is cumulative and
#: authoritative; older lines exist for trend reads, and the bound keeps
#: the whole-file atomic rewrite O(1) per tick instead of O(ticks)).
DEFAULT_MAX_LINES = 256

#: Snapshot schema version stamped on every line.
SPOOL_VERSION = 1


def spool_path(spool_dir: str, ctx: TraceContext) -> str:
    return os.path.join(spool_dir, f"{ctx.host}-{ctx.pid}{SPOOL_SUFFIX}")


class TelemetrySpool:
    """Periodic atomic snapshot writer for ONE process's metrics registry.

    Same thread model as telemetry.Pulse: a daemon thread ticks every
    ``interval_s``; ``stop(final=True)`` lands one last snapshot so a
    short-lived process still leaves its totals behind. ``tick()`` is
    public for tests and for processes that want a snapshot NOW (e.g.
    just before exec'ing a successor).

    A snapshot line carries cumulative state, so the newest line
    supersedes every older one — the aggregator only ever reads the last
    parseable line per file. Writes go through tmp-file + atomic rename
    of the WHOLE (bounded) file: a crash mid-write leaves the previous
    complete file, never a truncated line.
    """

    def __init__(
        self,
        spool_dir: str,
        role: Optional[str] = None,
        interval_s: Optional[float] = None,
        metrics=None,
        context: Optional[TraceContext] = None,
        max_lines: int = DEFAULT_MAX_LINES,
        clock: Callable[[], float] = time.time,
    ):
        if metrics is None:
            from tpu_tfrecord_torch.metrics import METRICS as metrics  # noqa: N813
        self.metrics = metrics
        self.interval_s = (
            DEFAULT_INTERVAL_S if interval_s is None else float(interval_s)
        )
        if self.interval_s <= 0:
            raise ValueError("interval_s must be > 0")
        self._clock = clock
        # an explicitly injected context is pinned (test seam); otherwise
        # snapshots FOLLOW the live process context, so a trace adopted
        # after the spool started (adopt_shared_trace_context after
        # iterator construction — nothing prevents that ordering) still
        # stamps every later snapshot, keeping spool lines, pulse lines,
        # and Chrome traces under one trace id and trace_id-scoped
        # aggregation from silently dropping the process
        self._pinned_context = context is not None
        if context is None:
            # role=None keeps whatever role the process already adopted
            # (adopt_from_env, adopt_shared_trace_context) — an explicit
            # role re-adopts, which is the telemetry_role option's job
            context = telemetry.current_context()
            if role is not None and context.role != role:
                context = telemetry.adopt(context.with_role(role))
        self.context = context
        if _fs.has_scheme(spool_dir):
            # os.path.abspath would silently mangle "gs://bucket/spool"
            # into a private local dir on every host — each worker would
            # look healthy while the aggregator finds an empty fleet
            raise ValueError(
                f"telemetry_spool_dir must be a local path (mount shared "
                f"storage locally instead); got {spool_dir!r}"
            )
        # normalize once: a relative spool_dir must not re-resolve against
        # a LATER cwd (a chdir between ticks, or between acquire/release,
        # would silently split the spool across directories)
        spool_dir = os.path.abspath(spool_dir)
        os.makedirs(spool_dir, exist_ok=True)
        self.spool_dir = spool_dir
        self.path = spool_path(spool_dir, context)
        self._lines: collections.deque = collections.deque(maxlen=max_lines)
        self._seq = 0
        # the snapshot's `created` stamp is the wall-window start that
        # throughput (records / (heartbeat - created)) divides by, and the
        # records are cumulative on the METRICS REGISTRY — so the epoch
        # must stick to the registry, not this spool instance: a second
        # spool over the same registry (release + re-acquire, back-to-back
        # iterators) keeps the original epoch instead of restarting the
        # window under lifetime totals and overstating the rate
        epoch = getattr(metrics, "_spool_epoch", None)
        if epoch is None:
            epoch = clock()
            try:
                metrics._spool_epoch = epoch
            except AttributeError:
                pass  # slotted/frozen registry: fall back to per-spool
        self._created = epoch
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._tick_lock = threading.Lock()

    # -- snapshot ------------------------------------------------------------

    def snapshot(self, final: bool = False) -> Dict[str, Any]:
        """One cumulative snapshot line (not yet written). ``final`` marks
        a clean shutdown: the aggregator keeps a finished process out of
        the dead list forever, so a completed job never reads as a mass
        kill — only a process that STOPPED heartbeating without saying
        goodbye (SIGKILL, wedge, partition) goes stale."""
        # the writer's _JOB_META stamping convention is the one schema
        # owner for "which process wrote this, and is it alive" — reuse it
        # verbatim and extend with the trace identity
        from tpu_tfrecord_torch.io.writer import job_marker_payload

        job = json.loads(job_marker_payload(created=self._created))
        if not self._pinned_context:
            # follow the LIVE process context: a shared trace adopted
            # after this spool started must stamp every later snapshot.
            # host/pid are restamped to this process at every adopt, so
            # the spool filename derived at init stays correct.
            self.context = telemetry.current_context()
        # identity comes from the adopted context (== this process in
        # production, injectable in tests) so the line always matches the
        # spool filename spool_path() derived from the same context
        job["pid"] = self.context.pid
        job["host"] = self.context.host
        job["role"] = self.context.role
        job["trace_id"] = self.context.trace_id
        job["span_id"] = self.context.span_id
        now = self._clock()
        job["heartbeat"] = now  # spool heartbeats ride the injectable clock
        stages: Dict[str, List[float]] = {}
        counters: Dict[str, int] = {}
        for name, (records, nbytes, batches, seconds) in sorted(
            self.metrics.raw_totals().items()
        ):
            if seconds == 0.0 and nbytes == 0:
                counters[name] = records
            else:
                stages[name] = [records, nbytes, batches, round(seconds, 6)]
        self._seq += 1
        return {
            "event": "spool",
            "v": SPOOL_VERSION,
            "seq": self._seq,
            "ts": round(now, 3),
            "interval_s": self.interval_s,
            **({"final": True} if final else {}),
            "job": job,
            "counters": counters,
            "stages": stages,
            "gauges": {
                k: round(v, 6) for k, v in sorted(self.metrics.gauges().items())
            },
            "hists": self.metrics.hist_states(),
        }

    def tick(self, final: bool = False) -> None:
        """Append one snapshot and atomically rewrite the spool file.
        Never raises: spooling is telemetry (``fleet.spool_errors`` counts
        failures so silent loss is still visible in the registry)."""
        with self._tick_lock:
            try:
                self._lines.append(
                    json.dumps(self.snapshot(final=final), sort_keys=True)
                )
                payload = ("\n".join(self._lines) + "\n").encode("utf-8")
                atomic_write_bytes(self.path, payload)
                self.metrics.count("fleet.spool_writes")
            except Exception:
                try:
                    self.metrics.count("fleet.spool_errors")
                except Exception:  # graftlint: swallow(the spool_errors counter itself failed; spooling never raises)
                    pass

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "TelemetrySpool":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, daemon=True, name="tfr-spool"
            )
            self._thread.start()
        return self

    def stop(self, final: bool = True) -> None:
        """Stop the thread; ``final`` lands one last snapshot — marked as
        a clean shutdown, so the aggregator never flags this process dead
        — so the process's totals survive it. Idempotent."""
        already = self._stop.is_set()
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=2.0)
            self._thread = None
        if final and not already:
            self.tick(final=True)

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.tick()


# One spool per (process, spool_dir): snapshots read the PROCESS-global
# metrics registry, so two concurrently-spooling iterators in one process
# would double-count every stage at aggregation. acquire/release refcount
# the singleton; the last release stops it with a final snapshot.
_SPOOLS: Dict[str, Tuple[TelemetrySpool, int]] = {}
_SPOOLS_LOCK = threading.Lock()


def acquire_spool(
    spool_dir: str,
    role: Optional[str] = None,
    interval_s: Optional[float] = None,
) -> TelemetrySpool:
    """Start (or join) the process's spool for ``spool_dir``. Refcounted:
    every ``acquire_spool`` must be paired with one ``release_spool``."""
    key = os.path.abspath(spool_dir)
    with _SPOOLS_LOCK:
        entry = _SPOOLS.get(key)
        if entry is not None:
            spool, refs = entry
            # joining an existing spool keeps ITS role/interval (the
            # snapshot stream is process-global); a caller who asked for
            # different settings must hear that they were not applied
            from tpu_tfrecord_torch.metrics import logger

            if interval_s is not None and float(interval_s) != spool.interval_s:
                logger.warning(
                    "tfrecord.fleet spool for %s already ticking every "
                    "%gs; requested interval %gs ignored",
                    spool_dir, spool.interval_s, interval_s,
                )
            if role is not None and role != spool.context.role:
                logger.warning(
                    "tfrecord.fleet spool for %s already stamped with "
                    "role %r; requested role %r ignored",
                    spool_dir, spool.context.role, role,
                )
            _SPOOLS[key] = (spool, refs + 1)
            return spool
        spool = TelemetrySpool(spool_dir, role=role, interval_s=interval_s)
        spool.start()
        _SPOOLS[key] = (spool, 1)
        return spool


def release_spool(spool_dir: str) -> None:
    """Drop one reference; the last one stops the spool with a final
    snapshot. Unmatched releases are ignored (close + GC finalizer may
    both fire)."""
    key = os.path.abspath(spool_dir)
    with _SPOOLS_LOCK:
        entry = _SPOOLS.get(key)
        if entry is None:
            return
        spool, refs = entry
        if refs > 1:
            _SPOOLS[key] = (spool, refs - 1)
            return
        del _SPOOLS[key]
    spool.stop(final=True)


# ---------------------------------------------------------------------------
# Reading spools back
# ---------------------------------------------------------------------------


@dataclass
class ProcessSnapshot:
    """The newest parseable snapshot of one process's spool file."""

    path: str
    host: str
    pid: int
    role: str
    trace_id: Optional[str]
    heartbeat: float
    interval_s: float
    seq: int
    #: Spool start time on the writer's clock (job marker ``created``):
    #: ``heartbeat - created`` is the process's wall-clock observation
    #: window, the honest denominator for throughput (stage ``seconds``
    #: are cumulative BUSY seconds summed across worker threads).
    created: float = 0.0
    #: True when the newest snapshot is a clean-shutdown marker
    #: (TelemetrySpool.stop's final tick): the process FINISHED — the
    #: aggregator never flags it dead, however stale its heartbeat.
    final: bool = False
    counters: Dict[str, int] = field(default_factory=dict)
    stages: Dict[str, List[float]] = field(default_factory=dict)
    gauges: Dict[str, float] = field(default_factory=dict)
    hists: Dict[str, dict] = field(default_factory=dict)
    lines: int = 0
    skipped_lines: int = 0

    def heartbeat_age(self, now: float) -> float:
        return max(0.0, now - self.heartbeat)


def _snapshot_from_line(path: str, obj: Any) -> ProcessSnapshot:
    """Coerce one parsed spool line into a ProcessSnapshot, validating
    every field the aggregator will arithmetic on — raises ValueError/
    TypeError/KeyError on anything malformed (a version-skewed writer, a
    hand-edited file), so a bad LINE is skipped by read_spool instead of
    a bad FILE crashing the whole fleet aggregation later."""
    if obj.get("event") != "spool":
        raise ValueError(obj.get("event"))
    job = obj.get("job") or {}
    stages: Dict[str, List[float]] = {}
    for name, t in (obj.get("stages") or {}).items():
        if len(t) != 4:
            raise ValueError(f"stage {name!r}: expected 4 totals, got {t!r}")
        stages[str(name)] = [int(t[0]), int(t[1]), int(t[2]), float(t[3])]
    return ProcessSnapshot(
        path=path,
        host=str(job.get("host", "?")),
        pid=int(job.get("pid", 0)),
        role=str(job.get("role", "?")),
        trace_id=job.get("trace_id"),
        heartbeat=float(job.get("heartbeat", 0.0)),
        interval_s=float(obj.get("interval_s", DEFAULT_INTERVAL_S)),
        seq=int(obj.get("seq", 0)),
        created=float(job.get("created", 0.0)),
        final=bool(obj.get("final", False)),
        counters={
            str(k): int(v) for k, v in (obj.get("counters") or {}).items()
        },
        stages=stages,
        gauges={str(k): float(v) for k, v in (obj.get("gauges") or {}).items()},
        hists=dict(obj.get("hists") or {}),
    )


def read_spool(path: str) -> Optional[ProcessSnapshot]:
    """Parse one spool file: the newest valid line wins (lines are
    cumulative), so the scan runs newest-first and STOPS at the first
    valid line — aggregation and Prometheus scrapes pay one line's parse
    per process, not the whole bounded history's. Invalid lines — a torn
    write from a pre-atomic-rename crash, stray garbage, a version-skewed
    writer's unparseable shapes — are skipped and counted
    (``skipped_lines``; only lines newer than the winning one are ever
    tried), not fatal; a file with no valid line at all returns None."""
    try:
        with open(path, "rb") as fh:
            raw_lines = fh.read().splitlines()
    except OSError:
        return None
    raw_lines = [raw for raw in raw_lines if raw.strip()]
    skipped = 0
    for raw in reversed(raw_lines):
        try:
            newest = _snapshot_from_line(path, json.loads(raw))
        except (ValueError, TypeError, KeyError, AttributeError):
            skipped += 1
            continue
        newest.lines = len(raw_lines)
        newest.skipped_lines = skipped
        return newest
    return None


def read_spool_history(path: str) -> List[ProcessSnapshot]:
    """Parse EVERY valid line of one spool file, oldest first — the
    windowed time series the SLO engine's burn-rate math needs (each line
    is a cumulative snapshot stamped with the writer's ``ts``, so
    consecutive lines difference into per-interval deltas). Same skip
    semantics as ``read_spool``: invalid lines are dropped, never fatal;
    an unreadable file is an empty history. Each snapshot's ``heartbeat``
    carries its own line's timestamp (cumulative-at-that-moment), and
    ``skipped_lines`` on the last snapshot counts the file's bad lines."""
    try:
        with open(path, "rb") as fh:
            raw_lines = fh.read().splitlines()
    except OSError:
        return []
    out: List[ProcessSnapshot] = []
    skipped = 0
    for raw in raw_lines:
        if not raw.strip():
            continue
        try:
            snap = _snapshot_from_line(path, json.loads(raw))
        except (ValueError, TypeError, KeyError, AttributeError):
            skipped += 1
            continue
        out.append(snap)
    if out:
        out[-1].lines = len(out)
        out[-1].skipped_lines = skipped
    return out


@dataclass
class FleetSnapshot:
    """One merged cluster-level view over every process in a spool dir."""

    processes: List[ProcessSnapshot]
    alive: List[ProcessSnapshot]
    dead: List[ProcessSnapshot]
    counters: Dict[str, int]
    stages: Dict[str, List[float]]
    hists: Dict[str, Histogram]
    verdict: str
    occupancy: Optional[float]

    def quantiles(self) -> Dict[str, Dict[str, float]]:
        return {name: h.quantiles() for name, h in self.hists.items() if h.count}


class TelemetryAggregator:
    """Merge a spool directory into one cluster picture.

    - counters and stage totals SUM exactly (they are cumulative ints).
    - histograms merge bucket-exactly (telemetry.Histogram.merge_state) —
      the cluster p99 is the quantile of the union of observations, not a
      mean of per-process p99s.
    - gauges stay per-process (an occupancy averaged across processes
      before the verdict would hide one starved worker behind two full
      ones — the cluster verdict uses the mean of ALIVE processes'
      occupancy but the per-process values are preserved for the doctor).
    - liveness: a process whose newest heartbeat is older than
      ``stale_after_s`` (default: 2x its own declared snapshot interval)
      is dead — killed, wedged, or partitioned; its totals still count
      (they happened) but its staleness is first-class in the output.

    ``clock`` is injectable so staleness tests need no real waiting.
    """

    def __init__(
        self,
        spool_dir: str,
        stale_after_s: Optional[float] = None,
        clock: Callable[[], float] = time.time,
        trace_id: Optional[str] = None,
    ):
        if _fs.has_scheme(spool_dir):
            raise ValueError(
                f"spool_dir must be a local path (mount shared storage "
                f"locally instead); got {spool_dir!r}"
            )
        self.spool_dir = spool_dir
        self.stale_after_s = stale_after_s
        self._clock = clock
        #: When set, only spool files stamped with this trace id are
        #: merged — scopes a REUSED spool directory to one run (leftover
        #: files from a previous run carry its trace id, and merging them
        #: would silently double-count; the fleet line's ``trace_ids``
        #: list discloses a mixed directory when no filter is given).
        self.trace_id = trace_id

    def processes(
        self, roles: Optional[List[str]] = None
    ) -> List[ProcessSnapshot]:
        """Newest snapshot per spool file, name-sorted (deterministic).
        ``roles`` filters to processes stamped with one of the given
        telemetry roles — e.g. ``dispatcher --elastic --scaler-roles
        trainer`` scopes the fleet scaler's verdict to trainer processes
        only, so no other process's telemetry can ever vote on decode
        capacity. (Unscoped, the verdict already ignores processes with
        no occupancy gauge; the filter makes the boundary explicit
        rather than incidental.) Raises OSError when the spool dir
        itself is unreadable — an unreadable fleet must not look like an
        empty (healthy) one."""
        names = sorted(
            n for n in os.listdir(self.spool_dir) if n.endswith(SPOOL_SUFFIX)
        )
        snaps = []
        for name in names:
            snap = read_spool(os.path.join(self.spool_dir, name))
            if snap is not None and (
                self.trace_id is None or snap.trace_id == self.trace_id
            ) and (roles is None or snap.role in roles):
                snaps.append(snap)
        return snaps

    def _stale_after(self, snap: ProcessSnapshot) -> float:
        if self.stale_after_s is not None:
            return self.stale_after_s
        return 2.0 * snap.interval_s

    def aggregate(self, roles: Optional[List[str]] = None) -> FleetSnapshot:
        now = self._clock()
        procs = self.processes(roles)
        alive: List[ProcessSnapshot] = []
        dead: List[ProcessSnapshot] = []
        counters: Dict[str, int] = {}
        stages: Dict[str, List[float]] = {}
        hists: Dict[str, Histogram] = {}
        for p in procs:
            # a clean-shutdown (final) snapshot means the process FINISHED:
            # stale heartbeats only indict processes that never said goodbye
            (alive if p.final or p.heartbeat_age(now) <= self._stale_after(p)
             else dead).append(p)
            for name, v in p.counters.items():
                counters[name] = counters.get(name, 0) + v
            for name, totals in p.stages.items():
                agg = stages.setdefault(name, [0, 0, 0, 0.0])
                for i in range(4):
                    agg[i] += totals[i]
            for name, state in p.hists.items():
                # same resilience contract as read_spool: one process's
                # corrupt/foreign-layout histogram state loses that stage's
                # buckets for that process, never the whole fleet picture
                try:
                    hists.setdefault(name, Histogram()).merge_state(state)
                except (ValueError, TypeError, KeyError, IndexError):
                    continue
        # verdict from RUNNING processes when any exist: a finished
        # process's frozen last occupancy describes its exit moment, and
        # averaging it in would mask a starved still-running worker. With
        # NOTHING running the fleet is a post-mortem, and the finished
        # processes' exit-state occupancy is the only (and right) evidence.
        running = [p for p in alive if not p.final]
        occs = [
            p.gauges[telemetry.OCCUPANCY_GAUGE]
            for p in (running or alive)
            if telemetry.OCCUPANCY_GAUGE in p.gauges
        ]
        occupancy = sum(occs) / len(occs) if occs else None
        return FleetSnapshot(
            processes=procs,
            alive=alive,
            dead=dead,
            counters=counters,
            stages=stages,
            hists=hists,
            verdict=boundness_verdict(occupancy),
            occupancy=occupancy,
        )

    # -- federated Prometheus page -------------------------------------------

    def prometheus_text(self) -> str:
        """The whole fleet in Prometheus text exposition format: every
        sample labeled with its process's ``host``/``pid``/``role`` (sum
        over processes in PromQL: ``sum by (stage) (...)``), plus
        process-liveness families and cluster-exact latency quantiles
        from the merged histograms. One contiguous block per family —
        strict parsers reject interleaved families as duplicates (same
        rule as telemetry.prometheus_text)."""
        now = self._clock()
        snap = self.aggregate()
        alive = set(id(p) for p in snap.alive)
        lines: List[str] = []

        esc = telemetry.escape_label_value

        def labels(p: ProcessSnapshot, **extra: str) -> str:
            parts = [
                f'host="{esc(p.host)}"', f'pid="{p.pid}"',
                f'role="{esc(p.role)}"',
            ] + [f'{k}="{esc(v)}"' for k, v in extra.items()]
            return "{" + ",".join(parts) + "}"

        def family(fam: str, ftype: str, samples: List[str]) -> None:
            telemetry.append_family(lines, fam, ftype, samples)

        family(
            "tfrecord_process_up",
            "gauge",
            [
                f"tfrecord_process_up{labels(p)} {int(id(p) in alive)}"
                for p in snap.processes
            ],
        )
        family(
            "tfrecord_process_heartbeat_age_seconds",
            "gauge",
            [
                f"tfrecord_process_heartbeat_age_seconds{labels(p)} "
                f"{p.heartbeat_age(now):.3f}"
                for p in snap.processes
            ],
        )
        family(
            "tfrecord_stage_records_total",
            "counter",
            [
                f"tfrecord_stage_records_total{labels(p, stage=n)} {t[0]}"
                for p in snap.processes
                for n, t in sorted(p.stages.items())
            ]
            + [
                f"tfrecord_stage_records_total{labels(p, stage=n)} {v}"
                for p in snap.processes
                for n, v in sorted(p.counters.items())
            ],
        )
        family(
            "tfrecord_stage_bytes_total",
            "counter",
            [
                f"tfrecord_stage_bytes_total{labels(p, stage=n)} {t[1]}"
                for p in snap.processes
                for n, t in sorted(p.stages.items())
                if t[1]
            ],
        )
        family(
            "tfrecord_stage_seconds_total",
            "counter",
            [
                f"tfrecord_stage_seconds_total{labels(p, stage=n)} {t[3]:.6f}"
                for p in snap.processes
                for n, t in sorted(p.stages.items())
                if t[3]
            ],
        )
        family(
            "tfrecord_gauge",
            "gauge",
            [
                f"tfrecord_gauge{labels(p, name=n)} {v:.6g}"
                for p in snap.processes
                for n, v in sorted(p.gauges.items())
            ],
        )
        family(
            "tfrecord_fleet_latency_seconds",
            "summary",
            telemetry.summary_family_lines(
                "tfrecord_fleet_latency_seconds",
                (
                    (f'stage="{esc(name)}"', q)
                    for name, q in sorted(snap.quantiles().items())
                    # dimensionless diagnostic hists (moe.*, pipeline.*)
                    # are fractions, not seconds — a latency family must
                    # not carry them
                    if telemetry.is_latency_hist(name)
                ),
            ),
        )
        # Exemplars ride a dedicated gauge family (value = the exemplared
        # observation in seconds) rather than OpenMetrics `# {...}` sample
        # suffixes: the text-format 0.0.4 parsers the existing pages pin
        # would reject the suffix syntax. `le` carries the bucket's upper
        # bound so a dashboard can join an exemplar to the quantile family.
        family(
            "tfrecord_fleet_latency_exemplar_seconds",
            "gauge",
            [
                "tfrecord_fleet_latency_exemplar_seconds{"
                f'stage="{esc(name)}",le="{Histogram.bucket_le(idx):.6g}",'
                f'trace_id="{esc(t)}",span_id="{esc(s)}"'
                "} " + f"{v:.6g}"
                for name, h in sorted(snap.hists.items())
                if telemetry.is_latency_hist(name)
                for idx, (t, s, v) in sorted(h.exemplars.items())
            ],
        )
        return "\n".join(lines) + "\n"

    def serve(self, port: int):
        """Serve the federated page on 127.0.0.1:PORT (stdlib HTTP, same
        per-port server table as the single-process exporter — use
        telemetry.exporter_address/shutdown_exporter with the same
        requested port)."""
        return telemetry.serve_text_endpoint(
            port, self.prometheus_text, kind="fleet"
        )


def quantiles_ms_from_states(hists: Dict[str, dict]) -> Dict[str, Dict[str, float]]:
    """Per-stage p50/p90/p99 in ms from spooled histogram states — the
    same output shape as telemetry.quantiles_ms, for per-process doctor
    lines."""
    return quantiles_ms(
        {
            name: Histogram.from_states([state]).quantiles()
            for name, state in hists.items()
        }
    )


def train_phase_shares(snap: ProcessSnapshot) -> Optional[Dict[str, float]]:
    """A trainer's step-phase shares from its spool snapshot, or None for
    a process that never recorded the train phases (a reader/worker).

    Prefers the WINDOWED ``train.share.<phase>`` gauges the harness
    publishes (the recent regime — what the verdict should describe);
    falls back to shares computed from the cumulative ``train.<phase>``
    stage seconds (lifetime average) for trainers that died before a
    window completed. Keys are telemetry.TRAIN_PHASES entries."""
    gauges = {
        phase: snap.gauges[telemetry.TRAIN_SHARE_PREFIX + phase]
        for phase in telemetry.TRAIN_PHASES
        if telemetry.TRAIN_SHARE_PREFIX + phase in snap.gauges
    }
    if gauges:
        return gauges
    seconds = {
        phase: snap.stages[telemetry.TRAIN_STAGE_PREFIX + phase][3]
        for phase in telemetry.TRAIN_PHASES
        if telemetry.TRAIN_STAGE_PREFIX + phase in snap.stages
    }
    total = sum(seconds.values())
    if total <= 0:
        return None
    return {phase: s / total for phase, s in seconds.items()}
