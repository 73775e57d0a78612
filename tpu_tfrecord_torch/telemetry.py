"""Flight recorder (spans) and the bound-ness and training verdicts.

Cut of ``tpu_tfrecord/telemetry.py`` to what the dataset's iterator and
the trainer harness (``harness.py``) read:

- the span recorder: ``SpanRecorder`` (a bounded, thread-safe ring of
  span and instant records), the process-global ``RECORDER``, ``span``,
  ``instant``, ``record_span``, ``enable`` / ``disable`` and the
  Chrome-trace export (``to_chrome_trace``, ``save_chrome_trace``);
- the producer/consumer verdict: ``OCCUPANCY_GAUGE``,
  ``boundness_verdict``, ``verdict_from_metrics`` and ``OccupancyEma``;
- the training verdict: ``TRAIN_PHASES``, the ``train.`` and
  ``train.share.`` prefixes, the two thresholds and ``training_verdict``;
- what the serving tier reads: ``TraceContext`` (a request's trace and
  span ids, shipped over the wire as ``to_json``), ``current_context``
  (the process's identity, adopted on ``RECORDER``), ``record_instant``
  and ``serving_verdict``;
- the telemetry pulse: ``Pulse`` (one JSON line an interval: per-interval
  stage rates, counters, gauges, latency quantiles in milliseconds and
  the verdict, with observers such as the autotune controller merging
  their fields in), ``quantiles_ms`` and ``is_latency_hist``.

Left out: the exporters, the environment hand-off of a trace context and
the trace merger (they wait for the port's fleet layer). The
Chrome trace names its process by the adopted context (``role@host:pid``)
or ``tfrecord:<pid>``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import socket
import threading
import time
import uuid
from typing import Any, Callable, Dict, List, Optional, Tuple


def atomic_write_bytes(path: str, data: bytes) -> None:
    """Write ``data`` to ``path`` through a pid-suffixed tmp file and an
    atomic rename, so a crash mid-write never leaves a truncated file."""
    tmp = f"{path}.tmp-{os.getpid()}-{uuid.uuid4().hex[:8]}"
    try:
        with open(tmp, "wb") as fh:
            fh.write(data)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise


# ---------------------------------------------------------------------------
# Trace context
# ---------------------------------------------------------------------------


def _new_id() -> str:
    return uuid.uuid4().hex[:16]


@dataclasses.dataclass(frozen=True)
class TraceContext:
    """Identity of one process's (or one request's) slice of a trace: the
    JAX package's ``TraceContext``, the same JSON.

    ``trace_id`` is shared by everything in one logical run, ``span_id``
    is this slice's own id and ``parent_span_id`` names the slice that
    spawned it (None at the root); role, host and pid identify the process
    for humans (``label``)."""

    trace_id: str
    span_id: str
    parent_span_id: Optional[str] = None
    role: str = "main"
    host: str = ""
    pid: int = 0

    @staticmethod
    def new(role: str = "main") -> "TraceContext":
        """A fresh root context for this process."""
        return TraceContext(trace_id=_new_id(), span_id=_new_id(), parent_span_id=None,
                            role=role, host=socket.gethostname(), pid=os.getpid())

    def child(self, role: str) -> "TraceContext":
        """The same trace, a new span id, this context's span as the
        parent; host and pid are left for the child to stamp."""
        return TraceContext(trace_id=self.trace_id, span_id=_new_id(),
                            parent_span_id=self.span_id, role=role, host="", pid=0)

    def to_json(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @staticmethod
    def from_json(obj: Dict[str, Any]) -> "TraceContext":
        known = {f.name for f in dataclasses.fields(TraceContext)}
        return TraceContext(**{k: v for k, v in obj.items() if k in known})

    def label(self) -> str:
        """The track label of a merged timeline: ``role@host:pid``."""
        return f"{self.role}@{self.host}:{self.pid}"


def current_context() -> TraceContext:
    """The process's trace context, created and adopted on the global
    recorder at first use."""
    ctx = RECORDER.context
    if ctx is None:
        ctx = RECORDER.adopt(TraceContext.new())
    return ctx


# ---------------------------------------------------------------------------
# Span tracing
# ---------------------------------------------------------------------------


class _NoopSpan:
    """The shared disabled-path context manager: no state, no lock."""

    __slots__ = ()

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> None:
        return None

    def set(self, **attrs) -> None:
        return None


_NOOP = _NoopSpan()


class _SpanCtx:
    """One live span: records (name, begin, duration, tid, attrs) into its
    recorder on exit. An exception through the span marks it ``failed=1``."""

    __slots__ = ("_rec", "name", "attrs", "_t0")

    def __init__(self, rec: "SpanRecorder", name: str, attrs: Optional[dict]):
        self._rec = rec
        self.name = name
        self.attrs = attrs

    def set(self, **attrs) -> None:
        """Attach attrs discovered mid-span (row counts, byte counts)."""
        if self.attrs is None:
            self.attrs = attrs
        else:
            self.attrs.update(attrs)

    def __enter__(self) -> "_SpanCtx":
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        dur = time.perf_counter_ns() - self._t0
        attrs = self.attrs
        if exc_type is not None:
            attrs = dict(attrs or (), failed=1)
        self._rec._record(self.name, self._t0, dur, attrs, "X")
        return None


class SpanRecorder:
    """Thread-safe bounded ring buffer of span and instant records.

    The buffer keeps the newest ``capacity`` records and counts what it
    dropped (``dropped``). ``enabled`` is a plain attribute read on the hot
    path: when False, ``span()`` / ``instant()`` return the shared no-op
    without taking the lock."""

    def __init__(self, capacity: int = 65536, enabled: bool = False):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        self.enabled = enabled
        self._lock = threading.Lock()
        self._ring: List[Optional[tuple]] = [None] * capacity
        self._seq = 0
        self.dropped = 0
        #: the adopted TraceContext (None until ``adopt``/``current_context``);
        #: metadata only, recording never reads it
        self.context: Optional[TraceContext] = None

    def adopt(self, ctx: TraceContext) -> TraceContext:
        """Adopt ``ctx`` as this recorder's process identity, host and pid
        re-stamped to this process."""
        host, pid = socket.gethostname(), os.getpid()
        if ctx.host != host or ctx.pid != pid:
            ctx = dataclasses.replace(ctx, host=host, pid=pid)
        self.context = ctx
        return ctx

    # -- recording -----------------------------------------------------------

    def span(self, name: str, **attrs) -> "_SpanCtx | _NoopSpan":
        if not self.enabled:
            return _NOOP
        return _SpanCtx(self, name, attrs or None)

    def instant(self, name: str, **attrs) -> None:
        if not self.enabled:
            return
        self._record(name, time.perf_counter_ns(), 0, attrs or None, "i")

    def _record(
        self,
        name: str,
        t0_ns: int,
        dur_ns: int,
        attrs: Optional[dict],
        ph: str,
        tid: Optional[int] = None,
    ) -> None:
        if tid is None:
            tid = threading.get_ident()
        with self._lock:
            seq = self._seq
            self._seq = seq + 1
            if seq >= self.capacity:
                self.dropped += 1
            self._ring[seq % self.capacity] = (name, t0_ns, dur_ns, tid, attrs, ph)

    # -- reading -------------------------------------------------------------

    def __len__(self) -> int:
        with self._lock:
            return min(self._seq, self.capacity)

    def spans(self) -> List[tuple]:
        """Snapshot of retained records, oldest first:
        (name, t0_ns, dur_ns, tid, attrs, ph)."""
        with self._lock:
            seq = self._seq
            if seq <= self.capacity:
                return list(self._ring[:seq])
            start = seq % self.capacity
            return [r for r in self._ring[start:] + self._ring[:start] if r is not None]

    def clear(self) -> None:
        with self._lock:
            self._ring = [None] * self.capacity
            self._seq = 0
            self.dropped = 0

    # -- export --------------------------------------------------------------

    def to_chrome_trace(self) -> Dict[str, Any]:
        """The retained records as a Chrome trace-event JSON object (the
        format Perfetto and chrome://tracing load): complete ("X") events
        for spans, thread-scoped instants ("i"), led by process and thread
        name ("M") records."""
        ctx = self.context
        pid = ctx.pid if ctx is not None and ctx.pid else os.getpid()
        pname = ctx.label() if ctx is not None else f"tfrecord:{pid}"
        events: List[Dict[str, Any]] = [
            {"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
             "args": {"name": pname}}
        ]
        thread_names = {t.ident: t.name for t in threading.enumerate()}
        spans = self.spans()
        seen = set()
        for rec in spans:
            tid = rec[3]
            if tid in seen:
                continue
            seen.add(tid)
            name = thread_names.get(tid)
            if name:  # exited threads keep their bare ident
                events.append({"name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
                               "args": {"name": name}})
        for name, t0_ns, dur_ns, tid, attrs, ph in spans:
            ev: Dict[str, Any] = {"name": name, "cat": "tfrecord", "ph": ph,
                                  "ts": t0_ns / 1000.0, "pid": pid, "tid": tid}
            if ph == "X":
                ev["dur"] = dur_ns / 1000.0
            else:
                ev["s"] = "t"
            if attrs:
                ev["args"] = attrs
            events.append(ev)
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def save_chrome_trace(self, path: str) -> None:
        """Export atomically (tmp + rename)."""
        atomic_write_bytes(path, json.dumps(self.to_chrome_trace()).encode("utf-8"))


#: Process-global flight recorder: spans come from dataset iterators,
#: decode threads and the trainer harness onto one timeline.
RECORDER = SpanRecorder()


def span(name: str, **attrs):
    """A duration span on the global recorder; the shared no-op when
    tracing is off."""
    rec = RECORDER
    if not rec.enabled:
        return _NOOP
    return _SpanCtx(rec, name, attrs or None)


def instant(name: str, **attrs) -> None:
    """A point event on the global recorder."""
    rec = RECORDER
    if rec.enabled:
        rec._record(name, time.perf_counter_ns(), 0, attrs or None, "i")


def record_span(name: str, t0_ns: int, dur_ns: int, tid: Optional[int] = None, **attrs) -> None:
    """Record an already-measured duration span (the consumer's batch
    wait, a train step) on the global recorder."""
    rec = RECORDER
    if rec.enabled:
        rec._record(name, t0_ns, dur_ns, attrs or None, "X", tid=tid)


def record_instant(name: str, t0_ns: int, tid: Optional[int] = None, **attrs) -> None:
    """Record a point event at an explicit timestamp (``instant`` stamps
    now): shed and expiry markers on the same clock and lane as the
    request spans around them."""
    rec = RECORDER
    if rec.enabled:
        rec._record(name, t0_ns, 0, attrs or None, "i", tid=tid)


def enable() -> SpanRecorder:
    RECORDER.enabled = True
    return RECORDER


def disable() -> None:
    RECORDER.enabled = False


# ---------------------------------------------------------------------------
# Bound-ness verdict
# ---------------------------------------------------------------------------

#: Gauge the consumer-side iterator maintains: EMA of the prefetch queue's
#: fill fraction sampled at each batch get (io/dataset.py).
OCCUPANCY_GAUGE = "prefetch.occupancy"


def boundness_verdict(occupancy: Optional[float]) -> str:
    """Producer/consumer verdict from a queue fill fraction in [0, 1]:
    ``consumer_bound`` at >= 0.66 (decode keeps ahead), ``producer_bound``
    at <= 0.33 (the consumer waits on decode), ``balanced`` between,
    ``unknown`` without samples."""
    if occupancy is None:
        return "unknown"
    if occupancy >= 0.66:
        return "consumer_bound"
    if occupancy <= 0.33:
        return "producer_bound"
    return "balanced"


def verdict_from_metrics(metrics=None, gauge: str = OCCUPANCY_GAUGE) -> str:
    """The verdict for a registry's occupancy gauge (the process default
    registry when ``metrics`` is None)."""
    if metrics is None:
        from tpu_tfrecord_torch.metrics import METRICS as metrics  # noqa: N813
    return boundness_verdict(metrics.gauge_value(gauge))


# ---------------------------------------------------------------------------
# Training verdict
# ---------------------------------------------------------------------------

#: The step-phase decomposition of the trainer harness (harness.StepPhases):
#: disjoint wall-clock parts of one train step. Stages are
#: ``train.<phase>``; windowed shares are ``train.share.<phase>`` gauges.
TRAIN_PHASES = ("data_wait", "h2d", "compute", "ckpt")
TRAIN_STAGE_PREFIX = "train."
TRAIN_SHARE_PREFIX = "train.share."

#: A step spending at least this share on checkpointing is ckpt_bound; at
#: least this share on input (data_wait + h2d) is input_bound.
TRAIN_CKPT_BOUND_SHARE = 0.25
TRAIN_INPUT_BOUND_SHARE = 0.5


def training_verdict(shares: Optional[Dict[str, float]]) -> str:
    """``input_bound`` / ``compute_bound`` / ``ckpt_bound`` / ``unknown``
    from a step-phase share mapping (missing phases read as 0).
    Checkpointing is checked first: its fix (async or rarer checkpoints)
    differs from adding decode capacity."""
    if not shares or sum(shares.values()) <= 0:
        return "unknown"
    if shares.get("ckpt", 0.0) >= TRAIN_CKPT_BOUND_SHARE:
        return "ckpt_bound"
    input_share = shares.get("data_wait", 0.0) + shares.get("h2d", 0.0)
    if input_share >= TRAIN_INPUT_BOUND_SHARE:
        return "input_bound"
    return "compute_bound"


class OccupancyEma:
    """One EMA (alpha 0.2: the recent regime, not the epoch's warm-up)
    feeding one named gauge."""

    __slots__ = ("gauge", "alpha", "value")

    def __init__(self, gauge: str, alpha: float = 0.2):
        self.gauge = gauge
        self.alpha = alpha
        self.value: Optional[float] = None

    def update(self, fill: float, metrics=None) -> float:
        v = self.value
        self.value = fill if v is None else (1.0 - self.alpha) * v + self.alpha * fill
        if metrics is None:
            from tpu_tfrecord_torch.metrics import METRICS as metrics  # noqa: N813
        metrics.gauge(self.gauge, self.value)
        return self.value


# ---------------------------------------------------------------------------
# Serving verdict
# ---------------------------------------------------------------------------

#: Queue depth at or above this fraction of the serving tier's admission
#: bound reads as queue pressure: the p99 miss is an admission problem.
SERVE_QUEUE_BOUND_FILL = 0.5


def serving_verdict(p99_ms: Optional[float], queue_depth: Optional[float],
                    slo_p99_ms: float, max_queue: int = 16) -> str:
    """Latency-SLO verdict of the serving tier: ``meeting_slo`` when the
    per-request p99 is within ``slo_p99_ms``; on a miss ``queue_bound``
    when the waiting queue holds at least ``SERVE_QUEUE_BOUND_FILL`` of the
    admission bound (latency is queueing: shed harder or add a replica),
    else ``compute_bound`` (the step itself is too slow for the SLO);
    ``unknown`` before any request completed."""
    if p99_ms is None:
        return "unknown"
    if p99_ms <= slo_p99_ms:
        return "meeting_slo"
    depth = 0.0 if queue_depth is None else float(queue_depth)
    if depth >= SERVE_QUEUE_BOUND_FILL * max(1, int(max_queue)):
        return "queue_bound"
    return "compute_bound"


# ---------------------------------------------------------------------------
# Telemetry pulse
# ---------------------------------------------------------------------------

#: Histogram families of dimensionless values (fractions of the model
#: diagnostics), not seconds: the millisecond renderers skip them.
DIMENSIONLESS_HIST_PREFIXES = ("moe.", "pipeline.")


def is_latency_hist(name: str) -> bool:
    return not name.startswith(DIMENSIONLESS_HIST_PREFIXES)


def quantiles_ms(source: Dict[str, Dict[str, float]]) -> Dict[str, Dict[str, float]]:
    """A ``Metrics.quantiles()`` mapping (or any whose entries carry
    ``p50_s`` / ``p90_s`` / ``p99_s``) in milliseconds, rounded to 3
    places, with the observation count; entries without quantiles and the
    dimensionless histograms are left out."""
    out: Dict[str, Dict[str, float]] = {}
    for name, q in sorted(source.items()):
        if not q or "p50_s" not in q or not is_latency_hist(name):
            continue
        entry = {
            "p50_ms": round(q["p50_s"] * 1e3, 3),
            "p90_ms": round(q["p90_s"] * 1e3, 3),
            "p99_ms": round(q["p99_s"] * 1e3, 3),
        }
        if "count" in q:
            entry["count"] = q["count"]
        elif "hist_count" in q:
            entry["count"] = int(q["hist_count"])
        out[name] = entry
    return out


class Pulse:
    """Periodic one-line JSON telemetry, the JAX ``Pulse``.

    Every ``interval_s`` a daemon thread emits one dict through ``emit``
    (default: a ``tfrecord.pulse {json}`` INFO line on the package
    logger). Stage rates are per-interval deltas (a stall shows as a rate
    of zero); counters (stages with no seconds and no bytes) are
    cumulative, with a ``.delta`` entry when they moved; gauges and
    quantiles are snapshots. ``tick()`` forces one line."""

    def __init__(
        self,
        interval_s: float,
        metrics=None,
        emit: Optional[Callable[[Dict[str, Any]], None]] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        if interval_s <= 0:
            raise ValueError("interval_s must be > 0")
        if metrics is None:
            from tpu_tfrecord_torch.metrics import METRICS as metrics  # noqa: N813
        self.interval_s = interval_s
        self.metrics = metrics
        self.emit = emit if emit is not None else _log_pulse
        self._clock = clock
        self._prev_totals: Dict[str, Tuple[int, int, int, float]] = {}
        self._prev_t = clock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._observers: List[Callable[[Dict[str, Any]], Optional[Dict]]] = []

    def add_observer(self, fn: Callable[[Dict[str, Any]], Optional[Dict]]) -> "Pulse":
        """Call ``fn(payload)`` at each tick before the line is emitted and
        merge a returned dict into it. An observer's exception is
        swallowed and counted in ``pulse.observer_errors``."""
        self._observers.append(fn)
        return self

    def start(self) -> "Pulse":
        if self._thread is None:
            self._thread = threading.Thread(target=self._run, daemon=True, name="tfr-pulse")
            self._thread.start()
        return self

    def stop(self, final: bool = True) -> None:
        """Stop the thread; ``final`` emits one last line for the tail
        interval. A second stop does nothing."""
        already = self._stop.is_set()
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=2.0)
            self._thread = None
        if final and not already:
            try:
                self.tick()
            except Exception:  # the tail line is best effort
                pass

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.tick()
            except Exception:  # telemetry never takes the pipeline down
                pass

    def tick(self) -> Dict[str, Any]:
        """Compute and emit one line; returns it."""
        now = self._clock()
        dt = max(now - self._prev_t, 1e-9)
        self._prev_t = now
        totals = self.metrics.raw_totals()
        stages: Dict[str, Dict[str, float]] = {}
        counters: Dict[str, int] = {}
        for name, (records, nbytes, _batches, seconds) in sorted(totals.items()):
            prev = self._prev_totals.get(name, (0, 0, 0, 0.0))
            d_rec = records - prev[0]
            d_bytes = nbytes - prev[1]
            if seconds == 0.0 and nbytes == 0:
                counters[name] = records
                if d_rec:
                    counters[name + ".delta"] = d_rec
                continue
            stages[name] = {
                "records_per_sec": round(d_rec / dt, 1),
                "bytes_per_sec": round(d_bytes / dt, 1),
                "records": records,
            }
        self._prev_totals = totals
        gauges = self.metrics.gauges()
        ctx = current_context()
        payload = {
            "event": "pulse",
            "ts": round(time.time(), 3),
            "interval_s": round(dt, 3),
            "proc": {"host": ctx.host, "pid": ctx.pid, "role": ctx.role,
                     "trace_id": ctx.trace_id},
            "stages": stages,
            "counters": counters,
            "gauges": {k: round(v, 4) for k, v in sorted(gauges.items())},
            "quantiles": quantiles_ms(self.metrics.quantiles()),
            "verdict": boundness_verdict(gauges.get(OCCUPANCY_GAUGE)),
        }
        for fn in list(self._observers):
            try:
                extra = fn(payload)
                if extra:
                    payload.update(extra)
            except Exception:  # shows as a counter on the next line
                try:
                    self.metrics.count("pulse.observer_errors")
                except Exception:
                    pass
        self.emit(payload)
        return payload


def _log_pulse(payload: Dict[str, Any]) -> None:
    from tpu_tfrecord_torch.metrics import logger

    logger.info("tfrecord.pulse %s", json.dumps(payload, sort_keys=True))
