"""Flight recorder (spans), the verdicts, the pulse and the exporters.

Copy of ``tpu_tfrecord/telemetry.py`` for one process:

- the span recorder: ``SpanRecorder`` (a bounded, thread-safe ring of
  span and instant records), the process-global ``RECORDER``, ``span``,
  ``instant``, ``record_span``, ``record_instant``, ``enable`` /
  ``disable`` (``TFRecordOptions(trace="on")`` enables it; "off" never
  disables it), the Chrome-trace export (``to_chrome_trace``,
  ``save_chrome_trace``) and ``merge_chrome_traces``, which fuses several
  processes' traces into one timeline with a named track each;
- the trace context: ``TraceContext`` (a process's or a request's trace
  and span ids, shipped over the wire as ``to_json`` and to a child
  process as ``to_env``), ``current_context``, ``adopt``,
  ``adopt_from_env`` and ``adopt_child_from_json``;
- the producer/consumer verdict: ``OCCUPANCY_GAUGE``,
  ``boundness_verdict``, ``verdict_from_metrics`` and ``OccupancyEma``;
- the training verdict: ``TRAIN_PHASES``, the ``train.`` and
  ``train.share.`` prefixes, the two thresholds and ``training_verdict``;
  the serving verdict ``serving_verdict``;
- the telemetry pulse: ``Pulse`` (one JSON line an interval: per-interval
  stage rates, counters, gauges, latency quantiles in milliseconds and
  the verdict, with observers such as the autotune controller merging
  their fields in), ``quantiles_ms`` and ``is_latency_hist``;
- the Prometheus text page: ``prometheus_text`` (stage totals, gauges,
  latency summaries and the histograms' exemplars) with
  ``escape_label_value``, ``append_family`` and ``summary_family_lines``,
  served by ``ensure_exporter`` (``TFRecordOptions(telemetry_port=...)``;
  a stdlib ``http.server`` on 127.0.0.1, 0 = an ephemeral port) over
  ``serve_text_endpoint``, with ``exporter_address`` and
  ``shutdown_exporter``. ``Histogram`` lives in ``metrics.py`` and is
  re-exported here.

The cluster spool, its aggregator and the fleet's federated page are in
``fleet.py``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import socket
import threading
import time
import uuid
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

from tpu_tfrecord_torch.metrics import Histogram

__all__ = [
    "Histogram",
    "SpanRecorder",
    "Pulse",
    "RECORDER",
    "TraceContext",
    "current_context",
    "adopt",
    "adopt_from_env",
    "adopt_child_from_json",
    "span",
    "instant",
    "record_span",
    "record_instant",
    "enable",
    "disable",
    "boundness_verdict",
    "verdict_from_metrics",
    "OccupancyEma",
    "quantiles_ms",
    "merge_chrome_traces",
    "atomic_write_bytes",
    "escape_label_value",
    "append_family",
    "summary_family_lines",
    "prometheus_text",
    "ensure_exporter",
    "serve_text_endpoint",
    "exporter_address",
    "shutdown_exporter",
]


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

#: The environment variable that carries a serialized TraceContext from a
#: parent process to its children (``TraceContext.to_env`` writes it,
#: ``adopt_from_env`` reads it).
TRACE_CONTEXT_ENV = "TFR_TRACE_CONTEXT"


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

    def with_role(self, role: str) -> "TraceContext":
        return dataclasses.replace(self, role=role)

    def to_json(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @staticmethod
    def from_json(obj: Dict[str, Any]) -> "TraceContext":
        known = {f.name for f in dataclasses.fields(TraceContext)}
        return TraceContext(**{k: v for k, v in obj.items() if k in known})

    def to_env(self) -> Dict[str, str]:
        """{TFR_TRACE_CONTEXT: payload} to merge into a child process's
        environment: the child's ``adopt_from_env`` joins this trace."""
        return {TRACE_CONTEXT_ENV: json.dumps(self.to_json(), sort_keys=True)}

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


def adopt(ctx: TraceContext) -> TraceContext:
    """Adopt ``ctx`` as this process's identity on the global recorder,
    host and pid re-stamped to this process (ids propagate, identities
    never do)."""
    return RECORDER.adopt(ctx)


def _adopt_child_of(obj: Any, role: Optional[str]) -> TraceContext:
    """Adopt a context that joins the trace ``obj`` (a parsed TraceContext
    JSON object) describes: the parent's trace id, the parent's span as
    our parent, a span id of our own. A malformed payload raises."""
    if not isinstance(obj, dict):
        raise ValueError(f"not a JSON object: {obj!r}")
    parent = TraceContext.from_json(obj)
    return RECORDER.adopt(TraceContext(
        trace_id=parent.trace_id, span_id=_new_id(), parent_span_id=parent.span_id,
        role=role if role is not None else parent.role))


def adopt_from_env(role: Optional[str] = None,
                   environ: Optional[Dict[str, str]] = None) -> TraceContext:
    """Join the trace a parent process shipped in ``TFR_TRACE_CONTEXT``;
    without it, or with a malformed payload, adopt a fresh root context
    (so a subprocess can call this unconditionally)."""
    environ = os.environ if environ is None else environ
    raw = environ.get(TRACE_CONTEXT_ENV)
    if raw:
        try:
            return _adopt_child_of(json.loads(raw), role)
        except (ValueError, TypeError, KeyError, AttributeError):
            pass  # a malformed payload must not take the pipeline down
    return RECORDER.adopt(TraceContext.new(role if role is not None else "main"))


def adopt_child_from_json(obj: Any, role: Optional[str] = None) -> TraceContext:
    """Join the trace of a coordinator that handed over its context in a
    wire payload rather than a spawn environment; a malformed payload
    adopts a fresh root and never raises."""
    try:
        return _adopt_child_of(obj, role)
    except (ValueError, TypeError, KeyError, AttributeError):
        return RECORDER.adopt(TraceContext.new(role if role is not None else "main"))


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
        name ("M") records. The adopted context rides the top-level
        ``traceContext`` key, which ``merge_chrome_traces`` reads to tell
        processes of different hosts apart."""
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
        out: Dict[str, Any] = {"traceEvents": events, "displayTimeUnit": "ms"}
        if ctx is not None:
            out["traceContext"] = ctx.to_json()
        return out

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


def merge_chrome_traces(out_path: str, in_paths: Iterable[str]) -> Dict[str, Any]:
    """Fuse several processes' Chrome trace files into one timeline with a
    named track a process, written atomically to ``out_path`` and
    returned (the JAX merger, the same output for the same inputs).

    A pid is unique only on one host: two files whose events share a pid
    but whose ``traceContext`` names another host or root span get a fresh
    pid, so their tracks never interleave. A pid with no ``process_name``
    record gets one from its context's label, else the file's name. An
    unreadable or malformed input raises (ValueError, OSError): a process
    dropped in silence would make the timeline lie."""
    files = []
    for path in in_paths:
        with open(path, "rb") as fh:
            try:
                obj = json.load(fh)
            except ValueError as e:
                raise ValueError(f"{path}: not valid JSON: {e}") from None
        if not isinstance(obj, dict) or not isinstance(obj.get("traceEvents"), list):
            raise ValueError(f"{path}: not a Chrome trace-event JSON object")
        files.append((path, obj))
    events: List[Dict[str, Any]] = []
    contexts: List[Dict[str, Any]] = []
    owner: Dict[int, tuple] = {}  # output pid -> the identity holding it
    max_pid = 0
    for _, obj in files:
        for ev in obj["traceEvents"]:
            if isinstance(ev.get("pid"), int):
                max_pid = max(max_pid, ev["pid"])
    for idx, (path, obj) in enumerate(files):
        ctx = obj.get("traceContext")
        if not isinstance(ctx, dict):
            ctx = None
        if ctx is not None:
            contexts.append(ctx)
        # same host and root span = same process; a file without a
        # context is an identity of its own
        ident_base = ((ctx.get("host"), ctx.get("pid"), ctx.get("span_id")) if ctx is not None
                      else (os.path.basename(path), idx))
        named = {ev.get("pid", 0) for ev in obj["traceEvents"]
                 if ev.get("ph") == "M" and ev.get("name") == "process_name"}
        remap: Dict[int, int] = {}
        file_events: List[Dict[str, Any]] = []
        for ev in obj["traceEvents"]:
            pid = ev.get("pid", 0)
            out_pid = remap.get(pid)
            if out_pid is None:
                ident = ident_base + (pid,)
                out_pid = pid
                if owner.get(out_pid, ident) != ident:
                    max_pid += 1
                    out_pid = max_pid
                owner[out_pid] = ident
                remap[pid] = out_pid
                if pid not in named:
                    label = (f"{ctx.get('role', 'proc')}@{ctx.get('host', '?')}:{pid}"
                             if ctx is not None else os.path.basename(path))
                    events.append({"name": "process_name", "ph": "M", "pid": out_pid,
                                   "tid": 0, "args": {"name": label}})
            if out_pid != pid:
                ev = dict(ev, pid=out_pid)
            file_events.append(ev)
        events.extend(file_events)
    merged: Dict[str, Any] = {"traceEvents": events, "displayTimeUnit": "ms"}
    if contexts:
        merged["traceContexts"] = contexts
    atomic_write_bytes(out_path, json.dumps(merged).encode("utf-8"))
    return merged


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


# ---------------------------------------------------------------------------
# Prometheus text endpoint (stdlib HTTP only)
# ---------------------------------------------------------------------------


def escape_label_value(v: Any) -> str:
    """Prometheus label-value escaping of a backslash, a quote and a
    newline."""
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def append_family(lines: List[str], fam: str, ftype: str, samples: List[str]) -> None:
    """Append one metric family under its ``# TYPE`` line: the samples of
    a family form one contiguous block (strict parsers reject a family
    split in two); an empty family is left out."""
    if samples:
        lines.append(f"# TYPE {fam} {ftype}")
        lines.extend(samples)


def summary_family_lines(fam: str,
                         labeled_quantiles: Iterable[Tuple[str, Dict[str, float]]]) -> List[str]:
    """The samples of a p50/p90/p99 summary family from ``quantiles()``
    entries: one ``fam{<labels>,quantile="q"} v`` line a quantile and the
    ``fam_count{<labels>}`` line."""
    samples: List[str] = []
    for label, q in labeled_quantiles:
        if not q:
            continue
        for key, quant in (("p50_s", "0.5"), ("p90_s", "0.9"), ("p99_s", "0.99")):
            samples.append(f'{fam}{{{label},quantile="{quant}"}} {q[key]:.9f}')
        samples.append(f'{fam}_count{{{label}}} {q["count"]}')
    return samples


def prometheus_text(metrics=None) -> str:
    """The registry in the Prometheus text format, the JAX page byte for
    byte: stage totals as counters, gauges, latency quantiles as a summary
    family and each histogram's exemplars as a gauge family (value = the
    exemplared observation in seconds, ``le`` its bucket's bound). Stage
    and gauge names ride in label values, so the family names stay fixed."""
    if metrics is None:
        from tpu_tfrecord_torch.metrics import METRICS as metrics  # noqa: N813
    totals = sorted(metrics.raw_totals().items())
    lines: List[str] = []
    append_family(lines, "tfrecord_stage_records_total", "counter",
                  [f'tfrecord_stage_records_total{{stage="{n}"}} {r}'
                   for n, (r, _b, _bt, _s) in totals])
    append_family(lines, "tfrecord_stage_bytes_total", "counter",
                  [f'tfrecord_stage_bytes_total{{stage="{n}"}} {b}'
                   for n, (_r, b, _bt, _s) in totals if b])
    append_family(lines, "tfrecord_stage_seconds_total", "counter",
                  [f'tfrecord_stage_seconds_total{{stage="{n}"}} {s:.6f}'
                   for n, (_r, _b, _bt, s) in totals if s])
    append_family(lines, "tfrecord_gauge", "gauge",
                  [f'tfrecord_gauge{{name="{name}"}} {value:.6g}'
                   for name, value in sorted(metrics.gauges().items())])
    append_family(lines, "tfrecord_latency_seconds", "summary",
                  summary_family_lines("tfrecord_latency_seconds",
                                       ((f'stage="{name}"', q)
                                        for name, q in sorted(metrics.quantiles().items()))))
    append_family(lines, "tfrecord_latency_exemplar_seconds", "gauge", [
        "tfrecord_latency_exemplar_seconds{"
        f'stage="{escape_label_value(name)}",'
        f'le="{Histogram.bucket_le(int(idx)):.6g}",'
        f'trace_id="{escape_label_value(t)}",'
        f'span_id="{escape_label_value(sid)}"'
        "} " + f"{v:.6g}"
        for name, state in sorted(metrics.hist_states().items())
        if is_latency_hist(name)
        for idx, (t, sid, v) in sorted((state.get("exemplars") or {}).items(),
                                        key=lambda kv: int(kv[0]))
    ])
    return "\n".join(lines) + "\n"


_EXPORTERS: Dict[int, Any] = {}
_EXPORTERS_LOCK = threading.Lock()


def ensure_exporter(port: int, metrics=None):
    """Start, or return the one already running, the Prometheus text
    endpoint of ``metrics`` (the process registry by default) on
    127.0.0.1:``port``: process-wide, one a requested port, on a daemon
    thread. Port 0 binds an ephemeral port; ``exporter_address(0)`` tells
    which. Serves ``/metrics`` and ``/``; anything else is a 404. A port
    that cannot be bound logs a warning and returns None: telemetry never
    takes the pipeline down."""
    if metrics is None:
        from tpu_tfrecord_torch.metrics import METRICS as metrics  # noqa: N813
    reg = metrics
    return serve_text_endpoint(port, lambda: prometheus_text(reg))


def serve_text_endpoint(port: int, render: Callable[[], str], kind: str = "process"):
    """The HTTP server under ``ensure_exporter``, keyed by the requested
    port and parameterized on the page it renders. A requested port that
    already serves another ``kind`` of page warns and returns None rather
    than hand back a server that serves the wrong page."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    from tpu_tfrecord_torch.metrics import logger

    with _EXPORTERS_LOCK:
        server = _EXPORTERS.get(port)
        if server is not None:
            served = getattr(server, "_tfr_kind", "process")
            if served != kind:
                logger.warning(
                    "tfrecord.telemetry endpoint for requested port %d already serves the "
                    "%r page; NOT replacing it with the requested %r page — use a different "
                    "port", port, served, kind)
                return None
            return server

        class _Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 - http.server API
                if self.path.split("?", 1)[0] not in ("/metrics", "/"):
                    self.send_response(404)
                    self.end_headers()
                    return
                body = render().encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/plain; version=0.0.4; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args) -> None:  # telemetry, not access logs
                return

        try:
            server = ThreadingHTTPServer(("127.0.0.1", port), _Handler)
        except OSError as e:
            logger.warning("tfrecord.telemetry prometheus endpoint on port %d unavailable "
                           "(%s); continuing without it", port, e)
            return None
        server.daemon_threads = True
        server._tfr_kind = kind
        threading.Thread(target=server.serve_forever, daemon=True, name="tfr-prometheus").start()
        _EXPORTERS[port] = server
        host, bound = server.server_address[:2]
        logger.info("tfrecord.telemetry prometheus endpoint on http://%s:%d/metrics", host, bound)
        return server


def exporter_address(port: int) -> Optional[Tuple[str, int]]:
    """(host, bound port) of the exporter started for the REQUESTED
    ``port`` (how a caller learns the port ``telemetry_port=0`` bound), or
    None when none runs."""
    with _EXPORTERS_LOCK:
        server = _EXPORTERS.get(port)
    return server.server_address[:2] if server is not None else None


def shutdown_exporter(port: int) -> None:
    """Stop the exporter started for the REQUESTED ``port`` (0 for an
    ephemeral one)."""
    with _EXPORTERS_LOCK:
        server = _EXPORTERS.pop(port, None)
    if server is not None:
        server.shutdown()
        server.server_close()
