"""Throughput counters, latency histograms and structured logging.

Cut of ``tpu_tfrecord/metrics.py`` to what the reader, the writer, the
checkpoint layer, the trainer harness and the serving tier read: the
``Metrics`` registry (per-stage totals through ``add`` / ``count``, gauges,
log-bucketed latency histograms fed by ``add`` or ``observe``, ``counter``
/ ``gauge_value`` / ``stage`` / ``quantiles``, and the one-lock copies the
telemetry pulse reads: ``raw_totals``, ``gauges`` and ``hist_states``),
``timed``, ``log_salvage_event`` and the package ``logger``.
``Histogram`` is a copy of ``tpu_tfrecord/telemetry.py::Histogram``,
exemplars included: ``add`` and ``observe`` take ``exemplar=(trace_id,
span_id)`` and tag the observation's bucket with it, as the JAX registry
does (``telemetry`` re-exports the name); ``state`` / ``merge_state`` /
``from_states`` carry it across processes bucket-exactly. Counters are updated at slab or
shard granularity, never per record, and every access takes the
registry's lock. Every name is registered in ``vocabulary.py``.

Stages the port records: ``read`` and ``read.io`` / ``read.open`` (the
reader), ``write``, ``write.encode``, ``write.compress``, ``write.io`` and
``write.commit`` (the writer), and the event counters
``read.corrupt_records``, ``read.resyncs``, ``read.skipped_shards``,
``write.commit_retries``, ``write.backpressure_waits`` and
``<stage>.errors``; the gauge ``write.inflight_slabs``. The dataset's
iterator adds ``batch.wait`` and the gauges ``prefetch.queue_depth`` and
``prefetch.occupancy``, its decode pool ``decode``, ``read.retries``,
the stall counters ``read.stalls``, ``read.deadline_misses``,
``read.hedges``, ``read.hedge_wins``, ``read.watchdog_restarts``,
``read.backpressure_waits`` and the gauge ``read.inflight_workers``; the
autotune controller ``autotune.adjustments`` and the gauges
``autotune.<knob>``, the pulse ``pulse.observer_errors``; the checkpoint
layer ``ckpt.snapshot``, ``ckpt.commit``, ``ckpt.commit_wait``,
``ckpt.bytes_written``,
``ckpt.generations_swept`` and the gauge ``ckpt.inflight``; the harness
``train.<phase>``, ``train.step``, ``train.steps`` and the gauges
``train.share.<phase>``; the serving tier the counters ``serve.requests``,
``serve.ticks``, ``serve.rejected``, ``serve.deadline_expired``,
``serve.disconnects`` and ``serve.errors``, the histograms
``serve.latency``, ``serve.queue_wait`` and ``serve.service`` and the
gauges ``serve.queue_depth`` and ``serve.in_flight``; the epoch cache the
counters ``cache.hits``, ``cache.misses``, ``cache.bytes_written``,
``cache.evictions``, ``cache.corrupt_fallbacks`` and
``cache.populate_errors`` and the stages ``cache.open``, ``cache.serve``
and ``cache.commit``; the fleet spool ``fleet.spool_writes`` and
``fleet.spool_errors``; the SLO engine the gauges
``slo.<kind>.budget_remaining`` and ``slo.<kind>.<window>_burn``.
"""

from __future__ import annotations

import json
import logging
import math
import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, Iterable, Optional, Tuple

logger = logging.getLogger("tpu_tfrecord_torch")


class Histogram:
    """Log-bucketed latency histogram with quantile estimation, the JAX
    ``telemetry.Histogram``.

    Buckets grow by ``2**0.25`` (about 19 % a bucket) from a 100 ns floor
    over 144 fixed buckets (up to about 1.9 h). Quantiles take the
    log-midpoint of the selected bucket, clamped to the observed [min,
    max]. ``exemplars`` maps a bucket to the last (trace_id, span_id,
    value) observed into it with an exemplar: the pointer from a tail
    bucket back to the request that filled it. Not locked: ``Metrics``
    serializes access under its own lock.
    """

    _MIN = 1e-7
    _LOG2_GROWTH = 0.25
    _NBUCKETS = 144

    __slots__ = ("counts", "count", "total", "min", "max", "exemplars")

    def __init__(self) -> None:
        self.counts = [0] * self._NBUCKETS
        self.count = 0
        self.total = 0.0
        self.min = math.inf
        self.max = 0.0
        self.exemplars: Dict[int, Tuple[str, str, float]] = {}

    def bucket_index(self, value: float) -> int:
        if value <= self._MIN:
            return 0
        return min(
            self._NBUCKETS - 1,
            1 + int(math.log2(value / self._MIN) / self._LOG2_GROWTH),
        )

    @classmethod
    def bucket_le(cls, idx: int) -> float:
        """Inclusive upper bound (seconds) of bucket ``idx``: the ``le``
        label of an exemplar on the Prometheus page."""
        if idx <= 0:
            return cls._MIN
        return cls._MIN * 2 ** (idx * cls._LOG2_GROWTH)

    def observe(self, value: float, exemplar: Optional[Tuple[str, str]] = None) -> None:
        idx = self.bucket_index(value)
        self.counts[idx] += 1
        self.count += 1
        self.total += value
        self.min = min(self.min, value)
        self.max = max(self.max, value)
        if exemplar is not None:
            self.exemplars[idx] = (str(exemplar[0]), str(exemplar[1]), float(value))

    def exemplar_at(self, q: float) -> Optional[Dict[str, Any]]:
        """The exemplar of the highest populated bucket at or below the one
        ``quantile(q)`` lands in, as ``{bucket, trace_id, span_id, value}``;
        None when no exemplar lies at or below it."""
        if self.count == 0 or not self.exemplars:
            return None
        rank = q * self.count
        cum = 0
        target = self._NBUCKETS - 1
        for idx, c in enumerate(self.counts):
            cum += c
            if cum >= rank and c:
                target = idx
                break
        below = [idx for idx in self.exemplars if idx <= target]
        if not below:
            return None
        best = max(below)
        trace_id, span_id, value = self.exemplars[best]
        return {"bucket": best, "trace_id": trace_id, "span_id": span_id, "value": value}

    def quantile(self, q: float) -> Optional[float]:
        """Estimated value at quantile ``q`` in [0, 1] (None when empty)."""
        if self.count == 0:
            return None
        rank = q * self.count
        cum = 0
        for idx, c in enumerate(self.counts):
            cum += c
            if cum >= rank and c:
                est = self._MIN if idx == 0 else self._MIN * 2 ** ((idx - 0.5) * self._LOG2_GROWTH)
                return min(max(est, self.min), self.max)
        return self.max

    def state(self) -> Dict[str, Any]:
        """JSON-serializable snapshot, the JAX layout: the populated
        buckets' counts, the count, total, min and max, the bucket layout
        and, when any was observed, ``exemplars`` as {bucket: [trace_id,
        span_id, value]}."""
        state: Dict[str, Any] = {
            "buckets": {str(i): c for i, c in enumerate(self.counts) if c},
            "count": self.count,
            "total": self.total,
            "min": self.min if self.count else None,
            "max": self.max,
            "layout": [self._MIN, self._LOG2_GROWTH, self._NBUCKETS],
        }
        if self.exemplars:
            state["exemplars"] = {str(i): [t, s, v]
                                  for i, (t, s, v) in sorted(self.exemplars.items())}
        return state

    def merge_state(self, state: Dict[str, Any]) -> None:
        """Fold one ``state()`` snapshot in, bucket for bucket (the layout
        is fixed, so the merge is exact). A foreign layout or an index out
        of range raises ValueError, a non-mapping TypeError: a bad state is
        refused, never blended. Exemplars merge last-wins per bucket."""
        if not isinstance(state, dict):
            raise TypeError(f"histogram state must be a mapping, got {type(state).__name__}")
        layout = state.get("layout")
        if layout is not None and list(layout) != [self._MIN, self._LOG2_GROWTH, self._NBUCKETS]:
            raise ValueError(
                f"histogram bucket layout mismatch: {layout} vs "
                f"{[self._MIN, self._LOG2_GROWTH, self._NBUCKETS]}"
            )
        buckets = state.get("buckets") or {}
        if not isinstance(buckets, dict):
            raise TypeError(f"histogram buckets must be a mapping, got {type(buckets).__name__}")
        for idx, c in buckets.items():
            i = int(idx)
            if not 0 <= i < self._NBUCKETS:
                # a negative index would silently wrap into the tail bucket
                raise ValueError(f"histogram bucket index out of range: {i}")
            self.counts[i] += int(c)
        self.count += int(state.get("count", 0))
        self.total += float(state.get("total", 0.0))
        smin = state.get("min")
        if smin is not None and smin < self.min:
            self.min = smin
        smax = state.get("max")
        if smax is not None and smax > self.max:
            self.max = smax
        exemplars = state.get("exemplars") or {}
        if not isinstance(exemplars, dict):
            raise TypeError(f"histogram exemplars must be a mapping, got {type(exemplars).__name__}")
        for idx, ex in exemplars.items():
            i = int(idx)
            if not 0 <= i < self._NBUCKETS:
                raise ValueError(f"exemplar bucket index out of range: {i}")
            trace_id, span_id, value = ex
            self.exemplars[i] = (str(trace_id), str(span_id), float(value))

    @classmethod
    def from_states(cls, states: Iterable[Dict[str, Any]]) -> "Histogram":
        """One histogram holding every state of ``states``, merged."""
        hist = cls()
        for st in states:
            hist.merge_state(st)
        return hist

    def quantiles(self) -> Dict[str, float]:
        """p50/p90/p99 (seconds), count and mean; empty when no data."""
        if self.count == 0:
            return {}
        return {
            "p50_s": self.quantile(0.50),
            "p90_s": self.quantile(0.90),
            "p99_s": self.quantile(0.99),
            "count": self.count,
            "mean_s": self.total / self.count,
        }


@dataclass
class StageStats:
    records: int = 0
    bytes: int = 0
    batches: int = 0
    seconds: float = 0.0

    def throughput(self) -> Dict[str, float]:
        dt = self.seconds or 1e-9
        return {
            "records_per_sec": self.records / dt,
            "bytes_per_sec": self.bytes / dt,
            "records": self.records,
            "bytes": self.bytes,
            "batches": self.batches,
            "seconds": self.seconds,
        }


class Metrics:
    """Registry of per-stage totals, gauges and latency histograms."""

    def __init__(self):
        self._lock = threading.Lock()
        self._stages: Dict[str, StageStats] = {}
        self._gauges: Dict[str, float] = {}
        self._hists: Dict[str, Histogram] = {}

    def add(
        self,
        stage: str,
        records: int = 0,
        nbytes: int = 0,
        seconds: float = 0.0,
        latency: Optional[float] = None,
        exemplar: Optional[Tuple[str, str]] = None,
    ) -> None:
        """Accumulate into a stage's totals; ``latency`` also folds one
        observation into the stage's histogram under the same lock, tagged
        with ``exemplar`` = (trace_id, span_id) when given."""
        with self._lock:
            st = self._stages.setdefault(stage, StageStats())
            st.records += records
            st.bytes += nbytes
            st.batches += 1
            st.seconds += seconds
            if latency is not None:
                hist = self._hists.get(stage)
                if hist is None:
                    hist = self._hists[stage] = Histogram()
                hist.observe(latency, exemplar=exemplar)

    def count(self, stage: str, n: int = 1) -> None:
        """Increment an event counter (the count rides ``records``)."""
        self.add(stage, records=n)

    def counter(self, stage: str) -> int:
        """Current value of a ``count()`` counter (0 if never hit)."""
        with self._lock:
            st = self._stages.get(stage)
            return st.records if st is not None else 0

    def gauge(self, name: str, value: float) -> None:
        """Set an instantaneous gauge; last write wins."""
        with self._lock:
            self._gauges[name] = float(value)

    def gauge_value(self, name: str, default: Optional[float] = None) -> Optional[float]:
        """A gauge's last value (``default`` if never set)."""
        with self._lock:
            return self._gauges.get(name, default)

    def gauges(self) -> Dict[str, float]:
        """A one-lock copy of every gauge."""
        with self._lock:
            return dict(self._gauges)

    def observe(self, stage: str, seconds: float,
                exemplar: Optional[Tuple[str, str]] = None) -> None:
        """Fold one latency observation into ``stage``'s histogram without
        touching its totals (for work timed inline rather than by
        ``timed``), its bucket tagged with ``exemplar`` = (trace_id,
        span_id) when given."""
        with self._lock:
            hist = self._hists.get(stage)
            if hist is None:
                hist = self._hists[stage] = Histogram()
            hist.observe(seconds, exemplar=exemplar)

    def quantiles(self, prefix: Optional[str] = None) -> Dict[str, Dict[str, float]]:
        """Per-stage latency quantiles (``Histogram.quantiles``); ``prefix``
        filters like ``snapshot``."""
        with self._lock:
            return {name: hist.quantiles() for name, hist in self._hists.items()
                    if prefix is None or name == prefix or name.startswith(prefix + ".")}

    def hist_states(self) -> Dict[str, dict]:
        """A one-lock copy of every histogram's ``Histogram.state``."""
        with self._lock:
            return {name: hist.state() for name, hist in self._hists.items()}

    def raw_totals(self) -> Dict[str, Tuple[int, int, int, float]]:
        """A one-lock copy of every stage's totals as (records, bytes,
        batches, seconds): the delta source of ``telemetry.Pulse``."""
        with self._lock:
            return {name: (st.records, st.bytes, st.batches, st.seconds)
                    for name, st in self._stages.items()}

    def stage(self, stage: str) -> StageStats:
        """A stage's totals (created empty if never hit)."""
        with self._lock:
            return self._stages.setdefault(stage, StageStats())

    def snapshot(self, prefix: Optional[str] = None) -> Dict[str, Dict[str, float]]:
        """Per-stage throughput map (with p50/p90/p99 where a stage has a
        histogram), gauges as ``{"gauge": value}``; ``prefix`` filters to
        one stage family (``'write'`` -> write, write.encode, ...)."""

        def keep(name: str) -> bool:
            return prefix is None or name == prefix or name.startswith(prefix + ".")

        with self._lock:
            out: Dict[str, Dict[str, float]] = {}
            for name, st in self._stages.items():
                if not keep(name):
                    continue
                entry = st.throughput()
                hist = self._hists.get(name)
                if hist is not None and hist.count:
                    entry.update(p50_s=hist.quantile(0.50), p90_s=hist.quantile(0.90),
                                 p99_s=hist.quantile(0.99), hist_count=hist.count)
                out[name] = entry
            for name, value in self._gauges.items():
                if keep(name):
                    out[name] = {"gauge": value}
            return out

    def reset(self) -> None:
        with self._lock:
            self._stages.clear()
            self._gauges.clear()
            self._hists.clear()
            # the fleet spool's wall-window epoch (fleet.TelemetrySpool
            # stamps it on this registry) describes the totals just cleared
            self.__dict__.pop("_spool_epoch", None)


# Process-global default registry.
METRICS = Metrics()


def log_salvage_event(**fields) -> None:
    """One JSON warning line per salvage or skip event (corrupt frame
    found, resync landed, shard dropped), keyed by path, offset and kind."""
    logger.warning("tfrecord.salvage %s", json.dumps(fields, sort_keys=True, default=str))


class timed:
    """Context manager adding a block's wall time (and the counts it sets)
    to a stage, plus one latency observation. An exception through the
    block still records the time and bumps ``<stage>.errors``."""

    def __init__(self, stage: str, metrics: Optional[Metrics] = None):
        self.stage = stage
        self.metrics = metrics or METRICS
        self.records = 0
        self.bytes = 0

    def __enter__(self) -> "timed":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        dt = time.perf_counter() - self._t0
        self.metrics.add(self.stage, records=self.records, nbytes=self.bytes,
                         seconds=dt, latency=dt)
        if exc_type is not None:
            self.metrics.count(self.stage + ".errors")
