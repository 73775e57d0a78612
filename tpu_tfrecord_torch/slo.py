"""Error-budget SLO engine: declarative objectives + multi-window
multi-burn-rate alerts over the fleet telemetry spool.

Copy of ``tpu_tfrecord/slo.py``: the same objectives, windows, burn math
and evaluation JSON, read from either package's spool (``fleet.py``).

``tfrecord_doctor serve`` judges the serving tier from a point-in-time
p99 against ``--slo-ms`` — good for "is it slow NOW", useless for "are we
burning this month's error budget fast enough to page someone". This
module adds the standard SRE formulation on top of the counters and
histograms the fleet already spools:

- An **Objective** is a target fraction of good requests:
  *availability* = 1 − (sheds + deadline misses) / attempts, or
  *latency* = fraction of requests completing under a target, computed
  bucket-exactly from the stage histogram (a request is "good" only when
  its whole bucket's upper bound sits at or under the target — the
  estimate can never flatter the tail).
- The **burn rate** over a window is ``error_rate / (1 − target)``:
  1.0 means the budget drains exactly at the sustainable pace, 14.4
  means a 30-day budget is gone in ~2 days.
- A **BurnWindow** alert fires only when BOTH its long and its short
  window burn at or above the threshold (the classic multi-window
  multi-burn-rate rule: the long window proves it is sustained, the
  short window proves it is still happening — no paging on a stale
  spike). The defaults are the fast-page (1 h / 5 m at 14.4x) and
  slow-ticket (6 h / 30 m at 6x) pair; ``scaled()`` shrinks them so
  tests run in milliseconds of fake-clock time.

The engine consumes CUMULATIVE totals (exactly what the spool lines and
``Metrics.raw_totals`` carry) into a bounded ring of samples; windowed
deltas come from differencing the newest sample against the newest
sample at or before the window start. Counters are cumulative from
process start, so a window older than the whole ring honestly anchors
at zero. The clock is injectable throughout — burn-rate pins need no
real waiting.
"""

from __future__ import annotations

import os
import time
from collections import deque
from dataclasses import dataclass, field, replace
from typing import Any, Callable, Deque, Dict, List, Optional, Sequence, Tuple

from tpu_tfrecord_torch import fleet as _fleet
from tpu_tfrecord_torch.metrics import Histogram

__all__ = [
    "Objective",
    "BurnWindow",
    "DEFAULT_WINDOWS",
    "DEFAULT_OBJECTIVES",
    "SloEngine",
    "burn_rate",
    "fleet_samples",
    "engine_from_spool",
]


@dataclass(frozen=True)
class Objective:
    """One declarative objective.

    ``kind`` is ``"availability"`` (good = completed without shed or
    deadline miss) or ``"latency"`` (good = completed under
    ``latency_ms``); ``target`` is the good fraction promised (0.999 =
    "three nines"). ``stage`` names the latency histogram a latency
    objective reads."""

    kind: str
    target: float
    latency_ms: Optional[float] = None
    stage: str = "serve.latency"

    def __post_init__(self) -> None:
        if self.kind not in ("availability", "latency"):
            raise ValueError(f"unknown objective kind {self.kind!r}")
        if not 0.0 < self.target < 1.0:
            raise ValueError(f"target must be in (0, 1), got {self.target!r}")
        if self.kind == "latency" and (
            self.latency_ms is None or self.latency_ms <= 0
        ):
            raise ValueError("latency objective needs latency_ms > 0")

    @property
    def spec(self) -> str:
        if self.kind == "latency":
            return f"latency:{self.target:g}:{self.latency_ms:g}"
        return f"availability:{self.target:g}"

    @classmethod
    def parse(cls, spec: str) -> "Objective":
        """``availability:0.999`` or ``latency:0.95:250`` (ms)."""
        parts = spec.split(":")
        try:
            if parts[0] == "availability" and len(parts) == 2:
                return cls(kind="availability", target=float(parts[1]))
            if parts[0] == "latency" and len(parts) == 3:
                return cls(
                    kind="latency",
                    target=float(parts[1]),
                    latency_ms=float(parts[2]),
                )
        except ValueError as e:
            raise ValueError(f"bad objective {spec!r}: {e}") from e
        raise ValueError(
            f"bad objective {spec!r} (want availability:TARGET or "
            f"latency:TARGET:MS)"
        )

    def bad_total(
        self, counters: Dict[str, int], hists: Dict[str, Any]
    ) -> Tuple[int, int]:
        """(bad, total) cumulative pair from one snapshot's totals."""
        if self.kind == "availability":
            ok = int(counters.get("serve.requests", 0))
            sheds = int(counters.get("serve.rejected", 0))
            misses = int(counters.get("serve.deadline_expired", 0))
            return sheds + misses, ok + sheds + misses
        state = hists.get(self.stage)
        if state is None:
            return 0, 0
        hist = state if isinstance(state, Histogram) else (
            Histogram.from_states([state])
        )
        limit_s = float(self.latency_ms) / 1e3
        good = sum(
            c
            for idx, c in enumerate(hist.counts)
            if c and Histogram.bucket_le(idx) <= limit_s
        )
        return hist.count - good, hist.count


@dataclass(frozen=True)
class BurnWindow:
    """A (long, short) burn-rate alert pair: fires when both windows
    burn at or above ``threshold``."""

    name: str
    long_s: float
    short_s: float
    threshold: float

    def scaled(self, factor: float) -> "BurnWindow":
        """The same alert shape at ``factor`` x the window lengths —
        tests scale hours down to fake-clock seconds without changing
        the thresholds under pin."""
        return replace(
            self, long_s=self.long_s * factor, short_s=self.short_s * factor
        )


#: The standard SRE fast-page / slow-ticket pair.
DEFAULT_WINDOWS: Tuple[BurnWindow, ...] = (
    BurnWindow("fast", long_s=3600.0, short_s=300.0, threshold=14.4),
    BurnWindow("slow", long_s=21600.0, short_s=1800.0, threshold=6.0),
)

#: What ``doctor slo`` evaluates when no ``--objective`` is given: three
#: nines of availability, 95% of requests under 250 ms.
DEFAULT_OBJECTIVES: Tuple[Objective, ...] = (
    Objective(kind="availability", target=0.999),
    Objective(kind="latency", target=0.95, latency_ms=250.0),
)


def burn_rate(bad: float, total: float, target: float) -> float:
    """``error_rate / (1 − target)`` — 0.0 with no traffic (an idle
    window burns nothing)."""
    if total <= 0:
        return 0.0
    return (bad / total) / (1.0 - target)


@dataclass
class _Sample:
    ts: float
    #: Per-objective cumulative (bad, total), indexed like the engine's
    #: objective tuple.
    pairs: List[Tuple[int, int]] = field(default_factory=list)


class SloEngine:
    """Bounded ring of cumulative samples + burn-rate evaluation.

    Feed it cumulative totals (``observe``) at whatever cadence the
    spool or pulse runs; ``evaluate`` answers with per-objective budget
    remaining, per-window burn rates, and a verdict in
    {"healthy", "slow_burn", "fast_burn", "no_data"} (worst window that
    alerts wins; fast beats slow regardless of declaration order)."""

    def __init__(
        self,
        objectives: Sequence[Objective] = DEFAULT_OBJECTIVES,
        windows: Sequence[BurnWindow] = DEFAULT_WINDOWS,
        ring: int = 4096,
        clock: Callable[[], float] = time.time,
    ):
        if not objectives:
            raise ValueError("need at least one objective")
        if not windows:
            raise ValueError("need at least one burn window")
        self.objectives = tuple(objectives)
        self.windows = tuple(windows)
        self._clock = clock
        self._ring: Deque[_Sample] = deque(maxlen=ring)

    def observe(
        self,
        counters: Dict[str, int],
        hists: Optional[Dict[str, Any]] = None,
        ts: Optional[float] = None,
    ) -> None:
        """Fold one CUMULATIVE snapshot (counter totals + histogram
        states, e.g. a spool line or ``Metrics.raw_totals`` +
        ``hist_states``) into the ring at time ``ts`` (engine clock when
        omitted). Out-of-order samples are dropped — the ring is a time
        series, and cumulative totals older than the newest sample carry
        no new information."""
        ts = self._clock() if ts is None else float(ts)
        if self._ring and ts < self._ring[-1].ts:
            return
        hists = hists or {}
        self._ring.append(
            _Sample(
                ts=ts,
                pairs=[o.bad_total(counters, hists) for o in self.objectives],
            )
        )

    def _anchor(self, start_ts: float, idx: int) -> Tuple[int, int]:
        """Cumulative (bad, total) at the newest sample at or before
        ``start_ts`` — (0, 0) when the window opens before the whole
        ring (counters are cumulative from zero, so the honest anchor
        for a window older than the process is the origin)."""
        best: Tuple[int, int] = (0, 0)
        for sample in self._ring:
            if sample.ts > start_ts:
                break
            best = sample.pairs[idx]
        return best

    def evaluate(self, now: Optional[float] = None) -> Dict[str, Any]:
        now = self._clock() if now is None else float(now)
        if not self._ring:
            return {"now": now, "verdict": "no_data", "objectives": []}
        newest = self._ring[-1]
        rank = {"healthy": 0, "slow_burn": 1, "fast_burn": 2}
        out: List[Dict[str, Any]] = []
        overall = "healthy"
        for idx, obj in enumerate(self.objectives):
            bad_now, total_now = newest.pairs[idx]
            longest = max(w.long_s for w in self.windows)
            anchor = self._anchor(now - longest, idx)
            budget_bad = bad_now - anchor[0]
            budget_total = total_now - anchor[1]
            allowed = (1.0 - obj.target) * budget_total
            if allowed > 0:
                remaining = min(1.0, 1.0 - budget_bad / allowed)
            else:
                remaining = 1.0 if budget_bad == 0 else 0.0
            verdict = "healthy"
            wreports: List[Dict[str, Any]] = []
            for w in self.windows:
                burns = []
                for span_s in (w.long_s, w.short_s):
                    a = self._anchor(now - span_s, idx)
                    burns.append(
                        burn_rate(
                            bad_now - a[0], total_now - a[1], obj.target
                        )
                    )
                alerting = burns[0] >= w.threshold and burns[1] >= w.threshold
                wreports.append(
                    {
                        "name": w.name,
                        "long_s": w.long_s,
                        "short_s": w.short_s,
                        "threshold": w.threshold,
                        "long_burn": burns[0],
                        "short_burn": burns[1],
                        "alerting": alerting,
                    }
                )
                if alerting:
                    candidate = (
                        "fast_burn" if w.name == "fast" else "slow_burn"
                    )
                    if rank[candidate] > rank[verdict]:
                        verdict = candidate
            out.append(
                {
                    "objective": obj.spec,
                    "kind": obj.kind,
                    "target": obj.target,
                    "latency_ms": obj.latency_ms,
                    "bad": budget_bad,
                    "total": budget_total,
                    "budget_remaining": remaining,
                    "windows": wreports,
                    "verdict": verdict,
                }
            )
            if rank[verdict] > rank[overall]:
                overall = verdict
        return {"now": now, "verdict": overall, "objectives": out}

    def publish(self, metrics: Any, now: Optional[float] = None) -> Dict[str, Any]:
        """Evaluate and land the result on a ``Metrics`` registry as
        ``slo.<kind>.budget_remaining`` / ``slo.<kind>.<window>_burn``
        gauges (dynamic ``slo.`` gauge prefix in the vocabulary), so the
        spool ships the SLO state alongside the raw counters it was
        computed from. Returns the evaluation."""
        report = self.evaluate(now)
        for entry in report["objectives"]:
            prefix = f"slo.{entry['kind']}"
            metrics.gauge(
                f"{prefix}.budget_remaining", entry["budget_remaining"]
            )
            for w in entry["windows"]:
                metrics.gauge(f"{prefix}.{w['name']}_burn", w["long_burn"])
        return report


# ---------------------------------------------------------------------------
# Fleet spool -> time series
# ---------------------------------------------------------------------------


def fleet_samples(
    spool_dir: str, trace_id: Optional[str] = None
) -> List[Tuple[float, Dict[str, int], Dict[str, Histogram]]]:
    """The cluster-wide cumulative time series from a spool directory:
    at each timestamp any process heartbeat, (ts, summed counters,
    bucket-exactly merged histograms) over every process's NEWEST line
    at or before ts — the same merge discipline as
    ``TelemetryAggregator.aggregate`` applied per point in time.
    ``trace_id`` scopes a reused spool dir to one run. Raises OSError
    when the dir itself is unreadable (an unreadable fleet must not look
    idle)."""
    histories: List[List[_fleet.ProcessSnapshot]] = []
    for name in sorted(os.listdir(spool_dir)):
        if not name.endswith(_fleet.SPOOL_SUFFIX):
            continue
        history = [
            snap
            for snap in _fleet.read_spool_history(
                os.path.join(spool_dir, name)
            )
            if trace_id is None or snap.trace_id == trace_id
        ]
        if history:
            histories.append(history)
    timestamps = sorted(
        {snap.heartbeat for history in histories for snap in history}
    )
    series: List[Tuple[float, Dict[str, int], Dict[str, Histogram]]] = []
    for ts in timestamps:
        counters: Dict[str, int] = {}
        hists: Dict[str, Histogram] = {}
        for history in histories:
            newest: Optional[_fleet.ProcessSnapshot] = None
            for snap in history:
                if snap.heartbeat <= ts:
                    newest = snap
                else:
                    break
            if newest is None:
                continue
            for cname, v in newest.counters.items():
                counters[cname] = counters.get(cname, 0) + v
            for hname, state in newest.hists.items():
                # same per-hist resilience as the aggregator: one bad
                # state loses that stage for that process at that point,
                # never the series
                try:
                    hists.setdefault(hname, Histogram()).merge_state(state)
                except (ValueError, TypeError, KeyError, IndexError):
                    continue
        series.append((ts, counters, hists))
    return series


def engine_from_spool(
    spool_dir: str,
    objectives: Sequence[Objective] = DEFAULT_OBJECTIVES,
    windows: Sequence[BurnWindow] = DEFAULT_WINDOWS,
    trace_id: Optional[str] = None,
    clock: Callable[[], float] = time.time,
) -> Optional[SloEngine]:
    """An engine pre-fed with a spool directory's whole fleet series —
    what ``tfrecord_doctor slo`` evaluates. None when the directory
    holds no (matching) snapshots, so the caller can distinguish "no
    fleet" (exit 2) from "fleet is idle" (healthy, no traffic)."""
    series = fleet_samples(spool_dir, trace_id=trace_id)
    if not series:
        return None
    engine = SloEngine(
        objectives=objectives,
        windows=windows,
        ring=max(len(series), 16),
        clock=clock,
    )
    for ts, counters, hists in series:
        engine.observe(counters, hists, ts=ts)
    return engine
