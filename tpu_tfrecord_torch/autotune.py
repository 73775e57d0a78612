"""Closed-loop autotuning: the pulse drives the decode pool's knobs.

Copy of ``tpu_tfrecord/autotune.py``. The right decode parallelism,
prefetch depth, readahead window and stall thresholds depend on the host,
the schema, the store's latency and whatever else shares the cores, none
of which is known when a configuration is written. Three pieces:

- ``PipelineControl``: the live knobs of one iterator's pipeline. It
  resizes the decode pool (``set_workers``; ``io.dataset._parallel_chunks``
  spawns and retires workers mid-epoch without touching the output order),
  the prefetch queue (``set_prefetch``) and the readahead window
  (``set_readahead_bytes``), and reaches the dataset's ``StallGuard``,
  whose thresholds guarded streams read live. Chunk boundaries and the
  emit order are a function of the data and the decode options, never of
  the worker count, so batches stay the same and ``IteratorState``
  checkpoints resume across any resize.
- ``AutotuneController``: bounded hill-climbing at pulse boundaries. Each
  ``telemetry.Pulse`` tick hands it the interval's payload; it grows the
  pool by one worker after ``hysteresis`` producer-bound ticks (and keeps
  the prefetch queue at workers + 2), shrinks it after as many
  consumer-bound ones, retargets readahead to the ``read.io`` bandwidth
  times a horizon, and derives ``hedge_after_ms`` (and, where the user set
  them, the deadlines) from the observed read and open p99. Hysteresis,
  per-knob clamps and a cooldown keep one noisy interval from moving the
  pool. Each move bumps ``autotune.adjustments``, writes the
  ``autotune.<knob>`` gauge and an ``autotune.adjust`` instant, lands in
  ``controller.log``, and an ``autotune`` block joins the pulse line.
- The wiring: ``TFRecordOptions(autotune="on")`` makes the iterator build a
  ``PipelineControl``, a controller and (unless one was configured) a
  pulse at ``autotune_interval_s``; the controller is a pulse observer.

With ``autotune="off"`` (the default) none of this exists.
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from tpu_tfrecord_torch import telemetry

__all__ = [
    "AutotuneController",
    "AutotunePolicy",
    "BoundedClimber",
    "PipelineControl",
    "DEFAULT_INTERVAL_S",
    "default_max_workers",
]

#: Pulse cadence when autotune is on but no pulse_interval_s /
#: autotune_interval_s was configured.
DEFAULT_INTERVAL_S = 1.0


def default_max_workers() -> int:
    """Decode-pool ceiling when the caller sets none: enough headroom to
    matter on IO-stalled pipelines (sleeping reads release the GIL, so
    useful parallelism can exceed the core count) without unbounded thread
    growth."""
    try:
        ncpu = len(os.sched_getaffinity(0))
    except AttributeError:  # non-Linux
        ncpu = os.cpu_count() or 1
    return min(32, max(4, 2 * ncpu))


class BoundedClimber:
    """Verdict-streak hysteresis + wall-clock cooldown: the guard-rail
    bookkeeping of a bounded hill-climber (the pool controller,
    ``AutotuneController``, paces its moves through it, so injected stalls
    cannot whipsaw the pool).

    ``observe(verdict)`` returns the verdict when it is actionable —
    the same verdict for ``hysteresis`` consecutive observations AND the
    cooldown window since the last move has passed — else None. The
    caller reports a move with ``acted()`` (stamps the cooldown, resets
    the streak). Verdicts outside ``actionable`` reset the streak: one
    quiet tick between two producer_bound ticks means the boundness was
    noise, not a regime.
    """

    def __init__(
        self,
        hysteresis: int,
        cooldown_s: float,
        clock: Callable[[], float] = time.monotonic,
        actionable: tuple = ("producer_bound", "consumer_bound"),
    ):
        self.hysteresis = int(hysteresis)
        self.cooldown_s = float(cooldown_s)
        self.clock = clock
        self.actionable = tuple(actionable)
        self._verdict: Optional[str] = None
        self._streak = 0
        self._last_move = -float("inf")

    @property
    def streak(self) -> int:
        return self._streak

    def observe(self, verdict: Optional[str]) -> Optional[str]:
        if verdict not in self.actionable:
            self._verdict = None
            self._streak = 0
            return None
        if verdict == self._verdict:
            self._streak += 1
        else:
            self._verdict = verdict
            self._streak = 1
        if self._streak < self.hysteresis:
            return None
        if self.clock() - self._last_move < self.cooldown_s:
            return None
        return verdict

    def acted(self) -> None:
        self._last_move = self.clock()
        self._streak = 0

    def cooldown_remaining(self) -> float:
        return max(0.0, self.cooldown_s - (self.clock() - self._last_move))


class PipelineControl:
    """Live-adjustable knobs of one iterator's pipeline.

    Thread-safety: ``set_*`` are called from the pulse thread (or tests)
    while workers run; every pool-accounting mutation happens under one
    lock. Worker threads participate through three hooks wired by
    ``_parallel_chunks`` (io/dataset.py): ``bind_spawn`` registers the
    thread factory (and brings the pool up to target), ``should_exit``
    lets a worker volunteer to retire when the pool is over target (the
    exit is reserved under the lock, so exactly the surplus retires), and
    ``note_exit`` balances the books on any exit path.
    """

    def __init__(
        self,
        workers: int,
        max_workers: Optional[int] = None,
        queue=None,
        dataset=None,
        guard=None,
    ):
        self._lock = threading.Lock()
        # the ceiling never clamps a user-CONFIGURED starting pool: someone
        # who asked for num_workers=48 gets 48 (autotune may shrink it
        # later on evidence, which is the contract — a silent startup
        # downgrade is not)
        self.max_workers = max(int(workers), max_workers or default_max_workers())
        self.target_workers = max(1, int(workers))
        self._alive = 0
        self._exit_permits = 0
        self._spawn: Optional[Callable[[], None]] = None
        self.queue = queue
        self._dataset = dataset
        self.guard = guard
        self._prefetch = queue.maxsize if queue is not None else None
        self._readahead = (
            getattr(dataset, "readahead_bytes", None) if dataset is not None else None
        )

    # -- decode worker pool --------------------------------------------------

    @property
    def workers(self) -> int:
        return self.target_workers

    def bind_spawn(self, spawn: Callable[[], None]) -> None:
        """Register the worker thread factory and bring the pool up to the
        current target (one call per _parallel_chunks run)."""
        with self._lock:
            self._spawn = spawn
            deficit = self.target_workers - (self._alive - self._exit_permits)
            if deficit > 0:
                self._alive += deficit
        for _ in range(max(0, deficit)):
            spawn()

    def set_workers(self, n: int) -> int:
        """Retarget the decode pool to ``n`` workers (clamped to
        [1, max_workers]); growth spawns immediately, shrink retires
        workers as they finish their current shard. Returns the clamped
        target."""
        n = max(1, min(int(n), self.max_workers))
        to_spawn = 0
        with self._lock:
            self.target_workers = n
            if self._spawn is not None:
                deficit = n - (self._alive - self._exit_permits)
                if deficit > 0:
                    self._alive += deficit
                    to_spawn = deficit
        for _ in range(to_spawn):
            self._spawn()
        return n

    def should_exit(self) -> bool:
        """Worker hook: True reserves one retirement when the pool is over
        target (the caller must exit WITHOUT claiming new work and then
        call ``note_exit(permitted=True)``)."""
        with self._lock:
            if self._alive - self._exit_permits > self.target_workers:
                self._exit_permits += 1
                return True
        return False

    def note_exit(self, permitted: bool = False) -> None:
        """Worker hook: balance the pool books on ANY worker exit."""
        with self._lock:
            self._alive -= 1
            if permitted and self._exit_permits:
                self._exit_permits -= 1

    # -- prefetch queue ------------------------------------------------------

    @property
    def prefetch(self) -> Optional[int]:
        q = self.queue
        return q.maxsize if q is not None else self._prefetch

    def set_prefetch(self, n: int) -> int:
        n = max(1, int(n))
        q = self.queue
        if q is not None:
            q.resize(n)
        self._prefetch = n
        return n

    # -- readahead window ----------------------------------------------------

    @property
    def readahead_bytes(self) -> Optional[int]:
        ds = self._dataset
        if ds is not None:
            return ds.readahead_bytes
        return self._readahead

    def set_readahead_bytes(self, n: int) -> int:
        """Retarget the sliding WILLNEED window; picked up at the next
        shard open (the per-shard hinter captures the window once)."""
        n = max(0, int(n))
        ds = self._dataset
        if ds is not None:
            ds.readahead_bytes = n
        self._readahead = n
        return n


@dataclass
class AutotunePolicy:
    """Bounds and pacing for the hill-climber. Every knob move is clamped
    to its [min, max]; the pool only moves after ``hysteresis`` consecutive
    same-verdict ticks and at most once per ``cooldown_s`` wall-clock
    window; derived thresholds only move on a relative change beyond
    ``threshold_rel_band`` (so a quiet store doesn't twitch them every
    tick)."""

    hysteresis: int = 2
    cooldown_s: float = 2.0
    min_workers: int = 1
    max_workers: int = field(default_factory=default_max_workers)
    min_prefetch: int = 2
    max_prefetch: int = 32
    # readahead retarget: keep ~horizon seconds of observed read.io
    # bandwidth in flight, moved only on a >50% regime change
    min_readahead_mb: int = 8
    max_readahead_mb: int = 256
    readahead_horizon_s: float = 0.5
    readahead_rel_band: float = 0.5
    # stall thresholds derived from observed latency quantiles. Deadline
    # multiples are deliberately wide (a false deadline miss RAISES and can
    # kill an epoch under on_stall="raise"); a false hedge is benign — it
    # just opens a backup read whose loser is discarded — so it sits much
    # closer to the observed p99.
    hedge_p99_mult: float = 4.0
    deadline_p99_mult: float = 20.0
    min_hedge_ms: float = 100.0
    min_deadline_ms: float = 2_000.0
    max_deadline_ms: float = 120_000.0
    threshold_rel_band: float = 0.25
    # quantiles are cumulative: require this many observations before
    # trusting a p99 enough to derive a deadline from it
    min_latency_samples: int = 20


class AutotuneController:
    """Pulse-boundary hill-climber over one pipeline's knobs.

    Run it as a pulse observer (``pulse.add_observer(c.on_pulse)``): each
    tick it reads the pulse payload, applies bounded adjustments through
    its ``PipelineControl``, and returns an ``{"autotune": {...}}`` block
    merged into the emitted pulse line — every decision lands in the same
    trace the flight recorder already writes.
    """

    def __init__(
        self,
        control: PipelineControl,
        interval_s: float = DEFAULT_INTERVAL_S,
        policy: Optional[AutotunePolicy] = None,
        metrics=None,
        clock: Callable[[], float] = time.monotonic,
    ):
        if metrics is None:
            from tpu_tfrecord_torch.metrics import METRICS as metrics  # noqa: N813
        self.control = control
        # default cooldown scales with the tick cadence: two quiet ticks
        # between pool moves, whatever the interval
        self.policy = policy or AutotunePolicy(
            cooldown_s=max(0.25, 2.0 * interval_s)
        )
        self.metrics = metrics
        self.clock = clock
        self.interval_s = interval_s
        #: full decision log: one dict per adjustment (knob, from, to,
        #: reason, tick) — the convergence trajectory
        self.log: List[Dict[str, Any]] = []
        self._tick = 0
        # guard-rail bookkeeping (hysteresis streaks + cooldown) lives in
        # BoundedClimber; the policy's knobs are re-read every tick so a
        # policy mutated after construction still governs
        self._climber = BoundedClimber(
            self.policy.hysteresis, self.policy.cooldown_s, clock=clock
        )
        # clamp the control's pool ceiling to the policy's — but never
        # below the configured starting pool (see PipelineControl)
        self.control.max_workers = max(
            self.control.target_workers,
            min(self.control.max_workers, self.policy.max_workers),
        )

    # -- knob application ----------------------------------------------------

    def _adjust(self, knob: str, old, new, reason: str, apply) -> bool:
        """Apply one knob move; record it everywhere a reader might look."""
        if new == old:
            return False
        apply(new)
        decision = {
            "tick": self._tick,
            "knob": knob,
            "from": old,
            "to": new,
            "reason": reason,
        }
        self.log.append(decision)
        self.metrics.count("autotune.adjustments")
        self.metrics.gauge(f"autotune.{knob}", float(new))
        telemetry.instant(
            "autotune.adjust", knob=knob, old=old, new=new, reason=reason
        )
        return True

    # -- the tick ------------------------------------------------------------

    def on_pulse(self, payload: Dict[str, Any]) -> Dict[str, Any]:
        """One control step. ``payload`` is a ``telemetry.Pulse.tick``
        dict (stages / counters / gauges / quantiles / verdict); returns
        the ``autotune`` block for the pulse line."""
        self._tick += 1
        n_before = len(self.log)
        self._step_pool(payload)
        self._step_readahead(payload)
        self._step_thresholds(payload)
        adjusted = self.log[n_before:]
        return {"autotune": self.snapshot(adjusted)}

    def snapshot(self, adjusted: Optional[List[Dict]] = None) -> Dict[str, Any]:
        """Current knob values (+ this tick's moves when given) — the
        shape the pulse line carries."""
        c = self.control
        guard = c.guard
        out: Dict[str, Any] = {
            "workers": c.workers,
            "prefetch": c.prefetch,
            "readahead_mb": (
                round(c.readahead_bytes / (1 << 20), 1)
                if c.readahead_bytes is not None
                else None
            ),
            "adjustments": len(self.log),
        }
        if guard is not None:
            out["thresholds_ms"] = {
                "read_deadline_ms": _to_ms(guard.read_deadline),
                "open_deadline_ms": _to_ms(guard.open_deadline),
                "hedge_after_ms": _to_ms(guard.hedge_after),
            }
        if adjusted is not None:
            out["adjusted"] = adjusted
        return out

    # -- pool sizing from the bound-ness verdict -----------------------------

    def _step_pool(self, payload: Dict[str, Any]) -> None:
        pol = self.policy
        self._climber.hysteresis = pol.hysteresis
        self._climber.cooldown_s = pol.cooldown_s
        verdict = self._climber.observe(payload.get("verdict"))
        if verdict is None:
            return
        c = self.control
        workers = c.workers
        if verdict == "producer_bound":
            target = min(workers + 1, pol.max_workers, c.max_workers)
            reason = "producer_bound"
        else:
            target = max(workers - 1, pol.min_workers)
            reason = "consumer_bound"
        moved = self._adjust("workers", workers, target, reason, c.set_workers)
        # keep the queue deep enough to absorb the pool (and no deeper
        # than it needs to be when shrinking): bursty producers otherwise
        # immediately re-block on a too-shallow queue
        if c.prefetch is not None:
            want = max(pol.min_prefetch, min(target + 2, pol.max_prefetch))
            if (target > workers and want > c.prefetch) or (
                target < workers and want < c.prefetch
            ):
                moved |= self._adjust(
                    "prefetch", c.prefetch, want, reason, c.set_prefetch
                )
        if moved:
            self._climber.acted()

    # -- readahead from observed IO bandwidth --------------------------------

    def _step_readahead(self, payload: Dict[str, Any]) -> None:
        pol = self.policy
        c = self.control
        cur = c.readahead_bytes
        if cur is None or not cur:
            return  # readahead disabled: nothing to scale
        io = (payload.get("stages") or {}).get("read.io")
        if not io:
            return
        bps = io.get("bytes_per_sec") or 0.0
        if bps <= 0:
            return
        want = bps * pol.readahead_horizon_s
        want_mb = max(pol.min_readahead_mb, min(pol.max_readahead_mb, want / (1 << 20)))
        want_bytes = int(round(want_mb)) << 20
        lo = cur * (1.0 - pol.readahead_rel_band)
        hi = cur * (1.0 + pol.readahead_rel_band)
        if lo <= want_bytes <= hi:
            return
        self._adjust(
            "readahead_mb",
            round(cur / (1 << 20), 1),
            want_bytes >> 20,
            "read_io_bandwidth",
            lambda mb: c.set_readahead_bytes(int(mb) << 20),
        )

    # -- stall thresholds from observed latency quantiles --------------------

    def _step_thresholds(self, payload: Dict[str, Any]) -> None:
        guard = self.control.guard
        if guard is None:
            return
        pol = self.policy
        q = payload.get("quantiles") or {}

        def p99_ms(stage: str) -> Optional[float]:
            entry = q.get(stage)
            if not entry or entry.get("count", 0) < pol.min_latency_samples:
                return None
            return entry.get("p99_ms")

        read_p99 = p99_ms("read.io") or p99_ms("read")
        open_p99 = p99_ms("read.open")
        updates: Dict[str, float] = {}
        if read_p99 is not None:
            # deadlines are only ADAPTED, never introduced: a user who set
            # no read/open deadline opted out of raise-on-stall semantics,
            # and a derived deadline that false-positives would kill their
            # epoch. Hedging has no such failure mode (the losing side is
            # discarded, first byte-identical result wins), so it may be
            # introduced on observation alone.
            if guard.read_deadline is not None:
                updates["read_deadline_ms"] = _clamp(
                    pol.deadline_p99_mult * read_p99,
                    pol.min_deadline_ms,
                    pol.max_deadline_ms,
                )
            updates["hedge_after_ms"] = _clamp(
                pol.hedge_p99_mult * read_p99,
                pol.min_hedge_ms,
                pol.max_deadline_ms,
            )
        if open_p99 is not None and guard.open_deadline is not None:
            updates["open_deadline_ms"] = _clamp(
                pol.deadline_p99_mult * open_p99,
                pol.min_deadline_ms,
                pol.max_deadline_ms,
            )
        current = {
            "read_deadline_ms": _to_ms(guard.read_deadline),
            "open_deadline_ms": _to_ms(guard.open_deadline),
            "hedge_after_ms": _to_ms(guard.hedge_after),
        }
        apply_kw: Dict[str, float] = {}
        for knob, want in updates.items():
            cur = current[knob]
            if cur is not None and abs(want - cur) <= pol.threshold_rel_band * cur:
                continue  # within the no-twitch band
            apply_kw[knob] = want
        if not apply_kw:
            return

        def apply_one(knob):
            def _apply(v):
                guard.update_thresholds(**{knob: v})

            return _apply

        for knob, want in apply_kw.items():
            self._adjust(
                knob,
                round(current[knob], 1) if current[knob] is not None else None,
                round(want, 1),
                "observed_p99",
                apply_one(knob),
            )


def _to_ms(seconds: Optional[float]) -> Optional[float]:
    return round(seconds * 1000.0, 1) if seconds is not None else None


def _clamp(v: float, lo: float, hi: float) -> float:
    return max(lo, min(hi, v))
