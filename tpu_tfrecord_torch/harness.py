"""The trainer harness: port of ``examples/_harness.py``.

One loop shape for a trainer: duty-cycled wait/step windows with a
one-deep pipeline (the host fetches and stages batch N+1 while the card
runs step N), a checkpoint cadence, fingerprint-tolerant resume and an
end-of-run summary. Every step is split into disjoint wall-clock phases
(``StepPhases``: ``train.data_wait`` / ``train.h2d`` / ``train.compute`` /
``train.ckpt`` stages with latency histograms, ``train.step`` and the
``train.steps`` counter), carries a ``train.step`` span and a profiler
range, and every window of steps publishes the phase shares as
``train.share.<phase>`` gauges with the training verdict
(``telemetry.training_verdict``). ``fold_model_diagnostics`` folds a
model's diagnostics (the MoE counts, the pipeline bubble) into gauges and
histograms.

The pipeline blocks on the previous step through a CUDA event recorded
on the current stream right after that step was dispatched, never through a
device-wide synchronize. On the CPU the step has finished when it
returns.

``trainer_spool`` / ``release_trainer_spool`` hold the process's fleet
spool (``fleet.py``) under the ``trainer`` role, from a directory or
``TFR_TRAIN_SPOOL_DIR``, so the fleet aggregator sees the step phases.

Not ported: the mesh helpers ``report_mesh`` and
``report_fsdp_param_bytes``.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from tpu_tfrecord_torch import checkpoint, fleet, telemetry
from tpu_tfrecord_torch.metrics import METRICS
from tpu_tfrecord_torch.tracing import DutyCycle, trace


def resume_or_fresh(ds, ckpt_dir: str):
    """(iterator, resume_state): ``ds.batches`` at the saved input
    position when one exists and still matches the dataset's fingerprint;
    a state saved for another dataset starts fresh with a loud line."""
    resume = checkpoint.load_state(ckpt_dir)
    print("resuming from", resume) if resume else print("fresh start")
    try:
        return ds.batches(resume), resume
    except ValueError as e:
        print(f"saved input state incompatible ({e}); starting fresh")
        return ds.batches(None), None


def state_saver(ckpt_dir: str):
    """(save_callback, saver) for ``run_train_loop``'s ``save=``: the
    callback reads the live iterator's position on the caller's thread
    and hands the durable write to the commit thread
    (``checkpoint.AsyncStateSaver``). ``TFR_CKPT_MODE=sync`` writes inline.
    Call ``saver.close()`` in a ``finally`` so the last commit drains."""
    sync = os.environ.get("TFR_CKPT_MODE", "async") == "sync"
    saver = checkpoint.AsyncStateSaver(ckpt_dir, sync=sync)

    def save(step, live_it, _state):
        saver.save(live_it, step=step)

    return save, saver


def stage_throughput() -> dict:
    """records/s of every stage with both records and measured time
    (gauges and pure event counters are left out)."""
    return {
        k: round(v["records_per_sec"])
        for k, v in METRICS.snapshot().items()
        if v.get("records") and v.get("seconds")
    }


class StepPhases:
    """Per-step phase decomposition, the training half of the flight
    recorder.

    Phases are disjoint wall-clock parts of one loop iteration:

    - ``data_wait``: blocked in ``next(it)``, minus the transfer seconds a
      ``DeviceIterator`` spent inside that call (its ``transfer_seconds``
      is read around the wait);
    - ``h2d``: host batch assembly and device placement (``produce``),
      plus those transfer seconds;
    - ``compute``: the device-step window (block on step N-1, dispatch step N);
    - ``ckpt``: the checkpoint callback.

    Timings are buffered per step and committed by ``end_step`` (stages,
    histograms, ``train.steps``, ``train.step``, one ``train.step`` span);
    ``abort_step`` drops the last iteration that only discovers the end
    of the data. Every ``window`` steps the windowed shares are published
    as ``train.share.<phase>`` gauges with a ``train.verdict`` instant."""

    PHASES = telemetry.TRAIN_PHASES

    def __init__(self, window: int = 16, metrics=None):
        if window < 1:
            raise ValueError("window must be >= 1")
        self.window = int(window)
        self.metrics = metrics or METRICS
        self.steps = 0
        self._totals = {p: 0.0 for p in self.PHASES}
        self._window_start = dict(self._totals)
        self._pending = {p: 0.0 for p in self.PHASES}
        self._pending_t0_ns: Optional[int] = None
        self._last_shares: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str, iterator=None):
        """Time one phase of the current step. ``iterator`` (the wait
        phase passes the batch iterator) moves a DeviceIterator's inline
        transfer seconds from data_wait to h2d."""
        if self._pending_t0_ns is None:
            self._pending_t0_ns = time.perf_counter_ns()
        t0 = time.perf_counter()
        h0 = getattr(iterator, "transfer_seconds", 0.0) if iterator is not None else 0.0
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            inline_h2d = 0.0
            if iterator is not None:
                inline_h2d = getattr(iterator, "transfer_seconds", 0.0) - h0
                # never more than the wall this wait took (a transfer
                # thread may have progressed meanwhile)
                inline_h2d = min(max(0.0, inline_h2d), dt)
                dt -= inline_h2d
            self._pending[name] += dt
            self._pending["h2d"] += inline_h2d

    def end_step(self) -> None:
        """Commit the buffered phases as one completed step."""
        step_seconds = 0.0
        for name, dt in self._pending.items():
            if dt:
                self.metrics.add(telemetry.TRAIN_STAGE_PREFIX + name, records=1, seconds=dt,
                                 latency=dt)
                self._totals[name] += dt
                step_seconds += dt
        self.steps += 1
        self.metrics.count("train.steps")
        self.metrics.add("train.step", records=1, seconds=step_seconds, latency=step_seconds)
        if self._pending_t0_ns is not None:
            telemetry.record_span("train.step", self._pending_t0_ns,
                                  time.perf_counter_ns() - self._pending_t0_ns, step=self.steps)
        self.abort_step()
        if self.steps % self.window == 0:
            self._refresh_window()

    def abort_step(self) -> None:
        """Drop the buffered partial step: nothing lands in the registry."""
        self._pending = {p: 0.0 for p in self.PHASES}
        self._pending_t0_ns = None

    def _refresh_window(self) -> None:
        deltas = {p: self._totals[p] - self._window_start[p] for p in self.PHASES}
        total = sum(deltas.values())
        if total > 0:
            self._last_shares = {p: deltas[p] / total for p in self.PHASES}
            for p, v in self._last_shares.items():
                self.metrics.gauge(telemetry.TRAIN_SHARE_PREFIX + p, round(v, 4))
            telemetry.instant("train.verdict", verdict=self.verdict(), step=self.steps)
        self._window_start = dict(self._totals)

    def flush(self) -> None:
        """Publish the shares of a run that never completed a window (a
        no-op once a full window has published)."""
        if self._last_shares:
            return
        if any(self._totals[p] > self._window_start[p] for p in self.PHASES):
            self._refresh_window()

    def shares(self) -> Dict[str, float]:
        """The newest windowed shares; before the first full window, the
        lifetime shares."""
        if self._last_shares:
            return dict(self._last_shares)
        total = sum(self._totals.values())
        if total <= 0:
            return {}
        return {p: v / total for p, v in self._totals.items()}

    def verdict(self) -> str:
        return telemetry.training_verdict(self.shares())


def fold_model_diagnostics(diag, metrics=None) -> Dict[str, float]:
    """A model's diagnostics (``lm.forward(diagnostics=True)``'s dict) ->
    one gauge (the last value) and one histogram observation (the spread
    over steps) a metric. Returns the folded floats.

    ``moe.expert_imbalance`` (max over mean of the routed tokens per
    expert: 1.0 is perfectly balanced), ``moe.dropped_fraction`` and
    ``moe.gate_entropy`` come from the MoE entries,
    ``pipeline.bubble_fraction`` (and ``pipeline.bubble_fraction_v`` when
    ``virtual_stages`` > 1) from the pipeline's. The whole dict comes to
    the host in one copy: call it after the step's loss has been waited
    on, so the copy adds no wait of its own."""
    metrics = metrics or METRICS
    out: Dict[str, float] = {}
    if not diag:
        return out
    names = sorted(diag)
    # float64 keeps a host float (the pipeline's bubble) exact and an f32
    # tensor's value unchanged
    tensors = [torch.as_tensor(diag[k], dtype=torch.float64).detach().reshape(-1)
               for k in names]
    flat = torch.cat([t.to(tensors[0].device) for t in tensors]).cpu().numpy()
    host, at = {}, 0
    for name, t in zip(names, tensors):
        host[name] = flat[at:at + t.numel()]
        at += t.numel()
    if "expert_tokens" in host:
        tokens = host["expert_tokens"].astype(np.float64)
        mean = tokens.mean() if tokens.size else 0.0
        out["moe.expert_imbalance"] = float(tokens.max() / mean) if mean > 0 else 0.0
        out["moe.dropped_fraction"] = float(host["dropped_fraction"][0])
        out["moe.gate_entropy"] = float(host["gate_entropy"][0])
    if "bubble_fraction" in host:
        out["pipeline.bubble_fraction"] = float(host["bubble_fraction"][0])
        if "virtual_stages" in host and float(host["virtual_stages"][0]) > 1:
            # the interleaved schedule's number, under its own name
            out["pipeline.bubble_fraction_v"] = float(host["bubble_fraction"][0])
    for name, v in out.items():
        metrics.gauge(name, v)
        metrics.observe(name, v)
    return out


def trainer_spool(spool_dir: Optional[str] = None, interval_s=None):
    """Acquire this process's telemetry spool under the ``trainer`` role
    (None when no dir is configured). Falls back to the
    ``TFR_TRAIN_SPOOL_DIR`` env var (and ``TFR_TRAIN_SPOOL_INTERVAL_S``)
    so the trainers without a spool flag spool too; pair with
    ``release_trainer_spool`` so a clean exit lands the ``final: true``
    goodbye snapshot (the aggregator then never flags the trainer dead)."""
    spool_dir = spool_dir or os.environ.get("TFR_TRAIN_SPOOL_DIR")
    if not spool_dir:
        return None
    if interval_s is None:
        env = os.environ.get("TFR_TRAIN_SPOOL_INTERVAL_S")
        interval_s = float(env) if env else None
    return fleet.acquire_spool(spool_dir, role="trainer", interval_s=interval_s)


def release_trainer_spool(spool) -> None:
    """Release a ``trainer_spool`` handle (no-op for None)."""
    if spool is not None:
        fleet.release_spool(spool.spool_dir)


def _step_event(loss) -> Optional[torch.cuda.Event]:
    """An event recorded on the current stream just after the step that
    gave ``loss``; None where there is nothing to wait for (a CPU step has
    finished when it returns)."""
    if isinstance(loss, torch.Tensor) and loss.is_cuda:
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(loss.device))
        return event
    return None


def _block(event: Optional[torch.cuda.Event]) -> None:
    if event is not None:
        event.synchronize()


def run_train_loop(
    it,
    produce: Callable,
    step_fn: Callable,
    state: Tuple,
    *,
    save: Optional[Callable[[int, object, object], None]] = None,
    save_every: int = 8,
    log_every: int = 8,
    on_step: Optional[Callable[[int, object], None]] = None,
    max_steps: Optional[int] = None,
    phases: Optional[StepPhases] = None,
) -> Tuple[Tuple, int, DutyCycle]:
    """The shared duty-cycled loop.

    - ``it``: the batch iterator (``next(it, None)``).
    - ``produce(cb) -> batch``: host prep and device placement, inside the
      WAIT window with the fetch, so the duty cycle cannot rise exactly
      when the input pipeline binds.
    - ``step_fn(state, batch) -> (state, loss)``: the update. The previous
      step is waited for inside the busy window (its CUDA event) before
      this one is dispatched: a one-deep pipeline.
    - ``save(step, it, state)``: every ``save_every`` steps, after the log
      line; it gets the live train state.
    - ``on_step(step, loss)``: after the loss is known.
    - ``phases``: the ``StepPhases`` recorder (one is made when None).

    Returns (state, steps, duty)."""
    step = 0
    duty = DutyCycle()
    rec = phases if phases is not None else StepPhases()
    prev_loss = prev_done = None
    while max_steps is None or step < max_steps:
        with trace("train.step"):
            with duty.wait():
                with rec.phase("data_wait", iterator=it):
                    cb = next(it, None)
                with rec.phase("h2d"):
                    gb = produce(cb) if cb is not None else None
            with duty.step():
                with rec.phase("compute"):
                    _block(prev_done)
                    if gb is not None:
                        state, prev_loss = step_fn(state, gb)
                        prev_done = _step_event(prev_loss)
            if cb is None:
                # discovering the end is not a step: its wait must not land
                # in the phases or the shares
                rec.abort_step()
                break
            step += 1
            # waiting on THIS step (the on_step / log paths) is device-step
            # time: it belongs to the compute phase
            if on_step is not None and prev_loss is not None:
                with rec.phase("compute"):
                    _block(prev_done)
                on_step(step, prev_loss)
            if step % log_every == 0 and prev_loss is not None:
                with rec.phase("compute"):
                    _block(prev_done)
                print(f"step {step}  loss ~{float(prev_loss):.4f}", flush=True)
            if save is not None and step % save_every == 0:
                with rec.phase("ckpt"):
                    save(step, it, state)
            rec.end_step()
    _block(prev_done)
    rec.flush()  # a run shorter than one window still lands its shares
    return state, step, duty


def finish(
    ckpt_dir: Optional[str],
    step: int,
    batch_size: int,
    t0: float,
    duty: DutyCycle,
    clear_state: bool = True,
    stages: bool = False,
    phases: Optional[StepPhases] = None,
) -> None:
    """End-of-run bookkeeping: clear the input state when the epoch budget
    is spent (the next run starts a fresh pass, not a resume into an empty
    stream), print the examples/s line, the duty cycle, the phase shares
    and verdict, and optionally the stage table."""
    if clear_state and ckpt_dir is not None:
        state_file = checkpoint.state_path(ckpt_dir)
        if os.path.exists(state_file):
            os.remove(state_file)
    dt = time.perf_counter() - t0
    print(f"done: {step} steps, {step * batch_size / dt:,.0f} examples/s")
    if duty.value() is not None:
        print(f"device duty cycle: {duty.value():.1%}")
    if phases is not None and phases.shares():
        shares = {k: round(v, 3) for k, v in phases.shares().items()}
        print(f"train phases: {shares}  verdict: {phases.verdict()}")
    if stages:
        print("stage throughput:", stage_throughput())
