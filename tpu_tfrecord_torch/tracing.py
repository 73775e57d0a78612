"""Profiling hooks: torch.profiler regions and sessions, and the device's
duty cycle.

Port of ``tpu_tfrecord/tracing.py``:

- ``trace(name)``: a host region on the profiler's timeline
  (``torch.profiler.record_function``), beside the device's kernels;
- ``start_trace(logdir)`` / ``stop_trace()``: one ``torch.profiler``
  session over the CPU (and CUDA, where there is a card) whose trace is
  written into ``logdir`` when it stops;
- ``DutyCycle``: the share of wall time the loop spends in its steps
  against waiting for input, split on the host clock. Use ``step()``
  around a step that synchronizes its own stream, so that its time is the
  device's.
"""

from __future__ import annotations

import contextlib
import time
from typing import Optional

import torch

_SESSION: Optional[torch.profiler.profile] = None


def trace(name: str):
    """Annotate a host region on the profiler's timeline."""
    return torch.profiler.record_function(name)


def start_trace(logdir: str) -> None:
    """Start a profiler session; ``stop_trace`` writes its trace into
    ``logdir``. One session at a time."""
    global _SESSION
    if _SESSION is not None:
        raise RuntimeError("a trace is already running")
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    session = torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir),
    )
    session.start()
    _SESSION = session


def stop_trace() -> None:
    """Stop the running session and write its trace."""
    global _SESSION
    if _SESSION is None:
        raise RuntimeError("no trace is running")
    session, _SESSION = _SESSION, None
    session.stop()


class DutyCycle:
    """Track step (busy) against input-wait time in a loop.

    Usage::

        duty = DutyCycle()
        for ...:
            with duty.wait():     # host blocked on the input pipeline
                batch = next(it)
            with duty.step():     # the step, synchronized on its stream
                loss = step(batch)
        print(duty.value())       # busy / (busy + wait)
    """

    def __init__(self):
        self.busy_seconds = 0.0
        self.wait_seconds = 0.0

    @contextlib.contextmanager
    def step(self):
        t0 = time.perf_counter()
        yield
        self.busy_seconds += time.perf_counter() - t0

    @contextlib.contextmanager
    def wait(self):
        t0 = time.perf_counter()
        yield
        self.wait_seconds += time.perf_counter() - t0

    def value(self) -> Optional[float]:
        total = self.busy_seconds + self.wait_seconds
        return self.busy_seconds / total if total > 0 else None
