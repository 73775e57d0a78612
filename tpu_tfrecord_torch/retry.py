"""One shared retry/backoff policy for transient filesystem faults.

Copy of ``tpu_tfrecord/retry.py``. ``RetryPolicy`` owns the budget
(attempts and an optional wall-clock deadline), the capped exponential
backoff with full jitter (uniform in [0, cap], so failures that happen
together do not retry in lockstep), and injectable ``sleep``/``clock``/
``rand`` seams, so tests prove retry behaviour without sleeping.

``policy.call(fn, retry_on=(OSError,))`` runs a plain call under the
policy. The pause protocol (the writer's commit-side operations and the
dataset's shard decode, which re-enters with its own skip accounting)::

      attempt, start = 0, policy.clock()
      while True:
          try:
              ...  # one attempt
              return
          except RETRYABLE:
              attempt += 1
              if not policy.pause(attempt, start):
                  raise
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass, field
from typing import Callable, Optional, Tuple, Type


@dataclass(frozen=True)
class RetryPolicy:
    """Immutable retry configuration + the clock/sleep seams.

    ``max_retries`` counts RETRIES, not attempts: 0 means one attempt and
    no retry (the historical ``read_retries=0`` default). ``deadline``
    bounds total elapsed time since the caller's ``start`` timestamp: once
    it is exhausted no retry is taken, and a backoff that would overrun it
    is CAPPED to the remaining budget — the policy never sleeps past its
    own deadline (it used to refuse such retries outright, giving up
    budget that was still available).
    """

    max_retries: int = 0
    base_delay: float = 0.1
    max_delay: float = 2.0
    jitter: bool = True
    deadline: Optional[float] = None
    sleep: Callable[[float], None] = field(default=time.sleep, repr=False)
    clock: Callable[[], float] = field(default=time.monotonic, repr=False)
    rand: Callable[[], float] = field(default=random.random, repr=False)

    def __post_init__(self) -> None:
        if self.max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, got {self.max_retries}")
        if self.base_delay < 0 or self.max_delay < 0:
            raise ValueError("delays must be >= 0")

    def backoff(self, attempt: int) -> float:
        """Delay before retry ``attempt`` (1-based): capped exponential,
        full jitter (uniform in [0, cap]) unless ``jitter=False``."""
        cap = min(self.max_delay, self.base_delay * (2 ** max(0, attempt - 1)))
        return cap * self.rand() if self.jitter else cap

    def pause(self, attempt: int, start: Optional[float] = None) -> bool:
        """Sleep before retry ``attempt`` and return True, or return False
        (without sleeping) when the budget — attempt count, or deadline
        measured from ``start`` — is exhausted and the caller must raise."""
        if attempt > self.max_retries:
            return False
        delay = self.backoff(attempt)
        if self.deadline is not None and start is not None:
            remaining = self.deadline - (self.clock() - start)
            if remaining <= 0:
                return False
            # never sleep past the deadline: spend exactly the remaining
            # budget on this backoff instead of refusing the retry
            delay = min(delay, remaining)
        if delay > 0:
            self.sleep(delay)
        return True

    def call(
        self,
        fn: Callable,
        *args,
        retry_on: Tuple[Type[BaseException], ...] = (OSError,),
        on_retry: Optional[Callable[[int, BaseException], None]] = None,
        **kwargs,
    ):
        """Run ``fn`` under this policy. ``on_retry(attempt, exc)`` fires
        once per retry actually taken."""
        attempt = 0
        start = self.clock()
        while True:
            try:
                return fn(*args, **kwargs)
            except retry_on as e:
                attempt += 1
                if not self.pause(attempt, start):
                    raise
                if on_retry is not None:
                    on_retry(attempt, e)
