"""Stall defence: per-op deadlines, hedged reads and the stall exceptions.

Copy of ``tpu_tfrecord/stall.py``, for local paths and URLs. A hung
``read()`` or a wedged decode worker raises nothing, so the retry and
``on_corrupt`` machinery never sees it. This module turns stalls into
faults that raise:

- ``StallError`` (an OSError) is what every stall detection raises, so it
  flows through the dataset's transient-retry net (``_retrying`` catches
  OSError) and then, once the retries are spent, through ``on_stall``
  (``raise`` | ``skip_shard``). ``DeadlineError`` is a deadline miss,
  ``WatchdogError`` a worker the decode pool's watchdog declared wedged.
- ``StallGuard`` (built by ``guard_from_options``; None when no threshold
  is set, so the default path pays nothing) runs shard opens under
  ``open_deadline_ms`` and every raw read under ``read_deadline_ms``;
  ``hedge_after_ms`` starts a backup open + read of the same byte range
  when the primary goes quiet, and the first answer wins. The bytes are
  the same whichever side wins: both read ``[offset, offset + n)`` of the
  same file.
- ``GuardedReadStream`` sits under the codec wrapper (raw file bytes), so
  deadlines and hedges work alike for every codec, and a hedge's handle
  can seek.

Each guarded stream owns one daemon worker thread (``_OpWorker``, taken
from the process-wide ``_WorkerPool``) that runs its reads in order; the
caller waits on a Future with a timeout. A miss abandons the worker
(Python cannot cancel a thread blocked in a C-level read), marks the
stream wedged, counts ``read.stalls`` / ``read.deadline_misses`` and
raises ``DeadlineError``; the abandoned worker closes its handle when the
blocked call returns. Reads smaller than ``io_chunk`` are served from an
internal buffer, so the fault-free cost is one queue hand-off per
``io_chunk`` of raw bytes.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import FIRST_COMPLETED, Future
from concurrent.futures import TimeoutError as _FutureTimeout
from concurrent.futures import wait as _wait_futures
from time import monotonic as _monotonic
from typing import BinaryIO, Callable, Optional

from tpu_tfrecord_torch import telemetry
from tpu_tfrecord_torch.metrics import METRICS, Metrics


class StallError(OSError):
    """A stall converted into a raising fault: an OSError, so the
    transient-retry nets treat it like any other IO fault."""


class DeadlineError(StallError):
    """An op exceeded its configured deadline (read_deadline_ms /
    open_deadline_ms)."""


class WatchdogError(StallError):
    """The pipeline watchdog declared a shard worker wedged (no progress
    heartbeat within the watchdog timeout)."""


class _OpWorker:
    """One daemon thread running submitted thunks strictly in order.

    ``abandon()`` tells it to exit after the op it is (possibly forever)
    blocked in; the pending future still completes/errors when that op
    returns, so an ``add_done_callback`` can close the abandoned handle.
    """

    def __init__(self, name: str = "tfr-stall"):
        self._q: "queue.Queue" = queue.Queue()
        self.abandoned = False
        self._thread = threading.Thread(target=self._run, daemon=True, name=name)
        self._thread.start()

    def submit(self, fn: Callable) -> Future:
        fut: Future = Future()
        self._q.put((fn, fut))
        return fut

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            fn, fut = item
            try:
                result = fn()
            except BaseException as e:  # delivered through the future
                fut.set_exception(e)
            else:
                fut.set_result(result)
            if self.abandoned:
                return

    def abandon(self) -> None:
        self.abandoned = True
        self._q.put(None)  # wake it if idle so the thread exits

    def close(self) -> None:
        self._q.put(None)


class _WorkerPool:
    """Free-list of _OpWorkers. Shard opens happen ~continuously on small
    shards; paying a thread CREATE per open/stream taxes a fully-loaded
    host, while a reused idle worker costs only the queue hand-off.
    Abandoned (wedged)
    workers are never checked back in; the idle list is bounded.

    There is ONE pool per process (``_SHARED_POOL``): a checked-out worker
    is exclusively owned until checkin, so sharing is safe, idle threads
    are bounded process-wide, and short-lived guards cannot strand their
    own pool's idle threads."""

    _MAX_IDLE = 8

    def __init__(self):
        self._idle: list = []
        self._lock = threading.Lock()

    def checkout(self) -> _OpWorker:
        with self._lock:
            if self._idle:
                return self._idle.pop()
        return _OpWorker()

    def checkin(self, worker: _OpWorker) -> None:
        if worker.abandoned:
            return
        with self._lock:
            if len(self._idle) < self._MAX_IDLE:
                self._idle.append(worker)
                return
        worker.close()


_SHARED_POOL = _WorkerPool()


def _close_quietly(fh) -> None:
    try:
        fh.close()
    except Exception:
        pass


def _close_result_when_done(fut: Future, pick=lambda r: r) -> None:
    """When an ABANDONED op finally returns, close the handle it yields
    (``pick`` extracts it from the result); errors are swallowed — the op
    was already given up on."""

    def _cb(f: Future) -> None:
        if f.cancelled() or f.exception() is not None:
            return
        _close_quietly(pick(f.result()))

    fut.add_done_callback(_cb)


def _close_fh_when_done(fut: Future, fh) -> None:
    """Close ``fh`` once the abandoned op blocked on it completes (the
    result — bytes of a stream we no longer trust — is discarded)."""

    def _cb(f: Future) -> None:
        f.exception()  # consume, never let it propagate
        _close_quietly(fh)

    fut.add_done_callback(_cb)


class GuardedReadStream:
    """Sequential read stream with per-op deadline + optional hedging.

    Plain duck-typed file object (read/tell/close only — deliberately NO
    readinto: an abandoned worker must never be left writing into
    caller-owned scratch memory, so every guarded read returns fresh
    bytes). ``reopen(pos)`` returns a fresh raw handle positioned at byte
    ``pos`` — the hedge's backup side; hedging is off when it is None.
    """

    def __init__(
        self,
        fh: BinaryIO,
        path: str,
        read_deadline: Optional[float],
        hedge_after: Optional[float],
        reopen: Optional[Callable[[int], BinaryIO]] = None,
        metrics: Metrics = METRICS,
        io_chunk: int = 4 << 20,
        pool: Optional[_WorkerPool] = None,
        guard: "Optional[StallGuard]" = None,
    ):
        self._fh = fh
        self._path = path
        self._fixed_deadline = read_deadline
        self._fixed_hedge_after = hedge_after
        # threshold source (autotune): when a guard is given, every fetch
        # reads ITS current read_deadline/hedge_after — so a controller
        # update (StallGuard.update_thresholds) takes effect on live
        # streams, not just the next shard open
        self._guard = guard
        self._reopen = reopen
        self._metrics = metrics
        self._io_chunk = max(1, int(io_chunk))
        self._pool = pool
        self._worker = pool.checkout() if pool is not None else _OpWorker()
        self._fetched = 0  # raw bytes consumed from the underlying object
        self._buf = b""
        self._buf_pos = 0
        self._wedged = False
        self._closed = False

    # -- live thresholds -----------------------------------------------------

    @property
    def _deadline(self) -> Optional[float]:
        g = self._guard
        return g.read_deadline if g is not None else self._fixed_deadline

    @property
    def _hedge_after(self) -> Optional[float]:
        if self._reopen is None:
            return None  # no backup opener: hedging impossible
        g = self._guard
        return g.hedge_after if g is not None else self._fixed_hedge_after

    # -- the guarded fetch ---------------------------------------------------

    def _fetch(self, n: int) -> bytes:
        """One underlying read of up to ``n`` bytes under deadline+hedge."""
        if self._wedged:
            raise DeadlineError(f"read stream wedged after stall: {self._path}")
        fh = self._fh
        t0 = _monotonic()
        fut = self._worker.submit(lambda: fh.read(n))
        hedge_first = self._hedge_after is not None and (
            self._deadline is None or self._hedge_after < self._deadline
        )
        try:
            data = fut.result(self._hedge_after if hedge_first else self._deadline)
        except _FutureTimeout:
            if hedge_first:
                return self._fetch_hedged(fut, n, t0)
            self._declare_stall(fut)
        self._fetched += len(data)
        return data

    def _remaining(self, t0: float) -> Optional[float]:
        """Seconds left of this fetch's read deadline (None = unbounded)."""
        if self._deadline is None:
            return None
        return max(0.001, self._deadline - (_monotonic() - t0))

    def _fetch_hedged(self, primary_fut: Future, n: int, t0: float) -> bytes:
        """The primary went quiet: launch a backup open+read of the SAME
        byte range; first result wins, the loser is abandoned (bytes
        discarded, handle closed when its blocked call returns)."""
        self._metrics.count("read.hedges")
        telemetry.instant("read.hedge", path=self._path)
        pos = self._fetched
        reopen = self._reopen
        backup_worker = _OpWorker(name="tfr-stall-hedge")

        def backup_read():
            bfh = reopen(pos)
            try:
                return bfh, bfh.read(n)
            except BaseException:
                _close_quietly(bfh)
                raise

        backup_fut = backup_worker.submit(backup_read)
        done, _ = _wait_futures(
            [primary_fut, backup_fut],
            timeout=self._remaining(t0),
            return_when=FIRST_COMPLETED,
        )
        if primary_fut in done:
            backup_worker.abandon()
            _close_result_when_done(backup_fut, pick=lambda r: r[0])
            data = primary_fut.result()  # re-raises a real (non-stall) error
            self._fetched += len(data)
            return data
        if backup_fut in done:
            try:
                bfh, data = backup_fut.result()
            except BaseException:
                # The BACKUP failed (its open/read erred) while the primary
                # is merely slow: a failed hedge must not shorten the
                # primary's deadline — keep waiting on the primary for the
                # rest of the read budget (forever when no deadline is
                # configured; only its true expiry declares the stall).
                backup_worker.close()
                try:
                    data = primary_fut.result(self._remaining(t0))
                except _FutureTimeout:
                    self._declare_stall(primary_fut)
                self._fetched += len(data)
                return data
            backup_worker.close()
            self._metrics.count("read.hedge_wins")
            telemetry.instant("read.hedge_win", path=self._path)
            old_worker = self._worker
            old_worker.abandon()
            _close_fh_when_done(primary_fut, self._fh)
            self._fh = bfh
            self._worker = (
                self._pool.checkout() if self._pool is not None else _OpWorker()
            )
            self._fetched += len(data)
            return data
        # neither side produced within the deadline
        backup_worker.abandon()
        _close_result_when_done(backup_fut, pick=lambda r: r[0])
        self._declare_stall(primary_fut)

    def _declare_stall(self, fut: Future):
        self._wedged = True
        self._metrics.count("read.stalls")
        self._metrics.count("read.deadline_misses")
        telemetry.instant("read.stall", path=self._path, kind="read_deadline")
        self._worker.abandon()
        _close_fh_when_done(fut, self._fh)
        raise DeadlineError(
            f"read exceeded deadline "
            f"({(self._deadline or 0) * 1000:.0f} ms) on {self._path}"
        ) from None

    # -- file-object surface -------------------------------------------------

    def read(self, size: int = -1) -> bytes:
        if size is None or size < 0:
            parts = []
            while True:
                chunk = self.read(self._io_chunk)
                if not chunk:
                    return b"".join(parts)
                parts.append(chunk)
        if size == 0:
            return b""
        avail = len(self._buf) - self._buf_pos
        if avail:
            take = min(avail, size)
            out = self._buf[self._buf_pos : self._buf_pos + take]
            self._buf_pos += take
            if self._buf_pos >= len(self._buf):
                self._buf = b""
                self._buf_pos = 0
            return out
        if size >= self._io_chunk:
            return self._fetch(size)
        data = self._fetch(self._io_chunk)
        if len(data) <= size:
            return data
        self._buf = data
        self._buf_pos = size
        return data[:size]

    def tell(self) -> int:
        return self._fetched - (len(self._buf) - self._buf_pos)

    def readable(self) -> bool:
        return True

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        worker, fh = self._worker, self._fh
        if self._wedged:
            worker.close()  # handle closes via the abandoned-op callback
            return
        fut = worker.submit(fh.close)
        try:
            fut.result(1.0)
        except _FutureTimeout:
            worker.abandon()
            return
        except Exception:
            pass
        if self._pool is not None:
            self._pool.checkin(worker)
        else:
            worker.close()

    @property
    def closed(self) -> bool:
        return self._closed

    def __enter__(self) -> "GuardedReadStream":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class StallGuard:
    """Per-dataset stall policy: deadlines + hedging wired into the shard
    open path. Built from TFRecordOptions (``guard_from_options``); None
    when no stall knob is set, so the unguarded hot path stays untouched."""

    def __init__(
        self,
        read_deadline: Optional[float] = None,
        open_deadline: Optional[float] = None,
        hedge_after: Optional[float] = None,
        metrics: Metrics = METRICS,
        io_chunk: int = 4 << 20,
        retry_policy=None,
    ):
        self.read_deadline = read_deadline
        self.open_deadline = open_deadline
        self.hedge_after = hedge_after
        self.metrics = metrics
        self.io_chunk = io_chunk
        # handed to the remote block prefetcher, so its fetches resume
        # under the budget of the dataset's shard-level retries (the
        # dataset sets it from its retry_policy)
        self.retry_policy = retry_policy
        # the process-wide pool: shard churn reuses worker threads instead
        # of creating one per open, and discarding this guard strands no
        # idle threads
        self._pool = _SHARED_POOL

    # -- controller-updated thresholds (autotune) ----------------------------

    def update_thresholds(
        self,
        read_deadline_ms: Optional[float] = None,
        open_deadline_ms: Optional[float] = None,
        hedge_after_ms: Optional[float] = None,
    ) -> None:
        """Retarget the guard's thresholds (milliseconds; None leaves a
        knob untouched). Live streams pick up read_deadline/hedge_after on
        their next fetch (GuardedReadStream reads them through the guard);
        open_deadline applies to the next open. Plain float attribute
        writes — atomic under the GIL, so no lock is needed for readers."""
        if read_deadline_ms is not None:
            self.read_deadline = read_deadline_ms / 1000.0
        if open_deadline_ms is not None:
            self.open_deadline = open_deadline_ms / 1000.0
        if hedge_after_ms is not None:
            self.hedge_after = hedge_after_ms / 1000.0

    # -- open-side deadline --------------------------------------------------

    def call_open(self, fn: Callable, path: str):
        """Run an open-type call under ``open_deadline_ms``. A miss bumps
        the stall counters and raises DeadlineError (retryable OSError);
        the late-arriving handle of an abandoned open is closed when the
        blocked call finally returns."""
        if self.open_deadline is None:
            return fn()
        worker = self._pool.checkout()
        fut = worker.submit(fn)
        try:
            result = fut.result(self.open_deadline)
        except _FutureTimeout:
            worker.abandon()
            _close_result_when_done(fut)
            self.metrics.count("read.stalls")
            self.metrics.count("read.deadline_misses")
            telemetry.instant("read.stall", path=path, kind="open_deadline")
            raise DeadlineError(
                f"open exceeded deadline "
                f"({self.open_deadline * 1000:.0f} ms) on {path}"
            ) from None
        except BaseException:
            # a REAL open error (missing file, transient fault): the op
            # completed, so the worker is healthy — return it to the pool
            # instead of leaking its thread, and let the error propagate
            self._pool.checkin(worker)
            raise
        self._pool.checkin(worker)
        return result

    # -- guarded compressed open ---------------------------------------------

    def open_compressed(self, path: str, codec: Optional[str]) -> BinaryIO:
        """The guarded twin of ``wire.open_compressed(path, 'rb', codec)``:
        the raw open under the open deadline, raw reads under the read
        deadline (and the hedge), the codec wrapper on top, so the
        deadline model covers every codec alike. A plain path opens through
        ``fs.local_open``, the seam ``faults.install_chaos`` patches; a URL
        through ``fs.open_for_read`` under ``retry_policy``, and the hedge
        reopens it with a plain ``open`` of its filesystem."""
        from tpu_tfrecord_torch import fs as _fs
        from tpu_tfrecord_torch import wire

        if _fs.has_scheme(path):
            fsys = _fs.filesystem_for(path)
            first = lambda: _fs.open_for_read(fsys, path, retry_policy=self.retry_policy)  # noqa: E731
            plain = lambda: fsys.open(path, "rb")  # noqa: E731
        else:
            first = plain = lambda: _fs.local_open(path, "rb")  # noqa: E731
        raw = self.call_open(first, path)

        def reopen(pos: int) -> BinaryIO:
            fh = plain()
            _fs.seek_to(fh, pos)
            return fh

        if self.read_deadline is None and self.hedge_after is None:
            guarded: BinaryIO = raw  # open deadline only: no read wrapper
        else:
            guarded = GuardedReadStream(
                raw,
                path,
                read_deadline=self.read_deadline,
                hedge_after=self.hedge_after,
                reopen=reopen,
                metrics=self.metrics,
                io_chunk=self.io_chunk,
                pool=self._pool,
                guard=self,  # live thresholds: autotune updates apply mid-stream
            )
        return wire.wrap_codec(path, "rb", wire.normalize_codec(codec), guarded)


def guard_from_options(options) -> Optional[StallGuard]:
    """A StallGuard for these options, or None when every stall knob is
    unset (the zero-overhead default)."""
    rd = getattr(options, "read_deadline_ms", None)
    od = getattr(options, "open_deadline_ms", None)
    hg = getattr(options, "hedge_after_ms", None)
    if rd is None and od is None and hg is None:
        return None
    return StallGuard(
        read_deadline=rd / 1000.0 if rd is not None else None,
        open_deadline=od / 1000.0 if od is not None else None,
        hedge_after=hg / 1000.0 if hg is not None else None,
    )
