"""Serving tier: continuous batching over ``LMStream``, on one device.

Port of ``tpu_tfrecord/serving.py``. N concurrent clients share one
``models.lm.LMStream``; the tier sheds load, honours deadlines and drains
gracefully. Three layers, separable for tests:

- :class:`ServingEngine`, the continuous-batching scheduler. Each tick
  packs up to ``mb`` schedulable requests into one microbatch
  (``models.lm.pack_slots``; continuations first, then admitted requests),
  pushes it through the stream with a host-side slot tag
  (``LMStream.submit_tagged``), and settles whatever popped: greedy argmax
  on the last position, slide the window, reschedule or finish. A
  finishing, expiring or disconnecting request frees its slot for the next
  tick. Admission is a bounded queue that refuses loudly
  (``serve.rejected`` and a Retry-After hint), and deadlines are enforced
  at admission and at every tick (an expired request is dropped and
  counted ``serve.deadline_expired``, never served late). Every model op
  is batch-row independent, so a request's tokens are those of a solo run
  (:func:`sequential_reference`), whatever shares its microbatch. Deadline
  and latency arithmetic reads the injectable ``clock``.
- :class:`ServeServer` / :class:`ServeClient`, the socket tier on the
  ``service_protocol`` framing (byte-identical to the JAX package's, so a
  client of either package talks to a replica of the other). A connection
  gets a reader and a writer thread with a bounded outbound queue, so a
  slow client blocks only its own writer; a disconnecting client cancels
  its live requests (``serve.disconnects``). The client walks a replica
  list and backs off on "overloaded" / "draining" with ``retry.py``'s
  policy, the server's Retry-After hint as the floor.
- chaos: ``op="serve"`` rules of a ``faults.FaultPlan`` (``slow_client``,
  ``client_disconnect``, ``burst``), consulted at the server's
  ``reply:<peer>`` / ``recv:<peer>`` seams (the plan passed to the server,
  or the one ``faults.install_chaos`` installed).

``python -m tpu_tfrecord_torch.serving`` runs a replica of a seeded
synthetic LM (``--device``, default ``cuda``; ``--stages`` is the stage
count of the one-device schedule): one JSON ready line (addr, pid) on
stdout, then it serves until a drain request or SIGTERM/SIGINT, finishes
every admitted request and exits 0.

``run_server(spool_dir=...)`` / ``--spool-dir`` spool the replica's
telemetry (``fleet.acquire_spool`` under ``role``, every 0.2 s); a drain,
SIGTERM included, lands the spool's ``final: true`` snapshot.

The autoscaler of the replicas is ``elastic.ServingScaler``, as in the
JAX package.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import signal
import socket
import sys
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from tpu_tfrecord_torch import faults as _faults
from tpu_tfrecord_torch import fleet as _fleet
from tpu_tfrecord_torch import retry as _retry
from tpu_tfrecord_torch import service_protocol as sp
from tpu_tfrecord_torch import telemetry as _telemetry
from tpu_tfrecord_torch.metrics import METRICS, logger
from tpu_tfrecord_torch.models import lm as _lm

__all__ = [
    "ServePolicy",
    "ServeRejected",
    "DeadlineExpired",
    "ServingEngine",
    "ServeServer",
    "ServeClient",
    "sequential_reference",
    "run_server",
    "main",
]


class ServeRejected(RuntimeError):
    """Admission refused the request (queue full or replica draining).
    Retriable: ``retry_after_s`` is the server's hint — the client-side
    backoff floor, exactly the Retry-After vocabulary httpfs honors."""

    def __init__(self, msg: str, retry_after_s: float = 0.0):
        super().__init__(msg)
        self.retry_after_s = float(retry_after_s)


class DeadlineExpired(RuntimeError):
    """The request's deadline passed before its last token — at
    admission, in the queue, or mid-generation. NOT retriable as-is (the
    answer would still be late); the caller owns the next move."""


@dataclass(frozen=True)
class ServePolicy:
    """Admission/scheduling knobs for one serving replica.

    ``mb`` is the microbatch row count — the slot count of the ONE
    compiled per-tick step (a different mb is a different program; pick
    it at startup). ``max_queue`` bounds requests admitted but not yet
    generating; the ``max_queue+1``-th concurrent arrival is shed with
    ``retry_after_s`` scaled by queue pressure. ``default_deadline_s``
    applies to requests that carry none (None = no deadline).
    ``slo_p99_ms`` is the target `telemetry.serving_verdict` judges
    against."""

    mb: int = 4
    max_queue: int = 16
    default_deadline_s: Optional[float] = None
    retry_after_s: float = 0.05
    slo_p99_ms: float = 250.0

    def __post_init__(self) -> None:
        if self.mb < 1:
            raise ValueError(f"mb must be >= 1, got {self.mb}")
        if self.max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {self.max_queue}")
        if self.retry_after_s < 0:
            raise ValueError("retry_after_s must be >= 0")

    def hint(self, queue_depth: int) -> float:
        """Retry-After for a rejection observed at ``queue_depth``: the
        base hint scaled by how far over capacity the queue is —
        deterministic (no jitter server-side; the CLIENT's RetryPolicy
        owns jitter, so synchronized clients still spread out)."""
        return self.retry_after_s * (1.0 + queue_depth / max(1, self.mb))


class _Request:
    """One admitted generation request: its sliding window, its budget,
    and its completion latch. State transitions happen on the engine
    thread; ``cancel`` may flip the flag from a connection thread — the
    engine observes it at the next pack/settle and frees the slot."""

    __slots__ = (
        "rid", "window", "n_new", "out", "deadline", "birth",
        "cancelled", "done", "status", "on_done",
        "trace_id", "span_id", "parent_span_id", "first_pack",
    )

    def __init__(self, rid, window, n_new, deadline, birth, on_done=None,
                 ctx: Optional[_telemetry.TraceContext] = None):
        self.rid = rid
        self.window = window  # np [L] int32, slides as tokens generate
        self.n_new = n_new
        self.out: List[int] = []
        self.deadline = deadline  # absolute clock() time, or None
        self.birth = birth
        self.cancelled = False
        self.done = threading.Event()
        self.status: Optional[str] = None  # "ok"|"deadline_expired"|"cancelled"
        self.on_done = on_done
        # request-scoped trace identity: the span the client minted for
        # THIS request (or a locally minted child) — the serve.request
        # root span records under these ids, and the latency exemplar
        # points at them
        self.trace_id = ctx.trace_id if ctx is not None else ""
        self.span_id = ctx.span_id if ctx is not None else ""
        self.parent_span_id = (
            ctx.parent_span_id if ctx is not None else None
        )
        self.first_pack: Optional[float] = None  # engine clock, first slot claim

    def result(self, timeout: Optional[float] = None) -> List[int]:
        """Block until the request settles; the generated tokens, or the
        loud failure (`DeadlineExpired` / `ServeRejected` on cancel)."""
        if not self.done.wait(timeout):
            raise TimeoutError(f"request {self.rid} still in flight")
        if self.status == "ok":
            return list(self.out)
        if self.status == "deadline_expired":
            raise DeadlineExpired(f"request {self.rid} missed its deadline")
        raise ServeRejected(f"request {self.rid} {self.status}")


#: Synthetic Chrome-trace lane base for per-request spans: concurrent
#: requests render as parallel tracks in Perfetto instead of overlapping
#: X events on the engine thread's track. Lanes recycle mod 512 — far
#: wider than any real in-flight set.
_REQUEST_LANE_BASE = 1 << 22


def _request_lane(rid: int) -> int:
    return _REQUEST_LANE_BASE + rid % 512


def _request_context(trace: Any) -> _telemetry.TraceContext:
    """The request's trace identity: the TraceContext the client stamped
    into the wire message (already a per-request child — ids propagate),
    or a locally minted child of this process's context for direct
    ``submit`` callers. A malformed wire payload degrades to the local
    child — tracing never rejects a request."""
    if isinstance(trace, _telemetry.TraceContext):
        return trace
    if isinstance(trace, dict):
        try:
            ctx = _telemetry.TraceContext.from_json(trace)
            if ctx.trace_id and ctx.span_id:
                return ctx
        except (TypeError, ValueError):
            pass
    return _telemetry.current_context().child("serve.request")


class ServingEngine:
    """The continuous-batching request multiplexer over one `LMStream`
    (``n_stages`` stages of the one-device schedule on ``device``).

    Thread model: any thread may ``submit``/``cancel``; exactly ONE
    thread (the engine loop, or a test calling ``step`` directly) drives
    the stream. Two queues feed the packer — ``_cont`` (requests whose
    previous step popped: they keep generating, priority) and ``_ready``
    (admitted, not yet started: the bounded admission queue) — so a
    finishing slot refills from ``_ready`` on the very next tick while
    in-progress requests never starve behind new arrivals."""

    def __init__(
        self,
        params,
        cfg,
        n_stages: int = 1,
        policy: Optional[ServePolicy] = None,
        metrics=METRICS,
        clock: Callable[[], float] = time.monotonic,
        device="cuda",
    ):
        self.cfg = cfg
        self.policy = policy or ServePolicy()
        self.stream = _lm.LMStream(params, cfg, n_stages, device=device)
        self._metrics = metrics
        self._clock = clock
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._ready: collections.deque = collections.deque()
        self._cont: collections.deque = collections.deque()
        self._packed = 0  # requests riding microbatches not yet popped
        self._draining = False
        self._stop = False
        self._next_rid = 0
        self._thread: Optional[threading.Thread] = None

    # -- admission -----------------------------------------------------------

    def submit(
        self,
        window,
        n_new: int,
        deadline_s: Optional[float] = None,
        on_done: Optional[Callable[["_Request"], None]] = None,
        trace: Any = None,
    ) -> _Request:
        """Admit one generation request (``window`` [L] int32, generate
        ``n_new`` tokens greedily) or refuse it LOUDLY: `ServeRejected`
        when the queue is at ``max_queue`` or the replica is draining
        (with a Retry-After hint), `DeadlineExpired` when the deadline is
        already unmeetable at admission. Never silently queues past
        either bound.

        ``trace`` is the request's trace identity — a TraceContext (or
        its ``to_json`` dict, as shipped over the wire by `ServeClient`);
        the ``serve.request`` root span and its children record under
        those ids, and a shed/expiry at admission lands a ``serve.shed``/
        ``serve.deadline_expired`` instant carrying the same trace id so
        a refused request is still attributable in the merged timeline."""
        window = np.asarray(window, dtype=np.int32)
        if window.shape != (self.cfg.max_len,):
            raise ValueError(
                f"window shape {window.shape} != ({self.cfg.max_len},)"
            )
        if n_new < 1:
            raise ValueError(f"n_new must be >= 1, got {n_new}")
        tracing = _telemetry.RECORDER.enabled
        ctx = _request_context(trace) if (tracing or trace is not None) else None
        now = self._clock()
        if deadline_s is None:
            deadline_s = self.policy.default_deadline_s
        deadline = None if deadline_s is None else now + deadline_s
        with self._cv:
            if self._draining or self._stop:
                if tracing:
                    _telemetry.record_instant(
                        "serve.shed", int(now * 1e9),
                        reason="draining",
                        trace_id=ctx.trace_id, span_id=ctx.span_id,
                    )
                raise ServeRejected(
                    "replica draining", self.policy.hint(len(self._ready))
                )
            if deadline is not None and deadline <= now:
                self._metrics.count("serve.deadline_expired")
                if tracing:
                    _telemetry.record_instant(
                        "serve.deadline_expired", int(now * 1e9),
                        at="admission",
                        trace_id=ctx.trace_id, span_id=ctx.span_id,
                    )
                raise DeadlineExpired("deadline expired at admission")
            if len(self._ready) >= self.policy.max_queue:
                self._metrics.count("serve.rejected")
                if tracing:
                    _telemetry.record_instant(
                        "serve.shed", int(now * 1e9),
                        reason="queue_full",
                        queue_depth=len(self._ready),
                        trace_id=ctx.trace_id, span_id=ctx.span_id,
                    )
                raise ServeRejected(
                    f"queue full ({self.policy.max_queue})",
                    self.policy.hint(len(self._ready)),
                )
            rid = self._next_rid
            self._next_rid += 1
            req = _Request(
                rid, window, int(n_new), deadline, now, on_done, ctx=ctx
            )
            self._ready.append(req)
            self._metrics.gauge("serve.queue_depth", float(len(self._ready)))
            self._cv.notify_all()
        return req

    def cancel(self, req: _Request) -> None:
        """Client-side abandonment (disconnect): the request's slot frees
        at the engine's next pack/settle without touching any other
        slot's bytes. Idempotent; completed requests are unaffected."""
        req.cancelled = True
        with self._cv:
            self._cv.notify_all()

    # -- completion paths (engine thread) ------------------------------------

    def _finish(self, req: _Request, status: str, now: float) -> None:
        req.status = status
        if status == "ok":
            self._metrics.count("serve.requests")
            exemplar = (
                (req.trace_id, req.span_id) if req.trace_id else None
            )
            self._metrics.observe(
                "serve.latency", now - req.birth, exemplar=exemplar
            )
            # the latency decomposition the bench probe reads: time spent
            # waiting for a slot vs time being served (first pack ->
            # completion). Both on the engine clock, both exemplar-tagged.
            if req.first_pack is not None:
                self._metrics.observe(
                    "serve.queue_wait", req.first_pack - req.birth,
                    exemplar=exemplar,
                )
                self._metrics.observe(
                    "serve.service", now - req.first_pack,
                    exemplar=exemplar,
                )
        elif status == "deadline_expired":
            self._metrics.count("serve.deadline_expired")
            if _telemetry.RECORDER.enabled and req.trace_id:
                _telemetry.record_instant(
                    "serve.deadline_expired", int(now * 1e9),
                    tid=_request_lane(req.rid), at="tick", rid=req.rid,
                    trace_id=req.trace_id, span_id=req.span_id,
                )
        if _telemetry.RECORDER.enabled and req.trace_id:
            # THE request root span: admission -> completion on the
            # engine's own (injectable) clock, so its duration equals the
            # serve.latency observation exactly. span_id is the id the
            # client minted — the client's spool and this replica's spool
            # merge into one causal timeline per request.
            _telemetry.record_span(
                "serve.request", int(req.birth * 1e9),
                int((now - req.birth) * 1e9),
                tid=_request_lane(req.rid),
                rid=req.rid, status=status, n_new=req.n_new,
                trace_id=req.trace_id, span_id=req.span_id,
                parent_span_id=req.parent_span_id,
            )
        req.done.set()
        if req.on_done is not None:
            try:
                req.on_done(req)
            except Exception:  # noqa: BLE001  # graftlint: swallow(counted serve.errors on the injected registry; a reply callback must never take the engine tick down)
                self._metrics.count("serve.errors")
                logger.exception(
                    "tfrecord.serving on_done callback failed (rid=%d)",
                    req.rid,
                )

    # -- the tick ------------------------------------------------------------

    def _pack(self, now: float) -> List[_Request]:
        """Pop up to ``mb`` schedulable requests (continuations first),
        enforcing deadlines and cancellations as slots are claimed — an
        expired or abandoned request never occupies a slot."""
        slots: List[_Request] = []
        with self._cv:
            for q in (self._cont, self._ready):
                while q and len(slots) < self.policy.mb:
                    req = q.popleft()
                    if req.cancelled:
                        self._finish(req, "cancelled", now)
                        continue
                    if req.deadline is not None and now > req.deadline:
                        self._finish(req, "deadline_expired", now)
                        continue
                    if req.first_pack is None:
                        req.first_pack = now
                        if _telemetry.RECORDER.enabled and req.trace_id:
                            # queue_wait closes the moment the request
                            # first claims a slot: admission -> first pack
                            _telemetry.record_span(
                                "serve.queue_wait", int(req.birth * 1e9),
                                int((now - req.birth) * 1e9),
                                tid=_request_lane(req.rid), rid=req.rid,
                                trace_id=req.trace_id,
                                parent_span_id=req.span_id,
                            )
                    slots.append(req)
            self._packed += len(slots)
            self._metrics.gauge("serve.queue_depth", float(len(self._ready)))
            self._metrics.gauge(
                "serve.in_flight", float(self._packed)
            )
        return slots

    def _settle(self, outs: List[Tuple[np.ndarray, Any]]) -> None:
        """Fold popped microbatches back into request state: one greedy
        token per valid slot, then finish or reschedule. Deadlines are
        re-checked HERE too — an in-flight request whose deadline passed
        while its microbatch was in the pipeline frees its slot now and
        is never served late."""
        for logits, tag in outs:
            if not tag:
                continue  # idle-advance microbatch: no valid slots
            now = self._clock()
            cont: List[_Request] = []
            for row, req in enumerate(tag):
                if req.cancelled:
                    self._finish(req, "cancelled", now)
                    continue
                if req.deadline is not None and now > req.deadline:
                    self._finish(req, "deadline_expired", now)
                    continue
                nxt = int(np.argmax(logits[row, -1]))
                req.out.append(nxt)
                if len(req.out) >= req.n_new:
                    self._finish(req, "ok", now)
                else:
                    req.window = np.concatenate(
                        [req.window[1:], [np.int32(nxt)]]
                    ).astype(np.int32)
                    cont.append(req)
            with self._cv:
                self._packed -= len(tag)
                self._cont.extend(cont)
                self._metrics.gauge(
                    "serve.in_flight", float(self._packed)
                )
                self._cv.notify_all()

    def step(self) -> int:
        """One scheduler tick: pack → push → settle. Returns the number
        of slots packed (0 with an idle-advance push still counts the
        in-flight work via the return of 1), or 0 when fully idle."""
        now = self._clock()
        slots = self._pack(now)
        if not slots:
            with self._cv:
                packed = self._packed
            if packed == 0:
                return 0
            # nothing schedulable but microbatches are in the pipeline:
            # advance one tick with an all-invalid microbatch (empty tag)
            # rather than draining — the no-drain half of continuous
            # batching: a continuation popping next tick gets its slot
            # back immediately
            tokens = _lm.pack_slots([], self.policy.mb, self.cfg.max_len)
            self._settle(self.stream.submit_tagged(tokens, ()))
            return 1
        tokens = _lm.pack_slots(
            [r.window for r in slots], self.policy.mb, self.cfg.max_len
        )
        self._metrics.count("serve.ticks")
        self._settle(self.stream.submit_tagged(tokens, tuple(slots)))
        if _telemetry.RECORDER.enabled:
            # one serve.tick slice per occupied slot, attributed to
            # slot + request id and parented under the request span —
            # the per-request timeline shows exactly which ticks (and
            # which slot) served it
            end = self._clock()
            t0_ns = int(now * 1e9)
            dur_ns = max(0, int((end - now) * 1e9))
            for row, req in enumerate(slots):
                if not req.trace_id:
                    continue
                _telemetry.record_span(
                    "serve.tick", t0_ns, dur_ns,
                    tid=_request_lane(req.rid),
                    slot=row, rid=req.rid,
                    trace_id=req.trace_id, parent_span_id=req.span_id,
                )
        return len(slots)

    def run_until_idle(self) -> None:
        """Drive ticks until no request is queued, continuing, or in
        flight — the synchronous mode tests and the bench probe use."""
        while self.step() > 0:
            pass

    # -- engine loop ---------------------------------------------------------

    def start(self) -> "ServingEngine":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, name="tfr-serving-engine", daemon=True
            )
            self._thread.start()
        return self

    def _run(self) -> None:
        while True:
            with self._cv:
                while (
                    not self._stop
                    and not self._ready
                    and not self._cont
                    and self._packed == 0
                ):
                    if self._draining:
                        self._stop = True
                        self._cv.notify_all()
                        break
                    self._cv.wait(0.05)
                if self._stop and not self._ready and not self._cont and not self._packed:
                    return
            try:
                self.step()
            except Exception:  # noqa: BLE001  # graftlint: swallow(counted serve.errors on the injected registry; a poisoned tick stops the loop loudly instead of spinning)
                self._metrics.count("serve.errors")
                logger.exception("tfrecord.serving engine tick failed")
                with self._cv:
                    self._stop = True
                    self._cv.notify_all()
                return

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Stop admitting, finish every in-flight and queued request,
        then stop the loop — the goodbye half of scale-down and of
        graceful signal shutdown. Returns True when fully drained."""
        with self._cv:
            self._draining = True
            self._cv.notify_all()
        if self._thread is None:
            self.run_until_idle()
            with self._cv:
                self._stop = True
            return True
        self._thread.join(timeout)
        return not self._thread.is_alive()

    def stop(self) -> None:
        """Hard stop: the loop exits after the current tick; queued
        requests are cancelled (their waiters unblock loudly)."""
        with self._cv:
            self._stop = True
            pending = list(self._cont) + list(self._ready)
            self._cont.clear()
            self._ready.clear()
            self._cv.notify_all()
        now = self._clock()
        for req in pending:
            self._finish(req, "cancelled", now)
        if self._thread is not None:
            self._thread.join(5.0)

    # -- introspection -------------------------------------------------------

    def report(self) -> Dict[str, Any]:
        """The status surface the server's ``status`` op reads: queue and
        in-flight depth, shed counters, per-request p50/p99 (ms), and the
        `telemetry.serving_verdict`."""
        with self._cv:
            queue_depth = len(self._ready)
            in_flight = self._packed + len(self._cont)
            draining = self._draining
        q = self._metrics.quantiles("serve.latency").get("serve.latency", {})
        p50 = q.get("p50_s")
        p99 = q.get("p99_s")
        p50_ms = None if p50 is None else p50 * 1e3
        p99_ms = None if p99 is None else p99 * 1e3
        qw = self._metrics.quantiles("serve.queue_wait").get(
            "serve.queue_wait", {}
        )
        sv = self._metrics.quantiles("serve.service").get("serve.service", {})
        qw99 = qw.get("p99_s")
        sv99 = sv.get("p99_s")
        return {
            "role": "serving",
            "draining": draining,
            "queue_depth": queue_depth,
            "in_flight": in_flight,
            "mb": self.policy.mb,
            "max_queue": self.policy.max_queue,
            "slo_p99_ms": self.policy.slo_p99_ms,
            "p50_ms": p50_ms,
            "p99_ms": p99_ms,
            "queue_wait_p99_ms": None if qw99 is None else qw99 * 1e3,
            "service_p99_ms": None if sv99 is None else sv99 * 1e3,
            "completed": q.get("count", 0),
            "counters": {
                name: self._metrics.counter(name)
                for name in (
                    "serve.requests",
                    "serve.rejected",
                    "serve.deadline_expired",
                    "serve.disconnects",
                )
            },
            "verdict": _telemetry.serving_verdict(
                p99_ms, queue_depth, self.policy.slo_p99_ms,
                max_queue=self.policy.max_queue,
            ),
        }


def sequential_reference(
    params, cfg, n_stages: int, requests: Sequence[Tuple[Any, int]],
    mb: int, device="cuda",
) -> List[List[int]]:
    """Each ``(window, n_new)`` run SOLO — one request per microbatch,
    flushed to completion before the next — through the same pack/argmax/
    slide loop the engine runs. THE parity oracle: N concurrent clients
    through one server must produce exactly these bytes (the per-slot
    isolation pin makes slot position and neighbors irrelevant)."""
    stream = _lm.LMStream(params, cfg, n_stages, device=device)
    results: List[List[int]] = []
    for window, n_new in requests:
        w = np.asarray(window, dtype=np.int32)
        toks: List[int] = []
        for _ in range(int(n_new)):
            outs = stream.submit_tagged(_lm.pack_slots([w], mb, cfg.max_len))
            outs += stream.flush_tagged()
            logits = outs[-1][0]
            nxt = int(np.argmax(logits[0, -1]))
            toks.append(nxt)
            w = np.concatenate([w[1:], [np.int32(nxt)]]).astype(np.int32)
        results.append(toks)
    return results


# ---------------------------------------------------------------------------
# Socket tier
# ---------------------------------------------------------------------------


def _shut(sock: socket.socket) -> None:
    """Shut a socket down, then close it: the shutdown wakes a thread
    blocked in its accept or recv (a bare close does not on Linux, and the
    peer would see the close only when that call times out)."""
    try:
        sock.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass  # never connected, or already closed
    try:
        sock.close()
    except OSError:
        pass


class _Hangup:
    """The socket a chaos rule closes: ``close`` shuts it down first, so an
    injected disconnect reaches the peer at once, as a real hangup does."""

    __slots__ = ("_sock",)

    def __init__(self, sock: socket.socket):
        self._sock = sock

    def close(self) -> None:
        _shut(self._sock)


class _Conn:
    """One accepted client connection: a bounded outbound queue drained
    by a dedicated writer thread, so one slow or dead client can only
    ever block ITSELF. Replies outrunning a stuck client past
    ``max_outbound`` drop the connection (counted as a disconnect) —
    bounded memory beats an unbounded buffer for a client that stopped
    reading."""

    def __init__(self, sock: socket.socket, peer: str, max_outbound: int):
        self.sock = sock
        self.peer = peer
        self.max_outbound = max_outbound
        self.outbound: collections.deque = collections.deque()
        self.cv = threading.Condition()
        self.closed = False
        self.live: Dict[int, _Request] = {}  # client req id -> engine request

    def enqueue(self, msg: Dict[str, Any]) -> None:
        with self.cv:
            if self.closed:
                return
            if len(self.outbound) >= self.max_outbound:
                self.closed = True
                self.cv.notify_all()
                return
            self.outbound.append(msg)
            self.cv.notify_all()

    def finish(self) -> None:
        """Stop taking replies; the writer sends what is queued (a drain
        request's own reply among them), then closes the connection."""
        with self.cv:
            self.closed = True
            self.cv.notify_all()

    def close(self) -> None:
        self.finish()
        _shut(self.sock)


class ServeServer:
    """The serving replica: accepts connections on the service wire
    protocol and multiplexes their generation requests through one
    :class:`ServingEngine`.

    Ops: ``generate`` (tokens window + n_new + optional deadline_s),
    ``status`` (the engine report), ``drain`` (stop admitting,
    finish in-flight, goodbye), ``ping``. Chaos: the plan passed here (or
    installed via ``faults.install_chaos``) is consulted at every
    ``recv:<peer>`` and ``reply:<peer>`` seam — ``slow_client`` stalls
    one writer, ``client_disconnect`` drops one connection; either way
    the engine tick never blocks and neighbors' bytes never change."""

    def __init__(
        self,
        engine: ServingEngine,
        host: str = "127.0.0.1",
        port: int = 0,
        fault_plan: Optional[_faults.FaultPlan] = None,
        max_outbound: int = 256,
        timeout_s: float = 30.0,
    ):
        self.engine = engine
        self._plan = fault_plan
        self._max_outbound = max_outbound
        self._timeout_s = timeout_s
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, int(port)))
        self._sock.listen(64)
        self.addr = sp.format_addr(host, self._sock.getsockname()[1])
        self._conns: List[_Conn] = []
        self._writers: List[threading.Thread] = []
        self._lock = threading.Lock()
        self._stopping = threading.Event()
        self.drained = threading.Event()
        self._accept_thread: Optional[threading.Thread] = None

    def _chaos(self) -> Optional[_faults.FaultPlan]:
        return self._plan if self._plan is not None else _faults._SERVE_CHAOS

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "ServeServer":
        self.engine.start()
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="tfr-serving-accept", daemon=True
        )
        self._accept_thread.start()
        logger.info("tfrecord.serving replica listening on %s", self.addr)
        return self

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Stop admitting, finish every in-flight request, then stop —
        scale-down's goodbye and the SIGTERM path. Idempotent."""
        ok = self.engine.drain(timeout)
        self.stop()
        if ok:
            self.drained.set()
        return ok

    def stop(self) -> None:
        if self._stopping.is_set():
            return
        self._stopping.set()
        _shut(self._sock)  # wakes the accept loop
        with self._lock:
            conns = list(self._conns)
        for conn in conns:
            conn.finish()
        self.engine.stop()

    def flush(self, timeout: Optional[float] = None) -> None:
        """Wait, after ``stop``, until every connection's writer has sent
        what it queued (a drain request's own reply among them): the
        writers are daemon threads, and a process that exits before they
        run drops the reply."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._lock:
            writers = list(self._writers)
        for t in writers:
            t.join(None if deadline is None else max(0.0, deadline - time.monotonic()))

    # -- accept / per-connection ---------------------------------------------

    def _accept_loop(self) -> None:
        while not self._stopping.is_set():
            try:
                sock, peer = self._sock.accept()
            except OSError:
                return  # listener closed: shutdown
            sp.enable_nodelay(sock)
            sock.settimeout(self._timeout_s)
            conn = _Conn(
                sock, sp.format_addr(peer[0], peer[1]), self._max_outbound
            )
            with self._lock:
                self._conns.append(conn)
            threading.Thread(
                target=self._read_loop, args=(conn,),
                name=f"tfr-serving-read-{conn.peer}", daemon=True,
            ).start()
            writer = threading.Thread(
                target=self._write_loop, args=(conn,),
                name=f"tfr-serving-write-{conn.peer}", daemon=True,
            )
            writer.start()
            with self._lock:
                self._writers = [t for t in self._writers if t.is_alive()] + [writer]

    def _drop(self, conn: _Conn) -> None:
        """Connection teardown: cancel the client's live requests (their
        slots free at the engine's next tick) and count the mid-request
        loss once."""
        with conn.cv:
            live = list(conn.live.values())
            conn.live.clear()
        if live and any(not r.done.is_set() for r in live):
            self.engine._metrics.count("serve.disconnects")
        for req in live:
            self.engine.cancel(req)
        conn.close()
        with self._lock:
            if conn in self._conns:
                self._conns.remove(conn)

    def _read_loop(self, conn: _Conn) -> None:
        try:
            while not conn.closed:
                plan = self._chaos()
                if plan is not None:
                    plan.apply_serve(f"recv:{conn.peer}", sock=_Hangup(conn.sock))
                msg = sp.recv_msg(conn.sock, conn.peer, allow_eof=True)
                if msg is None:
                    break
                self._handle(conn, msg)
        except (OSError, ConnectionError):
            pass
        finally:
            if not conn.closed:
                self._drop(conn)
            # else the connection is finishing: its writer sends what is
            # queued (a drain's reply) and then drops it; closing the
            # socket here would lose that reply

    def _write_loop(self, conn: _Conn) -> None:
        try:
            while True:
                with conn.cv:
                    while not conn.outbound and not conn.closed:
                        conn.cv.wait(0.5)
                    if conn.closed and not conn.outbound:
                        return
                    msg = conn.outbound.popleft()
                plan = self._chaos()
                if plan is not None:
                    # the slow/dead-client seam: a slow_client stall here
                    # blocks only THIS writer thread; client_disconnect
                    # closes the socket and unwinds to _drop
                    plan.apply_serve(f"reply:{conn.peer}", sock=_Hangup(conn.sock))
                sp.send_msg(conn.sock, msg)
        except (OSError, ConnectionError):
            pass
        finally:
            self._drop(conn)

    # -- request handling ----------------------------------------------------

    def _handle(self, conn: _Conn, msg: Dict[str, Any]) -> None:
        ver = msg.get("v", sp.PROTO_VERSION)
        if ver != sp.PROTO_VERSION:
            conn.enqueue({
                "ok": False, "error": "version_skew",
                "v": sp.PROTO_VERSION, "req": msg.get("req"),
            })
            return
        op = msg.get("op")
        if op == "ping":
            conn.enqueue({"ok": True, "req": msg.get("req")})
        elif op == "status":
            rep = dict(self.engine.report(), addr=self.addr, pid=os.getpid())
            conn.enqueue(dict(rep, ok=True, req=msg.get("req")))
        elif op == "drain":
            conn.enqueue({"ok": True, "draining": True, "req": msg.get("req")})
            threading.Thread(
                target=self.drain, name="tfr-serving-drain", daemon=True
            ).start()
        elif op == "generate":
            self._generate(conn, msg)
        else:
            conn.enqueue({
                "ok": False, "error": f"unknown op {op!r}",
                "req": msg.get("req"),
            })

    def _generate(self, conn: _Conn, msg: Dict[str, Any]) -> None:
        cid = msg.get("req")

        def on_done(req: _Request) -> None:
            with conn.cv:
                conn.live.pop(cid, None)
            if req.status == "ok":
                conn.enqueue({"ok": True, "req": cid, "tokens": req.out})
            elif req.status == "deadline_expired":
                conn.enqueue({
                    "ok": False, "req": cid, "error": "deadline_expired",
                })
            # cancelled: the connection is gone — nothing to send

        try:
            req = self.engine.submit(
                np.asarray(msg["tokens"], dtype=np.int32),
                int(msg["n_new"]),
                deadline_s=msg.get("deadline_s"),
                on_done=on_done,
                trace=msg.get("trace"),
            )
        except ServeRejected as e:
            conn.enqueue({
                "ok": False, "req": cid, "error": "overloaded",
                "retry_after_s": e.retry_after_s,
            })
            return
        except DeadlineExpired:
            conn.enqueue({
                "ok": False, "req": cid, "error": "deadline_expired",
            })
            return
        except (KeyError, ValueError, TypeError) as e:
            conn.enqueue({"ok": False, "req": cid, "error": f"bad request: {e}"})
            return
        with conn.cv:
            conn.live[cid] = req


class ServeClient:
    """Replica-walking client on the service wire protocol, speaking the
    `retry.py` vocabulary: an "overloaded" reply backs off with the
    server's Retry-After hint as the FLOOR under the policy's capped
    exponential (full jitter client-side — synchronized rejects don't
    re-arrive in lockstep); a dead replica (connection error) rotates to
    the next address, which is how a SIGKILLed replica's queue drains
    through the survivor."""

    def __init__(
        self,
        addrs: Sequence[str],
        policy: Optional[_retry.RetryPolicy] = None,
        timeout_s: float = 30.0,
    ):
        if not addrs:
            raise ValueError("ServeClient needs at least one replica addr")
        self._addrs = list(addrs)
        self._i = 0
        self._sock: Optional[socket.socket] = None
        self._timeout_s = timeout_s
        self.policy = policy or _retry.RetryPolicy(
            max_retries=8, base_delay=0.05, max_delay=2.0
        )
        self._next_req = 0

    @property
    def addr(self) -> str:
        return self._addrs[self._i % len(self._addrs)]

    def _rotate(self) -> None:
        self._close()
        self._i += 1

    def _close(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def _connected(self) -> socket.socket:
        if self._sock is None:
            self._sock = sp.connect(self.addr, timeout=self._timeout_s)
        return self._sock

    def _request(self, obj: Dict[str, Any]) -> Dict[str, Any]:
        """One round trip with rotation on connection failure — every
        replica tried once per attempt before the attempt is charged."""
        attempt, start = 0, self.policy.clock()
        while True:
            for _ in range(len(self._addrs)):
                try:
                    return sp.request(self._connected(), self.addr, obj)
                except (OSError, ConnectionError):
                    self._rotate()
            attempt += 1
            if not self.policy.pause(attempt, start):
                raise ConnectionError(
                    f"no serving replica reachable ({self._addrs})"
                )

    def generate(
        self,
        window,
        n_new: int,
        deadline_s: Optional[float] = None,
    ) -> List[int]:
        """One generation request, retried through overload sheds and
        replica deaths under the client's RetryPolicy budget. Raises
        `DeadlineExpired` (not retriable — late is late), `ServeRejected`
        when the budget exhausts against a saturated fleet."""
        self._next_req += 1
        # one per-request trace child rides the wire: the replica records
        # its serve.request root span under THIS span id (parented to the
        # client's process root), so client + replica spools merge into
        # one causal timeline per request. Extra message keys are
        # protocol-legal; an old server ignores it.
        ctx = _telemetry.current_context().child("serve.request")
        obj = {
            "v": sp.PROTO_VERSION,
            "op": "generate",
            "req": self._next_req,
            "tokens": np.asarray(window, dtype=np.int32).tolist(),
            "n_new": int(n_new),
            "deadline_s": deadline_s,
            "trace": ctx.to_json(),
        }
        attempt, start = 0, self.policy.clock()
        while True:
            rep = self._request(obj)
            if rep.get("ok"):
                return [int(t) for t in rep["tokens"]]
            err = rep.get("error")
            if err == "deadline_expired":
                raise DeadlineExpired("server reported deadline_expired")
            if err in ("overloaded", "draining"):
                hint = float(rep.get("retry_after_s", 0.0))
                if err == "draining":
                    self._rotate()  # this replica is saying goodbye
                attempt += 1
                if not self.policy.pause(attempt, start):
                    raise ServeRejected(
                        f"rejected after {attempt} attempts: {err}", hint
                    )
                if hint > 0:
                    # the Retry-After floor under the policy's jittered
                    # backoff (pause already slept the jittered part)
                    self.policy.sleep(hint)
                continue
            raise sp.ProtocolError(f"serving replica error: {rep!r}")

    def status(self) -> Dict[str, Any]:
        self._next_req += 1
        return self._request(
            {"v": sp.PROTO_VERSION, "op": "status", "req": self._next_req}
        )

    def drain(self) -> Dict[str, Any]:
        self._next_req += 1
        return self._request(
            {"v": sp.PROTO_VERSION, "op": "drain", "req": self._next_req}
        )

    def close(self) -> None:
        self._close()


# ---------------------------------------------------------------------------
# Process harness: signals, CLI
# ---------------------------------------------------------------------------


def run_server(
    server: ServeServer,
    spool_dir: Optional[str] = None,
    role: str = "serving",
    install_signals: bool = True,
    ready_fh=None,
    trace_out: Optional[str] = None,
) -> int:
    """Run a started server to completion: optionally announce readiness
    (one JSON line: addr + pid), and on SIGTERM/SIGINT drain gracefully —
    stop admitting, finish in-flight requests — then return 0. The drain
    request takes the same exit path. ``trace_out`` turns the flight
    recorder on for the process lifetime and saves the replica's Chrome
    trace (per-request ``serve.request`` timelines) there on exit.
    ``spool_dir`` lands the replica's telemetry on the fleet spool under
    ``role``; the drain's exit path writes its ``final: true`` snapshot."""
    if trace_out:
        _telemetry.current_context()  # adopt an identity for the track label
        _telemetry.enable()
    spool = None
    if spool_dir:
        spool = _fleet.acquire_spool(spool_dir, role=role, interval_s=0.2)
    stop = threading.Event()

    if install_signals:
        def _on_signal(signum, frame):
            logger.info(
                "tfrecord.serving got signal %d: draining", signum
            )
            threading.Thread(
                target=server.drain, name="tfr-serving-sigdrain", daemon=True
            ).start()
            stop.set()

        signal.signal(signal.SIGTERM, _on_signal)
        signal.signal(signal.SIGINT, _on_signal)

    if ready_fh is not None:
        ready_fh.write(
            json.dumps({"addr": server.addr, "pid": os.getpid()}) + "\n"
        )
        ready_fh.flush()
    try:
        while not server.drained.wait(0.1):
            if server._stopping.is_set():
                break
        # the drain already finished every admitted request; the writer
        # threads send the final replies before teardown
        server.stop()
        server.flush(server._timeout_s)
    finally:
        if spool is not None:
            _fleet.release_spool(spool_dir)
        if trace_out:
            try:
                _telemetry.RECORDER.save_chrome_trace(trace_out)
            except OSError:
                logger.exception(
                    "tfrecord.serving could not save trace to %s", trace_out
                )
            _telemetry.disable()
    return 0


def _build_synthetic(args) -> Tuple[Any, Any]:
    """A tiny seeded LM for subprocess scenarios: the weights are drawn on
    the CPU from ``args.seed`` whatever the serving device, so a client
    with the same seed computes the exact sequential reference locally."""
    cfg = _lm.LMConfig(
        vocab_size=args.vocab, d_model=args.d_model, n_heads=args.heads,
        n_layers=args.layers, max_len=args.max_len,
        n_virtual=args.virtual,
    )
    params = _lm.init_params(cfg, torch.Generator().manual_seed(args.seed), "cpu")
    return params, cfg


def _deterministic(device) -> None:
    """On the card: deterministic kernels (cuBLAS workspace ``:4096:8``),
    so a request's tokens do not depend on the run."""
    if torch.device(device).type == "cuda":
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        torch.use_deterministic_algorithms(True)


def main(argv: Optional[Sequence[str]] = None) -> int:
    """``python -m tpu_tfrecord_torch.serving`` — a synthetic-model serving
    replica for chaos scenarios. Prints one ready line (JSON: addr, pid)
    on stdout, serves until drained (drain RPC or SIGTERM/SIGINT), exits
    0."""
    p = argparse.ArgumentParser(prog="tpu_tfrecord_torch.serving", description=main.__doc__)
    p.add_argument("--device", default="cuda")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=0)
    p.add_argument("--mb", type=int, default=4)
    p.add_argument("--max-queue", type=int, default=16)
    p.add_argument("--default-deadline-s", type=float, default=None)
    p.add_argument("--slo-p99-ms", type=float, default=250.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--stages", type=int, default=2,
                   help="stages of the pipeline schedule, all on --device")
    p.add_argument("--virtual", type=int, default=1)
    p.add_argument("--layers", type=int, default=4)
    p.add_argument("--d-model", type=int, default=32)
    p.add_argument("--heads", type=int, default=2)
    p.add_argument("--vocab", type=int, default=96)
    p.add_argument("--max-len", type=int, default=16)
    p.add_argument("--spool-dir", default=None)
    p.add_argument("--role", default="serving")
    p.add_argument("--fault-plan", default=None,
                   help="path to a FaultPlan JSON (op='serve' rules)")
    p.add_argument("--trace-out", default=None, metavar="FILE",
                   help="record per-request spans and save the Chrome "
                   "trace here on exit (merge-trace fuses it with client "
                   "traces)")
    args = p.parse_args(argv)
    _deterministic(args.device)

    params, cfg = _build_synthetic(args)
    policy = ServePolicy(
        mb=args.mb, max_queue=args.max_queue,
        default_deadline_s=args.default_deadline_s,
        slo_p99_ms=args.slo_p99_ms,
    )
    plan = None
    if args.fault_plan:
        with open(args.fault_plan, "r", encoding="utf-8") as fh:
            plan = _faults.FaultPlan.from_json(fh.read())
    engine = ServingEngine(params, cfg, args.stages, policy=policy, device=args.device)
    server = ServeServer(
        engine, host=args.host, port=args.port, fault_plan=plan
    ).start()
    return run_server(
        server, spool_dir=args.spool_dir, role=args.role,
        ready_fh=sys.stdout, trace_out=args.trace_out,
    )


if __name__ == "__main__":
    raise SystemExit(main())
