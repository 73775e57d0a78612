"""Pipeline schedule on one device: port of ``tpu_tfrecord/models/pipeline.py``.

The JAX package runs S stages over a mesh axis: each device holds one
stage's weights, activations hop device s -> s+1 by ``ppermute`` every
tick, and with ``n_virtual=V`` > 1 each device owns V round-robin chunks
of the layer sequence (virtual stage k = v·S + s runs on device s). Here
the pipe axis is a tensor dimension of one device:

- stage weights stay stacked ``[S, ...]`` (``[S, V, ...]`` interleaved);
- the activation ring is an ``[S, mb, ...]`` tensor; every tick applies
  lane s's chunk (``_schedule_decode(t - s, s, S, V)``) to the feed when
  the lane is virtual stage 0 and to ``act[s]`` otherwise, and the ring's
  ``ppermute`` becomes a roll of the lanes by one;
- microbatch m enters stage 0 at tick ``inj(m) = (m // S)·S·V + m mod S``
  and its output leaves lane S-1 at tick ``inj(m) + S·V - 1``.

That is the JAX schedule tick for tick. ``pipeline_apply`` (the batch
path) and ``PipelineStream`` (the serving path) run the same tick function
(``_tick``), which calls ``stage_fn`` once per lane on ``[mb, ...]``
tensors, so a streamed output equals the batch output on the same slices
bitwise, on the card as on the CPU. S = 1 is the one-card deployment;
S > 1 runs the same schedule on one device (the port has gloo process
groups, but does not place stages on several cards yet).

``pipeline_reference`` is the sequential oracle. The schedule is plain
torch ops, so autograd runs through it: the LM's pipe mode trains through
``pipeline_apply`` (``models.lm``). ``pipeline_apply(diagnostics=True)``
also returns the bubble the schedule paid, counted tick by tick with the
JAX occupancy predicate, as host numbers. Left out because they have no
meaning without a mesh: ``microbatch_sharding``, ``pipe_axis``,
``batch_spec`` and ``param_spec`` (the feed and out rings exist only to
move microbatches between devices), ``PipelineStream.step_spec`` and the
HLO contracts.
"""

from __future__ import annotations

import collections
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import torch

from tpu_tfrecord_torch.checkpoint import tree_flatten, tree_unflatten

StageFn = Callable[[Any, torch.Tensor], torch.Tensor]


def _tree_map(fn, tree):
    leaves, treedef = tree_flatten(tree)
    return tree_unflatten(treedef, [fn(a) for a in leaves])


def _stage_count(stage_params: Any, n_virtual: int) -> int:
    leaves = tree_flatten(stage_params)[0]
    if not leaves:
        raise ValueError("stage_params has no leaves")
    bad = [tuple(l.shape) for l in leaves if l.ndim < 2 or l.shape[1] != n_virtual]
    if n_virtual > 1 and bad:
        raise ValueError(
            f"n_virtual={n_virtual} needs stage_params leaves stacked "
            f"[S, V, ...]; offending leaf shapes: {bad}"
        )
    n_stages = leaves[0].shape[0]
    if any(l.shape[0] != n_stages for l in leaves):
        raise ValueError(
            f"stage_params leaves must stack the same stage count on the leading "
            f"dim; leaf shapes: {[tuple(l.shape) for l in leaves]}"
        )
    return n_stages


def pipeline_reference(stage_fn: StageFn, stage_params: Any, xs: torch.Tensor,
                       n_virtual: int = 1) -> torch.Tensor:
    """Sequential oracle: fold every microbatch through all S·V virtual
    stages in interleaved order (virtual stage k = v·S + s runs chunk v of
    stage s). xs: [M, mb, ...]."""
    n_stages = _stage_count(stage_params, n_virtual)
    chunks = _chunk_table(stage_params, n_stages, n_virtual)
    outs = []
    for x in xs:
        for v in range(n_virtual):
            for s in range(n_stages):
                x = stage_fn(chunks[s][v], x)
        outs.append(x)
    return torch.stack(outs)


def _chunk_params(params, v_idx: Optional[int], n_virtual: int):
    """Chunk ``v_idx`` of one stage's [V, ...] stack (the stack itself for
    the classic V = 1 schedule)."""
    if n_virtual == 1:
        return params
    return _tree_map(lambda a: a[v_idx], params)


def _chunk_table(stage_params, n_stages: int, n_virtual: int) -> List[list]:
    """``table[s][v]``: the chunk lane s applies when the schedule decodes
    to virtual chunk v; indexed once, so a tick does no tree work."""
    table = []
    for s in range(n_stages):
        lane = _tree_map(lambda a: a[s], stage_params)  # noqa: B023
        table.append([_chunk_params(lane, v, n_virtual) for v in range(n_virtual)])
    return table


def _schedule_decode(u: int, s: int, n_stages: int, n_virtual: int):
    """(v_idx, chunk0, last_chunk) for lane s at its local step u = t - s:
    which virtual chunk the lane applies, whether it is virtual stage 0
    (eats the feed) and whether it is the last virtual stage (births an
    output). Shared by the batch path and the stream."""
    if n_virtual == 1:
        return None, s == 0, s == n_stages - 1
    v_idx = (max(u, 0) // n_stages) % n_virtual
    return v_idx, s == 0 and v_idx == 0, s == n_stages - 1 and v_idx == n_virtual - 1


def _tick(stage_fn: StageFn, chunks, t: int, act: torch.Tensor, x: torch.Tensor,
          n_stages: int, n_virtual: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """One schedule tick over the S lanes: lane s applies its decoded chunk
    to ``x`` (virtual stage 0) or to ``act[s]``, one ``stage_fn`` call of
    shape [mb, ...] per lane. Returns (the next activation ring, rolled one
    lane forward, and lane S-1's output)."""
    outs = []
    for s in range(n_stages):
        v_idx, chunk0, _ = _schedule_decode(t - s, s, n_stages, n_virtual)
        outs.append(stage_fn(chunks[s][v_idx or 0], x if chunk0 else act[s]))
    out = torch.stack(outs)
    return out.roll(1, 0), outs[-1]


def _m_of(u: int, n_stages: int, n_virtual: int) -> int:
    """The microbatch of a lane's local step u = r·V·S + v·S + i (m = r·S +
    i); negative for a step before the lane's first."""
    if n_virtual == 1:
        return u
    vs = n_stages * n_virtual
    return (u // vs) * n_stages + max(u, 0) % n_stages


def _bubble(n_micro: int, n_stages: int, n_virtual: int, t_end: int) -> Dict[str, float]:
    """The JAX schedule's occupancy count over ``t_end`` ticks: a lane's
    tick is useful when its local step u = t - s is a real microbatch's
    (u >= 0 and m(u) < n_micro). Every lane counts the same, so lane 0
    stands for all. Host numbers: reading them costs the step nothing."""
    useful = sum(1 for u in range(t_end) if _m_of(u, n_stages, n_virtual) < n_micro)
    diag = {
        "bubble_fraction": (t_end - useful) / t_end,
        "useful_ticks": float(useful),
        "total_ticks": float(t_end),
    }
    if n_virtual > 1:
        diag["virtual_stages"] = float(n_virtual)
    return diag


def pipeline_apply(stage_fn: StageFn, stage_params: Any, xs: torch.Tensor,
                   n_virtual: int = 1, diagnostics: bool = False
                   ) -> Union[torch.Tensor, Tuple[torch.Tensor, Dict[str, float]]]:
    """Run M microbatches through the S·V virtual stages on the pipeline
    schedule. stage_params: leaves stacked [S, ...] (or [S, V, ...] with
    ``n_virtual`` = V > 1); every stage maps [mb, ...] -> [mb, ...].
    xs: [M, mb, ...]; returns [M, mb, ...], the sequential composition
    (``pipeline_reference``) and bitwise what ``PipelineStream`` pops for
    the same slices.

    The loop runs through the birth tick of the last microbatch's last
    chunk: inj(M-1) + S·V - 1. Microbatch m enters at inj(m); a tick whose
    lane-0 slot is not an injection (the gap ticks between rounds when
    V > 1, the drain) feeds zeros, whose outputs nothing collects.

    ``diagnostics`` returns (out, diag): ``bubble_fraction`` (idle lane
    ticks over all, (S-1)/(M+S-1) for V = 1 and (S-1)/(V·M+S-1)
    interleaved), ``useful_ticks``, ``total_ticks`` and, with V > 1,
    ``virtual_stages``, as Python floats."""
    if n_virtual < 1:
        raise ValueError(f"n_virtual must be >= 1, got {n_virtual}")
    n_stages = _stage_count(stage_params, n_virtual)
    chunks = _chunk_table(stage_params, n_stages, n_virtual)
    n_micro = xs.shape[0]
    vs = n_stages * n_virtual
    mb_shape = tuple(xs.shape[1:])
    zero = torch.zeros(mb_shape, dtype=xs.dtype, device=xs.device)
    act = torch.zeros((n_stages,) + mb_shape, dtype=xs.dtype, device=xs.device)
    r_last, i_last = divmod(n_micro - 1, n_stages)
    t_end = r_last * vs + (n_virtual - 1) * n_stages + i_last + n_stages
    outs: List[Optional[torch.Tensor]] = [None] * n_micro
    for t in range(t_end):
        in_round = t % vs
        m_inj = (t // vs) * n_stages + in_round
        x = xs[m_inj] if in_round < n_stages and m_inj < n_micro else zero
        act, out = _tick(stage_fn, chunks, t, act, x, n_stages, n_virtual)
        # lane S-1 finished local step u_o; it is a birth when that step's
        # chunk is the last one (u_o mod S·V >= (V-1)·S)
        u_o = t - (n_stages - 1)
        if u_o >= 0 and u_o % vs >= vs - n_stages:
            m = (u_o // vs) * n_stages + u_o % n_stages
            if m < n_micro:
                outs[m] = out
    out = torch.stack(outs)
    if not diagnostics:
        return out
    return out, _bubble(n_micro, n_stages, n_virtual, t_end)


class PipelineStream:
    """Microbatch-streamed inference over the pipelined stages: the
    serving mode.

    Each ``push`` feeds exactly one [mb, ...] slice and advances the
    schedule to that microbatch's injection tick; outputs pop in FIFO order
    with the pipeline's latency (S·V ticks). ``flush`` drains the tail.
    After a flush the next push re-bases onto the first injection slot the
    clock has not passed. The stream is locked to the first microbatch's
    shape and dtype (one schedule, one shape). Stage weights and schedule
    are ``pipeline_apply``'s, and streamed outputs equal the batch path on
    the same slices bitwise.

    Every tensor lives on ``device`` (the stage weights' device when
    None); popped outputs stay there, for the caller to move."""

    def __init__(self, stage_fn: StageFn, stage_params: Any, n_virtual: int = 1,
                 microbatch_shape: Optional[Tuple[int, ...]] = None,
                 dtype: torch.dtype = torch.float32, device=None):
        if n_virtual < 1:
            raise ValueError(f"n_virtual must be >= 1, got {n_virtual}")
        self._n_stages = _stage_count(stage_params, n_virtual)
        self._n_virtual = n_virtual
        self._vs = self._n_stages * n_virtual
        self._stage_fn = stage_fn
        self._chunks = _chunk_table(stage_params, self._n_stages, n_virtual)
        self._device = torch.device(device) if device is not None else \
            tree_flatten(stage_params)[0][0].device
        self._dtype = dtype
        self._mb_shape: Optional[Tuple[int, ...]] = (
            tuple(microbatch_shape) if microbatch_shape is not None else None
        )
        self.served = 0  # microbatches whose outputs have been returned
        self.reset()

    # -- state ---------------------------------------------------------------

    def reset(self) -> None:
        """Forget every in-flight microbatch and restart at tick 0."""
        self._t = 0
        self._m = 0
        self._pending: collections.deque = collections.deque()
        self._act: Optional[torch.Tensor] = None
        self._zeros: Optional[torch.Tensor] = None
        if self._mb_shape is not None:
            self._ensure_state(self._mb_shape, self._dtype)

    def _ensure_state(self, mb_shape, dtype) -> None:
        if self._act is not None:
            if tuple(mb_shape) != self._mb_shape or dtype != self._dtype:
                raise ValueError(
                    f"microbatch {tuple(mb_shape)}/{dtype} != the stream's "
                    f"{self._mb_shape}/{self._dtype} (one schedule, one shape, one dtype)"
                )
            return
        self._mb_shape = tuple(mb_shape)
        self._dtype = dtype
        self._act = torch.zeros((self._n_stages,) + self._mb_shape, dtype=dtype,
                                device=self._device)
        self._zeros = torch.zeros(self._mb_shape, dtype=dtype, device=self._device)

    # -- schedule ------------------------------------------------------------

    def _inj(self, m: int) -> int:
        return (m // self._n_stages) * self._vs + m % self._n_stages

    def _advance(self, x: torch.Tensor, ready: list) -> None:
        head = self._pending[0][1] if self._pending else None
        self._act, out = _tick(self._stage_fn, self._chunks, self._t, self._act, x,
                               self._n_stages, self._n_virtual)
        if head is not None and self._t == head:
            # this tick finished the oldest in-flight microbatch's last chunk
            _, _, tag = self._pending.popleft()
            ready.append((out, tag))
            self.served += 1
        self._t += 1

    def push(self, x) -> List[torch.Tensor]:
        """Inject one [mb, ...] microbatch; returns the outputs (FIFO) that
        completed on the way: one a push once the pipeline is full, none
        during warm-up."""
        return [out for out, _ in self.push_tagged(x)]

    def push_tagged(self, x, tag: Any = None) -> List[Tuple[torch.Tensor, Any]]:
        """``push`` carrying an opaque host-side ``tag`` on the
        microbatch's FIFO entry; returns ``(output, tag)`` pairs, so a
        multiplexer can map popped outputs back to the requests packed into
        each slot."""
        x = torch.as_tensor(x, device=self._device)
        self._ensure_state(x.shape, x.dtype)
        # the next injection slot the clock has not passed: a flush advances
        # the clock, and skipped slots compute garbage nothing collects
        m = self._m
        while self._inj(m) < self._t:
            m += 1
        inj = self._inj(m)
        self._pending.append((m, inj + self._vs - 1, tag))  # birth tick
        self._m = m + 1
        ready: List[Tuple[torch.Tensor, Any]] = []
        while self._t < inj:
            self._advance(self._zeros, ready)  # gap ticks between rounds
        self._advance(x, ready)                # the injection tick
        return ready

    def flush(self) -> List[torch.Tensor]:
        """Drain: run ticks with a zero feed until every pushed
        microbatch's output has popped; returns them FIFO."""
        return [out for out, _ in self.flush_tagged()]

    def flush_tagged(self) -> List[Tuple[torch.Tensor, Any]]:
        """``flush`` returning ``(output, tag)`` pairs."""
        ready: List[Tuple[torch.Tensor, Any]] = []
        while self._pending:
            self._advance(self._zeros, ready)
        return ready

    @property
    def in_flight(self) -> int:
        return len(self._pending)
