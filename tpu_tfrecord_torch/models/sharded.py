"""Tensor-parallel communication over the named axes of a ``DeviceMesh``.

Under ``jit`` with sharded inputs, GSPMD inserts the collectives of a
sharded model itself. The port writes them out, as three autograd
``Function``s over one mesh axis each (``mesh.get_group(axis)``):

- ``copy_to(x, mesh, axis)``: identity forward; the backward sums the
  gradient over the axis (``all_reduce``). It marks where a tensor
  replicated on the axis enters per-rank work: a column-parallel layer,
  or the parameters of a tower that sees one slice of a sequence;
- ``gather_from(x, mesh, axis, dim)``: the slices of ``x`` along ``dim``
  from every rank of the axis, concatenated in rank order (the list form of
  ``all_gather``); the gradient coming back is replicated on the axis, so
  the backward hands each rank its own slice of it, unsummed;
- ``sum_over(x, mesh, axis)``: the sum of ``x`` over the axis
  (``all_reduce``); identity backward.

The sequence axis adds three exchanges, the JAX collectives that
``ring_attention`` and ``ulysses_attention`` issue inside their
``shard_map``. Each takes a tensor or a tuple of tensors (one autograd
node for all of them, so every rank runs the backward's collectives in
the same order whatever its local graph) and returns the same:

- ``shift(x, mesh, axis, offset)``: rank j gets rank (j - offset)'s ``x``,
  ``lax.ppermute`` with ``perm = [(j, (j + offset) % p)]``; the backward
  shifts the gradient by ``-offset``;
- ``swap(x, mesh, axis)``: rank j gets rank (p - 1 - j)'s ``x``, the
  zigzag involution; it is its own backward;
- ``all_to_all(x, mesh, axis, split_dim, concat_dim)``: the tiled
  ``lax.all_to_all``: ``x`` cut into p parts along ``split_dim``, part j
  to rank j, the parts received concatenated along ``concat_dim`` in rank
  order; the backward is the inverse exchange.

An integer tensor (segment ids) travels along and gets no gradient.

An axis the mesh lacks, or of size 1, moves nothing. Only ``all_reduce``
and the list ``all_gather`` are issued: the two collectives that gloo runs
on CUDA tensors (a card may hold several ranks, which only gloo allows).
The three exchanges gather the whole of each operand from every rank and
keep the part this rank needs: p times the bytes of a point-to-point
exchange, with no collective but the one proven on the card. A bf16
operand travels as float32 and comes back in its own dtype.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Union

import torch
import torch.distributed as dist


def axis_size(mesh, axis: Optional[str]) -> int:
    """The size of ``axis`` on ``mesh``; 1 when the mesh has no such axis."""
    names = tuple(getattr(mesh, "mesh_dim_names", None) or ())
    if mesh is None or axis is None or axis not in names:
        return 1
    return mesh.size(names.index(axis))


def axis_index(mesh, axis: Optional[str]) -> int:
    """This rank's coordinate on ``axis``; 0 when the mesh has no such axis."""
    if axis_size(mesh, axis) == 1:
        return 0
    return mesh.get_local_rank(axis)


def _wire(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy to send: float32 for a low-precision float."""
    if t.is_floating_point() and t.dtype != torch.float64:
        return t.to(torch.float32, copy=True).contiguous()
    return t.clone().contiguous()


def all_reduce(t: torch.Tensor, mesh, axis: Optional[str]) -> torch.Tensor:
    """The sum of ``t`` over ``axis``, a new tensor in ``t``'s dtype; ``t``
    itself when the axis has size 1."""
    if axis_size(mesh, axis) == 1:
        return t
    buf = _wire(t)
    dist.all_reduce(buf, group=mesh.get_group(axis))
    return buf.to(t.dtype)


def _gathered(t: torch.Tensor, mesh, axis: str) -> list:
    """Every rank's ``t`` on ``axis``, in rank order, in ``t``'s dtype."""
    buf = _wire(t)
    parts = [torch.empty_like(buf) for _ in range(axis_size(mesh, axis))]
    dist.all_gather(parts, buf, group=mesh.get_group(axis))
    return [part.to(t.dtype) for part in parts]


def all_gather(t: torch.Tensor, mesh, axis: Optional[str], dim: int = 0) -> torch.Tensor:
    """Every rank's ``t`` on ``axis``, concatenated along ``dim`` in rank
    order (every rank's ``t`` must have the same shape)."""
    if axis_size(mesh, axis) == 1:
        return t
    return torch.cat(_gathered(t, mesh, axis), dim=dim)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.mesh, ctx.axis), None, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim, ctx.width = mesh, axis, dim, x.shape[dim]
        return all_gather(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        lo = axis_index(ctx.mesh, ctx.axis) * ctx.width
        return g.narrow(ctx.dim, lo, ctx.width).contiguous(), None, None, None


class _SumOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return all_reduce(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def copy_to(x: torch.Tensor, mesh, axis: Optional[str]) -> torch.Tensor:
    """Identity; its backward sums the gradient over ``axis``."""
    if axis_size(mesh, axis) == 1:
        return x
    return _CopyTo.apply(x, mesh, axis)


def gather_from(x: torch.Tensor, mesh, axis: Optional[str], dim: int = -1) -> torch.Tensor:
    """The axis' slices along ``dim`` concatenated; the backward keeps this
    rank's slice of the (replicated) gradient."""
    if axis_size(mesh, axis) == 1:
        return x
    return _GatherFrom.apply(x, mesh, axis, dim % x.dim())


def sum_over(x: torch.Tensor, mesh, axis: Optional[str]) -> torch.Tensor:
    """The sum over ``axis``; its backward passes the gradient through."""
    if axis_size(mesh, axis) == 1:
        return x
    return _SumOver.apply(x, mesh, axis)


# -- the sequence axis' exchanges -------------------------------------------------------

Tensors = Union[torch.Tensor, Sequence[torch.Tensor]]


def _from_rank(fn: Callable[[int, int], int]) -> Callable:
    """An exchange in which this rank keeps the operand of rank
    ``fn(index, size)``."""
    def pick(t: torch.Tensor, mesh, axis: str) -> torch.Tensor:
        p = axis_size(mesh, axis)
        return _gathered(t, mesh, axis)[fn(axis_index(mesh, axis), p)]
    return pick


def _tiled_all_to_all(t: torch.Tensor, mesh, axis: str, split_dim: int,
                      concat_dim: int) -> torch.Tensor:
    p, me = axis_size(mesh, axis), axis_index(mesh, axis)
    parts = _gathered(t, mesh, axis)
    return torch.cat([part.chunk(p, split_dim)[me] for part in parts], dim=concat_dim)


class _Exchange(torch.autograd.Function):
    """``forward_fn`` on each tensor of the tuple, ``backward_fn`` on each
    gradient of a floating tensor, in one node."""

    @staticmethod
    def forward(ctx, forward_fn, backward_fn, *xs):
        ctx.backward_fn = backward_fn
        ctx.floating = [x.is_floating_point() for x in xs]
        outs = tuple(forward_fn(x) for x in xs)
        ctx.mark_non_differentiable(*[o for o, f in zip(outs, ctx.floating) if not f])
        return outs

    @staticmethod
    def backward(ctx, *gs):
        return (None, None) + tuple(ctx.backward_fn(g) if f else None
                                    for g, f in zip(gs, ctx.floating))


def _exchange(x: Tensors, mesh, axis: Optional[str], forward_fn, backward_fn) -> Tensors:
    single = isinstance(x, torch.Tensor)
    xs = (x,) if single else tuple(x)
    if axis_size(mesh, axis) == 1:
        return x if single else xs
    outs = _Exchange.apply(forward_fn, backward_fn, *xs)
    return outs[0] if single else tuple(outs)


def shift(x: Tensors, mesh, axis: Optional[str], offset: int = 1) -> Tensors:
    """Rank j gets rank (j - offset)'s ``x`` (``lax.ppermute`` with
    ``perm = [(j, (j + offset) % p)]``); the backward shifts by -offset."""
    fwd = _from_rank(lambda j, p: (j - offset) % p)
    bwd = _from_rank(lambda j, p: (j + offset) % p)
    return _exchange(x, mesh, axis, lambda t: fwd(t, mesh, axis), lambda g: bwd(g, mesh, axis))


def swap(x: Tensors, mesh, axis: Optional[str]) -> Tensors:
    """Rank j gets rank (p - 1 - j)'s ``x``: the zigzag involution, its
    own backward."""
    mirror = _from_rank(lambda j, p: p - 1 - j)
    fn = lambda t: mirror(t, mesh, axis)  # noqa: E731
    return _exchange(x, mesh, axis, fn, fn)


def all_to_all(x: Tensors, mesh, axis: Optional[str], split_dim: int,
               concat_dim: int) -> Tensors:
    """The tiled ``lax.all_to_all``: each ``x`` cut into p parts along
    ``split_dim``, part j to rank j, the parts received concatenated along
    ``concat_dim`` in rank order; the backward is the inverse exchange."""
    return _exchange(
        x, mesh, axis,
        lambda t: _tiled_all_to_all(t, mesh, axis, split_dim, concat_dim),
        lambda g: _tiled_all_to_all(g, mesh, axis, concat_dim, split_dim))


def sum_grads(tensors, mesh, axis: Optional[str]) -> None:
    """Sum the gradients of ``tensors`` over ``axis`` in place, in one
    float32 ``all_reduce`` (a missing gradient counts as zeros)."""
    if axis_size(mesh, axis) == 1:
        return
    tensors = list(tensors)
    for t in tensors:
        if t.grad is None:
            t.grad = torch.zeros_like(t)
    flat = all_reduce(torch.cat([t.grad.reshape(-1).float() for t in tensors]), mesh, axis)
    at = 0
    for t in tensors:
        t.grad.copy_(flat[at:at + t.numel()].view_as(t.grad))
        at += t.numel()
