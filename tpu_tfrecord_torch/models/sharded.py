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

An axis the mesh lacks, or of size 1, moves nothing. Only ``all_reduce``
and the list ``all_gather`` are issued: the two collectives that gloo runs
on CUDA tensors (a card may hold several ranks, which only gloo allows).
A bf16 operand travels as float32 and comes back in its own dtype.
"""

from __future__ import annotations

from typing import Optional

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


def all_gather(t: torch.Tensor, mesh, axis: Optional[str], dim: int = 0) -> torch.Tensor:
    """Every rank's ``t`` on ``axis``, concatenated along ``dim`` in rank
    order (every rank's ``t`` must have the same shape)."""
    n = axis_size(mesh, axis)
    if n == 1:
        return t
    buf = _wire(t)
    parts = [torch.empty_like(buf) for _ in range(n)]
    dist.all_gather(parts, buf, group=mesh.get_group(axis))
    return torch.cat(parts, dim=dim).to(t.dtype)


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
