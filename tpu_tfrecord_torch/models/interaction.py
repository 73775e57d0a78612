"""DLRM dot interaction: pairwise feature dots, forward and backward.

Given per-feature embeddings E [B, F, D], emit every pairwise dot
<E_i, E_j> for i > j, packed in ``np.tril_indices(F, k=-1)`` order —
(1,0), (2,0), (2,1), (3,0), ... — as a [B, F*(F-1)/2] tensor in E's dtype,
with the sums taken in f32.

``dot_interaction`` launches a hand-written CUDA kernel
(``csrc/interaction.cu``, the port of
``tpu_tfrecord/models/interaction.py::dot_interaction_pallas``) for a CUDA
tensor and uses the plain version for a CPU tensor; nothing else. The
kernel has two instances: bf16 E (the DLRM's main path) takes the Gram on
the tensor cores, f32 E register-blocked f32 FMAs on the CUDA cores. Their
launch geometry comes from ``_interaction_plan``, plain Python that the CPU
tests reach.

Gradients: where grad mode is on and E requires grad, ``dot_interaction``
runs through ``DotInteraction``, a ``torch.autograd.Function`` whose
forward is the kernel (the plain version on the CPU) and whose backward is
``dot_interaction_backward_reference``, the port of the JAX package's
``_bwd``: dE = (dG + dG^T) @ E in f32, dG scattered from the packed pairs.
The JAX package computes that backward in plain XLA, outside any Pallas
kernel, so here it is plain torch ops and launches no hand-written kernel.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

_PAIRS: Dict[Tuple[int, str], Tuple[torch.Tensor, torch.Tensor]] = {}


def tril_pairs(f: int, device="cpu") -> Tuple[torch.Tensor, torch.Tensor]:
    """(rows, cols) int32 index tables of ``np.tril_indices(f, k=-1)`` on
    ``device``, built once per (f, device)."""
    device = torch.device(device)
    key = (f, str(device))
    pairs = _PAIRS.get(key)
    if pairs is None:
        rows, cols = np.tril_indices(f, k=-1)
        pairs = _PAIRS[key] = (
            torch.from_numpy(rows.astype(np.int32)).to(device),
            torch.from_numpy(cols.astype(np.int32)).to(device),
        )
    return pairs


def dot_interaction_reference(emb: torch.Tensor) -> torch.Tensor:
    """Plain version: Gram matrix by einsum in f32, then the packed lower
    triangle, cast to ``emb``'s dtype."""
    e = emb.float()
    gram = torch.einsum("bfd,bgd->bfg", e, e)
    rows, cols = tril_pairs(emb.shape[1], emb.device)
    return gram[:, rows.long(), cols.long()].to(emb.dtype)


def dot_interaction_backward_reference(emb: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The gradient of the packed pairs with respect to ``emb`` [B, F, D],
    given their gradient ``g`` [B, F*(F-1)/2]: ``g`` in f32 scattered into
    a zero [B, F, F] at the lower-triangle pairs, plus its transpose, times
    E in f32, cast to E's dtype."""
    b, f, _ = emb.shape
    rows, cols = tril_pairs(f, emb.device)
    dgram = torch.zeros((b, f, f), dtype=torch.float32, device=emb.device)
    dgram[:, rows.long(), cols.long()] = g.float()
    sym = dgram + dgram.transpose(1, 2)
    return torch.bmm(sym, emb.float()).to(emb.dtype)


# Limits of an H100 (sm_90) and of the kernels in csrc/interaction.cu.
SMEM_BLOCK_MAX = 232_448      # dynamic shared memory one block may use
_SMEM_SM = 233_472            # shared memory of one SM
_SMEM_BLOCK_RESERVED = 1_024  # taken by the runtime for each resident block
_MMA_MAX_DP = 128             # interaction.cu: kMaxKSteps * 16
_MMA_BLOCKS_PER_SM = 4        # interaction.cu: kMmaMinBlocks
_STAGES = 2                   # interaction.cu: kStages, tiles of rows in flight
_MMA_TILE_BYTES = 8 * 1024    # bytes of E a tile aims to copy
_MMA_MAX_TILE = 32            # samples: 8 for each of the 4 warps
_TILED_THREADS = 256          # interaction.cu: kTiledThreads
_TILED_BLOCKS_PER_SM = 3      # interaction.cu: kTiledMinBlocks
_TILED_SAMPLE_PAD = 4         # interaction.cu: kSamplePad, floats after a staged sample
_TILED_MAX_TILE = 32

INSTANCES = ("bf16_mma", "f32_tiled")


class InteractionPlan(NamedTuple):
    """Launch geometry of one kernel call (see ``csrc/interaction.cu``)."""

    instance: str    # "bf16_mma" or "f32_tiled"
    fp: int          # staged rows per sample (F padded to 16 for the mma, to 4 for f32)
    dp: int          # staged columns per row (D padded to 16 for the mma, to 4 for f32)
    stride: int      # shared-memory row stride, elements
    tile: int        # samples per tile
    smem: int        # dynamic shared memory per block, bytes
    grid: int        # blocks
    vec_loads: bool  # rows are whole 16-byte chunks: cp.async staging


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _interaction_plan(b: int, f: int, d: int, dtype: torch.dtype, sms: int = 132) -> InteractionPlan:
    """Geometry of the kernel instance that takes E [b, f, d] of ``dtype``
    on a card with ``sms`` SMs. Raises ``ValueError`` where the design
    cannot take the shape.

    bf16: each sample's rows are staged as [Fp][stride] bf16, Fp and Dp the
    next multiples of 16, stride = Dp + 8 (the 16 extra bytes make the
    ldmatrix rows conflict-free). A block holds two tiles of rows and one
    tile of outputs (plus 8 elements of alignment slack). A tile is about
    8 KB of E (4 samples at the main path's (27, 32)), at most 32 samples,
    fewer where shared memory runs out; its output span may start inside a
    16-byte chunk, which the kernel's store handles. The grid is
    persistent: up to 4 blocks per SM.

    f32: each sample's rows are staged as [Fp][stride] f32, Fp and stride =
    Dp the next multiples of 4, then 4 floats of pad, so a sample is an odd
    number of 16-byte chunks (8 consecutive samples at one row and column
    fall in 8 different bank groups). A thread takes one 4x4 block of row
    pairs of one sample, (Fp/4)(Fp/4 + 1)/2 blocks per sample. A tile is a
    multiple of 8 samples, the most that gives each of the 256 threads at
    most one block (8 at the main path's (27, 32)), at most 32, fewer where
    shared memory runs out; a block holds two tiles of rows and one of
    outputs (plus 4 floats of alignment slack). Persistent grid: up to 3
    blocks per SM."""
    if b < 1 or f < 2 or d < 1:
        raise ValueError(f"dot_interaction kernel needs B >= 1, F >= 2, D >= 1; got ({b}, {f}, {d})")
    p = f * (f - 1) // 2
    if dtype == torch.float32:
        return _tiled_plan(b, f, d, p, sms)
    if dtype != torch.bfloat16:
        raise ValueError(f"dot_interaction kernel takes bf16 or f32, got {dtype}")
    fp, dp = _round_up(f, 16), _round_up(d, 16)
    if dp > _MMA_MAX_DP:
        raise ValueError(f"bf16 dot_interaction kernel takes D <= {_MMA_MAX_DP}, got {d}")
    stride = dp + 8

    def smem(tile: int) -> int:
        return _STAGES * tile * fp * stride * 2 + _round_up(8 + tile * p, 8) * 2

    tile = max(1, min(_MMA_MAX_TILE, _MMA_TILE_BYTES // (f * d * 2)))
    while tile > 1 and smem(tile) > SMEM_BLOCK_MAX:
        tile -= 1
    if smem(tile) > SMEM_BLOCK_MAX:
        raise ValueError(f"bf16 dot_interaction kernel: one sample of ({f}, {d}) needs "
                         f"{smem(1)} B of shared memory, over {SMEM_BLOCK_MAX}")
    per_sm = min(_MMA_BLOCKS_PER_SM, _SMEM_SM // (smem(tile) + _SMEM_BLOCK_RESERVED))
    grid = min(-(-b // tile), sms * per_sm)
    return InteractionPlan("bf16_mma", fp, dp, stride, tile, smem(tile), grid, d % 8 == 0)


def _tiled_plan(b: int, f: int, d: int, p: int, sms: int) -> InteractionPlan:
    """The f32 instance's geometry (see ``_interaction_plan``)."""
    fp, dp = _round_up(f, 4), _round_up(d, 4)
    sample = fp * dp + _TILED_SAMPLE_PAD
    nb = fp // 4

    def smem(tile: int) -> int:
        return (_STAGES * tile * sample + _round_up(4 + tile * p, 4)) * 4

    tile = max(8, min(_TILED_MAX_TILE, _TILED_THREADS // (nb * (nb + 1) // 2) // 8 * 8))
    while tile > 1 and smem(tile) > SMEM_BLOCK_MAX:
        tile -= 1
    if smem(tile) > SMEM_BLOCK_MAX:
        raise ValueError(f"f32 dot_interaction kernel: one sample of ({f}, {d}) needs "
                         f"{smem(1)} B of shared memory, over {SMEM_BLOCK_MAX}")
    per_sm = min(_TILED_BLOCKS_PER_SM, _SMEM_SM // (smem(tile) + _SMEM_BLOCK_RESERVED))
    grid = min(-(-b // tile), sms * per_sm)
    return InteractionPlan("f32_tiled", fp, dp, dp, tile, smem(tile), grid, d % 4 == 0)


@functools.cache
def _kernel_fns():
    from tpu_tfrecord_torch import _cuda

    lib = _cuda.load("interaction")
    fns = {"bf16_mma": lib.dot_interaction_bf16, "f32_tiled": lib.dot_interaction_f32}
    for fn in fns.values():  # both take the same arguments
        fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fns


@functools.lru_cache(maxsize=256)
def _device_plan(b: int, f: int, d: int, dtype: torch.dtype, index: int) -> InteractionPlan:
    """``_interaction_plan`` for CUDA device ``index``, kept per shape: the
    wrapper runs once per forward and its host time is launch overhead."""
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    return _interaction_plan(b, f, d, dtype, sms)


def dot_interaction_cuda(emb: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on ``emb`` [B, F, D] (bf16 or f32, contiguous,
    on a CUDA device) on the current stream. Raises on anything else, on a
    shape the kernel cannot take (``ValueError``) and when the launch fails.
    An empty output (B = 0 or F = 1) is returned without a launch."""
    if emb.device.type != "cuda":
        raise ValueError(f"dot_interaction_cuda needs a CUDA tensor, got {emb.device}")
    if emb.dim() != 3:
        raise ValueError(f"expected E of shape [B, F, D], got {tuple(emb.shape)}")
    if emb.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"dot_interaction kernel takes bf16 or f32, got {emb.dtype}")
    if not emb.is_contiguous():
        raise ValueError("dot_interaction kernel needs a contiguous E")
    b, f, d = emb.shape
    p = f * (f - 1) // 2
    out = torch.empty((b, p), dtype=emb.dtype, device=emb.device)
    if out.numel() == 0:
        return out
    plan = _device_plan(b, f, d, emb.dtype, emb.device.index or 0)
    fn = _kernel_fns()[plan.instance]
    with torch.cuda.device(emb.device):
        stream = torch.cuda.current_stream().cuda_stream
        vec_loads = plan.vec_loads and emb.data_ptr() % 16 == 0
        err = fn(emb.data_ptr(), out.data_ptr(), b, f, d, p, plan.fp, plan.dp,
                 plan.stride, plan.tile, plan.smem, plan.grid, int(vec_loads), stream)
    if err != 0:
        raise RuntimeError(
            f"dot_interaction kernel launch failed (cudaError {err}) at "
            f"B={b} F={f} D={d} {emb.dtype}: {plan}"
        )
    dot_interaction.launches += 1
    dot_interaction.instance_launches[plan.instance] += 1
    return out


def _forward(emb: torch.Tensor) -> torch.Tensor:
    if emb.device.type == "cpu":
        return dot_interaction_reference(emb)
    return dot_interaction_cuda(emb)


class DotInteraction(torch.autograd.Function):
    """The packed pairwise dots with their gradient: the kernel forward (the
    plain version for a CPU tensor) and ``dot_interaction_backward_reference``
    as the backward."""

    @staticmethod
    def forward(ctx, emb: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(emb)
        return _forward(emb)

    @staticmethod
    def backward(ctx, g: torch.Tensor) -> torch.Tensor:
        (emb,) = ctx.saved_tensors
        return dot_interaction_backward_reference(emb, g)


def dot_interaction(emb: torch.Tensor) -> torch.Tensor:
    """Packed pairwise dots [B, F, D] -> [B, F*(F-1)/2]: the CUDA kernel
    for a CUDA tensor, the plain version for a CPU tensor; through
    ``DotInteraction`` where grad mode is on and ``emb`` requires grad."""
    if torch.is_grad_enabled() and emb.requires_grad:
        return DotInteraction.apply(emb)
    return _forward(emb)


def reset_launch_counts() -> None:
    """Set the kernel's launch counters to 0."""
    dot_interaction.launches = 0
    dot_interaction.instance_launches = dict.fromkeys(INSTANCES, 0)


#: kernel launches since the last reset, of both instances
#: (``instance_launches`` splits them): forward launches only, since the
#: backward launches no hand-written kernel; launches of the plain version
#: do not count
reset_launch_counts()
