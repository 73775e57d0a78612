"""DLRM dot interaction: pairwise feature dots, forward only.

Given per-feature embeddings E [B, F, D], emit every pairwise dot
<E_i, E_j> for i > j, packed in ``np.tril_indices(F, k=-1)`` order —
(1,0), (2,0), (2,1), (3,0), ... — as a [B, F*(F-1)/2] tensor in E's dtype,
with the sums taken in f32.

``dot_interaction`` launches the hand-written CUDA kernel
(``csrc/interaction.cu``, the port of
``tpu_tfrecord/models/interaction.py::dot_interaction_pallas``) for a CUDA
tensor and uses the plain version for a CPU tensor; nothing else. The
backward pass is not ported yet.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

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


_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _kernel_fn():
    from tpu_tfrecord_torch import _cuda

    fn = _cuda.load("interaction").dot_interaction_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def dot_interaction_cuda(emb: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on ``emb`` [B, F, D] (bf16 or f32, contiguous,
    on a CUDA device) on the current stream. Raises on anything else, and
    when the launch fails."""
    if emb.device.type != "cuda":
        raise ValueError(f"dot_interaction_cuda needs a CUDA tensor, got {emb.device}")
    if emb.dim() != 3:
        raise ValueError(f"expected E of shape [B, F, D], got {tuple(emb.shape)}")
    if emb.dtype not in _DTYPE_CODES:
        raise TypeError(f"dot_interaction kernel takes bf16 or f32, got {emb.dtype}")
    if not emb.is_contiguous():
        raise ValueError("dot_interaction kernel needs a contiguous E")
    b, f, d = emb.shape
    p = f * (f - 1) // 2
    out = torch.empty((b, p), dtype=emb.dtype, device=emb.device)
    rows, cols = tril_pairs(f, emb.device)
    with torch.cuda.device(emb.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel_fn()(
            emb.data_ptr(), out.data_ptr(), rows.data_ptr(), cols.data_ptr(),
            b, f, d, p, _DTYPE_CODES[emb.dtype], stream,
        )
    if err != 0:
        raise RuntimeError(
            f"dot_interaction kernel launch failed (cudaError {err}) at "
            f"B={b} F={f} D={d} {emb.dtype}"
        )
    dot_interaction.launches += 1
    return out


def dot_interaction(emb: torch.Tensor) -> torch.Tensor:
    """Packed pairwise dots [B, F, D] -> [B, F*(F-1)/2]: the CUDA kernel
    for a CUDA tensor, the plain version for a CPU tensor."""
    if emb.device.type == "cpu":
        return dot_interaction_reference(emb)
    return dot_interaction_cuda(emb)


#: kernel launches since the last reset (launches of the plain version do
#: not count)
dot_interaction.launches = 0
