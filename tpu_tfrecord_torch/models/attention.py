"""Dense softmax attention: port of ``attention_reference`` of
``tpu_tfrecord/models/attention.py``.

The sequence models of the port (``models.long_doc``, ``models.lm``) run
on one card, so their attention is the dense one. It keeps the JAX
function's order of operations: the score product in the inputs' dtype,
then in float32 the scale, the masks (``_NEG``, a finite value, so a row
with every key masked gets uniform weights instead of NaNs) and the
softmax, the second product in float32, and the cast back to the inputs'
dtype. ``F.scaled_dot_product_attention`` is not used: its ``-inf`` masks
and fused kernels change both the masked rows and the summation.

Not ported: ``ring_attention``, ``ulysses_attention`` and their per-device
bodies, which shard the sequence over the ranks of a mesh; they raise
``OptionNotPortedError``.
"""

from __future__ import annotations

from typing import Optional

import torch

from tpu_tfrecord_torch.options import OptionNotPortedError

_NEG = -1e30  # the mask value; finite, so an empty row never gives inf - inf


def _expand_kv(q: torch.Tensor, kv: torch.Tensor) -> torch.Tensor:
    """GQA: repeat each K/V head in place to match q's head count (a no-op
    for MHA). q [B, L, H, D], kv [B, M, Hkv, D] with H % Hkv == 0 ->
    [B, M, H, D]; head j of the result is kv head j // (H / Hkv), as
    ``jnp.repeat(kv, H // Hkv, axis=2)`` gives."""
    h, hkv = q.shape[2], kv.shape[2]
    if h == hkv:
        return kv
    if h % hkv:
        raise ValueError(
            f"GQA needs num_heads % num_kv_heads == 0 (got H={h}, Hkv={hkv})"
        )
    return kv.repeat_interleave(h // hkv, dim=2)


def attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    lengths: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    causal: bool = False,
    segments: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Dense softmax attention. q [B, L, H, D], k/v [B, L, Hkv, D] with
    Hkv == H (MHA) or H % Hkv == 0 (GQA/MQA) -> [B, L, H, D] in q's dtype.
    ``lengths`` [B] masks the keys at and past each row's length;
    ``causal`` masks the keys after each query position; ``segments``
    [B, L] int lets position i attend to j only where
    segments[b, i] == segments[b, j] (documents packed into one row)."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    k, v = _expand_kv(q, k), _expand_kv(q, v)
    scores = torch.einsum("blhd,bmhd->bhlm", q, k).float() * scale
    if lengths is not None:
        valid = torch.arange(k.shape[1], device=k.device)[None, :] < lengths[:, None]
        scores = torch.where(valid[:, None, None, :], scores, _NEG)
    if segments is not None:
        same = segments[:, :, None] == segments[:, None, :]         # [B, L, M]
        scores = torch.where(same[:, None, :, :], scores, _NEG)
    if causal:
        l, m = q.shape[1], k.shape[1]
        tri = (torch.arange(m, device=q.device)[None, :]
               <= torch.arange(l, device=q.device)[:, None])       # [L, M]
        scores = torch.where(tri[None, None, :, :], scores, _NEG)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhlm,bmhd->blhd", probs, v.float()).to(q.dtype)


def ring_attention(*args, **kwargs):
    """Not ported: the ring shards the sequence over devices."""
    raise OptionNotPortedError(
        "ring_attention: sequence-parallel attention over torch.distributed ranks "
        "is not ported yet; use attention_reference"
    )


def ulysses_attention(*args, **kwargs):
    """Not ported: the all-to-all exchange shards the sequence over devices."""
    raise OptionNotPortedError(
        "ulysses_attention: sequence-parallel attention over torch.distributed ranks "
        "is not ported yet; use attention_reference"
    )
