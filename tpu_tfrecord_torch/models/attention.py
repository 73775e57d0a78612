"""Softmax attention: port of ``tpu_tfrecord/models/attention.py``.

``attention_reference`` is the dense attention the sequence models run on
one card. It keeps the JAX function's order of operations: the score
product in the inputs' dtype, then in float32 the scale, the masks
(``_NEG``, a finite value, so a row with every key masked gets uniform
weights instead of NaNs) and the softmax, the second product in float32,
and the cast back to the inputs' dtype. ``F.scaled_dot_product_attention``
is not used: its ``-inf`` masks and fused kernels change both the masked
rows and the summation.

``ring_attention`` and ``ulysses_attention`` shard the sequence over the
``seq_axis`` of a torch ``DeviceMesh`` of ranks, as the JAX functions shard
it over a mesh axis inside ``shard_map``. Each rank passes and gets back
its own contiguous chunk: q [B/data, L/p, H, D], k and v
[B/data, L/p, Hkv, D], ``lengths`` [B/data] and ``segments``
[B/data, L/p] of its rows (``data_axis`` is taken for the JAX signature:
the batch is already this rank's rows). The exchanges are
``models.sharded``'s ``shift``, ``swap`` and ``all_to_all``; autograd
through them gives the gradients, the backward's collectives in the same
order on every rank.

- The ring (``_ring_attention_local``, JAX ``:98-320``) folds the rank's
  own block (the causal diagonal) first, then p - 1 blocks that arrive by
  ``shift``: an online softmax in float32 with the ``_NEG`` floor and the
  ``max(l, 1e-30)`` divide. Only the Hkv heads travel; ``segments`` ride
  every hop. Under ``zigzag`` one ``swap`` of the second chunk-halves
  gives rank j strips 2j and 2p-1-2j, each later step computes only the
  unmasked half block (``half_k`` or ``half_q``, picked by
  ``(src < idx) == (src + idx <= p - 1)``: a Python branch, the rank
  index being an int), and the output swaps back.
- Ulysses (JAX ``:421-488``): two ``all_to_all`` exchanges around the
  dense attention, [B, L/p, H, D] -> [B, L, H/p, D] and back; the
  segment ids are gathered over the axis.
"""

from __future__ import annotations

from typing import Optional

import torch

from tpu_tfrecord_torch.models.sharded import all_gather, all_to_all, axis_index, axis_size, shift, swap

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


def _ring_attention_local(q, k, v, lengths, scale: float, mesh, axis: str, causal: bool,
                          zigzag: bool, segments):
    """This rank's body of the ring: q [B, Lc, H, D], k/v [B, Lc, Hkv, D]
    and ``segments`` [B, Lc] are its chunks; K/V (and the segment ids)
    rotate one neighbour a step."""
    p, idx = axis_size(mesh, axis), axis_index(mesh, axis)
    if zigzag:
        half = q.shape[1] // 2
        parts = (q, k, v) if segments is None else (q, k, v, segments)
        other = swap(tuple(t[:, half:] for t in parts), mesh, axis)
        parts = [torch.cat([t[:, :half], o], dim=1) for t, o in zip(parts, other)]
        q, k, v = parts[:3]
        if segments is not None:
            segments = parts[3]
    b, lc, h, d = q.shape
    dev = q.device

    def dev_pos(r: int) -> torch.Tensor:
        """Global positions of rank ``r``'s local rows."""
        if zigzag:
            s = lc // 2
            ar = torch.arange(s, device=dev)
            return torch.cat([2 * r * s + ar, (2 * p - 1 - 2 * r) * s + ar])
        return r * lc + torch.arange(lc, device=dev)

    def scores_of(qr, kr):
        return torch.einsum("blhd,bmhd->bhlm", qr, _expand_kv(q, kr)).float() * scale

    def len_mask(scores, kp):
        if lengths is None:
            return scores
        valid = kp[None, :] < lengths[:, None]                    # [B, K]
        return torch.where(valid[:, None, None, :], scores, _NEG)

    def seg_mask(scores, sq, sk):
        if sq is None:
            return scores
        same = sq[:, :, None] == sk[:, None, :]                   # [B, R, K]
        return torch.where(same[:, None, :, :], scores, _NEG)

    def online_update(scores, v_rows, m, l, o):
        """One online-softmax fold of ``scores`` [B, H, R, K] with values
        ``v_rows`` [B, K, H, D] into accumulators over the same R rows."""
        new_m = torch.maximum(m, scores.amax(dim=-1))
        corr = torch.exp(m - new_m)                               # rescale old sums
        probs = torch.exp(scores - new_m[..., None])
        l = l * corr + probs.sum(dim=-1)
        upd = torch.einsum("bhlm,bmhd->blhd", probs, v_rows.float())
        return new_m, l, o * corr.transpose(1, 2)[..., None] + upd

    def accumulate(step, k_blk, v_blk, seg_blk, m, l, o):
        # the block at step s came from rank (idx - s) mod p
        key_pos = dev_pos((idx - step) % p)
        scores = len_mask(scores_of(q, k_blk), key_pos)
        scores = seg_mask(scores, segments, seg_blk)
        if causal:
            tri = key_pos[None, :] <= dev_pos(idx)[:, None]       # [Lq, Lk]
            scores = torch.where(tri[None, None, :, :], scores, _NEG)
        return online_update(scores, _expand_kv(q, v_blk), m, l, o)

    def accumulate_zigzag(step, k_blk, v_blk, seg_blk, m, l, o):
        """A later step of the balanced causal ring: only the half of the
        score matrix that the strips leave causally unmasked."""
        s = lc // 2
        src = (idx - step) % p
        key_pos = dev_pos(src)
        start = 0 if src < idx else s
        if (src < idx) == (src + idx <= p - 1):
            # one k-half against every q row
            rows = slice(start, start + s)
            scores = len_mask(scores_of(q, k_blk[:, rows]), key_pos[rows])
            if segments is not None:
                scores = seg_mask(scores, segments, seg_blk[:, rows])
            return online_update(scores, _expand_kv(q, v_blk[:, rows]), m, l, o)
        # every key against one q-half: fold into that half's accumulators
        rows = slice(start, start + s)
        scores = len_mask(scores_of(q[:, rows], k_blk), key_pos)
        if segments is not None:
            scores = seg_mask(scores, segments[:, rows], seg_blk)
        ms, ls, os_ = online_update(scores, _expand_kv(q, v_blk), m[:, :, rows], l[:, :, rows],
                                    o[:, rows])
        return (torch.cat([m[:, :, :start], ms, m[:, :, start + s:]], dim=2),
                torch.cat([l[:, :, :start], ls, l[:, :, start + s:]], dim=2),
                torch.cat([o[:, :start], os_, o[:, start + s:]], dim=1))

    m = torch.full((b, h, lc), _NEG, dtype=torch.float32, device=dev)
    l = torch.zeros((b, h, lc), dtype=torch.float32, device=dev)
    o = torch.zeros((b, lc, h, d), dtype=torch.float32, device=dev)
    # step 0 is the rank's own block, the causal diagonal: the full masked fold
    m, l, o = accumulate(0, k, v, segments, m, l, o)
    rest = accumulate_zigzag if zigzag else accumulate
    blocks = (k, v) if segments is None else (k, v, segments)
    for step in range(1, p):
        blocks = shift(blocks, mesh, axis, 1)                     # p - 1 hops in all
        seg_blk = blocks[2] if segments is not None else None
        m, l, o = rest(step, blocks[0], blocks[1], seg_blk, m, l, o)
    out = o / torch.clamp(l, min=1e-30).transpose(1, 2)[..., None]
    if zigzag:  # the half swap is an involution: swap back
        half = lc // 2
        out = torch.cat([out[:, :half], swap(out[:, half:], mesh, axis)], dim=1)
    return out.to(q.dtype)


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mesh,
    seq_axis: str = "seq",
    data_axis: Optional[str] = None,
    lengths: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    causal: bool = False,
    zigzag: bool = False,
    segments: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Exact attention over a sequence sharded on ``mesh[seq_axis]``; this
    rank's chunk in, its chunk out (module docstring). q [B, Lc, H, D], k/v
    [B, Lc, Hkv, D] with Hkv a positive divisor of H; ``lengths`` [B] masks
    the keys at and past each row's (global) length; ``segments`` [B, Lc]
    int ids make the mask block-diagonal across packed documents.
    ``zigzag`` (causal only) runs the balanced causal schedule and needs
    the global length L = p·Lc divisible by 2p. JAX's ``ValueError``s."""
    p = axis_size(mesh, seq_axis)
    if zigzag:
        if not causal:
            raise ValueError(
                "zigzag re-striping only changes anything for causal "
                "attention; pass causal=True or drop zigzag"
            )
        if (q.shape[1] * p) % (2 * p):
            raise ValueError(
                f"zigzag needs sequence length % (2 * mesh['{seq_axis}']) "
                f"== 0 (got L={q.shape[1] * p}, axis size {p})"
            )
    if segments is not None and tuple(segments.shape) != tuple(q.shape[:2]):
        raise ValueError(
            f"segments shape {tuple(segments.shape)} != batch/sequence dims "
            f"{tuple(q.shape[:2])} of q"
        )
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    return _ring_attention_local(q, k, v, lengths, scale, mesh, seq_axis, causal, zigzag,
                                 segments)


def ulysses_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mesh,
    seq_axis: str = "seq",
    data_axis: Optional[str] = None,
    lengths: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    causal: bool = False,
    segments: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Exact attention over a sequence sharded on ``mesh[seq_axis]`` by the
    all-to-all (DeepSpeed-Ulysses) pattern, ``ring_attention``'s contract:
    [B, Lc, H, D] -> [B, L, H/p, D] by one ``all_to_all``, the dense
    attention over the whole sequence for this rank's head group, and the
    inverse exchange. H and Hkv must both divide by the axis size (JAX's
    ``ValueError``)."""
    p = axis_size(mesh, seq_axis)
    h, hkv = q.shape[2], k.shape[2]
    if h % p or hkv % p:
        raise ValueError(
            f"ulysses_attention needs num_heads % mesh['{seq_axis}'] == 0 "
            f"for q AND k/v (got H={h}, Hkv={hkv}, axis size {p}); use "
            f"ring_attention when heads cannot cover the sequence axis"
        )
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    qh, kh, vh = all_to_all((q, k, v), mesh, seq_axis, split_dim=2, concat_dim=1)
    if segments is not None:
        # the attention spans the whole sequence: every rank needs every id
        segments = all_gather(segments, mesh, seq_axis, dim=1)
    out = attention_reference(qh, kh, vh, lengths=lengths, scale=scale, causal=causal,
                              segments=segments)
    return all_to_all(out, mesh, seq_axis, split_dim=1, concat_dim=2)
