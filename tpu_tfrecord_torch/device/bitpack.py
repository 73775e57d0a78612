"""Transfer bit-packing: fewer host-to-device bytes for bounded-int columns.

Port of ``tpu_tfrecord/tpu/bitpack.py``. Hashed categorical features are
bucket ids in ``[0, hash_buckets)``: for a 2**20-bucket table that is 20
significant bits in a 32-bit lane. ``pack_bits`` packs the columns of an
int matrix into ``bits``-wide lanes of a narrower int32 matrix on the host;
``pack_mixed`` passes the first ``keep`` lanes of each row through and packs
the rest in one native call (``_native.pack_mixed``); ``unpack_bits`` is
the exact inverse as torch ops on the tensor's own device: int64 shifts,
masks and a (C_out x C_in) lane gather. Round trips are bit-exact for any
values < 2**bits.

torch lacks most ``uint32`` ops on the CPU, so the unpack widens the lanes
to int64 and masks them back to their 32-bit pattern before shifting.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from tpu_tfrecord_torch import _native

__all__ = ["packed_width", "pack_bits", "pack_mixed", "unpack_bits"]

_LANE = 32  # packing lane width: int32, the narrowest common transfer dtype
_LANE_MASK = (1 << _LANE) - 1


def packed_width(n_cols: int, bits: int) -> int:
    """Number of int32 output columns for ``n_cols`` values of ``bits`` each."""
    if not 1 <= bits <= _LANE:
        raise ValueError(f"bits must be in [1, {_LANE}], got {bits}")
    return (n_cols * bits + _LANE - 1) // _LANE


def pack_bits(arr: np.ndarray, bits: int) -> np.ndarray:
    """Pack ``arr[:, j] < 2**bits`` (int32/int64, non-negative) into a dense
    [B, packed_width] int32 matrix, little-endian within and across lanes:
    value j occupies global bit positions [j*bits, (j+1)*bits).

    Values are masked to ``bits``; negatives are rejected, since
    two's-complement lanes would corrupt their neighbours. At bits=32 a
    value in ``[2**31, 2**32)`` comes back as its int32 reinterpretation.
    """
    if arr.ndim != 2:
        raise ValueError(f"pack_bits expects [B, C], got shape {arr.shape}")
    b, c = arr.shape
    w = packed_width(c, bits)
    if np.issubdtype(arr.dtype, np.signedinteger) and arr.size and arr.min() < 0:
        raise ValueError("pack_bits requires non-negative values")
    if bits == _LANE:
        return (arr.astype(np.uint64) & _LANE_MASK).astype(np.uint32).view(np.int32)
    vals = arr.astype(np.uint64) & ((1 << bits) - 1)
    out = np.zeros((b, w), dtype=np.uint64)  # u64 scratch absorbs lane spill
    starts = np.arange(c, dtype=np.int64) * bits
    lanes = starts // _LANE
    offs = starts % _LANE
    for j in range(c):
        lane, off = int(lanes[j]), int(offs[j])
        out[:, lane] |= vals[:, j] << off
        spill = off + bits - _LANE
        if spill > 0:
            out[:, lane + 1] |= vals[:, j] >> (bits - spill)
    return (out & _LANE_MASK).astype(np.uint32).view(np.int32)


def pack_mixed(arr: np.ndarray, keep: int, bits: int) -> np.ndarray:
    """Mixed-width wire matrix: the first ``keep`` int32 lanes of each row
    pass through verbatim, the remaining columns bit-pack to ``bits``, as
    ``concatenate([arr[:, :keep], pack_bits(arr[:, keep:], bits)])``. int32
    input takes one native pass (``_native.pack_mixed``, which rejects a
    negative packed value); other integer dtypes take numpy. The consumer
    unpacks the tail with ``unpack_bits(wire[:, keep:], C - keep, bits)``.
    """
    if arr.ndim != 2:
        raise ValueError(f"pack_mixed expects [B, C], got shape {arr.shape}")
    if not 0 <= keep <= arr.shape[1]:
        raise ValueError(f"keep={keep} out of range for {arr.shape[1]} columns")
    packed_width(1, bits)  # validate bits before the native call
    if arr.dtype == np.int32:
        return _native.pack_mixed(arr, keep, bits)
    return np.concatenate(
        [np.ascontiguousarray(arr[:, :keep]).astype(np.int32),
         pack_bits(arr[:, keep:], bits)],
        axis=1,
    )


@functools.lru_cache(maxsize=64)
def _unpack_plan(n_cols: int, bits: int, width: int, device: torch.device) -> tuple:
    """(lane, shift, next lane, spill shift, straddles) index tensors of an
    unpack, built once per shape and device: a host-to-device copy of them
    on every call would wait for the stream's earlier work."""
    starts = np.arange(n_cols, dtype=np.int64) * bits
    lanes = starts // _LANE
    offs = starts % _LANE
    spill = offs + bits - _LANE  # > 0 where a value straddles two lanes
    next_lane = np.minimum(lanes + 1, width - 1)
    hi_shift = np.where(spill > 0, bits - spill, 0)
    return tuple(torch.from_numpy(a).to(device) for a in (lanes, offs, next_lane, hi_shift, spill > 0))


def unpack_bits(packed: torch.Tensor, n_cols: int, bits: int) -> torch.Tensor:
    """Inverse of :func:`pack_bits` as torch ops on ``packed``'s device:
    [B, packed_width] int32 -> [B, n_cols] int32."""
    if bits == _LANE:
        return packed
    lanes, offs, next_lane, hi_shift, straddles = _unpack_plan(
        n_cols, bits, packed.shape[1], packed.device
    )
    u = packed.to(torch.int64) & _LANE_MASK  # the lanes' unsigned 32-bit patterns
    lo = u[:, lanes] >> offs
    # high part: the next lane's low bits shifted up, dropped where no spill
    hi = torch.where(straddles, u[:, next_lane] << hi_shift, 0)
    return ((lo | hi) & ((1 << bits) - 1)).to(torch.int32)
