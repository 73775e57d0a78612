"""Columnar host batches -> dense numpy host batches -> tensors on the device.

Port of ``tpu_tfrecord/tpu/ingest.py`` for one device. The host half
(``hash_bytes_column``, ``host_batch_from_columnar``) hashes through
``_native.hash_blob`` and pads ragged columns with the native fused pads
(``_native.pad_ragged_dense`` / ``pad_ragged2_dense``), falling back to the
numpy pads of ``columnar`` only for a dtype the native pads do not take.
``make_device_batch`` takes the place of ``make_global_batch``: each array
is copied into pinned host memory and sent with ``non_blocking=True`` on the
current stream.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Union

import numpy as np
import torch

from tpu_tfrecord_torch import _native, wire
from tpu_tfrecord_torch.columnar import Column, ColumnarBatch, pad_ragged, pad_ragged2
from tpu_tfrecord_torch.schema import ArrayType, BinaryType, DataType, StringType, StructType


def _is_bytes_like(dt: DataType) -> bool:
    if isinstance(dt, (StringType, BinaryType)):
        return True
    if isinstance(dt, ArrayType):
        return _is_bytes_like(dt.element_type)
    return False


def _validate_cast(schema: StructType, cast: Dict[str, np.dtype]) -> None:
    """Every cast key must name a numeric schema column: a typo'd name would
    otherwise skip the cast silently."""
    castable = {f.name for f in schema if not _is_bytes_like(f.data_type)}
    for name in cast:
        if name not in castable:
            raise ValueError(
                f"cast: no castable data column named {name!r} "
                f"(numeric columns: {sorted(castable)})"
            )


def hash_bytes_column(col_or_blobs, num_buckets: int) -> np.ndarray:
    """CRC32C of each byte string mod ``num_buckets``, as int32: the
    categorical-feature path (strings never go to the device). Accepts a
    bytes-like Column (its flat blob, hashed in one native call) or a plain
    list of bytes."""
    if isinstance(col_or_blobs, Column):
        col = col_or_blobs
        return _native.hash_blob(col.blob, col.blob_offsets, num_buckets).astype(np.int32)
    blobs = col_or_blobs
    crc = wire.crc32c
    return np.fromiter(
        (crc(b) % num_buckets for b in blobs), dtype=np.int32, count=len(blobs)
    )


def _pad_ragged_cast(col: Column, max_len: int, out_dtype) -> tuple:
    """One-level pad with an optional dtype cast, fused natively when the
    dtypes allow."""
    res = _native.pad_ragged_dense(col.values, col.offsets, max_len, out_dtype)
    if res is not None:
        return res
    dense, lengths = pad_ragged(col.values, col.offsets, max_len)
    if out_dtype is not None:
        dense = dense.astype(out_dtype, copy=False)
    return dense, lengths


def _pad_ragged2_cast(col: Column, lo: int, li: int, out_dtype) -> tuple:
    """Two-level pad with an optional dtype cast, fused natively when the
    dtypes allow."""
    res = _native.pad_ragged2_dense(
        col.values, col.inner_offsets, col.offsets, lo, li, out_dtype
    )
    if res is not None:
        return res
    dense, outer_len, inner_len = pad_ragged2(
        col.values, col.inner_offsets, col.offsets, lo, li
    )
    if out_dtype is not None:
        dense = dense.astype(out_dtype, copy=False)
    return dense, outer_len, inner_len


def _check_fused_buckets(col: Column, name: str, buckets: int) -> None:
    if col.hash_buckets is not None and col.hash_buckets != buckets:
        raise ValueError(
            f"{name}: decoded with hash_buckets={col.hash_buckets} but host "
            f"batch requests {buckets}"
        )


def host_batch_from_columnar(
    batch: ColumnarBatch,
    schema: StructType,
    pad_to: Optional[Dict[str, Union[int, tuple]]] = None,
    hash_buckets: Optional[Dict[str, int]] = None,
    include_lengths: bool = True,
    pack: Optional[Dict[str, List[str]]] = None,
    cast: Optional[Dict[str, np.dtype]] = None,
) -> Dict[str, np.ndarray]:
    """ColumnarBatch -> dict of dense numpy arrays.

    - numeric scalar column  -> (B,) of its numpy dtype
    - numeric array column   -> (B, L) + '<name>_len' (B,) int32
    - array-of-array column  -> (B, Lo, Li) + '<name>_len' (B,)
                                + '<name>_inner_len' (B, Lo)
    - string/binary column   -> (B,) int32 bucket ids iff hashed via
                                ``hash_buckets[name]`` (multi-hot: (B, K) +
                                lengths), else omitted

    ``pad_to`` gives L (or (Lo, Li)) for every ragged column. ``pack``
    groups same-dtype scalar columns into one [B, K] array; groups the
    dataset already packed are taken as they are. ``cast`` maps a numeric
    column to an output numpy dtype.
    """
    pad_to = pad_to or {}
    hash_buckets = hash_buckets or {}
    cast = cast or {}
    _validate_cast(schema, cast)
    if cast and pack:
        for group, names in pack.items():
            overlap = sorted(set(cast) & set(names))
            if overlap:
                raise ValueError(
                    f"cast: columns {overlap} are members of pack group "
                    f"{group!r}; casting packed members is not supported"
                )
    out: Dict[str, np.ndarray] = {}
    packed_members = set()
    for group, names in (pack or {}).items():
        if group in batch:
            out[group] = batch[group].values
            packed_members.update(names)
    for f in schema:
        if f.name in packed_members:
            continue
        col = batch[f.name]
        dt = f.data_type
        if _is_bytes_like(dt):
            if f.name not in hash_buckets:
                continue
            buckets = hash_buckets[f.name]
            if col.values is not None:  # hashed while decoding
                _check_fused_buckets(col, f.name, buckets)
                vals = col.values
            else:
                vals = hash_bytes_column(col, buckets)
            if col.is_ragged:
                # multi-hot categorical: ragged ids pad to [B, K] + lengths
                if f.name not in pad_to:
                    raise ValueError(
                        f"multi-hot column {f.name!r} requires pad_to[{f.name!r}]"
                    )
                dense, lengths = pad_ragged(vals, col.offsets, pad_to[f.name])
                out[f.name] = dense
                if include_lengths:
                    out[f.name + "_len"] = lengths
            else:
                out[f.name] = vals
            continue
        out_dtype = cast.get(f.name)
        if isinstance(dt, ArrayType):
            if isinstance(dt.element_type, ArrayType):
                lo, li = pad_to[f.name]
                dense, outer_len, inner_len = _pad_ragged2_cast(col, lo, li, out_dtype)
                out[f.name] = dense
                if include_lengths:
                    out[f.name + "_len"] = outer_len
                    out[f.name + "_inner_len"] = inner_len
            else:
                if f.name not in pad_to:
                    # padding to the per-batch max would make shapes vary
                    # from batch to batch
                    raise ValueError(
                        f"ragged column {f.name!r} requires pad_to[{f.name!r}]"
                    )
                dense, lengths = _pad_ragged_cast(col, pad_to[f.name], out_dtype)
                out[f.name] = dense
                if include_lengths:
                    out[f.name + "_len"] = lengths
        else:
            vals = col.values
            if out_dtype is not None:
                vals = vals.astype(out_dtype, copy=False)
            out[f.name] = vals
    for group, names in (pack or {}).items():
        if group not in out:
            out[group] = np.stack([out.pop(n) for n in names], axis=1)
    return out


def make_device_batch(
    host_batch: Dict[str, np.ndarray], device="cuda"
) -> Dict[str, torch.Tensor]:
    """Host numpy batch -> dict of tensors on ``device``. For a CUDA device
    each array goes through pinned host memory and is copied with
    ``non_blocking=True`` on the current stream, so the copies queue behind
    each other without blocking the host; the caller synchronizes (or just
    uses the tensors on the same stream)."""
    device = torch.device(device)
    out: Dict[str, torch.Tensor] = {}
    for name, arr in host_batch.items():
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        else:
            t = t.to(device)
        out[name] = t
    return out
