"""Columnar host batches -> dense numpy host batches -> tensors on the device.

Port of ``tpu_tfrecord/tpu/ingest.py``. The host half
(``hash_bytes_column``, ``host_batch_from_columnar``) hashes through
``_native.hash_blob`` and pads ragged columns with the native fused pads
(``_native.pad_ragged_dense`` / ``pad_ragged2_dense``), falling back to the
numpy pads of ``columnar`` only for a dtype the native pads do not take.
``make_device_batch`` copies each array into pinned host memory and sends
it with ``non_blocking=True`` on the current stream. ``make_global_batch``
does the same on this rank's device of a ``DeviceMesh`` and wraps each
tensor as this rank's shard of a ``DTensor`` whose batch dim is sharded on
the mesh's data axis: the global batch is P x the local rows, as
``jax.make_array_from_process_local_data`` makes it. A column cast to
``torch.bfloat16`` travels as a CPU bf16 tensor (numpy has no bf16 dtype
of its own), everything else as numpy. ``TokenPacker`` packs ragged token
documents into causal-LM batches.

The feed: ``HostPrefetcher`` runs a host-batch iterator on a thread behind
a bounded queue; ``DeviceIterator`` copies each host batch to the card on a
side stream out of a reused pinned ``StagingRing``, a batch ahead of the
consumer (or on a transfer thread), and hands the tensors over ordered
behind their copy on the consumer's stream.

``batch_spec`` gives a global batch's shapes and dtypes ahead of any data,
as ``torch.empty(..., device="meta")`` tensors (the counterpart of
``jax.ShapeDtypeStruct``).
"""

from __future__ import annotations

import queue
import threading
import time
import weakref
from typing import Dict, Iterable, Iterator, List, Optional, Tuple, Union

import numpy as np
import torch

from tpu_tfrecord_torch import _native, wire
from tpu_tfrecord_torch.columnar import Column, ColumnarBatch, pad_ragged, pad_ragged2
from tpu_tfrecord_torch.metrics import METRICS
from tpu_tfrecord_torch.schema import (ArrayType, BinaryType, DataType, StringType, StructType,
                                       numpy_dtype)

# a host batch's array: numpy, or a CPU tensor for a dtype numpy lacks (bf16)
HostArray = Union[np.ndarray, torch.Tensor]
CastDtype = Union[np.dtype, torch.dtype]


def _is_bytes_like(dt: DataType) -> bool:
    if isinstance(dt, (StringType, BinaryType)):
        return True
    if isinstance(dt, ArrayType):
        return _is_bytes_like(dt.element_type)
    return False


def _validate_cast(schema: StructType, cast: Dict[str, CastDtype]) -> Dict[str, CastDtype]:
    """``cast`` with each dtype normalized: ``torch.bfloat16`` as it is,
    any other a numpy dtype. Every key must name a numeric schema column (a
    typo'd name would otherwise skip the cast silently), and a dtype the
    port cannot take raises, naming the column."""
    castable = {f.name for f in schema if not _is_bytes_like(f.data_type)}
    out: Dict[str, CastDtype] = {}
    for name, dtype in cast.items():
        if name not in castable:
            raise ValueError(
                f"cast: no castable data column named {name!r} "
                f"(numeric columns: {sorted(castable)})"
            )
        if dtype is torch.bfloat16:
            out[name] = dtype
            continue
        try:
            dt = (torch.empty(0, dtype=dtype).numpy().dtype
                  if isinstance(dtype, torch.dtype) else np.dtype(dtype))
        except TypeError as e:
            raise ValueError(f"cast: column {name!r} cannot be cast to {dtype!r}") from e
        if dt.kind not in "biuf":
            # numpy has no bfloat16 of its own: such a dtype comes from an
            # extension package, which the port does not use
            raise ValueError(
                f"cast: column {name!r} cannot be cast to {dt} "
                "(for bf16 pass torch.bfloat16)"
            )
        out[name] = dt
    return out


def _as_tensor(arr: HostArray) -> torch.Tensor:
    """A host array as a CPU tensor (a tensor as it is), contiguous. A
    read-only array (a view over the epoch cache's map) is copied: torch
    has no read-only tensor, and one over the map would alias the page
    cache."""
    if isinstance(arr, torch.Tensor):
        return arr.contiguous()
    if not arr.flags.writeable:
        return torch.from_numpy(np.array(arr, order="C"))
    return torch.from_numpy(np.ascontiguousarray(arr))


def _bf16(dense: np.ndarray, bits: bool) -> torch.Tensor:
    """A padded array as a CPU bf16 tensor: ``bits`` says it already holds
    bf16 bits as uint16 (the fused native pad), else it is cast (round to
    nearest even, as the native pad rounds)."""
    if bits:
        return torch.from_numpy(dense).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(dense)).to(torch.bfloat16)


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
    bf16 = out_dtype is torch.bfloat16
    res = _native.pad_ragged_dense(
        col.values, col.offsets, max_len, _native.BF16_BITS if bf16 else out_dtype
    )
    if res is None:
        dense, lengths = pad_ragged(col.values, col.offsets, max_len)
    else:
        dense, lengths = res
    if bf16:
        return _bf16(dense, res is not None), lengths
    if res is None and out_dtype is not None:
        dense = dense.astype(out_dtype, copy=False)
    return dense, lengths


def _pad_ragged2_cast(col: Column, lo: int, li: int, out_dtype) -> tuple:
    """Two-level pad with an optional dtype cast, fused natively when the
    dtypes allow."""
    bf16 = out_dtype is torch.bfloat16
    res = _native.pad_ragged2_dense(
        col.values, col.inner_offsets, col.offsets, lo, li,
        _native.BF16_BITS if bf16 else out_dtype,
    )
    if res is None:
        dense, outer_len, inner_len = pad_ragged2(
            col.values, col.inner_offsets, col.offsets, lo, li
        )
    else:
        dense, outer_len, inner_len = res
    if bf16:
        return _bf16(dense, res is not None), outer_len, inner_len
    if res is None and out_dtype is not None:
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
    cast: Optional[Dict[str, CastDtype]] = None,
) -> Dict[str, HostArray]:
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
    column to an output dtype: a numpy or torch dtype numpy has, or
    ``torch.bfloat16``, which gives the column as a CPU bf16 tensor (a
    float32 ragged column is padded and rounded in one native pass, at half
    the bytes to copy).
    """
    pad_to = pad_to or {}
    hash_buckets = hash_buckets or {}
    cast = _validate_cast(schema, cast or {})
    if cast and pack:
        for group, names in pack.items():
            overlap = sorted(set(cast) & set(names))
            if overlap:
                raise ValueError(
                    f"cast: columns {overlap} are members of pack group "
                    f"{group!r}; casting packed members is not supported"
                )
    out: Dict[str, HostArray] = {}
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
            if out_dtype is torch.bfloat16:
                vals = _bf16(vals, False)
            elif out_dtype is not None:
                vals = vals.astype(out_dtype, copy=False)
            out[f.name] = vals
    for group, names in (pack or {}).items():
        if group not in out:
            out[group] = np.stack([out.pop(n) for n in names], axis=1)
    return out


def batch_spec(
    schema: StructType,
    batch_size: int,
    pad_to: Optional[Dict[str, Union[int, tuple]]] = None,
    hash_buckets: Optional[Dict[str, int]] = None,
    include_lengths: bool = True,
    cast: Optional[Dict[str, CastDtype]] = None,
) -> Dict[str, torch.Tensor]:
    """Schema -> {name: meta tensor} of one global batch's shapes and
    dtypes, the keys and shapes ``host_batch_from_columnar`` gives:

    - numeric scalar column  -> (B,) of its dtype
    - numeric array column   -> (B, L) + '<name>_len' (B,) int32
    - array-of-array column  -> (B, Lo, Li) + '<name>_len' (B,)
                                + '<name>_inner_len' (B, Lo) int32
    - string/binary column   -> (B,) int32 iff hashed via
                                ``hash_buckets[name]`` (multi-hot: (B, K) +
                                '<name>_len'), else omitted

    ``pad_to`` gives L (or (Lo, Li), or K) for every ragged column.
    ``cast`` overrides a numeric column's dtype as in
    ``host_batch_from_columnar`` (``torch.bfloat16`` for bf16); a name
    that is no numeric column raises at once."""
    pad_to = pad_to or {}
    hash_buckets = hash_buckets or {}
    cast = _validate_cast(schema, cast or {})
    spec: Dict[str, torch.Tensor] = {}

    def meta(shape, dtype) -> torch.Tensor:
        if not isinstance(dtype, torch.dtype):
            dtype = torch.from_numpy(np.empty(0, dtype)).dtype
        return torch.empty(shape, dtype=dtype, device="meta")

    for f in schema:
        dt = f.data_type
        if _is_bytes_like(dt):
            if f.name in hash_buckets:
                if isinstance(dt, ArrayType):  # multi-hot: [B, K] + lengths
                    spec[f.name] = meta((batch_size, pad_to[f.name]), np.int32)
                    if include_lengths:
                        spec[f.name + "_len"] = meta((batch_size,), np.int32)
                else:
                    spec[f.name] = meta((batch_size,), np.int32)
            continue
        dtype = cast.get(f.name, numpy_dtype(dt))
        if isinstance(dt, ArrayType):
            if isinstance(dt.element_type, ArrayType):
                lo, li = pad_to[f.name]
                spec[f.name] = meta((batch_size, lo, li), dtype)
                if include_lengths:
                    spec[f.name + "_len"] = meta((batch_size,), np.int32)
                    spec[f.name + "_inner_len"] = meta((batch_size, lo), np.int32)
            else:
                spec[f.name] = meta((batch_size, pad_to[f.name]), dtype)
                if include_lengths:
                    spec[f.name + "_len"] = meta((batch_size,), np.int32)
        else:
            spec[f.name] = meta((batch_size,), dtype)
    return spec


def data_shardings(host_batch: Dict[str, HostArray], mesh, axis: str = "data") -> Dict[str, tuple]:
    """Batch-dim-on-``axis`` placements for every array of a host batch
    (``mesh.data_sharding``)."""
    from tpu_tfrecord_torch.device.mesh import data_sharding

    return {name: data_sharding(mesh, axis, arr.ndim) for name, arr in host_batch.items()}


def _as_global(tensors: Dict[str, torch.Tensor], mesh, shardings: Dict[str, tuple]) -> dict:
    """Each rank-local tensor as this rank's shard of a global ``DTensor``;
    no collective runs (``run_check=False``), so every rank must hold the
    same number of rows."""
    from torch.distributed.tensor import DTensor

    return {name: DTensor.from_local(t, mesh, shardings[name], run_check=False)
            for name, t in tensors.items()}


def make_global_batch(
    host_batch: Dict[str, HostArray], mesh, axis: str = "data",
    shardings: Optional[Dict[str, tuple]] = None,
) -> dict:
    """Per-process host batch -> {name: ``DTensor``} on ``mesh``, the batch
    dim sharded on ``axis``: this rank's rows are copied to its device
    (``make_device_batch``) and become its shard, so across P processes the
    global batch dim is P x the local rows. Every process must pass the
    same number of rows (``drop_remainder=True`` keeps a batch's rows
    equal; processes with more shards also run more batches)."""
    from tpu_tfrecord_torch.device.mesh import mesh_device

    if shardings is None:
        shardings = data_shardings(host_batch, mesh, axis)
    return _as_global(make_device_batch(host_batch, mesh_device(mesh)), mesh, shardings)


def make_device_batch(
    host_batch: Dict[str, HostArray], device="cuda"
) -> Dict[str, torch.Tensor]:
    """Host batch (numpy arrays or CPU tensors) -> dict of tensors on
    ``device``. For a CUDA device each array goes through pinned host memory and is copied with
    ``non_blocking=True`` on the current stream, so the copies queue behind
    each other without blocking the host; the caller synchronizes (or just
    uses the tensors on the same stream)."""
    device = torch.device(device)
    out: Dict[str, torch.Tensor] = {}
    for name, arr in host_batch.items():
        t = _as_tensor(arr)
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        else:
            t = t.to(device)
        out[name] = t
    return out


# -- packing token documents ----------------------------------------------------


class TokenPacker:
    """Ragged token documents -> packed causal-LM batches [B, L+1] int32:
    port of the JAX ``TokenPacker``, with the same batches and the same
    ``state()`` JSON, so a carry saved by either package restores in the
    other.

    Three packing modes (``packing``):

    - ``"slice"`` (default): documents are concatenated, each followed by
      ``eos_id``, and cut into windows of L+1 tokens (the model reads
      ``row[:-1]`` and scores ``row[1:]``). No padding, no masks; the tail
      carries into the next batch. Documents are split across rows, and a
      row mixes documents with no boundary signal.
    - ``"first_fit"`` / ``"best_fit"``: bin packing. Each document plus its
      EOS (split into L+1-sized chunks when longer, each chunk its own
      segment) goes whole into one of up to B open row-bins of capacity
      L+1: the lowest-indexed bin it fits (first_fit) or the fitting bin
      with the least room left, ties to the lowest index (best_fit). When a
      chunk fits no bin and B are open, the batch closes: rows pad to L+1
      with EOS and ``pop()`` returns ``{"tokens": [B, L+1], "segment_ids":
      [B, L+1]}``, ids numbering each row's documents 1..k in placement
      order and 0 on padding (the block-diagonal mask of
      ``models.attention``'s ``segments``). ``density()`` is the non-pad
      share of the tokens emitted.

    The carry (residual tokens or open bins, and the packed batches not
    yet popped) is the only state: ``state()`` / ``restore()``, a small
    JSON payload a trainer saves beside the dataset's position.
    """

    _MODES = ("slice", "first_fit", "best_fit")

    def __init__(
        self, batch_size: int, seq_len: int, eos_id: int = 0,
        packing: str = "slice",
    ):
        if batch_size < 1 or seq_len < 1:
            raise ValueError(
                f"batch_size and seq_len must be >= 1, got "
                f"({batch_size}, {seq_len})"
            )
        if packing not in self._MODES:
            raise ValueError(
                f"packing must be one of {self._MODES}, got {packing!r}"
            )
        self.batch_size = batch_size
        self.seq_len = seq_len
        self.eos_id = int(eos_id)
        self.packing = packing
        self._buf: List[np.ndarray] = []   # slice mode: chunks, joined lazily
        self._buf_len = 0
        self._bins: List[List[np.ndarray]] = []   # bin modes: open row-bins
        self._pending: List[Union[np.ndarray, Dict[str, np.ndarray]]] = []
        self._emitted_tokens = 0
        self._emitted_nonpad = 0

    def feed_docs(self, docs: Iterable[np.ndarray]) -> None:
        """Append documents (1-D int arrays) to the stream, EOS after each."""
        eos = np.asarray([self.eos_id], np.int32)
        if self.packing != "slice":
            cap = self.seq_len + 1
            for doc in docs:
                arr = np.concatenate(
                    [np.asarray(doc).astype(np.int32, copy=False).reshape(-1), eos]
                )
                for at in range(0, arr.size, cap):
                    self._place_chunk(arr[at : at + cap])
            return
        for doc in docs:
            arr = np.asarray(doc).astype(np.int32, copy=False).reshape(-1)
            self._buf.append(arr)
            self._buf.append(eos)
            self._buf_len += arr.size + 1
        self._drain()

    def _place_chunk(self, chunk: np.ndarray) -> None:
        cap = self.seq_len + 1
        fit = -1
        if self.packing == "best_fit":
            best_room = cap + 1
            for i, b in enumerate(self._bins):
                room = cap - sum(c.size for c in b)
                if chunk.size <= room < best_room:
                    fit, best_room = i, room
        else:
            for i, b in enumerate(self._bins):
                if chunk.size <= cap - sum(c.size for c in b):
                    fit = i
                    break
        if fit >= 0:
            self._bins[fit].append(chunk)
            return
        if len(self._bins) == self.batch_size:
            self._close_bins()
        self._bins.append([chunk])

    def _close_bins(self) -> None:
        """The B open bins as one pending {tokens, segment_ids} batch."""
        cap = self.seq_len + 1
        toks = np.full((self.batch_size, cap), self.eos_id, np.int32)
        segs = np.zeros((self.batch_size, cap), np.int32)
        nonpad = 0
        for r, b in enumerate(self._bins):
            at = 0
            for s, chunk in enumerate(b):
                toks[r, at : at + chunk.size] = chunk
                segs[r, at : at + chunk.size] = s + 1
                at += chunk.size
            nonpad += at
        self._bins = []
        self._pending.append({"tokens": toks, "segment_ids": segs})
        self._emitted_tokens += self.batch_size * cap
        self._emitted_nonpad += nonpad
        METRICS.gauge("pack.density", round(self.density(), 4))

    def density(self) -> float:
        """Share of the emitted batch tokens that are document tokens (1.0
        before a bin-mode batch closes, and always in slice mode)."""
        if not self._emitted_tokens:
            return 1.0
        return self._emitted_nonpad / self._emitted_tokens

    def feed_column(self, col: Column) -> None:
        """Feed a ragged int ``Column`` of a ``ColumnarBatch``: its offsets
        are the document boundaries."""
        values = np.asarray(col.values)
        offsets = np.asarray(col.offsets)
        self.feed_docs(
            values[offsets[i] : offsets[i + 1]] for i in range(len(offsets) - 1)
        )

    def _drain(self) -> None:
        need = self.batch_size * (self.seq_len + 1)
        if self._buf_len < need:
            return
        flat = np.concatenate(self._buf) if len(self._buf) > 1 else self._buf[0]
        n_batches = flat.size // need
        for i in range(n_batches):
            self._pending.append(
                flat[i * need : (i + 1) * need]
                .reshape(self.batch_size, self.seq_len + 1)
                .copy()
            )
        rest = flat[n_batches * need :]
        self._buf = [rest] if rest.size else []
        self._buf_len = int(rest.size)

    def pop(self):
        """The next ready batch, or None when more documents are needed: a
        [B, L+1] int32 array in slice mode, ``{"tokens", "segment_ids"}``
        in the bin modes."""
        return self._pending.pop(0) if self._pending else None

    def state(self) -> dict:
        """The JSON-able carry, in the JAX packer's layout: slice mode
        ``{residual, pending}``; the bin modes the open bins (chunk lists),
        the pending batches and the density counts."""
        if self.packing == "slice":
            flat = np.concatenate(self._buf).tolist() if self._buf else []
            return {"residual": flat, "pending": [b.tolist() for b in self._pending]}
        return {
            "bins": [[c.tolist() for c in b] for b in self._bins],
            "pending": [
                {"tokens": d["tokens"].tolist(), "segment_ids": d["segment_ids"].tolist()}
                for d in self._pending
            ],
            "emitted_tokens": self._emitted_tokens,
            "emitted_nonpad": self._emitted_nonpad,
        }

    def restore(self, state: dict) -> None:
        if self.packing == "slice":
            residual = np.asarray(state.get("residual", []), np.int32)
            self._buf = [residual] if residual.size else []
            self._buf_len = int(residual.size)
            self._pending = [np.asarray(b, np.int32) for b in state.get("pending", [])]
            return
        self._bins = [[np.asarray(c, np.int32) for c in b] for b in state.get("bins", [])]
        self._pending = [
            {
                "tokens": np.asarray(d["tokens"], np.int32),
                "segment_ids": np.asarray(d["segment_ids"], np.int32),
            }
            for d in state.get("pending", [])
        ]
        self._emitted_tokens = int(state.get("emitted_tokens", 0))
        self._emitted_nonpad = int(state.get("emitted_nonpad", 0))


# -- the feed ------------------------------------------------------------------


def _put(q: queue.Queue, item, stop: threading.Event) -> bool:
    """Enqueue, polling ``stop`` so that a consumer that went away never
    leaves the worker blocked on a full queue."""
    while not stop.is_set():
        try:
            q.put(item, timeout=0.1)
            return True
        except queue.Full:
            continue
    return False


_DONE = object()  # the end of a HostPrefetcher's stream


def _prefetch(source: Iterable, q: queue.Queue, stop: threading.Event) -> None:
    """HostPrefetcher's worker: the items of ``source``, then ``_DONE`` or
    the exception that stopped it. A module-level function, so the thread
    holds no reference to the prefetcher and an abandoned one can be
    collected."""
    try:
        for item in source:
            if not _put(q, item, stop):
                return
        _put(q, _DONE, stop)
    except BaseException as e:  # re-raised in the consumer by __next__
        _put(q, e, stop)


class HostPrefetcher:
    """Run an iterator on a background thread behind a bounded queue of
    ``depth`` items, so that the host's work on each batch (densify,
    ``log1p``, the wire packing) leaves the consumer's thread. Item-type
    agnostic. Iterate it, or use it as a context manager.

    - An exception in the iterator is raised at its item, and again on
      every later ``next()``.
    - ``close()`` stops the thread, drops what it queued and joins it;
      ``next()`` after ``close()`` raises ``StopIteration``. A thread
      blocked inside the source's own ``next()`` is joined when that
      returns.
    """

    def __init__(self, host_batches: Iterable, depth: int = 2):
        self._queue: queue.Queue = queue.Queue(maxsize=max(1, depth))
        self._stop = threading.Event()
        self._finished: Optional[object] = None
        self._thread = threading.Thread(
            target=_prefetch, args=(host_batches, self._queue, self._stop),
            name="host-prefetcher", daemon=True,
        )
        # a prefetcher dropped without close() still stops its thread
        self._finalizer = weakref.finalize(self, self._stop.set)
        self._thread.start()

    def __iter__(self) -> "HostPrefetcher":
        return self

    def __next__(self):
        # the end or the exception arrives on the queue once: keep it, so a
        # later next() raises again instead of waiting on a finished thread
        if self._finished is not None:
            if self._finished is _DONE:
                raise StopIteration
            raise self._finished
        while True:
            try:
                item = self._queue.get(timeout=0.1)
                break
            except queue.Empty:
                if self._stop.is_set():  # close()d from another thread
                    self._finished = _DONE
                    raise StopIteration
        if item is _DONE:
            self._finished = item
            raise StopIteration
        if isinstance(item, BaseException):
            self._finished = item
            raise item
        return item

    def close(self) -> None:
        self._stop.set()
        if self._finished is None:
            self._finished = _DONE
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass
        self._thread.join()

    def __enter__(self) -> "HostPrefetcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _torch_dtype(arr: HostArray) -> torch.dtype:
    if isinstance(arr, torch.Tensor):
        return arr.dtype
    return torch.from_numpy(np.empty(0, arr.dtype)).dtype


class StagingRing:
    """Pinned host buffers for the host-to-device copies, allocated once
    and reused: ``slots`` slots, each holding one buffer per (name, shape,
    dtype) it has staged and the event recorded behind its last copy.

    ``stage(host)`` takes the next slot, waits until that slot's last copy
    has completed, and copies the host arrays into its buffers; the caller
    issues the copies out of them and then ``done(slot, event)``. The
    buffers of a slot keep their addresses from batch to batch, so a CUDA
    graph can replay copies out of them into static device buffers.
    """

    def __init__(self, slots: int):
        self._buffers: List[Dict[tuple, torch.Tensor]] = [{} for _ in range(slots)]
        self._events: List[Optional[torch.cuda.Event]] = [None] * slots
        self._next = 0

    def stage(self, host: Dict[str, HostArray]) -> Tuple[int, Dict[str, torch.Tensor]]:
        slot = self._next
        self._next = (slot + 1) % len(self._buffers)
        event = self._events[slot]
        if event is not None:
            event.synchronize()  # the slot's last copy has read its buffers
        buffers = self._buffers[slot]
        out = {}
        for name, arr in host.items():
            dtype = _torch_dtype(arr)
            key = (name, tuple(arr.shape), dtype)
            if key not in buffers:
                buffers[key] = torch.empty(arr.shape, dtype=dtype, pin_memory=True)
            pinned = buffers[key]
            if isinstance(arr, torch.Tensor):
                pinned.copy_(arr)
            else:
                # one copy, read-only views over the cache's map included
                np.copyto(pinned.numpy(), arr)
            out[name] = pinned
        return slot, out

    def done(self, slot: int, event: torch.cuda.Event) -> None:
        self._events[slot] = event


# a batch on its way to the device: its tensors and the event recorded
# behind their copies (None on the CPU)
_Staged = Tuple[Dict[str, torch.Tensor], Optional[torch.cuda.Event]]


class DeviceIterator:
    """Host batches -> tensors on one device, the copy of batch N+1 issued
    while the consumer computes on batch N.

    Without a ``mesh`` it feeds ``device``. With a ``mesh`` (the JAX
    ``DeviceIterator``'s), the tensors go to this rank's device of the
    mesh and each batch is handed over as ``make_global_batch`` gives it:
    ``DTensor``s built on the tensors already copied, with no second copy.

    On a CUDA device each host array is copied into a ``StagingRing`` slot
    (``depth + 1`` slots) and from there with ``non_blocking=True`` on a
    side stream, into tensors allocated on that stream; an event is
    recorded behind the copies. ``next()`` makes the consumer's current
    stream wait for that event and marks each tensor with
    ``record_stream``, so the caching allocator does not hand its memory
    out while the consumer's work on it is queued. Nothing synchronizes
    the host with the card, apart from waiting for a ring slot whose copy
    is still running.

    - dispatch-ahead (the default): ``next()`` issues the next batch's copy
      before it returns the current one;
    - ``transfer_thread=True``: a ``HostPrefetcher`` worker issues each
      copy and waits for its event, ``depth`` device batches ahead.

    On a CPU device a batch is a plain ``.to(device)``: no stream, no
    pinning. ``transfer_seconds`` is the host's cumulative time spent
    transferring: issuing the copies (host copy into the ring included),
    plus the wait for their completion on the transfer thread. Use
    ``close()`` or a ``with`` block to release the worker.
    """

    def __init__(
        self,
        host_batches: Iterable[Dict[str, HostArray]],
        device="cuda",
        transfer_thread: bool = False,
        depth: int = 2,
        mesh=None,
        axis: str = "data",
    ):
        self._it = iter(host_batches)
        self._mesh = mesh
        self._axis = axis
        if mesh is not None:
            from tpu_tfrecord_torch.device.mesh import mesh_device

            device = mesh_device(mesh)
        self.device = torch.device(device)
        self._pending: Optional[_Staged] = None
        self._pf: Optional[HostPrefetcher] = None
        self.transfer_seconds = 0.0
        if self.device.type == "cuda":
            self._stream = torch.cuda.Stream(self.device)
            self._ring = StagingRing(depth + 1)
        if transfer_thread:
            def _transferred():
                for host in self._it:
                    t0 = time.perf_counter()
                    staged = self._transfer(host, timed=False)
                    if staged[1] is not None:
                        staged[1].synchronize()
                    self.transfer_seconds += time.perf_counter() - t0
                    yield staged

            self._pf = HostPrefetcher(_transferred(), depth=depth)

    def _transfer(self, host: Dict[str, HostArray], timed: bool = True) -> _Staged:
        t0 = time.perf_counter()
        if self.device.type != "cuda":
            staged = ({name: _as_tensor(arr).to(self.device) for name, arr in host.items()},
                      None)
        else:
            slot, pinned = self._ring.stage(host)
            with torch.cuda.stream(self._stream):
                tensors = {}
                for name, src in pinned.items():
                    dst = torch.empty(src.shape, dtype=src.dtype, device=self.device)
                    dst.copy_(src, non_blocking=True)
                    tensors[name] = dst
                event = torch.cuda.Event(blocking=True)
                event.record(self._stream)
            self._ring.done(slot, event)
            staged = (tensors, event)
        if timed:  # the transfer thread times the copy and its wait together
            self.transfer_seconds += time.perf_counter() - t0
        return staged

    def _hand_over(self, staged: _Staged) -> Dict[str, torch.Tensor]:
        tensors, event = staged
        if event is not None:
            consumer = torch.cuda.current_stream(self.device)
            consumer.wait_event(event)
            for t in tensors.values():
                t.record_stream(consumer)
        if self._mesh is None:
            return tensors
        return _as_global(tensors, self._mesh, data_shardings(tensors, self._mesh, self._axis))

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        return self

    def __next__(self) -> Dict[str, torch.Tensor]:
        if self._pf is not None:
            return self._hand_over(next(self._pf))
        if self._pending is None:
            self._pending = self._transfer(next(self._it))  # StopIteration at the end
        current, self._pending = self._pending, None
        try:
            nxt = next(self._it)
        except StopIteration:
            return self._hand_over(current)
        self._pending = self._transfer(nxt)
        return self._hand_over(current)

    def close(self) -> None:
        """Release the transfer worker (nothing to do without one)."""
        if self._pf is not None:
            self._pf.close()

    def __enter__(self) -> "DeviceIterator":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
