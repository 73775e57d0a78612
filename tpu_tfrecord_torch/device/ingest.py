"""Columnar host batches -> dense numpy host batches -> tensors on the device.

Port of ``tpu_tfrecord/tpu/ingest.py`` for one device. The host half
(``hash_bytes_column``, ``host_batch_from_columnar``) hashes through
``_native.hash_blob`` and pads ragged columns with the native fused pads
(``_native.pad_ragged_dense`` / ``pad_ragged2_dense``), falling back to the
numpy pads of ``columnar`` only for a dtype the native pads do not take.
``make_device_batch`` takes the place of ``make_global_batch``: each array
is copied into pinned host memory and sent with ``non_blocking=True`` on the
current stream.

The feed: ``HostPrefetcher`` runs a host-batch iterator on a thread behind
a bounded queue; ``DeviceIterator`` copies each host batch to the card on a
side stream out of a reused pinned ``StagingRing``, a batch ahead of the
consumer (or on a transfer thread), and hands the tensors over ordered
behind their copy on the consumer's stream.
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


def _torch_dtype(dtype: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype)).dtype


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
        self._buffers: List[Dict[tuple, Tuple[torch.Tensor, np.ndarray]]] = [
            {} for _ in range(slots)
        ]
        self._events: List[Optional[torch.cuda.Event]] = [None] * slots
        self._next = 0

    def stage(self, host: Dict[str, np.ndarray]) -> Tuple[int, Dict[str, torch.Tensor]]:
        slot = self._next
        self._next = (slot + 1) % len(self._buffers)
        event = self._events[slot]
        if event is not None:
            event.synchronize()  # the slot's last copy has read its buffers
        buffers = self._buffers[slot]
        out = {}
        for name, arr in host.items():
            key = (name, arr.shape, arr.dtype)
            if key not in buffers:
                pinned = torch.empty(arr.shape, dtype=_torch_dtype(arr.dtype), pin_memory=True)
                buffers[key] = (pinned, pinned.numpy())
            pinned, view = buffers[key]
            np.copyto(view, arr)
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

    The one-card counterpart of the JAX ``DeviceIterator``: ``device``
    takes the place of ``mesh`` and ``axis``; the JAX shardings
    (``data_shardings``, ``make_global_batch``) have no one-card meaning.

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
        host_batches: Iterable[Dict[str, np.ndarray]],
        device="cuda",
        transfer_thread: bool = False,
        depth: int = 2,
    ):
        self._it = iter(host_batches)
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

    def _transfer(self, host: Dict[str, np.ndarray], timed: bool = True) -> _Staged:
        t0 = time.perf_counter()
        if self.device.type != "cuda":
            staged = ({
                name: torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)
                for name, arr in host.items()
            }, None)
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
        return tensors

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
