"""Streaming batched read of a TFRecord dataset into ColumnarBatches.

Single-process cut of ``tpu_tfrecord/io/dataset.py::TFRecordDataset`` along
the JAX package's main path:

- the native decoder (``_native.NativeDecoder``): a local uncompressed shard
  is mmapped and scanned + decoded in one C++ pass per chunk of
  ``max(batch_size, 2048)`` records; a gzip or deflate shard streams in
  slabs of complete frames through ``_native.scan_partial`` and
  ``decode_spans``. A record type or schema the C++ side cannot represent
  (``ByteArray``, ``UnsupportedSchemaError``) decodes with the Python
  ``ColumnarDecoder``; ``decoder="python"`` asks for that decoder on any
  schema (the tests' oracle). A library that fails to build raises;
- ``hash_buckets`` and ``pack`` shape the batch as the native decoder does
  (with either decoder): a hashed bytes column carries int32 bucket ids in
  ``values`` (``Column.hash_buckets`` set), and each pack group is one
  ``[B, K]`` matrix column in place of its members;
- a background producer thread decodes ahead into a queue of ``PREFETCH``
  batches; the native calls release the GIL, so decode overlaps the
  consumer. Batches cross chunks, shards and epochs: a chunk that is
  exactly one batch passes through with no copy, anything else is cut and
  joined with ``slice_batch`` / ``concat_batches``;
- ``num_workers`` > 1 decodes that many shards at a time in a thread pool
  (``_parallel_chunks``): a dispatcher hands the shard tasks to the
  workers, each shard decodes into a bounded queue of its own, and the
  producer drains those queues in task order, so the chunks, and hence the
  batches, are the sequential ones for any worker count.

- ``shuffle`` permutes the shard order of each epoch with a permutation
  drawn from ``(seed, epoch)``, over every shard, empty ones included;
  ``shuffle_window`` > 0 permutes rows inside windows of that many batches,
  each window's permutation seeded by ``seed`` and the window's start
  position ``(epoch, shard cursor, record offset)``. Windows cross shards
  and epochs; the last, short window keeps its partial batch unless
  ``drop_remainder``. Batches equal the JAX dataset's for the same
  arguments.

Left out against the JAX dataset: checkpointable positions (the
positions above only seed the windows), the decode pool's watchdog and its
autotuned resizing (``control``), stall defense, caching, the data
service, partition columns and column selection.
"""

from __future__ import annotations

import collections
import contextlib
import mmap
import os
import queue
import threading
import weakref
from typing import Deque, Dict, Iterator, List, Optional, Tuple

import numpy as np

from tpu_tfrecord_torch import _native, wire
from tpu_tfrecord_torch.columnar import (
    Column,
    ColumnarBatch,
    ColumnarDecoder,
    concat_batches,
    slice_batch,
    take_rows,
)
from tpu_tfrecord_torch.infer import infer_from_records, type_map_to_schema
from tpu_tfrecord_torch.io.paths import discover_shards
from tpu_tfrecord_torch.options import RecordType, TFRecordOptions
from tpu_tfrecord_torch.schema import StructType

DECODERS = ("native", "python")
MIN_CHUNK_RECORDS = 2048
PREFETCH = 2  # decoded batches queued ahead of the consumer
SLAB_BYTES = 32 << 20  # decompressed bytes read at a time from a compressed shard
# a declared record length past this is a corrupt length field
MAX_RECORD_BYTES = 1 << 30


class TFRecordDataset:
    """Plan a streaming read: ``TFRecordDataset(paths, batch_size,
    schema=None, recordType="Example", hash_buckets=None, pack=None,
    drop_remainder=True, num_epochs=1, decoder="native", shuffle=False,
    shuffle_window=0, seed=0, num_workers=1)``. Without a schema, it is
    inferred from the first non-empty shard. ``num_epochs=None`` repeats the
    shards without end. ``num_workers`` shards decode at a time (values
    below 1 count as 1)."""

    def __init__(
        self,
        paths,
        batch_size: int,
        schema: Optional[StructType] = None,
        recordType="Example",
        hash_buckets: Optional[Dict[str, int]] = None,
        pack: Optional[Dict[str, List[str]]] = None,
        drop_remainder: bool = True,
        num_epochs: Optional[int] = 1,
        decoder: str = "native",
        shuffle: bool = False,
        shuffle_window: int = 0,
        seed: int = 0,
        num_workers: int = 1,
    ):
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        if num_epochs is not None and num_epochs < 1:
            raise ValueError(f"num_epochs must be >= 1 or None, got {num_epochs}")
        if decoder not in DECODERS:
            raise ValueError(f"decoder must be one of {DECODERS}, got {decoder!r}")
        if shuffle_window < 0:
            raise ValueError(f"shuffle_window must be >= 0, got {shuffle_window}")
        self.shuffle = shuffle
        self.shuffle_window = shuffle_window
        self.seed = seed
        self.num_workers = max(1, num_workers)
        self.options = TFRecordOptions.from_map(recordType=recordType, schema=schema)
        self.batch_size = batch_size
        self.drop_remainder = drop_remainder
        self.num_epochs = num_epochs
        self.shards = discover_shards(paths)
        self.schema: StructType = (
            self.options.schema if self.options.schema is not None else self._infer_schema()
        )
        rt = self.options.record_type
        self._decoder = ColumnarDecoder(self.schema, rt)
        self.hash_buckets = _native.validate_hash_buckets(self.schema, hash_buckets)
        self.pack = _native.validate_pack(self.schema, pack, self.hash_buckets)
        self._native_decoder = (
            _native.make_decoder(self.schema, rt, self.hash_buckets, self.pack)
            if decoder == "native"
            else None
        )

    @property
    def decoder(self) -> str:
        """'native' or 'python': the decoder this dataset's batches come from."""
        return "python" if self._native_decoder is None else "native"

    def _infer_schema(self) -> StructType:
        """Schema of the first non-empty shard whose records yield one."""
        rt = self.options.record_type
        if rt == RecordType.BYTE_ARRAY:
            from tpu_tfrecord_torch.infer import byte_array_schema

            return byte_array_schema()
        for shard in self.shards:
            if shard.size == 0:
                continue
            type_map = infer_from_records(wire.read_records(shard.path), rt)
            if type_map:
                return type_map_to_schema(type_map)
        raise ValueError(
            "Could not infer schema: no non-empty TFRecord file found"
            if self.shards
            else "Could not infer schema: no input files"
        )

    # -- decode chunks ---------------------------------------------------------

    def epoch_order(self, epoch: int) -> List[int]:
        """The order of the shard list in ``epoch``: as listed, or with
        ``shuffle`` a permutation drawn from ``(seed, epoch)`` alone."""
        if not self.shuffle:
            return list(range(len(self.shards)))
        rng = np.random.default_rng((self.seed, epoch))
        return rng.permutation(len(self.shards)).tolist()

    def _shard_tasks(self) -> Iterator[Tuple[int, int, int]]:
        """(epoch, cursor, shard index) of every non-empty shard of every
        epoch, lazily (epochs may be endless): ``cursor`` is the shard's
        position in the epoch's order."""
        if not any(sh.size for sh in self.shards):
            return
        epoch = 0
        while self.num_epochs is None or epoch < self.num_epochs:
            for cursor, index in enumerate(self.epoch_order(epoch)):
                if self.shards[index].size:
                    yield epoch, cursor, index
            epoch += 1

    def _decode_shard(
        self, epoch: int, cursor: int, index: int
    ) -> Iterator[Tuple[ColumnarBatch, int, int, int]]:
        """(chunk, epoch, cursor, start) of one shard's decoded chunks:
        ``start`` is the index of the chunk's first record in the shard."""
        chunk_records = max(self.batch_size, MIN_CHUNK_RECORDS)
        path = self.shards[index].path
        if self._native_decoder is None:
            chunks = self._python_chunks(path, chunk_records)
        elif wire.codec_from_path(path) is None:
            chunks = self._mmap_chunks(path, chunk_records)
        else:
            chunks = self._slab_chunks(path, chunk_records)
        start = 0
        for chunk in chunks:
            yield chunk, epoch, cursor, start
            start += chunk.num_rows

    def _chunks(
        self, stop: Optional[threading.Event] = None
    ) -> Iterator[Tuple[ColumnarBatch, int, int, int]]:
        """(chunk, epoch, cursor, start) for the decoded chunks of every
        epoch, in task order; with ``num_workers`` > 1 from the decode pool,
        which ``stop`` (or closing this generator) stops and joins."""
        if self.num_workers > 1:
            yield from _parallel_chunks(self, stop or threading.Event())
            return
        for task in self._shard_tasks():
            yield from self._decode_shard(*task)

    def _mmap_chunks(self, path: str, chunk_records: int) -> Iterator[ColumnarBatch]:
        """A local uncompressed shard: mmap it and scan + decode straight out
        of the page cache, one native call per chunk."""
        dec = self._native_decoder
        with open(path, "rb") as fh:
            size = os.fstat(fh.fileno()).st_size
            if size == 0:
                return
            mm = mmap.mmap(fh.fileno(), 0, prot=mmap.PROT_READ)
            buf = np.frombuffer(mm, np.uint8)
            try:
                pos = 0
                while True:
                    cb, _, n_done, pos = dec.scan_decode(
                        buf, pos, True, 0, chunk_records,
                        length=size, max_record_bytes=MAX_RECORD_BYTES,
                    )
                    if n_done == 0:
                        if pos != size:  # a partial frame is all that is left
                            raise wire.TFRecordCorruptionError(
                                f"truncated TFRecord at end of {path}"
                            )
                        return
                    yield cb
            finally:
                # decoded chunks copy or own their bytes, so only this view
                # exports the map's buffer, unless an exception's traceback
                # still holds it: then the map closes when that is collected
                del buf
                try:
                    mm.close()
                except BufferError:
                    pass

    def _slab_spans(self, path: str) -> Iterator[tuple]:
        """A compressed shard as (buf, offsets, lengths) slabs of complete
        frames: a partial trailing frame carries into the next slab, and a
        declared length past MAX_RECORD_BYTES raises instead of buffering
        the rest of a corrupt shard."""
        with wire.open_compressed(path, "rb", wire.codec_from_path(path)) as fh:
            carry = b""
            while True:
                want = SLAB_BYTES
                if len(carry) >= 8:
                    declared = int.from_bytes(carry[:8], "little")
                    if declared > MAX_RECORD_BYTES:
                        raise wire.TFRecordCorruptionError(
                            f"record length {declared} exceeds {MAX_RECORD_BYTES} "
                            f"in {path}: corrupt length field?"
                        )
                    want = max(want, 16 + declared - len(carry))
                data = fh.read(want)
                if not data:
                    if carry:
                        raise wire.TFRecordCorruptionError(
                            f"truncated TFRecord at end of {path}"
                        )
                    return
                buf = carry + data if carry else data
                offsets, lengths, consumed = _native.scan_partial(buf)
                carry = buf[consumed:]
                if len(offsets):
                    yield buf, offsets, lengths

    def _slab_chunks(self, path: str, chunk_records: int) -> Iterator[ColumnarBatch]:
        dec = self._native_decoder
        for buf, offsets, lengths in self._slab_spans(path):
            for start in range(0, len(offsets), chunk_records):
                stop = start + chunk_records
                yield dec.decode_spans(buf, offsets[start:stop], lengths[start:stop])

    def _python_chunks(self, path: str, chunk_records: int) -> Iterator[ColumnarBatch]:
        records: List[bytes] = []
        for rec in wire.read_records(path):
            records.append(rec)
            if len(records) == chunk_records:
                yield self._python_decode(records)
                records = []
        if records:
            yield self._python_decode(records)

    def _python_decode(self, records: List[bytes]) -> ColumnarBatch:
        """``ColumnarDecoder``, then the hashing and packing that the native
        decoder fuses into its decode."""
        from tpu_tfrecord_torch.device.ingest import hash_bytes_column

        batch = self._decoder.decode_batch(records)
        cols = dict(batch.columns)
        for name, buckets in self.hash_buckets.items():
            col = cols[name]
            cols[name] = Column(
                name,
                col.dtype,
                values=hash_bytes_column(col, buckets),
                offsets=col.offsets,
                mask=col.mask,
                hash_buckets=buckets,
            )
        for gname, members in self.pack.items():
            # like the native decoder: the group keeps the first member's
            # schema type and drops per-member validity (missing -> 0)
            values = np.stack([cols.pop(m).values for m in members], axis=1)
            cols[gname] = Column(gname, self.schema[members[0]].data_type, values=values)
        return ColumnarBatch(cols, batch.num_rows)

    # -- batches ---------------------------------------------------------------

    def batches(self) -> "BatchIterator":
        """One run over ``num_epochs`` epochs, decoded ahead by a producer
        thread. Use it in a ``with`` block (or call ``close()``) so an early
        exit stops and joins the thread."""
        return BatchIterator(self)


def _take(pending: Deque[list], n: int) -> ColumnarBatch:
    """The next ``n`` rows of the pending [chunk, rows_used] entries."""
    chunk, used = pending[0]
    if used == 0 and chunk.num_rows == n:
        # aligned: the chunk is the batch, its buffers pass through uncopied
        pending.popleft()
        return chunk
    parts = []
    while n:
        entry = pending[0]
        chunk, used = entry
        take = min(n, chunk.num_rows - used)
        parts.append(slice_batch(chunk, used, used + take))
        n -= take
        entry[1] = used + take
        if entry[1] == chunk.num_rows:
            pending.popleft()
    return concat_batches(parts)


def _put(out: queue.Queue, item, stop: threading.Event) -> bool:
    """Enqueue, polling ``stop`` so that a consumer that went away never
    leaves the producer blocked on a full queue."""
    while not stop.is_set():
        try:
            out.put(item, timeout=0.1)
            return True
        except queue.Full:
            continue
    return False


def _produce(ds: TFRecordDataset, out: queue.Queue, stop: threading.Event) -> None:
    """The producer thread: batches, then None at the end, or the exception
    that stopped it. A module-level function, so the thread holds no
    reference to the iterator and an abandoned iterator can be collected."""
    try:
        with contextlib.closing(ds._chunks(stop)) as chunks:
            emit = _emit_shuffled if ds.shuffle_window else _emit_in_order
            if not emit(ds, chunks, out, stop):
                return
        _put(out, None, stop)
    except BaseException as e:  # re-raised in the consumer by BatchIterator.__next__
        _put(out, e, stop)


def _emit_in_order(ds: TFRecordDataset, chunks, out: queue.Queue, stop: threading.Event) -> bool:
    """Cut the chunk stream into batches in stream order; False if the
    consumer went away."""
    pending: Deque[list] = collections.deque()
    avail = 0
    for chunk, *_ in chunks:
        if stop.is_set():
            return False
        if chunk.num_rows == 0:
            continue
        pending.append([chunk, 0])
        avail += chunk.num_rows
        while avail >= ds.batch_size:
            if not _put(out, _take(pending, ds.batch_size), stop):
                return False
            avail -= ds.batch_size
    if avail and not ds.drop_remainder:
        return _put(out, _take(pending, avail), stop)
    return True


class _ShardJob:
    """One shard's decode in the pool: its task, and the bounded queue its
    worker fills with ("chunk", tuple), then ("end", None) or ("error",
    exception)."""

    __slots__ = ("task", "out")

    def __init__(self, task: Tuple[int, int, int], depth: int):
        self.task = task
        self.out: queue.Queue = queue.Queue(maxsize=depth)


SHARD_QUEUE_CHUNKS = 2  # decoded chunks a worker may hold ahead of the producer


def _parallel_chunks(ds: TFRecordDataset, stop: threading.Event) -> Iterator[tuple]:
    """Ordered parallel shard decode, the JAX ``_parallel_chunks`` without
    its watchdog and its resizable pool.

    A dispatcher enumerates the shard tasks lazily and hands each to
    ``ds.num_workers`` workers through a task queue, after queueing its job
    on the order queue; both queues hold ``num_workers`` jobs, so at most
    about twice that many shards are decoded or waiting at a time. This
    generator (run by the producer) drains the jobs' queues in task order,
    so its chunks are the sequential stream's. A worker's exception is
    raised here, where its shard's chunks stop. ``stop``, the end of the
    stream, an error or closing the generator stops every thread, and the
    generator joins them before it returns."""
    n_workers = ds.num_workers
    halt = threading.Event()
    task_q: queue.Queue = queue.Queue(maxsize=n_workers)
    order_q: queue.Queue = queue.Queue(maxsize=n_workers + 1)
    end = object()

    def dispatcher() -> None:
        try:
            for task in ds._shard_tasks():
                job = _ShardJob(task, SHARD_QUEUE_CHUNKS)
                if not (_put(order_q, job, halt) and _put(task_q, job, halt)):
                    return
            _put(order_q, end, halt)
        except BaseException as e:  # raised by the generator below, in order
            _put(order_q, e, halt)
        finally:
            for _ in range(n_workers):
                if not _put(task_q, end, halt):
                    break

    def worker() -> None:
        while not halt.is_set():
            try:
                job = task_q.get(timeout=0.1)
            except queue.Empty:
                continue
            if job is end:
                return
            try:
                for item in ds._decode_shard(*job.task):
                    if not _put(job.out, ("chunk", item), halt):
                        return
                _put(job.out, ("end", None), halt)
            except BaseException as e:  # raised by the generator below, in order
                _put(job.out, ("error", e), halt)

    threads = [threading.Thread(target=dispatcher, name="tfrecord-dispatcher", daemon=True)]
    threads += [
        threading.Thread(target=worker, name=f"tfrecord-decode-{i}", daemon=True)
        for i in range(n_workers)
    ]
    for t in threads:
        t.start()

    def get(q: queue.Queue):
        """The next item of ``q``, or ``end`` once ``stop`` is set."""
        while not stop.is_set():
            try:
                return q.get(timeout=0.1)
            except queue.Empty:
                continue
        return end

    try:
        while True:
            job = get(order_q)
            if job is end:
                return
            if isinstance(job, BaseException):
                raise job
            while True:
                item = get(job.out)
                if item is end:
                    return
                kind, payload = item
                if kind == "end":
                    break
                if kind == "error":
                    raise payload
                yield payload
    finally:
        halt.set()
        for t in threads:
            t.join()


def _window_permutation(seed: int, start: Tuple[int, int, int], n: int) -> np.ndarray:
    """The row permutation of the window that starts at ``start`` =
    (epoch, shard cursor, record offset): drawn from the seed and that
    position alone, as the JAX dataset draws it."""
    ss = np.random.SeedSequence([seed & 0xFFFFFFFF, *start])
    return np.random.default_rng(ss).permutation(n)


def _emit_shuffled(ds: TFRecordDataset, chunks, out: queue.Queue, stop: threading.Event) -> bool:
    """Windowed row shuffle: gather ``shuffle_window`` batches of rows,
    permute them and emit them a batch at a time. A window ends at the
    position after its last row, (epoch, cursor, offset): a window that
    ends on a shard's last record ends at (epoch, cursor, n), and the next
    window starts there. False if the consumer went away."""
    b = ds.batch_size
    target = ds.shuffle_window * b
    win: List[ColumnarBatch] = []
    rows = 0
    win_start = end = (0, 0, 0)

    def flush(tail: bool) -> bool:
        window = concat_batches(win)
        perm = _window_permutation(ds.seed, win_start, rows)
        n_batches = rows // b
        if tail and rows % b and not ds.drop_remainder:
            n_batches += 1
        for k in range(n_batches):
            if not _put(out, take_rows(window, perm[k * b:min((k + 1) * b, rows)]), stop):
                return False
        return True

    for chunk, epoch, cursor, start in chunks:
        if stop.is_set():
            return False
        used = 0
        while used < chunk.num_rows:
            take = min(target - rows, chunk.num_rows - used)
            win.append(chunk if used == 0 and take == chunk.num_rows
                       else slice_batch(chunk, used, used + take))
            rows += take
            used += take
            end = (epoch, cursor, start + used)
            if rows == target:
                if not flush(tail=False):
                    return False
                win, rows, win_start = [], 0, end
    return not rows or flush(tail=True)


class BatchIterator:
    """Iterator over the batches a producer thread decodes ahead; also a
    context manager. An exception in the producer is raised here, at the
    batch where it happened."""

    def __init__(self, ds: TFRecordDataset):
        self._queue: queue.Queue = queue.Queue(maxsize=PREFETCH)
        self._stop = threading.Event()
        self._done = False
        self._thread = threading.Thread(
            target=_produce, args=(ds, self._queue, self._stop),
            name="tfrecord-producer", daemon=True,
        )
        # an iterator dropped without close() still stops its producer
        self._finalizer = weakref.finalize(self, self._stop.set)
        self._thread.start()

    def __iter__(self) -> "BatchIterator":
        return self

    def __next__(self) -> ColumnarBatch:
        if self._done:
            raise StopIteration
        while True:
            try:
                item = self._queue.get(timeout=0.1)
                break
            except queue.Empty:
                if self._stop.is_set():  # close()d
                    self._done = True
                    raise StopIteration
        if item is None or isinstance(item, BaseException):
            self.close()
            if item is None:
                raise StopIteration
            raise item
        return item

    def close(self) -> None:
        """Stop the producer, drop the batches it queued, and join it."""
        self._done = True
        self._stop.set()
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass
        self._thread.join()

    def __enter__(self) -> "BatchIterator":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
