"""Streaming batched read of a TFRecord dataset into ColumnarBatches.

Single-process cut of ``tpu_tfrecord/io/dataset.py::TFRecordDataset`` along
the JAX package's main path:

- the native decoder (``_native.NativeDecoder``): a local uncompressed shard
  is mmapped and scanned + decoded in one C++ pass per chunk of
  ``max(batch_size, 2048)`` records; a compressed shard is decompressed
  into a reused buffer of ``SLAB_BYTES`` and scanned + decoded there the
  same way (the JAX dataset's fused path). A record type or schema the
  C++ side cannot represent
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

- discovery, schema inference and partition typing go through
  ``io.reader.DatasetReader``, as in the JAX dataset: the values of
  ``col=value`` directories are columns of every batch, constant over a
  shard (``_attach_partition_chunk``), typed long -> double -> string;
  ``columns`` selects and orders the batch's columns, partition columns
  included.

- a checkpointable position (``IteratorState``, O(1): epoch, shard
  cursor, record offset and, inside a shuffle window, the batches already
  emitted from it) rides with every batch out of the producer;
  ``CheckpointableIterator.state()`` is the position of the last batch
  yielded, and ``batches(state)`` resumes there, re-opening one shard and
  skipping records in it. ``fingerprint()`` identifies the dataset a
  state belongs to, with the JAX dataset's digest, so a state moves
  between the two packages;

- ``on_corrupt``: ``skip_record`` decodes the frames that the reader's
  salvage scan keeps (``max_corrupt_records`` a shard, then
  ``corrupt_fallback``), ``skip_shard`` drops the rest of a shard at its
  first corrupt chunk; record offsets count emitted records, so a resume
  over a corrupt shard skips what the first pass skipped.

Left out against the JAX dataset: more than one process (the process slot
is 0 of 1), the decode pool's watchdog and its autotuned resizing
(``control``), stall defense, retries, caching and the data service.
"""

from __future__ import annotations

import collections
import contextlib
import hashlib
import json
import mmap
import os
import queue
import threading
import time
import weakref
from dataclasses import dataclass, field, fields, replace
from typing import Any, Deque, Dict, Iterator, List, Optional, Tuple

import numpy as np

from tpu_tfrecord_torch import _native, telemetry, wire
from tpu_tfrecord_torch.columnar import (
    Column,
    ColumnarBatch,
    ColumnarDecoder,
    concat_batches,
    slice_batch,
    take_rows,
)
from tpu_tfrecord_torch.io.paths import cast_partition_value
from tpu_tfrecord_torch.io.reader import (
    CorruptQuotaError,
    DatasetReader,
    SalvageTracker,
    _timed_open,
    _timed_read,
    salvage_spans_stream,
)
from tpu_tfrecord_torch.metrics import METRICS, log_salvage_event
from tpu_tfrecord_torch.options import OptionNotPortedError, TFRecordOptions
from tpu_tfrecord_torch.schema import StructType, numpy_dtype

DECODERS = ("native", "python")
MIN_CHUNK_RECORDS = 2048
PREFETCH = 2  # decoded batches queued ahead of the consumer
SLAB_BYTES = 32 << 20  # decompressed bytes read at a time from a compressed shard
# (the JAX dataset's IO scratch starts at this size)
# a declared record length past this is a corrupt length field
MAX_RECORD_BYTES = 1 << 30
# the JAX constructor's read knobs the port does not have yet, at the JAX
# defaults: a call that spells out a default is taken, another value raises
# OptionNotPortedError naming the argument
UNPORTED_ARGS = {
    "process_index": 0,
    "process_count": 1,
    "prefetch": PREFETCH,
    "read_retries": 0,
    "retry_policy": None,
    "slab_bytes": 256 << 20,
    "max_record_bytes": MAX_RECORD_BYTES,
    "use_mmap": True,
    "readahead_bytes": 64 << 20,
}

# the raw open of the mmap route, resolved at call time so that
# faults.install_chaos can route it through a fault plan
_open_local = open


@dataclass(frozen=True)
class IteratorState:
    """Resumable position, the JAX ``IteratorState``: ``shard_cursor`` is
    the position in the epoch's shard order (``epoch_order``, empty shards
    included), ``record_offset`` the records already consumed from that
    shard. Inside a shuffle window the position is the window's START and
    ``window_emitted`` counts the batches already yielded from it: a resume
    decodes the window again, draws the same permutation and skips them.

    ``fingerprint`` names the dataset the position belongs to
    (``TFRecordDataset.fingerprint``); None skips the check. It takes no
    part in equality."""

    epoch: int = 0
    shard_cursor: int = 0
    record_offset: int = 0
    fingerprint: Optional[str] = field(default=None, compare=False)
    window_emitted: int = 0

    def to_json(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "epoch": self.epoch,
            "shard_cursor": self.shard_cursor,
            "record_offset": self.record_offset,
        }
        if self.fingerprint is not None:
            out["fingerprint"] = self.fingerprint
        if self.window_emitted:
            out["window_emitted"] = self.window_emitted
        return out

    @staticmethod
    def from_json(obj: Dict[str, Any]) -> "IteratorState":
        # unknown keys (a newer writer's fields) are ignored
        known = {f.name for f in fields(IteratorState)}
        return IteratorState(**{k: v for k, v in obj.items() if k in known})


def _refuse_unported_args(**given) -> None:
    for name, value in given.items():
        default = UNPORTED_ARGS[name]
        if value is not default and value != default:
            raise OptionNotPortedError(
                f"TFRecordDataset({name}={value!r}): not ported yet; the port reads with the "
                f"JAX default {name}={default!r}"
            )


class TFRecordDataset:
    """Plan a streaming read: ``TFRecordDataset(paths, batch_size,
    schema=None, recordType="Example", hash_buckets=None, pack=None,
    drop_remainder=True, num_epochs=1, decoder="native", shuffle=False,
    shuffle_window=0, seed=0, num_workers=1, columns=None, options=None,
    **option_kwargs)``. Without a schema, it is inferred from the first
    non-empty shard. ``num_epochs=None`` repeats the shards without end.
    ``num_workers`` shards decode at a time (values below 1 count as 1).
    ``options`` (a ``TFRecordOptions``) or the keyword options
    (``verify_crc``, ``infer_sample_limit``, ...) configure the read, as
    in the JAX dataset; ``options`` takes the place of ``schema`` and
    ``recordType``. The JAX constructor's ``process_index``,
    ``process_count``, ``prefetch``, ``read_retries``, ``retry_policy``,
    ``slab_bytes``, ``max_record_bytes``, ``use_mmap`` and
    ``readahead_bytes`` are taken at their JAX defaults
    (``UNPORTED_ARGS``); another value raises ``OptionNotPortedError``."""

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
        columns: Optional[List[str]] = None,
        options: Optional[TFRecordOptions] = None,
        process_index: int = 0,
        process_count: int = 1,
        prefetch: int = PREFETCH,
        read_retries: int = 0,
        retry_policy=None,
        slab_bytes: int = 256 << 20,
        max_record_bytes: int = MAX_RECORD_BYTES,
        use_mmap: bool = True,
        readahead_bytes: int = 64 << 20,
        **option_kwargs,
    ):
        _refuse_unported_args(
            process_index=process_index, process_count=process_count, prefetch=prefetch,
            read_retries=read_retries, retry_policy=retry_policy, slab_bytes=slab_bytes,
            max_record_bytes=max_record_bytes, use_mmap=use_mmap, readahead_bytes=readahead_bytes,
        )
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
        if options is None:
            options = TFRecordOptions.from_map(
                option_kwargs, recordType=recordType, schema=schema
            )
        elif schema is not None or recordType != "Example" or option_kwargs:
            raise ValueError("pass either options= or schema/recordType/keyword options")
        self._reader = DatasetReader(paths, options=options)
        self.options = self._reader.options
        self.batch_size = batch_size
        self.drop_remainder = drop_remainder
        self.num_epochs = num_epochs
        self.shards = self._reader.shards
        full = self._reader.schema()
        part_cols = set(self._reader.partition_schema.names)
        wanted = full if columns is None else full.select(columns)
        # the decoders cover the record columns; the requested partition
        # columns are constant per shard and attached to each decoded chunk
        self.schema: StructType = StructType(list(wanted.fields))
        self._data_schema = StructType([f for f in wanted if f.name not in part_cols])
        self._partition_fields = [f for f in wanted if f.name in part_cols]
        rt = self.options.record_type
        self._decoder = ColumnarDecoder(self._data_schema, rt)
        self.hash_buckets = _native.validate_hash_buckets(self._data_schema, hash_buckets)
        self.pack = _native.validate_pack(self._data_schema, pack, self.hash_buckets)
        self._native_decoder = (
            _native.make_decoder(self._data_schema, rt, self.hash_buckets, self.pack)
            if decoder == "native"
            else None
        )
        self._fingerprint: Optional[str] = None

    @property
    def decoder(self) -> str:
        """'native' or 'python': the decoder this dataset's batches come from."""
        return "python" if self._native_decoder is None else "native"

    # -- decode chunks ---------------------------------------------------------

    def epoch_order(self, epoch: int) -> List[int]:
        """The order of the shard list in ``epoch``: as listed, or with
        ``shuffle`` a permutation drawn from ``(seed, epoch)`` alone."""
        if not self.shuffle:
            return list(range(len(self.shards)))
        rng = np.random.default_rng((self.seed, epoch))
        return rng.permutation(len(self.shards)).tolist()

    def _shard_tasks(self, state: Optional[IteratorState] = None) -> Iterator[Tuple[int, int, int, int]]:
        """(epoch, cursor, shard index, skip) of every non-empty shard of
        every epoch from ``state`` on, lazily (epochs may be endless):
        ``cursor`` is the shard's position in the epoch's order, ``skip``
        the records to pass over in it (the state's offset in the state's
        shard, else 0)."""
        state = state or IteratorState()
        if not any(sh.size for sh in self.shards):
            return
        epoch = state.epoch
        while self.num_epochs is None or epoch < self.num_epochs:
            order = self.epoch_order(epoch)
            first = state.shard_cursor if epoch == state.epoch else 0
            for cursor in range(first, len(order)):
                if self.shards[order[cursor]].size:
                    at_state = epoch == state.epoch and cursor == state.shard_cursor
                    yield epoch, cursor, order[cursor], state.record_offset if at_state else 0
            epoch += 1

    def _decode_shard(
        self, epoch: int, cursor: int, index: int, skip: int = 0
    ) -> Iterator[Tuple[ColumnarBatch, int, int, int]]:
        """(chunk, epoch, cursor, start) of one shard's decoded chunks from
        its record ``skip`` on: ``start`` is the index of the chunk's first
        record among the shard's emitted records. ``on_corrupt`` applies:
        ``skip_record`` decodes the salvage scan's frames, ``skip_shard``
        ends the shard at its first corrupt chunk (counted in
        ``read.corrupt_records`` and ``read.skipped_shards``)."""
        chunk_records = max(self.batch_size, MIN_CHUNK_RECORDS)
        path = self.shards[index].path
        mode = self.options.on_corrupt
        if mode == "skip_record":
            try:
                yield from self._positioned(
                    self._salvage_chunks(path, chunk_records, skip), epoch, cursor, index, skip)
            except CorruptQuotaError as e:
                if self.options.corrupt_fallback != "skip_shard":
                    raise wire.TFRecordCorruptionError(str(e)) from e
                self._note_skipped_shard(index, str(e))
            return
        chunks = self._strict_chunks(path, chunk_records, skip)
        if mode != "skip_shard":
            yield from self._positioned(chunks, epoch, cursor, index, skip)
            return
        try:
            yield from self._positioned(chunks, epoch, cursor, index, skip)
        except wire.TFRecordCorruptionError as e:
            METRICS.count("read.corrupt_records")
            self._note_skipped_shard(index, str(e))

    def _positioned(self, chunks, epoch: int, cursor: int, index: int, skip: int):
        """Number the chunks of one shard from record ``skip`` and attach
        its partition columns."""
        start = skip
        for chunk in chunks:
            if self._partition_fields:
                self._attach_partition_chunk(chunk, index)
            yield chunk, epoch, cursor, start
            start += chunk.num_rows

    def _strict_chunks(self, path: str, chunk_records: int, skip: int) -> Iterator[ColumnarBatch]:
        if self._native_decoder is None:
            return self._python_chunks(path, chunk_records, skip)
        if wire.codec_from_path(path) is None:
            return self._mmap_chunks(path, chunk_records, skip)
        return self._slab_chunks(path, chunk_records, skip)

    def _note_skipped_shard(self, index: int, reason: str) -> None:
        log_salvage_event(path=self.shards[index].path, kind="shard_skipped", error=reason)
        METRICS.count("read.skipped_shards")

    def _attach_partition_chunk(self, chunk: ColumnarBatch, index: int) -> None:
        """Partition values are constant within a shard: materialize them as
        constant columns over the chunk (JAX ``_attach_partition_chunk``)."""
        n = chunk.num_rows
        for f in self._partition_fields:
            val = cast_partition_value(self.shards[index].partitions.get(f.name), f.data_type)
            col = Column(f.name, f.data_type, mask=np.full(n, val is not None, dtype=bool))
            np_dt = numpy_dtype(f.data_type)
            if np_dt is None:
                item = val.encode("utf-8") if val is not None else b""
                col.blob = item * n
                col.blob_offsets = np.arange(n + 1, dtype=np.int64) * len(item)
            else:
                col.values = np.full(n, val if val is not None else 0, dtype=np_dt)
            chunk.columns[f.name] = col

    def _chunks(
        self, stop: Optional[threading.Event] = None, state: Optional[IteratorState] = None
    ) -> Iterator[Tuple[ColumnarBatch, int, int, int]]:
        """(chunk, epoch, cursor, start) for the decoded chunks of every
        epoch from ``state`` on, in task order; with ``num_workers`` > 1
        from the decode pool, which ``stop`` (or closing this generator)
        stops and joins."""
        state = state or IteratorState()
        if self.num_workers > 1:
            yield from _parallel_chunks(self, stop or threading.Event(), state)
            return
        for task in self._shard_tasks(state):
            yield from self._decode_shard(*task)

    def _mmap_chunks(self, path: str, chunk_records: int, skip: int = 0) -> Iterator[ColumnarBatch]:
        """A local uncompressed shard: mmap it and scan + decode straight out
        of the page cache, one native call per chunk; the first call
        CRC-checks and passes over ``skip`` records."""
        dec = self._native_decoder
        with _open_local(path, "rb") as fh:
            size = os.fstat(fh.fileno()).st_size
            if size == 0:
                return
            mm = mmap.mmap(fh.fileno(), 0, prot=mmap.PROT_READ)
            buf = np.frombuffer(mm, np.uint8)
            try:
                pos = 0
                to_skip = skip
                while True:
                    cb, n_skipped, n_done, pos = dec.scan_decode(
                        buf, pos, self.options.verify_crc, to_skip, chunk_records,
                        length=size, max_record_bytes=MAX_RECORD_BYTES,
                    )
                    to_skip -= n_skipped
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

    def _slab_chunks(self, path: str, chunk_records: int, skip: int = 0) -> Iterator[ColumnarBatch]:
        """A compressed shard, as the JAX dataset's fused path reads it:
        decompressed into a buffer of SLAB_BYTES, scanned + decoded one
        native call per chunk (the first calls CRC-check and pass over
        ``skip`` records); a partial frame at the buffer's end moves to its
        front before the next read, the buffer grows for a record larger
        than it, a declared length past MAX_RECORD_BYTES raises. Chunks
        before a corrupt one are yielded, as the JAX dataset yields them."""
        dec = self._native_decoder
        verify = self.options.verify_crc
        buf = np.empty(SLAB_BYTES, np.uint8)
        to_skip = skip
        data_len = pos = 0
        with _timed_open(path) as fh:
            while True:
                tail = data_len - pos
                if tail and pos:
                    buf[:tail] = buf[pos:data_len].copy()
                if tail >= 8:
                    declared = int(buf[:8].view(np.uint64)[0])
                    if declared > MAX_RECORD_BYTES:
                        raise wire.TFRecordCorruptionError(
                            f"record length {declared} exceeds max_record_bytes "
                            f"({MAX_RECORD_BYTES}) in {path} — corrupt length field?")
                    if 16 + declared > buf.nbytes:
                        grown = np.empty(16 + declared, np.uint8)
                        grown[:tail] = buf[:tail]
                        buf = grown
                data = _timed_read(fh, buf.nbytes - tail, path)
                if not data:
                    if tail:
                        raise wire.TFRecordCorruptionError(f"truncated TFRecord at end of {path}")
                    return
                buf[tail:tail + len(data)] = np.frombuffer(data, np.uint8)
                data_len, pos = tail + len(data), 0
                while True:
                    cb, n_skipped, n_done, pos = dec.scan_decode(
                        buf, pos, verify, to_skip, chunk_records, length=data_len,
                        max_record_bytes=MAX_RECORD_BYTES)
                    to_skip -= n_skipped
                    if n_done == 0:
                        break  # a partial frame, or nothing, is left: read on
                    yield cb

    def _salvage_chunks(self, path: str, chunk_records: int, skip: int = 0) -> Iterator[ColumnarBatch]:
        """``skip_record``: the frames the reader's salvage scan keeps (CRCs
        checked, corrupt regions resynced past and logged by a
        ``SalvageTracker``, which raises ``CorruptQuotaError`` past
        ``max_corrupt_records``), chunk-decoded from the ``skip``-th."""
        base = 0  # index of the slab's first frame among the kept ones
        for buf, offsets, lengths in salvage_spans_stream(
            path, on_event=SalvageTracker(path, self.options), slab_bytes=SLAB_BYTES,
            max_record_bytes=MAX_RECORD_BYTES,
        ):
            for start in range(max(0, skip - base), len(offsets), chunk_records):
                offs, lens = offsets[start:start + chunk_records], lengths[start:start + chunk_records]
                if self._native_decoder is not None:
                    yield self._native_decoder.decode_spans(buf, offs, lens)
                else:
                    yield self._python_decode([bytes(buf[o:o + n])
                                               for o, n in zip(offs.tolist(), lens.tolist())])
            base += len(offsets)

    def _python_chunks(self, path: str, chunk_records: int, skip: int = 0) -> Iterator[ColumnarBatch]:
        records: List[bytes] = []
        for i, rec in enumerate(wire.read_records(path, verify_crc=self.options.verify_crc)):
            if i < skip:
                continue
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

    # -- identity --------------------------------------------------------------

    def fingerprint(self) -> str:
        """Digest of what a resume position depends on, as the JAX dataset
        computes it: the shard list (paths and sizes), the process slot (0
        of 1), the shuffle settings, the record type, and with
        ``shuffle_window`` the window and the batch size (``window_emitted``
        counts batches)."""
        if self._fingerprint is None:
            ident = {
                "shards": [(sh.path, sh.size) for sh in self._reader.shards],
                "process_index": 0,
                "process_count": 1,
                "shuffle": self.shuffle,
                "seed": self.seed,
                "record_type": self.options.record_type.value,
            }
            if self.shuffle_window:
                ident["shuffle_window"] = self.shuffle_window
                ident["batch_size"] = self.batch_size
            blob = json.dumps(ident, sort_keys=True).encode()
            self._fingerprint = hashlib.sha256(blob).hexdigest()[:32]
        return self._fingerprint

    # -- batches ---------------------------------------------------------------

    def batches(self, state: Optional[IteratorState] = None) -> "CheckpointableIterator":
        """One run over ``num_epochs`` epochs from ``state`` (the start when
        None), decoded ahead by a producer thread. Use it in a ``with``
        block (or call ``close()``) so an early exit stops and joins the
        thread. A state whose fingerprint is not this dataset's raises
        ``ValueError``."""
        if state is not None and state.fingerprint is not None:
            mine = self.fingerprint()
            if state.fingerprint != mine:
                raise ValueError(
                    "iterator state does not match this dataset (fingerprint "
                    f"{state.fingerprint} != {mine}): the shard list, "
                    "process slot, shuffle seed, or record type changed "
                    "since the state was saved — resuming would read wrong "
                    "or duplicate data"
                )
        return CheckpointableIterator(self, state or IteratorState())


def _take(pending: Deque[list], n: int) -> Tuple[ColumnarBatch, IteratorState]:
    """The next ``n`` rows of the pending [chunk, rows_used, epoch, cursor,
    chunk_start] entries, and the position after the last of them."""
    chunk, used, epoch, cursor, chunk_start = pending[0]
    if used == 0 and chunk.num_rows == n:
        # aligned: the chunk is the batch, its buffers pass through uncopied
        pending.popleft()
        return chunk, IteratorState(epoch, cursor, chunk_start + n)
    parts = []
    while n:
        entry = pending[0]
        chunk, used, epoch, cursor, chunk_start = entry
        take = min(n, chunk.num_rows - used)
        parts.append(slice_batch(chunk, used, used + take))
        n -= take
        entry[1] = used + take
        end = IteratorState(epoch, cursor, chunk_start + entry[1])
        if entry[1] == chunk.num_rows:
            pending.popleft()
    return concat_batches(parts), end


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


def _produce(ds: TFRecordDataset, start: IteratorState, out: queue.Queue,
             stop: threading.Event) -> None:
    """The producer thread: (batch, end position) pairs from ``start`` on,
    then None at the end, or the exception that stopped it. A module-level
    function, so the thread holds no reference to the iterator and an
    abandoned iterator can be collected."""
    try:
        emit = _emit_shuffled if ds.shuffle_window else _emit_in_order
        if emit(ds, start, out, stop):
            _put(out, None, stop)
    except BaseException as e:  # re-raised in the consumer by CheckpointableIterator.__next__
        _put(out, e, stop)


def _emit_in_order(ds: TFRecordDataset, start: IteratorState, out: queue.Queue,
                   stop: threading.Event) -> bool:
    """Cut the chunk stream into batches in stream order, each with the
    position after its last row; False if the consumer went away."""
    pending: Deque[list] = collections.deque()
    avail = 0
    with contextlib.closing(ds._chunks(stop, start)) as chunks:
        for chunk, epoch, cursor, chunk_start in chunks:
            if stop.is_set():
                return False
            if chunk.num_rows == 0:
                continue
            pending.append([chunk, 0, epoch, cursor, chunk_start])
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

    def __init__(self, task: Tuple[int, int, int, int], depth: int):
        self.task = task
        self.out: queue.Queue = queue.Queue(maxsize=depth)


SHARD_QUEUE_CHUNKS = 2  # decoded chunks a worker may hold ahead of the producer


def _parallel_chunks(ds: TFRecordDataset, stop: threading.Event,
                     state: Optional[IteratorState] = None) -> Iterator[tuple]:
    """Ordered parallel shard decode from ``state`` on, the JAX
    ``_parallel_chunks`` without its watchdog and its resizable pool.

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
            for task in ds._shard_tasks(state):
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


def _window_permutation(seed: int, start: IteratorState, n: int) -> np.ndarray:
    """The row permutation of the window that starts at ``start``: drawn
    from the seed and that position alone, as the JAX dataset draws it."""
    ss = np.random.SeedSequence(
        [seed & 0xFFFFFFFF, start.epoch, start.shard_cursor, start.record_offset])
    return np.random.default_rng(ss).permutation(n)


def _emit_shuffled(ds: TFRecordDataset, start: IteratorState, out: queue.Queue,
                   stop: threading.Event) -> bool:
    """Windowed row shuffle: gather ``shuffle_window`` batches of rows,
    permute them and emit them a batch at a time. A window ends at the
    position after its last row, (epoch, cursor, offset): a window that
    ends on a shard's last record ends at (epoch, cursor, n), and the next
    window starts there. Every batch but a window's last carries the
    window's start with ``window_emitted`` = the batches emitted from it so
    far; the last carries the window's end. From a mid-window ``start`` the
    window is decoded from its start again and the batches already emitted
    are skipped. False if the consumer went away."""
    b = ds.batch_size
    target = ds.shuffle_window * b
    win: List[ColumnarBatch] = []
    rows = 0
    emit_skip = start.window_emitted
    win_start = end = IteratorState(start.epoch, start.shard_cursor, start.record_offset)

    def flush(tail: bool) -> bool:
        nonlocal emit_skip
        window = concat_batches(win)
        perm = _window_permutation(ds.seed, win_start, rows)
        n_batches = rows // b
        if tail and rows % b and not ds.drop_remainder:
            n_batches += 1
        for k in range(emit_skip, n_batches):
            pos = end if k == n_batches - 1 else replace(win_start, window_emitted=k + 1)
            if not _put(out, (take_rows(window, perm[k * b:min((k + 1) * b, rows)]), pos), stop):
                return False
        emit_skip = 0
        return True

    with contextlib.closing(ds._chunks(stop, win_start)) as chunks:
        for chunk, epoch, cursor, chunk_start in chunks:
            if stop.is_set():
                return False
            used = 0
            while used < chunk.num_rows:
                take = min(target - rows, chunk.num_rows - used)
                win.append(chunk if used == 0 and take == chunk.num_rows
                           else slice_batch(chunk, used, used + take))
                rows += take
                used += take
                end = IteratorState(epoch, cursor, chunk_start + used)
                if rows == target:
                    if not flush(tail=False):
                        return False
                    win, rows, win_start = [], 0, end
    return not rows or flush(tail=True)


class CheckpointableIterator:
    """Iterator over the batches a producer thread decodes ahead, with a
    resumable ``state()``; also a context manager. An exception in the
    producer is raised here, at the batch where it happened.

    Each batch crosses the queue with the position after it, so
    ``state()`` is the position of the last batch YIELDED, never of one
    decoded ahead: resuming from it replays nothing and skips nothing.
    Before each get the queue's fill fraction feeds the
    ``prefetch.occupancy`` gauge (an EMA, ``telemetry.boundness_verdict``
    reads it); the wait lands in the ``batch.wait`` stage and a ``batch``
    span."""

    def __init__(self, ds: TFRecordDataset, state: IteratorState):
        self._ds = ds
        self._consumed_state = state
        self._queue: queue.Queue = queue.Queue(maxsize=PREFETCH)
        self._stop = threading.Event()
        self._done = False
        self._occupancy = telemetry.OccupancyEma(telemetry.OCCUPANCY_GAUGE)
        self._thread = threading.Thread(
            target=_produce, args=(ds, state, self._queue, self._stop),
            name="tfrecord-producer", daemon=True,
        )
        # an iterator dropped without close() still stops its producer
        self._finalizer = weakref.finalize(self, self._stop.set)
        self._thread.start()

    def __iter__(self) -> "CheckpointableIterator":
        return self

    def __next__(self) -> ColumnarBatch:
        if self._done:
            raise StopIteration
        depth = self._queue.qsize()
        self._occupancy.update(depth / self._queue.maxsize)
        METRICS.gauge("prefetch.queue_depth", depth)
        t0_ns = time.perf_counter_ns()
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
        batch, self._consumed_state = item
        wait_ns = time.perf_counter_ns() - t0_ns
        METRICS.add("batch.wait", records=batch.num_rows, seconds=wait_ns / 1e9,
                    latency=wait_ns / 1e9)
        telemetry.record_span("batch", t0_ns, wait_ns, rows=batch.num_rows)
        return batch

    def state(self) -> IteratorState:
        """The position of the last batch yielded, stamped with the
        dataset's fingerprint."""
        return replace(self._consumed_state, fingerprint=self._ds.fingerprint())

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

    def __enter__(self) -> "CheckpointableIterator":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
