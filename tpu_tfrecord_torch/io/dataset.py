"""Streaming batched read of a TFRecord dataset into ColumnarBatches.

Single-process cut of ``tpu_tfrecord/io/dataset.py::TFRecordDataset``,
with the JAX constructor's read knobs and its decode pool:

- the native decoder (``_native.NativeDecoder``) scans and decodes one
  chunk of ``max(batch_size, 2048)`` records per C++ call. A local
  uncompressed shard is mmapped and decoded out of the page cache (the
  mmap route, ``use_mmap=True``); a compressed shard, or any shard with
  ``use_mmap=False``, is read into a per-thread buffer that is reused
  (``readinto``) and grows for a record larger than it (the stream route;
  its first size is ``min(slab_bytes, 32 MiB)``). A schema or record type
  the C++ side cannot represent decodes with the Python
  ``ColumnarDecoder`` over ``slab_bytes`` slabs of framed spans (the
  Python route); ``decoder="python"`` asks for it on any schema (the
  tests' oracle). A declared record length past ``max_record_bytes``
  raises ``TFRecordCorruptionError``;
- ``readahead_bytes`` (default 64 MiB, 0 = off) keeps a sliding
  ``posix_fadvise(WILLNEED)`` window ahead of the decoder on every local
  route, after one ``POSIX_FADV_SEQUENTIAL``, as the JAX dataset does;
- ``read_retries`` / ``retry_policy``: an IO or corruption error restarts
  the shard's attempt under a ``retry.RetryPolicy`` (``read.retries``, a
  ``read.retry`` instant); each attempt skips the records already
  yielded, on every route (mmap, stream, salvage and Python);
- stall defence (``stall.py``): with ``read_deadline_ms``,
  ``open_deadline_ms`` or ``hedge_after_ms`` set, opens and raw reads run
  under a ``StallGuard``; the mmap route's open runs under
  ``open_deadline_ms``. A stall that outlives the retries is handled by
  ``on_stall`` (``raise``, or ``skip_shard``: a ``shard_stalled`` event
  and ``read.skipped_shards``). Unset, no guard and no thread exists;
- ``hash_buckets`` and ``pack`` shape the batch as the native decoder
  does (with either decoder): a hashed bytes column carries int32 bucket
  ids in ``values`` (``Column.hash_buckets`` set), and each pack group is
  one ``[B, K]`` matrix column in place of its members;
- a producer thread decodes ahead into a queue of ``prefetch`` batches
  (resizable under autotune); the native calls release the GIL, so decode
  overlaps the consumer. Batches cross chunks, shards and epochs: a chunk
  that is exactly one batch passes through with no copy, anything else is
  cut and joined with ``slice_batch`` / ``concat_batches``;
- ``num_workers`` > 1 decodes that many shards at a time
  (``_parallel_chunks``): a dispatcher hands the shard tasks to the
  workers, each shard decodes into a bounded queue of its own, and the
  producer drains those queues in task order, so the chunks, and hence
  the batches, are the sequential ones for any worker count. With
  ``watchdog_timeout_ms`` a watchdog fails the job of a worker whose
  progress beat went silent (``stall.WatchdogError``, handled by
  ``on_stall`` once the chunks it made are drained) and starts a
  replacement; a worker blocked on its full queue is not stalled;
- ``autotune="on"`` (``autotune.py``) runs the pool from a
  ``PipelineControl`` that the controller resizes mid-epoch, at the
  ticks of a ``telemetry.Pulse`` (``pulse_interval_s``, else
  ``autotune_interval_s``); the batches and positions stay those of the
  sequential stream.

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
  shard (``_with_partitions``), typed long -> double -> string;
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

- ``cache="auto"`` (``cache.py``): the first pass over a shard appends its
  decoded chunks to an entry under ``cache_dir``; later passes, in this
  run or a later one with the same decode fingerprint, serve the chunks as
  views over the entry's mmap (``cache.serve``), at the populating pass's
  chunk boundaries, so positions and batches are those of an uncached
  read. Entries are the JAX cache's, byte for byte. Engaged only under
  ``on_corrupt="raise"``. ``trace="on"`` enables the flight recorder and
  ``telemetry_port`` starts the Prometheus endpoint.

- ``process_index`` / ``process_count``: this process reads the shards
  ``i`` of the global order with ``i % process_count == process_index``
  (``paths.interleave``, as ``device.mesh.assign_shards``); shuffles,
  positions and the cache work on that slice, and the fingerprint stamps
  the slot, so a state resumes only on the slot that saved it. Processes
  whose slices hold different row counts run different numbers of batches.

- a URL source (``http://`` through ``httpfs``, any other scheme through
  fsspec) takes the stream route: block-prefetched under the dataset's
  ``retry_policy`` (``fs.open_for_read``), no mmap and no readahead hint.

- ``telemetry_spool_dir``: the iterator holds the process's fleet spool
  (``fleet.acquire_spool``, refcounted per directory) while it is live,
  stamped with ``telemetry_role`` at ``spool_interval_s``; its end, its
  failure, ``close()`` or its collection releases it once, and the last
  release lands the ``final`` snapshot.

- ``service`` (``tpu_tfrecord_torch.service``): the chunks are fetched
  from a data service's decode workers instead of decoded here, exactly
  once, with a local read of the shard when the service stays
  unreachable past ``service_fallback_ms``; autotune is off under it.
"""

from __future__ import annotations

import collections
import contextlib
import hashlib
import itertools
import json
import mmap
import os
import queue
import threading
import time
import weakref
from dataclasses import dataclass, field, fields, replace
from typing import Any, Callable, Deque, Dict, Iterator, List, Optional, Tuple

import numpy as np

from tpu_tfrecord_torch import _native, autotune, fleet, fs as _fs, telemetry, wire
from tpu_tfrecord_torch.columnar import (
    Column,
    ColumnarBatch,
    ColumnarDecoder,
    concat_batches,
    slice_batch,
    take_rows,
)
from tpu_tfrecord_torch.io.paths import cast_partition_value, interleave
from tpu_tfrecord_torch.io.reader import (
    CorruptQuotaError,
    DatasetReader,
    SalvageTracker,
    _timed_open,
    salvage_spans_stream,
    scan_spans_stream,
)
from tpu_tfrecord_torch.metrics import METRICS, log_salvage_event, logger, timed
from tpu_tfrecord_torch.options import TFRecordOptions
from tpu_tfrecord_torch.retry import RetryPolicy
from tpu_tfrecord_torch.schema import StructType, numpy_dtype
from tpu_tfrecord_torch.stall import StallError, StallGuard, WatchdogError, guard_from_options
from tpu_tfrecord_torch.tracing import trace

DECODERS = ("native", "python")
MIN_CHUNK_RECORDS = 2048
PREFETCH = 2  # decoded batches queued ahead of the consumer (the JAX default)
SLAB_BYTES = 256 << 20  # the JAX default slab of the Python and salvage routes
SCRATCH_INIT = 32 << 20  # the stream route's first read buffer, at most
MAX_RECORD_BYTES = 1 << 30  # a declared record length past this is corrupt
READAHEAD_BYTES = 64 << 20  # the JAX default readahead window
SHARD_QUEUE_CHUNKS = 2  # decoded chunks a worker may hold ahead of the producer
BACKPRESSURE = "read.backpressure_waits"  # batch puts that found the queue full

# the raw open of the mmap route, resolved at call time so that
# faults.install_chaos can route it through a fault plan
_open_local = open


class _ResizableQueue(queue.Queue):
    """A ``queue.Queue`` whose ``maxsize`` can change while it is in use
    (the prefetch queue under autotune): growing wakes blocked putters;
    shrinking below the fill blocks new puts until the consumer drains
    it, and drops nothing."""

    def resize(self, maxsize: int) -> None:
        with self.mutex:
            self.maxsize = max(1, int(maxsize))
            self.not_full.notify_all()


def _noop_hint(_pos: int) -> None:
    return


def _make_readahead(fh, size: int, window: int) -> Callable[[int], None]:
    """The sliding ``posix_fadvise(WILLNEED)`` hinter of a local file:
    ``hint(pos)`` keeps ``[pos, pos + window)`` requested, so the kernel
    streams the window in while the decoder works on the current chunk.
    Issues ``POSIX_FADV_SEQUENTIAL`` once. A no-op for a window of 0, an
    object without a real descriptor or a platform without fadvise."""
    if not window or size <= 0:
        return _noop_hint
    try:
        fd = fh.fileno()
        os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_SEQUENTIAL)
    except (AttributeError, OSError, ValueError):
        return _noop_hint
    cursor = [0]

    def hint(pos: int) -> None:
        want_end = min(size, pos + window)
        if want_end > cursor[0]:
            try:
                os.posix_fadvise(fd, cursor[0], want_end - cursor[0], os.POSIX_FADV_WILLNEED)
            except OSError:
                cursor[0] = size  # the descriptor went away: stop hinting
                return
            cursor[0] = want_end

    hint(0)
    return hint


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


class TFRecordDataset:
    """Plan a streaming read: ``TFRecordDataset(paths, batch_size,
    options=None, columns=None, drop_remainder=True, num_epochs=1,
    process_index=0, process_count=1, prefetch=2, num_workers=1,
    shuffle=False, shuffle_window=0, seed=0, read_retries=0,
    retry_policy=None, hash_buckets=None, pack=None, slab_bytes=256 MiB,
    max_record_bytes=1 GiB, use_mmap=True, readahead_bytes=64 MiB, *,
    schema=None, recordType="Example", decoder="native",
    **option_kwargs)``: the JAX constructor's positional order, with the
    port's own parameters keyword-only. Without a schema, it is inferred from the first
    non-empty shard. ``num_epochs=None`` repeats the shards without end.
    ``num_workers`` shards decode at a time (values below 1 count as 1).
    ``options`` (a ``TFRecordOptions``) or the keyword options
    (``verify_crc``, ``read_deadline_ms``, ``on_stall``,
    ``watchdog_timeout_ms``, ``autotune``, ...) configure the read, as in
    the JAX dataset; ``options`` takes the place of ``schema`` and
    ``recordType``. The read knobs take the JAX constructor's defaults and
    meanings (see the module docstring); an explicit ``retry_policy`` wins
    over ``read_retries``. ``process_index`` and ``process_count`` pick
    this process's interleaved slice of the shards."""

    def __init__(
        self,
        paths,
        batch_size: int,
        options: Optional[TFRecordOptions] = None,
        columns: Optional[List[str]] = None,
        drop_remainder: bool = True,
        num_epochs: Optional[int] = 1,
        process_index: int = 0,
        process_count: int = 1,
        prefetch: int = PREFETCH,
        num_workers: int = 1,
        shuffle: bool = False,
        shuffle_window: int = 0,
        seed: int = 0,
        read_retries: int = 0,
        retry_policy: Optional[RetryPolicy] = None,
        hash_buckets: Optional[Dict[str, int]] = None,
        pack: Optional[Dict[str, List[str]]] = None,
        slab_bytes: int = SLAB_BYTES,
        max_record_bytes: int = MAX_RECORD_BYTES,
        use_mmap: bool = True,
        readahead_bytes: int = READAHEAD_BYTES,
        *,
        schema: Optional[StructType] = None,
        recordType="Example",
        decoder: str = "native",
        **option_kwargs,
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
        self.prefetch = prefetch
        self.read_retries = read_retries
        self.retry_policy = (
            retry_policy if retry_policy is not None else RetryPolicy(max_retries=read_retries)
        )
        self.slab_bytes = max(1, slab_bytes)
        self.max_record_bytes = max_record_bytes
        self.use_mmap = use_mmap
        self.readahead_bytes = max(0, readahead_bytes)
        self._scratch_local = threading.local()
        if options is None:
            options = TFRecordOptions.from_map(
                option_kwargs, recordType=recordType, schema=schema
            )
        elif schema is not None or recordType != "Example" or option_kwargs:
            raise ValueError("pass either options= or schema/recordType/keyword options")
        self._reader = DatasetReader(paths, options=options)
        # the source spec as given (before discovery), for the data
        # service's job spec: workers discover the same shard list from it
        # and prove agreement with the shard-list digest
        self.source_paths = [
            os.fspath(p) for p in (paths if isinstance(paths, (list, tuple)) else [paths])
        ]
        self.options = self._reader.options
        # the flight recorder is process-global: "on" enables it, "off"
        # leaves it alone (another live dataset may be tracing)
        if self.options.trace == "on":
            telemetry.enable()
        if self.options.telemetry_port is not None:
            telemetry.ensure_exporter(self.options.telemetry_port)
        # None unless a stall threshold is set: the default path pays
        # nothing. Autotune gets an empty guard to install hedges into
        # (streams opened after an install are guarded).
        self._stall_guard = guard_from_options(self.options)
        if self._stall_guard is None and self.options.autotune == "on":
            self._stall_guard = StallGuard()
        if self._stall_guard is not None:
            # remote block fetches resume under the shard-level budget
            self._stall_guard.retry_policy = self.retry_policy
        self.batch_size = batch_size
        self.drop_remainder = drop_remainder
        self.num_epochs = num_epochs
        self.process_index = process_index
        self.process_count = process_count
        self.shards = interleave(self._reader.shards, process_index, process_count)
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
        # The columnar epoch cache, engaged only under the strict corruption
        # policy: a tolerant one may emit fewer rows than the shard holds,
        # and caching them would freeze one corruption outcome into later
        # epochs.
        self._cache = None
        if self.options.cache == "auto":
            if self.options.on_corrupt != "raise":
                logger.warning("tfrecord.cache disabled: cache='auto' requires "
                               "on_corrupt='raise' (got %r)", self.options.on_corrupt)
            else:
                from tpu_tfrecord_torch import cache as _cache_mod

                # the columns of a decoded chunk: the data columns less the
                # pack members, the pack groups (both routes of the port
                # pack, as the native decoder does) and the partition fields
                members = {m for ms in self.pack.values() for m in ms}
                expect = ({f.name for f in self._data_schema if f.name not in members}
                          | set(self.pack) | {f.name for f in self._partition_fields})
                self._cache = _cache_mod.ShardCache(
                    self.options.cache_dir or _cache_mod.default_cache_dir(),
                    ident=self._cache_ident(), max_bytes=self.options.cache_max_bytes,
                    expect_columns=expect)
                self._cache_dtypes = self.chunk_dtypes()

    @property
    def decoder(self) -> str:
        """'native' or 'python': the decoder this dataset's batches come from."""
        return "python" if self._native_decoder is None else "native"

    # -- shard tasks -----------------------------------------------------------

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

    def _chunks(
        self, stop: Optional[threading.Event] = None, state: Optional[IteratorState] = None,
        control: Optional[autotune.PipelineControl] = None,
    ) -> Iterator[Tuple[ColumnarBatch, int, int, int]]:
        """(chunk, epoch, cursor, start) for the decoded chunks of every
        epoch from ``state`` on, in task order: from the decode pool when
        ``num_workers`` > 1 or a ``control`` (autotune) resizes the pool,
        which ``stop`` (or closing this generator) stops and joins. With
        ``options.service`` the chunks are fetched from the data service's
        decode workers instead (``_service_chunks``): the same tuples and
        positions, so ``num_workers`` and the pool do not apply."""
        state = state or IteratorState()
        if self.options.service is not None:
            yield from self._service_chunks(state, stop or threading.Event())
            return
        if self.num_workers > 1 or control is not None:
            yield from _parallel_chunks(self, stop or threading.Event(), state, control)
            return
        for task in self._shard_tasks(state):
            yield from self._decode_shard(*task)

    def _service_chunks(self, state: IteratorState, stop: threading.Event):
        """The service-backed chunk source (``tpu_tfrecord_torch.service``):
        each shard's chunks stream from a leased decode worker, exactly
        once across worker and dispatcher deaths, and from
        ``_decode_shard`` when the service stays unreachable, so resume
        states move between service-backed and local iterators."""
        from tpu_tfrecord_torch import service as _service

        client = _service.ServiceClient(self)
        try:
            for epoch, cursor, index, skip in self._shard_tasks(state):
                if stop.is_set():
                    return
                yield from client.shard_chunks(epoch, cursor, index, skip, stop)
        finally:
            client.close()

    # -- one shard: stall and corruption policies ------------------------------

    def _decode_shard(
        self, epoch: int, cursor: int, index: int, skip: int = 0
    ) -> Iterator[Tuple[ColumnarBatch, int, int, int]]:
        """(chunk, epoch, cursor, start) of one shard's decoded chunks from
        its record ``skip`` on: ``start`` is the index of the chunk's first
        record among the shard's emitted records. ``on_corrupt`` applies
        (``_decode_shard_inner``), then ``on_stall``: a stall that outlived
        the retries propagates (``raise``) or drops the rest of the shard
        as a ``shard_stalled`` event (``skip_shard``). With the epoch cache
        the shard is served from its entry or decoded and populated
        (``_decode_shard_caching``)."""
        try:
            if self._cache is not None:
                yield from self._decode_shard_caching(epoch, cursor, index, skip)
            else:
                yield from self._decode_shard_inner(epoch, cursor, index, skip)
        except StallError as e:
            if self.options.on_stall != "skip_shard":
                raise
            self._note_skipped_shard(index, str(e), kind="shard_stalled")

    def _decode_shard_caching(self, epoch: int, cursor: int, index: int, skip: int):
        """The cache around one shard's decode: a validated entry serves
        its chunks as mmap views; a miss decodes the TFRecord source and,
        on a pass from the shard's first record, appends each chunk to a
        staging entry committed at the shard's end. Any exception through
        the decode, ``GeneratorExit`` of an abandoned iterator included,
        aborts the staging entry: only whole shards are cached."""
        shard = self.shards[index]
        entry = self._cache.open_entry(shard)
        if entry is not None:
            yield from self._serve_cached(entry, epoch, cursor, index, skip)
            return
        # a resume inside the shard decodes a suffix: never cached
        pop = self._cache.populator(shard) if skip == 0 else None
        if pop is None:
            yield from self._decode_shard_inner(epoch, cursor, index, skip)
            return
        try:
            for item in self._decode_shard_inner(epoch, cursor, index, 0):
                pop.append(item[0], item[3])
                yield item
        except BaseException:
            pop.abort()
            raise
        pop.commit()

    def _serve_cached(self, entry, epoch: int, cursor: int, index: int, skip: int):
        """A cached shard's chunks from record ``skip`` on, at the chunk
        boundaries of the populating pass and with absolute record indices,
        so a position taken on a cached read resumes on an uncached one and
        back; a resume inside a chunk slices it (``slice_batch``). Each
        chunk lands in the ``cache.serve`` stage and span."""
        dtype_of = self._cache_dtypes.__getitem__
        path = self.shards[index].path
        for i in range(entry.num_chunks):
            start, n = entry.chunk_span(i)
            if n == 0 or start + n <= skip:
                continue
            with timed("cache.serve", METRICS) as t, trace("tfr:cache"), \
                    telemetry.span("cache.serve", shard=path) as sp:
                chunk = entry.chunk_batch(i, dtype_of)
                if skip > start:
                    chunk = slice_batch(chunk, skip - start, chunk.num_rows)
                    start = skip
                t.records += chunk.num_rows
                sp.set(rows=chunk.num_rows)
            yield chunk, epoch, cursor, start

    def _decode_shard_inner(self, epoch: int, cursor: int, index: int, skip: int):
        """``on_corrupt``: ``skip_record`` decodes the salvage scan's
        frames (a spent quota escalates to ``corrupt_fallback``),
        ``skip_shard`` ends the shard at its first corrupt chunk (counted
        in ``read.corrupt_records`` and ``read.skipped_shards``), ``raise``
        takes the strict routes."""
        mode = self.options.on_corrupt
        if mode == "skip_record":
            try:
                yield from self._decode_shard_salvage(epoch, cursor, index, skip)
            except CorruptQuotaError as e:
                if self.options.corrupt_fallback != "skip_shard":
                    raise wire.TFRecordCorruptionError(str(e)) from e
                self._note_skipped_shard(index, str(e))
            return
        if mode != "skip_shard":
            yield from self._decode_shard_strict(epoch, cursor, index, skip)
            return
        try:
            yield from self._decode_shard_strict(epoch, cursor, index, skip)
        except wire.TFRecordCorruptionError as e:
            METRICS.count("read.corrupt_records")
            self._note_skipped_shard(index, str(e))

    def _note_skipped_shard(self, index: int, reason: str, kind: str = "shard_skipped") -> None:
        log_salvage_event(path=self.shards[index].path, kind=kind, error=reason)
        METRICS.count("read.skipped_shards")

    def _retrying(self, make_attempt: Callable[[], Iterator[tuple]]) -> Iterator[tuple]:
        """Shard-level retry of every route: an IO or corruption error
        restarts the attempt under ``retry_policy`` (``read.retries``, a
        ``read.retry`` instant); each attempt skips the records its route
        already yielded, so a retry duplicates and drops nothing."""
        pol = self.retry_policy
        attempt = 0
        start = pol.clock()
        while True:
            try:
                yield from make_attempt()
                return
            except (OSError, wire.TFRecordCorruptionError):
                attempt += 1
                if not pol.pause(attempt, start):
                    raise
                METRICS.count("read.retries")
                telemetry.instant("read.retry", attempt=attempt)

    def _guarded_open_fn(self) -> Callable[[str, Optional[str]], Any]:
        """The (path, codec) opener of the span streams: the stall guard's
        when one is set, else ``wire.open_compressed``, which hands a URL's
        read ``retry_policy``, so its block fetches resume under the same
        budget as the shard-level retries."""
        if self._stall_guard is not None:
            return self._stall_guard.open_compressed
        pol = self.retry_policy
        return lambda path, codec: wire.open_compressed(path, "rb", codec, retry_policy=pol)

    def _readahead_for(self, path: str):
        """The ``make_hint`` of a span stream: the readahead hinter over
        the opened handle, at the window of the moment; none for a URL
        (no page cache to advise)."""

        def make_hint(fh):
            if _fs.has_scheme(path):
                return None
            try:
                return _make_readahead(fh, os.path.getsize(path), self.readahead_bytes)
            except OSError:
                return None

        return make_hint

    # -- routes ----------------------------------------------------------------

    def _emit_chunks(self, slabs: Iterator[tuple], epoch: int, cursor: int, index: int,
                     next_index: List[int]) -> Iterator[tuple]:
        """Chunk-decode a (buf, offsets, lengths) slab stream from record
        ``next_index[0]`` on, yielding (chunk, epoch, cursor, start) and
        advancing ``next_index`` past each chunk yielded (the Python and
        salvage routes)."""
        chunk_records = max(self.batch_size, MIN_CHUNK_RECORDS)
        path = self.shards[index].path
        base = 0
        for buf, offsets, lengths in slabs:
            n = len(offsets)
            if base + n <= next_index[0]:
                base += n
                continue
            for start in range(max(0, next_index[0] - base), n, chunk_records):
                stop = min(start + chunk_records, n)
                offs, lens = offsets[start:stop], lengths[start:stop]
                with timed("decode", METRICS) as t, trace("tfr:decode"), \
                        telemetry.span("decode", shard=path) as sp:
                    if self._native_decoder is not None:
                        chunk = self._native_decoder.decode_spans(buf, offs, lens)
                    else:
                        chunk = self._python_decode(
                            [bytes(buf[o:o + m]) for o, m in zip(offs.tolist(), lens.tolist())])
                    t.records += chunk.num_rows
                    t.bytes += int(lens.sum())
                    sp.set(rows=chunk.num_rows)
                yield self._with_partitions(chunk, index), epoch, cursor, base + start
                next_index[0] = base + stop
            base += n

    def _decode_shard_salvage(self, epoch: int, cursor: int, index: int, skip: int):
        """``skip_record``: the frames the reader's salvage scan keeps (CRCs
        checked, corrupt regions resynced past and logged by a
        ``SalvageTracker``, which raises ``CorruptQuotaError`` past
        ``max_corrupt_records``), chunk-decoded from the ``skip``-th."""
        path = self.shards[index].path
        tracker = SalvageTracker(path, self.options)
        next_index = [skip]

        def attempt() -> Iterator[tuple]:
            tracker.reset()  # a retry re-scans the same regions
            return self._emit_chunks(
                salvage_spans_stream(path, on_event=tracker, slab_bytes=self.slab_bytes,
                                     max_record_bytes=self.max_record_bytes,
                                     open_fn=self._guarded_open_fn()),
                epoch, cursor, index, next_index)

        yield from self._retrying(attempt)

    def _decode_shard_strict(self, epoch: int, cursor: int, index: int, skip: int):
        """The strict routes: the native decoder's (mmap or stream), else
        the Python route over framed ``slab_bytes`` slabs."""
        if self._native_decoder is not None:
            yield from self._decode_shard_fused(epoch, cursor, index, skip)
            return
        path = self.shards[index].path
        next_index = [skip]

        def attempt() -> Iterator[tuple]:
            return self._emit_chunks(
                scan_spans_stream(path, self.options.verify_crc, slab_bytes=self.slab_bytes,
                                  max_record_bytes=self.max_record_bytes,
                                  make_hint=self._readahead_for(path),
                                  open_fn=self._guarded_open_fn()),
                epoch, cursor, index, next_index)

        yield from self._retrying(attempt)

    def _io_scratch(self) -> Dict[str, Any]:
        """The stream route's read buffer of the calling thread, reused
        across shards (``readinto``, no allocation a read)."""
        loc = self._scratch_local
        if not hasattr(loc, "scratch"):
            loc.scratch = {"buf": np.empty(min(self.slab_bytes, SCRATCH_INIT), np.uint8)}
        return loc.scratch

    def _refill_scratch(self, fh, scratch: Dict[str, Any], tail_len: int, path: str) -> int:
        """Fill the scratch buffer after the ``tail_len`` carried bytes (a
        partial frame), growing it first for a record larger than it; a
        declared length past ``max_record_bytes`` raises. Returns the
        valid length, or -1 at a clean end of file; a partial frame at
        the end raises."""
        buf = scratch["buf"]
        if tail_len >= 8:
            declared = int(buf[:8].view(np.uint64)[0])
            if declared > self.max_record_bytes:
                raise wire.TFRecordCorruptionError(
                    f"record length {declared} exceeds max_record_bytes "
                    f"({self.max_record_bytes}) in {path} — corrupt length field?")
            if 16 + declared > buf.nbytes:
                grown = np.empty(16 + declared, np.uint8)
                grown[:tail_len] = buf[:tail_len]
                scratch["buf"] = buf = grown
        reader = getattr(fh, "readinto", None)
        t0 = time.perf_counter()
        with telemetry.span("read", shard=path) as sp:
            if reader is not None:
                n = reader(memoryview(buf)[tail_len:])
            else:
                # no readinto (the stall guard's stream): one copy more
                data = fh.read(buf.nbytes - tail_len)
                n = len(data)
                buf[tail_len:tail_len + n] = np.frombuffer(data, np.uint8)
            sp.set(bytes=int(n or 0))
        dt = time.perf_counter() - t0
        METRICS.add("read.io", nbytes=int(n or 0), seconds=dt, latency=dt)
        if not n:
            if tail_len:
                raise wire.TFRecordCorruptionError(f"truncated TFRecord at end of {path}")
            return -1
        return tail_len + n

    def _decode_shard_fused(self, epoch: int, cursor: int, index: int, skip: int):
        """The native routes: a local uncompressed shard with ``use_mmap``
        takes the mmap route; any other shard (a URL among them) is read
        into the thread's scratch buffer and scanned + decoded there, one
        native call per chunk (the stream route). A partial frame at the
        buffer's end moves to its front before the next read."""
        path = self.shards[index].path
        codec = wire.codec_from_path(path)
        if self.use_mmap and codec is None and not _fs.has_scheme(path):
            yield from self._decode_shard_mmap(epoch, cursor, index, skip)
            return
        chunk_records = max(self.batch_size, MIN_CHUNK_RECORDS)
        next_index = [skip]
        dec = self._native_decoder
        verify = self.options.verify_crc
        scratch = self._io_scratch()
        open_fn = self._guarded_open_fn()

        def attempt() -> Iterator[tuple]:
            with _timed_open(path, open_fn) as fh:
                # the hint follows the stream's tell(): for a codec that is
                # the decoded offset, which only makes the window eager
                hint = self._readahead_for(path)(fh) or _noop_hint
                to_skip = next_index[0]
                abs_idx = 0  # the shard's record index at buffer position bpos
                data_len = bpos = 0
                while True:
                    buf = scratch["buf"]
                    tail_len = data_len - bpos
                    if tail_len and bpos:
                        buf[:tail_len] = buf[bpos:data_len].copy()
                    try:
                        hint(fh.tell())
                    except (AttributeError, OSError, ValueError):
                        hint = _noop_hint
                    data_len = self._refill_scratch(fh, scratch, tail_len, path)
                    if data_len < 0:
                        return
                    buf = scratch["buf"]
                    bpos = 0
                    while True:
                        with timed("decode", METRICS) as t, trace("tfr:decode"), \
                                telemetry.span("decode", shard=path) as sp:
                            cb, n_sk, n_done, consumed = dec.scan_decode(
                                buf, bpos, verify, to_skip, chunk_records, length=data_len,
                                max_record_bytes=self.max_record_bytes)
                            t.records += n_done
                            t.bytes += consumed - bpos
                            sp.set(rows=n_done)
                        to_skip -= n_sk
                        abs_idx += n_sk
                        bpos = consumed
                        if n_done == 0:
                            break  # a partial frame, or nothing, is left: read on
                        yield self._with_partitions(cb, index), epoch, cursor, abs_idx
                        abs_idx += n_done
                        next_index[0] = abs_idx

        yield from self._retrying(attempt)

    def _decode_shard_mmap(self, epoch: int, cursor: int, index: int, skip: int):
        """A local uncompressed shard: mmap it and scan + decode straight
        out of the page cache, one native call per chunk; the first call
        CRC-checks and passes over the records to skip. The open runs
        under ``open_deadline_ms`` when a guard is set (the reads are page
        faults, which no deadline can see)."""
        chunk_records = max(self.batch_size, MIN_CHUNK_RECORDS)
        next_index = [skip]
        dec = self._native_decoder
        verify = self.options.verify_crc
        path = self.shards[index].path

        def raw_open(p: str, _codec):
            if self._stall_guard is not None:
                return self._stall_guard.call_open(lambda: _open_local(p, "rb"), p)
            return _open_local(p, "rb")

        def attempt() -> Iterator[tuple]:
            with _timed_open(path, raw_open) as fh:
                size = os.fstat(fh.fileno()).st_size
                if size == 0:
                    return
                hint = _make_readahead(fh, size, self.readahead_bytes)
                mm = mmap.mmap(fh.fileno(), 0, prot=mmap.PROT_READ)
                buf = np.frombuffer(mm, np.uint8)
                try:
                    to_skip = next_index[0]
                    abs_idx = bpos = 0
                    while True:
                        hint(bpos)
                        with timed("decode", METRICS) as t, trace("tfr:decode"), \
                                telemetry.span("decode", shard=path) as sp:
                            cb, n_sk, n_done, consumed = dec.scan_decode(
                                buf, bpos, verify, to_skip, chunk_records, length=size,
                                max_record_bytes=self.max_record_bytes)
                            t.records += n_done
                            t.bytes += consumed - bpos
                            sp.set(rows=n_done)
                        to_skip -= n_sk
                        abs_idx += n_sk
                        bpos = consumed
                        if n_done == 0:
                            if bpos != size:  # a partial frame is all that is left
                                raise wire.TFRecordCorruptionError(
                                    f"truncated TFRecord at end of {path}")
                            return
                        yield self._with_partitions(cb, index), epoch, cursor, abs_idx
                        abs_idx += n_done
                        next_index[0] = abs_idx
                finally:
                    # decoded chunks copy or own their bytes, so only this view
                    # exports the map's buffer, unless an exception's traceback
                    # still holds it: then the map closes when that is collected
                    del buf
                    try:
                        mm.close()
                    except BufferError:
                        pass

        yield from self._retrying(attempt)

    def _with_partitions(self, chunk: ColumnarBatch, index: int) -> ColumnarBatch:
        """Partition values are constant within a shard: materialize them as
        constant columns over the chunk (JAX ``_attach_partition_chunk``)."""
        if not self._partition_fields:
            return chunk
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
        return chunk

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

    def chunk_dtypes(self) -> Dict[str, Any]:
        """name -> schema DataType of every column a decoded chunk can
        carry (the requested fields and the pack groups): what the epoch
        cache rebuilds chunks with."""
        dtypes: Dict[str, Any] = {f.name: f.data_type for f in self.schema}
        for gname, members in self.pack.items():
            dtypes[gname] = self._data_schema[members[0]].data_type
        return dtypes

    # -- identity --------------------------------------------------------------

    def _cache_ident(self) -> Dict[str, Any]:
        """What decides a decoded chunk's content, for the epoch cache's
        fingerprint (``cache.decode_fingerprint``): the JAX dataset's ident,
        key for key, so the two packages share entries. Options that only
        change how chunks are made are left out. ``fused`` says the chunks
        carry hashed and packed columns: both routes of the port hash and
        pack as the native decoder does, so it is True wherever there is
        something to fuse (the JAX dataset's Python route does not fuse,
        and its entries are keyed apart)."""
        ident: Dict[str, Any] = {
            "schema": self._data_schema.to_json(),
            "partition_fields": [f.name for f in self._partition_fields],
            "record_type": self.options.record_type.value,
            "hash_buckets": self.hash_buckets,
            "pack": self.pack,
            "verify_crc": self.options.verify_crc,
            "max_record_bytes": self.max_record_bytes,
        }
        if self.hash_buckets or self.pack:
            ident["fused"] = True
        return ident

    def fingerprint(self) -> str:
        """Digest of what a resume position depends on, as the JAX dataset
        computes it: the global shard list (paths and sizes), the process
        slot, the shuffle settings, the record type, and with
        ``shuffle_window`` the window and the batch size (``window_emitted``
        counts batches)."""
        if self._fingerprint is None:
            ident = {
                "shards": [(sh.path, sh.size) for sh in self._reader.shards],
                "process_index": self.process_index,
                "process_count": self.process_count,
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


def _put(out: queue.Queue, item, stop: threading.Event, wait_counter: Optional[str] = None) -> bool:
    """Enqueue, polling ``stop`` so that a consumer that went away never
    leaves the producer blocked on a full queue; a put that found the
    queue full counts once in ``wait_counter``."""
    blocked = False
    while not stop.is_set():
        try:
            out.put(item, timeout=0.1)
            return True
        except queue.Full:
            if wait_counter and not blocked:
                blocked = True
                METRICS.count(wait_counter)
    return False


def _produce(ds: TFRecordDataset, start: IteratorState, out: queue.Queue,
             stop: threading.Event, control: Optional[autotune.PipelineControl] = None) -> None:
    """The producer thread: (batch, end position) pairs from ``start`` on,
    then None at the end, or the exception that stopped it. A module-level
    function, so the thread holds no reference to the iterator and an
    abandoned iterator can be collected."""
    try:
        emit = _emit_shuffled if ds.shuffle_window else _emit_in_order
        if emit(ds, start, out, stop, control):
            _put(out, None, stop)
    except BaseException as e:  # re-raised in the consumer by CheckpointableIterator.__next__
        _put(out, e, stop)


def _emit_in_order(ds: TFRecordDataset, start: IteratorState, out: queue.Queue,
                   stop: threading.Event, control=None) -> bool:
    """Cut the chunk stream into batches in stream order, each with the
    position after its last row; False if the consumer went away."""
    pending: Deque[list] = collections.deque()
    avail = 0
    with contextlib.closing(ds._chunks(stop, start, control)) as chunks:
        for chunk, epoch, cursor, chunk_start in chunks:
            if stop.is_set():
                return False
            if chunk.num_rows == 0:
                continue
            pending.append([chunk, 0, epoch, cursor, chunk_start])
            avail += chunk.num_rows
            while avail >= ds.batch_size:
                if not _put(out, _take(pending, ds.batch_size), stop, BACKPRESSURE):
                    return False
                avail -= ds.batch_size
    if avail and not ds.drop_remainder:
        return _put(out, _take(pending, avail), stop, BACKPRESSURE)
    return True


class _ShardJob:
    """One shard's decode in the pool: its task, the bounded queue its
    worker fills with ("chunk", tuple), then ("end", None) or ("error",
    exception), and the watchdog's view of it. ``beat`` is the worker's
    progress stamp (monotonic seconds), renewed at every chunk handed over
    and at every poll of a blocked put, so a worker waiting on a full
    queue never looks stalled; ``wedged`` and ``failed`` (a
    ``WatchdogError``) are set when the beat went silent; ``thread`` is
    the worker that took the job."""

    __slots__ = ("task", "out", "beat", "failed", "wedged", "thread")

    def __init__(self, task: Tuple[int, int, int, int], depth: int, now: float = 0.0):
        self.task = task
        self.out: queue.Queue = queue.Queue(maxsize=depth)
        self.beat = now
        self.failed: Optional[BaseException] = None
        self.wedged = False
        self.thread: Optional[threading.Thread] = None


def _parallel_chunks(ds: TFRecordDataset, stop: threading.Event,
                     state: Optional[IteratorState] = None,
                     control: Optional[autotune.PipelineControl] = None) -> Iterator[tuple]:
    """Ordered parallel shard decode from ``state`` on, with the JAX
    ``_parallel_chunks``'s watchdog and resizable pool.

    A dispatcher enumerates the shard tasks lazily and hands each to the
    workers through a task queue, after queueing its job on the order
    queue. This generator (run by the producer) drains the jobs' queues in
    task order, so its chunks are the sequential stream's for any worker
    count, which is what lets a ``control`` (autotune) resize the pool
    mid-epoch: growth spawns workers on the same task queue, shrinking
    lets surplus workers retire between shards (``should_exit``). The
    queues are sized to the control's ceiling.

    With ``watchdog_timeout_ms`` a watchdog thread scans the jobs in
    flight: a worker whose beat is older than the timeout (blocked in a
    read that never returns) has its job failed with a ``WatchdogError``
    and a replacement worker is started (``read.stalls``,
    ``read.watchdog_restarts``). This generator applies ``on_stall`` to
    the failed job once it has drained the chunks made before the stall.

    A worker's exception is raised here, where its shard's chunks stop.
    ``stop``, the end of the stream, an error or closing the generator
    stops every thread; the generator joins them before it returns, all
    but a wedged worker, which is left blocked in its read."""
    n_workers = ds.num_workers if control is None else control.workers
    cap = n_workers if control is None else max(control.max_workers, n_workers)
    halt = threading.Event()
    task_q: queue.Queue = queue.Queue(maxsize=cap)
    order_q: queue.Queue = queue.Queue(maxsize=cap + 1)
    end = object()
    clock = time.monotonic
    wd_ms = ds.options.watchdog_timeout_ms
    wd_timeout = wd_ms / 1000.0 if wd_ms else None
    inflight: Dict[int, _ShardJob] = {}
    lock = threading.Lock()  # inflight, threads and stuck
    threads: List[threading.Thread] = []
    stuck: set = set()  # workers of wedged jobs: never joined
    names = itertools.count()

    def put_checked(q: queue.Queue, item, job: Optional[_ShardJob] = None) -> bool:
        while not halt.is_set():
            if job is not None:
                job.beat = clock()  # blocked on a full queue is not a stall
                if job.wedged:
                    return False
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def start(target, name: str) -> None:
        t = threading.Thread(target=target, name=name, daemon=True)
        with lock:
            threads.append(t)
        t.start()

    def spawn_worker() -> None:
        start(worker, f"tfrecord-decode-{next(names)}")

    def dispatcher() -> None:
        try:
            for task in ds._shard_tasks(state):
                job = _ShardJob(task, SHARD_QUEUE_CHUNKS, clock())
                if not (put_checked(order_q, job) and put_checked(task_q, job)):
                    return
            put_checked(order_q, end)
        except BaseException as e:  # raised by the generator below, in order
            put_checked(order_q, e)
        finally:
            if control is not None:
                put_checked(task_q, end)  # one sentinel, passed on by each worker
            else:
                for _ in range(n_workers):
                    if not put_checked(task_q, end):
                        break

    def worker() -> None:
        permitted = False  # retired by the control
        replaced = False  # declared wedged: a replacement holds this slot
        try:
            while not halt.is_set():
                if control is not None and control.should_exit():
                    permitted = True
                    return
                try:
                    job = task_q.get(timeout=0.1)
                except queue.Empty:
                    continue
                if job is end:
                    if control is not None:
                        put_checked(task_q, end)
                    return
                job.beat = clock()
                job.thread = threading.current_thread()
                with lock:
                    inflight[id(job)] = job
                    METRICS.gauge("read.inflight_workers", len(inflight))
                try:
                    for item in ds._decode_shard(*job.task):
                        if not put_checked(job.out, ("chunk", item), job):
                            return
                        job.beat = clock()
                    if not job.wedged:
                        put_checked(job.out, ("end", None), job)
                except BaseException as e:  # raised by the generator below, in order
                    if not job.wedged:
                        put_checked(job.out, ("error", e), job)
                    return
                finally:
                    with lock:
                        # decided under the lock: a job either completes or
                        # is declared wedged and replaced, never both
                        inflight.pop(id(job), None)
                        METRICS.gauge("read.inflight_workers", len(inflight))
                        replaced = job.wedged
                if replaced:
                    return
        finally:
            if control is not None and not replaced:
                control.note_exit(permitted)

    def watchdog() -> None:
        interval = max(0.01, wd_timeout / 4.0)
        while not halt.wait(interval):
            now = clock()
            with lock:
                stale = [j for j in inflight.values()
                         if not j.wedged and now - j.beat > wd_timeout]
                for j in stale:
                    j.wedged = True
                    inflight.pop(id(j), None)
                    stuck.add(j.thread)
            for job in stale:
                path = ds.shards[job.task[2]].path
                job.failed = WatchdogError(
                    f"shard worker made no progress for {wd_timeout * 1000:.0f} ms on {path}")
                METRICS.count("read.stalls")
                METRICS.count("read.watchdog_restarts")
                telemetry.instant("watchdog_restart", path=path)
                log_salvage_event(path=path, kind="watchdog_restart", error=str(job.failed))
                # the wedged thread cannot be cancelled (it is blocked in a
                # C-level read): a fresh worker takes its slot in the pool,
                # and the wedged one's late exit is not booked
                spawn_worker()

    start(dispatcher, "tfrecord-dispatcher")
    if wd_timeout is not None:
        start(watchdog, "tfrecord-watchdog")
    if control is None:
        for _ in range(n_workers):
            spawn_worker()
    else:
        # the control brings the pool up to its target and grows it later
        control.bind_spawn(spawn_worker)

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
                try:
                    item = job.out.get(timeout=0.1)
                except queue.Empty:
                    if stop.is_set():
                        return
                    if job.failed is not None:
                        # every chunk made before the stall is out: on_stall
                        if ds.options.on_stall != "skip_shard":
                            raise job.failed
                        ds._note_skipped_shard(job.task[2], str(job.failed), kind="shard_stalled")
                        break
                    continue
                kind, payload = item
                if kind == "end":
                    break
                if kind == "error":
                    raise payload
                yield payload
    finally:
        halt.set()
        with lock:
            waiting = [t for t in threads if t not in stuck]
        for t in waiting:
            t.join()
        with lock:  # workers the watchdog started while the others stopped
            late = [t for t in threads if t not in stuck and t not in waiting]
        for t in late:
            t.join()


def _window_permutation(seed: int, start: IteratorState, n: int) -> np.ndarray:
    """The row permutation of the window that starts at ``start``: drawn
    from the seed and that position alone, as the JAX dataset draws it."""
    ss = np.random.SeedSequence(
        [seed & 0xFFFFFFFF, start.epoch, start.shard_cursor, start.record_offset])
    return np.random.default_rng(ss).permutation(n)


def _emit_shuffled(ds: TFRecordDataset, start: IteratorState, out: queue.Queue,
                   stop: threading.Event, control=None) -> bool:
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
            if not _put(out, (take_rows(window, perm[k * b:min((k + 1) * b, rows)]), pos), stop,
                        BACKPRESSURE):
                return False
        emit_skip = 0
        return True

    with contextlib.closing(ds._chunks(stop, win_start, control)) as chunks:
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
    span.

    With ``pulse_interval_s`` a ``telemetry.Pulse`` runs while the
    iterator is live. With ``autotune="on"`` the iterator builds a
    ``PipelineControl`` over its decode pool, prefetch queue, readahead
    window and stall guard (``_control``) and an ``AutotuneController``
    (``autotune``) that observes the pulse (at ``autotune_interval_s``
    when no pulse interval is set). With ``telemetry_spool_dir`` it holds
    the process's fleet spool. The end of the iteration, its failure or
    ``close()`` stops the pulse, with one last line, and releases the
    spool."""

    def __init__(self, dataset: TFRecordDataset, state: IteratorState):
        ds = self._ds = dataset
        self._consumed_state = state
        self._queue: queue.Queue = _ResizableQueue(maxsize=max(1, ds.prefetch))
        self._stop = threading.Event()
        self._done = False
        self._occupancy = telemetry.OccupancyEma(telemetry.OCCUPANCY_GAUGE)
        self._control: Optional[autotune.PipelineControl] = None
        self.autotune: Optional[autotune.AutotuneController] = None
        pulse_interval = ds.options.pulse_interval_s
        if ds.options.autotune == "on" and ds.options.service is not None:
            logger.warning(
                "autotune disabled: this iterator is service-backed "
                "(options.service=%r) — decode parallelism lives in the "
                "worker fleet, not in a local pool the controller could "
                "resize", ds.options.service,
            )
        elif ds.options.autotune == "on":
            self._control = autotune.PipelineControl(
                workers=ds.num_workers, queue=self._queue, dataset=ds, guard=ds._stall_guard)
            if pulse_interval is None:
                pulse_interval = ds.options.autotune_interval_s or autotune.DEFAULT_INTERVAL_S
            self.autotune = autotune.AutotuneController(self._control, interval_s=pulse_interval)
        # The fleet spool: a URL passes through untouched to the spool's
        # refusal (abspath would turn "gs://b/s" into a private local dir);
        # a local dir is made absolute once, so acquire and release agree
        # on the registry key across a chdir.
        spool_dir = ds.options.telemetry_spool_dir
        if spool_dir is not None and not _fs.has_scheme(spool_dir):
            spool_dir = os.path.abspath(spool_dir)
        self._spool_dir = spool_dir
        if spool_dir is not None:
            # role None keeps the process's adopted trace-context role
            fleet.acquire_spool(spool_dir, role=ds.options.telemetry_role,
                                interval_s=ds.options.spool_interval_s)
            # releases an abandoned iterator's reference; _stop_pulse calls
            # it on a clean end (a finalizer runs once, so never twice)
            self._spool_finalizer = weakref.finalize(self, fleet.release_spool, spool_dir)
        self._pulse: Optional[telemetry.Pulse] = None
        if pulse_interval is not None:
            self._pulse = telemetry.Pulse(pulse_interval)
            if self.autotune is not None:
                self._pulse.add_observer(self.autotune.on_pulse)
            self._pulse.start()
            # an abandoned iterator stops its pulse too (the finalizer
            # holds the Pulse, never this object)
            weakref.finalize(self, telemetry.Pulse.stop, self._pulse, False)
        self._thread = threading.Thread(
            target=_produce, args=(ds, state, self._queue, self._stop, self._control),
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
        q = self._queue
        depth = q.qsize()
        self._occupancy.update(depth / q.maxsize)
        METRICS.gauge("prefetch.queue_depth", depth)
        t0_ns = time.perf_counter_ns()
        while True:
            try:
                item = q.get(timeout=0.1)
                break
            except queue.Empty:
                if self._stop.is_set():  # close()d
                    self._done = True
                    self._stop_pulse()
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

    def _stop_pulse(self) -> None:
        """Stop the pulse (one last line for the tail interval) and release
        the fleet spool (its final snapshot when this was the last
        reference); once."""
        pulse, self._pulse = self._pulse, None
        if pulse is not None:
            try:
                pulse.stop()
            except Exception:  # graftlint: swallow(telemetry teardown must not fail iterator close)
                pass
        if self._spool_dir is not None:
            try:
                self._spool_finalizer()  # once-only: safe vs the GC path
            except Exception:  # graftlint: swallow(telemetry teardown must not fail iterator close)
                pass

    def close(self) -> None:
        """Stop the producer and the pulse, drop the batches the producer
        queued, and join it."""
        self._done = True
        self._stop.set()
        self._stop_pulse()
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
