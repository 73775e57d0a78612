"""Dataset reader: per-shard record iterators + partition-aware scans.

Copy of ``tpu_tfrecord/io/reader.py`` over the port's local filesystem and
native library. The span streams take the opener of the dataset
(``open_fn``: its stall guard's, when one is set) and a readahead hint
(``make_hint``). Left out: the row reader's stall guard.

The reference's read path (SURVEY.md §3.1):
DefaultSource.buildReader + TFRecordFileReader. One ShardReader per file
(the reference's one-Spark-task-per-file unit, isSplitable=false at
DefaultSource.scala:26-29), opened lazily, closed eagerly at EOF and
guaranteed closed via context-manager/close() (mirroring the task-completion
listener + early close at TFRecordFileReader.scala:34-57).

Partition columns parsed from ``col=value`` directories are appended to each
row (Spark does this in FileScanRDD outside the connector; here it is
explicit), with Spark-style type inference (long -> double -> string).
"""

from __future__ import annotations

import gzip
import time
import zlib
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np

from tpu_tfrecord_torch import _native, telemetry, wire
from tpu_tfrecord_torch.infer import (
    byte_array_schema,
    infer_from_records,
    merge_type_maps,
    type_map_from_precedences,
    type_map_to_schema,
)
from tpu_tfrecord_torch.io import paths as p
from tpu_tfrecord_torch.io.paths import Shard
from tpu_tfrecord_torch.metrics import METRICS, log_salvage_event, timed
from tpu_tfrecord_torch.options import RecordType, TFRecordOptions
from tpu_tfrecord_torch.schema import StructField, StructType
from tpu_tfrecord_torch.serde import Row, TFRecordDeserializer, decode_record
from tpu_tfrecord_torch.tracing import trace


def _open_plain(path: str, codec: Optional[str]):
    return wire.open_compressed(path, "rb", codec)


def _timed_open(path: str, open_fn: Optional[Callable[[str, Optional[str]], Any]] = None,
                codec: Optional[str] = "auto"):
    """Open a shard through ``open_fn(path, codec)``
    (``wire.open_compressed`` by default) under the ``read.open`` latency
    histogram, a ``tfr:open`` profiler region and an ``open`` span.
    ``codec="auto"`` takes the codec from the extension."""
    if codec == "auto":
        codec = wire.codec_from_path(path)
    with timed("read.open", METRICS), trace("tfr:open"), telemetry.span("open", shard=path):
        return (open_fn or _open_plain)(path, codec)


def _timed_read(fh, want: int, path: str) -> bytes:
    """One slab read under the ``read.io`` latency histogram and a ``read``
    span. An exception propagates untouched and records no totals."""
    with telemetry.span("read", shard=path) as sp:
        t0 = time.perf_counter()
        data = fh.read(want)
        dt = time.perf_counter() - t0
        sp.set(bytes=len(data))
    METRICS.add("read.io", nbytes=len(data), seconds=dt, latency=dt)
    return data


class CorruptQuotaError(Exception):
    """Internal escalation: a shard's ``max_corrupt_records`` quota is
    exhausted. Deliberately NOT a TFRecordCorruptionError/OSError subclass
    so it passes through the transient-retry nets untouched; the policy
    layer converts it to the configured ``corrupt_fallback`` behavior."""


class ShardSkip(Exception):
    """Internal signal: drop the rest of this shard (on_corrupt policy)."""


class SalvageTracker:
    """The ``on_event`` sink for one shard's salvage scan: logs each event
    as a structured warning, bumps the ``read.*`` counters, and enforces the
    per-shard policy (skip_shard escalates on the first event; skip_record
    escalates once ``max_corrupt_records`` is exceeded)."""

    def __init__(self, path: str, options: TFRecordOptions):
        self.path = path
        self.on_corrupt = options.on_corrupt
        self.quota = options.max_corrupt_records
        self.events = 0
        self._reported = 0  # high-water mark across transient-IO retries

    def reset(self) -> None:
        """Restart counting for a transient-IO retry re-scan: the same
        corrupt regions must not be double-counted against the quota, and
        (via the ``_reported`` high-water mark) must not re-increment the
        fleet counters or re-log — the salvage scan is deterministic, so
        event N of the re-scan is the same region as event N before."""
        self.events = 0

    def __call__(self, event: Dict[str, Any]) -> None:
        self.events += 1
        if self.events > self._reported:
            self._reported = self.events
            event = dict(event, path=self.path, policy=self.on_corrupt)
            log_salvage_event(**event)
            METRICS.count("read.corrupt_records")
            if event.get("resync_offset") is not None:
                METRICS.count("read.resyncs")
        if self.on_corrupt == "skip_shard":
            raise ShardSkip(
                f"corrupt frame at offset {event.get('offset')} in {self.path}"
            )
        if self.quota is not None and self.events > self.quota:
            raise CorruptQuotaError(
                f"{self.events} corrupt regions in {self.path} exceed "
                f"max_corrupt_records={self.quota}"
            )


# Codec-level decode failures that end a salvage scan: the TFRecord frames
# beyond a corrupt compressed region are unrecoverable (the decompressor
# loses sync), so these convert to one terminal 'codec' event instead of
# raising. Plain OSError is NOT here — it stays transient/retryable.
_CODEC_CORRUPTION = (
    wire.TFRecordCorruptionError,
    EOFError,
    zlib.error,
    gzip.BadGzipFile,
)


def salvage_spans_stream(
    path: str,
    on_event: Callable[[Dict[str, Any]], None],
    slab_bytes: int = 32 << 20,
    max_record_bytes: int = 1 << 30,
    codec: str = "auto",
    open_fn: Optional[Callable[[str, Optional[str]], Any]] = None,
) -> Iterator[tuple]:
    """Corruption-tolerant twin of ``scan_spans_stream``: yields
    (buf, offsets, lengths) span batches of VALID frames only, and instead
    of raising at the first bad frame, reports it through ``on_event`` and
    resyncs (wire.resync) to the next plausible header — every record
    before and after a corrupt region is salvaged. CRCs are always verified
    here: they are the detection mechanism.

    Events are dicts with ``offset`` (decoded-stream byte offset of the
    corrupt region), ``kind`` (``length_crc`` | ``data_crc`` | ``length`` |
    ``truncated`` | ``codec``), ``resync_offset`` (where scanning resumed;
    None when the rest of the stream was unrecoverable) and
    ``bytes_skipped``. ``on_event`` may raise to abort the scan (quota /
    skip-shard escalation); the exception propagates to the caller.

    Memory stays bounded exactly like the strict scanner: complete frames
    are yielded per slab and only a sub-frame tail (or the 11-byte resync
    window) carries between reads. ``codec="auto"`` takes the codec from
    the extension; an extensionless shard names it.
    """
    H, F = wire.HEADER_BYTES, wire.FOOTER_BYTES
    with _timed_open(path, open_fn, codec) as fh:
        buf = b""
        file_off = 0  # decoded-stream offset of buf[0]
        bad_at: Optional[int] = None  # absolute start of current corrupt region
        bad_kind = ""
        eof = False
        # An on_event exception mid-scan (quota / skip-shard escalation) is
        # DEFERRED until the current buffer's already-validated frames have
        # been yielded: everything salvaged before the escalation point is
        # delivered, and only then does the policy take over.
        escalate: Optional[BaseException] = None
        codec_dead = False  # a codec event already reported the stream loss
        while True:
            if not eof:
                want = slab_bytes
                if bad_at is None and len(buf) >= H:
                    # pending tail frame (header already CRC-validated and
                    # length-capped below): read enough to complete it
                    (declared,) = wire._LEN_STRUCT.unpack_from(buf, 0)
                    if declared <= max_record_bytes:
                        want = max(want, H + declared + F - len(buf))
                try:
                    data = _timed_read(fh, want, path)
                except _CODEC_CORRUPTION as e:
                    try:
                        on_event(
                            {
                                "kind": "codec",
                                "offset": file_off + len(buf),
                                "resync_offset": None,
                                "bytes_skipped": 0,
                                "error": str(e),
                            }
                        )
                    except BaseException as esc:  # re-raised after the validated frames are yielded
                        escalate = esc
                    data = b""
                    eof = True  # the decompressor lost sync: stream over
                    codec_dead = True
                if not data:
                    eof = True
                else:
                    buf += data
            spans: List[tuple] = []
            pos = 0
            n = len(buf)
            while escalate is None:
                if bad_at is not None:
                    r = wire.resync(buf, pos, max_record_bytes=max_record_bytes)
                    if r < 0:
                        # keep an 11-byte window: a header could straddle
                        # the slab boundary
                        pos = n if eof else max(pos, n - (H - 1))
                        break
                    try:
                        on_event(
                            {
                                "kind": bad_kind,
                                "offset": bad_at,
                                "resync_offset": file_off + r,
                                "bytes_skipped": file_off + r - bad_at,
                            }
                        )
                    except BaseException as esc:  # re-raised after the validated frames are yielded
                        escalate = esc
                        break
                    bad_at = None
                    pos = r
                if pos + H > n:
                    break
                (length,) = wire._LEN_STRUCT.unpack_from(buf, pos)
                (length_crc,) = wire._CRC_STRUCT.unpack_from(buf, pos + 8)
                if wire.masked_crc32c(buf[pos : pos + 8]) != length_crc:
                    bad_at, bad_kind = file_off + pos, "length_crc"
                    pos += 1
                    continue
                if length > max_record_bytes:
                    bad_at, bad_kind = file_off + pos, "length"
                    pos += 1
                    continue
                start = pos + H
                if start + length + F > n:
                    break  # tail: refill (or terminal truncation at EOF)
                (data_crc,) = wire._CRC_STRUCT.unpack_from(buf, start + length)
                if wire.masked_crc32c(buf[start : start + length]) != data_crc:
                    bad_at, bad_kind = file_off + pos, "data_crc"
                    pos += 1
                    continue
                spans.append((start, length))
                pos = start + length + F
            if spans:
                offsets = np.array([s for s, _ in spans], dtype=np.uint64)
                lengths = np.array([l for _, l in spans], dtype=np.uint64)
                yield buf, offsets, lengths
            if escalate is not None:
                raise escalate
            if pos:
                buf = buf[pos:]
                file_off += pos
            if eof:
                if bad_at is not None:
                    on_event(
                        {
                            "kind": bad_kind,
                            "offset": bad_at,
                            "resync_offset": None,
                            "bytes_skipped": file_off + len(buf) - bad_at,
                        }
                    )
                elif buf and not codec_dead:
                    # leftover partial frame after a codec failure is the
                    # SAME physical corruption the codec event already
                    # reported — a second event would double-charge the
                    # per-shard quota
                    on_event(
                        {
                            "kind": "truncated",
                            "offset": file_off,
                            "resync_offset": None,
                            "bytes_skipped": len(buf),
                        }
                    )
                return


class ShardReader:
    """Lazy iterator of rows from one TFRecord shard.

    The TFRecordFileReader equivalent: opens the (possibly compressed) stream
    on first ``next()``, decodes each record through the schema-driven
    deserializer, closes eagerly at EOF, and is safe to close twice.
    """

    def __init__(
        self,
        shard: Shard,
        data_schema: StructType,
        options: TFRecordOptions,
        partition_tail: Sequence[Any] = (),
    ):
        self.shard = shard
        self._options = options
        self._deserializer = TFRecordDeserializer(data_schema)
        self._partition_tail = list(partition_tail)
        self._fh = None
        self._reader = None
        self._closed = False

    def _ensure_open(self) -> None:
        if self._reader is None and not self._closed:
            self._fh = _timed_open(self.shard.path)
            self._reader = wire.RecordReader(self._fh, verify_crc=self._options.verify_crc)

    def close(self) -> None:
        self._closed = True
        if self._fh is not None:
            try:
                self._fh.close()
            finally:
                self._fh = None
                self._reader = None

    def __enter__(self) -> "ShardReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __iter__(self) -> Iterator[Row]:
        if self._options.on_corrupt != "raise":
            yield from self._iter_tolerant()
            return
        record_type = self._options.record_type
        tail = self._partition_tail
        # Time only the fetch+decode work, never the time the generator
        # spends suspended at yield (consumer compute is not read time).
        records = 0
        nbytes = 0
        seconds = 0.0
        clock = time.perf_counter
        try:
            self._ensure_open()
            if self._reader is None:
                return
            while True:
                t0 = clock()
                record = self._reader.read()
                if record is None:
                    seconds += clock() - t0
                    break
                row = decode_record(self._deserializer, record_type, record)
                seconds += clock() - t0
                records += 1
                nbytes += len(record)
                if tail:
                    row = row + tail
                yield row
        finally:
            self.close()
            METRICS.add("read", records=records, nbytes=nbytes, seconds=seconds)

    def _iter_tolerant(self) -> Iterator[Row]:
        """Row iteration under on_corrupt='skip_record'/'skip_shard': frames
        stream through the salvage scanner (which owns its file handle), so
        a corrupt frame costs one record — or, under skip_shard / quota
        escalation, the rest of this shard — never the whole read."""
        if self._closed:
            return
        opts = self._options
        tracker = SalvageTracker(self.shard.path, opts)
        record_type = opts.record_type
        deserializer = self._deserializer
        tail = self._partition_tail
        records = 0
        nbytes = 0
        seconds = 0.0
        clock = time.perf_counter
        try:
            # Same timing contract as the strict path: count fetch+decode,
            # never the time the generator spends suspended at yield.
            t0 = clock()
            for buf, offsets, lengths in salvage_spans_stream(
                self.shard.path, on_event=tracker
            ):
                for o, l in zip(offsets.tolist(), lengths.tolist()):
                    record = bytes(buf[o : o + l])
                    row = decode_record(deserializer, record_type, record)
                    records += 1
                    nbytes += len(record)
                    if tail:
                        row = row + tail
                    seconds += clock() - t0
                    yield row
                    t0 = clock()
            seconds += clock() - t0
        except ShardSkip as e:
            log_salvage_event(
                path=self.shard.path, kind="shard_skipped", error=str(e)
            )
            METRICS.count("read.skipped_shards")
        except CorruptQuotaError as e:
            if opts.corrupt_fallback == "skip_shard":
                log_salvage_event(
                    path=self.shard.path, kind="shard_skipped", error=str(e)
                )
                METRICS.count("read.skipped_shards")
            else:
                raise wire.TFRecordCorruptionError(str(e)) from e
        finally:
            self.close()
            METRICS.add("read", records=records, nbytes=nbytes, seconds=seconds)


def scan_spans_stream(
    path: str,
    verify_crc: bool,
    slab_bytes: int = 32 << 20,
    max_record_bytes: int = 1 << 30,
    max_records: Optional[int] = None,
    make_hint=None,
    open_fn: Optional[Callable[[str, Optional[str]], Any]] = None,
) -> Iterator[tuple]:
    """Stream one shard as (buf, offsets, lengths) span batches — the ONE
    owner of the slab framing loop (bounded tail-carry: a partial trailing
    frame carries into the next slab; a declared length beyond
    max_record_bytes raises instead of buffering the rest of a corrupt
    shard). Used by io/dataset's compressed-shard decode and by the native
    inference seqOp.

    ``max_records`` stops cleanly after that many records WITHOUT framing or
    CRC-checking the bytes beyond them — record-limited consumers (schema
    inference sampling) thereby match the lazy per-record reader on shards
    whose corruption lies past the limit. ``make_hint(fh)`` may return a
    ``hint(pos)`` readahead callback (the dataset's sliding
    ``posix_fadvise`` window), called with the stream position before
    each read."""
    remaining = max_records
    with _timed_open(path, open_fn) as fh:
        hint = make_hint(fh) if make_hint is not None else None
        carry = b""
        while remaining is None or remaining > 0:
            if hint is not None:
                try:
                    hint(fh.tell())
                except (AttributeError, OSError, ValueError):
                    hint = None
            want = slab_bytes
            if len(carry) >= 8:
                declared = int.from_bytes(carry[:8], "little")
                if declared > max_record_bytes:
                    raise wire.TFRecordCorruptionError(
                        f"record length {declared} exceeds max_record_bytes "
                        f"({max_record_bytes}) in {path} — corrupt length field?"
                    )
                want = max(want, 16 + declared - len(carry))
            data = _timed_read(fh, want, path)
            if not data:
                if carry:
                    raise wire.TFRecordCorruptionError(
                        f"truncated TFRecord at end of {path}"
                    )
                return
            buf = carry + data if carry else data
            offsets, lengths, consumed = _native.scan_partial(
                buf, verify_crc, max_records=remaining
            )
            if len(offsets) == 0:
                # not even one complete record yet: keep accumulating
                # (bounded by the declared-length check above)
                carry = buf
                continue
            carry = buf[consumed:]
            if remaining is not None:
                remaining -= len(offsets)
            yield buf, offsets, lengths


class DatasetReader:
    """Plan + execute a read over many shards with partition merging.

    The planning half mirrors DefaultSource.inferSchema/buildReader
    (DefaultSource.scala:31-39, 118-136); execution iterates shards in the
    deterministic discovery order.
    """

    def __init__(self, paths_in, options: Optional[TFRecordOptions] = None, **option_kwargs):
        self.options = options or TFRecordOptions.from_map(option_kwargs)
        self.shards = p.discover_shards(paths_in)
        self._partition_cols = p.partition_columns_of(self.shards)
        self._partition_types = {
            col: p.infer_partition_type(
                sh.partitions.get(col) for sh in self.shards
            )
            for col in self._partition_cols
        }
        self._schema: Optional[StructType] = None

    # -- schema -------------------------------------------------------------

    @property
    def partition_schema(self) -> StructType:
        return StructType(
            [
                StructField(c, self._partition_types[c], True)
                for c in self._partition_cols
            ]
        )

    def schema(self) -> StructType:
        """Full schema: data schema + appended partition columns.

        If the user supplied a schema it wins (reference: user schema skips
        inference, DefaultSource.scala:31-39); partition columns the user did
        not mention are appended.
        """
        if self._schema is not None:
            return self._schema
        if self.options.schema is not None:
            base = self.options.schema
        else:
            base = self._infer_data_schema()
        fields = list(base.fields)
        names = {f.name for f in fields}
        for col in self._partition_cols:
            if col not in names:
                fields.append(StructField(col, self._partition_types[col], True))
        self._schema = StructType(fields)
        return self._schema

    def data_schema(self) -> StructType:
        """Schema of what is physically inside the records (partition
        columns excluded)."""
        return self.schema().drop(self._partition_cols)

    _INFER_SLAB_BYTES = 32 << 20
    # effectively uncapped: the per-record reader this path replaces reads
    # records of ANY declared size, so inference must too — a real cap here
    # would make schema results depend on whether the native build is active
    _INFER_MAX_RECORD_BYTES = 1 << 62

    def _shard_type_map(self, shard: Shard) -> Dict[str, Any]:
        """One shard's seqOp: the native wire-walk inference (GIL-released
        C++, which is what lets the thread-pooled all-files entry scale);
        the Python fold for ByteArray. ``infer_sample_limit`` is pushed
        into the span scan, so bytes past the sampled records are never
        framed or CRC-checked (exactly like the lazy per-record reader)."""
        limit = self.options.infer_sample_limit
        if self.options.record_type != RecordType.BYTE_ARRAY:
            # With a small sample limit, a full-size slab would read (and on
            # a cold store, fetch) far more than the sample needs — size the
            # slab generously per record but keep the ceiling.
            slab = self._INFER_SLAB_BYTES
            if limit is not None:
                slab = min(slab, max(1 << 20, 4096 * limit))
            with _native.InferScanner(self.options.record_type) as scanner:
                for buf, offsets, lengths in scan_spans_stream(
                    shard.path,
                    self.options.verify_crc,
                    slab_bytes=slab,
                    max_record_bytes=self._INFER_MAX_RECORD_BYTES,
                    max_records=limit,
                ):
                    scanner.update(buf, offsets, lengths)
                return type_map_from_precedences(scanner.result())
        return infer_from_records(
            wire.read_records(shard.path, verify_crc=self.options.verify_crc),
            self.options.record_type,
            limit=limit,
        )

    def _salvage_type_map(self, shard: Shard) -> Dict[str, Any]:
        """Inference fallback over a corrupt shard: fold the type map over
        its salvageable records only. Events are deliberately NOT logged or
        counted here — the tolerant read that follows reports each region
        exactly once; inference double-counting would skew the fleet
        counters."""

        def records():
            for buf, offsets, lengths in salvage_spans_stream(
                shard.path, on_event=lambda _ev: None
            ):
                for off, length in zip(offsets.tolist(), lengths.tolist()):
                    yield bytes(buf[off : off + length])

        return infer_from_records(
            records(),
            self.options.record_type,
            limit=self.options.infer_sample_limit,
        )

    def _infer_data_schema(self) -> StructType:
        """First non-empty file whose records yield a non-empty schema —
        single scan per candidate file (the reference scans the winning file
        twice via hasSchema + getSchemaFromFile, DefaultSource.scala:36-37;
        we keep the first scan's result)."""
        if self.options.record_type == RecordType.BYTE_ARRAY:
            return byte_array_schema()
        tolerant = self.options.on_corrupt != "raise"
        for shard in self.shards:
            if shard.size == 0:
                continue
            try:
                type_map = self._shard_type_map(shard)
            except wire.TFRecordCorruptionError:
                if not tolerant:
                    raise
                # under a tolerant read policy a corrupt candidate is not
                # fatal: infer from this shard's salvageable records (the
                # same frames the tolerant read will deliver)
                type_map = self._salvage_type_map(shard)
            if type_map:
                return type_map_to_schema(type_map)
        raise ValueError(
            "Could not infer schema: no non-empty TFRecord file found under "
            f"{[s.path for s in self.shards][:5]}..."
            if self.shards
            else "Could not infer schema: no input files"
        )

    def local_type_map(
        self, shards: Optional[Sequence[Shard]] = None, num_workers: int = 1
    ) -> Dict[str, Any]:
        """The per-host seqOp fold: type map over ``shards`` (default: all
        of this reader's shards).

        ``num_workers > 1`` runs the per-shard seqOp in a thread pool — the
        within-host analog of the reference's executor-parallel RDD
        aggregate (TensorFlowInferSchema.scala:40-43); the native wire walk
        releases the GIL, so shards scan concurrently on a multi-core host.
        Partials merge in shard order regardless of completion order, so
        the result is identical to the serial scan."""
        shards = self.shards if shards is None else list(shards)

        def seq_op(shard: Shard):
            try:
                return self._shard_type_map(shard)
            except Exception as e:
                # annotate WHICH shard failed (wire errors don't all carry
                # the path) without changing the exception type the callers
                # pin (corruption tests expect TFRecordCorruptionError)
                if (
                    e.args
                    and isinstance(e.args[0], str)
                    and shard.path not in e.args[0]
                ):
                    e.args = (f"{e.args[0]} (shard {shard.path})",) + e.args[1:]
                raise
        if num_workers > 1 and len(shards) > 1:
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(
                max_workers=min(num_workers, len(shards))
            ) as pool:
                partials = list(pool.map(seq_op, shards))
        else:
            partials = map(seq_op, shards)
        merged: Dict[str, Any] = {}
        for partial in partials:
            merged = merge_type_maps(merged, partial)
        return merged

    def infer_schema_all_files(self, num_workers: int = 1) -> StructType:
        """Inference over EVERY shard with the distributed merge algebra —
        the standalone TensorFlowInferSchema entry (SURVEY.md §3.3)."""
        return type_map_to_schema(self.local_type_map(num_workers=num_workers))

    def infer_schema_multihost(self, num_workers: int = 1) -> StructType:
        """Inference across the process group, the reference's RDD
        ``aggregate`` end to end (TensorFlowInferSchema.scala:40-43): each
        process folds the seqOp over its interleaved slice of the shards
        (``device.mesh.assign_shards``, the read path's split), then the
        partial maps are allgathered and merged, so every process returns
        the same schema. One process: the local fold. A local failure
        (a corrupt shard, types that clash inside the slice) is not raised
        before the collective, where it would leave the peers blocked: it
        rides the gather and every process raises
        ``DistributedInferenceError``."""
        from tpu_tfrecord_torch.device.distributed import merge_schema_across_hosts
        from tpu_tfrecord_torch.device.mesh import assign_shards

        mine = assign_shards(self.shards)
        local: Dict[str, Any] = {}
        err: Optional[str] = None
        exc: Optional[BaseException] = None
        try:
            local = self.local_type_map(mine, num_workers=num_workers)
        except Exception as e:  # noqa: BLE001 - encoded into the collective, raised below
            err = f"{type(e).__name__}: {e}"
            exc = e
        try:
            return merge_schema_across_hosts(local, local_error=err)
        except Exception as merged:
            if exc is not None:
                raise merged from exc  # keep the local traceback too
            raise

    # -- execution ----------------------------------------------------------

    def _shard_reader(
        self, shard: Shard, data_schema: StructType, required_partitions: List[str]
    ) -> ShardReader:
        tail = [
            p.cast_partition_value(
                shard.partitions.get(col), self._partition_types[col]
            )
            for col in required_partitions
        ]
        return ShardReader(shard, data_schema, self.options, tail)

    def readers(self, columns: Optional[List[str]] = None) -> List[ShardReader]:
        """One lazy reader per shard. ``columns`` prunes the schema the way
        Spark pushes requiredSchema into buildReader (DefaultSource.scala:131)."""
        full = self.schema()
        if columns is not None:
            required = full.select(columns)
        else:
            required = full
        part_set = set(self._partition_cols)
        data_schema = StructType([f for f in required if f.name not in part_set])
        required_partitions = [f.name for f in required if f.name in part_set]
        # Rows come out as data columns (in required order) + partition tail;
        # reorder to the exact required order if partitions interleave.
        readers = [
            self._shard_reader(sh, data_schema, required_partitions)
            for sh in self.shards
        ]
        out_order = [f.name for f in data_schema] + required_partitions
        want = [f.name for f in required]
        if out_order != want:
            perm = [out_order.index(n) for n in want]
            return [_ReorderingReader(r, perm) for r in readers]  # type: ignore[list-item]
        return readers

    def rows(self, columns: Optional[List[str]] = None) -> Iterator[Row]:
        for reader in self.readers(columns):
            yield from reader


class _ReorderingReader:
    """Wraps a ShardReader permuting each row to the required column order."""

    def __init__(self, inner: ShardReader, perm: List[int]):
        self._inner = inner
        self._perm = perm
        self.shard = inner.shard

    def close(self) -> None:
        self._inner.close()

    def __iter__(self) -> Iterator[Row]:
        perm = self._perm
        for row in self._inner:
            yield [row[i] for i in perm]
