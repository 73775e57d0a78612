"""Dataset writer: save modes, Hive-style partitionBy, atomic commit.

Copy of ``tpu_tfrecord/io/writer.py`` over the port's filesystems (local,
and fsspec URLs; ``http(s)://`` is read-only), native encoder and
metrics. With ``trace="on"`` the pipeline records the
JAX spans ``write.encode``, ``write.compress``, ``write.io`` (``rows``) and
``write.commit`` (``job``, ``shards``) on the flight recorder, beside the
``tracing.trace`` profiler regions; ``telemetry_port`` starts the
Prometheus endpoint. For the same rows, options and worker
count the files hold the same record bytes, in the same files and order,
as the JAX writer's (only the random job id in the names differs).

The reference's write path (SURVEY.md §3.2):
what Spark's FileFormatWriter + DefaultSource.prepareWrite +
TFRecordOutputWriter do together —

- save modes overwrite / append / ignore / error  (Spark semantics, pinned by
  reference TFRecordIOSuite.scala:184-237)
- ``partitionBy`` routes rows into ``col=value`` directories with the
  partition columns STRIPPED from the written records (README.md:195-207)
- per-shard writers with codec-compressed streams and '.tfrecord' + codec
  extension file names (DefaultSource.scala:105-114,
  TFRecordOutputWriter.scala:12-43)
- job-level atomicity: shards are written under ``_temporary/<job>/`` and
  moved into place on commit, then a ``_SUCCESS`` marker is written — the
  idempotent-commit plan from SURVEY.md §5 (the reference gets this from
  Spark's commit protocol).

Parallel write pipeline (``write_workers`` / ``num_shards`` options): the
reference gets write-side parallelism for free from Spark's one-writer-per-
task FileFormatWriter; with no executor underneath, this writer pipelines
within the task instead. Worker threads do the CPU-heavy stages — partition
slicing, native batch encode (GIL released), TFRecord framing + CRC, and
per-slab codec compression (wire.compress_chunk) — while the planner thread
routes slabs round-robin over per-partition shard streams and a FIFO
committer appends finished slabs in plan order. The bounded in-flight queue
provides backpressure; the plan-order sequencer makes the PIPELINE's output
bytes a pure function of (rows, options) — never of worker timing or worker
count (write_workers=1 vs N with fixed num_shards is byte-identical). The
default configuration (write_workers=1, num_shards unset) instead takes the
single-threaded path (the JAX writer's legacy path, same bytes);
with a codec its single-stream output legitimately differs from the
pipeline's per-slab chunked streams.
"""

from __future__ import annotations

import collections
import itertools
import json
import os
import socket
import time
import uuid
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable, Deque, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from tpu_tfrecord_torch import _native, fs as _fs, telemetry, wire
from tpu_tfrecord_torch.columnar import (
    ColumnarBatch,
    batch_to_rows,
    slice_batch,
    take_rows,
)
from tpu_tfrecord_torch.io import paths as p
from tpu_tfrecord_torch.metrics import METRICS, logger, timed
from tpu_tfrecord_torch.options import TFRecordOptions
from tpu_tfrecord_torch.retry import RetryPolicy
from tpu_tfrecord_torch.schema import ArrayType, StructType
from tpu_tfrecord_torch.serde import TFRecordSerializer, encode_row
from tpu_tfrecord_torch.tracing import trace

SAVE_MODES = ("error", "errorifexists", "overwrite", "append", "ignore")

# Rows buffered per partition before a slab is handed to the worker pool
# (write_rows pipelined path). Big enough that framing/compression dominate
# the per-slab overhead; small enough that depth*slab memory stays modest.
_ROW_SLAB = 4096

# Max rows per pipeline work item: large submissions are split so the pool
# load-balances (a handful of whole-batch slabs over N workers leaves
# workers idle in the tail round). A plan-time constant, so chunk
# boundaries — and therefore compressed bytes — stay deterministic.
_PIPE_SLAB = 8192


class ShardWriter:
    """Per-shard output file: serialize each row, frame it, stream it out.

    The TFRecordOutputWriter equivalent (reference TFRecordOutputWriter.scala:
    12-44): one instance per (task, partition-dir), owning one output stream.
    """

    def __init__(self, path: str, schema: StructType, options: TFRecordOptions):
        self.path = path
        self._serializer = TFRecordSerializer(schema)
        self._record_type = options.record_type
        self._fh = wire.open_compressed(path, "wb", options.codec)
        self._writer = wire.RecordWriter(self._fh)

    def write(self, row: Sequence[Any]) -> None:
        self._writer.write(encode_row(self._serializer, self._record_type, row))

    def write_serialized(self, record: bytes) -> None:
        """Frame and write one already-serialized record."""
        self._writer.write(record)

    def write_framed(self, framed: "bytes | memoryview", n_records: int) -> None:
        """Write an already-framed record stream (native encoder output)."""
        self._fh.write(framed)
        self._writer.records_written += n_records
        self._writer.bytes_written += len(framed)

    @property
    def records_written(self) -> int:
        return self._writer.records_written

    def close(self) -> None:
        self._fh.close()


class DatasetWriter:
    """Partition-aware, save-mode-aware dataset writer."""

    def __init__(
        self,
        output_path: str,
        schema: StructType,
        options: Optional[TFRecordOptions] = None,
        partition_by: Optional[List[str]] = None,
        mode: str = "error",
        max_records_per_file: Optional[int] = None,
        write_success: bool = True,
        retry_policy: Optional[RetryPolicy] = None,
    ):
        mode = (mode or "error").lower()
        if mode not in SAVE_MODES:
            raise ValueError(f"Unknown save mode {mode!r}; one of {SAVE_MODES}")
        self.output_path = os.fspath(output_path)
        # The filesystem seam (the reference's Hadoop FileSystem): local
        # paths use the standard library, URLs fsspec (``http(s)://`` is
        # read-only and raises). On object stores without atomic rename
        # the commit is copy+delete (see the ``fs`` docstring).
        self.fs = _fs.filesystem_for(self.output_path)
        self.options = options or TFRecordOptions()
        self.mode = mode
        self.partition_by = list(partition_by or [])
        # ctor arg wins over the option-level spelling (max_records_per_shard)
        self.max_records_per_file = (
            max_records_per_file
            if max_records_per_file is not None
            else self.options.max_records_per_shard
        )
        self.write_workers = max(1, int(self.options.write_workers))
        self.num_shards = self.options.num_shards
        # The flight recorder is process-global: "on" enables it, "off"
        # leaves it as another dataset or writer set it.
        if self.options.trace == "on":
            telemetry.enable()
        if self.options.telemetry_port is not None:
            telemetry.ensure_exporter(self.options.telemetry_port)
        # Transient-fault policy for commit-side filesystem ops (shard open,
        # rename into place, _SUCCESS marker) — the remote-FS path is
        # demonstrably flaky (tests/test_fs_faults.py). An explicit policy
        # wins (injectable sleep/clock for tests); write_retries is the
        # option-level spelling; the default stays fail-fast.
        self.retry_policy = (
            retry_policy
            if retry_policy is not None
            else RetryPolicy(max_retries=int(self.options.write_retries))
        )
        # Multi-process jobs commit their own shards with
        # write_success=False and a distinct task_id; one process writes
        # the dataset-level marker after all of them committed.
        self.write_success = write_success
        self.schema = schema
        for col in self.partition_by:
            if col not in schema:
                raise ValueError(f"partitionBy column {col!r} not in schema")
            if isinstance(schema[col].data_type, ArrayType):
                raise ValueError(f"partition column {col!r} cannot be an array")
        if self.partition_by and len(self.partition_by) == len(schema):
            raise ValueError("cannot use all columns as partition columns")
        # Partition columns are stripped from the written records — the data
        # schema is the remainder (Spark strips them before the writer;
        # SURVEY.md §3.2 process-boundary note).
        self.data_schema = schema.drop(self.partition_by)
        self._pidx = [schema.field_index(c) for c in self.partition_by]
        self._didx = [
            i for i in range(len(schema)) if i not in set(self._pidx)
        ]

    # -- save-mode gate -----------------------------------------------------

    def _prepare_output(self) -> bool:
        """Apply save-mode semantics. Returns False if the write is a no-op
        (mode=ignore with existing output). Existence means PATH existence —
        an empty directory counts, matching Spark's save-mode checks."""
        out = self.output_path
        fs = self.fs
        exists = fs.exists(out)
        if exists:
            if self.mode in ("error", "errorifexists"):
                raise FileExistsError(
                    f"path {out} already exists (save mode: ErrorIfExists)"
                )
            if self.mode == "ignore":
                return False
            if self.mode == "overwrite":
                if fs.isdir(out):
                    # delete data and markers but PRESERVE the _temporary
                    # subtree: other jobs may have shards in flight there
                    for entry in fs.listdir(out):
                        if entry == p.TEMP_PREFIX:
                            continue
                        fp = os.path.join(out, entry)
                        if fs.isdir(fp):
                            fs.rmtree(fp)
                        else:
                            fs.remove(fp)
                else:
                    fs.remove(out)
        # remember whether THIS job created the output dir so abort() can
        # undo it — a leftover empty dir would flip error/ignore semantics
        # on retry now that existence is path-based
        self._created_output = not exists
        fs.makedirs(out)
        return True

    # -- the write job ------------------------------------------------------

    @property
    def use_pipeline(self) -> bool:
        """True when the slab pipeline handles this write. num_shards alone
        engages it (even at write_workers=1) so shard bytes depend only on
        the data and options, never on the worker count."""
        return self.write_workers > 1 or self.num_shards is not None

    def write_rows(self, rows: Iterable[Sequence[Any]], task_id: int = 0) -> List[str]:
        """Write all rows as one logical job; returns final shard paths."""
        if not self._prepare_output():
            return []
        job = _WriteJob(self, task_id)
        if self.use_pipeline:
            return _write_rows_pipelined(self, job, rows)
        writers: Dict[str, ShardWriter] = {}
        try:
            with timed("write", METRICS) as t:
                for row in rows:
                    rel = self._partition_rel_dir(row)
                    w = writers.get(rel)
                    if w is not None and (
                        self.max_records_per_file
                        and w.records_written >= self.max_records_per_file
                    ):
                        job.retire(writers.pop(rel))
                        w = None
                    if w is None:
                        w = writers[rel] = job.new_shard(rel)
                    w.write(self._strip_partitions(row))
                    t.records += 1
                    if t.records % 4096 == 0:
                        job.heartbeat()
            for w in writers.values():
                job.retire(w)
        except Exception:
            for w in writers.values():
                try:
                    w.close()
                except Exception:  # the original error is re-raised below
                    pass
            job.abort()
            raise
        return job.commit()

    def _partition_rel_dir(self, row: Sequence[Any]) -> str:
        if not self.partition_by:
            return ""
        return p.partition_dir(self.partition_by, [row[i] for i in self._pidx])

    def _strip_partitions(self, row: Sequence[Any]) -> List[Any]:
        if not self.partition_by:
            return list(row)
        return [row[i] for i in self._didx]

    def write_batches(self, batches, task_id: int = 0) -> List[str]:
        """Write ColumnarBatches (the fast columnar path for Example and
        SequenceExample). With partition_by, batches must contain the
        partition columns; consecutive equal-key runs route to their
        ``col=value`` dirs. See module docstring for save-mode semantics."""
        return _write_batches(self, batches, task_id)


#: Name of the per-job liveness marker inside ``_temporary/<job>/``. It
#: records (pid, host) so a later job in the same output dir can tell a
#: CRASHED job's staging dir (same host, dead pid → sweep it) from a LIVE
#: concurrent writer's (leave it alone), plus a ``heartbeat`` timestamp the
#: job refreshes while writing — the lease that lets the sweep also reclaim
#: staging left by writers on OTHER hosts (where pid liveness is
#: unknowable): a heartbeat stale past the lease TTL means the writer
#: stopped stamping long ago.
_JOB_MARKER = "_JOB_META"

#: Seconds between heartbeat re-stamps of _JOB_META (throttle: one tiny
#: marker rewrite per interval, not per slab).
_HEARTBEAT_INTERVAL = 60.0

#: Default lease TTL for cross-host orphan sweeping: a staging dir whose
#: heartbeat is older than this is reclaimable from any host. Generous
#: (an hour) because false positives delete a LIVE job's staging — clock
#: skew across hosts must be far smaller than this for the lease to be
#: sound.
_LEASE_TTL = 3600.0


def job_marker_payload(task_id: int = 0, created: Optional[float] = None) -> bytes:
    """The ``_JOB_META`` liveness-marker JSON (pid/host/created/heartbeat)
    that ``sweep_orphan_jobs`` parses — ONE owner for the schema, shared by
    write jobs (and the JAX package's cache populates)."""
    now = time.time()
    return json.dumps(
        {
            "pid": os.getpid(),
            "host": socket.gethostname(),
            "created": created if created is not None else now,
            "heartbeat": now,
            "task_id": task_id,
        }
    ).encode("utf-8")


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True  # exists, owned by someone else
    except OSError:
        return True  # unknowable: err on the side of 'alive'
    return True


def sweep_orphan_jobs(
    fs,
    output_path: str,
    keep: Optional[str] = None,
    lease_ttl: float = _LEASE_TTL,
) -> List[str]:
    """Best-effort removal of ``_temporary/<job>`` staging dirs left by
    previous CRASHED jobs in ``output_path``. Two independent orphan
    tests, either is sufficient:

    - same host + dead pid (exact but local-only);
    - marker heartbeat stale past ``lease_ttl`` (works across hosts and on
      remote stores, where pid liveness is unknowable — live jobs re-stamp
      their heartbeat every ``_HEARTBEAT_INTERVAL`` seconds, so a lease
      this stale means the writer died or lost the volume long ago).

    Dirs without a readable marker, or stamped by another LIVE host within
    the lease, may belong to live writers — left alone. Returns the removed
    dirs. Never raises (hygiene must not fail a job)."""
    removed: List[str] = []
    root = os.path.join(output_path, p.TEMP_PREFIX)
    try:
        if not fs.isdir(root):
            return removed
        host = socket.gethostname()
        now = time.time()
        for entry in fs.listdir(root):
            if entry == keep:
                continue
            job_dir = os.path.join(root, entry)
            try:
                if not fs.isdir(job_dir):
                    continue
                with fs.open(os.path.join(job_dir, _JOB_MARKER), "rb") as fh:
                    meta = json.loads(fh.read().decode("utf-8"))
                pid = int(meta.get("pid", -1))
                beat = meta.get("heartbeat", meta.get("created"))
                lease_stale = (
                    beat is not None and now - float(beat) > lease_ttl
                )
                is_local = meta.get("host") == host and pid > 0
                if is_local and _pid_alive(pid):
                    # provably-live local writer: NEVER swept, even with a
                    # stale lease (heartbeat re-stamps are best-effort and
                    # can silently fail while the job keeps writing)
                    continue
                local_dead = is_local and not _pid_alive(pid)
                if not (local_dead or lease_stale):
                    continue
                why = "dead pid" if local_dead else "stale lease"
            except Exception:  # no/unreadable marker: cannot judge ownership, leave the dir
                continue  # no/unreadable marker: can't judge, leave it
            try:
                fs.rmtree(job_dir, ignore_errors=True)
                removed.append(job_dir)
                logger.warning(
                    "tfrecord.write swept orphaned staging dir %s "
                    "(crashed job, pid %s, %s)", job_dir, pid, why,
                )
            except Exception:  # best-effort orphan staging sweep
                pass
    except Exception:  # best-effort orphan staging sweep
        pass
    return removed


class _WriteJob:
    """Shared scaffolding for one logical write job: a job-scoped temp dir
    under ``_temporary/<job>/``, shard allocation, and the single end-of-job
    commit (rename into place + ``_SUCCESS``). A failed job leaves NOTHING in
    the final directory and never touches other LIVE jobs' temp dirs (it
    does sweep staging left by crashed jobs — see sweep_orphan_jobs)."""

    def __init__(self, writer: "DatasetWriter", task_id: int):
        self.writer = writer
        self.task_id = task_id
        self.job_id = uuid.uuid4().hex[:12]
        self.fs = writer.fs
        self.temp_root = os.path.join(writer.output_path, p.TEMP_PREFIX, self.job_id)
        # Concurrent jobs share the _temporary parent and a finishing job
        # opportunistically rmdirs it: makedirs can lose the race between
        # creating the parent and the job dir — retry, it converges.
        for _ in range(20):
            try:
                self.fs.makedirs(self.temp_root)
                break
            except FileNotFoundError:
                continue
        else:
            raise OSError(f"could not create job temp dir {self.temp_root}")
        self._created = time.time()
        self._last_beat = self._created
        self._write_marker()
        self.ext = writer.options.file_extension()
        self._seq: Dict[str, int] = {}
        self._final_of: Dict[str, str] = {}
        self._pending: List[str] = []
        # Directories known to exist (created by this job): partitioned
        # writes allocate many shards per partition dir, and on container
        # overlay filesystems each redundant makedirs costs a real syscall.
        self._made_dirs = {self.temp_root}

    def _write_marker(self) -> None:
        try:
            with self.fs.open(os.path.join(self.temp_root, _JOB_MARKER), "wb") as fh:
                fh.write(job_marker_payload(self.task_id, created=self._created))
        except OSError:
            pass  # marker is best-effort: its absence only disables sweeping

    def heartbeat(self) -> None:
        """Re-stamp the _JOB_META heartbeat (throttled to one marker write
        per _HEARTBEAT_INTERVAL): the lease the cross-host orphan sweep
        reads. Cheap enough to call per slab/batch."""
        now = time.time()
        if now - self._last_beat >= _HEARTBEAT_INTERVAL:
            self._last_beat = now
            self._write_marker()

    def _ensure_dir(self, path: str) -> None:
        if path not in self._made_dirs:
            self.fs.makedirs(path)
            self._made_dirs.add(path)

    def alloc_shard_path(self, rel: str = "") -> str:
        """Allocate the next shard file name under ``rel`` (``.c{n}`` counter
        per partition dir) WITHOUT opening it — the slab pipeline plans file
        identities on the planner thread and opens them commit-side."""
        n = self._seq.get(rel, 0)
        self._seq[rel] = n + 1
        fname = p.new_shard_filename(self.task_id, f".c{n:03d}{self.ext}", self.job_id)
        tmp_dir = os.path.join(self.temp_root, rel) if rel else self.temp_root
        self._ensure_dir(tmp_dir)
        tmp_path = os.path.join(tmp_dir, fname)
        final_dir = (
            os.path.join(self.writer.output_path, rel)
            if rel
            else self.writer.output_path
        )
        self._final_of[tmp_path] = os.path.join(final_dir, fname)
        return tmp_path

    def _commit_op(self, fn: Callable, recovered: Optional[Callable[[], bool]] = None):
        """One commit-side filesystem op under the writer's RetryPolicy.
        ``recovered()`` (optional) reports that a failed attempt actually
        took effect (e.g. the rename landed before the error surfaced) so
        the op is not blindly re-run."""
        pol = self.writer.retry_policy
        attempt = 0
        start = pol.clock()
        while True:
            try:
                return fn()
            except OSError:
                if recovered is not None:
                    try:
                        if recovered():
                            return None
                    except OSError:
                        pass
                attempt += 1
                if not pol.pause(attempt, start):
                    raise
                METRICS.count("write.commit_retries")

    def new_shard(self, rel: str = "") -> ShardWriter:
        # the open is a commit-side fs op (remote stores briefly refuse
        # creates): retryable — nothing is written yet
        path = self.alloc_shard_path(rel)
        return self._commit_op(
            lambda: ShardWriter(path, self.writer.data_schema, self.writer.options)
        )

    def retire(self, shard_writer: ShardWriter) -> None:
        """Close a finished shard; it stays in temp until commit()."""
        shard_writer.close()
        self._pending.append(shard_writer.path)
        self.heartbeat()

    def retire_path(self, path: str) -> None:
        """Register an already-closed temp file for the end-of-job commit."""
        self._pending.append(path)

    def commit(self) -> List[str]:
        with timed("write.commit", METRICS) as t, trace("tfr.write.commit"), \
                telemetry.span("write.commit", job=self.job_id) as sp:
            out = self._commit_inner()
            t.records = len(out)
            sp.set(shards=len(out))
        return out

    def _commit_inner(self) -> List[str]:
        # Pre-commit hygiene: staging left by a crashed previous job on this
        # host would pin the shared _temporary parent (the rmdir below would
        # fail forever) — sweep it before renaming into place.
        sweep_orphan_jobs(self.fs, self.writer.output_path, keep=self.job_id)
        written = []
        for tmp_path in self._pending:
            final_path = self._final_of[tmp_path]
            # inline _commit_shard with the job's dir cache: partitioned
            # jobs commit many shards into few directories

            def rename_one(tmp=tmp_path, final=final_path):
                self._ensure_dir(os.path.dirname(final))
                self.fs.rename(tmp, final)

            def rename_landed(tmp=tmp_path, final=final_path):
                # the failed attempt may have won anyway (remote stores can
                # error after the copy); don't re-run a landed rename
                self._made_dirs.discard(os.path.dirname(final))
                return self.fs.exists(final) and not self.fs.exists(tmp)

            self._commit_op(rename_one, recovered=rename_landed)
            written.append(final_path)
        self.fs.rmtree(self.temp_root, ignore_errors=True)
        try:
            # only removable once no other job is using the shared parent
            self.fs.rmdir(os.path.join(self.writer.output_path, p.TEMP_PREFIX))
        except OSError:
            pass
        if self.writer.write_success:
            self._commit_op(
                lambda: p.write_success_marker(self.writer.output_path)
            )
        return written

    def abort(self) -> None:
        self.fs.rmtree(self.temp_root, ignore_errors=True)
        # abort-side hygiene: also clear staging orphaned by CRASHED jobs so
        # a retry of this job starts from a clean _temporary
        sweep_orphan_jobs(self.fs, self.writer.output_path, keep=self.job_id)
        # if this job created the output dir, remove it again when empty so
        # a retry sees the same save-mode world as the first attempt
        if getattr(self.writer, "_created_output", False):
            try:
                self.fs.rmdir(os.path.join(self.writer.output_path, p.TEMP_PREFIX))
            except OSError:
                pass
            try:
                self.fs.rmdir(self.writer.output_path)
            except OSError:
                pass


# ---------------------------------------------------------------------------
# Parallel slab pipeline (write_workers / num_shards)
# ---------------------------------------------------------------------------


def _payload_len(payload) -> int:
    """Byte length of a slab payload (bytes or a uint8 numpy array)."""
    return payload.nbytes if isinstance(payload, np.ndarray) else len(payload)


class _RawShardSink:
    """Commit-side output stream for one shard file of the slab pipeline.

    Receives finished slabs — framed records, already codec-compressed when
    the codec chunks (every supported codec today) — and appends them. With
    a hypothetical stream-only codec, ``codec`` is non-None and compression
    happens here on the committer instead."""

    def __init__(self, path: str, codec: Optional[str]):
        self.path = path
        self._fh = wire.open_compressed(path, "wb", codec)
        self.records_written = 0
        self.bytes_written = 0

    def write_slab(self, payload, n_records: int) -> None:
        self._fh.write(payload)
        self.records_written += n_records
        self.bytes_written += _payload_len(payload)

    def close(self) -> None:
        self._fh.close()


class _Stream:
    """One output stream of the pipeline: a (partition dir, shard index)
    slot. Plan side tracks allocated file paths and the record count of the
    current file (rollover); commit side tracks the open sink."""

    __slots__ = ("rel", "paths", "planned_records", "sink", "sink_path")

    def __init__(self, rel: str):
        self.rel = rel
        self.paths: List[str] = []
        self.planned_records = 0
        self.sink: Optional[_RawShardSink] = None
        self.sink_path: Optional[str] = None


class _SlabPipeline:
    """The parallel encode/compress/commit pipeline for one write job.

    Three roles, two thread groups:

    - PLANNER (caller thread): slices incoming work into slabs, assigns each
      slab a (partition dir, round-robin shard, file) target — including
      exact ``max_records_per_file`` rollover slicing, since the planner is
      the only place with deterministic running record counts — and submits
      encode+compress tasks to the pool. Submission blocks once ``depth``
      slabs are in flight (backpressure: memory stays ~depth slabs).
    - WORKERS (ThreadPoolExecutor): encode the slab to a framed TFRecord
      byte stream (native encoder releases the GIL; Python serde fallback
      otherwise) and compress it per-slab via wire.compress_chunk.
    - COMMITTER (caller thread, interleaved with planning): drains futures
      in FIFO submission order and appends payloads to their shard sinks.
      FIFO order + plan-time targets = byte-deterministic output for any
      worker count.
    """

    def __init__(self, writer: "DatasetWriter", job: "_WriteJob"):
        self.writer = writer
        self.job = job
        self.codec = writer.options.codec
        chunked = wire.codec_supports_chunks(self.codec)
        self._compress_in_worker = self.codec is not None and chunked
        self._sink_codec = None if chunked else self.codec
        self.num_shards = writer.num_shards or 1
        self.max_records = writer.max_records_per_file
        self.depth = max(4, 2 * writer.write_workers)
        self._pool = ThreadPoolExecutor(
            max_workers=writer.write_workers, thread_name_prefix="tfr-write"
        )
        self._inflight: Deque[Tuple[Future, _Stream, str]] = collections.deque()
        self._streams: Dict[Tuple[str, int], _Stream] = {}
        self._rr: Dict[str, int] = {}

    # -- planner side -------------------------------------------------------

    def submit(self, rel: str, start: int, stop: int, encode: Callable) -> None:
        """Plan rows [start, stop) of one slab source (``encode(s, e)`` must
        return the framed bytes for that half-open row range) onto ``rel``'s
        round-robin streams, splitting at _PIPE_SLAB and file-rollover
        points. The round-robin advances PER SLAB so even a single large
        batch spreads over all num_shards streams."""
        pos = start
        while pos < stop:
            shard = self._rr.get(rel, 0)
            self._rr[rel] = (shard + 1) % self.num_shards
            stream = self._streams.get((rel, shard))
            if stream is None:
                stream = self._streams[(rel, shard)] = _Stream(rel)
            if not stream.paths or (
                self.max_records and stream.planned_records >= self.max_records
            ):
                stream.paths.append(self.job.alloc_shard_path(rel))
                stream.planned_records = 0
            room = (
                self.max_records - stream.planned_records
                if self.max_records
                else stop - pos
            )
            take = min(room, stop - pos, _PIPE_SLAB)
            path = stream.paths[-1]
            METRICS.gauge("write.inflight_slabs", len(self._inflight))
            if len(self._inflight) >= self.depth:
                METRICS.count("write.backpressure_waits")
            while len(self._inflight) >= self.depth:
                self._commit_one()
            fut = self._pool.submit(self._run_task, encode, pos, pos + take)
            self._inflight.append((fut, stream, path))
            stream.planned_records += take
            pos += take

    # -- worker side --------------------------------------------------------

    def _run_task(self, encode: Callable, start: int, stop: int):
        with trace("tfr.write.encode"), timed("write.encode", METRICS) as t, \
                telemetry.span("write.encode", rows=stop - start):
            framed = encode(start, stop)
            t.records = stop - start
            t.bytes = _payload_len(framed)
        if not self._compress_in_worker:
            return framed, stop - start
        with trace("tfr.write.compress"), timed("write.compress", METRICS) as t, \
                telemetry.span("write.compress", rows=stop - start):
            payload = wire.compress_chunk(self.codec, framed)
            t.records = stop - start
            t.bytes = len(payload)
        return payload, stop - start

    # -- committer side -----------------------------------------------------

    def _commit_one(self) -> None:
        fut, stream, path = self._inflight.popleft()
        payload, n_records = fut.result()  # re-raises worker errors
        self.job.heartbeat()  # lease stays fresh for long pipeline jobs
        with trace("tfr.write.io"), timed("write.io", METRICS) as t, \
                telemetry.span("write.io", rows=n_records):
            if stream.sink_path != path:
                # all slabs of a file precede slabs of the stream's next
                # file (FIFO commit of an in-order plan), so a path switch
                # means the previous file is complete
                if stream.sink is not None:
                    stream.sink.close()
                    self.job.retire_path(stream.sink_path)
                stream.sink = self.job._commit_op(
                    lambda: _RawShardSink(path, self._sink_codec)
                )
                stream.sink_path = path
            stream.sink.write_slab(payload, n_records)
            t.records = n_records
            t.bytes = _payload_len(payload)

    def finish(self) -> None:
        """Drain every in-flight slab in plan order and close all sinks."""
        while self._inflight:
            self._commit_one()
        self._pool.shutdown(wait=True)
        for stream in self._streams.values():
            if stream.sink is not None:
                stream.sink.close()
                self.job.retire_path(stream.sink_path)
                stream.sink = None

    def abort(self) -> None:
        """Best-effort teardown on error: cancel queued work, stop workers,
        close sinks. Every file lives under the job temp dir, so the
        caller's job.abort() removes all bytes written so far."""
        for fut, _, _ in self._inflight:
            fut.cancel()
        self._inflight.clear()
        self._pool.shutdown(wait=True, cancel_futures=True)
        for stream in self._streams.values():
            if stream.sink is not None:
                try:
                    stream.sink.close()
                except Exception:  # abort hygiene: partial slabs already being discarded
                    pass
                stream.sink = None


def _write_rows_pipelined(
    writer: "DatasetWriter", job: "_WriteJob", rows: Iterable[Sequence[Any]]
) -> List[str]:
    """Row-oriented slab pipeline: buffer ``_ROW_SLAB`` stripped rows per
    partition dir on the planner thread, serialize+frame+compress each slab
    on the workers. Buffer flush points depend only on row arrival order, so
    output is deterministic for any worker count."""
    record_type = writer.options.record_type
    buffers: Dict[str, List[Sequence[Any]]] = {}
    pipe = None
    try:
        # inside the try: a constructor error (unsupported schema, pool
        # limits) must still abort the job or it leaks temp/output dirs
        serializer = TFRecordSerializer(writer.data_schema)
        pipe = _SlabPipeline(writer, job)

        def row_task(buf: List[Sequence[Any]]) -> Callable:
            def encode(start: int, stop: int) -> bytes:
                return b"".join(
                    wire.encode_record(encode_row(serializer, record_type, row))
                    for row in buf[start:stop]
                )

            return encode

        with timed("write", METRICS) as t:
            for row in rows:
                rel = writer._partition_rel_dir(row)
                buf = buffers.setdefault(rel, [])
                buf.append(writer._strip_partitions(row))
                t.records += 1
                if len(buf) >= _ROW_SLAB:
                    pipe.submit(rel, 0, len(buf), row_task(buf))
                    buffers[rel] = []
            for rel, buf in buffers.items():
                if buf:
                    pipe.submit(rel, 0, len(buf), row_task(buf))
            pipe.finish()
    except Exception:
        if pipe is not None:
            pipe.abort()
        job.abort()
        raise
    return job.commit()


def _write_batches_pipelined(
    writer: "DatasetWriter", job: "_WriteJob", batches, encoder
) -> List[str]:
    """Columnar slab pipeline: the planner computes the vectorized partition
    plan per batch and submits one slab per (run, rollover slice); workers
    slice the batch and run the native encoder (GIL released; Python row
    fallback when the schema has no native encoder) plus per-slab codec
    compression."""
    data_names = set(writer.data_schema.names)
    record_type = writer.options.record_type
    pipe = None
    try:
        # inside the try: a constructor error (unsupported schema, pool
        # limits) must still abort the job or it leaks temp/output dirs
        serializer = (
            TFRecordSerializer(writer.data_schema) if encoder is None else None
        )
        pipe = _SlabPipeline(writer, job)

        def batch_task(data_batch) -> Callable:
            def encode(start: int, stop: int):
                piece = (
                    data_batch
                    if start == 0 and stop == data_batch.num_rows
                    else slice_batch(data_batch, start, stop)
                )
                if encoder is not None:
                    return encoder.encode_batch(piece)
                return b"".join(
                    wire.encode_record(encode_row(serializer, record_type, row))
                    for row in batch_to_rows(piece, writer.data_schema)
                )

            return encode

        with timed("write", METRICS) as t:
            for batch in batches:
                if not writer.partition_by:
                    pipe.submit("", 0, batch.num_rows, batch_task(batch))
                    t.records += batch.num_rows
                    continue
                data_batch = ColumnarBatch(
                    {k: v for k, v in batch.columns.items() if k in data_names},
                    batch.num_rows,
                )
                order, runs = _partition_plan(batch, writer)
                if order is not None:
                    data_batch = take_rows(data_batch, order)
                task = batch_task(data_batch)
                for rel, start, stop in runs:
                    pipe.submit(rel, start, stop, task)
                t.records += batch.num_rows
            pipe.finish()
    except Exception:
        if pipe is not None:
            pipe.abort()
        job.abort()
        raise
    return job.commit()


def _partition_codes(batch, writer: "DatasetWriter") -> np.ndarray:
    """Factorize the partition-key tuple of every row into one int64 code
    per row (equal codes <=> equal key tuples, nulls distinct from every
    value). One vectorized np.unique pass per partition column — replaces
    the per-row Python comparisons that made interleaved-key routing
    row-at-a-time (VERDICT r4 item 6)."""
    n = batch.num_rows
    combined: Optional[np.ndarray] = None
    for name in writer.partition_by:
        col = batch[name]
        if col.blob is not None:
            vals = np.empty(n, dtype=object)
            vals[:] = col.blobs
        else:
            vals = col.values
        if col.mask is not None and not col.mask.all():
            valid = np.asarray(col.mask, dtype=bool)
            codes = np.empty(n, dtype=np.int64)
            uniq, inv = np.unique(vals[valid], return_inverse=True)
            codes[valid] = inv
            codes[~valid] = len(uniq)  # null: its own code
            k = len(uniq) + 1
        else:
            _, inv = np.unique(vals, return_inverse=True)
            codes = inv.astype(np.int64)
            k = max(1, int(codes.max()) + 1) if n else 1
        if combined is None:
            # first column: the per-column codes ARE the combination —
            # skipping the redundant re-factorization halves the unique()
            # work for the common single-column partitionBy
            combined = codes
            continue
        # re-factorize the running combination so codes stay compact (no
        # int64 overflow however many partition columns there are)
        _, combined = np.unique(combined * k + codes, return_inverse=True)
        combined = combined.astype(np.int64)
    assert combined is not None  # partition_by is non-empty at call sites
    return combined


def _partition_value_at(batch, writer: "DatasetWriter", row: int) -> list:
    """The partition-key values of one row, rendered like the row path
    (raw bytes for blob columns — p.format_partition_value applies the same
    lossy utf-8 handling; None for masked-out rows)."""
    values = []
    for name in writer.partition_by:
        col = batch[name]
        if col.mask is not None and not col.mask[row]:
            values.append(None)
        elif col.blob is not None:
            bo = col.blob_offsets
            values.append(bytes(col.blob[int(bo[row]) : int(bo[row + 1])]))
        else:
            values.append(col.values[row].item())
    return values


def _partition_plan(batch, writer: "DatasetWriter"):
    """Vectorized routing plan: (row_order, [(rel_dir, start, stop), ...]).

    Pre-clustered input (the common case for re-partition jobs) keeps its
    order (row_order None) and yields its few large contiguous runs.
    Interleaved keys would degenerate to per-row runs — and per-run encode
    calls — so when runs substantially exceed distinct keys the plan
    GROUPS instead: a stable argsort of the key codes clusters each key's
    rows (preserving their relative order), one gather reorders the batch,
    and each partition again emits as one large run. Either way the encoder
    sees big contiguous pieces, keeping interleaved-key partitionBy within
    a small factor of the unpartitioned columnar path."""
    n = batch.num_rows
    if n == 0:
        return None, []
    combined = _partition_codes(batch, writer)
    change = np.nonzero(combined[1:] != combined[:-1])[0] + 1
    starts = np.concatenate(([0], change))
    stops = np.concatenate((change, [n]))
    order = None
    # _partition_codes returns dense codes (its last step is a
    # return_inverse factorization), so the group count is just max+1
    n_groups = int(combined.max()) + 1
    if len(starts) > 2 * n_groups:
        order = np.argsort(combined, kind="stable")
        combined = combined[order]
        change = np.nonzero(combined[1:] != combined[:-1])[0] + 1
        starts = np.concatenate(([0], change))
        stops = np.concatenate((change, [n]))
    runs = []
    for s, e in zip(starts.tolist(), stops.tolist()):
        src_row = int(order[s]) if order is not None else s
        values = _partition_value_at(batch, writer, src_row)
        runs.append((p.partition_dir(writer.partition_by, values), s, e))
    return order, runs


def _write_batches(
    writer: "DatasetWriter", batches, task_id: int = 0
) -> List[str]:
    """Columnar write job: one native encode call per run (the fast write
    path for Example AND SequenceExample; falls back to per-row encoding
    when the schema has no native encoder). With partition_by, partition
    columns are stripped and consecutive equal-key runs route to their
    ``col=value`` directories."""
    # Config errors must raise BEFORE any filesystem mutation (overwrite
    # deletion, temp dirs): build the encoder and peek the first batch for
    # missing partition columns up front.
    encoder = _native.make_encoder(writer.data_schema, writer.options.record_type)
    batches = iter(batches)
    first = next(batches, None)
    if first is not None and writer.partition_by:
        missing = [c for c in writer.partition_by if c not in first.columns]
        if missing:
            raise ValueError(
                f"write_batches: partition columns {missing} not present in "
                f"the batch (have {sorted(first.columns)})"
            )
    batches = itertools.chain([first], batches) if first is not None else iter(())
    if not writer._prepare_output():
        return []
    job = _WriteJob(writer, task_id)
    if writer.use_pipeline:
        return _write_batches_pipelined(writer, job, batches, encoder)
    max_per_file = writer.max_records_per_file
    writers: Dict[str, ShardWriter] = {}
    data_names = set(writer.data_schema.names)

    def emit(rel: str, part, t) -> None:
        pos = 0
        while pos < part.num_rows:
            w = writers.get(rel)
            if w is not None and max_per_file and w.records_written >= max_per_file:
                job.retire(writers.pop(rel))
                w = None
            if w is None:
                w = writers[rel] = job.new_shard(rel)
            room = (
                max_per_file - w.records_written
                if max_per_file
                else part.num_rows - pos
            )
            take = min(room, part.num_rows - pos)
            piece = (
                part
                if (pos == 0 and take == part.num_rows)
                else slice_batch(part, pos, pos + take)
            )
            if encoder is not None:
                with timed("write.encode", METRICS) as te:
                    framed = encoder.encode_batch(piece)
                    te.records = piece.num_rows
                    te.bytes = framed.nbytes
                with timed("write.io", METRICS) as ti:
                    # zero-copy view; file objects accept any buffer
                    # (stream codecs compress inside this write, so the
                    # sequential path's io stage includes compression)
                    w.write_framed(framed.data, piece.num_rows)
                    ti.records = piece.num_rows
                    ti.bytes = framed.nbytes
            else:
                for row in batch_to_rows(piece, writer.data_schema):
                    w.write(row)
            t.records += piece.num_rows
            pos += take
        job.heartbeat()

    try:
        with timed("write", METRICS) as t:
            for batch in batches:
                if not writer.partition_by:
                    emit("", batch, t)
                    continue
                # strip partition columns; route runs to their directories
                data_batch = ColumnarBatch(
                    {k: v for k, v in batch.columns.items() if k in data_names},
                    batch.num_rows,
                )
                order, runs = _partition_plan(batch, writer)
                if order is not None:
                    data_batch = take_rows(data_batch, order)
                for rel, start, stop in runs:
                    emit(rel, slice_batch(data_batch, start, stop), t)
        for w in writers.values():
            job.retire(w)
    except Exception:
        for w in writers.values():
            try:
                w.close()
            except Exception:  # the original error is re-raised below
                pass
        job.abort()
        raise
    return job.commit()


def write_dataset(
    rows: Iterable[Sequence[Any]],
    schema: StructType,
    path: str,
    mode: str = "error",
    partition_by: Optional[List[str]] = None,
    options: Optional[TFRecordOptions] = None,
    **option_kwargs: Any,
) -> List[str]:
    """One-call write API: ``write_dataset(rows, schema, path,
    mode='overwrite', partition_by=['date'], recordType='Example',
    codec='gzip')``."""
    opts = options or TFRecordOptions.from_map(option_kwargs)
    writer = DatasetWriter(path, schema, opts, partition_by=partition_by, mode=mode)
    return writer.write_rows(rows)
