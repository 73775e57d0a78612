"""The port's writer against the JAX writer: the same record bytes in the
same files (only the random job id in the names differs) on the
sequential path and through the slab pipeline at write_workers 1-4, file
rollover, partitionBy routing, abort and cleanup on an error in a slab,
no thread left behind, ``sweep_orphan_jobs``, ``write_retries`` against a
failing filesystem operation, the native encoder and ``batch_to_rows``."""

import json
import os
import re
import socket
import threading
import time

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from tpu_tfrecord import proto as jproto, schema as js  # noqa: E402
from tpu_tfrecord import _native as jnative  # noqa: E402
from tpu_tfrecord.columnar import ColumnarDecoder as JDecoder, batch_to_rows as j_batch_to_rows  # noqa: E402
from tpu_tfrecord.io.writer import DatasetWriter as JWriter, sweep_orphan_jobs as j_sweep  # noqa: E402
from tpu_tfrecord.options import RecordType as JRT, TFRecordOptions as JOptions  # noqa: E402
from tpu_tfrecord.serde import TFRecordSerializer as JSer, encode_row as j_encode_row  # noqa: E402

from tpu_tfrecord_torch import _native as tnative, fs as tfs, schema as ts  # noqa: E402
from tpu_tfrecord_torch.columnar import ColumnarDecoder as TDecoder, batch_to_rows  # noqa: E402
from tpu_tfrecord_torch.io import writer as twriter  # noqa: E402
from tpu_tfrecord_torch.io.writer import DatasetWriter as TWriter, sweep_orphan_jobs  # noqa: E402
from tpu_tfrecord_torch.metrics import METRICS  # noqa: E402
from tpu_tfrecord_torch.options import (  # noqa: E402
    RecordType as TRT,
    TFRecordOptions as TOptions,
)
from tpu_tfrecord_torch.retry import RetryPolicy  # noqa: E402
from tpu_tfrecord_torch.serde import NullValueError  # noqa: E402

HAS_ZSTD = __import__("tpu_tfrecord_torch.wire", fromlist=["_zstandard"])._zstandard() is not None
CODECS = [None, "deflate", "gzip", "snappy", "lz4", "bzip2",
          pytest.param("zstd", marks=pytest.mark.skipif(not HAS_ZSTD, reason="no zstandard"))]


def schemas(mod):
    return mod.StructType([
        mod.StructField("id", mod.LongType()),
        mod.StructField("x", mod.FloatType()),
        mod.StructField("s", mod.StringType()),
        mod.StructField("v", mod.ArrayType(mod.LongType())),
        mod.StructField("key", mod.LongType()),
    ])


JS, TS = schemas(js), schemas(ts)


def make_rows(n, seed=0, keys=3):
    rng = np.random.default_rng(seed)
    return [[i, float(np.float32(rng.standard_normal())), f"s{int(rng.integers(0, 50))}",
             [int(k) for k in rng.integers(0, 99, size=i % 4)], int(rng.integers(0, keys))]
            for i in range(n)]


def batch_pair(rows, batch_size=4096):
    """The same rows as ColumnarBatches of each package."""
    ser = JSer(JS)
    recs = [j_encode_row(ser, JRT.EXAMPLE, r) for r in rows]
    jd, td = JDecoder(JS), TDecoder(TS)
    chunks = [recs[i:i + batch_size] for i in range(0, len(recs), batch_size)]
    return [jd.decode_batch(c) for c in chunks], [td.decode_batch(c) for c in chunks]


def shard_bytes(out):
    """{(partition dir, cNNN): bytes} of every data file, keyed without the
    random job id."""
    got = {}
    for root, dirs, files in os.walk(out):
        dirs[:] = [d for d in dirs if d != "_temporary"]
        for f in files:
            m = re.match(r"part-(\d+)-[0-9a-f]{12}\.(c\d+)\.", f)
            if m:
                with open(os.path.join(root, f), "rb") as fh:
                    got[(os.path.relpath(root, out), m.group(1), m.group(2))] = fh.read()
    return got


def write_threads():
    return [t for t in threading.enumerate() if t.name.startswith("tfr-write")]


def both(tmp_path, name, kw, rows=None, batches=None, partition_by=None):
    """Write with both packages; returns (jax bytes, port bytes)."""
    out = {}
    for tag, W, O, schema in (("j", JWriter, JOptions, JS), ("t", TWriter, TOptions, TS)):
        path = str(tmp_path / f"{name}_{tag}")
        w = W(path, schema, O.from_map(**kw), partition_by=partition_by, mode="overwrite")
        if rows is not None:
            w.write_rows(rows)
        else:
            w.write_batches(batches[0] if tag == "j" else batches[1])
        out[tag] = shard_bytes(path)
    assert not write_threads()
    return out["j"], out["t"]


# ---------------------------------------------------------------------------
# bytes equal to the JAX writer's
# ---------------------------------------------------------------------------

ROWS = make_rows(20_000)
BATCHES = batch_pair(ROWS)


@pytest.mark.parametrize("workers", [1, 2, 3, 4])
@pytest.mark.parametrize("codec", CODECS)
def test_pipelined_batches_bytes_equal_jax(tmp_path, codec, workers):
    j, t = both(tmp_path, "p", dict(codec=codec, write_workers=workers, num_shards=3),
                batches=BATCHES)
    assert len(t) == 3 and t == j


@pytest.mark.parametrize("workers", [1, 2, 3, 4])
def test_pipelined_bytes_independent_of_workers(tmp_path, workers):
    kw = dict(codec="deflate", num_shards=2)
    _, one = both(tmp_path, "w1", dict(kw, write_workers=1), batches=BATCHES)
    _, many = both(tmp_path, "wn", dict(kw, write_workers=workers), batches=BATCHES)
    assert one == many


@pytest.mark.parametrize("workers", [1, 2, 3, 4])
def test_pipelined_partitioned_batches_bytes_equal_jax(tmp_path, workers):
    j, t = both(tmp_path, "pp", dict(codec="gzip", write_workers=workers, num_shards=2),
                batches=BATCHES, partition_by=["key"])
    assert sorted({k[0] for k in t}) == ["key=0", "key=1", "key=2"]
    assert t == j


@pytest.mark.parametrize("workers", [1, 2, 3, 4])
def test_pipelined_rows_bytes_equal_jax(tmp_path, workers):
    j, t = both(tmp_path, "pr", dict(codec="snappy", write_workers=workers, num_shards=2),
                rows=ROWS[:9000], partition_by=["key"])
    assert t == j and len(t) >= 3


@pytest.mark.parametrize("api", ["rows", "batches"])
@pytest.mark.parametrize("codec", [None, "deflate", "lz4"])
def test_sequential_path_bytes_equal_jax(tmp_path, api, codec):
    kw = dict(codec=codec)
    if api == "rows":
        j, t = both(tmp_path, "s", kw, rows=ROWS[:3000], partition_by=["key"])
    else:
        j, t = both(tmp_path, "s", kw, batches=BATCHES)
    assert t == j and t


@pytest.mark.parametrize("pipelined", [False, True])
@pytest.mark.parametrize("api", ["rows", "batches"])
def test_max_records_per_shard_rotation(tmp_path, pipelined, api):
    kw = dict(max_records_per_shard=3000)
    if pipelined:
        kw.update(write_workers=2, num_shards=2)
    if api == "rows":
        j, t = both(tmp_path, "m", kw, rows=ROWS[:10_000])
    else:
        j, t = both(tmp_path, "m", kw, batches=BATCHES)
    assert t == j
    n = 10_000 if api == "rows" else 20_000
    counts = [sum(1 for _ in _records(b)) for b in t.values()]
    assert sum(counts) == n and max(counts) == 3000


def _records(buf):
    from tpu_tfrecord_torch import wire

    for off, length in wire.scan_buffer(buf):
        yield buf[off:off + length]


def test_max_records_per_file_argument_wins(tmp_path):
    out = str(tmp_path / "mf")
    w = TWriter(out, TS, TOptions.from_map(max_records_per_shard=5000), mode="overwrite",
                max_records_per_file=7000)
    assert w.max_records_per_file == 7000
    w.write_rows(ROWS[:10_000])
    assert len(shard_bytes(out)) == 2


# ---------------------------------------------------------------------------
# abort, cleanup and threads
# ---------------------------------------------------------------------------


def null_batch():
    nullable = ts.StructType([ts.StructField("x", ts.LongType())])
    ser = JSer(js.StructType([js.StructField("x", js.LongType())]))
    return TDecoder(nullable).decode_batch(
        [j_encode_row(ser, JRT.EXAMPLE, [1]), jproto.encode_example(jproto.Example())]
    )


@pytest.mark.parametrize("workers", [1, 4])
def test_error_in_a_slab_aborts_the_job(tmp_path, workers):
    """A NullValueError raised on a worker thread: nothing outside
    _temporary, no _SUCCESS, the job-created output dir removed, and no
    pipeline thread alive."""
    ns = ts.StructType([ts.StructField("x", ts.LongType(), nullable=False)])
    out = str(tmp_path / "abort")
    w = TWriter(out, ns, TOptions.from_map(write_workers=workers, num_shards=2), mode="overwrite")
    with pytest.raises(NullValueError):
        w.write_batches([null_batch()] * 3)
    assert not os.path.exists(out)
    assert not write_threads()


def test_batch_source_error_leaves_no_output(tmp_path):
    def gen():
        yield from BATCHES[1][:2]
        raise RuntimeError("source failed")

    out = str(tmp_path / "src")
    w = TWriter(out, TS, TOptions.from_map(write_workers=4, num_shards=2), mode="overwrite")
    with pytest.raises(RuntimeError, match="source failed"):
        w.write_batches(gen())
    assert not os.path.exists(out)
    assert not write_threads()


def test_abort_preserves_existing_output(tmp_path):
    out = str(tmp_path / "keep")
    TWriter(out, TS, TOptions(), mode="overwrite").write_batches(BATCHES[1][:1])
    before = shard_bytes(out)

    def gen():
        yield BATCHES[1][0]
        raise RuntimeError("boom")

    w = TWriter(out, TS, TOptions.from_map(write_workers=2), mode="append")
    with pytest.raises(RuntimeError):
        w.write_batches(gen())
    assert shard_bytes(out) == before
    assert not os.listdir(os.path.join(out, "_temporary")) if os.path.exists(
        os.path.join(out, "_temporary")) else True
    assert not write_threads()


def test_constructor_error_still_aborts_job(tmp_path):
    bad = ts.StructType([ts.StructField("x", ts.ArrayType(ts.NullType()))])
    out = str(tmp_path / "ctor")
    for _ in range(2):  # the retry sees the same save-mode world
        w = TWriter(out, bad, TOptions.from_map(write_workers=2), mode="error")
        with pytest.raises(Exception) as ei:
            w.write_rows([[None]])
        assert not isinstance(ei.value, FileExistsError)
        assert not os.path.exists(out)


def test_dropped_pipeline_threads_are_joined(tmp_path):
    before = threading.active_count()
    for workers in (2, 4):
        TWriter(str(tmp_path / f"t{workers}"), TS,
                TOptions.from_map(write_workers=workers, num_shards=2),
                mode="overwrite").write_batches(BATCHES[1])
    assert not write_threads()
    assert threading.active_count() == before


# ---------------------------------------------------------------------------
# orphan sweep and commit retries
# ---------------------------------------------------------------------------


def _dead_pid():
    pid = 4_000_000
    while True:
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            return pid
        except PermissionError:
            pass
        pid -= 1


def _staging(root, name, meta):
    job = os.path.join(root, "_temporary", name)
    os.makedirs(job)
    if meta is not None:
        with open(os.path.join(job, "_JOB_META"), "w") as fh:
            json.dump(meta, fh)
    open(os.path.join(job, "part-00000-x.c000.tfrecord"), "wb").close()


def _orphans(root):
    host, now = socket.gethostname(), time.time()
    _staging(root, "dead", {"pid": _dead_pid(), "host": host, "heartbeat": now})
    _staging(root, "live", {"pid": os.getpid(), "host": host, "heartbeat": now - 1e6})
    _staging(root, "stale", {"pid": 1, "host": "elsewhere", "heartbeat": now - 7200})
    _staging(root, "fresh", {"pid": 1, "host": "elsewhere", "heartbeat": now})
    _staging(root, "unmarked", None)
    _staging(root, "mine", {"pid": _dead_pid(), "host": host, "heartbeat": now})


def test_sweep_orphan_jobs_like_jax(tmp_path):
    got = {}
    for tag, sweep, fsys in (("t", sweep_orphan_jobs, tfs.LocalFS()),
                             ("j", j_sweep, __import__("tpu_tfrecord.fs", fromlist=["LocalFS"]).LocalFS())):
        root = str(tmp_path / tag)
        _orphans(root)
        removed = sweep(fsys, root, keep="mine")
        got[tag] = (sorted(os.path.basename(r) for r in removed),
                    sorted(os.listdir(os.path.join(root, "_temporary"))))
    assert got["t"] == got["j"] == (["dead", "stale"], ["fresh", "live", "mine", "unmarked"])


def test_commit_sweeps_crashed_jobs(tmp_path):
    out = str(tmp_path / "sweep")
    _staging(out, "crashed", {"pid": _dead_pid(), "host": socket.gethostname(),
                              "heartbeat": time.time()})
    TWriter(out, TS, TOptions(), mode="append").write_rows(ROWS[:10])
    assert not os.path.exists(os.path.join(out, "_temporary"))


class FlakyRenameFS(tfs.LocalFS):
    """A local filesystem whose first ``failures`` renames raise."""

    def __init__(self, failures):
        self.failures = failures
        self.calls = 0

    def rename(self, src, dst):
        self.calls += 1
        if self.calls <= self.failures:
            raise OSError("transient rename failure")
        super().rename(src, dst)


@pytest.mark.parametrize("failures,retries,ok", [(0, 0, True), (2, 2, True), (2, 1, False)])
def test_write_retries_against_failing_rename(tmp_path, failures, retries, ok):
    out = str(tmp_path / "retry")
    sleeps = []
    w = TWriter(out, TS, TOptions.from_map(write_retries=retries), mode="overwrite",
                retry_policy=RetryPolicy(max_retries=retries, sleep=sleeps.append))
    w.fs = FlakyRenameFS(failures)
    METRICS.reset()
    if ok:
        (path,) = w.write_rows(ROWS[:100])
        assert os.path.exists(path) and os.path.exists(os.path.join(out, "_SUCCESS"))
        assert METRICS.counter("write.commit_retries") == failures == len(sleeps)
    else:
        with pytest.raises(OSError, match="transient"):
            w.write_rows(ROWS[:100])
        assert not os.path.exists(os.path.join(out, "_SUCCESS"))


def test_write_retries_option_sets_policy():
    w = TWriter("/nonexistent/unused", TS, TOptions.from_map(writeRetries=3))
    assert w.retry_policy.max_retries == 3


# ---------------------------------------------------------------------------
# options, encoder, rows
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    {"write_workers": 0}, {"num_shards": 0}, {"max_records_per_shard": 0},
    {"infer_sample_limit": 0}, {"on_corrupt": "ignore"}, {"max_corrupt_records": -1},
    {"corrupt_fallback": "skip_record"}, {"write_retries": -1}, {"writeWorkerz": 2},
    {"codec": "lzo"},
])
def test_invalid_options_raise_like_jax(kw):
    with pytest.raises(ValueError):
        JOptions.from_map(**kw)
    with pytest.raises(ValueError):
        TOptions.from_map(**kw)


@pytest.mark.parametrize("mapping", [
    {"writeWorkers": "4", "numShards": "2", "maxRecordsPerShard": "10"},
    {"verifyCrc": "false", "inferSampleLimit": "5", "onCorrupt": "skip_record",
     "maxCorruptRecords": None, "corruptFallback": "skip_shard", "writeRetries": 2},
    {"recordType": "SequenceExample", "codec": "org.apache.hadoop.io.compress.SnappyCodec"},
])
def test_option_spellings_like_jax(mapping):
    j, t = JOptions.from_map(mapping), TOptions.from_map(mapping)
    for name in ("verify_crc", "infer_sample_limit", "write_workers", "num_shards",
                 "max_records_per_shard", "on_corrupt", "max_corrupt_records",
                 "corrupt_fallback", "write_retries", "codec"):
        assert getattr(t, name) == getattr(j, name), name
    assert t.record_type.value == j.record_type.value


# the JAX options the port lacked before its stall, pulse, autotune, cache,
# trace, telemetry-export, fleet-spool, data-service and elastic-fleet
# options were ported, in both spellings
OPTIONS_ONCE_NOT_PORTED = (
    ("read_deadline_ms", "readDeadlineMs"),
    ("open_deadline_ms", "openDeadlineMs"),
    ("hedge_after_ms", "hedgeAfterMs"),
    ("on_stall", "onStall"),
    ("watchdog_timeout_ms", "watchdogTimeoutMs"),
    ("cache", "cache"),
    ("cache_dir", "cacheDir"),
    ("cache_max_bytes", "cacheMaxBytes"),
    ("trace", "trace"),
    ("pulse_interval_s", "pulseIntervalS"),
    ("telemetry_port", "telemetryPort"),
    ("telemetry_spool_dir", "telemetrySpoolDir"),
    ("spool_interval_s", "spoolIntervalS"),
    ("telemetry_role", "telemetryRole"),
    ("autotune", "autotune"),
    ("autotune_interval_s", "autotuneIntervalS"),
    ("service", "service"),
    ("service_lease_ttl_s", "serviceLeaseTtlS"),
    ("service_deadline_ms", "serviceDeadlineMs"),
    ("service_fallback_ms", "serviceFallbackMs"),
    ("elastic_min_workers", "elasticMinWorkers"),
    ("elastic_max_workers", "elasticMaxWorkers"),
    ("elastic_interval_s", "elasticIntervalS"),
)
# a valid value of each ported one, spelled as a string where the JAX
# parser takes one
PORTED_VALUES = {
    "read_deadline_ms": "250", "open_deadline_ms": "100", "hedge_after_ms": 50,
    "on_stall": " Skip_Shard", "watchdog_timeout_ms": "500", "pulse_interval_s": "0.5",
    "autotune": "ON", "autotune_interval_s": 0.25, "cache": " Auto", "cache_dir": "/tmp/c",
    "cache_max_bytes": "1024", "trace": "ON", "telemetry_port": "9100",
    "telemetry_spool_dir": "/tmp/spool", "spool_interval_s": "2", "telemetry_role": "reader",
    "service": "h:1", "service_lease_ttl_s": "3", "service_deadline_ms": 100,
    "service_fallback_ms": "250", "elastic_min_workers": "2", "elastic_max_workers": 6,
    "elastic_interval_s": "0.5",
}


@pytest.mark.parametrize("key", [k for pair in OPTIONS_ONCE_NOT_PORTED
                                 for k in dict.fromkeys(pair)])
def test_options_not_ported_raise_and_name_themselves(key):
    """Every option once missing is ported now: it parses in either
    spelling to the JAX package's value."""
    snake = next(s for s, c in OPTIONS_ONCE_NOT_PORTED if key in (s, c))
    assert snake in PORTED_VALUES
    value = PORTED_VALUES[snake]
    t, j = TOptions.from_map({key: value}), JOptions.from_map({key: value})
    assert getattr(t, snake) == getattr(j, snake) != getattr(TOptions(), snake)


def test_write_metrics_wired(tmp_path):
    METRICS.reset()
    opts = TOptions.from_map(write_workers=2, codec="deflate")
    TWriter(str(tmp_path / "m"), TS, opts, mode="overwrite").write_batches(BATCHES[1])
    snap = METRICS.snapshot("write")
    assert snap["write"]["records"] == 20_000
    assert snap["write.encode"]["records"] == 20_000
    assert snap["write.compress"]["records"] == 20_000
    assert snap["write.io"]["bytes"] > 0 and snap["write.commit"]["records"] == 1


SEQ_ROWS = [[i, [[float(i), 1.5], []], [f"a{i}", "b"]] for i in range(30)]


def seq_schemas(mod):
    return mod.StructType([
        mod.StructField("id", mod.LongType()),
        mod.StructField("frames", mod.ArrayType(mod.ArrayType(mod.FloatType()))),
        mod.StructField("tags", mod.ArrayType(mod.StringType())),
    ])


@pytest.mark.parametrize("record_type", ["Example", "SequenceExample"])
def test_native_encoder_bytes_equal_jax(record_type):
    if record_type == "Example":
        jb, tb = BATCHES[0][0], BATCHES[1][0]
        jsch, tsch = JS, TS
    else:
        jsch, tsch = seq_schemas(js), seq_schemas(ts)
        ser = JSer(jsch)
        recs = [j_encode_row(ser, JRT.SEQUENCE_EXAMPLE, r) for r in SEQ_ROWS]
        jb = JDecoder(jsch, JRT.SEQUENCE_EXAMPLE).decode_batch(recs)
        tb = TDecoder(tsch, TRT.SEQUENCE_EXAMPLE).decode_batch(recs)
    jenc = jnative.make_encoder(jsch, JRT(record_type))
    tenc = tnative.make_encoder(tsch, TRT(record_type))
    out = tenc.encode_batch(tb)
    assert out.dtype == np.uint8 and out.tobytes() == jenc.encode_batch(jb).tobytes()


def test_make_encoder_none_only_for_supported_reasons(monkeypatch):
    assert tnative.make_encoder(TS, "ByteArray") is None
    nested = ts.StructType([ts.StructField("x", ts.ArrayType(ts.ArrayType(ts.ArrayType(ts.LongType()))))])
    assert tnative.make_encoder(nested, "SequenceExample") is None
    assert isinstance(tnative.make_encoder(TS, "Example"), tnative.NativeEncoder)

    def broken():
        raise RuntimeError("g++ failed to build tfrecord_native.cc")

    monkeypatch.setattr(tnative, "load", broken)
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        tnative.make_encoder(TS, "Example")
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        twriter.DatasetWriter("/nonexistent/x", TS).write_batches(BATCHES[1][:1])


@pytest.mark.parametrize("which", ["example", "sequence"])
def test_batch_to_rows_like_jax(which):
    if which == "example":
        jrows, trows = j_batch_to_rows(BATCHES[0][0], JS), batch_to_rows(BATCHES[1][0], TS)
    else:
        ser = JSer(seq_schemas(js))
        recs = [j_encode_row(ser, JRT.SEQUENCE_EXAMPLE, r) for r in SEQ_ROWS]
        jrows = j_batch_to_rows(JDecoder(seq_schemas(js), JRT.SEQUENCE_EXAMPLE).decode_batch(recs),
                                seq_schemas(js))
        trows = batch_to_rows(TDecoder(seq_schemas(ts), TRT.SEQUENCE_EXAMPLE).decode_batch(recs),
                              seq_schemas(ts))
    assert trows == jrows
