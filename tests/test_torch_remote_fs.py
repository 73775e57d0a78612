"""The port's fsspec filesystem (``fs.FsspecFS``) against the JAX package's,
on fsspec's ``memory://`` store, which both packages see in one process:
the cases of ``tests/test_fs.py`` and ``tests/test_fs_faults.py`` on the
port's side, each holding the port's rows, listings and errors against
the JAX package's on the same seeded rows.

- dispatch, round trips written by one package and read by the other,
  schema inference, save modes, ``partition_by``, codecs, the streaming
  dataset (batches and positions equal to the JAX dataset's), glob, the
  sorted walk, the write job's abort on a remote store;
- ``independent_read_handles``: the capability table against the JAX one
  for every protocol, through wrappers and through ``ChaosFS``; the
  ``PrefetchReader`` serializes its fetches on ``memory://``;
- faults on the remote read and write paths (a wrapped fsspec file):
  transient errors healed, an exhausted budget, short reads through every
  codec, truncation, a lost upload, a failed ``_SUCCESS``;
- ``DatasetWriter`` to ``memory://`` (rows and columnar batches) and a
  loud refusal of an ``http://`` target; the cache's source identity of a
  remote shard and its refusal of a remote ``cache_dir``.
"""

import importlib.util
import os
import uuid

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

fsspec = pytest.importorskip("fsspec")

import tpu_tfrecord.io as jio  # noqa: E402
from tpu_tfrecord import cache as jcache  # noqa: E402
from tpu_tfrecord import faults as jfaults  # noqa: E402
from tpu_tfrecord import fs as jfs  # noqa: E402
from tpu_tfrecord.io.dataset import TFRecordDataset as JDataset  # noqa: E402

import tpu_tfrecord_torch.io as tio  # noqa: E402
from tpu_tfrecord_torch import cache as tcache  # noqa: E402
from tpu_tfrecord_torch import faults as tfaults  # noqa: E402
from tpu_tfrecord_torch import fs as tfs  # noqa: E402
from tpu_tfrecord_torch import httpfs as thttp  # noqa: E402
from tpu_tfrecord_torch import wire  # noqa: E402
from tpu_tfrecord_torch.io.dataset import TFRecordDataset  # noqa: E402
from tpu_tfrecord_torch.io.writer import DatasetWriter  # noqa: E402
from tpu_tfrecord_torch.retry import RetryPolicy  # noqa: E402
from tpu_tfrecord_torch.schema import (  # noqa: E402
    FloatType,
    LongType,
    StringType,
    StructField,
    StructType,
)
from tpu_tfrecord.schema import StructType as JStructType  # noqa: E402

SCHEMA = StructType([
    StructField("id", LongType(), nullable=False),
    StructField("x", FloatType()),
    StructField("name", StringType()),
])
JSCHEMA = JStructType.from_json(SCHEMA.to_json())
ROWS = [[i, i / 2.0, f"n{i}"] for i in range(20)]
FAULT_SCHEMA = StructType([StructField("id", LongType(), nullable=False),
                           StructField("s", StringType())])
FAULT_ROWS = [[i, f"val{i}" * (i % 4 + 1)] for i in range(60)]
SIDE = {"port": tio, "jax": jio}


def _fast_retries(n):
    return RetryPolicy(max_retries=n, sleep=lambda _s: None)


@pytest.fixture
def mem_url():
    url = f"memory://tfs-{uuid.uuid4().hex[:8]}"
    yield url
    mem = fsspec.filesystem("memory")
    try:
        mem.rm(url.split("://", 1)[1], recursive=True)
    except FileNotFoundError:
        pass


def table_rows(table):
    return sorted(tuple(r) for r in table.rows)


def ids_and_states(ds):
    got = []
    with ds.batches() as it:
        for cb in it:
            got.append((np.asarray(cb["id"].values).tolist(), it.state().to_json()))
    return got


# -- the cases of tests/test_fs.py ---------------------------------------------------


def test_filesystem_for_dispatch(tmp_path):
    assert isinstance(tfs.filesystem_for(str(tmp_path)), tfs.LocalFS)
    assert isinstance(tfs.filesystem_for("memory://x"), tfs.FsspecFS)
    assert isinstance(tfs.filesystem_for("http://h/x"), thttp.HttpFS)
    assert not tfs.has_scheme("/plain/path")
    assert tfs.has_scheme("gs://bucket/key")
    assert tfs.filesystem_for("memory:///x").normalize("memory:///x") == \
        jfs.filesystem_for("memory:///x").normalize("memory:///x")


@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port"), ("port", "port")])
def test_round_trip_memory(mem_url, writer, reader):
    out = mem_url + "/ds"
    SIDE[writer].write(ROWS, SCHEMA if writer == "port" else JSCHEMA, out, mode="overwrite")
    assert SIDE[reader].has_success_marker(out)
    table = SIDE[reader].read(out, schema=SCHEMA if reader == "port" else JSCHEMA)
    assert table_rows(table) == sorted(tuple(r) for r in ROWS)


def test_write_bytes_equal_the_jax_writer(mem_url):
    """The same rows through either writer: the same record bytes."""
    files = {}
    for side in SIDE:
        out = f"{mem_url}/{side}"
        SIDE[side].write(ROWS, SCHEMA if side == "port" else JSCHEMA, out, mode="overwrite")
        fsys = tfs.filesystem_for(out)
        (name,) = [n for n in fsys.listdir(out) if n.startswith("part-")]
        with fsys.open(f"{out}/{name}", "rb") as fh:
            files[side] = fh.read()
    assert files["port"] == files["jax"]


def test_schema_inference_memory(mem_url):
    out = mem_url + "/infer"
    tio.write(ROWS, SCHEMA, out, mode="overwrite")
    port, ref = tio.read(out), jio.read(out)  # inferred from the remote bytes
    assert port.schema.json() == ref.schema.json()
    assert set(port.schema.names) == {"id", "x", "name"}
    assert tio.reader(out).infer_schema_all_files().json() == \
        jio.reader(out).infer_schema_all_files().json()


def test_save_modes_memory(mem_url):
    out = mem_url + "/modes"
    tio.write(ROWS[:5], SCHEMA, out)
    with pytest.raises(FileExistsError):
        tio.write(ROWS, SCHEMA, out, mode="error")
    tio.write(ROWS, SCHEMA, out, mode="ignore")
    assert len(tio.read(out, schema=SCHEMA).rows) == 5
    tio.write(ROWS[5:8], SCHEMA, out, mode="append")
    assert len(tio.read(out, schema=SCHEMA).rows) == 8
    assert len(jio.read(out, schema=JSCHEMA).rows) == 8
    tio.write(ROWS[:3], SCHEMA, out, mode="overwrite")
    assert len(tio.read(out, schema=SCHEMA).rows) == 3


def test_partition_by_memory(mem_url):
    out = mem_url + "/pt"
    rows = [[i, float(i), f"g{i % 3}"] for i in range(9)]
    tio.write(rows, SCHEMA, out, mode="overwrite", partition_by=["name"])
    fsys = tfs.filesystem_for(out)
    assert sorted(e for e in fsys.listdir(out) if e.startswith("name=")) == [
        "name=g0", "name=g1", "name=g2"]
    port, ref = tio.read(out), jio.read(out)
    assert port.schema.names[-1] == "name"  # the partition column is appended
    assert sorted(port.column("id")) == list(range(9))
    assert table_rows(port) == table_rows(ref)


@pytest.mark.parametrize("codec", ["gzip", "deflate", "bzip2"])
def test_codecs_memory(mem_url, codec):
    out = mem_url + "/c"
    tio.write(ROWS, SCHEMA, out, mode="overwrite", codec=codec)
    fsys = tfs.filesystem_for(out)
    names = [n for n in fsys.listdir(out) if n.startswith("part-")]
    assert names and all(wire.codec_from_path(n) == wire.normalize_codec(codec) for n in names)
    assert table_rows(tio.read(out, schema=SCHEMA)) == table_rows(jio.read(out, schema=JSCHEMA))
    assert sorted(tio.read(out, schema=SCHEMA).column("id")) == list(range(20))


@pytest.mark.parametrize("workers", [1, 3])
def test_streaming_dataset_memory(mem_url, workers):
    out = mem_url + "/stream"
    for s in range(3):
        tio.write(ROWS[s * 7:(s + 1) * 7], SCHEMA, out, mode="append" if s else "overwrite")
    port = ids_and_states(TFRecordDataset(out, batch_size=4, schema=SCHEMA,
                                          drop_remainder=False, num_workers=workers))
    ref = ids_and_states(JDataset(out, batch_size=4, schema=JSCHEMA, drop_remainder=False,
                                  num_workers=workers))
    assert port == ref
    assert sorted(i for ids, _ in port for i in ids) == list(range(20))


def test_glob_memory(mem_url):
    for sub in ("a", "b"):
        tio.write(ROWS[:4], SCHEMA, mem_url + f"/glob/{sub}", mode="overwrite")
    table = tio.read(mem_url + "/glob/*", schema=SCHEMA)
    assert len(table.rows) == 8
    assert tfs.filesystem_for(mem_url).glob(mem_url + "/glob/*") == \
        jfs.filesystem_for(mem_url).glob(mem_url + "/glob/*")


def test_walk_order_deterministic_memory(mem_url):
    """Directory recursion is sorted (fsspec's own walk follows dict
    order): every process derives the same global shard order."""
    for sub in ["b", "a", "c"]:  # insertion order differs from sorted order
        tio.write(ROWS[:2], SCHEMA, mem_url + f"/walk/{sub}", mode="overwrite")

    def keep(n):
        return not n.startswith("_")

    seen = list(tfs.filesystem_for(mem_url).walk_files(mem_url + "/walk", keep))
    assert [p for p, _ in seen] == sorted(p for p, _ in seen)
    assert seen == list(jfs.filesystem_for(mem_url).walk_files(mem_url + "/walk", keep))
    shards = tio.discover_shards(mem_url + "/walk")
    assert [(s.path, s.size) for s in shards] == [
        (s.path, s.size) for s in jio.discover_shards(mem_url + "/walk")]


def test_failed_write_leaves_no_partial_output_memory(mem_url):
    out = mem_url + "/aborted"

    def exploding_rows():
        yield [1, 1.0, "a"]
        yield [2, 2.0, "b"]
        raise RuntimeError("upstream died")

    with pytest.raises(RuntimeError, match="upstream died"):
        tio.write(exploding_rows(), SCHEMA, out, mode="error")
    fsys = tfs.filesystem_for(out)
    if fsys.exists(out):
        leftovers = [n for n in fsys.listdir(out) if not n.startswith("_temporary")]
        assert leftovers == [], leftovers
    assert not tio.has_success_marker(out)
    tio.write(ROWS[:4], SCHEMA, out, mode="error")
    assert len(tio.read(out, schema=SCHEMA).rows) == 4


def test_scheme_errors_cleanly():
    got, want = None, None
    try:
        tio.read("noproto42://bucket/x", schema=SCHEMA)
    except Exception as e:  # noqa: BLE001 - compared with the JAX error below
        got = type(e)
    try:
        jio.read("noproto42://bucket/x", schema=JSCHEMA)
    except Exception as e:  # noqa: BLE001
        want = type(e)
    assert got is not None and got is want


# -- the handle capability -----------------------------------------------------------


def _proto(proto, **extra):
    return type("_FS", (), dict(protocol=proto, **extra))()


PROTOCOLS = sorted(jfs._INDEPENDENT_HANDLE_PROTOCOLS) + [
    "memory", "ftp", "sftp", "ssh", "someproto42", ("gs", "gcs"), ("gs", "weird"),
    ("s3", "s3a"), ["http", "https"]]


def test_capability_allowlist_equals_jax():
    assert tfs._INDEPENDENT_HANDLE_PROTOCOLS == jfs._INDEPENDENT_HANDLE_PROTOCOLS


@pytest.mark.parametrize("proto", PROTOCOLS, ids=str)
def test_capability_table_equals_jax(proto):
    obj = _proto(proto)
    assert tfs.independent_read_handles(obj) == jfs.independent_read_handles(obj)

    class _Wrapper:
        def __init__(self, inner):
            self._fs = inner

    wrapped = _Wrapper(_Wrapper(obj))
    assert tfs.independent_read_handles(wrapped) == jfs.independent_read_handles(wrapped)


def test_capability_declarations_and_wrapper_chain():
    assert not tfs.independent_read_handles(object())
    assert not tfs.independent_read_handles(None)
    assert tfs.independent_read_handles(_proto("someproto42", independent_read_handles=True))
    assert not tfs.independent_read_handles(_proto("s3", independent_read_handles=False))

    class _OptOut:
        independent_read_handles = False

        def __init__(self, inner):
            self._fs = inner

    assert not tfs.independent_read_handles(_OptOut(_proto("s3")))


def test_capability_through_chaos_fs(mem_url):
    """``ChaosFS`` keeps the wrapped filesystem as ``_fs``: the walk sees
    through it, for the port's filesystems as for the JAX ones."""
    plan = tfaults.FaultPlan([])
    jplan = jfaults.FaultPlan([])
    for url, want in ((mem_url, False), ("http://h/x", True)):
        port = tfs.filesystem_for(url)
        ref = jfs.filesystem_for(url)
        assert tfs.independent_read_handles(port) is want
        assert tfs.independent_read_handles(tfaults.ChaosFS(port, plan)) is want
        assert jfs.independent_read_handles(jfaults.ChaosFS(ref, jplan)) is want


def test_prefetch_serializes_on_memory_and_matches(mem_url, monkeypatch):
    """A remote dataset big enough to engage the prefetcher decodes the
    same with pipelining on and off, and the pipelined leg provably went
    through ``PrefetchReader`` with its fetches serialized (one shared
    handle on ``memory://``)."""
    out = mem_url + "/ds"
    schema = StructType([StructField("x", LongType()), StructField("s", StringType())])
    tio.write([[i, "v" * 64] for i in range(5000)], schema, out, mode="overwrite")
    monkeypatch.setenv("TFR_REMOTE_BLOCK_BYTES", str(128 << 10))
    built = []
    real_init = tfs.PrefetchReader.__init__

    def init(self, *a, **k):
        real_init(self, *a, **k)
        built.append(self._fetch_lock is not None)

    monkeypatch.setattr(tfs.PrefetchReader, "__init__", init)

    def read_ids(use_mmap):
        ds = TFRecordDataset(out, batch_size=512, schema=schema, drop_remainder=False,
                             use_mmap=use_mmap)
        got = []
        with ds.batches() as it:
            for cb in it:
                got.extend(cb["x"].values.tolist())
        return got

    monkeypatch.setenv("TFR_REMOTE_PREFETCH_DEPTH", "4")
    with_prefetch = read_ids(True)  # use_mmap is ignored on a URL
    assert built and all(built), built
    n = len(built)
    monkeypatch.setenv("TFR_REMOTE_PREFETCH_DEPTH", "0")
    without = read_ids(False)
    assert len(built) == n, "depth 0 must disable the prefetcher"
    assert with_prefetch == without == list(range(5000))


def test_remote_gzip_streams_through_prefetcher(mem_url, monkeypatch):
    """A big compressed remote object streams off the block pipeline under
    the gzip layer and decodes like the JAX read of it."""
    schema = StructType([StructField("x", LongType()), StructField("s", StringType())])
    rows = [[i, "pad" * 40] for i in range(40000)]
    out = mem_url + "/gzds"
    tio.write(rows, schema, out, mode="overwrite", codec="gzip")
    fsys = tfs.filesystem_for(out)
    part = sorted(n for n in fsys.listdir(out) if n.startswith("part-"))[0]
    size = fsys.size(out + "/" + part)
    monkeypatch.setenv("TFR_REMOTE_BLOCK_BYTES", str(max(64 << 10, size // 8)))
    built = []
    real_init = tfs.PrefetchReader.__init__
    monkeypatch.setattr(tfs.PrefetchReader, "__init__",
                        lambda self, *a, **k: (built.append(1), real_init(self, *a, **k))[1])
    got = tio.read(out, schema=schema)
    assert built, "the gzip read did not engage the prefetcher"
    assert [r[0] for r in got.rows] == [r[0] for r in rows]
    assert [r[0] for r in jio.read(out, schema=JStructType.from_json(schema.to_json())).rows] \
        == [r[0] for r in got.rows]


# -- the cases of tests/test_fs_faults.py -----------------------------------------


class _FaultyFile:
    """An fsspec file with an optional cap on each read, a one-shot OSError
    after N bytes, and an OSError from close() on write streams (a lost
    upload: the inner file is never closed, so nothing lands)."""

    def __init__(self, inner, plan, path):
        self._inner = inner
        self._plan = plan
        self._path = path
        self._read_bytes = 0

    def _maybe_fail(self):
        remaining = self._plan.read_faults.get(self._path, 0)
        if remaining and self._read_bytes >= self._plan.fail_after_bytes:
            self._plan.read_faults[self._path] = remaining - 1
            raise OSError(f"injected transient read error on {self._path}")

    def read(self, size=-1):
        self._maybe_fail()
        if self._plan.short_read_cap and size is not None and size > 0:
            size = min(size, self._plan.short_read_cap)
        data = self._inner.read(size)
        self._read_bytes += len(data)
        return data

    def readinto(self, b):
        data = self.read(len(b))
        b[: len(data)] = data
        return len(data)

    def write(self, data):
        return self._inner.write(data)

    def close(self):
        if self._plan.close_faults and not self._inner.closed and \
                "w" in getattr(self._inner, "mode", "w"):
            if any(k in self._path for k in self._plan.close_faults):
                raise OSError(f"injected upload failure on close: {self._path}")
        if not self._inner.closed:
            self._inner.close()

    @property
    def closed(self):
        return self._inner.closed

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __getattr__(self, name):
        return getattr(self._inner, name)


class _Faults:
    def __init__(self):
        self.read_faults = {}
        self.fail_after_bytes = 0
        self.short_read_cap = 0
        self.close_faults = set()


@pytest.fixture
def faulty_fs(monkeypatch):
    plan = _Faults()
    orig = tfs.FsspecFS.open
    monkeypatch.setattr(tfs.FsspecFS, "open",
                        lambda self, path, mode: _FaultyFile(orig(self, path, mode), plan, path))
    return plan


def _write_remote(mem_url, n_shards=3):
    out = mem_url + "/ds"
    per = len(FAULT_ROWS) // n_shards
    for s in range(n_shards):
        tio.write(FAULT_ROWS[s * per:(s + 1) * per], FAULT_SCHEMA, out,
                  mode="append" if s else "overwrite")
    return out


def _read_all_ids(out, **kw):
    ds = TFRecordDataset(out, batch_size=7, schema=FAULT_SCHEMA, drop_remainder=False, **kw)
    got = []
    with ds.batches() as it:
        for cb in it:
            got.extend(cb["id"].values.tolist())
    return got


def _jax_ids(out):
    ds = JDataset(out, batch_size=7, schema=JStructType.from_json(FAULT_SCHEMA.to_json()),
                  drop_remainder=False)
    got = []
    with ds.batches() as it:
        for cb in it:
            got.extend(cb["id"].values.tolist())
    return got


class TestRemoteReadFaults:
    def test_transient_error_retries_without_dups_or_holes(self, mem_url, faulty_fs):
        out = _write_remote(mem_url)
        shards = [s.path for s in tio.discover_shards(out)]
        faulty_fs.fail_after_bytes = 100  # mid-stream, not on open
        faulty_fs.read_faults = {p: 1 for p in shards}
        got = _read_all_ids(out, retry_policy=_fast_retries(2))
        assert got == _jax_ids(out)
        assert sorted(got) == sorted(r[0] for r in FAULT_ROWS)
        assert all(v == 0 for v in faulty_fs.read_faults.values())  # every one fired

    def test_retries_exhausted_raises(self, mem_url, faulty_fs):
        out = _write_remote(mem_url)
        shards = [s.path for s in tio.discover_shards(out)]
        faulty_fs.fail_after_bytes = 0  # every read of the shard fails before a byte
        faulty_fs.read_faults = {shards[0]: 1000}
        with pytest.raises(OSError, match="injected transient"):
            _read_all_ids(out, retry_policy=_fast_retries(2))

    def test_short_reads_stream_correctly(self, mem_url, faulty_fs):
        out = _write_remote(mem_url)
        faulty_fs.short_read_cap = 7
        assert sorted(_read_all_ids(out)) == sorted(r[0] for r in FAULT_ROWS)
        table = tio.read(out, schema=FAULT_SCHEMA)
        assert sorted(table.column("id")) == sorted(r[0] for r in FAULT_ROWS)

    @pytest.mark.parametrize("codec", [
        "gzip", "deflate",
        pytest.param("zstd", marks=pytest.mark.skipif(
            importlib.util.find_spec("zstandard") is None,
            reason="optional zstandard package not installed")),
        "snappy", "lz4", "bzip2",
    ])
    def test_short_reads_through_codec_streams(self, mem_url, faulty_fs, codec):
        out = mem_url + f"/short_{codec}"
        tio.write(FAULT_ROWS[:20], FAULT_SCHEMA, out, mode="overwrite", codec=codec)
        faulty_fs.short_read_cap = 3
        table = tio.read(out, schema=FAULT_SCHEMA)
        assert sorted(table.column("id")) == list(range(20))

    def test_remote_truncation_detected(self, mem_url, faulty_fs):
        out = _write_remote(mem_url, n_shards=1)
        shard = tio.discover_shards(out)[0].path
        mem = fsspec.filesystem("memory")
        key = shard.split("://", 1)[1]
        blob = mem.cat_file(key)
        mem.pipe_file(key, blob[: len(blob) - 5])
        with pytest.raises(wire.TFRecordCorruptionError):
            _read_all_ids(out)

    def test_remote_gzip_truncation_detected(self, mem_url, faulty_fs):
        out = mem_url + "/gz"
        tio.write(FAULT_ROWS[:20], FAULT_SCHEMA, out, mode="overwrite", codec="gzip")
        shard = tio.discover_shards(out)[0].path
        mem = fsspec.filesystem("memory")
        key = shard.split("://", 1)[1]
        blob = mem.cat_file(key)
        mem.pipe_file(key, blob[: len(blob) // 2])
        with pytest.raises((wire.TFRecordCorruptionError, OSError, EOFError)):
            _read_all_ids(out)


class TestRemoteWriteFaults:
    def test_upload_on_close_failure_aborts_cleanly(self, mem_url, faulty_fs):
        out = mem_url + "/aborted"
        faulty_fs.close_faults = {"part-"}
        with pytest.raises(OSError, match="injected upload failure"):
            tio.write(FAULT_ROWS[:10], FAULT_SCHEMA, out, mode="error")
        fsys = tfs.filesystem_for(out)
        if fsys.exists(out):
            visible = [n for n in fsys.listdir(out) if not n.startswith("_temporary")]
            assert visible == [], visible
        assert not tio.has_success_marker(out)
        faulty_fs.close_faults = set()
        tio.write(FAULT_ROWS[:10], FAULT_SCHEMA, out, mode="error")
        assert sorted(tio.read(out, schema=FAULT_SCHEMA).column("id")) == list(range(10))

    def test_upload_failure_leaves_no_object_behind(self, mem_url, faulty_fs):
        out = mem_url + "/lost"
        faulty_fs.close_faults = {"part-"}
        with pytest.raises(OSError, match="injected upload failure"):
            tio.write(FAULT_ROWS[:5], FAULT_SCHEMA, out, mode="error")
        mem = fsspec.filesystem("memory")
        key = out.split("://", 1)[1]
        if mem.exists(key):
            found = [p for p in mem.find(key) if "part-" in p]
            assert found == [], found

    def test_success_marker_write_failure_propagates(self, mem_url, monkeypatch):
        out = mem_url + "/marker"
        orig_touch = tfs.FsspecFS.touch

        def touch_(self, path):
            if "_SUCCESS" in path:
                raise OSError(f"injected marker upload failure: {path}")
            return orig_touch(self, path)

        monkeypatch.setattr(tfs.FsspecFS, "touch", touch_)
        with pytest.raises(OSError, match="injected marker upload"):
            tio.write(FAULT_ROWS[:4], FAULT_SCHEMA, out, mode="error")
        assert not tio.has_success_marker(out)


# -- DatasetWriter targets --------------------------------------------------------------


@pytest.mark.parametrize("workers", [1, 3])
def test_dataset_writer_memory_round_trip(mem_url, tmp_path, workers):
    """``DatasetWriter`` commits to ``memory://`` through ``FsspecFS``
    (rows, then columnar batches through the slab pipeline); both packages
    read back the same rows."""
    from tpu_tfrecord_torch.options import TFRecordOptions

    out = mem_url + "/dw"
    opts = TFRecordOptions.from_map(write_workers=workers)
    w = DatasetWriter(out, SCHEMA, opts, mode="overwrite")
    assert isinstance(w.fs, tfs.FsspecFS)
    w.write_rows(ROWS)
    assert tio.has_success_marker(out)
    assert table_rows(tio.read(out, schema=SCHEMA)) == sorted(tuple(r) for r in ROWS)
    out2 = mem_url + "/dwb"
    local = str(tmp_path / "local")
    tio.write(ROWS, SCHEMA, local, mode="overwrite")
    with TFRecordDataset(local, batch_size=8, schema=SCHEMA, drop_remainder=False,
                         decoder="python").batches() as it:
        batches = list(it)
    DatasetWriter(out2, SCHEMA, opts, mode="overwrite").write_batches(iter(batches))
    assert table_rows(tio.read(out2, schema=SCHEMA)) == table_rows(jio.read(out2, schema=JSCHEMA))
    assert table_rows(tio.read(out2, schema=SCHEMA)) == sorted(tuple(r) for r in ROWS)


def test_http_target_is_refused_as_loudly_as_jax(tmp_path):
    """HTTP is read-only: a write to an ``http://`` target raises the JAX
    writer's error type, and nothing appears on the served directory."""
    from tpu_tfrecord.schema import StructType as JST

    with thttp.serve_directory(str(tmp_path)) as srv:
        got, want = [], []
        for target in (srv.url_for("new"), srv.url_for("new2")):
            for side, box in (("port", got), ("jax", want)):
                try:
                    SIDE[side].write(ROWS, SCHEMA if side == "port" else JST.from_json(
                        SCHEMA.to_json()), target, mode="overwrite")
                    box.append(("ok", ""))
                except Exception as e:  # noqa: BLE001 - the type is compared
                    box.append((type(e).__name__, "read-only" in str(e)))
        assert got == want
        assert got[0] == ("OSError", True)
    assert os.listdir(tmp_path) == []


# -- the cache and remote shards ----------------------------------------------------


def test_remote_cache_dir_raises(mem_url):
    with pytest.raises(ValueError, match="local path"):
        tcache.ShardCache(mem_url + "/cache", ident={"x": 1})


def test_source_stat_of_a_remote_shard_equals_jax(mem_url):
    out = _write_remote(mem_url, n_shards=1)
    shard = tio.discover_shards(out)[0]
    port = tcache.source_stat(shard.path, shard.size)
    assert port == jcache.source_stat(shard.path, shard.size)
    assert port["path"] == shard.path and port["size"] == shard.size
    assert tcache.source_stat(shard.path) == jcache.source_stat(shard.path)
    missing = tcache.source_stat(out + "/nothing.tfrecord")
    assert missing == jcache.source_stat(out + "/nothing.tfrecord")
    assert missing["size"] == 0 and missing["mtime_ns"] == 0


def test_memory_dataset_into_the_cache(mem_url, tmp_path):
    """A ``memory://`` source populates local entries, and a second epoch
    is served from them; the entries' reports check the remote source."""
    from tpu_tfrecord_torch.metrics import METRICS

    out = _write_remote(mem_url)
    cdir = str(tmp_path / "cache")
    first = _read_all_ids(out, cache="auto", cache_dir=cdir)
    METRICS.reset()
    second = _read_all_ids(out, cache="auto", cache_dir=cdir)
    assert first == second == _jax_ids(out)
    assert METRICS.counter("cache.hits") == 3 and METRICS.counter("cache.misses") == 0
    reports = list(tcache.iter_entry_reports(cdir))
    assert [r["status"] for r in reports] == ["ok"] * 3
    assert not any("source_check" in r for r in reports)
    tcache.release_registry(cdir)
