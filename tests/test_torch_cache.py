"""The port's columnar epoch cache (``tpu_tfrecord_torch/cache.py`` and the
dataset's ``cache="auto"``) against the JAX package's.

- The cases of ``tests/test_cache.py`` on the port's side: options, round
  trips, the invalidation matrix, the corrupt-entry fallback, resume
  positions moving between cached and uncached reads, LRU eviction and
  staging hygiene, the entry registry and malformed footers.
- Interchange with the JAX cache on the same shards: the entry a shard
  gets is byte-equal, under the same name; each side serves the other's
  entry as a hit; hits, misses and bytes written equal; ``inspect_entry``
  reports equal; a fault on a cache open falls back to the same batches.
- The slice: a small DLRM scores a warm cached epoch bit-equal to an
  uncached one, and within ``tests/test_torch_dlrm.py``'s tolerance of the
  JAX DLRM on the same batches.

The JAX dataset is pinned to its native decoder (the entries' ``fused``
key depends on it); every test releases both packages' entry registries.
"""

import json
import os
import struct
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from tpu_tfrecord import cache as jcache  # noqa: E402
from tpu_tfrecord.columnar import batch_to_rows as jbatch_to_rows  # noqa: E402
from tpu_tfrecord.faults import FaultPlan as JFaultPlan  # noqa: E402
from tpu_tfrecord.faults import FaultRule as JFaultRule  # noqa: E402
from tpu_tfrecord.faults import install_chaos as jinstall_chaos  # noqa: E402
from tpu_tfrecord.io.dataset import TFRecordDataset as JDataset  # noqa: E402
from tpu_tfrecord.metrics import METRICS as JMETRICS  # noqa: E402
from tpu_tfrecord.models import dlrm as jdlrm  # noqa: E402
from tpu_tfrecord.options import TFRecordOptions as JOptions  # noqa: E402
from tpu_tfrecord.schema import StructType as JStructType  # noqa: E402
from tpu_tfrecord.tpu.ingest import host_batch_from_columnar as j_hbfc  # noqa: E402

import tpu_tfrecord_torch.io as tio  # noqa: E402
from tpu_tfrecord_torch import cache as tcache  # noqa: E402
from tpu_tfrecord_torch import interop, wire  # noqa: E402
from tpu_tfrecord_torch.columnar import batch_to_rows  # noqa: E402
from tpu_tfrecord_torch.device.ingest import _as_tensor, host_batch_from_columnar  # noqa: E402
from tpu_tfrecord_torch.entry import _read_plan, _score_dataset, write_dryrun_dataset  # noqa: E402
from tpu_tfrecord_torch.faults import FaultPlan, FaultRule, install_chaos  # noqa: E402
from tpu_tfrecord_torch.io.dataset import TFRecordDataset  # noqa: E402
from tpu_tfrecord_torch.io.writer import DatasetWriter  # noqa: E402
from tpu_tfrecord_torch.metrics import METRICS  # noqa: E402
from tpu_tfrecord_torch.models import dlrm as tdlrm  # noqa: E402
from tpu_tfrecord_torch.options import TFRecordOptions  # noqa: E402
from tpu_tfrecord_torch.schema import (  # noqa: E402
    ArrayType,
    FloatType,
    LongType,
    StringType,
    StructField,
    StructType,
)

SCHEMA = StructType([
    StructField("id", LongType(), nullable=False),
    StructField("s", StringType()),  # nullable: the mask round-trips
    StructField("arr", ArrayType(LongType())),  # ragged
])
# every 7th string is null
ROWS = [[i, None if i % 7 == 0 else f"v{i}" * (i % 3 + 1), list(range(i % 5))]
        for i in range(90)]
PER_SHARD = 30  # 3 shards from one write job

# a hashed and packed read (the DLRM's shape of read), 2 shards of 3000 rows
FEAT = StructType([
    StructField("label", LongType(), nullable=False),
    StructField("d1", LongType()), StructField("d2", LongType()),
    StructField("c1", StringType()), StructField("c2", StringType()),
    StructField("arr", ArrayType(FloatType())),
])
FEAT_KW = dict(hash_buckets={"c1": 97, "c2": 97},
               pack={"dense": ["d1", "d2"], "cat": ["c1", "c2"]})


def feat_rows(n=6000, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        k = int(rng.integers(0, 4))
        out.append([i % 2, int(rng.integers(0, 1000)), None if i % 5 == 0 else i * 3,
                    f"s{int(rng.integers(0, 50))}", None if i % 3 == 0 else f"t{i % 11}",
                    [float(x) for x in rng.standard_normal(k)]])
    return out


@pytest.fixture(autouse=True)
def released_registries():
    """Each test's entries are unmapped at its end (a registered map would
    keep ``tmp_path``'s blocks) and the counters start at zero."""
    METRICS.reset()
    JMETRICS.reset()
    yield
    tcache.release_registry()
    jcache.release_registry()


@pytest.fixture
def data_dir(tmp_path):
    out = str(tmp_path / "ds")
    DatasetWriter(out, SCHEMA, mode="overwrite", max_records_per_file=PER_SHARD).write_rows(ROWS)
    return out


@pytest.fixture
def cache_dir(tmp_path):
    return str(tmp_path / "cache")


@pytest.fixture
def feat_dir(tmp_path):
    out = str(tmp_path / "feat")
    DatasetWriter(out, FEAT, mode="overwrite", max_records_per_file=3000).write_rows(feat_rows())
    return out


ROLES = ("values", "offsets", "inner_offsets", "blob", "blob_offsets", "mask")


def batch_items(b, ds, to_rows):
    """A batch's rows, or for a packed read (which has no rows view) each
    column's buffers as bytes."""
    if not ds.pack:
        return to_rows(b, ds.schema)
    out = []
    for name in sorted(b.columns):
        col = b.columns[name]
        out.append((name, col.hash_buckets, tuple(
            None if getattr(col, r) is None
            else bytes(col.blob) if r == "blob"
            else (getattr(col, r).dtype.str, getattr(col, r).shape,
                  np.ascontiguousarray(getattr(col, r)).tobytes())
            for r in ROLES)))
    return [out]


def collect(data_dir, state=None, schema=SCHEMA, batch_size=8, **kw):
    ds = TFRecordDataset(data_dir, batch_size=batch_size, schema=schema, drop_remainder=False,
                         num_epochs=kw.pop("num_epochs", 1), **kw)
    got = []
    with ds.batches(state) as it:
        for b in it:
            got.extend(batch_items(b, ds, batch_to_rows))
    return got


def jcollect(data_dir, schema=SCHEMA, batch_size=8, **kw):
    ds = JDataset(data_dir, batch_size=batch_size, schema=JStructType.from_json(schema.to_json()),
                  drop_remainder=False, num_epochs=1, **kw)
    assert ds._native_decoder is not None  # entries key on the native route
    got = []
    with ds.batches() as it:
        for b in it:
            got.extend(batch_items(b, ds, jbatch_to_rows))
    return got


def entries_in(cache_dir):
    if not os.path.isdir(cache_dir):
        return []
    return sorted(os.path.join(cache_dir, n) for n in os.listdir(cache_dir)
                  if n.endswith(tcache.ENTRY_SUFFIX))


def shards_of(data_dir):
    return sorted(os.path.join(data_dir, n) for n in os.listdir(data_dir) if n.startswith("part-"))


def counters(metrics=METRICS):
    return {k: metrics.counter(f"cache.{k}")
            for k in ("hits", "misses", "bytes_written", "evictions", "corrupt_fallbacks")}


# -- the cases of tests/test_cache.py on the port's side ------------------------------


class TestOptions:
    def test_parse_cache_knobs(self):
        opts = TFRecordOptions.from_map(cache="auto", cacheDir="/tmp/x", cacheMaxBytes="1024")
        assert (opts.cache, opts.cache_dir, opts.cache_max_bytes) == ("auto", "/tmp/x", 1024)
        assert TFRecordOptions.from_map(cache="auto", cache_dir="/tmp/x",
                                        cache_max_bytes=1024) == opts
        j = JOptions.from_map(cache="auto", cacheDir="/tmp/x", cacheMaxBytes="1024")
        assert (j.cache, j.cache_dir, j.cache_max_bytes) == ("auto", "/tmp/x", 1024)

    def test_defaults_off(self):
        opts = TFRecordOptions.from_map()
        assert opts.cache == "off" and opts.cache_dir is None and opts.cache_max_bytes is None

    @pytest.mark.parametrize("kw,match", [
        (dict(cache="always"), "cache must be one of"),
        (dict(cache_max_bytes=0), "cache_max_bytes"),
        (dict(trace="yes"), "trace must be one of"),
        (dict(telemetry_port=70000), "telemetry_port"),
    ])
    def test_bad_values_raise(self, kw, match):
        with pytest.raises(ValueError, match=match):
            TFRecordOptions.from_map(**kw)
        with pytest.raises(ValueError, match=match):
            JOptions.from_map(**kw)


class TestRoundTrip:
    def test_rows_byte_identical_and_counted(self, data_dir, cache_dir):
        base = collect(data_dir)
        first = collect(data_dir, cache="auto", cache_dir=cache_dir)
        c = counters()
        assert first == base
        assert c["misses"] == 3 and c["hits"] == 0 and c["bytes_written"] > 0
        assert len(entries_in(cache_dir)) == 3
        METRICS.reset()
        served = collect(data_dir, cache="auto", cache_dir=cache_dir)
        c = counters()
        assert served == base
        assert c["hits"] == 3 and c["misses"] == 0 and c["bytes_written"] == 0

    def test_second_epoch_of_one_iterator_is_served(self, data_dir, cache_dir):
        base = collect(data_dir)
        got = collect(data_dir, num_epochs=2, cache="auto", cache_dir=cache_dir)
        assert got[:len(base)] == base and got[len(base):] == base
        assert METRICS.counter("cache.hits") == 3

    def test_ragged2_sequence_example(self, tmp_path):
        schema = StructType([StructField("label", LongType(), nullable=False),
                             StructField("frames", ArrayType(ArrayType(FloatType())))])
        rows = [[i, [[float(i + j + k) for k in range(3)] for j in range(i % 4)]]
                for i in range(40)]
        out = str(tmp_path / "seq")
        DatasetWriter(out, schema, TFRecordOptions.from_map(recordType="SequenceExample"),
                      mode="overwrite", max_records_per_file=20).write_rows(rows)
        cdir = str(tmp_path / "seqcache")
        kw = dict(recordType="SequenceExample")
        base = collect(out, schema=schema, **kw)
        collect(out, schema=schema, cache="auto", cache_dir=cdir, **kw)
        METRICS.reset()
        served = collect(out, schema=schema, cache="auto", cache_dir=cdir, **kw)
        assert served == base and METRICS.counter("cache.hits") == 2

    def test_partitioned_dataset_cached(self, tmp_path):
        schema = StructType([StructField("id", LongType(), nullable=False),
                             StructField("part", StringType(), nullable=False)])
        out = str(tmp_path / "parts")
        tio.write([[i, f"p{i % 2}"] for i in range(40)], schema, out, mode="overwrite",
                  partition_by=["part"])
        cdir = str(tmp_path / "pcache")
        base = collect(out, schema=schema)
        collect(out, schema=schema, cache="auto", cache_dir=cdir)
        METRICS.reset()
        served = collect(out, schema=schema, cache="auto", cache_dir=cdir)
        assert served == base and METRICS.counter("cache.hits") == 2

    def test_parallel_workers_and_shuffle_window(self, data_dir, cache_dir):
        base = collect(data_dir, num_workers=3)
        collect(data_dir, cache="auto", cache_dir=cache_dir)
        assert collect(data_dir, num_workers=3, cache="auto", cache_dir=cache_dir) == base
        shuf_u = collect(data_dir, shuffle=True, seed=5, shuffle_window=2)
        shuf_c = collect(data_dir, shuffle=True, seed=5, shuffle_window=2, cache="auto",
                         cache_dir=cache_dir)
        assert shuf_u == shuf_c

    @pytest.mark.parametrize("workers", [1, 4])
    def test_populate_in_the_pool_and_under_autotune(self, data_dir, cache_dir, workers):
        """Workers populate different shards at once; autotune resizes the
        pool while the entries are written and served."""
        base = collect(data_dir)
        kw = dict(num_workers=workers, cache="auto", cache_dir=cache_dir)
        if workers == 1:
            kw.update(autotune="on", autotune_interval_s=0.05)
        assert collect(data_dir, **kw) == base
        assert METRICS.counter("cache.misses") == 3 and len(entries_in(cache_dir)) == 3
        METRICS.reset()
        assert collect(data_dir, **kw) == base
        assert METRICS.counter("cache.hits") == 3

    def test_abandoned_iterator_aborts_the_partial_entry(self, feat_dir, cache_dir):
        """Closing a shard's decode after its first of two chunks (the
        ``GeneratorExit`` a break out of ``batches()`` delivers) aborts the
        populate; a break out of a pooled read leaves whole entries only,
        and no staging."""
        ds = TFRecordDataset(feat_dir, batch_size=1000, schema=FEAT, cache="auto",
                             cache_dir=cache_dir, **FEAT_KW)
        gen = ds._decode_shard(0, 0, 0, 0)
        chunk, _epoch, _cursor, start = next(gen)
        assert start == 0 and chunk.num_rows < 3000
        gen.close()
        assert entries_in(cache_dir) == []
        temp_root = os.path.join(cache_dir, "_temporary")
        assert not os.path.isdir(temp_root) or os.listdir(temp_root) == []
        ds = TFRecordDataset(feat_dir, batch_size=1000, schema=FEAT, num_workers=2,
                             cache="auto", cache_dir=cache_dir, **FEAT_KW)
        with ds.batches() as it:
            next(it)
        for e in entries_in(cache_dir):
            report = tcache.inspect_entry(e)
            assert report["status"] == "ok" and report["rows"] == 3000
        assert not os.path.isdir(temp_root) or os.listdir(temp_root) == []


class TestInvalidation:
    def _populate(self, data_dir, cache_dir, **kw):
        collect(data_dir, cache="auto", cache_dir=cache_dir, **kw)
        METRICS.reset()

    def test_mtime_change_misses(self, data_dir, cache_dir):
        self._populate(data_dir, cache_dir)
        os.utime(shards_of(data_dir)[0], (12345, 12345))
        served = collect(data_dir, cache="auto", cache_dir=cache_dir)
        assert METRICS.counter("cache.hits") == 2 and METRICS.counter("cache.misses") == 1
        assert served == collect(data_dir)
        METRICS.reset()
        collect(data_dir, cache="auto", cache_dir=cache_dir)
        assert METRICS.counter("cache.hits") == 3

    def test_size_change_misses_and_serves_new_rows(self, data_dir, cache_dir):
        self._populate(data_dir, cache_dir)
        victim = shards_of(data_dir)[0]
        recs = list(wire.read_records(victim))
        wire.write_records(victim, recs + [recs[0]])
        served = collect(data_dir, cache="auto", cache_dir=cache_dir)
        assert METRICS.counter("cache.misses") == 1
        assert served == collect(data_dir) and len(served) == len(ROWS) + 1

    def test_schema_change_misses(self, data_dir, cache_dir):
        self._populate(data_dir, cache_dir)
        collect(data_dir, columns=["id", "arr"], cache="auto", cache_dir=cache_dir)
        assert METRICS.counter("cache.hits") == 0 and METRICS.counter("cache.misses") == 3
        assert len(entries_in(cache_dir)) == 6

    def test_verify_crc_change_misses(self, data_dir, cache_dir):
        self._populate(data_dir, cache_dir)
        collect(data_dir, verify_crc=False, cache="auto", cache_dir=cache_dir)
        assert METRICS.counter("cache.hits") == 0

    def test_irrelevant_option_change_hits(self, data_dir, cache_dir):
        self._populate(data_dir, cache_dir)
        got = collect(data_dir, batch_size=17, num_workers=2, prefetch=7, use_mmap=False,
                      readahead_bytes=0, slab_bytes=1 << 20, read_retries=2, cache="auto",
                      cache_dir=cache_dir)
        assert got == collect(data_dir)
        assert METRICS.counter("cache.hits") == 3 and METRICS.counter("cache.misses") == 0

    def test_container_version_bump_misses(self, data_dir, cache_dir, monkeypatch):
        self._populate(data_dir, cache_dir)
        monkeypatch.setattr(tcache, "VERSION", tcache.VERSION + 1)
        served = collect(data_dir, cache="auto", cache_dir=cache_dir)
        assert METRICS.counter("cache.hits") == 0 and METRICS.counter("cache.misses") == 3
        assert served == collect(data_dir)

    def test_tolerant_corrupt_policy_disables_cache(self, data_dir, cache_dir):
        got = collect(data_dir, on_corrupt="skip_record", cache="auto", cache_dir=cache_dir)
        assert got == collect(data_dir) and entries_in(cache_dir) == []


def flip_section_byte(entry_path, which=0, in_place=False):
    footer = tcache.load_footer(entry_path)
    off = footer["chunks"][0]["columns"][which]["sections"][0][1]["off"]
    raw = bytearray(open(entry_path, "rb").read())
    raw[off] ^= 0xFF
    with open(entry_path, "r+b" if in_place else "wb") as fh:
        fh.write(bytes(raw))


class TestCorruptFallback:
    def test_flipped_section_byte_falls_back(self, data_dir, cache_dir):
        base = collect(data_dir)
        collect(data_dir, cache="auto", cache_dir=cache_dir)
        flip_section_byte(entries_in(cache_dir)[0])
        METRICS.reset()
        assert collect(data_dir, cache="auto", cache_dir=cache_dir) == base
        assert METRICS.counter("cache.corrupt_fallbacks") == 1
        assert METRICS.counter("cache.hits") == 2
        METRICS.reset()  # rewritten: clean hits afterwards
        assert collect(data_dir, cache="auto", cache_dir=cache_dir) == base
        assert METRICS.counter("cache.hits") == 3
        assert METRICS.counter("cache.corrupt_fallbacks") == 0

    def test_truncated_entry_falls_back(self, data_dir, cache_dir):
        base = collect(data_dir)
        collect(data_dir, cache="auto", cache_dir=cache_dir)
        entry = entries_in(cache_dir)[0]
        raw = open(entry, "rb").read()
        open(entry, "wb").write(raw[:len(raw) // 2])
        METRICS.reset()
        assert collect(data_dir, cache="auto", cache_dir=cache_dir) == base
        assert METRICS.counter("cache.corrupt_fallbacks") == 1

    def test_corrupt_footer_falls_back(self, data_dir, cache_dir):
        base = collect(data_dir)
        collect(data_dir, cache="auto", cache_dir=cache_dir)
        entry = entries_in(cache_dir)[0]
        raw = bytearray(open(entry, "rb").read())
        raw[-30] ^= 0xFF
        open(entry, "wb").write(bytes(raw))
        METRICS.reset()
        assert collect(data_dir, cache="auto", cache_dir=cache_dir) == base
        assert METRICS.counter("cache.corrupt_fallbacks") == 1

    def test_corrupt_source_is_not_cached(self, data_dir, cache_dir):
        victim = shards_of(data_dir)[0]
        raw = bytearray(open(victim, "rb").read())
        raw[len(raw) // 2] ^= 0xFF
        open(victim, "wb").write(bytes(raw))
        with pytest.raises(wire.TFRecordCorruptionError):
            collect(data_dir, cache="auto", cache_dir=cache_dir)
        ds = TFRecordDataset(data_dir, batch_size=8, schema=SCHEMA, cache="auto",
                             cache_dir=cache_dir)
        fp = tcache.decode_fingerprint(ds._cache_ident())
        assert not os.path.exists(os.path.join(cache_dir, tcache.entry_filename(victim, fp)))
        temp_root = os.path.join(cache_dir, "_temporary")
        assert not os.path.isdir(temp_root) or os.listdir(temp_root) == []


class TestResumeInterchange:
    def _state_after(self, data_dir, n_batches, **kw):
        ds = TFRecordDataset(data_dir, batch_size=8, schema=SCHEMA, drop_remainder=False,
                             num_epochs=1, **kw)
        it = ds.batches()
        head = []
        for _ in range(n_batches):
            head.extend(batch_to_rows(next(it), ds.schema))
        state = it.state()
        it.close()
        return head, state

    @pytest.mark.parametrize("n_batches", [2, 5])  # mid-shard and cross-shard
    def test_saved_uncached_restored_cached(self, data_dir, cache_dir, n_batches):
        head, state = self._state_after(data_dir, n_batches)
        rest_uncached = collect(data_dir, state=state)
        collect(data_dir, cache="auto", cache_dir=cache_dir)
        METRICS.reset()
        rest_cached = collect(data_dir, state=state, cache="auto", cache_dir=cache_dir)
        assert rest_cached == rest_uncached
        assert head + rest_cached == collect(data_dir)
        assert METRICS.counter("cache.hits") > 0

    def test_saved_cached_restored_uncached(self, data_dir, cache_dir):
        collect(data_dir, cache="auto", cache_dir=cache_dir)
        head, state = self._state_after(data_dir, 5, cache="auto", cache_dir=cache_dir)
        assert head + collect(data_dir, state=state) == collect(data_dir)

    def test_resume_miss_does_not_populate_partial_entry(self, data_dir, cache_dir):
        _head, state = self._state_after(data_dir, 2)
        assert state.record_offset > 0
        collect(data_dir, state=state, cache="auto", cache_dir=cache_dir)
        assert len(entries_in(cache_dir)) == 2
        collect(data_dir, cache="auto", cache_dir=cache_dir)
        assert len(entries_in(cache_dir)) == 3


class TestEvictionAndHygiene:
    def test_lru_eviction_respects_budget(self, data_dir, cache_dir):
        collect(data_dir, cache="auto", cache_dir=cache_dir, cache_max_bytes=1)
        assert len(entries_in(cache_dir)) == 1
        assert METRICS.counter("cache.evictions") == 2
        assert (collect(data_dir, cache="auto", cache_dir=cache_dir, cache_max_bytes=1)
                == collect(data_dir))

    def test_oldest_atime_goes_first(self, data_dir, cache_dir):
        """atimes set by hand (a filesystem may not move them): the sweep
        evicts by atime, oldest first, down to the budget."""
        collect(data_dir, cache="auto", cache_dir=cache_dir)
        entries = entries_in(cache_dir)
        sizes = [os.path.getsize(e) for e in entries]
        for age, e in zip((300, 100, 200), entries):
            os.utime(e, ns=(age * 10**9, os.stat(e).st_mtime_ns))
        ds = TFRecordDataset(data_dir, batch_size=8, schema=SCHEMA, cache="auto",
                             cache_dir=cache_dir, cache_max_bytes=sum(sizes) - 1)
        assert ds._cache.sweep() == [entries[1]]
        METRICS.reset()
        budget = max(sizes)
        assert TFRecordDataset(data_dir, batch_size=8, schema=SCHEMA, cache="auto",
                               cache_dir=cache_dir, cache_max_bytes=budget
                               )._cache.sweep() == [entries[2]]
        assert entries_in(cache_dir) == [entries[0]]
        assert METRICS.counter("cache.evictions") == 1

    def test_unbounded_by_default(self, data_dir, cache_dir):
        collect(data_dir, cache="auto", cache_dir=cache_dir)
        assert METRICS.counter("cache.evictions") == 0 and len(entries_in(cache_dir)) == 3

    def test_chaos_open_fault_on_cache_falls_back(self, data_dir, cache_dir):
        base = collect(data_dir)
        collect(data_dir, cache="auto", cache_dir=cache_dir)
        plan = FaultPlan([FaultRule(op="open", kind="transient_error",
                                    path=tcache.ENTRY_SUFFIX, times=None)], seed=7)
        METRICS.reset()
        with install_chaos(plan):
            served = collect(data_dir, cache="auto", cache_dir=cache_dir)
        plan.release()
        assert served == base
        assert METRICS.counter("cache.hits") == 0
        assert any(e["op"] == "open" for e in plan.ledger)
        METRICS.reset()
        assert collect(data_dir, cache="auto", cache_dir=cache_dir) == base
        assert METRICS.counter("cache.hits") == 3

    def test_chaos_rename_fault_kills_the_populate_not_the_epoch(self, data_dir, cache_dir):
        base = collect(data_dir)
        plan = FaultPlan([FaultRule(op="rename", kind="transient_error",
                                    path=tcache.ENTRY_SUFFIX, times=None)], seed=3)
        with install_chaos(plan):
            served = collect(data_dir, cache="auto", cache_dir=cache_dir)
        plan.release()
        assert served == base and entries_in(cache_dir) == []
        assert METRICS.counter("cache.populate_errors") == 3


class TestRegistry:
    def test_scheme_cache_dir_rejected(self, data_dir):
        with pytest.raises(ValueError, match="cache_dir must be a local path"):
            TFRecordDataset(data_dir, batch_size=8, schema=SCHEMA, cache="auto",
                            cache_dir="memory://nope/cache")

    def test_remote_shard_raises_as_the_filesystem_does(self, monkeypatch):
        """A remote shard's identity comes from its filesystem's ``info``:
        a missing object (or a store that cannot be asked) stamps 0, as in
        the JAX cache; a filesystem that cannot be built raises."""
        from tpu_tfrecord import cache as jcache

        pytest.importorskip("fsspec")
        url = "memory://bucket-cache-test/part-00000.tfrecord"
        assert tcache.source_stat(url) == jcache.source_stat(url) == \
            {"path": url, "size": 0, "mtime_ns": 0}
        assert tcache.source_stat(url, 77) == jcache.source_stat(url, 77)

        def refuse(path):
            raise ImportError(f"no filesystem for {path}")

        monkeypatch.setattr(tcache._fs, "filesystem_for", refuse)
        with pytest.raises(ImportError, match="no filesystem"):
            tcache.source_stat(url)

    def test_registry_skips_reverification_across_datasets(self, data_dir, cache_dir,
                                                           monkeypatch):
        collect(data_dir, cache="auto", cache_dir=cache_dir)
        collect(data_dir, cache="auto", cache_dir=cache_dir)
        calls = []
        orig = tcache.open_entry_file
        monkeypatch.setattr(tcache, "open_entry_file",
                            lambda *a, **k: (calls.append(a), orig(*a, **k))[1])
        METRICS.reset()
        assert collect(data_dir, cache="auto", cache_dir=cache_dir) == collect(data_dir)
        assert METRICS.counter("cache.hits") == 3 and calls == []

    def test_registry_prunes_superseded_generations(self, data_dir, cache_dir):
        collect(data_dir, cache="auto", cache_dir=cache_dir)
        collect(data_dir, cache="auto", cache_dir=cache_dir)
        os.utime(shards_of(data_dir)[0], (777, 777))
        collect(data_dir, cache="auto", cache_dir=cache_dir)
        collect(data_dir, cache="auto", cache_dir=cache_dir)
        for entry in entries_in(cache_dir):
            apath = os.path.abspath(entry)
            assert len([k for k in tcache._ENTRY_REGISTRY if k[0] == apath]) <= 1

    def test_in_place_flip_same_inode_size_still_detected(self, data_dir, cache_dir):
        base = collect(data_dir)
        collect(data_dir, cache="auto", cache_dir=cache_dir)
        collect(data_dir, cache="auto", cache_dir=cache_dir)
        flip_section_byte(entries_in(cache_dir)[0], in_place=True)
        METRICS.reset()
        assert collect(data_dir, cache="auto", cache_dir=cache_dir) == base
        assert METRICS.counter("cache.corrupt_fallbacks") == 1

    def test_failed_populator_setup_leaves_no_staging(self, data_dir, cache_dir, monkeypatch):
        cache = tcache.ShardCache(cache_dir, ident={"x": 1})

        class MissingShard:
            path = os.path.join(data_dir, "does-not-exist.tfrecord")
            size = 0

        assert cache.populator(MissingShard()) is None

        def boom(self):
            raise OSError("disk full")

        monkeypatch.setattr(tcache.CachePopulator, "_write_marker", boom)

        class RealShard:
            path = shards_of(data_dir)[0]
            size = os.path.getsize(path)

        assert cache.populator(RealShard()) is None
        temp_root = os.path.join(cache_dir, "_temporary")
        assert not os.path.isdir(temp_root) or os.listdir(temp_root) == []

    def test_peek_entry_has_no_side_effects(self, data_dir, cache_dir):
        ds = TFRecordDataset(data_dir, batch_size=8, schema=SCHEMA, cache="auto",
                             cache_dir=cache_dir)
        assert not ds._cache.peek_entry(ds.shards[0])
        collect(data_dir, cache="auto", cache_dir=cache_dir)
        METRICS.reset()
        assert all(ds._cache.peek_entry(sh) for sh in ds.shards)
        assert counters() == dict.fromkeys(counters(), 0)


def rewrite_footer(entry_path, mutate):
    """Re-author an entry's footer under a valid CRC."""
    raw = bytearray(open(entry_path, "rb").read())
    (flen,) = struct.unpack("<Q", raw[-20:-12])
    footer = json.loads(raw[-20 - flen:-20].decode("utf-8"))
    mutate(footer)
    blob = json.dumps(footer, sort_keys=True, default=str).encode("utf-8")
    tail = struct.pack("<QI8s", len(blob), wire.crc32c(blob), tcache.TAIL_MAGIC)
    open(entry_path, "wb").write(bytes(raw[:-20 - flen]) + blob + tail)


def _drop_chunks(f):
    f.pop("chunks")


def _bad_dtype(f):
    f["chunks"][0]["columns"][0]["sections"][0][1]["dtype"] = "<i3"


def _rename_column(f):
    f["chunks"][0]["columns"][0]["name"] = "not_in_schema"


def _lie_about_rows(f):
    f["chunks"][0]["num_rows"] += 1


class TestMalformedFooter:
    @pytest.mark.parametrize("mutate", [_drop_chunks, _bad_dtype, _rename_column,
                                        _lie_about_rows], ids=lambda f: f.__name__.strip("_"))
    def test_malformed_footer_falls_back(self, data_dir, cache_dir, mutate):
        base = collect(data_dir)
        collect(data_dir, cache="auto", cache_dir=cache_dir)
        rewrite_footer(entries_in(cache_dir)[0], mutate)
        METRICS.reset()
        assert collect(data_dir, cache="auto", cache_dir=cache_dir) == base
        assert METRICS.counter("cache.corrupt_fallbacks") == 1
        assert tcache.inspect_entry(entries_in(cache_dir)[0])["status"] == "ok"

    def test_release_registry_unpins_cache_dir(self, data_dir, cache_dir):
        collect(data_dir, cache="auto", cache_dir=cache_dir)
        collect(data_dir, cache="auto", cache_dir=cache_dir)
        prefix = os.path.abspath(cache_dir) + os.sep
        assert any(k[0].startswith(prefix) for k in tcache._ENTRY_REGISTRY)
        assert tcache.release_registry(cache_dir) == 3
        assert not any(k[0].startswith(prefix) for k in tcache._ENTRY_REGISTRY)

    def test_inspect_reports_malformed_footer(self, data_dir, cache_dir):
        collect(data_dir, cache="auto", cache_dir=cache_dir)
        rewrite_footer(entries_in(cache_dir)[0], _drop_chunks)
        statuses = [r["status"] for r in tcache.iter_entry_reports(cache_dir)]
        assert sorted(statuses) == ["corrupt", "ok", "ok"]


# -- interchange with the JAX cache ---------------------------------------------------


READS = {
    "plain": (SCHEMA, {}, "data_dir", 8),
    "hashed_packed": (FEAT, FEAT_KW, "feat_dir", 1000),
}


@pytest.fixture(params=sorted(READS))
def read(request, data_dir, feat_dir):
    schema, kw, which, batch = READS[request.param]
    return dict(schema=schema, kw=kw, path={"data_dir": data_dir, "feat_dir": feat_dir}[which],
                batch=batch)


class TestAgainstJax:
    def test_entry_bytes_and_names_equal(self, read, tmp_path):
        tdir, jdir = str(tmp_path / "tc"), str(tmp_path / "jc")
        port = collect(read["path"], schema=read["schema"], batch_size=read["batch"],
                       cache="auto", cache_dir=tdir, **read["kw"])
        ref = jcollect(read["path"], schema=read["schema"], batch_size=read["batch"],
                       cache="auto", cache_dir=jdir, **read["kw"])
        assert port == ref
        names = sorted(os.listdir(tdir))
        assert names == sorted(os.listdir(jdir)) and len(names) == len(shards_of(read["path"]))
        for n in names:
            assert open(os.path.join(tdir, n), "rb").read() == \
                open(os.path.join(jdir, n), "rb").read()

    @pytest.mark.parametrize("writer", ["port", "jax"])
    def test_each_side_serves_the_others_entry(self, read, cache_dir, writer):
        go = dict(schema=read["schema"], batch_size=read["batch"], cache="auto",
                  cache_dir=cache_dir, **read["kw"])
        base = collect(read["path"], schema=read["schema"], batch_size=read["batch"],
                       **read["kw"])
        (collect if writer == "port" else jcollect)(read["path"], **go)
        METRICS.reset()
        JMETRICS.reset()
        got = (jcollect if writer == "port" else collect)(read["path"], **go)
        reader = JMETRICS if writer == "port" else METRICS
        n = len(shards_of(read["path"]))
        assert got == base
        assert reader.counter("cache.hits") == n and reader.counter("cache.misses") == 0

    def test_counters_equal_the_jax_sides(self, read, tmp_path):
        seen = []
        for run in range(2):  # populate, then warm
            METRICS.reset()
            JMETRICS.reset()
            collect(read["path"], schema=read["schema"], batch_size=read["batch"],
                    cache="auto", cache_dir=str(tmp_path / "tc"), **read["kw"])
            jcollect(read["path"], schema=read["schema"], batch_size=read["batch"],
                     cache="auto", cache_dir=str(tmp_path / "jc"), **read["kw"])
            seen.append((counters(), counters(JMETRICS)))
        for port, ref in seen:
            assert port == ref
        assert seen[0][0]["misses"] == seen[1][0]["hits"] == len(shards_of(read["path"]))

    @pytest.mark.parametrize("workers", [1, 4])
    def test_batches_equal_an_uncached_read(self, feat_dir, cache_dir, workers):
        go = dict(schema=FEAT, batch_size=1000, num_workers=workers, **FEAT_KW)
        base = collect(feat_dir, **go)
        assert collect(feat_dir, cache="auto", cache_dir=cache_dir, **go) == base
        assert collect(feat_dir, cache="auto", cache_dir=cache_dir, **go) == base
        assert jcollect(feat_dir, batch_size=1000, schema=FEAT, num_workers=workers,
                        **FEAT_KW) == base
        assert METRICS.counter("cache.hits") == 2

    def test_python_route_entry_serves_the_native_route(self, feat_dir, cache_dir):
        """The port's Python route hashes and packs like the native one, so
        its entry is the native route's (and the JAX native route's)."""
        go = dict(schema=FEAT, batch_size=1000, cache="auto", cache_dir=cache_dir, **FEAT_KW)
        base = collect(feat_dir, schema=FEAT, batch_size=1000, **FEAT_KW)
        assert collect(feat_dir, decoder="python", **go) == base
        METRICS.reset()
        assert collect(feat_dir, **go) == base
        assert jcollect(feat_dir, **go) == base
        assert METRICS.counter("cache.hits") == 2 and JMETRICS.counter("cache.hits") == 2

    @pytest.mark.parametrize("damage", ["none", "flip", "stale", "truncate", "missing_source"])
    def test_inspect_entry_equals_the_jax_report(self, data_dir, cache_dir, damage):
        collect(data_dir, cache="auto", cache_dir=cache_dir)
        entry = entries_in(cache_dir)[0]
        src = tcache.load_footer(entry)["source"]["path"]
        if damage == "flip":
            flip_section_byte(entry)
        elif damage == "stale":
            os.utime(src, (5, 5))
        elif damage == "truncate":
            raw = open(entry, "rb").read()
            open(entry, "wb").write(raw[:len(raw) // 2])
        elif damage == "missing_source":
            os.remove(src)
        got, want = tcache.inspect_entry(entry), jcache.inspect_entry(entry)
        assert got == want
        assert got["status"] == {"none": "ok", "flip": "corrupt", "stale": "stale",
                                 "truncate": "corrupt", "missing_source": "source_missing"}[damage]
        assert list(tcache.iter_entry_reports(cache_dir)) == \
            list(jcache.iter_entry_reports(cache_dir))

    def test_fault_plan_on_a_cache_open_falls_back_to_the_same_batches(self, feat_dir,
                                                                       tmp_path):
        go = dict(schema=FEAT, batch_size=1000, **FEAT_KW)
        base = collect(feat_dir, **go)
        tdir, jdir = str(tmp_path / "tc"), str(tmp_path / "jc")
        collect(feat_dir, cache="auto", cache_dir=tdir, **go)
        jcollect(feat_dir, cache="auto", cache_dir=jdir, **go)
        rule = dict(op="open", kind="transient_error", path=tcache.ENTRY_SUFFIX, ordinal=0,
                    times=1)
        plan, jplan = FaultPlan([FaultRule(**rule)], seed=1), JFaultPlan([JFaultRule(**rule)],
                                                                         seed=1)
        METRICS.reset()
        JMETRICS.reset()
        with install_chaos(plan):
            got = collect(feat_dir, cache="auto", cache_dir=tdir, **go)
        with jinstall_chaos(jplan):
            ref = jcollect(feat_dir, cache="auto", cache_dir=jdir, **go)
        plan.release()
        jplan.release()
        assert got == ref == base
        assert counters() == counters(JMETRICS)
        assert METRICS.counter("cache.misses") == 1 and METRICS.counter("cache.hits") == 1
        assert [e["op"] for e in plan.ledger] == [e["op"] for e in jplan.ledger] == ["open"]

    def test_cached_views_reach_torch_as_copies(self, feat_dir, cache_dir):
        """A served chunk's arrays are read-only views over the map; the
        feed's tensors are writable copies and no warning is raised."""
        go = dict(schema=FEAT, batch_size=3000, cache="auto", cache_dir=cache_dir, **FEAT_KW)
        collect(feat_dir, **go)
        ds = TFRecordDataset(feat_dir, **go)
        with ds.batches() as it:
            cb = next(it)
        assert not cb["cat"].values.flags.writeable
        hb = host_batch_from_columnar(cb, ds.schema, pad_to={"arr": 4}, hash_buckets=ds.hash_buckets,
                                      pack=ds.pack)
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            t = _as_tensor(hb["cat"])
        t[0, 0] += 1  # writes the copy, never the map
        assert int(t[0, 0]) == int(cb["cat"].values[0, 0]) + 1


# -- the slice: a small DLRM scores a warm cached epoch ------------------------------

VOCAB = 16
SLICE_BATCH = 8
TOL = {"f32": dict(rtol=1e-5, atol=1e-5), "bf16": dict(rtol=2e-2, atol=2e-2)}


def slice_configs(dtype):
    kw = dict(num_dense=4, num_categorical=3, vocab_size=VOCAB, embed_dim=4,
              bottom_mlp=(8, 4), top_mlp=(8, 1), seq_len=4, seq_dim=4, interaction="dot")
    jdt, tdt = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    return jdlrm.DLRMConfig(dtype=jdt, **kw), tdlrm.DLRMConfig(dtype=tdt, **kw)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_warm_cached_epoch_scores_like_uncached_and_jax(tmp_path, dtype):
    jcfg, tcfg = slice_configs(dtype)
    write_dryrun_dataset(str(tmp_path / "data"), tcfg, [24, 16], VOCAB)
    params = jax.tree.map(np.asarray, jdlrm.init_params(jax.random.key(0), jcfg))
    model = interop.dlrm_params_from_jax(params, tcfg, device="cpu")
    paths, hash_buckets, pack, pad_to = _read_plan(str(tmp_path / "data"), tcfg, None, None)
    cache_dir = str(tmp_path / "cache")

    def score(**kw):
        ds = TFRecordDataset(paths, SLICE_BATCH, recordType="SequenceExample",
                             hash_buckets=hash_buckets, pack=pack, **kw)
        return _score_dataset(ds, model, "cpu", pad_to, log1p_dense=False)

    plain = score()
    populate = score(cache="auto", cache_dir=cache_dir)
    METRICS.reset()
    warm = score(cache="auto", cache_dir=cache_dir, trace="on")
    assert METRICS.counter("cache.hits") == 2 and METRICS.counter("cache.misses") == 0
    assert warm.batches == plain.batches == 5
    assert torch.equal(warm.logits, plain.logits) and torch.equal(populate.logits, plain.logits)
    # the JAX DLRM on the same batches, read from the port's entries
    ds = JDataset(paths, batch_size=SLICE_BATCH, recordType="SequenceExample",
                  hash_buckets=hash_buckets, pack=pack, cache="auto", cache_dir=cache_dir)
    want = []
    with ds.batches() as it:
        for cb in it:
            hb = j_hbfc(cb, ds.schema, pad_to=pad_to, hash_buckets=hash_buckets, pack=pack)
            hb.pop("frames_inner_len", None)
            want.append(np.asarray(jdlrm.forward(params, {k: jnp.asarray(v)
                                                          for k, v in hb.items()}, jcfg)))
    assert JMETRICS.counter("cache.hits") == 2
    np.testing.assert_allclose(warm.logits.numpy(), np.concatenate(want), **TOL[dtype])
