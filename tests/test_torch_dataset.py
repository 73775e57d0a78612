"""The port's prefetching ``TFRecordDataset`` against the JAX package's, batch
by batch, over shards of uneven length with batches that cross decode
chunks, shards and epochs; the native decoder against the Python oracle;
and the producer thread's contract (errors reach the consumer, an early
exit leaves no thread, zero-copy group views outlive the dataset)."""

import gc
import gzip
import os
import threading
import time

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from tpu_tfrecord import schema as jschema, wire as jwire  # noqa: E402
from tpu_tfrecord.io.dataset import TFRecordDataset as JDataset  # noqa: E402
from tpu_tfrecord.proto import (  # noqa: E402
    Example,
    Feature,
    FeatureList,
    SequenceExample,
    encode_example,
    encode_sequence_example,
)

from tpu_tfrecord_torch import _native as tnative, schema as tschema, wire as twire  # noqa: E402
from tpu_tfrecord_torch.columnar import concat_batches, slice_batch  # noqa: E402
from tpu_tfrecord_torch.io import dataset as dataset_mod  # noqa: E402
from tpu_tfrecord_torch.io.dataset import TFRecordDataset as TDataset  # noqa: E402
from tpu_tfrecord_torch.serde import NullValueError  # noqa: E402

SHARD_ROWS = [700, 2500, 333]   # the middle shard spans two decode chunks (2048 + 452)
BATCH = 300                     # divides no shard and no total


def criteo_schema(mod):
    return mod.StructType(
        [mod.StructField("label", mod.IntegerType(), nullable=False)]
        + [mod.StructField(f"I{i}", mod.IntegerType()) for i in range(3)]
        + [mod.StructField(f"C{i}", mod.StringType()) for i in range(3)]
        + [mod.StructField("tags", mod.ArrayType(mod.StringType()))]
        + [mod.StructField("w", mod.ArrayType(mod.FloatType()))]
    )


def seq_schema(mod):
    return mod.StructType([
        mod.StructField("label", mod.LongType(), nullable=False),
        mod.StructField("c", mod.StringType()),
        mod.StructField("frames", mod.ArrayType(mod.ArrayType(mod.FloatType()))),
        mod.StructField("words", mod.ArrayType(mod.ArrayType(mod.StringType()))),
    ])


CRITEO_KW = dict(recordType="Example",
                 hash_buckets={"C0": 1 << 20, "C1": 7, "C2": 1 << 20, "tags": 11},
                 pack={"dense": ["I0", "I1", "I2"], "cat": ["C0", "C1", "C2"]})
SEQ_KW = dict(recordType="SequenceExample", hash_buckets={"c": 5})


def criteo_records(n, rng):
    out = []
    for k in range(n):
        feats = {"label": Feature.int64_list([int(rng.integers(0, 2))])}
        for i in range(3):
            if rng.random() > 0.1:
                feats[f"I{i}"] = Feature.int64_list([int(rng.integers(-(1 << 33), 1 << 33))])
            if rng.random() > 0.1:
                feats[f"C{i}"] = Feature.bytes_list([f"v{int(rng.integers(0, 99))}".encode()])
        feats["tags"] = Feature.bytes_list([b"t%d" % v for v in rng.integers(0, 9, size=k % 4)])
        feats["w"] = Feature.float_list(rng.normal(size=k % 3).tolist())
        out.append(encode_example(Example(features=feats)))
    return out


def seq_records(n, rng):
    out = []
    for k in range(n):
        ctx = {"label": Feature.int64_list([k]),
               "c": Feature.bytes_list([f"c{int(rng.integers(0, 20))}".encode()])}
        fl = {"frames": FeatureList([Feature.float_list(rng.normal(size=int(m)).tolist())
                                     for m in rng.integers(0, 4, size=k % 4)]),
              "words": FeatureList([Feature.bytes_list([b"w%d" % j for j in range(int(m))])
                                    for m in rng.integers(0, 3, size=k % 3)])}
        out.append(encode_sequence_example(SequenceExample(context=ctx, feature_lists=fl)))
    return out


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    """{(kind, gzip_middle): dir} of 3 shards written once through the JAX
    writer; with gzip_middle the second shard is a .tfrecord.gz."""
    root = tmp_path_factory.mktemp("torch_dataset")
    out = {}
    for kind, make in (("criteo", criteo_records), ("seq", seq_records)):
        rng = np.random.default_rng(7)
        shards = [make(n, rng) for n in SHARD_ROWS]
        for gz in (False, True):
            d = root / f"{kind}_{'gz' if gz else 'plain'}"
            d.mkdir()
            for i, recs in enumerate(shards):
                codec = "gzip" if gz and i == 1 else None
                jwire.write_records(str(d / f"part-{i:05d}.tfrecord{'.gz' if codec else ''}"),
                                    recs, codec=codec)
            out[(kind, gz)] = str(d)
    return out


def assert_batches_equal(a, b):
    assert a.num_rows == b.num_rows
    assert sorted(a.columns) == sorted(b.columns)
    for name in a.columns:
        ca, cb = a[name], b[name]
        assert ca.hash_buckets == cb.hash_buckets, name
        for attr in ("values", "offsets", "inner_offsets", "blob_offsets", "mask"):
            va, vb = getattr(ca, attr), getattr(cb, attr)
            assert (va is None) == (vb is None), (name, attr)
            if va is not None:
                va, vb = np.asarray(va), np.asarray(vb)
                assert va.dtype == vb.dtype and va.shape == vb.shape, (name, attr)
                assert np.array_equal(va, vb), f"{name}.{attr}"
        assert (None if ca.blob is None else bytes(ca.blob)) == (
            None if cb.blob is None else bytes(cb.blob)
        ), name


def read_all(ds):
    with ds.batches() as it:
        return list(it)


def expected_sizes(drop_remainder, num_epochs):
    total = sum(SHARD_ROWS) * num_epochs
    sizes = [BATCH] * (total // BATCH)
    if total % BATCH and not drop_remainder:
        sizes.append(total % BATCH)
    return sizes


CASES = [
    # (kind, gzip middle shard, drop_remainder, num_epochs)
    ("criteo", False, True, 1),
    ("criteo", False, False, 1),
    ("criteo", False, False, 2),
    ("criteo", True, True, 2),
    ("criteo", True, False, 1),
    ("seq", False, False, 2),
    ("seq", True, False, 1),
]


class TestAgainstJax:
    @pytest.mark.parametrize("kind,gz,drop,epochs", CASES)
    def test_batches_equal_jax(self, datasets, kind, gz, drop, epochs, monkeypatch):
        # small slabs: records of the gzip shard straddle slab reads
        monkeypatch.setattr(dataset_mod, "SLAB_BYTES", 4096)
        kw = CRITEO_KW if kind == "criteo" else SEQ_KW
        make_schema = criteo_schema if kind == "criteo" else seq_schema
        path = datasets[(kind, gz)]
        jb = read_all(JDataset(path, batch_size=BATCH, schema=make_schema(jschema),
                               drop_remainder=drop, num_epochs=epochs, **kw))
        tds = TDataset(path, batch_size=BATCH, schema=make_schema(tschema),
                       drop_remainder=drop, num_epochs=epochs, **kw)
        assert tds.decoder == "native"
        tb = read_all(tds)
        assert [b.num_rows for b in tb] == expected_sizes(drop, epochs)
        assert len(jb) == len(tb)
        for a, b in zip(jb, tb):
            assert_batches_equal(a, b)

    @pytest.mark.parametrize("kind,gz", [("criteo", False), ("criteo", True), ("seq", True)])
    def test_native_equals_python_oracle(self, datasets, kind, gz):
        kw = CRITEO_KW if kind == "criteo" else SEQ_KW
        make_schema = criteo_schema if kind == "criteo" else seq_schema
        common = dict(batch_size=BATCH, schema=make_schema(tschema), drop_remainder=False, **kw)
        native = TDataset(datasets[(kind, gz)], **common)
        python = TDataset(datasets[(kind, gz)], decoder="python", **common)
        assert (native.decoder, python.decoder) == ("native", "python")
        got, want = read_all(native), read_all(python)
        assert len(got) == len(want) == len(expected_sizes(False, 1))
        for a, b in zip(got, want):
            assert_batches_equal(a, b)


class TestSliceConcat:
    def test_bucket_count_and_rows_survive_slice_concat(self, datasets):
        ds = TDataset(datasets[("criteo", False)], batch_size=700,
                      schema=criteo_schema(tschema), **CRITEO_KW)
        with ds.batches() as it:
            whole = next(it)
        parts = [slice_batch(whole, 0, 1), slice_batch(whole, 1, 333), slice_batch(whole, 333, 700)]
        merged = concat_batches(parts)
        assert merged["tags"].hash_buckets == 11
        assert_batches_equal(merged, whole)
        from tpu_tfrecord.columnar import concat_batches as jconcat, slice_batch as jslice

        jparts = [jslice(whole, 0, 1), jslice(whole, 1, 333), jslice(whole, 333, 700)]
        for a, b in zip(parts, jparts):
            assert_batches_equal(a, b)


def _producer_threads():
    return [t for t in threading.enumerate() if t.name == "tfrecord-producer"]


def _wait_no_producer(timeout=10.0):
    deadline = time.monotonic() + timeout
    while _producer_threads() and time.monotonic() < deadline:
        time.sleep(0.01)
    return not _producer_threads()


class TestProducerThread:
    def test_early_break_leaves_no_producer(self, datasets):
        ds = TDataset(datasets[("criteo", False)], batch_size=50, num_epochs=None,
                      schema=criteo_schema(tschema), **CRITEO_KW)
        assert _wait_no_producer()
        with ds.batches() as it:
            for i, batch in enumerate(it):
                assert batch.num_rows == 50
                if i == 3:
                    break
            assert len(_producer_threads()) == 1
        assert _producer_threads() == []

    def test_abandoned_iterator_stops_its_producer(self, datasets):
        ds = TDataset(datasets[("criteo", False)], batch_size=50, num_epochs=None,
                      schema=criteo_schema(tschema), **CRITEO_KW)
        it = ds.batches()
        next(it)
        del it
        gc.collect()
        assert _wait_no_producer()

    def test_corrupt_shard_error_reaches_consumer(self, datasets, tmp_path):
        src = datasets[("criteo", False)]
        for name in sorted(os.listdir(src)):
            raw = bytearray(open(os.path.join(src, name), "rb").read())
            if name.startswith("part-00001"):
                raw[len(raw) // 2] ^= 0xFF
            (tmp_path / name).write_bytes(bytes(raw))
        ds = TDataset(str(tmp_path), batch_size=BATCH, schema=criteo_schema(tschema), **CRITEO_KW)
        got = []
        with pytest.raises(twire.TFRecordCorruptionError):
            with ds.batches() as it:
                for batch in it:
                    got.append(batch.num_rows)
        assert got and got[0] == BATCH  # the first shard's batches came through
        assert _wait_no_producer()

    @pytest.mark.parametrize("codec", [None, "gzip"])
    def test_truncated_shard_raises(self, tmp_path, codec, monkeypatch):
        monkeypatch.setattr(dataset_mod, "SLAB_BYTES", 512)
        recs = criteo_records(40, np.random.default_rng(0))
        raw = b"".join(jwire.encode_record(r) for r in recs)[:-3]
        name = "part-0.tfrecord" + (".gz" if codec else "")
        (tmp_path / name).write_bytes(gzip.compress(raw) if codec else raw)
        ds = TDataset(str(tmp_path), batch_size=8, schema=criteo_schema(tschema), **CRITEO_KW)
        with pytest.raises(twire.TFRecordCorruptionError, match="truncated"):
            read_all(ds)

    def test_null_in_non_nullable_column_reaches_consumer(self, tmp_path):
        recs = [encode_example(Example(features={"label": Feature.int64_list([1])}))] * 5
        recs.append(encode_example(Example()))
        jwire.write_records(str(tmp_path / "part-0.tfrecord"), recs)
        schema = tschema.StructType([tschema.StructField("label", tschema.LongType(),
                                                         nullable=False)])
        with pytest.raises(NullValueError):
            read_all(TDataset(str(tmp_path), batch_size=2, schema=schema))

    def test_group_views_outlive_dataset_and_iterator(self, datasets):
        ds = TDataset(datasets[("criteo", False)], batch_size=700,
                      schema=criteo_schema(tschema), **CRITEO_KW)
        it = ds.batches()
        batch = next(it)
        dense = batch["dense"].values
        want = dense.copy()
        owner = dense
        while owner is not None and not isinstance(owner, tnative._NativeResult):
            base = getattr(owner, "base", None)
            owner = base if base is not None else getattr(owner, "_owner", None)
        assert isinstance(owner, tnative._NativeResult), "aligned batch is not zero-copy"
        tensor = torch.from_numpy(dense)
        it.close()
        del ds, it, batch, dense, owner
        gc.collect()
        assert np.array_equal(tensor.numpy(), want)

    def test_bad_arguments_raise(self, datasets):
        path = datasets[("criteo", False)]
        schema = criteo_schema(tschema)
        with pytest.raises(ValueError, match="decoder"):
            TDataset(path, batch_size=8, schema=schema, decoder="fast")
        with pytest.raises(ValueError, match="num_epochs"):
            TDataset(path, batch_size=8, schema=schema, num_epochs=0)
        with pytest.raises(ValueError, match="hash_buckets"):
            TDataset(path, batch_size=8, schema=schema, decoder="python", pack={"g": ["C0"]})
