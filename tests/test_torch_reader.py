"""The port's read side against the JAX package's: the native
``InferScanner``, schema inference over every file at num_workers 1-4,
``infer_sample_limit``, the tolerant reads (``on_corrupt`` skip_record and
skip_shard, the quota and its fallback) with the same rows and the same
counters, and ``TFRecordDataset`` over a partitioned directory: the
batches of the JAX dataset, partition columns included, at num_workers
1-4, shuffled and not, with and without ``columns=``. Before the
data-source slice the port dropped those columns."""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import tpu_tfrecord.io as jio  # noqa: E402
from tpu_tfrecord import _native as jnative, schema as jschema, wire as jwire  # noqa: E402
from tpu_tfrecord.io.dataset import TFRecordDataset as JDataset  # noqa: E402
from tpu_tfrecord.metrics import METRICS as JMETRICS  # noqa: E402
from tpu_tfrecord.proto import (  # noqa: E402
    Example,
    Feature,
    FeatureList,
    SequenceExample,
    encode_example,
    encode_sequence_example,
)

import tpu_tfrecord_torch.io as tio  # noqa: E402
from tpu_tfrecord_torch import _native as tnative, schema as tschema, wire as twire  # noqa: E402
from tpu_tfrecord_torch.infer import SchemaInferenceError  # noqa: E402
from tpu_tfrecord_torch.io.dataset import TFRecordDataset as TDataset  # noqa: E402
from tpu_tfrecord_torch.metrics import METRICS as TMETRICS  # noqa: E402

from test_torch_dataset import assert_batches_equal, read_all  # noqa: E402


def example_records(n, rng, kinds=("i", "f", "s", "vi", "vf", "vs")):
    out = []
    for k in range(n):
        feats = {}
        if "i" in kinds and rng.random() > 0.2:
            feats["i"] = Feature.int64_list([int(rng.integers(-99, 99))])
        if "f" in kinds and rng.random() > 0.2:
            feats["f"] = Feature.float_list([float(rng.normal())])
        if "s" in kinds:
            feats["s"] = Feature.bytes_list([b"s%d" % k])
        if "vi" in kinds:
            feats["vi"] = Feature.int64_list([int(v) for v in rng.integers(0, 9, size=k % 4)])
        if "vf" in kinds and k % 2:
            feats["vf"] = Feature.float_list(rng.normal(size=k % 5 + 1).tolist())
        if "vs" in kinds:
            feats["vs"] = Feature.bytes_list([b"t"] * (k % 3 + 1))
        out.append(encode_example(Example(features=feats)))
    return out


def seq_records(n, rng):
    out = []
    for k in range(n):
        ctx = {"label": Feature.int64_list([k]), "c": Feature.bytes_list([b"c"])}
        fl = {"frames": FeatureList([Feature.float_list(rng.normal(size=int(m)).tolist())
                                     for m in rng.integers(1, 4, size=k % 4)]),
              "ids": FeatureList([Feature.int64_list([int(m)]) for m in range(k % 3)])}
        out.append(encode_sequence_example(SequenceExample(context=ctx, feature_lists=fl)))
    return out


# ---------------------------------------------------------------------------
# InferScanner
# ---------------------------------------------------------------------------


def _spans(recs):
    buf = b"".join(twire.encode_record(r) for r in recs)
    offs, lens, _ = tnative.scan_partial(buf)
    return buf, offs, lens


@pytest.mark.parametrize("batches", [1, 3])
@pytest.mark.parametrize("kind", ["Example", "SequenceExample"])
def test_infer_scanner_matches_jax(kind, batches):
    rng = np.random.default_rng(3)
    recs = example_records(120, rng) if kind == "Example" else seq_records(120, rng)
    maps = []
    for native in (tnative, jnative):
        with native.InferScanner(kind) as sc:
            for part in np.array_split(np.arange(len(recs)), batches):
                sc.update(*_spans([recs[i] for i in part]))
            maps.append((sc.result(), sc.records))
    assert maps[0] == maps[1] and maps[0][1] == 120


def test_infer_scanner_empty_and_byte_array():
    with tnative.InferScanner("Example") as sc:
        assert sc.result() == {}
    with pytest.raises(ValueError):
        tnative.InferScanner("ByteArray")


def test_infer_scanner_rejects_like_jax():
    bad = [b"\x0a\x05garbage"]
    errs = []
    for native in (tnative, jnative):
        with native.InferScanner("Example") as sc:
            with pytest.raises(ValueError) as e:
                sc.update(*_spans(bad))
            errs.append(type(e.value).__name__)
    assert errs[0] == errs[1]
    assert issubclass(SchemaInferenceError, ValueError)


# ---------------------------------------------------------------------------
# schema inference over files
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def hetero(tmp_path_factory):
    """Five shards whose types differ, so the merge order matters; one is
    empty and one is gzip."""
    d = tmp_path_factory.mktemp("hetero")
    rng = np.random.default_rng(11)
    kinds = [("i", "s"), ("f", "vi"), ("i", "vf", "vs"), (), ("s", "vs", "f")]
    for n, ks in enumerate(kinds):
        recs = example_records(0 if not ks else 200, rng, ks)
        ext = ".gz" if n == 2 else ""
        jwire.write_records(str(d / f"part-{n:05d}.tfrecord{ext}"), recs,
                            codec="gzip" if ext else None)
    return str(d)


@pytest.mark.parametrize("workers", [1, 2, 3, 4])
def test_infer_schema_all_files_matches_jax(hetero, workers):
    t, j = tio.reader(hetero), jio.reader(hetero)
    assert t.infer_schema_all_files(num_workers=workers).to_json() == \
        j.infer_schema_all_files(num_workers=workers).to_json()
    assert t.local_type_map(num_workers=workers) == {
        k: (None if v is None else tschema.StructType.from_json(
            jschema.StructType([jschema.StructField("x", v)]).to_json())["x"].data_type)
        for k, v in j.local_type_map(num_workers=workers).items()}
    assert t.schema().to_json() == j.schema().to_json()


@pytest.mark.parametrize("workers", [1, 4])
def test_local_type_map_of_a_subset(hetero, workers):
    t, j = tio.reader(hetero), jio.reader(hetero)
    want = j.local_type_map(j.shards[1:3], num_workers=workers)
    got = t.local_type_map(t.shards[1:3], num_workers=workers)
    assert sorted(got) == sorted(want)


def _corrupt_after(path, recs, good):
    """A shard whose first ``good`` frames are valid and the rest corrupt."""
    frames = [twire.encode_record(r) for r in recs]
    blob = bytearray(b"".join(frames))
    at = sum(len(f) for f in frames[:good]) + twire.HEADER_BYTES + 1
    blob[at] ^= 0xFF
    with open(path, "wb") as fh:
        fh.write(bytes(blob))


@pytest.mark.parametrize("limit", [None, 5, 10, 11])
def test_infer_sample_limit_matches_jax(tmp_path, limit):
    """Bytes past the sampled records are never CRC-checked: a corruption
    after the limit does not fail inference, one inside it does."""
    rng = np.random.default_rng(5)
    _corrupt_after(str(tmp_path / "part-0.tfrecord"), example_records(40, rng), good=10)
    kw = {} if limit is None else {"infer_sample_limit": limit}
    out = []
    for io_mod in (jio, tio):
        try:
            out.append(io_mod.reader(str(tmp_path), **kw).schema().to_json())
        except Exception as e:
            out.append(type(e).__name__)
    assert out[0] == out[1]
    assert (out[1] == "TFRecordCorruptionError") == (limit is None or limit > 10)


# ---------------------------------------------------------------------------
# tolerant reads
# ---------------------------------------------------------------------------

COUNTERS = ("read.corrupt_records", "read.resyncs", "read.skipped_shards")


@pytest.fixture(scope="module")
def corrupt_ds(tmp_path_factory):
    """Three uid shards: clean, one with frames 5 and 12 corrupt (a length
    CRC and a data CRC), one truncated mid-frame."""
    d = tmp_path_factory.mktemp("corrupt")
    ser = tschema.StructType([tschema.StructField("uid", tschema.LongType(), nullable=False)])
    from tpu_tfrecord_torch.options import RecordType
    from tpu_tfrecord_torch.serde import TFRecordSerializer, encode_row

    s = TFRecordSerializer(ser)
    for n in range(3):
        frames = [twire.encode_record(encode_row(s, RecordType.EXAMPLE, [100 * n + i]))
                  for i in range(30)]
        offs = np.cumsum([0] + [len(f) for f in frames])
        blob = bytearray(b"".join(frames))
        if n == 1:
            blob[offs[5] + 9] ^= 0xFF  # length CRC
            blob[offs[12] + twire.HEADER_BYTES + 1] ^= 0xFF  # data CRC
        if n == 2:
            blob = blob[: offs[20] + 7]
        with open(d / f"part-{n}.tfrecord", "wb") as fh:
            fh.write(bytes(blob))
    return str(d)


def _read_counted(io_mod, metrics, path, **kw):
    before = [metrics.counter(c) for c in COUNTERS]
    try:
        rows = [r[0] for r in io_mod.read(path, **kw).rows]
    except Exception as e:
        rows = type(e).__name__
    return rows, [metrics.counter(c) - b for c, b in zip(COUNTERS, before)]


POLICIES = [
    dict(),
    dict(on_corrupt="skip_record"),
    dict(on_corrupt="skip_shard"),
    dict(on_corrupt="skip_record", max_corrupt_records=1),
    dict(on_corrupt="skip_record", max_corrupt_records=1, corrupt_fallback="skip_shard"),
    dict(on_corrupt="skip_record", max_corrupt_records=None),
]


@pytest.mark.parametrize("policy", POLICIES, ids=lambda p: ",".join(f"{k}={v}" for k, v in p.items()) or "raise")
@pytest.mark.parametrize("schema_given", [True, False])
def test_tolerant_reads_match_jax(corrupt_ds, policy, schema_given):
    kw = dict(policy)
    if schema_given:
        js = jschema.StructType([jschema.StructField("uid", jschema.LongType(), nullable=False)])
        ts = tschema.StructType([tschema.StructField("uid", tschema.LongType(), nullable=False)])
    j = _read_counted(jio, JMETRICS, corrupt_ds, **kw, **({"schema": js} if schema_given else {}))
    t = _read_counted(tio, TMETRICS, corrupt_ds, **kw, **({"schema": ts} if schema_given else {}))
    assert t == j
    if policy.get("on_corrupt") == "skip_record" and policy.get("max_corrupt_records", 100) != 1:
        assert t[0] == list(range(30)) + [100 + i for i in range(30) if i not in (5, 12)] + \
            [200 + i for i in range(20)]


def test_salvage_events_are_logged(corrupt_ds, caplog):
    with caplog.at_level("WARNING", logger="tpu_tfrecord_torch"):
        tio.read(corrupt_ds, on_corrupt="skip_record")
    kinds = [r.getMessage() for r in caplog.records if "tfrecord.salvage" in r.getMessage()]
    assert len(kinds) == 3 and '"kind": "length_crc"' in kinds[0]


def test_dataset_refuses_tolerant_policies(corrupt_ds):
    """The dataset refuses an unknown policy; the tolerant ones it has
    (since the resume slice) and reads the rows the JAX dataset reads."""
    with pytest.raises(ValueError, match="on_corrupt"):
        TDataset(corrupt_ds, 4, on_corrupt="skip_some")
    for policy in ("skip_record", "skip_shard"):
        want = [b["uid"].values.tolist() for b in JDataset(
            corrupt_ds, 4, drop_remainder=False, on_corrupt=policy).batches()]
        with TDataset(corrupt_ds, 4, drop_remainder=False, on_corrupt=policy).batches() as it:
            assert [b["uid"].values.tolist() for b in it] == want


# ---------------------------------------------------------------------------
# TFRecordDataset over a partitioned directory
# ---------------------------------------------------------------------------

PART_SPEC = [("uid", "LongType"), ("x", "FloatType"), ("c", "StringType"),
             ("day", "StringType"), ("hour", "LongType"), ("rate", "DoubleType")]


def _part_schema(mod):
    return mod.StructType([mod.StructField(n, getattr(mod, t)()) for n, t in PART_SPEC])


@pytest.fixture(scope="module")
def partitioned(tmp_path_factory):
    """2,000 rows under day=<str>/hour=<long>/rate=<double> directories,
    one null day (the Hive default partition), written by the JAX writer."""
    d = str(tmp_path_factory.mktemp("parts") / "ds")
    rng = np.random.default_rng(2)
    rows = []
    for i in range(2000):
        day = [None, "2026-01-01", "2026-01-02"][int(rng.integers(0, 3))]
        rows.append([i, float(np.float32(rng.normal())), f"c{int(rng.integers(0, 9))}", day,
                     int(rng.integers(0, 3)), [0.5, 1.5][i % 2]])
    jio.write(rows, _part_schema(jschema), d, partition_by=["day", "hour", "rate"])
    return d


DS_CASES = [
    # (num_workers, shuffle, shuffle_window, columns)
    (1, False, 0, None),
    (2, False, 0, None),
    (3, True, 0, None),
    (4, True, 2, None),
    (1, True, 2, ["hour", "c", "day"]),
    (4, False, 0, ["rate", "uid"]),
    (2, True, 0, ["x"]),
]


@pytest.mark.parametrize("workers,shuffle,window,columns", DS_CASES)
def test_partitioned_dataset_batches_match_jax(partitioned, workers, shuffle, window, columns):
    kw = dict(batch_size=96, drop_remainder=False, num_epochs=2, num_workers=workers,
              shuffle=shuffle, shuffle_window=window, seed=3, columns=columns,
              hash_buckets={"c": 13} if columns is None or "c" in columns else None)
    jds, tds = JDataset(partitioned, **kw), TDataset(partitioned, **kw)
    assert tds.schema.to_json() == jds.schema.to_json()
    want, got = read_all(jds), read_all(tds)
    assert len(got) == len(want) > 20
    for a, b in zip(got, want):
        assert_batches_equal(a, b)
    names = columns or [n for n, _ in PART_SPEC]
    assert sorted(got[0].columns) == sorted(names)


def test_partition_columns_are_typed_and_constant_per_shard(partitioned):
    tds = TDataset(partitioned, batch_size=4000, drop_remainder=False)
    assert [(f.name, type(f.data_type).__name__) for f in tds.schema][-3:] == [
        ("day", "StringType"), ("hour", "LongType"), ("rate", "DoubleType")]
    (cb,) = read_all(tds)
    day = cb["day"]
    assert (~day.mask).sum() > 0  # the null day
    uid = cb["uid"].values
    assert sorted(uid.tolist()) == list(range(2000))
    assert set(cb["rate"].values.tolist()) == {0.5, 1.5}


@pytest.mark.parametrize("pack", [False, True])
def test_partitioned_dataset_options_and_pack(partitioned, pack):
    kw = dict(batch_size=500, drop_remainder=False, verify_crc=False)
    if pack:
        kw.update(columns=["uid", "hour", "x"], pack={"ids": ["uid"]})
    jds, tds = JDataset(partitioned, **kw), TDataset(partitioned, **kw)
    assert not tds.options.verify_crc
    for a, b in zip(read_all(tds), read_all(jds)):
        assert_batches_equal(a, b)


def test_dataset_options_object(partitioned):
    from tpu_tfrecord_torch.options import TFRecordOptions

    opts = TFRecordOptions.from_map(infer_sample_limit=3)
    tds = TDataset(partitioned, 100, options=opts)
    assert tds.options is opts or tds.options == opts
    with pytest.raises(ValueError, match="either"):
        TDataset(partitioned, 100, options=opts, recordType="SequenceExample")
