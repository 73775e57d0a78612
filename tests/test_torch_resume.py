"""The port's resume position against the JAX dataset's, bit for bit.

For each configuration (unshuffled; shard-order shuffle; windowed row
shuffle with states taken mid-window; 1 and 3 decode workers; batch sizes
that divide no shard; several epochs; gzip shards; a partitioned root;
``drop_remainder=False``): the port's ``state().to_json()`` after every
batch and its ``fingerprint()`` equal the JAX dataset's; from a state the
JAX iterator saved, the port yields the JAX stream's remaining batches,
and from the port's state the JAX dataset yields the port's. States cross
the packages as JSON, as a checkpoint carries them. Then the identity
guard, and ``on_corrupt`` (``skip_record``, ``skip_shard``, the quota
fallback) pinned against the JAX dataset: batches, positions and the
``read.*`` counters, and a resume inside a corrupt shard."""

import os

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import tpu_tfrecord.io as jio  # noqa: E402
from tpu_tfrecord import schema as jschema, wire as jwire  # noqa: E402
from tpu_tfrecord.io.dataset import IteratorState as JState  # noqa: E402
from tpu_tfrecord.io.dataset import TFRecordDataset as JDataset  # noqa: E402
from tpu_tfrecord.metrics import METRICS as JMETRICS  # noqa: E402
from tpu_tfrecord.proto import Example, Feature, encode_example  # noqa: E402

from tpu_tfrecord_torch import schema as tschema  # noqa: E402
from tpu_tfrecord_torch.io.dataset import IteratorState as TState  # noqa: E402
from tpu_tfrecord_torch.io.dataset import TFRecordDataset as TDataset  # noqa: E402
from tpu_tfrecord_torch.metrics import METRICS as TMETRICS  # noqa: E402

from test_torch_dataset import (  # noqa: E402
    CRITEO_KW,
    assert_batches_equal,
    criteo_records,
    criteo_schema,
)

SHARD_ROWS = [130, 0, 257, 61, 95]  # one empty shard
BATCH = 70                          # divides no shard and no total


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """{name: (root, schema kwargs)}: plain shards, the same shards with two
    gzipped, and a partitioned root, all written by the JAX package."""
    base = tmp_path_factory.mktemp("torch_resume")
    rng = np.random.default_rng(17)
    shards = [criteo_records(n, rng) for n in SHARD_ROWS]
    out = {}
    for name, gz in (("plain", ()), ("gzip", (2, 4))):
        d = base / name
        d.mkdir()
        for i, recs in enumerate(shards):
            ext = ".gz" if i in gz else ""
            jwire.write_records(str(d / f"part-{i:05d}.tfrecord{ext}"), recs,
                                codec="gzip" if ext else None)
        out[name] = (str(d), dict(CRITEO_KW))
    fields = [("uid", "LongType"), ("x", "FloatType"), ("c", "StringType"), ("day", "StringType")]
    js = jschema.StructType([jschema.StructField(n, getattr(jschema, t)()) for n, t in fields])
    rows = [[i, float(i) / 7, f"c{i % 11}", f"d{i % 3}"] for i in range(700)]
    part = str(base / "partitioned")
    jio.write(rows, js, part, mode="overwrite", partition_by=["day"])
    out["partitioned"] = (part, dict(recordType="Example", hash_buckets={"c": 13}))
    return out


def _schemas(name):
    if name == "partitioned":
        return {}, {}
    return {"schema": criteo_schema(jschema)}, {"schema": criteo_schema(tschema)}


def _read(ds, state=None):
    """[(batch, state)] of a whole run from ``state``."""
    with ds.batches(state) as it:
        return [(b, it.state()) for b in it]


def _same_stream(got, want):
    assert len(got) == len(want)
    for (a, sa), (b, sb) in zip(got, want):
        assert_batches_equal(a, b)
        assert sa.to_json() == sb.to_json()


CONFIGS = {
    "unshuffled": dict(),
    "shuffle": dict(shuffle=True, seed=3),
    "window3": dict(shuffle=True, shuffle_window=3, seed=5),
    "window3_workers3": dict(shuffle=True, shuffle_window=3, seed=4, num_workers=3),
    "workers3": dict(shuffle=True, seed=2, num_workers=3),
    "epochs3_remainder": dict(shuffle=True, seed=7, num_epochs=3, drop_remainder=False),
    "window2_epochs2_remainder": dict(shuffle_window=2, seed=9, num_epochs=2,
                                      drop_remainder=False),
}
CASES = [(root, cfg) for root in ("plain", "gzip", "partitioned") for cfg in CONFIGS
         if root == "plain" or cfg in ("window3", "workers3", "epochs3_remainder")]


@pytest.mark.parametrize("root,config", CASES)
def test_resume_matches_jax(roots, root, config):
    path, kw = roots[root]
    js, ts = _schemas(root)
    kw = dict(kw, batch_size=BATCH, **CONFIGS[config])
    jds, tds = JDataset(path, **js, **kw), TDataset(path, **ts, **kw)
    assert tds.fingerprint() == jds.fingerprint()
    want, got = _read(jds), _read(tds)
    _same_stream(got, want)
    n = len(want)
    assert n >= 6
    mid_window = [k for k, (_, s) in enumerate(want, 1) if s.window_emitted]
    if kw.get("shuffle_window"):
        assert mid_window
    for k in sorted({1, n // 2, n - 1} | set(mid_window[:2])):
        # the JAX iterator's state, through JSON, resumes the port ...
        jstate = TState.from_json(want[k - 1][1].to_json())
        _same_stream(_read(TDataset(path, **ts, **kw), jstate), want[k:])
        # ... and the port's resumes the JAX dataset
        tstate = JState.from_json(got[k - 1][1].to_json())
        _same_stream(_read(JDataset(path, **js, **kw), tstate), got[k:])


def test_state_after_last_batch_resumes_to_nothing(roots):
    path, kw = roots["plain"]
    _, ts = _schemas("plain")
    ds = TDataset(path, batch_size=BATCH, shuffle=True, shuffle_window=2, **ts, **kw)
    stream = _read(ds)
    assert _read(ds, stream[-1][1]) == []


# -- the identity guard ----------------------------------------------------------


def _state_after_one(path, **kw):
    with TDataset(path, batch_size=BATCH, **kw).batches() as it:
        next(it)
        return it.state()


@pytest.mark.parametrize("change", ["shard_list", "seed", "window"])
def test_mutated_dataset_rejected(roots, tmp_path, change):
    src, kw = roots["plain"]
    _, ts = _schemas("plain")
    kw = dict(kw, **ts)
    path = str(tmp_path / "ds")
    os.makedirs(path)
    for name in os.listdir(src):
        os.link(os.path.join(src, name), os.path.join(path, name))
    st = _state_after_one(path, shuffle=True, seed=1, shuffle_window=2, **kw)
    assert st.fingerprint is not None
    other = dict(shuffle=True, seed=1, shuffle_window=2)
    if change == "shard_list":
        jwire.write_records(os.path.join(path, "part-00009.tfrecord"),
                            criteo_records(5, np.random.default_rng(1)))
    elif change == "seed":
        other["seed"] = 2
    else:
        other["shuffle_window"] = 3
    ds = TDataset(path, batch_size=BATCH, **other, **kw)
    with pytest.raises(ValueError, match="fingerprint"):
        ds.batches(st)


def test_state_without_fingerprint_accepted(roots):
    path, kw = roots["plain"]
    _, ts = _schemas("plain")
    ds = TDataset(path, batch_size=BATCH, **ts, **kw)
    full = _read(ds)
    legacy = TState(epoch=0, shard_cursor=0, record_offset=BATCH)
    rest = _read(ds, legacy)
    _same_stream(rest, full[1:])


def test_state_json_round_trip_and_unknown_keys():
    st = TState(1, 2, 3, fingerprint="abc", window_emitted=4)
    assert TState.from_json(st.to_json()) == st
    assert TState.from_json(dict(st.to_json(), future_field=1)).fingerprint == "abc"
    assert JState(1, 2, 3, fingerprint="abc", window_emitted=4).to_json() == st.to_json()
    assert TState(1, 2, 3, fingerprint="x") == TState(1, 2, 3)  # fingerprint not compared


# -- on_corrupt ----------------------------------------------------------------------

COUNTERS = ("read.corrupt_records", "read.resyncs", "read.skipped_shards")


def _uid_records(lo, n):
    return [encode_example(Example(features={"uid": Feature.int64_list([i])}))
            for i in range(lo, lo + n)]


@pytest.fixture(scope="module")
def corrupt_root(tmp_path_factory):
    """Shards of uid records with corrupt frames: a length CRC and a data
    CRC in shard 1, a data CRC in the second decode chunk of the 3,000-record
    shard 2, a torn tail in shard 3, and two gzip shards whose TFRecord
    frames (inside a valid gzip stream) carry a bad data CRC, the second
    of 3,000 records with it in its second chunk."""
    d = tmp_path_factory.mktemp("torch_resume_corrupt")
    spec = [(0, 90, ()), (1000, 90, ((5, 9), (40, 13))), (2000, 3000, ((2500, 13),)),
            (6000, 80, ()), (7000, 90, ((30, 13),)), (9000, 3000, ((2600, 13),))]
    for i, (lo, n, flips) in enumerate(spec):
        frames = [jwire.encode_record(r) for r in _uid_records(lo, n)]
        offs = np.cumsum([0] + [len(f) for f in frames])
        blob = bytearray(b"".join(frames))
        for rec, byte in flips:
            blob[offs[rec] + byte] ^= 0xFF
        if i == 3:
            blob = blob[: offs[60] + 7]
        if i in (4, 5):
            import gzip

            (d / f"part-{i:05d}.tfrecord.gz").write_bytes(gzip.compress(bytes(blob), mtime=0))
        else:
            (d / f"part-{i:05d}.tfrecord").write_bytes(bytes(blob))
    return str(d)


POLICIES = {
    "skip_record": dict(on_corrupt="skip_record"),
    "skip_shard": dict(on_corrupt="skip_shard"),
    "quota_fallback": dict(on_corrupt="skip_record", max_corrupt_records=1,
                           corrupt_fallback="skip_shard"),
}


def _read_counted(metrics, ds, state=None):
    before = [metrics.counter(c) for c in COUNTERS]
    stream = _read(ds, state)
    return stream, [metrics.counter(c) - b for c, b in zip(COUNTERS, before)]


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("workers", [1, 3])
def test_tolerant_policies_match_jax_and_resume(corrupt_root, policy, workers):
    kw = dict(batch_size=64, drop_remainder=False, num_workers=workers, shuffle=True, seed=1,
              **POLICIES[policy])
    js = jschema.StructType([jschema.StructField("uid", jschema.LongType(), nullable=False)])
    ts = tschema.StructType([tschema.StructField("uid", tschema.LongType(), nullable=False)])
    want, jcounts = _read_counted(JMETRICS, JDataset(corrupt_root, schema=js, **kw))
    got, tcounts = _read_counted(TMETRICS, TDataset(corrupt_root, schema=ts, **kw))
    _same_stream(got, want)
    assert tcounts == jcounts and jcounts[0] > 0
    uids = np.concatenate([b["uid"].values for b, _ in got])
    if policy == "skip_record":
        bad = {1005, 1040, 4500, 7030, 11600}
        assert 1005 not in uids and 4500 not in uids and 4499 in uids and 4501 in uids
        assert set(uids) >= set(range(2000, 5000)) - bad
    if policy == "skip_shard":
        # a shard's chunks before its corrupt chunk stay: records 0-2047,
        # from the mmapped shard and from the gzip one
        assert set(uids) & set(range(2000, 5000)) == set(range(2000, 4048))
        assert set(uids) & set(range(9000, 12000)) == set(range(9000, 11048))
    # a resume from positions inside shards skips what the first pass
    # skipped (the salvage scan and the offsets are deterministic); under
    # skip_shard the chunks start at the offset, so the resume is held
    # against the JAX dataset's resume from the same position
    inside = [k for k in range(1, len(got)) if got[k - 1][1].record_offset]
    for k in inside[::7]:
        st = got[k - 1][1].to_json()
        rest = _read(TDataset(corrupt_root, schema=ts, **kw), TState.from_json(st))
        if policy != "skip_shard":
            _same_stream(rest, want[k:])
        else:
            _same_stream(rest, _read(JDataset(corrupt_root, schema=js, **kw), JState.from_json(st)))


def test_quota_exhausted_raises_by_default(corrupt_root):
    ds = TDataset(corrupt_root, batch_size=64, on_corrupt="skip_record", max_corrupt_records=1)
    from tpu_tfrecord_torch import wire as twire

    with pytest.raises(twire.TFRecordCorruptionError, match="max_corrupt_records"):
        _read(ds)
