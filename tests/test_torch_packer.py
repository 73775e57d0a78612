"""The port's ``TokenPacker`` (``tpu_tfrecord_torch.device.ingest``) against
the JAX package's on the same ragged documents from a seed: in every mode
the popped batches are bit-equal and ``density()`` equal; ``state()``
gives the same JSON, and a carry saved by either side restores in the
other and continues bit-equal; ``feed_column`` equals ``feed_docs``; and
the bench's ``pack_density`` shape."""

import json

import numpy as np
import pytest

from tpu_tfrecord.tpu.ingest import TokenPacker as JPacker

from tpu_tfrecord_torch.columnar import Column
from tpu_tfrecord_torch.device.ingest import TokenPacker as TPacker
from tpu_tfrecord_torch.schema import ArrayType, LongType

MODES = ["slice", "first_fit", "best_fit"]
B, L = 3, 8


def docs(seed, n=40):
    """Ragged documents, some longer than L+1 (the bin modes split them)."""
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 50, size=int(k)).astype(np.int64)
            for k in rng.choice([1, 2, 5, 9, 10, 14, 23], size=n)]


def drain(pk):
    out = []
    while (b := pk.pop()) is not None:
        out.append(b)
    return out


def assert_batches_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, dict):
            assert sorted(g) == sorted(w)
            for k in w:
                assert g[k].dtype == w[k].dtype == np.int32
                np.testing.assert_array_equal(g[k], w[k])
        else:
            assert g.dtype == w.dtype == np.int32 and g.shape == (B, L + 1)
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("mode", MODES)
def test_batches_and_density_equal_jax(mode):
    jp, tp = JPacker(B, L, eos_id=0, packing=mode), TPacker(B, L, eos_id=0, packing=mode)
    got, want = [], []
    for part in range(3):
        d = docs(part)
        jp.feed_docs(d)
        tp.feed_docs(d)
        got += drain(tp)
        want += drain(jp)
    assert want, "the documents filled no batch"
    assert_batches_equal(got, want)
    assert tp.density() == jp.density()
    if mode == "slice":
        assert tp.density() == 1.0
    else:
        assert tp.density() < 1.0


@pytest.mark.parametrize("mode", MODES)
def test_state_json_equal_and_restores_across(mode):
    jp, tp = JPacker(B, L, packing=mode), TPacker(B, L, packing=mode)
    d = docs(7, n=23)
    jp.feed_docs(d)
    tp.feed_docs(d)
    tp.pop()
    jp.pop()  # leave pending batches and a carry
    jstate, tstate = jp.state(), tp.state()
    assert json.dumps(tstate) == json.dumps(jstate)
    # each side's carry into the other, then the same documents on both
    rest = docs(8, n=30)
    j2, t2 = JPacker(B, L, packing=mode), TPacker(B, L, packing=mode)
    t2.restore(json.loads(json.dumps(jstate)))
    j2.restore(json.loads(json.dumps(tstate)))
    for pk in (jp, tp, j2, t2):
        pk.feed_docs(rest)
    want = drain(jp)
    assert_batches_equal(drain(t2), want)
    assert_batches_equal(drain(j2), want)
    assert_batches_equal(drain(tp), want)
    assert t2.density() == j2.density() == jp.density()


@pytest.mark.parametrize("mode", MODES)
def test_feed_column_equals_feed_docs(mode):
    d = docs(3)
    offsets = np.concatenate([[0], np.cumsum([len(x) for x in d])]).astype(np.int64)
    col = Column("tokens", ArrayType(LongType()), values=np.concatenate(d), offsets=offsets)
    a, b = TPacker(B, L, packing=mode), TPacker(B, L, packing=mode)
    a.feed_column(col)
    b.feed_docs(d)
    assert_batches_equal(drain(a), drain(b))
    assert a.state() == b.state()


def test_bench_pack_density_shape():
    """bench.py's probe: B=4, L=32, best_fit, 300 documents of ones."""
    def run(cls):
        rng = np.random.default_rng(15)
        pk = cls(4, 32, packing="best_fit")
        pk.feed_docs(np.ones(int(s), np.int32)
                     for s in rng.choice([2, 6, 10, 15, 16, 21, 25, 31], size=300))
        return drain(pk), pk.density()

    got, got_density = run(TPacker)
    want, want_density = run(JPacker)
    assert got and all(g["tokens"].shape == (4, 33) for g in got)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["tokens"], w["tokens"])
        np.testing.assert_array_equal(g["segment_ids"], w["segment_ids"])
    assert got_density == want_density


def test_bad_arguments_raise():
    with pytest.raises(ValueError, match="packing"):
        TPacker(2, 4, packing="next_fit")
    with pytest.raises(ValueError, match=">= 1"):
        TPacker(0, 4)
