"""The entry points over the feed on the CPU: ``train_files`` with two decode
workers, with and without the transfer thread, and with the bit-packed wire
(``wire_bits=20``), against a JAX training loop (JAX ``TFRecordDataset`` ->
``host_batch_from_columnar`` -> jitted step) over the same shuffled shards
(losses: f32, rtol 1e-5); ``score_files`` over the same feeds against its
default feed, bit for bit; the wire's argument checks."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

torch.set_num_threads(1)

from tpu_tfrecord import schema as jschema, wire as jwire  # noqa: E402
from tpu_tfrecord.io.dataset import TFRecordDataset as JDataset  # noqa: E402
from tpu_tfrecord.models import dlrm as jdlrm  # noqa: E402
from tpu_tfrecord.proto import Example, Feature, encode_example  # noqa: E402
from tpu_tfrecord.tpu.ingest import host_batch_from_columnar as j_hbfc  # noqa: E402

from tpu_tfrecord_torch import interop, schema as tschema  # noqa: E402
from tpu_tfrecord_torch.entry import score_files, train_files  # noqa: E402
from tpu_tfrecord_torch.models import dlrm as tdlrm  # noqa: E402

NUM_DENSE, NUM_CAT, VOCAB = 4, 3, 64
BATCH = 16
SHARD_ROWS = [40, 0, 31, 25]
READ = dict(shuffle=True, shuffle_window=2, seed=1, num_epochs=2)
STEPS = 2 * sum(SHARD_ROWS) // BATCH  # 12
MODEL_KW = dict(num_dense=NUM_DENSE, num_categorical=NUM_CAT, vocab_size=VOCAB, embed_dim=4,
                bottom_mlp=(8, 4), top_mlp=(8, 1), interaction="dot")
FEEDS = {
    "dispatch_ahead": dict(num_workers=2),
    "transfer_thread": dict(num_workers=2, transfer_thread=True),
    "wire": dict(num_workers=2, wire_bits=20),
    "wire_thread": dict(num_workers=3, transfer_thread=True, wire_bits=20),
}


def _schema(mod):
    """int32 label and dense columns: the wire carries them in int32 lanes."""
    return mod.StructType(
        [mod.StructField("label", mod.IntegerType(), nullable=False)]
        + [mod.StructField(f"d{i}", mod.IntegerType()) for i in range(1, NUM_DENSE + 1)]
        + [mod.StructField(f"c{i}", mod.StringType()) for i in range(1, NUM_CAT + 1)]
    )


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_train_feed")
    rng = np.random.default_rng(8)
    for s, n in enumerate(SHARD_ROWS):
        recs = []
        for _ in range(n):
            feats = {"label": Feature.int64_list([int(rng.integers(0, 2))])}
            for i in range(1, NUM_DENSE + 1):
                feats[f"d{i}"] = Feature.int64_list([int(rng.integers(-5, 100000))])
            for i in range(1, NUM_CAT + 1):
                feats[f"c{i}"] = Feature.bytes_list([b"v%d" % rng.integers(0, 50)])
            recs.append(encode_example(Example(features=feats)))
        jwire.write_records(str(d / f"part-{s:05d}.tfrecord"), recs)
    return str(d)


def _params():
    jcfg = jdlrm.DLRMConfig(dtype=jnp.float32, **MODEL_KW)
    return jcfg, jax.tree.map(np.asarray, jdlrm.init_params(jax.random.key(3), jcfg))


@functools.lru_cache(maxsize=None)
def _jax_run(data_dir, sparse):
    jcfg, params = _params()
    hash_buckets = {f"c{i}": VOCAB for i in range(1, NUM_CAT + 1)}
    pack = {"dense": [f"d{i}" for i in range(1, NUM_DENSE + 1)],
            "cat": [f"c{i}" for i in range(1, NUM_CAT + 1)]}
    ds = JDataset(data_dir, batch_size=BATCH, schema=_schema(jschema), hash_buckets=hash_buckets,
                  pack=pack, **READ)
    tx = optax.adam(1e-3)
    if sparse:
        state = jdlrm.sparse_opt_init(params, jcfg, tx)
        step = jax.jit(functools.partial(jdlrm.sparse_train_step, cfg=jcfg, tx=tx))
    else:
        state = tx.init(params)
        step = jax.jit(functools.partial(jdlrm.train_step, cfg=jcfg, tx=tx))
    losses = []
    with ds.batches() as it:
        for cb in it:
            hb = j_hbfc(cb, ds.schema, hash_buckets=hash_buckets, pack=pack)
            hb["dense"] = np.log1p(hb["dense"].clip(min=0)).astype(np.float32)
            hb["label"] = hb["label"].astype(np.float32)
            params, state, loss = step(params, state, {k: jnp.asarray(v) for k, v in hb.items()})
            losses.append(float(loss))
    return np.array(losses), jax.tree.map(np.asarray, params)


def _port_model():
    jcfg, params = _params()
    tcfg = tdlrm.DLRMConfig(dtype=torch.float32, **MODEL_KW)
    return tcfg, interop.dlrm_params_from_jax(params, tcfg, device="cpu")


@pytest.mark.parametrize("sparse", [True, False], ids=["sparse", "dense"])
@pytest.mark.parametrize("feed", sorted(FEEDS))
def test_train_files_over_the_feed_matches_jax_steps(data_dir, feed, sparse):
    want, jparams = _jax_run(data_dir, sparse)
    tcfg, model = _port_model()
    res = train_files(data_dir, tcfg, model, BATCH, device="cpu", sparse=sparse,
                      recordType="Example", schema=_schema(tschema), **READ, **FEEDS[feed])
    assert res.steps == len(want) == STEPS >= 6
    assert len(res.host_s) == len(res.h2d_s) == len(res.step_s) == len(res.done_s) == res.steps
    assert all(0 <= h <= w for h, w in zip(res.h2d_s, res.host_s))
    assert res.done_s == sorted(res.done_s) and res.done_s[-1] <= res.wall_s
    assert 0 < res.duty_cycle <= 1
    assert torch.isfinite(res.losses).all()
    np.testing.assert_allclose(res.losses.numpy()[:6], want[:6], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(res.losses.numpy(), want, rtol=1e-5, atol=1e-6)
    got = interop.dlrm_params_to_jax(model)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(jparams)):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)


def test_wire_batch_reaches_the_step_as_the_host_path_gives_it(data_dir):
    """Label, cat bit-equal and dense within an ulp of the host path's."""
    seen = {}
    real = tdlrm.loss_fn

    def spy(key):
        def loss(m, batch, emb=None):
            seen.setdefault(key, []).append({k: v.clone() for k, v in batch.items()})
            return real(m, batch, emb=emb)
        return loss

    for key, kw in (("host", {}), ("wire", dict(wire_bits=20))):
        tcfg, model = _port_model()
        tdlrm.loss_fn = spy(key)
        try:
            train_files(data_dir, tcfg, model, BATCH, device="cpu", sparse=False,
                        recordType="Example", schema=_schema(tschema), **READ, **kw)
        finally:
            tdlrm.loss_fn = real
    assert len(seen["host"]) == len(seen["wire"]) == STEPS
    for h, w in zip(seen["host"], seen["wire"]):
        assert sorted(h) == sorted(w) == ["cat", "dense", "label"]
        assert torch.equal(h["label"], w["label"]) and w["label"].dtype == torch.float32
        assert torch.equal(h["cat"], w["cat"]) and w["cat"].dtype == h["cat"].dtype
        assert w["dense"].dtype == torch.float32
        torch.testing.assert_close(w["dense"], h["dense"], rtol=1.2e-7, atol=0)


@pytest.mark.parametrize("feed", [dict(num_workers=2), dict(num_workers=3, transfer_thread=True)])
def test_score_files_over_the_feed_bit_equal(data_dir, feed):
    tcfg, model = _port_model()
    kw = dict(recordType="Example", schema=_schema(tschema), log1p_dense=True, num_epochs=3)
    want = score_files(data_dir, tcfg, model, BATCH, device="cpu", **kw)
    got = score_files(data_dir, tcfg, model, BATCH, device="cpu", **kw, **feed)
    assert got.batches == want.batches == 3 * sum(SHARD_ROWS) // BATCH
    assert torch.equal(got.logits, want.logits)
    assert 0 < got.duty_cycle <= 1 and 0 < want.duty_cycle <= 1


def test_wire_refuses_what_it_cannot_carry(data_dir, tmp_path):
    tcfg, model = _port_model()
    kw = dict(recordType="Example", device="cpu")
    long_schema = tschema.StructType(
        [tschema.StructField("label", tschema.IntegerType(), nullable=False)]
        + [tschema.StructField(f"d{i}", tschema.LongType()) for i in range(1, NUM_DENSE + 1)]
        + [tschema.StructField(f"c{i}", tschema.StringType()) for i in range(1, NUM_CAT + 1)]
    )
    with pytest.raises(ValueError, match="'d1' is .*not IntegerType"):
        train_files(data_dir, tcfg, model, BATCH, schema=long_schema, wire_bits=20, **kw)
    with pytest.raises(ValueError, match="not IntegerType"):  # inferred: int64 columns
        train_files(data_dir, tcfg, model, BATCH, wire_bits=20, **kw)
    with pytest.raises(ValueError, match="vocab_size=64"):
        train_files(data_dir, tcfg, model, BATCH, schema=_schema(tschema), wire_bits=5, **kw)
