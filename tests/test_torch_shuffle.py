"""The port's training read against the JAX package's on the CPU:
``take_rows`` on every column layout, ``TFRecordDataset`` batches with
shard-order and windowed row shuffling bit-identical to the JAX dataset's
(uneven shards, an empty shard, a batch size that divides no shard, two
epochs, both port decoders), and ``train_files`` against a JAX training
loop (JAX ``TFRecordDataset`` -> ``host_batch_from_columnar`` -> jitted
train step) over the same shards. Losses: f32, rtol 1e-5."""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

torch.set_num_threads(1)

from tpu_tfrecord import columnar as jcolumnar, schema as jschema, wire as jwire  # noqa: E402
from tpu_tfrecord.io.dataset import TFRecordDataset as JDataset  # noqa: E402
from tpu_tfrecord.models import dlrm as jdlrm  # noqa: E402
from tpu_tfrecord.proto import Example, Feature, encode_example  # noqa: E402
from tpu_tfrecord.tpu.ingest import host_batch_from_columnar as j_hbfc  # noqa: E402

from tpu_tfrecord_torch import interop, schema as tschema  # noqa: E402
from tpu_tfrecord_torch.columnar import take_rows  # noqa: E402
from tpu_tfrecord_torch.entry import train_files  # noqa: E402
from tpu_tfrecord_torch.io.dataset import TFRecordDataset as TDataset  # noqa: E402
from tpu_tfrecord_torch.models import dlrm as tdlrm  # noqa: E402

from test_torch_dataset import (  # noqa: E402
    CRITEO_KW,
    SEQ_KW,
    assert_batches_equal,
    criteo_records,
    criteo_schema,
    read_all,
    seq_records,
    seq_schema,
)

SHARD_ROWS = [70, 0, 250, 33]   # one empty shard
BATCH = 30                      # divides no shard and no total


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    """{kind: dir} of the uneven shards, written once through the JAX writer."""
    root = tmp_path_factory.mktemp("torch_shuffle")
    out = {}
    for kind, make in (("criteo", criteo_records), ("seq", seq_records)):
        rng = np.random.default_rng(11)
        d = root / kind
        d.mkdir()
        for i, n in enumerate(SHARD_ROWS):
            jwire.write_records(str(d / f"part-{i:05d}.tfrecord"), make(n, rng))
        out[kind] = str(d)
    return out


# -- take_rows -----------------------------------------------------------------


def _layout_batches(shards):
    """Decoded batches that hold every layout: packed group matrices,
    hashed scalar and multi-hot bytes, ragged floats, scalar ints and bytes
    with validity masks, ragged^2 floats and bytes."""
    crit = dict(batch_size=64, schema=criteo_schema(tschema))
    seq = dict(batch_size=64, schema=seq_schema(tschema))
    return {
        "packed_hashed": read_all(TDataset(shards["criteo"], **crit, **CRITEO_KW))[1],
        "raw_bytes": read_all(TDataset(shards["criteo"], recordType="Example", **crit))[1],
        "ragged2": read_all(TDataset(shards["seq"], **seq, **SEQ_KW))[1],
        "ragged2_python": read_all(TDataset(shards["seq"], decoder="python", **seq,
                                            **SEQ_KW))[1],
    }


@pytest.mark.parametrize("which", ["packed_hashed", "raw_bytes", "ragged2", "ragged2_python"])
def test_take_rows_matches_jax(shards, which):
    batch = _layout_batches(shards)[which]
    layouts = {("offsets" if c.offsets is not None else "scalar")
               + ("2" if c.inner_offsets is not None else "")
               + ("_bytes" if c.blob is not None else "")
               for c in batch.columns.values()}
    assert len(layouts) >= 2, layouts
    rng = np.random.default_rng(5)
    for idx in (rng.permutation(batch.num_rows), rng.integers(0, batch.num_rows, 17),
                np.array([], np.int64), np.array([batch.num_rows - 1, 0, 0])):
        assert_batches_equal(take_rows(batch, idx), jcolumnar.take_rows(batch, idx))


def test_take_rows_refuses_what_jax_refuses(shards):
    batch = _layout_batches(shards)["packed_hashed"]
    with pytest.raises(TypeError, match="boolean mask"):
        take_rows(batch, np.ones(batch.num_rows, bool))
    with pytest.raises(ValueError, match="1-D"):
        take_rows(batch, np.zeros((2, 2), np.int64))
    with pytest.raises(IndexError, match="out of range"):
        take_rows(batch, [batch.num_rows])


# -- the shuffled dataset --------------------------------------------------------

READ_CASES = [
    (shuffle, window, seed, drop, decoder)
    for shuffle in (False, True)
    for window in (0, 1, 3)
    for seed in (0, 7)
    for drop in (True, False)
    for decoder in ("native", "python")
]


def _read_pair(path, kind, **kw):
    if kind == "criteo":
        common, jschema_, tschema_ = CRITEO_KW, criteo_schema(jschema), criteo_schema(tschema)
    else:
        common, jschema_, tschema_ = SEQ_KW, seq_schema(jschema), seq_schema(tschema)
    decoder = kw.pop("decoder", "native")
    want = read_all(JDataset(path, schema=jschema_, **common, **kw))
    tds = TDataset(path, schema=tschema_, decoder=decoder, **common, **kw)
    assert tds.decoder == decoder
    return read_all(tds), want, tds


@pytest.mark.parametrize("shuffle,window,seed,drop,decoder", READ_CASES)
def test_shuffled_batches_bit_identical_to_jax(shards, shuffle, window, seed, drop, decoder):
    got, want, _ = _read_pair(shards["criteo"], "criteo", batch_size=BATCH, num_epochs=2,
                              shuffle=shuffle, shuffle_window=window, seed=seed,
                              drop_remainder=drop, decoder=decoder)
    total = 2 * sum(SHARD_ROWS)
    assert [b.num_rows for b in got][:-1] == [BATCH] * (len(got) - 1)
    assert sum(b.num_rows for b in got) == (total // BATCH * BATCH if drop else total)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert_batches_equal(a, b)


@pytest.mark.parametrize("window", [1, 4])
def test_shuffled_ragged2_batches_bit_identical_to_jax(shards, window):
    got, want, _ = _read_pair(shards["seq"], "seq", batch_size=BATCH, num_epochs=2,
                              shuffle=True, shuffle_window=window, seed=3, drop_remainder=False)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert_batches_equal(a, b)


def test_windows_end_on_a_shard_end(tmp_path):
    """Windows that end exactly on a shard's last record: the next window
    is seeded by (epoch, cursor, n), not (epoch, cursor + 1, 0)."""
    rng = np.random.default_rng(2)
    for i, n in enumerate([20, 20, 0, 10, 30]):
        jwire.write_records(str(tmp_path / f"part-{i:05d}.tfrecord"), criteo_records(n, rng))
    got, want, _ = _read_pair(str(tmp_path), "criteo", batch_size=10, num_epochs=3,
                              shuffle=True, shuffle_window=2, seed=1, drop_remainder=False)
    assert len(got) == len(want) == 24
    for a, b in zip(got, want):
        assert_batches_equal(a, b)


def test_epoch_order_matches_jax(shards):
    _, _, tds = _read_pair(shards["criteo"], "criteo", batch_size=BATCH, shuffle=True, seed=4)
    jds = JDataset(shards["criteo"], batch_size=BATCH, schema=criteo_schema(jschema),
                   shuffle=True, seed=4, **CRITEO_KW)
    assert [s.path for s in tds.shards] == [s.path for s in jds.shards]
    for epoch in range(4):
        assert tds.epoch_order(epoch) == jds.epoch_order(epoch)
    assert sorted(tds.epoch_order(0)) == list(range(len(SHARD_ROWS)))


def test_negative_window_raises(shards):
    with pytest.raises(ValueError, match="shuffle_window"):
        TDataset(shards["criteo"], batch_size=8, schema=criteo_schema(tschema), shuffle_window=-1)


# -- train_files against a JAX training loop -------------------------------------

NUM_DENSE, NUM_CAT, VOCAB = 4, 3, 64
TRAIN_BATCH = 16


def _train_schema(mod):
    return mod.StructType(
        [mod.StructField("label", mod.LongType(), nullable=False)]
        + [mod.StructField(f"d{i}", mod.LongType()) for i in range(1, NUM_DENSE + 1)]
        + [mod.StructField(f"c{i}", mod.StringType()) for i in range(1, NUM_CAT + 1)]
    )


@pytest.fixture(scope="module")
def train_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_train_files")
    rng = np.random.default_rng(4)
    for s, n in enumerate([40, 0, 31]):
        recs = []
        for _ in range(n):
            feats = {"label": Feature.int64_list([int(rng.integers(0, 2))])}
            for i in range(1, NUM_DENSE + 1):
                feats[f"d{i}"] = Feature.int64_list([int(rng.integers(-5, 1000))])
            for i in range(1, NUM_CAT + 1):
                feats[f"c{i}"] = Feature.bytes_list([b"v%d" % rng.integers(0, 40)])
            recs.append(encode_example(Example(features=feats)))
        jwire.write_records(str(d / f"part-{s:05d}.tfrecord"), recs)
    return str(d)


def _jax_losses(data_dir, jcfg, params, sparse, steps):
    hash_buckets = {f"c{i}": VOCAB for i in range(1, NUM_CAT + 1)}
    pack = {"dense": [f"d{i}" for i in range(1, NUM_DENSE + 1)],
            "cat": [f"c{i}" for i in range(1, NUM_CAT + 1)]}
    ds = JDataset(data_dir, batch_size=TRAIN_BATCH, schema=_train_schema(jschema),
                  hash_buckets=hash_buckets, pack=pack, num_epochs=2,
                  shuffle=True, shuffle_window=2, seed=1)
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
    return np.array(losses), params


@pytest.mark.parametrize("sparse", [True, False], ids=["sparse", "dense"])
def test_train_files_matches_jax_loop(train_dir, sparse):
    kw = dict(num_dense=NUM_DENSE, num_categorical=NUM_CAT, vocab_size=VOCAB, embed_dim=4,
              bottom_mlp=(8, 4), top_mlp=(8, 1), interaction="dot")
    jcfg = jdlrm.DLRMConfig(dtype=jnp.float32, **kw)
    tcfg = tdlrm.DLRMConfig(dtype=torch.float32, **kw)
    params = jax.tree.map(np.asarray, jdlrm.init_params(jax.random.key(2), jcfg))
    model = interop.dlrm_params_from_jax(params, tcfg, device="cpu")
    want, jparams = _jax_losses(train_dir, jcfg, params, sparse, steps=6)
    res = train_files(train_dir, tcfg, model, TRAIN_BATCH, device="cpu", sparse=sparse,
                      shuffle=True, shuffle_window=2, seed=1, recordType="Example",
                      schema=_train_schema(tschema), num_epochs=2)
    assert res.steps == len(want) == 2 * 71 // TRAIN_BATCH == 8 >= 6
    assert len(res.host_s) == len(res.h2d_s) == len(res.done_s) == res.steps
    assert res.done_s == sorted(res.done_s) and res.done_s[-1] <= res.wall_s
    assert res.losses.shape == (res.steps,) and torch.isfinite(res.losses).all()
    assert isinstance(res.opt, tdlrm.SparseEmbOptState if sparse else torch.optim.Adam)
    np.testing.assert_allclose(res.losses.numpy(), want, rtol=1e-5, atol=1e-6)
    got = interop.dlrm_params_to_jax(model)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(jax.tree.map(np.asarray, jparams))):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)


def test_train_files_log1p_and_label_cast(train_dir):
    """The batch reaching the step has log(1 + max(x, 0)) dense features and
    float32 labels."""
    kw = dict(num_dense=NUM_DENSE, num_categorical=NUM_CAT, vocab_size=VOCAB, embed_dim=4,
              bottom_mlp=(8, 4), top_mlp=(8, 1), dtype=torch.float32)
    cfg = tdlrm.DLRMConfig(**kw)
    model = tdlrm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    seen = []
    real = tdlrm.loss_fn

    def spy(m, batch, emb=None):
        seen.append({k: v.clone() for k, v in batch.items()})
        return real(m, batch, emb=emb)

    tdlrm.loss_fn = spy
    try:
        res = train_files(train_dir, cfg, model, TRAIN_BATCH, device="cpu", sparse=False,
                          recordType="Example", schema=_train_schema(tschema))
    finally:
        tdlrm.loss_fn = real
    assert res.steps == 71 // TRAIN_BATCH == len(seen)
    assert seen[0]["label"].dtype == torch.float32
    assert (seen[0]["dense"] >= 0).all() and seen[0]["dense"].max() < np.log1p(1000) + 1e-5
    assert os.path.isdir(train_dir)
