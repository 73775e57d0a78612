"""The port's serving slice end to end on the CPU: dryrun-style
SequenceExample shards scored by ``score_files``, against the JAX pipeline
(TFRecordDataset -> host_batch_from_columnar -> dlrm.forward) on the same
files and the same weights."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from tpu_tfrecord.io.dataset import TFRecordDataset as JDataset  # noqa: E402
from tpu_tfrecord.models import dlrm as jdlrm  # noqa: E402
from tpu_tfrecord.tpu.ingest import host_batch_from_columnar as j_hbfc  # noqa: E402

from tpu_tfrecord_torch import interop  # noqa: E402
from tpu_tfrecord_torch.entry import score_files, write_dryrun_dataset  # noqa: E402
from tpu_tfrecord_torch.models import dlrm as tdlrm  # noqa: E402

VOCAB = 8
SHARD_ROWS = [6, 14]   # the first batch straddles the two shards
BATCH = 8
TOL = {"f32": dict(rtol=1e-5, atol=1e-5), "bf16": dict(rtol=2e-2, atol=2e-2)}


def configs(dtype):
    kw = dict(num_dense=4, num_categorical=3, vocab_size=VOCAB, embed_dim=4,
              bottom_mlp=(8, 4), top_mlp=(8, 1), seq_len=4, seq_dim=4, interaction="dot")
    jdt, tdt = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    return jdlrm.DLRMConfig(dtype=jdt, **kw), tdlrm.DLRMConfig(dtype=tdt, **kw)


def jax_scores(data_dir, cfg, params):
    """The JAX package's serving flow over the same files, as
    __graft_entry__._ingest_real_batch sets it up, batch by batch."""
    hash_buckets = {f"c{i}": VOCAB for i in range(1, cfg.num_categorical + 1)}
    pack = {"dense": [f"d{i}" for i in range(1, cfg.num_dense + 1)],
            "cat": [f"c{i}" for i in range(1, cfg.num_categorical + 1)]}
    dirs = sorted(os.path.join(data_dir, d) for d in os.listdir(data_dir) if d.startswith("shard"))
    ds = JDataset(dirs, batch_size=BATCH, recordType="SequenceExample",
                  hash_buckets=hash_buckets, pack=pack)
    out = []
    with ds.batches() as it:
        for cb in it:
            hb = j_hbfc(cb, ds.schema, pad_to={"frames": (cfg.seq_len, cfg.seq_dim)},
                        hash_buckets=hash_buckets, pack=pack)
            hb.pop("frames_inner_len", None)
            out.append(np.asarray(jdlrm.forward(params, {k: jnp.asarray(v) for k, v in hb.items()}, cfg)))
    return np.concatenate(out)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_score_files_matches_jax_pipeline(tmp_path, dtype):
    jcfg, tcfg = configs(dtype)
    write_dryrun_dataset(str(tmp_path), tcfg, SHARD_ROWS, VOCAB)
    params = jax.tree.map(np.asarray, jdlrm.init_params(jax.random.key(0), jcfg))
    want = jax_scores(str(tmp_path), jcfg, params)
    model = interop.dlrm_params_from_jax(params, tcfg, device="cpu")
    res = score_files(str(tmp_path), tcfg, model, BATCH, device="cpu")
    assert res.batches == sum(SHARD_ROWS) // BATCH == len(res.host_s) == len(res.h2d_s)
    assert res.logits.shape == (res.batches * BATCH,) and want.shape == res.logits.shape
    assert torch.isfinite(res.logits).all()
    np.testing.assert_allclose(res.logits.numpy(), want, **TOL[dtype])


def test_dryrun_dataset_bytes_equal_jax_writer(tmp_path):
    """The port's dryrun writer produces the JAX dryrun's shards byte for byte."""
    import __graft_entry__ as graft

    _, tcfg = configs("f32")
    write_dryrun_dataset(str(tmp_path / "port"), tcfg, SHARD_ROWS, VOCAB)
    graft._write_dryrun_dataset(str(tmp_path / "jax"), tcfg, SHARD_ROWS, VOCAB)
    for shard in ("shard00", "shard01"):
        files = []
        for side in ("jax", "port"):
            d = tmp_path / side / shard
            (name,) = [n for n in os.listdir(d) if n.startswith("part-")]
            files.append((d / name).read_bytes())
            assert (d / "_SUCCESS").exists()
        assert files[0] == files[1]


def test_score_files_log1p_and_explicit_columns(tmp_path):
    """Explicit column lists and the log1p preprocessing: the dense group
    reaches the model as log(1 + max(x, 0))."""
    _, tcfg = configs("f32")
    write_dryrun_dataset(str(tmp_path), tcfg, [8], VOCAB)
    model = tdlrm.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    seen = []
    real_forward = model.forward
    model.forward = lambda batch, emb=None: (seen.append(batch["dense"]), real_forward(batch))[1]
    res = score_files(str(tmp_path / "shard00"), tcfg, model, 8, device="cpu",
                      dense_cols=[f"d{i}" for i in range(1, 5)],
                      cat_cols=[f"c{i}" for i in range(1, 4)], log1p_dense=True)
    assert res.batches == 1 and seen[0].dtype == torch.float32
    raw = score_files(str(tmp_path / "shard00"), tcfg, model, 8, device="cpu")
    assert raw.batches == 1
    torch.testing.assert_close(seen[0], torch.log1p(seen[1].float().clamp(min=0)))


def test_score_files_native_path_two_epochs_matches_jax_pipeline(tmp_path, monkeypatch):
    """score_files decodes through the native library (mmap + fused scan and
    decode on the producer thread) and gives the JAX pipeline's logits over
    two epochs; the loop's times are consistent."""
    from tpu_tfrecord_torch import _native

    calls = []
    real = _native.NativeDecoder.scan_decode
    monkeypatch.setattr(_native.NativeDecoder, "scan_decode",
                        lambda self, *a, **k: (calls.append(1), real(self, *a, **k))[1])
    jcfg, tcfg = configs("f32")
    write_dryrun_dataset(str(tmp_path), tcfg, SHARD_ROWS, VOCAB)
    params = jax.tree.map(np.asarray, jdlrm.init_params(jax.random.key(1), jcfg))
    want = jax_scores(str(tmp_path), jcfg, params)
    model = interop.dlrm_params_from_jax(params, tcfg, device="cpu")
    res = score_files(str(tmp_path), tcfg, model, BATCH, device="cpu", num_epochs=2)
    assert calls  # the native fused decode ran
    # two epochs of 20 rows: 5 full batches, the third straddles the epochs
    assert res.batches == 2 * sum(SHARD_ROWS) // BATCH == len(res.done_s)
    assert res.done_s == sorted(res.done_s) and 0 < res.done_s[-1] <= res.wall_s
    np.testing.assert_allclose(res.logits[:len(want)].numpy(), want, **TOL["f32"])
    assert torch.isfinite(res.logits).all()
