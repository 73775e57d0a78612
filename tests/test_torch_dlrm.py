"""Port DLRM vs the JAX package: forward and loss parity on the same
weights (moved through ``interop``) and the same numpy batch, for the dot
and cat interactions, with and without the sequence tower, in f32 and
bf16; a bit-exact ``interop`` round trip."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from tpu_tfrecord.models import dlrm as jdlrm  # noqa: E402

from tpu_tfrecord_torch import interop  # noqa: E402
from tpu_tfrecord_torch.device.ingest import make_device_batch  # noqa: E402
from tpu_tfrecord_torch.entry import entry  # noqa: E402
from tpu_tfrecord_torch.models import dlrm as tdlrm  # noqa: E402

TOL = {"f32": dict(rtol=1e-5, atol=1e-5), "bf16": dict(rtol=2e-2, atol=2e-2)}
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def configs(interaction, seq, dtype):
    kw = dict(num_dense=4, num_categorical=3, vocab_size=16, embed_dim=8,
              bottom_mlp=(8, 8), top_mlp=(8, 1), interaction=interaction,
              seq_len=4 if seq else 0, seq_dim=4 if seq else 0)
    jdt, tdt = DTYPES[dtype]
    return jdlrm.DLRMConfig(dtype=jdt, **kw), tdlrm.DLRMConfig(dtype=tdt, **kw)


def jax_params_np(jcfg, seed=0):
    return jax.tree.map(np.asarray, jdlrm.init_params(jax.random.key(seed), jcfg))


CASES = [(i, s, d) for i in ("dot", "cat") for s in (False, True) for d in ("f32", "bf16")]


@pytest.mark.parametrize("interaction,seq,dtype", CASES)
def test_forward_and_loss_parity(interaction, seq, dtype):
    jcfg, tcfg = configs(interaction, seq, dtype)
    params = jax_params_np(jcfg)
    model = interop.dlrm_params_from_jax(params, tcfg, device="cpu")
    host = jdlrm.make_synthetic_batch(jcfg, 24, seed=3)
    want_logits = np.asarray(jdlrm.forward(params, {k: jnp.asarray(v) for k, v in host.items()}, jcfg))
    want_loss = float(jdlrm.loss_fn(params, {k: jnp.asarray(v) for k, v in host.items()}, jcfg))
    batch = make_device_batch(host, "cpu")
    got_logits = model(batch)
    assert got_logits.dtype == torch.float32 and got_logits.shape == (24,)
    np.testing.assert_allclose(got_logits.numpy(), want_logits, **TOL[dtype])
    np.testing.assert_allclose(float(tdlrm.loss_fn(model, batch)), want_loss, **TOL[dtype])


def test_int32_cat_and_given_rows_match():
    """'cat' as int32 (what ingest produces) gives the same logits as int64,
    and passing the gathered rows as ``emb`` gives the same logits again."""
    jcfg, tcfg = configs("dot", True, "f32")
    model = interop.dlrm_params_from_jax(jax_params_np(jcfg), tcfg, device="cpu")
    host = jdlrm.make_synthetic_batch(jcfg, 8, seed=1)
    b64 = make_device_batch(host, "cpu")
    b32 = make_device_batch(dict(host, cat=host["cat"].astype(np.int32)), "cpu")
    torch.testing.assert_close(model(b32), model(b64), rtol=0, atol=0)
    rows = model.embeddings[torch.arange(3)[None, :], b64["cat"]]
    torch.testing.assert_close(model(b64, emb=rows), model(b64), rtol=0, atol=0)


def test_synthetic_batch_equals_jax():
    jcfg, tcfg = configs("dot", True, "f32")
    want = jdlrm.make_synthetic_batch(jcfg, 10, seed=7)
    got = tdlrm.make_synthetic_batch(tcfg, 10, seed=7)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("seq", [False, True])
def test_interop_round_trip_bit_exact(seq):
    jcfg, tcfg = configs("dot", seq, "bf16")
    params = jax_params_np(jcfg, seed=2)
    back = interop.dlrm_params_to_jax(interop.dlrm_params_from_jax(params, tcfg, device="cpu"))
    flat_a, tree_a = jax.tree.flatten(params)
    flat_b, tree_b = jax.tree.flatten(back)
    assert tree_a == tree_b
    for a, b in zip(flat_a, flat_b):
        assert b.dtype == np.float32 and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_port_init_round_trips_through_jax_layout():
    _, tcfg = configs("cat", True, "f32")
    model = tdlrm.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    again = interop.dlrm_params_from_jax(interop.dlrm_params_to_jax(model), tcfg, device="cpu")
    for (name, a), (_, b) in zip(model.state_dict().items(), again.state_dict().items()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)


def test_init_distributions_and_shapes():
    _, tcfg = configs("dot", True, "f32")
    tcfg = tdlrm.DLRMConfig(**{**tcfg.__dict__, "vocab_size": 4096})
    model = tdlrm.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert model.embeddings.shape == (3, 4096, 8) and model.embeddings.dtype == torch.float32
    assert abs(model.embeddings.std().item() - 0.05) < 2e-3
    assert model.top[0].in_features == 8 + 4 * 3 // 2 + 8
    for layer in list(model.bottom) + list(model.top) + [model.seq_proj]:
        assert torch.count_nonzero(layer.bias) == 0


def test_dot_requires_matching_widths():
    with pytest.raises(ValueError, match="bottom_mlp"):
        tdlrm.init_params(tdlrm.DLRMConfig(embed_dim=8, bottom_mlp=(8, 4), interaction="dot"),
                          torch.Generator().manual_seed(0), "cpu")


def test_entry_forward_on_cpu():
    model, (batch,) = entry("cpu")
    logits = model(batch)
    assert logits.shape == (32,) and torch.isfinite(logits).all()


def test_dlrm_builds_on_the_card_unless_asked_for_the_cpu():
    """``DLRM(cfg)`` makes its parameters on the card, as ``init_params``
    does; asked for the CPU explicitly, every parameter lies there."""
    import inspect

    assert inspect.signature(tdlrm.DLRM).parameters["device"].default == "cuda"
    assert inspect.signature(tdlrm.init_params).parameters["device"].default == "cuda"
    _, tcfg = configs("dot", False, "f32")
    model = tdlrm.DLRM(tcfg, device="cpu")
    assert {p.device.type for p in model.parameters()} == {"cpu"}
