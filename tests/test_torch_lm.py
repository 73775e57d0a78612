"""The port's causal LM (``tpu_tfrecord_torch.models.lm``) against the JAX
``lm`` on the same weights (moved through ``interop``) and the same numpy
tokens: the forward with and without packed-document ``segments`` (f32,
1e-5), the loss with the valid-pair mask, eight Adam steps against
``optax.adam(3e-3)`` (losses and parameters at 1e-5, entries whose
gradient came within 1e-6 of zero held to Adam's step bound, as in
``test_torch_long_doc.py``), the synthetic language's bytes, and the
mesh axes alone (the MoE FFN is held to JAX in
``test_torch_moe_models.py``)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tpu_tfrecord.models import lm as jlm
from tpu_tfrecord.tpu.ingest import TokenPacker as JPacker

from test_torch_long_doc import F32_TOL, assert_params_close, near_zero_grads
from tpu_tfrecord_torch import interop
from tpu_tfrecord_torch.models import lm as tlm, optim
from tpu_tfrecord_torch.options import OptionNotPortedError

torch.set_num_threads(1)

KW = dict(vocab_size=64, d_model=16, n_heads=4, n_layers=2, max_len=12)
B = 4


def configs():
    return jlm.LMConfig(dtype=jnp.float32, **KW), tlm.LMConfig(dtype=torch.float32, **KW)


def both_params(seed=0):
    jcfg, tcfg = configs()
    jp = jlm.init_params(jax.random.key(seed), jcfg)
    return jp, interop.lm_params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")


def packed(seed, n_docs=12):
    """A best_fit batch of the JAX packer: tokens and segment ids, padding
    included (segment 0)."""
    rng = np.random.default_rng(seed)
    pk = JPacker(B, KW["max_len"], packing="best_fit")
    while True:
        pk.feed_docs(rng.integers(1, KW["vocab_size"], size=int(n)) for n in
                     rng.integers(1, 10, size=n_docs))
        b = pk.pop()
        if b is not None:
            return b["tokens"], b["segment_ids"]


@pytest.mark.parametrize("with_segments", [False, True], ids=["slice", "segments"])
def test_forward_and_loss_match_jax(with_segments):
    jcfg, tcfg = configs()
    jp, tp = both_params()
    if with_segments:
        tokens, segs = packed(0)
        assert (segs == 0).any() and (segs.max(axis=1) > 1).any()
    else:
        tokens, segs = jlm.make_synthetic_tokens(jcfg, B, seed=3), None
    tseg = None if segs is None else torch.from_numpy(segs)
    with torch.no_grad():
        logits, aux = tlm.forward(tp, torch.from_numpy(tokens), tcfg, segments=tseg)
        loss = tlm.loss_fn(tp, torch.from_numpy(tokens), tcfg, segments=tseg)
    jlogits, jaux = jlm.forward(jp, tokens, jcfg, segments=segs)
    assert logits.shape == (B, KW["max_len"], KW["vocab_size"]) and logits.dtype == torch.float32
    assert float(aux) == float(jaux) == 0.0
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **F32_TOL)
    np.testing.assert_allclose(float(loss), float(jlm.loss_fn(jp, tokens, jcfg, segments=segs)),
                               **F32_TOL)


def test_segments_restart_positions_per_document():
    jcfg, tcfg = configs()
    jp, tp = both_params()
    tokens, segs = packed(1)
    got = tlm._embed_tokens(tp, torch.from_numpy(tokens), tcfg, torch.from_numpy(segs))
    want = jlm._embed_tokens(jp, tokens, jcfg, segments=segs)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("with_segments", [False, True], ids=["slice", "segments"])
def test_adam_steps_match_optax(with_segments):
    jcfg, tcfg = configs()
    jp, tp = both_params(seed=2)
    tx = optax.adam(3e-3)
    jo = tx.init(jp)
    jstep = jax.jit(functools.partial(jlm.train_step, cfg=jcfg, tx=tx))
    topt = optim.adam(tp, 3e-3)
    near_zero = None
    for i in range(8):
        if with_segments:
            tokens, segs = packed(10 + i)
        else:
            tokens, segs = jlm.make_synthetic_tokens(jcfg, B, seed=10 + i), None
        jp, jo, jloss = jstep(jp, jo, tokens, segments=segs)
        tloss = tlm.train_step(tp, topt, torch.from_numpy(tokens), tcfg,
                               segments=None if segs is None else torch.from_numpy(segs))
        near_zero = near_zero_grads(tp, near_zero)
        np.testing.assert_allclose(float(tloss), float(jloss), **F32_TOL)
    assert_params_close(tp, jp, near_zero, steps=8, lr=3e-3)


def test_synthetic_language_bytes_equal_jax():
    jcfg, tcfg = configs()
    assert tlm.bigram_table(64, 4).tobytes() == jlm.bigram_table(64, 4).tobytes()
    got, want = tlm.make_synthetic_tokens(tcfg, 5, seed=7), jlm.make_synthetic_tokens(jcfg, 5, seed=7)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    windows = [np.arange(12) + i for i in range(3)]
    assert tlm.pack_slots(windows, 4, 12).tobytes() == jlm.pack_slots(windows, 4, 12).tobytes()
    with pytest.raises(ValueError):
        tlm.pack_slots(windows, 2, 12)


# alone, without a mesh to place them on, these select nothing: the JAX
# forward runs its dense loop, and so does the port's
RUN_LIKE_JAX = ("mesh", "data_axis", "seq_axis", "fsdp_axis", "expert_axis")


@pytest.mark.parametrize("axis", ["mesh", "data_axis", "seq_axis", "pipe_axis", "fsdp_axis",
                                  "expert_axis"])
def test_mesh_axes_raise(axis):
    """A mesh argument alone: ``mesh``, ``data_axis``, ``seq_axis``,
    ``fsdp_axis`` or ``expert_axis`` with nothing to shard over run the
    dense loop as JAX does (logits 1e-5); ``fsdp_axis`` on one card's
    mapping mesh and ``pipe_axis`` without a mesh of sizes still raise
    ``OptionNotPortedError`` naming the axis (FSDP and EP run over a
    ``DeviceMesh`` of ranks: ``tests/test_torch_lm_fsdp.py``,
    ``tests/test_torch_moe_mesh.py``)."""
    jcfg, tcfg = configs()
    jp, tp = both_params()
    tokens = tlm.make_synthetic_tokens(tcfg, 2)
    if axis in RUN_LIKE_JAX:
        got = tlm.forward(tp, torch.from_numpy(tokens), tcfg, **{axis: "x"})[0]
        want = jlm.forward(jp, jnp.asarray(tokens), jcfg, **{axis: "x"})[0]
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **F32_TOL)
        loss = tlm.loss_fn(tp, torch.from_numpy(tokens), tcfg, **{axis: "x"})
        np.testing.assert_allclose(float(loss), float(jlm.loss_fn(jp, jnp.asarray(tokens), jcfg,
                                                                  **{axis: "x"})), **F32_TOL)
        if axis == "fsdp_axis":
            with pytest.raises(OptionNotPortedError, match=axis):
                tlm.forward(tp, torch.from_numpy(tokens), tcfg, mesh={"x": 2}, fsdp_axis="x")
        return
    with pytest.raises(OptionNotPortedError, match=axis):
        tlm.forward(tp, torch.from_numpy(tokens), tcfg, **{axis: "x"})
    with pytest.raises(OptionNotPortedError, match=axis):
        tlm.loss_fn(tp, torch.from_numpy(tokens), tcfg, **{axis: "x"})


def test_moe_stream_and_shardings_raise():
    # the MoE FFN is ported: its parameters hold a moe subtree in place of
    # mlp_in / mlp_out
    params = tlm.init_params(tlm.LMConfig(moe_experts=4, **KW), device="cpu")
    assert sorted(params["blocks"]) == ["moe", "proj", "qkv"]
    assert params["blocks"]["moe"]["w_in"].shape == (2, 4, 16, 64)
    # LMStream is ported; as in the JAX package it refuses the MoE FFN
    _, tp = both_params()
    with pytest.raises(ValueError, match="moe_experts > 0 is not supported"):
        tlm.LMStream(tp, tlm.LMConfig(moe_experts=4, **KW), device="cpu")
    # the LM's placements on the expert axis are JAX's: the expert dim of
    # the MoE kernels Shard(1), everything else replicated
    from jax.sharding import Mesh

    jparams = jlm.init_params(jax.random.key(0), jlm.LMConfig(moe_experts=4, **KW))
    mesh = Mesh(np.array(jax.devices()[:2]), ("expert",))
    want = jax.tree.map(lambda sh: (f"Shard(dim={list(sh.spec).index('expert')})"
                                    if "expert" in tuple(sh.spec) else "Replicate()",),
                        jlm.param_shardings(mesh, jparams, expert_axis="expert"))
    got = tlm.param_shardings({"expert": 2}, params, expert_axis="expert")
    assert jax.tree.map(repr, got) == want
    assert want["blocks"]["moe"]["w_in"] == ("Shard(dim=1)",)


def test_wrong_length_raises():
    _, tcfg = configs()
    _, tp = both_params()
    with pytest.raises(ValueError, match="max_len"):
        tlm.forward(tp, torch.zeros(2, 9, dtype=torch.int32), tcfg)
