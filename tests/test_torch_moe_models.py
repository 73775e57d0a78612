"""The port's MoE LM and MoE long_doc against the JAX models on the same
weights (moved through ``interop``, the ``moe`` subtree included) and the
same numpy batches (``JAX_PLATFORMS=cpu``).

- LM (top-2, 4 experts): ``forward`` logits, aux loss and diagnostics
  (counts summed over the layers, fractions averaged), with and without
  packed-document ``segments``; ``loss_fn`` with the aux term; six Adam
  steps through ``train_step(diagnostics=True)`` against the JAX
  ``train_step`` with ``optax.adam(3e-3)``: losses at 1e-5, each step's
  ``expert_tokens`` / ``expert_kept`` equal, parameters at 1e-5 (entries
  whose gradient came within 1e-6 of zero held to Adam's step bound, as
  in ``test_torch_long_doc.py``), and the dense LM's diagnostics ``{}``.
- long_doc (Switch top-1, 4 experts, routed over the valid prefix):
  ``forward(with_aux=True)`` and ``loss_fn`` in float32 (1e-5) and bf16
  (2e-2); four Adam steps against ``optax.adam(1e-3)``; padding content
  does not move the logits; ``remat`` on equals off.
- An LM checkpoint with MoE leaves written through the JAX
  ``LMCheckpoint`` restores into the port's and back, leaf for leaf; one
  more step on each side gives the same loss.
"""

import dataclasses
import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tpu_tfrecord.models import lm as jlm, long_doc as jld

from test_torch_long_doc import (
    BF16_TOL, F32_TOL, JDT, assert_params_close, batch_of, near_zero_grads, torch_batch,
)
from test_torch_lm import packed
from tpu_tfrecord_torch import interop, train_lm as tw_lm
from tpu_tfrecord_torch.checkpoint import tree_flatten
from tpu_tfrecord_torch.models import lm as tlm, long_doc as tld, optim

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "examples"))
import train_lm as jx_lm  # noqa: E402

torch.set_num_threads(1)

LM_KW = dict(vocab_size=64, d_model=16, n_heads=4, n_layers=2, max_len=12, moe_experts=4)
B = 4


def lm_configs(**over):
    kw = dict(LM_KW, **over)
    return jlm.LMConfig(dtype=jnp.float32, **kw), tlm.LMConfig(dtype=torch.float32, **kw)


def lm_params(jcfg, tcfg, seed=0):
    jp = jlm.init_params(jax.random.key(seed), jcfg)
    return jp, interop.lm_params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")


def assert_lm_diag(got, want):
    assert sorted(got) == sorted(want)
    for k in ("expert_tokens", "expert_kept"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    for k in ("dropped_fraction", "gate_entropy"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), **F32_TOL, err_msg=k)


def test_lm_moe_params_interchange():
    jcfg, tcfg = lm_configs()
    jp, tp = lm_params(jcfg, tcfg)
    assert sorted(tp["blocks"]) == ["moe", "proj", "qkv"]
    assert {k: tuple(v.shape) for k, v in tp["blocks"]["moe"].items()} == {
        "router": (2, 16, 4), "w_in": (2, 4, 16, 64), "w_out": (2, 4, 64, 16)}
    # the port's own init has the JAX tree's structure and shapes
    own = tlm.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    assert [tuple(a.shape) for a in tree_flatten(own)[0]] == \
        [tuple(np.shape(a)) for a in jax.tree.leaves(jp)]
    back = interop.lm_params_to_jax(tp)
    for g, w in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(g, np.asarray(w))


@pytest.mark.parametrize("top_k,cf", [(2, 1.25), (1, 1.25), (2, 0.5)], ids=["top2", "top1", "tight"])
@pytest.mark.parametrize("with_segments", [False, True], ids=["slice", "segments"])
def test_lm_forward_and_loss_match_jax(with_segments, top_k, cf):
    jcfg, tcfg = lm_configs(moe_top_k=top_k, moe_capacity_factor=cf)
    jp, tp = lm_params(jcfg, tcfg)
    if with_segments:
        tokens, segs = packed(0)
    else:
        tokens, segs = jlm.make_synthetic_tokens(jcfg, B, seed=3), None
    tseg = None if segs is None else torch.from_numpy(segs)
    with torch.no_grad():
        logits, aux, diag = tlm.forward(tp, torch.from_numpy(tokens), tcfg, segments=tseg,
                                        diagnostics=True)
        loss, ldiag = tlm.loss_fn(tp, torch.from_numpy(tokens), tcfg, segments=tseg,
                                  diagnostics=True)
        plain = tlm.forward(tp, torch.from_numpy(tokens), tcfg, segments=tseg)
    jlogits, jaux, jdiag = jlm.forward(jp, tokens, jcfg, segments=segs, diagnostics=True)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **F32_TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **F32_TOL)
    assert float(aux) > 0
    assert_lm_diag(diag, jdiag)
    assert_lm_diag(ldiag, jdiag)
    # every layer routes the whole stream: B * L * top_k a layer
    assert float(diag["expert_tokens"].sum()) == 2 * B * 12 * top_k
    np.testing.assert_allclose(float(loss), float(jlm.loss_fn(jp, tokens, jcfg, segments=segs)),
                               **F32_TOL)
    assert len(plain) == 2 and torch.equal(plain[0], logits) and torch.equal(plain[1], aux)


def test_lm_adam_steps_match_optax_with_diagnostics():
    jcfg, tcfg = lm_configs()
    jp, tp = lm_params(jcfg, tcfg, seed=2)
    tx = optax.adam(3e-3)
    jo = tx.init(jp)
    jstep = jax.jit(functools.partial(jlm.train_step, cfg=jcfg, tx=tx, diagnostics=True))
    topt = optim.adam(tp, 3e-3)
    near_zero = None
    for i in range(6):
        tokens = jlm.make_synthetic_tokens(jcfg, B, seed=10 + i)
        jp, jo, jloss, jdiag = jstep(jp, jo, tokens)
        tloss, tdiag = tlm.train_step(tp, topt, torch.from_numpy(tokens), tcfg, diagnostics=True)
        near_zero = near_zero_grads(tp, near_zero)
        np.testing.assert_allclose(float(tloss), float(jloss), **F32_TOL)
        assert_lm_diag(tdiag, jdiag)
    assert_params_close(tp, jp, near_zero, steps=6, lr=3e-3)


def test_dense_lm_diagnostics_are_empty():
    jcfg, tcfg = lm_configs(moe_experts=0)
    jp, tp = lm_params(jcfg, tcfg)
    tokens = jlm.make_synthetic_tokens(jcfg, B, seed=1)
    topt = optim.adam(tp, 3e-3)
    loss, diag = tlm.train_step(tp, topt, torch.from_numpy(tokens), tcfg, diagnostics=True)
    _, _, jdiag = jlm.forward(jp, tokens, jcfg, diagnostics=True)
    assert diag == {} and dict(jdiag) == {}
    np.testing.assert_allclose(float(loss), float(jlm.loss_fn(jp, tokens, jcfg)), **F32_TOL)


def ld_configs(dtype, remat=False, **over):
    kw = dict(seq_dim=6, d_model=16, n_heads=4, n_layers=2, max_len=10, n_classes=3,
              moe_experts=4, **over)
    return (jld.LongDocConfig(dtype=JDT[dtype], **kw),
            tld.LongDocConfig(dtype=dtype, remat=remat, **kw))


def ld_params(jcfg, tcfg, seed=0):
    jp = jld.init_params(jax.random.key(seed), jcfg)
    return jp, interop.long_doc_params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")


@pytest.mark.parametrize("cf", [1.25, 0.3], ids=["loose", "tight"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_long_doc_forward_and_loss_match_jax(dtype, cf):
    jcfg, tcfg = ld_configs(dtype, moe_capacity_factor=cf)
    jp, tp = ld_params(jcfg, tcfg)
    assert all(sorted(layer) == ["moe", "proj", "qkv"] for layer in tp["layers"])
    hb = batch_of(tcfg)
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    with torch.no_grad():
        logits, aux = tld.forward(tp, torch_batch(hb), tcfg, with_aux=True)
        loss = tld.loss_fn(tp, torch_batch(hb), tcfg)
        plain = tld.forward(tp, torch_batch(hb), tcfg)
    jlogits, jaux = jld.forward(jp, hb, jcfg, with_aux=True)
    assert logits.dtype == torch.float32 and logits.shape == (5, 3) and torch.equal(plain, logits)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **tol)
    np.testing.assert_allclose(float(aux), float(jaux), **tol)
    np.testing.assert_allclose(float(loss), float(jld.loss_fn(jp, hb, jcfg)), **tol)


def test_long_doc_padding_does_not_route():
    _, tcfg = ld_configs(torch.float32)
    _, tp = ld_params(*ld_configs(torch.float32))
    hb = batch_of(tcfg)
    other = {k: v.copy() for k, v in hb.items()}
    mask = np.arange(tcfg.max_len)[None, :] >= hb["frames_len"][:, None]
    other["frames"][mask] = 100.0  # padding content only
    with torch.no_grad():
        a = tld.forward(tp, torch_batch(hb), tcfg, with_aux=True)
        b = tld.forward(tp, torch_batch(other), tcfg, with_aux=True)
    assert mask.any()
    np.testing.assert_allclose(a[0].numpy(), b[0].numpy(), atol=1e-6)
    np.testing.assert_allclose(float(a[1]), float(b[1]), atol=1e-7)


def test_long_doc_adam_steps_match_optax():
    jcfg, tcfg = ld_configs(torch.float32)
    jp, tp = ld_params(jcfg, tcfg, seed=1)
    tx = optax.adam(1e-3)
    jo = tx.init(jp)
    jstep = jax.jit(functools.partial(jld.train_step, cfg=jcfg, tx=tx))
    topt = optim.adam(tp, 1e-3)
    near_zero = None
    for i in range(4):
        hb = batch_of(tcfg, seed=10 + i)
        jp, jo, jloss = jstep(jp, jo, hb)
        tloss = tld.train_step(tp, topt, torch_batch(hb), tcfg)
        near_zero = near_zero_grads(tp, near_zero)
        np.testing.assert_allclose(float(tloss), float(jloss), **F32_TOL)
    assert_params_close(tp, jp, near_zero, steps=4, lr=1e-3)


def test_long_doc_remat_equals_no_remat():
    _, plain = ld_configs(torch.float32)
    _, remat = ld_configs(torch.float32, remat=True)
    p1 = tld.init_params(plain, torch.Generator().manual_seed(3), device="cpu")
    p2 = tld.init_params(remat, torch.Generator().manual_seed(3), device="cpu")
    o1, o2 = optim.adam(p1, 1e-3), optim.adam(p2, 1e-3)
    for i in range(2):
        b = torch_batch(batch_of(plain, seed=i))
        assert torch.equal(tld.train_step(p1, o1, b, plain), tld.train_step(p2, o2, b, remat))
    for a, b in zip(optim.param_leaves(p1), optim.param_leaves(p2)):
        assert torch.equal(a, b)


def port_leaves(params, opt):
    return [t.detach().numpy() for t in tree_flatten(optim.train_state(params, opt))[0]]


def test_moe_lm_checkpoint_interchanges_both_ways(tmp_path):
    jcfg, tcfg = lm_configs()
    tx = optax.adam(tw_lm.LR)
    jstep = jax.jit(functools.partial(jlm.train_step, cfg=jcfg, tx=tx))
    toks = [jlm.make_synthetic_tokens(jcfg, B, seed=s) for s in range(4)]
    payload = {"input": "{}", "packer": {"residual": [3], "pending": []}}

    jp = jlm.init_params(jax.random.key(0), jcfg)
    jo = tx.init(jp)
    for t in toks[:2]:
        jp, jo, _ = jstep(jp, jo, t)
    jck = jx_lm.LMCheckpoint(str(tmp_path / "from_jax"))
    jck.save(2, (jp, jo), payload)
    jck.close()
    tp = tlm.init_params(tcfg, torch.Generator().manual_seed(5), device="cpu")
    topt = optim.adam(tp, tw_lm.LR)
    tck = tw_lm.LMCheckpoint(str(tmp_path / "from_jax"))
    step, tree, got_payload = tck.load(optim.train_state(tp, topt))
    tck.close()
    assert step == 2 and got_payload == payload
    optim.load_train_state(tp, topt, tree)
    want = jax.tree.leaves(jax.tree.map(np.asarray, (jp, jo)))
    got = port_leaves(tp, topt)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    jp, jo, jloss = jstep(jp, jo, toks[2])
    tloss = tlm.train_step(tp, topt, torch.from_numpy(toks[2]), tcfg)
    np.testing.assert_allclose(float(tloss), float(jloss), **F32_TOL)

    tck = tw_lm.LMCheckpoint(str(tmp_path / "from_port"))
    tck.save(3, optim.train_state(tp, topt), payload)
    tck.close()
    template = jlm.init_params(jax.random.key(9), jcfg)
    jck = jx_lm.LMCheckpoint(str(tmp_path / "from_port"))
    step, (rp, ro), got_payload = jck.load((template, tx.init(template)))
    jck.close()
    assert step == 3 and got_payload == payload
    assert int(ro[0].count) == 3
    for g, w in zip(jax.tree.leaves((rp, ro)), port_leaves(tp, topt)):
        np.testing.assert_array_equal(np.asarray(g), w)
    rp, ro, jloss = jstep(rp, ro, toks[3])
    tloss = tlm.train_step(tp, topt, torch.from_numpy(toks[3]), tcfg)
    np.testing.assert_allclose(float(tloss), float(jloss), **F32_TOL)


def test_lm_stream_still_refuses_moe():
    _, tcfg = lm_configs()
    _, dense = lm_configs(moe_experts=0)
    _, tp = lm_params(*lm_configs(moe_experts=0))
    with pytest.raises(ValueError, match="moe_experts > 0 is not supported"):
        tlm.LMStream(tp, dataclasses.replace(dense, moe_experts=4), device="cpu")
    assert tcfg.moe_top_k == 2 and tcfg.moe_aux_weight == 0.01
