"""The port's long-document classifier (``tpu_tfrecord_torch.models.long_doc``)
against the JAX ``long_doc`` on the same weights (moved through ``interop``)
and the same numpy batches: logits and loss in float32 (1e-5) and bf16
(2e-2), MHA and GQA; four Adam steps against ``optax.adam(1e-3)`` in
float32 (losses and parameters at 1e-5); ``remat`` on equals off; a mesh
raises.

Adam divides each gradient by its size plus eps (1e-8). Where an entry's
gradient comes within 1e-6 of zero (but is not zero) on some step, the
two packages' float32
rounding (≈1e-9 there) moves its update by up to ``lr``: the key bias is
such an entry on every step (softmax does not change when one constant is
added to every score of a row, so its exact gradient is zero). Those
entries are held to the most Adam can move a parameter, ``lr`` a step, and
every other entry to 1e-5; they are counted, and few."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tpu_tfrecord.models import long_doc as jld

from tpu_tfrecord_torch import interop
from tpu_tfrecord_torch.models import long_doc as tld, optim
from tpu_tfrecord_torch.options import OptionNotPortedError

torch.set_num_threads(1)

F32_TOL = dict(atol=1e-5, rtol=1e-5)
BF16_TOL = dict(atol=2e-2, rtol=2e-2)
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def configs(dtype, kv_heads, remat=False):
    kw = dict(seq_dim=6, d_model=16, n_heads=4, n_kv_heads=kv_heads, n_layers=2,
              max_len=10, n_classes=3)
    return (jld.LongDocConfig(dtype=JDT[dtype], **kw),
            tld.LongDocConfig(dtype=dtype, remat=remat, **kw))


def batch_of(tcfg, seed=0, batch_size=5):
    hb = tld.make_synthetic_batch(tcfg, batch_size, seed=seed)
    hb["frames_len"][0] = 0  # an empty document pools nothing
    hb["label"] = np.random.default_rng(seed).integers(0, tcfg.n_classes, batch_size).astype(np.int32)
    return hb


def torch_batch(hb):
    return {k: torch.from_numpy(v) for k, v in hb.items()}


def both_params(jcfg, tcfg, seed=0):
    jp = jld.init_params(jax.random.key(seed), jcfg)
    tp = interop.long_doc_params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jp, tp


@pytest.mark.parametrize("kv_heads", [0, 2, 1], ids=["mha", "gqa", "mqa"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_forward_and_loss_match_jax(dtype, kv_heads):
    jcfg, tcfg = configs(dtype, kv_heads)
    jp, tp = both_params(jcfg, tcfg)
    hb = batch_of(tcfg)
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    with torch.no_grad():
        got = tld.forward(tp, torch_batch(hb), tcfg)
        loss = tld.loss_fn(tp, torch_batch(hb), tcfg)
    want = jld.forward(jp, hb, jcfg)
    assert got.dtype == torch.float32 and got.shape == (5, 3)
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)
    np.testing.assert_allclose(float(loss), float(jld.loss_fn(jp, hb, jcfg)), **tol)


def near_zero_grads(params, masks=None):
    """Per leaf, the entries whose gradient (``.grad`` after a step) came
    within 1e-6 of zero without being zero (rows the batch did not touch
    get an exact zero on both sides), or'd into ``masks``."""
    grads = [(p.grad != 0) & (p.grad.abs() < 1e-6) for p in optim.param_leaves(params)]
    return grads if masks is None else [m | g for m, g in zip(masks, grads)]


def assert_params_close(tparams, jparams, near_zero, steps, lr):
    """Every parameter within 1e-5 of JAX's, apart from the entries of
    ``near_zero`` (see the module docstring), held within ``steps * lr``."""
    got = optim.param_leaves(tparams)
    want = jax.tree.leaves(jax.tree.map(np.asarray, jparams))
    assert len(got) == len(want) == len(near_zero)
    n_loose = sum(int(m.sum()) for m in near_zero)
    assert n_loose < 0.02 * sum(w.size for w in want), n_loose
    for i, (t, w, m) in enumerate(zip(got, want, near_zero)):
        t, m = t.detach().numpy().copy(), m.numpy()
        w = w.copy()
        if m.any():
            assert np.abs(t[m] - w[m]).max() <= steps * lr * (1 + 1e-3), i
            t[m] = w[m] = 0.0
        np.testing.assert_allclose(t, w, **F32_TOL, err_msg=f"leaf {i}")


@pytest.mark.parametrize("kv_heads", [0, 2], ids=["mha", "gqa"])
def test_adam_steps_match_optax(kv_heads):
    jcfg, tcfg = configs(torch.float32, kv_heads)
    jp, tp = both_params(jcfg, tcfg, seed=1)
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
    # the moments and the count, in optax's layout
    st = interop.adam_state_to_jax(tp, topt)
    assert int(st.count) == int(jo[0].count) == 4 and st.count.dtype == np.int32
    for g, w in zip(jax.tree.leaves(st.mu), jax.tree.leaves(jo[0].mu)):
        np.testing.assert_allclose(g, np.asarray(w), **F32_TOL)


def test_remat_equals_no_remat():
    _, plain = configs(torch.float32, 2)
    _, remat = configs(torch.float32, 2, remat=True)
    p1 = tld.init_params(plain, torch.Generator().manual_seed(3), device="cpu")
    p2 = tld.init_params(remat, torch.Generator().manual_seed(3), device="cpu")
    o1, o2 = optim.adam(p1, 1e-3), optim.adam(p2, 1e-3)
    for i in range(2):
        b = torch_batch(batch_of(plain, seed=i))
        l1 = tld.train_step(p1, o1, b, plain)
        l2 = tld.train_step(p2, o2, b, remat)
        assert torch.equal(l1, l2)
    for a, b in zip(optim.param_leaves(p1), optim.param_leaves(p2)):
        assert torch.equal(a, b)


def test_synthetic_batch_equals_jax():
    jcfg, tcfg = configs(torch.float32, 0)
    got, want = tld.make_synthetic_batch(tcfg, 7, seed=4), jld.make_synthetic_batch(jcfg, 7, seed=4)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_moe_and_mesh_raise():
    _, tcfg = configs(torch.float32, 0)
    # the MoE FFN is ported (held to JAX in test_torch_moe_models.py): it
    # initialises; a mesh still raises
    moe = tld.init_params(tld.LongDocConfig(moe_experts=4), device="cpu")
    assert all(sorted(layer) == ["moe", "proj", "qkv"] for layer in moe["layers"])
    params = tld.init_params(tcfg, device="cpu")
    with pytest.raises(OptionNotPortedError, match="mesh"):
        tld.forward(params, torch_batch(batch_of(tcfg)), tcfg, mesh=object())


def test_params_from_jax_checks_shapes():
    jcfg, tcfg = configs(torch.float32, 0)
    jp = jax.tree.map(np.asarray, jld.init_params(jax.random.key(0), jcfg))
    other = tld.LongDocConfig(seq_dim=6, d_model=16, n_heads=4, n_layers=2, max_len=12,
                              n_classes=3)
    with pytest.raises(ValueError, match="pos"):
        interop.long_doc_params_from_jax(jp, other, device="cpu")
    back = interop.long_doc_params_to_jax(interop.long_doc_params_from_jax(jp, tcfg, "cpu"))
    for g, w in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(g, w)
