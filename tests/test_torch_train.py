"""The port's training path against the JAX package's on the CPU: the dot
interaction's gradient against ``jax.vjp`` of its ``custom_vjp`` (XLA and
Pallas-interpret forwards), ``_dedup_sort`` bit-exact on both sort paths,
and 6-step trajectories of the dense ``train_step`` and of the sparse
``sparse_train_step`` (row-wise AdaGrad) from the same weights and batches.

Tolerances: f32 rtol 1e-5; bf16 2e-2, and one bf16 ulp (rtol 8e-3) where
the values are single dots. In the dense bf16 step the JAX model casts the
whole table to bf16 before its gather, so rows repeated in a batch sum
their gradients in bf16; the port gathers f32 rows and then casts, so they
sum in f32 (the forward values are identical). That difference is inside
the bf16 tolerance.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

torch.set_num_threads(1)

from tpu_tfrecord.models import dlrm as jdlrm  # noqa: E402
from tpu_tfrecord.models import interaction as jinter  # noqa: E402

from tpu_tfrecord_torch import interop  # noqa: E402
from tpu_tfrecord_torch.device.ingest import make_device_batch  # noqa: E402
from tpu_tfrecord_torch.models import dlrm as tdlrm  # noqa: E402
from tpu_tfrecord_torch.models.interaction import (  # noqa: E402
    DotInteraction,
    dot_interaction,
    dot_interaction_backward_reference,
    dot_interaction_reference,
)

DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"f32": dict(rtol=1e-5, atol=1e-6), "bf16": dict(rtol=2e-2, atol=2e-2)}
# one bf16 ulp where each value is a single dot (or a sum of few)
DOT_TOL = {"f32": dict(rtol=1e-5, atol=1e-5), "bf16": dict(rtol=8e-3, atol=1e-2)}
STEPS = 6


# -- the interaction's backward ---------------------------------------------

GRAD_SHAPES = [(8, 27, 32), (13, 5, 8), (8, 2, 4)]


def _emb_and_cotangent(shape, seed=0):
    rng = np.random.default_rng(seed)
    b, f, _ = shape
    return (rng.normal(size=shape).astype(np.float32),
            rng.normal(size=(b, f * (f - 1) // 2)).astype(np.float32))


@pytest.mark.parametrize("use_pallas", [None, True], ids=["xla", "pallas_interpret"])
@pytest.mark.parametrize("shape", GRAD_SHAPES)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_interaction_grad_matches_jax_vjp(dtype, shape, use_pallas):
    jdt, tdt = DTYPES[dtype]
    e_np, g_np = _emb_and_cotangent(shape)
    e_j, g_j = jnp.asarray(e_np, jdt), jnp.asarray(g_np, jdt)
    # one tile over the whole batch: the kernel takes any B that way
    fwd = functools.partial(jinter.dot_interaction, use_pallas=use_pallas,
                            block_b=shape[0], interpret=bool(use_pallas))
    _, vjp = jax.vjp(fwd, e_j)
    (want,) = vjp(g_j)
    emb = torch.from_numpy(e_np).to(tdt).requires_grad_()
    out = dot_interaction(emb)
    assert isinstance(out.grad_fn, DotInteraction._backward_cls)
    out.backward(torch.from_numpy(g_np).to(tdt))
    assert emb.grad.dtype == tdt and emb.grad.shape == shape
    np.testing.assert_allclose(emb.grad.float().numpy(), np.asarray(want, np.float32),
                               **DOT_TOL[dtype])


@pytest.mark.parametrize("shape", GRAD_SHAPES)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_function_grad_matches_autograd_through_plain_version(dtype, shape):
    _, tdt = DTYPES[dtype]
    e_np, g_np = _emb_and_cotangent(shape, seed=1)
    g = torch.from_numpy(g_np).to(tdt)
    a = torch.from_numpy(e_np).to(tdt).requires_grad_()
    b = torch.from_numpy(e_np).to(tdt).requires_grad_()
    DotInteraction.apply(a).backward(g)
    dot_interaction_reference(b).backward(g)
    torch.testing.assert_close(a.grad.float(), b.grad.float(), **DOT_TOL[dtype])
    torch.testing.assert_close(
        dot_interaction_backward_reference(a.detach(), g), a.grad, rtol=0, atol=0)


def test_no_graph_under_no_grad_or_without_requires_grad():
    emb = torch.randn(4, 5, 3)
    assert dot_interaction(emb).grad_fn is None
    with torch.no_grad():
        assert dot_interaction(emb.requires_grad_()).grad_fn is None


# -- _dedup_sort ---------------------------------------------------------------


@pytest.mark.parametrize("force_pairs", [False, True])
def test_dedup_sort_bit_exact_against_jax(force_pairs):
    # the skewed duplicate-heavy case of the JAX package's own sort test
    rng = np.random.default_rng(31)
    f_np = np.repeat(np.arange(3), 32).astype(np.int32)
    v_np = rng.integers(0, 6, 96).astype(np.int32)
    want = jdlrm._dedup_sort(jnp.asarray(f_np), jnp.asarray(v_np), 6, force_pairs=force_pairs)
    got = tdlrm._dedup_sort(torch.from_numpy(f_np), torch.from_numpy(v_np), 6,
                            force_pairs=force_pairs)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # and both port paths agree with each other
    other = tdlrm._dedup_sort(torch.from_numpy(f_np), torch.from_numpy(v_np), 6,
                              force_pairs=not force_pairs)
    for g, o in zip(got, other):
        assert torch.equal(g, o)


# -- trajectories ------------------------------------------------------------


def configs(interaction, dtype, vocab=64):
    kw = dict(num_dense=4, num_categorical=3, vocab_size=vocab, embed_dim=4,
              bottom_mlp=(8, 4), top_mlp=(8, 1), interaction=interaction)
    jdt, tdt = DTYPES[dtype]
    return jdlrm.DLRMConfig(dtype=jdt, **kw), tdlrm.DLRMConfig(dtype=tdt, **kw)


def batches(jcfg, regime, n=STEPS, batch_size=16):
    out = []
    for k in range(n):
        host = jdlrm.make_synthetic_batch(jcfg, batch_size, seed=100 + k)
        rng = np.random.default_rng(200 + k)
        if regime == "distinct":
            for f in range(jcfg.num_categorical):
                host["cat"][:, f] = rng.choice(jcfg.vocab_size, size=batch_size, replace=False)
        elif regime == "all7":
            host["cat"][:] = 7
        elif regime == "skewed":
            host["cat"] = rng.integers(0, 6, size=host["cat"].shape)
        out.append(host)
    return out


def jparams(jcfg, seed):
    return jax.tree.map(np.asarray, jdlrm.init_params(jax.random.key(seed), jcfg))


def assert_weights_close(model, params, tol):
    got = interop.dlrm_params_to_jax(model)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(jax.tree.map(np.asarray, params))):
        np.testing.assert_allclose(g, w, **tol)


DENSE_CASES = [(i, d) for i in ("dot", "cat") for d in ("f32", "bf16")]


@pytest.mark.parametrize("interaction,dtype", DENSE_CASES)
def test_dense_trajectory_matches_jax(interaction, dtype):
    jcfg, tcfg = configs(interaction, dtype, vocab=16)
    params = jparams(jcfg, 3)
    model = interop.dlrm_params_from_jax(params, tcfg, device="cpu")
    tx = optax.adam(1e-2)
    jstate = tx.init(params)
    jstep = jax.jit(functools.partial(jdlrm.train_step, cfg=jcfg, tx=tx))
    opt = torch.optim.Adam(model.parameters(), lr=1e-2)
    for host in batches(jcfg, "skewed"):
        params, jstate, jloss = jstep(params, jstate, {k: jnp.asarray(v) for k, v in host.items()})
        loss = tdlrm.train_step(model, opt, make_device_batch(host, "cpu"))
        assert loss.dim() == 0 and loss.grad_fn is None
        np.testing.assert_allclose(float(loss), float(jloss), **TOL[dtype])
    assert_weights_close(model, params, TOL[dtype])


def _torch_opt(name):
    return {"sgd": lambda ps: torch.optim.SGD(ps, lr=1e-2),
            "adam": lambda ps: torch.optim.Adam(ps, lr=1e-2)}[name]


SPARSE_CASES = [(r, o, d) for r in ("distinct", "all7", "skewed")
                for o in ("sgd", "adam") for d in ("f32", "bf16")]


@pytest.mark.parametrize("regime,opt_name,dtype", SPARSE_CASES)
def test_sparse_trajectory_matches_jax(regime, opt_name, dtype):
    jcfg, tcfg = configs("dot", dtype)
    params = jparams(jcfg, 5)
    model = interop.dlrm_params_from_jax(params, tcfg, device="cpu")
    table0 = model.embeddings.clone()
    tx = {"sgd": optax.sgd(1e-2), "adam": optax.adam(1e-2)}[opt_name]
    jstate = jdlrm.sparse_opt_init(params, jcfg, tx)
    jstep = jax.jit(functools.partial(jdlrm.sparse_train_step, cfg=jcfg, tx=tx))
    state = tdlrm.sparse_opt_init(model, tcfg, _torch_opt(opt_name))
    touched = np.zeros((jcfg.num_categorical, jcfg.vocab_size), bool)
    for host in batches(jcfg, regime):
        touched[np.arange(jcfg.num_categorical)[None, :], host["cat"]] = True
        params, jstate, jloss = jstep(params, jstate, {k: jnp.asarray(v) for k, v in host.items()})
        loss = tdlrm.sparse_train_step(model, state, make_device_batch(host, "cpu"), tcfg)
        assert loss.dim() == 0 and not model.embeddings.requires_grad
        np.testing.assert_allclose(float(loss), float(jloss), **TOL[dtype])
        np.testing.assert_allclose(interop.sparse_opt_state_to_jax(state),
                                   np.asarray(jstate.accum), **TOL[dtype])
    assert_weights_close(model, params, TOL[dtype])
    untouched = torch.from_numpy(~touched)
    assert torch.equal(model.embeddings[untouched], table0[untouched])
    assert (state.accum[untouched] == 0).all()


def test_sparse_steps_resume_from_a_jax_state_bit_exact():
    """Both sides continue from one mid-training JAX state (weights and
    accumulators moved through interop, bit-exact) and stay together."""
    jcfg, tcfg = configs("dot", "f32")
    params = jparams(jcfg, 7)
    tx = optax.sgd(1e-2)
    jstate = jdlrm.sparse_opt_init(params, jcfg, tx)
    jstep = jax.jit(functools.partial(jdlrm.sparse_train_step, cfg=jcfg, tx=tx))
    data = batches(jcfg, "skewed")
    for host in data[:3]:
        params, jstate, _ = jstep(params, jstate, {k: jnp.asarray(v) for k, v in host.items()})
    model = interop.dlrm_params_from_jax(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    state = interop.sparse_opt_state_from_jax(
        jstate, tcfg, torch.optim.SGD(list(tdlrm.dense_parameters(model)), lr=1e-2), device="cpu")
    np.testing.assert_array_equal(interop.sparse_opt_state_to_jax(state), np.asarray(jstate.accum))
    for host in data[3:]:
        params, jstate, jloss = jstep(params, jstate, {k: jnp.asarray(v) for k, v in host.items()})
        loss = tdlrm.sparse_train_step(model, state, make_device_batch(host, "cpu"), tcfg)
        np.testing.assert_allclose(float(loss), float(jloss), **TOL["f32"])
    assert_weights_close(model, params, TOL["f32"])
    with pytest.raises(ValueError, match="accum"):
        interop.sparse_opt_state_from_jax(np.zeros((2, 2), np.float32), tcfg, state.dense, "cpu")
