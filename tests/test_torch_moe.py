"""The port's MoE FFN (``tpu_tfrecord_torch.models.moe``) against the JAX
``moe`` on the same weights and the same numpy tokens (``JAX_PLATFORMS=cpu``).

- ``moe_apply``: outputs, the aux loss, the diagnostics and the gradients
  of x, ``router``, ``w_in`` and ``w_out`` against the JAX ``moe_apply``
  (float32 at 1e-5; bf16 compute at 2e-2, gradients in float32), and the
  outputs and diagnostics against ``moe_reference`` (the float64 oracle,
  in both packages), at top_k 1 and 2, under a ``valid`` mask and at a
  capacity tight enough to drop.
- ``_route``: on the JAX router probabilities, the port's (expert, queue
  position) of every kept assignment is the JAX dispatch tensor's, and its
  gates the JAX combine tensor's; each rank's expert is the oracle's
  argsort pick. ``_capacity`` is the JAX integer expression.
- Tight capacity drops second choices first; padding takes no slot.
- Repeated calls are bit-identical under deterministic algorithms.
- A bad ``top_k`` raises ``ValueError``. The expert-parallel entry
  points raise what JAX raises: ``moe_apply_ep`` JAX's two ``ValueError``s
  (its ``test_indivisible_shapes_rejected``), ``param_shardings`` JAX's
  ``ValueError`` for an axis the mesh lacks; ``moe_ep_body`` on one rank
  equals the JAX body under a one-device ``shard_map``, and
  ``param_shardings`` gives JAX's specs (over gloo ranks:
  ``test_torch_moe_mesh.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_tfrecord.models import moe as jmoe

from tpu_tfrecord_torch.models import moe as tmoe
from tpu_tfrecord_torch.options import OptionNotPortedError

torch.set_num_threads(1)

F32_TOL = dict(atol=1e-5, rtol=1e-5)
BF16_TOL = dict(atol=2e-2, rtol=2e-2)
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
D, FF, E = 16, 32, 4
SHAPE = (3, 40)  # leading dims of x: 120 tokens

# (top_k, capacity factor, share of padding): the Switch layer, top-2, a
# capacity that drops most second choices, and padding under top-2
CASES = {
    "top1": (1, 1.25, 0.0),
    "top2": (2, 1.25, 0.0),
    "top2_tight": (2, 0.25, 0.0),
    "top2_valid": (2, 1.25, 0.25),
    "top1_valid_tight": (1, 0.5, 0.25),
}


def configs(top_k, cf, dtype=torch.float32):
    kw = dict(d_model=D, d_ff=FF, n_experts=E, capacity_factor=cf, top_k=top_k)
    return jmoe.MoEConfig(dtype=JDT[dtype], **kw), tmoe.MoEConfig(dtype=dtype, **kw)


def inputs(seed, pad):
    """JAX params (numpy), x [3, 40, D] and a valid mask (None without
    padding), all from ``seed``."""
    jcfg, _ = configs(1, 1.0)
    params = jax.tree.map(np.asarray, jmoe.init_params(jax.random.key(seed), jcfg))
    rng = np.random.default_rng(seed)
    x = rng.normal(size=SHAPE + (D,)).astype(np.float32)
    valid = rng.random(SHAPE) >= pad if pad else None
    return params, x, valid


def torch_params(params, requires_grad=False):
    return {k: torch.tensor(v, requires_grad=requires_grad) for k, v in params.items()}


def t_valid(valid):
    return None if valid is None else torch.from_numpy(valid)


def j_valid(valid):
    return None if valid is None else jnp.asarray(valid)


def assert_diag_equal(got, want, tol=F32_TOL):
    assert sorted(got) == sorted(want) == ["dropped_fraction", "expert_kept", "expert_tokens",
                                             "gate_entropy"]
    for k in ("expert_tokens", "expert_kept"):
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)
    for k in ("dropped_fraction", "gate_entropy"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), **tol, err_msg=k)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", list(CASES))
def test_moe_apply_matches_jax(case, dtype):
    top_k, cf, pad = CASES[case]
    jcfg, tcfg = configs(top_k, cf, dtype)
    params, x, valid = inputs(1, pad)
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    jy, jaux, jdiag = jmoe.moe_apply(params, jnp.asarray(x).astype(JDT[dtype]), jcfg,
                                     valid=j_valid(valid), diagnostics=True)
    with torch.no_grad():
        ty, taux, tdiag = tmoe.moe_apply(torch_params(params), torch.from_numpy(x).to(dtype), tcfg,
                                         valid=t_valid(valid), diagnostics=True)
    assert ty.shape == x.shape and ty.dtype == dtype and taux.dtype == torch.float32
    np.testing.assert_allclose(ty.float().numpy(), np.asarray(jy, np.float32), **tol)
    np.testing.assert_allclose(float(taux), float(jaux), **F32_TOL)
    assert_diag_equal(tdiag, jdiag)
    if valid is not None:
        assert not ty.float().numpy()[~valid].any()  # padding gets no output
    # without diagnostics: the same (y, aux)
    with torch.no_grad():
        y2, aux2 = tmoe.moe_apply(torch_params(params), torch.from_numpy(x).to(dtype), tcfg,
                                  valid=t_valid(valid))
    assert torch.equal(y2, ty) and torch.equal(aux2, taux)


@pytest.mark.parametrize("case", list(CASES))
def test_moe_apply_matches_the_oracle(case):
    top_k, cf, pad = CASES[case]
    _, tcfg = configs(top_k, cf)
    params, x, valid = inputs(2, pad)
    with torch.no_grad():
        ty, _, tdiag = tmoe.moe_apply(torch_params(params), torch.from_numpy(x), tcfg,
                                      valid=t_valid(valid), diagnostics=True)
    jcfg, _ = configs(top_k, cf)
    want, wdiag = jmoe.moe_reference(params, x, jcfg, valid=valid, return_diag=True)
    got_ref, gdiag = tmoe.moe_reference(torch_params(params), torch.from_numpy(x), tcfg,
                                        valid=t_valid(valid), return_diag=True)
    np.testing.assert_allclose(ty.numpy(), want, **F32_TOL)
    np.testing.assert_array_equal(got_ref, want)  # the port's copy of the oracle
    assert_diag_equal(tdiag, wdiag)
    assert_diag_equal(gdiag, wdiag, tol=dict(atol=0, rtol=0))


@pytest.mark.parametrize("case", list(CASES))
def test_gradients_match_jax(case):
    top_k, cf, pad = CASES[case]
    jcfg, tcfg = configs(top_k, cf)
    params, x, valid = inputs(3, pad)
    cot = np.random.default_rng(30).normal(size=x.shape).astype(np.float32)

    def jloss(p, xx):
        y, aux = jmoe.moe_apply(p, xx, jcfg, valid=j_valid(valid))
        return jnp.sum(y * cot) + 3.0 * aux

    jg_p, jg_x = jax.grad(jloss, argnums=(0, 1))(jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    tp = torch_params(params, requires_grad=True)
    tx = torch.tensor(x, requires_grad=True)
    y, aux = tmoe.moe_apply(tp, tx, tcfg, valid=t_valid(valid))
    (torch.sum(y * torch.from_numpy(cot)) + 3.0 * aux).backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jg_x), **F32_TOL)
    for k in ("router", "w_in", "w_out"):
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(jg_p[k]), **F32_TOL, err_msg=k)


@pytest.mark.parametrize("case", list(CASES))
def test_routing_equals_jax_dispatch(case):
    """Both routings on the JAX router probabilities: every kept
    assignment in the same (expert, queue position) with the same gate,
    each rank's expert the oracle's pick."""
    top_k, cf, pad = CASES[case]
    jcfg, tcfg = configs(top_k, cf)
    params, x, valid = inputs(4, pad)
    xt = x.reshape(-1, D)
    t = xt.shape[0]
    c = tmoe._capacity(t, tcfg)
    assert c == jmoe._capacity(t, jcfg)
    probs = np.array(jax.nn.softmax(jnp.asarray(xt) @ jnp.asarray(params["router"]), axis=-1))
    vflat = None if valid is None else valid.reshape(-1)
    jdisp, jcomb, jfirst, jrouted, jkept = (np.asarray(a) for a in jmoe._route(
        jnp.asarray(probs), jcfg, c, None if vflat is None else jnp.asarray(vflat, jnp.float32)))
    r = tmoe._route(torch.from_numpy(probs), tcfg, c, None if vflat is None else torch.from_numpy(vflat))
    disp = np.zeros((t, E, c), np.float32)
    comb = np.zeros((t, E, c), np.float32)
    for rank in range(top_k):
        for i in np.nonzero(r.kept[rank].numpy())[0]:
            e_i = int(r.expert[rank, i])
            pos = int(r.slot[rank, i]) - e_i * c
            assert 0 <= pos < c
            disp[i, e_i, pos] = 1.0
            comb[i, e_i, pos] = float(r.gate[rank, i])
    np.testing.assert_array_equal(disp, jdisp)
    np.testing.assert_allclose(comb, jcomb, atol=0, rtol=0)
    np.testing.assert_array_equal(r.slot.numpy()[~r.kept.numpy()], E * c)
    np.testing.assert_array_equal(r.first.numpy(), jfirst)
    np.testing.assert_array_equal(r.routed.numpy(), jrouted)
    np.testing.assert_array_equal(r.kept_total.numpy(), jkept)
    ok = np.ones(t, bool) if vflat is None else vflat
    picks = np.argsort(-probs, axis=-1, kind="stable")[:, :top_k].T        # [k, T]
    np.testing.assert_array_equal(r.expert.numpy()[:, ok], picks[:, ok])
    assert not r.kept.numpy()[:, ~ok].any()
    assert not r.gate.numpy()[:, ~ok].any()


@pytest.mark.parametrize("tokens", [1, 7, 120, 2048, 4096])
@pytest.mark.parametrize("top_k,cf", [(1, 1.25), (2, 1.25), (2, 0.25), (1, 0.01), (2, 1.0)])
def test_capacity_is_the_jax_expression(tokens, top_k, cf):
    jcfg, tcfg = configs(top_k, cf)
    assert tmoe._capacity(tokens, tcfg) == jmoe._capacity(tokens, jcfg)


def test_tight_capacity_drops_second_choices_first():
    params, x, _ = inputs(5, 0.0)
    _, loose = configs(2, 1.25)
    _, tight = configs(2, 0.5)
    with torch.no_grad():
        _, _, d_loose = tmoe.moe_apply(torch_params(params), torch.from_numpy(x), loose,
                                       diagnostics=True)
        probs = tmoe._router_probs(torch_params(params), torch.from_numpy(x).reshape(-1, D))
        r = tmoe._route(probs, tight, tmoe._capacity(120, tight))
    assert float(d_loose["dropped_fraction"]) == 0.0
    # capacity 30 a expert for 120 first choices: a rank-1 assignment keeps
    # a slot only where an expert's first choices left room, never before
    # a first choice of the same expert
    kept = r.kept.numpy()
    first_per_expert = np.bincount(r.expert.numpy()[0], minlength=E)
    for e in range(E):
        rank1 = kept[1][r.expert.numpy()[1] == e].sum()
        rank0 = kept[0][r.expert.numpy()[0] == e].sum()
        assert rank0 == min(first_per_expert[e], 30)
        assert rank1 == max(0, min(30 - first_per_expert[e], (r.expert.numpy()[1] == e).sum()))
    assert kept[1].sum() < kept[0].sum()


def test_deterministic_repeats():
    params, x, valid = inputs(6, 0.25)
    _, tcfg = configs(2, 1.25)
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        outs = []
        for _ in range(2):
            tp = torch_params(params, requires_grad=True)
            tx = torch.tensor(x, requires_grad=True)
            y, aux = tmoe.moe_apply(tp, tx, tcfg, valid=t_valid(valid))
            (y.square().sum() + aux).backward()
            outs.append([y.detach(), aux.detach(), tx.grad] + [tp[k].grad for k in sorted(tp)])
    finally:
        torch.use_deterministic_algorithms(prev)
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_init_params_shapes():
    _, tcfg = configs(2, 1.25)
    p = tmoe.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    jp = jmoe.init_params(jax.random.key(0), configs(2, 1.25)[0])
    assert {k: tuple(v.shape) for k, v in p.items()} == {k: v.shape for k, v in jp.items()}
    assert all(v.dtype == torch.float32 for v in p.values())


@pytest.mark.parametrize("top_k", [0, E + 1])
def test_bad_top_k_raises(top_k):
    _, tcfg = configs(top_k, 1.25)
    params, x, _ = inputs(7, 0.0)
    with pytest.raises(ValueError, match="top_k"):
        tmoe.moe_apply(torch_params(params), torch.from_numpy(x), tcfg)


def _placements(spec, names, ndim) -> list:
    """A JAX PartitionSpec as the port's placements, one per mesh axis."""
    dims = list(spec) + [None] * (ndim - len(spec))
    return [f"Shard(dim={dims.index(n)})" if n in dims else "Replicate()" for n in names]


@pytest.mark.parametrize("fn", ["moe_apply_ep", "moe_ep_body", "param_shardings"])
def test_expert_parallel_entry_points_raise(fn):
    """Each expert-parallel entry point raises what the JAX one raises, and
    runs where JAX runs (module docstring)."""
    from jax.sharding import Mesh

    if fn == "moe_apply_ep":
        # JAX's test_indivisible_shapes_rejected, on a mapping of axis sizes:
        # the shape checks come before any collective
        _, tcfg = configs(1, 1.25)
        params, _, _ = inputs(0, 0.0)
        x = torch.zeros(2, 15, D)
        with pytest.raises(ValueError, match="token dim"):
            tmoe.moe_apply_ep(torch_params(params), x, tcfg, {"expert": 4})
        six = tmoe.MoEConfig(d_model=D, d_ff=FF, n_experts=6)
        p6 = tmoe.init_params(six, torch.Generator().manual_seed(0), device="cpu")
        with pytest.raises(ValueError, match="n_experts"):
            tmoe.moe_apply_ep(p6, torch.zeros(2, 16, D), six, {"expert": 4})
        # a mapping (one card) with a real expert axis is not a mesh of ranks
        with pytest.raises(OptionNotPortedError, match="DeviceMesh"):
            tmoe.moe_apply_ep(torch_params(params), torch.zeros(2, 16, D), tcfg, {"expert": 2})
    elif fn == "moe_ep_body":
        # one rank: the body of JAX's moe_apply_ep on a one-device mesh
        jcfg, tcfg = configs(2, 0.75)
        params, x, valid = inputs(3, 0.25)
        mesh = Mesh(np.array(jax.devices()[:1]), ("expert",))
        jy, jaux, jdiag = jmoe.moe_apply_ep(params, jnp.asarray(x), jcfg, mesh,
                                            valid=j_valid(valid), diagnostics=True)
        y, aux, diag = tmoe.moe_ep_body(torch_params(params), torch.from_numpy(x), tcfg,
                                        "expert", valid_local=t_valid(valid), diagnostics=True)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), **F32_TOL)
        np.testing.assert_allclose(float(aux), float(jaux), **F32_TOL)
        for k in jdiag:
            np.testing.assert_allclose(diag[k].numpy(), np.asarray(jdiag[k]), **F32_TOL)
        np.testing.assert_allclose(y.numpy(), tmoe.moe_reference(params, x, tcfg, valid=valid),
                                   **F32_TOL)
        with pytest.raises(ValueError, match="shard_experts"):
            half = dict(torch_params(params), w_in=torch.zeros(2, D, FF))
            tmoe.moe_ep_body(half, torch.from_numpy(x), tcfg, "expert")
    else:
        mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("data", "model"))
        want = {k: _placements(v.spec, mesh.axis_names, 3)
                for k, v in jmoe.param_shardings(mesh).items()}
        got = {k: [repr(p) for p in v]
               for k, v in tmoe.param_shardings({"data": 2, "model": 4}).items()}
        assert got == want and want["w_in"] == ["Replicate()", "Shard(dim=0)"]
        with pytest.raises(ValueError, match="not found in mesh"):
            jmoe.param_shardings(mesh, expert_axis="expert")
        with pytest.raises(ValueError, match="not found in mesh"):
            tmoe.param_shardings({"data": 2, "model": 4}, expert_axis="expert")
        with pytest.raises(TypeError, match="required positional argument"):
            tmoe.param_shardings()
