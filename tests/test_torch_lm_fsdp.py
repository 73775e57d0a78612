"""The LM's FSDP over gloo ranks against the JAX package's sharded step.

``lm.SpecLayout`` / ``param_specs`` / ``param_shardings`` /
``batch_shardings`` are held to the JAX functions as tables: every method
and every combination of the three axes, the parameter trees with the
dense and the MoE FFN, and the refusals (a dim the fsdp axis does not
divide raises ``ValueError`` on both sides; stages are 8h here; the
expert axis with fsdp places as JAX's does).

One gloo group of 4 CPU processes is spawned once for the module, every
process running this file as its worker (``python test_torch_lm_fsdp.py
worker SPEC``, importing only the port). On {data 2, fsdp 2}, {fsdp 4} and
{seq 2, fsdp 2} (the zigzag ring with best_fit packed ``segments``) each
rank loads the JAX weights through ``interop``, keeps its slices
(``lm.shard_params``), takes three Adam steps of ``lm.train_step`` on its
rows on 'data' and gathers the result (``lm.unshard_params``). This
process runs the JAX ``train_step`` under jit on 4 of the 8 CPU devices,
the weights placed by the JAX ``param_shardings(fsdp_axis="fsdp")`` and
the tokens on 'data', and holds every rank to it in float32: the losses at
rel 1e-5; the gathered parameters at abs 1e-5, and each rank's slices
equal to JAX's addressable shard of its device (entries whose gradient
came within 1e-6 of zero held to Adam's step bound, as
``test_torch_seq_mesh.py`` explains); the first step's gathered gradients
against ``jax.grad`` at 1e-5 of each tensor's largest (Adam is blind to a
gradient counted twice over fsdp, this is not); every 2D+ weight and its
Adam moments held as a slice. The ranks' at-rest bytes (parameters and
Adam state, ``harness.report_fsdp_param_bytes``) shrink as in JAX's
``test_param_bytes_shrink_linearly_in_fsdp``.

Then ``train_lm --mesh dp_fsdp --device cpu`` over 4 ranks ({data 2,
fsdp 2}) against one process, its checkpoints resumed under ``dp`` and a
``dp`` run's under ``dp_fsdp``, and its spool read by JAX's
``tools/tfrecord_doctor.py train``. Every spawn is waited on with a
timeout that kills it and fails.
"""

import functools
import itertools
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_torch_dlrm_mesh import (  # noqa: E402
    _as_placements, _free_port, _low_priority, _quiet_env, _wait_all)
from test_torch_seq_mesh import _flat, _flat_shardings, _leaf_map, _lm_steps, _unflat  # noqa: E402

GROUP = 4
GROUP_TIMEOUT_S = 120
TWIN_TIMEOUT_S = 120
STEPS = 3
RTOL_LOSS = 1e-5
ATOL_PARAM = 1e-5
RTOL_GRAD = 1e-5          # of the tensor's largest |gradient|
NEAR_ZERO = 1e-6
LR = 3e-3
BATCH = 8
LM = dict(vocab_size=64, d_model=16, n_heads=4, n_layers=2, max_len=16)
MEMORY_LM = dict(LM, n_layers=4)   # JAX's memory test's model
# (mesh, the step's axes, packed segments?)
CASES = {
    "data2_fsdp2": ({"data": 2, "fsdp": 2}, dict(data_axis="data", fsdp_axis="fsdp"), False),
    "fsdp4": ({"fsdp": 4}, dict(fsdp_axis="fsdp"), False),
    "seq2_fsdp2_segments": ({"seq": 2, "fsdp": 2}, dict(seq_axis="seq", fsdp_axis="fsdp"), True),
}
MEMORY = {1: {"data": 4, "fsdp": 1}, 2: {"data": 2, "fsdp": 2}, 4: {"fsdp": 4}}
AXIS_NAMES = ("fsdp", "pipe", "expert")


# -- the tables ----------------------------------------------------------------------


def _layouts():
    """Every (fsdp_axis, pipe_axis, expert_axis) with each None or named."""
    return list(itertools.product(*[(None, name) for name in AXIS_NAMES]))


def _as_tuples(tree):
    """A tree of JAX PartitionSpecs (or port specs) as a tree of tuples."""
    if isinstance(tree, dict):
        return {k: _as_tuples(v) for k, v in tree.items()}
    return tuple(tree)


@pytest.mark.parametrize("axes", _layouts())
def test_spec_layout_matches_jax(axes):
    """Each ``SpecLayout`` method gives JAX's spec, as a tuple, for every
    combination of the three axes; the defaults are JAX's."""
    from tpu_tfrecord.models import lm as jlm
    from tpu_tfrecord_torch.models import lm as tlm

    kw = dict(zip(("fsdp_axis", "pipe_axis", "expert_axis"), axes))
    j, t = jlm.SpecLayout(**kw), tlm.SpecLayout(**kw)
    for method in ("embed", "pos", "head", "block_dense", "moe"):
        assert getattr(t, method)() == _as_tuples(getattr(j, method)()), method
    assert tlm.SpecLayout() == tlm.SpecLayout(None, None, None)
    assert (tlm.SpecLayout().fsdp_axis, tlm.SpecLayout().pipe_axis,
            tlm.SpecLayout().expert_axis) == (None, None, None)


@pytest.mark.parametrize("moe", [0, 4])
def test_param_specs_match_jax(moe):
    """``param_specs`` mirrors the port's tree leaf for leaf (the ``moe``
    subtree included) with JAX's specs of the JAX tree, every layout."""
    import jax

    from tpu_tfrecord.models import lm as jlm
    from tpu_tfrecord_torch.models import lm as tlm

    jp = jlm.init_params(jax.random.key(0), jlm.LMConfig(moe_experts=moe, **LM))
    tp = tlm.init_params(tlm.LMConfig(moe_experts=moe, **LM), device="cpu")
    for axes in _layouts():
        kw = dict(zip(("fsdp_axis", "pipe_axis", "expert_axis"), axes))
        want = _as_tuples(jlm.param_specs(jp, jlm.SpecLayout(**kw)))
        assert tlm.param_specs(tp, tlm.SpecLayout(**kw)) == want, kw
    assert ("moe" in tlm.param_specs(tp, tlm.SpecLayout())["blocks"]) == bool(moe)


def _jax_mesh(axes: dict):
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()[:int(np.prod(list(axes.values())))]).reshape(
        tuple(axes.values())), tuple(axes))


def _jax_param_placements(axes: dict, params) -> dict:
    """JAX's ``param_shardings(fsdp_axis="fsdp")`` on ``axes`` as the port's
    placements by flat key."""
    from tpu_tfrecord.models import lm as jlm

    flat = _flat(params)
    return {k: _as_placements(s.spec, flat[k].ndim, tuple(axes), False)
            for k, s in _flat_shardings(jlm.param_shardings(_jax_mesh(axes), params,
                                                            fsdp_axis="fsdp")).items()}


@pytest.mark.parametrize("axes", [{"fsdp": 2}, {"data": 2, "fsdp": 4}, {"seq": 2, "fsdp": 2},
                                  {"fsdp": 8}])
def test_param_and_batch_shardings_match_jax_on_a_mapping(axes):
    """On a mapping of axis sizes the placements are JAX's
    ``NamedSharding`` specs (the ``DeviceMesh`` case runs in the ranks)."""
    import jax

    from tpu_tfrecord.models import lm as jlm
    from tpu_tfrecord_torch.models import lm as tlm

    jp = jax.tree.map(np.asarray, jlm.init_params(jax.random.key(0), jlm.LMConfig(**LM)))
    tp = tlm.init_params(tlm.LMConfig(**LM), device="cpu")
    got = tlm.param_shardings(axes, tp, fsdp_axis="fsdp")
    flat = _flat(_leaf_map(lambda _: np.zeros(()), tp))
    got = {k: [repr(p) for p in v] for k, v in zip(flat, _placements_in_order(got, flat))}
    assert got == _jax_param_placements(axes, jp)
    if "data" in axes:
        want = _as_placements(jlm.batch_shardings(_jax_mesh(axes))["tokens"].spec, 2,
                              tuple(axes), False)
        assert [repr(p) for p in tlm.batch_shardings(axes)["tokens"]] == want


def _placements_in_order(tree, flat: dict) -> list:
    from test_torch_seq_mesh import _leaves_in_order

    return _leaves_in_order(tree, flat)


def test_shardings_refuse_as_jax_does():
    """A dim the fsdp axis does not divide: ``ValueError`` on both sides
    (JAX at placement); a data axis the mesh lacks: ``ValueError`` on both;
    stages: ``OptionNotPortedError`` naming 8h. The expert axis with fsdp
    places as JAX's ``param_shardings`` does (``SpecLayout.moe``'s expert
    x fsdp layout)."""
    import jax

    from tpu_tfrecord.models import lm as jlm
    from tpu_tfrecord_torch.models import lm as tlm
    from tpu_tfrecord_torch.options import OptionNotPortedError

    jp = jlm.init_params(jax.random.key(0), jlm.LMConfig(**LM))
    tp = tlm.init_params(tlm.LMConfig(**LM), device="cpu")
    three = {"fsdp": 3}
    with pytest.raises(ValueError, match="divisible by 3"):
        jax.device_put(jp, jlm.param_shardings(_jax_mesh(three), jp, fsdp_axis="fsdp"))
    with pytest.raises(ValueError, match="divisible by 3"):
        tlm.param_shardings(three, tp, fsdp_axis="fsdp")
    with pytest.raises(ValueError, match="not found in mesh"):
        jlm.batch_shardings(_jax_mesh(three))
    with pytest.raises(ValueError, match="not found in mesh"):
        tlm.batch_shardings(three)
    with pytest.raises(OptionNotPortedError, match="pipe_axis.*8h"):
        tlm.param_shardings({"pipe": 2}, tp, pipe_axis="pipe")
    axes = {"expert": 2, "fsdp": 2}
    jmoe = jlm.init_params(jax.random.key(0), jlm.LMConfig(moe_experts=4, **LM))
    tmoe = tlm.init_params(tlm.LMConfig(moe_experts=4, **LM), device="cpu")
    flat = _flat(jax.tree.map(np.asarray, jmoe))
    want = {k: _as_placements(sh.spec, flat[k].ndim, tuple(axes), False)
            for k, sh in _flat_shardings(jlm.param_shardings(
                _jax_mesh(axes), jmoe, expert_axis="expert", fsdp_axis="fsdp")).items()}
    got = tlm.param_shardings(axes, tmoe, expert_axis="expert", fsdp_axis="fsdp")
    got = {k: [repr(p) for p in v] for k, v in zip(flat, _placements_in_order(got, flat))}
    assert got == want
    assert want["blocks/moe/w_in"] == ["Shard(dim=1)", "Shard(dim=2)"]


@pytest.mark.parametrize("axes,name", [
    (dict(mesh={"fsdp": 2}, fsdp_axis="fsdp"), "fsdp_axis"),
    (dict(mesh={"data": 1}, data_axis="data", fsdp_axis="fsdp"), "fsdp_axis"),
    (dict(mesh=object(), fsdp_axis="fsdp"), "mesh"),
])
def test_fsdp_off_a_device_mesh_refused(axes, name):
    """FSDP runs over a ``DeviceMesh`` of ranks only: on one card's mapping
    mesh, or on something else, it raises ``OptionNotPortedError``."""
    from tpu_tfrecord_torch.models import lm as tlm
    from tpu_tfrecord_torch.options import OptionNotPortedError

    cfg = tlm.LMConfig(**LM)
    toks = torch.from_numpy(tlm.make_synthetic_tokens(cfg, 2))
    with pytest.raises(OptionNotPortedError, match=name):
        tlm.loss_fn(tlm.init_params(cfg, device="cpu"), toks, cfg, **axes)


def test_fsdp_path_uses_no_dtensor_collective_or_torch_fsdp():
    """The LM's FSDP path (``models/lm.py``, ``models/sharded.py``,
    ``train_lm.py``, ``harness.py``) calls no ``torch.distributed``
    function but ``all_reduce`` and the list ``all_gather`` (the two gloo
    runs on CUDA tensors), and neither DTensor's ``full_tensor`` /
    ``from_local`` / ``redistribute`` nor torch's ``fully_shard``."""
    import ast

    calls = set()
    for rel in ("models/lm.py", "models/sharded.py", "train_lm.py", "harness.py"):
        tree = ast.parse(open(os.path.join(REPO, "tpu_tfrecord_torch", rel)).read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name) \
                    and node.value.id == "dist":
                calls.add(node.attr)
            name = node.attr if isinstance(node, ast.Attribute) else getattr(node, "id", None)
            assert name not in ("full_tensor", "from_local", "redistribute", "fully_shard",
                                "FullyShardedDataParallel", "reduce_scatter"), (rel, name)
    assert calls == {"all_reduce", "all_gather"}


# -- the worker (imports the port only) -------------------------------------------


def _run_case(spec: dict, name: str, mesh) -> tuple:
    import torch.distributed as dist

    from tpu_tfrecord_torch import interop
    from tpu_tfrecord_torch.models import lm, optim, sharded

    _, kw, _ = CASES[name]
    data = np.load(os.path.join(spec["dir"], f"{name}.npz"))
    params = _unflat({k[2:]: data[k] for k in data.files if k.startswith("p/")})
    batches = [{k.split("/")[2]: data[k] for k in data.files if k.startswith(f"b/{s}/")}
               for s in range(STEPS)]
    cfg = lm.LMConfig(dtype=torch.float32, **LM)
    tp = lm.shard_params(interop.lm_params_from_jax(params, cfg, device="cpu"), mesh)
    opt = optim.adam(tp, LR)
    di, per = sharded.axis_index(mesh, "data"), BATCH // sharded.axis_size(mesh, "data")
    rows = lambda a: torch.from_numpy(a[di * per:(di + 1) * per])  # noqa: E731
    losses, near_zero, grads = [], None, {}
    for s, host in enumerate(batches):
        segs = rows(host["segments"]) if "segments" in host else None
        losses.append(float(lm.train_step(tp, opt, rows(host["tokens"]), cfg, mesh=mesh,
                                          segments=segs, **kw)))
        shard_grads = _leaf_map(lambda p: p.grad.detach().clone(), tp)
        if s == 0:
            grads = _flat(interop.lm_params_to_jax(lm.unshard_params(shard_grads, mesh)))
        masks = _leaf_map(lambda g: ((g != 0) & (g.abs() < NEAR_ZERO)).float(), shard_grads)
        near_zero = masks if near_zero is None else _leaf_map2(torch.maximum, near_zero, masks)
    dist.barrier()
    whole = lm.unshard_params(tp, mesh)
    adam = optim.adam_state(tp, opt)[0]
    arrays = {f"{name}/param/{k}": v for k, v in _flat(interop.lm_params_to_jax(whole)).items()}
    arrays.update({f"{name}/shard/{k}": v for k, v in _flat(interop.lm_params_to_jax(tp)).items()})
    arrays.update({f"{name}/grad/{k}": v for k, v in grads.items()})
    for tag, tree in (("near_zero", lm.unshard_params(near_zero, mesh)),
                      ("shard_near_zero", near_zero)):
        arrays.update({f"{name}/{tag}/{k}": v > 0
                       for k, v in _flat(interop.lm_params_to_jax(tree)).items()})
    shapes = {"param": {k: list(v.shape) for k, v in _flat(interop.lm_params_to_jax(tp)).items()},
              "exp_avg": {k: list(v.shape) for k, v in
                          _flat(interop.lm_params_to_jax(adam.mu)).items()},
              "exp_avg_sq": {k: list(v.shape) for k, v in
                             _flat(interop.lm_params_to_jax(adam.nu)).items()}}
    return {"losses": losses, "shapes": shapes}, arrays


def _leaf_map2(fn, a, b):
    if isinstance(a, dict):
        return {k: _leaf_map2(fn, v, b[k]) for k, v in a.items()}
    return fn(a, b)


def _at_rest_bytes(mesh) -> int:
    """This rank's bytes of the slices of a fresh 4-layer LM and of its
    Adam state (``harness.report_fsdp_param_bytes``)."""
    from tpu_tfrecord_torch import harness
    from tpu_tfrecord_torch.models import lm, optim

    cfg = lm.LMConfig(**MEMORY_LM)
    tp = lm.shard_params(lm.init_params(cfg, device="cpu"), mesh)
    return harness.report_fsdp_param_bytes(optim.train_state(tp, optim.adam(tp, LR)))


def run_worker(spec: dict) -> dict:
    sys.path.insert(0, REPO)
    from tpu_tfrecord_torch.device import distributed, mesh as meshes
    from tpu_tfrecord_torch.models import lm

    distributed.initialize(spec["addr"], GROUP, spec["rank"])
    made = {}

    def mesh_of(axes):
        key = json.dumps(axes)
        if key not in made:
            made[key] = meshes.create_mesh(axes, device_type="cpu")
        return made[key]

    out, arrays = {"shardings": {}}, {}
    cfg = lm.LMConfig(dtype=torch.float32, **LM)
    template = lm.init_params(cfg, device="cpu")
    flat = _flat(_leaf_map(lambda _: np.zeros(()), template))
    for name, (axes, _, _) in CASES.items():
        mesh = mesh_of(axes)
        placed = lm.param_shardings(mesh, template, fsdp_axis="fsdp")
        out["shardings"][name] = {
            "params": {k: [repr(p) for p in v]
                       for k, v in zip(flat, _placements_in_order(placed, flat))},
            "coords": {a: int(mesh.get_local_rank(a)) for a in axes}}
        if "data" in axes:
            out["shardings"][name]["batch"] = [repr(p) for p in
                                               lm.batch_shardings(mesh)["tokens"]]
        out[name], arr = _run_case(spec, name, mesh)
        arrays.update(arr)
    out["bytes"] = {str(n): _at_rest_bytes(mesh_of(axes)) for n, axes in MEMORY.items()}
    np.savez(os.path.join(spec["results"], f"rank{spec['rank']}.npz"), **arrays)
    return out


# -- the JAX side (this process) -------------------------------------------------


def _inputs(name: str):
    """The JAX weights and STEPS global batches of ``name`` (numpy)."""
    import jax
    import jax.numpy as jnp

    from tpu_tfrecord.models import lm as jlm
    from tpu_tfrecord.tpu.ingest import TokenPacker

    cfg = jlm.LMConfig(dtype=jnp.float32, **LM)
    params = jax.tree.map(np.asarray, jlm.init_params(jax.random.key(5), cfg))
    if not CASES[name][2]:
        return cfg, params, [{"tokens": jlm.make_synthetic_tokens(cfg, BATCH, seed=40 + s)}
                             for s in range(STEPS)]
    rng, batches = np.random.default_rng(11), []
    pk = TokenPacker(BATCH, LM["max_len"], packing="best_fit")
    while len(batches) < STEPS:
        pk.feed_docs(rng.integers(1, LM["vocab_size"], size=int(n))
                     for n in rng.integers(1, 12, size=12))
        b = pk.pop()
        if b is not None:
            batches.append({"tokens": b["tokens"], "segments": b["segment_ids"]})
    return cfg, params, batches


def _jax_run(name: str, cfg, params, batches) -> dict:
    """The JAX sharded step under jit: losses, final parameters, each
    device's addressable shards, the first step's gradients."""
    import jax
    import optax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from tpu_tfrecord.models import lm as jlm

    axes, kw, _ = CASES[name]
    mesh = _jax_mesh(axes)
    tx = optax.adam(LR)
    p = jax.device_put(params, jlm.param_shardings(mesh, params, fsdp_axis="fsdp"))
    step = jax.jit(functools.partial(jlm.train_step, cfg=cfg, tx=tx, mesh=mesh, **kw))
    grad = jax.jit(jax.grad(functools.partial(jlm.loss_fn, cfg=cfg, mesh=mesh, **kw)))
    rows = NamedSharding(mesh, P(kw.get("data_axis"), None))

    def call(fn, p, *a, h):
        segs = jax.device_put(h["segments"], rows) if "segments" in h else None
        return fn(p, *a, jax.device_put(h["tokens"], rows), segments=segs)

    state = tx.init(p)
    losses, grads = [], None
    for h in batches:
        if grads is None:
            grads = _flat(jax.tree.map(np.asarray, call(grad, p, h=h)))
        p, state, loss = call(step, p, state, h=h)
        losses.append(float(loss))
    devices = list(mesh.devices.flat)
    shards = [_flat(jax.tree.map(
        lambda a, d=d: np.asarray(next(s.data for s in a.addressable_shards if s.device == d)),
        p)) for d in devices]
    return {"losses": losses, "params": _flat(jax.tree.map(np.asarray, p)), "grads": grads,
            "shards": shards}


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """Spawn the 4-rank group once; returns (JAX runs by case, rank
    results, rank arrays by rank)."""
    base = str(tmp_path_factory.mktemp("lm_fsdp"))
    spec = {"dir": base, "results": os.path.join(base, "results"),
            "addr": f"127.0.0.1:{_free_port()}"}
    os.makedirs(spec["results"])
    inputs = {}
    for name in CASES:
        inputs[name] = _inputs(name)
        _, params, batches = inputs[name]
        arrays = {f"p/{k}": v for k, v in _flat(params).items()}
        for s, host in enumerate(batches):
            arrays.update({f"b/{s}/{k}": v for k, v in host.items()})
        np.savez(os.path.join(base, f"{name}.npz"), **arrays)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "worker", json.dumps(dict(spec, rank=r))],
        cwd=REPO, env=_quiet_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        preexec_fn=_low_priority) for r in range(GROUP)]
    # the JAX side runs while the ranks start up
    jax_runs = {name: _jax_run(name, *inputs[name]) for name in CASES}
    logs = _wait_all(procs, GROUP_TIMEOUT_S, f"the group of {GROUP}")
    bad = [(r, rc, err[-3000:]) for r, (rc, _, err) in enumerate(logs) if rc != 0]
    assert not bad, bad
    ranks = [json.load(open(os.path.join(spec["results"], f"rank{r}.json")))
             for r in range(GROUP)]
    arrays = [dict(np.load(os.path.join(spec["results"], f"rank{r}.npz")))
              for r in range(GROUP)]
    return inputs, jax_runs, ranks, arrays


@pytest.mark.parametrize("name", list(CASES))
def test_device_mesh_shardings_match_jax(group, name):
    """On each rank's ``DeviceMesh`` the parameter and token placements are
    JAX's; the rank's coordinates are its JAX device's."""
    from tpu_tfrecord.models import lm as jlm

    inputs, _, ranks, _ = group
    axes = CASES[name][0]
    want = _jax_param_placements(axes, inputs[name][1])
    assert want["embed"][list(axes).index("fsdp")] == "Shard(dim=0)"
    assert want["blocks/qkv/w"][list(axes).index("fsdp")] == "Shard(dim=1)"
    assert set(map(tuple, (want[k] for k in want if k.endswith("/b")))) == {
        ("Replicate()",) * len(axes)}
    for r, res in enumerate(ranks):
        got = res["shardings"][name]
        assert got["params"] == want
        assert list(got["coords"].values()) == list(np.unravel_index(r, tuple(axes.values())))
        if "data" in axes:
            assert got["batch"] == _as_placements(
                jlm.batch_shardings(_jax_mesh(axes))["tokens"].spec, 2, tuple(axes), False)


@pytest.mark.parametrize("name", list(CASES))
def test_fsdp_losses_match_jax(group, name):
    _, jax_runs, ranks, _ = group
    for res in ranks:
        np.testing.assert_allclose(res[name]["losses"], jax_runs[name]["losses"],
                                   rtol=RTOL_LOSS, atol=0)
    assert all(res[name]["losses"] == ranks[0][name]["losses"] for res in ranks)


def _held(got: np.ndarray, want: np.ndarray, mask: np.ndarray, what: str) -> None:
    """``got`` within ATOL_PARAM of ``want``; the masked entries within
    Adam's bound of STEPS steps of lr."""
    got, want = got.copy(), want.copy()
    if mask.any():
        assert np.abs(got[mask] - want[mask]).max() <= STEPS * LR * (1 + 1e-3), what
        got[mask] = want[mask] = 0.0
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL_PARAM, err_msg=what)


@pytest.mark.parametrize("name", list(CASES))
def test_fsdp_params_match_jax(group, name):
    """After three steps ``unshard_params`` of every rank is JAX's
    parameters, and each rank's slices are JAX's addressable shard of its
    device (the near-zero-gradient entries, few, at Adam's step bound)."""
    _, jax_runs, _, arrays = group
    want = jax_runs[name]["params"]
    for r, arr in enumerate(arrays):
        pick = lambda tag: {k.split(f"/{tag}/", 1)[1]: v for k, v in arr.items()  # noqa: E731
                            if k.startswith(f"{name}/{tag}/")}
        got, masks = pick("param"), pick("near_zero")
        assert sorted(got) == sorted(want)
        assert sum(int(m.sum()) for m in masks.values()) < 0.02 * sum(
            w.size for w in want.values())
        for key, w in want.items():
            _held(got[key], w, masks[key], f"{name} {key}")
        shards, shard_masks = pick("shard"), pick("shard_near_zero")
        for key, w in jax_runs[name]["shards"][r].items():
            assert shards[key].shape == w.shape, key
            _held(shards[key], w, shard_masks[key], f"{name} rank {r} shard {key}")


@pytest.mark.parametrize("name", list(CASES))
def test_fsdp_gradients_match_jax_grad(group, name):
    """The first step's gradients, each rank's slices gathered over fsdp
    (summed over 'seq' by ``copy_to`` and over 'data' by ``sum_grads``),
    equal ``jax.grad`` of the JAX loss: a sum over fsdp would double them."""
    _, jax_runs, _, arrays = group
    want = jax_runs[name]["grads"]
    for arr in arrays:
        got = {k.split("/grad/", 1)[1]: v for k, v in arr.items()
               if k.startswith(f"{name}/grad/")}
        assert sorted(got) == sorted(want)
        for key, w in want.items():
            scale = np.abs(w).max()
            if scale == 0:
                assert np.abs(got[key]).max() == 0, key
                continue
            np.testing.assert_allclose(got[key], w, rtol=0, atol=RTOL_GRAD * scale,
                                       err_msg=f"{name} {key}")


@pytest.mark.parametrize("name", list(CASES))
def test_ranks_hold_slices_of_weights_and_adam_state(group, name):
    """Every 2D+ weight (embed, pos, the head's and the blocks' ``w``) and
    its Adam moments are held as a 1/fsdp slice of its first weight dim;
    the biases whole."""
    inputs, _, ranks, _ = group
    n = CASES[name][0]["fsdp"]
    full = _flat(inputs[name][1])
    for res in ranks:
        shapes = res[name]["shapes"]
        for key, w in full.items():
            want = list(w.shape)
            if key in ("embed", "pos") or key.endswith("/w"):
                want[1 if key.startswith("blocks/") else 0] //= n
            for tree in ("param", "exp_avg", "exp_avg_sq"):
                assert shapes[tree][key] == want, (tree, key)


def test_at_rest_bytes_shrink_linearly_in_fsdp(group):
    """JAX's bar (``test_lm_fsdp.py``): {fsdp 2} < 0.65 x {fsdp 1} and
    {fsdp 4} < 0.65 x {fsdp 2}, each rank's parameters and Adam state."""
    _, _, ranks, _ = group
    for res in ranks:
        b = {int(k): v for k, v in res["bytes"].items()}
        assert b[2] < 0.65 * b[1] and b[4] < 0.65 * b[2], b
    assert len({res["bytes"]["4"] for res in ranks}) == 1


# -- train_lm --mesh dp_fsdp over four ranks ----------------------------------------------


def _one(args: list):
    env = _quiet_env()
    env.pop("LM_MESH", None)
    return subprocess.Popen([sys.executable, "-m", "tpu_tfrecord_torch.train_lm", "--device",
                             "cpu", *args], cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, preexec_fn=_low_priority)


def _four(args: list) -> list:
    port = _free_port()
    procs = []
    for rank in range(GROUP):
        env = _quiet_env()
        env.update(RANK=str(rank), WORLD_SIZE=str(GROUP), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port))
        env.pop("LM_MESH", None)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "tpu_tfrecord_torch.train_lm", "--device", "cpu",
             "--mesh", "dp_fsdp", *args], cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, preexec_fn=_low_priority))
    return procs


def _outputs(procs, what: str) -> list:
    out = _wait_all(procs, TWIN_TIMEOUT_S, what)
    assert all(rc == 0 for rc, _, _ in out), [err[-3000:] for _, _, err in out]
    return [stdout.splitlines() for _, stdout, _ in out]


@pytest.fixture(scope="module")
def trainers(tmp_path_factory):
    """One process of ``--mesh dp`` for 8 steps (the reference), four ranks
    of ``dp_fsdp`` for 4 (saving at 4, spooling) and one ``dp`` process
    for 4 (saving at 4), side by side; then ``dp`` resuming the four
    ranks' checkpoint and four ``dp_fsdp`` ranks resuming the ``dp`` one,
    each to step 8."""
    from tpu_tfrecord_torch import train_lm

    base = tmp_path_factory.mktemp("lm_fsdp_twin")
    data = str(base / "data")
    train_lm.generate(data, shards=2, docs=64)
    common = ["--data-dir", data, "--save-every", "4", "--digest-out"]
    ck = {k: str(base / k) for k in ("ref", "fsdp", "dp")}
    ref = _one(["--mesh", "dp", "--steps", "8"] + common + [str(base / "ref.jsonl"),
                                                            "--ckpt-dir", ck["ref"]])
    four = _four(["--steps", "4", "--spool", str(base / "spool")] + common
                 + [str(base / "fsdp.jsonl"), "--ckpt-dir", ck["fsdp"]])
    dp = _one(["--mesh", "dp", "--steps", "4"] + common + [str(base / "dp.jsonl"),
                                                           "--ckpt-dir", ck["dp"]])
    first = _outputs([ref] + four + [dp], "the first train_lm runs")
    to_dp = _one(["--mesh", "dp", "--steps", "8"] + common + [str(base / "to_dp.jsonl"),
                                                              "--ckpt-dir", ck["fsdp"]])
    to_fsdp = _four(["--steps", "8"] + common + [str(base / "to_fsdp.jsonl"), "--ckpt-dir",
                                                 ck["dp"]])
    second = _outputs([to_dp] + to_fsdp, "the resumed train_lm runs")
    return {"ref": first[0], "fsdp": first[1:5], "dp": first[5], "to_dp": second[0],
            "to_fsdp": second[1:], "spool": str(base / "spool")}


def _close(got: dict, want: dict, steps) -> None:
    assert sorted(got) == list(steps)
    for s in steps:
        assert got[s]["digest"] == want[s]["digest"], s
        np.testing.assert_allclose(float(got[s]["loss"]), float(want[s]["loss"]),
                                   rtol=RTOL_LOSS)


def test_train_lm_dp_fsdp_over_four_ranks_matches_one_process(trainers):
    """Four ranks pick {data 2, fsdp 2} and print the mesh and each rank's
    slices' bytes; every rank packs the whole stream (one process's
    digests) and their losses follow one process's within rel 1e-5."""
    want = _lm_steps(trainers["ref"])
    got = [_lm_steps(lines) for lines in trainers["fsdp"]]
    for r, lines in enumerate(trainers["fsdp"]):
        assert lines[0] == (f"mesh: {{'data': 2, 'fsdp': 2}} mode=dp_fsdp (4 ranks: 2 layers, "
                            f"rank {r} holds rows [{16 * (r // 2)}, {16 * (r // 2 + 1)}) of "
                            "each batch)")
        assert lines[1].startswith("fsdp param bytes/device: ") and lines[2] == "fresh start"
        assert any(ln.startswith("done: 4 steps") for ln in lines)
        assert got[r] == got[0]
    _close(got[0], want, range(1, 5))
    # float32 slices: half of the 135,168 weights of 2D+ tensors, the 1,408
    # biases whole
    assert int(trainers["fsdp"][0][1].rsplit(" ", 1)[1]) == 4 * (135_168 // 2 + 1_408)


def test_checkpoints_move_between_dp_and_dp_fsdp(trainers):
    """The four ranks' checkpoint resumes one ``dp`` process, and a ``dp``
    process's resumes four ``dp_fsdp`` ranks: both at step 4, and both
    give the uninterrupted run's steps 5-8."""
    want = _lm_steps(trainers["ref"])
    assert "resumed at step 4" in trainers["to_dp"][:2]
    _close(_lm_steps(trainers["to_dp"]), want, range(5, 9))
    _close(_lm_steps(trainers["dp"]), want, range(1, 5))
    for lines in trainers["to_fsdp"]:
        assert lines[2] == "resumed at step 4", lines[:3]
        _close(_lm_steps(lines), want, range(5, 9))


def test_doctor_reads_the_port_trainers_mesh(trainers, capsys):
    """``report_mesh``'s ``train.mesh.*`` gauges reach the spool: JAX's
    ``tfrecord_doctor train`` prints each rank's mesh."""
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import tfrecord_doctor

    tfrecord_doctor.main(["train", trainers["spool"]])
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    procs = [ln for ln in lines if ln.get("event") == "trainer"]
    assert len(procs) == GROUP
    assert all(ln["mesh"] == {"data": 2, "fsdp": 2} and ln["steps"] == 4 for ln in procs)


if __name__ == "__main__" and len(sys.argv) == 3 and sys.argv[1] == "worker":
    torch.set_num_threads(1)
    _spec = json.loads(sys.argv[2])
    _out = run_worker(_spec)
    with open(os.path.join(_spec["results"], f"rank{_spec['rank']}.json"), "w") as _fh:
        json.dump(_out, _fh)
