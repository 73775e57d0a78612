"""The MoE over gloo ranks against the JAX package: expert parallelism
(``moe.moe_apply_ep`` / ``moe_ep_body`` over ``models.sharded.all_to_all``)
and the global route of the LM and ``long_doc`` over data, seq and fsdp
meshes.

One gloo group of 4 CPU processes is spawned once for the module, every
process running this file as its worker (``python test_torch_moe_mesh.py
worker SPEC``, importing only the port). This process runs the JAX side on
4 of the 8 CPU devices from ``tests/conftest.py``; the same numpy weights
go to both sides (``interop`` for the models).

- The layer: ``moe_apply_ep`` on {expert 4} (a 2-D token stream) and
  {data 2, expert 2} (``data_axis``, one row a data shard), top-k 1 and 2,
  capacity factors 0.75 and 1.25: y, the aux loss and the diagnostics
  against JAX's ``moe_apply_ep`` and ``moe_reference(shards=4)`` at rtol
  1e-4 / atol 1e-5, and the gradients of ``(y**2).sum() + 0.01 * aux``
  (whole on every rank) against ``jax.grad`` at 1e-5 of each tensor's
  largest, the router's nonzero. Each rank's ``shard_experts`` holds its
  E/P experts and ``unshard_experts`` gives the tree back. On {expert 4}
  JAX's two ``ValueError``s, with JAX's messages, and
  ``moe.param_shardings`` JAX's specs.
- The global route: the MoE LM's three Adam steps (``train_step`` with
  diagnostics) on {data 4}, {data 2, seq 2} (the zigzag ring, best_fit
  ``segments``) and {data 2, fsdp 2}, at capacity factors 0.75 (drops)
  and 1.25, against JAX's sharded ``train_step``: losses at rel 1e-5, the
  parameters at abs 1e-5 (entries whose gradient came within 1e-6 of zero,
  exact zeros included, at Adam's step bound: Adam turns a rounding-level
  gradient, such as the key bias's, into a step of up to lr), the
  diagnostics equal (counts exactly).
- EP in the LM: {data 2, expert 2} and {fsdp 2, expert 2} against JAX's
  sharded ``train_step`` on the same meshes, each rank holding E/P
  experts and their Adam state; {fsdp 2, expert 2} against {expert 2} on
  the same mesh without ``fsdp_axis`` at 1e-6 (JAX's
  ``test_dp_fsdp_ep_matches_dp_ep``).
- ``long_doc``: the MoE classifier on {seq 2, expert 2}, its expert
  weights placed on 'expert' (``moe.shard_experts``), documents padded
  (``valid``): the forward against JAX's on the replicated weights, and
  two train steps against JAX's sharded step.
- The trainer: ``train_lm --mesh dp --moe 4 --diagnostics --device cpu``
  over 2 ranks against one process (losses rel 1e-5, the same digests and
  ``moe.*`` gauges on both ranks, one process's within rel 2e-3: a
  near-tie router pick may flip), and its checkpoint resumed by one
  process (the stream exactly, the losses at rel 1e-4).

Every spawn is waited on with a timeout that kills it and fails.
"""

import concurrent.futures
import functools
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

from test_torch_dlrm_mesh import _free_port, _low_priority, _quiet_env, _wait_all  # noqa: E402
from test_torch_seq_mesh import _flat, _leaf_map, _lm_steps, _unflat  # noqa: E402

GROUP = 4
JAX_THREADS = 2
GROUP_TIMEOUT_S = 150
TWIN_TIMEOUT_S = 150
STEPS = 3
LD_STEPS = 2
LAYER_TOL = dict(rtol=1e-4, atol=1e-5)
RTOL_GRAD = 1e-5          # of the tensor's largest |gradient|
RTOL_LOSS = 1e-5
ATOL_PARAM = 1e-5
ATOL_FSDP_EP = 1e-6       # {fsdp 2, expert 2} against {expert 2}
GAUGE_RTOL = 2e-3         # the trainer's moe.* gauges, two ranks against one process
# one process's steps 5-6 from the ranks' step-4 state against its own
# uninterrupted run: a router pick that flipped in the ranks' step 4 moves
# the state by more than rounding (a lost Adam state moves it by far more)
RTOL_RESUMED = 1e-4
NEAR_ZERO = 1e-6
LR = 3e-3
LD_LR = 1e-3
BATCH = 8
D, FF, E = 16, 32, 4
LM = dict(vocab_size=64, d_model=16, n_heads=4, n_layers=1, max_len=16, moe_experts=4)
LONGDOC = dict(seq_dim=6, d_model=16, n_heads=4, n_layers=1, max_len=16, n_classes=2,
               moe_experts=4)
# the layer: (mesh, data_axis, x shape) by name; each at every top-k and factor
LAYER_MESHES = {
    "expert4": ({"expert": 4}, None, (32, D)),
    "data2_expert2": ({"data": 2, "expert": 2}, "data", (2, 16, D)),
}
LAYER_CASES = {f"{m}_top{k}_cf{cf}": (m, k, cf) for m in LAYER_MESHES for k in (1, 2)
               for cf in (0.75, 1.25)}
# the LM: (mesh, the step's axes, packed segments?, capacity factor)
LM_CASES = {
    f"{name}_cf{cf}": (axes, kw, segs, cf) for cf in (0.75, 1.25)
    for name, axes, kw, segs in (
        ("data4", {"data": 4}, dict(data_axis="data"), False),
        ("data2_seq2_segments", {"data": 2, "seq": 2}, dict(data_axis="data", seq_axis="seq"),
         True),
        ("data2_fsdp2", {"data": 2, "fsdp": 2}, dict(data_axis="data", fsdp_axis="fsdp"), False),
    )
}
EP_CASES = {
    "data2_expert2": ({"data": 2, "expert": 2}, dict(data_axis="data", expert_axis="expert")),
    "fsdp2_expert2": ({"fsdp": 2, "expert": 2}, dict(expert_axis="expert", fsdp_axis="fsdp")),
    # the reference of JAX's test_dp_fsdp_ep_matches_dp_ep: the same mesh, no fsdp_axis
    "expert2_on_fsdp2": ({"fsdp": 2, "expert": 2}, dict(expert_axis="expert")),
}
LD_AXES = {"seq": 2, "expert": 2}


# -- the worker (imports the port only) -------------------------------------------


def _load(spec: dict, name: str):
    data = np.load(os.path.join(spec["dir"], f"{name}.npz"))
    params = _unflat({k[2:]: data[k] for k in data.files if k.startswith("p/")})
    batches = [{k.split("/")[2]: data[k] for k in data.files if k.startswith(f"b/{s}/")}
               for s in range(STEPS)]
    return params, [b for b in batches if b]


def _layer_case(spec: dict, name: str, mesh) -> tuple:
    from tpu_tfrecord_torch.models import moe

    mname, top_k, cf = LAYER_CASES[name]
    _, data_axis, _ = LAYER_MESHES[mname]
    params, batches = _load(spec, name)
    cfg = moe.MoEConfig(d_model=D, d_ff=FF, n_experts=E, capacity_factor=cf, top_k=top_k)
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    x = torch.tensor(batches[0]["x"], requires_grad=True)
    y, aux, diag = moe.moe_apply_ep(tp, x, cfg, mesh, expert_axis="expert",
                                    data_axis=data_axis, diagnostics=True)
    ((y ** 2).sum() + 0.01 * aux).backward()
    mine = moe.shard_experts(params, mesh, "expert")
    back = moe.unshard_experts(mine, mesh, "expert")
    out = {"aux": float(aux), "diag": {k: v.tolist() for k, v in diag.items()},
           "expert_shape": list(mine["w_in"].shape),
           "round_trip": all(np.array_equal(back[k].numpy(), params[k]) for k in params)}
    arrays = {f"{name}/y": y.detach().numpy(), f"{name}/grad/x": x.grad.numpy()}
    arrays.update({f"{name}/grad/{k}": t.grad.numpy() for k, t in tp.items()})
    return out, arrays


def _lm_run(spec: dict, name: str, mesh, kw: dict, cf: float, tag: str) -> tuple:
    import torch.distributed as dist

    from tpu_tfrecord_torch import interop
    from tpu_tfrecord_torch.models import lm, optim, sharded

    params, batches = _load(spec, name)
    cfg = lm.LMConfig(dtype=torch.float32, moe_capacity_factor=cf, **LM)
    fsdp, expert = kw.get("fsdp_axis"), kw.get("expert_axis")
    tp = lm.shard_params(interop.lm_params_from_jax(params, cfg, device="cpu"), mesh,
                         fsdp_axis=fsdp, expert_axis=expert)
    opt = optim.adam(tp, LR)
    di, per = sharded.axis_index(mesh, "data"), BATCH // sharded.axis_size(mesh, "data")
    rows = lambda a: torch.from_numpy(a[di * per:(di + 1) * per])  # noqa: E731
    losses, diags, near_zero = [], [], None
    for host in batches:
        segs = rows(host["segments"]) if "segments" in host else None
        loss, diag = lm.train_step(tp, opt, rows(host["tokens"]), cfg, mesh=mesh, segments=segs,
                                   diagnostics=True, **kw)
        losses.append(float(loss))
        diags.append({k: np.asarray(v).tolist() for k, v in diag.items()})
        masks = _leaf_map(lambda p: (p.grad.abs() < NEAR_ZERO).float(), tp)
        near_zero = masks if near_zero is None else _leaf_map2(torch.maximum, near_zero, masks)
    dist.barrier()
    adam = optim.adam_state(tp, opt)[0]
    whole = lm.unshard_params(tp, mesh, fsdp_axis=fsdp, expert_axis=expert)
    zero = lm.unshard_params(near_zero, mesh, fsdp_axis=fsdp, expert_axis=expert)
    arrays = {f"{tag}/param/{k}": v for k, v in _flat(interop.lm_params_to_jax(whole)).items()}
    arrays.update({f"{tag}/near_zero/{k}": v > 0
                   for k, v in _flat(interop.lm_params_to_jax(zero)).items()})
    shapes = {tree: list(t["blocks"]["moe"]["w_in"].shape)
              for tree, t in (("param", tp), ("exp_avg", adam.mu), ("exp_avg_sq", adam.nu))}
    return {"losses": losses, "diags": diags, "shapes": shapes}, arrays


def _leaf_map2(fn, a, b):
    if isinstance(a, dict):
        return {k: _leaf_map2(fn, v, b[k]) for k, v in a.items()}
    if isinstance(a, list):
        return [_leaf_map2(fn, v, w) for v, w in zip(a, b)]
    return fn(a, b)


def _long_doc_case(spec: dict, mesh) -> tuple:
    import torch.distributed as dist

    from tpu_tfrecord_torch import interop
    from tpu_tfrecord_torch.models import long_doc, moe, optim, sharded

    params, batches = _load(spec, "long_doc")
    cfg = long_doc.LongDocConfig(dtype=torch.float32, **LONGDOC)
    tp = interop.long_doc_params_from_jax(params, cfg, device="cpu")
    for layer in tp["layers"]:
        layer["moe"] = moe.shard_experts(layer["moe"], mesh, "expert")
    si, lc = sharded.axis_index(mesh, "seq"), LONGDOC["max_len"] // LD_AXES["seq"]

    def local(host):
        out = {k: torch.from_numpy(v) for k, v in host.items()}
        out["frames"] = out["frames"][:, si * lc:(si + 1) * lc].contiguous()
        return out

    with torch.no_grad():
        logits = long_doc.forward(tp, local(batches[0]), cfg, mesh=mesh, expert_axis="expert")
    opt = optim.adam(tp, LD_LR)
    losses, near_zero = [], None
    for host in batches[:LD_STEPS]:
        losses.append(float(long_doc.train_step(tp, opt, local(host), cfg, mesh=mesh,
                                                expert_axis="expert")))
        masks = _leaf_map(lambda p: (p.grad.abs() < NEAR_ZERO).float(), tp)
        near_zero = masks if near_zero is None else _leaf_map2(torch.maximum, near_zero, masks)
    dist.barrier()
    expert_shape = list(tp["layers"][0]["moe"]["w_in"].shape)
    for tree in (tp, near_zero):
        for layer in tree["layers"]:
            layer["moe"] = moe.unshard_experts(layer["moe"], mesh, "expert")
    arrays = {"long_doc/logits": logits.numpy()}
    arrays.update({f"long_doc/param/{k}": v
                   for k, v in _flat(interop.long_doc_params_to_jax(tp)).items()})
    arrays.update({f"long_doc/near_zero/{k}": v > 0
                   for k, v in _flat(interop.long_doc_params_to_jax(near_zero)).items()})
    return {"losses": losses, "expert_shape": expert_shape}, arrays


def _refusals(mesh) -> dict:
    """On a ``DeviceMesh`` {expert 4}: the messages of the two shapes JAX's
    ``moe_apply_ep`` refuses, and ``param_shardings``' placements."""
    from tpu_tfrecord_torch.models import moe

    out = {}
    for what, e, t in (("token dim", E, 15), ("n_experts", 6, 16)):
        cfg = moe.MoEConfig(d_model=D, d_ff=FF, n_experts=e)
        params = moe.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
        try:
            moe.moe_apply_ep(params, torch.zeros(2, t, D), cfg, mesh)
            out[what] = None
        except ValueError as err:
            out[what] = str(err)
    out["param_shardings"] = {k: [repr(p) for p in v] for k, v in
                              moe.param_shardings(mesh, expert_axis="expert").items()}
    return out


def run_worker(spec: dict) -> dict:
    sys.path.insert(0, REPO)
    from tpu_tfrecord_torch.device import distributed, mesh as meshes

    distributed.initialize(spec["addr"], GROUP, spec["rank"])
    made = {}

    def mesh_of(axes):
        key = json.dumps(axes)
        if key not in made:
            made[key] = meshes.create_mesh(axes, device_type="cpu")
        return made[key]

    out, arrays = {"refusals": _refusals(mesh_of({"expert": 4}))}, {}
    for name, (mname, _, _) in LAYER_CASES.items():
        out[name], arr = _layer_case(spec, name, mesh_of(LAYER_MESHES[mname][0]))
        arrays.update(arr)
    for name, (axes, kw, _, cf) in LM_CASES.items():
        out[name], arr = _lm_run(spec, name, mesh_of(axes), kw, cf, name)
        arrays.update(arr)
    for name, (axes, kw) in EP_CASES.items():
        out[name], arr = _lm_run(spec, "ep", mesh_of(axes), kw, 1.25, name)
        arrays.update(arr)
    out["long_doc"], arr = _long_doc_case(spec, mesh_of(LD_AXES))
    arrays.update(arr)
    np.savez(os.path.join(spec["results"], f"rank{spec['rank']}.npz"), **arrays)
    return out


# -- the JAX side (this process) -------------------------------------------------


def _jax_mesh(axes: dict):
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()[:int(np.prod(list(axes.values())))]).reshape(
        tuple(axes.values())), tuple(axes))


def _layer_inputs(name: str) -> tuple:
    """The JAX config, weights drawn with numpy at the JAX init's
    distributions, and x."""
    from tpu_tfrecord.models import moe as jmoe

    mname, top_k, cf = LAYER_CASES[name]
    cfg = jmoe.MoEConfig(d_model=D, d_ff=FF, n_experts=E, capacity_factor=cf, top_k=top_k)
    rng = np.random.default_rng(sorted(LAYER_CASES).index(name))
    params = {"router": rng.normal(size=(D, E)) * 0.02,
              "w_in": rng.normal(size=(E, D, FF)) * np.sqrt(2.0 / D),
              "w_out": rng.normal(size=(E, FF, D)) * np.sqrt(2.0 / FF)}
    params = {k: v.astype(np.float32) for k, v in params.items()}
    x = rng.normal(size=LAYER_MESHES[mname][2]).astype(np.float32)
    return cfg, params, [{"x": x}]


def _layer_jax(name: str, cfg, params, batches) -> dict:
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from tpu_tfrecord.models import moe as jmoe

    mname = LAYER_CASES[name][0]
    axes, data_axis, shape = LAYER_MESHES[mname]
    mesh = _jax_mesh(axes)
    x_spec = P(*((data_axis,) if data_axis else ()), *([None] * (len(shape) - 3)), "expert", None)
    sh = jmoe.param_shardings(mesh, expert_axis="expert")
    p = {k: jax.device_put(v, sh[k]) for k, v in params.items()}
    x = jax.device_put(batches[0]["x"], NamedSharding(mesh, x_spec))

    def loss(p, x):
        y, aux, diag = jmoe.moe_apply_ep(p, x, cfg, mesh, expert_axis="expert",
                                         data_axis=data_axis, diagnostics=True)
        return (y ** 2).sum() + 0.01 * aux, (y, aux, diag)

    (_, (y, aux, diag)), (gp, gx) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1),
                                                               has_aux=True))(p, x)
    grads = {k: np.asarray(v) for k, v in gp.items()}
    grads["x"] = np.asarray(gx)
    want, want_diag = jmoe.moe_reference(params, batches[0]["x"], cfg, shards=4,
                                         return_diag=True)
    return {"y": np.asarray(y), "aux": float(aux), "grads": grads,
            "diag": {k: np.asarray(v) for k, v in diag.items()},
            "reference": want, "reference_diag": want_diag}


@functools.lru_cache(maxsize=None)
def _lm_weights() -> dict:
    """The weights of every LM case (the capacity factor draws nothing), in
    the JAX layout: the port's draw, which needs no compilation."""
    from tpu_tfrecord_torch import interop
    from tpu_tfrecord_torch.models import lm

    cfg = lm.LMConfig(**LM)
    return interop.lm_params_to_jax(lm.init_params(cfg, torch.Generator().manual_seed(4),
                                                   device="cpu"))


def _lm_inputs(name: str, cf: float, segments: bool, seed: int) -> tuple:
    import jax.numpy as jnp

    from tpu_tfrecord.models import lm as jlm
    from tpu_tfrecord.tpu.ingest import TokenPacker

    cfg = jlm.LMConfig(dtype=jnp.float32, moe_capacity_factor=cf, **LM)
    params = _lm_weights()
    if not segments:
        return cfg, params, [{"tokens": jlm.make_synthetic_tokens(cfg, BATCH, seed=seed + s)}
                             for s in range(STEPS)]
    rng, batches = np.random.default_rng(seed), []
    pk = TokenPacker(BATCH, LM["max_len"], packing="best_fit")
    while len(batches) < STEPS:
        pk.feed_docs(rng.integers(1, LM["vocab_size"], size=int(n))
                     for n in rng.integers(1, 12, size=12))
        b = pk.pop()
        if b is not None:
            batches.append({"tokens": b["tokens"], "segments": b["segment_ids"]})
    return cfg, params, batches


def _lm_jax(axes: dict, kw: dict, cfg, params, batches) -> dict:
    """The JAX sharded step under jit, with diagnostics: losses, diags,
    the final parameters."""
    import jax
    import optax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from tpu_tfrecord.models import lm as jlm

    mesh = _jax_mesh(axes)
    tx = optax.adam(LR)
    p = jax.device_put(params, jlm.param_shardings(
        mesh, params, expert_axis=kw.get("expert_axis"), fsdp_axis=kw.get("fsdp_axis")))
    step = jax.jit(functools.partial(jlm.train_step, cfg=cfg, tx=tx, mesh=mesh,
                                     diagnostics=True, **kw))
    rows = NamedSharding(mesh, P(kw.get("data_axis"), None))
    state = tx.init(p)
    losses, diags = [], []
    for h in batches:
        segs = jax.device_put(h["segments"], rows) if "segments" in h else None
        p, state, loss, diag = step(p, state, jax.device_put(h["tokens"], rows), segments=segs)
        losses.append(float(loss))
        diags.append({k: np.asarray(v) for k, v in diag.items()})
    return {"losses": losses, "diags": diags, "params": _flat(jax.tree.map(np.asarray, p))}


def _long_doc_inputs() -> tuple:
    import jax.numpy as jnp

    from tpu_tfrecord.models import long_doc as jld

    from tpu_tfrecord_torch import interop
    from tpu_tfrecord_torch.models import long_doc

    cfg = jld.LongDocConfig(dtype=jnp.float32, **LONGDOC)
    params = interop.long_doc_params_to_jax(long_doc.init_params(
        long_doc.LongDocConfig(**LONGDOC), torch.Generator().manual_seed(8), device="cpu"))
    batches = [jld.make_synthetic_batch(cfg, BATCH, seed=70 + s) for s in range(LD_STEPS)]
    assert (batches[0]["frames_len"] < LONGDOC["max_len"]).any()  # padding takes part
    return cfg, params, batches


def _long_doc_jax(cfg, params, batches) -> dict:
    """JAX's forward on the replicated weights, and its sharded train step
    on {seq 2, expert 2} with the expert weights placed on 'expert'."""
    import jax
    import optax

    from tpu_tfrecord.models import long_doc as jld, moe as jmoe

    logits = jax.jit(functools.partial(jld.forward, cfg=cfg))(params, batches[0])
    mesh = _jax_mesh(LD_AXES)
    sh = jmoe.param_shardings(mesh, expert_axis="expert")
    p = dict(params, layers=[dict(layer, moe={k: jax.device_put(v, sh[k])
                                              for k, v in layer["moe"].items()})
                             for layer in params["layers"]])
    tx = optax.adam(LD_LR)
    step = jax.jit(functools.partial(jld.train_step, cfg=cfg, tx=tx, mesh=mesh))
    state, losses = tx.init(p), []
    for h in batches:
        p, state, loss = step(p, state, h)
        losses.append(float(loss))
    return {"logits": np.asarray(logits), "losses": losses,
            "params": _flat(jax.tree.map(np.asarray, p))}


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """Spawn the 4-rank group once; returns (JAX runs by case, rank
    results, rank arrays by rank)."""
    base = str(tmp_path_factory.mktemp("moe_mesh"))
    spec = {"dir": base, "results": os.path.join(base, "results"),
            "addr": f"127.0.0.1:{_free_port()}"}
    os.makedirs(spec["results"])
    inputs = {name: _layer_inputs(name) for name in LAYER_CASES}
    inputs.update({name: _lm_inputs(name, cf, segs, 40 + i)
                   for i, (name, (_, _, segs, cf)) in enumerate(LM_CASES.items())})
    inputs["ep"] = _lm_inputs("ep", 1.25, False, 50)
    inputs["long_doc"] = _long_doc_inputs()
    for name, (_, params, batches) in inputs.items():
        arrays = {f"p/{k}": v for k, v in _flat(params).items()}
        for s, host in enumerate(batches):
            arrays.update({f"b/{s}/{k}": v for k, v in host.items()})
        np.savez(os.path.join(base, f"{name}.npz"), **arrays)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "worker", json.dumps(dict(spec, rank=r))],
        cwd=REPO, env=_quiet_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        preexec_fn=_low_priority) for r in range(GROUP)]
    # the JAX side runs while the ranks start up; its compilations on a few
    # threads (XLA compiles without the GIL)
    work = {name: functools.partial(_layer_jax, name, *inputs[name]) for name in LAYER_CASES}
    work.update({name: functools.partial(_lm_jax, axes, kw, *inputs[name])
                 for name, (axes, kw, _, _) in LM_CASES.items()})
    work.update({name: functools.partial(_lm_jax, axes, kw, *inputs["ep"])
                 for name, (axes, kw) in EP_CASES.items() if name != "expert2_on_fsdp2"})
    work["long_doc"] = functools.partial(_long_doc_jax, *inputs["long_doc"])
    with concurrent.futures.ThreadPoolExecutor(JAX_THREADS) as pool:
        futures = {name: pool.submit(fn) for name, fn in work.items()}
        jax_runs = {name: f.result() for name, f in futures.items()}
    logs = _wait_all(procs, GROUP_TIMEOUT_S, f"the group of {GROUP}")
    bad = [(r, rc, err[-3000:]) for r, (rc, _, err) in enumerate(logs) if rc != 0]
    assert not bad, bad
    ranks = [json.load(open(os.path.join(spec["results"], f"rank{r}.json")))
             for r in range(GROUP)]
    arrays = [dict(np.load(os.path.join(spec["results"], f"rank{r}.npz")))
              for r in range(GROUP)]
    return inputs, jax_runs, ranks, arrays


def _pick(arr: dict, tag: str) -> dict:
    return {k.split("/", 2)[2]: v for k, v in arr.items() if k.startswith(tag + "/")}


def test_ep_refusals_and_placements_match_jax(group):
    """On a ``DeviceMesh`` {expert 4} every rank raises JAX's two
    ``ValueError``s (a token dim and an expert count the axis does not
    divide: JAX's ``test_indivisible_shapes_rejected``) with JAX's messages,
    and ``moe.param_shardings`` gives JAX's ``NamedSharding`` specs."""
    import jax

    from tpu_tfrecord.models import moe as jmoe

    _, _, ranks, _ = group
    mesh = _jax_mesh({"expert": 4})
    want = {}
    for what, e, t in (("token dim", E, 15), ("n_experts", 6, 16)):
        cfg = jmoe.MoEConfig(d_model=D, d_ff=FF, n_experts=e)
        with pytest.raises(ValueError, match=what) as err:
            jmoe.moe_apply_ep(jmoe.init_params(jax.random.key(0), cfg),
                              np.zeros((2, t, D), np.float32), cfg, mesh)
        want[what] = str(err.value)
    specs = {k: v.spec for k, v in jmoe.param_shardings(mesh, expert_axis="expert").items()}
    want["param_shardings"] = {k: ["Shard(dim=0)" if tuple(spec)[:1] == ("expert",)
                                   else "Replicate()"] for k, spec in specs.items()}
    assert want["param_shardings"]["w_in"] == ["Shard(dim=0)"]
    for res in ranks:
        assert res["refusals"] == want


@pytest.mark.parametrize("name", list(LAYER_CASES))
def test_ep_layer_matches_jax_and_the_per_shard_oracle(group, name):
    """y, the aux loss and the diagnostics of ``moe_apply_ep`` on every
    rank: JAX's ``moe_apply_ep`` and ``moe_reference(shards=4)``."""
    _, jax_runs, ranks, arrays = group
    want = jax_runs[name]
    for res, arr in zip(ranks, arrays):
        y = arr[f"{name}/y"]
        np.testing.assert_allclose(y, want["y"], **LAYER_TOL)
        np.testing.assert_allclose(y, want["reference"], **LAYER_TOL)
        np.testing.assert_allclose(res[name]["aux"], want["aux"], **LAYER_TOL)
        for k, v in want["diag"].items():
            np.testing.assert_allclose(res[name]["diag"][k], v, **LAYER_TOL)
            np.testing.assert_allclose(res[name]["diag"][k], want["reference_diag"][k],
                                       **LAYER_TOL)
        assert res[name]["expert_shape"] == [E // 2 if "data2" in name else E // 4, D, FF]
        assert res[name]["round_trip"]


@pytest.mark.parametrize("name", list(LAYER_CASES))
def test_ep_layer_gradients_match_jax_grad(group, name):
    """The gradients of ``(y**2).sum() + 0.01 * aux`` through the
    all_to_all, whole on every rank, are ``jax.grad``'s; the router's are
    nonzero (the gates differentiate through the router probabilities)."""
    _, jax_runs, _, arrays = group
    want = jax_runs[name]["grads"]
    assert np.abs(want["router"]).max() > 0
    for arr in arrays:
        got = _pick(arr, f"{name}/grad")
        assert sorted(got) == sorted(want)
        assert np.abs(got["router"]).max() > 0
        for key, w in want.items():
            np.testing.assert_allclose(got[key], w, rtol=0, atol=RTOL_GRAD * np.abs(w).max(),
                                       err_msg=f"{name} {key}")


def _held(got: np.ndarray, want: np.ndarray, mask: np.ndarray, what: str, steps: int,
          lr: float, atol: float = ATOL_PARAM) -> None:
    """``got`` within ``atol`` of ``want``; the masked entries within
    Adam's bound of ``steps`` steps of ``lr``."""
    got, want = got.copy(), want.copy()
    if mask.any():
        assert np.abs(got[mask] - want[mask]).max() <= steps * lr * (1 + 1e-3), what
        got[mask] = want[mask] = 0.0
    np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=what)


def _check_lm(group, name: str, want: dict) -> None:
    _, _, ranks, arrays = group
    for res, arr in zip(ranks, arrays):
        np.testing.assert_allclose(res[name]["losses"], want["losses"], rtol=RTOL_LOSS, atol=0)
        assert res[name]["losses"] == ranks[0][name]["losses"]
        for got, w in zip(res[name]["diags"], want["diags"]):
            assert sorted(got) == sorted(w)
            for k in ("expert_tokens", "expert_kept"):
                np.testing.assert_array_equal(got[k], w[k])
            for k in ("dropped_fraction", "gate_entropy"):
                np.testing.assert_allclose(got[k], w[k], rtol=1e-5, atol=1e-6)
        params, masks = _pick(arr, f"{name}/param"), _pick(arr, f"{name}/near_zero")
        assert sorted(params) == sorted(want["params"])
        for key, w in want["params"].items():
            _held(params[key], w, masks[key], f"{name} {key}", STEPS, LR)


@pytest.mark.parametrize("name", list(LM_CASES))
def test_moe_lm_global_route_matches_jax_sharded_step(group, name):
    """Three Adam steps of the MoE LM over {data 4}, {data 2, seq 2} and
    {data 2, fsdp 2}: JAX's losses, diagnostics and parameters. At the
    0.75 factor assignments drop, so a rank that routed or capped its own
    tokens alone would part from JAX."""
    _, jax_runs, ranks, _ = group
    _check_lm(group, name, jax_runs[name])
    if name.endswith("0.75"):
        assert all(d["dropped_fraction"] > 0 for d in ranks[0][name]["diags"])


@pytest.mark.parametrize("name", ["data2_expert2", "fsdp2_expert2"])
def test_moe_lm_expert_parallel_matches_jax_sharded_step(group, name):
    """``expert_axis`` in the LM: JAX's sharded step on the same mesh;
    every rank holds E/P experts and their Adam moments (and, under fsdp,
    half of their d_model rows)."""
    _, jax_runs, ranks, _ = group
    _check_lm(group, name, jax_runs[name])
    want = [LM["n_layers"], E // 2, LM["d_model"] // (2 if "fsdp" in name else 1),
            4 * LM["d_model"]]
    for res in ranks:
        assert all(shape == want for shape in res[name]["shapes"].values()), res[name]["shapes"]


def test_fsdp_with_ep_matches_ep_alone(group):
    """JAX's ``test_dp_fsdp_ep_matches_dp_ep``: adding fsdp to the expert
    axis moves the trajectory by no more than 1e-6."""
    _, _, ranks, arrays = group
    for res, arr in zip(ranks, arrays):
        np.testing.assert_allclose(res["fsdp2_expert2"]["losses"],
                                   res["expert2_on_fsdp2"]["losses"], rtol=ATOL_FSDP_EP,
                                   atol=ATOL_FSDP_EP)
        got, ref = _pick(arr, "fsdp2_expert2/param"), _pick(arr, "expert2_on_fsdp2/param")
        assert sorted(got) == sorted(ref)
        for key in ref:
            np.testing.assert_allclose(got[key], ref[key], rtol=ATOL_FSDP_EP, atol=ATOL_FSDP_EP,
                                       err_msg=key)


def test_long_doc_moe_on_seq_and_expert_axes_matches_jax(group):
    """The MoE ``long_doc`` on {seq 2, expert 2}, its experts sharded on
    'expert', documents padded: JAX's forward on the replicated weights
    (1e-5), and two train steps against JAX's sharded step (losses rel
    1e-5, parameters abs 1e-5); each rank holds 2 of the 4 experts."""
    _, jax_runs, ranks, arrays = group
    want = jax_runs["long_doc"]
    for res, arr in zip(ranks, arrays):
        np.testing.assert_allclose(arr["long_doc/logits"], want["logits"], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(res["long_doc"]["losses"], want["losses"], rtol=RTOL_LOSS,
                                   atol=0)
        assert res["long_doc"]["expert_shape"] == [E // 2, LONGDOC["d_model"],
                                                   4 * LONGDOC["d_model"]]
        params, masks = _pick(arr, "long_doc/param"), _pick(arr, "long_doc/near_zero")
        assert sorted(params) == sorted(want["params"])
        for key, w in want["params"].items():
            _held(params[key], w, masks[key], f"long_doc {key}", LD_STEPS, LD_LR)


# -- train_lm --mesh dp --moe 4 over two ranks ------------------------------------------


def _train_lm(args: list, rank=None, port=None):
    env = _quiet_env()
    env.pop("LM_MESH", None)
    if rank is not None:
        env.update(RANK=str(rank), WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port))
    return subprocess.Popen([sys.executable, "-m", "tpu_tfrecord_torch.train_lm", "--device",
                             "cpu", "--mesh", "dp", "--moe", "4", "--diagnostics", *args],
                            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, preexec_fn=_low_priority)


def _outputs(procs, what: str) -> list:
    out = _wait_all(procs, TWIN_TIMEOUT_S, what)
    assert all(rc == 0 for rc, _, _ in out), [err[-3000:] for _, _, err in out]
    return [stdout.splitlines() for _, stdout, _ in out]


@pytest.fixture(scope="module")
def trainers(tmp_path_factory):
    """One process for 6 steps (the reference) and one for 4 (the gauges
    at step 4) beside two ranks for 4, all saving at 4; then one process
    resuming the two ranks' checkpoint to step 6."""
    from tpu_tfrecord_torch import train_lm

    base = tmp_path_factory.mktemp("moe_mesh_twin")
    data = str(base / "data")
    train_lm.generate(data, shards=2, docs=64)
    common = ["--data-dir", data, "--save-every", "4", "--digest-out"]
    port = _free_port()
    ref = _train_lm(["--steps", "6"] + common + [str(base / "ref.jsonl"), "--ckpt-dir",
                                                 str(base / "ref")])
    four = _train_lm(["--steps", "4"] + common + [str(base / "four.jsonl"), "--ckpt-dir",
                                                  str(base / "four")])
    two = [_train_lm(["--steps", "4"] + common + [str(base / "two.jsonl"), "--ckpt-dir",
                                                  str(base / "two")], r, port) for r in range(2)]
    first = _outputs([ref, four] + two, "the first train_lm runs")
    resumed = _outputs([_train_lm(["--steps", "6"] + common + [
        str(base / "resumed.jsonl"), "--ckpt-dir", str(base / "two")])], "the resumed run")
    return {"ref": first[0], "four": first[1], "two": first[2:], "resumed": resumed[0]}


def _diag_line(lines) -> dict:
    got = [ln for ln in lines if ln.startswith("model diagnostics: ")]
    assert len(got) == 1, lines[-6:]
    return json.loads(got[0].split(": ", 1)[1])


def test_train_lm_moe_over_two_ranks_matches_one_process(trainers):
    """Two ranks of ``--mesh dp --moe 4`` each keep half the rows of every
    batch and route the MoE over both halves: one process's digests and
    losses (rel 1e-5), the same on both ranks, with the same finite
    ``moe.*`` gauges as each other and as one process's at step 4; one
    process resumes their step-4 checkpoint and continues the
    uninterrupted run's stream and losses (rel 1e-4)."""
    want = _lm_steps(trainers["ref"])
    got = [_lm_steps(lines) for lines in trainers["two"]]
    gauges = [_diag_line(lines) for lines in trainers["two"]]
    for r, lines in enumerate(trainers["two"]):
        assert lines[0] == (f"mesh: {{'data': 2}} mode=dp (2 ranks: 2 layers, rank {r} holds "
                            f"rows [{16 * r}, {16 * (r + 1)}) of each batch)")
        assert any(ln.startswith("done: 4 steps") for ln in lines)
        assert got[r] == got[0] and gauges[r] == gauges[0]
    assert sorted(gauges[0]) == ["moe.dropped_fraction", "moe.expert_imbalance",
                                 "moe.gate_entropy"]
    assert all(np.isfinite(v) for v in gauges[0].values())
    # the ranks' rows take other matmul shapes than one process's batch, so
    # a near-tie router pick may flip: a few of the 8192 assignments a step
    for k, v in _diag_line(trainers["four"]).items():
        np.testing.assert_allclose(gauges[0][k], v, rtol=GAUGE_RTOL)
    assert sorted(got[0]) == [1, 2, 3, 4]
    for s in got[0]:
        assert got[0][s]["digest"] == want[s]["digest"]
        np.testing.assert_allclose(float(got[0][s]["loss"]), float(want[s]["loss"]),
                                   rtol=RTOL_LOSS)
    resumed = _lm_steps(trainers["resumed"])
    assert "resumed at step 4" in trainers["resumed"][:3]
    assert sorted(resumed) == [5, 6]
    for s in (5, 6):
        assert resumed[s]["digest"] == want[s]["digest"]
        np.testing.assert_allclose(float(resumed[s]["loss"]), float(want[s]["loss"]),
                                   rtol=RTOL_RESUMED)


if __name__ == "__main__" and len(sys.argv) == 3 and sys.argv[1] == "worker":
    torch.set_num_threads(1)
    _spec = json.loads(sys.argv[2])
    _out = run_worker(_spec)
    with open(os.path.join(_spec["results"], f"rank{_spec['rank']}.json"), "w") as _fh:
        json.dump(_out, _fh)
