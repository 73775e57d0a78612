"""The DLRM over a mesh of gloo ranks against the JAX package's sharded step.

One gloo group of 4 CPU processes is spawned once for the module, every
process running this file as its worker (``python
test_torch_dlrm_mesh.py worker SPEC``, importing only the port). On two
meshes, (data 2, model 2) and (model 2, seq 2) (the latter with a
sequence tower of L = 8), each rank loads the JAX weights through
``interop``, keeps its pieces (``dlrm.shard_model``), takes three dense
and three sparse sharded steps on its part of the global batches (cut by
its own ``dlrm.batch_shardings``), gathers the result back
(``dlrm.unshard_model``) and writes what it saw. This process runs the
JAX ``train_step`` / ``sparse_train_step`` under jit with the weights and
batches placed by the JAX ``param_shardings`` / ``batch_shardings`` on 4
of the 8 CPU devices, from the same numpy weights and batches, and holds
the ranks to it:

- the placements: the JAX ``PartitionSpec``s, a weight's transposed
  ([in, out] there, ``nn.Linear``'s [out, in] here);
- the losses at rel 1e-5 and the gathered parameters at abs 1e-5,
  float32; the sparse step's accumulators (the one state that carries
  the gradients' scale: Adam and the row-wise AdaGrad update are blind to
  a constant factor) at rel 1e-5 (an entry near zero: at 1e-6 of the
  largest), and the dense step's first gradients,
  gathered, against ``jax.grad`` at rel 1e-5 of each tensor's largest;
- the replicas of each model rank (over 'data', or over 'seq') bit-equal
  after every step.

The same sharded steps in bf16 activations are held to the port's own
one-process steps on the whole batches (losses and parameters 1e-5; the
accumulators and the dense gradients to 1e-5 of their largest).

Also: ``ingest.batch_spec`` against the JAX one and against the arrays
``host_batch_from_columnar`` gives, and ``train_dlrm --device cpu`` over
two ranks whose slots hold unequal rows (both must stop together). Every
spawn is waited on with a timeout that kills the group and fails.
"""

import ast
import functools
import hashlib
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(num_dense=5, num_categorical=4, vocab_size=64, embed_dim=8, bottom_mlp=(16, 8),
           top_mlp=(16, 1), interaction="dot")
SEQ = dict(seq_len=8, seq_dim=4)
MESHES = {"data2_model2": {"data": 2, "model": 2}, "model2_seq2": {"model": 2, "seq": 2}}
KINDS = ("dense", "sparse")
GLOBAL_BATCH = 16
STEPS = 3
LR = 1e-2
WEIGHT_SEED = 7
GROUP = 4
GROUP_TIMEOUT_S = 120   # the whole group, from spawn to exit
TWIN_TIMEOUT_S = 120    # the two train_dlrm ranks
RTOL_LOSS = 1e-5
ATOL_PARAM = 1e-5
RTOL_ACCUM = 1e-5
ATOL_ACCUM = 1e-6       # of the largest accumulator: an entry of a near-zero gradient
RTOL_GRAD = 1e-5        # of the tensor's largest |gradient|


def _has_seq(case: str) -> bool:
    return "seq" in MESHES[case]


def _data_axis(case: str):
    return "data" if "data" in MESHES[case] else None


# -- the worker (imports the port only) -------------------------------------------


def _params_tree(flat: dict) -> dict:
    """The JAX parameter pytree from its flat npz keys ('bottom.0.w', ...)."""
    tree = {"embeddings": flat["embeddings"]}
    for name in ("bottom", "top"):
        n = len({k.split(".")[1] for k in flat if k.startswith(name + ".")})
        tree[name] = [{"w": flat[f"{name}.{i}.w"], "b": flat[f"{name}.{i}.b"]} for i in range(n)]
    if "seq_proj.w" in flat:
        tree["seq_proj"] = {"w": flat["seq_proj.w"], "b": flat["seq_proj.b"]}
    return tree


def _flat_params(tree: dict) -> dict:
    flat = {"embeddings": np.asarray(tree["embeddings"])}
    for name in ("bottom", "top"):
        for i, layer in enumerate(tree[name]):
            flat[f"{name}.{i}.w"], flat[f"{name}.{i}.b"] = np.asarray(layer["w"]), np.asarray(layer["b"])
    if "seq_proj" in tree:
        flat["seq_proj.w"], flat["seq_proj.b"] = (np.asarray(tree["seq_proj"]["w"]),
                                                  np.asarray(tree["seq_proj"]["b"]))
    return flat


def _digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.detach().contiguous().numpy().tobytes()).hexdigest()


def _local_part(arr: np.ndarray, mesh, placements) -> torch.Tensor:
    """This rank's block of a global array under ``placements``."""
    from torch.distributed.tensor import Shard

    from tpu_tfrecord_torch.models import sharded

    t = torch.from_numpy(arr)
    for axis, p in zip(mesh.mesh_dim_names, placements):
        if isinstance(p, Shard):
            n = sharded.axis_size(mesh, axis)
            width = t.shape[p.dim] // n
            t = t.narrow(p.dim, sharded.axis_index(mesh, axis) * width, width)
    return t.contiguous()


def _gathered_grads(model, cfg, mesh=None) -> dict:
    """The gradients ``model``'s last step left, under the JAX flat names
    (weights [in, out]); a ``ShardedDLRM``'s (summed over 'data') gathered
    over the 'model' axis of ``mesh``."""
    from tpu_tfrecord_torch import interop
    from tpu_tfrecord_torch.models import dlrm, sharded

    holder = dlrm.DLRM(cfg, device="cpu")
    m = 1 if mesh is None else sharded.axis_size(mesh, "model")
    grads = dict(model.named_parameters())
    with torch.no_grad():
        for name, p in holder.named_parameters():
            g = grads[name].grad.float()
            dim = dlrm._model_dim(name, tuple(p.shape), m)
            p.copy_(g if dim is None else sharded.all_gather(g, mesh, "model", dim))
    return _flat_params(interop.dlrm_params_to_jax(holder))


def _run_case(spec: dict, case: str, rank: int) -> dict:
    import torch.distributed as dist

    from tpu_tfrecord_torch import interop
    from tpu_tfrecord_torch.device import mesh as meshes
    from tpu_tfrecord_torch.models import dlrm, sharded

    data = np.load(os.path.join(spec["dir"], f"{case}.npz"))
    cfg = dlrm.DLRMConfig(dtype=torch.float32, **CFG, **(SEQ if _has_seq(case) else {}))
    params = _params_tree({k[2:]: data[k] for k in data.files if k.startswith("p/")})
    batches = [{k.split("/")[2]: data[k] for k in data.files if k.startswith(f"b/{s}/")}
               for s in range(STEPS)]
    mesh = meshes.create_mesh(MESHES[case], device_type="cpu")
    model = interop.dlrm_params_from_jax(params, cfg, device="cpu")
    out = {"coords": {a: sharded.axis_index(mesh, a) for a in mesh.mesh_dim_names},
           "param_shardings": {k: [repr(p) for p in v]
                               for k, v in dlrm.param_shardings(mesh, model).items()},
           "batch_shardings": {k: [repr(p) for p in v] for k, v in dlrm.batch_shardings(
               mesh, batches[0], _data_axis(case), seq_axis="seq").items()}}
    try:
        dlrm.batch_shardings(mesh, batches[0], "nope")
        out["missing_axis"] = None
    except ValueError as e:
        out["missing_axis"] = str(e)
    arrays = {}
    for kind in KINDS:
        sm = dlrm.shard_model(model, mesh)
        adam = lambda ps: torch.optim.Adam(ps, lr=LR)  # noqa: E731
        opt = adam(sm.parameters()) if kind == "dense" else dlrm.sparse_opt_init(sm, cfg, adam)
        losses, digests = [], []
        for host in batches:
            shardings = dlrm.batch_shardings(mesh, host, _data_axis(case), seq_axis="seq")
            local = {k: _local_part(v, mesh, shardings[k]) for k, v in host.items()}
            if kind == "dense":
                loss = dlrm.sharded_train_step(sm, opt, local)
            else:
                loss = dlrm.sharded_sparse_train_step(sm, opt, local, cfg)
            losses.append(float(loss))
            digests.append({k: _digest(p) for k, p in sm.named_parameters()})
            if kind == "dense" and len(losses) == 1:
                arrays.update({f"grad/{k}": v for k, v in _gathered_grads(sm, cfg, mesh).items()})
        out[kind] = {"losses": losses, "digests": digests,
                     "local_table": list(sm.embeddings.shape)}
        full = interop.dlrm_params_to_jax(dlrm.unshard_model(sm))
        arrays.update({f"{kind}/{k}": v for k, v in _flat_params(full).items()})
        if kind == "sparse":
            accum = opt.accum
            if sm.table_sharded:
                accum = sharded.all_gather(accum, mesh, "model", dim=1)
            arrays["sparse/accum"] = accum.numpy()
        del sm, opt
    out["bf16"] = _bf16_against_one_process(mesh, case, params, batches)
    dist.barrier()
    if rank == 0:
        np.savez(os.path.join(spec["results"], f"{case}.npz"), **arrays)
    return out


def _bf16_against_one_process(mesh, case: str, params, batches) -> dict:
    """The sharded steps in bf16 activations against the port's
    one-process steps on the whole batches, run on each rank: the largest
    loss and parameter differences of each kind, and the relative ones
    (``_rel``) of the sparse step's accumulators and of each dense step's
    gradients."""
    from tpu_tfrecord_torch import interop
    from tpu_tfrecord_torch.models import dlrm, sharded

    cfg = dlrm.DLRMConfig(dtype=torch.bfloat16, **CFG, **(SEQ if _has_seq(case) else {}))
    adam = lambda ps: torch.optim.Adam(ps, lr=LR)  # noqa: E731
    out = {}
    for kind in KINDS:
        ref = interop.dlrm_params_from_jax(params, cfg, device="cpu")
        sm = dlrm.shard_model(ref, mesh)
        if kind == "dense":
            opt, ref_opt = adam(sm.parameters()), adam(ref.parameters())
        else:
            opt, ref_opt = (dlrm.sparse_opt_init(m, cfg, adam) for m in (sm, ref))
        loss_err, grad_rel = 0.0, 0.0
        for host in batches:
            shardings = dlrm.batch_shardings(mesh, host, _data_axis(case), seq_axis="seq")
            local = {k: _local_part(v, mesh, shardings[k]) for k, v in host.items()}
            full = {k: torch.from_numpy(v) for k, v in host.items()}
            if kind == "dense":
                got, want = dlrm.sharded_train_step(sm, opt, local), dlrm.train_step(ref, ref_opt, full)
                ref_grads = _gathered_grads(ref, cfg)
                for k, g in _gathered_grads(sm, cfg, mesh).items():
                    grad_rel = max(grad_rel, _rel(g, ref_grads[k]))
            else:
                got = dlrm.sharded_sparse_train_step(sm, opt, local, cfg)
                want = dlrm.sparse_train_step(ref, ref_opt, full, cfg)
            loss_err = max(loss_err, abs(float(got) - float(want)))
        back = dict(dlrm.unshard_model(sm).named_parameters())
        out[kind] = {"loss": loss_err, "params": max(
            float((back[k] - p).abs().max()) for k, p in ref.named_parameters())}
        if kind == "dense":
            out[kind]["grads"] = grad_rel
        else:
            accum = (sharded.all_gather(opt.accum, mesh, "model", dim=1) if sm.table_sharded
                     else opt.accum)
            out[kind]["accum"] = _rel(accum.numpy(), ref_opt.accum.numpy())
    return out


def _rel(got: np.ndarray, want: np.ndarray) -> float:
    """The largest |got - want| over the largest |want|."""
    return float(np.abs(got - want).max() / np.abs(want).max())


def run_worker(spec: dict) -> dict:
    sys.path.insert(0, REPO)
    from tpu_tfrecord_torch.device import distributed

    distributed.initialize(spec["addr"], GROUP, spec["rank"])
    return {case: _run_case(spec, case, spec["rank"]) for case in MESHES}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _wait_all(procs, timeout_s: float, what: str) -> list:
    """Each process' (returncode, stdout, stderr); kills the lot and fails
    when they are not all done within ``timeout_s``."""
    deadline = time.monotonic() + timeout_s
    logs = []
    try:
        for proc in procs:
            out, err = proc.communicate(timeout=max(1.0, deadline - time.monotonic()))
            logs.append((proc.returncode, out, err))
    except subprocess.TimeoutExpired:
        for proc in procs:
            proc.kill()
        for proc in procs:
            proc.communicate()
        pytest.fail(f"{what} did not finish within {timeout_s} s")
    return logs


def _quiet_env() -> dict:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
    return env


def _low_priority() -> None:
    """In a spawned rank: yield the CPU to the test run's other workers."""
    os.nice(10)


# -- the JAX side (this process) -------------------------------------------------


def _jax_cfg(case: str):
    import jax.numpy as jnp

    from tpu_tfrecord.models import dlrm as jdlrm

    return jdlrm.DLRMConfig(dtype=jnp.float32, **CFG, **(SEQ if _has_seq(case) else {}))


def _inputs(case: str):
    """The JAX weights and STEPS global batches of ``case`` (numpy):
    feature 0's ids drawn from 12 values, so rows repeat in a batch."""
    import jax

    from tpu_tfrecord.models import dlrm as jdlrm

    jcfg = _jax_cfg(case)
    params = jax.tree.map(np.asarray, jdlrm.init_params(jax.random.key(WEIGHT_SEED), jcfg))
    batches = []
    for s in range(STEPS):
        host = jdlrm.make_synthetic_batch(jcfg, GLOBAL_BATCH, seed=40 + s)
        host["cat"][:, 0] = np.random.default_rng(60 + s).integers(0, 12, size=GLOBAL_BATCH)
        batches.append(host)
    return params, batches


def _jax_mesh(case: str):
    import jax
    from jax.sharding import Mesh

    axes = MESHES[case]
    return Mesh(np.array(jax.devices()[:GROUP]).reshape(tuple(axes.values())), tuple(axes))


def _jax_run(case: str, kind: str, params, batches):
    """(losses, final params, accumulators or None, the first step's
    gradients or None) of the JAX step under jit, everything placed by the
    JAX shardings."""
    import jax
    import optax

    from tpu_tfrecord.models import dlrm as jdlrm

    jcfg = _jax_cfg(case)
    mesh = _jax_mesh(case)
    p = jax.device_put(params, jdlrm.param_shardings(mesh, params))
    tx = optax.adam(LR)
    if kind == "dense":
        state = tx.init(p)
        step = jax.jit(functools.partial(jdlrm.train_step, cfg=jcfg, tx=tx))
    else:
        state = jdlrm.sparse_opt_init(p, jcfg, tx)
        step = jax.jit(functools.partial(jdlrm.sparse_train_step, cfg=jcfg, tx=tx))
    losses, grads = [], None
    for host in batches:
        placed = jax.device_put(host, jdlrm.batch_shardings(mesh, host, _data_axis(case),
                                                            seq_axis="seq"))
        if kind == "dense" and grads is None:
            grads = _flat_params(jax.jit(jax.grad(functools.partial(jdlrm.loss_fn, cfg=jcfg)))(
                p, placed))
        p, state, loss = step(p, state, placed)
        losses.append(float(loss))
    accum = np.asarray(state.accum) if kind == "sparse" else None
    return losses, jax.tree.map(np.asarray, p), accum, grads


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """Spawn the 4-rank group once; returns (per-case inputs, JAX runs,
    rank results, gathered arrays)."""
    base = str(tmp_path_factory.mktemp("dlrm_mesh"))
    spec = {"dir": base, "results": os.path.join(base, "results"),
            "addr": f"127.0.0.1:{_free_port()}"}
    os.makedirs(spec["results"])
    inputs = {}
    for case in MESHES:
        params, batches = _inputs(case)
        inputs[case] = (params, batches)
        arrays = {f"p/{k}": v for k, v in _flat_params(params).items()}
        for s, host in enumerate(batches):
            arrays.update({f"b/{s}/{k}": v for k, v in host.items()})
        np.savez(os.path.join(base, f"{case}.npz"), **arrays)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "worker", json.dumps(dict(spec, rank=r))],
        cwd=REPO, env=_quiet_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        preexec_fn=_low_priority) for r in range(GROUP)]
    # the JAX side runs while the ranks start up
    jax_runs = {(case, kind): _jax_run(case, kind, *inputs[case])
                for case in MESHES for kind in KINDS}
    logs = _wait_all(procs, GROUP_TIMEOUT_S, f"the group of {GROUP}")
    bad = [(r, rc, err[-3000:]) for r, (rc, _, err) in enumerate(logs) if rc != 0]
    assert not bad, bad
    ranks = [json.load(open(os.path.join(spec["results"], f"rank{r}.json")))
             for r in range(GROUP)]
    gathered = {case: dict(np.load(os.path.join(spec["results"], f"{case}.npz")))
                for case in MESHES}
    return inputs, jax_runs, ranks, gathered


CASES = [(c, k) for c in MESHES for k in KINDS]


def _as_placements(spec, ndim: int, axes, transpose: bool) -> list:
    """A JAX PartitionSpec as the port's placements (one per mesh dim):
    ``Shard(i)`` where the axis names tensor dim i, after transposing a
    weight's two dims."""
    dims = list(spec) + [None] * (ndim - len(spec))
    if transpose:
        dims = dims[::-1]
    out = []
    for axis in axes:
        hit = [i for i, d in enumerate(dims) if d == axis or (isinstance(d, tuple) and axis in d)]
        out.append(f"Shard(dim={hit[0]})" if hit else "Replicate()")
    return out


def _port_name(path) -> tuple:
    """(port parameter name, transposed?) of a JAX pytree path."""
    keys = [getattr(k, "key", getattr(k, "idx", None)) for k in path]
    if keys[0] == "embeddings":
        return "embeddings", False
    leaf = {"w": "weight", "b": "bias"}[keys[-1]]
    return ".".join(str(k) for k in keys[:-1]) + "." + leaf, leaf == "weight"


@pytest.mark.parametrize("case", list(MESHES))
def test_param_shardings_match_jax_specs(group, case):
    import jax

    from tpu_tfrecord.models import dlrm as jdlrm

    inputs, _, ranks, _ = group
    params = inputs[case][0]
    want = {}
    for path, sharding in jax.tree_util.tree_flatten_with_path(
            jdlrm.param_shardings(_jax_mesh(case), params))[0]:
        name, transpose = _port_name(path)
        leaf = functools.reduce(lambda t, k: t[getattr(k, "key", getattr(k, "idx", None))],
                                path, params)
        want[name] = _as_placements(sharding.spec, leaf.ndim, tuple(MESHES[case]), transpose)
    for res in ranks:
        assert res[case]["param_shardings"] == want
    # the trap: JAX's [in, out@model] is the port's Shard(0); the [16, 1]
    # head and every bias stay replicated
    model_dim = list(MESHES[case]).index("model")
    assert want["top.0.weight"][model_dim] == "Shard(dim=0)"
    assert want["top.1.weight"] == want["top.0.bias"] == ["Replicate()"] * 2


@pytest.mark.parametrize("case", list(MESHES))
def test_batch_shardings_match_jax(group, case):
    from tpu_tfrecord.models import dlrm as jdlrm

    inputs, _, ranks, _ = group
    host = inputs[case][1][0]
    got = jdlrm.batch_shardings(_jax_mesh(case), host, _data_axis(case), seq_axis="seq")
    want = {k: _as_placements(s.spec, host[k].ndim, tuple(MESHES[case]), False)
            for k, s in got.items()}
    for res in ranks:
        assert res[case]["batch_shardings"] == want
    if _has_seq(case):
        assert want["frames"] == ["Replicate()", "Shard(dim=1)"]


@pytest.mark.parametrize("case", list(MESHES))
def test_batch_shardings_refuse_an_axis_the_mesh_lacks(group, case):
    """A data axis the mesh lacks raises ``ValueError``, as the JAX
    ``NamedSharding`` does."""
    from tpu_tfrecord.models import dlrm as jdlrm

    inputs, _, ranks, _ = group
    with pytest.raises(ValueError, match="nope"):
        jdlrm.batch_shardings(_jax_mesh(case), inputs[case][1][0], "nope")
    for res in ranks:
        assert res[case]["missing_axis"] and "'nope'" in res[case]["missing_axis"]


@pytest.mark.parametrize("case,kind", CASES)
def test_sharded_steps_match_jax_sharded_steps(group, case, kind):
    _, jax_runs, ranks, _ = group
    want = jax_runs[(case, kind)][0]
    for res in ranks:
        np.testing.assert_allclose(res[case][kind]["losses"], want, rtol=RTOL_LOSS, atol=0)


@pytest.mark.parametrize("case,kind", CASES)
def test_unshard_model_matches_jax_params(group, case, kind):
    _, jax_runs, ranks, gathered = group
    _, want, accum, _ = jax_runs[(case, kind)]
    got = {k.split("/", 1)[1]: v for k, v in gathered[case].items() if k.startswith(kind + "/")}
    flat = _flat_params(want)
    assert sorted(k for k in got if k != "accum") == sorted(flat)
    for name, w in flat.items():
        np.testing.assert_allclose(got[name], w, rtol=0, atol=ATOL_PARAM, err_msg=name)
    if kind == "sparse":
        touched = accum[accum > 0]
        print(f"{case} sparse accumulators: {touched.size} of {accum.size} touched, median "
              f"{np.median(touched):.3g}, largest {touched.max():.3g}")
        assert touched.size > 0
        np.testing.assert_allclose(got["accum"], accum, rtol=RTOL_ACCUM,
                                   atol=ATOL_ACCUM * touched.max())
    # each model rank held half of the table's rows
    for res in ranks:
        assert res[case][kind]["local_table"] == [CFG["num_categorical"],
                                                  CFG["vocab_size"] // 2, CFG["embed_dim"]]


@pytest.mark.parametrize("case", list(MESHES))
def test_sharded_dense_gradients_match_jax(group, case):
    """The first dense step's gradients, summed over 'data' and gathered
    over 'model', equal ``jax.grad`` of the JAX loss: Adam would step the
    same parameters from twice (or half) these gradients."""
    _, jax_runs, _, gathered = group
    want = jax_runs[(case, "dense")][3]
    got = {k.split("/", 1)[1]: v for k, v in gathered[case].items() if k.startswith("grad/")}
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        scale = np.abs(w).max()
        assert scale > 0, name
        np.testing.assert_allclose(got[name], w, rtol=0, atol=RTOL_GRAD * scale, err_msg=name)


@pytest.mark.parametrize("case,kind", CASES)
def test_replicas_stay_bit_equal(group, case, kind):
    """The ranks that hold the same model coordinate (replicas over 'data'
    or over 'seq') hold bit-equal pieces after every step; the two model
    ranks hold different ones."""
    _, _, ranks, _ = group
    by_model = {}
    for res in ranks:
        by_model.setdefault(res[case]["coords"]["model"], []).append(res[case][kind]["digests"])
    assert sorted(by_model) == [0, 1] and all(len(v) == 2 for v in by_model.values())
    for a, b in by_model.values():
        assert a == b
    assert by_model[0][0][-1]["embeddings"] != by_model[1][0][-1]["embeddings"]


@pytest.mark.parametrize("case,kind", CASES)
def test_bf16_sharded_steps_equal_one_process_steps(group, case, kind):
    """In bf16 activations the sharded steps stay with the port's
    one-process steps on the whole batches (run on each rank): the layers'
    gradients are summed over ranks in float32 and rounded once, as one
    GEMM over every row rounds its own, so Adam's sign-like first steps
    see the same gradients. The dense steps' gathered gradients and the
    sparse step's accumulators, which carry the gradients' scale, agree to
    1e-5 of their largest."""
    _, _, ranks, _ = group
    for res in ranks:
        got = res[case]["bf16"][kind]
        scale = got["grads"] if kind == "dense" else got["accum"]
        assert got["loss"] <= 1e-5 and got["params"] <= 1e-5 and scale <= 1e-5, got


def test_only_all_reduce_and_list_all_gather():
    """The sharded path issues no collective but ``all_reduce`` and the list
    ``all_gather`` (the two gloo runs on CUDA tensors), and builds no
    DTensor."""
    calls = set()
    for rel in ("tpu_tfrecord_torch/models/sharded.py", "tpu_tfrecord_torch/models/dlrm.py"):
        tree = ast.parse(open(os.path.join(REPO, rel)).read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name):
                if node.value.id == "dist":
                    calls.add(node.attr)
                assert node.attr not in ("from_local", "full_tensor", "redistribute"), rel
    assert calls == {"all_reduce", "all_gather"}


# -- batch_spec ----------------------------------------------------------------------


def _schemas(pkg):
    from importlib import import_module

    s = import_module(f"{pkg}.schema")
    return {
        # tests/test_ingest.py's SCHEMA with its pad_to and hash_buckets
        "scalars_array_hashed": (
            s.StructType([s.StructField("uid", s.LongType()), s.StructField("score", s.FloatType()),
                          s.StructField("emb", s.ArrayType(s.FloatType())),
                          s.StructField("cat", s.StringType())]),
            dict(pad_to={"emb": 4}, hash_buckets={"cat": 16})),
        # tests/test_ingest.py's SequenceExample frames, cast to bf16
        "array_of_arrays_bf16": (
            s.StructType([s.StructField("id", s.LongType()),
                          s.StructField("frames", s.ArrayType(s.ArrayType(s.FloatType())))]),
            dict(pad_to={"frames": (4, 4)}, cast="bf16")),
        # multi-hot ids without lengths, an int array, an unhashed string
        "multi_hot_no_lengths": (
            s.StructType([s.StructField("tags", s.ArrayType(s.StringType())),
                          s.StructField("ids", s.ArrayType(s.IntegerType())),
                          s.StructField("name", s.StringType()),
                          s.StructField("x", s.DoubleType())]),
            dict(pad_to={"tags": 3, "ids": 5}, hash_buckets={"tags": 32},
                 include_lengths=False)),
    }


def _spec_kw(kw: dict, bf16) -> dict:
    kw = dict(kw)
    if kw.pop("cast", None):
        kw["cast"] = {"frames": bf16}
    return kw


@pytest.mark.parametrize("name", ["scalars_array_hashed", "array_of_arrays_bf16",
                                  "multi_hot_no_lengths"])
def test_batch_spec_matches_jax(name):
    import ml_dtypes

    from tpu_tfrecord.tpu.ingest import batch_spec as jbatch_spec
    from tpu_tfrecord_torch.device.ingest import batch_spec

    jschema, kw = _schemas("tpu_tfrecord")[name]
    tschema, _ = _schemas("tpu_tfrecord_torch")[name]
    want = jbatch_spec(jschema, 8, **_spec_kw(kw, ml_dtypes.bfloat16))
    got = batch_spec(tschema, 8, **_spec_kw(kw, torch.bfloat16))
    assert list(got) == list(want)
    for k, s in want.items():
        dtype = (torch.bfloat16 if s.dtype == ml_dtypes.bfloat16
                 else torch.from_numpy(np.empty(0, s.dtype)).dtype)
        assert got[k].device.type == "meta"
        assert (tuple(got[k].shape), got[k].dtype) == (tuple(s.shape), dtype), k
    with pytest.raises(ValueError, match="no castable data column"):
        batch_spec(tschema, 8, cast={"nope": torch.bfloat16})


def _write_rows(name: str, out: str):
    from tpu_tfrecord_torch import io as tio

    schema, _ = _schemas("tpu_tfrecord_torch")[name]
    if name == "scalars_array_hashed":
        rows = [[i, i / 2.0, [float(i), float(i + 1), float(i + 2)], f"cat{i % 4}"]
                for i in range(8)]
        tio.write(rows, schema, out, mode="overwrite")
        return schema, "Example"
    rows = [[i, [[1.5 * i, 2.0], [3.0]][: 1 + i % 2]] for i in range(8)]
    tio.write(rows, schema, out, mode="overwrite", recordType="SequenceExample")
    return schema, "SequenceExample"


@pytest.mark.parametrize("name", ["scalars_array_hashed", "array_of_arrays_bf16"])
def test_batch_spec_matches_host_batch(tmp_path, name):
    from tpu_tfrecord_torch.device.ingest import batch_spec, host_batch_from_columnar
    from tpu_tfrecord_torch.io.dataset import TFRecordDataset

    out = str(tmp_path / name)
    schema, record_type = _write_rows(name, out)
    kw = _spec_kw(_schemas("tpu_tfrecord_torch")[name][1], torch.bfloat16)
    spec = batch_spec(schema, 8, **kw)
    ds = TFRecordDataset(out, batch_size=8, schema=schema, recordType=record_type)
    with ds.batches() as it:
        hb = host_batch_from_columnar(next(it), ds.schema, **kw)
    assert list(hb) == list(spec)
    for k, s in spec.items():
        arr = hb[k] if isinstance(hb[k], torch.Tensor) else torch.from_numpy(hb[k])
        assert (tuple(arr.shape), arr.dtype) == (tuple(s.shape), s.dtype), k


# -- train_dlrm over two ranks ---------------------------------------------------------


def _twin(tmp_path, data: str, sparse: bool, *args) -> list:
    """Two ranks of ``train_dlrm --device cpu`` under torchrun's
    environment; each rank's stdout lines."""
    port = _free_port()
    procs = []
    for rank in range(2):
        env = _quiet_env()
        env.update(RANK=str(rank), WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), DLRM_SPARSE="1" if sparse else "0")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "tpu_tfrecord_torch.train_dlrm", "--device", "cpu",
             "--data-dir", data, "--ckpt-dir", str(tmp_path / "ckpt"), *args],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            preexec_fn=_low_priority))
    logs = _wait_all(procs, TWIN_TIMEOUT_S, "the two train_dlrm ranks")
    assert all(rc == 0 for rc, _, _ in logs), [err[-3000:] for _, _, err in logs]
    return [out.splitlines() for _, out, _ in logs]


def _done(lines) -> str:
    return [line for line in lines if line.startswith("done:")][0].split(",")[0]


def test_train_dlrm_sparse_over_two_ranks_resumes_and_stops_together(tmp_path):
    """3 shards of 5 batches: rank 0's slot holds 2 of them, rank 1's one
    (10 batches over the 2 epochs). A run cut at step 9 saves each rank's
    own position at step 8; the rerun resumes each from its own, and both
    stop when rank 1's slot ends, 2 steps later (rank 0 alone would run
    12)."""
    from tpu_tfrecord_torch import checkpoint, train_dlrm

    data = str(tmp_path / "data")
    train_dlrm.generate(data, shards=3, rows=5 * train_dlrm.BATCH)
    first = _twin(tmp_path, data, True, "--max-steps", "9")
    assert [_done(lines) for lines in first] == ["done: 9 steps"] * 2
    states = [checkpoint.load_state(str(tmp_path / "ckpt"), r) for r in range(2)]
    assert all(st is not None for st in states) and states[0] != states[1]
    second = _twin(tmp_path, data, True)
    for lines, st in zip(second, states):
        assert lines[0] == f"resuming from {st}"
        assert _done(lines) == "done: 2 steps"
    assert [checkpoint.load_state(str(tmp_path / "ckpt"), r) for r in range(2)] == [None, None]


def test_train_dlrm_generate_writes_the_jax_example_rows(tmp_path):
    """The twin's column-wise ``generate`` writes the JAX example's files
    and, in each, its rows in its order."""
    import importlib.util

    from tpu_tfrecord_torch import train_dlrm, wire
    from tpu_tfrecord_torch.options import RecordType
    from tpu_tfrecord_torch.serde import TFRecordDeserializer, decode_record

    spec = importlib.util.spec_from_file_location(
        "jax_example_train_dlrm", os.path.join(REPO, "examples", "train_dlrm.py"))
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    want_dir, got_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    example.generate(want_dir, shards=3, rows=16)
    train_dlrm.generate(got_dir, shards=3, rows=16)
    names = sorted(os.listdir(want_dir))
    assert sorted(os.listdir(got_dir)) == names and "_SUCCESS" in names
    de = TFRecordDeserializer(train_dlrm.make_schema())
    for name in names:
        rows = [[list(decode_record(de, RecordType.EXAMPLE, r))
                 for r in wire.read_records(os.path.join(d, name))] for d in (want_dir, got_dir)]
        assert rows[0] == rows[1], name
        assert len(rows[0]) == (0 if name == "_SUCCESS" else 16)


def test_train_dlrm_dense_over_two_ranks(tmp_path):
    """The dense sharded step under the twin: both ranks take the steps asked."""
    from tpu_tfrecord_torch import train_dlrm

    data = str(tmp_path / "data")
    train_dlrm.generate(data, shards=2, rows=2 * train_dlrm.BATCH)
    lines = _twin(tmp_path, data, False, "--max-steps", "2")
    assert [_done(x) for x in lines] == ["done: 2 steps"] * 2


if __name__ == "__main__" and len(sys.argv) == 3 and sys.argv[1] == "worker":
    torch.set_num_threads(1)
    _spec = json.loads(sys.argv[2])
    _out = run_worker(_spec)
    with open(os.path.join(_spec["results"], f"rank{_spec['rank']}.json"), "w") as _fh:
        json.dump(_out, _fh)
