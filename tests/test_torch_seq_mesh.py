"""``long_doc`` and the LM over a (data 2, seq 2) mesh of gloo ranks against
the JAX package's sharded train steps, and the two sequence trainers over
two ranks.

One gloo group of 4 CPU processes is spawned once for the module, every
process running this file as its worker (``python test_torch_seq_mesh.py
worker SPEC``, importing only the port). Each rank loads the JAX weights
through ``interop``, cuts its part of the same numpy batches (``long_doc``:
``long_doc.batch_shardings``' placements, [B/2, L/2] frames; the LM: its
rows on 'data', the whole [B/2, L+1] token and segment rows) and takes
three Adam steps of ``train_step(mesh=, data_axis="data")``:

- ``long_doc`` with ring and with Ulysses attention (GQA, Hkv 2);
- the LM (zigzag causal ring) with and without packed-document
  ``segments``.

This process runs the JAX ``train_step`` under jit on 4 of the 8 CPU
devices, the weights and batches placed by the JAX shardings, and holds
every rank to it in float32: the losses at rel 1e-5; the parameters at
abs 1e-5, apart from entries whose gradient came within 1e-6 of zero
(held to Adam's step bound, as ``test_torch_long_doc.py`` explains); the
first step's gradients, summed over 'data', against ``jax.grad`` at 1e-5
of each tensor's largest (Adam would step the same parameters from twice
these gradients); the four ranks' parameters bit-equal after every step.

Then ``train_lm --mesh dp_sp --device cpu`` and ``train_longdoc --device
cpu`` over two ranks against one process, and one kill of the two-rank
``dp_sp`` run after step 10, whose rerun resumes at step 8 and repeats the
uninterrupted two-rank run's digests and losses bit for bit. Every spawn
is waited on with a timeout that kills it and fails.
"""

import functools
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_torch_dlrm_mesh import _free_port, _low_priority, _quiet_env, _wait_all  # noqa: E402

AXES = {"data": 2, "seq": 2}
GROUP = 4
GROUP_TIMEOUT_S = 120
TWIN_TIMEOUT_S = 120
STEPS = 3
RTOL_LOSS = 1e-5
ATOL_PARAM = 1e-5
RTOL_GRAD = 1e-5          # of the tensor's largest |gradient|
NEAR_ZERO = 1e-6
LONGDOC = dict(seq_dim=6, d_model=16, n_heads=4, n_kv_heads=2, n_layers=2, max_len=16,
               n_classes=3)
LM = dict(vocab_size=64, d_model=16, n_heads=4, n_layers=2, max_len=16)
BATCH = 8
LR = {"long_doc": 1e-3, "lm": 3e-3}
CASES = {"long_doc_ring": ("long_doc", "ring"), "long_doc_ulysses": ("long_doc", "ulysses"),
         "lm_zigzag": ("lm", None), "lm_zigzag_segments": ("lm", "segments")}


def _flat(tree, prefix=""):
    """A pytree of arrays (dicts and lists) as {"a/0/w": array}."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}{i}/"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def _unflat(flat: dict):
    """``_flat``'s inverse (digit keys are list indices)."""
    tree: dict = {}
    for key, v in flat.items():
        node, parts = tree, key.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = v

    def lists(t):
        if not isinstance(t, dict):
            return t
        if t and all(k.isdigit() for k in t):
            return [lists(t[str(i)]) for i in range(len(t))]
        return {k: lists(v) for k, v in t.items()}

    return lists(tree)


# -- the worker (imports the port only) -------------------------------------------


def _run_case(spec: dict, name: str, mesh) -> dict:
    import torch.distributed as dist

    from tpu_tfrecord_torch import interop
    from tpu_tfrecord_torch.models import long_doc, lm, optim, sharded

    family, flavour = CASES[name]
    data = np.load(os.path.join(spec["dir"], f"{name}.npz"))
    params = _unflat({k[2:]: data[k] for k in data.files if k.startswith("p/")})
    batches = [{k.split("/")[2]: data[k] for k in data.files if k.startswith(f"b/{s}/")}
               for s in range(STEPS)]
    di, si = sharded.axis_index(mesh, "data"), sharded.axis_index(mesh, "seq")
    per = BATCH // AXES["data"]
    if family == "long_doc":
        cfg = long_doc.LongDocConfig(dtype=torch.float32, sp_attention=flavour, **LONGDOC)
        tp = interop.long_doc_params_from_jax(params, cfg, device="cpu")
        to_jax = interop.long_doc_params_to_jax
        placements = long_doc.batch_shardings(mesh, batches[0])
    else:
        cfg = lm.LMConfig(dtype=torch.float32, **LM)
        tp = interop.lm_params_from_jax(params, cfg, device="cpu")
        to_jax = interop.lm_params_to_jax
        placements = None
    opt = optim.adam(tp, LR[family])
    losses, digests, near_zero, grads = [], [], None, {}
    for s, host in enumerate(batches):
        if family == "long_doc":
            local = {}
            for k, arr in host.items():
                t = torch.from_numpy(arr).narrow(0, di * per, per)
                if "Shard(dim=1)" in [repr(p) for p in placements[k]]:
                    lc = arr.shape[1] // AXES["seq"]
                    t = t.narrow(1, si * lc, lc)
                local[k] = t.contiguous()
            loss = long_doc.train_step(tp, opt, local, cfg, mesh=mesh, data_axis="data")
        else:
            rows = lambda a: torch.from_numpy(a[di * per:(di + 1) * per])  # noqa: E731
            segs = rows(host["segments"]) if "segments" in host else None
            loss = lm.train_step(tp, opt, rows(host["tokens"]), cfg, mesh=mesh,
                                 data_axis="data", seq_axis="seq", segments=segs)
        losses.append(float(loss))
        if s == 0:
            grads = _flat(to_jax(_leaf_map(lambda p: p.grad.detach().clone(), tp)))
        masks = _flat(_leaf_map(lambda p: ((p.grad != 0) & (p.grad.abs() < NEAR_ZERO)).numpy(),
                                tp))
        near_zero = masks if near_zero is None else {k: near_zero[k] | m
                                                     for k, m in masks.items()}
        digests.append(sha(optim.param_leaves(tp)))
    dist.barrier()
    arrays = {f"{name}/param/{k}": v for k, v in _flat(to_jax(tp)).items()}
    arrays.update({f"{name}/grad/{k}": v for k, v in grads.items()})
    arrays.update({f"{name}/near_zero/{k}": m for k, m in near_zero.items()})
    return {"losses": losses, "digests": digests}, arrays


def _leaf_map(fn, tree):
    """The tree of ``fn`` of each tensor of ``tree`` (dicts and lists)."""
    if isinstance(tree, dict):
        return {k: _leaf_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_leaf_map(fn, v) for v in tree]
    return fn(tree)


def sha(leaves) -> str:
    import hashlib

    h = hashlib.sha256()
    for t in leaves:
        h.update(t.detach().contiguous().numpy().tobytes())
    return h.hexdigest()


def _long_doc_shardings(spec: dict, mesh) -> dict:
    """``long_doc.param_shardings`` / ``batch_shardings`` on the mesh, as
    reprs by flat key."""
    from tpu_tfrecord_torch import interop
    from tpu_tfrecord_torch.models import long_doc

    data = np.load(os.path.join(spec["dir"], "long_doc_ring.npz"))
    cfg = long_doc.LongDocConfig(dtype=torch.float32, **LONGDOC)
    params = interop.long_doc_params_from_jax(
        _unflat({k[2:]: data[k] for k in data.files if k.startswith("p/")}), cfg, device="cpu")
    batch = {k.split("/")[2]: data[k] for k in data.files if k.startswith("b/0/")}
    flat = _flat(_leaf_map(lambda p: np.array(0), params))
    placed = long_doc.param_shardings(mesh, params)
    return {"params": {k: [repr(p) for p in v] for k, v in
                       zip(flat, _leaves_in_order(placed, flat))},
            "batch": {k: [repr(p) for p in v]
                      for k, v in long_doc.batch_shardings(mesh, batch).items()}}


def _leaves_in_order(tree, flat: dict) -> list:
    """The leaves of ``tree`` (placements tuples) at ``flat``'s keys."""
    out = []
    for key in flat:
        node = tree
        for part in key.split("/"):
            node = node[int(part)] if isinstance(node, list) else node[part]
        out.append(node)
    return out


def run_worker(spec: dict) -> dict:
    sys.path.insert(0, REPO)
    from tpu_tfrecord_torch.device import distributed, mesh as meshes

    distributed.initialize(spec["addr"], GROUP, spec["rank"])
    mesh = meshes.create_mesh(AXES, device_type="cpu")
    out, arrays = {"coords": {a: int(mesh.get_local_rank(a)) for a in AXES}}, {}
    out["shardings"] = _long_doc_shardings(spec, mesh)
    for name in CASES:
        out[name], arr = _run_case(spec, name, mesh)
        arrays.update(arr)
    np.savez(os.path.join(spec["results"], f"rank{spec['rank']}.npz"), **arrays)
    return out


# -- the JAX side (this process) -------------------------------------------------


def _jax_mesh():
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()[:GROUP]).reshape(tuple(AXES.values())), tuple(AXES))


def _inputs(name: str):
    """The JAX weights and STEPS global batches of ``name`` (numpy)."""
    import jax
    import jax.numpy as jnp

    from tpu_tfrecord.models import lm as jlm, long_doc as jld
    from tpu_tfrecord.tpu.ingest import TokenPacker

    family, flavour = CASES[name]
    if family == "long_doc":
        cfg = jld.LongDocConfig(dtype=jnp.float32, sp_attention=flavour, **LONGDOC)
        params = jax.tree.map(np.asarray, jld.init_params(jax.random.key(3), cfg))
        batches = []
        for s in range(STEPS):
            hb = jld.make_synthetic_batch(cfg, BATCH, seed=20 + s)
            hb["label"] = np.random.default_rng(s).integers(0, 3, BATCH).astype(np.int32)
            batches.append(hb)
        return cfg, params, batches
    cfg = jlm.LMConfig(dtype=jnp.float32, **LM)
    params = jax.tree.map(np.asarray, jlm.init_params(jax.random.key(4), cfg))
    batches = []
    if flavour == "segments":
        rng = np.random.default_rng(9)
        pk = TokenPacker(BATCH, LM["max_len"], packing="best_fit")
        while len(batches) < STEPS:
            pk.feed_docs(rng.integers(1, LM["vocab_size"], size=int(n))
                         for n in rng.integers(1, 12, size=12))
            b = pk.pop()
            if b is not None:
                batches.append({"tokens": b["tokens"], "segments": b["segment_ids"]})
    else:
        batches = [{"tokens": jlm.make_synthetic_tokens(cfg, BATCH, seed=30 + s)}
                   for s in range(STEPS)]
    return cfg, params, batches


def _jax_run(name: str, cfg, params, batches):
    """(losses, final params, the first step's gradients) of the JAX
    sharded step under jit."""
    import jax
    import optax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from tpu_tfrecord.models import lm as jlm, long_doc as jld

    family, _ = CASES[name]
    mesh = _jax_mesh()
    tx = optax.adam(LR[family])
    if family == "long_doc":
        p = jax.device_put(params, jld.param_shardings(mesh, params))
        kw = dict(mesh=mesh, data_axis="data")
        step = jax.jit(functools.partial(jld.train_step, cfg=cfg, tx=tx, **kw))
        grad = jax.jit(jax.grad(functools.partial(jld.loss_fn, cfg=cfg, **kw)))
        place = lambda h: jax.device_put(h, jld.batch_shardings(mesh, h))  # noqa: E731
        call = lambda fn, p, *a, h: fn(p, *a, place(h))  # noqa: E731
    else:
        p = jax.device_put(params, NamedSharding(mesh, P()))
        kw = dict(mesh=mesh, data_axis="data", seq_axis="seq")
        step = jax.jit(functools.partial(jlm.train_step, cfg=cfg, tx=tx, **kw))
        grad = jax.jit(jax.grad(functools.partial(jlm.loss_fn, cfg=cfg, **kw)))
        rows = NamedSharding(mesh, P("data", None))

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
    return losses, _flat(jax.tree.map(np.asarray, p)), grads


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """Spawn the 4-rank group once; returns (JAX runs by case, rank
    results, rank arrays by rank)."""
    base = str(tmp_path_factory.mktemp("seq_mesh"))
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
    return jax_runs, ranks, arrays


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_losses_match_jax(group, name):
    jax_runs, ranks, _ = group
    want = jax_runs[name][0]
    for res in ranks:
        np.testing.assert_allclose(res[name]["losses"], want, rtol=RTOL_LOSS, atol=0)


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_params_match_jax(group, name):
    """After three steps every rank's parameters (in JAX's layout) are
    JAX's within 1e-5; entries whose gradient came within 1e-6 of zero on
    some step are held to the most Adam moves them, lr a step, and are
    few."""
    jax_runs, _, arrays = group
    want = jax_runs[name][1]
    lr = LR[CASES[name][0]]
    for arr in arrays:
        got = {k.split("/param/", 1)[1]: v for k, v in arr.items()
               if k.startswith(f"{name}/param/")}
        masks = {k: arr[f"{name}/near_zero/{k}"] for k in want}
        assert sorted(got) == sorted(want)
        n_loose = sum(int(m.sum()) for m in masks.values())
        assert n_loose < 0.02 * sum(w.size for w in want.values()), n_loose
        for key, w in want.items():
            t, w, m = got[key].copy(), w.copy(), masks[key]
            if m.any():
                assert np.abs(t[m] - w[m]).max() <= STEPS * lr * (1 + 1e-3), key
                t[m] = w[m] = 0.0
            np.testing.assert_allclose(t, w, rtol=0, atol=ATOL_PARAM, err_msg=f"{name} {key}")


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_gradients_match_jax_grad(group, name):
    """The first step's gradients, summed over 'seq' (``copy_to``) and over
    'data' (``sum_grads``), equal ``jax.grad`` of the JAX loss on every
    rank: Adam is blind to a gradient counted twice, this is not."""
    jax_runs, _, arrays = group
    want = jax_runs[name][2]
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


def test_long_doc_shardings_match_jax(group):
    """``long_doc.param_shardings`` (every parameter replicated) and
    ``batch_shardings`` ('frames' on (data, seq), the rest on 'data') give
    the JAX functions' placements, as the port's per-mesh-dim tuples."""
    from test_torch_dlrm_mesh import _as_placements
    from tpu_tfrecord.models import long_doc as jld

    _, ranks, _ = group
    _, params, batches = _inputs("long_doc_ring")
    mesh = _jax_mesh()
    want_params = {k: _as_placements(s.spec, np.ndim(_flat(params)[k]), tuple(AXES), False)
                   for k, s in _flat_shardings(jld.param_shardings(mesh, params)).items()}
    want_batch = {k: _as_placements(s.spec, batches[0][k].ndim, tuple(AXES), False)
                  for k, s in jld.batch_shardings(mesh, batches[0]).items()}
    assert want_batch["frames"] == ["Shard(dim=0)", "Shard(dim=1)"]
    assert want_batch["label"] == ["Shard(dim=0)", "Replicate()"]
    assert set(map(tuple, want_params.values())) == {("Replicate()", "Replicate()")}
    for res in ranks:
        assert res["shardings"]["params"] == want_params
        assert res["shardings"]["batch"] == want_batch


def _flat_shardings(tree) -> dict:
    """``_flat`` for a pytree whose leaves are shardings."""
    import jax

    paths = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", None))) for k in path): leaf
            for path, leaf in paths}


@pytest.mark.parametrize("name", list(CASES))
def test_ranks_hold_bit_equal_parameters(group, name):
    _, ranks, _ = group
    first = ranks[0][name]["digests"]
    assert len(first) == STEPS and len(set(first)) == STEPS
    for res in ranks[1:]:
        assert res[name]["digests"] == first
    assert sorted(tuple(r["coords"].values()) for r in ranks) == [(0, 0), (0, 1), (1, 0), (1, 1)]


# -- the trainers over two ranks ---------------------------------------------------------


def _ranks(module: str, args: list, tmp_path, tag: str, env_extra=None) -> list:
    """Two ranks of ``python -m module --device cpu args`` under torchrun's
    environment, their stdout to ``tmp_path/<tag><r>.log``; returns the
    processes and the log paths."""
    port = _free_port()
    procs, logs = [], []
    for rank in range(2):
        env = _quiet_env()
        env.update(RANK=str(rank), WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), **(env_extra or {}))
        env.pop("LM_MESH", None)
        log = str(tmp_path / f"{tag}{rank}.log")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", module, "--device", "cpu", *args], cwd=REPO, env=env,
            stdout=open(log, "w"), stderr=subprocess.PIPE, text=True,
            preexec_fn=_low_priority))
    return procs, logs


def _finish(procs, logs, what: str) -> list:
    out = _wait_all(procs, TWIN_TIMEOUT_S, what)
    assert all(rc == 0 for rc, _, _ in out), [err[-3000:] for _, _, err in out]
    return [open(log).read().splitlines() for log in logs]


def _one(module: str, args: list, env_extra=None) -> list:
    env = _quiet_env()
    env.pop("LM_MESH", None)
    env.update(env_extra or {})
    proc = subprocess.run([sys.executable, "-m", module, "--device", "cpu", *args], cwd=REPO,
                          env=env, capture_output=True, text=True, timeout=TWIN_TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout.splitlines()


def _lm_steps(lines) -> dict:
    return {json.loads(ln.split(" ", 1)[1])["step"]: json.loads(ln.split(" ", 1)[1])
            for ln in lines if ln.startswith("lm_step ")}


@pytest.fixture(scope="module")
def lm_data(tmp_path_factory):
    from tpu_tfrecord_torch import train_lm

    d = str(tmp_path_factory.mktemp("lm") / "data")
    train_lm.generate(d, shards=2, docs=64)
    return d


def test_train_lm_dp_sp_over_two_ranks_matches_one_process(lm_data, tmp_path):
    """Two ranks pick {data 1, seq 2} and train 2 layers with the zigzag
    ring; every rank reads and packs the whole stream (the same batch
    digests as one process), and the losses follow one process's within
    rel 1e-5 (the ring's online softmax sums in another order)."""
    common = ["--mesh", "dp_sp", "--data-dir", lm_data, "--steps", "6", "--save-every", "4",
              "--digest-out"]
    one = _one("tpu_tfrecord_torch.train_lm", common + [str(tmp_path / "one.jsonl"),
                                                     "--ckpt-dir", str(tmp_path / "ck1")])
    procs, logs = _ranks("tpu_tfrecord_torch.train_lm",
                         common + [str(tmp_path / "two.jsonl"), "--ckpt-dir",
                                   str(tmp_path / "ck2")], tmp_path, "lm")
    two = _finish(procs, logs, "the two train_lm ranks")
    assert one[0].startswith("mesh: {'data': 1} mode=dp_sp (one device")
    for r, lines in enumerate(two):
        assert lines[0].startswith("mesh: {'data': 1, 'seq': 2} mode=dp_sp (2 ranks: 2 layers,")
        assert any(ln.startswith("done: 6 steps") for ln in lines)
    want, got = _lm_steps(one), [_lm_steps(lines) for lines in two]
    assert sorted(want) == sorted(got[0]) == sorted(got[1]) == list(range(1, 7))
    for s in want:
        assert got[0][s] == got[1][s]
        assert got[0][s]["digest"] == want[s]["digest"]
        np.testing.assert_allclose(float(got[0][s]["loss"]), float(want[s]["loss"]), rtol=1e-5)
    # rank 0 alone writes the digest file
    assert len(open(tmp_path / "two.jsonl").read().splitlines()) == 6


def test_train_lm_dp_sp_kill_and_resume_over_two_ranks(lm_data, tmp_path):
    """The two ranks SIGKILLed once rank 0 printed step 10 (generation 8
    committed) resume at step 8 and repeat the uninterrupted two-rank
    run's digests and losses bit for bit."""
    common = ["--mesh", "dp_sp", "--data-dir", lm_data, "--steps", "12", "--save-every", "4"]
    ref_p, ref_l = _ranks("tpu_tfrecord_torch.train_lm",
                          common + ["--digest-out", str(tmp_path / "ref.jsonl"), "--ckpt-dir",
                                    str(tmp_path / "ref_ck")], tmp_path, "ref")
    ref = _finish(ref_p, ref_l, "the uninterrupted train_lm ranks")
    ck = ["--digest-out", str(tmp_path / "run.jsonl"), "--ckpt-dir", str(tmp_path / "ck")]
    procs, logs = _ranks("tpu_tfrecord_torch.train_lm", common + ck, tmp_path, "run")
    gen8 = os.path.join(str(tmp_path / "ck"), f"gen-{8:08d}", "MANIFEST.json")
    deadline = time.monotonic() + TWIN_TIMEOUT_S
    killed = False
    try:
        while time.monotonic() < deadline and all(p.poll() is None for p in procs):
            if 10 in _lm_steps(open(logs[0]).read().splitlines()) and os.path.exists(gen8):
                for p in procs:
                    p.send_signal(signal.SIGKILL)
                killed = True
                break
            time.sleep(0.01)
    finally:
        for p in procs:
            if p.poll() is None and not killed:
                p.kill()
            p.wait()
            p.stderr.close()
    assert killed and all(p.returncode == -signal.SIGKILL for p in procs), \
        [p.returncode for p in procs]
    procs, logs = _ranks("tpu_tfrecord_torch.train_lm", common + ck, tmp_path, "again")
    again = _finish(procs, logs, "the resumed train_lm ranks")
    want = _lm_steps(ref[0])
    for lines in again:
        assert "resumed at step 8" in lines[:3], lines[:3]
        got = _lm_steps(lines)
        assert sorted(got) == list(range(9, 13))
        for s in got:
            assert got[s] == want[s]  # digest and loss, bit for bit
    assert _lm_steps(ref[1]) == want


@pytest.mark.parametrize("flavour", ["ring", "ulysses"])
def test_train_longdoc_over_two_ranks_matches_one_process(tmp_path, flavour):
    """Two ranks pick {data 1, seq 2} (the JAX example's picker) and train
    with ``LONGDOC_SP_ATTENTION``; each keeps its half of the frames, both
    stop after the steps asked, and the printed losses follow one
    process's dense attention within bf16 rounding (2e-2)."""
    from tpu_tfrecord_torch import train_longdoc

    data = str(tmp_path / "data")
    train_longdoc.generate(data, shards=4, rows=64)  # 4 steps an epoch
    env = {"LONGDOC_SP_ATTENTION": flavour}
    args = ["--data-dir", data, "--max-steps", "8"]
    one = _one("tpu_tfrecord_torch.train_longdoc", args + ["--ckpt-dir", str(tmp_path / "c1")],
               env)
    procs, logs = _ranks("tpu_tfrecord_torch.train_longdoc",
                         args + ["--ckpt-dir", str(tmp_path / "c2")], tmp_path, "ld", env)
    two = _finish(procs, logs, "the two train_longdoc ranks")
    loss = lambda lines: [float(ln.split("~")[1]) for ln in lines  # noqa: E731
                          if ln.startswith("step ") and "loss" in ln]
    assert loss(one)
    for r, lines in enumerate(two):
        assert lines[0] == (f"mesh: {{'data': 1, 'seq': 2}} sp_attention={flavour} (rank {r}: "
                            f"data 0, frames [{32 * r}, {32 * (r + 1)}))")
        assert any(ln.startswith("done: 8 steps") for ln in lines)
        np.testing.assert_allclose(loss(lines), loss(one), atol=2e-2)
    assert train_longdoc.pick_mesh(1) == {"data": 1, "seq": 1}
    assert train_longdoc.pick_mesh(8) == {"data": 2, "seq": 4}
    assert train_longdoc.pick_mesh(2) == {"data": 1, "seq": 2}


def test_pick_mesh_over_ranks_matches_the_jax_example(monkeypatch):
    """``train_lm.pick_mesh`` over W ranks is the JAX example's over W
    devices for dp_sp and dp; the kinds not ported over ranks raise."""
    import jax

    from tpu_tfrecord_torch import train_lm as tw
    from tpu_tfrecord_torch.options import OptionNotPortedError

    sys.path.insert(0, os.path.join(REPO, "examples"))
    import train_lm as jx

    every = jax.devices()
    for world in (2, 4, 8):
        monkeypatch.setattr(jax, "devices", lambda *a, **k: every[:world])
        for kind in ("dp_sp", "dp"):
            jmesh, jaxes, jlayers = jx.pick_mesh(kind)
            shape, axes, layers = tw.pick_mesh(kind, world=world)
            assert (shape, axes, layers) == (dict(jmesh.shape), jaxes, jlayers)
        for kind in ("dp_pp", "dp_fsdp", "dp_fsdp_pp"):
            with pytest.raises(OptionNotPortedError, match=kind):
                tw.pick_mesh(kind, world=world)


if __name__ == "__main__" and len(sys.argv) == 3 and sys.argv[1] == "worker":
    torch.set_num_threads(1)
    _spec = json.loads(sys.argv[2])
    _out = run_worker(_spec)
    with open(os.path.join(_spec["results"], f"rank{_spec['rank']}.json"), "w") as _fh:
        json.dump(_out, _fh)
