"""The port's sequence-parallel attention over gloo ranks against the JAX
``ring_attention`` and ``ulysses_attention``.

One gloo group of 4 CPU processes is spawned once for the module, every
process running this file as its worker (``python
test_torch_sp_attention.py worker SPEC``, importing only the port). On
two meshes, {seq 4} and {data 2, seq 2}, each rank takes its chunk of the
same numpy q, k, v (``[B/data, L/seq, H, D]``, k and v with Hkv heads),
``lengths`` and ``segments``, runs the port's flavour, differentiates the
sum of its output times its chunk of a fixed cotangent, and writes its
output and the gradients of q, k and v. This process runs the JAX
function on the same arrays over 4 of the 8 CPU devices (``jax.vjp``
with the same cotangent) and holds every rank's chunk to the matching
slice of JAX's: outputs at ``atol=1e-5``, gradients at 1e-5 of each
tensor's largest, float32.

The cases: the ring contiguous (with ``lengths`` and ``segments``),
causal, and zigzag causal with ``segments``, each for MHA, GQA (Hkv 2)
and MQA (Hkv 1); Ulysses causal with ``lengths`` and causal with
``segments`` where the axis divides H and Hkv. Each rank also makes the
calls JAX refuses on the mesh and records the ``ValueError``s, held to
JAX's messages. The spawn is waited on with a timeout that kills the
group and fails.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_torch_dlrm_mesh import _free_port, _low_priority, _quiet_env, _wait_all  # noqa: E402

MESHES = {"seq4": {"seq": 4}, "data2_seq2": {"data": 2, "seq": 2}}
B, L, H, D = 4, 16, 4, 8
GROUP = 4
GROUP_TIMEOUT_S = 120
ATOL_OUT = 1e-5
RTOL_GRAD = 1e-5          # of the tensor's largest |gradient|
RING = {"contiguous": dict(lengths=True, segments=True),
        "causal": dict(causal=True),
        "zigzag_segments": dict(causal=True, zigzag=True, segments=True)}
ULYSSES = {"causal_lengths": dict(causal=True, lengths=True),
           "causal_segments": dict(causal=True, segments=True)}


def _cases():
    """(mesh, flavour, kind, hkv) of every case."""
    out = []
    for mesh, axes in MESHES.items():
        for kind in RING:
            for hkv in (4, 2, 1):
                out.append((mesh, "ring_attention", kind, hkv))
        for kind in ULYSSES:
            for hkv in (4, 2, 1):
                if H % axes["seq"] == 0 and hkv % axes["seq"] == 0:
                    out.append((mesh, "ulysses_attention", kind, hkv))
    return out


CASES = _cases()


def _case_id(case) -> str:
    return "-".join(str(c) for c in case)


def _kwargs(flavour: str, kind: str) -> dict:
    return (RING if flavour == "ring_attention" else ULYSSES)[kind]


def _inputs(hkv: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, L + 1, size=B).astype(np.int32)
    # packed documents: ids rise along each row, padding (0) at a tail
    segments = np.sort(rng.integers(1, 4, size=(B, L)), axis=1).astype(np.int32)
    segments[1, L - 3:] = 0
    return dict(q=rng.normal(size=(B, L, H, D)).astype(np.float32),
                k=rng.normal(size=(B, L, hkv, D)).astype(np.float32),
                v=rng.normal(size=(B, L, hkv, D)).astype(np.float32),
                cot=rng.normal(size=(B, L, H, D)).astype(np.float32),
                lengths=lengths, segments=segments)


def _bad_calls(p: int) -> list:
    """Calls JAX refuses on a seq axis of ``p``: (flavour, q and k/v shapes
    of the GLOBAL arrays, kwargs). A length of 3p divides by p, not by 2p."""
    return [("ring_attention", (B, 3 * p, H, D), (B, 3 * p, H, D), dict(zigzag=True, causal=True)),
            ("ring_attention", (B, L, H, D), (B, L, H, D), dict(zigzag=True)),
            ("ulysses_attention", (B, L, 3, D), (B, L, 3, D), {}),
            ("ulysses_attention", (B, L, H, D), (B, L, 1, D), {})]


# -- the worker (imports the port only) -------------------------------------------


def _local(arr: np.ndarray, mesh, seq: bool = True) -> torch.Tensor:
    """This rank's rows on 'data' and, with ``seq``, its chunk on 'seq'."""
    from tpu_tfrecord_torch.models import sharded

    t = torch.from_numpy(arr)
    n, i = sharded.axis_size(mesh, "data"), sharded.axis_index(mesh, "data")
    t = t.narrow(0, i * t.shape[0] // n, t.shape[0] // n)
    if seq:
        n, i = sharded.axis_size(mesh, "seq"), sharded.axis_index(mesh, "seq")
        t = t.narrow(1, i * t.shape[1] // n, t.shape[1] // n)
    return t.contiguous()


def run_worker(spec: dict) -> dict:
    sys.path.insert(0, REPO)
    import torch.distributed as dist

    from tpu_tfrecord_torch.device import distributed, mesh as meshes
    from tpu_tfrecord_torch.models import attention

    distributed.initialize(spec["addr"], GROUP, spec["rank"])
    out, arrays = {}, {}
    for name, axes in MESHES.items():
        mesh = meshes.create_mesh(axes, device_type="cpu")
        data_axis = "data" if "data" in axes else None
        for case in CASES:
            if case[0] != name:
                continue
            _, flavour, kind, hkv = case
            inp = np.load(os.path.join(spec["dir"], f"{_case_id(case)}.npz"))
            q, k, v = (_local(inp[n], mesh).requires_grad_(True) for n in ("q", "k", "v"))
            kw = {n: x for n, x in _kwargs(flavour, kind).items() if n in ("causal", "zigzag")}
            if _kwargs(flavour, kind).get("lengths"):
                kw["lengths"] = _local(inp["lengths"], mesh, seq=False)
            if _kwargs(flavour, kind).get("segments"):
                kw["segments"] = _local(inp["segments"], mesh)
            got = getattr(attention, flavour)(q, k, v, mesh, seq_axis="seq",
                                              data_axis=data_axis, **kw)
            (got * _local(inp["cot"], mesh)).sum().backward()
            tag = _case_id(case)
            arrays.update({f"{tag}/out/{spec['rank']}": got.detach().numpy(),
                           f"{tag}/dq/{spec['rank']}": q.grad.numpy(),
                           f"{tag}/dk/{spec['rank']}": k.grad.numpy(),
                           f"{tag}/dv/{spec['rank']}": v.grad.numpy()})
        errors = []
        p = axes["seq"]
        for flavour, qs, kvs, kw in _bad_calls(p):
            local = lambda s: torch.zeros(s[0], s[1] // p, *s[2:])  # noqa: E731
            try:
                getattr(attention, flavour)(local(qs), local(kvs), local(kvs), mesh, **kw)
                errors.append(None)
            except ValueError as e:
                errors.append(str(e))
        try:  # segments of the wrong shape
            attention.ring_attention(*(torch.zeros(B, L // p, H, D) for _ in range(3)), mesh,
                                     segments=torch.zeros(B, L // p + 1, dtype=torch.int32))
            errors.append(None)
        except ValueError as e:
            errors.append(str(e))
        out[name] = {"errors": errors,
                     "coords": {a: int(mesh.get_local_rank(a)) for a in axes}}
        dist.barrier()
    np.savez(os.path.join(spec["results"], f"rank{spec['rank']}.npz"), **arrays)
    return out


# -- the JAX side (this process) -------------------------------------------------


def _jax_mesh(name: str):
    import jax
    from jax.sharding import Mesh

    axes = MESHES[name]
    return Mesh(np.array(jax.devices()[:GROUP]).reshape(tuple(axes.values())), tuple(axes))


def _jax_run(case) -> dict:
    """JAX's output and the gradients of q, k, v against the cotangent."""
    import jax
    import jax.numpy as jnp

    from tpu_tfrecord.models import attention as jatt

    name, flavour, kind, hkv = case
    inp = _inputs(hkv, seed=CASES.index(case))
    kw = {n: x for n, x in _kwargs(flavour, kind).items() if n in ("causal", "zigzag")}
    if _kwargs(flavour, kind).get("lengths"):
        kw["lengths"] = jnp.asarray(inp["lengths"])
    if _kwargs(flavour, kind).get("segments"):
        kw["segments"] = jnp.asarray(inp["segments"])
    data_axis = "data" if "data" in MESHES[name] else None
    mesh = _jax_mesh(name)

    def f(q, k, v):
        return getattr(jatt, flavour)(q, k, v, mesh, seq_axis="seq", data_axis=data_axis, **kw)

    @jax.jit
    def run(q, k, v, cot):
        out, vjp = jax.vjp(f, q, k, v)
        return (out,) + vjp(cot)

    out, dq, dk, dv = run(*(jnp.asarray(inp[n]) for n in ("q", "k", "v", "cot")))
    return dict(inputs=inp, out=np.asarray(out), dq=np.asarray(dq), dk=np.asarray(dk),
                dv=np.asarray(dv))


def _jax_errors(name: str) -> list:
    import jax.numpy as jnp

    from tpu_tfrecord.models import attention as jatt

    mesh = _jax_mesh(name)
    out = []
    for flavour, qs, kvs, kw in _bad_calls(MESHES[name]["seq"]):
        try:
            getattr(jatt, flavour)(jnp.zeros(qs), jnp.zeros(kvs), jnp.zeros(kvs), mesh, **kw)
            out.append(None)
        except ValueError as e:
            out.append(str(e))
    try:
        jatt.ring_attention(*(jnp.zeros((B, L, H, D)) for _ in range(3)), mesh,
                            segments=jnp.zeros((B, L + 1), jnp.int32))
        out.append(None)
    except ValueError as e:
        out.append(str(e))
    return out


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """Spawn the 4-rank group once; returns (JAX runs by case, JAX errors by
    mesh, rank results, rank arrays)."""
    base = str(tmp_path_factory.mktemp("sp_attention"))
    spec = {"dir": base, "results": os.path.join(base, "results"),
            "addr": f"127.0.0.1:{_free_port()}"}
    os.makedirs(spec["results"])
    for case in CASES:
        np.savez(os.path.join(base, f"{_case_id(case)}.npz"),
                 **_inputs(case[3], seed=CASES.index(case)))
    procs = [subprocess_rank(spec, r) for r in range(GROUP)]
    # the JAX side runs while the ranks start up
    jax_runs = {case: _jax_run(case) for case in CASES}
    jax_errors = {name: _jax_errors(name) for name in MESHES}
    logs = _wait_all(procs, GROUP_TIMEOUT_S, f"the group of {GROUP}")
    bad = [(r, rc, err[-3000:]) for r, (rc, _, err) in enumerate(logs) if rc != 0]
    assert not bad, bad
    ranks = [json.load(open(os.path.join(spec["results"], f"rank{r}.json")))
             for r in range(GROUP)]
    arrays = {}
    for r in range(GROUP):
        arrays.update(dict(np.load(os.path.join(spec["results"], f"rank{r}.npz"))))
    return jax_runs, jax_errors, ranks, arrays


def subprocess_rank(spec: dict, rank: int):
    import subprocess

    return subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "worker", json.dumps(dict(spec, rank=rank))],
        cwd=REPO, env=_quiet_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        preexec_fn=_low_priority)


def _slice(arr: np.ndarray, coords: dict, axes: dict) -> np.ndarray:
    """The block of a global [B, L, ...] array that the rank at ``coords``
    holds."""
    n, i = axes.get("data", 1), coords.get("data", 0)
    arr = arr[i * arr.shape[0] // n:(i + 1) * arr.shape[0] // n]
    n, i = axes["seq"], coords["seq"]
    return arr[:, i * arr.shape[1] // n:(i + 1) * arr.shape[1] // n]


@pytest.mark.parametrize("case", CASES, ids=[_case_id(c) for c in CASES])
def test_outputs_and_gradients_match_jax(group, case):
    jax_runs, _, ranks, arrays = group
    want = jax_runs[case]
    axes = MESHES[case[0]]
    tag = _case_id(case)
    for r, res in enumerate(ranks):
        coords = res[case[0]]["coords"]
        got = arrays[f"{tag}/out/{r}"]
        np.testing.assert_allclose(got, _slice(want["out"], coords, axes), rtol=0,
                                   atol=ATOL_OUT, err_msg=f"{tag} rank {r} output")
        for g in ("dq", "dk", "dv"):
            scale = np.abs(want[g]).max()
            assert scale > 0, (tag, g)
            np.testing.assert_allclose(arrays[f"{tag}/{g}/{r}"], _slice(want[g], coords, axes),
                                       rtol=0, atol=RTOL_GRAD * scale,
                                       err_msg=f"{tag} rank {r} {g}")


@pytest.mark.parametrize("name", list(MESHES))
def test_value_errors_match_jax(group, name):
    """The calls JAX refuses raise the same ``ValueError`` on every rank:
    the ring's zigzag without causal and a length not divisible by 2p,
    Ulysses' head counts the axis does not divide (same messages), and
    segments of the wrong shape (the port names this rank's chunk)."""
    _, jax_errors, ranks, _ = group
    want = jax_errors[name]
    assert all(w is not None for w in want), want
    for res in ranks:
        got = res[name]["errors"]
        assert got[:-1] == want[:-1]
        assert got[-1] is not None and got[-1].startswith("segments shape (")
        assert want[-1].startswith("segments shape (")


def test_gradients_reach_other_ranks_blocks(group):
    """In the ring a key on rank 0 is attended by queries on later ranks:
    its gradient is the sum over the ranks whose queries saw it, carried
    back by the reversed hops. Rank 0's dk on the causal {seq 4} case is
    held to JAX's (above) and is not the gradient of its own queries alone:
    the part from later ranks is large."""
    jax_runs, _, ranks, arrays = group
    case = ("seq4", "ring_attention", "causal", 4)
    want = jax_runs[case]
    r0 = [r for r, res in enumerate(ranks) if res["seq4"]["coords"]["seq"] == 0][0]
    got = arrays[f"{_case_id(case)}/dk/{r0}"]
    assert np.abs(got).max() > 0
    # the gradient of rank 0's keys through its own queries only
    import jax
    import jax.numpy as jnp

    from tpu_tfrecord.models import attention as jatt

    inp = want["inputs"]
    lc = L // 4

    def own(k0):
        k = jnp.asarray(inp["k"]).at[:, :lc].set(k0)
        out = jatt.attention_reference(jnp.asarray(inp["q"]), k, jnp.asarray(inp["v"]),
                                       causal=True)
        return jnp.sum(out[:, :lc] * jnp.asarray(inp["cot"])[:, :lc])

    alone = np.asarray(jax.grad(own)(jnp.asarray(inp["k"])[:, :lc]))
    assert np.abs(got - alone).max() > 100 * RTOL_GRAD * np.abs(want["dk"]).max()


if __name__ == "__main__" and len(sys.argv) == 3 and sys.argv[1] == "worker":
    torch.set_num_threads(1)
    _spec = json.loads(sys.argv[2])
    _out = run_worker(_spec)
    with open(os.path.join(_spec["results"], f"rank{_spec['rank']}.json"), "w") as _fh:
        json.dump(_out, _fh)
