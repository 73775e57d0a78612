"""Pipelined LM training on one card (``models.pipeline``, ``models.lm``'s
pipe mode, ``train_lm --mesh dp_pp``) against the JAX package.

- The port's loss and gradients through the schedule (S stages as a tensor
  dimension, V chunks a stage, M microbatches) equal the JAX dense
  ``lm.loss_fn`` and ``jax.grad`` on the same weights (carried across with
  ``interop.lm_params_from_jax``), for (S, V, M) in (1, 1, 2), (2, 1, 8),
  (2, 2, 4) and (4, 1, 8), and the port's own sequential model. The JAX
  ``pipeline_apply`` is not the reference: it is red on the installed jax.
- Gradients through ``pipeline_apply`` equal those through
  ``pipeline_reference``.
- ``diagnostics=True`` reports the bubble the schedule paid exactly:
  (S-1)/(M+S-1), (S-1)/(V·M+S-1) interleaved, and over the real stream of
  a ragged M, as ``tests/test_lm.py`` and ``tests/test_pipeline_parallel.py``
  pin it for the JAX schedule.
- Every refusal of the pipe mode has the JAX exception type; the other
  mesh modes still raise ``OptionNotPortedError``.
- ``pick_mesh("dp_pp")`` is the JAX example's on two devices; ``train_lm
  --mesh dp_pp`` trains 4 layers in 2 stages with 8 microbatches and folds
  the bubble into its gauges, and a run SIGKILLed after step 10 resumes
  from its own checkpoint with the uninterrupted run's digests and losses.
"""

import json
import os
import signal
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from tpu_tfrecord.models import lm as jlm  # noqa: E402
from tpu_tfrecord.tpu import create_mesh  # noqa: E402
from tpu_tfrecord_torch import interop, train_lm as tw  # noqa: E402
from tpu_tfrecord_torch.checkpoint import tree_flatten  # noqa: E402
from tpu_tfrecord_torch.metrics import METRICS  # noqa: E402
from tpu_tfrecord_torch.models import lm as tlm, pipeline  # noqa: E402
from tpu_tfrecord_torch.options import OptionNotPortedError  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "examples"))
import train_lm as jx  # noqa: E402

KW = dict(vocab_size=64, d_model=16, n_heads=2, n_layers=4, max_len=16)
B = 16
PIPE = dict(mesh={"pipe": 2}, pipe_axis="pipe")


def configs(s=2, v=1, m=None, **kw):
    return jlm.LMConfig(**KW, **kw), tlm.LMConfig(**KW, n_micro=m, n_virtual=v, **kw)


@pytest.fixture(scope="module")
def weights():
    jcfg, tcfg = configs()
    jp = jlm.init_params(jax.random.key(3), jcfg)
    tokens = tlm.make_synthetic_tokens(tcfg, B, seed=5)
    return jp, tokens


def port_loss_and_grads(jp, tokens, tcfg, diagnostics=False, **axes):
    params = interop.lm_params_from_jax(jp, tcfg, device="cpu")
    leaves = tree_flatten(params)[0]
    for leaf in leaves:
        leaf.requires_grad_(True)
    out = tlm.loss_fn(params, torch.from_numpy(tokens), tcfg, diagnostics=diagnostics, **axes)
    loss = out[0] if diagnostics else out
    loss.backward()
    grads = [leaf.grad.numpy() for leaf in leaves]
    loss = float(loss.detach())
    return (loss, grads, out[1]) if diagnostics else (loss, grads)


@pytest.mark.parametrize("s,v,m", [(1, 1, 2), (2, 1, 8), (2, 2, 4), (4, 1, 8)])
def test_pipelined_loss_and_grads_equal_jax_dense(weights, s, v, m):
    jp, tokens = weights
    jcfg, tcfg = configs(s, v, m)
    want_loss, want_grads = jax.value_and_grad(jlm.loss_fn)(jp, tokens, jcfg)
    want_grads = [np.asarray(g) for g in jax.tree.leaves(want_grads)]
    loss, grads, diag = port_loss_and_grads(jp, tokens, tcfg, diagnostics=True,
                                            mesh={"pipe": s, "data": 1}, data_axis="data",
                                            pipe_axis="pipe")
    np.testing.assert_allclose(loss, float(want_loss), rtol=1e-5, atol=1e-5)
    assert len(grads) == len(want_grads)
    for got, want in zip(grads, want_grads):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    # the same step without the schedule: the port's sequential model
    seq_loss, seq_grads = port_loss_and_grads(jp, tokens, tcfg)
    np.testing.assert_allclose(loss, seq_loss, rtol=1e-5, atol=1e-5)
    for got, want in zip(grads, seq_grads):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert diag["bubble_fraction"] == (s - 1) / (v * m + s - 1)


def test_train_step_through_the_schedule_equals_the_dense_step(weights):
    """Four Adam steps: the pipelined losses are the dense ones. (The
    parameters are not compared after Adam: it turns the rounding noise
    of a near-zero gradient into a step of up to lr.)"""
    jp, tokens = weights
    _, tcfg = configs(2, 2, 4)
    losses = {}
    for name, axes in (("pipe", PIPE), ("dense", {})):
        params = interop.lm_params_from_jax(jp, tcfg, device="cpu")
        opt = tlm_opt(params)
        losses[name] = [float(tlm.train_step(params, opt, torch.from_numpy(tokens), tcfg, **axes))
                        for _ in range(4)]
    np.testing.assert_allclose(losses["pipe"], losses["dense"], rtol=1e-5, atol=1e-5)
    assert losses["pipe"][-1] < losses["pipe"][0]


def tlm_opt(params):
    from tpu_tfrecord_torch.models import optim

    return optim.adam(params, 3e-3)


def make_stages(n_stages, n_virtual=1, width=8, seed=0):
    g = torch.Generator().manual_seed(seed)
    shape = (n_stages, n_virtual) if n_virtual > 1 else (n_stages,)
    params = {"w": torch.randn(*shape, width, width, generator=g) * 0.3,
              "b": torch.randn(*shape, width, generator=g) * 0.1}

    def stage_fn(p, x):
        return torch.tanh(x @ p["w"] + p["b"])

    return params, stage_fn


@pytest.mark.parametrize("s,v,m", [(2, 1, 4), (3, 1, 5), (2, 2, 6), (4, 2, 11)])
def test_grads_through_pipeline_apply_equal_pipeline_reference(s, v, m):
    params, stage_fn = make_stages(s, v)
    xs = torch.randn(m, 3, 8, generator=torch.Generator().manual_seed(1))
    grads = {}
    for name, fn in (("apply", pipeline.pipeline_apply),
                     ("reference", pipeline.pipeline_reference)):
        p = {k: t.clone().requires_grad_(True) for k, t in params.items()}
        x = xs.clone().requires_grad_(True)
        out = fn(stage_fn, p, x, n_virtual=v)
        (out * torch.linspace(-1, 1, out.numel()).reshape(out.shape)).sum().backward()
        grads[name] = (out.detach(), p["w"].grad, p["b"].grad, x.grad)
    for got, want in zip(grads["apply"], grads["reference"]):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def interleaved_bubble(n_stages, n_virtual, m):
    """``tests/test_pipeline_parallel.py``'s analytic bubble over the real
    stream (ragged M included)."""
    r_last, i_last = (m - 1) // n_stages, (m - 1) % n_stages
    u_last = r_last * n_virtual * n_stages + (n_virtual - 1) * n_stages + i_last
    return 1.0 - m * n_virtual / (u_last + n_stages)


@pytest.mark.parametrize("s,v,m", [(2, 1, 8), (2, 2, 8), (4, 1, 8), (4, 2, 8), (4, 4, 8),
                                   (4, 2, 11), (3, 1, 7), (1, 1, 4)])
def test_bubble_fraction_is_the_analytic_value(s, v, m):
    params, stage_fn = make_stages(s, v)
    xs = torch.zeros(m, 2, 8)
    out, diag = pipeline.pipeline_apply(stage_fn, params, xs, n_virtual=v, diagnostics=True)
    torch.testing.assert_close(out, pipeline.pipeline_reference(stage_fn, params, xs, n_virtual=v))
    assert diag["useful_ticks"] == m * v
    assert diag["bubble_fraction"] == pytest.approx(interleaved_bubble(s, v, m), abs=1e-12)
    if m % s == 0:
        assert diag["bubble_fraction"] == (s - 1) / (v * m + s - 1)
    assert ("virtual_stages" in diag) == (v > 1)
    assert all(isinstance(x, float) for x in diag.values())  # host numbers, no sync
    assert pipeline.pipeline_apply(stage_fn, params, xs, n_virtual=v).shape == out.shape


def test_lm_bubble_of_the_jax_interleaved_test():
    """``tests/test_lm.py``'s interleaved case: S=2, V=2, M=4 gives 1/9."""
    _, tcfg = configs(2, 2, 4)
    tp = tlm.init_params(tcfg, device="cpu")
    toks = torch.from_numpy(tlm.make_synthetic_tokens(tcfg, 8))
    _, _, diag = tlm.forward(tp, toks, tcfg, diagnostics=True, **PIPE)
    assert diag["bubble_fraction"] == 1 / 9 and diag["virtual_stages"] == 2.0


def jax_and_port_raise(exc, jcfg, tcfg, tokens, jax_mesh=None, **kw):
    """Both packages refuse with the same exception type."""
    with pytest.raises(exc) as jerr:
        jlm.forward(jlm.init_params(jax.random.key(0), jcfg), tokens, jcfg,
                    mesh=jax_mesh, **kw)
    tkw = dict(kw, mesh={"pipe": 2})
    with pytest.raises(exc) as terr:
        tlm.forward(tlm.init_params(tcfg, device="cpu"), torch.from_numpy(tokens), tcfg, **tkw)
    return str(jerr.value), str(terr.value)


def test_refusals_have_the_jax_types():
    jcfg, tcfg = configs()
    toks = tlm.make_synthetic_tokens(tcfg, 8)
    # pipe with seq, pipe with MoE, pipe with segments: ValueError in both
    j, t = jax_and_port_raise(ValueError, jcfg, tcfg, toks, pipe_axis="pipe", seq_axis="seq")
    assert j == t
    jm, tm = configs(moe_experts=4)
    j, t = jax_and_port_raise(ValueError, jm, tm, toks, pipe_axis="pipe")
    assert j == t
    with pytest.raises(ValueError, match="segments are not supported"):
        tlm.forward(tlm.init_params(tcfg, device="cpu"), torch.from_numpy(toks), tcfg,
                    segments=torch.ones(8, 17, dtype=torch.int32), **PIPE)
    mesh = create_mesh({"pipe": 2}, jax.devices()[:2])
    # a batch n_micro does not divide; a layer count S·V does not divide
    j6, t6 = configs(2, 1, 3)
    jcfg6 = jlm.LMConfig(**KW, n_micro=3)
    j, t = jax_and_port_raise(ValueError, jcfg6, t6, toks, jax_mesh=mesh, pipe_axis="pipe")
    assert j == t == "batch 8 not divisible by n_micro 3"
    jv = jlm.LMConfig(**dict(KW, n_layers=2), n_virtual=2)
    tv = tlm.LMConfig(**dict(KW, n_layers=2), n_virtual=2)
    mesh4 = create_mesh({"pipe": 4}, jax.devices()[:4])
    with pytest.raises(ValueError, match="n_virtual") as jerr:
        jlm.forward(jlm.init_params(jax.random.key(0), jv), toks, jv, mesh=mesh4,
                    pipe_axis="pipe")
    with pytest.raises(ValueError, match="n_virtual") as terr:
        tlm.forward(tlm.init_params(tv, device="cpu"), torch.from_numpy(toks), tv,
                    mesh={"pipe": 4}, pipe_axis="pipe")
    assert str(jerr.value) == str(terr.value)
    del j6


@pytest.mark.parametrize("axes,name", [
    (dict(mesh={"pipe": 2, "data": 2}, data_axis="data", pipe_axis="pipe"), "data_axis"),
    (dict(mesh={"pipe": 2, "fsdp": 2}, pipe_axis="pipe"), "mesh"),
    (dict(mesh={"pipe": 2}, pipe_axis="pipe", fsdp_axis="fsdp"), "fsdp_axis"),
    (dict(mesh={"pipe": 2}, pipe_axis="pipe", expert_axis="expert"), "expert_axis"),
    (dict(mesh={"data": 2}, pipe_axis="pipe"), "pipe_axis"),
    (dict(mesh={"data": 2}, data_axis="data"), "data_axis"),
    (dict(mesh=object(), pipe_axis="pipe"), "pipe_axis"),
])
def test_other_mesh_modes_still_refused(axes, name):
    _, tcfg = configs()
    tp = tlm.init_params(tcfg, device="cpu")
    toks = torch.from_numpy(tlm.make_synthetic_tokens(tcfg, 8))
    with pytest.raises(OptionNotPortedError, match=name):
        tlm.loss_fn(tp, toks, tcfg, **axes)


def test_a_mesh_of_sizes_one_runs_the_dense_loop():
    """A mapping mesh whose data axis has size 1 shards nothing: the loss
    is the plain one (a data or seq axis wider than 1 needs a torch
    DeviceMesh of ranks, and is refused on a mapping)."""
    _, tcfg = configs()
    tp = tlm.init_params(tcfg, device="cpu")
    toks = torch.from_numpy(tlm.make_synthetic_tokens(tcfg, 8))
    got = tlm.loss_fn(tp, toks, tcfg, mesh={"data": 1, "seq": 1}, data_axis="data",
                      seq_axis="seq")
    assert torch.equal(got, tlm.loss_fn(tp, toks, tcfg))
    with pytest.raises(OptionNotPortedError, match="seq_axis"):
        tlm.loss_fn(tp, toks, tcfg, mesh={"seq": 2}, seq_axis="seq")


def test_config_fields_take_the_jax_defaults():
    for field in ("zigzag", "n_micro", "n_virtual"):
        assert getattr(tlm.LMConfig(), field) == getattr(jlm.LMConfig(), field)


@pytest.mark.parametrize("virtual", [1, 2])
def test_pick_mesh_dp_pp_is_the_jax_two_device_result(virtual, monkeypatch):
    two = jax.devices()[:2]
    monkeypatch.setattr(jax, "devices", lambda *a, **k: two)
    jmesh, jaxes, jlayers = jx.pick_mesh("dp_pp", virtual)
    shape, axes, layers = tw.pick_mesh("dp_pp", virtual)
    assert shape == dict(jmesh.shape) == {"pipe": 2, "data": 1}
    assert axes == jaxes and layers == jlayers == 4
    cfg = tw.make_config(layers, 0, axes, virtual)
    assert (cfg.n_micro, cfg.n_virtual, cfg.n_layers) == (8, virtual, 4)


@pytest.fixture(scope="module")
def lm_data(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("lm") / "data")
    tw.generate(d, shards=2, docs=64)
    return d


def test_dp_pp_trains_four_layers_in_two_stages_with_the_bubble_gauge(lm_data, tmp_path,
                                                                      capsys):
    METRICS.reset()
    tw.main(["--device", "cpu", "--mesh", "dp_pp", "--virtual", "2", "--steps", "2",
             "--save-every", "8", "--epochs", "1", "--data-dir", lm_data, "--diagnostics",
             "--ckpt-dir", str(tmp_path / "ck")])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == ("mesh: {'pipe': 2, 'data': 1} mode=dp_pp (one device: 4 layers in "
                      "2 stages, n_micro 8, virtual 2)")
    diag = json.loads(next(ln for ln in out if ln.startswith("model diagnostics:"))
                      .split(":", 1)[1])
    assert diag == {"pipeline.bubble_fraction": 1 / 17, "pipeline.bubble_fraction_v": 1 / 17}
    assert any(ln.startswith("done: 2 steps") for ln in out)


def run_twin(args, kill_after=None):
    """The LM twin in a subprocess on the CPU (one thread: the losses are
    then bit-equal run to run); with ``kill_after`` SIGKILLed once that
    step's ``lm_step`` line is out."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.Popen([sys.executable, "-m", "tpu_tfrecord_torch.train_lm",
                             "--device", "cpu", *args], cwd=REPO, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    lines = []
    try:
        for line in proc.stdout:
            lines.append(line.rstrip())
            if kill_after is not None and line.startswith("lm_step ") and \
                    json.loads(line.split(" ", 1)[1])["step"] == kill_after:
                proc.send_signal(signal.SIGKILL)
                break
        proc.wait(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        err = proc.stderr.read()
        proc.stdout.close()
        proc.stderr.close()
    return proc.returncode, lines, err


def steps_of(lines):
    return {json.loads(ln.split(" ", 1)[1])["step"]: json.loads(ln.split(" ", 1)[1])
            for ln in lines if ln.startswith("lm_step ")}


def test_dp_pp_kill_and_resume_gives_the_uninterrupted_losses(lm_data, tmp_path, capsys):
    common = ["--data-dir", lm_data, "--steps", "12", "--save-every", "4", "--mesh", "dp_pp",
              "--virtual", "2"]
    tw.main(["--device", "cpu", *common, "--ckpt-dir", str(tmp_path / "ref"),
             "--digest-out", str(tmp_path / "ref.jsonl")])
    ref = capsys.readouterr().out.splitlines()
    assert ref[0].startswith("mesh: {'pipe': 2, 'data': 1}") and ref[1] == "fresh start"
    ckpt = ["--ckpt-dir", str(tmp_path / "ck"), "--digest-out", str(tmp_path / "run.jsonl")]
    rc, first, err = run_twin(common + ckpt, kill_after=10)
    assert rc == -signal.SIGKILL, (rc, err)
    rc, second, err = run_twin(common + ckpt)
    assert rc == 0, err
    assert second[1] == "resumed at step 8", second[:3]
    want, got = steps_of(ref), steps_of(second)
    assert sorted(got) == list(range(9, 13))
    for s in range(9, 13):
        assert got[s] == want[s]  # digest and loss, bit for bit
    assert steps_of(first)[10] == want[10]


# ---------------------------------------------------------------------------
# The mesh names the port lacked, and the gaps a signature comparison found
# ---------------------------------------------------------------------------


def _mesh_names():
    from tpu_tfrecord_torch.device import ingest
    from tpu_tfrecord_torch.models import dlrm, long_doc, moe

    return {
        "moe.param_shardings": moe.param_shardings,
        "dlrm.param_shardings": dlrm.param_shardings,
        "dlrm.batch_shardings": dlrm.batch_shardings,
        "long_doc.param_shardings": long_doc.param_shardings,
        "long_doc.batch_shardings": long_doc.batch_shardings,
        "lm.SpecLayout": tlm.SpecLayout,
        "lm.param_specs": tlm.param_specs,
        "lm.param_shardings": tlm.param_shardings,
        "lm.batch_shardings": tlm.batch_shardings,
        "ingest.batch_spec": ingest.batch_spec,
    }


# ported since: called with no arguments they ask for them instead of refusing
# (``lm.SpecLayout`` constructs with none, as JAX's does)
PORTED_MESH_NAMES = ("dlrm.param_shardings", "dlrm.batch_shardings", "ingest.batch_spec",
                     "long_doc.param_shardings", "long_doc.batch_shardings", "lm.SpecLayout",
                     "lm.param_specs", "lm.param_shardings", "lm.batch_shardings")


@pytest.mark.parametrize("name", sorted(_mesh_names()))
def test_mesh_names_exist_and_refuse_naming_item_8(name):
    """Each JAX mesh-placement name exists in the port. Those not ported
    raise ``OptionNotPortedError`` naming ROADMAP item 8 (an
    ``AttributeError`` on the parent); the ported ones (``PORTED_MESH_NAMES``)
    no longer refuse. The JAX config fields that select mesh modes exist
    with the JAX defaults, so a JAX config constructs."""
    if name == "lm.SpecLayout":
        assert tlm.SpecLayout() == tlm.SpecLayout(None, None, None)
        assert jlm.SpecLayout() == jlm.SpecLayout(None, None, None)
    elif name in PORTED_MESH_NAMES:
        with pytest.raises(TypeError, match="required positional argument"):
            _mesh_names()[name]()
    else:
        with pytest.raises(OptionNotPortedError, match=r"item 8") as err:
            _mesh_names()[name]()
        assert name in str(err.value)
    from tpu_tfrecord.models import long_doc as jld
    from tpu_tfrecord_torch.models import long_doc as tld

    assert tld.LongDocConfig().sp_attention == jld.LongDocConfig().sp_attention == "ring"
    assert tlm.LMConfig().zigzag is jlm.LMConfig().zigzag is True
    assert tlm.LMConfig().n_micro is jlm.LMConfig().n_micro is None
    with pytest.raises(ValueError, match="sp_attention"):
        tld.init_params(tld.LongDocConfig(sp_attention="zigzag"), device="cpu")


def test_options_with_schema_and_lm_checkpoint_latest_step(tmp_path):
    """``TFRecordOptions.with_schema`` and ``LMCheckpoint.latest_step``, which
    the JAX package has and the port lacked."""
    from tpu_tfrecord.options import TFRecordOptions as JOptions
    from tpu_tfrecord.schema import StructType as JStruct
    from tpu_tfrecord_torch.options import TFRecordOptions
    from tpu_tfrecord_torch.schema import LongType, StructField, StructType

    schema = StructType([StructField("x", LongType())])
    t = TFRecordOptions.from_map(codec="gzip").with_schema(schema)
    j = JOptions.from_map(codec="gzip").with_schema(JStruct.from_json(schema.to_json()))
    assert t.schema == schema and t.codec == j.codec == "gzip"
    assert t.schema.to_json() == j.schema.to_json()
    ck = tw.LMCheckpoint(str(tmp_path), sync=True)
    try:
        assert ck.latest_step() is None
        params = tlm.init_params(tw.make_config(), device="cpu")
        from tpu_tfrecord_torch.models import optim

        ck.save(3, optim.train_state(params, optim.adam(params, 1e-3)), {"input": {}})
        ck.wait()
        assert ck.latest_step() == 3
    finally:
        ck.close()
