"""The port's trainer harness (``tpu_tfrecord_torch.harness``) and its
telemetry against the JAX harness (``examples/_harness.py``) on the CPU.

- The verdict functions and ``OccupancyEma`` give the JAX values on the
  same inputs; ``StepPhases`` gives the JAX shares, gauges, stage seconds
  and verdicts on the same scripted durations (``time.perf_counter``
  replaced by a script); ``test_train_telemetry.py``'s StepPhases cases.
- ``run_train_loop`` on a small DLRM: the port's harness (port dataset,
  port model) and the JAX harness (JAX dataset, jitted JAX step) consume
  the same host batches step by step, with losses within
  ``test_torch_train.py``'s f32 tolerance (rtol 1e-5, atol 1e-6).
- A run stopped at step 5 (saved at 3) and resumed through
  ``resume_or_fresh`` and ``TrainCheckpointer.restore`` into a model of
  other weights gives the uninterrupted run's losses and parameters bit
  for bit, for the sparse and the dense step.
- ``python -m tpu_tfrecord_torch.train_dlrm --device cpu`` runs steps end
  to end and resumes.
- ``trainer_spool`` spools under the ``trainer`` role from
  ``TFR_TRAIN_SPOOL_DIR`` and its release lands the ``final`` snapshot.
"""

import functools
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

torch.set_num_threads(1)

from tpu_tfrecord import io as jio, schema as jschema, telemetry as jtel  # noqa: E402
from tpu_tfrecord.io.dataset import TFRecordDataset as JDataset  # noqa: E402
from tpu_tfrecord.metrics import Metrics as JMetrics  # noqa: E402
from tpu_tfrecord.models import dlrm as jdlrm  # noqa: E402
from tpu_tfrecord.tpu.ingest import host_batch_from_columnar as j_hbfc  # noqa: E402

from tpu_tfrecord_torch import checkpoint, harness, interop, telemetry  # noqa: E402
from tpu_tfrecord_torch import schema as tschema  # noqa: E402
from tpu_tfrecord_torch.device.ingest import (  # noqa: E402
    host_batch_from_columnar as t_hbfc,
    make_device_batch,
)
from tpu_tfrecord_torch.io.dataset import TFRecordDataset as TDataset  # noqa: E402
from tpu_tfrecord_torch.metrics import METRICS, Metrics  # noqa: E402
from tpu_tfrecord_torch.models import dlrm as tdlrm  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "examples"))
import _harness as jharness  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-6)  # test_torch_train.py's f32 tolerance


@pytest.fixture(autouse=True)
def _clean_registry():
    METRICS.reset()
    yield
    METRICS.reset()
    telemetry.disable()


# -- verdicts ------------------------------------------------------------------------


def test_verdict_functions_equal_jax():
    grid = np.linspace(0, 1, 11)
    for occ in [None, *grid, 0.33, 0.66]:
        assert telemetry.boundness_verdict(occ) == jtel.boundness_verdict(occ)
    for dw in grid:
        for h2d in grid[:6]:
            for ck in (0.0, 0.1, 0.24, 0.25, 0.4):
                shares = {"data_wait": dw, "h2d": h2d, "ckpt": ck, "compute": 1.0 - dw}
                assert telemetry.training_verdict(shares) == jtel.training_verdict(shares)
    assert telemetry.training_verdict(None) == jtel.training_verdict(None) == "unknown"
    assert (telemetry.TRAIN_PHASES, telemetry.TRAIN_STAGE_PREFIX, telemetry.TRAIN_SHARE_PREFIX,
            telemetry.TRAIN_CKPT_BOUND_SHARE, telemetry.TRAIN_INPUT_BOUND_SHARE,
            telemetry.OCCUPANCY_GAUGE) == (
        jtel.TRAIN_PHASES, jtel.TRAIN_STAGE_PREFIX, jtel.TRAIN_SHARE_PREFIX,
        jtel.TRAIN_CKPT_BOUND_SHARE, jtel.TRAIN_INPUT_BOUND_SHARE, jtel.OCCUPANCY_GAUGE)


def test_occupancy_ema_equals_jax():
    tm, jm = Metrics(), JMetrics()
    t, j = telemetry.OccupancyEma("q"), jtel.OccupancyEma("q")
    for fill in np.random.default_rng(3).random(40):
        assert t.update(float(fill), tm) == j.update(float(fill), jm)
    assert tm.gauge_value("q") == jm.gauge_value("q")
    assert telemetry.verdict_from_metrics(tm, "q") == jtel.verdict_from_metrics(jm, "q")


# -- StepPhases ---------------------------------------------------------------------


class _FakeDeviceIt:
    def __init__(self):
        self.transfer_seconds = 0.0


# (phase, seconds, transfer seconds inside it) of each scripted step
SCRIPT = [
    [("data_wait", 0.004, 0.001), ("h2d", 0.002, 0), ("compute", 0.010, 0)],
    [("data_wait", 0.020, 0.003), ("h2d", 0.002, 0), ("compute", 0.005, 0), ("ckpt", 0.2, 0)],
    [("data_wait", 0.001, 0.05), ("compute", 0.012, 0)],
    [("data_wait", 0.030, 0), ("h2d", 0.001, 0), ("compute", 0.004, 0)],
    [("data_wait", 0.002, 0), ("compute", 0.011, 0), ("ckpt", 0.001, 0)],
    [("data_wait", 0.050, 0.0)],  # the end-of-data probe: aborted
]


def _drive(rec, clock):
    it = _FakeDeviceIt()
    for k, phases in enumerate(SCRIPT):
        for name, dt, xfer in phases:
            with rec.phase(name, iterator=it if name == "data_wait" else None):
                clock[0] += dt
                it.transfer_seconds += xfer
        if k == len(SCRIPT) - 1:
            rec.abort_step()
        else:
            rec.end_step()
    rec.flush()


@pytest.mark.parametrize("window", [1, 2, 3, 16])
def test_step_phases_equal_jax_on_scripted_durations(monkeypatch, window):
    clock = [100.0]
    monkeypatch.setattr(time, "perf_counter", lambda: clock[0])
    results = []
    for mod, metrics in ((harness, Metrics()), (jharness, JMetrics())):
        rec = mod.StepPhases(window=window, metrics=metrics)
        _drive(rec, clock)
        snap = metrics.snapshot("train")
        results.append((
            rec.steps, rec.shares(), rec.verdict(),
            {k: v for k, v in snap.items() if "gauge" in v},
            {k: (v["records"], v["seconds"]) for k, v in snap.items() if "gauge" not in v},
            metrics.counter("train.steps"),
        ))
    assert results[0] == results[1]
    assert results[0][0] == len(SCRIPT) - 1


def test_phases_land_as_train_stages_with_histograms():
    m = Metrics()
    rec = harness.StepPhases(window=2, metrics=m)
    for _ in range(2):
        with rec.phase("data_wait"):
            pass
        with rec.phase("compute"):
            time.sleep(0.01)
        rec.end_step()
    snap = m.snapshot()
    assert snap["train.compute"]["records"] == 2
    assert snap["train.compute"]["seconds"] >= 0.02
    assert snap["train.compute"]["hist_count"] == 2
    assert m.counter("train.steps") == 2
    assert snap["train.step"]["hist_count"] == 2
    assert m.gauge_value("train.share.compute") > 0.9
    assert m.gauge_value("train.share.data_wait") is not None
    assert rec.verdict() == "compute_bound"


def test_inline_transfer_reattributed_from_wait_to_h2d():
    m = Metrics()
    rec = harness.StepPhases(metrics=m)
    it = _FakeDeviceIt()
    with rec.phase("data_wait", iterator=it):
        it.transfer_seconds += 0.05
        time.sleep(0.06)
    rec.end_step()
    assert m.stage("train.h2d").seconds == pytest.approx(0.05)
    assert 0.005 <= m.stage("train.data_wait").seconds < 0.06


def test_transfer_delta_capped_at_observed_wall():
    m = Metrics()
    rec = harness.StepPhases(metrics=m)
    it = _FakeDeviceIt()
    with rec.phase("data_wait", iterator=it):
        it.transfer_seconds += 10.0
        time.sleep(0.01)
    rec.end_step()
    assert m.stage("train.data_wait").seconds == 0.0
    assert m.stage("train.h2d").seconds < 1.0


def test_aborted_discovery_iteration_records_nothing():
    m = Metrics()
    rec = harness.StepPhases(window=1, metrics=m)
    with rec.phase("compute"):
        time.sleep(0.005)
    rec.end_step()
    with rec.phase("data_wait"):
        time.sleep(0.05)
    rec.abort_step()
    rec.flush()
    assert rec.steps == 1 and m.counter("train.steps") == 1
    assert m.stage("train.data_wait").records == 0
    assert rec.verdict() == "compute_bound"
    assert m.gauge_value("train.share.data_wait") == 0.0


def test_exhausted_loop_spans_match_step_count():
    telemetry.RECORDER.clear()
    telemetry.enable()
    try:
        rec = harness.StepPhases(metrics=Metrics())
        state, steps, _ = harness.run_train_loop(
            iter([1, 2, 3]), produce=lambda cb: cb, step_fn=lambda s, gb: (s, None),
            state=(), phases=rec, log_every=1000)
        assert steps == 3 and rec.steps == 3
        spans = [s for s in telemetry.RECORDER.spans() if s[0] == "train.step" and s[5] == "X"]
        assert len(spans) == 3
    finally:
        telemetry.disable()
        telemetry.RECORDER.clear()


def test_flush_publishes_partial_window():
    m = Metrics()
    rec = harness.StepPhases(window=100, metrics=m)
    with rec.phase("compute"):
        time.sleep(0.002)
    rec.end_step()
    assert m.gauge_value("train.share.compute") is None
    rec.flush()
    assert m.gauge_value("train.share.compute") == pytest.approx(1.0, abs=0.01)


def test_input_bound_verdict_from_wait_heavy_steps():
    rec = harness.StepPhases(window=2, metrics=Metrics())
    for _ in range(2):
        with rec.phase("data_wait"):
            time.sleep(0.02)
        with rec.phase("compute"):
            time.sleep(0.002)
        rec.end_step()
    assert rec.verdict() == "input_bound"


def test_window_validation():
    with pytest.raises(ValueError):
        harness.StepPhases(window=0)


def test_chrome_trace_export(tmp_path):
    telemetry.RECORDER.clear()
    telemetry.enable()
    try:
        with telemetry.span("decode", shard="a"):
            pass
        telemetry.instant("stall")
        p = str(tmp_path / "t.json")
        telemetry.RECORDER.save_chrome_trace(p)
    finally:
        telemetry.disable()
        telemetry.RECORDER.clear()
    import json

    events = json.load(open(p))["traceEvents"]
    assert [e["ph"] for e in events if e["ph"] != "M"] == ["X", "i"]
    assert events[0]["name"] == "process_name"


def test_trainer_spool_not_ported(monkeypatch, tmp_path):
    """The trainer spool, once refused, is the JAX harness's: None without
    a dir; with ``TFR_TRAIN_SPOOL_DIR`` / ``TFR_TRAIN_SPOOL_INTERVAL_S`` a
    spool under the ``trainer`` role whose release lands a ``final: true``
    line, as ``examples/_harness.trainer_spool`` gives."""
    from tpu_tfrecord_torch import fleet

    monkeypatch.delenv("TFR_TRAIN_SPOOL_DIR", raising=False)
    assert harness.trainer_spool() is None
    harness.release_trainer_spool(None)
    spool_dir = str(tmp_path / "spool")
    monkeypatch.setenv("TFR_TRAIN_SPOOL_DIR", spool_dir)
    monkeypatch.setenv("TFR_TRAIN_SPOOL_INTERVAL_S", "30")
    try:
        spool = harness.trainer_spool()
        assert spool.interval_s == 30.0 and spool.context.role == "trainer"
        assert harness.trainer_spool(spool_dir) is spool  # one spool per dir
        harness.release_trainer_spool(spool)
        assert os.listdir(spool_dir) == [] and not spool._stop.is_set()
        harness.release_trainer_spool(spool)
        snap = fleet.read_spool(spool.path)
        assert snap.final and snap.role == "trainer" and snap.interval_s == 30.0
        assert os.listdir(spool_dir) == [os.path.basename(spool.path)]
        assert not fleet._SPOOLS
    finally:
        telemetry.RECORDER.context = None


# -- run_train_loop on a small DLRM -----------------------------------------------------

NUM_DENSE, NUM_CAT, VOCAB = 4, 3, 64
BATCH = 16


def _cfgs():
    kw = dict(num_dense=NUM_DENSE, num_categorical=NUM_CAT, vocab_size=VOCAB, embed_dim=4,
              bottom_mlp=(8, 4), top_mlp=(8, 1), interaction="dot")
    return (jdlrm.DLRMConfig(dtype=jnp.float32, **kw),
            tdlrm.DLRMConfig(dtype=torch.float32, **kw))


def _schema(mod):
    return mod.StructType(
        [mod.StructField("label", mod.LongType(), nullable=False)]
        + [mod.StructField(f"I{i}", mod.LongType()) for i in range(NUM_DENSE)]
        + [mod.StructField(f"C{i}", mod.StringType()) for i in range(NUM_CAT)])


HASH = {f"C{i}": VOCAB for i in range(NUM_CAT)}
PACK = {"dense": [f"I{i}" for i in range(NUM_DENSE)], "cat": [f"C{i}" for i in range(NUM_CAT)]}
READ = dict(batch_size=BATCH, num_epochs=2, shuffle=True, shuffle_window=2, seed=0)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """3 shards of 40 Criteo-like rows through the JAX writer."""
    d = str(tmp_path_factory.mktemp("harness") / "ds")
    rng = np.random.default_rng(0)
    for _ in range(3):
        rows = [[int(rng.integers(0, 2))] + [int(v) for v in rng.integers(0, 1000, NUM_DENSE)]
                + [f"v{int(v)}" for v in rng.integers(0, 50, NUM_CAT)] for _ in range(40)]
        jio.write(rows, _schema(jschema), d, mode="append")
    return d


def _host(hbfc, cb, schema):
    hb = hbfc(cb, schema, hash_buckets=HASH, pack=PACK)
    hb["dense"] = np.log1p(hb["dense"].clip(min=0)).astype(np.float32)
    hb["label"] = hb["label"].astype(np.float32)
    return hb


def _port_run(data, model, opt, cfg, sparse, state=None, **loop):
    """The port's harness over the port's read: (host batches, losses)."""
    ds = TDataset(data, schema=_schema(tschema), **READ)
    seen, losses = [], []

    def produce(cb):
        hb = _host(t_hbfc, cb, ds.schema)
        seen.append(hb)
        return make_device_batch(hb, "cpu")

    def step(st, gb):
        loss = tdlrm.sparse_train_step(model, opt, gb, cfg) if sparse else \
            tdlrm.train_step(model, opt, gb)
        losses.append(float(loss))
        return st, loss

    it = ds.batches(state) if not isinstance(state, str) else harness.resume_or_fresh(ds, state)[0]
    with it:
        _, steps, _ = harness.run_train_loop(it, produce, step, (), log_every=1000, **loop)
    return seen, losses, steps


@pytest.mark.parametrize("sparse", [True, False], ids=["sparse", "dense"])
def test_run_train_loop_matches_jax_harness(data, sparse):
    jcfg, tcfg = _cfgs()
    params = jax.tree.map(np.asarray, jdlrm.init_params(jax.random.key(2), jcfg))
    model = interop.dlrm_params_from_jax(params, tcfg, device="cpu")
    tx = optax.adam(1e-2)
    adam = lambda ps: torch.optim.Adam(ps, lr=1e-2)  # noqa: E731
    if sparse:
        jstate = jdlrm.sparse_opt_init(params, jcfg, tx)
        jstep = jax.jit(functools.partial(jdlrm.sparse_train_step, cfg=jcfg, tx=tx))
        opt = tdlrm.sparse_opt_init(model, tcfg, adam)
    else:
        jstate = tx.init(params)
        jstep = jax.jit(functools.partial(jdlrm.train_step, cfg=jcfg, tx=tx))
        opt = adam(list(model.parameters()))

    jds = JDataset(data, schema=_schema(jschema), **READ)
    jseen = []

    def jproduce(cb):
        hb = _host(j_hbfc, cb, jds.schema)
        jseen.append(hb)
        return {k: jnp.asarray(v) for k, v in hb.items()}

    def jstep_fn(st, gb):
        p, s, loss = jstep(st[0], st[1], gb)
        return (p, s), loss

    jlosses = []
    with jds.batches() as it:
        _, jsteps, _ = jharness.run_train_loop(
            it, jproduce, jstep_fn, (params, jstate), log_every=1000,
            on_step=lambda k, loss: jlosses.append(float(loss)))
    seen, losses, steps = _port_run(data, model, opt, tcfg, sparse)
    assert steps == jsteps == len(losses) == len(jlosses) == 2 * 3 * 40 // BATCH
    for a, b in zip(seen, jseen):
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    np.testing.assert_allclose(losses, jlosses, **TOL)


@pytest.mark.parametrize("sparse", [True, False], ids=["sparse", "dense"])
def test_stop_and_resume_is_bit_equal(data, tmp_path, sparse):
    _, cfg = _cfgs()
    adam = lambda ps: torch.optim.Adam(ps, lr=1e-2)  # noqa: E731

    def fresh(seed):
        model = tdlrm.init_params(cfg, torch.Generator().manual_seed(seed), "cpu")
        opt = tdlrm.sparse_opt_init(model, cfg, adam) if sparse else adam(list(model.parameters()))
        return model, opt

    model, opt = fresh(0)
    _, full, total = _port_run(data, model, opt, cfg, sparse)
    final = [t.clone() for t in checkpoint.tree_flatten(tdlrm.train_state(model, opt))[0]]

    ckdir = str(tmp_path / "ck")
    model, opt = fresh(0)
    save_pos, saver = harness.state_saver(ckdir)
    ck = checkpoint.TrainCheckpointer(ckdir, max_to_keep=1)

    def save(step, it, st):
        save_pos(step, it, st)
        ck.save(step, tdlrm.train_state(model, opt), it)

    _, first, stopped = _port_run(data, model, opt, cfg, sparse, save=save, save_every=3,
                                  max_steps=5)
    saver.close()
    ck.close()
    assert stopped == 5 and first == full[:5]

    model, opt = fresh(7)
    ck = checkpoint.TrainCheckpointer(ckdir)
    step, tree, position = ck.restore(tdlrm.train_state(model, opt))
    ck.close()
    tdlrm.load_train_state(model, opt, tree)
    assert step == 3 and position == checkpoint.load_state(ckdir)
    _, rest, steps = _port_run(data, model, opt, cfg, sparse, state=ckdir)
    assert steps == total - 3 and rest == full[3:]
    for a, b in zip(checkpoint.tree_flatten(tdlrm.train_state(model, opt))[0], final):
        assert torch.equal(a, b)


def test_train_dlrm_runs_and_resumes_on_the_cpu(tmp_path):
    cmd = [sys.executable, "-m", "tpu_tfrecord_torch.train_dlrm", "--device", "cpu",
           "--data-dir", str(tmp_path / "data"), "--ckpt-dir", str(tmp_path / "ckpt")]
    env = dict(os.environ, DLRM_SPARSE="1", OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    first = subprocess.run(cmd + ["--max-steps", "9"], cwd=REPO, env=env, capture_output=True,
                           text=True, timeout=300)
    assert first.returncode == 0, first.stderr
    assert "fresh start" in first.stdout and "step 8  loss" in first.stdout
    assert "done: 9 steps" in first.stdout
    second = subprocess.run(cmd + ["--max-steps", "2"], cwd=REPO, env=env, capture_output=True,
                            text=True, timeout=300)
    assert second.returncode == 0, second.stderr
    assert "resuming from IteratorState(epoch=0, shard_cursor=1, record_offset=4096" in second.stdout
    assert "done: 2 steps" in second.stdout
