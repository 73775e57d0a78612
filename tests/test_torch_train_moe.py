"""The port's trainers with the MoE FFN on the CPU.

- ``python -m tpu_tfrecord_torch.train_lm --moe 4 --diagnostics
  --trace-out FILE``: an uninterrupted 12-step run in this process, then a
  run killed with SIGKILL after step 10 and run again: it resumes at step
  8 with the uninterrupted run's digests and losses (bit-equal, one torch
  thread), prints finite ``moe.*`` gauges and saves the trace. Its packed
  batches are the dense twin's (the same digests).
- ``LONGDOC_MOE_EXPERTS=4 python -m tpu_tfrecord_torch.train_longdoc``:
  finite losses, the phase shares and the done line.
- ``harness.fold_model_diagnostics`` folds a diagnostics dict into the
  gauges the JAX harness's ``fold_model_diagnostics`` gives for it.
"""

import json
import math
import os
import signal
import sys

import numpy as np
import pytest
import torch

from test_torch_train_seq import run_twin, steps_of
from tpu_tfrecord_torch import harness, telemetry, train_lm as tw_lm, train_longdoc as tw_ld
from tpu_tfrecord_torch.metrics import Metrics

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "examples"))
import _harness as jx_harness  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def lm_data(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("lm") / "data")
    tw_lm.generate(d)
    return d


def diag_line(lines):
    got = [ln for ln in lines if ln.startswith("model diagnostics: ")]
    assert len(got) == 1, lines[-6:]
    return json.loads(got[0].split(": ", 1)[1])


def test_moe_twin_kill_and_resume(lm_data, tmp_path, capsys, monkeypatch):
    monkeypatch.setenv("LM_MESH", "dp")
    common = ["--data-dir", lm_data, "--steps", "12", "--save-every", "4", "--moe", "4",
              "--diagnostics"]
    trace = tmp_path / "ref_trace.json"
    try:
        tw_lm.main(["--device", "cpu", *common, "--ckpt-dir", str(tmp_path / "ref"),
                    "--digest-out", str(tmp_path / "ref.jsonl"), "--trace-out", str(trace)])
    finally:
        telemetry.disable()
        telemetry.RECORDER.clear()
    ref = capsys.readouterr().out.splitlines()
    assert ref[0] == "fresh start" and any(ln.startswith("done: 12 steps") for ln in ref)
    assert f"trace saved: {trace}" in ref
    gauges = diag_line(ref)
    assert sorted(gauges) == ["moe.dropped_fraction", "moe.expert_imbalance", "moe.gate_entropy"]
    assert all(math.isfinite(v) for v in gauges.values())
    assert gauges["moe.expert_imbalance"] >= 1.0 and 0 <= gauges["moe.dropped_fraction"] < 1
    assert 0 < gauges["moe.gate_entropy"] <= math.log(4) + 1e-6
    spans = [e for e in json.loads(trace.read_text())["traceEvents"] if e.get("name") == "train.step"]
    assert len(spans) == 12

    ckpt = ["--ckpt-dir", str(tmp_path / "ck"), "--digest-out", str(tmp_path / "run.jsonl"),
            "--trace-out", str(tmp_path / "run_trace.json")]
    rc, first, err = run_twin(common + ckpt, kill_after=10)
    assert rc == -signal.SIGKILL, (rc, err)
    rc, second, err = run_twin(common + ckpt)
    assert rc == 0, err
    assert second[0] == "resumed at step 8", second[:3]
    want, got = steps_of(ref), steps_of(second)
    assert sorted(got) == list(range(9, 13))
    for s in range(9, 13):
        assert got[s] == want[s]  # digest and loss, bit for bit
    assert steps_of(first)[10] == want[10]
    assert all(math.isfinite(v) for v in diag_line(second).values())
    assert os.path.exists(tmp_path / "run_trace.json")

    # the same packed stream as the dense twin's: the digests agree
    tw_lm.main(["--device", "cpu", "--data-dir", lm_data, "--steps", "3", "--ckpt-dir",
                str(tmp_path / "dense"), "--digest-out", str(tmp_path / "dense.jsonl")])
    dense = steps_of(capsys.readouterr().out.splitlines())
    assert [dense[s]["digest"] for s in (1, 2, 3)] == [want[s]["digest"] for s in (1, 2, 3)]
    assert all(dense[s]["loss"] != want[s]["loss"] for s in (1, 2, 3))


def test_moe_longdoc_twin(tmp_path, capsys, monkeypatch):
    monkeypatch.setenv("LONGDOC_MOE_EXPERTS", "4")
    data = str(tmp_path / "data")
    tw_ld.generate(data, shards=2, rows=256)
    tw_ld.main(["--device", "cpu", "--data-dir", data, "--ckpt-dir", str(tmp_path / "ck")])
    out = capsys.readouterr().out.splitlines()
    losses = [float(ln.split("~")[1]) for ln in out if ln.startswith("step ")]
    assert out[0] == "fresh start"
    assert losses and np.isfinite(losses).all()
    assert any(ln.startswith("done: 16 steps") for ln in out), out[-5:]
    assert any(ln.startswith("train phases: ") and "verdict: " in ln for ln in out)


@pytest.mark.parametrize("diag", [
    {"expert_tokens": [30.0, 10.0, 20.0, 20.0], "expert_kept": [25.0, 10.0, 20.0, 20.0],
     "dropped_fraction": 0.0625, "gate_entropy": 1.2},
    {"expert_tokens": [0.0, 0.0], "expert_kept": [0.0, 0.0], "dropped_fraction": 0.0,
     "gate_entropy": 0.0},
    {"bubble_fraction": 0.25, "useful_ticks": 6.0, "total_ticks": 8.0},
    {"bubble_fraction": 0.1, "virtual_stages": 2.0},
    {},
], ids=["moe", "moe_empty", "pipeline", "pipeline_v2", "dense"])
def test_fold_model_diagnostics_matches_jax(diag):
    tm, jm = Metrics(), jx_harness.METRICS.__class__()
    got = harness.fold_model_diagnostics({k: torch.tensor(v) for k, v in diag.items()}, tm)
    want = jx_harness.fold_model_diagnostics({k: np.asarray(v, np.float32)
                                              for k, v in diag.items()}, jm)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-6)
        assert tm.gauge_value(k) == pytest.approx(jm.gauge_value(k), rel=1e-6)
        assert tm.quantiles(k)[k]["count"] == 1
