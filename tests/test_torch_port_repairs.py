"""Three faults of the port against the JAX package, repaired:

- The chaos plan reaches the dataset's mmap route: ``install_chaos``
  patches ``io.dataset._open_local``, so one ``FaultPlan`` gives the same
  exception, the same ledger and the same batches before it through the
  JAX ``TFRecordDataset`` and the port's, at 1 and 4 decode workers.
- The JAX constructor's nine read knobs are the port's keyword arguments:
  taken at their JAX defaults, and any other value raises
  ``OptionNotPortedError`` naming the argument (not the options parser's
  "Unknown option(s)" with a guess at another option).
- ``train_lm``: ``--trace-out`` saves a Chrome trace with ``train.step``
  spans, ``--spool-interval`` raises ``OptionNotPortedError``, and the
  ``--mesh`` default comes from ``LM_MESH`` (else ``dp_sp``), as in the
  JAX example.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from tpu_tfrecord import faults as jfaults
from tpu_tfrecord.io.dataset import TFRecordDataset as JDataset

from tpu_tfrecord_torch import faults as tfaults, telemetry, train_lm as tw_lm
from tpu_tfrecord_torch.io import dataset as tds
from tpu_tfrecord_torch.io.dataset import TFRecordDataset as TDataset
from tpu_tfrecord_torch.options import OptionNotPortedError
from tpu_tfrecord_torch.retry import RetryPolicy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "examples"))
import train_lm as jx_lm  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def docs(tmp_path_factory):
    """4 local uncompressed shards of 16 token documents: the mmap route."""
    d = str(tmp_path_factory.mktemp("docs") / "data")
    tw_lm.generate(d, shards=4, docs=16)
    return d


def read_under_plan(faults, dataset_cls, schema, data, plan_json, workers):
    """(exception type, message, ledger, token batches before it) of one
    epoch read under ``plan_json`` through ``faults.install_chaos``."""
    plan = faults.FaultPlan.from_json(plan_json)
    batches = []
    with faults.install_chaos(plan):
        ds = dataset_cls(data, batch_size=8, schema=schema, recordType="SequenceExample",
                         num_workers=workers)
        try:
            with ds.batches() as it:
                for cb in it:
                    batches.append([np.asarray(v).tolist() for v in cb["tokens"].values])
        except OSError as e:
            return type(e).__name__, str(e), plan.ledger, batches
    return None, None, plan.ledger, batches


@pytest.mark.parametrize("workers", [1, 4])
@pytest.mark.parametrize("path", ["part-", "c002"], ids=["any_shard", "third_shard"])
def test_chaos_plan_reaches_the_mmap_route(docs, path, workers):
    plan = {"seed": 0, "rules": [{"op": "open", "kind": "permanent_error", "path": path}]}
    jx = read_under_plan(jfaults, JDataset, jx_lm.make_schema(), docs, plan, workers)
    pt = read_under_plan(tfaults, TDataset, tw_lm.make_schema(), docs, plan, workers)
    assert jx[0] == pt[0] == "InjectedFault"
    assert len(pt[2]) == 1 and pt[2][0]["op"] == "open" and pt[2][0]["kind"] == "permanent_error"
    assert pt[2][0]["path"] in pt[1]
    if path == "c002" or workers == 1:
        # one shard is the first open (sequential reads) or the only match:
        # the ledgers, the messages and the batches before the fault agree
        assert pt[1] == jx[1]
        assert pt[2] == jx[2]
        assert pt[3] == jx[3]
        if path == "c002":
            assert len(pt[3]) == 4  # the two shards before the third, 16 documents each
    else:
        # four workers open shards concurrently: the fault lands on whichever
        # open comes first, in either package
        assert jx[2][0]["ordinal"] == pt[2][0]["ordinal"] == 0
    # the seam is restored afterwards: the same read is clean
    assert tds._open_local is open
    clean = read_under_plan(tfaults, TDataset, tw_lm.make_schema(), docs, {"rules": []}, workers)
    assert clean[0] is None and len(clean[3]) == 8


UNPORTED = {
    "process_index": 1,
    "process_count": 2,
    "prefetch": 4,
    "read_retries": 2,
    "retry_policy": RetryPolicy(max_retries=3),
    "slab_bytes": 1 << 20,
    "max_record_bytes": 1 << 20,
    "use_mmap": False,
    "readahead_bytes": 0,
}


@pytest.mark.parametrize("name", sorted(UNPORTED))
def test_unported_dataset_argument_raises_naming_itself(docs, name):
    with pytest.raises(OptionNotPortedError, match=name) as e:
        TDataset(docs, batch_size=8, schema=tw_lm.make_schema(), recordType="SequenceExample",
                 **{name: UNPORTED[name]})
    assert "did you mean" not in str(e.value) and "Unknown option" not in str(e.value)


def test_dataset_arguments_take_the_jax_defaults(docs):
    import inspect

    jax_sig = inspect.signature(JDataset.__init__).parameters
    assert {k: jax_sig[k].default for k in UNPORTED} == tds.UNPORTED_ARGS
    ds = TDataset(docs, batch_size=8, schema=tw_lm.make_schema(), recordType="SequenceExample",
                  **tds.UNPORTED_ARGS)
    with ds.batches() as it:
        assert sum(1 for _ in it) == 8


def run_main(argv, capsys):
    tw_lm.main(["--device", "cpu", *argv])
    return capsys.readouterr().out.splitlines()


def test_trace_out_saves_train_step_spans(tmp_path, capsys):
    data = str(tmp_path / "data")
    tw_lm.generate(data, shards=2, docs=64)
    trace = tmp_path / "trace.json"
    try:
        out = run_main(["--mesh", "dp", "--steps", "3", "--save-every", "8", "--epochs", "1",
                        "--data-dir", data, "--ckpt-dir", str(tmp_path / "ck"),
                        "--trace-out", str(trace)], capsys)
    finally:
        telemetry.disable()
        telemetry.RECORDER.clear()
    assert f"trace saved: {trace}" in out
    events = json.loads(trace.read_text())["traceEvents"]
    steps = [e for e in events if e.get("name") == "train.step" and e.get("ph") == "X"]
    assert len(steps) == 3 and all(e["dur"] >= 0 for e in steps)
    assert [e["args"]["step"] for e in steps] == [1, 2, 3]


def test_spool_interval_refused(tmp_path):
    with pytest.raises(OptionNotPortedError, match="spool-interval"):
        tw_lm.main(["--device", "cpu", "--spool-interval", "0.5", "--data-dir",
                    str(tmp_path / "data")])
    with pytest.raises(OptionNotPortedError, match="spool"):
        tw_lm.main(["--device", "cpu", "--spool", str(tmp_path / "spool"), "--spool-interval",
                    "0.5", "--data-dir", str(tmp_path / "data")])


@pytest.mark.parametrize("env,mode", [(None, "dp_sp"), ("dp_fsdp", "dp_fsdp"), ("dp", None)])
def test_lm_mesh_sets_the_default(tmp_path, capsys, monkeypatch, env, mode):
    if env is None:
        monkeypatch.delenv("LM_MESH", raising=False)
    else:
        monkeypatch.setenv("LM_MESH", env)
    data = str(tmp_path / "data")
    tw_lm.generate(data, shards=2, docs=32)
    out = run_main(["--steps", "1", "--epochs", "1", "--data-dir", data,
                    "--ckpt-dir", str(tmp_path / "ck")], capsys)
    if mode is None:
        assert out[0] == "fresh start"
    else:
        assert out[0] == f"mesh: {{'data': 1}} mode={mode} (one device: trains as dp with 2 layers)"
        assert out[1] == "fresh start"
    assert any(ln.startswith("done: 1 steps") for ln in out)
