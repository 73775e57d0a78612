"""Faults of the port against the JAX package, repaired:

- The chaos plan reaches the dataset's mmap route: ``install_chaos``
  patches ``io.dataset._open_local``, so one ``FaultPlan`` gives the same
  exception, the same ledger and the same batches before it through the
  JAX ``TFRecordDataset`` and the port's, at 1 and 4 decode workers.
- The JAX constructor's nine read knobs are the port's keyword arguments,
  with the JAX defaults, and each reads like the JAX dataset at a value
  other than its default (the process slot at ``process_index=1`` of
  ``process_count=2``), not through the options parser's "Unknown
  option(s)" with a guess at another option.
- ``train_lm``: ``--trace-out`` saves a Chrome trace with ``train.step``
  spans, ``--spool`` / ``--spool-interval`` spool the trainer's telemetry,
  and the ``--mesh`` default comes from ``LM_MESH`` (else ``dp_sp``), as
  in the JAX example.
- ``io.reader.salvage_spans_stream`` takes the JAX ``codec`` argument
  ("auto" = from the extension), so an extensionless gzip, snappy or zstd
  shard salvages the same records and events in both packages.
- The checkpointers' ``save`` / ``restore`` take the JAX keyword names
  ``state_pytree`` / ``template_pytree``.
- ``TFRecordDataset`` takes the JAX positional order (``paths,
  batch_size, options, columns, drop_remainder, num_epochs, ...``), so a
  positional ``TFRecordOptions`` configures the read instead of being
  taken for a schema; the port's own ``schema``, ``recordType`` and
  ``decoder`` are keyword-only.
- ``CheckpointableIterator``'s first parameter is named ``dataset``, as in
  the JAX package.
- ``TFRecordOptions``' fields come in the JAX order, so the same
  positional construction sets the same options in both packages.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from tpu_tfrecord import faults as jfaults
from tpu_tfrecord.io.dataset import TFRecordDataset as JDataset
from tpu_tfrecord.retry import RetryPolicy as JRetryPolicy

from tpu_tfrecord_torch import faults as tfaults, telemetry, train_lm as tw_lm
from tpu_tfrecord_torch.io import dataset as tds
from tpu_tfrecord_torch.io.dataset import TFRecordDataset as TDataset
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


def token_batches(ds):
    with ds.batches() as it:
        return [[np.asarray(v).tolist() for v in cb["tokens"].values] for cb in it]


@pytest.mark.parametrize("name", sorted(UNPORTED))
def test_unported_dataset_argument_raises_naming_itself(docs, name):
    """Each of the nine arguments, all ported now, is taken at a value
    other than its default and gives the JAX dataset's batches at the same
    value; the process slot is read at index 1 of 2 (the second half of
    the four shards, 4 batches)."""
    kw = dict(batch_size=8, recordType="SequenceExample")
    given = {name: UNPORTED[name]}
    if name == "process_index":
        given["process_count"] = UNPORTED["process_count"]
    jval = dict(given, retry_policy=JRetryPolicy(max_retries=3)) if name == "retry_policy" \
        else given
    want = token_batches(JDataset(docs, schema=jx_lm.make_schema(), **kw, **jval))
    ds = TDataset(docs, schema=tw_lm.make_schema(), **kw, **given)
    assert getattr(ds, name) == UNPORTED[name]
    assert token_batches(ds) == want
    assert len(want) == (4 if name.startswith("process_") else 8)


def test_dataset_arguments_take_the_jax_defaults(docs):
    import inspect

    jax_sig = inspect.signature(JDataset.__init__).parameters
    port_sig = inspect.signature(TDataset.__init__).parameters
    defaults = {k: jax_sig[k].default for k in UNPORTED}
    assert {k: port_sig[k].default for k in UNPORTED} == defaults
    ds = TDataset(docs, batch_size=8, schema=tw_lm.make_schema(), recordType="SequenceExample",
                  **defaults)
    jds = JDataset(docs, batch_size=8, schema=jx_lm.make_schema(), recordType="SequenceExample",
                   **defaults)
    assert ds.fingerprint() == jds.fingerprint()  # the slot 0 of 1 stamped alike
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


def test_spool_interval_refused(tmp_path, capsys):
    """``--spool`` / ``--spool-interval``, once refused, spool as the JAX
    example does: one file under the ``trainer`` role whose last line is
    the ``final: true`` snapshot of the finished run, with its steps and
    its phase stages."""
    from tpu_tfrecord_torch import fleet
    from tpu_tfrecord_torch.metrics import METRICS

    data = str(tmp_path / "data")
    tw_lm.generate(data, shards=2, docs=64)
    spool_dir = str(tmp_path / "spool")
    steps_before = METRICS.counter("train.steps")
    try:
        out = run_main(["--mesh", "dp", "--steps", "2", "--epochs", "1", "--data-dir", data,
                        "--ckpt-dir", str(tmp_path / "ck"), "--spool", spool_dir,
                        "--spool-interval", "0.05"], capsys)
    finally:
        ctx = telemetry.RECORDER.context
        telemetry.RECORDER.context = None
    assert any(ln.startswith("done: 2 steps") for ln in out)
    (name,) = os.listdir(spool_dir)
    snap = fleet.read_spool(os.path.join(spool_dir, name))
    assert snap.final and snap.role == "trainer" and snap.interval_s == 0.05
    assert snap.pid == os.getpid() and snap.trace_id == ctx.trace_id
    assert snap.counters["train.steps"] - steps_before == 2
    assert {"train.data_wait", "train.compute"} <= set(snap.stages)
    assert fleet.train_phase_shares(snap) is not None
    assert not fleet._SPOOLS


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


# -- salvage_spans_stream's codec ------------------------------------------------------


@pytest.mark.parametrize("codec", ["gzip", "snappy", "zstd"])
def test_salvage_spans_stream_takes_a_codec(tmp_path, codec):
    """An extensionless compressed shard with one bad data CRC: with the
    codec named, both packages salvage the same records around it and
    report the same event; "auto" (the default) still reads the codec
    from an extension."""
    import importlib

    from tpu_tfrecord import wire as jwire

    # the packages' ``io.reader`` names a function; the modules by path
    jreader = importlib.import_module("tpu_tfrecord.io.reader")
    treader = importlib.import_module("tpu_tfrecord_torch.io.reader")

    if codec == "zstd":
        pytest.importorskip("zstandard")
    rng = np.random.default_rng(9)
    recs = [rng.integers(0, 256, size=int(rng.integers(1, 400)), dtype=np.uint8).tobytes()
            for _ in range(40)]
    frames = [jwire.encode_record(r) for r in recs]
    bad = bytearray(frames[17])
    bad[-1] ^= 0xFF  # the data CRC
    frames[17] = bytes(bad)
    stream = b"".join(frames)
    plain = str(tmp_path / "shard")
    named = str(tmp_path / ("shard" + jwire.codec_extension(codec)))
    for path in (plain, named):
        with jwire.open_compressed(path, "wb", codec) as fh:
            fh.write(stream)

    def salvage(fn, path, **kw):
        events, out = [], []
        for buf, offs, lens in fn(path, events.append, slab_bytes=4096, **kw):
            out += [bytes(buf[o:o + n]) for o, n in zip(offs.tolist(), lens.tolist())]
        return out, events

    want = (recs[:17] + recs[18:], [{"kind": "data_crc"}])
    for path, kw in ((plain, {"codec": codec}), (named, {})):
        mine = salvage(treader.salvage_spans_stream, path, **kw)
        assert mine == salvage(jreader.salvage_spans_stream, path, **kw)
        assert mine[0] == want[0]
        assert [e["kind"] for e in mine[1]] == ["data_crc"]


# -- the checkpointers' keyword names ----------------------------------------------------


def test_checkpointers_take_the_jax_keywords(tmp_path):
    """``AsyncCheckpointer`` and ``TrainCheckpointer`` are called with the
    same keywords in both packages, and restore the same tree."""
    from tpu_tfrecord import checkpoint as jck
    from tpu_tfrecord.io.dataset import IteratorState as JState
    from tpu_tfrecord_torch import checkpoint as tck
    from tpu_tfrecord_torch.io.dataset import IteratorState as TState

    tree = {"w": np.arange(6, dtype=np.float32).reshape(2, 3), "b": np.ones(3, np.int32)}
    template = {"w": np.zeros((2, 3), np.float32), "b": np.zeros(3, np.int32)}
    for mod, state_cls, sub in ((jck, JState, "jax"), (tck, TState, "port")):
        ack = mod.AsyncCheckpointer(str(tmp_path / sub / "async"), sync=True)
        ack.save(step=3, state_pytree=tree, payload={"k": 1})
        ack.wait()
        step, got, payload = ack.restore(template_pytree=template)
        ack.close()
        assert step == 3 and payload == {"k": 1}
        np.testing.assert_array_equal(got["w"], tree["w"])
        np.testing.assert_array_equal(got["b"], tree["b"])
        tck_ = mod.TrainCheckpointer(str(tmp_path / sub / "train"), async_save=False)
        tck_.save(step=5, state_pytree=tree, state_or_iterator=state_cls(epoch=1))
        tck_.wait()
        step, got, state = tck_.restore(template_pytree=template)
        tck_.close()
        assert step == 5 and state.epoch == 1
        np.testing.assert_array_equal(got["w"], tree["w"])


# -- the dataset's positional order and the iterator's keyword ------------------------


def test_dataset_takes_options_positionally(docs):
    """``TFRecordDataset(paths, batch_size, options, columns,
    drop_remainder, num_epochs)`` given positionally reads the same token
    batches in both packages."""
    from tpu_tfrecord.options import TFRecordOptions as JOptions
    from tpu_tfrecord_torch.options import TFRecordOptions as TOptions

    jopts = JOptions.from_map(schema=jx_lm.make_schema(), recordType="SequenceExample")
    topts = TOptions.from_map(schema=tw_lm.make_schema(), recordType="SequenceExample")
    want = token_batches(JDataset(docs, 8, jopts, None, False, 2))
    ds = TDataset(docs, 8, topts, None, False, 2)
    assert ds.options is topts and ds.num_epochs == 2 and ds.drop_remainder is False
    assert token_batches(ds) == want
    assert len(want) == 16


def test_checkpointable_iterator_takes_dataset_keyword(docs):
    """``CheckpointableIterator(dataset=..., state=...)`` resumes from a
    mid-epoch state to the same batches in both packages."""
    from tpu_tfrecord.io.dataset import CheckpointableIterator as JIterator
    from tpu_tfrecord_torch.io.dataset import CheckpointableIterator as TIterator

    out = []
    for cls, it_cls, schema in ((JDataset, JIterator, jx_lm.make_schema()),
                                (TDataset, TIterator, tw_lm.make_schema())):
        ds = cls(docs, batch_size=8, schema=schema, recordType="SequenceExample")
        with ds.batches() as it:
            for _ in range(3):
                next(it)
            state = it.state()
        it = it_cls(dataset=ds, state=state)
        try:
            out.append([[np.asarray(v).tolist() for v in cb["tokens"].values] for cb in it])
        finally:
            it.close()
    assert out[0] == out[1]
    assert len(out[1]) == 5


def test_options_fields_take_the_jax_order():
    """The JAX field order, values given positionally: the port's options
    hold the same value under every name."""
    import dataclasses

    from tpu_tfrecord.options import TFRecordOptions as JOptions
    from tpu_tfrecord_torch.options import RecordType, TFRecordOptions as TOptions

    names = [f.name for f in dataclasses.fields(JOptions)]
    assert [f.name for f in dataclasses.fields(TOptions)] == names
    j = JOptions.from_map(cache="auto", trace="on", pulse_interval_s=0.5, telemetry_port=0,
                          autotune="on", autotune_interval_s=0.25, telemetry_role="reader",
                          service="h:1", elastic_min_workers=2, elastic_interval_s=3)
    args = [getattr(j, n) for n in names]
    args[names.index("record_type")] = RecordType(j.record_type.value)
    t = TOptions(*args)
    assert {n: getattr(t, n) for n in names if n != "record_type"} == \
        {n: getattr(j, n) for n in names if n != "record_type"}
