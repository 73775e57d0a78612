"""The port's telemetry export against the JAX package's: the Prometheus
page, the exporter, the trace merger, exemplars, trace-context adoption,
and the spans a traced read and write record.

- ``prometheus_text`` is byte-equal to the JAX page after the same seeded
  sequence of ``count`` / ``add`` / ``gauge`` / ``observe(exemplar=...)``
  calls on each package's registry; its helpers agree too.
- The exporter serves that page over loopback on an ephemeral port
  (``ensure_exporter(0)``, one scrape), also when a dataset asks for it
  with ``telemetry_port=0``.
- ``merge_chrome_traces`` gives the JAX merger's output for the same files.
- ``Histogram`` exemplars (``observe``, ``exemplar_at``, ``state``) and
  the registry's pass-through equal the JAX ones; the
  serving engine tags its latency histograms with the request's ids.
- ``adopt``, ``adopt_from_env`` and ``adopt_child_from_json`` join a trace
  as the JAX functions do.
- A ``trace="on"`` read at one worker, with and without the epoch cache,
  and a ``trace="on"`` write record the JAX multiset of span names and
  attribute keys.
"""

import collections
import json
import os
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from tpu_tfrecord import cache as jcache  # noqa: E402
from tpu_tfrecord import telemetry as jtelemetry  # noqa: E402
from tpu_tfrecord.io.dataset import TFRecordDataset as JDataset  # noqa: E402
from tpu_tfrecord.io.writer import DatasetWriter as JWriter  # noqa: E402
from tpu_tfrecord.metrics import Metrics as JMetrics  # noqa: E402
from tpu_tfrecord.options import TFRecordOptions as JOptions  # noqa: E402
from tpu_tfrecord.schema import StructType as JStructType  # noqa: E402

from tpu_tfrecord_torch import cache as tcache  # noqa: E402
from tpu_tfrecord_torch import telemetry  # noqa: E402
from tpu_tfrecord_torch.io.dataset import TFRecordDataset  # noqa: E402
from tpu_tfrecord_torch.io.writer import DatasetWriter  # noqa: E402
from tpu_tfrecord_torch.metrics import METRICS, Histogram, Metrics  # noqa: E402
from tpu_tfrecord_torch.options import TFRecordOptions  # noqa: E402
from tpu_tfrecord_torch.schema import (  # noqa: E402
    ArrayType,
    LongType,
    StringType,
    StructField,
    StructType,
)

STAGES = ("decode", "read.io", "cache.serve", "serve.latency", "moe.gate_entropy",
          'odd"stage\\name')
COUNTS = ("cache.hits", "cache.misses", "read.retries")
GAUGES = ("prefetch.occupancy", "read.inflight_workers", "autotune.workers")


def traffic(seed):
    """A seeded list of registry calls (method, args, kwargs)."""
    rng = np.random.default_rng(seed)
    calls = []
    for _ in range(int(rng.integers(20, 60))):
        kind = int(rng.integers(0, 5))
        stage = STAGES[int(rng.integers(0, len(STAGES)))]
        secs = float(rng.choice([2e-8, 3e-6, 4e-4, 0.012, 0.4, 7.5]))
        ex = None
        if rng.random() < 0.5:
            ex = (f"t{int(rng.integers(0, 99)):02d}", f's"{int(rng.integers(0, 9))}')
        if kind == 0:
            calls.append(("add", (stage,), dict(records=int(rng.integers(0, 5000)),
                                                nbytes=int(rng.integers(0, 1 << 20)),
                                                seconds=secs, latency=secs, exemplar=ex)))
        elif kind == 1:
            calls.append(("add", (stage,), dict(records=int(rng.integers(0, 50)))))
        elif kind == 2:
            calls.append(("count", (COUNTS[int(rng.integers(0, len(COUNTS)))],
                                    int(rng.integers(1, 4))), {}))
        elif kind == 3:
            calls.append(("gauge", (GAUGES[int(rng.integers(0, len(GAUGES)))],
                                    float(rng.choice([0.1, 0.5, 3.0, 1e7]))), {}))
        else:
            calls.append(("observe", (stage, secs), dict(exemplar=ex)))
    return calls


def both(seed):
    t, j = Metrics(), JMetrics()
    for name, args, kw in traffic(seed):
        getattr(t, name)(*args, **kw)
        getattr(j, name)(*args, **kw)
    return t, j


# -- the Prometheus page ----------------------------------------------------------------


@pytest.mark.parametrize("seed", range(6))
def test_prometheus_text_byte_equal(seed):
    t, j = both(seed)
    page = telemetry.prometheus_text(t)
    assert page == jtelemetry.prometheus_text(j)
    assert page.endswith("\n") and "# TYPE tfrecord_stage_records_total counter" in page


def test_prometheus_text_of_an_empty_registry():
    assert telemetry.prometheus_text(Metrics()) == jtelemetry.prometheus_text(JMetrics()) == "\n"


@pytest.mark.parametrize("value", ["plain", 'a"b', "back\\slash", "new\nline", 3.5, None])
def test_escape_label_value(value):
    assert telemetry.escape_label_value(value) == jtelemetry.escape_label_value(value)


def test_family_helpers():
    q = {"p50_s": 0.1, "p90_s": 0.2, "p99_s": 0.3, "count": 4}
    rows = [('stage="a"', q), ('stage="b"', {})]
    assert telemetry.summary_family_lines("fam", rows) == \
        jtelemetry.summary_family_lines("fam", rows)
    for samples in ([], ["x 1", "x 2"]):
        a, b = ["head"], ["head"]
        telemetry.append_family(a, "x", "gauge", samples)
        jtelemetry.append_family(b, "x", "gauge", samples)
        assert a == b


# -- the exporter ------------------------------------------------------------------------


def scrape(port: int, path: str = "/metrics") -> str:
    host, bound = telemetry.exporter_address(port)
    with urllib.request.urlopen(f"http://{host}:{bound}{path}", timeout=10) as resp:
        assert resp.headers["Content-Type"].startswith("text/plain; version=0.0.4")
        return resp.read().decode()


def test_exporter_scrape_over_loopback():
    reg, _ = both(7)
    try:
        server = telemetry.ensure_exporter(0, metrics=reg)
        assert server is not None and telemetry.ensure_exporter(0, metrics=reg) is server
        host, bound = telemetry.exporter_address(0)
        assert host == "127.0.0.1" and bound > 0
        assert scrape(0) == telemetry.prometheus_text(reg) == scrape(0, "/")
        with pytest.raises(urllib.error.HTTPError) as e:
            scrape(0, "/nope")
        assert e.value.code == 404
        # a requested port that serves another kind of page is refused
        assert telemetry.serve_text_endpoint(0, lambda: "x\n", kind="fleet") is None
    finally:
        telemetry.shutdown_exporter(0)
    assert telemetry.exporter_address(0) is None


def test_unbindable_port_warns_and_returns_none(caplog):
    import socket

    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    sock.listen(1)
    taken = sock.getsockname()[1]
    try:
        assert telemetry.ensure_exporter(taken, metrics=Metrics()) is None
        assert telemetry.exporter_address(taken) is None
    finally:
        sock.close()


SCHEMA = StructType([StructField("id", LongType(), nullable=False),
                     StructField("s", StringType()),
                     StructField("arr", ArrayType(LongType()))])
ROWS = [[i, f"v{i}" * (i % 3), list(range(i % 5))] for i in range(5000)]


@pytest.fixture
def data_dir(tmp_path):
    out = str(tmp_path / "ds")
    DatasetWriter(out, SCHEMA, mode="overwrite", max_records_per_file=2500).write_rows(ROWS)
    return out


@pytest.fixture
def recorders():
    """Both packages' flight recorders cleared before and disabled after."""
    for tel in (telemetry, jtelemetry):
        tel.RECORDER.clear()
    METRICS.reset()
    yield
    for tel in (telemetry, jtelemetry):
        tel.disable()
        tel.RECORDER.clear()
    tcache.release_registry()
    jcache.release_registry()


def test_dataset_telemetry_port_serves_the_cache_counters(data_dir, tmp_path, recorders):
    cache_dir = str(tmp_path / "cache")
    try:
        for _ in range(2):
            ds = TFRecordDataset(data_dir, 1000, schema=SCHEMA, cache="auto", cache_dir=cache_dir,
                                 telemetry_port=0)
            with ds.batches() as it:
                for _b in it:
                    pass
        page = scrape(0)
    finally:
        telemetry.shutdown_exporter(0)
    assert 'tfrecord_stage_records_total{stage="cache.hits"} 2' in page
    assert 'tfrecord_stage_records_total{stage="cache.misses"} 2' in page
    assert 'tfrecord_latency_seconds_count{stage="cache.serve"} 4' in page


# -- the trace merger --------------------------------------------------------------------


def trace_file(path, pid, host, span, events=3, named=True, ctx=True, role="w"):
    evs = []
    if named:
        evs.append({"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
                    "args": {"name": f"{role}@{host}:{pid}"}})
    for k in range(events):
        evs.append({"name": "decode", "cat": "tfrecord", "ph": "X", "ts": 10.0 * k,
                    "dur": 5.0, "pid": pid, "tid": 7, "args": {"rows": k}})
    obj = {"traceEvents": evs, "displayTimeUnit": "ms"}
    if ctx:
        obj["traceContext"] = {"trace_id": "tr", "span_id": span, "parent_span_id": None,
                               "role": role, "host": host, "pid": pid}
    with open(path, "w") as fh:
        json.dump(obj, fh)
    return str(path)


MERGE_CASES = {
    "two_hosts_one_pid": [("a.json", 100, "h1", "s1", True, True),
                          ("b.json", 100, "h2", "s2", True, True)],
    "unnamed_and_contextless": [("a.json", 5, "h1", "s1", False, True),
                                ("b.json", 5, "h1", "s2", False, False),
                                ("c.json", 9, "h3", "s3", True, False)],
    "same_process_twice": [("a.json", 42, "h1", "s1", True, True),
                           ("b.json", 42, "h1", "s1", True, True)],
}


@pytest.mark.parametrize("case", sorted(MERGE_CASES))
def test_merge_chrome_traces_equals_jax(tmp_path, case):
    paths = [trace_file(tmp_path / name, pid, host, span, named=named, ctx=ctx)
             for name, pid, host, span, named, ctx in MERGE_CASES[case]]
    got = telemetry.merge_chrome_traces(str(tmp_path / "t.json"), paths)
    want = jtelemetry.merge_chrome_traces(str(tmp_path / "j.json"), paths)
    assert got == want
    assert json.loads((tmp_path / "t.json").read_text()) == want
    named = {e["pid"] for e in got["traceEvents"] if e.get("name") == "process_name"}
    assert named == {e["pid"] for e in got["traceEvents"]}


def test_merge_rejects_malformed_input(tmp_path):
    bad = tmp_path / "bad.json"
    bad.write_text("[1, 2]")
    with pytest.raises(ValueError, match="not a Chrome trace-event JSON object"):
        telemetry.merge_chrome_traces(str(tmp_path / "o.json"), [str(bad)])
    bad.write_text("{nope")
    with pytest.raises(ValueError, match="not valid JSON"):
        telemetry.merge_chrome_traces(str(tmp_path / "o.json"), [str(bad)])


def test_merged_recorder_traces_keep_both_processes(tmp_path, recorders):
    """A port trace and a JAX trace of one process merge into one track
    each; the port's export carries its context as the JAX one does."""
    telemetry.adopt(telemetry.TraceContext.new(role="port"))
    jtelemetry.adopt(jtelemetry.TraceContext.new(role="jax"))
    for tel in (telemetry, jtelemetry):
        tel.enable()
        with tel.span("decode", rows=3):
            pass
    telemetry.RECORDER.save_chrome_trace(str(tmp_path / "t.json"))
    jtelemetry.RECORDER.save_chrome_trace(str(tmp_path / "j.json"))
    port = json.loads((tmp_path / "t.json").read_text())
    assert port["traceContext"]["role"] == "port"
    assert set(port) == set(json.loads((tmp_path / "j.json").read_text()))
    paths = [str(tmp_path / "t.json"), str(tmp_path / "j.json")]
    merged = telemetry.merge_chrome_traces(str(tmp_path / "m.json"), paths)
    assert merged == jtelemetry.merge_chrome_traces(str(tmp_path / "n.json"), paths)
    labels = sorted(e["args"]["name"].split("@")[0] for e in merged["traceEvents"]
                    if e.get("name") == "process_name")
    assert labels == ["jax", "port"]
    assert len({e["pid"] for e in merged["traceEvents"]}) == 2


# -- exemplars ----------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_histogram_exemplars_equal_jax(seed):
    rng = np.random.default_rng(seed)
    t, j = Histogram(), jtelemetry.Histogram()
    for k in range(200):
        v = float(rng.lognormal(-6, 2))
        ex = (f"t{k}", f"s{k}") if rng.random() < 0.3 else None
        t.observe(v, exemplar=ex)
        j.observe(v, exemplar=ex)
    assert t.state() == j.state()
    for q in (0.0, 0.5, 0.9, 0.99, 1.0):
        assert t.exemplar_at(q) == j.exemplar_at(q)
        assert t.quantile(q) == j.quantile(q)
    assert [Histogram.bucket_le(i) for i in (0, 1, 77)] == \
        [jtelemetry.Histogram.bucket_le(i) for i in (0, 1, 77)]
    assert telemetry.Histogram is Histogram


def test_exemplar_free_state_has_no_exemplars_key():
    h = Histogram()
    h.observe(0.1)
    assert "exemplars" not in h.state() and h.exemplar_at(0.99) is None


@pytest.mark.parametrize("seed", range(3))
def test_registry_passes_exemplars_through(seed):
    t, j = both(seed)
    assert t.hist_states() == j.hist_states()
    assert any("exemplars" in st for st in t.hist_states().values())


def test_serving_engine_tags_latency_with_the_request_ids():
    from tpu_tfrecord_torch.models import lm
    from tpu_tfrecord_torch.serving import ServePolicy, ServingEngine

    cfg = lm.LMConfig(vocab_size=32, d_model=16, n_heads=2, n_layers=2, max_len=8, n_virtual=1)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    reg = Metrics()
    eng = ServingEngine(params, cfg, 1, policy=ServePolicy(mb=2), metrics=reg, device="cpu")
    rng = np.random.default_rng(0)
    ctxs = [telemetry.TraceContext.new(role="client") for _ in range(2)]
    reqs = [eng.submit(rng.integers(1, 32, size=8).astype(np.int32), 2, trace=ctx)
            for ctx in ctxs]
    eng.run_until_idle()
    eng.stop()
    ids = {(r.trace_id, r.span_id) for r in reqs}
    assert {t for t, _ in ids} == {c.trace_id for c in ctxs}
    states = reg.hist_states()
    for name in ("serve.latency", "serve.queue_wait", "serve.service"):
        got = {(t, s) for t, s, _v in states[name]["exemplars"].values()}
        assert got and got <= ids
    page = telemetry.prometheus_text(reg)
    assert any(f'trace_id="{t}"' in page for t, _ in ids)


# -- trace-context adoption ---------------------------------------------------------------


@pytest.fixture
def contexts():
    saved = (telemetry.RECORDER.context, jtelemetry.RECORDER.context)
    yield
    telemetry.RECORDER.context, jtelemetry.RECORDER.context = saved


def test_adopt_from_env_joins_the_parents_trace(contexts):
    parent = telemetry.TraceContext.new(role="coordinator")
    env = parent.to_env()
    assert env == {telemetry.TRACE_CONTEXT_ENV: json.dumps(parent.to_json(), sort_keys=True)}
    child, jchild = telemetry.adopt_from_env("w0", env), jtelemetry.adopt_from_env("w0", env)
    for c in (child, jchild):
        assert c.trace_id == parent.trace_id and c.parent_span_id == parent.span_id
        assert c.role == "w0" and c.pid == os.getpid() and c.span_id != parent.span_id
    assert telemetry.current_context() is child
    assert telemetry.adopt_from_env(environ={}).parent_span_id is None


@pytest.mark.parametrize("payload", ["{broken", "null", "[1]", '"x"'])
def test_malformed_env_payload_adopts_a_fresh_root(contexts, payload):
    env = {telemetry.TRACE_CONTEXT_ENV: payload}
    got, want = telemetry.adopt_from_env("r", env), jtelemetry.adopt_from_env("r", env)
    assert got.parent_span_id is None and want.parent_span_id is None
    assert got.role == want.role == "r"


@pytest.mark.parametrize("payload", [
    {"trace_id": "abc", "span_id": "def", "role": "dispatcher"}, None, [1], "x"])
def test_adopt_child_from_json(contexts, payload):
    got, want = telemetry.adopt_child_from_json(payload), \
        jtelemetry.adopt_child_from_json(payload)
    assert (got.trace_id == want.trace_id) == isinstance(payload, dict)
    assert got.parent_span_id == want.parent_span_id
    assert got.role == want.role


def test_adopt_restamps_host_and_pid(contexts):
    ctx = telemetry.TraceContext("t", "s", None, "r", host="elsewhere", pid=1)
    got = telemetry.adopt(ctx)
    assert got.pid == os.getpid() and got.host != "elsewhere" and got.trace_id == "t"
    assert telemetry.RECORDER.context is got


# -- the spans of a traced read and write --------------------------------------------------


def span_multiset(rec):
    return collections.Counter((r[0], tuple(sorted((r[4] or {}).keys())), r[5])
                               for r in rec.spans())


@pytest.mark.parametrize("mode", ["uncached", "populate", "warm"])
def test_traced_read_spans_equal_jax(data_dir, tmp_path, recorders, mode):
    seen = []
    jschema = JStructType.from_json(SCHEMA.to_json())
    for cls, schema, tel, side in ((TFRecordDataset, SCHEMA, telemetry, "t"),
                                   (JDataset, jschema, jtelemetry, "j")):
        kw = {} if mode == "uncached" else dict(cache="auto", cache_dir=str(tmp_path / side))
        runs = 2 if mode == "warm" else 1
        for _ in range(runs):
            tel.RECORDER.clear()
            ds = cls(data_dir, 1000, schema=schema, trace="on", num_workers=1, **kw)
            with ds.batches() as it:
                for _b in it:
                    pass
        seen.append(span_multiset(tel.RECORDER))
        tel.disable()
    assert seen[0] == seen[1]
    names = {k[0] for k in seen[0]}
    want = {"uncached": {"open", "decode", "batch"},
            "populate": {"open", "decode", "batch", "cache.open", "cache.commit"},
            "warm": {"batch", "cache.open", "cache.serve"}}[mode]
    assert names == want
    if mode == "warm":
        assert seen[0][("cache.serve", ("rows", "shard"), "X")] == 4


@pytest.mark.parametrize("layout", ["pipeline_1", "pipeline_2", "sequential"])
def test_traced_write_spans_equal_jax(tmp_path, recorders, layout):
    """The writer's spans (missing from the port's writer before, though
    its ``timed`` stages were there): the JAX names and attribute keys."""
    kw = {"pipeline_1": dict(write_workers=1, num_shards=2),
          "pipeline_2": dict(write_workers=2, num_shards=2),
          "sequential": {}}[layout]
    seen = []
    jschema = JStructType.from_json(SCHEMA.to_json())
    for cls, schema, opts, tel, side in (
            (DatasetWriter, SCHEMA, TFRecordOptions, telemetry, "t"),
            (JWriter, jschema, JOptions, jtelemetry, "j")):
        tel.RECORDER.clear()
        cls(str(tmp_path / side), schema,
            opts.from_map(trace="on", codec="gzip", **kw),
            mode="overwrite").write_rows(ROWS)
        seen.append(span_multiset(tel.RECORDER))
        tel.disable()
    assert seen[0] == seen[1]
    want = {"write.commit"} if layout == "sequential" else {
        "write.encode", "write.compress", "write.io", "write.commit"}
    assert {k[0] for k in seen[0]} == want
    assert seen[0][("write.commit", ("job", "shards"), "X")] == 1


def test_trace_off_never_disables(data_dir, recorders):
    telemetry.enable()
    TFRecordDataset(data_dir, 1000, schema=SCHEMA, trace="off")
    DatasetWriter(data_dir + "_w", SCHEMA, TFRecordOptions.from_map(trace="off"))
    assert telemetry.RECORDER.enabled
