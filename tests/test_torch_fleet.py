"""The port's fleet flight recorder against the JAX package's.

Twins of ``tests/test_fleet.py`` on ``tpu_tfrecord_torch``: the trace
context, the bucket-exact histogram merge, atomic writes, trace merging,
the telemetry spool, the aggregator (sums, merges, liveness on an
injected clock, the federated page and its endpoint), the spool options
and the dataset's spool. Cross-package: each package's aggregator reads
the other's spool directory (counters, stage totals, liveness, merged
quantiles equal, the federated page byte-equal), a directory that both
spool into aggregates the same in both, and the repo's
``tfrecord_doctor fleet`` reads a port-written directory.

The integration cases spawn this file as a spooling port reader
(``python tests/test_torch_fleet.py worker SPEC``), three at a time, each
with its own timeout; one lingers and is SIGKILLed mid-life.
"""

import json
import os
import random
import signal
import subprocess
import sys
import time

import pytest
import torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DOCTOR = os.path.join(REPO, "tools", "tfrecord_doctor.py")
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from tpu_tfrecord_torch import fleet, telemetry  # noqa: E402
from tpu_tfrecord_torch.fleet import TelemetryAggregator, TelemetrySpool, read_spool  # noqa: E402
from tpu_tfrecord_torch.metrics import METRICS, Histogram, Metrics  # noqa: E402
from tpu_tfrecord_torch.schema import LongType, StringType, StructField, StructType  # noqa: E402
from tpu_tfrecord_torch.telemetry import (  # noqa: E402
    TraceContext,
    atomic_write_bytes,
    merge_chrome_traces,
)

SCHEMA = StructType([StructField("id", LongType(), nullable=False),
                     StructField("s", StringType())])
WORKER_TIMEOUT_S = 120.0


def write_dataset(path, n_shards=3, rows_per_shard=40):
    import tpu_tfrecord_torch.io as tio

    for s in range(n_shards):
        tio.write([[i, f"s{i}"] for i in range(s * rows_per_shard, (s + 1) * rows_per_shard)],
                  SCHEMA, str(path), mode="append" if s else "overwrite")
    return str(path)


def _reset_globals():
    from tpu_tfrecord import telemetry as jtel
    from tpu_tfrecord.metrics import METRICS as JMETRICS

    for tel, metrics in ((telemetry, METRICS), (jtel, JMETRICS)):
        tel.disable()
        tel.RECORDER.clear()
        tel.RECORDER.context = None
        metrics.reset()


@pytest.fixture(autouse=True)
def _clean_process_globals():
    """The trace context and metrics registry are process-global; every
    test starts and ends with both pristine, in both packages."""
    _reset_globals()
    yield
    _reset_globals()


def _spool(tmp_path, metrics, clock, interval=1.0, role="reader", pid=None, host="testhost",
           pkg=fleet, tel=telemetry):
    ctx = tel.TraceContext(trace_id="t" * 16, span_id=os.urandom(4).hex(), role=role,
                           host=host, pid=os.getpid() if pid is None else pid)
    return pkg.TelemetrySpool(str(tmp_path), role=role, interval_s=interval, metrics=metrics,
                              context=ctx, clock=clock)


def _jax():
    from tpu_tfrecord import fleet as jfleet, telemetry as jtel
    from tpu_tfrecord.metrics import Metrics as JMetrics

    return jfleet, jtel, JMetrics


# ---------------------------------------------------------------------------
# TraceContext
# ---------------------------------------------------------------------------


class TestTraceContext:
    def test_new_stamps_identity(self):
        ctx = TraceContext.new(role="dispatcher")
        assert ctx.trace_id and ctx.span_id and ctx.trace_id != ctx.span_id
        assert ctx.parent_span_id is None
        assert ctx.role == "dispatcher" and ctx.pid == os.getpid() and ctx.host
        assert ctx.label() == f"dispatcher@{ctx.host}:{ctx.pid}"

    def test_child_shares_trace_not_identity(self):
        root = TraceContext.new()
        child = root.child("decode_worker")
        assert child.trace_id == root.trace_id
        assert child.parent_span_id == root.span_id
        assert child.span_id != root.span_id
        assert child.host == "" and child.pid == 0

    def test_with_role_is_the_jax_with_role(self):
        _, jtel, _ = _jax()
        fields = dict(trace_id="t" * 16, span_id="s" * 16, parent_span_id="p" * 16,
                      role="main", host="h", pid=7)
        mine = TraceContext(**fields).with_role("trainer")
        theirs = jtel.TraceContext(**fields).with_role("trainer")
        assert mine.to_json() == theirs.to_json()
        assert mine.role == "trainer" and mine.span_id == "s" * 16

    def test_json_round_trip(self):
        ctx = TraceContext.new(role="trainer")
        assert TraceContext.from_json(json.loads(json.dumps(ctx.to_json()))) == ctx
        assert TraceContext.from_json(dict(ctx.to_json(), future_field=1)) == ctx

    def test_adopt_restamps_host_pid(self):
        foreign = TraceContext(trace_id="t" * 16, span_id="s" * 16, host="elsewhere", pid=1)
        adopted = telemetry.adopt(foreign)
        assert adopted.trace_id == foreign.trace_id
        assert adopted.pid == os.getpid() and adopted.host != "elsewhere"
        assert telemetry.current_context() is adopted

    def test_current_context_is_sticky(self):
        a = telemetry.current_context()
        assert telemetry.current_context() is a

    def test_adopt_from_env_joins_parent_trace(self):
        parent = TraceContext.new(role="parent")
        ctx = telemetry.adopt_from_env(role="worker", environ=parent.to_env())
        assert ctx.trace_id == parent.trace_id
        assert ctx.parent_span_id == parent.span_id
        assert ctx.span_id != parent.span_id
        assert ctx.role == "worker" and ctx.pid == os.getpid()

    def test_adopt_from_env_without_or_bad_payload_is_fresh_root(self):
        ctx = telemetry.adopt_from_env(environ={})
        assert ctx.parent_span_id is None
        telemetry.RECORDER.context = None
        ctx2 = telemetry.adopt_from_env(environ={telemetry.TRACE_CONTEXT_ENV: "{not json"})
        assert ctx2.parent_span_id is None and ctx2.trace_id != ctx.trace_id
        for payload in ("null", "[1, 2]", '"x"', "42"):
            telemetry.RECORDER.context = None
            ctx3 = telemetry.adopt_from_env(environ={telemetry.TRACE_CONTEXT_ENV: payload})
            assert ctx3.parent_span_id is None, payload


# ---------------------------------------------------------------------------
# Histogram state export / exact merge
# ---------------------------------------------------------------------------


def _observations(seed, n):
    rng = random.Random(seed)
    return [rng.choice([5e-8, 1e-6, 1e-4, 3e-3, 0.05, 1.7]) * (1.0 + rng.random())
            for _ in range(n)]


class TestHistogramMerge:
    @pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
    def test_merged_equals_concatenated_exactly(self, seed):
        """K histograms merged bucket-wise equal one histogram fed every
        observation, and a JAX histogram fed the same parts merges to the
        same buckets, quantiles and exemplars."""
        _, jtel, _ = _jax()
        rng = random.Random(seed * 1000 + 7)
        parts = [Histogram() for _ in range(3)]
        jparts = [jtel.Histogram() for _ in range(3)]
        reference = Histogram()
        for n, v in enumerate(_observations(seed, 400)):
            k = rng.randrange(3)
            ex = (f"t{k}", f"s{n}") if n % 7 == 0 else None
            parts[k].observe(v, exemplar=ex)
            jparts[k].observe(v, exemplar=ex)
            reference.observe(v, exemplar=ex)
        states = [json.loads(json.dumps(p.state())) for p in parts]
        assert states == [json.loads(json.dumps(p.state())) for p in jparts]
        merged = Histogram.from_states(states)
        assert merged.counts == reference.counts
        assert (merged.count, merged.min, merged.max) == (reference.count, reference.min,
                                                           reference.max)
        assert merged.total == pytest.approx(reference.total)
        mq, rq = merged.quantiles(), reference.quantiles()
        assert mq.pop("mean_s") == pytest.approx(rq.pop("mean_s"))
        assert mq == rq
        jmerged = jtel.Histogram.from_states(states)
        assert jmerged.counts == merged.counts and jmerged.exemplars == merged.exemplars
        assert jmerged.quantiles() == merged.quantiles()
        assert jmerged.exemplar_at(0.99) == merged.exemplar_at(0.99)

    def test_state_is_sparse_and_json_safe(self):
        h = Histogram()
        h.observe(0.001)
        h.observe(0.001)
        st = json.loads(json.dumps(h.state()))
        assert st["count"] == 2
        assert sum(int(c) for c in st["buckets"].values()) == 2
        assert len(st["buckets"]) == 1

    def test_empty_states_merge_to_empty(self):
        merged = Histogram.from_states([Histogram().state()] * 3)
        assert merged.count == 0 and merged.quantiles() == {}

    @pytest.mark.parametrize("pkg", ["port", "jax"])
    def test_foreign_states_raise_the_jax_exception_types(self, pkg):
        """A foreign layout, an index out of range and a non-mapping are
        refused with the exceptions the aggregator catches, in both
        packages alike; the refused state changes nothing."""
        cls = Histogram if pkg == "port" else _jax()[1].Histogram
        h = cls()
        bad = cls().state()
        bad["layout"] = [1e-7, 0.5, 72]
        with pytest.raises(ValueError, match="layout"):
            h.merge_state(bad)
        for buckets in ({"-3": 2}, {"1000000": 1}):
            bad = dict(cls().state(), buckets=buckets)
            with pytest.raises(ValueError, match="out of range"):
                h.merge_state(bad)
        with pytest.raises(TypeError, match="mapping"):
            h.merge_state([1, 2, 3])
        with pytest.raises(TypeError, match="mapping"):
            h.merge_state(dict(cls().state(), buckets=[4]))
        with pytest.raises(TypeError, match="mapping"):
            h.merge_state(dict(cls().state(), exemplars=[4]))
        with pytest.raises(ValueError, match="out of range"):
            h.merge_state(dict(cls().state(), exemplars={"999": ["t", "s", 1.0]}))
        assert h.count == 0

    def test_merge_carries_exemplars_last_wins(self):
        a, b = Histogram(), Histogram()
        a.observe(0.01, exemplar=("ta", "sa"))
        b.observe(0.01, exemplar=("tb", "sb"))
        b.observe(2.0, exemplar=("tail", "slow"))
        merged = Histogram.from_states([a.state(), b.state()])
        assert merged.count == 3
        idx = merged.bucket_index(0.01)
        assert merged.exemplars[idx] == ("tb", "sb", 0.01)
        assert merged.exemplar_at(0.99)["trace_id"] == "tail"


# ---------------------------------------------------------------------------
# Atomic artifact writes and trace merging
# ---------------------------------------------------------------------------


class TestAtomicWrite:
    def test_write_and_no_tmp_residue(self, tmp_path):
        p = str(tmp_path / "a.json")
        atomic_write_bytes(p, b"one")
        atomic_write_bytes(p, b"two")
        assert open(p, "rb").read() == b"two"
        assert os.listdir(tmp_path) == ["a.json"]

    def test_failed_write_leaves_previous_file(self, tmp_path, monkeypatch):
        p = str(tmp_path / "a.json")
        atomic_write_bytes(p, b"good")

        def boom(src, dst):
            raise OSError("disk full")

        monkeypatch.setattr(os, "replace", boom)
        with pytest.raises(OSError):
            atomic_write_bytes(p, b"bad")
        monkeypatch.undo()
        assert open(p, "rb").read() == b"good"
        assert os.listdir(tmp_path) == ["a.json"]

    def test_save_chrome_trace_is_atomic(self, tmp_path, monkeypatch):
        telemetry.enable()
        with telemetry.span("decode", shard="a"):
            pass
        p = str(tmp_path / "t.json")
        telemetry.RECORDER.save_chrome_trace(p)
        first = open(p).read()

        def boom(src, dst):
            raise OSError("disk full")

        monkeypatch.setattr(os, "replace", boom)
        with pytest.raises(OSError):
            telemetry.RECORDER.save_chrome_trace(p)
        monkeypatch.undo()
        assert open(p).read() == first
        assert os.listdir(tmp_path) == ["t.json"]


def _fake_trace(path, ctx, span_name, pid=None):
    rec = telemetry.SpanRecorder(enabled=True)
    rec.context = ctx
    with rec.span(span_name):
        pass
    doc = rec.to_chrome_trace()
    if pid is not None:  # another host reusing a pid number
        for ev in doc["traceEvents"]:
            ev["pid"] = pid
        doc["traceContext"] = dict(doc["traceContext"], pid=pid)
    atomic_write_bytes(str(path), json.dumps(doc).encode())
    return doc


class TestMergeChromeTraces:
    def test_merge_keeps_one_named_track_per_process(self, tmp_path):
        paths = []
        for i in range(3):
            ctx = TraceContext(trace_id="t" * 16, span_id=f"s{i}" * 4, role=f"r{i}",
                               host="hostA", pid=1000 + i)
            paths.append(str(tmp_path / f"p{i}.json"))
            _fake_trace(paths[-1], ctx, f"decode{i}", pid=ctx.pid)
        out = tmp_path / "merged.json"
        merged = merge_chrome_traces(str(out), paths)
        doc = json.load(open(out))
        assert doc == json.loads(json.dumps(merged))
        pids = {e["pid"] for e in doc["traceEvents"]}
        named = {e["pid"]: e["args"]["name"] for e in doc["traceEvents"]
                 if e.get("ph") == "M" and e["name"] == "process_name"}
        assert len(pids) == 3 and set(named) == pids
        assert named[1001] == "r1@hostA:1001"
        assert {"decode0", "decode1", "decode2"} <= {e["name"] for e in doc["traceEvents"]}

    def test_pid_collision_across_hosts_remapped(self, tmp_path):
        pa, pb = tmp_path / "a.json", tmp_path / "b.json"
        _fake_trace(pa, TraceContext(trace_id="t" * 16, span_id="a" * 8, role="w",
                                     host="hostA", pid=7), "spanA", pid=7)
        _fake_trace(pb, TraceContext(trace_id="t" * 16, span_id="b" * 8, role="w",
                                     host="hostB", pid=7), "spanB", pid=7)
        merged = merge_chrome_traces(str(tmp_path / "m.json"), [str(pa), str(pb)])
        ev_a = [e for e in merged["traceEvents"] if e["name"] == "spanA"][0]
        ev_b = [e for e in merged["traceEvents"] if e["name"] == "spanB"][0]
        assert ev_a["pid"] != ev_b["pid"]
        labels = {e["args"]["name"] for e in merged["traceEvents"]
                  if e.get("ph") == "M" and e["name"] == "process_name"}
        assert {"w@hostA:7", "w@hostB:7"} <= labels

    def test_contextless_file_gets_synthesized_label(self, tmp_path):
        p = tmp_path / "legacy.json"
        p.write_text(json.dumps({"traceEvents": [
            {"name": "x", "ph": "X", "ts": 0, "dur": 1, "pid": 3, "tid": 1}]}))
        merged = merge_chrome_traces(str(tmp_path / "m.json"), [str(p)])
        meta = [e for e in merged["traceEvents"]
                if e.get("ph") == "M" and e["name"] == "process_name"]
        assert meta and meta[0]["args"]["name"] == "legacy.json"

    def test_malformed_input_raises_not_drops(self, tmp_path):
        good = tmp_path / "good.json"
        good.write_text(json.dumps({"traceEvents": []}))
        bad = tmp_path / "bad.json"
        bad.write_text("{torn")
        with pytest.raises(ValueError, match="bad.json"):
            merge_chrome_traces(str(tmp_path / "m.json"), [str(good), str(bad)])
        notatrace = tmp_path / "list.json"
        notatrace.write_text("[1, 2]")
        with pytest.raises(ValueError, match="list.json"):
            merge_chrome_traces(str(tmp_path / "m.json"), [str(notatrace)])
        with pytest.raises(OSError):
            merge_chrome_traces(str(tmp_path / "m.json"), [str(tmp_path / "missing.json")])


# ---------------------------------------------------------------------------
# Telemetry spool
# ---------------------------------------------------------------------------


class TestSpool:
    def test_tick_writes_newest_cumulative_snapshot(self, tmp_path):
        m = Metrics()
        now = [100.0]
        sp = _spool(tmp_path, m, lambda: now[0], interval=0.5)
        m.add("decode", records=10, nbytes=64, seconds=0.25, latency=0.25)
        sp.tick()
        m.add("decode", records=5, nbytes=32, seconds=0.1, latency=0.1)
        m.gauge("prefetch.occupancy", 0.5)
        now[0] = 101.0
        sp.tick()
        snap = read_spool(sp.path)
        assert snap.lines == 2 and snap.skipped_lines == 0 and snap.seq == 2
        assert snap.stages["decode"][:2] == [15, 96]
        assert snap.gauges["prefetch.occupancy"] == 0.5
        assert snap.heartbeat == 101.0
        assert snap.role == "reader" and snap.host == "testhost"
        assert snap.hists["decode"]["count"] == 2
        assert m.counter("fleet.spool_writes") == 2

    def test_line_is_the_jax_layout(self, tmp_path):
        """The same registry contents and clock give the same spool line
        from both packages, key for key (only the writer's identity and
        the job marker's own wall clock differ)."""
        jfleet, jtel, JMetrics = _jax()
        lines = []
        for pkg, tel, M, sub in ((fleet, telemetry, Metrics, "port"),
                                 (jfleet, jtel, JMetrics, "jax")):
            m = M()
            m.add("decode", records=10, nbytes=64, seconds=0.25, latency=0.25)
            m.count("read.stalls", 2)
            m.gauge("prefetch.occupancy", 0.25)
            m.observe("serve.latency", 0.02, exemplar=("t" * 16, "s" * 16))
            os.makedirs(tmp_path / sub)
            sp = _spool(tmp_path / sub, m, lambda: 5.0, pid=3, pkg=pkg, tel=tel)
            sp.tick(final=True)
            obj = json.loads(open(sp.path).read().splitlines()[-1])
            for key in ("span_id", "created"):
                obj["job"].pop(key)
            lines.append(obj)
        assert lines[0] == lines[1]
        assert lines[0]["v"] == fleet.SPOOL_VERSION == jfleet.SPOOL_VERSION == 1
        assert lines[0]["final"] is True

    def test_counters_and_stages_partition(self, tmp_path):
        m = Metrics()
        m.count("read.stalls", 3)
        m.add("decode", records=4, seconds=0.2)
        line = _spool(tmp_path, m, lambda: 1.0).snapshot()
        assert line["counters"] == {"read.stalls": 3}
        assert list(line["stages"]) == ["decode"]

    def test_torn_line_skipped_not_fatal(self, tmp_path):
        m = Metrics()
        m.add("decode", records=7, seconds=0.1)
        sp = _spool(tmp_path, m, lambda: 5.0)
        sp.tick()
        with open(sp.path, "ab") as fh:
            fh.write(b'{"event": "spool", "tor')
        snap = read_spool(sp.path)
        assert snap.skipped_lines == 1 and snap.stages["decode"][0] == 7

    def test_no_valid_lines_returns_none(self, tmp_path):
        p = tmp_path / f"x{fleet.SPOOL_SUFFIX}"
        p.write_text("garbage\n{also: torn\n")
        assert read_spool(str(p)) is None
        assert read_spool(str(tmp_path / "missing")) is None
        assert fleet.read_spool_history(str(tmp_path / "missing")) == []

    def test_history_bounded(self, tmp_path):
        sp = TelemetrySpool(str(tmp_path), interval_s=1.0, metrics=Metrics(),
                            context=TraceContext.new(), max_lines=4, clock=lambda: 1.0)
        for _ in range(10):
            sp.tick()
        lines = [ln for ln in open(sp.path).read().splitlines() if ln.strip()]
        assert len(lines) == 4 and json.loads(lines[-1])["seq"] == 10
        history = fleet.read_spool_history(sp.path)
        assert [s.seq for s in history] == [7, 8, 9, 10]

    def test_tick_never_raises(self, tmp_path, monkeypatch):
        m = Metrics()
        sp = _spool(tmp_path, m, lambda: 1.0)

        def boom(path, data):
            raise OSError("spool dir vanished")

        monkeypatch.setattr(fleet, "atomic_write_bytes", boom)
        sp.tick()
        assert m.counter("fleet.spool_errors") == 1

    def test_thread_ticks_and_final_snapshot(self, tmp_path):
        m = Metrics()
        m.add("decode", records=1, seconds=0.01)
        sp = TelemetrySpool(str(tmp_path), interval_s=0.05, metrics=m,
                            context=TraceContext.new(role="reader"))
        sp.start()
        deadline = time.time() + 5.0
        while time.time() < deadline:
            snap = read_spool(sp.path)
            if snap is not None and snap.seq >= 2:
                break
            time.sleep(0.02)
        m.add("decode", records=9, seconds=0.01)
        sp.stop(final=True)
        sp.stop(final=True)  # idempotent
        snap = read_spool(sp.path)
        assert snap.stages["decode"][0] == 10 and snap.final

    def test_default_role_keeps_adopted_context_role(self, tmp_path):
        telemetry.adopt(TraceContext.new(role="decode_worker"))
        sp = TelemetrySpool(str(tmp_path), metrics=Metrics())
        assert sp.context.role == "decode_worker"
        assert telemetry.current_context().role == "decode_worker"
        sp2 = TelemetrySpool(str(tmp_path), role="trainer", metrics=Metrics())
        assert sp2.context.role == "trainer"

    def test_acquire_release_refcount(self, tmp_path):
        d = str(tmp_path / "spool")
        a = fleet.acquire_spool(d, interval_s=60.0)
        b = fleet.acquire_spool(d, interval_s=60.0)
        assert a is b
        fleet.release_spool(d)
        assert not a._stop.is_set()
        fleet.release_spool(d)
        assert a._stop.is_set()
        assert read_spool(a.path).final
        fleet.release_spool(d)  # unmatched release ignored
        assert not fleet._SPOOLS

    def test_remote_scheme_spool_dir_rejected(self, tmp_path):
        with pytest.raises(ValueError, match="local path"):
            fleet.TelemetrySpool("gs://bucket/spool", metrics=Metrics())
        with pytest.raises(ValueError, match="local path"):
            fleet.acquire_spool("s3://bucket/spool", interval_s=60.0)
        with pytest.raises(ValueError, match="local path"):
            fleet.TelemetryAggregator("gs://bucket/spool")
        assert not fleet._SPOOLS

    def test_snapshot_follows_late_adopted_context(self, tmp_path):
        m = Metrics()
        m.add("decode", records=1, seconds=0.1)
        sp = TelemetrySpool(str(tmp_path), metrics=m, clock=lambda: 1.0)
        early = sp.snapshot()
        shared = telemetry.adopt(TraceContext.new(role="worker"))
        assert early["job"]["trace_id"] != shared.trace_id
        late = sp.snapshot()
        assert late["job"]["trace_id"] == shared.trace_id and late["job"]["role"] == "worker"
        pinned = _spool(tmp_path, m, lambda: 1.0)
        telemetry.adopt(TraceContext.new(role="other"))
        assert pinned.snapshot()["job"]["trace_id"] == "t" * 16


# ---------------------------------------------------------------------------
# Aggregator
# ---------------------------------------------------------------------------


def _write_process(tmp_path, clock, pid, role="reader", decode=(10, 100, 0.5), counters=(),
                   latencies=(), occupancy=None, interval=1.0, pkg=fleet, tel=telemetry,
                   metrics_cls=Metrics):
    m = metrics_cls()
    m.add("decode", records=decode[0], nbytes=decode[1], seconds=decode[2])
    for name, v in counters:
        m.count(name, v)
    for lat in latencies:
        m.observe("decode", lat)
    if occupancy is not None:
        m.gauge(telemetry.OCCUPANCY_GAUGE, occupancy)
    _spool(tmp_path, m, clock, interval=interval, role=role, pid=pid, pkg=pkg, tel=tel).tick()
    return m


class TestAggregator:
    def test_counters_and_stages_sum_exactly(self, tmp_path):
        clock = lambda: 50.0  # noqa: E731
        _write_process(tmp_path, clock, pid=1, decode=(10, 100, 0.5),
                       counters=[("read.stalls", 3)])
        _write_process(tmp_path, clock, pid=2, decode=(20, 300, 1.5),
                       counters=[("read.stalls", 4), ("read.hedges", 1)])
        _write_process(tmp_path, clock, pid=3, decode=(5, 50, 0.25))
        snap = TelemetryAggregator(str(tmp_path), clock=clock).aggregate()
        assert len(snap.processes) == 3 and not snap.dead
        assert snap.counters["read.stalls"] == 7 and snap.counters["read.hedges"] == 1
        assert snap.stages["decode"][:2] == [35, 450]
        assert snap.stages["decode"][3] == pytest.approx(2.25)

    def test_histograms_merge_bucket_exactly(self, tmp_path):
        rng = random.Random(11)
        clock = lambda: 10.0  # noqa: E731
        all_obs = []
        for pid in (1, 2, 3):
            obs = [rng.uniform(1e-5, 2.0) for _ in range(100)]
            all_obs.extend(obs)
            _write_process(tmp_path, clock, pid=pid, latencies=obs)
        reference = Histogram()
        for v in all_obs:
            reference.observe(v)
        snap = TelemetryAggregator(str(tmp_path), clock=clock).aggregate()
        assert snap.hists["decode"].counts == reference.counts
        mq, rq = snap.quantiles()["decode"], reference.quantiles()
        assert mq.pop("mean_s") == pytest.approx(rq.pop("mean_s"))
        assert mq == rq

    def test_stale_heartbeat_flags_dead(self, tmp_path):
        now = [1000.0]
        clock = lambda: now[0]  # noqa: E731
        _write_process(tmp_path, clock, pid=1, interval=1.0)
        now[0] = 1001.0
        _write_process(tmp_path, clock, pid=2, interval=1.0)
        agg = TelemetryAggregator(str(tmp_path), clock=clock)
        assert not agg.aggregate().dead
        now[0] = 1002.0  # pid 1 at exactly the 2x bar: still alive
        assert not agg.aggregate().dead
        now[0] = 1002.5
        snap = agg.aggregate()
        assert [p.pid for p in snap.dead] == [1] and [p.pid for p in snap.alive] == [2]
        assert snap.stages["decode"][0] == 20
        snap = TelemetryAggregator(str(tmp_path), stale_after_s=10.0, clock=clock).aggregate()
        assert not snap.dead

    def test_cluster_verdict_from_alive_occupancy(self, tmp_path):
        now = [10.0]
        clock = lambda: now[0]  # noqa: E731
        _write_process(tmp_path, clock, pid=1, occupancy=0.9)
        _write_process(tmp_path, clock, pid=2, occupancy=0.8)
        snap = TelemetryAggregator(str(tmp_path), clock=clock).aggregate()
        assert snap.occupancy == pytest.approx(0.85) and snap.verdict == "consumer_bound"
        now[0] = 100.0
        _write_process(tmp_path, clock, pid=3, occupancy=0.0)
        snap = TelemetryAggregator(str(tmp_path), clock=clock).aggregate()
        assert [p.pid for p in snap.alive] == [3]
        assert snap.occupancy == pytest.approx(0.0) and snap.verdict == "producer_bound"

    def test_corrupt_hist_state_loses_stage_not_fleet(self, tmp_path):
        clock = lambda: 10.0  # noqa: E731
        _write_process(tmp_path, clock, pid=1, latencies=[0.01, 0.02])
        _write_process(tmp_path, clock, pid=2, latencies=[0.03])
        spool_file = os.path.join(tmp_path, f"testhost-2{fleet.SPOOL_SUFFIX}")
        obj = json.loads(open(spool_file).read().splitlines()[-1])
        obj["hists"]["decode"]["layout"] = [1e-7, 0.5, 72]
        with open(spool_file, "w") as fh:
            fh.write(json.dumps(obj) + "\n")
        snap = TelemetryAggregator(str(tmp_path), clock=clock).aggregate()
        assert len(snap.processes) == 2
        assert snap.hists["decode"].count == 2
        assert snap.stages["decode"][0] == 20

    def test_empty_dir_and_unreadable_dir(self, tmp_path):
        snap = TelemetryAggregator(str(tmp_path), clock=lambda: 0.0).aggregate()
        assert snap.processes == [] and snap.verdict == "unknown"
        with pytest.raises(OSError):
            TelemetryAggregator(str(tmp_path / "missing"), clock=lambda: 0.0).processes()

    def test_roles_filter(self, tmp_path):
        clock = lambda: 10.0  # noqa: E731
        _write_process(tmp_path, clock, pid=1, role="trainer", occupancy=0.1)
        _write_process(tmp_path, clock, pid=2, role="reader", occupancy=0.9)
        agg = TelemetryAggregator(str(tmp_path), clock=clock)
        assert [p.pid for p in agg.processes(roles=["trainer"])] == [1]
        snap = agg.aggregate(roles=["reader"])
        assert [p.pid for p in snap.processes] == [2]
        assert snap.stages["decode"][0] == 10 and snap.verdict == "consumer_bound"

    def test_federated_page_parses_with_official_parser(self, tmp_path):
        parser = pytest.importorskip("prometheus_client.parser")
        clock = lambda: 10.0  # noqa: E731
        _write_process(tmp_path, clock, pid=1, role="reader", decode=(10, 100, 0.5),
                       latencies=[0.01, 0.02], occupancy=0.4, counters=[("read.stalls", 2)])
        _write_process(tmp_path, clock, pid=2, role="trainer", decode=(20, 200, 1.0),
                       latencies=[0.03])
        agg = TelemetryAggregator(str(tmp_path), clock=clock)
        families = {f.name: f for f in parser.text_string_to_metric_families(agg.prometheus_text())}
        by_pid = {s.labels["pid"]: s for s in families["tfrecord_process_up"].samples}
        assert set(by_pid) == {"1", "2"}
        assert by_pid["1"].labels["role"] == "reader" and by_pid["1"].labels["host"] == "testhost"
        assert all(s.value == 1.0 for s in by_pid.values())
        recs = families["tfrecord_stage_records"]
        decode = {s.labels["pid"]: s.value for s in recs.samples if s.labels["stage"] == "decode"}
        assert decode == {"1": 10.0, "2": 20.0}
        stalls = [s for s in recs.samples if s.labels["stage"] == "read.stalls"]
        assert stalls and stalls[0].value == 2.0
        lat = families["tfrecord_fleet_latency_seconds"]
        cnt = [s for s in lat.samples if s.name.endswith("_count")]
        assert cnt and cnt[0].value == 3.0

    def test_federated_http_endpoint(self, tmp_path):
        import urllib.request

        _write_process(tmp_path, lambda: 10.0, pid=1)
        agg = TelemetryAggregator(str(tmp_path), clock=lambda: 10.0)
        server = agg.serve(0)
        try:
            host, port = telemetry.exporter_address(0)
            assert port == server.server_address[1]
            body = urllib.request.urlopen(f"http://{host}:{port}/metrics", timeout=5).read()
            assert body.decode() == agg.prometheus_text()
        finally:
            telemetry.shutdown_exporter(0)

    def test_serve_refuses_port_already_serving_other_kind(self, tmp_path):
        _write_process(tmp_path, lambda: 10.0, pid=1)
        exporter = telemetry.ensure_exporter(0, metrics=Metrics())
        assert exporter is not None
        try:
            agg = TelemetryAggregator(str(tmp_path), clock=lambda: 10.0)
            assert agg.serve(0) is None
        finally:
            telemetry.shutdown_exporter(0)

    def test_clean_shutdown_never_flagged_dead(self, tmp_path):
        now = [1000.0]
        clock = lambda: now[0]  # noqa: E731
        m1 = Metrics()
        m1.add("decode", records=10, nbytes=100, seconds=0.5)
        sp1 = _spool(tmp_path, m1, clock, pid=1)
        sp1.tick()
        sp1.stop(final=True)
        m2 = Metrics()
        m2.add("decode", records=20, nbytes=200, seconds=1.0)
        _spool(tmp_path, m2, clock, pid=2).tick()
        now[0] = 2000.0
        snap = TelemetryAggregator(str(tmp_path), clock=clock).aggregate()
        assert [p.pid for p in snap.alive] == [1] and snap.alive[0].final
        assert [p.pid for p in snap.dead] == [2]
        assert snap.stages["decode"][0] == 30

    def test_finished_process_occupancy_excluded_while_any_run(self, tmp_path):
        clock = lambda: 100.0  # noqa: E731
        m1 = Metrics()
        m1.add("decode", records=1, nbytes=1, seconds=0.1)
        m1.gauge(telemetry.OCCUPANCY_GAUGE, 1.0)
        sp1 = _spool(tmp_path, m1, clock, pid=1)
        sp1.tick()
        sp1.stop(final=True)
        m2 = Metrics()
        m2.add("decode", records=1, nbytes=1, seconds=0.1)
        m2.gauge(telemetry.OCCUPANCY_GAUGE, 0.1)
        sp2 = _spool(tmp_path, m2, clock, pid=2)
        sp2.tick()
        snap = TelemetryAggregator(str(tmp_path), clock=clock).aggregate()
        assert snap.occupancy == pytest.approx(0.1) and snap.verdict == "producer_bound"
        sp2.stop(final=True)
        snap = TelemetryAggregator(str(tmp_path), clock=clock).aggregate()
        assert snap.occupancy == pytest.approx(0.55)

    def test_trace_id_scopes_reused_spool_dir(self, tmp_path):
        clock = lambda: 10.0  # noqa: E731
        _write_process(tmp_path, clock, pid=1)
        stale = json.dumps({
            "event": "spool", "v": 1, "seq": 7, "ts": 1.0, "interval_s": 1.0,
            "job": {"host": "old", "pid": 1, "role": "r", "heartbeat": 1.0,
                    "trace_id": "previousrun00000"},
            "counters": {}, "stages": {"decode": [99, 0, 0, 1.0]}, "gauges": {}, "hists": {},
        })
        (tmp_path / f"old-1{fleet.SPOOL_SUFFIX}").write_text(stale + "\n")
        assert TelemetryAggregator(str(tmp_path), clock=clock).aggregate().stages["decode"][0] == 109
        scoped = TelemetryAggregator(str(tmp_path), clock=clock, trace_id="t" * 16).aggregate()
        assert [p.pid for p in scoped.processes] == [1]
        assert scoped.stages["decode"][0] == 10

    def test_snapshot_carries_spool_start_for_wall_throughput(self, tmp_path):
        now = [100.0]
        m = Metrics()
        m.add("decode", records=50, nbytes=0, seconds=7.5)
        sp = _spool(tmp_path, m, lambda: now[0])
        now[0] = 105.0
        sp.tick()
        snap = read_spool(sp.path)
        assert snap.created == pytest.approx(100.0) and snap.heartbeat == pytest.approx(105.0)
        sp.stop(final=True)
        now[0] = 200.0
        sp2 = _spool(tmp_path, m, lambda: now[0])
        sp2.tick()
        assert read_spool(sp2.path).created == pytest.approx(100.0)
        m.reset()  # a registry reset restarts the window with the totals
        now[0] = 300.0
        sp3 = _spool(tmp_path, m, lambda: now[0])
        sp3.tick()
        assert read_spool(sp3.path).created == pytest.approx(300.0)

    def test_malformed_line_skipped_not_fatal(self, tmp_path):
        clock = lambda: 10.0  # noqa: E731
        _write_process(tmp_path, clock, pid=1, decode=(10, 100, 0.5))
        bad_file = tmp_path / f"evil-9{fleet.SPOOL_SUFFIX}"
        good = json.dumps({
            "event": "spool", "v": 1, "seq": 1, "ts": 10.0, "interval_s": 1.0,
            "job": {"host": "h", "pid": 9, "role": "r", "heartbeat": 10.0},
            "counters": {}, "stages": {"decode": [5, 50, 0, 0.25]}, "gauges": {}, "hists": {},
        })
        for bad in ('{"event": "spool", "seq": 2, "job": {"pid": "abc"}}',
                    '{"event": "spool", "seq": 3, "job": {"heartbeat": "x"}}',
                    '{"event": "spool", "seq": 4, "stages": {"decode": [1]}}',
                    '{"event": "spool", "seq": 5, "counters": {"c": "NaNope"}}'):
            bad_file.write_text(good + "\n" + bad + "\n")
            snap = TelemetryAggregator(str(tmp_path), clock=clock).aggregate()
            assert {p.pid for p in snap.processes} == {1, 9}, bad
            nine = [p for p in snap.processes if p.pid == 9][0]
            assert nine.seq == 1 and nine.skipped_lines == 1, bad
            assert snap.stages["decode"][0] == 15, bad

    def test_label_values_escaped_on_federated_page(self, tmp_path):
        parser = pytest.importorskip("prometheus_client.parser")
        _write_process(tmp_path, lambda: 10.0, pid=1, role='w"1\\x\ny')
        agg = TelemetryAggregator(str(tmp_path), clock=lambda: 10.0)
        families = {f.name: f for f in parser.text_string_to_metric_families(agg.prometheus_text())}
        assert families["tfrecord_process_up"].samples[0].labels["role"] == 'w"1\\x\ny'

    def test_acquire_spool_mismatched_join_warns(self, tmp_path, caplog):
        import logging

        d = str(tmp_path / "sp")
        fleet.acquire_spool(d, role="a", interval_s=30.0)
        try:
            with caplog.at_level(logging.WARNING, logger="tpu_tfrecord_torch"):
                sp = fleet.acquire_spool(d, role="b", interval_s=0.5)
            assert sp.interval_s == 30.0 and sp.context.role == "a"
            msgs = " ".join(r.message for r in caplog.records)
            assert "interval" in msgs and "role" in msgs
        finally:
            fleet.release_spool(d)
            fleet.release_spool(d)

    def test_quantiles_ms_and_train_phase_shares(self, tmp_path):
        """The doctor's per-process readers, against the JAX ones."""
        jfleet, _, _ = _jax()
        m = Metrics()
        for v in (0.01, 0.02, 0.5):
            m.observe("serve.latency", v)
        m.add("train.data_wait", seconds=1.0)
        m.add("train.compute", seconds=3.0)
        sp = _spool(tmp_path, m, lambda: 1.0, role="trainer")
        sp.tick()
        mine, theirs = read_spool(sp.path), jfleet.read_spool(sp.path)
        assert fleet.quantiles_ms_from_states(mine.hists) == \
            jfleet.quantiles_ms_from_states(theirs.hists)
        shares = fleet.train_phase_shares(mine)
        assert shares == jfleet.train_phase_shares(theirs) == {"data_wait": 0.25,
                                                               "compute": 0.75}
        m.gauge("train.share.compute", 0.9)
        m.gauge("train.share.data_wait", 0.1)
        sp.tick()
        assert fleet.train_phase_shares(read_spool(sp.path)) == {"data_wait": 0.1,
                                                                 "compute": 0.9}
        m2 = Metrics()
        m2.add("decode", records=1, seconds=0.1)
        sp2 = _spool(tmp_path, m2, lambda: 1.0, pid=99)
        sp2.tick()
        assert fleet.train_phase_shares(read_spool(sp2.path)) is None


# ---------------------------------------------------------------------------
# Cross-package: either aggregator reads either package's spool
# ---------------------------------------------------------------------------


def _fleet_dir(tmp_path, writers, seed=5):
    """A spool dir of three processes; ``writers`` names the package that
    writes each one ("port" / "jax"). Returns the clock's time."""
    jfleet, jtel, JMetrics = _jax()
    rng = random.Random(seed)
    for pid, who in enumerate(writers, 1):
        pkg, tel, M = (fleet, telemetry, Metrics) if who == "port" else (jfleet, jtel, JMetrics)
        m = M()
        m.add("decode", records=10 * pid, nbytes=100 * pid, seconds=0.5 * pid)
        m.count("serve.requests", 50 * pid)
        m.count("serve.rejected", pid)
        m.count("serve.deadline_expired", pid - 1)
        for _ in range(60):
            m.observe("serve.latency", rng.uniform(1e-4, 0.6),
                      exemplar=("t" * 16, f"s{pid}{rng.randrange(9)}"))
        m.gauge(telemetry.OCCUPANCY_GAUGE, 0.3 * pid)
        clock = [10.0 * pid]
        sp = _spool(tmp_path, m, lambda: clock[0], role=f"r{pid}", pid=pid, pkg=pkg, tel=tel)
        sp.tick()
        m.count("serve.requests", 7)
        clock[0] += 0.5
        if pid == 1:
            sp.stop(final=True)
        else:
            sp.tick()
    return 31.0


def _picture(snap):
    return (snap.counters, snap.stages, [p.pid for p in snap.alive], [p.pid for p in snap.dead],
            snap.quantiles(), {n: h.counts for n, h in snap.hists.items()},
            {n: h.exemplars for n, h in snap.hists.items()}, snap.verdict, snap.occupancy)


@pytest.mark.parametrize("writers", [("port",) * 3, ("jax",) * 3, ("port", "jax", "port")],
                         ids=["port_dir", "jax_dir", "mixed_dir"])
class TestCrossPackage:
    def test_aggregates_equal(self, tmp_path, writers):
        jfleet, _, _ = _jax()
        now = _fleet_dir(tmp_path, writers)
        mine = TelemetryAggregator(str(tmp_path), clock=lambda: now).aggregate()
        theirs = jfleet.TelemetryAggregator(str(tmp_path), clock=lambda: now).aggregate()
        assert _picture(mine) == _picture(theirs)
        assert [p.pid for p in mine.dead] == [2]  # 30.5 is 0.5 s past its 2 s bar
        assert mine.counters["serve.requests"] == 57 + 107 + 157

    def test_federated_page_byte_equal(self, tmp_path, writers):
        jfleet, _, _ = _jax()
        now = _fleet_dir(tmp_path, writers)
        page = TelemetryAggregator(str(tmp_path), clock=lambda: now).prometheus_text()
        assert page == jfleet.TelemetryAggregator(str(tmp_path),
                                                  clock=lambda: now).prometheus_text()
        assert 'role="r1"' in page and "tfrecord_fleet_latency_exemplar_seconds" in page

    def test_history_and_trace_filter_equal(self, tmp_path, writers):
        jfleet, _, _ = _jax()
        _fleet_dir(tmp_path, writers)
        for name in sorted(os.listdir(tmp_path)):
            path = str(tmp_path / name)
            mine = [(s.seq, s.heartbeat, s.counters, s.final)
                    for s in fleet.read_spool_history(path)]
            assert mine == [(s.seq, s.heartbeat, s.counters, s.final)
                            for s in jfleet.read_spool_history(path)]
        assert TelemetryAggregator(str(tmp_path), trace_id="nope").processes() == []
        assert len(TelemetryAggregator(str(tmp_path), trace_id="t" * 16).processes()) == 3


def test_doctor_fleet_reads_a_port_dir(tmp_path):
    """``tfrecord_doctor fleet`` (the JAX package's tool) on a port-written
    spool dir exits 0 and reports the port's numbers."""
    now = _fleet_dir(tmp_path, ("port",) * 3)
    snap = TelemetryAggregator(str(tmp_path), stale_after_s=3600.0).aggregate()
    proc = subprocess.run([sys.executable, DOCTOR, "fleet", str(tmp_path), "--stale-after",
                           "3600"], capture_output=True, text=True, timeout=WORKER_TIMEOUT_S,
                          env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert proc.returncode == 0, (proc.stdout, proc.stderr)
    lines = [json.loads(ln) for ln in proc.stdout.splitlines() if ln.strip()]
    (fleet_line,) = [ln for ln in lines if ln["event"] == "fleet"]
    # on the real clock the fake-clock heartbeats are ancient: only the
    # process that said goodbye (pid 1) is alive, in both readings
    assert fleet_line["processes"] == 3 and now > 0
    assert fleet_line["alive"] == len(snap.alive) == 1 and snap.alive[0].final
    assert sorted(d["role"] for d in fleet_line["dead"]) == sorted(p.role for p in snap.dead) \
        == ["r2", "r3"]
    assert fleet_line["counters"] == snap.counters
    assert fleet_line["stages"]["decode"]["records"] == snap.stages["decode"][0] == 60
    assert fleet_line["trace_ids"] == ["t" * 16]
    assert sorted(ln["role"] for ln in lines if ln["event"] == "proc") == ["r1", "r2", "r3"]


# ---------------------------------------------------------------------------
# Options plumbing and the dataset's spool
# ---------------------------------------------------------------------------


class TestOptions:
    def test_defaults_off(self):
        from tpu_tfrecord_torch.options import TFRecordOptions

        o = TFRecordOptions.from_map()
        assert (o.telemetry_spool_dir, o.spool_interval_s, o.telemetry_role) == (None, None, None)

    def test_parsing_and_validation(self, tmp_path):
        from tpu_tfrecord.options import TFRecordOptions as JOptions
        from tpu_tfrecord_torch.options import TFRecordOptions

        kw = dict(telemetry_spool_dir=tmp_path, spool_interval_s=0.5,
                  telemetry_role="decode_worker")
        o, j = TFRecordOptions.from_map(**kw), JOptions.from_map(**kw)
        assert o.telemetry_spool_dir == j.telemetry_spool_dir == str(tmp_path)
        assert o.spool_interval_s == 0.5 and o.telemetry_role == "decode_worker"
        camel = TFRecordOptions.from_map(telemetrySpoolDir=str(tmp_path), spoolIntervalS="2",
                                         telemetryRole="t")
        assert camel.spool_interval_s == 2.0 and camel.telemetry_role == "t"
        with pytest.raises(ValueError, match="spool_interval_s"):
            TFRecordOptions.from_map(spool_interval_s=0)
        with pytest.raises(ValueError, match="telemetry_role"):
            TFRecordOptions.from_map(telemetry_role="")

    def test_dataset_scheme_spool_dir_rejected(self, tmp_path):
        from tpu_tfrecord_torch.io.dataset import TFRecordDataset

        data = write_dataset(tmp_path / "ds", n_shards=1, rows_per_shard=4)
        ds = TFRecordDataset(data, batch_size=4, schema=SCHEMA, num_epochs=1,
                             drop_remainder=False, telemetry_spool_dir="gs://bucket/spool")
        with pytest.raises(ValueError, match="local path"):
            with ds.batches():
                pass
        assert not fleet._SPOOLS

    def test_dataset_spools_while_iterating(self, tmp_path):
        from tpu_tfrecord_torch.io.dataset import TFRecordDataset

        data = write_dataset(tmp_path / "ds", n_shards=2, rows_per_shard=30)
        spool_dir = str(tmp_path / "spool")
        ds = TFRecordDataset(data, batch_size=16, schema=SCHEMA, num_epochs=1,
                             drop_remainder=False, telemetry_spool_dir=spool_dir,
                             spool_interval_s=0.05, telemetry_role="reader")
        rows = 0
        with ds.batches() as it:
            assert (spool_dir, ) == tuple(fleet._SPOOLS)
            for cb in it:
                rows += cb.num_rows
        assert rows == 60
        snaps = TelemetryAggregator(spool_dir).processes()
        assert len(snaps) == 1 and snaps[0].role == "reader" and snaps[0].final
        assert snaps[0].stages["decode"][0] == 60
        assert not fleet._SPOOLS

    def test_dataset_and_trainer_share_one_spool(self, tmp_path, monkeypatch):
        """The dataset and the trainer hold the same dir at once: one spool,
        released once on each path (the close and the collection of an
        abandoned iterator), the final snapshot after the last."""
        from tpu_tfrecord_torch import harness
        from tpu_tfrecord_torch.io.dataset import TFRecordDataset

        data = write_dataset(tmp_path / "ds", n_shards=1, rows_per_shard=8)
        spool_dir = str(tmp_path / "spool")
        monkeypatch.setenv("TFR_TRAIN_SPOOL_DIR", spool_dir)
        trainer = harness.trainer_spool(interval_s=60.0)
        ds = TFRecordDataset(data, batch_size=4, schema=SCHEMA, num_epochs=1,
                             telemetry_spool_dir=spool_dir)
        it = ds.batches()
        assert fleet._SPOOLS[spool_dir] == (trainer, 2)
        next(it)
        del it  # abandoned: the finalizer releases its reference
        import gc

        gc.collect()
        assert fleet._SPOOLS[spool_dir] == (trainer, 1)
        with ds.batches() as it2:
            assert fleet._SPOOLS[spool_dir] == (trainer, 2)
            list(it2)
        it2.close()  # a second close releases nothing
        assert fleet._SPOOLS[spool_dir] == (trainer, 1)
        assert read_spool(trainer.path) is None or not read_spool(trainer.path).final
        harness.release_trainer_spool(trainer)
        snap = read_spool(trainer.path)
        assert snap.final and snap.role == "trainer" and not fleet._SPOOLS


# ---------------------------------------------------------------------------
# Multi-process integration: three spooling port readers
# ---------------------------------------------------------------------------


def _spawn_reader(data, spool_dir, role, linger, env, interval=0.2):
    spec = {"data": data, "spool": spool_dir, "role": role, "linger": linger,
            "interval": interval}
    return subprocess.Popen([sys.executable, os.path.abspath(__file__), "worker",
                             json.dumps(spec)], cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


@pytest.fixture(scope="module")
def three_readers(tmp_path_factory):
    """Three port readers spool into one dir under one parent trace; two
    finish, the third lingers heartbeating and is SIGKILLed once the
    spool shows it alive with its reads done."""
    _reset_globals()
    base = tmp_path_factory.mktemp("fleet3")
    data = write_dataset(base / "ds", n_shards=3, rows_per_shard=40)
    spool_dir = str(base / "spool")
    os.makedirs(spool_dir)
    parent = TraceContext.new(role="test_parent")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1", **parent.to_env())
    procs = [_spawn_reader(data, spool_dir, f"reader{i}", 0.0, env) for i in range(2)]
    victim = _spawn_reader(data, spool_dir, "victim", 120.0, env)
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=WORKER_TIMEOUT_S)
            assert p.returncode == 0, err[-3000:]
            outs.append(json.loads(out.splitlines()[-1]))
        line = victim.stdout.readline()  # printed after its reads, before lingering
        assert line, victim.stderr.read()[-3000:] if victim.poll() is not None else "no line"
        victim_out = json.loads(line)
        deadline = time.time() + WORKER_TIMEOUT_S
        while time.time() < deadline:
            snap = read_spool(victim_out["spool_path"])
            if snap is not None and snap.stages.get("decode", [0])[0] == victim_out["decode"]:
                break
            time.sleep(0.05)
        else:
            pytest.fail("the victim's spool never showed its reads")
        victim.send_signal(signal.SIGKILL)
        victim.wait(timeout=30)
    finally:
        for p in procs + [victim]:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
            p.stdout.close()
            p.stderr.close()
    killed_at = time.time()
    return {"spool": spool_dir, "outs": outs, "victim": victim_out, "parent": parent,
            "killed_at": killed_at}


class TestFleetIntegration:
    def test_three_workers_aggregate_exactly(self, three_readers):
        r = three_readers
        workers = r["outs"] + [r["victim"]]
        assert all(o["rows"] == 240 for o in workers)
        assert {o["trace_id"] for o in workers} == {r["parent"].trace_id}
        assert {o["parent_span_id"] for o in workers} == {r["parent"].span_id}
        snap = TelemetryAggregator(r["spool"]).aggregate()
        assert sorted(p.pid for p in snap.processes) == sorted(o["pid"] for o in workers)
        assert sorted(p.role for p in snap.processes) == ["reader0", "reader1", "victim"]
        newest = [read_spool(o["spool_path"]) for o in workers]
        assert snap.stages["decode"][0] == sum(o["decode"] for o in workers) == 720
        for name in snap.counters:
            assert snap.counters[name] == sum(s.counters.get(name, 0) for s in newest), name
        for name, h in snap.hists.items():
            want = Histogram.from_states([s.hists[name] for s in newest if name in s.hists])
            assert h.counts == want.counts, name

    def test_killed_worker_flagged_dead(self, three_readers):
        r = three_readers
        time.sleep(max(0.0, r["killed_at"] + 0.5 - time.time()))  # past 2 x 0.2 s
        snap = TelemetryAggregator(r["spool"]).aggregate()
        assert [p.pid for p in snap.dead] == [r["victim"]["pid"]]
        assert snap.dead[0].role == "victim" and not snap.dead[0].final
        assert sorted(p.pid for p in snap.alive) == sorted(o["pid"] for o in r["outs"])
        assert all(p.final for p in snap.alive)
        assert snap.dead[0].stages["decode"][0] == r["victim"]["decode"]

    def test_jax_aggregator_and_doctor_agree(self, three_readers):
        jfleet, _, _ = _jax()
        r = three_readers
        now = time.time()
        mine = TelemetryAggregator(r["spool"], clock=lambda: now).aggregate()
        theirs = jfleet.TelemetryAggregator(r["spool"], clock=lambda: now).aggregate()
        assert _picture(mine) == _picture(theirs)
        proc = subprocess.run([sys.executable, DOCTOR, "fleet", r["spool"]],
                              capture_output=True, text=True, timeout=WORKER_TIMEOUT_S,
                              env={**os.environ, "JAX_PLATFORMS": "cpu"})
        assert proc.returncode == 0, (proc.stdout, proc.stderr)
        lines = [json.loads(ln) for ln in proc.stdout.splitlines() if ln.strip()]
        (fleet_line,) = [ln for ln in lines if ln["event"] == "fleet"]
        assert fleet_line["stages"]["decode"]["records"] == 720
        assert [d["role"] for d in fleet_line["dead"]] == ["victim"]
        assert fleet_line["trace_ids"] == [r["parent"].trace_id]


def _worker(spec: dict) -> None:
    """One spooling port reader: joins the parent's trace, reads the data
    twice with the spool on, prints its identity and totals, then lingers
    heartbeating for ``linger`` seconds (an extra spool reference keeps the
    spool ticking) before a clean release."""
    from tpu_tfrecord_torch.io.dataset import TFRecordDataset

    ctx = telemetry.adopt_from_env(role=spec["role"])
    ds = TFRecordDataset(spec["data"], batch_size=16, schema=SCHEMA, drop_remainder=False,
                         num_epochs=2, telemetry_spool_dir=spec["spool"],
                         spool_interval_s=spec["interval"], telemetry_role=spec["role"])
    fleet.acquire_spool(spec["spool"], role=spec["role"], interval_s=spec["interval"])
    rows = 0
    try:
        with ds.batches() as it:
            for cb in it:
                rows += cb.num_rows
        print(json.dumps({"pid": os.getpid(), "role": ctx.role, "trace_id": ctx.trace_id,
                          "parent_span_id": ctx.parent_span_id, "rows": rows,
                          "decode": METRICS.stage("decode").records,
                          "spool_path": fleet.spool_path(os.path.abspath(spec["spool"]), ctx)}),
              flush=True)
        deadline = time.time() + spec["linger"]
        while time.time() < deadline:
            time.sleep(0.02)
    finally:
        fleet.release_spool(spec["spool"])


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "worker":
        _worker(json.loads(sys.argv[2]))
