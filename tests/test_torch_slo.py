"""The port's SLO engine and histogram exemplars against the JAX package's.

Twins of ``tests/test_slo.py`` on ``tpu_tfrecord_torch``: exemplars ride
``Histogram.state`` / ``merge_state`` without perturbing bucket counts;
objectives parse and count bucket-exactly; an alert fires only when both
windows of a pair burn past the threshold, on a fake clock; the spool
replay (``fleet_samples``) sums counters and merges histograms per
heartbeat, scoped by trace id. Cross-package: ``fleet_samples`` and
``engine_from_spool(...).evaluate()`` agree with the JAX package's on
port-written, JAX-written and mixed spool directories under one fake
clock, and the repo's ``tfrecord_doctor slo`` / ``merge-trace`` read what
the port wrote.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(1)

from tpu_tfrecord_torch import fleet  # noqa: E402
from tpu_tfrecord_torch.metrics import Histogram, Metrics  # noqa: E402
from tpu_tfrecord_torch.slo import (  # noqa: E402
    DEFAULT_OBJECTIVES,
    DEFAULT_WINDOWS,
    BurnWindow,
    Objective,
    SloEngine,
    burn_rate,
    engine_from_spool,
    fleet_samples,
)
from tpu_tfrecord_torch.telemetry import SpanRecorder, TraceContext  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DOCTOR = os.path.join(REPO, "tools", "tfrecord_doctor.py")

#: bucket_index is an instance method (class-level layout), shared here
_bidx = Histogram().bucket_index


# ---------------------------------------------------------------------------
# Histogram exemplars
# ---------------------------------------------------------------------------


class TestHistogramExemplars:
    def test_observe_attaches_exemplar_to_the_value_bucket(self):
        h = Histogram()
        h.observe(0.25, exemplar=("t1", "s1"))
        idx = _bidx(0.25)
        assert h.exemplars[idx] == ("t1", "s1", 0.25)
        # untagged observations never create exemplars
        h.observe(0.5)
        assert len(h.exemplars) == 1

    def test_exemplar_at_tail_is_the_slow_request(self):
        h = Histogram()
        for _ in range(95):
            h.observe(0.010, exemplar=("tfast", "sfast"))
        for _ in range(5):
            h.observe(2.0, exemplar=("tslow", "sslow"))
        ex = h.exemplar_at(0.99)
        assert ex is not None
        assert ex["trace_id"] == "tslow" and ex["span_id"] == "sslow"
        assert ex["value"] == 2.0
        assert ex["bucket"] == _bidx(2.0)

    def test_exemplar_at_none_when_untagged(self):
        h = Histogram()
        h.observe(0.1)
        assert h.exemplar_at(0.99) is None
        assert Histogram().exemplar_at(0.99) is None

    def test_state_omits_exemplars_key_when_empty(self):
        """Byte compat: an exemplar-free histogram serializes exactly as
        it did before exemplars existed."""
        tagged, plain = Histogram(), Histogram()
        tagged.observe(0.1)
        plain.observe(0.1)
        assert "exemplars" not in plain.state()
        assert json.dumps(tagged.state(), sort_keys=True) == json.dumps(
            plain.state(), sort_keys=True
        )
        tagged.observe(0.2, exemplar=("t", "s"))
        assert "exemplars" in tagged.state()

    def test_merge_state_round_trips_exemplars_last_wins(self):
        a, b = Histogram(), Histogram()
        a.observe(0.1, exemplar=("ta", "sa"))
        b.observe(0.1, exemplar=("tb", "sb"))
        b.observe(3.0, exemplar=("tb2", "sb2"))
        merged = Histogram.from_states([a.state(), b.state()])
        idx = _bidx(0.1)
        # later state wins the shared bucket; b's tail bucket rides along
        assert merged.exemplars[idx] == ("tb", "sb", 0.1)
        assert merged.exemplars[_bidx(3.0)][0] == "tb2"
        # exemplars never perturb the merged counts/quantiles
        bare = Histogram.from_states(
            [{k: v for k, v in st.items() if k != "exemplars"}
             for st in (a.state(), b.state())]
        )
        assert merged.counts == bare.counts
        assert merged.count == bare.count == 3

    def test_merge_state_rejects_malformed_exemplars(self):
        h = Histogram()
        with pytest.raises(ValueError, match="exemplar bucket"):
            h.merge_state(
                {"buckets": {}, "count": 0, "total": 0.0,
                 "exemplars": {"99999": ["t", "s", 1.0]}}
            )
        with pytest.raises(TypeError, match="exemplars"):
            h.merge_state(
                {"buckets": {}, "count": 0, "total": 0.0, "exemplars": [1]}
            )

    def test_bucket_le_is_the_inclusive_upper_bound(self):
        for v in (1e-6, 0.001, 0.05, 0.25, 1.0, 30.0):
            idx = _bidx(v)
            assert v <= Histogram.bucket_le(idx) * (1 + 1e-12)
            if idx > 0:
                assert v > Histogram.bucket_le(idx - 1)


# ---------------------------------------------------------------------------
# Objectives
# ---------------------------------------------------------------------------


class TestObjective:
    def test_parse_round_trips_spec(self):
        a = Objective.parse("availability:0.999")
        assert (a.kind, a.target) == ("availability", 0.999)
        assert Objective.parse(a.spec) == a
        l = Objective.parse("latency:0.95:250")
        assert (l.kind, l.target, l.latency_ms) == ("latency", 0.95, 250.0)
        assert Objective.parse(l.spec) == l

    @pytest.mark.parametrize(
        "spec",
        ["availability", "availability:2", "latency:0.95", "bogus:0.9",
         "latency:0.95:abc", "latency:0.95:-1", ""],
    )
    def test_parse_rejects_bad_specs(self, spec):
        with pytest.raises(ValueError):
            Objective.parse(spec)

    def test_availability_bad_total_counts_sheds_and_misses(self):
        obj = Objective(kind="availability", target=0.999)
        counters = {
            "serve.requests": 97, "serve.rejected": 2,
            "serve.deadline_expired": 1,
        }
        assert obj.bad_total(counters, {}) == (3, 100)
        assert obj.bad_total({}, {}) == (0, 0)

    def test_latency_bad_total_is_bucket_exact_and_never_flatters(self):
        h = Histogram()
        for _ in range(9):
            h.observe(0.100)  # bucket upper bound well under 250 ms
        h.observe(1.0)
        obj = Objective(kind="latency", target=0.9, latency_ms=250.0)
        # accepts a live Histogram and its state() dict identically
        assert obj.bad_total({}, {"serve.latency": h}) == (1, 10)
        assert obj.bad_total({}, {"serve.latency": h.state()}) == (1, 10)
        # a value whose BUCKET straddles the target counts as bad: the
        # bucket's upper bound exceeds the limit, so it cannot be "good"
        edge = Histogram()
        edge.observe(0.249)
        bad, total = obj.bad_total({}, {"serve.latency": edge})
        assert total == 1
        assert bad == (
            0 if Histogram.bucket_le(_bidx(0.249)) <= 0.25
            else 1
        )

    def test_latency_bad_total_missing_stage_is_no_traffic(self):
        obj = Objective(kind="latency", target=0.95, latency_ms=250.0)
        assert obj.bad_total({}, {}) == (0, 0)


# ---------------------------------------------------------------------------
# Burn-rate engine
# ---------------------------------------------------------------------------

#: Seconds-scale copies of the default pair (same thresholds under pin).
FAST = BurnWindow("fast", long_s=60.0, short_s=5.0, threshold=14.4)
SLOW = BurnWindow("slow", long_s=360.0, short_s=30.0, threshold=6.0)


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


class TestSloEngine:
    def test_burn_rate_math(self):
        assert burn_rate(0, 0, 0.999) == 0.0  # idle window burns nothing
        assert burn_rate(1, 1000, 0.999) == pytest.approx(1.0)
        assert burn_rate(144, 10000, 0.999) == pytest.approx(14.4)

    def test_scaled_keeps_threshold(self):
        w = DEFAULT_WINDOWS[0].scaled(1.0 / 60.0)
        assert (w.long_s, w.short_s) == (60.0, 5.0)
        assert w.threshold == DEFAULT_WINDOWS[0].threshold == 14.4

    def test_no_data_verdict(self):
        eng = SloEngine(windows=(FAST, SLOW), clock=FakeClock())
        report = eng.evaluate()
        assert report["verdict"] == "no_data" and report["objectives"] == []

    def test_healthy_to_fast_burn_under_shed_storm(self):
        """THE flip: clean traffic reads healthy with a full budget; a
        shed storm inside both fast windows pages — all on a fake clock."""
        clock = FakeClock()
        eng = SloEngine(
            objectives=(Objective(kind="availability", target=0.999),),
            windows=(FAST, SLOW), clock=clock,
        )
        eng.observe({"serve.requests": 0}, ts=0.0)
        eng.observe({"serve.requests": 10000}, ts=100.0)
        healthy = eng.evaluate(now=100.0)
        assert healthy["verdict"] == "healthy"
        obj = healthy["objectives"][0]
        assert obj["budget_remaining"] == pytest.approx(1.0)
        assert not any(w["alerting"] for w in obj["windows"])
        # storm: 1000 sheds in two seconds
        eng.observe(
            {"serve.requests": 10000, "serve.rejected": 500}, ts=101.0
        )
        eng.observe(
            {"serve.requests": 10000, "serve.rejected": 1000}, ts=102.0
        )
        burning = eng.evaluate(now=102.0)
        assert burning["verdict"] == "fast_burn"
        obj = burning["objectives"][0]
        assert obj["verdict"] == "fast_burn"
        fast = next(w for w in obj["windows"] if w["name"] == "fast")
        assert fast["alerting"]
        assert fast["long_burn"] >= 14.4 and fast["short_burn"] >= 14.4
        assert obj["budget_remaining"] < 0  # budget overspent, not clamped

    def test_stale_spike_does_not_page(self):
        """Multi-window discipline: a storm that ended burns the LONG
        window but not the SHORT one — no alert (the classic reason for
        the pair)."""
        clock = FakeClock()
        eng = SloEngine(
            objectives=(Objective(kind="availability", target=0.999),),
            windows=(FAST,), clock=clock,
        )
        eng.observe({"serve.requests": 0}, ts=0.0)
        eng.observe(
            {"serve.requests": 500, "serve.rejected": 500}, ts=30.0
        )  # the old storm
        eng.observe(
            {"serve.requests": 1600, "serve.rejected": 500}, ts=52.0
        )  # clean recovery
        report = eng.evaluate(now=55.0)
        w = report["objectives"][0]["windows"][0]
        assert w["long_burn"] >= FAST.threshold  # storm visible long
        assert w["short_burn"] == 0.0           # but over short
        assert not w["alerting"]
        assert report["verdict"] == "healthy"

    def test_latency_objective_burns_from_histogram_states(self):
        clock = FakeClock()
        eng = SloEngine(
            objectives=(
                Objective(kind="latency", target=0.95, latency_ms=250.0),
            ),
            windows=(FAST, SLOW), clock=clock,
        )
        eng.observe({}, {}, ts=0.0)
        h = Histogram()
        for _ in range(100):
            h.observe(1.0)  # every request 4x over target
        eng.observe({}, {"serve.latency": h.state()}, ts=100.0)
        report = eng.evaluate(now=100.0)
        assert report["verdict"] == "fast_burn"
        assert report["objectives"][0]["bad"] == 100

    def test_out_of_order_sample_dropped(self):
        eng = SloEngine(
            objectives=(Objective(kind="availability", target=0.999),),
            windows=(FAST,), clock=FakeClock(),
        )
        eng.observe({"serve.requests": 100}, ts=10.0)
        eng.observe(
            {"serve.requests": 100, "serve.rejected": 999}, ts=5.0
        )  # stale replay: must not rewrite history
        report = eng.evaluate(now=10.0)
        assert report["objectives"][0]["bad"] == 0
        assert report["verdict"] == "healthy"

    def test_publish_lands_slo_gauges(self):
        clock = FakeClock()
        eng = SloEngine(windows=(FAST, SLOW), clock=clock)
        eng.observe({"serve.requests": 100}, ts=0.0)
        metrics = Metrics()
        report = eng.publish(metrics, now=0.0)
        gauges = metrics.gauges()
        for obj in DEFAULT_OBJECTIVES:
            assert f"slo.{obj.kind}.budget_remaining" in gauges
            assert f"slo.{obj.kind}.fast_burn" in gauges
            assert f"slo.{obj.kind}.slow_burn" in gauges
        assert report["verdict"] == "healthy"

    def test_engine_validation(self):
        with pytest.raises(ValueError, match="objective"):
            SloEngine(objectives=())
        with pytest.raises(ValueError, match="window"):
            SloEngine(windows=())


# ---------------------------------------------------------------------------
# Spool replay
# ---------------------------------------------------------------------------


def _spool_line(seq, heartbeat, counters, hists=None, trace="t" * 16, pid=1):
    return json.dumps({
        "event": "spool", "v": 1, "seq": seq, "ts": heartbeat,
        "interval_s": 1.0,
        "job": {
            "host": "h", "pid": pid, "role": "serve", "trace_id": trace,
            "heartbeat": heartbeat, "created": 0.0,
        },
        "counters": counters, "stages": {}, "gauges": {},
        "hists": hists or {},
    }, sort_keys=True)


def _port_spool(tmp_path, metrics, clock, pid=1, role="serve"):
    ctx = TraceContext(trace_id="t" * 16, span_id="s" * 16, role=role, host="h", pid=pid)
    return fleet.TelemetrySpool(str(tmp_path), role=role, interval_s=1.0, metrics=metrics,
                                context=ctx, clock=clock)


def _write_spool(tmp_path, name, lines):
    path = tmp_path / f"{name}.spool.jsonl"
    path.write_text("\n".join(lines) + "\n")
    return path


class TestFleetSamples:
    def test_series_sums_each_process_newest_line_per_heartbeat(
        self, tmp_path
    ):
        _write_spool(tmp_path, "h-1", [
            _spool_line(1, 10.0, {"serve.requests": 5}, pid=1),
            _spool_line(2, 20.0, {"serve.requests": 10}, pid=1),
        ])
        _write_spool(tmp_path, "h-2", [
            _spool_line(1, 15.0, {"serve.requests": 7}, pid=2),
        ])
        series = fleet_samples(str(tmp_path))
        assert [ts for ts, _, _ in series] == [10.0, 15.0, 20.0]
        totals = [c.get("serve.requests", 0) for _, c, _ in series]
        assert totals == [5, 12, 17]  # cumulative per process, summed

    def test_trace_id_scopes_a_reused_dir(self, tmp_path):
        _write_spool(tmp_path, "h-1", [
            _spool_line(1, 10.0, {"serve.requests": 5}, trace="a" * 16),
        ])
        _write_spool(tmp_path, "h-2", [
            _spool_line(1, 11.0, {"serve.requests": 999}, trace="b" * 16,
                        pid=2),
        ])
        series = fleet_samples(str(tmp_path), trace_id="a" * 16)
        assert len(series) == 1
        assert series[0][1]["serve.requests"] == 5

    def test_bad_hist_state_loses_the_stage_never_the_series(self, tmp_path):
        good = Histogram()
        good.observe(0.1, exemplar=("t", "s"))
        _write_spool(tmp_path, "h-1", [
            _spool_line(1, 10.0, {}, hists={"serve.latency": good.state()}),
        ])
        _write_spool(tmp_path, "h-2", [
            _spool_line(
                1, 10.0, {"serve.requests": 3},
                hists={"serve.latency": {
                    "buckets": {}, "count": 0, "total": 0.0,
                    "layout": [1.0, 1.0, 7],  # version-skewed geometry
                }},
                pid=2,
            ),
        ])
        series = fleet_samples(str(tmp_path))
        assert len(series) == 1
        ts, counters, hists = series[0]
        assert counters["serve.requests"] == 3  # bad hist didn't drop proc
        assert hists["serve.latency"].count == 1  # good state merged
        # exemplars survive the spool round trip into the merged series
        assert hists["serve.latency"].exemplar_at(0.99)["trace_id"] == "t"

    def test_unreadable_dir_raises(self, tmp_path):
        with pytest.raises(OSError):
            fleet_samples(str(tmp_path / "missing"))

    def test_engine_from_spool_none_vs_engine(self, tmp_path):
        assert engine_from_spool(str(tmp_path)) is None  # no fleet != idle
        _write_spool(tmp_path, "h-1", [
            _spool_line(1, 0.0, {"serve.requests": 0}),
            _spool_line(
                2, 100.0, {"serve.requests": 100, "serve.rejected": 400}
            ),
        ])
        eng = engine_from_spool(
            str(tmp_path),
            objectives=(Objective(kind="availability", target=0.999),),
            windows=(FAST, SLOW),
        )
        assert eng is not None
        assert eng.evaluate(now=100.0)["verdict"] == "fast_burn"


# ---------------------------------------------------------------------------
# tfrecord_doctor slo / merge-trace (subprocess)
# ---------------------------------------------------------------------------


def _doctor(*argv):
    return subprocess.run(
        [sys.executable, DOCTOR, *argv],
        capture_output=True, text=True, timeout=120,
        env={**os.environ, "JAX_PLATFORMS": "cpu"},
    )


class TestDoctorSlo:
    def _storm_spool(self, tmp_path):
        """The storm, written by the port's spool on a fake clock."""
        now = [0.0]
        m = Metrics()
        m.count("serve.requests", 0)
        sp = _port_spool(tmp_path, m, lambda: now[0])
        sp.tick()
        m.count("serve.requests", 1000)
        m.count("serve.rejected", 500)
        now[0] = 100.0
        sp.tick()

    def test_json_mirrors_text_lines_and_flags_the_burn(self, tmp_path):
        self._storm_spool(tmp_path)
        args = (
            "slo", str(tmp_path), "--objective", "availability:0.999",
            "--now", "100",
        )
        text = _doctor(*args)
        assert text.returncode == 0, (text.stdout, text.stderr)
        lines = [json.loads(l) for l in text.stdout.strip().splitlines()]
        doc = _doctor(*args, "--json")
        assert doc.returncode == 0, (doc.stdout, doc.stderr)
        assert json.loads(doc.stdout)["events"] == lines  # the round trip
        objective, summary = lines
        assert objective["event"] == "objective"
        assert objective["objective"] == "availability:0.999"
        assert objective["bad"] == 500 and objective["total"] == 1500
        fast = next(
            w for w in objective["windows"] if w["name"] == "fast"
        )
        assert fast["alerting"] and fast["threshold"] == 14.4
        assert summary["event"] == "slo"
        assert summary["verdict"] == "fast_burn"  # a finding, exit 0

    def test_no_spool_snapshots_exits_2(self, tmp_path):
        proc = _doctor("slo", str(tmp_path), "--json")
        assert proc.returncode == 2
        events = json.loads(proc.stdout)["events"]
        assert events[-1]["event"] == "error"
        assert "no spool snapshots" in events[-1]["error"]

    def test_bad_objective_spec_exits_2(self, tmp_path):
        self._storm_spool(tmp_path)
        proc = _doctor("slo", str(tmp_path), "--objective", "bogus:0.9")
        assert proc.returncode == 2
        err = json.loads(proc.stdout.strip().splitlines()[-1])
        assert err["event"] == "error" and "bogus" in err["error"]

    def test_window_scale_shrinks_windows_not_thresholds(self, tmp_path):
        # the same storm viewed through 3600x-longer windows still anchors
        # at origin, so this just pins the flag parses and reports
        self._storm_spool(tmp_path)
        proc = _doctor(
            "slo", str(tmp_path), "--objective", "availability:0.999",
            "--window-scale", "0.01", "--now", "100",
        )
        assert proc.returncode == 0, (proc.stdout, proc.stderr)
        objective = json.loads(proc.stdout.strip().splitlines()[0])
        assert {w["threshold"] for w in objective["windows"]} == {14.4, 6.0}


class TestMergeTraceDirectory:
    def test_directory_expands_to_sorted_trace_files(self, tmp_path):
        traces = tmp_path / "traces"
        traces.mkdir()
        for i, name in enumerate(["b.json", "a.json"]):
            rec = SpanRecorder(enabled=True)
            rec.context = TraceContext(trace_id="t" * 16, span_id=f"s{i}" * 4, role=f"r{i}",
                                       host="h", pid=100 + i)
            with rec.span(f"ev{i}"):
                pass
            rec.save_chrome_trace(str(traces / name))  # the port's own export
        out = tmp_path / "merged.json"
        proc = _doctor("merge-trace", str(out), str(traces))
        assert proc.returncode == 0, (proc.stdout, proc.stderr)
        merged = json.loads(out.read_text())
        names = {e["name"] for e in merged["traceEvents"]}
        assert {"ev0", "ev1"} <= names
        final = json.loads(proc.stdout.strip().splitlines()[-1])
        assert final["inputs"] == 2

    def test_empty_directory_exits_2(self, tmp_path):
        empty = tmp_path / "traces"
        empty.mkdir()
        proc = _doctor("merge-trace", str(tmp_path / "out.json"), str(empty))
        assert proc.returncode == 2
        err = json.loads(proc.stdout.strip().splitlines()[-1])
        assert err["event"] == "error"


# ---------------------------------------------------------------------------
# Cross-package: the same spool dir gives the same series and evaluation
# ---------------------------------------------------------------------------


def _traffic_dir(tmp_path, writers, seed=3):
    """Each writer ("port" / "jax") spools a serving process on its own
    fake clock: clean traffic, then a shed storm with a slow tail."""
    import numpy as np

    from tpu_tfrecord import fleet as jfleet, telemetry as jtel
    from tpu_tfrecord.metrics import Metrics as JMetrics

    rng = np.random.default_rng(seed)
    for pid, who in enumerate(writers, 1):
        pkg, tel, M = (fleet, None, Metrics) if who == "port" else (jfleet, jtel, JMetrics)
        ctx_cls = TraceContext if who == "port" else jtel.TraceContext
        ctx = ctx_cls(trace_id="t" * 16, span_id=f"{pid:016d}", role="serving", host="h",
                      pid=pid)
        now = [float(pid)]
        m = M()
        sp = pkg.TelemetrySpool(str(tmp_path), role="serving", interval_s=1.0, metrics=m,
                                context=ctx, clock=lambda: now[0])
        for tick in range(12):
            storm = tick >= 8
            m.count("serve.requests", int(rng.integers(50, 100)))
            if storm:
                m.count("serve.rejected", int(rng.integers(5, 20)))
                m.count("serve.deadline_expired", int(rng.integers(0, 5)))
            for v in rng.uniform(0.01, 0.6 if storm else 0.2, size=20):
                m.observe("serve.latency", float(v), exemplar=("t" * 16, f"r{tick}"))
            sp.tick()
            now[0] += 10.0
    return 130.0


@pytest.mark.parametrize("writers", [("port",) * 2, ("jax",) * 2, ("port", "jax")],
                         ids=["port_dir", "jax_dir", "mixed_dir"])
class TestCrossPackage:
    def test_fleet_samples_equal(self, tmp_path, writers):
        from tpu_tfrecord import slo as jslo

        _traffic_dir(tmp_path, writers)
        mine, theirs = fleet_samples(str(tmp_path)), jslo.fleet_samples(str(tmp_path))
        assert [(ts, c) for ts, c, _ in mine] == [(ts, c) for ts, c, _ in theirs]
        for (_, _, a), (_, _, b) in zip(mine, theirs):
            assert {n: (h.counts, h.exemplars) for n, h in a.items()} == \
                {n: (h.counts, h.exemplars) for n, h in b.items()}
        assert len(mine) == 24

    def test_engine_from_spool_evaluates_equal(self, tmp_path, writers):
        from tpu_tfrecord import slo as jslo

        now = _traffic_dir(tmp_path, writers)
        specs = ["availability:0.999", "latency:0.95:250"]
        windows = [w.scaled(1.0 / 60.0) for w in DEFAULT_WINDOWS]
        jwindows = [w.scaled(1.0 / 60.0) for w in jslo.DEFAULT_WINDOWS]
        clock = lambda: now  # noqa: E731
        mine = engine_from_spool(str(tmp_path), [Objective.parse(s) for s in specs],
                                 windows, clock=clock).evaluate()
        theirs = jslo.engine_from_spool(str(tmp_path), [jslo.Objective.parse(s) for s in specs],
                                        jwindows, clock=clock).evaluate()
        assert mine == theirs
        assert mine["verdict"] in ("slow_burn", "fast_burn")  # the storm burns
        assert mine["objectives"][0]["bad"] > 0

    def test_doctor_slo_reads_the_dir(self, tmp_path, writers):
        now = _traffic_dir(tmp_path, writers)
        proc = _doctor("slo", str(tmp_path), "--objective", "availability:0.999",
                       "--window-scale", str(1.0 / 60.0), "--now", str(now))
        assert proc.returncode == 0, (proc.stdout, proc.stderr)
        objective, summary = [json.loads(ln) for ln in proc.stdout.strip().splitlines()]
        windows = [w.scaled(1.0 / 60.0) for w in DEFAULT_WINDOWS]
        mine = engine_from_spool(str(tmp_path), [Objective.parse("availability:0.999")],
                                 windows).evaluate(now)
        assert (objective["bad"], objective["total"]) == (mine["objectives"][0]["bad"],
                                                          mine["objectives"][0]["total"])
        assert summary["verdict"] == mine["verdict"]
