"""The telemetry pulse of the port (``telemetry.Pulse``, ``quantiles_ms``
and the registry accessors it reads) against the JAX package.

- Pulse parity: both packages' ``Pulse``, driven by one injected clock
  and the same metric traffic into their own registries, emit equal
  lines (all but the wall-clock stamp and the process identity).
- Registry parity: ``raw_totals``, ``gauges`` and ``hist_states`` hold
  what the JAX registry holds after the same traffic, and ``observe`` /
  ``quantiles`` agree with the JAX ``Histogram``.
- The pieces, mirroring ``tests/test_telemetry.py::TestPulse``, and a
  dataset read with ``pulse_interval_s`` set.
"""

import json
import logging
import os
import time

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from tpu_tfrecord import telemetry as jtelemetry  # noqa: E402
from tpu_tfrecord.metrics import Metrics as JMetrics  # noqa: E402

import tpu_tfrecord_torch.io as tio  # noqa: E402
from tpu_tfrecord_torch import telemetry  # noqa: E402
from tpu_tfrecord_torch.io.dataset import TFRecordDataset  # noqa: E402
from tpu_tfrecord_torch.metrics import Metrics  # noqa: E402
from tpu_tfrecord_torch.options import TFRecordOptions  # noqa: E402
from tpu_tfrecord_torch.schema import LongType, StructField, StructType  # noqa: E402
from tpu_tfrecord_torch.telemetry import Pulse  # noqa: E402

STAGES = ("decode", "read.io", "read.open", "batch.wait", "moe.dropped_fraction")
COUNTS = ("read.retries", "read.stalls", "autotune.adjustments")


def traffic(seed):
    """A seeded list of registry calls: (method, args) per call, in ticks
    separated by None."""
    rng = np.random.default_rng(seed)
    calls = []
    for _ in range(6):
        for _ in range(int(rng.integers(0, 12))):
            kind = rng.integers(0, 4)
            if kind == 0:
                stage = STAGES[int(rng.integers(0, len(STAGES)))]
                secs = float(rng.choice([2e-6, 3e-4, 0.012, 0.4, 2.5]))
                calls.append(("add", (stage,), dict(records=int(rng.integers(0, 5000)),
                                                    nbytes=int(rng.integers(0, 1 << 22)),
                                                    seconds=secs, latency=secs)))
            elif kind == 1:
                calls.append(("count", (COUNTS[int(rng.integers(0, len(COUNTS)))],
                                        int(rng.integers(1, 4))), {}))
            elif kind == 2:
                calls.append(("gauge", (telemetry.OCCUPANCY_GAUGE,
                                        float(rng.choice([0.1, 0.5, 0.9]))), {}))
            else:
                calls.append(("observe", ("read.open", float(rng.choice([1e-5, 0.003, 0.2]))),
                              {}))
        calls.append(None)
    return calls


def replay(metrics, calls, on_tick):
    for c in calls:
        if c is None:
            on_tick()
        else:
            name, args, kw = c
            getattr(metrics, name)(*args, **kw)


def comparable(line):
    line = json.loads(json.dumps(line))
    line.pop("ts")
    line.pop("proc")
    return line


@pytest.mark.parametrize("seed", range(5))
def test_pulse_parity(seed):
    """One clock, one traffic: the same lines, observers included."""
    calls = traffic(seed)
    lines = {}
    for name, pulse_cls, metrics_cls in (("jax", jtelemetry.Pulse, JMetrics),
                                         ("torch", Pulse, Metrics)):
        m = metrics_cls()
        times = iter(np.cumsum([0.0] + [0.25, 1.0, 0.5, 2.0, 0.75, 1.5]).tolist())
        out = []
        p = pulse_cls(0.5, metrics=m, emit=out.append, clock=lambda: next(times))
        p.add_observer(lambda pl: {"seen": sorted(pl["stages"])})
        replay(m, calls, p.tick)
        lines[name] = [comparable(x) for x in out]
    assert lines["torch"] == lines["jax"]
    assert len(lines["torch"]) == 6 and any(x["stages"] for x in lines["torch"])


@pytest.mark.parametrize("seed", range(3))
def test_registry_accessors_like_jax(seed):
    calls = traffic(seed)
    j, t = JMetrics(), Metrics()
    replay(j, calls, lambda: None)
    replay(t, calls, lambda: None)
    assert t.raw_totals() == j.raw_totals()
    assert t.gauges() == j.gauges()
    assert t.hist_states() == j.hist_states()
    assert t.quantiles() == j.quantiles()
    assert telemetry.quantiles_ms(t.quantiles()) == jtelemetry.quantiles_ms(j.quantiles())


def test_histogram_observe_and_quantiles_like_jax():
    values = np.random.default_rng(9).lognormal(-6, 2, size=2000).tolist() + [0.0, 1e-9, 9e4]
    j, t = jtelemetry.Histogram(), Metrics()
    for v in values:
        j.observe(v)
        t.observe("x", v)
    assert t.quantiles()["x"] == j.quantiles()
    assert t.hist_states()["x"] == j.state()


def test_quantiles_ms_skips_dimensionless_and_empty():
    src = {"read.io": {"p50_s": 0.001, "p90_s": 0.002, "p99_s": 0.003, "count": 4},
           "moe.gate_entropy": {"p50_s": 0.5, "p90_s": 0.6, "p99_s": 0.7, "count": 2},
           "decode": {"p50_s": 1e-3, "p90_s": 2e-3, "p99_s": 4e-3, "hist_count": 3.0},
           "empty": {}}
    got = telemetry.quantiles_ms(src)
    assert got == jtelemetry.quantiles_ms(src)
    assert sorted(got) == ["decode", "read.io"] and got["decode"]["count"] == 3
    assert telemetry.is_latency_hist("read.io") and not telemetry.is_latency_hist("pipeline.x")


def test_pulse_line_round_trip():
    m = Metrics()
    m.add("decode", records=100, nbytes=5000, seconds=0.5, latency=0.5)
    m.count("read.retries", 2)
    m.gauge(telemetry.OCCUPANCY_GAUGE, 0.9)
    lines = []
    p = Pulse(1.0, metrics=m, emit=lines.append, clock=iter([0.0, 2.0]).__next__)
    payload = p.tick()
    assert lines == [payload]
    rt = json.loads(json.dumps(payload))
    assert rt["event"] == "pulse" and rt["interval_s"] == pytest.approx(2.0)
    assert rt["stages"]["decode"]["records_per_sec"] == pytest.approx(50.0)
    assert rt["stages"]["decode"]["bytes_per_sec"] == pytest.approx(2500.0)
    assert rt["counters"]["read.retries"] == 2
    assert rt["gauges"][telemetry.OCCUPANCY_GAUGE] == pytest.approx(0.9)
    assert rt["quantiles"]["decode"]["count"] == 1
    assert rt["verdict"] == "consumer_bound"


def test_pulse_reports_interval_deltas():
    m = Metrics()
    p = Pulse(1.0, metrics=m, emit=lambda _d: None, clock=iter([0.0, 1.0, 2.0]).__next__)
    m.add("decode", records=100, seconds=0.1)
    assert p.tick()["stages"]["decode"]["records_per_sec"] == pytest.approx(100.0)
    second = p.tick()
    assert second["stages"]["decode"]["records_per_sec"] == 0.0
    assert second["stages"]["decode"]["records"] == 100


def test_pulse_thread_and_default_log_emit(caplog):
    m = Metrics()
    m.add("decode", records=10, seconds=0.01)
    p = Pulse(0.02, metrics=m)
    with caplog.at_level(logging.INFO, logger="tpu_tfrecord_torch"):
        p.start()
        time.sleep(0.08)
        p.stop()
    pulse_lines = [r.getMessage() for r in caplog.records if "tfrecord.pulse" in r.getMessage()]
    assert pulse_lines
    assert json.loads(pulse_lines[0].split("tfrecord.pulse ", 1)[1])["event"] == "pulse"


def test_stop_idempotent():
    lines = []
    p = Pulse(10.0, metrics=Metrics(), emit=lines.append).start()
    p.stop()
    n = len(lines)
    p.stop()
    assert len(lines) == n == 1


def test_interval_must_be_positive():
    with pytest.raises(ValueError, match="interval_s"):
        Pulse(0)


def test_pulse_interval_option_parses_like_jax():
    assert TFRecordOptions.from_map({}).pulse_interval_s is None
    assert TFRecordOptions.from_map(pulse_interval_s="2.5").pulse_interval_s == 2.5
    assert TFRecordOptions.from_map({"pulseIntervalS": 1}).pulse_interval_s == 1.0
    with pytest.raises(ValueError, match="pulse_interval_s"):
        TFRecordOptions.from_map(pulse_interval_s=0)


def test_pulse_option_emits_during_iteration(tmp_path, caplog):
    schema = StructType([StructField("id", LongType(), nullable=False)])
    out = os.path.join(str(tmp_path), "ds")
    tio.write([[i] for i in range(200)], schema, out, mode="overwrite")
    ds = TFRecordDataset(out, batch_size=16, schema=schema, drop_remainder=False,
                         pulse_interval_s=0.02)
    with caplog.at_level(logging.INFO, logger="tpu_tfrecord_torch"):
        with ds.batches() as it:
            for _ in it:
                time.sleep(0.01)
    pulse_lines = [r.getMessage() for r in caplog.records if "tfrecord.pulse" in r.getMessage()]
    assert pulse_lines
    payload = json.loads(pulse_lines[-1].split("tfrecord.pulse ", 1)[1])
    assert payload["verdict"] in ("producer_bound", "consumer_bound", "balanced", "unknown")
    assert "prefetch.queue_depth" in payload["gauges"]
    assert payload["stages"]["decode"]["records"] >= 200
