"""Closed-loop autotuning in the port (``autotune.py`` and the dataset's
resizable pool) against the JAX package.

- Controller parity: one synthetic sequence of pulse payloads (verdicts,
  ``read.io`` bandwidths, read and open p99s) fed to the JAX and the port
  ``AutotuneController`` over fake controls, with one injected clock: the
  same decisions, the same knobs, the same pulse blocks.
- The pieces, mirroring ``tests/test_autotune.py``: the resizable prefetch
  queue, the pool books of ``PipelineControl``, the controller's
  hysteresis, cooldown, clamps, thresholds and readahead, the pulse
  observer, the live resize (batches and resumes unchanged), live stall
  thresholds, the options, and a throttled read that the controller grows
  while its rows stay those of a fixed pool.
"""

import json
import os
import threading
import time

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from tpu_tfrecord import autotune as jautotune  # noqa: E402
from tpu_tfrecord.metrics import Metrics as JMetrics  # noqa: E402
from tpu_tfrecord.stall import StallGuard as JGuard  # noqa: E402

import tpu_tfrecord_torch.io as tio  # noqa: E402
from tpu_tfrecord_torch import autotune as tautotune, faults as tfaults  # noqa: E402
from tpu_tfrecord_torch.autotune import AutotuneController, AutotunePolicy, PipelineControl  # noqa: E402
from tpu_tfrecord_torch.io.dataset import TFRecordDataset, _ResizableQueue  # noqa: E402
from tpu_tfrecord_torch.metrics import Metrics  # noqa: E402
from tpu_tfrecord_torch.options import TFRecordOptions  # noqa: E402
from tpu_tfrecord_torch.schema import LongType, StringType, StructField, StructType  # noqa: E402
from tpu_tfrecord_torch.stall import GuardedReadStream, StallGuard  # noqa: E402
from tpu_tfrecord_torch.telemetry import Pulse  # noqa: E402

SCHEMA = StructType([StructField("id", LongType(), nullable=False), StructField("s", StringType())])


def write_dataset(base, n_shards=6, rows_per_shard=40) -> str:
    out = os.path.join(str(base), "ds")
    for s in range(n_shards):
        rows = [[i, f"row-{i}"] for i in range(s * rows_per_shard, (s + 1) * rows_per_shard)]
        tio.write(rows, SCHEMA, out, mode="append" if s else "overwrite")
    return out


def read_all(ds) -> list:
    with ds.batches() as it:
        return [r for b in it for r in b["id"].values.tolist()]


# ---------------------------------------------------------------------------
# controller parity
# ---------------------------------------------------------------------------


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def payload(verdict="unknown", stages=None, quantiles=None, gauges=None):
    return {"event": "pulse", "verdict": verdict, "stages": stages or {},
            "quantiles": quantiles or {}, "gauges": gauges or {}, "counters": {}}


def q(stage, p99_ms, count=100):
    return {stage: {"p50_ms": p99_ms / 2, "p90_ms": p99_ms, "p99_ms": p99_ms, "count": count}}


def payload_sequence(seed):
    """A seeded walk over verdicts, bandwidths and latencies, each tick
    with a clock step."""
    rng = np.random.default_rng(seed)
    seq = []
    for _ in range(60):
        verdict = ["producer_bound", "consumer_bound", "balanced", "unknown"][
            int(rng.choice(4, p=[0.45, 0.25, 0.2, 0.1]))]
        stages = {}
        if rng.random() < 0.5:
            stages["read.io"] = {"bytes_per_sec": float(rng.choice([1e6, 80e6, 400e6, 2e9]))}
        quant = {}
        if rng.random() < 0.5:
            quant.update(q("read.io", float(rng.choice([2.0, 30.0, 500.0, 9000.0])),
                           int(rng.choice([5, 50]))))
        if rng.random() < 0.3:
            quant.update(q("read.open", float(rng.choice([1.0, 200.0]))))
        seq.append((float(rng.choice([0.25, 1.0, 3.0])), payload(verdict, stages, quant)))
    return seq


def run_controller(mod, guard_cls, metrics_cls, seq, workers, guard_kw):
    clock = FakeClock()
    guard = guard_cls(**guard_kw)
    control = mod.PipelineControl(workers=workers, max_workers=6, guard=guard)
    control.bind_spawn(lambda: None)
    control.set_prefetch(2)
    control.set_readahead_bytes(64 << 20)
    ctl = mod.AutotuneController(control, interval_s=0.5, metrics=metrics_cls(), clock=clock)
    blocks = []
    for dt, p in seq:
        clock.t += dt
        blocks.append(ctl.on_pulse(json.loads(json.dumps(p))))
    return ctl.log, blocks, (control.workers, control.prefetch, control.readahead_bytes,
                             guard.read_deadline, guard.open_deadline, guard.hedge_after)


@pytest.mark.parametrize("guard_kw", [{}, dict(read_deadline=1.0, open_deadline=2.0)])
@pytest.mark.parametrize("workers", [1, 3])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_controller_parity(seed, workers, guard_kw):
    seq = payload_sequence(seed)
    j = run_controller(jautotune, JGuard, JMetrics, seq, workers, guard_kw)
    t = run_controller(tautotune, StallGuard, Metrics, seq, workers, guard_kw)
    assert t[0] == j[0] and len(t[0]) > 0
    assert t[1] == j[1]
    assert t[2] == j[2]


def test_default_max_workers_like_jax():
    assert tautotune.default_max_workers() == jautotune.default_max_workers()
    assert tautotune.DEFAULT_INTERVAL_S == jautotune.DEFAULT_INTERVAL_S
    assert AutotunePolicy() == AutotunePolicy(**vars(jautotune.AutotunePolicy()))


def test_bounded_climber_like_jax():
    verdicts = ["producer_bound", "producer_bound", "balanced", "consumer_bound",
                "consumer_bound", "consumer_bound", "producer_bound", "producer_bound"]
    outs = []
    for mod in (jautotune, tautotune):
        clock = FakeClock()
        c = mod.BoundedClimber(2, 1.5, clock=clock)
        got = []
        for v in verdicts:
            clock.t += 1.0
            r = c.observe(v)
            got.append((r, c.streak, c.cooldown_remaining()))
            if r:
                c.acted()
        outs.append(got)
    assert outs[0] == outs[1]


# ---------------------------------------------------------------------------
# resizable prefetch queue
# ---------------------------------------------------------------------------


def test_grow_wakes_blocked_putter():
    q_ = _ResizableQueue(maxsize=1)
    q_.put(1)
    done = threading.Event()

    def putter():
        q_.put(2)  # blocks until the resize
        done.set()

    threading.Thread(target=putter, daemon=True).start()
    time.sleep(0.05)
    assert not done.is_set()
    q_.resize(2)
    assert done.wait(1.0)
    assert q_.get() == 1 and q_.get() == 2


def test_shrink_blocks_new_puts_until_drained():
    q_ = _ResizableQueue(maxsize=4)
    for i in range(3):
        q_.put(i)
    q_.resize(1)
    with pytest.raises(Exception):
        q_.put(99, timeout=0.05)
    assert [q_.get() for _ in range(3)] == [0, 1, 2]
    q_.put(99, timeout=0.5)


def test_resize_floor_is_one():
    q_ = _ResizableQueue(maxsize=4)
    q_.resize(0)
    assert q_.maxsize == 1


# ---------------------------------------------------------------------------
# PipelineControl books
# ---------------------------------------------------------------------------


def test_set_workers_clamps_and_spawns():
    spawned = []
    c = PipelineControl(workers=2, max_workers=4)
    c.bind_spawn(lambda: spawned.append(1))
    assert len(spawned) == 2
    assert c.set_workers(99) == 4 and len(spawned) == 4
    assert c.set_workers(0) == 1 and len(spawned) == 4


def test_exit_permits_match_surplus_exactly():
    c = PipelineControl(workers=4, max_workers=8)
    c.bind_spawn(lambda: None)
    c.set_workers(2)
    permits = [c.should_exit() for _ in range(4)]
    assert permits.count(True) == 2
    for p in permits:
        if p:
            c.note_exit(permitted=True)
    assert not c.should_exit()


def test_grow_after_shrink_respawns():
    spawned = []
    c = PipelineControl(workers=3, max_workers=8)
    c.bind_spawn(lambda: spawned.append(1))
    c.set_workers(1)
    assert c.should_exit() and c.should_exit()
    c.note_exit(permitted=True)
    c.note_exit(permitted=True)
    before = len(spawned)
    c.set_workers(3)
    assert len(spawned) - before == 2


def test_prefetch_and_readahead_without_queue_or_dataset():
    c = PipelineControl(workers=1)
    assert c.prefetch is None
    assert c.set_prefetch(5) == 5 and c.prefetch == 5
    assert c.set_readahead_bytes(8 << 20) == 8 << 20 and c.readahead_bytes == 8 << 20


def test_configured_pool_above_the_ceiling_is_kept():
    assert PipelineControl(workers=48, max_workers=8).max_workers == 48


# ---------------------------------------------------------------------------
# controller units
# ---------------------------------------------------------------------------


def make_controller(workers=1, policy=None, guard=None, queue=None):
    clock = FakeClock()
    control = PipelineControl(workers=workers, max_workers=8, queue=queue, guard=guard)
    ctl = AutotuneController(control, interval_s=1.0,
                             policy=policy or AutotunePolicy(hysteresis=2, cooldown_s=2.0),
                             metrics=Metrics(), clock=clock)
    return ctl, control, clock


def test_hysteresis_requires_consecutive_verdicts():
    ctl, control, clock = make_controller()
    ctl.on_pulse(payload("producer_bound"))
    assert control.workers == 1
    clock.t += 10
    ctl.on_pulse(payload("producer_bound"))
    assert control.workers == 2


def test_balanced_resets_streak():
    ctl, control, clock = make_controller()
    ctl.on_pulse(payload("producer_bound"))
    ctl.on_pulse(payload("balanced"))
    clock.t += 10
    ctl.on_pulse(payload("producer_bound"))
    assert control.workers == 1


def test_whipsaw_verdicts_never_move_the_pool():
    ctl, control, clock = make_controller()
    for i in range(10):
        clock.t += 10
        ctl.on_pulse(payload("producer_bound" if i % 2 else "consumer_bound"))
    assert control.workers == 1 and ctl.log == []


def test_cooldown_limits_move_rate():
    ctl, control, clock = make_controller(policy=AutotunePolicy(hysteresis=1, cooldown_s=5.0))
    ctl.on_pulse(payload("producer_bound"))
    assert control.workers == 2
    clock.t += 1.0
    ctl.on_pulse(payload("producer_bound"))
    ctl.on_pulse(payload("producer_bound"))
    assert control.workers == 2
    clock.t += 10.0
    ctl.on_pulse(payload("producer_bound"))
    assert control.workers == 3


def test_consumer_bound_shrinks_to_floor_only():
    ctl, control, clock = make_controller(
        workers=2, policy=AutotunePolicy(hysteresis=1, cooldown_s=0.0, min_workers=1))
    for _ in range(5):
        clock.t += 1
        ctl.on_pulse(payload("consumer_bound"))
    assert control.workers == 1


def test_grow_clamps_at_max_workers():
    ctl, control, clock = make_controller(
        policy=AutotunePolicy(hysteresis=1, cooldown_s=0.0, max_workers=3))
    for _ in range(8):
        clock.t += 1
        ctl.on_pulse(payload("producer_bound"))
    assert control.workers == 3


def test_prefetch_tracks_pool():
    q_ = _ResizableQueue(maxsize=1)
    ctl, control, clock = make_controller(
        policy=AutotunePolicy(hysteresis=1, cooldown_s=0.0), queue=q_)
    clock.t += 1
    ctl.on_pulse(payload("producer_bound"))
    assert control.workers == 2 and q_.maxsize == 4


def test_decisions_logged_and_counted():
    ctl, control, clock = make_controller(policy=AutotunePolicy(hysteresis=1, cooldown_s=0.0))
    clock.t += 1
    out = ctl.on_pulse(payload("producer_bound"))
    assert out["autotune"]["workers"] == 2
    assert out["autotune"]["adjusted"][0]["knob"] == "workers"
    assert ctl.log[0]["reason"] == "producer_bound"
    assert ctl.metrics.counter("autotune.adjustments") >= 1
    assert ctl.metrics.gauge_value("autotune.workers") == 2.0


def test_hedge_derived_from_read_p99():
    guard = StallGuard()
    ctl, _, _ = make_controller(guard=guard)
    ctl.on_pulse(payload(quantiles=q("read.io", 50.0)))
    assert guard.hedge_after == pytest.approx(0.2)


def test_hedge_floor_clamp():
    guard = StallGuard()
    ctl, _, _ = make_controller(guard=guard)
    ctl.on_pulse(payload(quantiles=q("read.io", 1.0)))
    assert guard.hedge_after == pytest.approx(0.1)


def test_deadlines_adapted_but_never_introduced():
    guard = StallGuard()
    ctl, _, _ = make_controller(guard=guard)
    ctl.on_pulse(payload(quantiles={**q("read.io", 500.0), **q("read.open", 500.0)}))
    assert guard.read_deadline is None and guard.open_deadline is None
    guard2 = StallGuard(read_deadline=1.0, open_deadline=1.0)
    ctl2, _, _ = make_controller(guard=guard2)
    ctl2.on_pulse(payload(quantiles={**q("read.io", 500.0), **q("read.open", 400.0)}))
    assert guard2.read_deadline == pytest.approx(10.0)
    assert guard2.open_deadline == pytest.approx(8.0)


def test_threshold_band_suppresses_twitch():
    guard = StallGuard(hedge_after=0.2)
    ctl, _, _ = make_controller(guard=guard)
    ctl.on_pulse(payload(quantiles=q("read.io", 55.0)))
    assert guard.hedge_after == pytest.approx(0.2) and ctl.log == []


def test_min_latency_samples_gate():
    guard = StallGuard()
    ctl, _, _ = make_controller(guard=guard)
    ctl.on_pulse(payload(quantiles=q("read.io", 50.0, count=3)))
    assert guard.hedge_after is None


def test_deadline_ceiling_clamp():
    guard = StallGuard(read_deadline=1.0)
    ctl, _, _ = make_controller(guard=guard)
    ctl.on_pulse(payload(quantiles=q("read.io", 60_000.0)))
    assert guard.read_deadline == pytest.approx(120.0)


def test_readahead_retargets_to_bandwidth_horizon():
    ctl, control, _ = make_controller()
    control.set_readahead_bytes(64 << 20)
    ctl.on_pulse(payload(stages={"read.io": {"bytes_per_sec": 100e6}}))
    assert control.readahead_bytes == 64 << 20
    ctl.on_pulse(payload(stages={"read.io": {"bytes_per_sec": 400e6}}))
    assert control.readahead_bytes == int(round(400e6 * 0.5 / (1 << 20))) << 20


def test_readahead_clamped_to_policy_range():
    ctl, control, _ = make_controller()
    control.set_readahead_bytes(64 << 20)
    ctl.on_pulse(payload(stages={"read.io": {"bytes_per_sec": 10e9}}))
    assert control.readahead_bytes == 256 << 20
    ctl.on_pulse(payload(stages={"read.io": {"bytes_per_sec": 1e6}}))
    assert control.readahead_bytes == 8 << 20


def test_disabled_readahead_stays_disabled():
    ctl, control, _ = make_controller()
    control.set_readahead_bytes(0)
    ctl.on_pulse(payload(stages={"read.io": {"bytes_per_sec": 400e6}}))
    assert control.readahead_bytes == 0


def test_observer_fields_merged_into_emitted_line():
    lines = []
    pulse = Pulse(60.0, metrics=Metrics(), emit=lines.append)
    pulse.add_observer(lambda p: {"autotune": {"workers": 3}})
    pulse.tick()
    assert lines[0]["autotune"] == {"workers": 3}


def test_observer_exception_never_breaks_the_tick():
    lines = []
    m = Metrics()
    pulse = Pulse(60.0, metrics=m, emit=lines.append)

    def bad(_p):
        raise RuntimeError("observer bug")

    pulse.add_observer(bad)
    pulse.tick()
    assert lines and lines[0]["event"] == "pulse"
    assert m.counter("pulse.observer_errors") == 1


# ---------------------------------------------------------------------------
# the live pool
# ---------------------------------------------------------------------------


def test_rows_identical_across_mid_epoch_resizes(tmp_path):
    out = write_dataset(tmp_path)
    baseline = read_all(TFRecordDataset(out, batch_size=7, schema=SCHEMA, drop_remainder=False))
    ds = TFRecordDataset(out, batch_size=7, schema=SCHEMA, drop_remainder=False,
                         autotune="on", autotune_interval_s=300.0)
    got = []
    with ds.batches() as it:
        for i, b in enumerate(it):
            if i == 1:
                it._control.set_workers(4)
                it._control.set_prefetch(8)
            if i == 10:
                it._control.set_workers(1)
                it._control.set_prefetch(2)
            got.extend(b["id"].values.tolist())
    assert got == baseline


def test_checkpoint_resume_across_resize(tmp_path):
    out = write_dataset(tmp_path)
    baseline = read_all(TFRecordDataset(out, batch_size=7, schema=SCHEMA, drop_remainder=False))
    ds = TFRecordDataset(out, batch_size=7, schema=SCHEMA, drop_remainder=False,
                         autotune="on", autotune_interval_s=300.0)
    it = ds.batches()
    head = []
    for i, b in enumerate(it):
        if i == 2:
            it._control.set_workers(3)
        head.extend(b["id"].values.tolist())
        if i == 5:
            break
    state = it.state()
    it.close()
    ds2 = TFRecordDataset(out, batch_size=7, schema=SCHEMA, drop_remainder=False, num_workers=2,
                          autotune="on", autotune_interval_s=300.0)
    tail = []
    with ds2.batches(state) as it2:
        for i, b in enumerate(it2):
            if i == 1:
                it2._control.set_workers(4)
            tail.extend(b["id"].values.tolist())
    assert head + tail == baseline


def test_single_worker_autotune_path_matches_sequential(tmp_path):
    out = write_dataset(tmp_path, n_shards=3)
    kw = dict(batch_size=5, schema=SCHEMA, drop_remainder=False)
    assert read_all(TFRecordDataset(out, autotune="on", autotune_interval_s=300.0, **kw)) == \
        read_all(TFRecordDataset(out, **kw))


def test_iterator_exposes_controller_only_when_on(tmp_path):
    out = write_dataset(tmp_path, n_shards=2)
    with TFRecordDataset(out, batch_size=5, schema=SCHEMA).batches() as it:
        assert it.autotune is None and it._control is None and it._pulse is None
    ds2 = TFRecordDataset(out, batch_size=5, schema=SCHEMA, autotune="on",
                          autotune_interval_s=300.0)
    with ds2.batches() as it2:
        assert it2.autotune is not None
        assert it2._control.guard is ds2._stall_guard is not None
        assert it2._pulse is not None and it2._pulse.interval_s == 300.0
    assert it2._pulse is None  # stopped at close


def test_guarded_stream_reads_thresholds_through_guard():
    import io

    guard = StallGuard(read_deadline=60.0)
    stream = GuardedReadStream(io.BytesIO(b"x" * 1024), "mem", read_deadline=60.0,
                               hedge_after=None, reopen=lambda pos: io.BytesIO(b"x" * 1024),
                               guard=guard)
    assert stream._deadline == 60.0
    guard.update_thresholds(read_deadline_ms=125.0, hedge_after_ms=250.0)
    assert stream._deadline == pytest.approx(0.125)
    assert stream._hedge_after == pytest.approx(0.25)
    stream.close()


def test_update_thresholds_units_and_partial():
    guard = StallGuard(read_deadline=1.0)
    guard.update_thresholds(hedge_after_ms=500.0)
    assert guard.read_deadline == 1.0 and guard.hedge_after == pytest.approx(0.5)
    guard.update_thresholds(read_deadline_ms=2000.0, open_deadline_ms=3000.0)
    assert guard.read_deadline == pytest.approx(2.0)
    assert guard.open_deadline == pytest.approx(3.0)


def test_autotune_options_parse_and_validate():
    opts = TFRecordOptions.from_map()
    assert opts.autotune == "off" and opts.autotune_interval_s is None
    opts = TFRecordOptions.from_map(autotune="on", autotune_interval_s="0.5")
    assert opts.autotune == "on" and opts.autotune_interval_s == 0.5
    with pytest.raises(ValueError, match="autotune must be"):
        TFRecordOptions.from_map(autotune="sometimes")
    with pytest.raises(ValueError, match="autotune_interval_s"):
        TFRecordOptions.from_map(autotune_interval_s=0)
    with pytest.raises(ValueError, match="autotune"):
        TFRecordOptions.from_map(autotunee="on")


def test_throttled_read_grows_the_pool_and_keeps_the_rows(tmp_path):
    """Every shard read pays an injected 30 ms sleep, so the read is
    producer-bound: the controller grows the pool from one worker, and the
    rows equal a fixed four-worker read's."""
    out = write_dataset(tmp_path, n_shards=6, rows_per_shard=40)

    def run(epochs, **kw):
        plan = tfaults.FaultPlan([tfaults.FaultRule(op="read", kind="stall", path="part-",
                                                    times=None, stall_ms=30.0)], seed=7)
        ds = TFRecordDataset(out, batch_size=20, schema=SCHEMA, drop_remainder=False,
                             num_epochs=epochs, use_mmap=False, **kw)
        with tfaults.install_chaos(plan):
            with ds.batches() as it:
                rows = [r for b in it for r in b["id"].values.tolist()]
                tuner = it.autotune
        plan.release()
        return rows, tuner

    fixed, _ = run(4, num_workers=4, prefetch=4)
    tuned, tuner = run(4, num_workers=1, prefetch=1, autotune="on", autotune_interval_s=0.1)
    assert tuned == fixed
    grows = [d for d in tuner.log if d["knob"] == "workers"]
    assert grows and grows[0]["to"] > grows[0]["from"], tuner.log
    assert tuner.control.workers > 1
