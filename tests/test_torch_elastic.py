"""The port's elastic service layer (``tpu_tfrecord_torch.elastic``) against
the JAX package's.

One counterpart of each class of ``tests/test_elastic.py`` but
``TestBoundedClimber`` (``test_torch_autotune.py`` holds the climber) and
``TestBenchRegressionVerdict`` (it tests ``bench.py``), run on the port:
the fleet scaler's decisions under an injected verdict and clock, the
dispatcher's drain, tenant-keyed leasing and the shared warm cache, the
aggregator's role filter, the ``elastic_*`` options, the JAX doctor's
tenant and scaler lines over a port dispatcher, the worker CLI draining
itself, and the resize chaos run (a subprocess fleet grown, drained and
a draining victim SIGKILLed mid-epoch) whose rows equal a local read of
either package. Then ``TestServingScaler`` and ``TestReplicaKillChaos``
of ``tests/test_serving.py`` over ``python -m tpu_tfrecord_torch.serving
--device cpu`` replicas, and the cross-package serving cases: the port's
``ServingScaler`` drains a JAX replica and the JAX one a port replica.

Every wait polls a condition under a deadline; no fixed sleep stands in
for a process's death or registration.
"""

import dataclasses
import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from tpu_tfrecord import elastic as jelastic  # noqa: E402
from tpu_tfrecord.columnar import batch_to_rows as jbatch_to_rows  # noqa: E402
from tpu_tfrecord.io.dataset import TFRecordDataset as JDataset  # noqa: E402
from tpu_tfrecord.metrics import METRICS as JMETRICS  # noqa: E402
from tpu_tfrecord.options import TFRecordOptions as JOptions  # noqa: E402
from tpu_tfrecord.schema import StructType as JStructType  # noqa: E402
from tpu_tfrecord_torch import elastic, fleet, service, telemetry  # noqa: E402
from tpu_tfrecord_torch.columnar import batch_to_rows  # noqa: E402
from tpu_tfrecord_torch.io.dataset import TFRecordDataset  # noqa: E402
from tpu_tfrecord_torch.io.writer import DatasetWriter  # noqa: E402
from tpu_tfrecord_torch.metrics import METRICS  # noqa: E402
from tpu_tfrecord_torch.models import lm  # noqa: E402
from tpu_tfrecord_torch.options import TFRecordOptions  # noqa: E402
from tpu_tfrecord_torch.schema import (  # noqa: E402
    ArrayType,
    LongType,
    StringType,
    StructField,
    StructType,
)
from tpu_tfrecord_torch.serving import ServeClient, sequential_reference  # noqa: E402

DOCTOR = os.path.join(REPO, "tools", "tfrecord_doctor.py")

SCHEMA = StructType(
    [
        StructField("id", LongType(), nullable=False),
        StructField("s", StringType()),
        StructField("arr", ArrayType(LongType())),
    ]
)
ROWS = [
    [i, None if i % 7 == 0 else f"v{i}" * (i % 3 + 1), list(range(i % 5))]
    for i in range(180)
]
PER_SHARD = 30  # 6 shards

#: the environment of every subprocess: no card, one thread, this checkout
SUB_ENV = {**os.environ, "JAX_PLATFORMS": "cpu", "CUDA_VISIBLE_DEVICES": "",
           "OMP_NUM_THREADS": "1", "PYTHONPATH": REPO}


@pytest.fixture(autouse=True)
def _reset_metrics():
    METRICS.reset()
    JMETRICS.reset()
    yield


@pytest.fixture
def data_dir(sandbox):
    out = str(sandbox / "ds")
    DatasetWriter(
        out, SCHEMA, mode="overwrite", max_records_per_file=PER_SHARD
    ).write_rows(ROWS)
    return out


def make_ds(data_dir, batch_size=8, **kw):
    return TFRecordDataset(
        data_dir, batch_size=batch_size, schema=SCHEMA,
        drop_remainder=False, num_epochs=1, **kw,
    )


def collect(data_dir, batch_size=8, hook=None, **kw):
    ds = make_ds(data_dir, batch_size=batch_size, **kw)
    got = []
    with ds.batches() as it:
        for b in it:
            got.extend(batch_to_rows(b, ds.schema))
            if hook is not None:
                hook(got)
    return got


def jax_local_rows(data_dir):
    jds = JDataset(data_dir, batch_size=8, schema=JStructType.from_json(SCHEMA.to_json()),
                   drop_remainder=False, num_epochs=1)
    got = []
    with jds.batches() as it:
        for b in it:
            got.extend(jbatch_to_rows(b, jds.schema))
    return got


@pytest.fixture
def local_rows(data_dir):
    return collect(data_dir)


def start_worker(dispatcher, **kw):
    w = service.DecodeWorker(dispatcher.addr, **kw).start()
    assert w.wait_registered(10), "worker failed to register"
    return w


def stage_records(name):
    return METRICS.raw_totals().get(name, (0, 0, 0, 0.0))[0]


def wait_for(cond, timeout=20.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {msg}")


class FakeAggregator:
    """The scaler's test seam: a FleetSnapshot-shaped verdict source whose
    verdict and consumer liveness the test sets."""

    def __init__(self, verdict="balanced", running=True):
        self.verdict = verdict
        self.running = running

    def aggregate(self, roles=None):
        procs = []
        if self.running:
            procs = [fleet.ProcessSnapshot(
                path="fake", host="h", pid=1, role="trainer", trace_id=None,
                heartbeat=time.time(), interval_s=1.0, seq=1,
                gauges={telemetry.OCCUPANCY_GAUGE: 0.1},
            )]
        return fleet.FleetSnapshot(
            processes=procs, alive=procs, dead=[], counters={}, stages={},
            hists={}, verdict=self.verdict, occupancy=None,
        )


@pytest.fixture
def dispatcher():
    d = service.ServiceDispatcher(lease_ttl_s=1.0).start()
    yield d
    d.stop()


# ---------------------------------------------------------------------------
# FleetScaler decisions
# ---------------------------------------------------------------------------


class TestScalerDecisions:
    def _scaler(self, d, spawn, agg, **pol):
        defaults = dict(hysteresis=1, cooldown_s=0.0, min_workers=1,
                        max_workers=4)
        defaults.update(pol)
        return elastic.FleetScaler(
            d, spawn, aggregator=agg,
            policy=elastic.ScalerPolicy(**defaults),
        )

    def test_below_min_refills_immediately(self, dispatcher):
        spawned = []

        def spawn():
            spawned.append(start_worker(dispatcher, drain_grace_s=0.1))

        s = self._scaler(dispatcher, spawn, FakeAggregator("balanced"))
        decision = s.step()
        assert decision == {
            "tick": 1, "action": "scale_up", "reason": "below_min",
            "workers": 0, "target": 1,
        }
        assert len(spawned) == 1
        assert METRICS.counter("elastic.scale_ups") == 1
        # the registered spawn retires the pending slot; at the floor no
        # further refill happens
        assert s.step() is None
        for w in spawned:
            w.stop()

    def test_producer_bound_grows_consumer_bound_needs_headroom(self, dispatcher):
        workers = [start_worker(dispatcher, drain_grace_s=0.1)]

        def spawn():
            workers.append(start_worker(dispatcher, drain_grace_s=0.1))

        s = self._scaler(dispatcher, spawn, FakeAggregator("producer_bound"), hysteresis=2)
        assert s.step() is None  # streak 1 < hysteresis
        d2 = s.step()
        assert d2 and d2["action"] == "scale_up" and d2["reason"] == "producer_bound"
        wait_for(lambda: len(dispatcher.status()["workers"]) == 2,
                 msg="second worker registration")
        for w in workers:
            w.stop()

    def test_whipsaw_alternating_verdicts_never_move(self, dispatcher):
        workers = [start_worker(dispatcher, drain_grace_s=0.1)]
        agg = FakeAggregator()
        s = self._scaler(dispatcher, lambda: None, agg, hysteresis=2)
        for i in range(10):
            agg.verdict = ("producer_bound", "consumer_bound")[i % 2]
            assert s.step() is None, "a flapping verdict moved the fleet"
        assert METRICS.counter("elastic.scale_ups") == 0
        assert METRICS.counter("elastic.scale_downs") == 0
        workers[0].stop()

    def test_cooldown_blocks_consecutive_moves_injected_clock(self, dispatcher):
        now = [0.0]
        spawned = []
        workers = [start_worker(dispatcher, drain_grace_s=0.1)]
        s = elastic.FleetScaler(
            dispatcher, lambda: spawned.append(now[0]),
            aggregator=FakeAggregator("producer_bound"), clock=lambda: now[0],
            policy=elastic.ScalerPolicy(hysteresis=1, cooldown_s=100.0, min_workers=1,
                                        max_workers=8),
        )
        assert s.step()["action"] == "scale_up"
        now[0] = 50.0
        assert s.step() is None, "cooldown did not hold"
        now[0] = 100.0
        assert s.step()["action"] == "scale_up"
        assert len(spawned) == 2
        workers[0].stop()

    def test_pending_spawns_count_against_ceiling(self, dispatcher):
        now = [0.0]
        spawns = []
        workers = [start_worker(dispatcher, drain_grace_s=0.1)]
        s = elastic.FleetScaler(
            dispatcher, lambda: spawns.append(now[0]),  # never registers
            aggregator=FakeAggregator("producer_bound"), clock=lambda: now[0],
            policy=elastic.ScalerPolicy(hysteresis=1, cooldown_s=0.0, min_workers=1,
                                        max_workers=3, pending_timeout_s=30.0),
        )
        assert s.step()["action"] == "scale_up"   # effective 1 -> 2
        assert s.step()["action"] == "scale_up"   # effective 2 -> 3
        assert s.step() is None, "pending spawns did not count against max"
        assert len(spawns) == 2
        # timed-out pendings stop counting (the exec died): retry allowed
        now[0] = 31.0
        assert s.step()["action"] == "scale_up"
        workers[0].stop()

    def test_idle_drains_to_min_and_status_surfaces(self, dispatcher):
        w1 = start_worker(dispatcher, worker_id="w-a", drain_grace_s=0.05)
        w2 = start_worker(dispatcher, worker_id="w-b", drain_grace_s=0.05)
        s = self._scaler(dispatcher, lambda: None, FakeAggregator(running=False))
        decision = s.step()
        assert decision and decision["action"] == "scale_down"
        assert decision["reason"] == "idle"
        assert decision["victim"] == "w-b"  # deterministic: sorted()[-1]
        assert METRICS.counter("elastic.scale_downs") == 1
        # the victim finishes (nothing in flight), says goodbye, exits
        assert w2.drained.wait(10), "victim never drained"
        wait_for(
            lambda: [x["worker_id"] for x in dispatcher.status()["workers"]] == ["w-a"],
            msg="goodbye to remove the victim",
        )
        assert METRICS.counter("elastic.drains") == 1
        assert s.step() is None  # at the floor: no further drain
        st = dispatcher.status()
        assert st["scaler"]["workers"] == 1
        assert st["scaler"]["last_decision"]["victim"] == "w-b"
        assert st["scaler"]["scale_downs"] == 1
        w1.stop()

    def test_spawn_failure_is_counted_not_fatal(self, dispatcher):
        workers = [start_worker(dispatcher, drain_grace_s=0.1)]

        def spawn():
            raise RuntimeError("exec failed")

        s = self._scaler(dispatcher, spawn, FakeAggregator("producer_bound"))
        assert s.step() is None
        assert METRICS.counter("elastic.spawn_errors") == 1
        assert METRICS.counter("elastic.scale_ups") == 0
        workers[0].stop()

    def test_unreadable_spool_never_drains_a_loaded_fleet(self, dispatcher):
        # an aggregator that RAISES (EACCES, EIO — not merely absent) is
        # non-actionable: blindness is not idleness
        workers = [start_worker(dispatcher, worker_id=f"w-{i}", drain_grace_s=0.1)
                   for i in range(2)]

        class Broken:
            def aggregate(self, roles=None):
                raise PermissionError("spool dir unreadable")

        s = self._scaler(dispatcher, lambda: None, Broken())
        for _ in range(5):
            assert s.step() is None, "unreadable spool moved the fleet"
        assert METRICS.counter("elastic.scale_downs") == 0
        assert METRICS.counter("elastic.verdict_errors") == 5
        # a MISSING spool dir (no consumer ever spooled) IS idle: drain
        s2 = elastic.FleetScaler(
            dispatcher, lambda: None, spool_dir=str(dispatcher.addr) + "-none",
            policy=elastic.ScalerPolicy(hysteresis=1, cooldown_s=0.0, min_workers=1,
                                        max_workers=4),
        )
        s2.aggregator.spool_dir = "/nonexistent/tfr-spool"
        decision = s2.step()
        assert decision and decision["reason"] == "idle"
        for w in workers:
            w.stop()

    def test_scaler_thread_refills_from_zero(self, dispatcher):
        spawned = []

        def spawn():
            spawned.append(start_worker(dispatcher, drain_grace_s=0.1))

        s = elastic.FleetScaler(
            dispatcher, spawn, aggregator=FakeAggregator("balanced"), interval_s=0.05,
            policy=elastic.ScalerPolicy(min_workers=1, max_workers=2),
        ).start()
        try:
            wait_for(lambda: len(spawned) == 1, msg="thread refill")
        finally:
            s.stop()
            for w in spawned:
                w.stop()

    def test_roles_scope_reaches_the_aggregator(self, dispatcher):
        workers = [start_worker(dispatcher, drain_grace_s=0.1)]
        seen = []
        inner = FakeAggregator("balanced")

        class Agg:
            def aggregate(self, roles=None):
                seen.append(roles)
                return inner.aggregate()

        s = elastic.FleetScaler(
            dispatcher, lambda: None, aggregator=Agg(), roles=["trainer"],
            policy=elastic.ScalerPolicy(min_workers=1, max_workers=4),
        )
        s.step()
        assert seen == [["trainer"]]
        workers[0].stop()

    def test_ctor_needs_exactly_one_verdict_source(self, dispatcher):
        with pytest.raises(ValueError):
            elastic.FleetScaler(dispatcher, lambda: None)
        with pytest.raises(ValueError):
            elastic.FleetScaler(dispatcher, lambda: None, spool_dir="/tmp/x",
                                aggregator=FakeAggregator())

    def test_policy_validation(self):
        for mod in (elastic, jelastic):
            with pytest.raises(ValueError):
                mod.ScalerPolicy(min_workers=0)
            with pytest.raises(ValueError):
                mod.ScalerPolicy(min_workers=3, max_workers=2)
            with pytest.raises(ValueError):
                mod.ScalerPolicy(hysteresis=0)
        assert dataclasses.asdict(elastic.ScalerPolicy()) == \
            dataclasses.asdict(jelastic.ScalerPolicy())


# ---------------------------------------------------------------------------
# Dispatcher drain
# ---------------------------------------------------------------------------


def _route(d, shard_index, path, tenant="t0", exclude=()):
    return d._handle({
        "op": "route", "proto": service.PROTO_VERSION, "job": "j0",
        "tenant": tenant, "consumer": "c0", "path": path,
        "shard_index": shard_index, "exclude": list(exclude),
    })


class TestDrain:
    def test_drain_releases_leases_and_routes_around(self, dispatcher):
        w1 = start_worker(dispatcher, worker_id="w-a", drain_grace_s=5.0)
        w2 = start_worker(dispatcher, worker_id="w-b", drain_grace_s=5.0)
        owner = _route(dispatcher, 0, "s0")["worker_id"]
        assert dispatcher.drain(owner) is True
        assert dispatcher.drain(owner) is False  # already draining
        assert dispatcher.drain("nope") is False
        assert METRICS.counter("elastic.drained_leases") == 1
        # the lease was handed back; re-route goes to the survivor and is
        # planned drift, never a lease_reassignment
        assert _route(dispatcher, 0, "s0")["worker_id"] != owner
        assert dispatcher.status()["lease_reassignments"] == 0
        assert dispatcher.status()["draining"] == [owner]
        w1.stop()
        w2.stop()

    def test_all_draining_still_routes(self, dispatcher):
        w = start_worker(dispatcher, worker_id="w-a", drain_grace_s=30.0)
        assert dispatcher.drain("w-a")
        # availability beats drain purity when nothing else is alive
        reply = _route(dispatcher, 0, "s0")
        assert reply.get("ok") and reply["worker_id"] == "w-a"
        w.stop()

    def test_goodbye_unknown_worker_is_benign(self, dispatcher):
        reply = dispatcher._handle({"op": "goodbye", "proto": service.PROTO_VERSION,
                                    "worker_id": "ghost"})
        assert reply == {"ok": True, "known": False}
        assert METRICS.counter("elastic.drains") == 0

    def test_reregister_clears_drain_mark(self, dispatcher):
        w = start_worker(dispatcher, worker_id="w-a", drain_grace_s=30.0)
        assert dispatcher.drain("w-a")
        dispatcher._handle({"op": "register_worker", "proto": service.PROTO_VERSION,
                            "worker_id": "w-a", "addr": w.addr, "pid": 1})
        assert dispatcher.status()["draining"] == []
        w.stop()

    def test_journal_replay_restores_draining_and_tenants(self, tmp_path):
        """The port's drain record replays in both packages to the same
        draining set and tenant books."""
        from tpu_tfrecord import service as jservice

        journal = str(tmp_path / "journal.json")
        d = service.ServiceDispatcher(journal=journal, lease_ttl_s=5.0)
        try:
            for wid in ("w-a", "w-b"):
                d._handle({"op": "register_worker", "proto": service.PROTO_VERSION,
                           "worker_id": wid, "addr": "127.0.0.1:1", "pid": 1})
            _route(d, 0, "s0", tenant="t-shared")
            d._handle({"op": "shard_done", "proto": service.PROTO_VERSION, "job": "j0",
                       "tenant": "t-shared", "consumer": "c0", "path": "s0",
                       "worker_id": "w-a", "cached": True})
            assert d.drain("w-b")
        finally:
            d.stop()
        for mod in (service, jservice):
            d2 = mod.ServiceDispatcher(journal=journal, lease_ttl_s=5.0)
            try:
                st = d2.status()
                assert st["draining"] == ["w-b"]
                t = st["tenants"]["t-shared"]
                assert t["consumers"] == 1 and t["jobs"] == 1
                assert t["shards_done"] == 1
                assert t["shared_cache_hits"] == 1 and t["completions"] == 1
            finally:
                d2.stop()


# ---------------------------------------------------------------------------
# Multi-tenant leasing and the shared warm cache
# ---------------------------------------------------------------------------


class TestMultiTenant:
    def test_tenant_digest_ignores_consumption_shape(self, data_dir):
        a = service.tenant_digest(make_ds(data_dir, batch_size=8))
        b = service.tenant_digest(make_ds(data_dir, batch_size=16, prefetch=7))
        c = service.tenant_digest(make_ds(data_dir, columns=["id"]))
        assert a == b
        assert a != c

    def test_same_fingerprint_shares_one_lease_table(self, dispatcher, data_dir, local_rows):
        workers = [start_worker(dispatcher) for _ in range(2)]
        try:
            got8 = collect(data_dir, batch_size=8, service=dispatcher.addr,
                           service_deadline_ms=15000)
            got16 = collect(data_dir, batch_size=16, service=dispatcher.addr,
                            service_deadline_ms=15000)
            assert got8 == local_rows and got16 == local_rows
            st = dispatcher.status()
            assert len(st["tenants"]) == 1, st["tenants"]
            (tenant_info,) = st["tenants"].values()
            assert tenant_info["consumers"] == 2
            assert tenant_info["jobs"] == 2
            # the done-set is shared: 6 shards paid once fleet-wide though
            # two jobs each completed them
            assert tenant_info["shards_done"] == 6
            assert tenant_info["completions"] == 12
            assert st["shards_done"] == 6
            assert METRICS.counter("service.tenants") == 1
        finally:
            for w in workers:
                w.stop()

    def test_different_fingerprints_isolated(self, dispatcher, data_dir):
        workers = [start_worker(dispatcher)]
        try:
            collect(data_dir, batch_size=8, service=dispatcher.addr, service_deadline_ms=15000)
            collect(data_dir, batch_size=8, columns=["id"], service=dispatcher.addr,
                    service_deadline_ms=15000)
            st = dispatcher.status()
            assert len(st["tenants"]) == 2, st["tenants"]
            assert st["shards_done"] == 12  # nothing shared across tenants
            assert METRICS.counter("service.tenants") == 2
        finally:
            for w in workers:
                w.stop()

    def test_job2_zero_ground_truth_reads_local(self, dispatcher, data_dir, local_rows,
                                                tmp_path):
        opts = TFRecordOptions.from_map(cache="auto", cache_dir=str(tmp_path / "cache"))
        w = service.DecodeWorker(dispatcher.addr, options=opts).start()
        assert w.wait_registered(10)
        try:
            got1 = collect(data_dir, batch_size=8, service=dispatcher.addr,
                           service_deadline_ms=15000)
            assert got1 == local_rows
            misses_before = METRICS.counter("cache.misses")
            hits_before = METRICS.counter("cache.hits")
            decode_before = stage_records("decode")
            got2 = collect(data_dir, batch_size=16, service=dispatcher.addr,
                           service_deadline_ms=15000)
            assert got2 == local_rows
            # job 2 is served entirely from the warm columnar cache: zero
            # ground-truth reads, pinned three ways
            assert METRICS.counter("cache.misses") == misses_before
            assert METRICS.counter("cache.hits") - hits_before == 6
            assert stage_records("decode") == decode_before
            assert METRICS.counter("service.cache_served") == 6
            assert METRICS.counter("service.shared_cache_hits") == 6
            (tenant_info,) = dispatcher.status()["tenants"].values()
            assert tenant_info["shared_cache_hits"] == 6
        finally:
            w.stop()

    def test_job2_zero_file_gets_remote(self, dispatcher, data_dir, local_rows, tmp_path,
                                        sandbox):
        from tpu_tfrecord_torch import httpfs

        opts = TFRecordOptions.from_map(cache="auto", cache_dir=str(tmp_path / "cache"))
        w = service.DecodeWorker(dispatcher.addr, options=opts).start()
        assert w.wait_registered(10)
        try:
            with httpfs.serve_directory(str(sandbox)) as srv:
                url = srv.url_for("ds")
                got1 = collect(url, batch_size=8, service=dispatcher.addr,
                               service_deadline_ms=15000)
                assert got1 == local_rows
                gets_after_job1 = srv.file_get_count
                assert gets_after_job1 > 0  # job 1 paid the link once
                got2 = collect(url, batch_size=16, service=dispatcher.addr,
                               service_deadline_ms=15000)
                assert got2 == local_rows
                # job 2 issues zero ground-truth file GETs: the fleet's
                # warm cache absorbed the whole second job
                assert srv.file_get_count == gets_after_job1
                assert METRICS.counter("service.shared_cache_hits") == 6
        finally:
            w.stop()


# ---------------------------------------------------------------------------
# Aggregator role scoping (the scaler's verdict filter)
# ---------------------------------------------------------------------------


class TestAggregatorRoles:
    def test_roles_filter(self, tmp_path):
        spool = str(tmp_path / "spool")
        for pid, role in ((111, "trainer"), (222, "decode_worker")):
            ctx = dataclasses.replace(telemetry.TraceContext.new(role=role), pid=pid)
            fleet.TelemetrySpool(spool, context=ctx).tick()
        agg = fleet.TelemetryAggregator(spool, stale_after_s=3600.0)
        assert {p.role for p in agg.processes()} == {"trainer", "decode_worker"}
        assert [p.role for p in agg.processes(roles=["trainer"])] == ["trainer"]
        snap = agg.aggregate(roles=["trainer"])
        assert [p.role for p in snap.processes] == ["trainer"]


# ---------------------------------------------------------------------------
# Options
# ---------------------------------------------------------------------------


class TestOptionsElastic:
    KEYS = ("elastic_min_workers", "elastic_max_workers", "elastic_interval_s")

    def test_round_trip_both_spellings(self):
        for given in ({"elastic_min_workers": 2, "elastic_max_workers": 6,
                       "elastic_interval_s": 0.5},
                      {"elasticMinWorkers": "2", "elasticMaxWorkers": "6",
                       "elasticIntervalS": "0.5"}):
            o, j = TFRecordOptions.from_map(given), JOptions.from_map(given)
            assert tuple(getattr(o, k) for k in self.KEYS) == (2, 6, 0.5)
            assert tuple(getattr(j, k) for k in self.KEYS) == (2, 6, 0.5)

    def test_defaults(self):
        o = TFRecordOptions()
        assert o.elastic_min_workers == 1
        assert o.elastic_max_workers is None
        assert o.elastic_interval_s is None

    def test_validation_loud(self):
        for bad in ({"elastic_min_workers": 0},
                    {"elastic_min_workers": 4, "elastic_max_workers": 2},
                    {"elastic_interval_s": 0}):
            with pytest.raises(ValueError) as mine:
                TFRecordOptions.from_map(bad)
            with pytest.raises(ValueError) as theirs:
                JOptions.from_map(bad)
            assert str(mine.value) == str(theirs.value)


# ---------------------------------------------------------------------------
# The JAX doctor's serve-status over a port dispatcher: tenant and scaler lines
# ---------------------------------------------------------------------------


class TestServeStatusElastic:
    def test_tenant_and_scaler_lines(self, dispatcher, data_dir, local_rows):
        w = start_worker(dispatcher, worker_id="w-a")
        s = elastic.FleetScaler(
            dispatcher, lambda: None, aggregator=FakeAggregator(),
            policy=elastic.ScalerPolicy(min_workers=1, max_workers=4),
        )
        s.step()
        try:
            got = collect(data_dir, service=dispatcher.addr, service_deadline_ms=15000)
            assert got == local_rows
            doc = subprocess.run([sys.executable, DOCTOR, "serve-status", dispatcher.addr],
                                 capture_output=True, text=True, env=SUB_ENV, timeout=120)
            assert doc.returncode == 0, (doc.returncode, doc.stdout, doc.stderr)
            lines = [json.loads(ln) for ln in doc.stdout.splitlines() if ln.strip()]
            tenants = [ln for ln in lines if ln.get("event") == "tenant"]
            assert len(tenants) == 1
            assert tenants[0]["consumers"] == 1
            assert tenants[0]["shards_done"] == 6
            assert tenants[0]["cache_hit_ratio"] == 0.0  # no cache configured
            (scaler_line,) = [ln for ln in lines if ln.get("event") == "scaler"]
            assert scaler_line["workers"] == 1
            assert scaler_line["min_workers"] == 1
            (summary,) = [ln for ln in lines if ln.get("event") == "service"]
            assert summary["tenants"] == 1
            assert summary["draining"] == []
        finally:
            w.stop()


# ---------------------------------------------------------------------------
# Worker CLI: --fault-plan and --drain-grace on a real subprocess
# ---------------------------------------------------------------------------


class TestWorkerCli:
    def test_subprocess_worker_with_fault_plan_serves_and_drains(self, dispatcher, data_dir,
                                                                 local_rows, tmp_path):
        plan_path = str(tmp_path / "plan.json")
        with open(plan_path, "w") as fh:
            json.dump({"seed": 3, "rules": [{"op": "read", "kind": "stall", "path": "part-",
                                             "times": 2, "stall_ms": 5}]}, fh)
        p = subprocess.Popen(
            [sys.executable, "-m", "tpu_tfrecord_torch.service", "worker",
             "--dispatcher", dispatcher.addr, "--worker-id", "w-cli",
             "--drain-grace", "0.1", "--fault-plan", plan_path],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True, env=SUB_ENV,
        )
        try:
            ready = json.loads(p.stdout.readline())
            assert ready["worker_id"] == "w-cli"
            wait_for(lambda: any(w["alive"] for w in dispatcher.status()["workers"]),
                     msg="subprocess worker registration")
            got = collect(data_dir, service=dispatcher.addr, service_deadline_ms=15000)
            assert got == local_rows
            # drain it: the process exits cleanly on its own
            assert dispatcher.drain("w-cli")
            assert p.wait(timeout=30) == 0
            wait_for(lambda: dispatcher.status()["workers"] == [],
                     msg="goodbye from the CLI worker")
            assert METRICS.counter("elastic.drains") == 1
        finally:
            if p.poll() is None:
                p.kill()
                p.wait()


# ---------------------------------------------------------------------------
# Chaos acceptance: grow, graceful drain and a SIGKILL mid-drain, mid-epoch
# ---------------------------------------------------------------------------


class TestResizeChaosAcceptance:
    def test_fleet_resize_mid_epoch_byte_identical(self, data_dir, local_rows):
        """The port fleet is grown from 2 to 3 subprocess workers, one is
        drained and a second draining victim SIGKILLed, all mid-epoch: the
        consumer's rows equal a local read of the port and of the JAX
        package, with no fallback."""
        d = service.ServiceDispatcher(lease_ttl_s=3.0).start()
        spawner = elastic.SubprocessSpawner(d.addr, ("--drain-grace", "0.2"), env=SUB_ENV)
        agg = FakeAggregator("balanced")
        scaler = elastic.FleetScaler(
            d, spawner, aggregator=agg,
            policy=elastic.ScalerPolicy(hysteresis=1, cooldown_s=0.0, min_workers=1,
                                        max_workers=3),
        )
        try:
            spawner()
            spawner()
            wait_for(lambda: d.status()["alive"] >= 2, timeout=60,
                     msg="initial fleet registration")
            phases = {"grown": False, "drained": False, "killed": None}

            def hook(rows):
                if len(rows) >= 16 and not phases["grown"]:
                    agg.verdict = "producer_bound"
                    assert scaler.step()["action"] == "scale_up"
                    wait_for(lambda: d.status()["alive"] >= 3, timeout=60,
                             msg="scaled-up worker registration")
                    phases["grown"] = True
                elif len(rows) >= 80 and not phases["drained"]:
                    # the victim may be serving this very epoch: its
                    # goodbye is asserted after the epoch
                    agg.verdict = "consumer_bound"
                    decision = scaler.step()
                    assert decision["action"] == "scale_down"
                    phases["drained"] = decision["victim"]
                elif len(rows) >= 120 and phases["killed"] is None:
                    agg.verdict = "consumer_bound"
                    decision = scaler.step()
                    assert decision["action"] == "scale_down"
                    victim = decision["victim"]
                    pid = next(w["pid"] for w in d.status()["workers"]
                               if w["worker_id"] == victim)
                    os.kill(pid, signal.SIGKILL)
                    phases["killed"] = victim

            got = collect(data_dir, service=d.addr, service_deadline_ms=15000, hook=hook)
            assert got == local_rows, "resize broke byte-identity"
            assert got == jax_local_rows(data_dir)
            assert phases["grown"] and phases["drained"] and phases["killed"]
            assert phases["drained"] != phases["killed"]
            assert METRICS.counter("elastic.scale_ups") == 1
            assert METRICS.counter("elastic.scale_downs") == 2
            assert METRICS.counter("service.fallbacks") == 0
            # the graceful victim says goodbye once its streams finish...
            wait_for(lambda: phases["drained"] not in
                     [w["worker_id"] for w in d.status()["workers"]],
                     timeout=30, msg="graceful victim goodbye")
            assert METRICS.counter("elastic.drains") == 1
            # ...the SIGKILLed one never does: it goes stale by heartbeat
            wait_for(lambda: any(w["worker_id"] == phases["killed"] and not w["alive"]
                                 for w in d.status()["workers"]),
                     timeout=30, msg="killed victim heartbeat expiry")
            assert phases["killed"] in d.status()["draining"]
        finally:
            spawner.reap()
            d.stop()


# ---------------------------------------------------------------------------
# ServingScaler: queue_bound grows, idle drains, a SIGKILL refills
# ---------------------------------------------------------------------------


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


class _FakeFleet:
    """In-memory replicas for the scaler's state machine: spawn() mints an
    address; the test sets each replica's status."""

    def __init__(self):
        self.n = 0
        self.load = {}  # addr -> status overrides
        self.dead = set()
        self.draining = set()

    def spawn(self):
        self.n += 1
        addr = f"127.0.0.1:{9000 + self.n}"
        self.load[addr] = {}
        return addr

    def status(self, addr):
        if addr in self.dead:
            raise ConnectionError("SIGKILLed")
        base = {"queue_depth": 0, "in_flight": 0, "p99_ms": 50.0, "slo_p99_ms": 250.0,
                "max_queue": 16, "completed": 0, "draining": addr in self.draining}
        base.update(self.load.get(addr, {}))
        return base

    def drain(self, addr):
        self.draining.add(addr)
        return {"ok": True, "draining": True}


def _serving_scaler(fleet_, mod=elastic, **pol):
    clock = FakeClock()
    s = mod.ServingScaler(
        fleet_.spawn,
        policy=mod.ScalerPolicy(min_workers=1, max_workers=4, hysteresis=2, cooldown_s=1.0,
                                **pol),
        status_fn=fleet_.status, drain_fn=fleet_.drain, clock=clock,
    )
    return s, clock


class TestServingScaler:
    def test_grows_on_queue_bound_and_drains_on_idle(self):
        """The same script of loads gives the port's and the JAX scaler the
        same decision log."""
        logs = []
        for mod in (elastic, jelastic):
            fleet_ = _FakeFleet()
            s, clock = _serving_scaler(fleet_, mod)
            assert s.step()["reason"] == "below_min"  # empty fleet -> floor
            addr = s.replicas[0]
            # sustained overload: full queue and missed SLO -> queue_bound
            fleet_.load[addr] = {"queue_depth": 12, "p99_ms": 900.0, "completed": 10}
            grew = None
            for _ in range(6):
                clock.advance(2.0)
                fleet_.load[addr]["completed"] += 5  # not idle
                grew = s.step()
                if grew:
                    break
            assert grew and grew["action"] == "scale_up"
            assert grew["reason"] == "queue_bound"
            assert len(s.replicas) == 2
            # load vanishes: empty queues and zero completions -> idle -> drain
            for a in s.replicas:
                fleet_.load[a] = {"queue_depth": 0, "completed": 50}
            shrank = None
            for _ in range(8):
                clock.advance(2.0)
                shrank = s.step() or shrank
            assert shrank and shrank["action"] == "scale_down"
            assert shrank["reason"] == "idle"
            assert fleet_.draining, "the victim never got the drain RPC"
            logs.append(s.log)
        assert logs[0] == logs[1]

    def test_drained_replica_death_is_a_clean_goodbye(self):
        fleet_ = _FakeFleet()
        s, clock = _serving_scaler(fleet_)
        s.step()
        victim = fleet_.spawn()
        s.replicas.append(victim)
        fleet_.drain(victim)
        s._draining.add(victim)
        before = METRICS.counter("elastic.drains")
        lost = METRICS.counter("elastic.replicas_lost")
        fleet_.dead.add(victim)  # a drained replica exits on its own
        clock.advance(2.0)
        s.step()
        assert victim not in s.replicas
        assert METRICS.counter("elastic.drains") == before + 1
        assert METRICS.counter("elastic.replicas_lost") == lost

    @pytest.mark.parametrize("error,drained", [("closed", True), ("refused", False)])
    def test_drain_reply_lost_to_the_replicas_exit(self, error, drained):
        """A drain whose reply the replica drops as it stops (the request
        went out; the connection closed) is a drain: its exit is a clean
        goodbye. A drain that never reached the replica is no move."""
        from tpu_tfrecord_torch import service_protocol as sp

        fleet_ = _FakeFleet()
        s, clock = _serving_scaler(fleet_)
        s.step()
        victim = fleet_.spawn()
        s.replicas.append(victim)

        def drain(addr):
            if error == "refused":
                raise ConnectionRefusedError(111, "refused")
            fleet_.drain(addr)
            raise sp.ProtocolError(f"short frame from {addr}: connection closed")

        s._drain = drain
        for _ in range(3):  # no completion delta yet, then idle twice
            clock.advance(2.0)
            decision = s.step()
        assert (decision is not None) is drained
        if drained:
            assert decision["victim"] == victim and victim in s._draining
            fleet_.dead.add(victim)
            clock.advance(2.0)
            s.step()
            assert victim not in s.replicas
            assert METRICS.counter("elastic.drains") == 1
            assert METRICS.counter("elastic.replicas_lost") == 0

    def test_sigkill_refills_below_floor_bypassing_climber(self):
        """An undrained death is a kill: counted ``elastic.replicas_lost``
        and refilled on the very next tick (no hysteresis wait)."""
        fleet_ = _FakeFleet()
        s, clock = _serving_scaler(fleet_)
        s.step()
        victim = s.replicas[0]
        lost = METRICS.counter("elastic.replicas_lost")
        fleet_.dead.add(victim)
        clock.advance(2.0)
        decision = s.step()
        assert METRICS.counter("elastic.replicas_lost") == lost + 1
        assert decision is not None and decision["reason"] == "below_min"
        assert len(s.replicas) == 1 and s.replicas[0] != victim


# ---------------------------------------------------------------------------
# Replica chaos on real processes: a SIGKILLed replica drains through the
# survivor; the scalers of both packages drain each other's replicas
# ---------------------------------------------------------------------------

REPLICA_ARGS = ("--stages", "1", "--layers", "2", "--d-model", "16", "--heads", "2",
                "--mb", "2", "--seed", "5")
REPLICA_CFG = lm.LMConfig(vocab_size=96, d_model=16, n_heads=2, n_layers=2, max_len=16,
                          n_virtual=1)
#: the status and drain RPCs' timeout here: a replica still warming up on
#: a loaded machine may take longer than the production default to answer
RPC_TIMEOUT_S = 30.0


def rpcs(mod):
    """``mod``'s real status and drain RPCs at ``RPC_TIMEOUT_S``."""
    return (lambda a: mod._serving_status_rpc(a, timeout=RPC_TIMEOUT_S),
            lambda a: mod._serving_drain_rpc(a, timeout=RPC_TIMEOUT_S))


def _windows(n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, REPLICA_CFG.vocab_size, size=REPLICA_CFG.max_len).astype(np.int32)
            for _ in range(n)]


class TestReplicaKillChaos:
    def test_sigkill_drains_through_survivor_and_scaler_refills(self):
        """Two seeded port replicas, one SIGKILLed: the client walks the
        member list so its requests drain through the survivor with the
        reference tokens, and the scaler's next tick counts the loss and
        refills the floor."""
        spawner = elastic.ServingReplicaSpawner(extra_args=("--device", "cpu", *REPLICA_ARGS),
                                                env=SUB_ENV)
        status_fn, drain_fn = rpcs(elastic)
        scaler = elastic.ServingScaler(
            spawner,
            policy=elastic.ScalerPolicy(min_workers=2, max_workers=3, hysteresis=2,
                                        cooldown_s=0.0),
            status_fn=status_fn, drain_fn=drain_fn,
        )
        try:
            scaler.step()  # below_min: 1st replica
            scaler.step()  # below_min: 2nd replica
            assert len(scaler.replicas) == 2
            addrs = list(scaler.replicas)
            params = lm.init_params(REPLICA_CFG, torch.Generator().manual_seed(5), "cpu")
            ws = _windows(3, seed=11)
            ref = sequential_reference(params, REPLICA_CFG, 1, [(w, 2) for w in ws], 2,
                                       device="cpu")
            c = ServeClient(addrs)
            try:
                assert c.generate(ws[0], 2) == ref[0]
                # SIGKILL the replica the client is pinned to: the next
                # request must rotate to the survivor
                victim_addr = c.addr
                victim = next(p for p, a in zip(spawner.procs, addrs) if a == victim_addr)
                os.kill(victim.pid, signal.SIGKILL)
                victim.wait(timeout=30)
                assert c.generate(ws[1], 2) == ref[1]
                assert c.generate(ws[2], 2) == ref[2]
            finally:
                c.close()
            lost = METRICS.counter("elastic.replicas_lost")
            decision = scaler.step()  # census the corpse, refill the floor
            assert METRICS.counter("elastic.replicas_lost") == lost + 1
            assert decision is not None and decision["reason"] == "below_min"
            assert len(scaler.replicas) == 2
            assert victim_addr not in scaler.replicas
        finally:
            scaler.stop()
            spawner.reap()


def test_each_serving_scaler_drains_the_other_packages_replica():
    """The port's ``ServingScaler`` drains a JAX replica and the JAX one a
    port replica over the real ``status`` and ``drain`` RPCs: the victim
    exits 0 and the next tick counts the clean goodbye. A fake member that
    sorts first keeps the fleet at its floor of one."""
    port_spawn = elastic.ServingReplicaSpawner(("--device", "cpu", *REPLICA_ARGS), env=SUB_ENV)
    jax_spawn = jelastic.ServingReplicaSpawner(REPLICA_ARGS, env=SUB_ENV)
    addrs = {}
    threads = [threading.Thread(target=lambda k=k, sp=sp: addrs.__setitem__(k, sp()))
               for k, sp in (("port", port_spawn), ("jax", jax_spawn))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    try:
        assert set(addrs) == {"port", "jax"}, "a replica never printed its ready line"
        stand_in = "0.0.0.0:1"  # sorts before every 127.0.0.1 address

        def run(mod, metrics, victim_addr, spawner):
            real_status, drain_fn = rpcs(mod)
            s = mod.ServingScaler(
                lambda: None, replicas=[stand_in, victim_addr],
                policy=mod.ScalerPolicy(min_workers=1, max_workers=2, hysteresis=1,
                                        cooldown_s=0.0),
                status_fn=lambda a: ({"queue_depth": 0, "in_flight": 0, "completed": 0}
                                     if a == stand_in else real_status(a)),
                drain_fn=drain_fn,
            )
            # idle needs two ticks with no completion between them; a
            # replica still warming up may hold that off a while
            decision, deadline, verdicts = None, time.monotonic() + RPC_TIMEOUT_S, []
            while decision is None and time.monotonic() < deadline:
                decision = s.step()
                verdicts.append(s.status()["verdict"])
                time.sleep(0.05)
            assert decision and decision["action"] == "scale_down", verdicts[-3:]
            assert decision["reason"] == "idle"
            assert decision["victim"] == victim_addr
            assert spawner.procs[0].wait(timeout=60) == 0  # drained, exited cleanly
            s.step()
            assert s.replicas == [stand_in]
            assert metrics.counter("elastic.drains") == 1
            assert metrics.counter("elastic.replicas_lost") == 0

        run(elastic, METRICS, addrs["jax"], jax_spawn)
        run(jelastic, JMETRICS, addrs["port"], port_spawn)
    finally:
        port_spawn.reap()
        jax_spawn.reap()
