"""The port's warm standby and federated scaler against the JAX package's.

Counterparts of ``TestStandbyFailover``, ``TestFederatedScaler``,
``TestDoctorFederated`` and ``TestHAChaosAcceptance`` of
``tests/test_service_ha.py``, run on ``tpu_tfrecord_torch.service`` and
``tpu_tfrecord_torch.elastic``: a standby tails the primary's journal,
answers lease ops with ``not_primary``, promotes on the primary's death
(generation + 1, the journal compacted into a new inode) and adopts its
address; the scaler's census merged over partitions, its whipsaw guard
and its ``DispatcherHandle``; the JAX doctor's federated ``serve-status``
over port dispatchers; and the acceptance run, the primary subprocess
SIGKILLed mid-epoch under two consumers and two worker subprocesses.

Then the cross-package cases: each package's standby promotes over the
other package's primary's journal and fences that primary when it comes
back; a JAX ``FleetScaler`` drains a port worker through a handle over a
port primary and standby, and a port ``FleetScaler`` a JAX worker through
a handle over a JAX dispatcher; the JAX doctor reads a port partition
after its failover, with the port scaler's line.

Every wait polls a condition (``status()`` or a counter) under a
deadline; the standby's ping interval and miss count leave room for a
loaded machine.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time

import pytest
import torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from tpu_tfrecord import elastic as jelastic  # noqa: E402
from tpu_tfrecord import fleet as jfleet  # noqa: E402
from tpu_tfrecord import service as jservice  # noqa: E402
from tpu_tfrecord import telemetry as jtelemetry  # noqa: E402
from tpu_tfrecord.metrics import METRICS as JMETRICS  # noqa: E402
from tpu_tfrecord_torch import elastic, fleet, service, telemetry  # noqa: E402
from tpu_tfrecord_torch.columnar import batch_to_rows  # noqa: E402
from tpu_tfrecord_torch.io.dataset import TFRecordDataset  # noqa: E402
from tpu_tfrecord_torch.io.writer import DatasetWriter  # noqa: E402
from tpu_tfrecord_torch.metrics import METRICS  # noqa: E402
from tpu_tfrecord_torch.schema import (  # noqa: E402
    ArrayType,
    LongType,
    StringType,
    StructField,
    StructType,
)

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

#: a standby's cadence in these tests: a primary must miss 3 pings 0.5 s
#: apart, each with a 0.5 s timeout, before its standby takes over (a
#: loaded machine answers a live primary's ping well within that)
PING_S, MISSES = 0.5, 3

PACKAGES = {"port": (service, METRICS), "jax": (jservice, JMETRICS)}


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


def make_ds(data_dir, **kw):
    return TFRecordDataset(data_dir, batch_size=8, schema=SCHEMA, drop_remainder=False,
                           num_epochs=1, **kw)


def collect(data_dir, **kw):
    ds = make_ds(data_dir, **kw)
    got = []
    with ds.batches() as it:
        for b in it:
            got.extend(batch_to_rows(b, ds.schema))
    return got


@pytest.fixture
def local_rows(data_dir):
    return collect(data_dir)


def wait_for(cond, timeout=20.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {msg}")


def _register(d, wid):
    return d._handle({"op": "register_worker", "worker_id": wid, "addr": f"h:{wid}",
                      "pid": 0})


def _route(d, shard_index, exclude=()):
    return d._handle({"op": "route", "job": "j", "path": f"/data/shard-{shard_index}",
                      "shard_index": shard_index, "exclude": list(exclude)})


def _journal_records(path):
    with open(path, "rb") as fh:
        data = fh.read()
    return [json.loads(ln) for ln in data.split(b"\n") if ln.strip()]


class FakeAggregator:
    """The scaler's test seam: a FleetSnapshot-shaped verdict source."""

    def __init__(self, verdict="balanced", running=True, fleet_mod=fleet, telemetry_mod=telemetry):
        self.verdict = verdict
        self.running = running
        self.fleet, self.telemetry = fleet_mod, telemetry_mod

    def aggregate(self, roles=None):
        procs = []
        if self.running:
            procs = [self.fleet.ProcessSnapshot(
                path="fake", host="h", pid=1, role="trainer", trace_id=None,
                heartbeat=time.time(), interval_s=1.0, seq=1,
                gauges={self.telemetry.OCCUPANCY_GAUGE: 0.1},
            )]
        return self.fleet.FleetSnapshot(
            processes=procs, alive=procs, dead=[], counters={}, stages={},
            hists={}, verdict=self.verdict, occupancy=None,
        )


def _standby(mod, journal, primary_addr, **kw):
    kw = {"lease_ttl_s": 5.0, "ping_interval_s": PING_S, "takeover_misses": MISSES,
          "takeover_addr": False, **kw}
    return mod.ServiceDispatcher(journal=journal, standby_of=primary_addr, **kw)


# ---------------------------------------------------------------------------
# The warm standby
# ---------------------------------------------------------------------------


class TestStandbyFailover:
    def test_standby_rejects_lease_ops_and_names_its_primary(self, tmp_path):
        b = _standby(service, str(tmp_path / "j.json"), "127.0.0.1:9", ping_interval_s=30.0)
        try:
            r = _route(b, 0)
            assert r["error"] == "not_primary"
            assert r["role"] == "standby" and r["primary"] == "127.0.0.1:9"
            st = b.status()
            assert st["role"] == "standby" and st["accepting"] is False
            assert st["standby_of"] == "127.0.0.1:9"
            # register/heartbeat still land: the standby keeps the fleet's
            # freshness warm for a takeover; ping reports the role
            assert _register(b, "w0")["ok"]
            assert b._handle({"op": "heartbeat", "worker_id": "w0"})["known"]
            assert b._handle({"op": "ping"}) == {"ok": True, "role": "standby",
                                                 "accepting": False, "generation": 0}
            assert METRICS.counter("service.not_primary_rejects") == 1
        finally:
            b.stop()

    def test_standby_tails_journal_and_promotes_on_primary_death(self, tmp_path):
        j = str(tmp_path / "j.json")
        a = service.ServiceDispatcher(journal=j, lease_ttl_s=5.0).start()
        b = None
        try:
            _register(a, "w0")
            _register(a, "w1")
            assert _route(a, 0)["ok"]
            b = _standby(service, j, a.addr).start()
            wait_for(lambda: len(b.status()["workers"]) == 2, msg="standby journal tail")
            assert not b.accepting
            a.stop()
            # the counter lands after the promotion's compaction: the
            # journal read below sees the promoted snapshot
            wait_for(lambda: METRICS.counter("service.failovers") == 1,
                     msg="standby promotion")
            st = b.status()
            assert b.accepting
            assert st["role"] == "dispatcher" and st["failed_over"] is True
            assert b.generation == 1
            assert METRICS.gauge_value("service.partition") == 0.0
            # the promotion's compaction is the fence: a fresh snapshot
            # with the bumped generation and the tailed lease state
            recs = _journal_records(j)
            assert recs[0]["kind"] == "snapshot"
            assert recs[0]["generation"] == 1
            assert set(recs[0]["workers"]) == {"w0", "w1"}
            assert st["active_leases"] == 1
        finally:
            if b is not None:
                b.stop()
            a.stop()

    def test_promoted_standby_adopts_the_primarys_address(self, tmp_path):
        j = str(tmp_path / "j.json")
        a = service.ServiceDispatcher(journal=j, lease_ttl_s=5.0).start()
        primary_addr = a.addr
        b = _standby(service, j, primary_addr, takeover_addr=True).start()
        try:
            a.stop()
            wait_for(lambda: METRICS.counter("service.failovers") == 1,
                     msg="standby promotion")

            def answered():
                try:
                    return service.fetch_status(primary_addr, timeout=1.0)
                except OSError:
                    return None

            wait_for(lambda: answered() is not None, msg="address adoption")
            st = answered()
            # a client that only knew the dead primary's host:port finds
            # the promoted standby answering there
            assert st["role"] == "dispatcher"
            assert st["failed_over"] is True and st["generation"] == 1
            assert st["addr"] == b.addr
        finally:
            b.stop()
            a.stop()


@pytest.mark.parametrize("primary,standby", [("port", "jax"), ("jax", "port")])
def test_standby_promotes_over_the_other_packages_primary(tmp_path, primary, standby):
    """A standby of one package tails the journal of the other package's
    primary, promotes on its death with the tailed books at generation 1,
    and the primary brought back as a zombie is fenced by the new inode
    and demoted: it grants nothing more and lands no byte."""
    pmod, pmetrics = PACKAGES[primary]
    smod, smetrics = PACKAGES[standby]
    j = str(tmp_path / "j.json")
    a = pmod.ServiceDispatcher(journal=j, lease_ttl_s=5.0).start()
    b = None
    try:
        _register(a, "w0")
        _register(a, "w1")
        assert _route(a, 0)["ok"]
        b = _standby(smod, j, a.addr).start()
        wait_for(lambda: len(b.status()["workers"]) == 2, msg="standby journal tail")
        assert _route(b, 1)["error"] == "not_primary"
        a.stop()  # the primary stops answering; its object lives on
        wait_for(lambda: smetrics.counter("service.failovers") == 1, msg="standby promotion")
        st = b.status()
        assert st["role"] == "dispatcher" and st["failed_over"] is True
        assert st["generation"] == 1 and st["active_leases"] == 1
        recs = _journal_records(j)
        assert recs[0]["generation"] == 1 and set(recs[0]["workers"]) == {"w0", "w1"}
        # the zombie's next mutation hits the fence
        assert a.accepting
        _register(a, "w9")
        assert pmetrics.counter("service.fenced_writes") == 1
        assert pmetrics.counter("service.demotions") == 1
        assert not a.accepting
        r = _route(a, 2)
        assert r["error"] == "not_primary" and r["demoted"] is True
        assert all("w9" not in json.dumps(rec) for rec in _journal_records(j))
        # the promoted standby grants from the tailed books
        assert _route(b, 2)["worker_id"] in ("w0", "w1")
    finally:
        if b is not None:
            b.stop()
        a.stop()


def test_shard_done_rides_a_failover(data_dir, tmp_path):
    """A consumer's completion report sent while the primary is dead and
    its standby not yet promoted lands in the promoted standby's books (the
    JAX consumer drops it: its own acceptance run loses a shard from the
    books when the kill falls on a shard's end)."""
    j = str(tmp_path / "j.json")
    a = service.ServiceDispatcher(journal=j, lease_ttl_s=5.0).start()
    b = _standby(service, j, a.addr, takeover_misses=10).start()  # a 5 s outage
    ds = make_ds(data_dir, service=f"{a.addr}|{b.addr}")
    client = service.ServiceClient(ds)
    try:
        _register(a, "w0")
        wait_for(lambda: len(b.status()["workers"]) == 1, msg="standby journal tail")
        a.stop()
        assert not b.accepting
        client._shard_done("w0", ds.shards[0].path)
        assert b.accepting and b.status()["shards_done"] == 1
    finally:
        client.close()
        b.stop()
        a.stop()


# ---------------------------------------------------------------------------
# The federated FleetScaler: merged census, whipsaw guard, remote handles
# ---------------------------------------------------------------------------


class _DeadPartition:
    """A partition whose primary and standby are unreachable."""

    scaler_status = None

    def status(self):
        raise OSError("unreachable")

    def drain(self, worker_id):
        raise OSError("unreachable")


class TestFederatedScaler:
    def test_census_merges_partitions_and_dedupes_workers(self):
        d0 = service.ServiceDispatcher(lease_ttl_s=5.0)
        d1 = service.ServiceDispatcher(lease_ttl_s=5.0)
        try:
            _register(d0, "w0")
            _register(d1, "w0")  # same worker, every partition
            _register(d0, "w1")
            s = elastic.FleetScaler([d0, d1], lambda: None, aggregator=FakeAggregator(),
                                    policy=elastic.ScalerPolicy(min_workers=1, max_workers=4))
            c = s._census()
            assert sorted(c["active"]) == ["w0", "w1"]
            # draining on any partition means draining in the merged view
            assert d0.drain("w1")
            c = s._census()
            assert c["active"] == ["w0"] and c["draining"] == ["w1"]
            # the constructor published its status block to every partition
            assert d0.scaler_status is not None
            assert d1.scaler_status is not None
        finally:
            d0.stop()
            d1.stop()

    def test_unreadable_partition_skips_the_tick_no_whipsaw(self):
        d0 = service.ServiceDispatcher(lease_ttl_s=5.0)
        try:
            _register(d0, "w0")
            spawned = []
            s = elastic.FleetScaler(
                [d0, _DeadPartition()], lambda: spawned.append(1),
                aggregator=FakeAggregator("producer_bound"),
                policy=elastic.ScalerPolicy(hysteresis=1, cooldown_s=0.0, min_workers=1,
                                            max_workers=4),
            )
            for _ in range(3):
                assert s.step() is None, "scaler acted on a partial fleet view"
            assert spawned == []
            assert METRICS.counter("elastic.census_errors") >= 3
            assert METRICS.counter("elastic.scale_ups") == 0
            assert METRICS.counter("elastic.scale_downs") == 0
        finally:
            d0.stop()

    def test_drain_fans_out_to_every_partition(self):
        d0 = service.ServiceDispatcher(lease_ttl_s=5.0)
        d1 = service.ServiceDispatcher(lease_ttl_s=5.0)
        try:
            _register(d0, "w0")
            _register(d1, "w0")
            assert _route(d1, 0)["worker_id"] == "w0"
            s = elastic.FleetScaler([d0, d1], lambda: None, aggregator=FakeAggregator(),
                                    policy=elastic.ScalerPolicy(min_workers=1, max_workers=4))
            assert s._drain_one(["w0"], "idle") is not None
            # the lease came back on the partition that routed to it, and
            # both partitions mark the victim draining
            assert d0.status()["draining"] == ["w0"]
            assert d1.status()["draining"] == ["w0"]
            assert d1.status()["active_leases"] == 0
        finally:
            d0.stop()
            d1.stop()

    def test_dispatcher_handle_walks_members_and_proxies_rpcs(self):
        d = service.ServiceDispatcher(lease_ttl_s=5.0).start()
        try:
            _register(d, "w0")
            # a dead member first: the handle walks to the live one
            h = elastic.DispatcherHandle(f"127.0.0.1:9|{d.addr}", timeout=2.0)
            st = h.status()
            assert [w["worker_id"] for w in st["workers"]] == ["w0"]
            h.scaler_status = {"workers": 1, "verdict": "balanced"}
            assert d.scaler_status == {"workers": 1, "verdict": "balanced"}
            assert h.drain("w0") is True
            assert d.status()["draining"] == ["w0"]
        finally:
            d.stop()

    def test_dispatcher_handle_skips_standbys_for_primary_only_ops(self, tmp_path):
        j = str(tmp_path / "j.json")
        a = service.ServiceDispatcher(journal=j, lease_ttl_s=5.0).start()
        b = _standby(service, j, a.addr, ping_interval_s=30.0).start()
        try:
            _register(a, "w0")
            # the standby listed first would reject a drain: the handle
            # skips to the acting primary
            h = elastic.DispatcherHandle([b.addr, a.addr], timeout=2.0)
            assert h.drain("w0") is True
            assert a.status()["draining"] == ["w0"]
        finally:
            b.stop()
            a.stop()


def _drained_by(scaler, worker, dispatcher):
    """Tick ``scaler`` over an idle fleet until it drains; then ``worker``
    finishes, says goodbye and leaves ``dispatcher``'s books."""
    decision = scaler.step()
    assert decision and decision["action"] == "scale_down" and decision["reason"] == "idle"
    assert decision["victim"] == worker.worker_id
    assert worker.drained.wait(20), "victim never said goodbye"
    wait_for(lambda: worker.worker_id not in
             [w["worker_id"] for w in dispatcher.status()["workers"]], msg="goodbye")
    return decision


def test_jax_scaler_drains_a_port_worker_through_a_port_primary_and_standby(tmp_path):
    j = str(tmp_path / "j.json")
    a = service.ServiceDispatcher(journal=j, lease_ttl_s=5.0).start()
    b = _standby(service, j, a.addr).start()
    spec = f"{a.addr}|{b.addr}"
    workers = [service.DecodeWorker(spec, worker_id=w, drain_grace_s=0.05).start()
               for w in ("w-a", "w-b")]
    try:
        for w in workers:
            assert w.wait_registered(10)
        wait_for(lambda: len(b.status()["workers"]) == 2, msg="standby journal tail")
        # the standby listed first answers the census from its tailed
        # books; the handle skips it for the drain
        h = jelastic.DispatcherHandle([b.addr, a.addr], timeout=2.0)
        s = jelastic.FleetScaler(
            [h], lambda: None,
            aggregator=FakeAggregator(running=False, fleet_mod=jfleet, telemetry_mod=jtelemetry),
            policy=jelastic.ScalerPolicy(hysteresis=1, cooldown_s=0.0, min_workers=1,
                                         max_workers=4),
        )
        _drained_by(s, workers[1], a)
        assert METRICS.counter("elastic.drains") == 1  # the port primary's goodbye
        # published through the handle to the first member that answers
        assert b.scaler_status["scale_downs"] == 1
    finally:
        for w in workers:
            w.stop()
        b.stop()
        a.stop()


def test_port_scaler_drains_a_jax_worker_through_a_jax_dispatcher():
    d = jservice.ServiceDispatcher(lease_ttl_s=5.0).start()
    workers = [jservice.DecodeWorker(d.addr, worker_id=w, drain_grace_s=0.05).start()
               for w in ("w-a", "w-b")]
    try:
        for w in workers:
            assert w.wait_registered(10)
        s = elastic.FleetScaler(
            [elastic.DispatcherHandle(d.addr, timeout=2.0)], lambda: None,
            aggregator=FakeAggregator(running=False),
            policy=elastic.ScalerPolicy(hysteresis=1, cooldown_s=0.0, min_workers=1,
                                        max_workers=4),
        )
        _drained_by(s, workers[1], d)
        assert JMETRICS.counter("elastic.drains") == 1  # the JAX dispatcher's goodbye
        assert METRICS.counter("elastic.scale_downs") == 1
        assert d.status()["scaler"]["last_decision"]["victim"] == "w-b"
    finally:
        for w in workers:
            w.stop()
        d.stop()


# ---------------------------------------------------------------------------
# The JAX doctor's federated serve-status over port dispatchers
# ---------------------------------------------------------------------------


def _doctor(*argv):
    proc = subprocess.run([sys.executable, DOCTOR, "serve-status", *argv],
                          capture_output=True, text=True, env=SUB_ENV, timeout=120)
    return proc.returncode, [json.loads(ln) for ln in proc.stdout.splitlines() if ln]


class TestDoctorFederated:
    def test_two_partitions_exit_0_with_ha_summary(self):
        d0 = service.ServiceDispatcher(lease_ttl_s=5.0).start()
        d1 = service.ServiceDispatcher(lease_ttl_s=5.0).start()
        try:
            _register(d0, "w0")
            _register(d1, "w0")  # registered with every partition
            rc, events = _doctor(f"{d0.addr},{d1.addr}", "--timeout", "2")
            assert rc == 0
            services = [e for e in events if e["event"] == "service"]
            assert [e["partition"] for e in services] == [0, 1]
            assert all(e["role"] == "dispatcher" and e["generation"] == 0 and e["accepting"]
                       for e in services)
            workers = [e for e in events if e["event"] == "worker"]
            assert {e["partition"] for e in workers} == {0, 1}
            (ha,) = [e for e in events if e["event"] == "ha"]
            assert ha["partitions"] == 2 and ha["answered"] == 2
            assert ha["acting_primaries"] == 2 and ha["failed_over"] == 0
            assert ha["workers"] == 1  # deduped across partitions
        finally:
            d0.stop()
            d1.stop()

    def test_unreachable_partition_exits_2(self):
        d0 = service.ServiceDispatcher(lease_ttl_s=5.0).start()
        try:
            rc, events = _doctor(f"{d0.addr},127.0.0.1:9", "--timeout", "1")
            assert rc == 2
            (err,) = [e for e in events if e["event"] == "error"]
            assert err["partition"] == 1
            (ha,) = [e for e in events if e["event"] == "ha"]
            assert ha["answered"] == 1 and ha["partitions"] == 2
        finally:
            d0.stop()

    def test_standby_answer_counts_the_partition_alive(self, tmp_path):
        b = _standby(service, str(tmp_path / "j.json"), "127.0.0.1:9",
                     ping_interval_s=30.0).start()
        try:
            rc, events = _doctor(f"127.0.0.1:9|{b.addr}", "--timeout", "1")
            assert rc == 0  # the partition is alive, if not accepting
            (svc,) = [e for e in events if e["event"] == "service"]
            assert svc["role"] == "standby" and svc["accepting"] is False
        finally:
            b.stop()


def test_doctor_reads_a_port_partition_after_failover_with_the_scaler_line(tmp_path):
    """After the port primary dies and its port standby promotes, the JAX
    doctor exits 0 over the partition, reports the failover, and shows the
    port scaler's line, published through a handle that followed it."""
    j = str(tmp_path / "j.json")
    a = service.ServiceDispatcher(journal=j, lease_ttl_s=5.0).start()
    b = _standby(service, j, a.addr).start()
    spec = f"{a.addr}|{b.addr}"
    try:
        _register(a, "w0")
        wait_for(lambda: len(b.status()["workers"]) == 1, msg="standby journal tail")
        a.stop()
        wait_for(lambda: METRICS.counter("service.failovers") == 1, msg="standby promotion")
        _register(b, "w0")  # the worker's beat reaches the promoted standby
        s = elastic.FleetScaler([elastic.DispatcherHandle(spec, timeout=1.0)], lambda: None,
                                aggregator=FakeAggregator(),
                                policy=elastic.ScalerPolicy(min_workers=1, max_workers=4))
        assert s.step() is None
        assert b.scaler_status["workers"] == 1
        rc, events = _doctor(spec, "--timeout", "1")
        assert rc == 0, events
        (svc,) = [e for e in events if e["event"] == "service"]
        assert svc["role"] == "dispatcher" and svc["failed_over"] is True
        assert svc["generation"] == 1
        (scaler_line,) = [e for e in events if e["event"] == "scaler"]
        assert scaler_line["workers"] == 1 and scaler_line["max_workers"] == 4
    finally:
        b.stop()
        a.stop()


# ---------------------------------------------------------------------------
# The acceptance run: SIGKILL the primary mid-epoch, ride the standby
# ---------------------------------------------------------------------------


def _ready_line(proc, timeout=60.0):
    """The process's first stdout line as JSON; a process that dies or
    stays silent fails the test instead of hanging it."""
    box = {}
    t = threading.Thread(target=lambda: box.setdefault("line", proc.stdout.readline()),
                         daemon=True)
    t.start()
    t.join(timeout)
    if not box.get("line"):
        proc.kill()
        raise AssertionError(f"no ready line (rc={proc.poll()})")
    return json.loads(box["line"])


def _spawn(*argv):
    return subprocess.Popen([sys.executable, "-m", "tpu_tfrecord_torch.service", *argv],
                            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
                            env=SUB_ENV)


class TestHAChaosAcceptance:
    def test_sigkill_primary_mid_epoch_standby_takeover_byte_identical(
            self, data_dir, local_rows, tmp_path):
        """A port primary subprocess is SIGKILLed mid-epoch while two
        consumers read from two port worker subprocesses. The standby tails
        the journal, sees the death by ping loss and promotes; both
        consumers finish the epoch equal to a local read with no fallback,
        every shard served once; the doctor reports the failover, exit 0."""
        journal = str(tmp_path / "journal.json")
        prim = _spawn("dispatcher", "--journal", journal, "--lease-ttl-s", "10")
        procs = []
        standby = None
        try:
            ready = _ready_line(prim)
            assert ready["event"] == "ready" and ready["standby_of"] is None
            primary_addr = ready["addr"]
            standby = _standby(service, journal, primary_addr, lease_ttl_s=10.0).start()
            spec = f"{primary_addr}|{standby.addr}"
            procs = [_spawn("worker", "--dispatcher", spec) for _ in range(2)]
            for p in procs:
                assert _ready_line(p)["event"] == "ready"
            # the standby learns the fleet from the journal tail alone
            wait_for(lambda: len(standby.status()["workers"]) == 2, timeout=30,
                     msg="standby tailed worker registrations")

            chaos_done = threading.Event()
            gate = threading.Barrier(3, timeout=120)  # 2 consumers + chaos

            def consume(out):
                ds = make_ds(data_dir, service=spec, service_deadline_ms=3000)
                rows = []
                paused = False
                with ds.batches() as it:
                    for b in it:
                        rows.extend(batch_to_rows(b, ds.schema))
                        if len(rows) >= 40 and not paused:
                            paused = True
                            gate.wait()
                            chaos_done.wait()
                out.extend(rows)

            def chaos():
                gate.wait()
                os.kill(prim.pid, signal.SIGKILL)  # no atexit, no goodbye
                prim.wait()
                # hold the consumers until the standby has promoted; their
                # dispatcher connections are dead and their next call
                # reconnects through the partition map's rotation
                wait_for(lambda: standby.accepting, timeout=30, msg="standby promotion")
                chaos_done.set()

            outs = [[], []]
            threads = [threading.Thread(target=consume, args=(outs[k],)) for k in range(2)]
            threads.append(threading.Thread(target=chaos))
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
                assert not t.is_alive(), "acceptance run wedged"

            assert outs[0] == local_rows
            assert outs[1] == local_rows
            assert METRICS.counter("service.fallbacks") == 0
            wait_for(lambda: METRICS.counter("service.failovers") == 1, msg="failover counted")
            assert standby.accepting and standby.failed_over
            assert standby.generation == 1
            # exactly once in the books too, across the generation boundary
            assert standby.status()["shards_done"] == 6
            rc, events = _doctor(spec, "--timeout", "2")
            assert rc == 0
            (svc,) = [e for e in events if e["event"] == "service"]
            assert svc["failed_over"] is True and svc["generation"] == 1
            assert svc["role"] == "dispatcher"
        finally:
            for p in procs:
                if p.poll() is None:
                    p.terminate()
            for p in procs:
                try:
                    p.wait(timeout=10)
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait()
            if standby is not None:
                standby.stop()
            if prim.poll() is None:
                prim.kill()
                prim.wait()
