"""The port dispatcher's journal against the JAX package's.

Counterparts of ``TestJournalV2``, ``TestJournalTruncation`` and
``TestFencingAndDemotion`` of ``tests/test_service_ha.py``, run on
``tpu_tfrecord_torch.service``: the v2 layout (a snapshot line, then one
durable delta line a mutation), the v1 upgrade, compaction, replay of the
newest consistent prefix under every truncation shape (the ``torn_write``
fault kind included), the inode fence, and demotion after consecutive
journal failures. The zombie of the fencing case is a port primary whose
journal a promoted JAX standby replaced (the port's own standby and the
mixed-package failovers are in ``test_torch_service_ha.py``). Then the
cross-package replay: each package's dispatcher restarts from the
other's v1 and v2 journals with the same books.
"""

import json
import os

import pytest
import torch

torch.set_num_threads(1)

from tpu_tfrecord import service as jservice  # noqa: E402
from tpu_tfrecord.metrics import METRICS as JMETRICS  # noqa: E402
from tpu_tfrecord_torch import checkpoint, service  # noqa: E402
from tpu_tfrecord_torch.faults import FaultPlan, FaultRule, install_chaos  # noqa: E402
from tpu_tfrecord_torch.metrics import METRICS  # noqa: E402


@pytest.fixture(autouse=True)
def _reset_metrics():
    METRICS.reset()
    JMETRICS.reset()
    yield


def _register(d, wid):
    return d._handle({"op": "register_worker", "worker_id": wid,
                      "addr": f"h:{wid}", "pid": 0})


def _route(d, shard_index, exclude=()):
    return d._handle(
        {
            "op": "route",
            "job": "j",
            "path": f"/data/shard-{shard_index}",
            "shard_index": shard_index,
            "exclude": list(exclude),
        }
    )


def _journal_records(path):
    with open(path, "rb") as fh:
        data = fh.read()
    return [json.loads(ln) for ln in data.split(b"\n") if ln.strip()]


class TestJournalV2:
    def test_snapshot_plus_deltas_roundtrip(self, tmp_path):
        j = str(tmp_path / "j.json")
        d = service.ServiceDispatcher(journal=j, lease_ttl_s=5.0)
        try:
            _register(d, "w0")
            _register(d, "w1")
            assert _route(d, 0)["ok"]
            d._handle({"op": "shard_done", "job": "j",
                       "path": "/data/shard-0", "worker_id": "w0"})
        finally:
            d.stop()
        recs = _journal_records(j)
        assert recs[0]["kind"] == "snapshot"
        assert recs[0]["version"] == service.JOURNAL_VERSION
        assert recs[0]["generation"] == 0
        assert [r["kind"] for r in recs[1:]] == [
            "register", "register", "lease", "done",
        ]
        d2 = service.ServiceDispatcher(journal=j, lease_ttl_s=5.0)
        try:
            st = d2.status()
            assert {w["worker_id"] for w in st["workers"]} == {"w0", "w1"}
            assert st["shards_done"] == 1 and st["active_leases"] == 0
        finally:
            d2.stop()

    def test_v1_journal_upgraded_in_place(self, tmp_path):
        j = str(tmp_path / "j.json")
        with open(j, "wb") as fh:
            fh.write(json.dumps({
                "workers": {"w0": {"addr": "h:w0", "pid": 7}},
                "leases": {"t/data-0": "w0"},
                "done": {},
                "reassignments": 3,
            }).encode())
        d = service.ServiceDispatcher(journal=j, lease_ttl_s=5.0)
        try:
            st = d.status()
            assert [w["worker_id"] for w in st["workers"]] == ["w0"]
            assert st["active_leases"] == 1
            assert st["lease_reassignments"] == 3
        finally:
            d.stop()
        # birth compaction rewrote the legacy object as a v2 snapshot line
        recs = _journal_records(j)
        assert len(recs) == 1
        assert recs[0]["kind"] == "snapshot"
        assert recs[0]["version"] == service.JOURNAL_VERSION

    def test_compaction_bounds_the_delta_tail(self, tmp_path, monkeypatch):
        monkeypatch.setattr(service, "JOURNAL_COMPACT_EVERY", 4)
        j = str(tmp_path / "j.json")
        d = service.ServiceDispatcher(journal=j, lease_ttl_s=5.0)
        try:
            for i in range(10):
                _register(d, f"w{i}")
            recs = _journal_records(j)
            # 10 appends with compaction every 4: the file is snapshot +
            # at most 3 trailing deltas, never the raw mutation history
            assert recs[0]["kind"] == "snapshot"
            assert len(recs) <= 4
            assert len(recs[0]["workers"]) >= 7
        finally:
            d.stop()


# ---------------------------------------------------------------------------
# Truncation replay: newest consistent prefix
# ---------------------------------------------------------------------------


class TestJournalTruncation:
    def test_empty_journal_is_a_fresh_start(self, tmp_path):
        j = str(tmp_path / "j.json")
        open(j, "wb").close()
        d = service.ServiceDispatcher(journal=j, lease_ttl_s=5.0)
        try:
            assert d.status()["workers"] == []
            assert d.accepting
        finally:
            d.stop()

    def test_torn_final_line_drops_only_the_tail(self, tmp_path):
        j = str(tmp_path / "j.json")
        d = service.ServiceDispatcher(journal=j, lease_ttl_s=5.0)
        try:
            _register(d, "w0")
            _register(d, "w1")
        finally:
            d.stop()
        with open(j, "ab") as fh:
            fh.write(b'{"kind": "register", "worker_id": "w')  # no newline
        d2 = service.ServiceDispatcher(journal=j, lease_ttl_s=5.0)
        try:
            st = d2.status()
            assert {w["worker_id"] for w in st["workers"]} == {"w0", "w1"}
            assert d2.accepting
        finally:
            d2.stop()

    def test_mid_record_tear_keeps_the_prefix_before_it(self, tmp_path):
        """A tear in the MIDDLE of the file (a record that is complete as
        a line but not as JSON): everything before it replays, everything
        after it is ignored — records past a tear were written by a
        writer that already knew its append failed."""
        j = str(tmp_path / "j.json")
        snap = {"kind": "snapshot", "version": 2, "generation": 0,
                "workers": {}, "leases": {}, "done": {}}
        with open(j, "wb") as fh:
            fh.write(json.dumps(snap).encode() + b"\n")
            fh.write(b'{"kind": "register", "worker_id": "w0", '
                     b'"addr": "h:0", "pid": 0}\n')
            fh.write(b'{"kind": "regis\n')  # torn, newline landed
            fh.write(b'{"kind": "register", "worker_id": "w1", '
                     b'"addr": "h:1", "pid": 0}\n')
        d = service.ServiceDispatcher(journal=j, lease_ttl_s=5.0)
        try:
            st = d.status()
            assert [w["worker_id"] for w in st["workers"]] == ["w0"]
        finally:
            d.stop()

    def test_parse_journal_units(self):
        parse = service.ServiceDispatcher._parse_journal
        assert parse(b"") == []
        assert parse(b"   \n") == []
        snap = json.dumps({"kind": "snapshot", "generation": 1}).encode()
        assert parse(snap + b"\n")[0]["generation"] == 1
        # torn tail after the last newline is dropped by construction
        assert len(parse(snap + b"\n" + b'{"kind": "reg')) == 1
        # a complete line WITHOUT a "kind" ends the consistent prefix
        assert len(parse(snap + b"\n" + b'{"nope": 1}\n' + snap + b"\n")) == 1

    def test_torn_write_fault_kind_pins_crash_mid_append(self, tmp_path):
        """Tear a journal append at a byte cap with the
        ``torn_write`` fault kind (the exact bytes a host crash
        mid-append leaves behind), then replay — the torn record is
        absorbed, the prefix survives, and the failure was counted."""
        j = str(tmp_path / "j.json")
        plan = FaultPlan(
            [FaultRule(op="journal", kind="torn_write", cap_bytes=12,
                       ordinal=1)]  # ordinal 0 is the birth compaction
        )
        with install_chaos(plan):
            d = service.ServiceDispatcher(journal=j, lease_ttl_s=5.0)
            try:
                _register(d, "w0")  # this append tears
            finally:
                d.stop()
        fired = [e for e in plan.ledger if e["kind"] == "torn_write"]
        assert len(fired) == 1 and fired[0]["cap_bytes"] == 12
        assert METRICS.counter("service.journal_errors") == 1
        with open(j, "rb") as fh:
            data = fh.read()
        # 12 record bytes landed after the snapshot's newline — a torn
        # tail, not a parseable record
        tail = data.split(b"\n")[-1]
        assert len(tail) == 12
        d2 = service.ServiceDispatcher(journal=j, lease_ttl_s=5.0)
        try:
            assert d2.status()["workers"] == []  # torn register absorbed
            assert d2.accepting
        finally:
            d2.stop()


# ---------------------------------------------------------------------------
# Fencing + self-demotion
# ---------------------------------------------------------------------------


class TestFencingAndDemotion:
    def test_durable_append_fences_before_any_byte_lands(self, tmp_path):
        p = str(tmp_path / "log")
        checkpoint.durable_write(p, b"a\n")
        ino = os.stat(p).st_ino
        assert checkpoint.durable_append(p, b"b\n", expect_ino=ino) == ino
        checkpoint.durable_write(p, b"replaced\n")  # new inode
        with pytest.raises(checkpoint.FencedWriteError):
            checkpoint.durable_append(p, b"stale\n", expect_ino=ino)
        with open(p, "rb") as fh:
            assert fh.read() == b"replaced\n"

    def test_resurrected_zombie_is_fenced_and_demoted(self, tmp_path):
        """The zero-duplicate-grants pin: after a standby promotes, the
        old primary's very next journaled mutation hits the inode fence,
        lands zero bytes, and demotes it — every later lease op is
        rejected with ``not_primary``."""
        j = str(tmp_path / "j.json")
        a = service.ServiceDispatcher(journal=j, lease_ttl_s=5.0)
        b = None
        try:
            _register(a, "w0")
            assert _route(a, 0)["worker_id"] == "w0"
            # the successor: a JAX standby over the port primary's journal
            b = jservice.ServiceDispatcher(
                journal=j, standby_of=a.addr, lease_ttl_s=5.0,
                takeover_addr=False,
            )
            b.promote()
            assert b.accepting and b.generation == 1 and b.failed_over
            # the zombie still believes it is primary; one mutation is
            # all it gets
            assert a.accepting
            _register(a, "w9")
            assert METRICS.counter("service.fenced_writes") == 1
            assert METRICS.counter("service.demotions") == 1
            assert not a.accepting
            r = _route(a, 1)
            assert r["error"] == "not_primary" and r["demoted"] is True
            # not a single stale byte interleaved into the successor's
            # journal: it is exactly the generation-1 snapshot
            recs = _journal_records(j)
            assert recs[0]["generation"] == 1
            assert all("w9" not in json.dumps(r) for r in recs)
            assert METRICS.counter("service.not_primary_rejects") >= 1
        finally:
            a.stop()
            if b is not None:
                b.stop()

    def test_demotes_after_n_consecutive_journal_failures(self, tmp_path):
        j = str(tmp_path / "j.json")
        plan = FaultPlan(
            [FaultRule(op="journal", kind="permanent_error", ordinal=1,
                       times=None)]
        )
        with install_chaos(plan):
            d = service.ServiceDispatcher(
                journal=j, lease_ttl_s=5.0, demote_after=3
            )
            try:
                _register(d, "w0")
                _register(d, "w1")
                assert d.accepting  # 2 failures < demote_after
                _register(d, "w2")
                assert not d.accepting
                assert METRICS.counter("service.demotions") == 1
                assert METRICS.counter("service.journal_errors") == 3
                r = _route(d, 0)
                assert r["error"] == "not_primary" and r["demoted"] is True
                # and it tells pingers honestly — takeover bait for a
                # standby that would recover journaled (consistent) state
                ping = d._handle({"op": "ping"})
                assert ping["ok"] and ping["accepting"] is False
            finally:
                d.stop()

    def test_dirty_journal_heals_by_compaction_on_next_write(self, tmp_path):
        """One failed append leaves an undefined tail; the next mutation
        must rewrite the whole journal as a fresh snapshot (covering both
        mutations), clearing the failure streak."""
        j = str(tmp_path / "j.json")
        plan = FaultPlan(
            [FaultRule(op="journal", kind="permanent_error", ordinal=1,
                       times=1)]
        )
        with install_chaos(plan):
            d = service.ServiceDispatcher(
                journal=j, lease_ttl_s=5.0, demote_after=3
            )
            try:
                _register(d, "w0")  # append fails -> dirty
                _register(d, "w1")  # heals: full snapshot compaction
                recs = _journal_records(j)
                assert len(recs) == 1 and recs[0]["kind"] == "snapshot"
                assert set(recs[0]["workers"]) == {"w0", "w1"}
                assert d.accepting
                assert d._journal_fail_streak == 0
            finally:
                d.stop()


# ---------------------------------------------------------------------------
# Cross-package replay: either dispatcher restarts from the other's journal
# ---------------------------------------------------------------------------

PACKAGES = {"port": service, "jax": jservice}


def _books(d):
    """The replayed books a restart must keep, from ``status()``."""
    st = d.status()
    return {
        "workers": [(w["worker_id"], w["addr"], w["pid"], w["leases"], w["shards_done"])
                    for w in st["workers"]],
        **{k: st[k] for k in ("lease_reassignments", "shards_done", "active_leases",
                              "tenants", "generation", "trace_id")},
    }


@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port")])
def test_v2_journal_replays_in_the_other_package(tmp_path, writer, reader):
    j = str(tmp_path / "j.json")
    d = PACKAGES[writer].ServiceDispatcher(journal=j, lease_ttl_s=5.0)
    try:
        for w in ("w0", "w1", "w2"):
            _register(d, w)
        for s in range(4):
            _route(d, s)
        _route(d, 1, exclude=[_route(d, 1)["worker_id"]])  # one reassignment
        d._handle({"op": "shard_done", "job": "j", "path": "/data/shard-0",
                   "worker_id": "w0", "cached": True})
        d._handle({"op": "shard_done", "job": "j", "path": "/data/shard-2",
                   "worker_id": "w2"})
        want = _books(d)
    finally:
        d.stop()
    assert [r["kind"] for r in _journal_records(j)][0] == "snapshot"
    again = PACKAGES[writer].ServiceDispatcher(journal=j, lease_ttl_s=5.0)
    other = None
    try:
        assert _books(again) == want  # the writer's own restart
    finally:
        again.stop()
    other = PACKAGES[reader].ServiceDispatcher(journal=j, lease_ttl_s=5.0)
    try:
        assert _books(other) == want
        assert want["lease_reassignments"] == 1 and want["shards_done"] == 2
        assert other.accepting
    finally:
        other.stop()


@pytest.mark.parametrize("first,second", [("port", "jax"), ("jax", "port")])
def test_v1_journal_replays_and_upgrades_alike(tmp_path, first, second):
    """A v1 journal (one JSON object) replays to the same books in both
    packages, and the v2 snapshot one package upgrades it to replays in
    the other."""
    legacy = json.dumps({
        "workers": {"w0": {"addr": "h:w0", "pid": 7}, "w1": {"addr": "h:w1", "pid": 8}},
        "leases": {"t/data-0": "w0", "t/data-1": "w1"},
        "done": {"t/data-2": "w1"},
        "reassignments": 3,
    }).encode()
    books = {}
    for pkg in (first, second):
        j = str(tmp_path / f"{pkg}.json")
        with open(j, "wb") as fh:
            fh.write(legacy)
        d = PACKAGES[pkg].ServiceDispatcher(journal=j, lease_ttl_s=5.0)
        try:
            books[pkg] = _books(d)
        finally:
            d.stop()
        (rec,) = _journal_records(j)
        assert rec["kind"] == "snapshot" and rec["version"] == 2
    strip = [{k: v for k, v in b.items() if k != "trace_id"} for b in books.values()]
    assert strip[0] == strip[1]
    assert strip[0]["lease_reassignments"] == 3 and strip[0]["active_leases"] == 2
    # the first package's upgraded journal, replayed by the second
    d = PACKAGES[second].ServiceDispatcher(journal=str(tmp_path / f"{first}.json"),
                                           lease_ttl_s=5.0)
    try:
        assert _books(d) == books[first]
    finally:
        d.stop()


def test_jax_drain_and_goodbye_records_fold_in_the_port(tmp_path):
    """A JAX journal may carry ``drain`` and ``goodbye`` records (its
    elastic scale-down); the port folds them as JAX does."""
    j = str(tmp_path / "j.json")
    d = jservice.ServiceDispatcher(journal=j, lease_ttl_s=5.0)
    try:
        for w in ("w0", "w1", "w2"):
            _register(d, w)
        _route(d, 0)
        assert d.drain("w1")
        d._handle({"op": "goodbye", "worker_id": "w2"})
        want = d.status()
    finally:
        d.stop()
    p = service.ServiceDispatcher(journal=j, lease_ttl_s=5.0)
    try:
        got = p.status()
        assert got["draining"] == want["draining"] == ["w1"]
        assert [w["worker_id"] for w in got["workers"]] == ["w0", "w1"]
        assert p._handle({"op": "heartbeat", "worker_id": "w1"})["drain"] is True
    finally:
        p.stop()
