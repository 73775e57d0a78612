"""The port's data service (``tpu_tfrecord_torch.service``) against the
JAX package's.

One counterpart of each test of ``tests/test_service.py``, run on the port:
the wire protocol and the socket-fault seam, the dispatcher's leasing and
journal replay, reads through the service equal to local reads, exactly
once under worker death, dispatcher restart and redelivery, the local
fallback, resume states shared with local iterators, the options, the
JAX doctor's ``serve-status`` against a port dispatcher, and the chaos
run (three ``python -m tpu_tfrecord_torch.service worker`` subprocesses
feeding two consumers, one SIGKILLed, the dispatcher restarted from its
journal). Then ``TestPartitionMap`` and ``TestPartitionedRouting`` of
``tests/test_service_ha.py``, and the cross-package cases: equal job
specs and digests, mixed fleets (a JAX dispatcher leasing port workers to
a port consumer, a port dispatcher leasing a JAX worker to a JAX
consumer) whose rows equal a local read. Last, the warm standby's
``not_primary`` reply and promotion, ``drain`` in process and on the
wire, the dispatcher CLI's standby and elastic flags against the JAX
CLI's, and the ``elastic_*`` options against the JAX parser (the
standby's and the scaler's own suites are ``test_torch_service_ha.py``
and ``test_torch_elastic.py``).

The subprocess cases wait on events and on the processes' own lines,
never on a fixed wall-clock budget for a worker's death.
"""

import json
import os
import signal
import socket
import struct
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

from tpu_tfrecord import service as jservice  # noqa: E402
from tpu_tfrecord.columnar import batch_to_rows as jbatch_to_rows  # noqa: E402
from tpu_tfrecord.io.dataset import TFRecordDataset as JDataset  # noqa: E402
from tpu_tfrecord.metrics import METRICS as JMETRICS  # noqa: E402
from tpu_tfrecord.schema import StructType as JStructType  # noqa: E402
from tpu_tfrecord_torch import service  # noqa: E402
from tpu_tfrecord_torch import service_protocol as sp  # noqa: E402
from tpu_tfrecord_torch.columnar import batch_to_rows, slice_batch  # noqa: E402
from tpu_tfrecord_torch.faults import (  # noqa: E402
    FaultPlan,
    FaultRule,
    InjectedFault,
    install_chaos,
)
from tpu_tfrecord_torch.io.dataset import TFRecordDataset  # noqa: E402
from tpu_tfrecord_torch.io.paths import interleave, interleave_owner  # noqa: E402
from tpu_tfrecord_torch.io.writer import DatasetWriter  # noqa: E402
from tpu_tfrecord_torch.metrics import METRICS  # noqa: E402
from tpu_tfrecord_torch.options import TFRecordOptions  # noqa: E402
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
        StructField("s", StringType()),  # nullable: exercises the mask
        StructField("arr", ArrayType(LongType())),  # ragged
    ]
)
# every 7th string null -> mask sections cross the wire too
ROWS = [
    [i, None if i % 7 == 0 else f"v{i}" * (i % 3 + 1), list(range(i % 5))]
    for i in range(180)
]
PER_SHARD = 30  # 6 shards


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


def make_ds(data_dir, state=None, **kw):
    return TFRecordDataset(
        data_dir, batch_size=8, schema=SCHEMA, drop_remainder=False,
        num_epochs=1, **kw,
    )


def collect(data_dir, state=None, n=None, **kw):
    """Rows from up to ``n`` batches (None = the whole epoch); with n set,
    also returns the iterator state at the pause point."""
    ds = make_ds(data_dir, **kw)
    got = []
    with ds.batches(state) as it:
        if n is None:
            for b in it:
                got.extend(batch_to_rows(b, ds.schema))
            return got
        for _ in range(n):
            got.extend(batch_to_rows(next(it), ds.schema))
        return got, it.state()


@pytest.fixture
def local_rows(data_dir):
    return collect(data_dir)


@pytest.fixture
def dispatcher():
    d = service.ServiceDispatcher(lease_ttl_s=5.0).start()
    yield d
    d.stop()


def start_workers(dispatcher, k, **kw):
    workers = [service.DecodeWorker(dispatcher.addr, **kw).start() for _ in range(k)]
    for w in workers:
        assert w.wait_registered(10), "worker failed to register"
    return workers


@pytest.fixture
def fleet(dispatcher):
    workers = start_workers(dispatcher, 2)
    yield dispatcher, workers
    for w in workers:
        w.stop()


# ---------------------------------------------------------------------------
# Wire protocol
# ---------------------------------------------------------------------------


class TestProtocol:
    def test_parse_addr(self):
        assert sp.parse_addr("h:1") == ("h", 1)
        assert sp.parse_addr("::1:80") == ("::1", 80)
        for bad in ("h", ":80", "h:"):
            with pytest.raises(ValueError):
                sp.parse_addr(bad)

    def test_frame_round_trip(self):
        a, b = socket.socketpair()
        try:
            sp.send_frame(a, b"hello world")
            assert sp.recv_frame(b, "peer") == b"hello world"
            sp.send_msg(a, {"op": "ping", "k": 1})
            assert sp.recv_msg(b, "peer") == {"op": "ping", "k": 1}
        finally:
            a.close()
            b.close()

    def test_clean_eof_at_boundary_is_none_elsewhere_loud(self):
        a, b = socket.socketpair()
        a.close()
        try:
            assert sp.recv_msg(b, "peer", allow_eof=True) is None
            with pytest.raises(sp.ProtocolError, match="short frame"):
                sp.recv_frame(b, "peer")  # allow_eof=False: EOF is a death
        finally:
            b.close()

    def test_mid_frame_close_is_short_frame(self):
        a, b = socket.socketpair()
        try:
            payload = b"x" * 64
            from tpu_tfrecord_torch import wire

            a.sendall(struct.pack("<II", len(payload), wire.masked_crc32c(payload)))
            a.sendall(payload[:10])
            a.close()
            with pytest.raises(sp.ProtocolError, match="short frame"):
                sp.recv_frame(b, "peer")
        finally:
            b.close()

    def test_crc_mismatch_loud(self):
        a, b = socket.socketpair()
        try:
            payload = b"payload-bytes"
            a.sendall(struct.pack("<II", len(payload), 0xDEAD))
            a.sendall(payload)
            with pytest.raises(sp.ProtocolError, match="CRC mismatch"):
                sp.recv_frame(b, "peer")
        finally:
            a.close()
            b.close()

    def test_absurd_length_rejected_before_allocation(self):
        a, b = socket.socketpair()
        try:
            a.sendall(struct.pack("<II", sp.MAX_CONTROL_FRAME + 1, 0))
            with pytest.raises(sp.ProtocolError, match="exceeds"):
                sp.recv_frame(b, "peer")
        finally:
            a.close()
            b.close()

    def test_non_object_message_loud(self):
        a, b = socket.socketpair()
        try:
            sp.send_frame(a, b"[1, 2]")
            with pytest.raises(sp.ProtocolError, match="malformed"):
                sp.recv_msg(b, "peer")
            sp.send_frame(a, b"\xff\xfe not json")
            with pytest.raises(sp.ProtocolError, match="malformed"):
                sp.recv_msg(b, "peer")
        finally:
            a.close()
            b.close()

    def _chunk_of(self, data_dir):
        ds = make_ds(data_dir)
        chunk = next(ds._decode_shard(0, 0, 0, 0))[0]
        return ds, chunk

    def _round_trip(self, ds, chunk, verify=True, corrupt=None):
        a, b = socket.socketpair()
        try:
            t = threading.Thread(target=sp.send_chunk, args=(a, chunk, 0, 0))
            t.start()
            header = sp.recv_msg(b, "peer")
            if corrupt is not None:
                corrupt(header)
            try:
                return sp.recv_chunk_body(
                    b, header, "peer", ds.chunk_dtypes().__getitem__, verify
                )
            finally:
                t.join()
        finally:
            a.close()
            b.close()

    def test_chunk_round_trip_identical_rows_and_order(self, data_dir):
        """Decoded rows AND column order survive the wire — order matters
        because downstream batch assembly is order-sensitive (regression:
        a sorted-by-name wire order permuted every non-alphabetical
        schema)."""
        ds, chunk = self._chunk_of(data_dir)
        got = self._round_trip(ds, chunk)
        assert list(got.columns) == list(chunk.columns)
        assert batch_to_rows(got, ds.schema) == batch_to_rows(chunk, ds.schema)

    def test_chunk_section_crc_verified(self, data_dir):
        ds, chunk = self._chunk_of(data_dir)

        def flip(header):
            header["cols"][0]["sections"][0]["crc"] ^= 1

        with pytest.raises(sp.ProtocolError, match="section CRC mismatch"):
            self._round_trip(ds, chunk, corrupt=flip)
        # verify=False skips the stamp check: the flip goes unnoticed
        got = self._round_trip(ds, chunk, verify=False, corrupt=flip)
        assert batch_to_rows(got, ds.schema) == batch_to_rows(chunk, ds.schema)

    def test_chunk_section_overrun_loud(self, data_dir):
        ds, chunk = self._chunk_of(data_dir)

        def grow(header):
            header["cols"][-1]["sections"][-1]["nbytes"] += 8

        with pytest.raises(sp.ProtocolError):
            self._round_trip(ds, chunk, corrupt=grow)


# ---------------------------------------------------------------------------
# Socket-fault seam (faults.FaultPlan connect/recv rules)
# ---------------------------------------------------------------------------


class TestSocketChaos:
    def test_connect_refused_rule(self):
        plan = FaultPlan([FaultRule(op="connect", kind="transient_error")])
        with pytest.raises(InjectedFault):
            plan.apply_socket("connect", "h:1")
        assert plan.ledger[0]["op"] == "connect"

    def test_recv_stall_uses_injected_sleep(self):
        slept = []
        plan = FaultPlan(
            [FaultRule(op="recv", kind="stall", stall_ms=250.0)],
            sleep=slept.append,
        )
        plan.apply_socket("recv", "h:1", size=64)
        assert slept == [0.25]

    def test_recv_short_read_caps_but_recv_loop_refills(self):
        """A capped recv returns a partial segment; _recv_exact must loop
        and still assemble the exact frame."""
        plan = FaultPlan(
            [FaultRule(op="recv", kind="short_read", cap_bytes=3, times=2)]
        )
        a, b = socket.socketpair()
        try:
            sp._CHAOS_PLAN = plan
            sp.send_msg(a, {"op": "ping", "pad": "x" * 200})
            assert sp.recv_msg(b, "peer") == {"op": "ping", "pad": "x" * 200}
        finally:
            sp._CHAOS_PLAN = None
            a.close()
            b.close()
        capped = [e for e in plan.ledger if e["kind"] == "short_read"]
        assert len(capped) == 2 and all(e["cap_bytes"] == 3 for e in capped)

    def test_recv_disconnect_closes_socket_and_raises(self):
        plan = FaultPlan([FaultRule(op="recv", kind="disconnect")])
        a, b = socket.socketpair()
        try:
            with pytest.raises(InjectedFault):
                plan.apply_socket("recv", "h:1", sock=b, size=16)
            # the local side observes a closed socket, like a real death
            with pytest.raises(OSError):
                b.recv(1)
        finally:
            a.close()
            b.close()

    def test_ledger_replayable(self):
        """Same plan JSON, same call sequence => byte-identical ledger —
        socket faults ride the SAME seeded, replayable machinery as file
        faults."""

        def run():
            plan = FaultPlan.from_json(
                {
                    "seed": 7,
                    "rules": [
                        {"op": "connect", "kind": "transient_error",
                         "probability": 0.5, "times": None},
                        {"op": "recv", "kind": "short_read", "cap_bytes": 9,
                         "ordinal": 2, "times": 3},
                    ],
                }
            )
            for i in range(10):
                try:
                    plan.apply_socket("connect", "h:1")
                except InjectedFault:
                    pass
                plan.apply_socket("recv", "h:1", size=100)
            return plan.ledger_json()

        first = run()
        assert first and first == run()

    def test_install_chaos_reaches_service_sockets(self, dispatcher, data_dir,
                                                   local_rows):
        """A seeded mid-stream disconnect on the consumer's recv of the
        worker chunk stream: the client reconnects, re-requests from its
        acked offset, and the epoch is STILL byte-identical — with the
        fault in the plan's ledger and the recovery in the counters.
        Workers bind a second loopback address so the rule's path
        substring targets EXACTLY the consumer->worker data stream (the
        dispatcher RPCs and worker heartbeats stay fault-free)."""
        d = dispatcher
        workers = start_workers(d, 2, host="127.1.0.1")
        plan = FaultPlan(
            [
                # ordinal deep enough to land mid-chunk-stream, times=1 so
                # the retry goes through clean
                FaultRule(op="recv", kind="disconnect", path="127.1.0.1",
                          ordinal=9, times=1),
            ]
        )
        try:
            with install_chaos(plan):
                got = collect(data_dir, service=d.addr, service_deadline_ms=2000)
        finally:
            for w in workers:
                w.stop()
        assert got == local_rows
        fired = [e for e in plan.ledger if e["kind"] == "disconnect"]
        assert len(fired) == 1 and fired[0]["op"] == "recv"
        assert METRICS.counter("service.reconnects") >= 1
        assert METRICS.counter("service.fallbacks") == 0


# ---------------------------------------------------------------------------
# Dispatcher: leasing, expiry, journal replay
# ---------------------------------------------------------------------------


def _route(d, shard_index, path=None, exclude=()):
    return d._handle(
        {
            "op": "route",
            "job": "j",
            "path": path or f"/data/shard-{shard_index}",
            "shard_index": shard_index,
            "exclude": list(exclude),
        }
    )


class TestDispatcher:
    def test_route_is_interleaved_over_alive_workers(self):
        now = [0.0]
        d = service.ServiceDispatcher(lease_ttl_s=5.0, clock=lambda: now[0])
        try:
            for i in range(3):
                d._handle({"op": "register_worker", "worker_id": f"w{i}",
                           "addr": f"h:{i}", "pid": i})
            wids = sorted(f"w{i}" for i in range(3))
            for s in range(6):
                r = _route(d, s)
                assert r["worker_id"] == wids[interleave_owner(s, 3)]
        finally:
            d.stop()

    def test_lease_expiry_and_reassignment_count(self):
        """A silent worker's lease expires at the TTL (injected clock) and
        its shard re-routes with the reassignment counted; a lease that
        merely MOVES because the fleet grew is rebalancing, not failure."""
        now = [0.0]
        d = service.ServiceDispatcher(lease_ttl_s=5.0, clock=lambda: now[0])
        try:
            d._handle({"op": "register_worker", "worker_id": "w0",
                       "addr": "h:0", "pid": 0})
            assert _route(d, 0)["worker_id"] == "w0"
            # fleet grows; shard 0 now interleaves to the other worker —
            # NOT a reassignment (w0 is alive and not excluded)
            d._handle({"op": "register_worker", "worker_id": "w1",
                       "addr": "h:1", "pid": 1})
            moved = _route(d, 1, path="/data/shard-0b")
            assert d.status()["lease_reassignments"] == 0
            # w0 goes silent past the TTL: its shard re-routes, counted
            now[0] = 6.0
            d._handle({"op": "heartbeat", "worker_id": "w1"})
            r = _route(d, 0)
            assert r["worker_id"] == "w1"
            st = d.status()
            assert st["lease_reassignments"] == 1
            assert [w["alive"] for w in st["workers"]] == [False, True]
            del moved
        finally:
            d.stop()

    def test_excluded_by_witness_counts_before_ttl(self):
        """A consumer that WATCHED its worker die excludes it on re-route;
        the reassignment counts immediately — no TTL wait."""
        now = [0.0]
        d = service.ServiceDispatcher(lease_ttl_s=5.0, clock=lambda: now[0])
        try:
            for i in range(2):
                d._handle({"op": "register_worker", "worker_id": f"w{i}",
                           "addr": f"h:{i}", "pid": i})
            first = _route(d, 0)["worker_id"]
            other = {"w0": "w1", "w1": "w0"}[first]
            r = _route(d, 0, exclude=[first])
            assert r["worker_id"] == other
            assert d.status()["lease_reassignments"] == 1
        finally:
            d.stop()

    def test_all_excluded_falls_back_to_alive(self):
        d = service.ServiceDispatcher(lease_ttl_s=5.0)
        try:
            d._handle({"op": "register_worker", "worker_id": "w0",
                       "addr": "h:0", "pid": 0})
            r = _route(d, 0, exclude=["w0"])
            assert r["worker_id"] == "w0"  # a flaky worker beats no worker
        finally:
            d.stop()

    def test_no_workers_is_an_error_reply(self):
        d = service.ServiceDispatcher(lease_ttl_s=5.0)
        try:
            assert _route(d, 0)["error"] == "no_workers"
        finally:
            d.stop()

    def test_proto_version_skew_rejected(self):
        d = service.ServiceDispatcher(lease_ttl_s=5.0)
        try:
            r = d._handle({"op": "route", "proto": 999})
            assert r["error"] == "proto_mismatch"
        finally:
            d.stop()

    def test_journal_replay_restores_assignment_state(self, tmp_path):
        """Kill the dispatcher, restart it from the journal: workers,
        leases, done set, reassignment count, and the trace identity all
        survive — the control plane forgets nothing but heartbeat
        freshness (which workers re-supply)."""
        journal = str(tmp_path / "journal.json")
        d = service.ServiceDispatcher(lease_ttl_s=5.0, journal=journal)
        try:
            for i in range(2):
                d._handle({"op": "register_worker", "worker_id": f"w{i}",
                           "addr": f"h:{i}", "pid": 100 + i})
            _route(d, 0)
            _route(d, 1, exclude=[_route(d, 1)["worker_id"]])
            d._handle({"op": "shard_done", "job": "j", "path": "/data/shard-0",
                       "worker_id": "w0"})
            before = d.status()
        finally:
            d.stop()
        d2 = service.ServiceDispatcher(lease_ttl_s=5.0, journal=journal)
        try:
            after = d2.status()
            for key in ("lease_reassignments", "shards_done", "active_leases",
                        "trace_id"):
                assert after[key] == before[key], key
            assert [w["worker_id"] for w in after["workers"]] == ["w0", "w1"]
            # replayed workers get one TTL of grace, then must re-heartbeat
            assert all(w["alive"] for w in after["workers"])
        finally:
            d2.stop()

    def test_unreadable_journal_is_loud(self, tmp_path):
        # an unreadable FILE (a directory at the journal path reads as
        # EISDIR) is loud — silently starting fresh would orphan every
        # lease the real journal records
        journal = str(tmp_path / "journal.json")
        os.mkdir(journal)
        with pytest.raises(RuntimeError, match="unreadable dispatcher journal"):
            service.ServiceDispatcher(journal=journal)

    def test_torn_journal_content_replays_consistent_prefix(self, tmp_path):
        # torn CONTENT is not an error: a crash mid-append
        # legitimately leaves a partial tail, and replay folds the newest
        # consistent prefix (here: nothing) instead of refusing to start
        journal = str(tmp_path / "journal.json")
        with open(journal, "w") as fh:
            fh.write("{torn")
        d = service.ServiceDispatcher(journal=journal)
        try:
            assert d.status()["workers"] == []
            assert d.accepting
        finally:
            d.stop()

    def test_shard_done_idempotent(self):
        d = service.ServiceDispatcher(lease_ttl_s=5.0)
        try:
            d._handle({"op": "register_worker", "worker_id": "w0",
                       "addr": "h:0", "pid": 0})
            _route(d, 0)
            for _ in range(2):
                d._handle({"op": "shard_done", "job": "j",
                           "path": "/data/shard-0", "worker_id": "w0"})
            assert d.status()["shards_done"] == 1
        finally:
            d.stop()


# ---------------------------------------------------------------------------
# Service-backed reads: byte-identity, failure matrix, dedupe
# ---------------------------------------------------------------------------


class TestServiceRead:
    def test_rows_byte_identical_to_local(self, fleet, data_dir, local_rows):
        d, _ = fleet
        assert collect(data_dir, service=d.addr) == local_rows
        assert METRICS.counter("service.fallbacks") == 0
        assert METRICS.counter("service.chunks_recv") > 0

    def test_two_consumers_concurrently(self, fleet, data_dir, local_rows):
        d, _ = fleet
        results = {}

        def consume(k):
            results[k] = collect(data_dir, service=d.addr)

        threads = [threading.Thread(target=consume, args=(k,)) for k in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert results[0] == local_rows and results[1] == local_rows

    def test_worker_death_mid_epoch_exactly_once(self, dispatcher, data_dir,
                                                 local_rows):
        """Kill the worker HOLDING the active lease mid-shard: the shard is
        re-routed exactly-once (witnessed exclusion, no TTL wait), the
        epoch completes byte-identical — nothing duplicated, nothing
        missing — and no fallback to local reads happened."""
        d = dispatcher
        workers = {w.worker_id: w for w in start_workers(d, 3)}
        try:
            ds = make_ds(data_dir, service=d.addr, service_deadline_ms=2000)
            got = []
            killed = False
            with ds.batches() as it:
                for b in it:
                    got.extend(batch_to_rows(b, ds.schema))
                    if not killed and len(got) >= 40:
                        # kill whichever worker holds an active lease right
                        # now (between-shards instants may have none — scan
                        # again at the next batch)
                        leases = {
                            w["worker_id"]: w["leases"]
                            for w in d.status()["workers"] if w["leases"]
                        }
                        if leases:
                            victim = next(iter(leases))
                            workers.pop(victim).stop()
                            killed = True
            assert killed, "no active lease ever observed"
            assert got == local_rows
            assert METRICS.counter("service.lease_reassignments") >= 1
            assert METRICS.counter("service.fallbacks") == 0
        finally:
            for w in workers.values():
                w.stop()

    def test_dispatcher_restart_mid_epoch(self, data_dir, local_rows, tmp_path):
        """Stop the dispatcher mid-epoch and restart it on the same port
        from its journal: workers re-register through their beat loop,
        the consumer rides its backoff through the outage, and the epoch
        completes byte-identical with no fallback."""
        journal = str(tmp_path / "journal.json")
        d = service.ServiceDispatcher(lease_ttl_s=5.0, journal=journal).start()
        port = int(d.addr.rsplit(":", 1)[1])
        workers = start_workers(d, 2)
        restarted = None
        try:
            ds = make_ds(data_dir, service=d.addr, service_deadline_ms=2000)
            got = []
            with ds.batches() as it:
                for b in it:
                    got.extend(batch_to_rows(b, ds.schema))
                    if restarted is None and len(got) >= 40:
                        d.stop()
                        restarted = service.ServiceDispatcher(
                            port=port, lease_ttl_s=5.0, journal=journal
                        ).start()
            assert restarted is not None
            assert got == local_rows
            assert METRICS.counter("service.fallbacks") == 0
        finally:
            for w in workers:
                w.stop()
            d.stop()
            if restarted is not None:
                restarted.stop()

    def test_unreachable_service_degrades_to_local(self, data_dir, local_rows):
        """No dispatcher at all: past the fallback budget the consumer
        reads the SAME shards locally — byte-identical rows, the
        degradation counted and logged."""
        got = collect(
            data_dir, service="127.0.0.1:1", service_deadline_ms=200,
            service_fallback_ms=250,
        )
        assert got == local_rows
        assert METRICS.counter("service.fallbacks") >= 1

    def test_fallback_none_never_degrades(self, data_dir):
        """service_fallback_ms=None = retry forever: the consumer must NOT
        silently read locally; it keeps trying until stopped."""
        ds = make_ds(
            data_dir, service="127.0.0.1:1", service_deadline_ms=100,
            service_fallback_ms=None,
        )
        it = ds.batches()
        t = threading.Thread(target=lambda: next(iter(it), None))
        t.start()
        t.join(timeout=1.0)
        try:
            assert t.is_alive(), "consumer fell back despite fallback=None"
            assert METRICS.counter("service.fallbacks") == 0
        finally:
            it.close()
            t.join(timeout=10)
            assert not t.is_alive()

    def test_spec_mismatch_is_loud_not_fallback(self, fleet, data_dir):
        """A consumer/worker disagreement about the dataset must raise,
        never be papered over by local fallback (divergent views of the
        data are a config bug, not a transport fault)."""
        d, _ = fleet
        ds = make_ds(data_dir, service=d.addr)
        client = service.ServiceClient(ds)
        client._spec = dict(client._spec, shards_digest="deadbeef00000000")
        try:
            with pytest.raises(service.ServiceSpecError, match="diverged"):
                list(client.shard_chunks(0, 0, 0, 0, threading.Event()))
        finally:
            client.close()

    def test_redelivered_prefix_dropped_not_double_counted(self, data_dir):
        """A fake worker redelivers: a full duplicate chunk AND a
        partially-overlapping chunk. The client's (shard, chunk-offset)
        dedupe drops the duplicate and slices the overlap — rows come out
        exactly once, in order."""
        ds = make_ds(data_dir)
        chunk0 = next(ds._decode_shard(0, 0, 0, 0))[0]
        rows0 = chunk0.num_rows
        assert rows0 >= 30
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.bind(("127.0.0.1", 0))
        srv.listen(1)
        addr = sp.format_addr("127.0.0.1", srv.getsockname()[1])

        def fake_worker():
            conn, _ = srv.accept()
            with conn:
                assert sp.recv_msg(conn, "c")["op"] == "fetch"
                sp.send_chunk(conn, slice_batch(chunk0, 0, 10), 0, 0)
                # full duplicate: must be dropped whole
                sp.send_chunk(conn, slice_batch(chunk0, 0, 10), 0, 1)
                # partial overlap (rows 7..19; 7..9 already acked): only
                # the unseen suffix may come through
                sp.send_chunk(conn, slice_batch(chunk0, 7, 20), 7, 2)
                sp.send_chunk(conn, slice_batch(chunk0, 20, rows0), 20, 3)
                sp.send_msg(conn, {"op": "eof", "chunks": 4})

        t = threading.Thread(target=fake_worker)
        t.start()
        svc_ds = make_ds(data_dir, service="127.0.0.1:1")
        client = service.ServiceClient(svc_ds)
        try:
            out = list(
                client._fetch_shard(addr, ds.shards[0].path, 0, 0, 0,
                                    threading.Event())
            )
        finally:
            client.close()
            t.join()
            srv.close()
        got = [r for item in out for r in batch_to_rows(item[0], ds.schema)]
        assert got == batch_to_rows(chunk0, ds.schema)  # exactly once,
        # in order — no dup, no hole
        # positions stay contiguous: each chunk starts where the last ended
        pos = 0
        for chunk, _e, _p, start in out:
            assert start == pos
            pos += chunk.num_rows
        assert pos == rows0
        assert METRICS.counter("service.redelivered_dropped") == 2

    def test_worker_serves_from_columnar_cache(self, dispatcher, data_dir,
                                               local_rows, tmp_path):
        """A worker with the epoch cache enabled populates on the first
        epoch and serves from mmap on the second — same bytes on the
        consumer either way."""
        d = dispatcher
        cache_dir = str(tmp_path / "cache")
        opts = TFRecordOptions.from_map(cache="auto", cache_dir=cache_dir)
        workers = start_workers(d, 1, options=opts)
        try:
            first = collect(data_dir, service=d.addr)
            assert first == local_rows
            assert METRICS.counter("cache.misses") > 0
            second = collect(data_dir, service=d.addr)
            assert second == local_rows
            assert METRICS.counter("cache.hits") > 0
        finally:
            for w in workers:
                w.stop()


# ---------------------------------------------------------------------------
# Checkpoint/resume interchange across the service boundary
# ---------------------------------------------------------------------------


class TestResumeInterchange:
    def test_service_state_resumes_locally_and_back(self, fleet, data_dir,
                                                    local_rows):
        """IteratorState is chunk-source-agnostic: a state taken mid-epoch
        from a service-backed iterator resumes on a direct local reader,
        and vice versa — all four head+tail combinations reproduce the
        epoch byte-identically."""
        d, _ = fleet
        svc = dict(service=d.addr, service_deadline_ms=2000)
        head_svc, st_svc = collect(data_dir, n=5, **svc)
        head_loc, st_loc = collect(data_dir, n=5)
        assert head_svc == head_loc == local_rows[: len(head_svc)]
        # state equality modulo source, by construction
        assert st_svc.to_json() == st_loc.to_json()
        for head, st in ((head_svc, st_svc), (head_loc, st_loc)):
            assert head + collect(data_dir, state=st) == local_rows
            assert head + collect(data_dir, state=st, **svc) == local_rows

    def test_resume_past_reassigned_shard(self, dispatcher, data_dir,
                                          local_rows):
        """Kill the lease-holding worker mid-epoch, checkpoint AFTER the
        reassignment, then resume on a fresh service AND on a local
        reader: both tails complete the epoch byte-identically."""
        d = dispatcher
        workers = {w.worker_id: w for w in start_workers(d, 3)}
        try:
            ds = make_ds(data_dir, service=d.addr, service_deadline_ms=2000)
            head = []
            st = None
            killed = False
            with ds.batches() as it:
                for b in it:
                    head.extend(batch_to_rows(b, ds.schema))
                    if not killed and len(head) >= 40:
                        leases = {
                            w["worker_id"]: w["leases"]
                            for w in d.status()["workers"] if w["leases"]
                        }
                        victim = next(iter(leases))
                        workers.pop(victim).stop()
                        killed = True
                    elif killed and st is None and \
                            METRICS.counter("service.lease_reassignments"):
                        st = it.state()
                        break
            assert killed and st is not None, "reassignment never happened"
            tail_svc = collect(data_dir, state=st, service=d.addr,
                               service_deadline_ms=2000)
            tail_loc = collect(data_dir, state=st)
            assert head + tail_loc == local_rows
            assert tail_svc == tail_loc
        finally:
            for w in workers.values():
                w.stop()


# ---------------------------------------------------------------------------
# Options plumbing
# ---------------------------------------------------------------------------


class TestOptions:
    def test_round_trip_both_spellings(self):
        o = TFRecordOptions.from_map(
            service="h:1", serviceLeaseTtlS=3.0, service_deadline_ms=100,
            serviceFallbackMs=None,
        )
        assert o.service == "h:1"
        assert o.service_lease_ttl_s == 3.0
        assert o.service_deadline_ms == 100.0
        assert o.service_fallback_ms is None

    def test_defaults(self):
        o = TFRecordOptions()
        assert o.service is None
        assert o.service_lease_ttl_s == 10.0
        assert o.service_deadline_ms == 5000.0
        assert o.service_fallback_ms == 30000.0

    def test_validation_loud(self):
        with pytest.raises(ValueError, match="host:port"):
            TFRecordOptions.from_map(service="not-an-addr")
        with pytest.raises(ValueError, match="service_lease_ttl_s"):
            TFRecordOptions.from_map(service_lease_ttl_s=0)
        with pytest.raises(ValueError, match="service_deadline_ms"):
            TFRecordOptions.from_map(service_deadline_ms=-1)
        with pytest.raises(ValueError, match="service_fallback_ms"):
            TFRecordOptions.from_map(service_fallback_ms=-1)

    def test_autotune_disabled_under_service(self, fleet, data_dir):
        """Decode parallelism lives in the worker fleet: a service-backed
        iterator must not spin up a local pool controller."""
        d, _ = fleet
        ds = make_ds(data_dir, service=d.addr, autotune="on")
        with ds.batches() as it:
            next(it)
            assert it.autotune is None

    def test_interleave_is_one_owner(self):
        items = list(range(10))
        for count in (1, 2, 3):
            split = [interleave(items, s, count) for s in range(count)]
            assert sorted(sum(split, [])) == items
            for s, part in enumerate(split):
                for it_ in part:
                    assert interleave_owner(it_, count) == s
        with pytest.raises(ValueError):
            interleave(items, 2, 2)
        with pytest.raises(ValueError):
            interleave(items, 0, 0)


# ---------------------------------------------------------------------------
# serve-status doctor
# ---------------------------------------------------------------------------


class TestServeStatusDoctor:
    def test_report_and_exit_codes(self, fleet):
        """The JAX doctor's ``serve-status`` reads a port dispatcher."""
        d, workers = fleet
        proc = subprocess.run(
            [sys.executable, DOCTOR, "serve-status", d.addr],
            capture_output=True, text=True,
            env={**os.environ, "JAX_PLATFORMS": "cpu"}, timeout=120,
        )
        assert proc.returncode == 0, proc.stderr
        lines = [json.loads(l) for l in proc.stdout.splitlines()]
        by_event = {}
        for l in lines:
            by_event.setdefault(l["event"], []).append(l)
        assert len(by_event["worker"]) == len(workers)
        for w in by_event["worker"]:
            assert w["alive"] and w["heartbeat_age_s"] < 5.0
        (summary,) = by_event["service"]
        assert summary["workers"] == len(workers)
        assert summary["alive"] == len(workers)
        assert summary["trace_id"]

    def test_unreachable_exits_2(self):
        """The doctor's transport, ``fetch_status``, raises a transport
        error on an unreachable dispatcher (the doctor's exit 2), and
        returns the status dict of a live one."""
        with pytest.raises(OSError):
            service.fetch_status("127.0.0.1:1", timeout=1.0)
        d = service.ServiceDispatcher(lease_ttl_s=5.0).start()
        try:
            st = service.fetch_status(d.addr, timeout=5.0)
            assert st["ok"] and st["role"] == "dispatcher" and st["workers"] == []
        finally:
            d.stop()


# ---------------------------------------------------------------------------
# The chaos acceptance run: subprocess workers, SIGKILL, dispatcher restart
# ---------------------------------------------------------------------------


def _ready_line(proc, timeout=60.0):
    """The process's first stdout line as JSON; a process that dies or
    stays silent fails the test instead of hanging it."""
    box = {}
    t = threading.Thread(target=lambda: box.setdefault("line", proc.stdout.readline()),
                         daemon=True)
    t.start()
    t.join(timeout)
    line = box.get("line")
    if not line:
        proc.kill()
        raise AssertionError(f"no ready line (rc={proc.poll()})")
    return json.loads(line)


def _spawn_worker_procs(dispatcher_addr, n, package="tpu_tfrecord_torch"):
    """n worker subprocesses started together (each pays its own imports),
    with their ready lines."""
    env = {
        **os.environ,
        "JAX_PLATFORMS": "cpu",
        "CUDA_VISIBLE_DEVICES": "",
        "OMP_NUM_THREADS": "1",
        "PYTHONPATH": REPO,
    }
    procs = [subprocess.Popen(
        [sys.executable, "-m", f"{package}.service", "worker",
         "--dispatcher", dispatcher_addr],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True, env=env,
    ) for _ in range(n)]
    out = []
    for proc in procs:
        ready = _ready_line(proc)
        assert ready["event"] == "ready"
        out.append((proc, ready))
    return out


class TestFailureHardening:
    """Pins for the hardening: length-field bounds, data-plane
    version skew, suspect aging, and liveness-vs-construction keepalives."""

    def test_chunk_body_length_bounds(self):
        """A chunk header announcing a negative, absurd, or non-numeric
        body length is a loud ProtocolError BEFORE any buffer allocation —
        never a bare ValueError that escapes the transport nets, never a
        huge bytearray."""
        for body in (-1, sp.MAX_CHUNK_BODY + 1, "nope"):
            header = {"op": "chunk", "start": 0, "rows": 0, "cols": [],
                      "body": body}
            with pytest.raises(sp.ProtocolError):
                sp.recv_chunk_body(None, header, "peer", {}.__getitem__)

    def test_worker_rejects_proto_skew_on_data_plane(self, dispatcher):
        """The worker's fetch loop rejects version skew as loudly as the
        dispatcher's control plane: a skewed consumer must never receive
        chunks whose section layout it would mis-parse."""
        w = service.DecodeWorker(dispatcher.addr).start()
        try:
            s = sp.connect(w.addr, timeout=5.0)
            try:
                s.settimeout(5.0)
                reply = sp.request(
                    s, w.addr, {"op": "fetch", "proto": 999, "spec": {},
                                "shard": "x"}
                )
                assert reply["kind"] == "proto_mismatch", reply
            finally:
                s.close()
        finally:
            w.stop()

    def test_route_reply_carries_dispatcher_ttl(self):
        """Consumers age suspects on the fleet's REAL reassignment clock:
        the route reply carries the dispatcher's lease TTL, so a mis-set
        local service_lease_ttl_s cannot desynchronize the client."""
        d = service.ServiceDispatcher(lease_ttl_s=7.5)
        try:
            d._handle({"op": "register_worker", "worker_id": "w0",
                       "addr": "h:0", "pid": 0})
            r = d._handle({"op": "route", "proto": service.PROTO_VERSION,
                           "job": "j", "path": "/p", "shard_index": 0,
                           "exclude": []})
            assert r["lease_ttl_s"] == 7.5
        finally:
            d.stop()

    def test_suspects_age_out_after_one_lease_ttl(self, data_dir):
        """One transient timeout must not exile a healthy worker for the
        client's lifetime: suspicion expires after one lease TTL — by then
        the dispatcher's own heartbeat accounting has caught a genuinely
        dead worker."""
        ds = make_ds(data_dir, service="127.0.0.1:1",
                     service_lease_ttl_s=5.0)
        client = service.ServiceClient(ds)
        now = [100.0]
        client._clock = lambda: now[0]
        client._suspects = {"w0": 100.0}
        assert client._live_suspects() == ["w0"]
        now[0] = 104.9
        assert client._live_suspects() == ["w0"]
        now[0] = 105.0
        assert client._live_suspects() == []
        assert client._suspects == {}

    def test_cold_construction_outlives_consumer_deadline(
        self, dispatcher, data_dir, local_rows, monkeypatch
    ):
        """A worker's first fetch pays dataset construction, which can
        exceed the consumer's per-op deadline on a loaded box: `building`
        keepalives make the deadline measure liveness, so a cold healthy
        worker costs zero reconnects and zero spurious reassignments."""
        orig = service.DecodeWorker._dataset_for

        def cold(self, spec):
            first = not self._datasets
            if first:
                time.sleep(1.0)  # >> the 400ms deadline below
            return orig(self, spec)

        monkeypatch.setattr(service.DecodeWorker, "_dataset_for", cold)
        w = service.DecodeWorker(dispatcher.addr).start()
        try:
            assert w.wait_registered(10)
            got = collect(data_dir, service=dispatcher.addr,
                          service_deadline_ms=400)
            assert got == local_rows
            assert METRICS.counter("service.reconnects") == 0
            assert dispatcher.status()["lease_reassignments"] == 0
        finally:
            w.stop()


class TestChaosAcceptance:
    def test_kill_worker_and_restart_dispatcher_mid_epoch(
        self, data_dir, local_rows, tmp_path
    ):
        """The chaos acceptance scenario: K=3 decode-worker
        subprocesses feed M=2 consumers; mid-epoch one worker is
        SIGKILLed (a real process death — no atexit, no socket
        shutdown) and the dispatcher is killed and restarted from its
        journal. Both consumers' epochs complete byte-identical to a
        direct local read — exactly-once, nothing duplicated, nothing
        missing, and none of it via local fallback."""
        journal = str(tmp_path / "journal.json")
        d = service.ServiceDispatcher(lease_ttl_s=10.0, journal=journal).start()
        port = int(d.addr.rsplit(":", 1)[1])
        addr = d.addr
        procs = []
        restarted = []
        state = {"d": d}
        try:
            procs.extend(_spawn_worker_procs(addr, 3))
            deadline = time.monotonic() + 60
            while time.monotonic() < deadline:
                if len(state["d"].status()["workers"]) == 3:
                    break
                time.sleep(0.05)
            assert len(state["d"].status()["workers"]) == 3

            chaos_done = threading.Event()
            gate = threading.Barrier(3, timeout=120)  # 2 consumers + chaos

            def consume(out):
                ds = make_ds(data_dir, service=addr, service_deadline_ms=3000)
                rows = []
                paused = False
                with ds.batches() as it:
                    for b in it:
                        rows.extend(batch_to_rows(b, ds.schema))
                        if len(rows) >= 40 and not paused:
                            paused = True
                            gate.wait()  # both consumers mid-epoch
                            chaos_done.wait()  # chaos runs while we hold
                out.extend(rows)

            def chaos():
                gate.wait()
                # SIGKILL a worker that holds an active lease right now
                leases = {
                    w["worker_id"]: w for w in state["d"].status()["workers"]
                    if w["leases"]
                }
                victim_id = next(iter(leases)) if leases else None
                for proc, ready in procs:
                    if victim_id is None or ready["worker_id"] == victim_id:
                        os.kill(proc.pid, signal.SIGKILL)
                        proc.wait()
                        break
                # kill + restart the dispatcher on the same port, same
                # journal — mid-epoch, while the SIGKILL is still fresh
                state["d"].stop()
                state["d"] = service.ServiceDispatcher(
                    port=port, lease_ttl_s=10.0, journal=journal
                ).start()
                restarted.append(state["d"])
                chaos_done.set()

            outs = [[], []]
            threads = [
                threading.Thread(target=consume, args=(outs[k],))
                for k in range(2)
            ]
            threads.append(threading.Thread(target=chaos))
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
                assert not t.is_alive(), "acceptance run wedged"
            assert outs[0] == local_rows
            assert outs[1] == local_rows
            assert METRICS.counter("service.fallbacks") == 0
            assert METRICS.counter("service.reconnects") >= 1
        finally:
            for proc, _ in procs:
                if proc.poll() is None:
                    proc.terminate()
            for proc, _ in procs:
                if proc.poll() is None:
                    try:
                        proc.wait(timeout=10)
                    except subprocess.TimeoutExpired:
                        proc.kill()
            state["d"].stop()


# ---------------------------------------------------------------------------
# PartitionMap and partitioned routing (tests/test_service_ha.py)
# ---------------------------------------------------------------------------


def wait_for(cond, timeout=20.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {msg}")


class TestPartitionMap:
    def test_spec_forms_and_roundtrip(self):
        pm = service.PartitionMap.parse("127.0.0.1:70")
        assert pm.k == 1 and pm.addrs(0) == ["127.0.0.1:70"]
        pm = service.PartitionMap.parse("h:1|h:2, h:3|h:4")
        assert pm.k == 2
        assert pm.addrs(0) == ["h:1", "h:2"]
        assert pm.addrs(1) == ["h:3", "h:4"]
        assert pm.to_spec() == "h:1|h:2,h:3|h:4"
        assert service.PartitionMap.parse(pm.to_spec()).partitions == pm.partitions

    def test_file_spec(self, tmp_path):
        p = tmp_path / "map.json"
        p.write_text(json.dumps({"partitions": [["h:1", "h:2"], ["h:3"]]}))
        pm = service.PartitionMap.parse(f"@{p}")
        assert pm.k == 2 and pm.addrs(0) == ["h:1", "h:2"]

    def test_garbage_specs_are_loud(self, tmp_path):
        for spec in ("nonsense", "", "h:1,|", f"@{tmp_path}/absent.json"):
            with pytest.raises((OSError, ValueError)):
                service.PartitionMap.parse(spec)

    def test_rendezvous_is_deterministic_and_covers_every_partition(self):
        """The same owner as the JAX map for every tenant."""
        pm = service.PartitionMap.parse("h:1,h:2,h:3")
        jpm = jservice.PartitionMap.parse("h:1,h:2,h:3")
        tenants = [f"tenant-{i:04x}" for i in range(300)]
        owners = [pm.partition_for(t) for t in tenants]
        assert owners == [pm.partition_for(t) for t in tenants]
        assert owners == [jpm.partition_for(t) for t in tenants]
        assert set(owners) == {0, 1, 2}

    def test_growing_k_remaps_only_a_minority(self):
        pm2 = service.PartitionMap([["h:1"], ["h:2"]])
        pm3 = service.PartitionMap([["h:1"], ["h:2"], ["h:3"]])
        moved = 0
        for t in [f"tenant-{i:04x}" for i in range(300)]:
            before, after = pm2.partition_for(t), pm3.partition_for(t)
            if before != after:
                moved += 1
                assert after == 2
        assert 0 < moved < 150


class TestPartitionedRouting:
    def test_client_routes_to_the_owning_partition(self, data_dir):
        d0 = service.ServiceDispatcher(lease_ttl_s=5.0).start()
        d1 = service.ServiceDispatcher(lease_ttl_s=5.0).start()
        try:
            spec = f"{d0.addr},{d1.addr}"
            client = service.ServiceClient(make_ds(data_dir, service=spec))
            try:
                pm = service.PartitionMap.parse(spec)
                owner = pm.partition_for(client._tenant)
                assert client.partition == owner
                assert client.addr == pm.addrs(owner)[0]
                assert METRICS.gauge_value("service.partition") == float(owner)
            finally:
                client.close()
        finally:
            d0.stop()
            d1.stop()

    def test_worker_registers_everywhere_and_the_epoch_reads_clean(
        self, data_dir, local_rows
    ):
        d0 = service.ServiceDispatcher(lease_ttl_s=5.0).start()
        d1 = service.ServiceDispatcher(lease_ttl_s=5.0).start()
        w = None
        try:
            spec = f"{d0.addr},{d1.addr}"
            w = service.DecodeWorker(spec).start()
            assert w.wait_registered(10)
            wait_for(lambda: len(d0.status()["workers"]) == 1
                     and len(d1.status()["workers"]) == 1,
                     msg="registration with every partition")
            assert collect(data_dir, service=spec, service_deadline_ms=3000) == local_rows
            assert METRICS.counter("service.fallbacks") == 0
            assert len([d for d in (d0, d1) if d.status()["shards_done"] > 0]) == 1
        finally:
            if w is not None:
                w.stop()
            d0.stop()
            d1.stop()


# ---------------------------------------------------------------------------
# Cross-package: job specs, mixed fleets
# ---------------------------------------------------------------------------


def jschema():
    return JStructType.from_json(SCHEMA.to_json())


def pair(data_dir, **kw):
    """The same dataset in both packages (the JAX one on its native
    decoder, which fuses hashes and packs as both port routes do)."""
    base = dict(batch_size=8, drop_remainder=False, num_epochs=1)
    tds = TFRecordDataset(data_dir, schema=SCHEMA, **base, **kw)
    jds = JDataset(data_dir, options=None, schema=jschema(), **base, **kw)
    return tds, jds


SPEC_CASES = {
    "plain": {},
    "columns": {"columns": ["arr", "id"]},
    "hash": {"hash_buckets": {"s": 64}},
    "pack_and_hash": {"hash_buckets": {"s": 64}, "pack": {"g": ["id"]}},
    "tolerant": {"on_corrupt": "skip_record", "max_corrupt_records": 3,
                 "verify_crc": False},
    "knobs": {"slab_bytes": 1 << 20, "max_record_bytes": 1 << 16,
              "num_workers": 3, "prefetch": 4},
}


@pytest.mark.parametrize("case", sorted(SPEC_CASES))
def test_job_spec_and_digests_equal_jax(data_dir, case):
    """A port dataset and a JAX dataset over the same files with the same
    options give the same job spec dict and the same shard-list, job and
    tenant digests: either package's worker serves the other's consumer."""
    tds, jds = pair(data_dir, **SPEC_CASES[case])
    spec, jspec = service.build_job_spec(tds), jservice.build_job_spec(jds)
    assert spec == jspec
    assert service.job_digest(spec) == jservice.job_digest(jspec)
    assert service.tenant_digest(tds) == jservice.tenant_digest(jds)
    assert service.shards_digest(tds._reader.shards) == \
        jservice.shards_digest(jds._reader.shards)


def jcollect(data_dir, **kw):
    jds = JDataset(data_dir, batch_size=8, schema=jschema(), drop_remainder=False,
                   num_epochs=1, **kw)
    got = []
    with jds.batches() as it:
        for b in it:
            got.extend(jbatch_to_rows(b, jds.schema))
    return got


def test_jax_dispatcher_leases_port_workers_to_a_port_consumer(data_dir, local_rows):
    d = jservice.ServiceDispatcher(lease_ttl_s=5.0).start()
    workers = [service.DecodeWorker(d.addr).start() for _ in range(2)]
    try:
        for w in workers:
            assert w.wait_registered(10)
        assert collect(data_dir, service=d.addr) == local_rows
        assert jcollect(data_dir) == local_rows  # the local read, either package
        assert METRICS.counter("service.fallbacks") == 0
        assert METRICS.counter("service.fetches") > 0  # port workers served it
        assert d.status()["shards_done"] == 6
    finally:
        for w in workers:
            w.stop()
        d.stop()


def test_port_dispatcher_leases_a_jax_worker_to_a_jax_consumer(data_dir, local_rows):
    d = service.ServiceDispatcher(lease_ttl_s=5.0).start()
    w = jservice.DecodeWorker(d.addr).start()
    try:
        assert w.wait_registered(10)
        assert jcollect(data_dir, service=d.addr) == local_rows
        assert JMETRICS.counter("service.fallbacks") == 0
        assert JMETRICS.counter("service.fetches") > 0
        st = service.fetch_status(d.addr)
        assert st["shards_done"] == 6 and [x["worker_id"] for x in st["workers"]] == [w.worker_id]
    finally:
        w.stop()
        d.stop()


def test_port_worker_subprocess_under_a_jax_dispatcher(data_dir, local_rows):
    """``python -m tpu_tfrecord_torch.service worker`` registers with a JAX
    dispatcher and serves a JAX consumer rows equal to a local read."""
    d = jservice.ServiceDispatcher(lease_ttl_s=5.0).start()
    procs = _spawn_worker_procs(d.addr, 1)
    try:
        wait_for(lambda: len(d.status()["workers"]) == 1, 60, "registration")
        assert jcollect(data_dir, service=d.addr) == local_rows
        assert JMETRICS.counter("service.fallbacks") == 0
    finally:
        for proc, _ in procs:
            proc.terminate()
            proc.wait(timeout=30)
        d.stop()


def test_python_route_jax_consumer_is_a_spec_mismatch(data_dir):
    """The JAX Python route does not fuse hashes and packs; both port
    routes do: a port worker refuses such a consumer loudly."""
    d = service.ServiceDispatcher(lease_ttl_s=5.0).start()
    w = service.DecodeWorker(d.addr).start()
    try:
        assert w.wait_registered(10)
        jds = JDataset(data_dir, batch_size=8, schema=jschema(), num_epochs=1,
                       hash_buckets={"s": 64}, service=d.addr)
        client = jservice.ServiceClient(jds)
        # what a consumer on the JAX Python route sends
        client._spec = dict(client._spec, fused=False)
        try:
            with pytest.raises(jservice.ServiceSpecError, match="fused"):
                list(client.shard_chunks(0, 0, 0, 0, threading.Event()))
        finally:
            client.close()
    finally:
        w.stop()
        d.stop()


# ---------------------------------------------------------------------------
# The warm standby (7c), draining and elastic scaling (7d), ported
# ---------------------------------------------------------------------------


def test_standby_and_promote_refused(tmp_path):
    """A standby refuses lease ops with ``not_primary`` naming its
    primary, as the JAX standby does, until ``promote()`` makes it the
    acting primary at generation 1; a standby needs a journal."""
    j = str(tmp_path / "j.json")
    with pytest.raises(ValueError, match="journal"):
        service.ServiceDispatcher(standby_of="127.0.0.1:1")
    with pytest.raises(ValueError, match="journal"):
        jservice.ServiceDispatcher(standby_of="127.0.0.1:1")
    replies = []
    for mod, sub in ((service, "port"), (jservice, "jax")):
        d = mod.ServiceDispatcher(journal=f"{j}.{sub}", standby_of="127.0.0.1:1",
                                  lease_ttl_s=5.0, takeover_addr=False)
        try:
            replies.append(d._handle({"op": "route", "path": "s0", "shard_index": 0}))
            st = d.status()
            assert st["standby_of"] == "127.0.0.1:1" and st["failed_over"] is False
            assert st["role"] == "standby" and st["accepting"] is False
            d.promote()
            st = d.status()
            assert st["role"] == "dispatcher" and st["failed_over"] is True
            assert st["generation"] == 1 and st["standby_of"] is None
        finally:
            d.stop()
    assert replies[0] == replies[1] == {"error": "not_primary", "role": "standby",
                                        "demoted": False, "primary": "127.0.0.1:1"}
    assert METRICS.counter("service.not_primary_rejects") == 1
    assert METRICS.counter("service.failovers") == 1


def test_drain_refused_in_process_and_on_the_wire(tmp_path):
    """``drain`` is refused for an unknown or already-draining worker (in
    process and over the wire) and by a standby (``not_primary``); the
    acting primary drains a known worker and hands its lease back."""
    d = service.ServiceDispatcher(lease_ttl_s=5.0).start()
    b = service.ServiceDispatcher(journal=str(tmp_path / "j.json"), standby_of=d.addr,
                                  lease_ttl_s=5.0, ping_interval_s=30.0,
                                  takeover_addr=False).start()

    def wire(addr, wid):
        s = sp.connect(addr, timeout=5.0)
        try:
            s.settimeout(5.0)
            return sp.request(s, addr, {"op": "drain", "proto": service.PROTO_VERSION,
                                        "worker_id": wid})
        finally:
            s.close()

    try:
        d._handle({"op": "register_worker", "worker_id": "w0", "addr": "h:0", "pid": 0})
        route = {"op": "route", "job": "j", "path": "s0", "shard_index": 0, "exclude": []}
        assert d._handle(route)["worker_id"] == "w0"
        assert d.drain("ghost") is False
        assert wire(d.addr, "ghost") == {"ok": True, "drained": False}
        assert wire(b.addr, "w0")["error"] == "not_primary"
        assert wire(d.addr, "w0") == {"ok": True, "drained": True}
        assert d.drain("w0") is False  # already draining
        st = d.status()
        assert st["draining"] == ["w0"] and st["active_leases"] == 0
        assert st["lease_reassignments"] == 0
        assert METRICS.counter("elastic.drained_leases") == 1
    finally:
        b.stop()
        d.stop()


class _Recorder:
    """Stands in for a class or factory the dispatcher CLI builds: records
    its arguments and plays the object's part."""

    def __init__(self, log, name):
        self.log, self.name = log, name

    def __call__(self, *args, **kw):
        self.log[self.name] = (args, kw)
        return self

    def start(self):
        return self

    stop = reap = start
    addr, partition_index, generation = "127.0.0.1:1", 0, 0
    _stop = None


def cli_capture(mod, argv, monkeypatch, capsys):
    """What ``mod.main(["dispatcher", *argv])`` hands to the dispatcher,
    the scaler and the spawner, and its ready line; or its exit code and
    error when the parser refuses."""
    import dataclasses
    import importlib

    elastic_mod = importlib.import_module(mod.__name__.replace("service", "elastic"))
    log = {}
    monkeypatch.setattr(mod, "ServiceDispatcher", _Recorder(log, "dispatcher"))
    monkeypatch.setattr(mod, "_run_forever", lambda stop: None)
    monkeypatch.setattr(mod.telemetry, "adopt_from_env", lambda **kw: None)
    monkeypatch.setattr(elastic_mod, "FleetScaler", _Recorder(log, "scaler"))
    monkeypatch.setattr(elastic_mod, "subprocess_spawner", _Recorder(log, "spawner"))
    try:
        mod.main(["dispatcher", *argv])
    except SystemExit as e:
        err = capsys.readouterr().err.splitlines()[-1]
        return {"exit": e.code, "error": err.split(": error: ", 1)[1]}
    out = {"ready": json.loads(capsys.readouterr().out.splitlines()[-1])}
    out["ready"].pop("pid")
    for name, (args, kw) in log.items():
        kw = dict(kw)
        if "policy" in kw:
            kw["policy"] = dataclasses.asdict(kw["policy"])
        if name == "scaler":  # the targets: this dispatcher, or handles
            targets = args[0] if isinstance(args[0], list) else [args[0]]
            args = ([getattr(t, "addrs", "local") for t in targets],)
        out[name] = (args, kw)
    return out


ELASTIC = ["--elastic", "--scaler-spool", "/tmp/s"]


@pytest.mark.parametrize("flags,reaches", [
    (["--standby-of", "127.0.0.1:1", "--journal", "/tmp/j"], "dispatcher"),
    (["--takeover-misses", "2"], "dispatcher"),
    (["--ping-interval", "0.5"], "dispatcher"),
    (["--no-addr-takeover"], "dispatcher"),
    (["--elastic"], "refused"),
    (["--scaler-spool", "/tmp/s", "--elastic"], "scaler"),
    (["--min-workers", "2", *ELASTIC], "scaler"),
    (["--max-workers", "4", *ELASTIC], "scaler"),
    (["--scale-interval", "0.5", *ELASTIC], "scaler"),
    (["--hysteresis", "3", *ELASTIC], "scaler"),
    (["--cooldown", "1", *ELASTIC], "scaler"),
    (["--scaler-roles", "trainer, eval", *ELASTIC], "scaler"),
    (["--worker-arg=--cache", "--worker-arg=auto", *ELASTIC], "spawner"),
    (["--partition-map", "127.0.0.1:1|127.0.0.1:2,127.0.0.1:3", *ELASTIC], "spawner"),
])
def test_cli_refuses_later_slices_flags(flags, reaches, monkeypatch, capsys):
    """Each of the JAX CLI's standby and elastic flags is accepted and
    reaches the dispatcher, the scaler or the spawner as the JAX CLI hands
    it on (``--elastic`` without a spool is refused as JAX refuses it)."""
    mine = cli_capture(service, flags, monkeypatch, capsys)
    want = cli_capture(jservice, flags, monkeypatch, capsys)
    assert mine == want
    if reaches == "refused":
        assert mine["exit"] == 2 and "--scaler-spool" in mine["error"]
        return
    assert reaches in mine
    given = dict(zip(flags[::2], flags[1::2])) if flags[0] != "--no-addr-takeover" else {}
    if flags[0] == "--standby-of":
        assert mine["ready"]["role"] == "standby"
        assert mine["ready"]["standby_of"] == given["--standby-of"]
    if reaches == "scaler":
        assert mine["ready"]["elastic"] is True
        assert mine["scaler"][1]["spool_dir"] == "/tmp/s"
    if flags[0] == "--partition-map":  # partition 0 here, partition 1 by handle
        assert mine["scaler"][0] == (["local", ["127.0.0.1:3"]],)
        assert mine["spawner"][0][0] == flags[1]


def test_elastic_options_still_refused():
    """The three ``elastic_*`` options parse in both spellings to the JAX
    parser's values and defaults, and the JAX validation refuses the same
    bad values."""
    from tpu_tfrecord.options import TFRecordOptions as JOptions

    keys = ("elastic_min_workers", "elastic_max_workers", "elastic_interval_s")
    for given in ({"elastic_min_workers": 2, "elastic_max_workers": 6, "elastic_interval_s": 0.5},
                  {"elasticMinWorkers": "3", "elasticMaxWorkers": "3", "elasticIntervalS": "2"},
                  {}):
        t, j = TFRecordOptions.from_map(given), JOptions.from_map(given)
        assert [getattr(t, k) for k in keys] == [getattr(j, k) for k in keys]
    assert [getattr(TFRecordOptions(), k) for k in keys] == [1, None, None]
    for bad in ({"elastic_min_workers": 0}, {"elastic_min_workers": 4, "elastic_max_workers": 2},
                {"elasticIntervalS": 0}):
        with pytest.raises(ValueError) as mine:
            TFRecordOptions.from_map(bad)
        with pytest.raises(ValueError) as theirs:
            JOptions.from_map(bad)
        assert str(mine.value) == str(theirs.value)


def test_service_processes_never_import_torch(tmp_path):
    """A dispatcher with its journal hosting a fleet scaler, its warm
    standby, a worker with its epoch cache and a consumer's read through
    them, in a fresh process: torch is never imported, so service
    processes start without paying for it."""
    code = f"""
import sys
sys.path.insert(0, {REPO!r})
from tpu_tfrecord_torch import elastic, service
from tpu_tfrecord_torch.io.dataset import TFRecordDataset
from tpu_tfrecord_torch.io.writer import DatasetWriter
from tpu_tfrecord_torch.options import TFRecordOptions
from tpu_tfrecord_torch.schema import LongType, StringType, StructField, StructType
schema = StructType([StructField("id", LongType(), nullable=False), StructField("s", StringType())])
d = {str(tmp_path)!r} + "/ds"
DatasetWriter(d, schema, mode="overwrite", max_records_per_file=30).write_rows(
    [[i, "v%d" % i] for i in range(90)])
disp = service.ServiceDispatcher(lease_ttl_s=5.0, journal=d + ".journal").start()
w = service.DecodeWorker(disp.addr, options=TFRecordOptions.from_map(
    cache="auto", cache_dir=d + ".cache")).start()
assert w.wait_registered(10)
ds = TFRecordDataset(d, batch_size=8, schema=schema, service=disp.addr, hash_buckets={{"s": 16}})
with ds.batches() as it:
    rows = sum(b.num_rows for b in it)
standby = service.ServiceDispatcher(journal=d + ".journal", standby_of=disp.addr,
                                    lease_ttl_s=5.0, takeover_addr=False).start()
scaler = elastic.FleetScaler([disp, elastic.DispatcherHandle(standby.addr + "|" + disp.addr)],
                             lambda: None, spool_dir=d + ".spool")
assert scaler.step() is None and disp.scaler_status["workers"] == 1
standby.promote()
assert standby.status()["generation"] == 1
w.stop(); standby.stop(); disp.stop()
print(rows, sorted(m for m in sys.modules if m.split(".")[0] in ("torch", "jax", "tpu_tfrecord")))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=REPO, env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split()[0] == "88"
    assert proc.stdout.strip().endswith("[]"), proc.stdout
