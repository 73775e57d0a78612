"""The port's serving replica on sockets (``ServeServer`` / ``ServeClient``)
on the CPU: N concurrent clients against the sequential reference, a
client that disconnects mid-generation, the "overloaded" reply with its
Retry-After hint, status, version skew, drain; the ``op="serve"`` chaos
rules (``slow_client``, ``client_disconnect``, ``burst``); a JAX
``ServeClient`` served by the port's replica; ``python -m
tpu_tfrecord_torch.serving --device cpu`` drained by SIGTERM; and the
replica's fleet spool (``run_server(spool_dir=)``, ``--spool-dir``).

Every socket binds port 0, every wait has its own timeout, and every
thread is joined in a ``finally``."""

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

from tpu_tfrecord import serving as jserving
from tpu_tfrecord_torch import faults
from tpu_tfrecord_torch import service_protocol as sp
from tpu_tfrecord_torch.metrics import Metrics
from tpu_tfrecord_torch.models import lm
from tpu_tfrecord_torch.serving import (
    ServeClient,
    ServePolicy,
    ServeRejected,
    ServeServer,
    ServingEngine,
    sequential_reference,
)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = lm.LMConfig(vocab_size=96, d_model=32, n_heads=2, n_layers=4, max_len=16)
MB = 4
STAGES = 2
JOIN_S = 60


@pytest.fixture(scope="module")
def params():
    return lm.init_params(CFG, torch.Generator().manual_seed(0), "cpu")


def windows(n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, CFG.vocab_size, size=CFG.max_len).astype(np.int32) for _ in range(n)]


def reference(params, reqs):
    return sequential_reference(params, CFG, STAGES, reqs, MB, device="cpu")


def new_server(params, plan=None, start=True, **pol):
    metrics = Metrics()
    eng = ServingEngine(params, CFG, STAGES, policy=ServePolicy(mb=MB, **pol), metrics=metrics,
                        device="cpu")
    srv = ServeServer(eng, port=0, fault_plan=plan)
    return (srv.start() if start else srv), metrics


def run_clients(fn, n):
    """``fn(i)`` on n threads; results (or the exception) by index."""
    out = {}

    def body(i):
        try:
            out[i] = fn(i)
        except Exception as e:  # noqa: BLE001 - reported by the caller's assertion
            out[i] = e

    threads = [threading.Thread(target=body, args=(i,)) for i in range(n)]
    try:
        for t in threads:
            t.start()
    finally:
        for t in threads:
            t.join(timeout=JOIN_S)
    assert not any(t.is_alive() for t in threads), "a client hung"
    return out


def generate(addr, w, n_new, **kw):
    c = ServeClient([addr], timeout_s=30.0)
    try:
        return c.generate(w, n_new=n_new, **kw)
    finally:
        c.close()


def wait_until(pred, what, timeout=30.0):
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, what
        time.sleep(0.01)


def test_concurrent_clients_with_a_disconnect(params):
    """Four concurrent clients while a fifth hangs up mid-generation: the
    four get the sequential reference's tokens, the abandoned slot frees
    (the engine goes idle) and the loss is counted once."""
    srv, metrics = new_server(params, max_queue=32)
    try:
        ws = windows(5, seed=6)
        doomed = sp.connect(srv.addr, timeout=10.0)
        sp.send_msg(doomed, {"v": sp.PROTO_VERSION, "op": "generate", "req": 1,
                             "tokens": ws[4].tolist(), "n_new": 500, "deadline_s": None})
        wait_until(lambda: metrics.gauge_value("serve.in_flight", 0.0) >= 1, "never started")
        doomed.close()
        got = run_clients(lambda i: generate(srv.addr, ws[i], 3), 4)
        assert [got[i] for i in range(4)] == reference(params, [(w, 3) for w in ws[:4]])

        def idle():
            rep = srv.engine.report()
            return rep["queue_depth"] == 0 and rep["in_flight"] == 0

        wait_until(idle, "the abandoned slot never freed")
        assert metrics.counter("serve.disconnects") == 1
        assert metrics.counter("serve.requests") == 4
    finally:
        srv.stop()


def test_overloaded_reply_carries_retry_after(params):
    """One queue slot and no engine thread: a second concurrent generate is
    shed on the wire with "overloaded" and a positive Retry-After."""
    srv, metrics = new_server(params, start=False, max_queue=1)
    srv._accept_thread = threading.Thread(target=srv._accept_loop, daemon=True)
    srv._accept_thread.start()
    s1 = s2 = None
    try:
        w = windows(1, seed=10)[0].tolist()
        s1 = sp.connect(srv.addr, timeout=10.0)
        sp.send_msg(s1, {"v": sp.PROTO_VERSION, "op": "generate", "req": 1, "tokens": w,
                         "n_new": 1, "deadline_s": None})
        wait_until(lambda: srv.engine.report()["queue_depth"] >= 1, "request 1 never queued")
        s2 = sp.connect(srv.addr, timeout=10.0)
        rep = sp.request(s2, srv.addr, {"v": sp.PROTO_VERSION, "op": "generate", "req": 2,
                                        "tokens": w, "n_new": 1, "deadline_s": None})
        assert rep["ok"] is False and rep["error"] == "overloaded"
        assert rep["retry_after_s"] > 0
        assert metrics.counter("serve.rejected") == 1
    finally:
        for s in (s1, s2):
            if s is not None:
                s.close()
        srv.stop()
        srv._accept_thread.join(timeout=JOIN_S)


def test_expired_deadline_on_the_wire(params):
    srv, metrics = new_server(params)
    try:
        from tpu_tfrecord_torch.serving import DeadlineExpired

        with pytest.raises(DeadlineExpired):
            generate(srv.addr, windows(1)[0], 2, deadline_s=0.0)
        assert metrics.counter("serve.deadline_expired") == 1
    finally:
        srv.stop()


def test_status_version_skew_and_drain(params):
    from tpu_tfrecord_torch.retry import RetryPolicy

    srv, _ = new_server(params)
    c = ServeClient([srv.addr], policy=RetryPolicy(max_retries=1, base_delay=0.01),
                    timeout_s=30.0)
    sock = sp.connect(srv.addr, timeout=10.0)
    try:
        st = sp.request(sock, srv.addr, {"v": sp.PROTO_VERSION, "op": "status", "req": 1})
        for key in ("queue_depth", "in_flight", "verdict", "mb", "max_queue", "counters", "addr",
                    "pid"):
            assert key in st, key
        rep = sp.request(sock, srv.addr, {"v": sp.PROTO_VERSION + 1, "op": "ping", "req": 2})
        assert rep["ok"] is False and rep["error"] == "version_skew"
        w = windows(1, seed=9)[0]
        assert c.generate(w, n_new=2) == reference(params, [(w, 2)])[0]
        rep = c.drain()
        assert rep["ok"] and rep["draining"]
        assert srv.drained.wait(30)
        with pytest.raises((ServeRejected, ConnectionError)):
            c.generate(w, n_new=1)
    finally:
        sock.close()
        c.close()
        srv.stop()


def test_run_server_returns_after_the_drain_reply_left(params, monkeypatch):
    """``run_server`` returns (and the replica's process exits) only after
    the drain request's reply has left: the connection writers, daemon
    threads, are joined. A writer scheduled late used to lose the reply,
    and the JAX ``ServingScaler`` then counted its drained replica as lost."""
    from tpu_tfrecord_torch import serving

    real_send = sp.send_msg
    sent = []

    def late_send(sock, msg):
        if msg.get("draining"):
            time.sleep(0.5)  # the writer thread scheduled late
            real_send(sock, msg)
            sent.append(time.monotonic())
            return
        real_send(sock, msg)

    monkeypatch.setattr(serving.sp, "send_msg", late_send)
    srv, _ = new_server(params)
    done = {}
    runner = threading.Thread(target=lambda: done.update(
        rc=serving.run_server(srv, install_signals=False), at=time.monotonic()))
    c = ServeClient([srv.addr], timeout_s=30.0)
    try:
        runner.start()
        assert c.drain()["draining"]
        runner.join(timeout=JOIN_S)
        assert done.get("rc") == 0 and sent and sent[0] <= done["at"]
    finally:
        c.close()
        srv.stop()
        runner.join(timeout=JOIN_S)


def test_jax_client_talks_to_the_port_replica(params):
    """The frames are the JAX package's: its ``ServeClient`` is served by
    the port's replica."""
    srv, _ = new_server(params)
    c = jserving.ServeClient([srv.addr], timeout_s=30.0)
    try:
        w = windows(1, seed=11)[0]
        assert c.generate(w, n_new=3) == reference(params, [(w, 3)])[0]
    finally:
        c.close()
        srv.stop()


def test_slow_client_stalls_only_its_own_writer(params):
    plan = faults.FaultPlan([faults.FaultRule(op="serve", kind="slow_client", path="reply:",
                                              stall_ms=200.0, times=1)])
    srv, _ = new_server(params, plan=plan, max_queue=32)
    try:
        ws = windows(3, seed=12)
        got = run_clients(lambda i: generate(srv.addr, ws[i], 2), 3)
        assert [got[i] for i in range(3)] == reference(params, [(w, 2) for w in ws])
        assert [e["kind"] for e in plan.ledger] == ["slow_client"]
        assert plan.ledger[0]["stall_ms"] == 200.0
    finally:
        plan.release()
        srv.stop()


def test_injected_disconnect_is_survivable(params):
    """``client_disconnect`` on the reply seam drops one connection; the
    client's retry resends and every client still gets the reference's
    tokens."""
    plan = faults.FaultPlan([faults.FaultRule(op="serve", kind="client_disconnect",
                                              path="reply:", times=1)])
    with faults.install_chaos(plan):  # the installed plan reaches the server's seams
        srv, _ = new_server(params, max_queue=32)
        try:
            ws = windows(3, seed=7)
            got = run_clients(lambda i: generate(srv.addr, ws[i], 2), 3)
            assert [got[i] for i in range(3)] == reference(params, [(w, 2) for w in ws])
            assert [e["kind"] for e in plan.ledger] == ["client_disconnect"]
        finally:
            srv.stop()


def test_burst_over_admission_sheds_exactly_the_excess(params):
    """An open-loop generator consults ``apply_serve("load")`` at each
    arrival and injects ``burst`` extra requests; with no engine thread,
    everything past ``max_queue`` is shed with "overloaded"."""
    plan = faults.FaultPlan([faults.FaultRule(op="serve", kind="burst", path="load",
                                              burst_n=6, ordinal=1)])
    srv, metrics = new_server(params, plan=plan, start=False, max_queue=4)
    srv._accept_thread = threading.Thread(target=srv._accept_loop, daemon=True)
    srv._accept_thread.start()
    socks = []
    try:
        ws = windows(2, seed=13)
        replies = []
        for i, w in enumerate(ws):
            for j in range(1 + plan.apply_serve("load")):
                s = sp.connect(srv.addr, timeout=10.0)
                socks.append(s)
                sp.send_msg(s, {"v": sp.PROTO_VERSION, "op": "generate", "req": j,
                                "tokens": w.tolist(), "n_new": 1, "deadline_s": None})
                if len(socks) > 4:
                    replies.append(sp.recv_msg(s, srv.addr))
                else:
                    wait_until(lambda n=len(socks): srv.engine.report()["queue_depth"] >= n,
                               "an arrival never queued")
        assert len(socks) == 8 and [e["kind"] for e in plan.ledger] == ["burst"]
        assert [r["error"] for r in replies] == ["overloaded"] * 4
        assert all(r["retry_after_s"] > 0 for r in replies)
        assert metrics.counter("serve.rejected") == 4
        # the admitted four are served once the engine runs
        srv.engine.start()
        for s in socks[:4]:
            rep = sp.recv_msg(s, srv.addr)
            assert rep["ok"] and len(rep["tokens"]) == 1
    finally:
        for s in socks:
            s.close()
        srv.stop()
        srv._accept_thread.join(timeout=JOIN_S)


def test_replica_subprocess_drains_on_sigterm(tmp_path):
    """``python -m tpu_tfrecord_torch.serving --device cpu``: a ready line,
    requests answered with the tokens of the same seed's weights computed
    here, SIGTERM -> drain -> exit 0."""
    args = ["--device", "cpu", "--seed", "3", "--stages", "2", "--mb", str(MB), "--layers", "4",
            "--d-model", "32", "--heads", "2", "--vocab", "96", "--max-len", "16"]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.Popen([sys.executable, "-m", "tpu_tfrecord_torch.serving", *args], cwd=REPO,
                            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        ready = {}
        reader = threading.Thread(target=lambda: ready.update(json.loads(proc.stdout.readline())))
        reader.start()
        reader.join(timeout=120)
        assert "addr" in ready, proc.stderr.read() if proc.poll() is not None else "no ready line"
        assert ready["pid"] == proc.pid
        ws = windows(3, seed=14)
        got = run_clients(lambda i: generate(ready["addr"], ws[i], 2), 3)
        p3 = lm.init_params(CFG, torch.Generator().manual_seed(3), "cpu")
        assert [got[i] for i in range(3)] == reference(p3, [(w, 2) for w in ws])
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        proc.stdout.close()
        proc.stderr.close()


def test_spool_refused(params, tmp_path):
    """``run_server(spool_dir=)`` and ``--spool-dir``, once refused, spool
    the replica as the JAX ``run_server`` does: role ``serving`` at 0.2 s,
    and a drain (the drain request in-process, SIGTERM for the CLI)
    lands the ``final: true`` snapshot with the requests it served."""
    from tpu_tfrecord_torch import fleet, telemetry
    from tpu_tfrecord_torch.serving import run_server

    spool_dir = str(tmp_path / "spool")
    srv, _ = new_server(params)
    done = {}
    runner = threading.Thread(target=lambda: done.update(rc=run_server(
        srv, spool_dir=spool_dir, role="replica0", install_signals=False)))
    try:
        runner.start()
        wait_until(lambda: fleet._SPOOLS, "the spool never started")
        (spool,) = [sp_ for sp_, _ in fleet._SPOOLS.values()]
        assert spool.interval_s == 0.2 and spool.context.role == "replica0"
        ws = windows(1, seed=21)
        assert generate(srv.addr, ws[0], 2) == reference(params, [(ws[0], 2)])[0]
        srv.drain()
        runner.join(timeout=JOIN_S)
        assert done == {"rc": 0}
        snap = fleet.read_spool(spool.path)
        assert snap.final and snap.role == "replica0" and not fleet._SPOOLS
    finally:
        srv.stop()
        runner.join(timeout=JOIN_S)
        telemetry.RECORDER.context = None

    cli_dir = str(tmp_path / "cli-spool")
    args = ["--device", "cpu", "--seed", "3", "--stages", "2", "--mb", str(MB), "--layers", "4",
            "--d-model", "32", "--heads", "2", "--vocab", "96", "--max-len", "16",
            "--spool-dir", cli_dir]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.Popen([sys.executable, "-m", "tpu_tfrecord_torch.serving", *args], cwd=REPO,
                            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        ready = {}
        reader = threading.Thread(target=lambda: ready.update(json.loads(proc.stdout.readline())))
        reader.start()
        reader.join(timeout=120)
        assert "addr" in ready, proc.stderr.read() if proc.poll() is not None else "no ready line"
        ws = windows(2, seed=22)
        got = run_clients(lambda i: generate(ready["addr"], ws[i], 2), 2)
        p3 = lm.init_params(CFG, torch.Generator().manual_seed(3), "cpu")
        assert [got[i] for i in range(2)] == reference(p3, [(w, 2) for w in ws])
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
        (name,) = os.listdir(cli_dir)
        snap = fleet.read_spool(os.path.join(cli_dir, name))
        assert snap.final and snap.role == "serving" and snap.pid == proc.pid
        assert snap.counters["serve.requests"] == 2
        assert snap.hists["serve.latency"]["count"] == 2
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        proc.stdout.close()
        proc.stderr.close()
