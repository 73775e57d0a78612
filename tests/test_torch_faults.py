"""The port's ``faults`` and ``service_protocol`` against the JAX package's:
a ``FaultPlan``'s JSON read by either package, the same decisions and
ledger for the same plan and call sequence (serve, socket and file seams),
the same rule validation, ``install_chaos`` on the port's seams, and wire
frames (control messages and chunk bodies) byte-equal to
``tpu_tfrecord.service_protocol``'s."""

import json
import socket
import threading

import numpy as np
import pytest
import torch

from tpu_tfrecord import faults as jfaults
from tpu_tfrecord import service_protocol as jsp
from tpu_tfrecord.columnar import Column as JColumn, ColumnarBatch as JBatch
from tpu_tfrecord.schema import ArrayType, FloatType, LongType, StringType
from tpu_tfrecord_torch import faults as tfaults
from tpu_tfrecord_torch import fs as tfs
from tpu_tfrecord_torch import service_protocol as tsp
from tpu_tfrecord_torch.columnar import Column as TColumn, ColumnarBatch as TBatch

torch.set_num_threads(1)


def plan_json():
    return {"seed": 7, "rules": [
        {"op": "serve", "kind": "slow_client", "path": "reply:", "stall_ms": 10.0, "times": 2},
        {"op": "serve", "kind": "burst", "path": "load", "burst_n": 3, "ordinal": 1},
        {"op": "serve", "kind": "client_disconnect", "path": "recv:", "probability": 0.5,
         "times": None},
        {"op": "recv", "kind": "short_read", "cap_bytes": 5, "times": 3},
        {"op": "connect", "kind": "transient_error", "path": "127.0.0.1"},
        {"op": "read", "kind": "stall", "stall_ms": 1.0, "times": None},
    ]}


def test_plan_json_reads_both_ways():
    tp = tfaults.FaultPlan.from_json(json.dumps(plan_json()))
    jp = jfaults.FaultPlan.from_json(plan_json())
    assert tp.to_json() == jp.to_json()
    assert jfaults.FaultPlan.from_json(json.dumps(tp.to_json())).to_json() == tp.to_json()
    assert tfaults.FaultPlan.from_json(jp.to_json()).to_json() == jp.to_json()
    assert tfaults.FAULT_KINDS == jfaults.FAULT_KINDS and tfaults.FAULT_OPS == jfaults.FAULT_OPS


def _drive(mod, plan):
    """One fixed call sequence over the serve, socket and file seams; what
    each call did (slept, burst, capped, raised)."""
    out = []
    for point in ("reply:a", "load", "reply:b", "load", "recv:c", "recv:c", "recv:d", "load",
                  "reply:a", "recv:c"):
        a, b = socket.socketpair()
        try:
            out.append(("serve", point, plan.apply_serve(point, sock=a)))
        except mod.InjectedFault as e:
            out.append(("serve", point, "raised", a.fileno() == -1, str(e)))
        finally:
            a.close()
            b.close()
    for op, addr, size in (("recv", "h:1", 100), ("recv", "h:1", 3), ("connect", "127.0.0.1:9", None),
                           ("connect", "127.0.0.1:9", None), ("recv", "h:2", 100)):
        try:
            out.append((op, addr, plan.apply_socket(op, addr, size=size)))
        except mod.InjectedFault as e:
            out.append((op, addr, "raised", str(e)))
    out.append(("read", "/x", plan.apply("read", "/x", size=10)))
    return out


def test_same_plan_same_decisions_and_ledger():
    slept = {"j": [], "t": []}
    jp = jfaults.FaultPlan.from_json(plan_json())
    jp.sleep = slept["j"].append
    tp = tfaults.FaultPlan.from_json(plan_json())
    tp.sleep = slept["t"].append
    want, got = _drive(jfaults, jp), _drive(tfaults, tp)
    assert got == want
    assert tp.ledger_json() == jp.ledger_json()
    assert slept["t"] == slept["j"] and slept["t"]
    kinds = {e["kind"] for e in tp.ledger}
    assert {"slow_client", "burst", "client_disconnect", "short_read"} <= kinds


@pytest.mark.parametrize("rule,match", [
    (dict(op="read", kind="slow_client", stall_ms=5), "op='serve'"),
    (dict(op="serve", kind="short_read", cap_bytes=1), "op='serve' supports"),
    (dict(op="serve", kind="slow_client"), "stall_ms"),
    (dict(op="serve", kind="burst"), "burst_n"),
    (dict(op="nope", kind="stall", stall_ms=1), "op must be"),
])
def test_rule_validation_as_in_jax(rule, match):
    for mod in (jfaults, tfaults):
        with pytest.raises(ValueError, match=match):
            mod.FaultRule(**rule)


def test_install_chaos_patches_the_port_seams(tmp_path):
    path = tmp_path / "f.bin"
    path.write_bytes(b"0123456789")
    plan = tfaults.FaultPlan([tfaults.FaultRule(op="read", kind="short_read", cap_bytes=4,
                                                times=None),
                              tfaults.FaultRule(op="connect", kind="permanent_error", times=None)])
    orig = (tfs.local_open, tfs.filesystem_for, tsp._CHAOS_PLAN, tfaults._SERVE_CHAOS)
    with tfaults.install_chaos(plan):
        assert tfaults._SERVE_CHAOS is plan and tsp._CHAOS_PLAN is plan
        with tfs.local_open(str(path), "rb") as fh:
            assert fh.read() == b"0123"
        with pytest.raises(tfaults.InjectedFault):
            tsp.connect("127.0.0.1:1", timeout=1.0)
        assert isinstance(tfs.filesystem_for(str(tmp_path)), tfaults.ChaosFS)
    assert (tfs.local_open, tfs.filesystem_for, tsp._CHAOS_PLAN, tfaults._SERVE_CHAOS) == orig
    assert [(e["op"], e["kind"]) for e in plan.ledger] == [("read", "short_read"),
                                                           ("connect", "permanent_error")]


def _frames(mod, send):
    """The bytes ``send(mod, sock)`` puts on a socket."""
    a, b = socket.socketpair()
    got = bytearray()

    def reader():
        while True:
            chunk = b.recv(65536)
            if not chunk:
                return
            got.extend(chunk)

    t = threading.Thread(target=reader)
    t.start()
    try:
        send(mod, a)
    finally:
        a.close()
        t.join(timeout=30)
        b.close()
    assert not t.is_alive()
    return bytes(got)


def test_control_frames_byte_equal():
    msgs = [{"v": 1, "op": "generate", "req": 3, "tokens": list(range(16)), "n_new": 4,
             "deadline_s": None, "trace": {"trace_id": "ab", "span_id": "cd"}},
            {"ok": False, "error": "overloaded", "retry_after_s": 0.125, "req": 9},
            {"ok": True, "req": 1, "tokens": [5, 6, 7]}]

    def send(mod, sock):
        for m in msgs:
            mod.send_msg(sock, m)

    want = _frames(jsp, send)
    assert _frames(tsp, send) == want
    # and each package reads the other's frames back
    a, b = socket.socketpair()
    try:
        a.sendall(want)
        a.close()
        assert [tsp.recv_msg(b, "peer") for _ in msgs] == msgs
        assert tsp.recv_msg(b, "peer", allow_eof=True) is None
    finally:
        b.close()


def _batches():
    vals = np.arange(6, dtype=np.int64)
    offs = np.array([0, 2, 2, 6], np.int64)
    blob = b"abcdefg"
    boffs = np.array([0, 3, 3, 7], np.int64)
    cols = {
        "x": (LongType(), dict(values=vals)),
        "y": (ArrayType(FloatType()), dict(values=np.linspace(0, 1, 6, dtype=np.float32),
                                           offsets=offs)),
        "s": (StringType(), dict(blob=blob, blob_offsets=boffs, mask=np.array([1, 0, 1], bool))),
    }
    j = JBatch({n: JColumn(n, dt, **kw) for n, (dt, kw) in cols.items()}, 3)
    from tpu_tfrecord_torch.schema import ArrayType as TA, FloatType as TF, LongType as TL, \
        StringType as TS

    tdt = {"x": TL(), "y": TA(TF()), "s": TS()}
    t = TBatch({n: TColumn(n, tdt[n], **kw) for n, (_, kw) in cols.items()}, 3)
    return j, t, tdt


def test_chunk_frames_byte_equal_and_round_trip():
    j, t, tdt = _batches()
    assert tsp.chunk_header(t, 10, 2)[0] == jsp.chunk_header(j, 10, 2)[0]
    want = _frames(jsp, lambda mod, sock: mod.send_chunk(sock, j, 10, 2))
    assert _frames(tsp, lambda mod, sock: mod.send_chunk(sock, t, 10, 2)) == want
    a, b = socket.socketpair()
    try:
        a.sendall(want)
        a.close()
        header = tsp.recv_msg(b, "peer")
        back = tsp.recv_chunk_body(b, header, "peer", tdt.__getitem__)
    finally:
        b.close()
    assert back.num_rows == 3 and list(back.columns) == ["x", "y", "s"]
    np.testing.assert_array_equal(back["y"].values, t["y"].values)
    assert back["s"].blob == b"abcdefg"


def test_bad_crc_is_a_protocol_error():
    frame = _frames(tsp, lambda mod, sock: mod.send_msg(sock, {"ok": True}))
    bad = frame[:-1] + bytes([frame[-1] ^ 1])
    a, b = socket.socketpair()
    try:
        a.sendall(bad)
        a.close()
        with pytest.raises(tsp.ProtocolError, match="CRC"):
            tsp.recv_msg(b, "peer")
    finally:
        b.close()
