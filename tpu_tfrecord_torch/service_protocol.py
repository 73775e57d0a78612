"""Wire protocol of the socket tiers: copy of ``tpu_tfrecord/service_protocol.py``.

The port's serving tier (``tpu_tfrecord_torch.serving``) and data service
(``tpu_tfrecord_torch.service``) speak it; the frames are byte-identical
to the JAX package's, so a client of either package talks to a replica,
dispatcher or decode worker of the other. The chunk bodies use the section
primitives of the columnar epoch cache (``cache.column_buffers`` and
``cache.section_crc``).

In the JAX package's words: everything that crosses a socket between a trainer consumer, a decode
worker, and the dispatcher goes through this module, so the framing,
integrity, and fault-injection story has ONE owner:

- **Control frames**: ``u32 payload_len | u32 masked_crc32c(payload) |
  payload`` where the payload is one JSON object (the same masked-CRC
  recipe as the TFRecord file format, ``wire.masked_crc32c``). A frame
  whose CRC does not match, whose declared length is absurd, or whose
  connection closes mid-frame raises :class:`ProtocolError` — a
  ``ConnectionError`` subclass, so every client-side reconnect/fallback
  net that catches ``OSError`` already handles it.

- **Chunk bodies**: a decoded ``ColumnarBatch`` chunk travels as a control
  frame (the chunk header: start offset, row count, per-column section
  table with dtype/shape/nbytes/CRC32C per buffer) followed by the raw
  concatenated section bytes. The section layout and per-section CRCs are
  the SAME primitives the columnar epoch cache serializes entries with
  (``cache.column_buffers`` / ``cache.section_crc``), so the two
  serializers cannot drift; receive-side reconstruction mirrors
  ``CachedShard.chunk_batch``.

- **Chaos seam**: ``install_chaos`` (tpu_tfrecord_torch.faults) points
  ``_CHAOS_PLAN`` at a seeded :class:`~tpu_tfrecord_torch.faults.FaultPlan`;
  every ``connect`` and every ``recv`` then consults the plan
  (refused-connection errors, bounded stalls, capped recvs, mid-frame
  disconnects), with every fired fault in the same replayable ledger as
  the file-seam faults. ``_CHAOS_PLAN is None`` (the default) costs one
  module-global read per call.
"""

from __future__ import annotations

import json
import socket
import struct
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from tpu_tfrecord_torch import wire
from tpu_tfrecord_torch.cache import column_buffers, section_crc
from tpu_tfrecord_torch.columnar import Column, ColumnarBatch

#: bumped on any incompatible frame/message change; peers reject mismatches
#: loudly instead of mis-parsing each other.
PROTO_VERSION = 1

_FRAME = struct.Struct("<II")  # payload length, masked crc32c(payload)

#: a control frame is JSON — anything near this size is corruption, not a
#: message (chunk BODIES are not frames; they are length-driven raw bytes).
MAX_CONTROL_FRAME = 64 << 20

#: chunk bodies are slab-scale; a header announcing anything outside
#: [0, this] is a corrupt/hostile length field and is rejected BEFORE the
#: receive buffer is allocated.
MAX_CHUNK_BODY = 4 << 30

#: set by faults.install_chaos for the duration of a chaos block.
_CHAOS_PLAN = None


class ProtocolError(ConnectionError):
    """A peer spoke garbage: short frame, CRC mismatch, absurd length,
    version skew, or a malformed message. ConnectionError so transport
    retry nets treat it as 'this connection is dead', never as data."""


def parse_addr(addr: str) -> Tuple[str, int]:
    """``"host:port"`` -> (host, port), validated loudly."""
    host, sep, port = str(addr).rpartition(":")
    if not sep or not host:
        raise ValueError(f"service address must be 'host:port', got {addr!r}")
    return host, int(port)


def format_addr(host: str, port: int) -> str:
    return f"{host}:{port}"


def _apply_chaos(op: str, addr: str, sock=None, size: Optional[int] = None):
    plan = _CHAOS_PLAN
    if plan is None:
        return None
    return plan.apply_socket(op, addr, sock=sock, size=size)


def enable_nodelay(sock: socket.socket) -> None:
    """Disable Nagle. Both SIDES of a framed request/reply stream need
    this: ``send_frame`` is two sendalls (header, payload), and a
    Nagle'd second segment waits out the peer's delayed ACK (~40ms) —
    per RPC. Accepted server conns are where that bite was measured
    (route+shard_done pairs went 45/s -> thousands/s)."""
    try:
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    except OSError:
        pass  # non-TCP transports (tests) — latency hint only


def connect(addr: str, timeout: Optional[float]) -> socket.socket:
    """Open a TCP connection to ``addr`` under the chaos plan (refused /
    stalled connects fire here) with ``timeout`` as both the connect and
    the per-op socket timeout."""
    host, port = parse_addr(addr)
    _apply_chaos("connect", addr)
    sock = socket.create_connection((host, port), timeout=timeout)
    enable_nodelay(sock)
    return sock


def _recv_exact(
    sock: socket.socket, n: int, addr: str, allow_eof: bool = False
) -> Optional[bytearray]:
    """Read exactly ``n`` bytes. A clean close at a frame boundary returns
    None when ``allow_eof`` (end of a message stream); a close anywhere
    else is a short frame -> ProtocolError. Chaos recv rules (stall, cap,
    disconnect) apply per recv call."""
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        want = n - got
        cap = _apply_chaos("recv", addr, sock=sock, size=want)
        if cap is not None and cap < want:
            want = cap
        try:
            k = sock.recv_into(view[got : got + want])
        except socket.timeout as e:
            raise TimeoutError(f"recv timed out talking to {addr}") from e
        if k == 0:
            if got == 0 and allow_eof:
                return None
            raise ProtocolError(
                f"short frame from {addr}: connection closed after "
                f"{got}/{n} bytes"
            )
        got += k
    return buf


def send_frame(sock: socket.socket, payload: bytes) -> None:
    sock.sendall(_FRAME.pack(len(payload), wire.masked_crc32c(payload)))
    sock.sendall(payload)


def recv_frame(
    sock: socket.socket, addr: str, allow_eof: bool = False
) -> Optional[bytes]:
    head = _recv_exact(sock, _FRAME.size, addr, allow_eof=allow_eof)
    if head is None:
        return None
    length, crc = _FRAME.unpack(bytes(head))
    if length > MAX_CONTROL_FRAME:
        raise ProtocolError(
            f"control frame of {length} bytes from {addr} exceeds "
            f"{MAX_CONTROL_FRAME} — corrupt length field?"
        )
    payload = bytes(_recv_exact(sock, length, addr))
    if wire.masked_crc32c(payload) != crc:
        raise ProtocolError(f"control frame CRC mismatch from {addr}")
    return payload


def send_msg(sock: socket.socket, obj: Dict[str, Any]) -> None:
    send_frame(sock, json.dumps(obj, sort_keys=True).encode("utf-8"))


def recv_msg(
    sock: socket.socket, addr: str, allow_eof: bool = False
) -> Optional[Dict[str, Any]]:
    payload = recv_frame(sock, addr, allow_eof=allow_eof)
    if payload is None:
        return None
    try:
        obj = json.loads(payload.decode("utf-8"))
    except (UnicodeDecodeError, ValueError) as e:
        raise ProtocolError(f"malformed message from {addr}: {e}") from e
    if not isinstance(obj, dict):
        raise ProtocolError(f"malformed message from {addr}: not an object")
    return obj


def request(sock: socket.socket, addr: str, obj: Dict[str, Any]) -> Dict[str, Any]:
    """One request/response round trip on a persistent connection."""
    send_msg(sock, obj)
    reply = recv_msg(sock, addr)
    if reply is None:
        raise ProtocolError(f"{addr} closed the connection mid-request")
    return reply


# ---------------------------------------------------------------------------
# Chunk serialization — the cache container's section layout, over a socket
# ---------------------------------------------------------------------------


def chunk_header(batch: ColumnarBatch, start: int, index: int) -> Tuple[Dict[str, Any], List[np.ndarray]]:
    """Build the chunk control message + the ordered section arrays whose
    raw bytes follow it. Column order is the DECODER's emission order and
    travels in the header: the receiver rebuilds in header order, so a
    service-fed batch has the same column order a local decode of the same
    job spec would produce (downstream batch assembly is order-sensitive)."""
    cols = []
    arrs: List[np.ndarray] = []
    total = 0
    for name, col in batch.columns.items():
        sections = []
        for role, arr in column_buffers(col):
            sections.append(
                {
                    "role": role,
                    "dtype": arr.dtype.str,
                    "shape": list(arr.shape) if arr.ndim != 1 else None,
                    "nbytes": int(arr.nbytes),
                    "crc": section_crc(arr),
                }
            )
            arrs.append(arr)
            total += int(arr.nbytes)
        cm: Dict[str, Any] = {"name": name, "sections": sections}
        if col.hash_buckets is not None:
            cm["hash_buckets"] = int(col.hash_buckets)
        cols.append(cm)
    header = {
        "op": "chunk",
        "chunk": int(index),
        "start": int(start),
        "rows": int(batch.num_rows),
        "cols": cols,
        "body": total,
    }
    return header, arrs


def send_chunk(sock: socket.socket, batch: ColumnarBatch, start: int, index: int) -> int:
    """Frame + send one decoded chunk; returns the body byte count."""
    header, arrs = chunk_header(batch, start, index)
    send_msg(sock, header)
    for arr in arrs:
        sock.sendall(memoryview(np.ascontiguousarray(arr)).cast("B"))
    return header["body"]


def recv_chunk_body(
    sock: socket.socket, header: Dict[str, Any], addr: str, dtype_of, verify: bool = True
) -> ColumnarBatch:
    """Receive the raw section bytes a ``chunk`` message announced and
    rebuild the ColumnarBatch (mirrors CachedShard.chunk_batch: numpy views
    over one receive buffer; bytes-like blobs are the single copy).
    ``verify`` checks every section CRC32C against the header's stamps."""
    try:
        total = int(header.get("body", 0))
    except (TypeError, ValueError) as e:
        raise ProtocolError(f"malformed chunk header from {addr}: {e}") from e
    if not 0 <= total <= MAX_CHUNK_BODY:
        raise ProtocolError(
            f"chunk body of {total} bytes from {addr} outside "
            f"[0, {MAX_CHUNK_BODY}] — corrupt length field?"
        )
    body = _recv_exact(sock, total, addr) if total else bytearray()
    off = 0
    cols: Dict[str, Column] = {}
    try:
        for cm in header["cols"]:
            name = cm["name"]
            col = Column(name, dtype_of(name), hash_buckets=cm.get("hash_buckets"))
            for sec in cm["sections"]:
                nb = int(sec["nbytes"])
                if off + nb > total:
                    raise ProtocolError(
                        f"chunk section overruns its body ({off}+{nb} > "
                        f"{total}) from {addr}"
                    )
                seg = np.frombuffer(body, dtype=np.uint8, count=nb, offset=off)
                if verify and section_crc(seg) != int(sec["crc"]):
                    raise ProtocolError(
                        f"chunk section CRC mismatch ({cm['name']}/"
                        f"{sec['role']}) from {addr}"
                    )
                role = sec["role"]
                if role == "blob":
                    col.blob = bytes(seg)
                else:
                    arr = seg.view(np.dtype(sec["dtype"]))
                    shape = sec.get("shape")
                    if shape is not None and len(shape) != 1:
                        arr = arr.reshape(shape)
                    setattr(col, role, arr)
                off += nb
            cols[name] = col
        rows = int(header["rows"])
    except (KeyError, TypeError, ValueError) as e:
        raise ProtocolError(f"malformed chunk header from {addr}: {e}") from e
    if off != total:
        raise ProtocolError(
            f"chunk body size mismatch from {addr}: sections cover {off} "
            f"of {total} bytes"
        )
    return ColumnarBatch(cols, rows)
