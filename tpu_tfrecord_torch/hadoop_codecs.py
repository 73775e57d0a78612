"""Hadoop ecosystem compression codecs.

Copy of ``tpu_tfrecord/hadoop_codecs.py``. The reference forwards any
codec class name into the Hadoop conf (DefaultSource.scala:95-102); this
module supplies the same breadth:

- **raw snappy** (``snappy_decompress`` / ``snappy_compress``): the full
  element format (literals and the three copy tags, overlapping copies
  included), decoded and greedily encoded by the native library
  (``_native.snappy_*``). ``_snappy_decompress_py`` is the pure-Python
  decoder the tests hold the native one against, and
  ``_snappy_compress_py`` the literal-only encoder (valid snappy, ratio
  1.0), kept as an oracle.
- **lz4 block** (``lz4_decompress`` / ``lz4_compress``): native decode
  and greedy encode; ``_lz4_decompress_py`` is the pure-Python decoder,
  and inputs past ``LZ4_NATIVE_MAX_BYTES`` (the native match table's
  int32 contract) take the literal-only encoder, as in the JAX package.
- **Hadoop block stream framing** (``HadoopBlockFile``,
  ``compress_hadoop_blocks``): the BlockCompressorStream layout of
  SnappyCodec and Lz4Codec, per block a 4-byte big-endian uncompressed
  length, then chunks of 4-byte big-endian compressed length + payload.
- **bzip2** (``Bz2File``): stdlib ``bz2``; Hadoop's BZip2Codec writes
  standard (possibly concatenated) .bz2 streams.

The native library is required: it is built at first use and raises if
it cannot be, as everywhere in the port. Truncated or corrupt streams
raise ``TFRecordCorruptionError``.
"""

from __future__ import annotations

import io
from typing import BinaryIO, Optional


def _corruption(msg: str) -> Exception:
    from tpu_tfrecord_torch.wire import TFRecordCorruptionError

    return TFRecordCorruptionError(msg)


from tpu_tfrecord_torch.wire import read_exact as _read_exact  # noqa: E402


# ---------------------------------------------------------------------------
# Raw snappy
# ---------------------------------------------------------------------------


def _read_varint(buf, pos: int):
    shift = 0
    out = 0
    while True:
        if pos >= len(buf):
            raise _corruption("snappy: truncated length varint")
        b = buf[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, pos
        shift += 7
        if shift > 35:
            raise _corruption("snappy: length varint too long")


def _write_varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def snappy_decompress(data: bytes) -> bytes:
    """Decode one raw-snappy buffer (the format inside Hadoop's block
    framing) with the native decoder: literal elements and 1/2/4-byte
    offset copies, overlapping copies included."""
    from tpu_tfrecord_torch import _native

    try:
        return _native.snappy_decompress(data)
    except ValueError as e:
        raise _corruption(f"snappy: {e}") from e


def _snappy_decompress_py(data: bytes) -> bytes:
    """Pure-Python reference decoder (also the oracle for the native one)."""
    buf = memoryview(data)
    expected, pos = _read_varint(buf, 0)
    out = bytearray()
    n = len(buf)
    while pos < n:
        tag = buf[pos]
        pos += 1
        kind = tag & 0x03
        if kind == 0:  # literal
            length = tag >> 2
            if length >= 60:  # 60..63 -> that many extra length bytes
                extra = length - 59
                if pos + extra > n:
                    raise _corruption("snappy: truncated literal length")
                length = int.from_bytes(buf[pos : pos + extra], "little")
                pos += extra
            length += 1
            if pos + length > n:
                raise _corruption("snappy: truncated literal")
            out += buf[pos : pos + length]
            pos += length
            continue
        if kind == 1:  # copy, 1-byte offset
            length = ((tag >> 2) & 0x07) + 4
            if pos >= n:
                raise _corruption("snappy: truncated copy offset")
            offset = ((tag >> 5) << 8) | buf[pos]
            pos += 1
        elif kind == 2:  # copy, 2-byte offset
            length = (tag >> 2) + 1
            if pos + 2 > n:
                raise _corruption("snappy: truncated copy offset")
            offset = int.from_bytes(buf[pos : pos + 2], "little")
            pos += 2
        else:  # copy, 4-byte offset
            length = (tag >> 2) + 1
            if pos + 4 > n:
                raise _corruption("snappy: truncated copy offset")
            offset = int.from_bytes(buf[pos : pos + 4], "little")
            pos += 4
        if offset == 0 or offset > len(out):
            raise _corruption("snappy: copy offset out of range")
        start = len(out) - offset
        if offset >= length:
            out += out[start : start + length]
        else:  # overlapping copy: RLE semantics, byte at a time
            for i in range(length):
                out.append(out[start + i])
    if len(out) != expected:
        raise _corruption(
            f"snappy: decoded {len(out)} bytes, header promised {expected}"
        )
    return bytes(out)


def snappy_compress(data: bytes) -> bytes:
    """Encode raw snappy with the native greedy-matching encoder."""
    from tpu_tfrecord_torch import _native

    return _native.snappy_compress(data)


def _snappy_compress_py(data: bytes) -> bytes:
    """Literal-only snappy encoder (valid snappy, ratio 1.0): the JAX
    package's last fallback, kept as an oracle."""
    out = bytearray(_write_varint(len(data)))
    pos = 0
    n = len(data)
    while pos < n:
        chunk = min(n - pos, 1 << 16)
        length = chunk - 1
        if length < 60:
            out.append(length << 2)
        else:
            extra = (length.bit_length() + 7) // 8
            out.append((59 + extra) << 2)
            out += length.to_bytes(extra, "little")
        out += data[pos : pos + chunk]
        pos += chunk
    return bytes(out)


# ---------------------------------------------------------------------------
# LZ4 block format
# ---------------------------------------------------------------------------


def lz4_decompress(
    data: bytes,
    expected: Optional[int] = None,
    max_out: Optional[int] = None,
) -> bytes:
    """Decode one lz4 BLOCK (the format inside Hadoop's Lz4Codec framing)
    with the native decoder: sequences of [token][literal-len ext]
    [literals][offset LE16][match-len ext], the last one literals only.
    ``expected`` is enforced exactly; ``max_out`` only sizes the output
    buffer (the block header's remaining bytes)."""
    from tpu_tfrecord_torch import _native

    try:
        return _native.lz4_decompress(data, expected, max_out)
    except ValueError as e:
        raise _corruption(f"lz4: {e}") from e


def _lz4_decompress_py(data: bytes, expected: Optional[int] = None) -> bytes:
    """Pure-Python reference decoder (also the oracle for the native one)."""
    buf = memoryview(data)
    out = bytearray()
    pos = 0
    n = len(buf)
    while pos < n:
        token = buf[pos]
        pos += 1
        lit_len = token >> 4
        if lit_len == 15:
            while True:
                if pos >= n:
                    raise _corruption("lz4: truncated literal length")
                b = buf[pos]
                pos += 1
                lit_len += b
                if b != 255:
                    break
        if pos + lit_len > n:
            raise _corruption("lz4: truncated literals")
        out += buf[pos : pos + lit_len]
        pos += lit_len
        if pos >= n:
            break  # final literals-only sequence
        if pos + 2 > n:
            raise _corruption("lz4: truncated match offset")
        offset = int.from_bytes(buf[pos : pos + 2], "little")
        pos += 2
        if offset == 0 or offset > len(out):
            raise _corruption("lz4: match offset out of range")
        match_len = (token & 0x0F) + 4
        if (token & 0x0F) == 15:
            while True:
                if pos >= n:
                    raise _corruption("lz4: truncated match length")
                b = buf[pos]
                pos += 1
                match_len += b
                if b != 255:
                    break
        start = len(out) - offset
        if offset >= match_len:
            out += out[start : start + match_len]
        else:
            for i in range(match_len):
                out.append(out[start + i])
    if expected is not None and len(out) != expected:
        raise _corruption(
            f"lz4: decoded {len(out)} bytes, framing promised {expected}"
        )
    return bytes(out)


# The native lz4 encoder's match table stores int32 positions: a single
# call beyond this is out of contract (positions would alias past 2 GiB —
# matches are byte-verified so output stays VALID, but the ratio collapses
# silently). Guarded here as well as in _native so the dispatch can never
# silently degrade; module-level so tests can shrink it and pin the
# fallback without allocating 2 GiB.
LZ4_NATIVE_MAX_BYTES = 2**31 - 1


def lz4_compress(data: bytes) -> bytes:
    """Encode one lz4 block with the native greedy-matching encoder.
    Inputs past ``LZ4_NATIVE_MAX_BYTES`` take the literal-only encoder
    (legal: the last sequence of a block carries only literals); Hadoop
    block framing never gets there, it frames in 256 KiB blocks."""
    from tpu_tfrecord_torch import _native

    if len(data) <= LZ4_NATIVE_MAX_BYTES:
        return _native.lz4_compress(data)
    return _lz4_compress_py(data)


def _lz4_compress_py(data: bytes) -> bytes:
    """Literal-only lz4 block encoder."""
    n = len(data)
    out = bytearray()
    if n < 15:
        out.append(n << 4)
    else:
        out.append(0xF0)
        rest = n - 15
        while rest >= 255:
            out.append(255)
            rest -= 255
        out.append(rest)
    out += data
    return bytes(out)


# ---------------------------------------------------------------------------
# Hadoop block stream framing (BlockCompressorStream layout)
# ---------------------------------------------------------------------------

_RAW_CODECS = {
    "snappy": (snappy_compress, snappy_decompress),
    "lz4": (lz4_compress, lz4_decompress),
}

# Hadoop io.compression.codec.snappy.buffersize default (SnappyCodec) —
# also a safe block size for Lz4Codec interop.
_BLOCK_SIZE = 256 * 1024


def compress_hadoop_blocks(codec: str, data) -> bytes:
    """Compress one slab into whole BlockCompressorStream blocks. Blocks are
    self-delimiting (uncompressed-length + chunk-length headers), so the
    concatenation of slabs compressed independently is exactly the stream
    HadoopBlockFile would have produced for the concatenated plaintext with
    aligned block boundaries — this is what lets the parallel writer
    compress snappy/lz4 slabs on worker threads."""
    compress, _ = _RAW_CODECS[codec]
    # one bytes copy per 256KB block (the native compressors take bytes);
    # the memoryview avoids copying the whole multi-MB slab up front
    view = memoryview(data).cast("B")
    out = bytearray()
    for pos in range(0, len(view), _BLOCK_SIZE):
        block = bytes(view[pos : pos + _BLOCK_SIZE])
        comp = compress(block)
        out += len(block).to_bytes(4, "big")
        out += len(comp).to_bytes(4, "big")
        out += comp
    return bytes(out)


class HadoopBlockFile(io.RawIOBase):
    """BlockCompressorStream/BlockDecompressorStream wire layout shared by
    Hadoop's SnappyCodec and Lz4Codec: per block a 4-byte big-endian
    uncompressed length, then one or more chunks of 4-byte big-endian
    compressed length + compressed payload until the block is complete.
    Writes flush whole blocks; close() closes the underlying stream
    (remote writers upload on close)."""

    def __init__(self, path: str, mode: str, codec: str,
                 fileobj: Optional[BinaryIO] = None):
        super().__init__()
        self._path = path
        self._codec = codec
        self._compress, self._decompress = _RAW_CODECS[codec]
        # lz4 chunks carry no own output-size header; the block header's
        # remaining byte count sizes the native decode buffer exactly
        self._pass_bound = codec == "lz4"
        if "w" in mode:
            self._raw = fileobj if fileobj is not None else open(path, "wb")
            self._writing = True
            self._wbuf = bytearray()
        else:
            self._raw = fileobj if fileobj is not None else open(path, "rb")
            self._writing = False
            self._pending = bytearray()
            self._eof = False

    def readable(self) -> bool:
        return not self._writing

    def writable(self) -> bool:
        return self._writing

    # -- read side ---------------------------------------------------------

    def _read_be4(self, what: str) -> Optional[int]:
        hdr = _read_exact(self._raw, 4)
        if not hdr:
            return None  # clean EOF only at a block boundary
        if len(hdr) < 4:
            raise _corruption(
                f"truncated {self._codec} stream in {self._path}: partial {what}"
            )
        return int.from_bytes(hdr, "big")

    def _fill(self) -> None:
        uncomp_len = self._read_be4("block header")
        if uncomp_len is None:
            self._eof = True
            return
        got = 0
        while got < uncomp_len:
            chunk_len = self._read_be4("chunk header")
            if chunk_len is None:
                raise _corruption(
                    f"truncated {self._codec} stream in {self._path}: "
                    "EOF inside a block"
                )
            chunk = _read_exact(self._raw, chunk_len)
            if len(chunk) < chunk_len:
                raise _corruption(
                    f"truncated {self._codec} stream in {self._path}: "
                    "EOF inside a chunk"
                )
            if self._pass_bound:
                plain = self._decompress(chunk, max_out=uncomp_len - got)
            else:
                plain = self._decompress(chunk)
            got += len(plain)
            self._pending += plain
        if got != uncomp_len:
            raise _corruption(
                f"corrupt {self._codec} stream in {self._path}: block "
                f"decoded to {got} bytes, header promised {uncomp_len}"
            )

    def read(self, size: int = -1) -> bytes:
        if size is None or size < 0:
            while not self._eof:
                self._fill()
            out = bytes(self._pending)
            self._pending = bytearray()
            return out
        while len(self._pending) < size and not self._eof:
            self._fill()
        out = bytes(self._pending[:size])
        del self._pending[:size]
        return out

    def readinto(self, b) -> int:
        data = self.read(len(b))
        b[: len(data)] = data
        return len(data)

    # -- write side --------------------------------------------------------

    def _emit_block(self, block: bytes) -> None:
        comp = self._compress(block)
        self._raw.write(len(block).to_bytes(4, "big"))
        self._raw.write(len(comp).to_bytes(4, "big"))
        self._raw.write(comp)

    def _flush_block(self) -> None:
        if self._wbuf:
            block = bytes(self._wbuf)
            self._wbuf = bytearray()
            self._emit_block(block)

    def write(self, data) -> int:
        self._wbuf += data
        while len(self._wbuf) >= _BLOCK_SIZE:
            block = bytes(self._wbuf[:_BLOCK_SIZE])
            del self._wbuf[:_BLOCK_SIZE]
            self._emit_block(block)
        return len(data)

    def close(self) -> None:
        if not self.closed:
            try:
                if self._writing:
                    self._flush_block()
            finally:
                if not self._raw.closed:
                    self._raw.close()
                super().close()


# ---------------------------------------------------------------------------
# bzip2 (stdlib)
# ---------------------------------------------------------------------------


class Bz2File(io.RawIOBase):
    """Hadoop BZip2Codec streams are standard (possibly concatenated) .bz2.
    stdlib bz2 handles multi-stream; EOFError on a truncated stream maps to
    TFRecordCorruptionError like every other codec here."""

    def __init__(self, path: str, mode: str, fileobj: Optional[BinaryIO] = None):
        super().__init__()
        import bz2

        self._path = path
        raw = fileobj if fileobj is not None else open(
            path, "wb" if "w" in mode else "rb"
        )
        self._raw = raw
        self._inner = bz2.BZ2File(raw, "wb" if "w" in mode else "rb")
        self._writing = "w" in mode

    def readable(self) -> bool:
        return not self._writing

    def writable(self) -> bool:
        return self._writing

    def read(self, size: int = -1) -> bytes:
        try:
            return self._inner.read(size if size is not None and size >= 0 else -1)
        except (EOFError, OSError) as e:
            raise _corruption(
                f"truncated or corrupt bzip2 stream in {self._path}: {e}"
            ) from e

    def readinto(self, b) -> int:
        data = self.read(len(b))
        b[: len(data)] = data
        return len(data)

    def write(self, data) -> int:
        return self._inner.write(data)

    def close(self) -> None:
        if not self.closed:
            try:
                self._inner.close()
            finally:
                if not self._raw.closed:
                    self._raw.close()
                super().close()
