"""TFRecord wire format: record framing with masked CRC32C checksums.

Copy of the pure-Python half of ``tpu_tfrecord/wire.py`` for local files,
with the uncompressed, gzip and deflate codecs. Frame layout per record::

    uint64  length        (little-endian)
    uint32  masked_crc32c(length bytes)
    bytes   data[length]
    uint32  masked_crc32c(data)

``crc32c`` goes through the native library (``_native.crc32c``, hardware
CRC32 on x86-64), which is built at its first call; ``crc32c_py`` is the
slicing-by-8 pure-Python version, kept as the oracle the tests hold the
native one against.
"""

from __future__ import annotations

import gzip
import io
import struct
import zlib
from typing import BinaryIO, Iterator, List, Optional

# ---------------------------------------------------------------------------
# CRC32C (Castagnoli, polynomial 0x1EDC6F41, reflected 0x82F63B78)
# ---------------------------------------------------------------------------

_POLY = 0x82F63B78


def _make_tables(n: int = 8) -> List[List[int]]:
    """Slicing-by-N tables: table[0] is the plain byte-at-a-time table."""
    t0 = []
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ (_POLY if crc & 1 else 0)
        t0.append(crc)
    tables = [t0]
    for k in range(1, n):
        prev = tables[k - 1]
        tables.append([(prev[i] >> 8) ^ t0[prev[i] & 0xFF] for i in range(256)])
    return tables


_T0, _T1, _T2, _T3, _T4, _T5, _T6, _T7 = _make_tables(8)


def crc32c_py(data: bytes, crc: int = 0) -> int:
    """CRC32C of ``data`` (slicing-by-8 in Python), continuing from ``crc``."""
    crc = crc ^ 0xFFFFFFFF
    n = len(data)
    i = 0
    end8 = n - (n % 8)
    while i < end8:
        b0 = data[i] ^ (crc & 0xFF)
        b1 = data[i + 1] ^ ((crc >> 8) & 0xFF)
        b2 = data[i + 2] ^ ((crc >> 16) & 0xFF)
        b3 = data[i + 3] ^ ((crc >> 24) & 0xFF)
        crc = (
            _T7[b0]
            ^ _T6[b1]
            ^ _T5[b2]
            ^ _T4[b3]
            ^ _T3[data[i + 4]]
            ^ _T2[data[i + 5]]
            ^ _T1[data[i + 6]]
            ^ _T0[data[i + 7]]
        )
        i += 8
    while i < n:
        crc = (crc >> 8) ^ _T0[(crc ^ data[i]) & 0xFF]
        i += 1
    return crc ^ 0xFFFFFFFF


def crc32c(data: bytes) -> int:
    """CRC32C of ``data`` through the native library."""
    # imported here, not at the top: _native imports options, which imports wire
    from tpu_tfrecord_torch import _native

    return _native.crc32c(data)


_MASK_DELTA = 0xA282EAD8


def masked_crc32c(data: bytes) -> int:
    """The TFRecord 'masked' CRC: rotate right by 15 and add a constant."""
    crc = crc32c(data)
    return ((((crc >> 15) | (crc << 17)) & 0xFFFFFFFF) + _MASK_DELTA) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Compression codecs
# ---------------------------------------------------------------------------

_CODEC_ALIASES = {
    "": None,
    "none": None,
    "uncompressed": None,
    "gzip": "gzip",
    "gz": "gzip",
    "org.apache.hadoop.io.compress.gzipcodec": "gzip",
    "deflate": "deflate",
    "zlib": "deflate",
    "org.apache.hadoop.io.compress.defaultcodec": "deflate",
    "org.apache.hadoop.io.compress.deflatecodec": "deflate",
}

_CODEC_EXTENSIONS = {"gzip": ".gz", "deflate": ".deflate"}


def normalize_codec(codec: Optional[str]) -> Optional[str]:
    """Resolve a user-supplied codec name to a canonical codec or raise."""
    if codec is None:
        return None
    key = codec.strip().lower()
    if key in _CODEC_ALIASES:
        return _CODEC_ALIASES[key]
    raise ValueError(
        f"Unsupported codec {codec!r}: supported codecs are 'gzip' and "
        "'deflate' (or their Hadoop class names)"
    )


def codec_extension(codec: Optional[str]) -> str:
    """File-name suffix appended after '.tfrecord' (ref DefaultSource.scala:112-114)."""
    codec = normalize_codec(codec)
    return _CODEC_EXTENSIONS.get(codec, "") if codec else ""


def codec_from_path(path: str) -> Optional[str]:
    """Infer the codec from a file extension, like Hadoop's codec factory."""
    lower = path.lower()
    if lower.endswith(".gz") or lower.endswith(".gzip"):
        return "gzip"
    if lower.endswith(".deflate") or lower.endswith(".zlib"):
        return "deflate"
    return None


def open_compressed(path: str, mode: str, codec: Optional[str]) -> BinaryIO:
    """Open a local record stream, wrapped in ``codec`` when it has one."""
    codec = normalize_codec(codec)
    if codec == "gzip":
        return gzip.open(path, mode)  # type: ignore[return-value]
    if codec == "deflate":
        return _DeflateFile(path, mode)  # type: ignore[return-value]
    return open(path, mode)


class _DeflateFile(io.RawIOBase):
    """zlib-wrapped file (Hadoop DefaultCodec writes raw zlib streams).

    Reads decompress incrementally and decode concatenated zlib streams back
    to back; a file that ends mid-stream raises TFRecordCorruptionError."""

    _READ_CHUNK = 1 << 20  # compressed bytes per underlying read

    def __init__(self, path: str, mode: str):
        super().__init__()
        self._path = path
        self._fh = open(path, mode)
        if "w" in mode:
            self._compress = zlib.compressobj()
            self._decompress = None
        else:
            self._compress = None
            self._decompress = zlib.decompressobj()
            self._pending = bytearray()
            self._eof = False

    def readable(self) -> bool:
        return self._decompress is not None

    def writable(self) -> bool:
        return self._compress is not None

    def _fill(self, want: int) -> None:
        try:
            d = self._decompress
            if d.eof:
                raw = d.unused_data or self._fh.read(self._READ_CHUNK)
                if not raw:
                    self._eof = True
                    return
                self._decompress = d = zlib.decompressobj()
                self._pending += d.decompress(raw, want)
            elif d.unconsumed_tail:
                self._pending += d.decompress(d.unconsumed_tail, want)
            else:
                raw = self._fh.read(self._READ_CHUNK)
                if not raw:
                    tail = d.flush()
                    if not d.eof:
                        raise TFRecordCorruptionError(
                            f"truncated deflate stream in {self._path}"
                        )
                    self._pending += tail
                    self._eof = True
                    return
                self._pending += d.decompress(raw, want)
        except zlib.error as e:
            raise TFRecordCorruptionError(
                f"corrupt deflate stream in {self._path}: {e}"
            ) from e

    def read(self, size: int = -1) -> bytes:
        if size is None or size < 0:
            while not self._eof:
                self._fill(self._READ_CHUNK)
            out = bytes(self._pending)
            self._pending = bytearray()
            return out
        while len(self._pending) < size and not self._eof:
            self._fill(size - len(self._pending))
        out = bytes(self._pending[:size])
        del self._pending[:size]
        return out

    def readinto(self, b) -> int:
        data = self.read(len(b))
        b[: len(data)] = data
        return len(data)

    def write(self, data) -> int:
        self._fh.write(self._compress.compress(bytes(data)))
        return len(data)

    def close(self) -> None:
        if not self.closed:
            if self._compress is not None:
                self._fh.write(self._compress.flush())
            self._fh.close()
            super().close()


# ---------------------------------------------------------------------------
# Record-level framing
# ---------------------------------------------------------------------------

_LEN_STRUCT = struct.Struct("<Q")
_CRC_STRUCT = struct.Struct("<I")
HEADER_BYTES = 12  # 8-byte length + 4-byte length crc
FOOTER_BYTES = 4  # 4-byte data crc


class TFRecordCorruptionError(IOError):
    """Raised when framing or CRC validation fails."""


def encode_record(data: bytes) -> bytes:
    """Frame one record (length + masked length CRC + data + masked data CRC)."""
    header = _LEN_STRUCT.pack(len(data))
    return b"".join(
        (
            header,
            _CRC_STRUCT.pack(masked_crc32c(header)),
            data,
            _CRC_STRUCT.pack(masked_crc32c(data)),
        )
    )


def read_exact(fh, n: int) -> bytes:
    """Read exactly n bytes, looping over short reads; only a 0-byte read is
    EOF, and only EOF mid-record is truncation."""
    data = fh.read(n)
    if len(data) in (0, n):
        return data
    parts = [data]
    got = len(data)
    while got < n:
        more = fh.read(n - got)
        if not more:
            break
        parts.append(more)
        got += len(more)
    return b"".join(parts)


class RecordReader:
    """Streaming TFRecord reader over a binary file object."""

    def __init__(self, fh: BinaryIO, verify_crc: bool = True):
        self._fh = fh
        self._verify = verify_crc

    def read(self) -> Optional[bytes]:
        """Read one record; returns None at a clean EOF."""
        header = read_exact(self._fh, HEADER_BYTES)
        if len(header) == 0:
            return None
        if len(header) < HEADER_BYTES:
            raise TFRecordCorruptionError("truncated TFRecord header")
        (length,) = _LEN_STRUCT.unpack_from(header, 0)
        (length_crc,) = _CRC_STRUCT.unpack_from(header, 8)
        if self._verify and masked_crc32c(header[:8]) != length_crc:
            raise TFRecordCorruptionError("corrupt TFRecord: bad length CRC")
        body = read_exact(self._fh, length + FOOTER_BYTES)
        if len(body) < length + FOOTER_BYTES:
            raise TFRecordCorruptionError("truncated TFRecord body")
        data = body[:length]
        if self._verify:
            (data_crc,) = _CRC_STRUCT.unpack_from(body, length)
            if masked_crc32c(data) != data_crc:
                raise TFRecordCorruptionError("corrupt TFRecord: bad data CRC")
        return data

    def __iter__(self) -> Iterator[bytes]:
        while True:
            rec = self.read()
            if rec is None:
                return
            yield rec


# ---------------------------------------------------------------------------
# File-level helpers
# ---------------------------------------------------------------------------


def write_records(path: str, records, codec: Optional[str] = None) -> int:
    """Write an iterable of serialized records to one TFRecord file."""
    count = 0
    with open_compressed(path, "wb", codec) as fh:
        for rec in records:
            fh.write(encode_record(rec))
            count += 1
    return count


def read_records(
    path: str, codec: Optional[str] = "auto", verify_crc: bool = True
) -> Iterator[bytes]:
    """Iterate serialized records from one TFRecord file; ``codec='auto'``
    infers compression from the extension."""
    if codec == "auto":
        codec = codec_from_path(path)
    with open_compressed(path, "rb", codec) as fh:
        yield from RecordReader(fh, verify_crc=verify_crc)
