"""TFRecord wire format: record framing with masked CRC32C checksums.

Copy of ``tpu_tfrecord/wire.py``, for local paths and URLs (through
``fs``), with every codec of the JAX package: gzip, deflate, zstd
(through the optional ``zstandard`` module, imported when first needed),
snappy and lz4 (Hadoop block framing, ``hadoop_codecs``) and bzip2. Frame
layout per record::

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
import os
import struct
import zlib
from typing import BinaryIO, Iterator, List, Optional, Tuple

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
#
# The reference maps a `codec` option onto Hadoop compression-codec class names
# (DefaultSource.scala:95-102) and infers the read codec from the file
# extension (Hadoop behavior). We support the same codecs Hadoop's
# GzipCodec/DefaultCodec provide, keyed by short name, Hadoop class name, or
# file extension.

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
    "zstd": "zstd",
    "zstandard": "zstd",
    "org.apache.hadoop.io.compress.zstandardcodec": "zstd",
    # Full Hadoop passthrough breadth (ref DefaultSource.scala:95-102
    # forwards ANY codec class name into the Hadoop conf): snappy and lz4
    # via the dependency-free implementations in hadoop_codecs.py, bzip2
    # via stdlib bz2.
    "snappy": "snappy",
    "org.apache.hadoop.io.compress.snappycodec": "snappy",
    "lz4": "lz4",
    "org.apache.hadoop.io.compress.lz4codec": "lz4",
    "bzip2": "bzip2",
    "bz2": "bzip2",
    "org.apache.hadoop.io.compress.bzip2codec": "bzip2",
}

_CODEC_EXTENSIONS = {
    "gzip": ".gz",
    "deflate": ".deflate",
    "zstd": ".zst",
    "snappy": ".snappy",
    "lz4": ".lz4",
    "bzip2": ".bz2",
}


def _zstandard():
    """The optional zstandard module, or None (zstd support is gated)."""
    try:
        import zstandard

        return zstandard
    except ImportError:
        return None


def normalize_codec(codec: Optional[str]) -> Optional[str]:
    """Resolve a user-supplied codec name to a canonical codec or raise."""
    if codec is None:
        return None
    key = codec.strip().lower()
    if key in _CODEC_ALIASES:
        resolved = _CODEC_ALIASES[key]
        if resolved == "zstd" and _zstandard() is None:
            raise ValueError(
                f"codec {codec!r} requires the optional 'zstandard' package"
            )
        return resolved
    raise ValueError(
        f"Unsupported codec {codec!r}: supported codecs are 'gzip', "
        "'deflate', 'zstd', 'snappy', 'lz4', and 'bzip2' (or their Hadoop "
        "class names)"
    )


def codec_extension(codec: Optional[str]) -> str:
    """File-name suffix appended after '.tfrecord' (ref DefaultSource.scala:112-114)."""
    codec = normalize_codec(codec)
    return _CODEC_EXTENSIONS.get(codec, "") if codec else ""


def codec_supports_chunks(codec: Optional[str]) -> bool:
    """True if ``compress_chunk`` can emit independently-decodable pieces
    for this codec (concatenating chunks yields a valid stream). True for
    every supported codec today; the probe exists so a future stream-only
    codec degrades the parallel writer to committer-side compression instead
    of producing corrupt files."""
    return normalize_codec(codec) in (
        None, "gzip", "deflate", "zstd", "snappy", "lz4", "bzip2"
    )


def compress_chunk(codec: Optional[str], data) -> bytes:
    """Compress one slab into a self-contained piece of ``codec``'s stream
    format, such that the byte-concatenation of chunks is a valid file of
    that codec. This is what lets the parallel writer compress slabs on
    worker threads instead of serializing behind one stream object:

    - gzip: one gzip member (multi-member files are standard; GzipFile
      reads them). ``mtime=0`` keeps output a pure function of the input.
    - deflate: one zlib stream (the read side handles concatenated
      streams, mirroring how it already handles concatenated zstd frames).
    - zstd: one zstd frame.
    - bzip2: one bz2 stream (stdlib reads multi-stream files).
    - snappy/lz4: a whole number of Hadoop BlockCompressorStream blocks
      (blocks are independent by construction).

    Deterministic: equal input bytes yield equal output bytes, so shard
    content is a function of the data and options, never of worker timing.
    """
    codec = normalize_codec(codec)
    # zlib/gzip/bz2/zstd accept any buffer (numpy arrays included) — no
    # bytes() copy of a multi-MB slab on the worker's hot path
    if codec is None:
        return bytes(data)
    if codec == "gzip":
        return gzip.compress(data, compresslevel=9, mtime=0)
    if codec == "deflate":
        return zlib.compress(data)
    if codec == "zstd":
        zstd = _zstandard()
        if zstd is None:  # normalize_codec guards; defensive
            raise ValueError("zstd codec requires the optional 'zstandard' package")
        return zstd.ZstdCompressor().compress(data)
    if codec == "bzip2":
        import bz2

        return bz2.compress(data)
    if codec in ("snappy", "lz4"):
        from tpu_tfrecord_torch.hadoop_codecs import compress_hadoop_blocks

        return compress_hadoop_blocks(codec, data)
    raise ValueError(f"codec {codec!r} has no chunked compressor")


def codec_from_path(path: str) -> Optional[str]:
    """Infer the codec from a file extension, like Hadoop's codec factory."""
    lower = path.lower()
    if lower.endswith(".gz") or lower.endswith(".gzip"):
        return "gzip"
    if lower.endswith(".deflate") or lower.endswith(".zlib"):
        return "deflate"
    if lower.endswith(".zst") or lower.endswith(".zstd"):
        return "zstd"
    if lower.endswith(".snappy"):
        return "snappy"
    if lower.endswith(".lz4"):
        return "lz4"
    if lower.endswith(".bz2") or lower.endswith(".bzip2"):
        return "bzip2"
    return None


def open_compressed(
    path: str, mode: str, codec: Optional[str], retry_policy=None
) -> BinaryIO:
    """Open a (possibly compressed) record stream, wrapped in the codec. A
    plain path opens through ``fs.local_open`` (the seam
    ``faults.install_chaos`` patches); a URL through its filesystem
    (``fs.filesystem_for``), a read through ``fs.open_for_read``, whose
    block fetches resume at the exact byte under ``retry_policy``."""
    codec = normalize_codec(codec)
    from tpu_tfrecord_torch import fs as _fs

    if _fs.has_scheme(path):
        fsys = _fs.filesystem_for(path)
        if mode in ("rb", "r"):
            raw = _fs.open_for_read(fsys, path, retry_policy=retry_policy)
        else:
            raw = fsys.open(path, mode)
    else:
        raw = _fs.local_open(path, mode)
    return wrap_codec(path, mode, codec, raw)


def wrap_codec(
    path: str, mode: str, codec: Optional[str], raw: BinaryIO
) -> BinaryIO:
    """Wrap an already-open raw byte stream in the codec for ``path`` —
    the codec half of ``open_compressed``."""
    if codec == "gzip":
        return _ClosingGzip(raw, mode)  # type: ignore[return-value]
    if codec == "deflate":
        return _DeflateFile(path, mode, fileobj=raw)
    if codec == "zstd":
        return _ZstdFile(path, mode, fileobj=raw)
    if codec in ("snappy", "lz4"):
        from tpu_tfrecord_torch.hadoop_codecs import HadoopBlockFile

        return HadoopBlockFile(path, mode, codec, fileobj=raw)
    if codec == "bzip2":
        from tpu_tfrecord_torch.hadoop_codecs import Bz2File

        return Bz2File(path, mode, fileobj=raw)
    return raw


class _ZstdFile(io.RawIOBase):
    """zstd-framed stream (Hadoop ZStandardCodec / .zst files), backed by
    the optional ``zstandard`` package. Reads stream incrementally through
    ``decompressobj`` and CHECK frame completion at EOF via its ``eof``
    flag — ``stream_reader`` returns a clean short read on a truncated
    frame, which would silently drop trailing records (the same trap
    _DeflateFile guards with zlib's eof). Concatenated frames are handled.
    Writes flush the frame on close and close the underlying stream
    (remote writers upload on close)."""

    _READ_CHUNK = 1 << 20  # compressed bytes per underlying read

    def __init__(self, path: str, mode: str, fileobj: Optional[BinaryIO] = None):
        super().__init__()
        zstd = _zstandard()
        if zstd is None:  # normalize_codec guards, but be safe
            raise ValueError("zstd codec requires the optional 'zstandard' package")
        self._zstd = zstd
        self._path = path
        if "w" in mode:
            self._raw = fileobj if fileobj is not None else open(path, "wb")
            self._writer = zstd.ZstdCompressor().stream_writer(
                self._raw, closefd=False
            )
            self._dobj = None
        else:
            self._raw = fileobj if fileobj is not None else open(path, "rb")
            self._writer = None
            self._dobj = zstd.ZstdDecompressor().decompressobj()
            self._pending = bytearray()
            self._eof = False

    def readable(self) -> bool:
        return self._dobj is not None

    def writable(self) -> bool:
        return self._writer is not None

    def _fill(self) -> None:
        raw = self._raw.read(self._READ_CHUNK)
        if not raw:
            if not self._dobj.eof:
                raise TFRecordCorruptionError(
                    f"truncated zstd stream in {self._path}"
                )
            self._eof = True
            return
        try:
            while raw:
                if self._dobj.eof:
                    # The previous frame ended exactly at a read-chunk
                    # boundary (eof=True, empty unused_data): a finished
                    # decompressobj cannot be fed again, so start a fresh
                    # one for the next concatenated frame.
                    self._dobj = self._zstd.ZstdDecompressor().decompressobj()
                self._pending += self._dobj.decompress(raw)
                if self._dobj.eof:
                    # concatenated frames: restart on the leftover input
                    raw = self._dobj.unused_data
                    if raw:
                        self._dobj = self._zstd.ZstdDecompressor().decompressobj()
                        continue
                break
        except self._zstd.ZstdError as e:
            raise TFRecordCorruptionError(
                f"corrupt zstd stream in {self._path}: {e}"
            ) from e

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

    def write(self, data) -> int:
        return self._writer.write(data)

    def close(self) -> None:
        if not self.closed:
            try:
                if self._writer is not None:
                    self._writer.close()  # flushes the frame
            finally:
                if not self._raw.closed:
                    self._raw.close()
                super().close()


class _ClosingGzip(gzip.GzipFile):
    """GzipFile that also closes the underlying stream — GzipFile(fileobj=)
    deliberately leaves it open, but remote-FS writers only upload on
    close."""

    def __init__(self, raw: BinaryIO, mode: str):
        super().__init__(fileobj=raw, mode=mode)
        self._raw = raw

    def close(self) -> None:
        try:
            super().close()
        finally:
            if not self._raw.closed:
                self._raw.close()


class _DeflateFile(io.RawIOBase):
    """zlib-wrapped file (Hadoop DefaultCodec writes raw zlib streams).

    Reads stream through ``zlib.decompressobj`` with bounded output per
    step (mirroring how gzip.open streams), so a large ``.deflate`` shard
    honors the slab-streaming bounded-memory contract (io/dataset.py
    ``_shard_slabs``) instead of materializing whole on open.

    CONCATENATED zlib streams are decoded back to back (the same contract
    _ZstdFile provides for concatenated frames): the parallel writer's
    chunked compressor emits one independent stream per slab, and a reader
    that stopped at the first stream end would silently drop every record
    after slab 0.
    """

    _READ_CHUNK = 1 << 20  # compressed bytes per underlying read

    def __init__(self, path: str, mode: str, fileobj: Optional[BinaryIO] = None):
        super().__init__()
        self._mode = mode
        self._path = path
        if "w" in mode:
            self._fh = fileobj if fileobj is not None else open(path, "wb")
            self._compress = zlib.compressobj()
            self._decompress = None
        else:
            self._fh = fileobj if fileobj is not None else open(path, "rb")
            self._compress = None
            self._decompress = zlib.decompressobj()
            self._pending = bytearray()
            self._eof = False

    def readable(self) -> bool:
        return self._decompress is not None

    def writable(self) -> bool:
        return self._compress is not None

    def _fill(self, want: int) -> None:
        """Decompress until ``want`` more bytes are pending or EOF; output
        per step is capped at ``want`` so memory stays ~pending+want. All
        zlib decode errors surface as TFRecordCorruptionError — the module's
        corruption contract — including bad bytes where a concatenated
        stream's header was expected."""
        try:
            self._fill_inner(want)
        except zlib.error as e:
            raise TFRecordCorruptionError(
                f"corrupt deflate stream in {self._path}: {e}"
            ) from e

    def _fill_inner(self, want: int) -> None:
        d = self._decompress
        if d.eof:
            # Stream finished: concatenated streams (chunked writer output)
            # restart a fresh decompressobj on the leftover input, or on the
            # next read when the stream ended exactly at a chunk boundary.
            raw = d.unused_data
            if not raw:
                raw = self._fh.read(self._READ_CHUNK)
                if not raw:
                    self._eof = True
                    return
            self._decompress = d = zlib.decompressobj()
            self._pending += d.decompress(raw, want)
            return
        if d.unconsumed_tail:
            self._pending += d.decompress(d.unconsumed_tail, want)
            return
        raw = self._fh.read(self._READ_CHUNK)
        if not raw:
            tail = d.flush()
            if not d.eof:
                # file ended mid-stream (partial copy/upload): whole-file
                # zlib.decompress raised here; streaming must too, or
                # trailing rows vanish silently
                raise TFRecordCorruptionError(
                    f"truncated deflate stream in {self._path}"
                )
            self._pending += tail
            self._eof = True
            return
        self._pending += d.decompress(raw, want)

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
            if self._fh is not None:
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


class RecordWriter:
    """Streaming TFRecord writer over a binary file object.

    Counterpart of the shaded ``TFRecordWriter`` used at reference
    TFRecordOutputWriter.scala:21,37.
    """

    def __init__(self, fh: BinaryIO):
        self._fh = fh
        self.records_written = 0
        self.bytes_written = 0

    def write(self, data: bytes) -> None:
        framed = encode_record(data)
        self._fh.write(framed)
        self.records_written += 1
        self.bytes_written += len(framed)

    def flush(self) -> None:
        self._fh.flush()


def read_exact(fh, n: int) -> bytes:
    """Read exactly n bytes, looping over short reads: remote/object-store
    streams may legally return fewer bytes per call than asked — only a
    0-byte read is EOF, and only EOF mid-record is truncation. Shared by
    every framing reader (RecordReader here, HadoopBlockFile)."""
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
    """Streaming TFRecord reader over a binary file object.

    Counterpart of the shaded ``TFRecordFileInputFormat`` record
    reader used at reference TFRecordFileReader.scala:32-51.
    """

    def __init__(self, fh: BinaryIO, verify_crc: bool = True):
        self._fh = fh
        self._verify = verify_crc
        self.records_read = 0
        self.bytes_read = 0

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
        self.records_read += 1
        self.bytes_read += HEADER_BYTES + length + FOOTER_BYTES
        return data

    def __iter__(self) -> Iterator[bytes]:
        while True:
            rec = self.read()
            if rec is None:
                return
            yield rec


def scan_buffer_partial(
    buf: bytes, verify_crc: bool = True, max_records: Optional[int] = None
) -> Tuple[List[Tuple[int, int]], int]:
    """Scan complete frames in a buffer; a record extending past the end is
    a TAIL (to carry into the next slab), not corruption. Returns
    ([(offset, length), ...], consumed_bytes). ``max_records`` stops the
    scan cleanly after that many records — bytes past them are neither
    framed nor CRC-checked (same contract as the native scan_partial)."""
    spans: List[Tuple[int, int]] = []
    pos = 0
    n = len(buf)
    consumed = 0
    while pos < n:
        if max_records is not None and len(spans) >= max_records:
            break
        if pos + HEADER_BYTES > n:
            break
        (length,) = _LEN_STRUCT.unpack_from(buf, pos)
        if verify_crc:
            (length_crc,) = _CRC_STRUCT.unpack_from(buf, pos + 8)
            if masked_crc32c(buf[pos : pos + 8]) != length_crc:
                raise TFRecordCorruptionError("corrupt TFRecord: bad length CRC")
        start = pos + HEADER_BYTES
        if n - start < FOOTER_BYTES or length > n - start - FOOTER_BYTES:
            break
        if verify_crc:
            (data_crc,) = _CRC_STRUCT.unpack_from(buf, start + length)
            if masked_crc32c(buf[start : start + length]) != data_crc:
                raise TFRecordCorruptionError("corrupt TFRecord: bad data CRC")
        spans.append((start, length))
        pos = start + length + FOOTER_BYTES
        consumed = pos
    return spans, consumed


def resync(
    buf,
    pos: int,
    max_record_bytes: Optional[int] = None,
    end: Optional[int] = None,
) -> int:
    """Scan forward from ``pos`` for the next plausible record header, so a
    shard with one bad frame loses one record instead of everything after
    it. A candidate offset qualifies when its 8-byte little-endian length is
    sane (<= ``max_record_bytes`` when given) AND the 4-byte masked
    length-CRC that follows matches — a ~2^-32 false-positive filter. When
    the whole candidate frame lies inside ``buf[:end]`` the data CRC must
    confirm too (~2^-64 combined); a candidate whose frame extends past the
    buffer is accepted on the header alone and carried by the caller as a
    tail. Returns the candidate offset, or -1 if none exists — the last
    HEADER_BYTES-1 bytes can never qualify and should be re-scanned with
    more data appended.
    """
    n = len(buf) if end is None else end
    i = max(0, pos)
    while i + HEADER_BYTES <= n:
        (length,) = _LEN_STRUCT.unpack_from(buf, i)
        if max_record_bytes is None or length <= max_record_bytes:
            (length_crc,) = _CRC_STRUCT.unpack_from(buf, i + 8)
            if masked_crc32c(bytes(buf[i : i + 8])) == length_crc:
                start = i + HEADER_BYTES
                if start + length + FOOTER_BYTES <= n:
                    (data_crc,) = _CRC_STRUCT.unpack_from(buf, start + length)
                    if masked_crc32c(bytes(buf[start : start + length])) == data_crc:
                        return i
                else:
                    return i
        i += 1
    return -1


def scan_buffer(
    buf: bytes, verify_crc: bool = True
) -> Iterator[Tuple[int, int]]:
    """Yield (offset, length) of each record payload in an in-memory buffer;
    a buffer that does not end on a frame boundary is corrupt.

    Strict scan = partial scan + completeness check, so the framing/CRC
    contract lives in exactly one place (same structure in the C++ twin).
    """
    spans, consumed = scan_buffer_partial(buf, verify_crc)
    if consumed != len(buf):
        raise TFRecordCorruptionError("truncated TFRecord")
    yield from spans


# ---------------------------------------------------------------------------
# File-level helpers
# ---------------------------------------------------------------------------


def write_records(
    path: str, records, codec: Optional[str] = None
) -> int:
    """Write an iterable of serialized records to one TFRecord file."""
    count = 0
    with open_compressed(path, "wb", codec) as fh:
        writer = RecordWriter(fh)
        for rec in records:
            writer.write(rec)
            count += 1
    return count


def file_is_empty(path: str) -> bool:
    """True if the file has zero length (ref DefaultSource.scala:82-87)."""
    return os.path.getsize(path) == 0


def read_records(
    path: str, codec: Optional[str] = "auto", verify_crc: bool = True
) -> Iterator[bytes]:
    """Iterate serialized records from one TFRecord file.

    ``codec='auto'`` infers compression from the extension the way the
    reference's read path relies on Hadoop to (README.md: codec "can be
    inferred automatically" on read).
    """
    if codec == "auto":
        codec = codec_from_path(path)
    with open_compressed(path, "rb", codec) as fh:
        yield from RecordReader(fh, verify_crc=verify_crc)
