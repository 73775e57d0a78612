"""Build, load and bind the port's native host library (``csrc/tfrecord_native.cc``).

The decode side of ``tpu_tfrecord/_native.py``: hardware CRC32C, TFRecord
frame scanning, and batch Example/SequenceExample -> columnar decoding with
fused categorical hashing and column-group packing, plus the fused ragged
pads and the transfer bit-packing pass (``pack_mixed``). The library is
host C++ (no CUDA), loaded with ``ctypes.CDLL``, so every call releases
the GIL and the dataset's producer thread decodes while the consumer
scores.

The library is compiled with ``g++`` at first use into ``_build/`` beside
this file, named by the source's content hash (an edited source rebuilds).
The build writes a temporary file and renames it into place under an
exclusive ``flock`` on ``_build/tfrecord_native.lock``, so processes that
start together compile it once and none of them loads a half-written
library. A failed build or load raises; nothing falls back to Python.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from tpu_tfrecord_torch import proto
from tpu_tfrecord_torch.columnar import Column, ColumnarBatch
from tpu_tfrecord_torch.options import RecordType
from tpu_tfrecord_torch.schema import (
    ArrayType,
    BinaryType,
    DataType,
    DecimalType,
    DoubleType,
    FloatType,
    IntegerType,
    LongType,
    StringType,
    StructType,
)
from tpu_tfrecord_torch.serde import NullValueError

_PKG = Path(__file__).resolve().parent
SRC = _PKG / "csrc" / "tfrecord_native.cc"
BUILD_DIR = _PKG / "_build"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def lib_path() -> Path:
    """Where the library for the current source is (or will be) built."""
    digest = hashlib.sha256(SRC.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libtfrecord_native-{digest}.so"


def compile_command(out: Path) -> List[str]:
    cmd = ["g++", "-std=c++20", "-O3", "-fPIC", "-shared", "-o", str(out), str(SRC)]
    if platform.machine() == "x86_64":
        # BMI2 (PEXT varint decode) is not forced: the source compiles it
        # per function and dispatches on __builtin_cpu_supports at run time
        cmd.insert(1, "-msse4.2")
    return cmd


def _build(path: Path) -> None:
    BUILD_DIR.mkdir(exist_ok=True)
    with open(BUILD_DIR / "tfrecord_native.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if path.exists():  # another process built it while this one waited
            return
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        try:
            proc = subprocess.run(compile_command(tmp), capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"g++ failed to build {SRC.name} (rc={proc.returncode}):\n{proc.stderr}"
                )
            os.replace(tmp, path)
        finally:
            tmp.unlink(missing_ok=True)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)

    lib.tfr_crc32c.restype = ctypes.c_uint32
    lib.tfr_crc32c.argtypes = [ctypes.c_char_p, ctypes.c_uint64]

    lib.tfr_scan.restype = ctypes.c_int64
    lib.tfr_scan.argtypes = [ctypes.c_char_p, ctypes.c_uint64, ctypes.c_int32, u64p, u64p, ctypes.c_int64]

    lib.tfr_scan_partial.restype = ctypes.c_int64
    lib.tfr_scan_partial.argtypes = [
        ctypes.c_char_p, ctypes.c_uint64, ctypes.c_int32, u64p, u64p,
        ctypes.c_int64, u64p,
    ]

    lib.tfr_decode_batch.restype = ctypes.c_void_p
    lib.tfr_decode_batch.argtypes = [
        ctypes.c_char_p, u64p, u64p, ctypes.c_int64, ctypes.c_int32,
        ctypes.c_int32, ctypes.POINTER(ctypes.c_char_p),
        i32p, i32p, i32p, u8p, i64p,
        i32p, i64p, ctypes.c_int32, i64p,
        ctypes.c_char_p, ctypes.c_int64,
    ]
    lib.tfr_scan_decode.restype = ctypes.c_void_p
    lib.tfr_scan_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint64,
        ctypes.c_int32, ctypes.c_int64, ctypes.c_int64, ctypes.c_uint64,
        ctypes.c_int32, ctypes.c_int32, ctypes.POINTER(ctypes.c_char_p),
        i32p, i32p, i32p, u8p, i64p,
        i32p, i64p, ctypes.c_int32, i64p,
        i64p, i64p, u64p,
        ctypes.c_char_p, ctypes.c_int64,
    ]
    lib.tfr_result_group.restype = ctypes.c_int64
    lib.tfr_result_group.argtypes = [ctypes.c_void_p, ctypes.c_int32, ctypes.POINTER(u8p)]
    lib.tfr_result_values.restype = ctypes.c_int64
    lib.tfr_result_values.argtypes = [ctypes.c_void_p, ctypes.c_int32, ctypes.POINTER(ctypes.c_void_p)]
    for name in ("tfr_result_row_offsets", "tfr_result_inner_offsets", "tfr_result_blob_offsets"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int64
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int32, ctypes.POINTER(i64p)]
    lib.tfr_result_blob.restype = ctypes.c_int64
    lib.tfr_result_blob.argtypes = [ctypes.c_void_p, ctypes.c_int32, ctypes.POINTER(u8p)]
    lib.tfr_result_mask.restype = ctypes.c_int64
    lib.tfr_result_mask.argtypes = [ctypes.c_void_p, ctypes.c_int32, ctypes.POINTER(u8p)]
    lib.tfr_result_trim.restype = None
    lib.tfr_result_trim.argtypes = [ctypes.c_void_p]
    lib.tfr_result_free.restype = None
    lib.tfr_result_free.argtypes = [ctypes.c_void_p]

    lib.tfr_hash_blob.restype = None
    lib.tfr_hash_blob.argtypes = [
        ctypes.c_char_p, i64p, ctypes.c_int64, ctypes.c_int64, i64p
    ]
    lib.tfr_pack_mixed.restype = ctypes.c_int64
    lib.tfr_pack_mixed.argtypes = [
        i32p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, i32p,
    ]
    lib.tfr_pad_ragged.restype = ctypes.c_int64
    lib.tfr_pad_ragged.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, i64p, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int32, ctypes.c_void_p, i32p,
    ]
    lib.tfr_pad_ragged2.restype = ctypes.c_int64
    lib.tfr_pad_ragged2.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, i64p, i64p, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int32, ctypes.c_void_p,
        i32p, i32p,
    ]
    return lib


def load() -> ctypes.CDLL:
    """The loaded library, built first if needed. Raises if it cannot be
    built or loaded."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            path = lib_path()
            if not path.exists():
                _build(path)
            _lib = _bind(ctypes.CDLL(str(path)))
        return _lib


# ---------------------------------------------------------------------------
# CRC32C and frame scanning
# ---------------------------------------------------------------------------


def crc32c(data: bytes) -> int:
    return load().tfr_crc32c(bytes(data), len(data))


_SCAN_ERRORS = {
    -1: "corrupt TFRecord: bad length CRC",
    -2: "truncated TFRecord",
    -3: "corrupt TFRecord: bad data CRC",
    -4: "scan capacity exceeded",
}


def scan(buf: bytes, verify_crc: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """Frame an in-memory buffer of whole records -> (offsets, lengths)."""
    from tpu_tfrecord_torch.wire import TFRecordCorruptionError

    cap = max(1, len(buf) // 16)
    offsets = np.empty(cap, dtype=np.uint64)
    lengths = np.empty(cap, dtype=np.uint64)
    n = load().tfr_scan(
        buf,
        len(buf),
        1 if verify_crc else 0,
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        cap,
    )
    if n < 0:
        raise TFRecordCorruptionError(_SCAN_ERRORS.get(int(n), f"scan error {n}"))
    # copy out of the len(buf)/16-entry backing arrays so a held result
    # does not pin buffer-sized allocations
    return offsets[:n].copy(), lengths[:n].copy()


def scan_partial(buf: bytes, verify_crc: bool = True) -> Tuple[np.ndarray, np.ndarray, int]:
    """Frame the complete records at the front of ``buf``; a record that runs
    past its end is a tail, not an error. Returns (offsets, lengths,
    consumed_bytes)."""
    from tpu_tfrecord_torch.wire import TFRecordCorruptionError

    cap = max(1, len(buf) // 16)
    offsets = np.empty(cap, dtype=np.uint64)
    lengths = np.empty(cap, dtype=np.uint64)
    consumed = ctypes.c_uint64(0)
    n = load().tfr_scan_partial(
        buf,
        len(buf),
        1 if verify_crc else 0,
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        cap,
        ctypes.byref(consumed),
    )
    if n < 0:
        raise TFRecordCorruptionError(_SCAN_ERRORS.get(int(n), f"scan error {n}"))
    return offsets[:n].copy(), lengths[:n].copy(), int(consumed.value)


# ---------------------------------------------------------------------------
# Schema -> native field specs, and the hash/pack validation
# ---------------------------------------------------------------------------

# layout/kind/dtype codes must match tfrecord_native.cc
_LAYOUT_SCALAR, _LAYOUT_RAGGED, _LAYOUT_RAGGED2 = 0, 1, 2
_DT_I64, _DT_I32, _DT_F32, _DT_F64, _DT_BYTES = 0, 1, 2, 3, -1
_DT_NP = {_DT_I64: np.int64, _DT_I32: np.int32, _DT_F32: np.float32, _DT_F64: np.float64}


class UnsupportedSchemaError(ValueError):
    """Schema not representable natively: the dataset decodes it with the
    Python ``ColumnarDecoder``. Distinct from configuration errors (bad
    pack/hash_buckets), which always raise to the user."""


def _field_spec(name: str, dtype: DataType) -> Tuple[int, int, int]:
    """(layout, kind, out_dtype) of a schema field; raises
    UnsupportedSchemaError if the native decoder cannot represent it."""
    elem: DataType = dtype
    layout = _LAYOUT_SCALAR
    if isinstance(dtype, ArrayType):
        if isinstance(dtype.element_type, ArrayType):
            layout = _LAYOUT_RAGGED2
            elem = dtype.element_type.element_type
            if isinstance(elem, ArrayType):
                raise UnsupportedSchemaError(">2-level nesting")
        else:
            layout = _LAYOUT_RAGGED
            elem = dtype.element_type
    if isinstance(elem, IntegerType):
        return layout, proto.INT64_LIST, _DT_I32
    if isinstance(elem, LongType):
        return layout, proto.INT64_LIST, _DT_I64
    if isinstance(elem, FloatType):
        return layout, proto.FLOAT_LIST, _DT_F32
    if isinstance(elem, (DoubleType, DecimalType)):
        return layout, proto.FLOAT_LIST, _DT_F64
    if isinstance(elem, (StringType, BinaryType)):
        return layout, proto.BYTES_LIST, _DT_BYTES
    raise UnsupportedSchemaError(f"unsupported native type {elem}")


def validate_hash_buckets(schema: StructType, hash_buckets) -> Dict[str, int]:
    """Every hashed column must be a (multi-hot) string/binary data column
    with a positive bucket count. Shared by ``NativeDecoder`` and the
    dataset, so a typo fails whichever decoder runs."""
    out: Dict[str, int] = {}
    for name, buckets in (hash_buckets or {}).items():
        if name not in schema:
            raise ValueError(
                f"hash_buckets[{name!r}]: no such data column (have {schema.names})"
            )
        dt = schema[name].data_type
        # scalar bytes column (single-hot) or array-of-bytes (multi-hot)
        if isinstance(dt, ArrayType):
            dt = dt.element_type
        if not isinstance(dt, (StringType, BinaryType)):
            raise ValueError(f"hash_buckets[{name!r}]: not a string/binary column")
        b = int(buckets)
        if b <= 0:
            raise ValueError(f"hash_buckets[{name!r}] must be positive, got {b}")
        out[name] = b
    return out


def validate_pack(schema: StructType, pack, hash_buckets) -> Dict[str, List[str]]:
    """Group names must not collide with columns; members must exist, be
    scalar, be numeric (or hashed bytes), be listed exactly once anywhere
    and share one output dtype; groups must be non-empty."""
    hash_buckets = hash_buckets or {}
    seen_members: Dict[str, str] = {}
    out: Dict[str, List[str]] = {}
    for gname, members in (pack or {}).items():
        if gname in schema:
            raise ValueError(f"pack group {gname!r} collides with a column name")
        if not members:
            raise ValueError(f"pack[{gname}]: group has no members")
        dtypes = set()
        for m in members:
            if m in seen_members:
                raise ValueError(
                    f"pack[{gname}]: column {m!r} already in group "
                    f"{seen_members[m]!r} — a column may be packed once"
                )
            seen_members[m] = gname
            if m not in schema:
                raise ValueError(
                    f"pack[{gname}]: no such data column {m!r} (have {schema.names})"
                )
            mdt = schema[m].data_type
            if isinstance(mdt, ArrayType):
                raise ValueError(f"pack[{gname}]: {m} is not a scalar column")
            if isinstance(mdt, (StringType, BinaryType)):
                if m not in hash_buckets:
                    raise ValueError(
                        f"pack[{gname}]: {m} is a bytes column (add it to "
                        "hash_buckets to pack it)"
                    )
                dtypes.add(_DT_I32)
            else:
                dtypes.add(_field_spec(m, mdt)[2])
        if len(dtypes) != 1:
            raise ValueError(f"pack[{gname}]: members must share one dtype")
        out[gname] = list(members)
    return out


# ---------------------------------------------------------------------------
# Batch decoder
# ---------------------------------------------------------------------------


class NativeDecoder:
    """Batch decoder backed by the C++ library. Its batches equal
    ``columnar.ColumnarDecoder``'s, except that a hashed bytes column carries
    int32 bucket ids in ``values`` (``hash_buckets`` set, no blob) and each
    pack group is one ``[n, K]`` matrix column in place of its members."""

    def __init__(
        self,
        schema: StructType,
        record_type: RecordType = RecordType.EXAMPLE,
        hash_buckets: Optional[Dict[str, int]] = None,
        pack: Optional[Dict[str, List[str]]] = None,
    ):
        self._lib = load()
        self.schema = schema
        self.record_type = RecordType.parse(record_type)
        if self.record_type == RecordType.BYTE_ARRAY:
            raise UnsupportedSchemaError("ByteArray decoding has no native path")
        n = len(schema)
        self._names = [f.name.encode("utf-8") for f in schema]
        self._c_names = (ctypes.c_char_p * n)(*self._names)
        specs = [_field_spec(f.name, f.data_type) for f in schema]
        self._layouts = np.array([s[0] for s in specs], dtype=np.int32)
        self._kinds = np.array([s[1] for s in specs], dtype=np.int32)
        self._dtypes = np.array([s[2] for s in specs], dtype=np.int32)
        # fused categorical hashing: a hashed bytes column decodes straight
        # to int32 bucket ids (no blob at all)
        self.hash_buckets = validate_hash_buckets(schema, hash_buckets)
        self._hash = np.zeros(n, dtype=np.int64)
        for i, f in enumerate(schema):
            if f.name in self.hash_buckets:
                self._hash[i] = self.hash_buckets[f.name]
                self._dtypes[i] = _DT_I32
        self._nullables = np.array([1 if f.nullable else 0 for f in schema], dtype=np.uint8)
        self._fmt = 0 if self.record_type == RecordType.EXAMPLE else 1
        # column-group packing: same-dtype scalar fields decode straight into
        # one [n_records, width] matrix per group
        self.pack = validate_pack(schema, pack, self.hash_buckets)
        self._group_ids = np.full(n, -1, dtype=np.int32)
        self._group_offs = np.zeros(n, dtype=np.int64)
        self._group_strides = np.zeros(len(self.pack), dtype=np.int64)
        self._group_meta: List[Tuple[str, np.dtype, int]] = []  # (name, dtype, width)
        for g, (gname, members) in enumerate(self.pack.items()):
            np_dt = np.dtype(_DT_NP[int(self._dtypes[schema.field_index(members[0])])])
            self._group_strides[g] = np_dt.itemsize * len(members)
            for pos, m in enumerate(members):
                i = schema.field_index(m)
                self._group_ids[i] = g
                self._group_offs[i] = np_dt.itemsize * pos
            self._group_meta.append((gname, np_dt, len(members)))
        i32p, i64p = ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64)
        # the schema arguments every decode call passes, after the buffer ones
        self._schema_args = (
            self._fmt,
            n,
            self._c_names,
            self._layouts.ctypes.data_as(i32p),
            self._kinds.ctypes.data_as(i32p),
            self._dtypes.ctypes.data_as(i32p),
            self._nullables.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            self._hash.ctypes.data_as(i64p),
            self._group_ids.ctypes.data_as(i32p),
            self._group_offs.ctypes.data_as(i64p),
            len(self._group_meta),
            self._group_strides.ctypes.data_as(i64p),
        )

    def decode_spans(
        self, buf: bytes, offsets: np.ndarray, lengths: np.ndarray
    ) -> ColumnarBatch:
        """Decode the records at ``buf[offsets[i]:offsets[i] + lengths[i]]``."""
        n_records = len(offsets)
        errbuf = ctypes.create_string_buffer(512)
        offsets = np.ascontiguousarray(offsets, dtype=np.uint64)
        lengths = np.ascontiguousarray(lengths, dtype=np.uint64)
        handle = self._lib.tfr_decode_batch(
            buf,
            offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            n_records,
            *self._schema_args,
            errbuf,
            len(errbuf),
        )
        if not handle:
            msg = errbuf.value.decode("utf-8", "replace")
            if "does not allow null values" in msg:
                raise NullValueError(msg)
            raise ValueError(f"native decode failed: {msg}")
        return self._extract_owned(handle, n_records)

    def scan_decode(
        self,
        buf,
        start: int,
        verify_crc: bool,
        skip_records: int,
        max_records: int,
        length: Optional[int] = None,
        max_record_bytes: int = 0,
    ) -> Tuple[Optional[ColumnarBatch], int, int, int]:
        """Fused frame scan + decode in one pass over ``buf`` from ``start``:
        CRC-check and skip ``skip_records`` frames, then decode up to
        ``max_records`` records, each parsed right after its CRC while its
        bytes are in cache. ``buf`` is bytes or a uint8 numpy array (an
        mmap view); ``length`` bounds the valid bytes. Returns
        (batch_or_None, n_skipped, n_decoded, consumed_abs); stops without
        error at a partial tail frame."""
        from tpu_tfrecord_torch.wire import TFRecordCorruptionError

        errbuf = ctypes.create_string_buffer(512)
        n_sk = ctypes.c_int64(0)
        n_de = ctypes.c_int64(0)
        consumed = ctypes.c_uint64(start)
        if isinstance(buf, np.ndarray):
            ptr = buf.ctypes.data_as(ctypes.c_char_p)
            blen = buf.nbytes
        else:
            ptr = buf
            blen = len(buf)
        if length is not None:
            blen = length
        handle = self._lib.tfr_scan_decode(
            ptr,
            blen,
            start,
            1 if verify_crc else 0,
            skip_records,
            max_records,
            max_record_bytes,
            *self._schema_args,
            ctypes.byref(n_sk),
            ctypes.byref(n_de),
            ctypes.byref(consumed),
            errbuf,
            len(errbuf),
        )
        if not handle:
            msg = errbuf.value.decode("utf-8", "replace")
            if msg.startswith("corrupt TFRecord"):
                raise TFRecordCorruptionError(msg)
            if "does not allow null values" in msg:
                raise NullValueError(msg)
            raise ValueError(f"native decode failed: {msg}")
        n_decoded = int(n_de.value)
        if n_decoded:
            cb = self._extract_owned(handle, n_decoded)
        else:
            cb = None
            self._lib.tfr_result_free(handle)
        return cb, int(n_sk.value), n_decoded, int(consumed.value)

    def decode_batch(self, records) -> ColumnarBatch:
        """List-of-bytes interface (as ``ColumnarDecoder.decode_batch``): the
        records are joined into one buffer and decoded in one call."""
        lengths = np.array([len(r) for r in records], dtype=np.uint64)
        offsets = np.zeros(len(records), dtype=np.uint64)
        np.cumsum(lengths[:-1], out=offsets[1:])
        return self.decode_spans(b"".join(records), offsets, lengths)

    def _extract_owned(self, handle, n_records: int) -> ColumnarBatch:
        """Extract a batch, taking ownership of ``handle``: it is freed on
        return unless zero-copy group views took it over (then the last
        view's garbage collection frees it, even if extraction failed
        midway)."""
        owner_box: List[Optional[_NativeResult]] = [None]
        try:
            return self._extract(handle, n_records, owner_box)
        finally:
            if owner_box[0] is None:
                self._lib.tfr_result_free(handle)

    def _extract(self, handle, n_records: int, owner_box) -> ColumnarBatch:
        lib = self._lib
        cols: Dict[str, Column] = {}
        # Non-group columns are copied out first; then the handle is trimmed
        # (per-column vectors dropped, group slack released) before group
        # pointers are taken: trim may reallocate group buffers, and a
        # pinned handle must hold no more than the group matrices.
        self._extract_fields(handle, cols)
        if self._group_meta:
            lib.tfr_result_trim(handle)
        for g, (gname, np_dt, width) in enumerate(self._group_meta):
            gptr = ctypes.POINTER(ctypes.c_uint8)()
            gbytes = lib.tfr_result_group(handle, g, ctypes.byref(gptr))
            if gbytes:
                # zero-copy: a view straight into the C++ group matrix; the
                # owner sits on the array's base chain, so the result
                # handle lives until the last view (or a tensor made from
                # it with torch.from_numpy) dies
                if owner_box[0] is None:
                    owner_box[0] = _NativeResult(lib, handle)
                values = _np_view(gptr, gbytes, np_dt, owner_box[0]).reshape(
                    n_records, width
                )
            else:
                values = np.empty((n_records, width), dtype=np_dt)
            # a group takes its first member's schema type; per-member
            # validity is dropped (missing -> 0)
            first = self.pack[gname][0]
            cols[gname] = Column(gname, self.schema[first].data_type, values=values)
        return ColumnarBatch(cols, n_records)

    def _extract_fields(self, handle, cols: Dict[str, Column]) -> None:
        lib = self._lib
        for i, field in enumerate(self.schema):
            if int(self._group_ids[i]) >= 0:
                continue  # lives in a group matrix
            layout = int(self._layouts[i])
            dt = int(self._dtypes[i])
            col = Column(
                field.name,
                field.data_type,
                hash_buckets=int(self._hash[i]) if self._hash[i] else None,
            )

            mptr = ctypes.POINTER(ctypes.c_uint8)()
            mlen = lib.tfr_result_mask(handle, i, ctypes.byref(mptr))
            col.mask = _np_copy(mptr, mlen, np.uint8).astype(bool)

            if layout != _LAYOUT_SCALAR:
                optr = ctypes.POINTER(ctypes.c_int64)()
                olen = lib.tfr_result_row_offsets(handle, i, ctypes.byref(optr))
                col.offsets = _np_copy(optr, olen * 8, np.int64)
            if layout == _LAYOUT_RAGGED2:
                iptr = ctypes.POINTER(ctypes.c_int64)()
                ilen = lib.tfr_result_inner_offsets(handle, i, ctypes.byref(iptr))
                col.inner_offsets = _np_copy(iptr, ilen * 8, np.int64)

            if dt == _DT_BYTES:
                bptr = ctypes.POINTER(ctypes.c_uint8)()
                blen = lib.tfr_result_blob(handle, i, ctypes.byref(bptr))
                col.blob = _np_copy(bptr, blen, np.uint8).tobytes()
                boptr = ctypes.POINTER(ctypes.c_int64)()
                bolen = lib.tfr_result_blob_offsets(handle, i, ctypes.byref(boptr))
                col.blob_offsets = _np_copy(boptr, bolen * 8, np.int64)
            else:
                vptr = ctypes.c_void_p()
                vbytes = lib.tfr_result_values(handle, i, ctypes.byref(vptr))
                col.values = _np_copy(
                    ctypes.cast(vptr, ctypes.POINTER(ctypes.c_uint8)), vbytes, _DT_NP[dt]
                )
            cols[field.name] = col


class _NativeResult:
    """Owns a decode result handle, freed when the last zero-copy view dies.
    It sits at the bottom of the numpy base chain of every group-matrix
    view, so garbage collection, not the decode call, decides when the C++
    buffers go."""

    __slots__ = ("_lib", "_handle")

    def __init__(self, lib, handle):
        self._lib = lib
        self._handle = handle

    def __del__(self):
        if self._handle:
            self._lib.tfr_result_free(self._handle)
            self._handle = None


def _np_view(ptr, nbytes: int, dtype, owner: _NativeResult) -> np.ndarray:
    """Zero-copy numpy view over a C++-owned buffer whose lifetime is tied to
    ``owner`` through the array's base chain."""
    raw = ctypes.cast(ptr, ctypes.POINTER(ctypes.c_uint8 * nbytes)).contents
    raw._owner = owner  # ctypes instances carry attributes; keeps the owner alive
    return np.frombuffer(raw, dtype=dtype)


def _np_copy(ptr, nbytes: int, dtype) -> np.ndarray:
    if nbytes == 0 or not ptr:
        return np.empty(0, dtype=dtype)
    raw = ctypes.cast(ptr, ctypes.POINTER(ctypes.c_uint8 * nbytes)).contents
    return np.frombuffer(raw, dtype=dtype).copy()  # one copy out of the C++ buffer


def make_decoder(
    schema: StructType,
    record_type,
    hash_buckets: Optional[Dict[str, int]] = None,
    pack: Optional[Dict[str, List[str]]] = None,
) -> Optional[NativeDecoder]:
    """A NativeDecoder, or None for a record type or schema the C++ side
    cannot represent (the caller then decodes with ``ColumnarDecoder``).
    Configuration errors (bad pack/hash_buckets) and a library that fails to
    build or load raise."""
    try:
        return NativeDecoder(schema, record_type, hash_buckets, pack)
    except UnsupportedSchemaError:
        return None


# ---------------------------------------------------------------------------
# Hashing and ragged pads
# ---------------------------------------------------------------------------


def hash_blob(blob: bytes, blob_offsets: np.ndarray, num_buckets: int) -> np.ndarray:
    """CRC32C of each value of a flat blob, mod ``num_buckets``, in one call."""
    n = len(blob_offsets) - 1
    out = np.empty(n, dtype=np.int64)
    bo = np.ascontiguousarray(blob_offsets, dtype=np.int64)
    load().tfr_hash_blob(
        blob,
        bo.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        n,
        num_buckets,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    return out


def pack_mixed(arr: np.ndarray, keep: int, bits: int) -> np.ndarray:
    """One pass over an int32 [B, C] matrix: the first ``keep`` lanes of
    each row copied, the rest bit-packed to ``bits`` (the layout of
    ``device/bitpack.py``). Raises ValueError on a negative packed value
    (the sign check rides the packing pass)."""
    n_rows, n_cols = arr.shape
    w = ((n_cols - keep) * bits + 31) // 32
    src = np.ascontiguousarray(arr, dtype=np.int32)
    out = np.empty((n_rows, keep + w), dtype=np.int32)
    i32p = ctypes.POINTER(ctypes.c_int32)
    bad = load().tfr_pack_mixed(
        src.ctypes.data_as(i32p), n_rows, n_cols, keep, bits, out.ctypes.data_as(i32p)
    )
    if bad >= 0:
        r, j = divmod(int(bad), n_cols)
        raise ValueError(
            "pack_mixed requires non-negative values in packed columns "
            f"(found {int(src[r, j])} at row {r}, column {j})"
        )
    return out


# fused pad+cast kind codes (tfr_pad_ragged/_ragged2's contract); a bf16
# output needs a numpy dtype named "bfloat16" (ml_dtypes)
_PAD_IN_KINDS = {np.dtype(np.float32): 0, np.dtype(np.int64): 1}


def _pad_out_kind(in_kind: int, out_dtype) -> Optional[int]:
    dt = np.dtype(out_dtype)
    if in_kind == 0:
        if dt == np.float32:
            return 0
        if dt.name == "bfloat16":
            return 1
    else:
        if dt == np.int64:
            return 2
        if dt == np.int32:
            return 3
    return None


def pad_ragged_dense(values, offsets, max_len, out_dtype=None, pad_value=0):
    """Fused pad(+cast): ragged [total] + offsets -> dense [N, max_len] and
    clipped lengths [N] int32. None for a dtype pair or pad value the
    library does not take (the caller uses ``columnar.pad_ragged``)."""
    if pad_value != 0:
        return None
    values = np.ascontiguousarray(values)
    in_kind = _PAD_IN_KINDS.get(values.dtype)
    if in_kind is None:
        return None
    out_dtype = values.dtype if out_dtype is None else np.dtype(out_dtype)
    out_kind = _pad_out_kind(in_kind, out_dtype)
    if out_kind is None:
        return None
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    n = len(offsets) - 1
    if n and offsets[-1] > len(values):
        # the C side is offset-driven with no values length: keep numpy's
        # failure mode instead of reading out of bounds
        raise IndexError(
            f"pad_ragged offsets end at {int(offsets[-1])} but values has "
            f"{len(values)} elements"
        )
    dense = np.empty((n, max_len), dtype=out_dtype)
    lengths = np.empty(n, dtype=np.int32)
    rc = load().tfr_pad_ragged(
        values.ctypes.data_as(ctypes.c_void_p), in_kind,
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), n, max_len, out_kind,
        dense.ctypes.data_as(ctypes.c_void_p),
        lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    if rc != 0:
        raise ValueError(f"tfr_pad_ragged refused kinds ({in_kind}, {out_kind}): rc={rc}")
    return dense, lengths


def pad_ragged2_dense(
    values, inner_offsets, row_splits, max_outer, max_inner,
    out_dtype=None, pad_value=0,
):
    """Fused pad(+cast): ragged² buffers -> dense [N, Lo, Li], outer lengths
    [N] and inner lengths [N, Lo] (both int32). None for a dtype pair or pad
    value the library does not take (the caller uses
    ``columnar.pad_ragged2``)."""
    if pad_value != 0:
        return None
    values = np.ascontiguousarray(values)
    in_kind = _PAD_IN_KINDS.get(values.dtype)
    if in_kind is None:
        return None
    out_dtype = values.dtype if out_dtype is None else np.dtype(out_dtype)
    out_kind = _pad_out_kind(in_kind, out_dtype)
    if out_kind is None:
        return None
    inner_offsets = np.ascontiguousarray(inner_offsets, dtype=np.int64)
    row_splits = np.ascontiguousarray(row_splits, dtype=np.int64)
    n = len(row_splits) - 1
    # offset-driven, no length parameters: keep numpy's IndexError on
    # inconsistent buffers instead of reading out of bounds
    if n and row_splits[-1] > len(inner_offsets) - 1:
        raise IndexError(
            f"pad_ragged2 row_splits end at {int(row_splits[-1])} but "
            f"inner_offsets describes {len(inner_offsets) - 1} lists"
        )
    if len(inner_offsets) > 1 and inner_offsets[-1] > len(values):
        raise IndexError(
            f"pad_ragged2 inner_offsets end at {int(inner_offsets[-1])} but "
            f"values has {len(values)} elements"
        )
    dense = np.empty((n, max_outer, max_inner), dtype=out_dtype)
    outer_len = np.empty(n, dtype=np.int32)
    inner_len = np.empty((n, max_outer), dtype=np.int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    rc = load().tfr_pad_ragged2(
        values.ctypes.data_as(ctypes.c_void_p), in_kind,
        inner_offsets.ctypes.data_as(i64p),
        row_splits.ctypes.data_as(i64p), n, max_outer, max_inner, out_kind,
        dense.ctypes.data_as(ctypes.c_void_p),
        outer_len.ctypes.data_as(i32p),
        inner_len.ctypes.data_as(i32p),
    )
    if rc != 0:
        raise ValueError(f"tfr_pad_ragged2 refused kinds ({in_kind}, {out_kind}): rc={rc}")
    return dense, outer_len, inner_len
