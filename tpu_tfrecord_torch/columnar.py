"""Columnar batch decoding: serialized records -> numpy column buffers.

Copy of ``tpu_tfrecord/columnar.py`` (the pure-Python decoder, the rows
of a batch that the writer encodes when a schema has no native encoder,
the row slice and concatenation that cut batches out of decode chunks,
the row gather of the windowed shuffle, the ragged padders and
``bucket_boundaries``). A batch of
serialized tf.Example records decodes STRAIGHT into per-column numpy
buffers — no per-record row objects, no per-field boxing:

- numeric scalar column  -> values[N] + validity mask[N]
- numeric array column   -> ragged: values[total] + offsets[N+1]
- array-of-array column  -> ragged^2: values[total] + inner_offsets[M+1]
                            + row_splits[N+1] (SequenceExample FeatureLists)
- string/binary columns  -> flat blob + offsets (hashing happens host-side)

Ragged columns pad into dense [batch, max_len] arrays in
``tpu_tfrecord_torch.device.ingest``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from tpu_tfrecord_torch import proto
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
    NullType,
    StringType,
    StructType,
    numpy_dtype,
)
from tpu_tfrecord_torch.serde import NullValueError


class Column:
    """One decoded column. Exactly one of the layouts below is populated.

    - scalar numeric: ``values`` [N]
    - ragged numeric: ``values`` [total] + ``offsets`` [N+1]
    - ragged^2 numeric: ``values`` [total] + ``inner_offsets`` + ``offsets``
      (offsets indexes into inner_offsets: row i spans inner lists
      offsets[i]:offsets[i+1], inner list j spans values
      inner_offsets[j]:inner_offsets[j+1])
    - bytes-like: one flat ``blob`` buffer + ``blob_offsets`` [n_values+1]
      value boundaries (with the same offsets scheme above it) — per-value
      Python objects are only materialized on demand via ``blobs``.
    """

    __slots__ = ("name", "dtype", "values", "offsets", "inner_offsets",
                 "blob", "blob_offsets", "mask", "hash_buckets")

    def __init__(
        self,
        name: str,
        dtype: DataType,
        values: Optional[np.ndarray] = None,
        offsets: Optional[np.ndarray] = None,
        inner_offsets: Optional[np.ndarray] = None,
        blob: Optional[bytes] = None,
        blob_offsets: Optional[np.ndarray] = None,
        mask: Optional[np.ndarray] = None,
        hash_buckets: Optional[int] = None,
    ):
        self.name = name
        self.dtype = dtype
        self.values = values
        self.offsets = offsets
        self.inner_offsets = inner_offsets
        self.blob = blob
        self.blob_offsets = blob_offsets
        self.mask = mask  # validity per row
        # set when a bytes column was hash-fused during decode: the bucket
        # count its int32 values were computed with
        self.hash_buckets = hash_buckets

    @property
    def is_ragged(self) -> bool:
        return self.offsets is not None

    @property
    def is_bytes(self) -> bool:
        return self.blob is not None

    def row_lengths(self) -> np.ndarray:
        assert self.offsets is not None
        return np.diff(self.offsets)

    @property
    def blobs(self) -> Optional[List[bytes]]:
        """Materialize per-value bytes objects (view concern — the hot path
        works on the flat ``blob`` + ``blob_offsets`` arrays)."""
        if self.blob is None:
            return None
        bo = self.blob_offsets
        blob = self.blob
        return [bytes(blob[bo[j] : bo[j + 1]]) for j in range(len(bo) - 1)]

    def set_blobs(self, items: Sequence[bytes]) -> None:
        self.blob = b"".join(items)
        self.blob_offsets = np.concatenate(
            ([0], np.cumsum(np.fromiter((len(b) for b in items), dtype=np.int64,
                                        count=len(items))))
        ) if items else np.zeros(1, dtype=np.int64)


@dataclass
class ColumnarBatch:
    columns: Dict[str, Column]
    num_rows: int

    def __getitem__(self, name: str) -> Column:
        return self.columns[name]

    def __contains__(self, name: str) -> bool:
        return name in self.columns


def _is_bytes_like(dt: DataType) -> bool:
    return isinstance(dt, (StringType, BinaryType))


class _FieldAcc:
    """Per-field accumulator filled record by record."""

    __slots__ = (
        "name", "dtype", "np_dtype", "kind", "layout", "nullable",
        "values", "lengths", "inner_lengths", "blobs", "mask", "decode_str",
    )

    # layout: 'scalar' | 'ragged' | 'ragged2'
    def __init__(self, name: str, dtype: DataType, nullable: bool):
        self.name = name
        self.dtype = dtype
        self.nullable = nullable
        self.decode_str = False
        elem: DataType = dtype
        if isinstance(dtype, ArrayType):
            if isinstance(dtype.element_type, ArrayType):
                self.layout = "ragged2"
                elem = dtype.element_type.element_type
            else:
                self.layout = "ragged"
                elem = dtype.element_type
        else:
            self.layout = "scalar"
        if isinstance(elem, ArrayType):
            raise ValueError(f"column {name}: >2-level nesting unsupported")
        if isinstance(elem, NullType):
            self.kind = None
        elif isinstance(elem, (IntegerType, LongType)):
            self.kind = proto.INT64_LIST
        elif isinstance(elem, (FloatType, DoubleType, DecimalType)):
            self.kind = proto.FLOAT_LIST
        elif _is_bytes_like(elem):
            self.kind = proto.BYTES_LIST
            self.decode_str = False  # keep raw bytes; str decode is a view concern
        else:
            raise ValueError(f"column {name}: unsupported element type {elem}")
        self.np_dtype = numpy_dtype(dtype) if self.kind != proto.BYTES_LIST else None
        self.values: List = []
        self.lengths: List[int] = []
        self.inner_lengths: List[int] = []
        self.blobs: List[bytes] = []
        self.mask: List[bool] = []

    # -- per-record appends --------------------------------------------------

    def append_missing(self) -> None:
        if not self.nullable:
            raise NullValueError(f"Field {self.name} does not allow null values")
        self.mask.append(False)
        if self.layout == "scalar":
            if self.kind == proto.BYTES_LIST:
                self.blobs.append(b"")
            else:
                self.values.append(0)
        else:
            self.lengths.append(0)

    def append_feature(self, feature: proto.Feature) -> None:
        if feature.kind != self.kind:
            if feature.kind is None:
                self.append_missing()
                return
            raise ValueError(
                f"column {self.name}: feature kind {feature.kind_name} does not "
                f"match schema type {self.dtype}"
            )
        vals = feature.values
        self.mask.append(True)
        if self.layout == "scalar":
            if self.kind == proto.BYTES_LIST:
                self.blobs.append(vals[0] if len(vals) else b"")
            else:
                if not len(vals):
                    raise ValueError(f"column {self.name}: empty feature for scalar")
                self.values.append(vals[0])
        elif self.layout == "ragged":
            self.lengths.append(len(vals))
            if self.kind == proto.BYTES_LIST:
                self.blobs.extend(vals)
            else:
                self.values.extend(vals)
        else:
            raise ValueError(
                f"column {self.name}: got a flat feature for array-of-array type"
            )

    def append_feature_list(self, flist: proto.FeatureList) -> None:
        if self.layout != "ragged2":
            # A FeatureList can also serve ArrayType(scalar): one scalar per
            # inner feature (TFRecordDeserializer.scala:129-143).
            if self.layout == "ragged":
                self.mask.append(True)
                self.lengths.append(len(flist.feature))
                for f in flist.feature:
                    if f.kind != self.kind:
                        raise ValueError(
                            f"column {self.name}: featurelist kind mismatch"
                        )
                    if self.kind == proto.BYTES_LIST:
                        self.blobs.append(f.values[0] if len(f.values) else b"")
                    else:
                        if not len(f.values):
                            raise ValueError(
                                f"column {self.name}: empty inner feature"
                            )
                        self.values.append(f.values[0])
                return
            raise ValueError(f"column {self.name}: FeatureList for scalar type")
        self.mask.append(True)
        self.lengths.append(len(flist.feature))
        for f in flist.feature:
            if f.kind != self.kind:
                raise ValueError(f"column {self.name}: featurelist kind mismatch")
            self.inner_lengths.append(len(f.values))
            if self.kind == proto.BYTES_LIST:
                self.blobs.extend(f.values)
            else:
                self.values.extend(f.values)

    # -- finalize -------------------------------------------------------------

    def _values_array(self) -> np.ndarray:
        if self.kind == proto.INT64_LIST:
            arr = np.asarray(self.values, dtype=np.int64)
            if self.np_dtype != np.int64:
                # IntegerType: two's-complement truncation (Scala Long.toInt)
                arr = arr.astype(self.np_dtype)
            return arr
        return np.asarray(self.values, dtype=self.np_dtype)

    def build(self, num_rows: int) -> Column:
        mask = np.asarray(self.mask, dtype=bool)
        col = Column(self.name, self.dtype, mask=mask)
        if self.layout == "scalar":
            if self.kind == proto.BYTES_LIST:
                col.set_blobs(self.blobs)
            else:
                col.values = self._values_array()
        elif self.layout == "ragged":
            col.offsets = np.concatenate(
                ([0], np.cumsum(np.asarray(self.lengths, dtype=np.int64)))
            )
            if self.kind == proto.BYTES_LIST:
                col.set_blobs(self.blobs)
            else:
                col.values = self._values_array()
        else:
            col.offsets = np.concatenate(
                ([0], np.cumsum(np.asarray(self.lengths, dtype=np.int64)))
            )
            col.inner_offsets = np.concatenate(
                ([0], np.cumsum(np.asarray(self.inner_lengths, dtype=np.int64)))
            )
            if self.kind == proto.BYTES_LIST:
                col.set_blobs(self.blobs)
            else:
                col.values = self._values_array()
        return col


class ColumnarDecoder:
    """Decode batches of serialized records into a ColumnarBatch.

    The schema plays the role of requiredSchema: features not in the schema
    are skipped cheaply; schema fields missing from a record follow the null
    rules (None-able -> masked out, non-nullable -> raise).
    """

    def __init__(self, schema: StructType, record_type: RecordType = RecordType.EXAMPLE):
        self.schema = schema
        self.record_type = RecordType.parse(record_type)
        if self.record_type == RecordType.BYTE_ARRAY and list(schema.names) != ["byteArray"]:
            raise ValueError("ByteArray record type requires the single-column schema")
        # validate eagerly (constructor-time errors like the serializer)
        for f in schema:
            _FieldAcc(f.name, f.data_type, f.nullable)

    def decode_batch(self, records: Sequence[bytes]) -> ColumnarBatch:
        accs = {
            f.name: _FieldAcc(f.name, f.data_type, f.nullable) for f in self.schema
        }
        n = 0
        if self.record_type == RecordType.BYTE_ARRAY:
            acc = accs["byteArray"]
            for rec in records:
                acc.mask.append(True)
                acc.blobs.append(bytes(rec))
                n += 1
        elif self.record_type == RecordType.EXAMPLE:
            for rec in records:
                ex = proto.parse_example(rec)
                for name, acc in accs.items():
                    feat = ex.features.get(name)
                    if feat is None:
                        acc.append_missing()
                    else:
                        acc.append_feature(feat)
                n += 1
        else:
            for rec in records:
                se = proto.parse_sequence_example(rec)
                for name, acc in accs.items():
                    feat = se.context.get(name)
                    if feat is not None:
                        acc.append_feature(feat)
                        continue
                    flist = se.feature_lists.get(name)
                    if flist is not None:
                        acc.append_feature_list(flist)
                    else:
                        acc.append_missing()
                n += 1
        return ColumnarBatch({name: acc.build(n) for name, acc in accs.items()}, n)


# ---------------------------------------------------------------------------
# Rows of a batch (the writer's row fallback)
# ---------------------------------------------------------------------------


def batch_to_rows(batch: ColumnarBatch, schema: StructType) -> List[list]:
    """Materialize serde-compatible rows from a columnar batch (the slow,
    row-oriented view — tests, partitioned writes, small exports)."""
    import decimal as _decimal

    def scalar_of(dt: DataType, v):
        if isinstance(dt, DecimalType):
            return _decimal.Decimal(str(v))
        if isinstance(dt, (FloatType, DoubleType)):
            return float(v)
        return int(v)

    n = batch.num_rows
    rows: List[list] = [[None] * len(schema) for _ in range(n)]
    for idx, f in enumerate(schema):
        col = batch[f.name]
        dt = f.data_type
        mask = col.mask
        if isinstance(dt, ArrayType) and isinstance(dt.element_type, ArrayType):
            inner_dt = dt.element_type.element_type
            blobs = col.blobs
            for r in range(n):
                if mask is not None and not mask[r]:
                    continue
                outer = []
                for j in range(col.offsets[r], col.offsets[r + 1]):
                    v0, v1 = int(col.inner_offsets[j]), int(col.inner_offsets[j + 1])
                    if blobs is not None:
                        items = blobs[v0:v1]
                        outer.append(
                            [b.decode("utf-8") for b in items]
                            if isinstance(inner_dt, StringType)
                            else list(items)
                        )
                    else:
                        outer.append([scalar_of(inner_dt, v) for v in col.values[v0:v1]])
                rows[r][idx] = outer
        elif isinstance(dt, ArrayType):
            elem = dt.element_type
            blobs = col.blobs if col.blob is not None else None
            for r in range(n):
                if mask is not None and not mask[r]:
                    continue
                v0, v1 = int(col.offsets[r]), int(col.offsets[r + 1])
                if blobs is not None:
                    items = blobs[v0:v1]
                    rows[r][idx] = (
                        [b.decode("utf-8") for b in items]
                        if isinstance(elem, StringType)
                        else list(items)
                    )
                else:
                    rows[r][idx] = [scalar_of(elem, v) for v in col.values[v0:v1]]
        elif isinstance(dt, (StringType, BinaryType)):
            blobs = col.blobs
            for r in range(n):
                if mask is not None and not mask[r]:
                    continue
                rows[r][idx] = (
                    blobs[r].decode("utf-8") if isinstance(dt, StringType) else blobs[r]
                )
        else:
            vals = col.values
            for r in range(n):
                if mask is not None and not mask[r]:
                    continue
                rows[r][idx] = scalar_of(dt, vals[r])
    return rows


# ---------------------------------------------------------------------------
# Row slices, concatenation (batches that cross decode chunks and shards)
# and row gathers (the windowed shuffle)
# ---------------------------------------------------------------------------


def _slice_blob(col: Column, new: Column, v0: int, v1: int) -> None:
    bo = col.blob_offsets
    b0, b1 = int(bo[v0]), int(bo[v1])
    new.blob = col.blob[b0:b1]
    new.blob_offsets = bo[v0 : v1 + 1] - b0


def slice_batch(batch: ColumnarBatch, start: int, stop: int) -> ColumnarBatch:
    """Rows ``start:stop`` of a batch: cuts fixed-size batches out of larger
    decode chunks. Values are views where numpy slices are; offsets are
    rebased copies."""
    start = max(0, start)
    stop = min(batch.num_rows, stop)
    out: Dict[str, Column] = {}
    for name, col in batch.columns.items():
        new = Column(
            name,
            col.dtype,
            mask=col.mask[start:stop] if col.mask is not None else None,
            hash_buckets=col.hash_buckets,
        )
        if col.inner_offsets is not None:  # ragged2
            o0, o1 = int(col.offsets[start]), int(col.offsets[stop])
            inner = col.inner_offsets[o0 : o1 + 1]
            v0, v1 = int(inner[0]), int(inner[-1])
            new.offsets = col.offsets[start : stop + 1] - o0
            new.inner_offsets = inner - v0
            if col.values is not None:
                new.values = col.values[v0:v1]
            if col.blob is not None:
                _slice_blob(col, new, v0, v1)
        elif col.offsets is not None:  # ragged
            v0, v1 = int(col.offsets[start]), int(col.offsets[stop])
            new.offsets = col.offsets[start : stop + 1] - v0
            if col.values is not None:
                new.values = col.values[v0:v1]
            if col.blob is not None:
                _slice_blob(col, new, v0, v1)
        else:  # scalar (1-D values, or a [N, K] group matrix)
            if col.values is not None:
                new.values = col.values[start:stop]
            if col.blob is not None:
                _slice_blob(col, new, start, stop)
        out[name] = new
    return ColumnarBatch(out, stop - start)


def concat_batches(batches: Sequence[ColumnarBatch]) -> ColumnarBatch:
    """Concatenate batches row-wise (all must share the same columns)."""
    if len(batches) == 1:
        return batches[0]
    first = batches[0]
    out: Dict[str, Column] = {}
    for name, col0 in first.columns.items():
        cols = [b.columns[name] for b in batches]
        new = Column(name, col0.dtype, hash_buckets=col0.hash_buckets)
        if col0.mask is not None:
            new.mask = np.concatenate([c.mask for c in cols])
        if col0.inner_offsets is not None:
            new.offsets = _concat_offsets([np.asarray(c.offsets) for c in cols])
            new.inner_offsets = _concat_offsets(
                [np.asarray(c.inner_offsets) for c in cols]
            )
        elif col0.offsets is not None:
            new.offsets = _concat_offsets([np.asarray(c.offsets) for c in cols])
        if col0.values is not None:
            new.values = np.concatenate([c.values for c in cols])
        if col0.blob is not None:
            new.blob = b"".join(c.blob for c in cols)
            new.blob_offsets = _concat_offsets(
                [np.asarray(c.blob_offsets) for c in cols]
            )
        out[name] = new
    return ColumnarBatch(out, sum(b.num_rows for b in batches))


def _span_gather(offsets: np.ndarray, idx: np.ndarray):
    """Gather plan for variable spans: for span ids ``idx`` over
    ``offsets``, (flat element indices, new offsets) that lay spans
    idx[0], idx[1], ... out one after another."""
    offsets = np.asarray(offsets)
    lengths = np.diff(offsets)[idx]
    new_offsets = np.empty(len(idx) + 1, dtype=np.int64)
    new_offsets[0] = 0
    np.cumsum(lengths, out=new_offsets[1:])
    total = int(new_offsets[-1])
    starts = offsets[idx]
    # element j of the output is starts[span(j)] + (j - new_offsets[span(j)])
    flat = (
        np.repeat(starts, lengths)
        + np.arange(total, dtype=np.int64)
        - np.repeat(new_offsets[:-1], lengths)
    )
    return flat, new_offsets


def _gather_blob(col: Column, new: Column, value_idx: np.ndarray) -> None:
    """Rebuild blob/blob_offsets for the values at ``value_idx``, in order."""
    bflat, new_bo = _span_gather(col.blob_offsets, value_idx)
    new.blob = np.frombuffer(col.blob, dtype=np.uint8)[bflat].tobytes()
    new.blob_offsets = new_bo


def take_rows(batch: ColumnarBatch, indices) -> ColumnarBatch:
    """Row gather: a new batch whose row i is row ``indices[i]`` of
    ``batch`` (the windowed row shuffle's primitive). One vectorized pass
    per column over every layout: scalar, ragged, ragged^2, bytes-like,
    hashed, and [N, K] group matrices."""
    raw = np.asarray(indices)
    if raw.dtype == np.bool_:
        # a mask would cast to 0/1 positions without a word
        raise TypeError(
            "take_rows takes integer row positions, not a boolean mask; "
            "use np.nonzero(mask)[0]"
        )
    idx = raw.astype(np.int64, copy=False)
    if idx.ndim != 1:
        raise ValueError(f"take_rows expects 1-D indices, got shape {idx.shape}")
    if idx.size and (idx.min() < 0 or idx.max() >= batch.num_rows):
        raise IndexError(f"take_rows indices out of range for {batch.num_rows} rows")
    out: Dict[str, Column] = {}
    for name, col in batch.columns.items():
        new = Column(
            name,
            col.dtype,
            mask=col.mask[idx] if col.mask is not None else None,
            hash_buckets=col.hash_buckets,
        )
        if col.inner_offsets is not None:  # ragged2: rows -> inner lists -> values
            inner_idx, new_off = _span_gather(col.offsets, idx)
            vflat, new_inner = _span_gather(col.inner_offsets, inner_idx)
            new.offsets = new_off
            new.inner_offsets = new_inner
        elif col.offsets is not None:  # ragged: rows -> values
            vflat, new.offsets = _span_gather(col.offsets, idx)
        else:  # scalar (1-D values, or a [N, K] group matrix)
            vflat = idx
        if col.values is not None:
            new.values = np.asarray(col.values)[vflat]
        if col.blob is not None:
            _gather_blob(col, new, vflat)
        out[name] = new
    return ColumnarBatch(out, len(idx))


def _concat_offsets(offset_arrays: List[np.ndarray]) -> np.ndarray:
    total = sum(len(o) - 1 for o in offset_arrays)
    out = np.empty(total + 1, dtype=np.int64)
    out[0] = 0
    pos = 0
    base = 0
    for o in offset_arrays:
        n = len(o) - 1
        out[pos + 1 : pos + 1 + n] = o[1:] + base
        base += int(o[-1])
        pos += n
    return out


# ---------------------------------------------------------------------------
# Ragged -> dense padding (host-side, numpy)
# ---------------------------------------------------------------------------


def pad_ragged(
    values: np.ndarray,
    offsets: np.ndarray,
    max_len: Optional[int] = None,
    pad_value: Union[int, float] = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """Ragged [total] + offsets [N+1] -> dense [N, max_len] + lengths [N].

    Rows longer than max_len are truncated; shorter rows are padded with
    ``pad_value``. Vectorized (no per-row Python loop).
    """
    lengths = np.diff(offsets)
    n = len(lengths)
    if max_len is None:
        max_len = int(lengths.max()) if n else 0
    clipped = np.minimum(lengths, max_len)
    dense = np.full((n, max_len), pad_value, dtype=values.dtype if values is not None else np.int64)
    if n and max_len:
        # gather indices: for row i, positions offsets[i] .. offsets[i]+clipped[i]
        col_idx = np.arange(max_len)[None, :]
        valid = col_idx < clipped[:, None]
        src = offsets[:-1][:, None] + col_idx
        dense[valid] = values[src[valid]]
    return dense, clipped.astype(np.int32)


def pad_ragged2(
    values: np.ndarray,
    inner_offsets: np.ndarray,
    row_splits: np.ndarray,
    max_outer: Optional[int] = None,
    max_inner: Optional[int] = None,
    pad_value: Union[int, float] = 0,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Two-level ragged -> dense [N, max_outer, max_inner] + outer lengths
    [N] + inner lengths [N, max_outer]."""
    row_splits = np.asarray(row_splits)
    inner_offsets = np.asarray(inner_offsets)
    outer_lengths = np.diff(row_splits)
    n = len(outer_lengths)
    if max_outer is None:
        max_outer = int(outer_lengths.max()) if n else 0
    inner_lengths_flat = np.diff(inner_offsets)
    if max_inner is None:
        max_inner = int(inner_lengths_flat.max()) if len(inner_lengths_flat) else 0
    dense = np.full((n, max_outer, max_inner), pad_value, dtype=values.dtype)
    inner_len_out = np.zeros((n, max_outer), dtype=np.int32)
    clipped_outer = np.minimum(outer_lengths, max_outer).astype(np.int32)
    if n and max_outer and max_inner:
        # Fully vectorized two-level pad (no per-row Python loop — that costs
        # ~75 ms/batch at the long-doc bench shape): select the kept inner
        # lists row-major with their destination (row, slot), then apply the
        # one-level pad gather over just those lists and scatter into the
        # flattened [n * max_outer, max_inner] dense view.
        slot = np.arange(max_outer)
        keep = slot[None, :] < clipped_outer[:, None]          # [n, max_outer]
        flat_lists = (row_splits[:-1, None] + slot[None, :])[keep]
        dest = (np.arange(n)[:, None] * max_outer + slot[None, :])[keep]
        starts = inner_offsets[flat_lists]
        clipped_inner = np.minimum(
            inner_lengths_flat[flat_lists], max_inner
        ).astype(np.int32)
        col_idx = np.arange(max_inner)[None, :]
        valid = col_idx < clipped_inner[:, None]               # [kept, max_inner]
        dense2 = dense.reshape(n * max_outer, max_inner)
        sub = np.full((len(flat_lists), max_inner), pad_value, dtype=values.dtype)
        sub[valid] = values[(starts[:, None] + col_idx)[valid]]
        dense2[dest] = sub
        inner_len_out.reshape(-1)[dest] = clipped_inner
    return dense, clipped_outer, inner_len_out


def bucket_boundaries(lengths: Sequence[int], num_buckets: int = 4) -> List[int]:
    """Quantile-based bucket boundaries for length-bucketing ragged batches:
    the ceilings of the ``num_buckets`` upper quantiles, strictly rising."""
    if not len(lengths):
        return []
    qs = np.quantile(np.asarray(lengths), np.linspace(0, 1, num_buckets + 1)[1:])
    out: List[int] = []
    for q in qs:
        v = int(np.ceil(q))
        if not out or v > out[-1]:
            out.append(v)
    return out
