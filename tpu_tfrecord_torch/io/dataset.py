"""Streaming batched read of a TFRecord dataset into ColumnarBatches.

Single-process cut of ``tpu_tfrecord/io/dataset.py::TFRecordDataset``: the
shards are read in discovery order, records are framed and CRC-checked by
``wire``, and every ``batch_size`` records decode into one ColumnarBatch, so
a batch may straddle shards. ``hash_buckets`` and ``pack`` shape the batch
the way the JAX package's native decoder does: a hashed bytes column carries
int32 bucket ids in ``values`` (``Column.hash_buckets`` set), and each pack
group is one ``[B, K]`` matrix column that replaces its members.

Left out against the JAX dataset: threads, shuffling, checkpointable
positions, stall defense, caching, the data service, autotuning, partition
columns and column selection.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional

import numpy as np

from tpu_tfrecord_torch import wire
from tpu_tfrecord_torch.columnar import Column, ColumnarBatch, ColumnarDecoder
from tpu_tfrecord_torch.infer import infer_from_records, type_map_to_schema
from tpu_tfrecord_torch.io.paths import discover_shards
from tpu_tfrecord_torch.options import RecordType, TFRecordOptions
from tpu_tfrecord_torch.schema import (
    ArrayType,
    BinaryType,
    StringType,
    StructType,
    numpy_dtype,
)


def validate_hash_buckets(schema: StructType, hash_buckets) -> Dict[str, int]:
    """Every hashed column must be a (multi-hot) string/binary data column
    with a positive bucket count."""
    out: Dict[str, int] = {}
    for name, buckets in (hash_buckets or {}).items():
        if name not in schema:
            raise ValueError(
                f"hash_buckets[{name!r}]: no such data column (have {schema.names})"
            )
        dt = schema[name].data_type
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
    scalar, be numeric (or hashed bytes), appear once, and share a dtype."""
    seen: Dict[str, str] = {}
    out: Dict[str, List[str]] = {}
    for gname, members in (pack or {}).items():
        if gname in schema:
            raise ValueError(f"pack group {gname!r} collides with a column name")
        if not members:
            raise ValueError(f"pack[{gname}]: group has no members")
        dtypes = set()
        for m in members:
            if m in seen:
                raise ValueError(
                    f"pack[{gname}]: column {m!r} already in group {seen[m]!r}"
                    " — a column may be packed once"
                )
            seen[m] = gname
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
                dtypes.add(np.dtype(np.int32))
            else:
                dtypes.add(numpy_dtype(mdt))
        if len(dtypes) != 1:
            raise ValueError(f"pack[{gname}]: members must share one dtype")
        out[gname] = list(members)
    return out


class TFRecordDataset:
    """Plan a streaming read: ``TFRecordDataset(paths, batch_size,
    schema=None, recordType="Example", hash_buckets=None, pack=None,
    drop_remainder=True)``. Without a schema, it is inferred from the first
    non-empty shard."""

    def __init__(
        self,
        paths,
        batch_size: int,
        schema: Optional[StructType] = None,
        recordType="Example",
        hash_buckets: Optional[Dict[str, int]] = None,
        pack: Optional[Dict[str, List[str]]] = None,
        drop_remainder: bool = True,
    ):
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        self.options = TFRecordOptions.from_map(recordType=recordType, schema=schema)
        self.batch_size = batch_size
        self.drop_remainder = drop_remainder
        self.shards = discover_shards(paths)
        self.schema: StructType = (
            self.options.schema if self.options.schema is not None else self._infer_schema()
        )
        self._decoder = ColumnarDecoder(self.schema, self.options.record_type)
        self.hash_buckets = validate_hash_buckets(self.schema, hash_buckets)
        self.pack = validate_pack(self.schema, pack, self.hash_buckets)

    def _infer_schema(self) -> StructType:
        """Schema of the first non-empty shard whose records yield one."""
        rt = self.options.record_type
        if rt == RecordType.BYTE_ARRAY:
            from tpu_tfrecord_torch.infer import byte_array_schema

            return byte_array_schema()
        for shard in self.shards:
            if shard.size == 0:
                continue
            type_map = infer_from_records(wire.read_records(shard.path), rt)
            if type_map:
                return type_map_to_schema(type_map)
        raise ValueError(
            "Could not infer schema: no non-empty TFRecord file found"
            if self.shards
            else "Could not infer schema: no input files"
        )

    def _records(self) -> Iterator[bytes]:
        for shard in self.shards:
            yield from wire.read_records(shard.path)

    def _decode(self, records: List[bytes]) -> ColumnarBatch:
        from tpu_tfrecord_torch.device.ingest import hash_bytes_column

        batch = self._decoder.decode_batch(records)
        cols = dict(batch.columns)
        for name, buckets in self.hash_buckets.items():
            col = cols[name]
            cols[name] = Column(
                name,
                col.dtype,
                values=hash_bytes_column(col, buckets),
                offsets=col.offsets,
                mask=col.mask,
                hash_buckets=buckets,
            )
        for gname, members in self.pack.items():
            # like the native decoder: the group keeps the first member's
            # schema type and drops per-member validity (missing -> 0)
            values = np.stack([cols.pop(m).values for m in members], axis=1)
            cols[gname] = Column(gname, self.schema[members[0]].data_type, values=values)
        return ColumnarBatch(cols, batch.num_rows)

    def _batches(self) -> Iterator[ColumnarBatch]:
        pending: List[bytes] = []
        for rec in self._records():
            pending.append(rec)
            if len(pending) == self.batch_size:
                yield self._decode(pending)
                pending = []
        if pending and not self.drop_remainder:
            yield self._decode(pending)

    def batches(self) -> "BatchIterator":
        """One pass over the dataset; iterate it, or use it in a ``with``
        block so an early exit closes the open shard."""
        return BatchIterator(self._batches())


class BatchIterator:
    """Iterator over ColumnarBatches that is also a context manager."""

    def __init__(self, gen: Iterator[ColumnarBatch]):
        self._gen = gen

    def __iter__(self) -> "BatchIterator":
        return self

    def __next__(self) -> ColumnarBatch:
        return next(self._gen)

    def close(self) -> None:
        self._gen.close()

    def __enter__(self) -> "BatchIterator":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
