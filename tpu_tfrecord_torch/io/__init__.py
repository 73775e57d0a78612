"""IO layer: the 'tfrecord' data source (read/write/infer).

Copy of ``tpu_tfrecord/io/__init__.py``, plus the streaming
``TFRecordDataset`` that feeds the port's device path. The DefaultSource
equivalent (reference DefaultSource.scala:23-143 +
SURVEY.md §2.1): registered under the short name ``tfrecord`` in the format
registry (the ServiceLoader analog, §2.10), planning reads (schema inference,
per-shard readers, partition merging) and writes (save modes, partitionBy,
codecs, atomic commit).

High-level API::

    import tpu_tfrecord_torch.io as tfio

    tfio.write(rows, schema, "/data/out", mode="overwrite",
               partition_by=["date"], codec="gzip")
    table = tfio.read("/data/out")            # schema inferred
    table = tfio.read("/data/out", schema=my_schema, columns=["x", "y"])
    ds = tfio.TFRecordDataset("/data/out", batch_size=1024)
    with ds.batches() as it:
        for batch in it:                      # ColumnarBatch, "date" included
            ...
"""

from __future__ import annotations

from typing import Any, Iterable, List, Optional, Sequence

from tpu_tfrecord_torch.io.dataset import CheckpointableIterator, IteratorState, TFRecordDataset
from tpu_tfrecord_torch.io.paths import Shard, discover_shards, has_success_marker
from tpu_tfrecord_torch.io.reader import DatasetReader, ShardReader
from tpu_tfrecord_torch.io.table import Table
from tpu_tfrecord_torch.io.writer import DatasetWriter, ShardWriter, write_dataset
from tpu_tfrecord_torch.options import TFRecordOptions
from tpu_tfrecord_torch.registry import register_format
from tpu_tfrecord_torch.schema import StructType


class TFRecordDataSource:
    """Format plugin: name + planning entry points (ref DefaultSource)."""

    short_name = "tfrecord"

    def infer_schema(self, paths, **options: Any) -> StructType:
        return DatasetReader(paths, **options).schema()

    def reader(self, paths, **options: Any) -> DatasetReader:
        return DatasetReader(paths, **options)

    def writer(
        self,
        path: str,
        schema: StructType,
        mode: str = "error",
        partition_by: Optional[List[str]] = None,
        **options: Any,
    ) -> DatasetWriter:
        opts = TFRecordOptions.from_map(options)
        return DatasetWriter(path, schema, opts, partition_by=partition_by, mode=mode)

    # Class-based identity like the reference's equals/hashCode
    # (DefaultSource.scala:140-142) so registry lookups dedupe.
    def __eq__(self, other: Any) -> bool:
        return isinstance(other, TFRecordDataSource)

    def __hash__(self) -> int:
        return hash(TFRecordDataSource)


register_format(TFRecordDataSource.short_name, TFRecordDataSource)


# read() materializes EVERYTHING as Python row lists — ~10-50x the on-disk
# bytes in memory. Refuse datasets beyond this size unless the caller opts
# in (limit=, bigger max_bytes=, or max_bytes=None).
_READ_MAX_BYTES_DEFAULT = 4 << 30


def read(
    paths,
    columns: Optional[List[str]] = None,
    options: Optional[TFRecordOptions] = None,
    *,
    limit: Optional[int] = None,
    max_bytes: Optional[int] = _READ_MAX_BYTES_DEFAULT,
    **option_kwargs: Any,
) -> Table:
    """Read a TFRecord dataset fully into a Table (schema inferred unless
    given). For streaming use ``reader()`` or ``TFRecordDataset``.

    ``limit`` caps the number of materialized rows (a cheap head over a big
    dataset). Without a limit, datasets whose on-disk size exceeds
    ``max_bytes`` (default 4 GiB) are refused with guidance — Python row
    lists cost an order of magnitude more RAM than the files themselves.
    """
    r = (
        DatasetReader(paths, options=options)
        if options is not None
        else DatasetReader(paths, **option_kwargs)
    )
    if limit is None and max_bytes is not None:
        total = sum(sh.size for sh in r.shards)
        if total > max_bytes:
            raise ValueError(
                f"dataset is {total / (1 << 30):.1f} GiB on disk, over the "
                f"read() guard of {max_bytes / (1 << 30):.1f} GiB; "
                "materializing it as Python rows would need far more RAM. "
                "Use tpu_tfrecord_torch.io.reader() or "
                "tpu_tfrecord_torch.io.TFRecordDataset to stream, pass "
                "limit=N for a head, or raise/disable with max_bytes="
            )
    schema = r.schema() if columns is None else r.schema().select(columns)
    out: List[List[Any]] = []
    rows_it = r.rows(columns)
    try:
        for row in rows_it:
            if limit is not None and len(out) >= limit:
                break
            out.append(list(row))
    finally:
        rows_it.close()  # early break mid-shard: close the file now, not at GC
    return Table(schema, out)


def reader(paths, options: Optional[TFRecordOptions] = None, **option_kwargs: Any) -> DatasetReader:
    if options is not None:
        return DatasetReader(paths, options=options)
    return DatasetReader(paths, **option_kwargs)


def write(
    rows: Iterable[Sequence[Any]],
    schema: StructType,
    path: str,
    mode: str = "error",
    partition_by: Optional[List[str]] = None,
    options: Optional[TFRecordOptions] = None,
    **option_kwargs: Any,
) -> List[str]:
    if isinstance(rows, Table):
        schema = rows.schema if schema is None else schema
        rows = rows.rows
    return write_dataset(
        rows, schema, path, mode=mode, partition_by=partition_by,
        options=options, **option_kwargs,
    )


__all__ = [
    "TFRecordDataSource",
    "TFRecordDataset",
    "CheckpointableIterator",
    "IteratorState",
    "DatasetReader",
    "DatasetWriter",
    "ShardReader",
    "ShardWriter",
    "Shard",
    "Table",
    "read",
    "write",
    "reader",
    "write_dataset",
    "discover_shards",
    "has_success_marker",
]
