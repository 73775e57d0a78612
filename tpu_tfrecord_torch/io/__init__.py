"""IO layer: write a TFRecord dataset and stream it back as columnar batches.

::

    import tpu_tfrecord_torch.io as tfio

    tfio.write(rows, schema, "/data/out", mode="overwrite", codec="gzip")
    ds = tfio.TFRecordDataset("/data/out", batch_size=1024)
    with ds.batches() as it:
        for batch in it:
            ...
"""

from __future__ import annotations

from typing import Any, Iterable, List, Optional, Sequence

from tpu_tfrecord_torch.io.dataset import TFRecordDataset
from tpu_tfrecord_torch.io.paths import Shard, discover_shards, has_success_marker
from tpu_tfrecord_torch.io.writer import write_rows
from tpu_tfrecord_torch.options import TFRecordOptions
from tpu_tfrecord_torch.schema import StructType


def write(
    rows: Iterable[Sequence[Any]],
    schema: StructType,
    path: str,
    mode: str = "error",
    options: Optional[TFRecordOptions] = None,
    **option_kwargs: Any,
) -> List[str]:
    """One-call write API: ``write(rows, schema, path, mode='overwrite',
    recordType='SequenceExample', codec='gzip')``. Returns the written part
    file paths."""
    opts = options or TFRecordOptions.from_map(**option_kwargs)
    return write_rows(rows, schema, path, opts, mode=mode)


__all__ = [
    "Shard",
    "TFRecordDataset",
    "discover_shards",
    "has_success_marker",
    "write",
]
