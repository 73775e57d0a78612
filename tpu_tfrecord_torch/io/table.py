"""A minimal in-memory table: rows + schema.

Copy of ``tpu_tfrecord/io/table.py``: the DataFrame stand-in for tests and
small jobs. The reference's user-facing currency is a Spark DataFrame; the
port's is columnar batches feeding torch tensors (``columnar``,
``device/ingest``), and a row-oriented Table keeps API parity for
round-trip tests, inspection and small exports.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Iterator, List, Sequence

from tpu_tfrecord_torch.schema import StructType


@dataclass
class Table:
    schema: StructType
    rows: List[List[Any]]

    def __len__(self) -> int:
        return len(self.rows)

    def __iter__(self) -> Iterator[List[Any]]:
        return iter(self.rows)

    def column(self, name: str) -> List[Any]:
        idx = self.schema.field_index(name)
        return [row[idx] for row in self.rows]

    def select(self, names: Sequence[str]) -> "Table":
        selected = self.schema.select(list(names))  # validates, names available
        idxs = [self.schema.field_index(n) for n in names]
        return Table(selected, [[r[i] for i in idxs] for r in self.rows])

    def sort_by(self, name: str) -> "Table":
        idx = self.schema.field_index(name)
        return Table(self.schema, sorted(self.rows, key=lambda r: (r[idx] is None, r[idx])))

    def to_dicts(self) -> List[dict]:
        names = self.schema.names
        return [dict(zip(names, row)) for row in self.rows]
