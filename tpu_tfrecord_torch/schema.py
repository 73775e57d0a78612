"""Schema model: the equivalent of Spark's StructType.

Mirrors the data-type vocabulary the reference supports (README.md "Supported
data types" table; TFRecordSerializer.scala:68-152): scalar Integer/Long/
Float/Double/Decimal/String/Binary, Array of those, and Array-of-Array (which
maps to SequenceExample FeatureLists). NullType arises only from schema
inference over empty feature lists (TensorFlowInferSchema.scala:147-188).

Unlike the reference's stringly-typed three-site option parsing, the schema is
a small immutable object graph with JSON round-trip (for shipping across
processes — the analog of reference SerializableConfiguration,
DefaultSource.scala:145-182) and a numpy dtype mapping for the columnar
ingest path. Copy of ``tpu_tfrecord/schema.py``.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np


class DataType:
    """Base class for all schema data types. Instances are immutable."""

    _name: str = "datatype"

    def simple_string(self) -> str:
        return self._name

    def __repr__(self) -> str:
        return self.simple_string()

    def __eq__(self, other: Any) -> bool:
        return type(self) is type(other)

    def __hash__(self) -> int:
        return hash(type(self))

    def to_json(self) -> Any:
        return self._name


class NullType(DataType):
    _name = "null"


class IntegerType(DataType):
    _name = "integer"


class LongType(DataType):
    _name = "long"


class FloatType(DataType):
    _name = "float"


class DoubleType(DataType):
    _name = "double"


class DecimalType(DataType):
    """Decimal(10, 0) — the reference always reads decimals at Spark's
    USER_DEFAULT precision/scale and downcasts to float32 on the wire
    (TFRecordSerializer.scala:88-90)."""

    _name = "decimal(10,0)"

    def __init__(self, precision: int = 10, scale: int = 0):
        self.precision = precision
        self.scale = scale

    def simple_string(self) -> str:
        return f"decimal({self.precision},{self.scale})"

    def __eq__(self, other: Any) -> bool:
        return (
            isinstance(other, DecimalType)
            and self.precision == other.precision
            and self.scale == other.scale
        )

    def __hash__(self) -> int:
        return hash((DecimalType, self.precision, self.scale))

    def to_json(self) -> Any:
        return self.simple_string()


class StringType(DataType):
    _name = "string"


class BinaryType(DataType):
    _name = "binary"


class ArrayType(DataType):
    """Array of a single element type; ``contains_null`` as in Spark."""

    def __init__(self, element_type: DataType, contains_null: bool = True):
        self.element_type = element_type
        self.contains_null = contains_null

    def simple_string(self) -> str:
        return f"array<{self.element_type.simple_string()}>"

    def __eq__(self, other: Any) -> bool:
        # Note: like the reference's type lattice, equality ignores
        # contains_null (ArrayType(LongType, _) patterns in
        # TensorFlowInferSchema.scala:194-207).
        return isinstance(other, ArrayType) and self.element_type == other.element_type

    def __hash__(self) -> int:
        return hash((ArrayType, self.element_type))

    def to_json(self) -> Any:
        return {
            "type": "array",
            "elementType": self.element_type.to_json(),
            "containsNull": self.contains_null,
        }


_ATOMIC_TYPES: Dict[str, DataType] = {
    "null": NullType(),
    "integer": IntegerType(),
    "long": LongType(),
    "float": FloatType(),
    "double": DoubleType(),
    "string": StringType(),
    "binary": BinaryType(),
}


def data_type_from_json(obj: Any) -> DataType:
    if isinstance(obj, str):
        if obj in _ATOMIC_TYPES:
            return _ATOMIC_TYPES[obj]
        if obj.startswith("decimal("):
            inner = obj[len("decimal(") : -1]
            precision, scale = (int(x) for x in inner.split(","))
            return DecimalType(precision, scale)
        raise ValueError(f"unknown data type {obj!r}")
    if isinstance(obj, dict) and obj.get("type") == "array":
        return ArrayType(
            data_type_from_json(obj["elementType"]), bool(obj.get("containsNull", True))
        )
    raise ValueError(f"unknown data type {obj!r}")


@dataclass(frozen=True)
class StructField:
    name: str
    data_type: DataType
    nullable: bool = True

    def to_json(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "type": self.data_type.to_json(),
            "nullable": self.nullable,
        }

    @staticmethod
    def from_json(obj: Dict[str, Any]) -> "StructField":
        return StructField(
            obj["name"], data_type_from_json(obj["type"]), bool(obj.get("nullable", True))
        )


class StructType:
    """An ordered collection of StructFields — the row schema."""

    def __init__(self, fields: List[StructField]):
        self.fields: Tuple[StructField, ...] = tuple(fields)
        self._index = {f.name: i for i, f in enumerate(self.fields)}
        if len(self._index) != len(self.fields):
            raise ValueError("duplicate field names in schema")

    @property
    def names(self) -> List[str]:
        return [f.name for f in self.fields]

    def field_index(self, name: str) -> int:
        return self._index[name]

    def __len__(self) -> int:
        return len(self.fields)

    def __iter__(self) -> Iterator[StructField]:
        return iter(self.fields)

    def __getitem__(self, key) -> StructField:
        if isinstance(key, str):
            return self.fields[self._index[key]]
        return self.fields[key]

    def __contains__(self, name: str) -> bool:
        return name in self._index

    def __eq__(self, other: Any) -> bool:
        return isinstance(other, StructType) and self.fields == other.fields

    def __hash__(self) -> int:
        return hash(self.fields)

    def __repr__(self) -> str:
        inner = ", ".join(
            f"{f.name}:{f.data_type.simple_string()}{'' if f.nullable else ' not null'}"
            for f in self.fields
        )
        return f"StructType({inner})"

    def add(self, name: str, data_type: DataType, nullable: bool = True) -> "StructType":
        return StructType(list(self.fields) + [StructField(name, data_type, nullable)])

    def select(self, names: List[str]) -> "StructType":
        missing = [n for n in names if n not in self._index]
        if missing:
            raise ValueError(
                f"unknown column(s) {missing}; available: {self.names}"
            )
        return StructType([self[n] for n in names])

    def drop(self, names) -> "StructType":
        drop_set = set(names)
        return StructType([f for f in self.fields if f.name not in drop_set])

    def to_json(self) -> Dict[str, Any]:
        return {"type": "struct", "fields": [f.to_json() for f in self.fields]}

    def json(self) -> str:
        return json.dumps(self.to_json())

    @staticmethod
    def from_json(obj) -> "StructType":
        if isinstance(obj, str):
            obj = json.loads(obj)
        return StructType([StructField.from_json(f) for f in obj["fields"]])


# ---------------------------------------------------------------------------
# numpy dtype mapping (the columnar & device view of the schema)
# ---------------------------------------------------------------------------

_NUMPY_DTYPES: Dict[type, np.dtype] = {
    IntegerType: np.dtype(np.int32),
    LongType: np.dtype(np.int64),
    FloatType: np.dtype(np.float32),
    DoubleType: np.dtype(np.float64),
    DecimalType: np.dtype(np.float64),
}


def numpy_dtype(data_type: DataType) -> Optional[np.dtype]:
    """The numpy dtype used for columnar buffers; None for bytes-like types."""
    if isinstance(data_type, (StringType, BinaryType, NullType)):
        return None
    if isinstance(data_type, ArrayType):
        return numpy_dtype(data_type.element_type)
    dt = _NUMPY_DTYPES.get(type(data_type))
    if dt is None:
        raise ValueError(f"no numpy dtype for {data_type}")
    return dt


def is_numeric(data_type: DataType) -> bool:
    return type(data_type) in _NUMPY_DTYPES


# Singletons for ergonomic schema literals (mirroring Spark's object types).
NULL = NullType()
INT = IntegerType()
LONG = LongType()
FLOAT = FloatType()
DOUBLE = DoubleType()
STRING = StringType()
BINARY = BinaryType()
