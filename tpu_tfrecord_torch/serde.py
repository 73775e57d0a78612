"""Schema-driven row <-> tf.Example/SequenceExample codec.

Re-implementation of the reference's TFRecordSerializer.scala and
TFRecordDeserializer.scala, with the exact same type semantics:

- Integer/Long -> Int64List; Float -> FloatList; Double and Decimal are
  DOWNCAST to float32 on the wire (TFRecordSerializer.scala:86-90) and come
  back widened (Double) / re-decimalized (Decimal) on read
  (TFRecordDeserializer.scala:86-91).
- String -> utf-8 BytesList; Binary -> BytesList.
- Array of a scalar type -> the corresponding list feature.
- Array-of-Array -> a SequenceExample FeatureList (one inner Feature per
  sub-array; TFRecordSerializer.scala:137-147). Only valid for
  SequenceExample rows.
- Null handling: a None value for a nullable field is OMITTED on write
  (TFRecordSerializer.scala:24-33) and a missing feature reads back as None
  for nullable fields; for non-nullable fields both directions raise
  (TFRecordSerializer.scala:29-31, TFRecordDeserializer.scala:31).
- On read, the feature kind must match the schema type family
  ("Feature must be of type ..." requires, TFRecordDeserializer.scala:177-221).

Copy of ``tpu_tfrecord/serde.py``.

Rows are plain Python sequences aligned to the schema's field order, with
None for null — the analog of Spark's InternalRow. Converters/writers are
precomputed PER SCHEMA at construction for both directions; the reference only
did this on the serialize side and rebuilt writers per field per row on
deserialize (TFRecordDeserializer.scala:29 vs TFRecordSerializer.scala:14) —
an inefficiency SURVEY.md §3.1 calls out, fixed here.

Decoders are stateless: every call builds a fresh row, so values can never
leak between records (pinned by the reference's state-leak regression test,
TFRecordDeserializerTest.scala:313-346, mirrored in tests/test_serde.py).
"""

from __future__ import annotations

import decimal
from typing import Any, Callable, List, Optional, Sequence

import numpy as np

from tpu_tfrecord_torch import proto
from tpu_tfrecord_torch.proto import (
    BYTES_LIST,
    FLOAT_LIST,
    INT64_LIST,
    Example,
    Feature,
    FeatureList,
    SequenceExample,
)
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
)

Row = List[Any]


class NullValueError(ValueError):
    """A null value where the schema forbids it (the reference throws
    NullPointerException, e.g. TFRecordSerializer.scala:30)."""


class UnsupportedDataTypeError(ValueError):
    """A schema type outside the supported vocabulary (the reference throws
    RuntimeException at converter construction, TFRecordSerializer.scala:151)."""


def _f32(value: Any) -> float:
    return float(np.float32(value))


def _to_i32(value: int) -> int:
    """Scala Long.toInt semantics: two's-complement truncation to 32 bits."""
    value &= 0xFFFFFFFF
    return value - (1 << 32) if value >= (1 << 31) else value


# ---------------------------------------------------------------------------
# Serializer (row -> proto)
# ---------------------------------------------------------------------------


class TFRecordSerializer:
    """Serialize rows to Example / SequenceExample / raw bytes.

    Mirrors reference TFRecordSerializer.scala:12-208. Unsupported top-level
    types raise at construction (pinned by TFRecordSerializerTest.scala:290-299).
    """

    def __init__(self, schema: StructType):
        self.schema = schema
        self._converters = [self._new_feature_converter(f.data_type) for f in schema]
        self._is_feature_list = [
            isinstance(f.data_type, ArrayType)
            and isinstance(f.data_type.element_type, ArrayType)
            for f in schema
        ]

    # -- entry points -------------------------------------------------------

    def serialize_byte_array(self, row: Sequence[Any]) -> bytes:
        value = row[0]
        if not isinstance(value, (bytes, bytearray, memoryview)):
            raise TypeError("ByteArray record type requires a single binary column")
        return bytes(value)

    def serialize_example(self, row: Sequence[Any]) -> Example:
        example = Example()
        for idx, field in enumerate(self.schema):
            value = row[idx]
            if value is not None:
                if self._is_feature_list[idx]:
                    raise UnsupportedDataTypeError(
                        f"Field {field.name}: array-of-array maps to a "
                        "FeatureList and requires recordType=SequenceExample"
                    )
                example.features[field.name] = self._converters[idx](value)
            elif not field.nullable:
                raise NullValueError(f"{field.name} does not allow null values")
        return example

    def serialize_sequence_example(self, row: Sequence[Any]) -> SequenceExample:
        se = SequenceExample()
        for idx, field in enumerate(self.schema):
            value = row[idx]
            if value is not None:
                if self._is_feature_list[idx]:
                    se.feature_lists[field.name] = self._converters[idx](value)
                else:
                    se.context[field.name] = self._converters[idx](value)
            elif not field.nullable:
                raise NullValueError(f"{field.name} does not allow null values")
        return se

    # -- converters ---------------------------------------------------------

    def _new_feature_converter(self, dtype: DataType) -> Callable[[Any], Any]:
        if isinstance(dtype, NullType):
            return lambda value: None
        if isinstance(dtype, (IntegerType, LongType)):
            return lambda value: Feature(INT64_LIST, [int(value)])
        if isinstance(dtype, FloatType):
            return lambda value: Feature(FLOAT_LIST, [_f32(value)])
        if isinstance(dtype, (DoubleType, DecimalType)):
            # Explicit precision loss: double/decimal -> float32 on the wire.
            return lambda value: Feature(FLOAT_LIST, [_f32(value)])
        if isinstance(dtype, StringType):
            return lambda value: Feature(BYTES_LIST, [str(value).encode("utf-8")])
        if isinstance(dtype, BinaryType):
            return lambda value: Feature(BYTES_LIST, [bytes(value)])
        if isinstance(dtype, ArrayType):
            return self._new_array_converter(dtype)
        raise UnsupportedDataTypeError(
            f"Cannot convert field to unsupported data type {dtype}"
        )

    def _new_array_converter(self, dtype: ArrayType) -> Callable[[Any], Any]:
        elem = dtype.element_type
        if isinstance(elem, (IntegerType, LongType)):
            def conv(values):
                return Feature(INT64_LIST, [int(_not_null(v)) for v in values])
        elif isinstance(elem, (FloatType, DoubleType, DecimalType)):
            def conv(values):
                return Feature(FLOAT_LIST, [_f32(_not_null(v)) for v in values])
        elif isinstance(elem, StringType):
            def conv(values):
                return Feature(
                    BYTES_LIST, [str(_not_null(v)).encode("utf-8") for v in values]
                )
        elif isinstance(elem, BinaryType):
            def conv(values):
                return Feature(BYTES_LIST, [bytes(_not_null(v)) for v in values])
        elif isinstance(elem, ArrayType):
            # 2-D array -> FeatureList (TFRecordSerializer.scala:137-147).
            inner = self._new_feature_converter(elem)
            def conv(values):
                return FeatureList([inner(_not_null(v)) for v in values])
        else:
            raise UnsupportedDataTypeError(
                f"Array element data type {elem} is unsupported"
            )
        return conv


def _not_null(value: Any) -> Any:
    if value is None:
        # The reference NPEs on null array elements when building the proto
        # (bytesListFeature -> ByteString.copyFrom(null)).
        raise NullValueError("null array element cannot be written to a TFRecord feature")
    return value


# ---------------------------------------------------------------------------
# Deserializer (proto -> row)
# ---------------------------------------------------------------------------


def _require_kind(feature: Feature, kind: int, label: str) -> None:
    if feature is None or feature.kind != kind:
        raise ValueError(f"Feature must be of type {label}")


def _int64_values(feature: Feature) -> Sequence[int]:
    _require_kind(feature, INT64_LIST, "Int64List")
    return feature.values


def _float_values(feature: Feature) -> Sequence[float]:
    _require_kind(feature, FLOAT_LIST, "FloatList")
    return feature.values


def _bytes_values(feature: Feature) -> Sequence[bytes]:
    _require_kind(feature, BYTES_LIST, "ByteList")
    return feature.values


def _head(values: Sequence, label: str):
    if len(values) == 0:
        raise ValueError(f"empty {label} feature has no head value")
    return values[0]


class TFRecordDeserializer:
    """Deserialize Example / SequenceExample / raw bytes into rows.

    Mirrors reference TFRecordDeserializer.scala:15-277. Feature writers are
    precomputed per schema (the reference rebuilt them per field per row).
    """

    def __init__(self, schema: StructType):
        self.schema = schema
        self._writers = [self._new_feature_writer(f.data_type) for f in schema]
        self._list_writers = [self._new_feature_list_writer(f.data_type) for f in schema]

    # -- entry points -------------------------------------------------------

    def deserialize_byte_array(self, data: bytes) -> Row:
        return [bytes(data)]

    def deserialize_example(self, example: Example) -> Row:
        row: Row = [None] * len(self.schema)
        for idx, field in enumerate(self.schema):
            feature = example.features.get(field.name)
            if feature is not None:
                row[idx] = self._writers[idx](feature)
            elif not field.nullable:
                raise NullValueError(f"Field {field.name} does not allow null values")
        return row

    def deserialize_sequence_example(self, se: SequenceExample) -> Row:
        row: Row = [None] * len(self.schema)
        for idx, field in enumerate(self.schema):
            feature = se.context.get(field.name)
            if feature is not None:
                row[idx] = self._writers[idx](feature)
                continue
            flist = se.feature_lists.get(field.name)
            if flist is not None:
                writer = self._list_writers[idx]
                if writer is None:
                    raise UnsupportedDataTypeError(
                        f"Cannot convert FeatureList to data type "
                        f"{field.data_type} for field {field.name}"
                    )
                row[idx] = writer(flist)
            elif not field.nullable:
                raise NullValueError(f"Field {field.name} does not allow null values")
        return row

    # -- feature writers ----------------------------------------------------

    def _new_feature_writer(self, dtype: DataType) -> Callable[[Feature], Any]:
        if isinstance(dtype, NullType):
            return lambda feature: None
        if isinstance(dtype, IntegerType):
            return lambda feature: _to_i32(_head(_int64_values(feature), "Int64List"))
        if isinstance(dtype, LongType):
            return lambda feature: int(_head(_int64_values(feature), "Int64List"))
        if isinstance(dtype, FloatType):
            return lambda feature: float(_head(_float_values(feature), "FloatList"))
        if isinstance(dtype, DoubleType):
            return lambda feature: float(_head(_float_values(feature), "FloatList"))
        if isinstance(dtype, DecimalType):
            return lambda feature: decimal.Decimal(
                str(_head(_float_values(feature), "FloatList"))
            )
        if isinstance(dtype, StringType):
            return lambda feature: _head(_bytes_values(feature), "ByteList").decode("utf-8")
        if isinstance(dtype, BinaryType):
            return lambda feature: bytes(_head(_bytes_values(feature), "ByteList"))
        if isinstance(dtype, ArrayType):
            return self._new_array_writer(dtype)
        raise UnsupportedDataTypeError(f"{dtype} is not supported yet.")

    def _new_array_writer(self, dtype: ArrayType) -> Callable[[Feature], List[Any]]:
        elem = dtype.element_type
        if isinstance(elem, IntegerType):
            return lambda feature: [_to_i32(v) for v in _int64_values(feature)]
        if isinstance(elem, LongType):
            return lambda feature: [int(v) for v in _int64_values(feature)]
        if isinstance(elem, FloatType):
            return lambda feature: [float(v) for v in _float_values(feature)]
        if isinstance(elem, DoubleType):
            return lambda feature: [float(v) for v in _float_values(feature)]
        if isinstance(elem, DecimalType):
            return lambda feature: [
                decimal.Decimal(str(v)) for v in _float_values(feature)
            ]
        if isinstance(elem, StringType):
            return lambda feature: [v.decode("utf-8") for v in _bytes_values(feature)]
        if isinstance(elem, BinaryType):
            return lambda feature: [bytes(v) for v in _bytes_values(feature)]
        if isinstance(elem, ArrayType):
            # A nested array can never come from a single Feature — only from
            # a FeatureList. Defer the error to call time, like the reference
            # (writers there are built lazily per row, so a SequenceExample
            # field served by a FeatureList never hits this path).
            def bad_writer(feature):
                raise UnsupportedDataTypeError(
                    f"Cannot convert Array type to unsupported data type {elem}"
                )

            return bad_writer
        raise UnsupportedDataTypeError(
            f"Cannot convert Array type to unsupported data type {elem}"
        )

    def _new_feature_list_writer(
        self, dtype: DataType
    ) -> Optional[Callable[[FeatureList], List[Any]]]:
        """Writer for FeatureList -> ArrayType(element); each inner Feature is
        decoded with the element type's feature writer
        (TFRecordDeserializer.scala:129-143). None for non-array types."""
        if not isinstance(dtype, ArrayType):
            return None
        try:
            elem_writer = self._new_feature_writer(dtype.element_type)
        except UnsupportedDataTypeError:
            return None
        return lambda flist: [elem_writer(f) for f in flist.feature]


# ---------------------------------------------------------------------------
# Record-level convenience: serialized bytes <-> rows
# ---------------------------------------------------------------------------


def encode_row(serializer: TFRecordSerializer, record_type, row: Sequence[Any]) -> bytes:
    """Row -> serialized record bytes, dispatching on record type (the write
    hot loop body, ref TFRecordOutputWriter.scala:26-38)."""
    from tpu_tfrecord_torch.options import RecordType

    if record_type == RecordType.EXAMPLE:
        return proto.encode_example(serializer.serialize_example(row))
    if record_type == RecordType.SEQUENCE_EXAMPLE:
        return proto.encode_sequence_example(serializer.serialize_sequence_example(row))
    if record_type == RecordType.BYTE_ARRAY:
        return serializer.serialize_byte_array(row)
    raise ValueError(f"Unsupported recordType {record_type}")


def decode_record(deserializer: TFRecordDeserializer, record_type, data: bytes) -> Row:
    """Serialized record bytes -> row (the read hot loop body, ref
    TFRecordFileReader.scala:46-82)."""
    from tpu_tfrecord_torch.options import RecordType

    if record_type == RecordType.EXAMPLE:
        return deserializer.deserialize_example(proto.parse_example(data))
    if record_type == RecordType.SEQUENCE_EXAMPLE:
        return deserializer.deserialize_sequence_example(proto.parse_sequence_example(data))
    if record_type == RecordType.BYTE_ARRAY:
        return deserializer.deserialize_byte_array(data)
    raise ValueError(f"Unsupported recordType {record_type}")
