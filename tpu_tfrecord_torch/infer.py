"""Schema inference with the numeric-precedence type lattice.

Re-implementation of reference TensorFlowInferSchema.scala:26-229:

1. Infer a type per feature per record (empty list -> "null type"; length 1 ->
   scalar; length > 1 -> array; TensorFlowInferSchema.scala:147-188).
2. Merge per-record maps with the tightest common type by numeric precedence
   Long < Float < String < Array(Long) < ... < Array(Array(String))
   (TensorFlowInferSchema.scala:194-228).
3. Fields still null-typed at the end become NullType columns
   (TensorFlowInferSchema.scala:48-57).

SequenceExample FeatureLists reduce their inner Features' types and wrap to
Array(Array(t)) (TensorFlowInferSchema.scala:98-118).

Where the reference runs this as a Spark RDD ``aggregate`` (per-partition
seqOp on executors + combOp tree-merge on the coordinator,
TensorFlowInferSchema.scala:40-43), this version exposes the same
algebra as plain functions: ``infer_from_records`` is the seqOp loop,
``merge_type_maps`` the combOp. Copy of ``tpu_tfrecord/infer.py``.

Field order: the reference inherits JVM HashMap iteration order (arbitrary);
we emit fields sorted by name for determinism across hosts.
"""

from __future__ import annotations

from typing import Dict, Iterable, Mapping, Optional, Union

from tpu_tfrecord_torch import proto
from tpu_tfrecord_torch.proto import BYTES_LIST, FLOAT_LIST, INT64_LIST, Example, Feature, SequenceExample
from tpu_tfrecord_torch.schema import (
    ArrayType,
    BinaryType,
    DataType,
    FloatType,
    LongType,
    NullType,
    StringType,
    StructField,
    StructType,
)

# A "null" inferred type is represented as Python None, like the reference's
# Scala nulls inside the aggregation maps.
TypeMap = Dict[str, Optional[DataType]]

_LONG = LongType()
_FLOAT = FloatType()
_STRING = StringType()


class SchemaInferenceError(ValueError):
    pass


def infer_field(feature: Feature) -> Optional[DataType]:
    """Infer one Feature's type (ref TensorFlowInferSchema.scala:132-188)."""
    n = len(feature.values)
    if feature.kind == BYTES_LIST:
        base: DataType = _STRING
    elif feature.kind == INT64_LIST:
        base = _LONG
    elif feature.kind == FLOAT_LIST:
        base = _FLOAT
    else:
        raise SchemaInferenceError("unsupported feature kind (oneof unset)")
    if n == 0:
        return None
    if n > 1:
        return ArrayType(base)
    return base


def _precedence(dtype: DataType) -> int:
    """The lattice (ref TensorFlowInferSchema.scala:194-207)."""
    if dtype == _LONG:
        return 1
    if dtype == _FLOAT:
        return 2
    if dtype == _STRING:
        return 3
    if isinstance(dtype, ArrayType):
        elem = dtype.element_type
        if elem == _LONG:
            return 4
        if elem == _FLOAT:
            return 5
        if elem == _STRING:
            return 6
        if isinstance(elem, ArrayType):
            inner = elem.element_type
            if inner == _LONG:
                return 7
            if inner == _FLOAT:
                return 8
            if inner == _STRING:
                return 9
    raise SchemaInferenceError(f"Unable to get the precedence for datatype {dtype}")


def find_tightest_common_type(
    t1: Optional[DataType], t2: Optional[DataType]
) -> Optional[DataType]:
    """Tightest common type; None (null) yields the other side
    (ref TensorFlowInferSchema.scala:213-228)."""
    if t1 == t2:
        return t1
    if t1 is None:
        return t2
    if t2 is None:
        return t1
    return t1 if _precedence(t1) > _precedence(t2) else t2


def _update(acc: TypeMap, name: str, current: Optional[DataType]) -> None:
    if name in acc:
        acc[name] = find_tightest_common_type(acc[name], current)
    else:
        acc[name] = current


def infer_example_row_type(acc: TypeMap, example: Example) -> TypeMap:
    for name, feature in example.features.items():
        _update(acc, name, infer_field(feature))
    return acc


def infer_sequence_example_row_type(acc: TypeMap, se: SequenceExample) -> TypeMap:
    for name, feature in se.context.items():
        _update(acc, name, infer_field(feature))
    for name, flist in se.feature_lists.items():
        if not flist.feature:
            _update(acc, name, None)
            continue
        inner: Optional[DataType] = None
        first = True
        for f in flist.feature:
            t = infer_field(f)
            inner = t if first else find_tightest_common_type(inner, t)
            first = False
        if inner is None:
            # All inner features empty: the whole FeatureList is "null" so far.
            _update(acc, name, None)
        elif isinstance(inner, ArrayType):
            _update(acc, name, ArrayType(inner))
        else:
            _update(acc, name, ArrayType(ArrayType(inner)))
    return acc


# Precedence -> type, the inverse of _precedence (index == precedence).
# Shared with the native inference seqOp (tfr_infer_batch), whose per-shard
# output is a (name -> max precedence) map in exactly this encoding.
_PREC_TYPES = [
    None,
    _LONG,
    _FLOAT,
    _STRING,
    ArrayType(_LONG),
    ArrayType(_FLOAT),
    ArrayType(_STRING),
    ArrayType(ArrayType(_LONG)),
    ArrayType(ArrayType(_FLOAT)),
    ArrayType(ArrayType(_STRING)),
]


def type_map_from_precedences(precs: Mapping[str, int]) -> TypeMap:
    """Native seqOp partial (name -> max precedence 0..9) -> TypeMap.
    Valid because the lattice merge IS precedence max with null identity
    (find_tightest_common_type), so the max commutes with per-record folds."""
    return {name: _PREC_TYPES[p] for name, p in precs.items()}


def merge_type_maps(first: TypeMap, second: TypeMap) -> TypeMap:
    """The combOp: key union + tightest common type. Like the reference's
    ``.get`` on the Option (TensorFlowInferSchema.scala:124), merging two
    *incompatible* concrete types raises (SURVEY.md §3.3 quirk)."""
    merged: TypeMap = {}
    for key in first.keys() | second.keys():
        merged[key] = find_tightest_common_type(first.get(key), second.get(key))
    return merged


def type_map_to_schema(acc: Mapping[str, Optional[DataType]]) -> StructType:
    fields = [
        StructField(name, NullType() if dtype is None else dtype, nullable=True)
        for name, dtype in sorted(acc.items())
    ]
    return StructType(fields)


def infer_from_records(
    records: Iterable[bytes],
    record_type,
    limit: Optional[int] = None,
) -> TypeMap:
    """seqOp loop over serialized record bytes (one shard's partial map)."""
    from tpu_tfrecord_torch.options import RecordType

    acc: TypeMap = {}
    count = 0
    if record_type == RecordType.EXAMPLE:
        for data in records:
            infer_example_row_type(acc, proto.parse_example(data))
            count += 1
            if limit is not None and count >= limit:
                break
    elif record_type == RecordType.SEQUENCE_EXAMPLE:
        for data in records:
            infer_sequence_example_row_type(acc, proto.parse_sequence_example(data))
            count += 1
            if limit is not None and count >= limit:
                break
    else:
        raise SchemaInferenceError(
            "Unsupported recordType: recordType can be Example or SequenceExample"
        )
    return acc


def infer_schema(
    records: Iterable[Union[bytes, Example, SequenceExample]],
    record_type=None,
    limit: Optional[int] = None,
) -> StructType:
    """Infer a StructType from records (bytes or parsed messages).

    The ByteArray record type has a fixed single-column schema
    (ref TensorFlowInferSchema.scala:60-64).
    """
    from tpu_tfrecord_torch.options import RecordType

    record_type = RecordType.parse(record_type) if not isinstance(record_type, RecordType) else record_type
    if record_type == RecordType.BYTE_ARRAY:
        return byte_array_schema()

    acc: TypeMap = {}
    count = 0
    for rec in records:
        if isinstance(rec, (bytes, bytearray, memoryview)):
            rec = (
                proto.parse_example(bytes(rec))
                if record_type == RecordType.EXAMPLE
                else proto.parse_sequence_example(bytes(rec))
            )
        if record_type == RecordType.EXAMPLE:
            if not isinstance(rec, Example):
                raise SchemaInferenceError(f"expected Example, got {type(rec).__name__}")
            infer_example_row_type(acc, rec)
        else:
            if not isinstance(rec, SequenceExample):
                raise SchemaInferenceError(
                    f"expected SequenceExample, got {type(rec).__name__}"
                )
            infer_sequence_example_row_type(acc, rec)
        count += 1
        if limit is not None and count >= limit:
            break
    return type_map_to_schema(acc)


def byte_array_schema() -> StructType:
    """ref TensorFlowInferSchema.scala:60-64."""
    return StructType([StructField("byteArray", BinaryType())])
