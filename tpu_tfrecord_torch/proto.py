"""Hand-rolled protobuf wire codec for tf.Example / tf.SequenceExample.

Re-implements natively what the reference pulls in as shaded JVM protobuf
classes (``org.tensorflow:proto`` — ``Example``, ``SequenceExample``,
``Features``, ``Feature``, ``FeatureList(s)``, ``Int64List``, ``FloatList``,
``BytesList``; see reference pom.xml:119-158 and SURVEY.md §2.9). No
TensorFlow or protobuf-runtime dependency: the messages involved are small and
closed, so we speak the proto3 wire format directly.

Message/field numbers (tensorflow/core/example/{example,feature}.proto):

    Example          { Features features = 1; }
    SequenceExample  { Features context = 1; FeatureLists feature_lists = 2; }
    Features         { map<string, Feature> feature = 1; }
    FeatureLists     { map<string, FeatureList> feature_list = 1; }
    FeatureList      { repeated Feature feature = 1; }
    Feature          { oneof kind { BytesList bytes_list = 1;
                                    FloatList float_list = 2;
                                    Int64List int64_list = 3; } }
    BytesList        { repeated bytes value = 1; }
    FloatList        { repeated float value = 1 [packed = true]; }
    Int64List        { repeated int64 value = 1 [packed = true]; }

The Python classes here are deliberately plain (lists/dicts) — the hot decode
ingest path bypasses them entirely and goes straight to columnar
numpy buffers (see ``tpu_tfrecord_torch.columnar``). Copy of
``tpu_tfrecord/proto.py``.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np

# Feature kind tags, aligned with the proto field numbers so that code
# mirroring the reference's `getKindCase.getNumber` checks reads naturally
# (ref TFRecordDeserializer.scala:179,192,205,216).
BYTES_LIST = 1
FLOAT_LIST = 2
INT64_LIST = 3

_KIND_NAMES = {BYTES_LIST: "bytes_list", FLOAT_LIST: "float_list", INT64_LIST: "int64_list"}


class ProtoDecodeError(ValueError):
    """Raised on malformed protobuf bytes."""


# ---------------------------------------------------------------------------
# Message classes
# ---------------------------------------------------------------------------


@dataclass
class Feature:
    """One feature: a kind (BYTES_LIST/FLOAT_LIST/INT64_LIST or None) + values.

    ``values`` is a list of bytes for BYTES_LIST, a list/array of float for
    FLOAT_LIST, and a list/array of int for INT64_LIST. kind=None mirrors a
    proto Feature with the oneof unset.
    """

    kind: Optional[int] = None
    values: Union[List[bytes], np.ndarray, List[int], List[float]] = field(default_factory=list)

    @staticmethod
    def int64_list(values: Sequence[int]) -> "Feature":
        return Feature(INT64_LIST, [int(v) for v in values])

    @staticmethod
    def float_list(values: Sequence[float]) -> "Feature":
        # float32 round-trip semantics: values are stored as f32 on the wire.
        return Feature(FLOAT_LIST, [float(np.float32(v)) for v in values])

    @staticmethod
    def bytes_list(values: Sequence[bytes]) -> "Feature":
        return Feature(BYTES_LIST, [bytes(v) for v in values])

    @property
    def kind_name(self) -> Optional[str]:
        return _KIND_NAMES.get(self.kind)

    def __len__(self) -> int:
        return len(self.values)


@dataclass
class FeatureList:
    feature: List[Feature] = field(default_factory=list)

    def __len__(self) -> int:
        return len(self.feature)


@dataclass
class Example:
    features: Dict[str, Feature] = field(default_factory=dict)

    def serialize(self) -> bytes:
        return encode_example(self)

    @staticmethod
    def parse(data: bytes) -> "Example":
        return parse_example(data)


@dataclass
class SequenceExample:
    context: Dict[str, Feature] = field(default_factory=dict)
    feature_lists: Dict[str, FeatureList] = field(default_factory=dict)

    def serialize(self) -> bytes:
        return encode_sequence_example(self)

    @staticmethod
    def parse(data: bytes) -> "SequenceExample":
        return parse_sequence_example(data)


# ---------------------------------------------------------------------------
# Wire-format primitives
# ---------------------------------------------------------------------------

_WT_VARINT = 0
_WT_I64 = 1
_WT_LEN = 2
_WT_I32 = 5


def _write_varint(out: bytearray, value: int) -> None:
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _read_varint(buf, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        try:
            b = buf[pos]
        except IndexError:
            raise ProtoDecodeError("truncated varint") from None
        result |= (b & 0x7F) << shift
        pos += 1
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 63:
            raise ProtoDecodeError("varint too long")


def _zigzag_i64(value: int) -> int:
    """Two's-complement int64 -> unsigned varint value (plain, not zigzag)."""
    return value & 0xFFFFFFFFFFFFFFFF


def _unsigned_to_i64(value: int) -> int:
    return value - (1 << 64) if value >= (1 << 63) else value


def _tag(field_number: int, wire_type: int) -> int:
    return (field_number << 3) | wire_type


def _write_len_field(out: bytearray, field_number: int, payload: bytes) -> None:
    _write_varint(out, _tag(field_number, _WT_LEN))
    _write_varint(out, len(payload))
    out += payload


def _skip_field(buf, pos: int, wire_type: int) -> int:
    if wire_type == _WT_VARINT:
        _, pos = _read_varint(buf, pos)
        return pos
    if wire_type == _WT_I64:
        return pos + 8
    if wire_type == _WT_LEN:
        length, pos = _read_varint(buf, pos)
        return pos + length
    if wire_type == _WT_I32:
        return pos + 4
    raise ProtoDecodeError(f"unsupported wire type {wire_type}")


def _iter_fields(buf, start: int, end: int) -> Iterator[Tuple[int, int, int, int]]:
    """Yield (field_number, wire_type, value_start, value_end) over a range.

    For VARINT fields value_end is the position after the varint and
    value_start its beginning; for LEN fields the (start, end) of the payload.
    """
    pos = start
    while pos < end:
        tag, pos = _read_varint(buf, pos)
        field_number = tag >> 3
        wire_type = tag & 0x7
        if wire_type == _WT_LEN:
            length, pos = _read_varint(buf, pos)
            if pos + length > end:
                raise ProtoDecodeError("truncated length-delimited field")
            yield field_number, wire_type, pos, pos + length
            pos += length
        elif wire_type == _WT_VARINT:
            vstart = pos
            _, pos = _read_varint(buf, pos)
            yield field_number, wire_type, vstart, pos
        elif wire_type == _WT_I64:
            if pos + 8 > end:
                raise ProtoDecodeError("truncated fixed64 field")
            yield field_number, wire_type, pos, pos + 8
            pos += 8
        elif wire_type == _WT_I32:
            if pos + 4 > end:
                raise ProtoDecodeError("truncated fixed32 field")
            yield field_number, wire_type, pos, pos + 4
            pos += 4
        else:
            raise ProtoDecodeError(f"unsupported wire type {wire_type}")


# ---------------------------------------------------------------------------
# Encoding
# ---------------------------------------------------------------------------


def _encode_feature(feature: Feature) -> bytes:
    out = bytearray()
    if feature.kind == INT64_LIST:
        payload = bytearray()
        for v in feature.values:
            _write_varint(payload, _zigzag_i64(int(v)))
        inner = bytearray()
        if payload:
            _write_len_field(inner, 1, bytes(payload))
        _write_len_field(out, INT64_LIST, bytes(inner))
    elif feature.kind == FLOAT_LIST:
        values = np.asarray(feature.values, dtype="<f4")
        inner = bytearray()
        if values.size:
            _write_len_field(inner, 1, values.tobytes())
        _write_len_field(out, FLOAT_LIST, bytes(inner))
    elif feature.kind == BYTES_LIST:
        inner = bytearray()
        for v in feature.values:
            _write_len_field(inner, 1, bytes(v))
        _write_len_field(out, BYTES_LIST, bytes(inner))
    elif feature.kind is None:
        pass
    else:
        raise ValueError(f"unknown feature kind {feature.kind}")
    return bytes(out)


def _encode_features_map(features: Dict[str, Feature], field_number: int = 1) -> bytes:
    """Encode a map<string, Feature> — one map-entry submessage per key.

    Keys are emitted in sorted order for deterministic output (protobuf leaves
    map order unspecified; the reference inherits JVM HashMap order).
    """
    out = bytearray()
    for name in sorted(features):
        entry = bytearray()
        key_bytes = name.encode("utf-8")
        _write_len_field(entry, 1, key_bytes)
        _write_len_field(entry, 2, _encode_feature(features[name]))
        _write_len_field(out, field_number, bytes(entry))
    return bytes(out)


def _encode_feature_list(flist: FeatureList) -> bytes:
    out = bytearray()
    for feature in flist.feature:
        _write_len_field(out, 1, _encode_feature(feature))
    return bytes(out)


def encode_example(example: Example) -> bytes:
    out = bytearray()
    _write_len_field(out, 1, _encode_features_map(example.features))
    return bytes(out)


def encode_sequence_example(se: SequenceExample) -> bytes:
    out = bytearray()
    _write_len_field(out, 1, _encode_features_map(se.context))
    fl_out = bytearray()
    for name in sorted(se.feature_lists):
        entry = bytearray()
        _write_len_field(entry, 1, name.encode("utf-8"))
        _write_len_field(entry, 2, _encode_feature_list(se.feature_lists[name]))
        _write_len_field(fl_out, 1, bytes(entry))
    _write_len_field(out, 2, bytes(fl_out))
    return bytes(out)


# ---------------------------------------------------------------------------
# Decoding
# ---------------------------------------------------------------------------


def _parse_feature(buf, start: int, end: int) -> Feature:
    # Repeated encounters of the same list field MERGE (protobuf submessage
    # merge semantics): values concatenate. A different oneof kind replaces.
    kind: Optional[int] = None
    values: Union[List[bytes], List[int], List[float]] = []
    for fnum, wtype, vstart, vend in _iter_fields(buf, start, end):
        if fnum == BYTES_LIST and wtype == _WT_LEN:
            if kind != BYTES_LIST:
                kind, values = BYTES_LIST, []
            for inum, iwt, istart, iend in _iter_fields(buf, vstart, vend):
                if inum == 1 and iwt == _WT_LEN:
                    values.append(bytes(buf[istart:iend]))
        elif fnum == FLOAT_LIST and wtype == _WT_LEN:
            if kind != FLOAT_LIST:
                kind, values = FLOAT_LIST, []
            for inum, iwt, istart, iend in _iter_fields(buf, vstart, vend):
                if inum != 1:
                    continue
                if iwt == _WT_LEN:  # packed
                    if (iend - istart) % 4:
                        raise ProtoDecodeError("packed float payload not 4-aligned")
                    values.extend(
                        np.frombuffer(buf, dtype="<f4", count=(iend - istart) // 4, offset=istart).tolist()
                    )
                elif iwt == _WT_I32:  # unpacked
                    values.append(struct.unpack_from("<f", buf, istart)[0])
        elif fnum == INT64_LIST and wtype == _WT_LEN:
            if kind != INT64_LIST:
                kind, values = INT64_LIST, []
            for inum, iwt, istart, iend in _iter_fields(buf, vstart, vend):
                if inum != 1:
                    continue
                if iwt == _WT_LEN:  # packed
                    pos = istart
                    while pos < iend:
                        raw, pos = _read_varint(buf, pos)
                        if pos > iend:
                            # a varint crossing the declared payload end is
                            # malformed — reading on into whatever bytes
                            # follow would silently fabricate a value
                            raise ProtoDecodeError(
                                "truncated varint in packed int64 list"
                            )
                        values.append(_unsigned_to_i64(raw))
                elif iwt == _WT_VARINT:  # unpacked
                    raw, _ = _read_varint(buf, istart)
                    values.append(_unsigned_to_i64(raw))
    return Feature(kind, values)


def _parse_features_map(buf, start: int, end: int) -> Dict[str, Feature]:
    result: Dict[str, Feature] = {}
    for fnum, wtype, vstart, vend in _iter_fields(buf, start, end):
        if fnum != 1 or wtype != _WT_LEN:
            continue
        name = None
        feature = Feature()
        for enum_, ewt, estart, eend in _iter_fields(buf, vstart, vend):
            if enum_ == 1 and ewt == _WT_LEN:
                name = bytes(buf[estart:eend]).decode("utf-8")
            elif enum_ == 2 and ewt == _WT_LEN:
                feature = _parse_feature(buf, estart, eend)
        if name is not None:
            result[name] = feature
    return result


def _parse_feature_list(buf, start: int, end: int) -> FeatureList:
    flist = FeatureList()
    for fnum, wtype, vstart, vend in _iter_fields(buf, start, end):
        if fnum == 1 and wtype == _WT_LEN:
            flist.feature.append(_parse_feature(buf, vstart, vend))
    return flist


def parse_example(data: bytes) -> Example:
    example = Example()
    for fnum, wtype, vstart, vend in _iter_fields(data, 0, len(data)):
        if fnum == 1 and wtype == _WT_LEN:
            example.features.update(_parse_features_map(data, vstart, vend))
    return example


def parse_sequence_example(data: bytes) -> SequenceExample:
    se = SequenceExample()
    for fnum, wtype, vstart, vend in _iter_fields(data, 0, len(data)):
        if fnum == 1 and wtype == _WT_LEN:
            se.context.update(_parse_features_map(data, vstart, vend))
        elif fnum == 2 and wtype == _WT_LEN:
            for gnum, gwt, gstart, gend in _iter_fields(data, vstart, vend):
                if gnum != 1 or gwt != _WT_LEN:
                    continue
                name = None
                flist = FeatureList()
                for enum_, ewt, estart, eend in _iter_fields(data, gstart, gend):
                    if enum_ == 1 and ewt == _WT_LEN:
                        name = bytes(data[estart:eend]).decode("utf-8")
                    elif enum_ == 2 and ewt == _WT_LEN:
                        flist = _parse_feature_list(data, estart, eend)
                if name is not None:
                    se.feature_lists[name] = flist
    return se
