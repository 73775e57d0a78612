"""Typed read/write options: the record type and the few knobs the port's
read and write paths take.

A cut-down copy of ``tpu_tfrecord/options.py``: ``RecordType`` with the
reference's exact spellings, and ``TFRecordOptions`` with the record type,
the write codec and an optional user schema. Reads always verify CRCs.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Any, Dict, Optional

from tpu_tfrecord_torch import wire
from tpu_tfrecord_torch.schema import StructType


class RecordType(enum.Enum):
    EXAMPLE = "Example"
    SEQUENCE_EXAMPLE = "SequenceExample"
    BYTE_ARRAY = "ByteArray"

    @staticmethod
    def parse(value: "RecordType | str | None") -> "RecordType":
        """Parse with the reference's exact accepted spellings and default
        (``Example``; unknown value -> error, ref DefaultSource.scala:67-68)."""
        if value is None or value == "":
            return RecordType.EXAMPLE
        if isinstance(value, RecordType):
            return value
        for rt in RecordType:
            if rt.value == value:
                return rt
        raise ValueError(
            f"Unsupported recordType {value}: recordType can be ByteArray, "
            "Example or SequenceExample"
        )


@dataclass(frozen=True)
class TFRecordOptions:
    """Options for one read or write, validated at construction.

    - record_type: Example | SequenceExample | ByteArray
    - codec: None | 'gzip' | 'deflate' (write side; reads infer it from the
      file extension)
    - schema: optional user-provided StructType (skips inference)
    """

    record_type: RecordType = RecordType.EXAMPLE
    codec: Optional[str] = None
    schema: Optional[StructType] = None

    @staticmethod
    def from_map(**options: Any) -> "TFRecordOptions":
        """Build from keyword options, accepting the reference's spelling
        ``recordType`` as well as ``record_type``. Unknown keys raise: a typo
        must fail loudly, never change behaviour silently."""
        merged: Dict[str, Any] = dict(options)
        record_type = RecordType.parse(
            merged.pop("recordType", merged.pop("record_type", None))
        )
        codec = wire.normalize_codec(merged.pop("codec", None))
        schema = merged.pop("schema", None)
        if isinstance(schema, (str, dict)):
            schema = StructType.from_json(schema)
        if merged:
            raise ValueError(f"unknown TFRecord option(s): {sorted(merged)}")
        return TFRecordOptions(record_type, codec, schema)

    def file_extension(self) -> str:
        """'.tfrecord' + codec suffix (ref DefaultSource.scala:112-114)."""
        return ".tfrecord" + wire.codec_extension(self.codec)
