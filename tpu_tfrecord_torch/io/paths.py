"""Shard discovery and Hive-style partition-directory layout.

Copy of ``tpu_tfrecord/io/paths.py`` over the port's filesystems
(``tpu_tfrecord_torch.fs``: local paths, ``http(s)://`` and fsspec URLs).

Covers what the reference delegates to Hadoop/Spark path machinery: glob
expansion (README.md: "can accept standard Hadoop globbing expressions"),
`col=value` partition directories produced by ``partitionBy`` (README.md
partitionBy example: output dirs ``number=1  number=2  number=8`` plus
``_SUCCESS``), partition-column value escaping, and partition-column type
inference on read (Spark's partition discovery infers long/double/string).
"""

from __future__ import annotations

import glob as _glob
import os
import re
import uuid
from dataclasses import dataclass
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

from tpu_tfrecord_torch.schema import DataType, DoubleType, LongType, StringType

SUCCESS_FILE = "_SUCCESS"
HIVE_DEFAULT_PARTITION = "__HIVE_DEFAULT_PARTITION__"
TEMP_PREFIX = "_temporary"

# Characters that must be %-escaped in partition directory names (the set
# Hive/Spark escape in ExternalCatalogUtils).
_ESCAPE_CHARS = set('"#%\'*/:=?\\\x7f{[]^')


def escape_partition_value(value: str) -> str:
    out = []
    for ch in value:
        if ch in _ESCAPE_CHARS or ord(ch) < 0x20:
            out.append(f"%{ord(ch):02X}")
        else:
            out.append(ch)
    return "".join(out)


def unescape_partition_value(value: str) -> str:
    return re.sub("%([0-9A-Fa-f]{2})", lambda m: chr(int(m.group(1), 16)), value)


def format_partition_value(value: Any) -> str:
    """Render a partition value the way Spark renders it into a dir name."""
    if value is None:
        return HIVE_DEFAULT_PARTITION
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, float):
        # Spark uses Java Double.toString; Python repr matches for typicals.
        return repr(value)
    if isinstance(value, bytes):
        return value.decode("utf-8", "replace")
    return str(value)


def partition_dir(columns: Sequence[str], values: Sequence[Any]) -> str:
    """Relative directory path ``c1=v1/c2=v2/...`` for one partition tuple."""
    parts = []
    for col, val in zip(columns, values):
        rendered = format_partition_value(val)
        if rendered != HIVE_DEFAULT_PARTITION:
            rendered = escape_partition_value(rendered)
        parts.append(f"{escape_partition_value(col)}={rendered}")
    return os.path.join(*parts) if parts else ""


def parse_partition_component(component: str) -> Optional[Tuple[str, Optional[str]]]:
    """Parse one ``col=value`` path component; None if not partition-shaped."""
    if "=" not in component:
        return None
    col, _, raw = component.partition("=")
    if not col:
        return None
    if raw == HIVE_DEFAULT_PARTITION:
        return unescape_partition_value(col), None
    return unescape_partition_value(col), unescape_partition_value(raw)


# Strict numeric shapes for partition-value classification, mirroring the
# JVM parses Spark's inference rides on: Long.parseLong (no trimming, no
# underscore separators, no 'inf') and Double.parseDouble (trims whitespace,
# accepts exact-case 'NaN'/'Infinity'). Python's int()/float() are more
# permissive ('1_0', lowercase 'inf'/'nan') — those must classify as
# strings, or mixed datasets silently coerce. The Java FloatTypeSuffix
# ('1.5f') is deliberately not accepted: the read-side cast uses Python
# float(), which cannot parse it.
_PARTITION_LONG_RE = re.compile(r"[+-]?\d+\Z")
_PARTITION_DOUBLE_RE = re.compile(
    r"[+-]?(NaN|Infinity|(\d+\.?\d*|\.\d+)([eE][+-]?\d+)?)\Z"
)


def infer_partition_type(values: Iterable[Optional[str]]) -> DataType:
    """Spark-style partition column type inference: long -> double -> string."""
    saw_long, saw_double = True, True
    for v in values:
        if v is None:
            continue
        if _PARTITION_LONG_RE.match(v):
            continue
        saw_long = False
        if not _PARTITION_DOUBLE_RE.match(v.strip()):
            saw_double = False
            break
    if saw_long:
        return LongType()
    if saw_double:
        return DoubleType()
    return StringType()


def cast_partition_value(raw: Optional[str], dtype: DataType):
    if raw is None:
        return None
    if isinstance(dtype, LongType):
        return int(raw)
    if isinstance(dtype, DoubleType):
        return float(raw)
    return raw


@dataclass(frozen=True)
class Shard:
    """One TFRecord file plus the partition values encoded in its path.

    The unit of parallelism: the reference reads one Spark task per file
    (isSplitable=false, DefaultSource.scala:26-29); here one shard maps to
    one decode worker.
    """

    path: str
    size: int
    partition_values: Tuple[Tuple[str, Optional[str]], ...] = ()

    @property
    def partitions(self) -> Dict[str, Optional[str]]:
        return dict(self.partition_values)


def is_data_file(name: str) -> bool:
    """Hidden/metadata files (_SUCCESS, _temporary, .crc...) are not data."""
    return not (name.startswith("_") or name.startswith("."))


def expand_paths(paths) -> List[str]:
    """Expand files/dirs/globs into a flat list of concrete roots (the
    reference gets this from Hadoop's FileSystem.globStatus). A URL goes
    through its filesystem (``fs.filesystem_for``); ``http(s)://`` has no
    glob and raises on one."""
    from tpu_tfrecord_torch import fs as _fs

    if isinstance(paths, (str, os.PathLike)):
        paths = [paths]
    out: List[str] = []
    for p in paths:
        p = os.fspath(p)
        fsys = _fs.filesystem_for(p)
        if _glob.has_magic(p):
            matches = fsys.glob(p)
            if not matches:
                raise FileNotFoundError(f"Path does not match any files: {p}")
            out.extend(matches)
        else:
            if not fsys.exists(p):
                raise FileNotFoundError(f"Path does not exist: {p}")
            out.append(p)
    return out


def discover_shards(paths) -> List[Shard]:
    """Find all data files under the input paths, with partition values
    parsed from ``col=value`` directory components below each root.

    Deterministic order (sorted walk): the files of a directory before its
    subdirectories, each in name order.
    """
    from tpu_tfrecord_torch import fs as _fs

    shards: List[Shard] = []
    for root in expand_paths(paths):
        fsys = _fs.filesystem_for(root)
        if fsys.isfile(root):
            shards.append(Shard(root, fsys.size(root)))
            continue
        root_norm = fsys.normalize(root).rstrip("/")
        for fpath, fsize in fsys.walk_files(root, is_data_file):
            rel = os.path.dirname(fpath)[len(root_norm) :].strip("/")
            pvals: List[Tuple[str, Optional[str]]] = []
            for comp in rel.split("/"):
                parsed = parse_partition_component(comp) if comp else None
                if parsed is not None:
                    pvals.append(parsed)
            shards.append(Shard(fpath, fsize, tuple(pvals)))
    return shards


def interleave(items: Sequence, slot: int, count: int) -> List:
    """The one owner of the interleaved assignment: slot ``s`` of ``count``
    takes items ``i`` with ``i % count == s``. The per-process shard split
    (``device.mesh.assign_shards``) and the dataset's process slot both go
    through it, so they cannot disagree about who owns what."""
    if count < 1:
        raise ValueError(f"count must be >= 1, got {count}")
    if not 0 <= slot < count:
        raise ValueError(f"slot must be in [0, {count}), got {slot}")
    return [it for i, it in enumerate(items) if i % count == slot]


def interleave_owner(index: int, count: int) -> int:
    """The inverse view of ``interleave``: which slot owns item ``index``."""
    if count < 1:
        raise ValueError(f"count must be >= 1, got {count}")
    return index % count


def partition_columns_of(shards: Sequence[Shard]) -> List[str]:
    """Union of partition column names across shards, in first-seen order."""
    cols: List[str] = []
    for sh in shards:
        for col, _ in sh.partition_values:
            if col not in cols:
                cols.append(col)
    return cols


def new_shard_filename(task_id: int, ext: str, job_uuid: Optional[str] = None) -> str:
    """Spark-style part-file name: ``part-00000-<uuid>.tfrecord[.gz]``."""
    job_uuid = job_uuid or uuid.uuid4().hex
    return f"part-{task_id:05d}-{job_uuid}{ext}"


def has_success_marker(path: str) -> bool:
    from tpu_tfrecord_torch import fs as _fs

    target = os.path.join(path, SUCCESS_FILE)
    return _fs.filesystem_for(target).exists(target)


def write_success_marker(path: str) -> None:
    from tpu_tfrecord_torch import fs as _fs

    target = os.path.join(path, SUCCESS_FILE)
    _fs.filesystem_for(target).touch(target)
