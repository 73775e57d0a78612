"""Shard discovery and output file naming for local datasets.

Cut-down copy of ``tpu_tfrecord/io/paths.py``: glob/dir expansion, a
deterministic sorted walk that skips hidden and metadata files
(``_SUCCESS``, ``_temporary``, ``.crc``), Spark-style part-file names and
the ``_SUCCESS`` marker. Partition directories (``col=value``) are walked
like any other directory; their values are not read back as columns.
"""

from __future__ import annotations

import glob as _glob
import os
import uuid
from dataclasses import dataclass
from typing import List, Optional

SUCCESS_FILE = "_SUCCESS"
TEMP_PREFIX = "_temporary"


@dataclass(frozen=True)
class Shard:
    """One TFRecord file and its size in bytes."""

    path: str
    size: int


def is_data_file(name: str) -> bool:
    """Hidden/metadata files (_SUCCESS, _temporary, .crc...) are not data."""
    return not (name.startswith("_") or name.startswith("."))


def expand_paths(paths) -> List[str]:
    """Expand files/dirs/globs into a flat list of concrete roots."""
    if isinstance(paths, (str, os.PathLike)):
        paths = [paths]
    out: List[str] = []
    for p in paths:
        p = os.fspath(p)
        if _glob.has_magic(p):
            matches = sorted(_glob.glob(p))
            if not matches:
                raise FileNotFoundError(f"Path does not match any files: {p}")
            out.extend(matches)
        else:
            if not os.path.exists(p):
                raise FileNotFoundError(f"Path does not exist: {p}")
            out.append(p)
    return out


def _walk_files(root: str):
    """Sorted walk yielding (path, size) of data files under ``root``: files
    of a directory first, then its subdirectories in name order. Directory
    symlinks are not followed."""
    stack = [root]
    while stack:
        dirpath = stack.pop()
        files, dirs = [], []
        with os.scandir(dirpath) as entries:
            for e in entries:
                if not is_data_file(e.name):
                    continue
                if e.is_dir(follow_symlinks=False):
                    dirs.append(e.path)
                elif not e.is_dir(follow_symlinks=True):
                    files.append((e.path, e.stat().st_size))
        yield from sorted(files)
        stack.extend(sorted(dirs, reverse=True))  # pop() visits in order


def discover_shards(paths) -> List[Shard]:
    """All data files under the input paths, in a deterministic order."""
    shards: List[Shard] = []
    for root in expand_paths(paths):
        if os.path.isfile(root):
            shards.append(Shard(root, os.path.getsize(root)))
        else:
            shards.extend(Shard(fpath, fsize) for fpath, fsize in _walk_files(root))
    return shards


def new_shard_filename(task_id: int, ext: str, job_uuid: Optional[str] = None) -> str:
    """Spark-style part-file name: ``part-00000-<uuid>.tfrecord[.gz]``."""
    job_uuid = job_uuid or uuid.uuid4().hex
    return f"part-{task_id:05d}-{job_uuid}{ext}"


def has_success_marker(path: str) -> bool:
    return os.path.exists(os.path.join(path, SUCCESS_FILE))


def write_success_marker(path: str) -> None:
    with open(os.path.join(path, SUCCESS_FILE), "wb"):
        pass
