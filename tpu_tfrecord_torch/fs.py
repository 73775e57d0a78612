"""The filesystem layer, local part.

Cut of ``tpu_tfrecord/fs.py`` to plain paths: ``has_scheme``,
``local_open`` (the one raw-open seam of the record read and write paths),
``LocalFS`` (the standard library behind the writer's commit and the
reader's discovery), ``filesystem_for`` and ``seek_to`` (positions the
stall guard's hedge handle). A path with a URL scheme
(``gs://``, ``s3://``, ``http://``, ``memory://``, ...) raises: the
fsspec and HTTP filesystems, the block prefetcher and the retrying read
stream are not ported yet.

Local ``rename`` is atomic (``os.replace``): it is the writer's commit
primitive.
"""

from __future__ import annotations

import glob as _glob
import os
import re
import shutil
from typing import BinaryIO, List

_SCHEME_RE = re.compile(r"^[a-zA-Z][a-zA-Z0-9+.\-]*://")


def has_scheme(path: str) -> bool:
    return bool(_SCHEME_RE.match(str(path)))


def local_open(path: str, mode: str) -> BinaryIO:
    """The raw open of a plain path on the record read and write paths
    (``wire.open_compressed`` routes through this)."""
    return open(path, mode)  # noqa: SIM115


def seek_to(fh, pos: int) -> None:
    """Position a fresh handle at byte ``pos``: seek where the handle can,
    read and discard otherwise."""
    if pos <= 0:
        return
    seek = getattr(fh, "seek", None)
    if seek is not None:
        try:
            seek(pos)
            return
        except (OSError, ValueError):
            pass
    left = pos
    while left > 0:
        chunk = fh.read(min(left, 8 << 20))
        if not chunk:
            return
        left -= len(chunk)


class LocalFS:
    """Standard-library filesystem: the one for plain paths."""

    def normalize(self, path: str) -> str:
        return path

    def open(self, path: str, mode: str) -> BinaryIO:
        return open(path, mode)  # noqa: SIM115

    def exists(self, path: str) -> bool:
        return os.path.exists(path)

    def isfile(self, path: str) -> bool:
        return os.path.isfile(path)

    def isdir(self, path: str) -> bool:
        return os.path.isdir(path)

    def listdir(self, path: str) -> List[str]:
        return os.listdir(path)

    def makedirs(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)

    def remove(self, path: str) -> None:
        os.remove(path)

    def rmtree(self, path: str, ignore_errors: bool = False) -> None:
        shutil.rmtree(path, ignore_errors=ignore_errors)

    def rmdir(self, path: str) -> None:
        os.rmdir(path)

    def rename(self, src: str, dst: str) -> None:
        os.replace(src, dst)

    def size(self, path: str) -> int:
        return os.path.getsize(path)

    def glob(self, pattern: str) -> List[str]:
        return sorted(_glob.glob(pattern))

    def walk_files(self, root: str, keep):
        """Sorted walk yielding (path, size) of the files under ``root``:
        descends only into directories ``keep`` accepts and yields only
        files it accepts, the files of a directory before its
        subdirectories. Sizes come from the directory listing. Directory
        symlinks are not followed: a link cycle must not hang discovery,
        and a link into the same tree must not count its shards twice."""
        stack = [root]
        while stack:
            dirpath = stack.pop()
            files, dirs = [], []
            with os.scandir(dirpath) as entries:
                for e in entries:
                    if not keep(e.name):
                        continue
                    if e.is_dir(follow_symlinks=False):
                        dirs.append(e.path)
                    elif not e.is_dir(follow_symlinks=True):
                        files.append((e.path, e.stat().st_size))
            yield from sorted(files)
            stack.extend(sorted(dirs, reverse=True))  # pop() visits in order

    def touch(self, path: str) -> None:
        with open(path, "wb"):
            pass


_LOCAL = LocalFS()


def filesystem_for(path: str) -> LocalFS:
    """The filesystem of a path: ``LocalFS`` for a plain path. A URL
    raises: remote filesystems are not ported yet."""
    spath = os.fspath(path)
    if has_scheme(spath):
        scheme = spath.split("://", 1)[0].lower()
        raise NotImplementedError(
            f"path {spath!r}: the {scheme}:// filesystem is not ported yet; "
            "the port reads and writes local paths only"
        )
    return _LOCAL
