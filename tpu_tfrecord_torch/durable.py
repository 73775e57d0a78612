"""Durable file writes: a whole file through a fsynced, renamed tmp twin
(``durable_write``) and an fsynced append that refuses a replaced file
(``durable_append`` / ``FencedWriteError``), with the crash-matrix kill
seam of the checkpoint (``TFR_CKPT_CHAOS_*``, the JAX package's).

The JAX package keeps these in ``tpu_tfrecord/checkpoint.py``; here they
sit in a module of their own, with no torch import, so that the data
service's dispatcher (``service.py``, which journals through them) starts
without loading torch. ``checkpoint`` re-exports every name.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Optional

#: Kill-point seam for the crash-matrix tests: when TFR_CKPT_CHAOS_STAGE
#: names the stage a writer is about to enter, the writer touches
#: TFR_CKPT_CHAOS_MARK and parks, so the test lands its SIGKILL exactly
#: there (snapshot / shard / pre_manifest / manifest / state);
#: TFR_CKPT_CHAOS_SKIP passes the stage that many times first.
_CHAOS_STAGE_ENV = "TFR_CKPT_CHAOS_STAGE"
_CHAOS_MARK_ENV = "TFR_CKPT_CHAOS_MARK"
_CHAOS_SKIP_ENV = "TFR_CKPT_CHAOS_SKIP"
_chaos_hits: dict = {}


def _chaos_point(stage: str) -> None:
    if os.environ.get(_CHAOS_STAGE_ENV) != stage:
        return
    _chaos_hits[stage] = _chaos_hits.get(stage, 0) + 1
    if _chaos_hits[stage] <= int(os.environ.get(_CHAOS_SKIP_ENV, "0")):
        return
    mark = os.environ.get(_CHAOS_MARK_ENV)
    if mark:
        tmp = f"{mark}.tmp.{os.getpid()}"
        with open(tmp, "w") as fh:
            fh.write(stage)
        os.replace(tmp, mark)
    while True:  # park here until the test's SIGKILL lands
        time.sleep(60)


def _fsync_dir(directory: str) -> None:
    """Best-effort fsync of a directory, so a rename in it is durable."""
    try:
        fd = os.open(directory, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
    except OSError:  # some filesystems refuse directory fds
        pass


def durable_write(
    path: str,
    data: Optional[bytes] = None,
    write_fn: Optional[Callable] = None,
    chaos: Optional[str] = None,
) -> None:
    """Write ``data`` (or let ``write_fn(fh)`` write) to a pid-suffixed
    tmp twin, flush and fsync it, ``os.replace`` it into place, then fsync
    the directory: a crash leaves the old complete file or the new one."""
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as fh:
            if write_fn is not None:
                write_fn(fh)
            if data is not None:
                fh.write(data)
            fh.flush()
            os.fsync(fh.fileno())
        if chaos is not None:
            _chaos_point(chaos)
        os.replace(tmp, path)
        _fsync_dir(os.path.dirname(os.path.abspath(path)))
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise


class FencedWriteError(OSError):
    """A ``durable_append`` found the file replaced underneath it (its
    inode changed); the append was not made."""


def durable_append(path: str, data: bytes, expect_ino: Optional[int] = None) -> int:
    """Append one record durably (append, flush, fsync); returns the
    file's inode. With ``expect_ino``, a file whose inode differs raises
    ``FencedWriteError`` before any byte lands."""
    with open(path, "ab") as fh:
        st = os.fstat(fh.fileno())
        if expect_ino is not None and st.st_ino != expect_ino:
            raise FencedWriteError(
                f"{path} was replaced underneath this writer "
                f"(inode {st.st_ino} != expected {expect_ino})"
            )
        fh.write(data)
        fh.flush()
        os.fsync(fh.fileno())
        return st.st_ino
