"""The filesystem layer.

The reference reads and writes through Hadoop's ``FileSystem``: any scheme
(HDFS, GCS, S3) through ``CodecStreams.createOutputStream``
(TFRecordOutputWriter.scala:19) and the Hadoop input format
(TFRecordFileReader.scala:24-32). Copy of ``tpu_tfrecord/fs.py``: plain
paths use the standard library (``LocalFS``, and ``local_open``, the one
raw-open seam of the record read and write paths); ``http://`` and
``https://`` go to the stdlib client ``httpfs.HttpFS``; every other
scheme (``gs://``, ``s3://``, ``memory://``, ...) goes through fsspec
(``FsspecFS``), imported only when such a path is opened, so the package
imports without it.

Remote reads stream through ``open_for_read``: a ``PrefetchReader``
(``TFR_REMOTE_PREFETCH_DEPTH`` block fetches of ``TFR_REMOTE_BLOCK_BYTES``
in flight, concurrent only where ``independent_read_handles`` says the
backend hands out independent handles) for an object of at least two
blocks, else a ``RetryingReadStream``; with a retry policy, both resume a
failed fetch at the exact byte it reached (``read.retries``,
``remote.fetch_retries``), and honour a server's ``Retry-After`` up to
``_RETRY_AFTER_CAP_S`` and the policy's deadline.

Semantics notes:
- ``rename`` is the commit primitive. Local rename is atomic; object stores
  have no rename, so fsspec's ``mv`` is copy+delete there — the commit is
  then idempotent-but-not-atomic (the same tradeoff Hadoop's
  FileOutputCommitter v2 makes on object stores).
- Paths returned by listing/glob/walk keep their scheme prefix, so every
  downstream consumer (codec detection, shard bookkeeping) works on full
  URLs unchanged. URL path arithmetic uses '/', which equals ``os.sep``
  everywhere this runs.
"""

from __future__ import annotations

import glob as _glob
import io
import os
import re
import shutil
from time import monotonic as _time_monotonic
from typing import BinaryIO, List, Optional

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


class FsspecFS:
    """fsspec-backed filesystem for scheme'd URLs. All returned paths carry
    the scheme prefix (``fs.unstrip_protocol``)."""

    def __init__(self, url: str):
        import fsspec

        self._fs, _ = fsspec.core.url_to_fs(url)

    def _strip(self, path: str) -> str:
        return self._fs._strip_protocol(path)

    def _unstrip(self, path: str) -> str:
        return self._fs.unstrip_protocol(path)

    def normalize(self, path: str) -> str:
        """Canonical URL form — listing/walk results are unstripped, so
        callers comparing against an input root must normalize it the same
        way (e.g. ``memory:///x`` vs ``memory://x``)."""
        return self._unstrip(self._strip(path))

    def open(self, path: str, mode: str) -> BinaryIO:
        return self._fs.open(self._strip(path), mode)

    def exists(self, path: str) -> bool:
        return self._fs.exists(self._strip(path))

    def isfile(self, path: str) -> bool:
        return self._fs.isfile(self._strip(path))

    def isdir(self, path: str) -> bool:
        return self._fs.isdir(self._strip(path))

    def listdir(self, path: str) -> List[str]:
        base = self._strip(path)
        return sorted(
            p.rstrip("/").rsplit("/", 1)[-1]
            for p in self._fs.ls(base, detail=False)
            if p.rstrip("/") != base.rstrip("/")
        )

    def makedirs(self, path: str) -> None:
        self._fs.makedirs(self._strip(path), exist_ok=True)

    def remove(self, path: str) -> None:
        self._fs.rm_file(self._strip(path))

    def rmtree(self, path: str, ignore_errors: bool = False) -> None:
        try:
            self._fs.rm(self._strip(path), recursive=True)
        except Exception:
            if not ignore_errors:
                raise

    def rmdir(self, path: str) -> None:
        # Object stores have no real directories; an "empty dir" marker may
        # not even exist. Only remove when actually empty, like os.rmdir.
        sp = self._strip(path)
        if self._fs.exists(sp):
            if self._fs.ls(sp, detail=False):
                raise OSError(f"Directory not empty: {path}")
            self._fs.rmdir(sp)

    def rename(self, src: str, dst: str) -> None:
        # copy+delete on stores without native rename (see module docstring)
        self._fs.mv(self._strip(src), self._strip(dst))

    def size(self, path: str) -> int:
        return self._fs.size(self._strip(path))

    def info(self, path: str) -> dict:
        """Backend metadata dict (size plus whatever freshness stamp the
        store exposes — mtime / LastModified / ETag); the epoch cache keys
        remote-source invalidation on it (``cache.source_stat``)."""
        return self._fs.info(self._strip(path))

    def glob(self, pattern: str) -> List[str]:
        return sorted(
            self._unstrip(p) for p in self._fs.glob(self._strip(pattern))
        )

    def walk_files(self, root: str, keep):
        """(path, size) pairs via an explicit SORTED stack walk over
        ``ls(detail=True)`` — one list call per directory, not one HEAD per
        shard, and deterministic recursion order: fsspec's own walk recurses
        in ls/dict order, which differs between hosts/backends and would
        silently skew the global shard order every host must agree on.
        Listing failures raise (a dropped subtree must never look like a
        smaller dataset)."""
        stack = [self._strip(root)]
        while stack:
            dirpath = stack.pop()
            files, dirs = [], []
            for info in self._fs.ls(dirpath, detail=True):
                name = info["name"].rstrip("/")
                if name == dirpath.rstrip("/"):
                    continue  # some backends include the dir itself
                if not keep(name.rsplit("/", 1)[-1]):
                    continue
                if info.get("type") == "directory":
                    dirs.append(name)
                else:
                    files.append((name, int(info.get("size") or 0)))
            for fpath, size in sorted(files):
                yield self._unstrip(fpath), size
            stack.extend(sorted(dirs, reverse=True))  # pop() visits in order

    def touch(self, path: str) -> None:
        self._fs.touch(self._strip(path))


class PrefetchReader(io.RawIOBase):
    """Sequential-read pipeline over a remote object: ``depth`` block
    fetches in flight at once, each on its OWN reader handle (parallel
    HTTP range GETs; the Hadoop FS connectors' readahead the reference
    streams HDFS/GCS/S3 through, TFRecordFileReader.scala:24-32). A serial
    ``fh.read`` loop pays one link round trip a block; pipelining hides
    that latency behind the consumer's decode.

    Contract: forward sequential reads only (exactly what the slab
    streamer issues). With a ``retry_policy``, block fetches SELF-HEAL: a
    transient fetch error (reset, truncated body, 503 — anything OSError)
    is retried on a FRESH handle resuming from the exact byte offset the
    last attempt reached (``read.retries``/``remote.fetch_retries``), and
    a server's Retry-After hint is honored through the policy's sleep
    seam. Errors that outlive the budget surface on the consumer's next
    read; the shard-level retry machinery reopens the stream. A short
    block mid-object (clean EOF) yields a short read, which the framing
    layer reports as truncation."""

    def __init__(
        self,
        fs,
        path: str,
        size: int,
        block_bytes: int,
        depth: int,
        serialize_fetches: bool = False,
        retry_policy=None,
    ):
        super().__init__()
        import threading
        from concurrent.futures import ThreadPoolExecutor

        self._fs = fs
        self._path = path
        self._size = size
        self._block = max(64 << 10, int(block_bytes))
        depth = max(1, int(depth))
        self._nblocks = (size + self._block - 1) // self._block
        self._pool = ThreadPoolExecutor(
            max_workers=depth, thread_name_prefix="tfr-prefetch"
        )
        self._depth = depth
        self._retry_policy = retry_policy
        # fsspec's memory backend hands every open() the SAME file object
        # (shared seek cursor) — fetches there must serialize to stay
        # correct; real object-store backends give independent handles and
        # fetch fully in parallel.
        self._fetch_lock = threading.Lock() if serialize_fetches else None
        self._futs = {}
        self._next = 0
        self._pos = 0
        self._cur = b""
        self._cur_idx = -1
        self._schedule()

    def _fetch(self, idx: int) -> bytes:
        start = idx * self._block
        n = min(self._block, self._size - start)
        if self._fetch_lock is not None:
            with self._fetch_lock:
                return self._fetch_retrying(start, n)
        return self._fetch_retrying(start, n)

    def _fetch_retrying(self, start: int, n: int) -> bytes:
        """One block fetch under the retry policy: each attempt resumes
        from the EXACT byte offset the previous one reached (a fresh
        handle re-ranges at start+got — no byte is refetched, none is
        skipped). Without a policy: one attempt, the historical
        behavior."""
        pol = self._retry_policy
        if pol is None:
            return self._fetch_one(start, n)
        parts: list = []
        attempt = 0
        t0 = pol.clock()
        while True:
            try:
                self._fetch_into(start + sum(map(len, parts)),
                                 n - sum(map(len, parts)), parts)
                return b"".join(parts)
            except OSError as e:
                attempt += 1
                if not _grant_retry(pol, attempt, t0, e):
                    raise

    def _fetch_one(self, start: int, n: int) -> bytes:
        parts: list = []
        self._fetch_into(start, n, parts)
        return b"".join(parts)

    def _fetch_into(self, start: int, n: int, parts: list) -> None:
        """Read [start, start+n) into ``parts`` chunk by chunk; on an
        error the chunks already read stay in ``parts``, so the retry
        resumes from the exact byte the connection died at instead of
        refetching the block."""
        with self._fs.open(self._path, "rb") as fh:
            fh.seek(start)
            got = 0
            while got < n:
                chunk = fh.read(n - got)
                if not chunk:
                    return  # short object: surfaces as a short read
                parts.append(chunk)
                got += len(chunk)

    def _schedule(self) -> None:
        while self._next < self._nblocks and len(self._futs) < self._depth:
            self._futs[self._next] = self._pool.submit(self._fetch, self._next)
            self._next += 1

    def _block_data(self, idx: int) -> bytes:
        if idx != self._cur_idx:
            fut = self._futs.pop(idx, None)
            if fut is None:  # out-of-order use: fetch inline (correct, slow)
                fut = self._pool.submit(self._fetch, idx)
            self._cur = fut.result()
            self._cur_idx = idx
            self._schedule()
        return self._cur

    def readable(self) -> bool:
        return True

    def readinto(self, b) -> int:
        mv = memoryview(b)
        want = len(mv)
        done = 0
        while done < want and self._pos < self._size:
            idx = self._pos // self._block
            off = self._pos - idx * self._block
            blk = self._block_data(idx)
            if off >= len(blk):
                break  # short block: truncated object
            take = min(want - done, len(blk) - off)
            mv[done : done + take] = blk[off : off + take]
            done += take
            self._pos += take
        return done

    def tell(self) -> int:
        return self._pos

    _CLOSE_TIMEOUT_S = 10.0

    def close(self) -> None:
        """Bounded-wait close: cancel queued fetches, then
        WAIT for in-flight fetch threads — an in-flight fetch holds a live
        backend handle, and letting it outlive close() races tempdir
        cleanup and backends that assume no reads after close. The wait is
        bounded (TFR_REMOTE_CLOSE_TIMEOUT_S): a fetch wedged in a dead
        socket must not wedge close() too — that one thread is abandoned
        exactly like a stall-guard worker, and its handle closes when the
        blocked call finally returns (the with-block in _fetch_into)."""
        if not self.closed:
            futs = list(self._futs.values())
            self._futs.clear()
            for fut in futs:
                fut.cancel()
            self._pool.shutdown(wait=False, cancel_futures=True)
            timeout = float(
                os.environ.get("TFR_REMOTE_CLOSE_TIMEOUT_S", self._CLOSE_TIMEOUT_S)
            )
            deadline = _time_monotonic() + timeout
            for t in list(getattr(self._pool, "_threads", ()) or ()):
                t.join(max(0.0, deadline - _time_monotonic()))
        super().close()


#: sanity ceiling on honoring a server's Retry-After: a hostile or buggy
#: server must not be able to park a reader for an hour with one header.
_RETRY_AFTER_CAP_S = 30.0


def _grant_retry(pol, attempt: int, t0: float, exc: BaseException) -> bool:
    """ONE owner for the remote-fetch retry grant (shared by the block
    prefetcher and the plain self-healing stream): consult the policy's
    budget, and only for a GRANTED retry honor the server's Retry-After
    pacing hint (through the injectable sleep seam) and bump the
    counters. False = budget exhausted, caller re-raises.

    The hint is BOUNDED like the policy's own backoff: capped at
    ``_RETRY_AFTER_CAP_S`` and never past the policy's remaining
    wall-clock deadline — ``pause`` promises not to sleep past the
    deadline, and the hint must not smuggle that promise away."""
    if not pol.pause(attempt, t0):
        return False
    retry_after = getattr(exc, "retry_after", None)
    if retry_after:
        delay = min(float(retry_after), _RETRY_AFTER_CAP_S)
        if pol.deadline is not None:
            delay = min(delay, max(0.0, pol.deadline - (pol.clock() - t0)))
        if delay > 0:
            pol.sleep(delay)
    from tpu_tfrecord_torch.metrics import METRICS

    METRICS.count("read.retries")
    METRICS.count("remote.fetch_retries")
    return True


class RetryingReadStream:
    """Self-healing wrapper for a PLAIN (non-prefetched) remote read
    handle: objects below the PrefetchReader engagement bar get the SAME
    contract — a transient read fault reopens a fresh handle positioned
    at the exact byte offset already consumed and resumes
    (``read.retries``/``remote.fetch_retries``, Retry-After honored).
    Forward sequential reads; seek supported (resets position)."""

    def __init__(self, fs, path: str, retry_policy, fh=None):
        self._fs = fs
        self._path = path
        self._pol = retry_policy
        self._fh = fh if fh is not None else fs.open(path, "rb")
        self._pos = 0
        self._closed = False

    def _drop_fh(self) -> None:
        fh, self._fh = self._fh, None
        if fh is not None:
            try:
                fh.close()
            except Exception:  # an already-broken handle, dropped before the reopen
                pass

    _CHUNK = 8 << 20

    def read(self, size: int = -1) -> bytes:
        if size is None or size < 0:
            # chunk the read-to-EOF HERE: delegating it to the inner
            # handle would lose its partial progress on a fault and
            # restart from byte 0 instead of the exact consumed offset
            parts = []
            while True:
                chunk = self.read(self._CHUNK)
                if not chunk:
                    return b"".join(parts)
                parts.append(chunk)
        pol = self._pol
        attempt = 0
        t0 = pol.clock()
        while True:
            try:
                # the reopen runs INSIDE the retried block: a transient
                # open-time fault spends the same budget as a read fault
                # instead of escaping it
                if self._fh is None:
                    fh = self._fs.open(self._path, "rb")
                    seek_to(fh, self._pos)
                    self._fh = fh
                data = self._fh.read(size)
                self._pos += len(data)
                return data
            except OSError as e:
                self._drop_fh()
                attempt += 1
                if not _grant_retry(pol, attempt, t0, e):
                    raise

    def readinto(self, b) -> int:
        data = self.read(len(b))
        b[: len(data)] = data
        return len(data)

    def seek(self, pos: int, whence: int = 0) -> int:
        if whence == 1:
            # SEEK_CUR needs no handle — the stream owns its position
            return self.seek(self._pos + pos)
        if whence == 2:
            if self._fh is None:
                self._fh = self._fs.open(self._path, "rb")
            pos = self._fh.seek(pos, 2)
            self._pos = pos
            return pos
        if whence != 0:
            raise ValueError(f"unsupported whence {whence}")
        if self._fh is not None:
            try:
                self._fh.seek(pos)
            except OSError:
                # a dead handle repositions lazily: the next read reopens
                # at the requested offset under the retry budget
                self._drop_fh()
        self._pos = pos
        return pos

    def tell(self) -> int:
        return self._pos

    def readable(self) -> bool:
        return True

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self._drop_fh()

    @property
    def closed(self) -> bool:
        return self._closed

    def __enter__(self) -> "RetryingReadStream":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _remote_prefetch_params() -> tuple:
    """(block_bytes, depth); env-tunable, read per open so tests can vary."""
    block = int(os.environ.get("TFR_REMOTE_BLOCK_BYTES", 8 << 20))
    depth = int(os.environ.get("TFR_REMOTE_PREFETCH_DEPTH", 4))
    return block, depth


#: fsspec protocols whose ``open()`` is known to hand out an INDEPENDENT
#: file object per call (its own cursor), so PrefetchReader may run its
#: block fetches concurrently. Everything else — including ``memory://``
#: (one shared file object per path) and any scheme not listed here —
#: serializes: on an unknown backend, concurrent seek+read on a possibly
#: shared handle would silently return corrupted blocks, while needless
#: serialization merely costs parallelism.
_INDEPENDENT_HANDLE_PROTOCOLS = frozenset(
    {
        "file", "local",
        "s3", "s3a",
        "gs", "gcs",
        "az", "abfs", "abfss", "adl",
        "http", "https",
        "hdfs", "webhdfs",
        "oss",
    }
)
# NOT listed (deliberately): ftp funnels every file object through ONE
# shared ftplib control connection, and sftp/ssh multiplex one paramiko
# channel — concurrent range fetches there interleave protocol traffic on
# a shared session, which is exactly the corruption mode this flag
# exists to rule out. They serialize like any unknown scheme.


def independent_read_handles(fs) -> bool:
    """Explicit capability flag: may PrefetchReader fetch blocks of one
    object CONCURRENTLY through ``fs.open()``?

    Resolution order, walking the ``_fs`` wrapper chain (FsspecFS wraps
    the fsspec filesystem; ChaosFS and test shims wrap either):

    1. an ``independent_read_handles`` attribute anywhere on the chain —
       the capability declaration; wrappers that change handle semantics
       (or backends fsspec cannot classify) set it explicitly;
    2. a declared fsspec ``protocol``, classified against the known
       independent-handle allowlist above;
    3. neither found, or an unknown protocol: **False** — serialize.
       Unknown backends default to the SAFE path: slower, never corrupt.
    """
    obj = fs
    for _ in range(8):
        if obj is None:
            return False
        cap = getattr(obj, "independent_read_handles", None)
        if cap is not None and not callable(cap):
            return bool(cap)
        proto = getattr(obj, "__dict__", {}).get("protocol", None) or getattr(
            type(obj), "protocol", None
        )
        if proto is not None:
            protos = (
                tuple(proto) if isinstance(proto, (list, tuple)) else (str(proto),)
            )
            return all(p in _INDEPENDENT_HANDLE_PROTOCOLS for p in protos)
        obj = getattr(obj, "_fs", None)
    return False


def open_for_read(fs, path: str, retry_policy=None) -> BinaryIO:
    """Open a scheme'd path for streaming read: block-pipelined
    PrefetchReader for objects big enough to benefit, the plain handle
    otherwise (or when size probing / prefetch setup is impossible).
    TFR_REMOTE_PREFETCH_DEPTH=0 disables pipelining. ``retry_policy``
    makes the prefetcher's block fetches self-heal (resume from the exact
    byte offset on transient faults); None = TFR_REMOTE_FETCH_RETRIES
    retries (default 0, the fail-fast historical behavior)."""
    block, depth = _remote_prefetch_params()
    if retry_policy is None:
        retry_policy = _default_fetch_retry_policy()
    size: Optional[int] = None
    if depth > 0:
        try:
            size = fs.size(path)
        except Exception:  # no size: a plain stream, no prefetch
            size = None
    if size is not None and size >= 2 * block:
        return PrefetchReader(
            fs, path, size, block, depth,
            serialize_fetches=not independent_read_handles(fs),
            retry_policy=retry_policy,
        )
    if retry_policy is not None:
        # below the prefetch bar the SAME self-healing contract applies:
        # a plain handle whose reads reopen + resume at the exact offset
        return RetryingReadStream(fs, path, retry_policy)
    return fs.open(path, "rb")


def _default_fetch_retry_policy():
    """Block-fetch retry budget when the caller supplied no policy
    (row-level readers, tools): TFR_REMOTE_FETCH_RETRIES (default 0 —
    one attempt, exactly the historical behavior)."""
    retries = int(os.environ.get("TFR_REMOTE_FETCH_RETRIES", 0))
    if retries <= 0:
        return None
    from tpu_tfrecord_torch.retry import RetryPolicy

    return RetryPolicy(max_retries=retries)


_LOCAL = LocalFS()


def filesystem_for(path: str):
    """The filesystem of a path: the stdlib HTTP client for ``http://`` /
    ``https://`` (``httpfs.HttpFS``: Range requests, ``Content-Range``
    checked, no fsspec needed), fsspec for every other URL, the standard
    library for a plain path. A URL of another scheme without fsspec
    installed raises ImportError."""
    spath = os.fspath(path)
    if has_scheme(spath):
        scheme = spath.split("://", 1)[0].lower()
        if scheme in ("http", "https"):
            from tpu_tfrecord_torch.httpfs import HttpFS

            return HttpFS(spath)
        try:
            import fsspec  # noqa: F401
        except ImportError as e:
            raise ImportError(
                f"path {path!r} has a URL scheme, which requires the optional "
                "fsspec dependency (pip install fsspec)"
            ) from e
        # other ImportErrors (a missing s3fs / gcsfs protocol package)
        # propagate with fsspec's own message
        return FsspecFS(spath)
    return _LOCAL
