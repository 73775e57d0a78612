"""Columnar epoch cache: decode a shard once, mmap every epoch after.

Port of ``tpu_tfrecord/cache.py``. The cache directory is local (a URL
there raises); a source shard may be a URL, so a remote shard's link is
paid once and later epochs read the local entry. A decoded
``ColumnarBatch`` (dense values, offsets, blob buffers) is already a flat
layout, so a cached epoch is served as numpy views over one mmap of the
entry file: no frame parsing, no record CRC, no protobuf decode.

The container (one entry file per (shard, decode fingerprint)), the JAX
one byte for byte, so either package serves the other's entries:

    [MAGIC "TFRCACH1"][u32 container version]
    section payloads, 8-byte aligned, appended chunk by chunk
    [footer JSON][u64 footer length][u32 crc32c(footer)][TAIL "TFRCEND1"]

The footer holds the decode fingerprint, the source shard's identity
(path, size, mtime_ns), the decode ident and a per-chunk table: each
chunk's first record and row count, its columns in order, and for each
column the sections it populates (values / offsets / inner_offsets / blob
/ blob_offsets / mask) with dtype, shape, offset, length and CRC32C. The
footer is written last and the file renamed into place, so a partial entry
is never visible under its name. Staging lives under ``_temporary/<job>/``
with the writer's ``_JOB_META`` marker, and each commit sweeps staging
orphaned by crashed populates with the writer's ``sweep_orphan_jobs``.

An entry is verified in full once a process (header, footer CRC,
fingerprint, source identity, every section CRC, the section geometry);
later opens in the process find it in the entry registry. Any failure
falls back to the TFRecord decode of that shard, which rewrites the entry:
never a crash, never wrong rows. ``cache_max_bytes`` bounds the directory
with an LRU sweep by atime (a hit re-stamps atime and keeps mtime, which
is part of the registry's key).

Entry opens go through ``fs.local_open`` and the commit's rename through
``fs.filesystem_for(...).rename``, both resolved at call time, so
``faults.install_chaos`` reaches the cache as it reaches the reads.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import mmap
import os
import shutil
import struct
import tempfile
import threading
import time
import uuid
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np

from tpu_tfrecord_torch import _native, fs as _fs, telemetry, wire
from tpu_tfrecord_torch.columnar import Column, ColumnarBatch
from tpu_tfrecord_torch.io import paths as p
from tpu_tfrecord_torch.metrics import METRICS, logger, timed

MAGIC = b"TFRCACH1"
TAIL_MAGIC = b"TFRCEND1"
#: Container version: part of the header check and of the decode
#: fingerprint, so a bump misses every existing entry.
VERSION = 1
ENTRY_SUFFIX = ".tfrc"

_HEADER = struct.Struct("<8sI")  # magic + container version
_TAIL = struct.Struct("<QI8s")  # footer length + footer crc + tail magic
_ALIGN = 8


class CacheOpenError(Exception):
    """An entry cannot be served. ``kind``: ``absent`` (no entry file, or
    unreadable: a plain miss), ``stale`` (fingerprint, container version
    or source identity changed) or ``corrupt`` (bad magic, a CRC mismatch,
    metadata that does not parse or does not fit the file)."""

    def __init__(self, kind: str, msg: str):
        super().__init__(msg)
        self.kind = kind


def default_cache_dir() -> str:
    """The per-user default of ``cache="auto"`` without ``cache_dir``: the
    uid suffix keeps another user from pre-staging entries under names
    this user's reads would open."""
    uid = os.getuid() if hasattr(os, "getuid") else 0
    return os.path.join(tempfile.gettempdir(), f"tpu_tfrecord_cache-{uid}")


def _norm_path(path: str) -> str:
    return path if _fs.has_scheme(path) else os.path.abspath(path)


def decode_fingerprint(ident: Dict[str, Any]) -> str:
    """Digest of what decides a decoded chunk's content (the dataset's
    ``_cache_ident``: data schema, record type, hash buckets, packs and
    their fusion, CRC verification, the record-size cap, partition fields)
    plus the container version. Options that only change how chunks are
    produced (batch size, workers, prefetch, mmap, readahead, retries,
    deadlines) are left out: changing them still hits."""
    ident = dict(ident, container_version=VERSION)
    blob = json.dumps(ident, sort_keys=True, default=str).encode("utf-8")
    return hashlib.sha256(blob).hexdigest()[:16]


def entry_filename(shard_path: str, fingerprint: str) -> str:
    """``<sha(source path)>-<fingerprint>.tfrc``: other decode options make
    new entries (the old ones age out by LRU); a changed shard overwrites
    its own entry on repopulate."""
    key = hashlib.sha256(_norm_path(shard_path).encode("utf-8")).hexdigest()[:20]
    return f"{key}-{fingerprint}{ENTRY_SUFFIX}"


def source_stat(shard_path: str, size_hint: Optional[int] = None) -> Dict[str, Any]:
    """The source identity an entry is keyed on: (path, size, mtime_ns).
    A local shard's come from ``os.stat``; a URL's from its filesystem's
    ``info`` (size, and the first of mtime / LastModified / last_modified
    / created / ETag as the stamp, an opaque tag hashed into it), so a
    remote rewrite of the same size still invalidates. A store that gives
    no stamp, or cannot be asked, leaves it 0: size-only invalidation."""
    if _fs.has_scheme(shard_path):
        size = int(size_hint) if size_hint else 0
        stamp = 0
        try:
            info = _fs.filesystem_for(shard_path).info(shard_path)
            if not size:
                size = int(info.get("size") or 0)
            raw = (info.get("mtime") or info.get("LastModified") or info.get("last_modified")
                   or info.get("created") or info.get("ETag") or info.get("etag") or 0)
            if hasattr(raw, "timestamp"):  # datetime
                raw = raw.timestamp()
            if isinstance(raw, (int, float)):
                stamp = int(raw * 1e9) if raw else 0
            elif raw:  # an opaque version tag (ETag)
                stamp = int(hashlib.sha256(str(raw).encode()).hexdigest()[:15], 16)
        except (AttributeError, OSError, KeyError, TypeError, ValueError):
            pass
        return {"path": shard_path, "size": size, "mtime_ns": stamp}
    st = os.stat(shard_path)
    return {"path": _norm_path(shard_path), "size": int(st.st_size),
            "mtime_ns": int(st.st_mtime_ns)}


# ---------------------------------------------------------------------------
# Container codec
# ---------------------------------------------------------------------------


def section_crc(arr: np.ndarray) -> int:
    """CRC32C over a contiguous array's buffer, read in place by the
    native library (no ``tobytes`` copy of a multi-MB section)."""
    return int(_native.load().tfr_crc32c(arr.ctypes.data_as(ctypes.c_char_p), arr.nbytes))


def column_buffers(col: Column) -> List[Tuple[str, np.ndarray]]:
    """The (role, contiguous array) sections a column populates, in the
    fixed role order the footer records."""
    out: List[Tuple[str, np.ndarray]] = []
    if col.values is not None:
        out.append(("values", np.ascontiguousarray(col.values)))
    if col.offsets is not None:
        out.append(("offsets", np.ascontiguousarray(col.offsets)))
    if col.inner_offsets is not None:
        out.append(("inner_offsets", np.ascontiguousarray(col.inner_offsets)))
    if col.blob is not None:
        out.append(("blob", np.frombuffer(col.blob, dtype=np.uint8)))
    if col.blob_offsets is not None:
        out.append(("blob_offsets", np.ascontiguousarray(col.blob_offsets)))
    if col.mask is not None:
        out.append(("mask", np.ascontiguousarray(col.mask)))
    return out


class CachedShard:
    """One validated, mmapped entry: ``chunk_batch`` rebuilds its chunks
    as numpy views over the map (a blob is copied out as ``bytes``, which
    the native calls downstream take). The views are read-only, and each
    keeps the map alive through its base; removing or replacing the entry
    file leaves an open map valid (POSIX inode semantics)."""

    def __init__(self, path: str, footer: Dict[str, Any], mm: mmap.mmap):
        self.path = path
        self.footer = footer
        self._mm = mm
        self._arr = np.frombuffer(mm, dtype=np.uint8)
        self.chunks: List[Dict[str, Any]] = footer["chunks"]
        self.rows = int(footer.get("rows", 0))

    @property
    def num_chunks(self) -> int:
        return len(self.chunks)

    def chunk_span(self, i: int) -> Tuple[int, int]:
        """(first record, rows) of chunk ``i``."""
        meta = self.chunks[i]
        return int(meta["start"]), int(meta["num_rows"])

    def _section_array(self, sec: Dict[str, Any]) -> np.ndarray:
        off, nb = int(sec["off"]), int(sec["nbytes"])
        arr = self._arr[off:off + nb].view(np.dtype(sec["dtype"]))
        shape = sec.get("shape")
        if shape is not None and len(shape) != 1:
            arr = arr.reshape(shape)
        return arr

    def chunk_batch(self, i: int, dtype_of: Callable[[str], Any]) -> ColumnarBatch:
        """Chunk ``i`` over the map; ``dtype_of(name)`` gives each column's
        schema DataType (the fingerprint guarantees it is the cached one)."""
        meta = self.chunks[i]
        cols: Dict[str, Column] = {}
        for cm in meta["columns"]:
            name = cm["name"]
            col = Column(name, dtype_of(name), hash_buckets=cm.get("hash_buckets"))
            for role, sec in cm["sections"]:
                if role == "blob":
                    off, nb = int(sec["off"]), int(sec["nbytes"])
                    col.blob = self._mm[off:off + nb]
                else:
                    setattr(col, role, self._section_array(sec))
            cols[name] = col
        return ColumnarBatch(cols, int(meta["num_rows"]))


def load_footer(path: str) -> Dict[str, Any]:
    """Read and CRC-check an entry's footer, without section verification.
    Raises ``CacheOpenError`` (``absent``, ``stale`` or ``corrupt``)."""
    try:
        fh = _fs.local_open(path, "rb")
    except FileNotFoundError as e:
        raise CacheOpenError("absent", str(e)) from e
    except OSError as e:
        raise CacheOpenError("absent", f"unreadable cache entry {path}: {e}") from e
    with fh:
        header = wire.read_exact(fh, _HEADER.size)
        if len(header) < _HEADER.size:
            raise CacheOpenError("corrupt", f"cache entry too short: {path}")
        magic, version = _HEADER.unpack(header)
        if magic != MAGIC:
            raise CacheOpenError("corrupt", f"bad cache magic in {path}")
        if version != VERSION:
            raise CacheOpenError("stale", f"cache container v{version} != v{VERSION} in {path}")
        fh.seek(0, os.SEEK_END)
        size = fh.tell()
        if size < _HEADER.size + _TAIL.size:
            raise CacheOpenError("corrupt", f"cache entry truncated: {path}")
        fh.seek(size - _TAIL.size)
        tail_bytes = wire.read_exact(fh, _TAIL.size)
        if len(tail_bytes) < _TAIL.size:  # the file shrank under us
            raise CacheOpenError("corrupt", f"cache entry truncated: {path}")
        flen, fcrc, tail = _TAIL.unpack(tail_bytes)
        if tail != TAIL_MAGIC or flen > size - _HEADER.size - _TAIL.size:
            raise CacheOpenError("corrupt", f"bad cache tail in {path} (truncated write?)")
        fh.seek(size - _TAIL.size - flen)
        blob = wire.read_exact(fh, flen)
        if len(blob) < flen or wire.crc32c(blob) != fcrc:
            raise CacheOpenError("corrupt", f"cache footer CRC mismatch in {path}")
        try:
            footer = json.loads(blob.decode("utf-8"))
        except ValueError as e:
            raise CacheOpenError("corrupt", f"unparseable cache footer in {path}: {e}") from e
    if footer.get("version") != VERSION:
        raise CacheOpenError("stale", f"cache footer version mismatch in {path}")
    return footer


def open_entry_file(
    path: str,
    expect_fingerprint: Optional[str] = None,
    source: Optional[Dict[str, Any]] = None,
    verify_sections: bool = True,
    expect_columns: Optional[set] = None,
) -> CachedShard:
    """Open and validate one entry: footer, fingerprint, source identity,
    by default every section's CRC and geometry, and with
    ``expect_columns`` that every chunk carries exactly those columns.
    Raises ``CacheOpenError``."""
    footer = load_footer(path)
    if expect_fingerprint is not None and footer.get("fingerprint") != expect_fingerprint:
        raise CacheOpenError(
            "stale", f"cache fingerprint {footer.get('fingerprint')} != "
                     f"{expect_fingerprint} in {path}")
    if source is not None and not _source_matches(footer, source):
        raise CacheOpenError("stale", f"source shard changed since {path} was written")
    try:
        fh = _fs.local_open(path, "rb")
    except OSError as e:
        raise CacheOpenError("absent", f"unreadable cache entry {path}: {e}") from e
    with fh:
        try:
            mm = mmap.mmap(fh.fileno(), 0, prot=mmap.PROT_READ)
        except (OSError, ValueError) as e:
            raise CacheOpenError("corrupt", f"cannot mmap {path}: {e}") from e
    try:
        return _verified_entry(path, footer, mm, verify_sections, expect_columns)
    except CacheOpenError:
        raise
    except Exception as e:  # noqa: BLE001
        # a footer that parsed and CRC-matched but has the wrong shape (a
        # foreign or faulty producer) is corrupt like any other
        raise CacheOpenError("corrupt", f"malformed cache footer structure in {path}: {e}") from e


def _check_section(path: str, role: str, sec: Dict[str, Any], roles: set, num_rows: int,
                   size: int) -> Tuple[int, int]:
    """Bounds, dtype, shape and row count of one section against the file
    and its chunk, so serving can never raise on it; returns (off, nbytes)."""
    off, nb = int(sec["off"]), int(sec["nbytes"])
    if off < 0 or nb < 0 or off + nb > size:
        raise CacheOpenError("corrupt", f"section out of bounds in {path}")
    try:
        dt = np.dtype(sec["dtype"])
    except TypeError as e:
        raise CacheOpenError("corrupt", f"bad section dtype in {path}: {e}") from e
    shape = sec.get("shape")
    n_items = 1
    for dim in shape if shape is not None else ():
        n_items *= int(dim)
    if nb % dt.itemsize or (shape is not None and n_items * dt.itemsize != nb):
        raise CacheOpenError(
            "corrupt", f"section shape/dtype inconsistent with its byte length in {path}")
    # per-row sections cover exactly num_rows rows (offsets carry the +1
    # fence): consumers index them by row without bounds checks
    n = nb // dt.itemsize
    first_dim = int(shape[0]) if shape else n
    bad_rows = ((role == "mask" and n != num_rows)
                or (role == "offsets" and n != num_rows + 1)
                or (role == "values" and "offsets" not in roles and first_dim != num_rows)
                or (role == "blob_offsets" and "offsets" not in roles and n != num_rows + 1))
    if bad_rows:
        raise CacheOpenError(
            "corrupt", f"section row count inconsistent with chunk num_rows in {path}")
    return off, nb


def _verified_entry(path: str, footer: Dict[str, Any], mm: mmap.mmap, verify_sections: bool,
                    expect_columns: Optional[set] = None) -> CachedShard:
    entry = CachedShard(path, footer, mm)
    if not verify_sections:
        return entry
    size = len(entry._arr)
    next_start = 0
    for meta in footer["chunks"]:
        start, num_rows = int(meta["start"]), int(meta["num_rows"])
        if start != next_start or num_rows < 0:
            # a populate writes one contiguous pass from record 0
            raise CacheOpenError("corrupt", f"non-contiguous chunk table in {path}")
        next_start = start + num_rows
        if expect_columns is not None:
            names = {str(cm["name"]) for cm in meta["columns"]}
            if names != expect_columns:
                raise CacheOpenError(
                    "corrupt", f"cached columns {sorted(names)} != expected "
                               f"{sorted(expect_columns)} in {path}")
        for cm in meta["columns"]:
            str(cm["name"])  # a serve-time lookup must not KeyError
            roles = {role for role, _sec in cm["sections"]}
            for role, sec in cm["sections"]:
                off, nb = _check_section(path, role, sec, roles, num_rows, size)
                if section_crc(entry._arr[off:off + nb]) != int(sec["crc"]):
                    raise CacheOpenError(
                        "corrupt", f"section CRC mismatch at offset {off} in {path}")
    return entry


class CachePopulator:
    """Streams one shard's decoded chunks into a staging entry and commits
    it atomically. An IO failure kills the populator (logged once, counted
    in ``cache.populate_errors``): writing the cache never fails an
    epoch."""

    def __init__(self, cache: "ShardCache", shard_path: str, source: Dict[str, Any]):
        self._cache = cache
        self._source = source
        self.source_path = shard_path
        self.final_path = os.path.join(cache.cache_dir,
                                       entry_filename(shard_path, cache.fingerprint))
        self._job_id = uuid.uuid4().hex[:12]
        self._tmp_dir = os.path.join(cache.cache_dir, p.TEMP_PREFIX, self._job_id)
        os.makedirs(self._tmp_dir, exist_ok=True)
        try:
            self._write_marker()
            self._tmp_path = os.path.join(self._tmp_dir, os.path.basename(self.final_path))
            self._fh = open(self._tmp_path, "wb")  # noqa: SIM115
            self._fh.write(_HEADER.pack(MAGIC, VERSION))
        except BaseException:
            # the marker names a live pid, so the orphan sweep would never
            # reclaim a staging dir a failed set-up left
            fh = getattr(self, "_fh", None)
            if fh is not None:
                try:
                    fh.close()
                except OSError:
                    pass
            shutil.rmtree(self._tmp_dir, ignore_errors=True)
            raise
        self._pos = _HEADER.size
        self._chunks: List[Dict[str, Any]] = []
        self._rows = 0
        self._dead = False

    def _write_marker(self) -> None:
        # the writer's liveness marker: sweep_orphan_jobs reclaims staging
        # of a crashed populate by the write jobs' dead-pid and lease tests
        from tpu_tfrecord_torch.io.writer import _JOB_MARKER, job_marker_payload

        try:
            with open(os.path.join(self._tmp_dir, _JOB_MARKER), "wb") as fh:
                fh.write(job_marker_payload())
        except OSError:
            pass

    def _kill(self, why: str) -> None:
        self._dead = True
        METRICS.count("cache.populate_errors")
        logger.warning("tfrecord.cache populate of %s disabled: %s", self.final_path, why)
        self.abort()

    def _put(self, arr: np.ndarray) -> Dict[str, Any]:
        pad = (-self._pos) % _ALIGN
        if pad:
            self._fh.write(b"\0" * pad)
            self._pos += pad
        self._fh.write(arr.data)  # contiguous: written and CRC'd in place
        sec = {"off": self._pos, "nbytes": arr.nbytes, "dtype": arr.dtype.str,
               "shape": list(arr.shape), "crc": section_crc(arr)}
        self._pos += arr.nbytes
        return sec

    def append(self, batch: ColumnarBatch, start: int) -> None:
        """Serialize one decoded chunk: its sections and its table row."""
        if self._dead:
            return
        try:
            cols_meta = []
            for name, col in batch.columns.items():
                sections = [(role, self._put(arr)) for role, arr in column_buffers(col)]
                cols_meta.append({"name": name, "hash_buckets": col.hash_buckets,
                                  "sections": sections})
            self._chunks.append({"start": int(start), "num_rows": int(batch.num_rows),
                                 "columns": cols_meta})
            self._rows += batch.num_rows
        except Exception as e:  # noqa: BLE001 - counted in _kill; the epoch goes on
            self._kill(f"append failed: {e}")

    def commit(self) -> bool:
        """Footer and atomic rename into place, then staging hygiene and
        the LRU sweep. True when the entry landed."""
        if self._dead:
            return False
        with timed("cache.commit", METRICS), \
                telemetry.span("cache.commit", shard=self.source_path):
            return self._commit_inner()

    def _commit_inner(self) -> bool:
        try:
            footer = {"version": VERSION, "fingerprint": self._cache.fingerprint,
                      "source": self._source, "ident": self._cache.ident,
                      "rows": self._rows, "chunks": self._chunks}
            blob = json.dumps(footer, sort_keys=True, default=str).encode("utf-8")
            self._fh.write(blob)
            self._fh.write(_TAIL.pack(len(blob), wire.crc32c(blob), TAIL_MAGIC))
            self._fh.close()
            self._pos += len(blob) + _TAIL.size
            # a rename that replaces an older generation grows the
            # directory by the difference only
            try:
                replaced = os.path.getsize(self.final_path)
            except OSError:
                replaced = 0
            _fs.filesystem_for(self._cache.cache_dir).rename(self._tmp_path, self.final_path)
        except Exception as e:  # noqa: BLE001 - counted in _kill; the epoch goes on
            self._kill(f"commit failed: {e}")
            return False
        METRICS.count("cache.bytes_written", self._pos)
        self._cleanup_staging()
        self._cache.sweep(protect=self.final_path, added_bytes=self._pos - replaced)
        return True

    def abort(self) -> None:
        try:
            if not self._fh.closed:
                self._fh.close()
        except OSError:
            pass
        self._cleanup_staging()

    def _cleanup_staging(self) -> None:
        from tpu_tfrecord_torch.io.writer import sweep_orphan_jobs

        fs = _fs.filesystem_for(self._cache.cache_dir)
        try:
            fs.rmtree(self._tmp_dir, ignore_errors=True)
        except OSError:
            pass
        # staging of crashed populates (dead pid, stale lease), then the
        # shared parent once it is empty
        sweep_orphan_jobs(fs, self._cache.cache_dir, keep=self._job_id)
        try:
            fs.rmdir(os.path.join(self._cache.cache_dir, p.TEMP_PREFIX))
        except OSError:
            pass


#: The process's validated entries, keyed by (abspath, inode, size,
#: mtime_ns): a fresh dataset on the same cache (one an epoch) finds an
#: entry here and skips the section verification. A commit's rename gives
#: a new inode, an in-place change a new mtime, and the LRU hit-touch moves
#: only atime. Inserts prune older generations of a path and evictions drop
#: theirs, so each live entry pins one mmap.
_REGISTRY_LOCK = threading.Lock()
_ENTRY_REGISTRY: Dict[Tuple[str, int, int, int], CachedShard] = {}


def _registry_key(path: str) -> Tuple[str, int, int, int]:
    st = os.stat(path)
    return (os.path.abspath(path), int(st.st_ino), int(st.st_size), int(st.st_mtime_ns))


def _registry_put(key: Tuple[str, int, int, int], entry: CachedShard) -> None:
    """Insert, dropping any older generation of the same path (its map
    would pin a deleted inode's blocks for the life of the process)."""
    with _REGISTRY_LOCK:
        for k in [k for k in _ENTRY_REGISTRY if k[0] == key[0] and k != key]:
            del _ENTRY_REGISTRY[k]
        _ENTRY_REGISTRY[key] = entry


def _registry_drop_path(path: str) -> None:
    apath = os.path.abspath(path)
    with _REGISTRY_LOCK:
        for k in [k for k in _ENTRY_REGISTRY if k[0] == apath]:
            del _ENTRY_REGISTRY[k]


def release_registry(cache_dir: Optional[str] = None) -> int:
    """Drop the registered entries (all, or those under ``cache_dir``),
    unpinning their maps, before a cache directory is removed: ``rmtree``
    frees no disk while a map holds the inodes. Entries a live dataset
    holds stay mapped through it. Returns the number dropped."""
    with _REGISTRY_LOCK:
        if cache_dir is None:
            n = len(_ENTRY_REGISTRY)
            _ENTRY_REGISTRY.clear()
            return n
        prefix = os.path.abspath(cache_dir) + os.sep
        victims = [k for k in _ENTRY_REGISTRY if k[0].startswith(prefix)]
        for k in victims:
            del _ENTRY_REGISTRY[k]
        return len(victims)


def _touch_atime(path: str) -> None:
    """The LRU stamp: bump atime, keep mtime (part of the registry key)."""
    try:
        st = os.stat(path)
        os.utime(path, ns=(time.time_ns(), st.st_mtime_ns))
    except OSError:
        pass


def _source_matches(footer: Dict[str, Any], source: Dict[str, Any]) -> bool:
    src = footer.get("source") or {}
    return (int(src.get("size", -1)) == int(source["size"])
            and int(src.get("mtime_ns", -1)) == int(source["mtime_ns"]))


class ShardCache:
    """A dataset's cache: one validated ``CachedShard`` a source shard,
    held for the life of the dataset, and the populate and eviction
    plumbing. Thread-safe: the decode pool's workers use it at once."""

    def __init__(self, cache_dir: str, ident: Dict[str, Any], max_bytes: Optional[int] = None,
                 expect_columns: Optional[set] = None):
        self.cache_dir = os.fspath(cache_dir)
        if _fs.has_scheme(self.cache_dir):
            raise ValueError(f"cache_dir must be a local path (the cache is mmap-served); "
                             f"got {self.cache_dir!r}")
        self.ident = ident
        self.fingerprint = decode_fingerprint(ident)
        self.max_bytes = max_bytes
        # the column set of a decoded chunk; an entry whose chunks differ
        # is corrupt, not servable
        self.expect_columns = set(expect_columns) if expect_columns else None
        self._lock = threading.Lock()
        self._entries: Dict[str, CachedShard] = {}
        # the source identity of the last miss, for the populator after it
        self._miss_source: Dict[str, Dict[str, Any]] = {}
        # the directory's size as of the last scan plus what commits added
        # since (None = not scanned): a commit under budget skips the scan
        self._total_bytes: Optional[int] = None
        os.makedirs(self.cache_dir, exist_ok=True)

    def entry_path(self, shard_path: str) -> str:
        return os.path.join(self.cache_dir, entry_filename(shard_path, self.fingerprint))

    def open_entry(self, shard, source: Optional[Dict[str, Any]] = None
                   ) -> Optional[CachedShard]:
        """A validated entry for ``shard`` (a hit), or None (a miss: decode
        and populate). Counts ``cache.hits`` / ``cache.misses`` a
        shard-epoch, and ``cache.corrupt_fallbacks`` when the miss was a
        corrupt entry; the first verification of an entry lands in the
        ``cache.open`` stage and span."""
        path = self.entry_path(shard.path)
        with self._lock:
            entry = self._entries.get(shard.path)
        if entry is not None:
            _touch_atime(path)
            METRICS.count("cache.hits")
            return entry
        try:
            if source is None:
                source = source_stat(shard.path, shard.size)
            with self._lock:
                self._miss_source[shard.path] = source
            key = None
            try:
                key = _registry_key(path)
            except OSError:
                pass
            if key is not None:
                with _REGISTRY_LOCK:
                    entry = _ENTRY_REGISTRY.get(key)
                if (entry is not None and entry.footer.get("fingerprint") == self.fingerprint
                        and _source_matches(entry.footer, source)):
                    # verified by an earlier dataset of this process; the
                    # same inode, size and mtime hold the same bytes
                    with self._lock:
                        self._entries[shard.path] = entry
                    _touch_atime(path)
                    METRICS.count("cache.hits")
                    return entry
                if entry is not None:
                    _registry_drop_path(path)
                entry = None
            # timed by hand, not by ``timed``: a healthy cold miss raises
            # here, and must not count as a cache.open error
            t0 = time.perf_counter()
            try:
                with telemetry.span("cache.open", shard=shard.path):
                    entry = open_entry_file(path, expect_fingerprint=self.fingerprint,
                                            source=source, expect_columns=self.expect_columns)
            finally:
                dt = time.perf_counter() - t0
                METRICS.add("cache.open", seconds=dt, latency=dt)
            if key is not None:
                _registry_put(key, entry)
        except CacheOpenError as e:
            if e.kind == "corrupt":
                METRICS.count("cache.corrupt_fallbacks")
                logger.warning("tfrecord.cache corrupt entry for %s — falling back to "
                               "TFRecord decode and rewriting: %s", shard.path, e)
            METRICS.count("cache.misses")
            return None
        except OSError as e:
            # an injected or transient open fault is a miss, never a crash
            METRICS.count("cache.misses")
            logger.warning("tfrecord.cache open failed for %s: %s", path, e)
            return None
        except Exception as e:  # noqa: BLE001
            # metadata that parsed but has the wrong shape: corrupt
            METRICS.count("cache.corrupt_fallbacks")
            METRICS.count("cache.misses")
            logger.warning("tfrecord.cache malformed entry for %s — falling back to "
                           "TFRecord decode and rewriting: %s", shard.path, e)
            return None
        with self._lock:
            self._entries[shard.path] = entry
        _touch_atime(path)
        METRICS.count("cache.hits")
        return entry

    def peek_entry(self, shard) -> bool:
        """Would ``open_entry`` hit? Side-effect free: no counters, no
        registry change, no section verification (a held or registered
        entry answers from memory, else only the footer is read)."""
        with self._lock:
            if shard.path in self._entries:
                return True
        path = self.entry_path(shard.path)
        try:
            key = _registry_key(path)
        except OSError:
            return False
        with _REGISTRY_LOCK:
            entry = _ENTRY_REGISTRY.get(key)
        try:
            source = source_stat(shard.path, shard.size)
            footer = entry.footer if entry is not None else load_footer(path)
        except Exception:  # noqa: BLE001 - unreadable or corrupt reads as not cached
            return False
        return footer.get("fingerprint") == self.fingerprint and _source_matches(footer, source)

    def populator(self, shard, source: Optional[Dict[str, Any]] = None
                  ) -> Optional[CachePopulator]:
        """Start a populate of ``shard`` (with the source identity of the
        miss before it); None when staging cannot be set up (the epoch
        goes on uncached)."""
        try:
            if source is None:
                with self._lock:
                    source = self._miss_source.pop(shard.path, None)
            if source is None:
                source = source_stat(shard.path, shard.size)
            return CachePopulator(self, shard.path, source)
        except OSError as e:
            logger.warning("tfrecord.cache cannot stage entry for %s: %s", shard.path, e)
            return None

    def forget(self, shard_path: str) -> None:
        """Drop a held entry (explicit invalidation)."""
        with self._lock:
            self._entries.pop(shard_path, None)

    def sweep(self, protect: Optional[str] = None, added_bytes: int = 0) -> List[str]:
        """LRU eviction down to ``max_bytes``: oldest atime first, never
        ``protect`` (the entry just committed). Skips the directory scan
        while the running total (``added_bytes`` = what the caller just
        committed) is within budget. Never raises; returns the evicted
        paths."""
        if not self.max_bytes:
            return []
        with self._lock:
            if self._total_bytes is not None:
                self._total_bytes += added_bytes
                if self._total_bytes <= self.max_bytes:
                    return []
        evicted: List[str] = []
        try:
            entries = []
            for name in os.listdir(self.cache_dir):
                if not name.endswith(ENTRY_SUFFIX):
                    continue
                path = os.path.join(self.cache_dir, name)
                try:
                    st = os.stat(path)
                except OSError:
                    continue
                entries.append((st.st_atime_ns, st.st_size, path))
            total = sum(sz for _, sz, _ in entries)
            for _at, sz, path in sorted(entries):
                if total <= self.max_bytes:
                    break
                if protect is not None and os.path.basename(path) == os.path.basename(protect):
                    continue
                try:
                    os.remove(path)
                except OSError:
                    continue
                _registry_drop_path(path)
                total -= sz
                evicted.append(path)
                METRICS.count("cache.evictions")
            with self._lock:
                self._total_bytes = total
        except OSError:
            pass
        return evicted


# ---------------------------------------------------------------------------
# Offline inspection
# ---------------------------------------------------------------------------


def inspect_entry(path: str) -> Dict[str, Any]:
    """The offline report of one entry file: footer fields, section-CRC
    verification and the source shard's freshness. ``status`` is ``ok``,
    ``corrupt``, ``stale`` or ``source_missing``."""
    report: Dict[str, Any] = {"entry": path, "size_bytes": None, "status": "ok"}
    try:
        report["size_bytes"] = os.path.getsize(path)
    except OSError:
        pass
    try:
        entry = open_entry_file(path, verify_sections=True)
    except CacheOpenError as e:
        report["status"] = "stale" if e.kind == "stale" else "corrupt"
        report["error"] = str(e)
        try:  # a stale footer that parses still names its identity
            footer = load_footer(path)
            report["fingerprint"] = footer.get("fingerprint")
            report["source"] = footer.get("source")
        except CacheOpenError:
            pass
        return report
    footer = entry.footer
    src = footer.get("source") or {}
    report.update({"fingerprint": footer.get("fingerprint"), "source": src,
                   "rows": entry.rows, "chunks": entry.num_chunks, "crc_verified": True})
    src_path = src.get("path")
    if src_path and _fs.has_scheme(src_path):
        # a remote source: the runtime's freshness probe; a store that
        # cannot be reached is reported unverified, not missing or stale
        try:
            if not _fs.filesystem_for(src_path).exists(src_path):
                report["status"] = "source_missing"
                return report
            if not _source_matches(footer, source_stat(src_path)):
                report["status"] = "stale"
        except Exception:  # any backend failure: disclosed as unavailable
            report["source_check"] = "unavailable"
        return report
    if src_path:
        try:
            current = source_stat(src_path)
        except OSError:
            report["status"] = "source_missing"
            return report
        if not _source_matches(footer, current):
            report["status"] = "stale"
    return report


def iter_entry_reports(cache_dir: str) -> Iterator[Dict[str, Any]]:
    """One ``inspect_entry`` report a ``*.tfrc`` file under ``cache_dir``.
    An unreadable directory raises: an audit that reports no entries would
    read as a healthy empty cache."""
    for name in sorted(os.listdir(cache_dir)):
        if name.endswith(ENTRY_SUFFIX):
            yield inspect_entry(os.path.join(cache_dir, name))
