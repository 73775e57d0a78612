"""The HTTP remote tier: a stdlib HTTP(S) filesystem client and a
fault-injecting Range server. Copy of the JAX package's ``httpfs.py``
(standard library only): the two packages' clients and servers talk to
each other, and one ``FaultPlan`` fires the same ledger on either server
for the same requests.

- ``HttpFS``: a read-only filesystem for ``http://`` / ``https://`` URLs
  on ``http.client`` alone (no fsspec). Reads are Range requests; every
  ``open()`` is its own connection, so ``fs.PrefetchReader`` fetches the
  blocks of one object at once. The client checks ``Content-Range``
  against the offset it asked for: a server that lies is a
  ``BadContentRangeError`` (counted in ``remote.bad_range``), never
  shifted bytes. A body that ends before its ``Content-Length`` raises,
  so a block fetch's retry resumes at the exact byte instead of reading a
  truncated body as the end of the object. Redirects are followed (at
  most ``_MAX_REDIRECTS``); a non-success status raises
  ``HTTPStatusError`` with ``status`` and the parsed ``Retry-After``;
  ``TFR_HTTP_TIMEOUT_S`` sets the socket timeout.

- ``serve_directory`` / ``FaultingRangeServer``: a threaded stdlib HTTP
  server over a local directory, for tests and benchmarks. Range support,
  a JSON directory index (``DIR_CONTENT_TYPE``), freshness stamps
  (``Last-Modified``, ``ETag``), and, given a ``faults.FaultPlan``, the
  ``http`` fault kinds executed at the server side of the socket: a reset
  mid-body, a truncated body, an ``http_error`` with ``Retry-After``, a
  shifted ``Content-Range``, a trickle and a stall. Every fired fault lands
  in the plan's replayable ledger; the plan key of a file GET is ``<url
  path>@<range start>``, so concurrent block fetches get per-offset
  ordinals.

Connection refusals as the client sees them come from the chaos seam:
``faults.install_chaos`` points ``_CHAOS_PLAN`` at its plan, and every
connection establishment consults it with ``op="connect"`` against the
peer ``host:port``.

HTTP is an ingest tier: every write-side operation raises.
"""

from __future__ import annotations

import email.utils
import http.client
import json
import os
import posixpath
import re
import socket
import struct
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import BinaryIO, Iterator, List, Optional, Tuple

from tpu_tfrecord_torch.metrics import METRICS

#: Chaos seam (``faults.install_chaos``): while a plan is
#: installed, every client connection establishment consults it with
#: ``op="connect"`` against the peer "host:port" — a transient/permanent
#: error rule there IS connection-refused as the client observes it.
_CHAOS_PLAN = None

#: Content type the fault server stamps on directory-index responses;
#: HttpFS uses it to tell files from directories without a convention
#: like trailing slashes.
DIR_CONTENT_TYPE = "application/vnd.tpu-tfrecord.dirindex+json"

_REDIRECT_STATUSES = (301, 302, 303, 307, 308)
_MAX_REDIRECTS = 3


class BadContentRangeError(OSError):
    """The server's ``Content-Range`` start disagrees with the offset the
    client requested: a LYING server. Raised before a single byte of the
    mislabeled body is surfaced — wrong data must be a loud error, never
    records decoded from shifted bytes."""


class HTTPStatusError(OSError):
    """A non-success HTTP response (503/429/...). Carries ``status`` and
    the parsed ``retry_after`` seconds (None when absent) so retry loops
    can honor the server's own pacing hint."""

    def __init__(self, msg: str, status: int = 0,
                 retry_after: Optional[float] = None):
        super().__init__(msg)
        self.status = status
        self.retry_after = retry_after


def _connect_timeout() -> Optional[float]:
    raw = os.environ.get("TFR_HTTP_TIMEOUT_S", "").strip()
    return float(raw) if raw else None


def _parse_retry_after(value: Optional[str]) -> Optional[float]:
    if not value:
        return None
    try:
        return max(0.0, float(value))
    except ValueError:
        pass
    try:  # HTTP-date form
        when = email.utils.parsedate_to_datetime(value)
        import datetime

        now = datetime.datetime.now(datetime.timezone.utc)
        return max(0.0, (when - now).total_seconds())
    except (TypeError, ValueError):
        return None


def _split_url(url: str) -> Tuple[str, str, int, str]:
    """(scheme, host, port, path+query) — path defaults to '/'."""
    u = urllib.parse.urlsplit(url)
    if u.scheme not in ("http", "https"):
        raise ValueError(f"not an http(s) URL: {url!r}")
    if not u.hostname:
        raise ValueError(f"http(s) URL without a host: {url!r}")
    port = u.port or (443 if u.scheme == "https" else 80)
    path = u.path or "/"
    if u.query:
        path += "?" + u.query
    return u.scheme, u.hostname, port, path


def _new_connection(scheme: str, host: str, port: int):
    """One fresh connection, through the chaos connect seam."""
    plan = _CHAOS_PLAN
    if plan is not None:
        plan.apply_socket("connect", f"{host}:{port}")
    timeout = _connect_timeout()
    kwargs = {} if timeout is None else {"timeout": timeout}
    if scheme == "https":
        return http.client.HTTPSConnection(host, port, **kwargs)
    return http.client.HTTPConnection(host, port, **kwargs)


class _HttpFile:
    """Read-only file object over HTTP Range requests.

    Lazy: ``seek`` just moves the position; the next ``read`` issues ONE
    open-ended range request (``bytes=pos-``) and streams from it, so a
    sequential consumer pays one request per open/seek, not per read.
    The response is validated before any byte is surfaced:

    - 206 must carry a ``Content-Range`` whose start equals the requested
      offset (``BadContentRangeError`` otherwise — the lying-server case);
    - a 200 from a server that ignored the Range header is accepted by
      discarding ``pos`` bytes (correct, slow, counted nowhere — only
      non-range-capable servers hit it);
    - a body that ends before its declared length raises ``OSError``
      ("truncated body"), never reads as EOF.
    """

    def __init__(self, url: str):
        self._url = url
        self._scheme, self._host, self._port, self._path = _split_url(url)
        self._pos = 0
        self._conn = None
        self._resp = None
        self._remaining: Optional[int] = None  # bytes left in this response
        self._size: Optional[int] = None  # total object size when known
        self._closed = False

    # -- request plumbing ----------------------------------------------------

    def _drop_response(self) -> None:
        """Abandon the in-flight response AND its connection: a
        partially-read HTTP/1.1 response poisons the connection for
        reuse. (Fully-drained responses keep the connection alive via
        ``_read_raw``'s remaining==0 path, which clears only ``_resp``.)"""
        self._resp = None
        self._remaining = None
        if self._conn is not None:
            try:
                self._conn.close()
            except Exception:  # closing a poisoned keep-alive connection
                pass
            self._conn = None

    def _start(self) -> None:
        """Issue ``GET`` with ``Range: bytes=pos-`` and validate. Follows
        bounded redirects (CDN offload / signed-URL front ends) — the
        metadata layer (HttpFS._request) already does, and a dataset that
        discovers must also read."""
        for _ in range(_MAX_REDIRECTS + 1):
            if self._start_once():
                return
        raise OSError(f"too many redirects reading {self._url}")

    def _redirect_to(self, location: str) -> None:
        self._drop_response()
        self._url = urllib.parse.urljoin(self._url, location)
        self._scheme, self._host, self._port, self._path = _split_url(
            self._url
        )

    def _start_once(self) -> bool:
        """One request/validate round; False = redirected, go again."""
        if self._conn is None:
            self._conn = _new_connection(self._scheme, self._host, self._port)
        discard = 0
        try:
            self._conn.request(
                "GET", self._path, headers={"Range": f"bytes={self._pos}-"}
            )
            resp = self._conn.getresponse()
            status = resp.status
            if status in _REDIRECT_STATUSES:
                loc = resp.headers.get("Location")
                try:
                    resp.read()
                except Exception:  # the OSError below names the missing Location
                    pass
                if not loc:
                    self._drop_response()
                    raise OSError(
                        f"redirect without Location reading {self._url}"
                    )
                self._redirect_to(loc)
                return False
            if status == 206:
                m = re.match(
                    r"bytes (\d+)-(\d+)/(\d+|\*)",
                    resp.headers.get("Content-Range", ""),
                )
                if not m:
                    METRICS.count("remote.bad_range")
                    resp.close()
                    self._drop_response()
                    raise BadContentRangeError(
                        f"206 without a parseable Content-Range from {self._url}"
                    )
                start, end, total = m.group(1), m.group(2), m.group(3)
                if int(start) != self._pos:
                    METRICS.count("remote.bad_range")
                    resp.close()
                    self._drop_response()
                    raise BadContentRangeError(
                        f"server returned range starting at byte {start} for a "
                        f"request at byte {self._pos} on {self._url} — refusing "
                        "to read shifted data"
                    )
                self._remaining = int(end) - int(start) + 1
                if total != "*":
                    self._size = int(total)
            elif status == 200:
                # range ignored: full body; discard up to pos (slow path).
                # remaining counts the WHOLE body — the discard loop below
                # runs it down to size - pos through _read_raw.
                length = resp.headers.get("Content-Length")
                self._remaining = int(length) if length else None
                self._size = int(length) if length else None
                discard = self._pos
            elif status == 416:
                # requested start at/past EOF: clean EOF, not an error
                resp.read()
                self._resp = None
                self._remaining = 0
                return True
            else:
                retry_after = _parse_retry_after(resp.headers.get("Retry-After"))
                try:
                    resp.read()
                except Exception:  # the HTTPStatusError below is raised either way
                    pass
                self._drop_response()
                raise HTTPStatusError(
                    f"HTTP {status} reading {self._url}",
                    status=status,
                    retry_after=retry_after,
                )
            self._resp = resp
            while discard > 0:
                chunk = self._read_raw(min(discard, 1 << 20))
                if not chunk:
                    break
                discard -= len(chunk)
            return True
        except (http.client.HTTPException, socket.error) as e:
            self._drop_response()
            if isinstance(e, OSError):
                raise
            raise OSError(f"HTTP request failed on {self._url}: {e}") from e

    def _read_raw(self, n: int) -> bytes:
        """One validated read off the live response."""
        resp = self._resp
        try:
            data = resp.read(n)
        except (http.client.HTTPException, socket.error) as e:
            self._drop_response()
            if isinstance(e, OSError):
                raise
            raise OSError(
                f"connection died mid-body at byte {self._pos} of {self._url}: {e}"
            ) from e
        if self._remaining is not None:
            if not data and self._remaining > 0:
                # the server closed before delivering Content-Length bytes:
                # a TRUNCATED body must raise (retryable, resumable at
                # self._pos), never read as end-of-object
                self._drop_response()
                raise OSError(
                    f"truncated body: connection closed {self._remaining} "
                    f"bytes early at byte {self._pos} of {self._url}"
                )
            self._remaining -= len(data)
            if self._remaining <= 0:
                # fully consumed: the connection is clean for reuse
                self._resp = None
                self._remaining = None
        return data

    # -- file-object surface -------------------------------------------------

    def read(self, size: int = -1) -> bytes:
        if self._closed:
            raise ValueError("read on closed _HttpFile")
        if size is None or size < 0:
            parts = []
            while True:
                chunk = self.read(8 << 20)
                if not chunk:
                    return b"".join(parts)
                parts.append(chunk)
        if size == 0:
            return b""
        if self._size is not None and self._pos >= self._size:
            return b""
        if self._resp is None:
            if self._remaining == 0:  # 416: at/past EOF
                return b""
            self._start()
            if self._resp is None:
                return b""
        data = self._read_raw(size)
        self._pos += len(data)
        return data

    def readinto(self, b) -> int:
        data = self.read(len(b))
        b[: len(data)] = data
        return len(data)

    def seek(self, pos: int, whence: int = 0) -> int:
        if whence == 1:
            pos = self._pos + pos
        elif whence == 2:
            if self._size is None:
                raise OSError("seek from end without a known size")
            pos = self._size + pos
        elif whence != 0:
            raise ValueError(f"unsupported whence {whence}")
        if pos != self._pos:
            if self._resp is not None:
                # mid-body: the partially-read response poisons the
                # connection — drop both
                self._drop_response()
            else:
                # fully drained (or never started): the keep-alive
                # connection is clean, the next read re-ranges on it
                self._remaining = None
        self._pos = pos
        return pos

    def tell(self) -> int:
        return self._pos

    def readable(self) -> bool:
        return True

    def seekable(self) -> bool:
        return True

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._drop_response()

    @property
    def closed(self) -> bool:
        return self._closed

    def __enter__(self) -> "_HttpFile":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class HttpFS:
    """Read-only stdlib filesystem for ``http://``/``https://`` URLs.

    Matches the surface ``LocalFS``/``FsspecFS`` expose to the read path
    (open/exists/isfile/isdir/listdir/walk_files/size/info/normalize);
    write-side methods raise. Directory listings understand the fault
    server's JSON index (DIR_CONTENT_TYPE) and degrade to parsing the
    ``href``s of a generic autoindex HTML page.

    ``independent_read_handles`` is declared True: every ``open()`` is a
    fresh connection with its own cursor, so PrefetchReader runs block
    fetches concurrently — the whole point of a real-network tier.
    """

    independent_read_handles = True
    protocol = ("http", "https")

    def __init__(self, url: str = "http://"):
        del url  # stateless: every path carries its own authority

    # -- metadata ------------------------------------------------------------

    def _request(self, method: str, url: str, allow_404: bool = False):
        """(status, headers, body bytes | None, final_url) with bounded
        redirects — final_url is where the response actually came from,
        so callers can see e.g. that a bare directory name was redirected
        to its trailing-slash listing."""
        current = url
        for _ in range(_MAX_REDIRECTS + 1):
            scheme, host, port, path = _split_url(current)
            conn = _new_connection(scheme, host, port)
            try:
                conn.request(method, path)
                resp = conn.getresponse()
                if resp.status in _REDIRECT_STATUSES:
                    loc = resp.headers.get("Location")
                    resp.read()
                    if not loc:
                        raise OSError(f"redirect without Location from {current}")
                    current = urllib.parse.urljoin(current, loc)
                    continue
                body = None if method == "HEAD" else resp.read()
                if resp.status == 404:
                    if allow_404:
                        return resp.status, resp.headers, body, current
                    raise FileNotFoundError(f"HTTP 404: {url}")
                if resp.status >= 400:
                    raise HTTPStatusError(
                        f"HTTP {resp.status} on {method} {url}",
                        status=resp.status,
                        retry_after=_parse_retry_after(
                            resp.headers.get("Retry-After")
                        ),
                    )
                return resp.status, resp.headers, body, current
            except (http.client.HTTPException, socket.error) as e:
                if isinstance(e, OSError):
                    raise
                raise OSError(f"HTTP {method} failed on {url}: {e}") from e
            finally:
                conn.close()
        raise OSError(f"too many redirects resolving {url}")

    def normalize(self, path: str) -> str:
        return path

    def open(self, path: str, mode: str) -> BinaryIO:
        if mode not in ("rb", "r"):
            raise OSError(
                f"http(s) filesystem is read-only: cannot open {path!r} "
                f"with mode {mode!r}"
            )
        return _HttpFile(path)

    def exists(self, path: str) -> bool:
        status, _, _, _ = self._request("HEAD", path, allow_404=True)
        return status == 200

    def _head_type(self, path: str) -> Tuple[int, str, bool]:
        """(status, content-type, landed_on_dir_listing) — the last flag
        is True when the (possibly redirected) final URL ends in '/',
        the generic-autoindex directory signal."""
        status, headers, _, final = self._request("HEAD", path,
                                                  allow_404=True)
        ctype = (headers.get("Content-Type") or "").split(";")[0].strip()
        return status, ctype, final.rstrip("?").endswith("/")

    def isfile(self, path: str) -> bool:
        status, ctype, on_dir = self._head_type(path)
        if status != 200 or ctype == DIR_CONTENT_TYPE:
            return False
        # a generic autoindex server 301s 'ds' -> 'ds/' and serves the
        # HTML listing: that is a DIRECTORY, not an html shard — without
        # this, the doctor would scan the listing page as TFRecord bytes
        return not (on_dir and ctype == "text/html")

    def isdir(self, path: str) -> bool:
        status, ctype, on_dir = self._head_type(path)
        if status == 200:
            return ctype == DIR_CONTENT_TYPE or (
                ctype == "text/html" and (on_dir or path.endswith("/"))
            )
        if status == 404 and not path.endswith("/"):
            # generic servers 404 the bare name and serve the listing at
            # path + "/"
            status, ctype, _ = self._head_type(path + "/")
            return status == 200 and ctype in (DIR_CONTENT_TYPE, "text/html")
        return False

    def size(self, path: str) -> int:
        status, headers, _, _ = self._request("HEAD", path)
        length = headers.get("Content-Length")
        if length is None:
            raise OSError(f"no Content-Length for {path}")
        return int(length)

    def info(self, path: str) -> dict:
        """Backend metadata in the key vocabulary ``cache.source_stat``
        scans (size + mtime / ETag): a remote rewrite with the same size
        still invalidates epoch-cache entries."""
        status, headers, _, _ = self._request("HEAD", path)
        out: dict = {"name": path, "type": "file"}
        length = headers.get("Content-Length")
        if length is not None:
            out["size"] = int(length)
        lm = headers.get("Last-Modified")
        if lm:
            try:
                out["mtime"] = email.utils.parsedate_to_datetime(lm).timestamp()
            except (TypeError, ValueError):
                pass
        etag = headers.get("ETag")
        if etag:
            out["ETag"] = etag
        return out

    # -- listing / discovery -------------------------------------------------

    def _entries(self, path: str) -> List[dict]:
        """Directory entries as dicts with name/type and (when the index
        provides it) size. Tries the URL as given, then with a trailing
        slash (generic autoindex servers)."""
        status, headers, body, _ = self._request("GET", path, allow_404=True)
        if status == 404 and not path.endswith("/"):
            status, headers, body, _ = self._request("GET", path + "/",
                                                     allow_404=True)
        if status != 200:
            raise FileNotFoundError(f"HTTP {status} listing {path}")
        ctype = (headers.get("Content-Type") or "").split(";")[0].strip()
        if ctype == DIR_CONTENT_TYPE:
            doc = json.loads(body.decode("utf-8"))
            return list(doc.get("entries", []))
        # generic autoindex HTML: hrefs relative to the directory
        entries = []
        for href in re.findall(rb'href="([^"?#]+)"', body or b""):
            name = urllib.parse.unquote(href.decode("utf-8", "replace"))
            if name.startswith(("/", "../")) or name in (".", "./"):
                continue
            is_dir = name.endswith("/")
            entries.append(
                {"name": name.rstrip("/"), "type": "directory" if is_dir
                 else "file"}
            )
        return entries

    def listdir(self, path: str) -> List[str]:
        return sorted(e["name"] for e in self._entries(path))

    def walk_files(self, root: str, keep) -> Iterator[Tuple[str, int]]:
        """Deterministic (sorted) walk yielding (url, size); directory
        recursion and file order match the other backends so every host
        derives the same global shard order. Sizes come from the JSON
        index when present, one HEAD per file otherwise."""
        stack = [root.rstrip("/")]
        while stack:
            dirurl = stack.pop()
            files, dirs = [], []
            for e in self._entries(dirurl):
                name = str(e.get("name", "")).strip("/")
                if not name or not keep(name):
                    continue
                child = f"{dirurl}/{name}"
                if e.get("type") == "directory":
                    dirs.append(child)
                else:
                    size = e.get("size")
                    if size is None:
                        size = self.size(child)
                    files.append((child, int(size)))
            for furl, size in sorted(files):
                yield furl, size
            stack.extend(sorted(dirs, reverse=True))  # pop() visits in order

    def glob(self, pattern: str) -> List[str]:
        raise OSError(
            f"glob is not supported over http(s) ({pattern!r}): point the "
            "reader at the dataset directory or a concrete file URL"
        )

    # -- write side: loudly read-only ---------------------------------------

    def _read_only(self, op: str, path: str):
        raise OSError(
            f"http(s) filesystem is read-only: {op} on {path!r} is not "
            "supported (HTTP is an ingest tier; write through a "
            "rename-capable store)"
        )

    def makedirs(self, path: str) -> None:
        self._read_only("makedirs", path)

    def remove(self, path: str) -> None:
        self._read_only("remove", path)

    def rmtree(self, path: str, ignore_errors: bool = False) -> None:
        if not ignore_errors:
            self._read_only("rmtree", path)

    def rmdir(self, path: str) -> None:
        self._read_only("rmdir", path)

    def rename(self, src: str, dst: str) -> None:
        self._read_only("rename", src)

    def touch(self, path: str) -> None:
        self._read_only("touch", path)


# ---------------------------------------------------------------------------
# The test/bench backend: a threaded Range server with socket-level faults
# ---------------------------------------------------------------------------


class _RangeHandler(BaseHTTPRequestHandler):
    """One request handler over ``server.root``. HTTP/1.1 with real
    keep-alive, Range support on files, a JSON index for directories, and
    the FaultPlan hook on file GETs (metadata requests are served clean so
    discovery does not eat rule firings meant for reads)."""

    protocol_version = "HTTP/1.1"
    server_version = "TfrRangeHTTP/1.0"

    def log_message(self, fmt, *args):  # noqa: D102 — silence stderr spam
        pass

    # -- path resolution -----------------------------------------------------

    def _resolve(self) -> Optional[str]:
        """Filesystem path for the request URL, or None when it escapes
        the served root (traversal) — answered 404, never served."""
        raw = urllib.parse.unquote(urllib.parse.urlsplit(self.path).path)
        norm = posixpath.normpath(raw)
        if norm.startswith(("..", "/..")):
            return None
        local = os.path.join(self.server.root, norm.lstrip("/"))
        local = os.path.normpath(local)
        root = os.path.normpath(self.server.root)
        if not (local == root or local.startswith(root + os.sep)):
            return None
        return local

    def _parse_range(self, size: int) -> Optional[Tuple[int, int]]:
        """(start, end) inclusive, or None for a whole-object request.
        Raises ValueError for an unsatisfiable start (→ 416)."""
        header = self.headers.get("Range")
        if not header:
            return None
        m = re.match(r"bytes=(\d+)-(\d*)$", header.strip())
        if not m:
            return None  # unsupported form: serve the whole object (200)
        start = int(m.group(1))
        if start >= size:
            raise ValueError("range start past EOF")
        end = int(m.group(2)) if m.group(2) else size - 1
        return start, min(end, size - 1)

    # -- responses -----------------------------------------------------------

    def _send_simple(self, status: int, body: bytes,
                     ctype: str = "text/plain",
                     extra_headers: Optional[dict] = None) -> None:
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        for k, v in (extra_headers or {}).items():
            self.send_header(k, str(v))
        self.end_headers()
        if self.command != "HEAD":
            self.wfile.write(body)

    def _send_dir_index(self, local: str) -> None:
        entries = []
        with os.scandir(local) as it:
            for e in sorted(it, key=lambda e: e.name):
                if e.is_dir(follow_symlinks=False):
                    entries.append({"name": e.name, "type": "directory"})
                elif e.is_file(follow_symlinks=True):
                    entries.append(
                        {"name": e.name, "type": "file",
                         "size": e.stat().st_size}
                    )
        body = json.dumps({"entries": entries}).encode("utf-8")
        self._send_simple(200, body, ctype=DIR_CONTENT_TYPE)

    def _rst(self) -> None:
        """Reset the connection: SO_LINGER 0 makes close() send RST, the
        hard mid-transfer death a FIN can't model."""
        try:
            self.connection.setsockopt(
                socket.SOL_SOCKET, socket.SO_LINGER, struct.pack("ii", 1, 0)
            )
        except OSError:
            pass
        self.close_connection = True
        try:
            self.connection.close()
        except OSError:
            pass

    # -- the served read -----------------------------------------------------

    def _serve_file(self, local: str, head: bool) -> None:
        try:
            st = os.stat(local)
            size = st.st_size
        except OSError:
            self._send_simple(404, b"not found")
            return
        try:
            rng = self._parse_range(size)
        except ValueError:
            self._send_simple(
                416, b"", extra_headers={"Content-Range": f"bytes */{size}"}
            )
            return
        start, end = rng if rng is not None else (0, size - 1)

        if not head:
            # data fetches only: dir-index and HEAD metadata requests are
            # not the link being paid for shard bytes
            self.server.note_file_get()
        # ---- fault hook: op="http", keyed per (path, offset) ----
        plan = self.server.plan
        fired = []
        if plan is not None and not head:
            urlpath = urllib.parse.unquote(
                urllib.parse.urlsplit(self.path).path
            )
            fired = plan.decide("http", f"{urlpath}@{start}")
        stall_s = 0.0
        trickle = None  # (chunk_bytes, pause_s)
        truncate_at = None  # bytes of body actually sent
        reset_at = None  # RST after this many body bytes
        shift = 0
        for f in fired:
            rule = f["_rule"]
            kind = f["kind"]
            if kind == "stall":
                stall_s += rule.stall_ms / 1000.0
            elif kind == "trickle":
                trickle = (max(1, rule.cap_bytes or 1024),
                           rule.stall_ms / 1000.0)
            elif kind == "http_error":
                if stall_s:
                    plan.sleep(stall_s)
                extra = {}
                if rule.retry_after_s:
                    extra["Retry-After"] = f"{rule.retry_after_s:g}"
                self._send_simple(
                    rule.status, b"injected http_error", extra_headers=extra
                )
                self.close_connection = True
                return
            elif kind in ("transient_error", "permanent_error"):
                if stall_s:
                    plan.sleep(stall_s)
                self._send_simple(500, b"injected server error")
                self.close_connection = True
                return
            elif kind == "truncated_body":
                n = end - start + 1
                truncate_at = min(rule.cap_bytes or max(1, n // 2), n)
            elif kind == "reset":
                n = end - start + 1
                reset_at = min(rule.cap_bytes or max(0, n // 2), n)
            elif kind == "bad_content_range":
                # lie CONSISTENTLY: header and body both from the shifted
                # offset — only the client's Content-Range check stands
                # between this and silently corrupted records
                shift = rule.shift_bytes
        if stall_s:
            plan.sleep(stall_s)
        if self.server.latency_s:
            # simulated per-request link RTT for the bench depth sweep —
            # still a real connection, the handler just answers late
            import time as _time

            _time.sleep(self.server.latency_s)

        if shift:
            start = min(max(0, start + shift), max(0, size - 1))
            end = min(max(start, end + shift), size - 1)
        body_len = end - start + 1
        self.send_response(206 if rng is not None else 200)
        self.send_header("Accept-Ranges", "bytes")
        self.send_header("Content-Type", "application/octet-stream")
        self.send_header("Content-Length", str(body_len))
        # freshness stamps: the epoch cache keys remote invalidation on
        # these (cache.source_stat via HttpFS.info)
        self.send_header(
            "Last-Modified", email.utils.formatdate(st.st_mtime, usegmt=True)
        )
        self.send_header("ETag", f'"{st.st_mtime_ns:x}-{size:x}"')
        if rng is not None:
            self.send_header("Content-Range", f"bytes {start}-{end}/{size}")
        self.end_headers()
        if head:
            return

        to_send = body_len if truncate_at is None else truncate_at
        chunk_bytes = trickle[0] if trickle else (256 << 10)
        sent = 0
        try:
            with open(local, "rb") as fh:
                fh.seek(start)
                while sent < to_send:
                    if reset_at is not None and sent >= reset_at:
                        self._rst()
                        return
                    n = min(chunk_bytes, to_send - sent)
                    if reset_at is not None:
                        # stop EXACTLY at the reset point: the RST must
                        # land mid-body, not after the whole (small)
                        # object already reached the client's buffers
                        n = min(n, reset_at - sent)
                    data = fh.read(n)
                    if not data:
                        break
                    self.wfile.write(data)
                    self.wfile.flush()
                    sent += len(data)
                    if trickle and sent < to_send:
                        plan.sleep(trickle[1])
            if reset_at is not None and sent >= reset_at:
                self._rst()
                return
        except (BrokenPipeError, ConnectionResetError):
            self.close_connection = True
            return
        if truncate_at is not None and truncate_at < body_len:
            # we declared body_len bytes and sent fewer: drop the
            # connection so the client sees the premature FIN now
            self.close_connection = True
            try:
                self.connection.shutdown(socket.SHUT_WR)
            except OSError:
                pass

    def _handle(self, head: bool) -> None:
        self.server.note_request(self.command, self.path)
        raw = urllib.parse.urlsplit(self.path).path
        if raw.startswith("/redirect/"):
            # test route: 302 to the same resource at its real path — the
            # CDN-offload shape both the metadata layer AND the data reads
            # must follow
            self.send_response(302)
            self.send_header("Location", raw[len("/redirect"):])
            self.send_header("Content-Length", "0")
            self.end_headers()
            return
        local = self._resolve()
        if local is None or not os.path.exists(local):
            self._send_simple(404, b"not found")
            return
        if os.path.isdir(local):
            self._send_dir_index(local)
            return
        self._serve_file(local, head)

    def do_GET(self) -> None:  # noqa: N802 — http.server API
        self._handle(head=False)

    def do_HEAD(self) -> None:  # noqa: N802
        self._handle(head=True)


class _QuietThreadingHTTPServer(ThreadingHTTPServer):
    """A connection dying mid-request (the client abandoned it, the RST
    fault closed it, a consumer was SIGKILLed) is business as usual for a
    fault-injection backend — not a traceback on stderr."""

    def handle_error(self, request, client_address):
        import sys as _sys

        exc = _sys.exc_info()[1]
        if isinstance(exc, (BrokenPipeError, ConnectionResetError,
                            ConnectionAbortedError)):
            return
        super().handle_error(request, client_address)


class FaultingRangeServer:
    """Threaded HTTP server over ``root`` with the FaultPlan hook.

    ``plan`` may be None (clean serving), or a faults.FaultPlan whose
    ``op="http"`` rules fire on file GETs; fired faults land in the
    plan's replayable ledger. ``latency_s`` adds a fixed per-request
    delay — the bench's simulated link RTT on top of real sockets.
    """

    def __init__(self, root: str, plan=None, latency_s: float = 0.0,
                 host: str = "127.0.0.1", port: int = 0):
        self.root = os.path.abspath(root)
        httpd = _QuietThreadingHTTPServer((host, port), _RangeHandler)
        httpd.daemon_threads = True
        httpd.root = self.root
        httpd.plan = plan
        httpd.latency_s = latency_s
        lock = threading.Lock()
        counts = {"requests": 0, "gets": 0, "file_gets": 0}

        def note_request(command: str, path: str) -> None:
            with lock:
                counts["requests"] += 1
                if command == "GET":
                    counts["gets"] += 1

        def note_file_get() -> None:
            with lock:
                counts["file_gets"] += 1

        httpd.note_request = note_request
        httpd.note_file_get = note_file_get
        self._counts = counts
        self._counts_lock = lock
        self._httpd = httpd
        self._thread = threading.Thread(
            target=httpd.serve_forever, kwargs={"poll_interval": 0.05},
            daemon=True, name="tfr-http-backend",
        )

    def start(self) -> "FaultingRangeServer":
        self._thread.start()
        return self

    @property
    def address(self) -> Tuple[str, int]:
        return self._httpd.server_address[:2]

    @property
    def url(self) -> str:
        host, port = self.address
        return f"http://{host}:{port}"

    def url_for(self, relpath: str = "") -> str:
        rel = relpath.lstrip("/")
        return f"{self.url}/{rel}" if rel else self.url

    @property
    def request_count(self) -> int:
        with self._counts_lock:
            return self._counts["requests"]

    @property
    def get_count(self) -> int:
        with self._counts_lock:
            return self._counts["gets"]

    @property
    def file_get_count(self) -> int:
        """File-body GETs only (shard bytes actually re-fetched) —
        dir-index GETs and HEAD metadata excluded."""
        with self._counts_lock:
            return self._counts["file_gets"]

    def set_plan(self, plan) -> None:
        """Swap the fault plan between test phases (atomic attribute
        write; in-flight requests keep the plan they started with)."""
        self._httpd.plan = plan

    def set_latency(self, latency_s: float) -> None:
        self._httpd.latency_s = float(latency_s)

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5.0)

    def __enter__(self) -> "FaultingRangeServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def serve_directory(root: str, plan=None, latency_s: float = 0.0,
                    host: str = "127.0.0.1", port: int = 0) -> FaultingRangeServer:
    """Start a FaultingRangeServer over ``root`` on an ephemeral port and
    return it (already serving)::

        with serve_directory(local_dir, plan=plan) as srv:
            ds = TFRecordDataset(srv.url_for("ds"), ...)
    """
    return FaultingRangeServer(
        root, plan=plan, latency_s=latency_s, host=host, port=port
    ).start()
