"""The port's HTTP tier (``tpu_tfrecord_torch.httpfs`` and the remote half
of ``tpu_tfrecord_torch.fs``) against the JAX package's, over real
localhost sockets.

- Clients and servers against each other: the port's ``HttpFS`` against
  the JAX ``serve_directory`` and the JAX ``HttpFS`` against the port's
  server (and each against its own) give the same listings, sizes,
  ``info`` stamps, range reads at the end of an object, redirects, 404s
  and read-only errors, of the same types.
- The same fault ledger: one plan, replayed on the port's server and on
  the JAX server under the same access pattern, fires the same ledger.
- The self-heal matrix of ``PrefetchReader`` and ``RetryingReadStream``
  (the cases of ``tests/test_http_remote.py``), each run through the
  port's ``fs.open_for_read`` and the JAX one against the same server and
  plan: a reset mid-block, a truncated block resumed at the exact offset,
  ``Retry-After`` through the sleep seam and capped, an exhausted budget,
  ``close`` leaving no fetch thread.
"""

import email.utils
import http.server
import os
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from tpu_tfrecord import fs as jfs  # noqa: E402
from tpu_tfrecord import httpfs as jhttp  # noqa: E402
from tpu_tfrecord.faults import FaultPlan as JPlan  # noqa: E402
from tpu_tfrecord.faults import FaultRule as JRule  # noqa: E402
from tpu_tfrecord.faults import install_chaos as j_install_chaos  # noqa: E402
from tpu_tfrecord.metrics import METRICS as JMETRICS  # noqa: E402
from tpu_tfrecord.retry import RetryPolicy as JPolicy  # noqa: E402

from tpu_tfrecord_torch import fs as tfs  # noqa: E402
from tpu_tfrecord_torch import httpfs as thttp  # noqa: E402
from tpu_tfrecord_torch.faults import FaultPlan as TPlan  # noqa: E402
from tpu_tfrecord_torch.faults import FaultRule as TRule  # noqa: E402
from tpu_tfrecord_torch.faults import install_chaos as t_install_chaos  # noqa: E402
from tpu_tfrecord_torch.metrics import METRICS as TMETRICS  # noqa: E402
from tpu_tfrecord_torch.retry import RetryPolicy as TPolicy  # noqa: E402

SIDES = {
    "port": SimpleNamespace(fs=tfs, http=thttp, Plan=TPlan, Rule=TRule, chaos=t_install_chaos,
                            metrics=TMETRICS, Policy=TPolicy),
    "jax": SimpleNamespace(fs=jfs, http=jhttp, Plan=JPlan, Rule=JRule, chaos=j_install_chaos,
                           metrics=JMETRICS, Policy=JPolicy),
}
PAIRS = [(c, s) for c in SIDES for s in SIDES]
FILES = {"ds/part-a.bin": 150_000, "ds/part-b.bin": 40_000, "ds/sub/part-c.bin": 9_000,
         "ds/_SUCCESS": 0, "big.bin": 1 << 20}
BLOCK = 128 << 10  # PrefetchReader blocks in the self-heal matrix: 8 over big.bin


def fast(side, n, **kw):
    return SIDES[side].Policy(max_retries=n, sleep=lambda _s: None, **kw)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """(root, {relpath: bytes}): seeded random payloads on disk."""
    root = tmp_path_factory.mktemp("httptree")
    rng = np.random.default_rng(15)
    data = {}
    for rel, n in FILES.items():
        path = root / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        data[rel] = rng.integers(0, 256, n, np.uint8).tobytes()
        path.write_bytes(data[rel])
    return str(root), data


@pytest.fixture(scope="module")
def servers(tree):
    """The port's and the JAX package's Range servers over the same tree."""
    root, _ = tree
    srv = {"port": thttp.serve_directory(root), "jax": jhttp.serve_directory(root)}
    yield srv
    for s in srv.values():
        s.close()


@pytest.fixture
def clean(servers):
    for s in servers.values():
        s.set_plan(None)
        s.set_latency(0.0)
    yield servers
    for s in servers.values():
        s.set_plan(None)
        s.set_latency(0.0)


def outcome(fn):
    """(type name, str) of what ``fn`` raises, or ("ok", repr(value))."""
    try:
        return "ok", repr(fn())
    except Exception as e:  # noqa: BLE001 - the type is what is compared
        return type(e).__name__, str(e)


# -- clients and servers against each other ----------------------------------------


@pytest.mark.parametrize("client,server", PAIRS)
class TestClientServerMatrix:
    def test_listing_walk_and_types(self, tree, servers, client, server):
        root, data = tree
        srv = servers[server]
        fsys = SIDES[client].http.HttpFS()
        ds = srv.url_for("ds")
        assert fsys.listdir(ds) == sorted(os.listdir(os.path.join(root, "ds")))
        walked = list(fsys.walk_files(ds, lambda n: not n.startswith("_")))
        assert walked == [(srv.url_for(rel), len(data[rel]))
                          for rel in ("ds/part-a.bin", "ds/part-b.bin", "ds/sub/part-c.bin")]
        local = list(tfs.LocalFS().walk_files(os.path.join(root, "ds"),
                                              lambda n: not n.startswith("_")))
        assert [s for _, s in walked] == [s for _, s in local]
        assert fsys.isdir(ds) and not fsys.isfile(ds)
        assert fsys.isfile(srv.url_for("ds/part-a.bin"))
        assert not fsys.isdir(srv.url_for("ds/part-a.bin"))
        assert fsys.exists(ds) and not fsys.exists(srv.url_for("ds/nothing"))
        assert fsys.size(srv.url_for("big.bin")) == len(data["big.bin"])

    def test_info_carries_freshness_stamps(self, tree, servers, client, server):
        root, data = tree
        srv = servers[server]
        url = srv.url_for("ds/part-a.bin")
        info = SIDES[client].http.HttpFS().info(url)
        st = os.stat(os.path.join(root, "ds/part-a.bin"))
        assert info["size"] == len(data["ds/part-a.bin"])
        assert info["ETag"] == f'"{st.st_mtime_ns:x}-{st.st_size:x}"'
        want_mtime = email.utils.parsedate_to_datetime(
            email.utils.formatdate(st.st_mtime, usegmt=True)).timestamp()
        assert info["mtime"] == want_mtime
        other = SIDES["jax" if client == "port" else "port"].http.HttpFS().info(url)
        assert info == other

    def test_range_reads_and_eof(self, tree, servers, client, server):
        _, data = tree
        payload = data["ds/part-a.bin"]
        fsys = SIDES[client].http.HttpFS()
        with fsys.open(servers[server].url_for("ds/part-a.bin"), "rb") as fh:
            assert fh.read(64) == payload[:64]
            fh.seek(len(payload) // 2)
            assert fh.read(128) == payload[len(payload) // 2:][:128]
            assert fh.tell() == len(payload) // 2 + 128
            fh.seek(-10, 2)
            assert fh.read() == payload[-10:]
            fh.seek(len(payload) + 10)
            assert fh.read(8) == b""  # past EOF: a clean empty read
            fh.seek(0)
            assert fh.read() == payload

    def test_redirects_are_followed(self, tree, servers, client, server):
        _, data = tree
        srv = servers[server]
        red = srv.url_for("redirect/ds/part-b.bin")
        fsys = SIDES[client].http.HttpFS()
        assert fsys.size(red) == len(data["ds/part-b.bin"])
        with fsys.open(red, "rb") as fh:
            fh.seek(1000)
            assert fh.read(64) == data["ds/part-b.bin"][1000:1064]

    def test_missing_object_and_read_only_errors(self, servers, client, server):
        srv = servers[server]
        missing = srv.url_for("ds/missing.bin")
        fsys = SIDES[client].http.HttpFS()
        with pytest.raises(FileNotFoundError):
            fsys.size(missing)
        with pytest.raises(SIDES[client].http.HTTPStatusError) as err:
            with fsys.open(missing, "rb") as fh:
                fh.read(1)
        assert err.value.status == 404
        url = srv.url_for("ds")
        calls = [lambda f: f.open(url + "/x", "wb"), lambda f: f.rename(url + "/a", url + "/b"),
                 lambda f: f.makedirs(url + "/d"), lambda f: f.remove(url + "/a"),
                 lambda f: f.touch(url + "/t"), lambda f: f.rmdir(url + "/d"),
                 lambda f: f.rmtree(url + "/d"), lambda f: f.glob(url + "/*")]
        got = [outcome(lambda c=c: c(fsys)) for c in calls]
        want = [outcome(lambda c=c: c(jhttp.HttpFS())) for c in calls]
        assert got == want
        assert all(kind == "OSError" for kind, _ in got)
        assert fsys.rmtree(url + "/d", ignore_errors=True) is None


def test_dispatch_and_capability(servers):
    url = servers["jax"].url_for("ds")
    for u in (url, "https://127.0.0.1:1/ds"):
        fsys = tfs.filesystem_for(u)
        assert isinstance(fsys, thttp.HttpFS)
        # every open() is its own connection: concurrent block fetches
        assert tfs.independent_read_handles(fsys)
    assert thttp.DIR_CONTENT_TYPE == jhttp.DIR_CONTENT_TYPE
    assert thttp._MAX_REDIRECTS == jhttp._MAX_REDIRECTS


@pytest.mark.parametrize("value", [None, "", "0.25", "7", "-3", "abc", "past", "future"])
def test_parse_retry_after_matches_jax(value):
    if value == "past":
        value = email.utils.formatdate(time.time() - 3600, usegmt=True)
    if value == "future":
        value = email.utils.formatdate(time.time() + 3600, usegmt=True)
    got, want = thttp._parse_retry_after(value), jhttp._parse_retry_after(value)
    if value and value.endswith("GMT") and want:
        assert got == pytest.approx(want, abs=2.0)
    else:
        assert got == want


def test_timeout_env_matches_jax(monkeypatch):
    assert thttp._connect_timeout() is None
    monkeypatch.setenv("TFR_HTTP_TIMEOUT_S", "2.5")
    assert thttp._connect_timeout() == jhttp._connect_timeout() == 2.5
    conn = thttp._new_connection("http", "127.0.0.1", 1)
    assert conn.timeout == 2.5
    conn.close()


def test_http_rules_reject_unexecutable_kinds():
    """An op='http' rule of a kind the Range server does not execute would
    be ledgered while the object serves clean: refused at construction, by
    both packages alike."""
    for kind in ("short_read", "disconnect", "flaky_listing", "rename_race"):
        kw = {"cap_bytes": 8} if kind == "short_read" else {}
        for rule in (TRule, JRule):
            with pytest.raises(ValueError, match="http"):
                rule(op="http", kind=kind, **kw)
    TRule(op="http", kind="stall", stall_ms=5)
    TRule(op="http", kind="transient_error")


def test_autoindex_redirecting_dir_is_not_a_file():
    """A generic autoindex server 301s 'ds' to 'ds/' and serves an HTML
    listing: a directory, not a file, for both clients."""

    class _Autoindex(http.server.BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            pass

        def _respond(self):
            if self.path == "/ds":
                self.send_response(301)
                self.send_header("Location", "/ds/")
                self.send_header("Content-Length", "0")
                self.end_headers()
                return None
            if self.path == "/ds/":
                body = b'<html><a href="shard.tfrecord">s</a><a href="../">up</a></html>'
                self.send_response(200)
                self.send_header("Content-Type", "text/html")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                return body
            self.send_response(404)
            self.send_header("Content-Length", "0")
            self.end_headers()
            return None

        def do_HEAD(self):  # noqa: N802
            self._respond()

        def do_GET(self):  # noqa: N802
            body = self._respond()
            if body:
                self.wfile.write(body)

    httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _Autoindex)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        url = f"http://127.0.0.1:{httpd.server_address[1]}/ds"
        for fsys in (thttp.HttpFS(), jhttp.HttpFS()):
            assert not fsys.isfile(url)
            assert fsys.isdir(url)
            assert fsys.listdir(url) == ["shard.tfrecord"]
    finally:
        httpd.shutdown()
        httpd.server_close()
        t.join(5)


def test_real_connection_refused_is_prompt_oserror(tmp_path):
    with thttp.serve_directory(str(tmp_path)) as srv:
        dead = srv.url_for("nothing.bin")
    t0 = time.monotonic()
    with pytest.raises(OSError):
        with thttp.HttpFS().open(dead, "rb") as fh:
            fh.read(1)
    assert time.monotonic() - t0 < 5.0


def test_install_chaos_points_the_connect_seam_and_restores(servers):
    url = servers["port"].url_for("ds/part-b.bin")
    plan = TPlan([TRule(op="connect", kind="transient_error", times=1)])
    assert thttp._CHAOS_PLAN is None
    with t_install_chaos(plan):
        assert thttp._CHAOS_PLAN is plan
        with pytest.raises(OSError, match="injected"):
            with thttp.HttpFS().open(url, "rb") as fh:
                fh.read(1)
        with thttp.HttpFS().open(url, "rb") as fh:  # healed: times=1
            assert len(fh.read(10)) == 10
    assert thttp._CHAOS_PLAN is None
    host, port = servers["port"].address
    assert [(e["op"], e["path"], e["kind"]) for e in plan.ledger] == [
        ("connect", f"{host}:{port}", "transient_error")]


# -- the same fault ledger on both servers ------------------------------------------


LEDGER_RULES = {
    "reset": dict(kind="reset", cap_bytes=64),
    "truncated_body": dict(kind="truncated_body", cap_bytes=512),
    "http_error": dict(kind="http_error", status=503, retry_after_s=0.001),
    "bad_content_range": dict(kind="bad_content_range", shift_bytes=32),
    "trickle": dict(kind="trickle", stall_ms=1, cap_bytes=4096),
    "stall": dict(kind="stall", stall_ms=20),
    "transient_error": dict(kind="transient_error"),
}


def read_exact(fh, n: int) -> bytes:
    """``n`` bytes, or fewer at the end: a read may return a short part."""
    parts = []
    while n > 0:
        chunk = fh.read(n)
        if not chunk:
            break
        parts.append(chunk)
        n -= len(chunk)
    return b"".join(parts)


def drive(srv, spec: dict, side: str):
    """The access pattern of the ledger checks, through the port's client:
    a self-healing full read of part-a, two reads of part-b at 4096 and
    the start of sub/part-c; returns (the plan, what was read)."""
    plan = SIDES[side].Plan.from_json(spec)
    srv.set_plan(plan)
    got = []
    fsys = thttp.HttpFS()
    with tfs.RetryingReadStream(fsys, srv.url_for("ds/part-a.bin"), fast("port", 4)) as fh:
        got.append(fh.read())
    for _ in range(2):
        with tfs.RetryingReadStream(fsys, srv.url_for("ds/part-b.bin"), fast("port", 4)) as fh:
            fh.seek(4096)
            got.append(read_exact(fh, 1000))
    with tfs.RetryingReadStream(fsys, srv.url_for("ds/sub/part-c.bin"), fast("port", 4)) as fh:
        got.append(read_exact(fh, 100))
    srv.set_plan(None)
    return plan, got


@pytest.mark.parametrize("kind", sorted(LEDGER_RULES))
def test_same_plan_same_ledger_on_both_servers(tree, clean, kind):
    _, data = tree
    rules = [dict(op="http", path="part-a.bin", times=1, **LEDGER_RULES[kind]),
             dict(op="http", path="part-b.bin@4096", ordinal=1, times=1, **LEDGER_RULES[kind])]
    spec = TPlan([TRule(**r) for r in rules], seed=7).to_json()
    assert spec == JPlan([JRule(**r) for r in rules], seed=7).to_json()
    runs = {}
    for side, srv in clean.items():
        before = (srv.request_count, srv.get_count, srv.file_get_count)
        plan, got = drive(srv, spec, side)
        after = (srv.request_count, srv.get_count, srv.file_get_count)
        runs[side] = (plan.ledger_json(), got, [a - b for a, b in zip(after, before)])
    assert runs["port"] == runs["jax"]
    ledger, got, _ = runs["port"]
    assert ledger.count("\n") == 1  # one event a rule
    assert got[0] == data["ds/part-a.bin"]
    assert got[1] == got[2] == data["ds/part-b.bin"][4096:5096]
    assert got[3] == data["ds/sub/part-c.bin"][:100]


def test_truncated_body_resumes_at_the_exact_offset_on_both_servers(tree, clean):
    """A truncation is a clean FIN: exactly cap_bytes arrive, so the
    retried request is keyed at the byte the body broke off at."""
    _, data = tree
    for side, srv in clean.items():
        plan = SIDES[side].Plan([SIDES[side].Rule(op="http", kind="truncated_body",
                                                  path="part-a.bin", cap_bytes=512, times=1)])
        srv.set_plan(plan)
        TMETRICS.reset()
        with tfs.open_for_read(thttp.HttpFS(), srv.url_for("ds/part-a.bin"),
                               retry_policy=fast("port", 2)) as fh:
            assert isinstance(fh, tfs.RetryingReadStream)  # below the prefetch bar
            assert fh.read() == data["ds/part-a.bin"]
        assert TMETRICS.counter("remote.fetch_retries") == 1
        assert ("http", "/ds/part-a.bin@512") in plan._calls, sorted(plan._calls)


# -- the self-heal matrix, the port's fs against the JAX one -------------------------


def prefetch_read(side, url, policy, monkeypatch, depth=4, nbytes=-1):
    monkeypatch.setenv("TFR_REMOTE_BLOCK_BYTES", str(BLOCK))
    monkeypatch.setenv("TFR_REMOTE_PREFETCH_DEPTH", str(depth))
    sf = SIDES[side].fs
    fh = sf.open_for_read(sf.filesystem_for(url), url, retry_policy=policy)
    assert isinstance(fh, sf.PrefetchReader)
    with fh:
        return fh.read(nbytes)


def heal(side, servers, rules, policy, monkeypatch, **kw):
    """One prefetched read of big.bin through ``side``'s fs against
    ``side``'s server under ``rules``: (payload or the error's type name,
    fetch retries, read retries, sorted ledger lines, requests seen)."""
    s = SIDES[side]
    srv = servers[side]
    plan = s.Plan([s.Rule(**r) for r in rules], seed=3)
    srv.set_plan(plan)
    s.metrics.reset()
    try:
        got = prefetch_read(side, srv.url_for("big.bin"), policy, monkeypatch, **kw)
    except OSError as e:
        got = type(e).__name__
    srv.set_plan(None)
    return (got, s.metrics.counter("remote.fetch_retries"), s.metrics.counter("read.retries"),
            sorted(plan.ledger_json().splitlines()), sorted(k for k in plan._calls))


def test_reset_mid_block_resumes(tree, clean, monkeypatch):
    _, data = tree
    rules = [dict(op="http", kind="reset", path="@131072", cap_bytes=1000, times=1),
             dict(op="http", kind="reset", path="@524288", cap_bytes=5000, times=1)]
    port = heal("port", clean, rules, fast("port", 3), monkeypatch)
    ref = heal("jax", clean, rules, fast("jax", 3), monkeypatch)
    assert port[0] == ref[0] == data["big.bin"]
    assert port[1] == ref[1] == port[2] == 2  # one retry a reset, on both sides
    assert port[3] == ref[3] and len(port[3]) == 2


def test_truncated_block_resumes_at_the_exact_offset(tree, clean, monkeypatch):
    _, data = tree
    rules = [dict(op="http", kind="truncated_body", path="@262144", cap_bytes=4096, times=1)]
    port = heal("port", clean, rules, fast("port", 2), monkeypatch)
    ref = heal("jax", clean, rules, fast("jax", 2), monkeypatch)
    assert port[0] == data["big.bin"] and port[:4] == ref[:4]
    assert port[1] == 1
    # the retry re-ranged from the byte the body broke off at
    assert ("http", "/big.bin@266240") in port[4]
    assert port[4] == ref[4]


def test_retry_after_goes_through_the_sleep_seam(tree, clean, monkeypatch):
    _, data = tree
    rules = [dict(op="http", kind="http_error", path="@0", status=429, retry_after_s=0.25,
                  times=1)]
    slept = {}
    for side in SIDES:
        slept[side] = []
        pol = SIDES[side].Policy(max_retries=2, sleep=slept[side].append, jitter=False,
                                 base_delay=0.0)
        assert heal(side, clean, rules, pol, monkeypatch)[0] == data["big.bin"]
    assert slept["port"] == slept["jax"] == [0.25]  # the server's hint, not a backoff


@pytest.mark.parametrize("deadline", [None, 5.0])
def test_retry_after_is_capped_by_the_cap_and_the_deadline(tree, clean, monkeypatch, deadline):
    """A hostile Retry-After (86400 s) parks no reader: the hint is clamped
    to ``_RETRY_AFTER_CAP_S`` and to the policy's remaining deadline."""
    _, data = tree
    assert tfs._RETRY_AFTER_CAP_S == jfs._RETRY_AFTER_CAP_S == 30.0
    rules = [dict(op="http", kind="http_error", path="@0", status=429, retry_after_s=86400,
                  times=1)]
    slept = {}
    for side in SIDES:
        slept[side] = []
        pol = SIDES[side].Policy(max_retries=3, deadline=deadline, jitter=False, base_delay=0.0,
                                 sleep=slept[side].append, clock=lambda: 0.0)
        assert heal(side, clean, rules, pol, monkeypatch)[0] == data["big.bin"]
    assert slept["port"] == slept["jax"] == [30.0 if deadline is None else deadline]


def test_budget_exhausted_raises(clean, monkeypatch):
    rules = [dict(op="http", kind="reset", path="@0", cap_bytes=100, times=None)]
    port = heal("port", clean, rules, fast("port", 1), monkeypatch)
    ref = heal("jax", clean, rules, fast("jax", 1), monkeypatch)
    assert port[0] in ("ConnectionResetError", "OSError") and ref[0] in (
        "ConnectionResetError", "OSError")
    assert port[1] == ref[1] == 1


def prefetch_threads():
    return [t.name for t in threading.enumerate()
            if t.name.startswith("tfr-prefetch") and t.is_alive()]


def test_close_leaves_no_live_fetch_threads(tree, clean, monkeypatch):
    _, data = tree
    assert prefetch_read("port", clean["port"].url_for("big.bin"), None, monkeypatch,
                         nbytes=1024) == data["big.bin"][:1024]
    assert prefetch_threads() == []


def test_close_waits_for_the_inflight_fetch(tree, clean, monkeypatch):
    """A fetch in flight when ``close`` is called is joined before it
    returns, not left holding a handle."""
    _, data = tree
    srv = clean["port"]
    srv.set_latency(0.05)  # every request answers late: fetches in flight
    monkeypatch.setenv("TFR_REMOTE_BLOCK_BYTES", str(BLOCK))
    monkeypatch.setenv("TFR_REMOTE_PREFETCH_DEPTH", "4")
    url = srv.url_for("big.bin")
    fh = tfs.open_for_read(tfs.filesystem_for(url), url)
    assert fh.read(1) == data["big.bin"][:1]
    fh.close()
    assert fh.closed and prefetch_threads() == []


def test_close_timeout_env_bounds_the_wait(clean, monkeypatch):
    """``TFR_REMOTE_CLOSE_TIMEOUT_S`` bounds the join: a fetch wedged in a
    stalled server is abandoned, not waited out."""
    srv = clean["port"]
    plan = TPlan([TRule(op="http", kind="stall", path="@131072", stall_ms=30_000, times=1)])
    srv.set_plan(plan)
    monkeypatch.setenv("TFR_REMOTE_BLOCK_BYTES", str(BLOCK))
    monkeypatch.setenv("TFR_REMOTE_PREFETCH_DEPTH", "2")
    monkeypatch.setenv("TFR_REMOTE_CLOSE_TIMEOUT_S", "0.2")
    url = srv.url_for("big.bin")
    try:
        fh = tfs.open_for_read(tfs.filesystem_for(url), url)
        fh.read(10)
        deadline = time.monotonic() + 5
        while not plan.ledger and time.monotonic() < deadline:
            time.sleep(0.01)
        assert plan.ledger  # the second block's request is stalled now
        t0 = time.monotonic()
        fh.close()
        assert time.monotonic() - t0 < 2.0
    finally:
        plan.release()
    deadline = time.monotonic() + 5
    while prefetch_threads() and time.monotonic() < deadline:
        time.sleep(0.01)
    assert prefetch_threads() == []


# -- RetryingReadStream: objects below the prefetch bar ----------------------------


def test_small_object_reads_self_heal_below_the_prefetch_bar(tree, clean):
    _, data = tree
    runs = {}
    for side in SIDES:
        s, srv = SIDES[side], clean[side]
        plan = s.Plan([s.Rule(op="http", kind="truncated_body", path="part-a.bin",
                              cap_bytes=512, times=1)])
        srv.set_plan(plan)
        s.metrics.reset()
        url = srv.url_for("ds/part-a.bin")
        fh = s.fs.open_for_read(s.fs.filesystem_for(url), url, retry_policy=fast(side, 2))
        assert isinstance(fh, s.fs.RetryingReadStream)  # the default 8 MiB block
        with fh:
            got = fh.read()
        runs[side] = (got == data["ds/part-a.bin"], s.metrics.counter("remote.fetch_retries"),
                      ("http", "/ds/part-a.bin@512") in plan._calls, plan.ledger_json())
    assert runs["port"] == runs["jax"] == (True, 1, True, runs["jax"][3])


def test_open_fault_during_retry_spends_the_budget(tree, clean):
    """A refused reconnect inside the stream's retry spends the same budget
    as a read fault instead of escaping it."""
    _, data = tree
    runs = {}
    for side in SIDES:
        s, srv = SIDES[side], clean[side]
        plan = s.Plan([
            s.Rule(op="http", kind="truncated_body", path="part-a.bin", cap_bytes=256, times=1),
            s.Rule(op="connect", kind="transient_error", ordinal=1, times=1),
        ])
        srv.set_plan(plan)
        s.metrics.reset()
        url = srv.url_for("ds/part-a.bin")
        with s.chaos(plan):
            fsys = s.fs.filesystem_for(url)
            with s.fs.open_for_read(fsys, url, retry_policy=fast(side, 3)) as fh:
                got = fh.read()
        runs[side] = (got == data["ds/part-a.bin"], s.metrics.counter("remote.fetch_retries"),
                      sorted(e["kind"] for e in plan.ledger))
    assert runs["port"] == runs["jax"] == (True, 2, ["transient_error", "truncated_body"])


def test_retrying_stream_seeks_like_jax(tree, clean):
    _, data = tree
    payload = data["ds/part-b.bin"]
    url = clean["port"].url_for("ds/part-b.bin")
    seen = {}
    for side in SIDES:
        sf = SIDES[side].fs
        with sf.RetryingReadStream(sf.filesystem_for(url), url, fast(side, 1)) as fh:
            out = [fh.read(100), fh.seek(50, 1), fh.read(10), fh.tell(), fh.seek(-20, 2),
                   fh.read(), fh.seek(7), bytearray(5)]
            out.append(fh.readinto(out[-1]))
            out.append(fh.closed)
        out.append(fh.closed)
        seen[side] = out
    assert seen["port"] == seen["jax"]
    assert seen["port"][0] == payload[:100] and seen["port"][2] == payload[150:160]
    assert seen["port"][5] == payload[-20:] and bytes(seen["port"][7]) == payload[7:12]


# -- open_for_read's knobs ------------------------------------------------------------


def test_open_for_read_engagement_and_env_knobs(tree, clean, monkeypatch):
    """Prefetch for an object of two blocks or more, a plain handle below
    (or at depth 0), ``TFR_REMOTE_FETCH_RETRIES`` as the default budget:
    the same choices as the JAX ``open_for_read``."""
    _, data = tree
    url = clean["port"].url_for("big.bin")
    cases = [({}, None), ({"TFR_REMOTE_BLOCK_BYTES": str(BLOCK)}, None),
             ({"TFR_REMOTE_BLOCK_BYTES": str(BLOCK), "TFR_REMOTE_PREFETCH_DEPTH": "0"}, None),
             ({"TFR_REMOTE_FETCH_RETRIES": "3"}, None),
             ({"TFR_REMOTE_BLOCK_BYTES": str(BLOCK)}, 2)]
    for env, retries in cases:
        for k in ("TFR_REMOTE_BLOCK_BYTES", "TFR_REMOTE_PREFETCH_DEPTH",
                  "TFR_REMOTE_FETCH_RETRIES"):
            monkeypatch.delenv(k, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        assert tfs._remote_prefetch_params() == jfs._remote_prefetch_params()
        t_pol, j_pol = tfs._default_fetch_retry_policy(), jfs._default_fetch_retry_policy()
        assert (t_pol is None) == (j_pol is None)
        if t_pol is not None:
            assert t_pol.max_retries == j_pol.max_retries == 3
        kinds = []
        for side in SIDES:
            sf = SIDES[side].fs
            pol = fast(side, retries) if retries else None
            with sf.open_for_read(sf.filesystem_for(url), url, retry_policy=pol) as fh:
                kinds.append(type(fh).__name__)
                assert fh.read() == data["big.bin"]
        assert kinds[0] == kinds[1], (env, kinds)


@pytest.mark.parametrize("retry_after", [None, 0.0, 0.1, 100.0, 86400.0])
@pytest.mark.parametrize("deadline", [None, 1.0])
def test_grant_retry_matches_jax(retry_after, deadline):
    """``_grant_retry`` on a policy with recording seams: the same grants,
    sleeps and counters as the JAX one, up to an exhausted budget."""
    seen = {}
    for side in SIDES:
        s = SIDES[side]
        slept = []
        pol = s.Policy(max_retries=2, deadline=deadline, jitter=False, base_delay=0.0,
                       sleep=slept.append, clock=lambda: 0.25)
        exc = s.http.HTTPStatusError("x", status=503, retry_after=retry_after)
        s.metrics.reset()
        grants = [s.fs._grant_retry(pol, attempt, 0.0, exc) for attempt in (1, 2, 3)]
        seen[side] = (grants, slept, s.metrics.counter("remote.fetch_retries"),
                      s.metrics.counter("read.retries"))
    assert seen["port"] == seen["jax"]
    assert seen["port"][0] == [True, True, False] and seen["port"][2] == 2
