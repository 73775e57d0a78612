"""The port's dataset over HTTP against the JAX package's, on real
localhost sockets: a Range server (the port's ``httpfs.serve_directory``)
fronts shards the JAX writer wrote, and a seeded ``FaultPlan`` fires at
the server side of the socket (resets, truncated bodies, 503/429 with
``Retry-After``, stalls, trickles, shifted ``Content-Range``) or at the
client's connect (refused). The cases of ``tests/test_http_remote.py``:

- discovery, inference and the row reader over ``http://`` equal the
  local read and the JAX read of the same URL;
- the fault matrix, every fault kind x {strict, prefetch, salvage,
  cached}: a port ``TFRecordDataset`` over the URL gives the ids and
  positions of a JAX ``TFRecordDataset`` over the same URL and of the
  local read, the same ledger and the same ``remote.*`` / ``read.retries``
  counters; a shifted ``Content-Range`` without retries raises
  ``BadContentRangeError`` before any row;
- the read knobs on a URL: shuffle, resume positions, the pool,
  ``on_corrupt``, ``read_retries``; no mmap and no fadvise on a URL;
- the stall guard over real sockets: a read deadline converts a server
  stall, a hedge wins against a stalled connection;
- remote into the cache: the link is paid once, the entries equal the JAX
  cache's byte for byte, a ``kill -9`` mid-populate resumes valid or
  bypassed, never wrong;
- the slice as a whole: a small DLRM scores batches read over HTTP
  (``entry.score_files``) and matches the JAX DLRM (its Pallas
  interaction in interpret mode) on the batches JAX read over the same
  URL.
"""

import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import tpu_tfrecord.io as jio  # noqa: E402
from tpu_tfrecord.faults import FaultPlan as JPlan  # noqa: E402
from tpu_tfrecord.faults import FaultRule as JRule  # noqa: E402
from tpu_tfrecord.faults import install_chaos as j_install_chaos  # noqa: E402
from tpu_tfrecord.io.dataset import IteratorState as JState  # noqa: E402
from tpu_tfrecord.io.dataset import TFRecordDataset as JDataset  # noqa: E402
from tpu_tfrecord.metrics import METRICS as JMETRICS  # noqa: E402
from tpu_tfrecord.models import dlrm as jdlrm  # noqa: E402
from tpu_tfrecord.models import interaction as jinter  # noqa: E402
from tpu_tfrecord.retry import RetryPolicy as JPolicy  # noqa: E402
from tpu_tfrecord.schema import LongType as JLong  # noqa: E402
from tpu_tfrecord.schema import StringType as JString  # noqa: E402
from tpu_tfrecord.schema import StructField as JField  # noqa: E402
from tpu_tfrecord.schema import StructType as JStruct  # noqa: E402
from tpu_tfrecord.tpu.ingest import host_batch_from_columnar as j_hbfc  # noqa: E402

import tpu_tfrecord_torch.io as tio  # noqa: E402
from tpu_tfrecord_torch import cache as tcache  # noqa: E402
from tpu_tfrecord_torch import httpfs  # noqa: E402
from tpu_tfrecord_torch import interop  # noqa: E402
from tpu_tfrecord_torch.entry import score_files, write_dryrun_dataset  # noqa: E402
from tpu_tfrecord_torch.faults import FaultPlan, FaultRule, install_chaos  # noqa: E402
from tpu_tfrecord_torch.io import dataset as tdataset  # noqa: E402
from tpu_tfrecord_torch.io.dataset import IteratorState, TFRecordDataset  # noqa: E402
from tpu_tfrecord_torch.metrics import METRICS  # noqa: E402
from tpu_tfrecord_torch.models import dlrm as tdlrm  # noqa: E402
from tpu_tfrecord_torch.retry import RetryPolicy  # noqa: E402
from tpu_tfrecord_torch.schema import LongType, StringType, StructField, StructType  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCHEMA = StructType([StructField("id", LongType(), nullable=False),
                     StructField("s", StringType())])
JSCHEMA = JStruct([JField("id", JLong(), nullable=False), JField("s", JString())])
N_SHARDS = 3
# 64 KiB blocks engage the prefetcher (size >= 2 blocks): ~140 KiB a shard
ROWS_PER_SHARD = 1200
PREFETCH_ENV = {"TFR_REMOTE_BLOCK_BYTES": str(64 << 10), "TFR_REMOTE_PREFETCH_DEPTH": "4"}
COUNTERS = ("remote.fetch_retries", "remote.bad_range", "read.retries",
            "read.corrupt_records")


def fast(n, side="port", **kw):
    return (RetryPolicy if side == "port" else JPolicy)(max_retries=n, sleep=lambda _s: None,
                                                        **kw)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """(server, dataset url, local dataset dir, shard names in read order)."""
    root = tmp_path_factory.mktemp("httpds")
    out = os.path.join(str(root), "ds")
    for s in range(N_SHARDS):
        jio.write([[i, f"val{i}" + "x" * (80 + i % 40)]
                   for i in range(s * ROWS_PER_SHARD, (s + 1) * ROWS_PER_SHARD)],
                  JSCHEMA, out, mode="append" if s else "overwrite")
    names = sorted(n for n in os.listdir(out) if n.startswith("part-"))
    with httpfs.serve_directory(str(root)) as srv:
        yield srv, srv.url_for("ds"), out, names


@pytest.fixture
def clean(served):
    srv = served[0]
    srv.set_plan(None)
    yield srv
    srv.set_plan(None)


def port_read(source, **kw):
    """[(ids, state json)] of a port read, one a batch."""
    kw.setdefault("batch_size", 16)
    kw.setdefault("drop_remainder", False)
    state = kw.pop("state", None)
    ds = TFRecordDataset(source, schema=SCHEMA, **kw)
    with ds.batches(state) as it:
        return [(cb["id"].values.tolist(), it.state().to_json()) for cb in it]


def jax_read(source, **kw):
    kw.setdefault("batch_size", 16)
    kw.setdefault("drop_remainder", False)
    ds = JDataset(source, schema=JSCHEMA, **kw)
    with ds.batches() as it:
        return [(cb["id"].values.tolist(), it.state().to_json()) for cb in it]


def ids_of(batches):
    return [i for ids, _ in batches for i in ids]


def positions(batches):
    return [{k: v for k, v in st.items() if k != "fingerprint"} for _, st in batches]


@pytest.fixture(scope="module")
def local(served):
    batches = port_read(served[2])
    assert sorted(ids_of(batches)) == list(range(N_SHARDS * ROWS_PER_SHARD))
    return batches


# -- discovery, inference, the row reader ---------------------------------------------


def test_discovery_matches_local_and_jax(served):
    _, url, out, names = served
    remote = tio.discover_shards(url)
    assert [s.path.rsplit("/", 1)[-1] for s in remote] == names
    assert [s.size for s in remote] == [s.size for s in tio.discover_shards(out)]
    assert [(s.path, s.size) for s in remote] == [(s.path, s.size)
                                                  for s in jio.discover_shards(url)]
    assert tio.discover_shards(f"{url}/{names[1]}")[0].size == remote[1].size


def test_inference_and_row_reader_over_http(served, clean):
    _, url, out, _ = served
    assert tio.reader(url).infer_schema_all_files().json() == \
        jio.reader(url).infer_schema_all_files().json() == \
        tio.reader(out).infer_schema_all_files().json()
    assert tio.reader(url).schema().json() == jio.reader(url).schema().json()
    table = tio.read(url, schema=SCHEMA)
    assert table.rows == jio.read(url, schema=JSCHEMA).rows == tio.read(out, schema=SCHEMA).rows
    assert sorted(table.column("id")) == list(range(N_SHARDS * ROWS_PER_SHARD))
    assert tio.read(url).schema.names == ["id", "s"]  # inferred over the link


def test_clean_epoch_equals_local_and_jax(served, local, clean):
    _, url, _, _ = served
    port = port_read(url)
    assert port == jax_read(url)
    assert ids_of(port) == ids_of(local) and positions(port) == positions(local)


def test_redirected_dataset_reads_like_metadata(served, local, clean):
    """A CDN-offload-shaped 302: the data reads follow it as discovery does."""
    srv = served[0]
    assert ids_of(port_read(srv.url_for("redirect/ds"))) == ids_of(local)


# -- the fault-kind x read-mode matrix --------------------------------------------------


READ_MODES = {
    "strict": {},
    "prefetch": {},  # the block pipeline, engaged through PREFETCH_ENV
    "salvage": {"on_corrupt": "skip_record"},
    "cached": {"cache": "auto"},
}
FAULT_KINDS = ["refused", "reset", "truncated", "status_503", "stall", "trickle",
               "bad_content_range"]


def fault_rules(kind, names):
    """Rules of one kind against the first request (byte 0) of shards 0 and
    1, so that concurrent block fetches fire the same faults every run."""
    a, b = names[0] + "@0", names[1] + "@0"
    return {
        "refused": [dict(op="connect", kind="transient_error", times=2)],
        "reset": [dict(op="http", kind="reset", path=a, cap_bytes=64, times=1),
                  dict(op="http", kind="reset", path=b, cap_bytes=256, times=1)],
        "truncated": [dict(op="http", kind="truncated_body", path=a, cap_bytes=100, times=1)],
        "status_503": [dict(op="http", kind="http_error", path=a, status=503,
                            retry_after_s=0.001, times=1),
                       dict(op="http", kind="http_error", path=b, status=429,
                            retry_after_s=0.001, times=1)],
        "stall": [dict(op="http", kind="stall", path=a, stall_ms=60, times=1)],
        "trickle": [dict(op="http", kind="trickle", path=a, stall_ms=1, cap_bytes=512,
                         times=1)],
        "bad_content_range": [dict(op="http", kind="bad_content_range", path=a,
                                   shift_bytes=32, times=1)],
    }[kind]


def fault_setup(side, spec, kind, mode, tmp_path):
    """``side``'s fresh plan from ``spec``, the plan the server runs (none
    for the client-side ``refused``), its metrics (reset) and the read's
    keyword arguments."""
    plan = (FaultPlan if side == "port" else JPlan).from_json(spec)
    metrics = METRICS if side == "port" else JMETRICS
    kw = dict(READ_MODES[mode], retry_policy=fast(4, side))
    if mode == "cached":
        kw["cache_dir"] = str(tmp_path / f"cache-{side}")
    metrics.reset()
    return plan, (None if kind == "refused" else plan), metrics, kw


@pytest.mark.parametrize("mode", sorted(READ_MODES))
@pytest.mark.parametrize("kind", FAULT_KINDS)
def test_fault_heals_byte_identical_and_equal_to_jax(served, local, clean, monkeypatch,
                                                     tmp_path, kind, mode):
    srv, url, _, names = served
    spec = FaultPlan([FaultRule(**r) for r in fault_rules(kind, names)], seed=11).to_json()
    if mode == "prefetch":
        for k, v in PREFETCH_ENV.items():
            monkeypatch.setenv(k, v)
    runs = {}
    for side in ("port", "jax"):
        plan, served_plan, metrics, kw = fault_setup(side, spec, kind, mode, tmp_path)
        srv.set_plan(served_plan)
        dataset = TFRecordDataset if side == "port" else JDataset
        # constructed before any chaos: discovery's connects stay clean
        ds = dataset(url, batch_size=16, schema=SCHEMA if side == "port" else JSCHEMA,
                     drop_remainder=False, **kw)
        chaos = install_chaos if side == "port" else j_install_chaos
        with chaos(plan) if kind == "refused" else _nothing():
            with ds.batches() as it:
                got = [(cb["id"].values.tolist(), it.state().to_json()) for cb in it]
        srv.set_plan(None)
        runs[side] = (got, sorted(plan.ledger_json().splitlines()),
                      {c: metrics.counter(c) for c in COUNTERS})
    port, ref = runs["port"], runs["jax"]
    assert ids_of(port[0]) == ids_of(local), f"{kind} x {mode}: rows differ from local"
    assert positions(port[0]) == positions(local)
    assert port[0] == ref[0], f"{kind} x {mode}: batches or positions differ from JAX"
    assert port[1] and port[1] == ref[1], f"{kind} x {mode}: ledgers differ"
    assert port[2] == ref[2], f"{kind} x {mode}: counters differ"
    if kind == "bad_content_range":
        assert port[2]["remote.bad_range"] >= 1  # detected, not absorbed as shifted data
    if kind not in ("refused", "stall", "trickle"):  # a refused HEAD may only cost a stamp
        assert port[2]["remote.fetch_retries"] + port[2]["read.retries"] >= 1


class _nothing:
    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


@pytest.mark.parametrize("prefetch", [False, True], ids=["plain", "prefetch"])
def test_bad_content_range_without_retries_raises_before_any_row(served, clean, monkeypatch,
                                                                 prefetch):
    srv, url, _, names = served
    if prefetch:
        for k, v in PREFETCH_ENV.items():
            monkeypatch.setenv(k, v)
    for side in ("port", "jax"):
        rule = dict(op="http", kind="bad_content_range", path=names[0], shift_bytes=32,
                    times=None)
        srv.set_plan(FaultPlan([FaultRule(**rule)]) if side == "port"
                     else JPlan([JRule(**rule)]))
        metrics = METRICS if side == "port" else JMETRICS
        metrics.reset()
        seen = []
        dataset = TFRecordDataset if side == "port" else JDataset
        ds = dataset(url, batch_size=16, schema=SCHEMA if side == "port" else JSCHEMA,
                     drop_remainder=False)
        with pytest.raises(OSError) as err:
            with ds.batches() as it:
                for cb in it:
                    seen.append(cb.num_rows)
        if side == "port":
            assert isinstance(err.value, httpfs.BadContentRangeError), repr(err.value)
        assert seen == []  # never a row from shifted bytes
        assert metrics.counter("remote.bad_range") >= 1
    srv.set_plan(None)


def test_permanent_fault_exhausts_retries_loudly(served, clean):
    srv, url, _, names = served
    srv.set_plan(FaultPlan([FaultRule(op="http", kind="http_error", path=names[0],
                                      status=503, times=None)]))
    with pytest.raises(httpfs.HTTPStatusError) as err:
        port_read(url, retry_policy=fast(2))
    assert err.value.status == 503


def test_ledger_replay_deterministic_and_equal_to_jax(served, local, clean):
    """The same plan and the same (sequential) access pattern fire the same
    ledger, run after run and package against package."""
    srv, url, _, names = served
    rules = [dict(op="http", kind="truncated_body", path=names[0], cap_bytes=128, times=1),
             dict(op="http", kind="http_error", path=names[1], status=503, times=1),
             dict(op="http", kind="stall", path=names[2], stall_ms=10, times=1)]
    spec = FaultPlan([FaultRule(**r) for r in rules], seed=5).to_json()
    ledgers = []
    for side in ("port", "port", "jax"):
        plan = (FaultPlan if side == "port" else JPlan).from_json(spec)
        srv.set_plan(plan)
        read = port_read if side == "port" else jax_read
        got = read(url, retry_policy=fast(4, side))
        assert ids_of(got) == ids_of(local)
        ledgers.append(plan.ledger_json())
    assert ledgers[0] == ledgers[1] == ledgers[2]
    assert [json.loads(line)["kind"] for line in ledgers[0].splitlines()] == [
        "truncated_body", "http_error", "stall"]  # one event a shard, in shard order


# -- the read knobs on a URL ------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(shuffle=True, seed=3),
    dict(shuffle=True, seed=5, shuffle_window=4),
    dict(num_workers=3),
    dict(num_workers=2, prefetch=1, use_mmap=False, slab_bytes=1 << 16),
    dict(num_epochs=2, batch_size=500),
], ids=["shuffle", "shuffle_window", "pool", "stream_knobs", "two_epochs"])
def test_read_knobs_over_http_equal_jax(served, clean, kw):
    _, url, out, _ = served
    port = port_read(url, **kw)
    assert port == jax_read(url, **kw)
    assert ids_of(port) == ids_of(port_read(out, **kw))


def test_resume_positions_over_http(served, local, clean):
    """A state taken over the URL resumes a new dataset on the URL to the
    uninterrupted batches, from either package's state."""
    _, url, _, _ = served
    whole = port_read(url)
    for cut in (3, 80, len(whole) - 1):
        state = IteratorState.from_json(whole[cut - 1][1])
        assert port_read(url, state=state) == whole[cut:]
        jstate = JState.from_json(whole[cut - 1][1])
        assert IteratorState.from_json(jstate.to_json()) == state
    assert ids_of(whole) == ids_of(local)


def test_no_mmap_and_no_fadvise_on_a_url(served, local, clean, monkeypatch):
    """The native decoder's mmap route and the readahead hinter never see a
    URL: over HTTP the stream route runs, with no ``posix_fadvise``."""
    _, url, out, _ = served
    opened, advised = [], []
    real_open, real_advise = tdataset._open_local, os.posix_fadvise
    monkeypatch.setattr(tdataset, "_open_local",
                        lambda p, mode: (opened.append(p), real_open(p, mode))[1])
    monkeypatch.setattr(os, "posix_fadvise",
                        lambda fd, off, n, adv: (advised.append(n), real_advise(fd, off, n, adv))[1])
    assert ids_of(port_read(url, use_mmap=True, readahead_bytes=64 << 20)) == ids_of(local)
    assert opened == [] and advised == []
    port_read(out, use_mmap=True, readahead_bytes=64 << 20)  # the local read does both
    assert len(opened) == N_SHARDS and advised


def test_read_retries_spelling_heals_over_http(served, local, clean):
    srv, url, _, names = served
    plan = FaultPlan([FaultRule(op="http", kind="truncated_body", path=names[1],
                                cap_bytes=300, times=1)])
    srv.set_plan(plan)
    METRICS.reset()
    assert ids_of(port_read(url, read_retries=3)) == ids_of(local)
    assert plan.ledger and METRICS.counter("remote.fetch_retries") == 1


@pytest.fixture(scope="module")
def corrupt_served(tmp_path_factory):
    """A dataset of 3 shards whose middle shard has one payload byte flipped."""
    root = tmp_path_factory.mktemp("httpcorrupt")
    out = os.path.join(str(root), "ds")
    for s in range(3):
        jio.write([[i, f"v{i}"] for i in range(s * 200, (s + 1) * 200)], JSCHEMA, out,
                  mode="append" if s else "overwrite")
    names = sorted(n for n in os.listdir(out) if n.startswith("part-"))
    path = os.path.join(out, names[1])
    blob = bytearray(open(path, "rb").read())
    blob[len(blob) // 2] ^= 0xFF
    with open(path, "wb") as fh:
        fh.write(bytes(blob))
    with httpfs.serve_directory(str(root)) as srv:
        yield srv.url_for("ds"), out


@pytest.mark.parametrize("mode", ["skip_record", "skip_shard"])
def test_on_corrupt_over_http_equals_jax(corrupt_served, mode):
    url, out = corrupt_served
    runs = {}
    for side in ("port", "jax"):
        metrics = METRICS if side == "port" else JMETRICS
        metrics.reset()
        read = port_read if side == "port" else jax_read
        got = read(url, on_corrupt=mode)
        runs[side] = (got, {c: metrics.counter(c) for c in ("read.corrupt_records",
                                                            "read.skipped_shards")})
    assert runs["port"] == runs["jax"]
    assert ids_of(runs["port"][0]) == ids_of(port_read(out, on_corrupt=mode))
    assert 0 < len(ids_of(runs["port"][0])) < 600
    with pytest.raises(Exception):
        port_read(url)  # the strict default raises


# -- the stall guard over real sockets ------------------------------------------------


def test_read_deadline_converts_a_server_stall(served, local, clean):
    srv, url, _, names = served
    plan = FaultPlan([FaultRule(op="http", kind="stall", path=names[0], stall_ms=60_000,
                                times=1)])
    srv.set_plan(plan)
    METRICS.reset()
    try:
        got = port_read(url, read_deadline_ms=200, retry_policy=fast(2))
    finally:
        plan.release()
    assert ids_of(got) == ids_of(local)
    assert METRICS.counter("read.deadline_misses") >= 1


def test_hedge_wins_against_a_stalled_connection(served, local, clean):
    srv, url, _, names = served
    plan = FaultPlan([FaultRule(op="http", kind="stall", path=names[0] + "@0",
                                stall_ms=60_000, times=1)])
    srv.set_plan(plan)
    METRICS.reset()
    try:
        got = port_read(url, hedge_after_ms=150)
    finally:
        plan.release()
    assert ids_of(got) == ids_of(local)
    assert METRICS.counter("read.hedges") >= 1
    assert METRICS.counter("read.hedge_wins") >= 1


# -- remote into the cache ------------------------------------------------------------


def test_link_paid_once_per_epoch(served, local, clean, tmp_path):
    srv, url, _, _ = served
    cdir = str(tmp_path / "cache")
    assert ids_of(port_read(url, cache="auto", cache_dir=cdir)) == ids_of(local)
    gets = srv.file_get_count
    METRICS.reset()
    assert ids_of(port_read(url, cache="auto", cache_dir=cdir)) == ids_of(local)
    assert METRICS.counter("cache.hits") == N_SHARDS and METRICS.counter("cache.misses") == 0
    # no file GET in the warm epoch: dir-index GETs and HEADs are metadata
    assert srv.file_get_count == gets
    reports = list(tcache.iter_entry_reports(cdir))
    assert [r["status"] for r in reports] == ["ok"] * N_SHARDS
    assert not any("source_check" in r for r in reports)  # the remote source was checked
    tcache.release_registry(cdir)


def test_remote_entries_equal_the_jax_cache(served, clean, tmp_path):
    """The entry built from a remote source is the JAX cache's entry for the
    same URL, name and bytes; each side then serves the other's."""
    srv, url, _, _ = served
    tdir, jdir = str(tmp_path / "tc"), str(tmp_path / "jc")
    port = port_read(url, cache="auto", cache_dir=tdir)
    jds = JDataset(url, batch_size=16, schema=JSCHEMA, drop_remainder=False, cache="auto",
                   cache_dir=jdir)
    assert jds._native_decoder is not None  # entries key on the native route
    with jds.batches() as it:
        ref = [(cb["id"].values.tolist(), it.state().to_json()) for cb in it]
    assert port == ref
    names = sorted(os.listdir(tdir))
    assert names == sorted(os.listdir(jdir))
    assert len([n for n in names if n.endswith(tcache.ENTRY_SUFFIX)]) == N_SHARDS
    for n in names:
        if n.endswith(tcache.ENTRY_SUFFIX):
            assert open(os.path.join(tdir, n), "rb").read() == \
                open(os.path.join(jdir, n), "rb").read()
    gets = srv.file_get_count
    METRICS.reset()
    assert port_read(url, cache="auto", cache_dir=jdir) == port
    assert METRICS.counter("cache.hits") == N_SHARDS and srv.file_get_count == gets
    tcache.release_registry(tdir)
    tcache.release_registry(jdir)


def test_remote_source_rewritten_same_size_invalidates(tmp_path):
    """The entry's source stamp comes from the server's freshness headers:
    a same-size rewrite of the shard behind the URL misses and repopulates."""
    out = str(tmp_path / "src" / "ds")
    tio.write([[i, f"a{i:03d}"] for i in range(100)], SCHEMA, out, mode="overwrite")
    cdir = str(tmp_path / "cache")
    with httpfs.serve_directory(str(tmp_path / "src")) as srv:
        url = srv.url_for("ds")
        first = ids_of(port_read(url, cache="auto", cache_dir=cdir))
        (name,) = [n for n in os.listdir(out) if n.startswith("part-")]
        path = os.path.join(out, name)
        st = os.stat(path)
        os.utime(path, ns=(st.st_atime_ns, st.st_mtime_ns + 5_000_000_000))
        METRICS.reset()
        again = ids_of(port_read(url, cache="auto", cache_dir=cdir))
        assert again == first
        assert METRICS.counter("cache.misses") == 1 and METRICS.counter("cache.hits") == 0
    tcache.release_registry(cdir)


def test_faulted_populate_still_commits_valid_entries(served, local, clean, tmp_path):
    srv, url, _, names = served
    cdir = str(tmp_path / "cache")
    plan = FaultPlan([FaultRule(op="http", kind="reset", path=names[1], cap_bytes=64,
                                times=1)])
    srv.set_plan(plan)
    assert ids_of(port_read(url, cache="auto", cache_dir=cdir, retry_policy=fast(3))) == \
        ids_of(local)
    assert plan.ledger
    srv.set_plan(None)
    METRICS.reset()
    assert ids_of(port_read(url, cache="auto", cache_dir=cdir)) == ids_of(local)
    assert METRICS.counter("cache.hits") == N_SHARDS
    tcache.release_registry(cdir)


KILL_WORKER = """
import sys
sys.path.insert(0, {repo!r})
from tpu_tfrecord_torch.io.dataset import TFRecordDataset
from tpu_tfrecord_torch.schema import LongType, StringType, StructField, StructType
schema = StructType([StructField("id", LongType(), nullable=False),
                     StructField("s", StringType())])
ds = TFRecordDataset(sys.argv[1], batch_size=256, schema=schema, drop_remainder=False,
                     cache="auto", cache_dir=sys.argv[2])
n = 0
with ds.batches() as it:
    for cb in it:
        n += cb.num_rows
        print(f"batch rows={{n}}", flush=True)
print(f"done rows={{n}}", flush=True)
"""


def test_kill9_mid_populate_then_resume_never_wrong(tmp_path):
    """SIGKILL a populating reader (a subprocess importing the port alone),
    then read again from the same cache dir: rows equal the local read,
    the cache valid or bypassed and repopulated, never wrong."""
    root = tmp_path / "killds"
    out = os.path.join(str(root), "ds")
    n = 3000
    for s in range(3):
        tio.write([[i, f"v{i}"] for i in range(s * n, (s + 1) * n)], SCHEMA, out,
                  mode="append" if s else "overwrite")
    want = ids_of(port_read(out, batch_size=256))
    cdir = str(tmp_path / "cache")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    with httpfs.serve_directory(str(root)) as srv:
        url = srv.url_for("ds")
        proc = subprocess.Popen([sys.executable, "-c", KILL_WORKER.format(repo=REPO), url, cdir],
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                                env=env)
        try:
            line = proc.stdout.readline()  # the first batch: the populate is under way
            assert line.startswith("batch"), (line, proc.stderr.read())
            os.kill(proc.pid, signal.SIGKILL)
        finally:
            proc.kill()
            proc.wait(timeout=60)
        assert proc.returncode == -signal.SIGKILL
        METRICS.reset()
        assert ids_of(port_read(url, batch_size=256, cache="auto", cache_dir=cdir)) == want
        METRICS.reset()
        assert ids_of(port_read(url, batch_size=256, cache="auto", cache_dir=cdir)) == want
        assert METRICS.counter("cache.hits") == 3
    tcache.release_registry(cdir)


def test_mixed_hostile_epoch_byte_identical_and_replayable(served, local, clean):
    """One epoch under a seeded plan mixing resets, stalls, truncations and
    503s completes equal to the local read with no corrupt row, and the
    ledger replays, on the port as on the JAX package."""
    srv, url, _, names = served
    rules = [dict(op="http", kind="reset", path=names[0], cap_bytes=200, times=1),
             dict(op="http", kind="stall", path=names[0], stall_ms=50, times=1),
             dict(op="http", kind="truncated_body", path=names[1], cap_bytes=150, times=1),
             dict(op="http", kind="http_error", path=names[2], status=503,
                  retry_after_s=0.001, times=1),
             dict(op="http", kind="http_error", path=names[2], status=429,
                  retry_after_s=0.001, ordinal=1, times=1)]
    spec = FaultPlan([FaultRule(**r) for r in rules], seed=42).to_json()
    ledgers = []
    for side in ("port", "port", "jax"):
        plan = (FaultPlan if side == "port" else JPlan).from_json(spec)
        srv.set_plan(plan)
        METRICS.reset()
        got = (port_read if side == "port" else jax_read)(url, retry_policy=fast(4, side))
        assert ids_of(got) == ids_of(local)
        assert METRICS.counter("read.corrupt_records") == 0
        ledgers.append(plan.ledger_json())
    assert ledgers[0] == ledgers[1] == ledgers[2], "the ledger does not replay"
    assert sorted(json.loads(line)["kind"] for line in ledgers[0].splitlines()) == sorted(
        ["reset", "stall", "truncated_body", "http_error", "http_error"])


# -- the slice as a whole: a small DLRM scores batches read over HTTP -----------------


VOCAB = 8
SHARD_ROWS = [6, 14]   # the first batch straddles the two shards
BATCH = 8
TOL = {"f32": dict(rtol=1e-5, atol=1e-5), "bf16": dict(rtol=2e-2, atol=2e-2)}


def dlrm_configs(dtype):
    kw = dict(num_dense=4, num_categorical=3, vocab_size=VOCAB, embed_dim=4,
              bottom_mlp=(8, 4), top_mlp=(8, 1), seq_len=4, seq_dim=4, interaction="dot")
    jdt, tdt = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    return jdlrm.DLRMConfig(dtype=jdt, **kw), tdlrm.DLRMConfig(dtype=tdt, **kw)


def jax_scores_over(urls, cfg, params):
    """The JAX serving flow over the URLs (TFRecordDataset ->
    host_batch_from_columnar -> dlrm.forward), batch by batch."""
    hash_buckets = {f"c{i}": VOCAB for i in range(1, cfg.num_categorical + 1)}
    pack = {"dense": [f"d{i}" for i in range(1, cfg.num_dense + 1)],
            "cat": [f"c{i}" for i in range(1, cfg.num_categorical + 1)]}
    ds = JDataset(urls, batch_size=BATCH, recordType="SequenceExample",
                  hash_buckets=hash_buckets, pack=pack)
    out = []
    with ds.batches() as it:
        for cb in it:
            hb = j_hbfc(cb, ds.schema, pad_to={"frames": (cfg.seq_len, cfg.seq_dim)},
                        hash_buckets=hash_buckets, pack=pack)
            hb.pop("frames_inner_len", None)
            out.append(np.asarray(jdlrm.forward(params, {k: jnp.asarray(v)
                                                         for k, v in hb.items()}, cfg)))
    return np.concatenate(out)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_dlrm_scores_http_batches_like_jax(tmp_path, monkeypatch, dtype):
    jcfg, tcfg = dlrm_configs(dtype)
    write_dryrun_dataset(str(tmp_path), tcfg, SHARD_ROWS, VOCAB)
    params = jax.tree.map(np.asarray, jdlrm.init_params(jax.random.key(0), jcfg))
    pallas = jinter.dot_interaction
    calls = []

    def interpret(emb, *a, **k):
        calls.append(emb.shape)
        return pallas(emb, use_pallas=True, block_b=emb.shape[0], interpret=True)

    monkeypatch.setattr(jinter, "dot_interaction", interpret)
    with httpfs.serve_directory(str(tmp_path)) as srv:
        urls = [srv.url_for("shard00"), srv.url_for("shard01")]
        want = jax_scores_over(urls, jcfg, params)
        model = interop.dlrm_params_from_jax(params, tcfg, device="cpu")
        gets = srv.file_get_count
        res = score_files(urls, tcfg, model, BATCH, device="cpu")
        assert srv.file_get_count > gets  # the port read over the link
    assert calls, "the JAX forward did not go through the Pallas kernel"
    assert res.batches == sum(SHARD_ROWS) // BATCH
    assert res.logits.shape == want.shape and torch.isfinite(res.logits).all()
    np.testing.assert_allclose(res.logits.numpy(), want, **TOL[dtype])
    local = score_files(str(tmp_path), tcfg, model, BATCH, device="cpu")
    assert torch.equal(local.logits, res.logits)  # the link changes no bit
