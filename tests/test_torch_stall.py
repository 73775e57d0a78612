"""Stall defence of the port (``stall.py`` and the dataset's decode pool)
against the JAX package.

- Dataset parity: one ``FaultPlan`` each for a transient read error (healed
  by the retry policy), a stalled read beaten by a hedge, and a wedged
  worker that the watchdog fails under ``on_stall="skip_shard"``, through
  the JAX ``TFRecordDataset`` and the port's at 1-4 decode workers,
  shuffled and not: the same batches, positions, fault ledger and
  ``read.*`` counters.
- The pieces, mirroring ``tests/test_chaos.py``: the stall matrix over the
  read routes and both ``on_stall`` policies, the guarded stream's hedge
  and its failed backup, the watchdog (skip, raise, none by default, a
  backpressured worker is not stalled), the guard's thread hygiene and
  the stall options.

Injected stalls last until ``plan.release()`` at the end of each read;
deadlines and the watchdog are a few hundred milliseconds, so a case costs
about a second.
"""

import os
import threading
import time

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from tpu_tfrecord import faults as jfaults, schema as jschema, wire as jwire  # noqa: E402
from tpu_tfrecord.io.dataset import TFRecordDataset as JDataset  # noqa: E402
from tpu_tfrecord.metrics import METRICS as JMETRICS  # noqa: E402
from tpu_tfrecord.retry import RetryPolicy as JRetry  # noqa: E402

from tpu_tfrecord_torch import faults as tfaults, schema as tschema  # noqa: E402
from tpu_tfrecord_torch.io.dataset import TFRecordDataset as TDataset  # noqa: E402
from tpu_tfrecord_torch.metrics import METRICS as TMETRICS, Metrics  # noqa: E402
from tpu_tfrecord_torch.options import TFRecordOptions  # noqa: E402
from tpu_tfrecord_torch.retry import RetryPolicy as TRetry  # noqa: E402
from tpu_tfrecord_torch.stall import (  # noqa: E402
    DeadlineError,
    GuardedReadStream,
    StallError,
    StallGuard,
    WatchdogError,
    _SHARED_POOL,
    guard_from_options,
)

from test_torch_dataset import (  # noqa: E402
    CRITEO_KW,
    assert_batches_equal,
    criteo_records,
    criteo_schema,
)

N_SHARDS = 4
ROWS = 300
BATCH = 64
STALL_MS = 60_000  # "forever": released at the end of each read
# compared exactly between the packages; a hedge can also launch (and win)
# where a healthy read is slow on a loaded host, so hedges are checked apart
COUNTERS = ("read.retries", "read.skipped_shards", "read.stalls", "read.watchdog_restarts")

PKGS = {
    "jax": dict(faults=jfaults, Dataset=JDataset, metrics=JMETRICS, Retry=JRetry, schema=jschema),
    "torch": dict(faults=tfaults, Dataset=TDataset, metrics=TMETRICS, Retry=TRetry,
                  schema=tschema),
}


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    """4 local uncompressed shards of 300 numpy-seeded Criteo-like rows."""
    d = tmp_path_factory.mktemp("torch_stall")
    rng = np.random.default_rng(12)
    for i in range(N_SHARDS):
        jwire.write_records(str(d / f"part-{i:05d}.tfrecord"), criteo_records(ROWS, rng))
    return str(d)


def _settle(before, timeout=5.0):
    """Wait for the threads a released stall freed to finish their read
    (the guard's pooled op workers, "tfr-stall", stay idle by design)."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline and any(
            t not in before and t.name != "tfr-stall" for t in threading.enumerate()):
        time.sleep(0.01)


def read_under(pkg, shards, rules, timeout=30.0, **kw):
    """(batches, positions, error, ledger, counters) of one epoch through
    ``pkg``'s dataset under a plan of ``rules`` (dicts), read on a side
    thread under an outer guard: a stall the defence misses fails the
    test instead of hanging it."""
    p = PKGS[pkg]
    p["metrics"].reset()
    plan = p["faults"].FaultPlan.from_json({"rules": rules})
    kw.setdefault("drop_remainder", False)
    ds = p["Dataset"](shards, batch_size=BATCH, schema=criteo_schema(p["schema"]),
                      **CRITEO_KW, **kw)
    out = {"batches": [], "positions": [], "error": None}
    before = set(threading.enumerate())

    def run():
        try:
            with ds.batches() as it:
                for b in it:
                    s = it.state()
                    out["batches"].append(b)
                    out["positions"].append((s.epoch, s.shard_cursor, s.record_offset,
                                             s.window_emitted))
        except BaseException as e:  # compared by the caller
            out["error"] = e

    with p["faults"].install_chaos(plan):
        t = threading.Thread(target=run, daemon=True)
        t.start()
        t.join(timeout)
        alive = t.is_alive()
        ledger = sorted(plan.ledger_json().splitlines())
    plan.release()
    _settle(before)
    assert not alive, "the read hung: the stall defence missed a stall"
    counters = {c: p["metrics"].counter(c) for c in COUNTERS + ("read.hedge_wins",)}
    return out["batches"], out["positions"], out["error"], ledger, counters


def retry_policy(pkg, n):
    return PKGS[pkg]["Retry"](max_retries=n, sleep=lambda _s: None)


def fault_case(fault, pkg, shards, workers):
    """(rules, dataset kwargs) of one fault of the parity matrix."""
    kw = dict(use_mmap=False, num_workers=workers)
    if fault == "transient":
        rules = [{"op": "read", "kind": "transient_error", "path": "part-00002", "times": 1}]
        kw["retry_policy"] = retry_policy(pkg, 2)
    elif fault == "hedge":
        rules = [{"op": "read", "kind": "stall", "path": "part-00001", "ordinal": 0, "times": 1,
                  "stall_ms": STALL_MS}]
        kw.update(hedge_after_ms=150, read_deadline_ms=20_000)
    else:
        rules = [{"op": "read", "kind": "stall", "path": "part-00001", "times": None,
                  "stall_ms": STALL_MS}]
        kw.update(watchdog_timeout_ms=800, on_stall="skip_shard")
        if workers == 1:
            # one worker decodes through the pool (and its watchdog) only
            # when autotune drives it
            kw.update(autotune="on", autotune_interval_s=300.0)
    return rules, kw


SHUFFLES = {"in_order": {}, "shuffled": dict(shuffle=True, seed=3, shuffle_window=2)}


@pytest.mark.parametrize("shuffle", sorted(SHUFFLES))
@pytest.mark.parametrize("workers", [1, 2, 3, 4])
@pytest.mark.parametrize("fault", ["transient", "hedge", "watchdog"])
def test_dataset_parity_under_one_plan(shards, fault, workers, shuffle):
    runs = {}
    for pkg in PKGS:
        rules, kw = fault_case(fault, pkg, shards, workers)
        runs[pkg] = read_under(pkg, shards, rules, **kw, **SHUFFLES[shuffle])
    jb, jpos, jerr, jledger, jcount = runs["jax"]
    tb, tpos, terr, tledger, tcount = runs["torch"]
    assert jerr is None and terr is None, (jerr, terr)
    assert len(tb) == len(jb)
    for a, b in zip(tb, jb):
        assert_batches_equal(a, b)
    assert tpos == jpos
    assert tledger == jledger and len(tledger) == 1
    assert {c: tcount[c] for c in COUNTERS} == {c: jcount[c] for c in COUNTERS}
    rows = sum(b.num_rows for b in tb)
    if fault == "transient":
        assert tcount["read.retries"] == 1 and rows == N_SHARDS * ROWS
    elif fault == "hedge":
        assert tcount["read.hedge_wins"] >= 1 and jcount["read.hedge_wins"] >= 1
        assert tcount["read.stalls"] == 0
        assert rows == N_SHARDS * ROWS
    else:
        assert tcount["read.watchdog_restarts"] == 1 and tcount["read.skipped_shards"] == 1
        assert rows == (N_SHARDS - 1) * ROWS


# ---------------------------------------------------------------------------
# the stall matrix over the read routes (tests/test_chaos.py)
# ---------------------------------------------------------------------------

MODES = {
    "python": dict(use_mmap=False, decoder="python"),
    "stream": dict(use_mmap=False),
    "mmap": dict(use_mmap=True),
    "salvage": dict(use_mmap=False, on_corrupt="skip_record"),
}


def port_ids(shards, mode, rules=(), timeout=30.0, **kw):
    rules = list(rules)
    batches, _, err, _, _ = read_under("torch", shards, rules, timeout, **MODES[mode], **kw)
    return [int(v) for b in batches for v in b["label"].values], batches, err


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("policy", ["raise", "skip_shard"])
def test_stall_per_policy(shards, mode, policy):
    """A shard whose read (open, on the mmap route) stalls for good no
    longer hangs the epoch: ``raise`` raises a DeadlineError within the
    deadline, ``skip_shard`` completes the epoch without the shard."""
    op = "open" if mode == "mmap" else "read"
    rules = [{"op": op, "kind": "stall", "path": "part-00001", "times": None,
              "stall_ms": STALL_MS}]
    _, base, _ = port_ids(shards, mode)
    _, got, err = port_ids(shards, mode, rules, read_deadline_ms=400, open_deadline_ms=400,
                           on_stall=policy)
    if policy == "raise":
        assert isinstance(err, DeadlineError)
    else:
        assert err is None
        assert sum(b.num_rows for b in got) == (N_SHARDS - 1) * ROWS
        assert TMETRICS.counter("read.skipped_shards") == 1
    assert TMETRICS.counter("read.stalls") >= 1
    assert TMETRICS.counter("read.deadline_misses") >= 1
    assert sum(b.num_rows for b in base) == N_SHARDS * ROWS


@pytest.mark.parametrize("mode", sorted(MODES))
def test_transient_error_retried_on_every_route(shards, mode):
    """One transient fault a shard, healed by the retries on each route:
    every row arrives once, in order."""
    op = "open" if mode == "mmap" else "read"
    rules = [{"op": op, "kind": "transient_error", "path": f"part-{i:05d}", "times": 1}
             for i in range(N_SHARDS)]
    base, _, _ = port_ids(shards, mode)
    got, _, err = port_ids(shards, mode, rules, retry_policy=retry_policy("torch", 3))
    assert err is None and got == base
    assert TMETRICS.counter("read.retries") == N_SHARDS


# ---------------------------------------------------------------------------
# the guarded stream
# ---------------------------------------------------------------------------


class SlowFirstRead:
    """The first read() of a first handle blocks until released."""

    def __init__(self, fh, first, release):
        self._fh, self._first, self._release, self._reads = fh, first, release, 0

    def read(self, n=-1):
        self._reads += 1
        if self._first and self._reads == 1:
            self._release.wait(30)
        return self._fh.read(n)

    def seek(self, pos):
        self._fh.seek(pos)

    def close(self):
        self._fh.close()


def test_guarded_stream_hedge_unit(tmp_path):
    """The backup reads the same byte range; the stream's output is the
    file's bytes and the loser is abandoned."""
    path = str(tmp_path / "blob.bin")
    payload = bytes(range(256)) * 5000
    with open(path, "wb") as fh:
        fh.write(payload)
    release = threading.Event()
    opens = []

    def reopen(pos):
        opens.append(pos)
        fh = SlowFirstRead(open(path, "rb"), False, release)
        fh.seek(pos)
        return fh

    m = Metrics()
    gs = GuardedReadStream(SlowFirstRead(open(path, "rb"), True, release), path,
                           read_deadline=None, hedge_after=0.05, reopen=reopen, metrics=m,
                           io_chunk=64 << 10)
    try:
        out = gs.read(-1)
    finally:
        release.set()
        gs.close()
    assert out == payload and opens == [0]
    assert m.counter("read.hedges") == 1 and m.counter("read.hedge_wins") == 1


def test_failed_backup_does_not_shorten_primary_deadline(tmp_path):
    """A hedge whose backup fails waits on the slow primary for the rest
    of the read deadline instead of declaring a stall."""
    path = str(tmp_path / "blob.bin")
    payload = os.urandom(128 << 10)
    with open(path, "wb") as fh:
        fh.write(payload)

    class SlowRead:
        def __init__(self, fh):
            self._fh = fh

        def read(self, n=-1):
            time.sleep(0.2)
            return self._fh.read(n)

        def close(self):
            self._fh.close()

    def reopen(_pos):
        raise OSError("backup open refused")

    m = Metrics()
    gs = GuardedReadStream(SlowRead(open(path, "rb")), path, read_deadline=5.0,
                           hedge_after=0.05, reopen=reopen, metrics=m, io_chunk=1 << 20)
    try:
        out = gs.read(-1)
    finally:
        gs.close()
    assert out == payload
    assert m.counter("read.hedges") >= 1 and m.counter("read.hedge_wins") == 0
    assert m.counter("read.stalls") == 0


def test_read_deadline_miss_raises_and_wedges(tmp_path):
    path = str(tmp_path / "blob.bin")
    with open(path, "wb") as fh:
        fh.write(b"x" * 1000)
    release = threading.Event()
    m = Metrics()
    gs = GuardedReadStream(SlowFirstRead(open(path, "rb"), True, release), path,
                           read_deadline=0.05, hedge_after=None, metrics=m)
    try:
        with pytest.raises(DeadlineError, match="read exceeded deadline"):
            gs.read(10)
        with pytest.raises(DeadlineError, match="wedged"):
            gs.read(10)
    finally:
        release.set()
        gs.close()
    assert m.counter("read.stalls") == 1 and m.counter("read.deadline_misses") == 1


def test_stall_errors_are_oserrors():
    assert issubclass(DeadlineError, StallError) and issubclass(WatchdogError, StallError)
    assert issubclass(StallError, OSError)


# ---------------------------------------------------------------------------
# the watchdog
# ---------------------------------------------------------------------------


def test_wedged_worker_skip_shard_completes(shards):
    rules = [{"op": "read", "kind": "stall", "path": "part-00000", "times": None,
              "stall_ms": STALL_MS}]
    _, got, err = port_ids(shards, "stream", rules, num_workers=2, watchdog_timeout_ms=300,
                           on_stall="skip_shard")
    assert err is None and sum(b.num_rows for b in got) == (N_SHARDS - 1) * ROWS
    assert TMETRICS.counter("read.watchdog_restarts") >= 1
    assert TMETRICS.counter("read.stalls") >= 1
    assert TMETRICS.counter("read.skipped_shards") >= 1


def test_wedged_worker_default_raises(shards):
    rules = [{"op": "read", "kind": "stall", "path": "part-00000", "times": None,
              "stall_ms": STALL_MS}]
    _, _, err = port_ids(shards, "stream", rules, num_workers=2, watchdog_timeout_ms=300)
    assert isinstance(err, WatchdogError)


def test_no_watchdog_config_means_no_watchdog_thread(shards):
    ds = TDataset(shards, batch_size=BATCH, schema=criteo_schema(tschema), num_workers=2,
                  **CRITEO_KW)
    with ds.batches() as it:
        next(it)
        names = [t.name for t in threading.enumerate()]
        assert "tfrecord-dispatcher" in names and "tfrecord-watchdog" not in names
    assert ds._stall_guard is None


def test_backpressure_is_not_a_stall(tmp_path):
    """Workers blocked handing over chunks and end sentinels to a slow
    consumer keep their beat: no restart, nothing skipped."""
    rng = np.random.default_rng(3)
    jwire.write_records(str(tmp_path / "part-0.tfrecord"), criteo_records(4500, rng))
    TMETRICS.reset()
    ds = TDataset(str(tmp_path), batch_size=512, schema=criteo_schema(tschema),
                  drop_remainder=False, num_workers=2, prefetch=1, num_epochs=2,
                  watchdog_timeout_ms=400, use_mmap=False, **CRITEO_KW)
    rows = 0
    with ds.batches() as it:
        for b in it:
            rows += b.num_rows
            time.sleep(0.08)  # a consumer far slower than the decoders
    assert rows == 2 * 4500
    assert TMETRICS.counter("read.watchdog_restarts") == 0
    assert TMETRICS.counter("read.skipped_shards") == 0


# ---------------------------------------------------------------------------
# guard hygiene and options
# ---------------------------------------------------------------------------


def test_real_open_error_does_not_leak_worker_threads(tmp_path):
    guard = StallGuard(open_deadline=5.0)
    before = threading.active_count()
    for _ in range(20):
        with pytest.raises(FileNotFoundError):
            guard.open_compressed(str(tmp_path / "missing.tfrecord"), None)
    assert threading.active_count() <= before + _SHARED_POOL._MAX_IDLE


def test_open_deadline_miss_raises(tmp_path):
    guard = StallGuard(open_deadline=0.05, metrics=Metrics())
    release = threading.Event()
    with pytest.raises(DeadlineError, match="open exceeded deadline"):
        guard.call_open(lambda: release.wait(10), "x")
    release.set()
    assert guard.metrics.counter("read.stalls") == 1


def test_guard_from_options_none_by_default():
    assert guard_from_options(TFRecordOptions.from_map()) is None
    g = guard_from_options(TFRecordOptions.from_map(read_deadline_ms=250, hedgeAfterMs="50"))
    assert g.read_deadline == pytest.approx(0.25) and g.hedge_after == pytest.approx(0.05)
    assert g.open_deadline is None


@pytest.mark.parametrize("kw,match", [
    (dict(read_deadline_ms=0), "read_deadline_ms"),
    (dict(open_deadline_ms=-1), "open_deadline_ms"),
    (dict(hedge_after_ms=0), "hedge_after_ms"),
    (dict(watchdog_timeout_ms=0), "watchdog_timeout_ms"),
    (dict(on_stall="sometimes"), "on_stall"),
])
def test_stall_options_validate(kw, match):
    with pytest.raises(ValueError, match=match):
        TFRecordOptions.from_map(**kw)


def test_guarded_open_reads_every_codec(tmp_path):
    """The guard sits under the codec: a gzip shard reads the same through
    a guarded stream as through the plain open."""
    rng = np.random.default_rng(5)
    jwire.write_records(str(tmp_path / "part-0.tfrecord.gz"), criteo_records(500, rng),
                        codec="gzip")
    kw = dict(batch_size=BATCH, schema=criteo_schema(tschema), **CRITEO_KW)
    with TDataset(str(tmp_path), **kw).batches() as it:
        plain = [b for b in it]
    with TDataset(str(tmp_path), read_deadline_ms=10_000, hedge_after_ms=5_000,
                  **kw).batches() as it:
        guarded = [b for b in it]
    assert len(plain) == len(guarded) == 500 // BATCH
    for a, b in zip(plain, guarded):
        assert_batches_equal(a, b)
