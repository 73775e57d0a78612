"""The port's device feed on the CPU, side by side with the JAX package:
``HostPrefetcher``'s thread contract against the JAX class (close joins,
an error is raised again, ``next`` after close stops, no thread is left),
``DeviceIterator`` in both modes against ``make_device_batch``, and
``tracing`` (``DutyCycle`` against the JAX one on the same timed blocks, a
profiler session written to its log dir)."""

import gc
import itertools
import os
import threading
import time

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from tpu_tfrecord import tracing as jtracing  # noqa: E402
from tpu_tfrecord.tpu import ingest as jingest  # noqa: E402

from tpu_tfrecord_torch import tracing as ttracing  # noqa: E402
from tpu_tfrecord_torch.device import ingest as tingest  # noqa: E402
from tpu_tfrecord_torch.device.ingest import (  # noqa: E402
    DeviceIterator,
    HostPrefetcher,
    make_device_batch,
)

PREFETCHERS = {"port": HostPrefetcher, "jax": jingest.HostPrefetcher}


class Boom(RuntimeError):
    pass


def failing(n_ok):
    for i in range(n_ok):
        yield i
    raise Boom(f"after {n_ok}")


def endless(counter):
    for i in itertools.count():
        counter.append(i)
        yield i


def _wait_dead(thread, timeout=10.0):
    thread.join(timeout)
    return not thread.is_alive()


@pytest.mark.parametrize("impl", sorted(PREFETCHERS))
class TestHostPrefetcher:
    def test_items_in_order_then_stop(self, impl):
        pf = PREFETCHERS[impl](iter(range(7)), depth=2)
        assert list(pf) == list(range(7))
        with pytest.raises(StopIteration):
            next(pf)
        pf.close()
        assert _wait_dead(pf._thread)

    def test_error_raised_at_its_item_and_again(self, impl):
        pf = PREFETCHERS[impl](failing(3), depth=2)
        assert [next(pf) for _ in range(3)] == [0, 1, 2]
        with pytest.raises(Boom, match="after 3"):
            next(pf)
        with pytest.raises(Boom, match="after 3"):
            next(pf)
        pf.close()
        assert _wait_dead(pf._thread)

    def test_close_unblocks_and_joins(self, impl):
        produced = []
        pf = PREFETCHERS[impl](endless(produced), depth=1)
        assert next(pf) == 0
        deadline = time.monotonic() + 10
        while len(produced) < 3 and time.monotonic() < deadline:
            time.sleep(0.01)  # the worker fills the queue, then blocks on it
        pf.close()
        assert not pf._thread.is_alive()
        with pytest.raises(StopIteration):
            next(pf)
        with pytest.raises(StopIteration):
            next(pf)

    def test_context_manager_closes(self, impl):
        with PREFETCHERS[impl](endless([]), depth=3) as pf:
            assert [next(pf) for _ in range(4)] == [0, 1, 2, 3]
        assert not pf._thread.is_alive()

    def test_item_type_agnostic(self, impl):
        items = [{"a": np.arange(3)}, ("tuple", 1), None, torch.ones(2)]
        with PREFETCHERS[impl](iter(items)) as pf:
            got = list(pf)
        assert got[0]["a"].tolist() == [0, 1, 2] and got[1:3] == items[1:3]
        assert torch.equal(got[3], items[3])


def test_abandoned_prefetcher_stops_its_thread():
    pf = HostPrefetcher(endless([]), depth=1)
    next(pf)
    thread = pf._thread
    del pf
    gc.collect()
    assert _wait_dead(thread)
    assert thread.name == "host-prefetcher"


def host_batches(n, rows=6, seed=0):
    rng = np.random.default_rng(seed)
    for i in range(n):
        yield {
            "label": rng.integers(0, 2, size=rows).astype(np.float32),
            "dense": rng.normal(size=(rows, 3)).astype(np.float32),
            "cat": rng.integers(0, 1 << 20, size=(rows, 4)).astype(np.int32),
            # a non-contiguous view, as a column sliced out of a group is
            "wire": rng.integers(0, 1 << 30, size=(rows, 8)).astype(np.int32)[:, ::2],
            "step": np.full(rows, i, np.int64),
        }


@pytest.mark.parametrize("transfer_thread", [False, True], ids=["dispatch_ahead", "thread"])
class TestDeviceIteratorCPU:
    def test_batches_equal_make_device_batch(self, transfer_thread):
        want = [make_device_batch(hb, "cpu") for hb in host_batches(9)]
        seen = []
        with DeviceIterator(host_batches(9), device="cpu", transfer_thread=transfer_thread,
                            depth=2) as it:
            for batch in it:
                seen.append(it.transfer_seconds)
                got = batch
                w = want[len(seen) - 1]
                assert sorted(got) == sorted(w)
                for k in w:
                    assert got[k].device.type == "cpu" and got[k].dtype == w[k].dtype
                    assert torch.equal(got[k], w[k]), k
        assert len(seen) == 9
        assert seen[0] >= 0 and all(b >= a for a, b in zip(seen, seen[1:]))
        assert it.transfer_seconds > 0

    def test_empty_source(self, transfer_thread):
        with DeviceIterator(iter(()), device="cpu", transfer_thread=transfer_thread) as it:
            assert list(it) == []

    def test_error_reaches_consumer(self, transfer_thread):
        def source():
            yield from host_batches(2)
            raise Boom("host side")

        got = 0
        with pytest.raises(Boom, match="host side"):
            with DeviceIterator(source(), device="cpu", transfer_thread=transfer_thread) as it:
                for _ in it:
                    got += 1
        # dispatch-ahead pulls the next batch before it returns the current one
        assert got == (2 if transfer_thread else 1)

    def test_close_leaves_no_worker(self, transfer_thread):
        before = set(threading.enumerate())
        it = DeviceIterator(({"x": np.arange(4)} for _ in itertools.count()), device="cpu",
                            transfer_thread=transfer_thread)
        assert torch.equal(next(it)["x"], torch.arange(4))
        it.close()
        assert not [t for t in set(threading.enumerate()) - before if t.is_alive()]


def test_over_a_host_prefetcher():
    """The entry points' chain: HostPrefetcher -> DeviceIterator."""
    with HostPrefetcher(host_batches(5, seed=3)) as pf, \
            DeviceIterator(pf, device="cpu", transfer_thread=True) as it:
        got = [b["step"][0].item() for b in it]
    assert got == list(range(5))


def test_ring_is_not_used_on_the_cpu():
    it = DeviceIterator(host_batches(1), device="cpu")
    assert not hasattr(it, "_ring") and not hasattr(it, "_stream")
    assert tingest.StagingRing.__doc__


# -- tracing ---------------------------------------------------------------------


def _replay(cls, ticks, blocks, monkeypatch):
    clock = iter(ticks)
    monkeypatch.setattr(time, "perf_counter", lambda: next(clock))
    duty = cls()
    assert duty.value() is None
    for kind in blocks:
        with getattr(duty, kind)():
            pass
    return duty.busy_seconds, duty.wait_seconds, duty.value()


def test_duty_cycle_same_blocks_same_value(monkeypatch):
    """One clock replayed into each: identical busy, wait and value."""
    ticks = [0.0, 0.25, 0.5, 1.5, 1.75, 2.0, 3.0, 3.5]
    blocks = ["wait", "step", "wait", "step"]
    out = {name: _replay(cls, ticks, blocks, monkeypatch)
           for name, cls in (("port", ttracing.DutyCycle), ("jax", jtracing.DutyCycle))}
    assert out["port"] == out["jax"] == (1.5, 0.5, 0.75)


@pytest.mark.parametrize("seed", range(4))
def test_duty_cycle_matches_jax_on_random_blocks(monkeypatch, seed):
    rng = np.random.default_rng(seed)
    blocks = rng.choice(["wait", "step"], size=40).tolist()
    ticks = np.cumsum(rng.uniform(1e-4, 0.05, size=2 * len(blocks))).tolist()
    port = _replay(ttracing.DutyCycle, ticks, blocks, monkeypatch)
    jax_ = _replay(jtracing.DutyCycle, ticks, blocks, monkeypatch)
    assert port == jax_ and 0 < port[2] < 1


def test_trace_is_a_profiler_region():
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with ttracing.trace("feed.region"):
            torch.ones(8).sum()
    assert "feed.region" in {e.key for e in prof.key_averages()}


def test_start_stop_trace_writes_logdir(tmp_path):
    ttracing.start_trace(str(tmp_path))
    try:
        with pytest.raises(RuntimeError, match="already running"):
            ttracing.start_trace(str(tmp_path))
        with ttracing.trace("feed.session"):
            torch.ones(16).cumsum(0)
    finally:
        ttracing.stop_trace()
    with pytest.raises(RuntimeError, match="no trace"):
        ttracing.stop_trace()
    files = [f for f in os.listdir(tmp_path) if f.endswith(".json")]
    assert files, os.listdir(tmp_path)
    assert "feed.session" in (tmp_path / files[0]).read_text()
