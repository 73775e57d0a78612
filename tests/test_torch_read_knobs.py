"""The dataset's read knobs in the port against the JAX package:
``use_mmap`` (the mmap and the stream routes, and the Python route),
``slab_bytes``, ``max_record_bytes``, ``readahead_bytes`` (the
``posix_fadvise`` calls themselves), ``prefetch``, ``read_retries`` /
``retry_policy``, and the helpers the module copies had left out
(``columnar.bucket_boundaries``, ``Column.row_lengths`` / ``is_bytes``,
``ShardWriter.write_serialized``, ``wire.file_is_empty``,
``RetryPolicy.call``, ``_native.available`` / ``load_error``).
The shards are numpy-seeded and written once through the JAX writer."""

import os

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from tpu_tfrecord import _native as jnative, columnar as jcolumnar  # noqa: E402
from tpu_tfrecord import schema as jschema, wire as jwire  # noqa: E402
from tpu_tfrecord.io.dataset import TFRecordDataset as JDataset  # noqa: E402
from tpu_tfrecord.io.writer import ShardWriter as JShardWriter  # noqa: E402
from tpu_tfrecord.options import TFRecordOptions as JOptions  # noqa: E402
from tpu_tfrecord.retry import RetryPolicy as JRetry  # noqa: E402

from tpu_tfrecord_torch import _native as tnative, columnar as tcolumnar  # noqa: E402
from tpu_tfrecord_torch import schema as tschema, wire as twire  # noqa: E402
from tpu_tfrecord_torch.io import dataset as dataset_mod  # noqa: E402
from tpu_tfrecord_torch.io.dataset import TFRecordDataset as TDataset  # noqa: E402
from tpu_tfrecord_torch.io.writer import ShardWriter as TShardWriter  # noqa: E402
from tpu_tfrecord_torch.metrics import METRICS as TMETRICS  # noqa: E402
from tpu_tfrecord_torch.options import TFRecordOptions as TOptions  # noqa: E402
from tpu_tfrecord_torch.retry import RetryPolicy as TRetry  # noqa: E402

from test_torch_dataset import (  # noqa: E402
    CRITEO_KW,
    assert_batches_equal,
    criteo_records,
    criteo_schema,
)

SHARD_ROWS = [900, 2500, 0, 1300]  # one empty shard; the second spans two chunks
BATCH = 256


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    """{"plain": dir, "gz": dir}: the same numpy-seeded shards, all local
    uncompressed, or with the second one gzipped."""
    root = tmp_path_factory.mktemp("torch_read_knobs")
    rng = np.random.default_rng(31)
    recs = [criteo_records(n, rng) for n in SHARD_ROWS]
    out = {}
    for kind in ("plain", "gz"):
        d = root / kind
        d.mkdir()
        for i, r in enumerate(recs):
            gz = kind == "gz" and i == 1
            jwire.write_records(str(d / f"part-{i:05d}.tfrecord{'.gz' if gz else ''}"), r,
                                codec="gzip" if gz else None)
        out[kind] = str(d)
    return out


def port(path, **kw):
    kw.setdefault("batch_size", BATCH)
    return TDataset(path, schema=criteo_schema(tschema), **CRITEO_KW, **kw)


def jax(path, python_route=False, **kw):
    """The JAX dataset. ``decoder="python"`` is the port's: the JAX
    dataset decodes natively then, unless ``python_route`` takes its
    Python route (which neither hashes nor packs)."""
    kw.setdefault("batch_size", BATCH)
    kw.pop("decoder", None)
    ds = JDataset(path, schema=criteo_schema(jschema), **CRITEO_KW, **kw)
    if python_route:
        ds._native_decoder = None
    return ds


def read(ds, state=None, limit=None):
    """(batches, states) of one run from ``state``, stopping after
    ``limit`` batches."""
    out, states = [], []
    with ds.batches(state) as it:
        for b in it:
            out.append(b)
            states.append(it.state())
            if limit is not None and len(out) == limit:
                break
    return out, states


def assert_same(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert_batches_equal(a, b)


ROUTES = {
    "mmap": dict(use_mmap=True),
    "stream": dict(use_mmap=False),
    "python": dict(use_mmap=False, decoder="python"),
}
READS = {
    "in_order": dict(),
    "workers3": dict(num_workers=3),
    "shuffled": dict(shuffle=True, seed=4, shuffle_window=3, drop_remainder=False),
}


@pytest.mark.parametrize("read_kw", sorted(READS))
@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("kind", ["plain", "gz"])
def test_route_parity(shards, kind, route, read_kw):
    """Every route gives the JAX dataset's batches and positions, on the
    same route, and the mmap route's."""
    kw = dict(**ROUTES[route], **READS[read_kw])
    got, gstates = read(port(shards[kind], **kw))
    want, wstates = read(jax(shards[kind], **kw))
    assert_same(got, want)
    assert [s.to_json() for s in gstates] == [s.to_json() for s in wstates]
    assert_same(got, read(port(shards[kind], **READS[read_kw]))[0])


@pytest.mark.parametrize("slab", [97, 4096])
@pytest.mark.parametrize("route", ["stream", "python", "salvage"])
def test_tiny_slabs_read_and_resume_like_whole_shards(shards, route, slab):
    """Slabs smaller than a record (97 bytes) or than a chunk give the
    whole-shard batches, and a state taken mid-shard resumes to the same
    remaining batches."""
    kw = (dict(use_mmap=False, on_corrupt="skip_record") if route == "salvage"
          else dict(ROUTES[route]))
    whole, states = read(port(shards["gz"], **kw))
    small = read(port(shards["gz"], slab_bytes=slab, **kw))[0]
    assert_same(small, whole)
    head, hstates = read(port(shards["gz"], slab_bytes=slab, **kw), limit=5)
    assert hstates[-1] == states[4] and hstates[-1].record_offset
    tail = read(port(shards["gz"], slab_bytes=slab, **kw), state=hstates[-1])[0]
    assert_same(head + tail, whole)
    if route == "stream":
        assert_same(small, read(jax(shards["gz"], slab_bytes=slab, **kw))[0])


def test_stream_route_reuses_one_buffer_a_thread(shards):
    ds = port(shards["plain"], use_mmap=False, slab_bytes=1 << 16)
    first = ds._io_scratch()
    assert first["buf"].nbytes == 1 << 16
    read(ds)
    assert ds._io_scratch() is first
    assert port(shards["plain"])._io_scratch()["buf"].nbytes == dataset_mod.SCRATCH_INIT


def oversized_shard(tmp_path, gz):
    name = "part-0.tfrecord" + (".gz" if gz else "")
    recs = criteo_records(40, np.random.default_rng(2))
    jwire.write_records(str(tmp_path / name), recs, codec="gzip" if gz else None)
    return str(tmp_path)


@pytest.mark.parametrize("route,gz", [("mmap", False), ("stream", False), ("stream", True),
                                      ("python", False)])
def test_max_record_bytes_raises_as_jax(tmp_path, route, gz):
    """A record longer than ``max_record_bytes`` raises the JAX dataset's
    exception on the same route (the slab routes check the length of a
    record that straddles a slab, hence 64-byte slabs); a cap above every
    record reads it all."""
    d = oversized_shard(tmp_path, gz)
    kw = dict(ROUTES[route], batch_size=8, slab_bytes=64)
    errors = {}
    for name, make in (("jax", lambda *a, **k: jax(*a, python_route=route == "python", **k)),
                       ("port", port)):
        with pytest.raises(twire.TFRecordCorruptionError if name == "port"
                           else jwire.TFRecordCorruptionError) as e:
            read(make(d, max_record_bytes=20, **kw))
        errors[name] = str(e.value)
    assert "exceeds max_record_bytes (20)" in errors["port"]
    assert errors["port"] == errors["jax"]
    assert sum(b.num_rows for b in read(port(d, max_record_bytes=1 << 16, **kw))[0]) == 40


@pytest.fixture
def fadvise_log(monkeypatch):
    """Every ``os.posix_fadvise`` call, as (offset, length, advice)."""
    calls = []
    real = os.posix_fadvise

    def record(fd, offset, length, advice):
        calls.append((offset, length, advice))
        return real(fd, offset, length, advice)

    monkeypatch.setattr(os, "posix_fadvise", record)
    return calls


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("window", [0, 16 << 10, 64 << 20])
def test_readahead_issues_the_jax_fadvise_calls(shards, fadvise_log, route, window):
    """The same ``posix_fadvise`` calls, in order, as the JAX dataset on
    the same route: SEQUENTIAL once a shard, then a WILLNEED window that
    slides with the decoder (small slabs make the stream routes refill);
    none at all with the window at 0."""
    kw = dict(ROUTES[route], readahead_bytes=window, slab_bytes=8 << 10)
    read(jax(shards["plain"], python_route=route == "python", **kw))
    want = list(fadvise_log)
    fadvise_log.clear()
    read(port(shards["plain"], **kw))
    assert fadvise_log == want
    if not window:
        assert want == []
    else:
        advices = [a for _, _, a in want]
        assert advices.count(os.POSIX_FADV_SEQUENTIAL) == 3  # the non-empty shards
        assert advices.count(os.POSIX_FADV_WILLNEED) >= 3
        if window == 16 << 10:
            assert advices.count(os.POSIX_FADV_WILLNEED) > 6  # the window slid


def test_readahead_default_is_on_and_follows_the_dataset(shards, fadvise_log):
    ds = port(shards["plain"])
    assert ds.readahead_bytes == dataset_mod.READAHEAD_BYTES == 64 << 20
    read(ds)
    assert fadvise_log and fadvise_log[0] == (0, 0, os.POSIX_FADV_SEQUENTIAL)
    assert port(shards["plain"], readahead_bytes=-5).readahead_bytes == 0


@pytest.mark.parametrize("prefetch", [1, 2, 7])
def test_prefetch_sizes_the_resizable_queue(shards, prefetch):
    ds = port(shards["plain"], prefetch=prefetch)
    with ds.batches() as it:
        assert isinstance(it._queue, dataset_mod._ResizableQueue)
        assert it._queue.maxsize == prefetch
        first = next(it)
    assert first.num_rows == BATCH


@pytest.mark.parametrize("retries", [0, 2])
def test_read_retries_build_the_policy_like_jax(shards, retries):
    t, j = port(shards["plain"], read_retries=retries), jax(shards["plain"], read_retries=retries)
    assert t.retry_policy.max_retries == j.retry_policy.max_retries == retries
    pol = TRetry(max_retries=5)
    assert port(shards["plain"], read_retries=1, retry_policy=pol).retry_policy is pol


def test_retry_restarts_skip_what_was_yielded(shards):
    """A read that fails midway through a shard restarts the shard's
    attempt and skips the records already emitted: no duplicate, no hole."""
    from tpu_tfrecord_torch import faults as tfaults

    kw = dict(use_mmap=False, slab_bytes=4096)
    base = read(port(shards["plain"], **kw))[0]
    plan = tfaults.FaultPlan([tfaults.FaultRule(op="read", kind="transient_error",
                                                path="part-00001", ordinal=20, times=1)])
    TMETRICS.reset()
    with tfaults.install_chaos(plan):
        got = read(port(shards["plain"], retry_policy=TRetry(max_retries=1,
                                                            sleep=lambda _s: None), **kw))[0]
    assert_same(got, base)
    assert TMETRICS.counter("read.retries") == 1 and len(plan.ledger) == 1


# ---------------------------------------------------------------------------
# helpers the module copies had left out
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_buckets", [1, 3, 4, 8])
def test_bucket_boundaries_like_jax(n_buckets):
    lengths = np.random.default_rng(n_buckets).integers(0, 300, size=257).tolist()
    assert tcolumnar.bucket_boundaries(lengths, n_buckets) == \
        jcolumnar.bucket_boundaries(lengths, n_buckets)
    assert tcolumnar.bucket_boundaries([], n_buckets) == []


def test_column_row_lengths_and_is_bytes_like_jax(shards):
    t = read(port(shards["plain"]))[0][0]
    j = read(jax(shards["plain"]))[0][0]
    assert np.array_equal(t["w"].row_lengths(), j["w"].row_lengths())
    for name in t.columns:
        assert t[name].is_bytes == j[name].is_bytes, name
    raw = TDataset(shards["plain"], batch_size=BATCH, schema=criteo_schema(tschema))
    assert read(raw)[0][0]["C1"].is_bytes


def test_shard_writer_write_serialized_like_jax(tmp_path):
    recs = criteo_records(25, np.random.default_rng(8))
    for name, cls, opts in (("j", JShardWriter, JOptions.from_map(codec="gzip")),
                            ("t", TShardWriter, TOptions.from_map(codec="gzip"))):
        w = cls(str(tmp_path / f"{name}.tfrecord.gz"), criteo_schema(
            jschema if name == "j" else tschema), opts)
        for r in recs:
            w.write_serialized(r)
        assert w.records_written == 25
        w.close()
    assert list(twire.read_records(str(tmp_path / "t.tfrecord.gz"))) == recs
    assert list(jwire.read_records(str(tmp_path / "j.tfrecord.gz"))) == recs


def test_file_is_empty_like_jax(tmp_path):
    (tmp_path / "e").write_bytes(b"")
    (tmp_path / "f").write_bytes(b"x")
    for name in ("e", "f"):
        p = str(tmp_path / name)
        assert twire.file_is_empty(p) == jwire.file_is_empty(p) == (name == "e")


def test_retry_policy_call_like_jax():
    for cls in (JRetry, TRetry):
        calls, retries = [], []

        def flaky():
            calls.append(1)
            if len(calls) < 3:
                raise OSError("transient")
            return "ok"

        pol = cls(max_retries=3, sleep=lambda _s: None)
        assert pol.call(flaky, on_retry=lambda a, e: retries.append(a)) == "ok"
        assert retries == [1, 2]
        with pytest.raises(ValueError):
            pol.call(lambda: (_ for _ in ()).throw(ValueError("not retried")))
        with pytest.raises(OSError):
            cls(max_retries=1, sleep=lambda _s: None).call(
                lambda: (_ for _ in ()).throw(OSError("again")))


def test_native_available_and_load_error_like_jax(monkeypatch):
    assert tnative.available() == jnative.available() is True
    assert tnative.load_error() is None

    def broken():
        raise OSError("no compiler")

    monkeypatch.setattr(tnative, "load", broken)
    assert tnative.available() is False
    assert tnative.load_error() == "OSError: no compiler"
