"""The port's ordered parallel shard decode (``TFRecordDataset(num_workers=...)``)
against the JAX dataset at the same worker count, shuffled and not, and
against its own sequential chunk stream; the pool's thread contract: a
corrupt shard's error reaches the consumer in order, and an early exit or a
finished read leaves no dispatcher, decode worker or producer thread."""

import itertools
import os
import threading
import time

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from tpu_tfrecord import schema as jschema, wire as jwire  # noqa: E402
from tpu_tfrecord.io.dataset import TFRecordDataset as JDataset  # noqa: E402

from tpu_tfrecord_torch import schema as tschema, wire as twire  # noqa: E402
from tpu_tfrecord_torch.io import dataset as dataset_mod  # noqa: E402
from tpu_tfrecord_torch.io.dataset import TFRecordDataset as TDataset  # noqa: E402

from test_torch_dataset import (  # noqa: E402
    CRITEO_KW,
    SEQ_KW,
    assert_batches_equal,
    criteo_records,
    criteo_schema,
    read_all,
    seq_records,
    seq_schema,
)

SHARD_ROWS = [90, 0, 260, 41, 130]   # one empty shard; gzip on the third
BATCH = 40                           # divides no shard and no total
POOL_THREADS = ("tfrecord-producer", "tfrecord-dispatcher", "tfrecord-decode-")


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    """{kind: dir} of uneven shards written once through the JAX writer."""
    root = tmp_path_factory.mktemp("torch_parallel")
    out = {}
    for kind, make in (("criteo", criteo_records), ("seq", seq_records)):
        rng = np.random.default_rng(21)
        d = root / kind
        d.mkdir()
        for i, n in enumerate(SHARD_ROWS):
            codec = "gzip" if i == 2 else None
            jwire.write_records(str(d / f"part-{i:05d}.tfrecord{'.gz' if codec else ''}"),
                                make(n, rng), codec=codec)
        out[kind] = str(d)
    return out


def _kinds(kind):
    if kind == "criteo":
        return CRITEO_KW, criteo_schema(jschema), criteo_schema(tschema)
    return SEQ_KW, seq_schema(jschema), seq_schema(tschema)


def _pool_threads():
    return [t for t in threading.enumerate() if t.name.startswith(POOL_THREADS)]


def _wait_no_pool(timeout=10.0):
    deadline = time.monotonic() + timeout
    while _pool_threads() and time.monotonic() < deadline:
        time.sleep(0.01)
    return not _pool_threads()


READS = {
    "in_order": dict(),
    "shard_shuffle": dict(shuffle=True, seed=3),
    "window_shuffle": dict(shuffle=True, shuffle_window=2, seed=5, drop_remainder=False),
}


@pytest.mark.parametrize("read", sorted(READS))
@pytest.mark.parametrize("workers", [1, 2, 3, 4])
def test_batches_bit_identical_to_jax(shards, monkeypatch, workers, read):
    # small chunks and slabs: every shard decodes in several chunks
    monkeypatch.setattr(dataset_mod, "MIN_CHUNK_RECORDS", 1)
    monkeypatch.setattr(dataset_mod, "SLAB_BYTES", 2048)
    common, js, ts = _kinds("criteo")
    kw = dict(batch_size=BATCH, num_epochs=3, **common, **READS[read])
    want = read_all(JDataset(shards["criteo"], schema=js, num_workers=workers, **kw))
    got = read_all(TDataset(shards["criteo"], schema=ts, num_workers=workers, **kw))
    assert len(got) == len(want) >= 3 * sum(SHARD_ROWS) // BATCH
    for a, b in zip(got, want):
        assert_batches_equal(a, b)
    assert _wait_no_pool()


@pytest.mark.parametrize("workers", [2, 4])
@pytest.mark.parametrize("decoder", ["native", "python"])
def test_ragged2_batches_bit_identical_to_jax(shards, workers, decoder):
    common, js, ts = _kinds("seq")
    kw = dict(batch_size=BATCH, num_epochs=2, shuffle=True, shuffle_window=1, seed=2,
              drop_remainder=False, **common)
    want = read_all(JDataset(shards["seq"], schema=js, num_workers=workers, **kw))
    got = read_all(TDataset(shards["seq"], schema=ts, num_workers=workers, decoder=decoder, **kw))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert_batches_equal(a, b)


@pytest.mark.parametrize("workers", [2, 3, 6])
def test_chunk_stream_equals_sequential(shards, monkeypatch, workers):
    """(epoch, cursor, start) and contents of every chunk, pool against one
    thread, over shuffled epochs."""
    monkeypatch.setattr(dataset_mod, "MIN_CHUNK_RECORDS", 1)
    common, _, ts = _kinds("criteo")
    streams = {}
    for n in (1, workers):
        ds = TDataset(shards["criteo"], batch_size=16, schema=ts, num_epochs=4, shuffle=True,
                      seed=9, num_workers=n, **common)
        streams[n] = list(ds._chunks())
    assert [t[1:] for t in streams[workers]] == [t[1:] for t in streams[1]]
    for (a, *_), (b, *_) in zip(streams[workers], streams[1]):
        assert_batches_equal(a, b)
    assert _wait_no_pool()


def test_tasks_are_enumerated_lazily(shards):
    common, _, ts = _kinds("criteo")
    ds = TDataset(shards["criteo"], batch_size=8, schema=ts, num_epochs=8, **common)
    tasks = list(ds._shard_tasks())
    assert len(tasks) == 8 * 4  # the empty shard has no task
    assert tasks[:4] == [(0, 0, 0), (0, 2, 2), (0, 3, 3), (0, 4, 4)]
    endless = TDataset(shards["criteo"], batch_size=8, schema=ts, num_epochs=None,
                       shuffle=True, **common)
    first = list(itertools.islice(endless._shard_tasks(), 100))
    assert [t[0] for t in first[::4]] == list(range(25))


def test_worker_count_below_one_is_one(shards):
    common, _, ts = _kinds("criteo")
    assert TDataset(shards["criteo"], batch_size=8, schema=ts, num_workers=0,
                    **common).num_workers == 1


@pytest.mark.parametrize("workers", [2, 4])
def test_corrupt_shard_error_reaches_consumer(shards, tmp_path, workers):
    src = shards["criteo"]
    for name in sorted(os.listdir(src)):
        raw = bytearray(open(os.path.join(src, name), "rb").read())
        if name.startswith("part-00003"):
            raw[len(raw) // 2] ^= 0xFF
        (tmp_path / name).write_bytes(bytes(raw))
    common, _, ts = _kinds("criteo")
    ds = TDataset(str(tmp_path), batch_size=BATCH, schema=ts, num_workers=workers, **common)
    got = []
    with pytest.raises(twire.TFRecordCorruptionError):
        with ds.batches() as it:
            for batch in it:
                got.append(batch.num_rows)
    # every batch before the bad shard's first bad record came through
    assert got and sum(got) >= (90 + 260) // BATCH * BATCH
    assert _wait_no_pool()


@pytest.mark.parametrize("workers", [2, 5])
def test_early_break_leaves_no_thread(shards, workers):
    common, _, ts = _kinds("criteo")
    ds = TDataset(shards["criteo"], batch_size=20, schema=ts, num_epochs=None,
                  num_workers=workers, **common)
    assert _wait_no_pool()
    with ds.batches() as it:
        for i, batch in enumerate(it):
            assert batch.num_rows == 20
            if i == 5:
                break
        names = [t.name for t in _pool_threads()]
        assert names.count("tfrecord-producer") == 1 and "tfrecord-dispatcher" in names
        assert sum(n.startswith("tfrecord-decode-") for n in names) == workers
    assert _pool_threads() == []


def test_finished_read_leaves_no_thread(shards):
    common, _, ts = _kinds("criteo")
    ds = TDataset(shards["criteo"], batch_size=BATCH, schema=ts, num_workers=3, **common)
    assert len(read_all(ds)) == sum(SHARD_ROWS) // BATCH
    assert _wait_no_pool()
