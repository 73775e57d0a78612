"""The dataset's process slot against the JAX dataset's.

``TFRecordDataset(process_index=i, process_count=P)`` reads the shards
``k`` of the global order with ``k % P == i``. For (P, i) in (2, 0),
(2, 1), (4, 0..3) over 6 shards (one empty), plain, shuffled, with a row
shuffle window, at 3 decode workers, over 2 epochs without dropping the
remainder, and through the epoch cache: the port's shard list, batches,
position after every batch and fingerprint equal the JAX dataset's with
the same arguments, and a state saved on either side resumes the other to
the same remaining batches. A state of another slot is refused, and the
slots of one group together read every row once."""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from tpu_tfrecord import schema as jschema, wire as jwire  # noqa: E402
from tpu_tfrecord.io.dataset import IteratorState as JState  # noqa: E402
from tpu_tfrecord.io.dataset import TFRecordDataset as JDataset  # noqa: E402

from tpu_tfrecord_torch import schema as tschema  # noqa: E402
from tpu_tfrecord_torch.io.dataset import IteratorState as TState  # noqa: E402
from tpu_tfrecord_torch.io.dataset import TFRecordDataset as TDataset  # noqa: E402

from test_torch_dataset import (  # noqa: E402
    CRITEO_KW,
    assert_batches_equal,
    criteo_records,
    criteo_schema,
)

SHARD_ROWS = [40, 0, 57, 33, 61, 25]  # six shards, one empty
BATCH = 16
SLOTS = [(2, 0), (2, 1), (4, 0), (4, 1), (4, 2), (4, 3)]
CONFIGS = {
    "plain": dict(),
    "shuffle": dict(shuffle=True, seed=3),
    "window2": dict(shuffle=True, shuffle_window=2, seed=5),
    "workers3": dict(shuffle=True, seed=2, num_workers=3),
    "epochs2_remainder": dict(shuffle=True, seed=7, num_epochs=2, drop_remainder=False),
    "cache": dict(cache="auto"),
}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_slot") / "data"
    d.mkdir()
    rng = np.random.default_rng(23)
    for i, n in enumerate(SHARD_ROWS):
        jwire.write_records(str(d / f"part-{i:05d}.tfrecord"), criteo_records(n, rng))
    return str(d)


def _datasets(root, tmp_path, config, count, index):
    kw = dict(CRITEO_KW, batch_size=BATCH, process_index=index, process_count=count,
              **CONFIGS[config])
    jkw, tkw = dict(kw), dict(kw)
    if config == "cache":
        jkw["cache_dir"] = str(tmp_path / "jax_cache")
        tkw["cache_dir"] = str(tmp_path / "port_cache")

    def jax_ds():
        return JDataset(root, schema=criteo_schema(jschema), **jkw)

    def port_ds():
        return TDataset(root, schema=criteo_schema(tschema), **tkw)

    return jax_ds, port_ds


def _read(ds, state=None):
    with ds.batches(state) as it:
        return [(b, it.state()) for b in it]


def _same_stream(got, want):
    assert len(got) == len(want)
    for (a, sa), (b, sb) in zip(got, want):
        assert_batches_equal(a, b)
        assert sa.to_json() == sb.to_json()


@pytest.mark.parametrize("config", CONFIGS)
@pytest.mark.parametrize("count,index", SLOTS, ids=[f"P{p}_i{i}" for p, i in SLOTS])
def test_slot_matches_jax(root, tmp_path, config, count, index):
    jax_ds, port_ds = _datasets(root, tmp_path, config, count, index)
    jds, tds = jax_ds(), port_ds()
    assert [sh.path for sh in tds.shards] == [sh.path for sh in jds.shards]
    assert [sh.path for sh in tds.shards] == [
        sh.path for k, sh in enumerate(tds._reader.shards) if k % count == index]
    assert (tds.process_index, tds.process_count) == (index, count)
    assert tds.fingerprint() == jds.fingerprint()
    want = _read(jds)
    got = _read(tds)
    _same_stream(got, want)
    assert want, "every slot reads at least one batch"
    if config == "cache":
        _same_stream(_read(port_ds()), want)  # served from the entries of the first pass
    if len(want) >= 2:
        k = len(want) // 2
        # the JAX iterator's state, through JSON, resumes the port ...
        _same_stream(_read(port_ds(), TState.from_json(want[k - 1][1].to_json())), want[k:])
        # ... and the port's resumes the JAX dataset
        _same_stream(_read(jax_ds(), JState.from_json(got[k - 1][1].to_json())), got[k:])


@pytest.mark.parametrize("count", [2, 4])
def test_state_of_another_slot_is_refused(root, tmp_path, count):
    """The fingerprint stamps the slot: a position saved on slot 0 resumes
    neither package's dataset on slot 1, and both say so alike."""
    _, port0 = _datasets(root, tmp_path, "plain", count, 0)
    jax1, port1 = _datasets(root, tmp_path, "plain", count, 1)
    with port0().batches() as it:
        next(it)
        state = it.state()
    with pytest.raises(ValueError) as want:
        with jax1().batches(JState.from_json(state.to_json())) as it:
            next(it)
    with pytest.raises(ValueError) as got:
        with port1().batches(state) as it:
            next(it)
    assert str(got.value) == str(want.value).replace(
        JState.from_json(state.to_json()).fingerprint, state.fingerprint)
    assert "process slot" in str(got.value)


@pytest.mark.parametrize("count", [1, 2, 3, 4, 6, 7])
def test_slots_read_every_row_once(root, tmp_path, count):
    """The slots of a group of ``count`` processes read, between them, the
    rows of a one-process read (no remainder dropped), each once."""
    def labels(index):
        _, port = _datasets(root, tmp_path, "plain", count, index)
        ds = port()
        ds.drop_remainder = False
        with ds.batches() as it:
            return [(int(v), int(i)) for cb in it
                    for v, i in zip(cb["label"].values, cb["dense"].values[:, 0])]

    rows = [r for index in range(count) for r in labels(index)]
    _, whole = _datasets(root, tmp_path, "plain", 1, 0)
    ds = whole()
    ds.drop_remainder = False
    with ds.batches() as it:
        want = [(int(v), int(i)) for cb in it
                for v, i in zip(cb["label"].values, cb["dense"].values[:, 0])]
    assert len(rows) == len(want) == sum(SHARD_ROWS)
    assert sorted(rows) == sorted(want)
