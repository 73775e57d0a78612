"""The port's checkpoint layer: ``tests/test_checkpoint.py``'s cases on
``tpu_tfrecord_torch.checkpoint``, the JAX package's layout read both
ways, and the train state of a DLRM through ``TrainCheckpointer``.

Cross-restore: a state file written by either package loads in the other;
a generation written by either ``AsyncCheckpointer`` restores in the
other with a numpy template; ``tree_flatten`` orders leaves as
``jax.tree.flatten`` does. Bitwise throughout (``np.array_equal`` on
values and dtypes)."""

import json
import os
import zipfile
from typing import NamedTuple

import jax
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from tpu_tfrecord import checkpoint as jckpt  # noqa: E402
from tpu_tfrecord.io.dataset import IteratorState as JState  # noqa: E402

import tpu_tfrecord_torch.io as tio  # noqa: E402
from tpu_tfrecord_torch import checkpoint  # noqa: E402
from tpu_tfrecord_torch.io.dataset import IteratorState, TFRecordDataset  # noqa: E402
from tpu_tfrecord_torch.metrics import Metrics  # noqa: E402
from tpu_tfrecord_torch.models import dlrm as tdlrm  # noqa: E402
from tpu_tfrecord_torch.schema import LongType, StructField, StructType  # noqa: E402

SCHEMA = StructType([StructField("uid", LongType())])


def test_save_load_round_trip(tmp_path):
    st = IteratorState(epoch=2, shard_cursor=5, record_offset=77)
    path = checkpoint.save_state(str(tmp_path), st, process_index=3, step=42)
    assert os.path.basename(path) == "_input_state.3.json"
    assert checkpoint.load_state(str(tmp_path), process_index=3) == st
    assert checkpoint.load_state(str(tmp_path), process_index=9) is None
    assert checkpoint.state_path(str(tmp_path)).endswith("_input_state.0.json")


def test_save_from_live_iterator_and_resume(tmp_path):
    out = str(tmp_path / "ds")
    for s in range(3):
        tio.write([[s * 10 + i] for i in range(6)], SCHEMA, out, mode="append")
    with TFRecordDataset(out, batch_size=6, schema=SCHEMA).batches() as it:
        full = [v for b in it for v in b["uid"].values.tolist()]
    with TFRecordDataset(out, batch_size=6, schema=SCHEMA).batches() as it:
        first = next(it)["uid"].values.tolist()
        checkpoint.save_state(str(tmp_path / "ck"), it, process_index=0)
    st = checkpoint.load_state(str(tmp_path / "ck"), process_index=0)
    with TFRecordDataset(out, batch_size=6, schema=SCHEMA).batches(st) as it:
        rest = [v for b in it for v in b["uid"].values.tolist()]
    assert first + rest == full


def test_state_file_inside_dataset_dir_is_ignored_by_discovery(tmp_path):
    out = str(tmp_path / "ds2")
    tio.write([[1], [2]], SCHEMA, out, mode="overwrite")
    checkpoint.save_state(out, IteratorState(), process_index=0)
    assert all("input_state" not in s.path for s in tio.discover_shards(out))
    assert len(tio.read(out, schema=SCHEMA)) == 2


def test_version_check(tmp_path):
    path = checkpoint.state_path(str(tmp_path), 0)
    with open(path, "w") as fh:
        json.dump({"version": 999, "state": {}}, fh)
    with pytest.raises(ValueError, match="version"):
        checkpoint.load_state(str(tmp_path), process_index=0)


def test_windowed_state_written_as_version_2(tmp_path):
    checkpoint.save_state(str(tmp_path), IteratorState(0, 1, 2, window_emitted=3), process_index=0)
    payload = json.load(open(checkpoint.state_path(str(tmp_path), 0)))
    assert payload["version"] == 2 and payload["state"]["window_emitted"] == 3


# -- durability -----------------------------------------------------------------


class TestDurableWrite:
    def test_writes_bytes_atomically(self, tmp_path):
        p = str(tmp_path / "out.json")
        checkpoint.durable_write(p, b'{"ok": 1}')
        assert open(p, "rb").read() == b'{"ok": 1}'
        assert not [n for n in os.listdir(tmp_path) if ".tmp." in n]

    def test_failure_cleans_stage_file(self, tmp_path):
        p = str(tmp_path / "out.bin")

        def boom(fh):
            raise RuntimeError("disk says no")

        with pytest.raises(RuntimeError):
            checkpoint.durable_write(p, write_fn=boom)
        assert not os.path.exists(p)
        assert not [n for n in os.listdir(tmp_path) if ".tmp." in n]

    def test_torn_state_file_raises_named_error(self, tmp_path):
        path = checkpoint.state_path(str(tmp_path), 0)
        with open(path, "w") as fh:
            fh.write('{"version": 1, "sta')  # a torn tail
        with pytest.raises(checkpoint.TornStateError, match="torn"):
            checkpoint.load_state(str(tmp_path), process_index=0)

    def test_durable_append_and_fence(self, tmp_path):
        p = str(tmp_path / "journal")
        ino = checkpoint.durable_append(p, b"a\n")
        assert checkpoint.durable_append(p, b"b\n", expect_ino=ino) == ino
        checkpoint.durable_write(p, b"new\n")  # replaced: a fresh inode
        with pytest.raises(checkpoint.FencedWriteError):
            checkpoint.durable_append(p, b"c\n", expect_ino=ino)
        assert open(p, "rb").read() == b"new\n"


# -- AsyncCheckpointer ------------------------------------------------------------


def _tree():
    return {"w": np.arange(24, dtype=np.float64).reshape(4, 6), "b": np.full(6, 3.5)}


def _torch_tree():
    return {"w": torch.arange(24, dtype=torch.float32).reshape(4, 6),
            "opt": [torch.tensor(3, dtype=torch.int64), torch.ones(2, 3, dtype=torch.bool)],
            "b": torch.full((6,), -0.0)}


def _members(path):
    """{member: bytes} of an npz (the zip entries' timestamps aside)."""
    with zipfile.ZipFile(path) as z:
        return {n: z.read(n) for n in z.namelist()}


def _ck(directory, **kw):
    return checkpoint.AsyncCheckpointer(str(directory), process_index=0, process_count=1, **kw)


class TestAsyncCheckpointer:
    @pytest.mark.parametrize("make", [_tree, _torch_tree], ids=["numpy", "torch"])
    def test_round_trip_bitwise(self, tmp_path, make):
        state = make()
        with _ck(tmp_path) as ck:
            ck.save(8, state, {"rows": "abc"})
            ck.wait()
            step, restored, payload = ck.restore(make())
        assert step == 8 and payload == {"rows": "abc"}
        got, _ = checkpoint.tree_flatten(restored)
        for a, b in zip(got, checkpoint.tree_flatten(state)[0]):
            assert type(a) is type(b)
            a, b = np.asarray(a), np.asarray(b)
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()

    def test_snapshot_is_taken_at_save(self, tmp_path):
        """The caller may mutate its tensors as soon as save() returns."""
        t = {"w": torch.zeros(1000)}
        with _ck(tmp_path, commit_delay_s=0.2) as ck:
            ck.save(1, t, None)
            t["w"].add_(1.0)
            ck.wait()
            _, got, _ = ck.restore({"w": torch.empty(1000)})
        assert torch.equal(got["w"], torch.zeros(1000))

    def test_sync_twin_same_bytes(self, tmp_path):
        a, s = str(tmp_path / "a"), str(tmp_path / "s")
        with _ck(a) as ck:
            ck.save(4, _tree(), {"x": 1})
            ck.wait()
        with _ck(s, sync=True) as ck:
            ck.save(4, _tree(), {"x": 1})
        rel = os.path.join("gen-00000004", "shard-00000.npz")
        assert _members(os.path.join(a, rel)) == _members(os.path.join(s, rel))
        assert sorted(os.listdir(os.path.join(a, "gen-00000004"))) == sorted(
            os.listdir(os.path.join(s, "gen-00000004")))

    def test_backpressure_one_commit_in_flight(self, tmp_path):
        m = Metrics()
        ck = _ck(tmp_path, commit_delay_s=0.2, metrics=m)
        ck.save(1, _tree(), None)
        ck.save(2, _tree(), None)  # blocks ~0.2 s on commit 1
        ck.close()
        snap = m.snapshot()
        assert snap["ckpt.commit_wait"]["records"] == 1
        assert snap["ckpt.commit_wait"]["seconds"] >= 0.15
        assert snap["ckpt.commit"]["records"] == 2
        assert snap["ckpt.inflight"] == {"gauge": 0.0}
        assert snap["ckpt.bytes_written"]["records"] > 0

    def test_retention_and_dead_generation_sweep(self, tmp_path):
        d = str(tmp_path)
        dead = os.path.join(d, "gen-00000003")
        os.makedirs(dead)
        open(os.path.join(dead, "shard-00000.npz"), "wb").close()
        m = Metrics()
        with _ck(d, keep=2, metrics=m) as ck:
            for step in (4, 8, 12):
                ck.save(step, _tree(), None)
            ck.wait()
        assert sorted(n for n in os.listdir(d) if n.startswith("gen-")) == [
            "gen-00000008", "gen-00000012"]
        assert m.snapshot()["ckpt.generations_swept"]["records"] == 2

    def test_commit_failure_surfaces_on_next_save(self, tmp_path, monkeypatch):
        ck = _ck(tmp_path)
        monkeypatch.setattr(checkpoint, "durable_write",
                            lambda *a, **k: (_ for _ in ()).throw(OSError("disk full")))
        ck.save(1, _tree(), None)
        with pytest.raises(checkpoint.CheckpointCommitError, match="disk full"):
            ck.save(2, _tree(), None)

    def test_torn_manifest_falls_back_a_generation(self, tmp_path):
        with _ck(tmp_path) as ck:
            ck.save(4, _tree(), {"gen": 4})
            ck.save(8, _tree(), {"gen": 8})
            ck.wait()
            with open(os.path.join(str(tmp_path), "gen-00000008", ck.MANIFEST), "w") as fh:
                fh.write('{"version": 1, "sha')
            step, _, payload = ck.restore(_tree())
        assert step == 4 and payload == {"gen": 4}

    def test_missing_shard_is_incomplete(self, tmp_path):
        with _ck(tmp_path) as ck:
            ck.save(4, _tree(), None)
            ck.wait()
            os.remove(os.path.join(str(tmp_path), "gen-00000004", "shard-00000.npz"))
            assert ck.latest_step() is None
            assert ck.restore(_tree())[0] is None

    def test_clear_removes_all_generations(self, tmp_path):
        with _ck(tmp_path) as ck:
            ck.save(4, _tree(), None)
            ck.clear()
            assert ck.latest_step() is None
            assert not [n for n in os.listdir(str(tmp_path)) if n.startswith("gen-")]

    def test_bf16_leaf_raises_naming_it(self, tmp_path):
        with _ck(tmp_path) as ck:
            with pytest.raises(TypeError, match=r"\['x'\]\[1\].*bfloat16"):
                ck.save(1, {"x": [torch.zeros(2), torch.zeros(2, dtype=torch.bfloat16)]}, None)

    def test_buffers_reused_while_shapes_match(self, tmp_path):
        with _ck(tmp_path) as ck:
            ck.save(1, _torch_tree(), None)
            first = [b.ctypes.data for b in ck._bufs]
            ck.save(2, _torch_tree(), None)
            assert [b.ctypes.data for b in ck._bufs] == first
            ck.save(3, {"other": torch.zeros(3)}, None)
            assert len(ck._bufs) == 1
            ck.wait()


class TestAsyncStateSaver:
    def test_same_file_same_bytes_as_save_state(self, tmp_path):
        st = IteratorState(epoch=1, shard_cursor=3, record_offset=70)
        a, b = str(tmp_path / "a"), str(tmp_path / "b")
        checkpoint.save_state(a, st, step=7, process_index=0)
        with checkpoint.AsyncStateSaver(b, process_index=0) as saver:
            saver.save(st, step=7)
            saver.wait()
        pa, pb = checkpoint.state_path(a, 0), checkpoint.state_path(b, 0)
        assert os.path.basename(pa) == os.path.basename(pb)
        assert open(pa, "rb").read() == open(pb, "rb").read()

    def test_round_trip_through_load_state(self, tmp_path):
        st = IteratorState(epoch=2, shard_cursor=1, record_offset=9)
        with checkpoint.AsyncStateSaver(str(tmp_path), process_index=0) as saver:
            saver.save(st, step=3)
            saver.wait()
        assert checkpoint.load_state(str(tmp_path), process_index=0) == st


# -- cross-restore with the JAX package ---------------------------------------------


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_state_file_loads_in_the_other_package(tmp_path, writer):
    kw = dict(epoch=1, shard_cursor=4, record_offset=33, fingerprint="f" * 32, window_emitted=2)
    a, b = str(tmp_path / "port"), str(tmp_path / "jax")
    checkpoint.save_state(a, IteratorState(**kw), process_index=0, step=5)
    jckpt.save_state(b, JState(**kw), process_index=0, step=5)
    assert open(checkpoint.state_path(a, 0), "rb").read() == open(
        jckpt.state_path(b, 0), "rb").read()
    src = a if writer == "port" else b
    assert jckpt.load_state(src, process_index=0).to_json() == kw
    assert checkpoint.load_state(src, process_index=0).to_json() == kw


class Pair(NamedTuple):
    first: object
    second: object


def _nested():
    rng = np.random.default_rng(0)
    return {
        "z": [rng.normal(size=3), (np.int32(7) * np.ones(2, np.int32), None)],
        "a": Pair(rng.normal(size=(2, 2)).astype(np.float32), {"y": np.arange(3), "b": np.ones(1)}),
        "m": np.array(True),
    }


def test_leaf_order_equals_jax_tree_flatten():
    tree = _nested()
    leaves, treedef = checkpoint.tree_flatten(tree)
    jleaves, _ = jax.tree.flatten(tree)
    assert [id(x) for x in leaves] == [id(x) for x in jleaves]
    back = checkpoint.tree_unflatten(treedef, leaves)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    assert isinstance(back["a"], Pair) and isinstance(back["z"][1], tuple)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_generation_restores_in_the_other_package(tmp_path, writer):
    tree = _nested()
    payload = {"state": {"epoch": 0, "shard_cursor": 1, "record_offset": 2}, "version": 1}
    d = str(tmp_path)
    if writer == "port":
        with _ck(d) as ck:
            ck.save(6, tree, payload)
        reader = jckpt.AsyncCheckpointer(d, process_index=0, process_count=1)
    else:
        with jckpt.AsyncCheckpointer(d, process_index=0, process_count=1) as ck:
            ck.save(6, tree, payload)
        reader = _ck(d)
    with reader:
        step, got, meta = reader.restore(_nested())
    assert step == 6 and meta == payload
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(tree)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


# -- TrainCheckpointer and the DLRM's train state ---------------------------------------


def _small_dlrm(seed):
    cfg = tdlrm.DLRMConfig(num_dense=4, num_categorical=3, vocab_size=16, embed_dim=4,
                           bottom_mlp=(8, 4), top_mlp=(8, 1), interaction="dot",
                           dtype=torch.float32)
    return cfg, tdlrm.init_params(cfg, torch.Generator().manual_seed(seed), "cpu")


def _batch(cfg, seed):
    from tpu_tfrecord_torch.device.ingest import make_device_batch

    return make_device_batch(tdlrm.make_synthetic_batch(cfg, 8, seed=seed), "cpu")


def _flat(tree):
    return [t.clone() for t in checkpoint.tree_flatten(tree)[0]]


@pytest.mark.parametrize("sparse", [True, False], ids=["sparse", "dense"])
def test_train_state_restores_bitwise(tmp_path, sparse):
    out = str(tmp_path / "ds")
    tio.write([[i] for i in range(30)], SCHEMA, out, mode="overwrite")
    cfg, model = _small_dlrm(0)
    adam = lambda ps: torch.optim.Adam(ps, lr=1e-2)  # noqa: E731
    opt = tdlrm.sparse_opt_init(model, cfg, adam) if sparse else adam(list(model.parameters()))
    step = (lambda b: tdlrm.sparse_train_step(model, opt, b, cfg)) if sparse else (
        lambda b: tdlrm.train_step(model, opt, b))
    for k in range(3):
        step(_batch(cfg, k))
    ds = TFRecordDataset(out, batch_size=10, schema=SCHEMA)
    it = ds.batches()
    first = next(it)["uid"].values.tolist()
    with checkpoint.TrainCheckpointer(str(tmp_path / "ck"), max_to_keep=1) as ck:
        ck.save(3, tdlrm.train_state(model, opt), it)
    it.close()
    saved = _flat(tdlrm.train_state(model, opt))
    losses = [float(step(_batch(cfg, k))) for k in range(3, 6)]

    cfg, model = _small_dlrm(9)  # other weights, fresh optimizer state
    opt = tdlrm.sparse_opt_init(model, cfg, adam) if sparse else adam(list(model.parameters()))
    step = (lambda b: tdlrm.sparse_train_step(model, opt, b, cfg)) if sparse else (
        lambda b: tdlrm.train_step(model, opt, b))
    with checkpoint.TrainCheckpointer(str(tmp_path / "ck")) as ck:
        n, tree, resume = ck.restore(tdlrm.train_state(model, opt))
    params = list(model.parameters())
    tdlrm.load_train_state(model, opt, tree)
    assert n == 3 and resume.fingerprint == ds.fingerprint()
    assert all(p is q for p, q in zip(params, model.parameters()))
    for a, b in zip(_flat(tdlrm.train_state(model, opt)), saved):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert [float(step(_batch(cfg, k))) for k in range(3, 6)] == losses
    with TFRecordDataset(out, batch_size=10, schema=SCHEMA).batches(resume) as it2:
        rest = [v for b in it2 for v in b["uid"].values.tolist()]
    assert first + rest == list(range(30))


def test_restore_without_checkpoint(tmp_path):
    with checkpoint.TrainCheckpointer(str(tmp_path / "empty")) as ck:
        step, tpl, resume = ck.restore({"a": np.ones(1)})
    assert step is None and resume is None and list(tpl) == ["a"]


def test_load_train_state_refuses_a_cast():
    cfg, model = _small_dlrm(0)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    tree = tdlrm.train_state(model, opt)
    bad = dict(tree, params=dict(tree["params"], embeddings=tree["params"]["embeddings"].double()))
    with pytest.raises(ValueError, match="embeddings"):
        tdlrm.load_train_state(model, opt, bad)
