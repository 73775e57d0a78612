"""Multi-process ingest over ``torch.distributed`` against the JAX package.

The module spawns real gloo process groups of 2 and 4 CPU processes, once
each (module-scoped fixture), every process running this file as its
worker (``python test_torch_distributed.py worker SPEC``, importing only
the port). The group of 2 joins through ``initialize(addr, 2, rank)``, the
group of 4 through ``torchrun``'s environment (``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR``, ``MASTER_PORT``). Each rank writes what it saw to a JSON
file; the tests hold it against the JAX package, run in this process:

- ``infer_schema_multihost`` over shards whose schemas differ equals the
  JAX ``infer_schema_all_files`` on every rank; a corrupt shard in rank
  1's slice makes every rank raise ``DistributedInferenceError`` naming
  process 1 alone (the JAX ``multihost_infer_error_worker``'s check);
- ``make_global_batch`` on a CPU mesh gives DTensors of global batch
  P x B whose ``full_tensor()`` is the JAX slot batches concatenated in
  rank order, and ``DeviceIterator(mesh=...)`` hands over the same;
- ``finalize_distributed_write``: one ``_SUCCESS``, plain and
  ``partition_by`` part files from every rank, every row read back;
- one trace id on every rank, rank 0's span the others' parent;
- ``AsyncCheckpointer(barrier=...)`` writes the manifest after every
  rank's shard landed, and each rank restores its own;
- ``allgather_bytes``, ``assert_same_across_hosts``, ``create_mesh``,
  ``data_sharding`` and ``local_batch_size`` (messages against JAX).

Every spawn is waited on with a timeout that kills the group and fails.
"""

import json
import os
import shutil
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH = 8
ROWS = [24, 17, 30, 19, 26, 20]    # rows a shard: every slot reads 2 batches or more
DAYS = ("d0", "d1", "d2")
PAD_IDS = 3
GROUP_TIMEOUT_S = 180             # the whole group, from spawn to exit
CORRUPT_SHARD = 1                 # in rank 1's slice at P = 2 and at P = 4
LOCAL_BATCHES = (8, 12, 7, 6, 2)  # global batches for local_batch_size


# -- the worker (imports the port only) -------------------------------------------


def _port_write_schema():
    from tpu_tfrecord_torch.schema import FloatType, LongType, StringType, StructField, StructType

    return StructType([StructField("uid", LongType()), StructField("x", FloatType()),
                       StructField("day", StringType())])


def _port_read_schema():
    from tpu_tfrecord_torch.schema import (ArrayType, FloatType, LongType, StringType,
                                           StructField, StructType)

    return StructType([StructField("uid", LongType()), StructField("x", FloatType()),
                       StructField("ids", ArrayType(LongType())),
                       StructField("day", StringType())])


def _tolist(t):
    return t.full_tensor().tolist()


def run_worker(spec: dict) -> dict:
    sys.path.insert(0, REPO)
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from tpu_tfrecord_torch import io as tio
    from tpu_tfrecord_torch.checkpoint import AsyncCheckpointer
    from tpu_tfrecord_torch.device import distributed, mesh as meshes
    from tpu_tfrecord_torch.device.ingest import (DeviceIterator, host_batch_from_columnar,
                                                  make_global_batch)
    from tpu_tfrecord_torch.io.dataset import TFRecordDataset
    from tpu_tfrecord_torch.io.writer import DatasetWriter

    count = spec["count"]
    if spec["explicit"]:
        distributed.initialize(spec["addr"], count, spec["rank"])
    else:
        distributed.initialize()  # torchrun's environment
    rank = distributed.process_index()
    res = {"rank": rank, "slot": list(distributed.process_slot())}
    res["trace"] = distributed.adopt_shared_trace_context("test_rank").to_json()
    res["gathered"] = [g.hex() for g in distributed.allgather_bytes(b"r" * rank)]
    distributed.assert_same_across_hosts(b"same", "same")
    try:
        distributed.assert_same_across_hosts(str(rank).encode(), "rank")
    except RuntimeError as e:
        res["divergent"] = str(e)
    res["service"] = distributed.shared_service_address("127.0.0.1:7000")

    res["schema"] = tio.reader(spec["mixed"]).infer_schema_multihost(num_workers=2).json()
    try:
        tio.reader(spec["corrupt"]).infer_schema_multihost()
    except distributed.DistributedInferenceError as e:
        res["corrupt"] = str(e)

    mesh = meshes.create_mesh(device_type="cpu")
    res["mesh"] = dict(shape=list(mesh.shape), names=list(mesh.mesh_dim_names),
                       device=str(meshes.mesh_device(mesh)),
                       sharded=meshes.data_sharding(mesh) == (Shard(0),))
    if count % 2 == 0:
        grid = meshes.create_mesh({"data": -1, "model": 2}, device_type="cpu")
        res["grid"] = dict(shape=list(grid.shape), names=list(grid.mesh_dim_names),
                           sharded=meshes.data_sharding(grid, "data", 2) == (Shard(0), Replicate()))
    local = {}
    for g in LOCAL_BATCHES:
        try:
            local[g] = meshes.local_batch_size(g, mesh)
        except ValueError as e:
            local[g] = str(e)
    res["local_batch_size"] = local

    def dataset(drop_remainder=True):
        return TFRecordDataset(spec["data"], BATCH, schema=_port_read_schema(),
                               drop_remainder=drop_remainder, process_index=rank,
                               process_count=count)

    def to_host(cb):
        return host_batch_from_columnar(cb, _port_read_schema(), pad_to={"ids": PAD_IDS})

    with dataset().batches() as it:
        gb = make_global_batch(to_host(next(it)), mesh)
    res["global"] = {k: dict(type=type(v).__name__, shape=list(v.shape),
                             local=list(v.to_local().shape),
                             sharded=v.placements == (Shard(0),), full=_tolist(v))
                     for k, v in sorted(gb.items())}
    with dataset().batches() as it, DeviceIterator(map(to_host, it), mesh=mesh) as dev:
        handed = [next(dev) for _ in range(2)]
    res["iterator"] = [{k: dict(type=type(v).__name__, full=_tolist(v))
                        for k, v in sorted(b.items())} for b in handed]
    res["iterator_device"] = str(dev.device)

    rows = []
    with dataset(drop_remainder=False).batches() as it:
        for cb in it:
            days = [bytes(cb["day"].blob[a:b]).decode() for a, b in
                    zip(cb["day"].blob_offsets[:-1], cb["day"].blob_offsets[1:])]
            rows += [[int(u), float(x), d] for u, x, d in
                     zip(cb["uid"].values, cb["x"].values, days)]
    res["rows"] = rows
    for name, part in (("plain", None), ("partitioned", ["day"])):
        out = os.path.join(spec["out"], name)
        DatasetWriter(out, _port_write_schema(), partition_by=part, mode="append",
                      write_success=False).write_rows(rows, task_id=rank)
        distributed.finalize_distributed_write(out)
        res[f"success_{name}"] = os.path.exists(os.path.join(out, "_SUCCESS"))

    tree = {"w": torch.full((3,), float(rank)), "n": np.arange(4) * rank}
    with AsyncCheckpointer(spec["ckpt"], keep=2, barrier=lambda: distributed.barrier("ckpt"),
                           commit_delay_s=0.3 if rank == count - 1 else 0.0) as ck:
        ck.save(4, tree, {"rank": rank})
        ck.wait()
        distributed.barrier("saved")
        step, back, payload = ck.restore({"w": torch.zeros(3), "n": np.zeros(4, np.int64)})
    res["ckpt"] = dict(step=step, w=back["w"].tolist(), n=back["n"].tolist(), payload=payload,
                       process_count=ck.process_count)
    res["jax_loaded"] = sorted(m for m in sys.modules if m.split(".")[0] in
                               ("jax", "jaxlib", "tpu_tfrecord"))
    distributed.barrier("done")
    torch.distributed.destroy_process_group()
    assert all(isinstance(v, DTensor) for b in handed for v in b.values())
    return res


def worker_main(argv) -> int:
    spec = json.loads(argv[1])
    torch.set_num_threads(1)
    res = run_worker(spec)
    with open(os.path.join(spec["results"], f"rank{res['rank']}.json"), "w") as fh:
        json.dump(res, fh)
    return 0


# -- the parent ----------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _example(uid, x, ids, day, mod):
    F = mod.Feature
    return mod.encode_example(mod.Example(features={
        "uid": F.int64_list([uid]), "x": F.float_list([x]), "ids": F.int64_list(ids),
        "day": F.bytes_list([day.encode()])}))


def _write_data(d):
    """Six shards of (uid, x, ids, day) Examples, uid unique."""
    from tpu_tfrecord import proto, wire

    os.makedirs(d)
    uid = 0
    for k, n in enumerate(ROWS):
        recs = []
        for _ in range(n):
            recs.append(_example(uid, uid / 8.0, list(range(uid % (PAD_IDS + 1))),
                                 DAYS[uid % len(DAYS)], proto))
            uid += 1
        wire.write_records(os.path.join(d, f"part-{k:05d}.tfrecord"), recs)


def _write_mixed(d):
    """Six shards whose schemas differ: ``v`` is int64 in even shards and
    float in odd ones, ``only<k>`` is in shard k alone, ``tags`` is a
    string list that is empty in some shards."""
    from tpu_tfrecord import proto, wire

    F = proto.Feature
    os.makedirs(d)
    for k in range(6):
        recs = []
        for i in range(5 + k):
            feats = {"uid": F.int64_list([100 * k + i]),
                     "v": F.int64_list([i]) if k % 2 == 0 else F.float_list([i + 0.5]),
                     f"only{k}": F.bytes_list([b"x"] * (i % 3))}
            if k % 3:
                feats["tags"] = F.bytes_list([b"t%d" % j for j in range(i % 2 + 1)])
            recs.append(proto.encode_example(proto.Example(features=feats)))
        wire.write_records(os.path.join(d, f"part-{k:05d}.tfrecord"), recs)


def _corrupt_copy(src, dst):
    shutil.copytree(src, dst)
    path = os.path.join(dst, f"part-{CORRUPT_SHARD:05d}.tfrecord")
    data = bytearray(open(path, "rb").read())
    data[20] ^= 0xFF  # inside the first record's payload: its CRC fails
    open(path, "wb").write(bytes(data))


def _spawn_group(base, count: int, explicit: bool) -> dict:
    spec = {"count": count, "explicit": explicit, "data": os.path.join(base, "data"),
            "mixed": os.path.join(base, "mixed"), "corrupt": os.path.join(base, "corrupt"),
            "out": os.path.join(base, "out"), "ckpt": os.path.join(base, "ckpt"),
            "results": os.path.join(base, "results")}
    _write_data(spec["data"])
    _write_mixed(spec["mixed"])
    _corrupt_copy(spec["mixed"], spec["corrupt"])
    os.makedirs(spec["results"])
    port = _free_port()
    spec["addr"] = f"127.0.0.1:{port}"
    procs = []
    for rank in range(count):
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        env.update(OMP_NUM_THREADS="1")
        if explicit:
            spec_r = dict(spec, rank=rank)
        else:
            spec_r = spec
            env.update(RANK=str(rank), WORLD_SIZE=str(count), MASTER_ADDR="127.0.0.1",
                       MASTER_PORT=str(port))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "worker", json.dumps(spec_r)],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    deadline = time.monotonic() + GROUP_TIMEOUT_S
    logs = []
    try:
        for proc in procs:
            out, err = proc.communicate(timeout=max(1.0, deadline - time.monotonic()))
            logs.append((proc.returncode, err[-3000:]))
    except subprocess.TimeoutExpired:
        for proc in procs:
            proc.kill()
        for proc in procs:
            proc.communicate()
        pytest.fail(f"the group of {count} did not finish within {GROUP_TIMEOUT_S} s")
    bad = [(rank, rc, err) for rank, (rc, err) in enumerate(logs) if rc != 0]
    if bad:
        with open(os.path.join(base, "failed.log"), "w") as fh:
            fh.write(json.dumps(bad, indent=1))
    assert not bad, bad
    spec["ranks"] = [json.load(open(os.path.join(spec["results"], f"rank{r}.json")))
                     for r in range(count)]
    return spec


@pytest.fixture(scope="module", params=[2, 4], ids=["P2", "P4"])
def group(request, tmp_path_factory):
    count = request.param
    return _spawn_group(str(tmp_path_factory.mktemp(f"dist{count}")), count,
                        explicit=count == 2)


def _jax_read_schema():
    from tpu_tfrecord.schema import (ArrayType, FloatType, LongType, StringType, StructField,
                                     StructType)

    return StructType([StructField("uid", LongType()), StructField("x", FloatType()),
                       StructField("ids", ArrayType(LongType())),
                       StructField("day", StringType())])


def _jax_slot_batches(group, index, n):
    """The first ``n`` host batches of the JAX dataset on slot ``index``."""
    from tpu_tfrecord.io.dataset import TFRecordDataset
    from tpu_tfrecord.tpu.ingest import host_batch_from_columnar

    ds = TFRecordDataset(group["data"], BATCH, schema=_jax_read_schema(),
                         process_index=index, process_count=group["count"])
    out = []
    with ds.batches() as it:
        for cb, _ in zip(it, range(n)):
            out.append(host_batch_from_columnar(cb, _jax_read_schema(), pad_to={"ids": PAD_IDS}))
    return out


def _jax_global(group, k):
    """Batch ``k`` of every slot, concatenated in rank order."""
    slots = [_jax_slot_batches(group, r, k + 1)[k] for r in range(group["count"])]
    return {name: np.concatenate([s[name] for s in slots]) for name in slots[0]}


def test_initialize_joins_every_rank(group):
    count = group["count"]
    assert [r["slot"] for r in group["ranks"]] == [[r, count] for r in range(count)]


def test_allgather_bytes_in_rank_order(group):
    want = [(b"r" * r).hex() for r in range(group["count"])]  # rank 0 sends nothing
    assert all(r["gathered"] == want for r in group["ranks"])


def test_assert_same_across_hosts(group):
    for r in group["ranks"]:
        assert r["divergent"] == "rank differs across hosts"
        assert r["service"] == "127.0.0.1:7000"


def test_infer_schema_multihost_equals_jax(group):
    from tpu_tfrecord.io.reader import DatasetReader

    want = DatasetReader(group["mixed"]).infer_schema_all_files().json()
    assert all(r["schema"] == want for r in group["ranks"])
    fields = {f["name"]: f["type"] for f in json.loads(want)["fields"]}
    assert fields["v"] == "float" and {f"only{k}" for k in range(6)} <= set(fields)


def test_corrupt_shard_fails_every_rank_naming_its_owner(group):
    for r in group["ranks"]:
        msg = r["corrupt"]
        assert msg.startswith("schema inference failed on 1 process(es): process 1: ")
        assert f"part-{CORRUPT_SHARD:05d}" in msg
        assert "process 0" not in msg


def test_create_mesh_and_local_batch_size(group):
    import jax

    from tpu_tfrecord.tpu import mesh as jmesh

    count = group["count"]
    jax_mesh = jmesh.create_mesh(None, jax.devices()[:count])
    for r in group["ranks"]:
        assert r["mesh"] == dict(shape=[count], names=["data"], device="cpu", sharded=True)
        if count % 2 == 0:
            assert r["grid"] == dict(shape=[count // 2, 2], names=["data", "model"], sharded=True)
        for g in LOCAL_BATCHES:
            got = r["local_batch_size"][str(g)]
            try:
                jmesh.local_batch_size(g, jax_mesh)
            except ValueError as e:
                assert got == str(e)  # the axis is every process: same check, same words
                continue
            assert got == g // count


def test_make_global_batch_equals_jax_slot_batches(group):
    count = group["count"]
    want = _jax_global(group, 0)
    for r in group["ranks"]:
        got = r["global"]
        assert sorted(got) == sorted(want)
        for name, arr in want.items():
            g = got[name]
            assert g["type"] == "DTensor"
            assert g["shape"] == [count * BATCH, *arr.shape[1:]] == list(arr.shape)
            assert g["local"] == [BATCH, *arr.shape[1:]]
            assert g["sharded"]
            np.testing.assert_array_equal(np.asarray(g["full"], dtype=arr.dtype), arr)


def test_device_iterator_hands_over_global_batches(group):
    for k in range(2):
        want = _jax_global(group, k)
        for r in group["ranks"]:
            assert r["iterator_device"] == "cpu"
            got = r["iterator"][k]
            assert sorted(got) == sorted(want)
            for name, arr in want.items():
                assert got[name]["type"] == "DTensor"
                np.testing.assert_array_equal(np.asarray(got[name]["full"], dtype=arr.dtype), arr)


def test_finalize_distributed_write_one_success(group):
    from tpu_tfrecord.io.dataset import TFRecordDataset

    count = group["count"]
    rows = sorted(tuple(row) for r in group["ranks"] for row in r["rows"])
    assert [row[0] for row in rows] == list(range(sum(ROWS)))
    for name in ("plain", "partitioned"):
        root = os.path.join(group["out"], name)
        assert all(r[f"success_{name}"] for r in group["ranks"])
        markers = [os.path.join(d, f) for d, _, fs in os.walk(root) for f in fs
                   if f == "_SUCCESS"]
        assert markers == [os.path.join(root, "_SUCCESS")]
        parts = [f for _, _, fs in os.walk(root) for f in fs if f.startswith("part-")]
        assert sorted({int(f.split("-")[1]) for f in parts}) == list(range(count))
        ds = TFRecordDataset(root, 64, drop_remainder=False)
        back = []
        with ds.batches() as it:
            for cb in it:
                day = cb["day"]
                days = [bytes(day.blob[a:b]).decode()
                        for a, b in zip(day.blob_offsets[:-1], day.blob_offsets[1:])] \
                    if day.blob is not None else [str(v) for v in day.values]
                back += [(int(u), float(x), d) for u, x, d in
                         zip(cb["uid"].values, cb["x"].values, days)]
        assert sorted(back) == rows


def test_shared_trace_id(group):
    ranks = group["ranks"]
    root = ranks[0]["trace"]
    assert root["parent_span_id"] is None
    for r in ranks:
        assert r["trace"]["trace_id"] == root["trace_id"]
        assert r["trace"]["role"] == "test_rank"
        assert r["trace"]["pid"] != 0
    for r in ranks[1:]:
        assert r["trace"]["parent_span_id"] == root["span_id"]
        assert r["trace"]["span_id"] != root["span_id"]


def test_checkpoint_manifest_after_every_shard(group):
    count = group["count"]
    gen = os.path.join(group["ckpt"], "gen-00000004")
    manifest = json.load(open(os.path.join(gen, "MANIFEST.json")))
    assert manifest["process_count"] == count
    assert manifest["shards"] == [f"shard-{r:05d}.npz" for r in range(count)]
    landed = os.stat(os.path.join(gen, "MANIFEST.json")).st_mtime_ns
    # the last rank commits 0.3 s late; rank 0 waited for it at the barrier
    assert all(os.stat(os.path.join(gen, s)).st_mtime_ns <= landed for s in manifest["shards"])
    for r in group["ranks"]:
        rank = r["rank"]
        assert r["ckpt"] == dict(step=4, w=[float(rank)] * 3, n=[0, rank, 2 * rank, 3 * rank],
                                 payload={"rank": rank}, process_count=count)


ALONE = r"""
import json, os, sys
sys.path.insert(0, {repo!r})
import numpy as np, torch
torch.set_num_threads(1)
from tpu_tfrecord_torch.device import distributed, mesh as meshes
from tpu_tfrecord_torch.device.ingest import make_global_batch
distributed.initialize()  # one process, no address: nothing to join
before = torch.distributed.is_initialized()
mesh = meshes.create_mesh(device_type="cpu")
gb = make_global_batch({{"a": np.arange(6), "b": np.ones((6, 2), np.float32)}}, mesh)
distributed.barrier("alone")
distributed.finalize_distributed_write({out!r})
print(json.dumps(dict(
    before=before, slot=list(distributed.process_slot()), shape=list(mesh.shape),
    global_shapes={{k: list(v.shape) for k, v in gb.items()}},
    full=gb["a"].full_tensor().tolist(), gathered=[g.decode() for g in
    distributed.allgather_bytes(b"solo")], success=os.path.exists({out!r} + "/_SUCCESS"),
    shards=meshes.assign_shards(list("abc")))))
"""


def test_one_process_without_a_group(tmp_path):
    """One process, no address and no ``torchrun`` environment:
    ``initialize`` is a no-op, ``create_mesh`` makes a group of one in
    memory, a global batch is the local one, barriers and the write's
    commit run alone, ``allgather_bytes`` is the identity."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")}
    out = str(tmp_path / "out")
    os.makedirs(out)
    proc = subprocess.run([sys.executable, "-c", ALONE.format(repo=REPO, out=out)], env=env,
                          cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got == dict(before=False, slot=[0, 1], shape=[1],
                       global_shapes={"a": [6], "b": [6, 2]}, full=list(range(6)),
                       gathered=["solo"], success=True, shards=["a", "b", "c"])


def test_commit_sweeps_only_its_own_tmp_orphans(tmp_path):
    """A commit removes this process's tmp orphans in the generation, never
    another process's tmp twin, which may be in flight (4 processes racing
    on one directory lost shards that way)."""
    from tpu_tfrecord_torch.checkpoint import AsyncCheckpointer

    gen = tmp_path / "gen-00000004"
    gen.mkdir()
    names = ["shard-00000.npz.tmp.11", "shard-00001.npz.tmp.12", "MANIFEST.json.tmp.13"]
    for name in names:
        (gen / name).write_bytes(b"x")
    # process 1 of 2 sweeps its own shard's orphan alone ...
    with AsyncCheckpointer(str(tmp_path), process_index=1, process_count=2, sync=True) as ck:
        ck.save(4, {"w": np.zeros(2)})
    assert {n for n in os.listdir(gen) if ".tmp." in n} == set(names) - {names[1]}
    # ... process 0 its shard's and the manifest's
    with AsyncCheckpointer(str(tmp_path), process_index=0, process_count=2, sync=True) as ck:
        ck.save(4, {"w": np.zeros(2)})
    assert not [n for n in os.listdir(gen) if ".tmp." in n]
    assert sorted(n for n in os.listdir(gen)) == ["MANIFEST.json", "shard-00000.npz",
                                                  "shard-00001.npz"]


def test_workers_load_no_jax(group):
    assert all(r["jax_loaded"] == [] for r in group["ranks"])


if __name__ == "__main__":
    sys.exit(worker_main(sys.argv[1:]))
