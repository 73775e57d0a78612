"""The port's shard split and mesh shapes against the JAX package's.

``device.mesh.assign_shards`` with an explicit slot (and ``io.paths``'s
``interleave`` / ``interleave_owner`` under it) against the JAX
``tpu.mesh.assign_shards`` for 1-5 processes over 0-11 shards; the mesh
axes ``create_mesh`` works out (one ``-1`` size), and the errors it
raises, against the JAX ``create_mesh`` over the same number of devices.
The meshes themselves, ``data_sharding`` and ``local_batch_size`` need a
process group: ``tests/test_torch_distributed.py`` checks them on 2 and 4
processes."""

import jax
import pytest
import torch

from tpu_tfrecord.io import paths as jpaths
from tpu_tfrecord.tpu import mesh as jmesh

from tpu_tfrecord_torch.device import mesh as tmesh
from tpu_tfrecord_torch.io import paths as tpaths

torch.set_num_threads(1)


def shards(n, module):
    return [module.Shard(f"/data/part-{i:05d}.tfrecord", 100 + i, ()) for i in range(n)]


@pytest.mark.parametrize("count", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("n", range(12))
def test_assign_shards_matches_jax(count, n):
    every = []
    for slot in range(count):
        want = [sh.path for sh in jmesh.assign_shards(shards(n, jpaths), slot, count)]
        got = [sh.path for sh in tmesh.assign_shards(shards(n, tpaths), slot, count)]
        assert got == want
        assert got == [sh.path for sh in tpaths.interleave(shards(n, tpaths), slot, count)]
        every += got
    # every shard has exactly one owner, the one interleave_owner names
    assert sorted(every) == [sh.path for sh in shards(n, tpaths)]
    for i in range(n):
        assert tpaths.interleave_owner(i, count) == jpaths.interleave_owner(i, count)


def test_assign_shards_defaults_to_one_process():
    """No process group: slot 0 of 1, every shard."""
    assert tmesh.assign_shards(shards(5, tpaths)) == shards(5, tpaths)


@pytest.mark.parametrize("slot,count", [(0, 0), (-1, 2), (2, 2), (5, 3)])
def test_interleave_errors_match_jax(slot, count):
    with pytest.raises(ValueError) as want:
        jpaths.interleave([1, 2, 3], slot, count)
    with pytest.raises(ValueError) as got:
        tpaths.interleave([1, 2, 3], slot, count)
    assert str(got.value) == str(want.value)
    if count < 1:
        with pytest.raises(ValueError, match=str(want.value)):
            tpaths.interleave_owner(0, count)


AXES = [
    None,
    {"data": -1},
    {"data": -1, "model": 2},
    {"data": 2, "model": -1},
    {"data": 2, "model": 2},
    {"a": -1, "b": -1},
    {"data": 3},
    {"data": -1, "model": 3},
    {"data": 8},
]


@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("axes", AXES, ids=lambda a: "default" if a is None else
                         ",".join(f"{k}={v}" for k, v in a.items()))
def test_mesh_axes_match_jax(axes, n):
    devices = jax.devices()[:n]
    assert len(devices) == n
    try:
        want = dict(jmesh.create_mesh(axes, devices).shape)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tmesh._mesh_axes(axes, n)
        assert str(got.value) == str(e)
        return
    got = tmesh._mesh_axes(axes, n)
    assert got == want
    assert list(got) == list(want)  # axis order, the mesh dims' order
