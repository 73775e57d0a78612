"""Device mesh construction and shard assignment.

Port of ``tpu_tfrecord/tpu/mesh.py``. A JAX mesh is laid over devices; a
``torch.distributed`` ``DeviceMesh`` is laid over the ranks of the process
group, one device a rank (``cuda:<rank % device_count>``, so ranks may
share a card). Shards are assigned to processes by the same interleave as
the JAX package, each process feeds its own rows, and the mesh's 'data'
axis carries the global batch (``device.ingest.make_global_batch``).
"""

from __future__ import annotations

import datetime
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import Replicate, Shard

from tpu_tfrecord_torch.device.distributed import GROUP_TIMEOUT_S, process_slot
from tpu_tfrecord_torch.io.paths import Shard as FileShard
from tpu_tfrecord_torch.io.paths import interleave


def _default_device_type() -> str:
    return "cuda" if torch.cuda.is_available() else "cpu"


def _mesh_axes(axes: Optional[Dict[str, int]], n: int) -> Dict[str, int]:
    """``axes`` with its one ``-1`` size worked out, checked to cover ``n``
    ranks; the JAX ``create_mesh``'s checks and messages."""
    axes = dict(axes or {"data": n})
    unknown = [k for k, v in axes.items() if v == -1]
    if len(unknown) > 1:
        raise ValueError("at most one axis size may be -1")
    known = math.prod(v for v in axes.values() if v != -1)
    if unknown:
        if n % known:
            raise ValueError(f"{n} devices not divisible by {known}")
        axes[unknown[0]] = n // known
    if math.prod(axes.values()) != n:
        raise ValueError(f"mesh {axes} does not cover {n} devices")
    return axes


def create_mesh(axes: Optional[Dict[str, int]] = None, device_type: Optional[str] = None
                ) -> DeviceMesh:
    """A ``DeviceMesh`` over the group's ranks with named axis sizes, one of
    which may be -1 (worked out). Default: every rank on a single 'data'
    axis; ``device_type`` defaults to 'cuda' where there is a card, else
    'cpu'. On the card each rank's current device becomes
    ``cuda:<rank % device_count>`` (``mesh_device``). One process with no
    group gets a group of one, in memory."""
    if not dist.is_initialized():
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1,
                                timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    axes = _mesh_axes(axes, dist.get_world_size())
    device_type = device_type or _default_device_type()
    if device_type == "cuda":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    return init_device_mesh(device_type, tuple(axes.values()), mesh_dim_names=tuple(axes))


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device on ``mesh``: ``cuda:<rank % device_count>`` or
    the CPU."""
    if mesh.device_type == "cpu":
        return torch.device("cpu")
    return torch.device(mesh.device_type, dist.get_rank() % torch.cuda.device_count())


def data_sharding(mesh: DeviceMesh, axis: str = "data", ndim: int = 1) -> Tuple:
    """The DTensor placements of an array whose dim 0 is sharded on
    ``axis``: ``Shard(0)`` on that mesh dim, ``Replicate()`` on the others.
    (``ndim`` is kept for the JAX signature: placements name mesh dims,
    not tensor dims, so it does not change them.)"""
    names = mesh.mesh_dim_names or ()
    if axis not in names:
        raise ValueError(f"mesh has no axis {axis!r} (axes {names})")
    return tuple(Shard(0) if name == axis else Replicate() for name in names)


def local_batch_size(global_batch: int, mesh: DeviceMesh, axis: str = "data") -> int:
    """This process's rows of a global batch sharded on ``axis``."""
    names = list(mesh.mesh_dim_names or ())
    axis_size = mesh.size(names.index(axis))
    if global_batch % axis_size:
        raise ValueError(f"global batch {global_batch} not divisible by {axis_size}")
    pc = process_slot()[1]
    if global_batch % pc:
        raise ValueError(f"global batch {global_batch} not divisible by process count {pc}")
    return global_batch // pc


def assign_shards(
    shards: Sequence[FileShard],
    process_index: Optional[int] = None,
    process_count: Optional[int] = None,
) -> List[FileShard]:
    """This process's shards: ``i % process_count == process_index`` over
    the global order (``discover_shards`` sorts), the slot taken from the
    group where it is not given. Static, so resume and every process
    agree without talking."""
    index, count = process_slot()
    return interleave(shards, index if process_index is None else process_index,
                      count if process_count is None else process_count)
