"""Host batch densification, token packing, the feed to the device, the
process mesh and its global batches, and transfer bit-packing."""

from tpu_tfrecord_torch.device.bitpack import pack_bits, pack_mixed, packed_width, unpack_bits
from tpu_tfrecord_torch.device.ingest import (
    DeviceIterator,
    HostPrefetcher,
    StagingRing,
    TokenPacker,
    data_shardings,
    hash_bytes_column,
    host_batch_from_columnar,
    make_device_batch,
    make_global_batch,
)

# ``device.mesh`` imports torch's DeviceMesh and DTensor (about a second of
# imports, sympy included): loaded on first use, so that a process that
# never places tensors on a mesh does not pay for it at start
_MESH_NAMES = ("assign_shards", "create_mesh", "data_sharding", "local_batch_size")


def __getattr__(name):
    if name in _MESH_NAMES:
        from tpu_tfrecord_torch.device import mesh

        return getattr(mesh, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

__all__ = [
    "create_mesh",
    "data_sharding",
    "assign_shards",
    "local_batch_size",
    "data_shardings",
    "make_global_batch",
    "DeviceIterator",
    "HostPrefetcher",
    "StagingRing",
    "TokenPacker",
    "hash_bytes_column",
    "host_batch_from_columnar",
    "make_device_batch",
    "pack_bits",
    "pack_mixed",
    "packed_width",
    "unpack_bits",
]
