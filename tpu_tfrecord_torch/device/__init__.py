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
from tpu_tfrecord_torch.device.mesh import (
    assign_shards,
    create_mesh,
    data_sharding,
    local_batch_size,
)

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
