"""Host batch densification, the feed to the device, and transfer bit-packing."""

from tpu_tfrecord_torch.device.bitpack import pack_bits, pack_mixed, packed_width, unpack_bits
from tpu_tfrecord_torch.device.ingest import (
    DeviceIterator,
    HostPrefetcher,
    StagingRing,
    hash_bytes_column,
    host_batch_from_columnar,
    make_device_batch,
)

__all__ = [
    "DeviceIterator",
    "HostPrefetcher",
    "StagingRing",
    "hash_bytes_column",
    "host_batch_from_columnar",
    "make_device_batch",
    "pack_bits",
    "pack_mixed",
    "packed_width",
    "unpack_bits",
]
