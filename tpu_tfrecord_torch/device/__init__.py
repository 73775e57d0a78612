"""Host batch densification and the host-to-device copy."""

from tpu_tfrecord_torch.device.ingest import (
    hash_bytes_column,
    host_batch_from_columnar,
    make_device_batch,
)

__all__ = ["hash_bytes_column", "host_batch_from_columnar", "make_device_batch"]
