"""Model families of the port: the Criteo DLRM and its dot interaction."""

from tpu_tfrecord_torch.models.dlrm import (
    DLRM,
    DLRMConfig,
    init_params,
    loss_fn,
    make_synthetic_batch,
)
from tpu_tfrecord_torch.models.interaction import (
    dot_interaction,
    dot_interaction_cuda,
    dot_interaction_reference,
)

__all__ = [
    "DLRM",
    "DLRMConfig",
    "dot_interaction",
    "dot_interaction_cuda",
    "dot_interaction_reference",
    "init_params",
    "loss_fn",
    "make_synthetic_batch",
]
