"""Model families of the port: the Criteo DLRM, its dot interaction and
its train steps."""

from tpu_tfrecord_torch.models.dlrm import (
    DLRM,
    DLRMConfig,
    SparseEmbOptState,
    init_params,
    loss_fn,
    make_synthetic_batch,
    sparse_opt_init,
    sparse_train_step,
    train_step,
)
from tpu_tfrecord_torch.models.interaction import (
    DotInteraction,
    dot_interaction,
    dot_interaction_backward_reference,
    dot_interaction_cuda,
    dot_interaction_reference,
)

__all__ = [
    "DLRM",
    "DLRMConfig",
    "DotInteraction",
    "SparseEmbOptState",
    "dot_interaction",
    "dot_interaction_backward_reference",
    "dot_interaction_cuda",
    "dot_interaction_reference",
    "init_params",
    "loss_fn",
    "make_synthetic_batch",
    "sparse_opt_init",
    "sparse_train_step",
    "train_step",
]
