"""Model families of the port: the Criteo DLRM, its dot interaction and
its train steps; the long-document classifier (``long_doc``) and the causal
LM (``lm``) over dense attention (``attention``), trained with Adam over a
parameter tree (``optim``) and served through the one-device pipeline
schedule (``pipeline``). The flat names are the DLRM's, as in the JAX
package; each sequence family's API lives on its module."""

from tpu_tfrecord_torch.models import attention, lm, long_doc, optim, pipeline
from tpu_tfrecord_torch.models.attention import attention_reference
from tpu_tfrecord_torch.models.dlrm import (
    DLRM,
    DLRMConfig,
    SparseEmbOptState,
    init_params,
    load_train_state,
    loss_fn,
    make_synthetic_batch,
    sparse_opt_init,
    sparse_train_step,
    train_state,
    train_step,
)
from tpu_tfrecord_torch.models.interaction import (
    DotInteraction,
    dot_interaction,
    dot_interaction_backward_reference,
    dot_interaction_cuda,
    dot_interaction_reference,
)
from tpu_tfrecord_torch.models.lm import LMConfig
from tpu_tfrecord_torch.models.long_doc import LongDocConfig

__all__ = [
    "DLRM",
    "DLRMConfig",
    "DotInteraction",
    "LMConfig",
    "LongDocConfig",
    "SparseEmbOptState",
    "attention",
    "attention_reference",
    "dot_interaction",
    "dot_interaction_backward_reference",
    "dot_interaction_cuda",
    "dot_interaction_reference",
    "init_params",
    "lm",
    "load_train_state",
    "long_doc",
    "loss_fn",
    "make_synthetic_batch",
    "optim",
    "pipeline",
    "sparse_opt_init",
    "sparse_train_step",
    "train_state",
    "train_step",
]
