"""Move DLRM weights between the JAX package's pytree and the port's module.

The JAX parameters, as numpy arrays, are a dict::

    {"embeddings": [F, V, D],
     "bottom": [{"w": [in, out], "b": [out]}, ...],
     "top":    [{"w": [in, out], "b": [out]}, ...],
     "seq_proj": {"w": [seq_dim, D], "b": [D]}}      # only with a seq tower

``nn.Linear`` keeps ``weight`` as [out, in], so ``w`` is transposed on the
way in and back on the way out. Values stay float32 and are copied exactly.

The sparse step's row-wise AdaGrad accumulators ([F, V] float32, the
``accum`` of both packages' ``SparseEmbOptState``) move the same way, so
both sides can start from one mid-training state. The optimizer state of
the MLPs (optax's on one side, ``torch.optim``'s on the other) does not.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from tpu_tfrecord_torch.models.dlrm import DLRM, DLRMConfig, SparseEmbOptState


def _f32(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


@torch.no_grad()
def dlrm_params_from_jax(params: Dict[str, Any], cfg: DLRMConfig, device="cuda") -> DLRM:
    """A ``DLRM`` on ``device`` holding the JAX parameter pytree's values."""
    model = DLRM(cfg, device="meta")

    def load_linear(layer: torch.nn.Linear, p: Dict[str, Any]) -> None:
        w, b = np.asarray(p["w"]), np.asarray(p["b"])
        if w.shape != (layer.in_features, layer.out_features):
            raise ValueError(
                f"layer weight {w.shape} does not fit "
                f"({layer.in_features}, {layer.out_features})"
            )
        layer.weight = torch.nn.Parameter(_f32(w.T), requires_grad=False)
        layer.bias = torch.nn.Parameter(_f32(b), requires_grad=False)

    table = np.asarray(params["embeddings"])
    want = (cfg.num_categorical, cfg.vocab_size, cfg.embed_dim)
    if table.shape != want:
        raise ValueError(f"embeddings {table.shape} != {want}")
    model.embeddings = torch.nn.Parameter(_f32(table), requires_grad=False)
    for name in ("bottom", "top"):
        layers = getattr(model, name)
        if len(params[name]) != len(layers):
            raise ValueError(f"{name}: {len(params[name])} layers != {len(layers)}")
        for layer, p in zip(layers, params[name]):
            load_linear(layer, p)
    if cfg.seq_len:
        load_linear(model.seq_proj, params["seq_proj"])
    return model.to(device).requires_grad_(False)


def dlrm_params_to_jax(model: DLRM) -> Dict[str, Any]:
    """The module's weights as the JAX package's numpy parameter pytree."""

    def linear(layer: torch.nn.Linear) -> Dict[str, np.ndarray]:
        return {
            "w": layer.weight.detach().float().cpu().numpy().T.copy(),
            "b": layer.bias.detach().float().cpu().numpy().copy(),
        }

    out: Dict[str, Any] = {
        "embeddings": model.embeddings.detach().float().cpu().numpy().copy()
    }
    for name in ("bottom", "top"):
        layers: List[Dict[str, np.ndarray]] = [linear(l) for l in getattr(model, name)]
        out[name] = layers
    if model.seq_proj is not None:
        out["seq_proj"] = linear(model.seq_proj)
    return out


def sparse_opt_state_from_jax(
    state, cfg: DLRMConfig, dense: torch.optim.Optimizer, device="cuda"
) -> SparseEmbOptState:
    """A ``SparseEmbOptState`` on ``device`` whose accumulators are those of
    the JAX package's ``SparseEmbOptState`` (or of its ``accum`` array)
    ``state``, beside the port's optimizer ``dense`` over the MLPs."""
    accum = np.asarray(getattr(state, "accum", state))
    want = (cfg.num_categorical, cfg.vocab_size)
    if accum.shape != want:
        raise ValueError(f"accum {accum.shape} != {want}")
    return SparseEmbOptState(dense=dense, accum=_f32(accum).to(device))


def sparse_opt_state_to_jax(state: SparseEmbOptState) -> np.ndarray:
    """The accumulators [F, V] as a float32 numpy array, the ``accum`` of a
    JAX ``SparseEmbOptState``."""
    return state.accum.detach().float().cpu().numpy().copy()
