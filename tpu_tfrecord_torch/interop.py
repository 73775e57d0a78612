"""Move weights and optimizer state between the JAX package's pytrees and
the port.

The DLRM's weights go into and out of the port's ``nn.Module``:

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

The sequence models (``models.long_doc``, ``models.lm``) keep the JAX
pytree as it is, with tensors for leaves, so their parameters move leaf
for leaf (``long_doc_params_from_jax`` / ``_to_jax``, ``lm_params_from_jax``
/ ``_to_jax``), checked against the structure and shapes ``init_params``
gives for the config, the MoE FFN's ``moe`` subtree included. Their Adam
state moves too: optax's
``ScaleByAdamState(count, mu, nu)`` to and from ``torch.optim.Adam``'s
``step``, ``exp_avg`` and ``exp_avg_sq`` (``adam_state_from_jax`` /
``adam_state_to_jax``).
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from tpu_tfrecord_torch.checkpoint import tree_flatten, tree_flatten_with_path, tree_unflatten
from tpu_tfrecord_torch.models import lm, long_doc, optim
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


def _tree_from_jax(tree, template, device, what: str):
    """The JAX pytree ``tree`` as float32 tensors on ``device`` in the
    template's structure; its leaf paths and shapes must be the
    template's."""
    got = tree_flatten_with_path(tree)[0]
    want = tree_flatten_with_path(template)[0]
    if [p for p, _ in got] != [p for p, _ in want]:
        raise ValueError(f"{what}: leaves {[p for p, _ in got]} != {[p for p, _ in want]}")
    leaves = []
    for (path, a), (_, t) in zip(got, want):
        if tuple(np.shape(a)) != tuple(t.shape):
            raise ValueError(f"{what}{path}: shape {np.shape(a)} != {tuple(t.shape)}")
        leaves.append(_f32(a).to(device))
    return tree_unflatten(tree_flatten(template)[1], leaves)


def _tree_to_jax(tree):
    leaves, treedef = tree_flatten(tree)
    return tree_unflatten(treedef, [l.detach().float().cpu().numpy().copy() for l in leaves])


def long_doc_params_from_jax(params, cfg: long_doc.LongDocConfig, device="cuda"):
    """The port's ``long_doc`` parameter tree on ``device`` holding the
    JAX ``long_doc.init_params`` pytree's values."""
    return _tree_from_jax(params, long_doc.init_params(cfg, device="cpu"), device, "long_doc")


def long_doc_params_to_jax(params):
    """The port's ``long_doc`` parameters as the JAX numpy pytree."""
    return _tree_to_jax(params)


def lm_params_from_jax(params, cfg: lm.LMConfig, device="cuda"):
    """The port's ``lm`` parameter tree on ``device`` holding the JAX
    ``lm.init_params`` pytree's values."""
    return _tree_from_jax(params, lm.init_params(cfg, device="cpu"), device, "lm")


def lm_params_to_jax(params):
    """The port's ``lm`` parameters as the JAX numpy pytree."""
    return _tree_to_jax(params)


def adam_state_from_jax(state, params, opt: torch.optim.Adam) -> None:
    """Load an ``optax.adam`` state (its ``(ScaleByAdamState, EmptyState)``
    or the ``ScaleByAdamState`` alone) into ``opt``'s state of ``params``."""
    if "count" not in getattr(state, "_fields", ()):
        state = state[0]
    optim.load_adam_state(params, opt, optim.ScaleByAdamState(state.count, state.mu, state.nu))


def adam_state_to_jax(params, opt: torch.optim.Adam) -> optim.ScaleByAdamState:
    """``opt``'s state of ``params`` as a ``ScaleByAdamState`` of numpy
    arrays (``count`` int32; ``optax.ScaleByAdamState(*it)`` rebuilds
    optax's)."""
    st = optim.adam_state(params, opt)[0]
    return optim.ScaleByAdamState(st.count.numpy().copy(), _tree_to_jax(st.mu), _tree_to_jax(st.nu))
