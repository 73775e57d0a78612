"""Adam over a parameter tree, with its state in optax's layout.

The sequence models keep their parameters as the JAX package does: a
nested dict (and, for ``long_doc``, a list) of float32 tensors. ``adam``
builds ``torch.optim.Adam`` over the tree's leaves in ``jax.tree.flatten``
order; ``optax.adam(lr)`` and ``torch.optim.Adam(lr)`` (betas (0.9, 0.999),
eps 1e-8) apply the same update.

``adam_state(params, opt)`` gives the optimizer's state in the layout of
``optax.adam``'s state, ``(ScaleByAdamState(count, mu, nu), EmptyState())``,
over the live tensors: ``count`` int32 (torch keeps a float ``step`` per
parameter; every one of them equals ``count``), ``mu`` / ``nu`` trees of
the parameters' ``exp_avg`` / ``exp_avg_sq``. With the parameters in front,
``(params, adam_state(params, opt))`` flattens to the leaves, in order and
in dtype, of the ``(params, opt_state)`` a JAX trainer checkpoints, so
either package restores the other's generation. ``load_adam_state`` copies
such a state back in place.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple

import numpy as np
import torch

from tpu_tfrecord_torch.checkpoint import tree_flatten, tree_unflatten


class ScaleByAdamState(NamedTuple):
    """optax's ``ScaleByAdamState``: the update count and the moments."""

    count: Any
    mu: Any
    nu: Any


class EmptyState(NamedTuple):
    """optax's ``EmptyState`` (the scale-by-learning-rate stage): no leaves."""


def init_adam_state(opt: torch.optim.Optimizer, p: torch.Tensor) -> Dict[str, torch.Tensor]:
    """``opt``'s state of ``p``, created as Adam creates it at its first
    step when it is empty (zero moments, a zero ``step``), so a tree taken
    before any step has the structure of one taken after: Adam's first
    step then finds the state and leaves it as it is."""
    group = next(g for g in opt.param_groups if any(q is p for q in g["params"]))
    state = opt.state[p]
    if not state:
        on_device = group.get("capturable") or group.get("fused")
        scalar = torch.float64 if torch.get_default_dtype() == torch.float64 and not \
            group.get("fused") else torch.float32
        state["step"] = torch.zeros((), dtype=scalar, device=p.device if on_device else "cpu")
        state["exp_avg"] = torch.zeros_like(p, memory_format=torch.preserve_format)
        state["exp_avg_sq"] = torch.zeros_like(p, memory_format=torch.preserve_format)
        if group.get("amsgrad"):
            state["max_exp_avg_sq"] = torch.zeros_like(p, memory_format=torch.preserve_format)
    return dict(state)


def param_leaves(params) -> list:
    """The tree's tensors in ``jax.tree.flatten`` order."""
    return tree_flatten(params)[0]


def adam(params, lr: float) -> torch.optim.Adam:
    """``torch.optim.Adam`` over the tree's leaves (``optax.adam(lr)``);
    the leaves are set to require grad."""
    leaves = param_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    return torch.optim.Adam(leaves, lr=lr, betas=(0.9, 0.999), eps=1e-8)


def _as_tensor(a) -> torch.Tensor:
    return a if isinstance(a, torch.Tensor) else torch.from_numpy(np.array(a))


def _count(opt: torch.optim.Adam, leaves) -> int:
    steps = {int(init_adam_state(opt, p)["step"]) for p in leaves}
    if len(steps) != 1:
        raise ValueError(f"the parameters were stepped unequally often: {sorted(steps)}")
    return steps.pop()


def adam_state(params, opt: torch.optim.Adam):
    """``(ScaleByAdamState(count, mu, nu), EmptyState())`` of ``opt`` over
    ``params``: ``mu`` / ``nu`` hold the live moment tensors, ``count`` is
    a new int32 tensor."""
    leaves, treedef = tree_flatten(params)
    states = [init_adam_state(opt, p) for p in leaves]
    count = torch.tensor(_count(opt, leaves), dtype=torch.int32)
    mu = tree_unflatten(treedef, [s["exp_avg"] for s in states])
    nu = tree_unflatten(treedef, [s["exp_avg_sq"] for s in states])
    return ScaleByAdamState(count, mu, nu), EmptyState()


@torch.no_grad()
def load_adam_state(params, opt: torch.optim.Adam, state) -> None:
    """Copy an optax-layout Adam state (numpy arrays or tensors, the
    ``(ScaleByAdamState, EmptyState)`` pair or the ``ScaleByAdamState``
    alone) into ``opt``'s state of ``params``, in place. Every moment must
    have its parameter's shape and dtype: nothing is cast."""
    if "count" not in getattr(state, "_fields", ()):
        state = state[0]
    count, mu, nu = state[0], state[1], state[2]
    leaves, treedef = tree_flatten(params)
    mus, nus = tree_flatten(mu)[0], tree_flatten(nu)[0]
    if len(mus) != len(leaves) or len(nus) != len(leaves):
        raise ValueError(f"Adam state has {len(mus)} / {len(nus)} moments for "
                         f"{len(leaves)} parameters")
    n = int(_as_tensor(count))
    for p, m, v in zip(leaves, mus, nus):
        st = init_adam_state(opt, p)
        for name, src in (("exp_avg", m), ("exp_avg_sq", v)):
            src = _as_tensor(src)
            dst = st[name]
            if src.dtype != dst.dtype or tuple(src.shape) != tuple(dst.shape):
                raise ValueError(f"Adam {name}: {src.dtype} {tuple(src.shape)} cannot load "
                                 f"into {dst.dtype} {tuple(dst.shape)}")
            dst.copy_(src)
        st["step"].fill_(n)


@torch.no_grad()
def load_params(params, tree) -> None:
    """Copy a restored parameter tree (numpy arrays or tensors) into the
    live ``params`` in place, leaf by leaf; shapes and dtypes must match."""
    dst, _ = tree_flatten(params)
    src, _ = tree_flatten(tree)
    if len(src) != len(dst):
        raise ValueError(f"{len(src)} leaves for a parameter tree of {len(dst)}")
    for i, (d, s) in enumerate(zip(dst, src)):
        s = _as_tensor(s)
        if s.dtype != d.dtype or tuple(s.shape) != tuple(d.shape):
            raise ValueError(f"parameter leaf {i}: {s.dtype} {tuple(s.shape)} cannot load "
                             f"into {d.dtype} {tuple(d.shape)}")
        d.copy_(s)


def train_state(params, opt: torch.optim.Adam):
    """``(params, adam_state(params, opt))``: the tree of a JAX trainer's
    ``(params, opt_state)`` for ``optax.adam``, over the live tensors."""
    return params, adam_state(params, opt)


def load_train_state(params, opt: torch.optim.Adam, tree) -> None:
    """Copy a restored ``train_state`` tree back in place."""
    load_params(params, tree[0])
    load_adam_state(params, opt, tree[1])
