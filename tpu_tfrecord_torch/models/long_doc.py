"""Long-document classifier: port of ``tpu_tfrecord/models/long_doc.py``,
the second model family next to the DLRM, on one card.

A pre-norm transformer encoder over the padded SequenceExample frames
(``frames`` [B, L, D_in] and ``frames_len`` [B], as
``device.ingest.host_batch_from_columnar`` pads them), with dense attention
masked by the lengths (``models.attention``), a masked mean-pool over the
valid prefix, and class logits.

The parameters are the JAX pytree as tensors: a dict with ``embed`` and
``head`` ({"w": [in, out], "b": [out]}), ``pos`` [max_len, d_model] and
``layers``, a list of {"qkv", "proj", "mlp_in", "mlp_out"} dicts, all
float32; with ``moe_experts`` > 0 a ``moe`` dict (``router`` [D, E],
``w_in`` [E, D, F], ``w_out`` [E, F, D]) takes the place of ``mlp_in`` /
``mlp_out`` and every block's FFN is the Switch MoE of ``models.moe``
(top 1, computed in ``cfg.dtype``, the router in float32), routed over
the valid prefix only: the pooling's mask ``arange(L) < frames_len``
keeps padding out of the routing, the capacity and the aux loss.
``forward`` follows the JAX function step by step: activations in
``cfg.dtype`` (bf16 by default), ``x @ w.to(dt) + b.to(dt)`` (the product
rounded to ``dt`` before the bias add), RMS norm in float32 without a
weight, GELU in its tanh form (``jax.nn.gelu``'s default), the q/k/v split
at [h·dh, (h+hkv)·dh], and float32 logits; ``forward(with_aux=True)``
also returns the MoE aux loss summed over the layers, which ``loss_fn``
adds times ``moe_aux_weight``. ``cfg.remat`` recomputes each block in the
backward (``torch.utils.checkpoint``). ``train_step`` is one Adam step
(``models.optim.adam``, ``optax.adam(1e-3)``'s update).

Not ported: a mesh (sequence-parallel ring or Ulysses attention); it
raises ``OptionNotPortedError``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from tpu_tfrecord_torch.models import moe as _moe
from tpu_tfrecord_torch.models.attention import attention_reference
from tpu_tfrecord_torch.options import OptionNotPortedError


@dataclass(frozen=True)
class LongDocConfig:
    seq_dim: int = 16        # input frame feature dim
    d_model: int = 32
    n_heads: int = 4
    n_kv_heads: int = 0      # 0 = MHA; fewer for GQA/MQA
    n_layers: int = 2
    mlp_mult: int = 4
    n_classes: int = 2
    max_len: int = 128       # padded sequence length
    dtype: torch.dtype = torch.bfloat16
    remat: bool = False      # recompute each block in the backward
    # > 0 swaps every block's dense FFN for the Switch MoE (models.moe,
    # top 1, d_ff = mlp_mult * d_model per expert); the aux losses join
    # the objective times moe_aux_weight
    moe_experts: int = 0
    moe_capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01


def _moe_cfg(cfg: LongDocConfig) -> _moe.MoEConfig:
    return _moe.MoEConfig(
        d_model=cfg.d_model,
        d_ff=cfg.mlp_mult * cfg.d_model,
        n_experts=cfg.moe_experts,
        capacity_factor=cfg.moe_capacity_factor,
        dtype=cfg.dtype,
    )


def _dense_init(gen: torch.Generator, fan_in: int, fan_out: int, device) -> Dict[str, torch.Tensor]:
    # gain 1: pre-norm residual blocks want unit-variance projections
    w = torch.randn(fan_in, fan_out, generator=gen, device=device) * float(np.sqrt(1.0 / fan_in))
    return {"w": w, "b": torch.zeros(fan_out, device=device)}


@torch.no_grad()
def init_params(cfg: LongDocConfig, generator: Optional[torch.Generator] = None,
                device="cuda") -> Dict[str, Any]:
    """Random parameters drawn from ``generator`` (which must live on
    ``device``; seed 0 when None) with the JAX init's distributions: each
    ``w`` ~ N(0, 1/fan_in), biases zero, ``pos`` ~ N(0, 0.02²), the MoE
    weights as ``models.moe.init_params`` draws them. The draws differ from
    ``jax.random``'s; load JAX weights through ``interop``."""
    if cfg.d_model % cfg.n_heads:
        raise ValueError(
            f"n_heads ({cfg.n_heads}) must divide d_model ({cfg.d_model}) evenly"
        )
    hkv = cfg.n_kv_heads or cfg.n_heads
    if hkv <= 0 or cfg.n_heads % hkv:
        raise ValueError(
            f"n_kv_heads must be a positive divisor of n_heads "
            f"({cfg.n_heads}); got {cfg.n_kv_heads}"
        )
    device = torch.device(device)
    gen = generator if generator is not None else torch.Generator(device=device).manual_seed(0)
    dh = cfg.d_model // cfg.n_heads
    params: Dict[str, Any] = {
        "embed": _dense_init(gen, cfg.seq_dim, cfg.d_model, device),
        "pos": torch.randn(cfg.max_len, cfg.d_model, generator=gen, device=device) * 0.02,
        "head": _dense_init(gen, cfg.d_model, cfg.n_classes, device),
    }
    params["layers"] = []
    for _ in range(cfg.n_layers):
        layer = {
            "qkv": _dense_init(gen, cfg.d_model, (cfg.n_heads + 2 * hkv) * dh, device),
            "proj": _dense_init(gen, cfg.d_model, cfg.d_model, device),
        }
        if cfg.moe_experts > 0:
            layer["moe"] = _moe.init_params(_moe_cfg(cfg), gen, device)
        else:
            layer["mlp_in"] = _dense_init(gen, cfg.d_model, cfg.mlp_mult * cfg.d_model, device)
            layer["mlp_out"] = _dense_init(gen, cfg.mlp_mult * cfg.d_model, cfg.d_model, device)
        params["layers"].append(layer)
    return params


def _dense(layer: Dict[str, torch.Tensor], x: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    # the product rounded to dt before the bias add, as XLA computes it
    return x @ layer["w"].to(dt) + layer["b"].to(dt)


def _rms_norm(x: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    scale = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + 1e-6)
    return (xf * scale).to(x.dtype)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")  # jax.nn.gelu's default form


def _block(layer, x: torch.Tensor, lengths: torch.Tensor, valid: torch.Tensor,
           cfg: LongDocConfig):
    """One pre-norm encoder block on x [B, L, D]; ``valid`` [B, L] is the
    prefix mask of ``lengths``. Returns (x, the MoE aux loss or None)."""
    dt = cfg.dtype
    b, l, _ = x.shape
    h = cfg.n_heads
    hkv = cfg.n_kv_heads or h
    dh = cfg.d_model // h
    qkv = _dense(layer["qkv"], _rms_norm(x), dt)             # [B, L, (H+2*Hkv)*dh]
    q, k, v = torch.split(qkv, [h * dh, hkv * dh, hkv * dh], dim=-1)
    att = attention_reference(
        q.reshape(b, l, h, dh), k.reshape(b, l, hkv, dh), v.reshape(b, l, hkv, dh),
        lengths=lengths,
    )
    x = x + _dense(layer["proj"], att.reshape(b, l, cfg.d_model), dt)
    if cfg.moe_experts > 0:
        # padding is masked out of the routing, the capacity and the aux
        # loss; a dropped token rides the residual
        y, aux = _moe.moe_apply(layer["moe"], _rms_norm(x), _moe_cfg(cfg), valid=valid)
        return x + y, aux
    y = _dense(layer["mlp_in"], _rms_norm(x), dt)
    return x + _dense(layer["mlp_out"], _gelu(y), dt), None


def forward(params: Dict[str, Any], batch: Dict[str, torch.Tensor], cfg: LongDocConfig,
            mesh=None, with_aux: bool = False):
    """Logits [B, n_classes] float32 of ``batch`` (``frames``,
    ``frames_len``); with ``with_aux`` (logits, aux), aux the MoE
    load-balance loss summed over the layers (0.0 on the dense FFN).
    ``mesh`` is the JAX signature's sequence-parallel mesh: not ported, it
    raises."""
    if mesh is not None:
        raise OptionNotPortedError(
            "long_doc forward(mesh=...): sequence-parallel attention needs "
            "torch.distributed across cards, which the port does not have yet"
        )
    dt = cfg.dtype
    frames = batch["frames"].to(dt)                          # [B, L, Din]
    lengths = batch["frames_len"]
    l = frames.shape[1]
    x = _dense(params["embed"], frames, dt) + params["pos"][:l].to(dt)[None]
    # one mask for the experts' routing and the pooling
    valid = torch.arange(l, device=x.device)[None, :] < lengths[:, None]     # [B, L]
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device) if with_aux else None
    for layer in params["layers"]:
        if cfg.remat and torch.is_grad_enabled():
            x, aux = checkpoint(_block, layer, x, lengths, valid, cfg, use_reentrant=False)
        else:
            x, aux = _block(layer, x, lengths, valid, cfg)
        if with_aux and aux is not None:
            aux_total = aux_total + aux
    # masked mean pool over the valid prefix
    mask = valid.float()
    pooled = (x.float() * mask[:, :, None]).sum(dim=1) / torch.clamp(
        mask.sum(dim=1, keepdim=True), min=1.0
    )
    logits = _dense(params["head"], pooled.to(dt), dt).float()
    return (logits, aux_total) if with_aux else logits


def loss_fn(params, batch, cfg: LongDocConfig, mesh=None) -> torch.Tensor:
    """Mean cross-entropy of the logits against ``batch["label"]``, plus
    ``moe_aux_weight`` times the MoE aux loss."""
    logits, aux = forward(params, batch, cfg, mesh, with_aux=True)
    logp = F.log_softmax(logits, dim=-1)
    ce = -torch.mean(torch.gather(logp, 1, batch["label"].long()[:, None]))
    return ce + cfg.moe_aux_weight * aux if cfg.moe_experts > 0 else ce


def train_step(params, opt: torch.optim.Optimizer, batch, cfg: LongDocConfig,
               mesh=None) -> torch.Tensor:
    """One optimizer step over ``params`` in place (``opt`` from
    ``models.optim.adam(params, lr)``). Returns the loss (0-dim, on the
    parameters' device) before the update."""
    opt.zero_grad(set_to_none=True)
    loss = loss_fn(params, batch, cfg, mesh)
    loss.backward()
    opt.step()
    return loss.detach()


def make_synthetic_batch(cfg: LongDocConfig, batch_size: int, seed: int = 0):
    """Host batch in the ingest layout (frames/frames_len/label), the JAX
    package's arrays for the same seed. Labels follow the frames."""
    rng = np.random.default_rng(seed)
    frames = rng.normal(size=(batch_size, cfg.max_len, cfg.seq_dim)).astype(np.float32)
    lengths = rng.integers(1, cfg.max_len + 1, size=(batch_size,)).astype(np.int32)
    mask = np.arange(cfg.max_len)[None, :] < lengths[:, None]
    mean0 = (frames[:, :, 0] * mask).sum(axis=1) / np.maximum(mask.sum(axis=1), 1)
    label = (mean0 > 0).astype(np.int32) % cfg.n_classes
    return {"frames": frames, "frames_len": lengths, "label": label}
