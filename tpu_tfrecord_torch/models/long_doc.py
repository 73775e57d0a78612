"""Long-document classifier: port of ``tpu_tfrecord/models/long_doc.py``,
the second model family next to the DLRM, on one card or over a (data,
seq) mesh of ranks.

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

With ``mesh`` (a torch ``DeviceMesh`` of ranks) the sequence runs sharded
over ``seq_axis``, the batch over ``data_axis``: each rank passes its part
of the global batch (``batch_shardings``: ``frames`` [B/data, L/seq, D_in],
``frames_len`` and ``label`` [B/data]) and gets the logits of its rows,
the same on every rank of the 'seq' axis. Attention is
``models.attention``'s ``ring_attention`` or ``ulysses_attention``, as
``cfg.sp_attention`` picks; the position embeddings and the valid mask use
the rank's global positions; the masked mean pool sums over 'seq' before
dividing by the global count. The parameters are replicated
(``param_shardings``): those that see one chunk of the sequence enter
through ``models.sharded.copy_to`` (their gradients sum over 'seq'), and
``train_step`` sums the gradients over 'data' in one float32 collective,
each rank having differentiated its rows' share of the global mean loss.
The MoE FFN over such a mesh takes ``models.moe``'s global route, JAX's
``moe_apply`` under GSPMD: the routing and the capacity over the whole
flattened [B, L] token set (each token's flat index from its row on
'data' and its position on 'seq'), padding taking no slot, each rank
running the experts on its own tokens. The expert weights may be placed
on an expert axis of the mesh (``moe.param_shardings``,
``moe.shard_experts``): with ``expert_axis`` naming it, a layer whose
``w_in`` / ``w_out`` hold fewer than ``moe_experts`` experts is gathered
on use over that axis (its gradient stays the rank's slice), the
semantics of JAX's forward on placed weights.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from tpu_tfrecord_torch.models import dlrm as _dlrm
from tpu_tfrecord_torch.models import moe as _moe
from tpu_tfrecord_torch.models import pipeline as _pipeline
from tpu_tfrecord_torch.models import sharded
from tpu_tfrecord_torch.models.attention import (
    attention_reference,
    ring_attention,
    ulysses_attention,
)
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
    # the sequence-parallel attention a mesh selects: 'ring' (K/V blocks
    # rotate, any head count) or 'ulysses' (two all-to-alls, n_heads and
    # n_kv_heads divisible by the seq axis' size)
    sp_attention: str = "ring"
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
    if cfg.sp_attention not in ("ring", "ulysses"):
        raise ValueError(
            f"sp_attention must be 'ring' or 'ulysses', got {cfg.sp_attention!r}"
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
           cfg: LongDocConfig, attend=attention_reference, moe=None):
    """One pre-norm encoder block on x [B, L, D]; ``valid`` [B, L] is the
    prefix mask of ``lengths``; ``attend(q, k, v, lengths=)`` is the
    attention; ``moe(params, x, valid)`` the MoE FFN (``moe_apply`` when
    None). Returns (x, the MoE aux loss or None)."""
    dt = cfg.dtype
    b, l, _ = x.shape
    h = cfg.n_heads
    hkv = cfg.n_kv_heads or h
    dh = cfg.d_model // h
    qkv = _dense(layer["qkv"], _rms_norm(x), dt)             # [B, L, (H+2*Hkv)*dh]
    q, k, v = torch.split(qkv, [h * dh, hkv * dh, hkv * dh], dim=-1)
    att = attend(
        q.reshape(b, l, h, dh), k.reshape(b, l, hkv, dh), v.reshape(b, l, hkv, dh),
        lengths=lengths,
    )
    x = x + _dense(layer["proj"], att.reshape(b, l, cfg.d_model), dt)
    if cfg.moe_experts > 0:
        # padding is masked out of the routing, the capacity and the aux
        # loss; a dropped token rides the residual
        if moe is None:
            y, aux = _moe.moe_apply(layer["moe"], _rms_norm(x), _moe_cfg(cfg), valid=valid)
        else:
            y, aux = moe(layer["moe"], _rms_norm(x), valid)
        return x + y, aux
    y = _dense(layer["mlp_in"], _rms_norm(x), dt)
    return x + _dense(layer["mlp_out"], _gelu(y), dt), None


def _sharded_axes(cfg: LongDocConfig, mesh, seq_axis, data_axis):
    """The attention of ``mesh``'s 'seq' axis and whether the mesh shards
    anything; the JAX refusal of an unknown flavour, the port's of what it
    lacks."""
    if mesh is None:
        return attention_reference, False
    if not hasattr(mesh, "mesh_dim_names"):
        raise OptionNotPortedError(
            f"long_doc forward(mesh={type(mesh).__name__}): the port shards the sequence "
            "over the ranks of a torch DeviceMesh only"
        )
    if cfg.sp_attention == "ulysses":
        sp = ulysses_attention
    elif cfg.sp_attention == "ring":
        sp = ring_attention
    else:  # a config changed after init_params must not run another exchange
        raise ValueError(
            f"sp_attention must be 'ring' or 'ulysses', got {cfg.sp_attention!r}"
        )
    split = sharded.axis_size(mesh, seq_axis) > 1 or sharded.axis_size(mesh, data_axis) > 1

    def attend(q, k, v, lengths):
        return sp(q, k, v, mesh, seq_axis=seq_axis, data_axis=data_axis, lengths=lengths)

    return attend, split


def _experts_whole(layers, cfg: LongDocConfig, mesh, expert_axis):
    """The layers with each MoE's ``w_in`` / ``w_out`` gathered over
    ``expert_axis`` where they hold this rank's experts only."""
    if cfg.moe_experts == 0 or expert_axis is None:
        return layers

    def whole(layer):
        moe = layer["moe"]
        if moe["w_in"].shape[0] == cfg.moe_experts:
            return layer
        return dict(layer, moe=dict(moe, **{k: sharded.gather_from(moe[k], mesh, expert_axis, 0)
                                           for k in ("w_in", "w_out")}))

    return [whole(layer) for layer in layers]


def forward(params: Dict[str, Any], batch: Dict[str, torch.Tensor], cfg: LongDocConfig,
            mesh=None, seq_axis: str = "seq", data_axis: Optional[str] = None,
            with_aux: bool = False, *, expert_axis: Optional[str] = None):
    """Logits [B, n_classes] float32 of ``batch`` (``frames``,
    ``frames_len``); with ``with_aux`` (logits, aux), aux the MoE
    load-balance loss summed over the layers (0.0 on the dense FFN).
    With ``mesh`` (a ``DeviceMesh``) the batch is this rank's part and the
    logits are its rows'; ``expert_axis`` names the mesh axis that MoE
    weights placed by ``moe.shard_experts`` are sharded on (module
    docstring)."""
    attend, split = _sharded_axes(cfg, mesh, seq_axis, data_axis)
    dt = cfg.dtype
    frames = batch["frames"].to(dt)                          # [B, L, Din]
    lengths = batch["frames_len"]
    l = frames.shape[1]
    first = sharded.axis_index(mesh, seq_axis) * l           # this rank's first position
    if split:
        # parameters that see one chunk of the sequence: gradients sum over 'seq'
        tied = lambda t: sharded.copy_to(t, mesh, seq_axis)  # noqa: E731
        params = dict(params, embed=_pipeline._tree_map(tied, params["embed"]),
                      pos=tied(params["pos"]), layers=_pipeline._tree_map(tied, params["layers"]))
    layers = _experts_whole(params["layers"], cfg, mesh, expert_axis)
    x = _dense(params["embed"], frames, dt) + params["pos"][first:first + l].to(dt)[None]
    # one mask for the experts' routing and the pooling
    steps = torch.arange(first, first + l, device=x.device)
    valid = steps[None, :] < lengths[:, None]                # [B, L]
    moe = None
    if split and cfg.moe_experts > 0:
        # the global route: each token's flat index in the [B, L] batch
        rows, seq_len = frames.shape[0], l * sharded.axis_size(mesh, seq_axis)
        row0 = sharded.axis_index(mesh, data_axis) * rows
        flat = (torch.arange(row0, row0 + rows, device=x.device)[:, None] * seq_len
                + steps[None, :])
        total = rows * sharded.axis_size(mesh, data_axis) * seq_len
        mcfg = _moe_cfg(cfg)

        def moe(p, xn, v):
            return _moe._moe_apply_tokens(p, xn, mcfg, mesh, (data_axis, seq_axis), flat, total,
                                          valid=v)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device) if with_aux else None
    for layer in layers:
        if cfg.remat and torch.is_grad_enabled():
            x, aux = checkpoint(_block, layer, x, lengths, valid, cfg, attend, moe,
                                use_reentrant=False)
        else:
            x, aux = _block(layer, x, lengths, valid, cfg, attend, moe)
        if with_aux and aux is not None:
            aux_total = aux_total + aux
    # masked mean pool over the valid prefix, summed over the sequence's ranks
    mask = valid.float()
    total = sharded.sum_over((x.float() * mask[:, :, None]).sum(dim=1), mesh, seq_axis)
    count = sharded.sum_over(mask.sum(dim=1, keepdim=True), mesh, seq_axis)
    pooled = total / torch.clamp(count, min=1.0)
    logits = _dense(params["head"], pooled.to(dt), dt).float()
    return (logits, aux_total) if with_aux else logits


def loss_fn(params, batch, cfg: LongDocConfig, mesh=None, seq_axis: str = "seq",
            data_axis: Optional[str] = None, *, expert_axis: Optional[str] = None
            ) -> torch.Tensor:
    """Mean cross-entropy of the logits against ``batch["label"]``, plus
    ``moe_aux_weight`` times the MoE aux loss. With ``mesh``, the mean over
    the global batch on every rank; its backward leaves each rank the
    gradient of its rows' share, which ``train_step`` sums over 'data'."""
    logits, aux = forward(params, batch, cfg, mesh, seq_axis, data_axis, with_aux=True,
                          expert_axis=expert_axis)
    logp = F.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, 1, batch["label"].long()[:, None])
    rows = nll.shape[0] * sharded.axis_size(mesh, data_axis)
    ce = sharded.sum_over(nll.sum() / rows, mesh, data_axis)
    return ce + cfg.moe_aux_weight * aux if cfg.moe_experts > 0 else ce


def train_step(params, opt: torch.optim.Optimizer, batch, cfg: LongDocConfig, mesh=None,
               seq_axis: str = "seq", data_axis: Optional[str] = None, *,
               expert_axis: Optional[str] = None) -> torch.Tensor:
    """One optimizer step over ``params`` in place (``opt`` from
    ``models.optim.adam(params, lr)``). Returns the loss (0-dim, on the
    parameters' device) before the update; with ``mesh``, the global
    batch's, the gradients summed over 'data' before the step (expert
    weights placed on ``expert_axis`` keep and step their slices)."""
    opt.zero_grad(set_to_none=True)
    loss = loss_fn(params, batch, cfg, mesh, seq_axis, data_axis, expert_axis=expert_axis)
    loss.backward()
    sharded.sum_grads([p for g in opt.param_groups for p in g["params"]], mesh, data_axis)
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


def batch_shardings(mesh, batch, data_axis: str = "data", seq_axis: Optional[str] = "seq"):
    """The placements of each array of a host batch on ``mesh`` (a
    ``DeviceMesh``; one per mesh dim, by key): ``frames`` on (data, seq),
    every other array's batch dim on ``data_axis``; the policy of the JAX
    function (``dlrm.batch_shardings``' with the seq axis on)."""
    return _dlrm.batch_shardings(mesh, batch, data_axis=data_axis, seq_axis=seq_axis)


def param_shardings(mesh, params):
    """Every parameter replicated on ``mesh``: the tree of ``params`` with
    each tensor's placements (``Replicate()`` on every mesh dim); the
    sequence axis shards activations only."""
    from torch.distributed.tensor import Replicate

    names = tuple(mesh.mesh_dim_names or ())
    return _pipeline._tree_map(lambda _: tuple(Replicate() for _ in names), params)
