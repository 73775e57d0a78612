"""Causal language model: port of ``tpu_tfrecord/models/lm.py``'s dense loop
(dense FFN and MoE FFN) on one card or over a (data, seq, fsdp) mesh of
ranks, and its pipe mode on one card.

Packed token batches from ``device.ingest.TokenPacker`` -> next-token
cross-entropy. The parameters are the JAX pytree as float32 tensors, the
blocks stacked on a leading [n_layers, ...] dim as in JAX (one checkpoint
layout for every package)::

    {"embed": [V, D], "pos": [L, D], "head": {"w": [D, V], "b": [V]},
     "blocks": {"qkv" | "proj" | "mlp_in" | "mlp_out":
                {"w": [n_layers, in, out], "b": [n_layers, out]}}}

With ``moe_experts`` > 0 a ``moe`` subtree (``router`` [n_layers, D, E],
``w_in`` [n_layers, E, D, F], ``w_out`` [n_layers, E, F, D]) takes the
place of ``mlp_in`` / ``mlp_out``, and every block's FFN is the top-k MoE
of ``models.moe`` (``moe_top_k``, ``moe_capacity_factor``).

``forward`` follows the JAX dense-loop path: pre-norm decoder blocks
(``models.long_doc``'s ``_rms_norm``, ``_dense`` and GELU), dense causal
attention (``models.attention``), and with ``segments`` (the bin modes of
the packer) the block-diagonal mask and per-document positions. It
returns the MoE aux loss summed over the layers, and with ``diagnostics``
the MoE diagnostics: ``expert_tokens`` / ``expert_kept`` summed over the
layers, ``dropped_fraction`` / ``gate_entropy`` averaged (``{}`` for the
dense FFN). ``loss_fn`` scores every position, or with ``segments`` only
the pairs whose input and target share a nonzero segment, plus
``moe_aux_weight`` times the aux loss. ``train_step`` is one Adam step
(``models.optim.adam``, ``optax.adam(3e-3)``'s update).

``LMStream`` serves the model through ``models.pipeline.PipelineStream``
on one device: the trainer's [n_layers, ...] blocks are re-stacked once,
at start-up, into S x V round-robin chunks (``_stage_stack``), each chunk
runs ``n_layers / (S·V)`` decoder blocks (``_make_stage_fn``), and the
embedding and head run per microbatch around the stream. As in JAX it
refuses the MoE FFN.

The pipe mode trains through the same schedule on one card: with
``pipe_axis`` and a ``mesh`` that maps axis names to sizes (what
``train_lm.pick_mesh`` returns, e.g. ``{"pipe": 2, "data": 1}``), the
blocks are stacked into S stages (``_stage_stack``, ``cfg.n_virtual``
chunks each), the embedded batch is split into ``cfg.n_micro`` (default
2·S) microbatches and run through ``models.pipeline.pipeline_apply``,
where the pipe axis is a tensor dimension; autograd runs through the
schedule. ``diagnostics=True`` returns the schedule's measured bubble
(``bubble_fraction``, ``useful_ticks``, ``total_ticks`` and, with V > 1,
``virtual_stages``). The JAX refusals stand, with the JAX exception
types: pipe with seq, with the MoE FFN or with ``segments``, a batch
that ``n_micro`` does not divide, a layer count that S·V does not divide.

Over a torch ``DeviceMesh`` of ranks the dense loop shards the batch on
``data_axis`` and the sequence on ``seq_axis``, as JAX's dense loop does
under GSPMD with ``ring_attention``: each rank passes its rows on 'data'
with all L+1 columns of ``tokens`` (and ``segments``), so the per-document
positions come from the whole row; it embeds and runs only its chunk of
the L positions on 'seq', every block's attention the causal ring
(``models.attention.ring_attention``, ``cfg.zigzag`` picking the
schedule), and its logits are that chunk's [B/data, L/p, V]. ``loss_fn``
sums the numerator and the count over 'seq' and 'data' before the
division, so every rank returns the global batch's loss. The parameters
enter through ``models.sharded.copy_to`` (their gradients sum over
'seq'), and ``train_step`` sums the gradients over 'data'. Without a
mesh to shard over, ``data_axis``, ``seq_axis`` and ``fsdp_axis`` select
nothing, as in JAX.

``fsdp_axis`` (FSDP) shards the weights at rest, by the JAX spec table
(``SpecLayout``, ``param_specs``, ``param_shardings``): each rank holds
``shard_params``' slice of every 2D+ weight (embed, pos and head by their
rows, a block weight [n_layers, fan_in, fan_out] by fan_in) and the whole
of every bias, and ``models.optim.adam`` over those leaves keeps Adam's
state sliced the same way. The batch is sharded on 'data' only
(``batch_shardings``), so the ranks of an fsdp group hold the same rows.
The forward gathers on use (``models.sharded.gather_from``, the list
``all_gather``): embed, pos and head before the embedding, each block's
weights of layer i in the layer loop; the backward keeps each rank the
slice of the gradient, and the step updates the slices. Autograd keeps
the gathered weights for the backward, so between a forward and its
backward a rank holds every layer whole once; at rest, between steps, only
the slices. ``unshard_params`` gathers a tree of slices (the parameters,
or Adam's moments) back to the one-process tree on every rank.

Not ported: ``expert_axis`` (8g), the MoE FFN under a data, seq or fsdp
axis wider than 1 (JAX routes and caps over the global token set; 8g),
stages on several cards and fsdp with stages (8h), ``fsdp_axis``, and a
data or seq axis wider than 1, on a mapping mesh (one card). Each raises
``OptionNotPortedError``.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from tpu_tfrecord_torch.models import moe as _moe
from tpu_tfrecord_torch.models import pipeline as _pipeline
from tpu_tfrecord_torch.models import sharded
from tpu_tfrecord_torch.models.attention import attention_reference, ring_attention
from tpu_tfrecord_torch.models.long_doc import _dense, _gelu, _rms_norm
from tpu_tfrecord_torch.options import OptionNotPortedError

# a parameter's spec: a mesh-axis name, or None, for each tensor dim
Spec = Tuple[Optional[str], ...]


@dataclass(frozen=True)
class LMConfig:
    vocab_size: int = 256
    d_model: int = 32
    n_heads: int = 4
    n_layers: int = 2
    mlp_mult: int = 4
    max_len: int = 64        # L: the model reads L tokens, predicts L
    dtype: torch.dtype = torch.float32
    # the causal ring's schedule on a 'seq' axis: zigzag (balanced) or
    # contiguous
    zigzag: bool = True
    # > 0 swaps every block's dense FFN for the top-k MoE (models.moe)
    moe_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01
    # microbatches of the pipe mode (must divide the batch); None = 2 x the
    # pipe axis's size
    n_micro: Optional[int] = None
    # interleaved virtual stages of the pipeline schedule: stage s owns the
    # V round-robin layer chunks s, s+S, ...; n_layers must divide by S·V
    n_virtual: int = 1


def _on_ranks(mesh) -> bool:
    """Whether ``mesh`` is a torch ``DeviceMesh`` of ranks (the one-card
    pipe mode takes a mapping of axis sizes instead)."""
    return hasattr(mesh, "mesh_dim_names")


# what each refused argument waits for
_NOT_PORTED = {
    "expert_axis": "expert parallelism (ROADMAP.md, Queue A item 8g)",
    "moe_experts": "the MoE FFN under a data, seq or fsdp axis wider than 1 (item 8g)",
    "pipe_axis": "stages on several cards (item 8h)",
    "fsdp_axis": "FSDP on one card's mapping mesh (with stages: item 8h)",
    "data_axis": "a data axis wider than 1 on one card's mapping mesh",
    "seq_axis": "a seq axis wider than 1 on one card's mapping mesh",
    "mesh": "a mesh axis the mode does not place",
}


def _mode(cfg: LMConfig, mesh, data_axis, seq_axis, pipe_axis, expert_axis, fsdp_axis,
          segments) -> Tuple[str, Optional[int]]:
    """("pipe", S) for the one-card pipe mode, ("ranks", None) for the
    dense loop over a (data, seq, fsdp) ``DeviceMesh``, ("dense", None) for
    the dense loop on this device's whole batch. The JAX package's
    refusals first (its exception types), then every mesh mode the port
    lacks."""
    if pipe_axis is not None and seq_axis is not None:
        raise ValueError(
            "pipe_axis and seq_axis are mutually exclusive: inside a "
            "pipeline stage the sequence is not sharded"
        )
    if pipe_axis is not None and cfg.moe_experts > 0:
        raise ValueError("moe_experts > 0 is not supported in the pipeline mode")
    if pipe_axis is not None and segments is not None:
        raise ValueError(
            "segments are not supported in the pipeline mode: the stage "
            "stream carries activations only (pack with the default "
            "slice mode, or drop pipe_axis)"
        )
    given = {"expert_axis": expert_axis}
    # one card: the mesh is a mapping of axis sizes; a torch DeviceMesh
    # places ranks (the data, seq and fsdp axes), never stages
    sizes = dict(mesh) if isinstance(mesh, Mapping) else None
    mode = "dense"
    if pipe_axis is not None:
        if sizes is None or pipe_axis not in sizes:
            given["pipe_axis"] = pipe_axis
        else:
            mode = "pipe"
            given["fsdp_axis"] = fsdp_axis
            if data_axis is not None and sizes.get(data_axis, 1) != 1:
                given["data_axis"] = data_axis
            if any(n > 1 for a, n in sizes.items() if a not in (pipe_axis, data_axis)):
                given["mesh"] = mesh
    elif sizes is not None:
        given["fsdp_axis"] = fsdp_axis
        for name, axis in (("data_axis", data_axis), ("seq_axis", seq_axis)):
            if axis is not None and sizes.get(axis, 1) > 1:
                given[name] = axis
        if any(n > 1 for a, n in sizes.items() if a not in (data_axis, seq_axis)):
            given["mesh"] = mesh
    elif _on_ranks(mesh):
        mode = "ranks"
        if cfg.moe_experts > 0 and any(sharded.axis_size(mesh, a) > 1
                                       for a in (data_axis, seq_axis, fsdp_axis)):
            given["moe_experts"] = cfg.moe_experts
    elif mesh is not None and (seq_axis is not None or fsdp_axis is not None):
        given["mesh"] = mesh
    refused = sorted(k for k, v in given.items() if v is not None)
    if refused:
        raise OptionNotPortedError(
            "lm: " + "; ".join(f"{k} not ported: {_NOT_PORTED[k]}" for k in refused) + ". The "
            "port runs the pipe mode on one card (pipe_axis with mesh={pipe_axis: S}, a data "
            "axis of size 1) and the dense loop over the data, seq and fsdp axes of a torch "
            "DeviceMesh of ranks (ROADMAP.md, Queue A item 8)"
        )
    return mode, (sizes[pipe_axis] if mode == "pipe" else None)


def _block_dims(cfg: LMConfig) -> Dict[str, Tuple[int, int]]:
    """The dense layers of a block: the MoE FFN stands in for mlp_in /
    mlp_out."""
    d, f = cfg.d_model, cfg.mlp_mult * cfg.d_model
    dims = {"qkv": (d, 3 * d), "proj": (d, d)}
    if cfg.moe_experts == 0:
        dims.update(mlp_in=(d, f), mlp_out=(f, d))
    return dims


def _moe_cfg(cfg: LMConfig) -> _moe.MoEConfig:
    return _moe.MoEConfig(
        d_model=cfg.d_model,
        d_ff=cfg.mlp_mult * cfg.d_model,
        n_experts=cfg.moe_experts,
        capacity_factor=cfg.moe_capacity_factor,
        top_k=cfg.moe_top_k,
        dtype=cfg.dtype,
    )


def _layer(blocks, i: int):
    """Layer ``i`` of the stacked [n_layers, ...] blocks."""
    return {name: {k: a[i] for k, a in p.items()} for name, p in blocks.items()}


@torch.no_grad()
def init_params(cfg: LMConfig, generator: Optional[torch.Generator] = None,
                device="cuda") -> Dict[str, Any]:
    """Random parameters drawn from ``generator`` (which must live on
    ``device``; seed 0 when None) with the JAX init's distributions:
    ``embed`` and ``pos`` ~ N(0, 0.02²), each ``w`` ~ N(0, 1/fan_in),
    biases zero; the MoE weights as ``models.moe.init_params`` draws them,
    layer by layer. The draws differ from ``jax.random``'s; load JAX
    weights through ``interop``."""
    if cfg.d_model % cfg.n_heads:
        raise ValueError(f"n_heads ({cfg.n_heads}) must divide d_model ({cfg.d_model})")
    device = torch.device(device)
    gen = generator if generator is not None else torch.Generator(device=device).manual_seed(0)

    def normal(*shape):
        return torch.randn(*shape, generator=gen, device=device)

    n = cfg.n_layers
    params: Dict[str, Any] = {
        "embed": normal(cfg.vocab_size, cfg.d_model) * 0.02,
        "pos": normal(cfg.max_len, cfg.d_model) * 0.02,
        "head": {"w": normal(cfg.d_model, cfg.vocab_size) * float(np.sqrt(1.0 / cfg.d_model)),
                 "b": torch.zeros(cfg.vocab_size, device=device)},
    }
    params["blocks"] = {
        name: {"w": normal(n, fi, fo) * float(np.sqrt(1.0 / fi)),
               "b": torch.zeros(n, fo, device=device)}
        for name, (fi, fo) in _block_dims(cfg).items()
    }
    if cfg.moe_experts > 0:
        layers = [_moe.init_params(_moe_cfg(cfg), gen, device) for _ in range(n)]
        params["blocks"]["moe"] = {k: torch.stack([l[k] for l in layers]) for k in layers[0]}
    return params


def _block(layer, x: torch.Tensor, cfg: LMConfig, segments=None, diagnostics: bool = False,
           attend=attention_reference):
    """One pre-norm decoder block on x [B, L, D] (one layer's slice of the
    stacked blocks): causal attention (``attend``: the dense one, or the
    ring over a seq axis), masked across packed documents by ``segments``
    [B, L], then the dense or the MoE FFN. Returns (x, aux, diag): the MoE
    aux loss and, with ``diagnostics``, its diagnostics; both None on the
    dense FFN."""
    dt = cfg.dtype
    b, l, _ = x.shape
    h, dh = cfg.n_heads, cfg.d_model // cfg.n_heads
    qkv = _dense(layer["qkv"], _rms_norm(x), dt)
    q, k, v = (a.reshape(b, l, h, dh) for a in torch.split(qkv, cfg.d_model, dim=-1))
    att = attend(q, k, v, causal=True, segments=segments)
    x = x + _dense(layer["proj"], att.reshape(b, l, cfg.d_model), dt)
    if cfg.moe_experts > 0:
        out = _moe.moe_apply(layer["moe"], _rms_norm(x), _moe_cfg(cfg), diagnostics=diagnostics)
        return x + out[0], out[1], (out[2] if diagnostics else None)
    y = _dense(layer["mlp_in"], _rms_norm(x), dt)
    return x + _dense(layer["mlp_out"], _gelu(y), dt), None, None


def _embed_tokens(params, tokens: torch.Tensor, cfg: LMConfig, segments=None,
                  cols: Optional[slice] = None) -> torch.Tensor:
    """tokens [B, L+1] -> x [B, L, D] from tokens[:, :-1]. With
    ``segments`` [B, L+1] each document's positions restart at 0: a
    position's document start is the running maximum of the start indices
    before it. ``cols`` keeps only those of the L positions (a rank's chunk
    of the sequence), their positions taken from the whole row."""
    dt = cfg.dtype
    x_tok = tokens[:, :-1].long()
    l = x_tok.shape[1]
    if l != cfg.max_len:
        raise ValueError(
            f"packed batch carries {l} input tokens but cfg.max_len is "
            f"{cfg.max_len} (the packer's seq_len must match)"
        )
    cols = cols if cols is not None else slice(0, l)
    if segments is None:
        pos = params["pos"][cols].to(dt)[None]
    else:
        segs = segments[:, :-1]
        idx = torch.arange(l, device=tokens.device)
        boundary = torch.cat(
            [torch.ones(segs.shape[0], 1, dtype=torch.bool, device=segs.device),
             segs[:, 1:] != segs[:, :-1]],
            dim=1,
        )
        start = torch.cummax(torch.where(boundary, idx[None, :], 0), dim=1).values
        pos = params["pos"][(idx[None, :] - start)[:, cols]].to(dt)   # [B, L, D]
    # gather, then cast: the JAX model casts the table first, the same values
    return params["embed"][x_tok[:, cols]].to(dt) + pos


def _head_logits(params, x: torch.Tensor, cfg: LMConfig) -> torch.Tensor:
    """Final norm and LM head: [.., L, D] -> float32 logits [.., L, V]."""
    return _dense(params["head"], _rms_norm(x), cfg.dtype).float()


def _chunk(cfg: LMConfig, mesh, seq_axis) -> slice:
    """This rank's columns of the L positions on ``seq_axis``."""
    p = sharded.axis_size(mesh, seq_axis)
    if cfg.max_len % p:
        raise ValueError(
            f"sequence length {cfg.max_len} not divisible by mesh['{seq_axis}'] = {p}"
        )
    lc = cfg.max_len // p
    first = sharded.axis_index(mesh, seq_axis) * lc
    return slice(first, first + lc)


def _gather_on_use(params, mesh, fsdp_axis: str, seq_axis: Optional[str]):
    """FSDP's gather on use over a ``DeviceMesh``: ``params`` with embed,
    pos and head whole (gathered over ``fsdp_axis``), and a function of i
    that gives layer i of the blocks, each weight gathered from this
    rank's slice of that layer only. With ``seq_axis`` every whole tensor
    then enters the chunk's work through ``copy_to``."""
    dims = _fsdp_dims(params, fsdp_axis)

    def use(t, dim):
        if dim is not None:
            # the backward keeps this rank's slice of the gradient, unsummed:
            # every rank of an fsdp group holds the same rows, so each has
            # the whole gradient already, and a sum over fsdp would count it
            # twice. copy_to's sum over 'seq' comes first, on the whole one.
            t = sharded.gather_from(t, mesh, fsdp_axis, dim)
        return sharded.copy_to(t, mesh, seq_axis)

    def layer(i):
        # layer i's slice drops the stacked dim: its fsdp dim moves down one
        return {name: {k: use(a[i], None if dims["blocks"][name][k] is None
                              else dims["blocks"][name][k] - 1)
                       for k, a in p.items()}
                for name, p in params["blocks"].items()}

    whole = {k: _tree_map2(use, params[k], dims[k]) for k in ("embed", "pos", "head")}
    return dict(params, **whole), layer


def forward(params, tokens: torch.Tensor, cfg: LMConfig, mesh=None, data_axis=None,
            seq_axis=None, pipe_axis=None, expert_axis=None, fsdp_axis=None,
            segments: Optional[torch.Tensor] = None, diagnostics: bool = False):
    """tokens [B, L+1] int -> (logits [B, L, V] float32, aux), or with
    ``diagnostics`` (logits, aux, diag): the model reads tokens[:, :-1];
    ``aux`` is the MoE load-balance loss summed over the layers (0.0 on the
    dense FFN and in the pipe mode); ``diag`` the MoE counts summed over
    the layers and the fractions averaged, or the pipe mode's measured
    bubble (``{}`` on the dense FFN). ``segments`` [B, L+1] (the packer's
    bin modes) masks attention across documents and restarts positions
    per document. ``pipe_axis`` with ``mesh={pipe_axis: S}`` runs the
    blocks through the pipeline schedule; a ``DeviceMesh`` runs the dense
    loop over its data, seq and fsdp axes, ``tokens`` and ``segments`` being
    this rank's rows whole, the logits its chunk [B, L/p, V] and, on
    ``fsdp_axis``, ``params`` this rank's ``shard_params`` slices (module
    docstring). The other mesh modes raise."""
    mode, n_stages = _mode(cfg, mesh, data_axis, seq_axis, pipe_axis, expert_axis, fsdp_axis,
                           segments)
    attend, cols, segs_in, layer = attention_reference, None, None, None
    if segments is not None:
        segs_in = segments[:, :-1]
    if mode == "ranks":
        cols = _chunk(cfg, mesh, seq_axis)
        seq = seq_axis if sharded.axis_size(mesh, seq_axis) > 1 else None
        if seq is not None:
            attend = functools.partial(ring_attention, mesh=mesh, seq_axis=seq_axis,
                                       data_axis=data_axis, zigzag=cfg.zigzag)
        if sharded.axis_size(mesh, fsdp_axis) > 1:
            params, layer = _gather_on_use(params, mesh, fsdp_axis, seq)
        elif seq is not None:
            # every parameter sees one chunk of the sequence: gradients sum over 'seq'
            params = _pipeline._tree_map(lambda t: sharded.copy_to(t, mesh, seq), params)
        if segs_in is not None:
            segs_in = segs_in[:, cols]
    layer = layer or functools.partial(_layer, params["blocks"])
    x = _embed_tokens(params, tokens, cfg, segments=segments, cols=cols)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    out: Dict[str, Any] = {}
    if mode == "pipe":
        b = tokens.shape[0]
        stage_params = _stage_stack(params["blocks"], cfg, n_stages)
        m = cfg.n_micro or 2 * n_stages
        if b % m:
            raise ValueError(f"batch {b} not divisible by n_micro {m}")
        xs = x.reshape((m, b // m) + tuple(x.shape[1:]))         # [M, mb, L, D]
        res = _pipeline.pipeline_apply(_make_stage_fn(cfg), stage_params, xs,
                                       n_virtual=cfg.n_virtual, diagnostics=diagnostics)
        xs, out = res if diagnostics else (res, {})
        x = xs.reshape((b,) + tuple(xs.shape[2:]))
    else:
        diags = []
        for i in range(cfg.n_layers):
            x, aux, diag = _block(layer(i), x, cfg, segments=segs_in, diagnostics=diagnostics,
                                  attend=attend)
            if aux is not None:
                aux_total = aux_total + aux
            if diag is not None:
                diags.append(diag)
        if diags:
            # every layer routes the whole stream: counts sum, fractions average
            n = len(diags)
            out = {
                "expert_tokens": sum(d["expert_tokens"] for d in diags),
                "expert_kept": sum(d["expert_kept"] for d in diags),
                "dropped_fraction": sum(d["dropped_fraction"] for d in diags) / n,
                "gate_entropy": sum(d["gate_entropy"] for d in diags) / n,
            }
    logits = _head_logits(params, x, cfg)
    if not diagnostics:
        return logits, aux_total
    return logits, aux_total, out


def loss_fn(params, tokens, cfg: LMConfig, mesh=None, data_axis=None, seq_axis=None,
            pipe_axis=None, expert_axis=None, fsdp_axis=None, segments=None,
            diagnostics: bool = False):
    """Mean next-token cross-entropy plus ``moe_aux_weight`` times the MoE
    aux loss. Without ``segments`` every position scores; with them a
    position scores only when its input token and its target share a
    nonzero segment. With ``diagnostics`` returns (loss, diag). The mesh
    arguments are ``forward``'s; over a ``DeviceMesh`` the numerator and
    the count are summed over 'seq' and 'data' before the division, so
    every rank returns the global batch's loss, and its backward leaves
    each rank the gradient of its rows' share, which ``train_step`` sums
    over 'data'."""
    out = forward(params, tokens, cfg, mesh, data_axis, seq_axis, pipe_axis, expert_axis,
                  fsdp_axis, segments=segments, diagnostics=diagnostics)
    logits, aux = out[0], out[1]
    ranks = _on_ranks(mesh) and pipe_axis is None
    cols = _chunk(cfg, mesh, seq_axis) if ranks else slice(None)
    targets = tokens[:, 1:][:, cols].long()
    logp = F.log_softmax(logits, dim=-1)
    tok_ce = -torch.gather(logp, -1, targets[..., None])[..., 0]
    if segments is None:
        valid = None
    else:
        valid = ((segments[:, :-1] == segments[:, 1:]) & (segments[:, 1:] != 0))[:, cols]
    if not ranks:
        if valid is None:
            loss = torch.mean(tok_ce)
        else:
            loss = torch.sum(tok_ce * valid) / torch.clamp(valid.sum(), min=1)
    else:
        num = tok_ce.sum() if valid is None else torch.sum(tok_ce * valid)
        count = (valid.sum() if valid is not None
                 else torch.tensor(tok_ce.numel(), device=tok_ce.device)).float()
        for axis in (seq_axis, data_axis):
            count = sharded.all_reduce(count, mesh, axis)
        share = num / torch.clamp(count, min=1)
        loss = sharded.sum_over(sharded.sum_over(share, mesh, seq_axis), mesh, data_axis)
    if cfg.moe_experts > 0:  # the dense FFN's aux is 0
        loss = loss + cfg.moe_aux_weight * aux
    return (loss, out[2]) if diagnostics else loss


def train_step(params, opt: torch.optim.Optimizer, tokens, cfg: LMConfig, mesh=None,
               data_axis=None, seq_axis=None, pipe_axis=None, expert_axis=None,
               fsdp_axis=None, segments=None, diagnostics: bool = False):
    """One optimizer step over ``params`` in place (``opt`` from
    ``models.optim.adam(params, lr)``). Returns the loss (0-dim, on the
    parameters' device) before the update; with ``diagnostics``
    (loss, diag), the diag of ``forward``. Over a ``DeviceMesh`` the
    gradients are summed over 'data' before the step; on ``fsdp_axis`` they
    are the slices' and ``opt`` steps the slices."""
    opt.zero_grad(set_to_none=True)
    out = loss_fn(params, tokens, cfg, mesh, data_axis, seq_axis, pipe_axis, expert_axis,
                  fsdp_axis, segments=segments, diagnostics=diagnostics)
    loss = out[0] if diagnostics else out
    loss.backward()
    if _on_ranks(mesh):
        sharded.sum_grads([p for g in opt.param_groups for p in g["params"]], mesh, data_axis)
    opt.step()
    return (loss.detach(), out[1]) if diagnostics else loss.detach()


def pack_slots(windows, mb: int, max_len: int) -> np.ndarray:
    """Up to ``mb`` token windows ([L] int32 each) as one [mb, L+1]
    microbatch: row i is window i and a zero target slot, unused rows are
    zero."""
    if len(windows) > mb:
        raise ValueError(f"{len(windows)} windows > {mb} slots")
    out = np.zeros((mb, max_len + 1), np.int32)
    for i, w in enumerate(windows):
        w = np.asarray(w, dtype=np.int32)
        if w.shape != (max_len,):
            raise ValueError(f"window {i} shape {w.shape} != ({max_len},)")
        out[i, :max_len] = w
    return out


def make_synthetic_tokens(cfg: LMConfig, batch_size: int, seed: int = 0,
                          n_next: int = 4) -> np.ndarray:
    """[B, L+1] int32 batches from the sparse-bigram language: each token
    has ``n_next`` plausible successors, so the loss can fall from ~ln(V)
    toward ~ln(n_next). The JAX package's arrays for the same seed."""
    rng = np.random.default_rng(seed)
    table = bigram_table(cfg.vocab_size, n_next, seed=1234)
    out = np.empty((batch_size, cfg.max_len + 1), np.int32)
    for i in range(batch_size):
        t = int(rng.integers(cfg.vocab_size))
        for j in range(cfg.max_len + 1):
            out[i, j] = t
            t = int(table[t, rng.integers(n_next)])
    return out


def bigram_table(vocab: int, n_next: int, seed: int = 1234) -> np.ndarray:
    """[V, n_next] successor table of the synthetic language."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, vocab, size=(vocab, n_next)).astype(np.int32)


def _chunk_count(cfg: LMConfig, n_stages: int) -> int:
    chunks = n_stages * cfg.n_virtual
    if cfg.n_layers % chunks:
        raise ValueError(
            f"n_layers ({cfg.n_layers}) must divide into the pipe axis × "
            f"n_virtual ({n_stages} stages × {cfg.n_virtual} virtual = "
            f"{chunks} chunks)"
        )
    return chunks


def _stage_stack(blocks, cfg: LMConfig, n_stages: int):
    """The stacked [n_layers, ...] blocks in the pipeline's stage layout:
    [S, per_stage, ...], or [S, V, per_chunk, ...] interleaved, where
    virtual stage k = v·S + s (stage s's chunk v) holds layers
    [k·pc, (k+1)·pc): stage s owns the layer chunks s, s+S, s+2S, ..."""
    chunks = _chunk_count(cfg, n_stages)
    pc = cfg.n_layers // chunks
    if cfg.n_virtual == 1:
        return _pipeline._tree_map(lambda a: a.reshape((n_stages, pc) + a.shape[1:]), blocks)
    v = cfg.n_virtual
    return _pipeline._tree_map(
        lambda a: a.reshape((v, n_stages, pc) + a.shape[1:]).transpose(0, 1).contiguous(),
        blocks,
    )


def _make_stage_fn(cfg: LMConfig):
    """One pipeline chunk: its per-chunk decoder blocks in order, dense
    attention over the whole sequence."""
    def stage_fn(p_chunk, xs):
        pc = p_chunk["qkv"]["w"].shape[0]
        for j in range(pc):
            xs = _block(_layer(p_chunk, j), xs, cfg)[0]
        return xs

    return stage_fn


class LMStream:
    """Microbatch-streamed LM inference: ``models.pipeline.PipelineStream``
    around the decoder chunks of the trainer's checkpoint.

    ``params`` is the [n_layers, ...] tree ``init_params`` and the trainer
    keep (tensors or numpy arrays); it is copied to ``device`` and the
    blocks are re-stacked into the S x V chunk layout once, here. The
    embedding and the head run per microbatch around the stream.

    ``submit(tokens [mb, L+1])`` feeds one microbatch and returns the
    logits that completed, FIFO, as host numpy float32 [mb, L, V] (one copy
    to the host a popped microbatch); ``flush()`` drains the tail. The
    streamed logits equal ``batch_reference`` (the same embedding and head
    around ``pipeline_apply`` on the same slices) bitwise."""

    def __init__(self, params: Dict[str, Any], cfg: LMConfig, n_stages: int = 1,
                 device="cuda"):
        self.cfg = cfg
        _chunk_count(cfg, n_stages)
        if cfg.moe_experts > 0:
            raise ValueError("moe_experts > 0 is not supported in the pipeline mode")
        self.device = torch.device(device)

        def place(a):
            t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.array(a))
            return t.detach().to(self.device, torch.float32)

        self._stage_fn = _make_stage_fn(cfg)
        self._stage_params = _stage_stack(_pipeline._tree_map(place, params["blocks"]), cfg,
                                          n_stages)
        self._ep = {"embed": place(params["embed"]), "pos": place(params["pos"])}
        self._hp = {"head": _pipeline._tree_map(place, params["head"])}
        self.stream = _pipeline.PipelineStream(self._stage_fn, self._stage_params,
                                               n_virtual=cfg.n_virtual, device=self.device)

    def _embed(self, tokens) -> torch.Tensor:
        return _embed_tokens(self._ep, torch.as_tensor(np.asarray(tokens), device=self.device),
                             self.cfg)

    def _head(self, x: torch.Tensor) -> np.ndarray:
        return _head_logits(self._hp, x, self.cfg).cpu().numpy()

    def submit(self, tokens) -> list:
        """One request: tokens [mb, L+1] int32 in, zero or more finished
        [mb, L, V] float32 logits out (FIFO, S·V ticks behind)."""
        return [out for out, _ in self.submit_tagged(tokens)]

    @torch.no_grad()
    def submit_tagged(self, tokens, tag=None) -> list:
        """``submit`` with an opaque host-side tag on the microbatch;
        returns ``(logits, tag)`` pairs."""
        return [(self._head(o), t) for o, t in self.stream.push_tagged(self._embed(tokens), tag)]

    def flush(self) -> list:
        """Drain the in-flight tail; returns the remaining logits FIFO."""
        return [out for out, _ in self.flush_tagged()]

    @torch.no_grad()
    def flush_tagged(self) -> list:
        """``flush`` returning ``(logits, tag)`` pairs."""
        return [(self._head(o), t) for o, t in self.stream.flush_tagged()]

    def reset(self) -> None:
        self.stream.reset()

    @torch.no_grad()
    def batch_reference(self, batches) -> list:
        """The batch path on the same slices: the same embedding and head
        around ``pipeline_apply`` over the stacked [M, mb, ...] stream, which
        the streamed logits must equal bitwise."""
        xs = torch.stack([self._embed(t) for t in batches])
        out = _pipeline.pipeline_apply(self._stage_fn, self._stage_params, xs,
                                       n_virtual=self.cfg.n_virtual)
        return [self._head(out[i]) for i in range(len(batches))]


@dataclass(frozen=True)
class SpecLayout:
    """The LM's mesh-axis spec table: which axis each parameter dimension
    shards over, each spec a tuple of axis names or None (JAX's
    ``PartitionSpec`` as a tuple; trailing dims it leaves out replicate).
    The stacked block dim ([n_layers, ...]) belongs to ``pipe_axis``, the
    first weight dim after it (fan-in of a dense kernel, d_model of the
    router, the rows of embed / pos / head) to ``fsdp_axis``, the expert
    dim of the MoE kernels to ``expert_axis``; biases replicate over fsdp.
    An axis left None replicates its dims."""

    fsdp_axis: Optional[str] = None
    pipe_axis: Optional[str] = None
    expert_axis: Optional[str] = None

    def embed(self) -> Spec:                    # [vocab, d_model]
        return (self.fsdp_axis, None)

    def pos(self) -> Spec:                      # [max_len, d_model]
        return (self.fsdp_axis, None)

    def head(self) -> Dict[str, Spec]:          # w [d_model, vocab]
        return {"w": (self.fsdp_axis, None), "b": ()}

    def block_dense(self) -> Dict[str, Spec]:   # w [n_layers, fan_in, fan_out]
        return {"w": (self.pipe_axis, self.fsdp_axis, None), "b": (self.pipe_axis, None)}

    def moe(self) -> Dict[str, Spec]:           # w_in [n_layers, E, d_model, d_ff]
        return {
            "router": (self.pipe_axis, self.fsdp_axis, None),
            "w_in": (self.pipe_axis, self.expert_axis, self.fsdp_axis, None),
            "w_out": (self.pipe_axis, self.expert_axis, self.fsdp_axis, None),
        }


def param_specs(params, layout: SpecLayout) -> Dict[str, Any]:
    """The spec tree of ``params`` from the table, leaf for leaf."""
    blocks = {name: layout.moe() if name == "moe" else layout.block_dense()
              for name in params["blocks"]}
    return {"embed": layout.embed(), "pos": layout.pos(), "head": layout.head(),
            "blocks": blocks}


def _tree_map2(fn, tree, other):
    """``fn(leaf, other's leaf)`` over ``tree``'s dicts (``other`` has its
    structure at least)."""
    if isinstance(tree, dict):
        return {k: _tree_map2(fn, v, other[k]) for k, v in tree.items()}
    return fn(tree, other)


def _fsdp_dims(tree, fsdp_axis: str, size: int = 1):
    """The tree of each leaf's dim on ``fsdp_axis`` (None: replicated); a
    dim that ``size`` does not divide raises ``ValueError``, as JAX's
    placement does."""
    def dim(p, spec):
        d = spec.index(fsdp_axis) if fsdp_axis is not None and fsdp_axis in spec else None
        if d is not None and p.shape[d] % size:
            raise ValueError(
                f"a parameter sharded on '{fsdp_axis}' over {size} ranks implies that the "
                f"global size of its dimension {d} should be divisible by {size}, but it is "
                f"equal to {p.shape[d]} (full shape: {tuple(p.shape)})")
        return d

    return _tree_map2(dim, tree, param_specs(tree, SpecLayout(fsdp_axis=fsdp_axis)))


def param_shardings(mesh, params, pipe_axis: Optional[str] = None,
                    expert_axis: Optional[str] = None, fsdp_axis: Optional[str] = None):
    """The DTensor placements of each parameter on ``mesh`` (a
    ``DeviceMesh`` or a mapping of axis sizes), one per mesh dim, from the
    table: ``Shard(d)`` on ``fsdp_axis`` for a 2D+ weight's first weight
    dim d, ``Replicate()`` elsewhere. A dim that the fsdp axis's size does
    not divide raises ``ValueError``, as JAX's placement does. Stage
    slicing (``pipe_axis``, 8h) and expert sharding (``expert_axis``, 8g)
    raise ``OptionNotPortedError``."""
    from torch.distributed.tensor import Replicate, Shard

    refused = [f"{k} not ported yet (ROADMAP.md, Queue A item {item})"
               for k, v, item in (("pipe_axis", pipe_axis, "8h"), ("expert_axis", expert_axis, "8g"))
               if v is not None]
    if refused:
        raise OptionNotPortedError("lm.param_shardings: " + ", ".join(refused))
    sizes = sharded.mesh_shape(mesh)
    return _tree_map2(
        lambda _, dim: tuple(Shard(dim) if name == fsdp_axis and dim is not None
                             else Replicate() for name in sizes),
        params, _fsdp_dims(params, fsdp_axis, sizes.get(fsdp_axis, 1)))


def batch_shardings(mesh, data_axis: str = "data"):
    """The placements of the packed token batch on ``mesh``: its rows
    ``Shard(0)`` on ``data_axis``, replicated on every other axis (an fsdp
    group's ranks hold the same rows)."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(sharded.mesh_shape(mesh))
    if data_axis not in names:
        raise ValueError(f"Resource axis: {data_axis} of the token batch's spec is not found "
                         f"in mesh: {names}.")
    return {"tokens": tuple(Shard(0) if name == data_axis else Replicate() for name in names)}


@torch.no_grad()
def shard_params(tree, mesh, fsdp_axis: str = "fsdp"):
    """This rank's slices of a one-process tree of ``params``' structure
    (the parameters, or Adam's ``exp_avg`` / ``exp_avg_sq`` trees; tensors
    or numpy arrays, the same on every rank), as new contiguous leaf
    tensors: each 2D+ weight cut on ``fsdp_axis`` by ``param_shardings``,
    the rest copied whole."""
    n, k = sharded.axis_size(mesh, fsdp_axis), sharded.axis_index(mesh, fsdp_axis)

    def piece(t, dim):
        t = torch.as_tensor(t).detach()
        if dim is not None:
            t = t.narrow(dim, k * (t.shape[dim] // n), t.shape[dim] // n)
        return t.clone().contiguous()

    return _tree_map2(piece, tree, _fsdp_dims(tree, fsdp_axis, n))


@torch.no_grad()
def unshard_params(tree, mesh, fsdp_axis: str = "fsdp"):
    """The one-process tree of a tree of ``shard_params``' slices, on every
    rank: each sharded leaf gathered over ``fsdp_axis`` (a collective:
    every rank of the mesh calls it, in the same order)."""
    return _tree_map2(
        lambda t, dim: t.detach().clone() if dim is None
        else sharded.all_gather(t.detach(), mesh, fsdp_axis, dim).clone(),
        tree, _fsdp_dims(tree, fsdp_axis))
