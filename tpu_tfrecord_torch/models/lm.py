"""Causal language model: port of ``tpu_tfrecord/models/lm.py``'s one-device
paths (dense FFN and MoE FFN), on one card.

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

Not ported: every mesh axis of ``forward`` (``mesh``, ``data_axis``,
``seq_axis``, ``pipe_axis``, ``fsdp_axis``, ``expert_axis``: ring
attention, pipelined training, FSDP, expert parallelism) and
``SpecLayout`` / ``param_shardings``. Each raises ``OptionNotPortedError``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from tpu_tfrecord_torch.models import moe as _moe
from tpu_tfrecord_torch.models import pipeline as _pipeline
from tpu_tfrecord_torch.models.attention import attention_reference
from tpu_tfrecord_torch.models.long_doc import _dense, _gelu, _rms_norm
from tpu_tfrecord_torch.options import OptionNotPortedError


@dataclass(frozen=True)
class LMConfig:
    vocab_size: int = 256
    d_model: int = 32
    n_heads: int = 4
    n_layers: int = 2
    mlp_mult: int = 4
    max_len: int = 64        # L: the model reads L tokens, predicts L
    dtype: torch.dtype = torch.float32
    # > 0 swaps every block's dense FFN for the top-k MoE (models.moe)
    moe_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01
    # interleaved virtual stages of the pipeline schedule: stage s owns the
    # V round-robin layer chunks s, s+S, ...; n_layers must divide by S·V
    n_virtual: int = 1


def _refuse(cfg: LMConfig, **axes) -> None:
    given = sorted(k for k, v in axes.items() if v is not None)
    if given:
        raise OptionNotPortedError(
            f"lm: {', '.join(given)} not ported: the mesh modes (ring attention, "
            "the pipeline, FSDP, expert parallelism) need torch.distributed across "
            "cards, which the port does not have yet"
        )


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


def _block(layer, x: torch.Tensor, cfg: LMConfig, segments=None, diagnostics: bool = False):
    """One pre-norm decoder block on x [B, L, D] (one layer's slice of the
    stacked blocks): dense causal attention, masked across packed
    documents by ``segments`` [B, L], then the dense or the MoE FFN.
    Returns (x, aux, diag): the MoE aux loss and, with ``diagnostics``,
    its diagnostics; both None on the dense FFN."""
    dt = cfg.dtype
    b, l, _ = x.shape
    h, dh = cfg.n_heads, cfg.d_model // cfg.n_heads
    qkv = _dense(layer["qkv"], _rms_norm(x), dt)
    q, k, v = (a.reshape(b, l, h, dh) for a in torch.split(qkv, cfg.d_model, dim=-1))
    att = attention_reference(q, k, v, causal=True, segments=segments)
    x = x + _dense(layer["proj"], att.reshape(b, l, cfg.d_model), dt)
    if cfg.moe_experts > 0:
        out = _moe.moe_apply(layer["moe"], _rms_norm(x), _moe_cfg(cfg), diagnostics=diagnostics)
        return x + out[0], out[1], (out[2] if diagnostics else None)
    y = _dense(layer["mlp_in"], _rms_norm(x), dt)
    return x + _dense(layer["mlp_out"], _gelu(y), dt), None, None


def _embed_tokens(params, tokens: torch.Tensor, cfg: LMConfig, segments=None) -> torch.Tensor:
    """tokens [B, L+1] -> x [B, L, D] from tokens[:, :-1]. With
    ``segments`` [B, L+1] each document's positions restart at 0: a
    position's document start is the running maximum of the start indices
    before it."""
    dt = cfg.dtype
    x_tok = tokens[:, :-1].long()
    l = x_tok.shape[1]
    if l != cfg.max_len:
        raise ValueError(
            f"packed batch carries {l} input tokens but cfg.max_len is "
            f"{cfg.max_len} (the packer's seq_len must match)"
        )
    if segments is None:
        pos = params["pos"][:l].to(dt)[None]
    else:
        segs = segments[:, :-1]
        idx = torch.arange(l, device=tokens.device)
        boundary = torch.cat(
            [torch.ones(segs.shape[0], 1, dtype=torch.bool, device=segs.device),
             segs[:, 1:] != segs[:, :-1]],
            dim=1,
        )
        start = torch.cummax(torch.where(boundary, idx[None, :], 0), dim=1).values
        pos = params["pos"][idx[None, :] - start].to(dt)         # [B, L, D]
    # gather, then cast: the JAX model casts the table first, the same values
    return params["embed"][x_tok].to(dt) + pos


def _head_logits(params, x: torch.Tensor, cfg: LMConfig) -> torch.Tensor:
    """Final norm and LM head: [.., L, D] -> float32 logits [.., L, V]."""
    return _dense(params["head"], _rms_norm(x), cfg.dtype).float()


def forward(params, tokens: torch.Tensor, cfg: LMConfig, mesh=None, data_axis=None,
            seq_axis=None, pipe_axis=None, expert_axis=None, fsdp_axis=None,
            segments: Optional[torch.Tensor] = None, diagnostics: bool = False):
    """tokens [B, L+1] int -> (logits [B, L, V] float32, aux), or with
    ``diagnostics`` (logits, aux, diag): the model reads tokens[:, :-1];
    ``aux`` is the MoE load-balance loss summed over the layers (0.0 on the
    dense FFN); ``diag`` the MoE counts summed over the layers and the
    fractions averaged (``{}`` on the dense FFN). ``segments`` [B, L+1]
    (the packer's bin modes) masks attention across documents and restarts
    positions per document. The mesh arguments are the JAX signature's:
    not ported, they raise."""
    _refuse(cfg, mesh=mesh, data_axis=data_axis, seq_axis=seq_axis, pipe_axis=pipe_axis,
            expert_axis=expert_axis, fsdp_axis=fsdp_axis)
    x = _embed_tokens(params, tokens, cfg, segments=segments)
    segs_in = segments[:, :-1] if segments is not None else None
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    diags = []
    for i in range(cfg.n_layers):
        x, aux, diag = _block(_layer(params["blocks"], i), x, cfg, segments=segs_in,
                              diagnostics=diagnostics)
        if aux is not None:
            aux_total = aux_total + aux
        if diag is not None:
            diags.append(diag)
    logits = _head_logits(params, x, cfg)
    if not diagnostics:
        return logits, aux_total
    out: Dict[str, torch.Tensor] = {}
    if diags:
        # every layer routes the whole stream: counts sum, fractions average
        n = len(diags)
        out = {
            "expert_tokens": sum(d["expert_tokens"] for d in diags),
            "expert_kept": sum(d["expert_kept"] for d in diags),
            "dropped_fraction": sum(d["dropped_fraction"] for d in diags) / n,
            "gate_entropy": sum(d["gate_entropy"] for d in diags) / n,
        }
    return logits, aux_total, out


def loss_fn(params, tokens, cfg: LMConfig, segments=None, diagnostics: bool = False, **axes):
    """Mean next-token cross-entropy plus ``moe_aux_weight`` times the MoE
    aux loss. Without ``segments`` every position scores; with them a
    position scores only when its input token and its target share a
    nonzero segment. With ``diagnostics`` returns (loss, diag)."""
    out = forward(params, tokens, cfg, segments=segments, diagnostics=diagnostics, **axes)
    logits, aux = out[0], out[1]
    targets = tokens[:, 1:].long()
    logp = F.log_softmax(logits, dim=-1)
    tok_ce = -torch.gather(logp, -1, targets[..., None])[..., 0]
    if segments is None:
        loss = torch.mean(tok_ce)
    else:
        valid = (segments[:, :-1] == segments[:, 1:]) & (segments[:, 1:] != 0)
        loss = torch.sum(tok_ce * valid) / torch.clamp(valid.sum(), min=1)
    if cfg.moe_experts > 0:  # the dense FFN's aux is 0
        loss = loss + cfg.moe_aux_weight * aux
    return (loss, out[2]) if diagnostics else loss


def train_step(params, opt: torch.optim.Optimizer, tokens, cfg: LMConfig, segments=None,
               diagnostics: bool = False, **axes):
    """One optimizer step over ``params`` in place (``opt`` from
    ``models.optim.adam(params, lr)``). Returns the loss (0-dim, on the
    parameters' device) before the update; with ``diagnostics``
    (loss, diag), the diag of ``forward``."""
    opt.zero_grad(set_to_none=True)
    out = loss_fn(params, tokens, cfg, segments=segments, diagnostics=diagnostics, **axes)
    loss = out[0] if diagnostics else out
    loss.backward()
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


def param_shardings(*args, **kwargs):
    """Not ported: parameter placement over a mesh."""
    raise OptionNotPortedError(
        "lm.param_shardings: mesh placement needs torch.distributed across cards, "
        "which the port does not have yet"
    )
