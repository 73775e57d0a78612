"""Criteo-style DLRM, forward (scoring) only: port of
``tpu_tfrecord/models/dlrm.py``.

The parameters live in an ``nn.Module`` built by ``init_params``: one
stacked embedding table [F, V, D], bottom and top MLPs of ``nn.Linear``
layers, and an optional sequence-tower projection, all float32. ``forward``
follows the JAX function step by step: activations in ``cfg.dtype`` (bf16
by default), ``x @ w + b`` per layer with relu between layers, the dot
interaction over ``[bottom_out; embeddings]`` (bottom output first), the
concat order ``[bottom_out, pairs, pooled]``, and float32 logits.

Batch layout is that of ``device.ingest.host_batch_from_columnar`` for a
Criteo-like schema: 'dense' [B, num_dense], 'cat' [B, F] hashed ids (int32
or int64), 'label' [B], optionally 'frames' [B, L, D_in] + 'frames_len' [B].
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from tpu_tfrecord_torch.models.interaction import dot_interaction


@dataclass(frozen=True)
class DLRMConfig:
    num_dense: int = 13
    num_categorical: int = 26
    vocab_size: int = 1024          # per-feature hash buckets
    embed_dim: int = 32
    bottom_mlp: Tuple[int, ...] = (64, 32)
    top_mlp: Tuple[int, ...] = (64, 1)
    seq_len: int = 0                # 0 = no sequence tower
    seq_dim: int = 0
    dtype: torch.dtype = torch.bfloat16  # activation dtype
    # 'cat': concatenate bottom output + flattened embeddings
    # 'dot': pairwise dot interaction over [bottom_out; embs]
    #        (requires bottom_mlp[-1] == embed_dim)
    interaction: str = "cat"

    def interact_dim(self) -> int:
        if self.interaction == "dot":
            if self.bottom_mlp[-1] != self.embed_dim:
                raise ValueError(
                    "interaction='dot' requires bottom_mlp[-1] == embed_dim "
                    f"(got {self.bottom_mlp[-1]} vs {self.embed_dim})"
                )
            n_feat = self.num_categorical + 1  # embeddings + bottom output
            dim = self.bottom_mlp[-1] + n_feat * (n_feat - 1) // 2
        elif self.interaction == "cat":
            dim = self.bottom_mlp[-1] + self.num_categorical * self.embed_dim
        else:
            raise ValueError(f"unknown interaction {self.interaction!r}")
        return dim + (self.embed_dim if self.seq_len else 0)


def _mlp_layers(fan_in: int, widths: Tuple[int, ...]) -> nn.ModuleList:
    layers = []
    for width in widths:
        layers.append(nn.Linear(fan_in, width))
        fan_in = width
    return nn.ModuleList(layers)


def _mlp(layers: Sequence[nn.Linear], x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    # x @ w.astype(dt) + b.astype(dt), as the JAX model computes it: the
    # product is rounded to dt before the bias add (no fused addmm)
    for i, layer in enumerate(layers):
        x = x @ layer.weight.to(dtype).t() + layer.bias.to(dtype)
        if i + 1 < len(layers):
            x = torch.relu(x)
    return x


class DLRM(nn.Module):
    """The DLRM's parameters and its forward pass (see module docstring)."""

    def __init__(self, cfg: DLRMConfig, device=None):
        super().__init__()
        self.cfg = cfg
        interact_dim = cfg.interact_dim()
        with torch.device(device or "cpu"):
            self.embeddings = nn.Parameter(
                torch.empty(cfg.num_categorical, cfg.vocab_size, cfg.embed_dim),
                requires_grad=False,
            )
            self.bottom = _mlp_layers(cfg.num_dense, cfg.bottom_mlp)
            self.top = _mlp_layers(interact_dim, cfg.top_mlp)
            self.seq_proj = nn.Linear(cfg.seq_dim, cfg.embed_dim) if cfg.seq_len else None

    def forward(
        self, batch: Dict[str, torch.Tensor], emb: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        """Logits [B] in float32. ``emb`` optionally supplies the gathered
        embedding rows [B, F, D]; the table is then not read."""
        cfg = self.cfg
        dt = cfg.dtype
        dense = batch["dense"].to(dt)
        bottom_out = _mlp(self.bottom, dense, dt)                # [B, H]
        if emb is None:
            # Gather the rows first, then cast: the JAX model casts the
            # whole [F, V, D] table to dt before its gather (3.5 GB at
            # Criteo width per call); the cast is elementwise, so the
            # result is identical.
            idx = batch["cat"].long()                            # [B, F]
            f_ix = torch.arange(cfg.num_categorical, device=idx.device)[None, :]
            emb = self.embeddings[f_ix, idx]
        emb = emb.to(dt)                                         # [B, F, D]
        if cfg.interaction == "dot":
            stack = torch.cat([bottom_out[:, None, :], emb], dim=1)
            pairs = dot_interaction(stack.contiguous())          # [B, P]
            feats = [bottom_out, pairs.to(dt)]
        else:
            feats = [bottom_out, emb.reshape(emb.shape[0], -1)]
        if cfg.seq_len:
            frames = batch["frames"].to(dt)                      # [B, L, D_in]
            proj = _mlp([self.seq_proj], frames, dt)             # [B, L, D]
            steps = torch.arange(frames.shape[1], device=frames.device)
            mask = (steps[None, :] < batch["frames_len"][:, None]).to(dt)
            pooled = (proj * mask[:, :, None]).sum(dim=1) / torch.clamp(
                mask.sum(dim=1, keepdim=True), min=1.0
            )
            feats.append(pooled)
        x = torch.cat(feats, dim=-1)
        logits = _mlp(self.top, x, dt)
        return logits[:, 0].float()


@torch.no_grad()
def init_params(
    cfg: DLRMConfig, generator: Optional[torch.Generator] = None, device="cuda"
) -> DLRM:
    """A DLRM with random weights drawn from ``generator`` (which must live
    on ``device``; seed 0 when None): the table ~ N(0, 0.05^2), each weight
    He-scaled N(0, 2/fan_in), biases zero — the JAX init's distributions.
    The draws themselves differ from ``jax.random``'s; load JAX weights
    through ``interop`` to compare the two models."""
    device = torch.device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    model = DLRM(cfg, device=device)
    model.embeddings.normal_(0.0, 0.05, generator=generator)
    layers = list(model.bottom) + list(model.top)
    if model.seq_proj is not None:
        layers.append(model.seq_proj)
    for layer in layers:
        layer.weight.normal_(0.0, float(np.sqrt(2.0 / layer.in_features)), generator=generator)
        layer.bias.zero_()
    return model.requires_grad_(False)


def loss_fn(model: DLRM, batch: Dict[str, torch.Tensor], emb=None) -> torch.Tensor:
    """Mean binary cross-entropy with logits, in the JAX model's stable form."""
    logits = model(batch, emb=emb)
    labels = batch["label"].float()
    return torch.mean(
        torch.clamp(logits, min=0) - logits * labels + torch.log1p(torch.exp(-logits.abs()))
    )


def make_synthetic_batch(
    cfg: DLRMConfig, batch_size: int, seed: int = 0
) -> Dict[str, np.ndarray]:
    """Deterministic synthetic Criteo-like host batch (numpy), the same
    arrays as the JAX package's ``make_synthetic_batch`` for the same seed."""
    rng = np.random.default_rng(seed)
    batch = {
        "dense": rng.normal(size=(batch_size, cfg.num_dense)).astype(np.float32),
        "cat": rng.integers(
            0, cfg.vocab_size, size=(batch_size, cfg.num_categorical), dtype=np.int64
        ),
        "label": rng.integers(0, 2, size=(batch_size,)).astype(np.float32),
    }
    if cfg.seq_len:
        batch["frames"] = rng.normal(
            size=(batch_size, cfg.seq_len, cfg.seq_dim)
        ).astype(np.float32)
        batch["frames_len"] = rng.integers(
            1, cfg.seq_len + 1, size=(batch_size,)
        ).astype(np.int32)
    return batch
