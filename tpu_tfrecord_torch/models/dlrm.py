"""Criteo-style DLRM, scoring and training: port of
``tpu_tfrecord/models/dlrm.py``.

The parameters live in an ``nn.Module`` built by ``init_params``: one
stacked embedding table [F, V, D], bottom and top MLPs of ``nn.Linear``
layers, and an optional sequence-tower projection, all float32. ``forward``
follows the JAX function step by step: activations in ``cfg.dtype`` (bf16
by default), ``x @ w + b`` per layer with relu between layers, the dot
interaction over ``[bottom_out; embeddings]`` (bottom output first), the
concat order ``[bottom_out, pairs, pooled]``, and float32 logits.

Training follows the JAX steps: ``train_step`` differentiates everything
(the table's gradient is dense, [F, V, D]) and applies one
``torch.optim.Optimizer``; ``sparse_train_step`` differentiates the
gathered rows [B, F, D] and the MLPs only, steps the MLPs with the
optimizer in ``SparseEmbOptState.dense`` and the touched table rows with
the dedup-first row-wise AdaGrad. optax's transforms map onto torch's:
``optax.adam(lr)`` is ``torch.optim.Adam(params, lr)`` (betas (0.9, 0.999),
eps 1e-8, the same update formula), ``optax.sgd(lr)`` is
``torch.optim.SGD(params, lr)``. A step returns its loss as a 0-dim tensor
on the model's device and never reads it back to the host.

Batch layout is that of ``device.ingest.host_batch_from_columnar`` for a
Criteo-like schema: 'dense' [B, num_dense], 'cat' [B, F] hashed ids (int32
or int64), 'label' [B], optionally 'frames' [B, L, D_in] + 'frames_len' [B].
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Iterable, NamedTuple, Optional, Sequence, Tuple

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


def train_step(model: DLRM, opt: torch.optim.Optimizer, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """One step over every parameter that ``opt`` holds: loss -> backward ->
    ``opt.step()``. The table's gradient is dense ([F, V, D], like the JAX
    step's); use ``sparse_train_step`` for large tables. Returns the loss
    (0-dim, on the model's device) before the update."""
    params = [p for group in opt.param_groups for p in group["params"]]
    for p in params:
        p.requires_grad_(True)
    opt.zero_grad(set_to_none=True)
    loss = loss_fn(model, batch)
    loss.backward()
    opt.step()
    return loss.detach()


class SparseEmbOptState(NamedTuple):
    """Optimizer state of ``sparse_train_step``: the optimizer over every
    parameter but the table, and the row-wise AdaGrad accumulators [F, V]
    float32 (one per table row, not per element)."""

    dense: torch.optim.Optimizer
    accum: torch.Tensor


def dense_parameters(model: DLRM) -> Iterable[nn.Parameter]:
    """Every parameter of ``model`` but the embedding table."""
    return (p for name, p in model.named_parameters() if name != "embeddings")


def sparse_opt_init(
    model: DLRM, cfg: DLRMConfig, make_opt: Callable[[Iterable[nn.Parameter]], torch.optim.Optimizer]
) -> SparseEmbOptState:
    """``make_opt`` over the non-table parameters (for example
    ``lambda ps: torch.optim.Adam(ps, lr=1e-3)``) and zero accumulators on
    the table's device."""
    return SparseEmbOptState(
        dense=make_opt(list(dense_parameters(model))),
        accum=torch.zeros(
            (cfg.num_categorical, cfg.vocab_size), dtype=torch.float32,
            device=model.embeddings.device,
        ),
    )


def _span(name: str):
    """A named range of the sparse step in a ``torch.profiler`` trace
    ("sparse_step.<name>"); next to nothing when no profiler runs."""
    return torch.profiler.record_function(f"sparse_step.{name}")


# Largest F*V for which the flat dedup key f*V + v cannot wrap. The JAX
# package's key is int32 (x64 is off there) and switches to a (f, v) pair
# sort past 2^31 - 1; the port's key is int64, so the pair sort is never
# needed at any table torch can hold. It stays (``force_pairs``) so tests
# can pin both paths against the JAX package's.
_FLAT_KEY_MAX = 2**63 - 1


def _dedup_sort(f_flat: torch.Tensor, v_flat: torch.Tensor, vocab: int, force_pairs: bool = False):
    """Sorted grouping for the dedup-first update: (order, sf, sv,
    run_start), where ``order`` sorts the flat (f, v) list
    lexicographically (stable), ``sf``/``sv`` are the sorted pairs and
    ``run_start`` marks each duplicate group's first element. Flat int64
    keys take one stable sort; ``force_pairs`` is the lexsort, a stable
    sort by v and then a stable sort by f, which gives the same
    permutation."""
    f_flat, v_flat = f_flat.long(), v_flat.long()
    if force_pairs:
        by_v = torch.sort(v_flat, stable=True).indices
        order = by_v[torch.sort(f_flat[by_v], stable=True).indices]
    else:
        order = torch.sort(v_flat + f_flat * vocab, stable=True).indices
    sf = f_flat[order]
    sv = v_flat[order]
    run_start = torch.cat([
        torch.ones(1, dtype=torch.bool, device=sf.device),
        (sf[1:] != sf[:-1]) | (sv[1:] != sv[:-1]),
    ])
    return order, sf, sv, run_start


def sparse_train_step(
    model: DLRM,
    state: SparseEmbOptState,
    batch: Dict[str, torch.Tensor],
    cfg: DLRMConfig,
    embed_lr: float = 0.01,
    embed_eps: float = 1e-8,
) -> torch.Tensor:
    """One step with sparse embedding updates (row-wise AdaGrad), in place.

    The table never requires grad: the batch's rows [B, F, D] are gathered
    without a graph and the loss is differentiated with respect to them
    and the MLPs. ``state.dense`` steps the MLPs. The touched rows get the
    dedup-first row-wise AdaGrad of the JAX step: rows repeated in the
    batch sum their gradients first (a sort and a segment sum over the
    B*F (f, v) keys), the accumulator adds mean((sum g)^2) once per unique
    row (split evenly over its duplicates, so a plain scatter-add applies
    it once), and the summed gradient is scaled by
    embed_lr / sqrt(accum + embed_eps) after the accumulation. Returns the
    loss (0-dim, on the model's device) before the update."""
    table = model.embeddings                                  # [F, V, D]
    table.requires_grad_(False)
    idx = batch["cat"].long()                                 # [B, F]
    fdim, vocab = cfg.num_categorical, cfg.vocab_size
    f_ix = torch.arange(fdim, device=idx.device)[None, :]     # [1, F]
    with torch.no_grad(), _span("gather"):
        rows = table[f_ix, idx]                               # [B, F, D]
    rows.requires_grad_(True)
    for p in dense_parameters(model):
        p.requires_grad_(True)
    state.dense.zero_grad(set_to_none=True)
    with _span("forward"):
        loss = loss_fn(model, batch, emb=rows)
    with _span("backward"):
        loss.backward()
    with _span("dense_opt"):
        state.dense.step()
    with torch.no_grad():
        g_rows = rows.grad.float()
        d = g_rows.shape[-1]
        n = idx.shape[0] * fdim
        f_flat = f_ix.expand(idx.shape).reshape(n)            # [N] feature id
        v_flat = idx.reshape(n)                               # [N] vocab row
        with _span("dedup_sort"):
            order, sf, sv, run_start = _dedup_sort(
                f_flat, v_flat, vocab, force_pairs=fdim * vocab > _FLAT_KEY_MAX
            )
        with _span("segment_sums"):
            sg = g_rows.reshape(n, d)[order]
            rid = torch.cumsum(run_start, 0) - 1              # run id per element
            # each element's view of its duplicate group's summed gradient and size
            g_sum = torch.zeros_like(sg).index_add_(0, rid, sg)[rid]        # [N, D]
            m = torch.zeros(n, dtype=torch.float32, device=sg.device).index_add_(
                0, rid, torch.ones(n, dtype=torch.float32, device=sg.device))[rid]
            inv_m = 1.0 / m
            ms_share = torch.mean(g_sum * g_sum, dim=-1) * inv_m  # sums to mean(G^2)
        with _span("scatters"):
            state.accum.index_put_((sf, sv), ms_share, accumulate=True)
            # post-accumulation scale, shared by a row's duplicates by construction
            scale = embed_lr * torch.rsqrt(state.accum[sf, sv] + embed_eps)  # [N]
            table.index_put_((sf, sv), -(scale * inv_m)[:, None] * g_sum, accumulate=True)
    return loss.detach()


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
