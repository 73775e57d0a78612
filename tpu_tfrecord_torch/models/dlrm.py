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
``train_state(model, opt)`` is the train state as a tree of the live
tensors (parameters, Adam's state, the AdaGrad accumulators) for
``checkpoint.TrainCheckpointer``; ``load_train_state`` copies a restored
tree back in place.

Batch layout is that of ``device.ingest.host_batch_from_columnar`` for a
Criteo-like schema: 'dense' [B, num_dense], 'cat' [B, F] hashed ids (int32
or int64), 'label' [B], optionally 'frames' [B, L, D_in] + 'frames_len' [B].

Over a ``DeviceMesh`` of ranks (``device.mesh.create_mesh``), the JAX
layout: ``param_shardings`` puts the table's V rows and each weight's
output columns on the 'model' axis where the axis size divides them
(``nn.Linear.weight`` is [out, in], so JAX's [in, out@model] is
``Shard(0)`` here) and replicates the rest; ``batch_shardings`` puts the
batch on 'data' and ``frames``' L on 'seq'. ``shard_model`` keeps this
rank's pieces as a ``ShardedDLRM`` (``unshard_model`` gathers them back),
whose forward writes out the collectives GSPMD would insert
(``models.sharded``): column-parallel layers gather their outputs over
'model', the lookup sums each rank's rows of its V range over 'model',
and the sequence tower sums its masked partial sums and counts over
'seq'. ``sharded_train_step`` sums every gradient over 'data' before the
optimizer steps; ``sharded_sparse_train_step`` gathers the row gradients
and their ids over 'data', so every data replica deduplicates the global
batch, and each model rank updates the rows of its own V range.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Iterable, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from tpu_tfrecord_torch.models import sharded
from tpu_tfrecord_torch.models.interaction import dot_interaction
from tpu_tfrecord_torch.models.optim import init_adam_state


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
    """The DLRM's parameters and its forward pass (see module docstring).
    The parameters are made (uninitialized) on ``device``: the card unless
    the caller asks for another device (``init_params`` fills them)."""

    def __init__(self, cfg: DLRMConfig, device="cuda"):
        super().__init__()
        self.cfg = cfg
        interact_dim = cfg.interact_dim()
        with torch.device(device):
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
        bottom_out = self._mlp(self.bottom, dense, dt)           # [B, H]
        if emb is None:
            emb = self.lookup(batch["cat"])
        emb = emb.to(dt)                                         # [B, F, D]
        if cfg.interaction == "dot":
            stack = torch.cat([bottom_out[:, None, :], emb], dim=1)
            pairs = dot_interaction(stack.contiguous())          # [B, P]
            feats = [bottom_out, pairs.to(dt)]
        else:
            feats = [bottom_out, emb.reshape(emb.shape[0], -1)]
        if cfg.seq_len:
            feats.append(self._pooled(batch["frames"].to(dt), batch["frames_len"], dt))
        x = torch.cat(feats, dim=-1)
        logits = self._mlp(self.top, x, dt)
        return logits[:, 0].float()

    def _mlp(self, layers, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return _mlp(layers, x, dtype)

    def lookup(self, cat: torch.Tensor) -> torch.Tensor:
        """The table's rows [B, F, D] (float32) of the ids ``cat`` [B, F].
        The JAX model casts the whole [F, V, D] table to the activation
        dtype before its gather (3.5 GB at Criteo width per call); the
        forward gathers first and casts the rows, which gives the same
        values."""
        idx = cat.long()
        f_ix = torch.arange(self.cfg.num_categorical, device=idx.device)[None, :]
        return self.embeddings[f_ix, idx]

    def _pooled(self, frames: torch.Tensor, frames_len: torch.Tensor, dt: torch.dtype
                ) -> torch.Tensor:
        """The sequence tower: the projected frames' mean over the steps
        below each row's length."""
        proj = self._mlp([self.seq_proj], frames, dt)            # [B, L, D]
        steps = torch.arange(frames.shape[1], device=frames.device)
        mask = (steps[None, :] < frames_len[:, None]).to(dt)
        return (proj * mask[:, :, None]).sum(dim=1) / torch.clamp(
            mask.sum(dim=1, keepdim=True), min=1.0
        )


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
    the table's device, one per row the model holds ([F, V], or this
    rank's [F, V/m] of a ``ShardedDLRM``)."""
    return SparseEmbOptState(
        dense=make_opt(list(dense_parameters(model))),
        accum=torch.zeros(
            tuple(model.embeddings.shape[:2]), dtype=torch.float32,
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
    fdim = cfg.num_categorical
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
        n = idx.shape[0] * fdim
        _row_update(table, state.accum, f_ix.expand(idx.shape).reshape(n), idx.reshape(n),
                    g_rows.reshape(n, -1), embed_lr, embed_eps)
    return loss.detach()


def _segment_sum(values: torch.Tensor, rid: torch.Tensor, n: int, deterministic: bool):
    out = torch.zeros((n,) + values.shape[1:], dtype=values.dtype, device=values.device)
    if deterministic:
        # sorted accumulation: the same bits on every rank and every run
        return out.index_put_((rid,), values, accumulate=True)
    return out.index_add_(0, rid, values)


def _row_update(table, accum, f_flat, v_flat, g, embed_lr, embed_eps, deterministic=False):
    """The dedup-first row-wise AdaGrad of the touched rows, in place:
    element i of the flat lists adds its row gradient ``g[i]`` [D] to row
    (``f_flat[i]``, ``v_flat[i]``) of ``table`` [F, V, D] with accumulator
    ``accum`` [F, V]. ``deterministic`` sums the duplicate groups in sorted
    order (on the card ``index_add_`` sums them with atomics, in any
    order)."""
    n = g.shape[0]
    if n == 0:
        return
    fdim, vocab = table.shape[:2]
    with _span("dedup_sort"):
        order, sf, sv, run_start = _dedup_sort(
            f_flat, v_flat, vocab, force_pairs=fdim * vocab > _FLAT_KEY_MAX
        )
    with _span("segment_sums"):
        sg = g[order]
        rid = torch.cumsum(run_start, 0) - 1                  # run id per element
        # each element's view of its duplicate group's summed gradient and size
        g_sum = _segment_sum(sg, rid, n, deterministic)[rid]                   # [N, D]
        m = _segment_sum(torch.ones(n, dtype=torch.float32, device=sg.device), rid, n,
                         deterministic)[rid]                                   # [N]
        inv_m = 1.0 / m
        ms_share = torch.mean(g_sum * g_sum, dim=-1) * inv_m  # sums to mean(G^2)
    with _span("scatters"):
        accum.index_put_((sf, sv), ms_share, accumulate=True)
        # post-accumulation scale, shared by a row's duplicates by construction
        scale = embed_lr * torch.rsqrt(accum[sf, sv] + embed_eps)  # [N]
        table.index_put_((sf, sv), -(scale * inv_m)[:, None] * g_sum, accumulate=True)


def train_state(model: DLRM, opt) -> Dict[str, object]:
    """The train state as a tree of tensors only, for
    ``checkpoint.TrainCheckpointer``: ``params`` (every parameter by name),
    ``adam`` (for each parameter the optimizer steps, by name: its moments
    and its ``step``) and, for a ``SparseEmbOptState``, ``accum`` (the
    row-wise AdaGrad accumulators). The tensors are the live ones, not
    copies. ``opt`` is a ``torch.optim.Adam`` / ``AdamW`` or a
    ``SparseEmbOptState`` over one; the hyperparameters stay in code."""
    dense = opt.dense if isinstance(opt, SparseEmbOptState) else opt
    if not isinstance(dense, (torch.optim.Adam, torch.optim.AdamW)):
        raise TypeError(f"train_state holds Adam's state; got {type(dense).__name__}")
    names = {id(p): name for name, p in model.named_parameters()}
    tree: Dict[str, object] = {
        "params": dict(model.named_parameters()),
        "adam": {names[id(p)]: init_adam_state(dense, p)
                 for group in dense.param_groups for p in group["params"]},
    }
    if isinstance(opt, SparseEmbOptState):
        tree["accum"] = opt.accum
    return tree


@torch.no_grad()
def load_train_state(model: DLRM, opt, tree) -> None:
    """Copy a restored ``train_state`` tree (numpy arrays or tensors, on
    any device) into ``model`` and ``opt`` in place, so the optimizer
    keeps its parameters. Every leaf must have its target's shape and
    dtype: nothing is cast."""

    def copy(dst, src, path: str) -> None:
        if isinstance(dst, dict):
            if not isinstance(src, dict) or sorted(src) != sorted(dst):
                raise ValueError(f"train state {path or '<root>'}: keys "
                                 f"{sorted(src) if isinstance(src, dict) else type(src).__name__} "
                                 f"!= {sorted(dst)}")
            for k in dst:
                copy(dst[k], src[k], f"{path}[{k!r}]")
            return
        src = torch.as_tensor(src)
        if src.dtype != dst.dtype or tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"train state {path}: {src.dtype} {tuple(src.shape)} cannot "
                             f"load into {dst.dtype} {tuple(dst.shape)}")
        dst.copy_(src)

    copy(train_state(model, opt), tree, "")


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


# -- over a mesh of ranks ---------------------------------------------------------

# The mesh axes a ShardedDLRM runs on ('data', 'model', 'seq').
_DATA, _MODEL, _SEQ = "data", "model", "seq"


def _model_dim(name: str, shape, m: int) -> Optional[int]:
    """The dim of parameter ``name`` that goes on a 'model' axis of size
    ``m``, or None (replicated): the table's V when m divides it, a
    weight's output columns ([out, in]: dim 0) when m divides them."""
    if m == 1:
        return None
    if name == "embeddings":
        return 1 if shape[1] % m == 0 else None
    if len(shape) == 2 and shape[0] % m == 0:
        return 0
    return None


def param_shardings(mesh, model: DLRM, model_axis: str = "model") -> Dict[str, tuple]:
    """The DTensor placements of each of ``model``'s parameters (by its
    name in ``named_parameters``) on ``mesh``, one per mesh dim, as
    ``device.mesh.data_sharding`` gives them: on ``model_axis`` the table
    is ``Shard(1)`` (its V rows) and a weight ``Shard(0)`` (its output
    columns) where the axis size divides them; biases, the rest and every
    other axis ``Replicate()``. The JAX layout, with ``nn.Linear``'s
    [out, in] weights."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names or ())
    m = sharded.axis_size(mesh, model_axis)
    out = {}
    for name, p in model.named_parameters():
        dim = _model_dim(name, tuple(p.shape), m)
        out[name] = tuple(Shard(dim) if axis == model_axis and dim is not None else Replicate()
                          for axis in names)
    return out


def batch_shardings(mesh, batch: Dict[str, torch.Tensor], data_axis: Optional[str] = "data",
                    seq_axis: Optional[str] = None) -> Dict[str, tuple]:
    """The DTensor placements of each array of a global batch on ``mesh``:
    dim 0 ``Shard(0)`` on ``data_axis`` (None: not sharded) and, with
    ``seq_axis`` on the mesh, ``frames``' dim 1 ``Shard(1)`` on it; the
    other axes ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names or ())
    if data_axis is not None and data_axis not in names:
        raise ValueError(f"mesh has no axis {data_axis!r} (axes {names})")
    out = {}
    for name, arr in batch.items():
        on_seq = bool(seq_axis) and seq_axis in names and name == "frames" and arr.ndim >= 2
        out[name] = tuple(Shard(0) if axis == data_axis
                          else Shard(1) if on_seq and axis == seq_axis
                          else Replicate() for axis in names)
    return out


class _MatMul(torch.autograd.Function):
    """``x.to(dt) @ w.to(dt).t()`` for a float32 ``x`` holding ``dt``
    values: the forward is the one-process layer's GEMM in ``dt``; the
    backward hands back dx and dw as float32 sums, unrounded, where the
    one-process GEMMs round theirs to ``dt``. A sum of them over ranks is
    then rounded once, as one GEMM over all the rows rounds its own."""

    @staticmethod
    def forward(ctx, x, w, dt):
        ctx.save_for_backward(x, w)
        ctx.dt = dt
        return x.to(dt) @ w.to(dt).t()

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.float()
        dx = g @ w.to(ctx.dt).float()
        dw = g.reshape(-1, g.shape[-1]).t() @ x.reshape(-1, x.shape[-1])
        return dx, dw, None


class _AddBias(torch.autograd.Function):
    """``y + b.to(y.dtype)``, the bias' gradient summed in float32 and left
    unrounded (see ``_MatMul``)."""

    @staticmethod
    def forward(ctx, y, b):
        return y + b.to(y.dtype)

    @staticmethod
    def backward(ctx, g):
        return g, g.float().reshape(-1, g.shape[-1]).sum(0)


class _ShardedLinear(nn.Module):
    """One MLP layer of a ``ShardedDLRM``: ``weight`` holds this rank's
    output columns [out/m, in] when ``sharded``, else all of them; ``bias``
    [out] is whole (replicated, as in the JAX layout)."""

    def __init__(self, weight: torch.Tensor, bias: torch.Tensor, sharded: bool):
        super().__init__()
        self.weight = nn.Parameter(weight, requires_grad=False)
        self.bias = nn.Parameter(bias, requires_grad=False)
        self.sharded = sharded


class ShardedDLRM(DLRM):
    """This rank's pieces of a ``DLRM`` laid out by ``param_shardings`` on
    ``mesh``, as plain local tensors under the one-process names: the
    table's rows ``v_lo:v_hi`` [F, V/m, D] and the column slices of the
    sharded weights. Its forward takes this rank's part of the global
    batch (its rows on 'data', its steps of ``frames`` on 'seq'; DTensors
    give their local part) and returns the logits of its rows, the same on
    every rank of the 'model' and 'seq' axes. An axis the mesh lacks counts
    as size 1."""

    def __init__(self, model: DLRM, mesh):
        nn.Module.__init__(self)
        self.cfg = model.cfg
        self.mesh = mesh
        m = sharded.axis_size(mesh, _MODEL)
        k = sharded.axis_index(mesh, _MODEL)

        def piece(name: str, t: torch.Tensor) -> torch.Tensor:
            dim = _model_dim(name, tuple(t.shape), m)
            t = t.detach()
            if dim is not None:
                t = t.narrow(dim, k * (t.shape[dim] // m), t.shape[dim] // m)
            return t.clone()

        vocab = model.cfg.vocab_size
        self.table_sharded = _model_dim("embeddings", tuple(model.embeddings.shape), m) is not None
        rows = vocab // m if self.table_sharded else vocab
        self.v_lo = k * rows if self.table_sharded else 0
        self.v_hi = self.v_lo + rows
        self.embeddings = nn.Parameter(piece("embeddings", model.embeddings), requires_grad=False)

        def layers(prefix: str, source) -> nn.ModuleList:
            return nn.ModuleList(
                _ShardedLinear(piece(f"{prefix}.{i}.weight", l.weight), l.bias.detach().clone(),
                               _model_dim(f"{prefix}.{i}.weight", tuple(l.weight.shape), m)
                               is not None)
                for i, l in enumerate(source))

        self.bottom = layers("bottom", model.bottom)
        self.top = layers("top", model.top)
        self.seq_proj = (layers("seq_proj", [model.seq_proj])[0]
                         if model.seq_proj is not None else None)
        self.data_size = sharded.axis_size(mesh, _DATA)

    def _linear(self, layer: _ShardedLinear, x, dt, param_axis=None) -> torch.Tensor:
        """One layer, ``x @ w.to(dt) + b.to(dt)`` as the one-process
        layer computes it. A sharded layer takes its input through
        ``copy_to`` and gathers its output columns; the input travels as
        float32, so its gradient's partial sums over 'model' are added
        before the one rounding to ``dt``."""
        w, b = layer.weight, layer.bias
        if param_axis is not None:
            # each rank of param_axis sees part of the input: the
            # parameters' gradients sum over it
            w, b = sharded.copy_to(w, self.mesh, param_axis), sharded.copy_to(b, self.mesh, param_axis)
        x = x.float()
        if layer.sharded:
            x = sharded.copy_to(x, self.mesh, _MODEL)
            y = sharded.gather_from(_MatMul.apply(x, w, dt), self.mesh, _MODEL, -1)
        else:
            y = _MatMul.apply(x, w, dt)
        return _AddBias.apply(y, b)

    def _mlp(self, layers, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        for i, layer in enumerate(layers):
            x = self._linear(layer, x, dtype)
            if i + 1 < len(layers):
                x = torch.relu(x)
        return x

    def lookup(self, cat: torch.Tensor) -> torch.Tensor:
        """The rows [B, F, D] (float32) of the ids ``cat``: each rank reads
        the ids in its V range (others read as zero rows), and the sum over
        'model' holds each row exactly once."""
        if not self.table_sharded:
            return super().lookup(cat)
        local = cat.long() - self.v_lo
        inside = (local >= 0) & (local < self.v_hi - self.v_lo)
        f_ix = torch.arange(self.cfg.num_categorical, device=local.device)[None, :]
        rows = self.embeddings[f_ix, torch.where(inside, local, 0)]
        rows = torch.where(inside[:, :, None], rows, rows.new_zeros(()))
        return sharded.sum_over(rows, self.mesh, _MODEL)

    def _pooled(self, frames: torch.Tensor, frames_len: torch.Tensor, dt: torch.dtype
                ) -> torch.Tensor:
        """The sequence tower over this rank's steps of ``frames``: the
        masked sums (in float32, rounded to ``dt`` once, as the one-process
        sum rounds) and the counts are summed over 'seq' before the
        division."""
        axis = _SEQ if sharded.axis_size(self.mesh, _SEQ) > 1 else None
        proj = self._linear(self.seq_proj, frames, dt, param_axis=axis)   # [B, L/s, D]
        first = sharded.axis_index(self.mesh, axis) * frames.shape[1]
        steps = torch.arange(frames.shape[1], device=frames.device) + first
        mask = (steps[None, :] < frames_len[:, None]).to(dt)
        total = sharded.sum_over((proj * mask[:, :, None]).float().sum(dim=1), self.mesh, axis)
        count = sharded.sum_over(mask.float().sum(dim=1, keepdim=True), self.mesh, axis)
        return total.to(dt) / torch.clamp(count.to(dt), min=1.0)


def shard_model(model: DLRM, mesh) -> ShardedDLRM:
    """This rank's ``ShardedDLRM`` of the one-process ``model`` (every rank
    passes the same weights)."""
    return ShardedDLRM(model, mesh)


@torch.no_grad()
def unshard_model(model: ShardedDLRM) -> DLRM:
    """The one-process ``DLRM`` of a ``ShardedDLRM``, on every rank: the
    sharded pieces are gathered over 'model'."""
    full = DLRM(model.cfg, device=model.embeddings.device)
    m = sharded.axis_size(model.mesh, _MODEL)
    parts = dict(model.named_parameters())
    for name, p in full.named_parameters():
        dim = _model_dim(name, tuple(p.shape), m)
        piece = parts[name].detach()
        p.copy_(piece if dim is None else sharded.all_gather(piece, model.mesh, _MODEL, dim))
    return full.requires_grad_(False)


def _local(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """This rank's part of a batch of DTensors (tensors as they are)."""
    return {k: v.to_local() if hasattr(v, "to_local") else v for k, v in batch.items()}


def sharded_loss_fn(model: ShardedDLRM, batch: Dict[str, torch.Tensor], emb=None) -> torch.Tensor:
    """This rank's share of the global batch's mean loss: its rows' mean
    over the 'data' axis' size, so that the shares sum over 'data' to the
    mean over every row (every data rank holds as many rows)."""
    logits = model(_local(batch), emb=emb)
    labels = _local(batch)["label"].float()
    per_row = torch.clamp(logits, min=0) - logits * labels + torch.log1p(torch.exp(-logits.abs()))
    return torch.mean(per_row) / model.data_size


def _sum_grads(model: ShardedDLRM, params) -> None:
    """Sum the gradients over 'data' in one collective, then round the
    layers' (float32 partial sums, see ``_MatMul``) to the activation
    dtype, as the one-process step's GEMMs round theirs. The table's
    gradient is a float32 scatter of rows in both and stays as it is."""
    stepped = {id(p) for p in params}
    named = [(n, p) for n, p in model.named_parameters()
             if p.grad is not None and id(p) in stepped]
    sharded.sum_grads([p for _, p in named], model.mesh, _DATA)
    dt = model.cfg.dtype
    if dt != torch.float32:
        for name, p in named:
            if name != "embeddings":
                p.grad.copy_(p.grad.to(dt))


def sharded_train_step(model: ShardedDLRM, opt: torch.optim.Optimizer,
                       batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """``train_step`` over the mesh: every rank differentiates its share of
    the global mean loss, the gradients are summed over 'data', and ``opt``
    steps this rank's pieces (identical on every data replica). Returns the
    global batch's loss before the update (0-dim, the same on every rank)."""
    params = [p for group in opt.param_groups for p in group["params"]]
    for p in params:
        p.requires_grad_(True)
    opt.zero_grad(set_to_none=True)
    share = sharded_loss_fn(model, batch)
    share.backward()
    _sum_grads(model, params)
    opt.step()
    return sharded.all_reduce(share.detach(), model.mesh, _DATA)


def sharded_sparse_train_step(
    model: ShardedDLRM,
    state: SparseEmbOptState,
    batch: Dict[str, torch.Tensor],
    cfg: DLRMConfig,
    embed_lr: float = 0.01,
    embed_eps: float = 1e-8,
) -> torch.Tensor:
    """``sparse_train_step`` over the mesh. The rows of this rank's ids are
    looked up across 'model' and differentiated with the MLPs; the MLPs'
    gradients are summed over 'data' before ``state.dense`` steps. The row
    gradients (already scaled to the global mean) and their ids are
    gathered over 'data', so every data replica deduplicates the whole
    global batch, and each rank applies the dedup-first row-wise AdaGrad
    to the rows of its own V range in its table and accumulator pieces
    (summed in sorted order: the replicas stay bit-equal). Returns the
    global batch's loss before the update."""
    table = model.embeddings                                  # [F, V/m, D]
    table.requires_grad_(False)
    batch = _local(batch)
    idx = batch["cat"].long()                                 # [B, F]
    with torch.no_grad(), _span("gather"):
        rows = model.lookup(idx)                              # [B, F, D]
    rows.requires_grad_(True)
    params = list(dense_parameters(model))
    for p in params:
        p.requires_grad_(True)
    state.dense.zero_grad(set_to_none=True)
    with _span("forward"):
        share = sharded_loss_fn(model, batch, emb=rows)
    with _span("backward"):
        share.backward()
    with _span("dense_opt"):
        _sum_grads(model, params)
        state.dense.step()
    with torch.no_grad():
        g = sharded.all_gather(rows.grad.float(), model.mesh, _DATA)  # [B_g, F, D]
        ids = sharded.all_gather(idx, model.mesh, _DATA)             # [B_g, F]
        n = ids.numel()
        f_ix = torch.arange(cfg.num_categorical, device=ids.device)[None, :]
        f_flat, v_flat, g = f_ix.expand(ids.shape).reshape(n), ids.reshape(n), g.reshape(n, -1)
        if model.table_sharded:
            mine = (v_flat >= model.v_lo) & (v_flat < model.v_hi)
            f_flat, v_flat, g = f_flat[mine], v_flat[mine] - model.v_lo, g[mine]
        _row_update(table, state.accum, f_flat, v_flat, g, embed_lr, embed_eps,
                    deterministic=True)
    return sharded.all_reduce(share.detach(), model.mesh, _DATA)
