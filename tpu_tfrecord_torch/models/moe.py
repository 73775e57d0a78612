"""Mixture-of-Experts FFN: port of ``tpu_tfrecord/models/moe.py`` on one
card (no mesh).

Top-k routing with a fixed per-expert capacity, the Switch / GShard layer
of the JAX package:

- ``_capacity`` is the JAX integer expression, ``ceil(tokens * factor *
  top_k / E)`` floored at 1, over the flattened token count *including*
  padding: a ``valid`` mask does not shrink it, so both packages drop the
  same assignments;
- arrival order is rank-major: every first choice queues (in token order)
  before any second choice, so a rank's queue positions start after every
  lower rank's total per expert. The gates are the raw router
  probabilities of the chosen experts (no renormalisation); an expert
  already taken is masked to ``-inf`` for the next rank. ``valid`` zeroes
  a padding token's assignment and gate: it takes no slot and stays out
  of the aux loss;
- the load-balance aux loss is Switch eq. 4 over the first choices and
  the valid tokens; ``diagnostics`` adds the routed and kept counts per
  expert, the dropped fraction and the mean gate entropy, without
  gradients.

The JAX layer moves tokens with one-hot [T, E, C] dispatch and combine
einsums. Here each assignment's (expert, queue position) is one row of an
[E·C + 1, D] buffer (the last row takes what was dropped): the kept tokens
are scattered into their rows (each row has at most one writer), the
experts run as two batched matmuls over [E, C, D], and each token gathers
its ``top_k`` rows back, times their gates, summed over the ranks. The
values are the einsums' up to matmul rounding. No step copies to the host,
and every step is deterministic under
``torch.use_deterministic_algorithms(True)``: the queue positions are an
integer cumsum, the backward into ``x`` is a gather of the scattered rows
and a sum over the ranks, and the backward into the expert outputs is an
indexed accumulate.

``moe_reference`` is the JAX package's numpy float64 oracle, the plain
version the tests hold ``moe_apply`` to. Not ported: the expert-parallel
route over a mesh (``moe_apply_ep``, ``moe_ep_body``, ``param_shardings``);
each raises ``OptionNotPortedError``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from tpu_tfrecord_torch.options import OptionNotPortedError


@dataclass(frozen=True)
class MoEConfig:
    d_model: int = 32
    d_ff: int = 64            # per-expert hidden width
    n_experts: int = 4
    # capacity = ceil(tokens * factor * top_k / n_experts): 1.0 just fits
    # perfectly balanced routing, > 1 leaves slack before drops
    capacity_factor: float = 1.25
    # experts per token: 1 = Switch, 2 = GShard-style top-2
    top_k: int = 1
    dtype: torch.dtype = torch.float32


@torch.no_grad()
def init_params(cfg: MoEConfig, generator: Optional[torch.Generator] = None,
                device="cuda") -> Dict[str, torch.Tensor]:
    """Random parameters drawn from ``generator`` (which must live on
    ``device``; seed 0 when None) with the JAX init's distributions:
    ``router`` [D, E] ~ N(0, 0.02²), the expert-stacked ``w_in`` [E, D, F]
    ~ N(0, 2/D) and ``w_out`` [E, F, D] ~ N(0, 2/F). The draws differ from
    ``jax.random``'s; load JAX weights through ``interop``."""
    device = torch.device(device)
    gen = generator if generator is not None else torch.Generator(device=device).manual_seed(0)

    def normal(*shape):
        return torch.randn(*shape, generator=gen, device=device)

    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    return {
        "router": normal(d, e) * 0.02,
        "w_in": normal(e, d, f) * float(np.sqrt(2.0 / d)),
        "w_out": normal(e, f, d) * float(np.sqrt(2.0 / f)),
    }


def _capacity(tokens: int, cfg: MoEConfig) -> int:
    # the JAX expression exactly: ``tokens`` counts padding too (a valid
    # mask does not shrink the budget), so both packages drop alike
    cap = -(-int(tokens * cfg.capacity_factor) * cfg.top_k // cfg.n_experts)
    return max(1, cap)


class Routing(NamedTuple):
    """Where each token's assignments go, rank by rank ([k, T] each), and
    the per-expert totals."""

    expert: torch.Tensor      # [k, T] int64: the rank's expert
    gate: torch.Tensor        # [k, T] f32: its raw router prob (0 for padding)
    slot: torch.Tensor        # [k, T] int64: expert * C + queue position; E * C when not kept
    kept: torch.Tensor        # [k, T] bool: the assignment won a capacity slot
    first: torch.Tensor       # [T, E] f32: the first choices of valid tokens, one-hot
    routed: torch.Tensor      # [E] f32: assignments per expert over every rank, kept or not
    kept_total: torch.Tensor  # [E] f32: assignments that won a slot


def _router_probs(params, xt: torch.Tensor) -> torch.Tensor:
    """[T, D] -> router probabilities [T, E], in float32."""
    return F.softmax(xt.float() @ params["router"].float(), dim=-1)


def _route(probs: torch.Tensor, cfg: MoEConfig, c: int,
           valid: Optional[torch.Tensor] = None) -> Routing:
    """Top-k routing of ``probs`` [T, E] into capacity ``c``, rank-major
    (see the module docstring). ``valid`` [T] bool drops padding."""
    e, k = cfg.n_experts, cfg.top_k
    if not 1 <= k <= e:
        raise ValueError(f"top_k must be in [1, n_experts={e}], got {k}")
    masked = probs.detach()
    ids = torch.arange(e, device=probs.device)[:, None]               # [E, 1]
    prev = torch.zeros(e, 1, dtype=torch.int64, device=probs.device)
    kept_total = torch.zeros_like(prev)
    experts, gates, slots, kepts = [], [], [], []
    first = None
    for _ in range(k):
        expert = torch.argmax(masked, dim=-1)                       # [T]
        gate = torch.gather(probs, 1, expert[:, None])[:, 0]
        # the one-hot laid out [E, T], so the cumsum below scans the
        # contiguous token dim (a scan down 4 columns of 2048 is slow)
        onehot = (ids == expert[None, :]).long()                   # [E, T]
        if valid is not None:
            onehot = onehot * valid[None, :]
            gate = gate * valid
        # queue position within the expert, after every lower rank's
        # arrivals; an integer cumsum (a float one has no deterministic
        # CUDA kernel)
        pos = torch.gather(torch.cumsum(onehot, dim=1) - 1 + prev, 0, expert[None, :])[0]
        keep = (pos < c) & (torch.gather(onehot, 0, expert[None, :])[0] > 0)
        slots.append(torch.where(keep, expert * c + pos, e * c))
        experts.append(expert)
        gates.append(gate)
        kepts.append(keep)
        if first is None:
            first = onehot.t().float()
        prev = prev + onehot.sum(dim=1, keepdim=True)
        kept_total = kept_total + (onehot * keep[None, :]).sum(dim=1, keepdim=True)
        # the expert just taken cannot be the next rank's pick
        masked = masked.masked_fill(onehot.t() > 0, float("-inf"))
    return Routing(torch.stack(experts), torch.stack(gates), torch.stack(slots),
                   torch.stack(kepts), first, prev[:, 0].float(), kept_total[:, 0].float())


def _expert_ffn(params, expert_in: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """[E, C, D] -> [E, C, D] through each expert's GELU FFN, in ``dt``."""
    h = F.gelu(torch.bmm(expert_in, params["w_in"].to(dt)), approximate="tanh")  # jax.nn.gelu's form
    return torch.bmm(h, params["w_out"].to(dt))


def _moe_local(params, xt: torch.Tensor, cfg: MoEConfig, valid: Optional[torch.Tensor], *,
               c: int, diagnostics: bool = False):
    """Route, dispatch, the experts and combine over [T, D] tokens.
    Returns (y [T, D] in ``cfg.dtype``, (first-choice counts [E], router
    prob sums [E], valid token count), and with ``diagnostics`` (routed
    [E], kept [E], gate-entropy sum) else None)."""
    e, dt = cfg.n_experts, cfg.dtype
    t, d = xt.shape
    probs = _router_probs(params, xt)                                # [T, E]
    route = _route(probs, cfg, c, valid)
    if valid is not None:
        vf = valid.float()
        n_tokens = vf.sum()
        prob_sum = (probs * vf[:, None]).sum(dim=0)
    else:
        n_tokens = torch.full((), float(t), device=xt.device)
        prob_sum = probs.sum(dim=0)
    diag = None
    if diagnostics:
        with torch.no_grad():
            ent = -(probs * torch.log(probs + 1e-9)).sum(dim=-1)    # [T]
            if valid is not None:
                ent = ent * vf
            diag = (route.routed, route.kept_total, ent.sum())
    k = cfg.top_k
    # dispatch: each kept assignment into its own row; row E*C takes the
    # dropped ones and is cut off
    rows = xt.new_zeros(e * c + 1, d, dtype=dt).index_put(
        (route.slot.reshape(-1),), xt.to(dt).repeat(k, 1))
    expert_out = _expert_ffn(params, rows[: e * c].reshape(e, c, d), dt)
    # combine: each rank's row back (a zero row when not kept) times its
    # gate, the gates rounded to dt as the JAX combine tensor is, summed
    # in float32 as the einsum accumulates
    out_rows = torch.cat([expert_out.reshape(e * c, d), expert_out.new_zeros(1, d)])
    picked = out_rows[route.slot]                                    # [k, T, D]
    y = (route.gate.to(dt).float()[..., None] * picked.float()).sum(dim=0).to(dt)
    return y, (route.first.sum(dim=0), prob_sum, n_tokens), diag


def _aux_loss(assign_sum, prob_sum, n_tokens, e: int) -> torch.Tensor:
    # Switch eq. 4: E * sum(fraction of first choices * mean prob) over
    # the valid tokens
    n = torch.clamp(n_tokens, min=1.0)
    return ((assign_sum / n) * (prob_sum / n)).sum() * e


def _diag_dict(routed, kept, entropy_sum, n_tokens) -> Dict[str, torch.Tensor]:
    """The diagnostics of the JAX ``_diag_dict``: ``expert_tokens`` [E]
    (assignments routed to each expert, kept or dropped), ``expert_kept``
    [E], ``dropped_fraction`` (1 - kept / routed) and ``gate_entropy``
    (mean router-prob entropy per valid token, nats), all float32 and
    without gradients."""
    with torch.no_grad():
        routed_total = torch.clamp(routed.sum(), min=1.0)
        return {
            "expert_tokens": routed,
            "expert_kept": kept,
            "dropped_fraction": 1.0 - kept.sum() / routed_total,
            "gate_entropy": entropy_sum / torch.clamp(n_tokens, min=1.0),
        }


def moe_apply(params, x: torch.Tensor, cfg: MoEConfig, valid: Optional[torch.Tensor] = None,
              diagnostics: bool = False):
    """Top-k MoE FFN on x [..., T, D] (leading dims flattened into the
    token count). Returns (y, aux) with y shaped and typed like x (a
    dropped assignment adds nothing: the residual outside carries the
    token), aux the float32 load-balance loss; with ``diagnostics``
    (y, aux, diag), diag as ``_diag_dict``.

    ``valid`` ([..., T], bool) excludes padding entirely: no output, no
    capacity slot, no part in the aux loss or the diagnostics."""
    shape = x.shape
    xt = x.reshape(-1, shape[-1])
    c = _capacity(xt.shape[0], cfg)
    vf = valid.reshape(-1).to(torch.bool) if valid is not None else None
    y, (assign_sum, prob_sum, n_tokens), diag = _moe_local(
        params, xt, cfg, vf, c=c, diagnostics=diagnostics)
    aux = _aux_loss(assign_sum, prob_sum, n_tokens, cfg.n_experts)
    y = y.reshape(shape).to(x.dtype)
    if not diagnostics:
        return y, aux
    return y, aux, _diag_dict(*diag, n_tokens)


def _refuse_ep(name: str):
    raise OptionNotPortedError(
        f"moe.{name}: expert parallelism over a mesh is not ported yet; of the models, the "
        "port places the DLRM, long_doc and the LM over a device mesh (ROADMAP.md, Queue A "
        "item 8g)"
    )


def moe_apply_ep(*args, **kwargs):
    """Not ported: the all-to-all expert-parallel layer."""
    _refuse_ep("moe_apply_ep")


def moe_ep_body(*args, **kwargs):
    """Not ported: the per-device body of the expert-parallel layer."""
    _refuse_ep("moe_ep_body")


def param_shardings(*args, **kwargs):
    """Not ported: the expert-axis placement of the weights."""
    _refuse_ep("param_shardings")


def _f64(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().double().numpy()
    return np.asarray(a, dtype=np.float64)


def moe_reference(params, x, cfg: MoEConfig, valid: Optional[Any] = None, shards: int = 1,
                  return_diag: bool = False) -> Any:
    """Per-token float64 oracle (the JAX package's): route each valid
    token to its top-k experts in rank-major arrival order, gate by the
    raw router prob, drop assignments beyond capacity. ``shards`` splits
    the token stream into P contiguous blocks with their own capacity
    budgets. ``return_diag`` also returns the diagnostics by literal
    counting. Takes tensors or numpy arrays; returns numpy."""
    xt = _f64(x).reshape(-1, x.shape[-1])
    vmask = (np.asarray(valid.cpu() if isinstance(valid, torch.Tensor) else valid).reshape(-1)
             if valid is not None else np.ones(xt.shape[0], dtype=bool))
    router, w_in, w_out = (_f64(params[k]) for k in ("router", "w_in", "w_out"))
    t = xt.shape[0]
    if t % shards:
        raise ValueError(f"{t} tokens do not split into {shards} shards")
    t_l = t // shards
    cap = _capacity(t_l, cfg)
    logits = xt @ router
    z = np.exp(logits - logits.max(axis=-1, keepdims=True))
    probs = z / z.sum(axis=-1, keepdims=True)
    out = np.zeros_like(xt)
    routed = np.zeros(cfg.n_experts)
    kept = np.zeros(cfg.n_experts)

    def ffn(ei, v):
        h = v @ w_in[ei]
        h = 0.5 * h * (1.0 + np.tanh(np.sqrt(2 / np.pi) * (h + 0.044715 * h**3)))
        return h @ w_out[ei]

    for b in range(shards):
        lo, hi = b * t_l, (b + 1) * t_l
        counts = {ei: 0 for ei in range(cfg.n_experts)}
        taken = [set() for _ in range(t_l)]  # experts already chosen per token
        for _rank in range(cfg.top_k):
            for i in range(lo, hi):
                if not vmask[i]:
                    continue
                order = np.argsort(-probs[i])
                ei = next(int(e) for e in order if int(e) not in taken[i - lo])
                taken[i - lo].add(ei)
                routed[ei] += 1
                if counts[ei] >= cap:
                    continue
                counts[ei] += 1
                kept[ei] += 1
                out[i] += probs[i, ei] * ffn(ei, xt[i])
    out = out.reshape(tuple(x.shape))
    if not return_diag:
        return out
    n_valid = max(int(vmask.sum()), 1)
    ent = -(probs * np.log(probs + 1e-9)).sum(axis=-1)
    diag = {
        "expert_tokens": routed,
        "expert_kept": kept,
        "dropped_fraction": 1.0 - kept.sum() / max(routed.sum(), 1.0),
        "gate_entropy": float(ent[vmask.astype(bool)].sum() / n_valid),
    }
    return out, diag
