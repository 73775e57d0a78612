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
version the tests hold ``moe_apply`` to.

Over a torch ``DeviceMesh`` of ranks there are two routes, as in JAX:

- the pinned expert-parallel route (``moe_ep_body``, ``moe_apply_ep``):
  each rank routes its own token shard under its own budget
  ``_capacity(T_local)`` (``moe_reference(shards=P)``), and
  ``models.sharded.all_to_all`` moves the [E, C, D] capacity slices so
  that each rank runs only its E/P experts over the P·C rows it received
  (split 0, concat 1), the inverse exchange bringing the outputs home.
  The aux-loss pieces and the diagnostics are summed over the expert and
  data axes before the ratios form. ``param_shardings`` places the expert
  dim on the expert axis (``Shard(0)``, the router replicated);
  ``shard_experts`` / ``unshard_experts`` cut a tree to this rank's
  experts and gather it back;
- the global route (``_moe_apply_tokens``), what JAX's ``moe_apply``
  computes under GSPMD on a mesh that shards the tokens over data and
  seq axes: routing and capacity over the whole flattened token set, in
  its natural order, with ``_capacity`` of the global count. Each rank
  routes its own tokens, the [k, T_local] expert ids travel with each
  token's global flat index (the list ``all_gather``), every rank works
  out the queue positions of the whole set, and each runs the experts
  and the combine on its own kept tokens only: activations stay local.

Only ``all_reduce`` and the list ``all_gather`` are issued (gloo runs
those two on CUDA tensors).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from tpu_tfrecord_torch.models import sharded
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
               c: int, exchange=None, route=_route, diagnostics: bool = False):
    """Route, dispatch, the experts and combine over [T, D] tokens.
    Returns (y [T, D] in ``cfg.dtype``, (first-choice counts [E], router
    prob sums [E], valid token count), and with ``diagnostics`` (routed
    [E], kept [E], gate-entropy sum) else None): every piece a sum, so a
    caller over ranks reduces them with one sum. ``exchange`` is an
    optional (to_experts, from_experts) pair around the experts (the
    identity when None; the all_to_all pair under EP); ``route`` gives the
    ``Routing`` of (probs, cfg, c, valid), ``c`` the rows of each expert's
    buffer."""
    e, dt = cfg.n_experts, cfg.dtype
    t, d = xt.shape
    probs = _router_probs(params, xt)                                # [T, E]
    route = route(probs, cfg, c, valid)
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
    expert_in = rows[: e * c].reshape(e, c, d)
    if exchange is not None:
        expert_in = exchange[0](expert_in)
    expert_out = _expert_ffn(params, expert_in, dt)
    if exchange is not None:
        expert_out = exchange[1](expert_out)
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


def _sum_pieces(pieces, mesh, axes) -> list:
    """Each tensor of ``pieces`` summed over every axis of ``axes`` (one
    float32 ``all_reduce`` an axis for all of them; the gradient passes
    through, so each rank differentiates its own part)."""
    axes = [a for a in axes if sharded.axis_size(mesh, a) > 1]
    if not axes:
        return list(pieces)
    flat = torch.cat([p.reshape(-1).float() for p in pieces])
    for axis in axes:
        flat = sharded.sum_over(flat, mesh, axis)
    out, at = [], 0
    for p in pieces:
        out.append(flat[at:at + p.numel()].reshape(p.shape).to(p.dtype))
        at += p.numel()
    return out


def _reduced_result(y, x_shape, x_dtype, pieces, diag, cfg: MoEConfig, mesh, axes,
                    diagnostics: bool):
    """(y, aux[, diag]) with the aux loss and the diagnostics formed from
    ``pieces`` (and ``diag``'s) summed over ``axes`` first."""
    n_aux = len(pieces)
    summed = _sum_pieces(list(pieces) + (list(diag) if diagnostics else []), mesh, axes)
    assign_sum, prob_sum, n_tokens = summed[:n_aux]
    aux = _aux_loss(assign_sum, prob_sum, n_tokens, cfg.n_experts)
    y = y.reshape(x_shape).to(x_dtype)
    if not diagnostics:
        return y, aux
    return y, aux, _diag_dict(*[t.detach() for t in summed[n_aux:]], n_tokens.detach())


def _ep_shapes(cfg: MoEConfig, p: int, t_dim: int, expert_axis: str) -> None:
    """JAX's two ``ValueError``s of the expert-parallel layer."""
    e = cfg.n_experts
    if e % p:
        raise ValueError(
            f"moe_apply_ep needs n_experts % mesh['{expert_axis}'] == 0 "
            f"(got E={e}, axis size {p})"
        )
    if t_dim % p:
        raise ValueError(
            f"moe_apply_ep needs the token dim % mesh['{expert_axis}'] == 0 "
            f"(got T={t_dim}, axis size {p}); pad or re-bucket the stream"
        )


def moe_ep_body(params_local, x_local: torch.Tensor, cfg: MoEConfig, expert_axis: str,
                data_axis: Optional[str] = None, valid_local: Optional[torch.Tensor] = None,
                diagnostics: bool = False, *, mesh=None):
    """The per-rank body of the expert-parallel layer (JAX's, whose mesh
    is the enclosing ``shard_map``'s; here ``mesh``, a ``DeviceMesh``, or
    None for one rank). ``params_local`` holds this rank's experts
    ([E/P, ...] ``w_in`` / ``w_out``, as ``shard_experts`` cuts them) and
    the whole router; ``x_local`` [..., T_local, D] is this rank's token
    shard (leading dims flattened into the token count, which sets the
    per-shard budget ``_capacity(T_local)``). ``models.sharded.all_to_all``
    sends the [E, C, D] capacity slices to the ranks of their experts and
    brings the outputs back. Returns (y, aux) with y shaped like
    ``x_local``, or with ``diagnostics`` (y, aux, diag): the aux pieces and
    the diagnostics summed over ``expert_axis`` (and ``data_axis``) before
    the ratios form, the same on every rank."""
    p = sharded.axis_size(mesh, expert_axis)
    w_experts = params_local["w_in"].shape[0]
    if w_experts * p != cfg.n_experts:
        raise ValueError(
            f"moe_ep_body: params_local holds {w_experts} experts, not n_experts / "
            f"mesh['{expert_axis}'] = {cfg.n_experts} / {p} (cut them with shard_experts)")
    xt = x_local.reshape(-1, x_local.shape[-1])
    vf = valid_local.reshape(-1).to(torch.bool) if valid_local is not None else None
    c = _capacity(xt.shape[0], cfg)
    # the exchange around the shared body: the expert dim cut P ways, each
    # rank keeps its E/P experts' capacity slices from every rank (concat
    # on the capacity dim: [E/P, P*C, D]); the inverse brings the outputs
    # home. Tokens move, weights never do.
    exchange = (
        lambda a: sharded.all_to_all(a, mesh, expert_axis, split_dim=0, concat_dim=1),
        lambda a: sharded.all_to_all(a, mesh, expert_axis, split_dim=1, concat_dim=0),
    )
    y, pieces, diag = _moe_local(params_local, xt, cfg, vf, c=c, exchange=exchange,
                                 diagnostics=diagnostics)
    return _reduced_result(y, x_local.shape, x_local.dtype, pieces, diag, cfg, mesh,
                           (expert_axis, data_axis), diagnostics)


def _refuse_mapping(mesh, what: str) -> None:
    """Refuse a mapping mesh (one card) with an axis wider than 1."""
    wide = any(n > 1 for n in sharded.mesh_shape(mesh).values())
    if not hasattr(mesh, "mesh_dim_names") and wide:
        raise OptionNotPortedError(
            f"moe.{what}(mesh={type(mesh).__name__}): the port runs expert parallelism over "
            "the ranks of a torch DeviceMesh only")


def moe_apply_ep(params, x: torch.Tensor, cfg: MoEConfig, mesh, expert_axis: str = "expert",
                 data_axis: Optional[str] = None, valid: Optional[torch.Tensor] = None,
                 diagnostics: bool = False):
    """The comms-pinned expert-parallel layer over ``mesh[expert_axis]``:
    ``params`` and x [..., T, D] (and ``valid`` [..., T]) whole, the same
    on every rank. Each rank takes its E/P experts and its T/P tokens
    (with ``data_axis`` and leading dims, its rows of the first leading dim
    too: JAX's ``x_spec``), runs ``moe_ep_body`` and gets y back whole
    (``models.sharded.gather_from``). Numerics: ``moe_reference(shards=P)``
    (per-shard capacity). Returns (y, aux) or (y, aux, diag) as
    ``moe_ep_body``. The inputs enter through ``copy_to`` and the output
    leaves through ``gather_from``, so the gradients of ``params`` and ``x``
    are whole on every rank when the rest of the loss is computed alike on
    every rank, as ``jax.grad`` of the JAX layer gives them."""
    p = sharded.mesh_shape(mesh)[expert_axis]
    _ep_shapes(cfg, p, x.shape[-2], expert_axis)
    _refuse_mapping(mesh, "moe_apply_ep")
    lead = x.shape[:-2]
    dp = data_axis if data_axis is not None and lead else None
    axes = [expert_axis] + ([dp] if dp is not None else [])

    def enter(t):
        for axis in axes:
            t = sharded.copy_to(t, mesh, axis)
        return t

    def rows(t):
        # the first leading dim's rows of this rank's 'data' coordinate
        if dp is None:
            return t
        n = sharded.axis_size(mesh, dp)
        per = t.shape[0] // n
        return t.narrow(0, sharded.axis_index(mesh, dp) * per, per)

    j, el, tl = sharded.axis_index(mesh, expert_axis), cfg.n_experts // p, x.shape[-2] // p
    local = {"router": enter(params["router"]),
             "w_in": enter(params["w_in"]).narrow(0, j * el, el),
             "w_out": enter(params["w_out"]).narrow(0, j * el, el)}
    x_l = rows(enter(x)).narrow(x.dim() - 2, j * tl, tl)
    v_l = rows(valid).narrow(valid.dim() - 1, j * tl, tl) if valid is not None else None
    out = moe_ep_body(local, x_l, cfg, expert_axis, data_axis=data_axis, valid_local=v_l,
                      diagnostics=diagnostics, mesh=mesh)
    y = sharded.gather_from(out[0], mesh, expert_axis, dim=x.dim() - 2)
    if dp is not None:
        y = sharded.gather_from(y, mesh, dp, dim=0)
    return (y,) + tuple(out[1:])


def param_shardings(mesh, expert_axis: str = "model") -> Dict[str, tuple]:
    """The placements of the MoE parameters on ``mesh`` (a ``DeviceMesh``
    or a mapping of axis sizes), one per mesh dim: the expert dim of
    ``w_in`` / ``w_out`` ``Shard(0)`` on ``expert_axis``, the router
    replicated (JAX's ``NamedSharding`` specs). An axis the mesh lacks
    raises JAX's ``ValueError``."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(sharded.mesh_shape(mesh))
    if expert_axis not in names:
        raise ValueError(f"Resource axis: {expert_axis} of the expert weights' spec is not "
                         f"found in mesh: {names}.")
    expert = tuple(Shard(0) if name == expert_axis else Replicate() for name in names)
    return {"router": tuple(Replicate() for _ in names), "w_in": expert, "w_out": expert}


@torch.no_grad()
def shard_experts(params, mesh, expert_axis: str = "model") -> Dict[str, torch.Tensor]:
    """This rank's experts of a whole MoE tree (tensors or numpy arrays,
    the same on every rank), as ``param_shardings`` places them: ``w_in``
    and ``w_out`` cut on their expert dim, the router whole; new contiguous
    leaf tensors."""
    n, k = sharded.axis_size(mesh, expert_axis), sharded.axis_index(mesh, expert_axis)

    def piece(name):
        t = torch.as_tensor(params[name]).detach()
        if name != "router":
            if t.shape[0] % n:
                raise ValueError(f"{t.shape[0]} experts do not split over mesh['{expert_axis}'] "
                                 f"= {n}")
            t = t.narrow(0, k * (t.shape[0] // n), t.shape[0] // n)
        return t.clone().contiguous()

    return {name: piece(name) for name in params}


@torch.no_grad()
def unshard_experts(params, mesh, expert_axis: str = "model") -> Dict[str, torch.Tensor]:
    """The whole MoE tree of ``shard_experts``' pieces, on every rank:
    ``w_in`` / ``w_out`` gathered over ``expert_axis`` (a collective: every
    rank of the mesh calls it, in the same order)."""
    return {name: (t.detach().clone() if name == "router"
                   else sharded.all_gather(t.detach(), mesh, expert_axis, 0).clone())
            for name, t in params.items()}


# -- the global route: moe_apply's semantics over the token shards of ranks --------------


def _route_over_ranks(probs: torch.Tensor, cfg: MoEConfig, c: int,
                      valid: Optional[torch.Tensor], *, mesh, token_axes: Sequence[str],
                      flat_index: torch.Tensor, total: int) -> Routing:
    """``_route`` over the whole token set of the ranks of ``token_axes``:
    this rank's [k, T] picks and each token's global flat index
    (``flat_index`` [T] in 0..total-1) are gathered, every rank works out
    the rank-major queue positions of the whole set in flat-index order
    under ``_capacity(total)``, and keeps its own tokens'. Its kept
    assignments take rows of a compact buffer of ``c`` rows an expert
    (c >= min(capacity, T)). ``routed`` and ``kept_total`` count this
    rank's tokens only, as the other pieces do."""
    e, k = cfg.n_experts, cfg.top_k
    if not 1 <= k <= e:
        raise ValueError(f"top_k must be in [1, n_experts={e}], got {k}")
    dev = probs.device
    t = probs.shape[0]
    masked = probs.detach()
    picks = []
    for _ in range(k):
        expert = torch.argmax(masked, dim=-1)
        picks.append(expert)
        # the expert just taken cannot be the next rank's pick
        masked = masked.scatter(1, expert[:, None], float("-inf"))
    expert = torch.stack(picks)                                      # [k, T]
    vmask = valid if valid is not None else torch.ones(t, dtype=torch.bool, device=dev)
    # only ids move: the picks, the valid flag and the flat index of each token
    ids = torch.cat([expert, vmask.long()[None], flat_index.long()[None]])   # [k + 2, T]
    for axis in token_axes:
        ids = sharded.all_gather(ids, mesh, axis, dim=1)
    whole = torch.zeros(k + 1, total, dtype=torch.int64, device=dev)
    whole[:, ids[k + 1]] = ids[: k + 1]                               # in flat-index order
    cap = _capacity(total, cfg)
    eids = torch.arange(e, device=dev)[:, None]
    prev = torch.zeros(e, 1, dtype=torch.int64, device=dev)
    keep_whole = []
    for r in range(k):
        onehot = (eids == whole[r][None, :]).long() * whole[k][None, :]     # [E, total]
        pos = torch.gather(torch.cumsum(onehot, dim=1) - 1 + prev, 0, whole[r][None, :])[0]
        keep_whole.append((pos < cap) & (whole[k] > 0))
        prev = prev + onehot.sum(dim=1, keepdim=True)
    kept = torch.stack(keep_whole)[:, flat_index.long()]             # [k, T]: this rank's
    # this rank's kept assignments, rank-major, in the rows of a compact buffer
    own = (eids[None] == expert[:, None, :]).long() * kept[:, None, :].long()   # [k, E, T]
    flat = own.transpose(0, 1).reshape(e, k * t)                     # [E, k*T] rank-major
    local_pos = torch.gather(torch.cumsum(flat, dim=1) - 1, 0,
                             expert.reshape(1, k * t))[0].reshape(k, t)
    slot = torch.where(kept, expert * c + local_pos, e * c)
    gate = torch.gather(probs, 1, expert.t()).t()                    # [k, T]
    vf = vmask.float()
    gate = gate * vf[None]
    first = F.one_hot(expert[0], e).float() * vf[:, None]
    routed = F.one_hot(expert, e).float().mul(vf[None, :, None]).sum(dim=(0, 1))
    kept_total = own.sum(dim=(0, 2)).float()
    return Routing(expert, gate, slot, kept, first, routed, kept_total)


def _moe_apply_tokens(params, x: torch.Tensor, cfg: MoEConfig, mesh, token_axes: Sequence[str],
                      flat_index: torch.Tensor, total: int,
                      valid: Optional[torch.Tensor] = None, diagnostics: bool = False):
    """``moe_apply`` over the tokens of the ranks of ``token_axes``: x
    [..., D] is this rank's tokens, ``flat_index`` (x's shape without D)
    their positions in the flattened global token set of ``total`` tokens
    (its natural order), ``valid`` their padding mask. The routing and the
    capacity are those of ``moe_apply`` on the whole set; the experts and
    the combine run on this rank's tokens. Returns (y, aux) or (y, aux,
    diag) with the aux loss and the diagnostics of the whole set, the same
    on every rank; the aux's gradient is this rank's part."""
    xt = x.reshape(-1, x.shape[-1])
    vf = valid.reshape(-1).to(torch.bool) if valid is not None else None
    c = min(_capacity(total, cfg), xt.shape[0])
    route = functools.partial(_route_over_ranks, mesh=mesh, token_axes=tuple(token_axes),
                              flat_index=flat_index.reshape(-1), total=total)
    y, pieces, diag = _moe_local(params, xt, cfg, vf, c=c, route=route,
                                 diagnostics=diagnostics)
    return _reduced_result(y, x.shape, x.dtype, pieces, diag, cfg, mesh, token_axes,
                           diagnostics)


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
