"""Mixture-of-Experts FFN with top-k routing and capacity-bounded,
sort-based dispatch (port of ``repro/models/moe.py``).

Tokens are routed in ``groups``: each group of ``Tg`` tokens gets a
capacity of ``C`` slots per expert (:func:`capacity`), filled in token
order; an entry past its expert's C slots is dropped. So a token's output
depends on the other tokens of its group. In serving that includes every
row of the ragged tick, inactive slots too, as in the reference.

The dispatch is the reference's, step for step: a stable sort of the
``Tg * K`` (token, expert) entries by expert, ``searchsorted`` for each
expert's first and one-past-last entry, a slot = rank within the expert,
and an ``[E, C]`` table of sorted positions clamped to ``Tg * K - 1`` (an
empty slot gathers a real token with weight 0 and ``valid`` false). The
top k is a stable descending sort, so ties go to the lower expert index
as with ``jax.lax.top_k``.

The combine is a gather, not a scatter-add: each token's K entries are
looked up in the ``[E * C]`` table through an inverse map (a dropped entry
points at a zero row) and summed in expert order, so on CUDA the float
adds happen in a fixed order and two calls are bitwise equal. The expert
products are plain ``torch.einsum``: the reference computes them outside
any Pallas kernel. The reference's sharding constraints (``constrain_moe``)
are layout hints to XLA and left out.

On a mesh (``sharding.comm``) the block is expert-parallel. The router is
whole on every rank, and x is the same on every "model" rank, so every
model rank routes alike (outside the model-split region: x and the
routing weights enter the rank's experts through ``copy_to_model``); the
expert products run over the rank's experts
(the plan's "experts") or its block of every expert's FFN width
("width"), the combine reads the rank's slots (zeros for the others),
and one ``reduce_model("moe")`` of ``y`` closes the block. Routing groups
keep the reference's tokens: ``groups`` is the whole batch's count (the
reference's "one per data shard"); when it is a multiple of the ways the
batch rows are split over, a rank routes its share of the groups over
its own rows, else the group spans data ranks (serving's one group over
the tick) and the rank gathers the rows over "data", routes the whole
group and keeps its own rows. Under a gradient that gather's backward
sums the ranks' gradients and keeps the rank's rows, and the group's
load-balance loss, whole on every rank, enters with its gradient divided
by the rows' ways (``comm.shared_term``), so it counts once.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.device import torch_dtype
from repro_torch.models import layers as L
from repro_torch.sharding import comm

Params = Dict[str, torch.Tensor]


def init_moe(gen: torch.Generator, cfg: ModelConfig, device) -> Params:
    """Router ``[D, E]`` (scale 0.02) and the experts' SwiGLU weights
    ``w_gate`` / ``w_up`` ``[E, D, F]`` and ``w_down`` ``[E, F, D]``, drawn
    from ``gen`` on ``device`` in the reference's order and scales."""
    assert cfg.moe is not None
    dt = torch_dtype(cfg.param_dtype)
    d, e, f = cfg.d_model, cfg.moe.n_experts, cfg.moe.expert_d_ff
    return {
        "router": L.dense_init(gen, (d, e), dt, device, scale=0.02),
        "w_gate": L.dense_init(gen, (e, d, f), dt, device),
        "w_up": L.dense_init(gen, (e, d, f), dt, device),
        "w_down": L.dense_init(gen, (e, f, d), dt, device),
    }


def capacity(tokens_per_group: int, n_experts: int, top_k: int,
             factor: float) -> int:
    """Slots per expert and group: ``int(Tg * K / E * factor) + 1``,
    rounded up to a multiple of 4, at least 4."""
    c = int(tokens_per_group * top_k / n_experts * factor) + 1
    return max(4, -(-c // 4) * 4)


class Route(NamedTuple):
    probs: torch.Tensor      # [G, Tg, E] f32 softmax of the router logits
    top_idx: torch.Tensor    # [G, Tg, K] int64, descending probability
    top_w: torch.Tensor      # [G, Tg, K] f32, renormalised to sum 1


def route(p: Params, cfg: ModelConfig, xf: torch.Tensor) -> Route:
    """xf: [G, Tg, D]. Router logits in ``xf``'s dtype, softmax in f32,
    the top k by a stable descending sort (ties: lower expert first),
    weights renormalised by ``max(sum, 1e-9)``."""
    logits = xf @ p["router"].to(xf.dtype)
    probs = torch.softmax(logits.float(), dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = cfg.moe.top_k
    top_w, top_idx = vals[..., :k], idx[..., :k]
    top_w = top_w / top_w.sum(-1, keepdim=True).clamp_min(1e-9)
    return Route(probs, top_idx, top_w)


def routing_margin(probs: torch.Tensor, top_k: int) -> float:
    """The smallest gap between the k-th and (k+1)-th probability over
    all tokens (``inf`` when every expert is chosen). Two computations of
    ``probs`` that differ by less than half of it choose the same experts
    for every token; a near-tie can flip one expert between two devices'
    float sums (the spirit of ``core/admission.py::check_tau_margin``)."""
    if top_k >= probs.shape[-1]:
        return float("inf")
    vals = torch.sort(probs.detach().float(), dim=-1, descending=True).values
    return float((vals[..., top_k - 1] - vals[..., top_k]).min())


class Dispatch(NamedTuple):
    x_ec: torch.Tensor       # [G, E, C, D] tokens in their expert slots
    tok_ec: torch.Tensor     # [G, E, C] int64 token of each slot (clamped)
    w_ec: torch.Tensor       # [G, E, C] f32 routing weight (0 if empty)
    valid_ec: torch.Tensor   # [G, E, C] bool: the slot holds an entry
    load: torch.Tensor       # [G, E] f32 entries kept per expert
    slot_tk: torch.Tensor    # [G, Tg, K] int64 flat slot e * C + c of each
    #                          token's entries in expert order; E * C for a
    #                          dropped entry (the combine's zero row)


def dispatch(xf: torch.Tensor, r: Route, cap: int, n_experts: int,
             held: Tuple[int, int] = (0, -1)) -> Dispatch:
    """The reference's ``_dispatch_one_group`` over every group at once,
    plus the inverse map the combine reads. ``held``: (first, count)
    of the experts whose slots ``x_ec`` holds (default all; the other
    fields always cover every expert)."""
    g, t, k = r.top_idx.shape
    tk, e = t * k, n_experts
    dev = xf.device
    flat_e = r.top_idx.reshape(g, tk)
    flat_w = r.top_w.reshape(g, tk)
    flat_tok = torch.arange(t, device=dev).repeat_interleave(k)     # [TK]
    se, order = torch.sort(flat_e, dim=-1, stable=True)
    stok = flat_tok[order]                                          # [G, TK]
    sw = torch.gather(flat_w, 1, order)
    experts = torch.arange(e, device=dev).expand(g, e).contiguous()
    start = torch.searchsorted(se, experts, side="left")            # [G, E]
    end = torch.searchsorted(se, experts, side="right")
    slots = torch.arange(cap, device=dev)
    pos_ec = start[:, :, None] + slots                              # [G, E, C]
    valid_ec = pos_ec < end[:, :, None]
    pos_ec = pos_ec.clamp(max=tk - 1).reshape(g, e * cap)
    tok_ec = torch.gather(stok, 1, pos_ec).reshape(g, e, cap)
    w_ec = torch.where(valid_ec,
                       torch.gather(sw, 1, pos_ec).reshape(g, e, cap),
                       torch.zeros((), dtype=sw.dtype, device=dev))
    rows = torch.arange(g, device=dev)[:, None, None]
    e0, ne = held[0], (e if held[1] < 0 else held[1])
    x_ec = (xf[rows, tok_ec[:, e0:e0 + ne]]
            * valid_ec[:, e0:e0 + ne, :, None].to(xf.dtype))
    load = (end - start).clamp(max=cap).float()
    # inverse map: entry i of the unsorted list sits at sorted position
    # rank[i]; its slot is that rank within its expert
    rank = torch.empty_like(order).scatter_(
        1, order, torch.arange(tk, device=dev).expand(g, tk).contiguous())
    slot = rank - torch.gather(start, 1, flat_e)
    flat_slot = torch.where(slot < cap, flat_e * cap + slot,
                            torch.full_like(slot, e * cap))
    slot_tk = torch.sort(flat_slot.reshape(g, t, k), dim=-1).values
    return Dispatch(x_ec, tok_ec, w_ec, valid_ec, load, slot_tk)


def spans_rows(cfg: ModelConfig, groups: int, rows_n: int) -> bool:
    """Whether ``cfg``'s MoE blocks route ``groups`` groups (the whole
    batch's count) that span the ``rows_n`` ranks its rows are split
    over: :func:`moe_ffn` then gathers every rank's rows, so every rank
    must run each position its peers run. False without MoE blocks."""
    return "attn_moe" in cfg.block_pattern + cfg.stem_pattern and \
        groups % rows_n != 0


def moe_ffn(p: Params, cfg: ModelConfig, x: torch.Tensor, *,
            groups: int = 1) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: [B, S, D] -> (y [B, S, D], {"lb_loss", "router_drop_frac"}).
    The ``B * S`` tokens form ``groups`` groups of consecutive tokens
    (row-major), each routed with its own capacity. On a mesh (module
    note) ``x`` holds the rank's rows and ``groups`` counts the whole
    batch's groups; the aux values are the whole routing's (a rank's own
    groups' averaged over the rows' axes)."""
    mc = cfg.moe
    e, k = mc.n_experts, mc.top_k
    _, rows_i, rows_n = comm.rows_block()
    own = None
    if spans_rows(cfg, groups, rows_n):
        # route every rank's rows, keep ours
        own = slice(rows_i * x.shape[0], (rows_i + 1) * x.shape[0])
        x = comm.gather_moe_rows(x)
    else:
        groups //= rows_n
    b, s, d = x.shape
    tot = b * s
    if tot % groups:
        raise ValueError(f"{tot} tokens do not split into {groups} groups")
    tg = tot // groups
    cap = capacity(tg, e, k, mc.capacity_factor)
    xf = x.reshape(groups, tg, d)
    # routing is whole and alike on every "model" rank; the rank's
    # experts take x and the routing weights through ``copy_to_model``,
    # so the gradients of both sum the ranks' parts while the router's
    # and the load-balance loss's stay whole
    r = route(p, cfg, xf)
    r = r._replace(top_w=comm.copy_to_model(r.top_w, "moe"))
    plan = comm.ACTIVE.plan if comm.ACTIVE is not None else None
    e0, ne = plan.experts if plan is not None and plan.n_experts else (0, e)
    dp = dispatch(comm.copy_to_model(xf, "moe"), r, cap, e, (e0, ne))
    # Switch-style load-balance aux loss (before the experts: a
    # rematerialized block's recompute then stops at the combine, short
    # of the collectives below)
    frac_tokens = dp.load / dp.load.sum(-1, keepdim=True).clamp_min(1.0)
    mean_prob = r.probs.mean(dim=1)
    lb = e * (frac_tokens * mean_prob).sum(-1).mean()
    dropped = 1.0 - dp.load.sum() / (groups * tg * k)
    dt = x.dtype
    h = torch.einsum("gecd,edf->gecf", dp.x_ec, p["w_gate"].to(dt))
    u = torch.einsum("gecd,edf->gecf", dp.x_ec, p["w_up"].to(dt))
    yo = torch.einsum("gecf,efd->gecd", F.silu(h) * u, p["w_down"].to(dt))
    mine = slice(e0, e0 + ne)
    yo = yo * (dp.w_ec[:, mine] * dp.valid_ec[:, mine])[..., None].to(
        yo.dtype)
    # combine: each token's entries gathered from the slot table of this
    # rank's experts (plus a zero row for dropped entries and the other
    # ranks' experts) and summed in expert order
    table = torch.cat([yo.reshape(groups, ne * cap, d),
                       yo.new_zeros((groups, 1, d))], dim=1)
    slot = dp.slot_tk - e0 * cap
    slot = torch.where((slot >= 0) & (slot < ne * cap), slot,
                       torch.full_like(slot, ne * cap))
    rows = torch.arange(groups, device=x.device)[:, None, None]
    y = table[rows, slot].sum(dim=2).reshape(b, s, d)
    if own is not None:
        # the group's terms are whole and alike on every rank: they count
        # once in the gradients summed over the rows' ranks
        y = y[own]
        lb = comm.shared_term(lb)
    y = comm.reduce_model(y, "moe")
    if own is None and rows_n > 1:
        lb, dropped = comm.mean_blocks(torch.stack([lb, dropped]),
                                       heads=False).unbind(0)
    return y, {"lb_loss": lb, "router_drop_frac": dropped}
