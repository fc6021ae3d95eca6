"""Torch oracles for the ported kernels (port of the matching half of
``repro/kernels/ref.py``): deliberately dense and straightforward, the
correctness contracts the kernels and their plain versions are held to.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def paged_decode_ref(q, k_pool, v_pool, page_table, lengths):
    """Paged decode attention, head-folded-into-batch (paper Appendix B).

    q: [N, hd] one query per stream; k_pool, v_pool: [P, page, hd];
    page_table: [N, max_pages] int32; lengths: [N]. Returns [N, hd]."""
    n, hd = q.shape
    _, page, _ = k_pool.shape
    mp = page_table.shape[1]
    tbl = page_table.long()
    k = k_pool[tbl].reshape(n, mp * page, hd)
    v = v_pool[tbl].reshape(n, mp * page, hd)
    pos = torch.arange(mp * page, device=q.device)[None]
    valid = pos < lengths[:, None]
    logits = torch.einsum("nd,nkd->nk", q, k).float() * (hd ** -0.5)
    logits = torch.where(valid, logits, torch.full_like(logits, NEG_INF))
    w = torch.softmax(logits, dim=-1)
    return torch.einsum("nk,nkd->nd", w.to(v.dtype), v)


def paged_decode_selected_ref(q, k_pool, v_pool, page_table, lengths,
                              sel_ids, n_sel):
    """Quest-selected paged decode: like :func:`paged_decode_ref` but only
    the pages listed in ``sel_ids`` [N, K] (logical page indices, the
    first ``n_sel[n]`` valid) contribute; token positions come from the
    logical ids, masked to ``lengths``."""
    n, hd = q.shape
    _, page, _ = k_pool.shape
    kp = sel_ids.shape[1]
    phys = torch.gather(page_table, 1, sel_ids).long()           # [N, K]
    k = k_pool[phys].reshape(n, kp * page, hd)
    v = v_pool[phys].reshape(n, kp * page, hd)
    pos = (sel_ids[:, :, None] * page
           + torch.arange(page, device=q.device)[None, None]).reshape(n, -1)
    page_ok = torch.arange(kp, device=q.device)[None] < n_sel[:, None]
    valid = (pos < lengths[:, None]) & page_ok.repeat_interleave(page, dim=1)
    logits = torch.einsum("nd,nkd->nk", q, k).float() * (hd ** -0.5)
    logits = torch.where(valid, logits, torch.full_like(logits, NEG_INF))
    w = torch.softmax(logits, dim=-1)
    w = torch.where(valid, w, torch.zeros_like(w))
    return torch.einsum("nk,nkd->nd", w.to(v.dtype), v)


def gate_mlp_ref(x, w1, b1, w2, b2):
    """Write-Gate MLP. x: [H, S, F]; w1: [H, F, M]; w2: [H, M, 1].
    Returns g [H, S] in (0, 1), float32. GELU in its tanh form, as
    ``jax.nn.gelu`` computes by default."""
    h = torch.einsum("hsf,hfm->hsm", x, w1) + b1[:, None]
    h = F.gelu(h, approximate="tanh")
    y = torch.einsum("hsm,hmo->hso", h, w2) + b2[:, None]
    return torch.sigmoid(y[..., 0].float())


def gated_flash_ref(q, k, v, g, *, w_local: int, eps: float = 1e-6):
    """Write-gated attention (training form), single head group.

    q, k, v: [N, S, hd]; g: [N, S]. Bias 0 inside the local window,
    log(g + eps) outside it, NEG_INF above the causal diagonal; one
    softmax per query. Returns [N, S, hd]."""
    n, sq, hd = q.shape
    sk = k.shape[1]
    qi = torch.arange(sq, device=q.device)[:, None]
    kj = torch.arange(sk, device=q.device)[None, :]
    causal = qi >= kj
    in_win = causal & (qi - kj < w_local)
    logits = torch.einsum("nqd,nkd->nqk", q, k).float() * (hd ** -0.5)
    logg = torch.log(g.float() + eps)[:, None, :]
    bias = torch.where(in_win[None], torch.zeros_like(logg), logg)
    logits = logits + torch.where(causal[None], bias,
                                  torch.full_like(bias, NEG_INF))
    w = torch.softmax(logits, dim=-1)
    return torch.einsum("nqk,nkd->nqd", w.to(v.dtype), v)


def vertical_slash_ref(q, k, v, kg, vg, gpos, *, w_local: int):
    """Budgeted vertical-slash prefill attention, single head group.

    q, k, v: [N, S, hd]; kg, vg: [N, C, hd] gathered global tokens at
    absolute positions gpos [N, C] (int32; out of range => never
    visible). Query i sees its local window (i - W < j <= i) from k and
    the global tokens with gpos <= i - W, in one softmax."""
    n, s, hd = q.shape
    qi = torch.arange(s, device=q.device)[:, None]
    kj = torch.arange(s, device=q.device)[None, :]
    local_ok = (qi >= kj) & (qi - kj < w_local)
    l1 = torch.einsum("nqd,nkd->nqk", q, k).float() * (hd ** -0.5)
    l1 = torch.where(local_ok[None], l1, torch.full_like(l1, NEG_INF))
    l2 = torch.einsum("nqd,ncd->nqc", q, kg).float() * (hd ** -0.5)
    vis = gpos[:, None, :] <= (torch.arange(s, device=q.device)[None, :, None]
                               - w_local)
    l2 = torch.where(vis, l2, torch.full_like(l2, NEG_INF))
    w = torch.softmax(torch.cat([l1, l2], dim=-1), dim=-1)
    o = torch.einsum("nqk,nkd->nqd", w[..., :s].to(v.dtype), v)
    return o + torch.einsum("nqc,ncd->nqd", w[..., s:].to(vg.dtype), vg)


def rglru_scan_ref(a, b, h0=None):
    """Linear recurrence h_t = a_t * h_{t-1} + b_t. a, b: [B, S, D];
    h0: [B, D] or None (zeros)."""
    h = torch.zeros_like(a[:, 0]) if h0 is None else h0
    hs = []
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1)
