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


def gate_mlp_ref(x, w1, b1, w2, b2):
    """Write-Gate MLP. x: [H, S, F]; w1: [H, F, M]; w2: [H, M, 1].
    Returns g [H, S] in (0, 1), float32. GELU in its tanh form, as
    ``jax.nn.gelu`` computes by default."""
    h = torch.einsum("hsf,hfm->hsm", x, w1) + b1[:, None]
    h = F.gelu(h, approximate="tanh")
    y = torch.einsum("hsm,hmo->hso", h, w2) + b2[:, None]
    return torch.sigmoid(y[..., 0].float())
