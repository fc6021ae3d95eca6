"""Model-level folds around the kernels (port of the matching half of
``repro/kernels/ops.py``): GQA head folding, the write-gate batch fold,
and the dual cache viewed as two paged segments.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.core.selection import PAGE_SIZE
from repro_torch.kernels.gate_mlp import gate_mlp
from repro_torch.kernels.paged_decode import paged_decode


def write_gate(x, w1, b1, w2, b2):
    """Write-Gate MLP over features x [B, H, S, F] with per-head weights
    [H, F, M] / [H, M] / [H, M, 1] / [H, 1] -> g [B, H, S] float32. The
    batch folds into rows; the kernel picks each row's head as
    ``row % H`` instead of tiling the weights over the batch."""
    b, h, s, f = x.shape
    g = gate_mlp(x.reshape(b * h, s, f).contiguous(), w1.contiguous(),
                 b1.contiguous(), w2.contiguous(), b2.contiguous())
    return g.reshape(b, h, s)


def paged_decode_attention(q, k_pool, v_pool, page_table, lengths):
    """Head-folded paged decode (paper Appendix B). q: [B, Hq, hd]; pools
    [P, page, hd]; page_table: [B, Hkv, max_pages]; lengths: [B, Hkv]
    -> [B, Hq, hd]."""
    b, hq, hd = q.shape
    hkv, mp = page_table.shape[1], page_table.shape[2]
    g = hq // hkv
    tf = page_table.reshape(b * hkv, mp).repeat_interleave(g, dim=0)
    lf = lengths.reshape(b * hkv).repeat_interleave(g, dim=0)
    of = paged_decode(q.reshape(b * hq, hd).contiguous(), k_pool, v_pool,
                      tf.contiguous(), lf.contiguous())
    return of.reshape(b, hq, hd)


@functools.lru_cache(maxsize=64)
def _identity_tables(streams: int, pages: int, group: int,
                     device: torch.device) -> torch.Tensor:
    """Page table of a contiguous [streams, pages * 16, hd] buffer viewed
    as a pool: stream s owns pages s * pages ... s * pages + pages - 1.
    Each stream's row is repeated ``group`` times (GQA fold)."""
    base = torch.arange(streams, dtype=torch.int32, device=device)[:, None]
    tbl = base * pages + torch.arange(pages, dtype=torch.int32,
                                      device=device)[None]
    return tbl.repeat_interleave(group, dim=0).contiguous()


def dual_cache_segments(q, cache):
    """The paged-decode arguments of a DualCache read, viewed in place:
    (q [B*Hq, hd], global segment, local-ring segment), each segment a
    (k_pool, v_pool, page_table, lengths) tuple. The global segment holds
    ``gcnt`` tokens per head; the valid ring slots are exactly the first
    ``min(t, W)`` (the ring is written at ``ptr``, which starts at 0 and
    advances with ``t``)."""
    b, hq, hd = q.shape
    _, hkv, c, _ = cache.gk.shape
    w = cache.lk.shape[2]
    if c % PAGE_SIZE or w % PAGE_SIZE:
        raise ValueError(f"dual-cache read needs page-aligned C={c} and "
                         f"W={w} (multiples of {PAGE_SIZE})")
    g = hq // hkv
    s = b * hkv
    glen = cache.gcnt.reshape(s).repeat_interleave(g)
    llen = torch.clamp(cache.t, max=w).to(torch.int32)[:, None] \
        .expand(b, hkv).reshape(s).repeat_interleave(g)
    first = (cache.gk.reshape(s * c // PAGE_SIZE, PAGE_SIZE, hd),
             cache.gv.reshape(s * c // PAGE_SIZE, PAGE_SIZE, hd),
             _identity_tables(s, c // PAGE_SIZE, g, q.device),
             glen.contiguous())
    second = (cache.lk.reshape(s * w // PAGE_SIZE, PAGE_SIZE, hd),
              cache.lv.reshape(s * w // PAGE_SIZE, PAGE_SIZE, hd),
              _identity_tables(s, w // PAGE_SIZE, g, q.device),
              llen.contiguous())
    return q.reshape(b * hq, hd).contiguous(), first, second


def dual_cache_attention(q, cache):
    """One query per head over a DualCache's [admitted global ‖ local
    ring], read in place by the paged-decode kernel as two segments.
    q: [B, Hq, hd] -> [B, Hq, hd]."""
    qf, first, second = dual_cache_segments(q, cache)
    return paged_decode(qf, *first, second=second).reshape(q.shape)
