"""Model-level folds around the kernels (port of ``repro/kernels/ops.py``):
GQA head folding, the write-gate batch fold, the dual cache viewed as two
paged segments, read whole or through the Quest-selected pages of its
global segment, the dense baseline's cache read as one paged segment
(from a start offset when windowed) and its causal prefill through the
write-gated kernel (its hard-window mode when windowed), and the RG-LRU
linear scan.

The GQA fold keeps the reference's stream order ``(b, kv head, group)``
(``q.reshape(b, hkv, g, s, hd)``) but does not repeat K, V, the gates, the
globals, page tables, lengths or selected ids G times: the kernels take
the group size and read kv stream ``n // G`` for query stream n.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.core.selection import PAGE_SIZE
from repro_torch.kernels.gate_mlp import gate_mlp
from repro_torch.kernels.gated_flash import gated_flash, gated_flash_window
from repro_torch.kernels.paged_decode import (paged_decode,
                                              paged_decode_selected)
from repro_torch.kernels.rglru_scan import rglru_scan
from repro_torch.kernels.vertical_slash import vertical_slash


def write_gate(x, w1, b1, w2, b2):
    """Write-Gate MLP over features x [B, H, S, F] with per-head weights
    [H, F, M] / [H, M] / [H, M, 1] / [H, 1] -> g [B, H, S] float32. The
    batch folds into rows; the kernel picks each row's head as
    ``row % H`` instead of tiling the weights over the batch."""
    b, h, s, f = x.shape
    g = gate_mlp(x.reshape(b * h, s, f).contiguous(), w1.contiguous(),
                 b1.contiguous(), w2.contiguous(), b2.contiguous())
    return g.reshape(b, h, s)


def gated_flash_attention(q, k, v, g, *, w_local: int, eps: float):
    """Model-level write-gated attention. q: [B, Hq, S, hd]; k, v:
    [B, Hkv, S, hd]; g: [B, Hkv, S] float32 -> [B, Hq, S, hd]."""
    b, hq, s, hd = q.shape
    hkv = k.shape[1]
    of = gated_flash(q.reshape(b * hq, s, hd).contiguous(),
                     k.reshape(b * hkv, s, hd).contiguous(),
                     v.reshape(b * hkv, s, hd).contiguous(),
                     g.reshape(b * hkv, s).contiguous(),
                     w_local=w_local, eps=eps, group=hq // hkv)
    return of.reshape(b, hq, s, hd)


def vertical_slash_attention(q, k, v, kg, vg, gpos, *, w_local: int):
    """Budgeted vertical-slash prefill. q: [B, Hq, S, hd]; k, v:
    [B, Hkv, S, hd]; kg, vg: [B, Hkv, C, hd]; gpos: [B, Hkv, C] int32
    -> [B, Hq, S, hd]."""
    b, hq, s, hd = q.shape
    hkv, c = kg.shape[1], kg.shape[2]
    of = vertical_slash(q.reshape(b * hq, s, hd).contiguous(),
                        k.reshape(b * hkv, s, hd).contiguous(),
                        v.reshape(b * hkv, s, hd).contiguous(),
                        kg.reshape(b * hkv, c, hd).contiguous(),
                        vg.reshape(b * hkv, c, hd).contiguous(),
                        gpos.reshape(b * hkv, c).contiguous(),
                        w_local=w_local, group=hq // hkv)
    return of.reshape(b, hq, s, hd)


def paged_decode_attention(q, k_pool, v_pool, page_table, lengths):
    """Head-folded paged decode (paper Appendix B). q: [B, Hq, hd]; pools
    [P, page, hd]; page_table: [B, Hkv, max_pages]; lengths: [B, Hkv]
    -> [B, Hq, hd]."""
    b, hq, hd = q.shape
    hkv, mp = page_table.shape[1], page_table.shape[2]
    of = paged_decode(q.reshape(b * hq, hd).contiguous(), k_pool, v_pool,
                      page_table.reshape(b * hkv, mp).contiguous(),
                      lengths.reshape(b * hkv).contiguous(), group=hq // hkv)
    return of.reshape(b, hq, hd)


@functools.lru_cache(maxsize=64)
def _identity_tables(streams: int, pages: int,
                     device: torch.device) -> torch.Tensor:
    """Page table of a contiguous [streams, pages * 16, hd] buffer viewed
    as a pool: stream s owns pages s * pages ... s * pages + pages - 1."""
    base = torch.arange(streams, dtype=torch.int32, device=device)[:, None]
    tbl = base * pages + torch.arange(pages, dtype=torch.int32,
                                      device=device)[None]
    return tbl.contiguous()


def dual_cache_segments(q, cache, block=None):
    """The paged-decode arguments of a DualCache read, viewed in place:
    (q [B*Hq, hd], global segment, local-ring segment, group), each
    segment a (k_pool, v_pool, page_table, lengths) tuple per kv stream
    (B*Hkv rows) and ``group`` = Hq / Hkv. The global segment holds
    ``gcnt`` tokens per head; the valid ring slots are exactly the first
    ``min(t, W)`` (the ring is written at ``ptr``, which starts at 0 and
    advances with ``t``).

    A global budget off the page grid (a fraction of the capacity, such
    as 0.4 x 512 = 204) is read through a copy padded to whole pages:
    ``gcnt <= C`` keeps the padding unread. The ring must be
    page-aligned.

    ``block`` (i, n): the cache's global token axis is split over n
    ranks and this one holds block i of it (context-parallel decode):
    the global segment is this rank's ``C / n`` slots, holding
    ``clamp(gcnt - i C / n, 0, C / n)`` tokens, and only block 0 reads
    the ring (the others read it with length 0)."""
    b, hq, hd = q.shape
    _, hkv, c, _ = cache.gk.shape
    w = cache.lk.shape[2]
    if w % PAGE_SIZE:
        raise ValueError(f"dual-cache read needs a page-aligned ring, "
                         f"W={w} (a multiple of {PAGE_SIZE})")
    gk, gv = cache.gk, cache.gv
    if c % PAGE_SIZE:
        pad = -c % PAGE_SIZE
        gk = torch.nn.functional.pad(gk, (0, 0, 0, pad))
        gv = torch.nn.functional.pad(gv, (0, 0, 0, pad))
        c += pad
    s = b * hkv
    glen = cache.gcnt.reshape(s)
    llen = torch.clamp(cache.t, max=w).to(torch.int32)[:, None] \
        .expand(b, hkv).reshape(s)
    if block is not None:
        i, _ = block
        cb = cache.gk.shape[2]
        glen = torch.clamp(glen - i * cb, 0, cb).to(torch.int32)
        if i:
            llen = torch.zeros_like(llen)
    first = (gk.reshape(s * c // PAGE_SIZE, PAGE_SIZE, hd),
             gv.reshape(s * c // PAGE_SIZE, PAGE_SIZE, hd),
             _identity_tables(s, c // PAGE_SIZE, q.device),
             glen.contiguous())
    second = (cache.lk.reshape(s * w // PAGE_SIZE, PAGE_SIZE, hd),
              cache.lv.reshape(s * w // PAGE_SIZE, PAGE_SIZE, hd),
              _identity_tables(s, w // PAGE_SIZE, q.device),
              llen.contiguous())
    return q.reshape(b * hq, hd).contiguous(), first, second, hq // hkv


def dual_cache_attention(q, cache, block=None):
    """One query per head over a DualCache's [admitted global ‖ local
    ring], read in place by the paged-decode kernel as two segments.
    q: [B, Hq, hd] -> [B, Hq, hd]. With ``block`` (this rank's block of a
    seq-sharded global axis, :func:`dual_cache_segments`): (out, the
    read's log-sum-exp [B, Hq] f32), for ``sharding.comm.combine_lse``."""
    qf, first, second, g = dual_cache_segments(q, cache, block)
    if block is None:
        return paged_decode(qf, *first, second=second,
                            group=g).reshape(q.shape)
    out, lse = paged_decode(qf, *first, second=second, group=g, lse=True)
    return out.reshape(q.shape), lse.reshape(q.shape[:2])


def dense_cache_segment(q, cache):
    """The paged-decode arguments of a DenseCache read, viewed in place:
    (q [B*Hq, hd], one segment (k_pool, v_pool, page_table, lengths) per
    kv stream, group). The contiguous [B, Hkv, S_max, hd] buffer is
    S_max / 16 pages per kv stream (S_max a multiple of 16;
    ``init_dense_cache`` rounds it up), each stream ``t`` long.
    :func:`dense_window_starts` gives a windowed read's starts."""
    b, hq, hd = q.shape
    _, hkv, s_max, _ = cache.k.shape
    if s_max % PAGE_SIZE:
        raise ValueError(f"dense-cache read needs a page-aligned buffer, "
                         f"got S_max={s_max} (a multiple of {PAGE_SIZE})")
    s = b * hkv
    pages = s_max // PAGE_SIZE
    lens = cache.t.to(torch.int32)[:, None].expand(b, hkv).reshape(s)
    seg = (cache.k.reshape(s * pages, PAGE_SIZE, hd),
           cache.v.reshape(s * pages, PAGE_SIZE, hd),
           _identity_tables(s, pages, q.device), lens.contiguous())
    return q.reshape(b * hq, hd).contiguous(), seg, hq // hkv


def dense_window_starts(t, hkv: int, window: int):
    """Per kv stream [B * Hkv] int32, the first token of a windowed read
    of rows at position ``t`` [B]: ``max(t - window, 0)``."""
    first = torch.clamp(t.to(torch.int32) - window, min=0)
    return first[:, None].expand(t.shape[0], hkv).reshape(-1).contiguous()


def dense_cache_attention(q, cache, window=None, end=None, block=None):
    """One query per head over a DenseCache's first ``t`` tokens, read in
    place by the paged-decode kernel as ONE segment; with ``window`` only
    the last ``window`` of them, [t - window, t), through the kernel's
    start offset. ``end`` [B] (default ``t``): the read stops there, the
    window still ends at ``t``. q: [B, Hq, hd] -> [B, Hq, hd].

    ``block`` (i, n): the buffer's token axis is split over n ranks and
    ``cache.k`` / ``cache.v`` are this rank's block i of it, tokens
    [i S, (i + 1) S) for a block of S slots (context-parallel decode;
    ``t`` stays global). The read's length and window start are clipped
    to the block, so a block that holds none of a row's keys reads
    nothing; returns (out, the read's log-sum-exp [B, Hq] f32), for
    ``sharding.comm.combine_lse``.

    With ``window`` and ``end`` (the ragged scan's buffer limit, at most
    ``t``), a row whose window lies wholly at or past ``end`` reads what
    the reference's softmax over no valid key gives: the mean of V over
    its first ``end`` entries (:func:`_empty_window_mean`; on a block its
    share, weighted by count in the combine)."""
    empty = None
    if window is not None and end is not None:
        # a row whose window lies wholly at or past ``end`` reads no key
        empty = torch.clamp(cache.t.to(torch.int32) - window, min=0) >= \
            end.to(torch.int32)
    limit = end
    end = cache.t if end is None else end
    starts = None
    if block is not None:
        cb = cache.k.shape[2]
        off = block[0] * cb
        if window is not None:
            starts = torch.clamp(torch.clamp(cache.t.to(torch.int32)
                                             - window, min=0) - off, 0, cb)
            starts = starts.to(torch.int32)[:, None].expand(
                cache.t.shape[0], cache.k.shape[1]).reshape(-1).contiguous()
        end = torch.clamp(end.to(torch.int32) - off, 0, cb).to(torch.int32)
    elif window is not None:
        starts = dense_window_starts(cache.t, cache.k.shape[1], window)
    qf, seg, g = dense_cache_segment(q, cache._replace(t=end))
    kw = {} if window is None else {"starts": starts, "span": window}
    if block is None:
        out = paged_decode(qf, *seg, group=g, **kw).reshape(q.shape)
        if empty is None:
            return out
        return _empty_window_mean(out, None, cache, limit, empty, g)
    out, lse = paged_decode(qf, *seg, group=g, lse=True, **kw)
    out, lse = out.reshape(q.shape), lse.reshape(q.shape[:2])
    if empty is None:
        return out, lse
    return _empty_window_mean(out, lse, cache, end, empty, g)


def _empty_window_mean(out, lse, cache, n, empty, group):
    """The reference's read of a row whose window holds no key (its
    softmax over all-masked scores weighs every entry alike): the mean
    of V over the row's first ``n`` [B] buffer entries (the buffer of
    ``limit`` entries; on a block, the block's share of it, with the lse
    of ``n`` equal scores of 0, ``log n``, so the blocks' combine weighs
    each block's mean by its count) in place of the kernel's empty read,
    for the rows ``empty`` [B]. No host sync: every row's mean is
    computed and ``empty`` selects."""
    b, hkv, s_max, _ = cache.v.shape
    n = torch.clamp(n.to(torch.int64), 0, s_max)
    keep = (torch.arange(s_max, device=out.device)[None] < n[:, None])
    vsum = torch.einsum("bs,bhsd->bhd", keep.to(torch.float32),
                        cache.v.float())
    mean = (vsum / torch.clamp(n, min=1).to(torch.float32)[:, None, None])
    mean = mean.repeat_interleave(group, dim=1).to(out.dtype)
    out = torch.where(empty[:, None, None], mean, out)
    if lse is None:
        return out
    lse_n = torch.where(n > 0, torch.log(n.to(torch.float32)),
                        torch.full_like(n, 0, dtype=torch.float32)
                        - float("inf"))
    return out, torch.where(empty[:, None], lse_n[:, None].expand_as(lse),
                            lse)


def windowed_causal_attention(q, k, v, window: int):
    """Causal attention over the last ``window`` keys of each query
    (0 <= i - j < window) through the write-gated kernel's hard-window
    mode. q: [B, Hq, S, hd]; k, v: [B, Hkv, S, hd] -> [B, Hq, S, hd]."""
    b, hq, s, hd = q.shape
    hkv = k.shape[1]
    of = gated_flash_window(q.reshape(b * hq, s, hd).contiguous(),
                            k.reshape(b * hkv, s, hd).contiguous(),
                            v.reshape(b * hkv, s, hd).contiguous(),
                            window=window, group=hq // hkv)
    return of.reshape(b, hq, s, hd)


def causal_attention(q, k, v):
    """Plain causal attention through the write-gated kernel: g all ones
    and ``w_local = S`` put every causal key inside the window, where the
    bias is exactly 0, and the kernel skips the key tiles above the
    diagonal. q: [B, Hq, S, hd]; k, v: [B, Hkv, S, hd] -> [B, Hq, S, hd]."""
    b, hkv, s, _ = k.shape
    g = torch.ones((b, hkv, s), dtype=torch.float32, device=q.device)
    return gated_flash_attention(q, k, v, g, w_local=s, eps=1e-6)


def block_page_ids(ids, n_sel, block, pages: int):
    """The selected pages of a global page list that block ``block`` (i,
    n) of a seq-sharded global cache holds, as that block's read takes
    them: ``ids`` [..., K] int32 with the first ``n_sel`` [...] valid, in
    ascending order (or any order that keeps each block's ids together:
    the mask mode's), each block ``pages`` pages wide. Returns (local
    ids [..., min(K, pages)] int32, shifted to the block's first page and
    moved to the front, their count [...] int32). Every rank of the
    block's axis took the same global ids, so together the blocks read
    each selected page once."""
    lo_id = block[0] * pages
    k = ids.shape[-1]
    valid = torch.arange(k, device=ids.device) < n_sel[..., None]
    before = (valid & (ids < lo_id)).sum(-1, keepdim=True)
    mine = (valid & (ids >= lo_id) & (ids < lo_id + pages)).sum(-1)
    kl = min(k, pages)
    at = torch.clamp(torch.arange(kl, device=ids.device) + before, max=k - 1)
    local = torch.clamp(torch.gather(ids, -1, at) - lo_id, 0, pages - 1)
    return local.to(torch.int32), mine.to(torch.int32)


def dual_cache_selected_attention(q, cache, ids, n_sel, block=None):
    """:func:`dual_cache_attention` with Quest read-time selection: the
    global segment is read through only the pages ``ids`` [B, Hkv, K]
    int32 (ascending logical page ids per kv head, the first ``n_sel``
    [B, Hkv] valid), the local ring whole, in one softmax. q: [B, Hq, hd]
    -> [B, Hq, hd]. With ``block`` (this rank's block of a seq-sharded
    global axis, whole pages): the ids are the global selection, the same
    on every rank; the rank reads those its block holds
    (:func:`block_page_ids`; the ring on block 0 only, as
    :func:`dual_cache_segments`) and returns (out, the read's
    log-sum-exp [B, Hq] f32)."""
    qf, first, second, g = dual_cache_segments(q, cache, block)
    if block is not None:
        ids, n_sel = block_page_ids(ids, n_sel, block,
                                    cache.gk.shape[2] // PAGE_SIZE)
    b, hkv, k = ids.shape
    args = (qf, *first, ids.reshape(b * hkv, k).contiguous(),
            n_sel.reshape(b * hkv).contiguous())
    if block is None:
        return paged_decode_selected(*args, second=second,
                                     group=g).reshape(q.shape)
    out, lse = paged_decode_selected(*args, second=second, group=g,
                                     lse=True)
    return out.reshape(q.shape), lse.reshape(q.shape[:2])


def rglru_linear_scan(a, b):
    """[B, S, D] linear recurrence ``h_t = a_t * h_{t-1} + b_t`` from zero.
    The kernel tiles itself, so the reference's ``bt``/``bd`` have no
    counterpart."""
    return rglru_scan(a.contiguous(), b.contiguous())
