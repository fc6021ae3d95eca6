"""Quest-style read-time KV Selection (port of
``repro/core/selection.py``, paper §5.4).

Page metadata: ``pkmin``/``pkmax`` are DualCache leaves, maintained
incrementally on every promotion (``update_page_meta_on_write``) and
rebuilt from scratch only by eviction and prefill
(``build_page_meta``). Scoring: ``page_upper_bound`` bounds each page's
attention score for the live query from its key min/max.

Two consumption modes, as in the reference:

  * **mask** (``select_pages``): the top pages per kv head, ties at the
    threshold included. The port reads them through the same kernel as
    gather mode, listed ascending (``page_ids_from_mask``).
  * **gather** (``topk_page_ids``): exactly K page ids per kv head,
    sorted ascending, and the count of valid ones. The decode read walks
    only those pages (``kernels/paged_decode.py::paged_decode_selected``).

The reference picks pages with ``lax.top_k``, which keeps the lower index
first among equal scores; the port takes the first K of a STABLE
descending sort, which breaks ties the same way (as
``core/admission.py::select_global`` does).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

PAGE_SIZE = 16

# Sentinel filling empty page-metadata lanes: pkmin=+META_BIG,
# pkmax=-META_BIG. Any real key strictly shrinks the interval, so the
# incremental update needs no "page initialized" flag. Fits bfloat16.
META_BIG = 3e38


class PageMeta(NamedTuple):
    kmin: torch.Tensor   # [B, H, P, hd]
    kmax: torch.Tensor   # [B, H, P, hd]
    valid: torch.Tensor  # [B, H, P] page has >= 1 valid token


def n_pages(n_tokens: int, page_size: int = PAGE_SIZE) -> int:
    """Number of metadata pages covering ``n_tokens`` slots (ceil)."""
    return -(-n_tokens // page_size)


def init_page_meta(batch: int, n_kv_heads: int, n_tokens: int,
                   head_dim: int, *, page_size: int = PAGE_SIZE,
                   dtype=torch.float32, device=None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Empty (pkmin, pkmax) leaves for a cache of ``n_tokens`` slots."""
    shape = (batch, n_kv_heads, n_pages(n_tokens, page_size), head_dim)
    return (torch.full(shape, META_BIG, dtype=dtype, device=device),
            torch.full(shape, -META_BIG, dtype=dtype, device=device))


def build_page_meta(k: torch.Tensor, valid: torch.Tensor,
                    page_size: int = PAGE_SIZE) -> PageMeta:
    """k: [B, H, S, hd]; valid: [B, H, S] -> page metadata. A ragged tail
    (S % page != 0) is padded internally with invalid lanes."""
    b, h, s, d = k.shape
    pad = (-s) % page_size
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, pad))
        valid = torch.nn.functional.pad(valid, (0, pad))
    p = (s + pad) // page_size
    kp = k.reshape(b, h, p, page_size, d)
    vp = valid.reshape(b, h, p, page_size)
    big = torch.full((), META_BIG, dtype=k.dtype, device=k.device)
    kmin = torch.where(vp[..., None], kp, big).amin(dim=3)
    kmax = torch.where(vp[..., None], kp, -big).amax(dim=3)
    return PageMeta(kmin, kmax, vp.any(dim=3))


def page_valid_from_count(count: torch.Tensor, p: int,
                          page_size: int = PAGE_SIZE) -> torch.Tensor:
    """Contiguous-cache page validity: page i holds >= 1 valid token iff
    its first slot index is < count. count: [B, H] -> [B, H, P] bool."""
    first = torch.arange(p, dtype=count.dtype, device=count.device) * page_size
    return first[None, None] < count[..., None]


def update_page_meta_on_write(
    pkmin: torch.Tensor,      # [B, H, P, hd]
    pkmax: torch.Tensor,
    dest: torch.Tensor,       # [B, H] slot the appended entry lands in
    k_new: torch.Tensor,      # [B, H, hd] the appended key
    can_write: torch.Tensor,  # [B, H] bool: append actually happens
    *,
    page_size: int = PAGE_SIZE,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold one new key into the single page it touches (functional: the
    inputs are left untouched). A write at a page boundary starts the
    page fresh from the sentinel."""
    b, h = dest.shape
    pg = (dest // page_size).long()
    fresh = (dest % page_size) == 0
    bi = torch.arange(b, device=dest.device)[:, None].expand(b, h)
    hi = torch.arange(h, device=dest.device)[None, :].expand(b, h)
    old_lo = pkmin[bi, hi, pg]
    old_hi = pkmax[bi, hi, pg]
    big = torch.full((), META_BIG, dtype=pkmin.dtype, device=pkmin.device)
    base_lo = torch.where(fresh[..., None], big, old_lo)
    base_hi = torch.where(fresh[..., None], -big, old_hi)
    kn = k_new.to(pkmin.dtype)
    lo = torch.where(can_write[..., None], torch.minimum(base_lo, kn), old_lo)
    hi_ = torch.where(can_write[..., None], torch.maximum(base_hi, kn), old_hi)
    new_min, new_max = pkmin.clone(), pkmax.clone()
    new_min[bi, hi, pg] = lo
    new_max[bi, hi, pg] = hi_
    return new_min, new_max


def page_upper_bound(q: torch.Tensor, meta: PageMeta) -> torch.Tensor:
    """q: [B, Hq, hd] (Hq = G * Hkv); meta per kv head. Returns ub scores
    averaged over the query group, -inf on invalid pages: [B, Hkv, P]."""
    b, hq, d = q.shape
    hkv = meta.kmin.shape[1]
    g = hq // hkv
    qg = q.reshape(b, hkv, g, d)
    lo = torch.einsum("bhgd,bhpd->bhgp", qg, meta.kmin.to(q.dtype))
    hi = torch.einsum("bhgd,bhpd->bhgp", qg, meta.kmax.to(q.dtype))
    ub = torch.maximum(lo, hi).sum(dim=2) / g
    return torch.where(meta.valid, ub, torch.full_like(ub, float("-inf")))


def _top_k(ub: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` over the last axis: the k largest, lower index first
    among equal scores."""
    scores, idx = torch.sort(ub, dim=-1, descending=True, stable=True)
    return scores[..., :k], idx[..., :k]


def select_pages(q: torch.Tensor, meta: PageMeta,
                 budget_pages: int) -> torch.Tensor:
    """Top-``budget_pages`` page mask per kv head (ties at the threshold
    included, invalid pages never): [B, Hkv, P] bool."""
    ub = page_upper_bound(q, meta)
    k = min(budget_pages, ub.shape[-1])
    thresh = _top_k(ub, k)[0][..., -1:]
    return (ub >= thresh) & torch.isfinite(ub)


def token_mask_from_pages(page_mask: torch.Tensor,
                          page_size: int = PAGE_SIZE) -> torch.Tensor:
    """[B, H, P] -> [B, H, P*page_size]."""
    return torch.repeat_interleave(page_mask, page_size, dim=-1)


def topk_page_ids(q: torch.Tensor, meta: PageMeta, budget_pages: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-``budget_pages`` page ids per kv head, sorted ascending:
    (ids [B, Hkv, K] int32, n_selected [B, Hkv] int32 — the selected
    pages with a finite bound, i.e. valid pages).

    Ascending order puts the valid pages first (an invalid page scores
    -inf, so it is selected only once every valid page is), and when K
    covers every page the list is the identity permutation: the decode
    read then walks the same pages in the same order as the full read."""
    ub = page_upper_bound(q, meta)
    k = min(budget_pages, ub.shape[-1])
    scores, idx = _top_k(ub, k)
    n_sel = torch.isfinite(scores).sum(dim=-1).to(torch.int32)
    return torch.sort(idx, dim=-1).values.to(torch.int32), n_sel


def page_ids_from_mask(page_mask: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A page mask [B, H, P] as the selected read's arguments: (ids
    [B, H, P] int32 with the selected pages first, ascending, then the
    rest; n_selected [B, H] int32)."""
    order = torch.argsort((~page_mask).to(torch.int8), dim=-1, stable=True)
    return order.to(torch.int32), page_mask.sum(dim=-1).to(torch.int32)


def gather_pages(gk: torch.Tensor, gv: torch.Tensor, gcnt: torch.Tensor,
                 page_ids: torch.Tensor, *, page_size: int = PAGE_SIZE
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Materialize only the selected pages' K/V rows.

    gk/gv: [B, H, C, hd] contiguous cache; gcnt: [B, H] valid counts;
    page_ids: [B, H, K] (sorted). Returns (k [B, H, K*page, hd], v,
    valid [B, H, K*page]). The port's decode read does not call it (the
    kernel walks the pages in place); it is the dense statement of what
    that read sees."""
    b, h, c, d = gk.shape
    tok = (page_ids[..., None] * page_size
           + torch.arange(page_size, dtype=page_ids.dtype,
                          device=page_ids.device)[None, None, None])
    tok = tok.reshape(b, h, -1)
    valid = tok < gcnt[..., None]
    tokc = torch.clamp(tok, max=c - 1).long()[..., None].expand(b, h, -1, d)
    return (torch.gather(gk, 2, tokc), torch.gather(gv, 2, tokc), valid)
