"""Quest page metadata over the global cache (port of the page-metadata
half of ``repro/core/selection.py``).

``pkmin``/``pkmax`` are DualCache leaves, maintained incrementally on
every promotion. The scoring half (``page_upper_bound``,
``topk_page_ids``, ``gather_pages``) arrives with decode selection.
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
    big = torch.tensor(META_BIG, dtype=k.dtype, device=k.device)
    kmin = torch.where(vp[..., None], kp, big).amin(dim=3)
    kmax = torch.where(vp[..., None], kp, -big).amax(dim=3)
    return PageMeta(kmin, kmax, vp.any(dim=3))


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
    big = torch.tensor(META_BIG, dtype=pkmin.dtype, device=pkmin.device)
    base_lo = torch.where(fresh[..., None], big, old_lo)
    base_hi = torch.where(fresh[..., None], -big, old_hi)
    kn = k_new.to(pkmin.dtype)
    lo = torch.where(can_write[..., None], torch.minimum(base_lo, kn), old_lo)
    hi_ = torch.where(can_write[..., None], torch.maximum(base_hi, kn), old_hi)
    new_min, new_max = pkmin.clone(), pkmax.clone()
    new_min[bi, hi, pg] = lo
    new_max[bi, hi, pg] = hi_
    return new_min, new_max
