"""Dual cache (local ring + budgeted global) with lazy promotion (port of
``repro/core/dual_cache.py``, paper §4).

The updates are functional, like the reference's: ``lazy_promote_and_write``
returns a new :class:`DualCache` and leaves its input untouched, so a
caller may keep the pre-step tree (the serving engine's paged mirror
diffs before/after trees; the ragged extend selects old leaves for
length-0 rows bit for bit).

Integer state (``lpos``, ``gpos``, ``gcnt``, ``t``, ``ptr``, ``overflow``)
stays int32 as in the reference and is cast to int64 only to index.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.core.selection import init_page_meta, update_page_meta_on_write


class DualCache(NamedTuple):
    lk: torch.Tensor        # [B, H, W, hd] local keys (post-RoPE)
    lv: torch.Tensor        # [B, H, W, hd]
    lg: torch.Tensor        # [B, H, W]    gate score of local entries
    lpos: torch.Tensor      # [B, W] int32 absolute positions (-1 = empty)
    gk: torch.Tensor        # [B, H, C, hd]
    gv: torch.Tensor        # [B, H, C, hd]
    gpos: torch.Tensor      # [B, H, C] int32
    gcnt: torch.Tensor      # [B, H] int32 valid entries in global cache
    t: torch.Tensor         # [B] int32 next absolute position
    ptr: torch.Tensor       # [B] int32 ring pointer (next victim slot)
    overflow: torch.Tensor  # [B, H] int32 promotions dropped for budget
    pkmin: torch.Tensor     # [B, H, P, hd] Quest page metadata
    pkmax: torch.Tensor     # [B, H, P, hd]

    @property
    def w_local(self) -> int:
        return self.lk.shape[-2]

    @property
    def budget(self) -> int:
        return self.gk.shape[-2]


def init_dual_cache(batch: int, n_kv_heads: int, head_dim: int, *,
                    w_local: int, budget: int, dtype=torch.float32,
                    device=None) -> DualCache:
    b, h, w, c, d = batch, n_kv_heads, w_local, budget, head_dim
    pkmin, pkmax = init_page_meta(b, h, c, d, dtype=dtype, device=device)

    def z(shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    i32 = torch.int32
    return DualCache(
        lk=z((b, h, w, d)), lv=z((b, h, w, d)), lg=z((b, h, w), torch.float32),
        lpos=torch.full((b, w), -1, dtype=i32, device=device),
        gk=z((b, h, c, d)), gv=z((b, h, c, d)),
        gpos=z((b, h, c), i32), gcnt=z((b, h), i32),
        t=z((b,), i32), ptr=z((b,), i32), overflow=z((b, h), i32),
        pkmin=pkmin, pkmax=pkmax)


def lazy_promote_and_write(cache: DualCache, k_new: torch.Tensor,
                           v_new: torch.Tensor, g_new: torch.Tensor, *,
                           tau: float) -> DualCache:
    """Decode-phase cache update (paper Fig. 6d):

    1. inspect the victim at the ring pointer;
    2. promote it to the global cache iff its stored g >= tau (per head),
       while the budget lasts (a full cache counts the drop in
       ``overflow`` and leaves slot ``C - 1`` as it was);
    3. overwrite the ring slot with the new token; advance the pointer.
    """
    b, h, w, d = cache.lk.shape
    c = cache.budget
    dev = cache.lk.device
    bar = torch.arange(b, device=dev)
    ptr = cache.ptr.long()
    # ---- victim ----------------------------------------------------------
    vk = cache.lk[bar, :, ptr]                        # [B, H, hd]
    vv = cache.lv[bar, :, ptr]
    vg = cache.lg[bar, :, ptr]                        # [B, H]
    vpos = cache.lpos[bar, ptr]                       # [B]
    victim_valid = vpos >= 0
    promote = victim_valid[:, None] & (vg >= tau)     # [B, H]
    can_write = promote & (cache.gcnt < c)
    # ---- promotion: scatter one slot per head -----------------------------
    dest = torch.clamp(cache.gcnt, max=c - 1)         # [B, H]
    bi = bar[:, None].expand(b, h)
    hi = torch.arange(h, device=dev)[None, :].expand(b, h)
    di = dest.long()
    old_k = cache.gk[bi, hi, di]
    old_v = cache.gv[bi, hi, di]
    old_p = cache.gpos[bi, hi, di]
    up_k = torch.where(can_write[..., None], vk.to(cache.gk.dtype), old_k)
    up_v = torch.where(can_write[..., None], vv.to(cache.gv.dtype), old_v)
    up_p = torch.where(can_write, vpos[:, None].expand(b, h), old_p)
    gk, gv, gpos = cache.gk.clone(), cache.gv.clone(), cache.gpos.clone()
    gk[bi, hi, di] = up_k
    gv[bi, hi, di] = up_v
    gpos[bi, hi, di] = up_p
    gcnt = cache.gcnt + can_write.to(torch.int32)
    overflow = cache.overflow + (promote & ~can_write).to(torch.int32)
    pkmin, pkmax = update_page_meta_on_write(
        cache.pkmin, cache.pkmax, dest, vk, can_write)
    # ---- write the new token into the ring (scatter at ptr) --------------
    lk, lv = cache.lk.clone(), cache.lv.clone()
    lg, lpos = cache.lg.clone(), cache.lpos.clone()
    lk[bar, :, ptr] = k_new.to(lk.dtype)
    lv[bar, :, ptr] = v_new.to(lv.dtype)
    lg[bar, :, ptr] = g_new.float()
    lpos[bar, ptr] = cache.t
    return cache._replace(
        lk=lk, lv=lv, lg=lg, lpos=lpos,
        gk=gk, gv=gv, gpos=gpos, gcnt=gcnt, overflow=overflow,
        pkmin=pkmin, pkmax=pkmax,
        t=cache.t + 1, ptr=torch.remainder(cache.ptr + 1, w).to(torch.int32))


def cache_kv_for_attention(cache: DualCache) -> Tuple[torch.Tensor, ...]:
    """Concatenate [global | local] K/V with a validity mask for decode
    attention: (k [B,H,C+W,hd], v, valid [B,H,C+W])."""
    k = torch.cat([cache.gk, cache.lk], dim=2)
    v = torch.cat([cache.gv, cache.lv], dim=2)
    c = cache.budget
    ar = torch.arange(c, device=cache.gk.device)
    gvalid = ar[None, None] < cache.gcnt[..., None]              # [B,H,C]
    lvalid = (cache.lpos >= 0)[:, None, :].expand(cache.lg.shape)
    return k, v, torch.cat([gvalid, lvalid], dim=2)
