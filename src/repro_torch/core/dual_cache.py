"""Dual cache (local ring + budgeted global) with lazy promotion (port of
``repro/core/dual_cache.py``, paper §4), and its initial population by a
budgeted prefill (``prefill_populate``).

The updates are functional, like the reference's: ``lazy_promote_and_write``
returns a new :class:`DualCache` and leaves its input untouched, so a
caller may keep the pre-step tree (the serving engine's paged mirror
diffs before/after trees; the ragged extend selects old leaves for
length-0 rows bit for bit).

Integer state (``lpos``, ``gpos``, ``gcnt``, ``t``, ``ptr``, ``overflow``)
stays int32 as in the reference and is cast to int64 only to index.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core.admission import GlobalSelection, select_global
from repro_torch.core.selection import (build_page_meta, init_page_meta,
                                        update_page_meta_on_write)


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

    def memory_tokens(self) -> torch.Tensor:
        """Current per-head resident token count: [B, H]."""
        local = torch.clamp(self.t, max=self.w_local)[:, None]
        return self.gcnt + local


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


def prefill_populate(cache: DualCache, k: torch.Tensor, v: torch.Tensor,
                     g: torch.Tensor, *, tau: float, sink: int = 0,
                     sel: Optional[GlobalSelection] = None) -> DualCache:
    """Initial cache population (paper §4.2). k, v: [B, H, S, hd] post-RoPE
    keys and values; g: [B, H, S].

    The final min(W, S) tokens go to the local ring, the token at
    absolute position p in slot p % W; earlier tokens go to the global
    cache iff admitted (g >= tau, sinks always), up to the budget, padded
    to the static budget. The page metadata is rebuilt once. Then
    ``t = S`` and ``ptr = S % W``. ``sel`` may pass the selection the
    budgeted prefill already made from the same gates (the same call of
    ``select_global``), so it is not sorted twice.

    The ring slots that hold tokens are then exactly the first
    min(t, W), the invariant the two-segment decode read relies on
    (``kernels/ops.py::dual_cache_segments``): for S >= W every slot is
    written (the last W positions cover every residue mod W), and for
    S < W the positions 0..S-1 land in slots 0..S-1. With S % W == 0, as
    the budgeted prefill requires, ``ptr`` is 0 and the ring is full."""
    b, h, s, d = k.shape
    w = cache.w_local
    dev = k.device
    # ---- local: last min(W, S) tokens at slots pos % W -------------------
    n_local = min(w, s)
    local_pos = torch.arange(s - n_local, s, device=dev)
    slots = local_pos % w
    lk, lv = cache.lk.clone(), cache.lv.clone()
    lg, lpos = cache.lg.clone(), cache.lpos.clone()
    lk[:, :, slots] = k[:, :, s - n_local:].to(lk.dtype)
    lv[:, :, slots] = v[:, :, s - n_local:].to(lv.dtype)
    lg[:, :, slots] = g[:, :, s - n_local:].float()
    lpos[:, slots] = local_pos.to(torch.int32)
    # ---- global: admitted tokens before the local window -----------------
    if sel is None:
        sel = select_global(g, budget=cache.budget, tau=tau, sink=sink,
                            exclude_from=s - n_local)
    bi = torch.arange(b, device=dev)[:, None, None]
    hi = torch.arange(h, device=dev)[None, :, None]
    idx = sel.idx.long()
    keep = sel.valid[..., None]
    gk = torch.where(keep, k[bi, hi, idx], torch.zeros((), dtype=k.dtype,
                                                      device=dev))
    gv = torch.where(keep, v[bi, hi, idx], torch.zeros((), dtype=v.dtype,
                                                      device=dev))
    gk, gv = gk.to(cache.gk.dtype), gv.to(cache.gv.dtype)
    gpos = torch.where(sel.valid, sel.idx, torch.zeros_like(sel.idx))
    pad = cache.budget - gk.shape[2]
    if pad:
        # short prefill (S < capacity): pad to the static budget
        gk = torch.nn.functional.pad(gk, (0, 0, 0, pad))
        gv = torch.nn.functional.pad(gv, (0, 0, 0, pad))
        gpos = torch.nn.functional.pad(gpos, (0, pad))
    gvalid = (torch.arange(cache.budget, device=dev)[None, None]
              < sel.count[..., None])
    meta = build_page_meta(gk, gvalid)
    return cache._replace(
        lk=lk, lv=lv, lg=lg, lpos=lpos,
        gk=gk, gv=gv, gpos=gpos, gcnt=sel.count,
        pkmin=meta.kmin.to(cache.pkmin.dtype),
        pkmax=meta.kmax.to(cache.pkmax.dtype),
        t=torch.full_like(cache.t, s),
        ptr=torch.full_like(cache.ptr, s % w))


def lazy_promote_and_write(cache: DualCache, k_new: torch.Tensor,
                           v_new: torch.Tensor, g_new: torch.Tensor, *,
                           tau: float, block=None) -> DualCache:
    """Decode-phase cache update (paper Fig. 6d):

    1. inspect the victim at the ring pointer;
    2. promote it to the global cache iff its stored g >= tau (per head),
       while the budget lasts (a full cache counts the drop in
       ``overflow`` and leaves slot ``C - 1`` as it was);
    3. overwrite the ring slot with the new token; advance the pointer.

    ``block`` (i, n): the global token axis (``gk``, ``gv``, ``gpos``) is
    split over n ranks and this cache holds block i of it (context-
    parallel decode). The budget is then ``n`` times the block, the
    victim's global slot ``gcnt`` lies in one block, and only that rank
    writes it; ``gcnt``, ``overflow``, the ring, ``t``, ``ptr`` and the
    page metadata (whole on every rank) advance alike everywhere."""
    b, h, w, d = cache.lk.shape
    c = cache.budget
    off = 0
    if block is not None:
        off, c = block[0] * c, block[1] * c
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
    mine = can_write
    di = dest.long()
    if block is not None:
        cb = cache.budget
        mine = can_write & (dest >= off) & (dest < off + cb)
        di = torch.clamp(di - off, 0, cb - 1)
    old_k = cache.gk[bi, hi, di]
    old_v = cache.gv[bi, hi, di]
    old_p = cache.gpos[bi, hi, di]
    up_k = torch.where(mine[..., None], vk.to(cache.gk.dtype), old_k)
    up_v = torch.where(mine[..., None], vv.to(cache.gv.dtype), old_v)
    up_p = torch.where(mine, vpos[:, None].expand(b, h), old_p)
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
