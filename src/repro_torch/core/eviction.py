"""SnapKV-like post-write Eviction (port of ``repro/core/eviction.py``,
paper §5.4, Appendix K.1).

Importance of key j is scored from the most recent W_obs queries:
  A^(h)   = softmax(Q_obs^(h) K^T / sqrt(d))         per query head in group
  S_raw_j = sum_i max_h A[i, j]                      aggregate
  S       = maxpool(S_raw, W_pool)                   local smoothing
When a head's global cache reaches its hard budget, the bottom
``evict_frac`` of its valid entries are dropped and the cache is
compacted; the Quest page metadata is rebuilt.

Plain PyTorch on every device: the reference has no TPU kernel here.
Ranking keeps the reference's tie order: ``jnp.argsort`` is stable, and
the width-5 max-pool copies one score to up to five neighbours, so exact
ties are common; every sort here passes ``stable=True``. Nothing syncs
with the host: the scores are computed for every head, the evicted
cache is selected per (row, head) by ``torch.where``, and scalars are
made on the device.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.core.dual_cache import DualCache
from repro_torch.core.selection import build_page_meta

INT32_MAX = 2 ** 31 - 1


class ObsWindow(NamedTuple):
    """Ring buffer of recent query vectors (per q-head)."""

    q: torch.Tensor    # [B, Hq, W_obs, hd]
    n: torch.Tensor    # [B] int32 valid count (grows past W_obs)

    @property
    def w_obs(self) -> int:
        return self.q.shape[2]


def init_obs(batch: int, n_q_heads: int, head_dim: int, w_obs: int = 256,
             dtype=torch.float32, device=None) -> ObsWindow:
    return ObsWindow(
        q=torch.zeros((batch, n_q_heads, w_obs, head_dim), dtype=dtype,
                      device=device),
        n=torch.zeros((batch,), dtype=torch.int32, device=device))


def push_query(obs: ObsWindow, q: torch.Tensor) -> ObsWindow:
    """q: [B, Hq, hd] — written at slot ``n % W_obs`` (functional)."""
    w = obs.w_obs
    slot = torch.remainder(obs.n, w)
    sl = torch.arange(w, device=q.device)[None] == slot[:, None]  # [B, W]
    qn = torch.where(sl[:, None, :, None], q[:, :, None, :].to(obs.q.dtype),
                     obs.q)
    return ObsWindow(q=qn, n=obs.n + 1)


def snap_scores(obs: ObsWindow, k: torch.Tensor, valid: torch.Tensor,
                w_pool: int = 5) -> torch.Tensor:
    """k: [B, Hkv, N, hd]; valid: [B, Hkv, N]. Returns scores [B, Hkv, N]
    (-inf on invalid entries)."""
    b, hq, w, d = obs.q.shape
    hkv = k.shape[1]
    g = hq // hkv
    qg = obs.q.reshape(b, hkv, g, w, d)
    logits = torch.einsum("bhgwd,bhnd->bhgwn", qg, k.to(obs.q.dtype))
    # a true division by sqrt(d) in the obs dtype, as the reference; a
    # 0-d device tensor (a fill, not a host copy) keeps it a division
    logits = logits / torch.full((), float(d), dtype=logits.dtype,
                                 device=logits.device).sqrt()
    qvalid = (torch.arange(w, device=k.device)[None]
              < torch.clamp(obs.n, max=w)[:, None])                 # [B, W]
    mask = valid[:, :, None, None, :] & qvalid[:, None, None, :, None]
    logits = torch.where(mask, logits, torch.full_like(logits, -1e30))
    a = torch.softmax(logits, dim=-1)
    a = torch.where(mask, a, torch.zeros_like(a))
    raw = a.amax(dim=2).sum(dim=2)     # max over group heads, sum over window
    pads = w_pool // 2
    padded = torch.nn.functional.pad(raw, (pads, pads), value=float("-inf"))
    n = raw.shape[-1]
    pooled = torch.stack([padded[..., i:i + n] for i in range(w_pool)]
                         ).amax(dim=0)
    return torch.where(valid, pooled, torch.full_like(pooled, float("-inf")))


def evict_global(cache: DualCache, scores: torch.Tensor, *,
                 evict_frac: float = 0.10) -> DualCache:
    """Drop the bottom ``evict_frac`` (at least one) of the valid global
    entries of every head and compact the rest in position order.
    scores: [B, Hkv, C] (-inf on invalid)."""
    c = cache.gk.shape[2]
    dev = scores.device
    n_evict = torch.clamp((cache.gcnt * evict_frac).to(torch.int32), min=1)
    n_evict = torch.where(cache.gcnt > 0, n_evict, torch.zeros_like(n_evict))
    keep_n = cache.gcnt - n_evict                                   # [B, H]
    order = torch.argsort(-scores, dim=-1, stable=True)   # descending score
    rank_of_slot = torch.argsort(order, dim=-1, stable=True)
    keep = rank_of_slot < keep_n[..., None]                        # [B, H, C]
    poskey = torch.where(keep, cache.gpos, torch.full_like(cache.gpos,
                                                           INT32_MAX))
    perm = torch.argsort(poskey, dim=-1, stable=True)  # kept first, by pos
    newcnt = keep.sum(-1).to(torch.int32)
    valid = torch.arange(c, device=dev)[None, None] < newcnt[..., None]

    def take(x):
        idx = perm[..., None].expand(x.shape)
        return torch.gather(x, 2, idx)

    zero = torch.zeros((), dtype=cache.gk.dtype, device=dev)
    newgk = torch.where(valid[..., None], take(cache.gk), zero)
    newgv = torch.where(valid[..., None], take(cache.gv), zero)
    # compaction permutes every slot, so the page metadata is rebuilt
    meta = build_page_meta(newgk, valid)
    return cache._replace(
        gk=newgk, gv=newgv,
        gpos=torch.where(valid, torch.gather(cache.gpos, 2, perm),
                         torch.zeros_like(cache.gpos)),
        gcnt=newcnt,
        pkmin=meta.kmin.to(cache.pkmin.dtype),
        pkmax=meta.kmax.to(cache.pkmax.dtype))


def maybe_evict(cache: DualCache, obs: ObsWindow, *, hard_budget: int,
                evict_frac: float = 0.10
                ) -> Tuple[DualCache, torch.Tensor]:
    """Evict in every head whose global count has reached
    ``hard_budget``. Returns (cache, triggered [B, Hkv] bool)."""
    gvalid = (torch.arange(cache.budget, device=cache.gcnt.device)[None, None]
              < cache.gcnt[..., None])
    trig = cache.gcnt >= hard_budget
    scores = snap_scores(obs, cache.gk, gvalid)
    evicted = evict_global(cache, scores, evict_frac=evict_frac)

    def pick(new, old):
        t = trig.reshape(trig.shape + (1,) * (old.ndim - 2))
        return torch.where(t, new, old)
    return cache._replace(
        gk=pick(evicted.gk, cache.gk), gv=pick(evicted.gv, cache.gv),
        gpos=pick(evicted.gpos, cache.gpos),
        gcnt=pick(evicted.gcnt, cache.gcnt),
        pkmin=pick(evicted.pkmin, cache.pkmin),
        pkmax=pick(evicted.pkmax, cache.pkmax)), trig
