"""GQA self-attention with the write-gated dual cache (port of the decode
half of ``repro/models/attention.py``).

On CUDA the gate runs in the ``gate_mlp`` kernel and the read over
[admitted global ‖ local ring] in the two-segment ``paged_decode``
kernel, straight from the cache buffers; on the CPU both wrappers run
their plain PyTorch versions.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.dual_cache import DualCache, lazy_promote_and_write
from repro_torch.core.gate import gate_scores, init_gate
from repro_torch.device import torch_dtype
from repro_torch.kernels import ops
from repro_torch.models import layers as L

Params = Dict[str, torch.Tensor]


def init_attention(gen: torch.Generator, cfg: ModelConfig, device) -> Params:
    """Causal self-attention parameters (the reference's ``kind="self"``),
    with the write gate when WG-KV is enabled."""
    dt = torch_dtype(cfg.param_dtype)
    d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p: Params = {
        "w_q": L.dense_init(gen, (d, hq * hd), dt, device),
        "w_k": L.dense_init(gen, (d, hkv * hd), dt, device),
        "w_v": L.dense_init(gen, (d, hkv * hd), dt, device),
        "w_o": L.dense_init(gen, (hq * hd, d), dt, device),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((hd,), dtype=dt, device=device)
        p["k_norm"] = torch.ones((hd,), dtype=dt, device=device)
    if cfg.wgkv.enabled:
        p["gate"] = init_gate(gen, cfg, device)
    return p


def _heads(x: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    """[B, S, n*hd] -> [B, n, S, hd]"""
    b, s, _ = x.shape
    return x.reshape(b, s, n, hd).transpose(1, 2)


def _qk_norm(p: Params, q, k):
    if "q_norm" in p:
        q = L.rmsnorm_nowt(q) * p["q_norm"].to(q.dtype)
        k = L.rmsnorm_nowt(k) * p["k_norm"].to(k.dtype)
    return q, k


def _rope_single(cfg: ModelConfig, x: torch.Tensor,
                 t: torch.Tensor) -> torch.Tensor:
    """x: [B, H, hd] at per-batch position t [B]."""
    if cfg.rope_theta <= 0:
        return x
    return L.apply_rope(x[:, :, None, :], t[:, None, None],
                        cfg.rope_theta)[:, :, 0]


def attn_decode_wgkv(p: Params, cfg: ModelConfig, x_t: torch.Tensor,
                     cache: DualCache, *,
                     gate_override: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, DualCache, torch.Tensor]:
    """One decode step against the dual cache. x_t: [B, D].

    The cache is updated FIRST (the victim at age W promoted iff
    admitted, the new token written into the ring), then attention runs
    over the updated cache, so the just-written token is visible — the
    reference's order (``attention.py:393-394``).

    Returns (out [B, D], new cache, g_new [B, Hkv])."""
    b, _ = x_t.shape
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    x = x_t[:, None, :]
    q = _heads(x @ p["w_q"].to(x.dtype), hq, hd)[:, :, 0]        # [B,Hq,hd]
    k_pre = _heads(x @ p["w_k"].to(x.dtype), hkv, hd)[:, :, 0]
    v_new = _heads(x @ p["w_v"].to(x.dtype), hkv, hd)[:, :, 0]
    q, k_pre = _qk_norm(p, q[:, :, None], k_pre[:, :, None])
    q, k_pre = q[:, :, 0], k_pre[:, :, 0]
    q = _rope_single(cfg, q, cache.t)
    k_new = _rope_single(cfg, k_pre, cache.t)
    if gate_override is not None:
        g_new = gate_override
    else:
        g_new = gate_scores(p["gate"], k_pre[:, :, None],
                            k_new[:, :, None])[..., 0]
    new_cache = lazy_promote_and_write(cache, k_new, v_new, g_new,
                                       tau=cfg.wgkv.tau)
    o = ops.dual_cache_attention(q, new_cache)                   # [B,Hq,hd]
    y = o.reshape(b, hq * hd) @ p["w_o"].to(x_t.dtype)
    return y, new_cache, g_new
