"""Shared model building blocks (port of ``repro/models/layers.py``).

Plain functions on tensors with parameter dicts, in the reference's
layouts: weights are ``[in, out]`` and applied as ``x @ w``.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.device import torch_dtype

Params = Dict[str, torch.Tensor]


# --------------------------------------------------------------------------
# init helpers
# --------------------------------------------------------------------------
def dense_init(gen: torch.Generator, shape: Tuple[int, ...], dtype,
               device, scale: float | None = None) -> torch.Tensor:
    fan_in = shape[0] if len(shape) >= 2 else shape[-1]
    if scale is None:
        scale = fan_in ** -0.5
    w = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    return (w * scale).to(dtype)


def embed_init(gen: torch.Generator, shape, dtype, device) -> torch.Tensor:
    w = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    return (w * 0.02).to(dtype)


# --------------------------------------------------------------------------
# norms
# --------------------------------------------------------------------------
def init_rmsnorm(dim: int, dtype, device) -> Params:
    return {"scale": torch.ones((dim,), dtype=dtype, device=device)}


def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """f32 upcast, eps 1e-6, scale applied in f32 (``layers.py:35-38``)."""
    x32 = x.float()
    y = x32 * torch.rsqrt(x32.square().mean(-1, keepdim=True) + eps)
    return (y * p["scale"].float()).to(x.dtype)


def rmsnorm_nowt(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    y = x32 * torch.rsqrt(x32.square().mean(-1, keepdim=True) + eps)
    return y.to(x.dtype)


# --------------------------------------------------------------------------
# rotary embeddings
# --------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """[head_dim // 2] inverse frequencies."""
    ar = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
    return 1.0 / (theta ** (ar / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., T, hd]; positions broadcastable to [..., T] (int).
    Rotates INTERLEAVED pairs (x[2i], x[2i+1]) — not the half-split
    layout. Returns x's dtype."""
    if theta <= 0:
        return x
    hd = x.shape[-1]
    inv = rope_freqs(hd, theta, device=x.device)              # [hd/2]
    ang = positions[..., None].float() * inv                  # [..., T, hd/2]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x32 = x.float()
    x1, x2 = x32[..., 0::2], x32[..., 1::2]
    r1 = x1 * cos - x2 * sin
    r2 = x2 * cos + x1 * sin
    out = torch.stack([r1, r2], dim=-1).reshape(x.shape)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# FFN (SwiGLU)
# --------------------------------------------------------------------------
def init_swiglu(gen: torch.Generator, d_model: int, d_ff: int, dtype,
                device) -> Params:
    return {
        "w_gate": dense_init(gen, (d_model, d_ff), dtype, device),
        "w_up": dense_init(gen, (d_model, d_ff), dtype, device),
        "w_down": dense_init(gen, (d_ff, d_model), dtype, device),
    }


def swiglu(p: Params, x: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    h = F.silu(x @ p["w_gate"].to(dt)) * (x @ p["w_up"].to(dt))
    return h @ p["w_down"].to(dt)


# --------------------------------------------------------------------------
# embedding / unembedding (tied)
# --------------------------------------------------------------------------
def init_embedding(gen: torch.Generator, cfg: ModelConfig, device) -> Params:
    dt = torch_dtype(cfg.param_dtype)
    p = {"tok": embed_init(gen, (cfg.vocab_size, cfg.d_model), dt, device)}
    if not cfg.tie_embeddings:
        p["unembed"] = embed_init(gen, (cfg.d_model, cfg.vocab_size), dt,
                                  device)
    return p


def embed(p: Params, tokens: torch.Tensor, dtype) -> torch.Tensor:
    return p["tok"].to(dtype)[tokens.long()]


def unembed(p: Params, x: torch.Tensor) -> torch.Tensor:
    w = p.get("unembed")
    if w is None:
        w = p["tok"].T
    return x @ w.to(x.dtype)
