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
from repro_torch.sharding import comm

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


def init_layernorm(dim: int, dtype, device) -> Params:
    return {"scale": torch.ones((dim,), dtype=dtype, device=device),
            "bias": torch.zeros((dim,), dtype=dtype, device=device)}


def layernorm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """f32 upcast, biased variance, eps 1e-5 (``layers.py:46-52``)."""
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = (x32 - mu).square().mean(-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    y = y * p["scale"].float() + p["bias"].float()
    return y.to(x.dtype)


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


def mrope_sections(head_dim: int) -> Tuple[int, int, int]:
    """Qwen2-VL splits the hd/2 frequency slots into (t, h, w) sections;
    for hd 128 the reference uses (16, 24, 24), generalized by ratio."""
    half = head_dim // 2
    t = half // 4
    h = (half - t) // 2
    return t, h, half - t - h


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor,
                theta: float) -> torch.Tensor:
    """Multimodal RoPE. x: [..., T, hd]; positions3: [3, ..., T] (t, h, w
    ids: equal for text tokens, spatial for vision tokens). Frequency slot
    i is driven by stream 0, 1 or 2 per :func:`mrope_sections`; pairs
    rotate interleaved, as in :func:`apply_rope`."""
    hd = x.shape[-1]
    inv = rope_freqs(hd, theta, device=x.device)              # [hd/2]
    st, sh, sw = mrope_sections(hd)
    sec = torch.cat([torch.full((n,), i, dtype=torch.long, device=x.device)
                     for i, n in enumerate((st, sh, sw))])    # [hd/2]
    pos = torch.movedim(positions3, 0, -1).float()           # [..., T, 3]
    slot_pos = pos[..., sec]                                  # [..., T, hd/2]
    ang = slot_pos * inv
    cos, sin = torch.cos(ang), torch.sin(ang)
    x32 = x.float()
    x1, x2 = x32[..., 0::2], x32[..., 1::2]
    out = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                      dim=-1).reshape(x.shape)
    return out.to(x.dtype)


def sinusoidal_inv(dim: int, device=None) -> torch.Tensor:
    """[dim // 2] inverse frequencies of :func:`sinusoidal_positions`."""
    ar = torch.arange(dim // 2, dtype=torch.float32, device=device)
    return torch.exp(-torch.log(torch.tensor(10000.0)) * ar
                     / max(dim // 2 - 1, 1))


def sinusoidal_positions(seq: int, dim: int, device=None) -> torch.Tensor:
    """Whisper-style absolute sinusoidal embeddings [seq, dim]:
    [sin | cos] halves."""
    pos = torch.arange(seq, dtype=torch.float32, device=device)[:, None]
    ang = pos * sinusoidal_inv(dim, device)[None]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# --------------------------------------------------------------------------
# FFN (SwiGLU, llama-family) and whisper-style GELU MLP
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
    # on a mesh: the column-parallel w_gate / w_up take x through the
    # seam whose backward sums the gradient over "model", and the
    # row-parallel w_down's partials are summed over "model"
    x = comm.copy_to_model(x, "ffn")
    h = F.silu(x @ p["w_gate"].to(dt)) * (x @ p["w_up"].to(dt))
    return comm.reduce_model(h @ p["w_down"].to(dt), "ffn")


def init_gelu_mlp(gen: torch.Generator, d_model: int, d_ff: int, dtype,
                  device) -> Params:
    return {
        "w_in": dense_init(gen, (d_model, d_ff), dtype, device),
        "b_in": torch.zeros((d_ff,), dtype=dtype, device=device),
        "w_out": dense_init(gen, (d_ff, d_model), dtype, device),
        "b_out": torch.zeros((d_model,), dtype=dtype, device=device),
    }


def gelu_mlp(p: Params, x: torch.Tensor) -> torch.Tensor:
    """GELU in its tanh form, ``jax.nn.gelu``'s default. On a mesh as
    :func:`swiglu`: ``w_in`` (with its bias ``b_in``) column-parallel,
    ``w_out``'s partials summed over "model", then ``b_out`` added once."""
    dt = x.dtype
    x = comm.copy_to_model(x, "ffn")
    h = F.gelu(x @ p["w_in"].to(dt) + p["b_in"].to(dt), approximate="tanh")
    return comm.reduce_model(h @ p["w_out"].to(dt), "ffn") + \
        p["b_out"].to(dt)


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
