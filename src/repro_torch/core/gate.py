"""Write-Gate MLP (port of ``repro/core/gate.py``, paper §3.2).

    x = [RMSNorm(k_pre_rope); RMSNorm(k_post_rope)]       (2*head_dim,)
    g = sigmoid(W2 @ gelu_tanh(W1 @ x + b1) + b2)

Weights per kv head: W1 [H, 2*hd, hidden], b1 [H, hidden], W2 [H, hidden,
1], b2 [H, 1]. ``jax.nn.gelu`` defaults to the tanh approximation, so the
port uses it too: exact GELU shifts g and flips admissions near tau.
On CUDA the MLP runs in the hand-written ``gate_mlp`` kernel.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import torch_dtype
from repro_torch.kernels import ops

Params = Dict[str, torch.Tensor]


def init_gate(gen: torch.Generator, cfg: ModelConfig, device) -> Params:
    h = cfg.n_kv_heads
    fin = 2 * cfg.head_dim
    hid = cfg.wgkv.gate_hidden
    dt = torch_dtype(cfg.param_dtype)
    w1 = torch.randn((h, fin, hid), generator=gen, device=device)
    w2 = torch.randn((h, hid, 1), generator=gen, device=device)
    return {
        "w1": (w1 / fin ** 0.5).to(dt),
        "b1": torch.zeros((h, hid), dtype=dt, device=device),
        "w2": (w2 / hid ** 0.5).to(dt),
        # positive bias => gates start near "admit" (~0.73), as in the
        # reference's init
        "b2": torch.full((h, 1), 1.0, dtype=dt, device=device),
    }


def _rmsnorm_nowt(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps)


def gate_features(k_pre: torch.Tensor, k_post: torch.Tensor) -> torch.Tensor:
    """[..., H, T, hd] x2 -> [..., H, T, 2*hd] (both RMS-normalized)."""
    return torch.cat([_rmsnorm_nowt(k_pre), _rmsnorm_nowt(k_post)], dim=-1)


def gate_scores(params: Params, k_pre: torch.Tensor,
                k_post: torch.Tensor) -> torch.Tensor:
    """k_pre, k_post: [B, H_kv, T, hd] (pre-/post-RoPE keys).
    Returns g: [B, H_kv, T] float32 in (0, 1)."""
    x = gate_features(k_pre, k_post).to(params["w1"].dtype)
    return ops.write_gate(x, params["w1"], params["b1"], params["w2"],
                          params["b2"])


def gate_param_count(cfg: ModelConfig) -> int:
    h, fin, hid = cfg.n_kv_heads, 2 * cfg.head_dim, cfg.wgkv.gate_hidden
    return h * (fin * hid + hid + hid + 1)
