"""Write-gated attention masks and log-space biases (port of
``repro/core/masks.py``, paper §3.2, §4.2).

Training-time (differentiable):
    m_ij = 1                if i - j < W_local
         = g_j              otherwise
    bias B_ij = log(m_ij + eps), added to qk/sqrt(d) before softmax;
    causal positions i < j get NEG_INF.

Inference-time (binary, vertical-slash):
    M_ij = (1[i - j < W_local] or 1[g_j >= tau]) and 1[i >= j]
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def _positions(s_q: int, s_k: int, q_offset: int, device):
    qi = torch.arange(s_q, device=device)[:, None] + q_offset
    kj = torch.arange(s_k, device=device)[None, :]
    return qi, kj


def local_window_mask(s_q: int, s_k: int, w_local: int, q_offset: int = 0,
                      device=None) -> torch.Tensor:
    """[s_q, s_k] bool: True where i - j < w_local (and causal i >= j).
    Query i is at absolute position ``q_offset + i``; keys are 0..s_k-1."""
    qi, kj = _positions(s_q, s_k, q_offset, device)
    return (qi >= kj) & (qi - kj < w_local)


def causal_mask(s_q: int, s_k: int, q_offset: int = 0,
                device=None) -> torch.Tensor:
    qi, kj = _positions(s_q, s_k, q_offset, device)
    return qi >= kj


def write_gate_bias(g: torch.Tensor, s_q: int, w_local: int,
                    eps: float = 1e-6, q_offset: int = 0) -> torch.Tensor:
    """g: [..., s_k] gate scores per key -> bias [..., s_q, s_k]: 0 inside
    the local window, log(g + eps) outside it, NEG_INF above the causal
    diagonal."""
    s_k = g.shape[-1]
    local = local_window_mask(s_q, s_k, w_local, q_offset, g.device)
    causal = causal_mask(s_q, s_k, q_offset, g.device)
    logg = torch.log(g + eps)[..., None, :]
    bias = torch.where(local, torch.zeros_like(logg), logg)
    return torch.where(causal, bias, torch.full_like(bias, NEG_INF))


def vertical_slash_mask(g: torch.Tensor, tau: float, s_q: int, w_local: int,
                        q_offset: int = 0, sink: int = 0) -> torch.Tensor:
    """Binary inference mask M_ij (vertical-slash pattern).
    g: [..., s_k] -> bool [..., s_q, s_k]."""
    s_k = g.shape[-1]
    local = local_window_mask(s_q, s_k, w_local, q_offset, g.device)
    causal = causal_mask(s_q, s_k, q_offset, g.device)
    admitted = g >= tau
    if sink > 0:
        admitted = admitted | (torch.arange(s_k, device=g.device) < sink)
    return (local | admitted[..., None, :]) & causal
