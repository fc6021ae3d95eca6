"""Static admission baselines (port of ``repro/core/baselines.py``, paper
§5.2, Appendix E).

Both are input-independent admission policies expressed in the write
gate's interface (g per (kv head, token)), so they reuse the same
vertical-slash prefill and dual-cache decode as WG-KV:

* Local Attention (StreamingLLM): admit only the attention sinks; every
  other token lives transiently in the local window.
* DuoAttention: a static per-head split into retrieval heads (admit all)
  and streaming heads (sinks and the local window only).

Plain tensor functions: no kernel runs here.
"""
from __future__ import annotations

from typing import Sequence

import torch


def local_attention_gates(batch: int, n_kv_heads: int, seq: int,
                          sink: int = 128, device=None) -> torch.Tensor:
    """g = 1 for sink tokens, 0 elsewhere. [B, H, S] float32."""
    g = (torch.arange(seq, device=device) < sink).float()
    return g[None, None].expand(batch, n_kv_heads, seq)


def duo_attention_gates(batch: int, head_is_retrieval: torch.Tensor,
                        seq: int, sink: int = 128) -> torch.Tensor:
    """head_is_retrieval: [H] bool. Retrieval heads admit everything;
    streaming heads admit only sinks. [B, H, S] float32."""
    dev = head_is_retrieval.device
    h = head_is_retrieval.shape[0]
    sinks = (torch.arange(seq, device=dev) < sink).float()[None, :]
    g = torch.where(head_is_retrieval[:, None], torch.ones_like(sinks),
                    sinks)                                      # [H, S]
    return g[None].expand(batch, h, seq)


def identify_retrieval_heads(gate_scores: torch.Tensor,
                             ratio: float) -> torch.Tensor:
    """Profile-based head identification (DuoAttention-style): rank heads
    by the mean admission of a learned gate on calibration data and flag
    the top ``ratio`` fraction as retrieval heads. gate_scores: [B, H, S]
    -> [H] bool (ties at the threshold included)."""
    per_head = gate_scores.float().mean(dim=(0, 2))               # [H]
    h = per_head.shape[0]
    k = max(1, int(round(ratio * h)))
    thresh = torch.sort(per_head).values[h - k]
    return per_head >= thresh


def full_attention_gates(batch: int, n_kv_heads: int, seq: int,
                         device=None) -> torch.Tensor:
    """The no-admission upper baseline: admit everything."""
    return torch.ones((batch, n_kv_heads, seq), dtype=torch.float32,
                      device=device)


def gates_from_positions(policy: str, positions: torch.Tensor,
                         n_kv_heads: int, *, sink: int,
                         retrieval_heads: Sequence[int] = ()
                         ) -> torch.Tensor:
    """Static admission gates at absolute ``positions`` ([B] for one
    decode step, [B, S] for a prefill): [B, H] or [B, H, S] float32, the
    head axis inserted at dim 1, so chunked prefill and decode writes see
    the same gate for the same position."""
    g = (positions < sink).float()                              # [B] / [B, S]
    out_shape = g.shape[:1] + (n_kv_heads,) + g.shape[1:]
    g = g.unsqueeze(1).expand(out_shape)
    if policy == "streaming_llm":
        return g
    if policy == "duo":
        retr = torch.zeros((n_kv_heads,), dtype=torch.bool,
                           device=positions.device)
        if len(retrieval_heads):
            retr[torch.as_tensor(list(retrieval_heads), dtype=torch.long,
                                 device=positions.device)] = True
        retr = retr.reshape((1, n_kv_heads) + (1,) * (g.ndim - 2))
        return torch.where(retr, torch.ones_like(g), g)
    raise ValueError(f"unknown static admission policy {policy!r}")
