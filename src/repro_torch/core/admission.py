"""Budgeted KV Admission (port of ``repro/core/admission.py``, paper §2.2,
§4.2 "Initial Cache Population").

Inference-time admission binarizes the gate (g >= tau) and, under a
budget ``C`` per head, selects the admitted tokens to keep in the global
cache. The first ``sink`` positions are always admitted.

The reference picks the budget with ``lax.top_k``, which keeps the lower
index first among equal scores. All sinks score 2.0, so with
``budget < eligible`` the cut can fall inside that tie; ``torch.topk``
promises no order there. The port takes the first ``budget`` entries of a
STABLE descending sort instead, which breaks ties the same way, so the
selected set — and, after the ascending sort, ``idx``, ``valid`` and
``count`` — are exactly the reference's.
"""
from __future__ import annotations

import warnings
from typing import NamedTuple, Optional

import torch


class GlobalSelection(NamedTuple):
    """Per-head admitted token set under a budget.

    idx:   [B, H, C] int32 token positions (ascending; padded with 0)
    valid: [B, H, C] bool
    count: [B, H] int32 number of valid entries
    """

    idx: torch.Tensor
    valid: torch.Tensor
    count: torch.Tensor


def select_global(g: torch.Tensor, *, budget: int, tau: float,
                  sink: int = 0,
                  exclude_from: Optional[int] = None) -> GlobalSelection:
    """Pick up to ``budget`` admitted tokens per head.

    g: [B, H, S] gate scores. Positions >= ``exclude_from`` (the final
    local window of a prefill) are never selected: they stay in the local
    ring and are promoted lazily. Sinks come first, then the highest
    gates; ties keep the lower position first."""
    b, h, s = g.shape
    pos = torch.arange(s, device=g.device)
    eligible = g >= tau
    if sink > 0:
        eligible = eligible | (pos < sink)
    if exclude_from is not None:
        eligible = eligible & (pos < exclude_from)
    score = torch.where(eligible, g, torch.full_like(g, float("-inf")))
    if sink > 0:
        score = torch.where((pos < sink) & eligible,
                            torch.full_like(g, 2.0), score)
    budget = min(budget, s)
    top_score, top_idx = torch.sort(score, dim=-1, descending=True,
                                    stable=True)
    top_score, top_idx = top_score[..., :budget], top_idx[..., :budget]
    valid = torch.isfinite(top_score)
    count = valid.sum(-1).to(torch.int32)
    # ascending positions (invalid entries last, in their top-k order)
    sort_key = torch.where(valid, top_idx, torch.full_like(top_idx, s + 1))
    order = torch.argsort(sort_key, dim=-1, stable=True)
    top_idx = torch.gather(top_idx, -1, order)
    valid = torch.gather(valid, -1, order)
    top_idx = torch.where(valid, top_idx, torch.zeros_like(top_idx))
    return GlobalSelection(top_idx.to(torch.int32), valid, count)


def tau_margin(g: torch.Tensor, tau: float) -> float:
    """Distance from tau to the nearest gate score: min |g - tau|.

    A margin near zero means the threshold sits inside the gate-score
    cluster, where two numerically equivalent attention paths can admit
    different token sets."""
    return float((g.float() - tau).abs().min())


def check_tau_margin(g: torch.Tensor, tau: float, *,
                     eps: float = 1e-3) -> float:
    """Warn (RuntimeWarning) when tau is knife-edge relative to the
    observed gate scores; returns the margin."""
    m = tau_margin(g, tau)
    if m < eps:
        warnings.warn(
            f"knife-edge admission threshold: min |g - tau| = {m:.2e} < "
            f"eps={eps:.0e} (tau={tau}); admission decisions may flip "
            "between numerically-equivalent attention paths. Move tau away "
            "from the gate-score cluster for parity-sensitive runs.",
            RuntimeWarning,
            stacklevel=2,
        )
    return m


def admission_rate(g: torch.Tensor, tau: float) -> torch.Tensor:
    """Fraction of tokens admitted per head: [B, H]."""
    return (g >= tau).float().mean(-1)


def normalized_cache_size(g: torch.Tensor, tau: float,
                          w_local: int) -> torch.Tensor:
    """Paper's x-axis metric: (admitted + local window) / full, per head."""
    s = g.shape[-1]
    admitted = (g >= tau).sum(-1)
    return torch.clamp((admitted + w_local) / s, max=1.0)
