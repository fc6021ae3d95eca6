"""Training objective for the admission policy (port of
``repro/core/losses.py``, paper §3.3).

    L_total = L_distill + lambda * L_sparsity
    L_distill  = mean || h_student_final - h_teacher_final ||^2
    L_sparsity = mean_{l,h,t} ( g + g * (1 - g) )

The backbone is frozen; only Write-Gate MLP parameters receive gradients.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch


def distill_loss(h_student: torch.Tensor, h_teacher: torch.Tensor,
                 loss_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """L2 on final-layer hidden states. h: [B, S, D]; mask: [B, S]."""
    d = torch.square(h_student.float() - h_teacher.float()).mean(-1)
    if loss_mask is not None:
        return (d * loss_mask).sum() / torch.clamp(loss_mask.sum(), min=1.0)
    return d.mean()


def sparsity_loss(gates: torch.Tensor,
                  loss_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """gates: [..., T] stacked over layers/heads. The first term drives
    admission down; the second penalizes non-binary values (pushes g toward
    {0, 1})."""
    g = gates.float()
    per = g + g * (1.0 - g)
    if loss_mask is not None:
        # gates: [L, B, H, T]; mask: [B, T] -> [1, B, 1, T]
        m = loss_mask[None, :, None, :] if per.ndim == 4 else loss_mask
        w = torch.broadcast_to(m, per.shape)
        return (per * w).sum() / torch.clamp(w.sum(), min=1.0)
    return per.mean()


def total_loss(h_student, h_teacher, gates, lam: float, loss_mask=None
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    ld = distill_loss(h_student, h_teacher, loss_mask)
    ls = sparsity_loss(gates, loss_mask)
    aux = {
        "distill": ld,
        "sparsity": ls,
        "mean_gate": gates.mean(),
        "admission_rate@0.1": (gates >= 0.1).float().mean(),
    }
    return ld + lam * ls, aux
