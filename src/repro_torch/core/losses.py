"""Training objective for the admission policy (port of
``repro/core/losses.py``, paper §3.3).

    L_total = L_distill + lambda * L_sparsity
    L_distill  = mean || h_student_final - h_teacher_final ||^2
    L_sparsity = mean_{l,h,t} ( g + g * (1 - g) )

The backbone is frozen; only Write-Gate MLP parameters receive gradients.

On a mesh (``sharding.comm``) each masked mean is a sum and a count
added over the axes the batch rows are split over (and, for the gates,
over "model" when the kv heads are split: the gates are the rank's
``[L, B, H_local, T]``), so every rank holds the global loss and its
gradient is its own rows' and heads' part.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.sharding import comm


def distill_loss(h_student: torch.Tensor, h_teacher: torch.Tensor,
                 loss_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """L2 on final-layer hidden states. h: [B, S, D]; mask: [B, S]."""
    d = torch.square(h_student.float() - h_teacher.float()).mean(-1)
    if loss_mask is not None:
        num, den = (d * loss_mask).sum(), loss_mask.sum()
    else:
        num, den = d.sum(), torch.full_like(d.sum(), d.numel())
    tot = comm.sum_rows(_pack(num, den))
    if loss_mask is not None:
        return tot[0] / torch.clamp(tot[1], min=1.0)
    return tot[0] / tot[1]


def _pack(*xs: torch.Tensor) -> torch.Tensor:
    """0-d terms -> one f32 vector (one collective for all of them)."""
    out = xs[0].new_zeros((len(xs),), dtype=torch.float32)
    for i, x in enumerate(xs):
        out[i] = x
    return out


def sparsity_loss(gates: torch.Tensor,
                  loss_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """gates: [..., T] stacked over layers/heads. The first term drives
    admission down; the second penalizes non-binary values (pushes g toward
    {0, 1})."""
    return _sparsity_sums(gates, loss_mask)[0]


def _sparsity_sums(gates: torch.Tensor,
                   loss_mask: Optional[torch.Tensor] = None):
    """(sparsity loss, the global [sum g, count, admitted count] the
    aux means read): the terms summed in one collective on a mesh."""
    g = gates.float()
    per = g + g * (1.0 - g)
    ones = torch.ones((), dtype=torch.float32, device=g.device)
    stats = (g.sum(), ones * g.numel(), (g >= 0.1).float().sum())
    if loss_mask is not None:
        # gates: [L, B, H, T]; mask: [B, T] -> [1, B, 1, T]
        m = loss_mask[None, :, None, :] if per.ndim == 4 else loss_mask
        w = torch.broadcast_to(m, per.shape)
        tot = comm.sum_rows(_pack((per * w).sum(), w.sum(), *stats),
                            heads=True)
        return tot[0] / torch.clamp(tot[1], min=1.0), tot[2:]
    tot = comm.sum_rows(_pack(per.sum(), ones * per.numel(), *stats),
                        heads=True)
    return tot[0] / tot[1], tot[2:]


def total_loss(h_student, h_teacher, gates, lam: float, loss_mask=None
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    ld = distill_loss(h_student, h_teacher, loss_mask)
    ls, (g_sum, g_n, g_adm) = _sparsity_sums(gates, loss_mask)
    aux = {
        "distill": ld,
        "sparsity": ls,
        "mean_gate": g_sum / g_n,
        "admission_rate@0.1": g_adm / g_n,
    }
    return ld + lam * ls, aux
