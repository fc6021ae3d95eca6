"""AdamW with a cosine schedule and linear warmup (port of
``repro/training/optimizer.py``; paper Appendix C: AdamW, wd 0.01, peak
lr 1e-3, 10% warmup, cosine decay).

Plain functions on trees of tensors, as in the reference: the state is a
step counter and the first and second moments, and :func:`adamw_update`
returns new parameters and a new state without touching its inputs. The
step is a 0-d int32 tensor on the CPU and the learning rate a 0-d float32
tensor there, so a step reads nothing back from the card.
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Tuple, Union

import torch

from repro_torch.tree import tree_map


class AdamWState(NamedTuple):
    step: torch.Tensor   # 0-d int32, on the CPU
    m: Any
    v: Any


def cosine_schedule(peak_lr: float, total_steps: int,
                    warmup_frac: float = 0.1) -> Callable:
    """step -> learning rate (0-d float32): linear warmup over the first
    ``warmup_frac`` of the steps, then cosine decay to 0."""
    warmup = max(1, int(total_steps * warmup_frac))

    def lr(step) -> torch.Tensor:
        step = torch.as_tensor(step, dtype=torch.float32)
        warm = peak_lr * step / warmup
        prog = torch.clamp((step - warmup) / max(total_steps - warmup, 1),
                           0.0, 1.0)
        cos = peak_lr * 0.5 * (1.0 + torch.cos(math.pi * prog))
        return torch.where(step < warmup, warm, cos)

    return lr


def adamw_init(params: Any) -> AdamWState:
    return AdamWState(torch.zeros((), dtype=torch.int32),
                      tree_map(torch.zeros_like, params),
                      tree_map(torch.zeros_like, params))


@torch.no_grad()
def adamw_update(grads: Any, state: AdamWState, params: Any, *,
                 lr: Union[float, Callable], b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.01) -> Tuple[Any, AdamWState]:
    """One AdamW step, the reference's formula: bias correction, the
    learning rate read at the incremented step, decoupled weight decay."""
    step = state.step + 1
    lr_t = lr(step) if callable(lr) else torch.tensor(lr, dtype=torch.float32)
    stepf = step.float()
    b1t = 1.0 - torch.tensor(b1, dtype=torch.float32) ** stepf
    b2t = 1.0 - torch.tensor(b2, dtype=torch.float32) ** stepf
    m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g, state.m, grads)
    v = tree_map(lambda v_, g: b2 * v_ + (1 - b2) * g * g, state.v, grads)
    new_params = tree_map(
        lambda p, m_, v_: p - lr_t * ((m_ / b1t) / (torch.sqrt(v_ / b2t) + eps)
                                      + weight_decay * p),
        params, m, v)
    return new_params, AdamWState(step, m, v)
