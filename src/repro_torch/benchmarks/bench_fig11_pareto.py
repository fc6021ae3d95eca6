"""Fig. 11 (Appendix F) — lambda / tau Pareto frontier: distillation loss
vs normalized KV cache size (port of ``benchmarks/bench_fig11_pareto.py``).
Sweeping tau on gates distilled at three lambdas traces the frontier;
tau≈0.1 should sit near the knee."""
from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.benchmarks.common import (_distill, bench_cfg, cache_size_at,
                                           device_of, needle_batch,
                                           trained_model)
from repro_torch.core.losses import distill_loss
from repro_torch.device import DeviceLike
from repro_torch.models import transformer as T


@functools.lru_cache(maxsize=4)
def _model_at_lambda(lam: float, device: DeviceLike = None):
    cfg = bench_cfg(lam=lam)
    _, base = trained_model(device=device)  # the pre-trained teacher backbone
    params, _ = _distill(cfg, base, lam, steps=120)
    return cfg, params


@torch.no_grad()
def _val_loss(cfg, params, tau, n=8, seed=999, batch=None):
    c2 = cfg.replace(wgkv=dataclasses.replace(cfg.wgkv, tau=tau))
    b = needle_batch(seed, n, device_of(params), batch)
    teach = T.forward(params, c2, b["tokens"], mode="teacher")
    hard = T.forward(params, c2, b["tokens"], mode="hard")
    return float(distill_loss(hard.hidden, teach.hidden))


def run(device: DeviceLike = None):
    rows = []
    for lam in (0.05, 0.15, 0.4):
        cfg, params = _model_at_lambda(lam, device)
        for tau in (0.05, 0.1, 0.3, 0.7):
            loss = _val_loss(cfg, params, tau)
            size = cache_size_at(cfg, params, tau)
            rows.append((f"fig11/lam{lam}_tau{tau}", 0.0,
                         f"cache={size:.3f},distill_loss={loss:.4f}"))
    return rows
