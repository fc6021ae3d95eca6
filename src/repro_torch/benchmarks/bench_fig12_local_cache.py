"""Fig. 12 (Appendix G) — necessity of the Local Cache (port of
``benchmarks/bench_fig12_local_cache.py``).

Retrain gates with w_local=1 (no grace period: immediate admit-or-drop)
and compare the loss-memory point against the full dual-cache design.
Expected: marked degradation without the local window ("transient
utility" hypothesis)."""
from __future__ import annotations

import dataclasses as dc
import functools

import torch

from repro_torch.benchmarks.common import (_distill, bench_cfg, cache_size_at,
                                           needle_accuracy, trained_model)
from repro_torch.device import DeviceLike


@functools.lru_cache(maxsize=1)
def _no_local_model(lam: float = 0.15, device: DeviceLike = None):
    cfg = bench_cfg(lam=lam, w_local=1)
    _, base = trained_model(device=device)
    params, _ = _distill(cfg, base, lam, steps=120)
    return cfg, params


@torch.no_grad()
def run(device: DeviceLike = None):
    rows = []
    cfg_full, params_full = trained_model(device=device)
    cfg_nl, params_nl = _no_local_model(device=device)
    for tau in (0.05, 0.2, 0.5):
        a_full = needle_accuracy(
            cfg_full.replace(wgkv=dc.replace(cfg_full.wgkv, tau=tau)),
            params_full, mode="hard")
        s_full = cache_size_at(cfg_full, params_full, tau)
        a_nl = needle_accuracy(
            cfg_nl.replace(wgkv=dc.replace(cfg_nl.wgkv, tau=tau)),
            params_nl, mode="hard")
        s_nl = cache_size_at(cfg_nl, params_nl, tau)
        rows.append((f"fig12/full_tau{tau}", 0.0,
                     f"cache={s_full:.3f},acc={a_full:.3f}"))
        rows.append((f"fig12/no_local_tau{tau}", 0.0,
                     f"cache={s_nl:.3f},acc={a_nl:.3f}"))
    return rows
