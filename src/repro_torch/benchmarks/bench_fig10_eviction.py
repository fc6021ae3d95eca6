"""Fig. 10 / Fig. 16 — composability with post-write Eviction (SnapKV)
under a hard memory bound (port of ``benchmarks/bench_fig10_eviction.py``),
on the needle-retrieval task decoded step by step (early context needed
at the end — the reasoning-trace proxy).

Quadrant reproduced:
  * Eviction only ("write-then-throw"): everything is admitted, the cache
    fills with noise, evictions fire repeatedly and can discard the needle.
  * Admission only, aggressive: zero evictions but the gate may starve the
    model of useful context.
  * Admission + Eviction at moderate tau: few triggers, accuracy held.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.benchmarks.bench_fig9_quest import decode_payload
from repro_torch.benchmarks.common import device_of, needle_batch, trained_model
from repro_torch.device import DeviceLike
from repro_torch.models import inference as I


@torch.no_grad()
def _run_policy(cfg, params, *, tau, hard_budget, n=16, seed=91, batch=None):
    c2 = cfg.replace(wgkv=dataclasses.replace(cfg.wgkv, tau=tau))
    b = needle_batch(seed, n, device_of(params), batch)
    opts = I.DecodeOptions(evict_hard_budget=hard_budget, w_obs=8)
    pred, caches, trig = decode_payload(c2, params, opts, b, budget=64)
    acc = float((pred == b["answer"].cpu().numpy()).mean())
    # the first block's caches, stacked over the repeats ([R, B, H]); a
    # cross-attention block's self cache
    node = caches["blocks"]["b0"]
    dc = node["self"] if isinstance(node, dict) else node
    mem = float(dc.gcnt.float().mean())
    return acc, trig, mem


def run(device: DeviceLike = None):
    cfg, params = trained_model(device=device)
    batch = needle_batch(91, 16, device_of(params))
    rows = []
    budget = 24  # hard per-head global bound (tokens)
    for label, tau, bound in (("snapkv_only", -1.0, budget),
                              ("wgkv_aggressive_only", 0.95, budget),
                              ("wgkv+snapkv", 0.1, budget),
                              ("unbounded_ref", 0.1, 10_000)):
        acc, trig, mem = _run_policy(cfg, params, tau=tau, hard_budget=bound,
                                     batch=batch)
        rows.append((f"fig10/{label}", 0.0,
                     f"acc={acc:.3f},evictions={trig:.0f},gmem={mem:.1f}"))
    return rows
