"""Fig. 7 — memory-accuracy trade-off on long-context retrieval (port of
``benchmarks/bench_fig7_memory_accuracy.py``).

WG-KV (learned admission, tau sweep over the distilled gate) vs. the two
static admission baselines from the paper: Local Attention (sink + window,
window sweep) and DuoAttention (per-head retrieval/streaming split, ratio
sweep). Task: needle retrieval (HELMET recall proxy).

Expected qualitative reproduction: WG-KV holds accuracy into the
low-memory regime; Local Attention collapses once the needle leaves the
window; DuoAttention sits between.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.benchmarks.common import (SEQ, W_LOCAL, _payload_accuracy,
                                           cache_size_at, device_of,
                                           needle_accuracy, needle_batch,
                                           trained_model)
from repro_torch.core.baselines import (duo_attention_gates,
                                        identify_retrieval_heads,
                                        local_attention_gates)
from repro_torch.device import DeviceLike
from repro_torch.models import transformer as T


def _acc_with_override(cfg, params, override, n=32, seed=777, batch=None):
    b = needle_batch(seed, n, device_of(params), batch)
    out = T.forward(params, cfg, b["tokens"], mode="hard",
                    gate_override=override)
    return _payload_accuracy(out.logits, b)


def _duo_overrides(cfg, params, ratio, b, calib=None):
    """One DuoAttention policy per attention layer ([L, B, H, S]), its
    heads ranked by the learned gate on calibration data (seed 5)."""
    calib = needle_batch(5, 8, device_of(params), calib)
    gout = T.forward(params, cfg, calib["tokens"], mode="gated")
    return torch.stack([
        duo_attention_gates(b, identify_retrieval_heads(g, ratio), SEQ,
                            sink=2) for g in gout.gates])


@torch.no_grad()
def run(device: DeviceLike = None, batches=None):
    """``batches``: seed -> the needle batch that seed draws (777 the
    accuracies', 778 the cache sizes', 5 the calibration's); a seed not
    in it is drawn on the device."""
    batches = batches or {}
    batch = batches.get(777)
    cfg, params = trained_model(device=device)
    dev = device_of(params)
    rows = []
    # --- WG-KV: sweep binarization threshold tau ------------------------
    for tau in (0.02, 0.1, 0.3, 0.6, 0.9):
        c2 = cfg.replace(wgkv=dataclasses.replace(cfg.wgkv, tau=tau))
        acc = needle_accuracy(c2, params, mode="hard", batch=batch)
        size = cache_size_at(cfg, params, tau, batch=batches.get(778))
        rows.append((f"fig7/wgkv_tau{tau}", 0.0,
                     f"cache={size:.3f},acc={acc:.3f}"))
    # --- Local Attention: sweep window ----------------------------------
    b = 32
    for window in (24, 48, 96):
        ov = local_attention_gates(b, cfg.n_kv_heads, SEQ, sink=2, device=dev)
        c2 = cfg.replace(wgkv=dataclasses.replace(cfg.wgkv, w_local=window))
        acc = _acc_with_override(c2, params, ov, n=b, batch=batch)
        rows.append((f"fig7/local_w{window}", 0.0,
                     f"cache={(window + 2) / SEQ:.3f},acc={acc:.3f}"))
    # --- DuoAttention: sweep retrieval-head ratio ------------------------
    # profile heads with the learned gate on calibration data
    for ratio in (0.25, 0.5, 0.75):
        ov = _duo_overrides(cfg, params, ratio, b, batches.get(5))
        acc = _acc_with_override(cfg, params, ov, n=b, batch=batch)
        size = ratio + (1 - ratio) * (W_LOCAL + 2) / SEQ
        rows.append((f"fig7/duo_r{ratio}", 0.0,
                     f"cache={size:.3f},acc={acc:.3f}"))
    return rows
