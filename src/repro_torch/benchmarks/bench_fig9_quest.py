"""Fig. 9 — composability with read-time Selection (Quest) (port of
``benchmarks/bench_fig9_quest.py``).

"Quest only" (selection over the full admitted cache, frac=1.0) vs
"WG-KV + Quest" (selection over the admission-compressed cache). The
paper's claim: the curves overlap — tokens WG-KV drops are ones Quest
would not have selected anyway. We measure needle accuracy as a function
of page budget against the same decode without selection.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.benchmarks.common import (SEQ, device_of, needle_batch,
                                           trained_model)
from repro_torch.device import DeviceLike
from repro_torch.models import inference as I


def decode_payload(cfg, params, opts, b, *, budget: int):
    """Prefill the needle prompts up to a window-aligned point before the
    query, decode through the query, and return the greedy predictions
    of the 2 payload tokens [n, 2] and the final caches."""
    toks = b["tokens"]
    qpos = b["query_pos"]
    npre = (qpos + 1) - (qpos + 1) % cfg.wgkv.w_local
    _, caches = I.prefill(params, cfg, toks[:, :npre], budget=budget,
                          opts=opts)
    preds, trig = [], 0.0
    for t in range(npre, qpos + 3):
        logits, caches, st = I.decode_step(params, cfg, toks[:, t], caches,
                                           opts=opts)
        trig += float(st["evict_triggers"])
        if t >= qpos:
            preds.append(logits.argmax(-1).cpu().numpy())
    return np.stack(preds[:2], 1), caches, trig


@torch.no_grad()
def _decode_acc(cfg, params, opts, n=16, seed=881, batch=None):
    """Prefill up to the query, decode the 2 payload tokens."""
    b = needle_batch(seed, n, device_of(params), batch)
    pred, _, _ = decode_payload(cfg, params, opts, b,
                                budget=cfg.wgkv.global_budget(SEQ))
    return float((pred == b["answer"].cpu().numpy()).mean())


def run(device: DeviceLike = None):
    cfg, params = trained_model(device=device)
    batch = needle_batch(881, 16, device_of(params))
    rows = []
    for label, frac in (("quest_only", 1.0), ("wgkv+quest", 0.5)):
        # fracs chosen so the global budget stays 16-token page-aligned
        c2 = cfg.replace(wgkv=dataclasses.replace(
            cfg.wgkv, global_budget_frac=frac,
            tau=0.1 if frac < 1.0 else -1.0))  # tau=-1 => admit all
        base = _decode_acc(c2, params, I.DecodeOptions(), batch=batch)
        for pages in (1, 2, 4, 8):
            acc = _decode_acc(c2, params, I.DecodeOptions(quest_pages=pages),
                              batch=batch)
            rows.append((f"fig9/{label}_pages{pages}", 0.0,
                         f"acc={acc:.3f},noselect_acc={base:.3f}"))
    return rows
