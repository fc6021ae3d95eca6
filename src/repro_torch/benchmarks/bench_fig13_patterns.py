"""Fig. 13 (Appendix H) — input-dependent admission patterns (port of
``benchmarks/bench_fig13_patterns.py``).

Per-(layer, head) normalized cache size on two different tasks (uniform
zipf stream vs structured copy task). Input dependence = the per-head
admission profile changes with the task (low cross-task correlation /
different mean sparsity), unlike any static policy."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.benchmarks.common import (SEQ, VOCAB, device_of, on_device,
                                           trained_model)
from repro_torch.data.synthetic import copy_task, token_stream
from repro_torch.device import DeviceLike
from repro_torch.models import transformer as T


@torch.no_grad()
def _per_head_sizes(cfg, params, toks):
    toks = on_device(toks, device_of(params))
    out = T.forward(params, cfg, toks, mode="gated")
    adm = (out.gates >= cfg.wgkv.tau).float().mean(dim=(1, 3))  # [L_attn, H]
    return adm.cpu().numpy()


def task_tokens(device, seed: int = 3):
    """(the zipf stream [8, SEQ], the copy task's tokens [8, SEQ]), both
    drawn from one generator seeded ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    stream = token_stream(gen, 8, SEQ, VOCAB)
    copy = copy_task(gen, 8, 24, SEQ - 26, VOCAB)["tokens"]
    return stream, copy


def run(device: DeviceLike = None, tokens=None):
    """``tokens``: (stream, copy) token arrays (drawn on the device from
    seed 3 when None)."""
    cfg, params = trained_model(device=device)
    stream, copy = tokens if tokens is not None else task_tokens(
        device_of(params))
    a = _per_head_sizes(cfg, params, stream)
    b = _per_head_sizes(cfg, params, copy)
    corr = float(np.corrcoef(a.ravel(), b.ravel())[0, 1])
    rows = [
        ("fig13/stream_mean_admission", 0.0, f"{a.mean():.3f}"),
        ("fig13/copy_mean_admission", 0.0, f"{b.mean():.3f}"),
        ("fig13/head_variance_stream", 0.0, f"{a.std():.3f}"),
        ("fig13/head_variance_copy", 0.0, f"{b.std():.3f}"),
        ("fig13/cross_task_head_correlation", 0.0, f"{corr:.3f}"),
        ("fig13/task_delta_mean_abs", 0.0, f"{np.abs(a - b).mean():.3f}"),
    ]
    return rows
