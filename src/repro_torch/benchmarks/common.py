"""Shared benchmark substrate (port of ``benchmarks/common.py``): a tiny
needle-retrieval model with distilled write gates, the stand-in for
Llama-3.1-8B + FineWeb in an offline container.

``trained_model(0.15)`` loads the committed
``checkpoints/bench_model_lam0.15.npz`` (the reference's weights, through
``convert.params_from_numpy``). For a lambda with no committed file it
pre-trains and distills as the reference does, once, into the git-ignored
``build/bench/``. Every draw comes from a ``torch.Generator`` seeded with
the reference's seed, on the device the model lives on; that cannot
reproduce ``jax.random``'s bits, so each helper that draws also takes the
batch (numpy or tensors), and a test hands both packages the same one.
"""
from __future__ import annotations

import functools
import os
import subprocess
import time
from pathlib import Path
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, WGKVConfig
from repro_torch.convert import params_from_numpy
from repro_torch.data.synthetic import lm_loss, needle_task
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import transformer as T
from repro_torch.training import checkpoint as C
from repro_torch.training import trainer as TR
from repro_torch.training.optimizer import (adamw_init, adamw_update,
                                            cosine_schedule)
from repro_torch.tree import tree_leaves, tree_map

REPO = Path(__file__).resolve().parents[3]
CHECKPOINTS = REPO / "checkpoints"
ART = REPO / "build" / "bench"
VOCAB = 256
SEQ = 128      # needles live in the first 55% => always > W_LOCAL from the query
W_LOCAL = 16


def bench_cfg(**wg) -> ModelConfig:
    wk = dict(enabled=True, w_local=W_LOCAL, tau=0.1, gate_hidden=32,
              global_budget_frac=1.0, sink=2, lam=0.1)
    wk.update(wg)
    return ModelConfig(
        name="bench-tiny", arch_type="dense", d_model=128, n_heads=4,
        n_kv_heads=2, head_dim=32, d_ff=256, vocab_size=VOCAB,
        block_pattern=("attn",), n_repeats=2, rope_theta=10000.0,
        dtype="float32", wgkv=WGKVConfig(**wk))


def device_of(params) -> torch.device:
    return tree_leaves(params)[0].device


def on_device(x, device) -> torch.Tensor:
    """A tensor (on any device) or an array (numpy, or anything
    ``np.array`` takes) as a tensor on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.as_tensor(np.array(x)).to(device)


def needle_batch(seed: int, n: int, device, batch=None
                 ) -> Dict[str, torch.Tensor]:
    """``needle_task(seed, n, SEQ, VOCAB, payload=2)`` on ``device``, or
    ``batch`` (the same keys, numpy or tensors) moved there."""
    if batch is None:
        gen = torch.Generator(device=device).manual_seed(seed)
        return needle_task(gen, n, SEQ, VOCAB, payload=2)
    return {k: int(v) if k == "query_pos" else on_device(v, device)
            for k, v in batch.items()}


def _lm_step(params, opt, loss_fn, *, lr, weight_decay: float):
    """One AdamW step on every parameter of ``loss_fn(params)``."""
    leaves = tree_map(lambda v: v.detach().requires_grad_(), params)
    with torch.enable_grad():
        loss = loss_fn(leaves)
        grads = iter(torch.autograd.grad(loss, tree_leaves(leaves)))
    grads = tree_map(lambda _: next(grads), params)
    params, opt = adamw_update(grads, opt, params, lr=lr,
                               weight_decay=weight_decay)
    return params, opt, loss.detach()


def _pretrain(cfg: ModelConfig, steps: int = 2000,
              device: DeviceLike = None) -> Dict:
    """Train the teacher until induction-head retrieval emerges (the
    circuit needs ~1-2k steps at this scale; weight decay off helps)."""
    dev = resolve_device(device)
    params = T.init_model(cfg, torch.Generator(device=dev).manual_seed(0),
                          dev)
    opt = adamw_init(params)
    lr = cosine_schedule(2e-3, steps)
    gen = torch.Generator(device=dev)
    for i in range(steps):
        b = needle_task(gen.manual_seed(i + 1), 16, SEQ, VOCAB, payload=2)

        def loss_fn(p, b=b):
            logits = T.forward(p, cfg, b["tokens"], mode="teacher").logits
            return (lm_loss(logits, b["tokens"])
                    + 4.0 * lm_loss(logits, b["tokens"], b["loss_mask"]))
        params, opt, _ = _lm_step(params, opt, loss_fn, lr=float(lr(i)),
                                  weight_decay=0.0)
    return params


def _distill(cfg: ModelConfig, params, lam: float, steps: int = 150,
             batches=None):
    """Gate distillation on needle batches (4 x SEQ, seeds 10,000 + i), or
    on ``batches[i]`` (token arrays) where given."""
    dev = device_of(params)
    state = TR.init_train_state(params)
    step = TR.make_train_step(cfg, lr=cosine_schedule(2e-3, steps), lam=lam)
    gen = torch.Generator(device=dev)
    m = None
    for i in range(steps):
        if batches is not None:
            toks = on_device(batches[i], dev)
        else:
            toks = needle_task(gen.manual_seed(10_000 + i), 4, SEQ, VOCAB,
                               payload=2)["tokens"]
        state, m = step(state, params, batch={"tokens": toks})
    return TR.set_gates(params, state.gates), m


@functools.lru_cache(maxsize=2)
def trained_model(lam: float = 0.15, device: DeviceLike = None
                  ) -> Tuple[ModelConfig, Dict]:
    """Teacher + distilled gates: the committed checkpoint for this
    lambda, else one trained here and kept under ``build/bench/``."""
    dev = resolve_device(device)
    cfg = bench_cfg(lam=lam)
    name = f"bench_model_lam{lam}.npz"
    for path in (CHECKPOINTS / name, ART / name):
        if path.exists():
            return cfg, params_from_numpy(str(path), cfg, dev)
    params = _pretrain(cfg, device=dev)
    params, _ = _distill(cfg, params, lam)
    os.makedirs(ART, exist_ok=True)
    C.save(str(ART / name), params,
           meta={"lam": lam, "vocab": VOCAB, "seq": SEQ})
    return cfg, params


def _payload_accuracy(logits: torch.Tensor, b) -> float:
    qpos = b["query_pos"]
    pred = logits[:, qpos:qpos + 2].argmax(-1)
    return float((pred.cpu() == b["answer"].cpu()).float().mean())


def needle_accuracy(cfg: ModelConfig, params, *, mode: str = "hard",
                    n: int = 32, seed: int = 777, batch=None) -> float:
    b = needle_batch(seed, n, device_of(params), batch)
    out = T.forward(params, cfg, b["tokens"], mode=mode)
    return _payload_accuracy(out.logits, b)


def cache_size_at(cfg: ModelConfig, params, tau: float, n: int = 16,
                  seed: int = 778, batch=None) -> float:
    """Mean normalized KV cache size (admitted + window) / full."""
    b = needle_batch(seed, n, device_of(params), batch)
    out = T.forward(params, cfg, b["tokens"], mode="gated")
    adm = (out.gates >= tau).float().mean()
    return float(min(float(adm) + cfg.wgkv.w_local / SEQ, 1.0))


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def timeit(fn, *args, warmup: int = 1, iters: int = 5) -> float:
    """Median wall time per call in microseconds (waiting for the card)."""
    for _ in range(warmup):
        fn(*args)
        _sync()
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(*args)
        _sync()
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts) * 1e6)


def kernel_counters():
    """Every kernel wrapper's launch counter (``build.LaunchCounter``)."""
    from repro_torch.kernels import (gate_mlp, gated_flash, paged_decode,
                                     rglru_scan, vertical_slash)
    return [gate_mlp.launches, paged_decode.launches,
            paged_decode.selected_launches, vertical_slash.launches,
            gated_flash.launches, rglru_scan.launches,
            gate_mlp.bwd_launches, gated_flash.bwd_launches,
            rglru_scan.bwd_launches, gated_flash.window_launches,
            paged_decode.start_launches]


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    if not out:
        raise RuntimeError("nvidia-smi printed nothing")
    return out[0].strip()


def device_label(device: torch.device) -> str:
    """What a row was measured on: the card line, or the CPU."""
    return card_line() if device.type == "cuda" else "cpu (plain PyTorch)"
