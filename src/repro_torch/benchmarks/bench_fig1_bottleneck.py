"""Fig. 1 — attention dominates long-context inference (port of
``benchmarks/bench_fig1_bottleneck.py``).

Measures (a) prefill latency split attention vs. non-attention as seq
grows, (b) decode latency vs. resident cache size, on the tiny bench
model; the quadratic-vs-linear scaling trend is the claim.
"""
from __future__ import annotations

import torch

from repro_torch.benchmarks.common import bench_cfg, device_of, timeit
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import inference as I
from repro_torch.models import layers as L
from repro_torch.models import transformer as T


def _tokens(seed: int, s: int, vocab: int, device) -> torch.Tensor:
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(0, vocab, (1, s), generator=gen, device=device)


@torch.no_grad()
def run(device: DeviceLike = None):
    dev = resolve_device(device)
    cfg = bench_cfg()
    params = T.init_model(cfg, torch.Generator(device=dev).manual_seed(0),
                          dev)
    rows = []
    prev = None
    for s in (256, 512, 1024, 2048):
        toks = _tokens(1, s, cfg.vocab_size, dev)

        def full(p, t):
            return T.forward(p, cfg, t, mode="teacher").logits
        t_full = timeit(full, params, toks)
        # "non-attention" estimate: the embed + FFN + unembed path alone
        t_mlp = timeit(_mlp_only, params, cfg, toks)
        frac = max(0.0, 1.0 - t_mlp / t_full)
        rows.append((f"fig1/prefill_s{s}", t_full, f"attn_frac={frac:.2f}"))
        if prev is not None:
            rows.append((f"fig1/prefill_scaling_s{s}", t_full,
                         f"x{t_full / prev:.2f}_vs_half_seq"))
        prev = t_full
    # decode: latency vs cache length (memory-bound trend)
    for s in (512, 2048):
        caches = _dense_caches(cfg, params, s)
        tok = torch.zeros((1,), dtype=torch.int32, device=dev)

        def step(p, t, c):
            return I.decode_step(p, cfg, t, c)[0]
        t_dec = timeit(step, params, tok, caches)
        rows.append((f"fig1/decode_cache{s}", t_dec, f"cache_tokens={s}"))
    return rows


def _mlp_only(params, cfg, toks):
    """Every repeat's ``x + swiglu(rmsnorm(x))`` between the embedding and
    the unembedding: the model with its attention removed."""
    x = L.embed(params["embed"], toks, torch.float32)
    for lp in T.layer_params(params, cfg):
        b0 = lp["b0"]
        x = x + L.swiglu(b0["mlp"], L.rmsnorm(b0["ln2"], x))
    return L.unembed(params["embed"], x)


def _dense_caches(cfg, params, s):
    toks = _tokens(2, s, cfg.vocab_size, device_of(params))
    _, caches = I.prefill(params, cfg, toks, use_wgkv=False, max_len=s + 16)
    return caches
