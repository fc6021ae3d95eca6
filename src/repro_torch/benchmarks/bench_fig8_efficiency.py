"""Fig. 8 / Fig. 15 — system efficiency at 75% sparsity vs full attention
(port of ``benchmarks/bench_fig8_efficiency.py``).

The paper (Appendix I.3) runs the full forward with the Write-Gate MLP and
overrides the admission decisions with a random mask at the target
sparsity. The reference draws such a mask (``_rand_gates``) but never
passes it to ``prefill``, and neither does this port: the only sparsity
is the budget's cap, S / 4 global slots per kv head, on the model's own
gate (random-init gates admit nearly every token). Each prefill row
reports the measured ``mean_admission`` beside its time.

Per S: the budgeted vertical-slash prefill (WG-KV) against the dense
causal prefill, a decode step from each one's caches, and the resident
cache bytes (the memory claim); then the kernel row, ``gated_flash`` at
[1, 4 / 2, 1024, 64] with W 64. Each timed row carries the kernel
launches per call (zero on the CPU, where the plain versions run).

The port's dense buffer is ``attention.dense_len(S + 8)``, S + 8 rounded
up to a 16-token page, where the reference's is S + 8: the row reports
the port's bytes and those of an S + 8 buffer, and a reduction against
each.

    PYTHONPATH=src python -m repro_torch.benchmarks.bench_fig8_efficiency \\
        --arch qwen3-0.6b [--device cuda]

runs the same method at full width (f32, weights drawn from seed 0);
without ``--arch`` it runs the reference's ``bench_cfg`` model.
"""
from __future__ import annotations

import argparse
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.benchmarks.common import (bench_cfg, device_label,
                                           device_of, kernel_counters,
                                           on_device, timeit)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import inference as I
from repro_torch.models import transformer as T
from repro_torch.tree import tree_leaves, tree_leaves_with_path

SPARSITY = 0.75


def cache_bytes(caches) -> int:
    return sum(leaf.numel() * leaf.element_size()
               for leaf in tree_leaves(caches))


def unpadded_bytes(caches, max_len: int) -> int:
    """The dense tree's bytes with every K / V buffer cut to ``max_len``
    slots (the reference's buffer length)."""
    tot = 0
    for path, leaf in tree_leaves_with_path(caches):
        n = leaf.numel() * leaf.element_size()
        if path[-1] in ("k", "v"):
            n = n // leaf.shape[-2] * max_len
        tot += n
    return tot


def _timed(fn, *args, iters: int):
    """(median µs per call, launches per call of each kernel launched),
    read from the counters' growth: a caller's own count goes on. Each
    kernel's growth must be a whole number of launches per call."""
    counters = kernel_counters()
    before = [c.count for c in counters]
    us = timeit(fn, *args, iters=iters)
    calls = 1 + iters
    grown = {c.name: c.count - n for c, n in zip(counters, before)
             if c.count > n}
    uneven = {k: n for k, n in grown.items() if n % calls}
    if uneven:
        raise RuntimeError(f"launches {uneven} over {calls} calls are not "
                           "the same in every call")
    return us, {k: n // calls for k, n in grown.items()}


def _launch_str(counts: Dict[str, int]) -> str:
    return ";".join(f"{k}:{v}" for k, v in sorted(counts.items())) or "none"


def prefills(params, cfg, toks, budget: int):
    """(dense out, dense caches, WG-KV out, dual caches) of one prompt."""
    s = toks.shape[1]
    full = I.prefill(params, cfg, toks, use_wgkv=False, max_len=s + 8)
    wgkv = I.prefill(params, cfg, toks, use_wgkv=True, budget=budget)
    return full + wgkv


@torch.no_grad()
def measure(cfg, params, sizes: Sequence[int], sparsity: float = SPARSITY,
            *, tokens: Optional[Dict[int, np.ndarray]] = None) -> List[dict]:
    """For each S of ``sizes`` (prompts of [1, S] drawn from seed 0, or
    ``tokens[S]``; budget ``S * (1 - sparsity)``): ``{"s", "prefill_full",
    "prefill_wgkv", "decode_full", "decode_wgkv"}``, each timed entry
    ``{"us", "launches"}`` (launches per call of each kernel), with
    ``"mean_admission"`` and the bytes ``{"full", "wgkv", "full_at_s+8"}``
    beside them."""
    dev = device_of(params)
    out = []
    for s in sizes:
        if tokens is not None:
            toks = on_device(tokens[s], dev)
        else:
            gen = torch.Generator(device=dev).manual_seed(0)
            toks = torch.randint(0, cfg.vocab_size, (1, s), generator=gen,
                                 device=dev)
        budget = int(s * (1 - sparsity))
        m = {"s": s}

        def timed(name, fn, *args, iters):
            us, launches = _timed(fn, *args, iters=iters)
            m[name] = {"us": us, "launches": launches}

        # ---- prefill: full dense vs budgeted vertical-slash -------------
        def pf_full(p, t):
            return I.prefill(p, cfg, t, use_wgkv=False, max_len=s + 8)[0]

        def pf_wgkv(p, t):
            return I.prefill(p, cfg, t, use_wgkv=True, budget=budget)[0]
        timed("prefill_full", pf_full, params, toks, iters=3)
        timed("prefill_wgkv", pf_wgkv, params, toks, iters=3)
        _, dense_c, wgkv_out, dual_c = prefills(params, cfg, toks, budget)
        m["mean_admission"] = float(wgkv_out.mean_admission)

        # ---- decode: dense cache vs dual cache ---------------------------
        tok = torch.zeros((1,), dtype=torch.int32, device=dev)

        def dec(p, t, c):
            return I.decode_step(p, cfg, t, c)[0]
        timed("decode_full", dec, params, tok, dense_c, iters=5)
        timed("decode_wgkv", dec, params, tok, dual_c, iters=5)

        # ---- memory: resident cache bytes --------------------------------
        m["bytes"] = {"full": cache_bytes(dense_c),
                      "wgkv": cache_bytes(dual_c),
                      "full_at_s+8": unpadded_bytes(dense_c, s + 8)}
        del dense_c, dual_c
        out.append(m)
    return out


def rows_of(m: dict) -> List[tuple]:
    """The figure's CSV rows of one S of ``measure``."""
    s, b = m["s"], m["bytes"]
    t_full, t_wgkv = m["prefill_full"]["us"], m["prefill_wgkv"]["us"]
    t_dfull, t_dwg = m["decode_full"]["us"], m["decode_wgkv"]["us"]

    def launches(name):
        return f"launches={_launch_str(m[name]['launches'])}"
    return [
        (f"fig8/prefill_full_s{s}", t_full, launches("prefill_full")),
        (f"fig8/prefill_wgkv_s{s}", t_wgkv,
         f"speedup={t_full / t_wgkv:.2f}x,"
         f"mean_admission={m['mean_admission']:.6f},"
         + launches("prefill_wgkv")),
        (f"fig8/decode_full_s{s}", t_dfull, launches("decode_full")),
        (f"fig8/decode_wgkv_s{s}", t_dwg,
         f"speedup={t_dfull / t_dwg:.2f}x," + launches("decode_wgkv")),
        (f"fig8/cache_bytes_s{s}", 0.0,
         f"full={b['full']},wgkv={b['wgkv']},"
         f"reduction={1 - b['wgkv'] / b['full']:.2%},"
         f"full_at_s+8={b['full_at_s+8']},"
         f"reduction_vs_s+8={1 - b['wgkv'] / b['full_at_s+8']:.2%}")]


def efficiency(cfg, params, sizes: Sequence[int], sparsity: float = SPARSITY,
               *, tokens: Optional[Dict[int, np.ndarray]] = None
               ) -> List[tuple]:
    """The figure's rows for each S of ``sizes`` (``measure``'s
    arguments)."""
    return [r for m in measure(cfg, params, sizes, sparsity, tokens=tokens)
            for r in rows_of(m)]


@torch.no_grad()
def kernel_row(device: torch.device) -> tuple:
    """``gated_flash_attention`` at [1, 4 / 2, 1024, 64], W 64."""
    from repro_torch.kernels.ops import gated_flash_attention

    b, hq, hkv, s, hd = 1, 4, 2, 1024, 64
    gen = torch.Generator(device=device).manual_seed(0)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=device)
    q, k, v = normal(b, hq, s, hd), normal(b, hkv, s, hd), normal(b, hkv, s, hd)
    g = torch.sigmoid(normal(b, hkv, s))
    us, launches = _timed(
        lambda: gated_flash_attention(q, k, v, g, w_local=64, eps=1e-6),
        iters=3)
    return ("fig8/kernel_gated_flash_s1024", us,
            f"{device_label(device)},launches={_launch_str(launches)}")


def run(device: DeviceLike = None):
    dev = resolve_device(device)
    cfg = bench_cfg(w_local=64, global_budget_frac=1 - SPARSITY)
    params = T.init_model(cfg, torch.Generator(device=dev).manual_seed(0),
                          dev)
    return efficiency(cfg, params, (1024, 2048, 4096)) + [kernel_row(dev)]


def main(argv=None) -> int:
    from repro_torch.configs import ARCH_NAMES, get_config

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.benchmarks.bench_fig8_efficiency")
    ap.add_argument("--arch", default=None, choices=ARCH_NAMES,
                    help="run the method at this arch's width (f32)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain PyTorch path)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print(device_label(dev))
    print("name,us_per_call,derived")
    if args.arch is None:
        rows = run(dev)
    else:
        cfg = get_config(args.arch).replace(dtype="float32")
        params = T.init_model(cfg, torch.Generator(device=dev).manual_seed(0),
                              dev)
        rows = efficiency(cfg, params, (1024, 2048, 4096))
    for name, us, derived in rows:
        print(f"{name},{us:.1f},{derived}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
