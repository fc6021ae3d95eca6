#!/usr/bin/env python3
"""On-card smoke run of the PyTorch + CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one NVIDIA GPU (Hopper, sm_90a) and ``nvcc``; exits non-zero, and
prints no result, without them. Phases, any failure fatal:

  1. device   — the card's name and power limit (nvidia-smi).
  2. build    — the kernels from ``src/repro_torch/csrc`` (nine entry
                points in eight sources: the six forward kernels and the
                backward kernels of ``gate_mlp``, ``gated_flash`` and
                ``rglru_scan``), one nvcc per source, all started together.
  3. kernels  — each CUDA kernel against its plain PyTorch version on the
                card, at the main paths' shapes (qwen3-0.6b's and
                recurrentgemma-9b's, and a larger or smaller one), f32 and
                bf16 for the attention kernels; the forward kernels also at
                the odd GQA groups of the dense archs (15 / 5 at hd 64, 24 /
                8 and 40 / 10 at hd 128: their serve and offline decode,
                gate, S 4096 prefill and tau probe shapes), with times
                (CUDA events, and the device time of the same calls
                replayed from a CUDA graph; for ``paged_decode`` also each
                of its two kernels' time under torch.profiler), the plain
                version's time, a library yardstick where one exists, and
                the card's bound at the rate of the kernel's arithmetic;
                ``paged_decode_selected`` also bitwise against
                ``paged_decode`` at the identity ids, and two calls of
                ``paged_decode``, ``vertical_slash``, ``gated_flash``,
                ``gate_mlp`` and ``rglru_scan`` bitwise equal.
  4. serve-cli  — ``repro_torch.launch.serve`` at full qwen3-0.6b width,
                its startup tau probe (a gated forward) included.
  5. serve-long — ``ServeSession`` at full width with 384-token prompts,
                so tokens leave the 256-token ring and lazy promotion
                runs; launch counters prove the decode kernels carried it.
  6. prefill-long  — ``inference.prefill`` (budgeted vertical-slash, paper
                §4.2) of a 4096-token prompt at full width, budget 1024,
                then 16 greedy ``decode_step``s from its dual caches.
  7. decode-select — from prefill-long's caches (C = 1024), 16 greedy
                ``decode_step``s with Quest selection: ``quest:64`` (every
                page) bitwise equal to selection off, ``quest:8`` through
                ``paged_decode_selected`` only, and mask mode
                (``quest_pages=8``) within 5e-5 of ``quest:8``.
  8. forward-gated — ``transformer.forward(mode="gated")`` at full width
                over 2048 tokens (the write-gated training forward).
  9. serve-compose — ``ServeSession`` at full width (depth cut to 14
                layers) with ``quest:2`` decode selection and SnapKV
                eviction (budget 96): both run, and the paged pool stays
                within 2e-3 after an eviction.
 10. substrate — the trained bench substrate
                (``checkpoints/bench_model_lam0.15.npz``): one numpy
                prompt through prefill + 16 greedy decode steps on the card
                (kernels) and on the CPU (plain path), once plain and once
                with ``quest:2`` and eviction; tokens and integer cache
                state must be identical, logits within 1e-4.
 11. rg-serve — ``repro_torch.launch.serve --arch recurrentgemma-9b`` at
                full width (38 layers: a 2-block RG-LRU stem and 12 x
                (RG-LRU, RG-LRU, local attention), d_model 4096, f32), 2
                requests of 64 tokens, 8 new tokens, the tau probe.
 12. rg-prefill — ``inference.prefill`` of a 4096-token prompt through the
                full-width hybrid (budget 1024, ring 2048): 26
                ``rglru_scan`` and 12 ``vertical_slash`` launches; then 16
                greedy decode steps.
 13. rg-forward — ``transformer.forward(mode="gated")`` of the hybrid over
                4096 tokens: 26 ``rglru_scan`` and 12 ``gated_flash``.
 14. rg-substrate — the reduced hybrid with its 2-block stem (S 128,
                window 32) through prefill + 8 greedy steps on the card and
                on the CPU: identical tokens and integer cache state,
                logits and recurrent states within 1e-4.

The baselines and the prefix store (run after phase 10, before the
recurrentgemma phases):

  prefill-dense — ``inference.prefill(use_wgkv=False)`` of prefill-long's
                4,096-token prompt at full width and depth (28
                ``gated_flash`` launches at W = S, g = 1) and 16 greedy
                dense decode steps (28 one-segment ``paged_decode`` each),
                beside prefill-long's WG-KV numbers.
  serve-ab    — ``ServeSession`` at full width, depth cut to 14 of 28
                layers: 2 x 384-token prompts, 16 new tokens, through
                ``wgkv`` and ``dense``, and one of them through
                ``streaming_llm`` and ``duo``; TTFT, TPOT, tokens/s, the
                KV-token peak and KV bytes per backend. ``dense`` runs
                ``paged_decode`` only, the static backends never the gate;
                the paged backends' pools verify.
  prefix      — a multi-turn replay (depth cut to 4 layers): 2
                conversations x 2 turns through the prefix store for
                ``wgkv`` and ``dense``; hit streams equal cold streams, hits
                happen, a hit row's pool verifies, and every page is
                reclaimed once the store is cleared.
  substrate-ab — the trained substrate served by ``dense``,
                ``streaming_llm`` and ``duo`` on the card and on the CPU:
                identical streams, KV tokens per tick and integer cache
                state.

Gate-distillation training (run after substrate-ab):

  train       — ``repro_torch.launch.train --arch qwen3-0.6b --steps 4
                --batch 2 --seq 2048`` at full width and depth (28
                layers, f32, a seeded random backbone): per step wall
                time, loss, distill, admission and peak memory; 28
                launches per step of each of ``gated_flash``,
                ``gated_flash_bwd``, ``gate_mlp`` and ``gate_mlp_bwd``;
                the backbone bitwise unchanged, the gates moved.
  train-substrate — three ``train_step``s of the trained substrate on the
                card and on the CPU from the same numpy tokens: losses and
                aux within 1e-4 relative, the first step's gate gradients
                within 1e-4 of each tensor's largest magnitude.

Training the hybrid, and the dense archs smollm-360m, phi4-mini-3.8b and
phi3-medium-14b (run after rg-substrate):

  rg-train    — ``repro_torch.launch.train --arch recurrentgemma-9b
                --steps 3 --batch 1 --seq 4096`` at full width and depth
                (38 layers, f32; S past the 2,048 window, so distill is
                not 0): per step wall time, loss and peak memory (under 80
                GB); per step 12 launches each of ``gated_flash`` (hd 256),
                ``gated_flash_bwd``, ``gate_mlp`` (F 512) and
                ``gate_mlp_bwd``, 52 of ``rglru_scan`` (student and
                teacher) and 22 of ``rglru_scan_bwd`` (the RG-LRU layers
                after the first gate; the four before it get no gradient);
                one more step under torch.profiler.
  rg-train-substrate — three ``train_step``s of the reduced hybrid (a
                2-block stem and two repeats, so RG-LRU blocks follow a
                gate) on the card and on the CPU from the same numpy
                tokens: losses and aux within 1e-4 relative, the first
                step's gate gradients within 1e-4 of each tensor's max,
                ``remat=True`` bitwise on the card.
  dense-arch  — for each of the three dense archs at full width (f32,
                seeded random weights; G 3 at hd 64 and 128, G 4, the
                untied head of phi3-medium-14b, 54.6 GiB): ``launch.serve``
                (2 x 64-token prompts, 8 new, 2 slots, capacity 512, the
                tau probe; the pool within 2e-3), ``inference.prefill`` of
                4,096 tokens at budget 1,024 and 16 greedy steps, then the
                reduced config (smollm-360m's G 3 at hd 80) on card and
                CPU: the gated forward and the greedy streams, integer
                cache state exact, logits within 1e-4.
  smollm-train — ``repro_torch.launch.train --arch smollm-360m --steps 2
                --batch 2 --seq 2048``: ``gated_flash_bwd`` at G 3.

Phase 3 also holds the three backward kernels against their plain
versions and against autograd of the forward's plain version (1e-4 of
each gradient's largest magnitude), at the train phases' shapes
(recurrentgemma-9b's hd 256 and F 512 and the scan at [1, 4096, 4096]
included) and the substrate's, two calls bitwise equal, and each fault of
``BWD_FAULTS`` planted alone in a rebuild that must read above that
limit. It also holds the dense read (one ``paged_decode`` segment over a
contiguous buffer) and the causal ``gated_flash`` at those paths' shapes
against their plain versions, and ``paged_decode``, ``gate_mlp``,
``vertical_slash`` and ``gated_flash`` at the dense archs' groups of 3
and 4.

Each full-width model (32 GiB for recurrentgemma-9b in f32, 54.6 GiB for
phi3-medium-14b) is freed before the next is built. The full-width
weights are random (seeded);
the point is that the port runs end to end on the card through its
kernels and agrees with itself: the paged physical pool matches the
logical cache (< 2e-3), every request
completes, every logit is finite, and on trained weights the card and the
CPU agree. The launch counts of each main path are set to 0 just before
it and read just after. Any failed check raises, and the script exits
non-zero. The last two lines are the ``kernels`` JSON and the ``ok`` JSON.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

H100_BYTES_PER_S = 3.35e12      # HBM3, SXM data sheet
H100_F32_FLOPS = 67e12          # float32 outside the tensor cores
H100_BF16_FLOPS = 989e12        # dense bf16 tensor cores
H100_TF32_FLOPS = 495e12        # dense TF32 tensor cores
# the f32 arithmetic of the tensor-core kernels: 3xTF32, three TF32
# products per product
H100_3XTF32_FLOPS = H100_TF32_FLOPS / 3
INT32_MAX = 2 ** 31 - 1
PEAK = {"float32": H100_F32_FLOPS, "bfloat16": H100_BF16_FLOPS}
# the prefill attention kernels' arithmetic: f32 in 3xTF32 (three TF32
# products per product), bf16 on the bf16 tensor cores
ATTN_RATE = {"float32": (H100_3XTF32_FLOPS,
                         "3xTF32 tensor cores, 495/3 TFLOP/s"),
             "bfloat16": (H100_BF16_FLOPS, "bf16 tensor cores, 989 TFLOP/s")}
# max abs error of an attention kernel against its plain version: both
# compute in f32 in different orders; in bf16 both round the output, so
# they may differ by an ulp of an output (2**-9 under 0.5). A pair of
# elements swapped or dropped in the bf16 load reads far above 1e-2
# (tests/test_torch_cuda.py plants both).
TOL = {"float32": 5e-5, "bfloat16": 1e-2}
# the dense archs' heads: (q heads, kv heads, head_dim)
DENSE_HEADS = {"smollm-360m": (15, 5, 64), "phi4-mini-3.8b": (24, 8, 128),
               "phi3-medium-14b": (40, 10, 128)}


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    check(bool(out), "nvidia-smi printed nothing")
    return out[0].strip()


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def graph_ms(fn, iters: int) -> float | None:
    """Device time per call: ``iters`` calls captured in one CUDA graph and
    replayed, so the host's dispatch of each call (Python, checks, the
    launch itself) is not in the time that ``cuda_ms`` reads. None, with
    the reason printed, if the calls cannot be captured."""
    import torch
    try:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(3):
                fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(iters):
                fn()
        graph.replay()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(5):
            graph.replay()
        stop.record()
        torch.cuda.synchronize()
        del graph
        return start.elapsed_time(stop) / (5 * iters)
    except RuntimeError as exc:  # capture refused: report, do not fail
        print(f"graph_ms: capture failed: {str(exc)[:200]}")
        return None


def kernel_us(fn, iters: int = 20) -> dict:
    """Device microseconds per call of each CUDA kernel ``fn`` launches
    (torch.profiler over ``iters`` calls), by kernel name."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_time_total > 0:
            name = e.key.replace("(anonymous namespace)::", "")
            name = name.split("<")[0].split("(")[0].split()[-1]
            name = name.split("::")[-1]
            out[name] = out.get(name, 0.0) + e.device_time_total / iters
    return out


def bound(nbytes: float, flops: float, peak_flops: float):
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# --------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# --------------------------------------------------------------------------
def gate_case(rows: int, s: int, seed: int, h: int = 8, f: int = 256):
    """The write gate over ``rows`` (batch x kv heads) of ``s`` tokens with
    ``f`` = 2 x head_dim features: qwen3-0.6b's h 8, f 256 by default,
    recurrentgemma-9b's h 1, f 512."""
    import torch
    from repro_torch.kernels.gate_mlp import gate_mlp, gate_mlp_plain, plan
    g = torch.Generator(device="cuda").manual_seed(seed)
    m = 64

    def rn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device="cuda") * scale
    x = rn(rows, s, f)
    w1, b1 = rn(h, f, m, scale=f ** -0.5), rn(h, m, scale=0.1)
    w2, b2 = rn(h, m, 1, scale=m ** -0.5), rn(h, 1)
    args = (x, w1, b1, w2, b2)
    got = gate_mlp(*args)
    again = gate_mlp(*args)
    want = gate_mlp_plain(*args)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    check(bool(torch.isfinite(got).all()),
          f"gate_mlp [{rows},{s},{f}]: non-finite output")
    check(err <= 1e-5, f"gate_mlp [{rows},{s},{f}] err {err:.3e} > 1e-5")
    check(torch.equal(got, again), f"gate_mlp [{rows},{s},{f}]: two calls "
          "differ")
    iters = 200 if s == 1 else 20
    ms = cuda_ms(lambda: gate_mlp(*args), iters)
    # at S 1 the events time is the host's dispatch; the device time is
    # the same calls replayed from a CUDA graph
    device_ms = graph_ms(lambda: gate_mlp(*args), 50 if s == 1 else iters)
    plain_ms = cuda_ms(lambda: gate_mlp_plain(*args), iters)
    nbytes = 4 * (x.numel() + rows * s + sum(a.numel() for a in args[1:]))
    flops = rows * s * (2 * f * m + 2 * m)
    # the bound at the rate of the kernel's arithmetic: the decode path
    # (tile 0) multiplies in f32 on the CUDA cores, the tensor-core path
    # in 3xTF32; and at the CUDA cores' rate, the bound of the first kernel
    tile = plan(rows, s, h)
    rate = ((H100_F32_FLOPS, "f32 CUDA cores, 67 TFLOP/s") if tile == 0
            else ATTN_RATE["float32"])
    b_ms, b_by = bound(nbytes, flops, rate[0])
    cc_ms, _ = bound(nbytes, flops, H100_F32_FLOPS)
    return {"shape": f"x[{rows},{s},{f}] H={h} M={m}", "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "bound_rate": rate[1],
            "bound_ms_cuda_cores": cc_ms, "library_ms": None,
            "device_ms": device_ms, "tile": tile, "two_calls_bitwise": True}


def dual_cache_case(slots: int, c: int, w: int, dtype, seed: int,
                    hkv: int = 8, grp: int = 2, hd: int = 128):
    """Two segments (global C, ring W) of a random dual cache with ragged
    gcnt (0, partial page, full, ...) and rows before and after the ring
    wraps, read by the kernel and by its plain version. qwen3-0.6b's heads
    by default (8 kv heads, group 2, hd 128); recurrentgemma-9b's are 1 kv
    head, group 16, hd 256; the dense archs' 5 / 3 at hd 64, 8 / 3 and
    10 / 4 at hd 128."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core.dual_cache import init_dual_cache
    from repro_torch.kernels import ops
    from repro_torch.kernels.paged_decode import paged_decode, paged_decode_plain
    g = torch.Generator(device="cuda").manual_seed(seed)
    cache = init_dual_cache(slots, hkv, hd, w_local=w, budget=c, dtype=dtype,
                            device="cuda")

    def rn(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)
    pattern = torch.tensor([0, 7, c, c // 2 + 3, 1, c - 1, 16, 33],
                           dtype=torch.int32, device="cuda")
    pattern = pattern.repeat(-(-hkv // 8))  # phi3-medium-14b's 10 kv heads
    gcnt = torch.stack([pattern.roll(i)[:hkv] for i in range(slots)])
    t = torch.tensor([(w // 2 + 37 * i) if i % 2 == 0 else (w + 101 * i)
                      for i in range(slots)], dtype=torch.int32, device="cuda")
    cache = cache._replace(gk=rn(slots, hkv, c, hd), gv=rn(slots, hkv, c, hd),
                           lk=rn(slots, hkv, w, hd), lv=rn(slots, hkv, w, hd),
                           gcnt=gcnt, t=t)
    q = rn(slots, hkv * grp, hd)
    qf, first, second, grp = ops.dual_cache_segments(q, cache)
    got = paged_decode(qf, *first, second=second, group=grp)
    want = paged_decode_plain(qf, *first, second=second, group=grp)
    again = paged_decode(qf, *first, second=second, group=grp)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    tol = TOL["float32" if dtype == torch.float32 else "bfloat16"]
    check(err <= tol, f"paged_decode {dtype} slots={slots} C={c} W={w} "
          f"err {err:.3e} > {tol}")
    check(torch.equal(got, again), f"paged_decode {dtype} slots={slots} "
          f"C={c} W={w}: two calls differ")
    ms = cuda_ms(lambda: paged_decode(qf, *first, second=second, group=grp),
                 200)
    plain_ms = cuda_ms(lambda: paged_decode_plain(qf, *first, second=second,
                                                  group=grp), 50)
    # library yardstick: SDPA over the pre-concatenated [global | ring]
    # K/V with a validity mask (times the attention call only)
    k = torch.cat([cache.gk, cache.lk], dim=2)
    v = torch.cat([cache.gv, cache.lv], dim=2)
    pos = torch.arange(c + w, device="cuda")
    valid = torch.where(pos[None, None] < c, pos[None, None] < gcnt[..., None],
                        (pos[None, None] - c) < torch.clamp(t, max=w)[:, None, None])
    qg = q.reshape(slots, hkv, grp, hd)
    mask = valid[:, :, None, :]
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        qg, k, v, attn_mask=mask), 200)
    device_ms = graph_ms(lambda: paged_decode(qf, *first, second=second,
                                              group=grp), 50)
    split_us = kernel_us(lambda: paged_decode(qf, *first, second=second,
                                              group=grp))
    library_device_ms = graph_ms(lambda: F.scaled_dot_product_attention(
        qg, k, v, attn_mask=mask), 50)
    # the bound: each valid K/V token read once per kv stream, q and the
    # output once, page tables and lengths once
    toks = int(gcnt.sum()) + int(torch.clamp(t, max=w).sum()) * hkv
    isz = torch.tensor([], dtype=dtype).element_size()
    nbytes = (2 * q.numel() * isz + 2 * toks * hd * isz
              + 4 * sum(x.numel() for x in (first[2], first[3], second[2],
                                            second[3])))
    flops = 4 * toks * grp * hd
    b_ms, b_by = bound(nbytes, flops, H100_F32_FLOPS if dtype == torch.float32
                       else H100_BF16_FLOPS)
    plan = split_plan_of(qf, first, second, grp)
    return {"shape": f"N={slots * hkv * grp} hd={hd} C={c} W={w} {dtype}",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms,
            "device_ms": device_ms, "library_device_ms": library_device_ms,
            "split_plan": plan, "kernel_us": split_us}


def dense_case(slots: int, max_len: int, t: list, dtype, seed: int,
               hkv: int = 8, grp: int = 2, hd: int = 128):
    """The dense baseline's decode read (``ops.dense_cache_attention``):
    ONE ``paged_decode`` segment over a contiguous dense buffer of
    ``max_len`` (rounded up to a page), each row ``t`` long; qwen3-0.6b's
    heads. The library's: SDPA over the same buffer with a length
    mask."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    from repro_torch.kernels.paged_decode import (paged_decode,
                                                  paged_decode_plain)
    from repro_torch.models.attention import init_dense_cache
    g = torch.Generator(device="cuda").manual_seed(seed)
    cache = init_dense_cache(slots, hkv, hd, max_len, dtype, "cuda")
    s_max = cache.k.shape[2]

    def rn(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)
    tt = torch.tensor(t, dtype=torch.int32, device="cuda")
    cache = cache._replace(k=rn(slots, hkv, s_max, hd),
                           v=rn(slots, hkv, s_max, hd), t=tt)
    q = rn(slots, hkv * grp, hd)
    qf, seg, grp = ops.dense_cache_segment(q, cache)
    got = paged_decode(qf, *seg, group=grp)
    want = paged_decode_plain(qf, *seg, group=grp)
    again = paged_decode(qf, *seg, group=grp)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    tol = TOL["float32" if dtype == torch.float32 else "bfloat16"]
    check(err <= tol, f"dense read {dtype} S_max={s_max} t={t} err "
          f"{err:.3e} > {tol}")
    check(torch.equal(got, again), f"dense read {dtype}: two calls differ")
    ms = cuda_ms(lambda: paged_decode(qf, *seg, group=grp), 200)
    plain_ms = cuda_ms(lambda: paged_decode_plain(qf, *seg, group=grp), 20)
    device_ms = graph_ms(lambda: paged_decode(qf, *seg, group=grp), 50)
    qg = q.reshape(slots, hkv, grp, hd)
    mask = (torch.arange(s_max, device="cuda")[None, None, None]
            < tt[:, None, None, None])
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        qg, cache.k, cache.v, attn_mask=mask), 200)
    toks = sum(t) * hkv
    isz = torch.tensor([], dtype=dtype).element_size()
    nbytes = (2 * q.numel() * isz + 2 * toks * hd * isz
              + 4 * (seg[2].numel() + seg[3].numel()))
    b_ms, b_by = bound(nbytes, 4 * toks * grp * hd,
                       H100_F32_FLOPS if dtype == torch.float32
                       else H100_BF16_FLOPS)
    return {"shape": f"N={slots * hkv * grp} hd={hd} S_max={s_max} t={t} "
                     f"{dtype}",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms,
            "device_ms": device_ms,
            "split_plan": split_plan_of(qf, seg, None, grp)}


def selected_case(slots: int, c: int, w: int, k: int, dtype, seed: int):
    """The dual-cache read with Quest selection: a random dual cache with
    ragged gcnt, its page metadata rebuilt, and the top-K page ids of a
    random query (``selection.topk_page_ids``, the decode path's scorer);
    the global segment read through the ids, the ring whole. Also checks
    that the identity ids with K covering every page give exactly
    ``paged_decode``'s output."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core import selection as SEL
    from repro_torch.core.dual_cache import init_dual_cache
    from repro_torch.kernels import ops
    from repro_torch.kernels.paged_decode import (paged_decode,
                                                  paged_decode_selected,
                                                  paged_decode_selected_plain)
    g = torch.Generator(device="cuda").manual_seed(seed)
    hkv, grp, hd, page = 8, 2, 128, 16
    p_all = c // page
    cache = init_dual_cache(slots, hkv, hd, w_local=w, budget=c, dtype=dtype,
                            device="cuda")

    def rn(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)
    pattern = torch.tensor([c, 7, c // 2 + 3, 0, c - 1, 16, 33, 5 * page],
                           dtype=torch.int32, device="cuda")
    gcnt = torch.stack([pattern.roll(i)[:hkv] for i in range(slots)])
    t = torch.tensor([w + 101 * i for i in range(slots)], dtype=torch.int32,
                     device="cuda")
    cache = cache._replace(gk=rn(slots, hkv, c, hd), gv=rn(slots, hkv, c, hd),
                           lk=rn(slots, hkv, w, hd), lv=rn(slots, hkv, w, hd),
                           gcnt=gcnt, t=t)
    q = rn(slots, hkv * grp, hd)
    valid = torch.arange(c, device="cuda")[None, None] < gcnt[..., None]
    meta = SEL.build_page_meta(cache.gk, valid)
    meta = SEL.PageMeta(meta.kmin, meta.kmax,
                        SEL.page_valid_from_count(gcnt, p_all))
    ids, n_sel = SEL.topk_page_ids(q, meta, k)
    qf, first, second, grp = ops.dual_cache_segments(q, cache)
    sel = ids.reshape(slots * hkv, k).contiguous()
    nsf = n_sel.reshape(-1).contiguous()
    got = paged_decode_selected(qf, *first, sel, nsf, second=second,
                                group=grp)
    want = paged_decode_selected_plain(qf, *first, sel, nsf, second=second,
                                       group=grp)
    # the identity ids at K = every page, as topk_page_ids gives them
    all_ids, n_all = SEL.topk_page_ids(q, meta, p_all)
    sel_all = all_ids.reshape(slots * hkv, p_all).contiguous()
    n_allf = n_all.reshape(-1).contiguous()
    ident = paged_decode_selected(qf, *first, sel_all, n_allf, second=second,
                                  group=grp)
    full = paged_decode(qf, *first, second=second, group=grp)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    tol = TOL["float32" if dtype == torch.float32 else "bfloat16"]
    tag = f"paged_decode_selected {dtype} slots={slots} C={c} W={w} K={k}"
    check(bool(torch.isfinite(got.float()).all()), f"{tag}: non-finite")
    check(err <= tol, f"{tag} err {err:.3e} > {tol}")
    check(torch.equal(ident, full), f"{tag}: identity ids differ from "
          f"paged_decode by {float((ident - full).abs().max()):.3e}")
    ms = cuda_ms(lambda: paged_decode_selected(qf, *first, sel, nsf,
                                               second=second, group=grp), 200)
    full_ms = cuda_ms(lambda: paged_decode(qf, *first, second=second,
                                           group=grp), 200)
    plain_ms = cuda_ms(lambda: paged_decode_selected_plain(
        qf, *first, sel, nsf, second=second, group=grp), 50)
    # library yardstick: SDPA over the K gathered pages and the ring, with
    # the validity mask (the gather is outside the timed call)
    gk, gv, gvalid = SEL.gather_pages(cache.gk, cache.gv, gcnt, ids)
    gvalid = gvalid & (
        torch.arange(k, device="cuda").repeat_interleave(page)[None, None]
        < n_sel[..., None])
    kk = torch.cat([gk, cache.lk], dim=2)
    vv = torch.cat([gv, cache.lv], dim=2)
    lvalid = (torch.arange(w, device="cuda")[None, None]
              < torch.clamp(t, max=w)[:, None, None]).expand(slots, hkv, w)
    mask = torch.cat([gvalid, lvalid], dim=2)[:, :, None, :]
    qg = q.reshape(slots, hkv, grp, hd)
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        qg, kk, vv, attn_mask=mask), 200)
    device_ms = graph_ms(lambda: paged_decode_selected(
        qf, *first, sel, nsf, second=second, group=grp), 50)
    library_device_ms = graph_ms(lambda: F.scaled_dot_product_attention(
        qg, kk, vv, attn_mask=mask), 50)
    # the bound: the valid tokens of the selected pages and of the ring,
    # K and V once per kv stream; q, the output, the ids, their counts,
    # the table entries they select and the lengths once
    toks = int(gvalid.sum()) + int(lvalid.sum())
    isz = q.element_size()
    n = qf.shape[0]
    nbytes = (2 * q.numel() * isz + 2 * toks * hd * isz
              + 4 * (2 * sel.numel() + nsf.numel() + 2 * (n // grp)
                     + second[2].numel()))
    flops = 4 * toks * grp * hd
    b_ms, b_by = bound(nbytes, flops, H100_F32_FLOPS
                       if dtype == torch.float32 else H100_BF16_FLOPS)
    return {"shape": f"N={n} hd={hd} C={c} ({p_all} pages) K={k} W={w} "
                     f"{dtype}",
            "max_abs_err": err, "ms": ms, "full_read_ms": full_ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": library_ms, "device_ms": device_ms,
            "library_device_ms": library_device_ms, "tokens_read": toks,
            "identity_bitwise": True}


def vertical_slash_case(dtype: str, seed: int, hkv: int = 8, hd: int = 128,
                        w: int = 256, hq: int = 16):
    """The prefill path's shape: B = 1, S = 4096, C 1024 globals chosen by
    ``select_global`` from random gates (sinks, then the highest; unused
    slots at INT32_MAX). qwen3-0.6b's 16 q on 8 kv heads, hd 128, W 256 by
    default; recurrentgemma-9b's 16 on 1 kv head, hd 256, W 2048; the
    dense archs' odd groups (smollm-360m 15 / 5 at hd 64, phi4-mini-3.8b 24
    / 8 and phi3-medium-14b 40 / 10 at hd 128)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core.admission import select_global
    from repro_torch.device import torch_dtype
    from repro_torch.kernels.vertical_slash import (vertical_slash,
                                                    vertical_slash_plain)
    s, c = 4096, 1024
    grp = hq // hkv
    dt = torch_dtype(dtype)
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dt)
    q, k, v = rn(hq, s, hd), rn(hkv, s, hd), rn(hkv, s, hd)
    gates = torch.rand((1, hkv, s), generator=gen, device="cuda")
    sel = select_global(gates, budget=c, tau=0.1, sink=16,
                        exclude_from=s - w)
    idx = sel.idx[0].long()                                    # [hkv, C]
    rows = torch.arange(hkv, device="cuda")[:, None]
    kg, vg = k[rows, idx].contiguous(), v[rows, idx].contiguous()
    gpos = torch.where(sel.valid[0], sel.idx[0],
                       torch.full_like(sel.idx[0], INT32_MAX)).contiguous()
    args = (q, k, v, kg, vg, gpos)
    got = vertical_slash(*args, w_local=w, group=grp)
    again = vertical_slash(*args, w_local=w, group=grp)
    want = vertical_slash_plain(*args, w_local=w, group=grp)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    tag = f"vertical_slash {hq}/{hkv} hd={hd} {dtype}"
    check(bool(torch.isfinite(got.float()).all()), f"{tag}: non-finite "
          "output")
    check(err <= TOL[dtype], f"{tag} err {err:.3e} > {TOL[dtype]}")
    check(torch.equal(got, again), f"{tag}: two calls differ")
    ms = cuda_ms(lambda: vertical_slash(*args, w_local=w, group=grp), 10)
    device_ms = graph_ms(lambda: vertical_slash(*args, w_local=w,
                                                group=grp), 10)
    plain_ms = cuda_ms(lambda: vertical_slash_plain(*args, w_local=w,
                                                    group=grp), 3, warmup=1)
    # library yardstick: one SDPA call over [K ‖ Kg] with the same boolean
    # visibility (K/V repeated over the group and the mask built outside
    # the timed call)
    qi = torch.arange(s, device="cuda")[:, None]
    kj = torch.arange(s, device="cuda")[None, :]
    local = (qi >= kj) & (qi - kj < w)                         # [S, S]
    vis = gpos[:, None, :].long() <= (qi[None] - w)            # [hkv, S, C]
    mask = torch.cat([local[None].expand(hkv, s, s), vis], dim=-1)
    mask = mask.repeat_interleave(grp, dim=0)[None]
    kk = torch.cat([k, kg], dim=1).repeat_interleave(grp, dim=0)[None]
    vv = torch.cat([v, vg], dim=1).repeat_interleave(grp, dim=0)[None]
    q4 = q[None]
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        q4, kk, vv, attn_mask=mask), 5, warmup=1)
    del mask, kk, vv
    # the bound: every visible (query, key) pair once, 4 * hd FLOPs each;
    # q, out, k, v, kg, vg and gpos each moved once
    local_keys = int(torch.clamp(torch.arange(s) + 1, max=w).sum())
    gp = gpos.long()
    glob_keys = int(torch.where(gp < INT32_MAX,
                                torch.clamp(s - (gp + w), min=0),
                                torch.zeros_like(gp)).sum())
    visible = grp * (hkv * local_keys + glob_keys)
    isz = q.element_size()
    nbytes = (isz * (2 * q.numel() + k.numel() + v.numel() + kg.numel()
                     + vg.numel()) + 4 * gpos.numel())
    # the bound at the rate of the kernel's arithmetic (as gated_flash's),
    # and for f32 also at the CUDA cores' rate
    b_ms, b_by = bound(nbytes, 4 * hd * visible, ATTN_RATE[dtype][0])
    cc_ms, _ = bound(nbytes, 4 * hd * visible, PEAK[dtype])
    return {"shape": f"q[{hq},{s},{hd}] kv[{hkv},{s},{hd}] C={c} W={w} "
                     f"group={grp} {dtype}",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by,
            "bound_rate": ATTN_RATE[dtype][1],
            "bound_ms_cuda_cores": cc_ms if dtype == "float32" else None,
            "library_ms": library_ms, "device_ms": device_ms,
            "two_calls_bitwise": True, "visible_pairs": visible,
            "global_valid": int(sel.count.sum())}


def gated_flash_case(s: int, dtype: str, seed: int, hkv: int = 8,
                     hd: int = 128, w: int = 256, causal: bool = False,
                     hq: int = 16):
    """The gated forward's shape: the forward phase's S = 2048 or the tau
    probe's S = 32, with qwen3-0.6b's 16 q on 8 kv heads, hd 128, W 256 by
    default; recurrentgemma-9b's 16 on 1 kv head, hd 256, W 2048 at S =
    4096; the dense archs' odd groups (15 / 5 at hd 64, 24 / 8 and 40 / 10
    at hd 128). ``causal``: the dense baseline's prefill form
    (``ops.causal_attention``): g = 1 and W = S, held against the same
    plain version, with one causal SDPA call as the library's."""
    import torch
    import torch.nn.functional as F
    from repro_torch.device import torch_dtype
    from repro_torch.kernels.gated_flash import gated_flash, gated_flash_plain
    eps = 1e-6
    grp = hq // hkv
    dt = torch_dtype(dtype)
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dt)
    q, k, v = rn(hq, s, hd), rn(hkv, s, hd), rn(hkv, s, hd)
    g = torch.rand((hkv, s), generator=gen, device="cuda")
    if causal:
        g, w = torch.ones_like(g), s
    args = (q, k, v, g)
    got = gated_flash(*args, w_local=w, eps=eps, group=grp)
    again = gated_flash(*args, w_local=w, eps=eps, group=grp)
    want = gated_flash_plain(*args, w_local=w, eps=eps, group=grp)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    tag = f"gated_flash {hq}/{hkv} hd={hd} S={s} {dtype}"
    check(bool(torch.isfinite(got.float()).all()), f"{tag}: non-finite "
          "output")
    check(err <= TOL[dtype], f"{tag} err {err:.3e} > {TOL[dtype]}")
    check(torch.equal(got, again), f"{tag}: two calls differ")
    iters = 200 if s <= 64 else (10 if s <= 2048 else 4)
    ms = cuda_ms(lambda: gated_flash(*args, w_local=w, eps=eps, group=grp),
                 iters)
    plain_ms = cuda_ms(lambda: gated_flash_plain(*args, w_local=w, eps=eps,
                                                 group=grp),
                       max(iters // 4, 3), warmup=1)
    # library yardstick: one SDPA call with the additive float bias
    # (0 in the window, log(g + eps) outside, -1e30 above the diagonal)
    # (the causal form: SDPA's own is_causal, no bias tensor)
    bias = None
    if not causal:
        qi = torch.arange(s, device="cuda")[:, None]
        kj = torch.arange(s, device="cuda")[None, :]
        below, in_win = qi >= kj, (qi >= kj) & (qi - kj < w)
        logg = torch.log(g + eps)[:, None, :]                  # [hkv, 1, S]
        bias = torch.where(below, torch.where(in_win, torch.zeros_like(logg),
                                              logg),
                           torch.full_like(logg, -1e30))
        bias = bias.repeat_interleave(grp, dim=0)[None].to(dt)
    kk = k.repeat_interleave(grp, dim=0)[None]
    vv = v.repeat_interleave(grp, dim=0)[None]
    q4 = q[None]
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        q4, kk, vv, attn_mask=bias, is_causal=causal), iters, warmup=1)
    device_ms = graph_ms(lambda: gated_flash(*args, w_local=w, eps=eps,
                                             group=grp),
                         50 if s <= 64 else iters)
    library_device_ms = None
    if s <= 64:  # the probe: launch-bound, so also the library's
        library_device_ms = graph_ms(lambda: F.scaled_dot_product_attention(
            q4, kk, vv, attn_mask=bias), 50)
    del bias, kk, vv
    isz = q.element_size()
    nbytes = isz * (2 * q.numel() + k.numel() + v.numel()) + 4 * g.numel()
    flops = 4 * hd * hq * s * (s + 1) // 2
    # the bound at the rate of the kernel's arithmetic, and for f32 also at
    # the CUDA cores' rate, the bound earlier versions were held to
    b_ms, b_by = bound(nbytes, flops, ATTN_RATE[dtype][0])
    cc_ms, _ = bound(nbytes, flops, PEAK[dtype])
    return {"shape": f"q[{hq},{s},{hd}] kv[{hkv},{s},{hd}] W={w} "
                     f"group={grp} {dtype}" + (" g=1" if causal else ""),
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by,
            "bound_rate": ATTN_RATE[dtype][1],
            "bound_ms_cuda_cores": cc_ms if dtype == "float32" else None,
            "library_ms": library_ms, "device_ms": device_ms,
            "library_device_ms": library_device_ms,
            "two_calls_bitwise": True}


def split_plan_of(qf, first, second, group: int) -> dict:
    """The split plan ``paged_decode`` launched with, for the record."""
    from repro_torch.kernels.paged_decode import walk_plan
    plan = walk_plan(qf, first[2], second, group=group)
    return {"pages_per_split": plan.pages_per_split,
            "splits": plan.n_splits, "heads_per_cta": plan.heads,
            "ctas": qf.shape[0] // group * plan.n_splits
            * -(-group // plan.heads)}


def rglru_case(b: int, s: int, d: int, with_h0: bool, seed: int):
    """The RG-LRU linear recurrence ``h_t = a_t h_{t-1} + b_t`` on
    ``a = sigmoid(normal)``, ``b = normal``: recurrentgemma-9b's prefill
    shape [1, 4096, 4096] (one prompt, dr = d_model), or a ragged one with
    a carried-in state (folded into ``b[:, 0]`` by the model's
    ``rglru_scan``, then the kernel)."""
    import torch
    from repro_torch.kernels.rglru_scan import rglru_scan, rglru_scan_plain
    from repro_torch.models import rglru as RG
    gen = torch.Generator(device="cuda").manual_seed(seed)
    a = torch.sigmoid(torch.randn((b, s, d), generator=gen, device="cuda"))
    bb = torch.randn((b, s, d), generator=gen, device="cuda")
    h0 = torch.randn((b, d), generator=gen, device="cuda")
    if with_h0:
        got = RG.rglru_scan(a, bb, h0)
        folded = bb.clone()
        folded[:, 0] = folded[:, 0] + a[:, 0] * h0
        want = rglru_scan_plain(a, folded)
    else:
        got = rglru_scan(a, bb)
        want = rglru_scan_plain(a, bb)
    again = RG.rglru_scan(a, bb, h0) if with_h0 else rglru_scan(a, bb)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    tag = f"rglru_scan [{b},{s},{d}]" + (" h0" if with_h0 else "")
    check(bool(torch.isfinite(got).all()), f"{tag}: non-finite output")
    check(err <= 5e-5, f"{tag} err {err:.3e} > 5e-5")
    check(torch.equal(got, again), f"{tag}: two calls differ")
    ms = cuda_ms(lambda: rglru_scan(a, bb), 20)
    device_ms = graph_ms(lambda: rglru_scan(a, bb), 20)
    plain_ms = cuda_ms(lambda: rglru_scan_plain(a, bb), 2, warmup=1)
    # the bound: a and b read once, h written once; two operations each
    n = b * s * d
    b_ms, b_by = bound(12 * n, 2 * n, H100_F32_FLOPS)
    return {"shape": f"a,b[{b},{s},{d}] f32" + (" h0" if with_h0 else ""),
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "device_ms": device_ms, "two_calls_bitwise": True}


# the backward kernels' limit: max |kernel - reference| <= 1e-4 x max |ref|
# of each gradient tensor, against the plain backward on the same inputs
# and against torch.autograd of the forward's plain version (elementwise
# limits would trip on dg's 1 / (g + eps) near g = 0)
BWD_REL = 1e-4

# faults planted in copies of the backward sources, each alone in its own
# copy: dg summed inside the window too (in every block that runs the
# per-pair mask, where the diagonal's in-window pairs are; every hd); the
# hd-256 kernels' dP without the other half of hd (the pair exchange);
# dy without its (1 - g) factor; and the RG-LRU scan's hand-off between
# chunks lost. Each must read above BWD_REL
BWD_FAULTS = {
    "gated_flash_bwd": ("if (pr.outside) dgp[h] += pr.ds;",
                        "dgp[h] += pr.ds;"),
    "gated_flash_bwd_hd256": (
        "p[nt][e] += other[((NT + nt) * 4 + e) * 32 + lane];",
        "p[nt][e] *= 2.f;"),
    "gate_mlp_bwd": ("dy[h2] = dgv * gv * (1.f - gv);", "dy[h2] = dgv * gv;"),
    "rglru_scan_bwd": ("carry = __uint_as_float((unsigned)v);",
                       "carry = 0.f * __uint_as_float((unsigned)v);"),
}
# the source of a fault whose name is not its source's
FAULT_SOURCES = {"gated_flash_bwd_hd256": "gated_flash_bwd"}


def _entry_name(mangled: str) -> str:
    """``name<template arguments>`` of a mangled kernel entry: the first
    length-prefixed identifier that ends in ``_kernel`` (digits allowed,
    as in ``bwd_kv256_kernel``), then its integer or bool arguments."""
    import re
    for m in re.finditer(r"(?=(\d+)[A-Za-z_])", mangled):
        start = m.start() + len(m.group(1))
        ident = mangled[start:start + int(m.group(1))]
        if ident.endswith("_kernel") and re.fullmatch(r"\w+", ident):
            t = re.match(r"I((?:L[ib]\d+E)+)E", mangled[start + len(ident):])
            args = re.findall(r"L[ib](\d+)E", t.group(1)) if t else []
            return ident + (f"<{','.join(args)}>" if args else "")
    return mangled


def ptxas_info(name: str) -> dict:
    """Registers, spills and static shared memory of each kernel entry of
    source ``name``, from the build log (nvcc -Xptxas -v) of the library
    that ``build.load`` loads, by entry (``name<template arguments>``)."""
    import re
    from repro_torch.kernels import build
    out, cur = {}, None
    for line in build.log_path(name).read_text().splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = _entry_name(m.group(1))
            out[cur] = {}
            continue
        if cur is None:
            continue
        for key, pat in (("registers", r"Used (\d+) registers"),
                         ("smem_static", r"(\d+) bytes smem"),
                         ("spill_stores", r"(\d+) bytes spill stores"),
                         ("spill_loads", r"(\d+) bytes spill loads")):
            m = re.search(pat, line)
            if m:
                out[cur][key] = int(m.group(1))
    return out


def rel_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max().clamp_min(1e-30))


class Planted:
    """The faults ``names`` (default: all of ``BWD_FAULTS``), each planted
    alone in its own copy of the sources in a temporary directory and
    built there while the block runs (one nvcc per fault, all at once).
    The build module points at the first fault's copy; ``use(name)``
    points it at another's. ``tests/test_torch_cuda.py`` plants its faults
    through this too."""

    def __init__(self, names=tuple(BWD_FAULTS)):
        self.names = list(names)

    def _point(self, name):
        self.build.CSRC, self.build.BUILD_DIR, self.build._LIBS = \
            self.dirs[name]

    def __enter__(self):
        import shutil
        import tempfile
        from repro_torch.kernels import build
        self.build, self.saved = build, (build.CSRC, build.BUILD_DIR,
                                         build._LIBS)
        self.tmp = Path(tempfile.mkdtemp(prefix="planted-"))
        self.dirs, procs = {}, {}
        for name in self.names:
            src = FAULT_SOURCES.get(name, name)
            old, new = BWD_FAULTS[name]
            csrc = self.tmp / name / "csrc"
            shutil.copytree(self.saved[0], csrc)
            path = csrc / f"{src}.cu"
            text = path.read_text()
            check(text.count(old) == 1, f"planted fault: {old!r} not found "
                  f"once in {src}.cu")
            path.write_text(text.replace(old, new))
            self.dirs[name] = (csrc, self.tmp / name / "build", {})
            self._point(name)
            procs[name] = build._start(src)
        for name, proc in procs.items():
            self._point(name)
            build._finish(FAULT_SOURCES.get(name, name), proc)
        self._point(self.names[0])
        return self

    def use(self, name):
        """Point the build module at fault ``name``'s copy."""
        self._point(name)

    def __exit__(self, *exc):
        import shutil
        self.build.CSRC, self.build.BUILD_DIR, self.build._LIBS = self.saved
        shutil.rmtree(self.tmp, ignore_errors=True)
        return False


def gate_bwd_case(rows: int, s: int, seed: int, h: int = 8, f: int = 256,
                  m: int = 64):
    """The write gate's backward at a training shape: qwen3-0.6b's x [B x
    8, 2048, 256] (M 64) by default, the substrate's x [B x 2, 128, 64]
    (M 32). Returns the record and a function that runs the kernel on the
    same inputs (for the planted fault)."""
    import torch
    from repro_torch.kernels.gate_mlp import (gate_mlp_bwd,
                                              gate_mlp_bwd_plain,
                                              gate_mlp_plain)
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale
    x = rn(rows, s, f)
    w1, b1 = rn(h, f, m, scale=f ** -0.5), rn(h, m, scale=0.1)
    w2, b2 = rn(h, m, 1, scale=m ** -0.5), rn(h, 1)
    dg = rn(rows, s)
    args = (x, w1, b1, w2, b2)
    ins = [t.clone().requires_grad_() for t in args]
    g_auto = gate_mlp_plain(*ins)
    auto = torch.autograd.grad(g_auto, ins, dg)
    g = g_auto.detach()
    run = lambda: gate_mlp_bwd(*args, g, dg)  # noqa: E731
    got, again = run(), run()
    want = gate_mlp_bwd_plain(*args, g, dg)
    torch.cuda.synchronize()
    tag = f"gate_mlp_bwd x[{rows},{s},{f}] M={m}"
    names = ("dx", "dw1", "db1", "dw2", "db2")
    errs = {n: rel_err(a, b) for n, a, b in zip(names, got, want)}
    errs_auto = {n: rel_err(a, b) for n, a, b in zip(names, got, auto)}
    check(all(bool(torch.isfinite(t).all()) for t in got),
          f"{tag}: non-finite gradient")
    check(max(errs.values()) <= BWD_REL and max(errs_auto.values()) <= BWD_REL,
          f"{tag}: errors {errs} / autograd {errs_auto} > {BWD_REL} x max")
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          f"{tag}: two calls differ")
    ms = cuda_ms(run, 20)
    device_ms = graph_ms(run, 20)
    plain_ms = cuda_ms(lambda: gate_mlp_bwd_plain(*args, g, dg), 5, warmup=1)
    # the bound: x, the weights, g and dg read once, dx and the weight
    # gradients written once; per token the recomputed pre-activation, dx
    # and dw1 (2 F M FLOPs each) and about 12 M of elementwise work, at the
    # card's f32 product rate (3xTF32); beside it the bound at the CUDA
    # cores' rate, where the kernel multiplies
    nbytes = 4 * (2 * x.numel() + 2 * sum(a.numel() for a in args[1:])
                  + 2 * rows * s)
    flops = rows * s * (6 * f * m + 12 * m)
    b_ms, b_by = bound(nbytes, flops, ATTN_RATE["float32"][0])
    cc_ms, _ = bound(nbytes, flops, H100_F32_FLOPS)
    rec = {"shape": f"x[{rows},{s},{f}] H={h} M={m}",
           "max_abs_err": max(float((a - b).abs().max())
                              for a, b in zip(got, want)),
           "max_rel_err": errs, "max_rel_err_autograd": errs_auto,
           "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
           "bound_by": b_by, "bound_rate": ATTN_RATE["float32"][1],
           "bound_ms_cuda_cores": cc_ms,
           "library_ms": None, "device_ms": device_ms,
           "two_calls_bitwise": True}
    return rec, (run, want)


def flash_bwd_case(nq: int, s: int, seed: int, nk: int, hd: int = 128,
                   w: int = 256):
    """The write-gated attention's backward at a training shape: qwen3's
    B = 2 (Nq 32 on Nk 16), S 2048, hd 128, W 256 by default, the
    substrate's (S 128, hd 32, group 2, W 16). The forward kernel gives o
    and lse (lse also held to the plain version's); the backward kernel
    is held to the plain backward on those and to autograd of the plain
    forward. Library yardstick: SDPA's backward alone with the additive
    bias as a constant (dq, dk, dv only, so a lower yardstick), and SDPA
    forward + backward beside it."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import gated_flash as GF
    grp, eps = nq // nk, 1e-6
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    q, k, v, do = rn(nq, s, hd), rn(nk, s, hd), rn(nk, s, hd), rn(nq, s, hd)
    g = torch.rand((nk, s), generator=gen, device="cuda")
    g[0, :8] = 1e-7   # gates near 0: large dg
    kw = {"w_local": w, "eps": eps, "group": grp}
    o, lse = GF._forward_cuda(q, k, v, g, w, eps, grp, True)
    o_plain, lse_plain = GF.gated_flash_plain(q, k, v, g, with_lse=True, **kw)
    ins = [t.clone().requires_grad_() for t in (q, k, v, g)]
    auto = torch.autograd.grad(GF.gated_flash_plain(*ins, **kw), ins, do)
    run = lambda: GF.gated_flash_bwd(q, k, v, g, o, lse, do, **kw)  # noqa
    got, again = run(), run()
    want = GF.gated_flash_bwd_plain(q, k, v, g, o, lse, do, **kw)
    torch.cuda.synchronize()
    tag = f"gated_flash_bwd q[{nq},{s},{hd}] W={w}"
    lse_err = float((lse - lse_plain).abs().max())
    check(float((o - o_plain).abs().max()) <= TOL["float32"]
          and lse_err <= TOL["float32"],
          f"{tag}: forward with lse off by {lse_err:.3e}")
    names = ("dq", "dk", "dv", "dg")
    errs = {n: rel_err(a, b) for n, a, b in zip(names, got, want)}
    errs_auto = {n: rel_err(a, b) for n, a, b in zip(names, got, auto)}
    check(all(bool(torch.isfinite(t).all()) for t in got),
          f"{tag}: non-finite gradient")
    check(max(errs.values()) <= BWD_REL and max(errs_auto.values()) <= BWD_REL,
          f"{tag}: errors {errs} / autograd {errs_auto} > {BWD_REL} x max")
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          f"{tag}: two calls differ")
    iters = 10 if s >= 2048 else 50
    ms = cuda_ms(run, iters)
    device_ms = graph_ms(run, iters)
    plain_ms = cuda_ms(lambda: GF.gated_flash_bwd_plain(q, k, v, g, o, lse,
                                                        do, **kw),
                       3, warmup=1)
    qi = torch.arange(s, device="cuda")[:, None]
    kj = torch.arange(s, device="cuda")[None, :]
    logg = torch.log(g + eps)[:, None, :]
    bias = torch.where(qi >= kj, torch.where(qi - kj < w,
                                             torch.zeros_like(logg), logg),
                       torch.full_like(logg, -1e30))
    bias = bias.repeat_interleave(grp, dim=0)[None]
    q4 = q[None].clone().requires_grad_()
    k4 = k.repeat_interleave(grp, dim=0)[None].requires_grad_()
    v4 = v.repeat_interleave(grp, dim=0)[None].requires_grad_()

    def library():
        out = F.scaled_dot_product_attention(q4, k4, v4, attn_mask=bias)
        torch.autograd.grad(out, (q4, k4, v4), do[None])
    library_fwd_bwd_ms = cuda_ms(library, max(iters // 2, 3), warmup=1)
    # the same function as the kernel: SDPA's backward alone, its forward
    # run once outside the timed calls
    out4 = F.scaled_dot_product_attention(q4, k4, v4, attn_mask=bias)
    library_ms = cuda_ms(lambda: torch.autograd.grad(
        out4, (q4, k4, v4), do[None], retain_graph=True),
        max(iters // 2, 3), warmup=1)
    del bias, q4, k4, v4, out4
    # the bound: q, k, v, g, o, lse and do read once, dq, dk, dv and dg
    # written once; per causal pair the scores again (2 hd FLOPs), dO V^T,
    # dV, dK and dQ (2 hd each), at the card's f32 product rate (3xTF32);
    # beside it the bound at the CUDA cores' rate, where the kernel
    # multiplies
    pairs = nq * s * (s + 1) // 2
    nbytes = 4 * (2 * (q.numel() + k.numel() + v.numel() + g.numel())
                  + o.numel() + lse.numel() + do.numel())
    b_ms, b_by = bound(nbytes, 10 * hd * pairs, ATTN_RATE["float32"][0])
    cc_ms, _ = bound(nbytes, 10 * hd * pairs, H100_F32_FLOPS)
    rec = {"shape": f"q[{nq},{s},{hd}] kv[{nk},{s},{hd}] W={w} group={grp} "
                    "f32",
           "max_abs_err": max(float((a - b).abs().max())
                              for a, b in zip(got, want)),
           "max_rel_err": errs, "max_rel_err_autograd": errs_auto,
           "lse_max_abs_err": lse_err, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": b_ms, "bound_by": b_by,
           "bound_rate": ATTN_RATE["float32"][1],
           "bound_ms_cuda_cores": cc_ms, "library_ms": library_ms,
           "library": "SDPA backward alone (forward once, outside the "
                      "timed calls), additive bias, dq/dk/dv (no dg)",
           "library_fwd_bwd_ms": library_fwd_bwd_ms,
           "device_ms": device_ms, "two_calls_bitwise": True}
    return rec, (run, want)


def rglru_bwd_case(b: int, s: int, d: int, with_h0: bool, seed: int):
    """The RG-LRU scan's backward at recurrentgemma-9b's training shape [1,
    4096, 4096] (one sequence, dr = d_model), or a ragged one with a
    carried-in state, on a in (0.9, 0.999) (the model's range, so that what
    a chunk hands the next is not negligible) and normal b and dy. The
    kernel is held to the plain backward on the forward kernel's h and,
    through the model's scan (its autograd Function; the state folded into
    b[:, 0]), to autograd of the plain loop; two calls bitwise equal.
    Returns the record and a function that runs the kernel on the same
    inputs (for the planted fault)."""
    import torch
    from repro_torch.kernels import rglru_scan as RS
    from repro_torch.models import rglru as RG
    gen = torch.Generator(device="cuda").manual_seed(seed)
    a = 0.9 + 0.099 * torch.rand((b, s, d), generator=gen, device="cuda")
    x = torch.randn((b, s, d), generator=gen, device="cuda")
    h0 = torch.randn((b, d), generator=gen, device="cuda")
    dy = torch.randn((b, s, d), generator=gen, device="cuda")
    xf = x.clone()
    if with_h0:
        xf[:, 0] = xf[:, 0] + a[:, 0] * h0
    h = RS.rglru_scan(a, xf)
    run = lambda: RS.rglru_scan_bwd(a, h, dy)  # noqa: E731
    got, again = run(), run()
    want = RS.rglru_scan_bwd_plain(a, h, dy)
    names = ("da", "db") + (("dh0",) if with_h0 else ())
    ins = [t.clone().requires_grad_() for t in (a, x, h0)[:len(names)]]
    model = torch.autograd.grad(RG.rglru_scan(*ins[:2], ins[2] if with_h0
                                              else None), ins, dy)
    pins = [t.clone().requires_grad_() for t in (a, x, h0)[:len(names)]]
    pb = pins[1]
    if with_h0:
        pb = pb.clone()
        pb[:, 0] = pb[:, 0] + pins[0][:, 0] * pins[2]
    auto = torch.autograd.grad(RS.rglru_scan_plain(pins[0], pb), pins, dy)
    torch.cuda.synchronize()
    tag = f"rglru_scan_bwd [{b},{s},{d}]" + (" h0" if with_h0 else "")
    errs = {n: rel_err(g, w) for n, g, w in zip(names, got, want)}
    errs_auto = {n: rel_err(g, w) for n, g, w in zip(names, model, auto)}
    check(all(bool(torch.isfinite(t).all()) for t in got + model),
          f"{tag}: non-finite gradient")
    check(max(errs.values()) <= BWD_REL and max(errs_auto.values()) <= BWD_REL,
          f"{tag}: errors {errs} / autograd {errs_auto} > {BWD_REL} x max")
    check(all(torch.equal(g, w) for g, w in zip(got, again)),
          f"{tag}: two calls differ")
    ms = cuda_ms(run, 20)
    device_ms = graph_ms(run, 20)
    plain_ms = cuda_ms(lambda: RS.rglru_scan_bwd_plain(a, h, dy), 2, warmup=1)
    # the bound: a, h and dy read once, da and db written once; four
    # operations per element
    n = b * s * d
    b_ms, b_by = bound(20 * n, 4 * n, H100_F32_FLOPS)
    rec = {"shape": f"a,h,dy[{b},{s},{d}] f32" + (" h0" if with_h0 else ""),
           "max_abs_err": max(float((g - w).abs().max())
                              for g, w in zip(got, want)),
           "max_rel_err": errs, "max_rel_err_autograd": errs_auto,
           "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
           "bound_by": b_by, "library_ms": None, "device_ms": device_ms,
           "two_calls_bitwise": True}
    return rec, (run, want)


def planted_faults(cases) -> dict:
    """Each fault of ``BWD_FAULTS`` planted alone in a rebuild of its
    backward kernel, run on the inputs of its cases (fault name, (run,
    want)): its error against the plain backward must read above BWD_REL
    (the sound kernels read below it above)."""
    import torch
    out = {}
    with Planted(sorted({name for name, _ in cases})) as planted:
        for name, (run, want) in cases:
            planted.use(name)
            got = run()
            torch.cuda.synchronize()
            err = max(rel_err(a, b) for a, b in zip(got, want))
            check(err > BWD_REL, f"planted fault {name}: error {err:.3e} "
                  f"<= {BWD_REL}: the limit would not see it")
            out.setdefault(name, []).append(err)
    return out


# --------------------------------------------------------------------------
# phases 4-14: the main paths
# --------------------------------------------------------------------------
class Wrapped:
    """Counts and times calls of ``owner.name`` while the block runs (a
    module function such as ``inference.decode_step``, one call per
    position step, or an engine method such as the paged mirror)."""

    def __init__(self, owner, name: str):
        self.owner, self.name = owner, name
        self.inner = getattr(owner, name)
        self.count, self.seconds = 0, 0.0

    def __enter__(self):
        def wrapped(*a, **kw):
            self.count += 1
            t0 = time.perf_counter()
            try:
                return self.inner(*a, **kw)
            finally:
                self.seconds += time.perf_counter() - t0
        setattr(self.owner, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.name, self.inner)
        return False


def position_counter():
    from repro_torch.models import inference as I
    return Wrapped(I, "decode_step")


def _counters():
    from repro_torch.kernels import (gate_mlp, gated_flash, paged_decode,
                                     rglru_scan, vertical_slash)
    return [gate_mlp.launches, paged_decode.launches,
            paged_decode.selected_launches, vertical_slash.launches,
            gated_flash.launches, rglru_scan.launches,
            gate_mlp.bwd_launches, gated_flash.bwd_launches,
            rglru_scan.bwd_launches]


def reset_counts():
    for c in _counters():
        c.reset()


def read_counts():
    return {c.name: c.count for c in _counters()}


def serve_cli(n_layers: int):
    import torch
    from repro_torch.launch import serve
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    with position_counter() as pc:
        res = serve.main(["--arch", "qwen3-0.6b", "--requests", "4",
                          "--max-new", "16", "--quiet-stream"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    outs = res["outputs"]
    check(len(outs) == 4 and all(len(o) == 16 for o in outs),
          f"serve-cli: not every request returned 16 tokens: "
          f"{[len(o) for o in outs]}")
    check(res["paged_dev"] < 2e-3,
          f"serve-cli: paged-vs-logical deviation {res['paged_dev']:.3e}")
    # the startup tau probe is one gated forward: one gate_mlp and one
    # gated_flash launch per layer, before any position step
    check(counts["gate_mlp"] == n_layers * (pc.count + 1),
          f"serve-cli: gate_mlp launches {counts['gate_mlp']} != "
          f"{n_layers} x ({pc.count} positions + 1 probe)")
    check(counts["gated_flash"] == n_layers,
          f"serve-cli: gated_flash launches {counts['gated_flash']} != "
          f"{n_layers} (the tau probe)")
    check(counts["paged_decode"] >= n_layers * pc.count,
          f"serve-cli: paged_decode launches {counts['paged_decode']}")
    print(f"serve-cli: ok wall={wall:.3f}s positions={pc.count} "
          f"launches={counts} paged_dev={res['paged_dev']:.3e}")
    return counts


def profile_ticks(sess, n: int):
    """Device busy share over ``n`` serving ticks under torch.profiler
    (CUDA kernel self time summed by name, against the window's wall
    time; the profiler's own host cost inflates the wall)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            sess.tick()
        sess.orchestrator.drain()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    per_kernel = {}
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != DeviceType.CUDA:
            continue
        us = (getattr(e, "self_device_time_total", 0.0)
              or getattr(e, "self_cuda_time_total", 0.0))
        ms, calls = per_kernel.get(e.key, (0.0, 0))
        per_kernel[e.key] = (ms + us / 1e3, calls + e.count)
    busy = sum(ms for ms, _ in per_kernel.values())
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:8]
    return {"ticks": n, "wall_ms": wall_ms, "device_busy_ms": busy,
            "device_busy_share": busy / wall_ms,
            "top_kernels_ms_calls": [[k[:60], ms, calls]
                                     for k, (ms, calls) in top]}


def serve_long(card: str):
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import pool_pages_for
    from repro_torch.models.transformer import init_model
    from repro_torch.serving.backend import make_backend
    from repro_torch.serving.orchestrator import SchedulerConfig, ServeSession

    slots, cap, prompt_len, max_new = 2, 512, 384, 16
    cfg = get_config("qwen3-0.6b").replace(dtype="float32")
    gen = torch.Generator(device="cuda").manual_seed(1)
    params = init_model(cfg, gen, "cuda")
    pool_pages = pool_pages_for(cfg, slots, cap)
    eng = make_backend("wgkv", params, cfg, slots=slots, capacity=cap,
                       pool_pages=pool_pages, device="cuda")
    sess = ServeSession(eng, sched=SchedulerConfig(chunk_tokens=64,
                                                   dispatch_ahead=1))
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, cfg.vocab_size - 8, prompt_len).tolist()
               for _ in range(4)]
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    gmax, dev, verified = 0, None, 0
    with position_counter() as pc, \
            Wrapped(eng, "_mirror_prefill") as mp, \
            Wrapped(eng, "_mirror_decode") as md:
        handles = [sess.submit(p, max_new=max_new) for p in prompts]
        for _ in range(100_000):
            if not sess.tick():
                break
            if dev is None and any(h.state == "decode" for h in handles):
                # settle the mirror and check the physical pool while live
                sess.orchestrator.drain()
                node = eng.caches["blocks"]["b0"]
                live = [s for s in range(slots) if eng.live[s]]
                per_layer = node.gcnt[:, live].sum(dim=(1, 2))
                gmax = int(node.gcnt[:, live].max())
                layer = int(per_layer.argmax())
                dev = eng.verify_paged(layer_repeat=layer)
                verified += 1
        sess.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    summ = sess.telemetry.summary()
    # outside the measured window: two more long requests, and a profile
    # of decode-only ticks once both decode at long context
    extra = [sess.submit(p, max_new=8) for p in prompts[:2]]
    while not all(h.state == "decode" for h in extra):
        check(sess.tick(), "serve-long: profile requests stalled")
    prof = profile_ticks(sess, 4)
    sess.run()
    sess.close()
    n_layers = cfg.n_layers
    check(all(h.state == "done" and len(h.tokens()) == max_new
              for h in handles),
          f"serve-long: requests incomplete: "
          f"{[(h.state, len(h.tokens())) for h in handles]}")
    check(gmax > 0, "serve-long: no layer admitted a token to the global "
          "cache (lazy promotion did not run)")
    check(dev is not None and dev < 2e-3,
          f"serve-long: paged-vs-logical deviation {dev}")
    check(counts["gate_mlp"] > 0 and counts["paged_decode"] > 0,
          f"serve-long: a kernel never launched: {counts}")
    check(counts["gate_mlp"] == n_layers * pc.count,
          f"serve-long: gate_mlp launches {counts['gate_mlp']} != "
          f"{n_layers} x {pc.count} positions")
    check(counts["paged_decode"] == n_layers * pc.count + verified,
          f"serve-long: paged_decode launches {counts['paged_decode']} != "
          f"{n_layers} x {pc.count} positions + {verified} verify")
    per_pos = {k: (v - (verified if k == "paged_decode" else 0)) / pc.count
               for k, v in counts.items()}
    stats = {
        "card": card, "requests": len(handles), "prompt_len": prompt_len,
        "max_new": max_new, "slots": slots, "capacity": cap,
        "pool_pages": pool_pages, "wall_s": wall,
        "ttft_mean_s": summ["ttft_mean_s"], "ttft_p50_s": summ["ttft_p50_s"],
        "tpot_mean_s": summ["tpot_mean_s"], "tpot_p50_s": summ["tpot_p50_s"],
        "tokens_per_s": summ["tokens_per_s"],
        "mean_admission": summ["mean_admission"],
        "gcnt_max": gmax, "paged_dev": dev, "positions": pc.count,
        "launches": counts, "launches_per_position": per_pos,
        "mirror_prefill_s": mp.seconds, "mirror_prefill_calls": mp.count,
        "mirror_decode_s": md.seconds, "mirror_decode_calls": md.count,
        "collect_time_s": summ["counters"].get("collect_time_s"),
        "dispatch_time_s": summ["counters"].get("dispatch_time_s"),
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        "profile": prof,
    }
    print("serve-long: " + json.dumps(stats))
    return counts


def full_model(seed: int):
    """Full-width qwen3-0.6b (f32) with random weights drawn on the card."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_model
    cfg = get_config("qwen3-0.6b").replace(dtype="float32")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return cfg, init_model(cfg, gen, "cuda")


def greedy_decode(params, cfg, logits, caches, steps: int, opts=None):
    """``steps`` greedy decode steps from a prefill's caches; returns the
    tokens fed, every step's logits, the final caches and each step's
    stats."""
    import torch
    from repro_torch.models import inference as I
    from repro_torch.models.transformer import layer_params
    layers = layer_params(params, cfg)
    opts = opts or I.DecodeOptions()
    toks, all_logits, stats = [], [logits], []
    for _ in range(steps):
        tok = logits.argmax(-1)
        toks.append(tok)
        logits, caches, st = I.decode_step(params, cfg, tok, caches,
                                           opts=opts, layers=layers)
        all_logits.append(logits)
        stats.append(st)
    return torch.stack(toks, 1), torch.stack(all_logits, 1), caches, stats


def prefill_decode(cfg, params, seed: int, tag: str):
    """``inference.prefill`` of a 4096-token prompt (budget 1024, tokens
    from ``seed``) through a dense ``("attn",)`` model, then 16 greedy
    decode steps from its caches: one ``vertical_slash`` per layer, one
    ``gate_mlp`` per layer and position, one ``paged_decode`` per layer
    and decode step. Returns the stats and what decode-select starts
    from: the prefill's logits and caches (left untouched by the
    functional decode), the decode's tokens and logits."""
    import numpy as np
    import torch
    from repro_torch.models import inference as I
    s, budget, steps, n_layers = 4096, 1024, 16, cfg.n_layers
    toks = torch.as_tensor(np.random.default_rng(seed).integers(
        0, cfg.vocab_size - 8, (1, s)), device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with torch.no_grad():
        t0 = time.perf_counter()
        out, caches = I.prefill(params, cfg, toks, budget=budget)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        toks_off, logits, dec_caches, _ = greedy_decode(
            params, cfg, out.logits, caches, steps)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    counts = read_counts()
    node = dec_caches["blocks"]["b0"]
    gcnt = node.gcnt
    check(counts["vertical_slash"] == n_layers,
          f"{tag}: vertical_slash launches "
          f"{counts['vertical_slash']} != {n_layers}")
    check(counts["gate_mlp"] == n_layers * (1 + steps),
          f"{tag}: gate_mlp launches {counts['gate_mlp']} != "
          f"{n_layers} + {n_layers} x {steps}")
    check(counts["paged_decode"] == n_layers * steps,
          f"{tag}: paged_decode launches {counts['paged_decode']} "
          f"!= {n_layers} x {steps}")
    check(int(dec_caches["t"][0]) == s + steps
          and bool((node.t == s + steps).all()),
          f"{tag}: t {dec_caches['t'].tolist()} != {s + steps}")
    check(node.gk.shape[-2] == budget and int(gcnt.min()) > 0
          and int(gcnt.max()) <= budget,
          f"{tag}: gcnt in [{int(gcnt.min())}, {int(gcnt.max())}], "
          f"want (0, {budget}]")
    check(bool(torch.isfinite(logits).all()), f"{tag}: non-finite logits")
    stats = {"prompt_len": s, "budget": budget, "decode_steps": steps,
             "prefill_ms": (t1 - t0) * 1e3,
             "decode_ms_per_step": (t2 - t1) * 1e3 / steps,
             "mean_admission": float(out.mean_admission),
             "gcnt_min": int(gcnt.min()), "gcnt_max": int(gcnt.max()),
             "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
             "launches": counts}
    # the same prefill again, after the counts were read: the phase times
    # one cold call, so a one-off stall there shows as a gap to this one
    with torch.no_grad():
        t0 = time.perf_counter()
        again = I.prefill(params, cfg, toks, budget=budget)
        torch.cuda.synchronize()
        stats["prefill_ms_repeat"] = (time.perf_counter() - t0) * 1e3
    del again
    return stats, {"prefill_logits": out.logits, "caches": caches,
                   "tokens": toks_off, "logits": logits}


def prefill_long(cfg, params):
    """``prefill_decode`` of qwen3-0.6b. Returns the launch counts, ms and
    what decode-select starts from."""
    stats, base = prefill_decode(cfg, params, 12, "prefill-long")
    print("prefill-long: " + json.dumps(stats))
    return dict(base, counts=stats["launches"],
                prefill_ms=stats["prefill_ms"],
                decode_ms_per_step=stats["decode_ms_per_step"])


def decode_select(cfg, params, base):
    """From prefill-long's caches (C = 1024, 64 pages), 16 greedy decode
    steps with Quest selection: ``quest:64`` (every page) bitwise equal to
    prefill-long's selection-off run; ``quest:8`` read by
    ``paged_decode_selected`` alone, 8 pages per (kv head, layer);
    mask mode ``quest_pages=8`` within 5e-5 of ``quest:8``."""
    import torch
    from repro_torch.models import inference as I
    steps, n_layers = 16, cfg.n_layers

    def run(opts):
        torch.cuda.synchronize()
        reset_counts()
        with torch.no_grad():
            t0 = time.perf_counter()
            toks, logits, _, st = greedy_decode(
                params, cfg, base["prefill_logits"], base["caches"], steps,
                opts)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3 / steps
        return toks, logits, st, read_counts(), ms

    toks_all, logits_all, _, c_all, _ = run(
        I.DecodeOptions(selection_policy="quest:64"))
    check(torch.equal(toks_all, base["tokens"]),
          "decode-select: quest:64 tokens differ from selection off")
    check(torch.equal(logits_all, base["logits"]),
          "decode-select: quest:64 logits differ from selection off by "
          f"{float((logits_all - base['logits']).abs().max()):.3e}")
    check(c_all["paged_decode_selected"] == n_layers * steps
          and c_all["paged_decode"] == 0,
          f"decode-select: quest:64 launches {c_all}")
    toks8, logits8, st8, c8, ms8 = run(
        I.DecodeOptions(selection_policy="quest:8"))
    per_step = [float(st["selected_pages_rows"][0]) for st in st8]
    check(all(v == 8.0 * n_layers for v in per_step),
          f"decode-select: selected_pages_rows {per_step} != "
          f"8 x {n_layers} per step")
    check(c8["paged_decode_selected"] == n_layers * steps
          and c8["paged_decode"] == 0,
          f"decode-select: quest:8 launches {c8} (want "
          f"paged_decode_selected {n_layers} x {steps}, paged_decode 0)")
    check(bool(torch.isfinite(logits8).all()),
          "decode-select: non-finite logits")
    toks_m, logits_m, st_m, c_m, ms_m = run(I.DecodeOptions(quest_pages=8))
    err = float((logits_m - logits8).abs().max())
    check(err <= 5e-5, f"decode-select: mask mode logits differ from "
          f"quest:8 by {err:.3e} > 5e-5")
    check(torch.equal(toks_m, toks8), "decode-select: mask mode tokens "
          "differ from quest:8")
    check(c_m["paged_decode_selected"] == n_layers * steps
          and c_m["paged_decode"] == 0,
          f"decode-select: mask mode launches {c_m}")
    stats = {"decode_steps": steps,
             "decode_ms_per_step_off": base["decode_ms_per_step"],
             "decode_ms_per_step_quest8": ms8,
             "decode_ms_per_step_mask8": ms_m,
             "quest8_vs_off_max_logit_diff": float(
                 (logits8 - base["logits"]).abs().max()),
             "quest8_tokens_equal_off": bool(torch.equal(toks8,
                                                         base["tokens"])),
             "mask_vs_quest8_max_logit_err": err,
             "launches_quest64": c_all, "launches_quest8": c8,
             "launches_mask8": c_m}
    print("decode-select: " + json.dumps(stats))
    return c8


def serve_compose(card: str):
    """``ServeSession`` at full width (14 layers) composing the three
    primitives:
    learned admission, ``quest:2`` decode selection and SnapKV eviction
    (hard budget 96 global tokens per head). Prompts of 384 tokens leave
    the 256-token ring, so promotion fills the global cache past the
    budget and eviction fires; decode-only ticks run the selection
    variant. The pool is verified after a decode step's eviction was
    mirrored."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import pool_pages_for
    from repro_torch.models import inference as I
    from repro_torch.models.transformer import init_model
    from repro_torch.serving.backend import make_backend
    from repro_torch.serving.obs import Tracer
    from repro_torch.serving.orchestrator import SchedulerConfig, ServeSession

    slots, cap, prompt_len, max_new, budget = 2, 512, 384, 16, 96
    # full width, depth cut to 14 of 28 layers: eviction adds about 100
    # host-dispatched ops per layer and position, and the phase's time
    # scales with depth (28 layers: 96 s on one H100)
    cfg = get_config("qwen3-0.6b").replace(dtype="float32", n_repeats=14)
    gen = torch.Generator(device="cuda").manual_seed(3)
    params = init_model(cfg, gen, "cuda")
    eng = make_backend("wgkv", params, cfg, slots=slots, capacity=cap,
                       pool_pages=pool_pages_for(cfg, slots, cap),
                       opts=I.DecodeOptions(evict_hard_budget=budget),
                       selection="quest:2", device="cuda")
    tracer = Tracer(capacity=1 << 16)
    sess = ServeSession(eng, sched=SchedulerConfig(chunk_tokens=64,
                                                   dispatch_ahead=1),
                        tracer=tracer)
    rng = np.random.default_rng(14)
    prompts = [rng.integers(0, cfg.vocab_size - 8, prompt_len).tolist()
               for _ in range(2)]
    resyncs = []
    inner = eng._mirror_decode

    def mirror(before, after, *, rows=None, evicted_rows=None):
        if evicted_rows is not None and rows \
                and any(bool(evicted_rows[r]) for r in rows):
            resyncs.append(len(resyncs))
        return inner(before, after, rows=rows, evicted_rows=evicted_rows)
    eng._mirror_decode = mirror
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    dev = None
    with position_counter() as pc:
        handles = [sess.submit(p, max_new=max_new) for p in prompts]
        for _ in range(100_000):
            if not sess.tick():
                break
            if dev is None and resyncs and any(eng.live):
                sess.orchestrator.drain()
                dev = eng.verify_paged(layer_repeat=cfg.n_layers - 1)
        sess.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    summ = sess.telemetry.summary()
    sess.close()
    spans = {sp.name for sp in tracer.spans}
    check(all(h.state == "done" and len(h.tokens()) == max_new
              for h in handles),
          f"serve-compose: requests incomplete: "
          f"{[(h.state, len(h.tokens())) for h in handles]}")
    check(eng.stats["evict_triggers"] > 0, "serve-compose: eviction never "
          "triggered")
    check(eng.stats["selected_pages"] > 0, "serve-compose: no page selected")
    check("selection" in spans, f"serve-compose: no selection span in "
          f"{sorted(spans)}")
    check(bool(resyncs), "serve-compose: no post-eviction mirror re-sync")
    check(dev is not None and dev < 2e-3,
          f"serve-compose: paged-vs-logical deviation {dev}")
    check(counts["paged_decode_selected"] > 0 and counts["paged_decode"] > 0
          and counts["gate_mlp"] == cfg.n_layers * pc.count,
          f"serve-compose: launches {counts} over {pc.count} positions")
    stats = {"card": card, "requests": len(handles),
             "prompt_len": prompt_len, "max_new": max_new, "slots": slots,
             "capacity": cap, "evict_hard_budget": budget,
             "selection": "quest:2", "wall_s": wall, "positions": pc.count,
             "ttft_mean_s": summ["ttft_mean_s"],
             "tpot_mean_s": summ["tpot_mean_s"],
             "tokens_per_s": summ["tokens_per_s"],
             "evict_triggers": eng.stats["evict_triggers"],
             "selected_pages": eng.stats["selected_pages"],
             "selection_time_s": eng.stats["selection_time_s"],
             "evict_resync_steps": len(resyncs), "paged_dev": dev,
             "launches": counts}
    print("serve-compose: " + json.dumps(stats))
    return counts


def forward_gated(cfg, params):
    """The write-gated full-sequence forward over 2048 tokens."""
    import numpy as np
    import torch
    from repro_torch.models import transformer as T
    s, n_layers = 2048, cfg.n_layers
    toks = torch.as_tensor(np.random.default_rng(13).integers(
        0, cfg.vocab_size - 8, (1, s)), device="cuda")
    torch.cuda.synchronize()
    reset_counts()
    with torch.no_grad():
        t0 = time.perf_counter()
        res = T.forward(params, cfg, toks, mode="gated", with_logits=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = read_counts()
    shape = tuple(res.gates.shape)
    check(counts["gated_flash"] == n_layers,
          f"forward-gated: gated_flash launches {counts['gated_flash']} != "
          f"{n_layers}")
    check(counts["gate_mlp"] == n_layers,
          f"forward-gated: gate_mlp launches {counts['gate_mlp']} != "
          f"{n_layers}")
    check(shape == (n_layers, 1, cfg.n_kv_heads, s),
          f"forward-gated: gates {shape}")
    check(bool(torch.isfinite(res.hidden).all()
               and ((res.gates > 0) & (res.gates < 1)).all()),
          "forward-gated: non-finite hidden or gates outside (0, 1)")
    stats = {"seq": s, "forward_ms": wall * 1e3, "gates": list(shape),
             "admitted_frac": float((res.gates >= cfg.wgkv.tau).float()
                                    .mean()),
             "launches": counts}
    print("forward-gated: " + json.dumps(stats))
    return counts


SUBSTRATE = ROOT / "checkpoints" / "bench_model_lam0.15.npz"


def substrate_cfg():
    """The trained substrate's config:
    ``benchmarks/common.py::bench_cfg(lam=0.15)``, field for field."""
    from repro_torch.configs.base import ModelConfig, WGKVConfig
    return ModelConfig(
        name="bench-tiny", arch_type="dense", d_model=128, n_heads=4,
        n_kv_heads=2, head_dim=32, d_ff=256, vocab_size=256,
        block_pattern=("attn",), n_repeats=2, rope_theta=10000.0,
        dtype="float32", wgkv=WGKVConfig(
            enabled=True, w_local=16, tau=0.1, gate_hidden=32,
            global_budget_frac=1.0, sink=2, lam=0.15))


def substrate():
    """The trained bench substrate through prefill + 16 greedy decode steps
    on the card (kernels) and on the CPU (plain path): identical tokens and
    integer cache state, logits within 1e-4. Run twice: as served by
    default, then with ``quest:2`` decode selection and SnapKV eviction
    (hard budget 64, below the 83-103 global tokens the prompt leaves in
    the first layer's heads, so eviction fires)."""
    import numpy as np
    import torch
    from repro_torch.convert import params_from_numpy
    from repro_torch.core import selection as SEL
    from repro_torch.kernels import ops
    from repro_torch.models import inference as I
    path = SUBSTRATE
    check(path.exists(), f"substrate: {path} missing")
    cfg = substrate_cfg()
    # prompt seed 20: every gate score of this prompt, in prefill and in
    # the 16 decode steps, stays >= 1e-3 from tau (checked below)
    prompt = np.random.default_rng(20).integers(0, cfg.vocab_size, (1, 128))
    steps, tau, k_sel = 16, cfg.wgkv.tau, 2
    composed = I.DecodeOptions(selection_policy=f"quest:{k_sel}",
                               evict_hard_budget=64)

    def run(device: str, opts):
        params = params_from_numpy(path, cfg, device)
        with torch.no_grad():
            out, caches = I.prefill(params, cfg,
                                    torch.as_tensor(prompt, device=device),
                                    opts=opts)
            toks, logits, caches, st = greedy_decode(
                params, cfg, out.logits, caches, steps, opts)
        trig = sum(float(x["evict_trigger_rows"].sum()) for x in st)
        return out, toks.cpu(), logits.cpu(), caches, trig

    def compare(tag, opts, cpu, want_counts):
        torch.cuda.synchronize()
        reset_counts()
        gpu = run("cuda", opts)
        torch.cuda.synchronize()
        counts = read_counts()
        cpu_out, cpu_toks, cpu_logits, cpu_caches, cpu_trig = cpu
        gpu_out, gpu_toks, gpu_logits, gpu_caches, gpu_trig = gpu
        check(all(counts[k] == v for k, v in want_counts.items()),
              f"substrate{tag}: the card run missed its kernels: {counts}")
        check(torch.equal(gpu_toks, cpu_toks),
              f"substrate{tag}: greedy tokens differ: {gpu_toks.tolist()} "
              f"vs {cpu_toks.tolist()}")
        err = float((gpu_logits - cpu_logits).abs().max())
        check(err <= 1e-4, f"substrate{tag}: logits differ by {err:.3e} > "
              "1e-4")
        check(torch.equal(gpu_caches["t"].cpu(), cpu_caches["t"]),
              f"substrate{tag}: t differs")
        gnode, cnode = gpu_caches["blocks"]["b0"], cpu_caches["blocks"]["b0"]
        for name in ("t", "ptr", "lpos", "gpos", "gcnt", "overflow"):
            check(torch.equal(getattr(gnode, name).cpu(),
                              getattr(cnode, name)),
                  f"substrate{tag}: cache {name} differs between card and "
                  "CPU")
        check(gpu_trig == cpu_trig, f"substrate{tag}: eviction triggers "
              f"{gpu_trig} (CPU {cpu_trig})")
        adm = float(gpu_out.mean_admission)
        check(abs(adm - float(cpu_out.mean_admission)) <= 1e-6
              and 0 < adm < 1,
              f"substrate{tag}: mean_admission {adm} (CPU "
              f"{float(cpu_out.mean_admission)})")
        return {"mean_admission": adm, "max_logit_err": err,
                "tokens": gpu_toks[0].tolist(),
                "gcnt": gnode.gcnt[:, 0].tolist(), "evict_triggers": gpu_trig,
                "launches": counts}

    scores, gaps = [], []
    inner_gate, inner_topk = ops.write_gate, SEL.topk_page_ids

    def recording(*a, **kw):
        g = inner_gate(*a, **kw)
        scores.append(g)
        return g

    def topk_gap(q, meta, k):
        # gap between the K-th and (K+1)-th page upper bound (inf where
        # fewer than K+1 pages hold tokens): a near-tie could flip the pick
        srt = torch.sort(SEL.page_upper_bound(q, meta), dim=-1,
                         descending=True).values
        gap = srt[..., k - 1] - srt[..., k]
        gaps.append(float(torch.where(torch.isfinite(srt[..., k]), gap,
                                      torch.full_like(gap, float("inf")))
                          .min()))
        return inner_topk(q, meta, k)
    ops.write_gate, SEL.topk_page_ids = recording, topk_gap
    try:
        cpu_plain = run("cpu", I.DecodeOptions())
        n_plain = len(scores)
        cpu_comp = run("cpu", composed)
    finally:
        ops.write_gate, SEL.topk_page_ids = inner_gate, inner_topk
    margin = min(float((g - tau).abs().min()) for g in scores[:n_plain])
    check(margin >= 1e-3, f"substrate: gate margin {margin:.2e} < 1e-3 "
          "(pick another prompt seed)")
    # the composed run decodes other tokens, so it sees other gate scores;
    # card and CPU gates agree to about 1e-6 (logits to 1e-5), so a margin
    # of 1e-4 still cannot flip an admission
    margin_comp = min(float((g - tau).abs().min())
                      for g in scores[n_plain:])
    check(margin_comp >= 1e-4, f"substrate: composed-run gate margin "
          f"{margin_comp:.2e} < 1e-4")
    check(cpu_comp[4] > 0, "substrate: eviction never triggered")
    n = cfg.n_layers
    plain = compare("", I.DecodeOptions(), cpu_plain,
                    {"vertical_slash": n, "paged_decode": n * steps,
                     "paged_decode_selected": 0})
    comp = compare(" (quest:2 + eviction)", composed, cpu_comp,
                   {"vertical_slash": n, "paged_decode": 0,
                    "paged_decode_selected": n * steps})
    stats = {"prompt_len": prompt.shape[1], "decode_steps": steps,
             "tau_margin": margin, **plain,
             "composed": {"selection": composed.selection_policy,
                          "evict_hard_budget": composed.evict_hard_budget,
                          "tau_margin": margin_comp,
                          "min_topk_ub_gap": min(gaps), **comp}}
    print("substrate: " + json.dumps(stats))
    return comp["launches"]


def _serve_until_decoding(sess, eng, handles, verify: bool):
    """Tick ``sess`` to the end; once every handle decodes, settle the
    mirror and, on a paged backend with ``verify``, check the physical
    pool (``verify_paged``, one ``paged_decode`` launch). Returns the
    deviation (None when not checked)."""
    dev = None
    for _ in range(100_000):
        if not sess.tick():
            break
        if verify and dev is None and all(h.state == "decode"
                                          for h in handles):
            sess.orchestrator.drain()
            dev = eng.verify_paged()
    sess.run()
    return dev


def serve_ab(card: str):
    """The serving A/B at full width (depth cut to 14 of 28 layers, as in
    serve-compose): the same 2 x 384-token prompts and 16 new tokens
    through ``ServeSession`` over ``wgkv`` then ``dense``, then one of
    them through ``streaming_llm`` and ``duo``. Per backend: TTFT, TPOT,
    tokens/s, the KV-token peak and resident KV bytes (logical, and the
    device buffers of the batched tree plus the pool's pages). ``dense``
    must run only ``paged_decode`` (never the gate), the static
    backends never the gate; the paged backends' pools verify."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import pool_pages_for
    from repro_torch.launch.specs import cache_tree_bytes
    from repro_torch.models.transformer import init_model
    from repro_torch.serving.backend import make_backend
    from repro_torch.serving.orchestrator import SchedulerConfig, ServeSession

    slots, cap, prompt_len, max_new = 2, 512, 384, 16
    cfg = get_config("qwen3-0.6b").replace(dtype="float32", n_repeats=14)
    gen = torch.Generator(device="cuda").manual_seed(15)
    params = init_model(cfg, gen, "cuda")
    rng = np.random.default_rng(15)
    prompts = [rng.integers(0, cfg.vocab_size - 8, prompt_len).tolist()
               for _ in range(2)]
    n = cfg.n_layers
    out, counts_by = {}, {}
    for name, n_req in (("wgkv", 2), ("dense", 2), ("streaming_llm", 1),
                        ("duo", 1)):
        eng = make_backend(name, params, cfg, slots=slots, capacity=cap,
                           pool_pages=pool_pages_for(cfg, slots, cap),
                           device="cuda")
        paged = eng.capabilities().paged
        sess = ServeSession(eng, sched=SchedulerConfig(chunk_tokens=64,
                                                       dispatch_ahead=1))
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        with position_counter() as pc:
            handles = [sess.submit(p, max_new=max_new)
                       for p in prompts[:n_req]]
            dev = _serve_until_decoding(sess, eng, handles, paged)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        summ = sess.telemetry.summary()
        buf_bytes = cache_tree_bytes(eng.caches)
        pool_bytes = (summ["pool_pages_peak"] or 0) * 16 * cfg.head_dim * 2 * 4
        sess.close()
        check(all(h.state == "done" and len(h.tokens()) == max_new
                  for h in handles),
              f"serve-ab {name}: requests incomplete: "
              f"{[(h.state, len(h.tokens())) for h in handles]}")
        verified = 1 if dev is not None else 0
        check(counts["paged_decode"] == n * pc.count + verified,
              f"serve-ab {name}: paged_decode launches "
              f"{counts['paged_decode']} != {n} x {pc.count} positions + "
              f"{verified} verify")
        gate_want = n * pc.count if name == "wgkv" else 0
        check(counts["gate_mlp"] == gate_want,
              f"serve-ab {name}: gate_mlp launches {counts['gate_mlp']} != "
              f"{gate_want}")
        check(counts["gated_flash"] == 0 and counts["vertical_slash"] == 0,
              f"serve-ab {name}: unexpected prefill kernels {counts}")
        if paged:
            check(dev is not None and dev < 2e-3,
                  f"serve-ab {name}: paged-vs-logical deviation {dev}")
        out[name] = {
            "requests": n_req, "wall_s": wall, "positions": pc.count,
            "ttft_mean_s": summ["ttft_mean_s"],
            "tpot_mean_s": summ["tpot_mean_s"],
            "tokens_per_s": summ["tokens_per_s"],
            "mean_admission": summ["mean_admission"],
            "kv_tokens_peak": summ["kv_tokens_peak"],
            "kv_bytes_peak": summ["kv_bytes_peak"],
            "cache_buffer_bytes": buf_bytes, "pool_bytes_peak": pool_bytes,
            "pool_pages_peak": summ["pool_pages_peak"], "paged_dev": dev,
            "launches": counts}
        counts_by[name] = counts
        del eng, sess
        free_cuda()
    ratio = out["wgkv"]["kv_tokens_peak"] / out["dense"]["kv_tokens_peak"]
    check(out["dense"]["mean_admission"] == 1.0,
          f"serve-ab: dense admission {out['dense']['mean_admission']}")
    stats = {"card": card, "layers": n, "slots": slots, "capacity": cap,
             "prompt_len": prompt_len, "max_new": max_new,
             "backends": out, "kv_tokens_peak_wgkv_over_dense": ratio,
             "note": "random gates admit nearly every token, so this "
                     "memory ratio says nothing about the paper's claim"}
    print("serve-ab: " + json.dumps(stats), flush=True)
    return counts_by


def prefill_dense(cfg, params, long_stats):
    """``inference.prefill(use_wgkv=False)`` of prefill-long's 4096-token
    prompt at full width and depth (causal attention through
    ``gated_flash`` at W = S, a dense cache of 4160 slots per layer), then
    16 greedy dense ``decode_step``s (one-segment ``paged_decode``)."""
    import numpy as np
    import torch
    from repro_torch.launch.specs import cache_tree_bytes
    from repro_torch.models import inference as I
    s, steps, n = 4096, 16, cfg.n_layers
    toks = torch.as_tensor(np.random.default_rng(12).integers(
        0, cfg.vocab_size - 8, (1, s)), device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with torch.no_grad():
        t0 = time.perf_counter()
        out, caches = I.prefill(params, cfg, toks, use_wgkv=False)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        _, logits, dec, _ = greedy_decode(params, cfg, out.logits, caches,
                                          steps)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    counts = read_counts()
    node = dec["blocks"]["b0"]
    check(counts["gated_flash"] == n,
          f"prefill-dense: gated_flash launches {counts['gated_flash']} != "
          f"{n}")
    check(counts["paged_decode"] == n * steps,
          f"prefill-dense: paged_decode launches {counts['paged_decode']} "
          f"!= {n} x {steps}")
    check(counts["gate_mlp"] == 0 and counts["vertical_slash"] == 0,
          f"prefill-dense: WG-KV kernels ran: {counts}")
    check(tuple(node.k.shape) == (n, 1, cfg.n_kv_heads, 4160, cfg.head_dim)
          and bool((node.t == s + steps).all()),
          f"prefill-dense: cache {tuple(node.k.shape)} t "
          f"{node.t.unique().tolist()}")
    check(bool(torch.isfinite(logits).all()), "prefill-dense: non-finite "
          "logits")
    stats = {"prompt_len": s, "decode_steps": steps,
             "prefill_ms": (t1 - t0) * 1e3,
             "decode_ms_per_step": (t2 - t1) * 1e3 / steps,
             "wgkv_prefill_ms": long_stats["prefill_ms"],
             "wgkv_decode_ms_per_step": long_stats["decode_ms_per_step"],
             "dense_cache_gib": cache_tree_bytes(caches["blocks"]) / 2 ** 30,
             "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
             "launches": counts}
    print("prefill-dense: " + json.dumps(stats), flush=True)
    return counts


def prefix_phase(card: str):
    """A multi-turn replay at full width (depth cut to 4 of 28 layers):
    2 conversations x 2 turns, chunk 64, a first prompt of 264 tokens
    (past the 256-token ring, so the global segment holds tokens), each
    turn adding the 16-token reply and 48 user tokens (one chunk), so
    turn 2 resumes from the stored 256-token prefix. For ``wgkv`` and
    ``dense``: cold (no store) and through the store; hit streams equal
    cold streams, the hit rate is above 0, a hit row's pool verifies
    mid-decode (wgkv), and every page is reclaimed after the store is
    cleared."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import pool_pages_for
    from repro_torch.models.transformer import init_model
    from repro_torch.serving.backend import make_backend
    from repro_torch.serving.orchestrator import SchedulerConfig, ServeSession
    from repro_torch.serving.prefix_cache import PrefixCache

    slots, cap, chunk, plen, mnew, user = 2, 512, 64, 264, 16, 48
    cfg = get_config("qwen3-0.6b").replace(dtype="float32", n_repeats=4)
    gen = torch.Generator(device="cuda").manual_seed(16)
    params = init_model(cfg, gen, "cuda")
    n = cfg.n_layers

    def turns(eng, pc, verify):
        rng = np.random.default_rng(16)
        prompts = [rng.integers(0, cfg.vocab_size - 8, plen).tolist()
                   for _ in range(2)]
        streams, devs = [], []
        for turn in range(2):
            sess = ServeSession(eng, sched=SchedulerConfig(
                chunk_tokens=chunk, dispatch_ahead=1), prefix_cache=pc)
            hs = [sess.submit(p, max_new=mnew) for p in prompts]
            # turn 2's rows resume from stored prefixes: verify them
            dev = _serve_until_decoding(sess, eng, hs, verify and turn == 1)
            if dev is not None:
                check(all(r.prefix_hit for r in sess.telemetry.records),
                      "prefix: a turn-2 request missed the store")
                devs.append(dev)
            sess.close()
            outs = [h.tokens() for h in hs]
            streams.append(outs)
            prompts = [p + o + rng.integers(0, cfg.vocab_size - 8,
                                            user).tolist()
                       for p, o in zip(prompts, outs)]
        return streams, devs

    out, counts_by = {}, {}
    for name in ("wgkv", "dense"):
        # the pool holds the slots and the store's entries (up to 4)
        eng = make_backend(name, params, cfg, slots=slots, capacity=cap,
                           pool_pages=pool_pages_for(cfg, slots + 4, cap),
                           device="cuda")
        paged = eng.capabilities().paged
        cold, _ = turns(eng, None, False)
        pc = PrefixCache(quantum=chunk, free_fn=eng.release_prefix)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        with position_counter() as pcnt:
            warm, devs = turns(eng, pc, paged)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        hit_rate = pc.hits / max(pc.hits + pc.misses, 1)
        check(warm == cold, f"prefix {name}: hit streams differ from cold")
        check(pc.hits > 0 and hit_rate > 0, f"prefix {name}: no hit "
              f"({pc.hits} hits, {pc.misses} misses)")
        verified = len(devs)
        if paged:
            check(verified > 0 and max(devs) < 2e-3,
                  f"prefix {name}: hit-row pool deviation {devs}")
        check(counts["paged_decode"] == n * pcnt.count + verified,
              f"prefix {name}: paged_decode launches "
              f"{counts['paged_decode']} != {n} x {pcnt.count} + {verified}")
        check(counts["gate_mlp"] == (n * pcnt.count if name == "wgkv"
                                     else 0),
              f"prefix {name}: gate_mlp launches {counts['gate_mlp']}")
        stats = {"hits": pc.hits, "misses": pc.misses, "hit_rate": hit_rate,
                 "inserts": pc.inserts, "store_bytes": pc.bytes_used,
                 "positions_warm": pcnt.count, "wall_warm_s": wall,
                 "paged_dev_hit_rows": devs, "launches": counts}
        pc.clear()
        check(len(pc) == 0 and pc.bytes_used == 0,
              f"prefix {name}: the store kept entries after clear")
        if paged:
            check(eng.pool.pages_in_use == 0,
                  f"prefix {name}: {eng.pool.pages_in_use} pool pages left "
                  "after the store was cleared")
        out[name] = stats
        counts_by[name] = counts
    print("prefix: " + json.dumps({"card": card, "layers": n,
                                   "chunk": chunk, "backends": out}),
          flush=True)
    return counts_by


def substrate_ab():
    """The trained substrate served by ``dense``, ``streaming_llm`` and
    ``duo`` on the card (kernels) and on the CPU (plain path): two numpy
    prompts (128 and 60 tokens, past the 16-token ring), 8 new tokens,
    chunk 32. Greedy streams, resident KV tokens tick by tick and every
    integer cache leaf must be identical."""
    import numpy as np
    import torch
    from repro_torch.convert import params_from_numpy
    from repro_torch.serving.backend import make_backend
    from repro_torch.serving.orchestrator import SchedulerConfig, ServeSession
    from repro_torch.tree import tree_leaves_with_path
    path = SUBSTRATE
    cfg = substrate_cfg()
    prompts = [np.random.default_rng(20).integers(0, 256, 128).tolist(),
               np.random.default_rng(21).integers(0, 256, 60).tolist()]

    def run(name, device):
        params = params_from_numpy(path, cfg, device)
        eng = make_backend(name, params, cfg, slots=2, capacity=192,
                           pool_pages=512, device=device)
        sess = ServeSession(eng, sched=SchedulerConfig(chunk_tokens=32))
        hs = [sess.submit(p, max_new=8) for p in prompts]
        kv = []
        with position_counter() as pc:
            while sess.tick():
                sess.orchestrator.drain()
                kv.append(eng.memory_snapshot()["kv_tokens"])
            sess.run()
        sess.close()
        ints = {p: x.cpu() for p, x in tree_leaves_with_path(eng.caches)
                if not x.is_floating_point()}
        return [h.tokens() for h in hs], kv, ints, pc.count

    out, counts_by = {}, {}
    for name in ("dense", "streaming_llm", "duo"):
        cpu = run(name, "cpu")
        torch.cuda.synchronize()
        reset_counts()
        gpu = run(name, "cuda")
        torch.cuda.synchronize()
        counts = read_counts()
        n = cfg.n_layers
        check(gpu[0] == cpu[0], f"substrate-ab {name}: streams differ: "
              f"{gpu[0]} vs {cpu[0]}")
        check(gpu[1] == cpu[1], f"substrate-ab {name}: KV tokens per tick "
              "differ")
        check(gpu[2].keys() == cpu[2].keys() and all(
            torch.equal(gpu[2][k], cpu[2][k]) for k in cpu[2]),
            f"substrate-ab {name}: integer cache state differs")
        check(counts["paged_decode"] == n * gpu[3]
              and counts["gate_mlp"] == 0 and counts["gated_flash"] == 0,
              f"substrate-ab {name}: launches {counts} over {gpu[3]} "
              "positions")
        out[name] = {"tokens": gpu[0], "kv_tokens_peak": max(gpu[1]),
                     "int_leaves": len(cpu[2]), "positions": gpu[3],
                     "launches": counts}
        counts_by[name] = counts
    print("substrate-ab: " + json.dumps(out), flush=True)
    return counts_by


def train_card_vs_cpu(tag: str, cfg, cpu_params, token_seed: int,
                      min_margin: float):
    """Three ``train_step``s of ``cpu_params`` (a CPU tree, copied to the
    card) from the same numpy tokens (3 batches of 2 x 128) on the card
    (kernels) and on the CPU (plain path): every step's loss and aux
    within 1e-4 relative, distill not 0, and the gate gradients of the
    first within 1e-4 of the largest magnitude of each CPU gradient; on
    the card, ``remat=True`` gives those gradients bit for bit, and the
    kernels launch as ``train_launches`` says for four gradient
    evaluations. Every gate score must sit ``min_margin`` from tau, so
    the admission rate cannot flip between the devices."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.training import trainer as TR
    from repro_torch.tree import tree_map
    rng = np.random.default_rng(token_seed)
    toks = [rng.integers(0, cfg.vocab_size - 8, (2, 128)).astype(np.int32)
            for _ in range(3)]

    def run(device):
        params = tree_map(lambda x: x.to(device), cpu_params)
        batches = [{"tokens": torch.as_tensor(t, device=device)}
                   for t in toks]
        state = TR.init_train_state(params)
        _, _, grads = TR.loss_and_grads(state.gates, params, cfg, batches[0],
                                        lam=cfg.wgkv.lam)
        metrics = []
        for b in batches:
            state, m = TR.train_step(state, params, cfg, b, lr=1e-3)
            metrics.append({k: float(v) for k, v in m.items()})
        return {k: v.cpu() for k, v in grads.items()}, metrics, params, \
            batches[0]

    scores = []
    inner = ops.write_gate

    def recording(*a, **kw):
        g = inner(*a, **kw)
        scores.append(g.detach())
        return g
    ops.write_gate = recording
    try:
        cpu_grads, cpu_metrics, _, _ = run("cpu")
    finally:
        ops.write_gate = inner
    margin = min(float((g - cfg.wgkv.tau).abs().min()) for g in scores)
    check(margin >= min_margin, f"{tag}: gate margin {margin:.2e} < "
          f"{min_margin}")
    torch.cuda.synchronize()
    reset_counts()
    gpu_grads, gpu_metrics, params, batch = run("cuda")
    torch.cuda.synchronize()
    counts = read_counts()
    # remat: each block's forward, lse included, runs again inside the
    # backward; the kernels are deterministic, so the gradients must be
    # the same bits (outside the counted run)
    _, _, remat_grads = TR.loss_and_grads(TR.get_gates(params), params, cfg,
                                          batch, lam=cfg.wgkv.lam, remat=True)
    check(all(torch.equal(remat_grads[k].cpu(), gpu_grads[k])
              for k in gpu_grads), f"{tag}: remat=True changed the gate "
          "gradients")
    want = {k: 4 * v for k, v in train_launches(cfg).items()}
    check(counts == want, f"{tag}: launches {counts} != {want} (four "
          "gradient evaluations)")
    loss_err = 0.0
    for i, (gm, cm) in enumerate(zip(gpu_metrics, cpu_metrics)):
        check(set(gm) == set(cm), f"{tag}: metric keys {set(gm)}")
        for k in cm:
            err = abs(gm[k] - cm[k]) / max(abs(cm[k]), 1e-30)
            loss_err = max(loss_err, err)
            check(err <= 1e-4, f"{tag}: step {i} {k} {gm[k]} vs CPU {cm[k]} "
                  f"(relative {err:.2e} > 1e-4)")
    check(all(m["distill"] > 0 for m in cpu_metrics),
          f"{tag}: distill 0 {cpu_metrics}")
    grad_err = {k: rel_err(gpu_grads[k], cpu_grads[k]) for k in cpu_grads}
    check(max(grad_err.values()) <= 1e-4,
          f"{tag}: gate gradients differ {grad_err}")
    stats = {"layers": cfg.n_layers, "tau_margin": margin,
             "max_rel_metric_err": loss_err, "grad_rel_err": grad_err,
             "remat_grads_bitwise": True,
             "losses": [m["loss"] for m in gpu_metrics],
             "cpu_losses": [m["loss"] for m in cpu_metrics],
             "launches": counts}
    print(f"{tag}: " + json.dumps(stats), flush=True)
    return counts


def train_substrate():
    """``train_card_vs_cpu`` on the trained bench substrate. The tokens
    (seed 72) keep every gate score >= 1e-4 from tau."""
    from repro_torch.convert import params_from_numpy
    cfg = substrate_cfg()
    return train_card_vs_cpu("train-substrate", cfg,
                             params_from_numpy(SUBSTRATE, cfg, "cpu"), 72,
                             1e-4)


def free_cuda():
    """Release what the previous phase left cached on the card."""
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def rg_serve(card: str):
    """``repro_torch.launch.serve --arch recurrentgemma-9b`` at full width:
    2 requests of 64 tokens, 8 new tokens, 2 slots, capacity 512, the
    startup tau probe (a gated forward through the hybrid) included. The
    CLI builds its own model and drops it when it returns."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    cfg = get_config("recurrentgemma-9b")
    n_attn = cfg.n_repeats * cfg.attn_blocks_per_pattern
    n_rec = cfg.n_layers - n_attn
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    with position_counter() as pc:
        res = serve.main(["--arch", "recurrentgemma-9b", "--requests", "2",
                          "--prompt-len", "64", "--max-new", "8",
                          "--slots", "2", "--capacity", "512",
                          "--quiet-stream"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    outs = res["outputs"]
    summ = res["summary"]
    check(len(outs) == 2 and all(len(o) == 8 for o in outs),
          f"rg-serve: not every request returned 8 tokens: "
          f"{[len(o) for o in outs]}")
    check(res["paged_dev"] < 2e-3,
          f"rg-serve: paged-vs-logical deviation {res['paged_dev']:.3e}")
    # the probe: one gated forward (gate_mlp and gated_flash once per
    # attention layer, rglru_scan once per recurrent layer); then one
    # gate_mlp and one paged_decode per attention layer and position
    check(counts["rglru_scan"] == n_rec,
          f"rg-serve: rglru_scan launches {counts['rglru_scan']} != "
          f"{n_rec} (the tau probe)")
    check(counts["gated_flash"] == n_attn,
          f"rg-serve: gated_flash launches {counts['gated_flash']} != "
          f"{n_attn} (the tau probe)")
    check(counts["gate_mlp"] == n_attn * (pc.count + 1),
          f"rg-serve: gate_mlp launches {counts['gate_mlp']} != {n_attn} x "
          f"({pc.count} positions + 1 probe)")
    check(counts["paged_decode"] >= n_attn * pc.count,
          f"rg-serve: paged_decode launches {counts['paged_decode']}")
    stats = {"card": card, "requests": 2, "prompt_len": 64, "max_new": 8,
             "slots": 2, "capacity": 512, "wall_s": wall,
             "positions": pc.count, "ttft_mean_s": summ["ttft_mean_s"],
             "ttft_p50_s": summ["ttft_p50_s"],
             "tpot_mean_s": summ["tpot_mean_s"],
             "tpot_p50_s": summ["tpot_p50_s"],
             "tokens_per_s": summ["tokens_per_s"],
             "mean_admission": summ["mean_admission"],
             "paged_dev": res["paged_dev"],
             "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
             "launches": counts}
    print("rg-serve: " + json.dumps(stats), flush=True)
    return counts


def rg_model(seed: int):
    """Full-width recurrentgemma-9b (38 layers, d_model 4096, f32) with
    random weights drawn on the card."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_model
    cfg = get_config("recurrentgemma-9b").replace(dtype="float32")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return cfg, init_model(cfg, gen, "cuda")


def rg_prefill(cfg, params):
    """``inference.prefill`` of one 4096-token prompt through the hybrid
    (budget 1024, the local-attention ring 2048), then 16 greedy
    ``decode_step``s."""
    import numpy as np
    import torch
    from repro_torch.models import inference as I
    from repro_torch.models import rglru as RG
    s, budget, steps = 4096, 1024, 16
    n_attn = cfg.n_repeats * cfg.attn_blocks_per_pattern
    n_rec = cfg.n_layers - n_attn
    toks = torch.as_tensor(np.random.default_rng(15).integers(
        0, cfg.vocab_size - 8, (1, s)), device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with torch.no_grad():
        t0 = time.perf_counter()
        out, caches = I.prefill(params, cfg, toks, budget=budget)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        prefill_counts = read_counts()
        _, logits, dec_caches, _ = greedy_decode(params, cfg, out.logits,
                                                 caches, steps)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    counts = read_counts()
    check(prefill_counts["rglru_scan"] == n_rec,
          f"rg-prefill: rglru_scan launches {prefill_counts['rglru_scan']} "
          f"!= {n_rec}")
    check(prefill_counts["vertical_slash"] == n_attn,
          f"rg-prefill: vertical_slash launches "
          f"{prefill_counts['vertical_slash']} != {n_attn}")
    check(counts["rglru_scan"] == n_rec,
          f"rg-prefill: decode launched rglru_scan ({counts})")
    check(counts["gate_mlp"] == n_attn * (1 + steps),
          f"rg-prefill: gate_mlp launches {counts['gate_mlp']} != "
          f"{n_attn} + {n_attn} x {steps}")
    check(counts["paged_decode"] == n_attn * steps,
          f"rg-prefill: paged_decode launches {counts['paged_decode']} != "
          f"{n_attn} x {steps}")
    node = dec_caches["blocks"]["b2"]
    gcnt = node.gcnt
    check(node.w_local == cfg.sliding_window and node.budget == budget,
          f"rg-prefill: ring {node.w_local}, budget {node.budget}")
    check(int(dec_caches["t"][0]) == s + steps
          and bool((node.t == s + steps).all()),
          f"rg-prefill: t {dec_caches['t'].tolist()} != {s + steps}")
    check(0 < int(gcnt.min()) and int(gcnt.max()) <= budget,
          f"rg-prefill: gcnt in [{int(gcnt.min())}, {int(gcnt.max())}]")
    states = list(dec_caches.get("stem", ())) + [
        dec_caches["blocks"][f"b{i}"]
        for i, bt in enumerate(cfg.block_pattern) if bt == "rglru"]
    check(all(isinstance(st, RG.RGLRUState) and bool(torch.isfinite(st.h)
                                                     .all())
              for st in states), "rg-prefill: a recurrent state is not "
          "finite")
    check(bool(torch.isfinite(logits).all()), "rg-prefill: non-finite "
          "logits")
    stats = {"prompt_len": s, "budget": budget, "ring": node.w_local,
             "decode_steps": steps, "prefill_ms": (t1 - t0) * 1e3,
             "decode_ms_per_step": (t2 - t1) * 1e3 / steps,
             "mean_admission": float(out.mean_admission),
             "gcnt_min": int(gcnt.min()), "gcnt_max": int(gcnt.max()),
             "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
             "launches_prefill": prefill_counts, "launches": counts}
    print("rg-prefill: " + json.dumps(stats), flush=True)
    return prefill_counts, counts


def rg_forward(cfg, params):
    """The write-gated forward of the hybrid over 4096 tokens: the window
    is 2048, so half of the keys are gated."""
    import numpy as np
    import torch
    from repro_torch.models import transformer as T
    s = 4096
    n_attn = cfg.n_repeats * cfg.attn_blocks_per_pattern
    n_rec = cfg.n_layers - n_attn
    toks = torch.as_tensor(np.random.default_rng(16).integers(
        0, cfg.vocab_size - 8, (1, s)), device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with torch.no_grad():
        t0 = time.perf_counter()
        res = T.forward(params, cfg, toks, mode="gated", with_logits=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = read_counts()
    shape = tuple(res.gates.shape)
    check(counts["rglru_scan"] == n_rec,
          f"rg-forward: rglru_scan launches {counts['rglru_scan']} != {n_rec}")
    check(counts["gated_flash"] == n_attn,
          f"rg-forward: gated_flash launches {counts['gated_flash']} != "
          f"{n_attn}")
    check(counts["gate_mlp"] == n_attn,
          f"rg-forward: gate_mlp launches {counts['gate_mlp']} != {n_attn}")
    check(shape == (n_attn, 1, cfg.n_kv_heads, s), f"rg-forward: gates "
          f"{shape}")
    check(bool(torch.isfinite(res.hidden).all()
               and ((res.gates > 0) & (res.gates < 1)).all()),
          "rg-forward: non-finite hidden or gates outside (0, 1)")
    stats = {"seq": s, "window": cfg.sliding_window,
             "forward_ms": wall * 1e3, "gates": list(shape),
             "admitted_frac": float((res.gates >= cfg.wgkv.tau).float()
                                    .mean()),
             "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
             "launches": counts}
    print("rg-forward: " + json.dumps(stats), flush=True)
    return counts


def rg_substrate():
    """The reduced hybrid (2-block RG-LRU stem, then RG-LRU, RG-LRU,
    local attention with a 32-token window; seeded random weights, the
    gate set to admit about half the tokens with scores far from tau)
    through prefill of a 128-token prompt and 8 greedy decode steps on
    the card (kernels) and on the CPU (plain path): identical tokens and
    integer cache state, logits and recurrent states within 1e-4."""
    import numpy as np
    import torch
    from repro_torch.configs import get_reduced_config
    from repro_torch.kernels import ops
    from repro_torch.models import inference as I
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_leaves_with_path, tree_map
    cfg = get_reduced_config("recurrentgemma-9b").replace(
        dtype="float32", stem_pattern=("rglru", "rglru"), sliding_window=32)
    cpu_params = T.init_model(cfg, torch.Generator().manual_seed(4), "cpu")
    # hidden unit 0 reads gate feature 0: g = sigmoid(200 gelu(x0) - 4)
    for i, bt in enumerate(cfg.block_pattern):
        if bt == "local_attn":
            gate = cpu_params["blocks"][f"b{i}"]["attn"]["gate"]
            for k in ("w1", "b1", "w2"):
                gate[k].zero_()
            gate["w1"][:, :, 0, 0] = 1.0
            gate["w2"][:, :, 0, 0] = 200.0
            gate["b2"].fill_(-4.0)
    prompt = np.random.default_rng(21).integers(0, cfg.vocab_size, (1, 128))
    steps, tau = 8, cfg.wgkv.tau

    def run(device, params):
        with torch.no_grad():
            out, caches = I.prefill(params, cfg,
                                    torch.as_tensor(prompt, device=device))
            toks, logits, caches, _ = greedy_decode(params, cfg, out.logits,
                                                    caches, steps)
        return out, toks.cpu(), logits.cpu(), caches

    scores = []
    inner = ops.write_gate

    def recording(*a, **kw):
        g = inner(*a, **kw)
        scores.append(g)
        return g
    ops.write_gate = recording
    try:
        cpu_out, cpu_toks, cpu_logits, cpu_caches = run("cpu", cpu_params)
    finally:
        ops.write_gate = inner
    margin = min(float((g - tau).abs().min()) for g in scores)
    check(margin >= 1e-3, f"rg-substrate: gate margin {margin:.2e} < 1e-3")
    gpu_params = tree_map(lambda x: x.to("cuda"), cpu_params)
    torch.cuda.synchronize()
    reset_counts()
    gpu_out, gpu_toks, gpu_logits, gpu_caches = run("cuda", gpu_params)
    torch.cuda.synchronize()
    counts = read_counts()
    n_attn = cfg.n_repeats * cfg.attn_blocks_per_pattern
    n_rec = cfg.n_layers - n_attn
    want = {"rglru_scan": n_rec, "vertical_slash": n_attn,
            "gate_mlp": n_attn * (1 + steps),
            "paged_decode": n_attn * steps}
    check(all(counts[k] == v for k, v in want.items()),
          f"rg-substrate: the card run missed its kernels: {counts}")
    top2 = torch.topk(cpu_logits, 2, dim=-1).values
    gap = float((top2[..., 0] - top2[..., 1]).min())
    check(torch.equal(gpu_toks, cpu_toks),
          f"rg-substrate: greedy tokens differ: {gpu_toks.tolist()} vs "
          f"{cpu_toks.tolist()}")
    err = float((gpu_logits - cpu_logits).abs().max())
    check(err <= 1e-4, f"rg-substrate: logits differ by {err:.3e} > 1e-4")
    ints = {"t", "ptr", "lpos", "gpos", "gcnt", "overflow"}
    h_err = 0.0
    gpu_leaves = dict(tree_leaves_with_path(gpu_caches))
    for path, want_leaf in tree_leaves_with_path(cpu_caches):
        got = gpu_leaves[path].cpu()
        if path[-1] in ints:
            check(torch.equal(got, want_leaf), f"rg-substrate: cache "
                  f"{'/'.join(map(str, path))} differs between card and CPU")
        elif path[-1] == "h":
            h_err = max(h_err, float((got - want_leaf).abs().max()))
    check(h_err <= 1e-4, f"rg-substrate: recurrent state h differs by "
          f"{h_err:.3e} > 1e-4")
    adm = float(gpu_out.mean_admission)
    check(abs(adm - float(cpu_out.mean_admission)) <= 1e-6,
          f"rg-substrate: mean_admission {adm} (CPU "
          f"{float(cpu_out.mean_admission)})")
    gcnt = gpu_caches["blocks"]["b2"].gcnt
    stats = {"prompt_len": prompt.shape[1], "decode_steps": steps,
             "window": cfg.sliding_window, "layers": cfg.n_layers,
             "tau_margin": margin, "mean_admission": adm,
             "max_logit_err": err, "max_h_err": h_err,
             "min_top2_logit_gap": gap, "tokens": gpu_toks[0].tolist(),
             "gcnt": gcnt[:, 0].tolist(), "launches": counts}
    print("rg-substrate: " + json.dumps(stats), flush=True)
    return counts


def grad_rglru_blocks(cfg) -> int:
    """RG-LRU layers at or after the first attention layer: the only ones
    a gate's gradient runs back through (the blocks before it see no input
    that requires grad), so each launches ``rglru_scan_bwd`` once per
    gradient evaluation."""
    order = list(cfg.stem_pattern) + list(cfg.block_pattern) * cfg.n_repeats
    first = next(i for i, bt in enumerate(order)
                 if bt in ("attn", "local_attn"))
    return sum(bt == "rglru" for bt in order[first:])


def train_launches(cfg) -> dict:
    """Kernel launches of one gradient evaluation of gate distillation:
    every attention layer's ``gated_flash``, ``gated_flash_bwd``,
    ``gate_mlp`` and ``gate_mlp_bwd`` once, every RG-LRU layer's
    ``rglru_scan`` twice (student and teacher) and, from the first
    attention layer on, its ``rglru_scan_bwd`` once; nothing else."""
    n_attn = cfg.n_repeats * cfg.attn_blocks_per_pattern
    n_rec = cfg.n_layers - n_attn
    return {"gated_flash": n_attn, "gated_flash_bwd": n_attn,
            "gate_mlp": n_attn, "gate_mlp_bwd": n_attn,
            "rglru_scan": 2 * n_rec,
            "rglru_scan_bwd": grad_rglru_blocks(cfg),
            "paged_decode": 0, "paged_decode_selected": 0,
            "vertical_slash": 0}


def cluster_gates(cfg, params, seed: int) -> None:
    """Every attention block's gate weights drawn with numpy so that the
    scores cluster per (repeat, head) clear of tau: head h of repeat r
    admits (scores near sigmoid(0.5)) when r + h is even and rejects (near
    sigmoid(-5)) otherwise. In place, on the CPU tensors of ``params``."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    for i, bt in enumerate(cfg.block_pattern):
        if bt not in ("attn", "local_attn"):
            continue
        gate = params["blocks"][f"b{i}"]["attn"]["gate"]
        r, h, f, m = gate["w1"].shape
        admit = (np.arange(r)[:, None] + np.arange(h)[None]) % 2 == 0
        new = {"w1": rng.standard_normal((r, h, f, m)) / np.sqrt(f),
               "b1": 0.1 * rng.standard_normal((r, h, m)),
               "w2": 0.5 * rng.standard_normal((r, h, m, 1)) / np.sqrt(m),
               "b2": np.where(admit, 0.5, -5.0)[..., None]}
        for k, v in new.items():
            gate[k].copy_(torch.from_numpy(v.astype(np.float32)))


def train_arch(card: str, arch: str, steps: int, batch: int, seq: int,
               tag: str, check_backbone: bool = False):
    """``repro_torch.launch.train --arch <arch>`` at full width and depth
    (f32, a seeded random backbone): per step wall time, loss, distill and
    peak memory (under 80 GB). Per step every attention layer launches
    ``gated_flash``, ``gated_flash_bwd``, ``gate_mlp`` and
    ``gate_mlp_bwd`` once, every RG-LRU layer ``rglru_scan`` twice (student
    and teacher) and, from the first attention layer on,
    ``rglru_scan_bwd`` once; nothing else of the port's. With
    ``check_backbone`` every gate leaf moved and every other leaf comes
    back bitwise as initialised (a second model is drawn to compare).
    Then one more step under torch.profiler (device time by kernel
    name)."""
    import math

    import numpy as np
    import torch
    from repro_torch.convert import flat_paths
    from repro_torch.launch import train
    from repro_torch.models.transformer import init_model
    from repro_torch.training import trainer as TR
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    res = train.main(["--arch", arch, "--steps", str(steps), "--batch",
                      str(batch), "--seq", str(seq), "--log-every", "1"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    cfg, hist = res["cfg"], res["history"]
    want = {k: v * steps for k, v in train_launches(cfg).items()}
    check(counts == want, f"{tag}: launches {counts} != {want}")
    check(len(hist) == steps and all(
        math.isfinite(h[k]) for h in hist for k in ("loss", "distill"))
        and all(h["distill"] > 0 for h in hist), f"{tag}: history {hist}")
    peak = max(h["peak_mem_gib"] for h in hist)
    check(peak * 2 ** 30 < 80e9, f"{tag}: peak memory {peak} GiB")
    if check_backbone:
        fresh = init_model(cfg, torch.Generator(device="cuda").manual_seed(0),
                           "cuda")
        trained = dict(flat_paths(res["params"]))
        moved = 0
        for key, leaf in flat_paths(fresh):
            if "gate" in key.split("/"):
                moved += int(not torch.equal(trained[key], leaf))
            else:
                check(torch.equal(trained[key], leaf),
                      f"{tag}: backbone leaf {key} changed")
        check(moved == len(TR.get_gates(fresh)), f"{tag}: only {moved} of "
              f"{len(TR.get_gates(fresh))} gate leaves moved")
        del fresh, trained
    toks = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab_size - 8, (batch, seq)), device="cuda")
    step = TR.make_train_step(cfg, lr=1e-3, lam=0.08)
    t1 = time.perf_counter()
    by_kernel = kernel_us(lambda: step(res["state"], res["params"],
                                       batch={"tokens": toks}), iters=1)
    prof_wall = time.perf_counter() - t1
    del res
    free_cuda()
    stats = {"arch": cfg.name, "layers": cfg.n_layers, "batch": batch,
             "seq": seq, "window": cfg.sliding_window
             if "local_attn" in cfg.block_pattern else cfg.wgkv.w_local,
             "steps": [{k: h.get(k) for k in ("step", "step_s", "loss",
                                              "distill", "admission_rate@0.1",
                                              "mean_gate", "peak_mem_gib")}
                       for h in hist],
             "wall_s": wall, "peak_mem_gib": peak, "launches": counts,
             "launches_per_step": {k: v / steps for k, v in counts.items()},
             "profiled_step": {
                 "device_ms": sum(by_kernel.values()) / 1e3,
                 "wall_s_two_steps": prof_wall,
                 "top_kernels_ms": {k: v / 1e3 for k, v in sorted(
                     by_kernel.items(), key=lambda kv: -kv[1])[:14]}},
             "card": card}
    print(f"{tag}: " + json.dumps(stats), flush=True)
    return counts, stats


def rg_train_substrate():
    """``train_card_vs_cpu`` on the reduced hybrid (64-token window) with a
    2-block RG-LRU stem and two repeats, so that RG-LRU blocks follow a
    gate and the scan's backward runs: seeded random weights, the gates
    clustered clear of tau (>= 1e-3), 2 x 128 tokens past the window."""
    import torch
    from repro_torch.configs import get_reduced_config
    from repro_torch.models import transformer as T
    cfg = get_reduced_config("recurrentgemma-9b").replace(
        dtype="float32", stem_pattern=("rglru", "rglru"), n_repeats=2)
    params = T.init_model(cfg, torch.Generator().manual_seed(6), "cpu")
    cluster_gates(cfg, params, 106)
    return train_card_vs_cpu("rg-train-substrate", cfg, params, 73, 1e-3)


def dense_serve(arch: str, card: str):
    """``repro_torch.launch.serve --arch <arch>`` at full width: 2 requests
    of 64 tokens, 8 new tokens, 2 slots, capacity 512, the startup tau
    probe included (one ``gated_flash`` and ``gate_mlp`` per layer), then
    one ``gate_mlp`` and one ``paged_decode`` per layer and position."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    n = get_config(arch).n_layers
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    with position_counter() as pc:
        res = serve.main(["--arch", arch, "--requests", "2", "--prompt-len",
                          "64", "--max-new", "8", "--slots", "2",
                          "--capacity", "512", "--quiet-stream"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    outs, summ = res["outputs"], res["summary"]
    check(len(outs) == 2 and all(len(o) == 8 for o in outs),
          f"{arch} serve: not every request returned 8 tokens: "
          f"{[len(o) for o in outs]}")
    check(res["paged_dev"] < 2e-3,
          f"{arch} serve: paged-vs-logical deviation {res['paged_dev']:.3e}")
    check(counts["gated_flash"] == n and counts["gate_mlp"] == n * (
        pc.count + 1) and counts["paged_decode"] >= n * pc.count,
        f"{arch} serve: launches {counts} over {pc.count} positions, "
        f"{n} layers")
    return {"wall_s": wall, "positions": pc.count,
            "ttft_mean_s": summ["ttft_mean_s"],
            "tpot_mean_s": summ["tpot_mean_s"],
            "tokens_per_s": summ["tokens_per_s"],
            "mean_admission": summ["mean_admission"],
            "paged_dev": res["paged_dev"],
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "launches": counts}


def dense_prefill(arch: str, seed: int):
    """``prefill_decode`` through the full-width model (f32, random weights
    drawn on the card), which is freed after it."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_model
    from repro_torch.tree import tree_leaves
    cfg = get_config(arch).replace(dtype="float32")
    params = init_model(cfg, torch.Generator(device="cuda").manual_seed(seed),
                        "cuda")
    stats, _ = prefill_decode(cfg, params, seed, f"{arch} prefill")
    stats["weights_gib"] = sum(t.numel() * t.element_size()
                               for t in tree_leaves(params)) / 2 ** 30
    del params
    free_cuda()
    return stats


def dense_reduced(arch: str):
    """The reduced config (f32, a 32-token ring, seeded random weights, the
    gates clustered clear of tau) on the card (kernels) and on the CPU
    (plain path): the gated forward of a 96-token numpy prompt (hidden and
    gates within 1e-4), then prefill of a 128-token prompt and 8 greedy
    decode steps: identical tokens and integer cache state, logits within
    1e-4."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import get_reduced_config
    from repro_torch.kernels import ops
    from repro_torch.models import inference as I
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_leaves_with_path, tree_map
    cfg = get_reduced_config(arch).replace(dtype="float32")
    cfg = cfg.replace(wgkv=dataclasses.replace(cfg.wgkv, w_local=32))
    cpu_params = T.init_model(cfg, torch.Generator().manual_seed(7), "cpu")
    cluster_gates(cfg, cpu_params, 107)
    rng = np.random.default_rng(22)
    fwd_toks = rng.integers(0, cfg.vocab_size, (2, 96))
    prompt = rng.integers(0, cfg.vocab_size, (1, 128))
    steps = 8

    def run(device, params):
        with torch.no_grad():
            fwd = T.forward(params, cfg, torch.as_tensor(fwd_toks,
                                                         device=device),
                            mode="gated", with_logits=False)
            out, caches = I.prefill(params, cfg,
                                    torch.as_tensor(prompt, device=device))
            toks, logits, caches, _ = greedy_decode(params, cfg, out.logits,
                                                    caches, steps)
        return fwd, out, toks.cpu(), logits.cpu(), caches

    scores = []
    inner = ops.write_gate

    def recording(*a, **kw):
        g = inner(*a, **kw)
        scores.append(g)
        return g
    ops.write_gate = recording
    try:
        cpu = run("cpu", cpu_params)
    finally:
        ops.write_gate = inner
    margin = min(float((g - cfg.wgkv.tau).abs().min()) for g in scores)
    check(margin >= 1e-3, f"{arch} reduced: gate margin {margin:.2e}")
    gpu_params = tree_map(lambda x: x.to("cuda"), cpu_params)
    torch.cuda.synchronize()
    reset_counts()
    gpu = run("cuda", gpu_params)
    torch.cuda.synchronize()
    counts = read_counts()
    n = cfg.n_layers
    want = {"gated_flash": n, "vertical_slash": n,
            "gate_mlp": n * (2 + steps), "paged_decode": n * steps}
    check(all(counts[k] == v for k, v in want.items()),
          f"{arch} reduced: the card run missed its kernels: {counts}")
    fwd_err = max(float((gpu[0].hidden.cpu() - cpu[0].hidden).abs().max()),
                  float((gpu[0].gates.cpu() - cpu[0].gates).abs().max()))
    check(fwd_err <= 1e-4, f"{arch} reduced: gated forward differs by "
          f"{fwd_err:.3e} > 1e-4")
    check(torch.equal(gpu[2], cpu[2]), f"{arch} reduced: greedy tokens "
          f"differ: {gpu[2].tolist()} vs {cpu[2].tolist()}")
    err = float((gpu[3] - cpu[3]).abs().max())
    check(err <= 1e-4, f"{arch} reduced: logits differ by {err:.3e} > 1e-4")
    ints = {"t", "ptr", "lpos", "gpos", "gcnt", "overflow"}
    gpu_leaves = dict(tree_leaves_with_path(gpu[4]))
    for path, want_leaf in tree_leaves_with_path(cpu[4]):
        if path[-1] in ints:
            check(torch.equal(gpu_leaves[path].cpu(), want_leaf),
                  f"{arch} reduced: cache {'/'.join(map(str, path))} "
                  "differs between card and CPU")
    adm = float(gpu[1].mean_admission)
    check(abs(adm - float(cpu[1].mean_admission)) <= 1e-6,
          f"{arch} reduced: mean_admission {adm} (CPU "
          f"{float(cpu[1].mean_admission)})")
    return {"heads": [cfg.n_heads, cfg.n_kv_heads, cfg.head_dim],
            "tau_margin": margin, "forward_max_err": fwd_err,
            "max_logit_err": err, "mean_admission": adm,
            "tokens": gpu[2][0].tolist(),
            "gcnt": gpu[4]["blocks"]["b0"].gcnt[:, 0].tolist(),
            "launches": counts}


def dense_arch(arch: str, card: str, seed: int):
    """One plain ``("attn",)`` decoder at full width: serve, prefill 4096
    tokens and decode 16, then its reduced config on card and CPU."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    stats = {"arch": arch, "layers": cfg.n_layers,
             "heads": [cfg.n_heads, cfg.n_kv_heads, cfg.head_dim],
             "tie_embeddings": cfg.tie_embeddings, "card": card}
    stats["serve"] = dense_serve(arch, card)
    free_cuda()
    stats["prefill"] = dense_prefill(arch, seed)
    stats["reduced"] = dense_reduced(arch)
    print(f"dense-arch {arch}: " + json.dumps(stats), flush=True)
    return {k: stats[k]["launches"] for k in ("serve", "prefill", "reduced")}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: FAIL: no CUDA device", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: FAIL: {SRC / 'repro_torch'} not found; run from "
              "a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # 1. device
    card = card_line()
    print(card)
    print(f"device: {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()} torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    # 2. build
    from repro_torch.kernels import build
    build_s = build.timed_build_all()
    print(f"build: {build_s:.2f}s")
    for name in build.KERNELS:
        log = build.log_path(name)
        if log.exists():
            for line in log.read_text().splitlines():
                if ("registers" in line or "spill" in line
                        or "Compiling entry" in line):
                    print(f"  ptxas {name}: {line.strip()[:160]}")
    # 3. kernels vs plain (serving shapes first, then a larger size)
    gate_main = gate_case(rows=2 * 8, s=1, seed=0)
    gate_big = gate_case(rows=2 * 8, s=4096, seed=1)
    gate_prefill = gate_case(rows=8, s=4096, seed=32)  # prefill-long's
    pd_main = dual_cache_case(2, 128, 256, torch.float32, seed=2)
    pd_bf16 = dual_cache_case(2, 128, 256, torch.bfloat16, seed=3)
    pd_big = dual_cache_case(8, 1024, 256, torch.float32, seed=4)
    vs_main = vertical_slash_case("float32", seed=5)
    vs_bf16 = vertical_slash_case("bfloat16", seed=6)
    gf_main = gated_flash_case(2048, "float32", seed=7)
    gf_bf16 = gated_flash_case(2048, "bfloat16", seed=8)
    gf_probe = gated_flash_case(32, "float32", seed=9)
    gf_probe_bf16 = gated_flash_case(32, "bfloat16", seed=10)
    # the serving shape (C 128 = 8 pages, K 2) and the offline decode
    # shape (C 1024 = 64 pages, K 8), each with the 256-token ring
    sel_main = selected_case(2, 128, 256, 2, torch.float32, seed=11)
    sel_bf16 = selected_case(2, 128, 256, 2, torch.bfloat16, seed=12)
    sel_long = selected_case(1, 1024, 256, 8, torch.float32, seed=13)
    sel_long_bf16 = selected_case(1, 1024, 256, 8, torch.bfloat16, seed=14)
    # recurrentgemma-9b's shapes: MQA (1 kv head, 16 q heads), hd 256, the
    # 2048-token local window, the gate's F = 2 x hd = 512; the scan at
    # [1, 4096, 4096] (one prompt, dr = d_model) and a ragged one with h0
    rg_scan = rglru_case(1, 4096, 4096, False, seed=20)
    rg_scan_h0 = rglru_case(3, 1000, 200, True, seed=21)
    rg_gate = gate_case(rows=1, s=4096, seed=22, h=1, f=512)
    rg_gate_dec = gate_case(rows=2, s=1, seed=23, h=1, f=512)
    rg_pd = dual_cache_case(1, 1024, 2048, torch.float32, seed=24, hkv=1,
                            grp=16, hd=256)
    rg_pd_bf16 = dual_cache_case(1, 1024, 2048, torch.bfloat16, seed=25,
                                 hkv=1, grp=16, hd=256)
    rg_pd_serve = dual_cache_case(2, 128, 2048, torch.float32, seed=26,
                                  hkv=1, grp=16, hd=256)
    rg_vs = vertical_slash_case("float32", seed=27, hkv=1, hd=256, w=2048)
    rg_vs_bf16 = vertical_slash_case("bfloat16", seed=28, hkv=1, hd=256,
                                     w=2048)
    rg_gf = gated_flash_case(4096, "float32", seed=29, hkv=1, hd=256, w=2048)
    rg_gf_bf16 = gated_flash_case(4096, "bfloat16", seed=30, hkv=1, hd=256,
                                  w=2048)
    rg_gf_probe = gated_flash_case(32, "float32", seed=31, hkv=1, hd=256,
                                   w=2048)
    # the dense baseline's shapes: serve-ab's decode read (2 slots,
    # capacity 512) and prefill-dense's (one row, 4160 slots), one
    # paged_decode segment; prefill-dense's causal prefill at S 4096
    dense_serve = dense_case(2, 512, [398, 383], torch.float32, seed=33)
    dense_long = dense_case(1, 4160, [4104], torch.float32, seed=34)
    dense_long_bf16 = dense_case(1, 4160, [4104], torch.bfloat16, seed=35)
    gf_causal = gated_flash_case(4096, "float32", seed=36, causal=True)
    gf_causal_bf16 = gated_flash_case(4096, "bfloat16", seed=37,
                                      causal=True)
    # the backward kernels at the train phase's shapes (qwen3-0.6b, batch
    # 2 x 2048 tokens) and at the substrate's (batch 2 x 128 tokens), then
    # each rebuilt with a planted fault on the same inputs
    gb_train, gb_train_run = gate_bwd_case(rows=2 * 8, s=2048, seed=40)
    gb_sub, gb_sub_run = gate_bwd_case(rows=2 * 2, s=128, seed=41, h=2,
                                       f=64, m=32)
    fb_train, fb_train_run = flash_bwd_case(32, 2048, seed=42, nk=16)
    fb_sub, fb_sub_run = flash_bwd_case(8, 128, seed=43, nk=4, hd=32, w=16)
    # this slice's: recurrentgemma-9b's training shapes (the scan at [1,
    # 4096, 4096], 16 q heads of hd 256 on 1 kv head with W 2048, the gate
    # at F 512), a ragged scan with h0, and G 3 (smollm-360m's 30 q / 10
    # kv heads of hd 64 at batch 2, its reduced config's hd 80)
    rb_train, rb_train_run = rglru_bwd_case(1, 4096, 4096, False, seed=44)
    rb_h0, rb_h0_run = rglru_bwd_case(3, 1000, 200, True, seed=45)
    fb_rg, fb_rg_run = flash_bwd_case(16, 4096, seed=46, nk=1, hd=256,
                                      w=2048)
    fb_g3, fb_g3_run = flash_bwd_case(30, 2048, seed=47, nk=10, hd=64)
    fb_g3_80, _ = flash_bwd_case(6, 256, seed=48, nk=2, hd=80, w=16)
    gb_rg, gb_rg_run = gate_bwd_case(rows=1, s=4096, seed=49, h=1, f=512)
    planted = planted_faults([("gate_mlp_bwd", gb_train_run),
                              ("gate_mlp_bwd", gb_sub_run),
                              ("gate_mlp_bwd", gb_rg_run),
                              ("gated_flash_bwd", fb_train_run),
                              ("gated_flash_bwd", fb_sub_run),
                              ("gated_flash_bwd", fb_g3_run),
                              ("gated_flash_bwd", fb_rg_run),
                              ("gated_flash_bwd_hd256", fb_rg_run),
                              ("rglru_scan_bwd", rb_train_run),
                              ("rglru_scan_bwd", rb_h0_run)])
    del gb_train_run, gb_sub_run, fb_train_run, fb_sub_run, rb_train_run
    del rb_h0_run, fb_rg_run, fb_g3_run, gb_rg_run
    # the dense archs' odd groups at the shapes their full-width phases
    # give each forward kernel (f32): serve's dual cache (2 slots, C 128
    # of capacity 512, W 256), the gate at serve and over a 4,096-token
    # prefill, the offline decode's dual cache (C 1024), prefill's
    # vertical_slash (S 4096, C 1024, W 256) and the tau probe's
    # gated_flash (S 32); smollm-360m's gated_flash also at S 2048, its
    # train forward's
    dense_kernels = []
    for i, (arch, (hq, hkv, hd)) in enumerate(DENSE_HEADS.items()):
        sd, grp = 50 + 10 * i, hq // hkv
        dense_kernels += [
            (f"paged_decode {arch}", dual_cache_case(
                2, 128, 256, torch.float32, seed=sd, hkv=hkv, grp=grp,
                hd=hd)),
            (f"gate_mlp {arch}", gate_case(rows=2 * hkv, s=1, seed=sd + 1,
                                           h=hkv, f=2 * hd)),
            (f"gate_mlp {arch}", gate_case(rows=hkv, s=4096, seed=sd + 2,
                                           h=hkv, f=2 * hd)),
            (f"paged_decode {arch}", dual_cache_case(
                1, 1024, 256, torch.float32, seed=sd + 3, hkv=hkv, grp=grp,
                hd=hd)),
            (f"vertical_slash {arch}", vertical_slash_case(
                "float32", seed=sd + 4, hkv=hkv, hd=hd, hq=hq)),
            (f"gated_flash {arch}", gated_flash_case(
                32, "float32", seed=sd + 5, hkv=hkv, hd=hd, hq=hq))]
    dense_kernels.append(("gated_flash smollm-360m", gated_flash_case(
        2048, "float32", seed=80, hkv=5, hd=64, hq=15)))
    free_cuda()
    for tag, r in (("gate_mlp", gate_main), ("gate_mlp", gate_big),
                   ("gate_mlp", gate_prefill),
                   ("paged_decode", pd_main), ("paged_decode", pd_bf16),
                   ("paged_decode", pd_big), ("vertical_slash", vs_main),
                   ("vertical_slash", vs_bf16), ("gated_flash", gf_main),
                   ("gated_flash", gf_bf16), ("gated_flash", gf_probe),
                   ("gated_flash", gf_probe_bf16),
                   ("paged_decode_selected", sel_main),
                   ("paged_decode_selected", sel_bf16),
                   ("paged_decode_selected", sel_long),
                   ("paged_decode_selected", sel_long_bf16),
                   ("rglru_scan", rg_scan), ("rglru_scan", rg_scan_h0),
                   ("gate_mlp rg", rg_gate), ("gate_mlp rg", rg_gate_dec),
                   ("paged_decode rg", rg_pd), ("paged_decode rg", rg_pd_bf16),
                   ("paged_decode rg", rg_pd_serve),
                   ("vertical_slash rg", rg_vs),
                   ("vertical_slash rg", rg_vs_bf16),
                   ("gated_flash rg", rg_gf), ("gated_flash rg", rg_gf_bf16),
                   ("gated_flash rg", rg_gf_probe),
                   ("paged_decode dense", dense_serve),
                   ("paged_decode dense", dense_long),
                   ("paged_decode dense", dense_long_bf16),
                   ("gated_flash causal", gf_causal),
                   ("gated_flash causal", gf_causal_bf16),
                   ("gate_mlp_bwd", gb_train), ("gate_mlp_bwd", gb_sub),
                   ("gated_flash_bwd", fb_train),
                   ("gated_flash_bwd", fb_sub),
                   ("rglru_scan_bwd", rb_train), ("rglru_scan_bwd", rb_h0),
                   ("gated_flash_bwd rg", fb_rg),
                   ("gated_flash_bwd G3", fb_g3),
                   ("gated_flash_bwd G3", fb_g3_80),
                   ("gate_mlp_bwd rg", gb_rg), *dense_kernels):
        print(f"kernel {tag}: " + json.dumps(r), flush=True)
    print("planted faults (relative error, limit "
          f"{BWD_REL}): " + json.dumps(planted), flush=True)
    # 4-10. the main paths, counts set to 0 just before each
    cli_counts = serve_cli(n_layers=28)
    long_counts = serve_long(card)
    cfg, params = full_model(seed=2)
    base = prefill_long(cfg, params)
    prefill_counts = base["counts"]
    select_counts = decode_select(cfg, params, base)
    long_stats = {k: base[k] for k in ("prefill_ms", "decode_ms_per_step")}
    del base
    free_cuda()
    dense_counts = prefill_dense(cfg, params, long_stats)
    forward_counts = forward_gated(cfg, params)
    del params
    free_cuda()
    compose_counts = serve_compose(card)
    substrate_counts = substrate()
    # the baselines and the prefix store (this slice's paths)
    ab_counts = serve_ab(card)
    prefix_counts = prefix_phase(card)
    sub_ab_counts = substrate_ab()
    # gate-distillation training (this slice's paths)
    free_cuda()
    train_counts, train_stats = train_arch(card, "qwen3-0.6b", steps=4,
                                           batch=2, seq=2048, tag="train",
                                           check_backbone=True)
    free_cuda()
    train_sub_counts = train_substrate()
    # 11-14. recurrentgemma-9b (one 32 GiB model at a time)
    free_cuda()
    rg_serve_counts = rg_serve(card)
    free_cuda()
    rg_cfg, rg_params = rg_model(seed=5)
    rg_prefill_counts, rg_decode_counts = rg_prefill(rg_cfg, rg_params)
    rg_forward_counts = rg_forward(rg_cfg, rg_params)
    del rg_params
    free_cuda()
    rg_substrate_counts = rg_substrate()
    # this slice's: the hybrid's training at full width, its reduced
    # config's training on card and CPU, the three dense archs, and
    # smollm-360m's training (gated_flash_bwd at G 3)
    free_cuda()
    rg_train_counts, rg_train_stats = train_arch(
        card, "recurrentgemma-9b", steps=3, batch=1, seq=4096,
        tag="rg-train")
    free_cuda()
    rg_train_sub_counts = rg_train_substrate()
    dense_counts_by = {}
    for seed, arch in enumerate(DENSE_HEADS):
        free_cuda()
        dense_counts_by[arch] = dense_arch(arch, card, seed=60 + seed)
    free_cuda()
    smollm_train_counts, _ = train_arch(card, "smollm-360m", steps=2,
                                        batch=2, seq=2048,
                                        tag="smollm-train")
    rg = "recurrentgemma"
    attn = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    dense_by = {}  # kernel -> arch -> its cases at the dense archs' shapes
    for tag, r in dense_kernels:
        name, arch = tag.split()
        dense_by.setdefault(name, {}).setdefault(arch, []).append(r)

    def dense_err(name):
        return max(r["max_abs_err"] for rs in dense_by[name].values()
                   for r in rs)
    kernels = [
        {"name": "gate_mlp", "route": "cuda",
         "source": "src/repro_torch/csrc/gate_mlp.cu",
         "replaces": "src/repro/kernels/gate_mlp.py:28",
         "launches": long_counts["gate_mlp"],
         "max_abs_err": max(dense_err("gate_mlp"), *(
             r["max_abs_err"] for r in (gate_main, gate_big, gate_prefill,
                                        rg_gate, rg_gate_dec))),
         **{k: gate_main[k] for k in ("ms", "plain_ms", "bound_ms",
                                      "bound_by", "library_ms")},
         "shape": gate_main["shape"], "device_ms": gate_main["device_ms"],
         "bound_rate": gate_main["bound_rate"],
         "bound_ms_cuda_cores": gate_main["bound_ms_cuda_cores"],
         "launches_serve_cli": cli_counts["gate_mlp"], "large": gate_big,
         "prefill": gate_prefill,
         "launches_prefill_long": prefill_counts["gate_mlp"],
         "launches_rg_prefill": rg_decode_counts["gate_mlp"],
         "launches_rg_serve": rg_serve_counts["gate_mlp"],
         "launches_train": train_counts["gate_mlp"],
         rg: {"prefill": rg_gate, "decode": rg_gate_dec},
         "dense_archs": dense_by["gate_mlp"],
         "launches_rg_train": rg_train_counts["gate_mlp"],
         "launches_smollm_train": smollm_train_counts["gate_mlp"],
         "launches_dense_archs": {a: {k: v["gate_mlp"] for k, v in c.items()}
                                  for a, c in dense_counts_by.items()}},
        {"name": "paged_decode", "route": "cuda",
         "source": "src/repro_torch/csrc/paged_decode.cu",
         "replaces": "src/repro/kernels/paged_decode.py:59",
         "launches": long_counts["paged_decode"],
         "max_abs_err": max(pd_main["max_abs_err"], pd_big["max_abs_err"],
                            dense_err("paged_decode")),
         **{k: pd_main[k] for k in ("ms", "plain_ms", "bound_ms",
                                    "bound_by", "library_ms")},
         "shape": pd_main["shape"],
         "max_abs_err_bf16": pd_bf16["max_abs_err"],
         "launches_serve_cli": cli_counts["paged_decode"],
         "bf16": pd_bf16, "large": pd_big,
         "launches_rg_prefill": rg_decode_counts["paged_decode"],
         "launches_rg_serve": rg_serve_counts["paged_decode"],
         rg: {"offline": rg_pd, "offline_bf16": rg_pd_bf16,
              "serve": rg_pd_serve},
         "launches_serve_ab": {k: v["paged_decode"]
                               for k, v in ab_counts.items()},
         "launches_prefill_dense": dense_counts["paged_decode"],
         "launches_prefix": {k: v["paged_decode"]
                             for k, v in prefix_counts.items()},
         "launches_substrate_ab": {k: v["paged_decode"]
                                   for k, v in sub_ab_counts.items()},
         "dense": {"serve": dense_serve, "offline": dense_long,
                   "offline_bf16": dense_long_bf16},
         "dense_archs": dense_by["paged_decode"],
         "launches_dense_archs": {
             a: {k: v["paged_decode"] for k, v in c.items()}
             for a, c in dense_counts_by.items()}},
        {"name": "vertical_slash", "route": "cuda",
         "source": "src/repro_torch/csrc/vertical_slash.cu",
         "replaces": "src/repro/kernels/vertical_slash.py:88",
         "launches": prefill_counts["vertical_slash"],
         "max_abs_err": max(vs_main["max_abs_err"],
                            dense_err("vertical_slash")),
         **{k: vs_main[k] for k in attn}, "shape": vs_main["shape"],
         "bound_rate": vs_main["bound_rate"],
         "bound_ms_cuda_cores": vs_main["bound_ms_cuda_cores"],
         "device_ms": vs_main["device_ms"],
         "max_abs_err_bf16": vs_bf16["max_abs_err"], "bf16": vs_bf16,
         "launches_rg_prefill": rg_prefill_counts["vertical_slash"],
         "launches_rg_substrate": rg_substrate_counts["vertical_slash"],
         rg: {"f32": rg_vs, "bf16": rg_vs_bf16},
         "dense_archs": dense_by["vertical_slash"],
         "launches_dense_archs": {
             a: {k: v["vertical_slash"] for k, v in c.items()}
             for a, c in dense_counts_by.items()}},
        {"name": "gated_flash", "route": "cuda",
         "source": "src/repro_torch/csrc/gated_flash.cu",
         "replaces": "src/repro/kernels/gated_flash.py:68",
         "launches": forward_counts["gated_flash"],
         "max_abs_err": max(gf_main["max_abs_err"],
                            gf_probe["max_abs_err"],
                            dense_err("gated_flash")),
         **{k: gf_main[k] for k in attn}, "shape": gf_main["shape"],
         "bound_rate": gf_main["bound_rate"],
         "bound_ms_cuda_cores": gf_main["bound_ms_cuda_cores"],
         "device_ms": gf_main["device_ms"],
         "max_abs_err_bf16": max(gf_bf16["max_abs_err"],
                                 gf_probe_bf16["max_abs_err"]),
         "launches_serve_cli": cli_counts["gated_flash"],
         "bf16": gf_bf16, "probe": gf_probe, "probe_bf16": gf_probe_bf16,
         "launches_rg_forward": rg_forward_counts["gated_flash"],
         "launches_rg_serve": rg_serve_counts["gated_flash"],
         rg: {"f32": rg_gf, "bf16": rg_gf_bf16, "probe": rg_gf_probe},
         "launches_prefill_dense": dense_counts["gated_flash"],
         "launches_train": train_counts["gated_flash"],
         "launches_train_substrate": train_sub_counts["gated_flash"],
         "causal": {"f32": gf_causal, "bf16": gf_causal_bf16},
         "dense_archs": dense_by["gated_flash"],
         "launches_rg_train": rg_train_counts["gated_flash"],
         "launches_smollm_train": smollm_train_counts["gated_flash"],
         "launches_dense_archs": {
             a: {k: v["gated_flash"] for k, v in c.items()}
             for a, c in dense_counts_by.items()}},
        {"name": "paged_decode_selected", "route": "cuda",
         "source": "src/repro_torch/csrc/paged_decode.cu",
         "replaces": "src/repro/kernels/paged_decode.py:133",
         "launches": select_counts["paged_decode_selected"],
         "max_abs_err": max(sel_main["max_abs_err"],
                            sel_long["max_abs_err"]),
         **{k: sel_main[k] for k in attn}, "shape": sel_main["shape"],
         "full_read_ms": sel_main["full_read_ms"],
         "max_abs_err_bf16": max(sel_bf16["max_abs_err"],
                                 sel_long_bf16["max_abs_err"]),
         "launches_serve_compose": compose_counts["paged_decode_selected"],
         "launches_substrate": substrate_counts["paged_decode_selected"],
         "bf16": sel_bf16, "offline": sel_long,
         "offline_bf16": sel_long_bf16},
        {"name": "rglru_scan", "route": "cuda",
         "source": "src/repro_torch/csrc/rglru_scan.cu",
         "replaces": "src/repro/kernels/rglru_scan.py:39",
         "launches": rg_prefill_counts["rglru_scan"],
         "max_abs_err": max(rg_scan["max_abs_err"],
                            rg_scan_h0["max_abs_err"]),
         **{k: rg_scan[k] for k in attn}, "shape": rg_scan["shape"],
         "device_ms": rg_scan["device_ms"],
         "launches_rg_forward": rg_forward_counts["rglru_scan"],
         "launches_rg_serve": rg_serve_counts["rglru_scan"],
         "launches_rg_substrate": rg_substrate_counts["rglru_scan"],
         "launches_rg_train": rg_train_counts["rglru_scan"],
         "launches_rg_train_substrate": rg_train_sub_counts["rglru_scan"],
         "ragged_h0": rg_scan_h0},
        {"name": "gate_mlp_bwd", "route": "cuda",
         "source": "src/repro_torch/csrc/gate_mlp_bwd.cu",
         "replaces": "src/repro/kernels/gate_mlp.py:28",
         "launches": train_counts["gate_mlp_bwd"],
         "max_abs_err": max(gb_train["max_abs_err"], gb_sub["max_abs_err"]),
         **{k: gb_train[k] for k in attn}, "shape": gb_train["shape"],
         "device_ms": gb_train["device_ms"],
         "bound_rate": gb_train["bound_rate"],
         "bound_ms_cuda_cores": gb_train["bound_ms_cuda_cores"],
         "max_rel_err": gb_train["max_rel_err"],
         "launches_per_train_step":
             train_stats["launches_per_step"]["gate_mlp_bwd"],
         "launches_train_substrate": train_sub_counts["gate_mlp_bwd"],
         "planted_fault_rel_err": planted["gate_mlp_bwd"],
         "ptxas": ptxas_info("gate_mlp_bwd"),
         "smem_dynamic_bytes": build.load(
             "gate_mlp_bwd").gate_mlp_bwd_smem_bytes(256, 64),
         "substrate": gb_sub, rg: gb_rg,
         "smem_dynamic_bytes_rg": build.load(
             "gate_mlp_bwd").gate_mlp_bwd_smem_bytes(512, 64),
         "launches_rg_train": rg_train_counts["gate_mlp_bwd"],
         "launches_per_rg_train_step":
             rg_train_stats["launches_per_step"]["gate_mlp_bwd"],
         "launches_rg_train_substrate": rg_train_sub_counts["gate_mlp_bwd"],
         "launches_smollm_train": smollm_train_counts["gate_mlp_bwd"]},
        {"name": "gated_flash_bwd", "route": "cuda",
         "source": "src/repro_torch/csrc/gated_flash_bwd.cu",
         "replaces": "src/repro/kernels/gated_flash.py:68",
         "launches": train_counts["gated_flash_bwd"],
         "max_abs_err": max(fb_train["max_abs_err"], fb_sub["max_abs_err"]),
         **{k: fb_train[k] for k in attn}, "shape": fb_train["shape"],
         "device_ms": fb_train["device_ms"],
         "bound_rate": fb_train["bound_rate"],
         "bound_ms_cuda_cores": fb_train["bound_ms_cuda_cores"],
         "library": fb_train["library"],
         "max_rel_err": fb_train["max_rel_err"],
         "launches_per_train_step":
             train_stats["launches_per_step"]["gated_flash_bwd"],
         "launches_train_substrate": train_sub_counts["gated_flash_bwd"],
         "planted_fault_rel_err": planted["gated_flash_bwd"],
         "library_fwd_bwd_ms": fb_train["library_fwd_bwd_ms"],
         "ptxas": ptxas_info("gated_flash_bwd"),
         "smem_dynamic_bytes": {
             f"{k}<{hd}>": build.load("gated_flash_bwd").gated_flash_bwd_smem_bytes(
                 hd, which) for hd in (64, 128, 256)
             for which, k in ((0, "bwd_kv_kernel"), (1, "bwd_q_kernel"))},
         "substrate": fb_sub, rg: fb_rg, "g3": [fb_g3, fb_g3_80],
         "head_splits_rg": build.load(
             "gated_flash_bwd").gated_flash_bwd_splits(256, 16),
         "planted_fault_rel_err_hd256": planted["gated_flash_bwd_hd256"],
         "launches_rg_train": rg_train_counts["gated_flash_bwd"],
         "launches_per_rg_train_step":
             rg_train_stats["launches_per_step"]["gated_flash_bwd"],
         "launches_rg_train_substrate":
             rg_train_sub_counts["gated_flash_bwd"],
         "launches_smollm_train": smollm_train_counts["gated_flash_bwd"]},
        {"name": "rglru_scan_bwd", "route": "cuda",
         "source": "src/repro_torch/csrc/rglru_scan_bwd.cu",
         "replaces": "src/repro/kernels/rglru_scan.py:39",
         "launches": rg_train_counts["rglru_scan_bwd"],
         "max_abs_err": max(rb_train["max_abs_err"], rb_h0["max_abs_err"]),
         **{k: rb_train[k] for k in attn}, "shape": rb_train["shape"],
         "device_ms": rb_train["device_ms"],
         "max_rel_err": rb_train["max_rel_err"],
         "launches_per_rg_train_step":
             rg_train_stats["launches_per_step"]["rglru_scan_bwd"],
         "launches_rg_train_substrate":
             rg_train_sub_counts["rglru_scan_bwd"],
         "planted_fault_rel_err": planted["rglru_scan_bwd"],
         "ptxas": ptxas_info("rglru_scan_bwd"),
         "ragged_h0": rb_h0},
    ]
    print(f"total: {time.perf_counter() - t_start:.1f}s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
