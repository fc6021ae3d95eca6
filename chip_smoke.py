#!/usr/bin/env python3
"""On-card smoke run of the PyTorch + CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one NVIDIA GPU (Hopper, sm_90a) and ``nvcc``; exits non-zero, and
prints no result, without them. Phases, any failure fatal:

  1. device   — the card's name and power limit (nvidia-smi).
  2. build    — both kernels from ``src/repro_torch/csrc`` with nvcc.
  3. kernels  — each CUDA kernel against its plain PyTorch version on the
                card, at the serving path's shapes and at a larger size,
                with times (CUDA events), the plain version's time, a
                library yardstick where one exists, and the card's bound.
  4. serve-cli  — ``repro_torch.launch.serve`` at full qwen3-0.6b width.
  5. serve-long — ``ServeSession`` at full width with 384-token prompts,
                so tokens leave the 256-token ring and lazy promotion
                runs; launch counters prove both kernels carried it.

The weights are random (seeded); the point is that the port runs end to
end on the card through its kernels and agrees with itself: the paged
physical pool matches the logical cache (< 2e-3), every request completes.
Any failed check raises, and the script exits non-zero. The last two lines
are the ``kernels`` JSON and the ``ok`` JSON.
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


def bound(nbytes: float, flops: float, peak_flops: float):
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# --------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# --------------------------------------------------------------------------
def gate_case(rows: int, s: int, seed: int):
    import torch
    from repro_torch.kernels.gate_mlp import gate_mlp, gate_mlp_plain
    g = torch.Generator(device="cuda").manual_seed(seed)
    h, f, m = 8, 256, 64

    def rn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device="cuda") * scale
    x = rn(rows, s, f)
    w1, b1 = rn(h, f, m, scale=f ** -0.5), rn(h, m, scale=0.1)
    w2, b2 = rn(h, m, 1, scale=m ** -0.5), rn(h, 1)
    args = (x, w1, b1, w2, b2)
    got = gate_mlp(*args)
    want = gate_mlp_plain(*args)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    check(err <= 1e-5, f"gate_mlp [{rows},{s},{f}] err {err:.3e} > 1e-5")
    iters = 200 if s == 1 else 20
    ms = cuda_ms(lambda: gate_mlp(*args), iters)
    plain_ms = cuda_ms(lambda: gate_mlp_plain(*args), iters)
    nbytes = 4 * (x.numel() + rows * s + sum(a.numel() for a in args[1:]))
    flops = rows * s * (2 * f * m + 2 * m)
    b_ms, b_by = bound(nbytes, flops, H100_F32_FLOPS)
    return {"shape": f"x[{rows},{s},{f}] M={m}", "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None}


def dual_cache_case(slots: int, c: int, w: int, dtype, seed: int):
    """Two segments (global C, ring W) of a random dual cache with ragged
    gcnt (0, partial page, full, ...) and rows before and after the ring
    wraps, read by the kernel and by its plain version."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core.dual_cache import init_dual_cache
    from repro_torch.kernels import ops
    from repro_torch.kernels.paged_decode import paged_decode, paged_decode_plain
    g = torch.Generator(device="cuda").manual_seed(seed)
    hkv, grp, hd = 8, 2, 128
    cache = init_dual_cache(slots, hkv, hd, w_local=w, budget=c, dtype=dtype,
                            device="cuda")

    def rn(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)
    pattern = torch.tensor([0, 7, c, c // 2 + 3, 1, c - 1, 16, 33],
                           dtype=torch.int32, device="cuda")
    gcnt = torch.stack([pattern.roll(i)[:hkv] for i in range(slots)])
    t = torch.tensor([(w // 2 + 37 * i) if i % 2 == 0 else (w + 101 * i)
                      for i in range(slots)], dtype=torch.int32, device="cuda")
    cache = cache._replace(gk=rn(slots, hkv, c, hd), gv=rn(slots, hkv, c, hd),
                           lk=rn(slots, hkv, w, hd), lv=rn(slots, hkv, w, hd),
                           gcnt=gcnt, t=t)
    q = rn(slots, hkv * grp, hd)
    qf, first, second = ops.dual_cache_segments(q, cache)
    got = paged_decode(qf, *first, second=second)
    want = paged_decode_plain(qf, *first, second=second)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    tol = 5e-5 if dtype == torch.float32 else 5e-2
    check(err <= tol, f"paged_decode {dtype} slots={slots} C={c} W={w} "
          f"err {err:.3e} > {tol}")
    ms = cuda_ms(lambda: paged_decode(qf, *first, second=second), 200)
    plain_ms = cuda_ms(lambda: paged_decode_plain(qf, *first, second=second), 50)
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
    return {"shape": f"N={slots * hkv * grp} hd={hd} C={c} W={w} {dtype}",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms}


# --------------------------------------------------------------------------
# phases 4-5: the main path
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


def reset_counts():
    from repro_torch.kernels import gate_mlp, paged_decode
    gate_mlp.launches.reset()
    paged_decode.launches.reset()


def read_counts():
    from repro_torch.kernels import gate_mlp, paged_decode
    return {"gate_mlp": gate_mlp.launches.count,
            "paged_decode": paged_decode.launches.count}


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
    check(counts["gate_mlp"] == n_layers * pc.count,
          f"serve-cli: gate_mlp launches {counts['gate_mlp']} != "
          f"{n_layers} x {pc.count} positions")
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
        log = build.BUILD_DIR / f"{name}.log"
        if log.exists():
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  ptxas {name}: {line.strip()}")
    # 3. kernels vs plain (serving shapes first, then a larger size)
    gate_main = gate_case(rows=2 * 8, s=1, seed=0)
    gate_big = gate_case(rows=2 * 8, s=4096, seed=1)
    pd_main = dual_cache_case(2, 128, 256, torch.float32, seed=2)
    pd_bf16 = dual_cache_case(2, 128, 256, torch.bfloat16, seed=3)
    pd_big = dual_cache_case(8, 1024, 256, torch.float32, seed=4)
    for tag, r in (("gate_mlp", gate_main), ("gate_mlp", gate_big),
                   ("paged_decode", pd_main), ("paged_decode", pd_bf16),
                   ("paged_decode", pd_big)):
        print(f"kernel {tag}: " + json.dumps(r))
    # 4-5. the main path, counts set to 0 just before each
    cli_counts = serve_cli(n_layers=28)
    long_counts = serve_long(card)
    kernels = [
        {"name": "gate_mlp", "route": "cuda",
         "source": "src/repro_torch/csrc/gate_mlp.cu",
         "replaces": "src/repro/kernels/gate_mlp.py:28",
         "launches": long_counts["gate_mlp"],
         "max_abs_err": max(gate_main["max_abs_err"], gate_big["max_abs_err"]),
         **{k: gate_main[k] for k in ("ms", "plain_ms", "bound_ms",
                                      "bound_by", "library_ms")},
         "shape": gate_main["shape"],
         "launches_serve_cli": cli_counts["gate_mlp"], "large": gate_big},
        {"name": "paged_decode", "route": "cuda",
         "source": "src/repro_torch/csrc/paged_decode.cu",
         "replaces": "src/repro/kernels/paged_decode.py:59",
         "launches": long_counts["paged_decode"],
         "max_abs_err": max(pd_main["max_abs_err"], pd_big["max_abs_err"]),
         **{k: pd_main[k] for k in ("ms", "plain_ms", "bound_ms",
                                    "bound_by", "library_ms")},
         "shape": pd_main["shape"],
         "max_abs_err_bf16": pd_bf16["max_abs_err"],
         "launches_serve_cli": cli_counts["paged_decode"],
         "bf16": pd_bf16, "large": pd_big},
    ]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
