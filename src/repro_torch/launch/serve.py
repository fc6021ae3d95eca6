"""Serving driver of the port: the ServeSession client API over the
``wgkv`` engine (port of ``repro/launch/serve.py``), with chunked prefill,
dispatch-ahead decode, per-request token streaming, deadlines and
admission-aware telemetry.

    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch qwen3-0.6b --requests 4 --max-new 16 --quiet-stream
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch qwen3-0.6b --reduced --device cpu --requests 2

Weights are random, drawn from ``--seed`` with a ``torch.Generator``;
prompts are drawn with numpy from the same seed. Flags of the reference
CLI that this port does not support yet exit with a message instead of
being ignored. The reference's startup tau probe runs the gated training
forward, which is not ported yet, so it is left out.
"""
from __future__ import annotations

import argparse
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs import ARCH_NAMES, get_config, get_reduced_config
from repro_torch.device import resolve_device
from repro_torch.models import inference as I
from repro_torch.models import transformer as T
from repro_torch.serving.backend import BACKEND_NAMES, make_backend
from repro_torch.serving.obs import Tracer, write_chrome_trace
from repro_torch.serving.orchestrator import (QueueFull, SchedulerConfig,
                                              ServeSession)


def pool_pages_for(cfg, slots: int, capacity: int) -> int:
    """Pool pages that hold ``slots`` full dual caches: every layer's kv
    heads with a full ring and a full global budget, plus the null page."""
    per_stream = (cfg.wgkv.w_local + cfg.wgkv.global_budget(capacity)) // 16
    return slots * cfg.n_layers * cfg.n_kv_heads * per_stream + 1


_UNPORTED = {
    "selection": "--selection (decode-time page selection)",
    "prefix_cache": "--prefix-cache (content-addressed prefix store)",
    "mesh": "--mesh (multi-device serving)",
    "quest_pages": "--quest-pages (Quest mask selection)",
    "evict_budget": "--evict-budget (SnapKV eviction)",
}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", required=True, choices=ARCH_NAMES)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (cuda or cpu)")
    ap.add_argument("--backend", default="wgkv", choices=BACKEND_NAMES,
                    help="serving engine backend (only wgkv is ported)")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--capacity", type=int, default=512)
    ap.add_argument("--chunk-tokens", type=int, default=64,
                    help="prefill chunk per scheduler tick")
    ap.add_argument("--max-prefill-batch", type=int, default=None,
                    help="cap on prefill tasks advanced per tick")
    ap.add_argument("--selection", default=None, metavar="quest:K")
    ap.add_argument("--prefix-cache", action="store_true")
    ap.add_argument("--prefix-cache-mb", type=int, default=256)
    ap.add_argument("--dispatch-ahead", type=int, default=1,
                    help="decode steps kept in flight on the device "
                         "(0 = synchronous one-step-per-tick baseline)")
    ap.add_argument("--deadline-s", type=float, default=None)
    ap.add_argument("--max-pending", type=int, default=None)
    ap.add_argument("--mesh", default=None, metavar="DxM")
    ap.add_argument("--quest-pages", type=int, default=None)
    ap.add_argument("--evict-budget", type=int, default=None)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--quiet-stream", action="store_true",
                    help="suppress per-token stream prints")
    ap.add_argument("--trace-out", default=None, metavar="TRACE.json")
    ap.add_argument("--trace-capacity", type=int, default=1 << 16)
    ap.add_argument("--device-annotations", action="store_true",
                    help="also wrap traced phases in torch.profiler."
                         "record_function so device profiles show them")
    ap.add_argument("--metrics-interval", type=float, default=None,
                    metavar="SECONDS")
    return ap


def main(argv: Optional[List[str]] = None) -> Dict[str, object]:
    """Run the CLI; returns {"outputs": [tokens per request],
    "paged_dev": float, "report": str} for callers that drive it."""
    ap = build_parser()
    args = ap.parse_args(argv)
    for name, flag in _UNPORTED.items():
        val = getattr(args, name)
        if val not in (None, False):
            ap.exit(2, f"{ap.prog}: {flag} is not ported to repro_torch "
                       "yet (see ROADMAP.md)\n")
    if args.backend != "wgkv":
        ap.exit(2, f"{ap.prog}: --backend {args.backend} is not ported to "
                   "repro_torch yet; only wgkv is\n")
    if args.max_pending is not None and args.max_pending < 1:
        ap.error("--max-pending must be >= 1")
    if args.chunk_tokens < 1:
        ap.error("--chunk-tokens must be >= 1")
    if args.dispatch_ahead < 0:
        ap.error("--dispatch-ahead must be >= 0")
    if args.max_prefill_batch is not None and args.max_prefill_batch < 1:
        ap.error("--max-prefill-batch must be >= 1")
    if args.trace_capacity < 1:
        ap.error("--trace-capacity must be >= 1")
    if args.metrics_interval is not None and args.metrics_interval <= 0:
        ap.error("--metrics-interval must be > 0")
    device = resolve_device(args.device)
    cfg = get_reduced_config(args.arch) if args.reduced else get_config(args.arch)
    cfg = cfg.replace(dtype="float32")
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    params = T.init_model(cfg, gen, device)
    eng = make_backend(args.backend, params, cfg, slots=args.slots,
                       capacity=args.capacity, opts=I.DecodeOptions(),
                       temperature=args.temperature, seed=args.seed,
                       pool_pages=pool_pages_for(cfg, args.slots,
                                                 args.capacity),
                       device=device)
    print(f"backend: {eng.capabilities()}")
    tracer = None
    if args.trace_out or args.device_annotations:
        tracer = Tracer(capacity=args.trace_capacity,
                        annotate_device=args.device_annotations)
    session = ServeSession(
        eng,
        sched=SchedulerConfig(chunk_tokens=args.chunk_tokens,
                              dispatch_ahead=args.dispatch_ahead,
                              max_prefill_batch=args.max_prefill_batch),
        max_pending=args.max_pending, tracer=tracer,
        metrics_interval_s=args.metrics_interval)

    def on_token(rid: int, tok: int, is_last: bool) -> None:
        if not args.quiet_stream:
            print(f"  stream rid={rid} tok={tok}" + (" <eor>" if is_last else ""),
                  flush=True)

    def submit_bp(prompt, **kw):
        # backpressure: serve until the queue has room
        while True:
            try:
                return session.submit(prompt, **kw)
            except QueueFull as qf:
                if not args.quiet_stream:
                    print(f"  backpressure: depth={qf.depth}/"
                          f"{qf.max_pending}, serving to drain")
                session.tick()

    rng = np.random.default_rng(args.seed + 7)
    handles = []
    for _ in range(args.requests):
        prompt = rng.integers(0, cfg.vocab_size - 8,
                              size=args.prompt_len).tolist()
        h = submit_bp(prompt, max_new=args.max_new, on_token=on_token,
                      deadline_s=args.deadline_s)
        print(f"submitted rid={h.rid} prompt_len={len(prompt)}")
        handles.append(h)
    session.run()

    print("\nresults:")
    for h in handles:
        tag = " (cancelled: deadline)" if h.cancelled else ""
        print(f"req {h.rid}: state={h.state}{tag} -> out={h.tokens()}")
    print("\ntelemetry:")
    report = session.report()
    print(report)
    dev = 0.0
    if eng.capabilities().paged:
        # verify_paged needs resident caches, and the pool is empty once
        # the burst drains — so serve one extra request and check the
        # physical-vs-logical deviation while it is live
        vh = submit_bp(rng.integers(0, cfg.vocab_size - 8,
                                    size=args.prompt_len).tolist(),
                       max_new=2)
        for _ in range(10_000):
            if vh.state in ("decode", "done", "cancelled"):
                break
            session.tick()
        session.orchestrator.drain()  # settle the mirror before verifying
        dev = eng.verify_paged() if any(eng.live) else 0.0
        print(f"\npaged-vs-logical max deviation (live request): {dev:.2e}")
        session.run()
    session.close()
    if args.trace_out and tracer is not None:
        obj = write_chrome_trace(
            tracer, args.trace_out,
            meta={"arch": args.arch, "backend": args.backend,
                  "requests": args.requests, "slots": args.slots,
                  "dispatch_ahead": args.dispatch_ahead})
        print(f"\ntrace: {args.trace_out} "
              f"({len(obj['traceEvents'])} events, "
              f"{obj['otherData']['spans_dropped']} dropped)")
    return {"outputs": [h.tokens() for h in handles], "paged_dev": dev,
            "report": report}


if __name__ == "__main__":
    main()
