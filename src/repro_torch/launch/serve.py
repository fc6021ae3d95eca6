"""Serving driver of the port: the ServeSession client API over any
registered backend — the WG-KV dual cache (default), dense full-KV, or a
static admission baseline (port of ``repro/launch/serve.py``) — with
chunked prefill, dispatch-ahead decode, per-request token streaming,
deadlines, an optional content-addressed prefix store and admission-aware
telemetry.

    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch qwen3-0.6b --requests 4 --max-new 16 --quiet-stream
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch qwen3-0.6b --reduced --device cpu --requests 2
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \\
        --selection quest:2 --evict-budget 96 --prompt-len 384
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch recurrentgemma-9b --reduced --device cpu --requests 2
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \\
        --reduced --device cpu --backend dense --prefix-cache
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \\
        --reduced --device cpu --backend duo --retrieval-ratio 0.5
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \\
        --reduced --device cpu --mesh 2x2 --requests 2 --max-new 4
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \\
        --mesh 1x2 --dist-backend gloo

Weights are random, drawn from ``--seed`` with a ``torch.Generator``;
prompts are drawn with numpy from the same seed. As in the reference, an
arch without a KV cache (xlstm-350m) and the encoder-decoder
(whisper-medium) are refused, on a mesh too (before any rank starts);
qwen2-vl-7b serves text only, on one device or a mesh. At startup of
the ``wgkv`` backend a short gated forward probes the gate scores
(:func:`tau_probe`) and warns on stderr when tau sits inside their
cluster.

``--mesh DxM`` serves on a data x model mesh (serving/sharded.py): under
``torchrun`` the CLI joins the world it is given; otherwise it starts its
``D * M`` ranks itself (``launch.mesh.spawn``; on CUDA it builds the
kernels once first). Every rank draws the same weights, runs the tau
probe on them whole, and serves its shard; rank 0 alone streams and
prints. ``--dist-backend`` is ``nccl`` on CUDA (one card per rank) and
``gloo`` on the CPU; ``--dist-backend gloo`` on CUDA runs ranks that share
a card.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import sys
import warnings
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs import ARCH_NAMES, get_config, get_reduced_config
from repro_torch.configs.base import ATTN_BLOCKS
from repro_torch.core.admission import check_tau_margin
from repro_torch.device import resolve_device
from repro_torch.kernels import build
from repro_torch.launch import mesh as M
from repro_torch.models import inference as I
from repro_torch.models import transformer as T
from repro_torch.serving.backend import BACKEND_NAMES, make_backend
from repro_torch.serving.obs import Tracer, write_chrome_trace
from repro_torch.serving.orchestrator import (QueueFull, SchedulerConfig,
                                              ServeSession)
from repro_torch.serving.prefix_cache import PrefixCache
from repro_torch.serving.sharded import parse_mesh_shape
from repro_torch.sharding import rules


def pool_pages_for(cfg, slots: int, capacity: int) -> int:
    """Pool pages that hold ``slots`` full dual caches: every attention
    layer's kv heads with a full ring (``cfg.sliding_window`` for
    ``local_attn``, else ``cfg.wgkv.w_local``) and a full global budget,
    plus the null page. Recurrent layers keep no pages."""
    budget = cfg.wgkv.global_budget(capacity)
    layers = cfg.stem_pattern + cfg.block_pattern * cfg.n_repeats
    per_slot = sum(
        ((cfg.sliding_window if bt == "local_attn" else cfg.wgkv.w_local)
         + budget) // 16 for bt in layers if bt in ATTN_BLOCKS)
    return slots * cfg.n_kv_heads * per_slot + 1


def tau_probe(params, cfg, *, prompt_len: int, seed: int,
              device: torch.device) -> Optional[float]:
    """The knife-edge tau guard at startup: one gated forward over a
    ``min(prompt_len, 32)``-token probe drawn with numpy from ``seed + 99``,
    then ``check_tau_margin`` on its gate scores. A tau inside the score
    cluster flips admissions between numerically equivalent prefill
    paths, so its RuntimeWarning becomes a one-line stderr notice.
    Returns the margin min |g - tau| (None without gates). On CUDA the
    forward runs the ``gate_mlp`` and ``gated_flash`` kernels once per
    attention layer (and ``rglru_scan`` once per recurrent layer of a
    hybrid)."""
    rng = np.random.default_rng(seed + 99)
    ptoks = rng.integers(0, cfg.vocab_size - 8, size=(1, min(prompt_len, 32)))
    with torch.no_grad():
        g = T.forward(params, cfg, torch.as_tensor(ptoks, device=device),
                      mode="gated", with_logits=False).gates
    if g is None:
        return None
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always", RuntimeWarning)
        margin = check_tau_margin(g, cfg.wgkv.tau)
    if any(issubclass(w.category, RuntimeWarning) for w in caught):
        print(f"WARNING: knife-edge admission tau={cfg.wgkv.tau}: "
              f"min |g - tau| = {margin:.2e} over a "
              f"{ptoks.shape[1]}-token probe; admission may flip "
              "between numerically-equivalent prefill paths",
              file=sys.stderr)
    return margin


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", required=True, choices=ARCH_NAMES)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (cuda or cpu)")
    ap.add_argument("--backend", default="wgkv", choices=BACKEND_NAMES,
                    help="serving engine backend (protocol implementation)")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--capacity", type=int, default=512)
    ap.add_argument("--chunk-tokens", type=int, default=64,
                    help="prefill chunk per scheduler tick")
    ap.add_argument("--max-prefill-batch", type=int, default=None,
                    help="cap on prefill tasks advanced per tick")
    ap.add_argument("--selection", default=None, metavar="quest:K",
                    help="decode-time page selection: on decode-only "
                         "ticks read only the top-K global pages per "
                         "(row, kv head)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="content-addressed prefix store: requests sharing "
                         "a chunk-aligned prompt prefix splice its cached "
                         "post-admission KV instead of re-prefilling it")
    ap.add_argument("--prefix-cache-mb", type=int, default=256,
                    help="prefix store LRU byte budget in MiB")
    ap.add_argument("--sink", type=int, default=None,
                    help="static backends: sink tokens every head admits "
                         "(default: the config's wgkv.sink)")
    ap.add_argument("--retrieval-ratio", type=float, default=0.25,
                    help="duo: fraction of kv heads that admit every token")
    ap.add_argument("--dispatch-ahead", type=int, default=1,
                    help="decode steps kept in flight on the device "
                         "(0 = synchronous one-step-per-tick baseline)")
    ap.add_argument("--deadline-s", type=float, default=None)
    ap.add_argument("--max-pending", type=int, default=None)
    ap.add_argument("--mesh", default=None, metavar="DxM",
                    help="serve on a data x model mesh of D * M ranks")
    ap.add_argument("--dist-backend", default=None, choices=("nccl", "gloo"),
                    help="the mesh's process-group backend (default: nccl "
                         "on cuda, gloo on cpu)")
    ap.add_argument("--quest-pages", type=int, default=None,
                    help="Quest selection as a page mask on every step")
    ap.add_argument("--evict-budget", type=int, default=None,
                    help="SnapKV eviction bound (global tokens per head)")
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
    "paged_dev": float, "report": str, "summary": the telemetry summary
    of the burst} for callers that drive it."""
    ap = build_parser()
    argv = sys.argv[1:] if argv is None else list(argv)
    args = ap.parse_args(argv)
    if args.prefix_cache_mb < 1:
        ap.error("--prefix-cache-mb must be >= 1")
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
    if args.mesh is None:
        return serve(args, None)
    try:
        shape = parse_mesh_shape(args.mesh)
    except ValueError as e:
        ap.error(str(e))
    try:   # before any rank starts
        rules.check_mesh_arch(get_config(args.arch))
    except NotImplementedError as e:
        ap.exit(2, f"{ap.prog}: {e}\n")
    refused = _refusal(get_config(args.arch))
    if refused:
        ap.exit(2, f"{ap.prog}: {refused}\n")
    if M.under_torchrun():
        return serve(args, M.from_env(shape, backend=args.dist_backend,
                                      device=args.device))
    if resolve_device(args.device).type == "cuda":
        build.build_all()   # once, before the ranks would each run nvcc
    return M.spawn(_serve_rank, shape, args=(argv,),
                   backend=args.dist_backend, device=args.device)[0]


def _serve_rank(mesh, argv: List[str]):
    """One rank of a spawned ``--mesh`` serve: rank 0 prints and returns
    the result, the others serve silently."""
    args = build_parser().parse_args(argv)
    if mesh.rank == 0:
        return serve(args, mesh)
    with contextlib.redirect_stdout(io.StringIO()):
        serve(args, mesh)
    return None


def _refusal(cfg) -> Optional[str]:
    """The reference's message for an arch it does not serve (no KV
    cache, or the encoder-decoder), else None."""
    if not cfg.has_attention_cache:
        return (f"{cfg.name} has no KV cache; engine serves attention "
                "archs (SSM decode via examples/)")
    if cfg.is_encdec:
        return ("enc-dec serving requires audio frontends; see examples/ "
                "for whisper decode")
    return None


def serve(args, mesh) -> Dict[str, object]:
    """The serve of parsed ``args``, on ``mesh``'s shard or (None) on
    ``args.device``."""
    device = resolve_device(args.device) if mesh is None else mesh.device
    cfg = get_reduced_config(args.arch) if args.reduced else get_config(args.arch)
    cfg = cfg.replace(dtype="float32")
    refused = _refusal(cfg)
    if refused:
        raise SystemExit(refused)
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    params = T.init_model(cfg, gen, device)
    if args.backend == "wgkv" and cfg.wgkv.enabled:
        tau_probe(params, cfg, prompt_len=args.prompt_len, seed=args.seed,
                  device=device)
    opts = I.DecodeOptions(quest_pages=args.quest_pages,
                           evict_hard_budget=args.evict_budget)
    static_kw = {}
    if args.backend in I.STATIC_POLICIES:
        static_kw = dict(sink=args.sink, retrieval_ratio=args.retrieval_ratio)
    eng = make_backend(args.backend, params, cfg, slots=args.slots,
                       capacity=args.capacity, opts=opts,
                       selection=args.selection,
                       temperature=args.temperature, seed=args.seed,
                       pool_pages=pool_pages_for(cfg, args.slots,
                                                 args.capacity),
                       device=device, mesh=mesh, **static_kw)
    print(f"backend: {eng.capabilities()}")
    if mesh is not None:
        print(f"mesh: {mesh.describe()}")
    prefix_cache = None
    if args.prefix_cache:
        prefix_cache = PrefixCache(quantum=args.chunk_tokens,
                                   budget_bytes=args.prefix_cache_mb << 20,
                                   free_fn=eng.release_prefix)
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
        metrics_interval_s=args.metrics_interval, prefix_cache=prefix_cache)

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
    summary = session.telemetry.summary()
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
            "report": report, "summary": summary}


if __name__ == "__main__":
    main()
