"""Serving A/B benchmark (port of ``benchmarks/bench_serving.py``): replay
one recorded arrival trace through each requested engine backend (WG-KV,
dense full-KV, static admission) under the same continuous-batching
stack, and emit per-backend throughput, TTFT/TPOT percentiles, and peak
KV/paged-pool memory.

This is the paper's headline comparison (46-68% memory reduction,
1.85-2.56x decode speedup vs full-KV) recast as a regression-tracked
serving scenario: identical traffic, identical scheduler, only the cache
policy behind the ``EngineBackend`` protocol changes.

    PYTHONPATH=src python -m repro_torch.benchmarks.bench_serving \
        --backends wgkv,dense [--smoke] [--arrival poisson:0.5] \
        [--slo-tolerance 0.25] [--trace-out trace.json] [--device cpu] \
        [--json-out PATH]

Drivers replaying every trace (the scheduler tick is always the fused
megabatch call — ONE ragged model call per tick advancing every live
request: first chunks, mid-prefill extends, and decode rows together,
with on-device sampling):

  * the **async** replay (``ServeSession``, ``dispatch_ahead=1``) — the
    production path and the source of each backend's headline metrics;
  * the **synchronous** baseline (``dispatch_ahead=0``) — recorded as
    ``sync_tokens_per_s`` with the ratio ``async_speedup_vs_sync``, so
    the overlap the two-phase surface buys is regression-tracked;
  * the **selection A/B** (paged backends): per-K engines built with
    ``selection="quest:K"`` replay the same trace, so decode-only ticks
    score global pages against the live query (incremental per-page key
    min/max metadata) and attend over only the gathered top-K pages.
    ``quest:<all pages>`` is first asserted byte-identical to the
    selection-off async streams (ascending top-K at K = P is the
    identity permutation), then K in {2, 4, 8} are timed — recorded
    under ``selection`` with ``selection_speedup`` = best timed K vs
    the selection-off async replay. Each K also decodes a
    needle-retrieval batch through the serving path
    (``needle_accuracy``): payload recall with the needles far outside
    the local window, the accuracy axis that catches a selection policy
    gathering the wrong pages.

  * the **multi-turn prefix-cache A/B**: conversations that resend a
    growing shared context each turn replay cold and then through a
    content-addressed prefix store (serving/prefix_cache.py) — cached
    streams are asserted byte-identical to cold prefill, and the record
    carries ``prefix.hit_rate`` plus TTFT-on-hit vs the in-run miss and
    cold-matched p50s (the splice-instead-of-re-prefill win).

Greedy token streams from all replays are asserted byte-identical
before any timing is trusted. Warmup replays run first per engine and
their wall time is recorded as ``compile_time_s`` (on the card: the
kernels' first launches and the allocator's warmup), so the steady-state
numbers above never pay for them.

SLO regression gate: with ``--slo-tolerance T`` the run compares each
backend's p99 TTFT AND p99 TPOT against the port's own history, the
record at ``--json-out`` (default ``BENCH_serving_torch.json`` at the
repository's root; same trace signature), and exits nonzero
when a new p99 exceeds the old by more than ``T`` (fractional, e.g.
0.25 = +25%) — the TTFT tail alert the roadmap called for, plus the
decode-latency guard that keeps batched prefill from regressing TPOT
unnoticed.

Arrival processes: the default ``burst`` trace scatters arrivals over the
first ``n`` scheduler ticks; ``poisson:<rate>`` draws i.i.d. exponential
inter-arrival gaps (``rate`` = mean arrivals per tick), the open-loop
traffic model the TTFT tail percentiles are meaningful under.

``--mesh DxM`` replays the A/B on a data x model mesh
(serving/sharded.py): every rank runs the same replays on its shard, as
``repro_torch.launch.serve --mesh`` does (ranks spawned here, or the
world ``torchrun`` started; ``--dist-backend gloo`` shares one card), and
rank 0 writes the record, whose trace carries the mesh. Without
``--json-out`` a mesh run writes to a temporary file, never over
``BENCH_serving_torch.json``.

The arrival trace is drawn with numpy (``np.random.default_rng(seed)``),
not ``jax.random``: the port's prompts and ticks are its own, so its
record is compared with its own history only. Emits CSV rows for
``repro_torch.benchmarks.run`` and writes the port's record
(``{"trace": ..., "device": card line, "backends": {name: metrics},
"ab": ratios-vs-dense}``), never the reference's
``BENCH_serving.json``. Each backend record
carries a ``phases`` tick-phase wall-time breakdown (prefill with its
extend sub-phase, dispatch with its fused/selection sub-phases, collect,
evict, memory_sample, admit, vs the measured tick total) plus
``fused_padding_frac`` — the fraction of fused slot-rows that were
padding, the fixed-shape overhead axis. ``--trace-out`` additionally
runs one dedicated traced replay per backend (after the timed A/B, so
timing stays tracing-free) and writes validated Chrome-trace JSONs
(``repro_torch.serving.obs``).
"""
from __future__ import annotations

import argparse
import datetime
import json
import os
import sys
import tempfile
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.benchmarks.common import (REPO, device_label, needle_batch,
                                           trained_model)
from repro_torch.core.selection import PAGE_SIZE
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import build
from repro_torch.launch import mesh as M
from repro_torch.serving.backend import BACKEND_NAMES, make_backend
from repro_torch.serving.obs.export import (validate_chrome_trace,
                                            write_chrome_trace)
from repro_torch.serving.obs.trace import Tracer
from repro_torch.serving.orchestrator import SchedulerConfig, ServeSession
from repro_torch.serving.orchestrator.telemetry import PHASE_TIME_KEYS
from repro_torch.serving.sharded import parse_mesh_shape

N_REQUESTS = 12
PROMPT_LEN = 96
MAX_NEW = 16
SLOTS = 4
CHUNK = 32
CAPACITY = 192
DISPATCH_AHEAD = 1
SMOKE = dict(n_requests=4, prompt_len=48, max_new=4)

# multi-turn chat replay (prefix-cache A/B): every turn resends the whole
# growing conversation, so turns 2..T share an ever-longer chunk-aligned
# prefix with their predecessor — the workload the content-addressed
# prefix store exists for
MULTI_TURN = dict(convs=4, turns=3, user_tokens=16)
SMOKE_MULTI_TURN = dict(convs=2, turns=2, user_tokens=8)

# decode-time page-selection A/B: timed K sweep (smoke trims the sweep;
# the K = all-pages parity replay always runs on paged backends)
SELECTION_KS = (2, 4, 8)
SMOKE_SELECTION_KS = (4,)
NEEDLE_N = 16
SMOKE_NEEDLE_N = 8

# the port's record (the reference writes BENCH_serving.json)
JSON_PATH = str(REPO / "BENCH_serving_torch.json")

# the record's schema, the reference's; v2 added the per-backend tick-phase
# wall-time breakdown ("phases") and top-level self-description; v3 made
# the fused megabatch tick the headline replay and added compile_time_s
# and the fused phase counters; v4 retired the unfused/unbatched replays
# (the split prefill/decode paths are gone from the scheduler) and added
# the decode-time page-selection A/B ("selection", selection_speedup,
# needle_accuracy) and fused_padding_frac; v5 added the per-backend
# multi-turn prefix-cache A/B ("prefix": hit_rate, ttft_on_hit_p50_s vs
# the miss/cold-matched p50s, tokens_reused) and the prefix_* counters
BENCH_SCHEMA_VERSION = 5

# trace fields that must match before an SLO comparison against history
# is meaningful (different traffic -> different tails, not a regression)
TRACE_SIGNATURE = ("requests", "prompt_len", "max_new", "arrival", "mesh",
                   "smoke")


def poisson_rate(arrival: str) -> Optional[float]:
    """Validate an arrival spec; returns the rate for ``poisson:<rate>``
    (mean arrivals per scheduler tick), None for ``burst``."""
    if arrival == "burst":
        return None
    if arrival.startswith("poisson:"):
        try:
            rate = float(arrival.split(":", 1)[1])
        except ValueError:
            raise ValueError(f"bad poisson rate in {arrival!r}") from None
        if rate <= 0:
            raise ValueError(f"poisson rate must be > 0, got {rate}")
        return rate
    raise ValueError(
        f"arrival must be 'burst' or 'poisson:<rate>', got {arrival!r}")


def record_trace(n: int, vocab: int, *, prompt_len: int, max_new: int,
                 seed: int = 1, arrival: str = "burst") -> List[Dict]:
    """Deterministic arrival trace: each request carries a prompt and an
    arrival tick (scheduler rounds since t0). Every backend replays the
    SAME trace, so latency/throughput deltas are attributable to the cache
    policy alone.

    ``arrival="burst"`` scatters all arrivals uniformly over the first
    ``n`` ticks (closed burst); ``arrival="poisson:<rate>"`` draws
    exponential inter-arrival gaps with mean ``1/rate`` ticks — an
    open-loop Poisson process, the traffic model TTFT tail percentiles
    are meaningful under. Drawn from ``np.random.default_rng(seed)``;
    the sort is stable, so requests of one tick keep their order."""
    rate = poisson_rate(arrival)
    rng = np.random.default_rng(seed)
    out = []
    t = 0.0
    for _ in range(n):
        prompt = rng.integers(0, vocab - 8, size=prompt_len).tolist()
        if rate is None:
            tick = int(rng.integers(0, max(1, n)))
        else:
            t += float(rng.exponential()) / rate
            tick = int(t)
        out.append({"arrival_tick": tick, "prompt": prompt,
                    "max_new": max_new})
    out.sort(key=lambda r: r["arrival_tick"])
    return out


def replay(eng, trace: List[Dict], *, chunk: int = CHUNK,
           dispatch_ahead: int = DISPATCH_AHEAD,
           tracer: Optional[Tracer] = None
           ) -> Tuple[ServeSession, List[List[int]]]:
    """Replay a recorded trace through a ServeSession: submit each
    request at its arrival tick, tick until drained. Returns the closed
    session and each request's token stream (submission order). With
    ``tracer`` the replay records lifecycle/phase spans (the timed A/B
    replays run without one, so the timed numbers stay tracing-free)."""
    sess = ServeSession(eng, sched=SchedulerConfig(
        chunk_tokens=chunk, dispatch_ahead=dispatch_ahead),
        tracer=tracer)
    handles = []
    pending = list(trace)
    tick = 0
    while pending or not sess.orchestrator.queue.all_done():
        while pending and pending[0]["arrival_tick"] <= tick:
            r = pending.pop(0)
            handles.append(sess.submit(r["prompt"], max_new=r["max_new"]))
        sess.tick()
        tick += 1
        if tick > 100_000:
            raise RuntimeError("trace replay did not drain")
    sess.close()
    return sess, [h.tokens() for h in handles]


def multi_turn_replay(eng, *, convs: int, turns: int, user_tokens: int,
                      plen: int, mnew: int, vocab: int, seed: int = 5,
                      prefix_cache=None):
    """Multi-turn chat replay: ``convs`` conversations served for
    ``turns`` rounds; each round's prompt is the previous prompt plus the
    model's output plus fresh user tokens, so rounds 2..T resend a
    growing shared context. One ServeSession per round (the engine and
    the prefix store persist across rounds — exactly how a frontend
    would hold them). Returns per-(conv, turn) token streams and the
    completed request records per turn, rid-sorted so cold and cached
    replays align request-for-request."""
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, vocab - 8, size=plen).tolist()
               for _ in range(convs)]
    streams = [[] for _ in range(convs)]
    turn_recs = []
    for _ in range(turns):
        sess = ServeSession(eng, sched=SchedulerConfig(
            chunk_tokens=CHUNK, dispatch_ahead=DISPATCH_AHEAD),
            prefix_cache=prefix_cache)
        hs = [sess.submit(p, max_new=mnew) for p in prompts]
        sess.run()
        sess.close()
        turn_recs.append(sorted(sess.telemetry.records,
                                key=lambda r: r.rid))
        for c, h in enumerate(hs):
            out = h.tokens()
            streams[c].append(out)
            prompts[c] = prompts[c] + out + rng.integers(
                0, vocab - 8, size=user_tokens).tolist()
    return streams, turn_recs


def _prefix_ab(eng, *, convs: int, turns: int, user_tokens: int,
               plen: int, mnew: int, vocab: int) -> Dict:
    """Prefix-cache A/B on one warm engine: the multi-turn trace replayed
    cold (no store), then with the store — greedy streams must be
    byte-identical (a hit splices the SAME post-admission state the cold
    run recomputes), and TTFT-on-hit is compared against both the
    in-run misses and the cold replay's matched requests."""
    from repro_torch.serving.prefix_cache import PrefixCache
    kw = dict(convs=convs, turns=turns, user_tokens=user_tokens,
              plen=plen, mnew=mnew, vocab=vocab)
    cold_streams, cold_recs = multi_turn_replay(eng, **kw)
    pc = PrefixCache(quantum=CHUNK, free_fn=eng.release_prefix)
    warm_streams, warm_recs = multi_turn_replay(eng, prefix_cache=pc, **kw)
    if warm_streams != cold_streams:
        raise AssertionError(
            "prefix-cache replay diverged from cold prefill on the same "
            "multi-turn trace")
    flat_warm = [r for recs in warm_recs for r in recs]
    flat_cold = [r for recs in cold_recs for r in recs]
    hit_ttfts = [r.ttft for r in flat_warm
                 if r.prefix_hit and r.ttft is not None]
    miss_ttfts = [r.ttft for r in flat_warm
                  if not r.prefix_hit and r.ttft is not None]
    # cold TTFTs of the SAME (conv, turn) requests that hit when cached:
    # identical prompts, identical scheduler — the isolated splice win
    cold_matched = [c.ttft for w, c in zip(flat_warm, flat_cold)
                    if w.prefix_hit and c.ttft is not None]
    out = {
        "convs": convs, "turns": turns, "user_tokens": user_tokens,
        "hit_rate": pc.hits / max(pc.hits + pc.misses, 1),
        "hits": pc.hits, "misses": pc.misses,
        "inserts": pc.inserts, "evictions": pc.evictions,
        "bytes": pc.bytes_used,
        "tokens_reused": float(sum(r.prefix_tokens for r in flat_warm)),
        "ttft_on_hit_p50_s": (float(np.percentile(hit_ttfts, 50))
                              if hit_ttfts else None),
        "ttft_on_miss_p50_s": (float(np.percentile(miss_ttfts, 50))
                               if miss_ttfts else None),
        "ttft_cold_matched_p50_s": (float(np.percentile(cold_matched, 50))
                                    if cold_matched else None),
    }
    if hit_ttfts and cold_matched:
        out["ttft_hit_speedup_vs_cold"] = (
            float(np.percentile(cold_matched, 50))
            / float(np.percentile(hit_ttfts, 50)))
    pc.clear()
    return out


def needle_serving_accuracy(eng, vocab: int, *, n: int = NEEDLE_N,
                            seed: int = 777) -> float:
    """Needle payload recall THROUGH the serving decode path: prefill
    each needle prompt up to its final query marker, greedy-decode the
    payload span, and score it against the planted answer. The needles
    live in the first 55% of the sequence — always in global pages, far
    outside the local window — so under ``selection="quest:K"`` this
    measures whether query-aware top-K page selection gathers the pages
    the retrieval actually needs (an accuracy axis ``tokens_per_s``
    cannot see). The prompts are drawn on the host (a CPU generator
    seeded ``seed``), so every device serves the same ones."""
    b = needle_batch(seed, n, "cpu")
    qpos = b["query_pos"]
    toks = b["tokens"].numpy()
    sess = ServeSession(eng, sched=SchedulerConfig(
        chunk_tokens=CHUNK, dispatch_ahead=DISPATCH_AHEAD))
    hs = [sess.submit(toks[i, :qpos + 1].tolist(), max_new=2)
          for i in range(n)]
    sess.run()
    sess.close()
    pred = np.array([h.tokens() for h in hs])
    return float((pred == b["answer"].numpy()).mean())


def _prefill_tok_rate(s: Dict) -> Optional[float]:
    """Prompt-ingest throughput of one replay: prefill tokens over the
    wall time spent advancing them (not the whole replay —
    decode-heavy traces would drown the prefill signal). The fused tick
    has no separate prefill stage; its prefill share of the fused
    call's wall is apportioned by the engine
    (``fused_prefill_time_s``/``fused_prefill_tokens``)."""
    c = s["counters"]
    t = c.get("fused_prefill_time_s")
    return c.get("fused_prefill_tokens", 0.0) / t if t else None


def _phase_breakdown(s: Dict) -> Dict:
    """Tick-phase wall-time decomposition of one replay (seconds), from
    the orchestrator's always-on phase counters: the disjoint per-tick
    stages (``phase_sum_s`` = their sum, <= the measured ``tick_time_s``
    total — the rest is scheduler/stream/telemetry glue) plus the fused
    megabatch call's wall (inside ``dispatch_time_s``), its prefill-row
    apportionment, and the wall of the decode-only dispatches that ran
    the top-K selection variant (``selection_time_s``, a subset of
    ``fused_time_s``)."""
    c = s["counters"]
    out = {k: float(c.get(k, 0.0)) for k in PHASE_TIME_KEYS}
    out["extend_time_s"] = float(c.get("extend_time_s", 0.0))
    out["fused_time_s"] = float(c.get("fused_time_s", 0.0))
    out["fused_prefill_time_s"] = float(c.get("fused_prefill_time_s", 0.0))
    out["selection_time_s"] = float(c.get("selection_time_s", 0.0))
    out["tick_time_s"] = float(c.get("tick_time_s", 0.0))
    out["phase_sum_s"] = sum(float(c.get(k, 0.0)) for k in PHASE_TIME_KEYS)
    return out


def _backend_record(s: Dict) -> Dict:
    return {
        "requests": s["requests"],
        "requests_per_s": s["requests_per_s"],
        "tokens_per_s": s["tokens_per_s"],
        "ttft_mean_s": s["ttft_mean_s"],
        "ttft_p50_s": s["ttft_p50_s"],
        "ttft_p90_s": s["ttft_p90_s"],
        "ttft_p99_s": s["ttft_p99_s"],
        "tpot_mean_s": s["tpot_mean_s"],
        "tpot_p50_s": s["tpot_p50_s"],
        "tpot_p90_s": s["tpot_p90_s"],
        "tpot_p99_s": s["tpot_p99_s"],
        "mean_admission": s["mean_admission"],
        "mean_admission_decode": s["mean_admission_decode"],
        "fused_padding_frac": s["fused_padding_frac"],
        "pool_utilization": s["pool_util_mean"],
        "pool_pages_peak": s["pool_pages_peak"],
        "kv_tokens_peak": s["kv_tokens_peak"],
        "kv_bytes_peak": s["kv_bytes_peak"],
        "kv_bytes_per_shard_peak": s["kv_bytes_per_shard_peak"],
        "decode_steps": s["counters"]["decode_steps"],
        "prefill_chunks": s["counters"]["prefill_chunks"],
        "prefill_batches": s["counters"]["prefill_batches"],
        # where the best async replay's tick wall time went, per stage
        "phases": _phase_breakdown(s),
        # prefill_tokens_per_s is filled in by run() from the best stage
        # rate across the interleaved replays, not this single summary
    }


def check_slo(prev: Optional[Dict], record: Dict,
              tolerance: float) -> List[str]:
    """Compare per-backend p99 TTFT and p99 TPOT against the committed
    history (TPOT so batched prefill cannot regress decode latency
    unnoticed — coalesced prefill work shares ticks with decode).

    Returns human-readable violations (empty = pass). History with a
    different trace signature is skipped: changed traffic is not a
    regression."""
    if not prev:
        return []
    pt, nt = prev.get("trace", {}), record["trace"]
    if any(pt.get(k) != nt.get(k) for k in TRACE_SIGNATURE):
        print(f"slo: history trace signature differs "
              f"({ {k: pt.get(k) for k in TRACE_SIGNATURE} } vs "
              f"{ {k: nt.get(k) for k in TRACE_SIGNATURE} }); skipping",
              file=sys.stderr)
        return []
    out = []
    for name, rec in record["backends"].items():
        for metric, label in (("ttft_p99_s", "p99 TTFT"),
                              ("tpot_p99_s", "p99 TPOT")):
            old = prev.get("backends", {}).get(name, {}).get(metric)
            new = rec.get(metric)
            if old is None or new is None:
                continue
            if new > old * (1.0 + tolerance):
                out.append(
                    f"{name}: {label} {new * 1e3:.1f}ms > "
                    f"{old * 1e3:.1f}ms * (1 + {tolerance:g}) from history")
    return out


def _trace_path(base: str, name: str) -> str:
    """Per-backend trace artifact path: trace.json -> trace.wgkv.json."""
    stem, ext = os.path.splitext(base)
    return f"{stem}.{name}{ext or '.json'}"


def _selection_ab(name: str, params, cfg, bkw, trace, warmup,
                  async_toks, base_tok_rate, *, ks: Sequence[int],
                  needle_n: int) -> Dict:
    """Decode-time page-selection A/B on one paged backend: a fresh
    engine per ``quest:K`` spec (selection is an engine option — each
    engine runs its own decode-only variant), the K = all-pages
    engine asserted byte-identical to the selection-off streams first,
    then the timed K sweep with serving-path needle accuracy."""
    k_all = CAPACITY // PAGE_SIZE
    sel_eng = make_backend(name, params, cfg, slots=SLOTS,
                           capacity=CAPACITY, selection=f"quest:{k_all}",
                           **bkw)
    sel_eng.mirror = False
    replay(sel_eng, warmup)
    _, all_toks = replay(sel_eng, trace)
    # selection must change WHICH pages are attended, never the result
    # when it selects all of them: ascending top-K at K = P is the
    # identity permutation, so the streams are byte-identical
    if all_toks != async_toks:
        raise AssertionError(
            f"{name}: quest:{k_all} (= all pages) diverged from the "
            f"selection-off async replay on the same trace")
    out: Dict = {"parity_k": k_all, "per_k": {}}
    for k in ks:
        eng = make_backend(name, params, cfg, slots=SLOTS,
                           capacity=CAPACITY, selection=f"quest:{k}",
                           **bkw)
        eng.mirror = False
        t0 = time.perf_counter()
        replay(eng, warmup)
        compile_time_s = time.perf_counter() - t0
        best = None
        for _ in range(2):
            summ = replay(eng, trace)[0].telemetry.summary()
            if best is None or ((summ["tokens_per_s"] or 0.0)
                                > (best["tokens_per_s"] or 0.0)):
                best = summ
        c = best["counters"]
        out["per_k"][f"quest:{k}"] = {
            "tokens_per_s": best["tokens_per_s"],
            "tpot_p50_s": best["tpot_p50_s"],
            "selected_pages": float(c.get("selected_pages", 0.0)),
            "selection_time_s": float(c.get("selection_time_s", 0.0)),
            "fused_padding_frac": best["fused_padding_frac"],
            "compile_time_s": compile_time_s,
            "needle_accuracy": needle_serving_accuracy(
                eng, cfg.vocab_size, n=needle_n),
        }
    rates = {k: v["tokens_per_s"] for k, v in out["per_k"].items()
             if v["tokens_per_s"]}
    if rates and base_tok_rate:
        kbest = max(rates, key=rates.get)
        out["best_k"] = kbest
        out["selection_speedup"] = rates[kbest] / base_tok_rate
    return out


def run(backends: Optional[Sequence[str]] = None, smoke: bool = False,
        arrival: str = "burst", mesh: Optional[str] = None,
        trace_out: Optional[str] = None, device: DeviceLike = None,
        json_path: str = JSON_PATH, dist_backend: Optional[str] = None):
    """The A/B on ``device`` (default ``cuda``), or on every rank of a
    ``mesh`` ("DxM") over ``dist_backend``; the record goes to
    ``json_path`` (rank 0's rows are returned)."""
    names = tuple(backends) if backends else ("wgkv", "dense")
    for n in names:
        if n not in BACKEND_NAMES:
            raise ValueError(f"unknown backend {n!r}; known: {BACKEND_NAMES}")
    poisson_rate(arrival)       # validate before any model work
    kw = dict(names=names, smoke=smoke, arrival=arrival, spec=mesh,
              trace_out=trace_out, device=device, json_path=json_path)
    if mesh is None:
        return _run(None, **kw)
    shape = parse_mesh_shape(mesh)
    if M.under_torchrun():
        return _run(M.from_env(shape, backend=dist_backend, device=device),
                    **kw)
    if resolve_device(device).type == "cuda":
        build.build_all()   # once, before the ranks would each run nvcc
    return M.spawn(_run, shape, kwargs=kw, backend=dist_backend,
                   device=device or "cuda")[0]


def _run(mesh_obj, *, names, smoke, arrival, spec, trace_out, device,
         json_path):
    """The A/B of :func:`run` on this process: unsharded, or this rank's
    shard of ``mesh_obj`` (only rank 0 writes files)."""
    dev = resolve_device(device) if mesh_obj is None else mesh_obj.device
    writer = mesh_obj is None or mesh_obj.rank == 0
    bkw = dict(device=dev, mesh=mesh_obj)
    n_req, plen, mnew = ((SMOKE["n_requests"], SMOKE["prompt_len"],
                          SMOKE["max_new"]) if smoke
                         else (N_REQUESTS, PROMPT_LEN, MAX_NEW))
    sel_ks = SMOKE_SELECTION_KS if smoke else SELECTION_KS
    needle_n = SMOKE_NEEDLE_N if smoke else NEEDLE_N
    mt_kw = SMOKE_MULTI_TURN if smoke else MULTI_TURN
    # the distilled bench substrate (pretrained teacher + trained write
    # gates): with random-init gates every token passes tau and the memory
    # A/B axis degenerates to 1.0
    cfg, params = trained_model(device=dev)
    trace = record_trace(n_req, cfg.vocab_size, prompt_len=plen,
                         max_new=mnew, seed=1, arrival=arrival)
    warmup = record_trace(SLOTS, cfg.vocab_size, prompt_len=plen,
                          max_new=2, seed=99)
    record: Dict = {
        "schema_version": BENCH_SCHEMA_VERSION,
        "generated_at": datetime.datetime.now(
            datetime.timezone.utc).isoformat(),
        "device": device_label(dev),
        "trace": {"requests": n_req, "prompt_len": plen, "max_new": mnew,
                  "arrival": arrival, "mesh": spec,
                  "arrival_ticks": [r["arrival_tick"] for r in trace],
                  "dispatch_ahead": DISPATCH_AHEAD, "smoke": smoke},
        "backends": {},
    }
    rows = []
    for name in names:
        eng = make_backend(name, params, cfg, slots=SLOTS, capacity=CAPACITY,
                           **bkw)
        paged = eng.capabilities().paged
        # the timed replays run with the host-side paged mirror OFF so the
        # throughput/latency A/B isolates the cache policy; mirroring cost
        # is measured separately below
        if paged:
            eng.mirror = False
        # warmup: run the fused tick's shapes once on the same engine —
        # (slots, chunk) for mixed dispatches and (slots, 1) for
        # decode-only top-ups — then replay the measured trace fresh in
        # each mode. The warmup wall is recorded as compile_time_s so
        # steady-state numbers never pay first-call costs. Timed replays
        # are INTERLEAVED (sync, async, sync, ...) and each mode keeps
        # its best, so a shared-box noise burst lands on every mode
        # instead of silently skewing a ratio.
        t0 = time.perf_counter()
        replay(eng, warmup)
        compile_time_s = time.perf_counter() - t0
        modes = {
            "sync": dict(dispatch_ahead=0),
            "async": dict(dispatch_ahead=DISPATCH_AHEAD),
        }
        best: Dict[str, Tuple] = {}
        best_prefill: Dict[str, float] = {}
        for _ in range(3):
            for mode, kw in modes.items():
                sess, toks = replay(eng, trace, **kw)
                summ = sess.telemetry.summary()
                if mode not in best or ((summ["tokens_per_s"] or 0.0)
                                         > (best[mode][0]["tokens_per_s"]
                                            or 0.0)):
                    best[mode] = (summ, toks)
                best_prefill[mode] = max(best_prefill.get(mode, 0.0),
                                          _prefill_tok_rate(summ) or 0.0)
        s_sync, sync_toks = best["sync"]
        s, async_toks = best["async"]
        # no replay may change WHAT is served, only how the work is
        # scheduled on the device: greedy streams are byte-identical by
        # construction, checked before any timing is trusted
        if async_toks != sync_toks:
            raise AssertionError(
                f"{name}: async dispatch/collect replay diverged from the "
                f"synchronous baseline on the same trace")
        rec = _backend_record(s)
        rec["compile_time_s"] = compile_time_s
        rec["sync_tokens_per_s"] = s_sync["tokens_per_s"]
        rec["sync_ttft_p99_s"] = s_sync["ttft_p99_s"]
        if s["tokens_per_s"] and s_sync["tokens_per_s"]:
            rec["async_speedup_vs_sync"] = (
                s["tokens_per_s"] / s_sync["tokens_per_s"])
        # the async replay's BEST prefill-stage rate across the
        # interleaved replays (the fused call's prefill-row
        # apportionment), so the stage rate is the mode's achievable
        # rate instead of whichever replay won on total tokens_per_s
        rec["prefill_tokens_per_s"] = best_prefill["async"] or None
        if paged:
            # decode-time page selection A/B: parity at K = all pages,
            # timed K sweep, serving-path needle accuracy (the engines
            # are per-K — the selection spec is an engine option)
            sel = _selection_ab(name, params, cfg, bkw, trace,
                                warmup, async_toks, s["tokens_per_s"],
                                ks=sel_ks, needle_n=needle_n)
            sel["needle_accuracy_off"] = needle_serving_accuracy(
                eng, cfg.vocab_size, n=needle_n)
            rec["selection"] = sel
            if "selection_speedup" in sel:
                rec["selection_speedup"] = sel["selection_speedup"]
        if trace_out and writer:
            # dedicated traced replay on the warm engine, AFTER the timed
            # A/B (spans cover the production async replay; the timed
            # numbers above stay tracing-free). The artifact is validated
            # here, not just written — an instrumentation regression that
            # empties a span family should fail the bench, not ship a
            # hollow trace.
            tracer = Tracer()
            replay(eng, trace, tracer=tracer)
            tpath = _trace_path(trace_out, name)
            obj = write_chrome_trace(
                tracer, tpath,
                meta={"backend": name, "arrival": arrival,
                      "requests": n_req, "smoke": smoke})
            errs = validate_chrome_trace(obj)
            if errs:
                raise AssertionError(
                    f"{name}: invalid trace artifact {tpath}: {errs[:3]}")
            rows.append((f"serving/{name}/trace_out", 0.0,
                         f"{tpath} events={len(obj['traceEvents'])}"))
        if paged:
            # extra replay on the warm engine with mirroring ON: physical
            # pool telemetry (pages peak / utilization), kept out of the
            # timed numbers above
            eng.mirror = True
            s2 = replay(eng, trace)[0].telemetry.summary()
            rec["pool_utilization"] = s2["pool_util_mean"]
            rec["pool_pages_peak"] = s2["pool_pages_peak"]
            eng.mirror = False
        # multi-turn prefix-cache A/B on the warm engine: hit-rate and
        # the TTFT win of splicing a stored shared-context prefix vs
        # re-prefilling it (streams asserted byte-identical inside)
        rec["prefix"] = _prefix_ab(eng, plen=plen, mnew=mnew,
                                   vocab=cfg.vocab_size, **mt_kw)
        record["backends"][name] = rec
        rows += [
            (f"serving/{name}/trace", (s["wall_s"] or 0.0) * 1e6,
             f"req_per_s={s['requests_per_s']:.2f}"),
            (f"serving/{name}/ttft_mean", (s["ttft_mean_s"] or 0.0) * 1e6,
             f"p90={(s['ttft_p90_s'] or 0.0) * 1e3:.1f}ms"),
            (f"serving/{name}/tpot_mean", (s["tpot_mean_s"] or 0.0) * 1e6,
             f"tok_per_s={s['tokens_per_s']:.1f}"),
            (f"serving/{name}/async_vs_sync", 0.0,
             f"speedup={rec.get('async_speedup_vs_sync', 0.0):.3f}"),
            (f"serving/{name}/memory", 0.0,
             f"kv_tokens_peak={rec['kv_tokens_peak']} "
             f"pool_pages_peak={rec['pool_pages_peak']}"),
            (f"serving/{name}/phases",
             rec["phases"]["tick_time_s"] * 1e6,
             "phase_sum={phase_sum_s:.3f}s prefill={prefill_time_s:.3f}s "
             "dispatch={dispatch_time_s:.3f}s collect={collect_time_s:.3f}s "
             "padding_frac={pad:.3f}"
             .format(pad=rec["fused_padding_frac"] or 0.0,
                     **rec["phases"])),
        ]
        pfx = rec["prefix"]
        rows.append((
            f"serving/{name}/prefix",
            (pfx["ttft_on_hit_p50_s"] or 0.0) * 1e6,
            f"hit_rate={pfx['hit_rate']:.3f} "
            f"tokens_reused={pfx['tokens_reused']:.0f} "
            f"ttft_hit_p50={(pfx['ttft_on_hit_p50_s'] or 0.0) * 1e3:.1f}ms "
            f"miss_p50={(pfx['ttft_on_miss_p50_s'] or 0.0) * 1e3:.1f}ms "
            f"cold_p50={(pfx['ttft_cold_matched_p50_s'] or 0.0) * 1e3:.1f}ms"))
        if paged and "selection" in rec:
            sel = rec["selection"]
            per_k = " ".join(
                f"{k}={v['tokens_per_s'] or 0.0:.1f}tok/s"
                f"(needle={v['needle_accuracy']:.2f})"
                for k, v in sel["per_k"].items())
            rows.append((
                f"serving/{name}/selection", 0.0,
                f"speedup={sel.get('selection_speedup', 0.0):.3f} "
                f"parity_k={sel['parity_k']} {per_k} "
                f"needle_off={sel['needle_accuracy_off']:.2f}"))
    # comparative ratios vs the dense full-KV baseline: the paper's
    # speedup and memory-reduction claims as serving-level numbers
    dense = record["backends"].get("dense")
    if dense:
        record["ab"] = {}
        for name, r in record["backends"].items():
            if name == "dense":
                continue
            ab = {}
            if r["tokens_per_s"] and dense["tokens_per_s"]:
                ab["decode_speedup_vs_dense"] = (
                    r["tokens_per_s"] / dense["tokens_per_s"])
            if r["kv_tokens_peak"] and dense["kv_tokens_peak"]:
                ab["kv_memory_frac_of_dense"] = (
                    r["kv_tokens_peak"] / dense["kv_tokens_peak"])
            record["ab"][name] = ab
            rows.append((f"serving/ab/{name}", 0.0,
                         " ".join(f"{k}={v:.3f}" for k, v in ab.items())
                         or "n/a"))
    if not writer:
        return None
    with open(json_path, "w") as fh:
        json.dump(record, fh, indent=2)
    rows.append(("serving/json", 0.0, json_path))
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.benchmarks.bench_serving",
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--backends", default="wgkv,dense",
                    help="comma-separated subset of " + ",".join(BACKEND_NAMES))
    ap.add_argument("--smoke", action="store_true",
                    help="tiny trace (CI/headless A/B path check)")
    ap.add_argument("--arrival", default="burst",
                    help="arrival process: burst | poisson:<rate> "
                         "(mean arrivals per scheduler tick)")
    ap.add_argument("--mesh", default=None, metavar="DxM",
                    help="replay the A/B on a data x model mesh of D * M "
                         "ranks")
    ap.add_argument("--dist-backend", default=None, choices=("nccl", "gloo"),
                    help="the mesh's process-group backend (default: nccl "
                         "on cuda, gloo on cpu)")
    ap.add_argument("--slo-tolerance", type=float, default=None,
                    metavar="FRAC",
                    help="fail (exit 1) when a backend's p99 TTFT exceeds "
                         "the history at --json-out by more than this "
                         "fraction (e.g. 0.25 = +25%%)")
    ap.add_argument("--trace-out", default=None, metavar="TRACE.json",
                    help="record a dedicated traced replay per backend "
                         "(after the timed A/B) and write validated "
                         "Chrome-trace JSONs, one per backend "
                         "(trace.json -> trace.wgkv.json, ...)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain PyTorch path)")
    ap.add_argument("--json-out", default=None, metavar="PATH",
                    help="the port's record and SLO history (default: "
                         "BENCH_serving_torch.json at the root; with "
                         "--mesh, a temporary file)")
    args = ap.parse_args(argv)
    if args.mesh is not None:
        try:
            parse_mesh_shape(args.mesh)
        except ValueError as e:
            ap.error(str(e))
    if args.json_out is None:
        args.json_out = JSON_PATH if args.mesh is None else os.path.join(
            tempfile.mkdtemp(prefix="bench_serving_mesh_"),
            "BENCH_serving_torch.json")
    # snapshot the committed history BEFORE run() overwrites it
    prev_record = None
    if args.slo_tolerance is not None and os.path.exists(args.json_out):
        with open(args.json_out) as fh:
            prev_record = json.load(fh)
    rows = run(backends=args.backends.split(","), smoke=args.smoke,
               arrival=args.arrival, mesh=args.mesh, trace_out=args.trace_out,
               device=args.device, json_path=args.json_out,
               dist_backend=args.dist_backend)
    print(device_label(resolve_device(args.device)))
    for r in rows:
        print(",".join(str(x) for x in r))
    if args.slo_tolerance is not None:
        with open(args.json_out) as fh:
            new_record = json.load(fh)
        violations = check_slo(prev_record, new_record, args.slo_tolerance)
        if violations:
            print("SLO REGRESSION:", file=sys.stderr)
            for v in violations:
                print(f"  {v}", file=sys.stderr)
            raise SystemExit(1)


if __name__ == "__main__":
    main()
