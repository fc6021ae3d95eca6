"""Serving telemetry: throughput, latency percentiles, paged-pool
utilization, eviction triggers, and mean write-gate admission rate.

The admission rate is the paper's headline memory knob surfaced as a
serving metric: a mean admission of ``a`` with local window ``W`` means
steady-state KV residency ~``a*t + W`` tokens instead of ``t`` — the
memory saving the gate buys is directly observable per request here.

Telemetry sits on top of the observability metrics registry
(:class:`repro_torch.serving.obs.MetricsRegistry`): the public ``counters``
dict is a live :class:`repro_torch.serving.obs.CounterView` over registry
counters, and every latency/memory observation also feeds a
rolling-window histogram — so the end-of-run ``summary()``/``report()``
(cumulative) and the live periodic ``live_line()`` (windowed; the
``--metrics-interval`` report in launch/serve.py) share one source of
truth instead of two bookkeeping paths that can drift.
"""
from __future__ import annotations

import dataclasses
import datetime
import json
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from repro_torch.serving.obs.metrics import CounterView, MetricsRegistry

# summary()/to_json() artifact schema: bump on shape changes so BENCH /
# trace consumers across PRs can tell what they are reading
TELEMETRY_SCHEMA_VERSION = 4

# tick-phase wall-time counters (seconds), accumulated by the
# orchestrator's phase spans: where each tick's time goes. ``extend``
# is an engine-side sub-phase of the ``prefill`` stage (synced from
# engine stats), so the disjoint per-tick decomposition is
# prefill + dispatch + collect + evict + memory_sample + admit <= tick.
PHASE_TIME_KEYS = ("prefill_time_s", "dispatch_time_s", "collect_time_s",
                   "evict_time_s", "memory_sample_time_s", "admit_time_s",
                   "prefix_capture_time_s")


@dataclasses.dataclass
class RequestRecord:
    rid: int
    prompt_len: int
    n_out: int
    ttft: Optional[float]
    tpot: Optional[float]
    e2e: Optional[float]
    mean_admission: Optional[float]
    # chunks this request's prefill took (batched ticks count one chunk
    # per task, same as the per-request driver)
    prefill_chunks: int = 0
    # prefix-cache outcome: served off a stored shared-context prefix
    # (and how many prompt tokens the splice skipped re-prefilling)
    prefix_hit: bool = False
    prefix_tokens: int = 0


def _pct(xs: List[float], q: float) -> Optional[float]:
    return float(np.percentile(np.asarray(xs), q)) if xs else None


def _mean(xs: List[float]) -> Optional[float]:
    return float(np.mean(np.asarray(xs))) if xs else None


class Telemetry:
    """Aggregates counters, per-request latency records, and pool samples."""

    def __init__(self, clock: Callable[[], float] = time.monotonic,
                 window_s: float = 30.0):
        self.clock = clock
        self.t_start: Optional[float] = None
        self.t_end: Optional[float] = None
        self.metrics = MetricsRegistry(clock=clock, window_s=window_s)
        # live dict-like view over registry counters (historic contract:
        # telemetry.counters[...] reads/writes keep working everywhere)
        self.counters: Dict[str, float] = CounterView(self.metrics)
        for name, v in (
                ("ticks", 0), ("decode_steps", 0), ("prefill_chunks", 0),
                # prefill ADVANCE calls: one batched ragged call covers many
                # tasks, so prefill_batches <= prefill_chunks (equal only
                # under the per-request driver) — prefill_chunks keeps its
                # one-per-task-per-tick meaning. (A task's first aligned
                # chunk additionally runs its own batch-1 prefill inside the
                # call, so this is not an exact device-dispatch count.)
                ("prefill_batches", 0),
                # wall seconds spent in the tick loop's prefill-advance stage
                # (open + batched/per-task extend calls, incl. their device
                # sync): prefill_tokens / prefill_time_s is the prompt-ingest
                # rate the batched-prefill A/B compares
                ("prefill_time_s", 0.0),
                ("prefill_tokens", 0), ("generated_tokens", 0),
                ("completed", 0), ("rejected", 0), ("evict_triggers", 0.0),
                # async driver + client-surface lifecycle (scheduler/session)
                ("dispatched_steps", 0), ("cancelled", 0),
                ("deadline_expired", 0),
                # tick-phase wall-time breakdown (orchestrator phase spans)
                ("tick_time_s", 0.0), ("dispatch_time_s", 0.0),
                ("collect_time_s", 0.0), ("evict_time_s", 0.0),
                ("memory_sample_time_s", 0.0), ("admit_time_s", 0.0),
                # fused megabatch tick (engine stats, synced per tick):
                # fused_prefill_time_s/_tokens apportion the fused call's
                # wall time to its prefill rows for the prompt-ingest rate
                ("fused_steps", 0), ("fused_time_s", 0.0),
                ("fused_prefill_time_s", 0.0), ("fused_prefill_tokens", 0),
                # fixed-shape padding accounting of fused dispatches
                # (fused_padding_frac = 1 - active/slot rows)
                ("fused_slot_rows", 0), ("fused_active_rows", 0),
                # decode-time page selection (gathered top-K fused ticks)
                ("selected_pages", 0.0), ("selection_time_s", 0.0),
                # content-addressed prefix store (admission-gated
                # shared-context reuse): hit/miss at admission, LRU
                # evictions, and the store's current byte footprint
                ("prefix_hit", 0), ("prefix_miss", 0),
                ("prefix_evict", 0.0), ("prefix_bytes", 0.0),
                ("prefix_capture_time_s", 0.0)):
            self.counters[name] = v
        self.records: List[RequestRecord] = []
        self.pool_util_samples: List[float] = []
        self.pool_page_samples: List[int] = []
        self.kv_token_samples: List[float] = []
        self.kv_byte_samples: List[float] = []
        self.kv_byte_shard_samples: List[float] = []  # per-device, meshed
        # live_line() state: last cut (t, generated_tokens, completed)
        self._line_mark: Optional[tuple] = None

    # ---- lifecycle -------------------------------------------------------
    def start(self) -> None:
        if self.t_start is None:
            self.t_start = self.clock()

    def stop(self) -> None:
        self.t_end = self.clock()

    def bump(self, name: str, by: float = 1) -> None:
        self.metrics.counter(name).inc(by)

    def sample_memory(self, snapshot: Dict[str, float]) -> None:
        """Record one backend ``memory_snapshot()``: paged-pool occupancy
        (when the backend is physically paged) and resident KV tokens/bytes
        (every backend) — the serving-level memory axis of the A/B."""
        gauge = self.metrics.gauge
        if "pool_util" in snapshot:
            self.pool_util_samples.append(float(snapshot["pool_util"]))
            gauge("pool_util").set(snapshot["pool_util"])
        if "pool_pages" in snapshot:
            self.pool_page_samples.append(int(snapshot["pool_pages"]))
            gauge("pool_pages").set(snapshot["pool_pages"])
        if "kv_tokens" in snapshot:
            self.kv_token_samples.append(float(snapshot["kv_tokens"]))
            gauge("kv_tokens").set(snapshot["kv_tokens"])
        if "kv_bytes" in snapshot:
            self.kv_byte_samples.append(float(snapshot["kv_bytes"]))
            gauge("kv_bytes").set(snapshot["kv_bytes"])
        if "kv_bytes_per_shard" in snapshot:
            # sharded backends: even-occupancy per-device share of kv_bytes
            self.kv_byte_shard_samples.append(
                float(snapshot["kv_bytes_per_shard"]))
            gauge("kv_bytes_per_shard").set(snapshot["kv_bytes_per_shard"])

    def record_request(self, *, rid: int, prompt_len: int, n_out: int,
                       ttft: Optional[float], tpot: Optional[float],
                       e2e: Optional[float],
                       mean_admission: Optional[float],
                       prefill_chunks: int = 0,
                       prefix_hit: bool = False,
                       prefix_tokens: int = 0) -> None:
        self.records.append(RequestRecord(rid, prompt_len, n_out, ttft,
                                          tpot, e2e, mean_admission,
                                          prefill_chunks, prefix_hit,
                                          prefix_tokens))
        self.bump("completed")
        self.bump("generated_tokens", n_out)
        # rolling-window view of the same observations (live_line)
        if ttft is not None:
            self.metrics.observe("ttft_s", ttft)
        if tpot is not None:
            self.metrics.observe("tpot_s", tpot)
        if e2e is not None:
            self.metrics.observe("e2e_s", e2e)

    # ---- aggregation -----------------------------------------------------
    def summary(self) -> Dict[str, object]:
        wall = None
        if self.t_start is not None:
            wall = (self.t_end or self.clock()) - self.t_start
        ttfts = [r.ttft for r in self.records if r.ttft is not None]
        tpots = [r.tpot for r in self.records if r.tpot is not None]
        e2es = [r.e2e for r in self.records if r.e2e is not None]
        adms = [r.mean_admission for r in self.records
                if r.mean_admission is not None]
        n = len(self.records)
        toks = self.counters["generated_tokens"]
        steps = self.counters["decode_steps"]
        decode_adm = (self.counters.get("decode_adm_sum", 0.0) / steps
                      if steps else None)
        # fixed-shape padding of the fused dispatches: every compiled
        # step spans all slot rows, so on CPU-XLA the padded rows cost
        # real compute — this fraction makes stage-time ratios legible
        slot_rows = self.counters.get("fused_slot_rows", 0.0)
        pad_frac = (1.0 - self.counters.get("fused_active_rows", 0.0)
                    / slot_rows) if slot_rows else None
        # prefix-cache split: TTFT on hit vs miss is the store's win axis
        ttft_hit = [r.ttft for r in self.records
                    if r.prefix_hit and r.ttft is not None]
        ttft_miss = [r.ttft for r in self.records
                     if not r.prefix_hit and r.ttft is not None]
        return {
            # self-description: artifacts (BENCH json, committed
            # summaries) say what schema they carry and when they were cut
            "schema_version": TELEMETRY_SCHEMA_VERSION,
            "generated_at": datetime.datetime.now(
                datetime.timezone.utc).isoformat(),
            "mean_admission_decode": decode_adm,
            "fused_padding_frac": pad_frac,
            "requests": n,
            "wall_s": wall,
            "requests_per_s": (n / wall if wall else None),
            "tokens_per_s": (toks / wall if wall else None),
            "ttft_mean_s": _mean(ttfts),
            "ttft_p50_s": _pct(ttfts, 50),
            "ttft_p90_s": _pct(ttfts, 90),
            "ttft_p99_s": _pct(ttfts, 99),
            "tpot_mean_s": _mean(tpots),
            "tpot_p50_s": _pct(tpots, 50),
            "tpot_p90_s": _pct(tpots, 90),
            "tpot_p99_s": _pct(tpots, 99),
            "prefill_chunks_per_request_mean": _mean(
                [float(r.prefill_chunks) for r in self.records]),
            "prefix_hit_rate": (sum(1 for r in self.records if r.prefix_hit)
                                / n if n else None),
            "prefix_tokens_reused": float(sum(
                r.prefix_tokens for r in self.records)),
            "ttft_on_hit_p50_s": _pct(ttft_hit, 50),
            "ttft_on_miss_p50_s": _pct(ttft_miss, 50),
            "e2e_mean_s": _mean(e2es),
            "mean_admission": _mean(adms),
            "pool_util_mean": _mean(self.pool_util_samples),
            "pool_util_last": (self.pool_util_samples[-1]
                               if self.pool_util_samples else None),
            "pool_pages_peak": (max(self.pool_page_samples)
                                if self.pool_page_samples else None),
            "kv_tokens_peak": (max(self.kv_token_samples)
                               if self.kv_token_samples else None),
            "kv_tokens_mean": _mean(self.kv_token_samples),
            "kv_bytes_peak": (max(self.kv_byte_samples)
                              if self.kv_byte_samples else None),
            "kv_bytes_per_shard_peak": (max(self.kv_byte_shard_samples)
                                        if self.kv_byte_shard_samples
                                        else None),
            "counters": dict(self.counters),
        }

    def phase_times(self) -> Dict[str, float]:
        """Per-phase tick wall-time decomposition (seconds): the disjoint
        orchestrator phases plus the engine-side prefill sub-phase
        (``extend_time_s``, contained in ``prefill_time_s``) and the
        measured total ``tick_time_s``."""
        c = self.counters
        out = {k: float(c.get(k, 0.0)) for k in PHASE_TIME_KEYS}
        out["extend_time_s"] = float(c.get("extend_time_s", 0.0))
        # fused megabatch: one device call per tick covering prefill rows
        # and decode rows together — its wall time lands in
        # dispatch_time_s (already a PHASE_TIME_KEYS member), surfaced
        # here as its own lens plus the prefill-row apportionment and
        # the selection-enabled (gathered top-K) share
        out["fused_time_s"] = float(c.get("fused_time_s", 0.0))
        out["fused_prefill_time_s"] = float(c.get("fused_prefill_time_s", 0.0))
        out["selection_time_s"] = float(c.get("selection_time_s", 0.0))
        out["tick_time_s"] = float(c.get("tick_time_s", 0.0))
        out["phase_sum_s"] = sum(float(c.get(k, 0.0))
                                 for k in PHASE_TIME_KEYS)
        return out

    def report(self) -> str:
        s = self.summary()
        c = s["counters"]

        def f(x, unit="", scale=1.0, nd=2):
            return "-" if x is None else f"{x * scale:.{nd}f}{unit}"

        ph = self.phase_times()
        lines = [
            f"requests={s['requests']} "
            f"({c['rejected']:.0f} rejected by backpressure, "
            f"{c['cancelled']:.0f} cancelled, "
            f"{c['deadline_expired']:.0f} past deadline)  "
            f"wall={f(s['wall_s'], 's')}",
            f"throughput: {f(s['requests_per_s'])} req/s, "
            f"{f(s['tokens_per_s'])} tok/s "
            f"(decode_steps={c['decode_steps']:.0f}, "
            f"prefill_chunks={c['prefill_chunks']:.0f} "
            f"in {c['prefill_batches']:.0f} batches, "
            f"prefill_tokens={c['prefill_tokens']:.0f})",
            f"TTFT: mean={f(s['ttft_mean_s'], 'ms', 1e3)} "
            f"p50={f(s['ttft_p50_s'], 'ms', 1e3)} "
            f"p90={f(s['ttft_p90_s'], 'ms', 1e3)} "
            f"p99={f(s['ttft_p99_s'], 'ms', 1e3)}",
            # p99 included: --slo-tolerance gates on tpot_p99_s, so the
            # human-readable report must show the same tail it gates
            f"TPOT: mean={f(s['tpot_mean_s'], 'ms', 1e3)} "
            f"p50={f(s['tpot_p50_s'], 'ms', 1e3)} "
            f"p90={f(s['tpot_p90_s'], 'ms', 1e3)} "
            f"p99={f(s['tpot_p99_s'], 'ms', 1e3)}",
            f"tick phases: prefill={f(ph['prefill_time_s'], 's')} "
            f"(extend={f(ph['extend_time_s'], 's')}) "
            f"dispatch={f(ph['dispatch_time_s'], 's')} "
            f"(fused={f(ph['fused_time_s'], 's')} "
            f"of which prefill={f(ph['fused_prefill_time_s'], 's')} "
            f"over {c['fused_steps']:.0f} fused steps) "
            f"collect={f(ph['collect_time_s'], 's')} "
            f"evict={f(ph['evict_time_s'], 's')} "
            f"mem={f(ph['memory_sample_time_s'], 's')} "
            f"/ tick_total={f(ph['tick_time_s'], 's')}",
            f"admission: prefill_mean={f(s['mean_admission'], nd=3)} "
            f"decode_mean={f(s['mean_admission_decode'], nd=3)} "
            f"(evict_triggers={c['evict_triggers']:.0f})",
            f"fused padding_frac={f(s['fused_padding_frac'], nd=3)}  "
            f"selection: pages={c.get('selected_pages', 0.0):.0f} "
            f"time={f(ph['selection_time_s'], 's')}",
            f"prefix cache: hit_rate={f(s['prefix_hit_rate'], nd=3)} "
            f"(hits={c.get('prefix_hit', 0.0):.0f} "
            f"misses={c.get('prefix_miss', 0.0):.0f} "
            f"evictions={c.get('prefix_evict', 0.0):.0f}) "
            f"tokens_reused={s['prefix_tokens_reused']:.0f} "
            f"bytes={c.get('prefix_bytes', 0.0):.0f}  "
            f"ttft_on_hit_p50={f(s['ttft_on_hit_p50_s'], 'ms', 1e3)} "
            f"vs_miss_p50={f(s['ttft_on_miss_p50_s'], 'ms', 1e3)}",
            f"paged pool: util_mean={f(s['pool_util_mean'], nd=3)} "
            f"util_last={f(s['pool_util_last'], nd=3)} "
            f"pages_peak={s['pool_pages_peak']}",
            f"resident KV: tokens_peak={f(s['kv_tokens_peak'], nd=0)} "
            f"tokens_mean={f(s['kv_tokens_mean'], nd=0)} "
            f"bytes_peak={f(s['kv_bytes_peak'], nd=0)} "
            f"bytes_per_shard_peak={f(s['kv_bytes_per_shard_peak'], nd=0)}",
        ]
        return "\n".join(lines)

    # ---- live periodic reporting ----------------------------------------
    def live_line(self, interval_s: float) -> Optional[str]:
        """One-line rolling snapshot, at most once per ``interval_s``
        seconds (None between cuts): windowed token rate + windowed
        latency percentiles + instantaneous memory gauges. The
        orchestrator calls this every tick when a metrics interval is
        configured (launch/serve.py ``--metrics-interval``)."""
        now = self.clock()
        if self._line_mark is None:
            # first call opens the window; no line until it elapses
            self._line_mark = (now, self.counters["generated_tokens"],
                               self.counters["completed"])
            return None
        t0, toks0, done0 = self._line_mark
        if now - t0 < interval_s:
            return None
        dt = now - t0
        toks = self.counters["generated_tokens"]
        done = self.counters["completed"]
        self._line_mark = (now, toks, done)
        self.metrics.mark_counters()

        def fmt(x, unit="", scale=1.0, nd=1):
            return "-" if x is None else f"{x * scale:.{nd}f}{unit}"

        ttft = self.metrics.histogram("ttft_s").window_stats(now)
        tpot = self.metrics.histogram("tpot_s").window_stats(now)
        kv = self.metrics.gauge("kv_tokens").value
        util = self.metrics.gauge("pool_util").value
        wall = now - (self.t_start if self.t_start is not None else t0)
        return (f"[metrics +{wall:.1f}s] "
                f"done={done:.0f} (+{done - done0:.0f}) "
                f"tok/s={fmt((toks - toks0) / dt if dt > 0 else None)} "
                f"ttft_p50={fmt(ttft['p50'], 'ms', 1e3)} "
                f"ttft_p99={fmt(ttft['p99'], 'ms', 1e3)} "
                f"tpot_p50={fmt(tpot['p50'], 'ms', 1e3)} "
                f"kv_tokens={fmt(kv, nd=0)} "
                f"pool_util={fmt(util, nd=3)} "
                f"ticks={self.counters['ticks']:.0f}")

    def to_json(self, path: str) -> None:
        with open(path, "w") as fh:
            json.dump(self.summary(), fh, indent=2)
