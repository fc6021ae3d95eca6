"""Serving engine for the write-gated dual cache (port of the ``wgkv``
Engine of ``repro/serving/engine.py`` with the unmeshed half of
``repro/serving/sharded.py`` folded in).

The model math runs through :func:`repro_torch.models.inference.prefill_extend_ragged`;
on CUDA its gate and dual-cache read run in the hand-written kernels.
The engine implements the :class:`~repro_torch.serving.backend.EngineBackend`
protocol the orchestrator schedules:

  * ``step_batch(tasks, chunk, decode=True)`` — the FUSED megabatch tick:
    one ragged call over the persistent batched cache tree advances every
    live row whatever its phase (first-chunk rows are spliced in empty,
    mid-prefill rows take their next chunk, decode rows ride along as
    length-1 rows fed from the on-device sampled vector, dead rows are
    length-0 padding kept bit-identical). Sampling runs on the device and
    ``_tok_dev`` stays a device tensor, so a second step can be
    dispatched before the first is collected (PyTorch enqueues CUDA work
    asynchronously).
  * ``collect(step)`` — the one host sync: pull sampled tokens and per-row
    stats, apply the paged-mirror delta.
  * ``start_prefill`` / ``finish_prefill`` / ``prefill`` / ``insert`` —
    the offline batch-1 prefix surface.
  * ``free_slot(slot)`` — release the slot and its pool pages.
  * ``verify_paged()`` — recompute one layer's attention from the
    PHYSICAL pool through the ``paged_decode`` kernel and compare with
    the logical cache.

Cache trees are never updated in place (every step returns a new tree),
so an in-flight step's ``before``/``after`` trees stay valid for the
mirror. Not ported yet: decode selection, SnapKV eviction, the prefix
store, meshes and the legacy ``add_request``/``step``/``run`` loop.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.dual_cache import DualCache
from repro_torch.device import (DeviceLike, host_to_device,
                                resolve_device, torch_dtype)
from repro_torch.kernels.paged_decode import paged_decode
from repro_torch.launch.specs import (alloc_batched_caches, build_decode_caches,
                                      extract_slot_caches, splice_caches)
from repro_torch.models import inference as I
from repro_torch.serving import paged
from repro_torch.serving.backend import (BackendCapabilities, FusedStep,
                                         Prefix, PrefillTask)
from repro_torch.serving.obs.trace import NULL_TRACER
from repro_torch.serving.sampling import sample
from repro_torch.tree import tree_map


def _host(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


class Engine:
    """Batched serving backend (slots = max concurrent decodes) for the
    paper's write-gated dual cache. ``device`` defaults to ``cuda``;
    ``device="cpu"`` runs the plain PyTorch path."""

    def __init__(self, params, cfg: ModelConfig, *, slots: int = 4,
                 capacity: int = 4096, opts: Optional[I.DecodeOptions] = None,
                 pool_pages: int = 4096, eos: Optional[int] = None,
                 temperature: float = 0.0, seed: int = 0,
                 mirror_paged: bool = True, device: DeviceLike = None):
        if not cfg.has_attention_cache:
            raise ValueError("engine serves KV-cache archs")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.slots = slots
        self.capacity = capacity
        self.opts = opts or I.DecodeOptions()
        self.eos = eos
        self.temperature = temperature
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.caches = None
        self.live: List[bool] = [False] * slots
        # host view of each row's newest token; the decode feed is the
        # DEVICE vector ``_tok_dev``, which dispatch-ahead keeps ahead
        self.last_token: List[int] = [0] * slots
        # bumped on every insert/free so collect() can tell whether a slot
        # still belongs to the request a step was dispatched for
        self._slot_gen: List[int] = [0] * slots
        self.mirror = mirror_paged
        if mirror_paged:
            self.pool = paged.PagedKVPool(pool_pages, cfg.head_dim,
                                          device=self.device)
        self.params = tree_map(lambda x: x.to(self.device), params)
        self._tok_dev = torch.zeros((slots,), dtype=torch.int32,
                                    device=self.device)
        self._resident: List[bool] = [False] * slots
        self._empty_tree = None
        # host cache of per-row resident KV tokens, refreshed at collect
        self._kv_rows = np.zeros((slots,), np.float64)
        self.stats = {"steps": 0, "evict_triggers": 0.0, "decode_adm_sum": 0.0,
                      "extend_time_s": 0.0, "extend_tokens": 0.0,
                      "fused_steps": 0.0, "fused_time_s": 0.0,
                      "fused_prefill_time_s": 0.0,
                      "fused_prefill_tokens": 0.0,
                      "fused_slot_rows": 0.0, "fused_active_rows": 0.0,
                      "selected_pages": 0.0, "selection_time_s": 0.0}
        self.tracer = NULL_TRACER

    # ------------------------------------------------------------------
    # EngineBackend protocol: descriptor + memory telemetry
    # ------------------------------------------------------------------
    def capabilities(self) -> BackendCapabilities:
        return BackendCapabilities(
            name="wgkv", gated=True, paged=self.mirror,
            description="write-gated dual cache (learned admission)",
            sharded=False, selection=None)

    def memory_snapshot(self) -> Dict[str, float]:
        """Resident logical KV tokens/bytes over live slots, plus physical
        pool occupancy when mirroring. Reads host state only."""
        snap: Dict[str, float] = {}
        if self.mirror:
            snap["pool_pages"] = float(self.pool.pages_in_use)
            snap["pool_util"] = float(self.pool.utilization())
        live = [s for s in range(self.slots) if self.live[s]]
        toks = float(self._kv_rows[live].sum()) if live else 0.0
        snap["kv_tokens"] = toks
        snap["kv_bytes"] = float(toks * 2 * self.cfg.head_dim
                                 * torch_dtype(self.cfg.dtype).itemsize)
        return snap

    def _dual_nodes(self, caches) -> List[DualCache]:
        return [caches["blocks"][f"b{i}"]
                for i in range(len(self.cfg.block_pattern))]

    def _kv_tokens_device(self, caches) -> torch.Tensor:
        """[B] resident KV tokens per row on the device, without a sync:
        per layer, admitted global entries summed over kv heads plus the
        filled ring window per head."""
        total = None
        for dc in self._dual_nodes(caches):
            per = (dc.gcnt.sum(dim=(0, 2))
                   + (torch.clamp(dc.t, max=dc.w_local)
                      * dc.gcnt.shape[2]).sum(dim=0))
            total = per if total is None else total + per
        return total.to(torch.int32)

    # ------------------------------------------------------------------
    # offline prefix surface: chunked batch-1 prefill + insert
    # ------------------------------------------------------------------
    @property
    def _w_align(self) -> int:
        """Prefill chunk alignment: the ring window."""
        return self.cfg.wgkv.w_local

    def start_prefill(self, prompt: List[int]) -> PrefillTask:
        return PrefillTask(prompt=list(prompt))

    def _fresh_task_caches(self):
        """Batch-1 EMPTY decode-cache tree (shared: never mutated)."""
        if self._empty_tree is None:
            self._empty_tree = build_decode_caches(
                self.cfg, 1, self.capacity, device=self.device)
        return self._empty_tree

    def _stack_rows(self, trees):
        out = alloc_batched_caches(trees[0], len(trees))
        for i, t in enumerate(trees):
            out = splice_caches(out, t, i)
        return out

    def _extend_ragged(self, tasks: List[PrefillTask],
                       max_tokens: Optional[int]) -> None:
        """ONE batched ragged extend for every mid-prefill task."""
        t_wall = time.perf_counter()
        takes = [len(t.prompt) - t.pos if max_tokens is None
                 else min(len(t.prompt) - t.pos, max_tokens) for t in tasks]
        if max_tokens is None:
            q = self._w_align
            s = -(-max(takes) // q) * q
        else:
            s = max_tokens
        b = len(tasks)
        toks = np.zeros((b, s), np.int32)
        for i, (t, take) in enumerate(zip(tasks, takes)):
            toks[i, :take] = t.prompt[t.pos:t.pos + take]
        batched = tasks[0].caches if b == 1 \
            else self._stack_rows([t.caches for t in tasks])
        with self.tracer.span("prefill_extend_ragged", batch=b, s=s,
                              tokens=int(sum(takes))):
            logits, batched, st = I.prefill_extend_ragged(
                self.params, self.cfg,
                host_to_device(toks, self.device), takes, batched,
                opts=self.opts)
            outs = (batched,) if b == 1 \
                else [extract_slot_caches(batched, i) for i in range(b)]
            trig = _host(st["evict_trigger_rows"])
            adm = _host(st["adm_sum_rows"])
        self.stats["extend_time_s"] += time.perf_counter() - t_wall
        self.stats["extend_tokens"] += float(sum(takes))
        self.stats["evict_triggers"] += float(trig.sum())
        for i, (t, take) in enumerate(zip(tasks, takes)):
            t.caches = outs[i]
            t.last_logits = logits[i:i + 1]
            t.adm_weighted += self._extend_admission(
                adm[i], take, full=(max_tokens is not None
                                    and take == max_tokens))
            t.pos += take

    def _extend_admission(self, adm_sum, take: int, full: bool) -> float:
        """Admission mass one ragged extend adds to a task's
        ``adm_weighted``: a full chunk records mean * take (float32 mean),
        a ragged tail the raw per-step sum — as the reference does."""
        if full:
            return float(np.float32(adm_sum) / np.float32(take)) * take
        return float(adm_sum)

    def finish_prefill(self, task: PrefillTask, *,
                       emit_first: bool = True) -> Prefix:
        """Seal a completed prefill task into a Prefix; with
        ``emit_first`` the first generated token is sampled from the
        prefill's own last-position logits."""
        assert task.done, "prefill task not finished"
        assert task.last_logits is not None, "prefill produced no logits"
        adm = task.adm_weighted / max(task.pos, 1)
        prefix = Prefix(caches=task.caches, prompt_len=len(task.prompt),
                        mean_admission=adm)
        if emit_first:
            prefix.first_token = int(sample(
                self.generator, task.last_logits,
                temperature=self.temperature)[0])
            prefix.first_logits = task.last_logits[0]
        return prefix

    def prefill(self, prompt: List[int], *,
                chunk_tokens: Optional[int] = None,
                emit_first: bool = True) -> Prefix:
        """Drive one task's whole prompt through the ragged extend."""
        if chunk_tokens is not None and chunk_tokens < 1:
            raise ValueError(f"chunk_tokens must be >= 1, got {chunk_tokens}")
        task = self.start_prefill(prompt)
        task.caches = self._fresh_task_caches()
        while task.pos < len(task.prompt):
            self._extend_ragged([task], chunk_tokens)
        return self.finish_prefill(task, emit_first=emit_first)

    def insert(self, prefix: Prefix, slot: int) -> None:
        """Splice a prefix's caches into batch row ``slot`` and mirror it
        into the physical paged pool."""
        if self.caches is None:
            self.caches = alloc_batched_caches(prefix.caches, self.slots)
        self.caches = splice_caches(self.caches, prefix.caches, slot)
        self.live[slot] = True
        self._slot_gen[slot] += 1
        tok = prefix.first_token if prefix.first_token is not None else 0
        self.last_token[slot] = tok
        self._set_tok(slot, tok)
        self._kv_rows[slot] = float(self._kv_tokens_device(prefix.caches)[0])
        if self.mirror:
            self._mirror_prefill(slot, prefix.caches)

    def _set_tok(self, slot: int, tok: int) -> None:
        """Set one row of the device feed without a host->device copy."""
        rows = torch.arange(self.slots, device=self.device)
        self._tok_dev = torch.where(rows == slot, tok, self._tok_dev)

    # ------------------------------------------------------------------
    # fused megabatch tick
    # ------------------------------------------------------------------
    def _fused(self, toks: np.ndarray, lengths: np.ndarray,
               use_dev: np.ndarray, caches):
        """The fused step: ragged extend over the persistent batched tree
        with decode rows fed from the on-device sampled vector, sampling
        and per-row resident-token counts on the device too."""
        tokens = host_to_device(toks, self.device)
        use = host_to_device(use_dev, self.device)
        tokens[:, 0] = torch.where(use, self._tok_dev, tokens[:, 0])
        last_logits, caches, st = I.prefill_extend_ragged(
            self.params, self.cfg, tokens, lengths, caches, opts=self.opts)
        sampled = sample(self.generator, last_logits,
                         temperature=self.temperature)
        kv_rows = self._kv_tokens_device(caches)
        return last_logits, caches, {**st, "sampled": sampled,
                                     "kv_tokens_rows": kv_rows}

    def step_batch(self, tasks: List[PrefillTask],
                   max_tokens: Optional[int] = None, *,
                   decode: bool = True) -> Optional[FusedStep]:
        """Dispatch ONE fused ragged step advancing every live row of the
        persistent batched cache tree — prefill chunks and decode tokens
        together — without synchronizing. Each task must carry its
        reserved ``slot``; host state advances at dispatch so a second
        step can be dispatched behind this one. Returns None when nothing
        can advance."""
        if max_tokens is not None and max_tokens < 1:
            raise ValueError(f"max_tokens must be >= 1, got {max_tokens}")
        tasks = [t for t in tasks if not t.done]
        if not tasks and not (decode and any(self.live)):
            return None
        t0 = time.perf_counter()
        if self.caches is None:
            self.caches = alloc_batched_caches(self._fresh_task_caches(),
                                               self.slots)
        for t in tasks:
            assert t.slot is not None, "fused step_batch needs slot-bound tasks"
            assert not self.live[t.slot], "prefill task in a live decode row"
            if t.prefix_entry is not None:
                raise NotImplementedError("the prefix store is not ported "
                                          "to repro_torch yet")
            if not self._resident[t.slot]:
                with self.tracer.span("fused_open", slot=t.slot):
                    self.caches = splice_caches(
                        self.caches, self._fresh_task_caches(), t.slot)
                self._resident[t.slot] = True
                self._slot_gen[t.slot] += 1
        takes = [len(t.prompt) - t.pos if max_tokens is None
                 else min(len(t.prompt) - t.pos, max_tokens) for t in tasks]
        if not tasks:
            s = 1
        elif max_tokens is None:
            q = self._w_align
            s = -(-max(takes) // q) * q
        else:
            s = max_tokens
        toks = np.zeros((self.slots, s), np.int32)
        lengths = np.zeros((self.slots,), np.int32)
        use_dev = np.zeros((self.slots,), bool)
        for t, take in zip(tasks, takes):
            toks[t.slot, :take] = t.prompt[t.pos:t.pos + take]
            lengths[t.slot] = take
        decode_rows = tuple(sl for sl in range(self.slots)
                            if decode and self.live[sl] and lengths[sl] == 0)
        for sl in decode_rows:
            lengths[sl] = 1
            use_dev[sl] = True
        # a dead row decodes masked but still feeds its last_token; a
        # nonzero token there is a missed free_slot reset
        assert all(self.last_token[sl] == 0 for sl in range(self.slots)
                   if not self.live[sl] and lengths[sl] == 0), \
            "stale last_token on a dead row"
        self.stats["fused_slot_rows"] += float(self.slots)
        self.stats["fused_active_rows"] += float(int((lengths > 0).sum()))
        before = self.caches
        with self.tracer.device_scope("fused_step"):
            _logits, self.caches, st = self._fused(toks, lengths, use_dev,
                                                   before)
        sampled = st["sampled"]
        finishing = []
        for t, take in zip(tasks, takes):
            t.pos += take
            fin = t.pos >= len(t.prompt)
            finishing.append(fin)
            if fin:
                self.live[t.slot] = True
        # only rows that really sampled this step update the device feed
        fed = np.zeros((self.slots,), bool)
        for sl in decode_rows:
            fed[sl] = True
        for t, fin in zip(tasks, finishing):
            fed[t.slot] = fin
        self._tok_dev = torch.where(host_to_device(fed, self.device),
                                    sampled, self._tok_dev)
        fulls = [max_tokens is not None and take == max_tokens
                 for take in takes]
        return FusedStep(
            tokens=sampled, stats=st,
            before=before if self.mirror else None, after=self.caches,
            live=tuple(self.live), gen=tuple(self._slot_gen),
            tasks=tuple(tasks), takes=tuple(takes), fulls=tuple(fulls),
            finishing=tuple(finishing), decode_rows=decode_rows,
            had_prefill=bool(tasks), t_dispatch=t0, selection=False)

    def collect(self, step: FusedStep) -> Dict[int, int]:
        """Synchronize one in-flight fused step: pull its sampled tokens
        and per-row stats to the host (the one sync), fold admission
        stats, mirror finishing rows' prefixes and decode rows' deltas
        into the paged pool, and return {slot: token} for every slot
        still owned by the request the step was dispatched for."""
        assert not step.collected, "in-flight step collected twice"
        step.collected = True
        nxt, trig, adm, kvr = (_host(x) for x in (
            step.tokens, step.stats["evict_trigger_rows"],
            step.stats["adm_sum_rows"], step.stats["kv_tokens_rows"]))
        for sl in range(self.slots):
            if self._slot_gen[sl] == step.gen[sl]:
                self._kv_rows[sl] = float(kvr[sl])
        wall = time.perf_counter() - step.t_dispatch
        self.stats["fused_steps"] += 1
        self.stats["fused_time_s"] += wall
        if step.had_prefill:
            self.stats["fused_prefill_time_s"] += wall
            self.stats["fused_prefill_tokens"] += float(sum(step.takes))
        self.stats["evict_triggers"] += float(trig.sum())
        for t, take, full in zip(step.tasks, step.takes, step.fulls):
            t.adm_weighted += self._extend_admission(adm[t.slot], take,
                                                     full=full)
        if step.decode_rows:
            self.stats["steps"] += 1
            # a decode row has exactly one real position, so its ragged
            # adm SUM is that step's per-row mean admission
            self.stats["decode_adm_sum"] += float(
                adm[list(step.decode_rows)].mean())
        rows = [s for s in step.decode_rows
                if self.live[s] and self._slot_gen[s] == step.gen[s]]
        if self.mirror and step.before is not None:
            for t, fin in zip(step.tasks, step.finishing):
                if fin and self._slot_gen[t.slot] == step.gen[t.slot]:
                    self._mirror_prefill(
                        t.slot, extract_slot_caches(step.after, t.slot))
            if rows:
                self._mirror_decode(step.before, step.after, rows=rows)
        out: Dict[int, int] = {}
        for t, fin in zip(step.tasks, step.finishing):
            if fin and self._slot_gen[t.slot] == step.gen[t.slot]:
                tok = int(nxt[t.slot])
                self.last_token[t.slot] = tok
                out[t.slot] = tok
        for s in rows:
            tok = int(nxt[s])
            self.last_token[s] = tok
            out[s] = tok
        return out

    def free_slot(self, slot: int) -> None:
        """Retire a slot: stop decoding it and reclaim its pool pages."""
        self.live[slot] = False
        self._resident[slot] = False
        self._slot_gen[slot] += 1
        # a retired row keeps decoding (masked) in the batched step; zero
        # its token so the dead row never replays its final token
        self.last_token[slot] = 0
        self._set_tok(slot, 0)
        self._kv_rows[slot] = 0.0
        if self.mirror and self.caches is not None:
            for lkey in self._layer_keys():
                for h in range(self.cfg.n_kv_heads):
                    self.pool.free_stream((slot, lkey, h, "global"))
                    self.pool.free_stream((slot, lkey, h, "local"))

    # ------------------------------------------------------------------
    # paged-pool mirroring
    # ------------------------------------------------------------------
    def _layer_keys(self):
        return [(r, i) for i in range(len(self.cfg.block_pattern))
                for r in range(self.cfg.n_repeats)]

    def _mirror_prefill(self, slot: int, caches) -> None:
        """Copy a batch-1 tree's logical dual caches into the physical
        pool: each head's ``gcnt`` global entries and its ``min(t, W)``
        filled ring slots (ring pages are allocated lazily until the
        wrap). One host transfer per leaf for all layers."""
        for i, node in enumerate(self._dual_nodes(caches)):
            gk, gv, lk, lv, gcnt, t = (_host(x) for x in (
                node.gk, node.gv, node.lk, node.lv, node.gcnt, node.t))
            w = node.w_local
            for r in range(self.cfg.n_repeats):
                n_local = min(int(t[r, 0]), w)
                for h in range(self.cfg.n_kv_heads):
                    gkey = (slot, (r, i), h, "global")
                    self.pool.free_stream(gkey)
                    cnt = int(gcnt[r, 0, h])
                    self.pool.bulk_append(gkey, gk[r, 0, h, :cnt],
                                          gv[r, 0, h, :cnt])
                    lkey = (slot, (r, i), h, "local")
                    self.pool.free_stream(lkey)
                    self.pool.bulk_append(lkey, lk[r, 0, h, :n_local],
                                          lv[r, 0, h, :n_local])

    def _mirror_decode(self, before, after, *,
                       rows: Optional[List[int]] = None) -> None:
        """Apply one decode step's logical cache delta to the pool: the
        ring vector each row wrote at its pre-step pointer, and the
        newest global entry of each head whose ``gcnt`` grew. The needed
        vectors are gathered on the device for all layers at once, so the
        host pulls a handful of [layers, rows, heads, hd] arrays."""
        if rows is None:
            rows = [s for s in range(self.slots) if self.live[s]]
        if not rows:
            return
        dev = self.device
        ridx = torch.as_tensor(rows, device=dev)
        for i, (dcb, dca) in enumerate(zip(self._dual_nodes(before),
                                           self._dual_nodes(after))):
            n_rep, _, hkv = dca.gcnt.shape
            gcb = dcb.gcnt[:, ridx]                             # [R, n, H]
            ptrb = dcb.ptr[:, ridx].long()                      # [R, n]
            gca = dca.gcnt[:, ridx]
            li = torch.arange(n_rep, device=dev)[:, None, None]
            r2 = ridx[None, :, None]
            h2 = torch.arange(hkv, device=dev)[None, None, :]
            p2 = ptrb[:, :, None]
            g2 = torch.clamp(gca - 1, min=0).long()
            ring_k, ring_v, prom_k, prom_v, gcb, ptrb, gca = (
                _host(x) for x in (
                    dca.lk[li, r2, h2, p2], dca.lv[li, r2, h2, p2],
                    dca.gk[li, r2, h2, g2], dca.gv[li, r2, h2, g2],
                    gcb, ptrb, gca))
            for r in range(n_rep):
                for j, slot in enumerate(rows):
                    p = int(ptrb[r, j])
                    for h in range(hkv):
                        if int(gca[r, j, h]) > int(gcb[r, j, h]):
                            # promotion: gcnt grew -> append promoted token
                            self.pool.append((slot, (r, i), h, "global"),
                                             prom_k[r, j, h], prom_v[r, j, h])
                        # ring write at ptr_before: grows the stream until
                        # the ring wraps, overwrites after
                        lkey = (slot, (r, i), h, "local")
                        if p == self.pool.table(lkey).length:
                            self.pool.append(lkey, ring_k[r, j, h],
                                             ring_v[r, j, h])
                        else:
                            self.pool.overwrite(lkey, p, ring_k[r, j, h],
                                                ring_v[r, j, h])

    # ------------------------------------------------------------------
    def verify_paged(self, layer_repeat: int = 0, block: int = 0,
                     atol: float = 2e-3) -> float:
        """Recompute one layer's decode attention for all live slots from
        the PHYSICAL pool via the paged_decode kernel and compare with the
        logical dual-cache contents. Returns max abs deviation."""
        assert self.mirror and self.caches is not None
        live = [s for s in range(self.slots) if self.live[s]]
        if not live:
            return 0.0
        node = self.caches["blocks"][f"b{block}"]
        dc = DualCache(*(_host(x[layer_repeat]) for x in node))
        lkey = (layer_repeat, block)
        worst = 0.0
        for slot in live:
            n_local = min(int(dc.t[slot]), node.w_local)
            for h in range(self.cfg.n_kv_heads):
                gk, _ = self.pool.gather((slot, lkey, h, "global"))
                cnt = int(dc.gcnt[slot, h])
                logical = np.asarray(dc.gk[slot, h, :cnt], np.float32)
                if cnt:
                    worst = max(worst, float(np.abs(gk[:cnt] - logical).max()))
                lk, _ = self.pool.gather((slot, lkey, h, "local"))
                # ring pages are allocated lazily: the stream holds exactly
                # the min(t, W) slots written so far
                assert lk.shape[0] == n_local, (lk.shape, n_local)
                if n_local:
                    worst = max(worst, float(np.abs(
                        lk - np.asarray(dc.lk[slot, h, :n_local],
                                        np.float32)).max()))
        # kernel-level check: paged attention over the global streams
        keys = [(s, lkey, h, "global")
                for s in live for h in range(self.cfg.n_kv_heads)]
        kp, vp, tbl, lens = self.pool.kernel_args(keys)
        if int(lens.max()) > 0:
            hd = self.cfg.head_dim
            q = torch.ones((len(keys), hd), dtype=torch.float32,
                           device=self.device) / hd
            out = _host(paged_decode(q, kp, vp, tbl, lens))
            i = 0
            for s in live:
                for h in range(self.cfg.n_kv_heads):
                    cnt = int(dc.gcnt[s, h])
                    if cnt:
                        kk = np.asarray(dc.gk[s, h, :cnt], np.float32)
                        vv = np.asarray(dc.gv[s, h, :cnt], np.float32)
                        lg = (np.ones(hd) / hd) @ kk.T / np.sqrt(hd)
                        w = np.exp(lg - lg.max())
                        w /= w.sum()
                        oracle = w @ vv
                        worst = max(worst, float(np.abs(out[i] - oracle).max()))
                    i += 1
        return worst
