"""Serving engine for the write-gated dual cache (port of the ``wgkv``
Engine of ``repro/serving/engine.py``; its mesh placement is
:class:`~repro_torch.serving.sharded.ShardedDecodeMixin`).

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
    On a DECODE-ONLY tick an engine configured with
    ``DecodeOptions.selection_policy = "quest:K"`` runs the Quest
    selection variant of the same step, whose decode read walks only the
    top-K global pages per (row, kv head) through the
    ``paged_decode_selected`` kernel; mixed ticks run the full path.
  * ``collect(step)`` — the one host sync: pull sampled tokens and per-row
    stats, apply the paged-mirror delta (a full re-sync of a row's global
    streams after a SnapKV eviction compacted them).
  * ``start_prefill`` / ``finish_prefill`` / ``prefill`` / ``insert`` —
    the offline batch-1 prefix surface.
  * ``free_slot(slot)`` — release the slot and its pool pages.
  * ``capture_prefix`` / ``release_prefix`` — the prefix store's hooks
    (serving/prefix_cache.py): freeze a collected row into a shareable
    batch-1 entry whose pool streams a hitting slot aliases by refcount
    (copy-on-write keeps sharers apart); a task carrying
    ``prefix_entry`` is spliced from the entry instead of an empty tree
    and resumes at the suffix.
  * ``verify_paged()`` — recompute one layer's attention from the
    PHYSICAL pool through the ``paged_decode`` kernel and compare with
    the logical cache.
  * ``add_request`` / ``step`` / ``run`` — the reference's fixed-slot
    loop, a thin layer over ``prefill`` / ``insert`` / ``step_batch`` /
    ``collect``.
  * ``COMPILE_SHAPE_BUDGETS`` / ``compiled_shape_counts()`` — the step
    shapes the engine dispatches, per kind, and their budget
    (``analysis.CompileSentinel`` holds a replay to it).

The tick's methods carry ``analysis.contracts.tick_path``: the port's
lint (``python -m repro_torch.analysis.lint``) flags any host sync in
them that is not annotated with its reason, and
``analysis.SyncSentinel`` checks the same discipline at run time.

The dense and static-admission baselines (serving/dense.py,
serving/static_admission.py) subclass this engine through its seams:
``_build_empty_caches``, ``_kv_tokens_device``, ``_extend_admission``,
``_decode_admission``, ``_pre_fused_dispatch``, ``_adopt_prefix`` and
``mirror_paged=False``.

Cache trees are never updated in place (every step returns a new tree),
so an in-flight step's ``before``/``after`` trees stay valid for the
mirror and a stored prefix tree stays valid for later hits.

On a mesh (``mesh=``, serving/sharded.py) each rank's engine holds its
rows and kv heads of the batched tree; the host state (``live``,
``last_token``, the scheduler's view) is every slot's, the same on every
rank, and each rank mirrors its own rows' and heads' pages.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.analysis.contracts import tick_path
from repro_torch.configs.base import ATTN_BLOCKS, ModelConfig
from repro_torch.core.dual_cache import DualCache
from repro_torch.device import (DeviceLike, host_to_device,
                                resolve_device, torch_dtype)
from repro_torch.kernels.paged_decode import paged_decode
from repro_torch.launch.specs import (alloc_batched_caches, build_decode_caches,
                                      cache_tree_bytes, extract_slot_caches,
                                      splice_caches)
from repro_torch.models import inference as I
from repro_torch.serving import paged
from repro_torch.serving.backend import (BackendCapabilities, FusedStep,
                                         Prefix, PrefillTask)
from repro_torch.serving.obs.trace import NULL_TRACER
from repro_torch.serving.sampling import sample
from repro_torch.serving.sharded import ShardedDecodeMixin
from repro_torch.sharding import comm
from repro_torch.tree import tree_map


def _host(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


@dataclasses.dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new: int
    out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


class Engine(ShardedDecodeMixin):
    """Batched serving backend (slots = max concurrent decodes) for the
    paper's write-gated dual cache. ``device`` defaults to ``cuda``;
    ``device="cpu"`` runs the plain PyTorch path. ``mesh`` (a
    :class:`~repro_torch.launch.mesh.Mesh`, one per rank) serves on this
    rank's shard, on the mesh's device."""

    def __init__(self, params, cfg: ModelConfig, *, slots: int = 4,
                 capacity: int = 4096, opts: Optional[I.DecodeOptions] = None,
                 pool_pages: int = 4096, eos: Optional[int] = None,
                 temperature: float = 0.0, seed: int = 0,
                 mirror_paged: bool = True, device: DeviceLike = None,
                 mesh=None):
        self.slots = slots
        # an arch the mesh does not take raises here, on a mesh
        params, cfg = self._sharding_setup(params, cfg, mesh)
        if not cfg.has_attention_cache:
            raise ValueError("engine serves KV-cache archs")
        self.cfg = cfg
        self.device = resolve_device(device)
        if mesh is not None:
            if self.device.type != mesh.device.type:
                raise ValueError(f"device {self.device} is not the mesh's "
                                 f"{mesh.device}")
            self.device = mesh.device
        self.capacity = capacity
        self.opts = opts or I.DecodeOptions()
        # decode-time page selection: the base opts run the full path
        # (prefill chunks and mixed ticks see every admitted token); the
        # policy applies only on decode-only ticks (``_sel_opts``)
        self.selection = self.opts.selection_policy
        self._sel_k = I.parse_selection_policy(self.selection)
        self._sel_opts = None
        if self.selection is not None:
            self._sel_opts = self.opts
            self.opts = dataclasses.replace(self.opts, selection_policy=None)
        self.opts = self._local_opts(self.opts)
        self._sel_opts = self._local_opts(self._sel_opts)
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
        # prefix-store adoption: the CachedPrefix a row was seeded from
        # (drives the suffix-only pool mirror at finish) and whether an
        # eviction trigger fired since the row opened (eviction compacts
        # the global cache, forcing the full re-mirror)
        self._slot_prefix: List[Optional[object]] = [None] * slots
        self._slot_evicted: List[bool] = [False] * slots
        self.stats = {"steps": 0, "evict_triggers": 0.0, "decode_adm_sum": 0.0,
                      "extend_time_s": 0.0, "extend_tokens": 0.0,
                      "fused_steps": 0.0, "fused_time_s": 0.0,
                      "fused_prefill_time_s": 0.0,
                      "fused_prefill_tokens": 0.0,
                      "fused_slot_rows": 0.0, "fused_active_rows": 0.0,
                      "selected_pages": 0.0, "selection_time_s": 0.0}
        self.tracer = NULL_TRACER
        # the legacy fixed-slot loop's requests and slot owners
        self.requests: Dict[int, Request] = {}
        self.slot_rid: List[Optional[int]] = [None] * slots
        self._next_rid = 0
        # the distinct step shapes dispatched, per kind
        self._shapes: Dict[str, set] = {"extend_batch": set(),
                                        "fused_step": set(),
                                        "fused_step_sel": set()}

    # ------------------------------------------------------------------
    # EngineBackend protocol: descriptor + memory telemetry
    # ------------------------------------------------------------------
    def capabilities(self) -> BackendCapabilities:
        return BackendCapabilities(
            name="wgkv", gated=True, paged=self.mirror,
            description="write-gated dual cache (learned admission)",
            sharded=self.mesh is not None, selection=self.selection)

    # the fused tick's declared step-shape budget, the reference's: the
    # base fused step runs (slots, chunk) for prefill-carrying ticks and
    # (slots, 1) for decode-only ticks; the selection variant (slots, 1)
    # only. analysis.CompileSentinel holds a replay to it; the
    # synchronous extend ("extend_batch") takes one shape per (batch
    # width, chunk) by design and carries no budget.
    COMPILE_SHAPE_BUDGETS: Dict[str, int] = {
        "fused_step": 2,
        "fused_step_sel": 1,
    }

    def compiled_shape_counts(self) -> Dict[str, int]:
        """The distinct step shapes dispatched so far, per kind: eager
        PyTorch keeps no jit cache, so this counts what the reference's
        caches would hold, and what CUDA graphs a capture would need
        (one per shape). ``fused_step_sel`` only with a selection
        policy."""
        return {kind: len(shapes) for kind, shapes in self._shapes.items()
                if kind != "fused_step_sel" or self._sel_opts is not None}

    @tick_path
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
        return self._per_shard_snapshot(snap)

    def _attn_blocks(self) -> List[int]:
        """Indices ``i`` of the pattern's attention blocks (``"b{i}"``):
        the blocks that keep a dual cache; ``rglru`` blocks keep a
        recurrent state and have nothing to mirror."""
        return [i for i, bt in enumerate(self.cfg.block_pattern)
                if bt in ATTN_BLOCKS]

    def _dual_nodes(self, caches) -> List[Tuple[int, DualCache]]:
        """(block index, stacked DualCache) of every attention block that
        keeps one (the dense baseline's full-attention blocks keep a
        DenseCache instead)."""
        return [(i, caches["blocks"][f"b{i}"]) for i in self._attn_blocks()
                if isinstance(caches["blocks"][f"b{i}"], DualCache)]

    def _kv_tokens_device(self, caches) -> torch.Tensor:
        """[B] resident KV tokens per row on the device, without a sync:
        per attention layer, admitted global entries summed over kv heads
        plus the filled ring window per head."""
        total = torch.zeros_like(caches["t"])
        for _, dc in self._dual_nodes(caches):
            total = total + (dc.gcnt.sum(dim=(0, 2))
                             + (torch.clamp(dc.t, max=dc.w_local)
                                * dc.gcnt.shape[2]).sum(dim=0))
        return total.to(torch.int32)

    # ------------------------------------------------------------------
    # offline prefix surface: chunked batch-1 prefill + insert
    # ------------------------------------------------------------------
    @property
    def _w_align(self) -> int:
        """Prefill chunk alignment: the largest ring window in the model."""
        w = self.cfg.wgkv.w_local
        if any(bt == "local_attn"
               for bt in self.cfg.block_pattern + self.cfg.stem_pattern):
            w = max(w, self.cfg.sliding_window)
        return w

    def start_prefill(self, prompt: List[int]) -> PrefillTask:
        return PrefillTask(prompt=list(prompt))

    def _fresh_task_caches(self):
        """Batch-1 EMPTY decode-cache tree (shared: never mutated)."""
        if self._empty_tree is None:
            self._empty_tree = self._build_empty_caches()
        return self._empty_tree

    def _build_empty_caches(self):
        caches = build_decode_caches(self.cfg, 1, self.capacity,
                                     use_wgkv=True, device=self.device)
        if self.opts.evict_hard_budget is not None:
            caches["obs"] = I._init_obs_tree(self.cfg, 1, self.opts,
                                             self.device)
        return caches

    def _stack_rows(self, trees):
        out = alloc_batched_caches(trees[0], len(trees))
        for i, t in enumerate(trees):
            out = splice_caches(out, t, i)
        return out

    @tick_path
    def _extend_ragged(self, tasks: List[PrefillTask],
                       max_tokens: Optional[int]) -> None:
        """ONE batched ragged extend for every mid-prefill task: the
        synchronous path (it pulls its stats before it returns), one step
        shape per (batch width, chunk)."""
        t_wall = time.perf_counter()
        takes = [len(t.prompt) - t.pos if max_tokens is None
                 else min(len(t.prompt) - t.pos, max_tokens) for t in tasks]
        if max_tokens is None:
            q = self._w_align
            s = -(-max(takes) // q) * q
        else:
            s = max_tokens
        b = len(tasks)
        self._shapes["extend_batch"].add((b, s))
        toks = np.zeros((b, s), np.int32)
        for i, (t, take) in enumerate(zip(tasks, takes)):
            toks[i, :take] = t.prompt[t.pos:t.pos + take]
        batched = tasks[0].caches if b == 1 \
            else self._stack_rows([t.caches for t in tasks])
        with self.tracer.span("prefill_extend_ragged", batch=b, s=s,
                              tokens=int(sum(takes))), \
                comm.active(self.mesh, self.plan):
            logits, batched, st = I.prefill_extend_ragged(
                self.params, self.cfg,
                host_to_device(toks, self.device), takes, batched,
                opts=self.opts, capacity=self.capacity)
            outs = (batched,) if b == 1 \
                else [extract_slot_caches(batched, i) for i in range(b)]
            # torchlint: allow-sync(the synchronous extend pulls its stats)
            trig = _host(self._head_mean(st["evict_trigger_rows"]))
            # torchlint: allow-sync(the synchronous extend pulls its stats)
            adm = _host(self._head_mean(st["adm_sum_rows"]))
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
            self.caches = alloc_batched_caches(prefix.caches, self._n_rows)
        self.caches = self._splice(self.caches, prefix.caches, slot)
        self.live[slot] = True
        self._slot_gen[slot] += 1
        tok = prefix.first_token if prefix.first_token is not None else 0
        self.last_token[slot] = tok
        self._set_tok(slot, tok)
        self._kv_rows[slot] = float(self._head_sum(
            self._kv_tokens_device(prefix.caches))[0])
        if self.mirror and self._local_row(slot) is not None:
            self._mirror_prefill(slot, prefix.caches)

    def _set_tok(self, slot: int, tok: int) -> None:
        """Set one row of the device feed without a host->device copy."""
        rows = torch.arange(self.slots, device=self.device)
        self._tok_dev = torch.where(rows == slot, tok, self._tok_dev)

    # ------------------------------------------------------------------
    # fused megabatch tick
    # ------------------------------------------------------------------
    @tick_path
    def _fused(self, toks: np.ndarray, lengths: np.ndarray,
               use_dev: np.ndarray, caches, opts: I.DecodeOptions):
        """The fused step: ragged extend over the persistent batched tree
        with decode rows fed from the on-device sampled vector, sampling
        and per-row resident-token counts on the device too. On a mesh
        the rank runs its rows, and the tokens and stats come back for
        every slot (``_assemble_step``)."""
        rows = self._rows
        tokens = host_to_device(toks[rows], self.device)
        use = host_to_device(use_dev[rows], self.device)
        tokens[:, 0] = torch.where(use, self._tok_dev[rows], tokens[:, 0])
        # the rows entry: an MoE block's routing group (every row of the
        # tick) spans the data ranks when they split the slots
        with comm.active(self.mesh, self.plan,
                         rows="data" if self._rows_split else None):
            last_logits, caches, st = I.prefill_extend_ragged(
                self.params, self.cfg, tokens, lengths[rows], caches,
                opts=opts, capacity=self.capacity,
                steps=self._tick_steps(lengths))
        st = {**st, "kv_tokens_rows": self._kv_tokens_device(caches)}
        if self.mesh is None:
            sampled = sample(self.generator, last_logits,
                             temperature=self.temperature)
            return last_logits, caches, {**st, "sampled": sampled}
        if self.temperature > 0.0:
            # every rank draws the same tokens from the same whole batch
            sampled = sample(self.generator, self._gather_rows(last_logits),
                             temperature=self.temperature)
            _, st = self._assemble_step(None, st)
        else:
            sampled, st = self._assemble_step(
                sample(None, last_logits), st)
        return last_logits, caches, {**st, "sampled": sampled}

    @tick_path
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
                                               self._n_rows)
        for t in tasks:
            assert t.slot is not None, "fused step_batch needs slot-bound tasks"
            assert not self.live[t.slot], "prefill task in a live decode row"
            if not self._resident[t.slot]:
                if t.prefix_entry is not None:
                    # prefix hit: splice the stored (already gate-filtered)
                    # tree; the row's per-layer ``t`` makes the ragged scan
                    # resume at the suffix
                    with self.tracer.span("prefix_splice", slot=t.slot,
                                          tokens=t.prefix_entry.n_tokens):
                        self.caches = self._splice(
                            self.caches, t.prefix_entry.caches, t.slot)
                    self._adopt_prefix(t.slot, t.prefix_entry)
                else:
                    with self.tracer.span("fused_open", slot=t.slot):
                        self.caches = self._splice(
                            self.caches, self._fresh_task_caches(), t.slot)
                    self._slot_prefix[t.slot] = None
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
        self._pre_fused_dispatch(
            [(t.slot, take) for t, take in zip(tasks, takes)], decode_rows)
        self.stats["fused_slot_rows"] += float(self.slots)
        self.stats["fused_active_rows"] += float(int((lengths > 0).sum()))
        # decode-only ticks run the Quest selection variant when
        # configured; any prompt chunk aboard forces the full path
        use_sel = self._sel_opts is not None and not tasks
        self._shapes["fused_step_sel" if use_sel else "fused_step"].add(
            (self.slots, s))
        before = self.caches
        with self.tracer.device_scope("fused_step"):
            if use_sel:
                with self.tracer.span("selection", k=self._sel_k,
                                      rows=len(decode_rows)):
                    _logits, self.caches, st = self._fused(
                        toks, lengths, use_dev, before, self._sel_opts)
            else:
                _logits, self.caches, st = self._fused(
                    toks, lengths, use_dev, before, self.opts)
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
            had_prefill=bool(tasks), t_dispatch=t0, selection=use_sel)

    def _pre_fused_dispatch(self, prefill: List[Tuple[int, int]],
                            decode_rows: Tuple[int, ...]) -> None:
        """Hook before a fused dispatch (``prefill``: [(slot, take)]):
        the dense baseline guards its capacity here; the dual cache never
        overflows (the ring wraps, the global cache is budgeted)."""

    def _decode_admission(self, adm_rows: np.ndarray,
                          rows: List[int]) -> float:
        """Mean write-gate admission over the decode rows of one step."""
        return float(adm_rows[rows].mean())

    @tick_path
    def collect(self, step: FusedStep) -> Dict[int, int]:
        """Synchronize one in-flight fused step: pull its sampled tokens
        and per-row stats to the host (the one sync), fold admission
        stats, mirror finishing rows' prefixes and decode rows' deltas
        into the paged pool, and return {slot: token} for every slot
        still owned by the request the step was dispatched for."""
        assert not step.collected, "in-flight step collected twice"
        step.collected = True
        # torchlint: allow-sync(collect is the tick's one sync point)
        nxt, trig, adm, selp, kvr = (_host(x) for x in (
            step.tokens, step.stats["evict_trigger_rows"],
            step.stats["adm_sum_rows"], step.stats["selected_pages_rows"],
            step.stats["kv_tokens_rows"]))
        for sl in range(self.slots):
            if self._slot_gen[sl] == step.gen[sl]:
                self._kv_rows[sl] = float(kvr[sl])
            if trig[sl] > 0:
                self._slot_evicted[sl] = True
        wall = time.perf_counter() - step.t_dispatch
        self.stats["fused_steps"] += 1
        self.stats["fused_time_s"] += wall
        if step.had_prefill:
            self.stats["fused_prefill_time_s"] += wall
            self.stats["fused_prefill_tokens"] += float(sum(step.takes))
        if step.selection:
            self.stats["selection_time_s"] += wall
            if step.decode_rows:
                self.stats["selected_pages"] += float(
                    selp[list(step.decode_rows)].sum())
        self.stats["evict_triggers"] += float(trig.sum())
        for t, take, full in zip(step.tasks, step.takes, step.fulls):
            t.adm_weighted += self._extend_admission(adm[t.slot], take,
                                                     full=full)
        if step.decode_rows:
            self.stats["steps"] += 1
            # a decode row has exactly one real position, so its ragged
            # adm SUM is that step's per-row mean admission
            self.stats["decode_adm_sum"] += self._decode_admission(
                adm, list(step.decode_rows))
        rows = [s for s in step.decode_rows
                if self.live[s] and self._slot_gen[s] == step.gen[s]]
        if self.mirror and step.before is not None:
            for t, fin in zip(step.tasks, step.finishing):
                row = self._local_row(t.slot)
                if fin and row is not None and \
                        self._slot_gen[t.slot] == step.gen[t.slot]:
                    # a prefix-hit row already aliases the entry's pages:
                    # only its suffix is mirrored, unless an eviction
                    # compacted the global cache (then the full re-sync)
                    entry = self._slot_prefix[t.slot]
                    sc = extract_slot_caches(step.after, row)
                    if entry is not None and not self._slot_evicted[t.slot]:
                        self._mirror_prefill_suffix(t.slot, sc, entry)
                    else:
                        self._mirror_prefill(t.slot, sc)
            mine = [s for s in rows if self._local_row(s) is not None]
            if mine:
                self._mirror_decode(step.before, step.after, rows=mine,
                                    evicted_rows=trig > 0)
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
        self._slot_prefix[slot] = None
        self._slot_evicted[slot] = False
        if self.mirror and self.caches is not None:
            for lkey in self._layer_keys():
                for h in range(self.cfg.n_kv_heads):
                    # pages shared with a prefix-store entry are only
                    # dereferenced here; the entry's own refs keep them
                    self.pool.free_stream((slot, lkey, h, "global"))
                    self.pool.free_stream((slot, lkey, h, "local"))

    # ------------------------------------------------------------------
    # content-addressed prefix store hooks (serving/prefix_cache.py)
    # ------------------------------------------------------------------
    @tick_path
    def _adopt_prefix(self, slot: int, entry) -> None:
        """Host-side adoption of a stored prefix into a freshly spliced
        row: alias the entry's pool pages into the slot's streams (incref
        only; copy-on-write unshares any page either side writes later)
        and seed the host kv accounting. No device sync."""
        self._slot_prefix[slot] = entry
        self._slot_evicted[slot] = False
        self._kv_rows[slot] = float(entry.kv_tokens)
        if self.mirror:
            for skey in entry.stream_keys:
                # ("pfx", key, lkey, h, region) -> (slot, lkey, h, region)
                dst = (slot,) + skey[2:]
                self.pool.free_stream(dst)
                self.pool.share_stream(skey, dst)

    def capture_prefix(self, step: FusedStep, slot: int, key: str, *,
                       adm_weighted: float = 0.0):
        """Freeze row ``slot`` of a collected step into a
        :class:`~repro_torch.serving.prefix_cache.CachedPrefix`: the
        batch-1 tree (a copy; later steps build new trees and cannot
        disturb it), the per-layer counts the suffix mirror needs and,
        when mirroring, entry-owned pool streams holding the admitted
        bytes, ready to be aliased into a hitting slot. A host sync, run
        once per unique prefix after the collect that produced it."""
        from repro_torch.serving.prefix_cache import CachedPrefix
        caches = self._slot_tree(step.after, slot)
        meta: Dict[Tuple, Dict] = {}
        stream_keys: List[Tuple] = []
        kv_tokens = n_tokens = pool_pages = 0
        for i, node in self._dual_nodes(caches):
            gcnt, t = _host(node.gcnt), _host(node.t)
            if self.mirror:
                gk, gv, lk, lv = (_host(x) for x in (node.gk, node.gv,
                                                     node.lk, node.lv))
            for r in range(self.cfg.n_repeats):
                lkey = (r, i)
                n_tokens = int(t[r, 0])
                n_local = min(n_tokens, node.w_local)
                g = gcnt[r, 0].astype(np.int64)                  # [H]
                meta[lkey] = {"gcnt": g, "n_local": n_local}
                kv_tokens += int(g.sum()) + n_local * g.shape[0]
                if not self.mirror:
                    continue
                for h in range(self.cfg.n_kv_heads):
                    gkey = ("pfx", key, lkey, h, "global")
                    self.pool.free_stream(gkey)
                    self.pool.bulk_append(gkey, gk[r, 0, h, :g[h]],
                                          gv[r, 0, h, :g[h]])
                    lkey_ = ("pfx", key, lkey, h, "local")
                    self.pool.free_stream(lkey_)
                    self.pool.bulk_append(lkey_, lk[r, 0, h, :n_local],
                                          lv[r, 0, h, :n_local])
                    stream_keys += [gkey, lkey_]
                    pool_pages += len(self.pool.table(gkey).pages)
                    pool_pages += len(self.pool.table(lkey_).pages)
        n_bytes = cache_tree_bytes(caches) + \
            pool_pages * paged.PAGE_SIZE * self.cfg.head_dim * 2 * 4
        # on a mesh both are the model ranks' sums, the same on every
        # rank: the store's LRU decisions must be the same everywhere
        kv_tokens, n_bytes = self._head_sum_host(kv_tokens, n_bytes)
        return CachedPrefix(key=key, n_tokens=n_tokens, caches=caches,
                            adm_weighted=adm_weighted, meta=meta,
                            kv_tokens=kv_tokens, n_bytes=n_bytes,
                            stream_keys=tuple(stream_keys))

    def release_prefix(self, entry) -> None:
        """Free an evicted store entry's pool streams. Pages a live slot
        still shares survive by their refcounts."""
        if self.mirror:
            for skey in entry.stream_keys:
                self.pool.free_stream(skey)

    def _mirror_prefill_suffix(self, slot: int, caches, entry) -> None:
        """Mirror only what a prefix-hit row added past the stored
        boundary: global entries beyond the entry's per-head counts are
        appended, and only the ring slots that positions ``[n_tokens, t)``
        wrote are written (copy-on-write unshares any page the entry
        still holds)."""
        t0 = entry.n_tokens
        for i, node in self._dual_nodes(caches):
            gk, gv, lk, lv, gcnt, t = (_host(x) for x in (
                node.gk, node.gv, node.lk, node.lv, node.gcnt, node.t))
            w = node.w_local
            for r in range(self.cfg.n_repeats):
                lkey = (r, i)
                t1 = int(t[r, 0])
                len0, len1 = min(t0, w), min(t1, w)
                touched = (set(range(len1)) if t1 - t0 >= w
                           else {p % w for p in range(t0, t1)})
                grow = list(range(len0, len1))
                over = sorted(touched.difference(grow))
                gcnt0 = entry.meta[lkey]["gcnt"]
                for h in range(self.cfg.n_kv_heads):
                    c0, c1 = int(gcnt0[h]), int(gcnt[r, 0, h])
                    if c1 < c0:
                        raise RuntimeError("global cache shrank without an "
                                           "eviction trigger")
                    if c1 > c0:
                        self.pool.bulk_append(
                            (slot, lkey, h, "global"), gk[r, 0, h, c0:c1],
                            gv[r, 0, h, c0:c1])
                    ring = (slot, lkey, h, "local")
                    for j in grow:
                        self.pool.append(ring, lk[r, 0, h, j],
                                         lv[r, 0, h, j])
                    for j in over:
                        self.pool.overwrite(ring, j, lk[r, 0, h, j],
                                            lv[r, 0, h, j])

    # ------------------------------------------------------------------
    # paged-pool mirroring
    # ------------------------------------------------------------------
    def _layer_keys(self):
        """Pool layer keys ``(repeat, block index)`` of every attention
        layer."""
        return [(r, i) for i in self._attn_blocks()
                for r in range(self.cfg.n_repeats)]

    def _mirror_prefill(self, slot: int, caches) -> None:
        """Copy a batch-1 tree's logical dual caches into the physical
        pool: each head's ``gcnt`` global entries and its ``min(t, W)``
        filled ring slots (ring pages are allocated lazily until the
        wrap). One host transfer per leaf for all layers."""
        for i, node in self._dual_nodes(caches):
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
                       rows: Optional[List[int]] = None,
                       evicted_rows: Optional[np.ndarray] = None) -> None:
        """Apply one decode step's logical cache delta to the pool: the
        ring vector each row wrote at its pre-step pointer, and the
        newest global entry of each head whose ``gcnt`` grew. The needed
        vectors are gathered on the device for all layers at once, so the
        host pulls a handful of [layers, rows, heads, hd] arrays.

        ``evicted_rows`` ([slots] bool) marks rows whose step reported a
        SnapKV eviction trigger: eviction compacts and reorders the
        logical global cache, so each of that row's global streams that
        did not grow is re-synced whole (freeing the pages it no longer
        needs). A stream that grew cannot have evicted this step: eviction
        drops at least one entry and promotion adds at most one."""
        if rows is None:
            rows = [s for s in range(self.slots)
                    if self.live[s] and self._local_row(s) is not None]
        if not rows:
            return
        dev = self.device
        ridx = torch.as_tensor([self._local_row(s) for s in rows], device=dev)
        ev_rows = [s for s in rows
                   if evicted_rows is not None and bool(evicted_rows[s])]
        for (i, dcb), (_, dca) in zip(self._dual_nodes(before),
                                      self._dual_nodes(after)):
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
            full_k = full_v = None
            if ev_rows:
                eidx = torch.as_tensor([self._local_row(s) for s in ev_rows],
                                       device=dev)
                full_k, full_v = _host(dca.gk[:, eidx]), _host(dca.gv[:, eidx])
            ev_pos = {s: e for e, s in enumerate(ev_rows)}
            for r in range(n_rep):
                for j, slot in enumerate(rows):
                    p = int(ptrb[r, j])
                    e = ev_pos.get(slot)
                    for h in range(hkv):
                        cb, ca = int(gcb[r, j, h]), int(gca[r, j, h])
                        gkey = (slot, (r, i), h, "global")
                        if e is not None and ca <= cb:
                            # post-eviction re-sync (reclaims freed pages)
                            self.pool.free_stream(gkey)
                            self.pool.bulk_append(gkey, full_k[r, e, h, :ca],
                                                  full_v[r, e, h, :ca])
                        elif ca > cb:
                            # promotion: gcnt grew -> append promoted token
                            self.pool.append(gkey, prom_k[r, j, h],
                                             prom_v[r, j, h])
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
    # legacy fixed-slot loop (thin layer over prefill/insert/dispatch)
    # ------------------------------------------------------------------
    def add_request(self, prompt: List[int], max_new: int = 32) -> int:
        rid = self._next_rid
        self._next_rid += 1
        self.requests[rid] = Request(rid, list(prompt), max_new)
        return rid

    def _free_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.slot_rid) if r is None]

    def _retire_if_done(self, req: Request, slot: int, tok: int) -> None:
        if len(req.out) >= req.max_new or (self.eos is not None
                                           and tok == self.eos):
            req.done = True
            self.slot_rid[slot] = None
            self.free_slot(slot)

    def step(self) -> Dict[int, int]:
        """Admit pending requests, run one decode step, return {rid:
        newest token}. A request admitted THIS step emits both its
        prefill's first token and a decode token; the dict keeps only the
        newest, ``requests[rid].out`` holds the full record."""
        pending = [r for r in self.requests.values()
                   if not r.done and r.rid not in self.slot_rid]
        emitted: Dict[int, int] = {}
        for slot in self._free_slots():
            if not pending:
                break
            req = pending.pop(0)
            self.slot_rid[slot] = req.rid
            # the first generated token comes straight from the prefill's
            # last-position logits; insert feeds it to the batched decode
            prefix = self.prefill(req.prompt, emit_first=True)
            self.insert(prefix, slot)
            req.out.append(prefix.first_token)
            emitted[req.rid] = prefix.first_token
            self._retire_if_done(req, slot, prefix.first_token)
        inflight = self.step_batch([])
        emitted_slots = self.collect(inflight) if inflight is not None else {}
        for slot, tok in emitted_slots.items():
            rid = self.slot_rid[slot]
            if rid is None:
                continue
            req = self.requests[rid]
            req.out.append(tok)
            emitted[rid] = tok
            self._retire_if_done(req, slot, tok)
        return emitted

    def run(self, max_steps: int = 256) -> None:
        for _ in range(max_steps):
            self.step()
            if all(r.done for r in self.requests.values()):
                break

    # ------------------------------------------------------------------
    def verify_paged(self, layer_repeat: int = 0,
                     block: Optional[int] = None,
                     atol: float = 2e-3) -> float:
        """Recompute one layer's decode attention for all live slots from
        the PHYSICAL pool via the paged_decode kernel and compare with the
        logical dual-cache contents. ``block`` (default: the pattern's
        first attention block) must be an attention block. Returns max
        abs deviation (on a mesh, the largest of every rank's, each over
        its rows and kv heads)."""
        assert self.mirror and self.caches is not None
        if block is None:
            block = self._attn_blocks()[0]
        if block not in self._attn_blocks():
            raise ValueError(f"block b{block} "
                             f"({self.cfg.block_pattern[block]!r}) keeps no "
                             "dual cache to verify")
        if not any(self.live):
            return 0.0
        return self._mesh_max(self._verify_local(layer_repeat, block))

    def _verify_local(self, layer_repeat: int, block: int) -> float:
        live = [s for s in range(self.slots)
                if self.live[s] and self._local_row(s) is not None]
        if not live:
            return 0.0
        node = self.caches["blocks"][f"b{block}"]
        dc = DualCache(*(_host(x[layer_repeat]) for x in node))
        lkey = (layer_repeat, block)
        worst = 0.0
        for slot in live:
            row = self._local_row(slot)
            n_local = min(int(dc.t[row]), node.w_local)
            for h in range(self.cfg.n_kv_heads):
                gk, _ = self.pool.gather((slot, lkey, h, "global"))
                cnt = int(dc.gcnt[row, h])
                logical = np.asarray(dc.gk[row, h, :cnt], np.float32)
                if cnt:
                    worst = max(worst, float(np.abs(gk[:cnt] - logical).max()))
                lk, _ = self.pool.gather((slot, lkey, h, "local"))
                # ring pages are allocated lazily: the stream holds exactly
                # the min(t, W) slots written so far
                assert lk.shape[0] == n_local, (lk.shape, n_local)
                if n_local:
                    worst = max(worst, float(np.abs(
                        lk - np.asarray(dc.lk[row, h, :n_local],
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
                row = self._local_row(s)
                for h in range(self.cfg.n_kv_heads):
                    cnt = int(dc.gcnt[row, h])
                    if cnt:
                        kk = np.asarray(dc.gk[row, h, :cnt], np.float32)
                        vv = np.asarray(dc.gv[row, h, :cnt], np.float32)
                        lg = (np.ones(hd) / hd) @ kk.T / np.sqrt(hd)
                        w = np.exp(lg - lg.max())
                        w /= w.sum()
                        oracle = w @ vv
                        worst = max(worst, float(np.abs(out[i] - oracle).max()))
                    i += 1
        return worst
