"""EngineBackend: the backend-agnostic serving protocol (port of
``repro/serving/backend.py``; the port implements the ``wgkv`` backend
only, without decode selection or the prefix store).

The orchestrator (serving/orchestrator/) schedules *any* accelerator
backend that exposes the JetStream-style prefill/insert/generate
decomposition; the concrete cache policy — write-gated dual cache, dense
full KV, static StreamingLLM/DuoAttention admission — is a backend
implementation detail. The paper's headline numbers (memory reduction,
decode speedup) are comparative, so serving the baselines under the SAME
scheduler/queue/telemetry stack is what makes an apples-to-apples A/B
possible (``benchmarks/bench_serving.py --backends wgkv,dense``).

Protocol surface (one request = one chunked prefill + one decode slot):

  * ``start_prefill(prompt) -> PrefillTask`` — open a chunked prefill.
  * ``step_batch(tasks, max_tokens, decode=True) -> FusedStep | None`` —
    THE fused megabatch tick: ONE jitted ragged device call advances
    every live row of the persistent batched cache tree, whatever its
    phase. A first-chunk row is spliced in as an EMPTY row (per-row
    ``t`` offsets make the ragged scan start it from position 0 — no
    separately-compiled batch-1 open), a mid-prefill row takes its next
    prompt chunk, a live decode row piggybacks as a length-1 ragged row
    fed from the on-device sampled-token vector, and a dead row is
    length-0 padding whose state is kept bit-identical by per-leaf
    masked writes. Sampling runs inside the same jitted call; the
    result is an uncollected :class:`FusedStep`. A task-less
    ``step_batch([])`` is the decode-only dispatch — and, when the
    backend was built with a ``selection`` policy (``"quest:K"``), the
    tick where gathered top-K page selection applies: decode rows
    attend over only the K highest-scoring global pages for the live
    query, scored from incremental per-page key min/max metadata
    (core/selection.py). Mixed ticks always run the full path.
    (The unfused ``prefill_step_batch`` / ``dispatch_decode`` split
    drivers served their deprecation cycle and are gone — every backend
    runs the fused tick.)
  * ``finish_prefill(task, emit_first=True) -> Prefix`` — seal the task;
    with ``emit_first`` the first generated token is sampled from the
    prefill's own last-position logits (no extra decode step, no
    duplicate KV write — JetStream semantics: TTFT ends at prefill).
    Fused-path tasks never reach it: their first token comes out of
    ``collect`` on the step whose chunk completed the prompt.
  * ``insert(prefix, slot)`` — splice the batch-1 caches into decode row
    ``slot`` of the batched state (unfused path only; fused-path rows
    are already resident).
  * ``free_slot(slot)`` — retire a slot and release its physical memory.
  * ``capabilities() -> BackendCapabilities`` — static descriptor
    (gated? physically paged? fused?) the orchestrator/telemetry key off.
  * ``memory_snapshot() -> dict`` — point-in-time memory telemetry
    (resident KV tokens/bytes, paged-pool pages/utilization when paged).

Decode is a TWO-PHASE surface so host work never blocks the device:

  * ``step_batch(...) -> FusedStep | None`` — enqueue one jitted
    batched step WITHOUT synchronizing. The sampled next-token vector
    stays on device and becomes the feed of the next dispatch, so the
    driver may dispatch step t+1 before step t's result has ever
    touched the host (dispatch-ahead depth >= 1). Returns None when
    nothing can advance.
  * ``collect(step) -> {slot: token}`` — the sync point: pull the
    sampled tokens to host, fold eviction/admission stats into
    ``stats``, and apply the step's cache delta to the paged mirror.
    Host-side mirroring and bookkeeping for step t therefore overlap
    device compute for step t+1. A slot whose request was freed (or
    re-inserted) between dispatch and collect is skipped — its token is
    discarded and its pool streams are left exactly as ``free_slot`` /
    ``insert`` put them (per-slot generation counters guard the race).
    For a :class:`FusedStep` the token map also carries FIRST tokens of
    rows whose prompt completed in that step (``step.finishing``).

(The ``generate()`` synchronous shim — ``collect(dispatch_decode())`` —
served its one deprecation cycle and is gone; single-step callers run
the two-phase surface directly.)

Fused lifecycle (default; slots are rows of ONE persistent batched tree)::

    submit ──> start_prefill (slot reserved; row spliced empty on the
              │                first step_batch that includes the task)
              v
        step_batch(tasks, chunk) ──> [device: ONE fused ragged step]
              │   prefill rows: next chunk   decode rows: length-1
              │   dead rows: length-0 (bit-identical padding)
              ├──> step_batch(...)  [device: step t+1, dispatch-ahead]
              v
        collect(step t) ── {slot: token} (decode tokens + first tokens
              │                           of rows finishing prompt)
              v
        free_slot(slot)          (finished / cancelled)

(The unfused lifecycle — ``prefill_step_batch`` chunk loops feeding
``finish_prefill``/``insert``, plus ``dispatch_decode`` — served its
deprecation cycle and is gone. ``prefill``/``finish_prefill``/``insert``
remain as the offline prefix surface: build a batch-1 prefix eagerly and
splice it into a decode row.)

Concrete implementations in the port:
  serving/engine.py           Engine                (wgkv — paper system)
The reference's dense and static-admission baselines, its mesh-sharded
path and its prefix-store hooks (``capture_prefix`` / ``release_prefix``)
are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import (Any, Dict, List, Optional, Protocol, Tuple,
                    runtime_checkable)


@dataclasses.dataclass
class Prefix:
    """Result of a (possibly chunked) batch-1 prefill, ready to `insert`."""
    caches: Any                        # batch-1 cache tree
    prompt_len: int
    mean_admission: float              # token-weighted write-gate admission
    first_token: Optional[int] = None  # emitted iff finish_prefill(emit_first)
    first_logits: Optional[Any] = None  # [V] logits behind first_token


@dataclasses.dataclass
class PrefillTask:
    """Incremental chunked-prefill state (one request).

    Unfused path: ``caches`` is the task's own batch-1 tree. Fused path:
    the task's state lives as row ``slot`` of the engine's persistent
    batched tree (``caches`` stays None; ``done`` keys off ``slot``)."""
    prompt: List[int]
    pos: int = 0                       # prompt tokens already in the cache
    caches: Any = None
    adm_weighted: float = 0.0          # sum(admission * tokens) so far
    # [1, V] device logits of the newest prefilled position; once the task
    # is done these are the first-token logits (finish_prefill samples
    # them directly instead of re-feeding prompt[-1] through decode_step)
    last_logits: Any = None
    # fused path: the decode row this task is resident in (set by the
    # scheduler at admit; step_batch requires it)
    slot: Optional[int] = None
    # prefix-cache hit (serving/prefix_cache.py CachedPrefix), adopted at
    # admit: the engine splices the entry's cached tree instead of the
    # empty template on this task's first fused dispatch, so the ragged
    # scan resumes at the suffix (``pos`` starts at ``entry.n_tokens``).
    # The orchestrator releases the store reference after that dispatch.
    prefix_entry: Any = None
    # miss path: (n_tokens, chain_key) boundary the orchestrator wants
    # captured once ``pos`` reaches it (consumed at dispatch registration)
    capture_plan: Optional[Tuple[int, str]] = None

    @property
    def done(self) -> bool:
        opened = self.caches is not None or self.slot is not None
        return opened and self.pos >= len(self.prompt)


@dataclasses.dataclass
class InflightStep:
    """One dispatched-but-uncollected batched decode step.

    Every field except the two snapshots is a DEVICE value — holding the
    step does not synchronize. ``live``/``gen`` freeze which request
    owned each slot at dispatch time so ``collect`` can discard tokens
    for slots that were freed or re-inserted while the step was in
    flight."""
    tokens: Any                 # [slots] int32 on device: sampled next tokens
    stats: Any                  # device stats tree from decode_step
    before: Any                 # cache tree before the step (mirror delta)
    after: Any                  # cache tree after the step
    live: Tuple[bool, ...]      # live mask snapshot at dispatch
    gen: Tuple[int, ...]        # per-slot generation snapshot at dispatch
    collected: bool = False


@dataclasses.dataclass
class FusedStep(InflightStep):
    """One dispatched-but-uncollected FUSED megabatch step.

    Extends :class:`InflightStep` with the per-row role bookkeeping of a
    fused tick: which rows took prompt chunks (and whether that chunk
    completed the prompt), which rows decoded, and which were length-0
    padding. ``tokens`` holds the on-device sampled vector — the next
    token for decode rows AND the first generated token for finishing
    prefill rows (their last-real-position logits are the prompt's final
    logits, so sampling them inside the fused call IS JetStream's
    emit-first semantics with zero extra device work)."""
    tasks: Tuple[PrefillTask, ...] = ()   # prefill rows advanced this step
    takes: Tuple[int, ...] = ()           # prompt tokens each task consumed
    fulls: Tuple[bool, ...] = ()          # task chunk == full chunk width?
    finishing: Tuple[bool, ...] = ()      # task's prompt completed this step?
    decode_rows: Tuple[int, ...] = ()     # rows that decoded (length-1)
    had_prefill: bool = False
    t_dispatch: float = 0.0               # host wall clock at dispatch
    # this step ran the gathered top-K page-selection variant (decode-only
    # dispatch on a selection-configured backend)
    selection: bool = False


@dataclasses.dataclass(frozen=True)
class BackendCapabilities:
    """Static backend descriptor consumed by orchestrator/telemetry/bench."""
    name: str            # registry name ("wgkv", "dense", "streaming_llm", ...)
    gated: bool          # admission < 1.0 expected (learned or static gates)
    paged: bool          # mirrors into a physical paged pool (verify_paged)
    description: str = ""
    # decode/extend run SPMD over a data x model device mesh (slots batch
    # over "data", KV heads over "model"; serving/sharded.py)
    sharded: bool = False
    # active decode-time page-selection policy ("quest:K"), None = full
    # attention on every decode row
    selection: Optional[str] = None


@runtime_checkable
class EngineBackend(Protocol):
    """What the orchestrator requires of a serving backend."""

    slots: int
    eos: Optional[int]
    live: List[bool]
    stats: Dict[str, float]
    # observability handle (repro_torch.serving.obs.trace.Tracer). Backends
    # default it to NULL_TRACER; the Orchestrator overwrites it with its
    # own tracer at construction so engine-side sub-phase spans
    # (fused_open / prefill_extend_ragged / decode dispatch) land on
    # the same timeline as the scheduler's tick phases.
    tracer: Any

    def capabilities(self) -> BackendCapabilities: ...

    def start_prefill(self, prompt: List[int]) -> PrefillTask: ...

    # fused megabatch tick: one jitted ragged call advancing prefill
    # chunks + piggybacked decode rows; collect() accepts the returned
    # FusedStep. step_batch([]) is the decode-only dispatch (and where
    # gathered top-K page selection applies when configured).
    def step_batch(self, tasks: List[PrefillTask],
                   max_tokens: Optional[int] = None, *,
                   decode: bool = True) -> Optional[FusedStep]: ...

    def finish_prefill(self, task: PrefillTask, *,
                       emit_first: bool = True) -> Prefix: ...

    def insert(self, prefix: Prefix, slot: int) -> None: ...

    def collect(self, step: FusedStep) -> Dict[int, int]: ...

    def free_slot(self, slot: int) -> None: ...

    def memory_snapshot(self) -> Dict[str, float]: ...


# ==========================================================================
# registry: name -> backend factory (lazy imports; no concrete backend is
# imported until requested, so orchestrator code stays protocol-only)
# ==========================================================================
BACKEND_NAMES: Tuple[str, ...] = ("wgkv", "dense", "streaming_llm", "duo")


def make_backend(name: str, params, cfg, **kw) -> EngineBackend:
    """Construct a registered backend by name.

    Keyword args: ``slots``, ``capacity``, ``opts``, ``eos``,
    ``temperature``, ``seed``, ``pool_pages``, ``mirror_paged`` and
    ``device`` (default ``cuda``; ``"cpu"`` runs the plain PyTorch path).
    Only ``"wgkv"`` is ported; the dense and static-admission baselines,
    decode selection and meshes raise :class:`NotImplementedError`.
    """
    for opt in ("selection", "mesh"):
        if kw.pop(opt, None) is not None:
            raise NotImplementedError(f"make_backend({opt}=...) is not "
                                      "ported to repro_torch yet")
    if name == "wgkv":
        from repro_torch.serving.engine import Engine
        return Engine(params, cfg, **kw)
    if name in BACKEND_NAMES:
        raise NotImplementedError(f"backend {name!r} is not ported to "
                                  "repro_torch yet; only 'wgkv' is")
    raise ValueError(f"unknown backend {name!r}; known: {BACKEND_NAMES}")
