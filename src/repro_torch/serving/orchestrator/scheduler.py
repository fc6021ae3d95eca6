"""Scheduler + Orchestrator: continuous batching over any EngineBackend.

The orchestrator depends only on the :class:`EngineBackend` protocol
(serving/backend.py) — never on a concrete engine — so the same scheduler,
queue, streams, and telemetry serve the WG-KV dual cache, the dense
full-KV baseline, and the static-admission baselines interchangeably
(pick one with ``repro_torch.serving.backend.make_backend``).

Every tick runs the FUSED megabatch step: ONE ``step_batch`` call — a
single jitted ragged device call advancing every live row of the
engine's persistent batched cache tree, whatever its phase: first-chunk
opens (spliced in empty, scanned from position 0), mid-prefill chunk
extends, and piggybacked length-1 decode rows, with sampling inside the
same call. A row whose prompt completes delivers its FIRST token at that
step's collect (state prefill -> decode with no separate
finish_prefill/insert — the row is already resident and live), and
dispatch-ahead keeps fused steps in flight exactly like decode steps.
(The unfused phase-per-phase tick and its ``fused_step`` /
``batched_prefill`` toggles served their deprecation cycle and are
gone.) On a selection-configured backend (``make_backend(...,
selection="quest:K")``) the decode-only top-up dispatches run gathered
top-K page selection; ticks carrying prompt chunks stay on the full
path.

Each tick interleaves three kinds of work:

  1. **admit** — pop arrival-ordered requests from the queue into free
     slots (a slot is reserved while its prefill is in flight), after
     cancelling any request whose deadline has passed;
  2. **fused dispatch** — ONE ``step_batch`` call advances every live
     row (chunks capped at ``chunk_tokens`` per task, Sarathi-style
     piggybacked chunking, so a long prompt never blocks decode for
     more than a chunk); with ``dispatch_ahead >= 1``, extra
     decode-only steps top the in-flight window up WITHOUT
     synchronizing (the on-device sampled-token feed lets step t+1
     queue behind step t — JetStream's driver-thread overlap without
     threads);
  3. **collect** — synchronize the OLDEST in-flight step (host
     mirroring, sampling pull, stats) and stream one token per live
     request; finished requests free their slot and paged-pool pages on
     the spot so the next arrival can join. With ``dispatch_ahead=0``
     the step dispatched this tick is collected this tick.

The Scheduler is the pure policy (how many to admit, how many prefill
tasks to advance, whether to decode); the Orchestrator executes the plan
against the engine, streams, and telemetry. :class:`ServeSession`
(session.py) is the public client surface over this loop.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable, Deque, Dict, List, Optional

from repro_torch.serving.backend import EngineBackend, FusedStep
from repro_torch.serving.obs.trace import (CAT_ENGINE, CAT_REQUEST, LANE_REQ,
                                     LANE_TICK, NULL_TRACER, Tracer)
from repro_torch.serving.orchestrator.queue import (InvalidRequest, QueueFull,
                                              RequestQueue, ServeRequest)
from repro_torch.serving.orchestrator.stream import OnToken, StreamMux
from repro_torch.serving.orchestrator.telemetry import Telemetry
from repro_torch.sharding import comm

# engine-side stat counters mirrored into telemetry as deltas relative to
# the orchestrator's birth (engines are reusable across replays):
# eviction/admission plus the prefill sub-phase counters (extend_* for
# the coalesced ragged advances of the offline prefill wrapper)
_ENGINE_STAT_KEYS = ("evict_triggers", "decode_adm_sum",
                     "extend_time_s", "extend_tokens",
                     # fused megabatch ticks: dispatch->collect wall and
                     # the prefill-stage share (the compile-free
                     # prefill tokens/s numerator bench_serving reports)
                     "fused_steps", "fused_time_s",
                     "fused_prefill_time_s", "fused_prefill_tokens",
                     # fixed-shape padding accounting (active vs padded
                     # rows per fused dispatch -> fused_padding_frac)
                     "fused_slot_rows", "fused_active_rows",
                     # decode-time page selection (gathered top-K ticks)
                     "selected_pages", "selection_time_s")


class _Phase:
    """Times one tick phase against the orchestrator's clock, folding the
    duration into a telemetry counter AND emitting an engine-lane tracer
    span. With the default :data:`NULL_TRACER` the span add is a no-op
    branch, so always-on phase accounting costs two clock reads."""
    __slots__ = ("orch", "name", "counter", "args", "t0")

    def __init__(self, orch: "Orchestrator", name: str, counter: str,
                 args: Optional[Dict]):
        self.orch = orch
        self.name = name
        self.counter = counter
        self.args = args

    def __enter__(self) -> "_Phase":
        self.t0 = self.orch.clock()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = self.orch.clock()
        self.orch.telemetry.bump(self.counter, t1 - self.t0)
        self.orch.tracer.add(self.name, self.t0, t1, cat=CAT_ENGINE,
                             lane=(LANE_TICK, 0), args=self.args)
        return False


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    chunk_tokens: int = 64        # prefill tokens per task per tick
    # prefill tasks advanced per tick — in ONE batched ragged device call
    # when the backend supports it. None = every in-flight prefill, every
    # tick (bounded by the slot count, since each task holds a reserved
    # slot); set a cap to bound the batched call's latency on deep models.
    # (Replaces the retired ``prefill_concurrency`` knob, whose "how many
    # separate batch-1 calls per tick" semantics the batched path made
    # vacuous. The ``batched_prefill`` / ``fused_step`` fallback toggles
    # served their deprecation cycle and are gone — every tick is ONE
    # fused jitted ragged step_batch call.)
    max_prefill_batch: Optional[int] = None
    decode_while_prefill: bool = True  # decode between prefill chunks
    # decode steps kept in flight on the device (two-phase
    # dispatch/collect; backend.py). 0 = one synchronous dispatch+collect
    # per tick (the pre-async behavior, the parity/regression baseline);
    # >= 1 dispatches step t+1 before step t's result touches the host,
    # so per-tick host work (paged-pool mirroring, sampling pulls,
    # chunked prefill) overlaps device compute.
    dispatch_ahead: int = 0
    # ticks between backend memory_snapshot() samples. Snapshots sync a few
    # small device counters per layer to host; the default samples every
    # tick so kv/pool peaks are exact (the A/B memory axis). Raise it to
    # lighten the tick loop on deep models — at the cost of possibly
    # missing a short-lived peak between samples. (Sampling waits on the
    # newest dispatched step, so under dispatch_ahead it runs at the top
    # of the tick, before new work is enqueued behind the in-flight step.)
    memory_sample_every: int = 1

    def __post_init__(self):
        if self.chunk_tokens < 1:
            raise ValueError(f"chunk_tokens must be >= 1, got {self.chunk_tokens}")
        if self.max_prefill_batch is not None and self.max_prefill_batch < 1:
            raise ValueError("max_prefill_batch must be >= 1 or None")
        if self.dispatch_ahead < 0:
            raise ValueError("dispatch_ahead must be >= 0")
        if self.memory_sample_every < 1:
            raise ValueError("memory_sample_every must be >= 1")


@dataclasses.dataclass(frozen=True)
class Plan:
    admit: int            # queued requests to move into reserved slots
    advance_prefills: int  # in-flight prefill tasks to advance one chunk
    decode: bool          # run one batched decode step


class Scheduler:
    """Pure per-tick scheduling policy."""

    def __init__(self, cfg: SchedulerConfig = SchedulerConfig()):
        self.cfg = cfg

    def plan(self, *, free_slots: int, queue_depth: int,
             active_prefills: int, live_decodes: int) -> Plan:
        admit = min(free_slots, queue_depth)
        advance = active_prefills + admit
        if self.cfg.max_prefill_batch is not None:
            advance = min(advance, self.cfg.max_prefill_batch)
        decode = live_decodes > 0 and (
            self.cfg.decode_while_prefill or (active_prefills + admit) == 0)
        return Plan(admit=admit, advance_prefills=advance, decode=decode)


class Orchestrator:
    """Continuous-batching serving loop over any EngineBackend."""

    def __init__(self, engine: EngineBackend, *,
                 sched: SchedulerConfig = SchedulerConfig(),
                 max_pending: Optional[int] = None,
                 clock: Callable[[], float] = time.monotonic,
                 tracer: Optional[Tracer] = None,
                 metrics_interval_s: Optional[float] = None,
                 on_metrics: Callable[[str], None] = print,
                 prefix_cache=None):
        self.engine = engine
        # content-addressed prefix store (serving/prefix_cache.py): cache
        # state is only capturable/resumable at chunk boundaries, so the
        # store's hash quantum must BE the scheduler chunk
        self.prefix_cache = prefix_cache
        if prefix_cache is not None and \
                prefix_cache.quantum != sched.chunk_tokens:
            raise ValueError(
                f"prefix_cache.quantum={prefix_cache.quantum} must equal "
                f"sched.chunk_tokens={sched.chunk_tokens}: prefixes are "
                "only capturable/resumable at chunk boundaries")
        # id(step) -> [(req, task, n_tokens, key)] capture obligations
        # that mature when that in-flight step is collected
        self._captures: Dict[int, List] = {}
        self.scheduler = Scheduler(sched)
        self.clock = clock
        # observability: the tracer records request-lifecycle and
        # tick-phase spans (NULL_TRACER = disabled, branch-cheap); the
        # engine gets the same handle so its fused_open/extend_ragged
        # sub-phases land on the same timeline
        self.tracer = tracer if tracer is not None else NULL_TRACER
        engine.tracer = self.tracer
        self._metrics_interval = metrics_interval_s
        self._on_metrics = on_metrics
        self.queue = RequestQueue(max_pending, clock)
        self.mux = StreamMux(clock)
        self.telemetry = Telemetry(clock)
        self.slot_req: List[Optional[ServeRequest]] = [None] * engine.slots
        # rid -> (request, prefill task), in admission order
        self._prefills: Dict[int, "tuple[ServeRequest, PrefillTask]"] = {}
        # dispatched-but-uncollected fused steps, oldest first
        self._inflight: Deque[FusedStep] = collections.deque()
        # requests with a live deadline (rid -> request): the per-tick
        # expiry check stays O(active deadlines), not O(every request
        # ever submitted to this long-lived session)
        self._deadlined: Dict[int, ServeRequest] = {}
        # engines are reusable (e.g. benchmark warmup); report stat deltas
        # relative to this orchestrator's birth, not engine lifetime totals
        self._stats0 = dict(engine.stats)

    # ------------------------------------------------------------------
    def submit(self, prompt: List[int], max_new: int = 32,
               on_token: Optional[OnToken] = None,
               deadline_s: Optional[float] = None) -> int:
        """Enqueue a request and open its token stream. Raises the typed
        :class:`QueueFull` under backpressure (request not enqueued;
        retry after draining) and :class:`InvalidRequest` for requests
        that can never be served. With ``deadline_s`` the request is
        cancelled — mid-stream if need be — once that many seconds have
        passed since arrival."""
        try:
            rid = self.queue.submit(prompt, max_new, deadline_s=deadline_s)
        except QueueFull:
            # keep shed-load telemetry fresh even if no tick follows
            self.telemetry.counters["rejected"] = float(self.queue.rejected)
            raise
        req = self.queue.requests[rid]
        if req.deadline_t is not None:
            self._deadlined[rid] = req
        self.mux.open(rid, req.arrival_t, on_token)
        return rid

    def _free_slots(self) -> List[int]:
        return [s for s, r in enumerate(self.slot_req) if r is None]

    # ------------------------------------------------------------------
    # cancellation (explicit via ServeSession.cancel, or deadline expiry)
    # ------------------------------------------------------------------
    def cancel(self, rid: int, *, reason: str = "cancelled") -> bool:
        """Cancel a request at any lifecycle stage: drop it from the
        pending queue, abandon its in-flight prefill, or — mid-stream —
        free its decode slot and reclaim its paged-pool pages on the
        spot. The engine's per-slot generation guard discards any token
        an already-dispatched step produces for the freed row, so
        surviving requests' streams are untouched. Returns False when the
        request is unknown or already finished."""
        req = self.queue.requests.get(rid)
        if req is None or req.state in ("done", "cancelled"):
            return False
        was = req.state
        if req.state == "queued":
            self.queue.remove(rid)
        elif req.state == "prefill":
            # drop the task and release the reservation; under the fused
            # tick the task's state is RESIDENT in the engine's batched
            # tree (and may already be live if its last chunk was
            # dispatched), so the row must be freed too — the per-slot
            # generation guard discards anything in-flight steps still
            # produce for it
            ent = self._prefills.pop(rid, None)
            if (ent is not None and self.prefix_cache is not None
                    and ent[1].prefix_entry is not None):
                # admitted on a prefix hit but cancelled before its first
                # dispatch spliced the entry in: drop the store pin so a
                # pending eviction can reclaim the entry
                self.prefix_cache.release(ent[1].prefix_entry)
                ent[1].prefix_entry = None
            with self._phase("evict", counter="evict_time_s",
                             slot=req.slot, rid=rid):
                self.engine.free_slot(req.slot)
            self.slot_req[req.slot] = None
        elif req.state == "decode":
            with self._phase("evict", counter="evict_time_s",
                             slot=req.slot, rid=rid):
                self.engine.free_slot(req.slot)
            self.slot_req[req.slot] = None
        req.state = "cancelled"
        req.finish_t = self.clock()
        self._close_request_spans(req)
        self.tracer.instant(reason, cat=CAT_REQUEST, lane=(LANE_REQ, rid),
                            rid=rid, was=was)
        self.mux.close(rid, cancelled=True)
        self.telemetry.bump("cancelled")
        if reason == "deadline":
            self.telemetry.bump("deadline_expired")
        return True

    # ------------------------------------------------------------------
    # observability helpers (tick phases + request-lane spans)
    # ------------------------------------------------------------------
    def _phase(self, name: str, *, counter: Optional[str] = None,
               **args) -> _Phase:
        """Engine-lane phase timer: accumulates into the telemetry
        counter (default ``<name>_time_s``) and traces a span."""
        return _Phase(self, name, counter or f"{name}_time_s",
                      args or None)

    def _close_request_spans(self, req: ServeRequest) -> None:
        """Emit the request's terminal lifecycle span: the decode phase
        runs from insert to finish/cancel (prefill/queued spans were
        emitted at their own transitions)."""
        if req.insert_t is not None and req.finish_t is not None:
            self.tracer.add("decode", req.insert_t, req.finish_t,
                            cat=CAT_REQUEST, lane=(LANE_REQ, req.rid),
                            args={"rid": req.rid, "slot": req.slot,
                                  "n_out": len(req.out)})

    def _dispatch_is_useful(self) -> bool:
        """True while some decoding request still wants a token beyond
        the steps already in flight. Each in-flight step yields at most
        one token per live row, so once ``len(_inflight)`` covers every
        live request's remaining ``max_new`` budget, a further dispatch
        can only produce discarded tokens. (EOS can still finish a
        request earlier — that waste is bounded by the window depth and
        unknowable in advance.)"""
        ahead = len(self._inflight)

        def wants_more(req) -> bool:
            if req is None:
                return False
            if req.state == "decode":
                return req.max_new - len(req.out) > ahead
            # fused path: a request whose last chunk was dispatched is
            # live and decoding, but stays state=="prefill" until its
            # first token is collected
            if req.state == "prefill" and req.rid in self._prefills:
                task = self._prefills[req.rid][1]
                return task.done and req.max_new - len(req.out) > ahead
            return False

        return any(wants_more(req) for req in self.slot_req)

    def _expire_deadlines(self) -> None:
        if not self._deadlined:
            return
        now = self.clock()
        expired = []
        for rid, req in list(self._deadlined.items()):
            if req.state in ("done", "cancelled"):
                del self._deadlined[rid]
            elif now > req.deadline_t:
                expired.append(rid)
        mesh = getattr(self.engine, "mesh", None)
        if mesh is not None and self._deadlined:
            # each rank reads its own clock: rank 0 decides for all, or
            # the ranks' collectives would part ways
            expired = comm.bcast_from_root(expired, mesh)
        for rid in expired:
            self.cancel(rid, reason="deadline")
            self._deadlined.pop(rid, None)

    # ------------------------------------------------------------------
    # content-addressed prefix cache (serving/prefix_cache.py): hit at
    # admission -> splice-and-resume; capture at the collect of the step
    # whose row position lands on the target chunk boundary
    # ------------------------------------------------------------------
    def _prefix_admit(self, req: ServeRequest, task) -> None:
        """Try the store at admission: on a hit the task starts at the
        entry's boundary (step_batch splices the cached tree instead of
        an empty one — the fused scan resumes at the suffix); on a miss
        (or a shorter-than-ideal hit) plan a capture at the longest
        unstored aligned boundary of this prompt."""
        pc = self.prefix_cache
        entry = pc.lookup(req.prompt)
        if entry is not None:
            task.prefix_entry = entry
            task.pos = entry.n_tokens
            task.adm_weighted = entry.adm_weighted
            req.prefix_hit = True
            req.prefix_tokens = entry.n_tokens
            self.telemetry.bump("prefix_hit")
            self.tracer.instant("prefix_hit", cat=CAT_REQUEST,
                                lane=(LANE_REQ, req.rid), rid=req.rid,
                                tokens=entry.n_tokens, key=entry.key)
        else:
            self.telemetry.bump("prefix_miss")
        plan = pc.capture_target(req.prompt)
        if plan is not None and (entry is None or plan[0] > entry.n_tokens):
            task.capture_plan = plan

    def _prefix_after_dispatch(self, step, pairs) -> None:
        """Post-dispatch bookkeeping for the tasks just advanced: drop
        admission pins (the splice copied the entry's device tree into
        the slot row and the pool mirror is shared by COW refcount, so
        the slot no longer depends on the entry) and register capture
        obligations against the step whose ``after`` tree holds the row
        at exactly the target boundary."""
        if step is None:
            return
        pc = self.prefix_cache
        for req, task in pairs:
            if task.prefix_entry is not None:
                pc.release(task.prefix_entry)
                task.prefix_entry = None
            if task.capture_plan is not None:
                n, key = task.capture_plan
                if task.pos == n:
                    self._captures.setdefault(id(step), []).append(
                        (req, task, n, key))
                if task.pos >= n:
                    task.capture_plan = None

    def _run_captures(self, step) -> None:
        """Mature this collected step's capture obligations: snapshot the
        slot's post-admission cache state (``capture_prefix`` is a
        sanctioned host sync, like the collect that just ran) and insert
        it into the store. FIFO collect means the task's ``adm_weighted``
        covers exactly the captured prefix here."""
        jobs = self._captures.pop(id(step), None)
        if not jobs:
            return
        pc = self.prefix_cache
        for req, task, n, key in jobs:
            if self._prefills.get(req.rid, (None, None))[1] is not task:
                continue   # cancelled while the step was in flight
            if key in pc:
                continue   # another request already captured this prefix
            with self._phase("prefix_capture",
                             counter="prefix_capture_time_s",
                             rid=req.rid, slot=task.slot, tokens=n):
                entry = self.engine.capture_prefix(
                    step, task.slot, key, adm_weighted=task.adm_weighted)
            pc.insert(entry)
            self.tracer.instant("prefix_capture", cat=CAT_REQUEST,
                                lane=(LANE_REQ, req.rid), rid=req.rid,
                                tokens=n)
        self.telemetry.counters["prefix_evict"] = float(pc.evictions)
        self.telemetry.counters["prefix_bytes"] = float(pc.bytes_used)

    # ------------------------------------------------------------------
    def tick(self) -> bool:
        """One scheduling round; returns True if any work was done."""
        self.telemetry.start()
        self.telemetry.bump("ticks")
        tick_no = int(self.telemetry.counters["ticks"])
        t_tick0 = self.clock()
        self._expire_deadlines()
        depth = self.scheduler.cfg.dispatch_ahead
        # sample BEFORE dispatching: the snapshot syncs small per-layer
        # counters, so taken later it would wait on the step dispatched
        # this tick and forfeit the overlap dispatch-ahead buys
        if (tick_no - 1) % self.scheduler.cfg.memory_sample_every == 0:
            with self._phase("memory_sample", tick=tick_no):
                self.telemetry.sample_memory(self.engine.memory_snapshot())
        plan = self.scheduler.plan(
            free_slots=len(self._free_slots()),
            queue_depth=self.queue.depth,
            active_prefills=len(self._prefills),
            live_decodes=sum(self.engine.live))
        worked = False

        # 1) admit: queued request -> reserved slot + prefill task
        if plan.admit:
            with self._phase("admit", tick=tick_no, n=plan.admit):
                for _ in range(plan.admit):
                    req = self.queue.pop()
                    if req is None:
                        break
                    slot = self._free_slots()[0]
                    req.slot, req.state = slot, "prefill"
                    now = self.clock()
                    req.admit_t = now
                    # request-lane lifecycle: the queued wait ends here
                    self.tracer.add("queued", req.arrival_t, now,
                                    cat=CAT_REQUEST,
                                    lane=(LANE_REQ, req.rid),
                                    args={"rid": req.rid, "slot": slot,
                                          "prompt_len": len(req.prompt)})
                    self.slot_req[slot] = req
                    task = self.engine.start_prefill(req.prompt)
                    # fused path: the task's row IS the reserved slot
                    # (spliced in empty on its first step_batch)
                    task.slot = slot
                    if self.prefix_cache is not None:
                        self._prefix_admit(req, task)
                    self._prefills[req.rid] = (req, task)
                    worked = True

        # 2) fused dispatch: ONE jitted ragged device call advances every
        # live row — first-chunk opens, mid-prefill extends, and
        # piggybacked decode rows together. The step is dispatched
        # WITHOUT synchronizing and joins the in-flight window; extra
        # decode-only fused steps (where gathered top-K page selection
        # applies, when configured) top the window up to depth + 1. A
        # step is only dispatched while some live request's remaining
        # max_new budget exceeds the tokens already in flight — past
        # that the step is provably wasted.
        adv = list(self._prefills)[:plan.advance_prefills]
        pairs = [self._prefills[rid] for rid in adv]
        tasks = [task for _, task in pairs]
        pos0 = [task.pos for task in tasks]
        chunk = self.scheduler.cfg.chunk_tokens
        with self._phase("fused_step", counter="dispatch_time_s",
                         tick=tick_no, batch=len(tasks),
                         width=sum(self.engine.live)) as ph:
            step = self.engine.step_batch(tasks, chunk,
                                          decode=plan.decode)
            if step is not None:
                self._inflight.append(step)
                self.telemetry.bump("dispatched_steps")
                worked = True
            while (depth > 0 and plan.decode
                   and len(self._inflight) < depth + 1
                   and self._dispatch_is_useful()):
                extra = self.engine.step_batch([], decode=True)
                if extra is None:
                    break
                self._inflight.append(extra)
                self.telemetry.bump("dispatched_steps")
                worked = True
        # per-task chunk accounting at dispatch (positions advance
        # teacher-forced inside step_batch; first tokens arrive at
        # collect via _route_tokens)
        t_adv1 = self.clock()
        advanced = 0
        for rid, (req, task), p0 in zip(adv, pairs, pos0):
            took = task.pos - p0
            if took <= 0:
                continue
            advanced += 1
            self.telemetry.bump("prefill_chunks")
            self.telemetry.bump("prefill_tokens", took)
            req.prefill_chunks += 1
            self.tracer.add(f"prefill[chunk {req.prefill_chunks - 1}]",
                            ph.t0, t_adv1, cat=CAT_REQUEST,
                            lane=(LANE_REQ, rid),
                            args={"rid": rid, "tokens": took,
                                  "pos": task.pos, "batch": len(tasks),
                                  "fused": True})
        if advanced:
            self.telemetry.bump("prefill_batches")
        if self.prefix_cache is not None:
            self._prefix_after_dispatch(step, pairs)

        # 3) collect the OLDEST in-flight step (the host sync point); at
        # depth 0 that is the step dispatched just above
        out: Dict[int, int] = {}
        step = None
        if self._inflight:
            step = self._inflight.popleft()
            with self._phase("collect", tick=tick_no,
                             width=sum(step.live)):
                out = self.engine.collect(step)
            if self._is_decode_step(step):
                self.telemetry.bump("decode_steps")
            worked = True
        self._route_tokens(step, out)
        if self.prefix_cache is not None and step is not None:
            self._run_captures(step)

        self.telemetry.counters["rejected"] = float(self.queue.rejected)
        for k in _ENGINE_STAT_KEYS:
            self.telemetry.counters[k] = \
                self.engine.stats.get(k, 0.0) - self._stats0.get(k, 0.0)
        self.telemetry.bump("tick_time_s", self.clock() - t_tick0)
        if self._metrics_interval is not None:
            line = self.telemetry.live_line(self._metrics_interval)
            if line:
                self._on_metrics(line)
        return worked

    @staticmethod
    def _is_decode_step(step) -> bool:
        """Did this collected step advance any decode row? A fused step
        can be pure prefill; counting it as a decode step would skew the
        per-step decode-admission mean."""
        if isinstance(step, FusedStep):
            return bool(step.decode_rows)
        return True

    def _route_tokens(self, step, out: Dict[int, int]) -> None:
        """Deliver one collected step's tokens. For a fused step, a row
        whose prompt completed in that step delivers its FIRST token here
        — the prefill -> decode transition with no separate
        finish_prefill/insert, since the row is already resident and
        live; everything else is an ordinary decode token."""
        if isinstance(step, FusedStep):
            for task, fin in zip(step.tasks, step.finishing):
                if not fin or task.slot is None:
                    continue
                tok = out.pop(task.slot, None)
                req = self.slot_req[task.slot]
                if (tok is None or req is None or req.state != "prefill"
                        or self._prefills.get(req.rid,
                                              (None, None))[1] is not task):
                    continue  # cancelled / slot re-owned while in flight
                req.state = "decode"
                req.insert_t = self.clock()
                self.tracer.instant("insert", cat=CAT_REQUEST,
                                    lane=(LANE_REQ, req.rid), rid=req.rid,
                                    slot=task.slot, fused=True)
                req.mean_admission = task.adm_weighted / max(task.pos, 1)
                del self._prefills[req.rid]
                self._deliver(req, tok)
        for slot, tok in out.items():
            req = self.slot_req[slot]
            if req is not None and req.state == "decode":
                self._deliver(req, tok)

    def _deliver(self, req: ServeRequest, token: int) -> None:
        """Stream one token to a request; retire it when finished."""
        req.out.append(int(token))
        now = self.clock()
        is_last = (len(req.out) >= req.max_new
                   or (self.engine.eos is not None
                       and int(token) == self.engine.eos))
        self.mux.emit(req.rid, int(token), is_last)
        if is_last:
            req.state = "done"
            req.finish_t = now
            if req.slot is not None and self.slot_req[req.slot] is req:
                with self._phase("evict", counter="evict_time_s",
                                 slot=req.slot, rid=req.rid):
                    self.engine.free_slot(req.slot)
                self.slot_req[req.slot] = None
            self._close_request_spans(req)
            self.tracer.instant("finish", cat=CAT_REQUEST,
                                lane=(LANE_REQ, req.rid), rid=req.rid,
                                n_out=len(req.out))
            st = self.mux.streams[req.rid]
            self.telemetry.record_request(
                rid=req.rid, prompt_len=len(req.prompt), n_out=len(req.out),
                ttft=st.ttft, tpot=st.tpot,
                e2e=req.finish_t - req.arrival_t,
                mean_admission=req.mean_admission,
                prefill_chunks=req.prefill_chunks,
                prefix_hit=req.prefix_hit,
                prefix_tokens=req.prefix_tokens)

    # ------------------------------------------------------------------
    def drain(self) -> None:
        """Collect every still-in-flight decode step (run() calls this
        once the queue drains so engine stats and the paged mirror are
        settled; tokens for freed rows are discarded by the engine)."""
        while self._inflight:
            # drain iterations are mini-ticks for phase accounting: their
            # collect time counts toward tick_time_s so the phase-sum <=
            # tick-wall invariant holds over whole runs
            t0 = self.clock()
            step = self._inflight.popleft()
            with self._phase("collect", drain=True, width=sum(step.live)):
                out = self.engine.collect(step)
            if self._is_decode_step(step):
                self.telemetry.bump("decode_steps")
            self._route_tokens(step, out)
            if self.prefix_cache is not None:
                self._run_captures(step)
            # collect folded this step's eviction/admission stats into
            # engine.stats after the last tick's counter sync ran
            for k in _ENGINE_STAT_KEYS:
                self.telemetry.counters[k] = \
                    self.engine.stats.get(k, 0.0) - self._stats0.get(k, 0.0)
            self.telemetry.bump("tick_time_s", self.clock() - t0)

    def run(self, max_ticks: int = 10_000) -> None:
        """Tick until every submitted request has completed (or been
        cancelled), then drain the in-flight window."""
        self.telemetry.start()
        for _ in range(max_ticks):
            if self.queue.all_done():
                break
            self.tick()
        self.drain()
        self.telemetry.stop()

    def tokens(self, rid: int) -> List[int]:
        return self.mux.tokens(rid)


# re-exported for callers that treat the orchestrator package as the
# serving API surface
__all__ = ["SchedulerConfig", "Plan", "Scheduler", "Orchestrator",
           "QueueFull", "InvalidRequest"]
