"""Structured serving tracer: per-request lifecycle spans and per-tick
engine-phase spans over a ring buffer.

The serving stack is five PRs of pipelining (chunked prefill, batched
ragged extend, dispatch-ahead decode) — an end-of-run aggregate cannot
say *where a tick's wall time goes* or *where one request's TTFT was
spent*. The tracer answers both with two families of spans:

  * **request lane** (one lane per rid): ``queued -> prefill[chunk i]
    -> insert -> decode -> finish/cancel/deadline`` — the lifecycle the
    orchestrator drives;
  * **engine lane** (one lane per tick loop): ``memory_sample``,
    ``admit``, ``fused_step`` (the one jitted megabatch dispatch, with
    a ``selection`` sub-span when top-K page selection is active),
    ``collect``, ``evict`` — the per-tick phase decomposition the
    ROADMAP's fused megabatch / prefix-cache items need as evidence.

Design constraints:

  * **Always-on capable**: spans land in a bounded ring buffer
    (``collections.deque(maxlen=...)``) of plain tuples — no I/O, no
    serialization, no unbounded growth on a long-lived session. The
    oldest spans fall off; ``emitted`` counts everything ever recorded
    so exporters can report truncation.
  * **No-op-cheap when disabled**: the module-level :data:`NULL_TRACER`
    is the default everywhere. Its ``span()`` returns one shared
    pre-allocated context manager and ``add``/``instant`` return before
    touching the clock, so un-traced serving pays one attribute load +
    one branch per call site (asserted by the overhead test).
  * **Device bridge**: with ``annotate_device=True`` every ``span()``
    also enters a ``torch.profiler.record_function`` scope, so host spans
    line up with device traces in a profiler timeline.

Timestamps come from the injected ``clock`` (monotonic by default) —
deterministic-clock tests drive the tracer and the orchestrator from the
same fake clock. Export to Chrome-trace JSON lives in
:mod:`repro_torch.serving.obs.export`.
"""
from __future__ import annotations

import collections
import time
from typing import Callable, Deque, Dict, List, NamedTuple, Optional, Tuple

# lane kinds: spans are grouped into horizontal lanes by (kind, id) —
# ("req", rid) per request, ("tick", 0) for the engine tick loop
LANE_REQ = "req"
LANE_TICK = "tick"

# span categories (Chrome-trace "cat"): request lifecycle vs engine phase
CAT_REQUEST = "request"
CAT_ENGINE = "engine"


class Span(NamedTuple):
    """One completed span (or instant event, when ``t1 == t0``)."""
    name: str
    cat: str
    lane: Tuple[str, int]          # (kind, id): ("req", rid) | ("tick", 0)
    t0: float
    t1: float
    args: Optional[Dict[str, object]]


class _NullSpan:
    """Shared no-op context manager returned by a disabled tracer."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _SpanCm:
    """Context manager recording one span on exit (enabled tracers)."""
    __slots__ = ("tracer", "name", "cat", "lane", "args", "t0", "_ann")

    def __init__(self, tracer: "Tracer", name: str, cat: str,
                 lane: Tuple[str, int], args: Optional[Dict]):
        self.tracer = tracer
        self.name = name
        self.cat = cat
        self.lane = lane
        self.args = args
        self._ann = None

    def __enter__(self):
        if self.tracer.annotate_device:
            from torch.profiler import record_function
            self._ann = record_function(self.name)
            self._ann.__enter__()
        self.t0 = self.tracer.clock()
        return self

    def __exit__(self, *exc):
        t1 = self.tracer.clock()
        if self._ann is not None:
            self._ann.__exit__(*exc)
        self.tracer.add(self.name, self.t0, t1, cat=self.cat,
                        lane=self.lane, args=self.args)
        return False


class Tracer:
    """Ring-buffer span recorder.

    ``capacity`` bounds resident spans (oldest dropped); ``enabled=False``
    short-circuits every entry point (see :data:`NULL_TRACER`);
    ``annotate_device`` additionally wraps ``span()`` bodies in
    ``torch.profiler.record_function`` so a device profile shows the same
    phase names as the host trace."""

    def __init__(self, capacity: int = 1 << 16, *,
                 clock: Callable[[], float] = time.monotonic,
                 enabled: bool = True, annotate_device: bool = False):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.clock = clock
        self.enabled = enabled
        self.annotate_device = annotate_device
        self.spans: Deque[Span] = collections.deque(maxlen=capacity)
        self.emitted = 0        # total ever recorded (>= len(spans))

    # ---- recording -------------------------------------------------------
    def span(self, name: str, *, cat: str = CAT_ENGINE,
             lane: Tuple[str, int] = (LANE_TICK, 0), **args):
        """Context manager timing one phase; ``**args`` become span
        attributes (tick/rid/slot/batch width...)."""
        if not self.enabled:
            return _NULL_SPAN
        return _SpanCm(self, name, cat, lane, args or None)

    def add(self, name: str, t0: float, t1: float, *,
            cat: str = CAT_ENGINE, lane: Tuple[str, int] = (LANE_TICK, 0),
            args: Optional[Dict] = None) -> None:
        """Record an already-timed span (the orchestrator times phases
        with its own injected clock and reports [t0, t1] here)."""
        if not self.enabled:
            return
        self.spans.append(Span(name, cat, lane, t0, t1, args))
        self.emitted += 1

    def instant(self, name: str, *, cat: str = CAT_ENGINE,
                lane: Tuple[str, int] = (LANE_TICK, 0), **args) -> None:
        """Record a zero-duration marker (finish / cancel / deadline)."""
        if not self.enabled:
            return
        t = self.clock()
        self.spans.append(Span(name, cat, lane, t, t, args or None))
        self.emitted += 1

    def device_scope(self, name: str):
        """``torch.profiler.record_function`` context when device
        annotation is on, else the shared no-op — engines wrap their
        fused dispatches with this so device profiles carry the serving
        phase names without the host-span overhead per step."""
        if not (self.enabled and self.annotate_device):
            return _NULL_SPAN
        from torch.profiler import record_function
        return record_function(name)

    # ---- views -----------------------------------------------------------
    def drain(self) -> List[Span]:
        """Snapshot and clear the ring (exporters call this)."""
        out = list(self.spans)
        self.spans.clear()
        return out

    @property
    def dropped(self) -> int:
        return self.emitted - len(self.spans)

    def clear(self) -> None:
        self.spans.clear()
        self.emitted = 0


# the default tracer everywhere: disabled, shared, allocation-free on the
# hot path — serving code calls through it unconditionally
NULL_TRACER = Tracer(capacity=1, enabled=False)
