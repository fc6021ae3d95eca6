"""ServeSession: the public client surface over the serving orchestrator.

The Orchestrator (scheduler.py) is the *mechanism* — a tick loop over
queue/prefill/dispatch/collect. ServeSession is the *API* a frontend
programs against, in the spirit of JetStream's client-facing driver:

    session = ServeSession(make_backend("wgkv", params, cfg, slots=4))
    h = session.submit(prompt, max_new=64, deadline_s=2.0)
    for tok in h:                    # pumps the loop; yields as decoded
        emit(tok)
    session.cancel(h.rid)            # or: h.cancel() — mid-stream is fine
    session.close()                  # drain in-flight work, stop telemetry

Contract:

  * ``submit`` returns a :class:`RequestHandle` immediately, or raises
    the typed :class:`QueueFull` (backpressure: queue depth and bound
    attached; the request was NOT enqueued — shed load or retry) /
    :class:`InvalidRequest` (malformed: never retriable).
  * Tokens stream through the handle: ``for tok in handle`` (sync) or
    ``async for tok in handle.astream()`` (cooperative asyncio wrapper);
    both pump ``session.tick()`` only while output is pending, so many
    handles can be consumed concurrently.
  * ``cancel`` works at ANY stage — queued, mid-prefill, mid-decode.
    Mid-decode the slot is freed and its paged-pool pages reclaimed on
    the spot; tokens an already-dispatched step produces for the freed
    row are discarded by the engine's generation guard, so surviving
    streams are byte-identical to an uncancelled run.
  * The session defaults to ``dispatch_ahead=1`` (the two-phase
    dispatch/collect driver): host work for decode step t overlaps
    device compute for step t+1. Pass a ``SchedulerConfig`` with
    ``dispatch_ahead=0`` for the synchronous baseline.
"""
from __future__ import annotations

import asyncio
import dataclasses
from typing import AsyncIterator, Iterator, List, Optional

from repro_torch.serving.backend import EngineBackend
from repro_torch.serving.orchestrator.scheduler import Orchestrator, SchedulerConfig
from repro_torch.serving.orchestrator.stream import OnToken

# ticks tolerated without any work or token progress before an iterator
# concludes the loop is wedged (scheduler bug) instead of spinning forever
_STALL_TICKS = 10_000


@dataclasses.dataclass
class RequestHandle:
    """One submitted request: stream cursor + lifecycle view + cancel."""
    session: "ServeSession"
    rid: int

    # ---- lifecycle ---------------------------------------------------
    @property
    def state(self) -> str:
        """queued | prefill | decode | done | cancelled"""
        return self.session.orchestrator.queue.requests[self.rid].state

    @property
    def done(self) -> bool:
        return self.state == "done"

    @property
    def cancelled(self) -> bool:
        return self.state == "cancelled"

    def tokens(self) -> List[int]:
        """Tokens streamed so far (does not pump the loop)."""
        return list(self.session.orchestrator.tokens(self.rid))

    def cancel(self) -> bool:
        return self.session.cancel(self.rid)

    # ---- streaming ---------------------------------------------------
    def _pump(self) -> Iterator[Optional[int]]:
        """Shared token pump behind both iterators: yields each new token
        as it lands, and ``None`` after a scheduler tick that produced no
        token for this stream (the async adapter uses those gaps to yield
        control). Ends when the stream closes; raises if the loop makes
        no progress for _STALL_TICKS ticks (scheduler wedge, not EOS)."""
        stream = self.session.orchestrator.mux.streams[self.rid]
        i, stalled = 0, 0
        while True:
            while i < len(stream.tokens):
                stalled = 0
                yield stream.tokens[i]
                i += 1
            if stream.closed:
                return
            worked = self.session.tick()
            stalled = 0 if worked else stalled + 1
            if stalled > _STALL_TICKS:
                raise RuntimeError(
                    f"request {self.rid} stalled: no scheduler progress for "
                    f"{_STALL_TICKS} ticks (state={self.state})")
            yield None

    def __iter__(self) -> Iterator[int]:
        """Yield tokens as the serving loop produces them, pumping
        ``session.tick()`` whenever the stream is dry. Ends when the
        request finishes or is cancelled (partial stream)."""
        return (tok for tok in self._pump() if tok is not None)

    async def astream(self) -> AsyncIterator[int]:
        """``async for`` adapter over the same pump: yields control to
        the event loop between scheduler ticks so other coroutines (e.g.
        other handles' astream consumers) interleave."""
        for tok in self._pump():
            if tok is None:
                await asyncio.sleep(0)
            else:
                yield tok

    def result(self) -> List[int]:
        """Pump until terminal and return the full (possibly partial, if
        cancelled) token list."""
        for _ in self:
            pass
        return self.tokens()


class ServeSession:
    """Client session over one engine backend: submit / stream / cancel.

    ``sched`` defaults to the dispatch-ahead driver
    (``dispatch_ahead=1``); everything else (chunking, backpressure
    bound) is the orchestrator's. Pass ``prefix_cache=PrefixCache(
    quantum=sched.chunk_tokens, free_fn=engine.release_prefix)`` to
    enable content-addressed shared-context reuse across requests
    (serving/prefix_cache.py) — the store outlives the session, so
    multi-turn drivers reuse prefixes across rounds."""

    def __init__(self, engine: EngineBackend, *,
                 sched: Optional[SchedulerConfig] = None,
                 max_pending: Optional[int] = None, **orch_kw):
        if sched is None:
            sched = SchedulerConfig(dispatch_ahead=1)
        self.orchestrator = Orchestrator(engine, sched=sched,
                                         max_pending=max_pending, **orch_kw)
        self._closed = False

    # ---- submission --------------------------------------------------
    def submit(self, prompt: List[int], max_new: int = 32, *,
               deadline_s: Optional[float] = None,
               on_token: Optional[OnToken] = None) -> RequestHandle:
        """Enqueue a request and return its handle. Raises the typed
        :class:`repro_torch.serving.orchestrator.queue.QueueFull` under
        backpressure and :class:`InvalidRequest` for malformed requests."""
        assert not self._closed, "session is closed"
        rid = self.orchestrator.submit(prompt, max_new, on_token=on_token,
                                       deadline_s=deadline_s)
        return RequestHandle(self, rid)

    def cancel(self, rid: int) -> bool:
        """Cancel a request at any stage (mid-stream included): its slot
        is freed and paged-pool pages reclaimed immediately; its stream
        closes with ``cancelled=True``."""
        return self.orchestrator.cancel(rid)

    # ---- loop control ------------------------------------------------
    def tick(self) -> bool:
        return self.orchestrator.tick()

    def run(self, max_ticks: int = 10_000) -> None:
        """Drive until every submitted request is terminal."""
        self.orchestrator.run(max_ticks)

    def close(self) -> None:
        """Drain in-flight device work and stop telemetry. Idempotent;
        the session rejects new submissions afterwards."""
        if not self._closed:
            self.orchestrator.drain()
            self.orchestrator.telemetry.stop()
            self._closed = True

    def __enter__(self) -> "ServeSession":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ---- views -------------------------------------------------------
    @property
    def engine(self) -> EngineBackend:
        return self.orchestrator.engine

    @property
    def telemetry(self):
        return self.orchestrator.telemetry

    @property
    def tracer(self):
        """The orchestrator's span tracer (pass ``tracer=Tracer(...)`` at
        construction; defaults to the no-op NULL_TRACER). Export with
        :func:`repro_torch.serving.obs.export.write_chrome_trace`."""
        return self.orchestrator.tracer

    def report(self) -> str:
        return self.orchestrator.telemetry.report()
