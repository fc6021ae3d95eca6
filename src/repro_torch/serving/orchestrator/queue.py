"""Arrival-ordered request queue with backpressure and typed rejections.

Requests enter in submission order (FIFO); ``max_pending`` bounds the
number of requests waiting for a slot — once full, ``submit`` raises
:class:`QueueFull`, a *typed* backpressure response carrying the queue
state so an upstream frontend can shed load or retry with backoff (the
serving-system analogue of a bounded inbox; rejected arrivals are
counted for telemetry). Malformed requests (empty prompt, ``max_new <
1``) raise :class:`InvalidRequest` at the queue boundary instead of
failing deep inside the backend's ``start_prefill``.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable, Deque, Dict, List, Optional


class QueueFull(RuntimeError):
    """Backpressure signal: the pending queue is at ``max_pending``.

    Typed response for frontends: ``depth`` is the pending depth at
    rejection time, ``max_pending`` the configured bound. Retry after
    draining (the request was NOT enqueued)."""

    def __init__(self, depth: int, max_pending: int):
        super().__init__(
            f"pending queue at max_pending={max_pending} (depth={depth})")
        self.depth = depth
        self.max_pending = max_pending


class InvalidRequest(ValueError):
    """The request can never be served: empty prompt or ``max_new < 1``."""


@dataclasses.dataclass
class ServeRequest:
    """One request's full serving lifecycle record."""
    rid: int
    prompt: List[int]
    max_new: int
    arrival_t: float
    state: str = "queued"  # queued -> prefill -> decode -> done | cancelled
    slot: Optional[int] = None
    out: List[int] = dataclasses.field(default_factory=list)
    finish_t: Optional[float] = None
    mean_admission: Optional[float] = None
    # chunks THIS request's prefill advanced by (batched advances still
    # count one chunk per task per tick; the per-request view dashboards
    # keep when the global prefill_chunks/prefill_batches split changed)
    prefill_chunks: int = 0
    # absolute wall-clock deadline (arrival_t + deadline_s); the
    # orchestrator cancels the request when the clock passes it
    deadline_t: Optional[float] = None
    # lifecycle transition timestamps for the request-lane trace spans:
    # queued ends at admit_t, decode runs insert_t -> finish_t
    admit_t: Optional[float] = None
    insert_t: Optional[float] = None
    # prefix-cache outcome at admission: did a stored shared-context
    # prefix splice in, and how many prompt tokens did it cover
    prefix_hit: bool = False
    prefix_tokens: int = 0
    # TTFT/TPOT live on the request's TokenStream (stream.py), the single
    # source of truth for per-token timing


class RequestQueue:
    """FIFO arrival queue with bounded pending depth."""

    def __init__(self, max_pending: Optional[int] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.max_pending = max_pending
        self.clock = clock
        self._pending: Deque[ServeRequest] = collections.deque()
        self.requests: Dict[int, ServeRequest] = {}
        self._next_rid = 0
        self.rejected = 0

    def submit(self, prompt: List[int], max_new: int = 32, *,
               deadline_s: Optional[float] = None) -> int:
        """Enqueue a request. Raises :class:`InvalidRequest` for requests
        that can never be served and :class:`QueueFull` at
        ``max_pending`` (backpressure; the request is not enqueued)."""
        if not prompt:
            raise InvalidRequest("prompt must be non-empty")
        if max_new < 1:
            raise InvalidRequest(f"max_new must be >= 1, got {max_new}")
        if deadline_s is not None and deadline_s <= 0:
            raise InvalidRequest(f"deadline_s must be > 0, got {deadline_s}")
        if self.max_pending is not None and len(self._pending) >= self.max_pending:
            self.rejected += 1
            raise QueueFull(len(self._pending), self.max_pending)
        rid = self._next_rid
        self._next_rid += 1
        now = self.clock()
        req = ServeRequest(rid=rid, prompt=list(prompt), max_new=max_new,
                           arrival_t=now,
                           deadline_t=(None if deadline_s is None
                                       else now + deadline_s))
        self._pending.append(req)
        self.requests[rid] = req
        return rid

    def pop(self) -> Optional[ServeRequest]:
        """Dequeue the oldest pending request (None when empty)."""
        return self._pending.popleft() if self._pending else None

    def remove(self, rid: int) -> bool:
        """Drop a still-queued request (cancellation before admission).
        Returns False if the request is not in the pending queue."""
        for req in self._pending:
            if req.rid == rid:
                self._pending.remove(req)
                return True
        return False

    def __len__(self) -> int:
        return len(self._pending)

    @property
    def depth(self) -> int:
        return len(self._pending)

    def all_done(self) -> bool:
        return not self._pending and all(
            r.state in ("done", "cancelled") for r in self.requests.values())
