"""Per-request token streaming with latency timestamps.

Each request gets a :class:`TokenStream`: the orchestrator pushes tokens
as the batched decode emits them, the stream timestamps every push
(TTFT = first push - arrival, TPOT = mean gap between pushes) and relays
to an optional user callback ``on_token(rid, token, is_last)`` — the
in-process analogue of an SSE/gRPC streaming response.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

OnToken = Callable[[int, int, bool], None]


class TokenStream:
    """One request's ordered token stream + per-token wall-clock stamps."""

    def __init__(self, rid: int, arrival_t: float,
                 on_token: Optional[OnToken] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.rid = rid
        self.arrival_t = arrival_t
        self.on_token = on_token
        self.clock = clock
        self.tokens: List[int] = []
        self.times: List[float] = []
        self.closed = False
        self.cancelled = False

    def emit(self, token: int, is_last: bool = False) -> None:
        assert not self.closed, f"stream {self.rid} already closed"
        self.tokens.append(int(token))
        self.times.append(self.clock())
        if is_last:
            self.closed = True
        if self.on_token is not None:
            self.on_token(self.rid, int(token), is_last)

    def close(self, *, cancelled: bool = False) -> None:
        """Terminate the stream without a final token (mid-stream
        cancellation / deadline expiry). Idempotent; late tokens for a
        closed stream are a bug `emit` refuses."""
        if not self.closed:
            self.closed = True
            self.cancelled = cancelled

    @property
    def ttft(self) -> Optional[float]:
        return self.times[0] - self.arrival_t if self.times else None

    @property
    def tpot(self) -> Optional[float]:
        """Mean inter-token gap after the first token."""
        if len(self.times) < 2:
            return None
        return (self.times[-1] - self.times[0]) / (len(self.times) - 1)


class StreamMux:
    """rid -> TokenStream registry the orchestrator emits through."""

    def __init__(self, clock: Callable[[], float] = time.monotonic):
        self.clock = clock
        self.streams: Dict[int, TokenStream] = {}

    def open(self, rid: int, arrival_t: float,
             on_token: Optional[OnToken] = None) -> TokenStream:
        st = TokenStream(rid, arrival_t, on_token=on_token, clock=self.clock)
        self.streams[rid] = st
        return st

    def emit(self, rid: int, token: int, is_last: bool = False) -> None:
        self.streams[rid].emit(token, is_last)

    def close(self, rid: int, *, cancelled: bool = False) -> None:
        if rid in self.streams:
            self.streams[rid].close(cancelled=cancelled)

    def tokens(self, rid: int) -> List[int]:
        return self.streams[rid].tokens
