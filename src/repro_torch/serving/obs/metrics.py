"""Serving metrics registry: counters, gauges, and rolling-window
histograms behind one namespace.

:class:`repro_torch.serving.orchestrator.telemetry.Telemetry` sits on top of
this registry — its counter dict is a live view over registry counters,
and its latency/memory observations feed rolling histograms — so the
same numbers power both the end-of-run summary (cumulative) and the live
periodic report line (`--metrics-interval` in launch/serve.py, windowed).

Aggregation model:

  * :class:`Counter` — monotone-by-convention float; ``inc`` on the hot
    path, ``set`` for the scheduler's engine-stat delta sync. A counter
    remembers windowed rates via ``rate(window_s)`` using a small ring
    of (t, value) checkpoints taken on ``tick()``.
  * :class:`Gauge` — last-write-wins instantaneous value.
  * :class:`Histogram` — cumulative count/sum/min/max plus a bounded
    deque of (t, value) observations for rolling-window percentiles
    (pXX over the last ``window_s`` seconds, not over the whole run —
    the difference between "p99 since boot" and "p99 right now").

Everything takes its time from the injected ``clock`` so deterministic
tests can drive the windows.
"""
from __future__ import annotations

import collections
import time
from typing import Callable, Deque, Dict, List, Optional, Tuple

import numpy as np


class Counter:
    __slots__ = ("name", "value", "_marks")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0
        # (t, value) checkpoints for windowed rates, newest last
        self._marks: Deque[Tuple[float, float]] = collections.deque(maxlen=256)

    def inc(self, by: float = 1.0) -> None:
        self.value += by

    def set(self, v: float) -> None:
        self.value = float(v)

    def mark(self, now: float) -> None:
        """Checkpoint the current value (the registry marks every
        counter when a live report line is cut)."""
        self._marks.append((now, self.value))

    def rate(self, now: float, window_s: float) -> Optional[float]:
        """Mean increase per second over ~``window_s`` (None until two
        checkpoints at least partially cover the window)."""
        base = None
        for t, v in reversed(self._marks):
            base = (t, v)
            if now - t >= window_s:
                break
        if base is None or now <= base[0]:
            return None
        return (self.value - base[1]) / (now - base[0])


class Gauge:
    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value: Optional[float] = None

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Cumulative stats + rolling-window percentile support."""
    __slots__ = ("name", "count", "sum", "min", "max", "window_s", "_obs")

    def __init__(self, name: str, *, window_s: float = 30.0,
                 max_window_obs: int = 4096):
        self.name = name
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None
        self.window_s = window_s
        self._obs: Deque[Tuple[float, float]] = collections.deque(
            maxlen=max_window_obs)

    def observe(self, v: float, *, now: float) -> None:
        v = float(v)
        self.count += 1
        self.sum += v
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)
        self._obs.append((now, v))

    @property
    def mean(self) -> Optional[float]:
        return self.sum / self.count if self.count else None

    def window_values(self, now: float) -> List[float]:
        t0 = now - self.window_s
        return [v for t, v in self._obs if t >= t0]

    def window_stats(self, now: float,
                     pcts: Tuple[float, ...] = (50, 90, 99)) -> Dict:
        vals = self.window_values(now)
        out: Dict[str, Optional[float]] = {
            "count": float(len(vals)),
            "mean": float(np.mean(vals)) if vals else None,
        }
        arr = np.asarray(vals) if vals else None
        for q in pcts:
            out[f"p{int(q)}"] = (float(np.percentile(arr, q))
                                 if arr is not None else None)
        return out


class MetricsRegistry:
    """Name -> metric map with get-or-create accessors.

    One registry per Telemetry (per orchestrator). Names are flat
    strings; the registry never forgets a metric, so ``snapshot()`` is a
    stable schema across a run."""

    def __init__(self, *, clock: Callable[[], float] = time.monotonic,
                 window_s: float = 30.0):
        self.clock = clock
        self.window_s = window_s
        self.counters: Dict[str, Counter] = {}
        self.gauges: Dict[str, Gauge] = {}
        self.histograms: Dict[str, Histogram] = {}

    # ---- get-or-create ---------------------------------------------------
    def counter(self, name: str) -> Counter:
        c = self.counters.get(name)
        if c is None:
            c = self.counters[name] = Counter(name)
        return c

    def gauge(self, name: str) -> Gauge:
        g = self.gauges.get(name)
        if g is None:
            g = self.gauges[name] = Gauge(name)
        return g

    def histogram(self, name: str,
                  window_s: Optional[float] = None) -> Histogram:
        h = self.histograms.get(name)
        if h is None:
            h = self.histograms[name] = Histogram(
                name, window_s=window_s or self.window_s)
        return h

    # ---- convenience hot-path entry points -------------------------------
    def inc(self, name: str, by: float = 1.0) -> None:
        self.counter(name).inc(by)

    def observe(self, name: str, v: float) -> None:
        self.histogram(name).observe(v, now=self.clock())

    # ---- aggregation -----------------------------------------------------
    def mark_counters(self) -> None:
        """Checkpoint all counters for windowed rate queries."""
        now = self.clock()
        for c in self.counters.values():
            c.mark(now)

    def snapshot(self) -> Dict[str, object]:
        """Point-in-time view: counter values, gauge values, histogram
        cumulative + rolling-window stats."""
        now = self.clock()
        return {
            "counters": {k: c.value for k, c in self.counters.items()},
            "gauges": {k: g.value for k, g in self.gauges.items()},
            "histograms": {
                k: {"count": float(h.count), "mean": h.mean,
                    "min": h.min, "max": h.max,
                    "window": h.window_stats(now)}
                for k, h in self.histograms.items()},
        }


class CounterView(collections.abc.MutableMapping):
    """Dict-like facade over a registry's counters.

    Telemetry's public ``counters`` attribute keeps its historical
    ``Dict[str, float]`` contract (``[]``, ``.get``, ``dict(...)``,
    ``in``) while every read/write lands in the registry — the refactor
    that lets the live metrics line and the end-of-run summary share one
    source of truth."""
    __slots__ = ("_reg",)

    def __init__(self, reg: MetricsRegistry):
        self._reg = reg

    def __getitem__(self, name: str) -> float:
        c = self._reg.counters.get(name)
        if c is None:
            raise KeyError(name)
        return c.value

    def __setitem__(self, name: str, v: float) -> None:
        self._reg.counter(name).set(v)

    def __delitem__(self, name: str) -> None:
        del self._reg.counters[name]

    def __iter__(self):
        return iter(self._reg.counters)

    def __len__(self) -> int:
        return len(self._reg.counters)

    def __repr__(self) -> str:
        return f"CounterView({dict(self)!r})"
