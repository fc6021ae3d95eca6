"""Run-time contract sentinels for the serving tick (port of
``repro/analysis/sentinels.py`` for eager PyTorch).

* :class:`CompileSentinel` — the engine's step-shape budget as an
  assertion: the distinct step shapes dispatched per kind
  (``Engine.compiled_shape_counts()``; in eager PyTorch each is one CUDA
  graph a later capture would need) must stay within
  ``Engine.COMPILE_SHAPE_BUDGETS``.
* :class:`SyncSentinel` — the dispatch discipline as an assertion: while
  a fused step is in flight, and inside ``step_batch`` itself, a host
  pull may only run inside a sanctioned engine method (``collect`` above
  all). Host pulls are the engine's ``_host`` and
  ``Tensor.cpu/.item/.tolist/.numpy``, patched for the sentinel's life.
  On a CUDA engine the same window also runs under
  ``torch.cuda.set_sync_debug_mode("error")``, so a sync no Python call
  shows (a blocking copy, a ``nonzero``) raises too.
"""
from __future__ import annotations

import functools
from typing import Dict, Iterable, Optional

import torch

from repro_torch.serving import engine as engine_module


class CompileBudgetExceeded(AssertionError):
    pass


class SyncViolation(AssertionError):
    pass


class CompileSentinel:
    """Assert an engine's dispatched step shapes stay within its declared
    budget::

        with CompileSentinel(engine):
            ... full serve replay ...

    ``budgets`` overrides the engine's declaration. ``check()`` can be
    called mid-run; ``__exit__`` always checks (except when unwinding an
    exception, which it never masks)."""

    def __init__(self, engine, budgets: Optional[Dict[str, int]] = None):
        self.engine = engine
        self.budgets = dict(budgets if budgets is not None
                            else getattr(engine, "COMPILE_SHAPE_BUDGETS", {}))
        if not self.budgets:
            raise ValueError("no shape budgets: engine declares no "
                             "COMPILE_SHAPE_BUDGETS and none were passed")

    def counts(self) -> Dict[str, int]:
        return self.engine.compiled_shape_counts()

    def check(self) -> Dict[str, int]:
        counts = self.counts()
        over = {kind: (counts.get(kind, 0), budget)
                for kind, budget in self.budgets.items()
                if counts.get(kind, 0) > budget}
        if over:
            detail = ", ".join(
                f"{kind}: {got} step shapes > budget {budget}"
                for kind, (got, budget) in sorted(over.items()))
            raise CompileBudgetExceeded(
                f"dispatched step shapes exceeded the declared budget "
                f"({detail}); every extra shape is another graph to capture "
                "and a recompile stall in the tick: either the feed shapes "
                "regressed or Engine.COMPILE_SHAPE_BUDGETS must be updated")
        return counts

    def __enter__(self) -> "CompileSentinel":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc_type is None:
            self.check()
        return False


_TENSOR_PULLS = ("cpu", "item", "tolist", "numpy")


class SyncSentinel:
    """Assert no host sync escapes the dispatch/collect contract: after a
    ``step_batch`` dispatch returns an in-flight step, a host pull raises
    :class:`SyncViolation` until the step is collected, unless it runs
    inside a sanctioned engine method (``collect`` is the designated sync
    point; ``insert``/``free_slot``/``memory_snapshot``/``capture_prefix``
    are host-side slot upkeep the dispatch-ahead window overlaps). A pull
    inside ``step_batch`` itself is always a violation: dispatch never
    blocks on the device. Every patch is undone on exit, also after a
    raise."""

    SANCTIONED: Iterable[str] = ("collect", "insert", "free_slot",
                                 "memory_snapshot", "capture_prefix")

    def __init__(self, engine, sanctioned: Optional[Iterable[str]] = None):
        self.engine = engine
        self.sanctioned = tuple(sanctioned if sanctioned is not None
                                else self.SANCTIONED)
        self.outstanding = 0
        self._depth = 0  # inside a sanctioned frame
        self.syncs_in_collect = 0
        dev = getattr(engine, "device", None)
        self.cuda = dev is not None and torch.device(dev).type == "cuda"
        self._saved_mode = None
        self._patched: Dict[str, object] = {}
        self._wrapped: Dict[str, object] = {}

    # -- the guard ---------------------------------------------------------

    def _guard(self, what: str) -> None:
        if self._depth == 0 and self.outstanding > 0:
            raise SyncViolation(
                f"{what} while a fused step is in flight and outside any "
                "sanctioned engine method: collect() is the tick's only "
                "sync point; move this host pull into collect or out of "
                "the dispatch window")
        if self._depth > 0:
            self.syncs_in_collect += 1

    def _refresh_mode(self) -> None:
        """On CUDA: sync debug mode "error" exactly while a pull would be
        a violation."""
        if self.cuda:
            strict = self._depth == 0 and self.outstanding > 0
            torch.cuda.set_sync_debug_mode("error" if strict else "default")

    def _pull(self, what: str, orig):
        @functools.wraps(orig)
        def pull(*args, **kwargs):
            self._guard(what)
            return orig(*args, **kwargs)
        return pull

    # -- engine wrappers ---------------------------------------------------

    def _wrap_step_batch(self, orig):
        @functools.wraps(orig)
        def step_batch(*args, **kwargs):
            # dispatch itself must be sync-free, the first one too: a
            # provisional in-flight count covers it
            self.outstanding += 1
            self._refresh_mode()
            try:
                step = orig(*args, **kwargs)
            finally:
                self.outstanding -= 1
                self._refresh_mode()
            if step is not None:
                self.outstanding += 1
                self._refresh_mode()
            return step
        return step_batch

    def _wrap_sanctioned(self, orig, collects: bool):
        @functools.wraps(orig)
        def method(*args, **kwargs):
            self._depth += 1
            self._refresh_mode()
            try:
                return orig(*args, **kwargs)
            finally:
                self._depth -= 1
                if collects:
                    self.outstanding = max(0, self.outstanding - 1)
                self._refresh_mode()
        return method

    def __enter__(self) -> "SyncSentinel":
        if self.cuda:
            self._saved_mode = torch.cuda.get_sync_debug_mode()
        self._patched["_host"] = engine_module._host
        engine_module._host = self._pull("the engine's _host",
                                         engine_module._host)
        for name in _TENSOR_PULLS:
            orig = getattr(torch.Tensor, name)
            self._patched[name] = (orig, name in vars(torch.Tensor))
            setattr(torch.Tensor, name, self._pull(f"Tensor.{name}()", orig))
        eng = self.engine
        self._wrapped["step_batch"] = eng.step_batch
        eng.step_batch = self._wrap_step_batch(eng.step_batch)
        for name in self.sanctioned:
            fn = getattr(eng, name, None)
            if fn is None:
                continue
            self._wrapped[name] = fn
            setattr(eng, name, self._wrap_sanctioned(fn, name == "collect"))
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        engine_module._host = self._patched.pop("_host")
        for name, (orig, own) in self._patched.items():
            if own:
                setattr(torch.Tensor, name, orig)
            else:  # inherited from the C base: drop the shadowing wrapper
                delattr(torch.Tensor, name)
        self._patched.clear()
        for name in self._wrapped:
            # instance attributes shadowed the bound methods; drop them
            try:
                delattr(self.engine, name)
            except AttributeError:
                setattr(self.engine, name, self._wrapped[name])
        self._wrapped.clear()
        if self.cuda:
            torch.cuda.set_sync_debug_mode(self._saved_mode)
        return False
