"""repro_torch.analysis — the port's static lint and run-time sentinels
(port of ``repro/analysis``).

Static side (stdlib only)::

    python -m repro_torch.analysis.lint src/repro_torch \\
        --baseline src/repro_torch/analysis/baseline.json

Run-time side (needs torch; imported lazily, so the engine can import
:func:`tick_path` without pulling the sentinels, which import the
engine)::

    from repro_torch.analysis import CompileSentinel, SyncSentinel
"""
from __future__ import annotations

from .contracts import tick_path  # stdlib only, safe at import time

__all__ = [
    "tick_path",
    "CompileSentinel",
    "SyncSentinel",
    "CompileBudgetExceeded",
    "SyncViolation",
    "Finding",
    "lint_paths",
]

_LAZY = {
    "CompileSentinel": "repro_torch.analysis.sentinels",
    "SyncSentinel": "repro_torch.analysis.sentinels",
    "CompileBudgetExceeded": "repro_torch.analysis.sentinels",
    "SyncViolation": "repro_torch.analysis.sentinels",
    "Finding": "repro_torch.analysis.findings",
    "lint_paths": "repro_torch.analysis.lint",
}


def __getattr__(name: str):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(mod), name)
