"""The torchlint static passes (port of ``repro/analysis/passes.py`` for
eager PyTorch).

Stdlib ``ast`` analysis only: the lint CLI runs without torch.

Codes
-----
TL000  malformed ``# torchlint:`` annotation (unknown directive,
       reasonless ``allow-*``)
TL001  host sync in a tick-path function without ``allow-sync(reason)``:
       ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``,
       ``torch.cuda.synchronize()``, ``float()/int()/bool()`` of a tensor
       value, ``np.asarray``/``np.array`` of a tensor value, the engine's
       ``_host``, and a Python ``if``/``while``/``assert`` on a tensor
       value (in eager mode such a branch is itself a host sync: the
       reference's JL004 folds in here)
TL002  ``torch.cat`` / ``torch.stack`` (and ``concat`` / ``concatenate``)
       in a module of the sharded path (``SHARDED_PATH_MODULES``) or a
       function marked ``sharded-path``, without ``allow-concat(reason)``
       (the reference's JL002). There a rank holds blocks of tensors
       split over "data" or "model": a concat of local blocks along a
       split axis builds a tensor no rank should hold, and the one that
       should exist is assembled by a collective, in
       ``sharding/comm.py``.
TL003  cache state escaping a masked scan body without the per-row
       select (``tree_map`` / ``torch.where``), or written in place there

The reference's JL005 (jit shape budget) has no static counterpart in
eager PyTorch: the budget is data on the Engine, which
``sentinels.CompileSentinel`` checks at run time.
"""
from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, Iterable, List, Optional, Set, Tuple

from .contracts import AnnotationIndex, parse_annotations
from .findings import Finding

# Calls whose outputs count as already-masked cache state for TL003: the
# per-leaf select and the ragged extend whose body performs it.
MASKED_PRODUCERS: Tuple[str, ...] = (
    "tree_map", "tree_map_with_path", "where", "prefill_extend_ragged",
)

# Parameter names that seed TL003's cache-flow tracking.
CACHE_PARAM_NAMES: FrozenSet[str] = frozenset(
    {"carry", "caches", "cache", "old", "state"})

# In-place tensor writes TL003 checks on cache state.
INPLACE_METHODS: FrozenSet[str] = frozenset(
    {"copy_", "index_copy_", "index_put_", "masked_scatter_", "scatter_",
     "fill_", "zero_", "add_"})

# Reads of a tensor that stay on the host: its metadata.
SAFE_TENSOR_ATTRS: FrozenSet[str] = frozenset(
    {"shape", "ndim", "dtype", "device", "is_cuda", "requires_grad"})
SAFE_TENSOR_CALLS: FrozenSet[str] = frozenset(
    {"len", "isinstance", "getattr", "hasattr", "type", "id"})

# torch calls that compute on host metadata, not tensor values
_HOST_SAFE_CALLS: FrozenSet[str] = frozenset(
    {"torch.device", "torch.dtype", "torch.Size", "torch.iinfo",
     "torch.finfo", "torch.is_grad_enabled", "torch.is_tensor",
     "torch.cuda.is_available", "torch.cuda.device_count",
     "torch.get_default_dtype"})

# Methods whose call pulls a tensor's value to the host.
SYNC_METHODS: FrozenSet[str] = frozenset({"item", "tolist", "cpu", "numpy"})
# Functions that do: the engine's designated pull.
SYNC_FUNCTIONS: FrozenSet[str] = frozenset(
    {"_host", "torch.cuda.synchronize"})

ALL_CODES: Tuple[str, ...] = ("TL000", "TL001", "TL002", "TL003")

# Modules whose every concat or stack is a TL002 finding: the sharded
# serving's helpers hold rank-local blocks of batched cache trees.
SHARDED_PATH_MODULES: Tuple[str, ...] = ("repro_torch/serving/sharded.py",)
CONCAT_CALLS: FrozenSet[str] = frozenset(
    {"torch.cat", "torch.concat", "torch.concatenate", "torch.stack"})


@dataclass
class ModuleContext:
    path: str  # as passed on the CLI, '/'-separated
    source: str
    tree: ast.Module
    ann: AnnotationIndex
    lines: List[str] = field(default_factory=list)
    parents: Dict[ast.AST, ast.AST] = field(default_factory=dict)

    @classmethod
    def parse(cls, path: str, source: str) -> "ModuleContext":
        tree = ast.parse(source, filename=path)
        ctx = cls(path=path.replace("\\", "/"), source=source, tree=tree,
                  ann=parse_annotations(source), lines=source.splitlines())
        for parent in ast.walk(tree):
            for child in ast.iter_child_nodes(parent):
                ctx.parents[child] = parent
        return ctx

    def line_text(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1].strip()
        return ""

    def finding(self, code: str, lineno: int, message: str) -> Finding:
        return Finding(code=code, path=self.path, line=lineno,
                       message=message, text=self.line_text(lineno))


# Shared AST helpers --------------------------------------------------------


def _dotted(node: ast.AST) -> Optional[str]:
    """``a.b.c`` for Name/Attribute chains, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _name_targets(target: ast.AST) -> List[str]:
    """Flatten assignment targets into plain names (ignores attrs and
    subscripts)."""
    if isinstance(target, ast.Name):
        return [target.id]
    if isinstance(target, (ast.Tuple, ast.List)):
        out: List[str] = []
        for elt in target.elts:
            out.extend(_name_targets(elt))
        return out
    if isinstance(target, ast.Starred):
        return _name_targets(target.value)
    return []


def _functions(tree: ast.AST):
    """Every def/async def of the tree."""
    return [n for n in ast.walk(tree)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]


def _assignments_in_order(node: ast.AST) -> List[ast.stmt]:
    out = [n for n in ast.walk(node)
           if isinstance(n, (ast.Assign, ast.AugAssign, ast.AnnAssign))]
    out.sort(key=lambda n: n.lineno)
    return out


def _targets(st: ast.stmt) -> List[ast.AST]:
    return st.targets if isinstance(st, ast.Assign) else [st.target]


def _func_params(fn) -> List[str]:
    a = fn.args
    names = [p.arg for p in a.posonlyargs + a.args + a.kwonlyargs]
    if a.vararg:
        names.append(a.vararg.arg)
    if a.kwarg:
        names.append(a.kwarg.arg)
    return [n for n in names if n != "self"]


def _is_torch_value_call(call: ast.Call) -> bool:
    d = _dotted(call.func) or ""
    return d.startswith("torch.") and d not in _HOST_SAFE_CALLS


def _tensor_value_uses(expr: ast.AST, tainted: Set[str]) -> List[ast.AST]:
    """Nodes of `expr` that evaluate a tensor's VALUE: torch calls (other
    than the metadata helpers) and tainted names, except where only their
    metadata is read (``.shape``, ``len()``, ``isinstance()``, ``is
    None``)."""
    parents = {c: p for p in ast.walk(expr) for c in ast.iter_child_nodes(p)}
    hits: List[ast.AST] = []
    for n in ast.walk(expr):
        is_torch = isinstance(n, ast.Call) and _is_torch_value_call(n)
        is_name = isinstance(n, ast.Name) and n.id in tainted
        if not (is_torch or is_name):
            continue
        parent = parents.get(n)
        if isinstance(parent, ast.Attribute) \
                and parent.attr in SAFE_TENSOR_ATTRS:
            continue
        if isinstance(parent, ast.Call) and n in parent.args \
                and isinstance(parent.func, ast.Name) \
                and parent.func.id in SAFE_TENSOR_CALLS:
            continue
        if isinstance(parent, ast.Compare) and all(
                isinstance(op, (ast.Is, ast.IsNot)) for op in parent.ops):
            continue
        hits.append(n)
    return hits


def _pulls_to_host(value: ast.AST) -> bool:
    """An assignment whose value is already on the host: the engine's
    pull, a numpy call, or a sync method."""
    if not isinstance(value, ast.Call):
        return any(isinstance(n, ast.Call)
                   and (_dotted(n.func) or "") in SYNC_FUNCTIONS
                   for n in ast.walk(value))
    d = _dotted(value.func) or ""
    if d in SYNC_FUNCTIONS or d.startswith("np.") or d.startswith("numpy."):
        return True
    return isinstance(value.func, ast.Attribute) \
        and value.func.attr in SYNC_METHODS


# TL000 — annotation errors -------------------------------------------------


def check_annotations(ctx: ModuleContext) -> List[Finding]:
    return [ctx.finding(
        "TL000", d.line,
        f"malformed torchlint annotation '{d.name}'"
        + (" (allow-* suppressions require a reason in parens)"
           if d.name.startswith("allow-") else " (unknown directive)"))
        for d in ctx.ann.errors]


# TL001 — host sync in the tick path ----------------------------------------


def _is_tick_function(fn, ctx: ModuleContext) -> bool:
    for dec in fn.decorator_list:
        d = _dotted(dec) or ""
        if d == "tick_path" or d.endswith(".tick_path"):
            return True
    return ctx.ann.scope_marker("tick-path", fn.lineno)


def check_host_sync(ctx: ModuleContext) -> List[Finding]:
    out: List[Finding] = []
    spans = [(fn.lineno, fn.end_lineno or fn.lineno)
             for fn in _functions(ctx.tree) if _is_tick_function(fn, ctx)]
    if not spans:
        return out

    def in_tick(node) -> bool:
        return any(lo <= node.lineno <= hi for lo, hi in spans)

    # tensor taint over local names, assignments in source order
    tainted: Set[str] = set()
    for st in _assignments_in_order(ctx.tree):
        if not in_tick(st):
            continue
        names: List[str] = []
        for t in _targets(st):
            names.extend(_name_targets(t))
        if st.value is None:
            continue
        if _pulls_to_host(st.value):
            tainted.difference_update(names)
        elif _tensor_value_uses(st.value, tainted):
            tainted.update(names)
        elif not isinstance(st, ast.AugAssign):
            tainted.difference_update(names)

    def emit(node, what: str) -> None:
        if ctx.ann.suppressed("TL001", node.lineno):
            return
        out.append(ctx.finding(
            "TL001", node.lineno,
            f"{what} in a tick-path function blocks dispatch on a host "
            "sync: move it into collect() or out of the tick, or annotate "
            "`# torchlint: allow-sync(reason)`"))

    for node in ast.walk(ctx.tree):
        if isinstance(node, (ast.If, ast.While, ast.Assert)) \
                and in_tick(node):
            if _tensor_value_uses(node.test, tainted):
                emit(node, f"Python {type(node).__name__.lower()} on a "
                           "tensor value")
            continue
        if not (isinstance(node, ast.Call) and in_tick(node)):
            continue
        d = _dotted(node.func) or ""
        if d in SYNC_FUNCTIONS:
            emit(node, f"{d}()")
        elif isinstance(node.func, ast.Attribute) \
                and node.func.attr in SYNC_METHODS \
                and (node.func.attr == "cpu" or not node.args):
            emit(node, f".{node.func.attr}()")
        elif d in ("np.asarray", "numpy.asarray", "np.array",
                   "numpy.array") and node.args:
            arg = node.args[0]
            benign = isinstance(arg, (ast.Constant, ast.List, ast.Tuple)) \
                or (isinstance(arg, ast.Name) and arg.id not in tainted)
            if not benign:
                emit(node, f"{d} of a tensor value")
        elif isinstance(node.func, ast.Name) \
                and node.func.id in ("float", "int", "bool") \
                and len(node.args) == 1 \
                and _tensor_value_uses(node.args[0], tainted):
            emit(node, f"{node.func.id}() of a tensor value")
    return out


# TL003 — cache state escaping a masked scan body ---------------------------

_PLAIN, _CACHE, _RAW, _MASKED = "plain", "cache", "raw", "masked"


def _is_masked_producer(call: ast.Call) -> bool:
    d = _dotted(call.func) or ""
    return d.rsplit(".", 1)[-1] in MASKED_PRODUCERS


def check_masked_scan_body(ctx: ModuleContext) -> List[Finding]:
    out: List[Finding] = []
    for fn in _functions(ctx.tree):
        if not ctx.ann.scope_marker("masked-scan-body", fn.lineno):
            continue
        state: Dict[str, str] = {p: _CACHE for p in _func_params(fn)
                                 if p in CACHE_PARAM_NAMES}

        def expr_state(e) -> str:
            """RAW if `e` carries cache state that no per-row select has
            masked: a call other than a masked producer that reads cache
            or raw state makes raw state."""
            if isinstance(e, ast.Call):
                if _is_masked_producer(e):
                    return _MASKED
                inner = [expr_state(a) for a in
                         list(e.args) + [k.value for k in e.keywords]]
                inner.append(expr_state(e.func))
                return _RAW if (_RAW in inner or _CACHE in inner) \
                    else _PLAIN
            if isinstance(e, ast.Name):
                return state.get(e.id, _PLAIN)
            if isinstance(e, ast.Lambda):
                return _PLAIN
            worst = _PLAIN
            for c in ast.iter_child_nodes(e):
                s = expr_state(c)
                if s == _RAW:
                    return _RAW
                if s == _CACHE:
                    worst = _CACHE
            return worst

        def writes_cache(target) -> bool:
            base = target
            while isinstance(base, (ast.Subscript, ast.Attribute)):
                base = base.value
            return isinstance(base, ast.Name) \
                and state.get(base.id) in (_CACHE, _RAW)

        for st in _assignments_in_order(fn):
            if st.value is None:
                continue
            new = expr_state(st.value)
            for t in _targets(st):
                if isinstance(t, ast.Subscript) and writes_cache(t):
                    masked = any(isinstance(n, ast.Call)
                                 and _is_masked_producer(n)
                                 for n in ast.walk(st.value))
                    if not masked and not ctx.ann.suppressed(
                            "TL003", st.lineno):
                        out.append(ctx.finding(
                            "TL003", st.lineno,
                            "in-place write to cache state inside a masked "
                            "scan body without a per-row select: padding "
                            "rows would be corrupted; select with "
                            "torch.where(active, ...) or annotate "
                            "`# torchlint: allow-unmasked-write(reason)`"))
                for name in _name_targets(t):
                    state[name] = new

        for node in ast.walk(fn):
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr in INPLACE_METHODS \
                    and writes_cache(node.func.value) \
                    and not ctx.ann.suppressed("TL003", node.lineno):
                out.append(ctx.finding(
                    "TL003", node.lineno,
                    f".{node.func.attr}() on cache state inside a masked "
                    "scan body: padding rows would be corrupted; build a "
                    "new tree through the per-row select"))

        for node in ast.walk(fn):
            if not isinstance(node, ast.Return) or node.value is None:
                continue
            raw = sorted({n.id for n in ast.walk(node.value)
                          if isinstance(n, ast.Name)
                          and state.get(n.id) == _RAW})
            if not raw or ctx.ann.suppressed("TL003", node.lineno):
                continue
            out.append(ctx.finding(
                "TL003", node.lineno,
                f"cache state {raw} escapes the masked scan body without "
                "the per-leaf masked select (tree_map_with_path + "
                "torch.where over the pre-step tree): short and padding "
                "rows would see unmasked writes"))
    return out


# TL002 — concat on the sharded path ----------------------------------------


def check_sharded_concat(ctx: ModuleContext) -> List[Finding]:
    if any(ctx.path.endswith(m) for m in SHARDED_PATH_MODULES):
        spans = [(1, len(ctx.lines) or 1)]
    else:
        spans = [(fn.lineno, fn.end_lineno or fn.lineno)
                 for fn in _functions(ctx.tree)
                 if ctx.ann.scope_marker("sharded-path", fn.lineno)]
    if not spans:
        return []
    out: List[Finding] = []
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        d = _dotted(node.func) or ""
        if d not in CONCAT_CALLS:
            continue
        if not any(lo <= node.lineno <= hi for lo, hi in spans):
            continue
        if ctx.ann.suppressed("TL002", node.lineno):
            continue
        out.append(ctx.finding(
            "TL002", node.lineno,
            f"{d} on the sharded path: a rank holds blocks split over "
            "'data' or 'model', and a concat of local blocks along a split "
            "axis builds a tensor no rank should hold; assemble it with a "
            "collective in sharding/comm.py, or annotate "
            "`# torchlint: allow-concat(reason)` for an axis no mesh "
            "splits"))
    return out


# Driver --------------------------------------------------------------------

PASSES = {
    "TL000": check_annotations,
    "TL001": check_host_sync,
    "TL002": check_sharded_concat,
    "TL003": check_masked_scan_body,
}


def run_passes(ctx: ModuleContext,
               select: Optional[Iterable[str]] = None) -> List[Finding]:
    codes = tuple(select) if select else ALL_CODES
    out: List[Finding] = []
    for code in codes:
        out.extend(PASSES[code](ctx))
    out.sort(key=lambda f: (f.path, f.line, f.code))
    return out
