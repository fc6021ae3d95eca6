"""Annotation grammar shared by the static passes and the runtime marker
(port of ``repro/analysis/contracts.py`` for eager PyTorch).

The serving tick's invariants are declared in source with ``# torchlint:``
comments and the :func:`tick_path` decorator. This module is pure stdlib:
the engine imports it for ``tick_path`` and the lint CLI runs without
torch.

Grammar (one directive per comment, attached to the physical line)::

    # torchlint: tick-path                    scope marker on a ``def`` line
    # torchlint: masked-scan-body             scope marker on a ``def`` line
    # torchlint: sharded-path                 scope marker on a ``def`` line
    # torchlint: allow-sync(reason)           suppress TL001 on this line
    # torchlint: allow-concat(reason)         suppress TL002 on this line
    # torchlint: allow-unmasked-write(reason) suppress TL003 on this line

``allow-*`` directives REQUIRE a non-empty reason; a reasonless
suppression is itself reported (TL000). Scope markers may sit on the
``def`` line or on the line directly above it. Suppressions apply to the
line carrying the flagged expression's first token, or the line directly
above it. The prefix is the port's own, so the reference's lint (which
reads its own prefix) and this one never read each other's directives.
"""
from __future__ import annotations

import io
import re
import tokenize
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple, TypeVar

PREFIX = "torchlint"

SCOPE_MARKERS = frozenset({"tick-path", "masked-scan-body", "sharded-path"})
SUPPRESSIONS = frozenset({"allow-sync", "allow-concat",
                          "allow-unmasked-write"})
KNOWN_DIRECTIVES = SCOPE_MARKERS | SUPPRESSIONS

# Which suppression silences which pass.
SUPPRESSION_FOR_CODE = {
    "TL001": "allow-sync",
    "TL002": "allow-concat",
    "TL003": "allow-unmasked-write",
}

_DIRECTIVE_RE = re.compile(
    r"#\s*" + PREFIX + r":\s*(?P<name>[a-z][a-z0-9-]*)\s*(?:\((?P<arg>[^)]*)\))?"
)


@dataclass(frozen=True)
class Directive:
    """One parsed ``# torchlint:`` comment."""

    name: str
    arg: Optional[str]  # text inside parens, stripped; None if absent
    line: int  # 1-based physical line carrying the comment


@dataclass
class AnnotationIndex:
    """All directives of one source file, indexed for the passes."""

    by_line: Dict[int, List[Directive]] = field(default_factory=dict)
    errors: List[Directive] = field(default_factory=list)  # malformed (TL000)

    def at(self, line: int) -> List[Directive]:
        return self.by_line.get(line, [])

    def suppressed(self, code: str, line: int) -> bool:
        """True if a valid suppression for `code` sits on `line` or `line-1`."""
        want = SUPPRESSION_FOR_CODE.get(code)
        if want is None:
            return False
        return any(d.name == want and d.arg
                   for ln in (line, line - 1) for d in self.at(ln))

    def scope_marker(self, marker: str, def_line: int) -> bool:
        """True if a scope marker sits on the ``def`` line or the line above."""
        return any(d.name == marker
                   for ln in (def_line, def_line - 1) for d in self.at(ln))


def parse_annotations(source: str) -> AnnotationIndex:
    """Extract every ``# torchlint:`` directive from `source`.

    Malformed directives (unknown name, or an ``allow-*`` with a missing
    or empty reason) land in ``index.errors`` for the driver to report as
    TL000; they never suppress anything.
    """
    index = AnnotationIndex()
    for lineno, text in _comments(source):
        if PREFIX not in text:
            continue
        for m in _DIRECTIVE_RE.finditer(text):
            arg = m.group("arg")
            d = Directive(name=m.group("name"),
                          arg=arg.strip() if arg is not None else None,
                          line=lineno)
            bad = d.name not in KNOWN_DIRECTIVES or (
                d.name in SUPPRESSIONS and not d.arg)
            if bad:
                index.errors.append(d)
            else:
                index.by_line.setdefault(lineno, []).append(d)
    return index


def _comments(source: str) -> List[Tuple[int, str]]:
    """(lineno, text) of every real comment token: directives quoted in
    string literals (docstrings showing the grammar) are not annotations.
    Falls back to whole lines if the file does not tokenize."""
    try:
        return [(tok.start[0], tok.string)
                for tok in tokenize.generate_tokens(
                    io.StringIO(source).readline)
                if tok.type == tokenize.COMMENT]
    except (tokenize.TokenError, IndentationError, SyntaxError):
        return list(enumerate(source.splitlines(), start=1))


_F = TypeVar("_F", bound=Callable)


def tick_path(fn: _F) -> _F:
    """Mark `fn` as part of the serving tick: TL001 forbids unannotated
    host syncs inside it. A pure marker: no wrapper frame, no call
    overhead."""
    fn.__torchlint_tick_path__ = True  # type: ignore[attr-defined]
    return fn
