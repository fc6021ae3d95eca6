"""Finding records and the accepted-findings baseline (port of
``repro/analysis/findings.py``).

A baseline entry is matched by ``(code, path, stripped source text)``
with a count, NOT by line number: accepted findings survive unrelated
edits that shift lines, but a new occurrence of the same pattern in the
same file still fails the run (the count caps how many may match).
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Tuple

BASELINE_VERSION = 1


@dataclass(frozen=True)
class Finding:
    code: str  # "TL001", "TL003"; "TL000" for annotation errors
    path: str  # as given to the lint, '/'-separated
    line: int  # 1-based
    message: str
    text: str = ""  # stripped source line, used for baseline matching

    def render(self) -> str:
        return f"{self.path}:{self.line}: {self.code} {self.message}"

    def fingerprint(self) -> Tuple[str, str, str]:
        return (self.code, self.path, self.text)


@dataclass
class Baseline:
    """Accepted findings: fingerprint -> allowed count (+ recorded reason)."""

    counts: Dict[Tuple[str, str, str], int] = field(default_factory=dict)
    reasons: Dict[Tuple[str, str, str], str] = field(default_factory=dict)

    def split(self, findings: List[Finding]
              ) -> Tuple[List[Finding], List[Finding]]:
        """Partition into (new, accepted) against this baseline."""
        remaining = dict(self.counts)
        new: List[Finding] = []
        accepted: List[Finding] = []
        for f in findings:
            fp = f.fingerprint()
            if remaining.get(fp, 0) > 0:
                remaining[fp] -= 1
                accepted.append(f)
            else:
                new.append(f)
        return new, accepted


def load_baseline(path: Path) -> Baseline:
    data = json.loads(path.read_text())
    if data.get("version") != BASELINE_VERSION:
        raise ValueError(f"unsupported baseline version "
                         f"{data.get('version')!r} in {path}")
    base = Baseline()
    for entry in data.get("findings", []):
        fp = (entry["code"], entry["path"], entry["text"])
        base.counts[fp] = base.counts.get(fp, 0) + int(entry.get("count", 1))
        if entry.get("reason"):
            base.reasons[fp] = entry["reason"]
    return base


def write_baseline(findings: List[Finding], path: Path,
                   reason: str = "") -> None:
    grouped: Dict[Tuple[str, str, str], int] = {}
    for f in findings:
        fp = f.fingerprint()
        grouped[fp] = grouped.get(fp, 0) + 1
    entries = [{"code": code, "path": p, "text": text, "count": count,
                **({"reason": reason} if reason else {})}
               for (code, p, text), count in sorted(grouped.items())]
    payload = {"version": BASELINE_VERSION, "findings": entries}
    path.write_text(json.dumps(payload, indent=2) + "\n")
