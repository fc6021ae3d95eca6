"""Chrome-trace / Perfetto JSON export for the serving tracer.

Converts :class:`repro_torch.serving.obs.trace.Tracer` spans into the Chrome
Trace Event Format (the ``{"traceEvents": [...]}`` object form), viewable
in ``chrome://tracing``, https://ui.perfetto.dev, or Speedscope:

  * the engine tick loop is one process ("engine") with one lane of
    nested per-tick phase spans (``memory_sample`` / ``fused_step``
    with its ``selection`` sub-span / ``collect`` / ``evict`` ...);
  * requests are a second process ("requests") with one lane (tid) per
    rid showing the lifecycle ``queued -> prefill[chunk i] -> insert ->
    decode`` plus finish/cancel/deadline instants.

Timestamps are microseconds relative to the earliest span, so traces
from a monotonic clock (whose epoch is arbitrary) render from t=0.

``validate_chrome_trace`` is the structural checker CI runs on emitted
artifacts (also available as a CLI:
``python -m repro_torch.serving.obs.export trace.json [...]`` exits nonzero on
the first invalid file).
"""
from __future__ import annotations

import datetime
import json
import sys
from typing import Dict, Iterable, List, Optional

from repro_torch.serving.obs.trace import (CAT_ENGINE, CAT_REQUEST, LANE_REQ,
                                     LANE_TICK, Span, Tracer)

# artifact schema version: bump when the event layout changes shape
TRACE_SCHEMA_VERSION = 1

_LANE_PID = {LANE_TICK: 1, LANE_REQ: 2}
_PID_NAME = {1: "engine", 2: "requests"}


def _now_iso() -> str:
    return datetime.datetime.now(datetime.timezone.utc).isoformat()


def chrome_trace_events(spans: Iterable[Span]) -> List[Dict]:
    """Spans -> Chrome trace event dicts ("X" complete events, "i"
    instants, plus "M" metadata naming the process/thread lanes)."""
    spans = list(spans)
    if not spans:
        return []
    t_base = min(s.t0 for s in spans)
    events: List[Dict] = []
    seen_lanes = set()
    for s in spans:
        kind, lane_id = s.lane
        pid = _LANE_PID.get(kind, 0)
        tid = int(lane_id)
        if (pid, tid) not in seen_lanes:
            seen_lanes.add((pid, tid))
            events.append({"ph": "M", "name": "process_name", "pid": pid,
                           "tid": 0,
                           "args": {"name": _PID_NAME.get(pid, kind)}})
            tname = f"rid {tid}" if kind == LANE_REQ else "tick loop"
            events.append({"ph": "M", "name": "thread_name", "pid": pid,
                           "tid": tid, "args": {"name": tname}})
        ev = {
            "name": s.name,
            "cat": s.cat,
            "pid": pid,
            "tid": tid,
            "ts": (s.t0 - t_base) * 1e6,        # Chrome traces are in us
        }
        if s.t1 > s.t0:
            ev["ph"] = "X"
            ev["dur"] = (s.t1 - s.t0) * 1e6
        else:
            ev["ph"] = "i"
            ev["s"] = "t"                       # thread-scoped instant
        if s.args:
            ev["args"] = dict(s.args)
        events.append(ev)
    return events


def chrome_trace(tracer: Tracer, *, meta: Optional[Dict] = None) -> Dict:
    """Full Chrome-trace object for a tracer's resident spans (the ring
    is not drained). ``meta`` lands under ``otherData`` next to the
    self-description fields every artifact carries."""
    other = {
        "schema_version": TRACE_SCHEMA_VERSION,
        "generated_at": _now_iso(),
        "spans": len(tracer.spans),
        "spans_emitted": tracer.emitted,
        "spans_dropped": tracer.dropped,   # ring overflow, oldest lost
    }
    if meta:
        other.update(meta)
    return {
        "traceEvents": chrome_trace_events(tracer.spans),
        "displayTimeUnit": "ms",
        "otherData": other,
    }


def write_chrome_trace(tracer: Tracer, path: str, *,
                       meta: Optional[Dict] = None) -> Dict:
    """Serialize :func:`chrome_trace` to ``path``; returns the object."""
    obj = chrome_trace(tracer, meta=meta)
    with open(path, "w") as fh:
        json.dump(obj, fh)
    return obj


# ==========================================================================
# validation (CI gate: emitted artifacts must be structurally sound and
# actually contain both span families)
# ==========================================================================
_REQUIRED_KEYS = ("ph", "name", "pid", "tid")


def validate_chrome_trace(obj: Dict, *, require_lanes: bool = True
                          ) -> List[str]:
    """Structural check of a Chrome-trace object. Returns a list of
    human-readable problems (empty = valid). With ``require_lanes`` both
    a non-empty request lane and a non-empty engine-phase lane must be
    present — a trace missing either would mean the instrumentation
    silently fell off one side of the stack."""
    errs: List[str] = []
    if not isinstance(obj, dict):
        return [f"trace must be a JSON object, got {type(obj).__name__}"]
    events = obj.get("traceEvents")
    if not isinstance(events, list):
        return ["traceEvents missing or not a list"]
    cats = {CAT_ENGINE: 0, CAT_REQUEST: 0}
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            errs.append(f"event {i}: not an object")
            continue
        for k in _REQUIRED_KEYS:
            if k not in ev:
                errs.append(f"event {i}: missing {k!r}")
        ph = ev.get("ph")
        if ph == "X":
            if not isinstance(ev.get("ts"), (int, float)):
                errs.append(f"event {i}: 'X' event without numeric ts")
            if not isinstance(ev.get("dur"), (int, float)) or ev["dur"] < 0:
                errs.append(f"event {i}: 'X' event without numeric dur >= 0")
        if ev.get("cat") in cats and ph in ("X", "i"):
            cats[ev["cat"]] += 1
    if require_lanes:
        if not cats[CAT_ENGINE]:
            errs.append("no engine-phase spans (cat='engine')")
        if not cats[CAT_REQUEST]:
            errs.append("no request lifecycle spans (cat='request')")
    other = obj.get("otherData")
    if not isinstance(other, dict) or "schema_version" not in other \
            or "generated_at" not in other:
        errs.append("otherData.schema_version/generated_at missing "
                    "(artifact not self-describing)")
    return errs


def main(argv: Optional[List[str]] = None) -> int:
    """CLI validator: ``python -m repro_torch.serving.obs.export t1.json ...``"""
    paths = list(sys.argv[1:] if argv is None else argv)
    if not paths:
        print("usage: python -m repro_torch.serving.obs.export TRACE.json [...]",
              file=sys.stderr)
        return 2
    rc = 0
    for path in paths:
        try:
            with open(path) as fh:
                obj = json.load(fh)
        except (OSError, json.JSONDecodeError) as e:
            print(f"{path}: unreadable: {e}", file=sys.stderr)
            rc = 1
            continue
        errs = validate_chrome_trace(obj)
        n = len(obj.get("traceEvents", []) or [])
        if errs:
            rc = 1
            print(f"{path}: INVALID ({n} events)", file=sys.stderr)
            for e in errs[:20]:
                print(f"  - {e}", file=sys.stderr)
        else:
            cats: Dict[str, int] = {}
            for ev in obj["traceEvents"]:
                if ev.get("ph") in ("X", "i"):
                    cats[ev.get("cat", "?")] = cats.get(ev.get("cat", "?"),
                                                        0) + 1
            print(f"{path}: ok ({n} events: "
                  + ", ".join(f"{k}={v}" for k, v in sorted(cats.items()))
                  + ")")
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
