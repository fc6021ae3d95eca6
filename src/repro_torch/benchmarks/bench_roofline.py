"""Table/roofline summary (port of ``benchmarks/bench_roofline.py``):
reads what the port's one-card dry run and roofline sweep wrote
(``repro_torch.launch.dryrun``, ``repro_torch.roofline.run_all``: the
git-ignored ``build/roofline/dryrun.json`` and ``roofline.json``) and
prints the per-(arch x shape) terms against one H100's rates, the
analogue of the paper's Fig. 8 H200 wall-clock table. Runs nothing on a
device."""
from __future__ import annotations

import json
import os

from repro_torch.device import DeviceLike
from repro_torch.launch.dryrun import DRYRUN_JSON
from repro_torch.roofline.analysis import ROOFLINE_JSON


def run(device: DeviceLike = None, roofline_path: str = ROOFLINE_JSON,
        dryrun_path: str = DRYRUN_JSON):
    """``device`` is taken for the runner's sake; the rows come from the
    two files alone."""
    rows = []
    if os.path.exists(roofline_path):
        with open(roofline_path) as f:
            recs = json.load(f)
        for r in sorted(recs, key=lambda x: (x["arch"], x["shape"])):
            if "error" in r:
                rows.append((f"roofline/{r['arch']}/{r['shape']}", 0.0,
                             f"error={str(r['error'])[:40]}"))
                continue
            if r.get("skipped"):  # a pair shape_applicable rules out
                rows.append((f"roofline/{r['arch']}/{r['shape']}", 0.0,
                             f"skipped={str(r.get('reason'))[:40]}"))
                continue
            rows.append((
                f"roofline/{r['arch']}/{r['shape']}", 0.0,
                f"bottleneck={r['bottleneck']},c={r['compute_s']:.4g}s,"
                f"m={r['memory_s']:.4g}s,x={r['collective_s']:.4g}s,"
                f"useful={r['useful_ratio']:.2f}"))
    if os.path.exists(dryrun_path):
        with open(dryrun_path) as f:
            recs = json.load(f)
        full = [r for r in recs if r.get("n_repeats_override") is None]
        ok = sum(1 for r in full if "error" not in r and not r.get("skipped"))
        skip = sum(1 for r in full if r.get("skipped"))
        err = sum(1 for r in full if "error" in r)
        rows.append(("dryrun/summary", 0.0,
                     f"ok={ok},documented_skips={skip},errors={err}"))
    if not rows:
        rows.append(("roofline/missing", 0.0,
                     "run repro_torch.launch.dryrun + "
                     "repro_torch.roofline.run_all first"))
    return rows
