"""The dry-run and roofline tables of one H100, from the records under
``build/roofline/`` (``launch/dryrun.py``, ``roofline/run_all.py``).

    PYTHONPATH=src python -m repro_torch.roofline.report [--dryrun PATH] \\
        [--roofline PATH]

A sweep's records (``run_all``) hold the dry run's fields too: the
dry-run table shows them beside the records of ``dryrun.json`` (which
win for the same arch, shape and WG-KV setting).
"""
from __future__ import annotations

import argparse
import json
import os

from repro_torch.launch.dryrun import DRYRUN_JSON
from repro_torch.roofline.analysis import ROOFLINE_JSON


def _load(path):
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return json.load(f)


def _gb(x):
    return f"{x / 2**30:.2f}" if x is not None else "-"


def _status(r):
    if r.get("skipped"):
        return "SKIP (shape_applicable)"
    if "error" in r:
        return f"ERROR {str(r['error'])[:60]}"
    return None


def dryrun_table(recs) -> str:
    out = ["| arch | shape | wgkv | status | peak GiB | args GiB | params "
           "GiB | caches GiB | fits one H100 | kernel launches | run s |",
           "|---|---|---|---|---|---|---|---|---|---|---|"]
    for r in sorted(recs, key=lambda x: (x["arch"], x["shape"])):
        bad = _status(r)
        if bad:
            out.append(f"| {r['arch']} | {r['shape']} | {r.get('wgkv', '-')} "
                       f"| {bad} | - | - | - | - | - | - | - |")
            continue
        m = r["memory"]
        launches = ", ".join(f"{k} {v['launches']}"
                             for k, v in r["cost"]["kernels"].items()) or "-"
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['wgkv']} | ok "
            f"| {_gb(m['peak_bytes'])} | {_gb(m['argument_bytes'])} "
            f"| {_gb(m.get('params_bytes'))} | {_gb(m.get('caches_bytes'))} "
            f"| {m['fits_one_h100']} | {launches} | {r['run_s']} |")
    return "\n".join(out)


def roofline_table(recs) -> str:
    out = ["| arch | shape | compute s | memory s | collective s | "
           "bottleneck | MODEL_FLOPS | useful | kernel share of bytes |",
           "|---|---|---|---|---|---|---|---|---|"]
    for r in sorted(recs, key=lambda x: (x["arch"], x["shape"])):
        bad = _status(r)
        if bad:
            out.append(f"| {r['arch']} | {r['shape']} | - | - | - | {bad} "
                       f"| - | - | - |")
            continue
        kb = sum(k["bytes"] for k in r["cost"]["kernels"].values())
        share = kb / r["cost"]["bytes"] if r["cost"]["bytes"] else 0.0
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['compute_s']:.4g} "
            f"| {r['memory_s']:.4g} | {r['collective_s']:.4g} "
            f"| **{r['bottleneck']}** | {r['model_flops']:.3g} "
            f"| {r['useful_ratio']:.2f} | {share:.2f} |")
    return "\n".join(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dryrun", default=DRYRUN_JSON)
    ap.add_argument("--roofline", default=ROOFLINE_JSON)
    args = ap.parse_args(argv)
    roof = _load(args.roofline)

    def key(r):
        return (r["arch"], r["shape"], r.get("wgkv"))
    dry = {key(r): r for r in roof}
    dry.update({key(r): r for r in _load(args.dryrun)})
    print("## Dry run (one H100, meta device; peak and argument bytes)\n")
    print(dryrun_table(list(dry.values())))
    print("\n## Roofline (one NVIDIA H100 SXM: 3.35 TB/s, 67 / 165 / 989 "
          "TFLOP/s for f32 / 3xTF32 / bf16)\n")
    print(roofline_table(roof))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
