"""The dry-run and roofline tables of one H100, and of rank (0, 0) of the
mesh dry runs, from the records under ``build/roofline/``
(``launch/dryrun.py``, ``roofline/run_all.py``).

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


def mesh_table(recs) -> str:
    """Rank (0, 0) of each mesh dry run: its peak, collective bytes by
    axis (an axis marked * spans more than one 8-card NVLink node, where
    the NVLink price of ``collective_s`` is a least time) and terms."""
    out = ["| arch | shape | mesh | status | peak GiB | collective bytes "
           "by axis | compute s | memory s | collective s | bottleneck |",
           "|---|---|---|---|---|---|---|---|---|---|"]
    for r in sorted(recs, key=lambda x: (x["arch"], x["shape"],
                                         x.get("mesh"))):
        bad = _status(r)
        if bad:
            out.append(f"| {r['arch']} | {r['shape']} | {r.get('mesh')} "
                       f"| {bad} | - | - | - | - | - | - |")
            continue
        c = r["collectives"]
        by = ", ".join(f"{k}{'*' if c['crosses_node'].get(k) else ''} {v:,}"
                       for k, v in c["by_axis"].items()) or "-"
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | ok "
            f"| {_gb(r['memory']['peak_bytes'])} | {by} "
            f"| {r['compute_s']:.4g} | {r['memory_s']:.4g} "
            f"| {r['collective_s']:.4g} | **{r['bottleneck']}** |")
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
    records = _load(args.dryrun)
    dry = {key(r): r for r in roof}
    dry.update({key(r): r for r in records if not r.get("mesh")})
    print("## Dry run (one H100, meta device; peak and argument bytes)\n")
    print(dryrun_table(list(dry.values())))
    mesh = [r for r in records if r.get("mesh")]
    if mesh:
        print("\n## Mesh dry run (rank (0, 0), meta device, fake process "
              "group; * an axis across 8-card nodes)\n")
        print(mesh_table(mesh))
    print("\n## Roofline (one NVIDIA H100 SXM: 3.35 TB/s, 67 / 165 / 989 "
          "TFLOP/s for f32 / 3xTF32 / bf16)\n")
    print(roofline_table(roof))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
