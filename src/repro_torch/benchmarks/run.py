"""One function per paper table/figure (port of ``benchmarks/run.py``).
Prints the device line, then ``name,us_per_call,derived`` CSV rows.

    PYTHONPATH=src python -m repro_torch.benchmarks.run [--only fig7,fig8] \\
        [--device cpu]

Modules:
  fig1   attention-bottleneck scaling          (paper Fig. 1)
  fig7   memory-accuracy vs static admission   (paper Fig. 7 / Fig. 14)
  fig8   efficiency at 75% sparsity            (paper Fig. 8 / Fig. 15)
  fig9   Quest (Selection) composability       (paper Fig. 9)
  fig10  SnapKV (Eviction) synergy             (paper Fig. 10 / Fig. 16)
  fig11  lambda/tau Pareto frontier            (paper Fig. 11)
  fig12  local-cache ablation                  (paper Fig. 12)
  fig13  input-dependent admission patterns    (paper Fig. 13)
  roofline  the one-card dry run's roofline table (paper Fig. 8 analogue)
  serving   backend A/B trace replay: wgkv vs dense under one orchestrator
            (bench_serving --backends wgkv,dense --smoke; its record goes
            to --serving-json, by default in the temp dir: the committed
            BENCH_serving_torch.json is written by bench_serving alone)

Every module runs on ``--device`` (default ``cuda``; no fallback to the
host). A module that raises prints an ``_error`` row, and the run exits 1.
"""
import argparse
import importlib
import os
import sys
import tempfile
import time
import traceback

from repro_torch.benchmarks.common import device_label
from repro_torch.device import resolve_device

MODULES = {
    "fig1": "repro_torch.benchmarks.bench_fig1_bottleneck",
    "fig7": "repro_torch.benchmarks.bench_fig7_memory_accuracy",
    "fig8": "repro_torch.benchmarks.bench_fig8_efficiency",
    "fig9": "repro_torch.benchmarks.bench_fig9_quest",
    "fig10": "repro_torch.benchmarks.bench_fig10_eviction",
    "fig11": "repro_torch.benchmarks.bench_fig11_pareto",
    "fig12": "repro_torch.benchmarks.bench_fig12_local_cache",
    "fig13": "repro_torch.benchmarks.bench_fig13_patterns",
    "roofline": "repro_torch.benchmarks.bench_roofline",
    "serving": "repro_torch.benchmarks.bench_serving",
}

# per-module run() kwargs: the serving A/B path runs headlessly on the
# smoke trace so every benchmark sweep exercises the multi-backend replay
MODULE_KWARGS = {
    "serving": {"backends": ("wgkv", "dense"), "smoke": True},
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.benchmarks.run")
    ap.add_argument("--only", default=None,
                    help="comma-separated subset of " + ",".join(MODULES))
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain PyTorch path)")
    ap.add_argument("--serving-json", metavar="PATH",
                    default=os.path.join(tempfile.gettempdir(),
                                         "BENCH_serving_torch.json"),
                    help="where the serving module writes its record")
    args = ap.parse_args(argv)
    names = list(MODULES) if not args.only else args.only.split(",")
    kwargs = {name: dict(kw) for name, kw in MODULE_KWARGS.items()}
    kwargs["serving"]["json_path"] = args.serving_json
    dev = resolve_device(args.device)
    print(device_label(dev))
    print("name,us_per_call,derived")
    failures = 0
    for name in names:
        t0 = time.time()
        try:
            mod = importlib.import_module(MODULES[name])
            rows = mod.run(device=dev, **kwargs.get(name, {}))
            for r, us, derived in rows:
                print(f"{r},{us:.1f},{derived}", flush=True)
            print(f"{name}/_wall_s,{(time.time() - t0) * 1e6:.0f},module_total",
                  flush=True)
        except Exception:
            failures += 1
            print(f"{name}/_error,0,{traceback.format_exc(limit=2)!r}",
                  flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
