"""Roofline sweep of one H100: every (arch x shape) dry-run on the
``meta`` device, its terms added (``analysis.analyze_pair``). Writes
``build/roofline/roofline.json`` (git-ignored; ``--out`` elsewhere).

    PYTHONPATH=src python -m repro_torch.roofline.run_all [--arch A] [--shape S]

Needs no GPU. A pair ``shape_applicable`` rules out is recorded as
skipped; a failure is recorded with its cause.
"""
import argparse
import traceback

from repro_torch.configs import ARCH_NAMES
from repro_torch.launch.dryrun import SHAPE_NAMES
from repro_torch.roofline.analysis import analyze_pair, append_roofline


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--wgkv", default="auto", choices=["auto", "on", "off"])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    archs = list(ARCH_NAMES) if args.arch == "all" else [args.arch]
    shapes = list(SHAPE_NAMES) if args.shape == "all" else [args.shape]
    wg = None if args.wgkv == "auto" else (args.wgkv == "on")
    for arch in archs:
        for shp in shapes:
            try:
                rec = analyze_pair(arch, shp, use_wgkv=wg)
            except Exception as e:  # record failures: they are bugs to fix
                rec = {"arch": arch, "shape": shp, "wgkv": wg,
                       "error": f"{type(e).__name__}: {e}",
                       "traceback": traceback.format_exc()[-1500:]}
            append_roofline(rec, args.out)
            if rec.get("skipped"):
                print(f"[roofline] {arch} x {shp}: SKIP {rec['reason']}",
                      flush=True)
            elif "error" in rec:
                print(f"[roofline] {arch} x {shp}: ERROR {rec['error']}",
                      flush=True)
            else:
                print(f"[roofline] {arch} x {shp}: {rec['bottleneck']} "
                      f"c={rec['compute_s']:.4f}s m={rec['memory_s']:.4f}s "
                      f"x={rec['collective_s']:.4f}s "
                      f"ratio={rec['useful_ratio']:.2f} ({rec['run_s']} s)",
                      flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
