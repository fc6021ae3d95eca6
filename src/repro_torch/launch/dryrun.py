"""The one-card dry run: a step of (arch x input shape) run once under the
work counter, with its memory and cost recorded (port of
``repro/launch/dryrun.py`` for one H100).

    PYTHONPATH=src python -m repro_torch.launch.dryrun \\
        --arch qwen3-0.6b --shape prefill_32k [--wgkv auto|on|off] \\
        [--mesh single|multi] [--out PATH]

The step runs on the ``meta`` device, so it needs no GPU: every tensor is
a shape and a dtype, the kernel wrappers return their outputs' shapes and
report their work (``repro_torch.roofline.work``), and the counter
(``repro_torch.roofline.counter``) counts the aten ops between them.
:func:`run_dryrun` also takes ``device="cuda"`` and weights on the card:
``chip_smoke.py`` runs the same bundle there under the same counter and
holds the two counts equal. ``collectives`` holds the counter's
collective bytes by axis, none on one card. Records are appended to
``build/roofline/dryrun.json`` (git-ignored) or ``--out``.

**The mesh dry run** (``--mesh single``: the reference's 16 x 16;
``multi``: 2 x 16 x 16 across pods) runs rank (0, 0)'s step of the
sharded bundle (``steps.make_bundle(mesh=)``) on ``meta`` as one rank of
torch's ``fake`` process group (``launch.mesh.fake_mesh``): its
collectives return at once and report their bytes by axis. The record
holds that rank's FLOPs by rate class, HBM bytes, launches, peak live
bytes, collective bytes by axis (and which axes cross an 8-card NVLink
node), the roofline terms with the collective term
(``roofline.analysis.roofline_terms``), the knobs and ``in_shardings``.
The port counts every layer, so the reference's ``n_repeats_override``
(its L1/L2 differencing of a ``while`` body XLA counts once) is not
needed and not ported. Without ``--mesh`` the one-card run above.

xlstm's sLSTM runs one Python step per token, far too many ops to count
one by one at these shapes. On ``meta`` its loop does not run
(``models/xlstm.py::_slstm_scan``): the record adds the loop's recurrent
products from ``roofline.analysis.slstm_hidden_flops`` to the f32 FLOPs
(``slstm_hidden_flops`` in the record), as the reference adds them for
its own hidden loop; the loop's elementwise ops, its bytes and its
backward are not counted. On a mesh the rank adds its share: the loop's
products over the ways its batch rows and its xLSTM heads split.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import Any, Dict, Optional, Union

import torch

from repro_torch.configs import ARCH_NAMES, get_config, get_shape, shape_applicable
from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.kernels import ops as OPS
from repro_torch.launch.mesh import fake_mesh, make_production_mesh
from repro_torch.launch.steps import make_bundle
from repro_torch.roofline import analysis as A
from repro_torch.roofline import counter as C
from repro_torch.sharding import rules
from repro_torch.tree import tree_leaves

SHAPE_NAMES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
DRYRUN_JSON = os.path.join(os.path.dirname(A.ROOFLINE_JSON), "dryrun.json")


def tree_bytes(tree) -> int:
    """Bytes of the distinct storages a tree's tensors hold (shapes
    only)."""
    seen: Dict[int, int] = {}
    for x in tree_leaves(tree):
        if isinstance(x, torch.Tensor):
            st = x.untyped_storage()
            seen[st._cdata] = st.nbytes()
    return sum(seen.values())


MESH_NAMES = {"single": "16x16", "multi": "2x16x16"}


def run_dryrun(arch: str, shape: Union[str, InputShape], *,
               use_wgkv: Optional[bool] = None,
               cfg_override: Optional[ModelConfig] = None,
               device="meta", params=None, caches=None,
               knob_overrides: Optional[Dict[str, Any]] = None,
               mesh=None) -> Dict[str, Any]:
    """Runs the step of ``shape`` once on ``device`` under a
    :class:`~repro_torch.roofline.counter.WorkCounter` and returns its
    record: argument bytes (params, train state, caches and inputs, each
    on its own), output and peak live bytes against one H100's
    (``fits_one_h100``), FLOPs by rate class, bytes, and each kernel's
    launches and work. ``params``: weights already on ``device`` (else
    drawn by ``steps.param_structs``); ``caches``, ``knob_overrides``:
    see ``steps.make_bundle``. ``mesh``: None (one card), "single" or
    "multi" (rank (0, 0) of the production mesh on a fake process group,
    on ``meta``), or a :class:`~repro_torch.launch.mesh.Mesh` this process
    is a rank of (its own step, on its device)."""
    if isinstance(mesh, str):
        with fake_mesh(make_production_mesh(
                multi_pod=mesh == "multi")) as m:
            rec = run_dryrun(arch, shape, use_wgkv=use_wgkv,
                             cfg_override=cfg_override,
                             knob_overrides=knob_overrides, mesh=m)
        if not rec.get("skipped"):
            rec["mesh"] = MESH_NAMES[mesh]
        return rec
    cfg = cfg_override if cfg_override is not None else get_config(arch)
    shape = get_shape(shape) if isinstance(shape, str) else shape
    ok, reason = shape_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape.name, "skipped": True,
                "reason": reason}
    if use_wgkv is None:
        use_wgkv = cfg.wgkv.enabled
    if mesh is not None:
        device = mesh.device
    t0 = time.perf_counter()
    bundle = make_bundle(cfg, shape, use_wgkv=use_wgkv, device=device,
                         params=params, caches=caches,
                         knob_overrides=knob_overrides, mesh=mesh)
    args = bundle.args
    if shape.kind == "train":
        parts = {"state": args[0], "inputs": args[-1]}
        if len(args) == 3:
            parts["params"] = args[1]
    elif shape.kind == "prefill":
        parts = {"params": args[0], "inputs": args[1]}
    else:
        parts = {"params": args[0], "caches": args[1], "inputs": args[2]}
    t_build = time.perf_counter() - t0
    # the page tables of a contiguous buffer are cached per process: a
    # count that starts from none does not depend on what ran before
    OPS._identity_tables.cache_clear()
    with C.WorkCounter() as wc:
        out = bundle.fn(*args)
    t_run = time.perf_counter() - t0 - t_build
    cost = wc.record()
    arg_bytes = tree_bytes(list(parts.values()))
    peak = arg_bytes + cost.pop("peak_made_bytes")
    rec: Dict[str, Any] = {
        "arch": arch, "shape": shape.name, "device": str(device),
        "devices": 1 if mesh is None else mesh.size,
        "wgkv": bool(use_wgkv), "kind": shape.kind,
        "knobs": bundle.knobs,
        "build_s": round(t_build, 2), "run_s": round(t_run, 2),
        "memory": {
            "argument_bytes": arg_bytes,
            **{f"{k}_bytes": tree_bytes(v) for k, v in parts.items()},
            "output_bytes": tree_bytes(out),
            "peak_bytes": peak,
            "h100_process_bytes": A.H100_PROCESS_BYTES,
            "fits_one_h100": peak <= A.H100_PROCESS_BYTES,
        },
        "cost": cost,
        "collectives": {"per_chip_bytes": cost.pop("collective_bytes"),
                        "by_axis": cost.pop("collective_bytes_by_axis")},
    }
    slstm = A.slstm_hidden_flops(cfg, shape, _slstm_ways(cfg, shape, mesh))
    if torch.device(device).type == "meta" and slstm and \
            shape.kind != "decode":
        rec["slstm_hidden_flops"] = int(slstm)
        cost["flops"]["f32"] += int(slstm)
    if mesh is not None:
        rec["mesh"] = "x".join(str(v) for v in mesh.shape.values())
        rec["coords"] = mesh.coords
        rec["collectives"]["crosses_node"] = {
            ax: A.crosses_node(mesh.shape, ax)
            for ax in rec["collectives"]["by_axis"]}
        rec["in_shardings"] = {
            "/".join(p): list(sp) for p, sp in rules.specs_by_path(
                bundle.args, bundle.in_shardings).items()}
        rec.update(A.roofline_terms(cost["flops"], cost["bytes"],
                                    rec["collectives"]["per_chip_bytes"]))
    return rec


def _slstm_ways(cfg: ModelConfig, shape: InputShape, mesh) -> int:
    """How many ranks share the sLSTM loop's products: the ways the batch
    rows split times the ways the xLSTM heads split (1 on one card)."""
    if mesh is None:
        return 1
    rows = rules.tokens_spec(mesh.shape, shape.global_batch, 0)[0]
    plan = rules.tp_plan(cfg, mesh.shape)
    return rules._axsize(mesh.shape, rules._axes_of(rows) or None) * \
        (plan.ways if plan.xlstm else 1)


def append_record(rec: Dict[str, Any], path: Optional[str] = None) -> None:
    """Add ``rec`` to the JSON list at ``path`` (default
    ``build/roofline/dryrun.json``), replacing the record of the same
    (arch, shape, device, wgkv)."""
    path = path or DRYRUN_JSON
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    records = []
    if os.path.exists(path):
        with open(path) as f:
            records = json.load(f)

    def key(r):
        return (r["arch"], r["shape"], r.get("device"), r.get("wgkv"),
                r.get("mesh"))
    records = [r for r in records if key(r) != key(rec)]
    records.append(rec)
    with open(path, "w") as f:
        json.dump(records, f, indent=1, default=str)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list(ARCH_NAMES) + ["all"])
    ap.add_argument("--shape", required=True, choices=list(SHAPE_NAMES)
                    + ["all"])
    ap.add_argument("--wgkv", default="auto", choices=["auto", "on", "off"])
    ap.add_argument("--mesh", default=None, choices=list(MESH_NAMES),
                    help="rank (0, 0) of the 16 x 16 (single) or 2 x 16 "
                    "x 16 (multi) mesh on a fake process group; default "
                    "one card")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    archs = list(ARCH_NAMES) if args.arch == "all" else [args.arch]
    shapes = list(SHAPE_NAMES) if args.shape == "all" else [args.shape]
    wg = None if args.wgkv == "auto" else (args.wgkv == "on")
    for arch in archs:
        for shp in shapes:
            try:
                rec = run_dryrun(arch, shp, use_wgkv=wg, mesh=args.mesh)
            except Exception as e:  # record failures: they are bugs to fix
                rec = {"arch": arch, "shape": shp, "device": "meta",
                       "mesh": MESH_NAMES.get(args.mesh),
                       "error": f"{type(e).__name__}: {e}",
                       "traceback": traceback.format_exc()[-2000:]}
            append_record(rec, args.out)
            status = ("SKIP " + rec.get("reason", "")[:40] if rec.get("skipped")
                      else ("ERROR " + rec.get("error", "")[:80] if "error" in rec
                            else f"ok peak={rec['memory']['peak_bytes']}"))
            where = f" ({rec['mesh']})" if rec.get("mesh") else ""
            print(f"[dryrun] {arch} x {shp}{where}: {status}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
