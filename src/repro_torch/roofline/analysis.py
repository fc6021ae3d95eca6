"""Roofline analysis of one H100 from the dry run's counted work (port of
``repro/roofline/analysis.py``).

Terms of a step on one card, from :func:`repro_torch.launch.dryrun.run_dryrun`'s
record (FLOPs by rate class, bytes, collective bytes)::

    compute_s    = sum over rate classes of flops[class] / RATES[class]
    memory_s     = bytes / HBM_BYTES_PER_S
    collective_s = collective bytes / NVLINK_BYTES_PER_S

The reference compiles its step with XLA, whose ``cost_analysis`` counts
a ``while`` body once, so it differences unrolled one- and two-repeat
compiles (its L1/L2 totals). The port runs the step eagerly and its
counter sees every layer's ops, so that differencing is not ported. The
reference parses its collectives out of HLO text; the port's mesh
collectives (``sharding/comm.py``) report their bytes to the counter in
the same ring accounting (``roofline.counter.collective_bytes``), and
NVLink's rate prices them (on one card there are none). On a 16-way axis
that spans two 8-card NVLink nodes (:func:`crosses_node`) part of the
traffic crosses InfiniBand, which is slower: the NVLink price is then
still a least time, so the bound stays a bound.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

from repro_torch.configs.base import InputShape, ModelConfig

# One NVIDIA H100 SXM at its 700 W limit (NVIDIA's data sheet, dense
# rates): HBM3 at 3.35 TB/s; float32 outside the tensor cores 67 TFLOP/s
# (TF32 stays off for parity with the CPU); the kernels' f32 products in
# 3xTF32, three TF32 products each, at 495/3 TFLOP/s; bf16 on the tensor
# cores 989 TFLOP/s; NVLink 4 at 450 GB/s each way.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
TF32_FLOPS = 495e12
TF32X3_FLOPS = TF32_FLOPS / 3
BF16_FLOPS = 989e12
NVLINK_BYTES_PER_S = 450e9
# cards one NVLink domain joins (an 8-card H100 node): a mesh axis whose
# group spans more crosses a node, where InfiniBand is slower than NVLink,
# so NVLINK_BYTES_PER_S still gives a least time there
CARDS_PER_NODE = 8
# the device memory one process gets of an "NVIDIA H100 80GB HBM3"
H100_PROCESS_BYTES = 79 * 2 ** 30

# FLOP rate classes: what a product runs on
RATES = {"f32": F32_FLOPS, "3xtf32": TF32X3_FLOPS, "bf16": BF16_FLOPS}
RATE_LABELS = {"f32": "f32 CUDA cores, 67 TFLOP/s",
               "3xtf32": "3xTF32 tensor cores, 495/3 TFLOP/s",
               "bf16": "bf16 tensor cores, 989 TFLOP/s"}

ROOFLINE_JSON = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                             "build", "roofline", "roofline.json")


# ==========================================================================
# analytic corrections for hidden (in-layer) loops
# ==========================================================================
def slstm_hidden_flops(cfg: ModelConfig, shape: InputShape, devices: int) -> float:
    """sLSTM recurrent matmuls inside the time scan: 4 gates x H block-diag
    [dh x dh] per step => 4 * d_model * dh * 2 flops/token (per layer)."""
    if "slstm" not in cfg.block_pattern:
        return 0.0
    n_slstm = sum(1 for b in cfg.block_pattern if b == "slstm") * cfg.n_repeats
    dh = cfg.d_model // cfg.n_heads
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    flops = n_slstm * tokens * 4 * cfg.d_model * dh * 2
    return flops / devices


def model_flops(cfg: ModelConfig, shape: InputShape) -> float:
    """MODEL_FLOPS = 6*N*D (train) / 2*N*D (inference); N = active params."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        if cfg.arch_type == "audio":
            tokens = shape.global_batch * (
                shape.seq_len // cfg.enc_seq_divisor + cfg.dec_max_len)
        # gate training runs teacher fwd + student fwd + student bwd ≈ 8ND
        return 8.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        if cfg.arch_type == "audio":
            tokens = shape.global_batch * (
                shape.seq_len // cfg.enc_seq_divisor + cfg.dec_max_len)
        return 2.0 * n * tokens
    return 2.0 * n * shape.global_batch  # one decode step


def crosses_node(shape: Dict[str, int], axis: str) -> bool:
    """Whether the group of ``axis`` ("model", "data", "pod+data",
    "world": ``Mesh.axes_key``) of a mesh of ``shape``, its ranks laid
    out row-major over ``CARDS_PER_NODE``-card nodes, spans more than one
    node (rank 0's group; every group of an axis spans alike)."""
    names = list(shape)
    axes = names if axis == "world" else axis.split("+")
    ranks = [0]
    for a in axes:
        stride = 1
        for b in names[names.index(a) + 1:]:
            stride *= shape[b]
        ranks = [r + i * stride for r in ranks for i in range(shape[a])]
    return len({r // CARDS_PER_NODE for r in ranks}) > 1


# ==========================================================================
# terms
# ==========================================================================
def bound_s(flops: Dict[str, int], nbytes: int) -> Dict[str, Any]:
    """The least time one card takes for ``flops`` (by rate class) and
    ``nbytes`` of HBM traffic: the larger of the two terms."""
    comp = sum(f / RATES[c] for c, f in flops.items())
    mem = nbytes / HBM_BYTES_PER_S
    return {"compute_s": comp, "memory_s": mem, "bound_s": max(comp, mem),
            "bound_by": "operations" if comp > mem else "bytes"}


def roofline_terms(flops: Dict[str, int], nbytes: int,
                   collective_bytes: int = 0) -> Dict[str, Any]:
    """``flops`` by rate class (``RATES``' keys), HBM bytes and collective
    bytes -> compute_s, memory_s, collective_s and the bottleneck."""
    b = bound_s(flops, nbytes)
    coll = collective_bytes / NVLINK_BYTES_PER_S
    dominant = max(("compute", b["compute_s"]), ("memory", b["memory_s"]),
                   ("collective", coll), key=lambda kv: kv[1])[0]
    return {"compute_s": b["compute_s"], "memory_s": b["memory_s"],
            "collective_s": coll, "bottleneck": dominant}


def analyze_pair(arch: str, shape_name: str, *,
                 use_wgkv=None) -> Dict[str, Any]:
    """The meta dry run's record of (arch, shape) with its roofline terms,
    ``model_flops`` and ``useful_ratio`` (model FLOPs over the counted
    FLOPs of every rate class) added."""
    from repro_torch.configs import get_config, get_shape
    from repro_torch.launch.dryrun import run_dryrun
    rec = run_dryrun(arch, shape_name, use_wgkv=use_wgkv)
    if rec.get("skipped") or "error" in rec:
        return rec
    cost = rec["cost"]
    rec.update(roofline_terms(cost["flops"], cost["bytes"],
                              rec["collectives"]["per_chip_bytes"]))
    mf = model_flops(get_config(arch), get_shape(shape_name))
    counted = sum(cost["flops"].values())
    rec["model_flops"] = mf
    rec["useful_ratio"] = (mf / counted) if counted else 0.0
    return rec


def append_roofline(rec: Dict[str, Any], path: Optional[str] = None) -> None:
    """Add ``rec`` to the JSON list at ``path`` (default
    ``build/roofline/roofline.json``), replacing the record of the same
    (arch, shape, wgkv)."""
    path = path or ROOFLINE_JSON
    os.makedirs(os.path.dirname(path), exist_ok=True)
    records = []
    if os.path.exists(path):
        with open(path) as f:
            records = json.load(f)
    key = (rec["arch"], rec["shape"], rec.get("wgkv"))
    records = [r for r in records
               if (r["arch"], r["shape"], r.get("wgkv")) != key]
    records.append(rec)
    with open(path, "w") as f:
        json.dump(records, f, indent=1, default=str)
