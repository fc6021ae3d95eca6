"""Budgeted vertical-slash prefill kernel wrapper (port of
``repro/kernels/vertical_slash.py::vertical_slash``, paper §4.2).

:func:`vertical_slash` launches the hand-written CUDA kernel
(``csrc/vertical_slash.cu``) for tensors on a CUDA device and runs
:func:`vertical_slash_plain`, its plain PyTorch version, for tensors on
the CPU. Nothing else decides: a CUDA tensor the kernel does not take
raises.

Query i sees its local window (i - W < j <= i) of its own sequence and
the pre-gathered global tokens with ``gpos <= i - W``, in one softmax.
``group`` query streams share one kv stream (GQA): query stream n reads
kv stream ``n // group``, so K, V and the globals are never repeated.
Rows that see no key keep the Pallas kernel's handling (``m_safe``, zero
``alpha``, ``acc / max(l, 1e-30)``): they return 0. The kernel is
forward-only: on CUDA an input that requires grad (with grad enabled)
raises rather than yield an output without a graph.

On the ``meta`` device it returns an empty output of the right shape and
dtype: no plain version runs, no kernel, no check of what the kernel
takes. While a :class:`repro_torch.roofline.counter.WorkCounter` is
active, every call on any device reports its work from its shapes
(:func:`repro_torch.roofline.counter.counted`).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.roofline import counter
from repro_torch.roofline import work as W

NEG_INF = -1e30

launches = build.LaunchCounter("vertical_slash")

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def vertical_slash_plain(q, k, v, kg, vg, gpos, *, w_local: int,
                         group: int = 1):
    """q: [Nq, S, hd]; k, v: [Nq/group, S, hd]; kg, vg: [Nq/group, C, hd];
    gpos: [Nq/group, C] int32 -> [Nq, S, hd] in q's dtype (f32 math)."""
    nq, s, hd = q.shape
    nk = nq // group
    dev = q.device
    qg = q.reshape(nk, group, s, hd).float()
    scale = hd ** -0.5
    qi = torch.arange(s, device=dev)[:, None]
    kj = torch.arange(s, device=dev)[None, :]
    local_ok = (qi >= kj) & (qi - kj < w_local)
    l1 = torch.einsum("ngqd,nkd->ngqk", qg, k.float()) * scale
    l1 = torch.where(local_ok, l1, torch.full_like(l1, NEG_INF))
    l2 = torch.einsum("ngqd,ncd->ngqc", qg, kg.float()) * scale
    vis = gpos[:, None, None, :] <= (qi[None, None] - w_local)
    l2 = torch.where(vis, l2, torch.full_like(l2, NEG_INF))
    logits = torch.cat([l1, l2], dim=-1)
    m = logits.amax(dim=-1, keepdim=True)
    m_safe = torch.where(m <= NEG_INF / 2, torch.zeros_like(m), m)
    p = torch.exp(logits - m_safe)
    denom = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = (torch.einsum("ngqk,nkd->ngqd", p[..., :s], v.float())
           + torch.einsum("ngqc,ncd->ngqd", p[..., s:], vg.float())) / denom
    return out.reshape(nq, s, hd).to(q.dtype)


def _check_cuda(q, k, v, kg, vg, gpos, group: int) -> None:
    nq, s, hd = q.shape
    build.refuse_grad("vertical_slash", (q, k, v, kg, vg))
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"vertical_slash kernel takes float32 or bfloat16, "
                        f"got {q.dtype}")
    if not 0 < hd <= 256 or hd % 8:
        raise ValueError(f"vertical_slash kernel takes hd <= 256, a "
                         f"multiple of 8, got {hd}")
    if group < 1 or nq % group:
        raise ValueError(f"vertical_slash: {nq} query streams are not a "
                         f"multiple of group {group}")
    nk = nq // group
    c = kg.shape[1] if kg.ndim == 3 else -1
    want = {"k": (k, (nk, s, hd)), "v": (v, (nk, s, hd)),
            "kg": (kg, (nk, c, hd)), "vg": (vg, (nk, c, hd)),
            "gpos": (gpos, (nk, c))}
    for name, (t, shape) in want.items():
        if t.device != q.device:
            raise ValueError(f"vertical_slash: {name} on {t.device}, q on "
                             f"{q.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"vertical_slash: {name} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"vertical_slash: {name} must be contiguous")
        if name != "gpos" and t.dtype != q.dtype:
            raise TypeError(f"vertical_slash: {name} is {t.dtype}, q is "
                            f"{q.dtype}")
        if name != "gpos" and t.numel() and t.data_ptr() % 16:
            raise ValueError(f"vertical_slash: {name} must be 16-byte "
                             f"aligned")
    if gpos.dtype != torch.int32:
        raise TypeError("vertical_slash: gpos must be int32")
    if not q.is_contiguous():
        raise ValueError("vertical_slash: q must be contiguous")
    if q.data_ptr() % 16:
        raise ValueError("vertical_slash: q must be 16-byte aligned")


@counter.counted("vertical_slash",
                 lambda q, k, v, kg, vg, gpos, *, w_local, group=1:
                 W.vertical_slash(*q.shape, group, kg.shape[1], w_local,
                                  q.element_size()))
def vertical_slash(q, k, v, kg, vg, gpos, *, w_local: int, group: int = 1):
    """Budgeted vertical-slash prefill attention -> [Nq, S, hd]."""
    if q.device.type == "cpu":
        return vertical_slash_plain(q, k, v, kg, vg, gpos, w_local=w_local,
                                    group=group)
    if q.device.type == "meta":
        return torch.empty_like(q)
    if q.device.type != "cuda":
        raise ValueError(f"vertical_slash: unsupported device {q.device}")
    if q.ndim != 3:
        raise ValueError("vertical_slash: q must be [Nq, S, hd]")
    _check_cuda(q, k, v, kg, vg, gpos, group)
    nq, s, hd = q.shape
    out = torch.empty_like(q)
    lib = build.load("vertical_slash")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.vertical_slash(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), kg.data_ptr(),
            vg.data_ptr(), gpos.data_ptr(), out.data_ptr(), nq, s,
            kg.shape[1], hd, w_local, group, _DTYPE_CODE[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"vertical_slash kernel launch failed: CUDA "
                           f"error {rc}")
    launches.count += 1
    return out
