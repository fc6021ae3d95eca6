"""Paged decode attention kernel wrappers (port of
``repro/kernels/paged_decode.py``: ``paged_decode`` and
``paged_decode_selected``).

:func:`paged_decode` and :func:`paged_decode_selected` launch the
hand-written CUDA kernels (``csrc/paged_decode.cu``) for tensors on a CUDA
device and run their plain PyTorch versions (:func:`paged_decode_plain`,
:func:`paged_decode_selected_plain`) for tensors on the CPU. Nothing else
decides: a CUDA tensor the kernel does not take raises.

All take an optional ``second`` segment ``(k_pool, v_pool, page_table,
lengths)`` folded into the same softmax — the dual cache's [global ‖
local ring] read. The selected read walks only the pages ``sel_ids``
[N, K] (logical ids, ascending, the first ``n_sel[n]`` valid) of the
first segment; the second is read whole. Fully masked streams keep the
Pallas kernel's handling: the output is ``acc / max(l, 1e-30)``, so a
length-0 stream returns 0.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import build

NEG_INF = -1e30

launches = build.LaunchCounter("paged_decode")
selected_launches = build.LaunchCounter("paged_decode_selected")

Segment = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _segment(q, k_pool, v_pool, page_table, lengths):
    n, hd = q.shape
    _, page, _ = k_pool.shape
    mp = page_table.shape[1]
    tbl = page_table.long()
    k = k_pool[tbl].reshape(n, mp * page, hd)
    v = v_pool[tbl].reshape(n, mp * page, hd)
    pos = torch.arange(mp * page, device=q.device)[None]
    valid = pos < lengths[:, None]
    logits = torch.einsum("nd,nkd->nk", q.float(), k.float()) * (hd ** -0.5)
    return torch.where(valid, logits, torch.full_like(logits, NEG_INF)), v


def _selected_segment(q, k_pool, v_pool, page_table, lengths, sel_ids,
                      n_sel):
    """:func:`_segment` over the selected pages: at the identity ids with
    every page valid it builds the same tensors in the same order."""
    n, hd = q.shape
    _, page, _ = k_pool.shape
    kp = sel_ids.shape[1]
    sel = sel_ids.long()
    phys = torch.gather(page_table.long(), 1, sel)
    k = k_pool[phys].reshape(n, kp * page, hd)
    v = v_pool[phys].reshape(n, kp * page, hd)
    pos = (sel[:, :, None] * page
           + torch.arange(page, device=q.device)[None, None]).reshape(n, -1)
    page_ok = torch.arange(kp, device=q.device)[None] < n_sel[:, None]
    valid = (pos < lengths[:, None]) & page_ok.repeat_interleave(page, dim=1)
    logits = torch.einsum("nd,nkd->nk", q.float(), k.float()) * (hd ** -0.5)
    return torch.where(valid, logits, torch.full_like(logits, NEG_INF)), v


def _combine(q, logits, v, second: Optional[Segment]):
    if second is not None:
        l2, v2 = _segment(q, *second)
        logits = torch.cat([logits, l2], dim=1)
        v = torch.cat([v, v2], dim=1)
    m = logits.amax(dim=-1, keepdim=True)
    m_safe = torch.where(m <= NEG_INF / 2, torch.zeros_like(m), m)
    p = torch.exp(logits - m_safe)
    denom = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("nk,nkd->nd", p, v.float()) / denom
    return out.to(q.dtype)


def paged_decode_plain(q, k_pool, v_pool, page_table, lengths,
                       second: Optional[Segment] = None):
    """q: [N, hd]; pools [P, page, hd]; page_table [N, max_pages] int32;
    lengths [N] -> [N, hd] in q's dtype."""
    logits, v = _segment(q, k_pool, v_pool, page_table, lengths)
    return _combine(q, logits, v, second)


def paged_decode_selected_plain(q, k_pool, v_pool, page_table, lengths,
                                sel_ids, n_sel,
                                second: Optional[Segment] = None):
    """As :func:`paged_decode_plain` with the first segment read through
    ``sel_ids`` [N, K] int32 / ``n_sel`` [N] int32. At the identity ids
    (K covering every page) it is bitwise equal to
    :func:`paged_decode_plain`."""
    logits, v = _selected_segment(q, k_pool, v_pool, page_table, lengths,
                                  sel_ids, n_sel)
    return _combine(q, logits, v, second)


def _check_cuda(q, seg: Segment, tag: str) -> None:
    k_pool, v_pool, table, lengths = seg
    n, hd = q.shape
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool),
                    ("page_table", table), ("lengths", lengths)):
        if t.device != q.device:
            raise ValueError(f"paged_decode: {tag}{name} on {t.device}, "
                             f"q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"paged_decode: {tag}{name} must be contiguous")
    if k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise TypeError(f"paged_decode: {tag}pools must be {q.dtype}")
    if k_pool.shape != v_pool.shape or k_pool.ndim != 3 \
            or k_pool.shape[2] != hd:
        raise ValueError(f"paged_decode: {tag}pools {tuple(k_pool.shape)} do "
                         f"not match [P, page, {hd}]")
    if table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError(f"paged_decode: {tag}page_table and lengths must be "
                        "int32")
    if table.ndim != 2 or table.shape[0] != n or tuple(lengths.shape) != (n,):
        raise ValueError(f"paged_decode: {tag}page_table {tuple(table.shape)}"
                         f" / lengths {tuple(lengths.shape)} do not match "
                         f"{n} streams")


def _check_launch(q, first: Segment, second: Optional[Segment]) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode: unsupported device {q.device}")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"paged_decode kernel takes float32 or bfloat16, "
                        f"got {q.dtype}")
    if q.ndim != 2 or not q.is_contiguous():
        raise ValueError("paged_decode: q must be a contiguous [N, hd]")
    _check_cuda(q, first, "")
    if second is not None:
        _check_cuda(q, second, "second ")
        if second[0].shape[1] != first[0].shape[1]:
            raise ValueError("paged_decode: both segments need one page size")


def _second_args(second: Optional[Segment]):
    if second is None:
        return (None, None, None, None, 0)
    k2, v2, t2, l2 = second
    return (k2.data_ptr(), v2.data_ptr(), t2.data_ptr(), l2.data_ptr(),
            t2.shape[1])


def paged_decode(q, k_pool, v_pool, page_table, lengths,
                 second: Optional[Segment] = None):
    """Single-query paged decode over one or two segments -> [N, hd]."""
    if q.device.type == "cpu":
        return paged_decode_plain(q, k_pool, v_pool, page_table, lengths,
                                  second)
    _check_launch(q, (k_pool, v_pool, page_table, lengths), second)
    n, hd = q.shape
    out = torch.empty_like(q)
    lib = build.load("paged_decode")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.paged_decode(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            page_table.data_ptr(), lengths.data_ptr(), page_table.shape[1],
            *_second_args(second),
            out.data_ptr(), n, hd, k_pool.shape[1], _DTYPE_CODE[q.dtype],
            stream)
    if rc != 0:
        raise RuntimeError(f"paged_decode kernel launch failed: CUDA error {rc}")
    launches.count += 1
    return out


def paged_decode_selected(q, k_pool, v_pool, page_table, lengths, sel_ids,
                          n_sel, second: Optional[Segment] = None):
    """Quest-selected single-query paged decode -> [N, hd]: the first
    segment read through only the pages ``sel_ids`` [N, K] int32
    (ascending logical ids) of which the first ``n_sel`` [N] int32 are
    valid; ``second`` read whole."""
    if q.device.type == "cpu":
        return paged_decode_selected_plain(q, k_pool, v_pool, page_table,
                                           lengths, sel_ids, n_sel, second)
    _check_launch(q, (k_pool, v_pool, page_table, lengths), second)
    n, hd = q.shape
    for name, t in (("sel_ids", sel_ids), ("n_sel", n_sel)):
        if t.device != q.device or t.dtype != torch.int32 \
                or not t.is_contiguous():
            raise ValueError(f"paged_decode_selected: {name} must be a "
                             f"contiguous int32 tensor on {q.device}")
    if sel_ids.ndim != 2 or sel_ids.shape[0] != n or sel_ids.shape[1] < 1 \
            or tuple(n_sel.shape) != (n,):
        raise ValueError(f"paged_decode_selected: sel_ids "
                         f"{tuple(sel_ids.shape)} / n_sel "
                         f"{tuple(n_sel.shape)} do not match {n} streams")
    out = torch.empty_like(q)
    lib = build.load("paged_decode")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.paged_decode_selected(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            page_table.data_ptr(), lengths.data_ptr(), page_table.shape[1],
            sel_ids.data_ptr(), n_sel.data_ptr(), sel_ids.shape[1],
            *_second_args(second),
            out.data_ptr(), n, hd, k_pool.shape[1], _DTYPE_CODE[q.dtype],
            stream)
    if rc != 0:
        raise RuntimeError(f"paged_decode_selected kernel launch failed: "
                           f"CUDA error {rc}")
    selected_launches.count += 1
    return out
