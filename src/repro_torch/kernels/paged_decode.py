"""Paged decode attention kernel wrapper (port of
``repro/kernels/paged_decode.py::paged_decode``).

:func:`paged_decode` launches the hand-written CUDA kernel
(``csrc/paged_decode.cu``) for tensors on a CUDA device and runs
:func:`paged_decode_plain`, its plain PyTorch version, for tensors on the
CPU. Nothing else decides: a CUDA tensor the kernel does not take raises.

Both take an optional ``second`` segment ``(k_pool, v_pool, page_table,
lengths)`` folded into the same softmax — the dual cache's [global ‖
local ring] read. With no second segment this is ``paged_decode``.
Fully masked streams keep the Pallas kernel's handling: the output is
``acc / max(l, 1e-30)``, so a length-0 stream returns 0.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import build

NEG_INF = -1e30

launches = build.LaunchCounter("paged_decode")

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


def paged_decode_plain(q, k_pool, v_pool, page_table, lengths,
                       second: Optional[Segment] = None):
    """q: [N, hd]; pools [P, page, hd]; page_table [N, max_pages] int32;
    lengths [N] -> [N, hd] in q's dtype."""
    logits, v = _segment(q, k_pool, v_pool, page_table, lengths)
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


def paged_decode(q, k_pool, v_pool, page_table, lengths,
                 second: Optional[Segment] = None):
    """Single-query paged decode over one or two segments -> [N, hd]."""
    if q.device.type == "cpu":
        return paged_decode_plain(q, k_pool, v_pool, page_table, lengths,
                                  second)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode: unsupported device {q.device}")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"paged_decode kernel takes float32 or bfloat16, "
                        f"got {q.dtype}")
    if q.ndim != 2 or not q.is_contiguous():
        raise ValueError("paged_decode: q must be a contiguous [N, hd]")
    first = (k_pool, v_pool, page_table, lengths)
    _check_cuda(q, first, "")
    if second is not None:
        _check_cuda(q, second, "second ")
        if second[0].shape[1] != k_pool.shape[1]:
            raise ValueError("paged_decode: both segments need one page size")
    n, hd = q.shape
    out = torch.empty_like(q)
    lib = build.load("paged_decode")
    k2, v2, t2, l2 = (second if second is not None else (None,) * 4)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.paged_decode(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            page_table.data_ptr(), lengths.data_ptr(), page_table.shape[1],
            None if k2 is None else k2.data_ptr(),
            None if v2 is None else v2.data_ptr(),
            None if t2 is None else t2.data_ptr(),
            None if l2 is None else l2.data_ptr(),
            0 if t2 is None else t2.shape[1],
            out.data_ptr(), n, hd, k_pool.shape[1], _DTYPE_CODE[q.dtype],
            stream)
    if rc != 0:
        raise RuntimeError(f"paged_decode kernel launch failed: CUDA error {rc}")
    launches.count += 1
    return out
