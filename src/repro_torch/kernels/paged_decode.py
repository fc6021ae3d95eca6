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
[Nkv, K] (logical ids, ascending, the first ``n_sel`` valid) of the
first segment; the second is read whole. Fully masked streams keep the
Pallas kernel's handling: the output is ``acc / max(l, 1e-30)``, so a
length-0 stream returns 0.

``group`` query rows share one kv stream (GQA, rows ordered (kv stream,
head)): tables, lengths, ids and counts are given per kv stream, [N /
group, ...], and the kernel stages each page once for the whole group.
``group=1`` is the reference's layout, one table row per query row.

:func:`paged_decode` also takes ``starts`` [N / group] int32 and ``span``
(the dense baseline's windowed read): the first segment of a kv stream
is then read over [starts, min(lengths, starts + span)) only, its walk
beginning at the page of the start and covering the pages ``span`` tokens
can touch (:func:`start_walk`), so pages below the start or past the
window are never walked. Those launches count in ``start_launches``.

The kernel cuts each kv stream's walk [segment 1 pages ‖ segment 2
pages] into splits (:func:`split_plan`, a function of shapes only) that
run in parallel and are combined in a fixed order. Both kernels are
forward-only: on CUDA a query or pool that requires grad (with grad
enabled) raises rather than yield an output without a graph.

:func:`paged_decode` and :func:`paged_decode_selected` with ``lse=True``
also return the read's log-sum-exp per query row in f32, ``m + log(l)``
of the online softmax (scores scaled by hd^-1/2), and -inf for a row
that read no key (whose output is 0): the context-parallel decode
combines the "data" ranks' reads of their blocks of a seq-sharded cache
by it (``sharding.comm.combine_lse``).

On the ``meta`` device both return an empty output of the right shape
and dtype: no plain version runs, no kernel, no check of what the kernel
takes. While a :class:`repro_torch.roofline.counter.WorkCounter` is
active, every call on any device reports its work from its shapes
(:func:`repro_torch.roofline.counter.counted`).
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.roofline import counter
from repro_torch.roofline import work as W

NEG_INF = -1e30

launches = build.LaunchCounter("paged_decode")
selected_launches = build.LaunchCounter("paged_decode_selected")
start_launches = build.LaunchCounter("paged_decode_starts")

Segment = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

PAGE = 16            # tokens per page (the kernel's fixed page)
SMS = 132            # streaming multiprocessors of an H100 SXM
TARGET_CTAS = 2 * SMS
MAX_PAGES_PER_SPLIT = 4  # a longer walk per CTA waits on its loads
_THREADS = 128       # threads of a split CTA (csrc/paged_decode.cu)
_MAX_ACC = 8         # float4 accumulators per thread


class SplitPlan(NamedTuple):
    pages_per_split: int   # walk positions each split CTA covers
    n_splits: int
    heads: int             # query heads per CTA (of the group)


def max_heads(hd: int) -> int:
    """Query heads one CTA holds at head dim ``hd``: each of its threads
    owns a float4 column of the output for up to 8 heads."""
    return (_THREADS // (hd // 4)) * _MAX_ACC


@functools.lru_cache(maxsize=256)
def split_plan(walk_pages: int, kv_streams: int, group: int,
               hd: int) -> SplitPlan:
    """The kernel's split of a walk of ``walk_pages`` positions (segment
    1's pages, or its K selected ids, then segment 2's) for
    ``kv_streams`` kv streams of ``group`` heads at head dim ``hd``.
    Shapes only, never lengths or ids (reading them would sync the host):
    splits of equal size, enough for about two CTAs per SM, and at most
    ``MAX_PAGES_PER_SPLIT`` pages each."""
    chunks = -(-group // max_heads(hd))
    heads = -(-group // chunks)
    walk = max(walk_pages, 1)
    pps = min(MAX_PAGES_PER_SPLIT,
              max(1, math.ceil(walk * kv_streams * chunks / TARGET_CTAS)))
    return SplitPlan(pps, -(-walk // pps), heads)


def start_walk(max_pages: int, span: int) -> int:
    """Walk positions of a first segment read from a start offset: the
    pages ``span`` tokens can touch from any offset in their first page,
    at most the table's width."""
    return min(max_pages, (span + 2 * PAGE - 2) // PAGE)


def walk_plan(q, page_table, second: Optional[Segment] = None, *,
              group: int = 1, sel_ids=None,
              span: Optional[int] = None) -> SplitPlan:
    """The split plan a wrapper launches with: the walk is segment 1's
    table width (or the K of ``sel_ids``, or :func:`start_walk` of
    ``span`` when read from a start) plus segment 2's, so the selected
    read at K = every page gets paged_decode's plan."""
    first = page_table.shape[1] if sel_ids is None else sel_ids.shape[1]
    if span is not None:
        first = start_walk(first, span)
    walk = first + (second[2].shape[1] if second is not None else 0)
    return split_plan(walk, q.shape[0] // group, group, q.shape[1])


def _per_query(t: torch.Tensor, group: int) -> torch.Tensor:
    return t if group == 1 else t.repeat_interleave(group, dim=0)


def _per_query_segment(seg: Optional[Segment], group: int):
    if seg is None or group == 1:
        return seg
    k, v, tbl, lens = seg
    return k, v, _per_query(tbl, group), _per_query(lens, group)


def _segment(q, k_pool, v_pool, page_table, lengths, starts=None,
             span: Optional[int] = None):
    n, hd = q.shape
    _, page, _ = k_pool.shape
    mp = page_table.shape[1]
    tbl = page_table.long()
    k = k_pool[tbl].reshape(n, mp * page, hd)
    v = v_pool[tbl].reshape(n, mp * page, hd)
    pos = torch.arange(mp * page, device=q.device)[None]
    valid = pos < lengths[:, None]
    if starts is not None:
        first = starts.clamp_min(0)[:, None]
        valid = valid & (pos >= first) & (pos < first + span)
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
    """-> (out [N, hd] in q's dtype, lse [N] f32)."""
    if second is not None:
        l2, v2 = _segment(q, *second)
        logits = torch.cat([logits, l2], dim=1)
        v = torch.cat([v, v2], dim=1)
    m = logits.amax(dim=-1, keepdim=True)
    m_safe = torch.where(m <= NEG_INF / 2, torch.zeros_like(m), m)
    p = torch.exp(logits - m_safe)
    psum = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("nk,nkd->nd", p, v.float()) / psum.clamp_min(1e-30)
    lse = torch.where(psum > 0, m_safe + torch.log(psum),
                      torch.full_like(psum, -math.inf))[:, 0]
    return out.to(q.dtype), lse


def paged_decode_plain(q, k_pool, v_pool, page_table, lengths,
                       second: Optional[Segment] = None, *, group: int = 1,
                       starts=None, span: Optional[int] = None,
                       lse: bool = False):
    """q: [N, hd]; pools [P, page, hd]; page_table [N / group, max_pages]
    int32; lengths [N / group] -> [N, hd] in q's dtype (and, with
    ``lse``, the log-sum-exp [N] f32). With ``starts`` [N / group] int32
    and ``span``, the first segment is read over [starts, min(lengths,
    starts + span))."""
    if starts is not None:
        starts = _per_query(starts, group)
    logits, v = _segment(q, k_pool, v_pool, _per_query(page_table, group),
                         _per_query(lengths, group), starts, span)
    out, l_se = _combine(q, logits, v, _per_query_segment(second, group))
    return (out, l_se) if lse else out


def paged_decode_selected_plain(q, k_pool, v_pool, page_table, lengths,
                                sel_ids, n_sel,
                                second: Optional[Segment] = None, *,
                                group: int = 1, lse: bool = False):
    """As :func:`paged_decode_plain` with the first segment read through
    ``sel_ids`` [N / group, K] int32 / ``n_sel`` [N / group] int32 (and,
    with ``lse``, the log-sum-exp [N] f32 too). At the identity ids (K
    covering every page) it is bitwise equal to
    :func:`paged_decode_plain`."""
    logits, v = _selected_segment(
        q, k_pool, v_pool, _per_query(page_table, group),
        _per_query(lengths, group), _per_query(sel_ids, group),
        _per_query(n_sel, group))
    out, l_se = _combine(q, logits, v, _per_query_segment(second, group))
    return (out, l_se) if lse else out


def _check_cuda(q, seg: Segment, tag: str, n: int) -> None:
    k_pool, v_pool, table, lengths = seg
    hd = q.shape[1]
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
                         f"{n} kv streams")
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool)):
        if t.data_ptr() % 16:
            raise ValueError(f"paged_decode: {tag}{name} must be 16-byte "
                             "aligned")


def _check_launch(q, first: Segment, second: Optional[Segment],
                  group: int) -> int:
    """Checks what the kernel takes; returns the number of kv streams."""
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode: unsupported device {q.device}")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"paged_decode kernel takes float32 or bfloat16, "
                        f"got {q.dtype}")
    if q.ndim != 2 or not q.is_contiguous():
        raise ValueError("paged_decode: q must be a contiguous [N, hd]")
    n, hd = q.shape
    if not 0 < hd <= 256 or hd * q.element_size() % 16:
        raise ValueError(f"paged_decode kernel takes hd <= 256 with 16-byte "
                         f"rows, got hd {hd} in {q.dtype}")
    if group < 1 or n % group:
        raise ValueError(f"paged_decode: {n} query rows are not a multiple "
                         f"of group {group}")
    if first[0].ndim != 3 or first[0].shape[1] != PAGE:
        raise ValueError(f"paged_decode kernel takes pages of {PAGE} tokens")
    build.refuse_grad("paged_decode", (q, first[0], first[1])
                      + ((second[0], second[1]) if second is not None else ()))
    _check_cuda(q, first, "", n // group)
    if second is not None:
        _check_cuda(q, second, "second ", n // group)
        if second[0].shape[1] != first[0].shape[1]:
            raise ValueError("paged_decode: both segments need one page size")
    return n // group


def _second_args(second: Optional[Segment]):
    if second is None:
        return (None, None, None, None, 0)
    k2, v2, t2, l2 = second
    return (k2.data_ptr(), v2.data_ptr(), t2.data_ptr(), l2.data_ptr(),
            t2.shape[1])


def _launch(fn, q, plan: SplitPlan, group: int, args, tail,
            lse: Optional[torch.Tensor] = None):
    """Runs a kernel entry with its split plan and scratch; returns out
    (and writes the log-sum-exp into ``lse`` [N] f32 when given)."""
    n, hd = q.shape
    nkv = n // group
    out = torch.empty_like(q)
    part = None
    if plan.n_splits > 1:
        part = torch.empty(nkv * plan.n_splits * group * (hd + 2),
                           dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), *args, *tail, out.data_ptr(),
                lse.data_ptr() if lse is not None else None,
                part.data_ptr() if part is not None else None, n, group, hd,
                PAGE, plan.pages_per_split, plan.heads, _DTYPE_CODE[q.dtype],
                stream)
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} kernel launch failed: CUDA error "
                           f"{rc}")
    return out


def _read_name(*args, starts=None, **kw) -> str:
    return "paged_decode" if starts is None else "paged_decode_starts"


def _read_work(q, k_pool, v_pool, page_table, lengths, second=None, *,
               group=1, starts=None, span=None, lse=False):
    return W.paged_decode(*q.shape, group, page_table.shape[1],
                          second[2].shape[1] if second is not None else 0,
                          isz=q.element_size(), span=span, lse=lse)


def _selected_work(q, k_pool, v_pool, page_table, lengths, sel_ids, n_sel,
                   second=None, *, group=1, lse=False):
    return W.paged_decode_selected(
        *q.shape, group, sel_ids.shape[1],
        second[2].shape[1] if second is not None else 0,
        isz=q.element_size(), lse=lse)


@counter.counted(_read_name, _read_work)
def paged_decode(q, k_pool, v_pool, page_table, lengths,
                 second: Optional[Segment] = None, *, group: int = 1,
                 starts=None, span: Optional[int] = None,
                 lse: bool = False):
    """Single-query paged decode over one or two segments -> [N, hd]
    (with ``lse``: (out, log-sum-exp [N] f32)); with ``starts`` and
    ``span`` the first segment is read from a start offset (see the
    module's note)."""
    if (starts is None) != (span is None):
        raise ValueError("paged_decode: starts and span go together")
    if span is not None and span < 1:
        raise ValueError(f"paged_decode: span must be >= 1, got {span}")
    if q.device.type == "cpu":
        return paged_decode_plain(q, k_pool, v_pool, page_table, lengths,
                                  second, group=group, starts=starts,
                                  span=span, lse=lse)
    if q.device.type == "meta":
        out = torch.empty_like(q)
        return (out, q.new_empty(q.shape[0], dtype=torch.float32)) if lse \
            else out
    nkv = _check_launch(q, (k_pool, v_pool, page_table, lengths), second,
                        group)
    start_args = (None, 0, 0)
    if starts is not None:
        if starts.device != q.device or starts.dtype != torch.int32 \
                or not starts.is_contiguous() \
                or tuple(starts.shape) != (nkv,):
            raise ValueError(f"paged_decode: starts must be a contiguous "
                             f"int32 [{nkv}] on {q.device}")
        start_args = (starts.data_ptr(), span,
                      start_walk(page_table.shape[1], span))
    lib = build.load("paged_decode")
    l_se = (torch.empty(q.shape[0], dtype=torch.float32, device=q.device)
            if lse else None)
    out = _launch(lib.paged_decode, q,
                  walk_plan(q, page_table, second, group=group, span=span),
                  group,
                  (k_pool.data_ptr(), v_pool.data_ptr(),
                   page_table.data_ptr(), lengths.data_ptr(),
                   page_table.shape[1], *start_args), _second_args(second),
                  l_se)
    if starts is None:
        launches.count += 1
    else:
        start_launches.count += 1
    return (out, l_se) if lse else out


@counter.counted("paged_decode_selected", _selected_work)
def paged_decode_selected(q, k_pool, v_pool, page_table, lengths, sel_ids,
                          n_sel, second: Optional[Segment] = None, *,
                          group: int = 1, lse: bool = False):
    """Quest-selected single-query paged decode -> [N, hd] (with
    ``lse``: (out, log-sum-exp [N] f32), as :func:`paged_decode`'s): the
    first segment read through only the pages ``sel_ids`` [N / group, K]
    int32 (ascending logical ids) of which the first ``n_sel`` [N /
    group] int32 are valid; ``second`` read whole."""
    if q.device.type == "cpu":
        return paged_decode_selected_plain(q, k_pool, v_pool, page_table,
                                           lengths, sel_ids, n_sel, second,
                                           group=group, lse=lse)
    if q.device.type == "meta":
        out = torch.empty_like(q)
        return (out, q.new_empty(q.shape[0], dtype=torch.float32)) if lse \
            else out
    nkv = _check_launch(q, (k_pool, v_pool, page_table, lengths), second,
                        group)
    for name, t in (("sel_ids", sel_ids), ("n_sel", n_sel)):
        if t.device != q.device or t.dtype != torch.int32 \
                or not t.is_contiguous():
            raise ValueError(f"paged_decode_selected: {name} must be a "
                             f"contiguous int32 tensor on {q.device}")
    if sel_ids.ndim != 2 or sel_ids.shape[0] != nkv or sel_ids.shape[1] < 1 \
            or tuple(n_sel.shape) != (nkv,):
        raise ValueError(f"paged_decode_selected: sel_ids "
                         f"{tuple(sel_ids.shape)} / n_sel "
                         f"{tuple(n_sel.shape)} do not match {nkv} kv "
                         f"streams")
    lib = build.load("paged_decode")
    l_se = (torch.empty(q.shape[0], dtype=torch.float32, device=q.device)
            if lse else None)
    out = _launch(lib.paged_decode_selected, q,
                  walk_plan(q, page_table, second, group=group,
                            sel_ids=sel_ids), group,
                  (k_pool.data_ptr(), v_pool.data_ptr(),
                   page_table.data_ptr(), lengths.data_ptr(),
                   page_table.shape[1], sel_ids.data_ptr(), n_sel.data_ptr(),
                   sel_ids.shape[1]), _second_args(second), l_se)
    selected_launches.count += 1
    return (out, l_se) if lse else out
