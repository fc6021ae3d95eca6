"""The work of each kernel entry from its call's shapes: FLOPs, bytes and
the rate class its products run at (``analysis.RATES``' keys).

Bytes: each input read once and each output written once. FLOPs: the
products and sums the function needs, not what a kernel recomputes.
Where the exact count depends on values (the valid tokens a decode read
walks, the global keys a prefill query sees), a function takes that
count as an optional host integer: given, the work is exact; left out,
it is the work of a call in which every slot the kernel may read is
valid. The dry run and the counter only use the shapes-only form: they
never read a device value. ``chip_smoke.py`` computes its bounds from
these functions with the exact counts it holds.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

F32, TF32X3, BF16 = "f32", "3xtf32", "bf16"
PAGE = 16   # tokens per page of the decode kernels (kernels/paged_decode.py)


class Work(NamedTuple):
    flops: int
    bytes: int
    rate: str   # the rate class of the FLOPs (analysis.RATES)


def _attn_rate(isz: int) -> str:
    """The prefill attention kernels multiply f32 in 3xTF32 and bf16 on
    the bf16 tensor cores."""
    return TF32X3 if isz == 4 else BF16


def window_pairs(s: int, w: int) -> int:
    """(query, key) pairs a window of ``w`` keeps over ``s`` tokens: the
    sum over i of min(i + 1, w)."""
    m = min(s, w)
    return m * (m + 1) // 2 + (s - m) * w


def gate_mlp(r: int, s: int, f: int, m: int, h: int, tile: int,
             isz: int = 4) -> Work:
    """x [r, s, f] through h heads' [f, m] -> [m, 1] MLP -> g [r, s] f32;
    ``tile`` is the kernel's plan (``kernels.gate_mlp.plan``): the decode
    path (0) multiplies on the CUDA cores, the tensor-core path in
    3xTF32."""
    weights = h * (f * m + m + m + 1)
    return Work(r * s * (2 * f * m + 2 * m),
                isz * (r * s * f + weights) + 4 * r * s,
                F32 if tile == 0 else TF32X3)


def gate_mlp_bwd(r: int, s: int, f: int, m: int, h: int) -> Work:
    """x, the weights, g and dg read, dx and the weight gradients written
    (f32); per token the recomputed pre-activation, dx and dw1 (2 f m
    each) and about 12 m of elementwise work, in 3xTF32."""
    weights = h * (f * m + m + m + 1)
    return Work(r * s * (6 * f * m + 12 * m),
                4 * (2 * r * s * f + 2 * weights + 2 * r * s), TF32X3)


def gated_flash(nq: int, s: int, hd: int, group: int, isz: int = 4,
                with_lse: bool = False) -> Work:
    """Causal attention of nq query streams on nq / group kv streams with
    the gate g [nk, s] f32: every causal pair, 4 hd FLOPs each; q, k, v
    and g read, the output (and each row's f32 log-sum-exp for the
    backward) written."""
    nk = nq // group
    return Work(4 * hd * nq * s * (s + 1) // 2,
                isz * (2 * nq + 2 * nk) * s * hd + 4 * nk * s
                + (4 * nq * s if with_lse else 0),
                _attn_rate(isz))


def gated_flash_window(nq: int, s: int, hd: int, group: int, window: int,
                       isz: int = 4) -> Work:
    """The hard window: the pairs with 0 <= i - j < window, no gate."""
    nk = nq // group
    return Work(4 * hd * nq * window_pairs(s, window),
                isz * (2 * nq + 2 * nk) * s * hd, _attn_rate(isz))


def gated_flash_bwd(nq: int, s: int, hd: int, group: int) -> Work:
    """q, k, v, g, o, lse and do read, dq, dk, dv and dg written (f32);
    per causal pair the scores again, dO V^T, dV, dK and dQ (2 hd FLOPs
    each), in 3xTF32."""
    nk = nq // group
    qkvg = nq * s * hd + 2 * nk * s * hd + nk * s
    return Work(10 * hd * nq * s * (s + 1) // 2,
                4 * (2 * qkvg + nq * s * hd + nq * s + nq * s * hd), TF32X3)


def vertical_slash(nq: int, s: int, hd: int, group: int, c: int,
                   w_local: int, isz: int = 4,
                   global_pairs: Optional[int] = None) -> Work:
    """Each query's local window of its own kv stream and the C
    pre-gathered globals past its window: every visible pair once, 4 hd
    FLOPs each; q, k, v, kg, vg and gpos read, the output written.
    ``global_pairs``: the (kv stream, query, global) triples visible,
    summed over kv streams (a global at position p is visible to the
    queries i >= p + w_local); left out, every slot holds a global that
    every query past the first window sees."""
    nk = nq // group
    if global_pairs is None:
        global_pairs = nk * c * max(s - w_local, 0)
    visible = group * (nk * window_pairs(s, w_local) + global_pairs)
    return Work(4 * hd * visible,
                isz * ((2 * nq + 2 * nk) * s * hd + 2 * nk * c * hd)
                + 4 * nk * c,
                _attn_rate(isz))


def paged_decode(n: int, hd: int, group: int, pages1: int, pages2: int = 0,
                 *, isz: int = 4, tokens: Optional[int] = None,
                 span: Optional[int] = None, lse: bool = False) -> Work:
    """One query row per (kv stream, head) over segment 1's table of
    ``pages1`` pages per kv stream and, when ``pages2``, segment 2's: each
    valid K/V token read once per kv stream, q read and the output
    written once, the tables, lengths (and ``starts``, with ``span``)
    read once; 4 hd FLOPs per (query row, token), on the CUDA cores in
    f32. ``tokens``: the valid tokens read, summed over kv streams; left
    out, every slot of both tables (segment 1's only ``span`` tokens from
    its start). ``lse``: the read's log-sum-exp written too, one f32 per
    query row."""
    nkv = n // group
    if tokens is None:
        first = pages1 * PAGE if span is None else min(span, pages1 * PAGE)
        tokens = nkv * (first + pages2 * PAGE)
    ints = nkv * (pages1 + 1) + (nkv * (pages2 + 1) if pages2 else 0)
    ints += nkv if span is not None else 0
    ints += n if lse else 0
    return Work(4 * tokens * group * hd,
                2 * n * hd * isz + 2 * tokens * hd * isz + 4 * ints,
                F32 if isz == 4 else BF16)


def paged_decode_selected(n: int, hd: int, group: int, k: int, pages2: int,
                          *, isz: int = 4, tokens: Optional[int] = None,
                          lse: bool = False) -> Work:
    """:func:`paged_decode` with segment 1 read through ``k`` selected
    pages per kv stream: the ids, their counts, the table entries they
    select and both segments' lengths read once. ``tokens`` left out:
    every selected page full and segment 2 whole. ``lse``: the read's
    log-sum-exp written too, one f32 per query row."""
    nkv = n // group
    if tokens is None:
        tokens = nkv * (k + pages2) * PAGE
    ints = 2 * nkv * k + nkv + 2 * nkv + nkv * pages2
    ints += n if lse else 0
    return Work(4 * tokens * group * hd,
                2 * n * hd * isz + 2 * tokens * hd * isz + 4 * ints,
                F32 if isz == 4 else BF16)


def rglru_scan(b: int, s: int, d: int) -> Work:
    """h_t = a_t h_{t-1} + b_t over [b, s, d] f32: a and b read, h
    written; two operations an element."""
    n = b * s * d
    return Work(2 * n, 12 * n, F32)


def rglru_scan_bwd(b: int, s: int, d: int) -> Work:
    """a, h and dy read, da and db written (f32); four operations an
    element."""
    n = b * s * d
    return Work(4 * n, 20 * n, F32)
