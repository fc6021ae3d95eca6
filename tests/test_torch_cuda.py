"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

Every test here carries the ``cuda`` marker and skips without a GPU. The
file imports no JAX and nothing of the reference package, so it runs on a
machine that has only PyTorch (``tests/conftest.py`` imports JAX, hence
``--noconftest``)::

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Inputs are drawn with numpy from a seed. Tolerances, absolute:
``gate_mlp`` 1e-5 (its tensor-core path multiplies in 3xTF32, which keeps
f32 accuracy to about 2**-20 of each product, its decode path in f32 on
the CUDA cores); ``rglru_scan`` 5e-5 (it scans in chunks and regroups the
products at their boundaries, so it is within a few ulps of |h| of its
plain loop, not bitwise equal; two calls are bitwise equal, as for
``gate_mlp``); the attention kernels (``paged_decode_selected``
too; at the identity ids it must equal ``paged_decode`` exactly) 5e-5 in
float32 and 1e-2 in
bfloat16. The kernels and the plain versions both compute in f32, in
different orders (``gated_flash`` and ``vertical_slash`` on tensor cores:
3xTF32 for float32, bfloat16 products with P as two bfloat16 terms), and
round the output to
bfloat16, so in bfloat16 they may differ by an ulp of an output (2**-9
for outputs under 0.5). A mutation check holds the bfloat16 bound against
a kernel whose bfloat16 load is broken on purpose.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels import paged_decode as PD
from repro_torch.kernels import gated_flash as GF
from repro_torch.kernels.gate_mlp import (bwd_scratch, gate_mlp, gate_mlp_bwd,
                                          gate_mlp_bwd_plain, gate_mlp_plain)
from repro_torch.kernels.gated_flash import (gated_flash, gated_flash_bwd,
                                             gated_flash_bwd_plain,
                                             gated_flash_plain)
from repro_torch.kernels.paged_decode import (paged_decode, paged_decode_plain,
                                              paged_decode_selected,
                                              paged_decode_selected_plain)
from repro_torch.kernels.rglru_scan import (rglru_scan, rglru_scan_bwd,
                                            rglru_scan_bwd_plain,
                                            rglru_scan_plain)
from repro_torch.kernels.vertical_slash import (vertical_slash,
                                                vertical_slash_plain)
from repro_torch.models import rglru as RG

TOL = {"float32": 5e-5, "bfloat16": 1e-2}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU "
                    "mode); chip_smoke.py runs these checks on the card")
    torch.backends.cuda.matmul.allow_tf32 = False


def _cuda(*arrays, dtype=None):
    out = [torch.from_numpy(np.ascontiguousarray(a)).cuda() for a in arrays]
    return [t.to(dtype) for t in out] if dtype is not None else out


def _gate_inputs(rng, h, s, f, m):
    x = rng.standard_normal((h, s, f)).astype(np.float32)
    w1 = (0.1 * rng.standard_normal((h, f, m))).astype(np.float32)
    b1 = (0.1 * rng.standard_normal((h, m))).astype(np.float32)
    w2 = (0.1 * rng.standard_normal((h, m, 1))).astype(np.float32)
    b2 = np.zeros((h, 1), np.float32)
    return x, w1, b1, w2, b2


def _paged_inputs(rng, n, hd, page, ptotal, mp):
    q = rng.standard_normal((n, hd)).astype(np.float32)
    kp = rng.standard_normal((ptotal, page, hd)).astype(np.float32)
    vp = rng.standard_normal((ptotal, page, hd)).astype(np.float32)
    tbl = rng.integers(0, ptotal, (n, mp)).astype(np.int32)
    lens = rng.integers(1, mp * page, (n,)).astype(np.int32)
    return q, kp, vp, tbl, lens


def _vs_globals(rng, n, s, w, c, k, v, *, none_valid=False):
    """Unsorted global positions older than the last window, a random
    number valid per stream (none with ``none_valid``) and the rest
    INT32_MAX (never visible), with their K/V gathered."""
    gpos = rng.integers(0, s - w, (n, c))
    nvalid = 0 if none_valid else rng.integers(1, c, (n, 1))
    gpos = np.where(np.arange(c)[None] < nvalid, gpos,
                    np.iinfo(np.int32).max).astype(np.int32)
    safe = np.minimum(gpos, s - 1)
    ok = (gpos < s)[..., None]
    bi = np.arange(n)[:, None]
    return (np.where(ok, k[bi, safe], 0).astype(np.float32),
            np.where(ok, v[bi, safe], 0).astype(np.float32), gpos)


@pytest.mark.parametrize("rows,s,h,f", [
    (16, 1, 8, 256),      # qwen3-0.6b decode: 2 slots x 8 kv heads
    (2, 1, 1, 512),       # recurrentgemma-9b decode: 2 slots, 1 kv head
    (128, 1, 8, 256),     # 16 slots: two CTAs of 8 tokens per head
    (16, 4096, 8, 256),   # long S on the tensor cores, tile 64
    (8, 4096, 8, 256),    # prefill-long's shape
    (1, 4096, 1, 512),    # recurrentgemma-9b prefill: one row, tile 16
    (8, 1, 8, 256),       # ragged S: 1, 37 and 1000 tokens
    (8, 37, 8, 256),
    (8, 1000, 8, 256),
    (24, 1000, 8, 256),   # rows a multiple of H > 1 at long S
    (16, 300, 8, 128),    # F 128 (hd 64), tile 16
    (8, 2, 8, 160),       # F 160 (hd 80), decode
    (8, 100, 8, 160),
])
def test_gate_mlp_kernel_matches_plain_on_gpu(rows, s, h, f):
    _, w1, b1, w2, b2 = _gate_inputs(np.random.default_rng(0), h, 1, f, 64)
    x = np.random.default_rng(1).standard_normal((rows, s, f)).astype(
        np.float32)
    args = _cuda(x, w1, b1, w2, b2)
    got = gate_mlp(*args)
    again = gate_mlp(*args)
    want = gate_mlp_plain(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    assert torch.equal(got, again)  # two calls bitwise equal


@pytest.mark.parametrize("m", [8, 32, 96, 128])
def test_gate_mlp_kernel_hidden_widths_on_gpu(m):
    """Hidden widths other than 64, on both paths."""
    for rows, s in ((8, 1), (8, 200)):
        _, w1, b1, w2, b2 = _gate_inputs(np.random.default_rng(2), 8, 1,
                                         256, m)
        x = np.random.default_rng(3).standard_normal((rows, s, 256)).astype(
            np.float32)
        args = _cuda(x, w1, b1, w2, b2)
        got = gate_mlp(*args)
        want = gate_mlp_plain(*args)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


def test_gate_mlp_refuses_what_the_kernel_does_not_take_on_gpu():
    """F and M multiples of 8, F <= 2048, M <= 128; the plain version
    takes any of them."""
    for f, m in ((12, 64), (256, 12), (256, 136), (2056, 64)):
        x, w1, b1, w2, b2 = _gate_inputs(np.random.default_rng(4), 8, 4, f,
                                         m)
        args = _cuda(x, w1, b1, w2, b2)
        with pytest.raises(ValueError, match="multiples of 8"):
            gate_mlp(*args)
        assert gate_mlp_plain(*args).shape == (8, 4)
    x, w1, b1, w2, b2 = _cuda(*_gate_inputs(np.random.default_rng(5), 8, 4,
                                            256, 64))
    shifted = torch.empty(x.numel() + 1, device="cuda")[1:].view(x.shape)
    shifted.copy_(x)  # contiguous, 4 bytes past a 16-byte boundary
    with pytest.raises(ValueError, match="aligned"):
        gate_mlp(shifted, w1, b1, w2, b2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_decode_kernel_matches_plain_on_gpu(dtype):
    q, kp, vp, tbl, lens = _paged_inputs(np.random.default_rng(3), 32, 128,
                                         16, 64, 24)
    lens[0] = 0
    args = _cuda(q, kp, vp, dtype=TDT[dtype])
    ti = _cuda(tbl, lens)
    second = (args[1], args[2], ti[0][:, :8].contiguous(), ti[1] // 3)
    got = paged_decode(*args, *ti, second=second)
    want = paged_decode_plain(*args, *ti, second=second)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=0)


def _selected_ids(rng, n, mp, kp):
    """Ascending K-subsets of each stream's logical pages and a ragged
    n_sel (1..K)."""
    sel = np.sort(np.argsort(rng.random((n, mp)), axis=-1)[:, :kp],
                  axis=-1).astype(np.int32)
    return sel, rng.integers(1, kp + 1, (n,)).astype(np.int32)


@pytest.mark.parametrize("kp", [2, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_decode_selected_kernel_matches_plain_on_gpu(kp, dtype):
    """K-subsets of 24 pages (some past a stream's length), a length-0
    stream, and the whole second segment (the ring) in the same softmax."""
    rng = np.random.default_rng(4)
    q, kp_, vp, tbl, lens = _paged_inputs(rng, 32, 128, 16, 64, 24)
    lens[0] = 0
    sel, nsel = _selected_ids(rng, 32, 24, kp)
    args = _cuda(q, kp_, vp, dtype=TDT[dtype])
    ti = _cuda(tbl, lens, sel, nsel)
    second = (args[1], args[2], ti[0][:, :8].contiguous(), ti[1] // 3)
    got = paged_decode_selected(*args, *ti, second=second)
    want = paged_decode_selected_plain(*args, *ti, second=second)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_decode_selected_identity_is_bitwise_on_gpu(dtype):
    """The identity ids with K covering every page walk the same pages in
    the same order as paged_decode: torch.equal outputs, per query stream
    (group 1) and with tables per kv stream of a group of 2."""
    rng = np.random.default_rng(5)
    q, kp_, vp, tbl, lens = _paged_inputs(rng, 16, 128, 16, 64, 8)
    lens[3] = 0
    args = _cuda(q, kp_, vp, dtype=TDT[dtype])
    for group in (1, 2):
        tt, tl = _cuda(tbl[::group], lens[::group])
        nkv = tt.shape[0]
        sel = torch.arange(8, dtype=torch.int32, device="cuda")[None].expand(
            nkv, 8).contiguous()
        nsel = torch.full((nkv,), 8, dtype=torch.int32, device="cuda")
        second = (args[1], args[2], tt[:, :4].contiguous(), tl // 2)
        for seg2 in (None, second):
            full = paged_decode(*args, tt, tl, second=seg2, group=group)
            got = paged_decode_selected(*args, tt, tl, sel, nsel,
                                        second=seg2, group=group)
            torch.cuda.synchronize()
            assert torch.equal(got, full)


def _split_walk_case(rng, group, hd, dtype):
    """Four kv streams over [global C 1024 ‖ ring W 2048] (64 + 128 pages
    of 16), where the split plan cuts the walk into splits of a few pages:
    a length-0 stream, one whose live pages all fall in the first split,
    one that reaches one token past the first split boundary, and a full
    one whose ring reaches past the last boundary."""
    nkv, p1, p2 = 4, 64, 128
    pps = PD.split_plan(p1 + p2, nkv, group, hd).pages_per_split
    assert pps > 1
    ptotal = 600
    q = rng.standard_normal((nkv * group, hd)).astype(np.float32)
    kp, vp = (rng.standard_normal((ptotal, 16, hd)).astype(np.float32)
              for _ in range(2))
    t1 = rng.integers(0, ptotal, (nkv, p1)).astype(np.int32)
    t2 = rng.integers(0, ptotal, (nkv, p2)).astype(np.int32)
    l1 = np.array([0, pps * 16 - 5, pps * 16 + 1, p1 * 16], np.int32)
    l2 = np.array([0, 0, 7, p2 * 16], np.int32)
    args = _cuda(q, kp, vp, dtype=TDT[dtype])
    tt1, tl1, tt2, tl2 = _cuda(t1, l1, t2, l2)
    return args, (tt1, tl1), (args[1], args[2], tt2, tl2)


@pytest.mark.parametrize("group,hd", [(1, 64), (2, 128), (16, 256),
                                      (16, 64), (2, 256),
                                      # the dense archs' G 3 and G 4
                                      (3, 64), (3, 128), (4, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_decode_split_walk_matches_plain_on_gpu(group, hd, dtype):
    """The split-K walk with GQA-shared pages against the plain read, and
    two calls bitwise equal (the combine runs in a fixed split order)."""
    rng = np.random.default_rng(7)
    args, first, second = _split_walk_case(rng, group, hd, dtype)
    got = paged_decode(*args, *first, second=second, group=group)
    again = paged_decode(*args, *first, second=second, group=group)
    want = paged_decode_plain(*args, *first, second=second, group=group)
    torch.cuda.synchronize()
    assert torch.all(got[:group] == 0)  # the length-0 kv stream
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=0)
    assert torch.equal(got, again)
    # one segment: the walk is the global pages alone
    got1 = paged_decode(*args, *first, group=group)
    want1 = paged_decode_plain(*args, *first, group=group)
    torch.cuda.synchronize()
    torch.testing.assert_close(got1.float(), want1.float(), atol=TOL[dtype],
                               rtol=0)


@pytest.mark.parametrize("group,hd", [(1, 64), (2, 128), (16, 256)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_decode_selected_split_walk_matches_plain_on_gpu(group, hd,
                                                               dtype):
    """K = 8 of 64 global pages per kv stream with n_sel below K on some
    streams (0 on one), the ring whole, per kv stream; bitwise repeatable."""
    rng = np.random.default_rng(8)
    args, first, second = _split_walk_case(rng, group, hd, dtype)
    sel, _ = _selected_ids(rng, 4, 64, 8)
    ts, tn = _cuda(sel, np.array([8, 3, 0, 5], np.int32))
    got = paged_decode_selected(*args, *first, ts, tn, second=second,
                                group=group)
    again = paged_decode_selected(*args, *first, ts, tn, second=second,
                                  group=group)
    want = paged_decode_selected_plain(*args, *first, ts, tn, second=second,
                                       group=group)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=0)
    assert torch.equal(got, again)


def test_paged_decode_selected_refuses_bad_ids_on_gpu():
    rng = np.random.default_rng(6)
    q, kp_, vp, tbl, lens = _cuda(*_paged_inputs(rng, 4, 64, 16, 8, 4))
    sel = torch.zeros((4, 2), dtype=torch.int64, device="cuda")
    nsel = torch.ones((4,), dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="int32"):
        paged_decode_selected(q, kp_, vp, tbl, lens, sel, nsel)
    with pytest.raises(ValueError, match="streams"):
        paged_decode_selected(q, kp_, vp, tbl, lens,
                              sel[:3].to(torch.int32).contiguous(), nsel)


@pytest.mark.parametrize("s,hd", [(32, 128), (2048, 128), (200, 32),
                                  (96, 256)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gated_flash_kernel_matches_plain_on_gpu(s, hd, dtype):
    """GQA group 2, the probe's S = 32 and the forward's S = 2048, a ragged
    last query tile (S = 200) and the hd extremes."""
    rng = np.random.default_rng(13)
    q = rng.standard_normal((16, s, hd)).astype(np.float32)
    k, v = (rng.standard_normal((8, s, hd)).astype(np.float32)
            for _ in range(2))
    g = rng.uniform(0.0, 1.0, (8, s)).astype(np.float32)
    args = _cuda(q, k, v, dtype=TDT[dtype])
    (tg,) = _cuda(g)
    got = gated_flash(*args, tg, w_local=64, eps=1e-6, group=2)
    want = gated_flash_plain(*args, tg, w_local=64, eps=1e-6, group=2)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=0)


@pytest.mark.parametrize("group,s,hd", [(16, 200, 256), (16, 96, 64),
                                        (1, 130, 128), (4, 77, 96),
                                        # the dense archs' G 3 and G 4
                                        (3, 130, 64), (3, 77, 128),
                                        (4, 200, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gated_flash_grouped_rows_match_plain_on_gpu(group, s, hd, dtype):
    """The CTA folds (position, head) rows over a group that divides its
    64 rows (G 16 with hd 256, as the hybrid runs it; G 4), or one that
    does not (G 3), or takes 64 positions of one head (G 1); ragged S
    throughout. Two calls are bitwise equal."""
    rng = np.random.default_rng(22)
    q = rng.standard_normal((2 * group, s, hd)).astype(np.float32)
    k, v = (rng.standard_normal((2, s, hd)).astype(np.float32)
            for _ in range(2))
    g = rng.uniform(0.0, 1.0, (2, s)).astype(np.float32)
    args = _cuda(q, k, v, dtype=TDT[dtype])
    (tg,) = _cuda(g)
    got = gated_flash(*args, tg, w_local=48, eps=1e-6, group=group)
    again = gated_flash(*args, tg, w_local=48, eps=1e-6, group=group)
    want = gated_flash_plain(*args, tg, w_local=48, eps=1e-6, group=group)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=0)
    assert torch.equal(got, again)


def test_gated_flash_kernel_refuses_grad_on_gpu():
    """The backward kernel takes float32 with hd a multiple of 8 up to
    128, or 256: inputs that require grad in bfloat16, or at hd 136 (the
    forward kernel's range, not the backward's), raise in the forward (no
    graph that would miss its gradient is built); under torch.no_grad()
    both run the forward kernel."""
    rng = np.random.default_rng(14)
    for hd, dtype in ((64, torch.bfloat16), (136, torch.float32)):
        q, k, v = _cuda(*(rng.standard_normal((2, 32, hd)).astype(np.float32)
                          for _ in range(3)), dtype=dtype)
        (g,) = _cuda(rng.uniform(0, 1, (2, 32)).astype(np.float32))
        with pytest.raises(RuntimeError, match="backward kernel takes"):
            gated_flash(q.requires_grad_(), k, v, g, w_local=8)
        with torch.no_grad():
            assert gated_flash(q, k, v, g, w_local=8).shape == (2, 32, hd)


@pytest.mark.parametrize("s,c,w,group,hd,none_valid", [
    (1024, 96, 256, 2, 128, False), (1024, 1024, 256, 2, 128, False),
    (384, 0, 128, 2, 128, False),
    (1000, 100, 200, 3, 64, False),   # smollm's G 3: rows are positions
    (1000, 100, 256, 3, 128, False),  # phi4-mini's G 3 at hd 128
    (1000, 100, 256, 4, 128, False),  # phi3-medium's G 4
    (1000, 77, 128, 2, 128, True),    # every gpos INT32_MAX
    (600, 40, 64, 16, 256, False),    # rg's layout, 8 positions x 16 heads
    (257, 300, 64, 1, 72, False),     # hd 72: zero columns 72..79
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vertical_slash_kernel_matches_plain_on_gpu(s, c, w, group, hd,
                                                    none_valid, dtype):
    """Unsorted global positions with INT32_MAX padding; C ragged against
    every key tile (96, 100, 77, 40, 300 against 16, 32 and 64 keys) and
    no globals; ragged S; a group that divides the CTA's rows (2, 16) and
    one that does not (3). Two calls are bitwise equal."""
    rng = np.random.default_rng(15)
    nkv = 16 // group if 16 % group == 0 else 4
    q = rng.standard_normal((nkv * group, s, hd)).astype(np.float32)
    k, v = (rng.standard_normal((nkv, s, hd)).astype(np.float32)
            for _ in range(2))
    if c:
        kg, vg, gpos = _vs_globals(rng, nkv, s, w, c, k, v,
                                   none_valid=none_valid)
    else:
        kg = vg = np.zeros((nkv, 0, hd), np.float32)
        gpos = np.zeros((nkv, 0), np.int32)
    args = _cuda(q, k, v, kg, vg, dtype=TDT[dtype])
    (tg,) = _cuda(gpos)
    got = vertical_slash(*args, tg, w_local=w, group=group)
    again = vertical_slash(*args, tg, w_local=w, group=group)
    want = vertical_slash_plain(*args, tg, w_local=w, group=group)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=0)
    assert torch.equal(got, again)


def test_vertical_slash_refuses_what_the_kernel_does_not_take_on_gpu():
    """The tensor-core kernel takes 16-byte rows: hd a multiple of 8 (the
    plain version takes any hd, and the CPU path still does)."""
    rng = np.random.default_rng(23)
    q, k, v, kg, vg = _cuda(*(rng.standard_normal(shape).astype(np.float32)
                              for shape in [(2, 64, 60)] * 3
                              + [(2, 8, 60)] * 2))
    (gpos,) = _cuda(np.zeros((2, 8), np.int32))
    with pytest.raises(ValueError, match="multiple of 8"):
        vertical_slash(q, k, v, kg, vg, gpos, w_local=16)
    with pytest.raises(TypeError, match="int32"):
        vertical_slash(q[..., :56].contiguous(), k[..., :56].contiguous(),
                       v[..., :56].contiguous(), kg[..., :56].contiguous(),
                       vg[..., :56].contiguous(), gpos.long(), w_local=16)
    cpu = vertical_slash(*(t.cpu() for t in (q, k, v, kg, vg, gpos)),
                         w_local=16)
    assert cpu.shape == (2, 64, 60)


# the bfloat16 load each attention kernel's mutation check breaks, both in
# the key-tile step of flash_mma.cuh that the two kernels share: the Q
# fragment load (vertical_slash: the second half of a k-step, rows g and
# g + 8) and the K fragments that ldmatrix loads (gated_flash: the two
# registers of two bf16 each of n-tiles nt and nt + 1); each broken two
# ways, a swap and a drop of a pair of elements
_BF16_LOAD = {
    "vertical_slash": ("flash_mma.cuh",
                       "a[2] = lds32(row + 8); a[3] = lds32(row + 8 * LD + 8);",
                       {"swap_pairs": "a[2] = lds32(row + 8 * LD + 8); a[3] = lds32(row + 8);",
                        "drop_pair": "a[2] = lds32(row + 8); a[3] = 0u;"}),
    "gated_flash": ("flash_mma.cuh",
                    "const uint32_t k0[2] = {r[0], r[1]}, k1[2] = {r[2], r[3]};",
                    {"swap_pairs": "const uint32_t k0[2] = {r[1], r[0]}, k1[2] = {r[3], r[2]};",
                     "drop_pair": "const uint32_t k0[2] = {r[0], 0u}, k1[2] = {r[2], r[3]};"}),
}
FAULTS = ("swap_pairs", "drop_pair")


def _attention_case(kernel):
    """A bfloat16 case of each attention kernel (GQA group 2, hd 128) as
    (run(fn), plain output)."""
    rng = np.random.default_rng(16)
    s, hd = (256, 128) if kernel == "gated_flash" else (1024, 128)
    q = rng.standard_normal((16, s, hd)).astype(np.float32)
    k, v = (rng.standard_normal((8, s, hd)).astype(np.float32)
            for _ in range(2))
    if kernel == "gated_flash":
        args = _cuda(q, k, v, dtype=torch.bfloat16)
        args += _cuda(rng.uniform(0.0, 1.0, (8, s)).astype(np.float32))
        kw = {"w_local": 64, "eps": 1e-6, "group": 2}
        fns = (gated_flash, gated_flash_plain)
    else:
        kg, vg, gpos = _vs_globals(rng, 8, s, 256, 96, k, v)
        args = _cuda(q, k, v, kg, vg, dtype=torch.bfloat16) + _cuda(gpos)
        kw = {"w_local": 256, "group": 2}
        fns = (vertical_slash, vertical_slash_plain)
    return (lambda: fns[0](*args, **kw)), fns[1](*args, **kw).float()


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("kernel", ["gated_flash", "vertical_slash"])
def test_bf16_tolerance_catches_a_planted_load_fault(kernel, fault, tmp_path,
                                                     monkeypatch):
    """Mutation check of the bfloat16 bound: the sound kernel is within
    TOL, and a copy of its sources whose bfloat16 load swaps or drops a
    pair of elements, built into a temporary directory, is not. Prints
    both errors (run with ``-s`` to read them)."""
    run, want = _attention_case(kernel)
    sound = float((run().float() - want).abs().max())
    header, line, faults = _BF16_LOAD[kernel]
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    names = [src.name for src in build.sources(kernel)]
    assert header in names
    for src in build.sources(kernel):
        text = src.read_text()
        if src.name == header:
            assert text.count(line) == 1
            text = text.replace(line, faults[fault])
        (csrc / src.name).write_text(text)
    monkeypatch.setattr(build, "CSRC", csrc)
    monkeypatch.setattr(build, "BUILD_DIR", Path(tmp_path) / "build")
    monkeypatch.setattr(build, "_LIBS", {})
    planted = float((run().float() - want).abs().max())
    print(f"\n{kernel} bf16 max abs err: sound {sound:.3e}, planted "
          f"{fault} {planted:.3e} (limit {TOL['bfloat16']:.0e})")
    assert sound <= TOL["bfloat16"] < planted


# ==========================================================================
# rglru_scan
# ==========================================================================
@pytest.mark.parametrize("b,s,d,with_h0", [
    (1, 4096, 4096, False),    # recurrentgemma-9b: one 4096-token prompt
    (3, 1000, 200, True),      # ragged: no multiple of any tile, an h0
    (2, 1, 300, True),         # S = 1
    (4, 257, 1, False),        # D = 1
    (2, 100, 70, False),       # S < L (one chunk of 128 steps)
    (2, 129, 70, True),        # S = L + 1: one step in the last chunk
])
def test_rglru_scan_kernel_matches_plain_on_gpu(b, s, d, with_h0):
    rng = np.random.default_rng(17)
    a = (1.0 / (1.0 + np.exp(-rng.standard_normal((b, s, d))))
         ).astype(np.float32)
    bb = rng.standard_normal((b, s, d)).astype(np.float32)
    h0 = rng.standard_normal((b, d)).astype(np.float32)
    ta, tb, th0 = _cuda(a, bb, h0)
    if with_h0:
        # the model's scan: h0 folded into b[:, 0], then the kernel
        got = RG.rglru_scan(ta, tb, th0)
        folded = tb.clone()
        folded[:, 0] = folded[:, 0] + ta[:, 0] * th0
        want = rglru_scan_plain(ta, folded)
    else:
        got = rglru_scan(ta, tb)
        want = rglru_scan_plain(ta, tb)
    again = RG.rglru_scan(ta, tb, th0) if with_h0 else rglru_scan(ta, tb)
    torch.cuda.synchronize()
    assert got.shape == (b, s, d) and got.dtype == torch.float32
    torch.testing.assert_close(got, want, atol=5e-5, rtol=0)
    assert torch.equal(got, again)  # two calls bitwise equal


def test_rglru_scan_refuses_what_the_kernel_does_not_take_on_gpu():
    rng = np.random.default_rng(18)
    a, bb = _cuda(*(rng.uniform(0, 1, (2, 16, 64)).astype(np.float32)
                    for _ in range(2)))
    with pytest.raises(TypeError, match="float32"):
        rglru_scan(a.to(torch.bfloat16), bb.to(torch.bfloat16))
    with pytest.raises(ValueError, match="contiguous"):
        rglru_scan(a.transpose(1, 2), bb.transpose(1, 2))
    with pytest.raises(ValueError, match=r"\[B, S, D\]"):
        rglru_scan(a, bb[:, :8])


# ==========================================================================
# the attention kernels at recurrentgemma-9b's shapes: hd 256, MQA with
# G = 16 query heads per kv head, the 2048-token local window
# ==========================================================================
RG_HQ, RG_HD, RG_W = 16, 256, 2048


def test_vertical_slash_at_recurrentgemma_shape_on_gpu():
    rng = np.random.default_rng(19)
    s, c = 4096, 1024
    q = rng.standard_normal((RG_HQ, s, RG_HD)).astype(np.float32)
    k, v = (rng.standard_normal((1, s, RG_HD)).astype(np.float32)
            for _ in range(2))
    kg, vg, gpos = _vs_globals(rng, 1, s, RG_W, c, k, v)
    args = _cuda(q, k, v, kg, vg) + _cuda(gpos)
    got = vertical_slash(*args, w_local=RG_W, group=RG_HQ)
    want = vertical_slash_plain(*args, w_local=RG_W, group=RG_HQ)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, atol=TOL["float32"], rtol=0)


def test_gated_flash_at_recurrentgemma_shape_on_gpu():
    rng = np.random.default_rng(20)
    s = 4096
    q = rng.standard_normal((RG_HQ, s, RG_HD)).astype(np.float32)
    k, v = (rng.standard_normal((1, s, RG_HD)).astype(np.float32)
            for _ in range(2))
    g = rng.uniform(0.0, 1.0, (1, s)).astype(np.float32)
    args = _cuda(q, k, v, g)
    got = gated_flash(*args, w_local=RG_W, eps=1e-6, group=RG_HQ)
    want = gated_flash_plain(*args, w_local=RG_W, eps=1e-6, group=RG_HQ)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=TOL["float32"], rtol=0)


def test_paged_decode_at_recurrentgemma_shape_on_gpu():
    """One decode query per head over [global 1024 ‖ ring 2048] (64 + 128
    pages) of one kv head: tables repeated for its 16 query heads (group
    1), or one row shared by the group of 16."""
    rng = np.random.default_rng(21)
    gp, rp, page = 64, RG_W // 16, 16
    q = rng.standard_normal((RG_HQ, RG_HD)).astype(np.float32)
    kp, vp = (rng.standard_normal((gp + rp, page, RG_HD)).astype(np.float32)
              for _ in range(2))
    tq, tk, tv = _cuda(q, kp, vp)
    for group in (1, RG_HQ):
        rows = RG_HQ // group
        gtbl = torch.arange(gp, dtype=torch.int32, device="cuda")[
            None].expand(rows, gp).contiguous()
        rtbl = (gp + torch.arange(rp, dtype=torch.int32, device="cuda"))[
            None].expand(rows, rp).contiguous()
        glen = torch.full((rows,), 700, dtype=torch.int32, device="cuda")
        rlen = torch.full((rows,), RG_W, dtype=torch.int32, device="cuda")
        second = (tk, tv, rtbl, rlen)
        got = paged_decode(tq, tk, tv, gtbl, glen, second=second,
                           group=group)
        want = paged_decode_plain(tq, tk, tv, gtbl, glen, second=second,
                                  group=group)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, atol=TOL["float32"], rtol=0)


# ==========================================================================
# the dense baseline's reads: one paged_decode segment over the dense
# buffer, and causal prefill through gated_flash at w_local = S
# ==========================================================================
def _attend(q, k, v, valid):
    """Independent f32 oracle: q [N, hd] over k, v [N, L, hd] where
    ``valid`` [N, L]; a row with nothing valid reads 0."""
    logits = torch.einsum("nd,nld->nl", q.float(), k.float()) \
        * q.shape[-1] ** -0.5
    logits = logits.masked_fill(~valid, float("-inf"))
    w = torch.nan_to_num(torch.softmax(logits, dim=-1))
    return torch.einsum("nl,nld->nd", w, v.float())


@pytest.mark.parametrize("max_len", [37, 4160])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_cache_attention_matches_plain_on_gpu(max_len, dtype):
    """qwen3-0.6b's heads (16 q on 8 kv, hd 128) over a dense buffer of
    ``max_len`` (37 rounds up to 48 slots) at t 0, 1 and max_len."""
    from repro_torch.kernels import ops
    from repro_torch.models.attention import DenseCache, init_dense_cache
    rng = np.random.default_rng(40)
    b, hq, hkv, hd = 3, 16, 8, 128
    cache = init_dense_cache(b, hkv, hd, max_len, TDT[dtype], "cuda")
    s_max = cache.k.shape[2]
    assert s_max % 16 == 0 and s_max - 16 < max_len <= s_max
    k, v = (rng.standard_normal((b, hkv, s_max, hd)).astype(np.float32)
            for _ in range(2))
    cache.k.copy_(torch.from_numpy(k))
    cache.v.copy_(torch.from_numpy(v))
    cache.t.copy_(torch.tensor([0, 1, max_len], dtype=torch.int32))
    q = _cuda(rng.standard_normal((b, hq, hd)).astype(np.float32),
              dtype=TDT[dtype])[0]
    before = PD.launches.count
    out = ops.dense_cache_attention(q, cache)
    torch.cuda.synchronize()
    assert PD.launches.count == before + 1
    cpu = DenseCache(*(x.cpu() for x in cache))
    plain = ops.dense_cache_attention(q.cpu(), cpu)
    err = float((out.cpu().float() - plain.float()).abs().max())
    assert err <= TOL[dtype], err
    kk = cpu.k.repeat_interleave(hq // hkv, dim=1).reshape(b * hq, s_max, hd)
    vv = cpu.v.repeat_interleave(hq // hkv, dim=1).reshape(b * hq, s_max, hd)
    valid = (torch.arange(s_max)[None] < cpu.t.repeat_interleave(hq)[:, None])
    want = _attend(q.cpu().reshape(b * hq, hd), kk, vv, valid)
    err = float((out.cpu().float().reshape(b * hq, hd) - want).abs().max())
    assert err <= TOL[dtype], err
    assert float(out[0].abs().max()) == 0.0            # t = 0 reads 0
    odd = DenseCache(cache.k[:, :, :37], cache.v[:, :, :37], cache.t)
    with pytest.raises(ValueError, match="page-aligned"):
        ops.dense_cache_attention(q, odd)


@pytest.mark.parametrize("s", [200, 2048])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_attention_matches_plain_causal_on_gpu(s, dtype):
    """``ops.causal_attention`` (``gated_flash`` with g = 1, w_local = S)
    against plain causal softmax attention."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import gated_flash as GF
    rng = np.random.default_rng(41)
    b, hq, hkv, hd = 1, 16, 8, 128
    q, k, v = _cuda(rng.standard_normal((b, hq, s, hd)).astype(np.float32),
                    rng.standard_normal((b, hkv, s, hd)).astype(np.float32),
                    rng.standard_normal((b, hkv, s, hd)).astype(np.float32),
                    dtype=TDT[dtype])
    before = GF.launches.count
    out = ops.causal_attention(q, k, v)
    torch.cuda.synchronize()
    assert GF.launches.count == before + 1
    g = hq // hkv
    kk = k.float().repeat_interleave(g, dim=1)
    vv = v.float().repeat_interleave(g, dim=1)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk) * hd ** -0.5
    causal = torch.ones(s, s, dtype=torch.bool, device="cuda").tril()
    want = torch.einsum("bhqk,bhkd->bhqd",
                        torch.softmax(logits.masked_fill(~causal,
                                                         float("-inf")), -1),
                        vv)
    err = float((out.float() - want).abs().max())
    assert err <= TOL[dtype], err


def test_cow_pages_read_by_paged_decode_on_gpu():
    """A prefix entry's stream shared into a slot, then written through
    the slot (an append onto the shared tail page, an overwrite in the
    first page): the kernel reads each stream's own bytes from the
    uploaded pool, and the entry's read is unchanged."""
    from repro_torch.serving.paged import PagedKVPool
    rng = np.random.default_rng(42)
    hd = 128
    pool = PagedKVPool(64, hd, device="cuda")
    src, dst = ("pfx", "k", (0, 0), 0, "global"), (0, (0, 0), 0, "global")
    for _ in range(40):
        kv = rng.standard_normal((2, hd)).astype(np.float32)
        pool.append(src, kv[0], kv[1])
    q = _cuda(rng.standard_normal((2, hd)).astype(np.float32))[0]

    def read(keys):
        out = paged_decode(q[:len(keys)].contiguous(),
                           *pool.kernel_args(keys))
        torch.cuda.synchronize()
        return out.cpu()

    entry_before = read([src])
    pool.share_stream(src, dst)
    for _ in range(3):
        kv = rng.standard_normal((2, hd)).astype(np.float32)
        pool.append(dst, kv[0], kv[1])
    kv = rng.standard_normal((2, hd)).astype(np.float32)
    pool.overwrite(dst, 5, kv[0], kv[1])
    assert pool.table(src).pages[0] != pool.table(dst).pages[0]
    assert pool.table(src).pages[1] == pool.table(dst).pages[1]
    assert pool.table(src).pages[2] != pool.table(dst).pages[2]
    out = read([src, dst])
    assert torch.equal(out[:1], entry_before)
    for i, key in enumerate((src, dst)):
        k, v = (torch.from_numpy(a) for a in pool.gather(key))
        want = _attend(q[i:i + 1].cpu(), k[None], v[None],
                       torch.ones(1, k.shape[0], dtype=torch.bool))
        err = float((out[i:i + 1] - want).abs().max())
        assert err <= TOL["float32"], (key, err)


# ==========================================================================
# the backward kernels (training): gate_mlp_bwd and gated_flash_bwd
# against their plain versions and autograd, 1e-4 of each gradient's
# largest magnitude (dg's 1 / (g + eps) near g = 0 makes an elementwise
# limit meaningless); two calls bitwise equal
# ==========================================================================
BWD_REL = 1e-4


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


@pytest.mark.parametrize("rows,s,h,f,m", [
    (4, 128, 2, 64, 32),      # the bench substrate, batch 2
    (16, 2048, 8, 256, 64),   # qwen3-0.6b, batch 2 x 2048 tokens
    (3, 100, 1, 512, 64),     # F 512 (hd 256), ragged S
    (8, 37, 8, 160, 24),      # F 160 (hd 80), M not a power of two
    (24, 1000, 8, 256, 64),   # three rows per head, a ragged last tile
    (2, 64, 1, 1024, 16),     # shared memory for one x tile, padded rows
    (2, 64, 2, 1024, 32),     # one x tile, w1[h] rows unpadded
    (1, 4096, 1, 512, 64),    # recurrentgemma-9b's training shape
    (10, 2048, 5, 128, 64),   # smollm-360m's, batch 2 (F 128, 5 heads)
])
def test_gate_mlp_bwd_kernel_matches_plain_on_gpu(rows, s, h, f, m):
    rng = np.random.default_rng(30)
    _, w1, b1, w2, b2 = _gate_inputs(rng, h, 1, f, m)
    x = rng.standard_normal((rows, s, f)).astype(np.float32)
    dg = rng.standard_normal((rows, s)).astype(np.float32)
    args = _cuda(x, w1, b1, w2, b2)
    (tdg,) = _cuda(dg)
    ins = [t.clone().requires_grad_() for t in args]
    g = gate_mlp(*ins)           # the kernel, through its autograd Function
    auto = torch.autograd.grad(g, ins, tdg)
    got = gate_mlp_bwd(*args, g.detach(), tdg)
    again = gate_mlp_bwd(*args, g.detach(), tdg)
    want = gate_mlp_bwd_plain(*args, g.detach(), tdg)
    torch.cuda.synchronize()
    for a, b, c, d in zip(got, want, auto, again):
        assert a.shape == b.shape
        assert _rel(a, b) <= BWD_REL
        assert torch.equal(a, c)   # autograd ran the same kernel
        assert torch.equal(a, d)   # two calls bitwise equal


@pytest.mark.parametrize("rows,s,h,f,m", [
    (4, 128, 2, 64, 32),      # the bench substrate, batch 2
    (16, 2048, 8, 256, 64),   # qwen3-0.6b, batch 2 x 2048 tokens
    (3, 100, 1, 512, 64),     # F 512: a tile of 16 tokens
    (8, 37, 8, 160, 24),      # partial rows whose length is no multiple of 4
])
def test_gate_mlp_bwd_reads_no_stale_scratch_on_gpu(rows, s, h, f, m):
    """The kernel's scratch of partial sums is ``torch.empty``: filled with
    NaN before the call (the caching allocator hands the freed block to the
    next allocation of its size, the scratch), it must leave no gradient
    non-finite or off its plain version."""
    rng = np.random.default_rng(33)
    _, w1, b1, w2, b2 = _gate_inputs(rng, h, 1, f, m)
    x = rng.standard_normal((rows, s, f)).astype(np.float32)
    dg = rng.standard_normal((rows, s)).astype(np.float32)
    args = _cuda(x, w1, b1, w2, b2)
    (tdg,) = _cuda(dg)
    g = gate_mlp_plain(*args)
    want = gate_mlp_bwd_plain(*args, g, tdg)
    _, floats = bwd_scratch(rows, s, f, m, h)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    stale = torch.full((floats,), float("nan"), device="cuda")
    ptr = stale.data_ptr()
    del stale
    probe = torch.empty(floats, device="cuda")
    assert probe.data_ptr() == ptr and bool(probe.isnan().all())
    del probe
    got = gate_mlp_bwd(*args, g, tdg)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert bool(torch.isfinite(a).all())
        assert _rel(a, b) <= BWD_REL


@pytest.mark.parametrize("nq,nk,s,hd,w", [
    (8, 4, 128, 32, 16),      # the bench substrate, batch 2, group 2
    (32, 16, 2048, 128, 256), # qwen3-0.6b, batch 2 x 2048 tokens
    (4, 2, 200, 80, 16),      # hd 80, S not a multiple of the tile
    (2, 2, 64, 64, 1),        # group 1, W 1
    (4, 1, 96, 128, 96),      # MQA, W = S: dg exactly 0
    (8, 2, 320, 64, 100),     # group 4, the window edge across tiles
    (16, 1, 1000, 256, 300),  # hd 256, recurrentgemma-9b's MQA group 16
    (4, 1, 200, 256, 64),     # hd 256, group 4, S not a multiple of 64
    (6, 2, 130, 256, 16),     # hd 256, two kv streams of group 3
    (3, 1, 100, 256, 200),    # hd 256, W > S: dg exactly 0
    (15, 5, 700, 64, 256),    # group 3 (smollm-360m's 15 / 5), hd 64
    (6, 2, 200, 80, 16),      # group 3 at hd 80 (its reduced config)
])
def test_gated_flash_bwd_kernel_matches_plain_on_gpu(nq, nk, s, hd, w):
    rng = np.random.default_rng(31)
    q, do = (rng.standard_normal((nq, s, hd)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((nk, s, hd)).astype(np.float32)
            for _ in range(2))
    g = rng.uniform(0, 1, (nk, s)).astype(np.float32)
    g[0, :5] = 1e-7
    tq, tk, tv, tg, tdo = _cuda(q, k, v, g, do)
    kw = {"w_local": w, "group": nq // nk}
    ins = [t.clone().requires_grad_() for t in (tq, tk, tv, tg)]
    out = gated_flash(*ins, **kw)   # the kernels, through autograd
    auto = torch.autograd.grad(out, ins, tdo)
    o, lse = GF._forward_cuda(tq, tk, tv, tg, w, 1e-6, nq // nk, True)
    o_plain, lse_plain = gated_flash_plain(tq, tk, tv, tg, with_lse=True,
                                           **kw)
    got = gated_flash_bwd(tq, tk, tv, tg, o, lse, tdo, **kw)
    again = gated_flash_bwd(tq, tk, tv, tg, o, lse, tdo, **kw)
    want = gated_flash_bwd_plain(tq, tk, tv, tg, o, lse, tdo, **kw)
    plain_auto = torch.autograd.grad(
        gated_flash_plain(*ins, **kw), ins, tdo)
    torch.cuda.synchronize()
    torch.testing.assert_close(o, o_plain, atol=TOL["float32"], rtol=0)
    torch.testing.assert_close(lse, lse_plain, atol=TOL["float32"], rtol=0)
    for a, b, c, d, e in zip(got, want, auto, again, plain_auto):
        if w >= s and a.shape == tg.shape:
            assert not torch.any(a) and not torch.any(b)
            continue
        assert _rel(a, b) <= BWD_REL
        assert _rel(a, e) <= BWD_REL
        assert torch.equal(a, c)
        assert torch.equal(a, d)


def _smoke():
    """``chip_smoke.py`` as a module: it holds the planted backward faults
    (``BWD_FAULTS``) and ``Planted``, which builds the kernels with them,
    so this test and the card's smoke run plant the same faults."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_SMOKE = _smoke()


@pytest.mark.parametrize("kernel", sorted(_SMOKE.BWD_FAULTS))
def test_bwd_limit_catches_a_planted_fault(kernel):
    """Mutation check of BWD_REL: the sound kernel reads below it, the
    kernel built from a copy with the fault planted reads above it.
    Prints both errors (``-s``)."""
    rng = np.random.default_rng(32)
    if kernel == "rglru_scan_bwd":
        a = rng.uniform(0.9, 0.999, (2, 700, 40)).astype(np.float32)
        x, dy = (rng.standard_normal((2, 700, 40)).astype(np.float32)
                 for _ in range(2))
        ta, tx, tdy = _cuda(a, x, dy)
        h = rglru_scan_plain(ta, tx)
        run = lambda: rglru_scan_bwd(ta, h, tdy)  # noqa: E731
        want = rglru_scan_bwd_plain(ta, h, tdy)
    elif kernel == "gated_flash_bwd_hd256":
        q, do = (rng.standard_normal((4, 150, 256)).astype(np.float32)
                 for _ in range(2))
        k, v = (rng.standard_normal((1, 150, 256)).astype(np.float32)
                for _ in range(2))
        g = rng.uniform(0, 1, (1, 150)).astype(np.float32)
        tq, tk, tv, tg, tdo = _cuda(q, k, v, g, do)
        o, lse = gated_flash_plain(tq, tk, tv, tg, w_local=32, group=4,
                                   with_lse=True)
        run = lambda: gated_flash_bwd(tq, tk, tv, tg, o, lse, tdo,  # noqa
                                      w_local=32, group=4)
        want = gated_flash_bwd_plain(tq, tk, tv, tg, o, lse, tdo,
                                     w_local=32, group=4)
    elif kernel == "gate_mlp_bwd":
        _, w1, b1, w2, b2 = _gate_inputs(rng, 2, 1, 64, 32)
        x = rng.standard_normal((4, 128, 64)).astype(np.float32)
        args = _cuda(x, w1, b1, w2, b2)
        g = gate_mlp_plain(*args)
        (dg,) = _cuda(rng.standard_normal((4, 128)).astype(np.float32))
        run = lambda: gate_mlp_bwd(*args, g, dg)  # noqa: E731
        want = gate_mlp_bwd_plain(*args, g, dg)
    else:
        q, do = (rng.standard_normal((8, 128, 32)).astype(np.float32)
                 for _ in range(2))
        k, v = (rng.standard_normal((4, 128, 32)).astype(np.float32)
                for _ in range(2))
        g = rng.uniform(0, 1, (4, 128)).astype(np.float32)
        tq, tk, tv, tg, tdo = _cuda(q, k, v, g, do)
        o, lse = gated_flash_plain(tq, tk, tv, tg, w_local=16, group=2,
                                   with_lse=True)
        run = lambda: gated_flash_bwd(tq, tk, tv, tg, o, lse, tdo,  # noqa
                                      w_local=16, group=2)
        want = gated_flash_bwd_plain(tq, tk, tv, tg, o, lse, tdo,
                                     w_local=16, group=2)
    sound = max(_rel(a, b) for a, b in zip(run(), want))
    with _SMOKE.Planted([kernel]):
        planted = max(_rel(a, b) for a, b in zip(run(), want))
    print(f"\n{kernel} max |d| / max |ref|: sound {sound:.3e}, planted "
          f"{planted:.3e} (limit {BWD_REL:.0e})")
    assert sound <= BWD_REL < planted


def test_forward_only_kernels_refuse_grad_on_gpu():
    """``vertical_slash``, ``paged_decode`` and ``paged_decode_selected``
    have no backward: with grad enabled and an input that requires it they
    raise (their fresh outputs would carry no graph); under
    torch.no_grad() they run. (``rglru_scan`` has had a backward kernel
    since ``csrc/rglru_scan_bwd.cu``; its tests are below.)"""
    rng = np.random.default_rng(33)
    q, k, v = _cuda(*(rng.standard_normal((2, 64, 32)).astype(np.float32)
                      for _ in range(3)))
    kg, vg, gpos = _vs_globals(rng, 2, 64, 16, 8, k.cpu().numpy(),
                               v.cpu().numpy())
    kg, vg, gpos = _cuda(kg, vg, gpos)
    qd, kp, vp, tbl, lens = _cuda(*_paged_inputs(rng, 4, 64, 16, 12, 3))
    ids = torch.zeros((4, 1), dtype=torch.int32, device="cuda")
    nsel = torch.ones(4, dtype=torch.int32, device="cuda")
    calls = {
        "vertical_slash": lambda x: vertical_slash(x, k, v, kg, vg, gpos,
                                                   w_local=16),
        "paged_decode": lambda x: paged_decode(qd, x, vp, tbl, lens),
        "paged_decode_selected": lambda x: paged_decode_selected(
            qd, x, vp, tbl, lens, ids, nsel),
    }
    leaves = {"vertical_slash": q, "paged_decode": kp,
              "paged_decode_selected": kp}
    for name, call in calls.items():
        x = leaves[name].clone().requires_grad_()
        with pytest.raises(RuntimeError, match="forward-only"):
            call(x)
        with torch.no_grad():
            call(x)
    torch.cuda.synchronize()


def test_gate_gradients_on_gpu_match_cpu_and_remat():
    """The trainer's gate gradients on reduced qwen3-0.6b (2 layers, hd 64,
    W 16 < S) through the backward kernels equal the CPU's plain autograd
    within BWD_REL of each tensor's max, and ``remat=True`` (each block's
    forward, lse included, run again in the backward) gives the same bits."""
    import dataclasses

    from repro_torch.configs import get_reduced_config
    from repro_torch.models.transformer import init_model
    from repro_torch.training import trainer as TR
    from repro_torch.tree import tree_map
    cfg = get_reduced_config("qwen3-0.6b").replace(dtype="float32")
    cfg = cfg.replace(wgkv=dataclasses.replace(cfg.wgkv, w_local=16))
    params = init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.from_numpy(np.random.default_rng(34).integers(
        0, cfg.vocab_size - 8, (2, 64)))
    want = TR.loss_and_grads(TR.get_gates(params), params, cfg,
                             {"tokens": toks}, lam=0.3)
    gparams = tree_map(lambda t: t.cuda(), params)
    got, got_remat = (TR.loss_and_grads(TR.get_gates(gparams), gparams, cfg,
                                        {"tokens": toks.cuda()}, lam=0.3,
                                        remat=remat)
                      for remat in (False, True))
    torch.cuda.synchronize()
    assert abs(float(got[0]) - float(want[0])) <= 1e-5 * abs(float(want[0]))
    for k, w in want[2].items():
        assert _rel(got[2][k].cpu(), w) <= BWD_REL, k
        assert torch.equal(got[2][k], got_remat[2][k]), k


# ==========================================================================
# the RG-LRU scan's backward (the hybrid's training path)
# ==========================================================================
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("b,s,d", [
    (1, 4096, 512),   # recurrentgemma-9b's 4096 steps (32 chunks)
    (3, 1000, 200),   # ragged chunks and channel blocks
    (2, 128, 33),     # one whole chunk
    (1, 1, 5),        # one step
])
def test_rglru_scan_bwd_kernel_matches_plain_on_gpu(b, s, d, with_h0):
    """The kernel against the plain reverse loop on the forward kernel's h,
    and through the model's scan (the autograd Function; a carried-in
    state folded into b[:, 0]) against autograd of the plain loop, a in
    (0.9, 0.999) so that what a chunk hands down matters; two calls
    bitwise equal, and the Function's backward is the same kernel."""
    rng = np.random.default_rng(35)
    a = rng.uniform(0.9, 0.999, (b, s, d)).astype(np.float32)
    x, dy = (rng.standard_normal((b, s, d)).astype(np.float32)
             for _ in range(2))
    h0 = rng.standard_normal((b, d)).astype(np.float32)
    ta, tx, tdy, th0 = _cuda(a, x, dy, h0)
    xf = tx.clone()
    if with_h0:
        xf[:, 0] = xf[:, 0] + ta[:, 0] * th0
    h = rglru_scan(ta, xf)
    got = rglru_scan_bwd(ta, h, tdy)
    again = rglru_scan_bwd(ta, h, tdy)
    want = rglru_scan_bwd_plain(ta, h, tdy)
    n = 3 if with_h0 else 2
    ins = [t.clone().requires_grad_() for t in (ta, tx, th0)[:n]]
    auto = torch.autograd.grad(
        RG.rglru_scan(ins[0], ins[1], ins[2] if with_h0 else None), ins, tdy)
    pins = [t.clone().requires_grad_() for t in (ta, tx, th0)[:n]]
    px = pins[1]
    if with_h0:
        px = px.clone()
        px[:, 0] = px[:, 0] + pins[0][:, 0] * pins[2]
    plain_auto = torch.autograd.grad(rglru_scan_plain(pins[0], px), pins,
                                     tdy)
    torch.cuda.synchronize()
    for g, w, r in zip(got, want, again):
        assert _rel(g, w) <= BWD_REL
        assert torch.equal(g, r)
    for g, w in zip(auto, plain_auto):
        assert _rel(g, w) <= BWD_REL
    if not with_h0:
        for g, w in zip(auto, got):
            assert torch.equal(g, w)


def test_hybrid_gate_gradients_on_gpu_match_cpu_and_remat():
    """The trainer's gate gradients on the reduced hybrid (a 2-block RG-LRU
    stem and two repeats, so the gradient runs back through RG-LRU blocks:
    rglru_scan_bwd, gated_flash_bwd at hd 64 group 4, gate_mlp_bwd; S 96
    past the 64-token window) through the kernels equal the CPU's plain
    autograd within BWD_REL of each tensor's max, and ``remat=True``
    gives the same bits."""
    from repro_torch.configs import get_reduced_config
    from repro_torch.kernels import rglru_scan as RS
    from repro_torch.models.transformer import init_model
    from repro_torch.training import trainer as TR
    from repro_torch.tree import tree_map
    cfg = get_reduced_config("recurrentgemma-9b").replace(
        dtype="float32", stem_pattern=("rglru", "rglru"), n_repeats=2)
    params = init_model(cfg, torch.Generator().manual_seed(1), "cpu")
    toks = torch.from_numpy(np.random.default_rng(37).integers(
        0, cfg.vocab_size - 8, (2, 96)))
    want = TR.loss_and_grads(TR.get_gates(params), params, cfg,
                             {"tokens": toks}, lam=0.3)
    gparams = tree_map(lambda t: t.cuda(), params)
    RS.bwd_launches.reset()
    got, got_remat = (TR.loss_and_grads(TR.get_gates(gparams), gparams, cfg,
                                        {"tokens": toks.cuda()}, lam=0.3,
                                        remat=remat)
                      for remat in (False, True))
    torch.cuda.synchronize()
    assert RS.bwd_launches.count == 2 * 2   # repeat 1's two RG-LRU blocks
    assert float(want[1]["distill"]) > 0
    assert abs(float(got[0]) - float(want[0])) <= 1e-5 * abs(float(want[0]))
    for k, w in want[2].items():
        assert _rel(got[2][k].cpu(), w) <= BWD_REL, k
        assert torch.equal(got[2][k], got_remat[2][k]), k
