"""The split-K decode read with GQA-shared tables, and the numeric design of
the tensor-core ``gated_flash``, on the CPU.

- ``paged_decode`` / ``paged_decode_selected`` with ``group=G`` and tables,
  lengths and ids per kv stream equal the ``group=1`` call with them
  repeated per query row (bitwise: the plain path repeats them), and the
  reference's Pallas kernels (interpret mode) at 5e-5 in float32.
- The split plan (``split_plan``, a function of shapes) covers every walk
  position once and in order, fills the card at the serving shapes, and
  gives both entries the same plan at the identity ids with K = every page.
- A numpy emulation of the 3xTF32 split of ``csrc/flash_mma.cuh`` (an
  operand's TF32 value: its mantissa cut to 10 bits) keeps write-gated
  attention within 5e-5 of float32 at hd 128 and 256, where one TF32 pass
  does not.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_decode import paged_decode as pallas_paged_decode
from repro.kernels.paged_decode import \
    paged_decode_selected as pallas_paged_decode_selected
from repro_torch.kernels import paged_decode as PD
from repro_torch.kernels.gated_flash import gated_flash_plain

torch.set_num_threads(2)

TOL = 5e-5


def _inputs(rng, nkv, g, hd, ptotal, mp):
    q = rng.standard_normal((nkv * g, hd)).astype(np.float32)
    kp = rng.standard_normal((ptotal, 16, hd)).astype(np.float32)
    vp = rng.standard_normal((ptotal, 16, hd)).astype(np.float32)
    tbl = rng.integers(0, ptotal, (nkv, mp)).astype(np.int32)
    lens = rng.integers(1, mp * 16, (nkv,)).astype(np.int32)
    lens[0] = 0
    return q, kp, vp, tbl, lens


def _rep(a, g):
    return np.repeat(a, g, axis=0)


@pytest.mark.parametrize("g,hd", [(1, 64), (2, 128), (4, 64), (16, 32)])
def test_grouped_tables_match_repeated_tables_and_pallas(g, hd):
    rng = np.random.default_rng(30 + g)
    q, kp, vp, tbl, lens = _inputs(rng, 3, g, hd, 24, 5)
    t = [torch.from_numpy(a) for a in (q, kp, vp, tbl, lens)]
    got = PD.paged_decode(*t, group=g)
    rep = PD.paged_decode(t[0], t[1], t[2], torch.from_numpy(_rep(tbl, g)),
                          torch.from_numpy(_rep(lens, g)))
    assert torch.equal(got, rep)
    assert torch.all(got[:g] == 0)  # kv stream 0 has length 0
    pallas = np.asarray(pallas_paged_decode(
        *map(jnp.asarray, (q, kp, vp, _rep(tbl, g), _rep(lens, g)))))
    np.testing.assert_allclose(got.numpy(), pallas, atol=TOL, rtol=TOL)
    # a second segment (the ring), per kv stream as well
    second = (t[1], t[2], t[3][:, :2].contiguous(), t[4] // 3)
    two = PD.paged_decode(*t, second=second, group=g)
    two_rep = PD.paged_decode(
        t[0], t[1], t[2], torch.from_numpy(_rep(tbl, g)),
        torch.from_numpy(_rep(lens, g)),
        second=(t[1], t[2], torch.from_numpy(_rep(tbl[:, :2], g)),
                torch.from_numpy(_rep(lens // 3, g))))
    assert torch.equal(two, two_rep)


@pytest.mark.parametrize("g", [1, 2, 16])
def test_grouped_selected_matches_repeated_ids_and_pallas(g):
    rng = np.random.default_rng(40 + g)
    nkv, hd, mp, k = 3, 64, 6, 3
    q, kp, vp, tbl, lens = _inputs(rng, nkv, g, hd, 24, mp)
    sel = np.sort(np.argsort(rng.random((nkv, mp)), axis=-1)[:, :k],
                  axis=-1).astype(np.int32)
    nsel = np.array([k, 1, 2], np.int32)   # n_sel below K on two streams
    t = [torch.from_numpy(a) for a in (q, kp, vp, tbl, lens, sel, nsel)]
    got = PD.paged_decode_selected(*t, group=g)
    rep = PD.paged_decode_selected(
        t[0], t[1], t[2], *(torch.from_numpy(_rep(a, g))
                            for a in (tbl, lens, sel, nsel)))
    assert torch.equal(got, rep)
    pallas = np.asarray(pallas_paged_decode_selected(
        *map(jnp.asarray, (q, kp, vp) + tuple(
            _rep(a, g) for a in (tbl, lens, sel, nsel)))))
    np.testing.assert_allclose(got.numpy(), pallas, atol=TOL, rtol=TOL)


def test_grouped_selected_identity_is_bitwise_full_read():
    rng = np.random.default_rng(50)
    nkv, g, hd, mp = 4, 2, 64, 5
    q, kp, vp, tbl, lens = _inputs(rng, nkv, g, hd, 24, mp)
    t = [torch.from_numpy(a) for a in (q, kp, vp, tbl, lens)]
    sel = torch.arange(mp, dtype=torch.int32)[None].expand(nkv, mp)
    nsel = torch.full((nkv,), mp, dtype=torch.int32)
    second = (t[1], t[2], t[3][:, :2].contiguous(), t[4] // 2)
    for seg2 in (None, second):
        full = PD.paged_decode(*t, second=seg2, group=g)
        got = PD.paged_decode_selected(*t, sel.contiguous(), nsel,
                                       second=seg2, group=g)
        assert torch.equal(got, full)
        assert PD.walk_plan(t[0], t[3], seg2, group=g, sel_ids=sel) == \
            PD.walk_plan(t[0], t[3], seg2, group=g)


# (walk pages, kv streams, group, hd): qwen3-0.6b serving (2 slots, C 128 ‖
# W 256), recurrentgemma-9b serving (C 128 ‖ W 2048) and offline (C 1024 ‖
# W 2048), pd_big (8 slots, C 1024 ‖ W 256), decode-select (K 8 ‖ W 256),
# the pool check (group 1), a tiny one and a wide group
SHAPES = [(24, 16, 2, 128), (136, 2, 16, 256), (192, 1, 16, 256),
          (80, 64, 2, 128), (24, 8, 2, 128), (40, 56, 1, 128), (1, 1, 1, 32),
          (7, 3, 64, 64), (300, 5, 40, 96)]


@pytest.mark.parametrize("walk,nkv,g,hd", SHAPES)
def test_split_plan_covers_the_walk_once_in_order(walk, nkv, g, hd):
    plan = PD.split_plan(walk, nkv, g, hd)
    # split s walks positions [s * pages_per_split, (s + 1) * ...) of the
    # walk, cut at its end (csrc/paged_decode.cu, split_kernel)
    p = plan.pages_per_split
    ranges = [(s * p, min((s + 1) * p, walk)) for s in range(plan.n_splits)]
    covered = [j for a, b in ranges for j in range(a, b)]
    assert covered == list(range(walk))
    assert all(b > a for a, b in ranges)  # no empty split
    # every head of the group in some CTA, each CTA within its capacity
    chunks = -(-g // plan.heads)
    assert plan.heads <= min(g, PD.max_heads(hd)) and chunks * plan.heads >= g
    ctas = nkv * chunks * plan.n_splits
    assert ctas >= min(PD.SMS, walk * nkv * chunks)   # fills the card
    assert plan.n_splits <= 65535


def test_split_plan_depends_on_shapes_only():
    """The plan comes from tensor shapes: two reads that differ only in
    lengths, ids and counts get the same plan."""
    rng = np.random.default_rng(51)
    q, kp, vp, tbl, lens = _inputs(rng, 4, 2, 64, 24, 6)
    t = [torch.from_numpy(a) for a in (q, kp, vp, tbl, lens)]
    p1 = PD.walk_plan(t[0], t[3], group=2)
    t[4].zero_()
    assert PD.walk_plan(t[0], t[3], group=2) == p1
    assert p1 == PD.split_plan(6, 4, 2, 64)


# ==========================================================================
# 3xTF32: the numeric design of the f32 tensor-core gated_flash
# ==========================================================================
def _tf32(x):
    """The TF32 value of float32 x as the tensor cores read an operand:
    the low 13 mantissa bits cleared (10 kept)."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return (bits & np.uint32(0xFFFFE000)).view(np.float32)


def _mm(a, b, passes):
    """a @ b as the tensor cores compute it from f32 inputs: 3xTF32 (hi =
    the TF32 value, lo = x - hi read as TF32; lo*hi + hi*lo + hi*hi, in
    that order) or one TF32 pass (hi*hi)."""
    ah, bh = _tf32(a), _tf32(b)
    if passes == 1:
        return np.matmul(ah, bh)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return (np.matmul(al, bh) + np.matmul(ah, bl)) + np.matmul(ah, bh)


def _gated_emulated(q, k, v, g, w, eps, passes):
    s, hd = q.shape[1], q.shape[2]
    logits = _mm(q, np.swapaxes(k, 1, 2), passes) * np.float32(hd ** -0.5)
    i = np.arange(s)[:, None]
    j = np.arange(s)[None, :]
    logg = np.log(g + np.float32(eps)).astype(np.float32)[:, None, :]
    bias = np.where(i - j < w, np.float32(0), logg)
    logits = np.where(j > i, np.float32(-1e30), logits + bias)
    p = np.exp(logits - logits.max(-1, keepdims=True)).astype(np.float32)
    return _mm(p, v, passes) / p.sum(-1, keepdims=True)


@pytest.mark.parametrize("hd", [128, 256])
def test_3xtf32_keeps_the_f32_tolerance_where_one_tf32_pass_does_not(hd):
    rng = np.random.default_rng(60 + hd)
    n, s, w = 2, 256, 64
    q, k, v = (rng.standard_normal((n, s, hd)).astype(np.float32)
               for _ in range(3))
    g = rng.uniform(0.0, 1.0, (n, s)).astype(np.float32)
    want = gated_flash_plain(*map(torch.from_numpy, (q, k, v, g)),
                             w_local=w, eps=1e-6).numpy()
    err3 = np.abs(_gated_emulated(q, k, v, g, w, 1e-6, 3) - want).max()
    err1 = np.abs(_gated_emulated(q, k, v, g, w, 1e-6, 1) - want).max()
    assert err3 <= TOL < err1, (err3, err1)
