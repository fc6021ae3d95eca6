"""The port's kernel modules vs the reference's Pallas kernels (interpret
mode) and oracles, on the CPU: each wrapper runs its plain PyTorch version
for CPU tensors, and that version is what the CUDA kernel is held to on
the card (``chip_smoke.py``, and the ``cuda``-marked tests of
``tests/test_torch_cuda.py``, which import no JAX so that they run on a
machine with a GPU).

Sweeps and tolerances follow ``tests/test_kernels.py``: ``paged_decode``,
``gated_flash`` and ``vertical_slash`` at 5e-5 in float32 and 5e-2 in
bfloat16, ``gate_mlp`` at 1e-5 in float32. Inputs are drawn with numpy
from a seed and handed to both packages.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dual_cache as JDC
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.gate_mlp import gate_mlp as pallas_gate_mlp
from repro.kernels.gated_flash import gated_flash as pallas_gated_flash
from repro.kernels.paged_decode import paged_decode as pallas_paged_decode
from repro.kernels.vertical_slash import vertical_slash as pallas_vertical_slash
from repro_torch.core import dual_cache as TDC
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.gate_mlp import gate_mlp
from repro_torch.kernels.gate_mlp import plan as gate_plan
from repro_torch.kernels.gated_flash import gated_flash
from repro_torch.kernels.paged_decode import paged_decode
from repro_torch.kernels.vertical_slash import vertical_slash

torch.set_num_threads(2)

TOL = {"float32": 5e-5, "bfloat16": 5e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _np32(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


# ==========================================================================
# gate_mlp
# ==========================================================================
def _gate_inputs(rng, h, s, f, m):
    x = rng.standard_normal((h, s, f)).astype(np.float32)
    w1 = (0.1 * rng.standard_normal((h, f, m))).astype(np.float32)
    b1 = (0.1 * rng.standard_normal((h, m))).astype(np.float32)
    w2 = (0.1 * rng.standard_normal((h, m, 1))).astype(np.float32)
    b2 = np.zeros((h, 1), np.float32)
    return x, w1, b1, w2, b2


@pytest.mark.parametrize("h,s,f,m,bs", [
    (4, 512, 128, 64, 128), (2, 64, 64, 32, 64), (8, 256, 256, 16, 256),
])
def test_gate_mlp_matches_pallas_and_oracles(h, s, f, m, bs):
    args = _gate_inputs(np.random.default_rng(4), h, s, f, m)
    pallas = np.asarray(pallas_gate_mlp(*map(jnp.asarray, args), bs=bs))
    jax_ref = np.asarray(jref.gate_mlp_ref(*map(jnp.asarray, args)))
    targs = [torch.from_numpy(a) for a in args]
    out = gate_mlp(*targs)
    assert out.dtype == torch.float32 and tuple(out.shape) == (h, s)
    got = out.numpy()
    np.testing.assert_allclose(got, pallas, atol=1e-5)
    np.testing.assert_allclose(got, jax_ref, atol=1e-5)
    np.testing.assert_allclose(got, tref.gate_mlp_ref(*targs).numpy(),
                               atol=1e-5)
    assert ((got > 0) & (got < 1)).all()


@pytest.mark.parametrize("r,s,h,tile", [
    (16, 1, 8, 0),        # qwen3-0.6b decode, 2 slots: the decode path
    (2, 1, 1, 0),         # recurrentgemma-9b decode
    (128, 1, 8, 0),       # 16 slots: 16 tokens per head
    (136, 1, 8, 64),      # 17 tokens per head: tensor cores
    (16, 4096, 8, 64),    # 1,024 CTAs of 64
    (8, 4096, 8, 64),     # prefill-long: 512 CTAs of 64
    (1, 4096, 1, 16),     # recurrentgemma-9b prefill: 256 CTAs of 16
    (2, 4096, 1, 16),     # 128 CTAs of 64 would leave SMs idle
    (3, 4096, 1, 64),     # 192 CTAs of 64
    (8, 32, 8, 16),       # the tau probe
])
def test_gate_mlp_plan_reads_only_shapes(r, s, h, tile):
    """The CUDA kernel's path and tile come from the shapes alone: the
    decode path up to 16 tokens per head, else a tile of 64 tokens if
    that grid gives every SM a CTA, else of 16."""
    assert gate_plan(r, s, h) == tile


def test_write_gate_folds_batch_by_row_mod_heads():
    """The model-level fold indexes per-head weights with row % H instead
    of tiling them: same result as the reference's tiled ``write_gate``."""
    rng = np.random.default_rng(5)
    b, h, s, f, m = 3, 2, 8, 32, 16
    x = rng.standard_normal((b, h, s, f)).astype(np.float32)
    _, w1, b1, w2, b2 = _gate_inputs(rng, h, 1, f, m)
    want = np.asarray(jops.write_gate(*map(jnp.asarray, (x, w1, b1, w2, b2)),
                                      bs=8))
    got = tops.write_gate(*(torch.from_numpy(a) for a in (x, w1, b1, w2, b2)))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


# ==========================================================================
# paged_decode
# ==========================================================================
def _paged_inputs(rng, n, hd, page, ptotal, mp):
    q = rng.standard_normal((n, hd)).astype(np.float32)
    kp = rng.standard_normal((ptotal, page, hd)).astype(np.float32)
    vp = rng.standard_normal((ptotal, page, hd)).astype(np.float32)
    tbl = rng.integers(0, ptotal, (n, mp)).astype(np.int32)
    lens = rng.integers(1, mp * page, (n,)).astype(np.int32)
    return q, kp, vp, tbl, lens


@pytest.mark.parametrize("n,hd,page,ptotal,mp", [
    (6, 64, 16, 32, 8), (2, 128, 16, 8, 4), (12, 64, 32, 64, 16),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_decode_matches_pallas_and_oracles(n, hd, page, ptotal, mp,
                                                 dtype):
    q, kp, vp, tbl, lens = _paged_inputs(np.random.default_rng(2), n, hd,
                                         page, ptotal, mp)
    jin = [jnp.asarray(a).astype(JDT[dtype]) for a in (q, kp, vp)]
    pallas = _np32(pallas_paged_decode(*jin, jnp.asarray(tbl),
                                       jnp.asarray(lens)))
    jax_ref = _np32(jref.paged_decode_ref(
        *(x.astype(jnp.float32) for x in jin), jnp.asarray(tbl),
        jnp.asarray(lens)))
    tin = [torch.from_numpy(a).to(TDT[dtype]) for a in (q, kp, vp)]
    out = paged_decode(*tin, torch.from_numpy(tbl), torch.from_numpy(lens))
    assert out.dtype == TDT[dtype]
    got = out.float().numpy()
    tol = TOL[dtype]
    np.testing.assert_allclose(got, pallas, atol=tol, rtol=tol)
    np.testing.assert_allclose(got, jax_ref, atol=tol, rtol=tol)
    oracle = tref.paged_decode_ref(*(x.float() for x in tin),
                                   torch.from_numpy(tbl),
                                   torch.from_numpy(lens))
    np.testing.assert_allclose(got, oracle.numpy(), atol=tol, rtol=tol)


def test_paged_decode_length_zero_stream_returns_zero():
    """A fully masked stream keeps the Pallas kernel's handling: m_safe
    and a zero alpha, output acc / max(l, 1e-30) = 0."""
    q, kp, vp, tbl, lens = _paged_inputs(np.random.default_rng(9), 4, 64,
                                         16, 8, 3)
    lens[1] = 0
    pallas = np.asarray(pallas_paged_decode(*map(jnp.asarray,
                                                 (q, kp, vp, tbl, lens))))
    got = paged_decode(*map(torch.from_numpy, (q, kp, vp, tbl, lens))).numpy()
    assert np.all(got[1] == 0.0) and np.all(pallas[1] == 0.0)
    np.testing.assert_allclose(got, pallas, atol=5e-5, rtol=5e-5)


def test_paged_decode_attention_gqa_fold_matches_reference():
    """Model-level fold: [B, Hq, hd] queries over per-(row, kv head) page
    tables, each kv stream shared by its query group."""
    rng = np.random.default_rng(6)
    b, hq, hkv, hd, page, ptotal, mp = 2, 4, 2, 64, 16, 24, 5
    q = rng.standard_normal((b, hq, hd)).astype(np.float32)
    kp = rng.standard_normal((ptotal, page, hd)).astype(np.float32)
    vp = rng.standard_normal((ptotal, page, hd)).astype(np.float32)
    tbl = rng.integers(0, ptotal, (b, hkv, mp)).astype(np.int32)
    lens = rng.integers(1, mp * page, (b, hkv)).astype(np.int32)
    want = np.asarray(jops.paged_decode_attention(
        *map(jnp.asarray, (q, kp, vp, tbl, lens))))
    got = tops.paged_decode_attention(
        *map(torch.from_numpy, (q, kp, vp, tbl, lens)))
    np.testing.assert_allclose(got.numpy(), want, atol=5e-5, rtol=5e-5)


# ==========================================================================
# the two-segment read of the dual cache
# ==========================================================================
def _dual_cache(rng, b, h, c, w, hd, gcnt, t):
    """A DualCache (numpy leaves) with the first gcnt[b, h] global slots
    and the first min(t[b], W) ring slots holding tokens."""
    gk = rng.standard_normal((b, h, c, hd)).astype(np.float32)
    gv = rng.standard_normal((b, h, c, hd)).astype(np.float32)
    lk = rng.standard_normal((b, h, w, hd)).astype(np.float32)
    lv = rng.standard_normal((b, h, w, hd)).astype(np.float32)
    lpos = np.full((b, w), -1, np.int32)
    for i in range(b):
        n = min(int(t[i]), w)
        lpos[i, :n] = np.arange(n)
    p = c // 16
    return dict(lk=lk, lv=lv, lg=np.zeros((b, h, w), np.float32), lpos=lpos,
                gk=gk, gv=gv, gpos=np.zeros((b, h, c), np.int32),
                gcnt=np.asarray(gcnt, np.int32), t=np.asarray(t, np.int32),
                ptr=(np.asarray(t) % w).astype(np.int32),
                overflow=np.zeros((b, h), np.int32),
                pkmin=np.zeros((b, h, p, hd), np.float32),
                pkmax=np.zeros((b, h, p, hd), np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dual_cache_attention_matches_concat_softmax(dtype):
    """Global segment with ragged gcnt (0, partial page, full) and the ring
    before (t < W) and after (t >= W) it wraps, read in place as two
    segments; held against cache_kv_for_attention + softmax in both
    packages."""
    rng = np.random.default_rng(11)
    b, h, g, c, w, hd = 3, 2, 2, 32, 48, 64
    gcnt = [[0, 7], [32, 16], [1, 0]]
    t = [5, 48, 100]
    leaves = _dual_cache(rng, b, h, c, w, hd, gcnt, t)
    q = rng.standard_normal((b, h * g, hd)).astype(np.float32)
    tcache = TDC.DualCache(**{k: torch.from_numpy(v) for k, v in leaves.items()})
    if dtype == "bfloat16":
        tcache = tcache._replace(**{k: getattr(tcache, k).to(torch.bfloat16)
                                    for k in ("gk", "gv", "lk", "lv")})
    tq = torch.from_numpy(q).to(TDT[dtype])
    got = tops.dual_cache_attention(tq, tcache).float().numpy()

    def concat_softmax(k, v, valid, qq):
        qg = qq.reshape(b, h, g, hd)
        lg = np.einsum("bhgd,bhkd->bhgk", qg, k) * hd ** -0.5
        lg = np.where(valid[:, :, None], lg, -1e30)
        wts = np.exp(lg - lg.max(-1, keepdims=True))
        wts /= wts.sum(-1, keepdims=True)
        return np.einsum("bhgk,bhkd->bhgd", wts, v).reshape(b, h * g, hd)

    k, v, valid = TDC.cache_kv_for_attention(tcache)
    want = concat_softmax(k.float().numpy(), v.float().numpy(),
                          valid.numpy(), tq.float().numpy())
    jk, jv, jvalid = JDC.cache_kv_for_attention(JDC.DualCache(
        **{k_: jnp.asarray(v_) for k_, v_ in leaves.items()}))
    np.testing.assert_array_equal(np.asarray(jvalid), valid.numpy())
    tol = TOL[dtype]
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)
    if dtype == "float32":
        np.testing.assert_allclose(
            got, concat_softmax(np.asarray(jk), np.asarray(jv),
                                np.asarray(jvalid), q), atol=tol, rtol=tol)


def test_dual_cache_attention_rejects_unaligned_window():
    rng = np.random.default_rng(1)
    leaves = _dual_cache(rng, 1, 1, 32, 24, 16, [[3]], [5])
    tcache = TDC.DualCache(**{k: torch.from_numpy(v) for k, v in leaves.items()})
    with pytest.raises(ValueError, match="page-aligned"):
        tops.dual_cache_attention(torch.zeros(1, 1, 16), tcache)


# ==========================================================================
# gated_flash
# ==========================================================================
def _gated_inputs(rng, n, s, hd):
    q, k, v = (rng.standard_normal((n, s, hd)).astype(np.float32)
               for _ in range(3))
    g = (1.0 / (1.0 + np.exp(-rng.standard_normal((n, s))))).astype(
        np.float32)
    return q, k, v, g


@pytest.mark.parametrize("n,s,hd,w,bq,bk", [
    (2, 256, 64, 32, 64, 64), (1, 128, 128, 16, 128, 32),
    (3, 512, 64, 256, 128, 128), (1, 64, 256, 8, 32, 16),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gated_flash_matches_pallas_and_oracles(n, s, hd, w, bq, bk, dtype):
    q, k, v, g = _gated_inputs(np.random.default_rng(7), n, s, hd)
    jin = [jnp.asarray(a).astype(JDT[dtype]) for a in (q, k, v)]
    pallas = _np32(pallas_gated_flash(*jin, jnp.asarray(g), w_local=w,
                                      bq=bq, bk=bk))
    jax_ref = _np32(jref.gated_flash_ref(
        *(x.astype(jnp.float32) for x in jin), jnp.asarray(g), w_local=w))
    tin = [torch.from_numpy(a).to(TDT[dtype]) for a in (q, k, v)]
    tg = torch.from_numpy(g)
    out = gated_flash(*tin, tg, w_local=w)
    assert out.dtype == TDT[dtype] and tuple(out.shape) == (n, s, hd)
    got = out.float().numpy()
    tol = TOL[dtype]
    np.testing.assert_allclose(got, pallas, atol=tol, rtol=tol)
    np.testing.assert_allclose(got, jax_ref, atol=tol, rtol=tol)
    oracle = tref.gated_flash_ref(*(t.float() for t in tin), tg, w_local=w)
    np.testing.assert_allclose(got, oracle.numpy(), atol=tol, rtol=tol)


def test_gated_flash_attention_gqa_fold_matches_reference():
    """G = 2 query heads per kv head: the port passes the group to the
    kernel (kv stream n // G) instead of repeating K, V and g."""
    rng = np.random.default_rng(8)
    b, hq, hkv, s, hd, w = 2, 4, 2, 128, 64, 32
    q = rng.standard_normal((b, hq, s, hd)).astype(np.float32)
    k, v = (rng.standard_normal((b, hkv, s, hd)).astype(np.float32)
            for _ in range(2))
    g = rng.uniform(0.0, 1.0, (b, hkv, s)).astype(np.float32)
    want = np.asarray(jops.gated_flash_attention(
        *map(jnp.asarray, (q, k, v, g)), w_local=w, bq=64, bk=32))
    got = tops.gated_flash_attention(*map(torch.from_numpy, (q, k, v, g)),
                                     w_local=w, eps=1e-6)
    np.testing.assert_allclose(got.numpy(), want, atol=5e-5, rtol=5e-5)


def test_gated_flash_plain_is_differentiable():
    """On the CPU the plain version is ordinary autograd PyTorch (the CUDA
    kernel is forward-only and refuses inputs that require grad)."""
    q, k, v, g = (torch.from_numpy(a).requires_grad_()
                  for a in _gated_inputs(np.random.default_rng(9), 2, 32, 16))
    gated_flash(q, k, v, g, w_local=8).sum().backward()
    for t in (q, k, v, g):
        assert t.grad is not None and torch.isfinite(t.grad).all()
    assert float(g.grad.abs().sum()) > 0


# ==========================================================================
# vertical_slash
# ==========================================================================
def _vs_inputs(rng, n, s, hd, w, c, *, sort=True):
    """q, k, v [n, s, hd]; globals gathered at random positions older than
    the last window, a random number of them valid and the rest at
    INT32_MAX (never visible), as the reference's sweep builds them."""
    q, k, v = (rng.standard_normal((n, s, hd)).astype(np.float32)
               for _ in range(3))
    gpos = rng.integers(0, s - w, (n, c))
    if sort:
        gpos = np.sort(gpos, axis=-1)
    nvalid = rng.integers(1, c, (n, 1))
    gpos = np.where(np.arange(c)[None] < nvalid, gpos,
                    np.iinfo(np.int32).max).astype(np.int32)
    safe = np.minimum(gpos, s - 1)
    bi = np.arange(n)[:, None]
    ok = (gpos < s)[..., None]
    kg = np.where(ok, k[bi, safe], 0).astype(np.float32)
    vg = np.where(ok, v[bi, safe], 0).astype(np.float32)
    return q, k, v, kg, vg, gpos


@pytest.mark.parametrize("n,s,hd,w,c,bc", [
    (2, 256, 64, 64, 64, 32), (1, 512, 128, 128, 128, 128),
    (2, 384, 64, 128, 96, 32),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vertical_slash_matches_pallas_and_oracles(n, s, hd, w, c, bc, dtype):
    q, k, v, kg, vg, gpos = _vs_inputs(np.random.default_rng(10), n, s, hd,
                                       w, c)
    jin = [jnp.asarray(a).astype(JDT[dtype]) for a in (q, k, v, kg, vg)]
    pallas = _np32(pallas_vertical_slash(*jin, jnp.asarray(gpos),
                                         w_local=w, bc=bc))
    jax_ref = _np32(jref.vertical_slash_ref(
        *(x.astype(jnp.float32) for x in jin), jnp.asarray(gpos), w_local=w))
    tin = [torch.from_numpy(a).to(TDT[dtype]) for a in (q, k, v, kg, vg)]
    tg = torch.from_numpy(gpos)
    out = vertical_slash(*tin, tg, w_local=w)
    assert out.dtype == TDT[dtype] and tuple(out.shape) == (n, s, hd)
    got = out.float().numpy()
    assert np.isfinite(got).all()
    tol = TOL[dtype]
    np.testing.assert_allclose(got, pallas, atol=tol, rtol=tol)
    np.testing.assert_allclose(got, jax_ref, atol=tol, rtol=tol)
    oracle = tref.vertical_slash_ref(*(t.float() for t in tin), tg,
                                     w_local=w)
    np.testing.assert_allclose(got, oracle.numpy(), atol=tol, rtol=tol)


def test_vertical_slash_attention_gqa_fold_matches_reference():
    """G = 2 with unsorted global positions (sorting is not part of the
    kernel's contract)."""
    rng = np.random.default_rng(12)
    b, hq, hkv, s, hd, w, c = 2, 4, 2, 256, 64, 64, 64
    q = rng.standard_normal((b, hq, s, hd)).astype(np.float32)
    _, k, v, kg, vg, gpos = _vs_inputs(rng, b * hkv, s, hd, w, c, sort=False)
    k, v = k.reshape(b, hkv, s, hd), v.reshape(b, hkv, s, hd)
    kg, vg = kg.reshape(b, hkv, c, hd), vg.reshape(b, hkv, c, hd)
    gpos = gpos.reshape(b, hkv, c)
    want = np.asarray(jops.vertical_slash_attention(
        *map(jnp.asarray, (q, k, v, kg, vg, gpos)), w_local=w, bc=32))
    got = tops.vertical_slash_attention(
        *map(torch.from_numpy, (q, k, v, kg, vg, gpos)), w_local=w)
    np.testing.assert_allclose(got.numpy(), want, atol=5e-5, rtol=5e-5)


def test_vertical_slash_attention_rg_head_layout_matches_reference():
    """recurrentgemma-9b's head layout, reduced: 16 q heads on 1 kv head
    (G 16), hd 256, S 512, W 128, C 64 unsorted globals with INT32_MAX
    padding, against the Pallas kernel in interpret mode."""
    rng = np.random.default_rng(24)
    b, hq, hkv, s, hd, w, c = 1, 16, 1, 512, 256, 128, 64
    q = rng.standard_normal((b, hq, s, hd)).astype(np.float32)
    _, k, v, kg, vg, gpos = _vs_inputs(rng, b * hkv, s, hd, w, c, sort=False)
    assert (gpos == np.iinfo(np.int32).max).any()
    k, v = k.reshape(b, hkv, s, hd), v.reshape(b, hkv, s, hd)
    kg, vg = kg.reshape(b, hkv, c, hd), vg.reshape(b, hkv, c, hd)
    gpos = gpos.reshape(b, hkv, c)
    want = np.asarray(jops.vertical_slash_attention(
        *map(jnp.asarray, (q, k, v, kg, vg, gpos)), w_local=w))
    got = tops.vertical_slash_attention(
        *map(torch.from_numpy, (q, k, v, kg, vg, gpos)), w_local=w)
    assert got.shape == (b, hq, s, hd)
    np.testing.assert_allclose(got.numpy(), want, atol=5e-5, rtol=5e-5)


# ==========================================================================
# the dense baseline's windowed modes: gated_flash's hard window and
# paged_decode's start offset, against the reference's windowed cores
# ==========================================================================
@pytest.mark.parametrize("hq,hkv,s,hd,w", [(4, 2, 48, 16, 16),
                                            (16, 1, 64, 32, 24),
                                            (3, 3, 40, 8, 40)])
def test_gated_flash_window_matches_reference_windowed_sdpa(hq, hkv, s, hd,
                                                            w):
    """The plain hard-window mode vs the reference's ``attn_prefill_full``
    core: its ``sdpa`` under the windowed bias (0 where 0 <= i - j < W,
    NEG_INF elsewhere); W = S is the causal form."""
    from repro.models.attention import sdpa as jsdpa
    from repro_torch.kernels.gated_flash import (gated_flash_window,
                                                 gated_flash_window_plain)
    rng = np.random.default_rng(hq * s + w)
    q = rng.standard_normal((1, hq, s, hd)).astype(np.float32)
    k = rng.standard_normal((1, hkv, s, hd)).astype(np.float32)
    v = rng.standard_normal((1, hkv, s, hd)).astype(np.float32)

    def bias_fn(q_start, q_len):
        qi = jnp.arange(q_len)[:, None] + q_start
        kj = jnp.arange(s)[None, :]
        ok = (qi >= kj) & (qi - kj < w)
        return jnp.where(ok, 0.0, -1e30)[None, None, None]

    want = np.asarray(jsdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            bias_fn))
    got = tops.windowed_causal_attention(torch.from_numpy(q),
                                         torch.from_numpy(k),
                                         torch.from_numpy(v), w)
    np.testing.assert_allclose(got.numpy(), want, atol=5e-5, rtol=0)
    args = [torch.from_numpy(a[0]) for a in (q, k, v)]
    assert torch.equal(gated_flash_window(*args, window=w, group=hq // hkv),
                       gated_flash_window_plain(*args, window=w,
                                                group=hq // hkv))
    with pytest.raises(ValueError, match="window"):
        gated_flash_window(*args, window=0, group=hq // hkv)


@pytest.mark.parametrize("t,limit,w", [([5, 37, 70], None, 24),
                                       ([40, 70, 17], [64, 64, 64], 16),
                                       ([90, 63, 80], [64, 64, 64], 16),
                                       ([3, 30, 64], None, 64)])
def test_dense_window_read_matches_reference_core(t, limit, w):
    """``ops.dense_cache_attention(window=)`` (the plain ``paged_decode``
    with ``starts``) vs the reference's ``attn_decode_dense`` window read:
    ``valid = (pos < t) & (pos >= t - W)`` over a buffer of ``limit``
    (rows past it read the buffer's end), one softmax per query head. The
    starts are not page-aligned; a window wider than ``t`` starts at 0. A
    row with ``t >= limit + W`` (its window wholly past the buffer) reads
    no key: the port returns what the reference's softmax over no valid
    key gives there, the mean of V over the buffer's ``limit`` entries;
    so does the read by blocks of a buffer split in two, its blocks
    combined by their log-sum-exp."""
    from repro_torch.models.attention import DenseCache
    rng = np.random.default_rng(sum(t) + w)
    b, hkv, grp, hd, s_max = len(t), 2, 3, 16, 96
    k = rng.standard_normal((b, hkv, s_max, hd)).astype(np.float32)
    v = rng.standard_normal((b, hkv, s_max, hd)).astype(np.float32)
    q = rng.standard_normal((b, hkv * grp, hd)).astype(np.float32)
    tt = np.asarray(t, np.int32)
    cap = s_max if limit is None else limit[0]
    pos = jnp.arange(cap)[None]
    valid = (pos < jnp.asarray(tt)[:, None]) \
        & (pos >= jnp.asarray(tt)[:, None] - w)
    qg = jnp.asarray(q).reshape(b, hkv, grp, hd)
    logits = jnp.einsum("bhgd,bhkd->bhgk", qg,
                        jnp.asarray(k[:, :, :cap])) * hd ** -0.5
    logits = jnp.where(valid[:, None, None], logits, -1e30)
    wts = jnp.exp(logits - logits.max(-1, keepdims=True))
    wts = wts / wts.sum(-1, keepdims=True)
    want = np.asarray(jnp.einsum("bhgk,bhkd->bhgd", wts,
                                 jnp.asarray(v[:, :, :cap])))
    cache = DenseCache(torch.from_numpy(k), torch.from_numpy(v),
                       torch.from_numpy(tt))
    end = None if limit is None else torch.minimum(
        cache.t, torch.tensor(limit, dtype=torch.int32))
    got = tops.dense_cache_attention(torch.from_numpy(q), cache, window=w,
                                     end=end).numpy().reshape(want.shape)
    empty = tt >= cap + w
    assert empty.any() == (t == [90, 63, 80])
    assert np.abs(got[empty]).max(initial=1.0) > 0.0
    np.testing.assert_allclose(got, want, atol=5e-5, rtol=0)
    if end is None:
        return
    # the same read by blocks of the buffer split in two, combined as the
    # context-parallel decode combines them
    half = s_max // 2
    outs, lses = [], []
    for i in range(2):
        part = DenseCache(cache.k[:, :, i * half:(i + 1) * half],
                          cache.v[:, :, i * half:(i + 1) * half], cache.t)
        o, lse = tops.dense_cache_attention(torch.from_numpy(q), part,
                                            window=w, end=end, block=(i, 2))
        outs.append(o.numpy())
        lses.append(lse.numpy())
    lse = np.stack(lses)
    m = lse.max(0)
    wts = np.where(np.isfinite(lse), np.exp(lse - m), 0.0)
    joined = (wts[..., None] * np.stack(outs)).sum(0) / wts.sum(0)[..., None]
    np.testing.assert_allclose(joined.reshape(want.shape), want, atol=5e-5,
                               rtol=0)


def test_paged_decode_starts_mask_and_walk():
    """The plain ``paged_decode`` with ``starts``: tokens below the start
    and at or past ``starts + span`` are masked, ``starts=None`` is the
    plain read, and the walk of a start read covers the pages ``span``
    tokens can touch (the kernel's split plan counts only those)."""
    from repro_torch.kernels.paged_decode import (paged_decode_plain,
                                                  start_walk, walk_plan)
    rng = np.random.default_rng(8)
    n, hd, mp = 3, 8, 8
    kp = torch.from_numpy(rng.standard_normal((n * mp, 16, hd))
                          .astype(np.float32))
    vp = torch.from_numpy(rng.standard_normal((n * mp, 16, hd))
                          .astype(np.float32))
    tbl = torch.arange(n * mp, dtype=torch.int32).reshape(n, mp)
    lens = torch.tensor([100, 128, 40], dtype=torch.int32)
    starts = torch.tensor([37, 0, 39], dtype=torch.int32)
    q = torch.from_numpy(rng.standard_normal((n, hd)).astype(np.float32))
    got = paged_decode(q, kp, vp, tbl, lens, starts=starts, span=50)
    # the same read as a plain one over the sliced tokens
    for i, (a, e) in enumerate(((37, 87), (0, 50), (39, 40))):
        kk = kp[tbl[i].long()].reshape(-1, hd)[a:e]
        vv = vp[tbl[i].long()].reshape(-1, hd)[a:e]
        p = torch.softmax(kk @ q[i] * hd ** -0.5, dim=0)
        torch.testing.assert_close(got[i], p @ vv, atol=5e-6, rtol=0)
    assert torch.equal(paged_decode(q, kp, vp, tbl, lens),
                       paged_decode_plain(q, kp, vp, tbl, lens))
    assert start_walk(mp, 50) == 5 and start_walk(mp, 16) == 2
    assert start_walk(mp, 2048) == mp
    assert walk_plan(q, tbl, span=50).n_splits \
        <= walk_plan(q, tbl).n_splits
    with pytest.raises(ValueError, match="together"):
        paged_decode(q, kp, vp, tbl, lens, starts=starts)


# ==========================================================================
# the log-sum-exp of the seq-sharded reads
# ==========================================================================
def _lse_np(q, k, valid):
    """log sum exp of the scaled scores q . k / sqrt(hd) over the valid
    keys of each row; -inf for a row with none."""
    s = np.einsum("nd,nkd->nk", q.astype(np.float64),
                  k.astype(np.float64)) * q.shape[1] ** -0.5
    s = np.where(valid, s, -np.inf)
    m = s.max(axis=1, keepdims=True)
    m_safe = np.where(np.isfinite(m), m, 0.0)
    with np.errstate(divide="ignore"):
        return (m_safe + np.log(np.exp(s - m_safe).sum(1, keepdims=True))
                )[:, 0]


def _combine_np(parts):
    """Reads of disjoint key sets [(out [N, hd], lse [N])] joined by their
    log-sum-exp, as ``comm.combine_lse`` joins the ranks'."""
    lse = np.stack([p[1] for p in parts])
    m = lse.max(axis=0)
    m = np.where(np.isfinite(m), m, 0.0)
    w = np.where(np.isfinite(lse), np.exp(lse - m), 0.0)
    num = sum(wi[:, None] * p[0] for wi, p in zip(w, parts))
    return num / np.maximum(w.sum(0), 1e-30)[:, None]


def test_paged_decode_selected_plain_lse_matches_oracle_and_blocks():
    """``paged_decode_selected_plain(lse=True)``: ``out`` the reference's
    ``paged_decode_selected_ref``, ``lse`` the log-sum-exp of the selected
    valid keys' scaled scores (-inf and 0 for a row that selected
    nothing); two blocks of the pages, each reading the selected ids it
    holds (``ops.block_page_ids``), joined by lse give the whole read."""
    from repro_torch.kernels.paged_decode import paged_decode_selected_plain
    rng = np.random.default_rng(12)
    n, hd, mp, k = 5, 32, 8, 5
    kp = rng.standard_normal((n * mp, 16, hd)).astype(np.float32)
    vp = rng.standard_normal((n * mp, 16, hd)).astype(np.float32)
    tbl = np.arange(n * mp, dtype=np.int32).reshape(n, mp)
    lens = np.array([128, 100, 70, 20, 128], np.int32)
    q = rng.standard_normal((n, hd)).astype(np.float32)
    ids = np.stack([np.sort(rng.choice(mp, k, replace=False))
                    for _ in range(n)]).astype(np.int32)
    n_sel = np.array([5, 3, 4, 2, 0], np.int32)
    t = [torch.from_numpy(a) for a in (q, kp, vp, tbl, lens, ids, n_sel)]
    out, lse = paged_decode_selected_plain(*t, lse=True)
    want = np.asarray(jref.paged_decode_selected_ref(
        *map(jnp.asarray, (q, kp, vp, tbl, lens, ids, n_sel))))
    np.testing.assert_allclose(out.numpy(), want, atol=1e-5, rtol=1e-5)
    pos = ids[:, :, None] * 16 + np.arange(16)
    keys = kp[np.take_along_axis(tbl, ids, 1)].reshape(n, -1, hd)
    valid = (pos < lens[:, None, None]) & \
        (np.arange(k)[None, :, None] < n_sel[:, None, None])
    np.testing.assert_allclose(lse.numpy(), _lse_np(q, keys,
                                                    valid.reshape(n, -1)),
                               atol=1e-5, rtol=1e-5)
    assert lse[4] == -np.inf and torch.all(out[4] == 0)
    parts = []
    for i in range(2):
        lo = i * mp // 2
        loc, cnt = tops.block_page_ids(t[5], t[6], (i, 2), mp // 2)
        o, l_se = paged_decode_selected_plain(
            t[0], t[1], t[2], t[3][:, lo:lo + mp // 2].contiguous(),
            torch.clamp(t[4] - lo * 16, 0, mp // 2 * 16), loc, cnt,
            lse=True)
        parts.append((o.numpy(), l_se.numpy()))
    np.testing.assert_allclose(_combine_np(parts), out.numpy(), atol=1e-5,
                               rtol=1e-5)


def test_paged_decode_starts_lse_matches_oracle_and_blocks():
    """``paged_decode_plain(starts=, span=, lse=True)``: ``out`` the
    reference's ``paged_decode_ref`` over the window's pages (page-aligned
    starts), ``lse`` the log-sum-exp of the window's scaled scores; a
    dense buffer split in two blocks, a window across their edge, each
    block's read (``ops.dense_cache_attention(block=)``) joined by lse
    gives the whole windowed read, and a block the window misses reads
    nothing."""
    from repro_torch.kernels.paged_decode import paged_decode_plain
    from repro_torch.models.attention import DenseCache
    rng = np.random.default_rng(13)
    n, hd, mp, span = 4, 32, 8, 40
    kp = rng.standard_normal((n * mp, 16, hd)).astype(np.float32)
    vp = rng.standard_normal((n * mp, 16, hd)).astype(np.float32)
    tbl = np.arange(n * mp, dtype=np.int32).reshape(n, mp)
    lens = np.array([128, 100, 70, 30], np.int32)
    starts = np.array([32, 48, 16, 0], np.int32)
    q = rng.standard_normal((n, hd)).astype(np.float32)
    out, lse = paged_decode_plain(
        *map(torch.from_numpy, (q, kp, vp, tbl, lens)),
        starts=torch.from_numpy(starts), span=span, lse=True)
    ends = np.minimum(lens, starts + span)
    want = np.stack([np.asarray(jref.paged_decode_ref(
        jnp.asarray(q[i:i + 1]), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(tbl[i:i + 1, starts[i] // 16:]),
        jnp.asarray(ends[i:i + 1] - starts[i])))[0] for i in range(n)])
    np.testing.assert_allclose(out.numpy(), want, atol=1e-5, rtol=1e-5)
    keys = kp[tbl].reshape(n, -1, hd)
    p = np.arange(mp * 16)[None]
    valid = (p >= starts[:, None]) & (p < ends[:, None])
    np.testing.assert_allclose(lse.numpy(), _lse_np(q, keys, valid),
                               atol=1e-5, rtol=1e-5)
    # a dense buffer [B 2, Hkv 1, 64, hd], G 2; rows at t 40 and 24 with a
    # window of 20: [20, 40) straddles the blocks' edge at 32, [4, 24)
    # lies in block 0 and block 1 reads nothing for it
    b, s_max, w = 2, 64, 20
    k = torch.from_numpy(rng.standard_normal((b, 1, s_max, hd))
                         .astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((b, 1, s_max, hd))
                         .astype(np.float32))
    t = torch.tensor([40, 24], dtype=torch.int32)
    qq = torch.from_numpy(rng.standard_normal((b, 2, hd)).astype(np.float32))
    whole = tops.dense_cache_attention(qq, DenseCache(k, v, t), window=w)
    parts = []
    for i in range(2):
        blk = DenseCache(k[:, :, i * 32:(i + 1) * 32].contiguous(),
                         v[:, :, i * 32:(i + 1) * 32].contiguous(), t)
        o, l_se = tops.dense_cache_attention(qq, blk, window=w, block=(i, 2))
        parts.append((o.reshape(-1, hd).numpy(), l_se.reshape(-1).numpy()))
    assert np.all(parts[1][1][2:] == -np.inf) and np.all(parts[1][0][2:] == 0)
    np.testing.assert_allclose(_combine_np(parts), whole.reshape(-1, hd),
                               atol=1e-5, rtol=1e-5)
