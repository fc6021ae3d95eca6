"""The port's kernel modules vs the reference's Pallas kernels (interpret
mode) and oracles, on the CPU: each wrapper runs its plain PyTorch version
for CPU tensors, and that version is what the CUDA kernel is held to on
the card (``chip_smoke.py``; the ``cuda``-marked tests below repeat the
comparison when a GPU is present).

Sweeps and tolerances follow ``tests/test_kernels.py``: ``paged_decode``
at 5e-5 in float32 and 5e-2 in bfloat16, ``gate_mlp`` at 1e-5 in float32.
Inputs are drawn with numpy from a seed and handed to both packages.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dual_cache as JDC
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.gate_mlp import gate_mlp as pallas_gate_mlp
from repro.kernels.paged_decode import paged_decode as pallas_paged_decode
from repro_torch.core import dual_cache as TDC
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.gate_mlp import gate_mlp, gate_mlp_plain
from repro_torch.kernels.paged_decode import paged_decode, paged_decode_plain

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
# on the card: each CUDA kernel against its plain version
# ==========================================================================
def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU "
                    "mode); chip_smoke.py runs these checks on the card")


@pytest.mark.cuda
@pytest.mark.parametrize("rows,s", [(16, 1), (16, 4096)])
def test_gate_mlp_kernel_matches_plain_on_gpu(rows, s):
    _need_cuda()
    x, w1, b1, w2, b2 = _gate_inputs(np.random.default_rng(0), 8, s, 256, 64)
    x = np.random.default_rng(1).standard_normal((rows, s, 256)).astype(
        np.float32)
    args = [torch.from_numpy(a).cuda() for a in (x, w1, b1, w2, b2)]
    got = gate_mlp(*args)
    want = gate_mlp_plain(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_decode_kernel_matches_plain_on_gpu(dtype):
    _need_cuda()
    q, kp, vp, tbl, lens = _paged_inputs(np.random.default_rng(3), 32, 128,
                                         16, 64, 24)
    lens[0] = 0
    args = [torch.from_numpy(a).cuda().to(TDT[dtype]) for a in (q, kp, vp)]
    ti = [torch.from_numpy(a).cuda() for a in (tbl, lens)]
    second = (args[1], args[2], ti[0][:, :8].contiguous(), ti[1] // 3)
    got = paged_decode(*args, *ti, second=second)
    want = paged_decode_plain(*args, *ti, second=second)
    torch.cuda.synchronize()
    tol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
