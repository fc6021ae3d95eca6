"""The backward kernels' products in 3xTF32 and in one TF32 pass, emulated
on the CPU against the plain backward versions.

``csrc/gated_flash_bwd.cu`` runs the five products of the attention
backward (S = Q K^T, dP = dO V^T, dV = P^T dO, dK = dS^T Q, dQ = dS K) and
``csrc/gate_mlp_bwd.cu`` the gate's three (the recomputed pre-activation
x W1, dx = dpre W1^T, dW1 = x^T dpre) on TF32 tensor cores. The tensor
cores read the top 10 mantissa bits of an f32 operand, so each operand is
split (``flash_mma.cuh``): hi is the value with its 13 low mantissa bits
cleared, lo is the rest, of which the tensor cores again read only the
top bits, and a product is accumulated as lo_a hi_b + hi_a lo_b + hi_a
hi_b, small terms first. This file emulates that arithmetic along the
kernels' data flow (P and dS formed from the emulated S and dP and split
again as operands of the next products; products of truncated operands
are exact in f32), at the substrate's shapes and at a reduced train shape
(hd 128, S 256, W 100 inside a key tile, gates at 1e-7), over seeds:

* 3xTF32 keeps every gradient (dq, dk, dv, dg; dx, dw1, db1, dw2, db2)
  within the card's limit, BWD_REL = 1e-4 of its largest magnitude, of
  ``gated_flash_bwd_plain`` / ``gate_mlp_bwd_plain``;
* one TF32 pass (hi_a hi_b alone) reads above it: every attention
  gradient (1e-3 to 5e-3), and every gate gradient that a product feeds:
  dx and dw1 (about 1e-3), db1 and dw2 (2e-4 to 1e-3, through the
  pre-activation). db2 would tolerate it: it sums dy = dg g (1 - g), from
  the forward's g, and no product enters it. That is why every operand is
  split.

What the emulation leaves out: the order of the card's f32 sums and the
tensor cores' truncation when they add to an accumulator (the kernels sum
each tile in fresh accumulators and add tiles in f32); the card's own
check holds the kernels to the same limit (``chip_smoke.py``,
``tests/test_torch_cuda.py``).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import gated_flash as GF
from repro_torch.kernels.gate_mlp import (_gelu_tanh_and_grad,
                                          gate_mlp_bwd_plain, gate_mlp_plain)

torch.set_num_threads(2)

BWD_REL = 1e-4  # the backward kernels' limit on the card (chip_smoke.py)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """x with its 13 low mantissa bits cleared: the value a TF32 tensor core
    reads."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _mm(eq: str, a, b, terms: int):
    """einsum ``eq`` of a and b from ``terms`` TF32 products: 3 is the
    kernels' lo hi + hi lo + hi hi, 1 a single TF32 pass."""
    ah, bh = _tf32(a), _tf32(b)
    prod = torch.einsum(eq, ah, bh)
    if terms == 3:
        al, bl = _tf32(a - ah), _tf32(b - bh)
        prod = (torch.einsum(eq, al, bh) + torch.einsum(eq, ah, bl)) + prod
    return prod


def _rel(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


# ==========================================================================
# gated_flash_bwd
# ==========================================================================
def _flash_bwd(q, k, v, g, o, lse, do, w, group, terms, eps=1e-6):
    """The kernels' backward with emulated products -> dq, dk, dv, dg."""
    nq, s, hd = q.shape
    nk = nq // group
    scale = hd ** -0.5
    qg = q.reshape(nk, group, s, hd)
    dog = do.reshape(nk, group, s, hd)
    causal, in_win = GF._masks(s, w, q.device)
    logg = torch.log(g + eps)[:, None, None, :]
    bias = torch.where(in_win, torch.zeros_like(logg), logg)
    sc = _mm("ngqd,nkd->ngqk", qg, k, terms) * scale
    logits = sc + torch.where(causal, bias, torch.full_like(bias, GF.NEG_INF))
    p = torch.exp(logits - lse.reshape(nk, group, s, 1))
    dvec = (dog * o.reshape(nk, group, s, hd)).sum(-1, keepdim=True)
    ds = p * (_mm("ngqd,nkd->ngqk", dog, v, terms) - dvec)
    dv = _mm("ngqk,ngqd->nkd", p, dog, terms)
    dk = _mm("ngqk,ngqd->nkd", ds, qg, terms) * scale
    dq = _mm("ngqk,nkd->ngqd", ds, k, terms) * scale
    outside = causal & ~in_win
    dg = torch.where(outside, ds, torch.zeros_like(ds)).sum(dim=(1, 2)) \
        / (g + eps)
    return dq.reshape(nq, s, hd), dk, dv, dg


# (nq, nk, S, hd, W): the substrate's (chip_smoke.py's substrate case) and
# a reduced train shape (qwen3-0.6b's hd 128 and group 2)
FLASH_SHAPES = [(8, 4, 128, 32, 16), (4, 2, 256, 128, 100)]


@pytest.mark.parametrize("nq,nk,s,hd,w", FLASH_SHAPES)
@pytest.mark.parametrize("seed", range(3))
def test_flash_bwd_3xtf32_holds_the_limit_and_one_pass_does_not(
        nq, nk, s, hd, w, seed):
    rng = np.random.default_rng(seed)

    def rn(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    q, do, k, v = rn(nq, s, hd), rn(nq, s, hd), rn(nk, s, hd), rn(nk, s, hd)
    g = torch.from_numpy(rng.uniform(0, 1, (nk, s)).astype(np.float32))
    g[0, :8] = 1e-7   # gates near 0: large dg
    kw = {"w_local": w, "group": nq // nk}
    o, lse = GF.gated_flash_plain(q, k, v, g, with_lse=True, **kw)
    want = GF.gated_flash_bwd_plain(q, k, v, g, o, lse, do, **kw)
    names = ("dq", "dk", "dv", "dg")
    three = {n: _rel(a, b) for n, a, b in zip(
        names, _flash_bwd(q, k, v, g, o, lse, do, w, nq // nk, 3), want)}
    one = {n: _rel(a, b) for n, a, b in zip(
        names, _flash_bwd(q, k, v, g, o, lse, do, w, nq // nk, 1), want)}
    assert max(three.values()) <= BWD_REL, three
    assert min(one.values()) > BWD_REL, one   # no gradient tolerates it
    assert max(three.values()) < max(one.values()) / 100


# ==========================================================================
# gate_mlp_bwd
# ==========================================================================
def _gate_bwd(x, w1, b1, w2, g, dg, terms):
    """The kernel's backward with emulated products -> dx, dw1, db1, dw2,
    db2."""
    r, s, f = x.shape
    hh = w1.shape[0]
    xb = x.reshape(r // hh, hh, s, f)
    pre = _mm("bhsf,hfm->bhsm", xb, w1, terms) + b1[None, :, None]
    gel, dgel = _gelu_tanh_and_grad(pre)
    gb = g.reshape(r // hh, hh, s)
    dy = dg.reshape(r // hh, hh, s) * gb * (1.0 - gb)
    dpre = dy[..., None] * w2[None, :, None, :, 0] * dgel
    dx = _mm("bhsm,hfm->bhsf", dpre, w1, terms).reshape(r, s, f)
    dw1 = _mm("bhsf,bhsm->hfm", xb, dpre, terms)
    db1 = dpre.sum(dim=(0, 2))
    dw2 = torch.einsum("bhs,bhsm->hm", dy, gel)[..., None]
    db2 = dy.sum(dim=(0, 2))[:, None]
    return dx, dw1, db1, dw2, db2


# (rows, S, H, F, M): the substrate's and a reduced train shape
# (qwen3-0.6b's 8 kv heads, F 256, M 64, batch 2)
GATE_SHAPES = [(4, 128, 2, 64, 32), (16, 256, 8, 256, 64)]


@pytest.mark.parametrize("rows,s,hh,f,m", GATE_SHAPES)
@pytest.mark.parametrize("seed", range(3))
def test_gate_bwd_3xtf32_holds_the_limit_and_one_pass_does_not(
        rows, s, hh, f, m, seed):
    rng = np.random.default_rng(seed)

    def rn(*shape, scale=1.0):
        return torch.from_numpy(
            (scale * rng.standard_normal(shape)).astype(np.float32))
    x = rn(rows, s, f)
    w1, b1 = rn(hh, f, m, scale=f ** -0.5), rn(hh, m, scale=0.1)
    w2, b2 = rn(hh, m, 1, scale=m ** -0.5), rn(hh, 1)
    dg = rn(rows, s)
    g = gate_mlp_plain(x, w1, b1, w2, b2)
    want = gate_mlp_bwd_plain(x, w1, b1, w2, b2, g, dg)
    names = ("dx", "dw1", "db1", "dw2", "db2")
    three = {n: _rel(a, b) for n, a, b in zip(
        names, _gate_bwd(x, w1, b1, w2, g, dg, 3), want)}
    one = {n: _rel(a, b) for n, a, b in zip(
        names, _gate_bwd(x, w1, b1, w2, g, dg, 1), want)}
    assert max(three.values()) <= BWD_REL, three
    # every gradient that a product feeds reads above the limit in one
    # pass; db2 has no product in it
    assert min(one[n] for n in names[:4]) > BWD_REL, one
    assert three["db2"] <= 1e-6 and one["db2"] <= 1e-6, (three, one)
    assert max(three.values()) < max(one.values()) / 100
