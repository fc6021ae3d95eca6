"""The plain backward versions of the port's two trained kernels against
the reference on the CPU.

``gate_mlp_bwd_plain`` and ``gated_flash_bwd_plain`` write the gradients
out as formulas (the CUDA backward kernels are held to them on the card:
``tests/test_torch_cuda.py``, ``chip_smoke.py``). Here they are held to
``jax.vjp`` of the reference's oracles (``src/repro/kernels/ref.py``:
``gate_mlp_ref`` and ``gated_flash_ref``) and to ``torch.autograd`` of the
port's forward plain versions, on the same numpy inputs: GQA group 2, S
64 and a window of 16, so rows at the window's edge (i - j = W, outside
it) are included, with some gates near 0, where ``dg = .../(g + eps)`` is
large. Limit: 1e-5 of the largest magnitude of each reference gradient
(float32 sums in different orders; an elementwise limit would fail on
the large ``dg`` entries' neighbours for no fault).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as JREF
from repro_torch.kernels.gate_mlp import (gate_mlp, gate_mlp_bwd,
                                          gate_mlp_bwd_plain, gate_mlp_plain)
from repro_torch.kernels.gated_flash import (gated_flash, gated_flash_bwd,
                                             gated_flash_bwd_plain,
                                             gated_flash_plain)

torch.set_num_threads(2)

REL = 1e-5


def _close(got, want, rel=REL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max() / scale
    assert err <= rel, f"max |d| / max |ref| = {err:.3e} > {rel:.0e}"


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), dtype=torch.float32, requires_grad=grad)


# ==========================================================================
# gated_flash
# ==========================================================================
def _flash_inputs(seed, nk=2, group=2, s=64, hd=32):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((nk * group, s, hd)).astype(np.float32)
    k = rng.standard_normal((nk, s, hd)).astype(np.float32)
    v = rng.standard_normal((nk, s, hd)).astype(np.float32)
    g = rng.uniform(0.0, 1.0, (nk, s)).astype(np.float32)
    g[0, :6] = 1e-7          # gates near 0: dg ~ 1/(g + eps) is large
    do = rng.standard_normal((nk * group, s, hd)).astype(np.float32)
    return q, k, v, g, do


def _flash_ref_grads(q, k, v, g, do, w, group, eps=1e-6):
    """jax.vjp of gated_flash_ref: the reference oracle is one head-group,
    so K, V and g are repeated over the group and their gradients summed
    back over it."""
    nk, s, hd = k.shape

    def f(q_, k_, v_, g_):
        rep = lambda t: jnp.repeat(t, group, axis=0)
        return JREF.gated_flash_ref(q_, rep(k_), rep(v_), rep(g_),
                                    w_local=w, eps=eps)
    out, vjp = jax.vjp(f, *(jnp.asarray(t) for t in (q, k, v, g)))
    return np.asarray(out), [np.asarray(t) for t in vjp(jnp.asarray(do))]


@pytest.mark.parametrize("w,seed", [(16, 0), (1, 1), (64, 2)])
def test_gated_flash_bwd_plain_matches_jax_vjp(w, seed):
    """W 16 (the window's edge inside the sequence), W 1 (every earlier
    key biased) and W = S (no key biased: dg is exactly 0)."""
    q, k, v, g, do = _flash_inputs(seed)
    out_ref, want = _flash_ref_grads(q, k, v, g, do, w, 2)
    o, lse = gated_flash_plain(*(_t(a) for a in (q, k, v, g)), w_local=w,
                               group=2, with_lse=True)
    _close(o.numpy(), out_ref)
    got = gated_flash_bwd_plain(*(_t(a) for a in (q, k, v, g)), o, lse,
                                _t(do), w_local=w, group=2)
    for gt, wt in zip(got, want):
        if w == 64 and gt.shape == g.shape:
            assert not np.any(wt) and not torch.any(gt)
            continue
        _close(gt.numpy(), wt)


def test_gated_flash_bwd_plain_matches_autograd():
    q, k, v, g, do = _flash_inputs(3)
    ins = [_t(a, grad=True) for a in (q, k, v, g)]
    o, lse = gated_flash_plain(*ins, w_local=16, group=2, with_lse=True)
    want = torch.autograd.grad(o, ins, _t(do))
    got = gated_flash_bwd_plain(*(t.detach() for t in ins), o.detach(),
                                lse.detach(), _t(do), w_local=16, group=2)
    for gt, wt in zip(got, want):
        _close(gt.numpy(), wt.numpy())


def test_gated_flash_lse_is_the_log_of_the_softmax_sum():
    q, k, v, g, _ = _flash_inputs(4)
    _, lse = gated_flash_plain(*(_t(a) for a in (q, k, v, g)), w_local=16,
                               group=2, with_lse=True)
    s, hd = q.shape[1], q.shape[2]
    qi, kj = np.arange(s)[:, None], np.arange(s)[None]
    bias = np.where(qi - kj < 16, 0.0, np.log(g.astype(np.float64) + 1e-6)
                    [:, None, None, :])
    kk = np.repeat(k, 2, axis=0).astype(np.float64)
    logits = np.einsum("nqd,nkd->nqk", q, kk) / np.sqrt(hd) \
        + np.repeat(bias, 2, axis=0)[:, 0]
    logits = np.where(qi >= kj, logits, -np.inf)
    want = np.log(np.exp(logits).sum(-1))
    np.testing.assert_allclose(lse.numpy(), want, atol=2e-5, rtol=0)


def test_gated_flash_is_differentiable_on_the_cpu_through_the_wrapper():
    """On CPU tensors the wrapper runs the plain version, so autograd
    gives the plain backward's gradients."""
    q, k, v, g, do = _flash_inputs(5)
    ins = [_t(a, grad=True) for a in (q, k, v, g)]
    out = gated_flash(*ins, w_local=16, group=2)
    got = torch.autograd.grad(out, ins, _t(do))
    o, lse = gated_flash_plain(*(t.detach() for t in ins), w_local=16,
                               group=2, with_lse=True)
    want = gated_flash_bwd_plain(*(t.detach() for t in ins), o, lse, _t(do),
                                 w_local=16, group=2)
    for gt, wt in zip(got, want):
        _close(gt.numpy(), wt.numpy())


# ==========================================================================
# gate_mlp
# ==========================================================================
def _gate_inputs(seed, b=2, h=2, s=64, f=64, m=32):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b * h, s, f)).astype(np.float32)
    w1 = (rng.standard_normal((h, f, m)) / np.sqrt(f)).astype(np.float32)
    b1 = (0.1 * rng.standard_normal((h, m))).astype(np.float32)
    w2 = (rng.standard_normal((h, m, 1)) / np.sqrt(m)).astype(np.float32)
    b2 = rng.standard_normal((h, 1)).astype(np.float32)
    dg = rng.standard_normal((b * h, s)).astype(np.float32)
    return (x, w1, b1, w2, b2), dg


def test_gate_mlp_bwd_plain_matches_jax_vjp():
    """Rows are (batch, head) with head ``row % H``; the reference oracle
    takes one row per head, so it runs once per batch and the weight
    gradients are summed over the batch."""
    (x, w1, b1, w2, b2), dg = _gate_inputs(0)
    h = w1.shape[0]
    b = x.shape[0] // h
    want = [np.zeros_like(x)] + [np.zeros_like(a) for a in (w1, b1, w2, b2)]
    g_ref = np.zeros(dg.shape, np.float32)
    for i in range(b):
        rows = slice(i * h, (i + 1) * h)
        out, vjp = jax.vjp(JREF.gate_mlp_ref, jnp.asarray(x[rows]),
                           *(jnp.asarray(a) for a in (w1, b1, w2, b2)))
        g_ref[rows] = np.asarray(out)
        grads = vjp(jnp.asarray(dg[rows]))
        want[0][rows] = np.asarray(grads[0])
        for j in range(1, 5):
            want[j] = want[j] + np.asarray(grads[j])
    g = gate_mlp_plain(*(_t(a) for a in (x, w1, b1, w2, b2)))
    _close(g.numpy(), g_ref)
    got = gate_mlp_bwd_plain(*(_t(a) for a in (x, w1, b1, w2, b2)), g,
                             _t(dg))
    for gt, wt in zip(got, want):
        _close(gt.numpy(), wt)


def test_gate_mlp_bwd_plain_matches_autograd():
    args, dg = _gate_inputs(1, b=3, h=4, s=16, f=32, m=24)
    ins = [_t(a, grad=True) for a in args]
    g = gate_mlp(*ins)
    want = torch.autograd.grad(g, ins, _t(dg))
    got = gate_mlp_bwd_plain(*(t.detach() for t in ins), g.detach(),
                             _t(dg))
    for gt, wt in zip(got, want):
        assert gt.shape == wt.shape
        _close(gt.numpy(), wt.numpy())


@pytest.mark.parametrize("kernel", ["gate_mlp_bwd", "gated_flash_bwd"])
def test_bwd_wrappers_take_cuda_tensors_only(kernel):
    """The backward wrappers launch their kernels and nothing else: on
    CPU tensors they raise (the CPU path is autograd of the plain
    forward, checked above)."""
    if kernel == "gate_mlp_bwd":
        args, dg = _gate_inputs(2, b=1, s=8, f=16, m=8)
        ts = [_t(a) for a in args]
        g = gate_mlp_plain(*ts)
        call = lambda: gate_mlp_bwd(*ts, g, _t(dg))  # noqa: E731
    else:
        q, k, v, g, do = (_t(a) for a in _flash_inputs(3))
        o, lse = gated_flash_plain(q, k, v, g, w_local=16, group=2,
                                   with_lse=True)
        call = lambda: gated_flash_bwd(q, k, v, g, o, lse, do,  # noqa: E731
                                       w_local=16, group=2)
    with pytest.raises(ValueError, match="unsupported device"):
        call()
