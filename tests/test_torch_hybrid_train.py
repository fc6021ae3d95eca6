"""The hybrid's gate-distillation training in the port against the reference
on the CPU, and the RG-LRU scan's backward.

``rglru_scan_bwd_plain`` (the reverse loop that ``csrc/rglru_scan_bwd.cu``
is held to on the card) against ``jax.vjp`` of the reference's
``models/rglru.py::rglru_scan`` (an associative scan), with and without a
carried-in state, and against autograd of ``rglru_scan_plain``; the CUDA
kernel's chunked arithmetic (chunk and sub-chunk lengths read from the
``.cu``) emulated in float32 against the same vjp. Then the reduced
recurrentgemma-9b with the two-block RG-LRU stem of
``tests/test_torch_hybrid.py`` and two repeats, so that RG-LRU blocks
follow a gate and its gradient runs back through them: distill loss, aux
and every gate gradient of one step against ``jax.value_and_grad`` at S
96, past the 64-token window (distill is not 0), three steps' metrics,
``remat``, and the CLI.

Tolerances. The reference scans by ``jax.lax.associative_scan`` and the
port sequentially, so the two round in different orders; the scan's
gradients (a in (0.5, 0.999), S up to 4096) stay within 1e-5 of each
gradient's largest magnitude, the limit of ``tests/test_torch_training.py``
(``_max_close``), and so do the hybrid's gate gradients; losses and aux
1e-5 relative. The plain backward against autograd of the plain forward:
1e-6 of the largest magnitude (the same products; autograd may add a
step's two gradient terms in the other order).
"""
import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import rglru as JRG
from repro.models import transformer as JT
from repro.training import trainer as JTR
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import build
from repro_torch.kernels.rglru_scan import (rglru_scan_bwd_plain,
                                            rglru_scan_plain)
from repro_torch.launch import train as TLAUNCH
from repro_torch.training import trainer as TTR
from test_torch_hybrid import hybrid_cfg
from test_torch_prefill import GateRecorder
from test_torch_support import port_cfg
from test_torch_training import (_batches, _jbatch, _max_close, _rel_close,
                                 _ref_value_and_grad, _tbatch)

torch.set_num_threads(2)

TAU_MARGIN = 1e-3


# ==========================================================================
# the scan's backward
# ==========================================================================
def _scan_inputs(seed, b, s, d):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.5, 0.999, (b, s, d)).astype(np.float32)
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    h0 = rng.standard_normal((b, d)).astype(np.float32)
    dy = rng.standard_normal((b, s, d)).astype(np.float32)
    return a, x, h0, dy


@jax.jit
def _vjp_h0(a, x, h0, dy):
    return jax.vjp(JRG.rglru_scan, a, x, h0)[1](dy)


@jax.jit
def _vjp(a, x, dy):
    return jax.vjp(lambda a_, x_: JRG.rglru_scan(a_, x_, None), a, x)[1](dy)


@functools.lru_cache(maxsize=None)
def _inputs_and_ref(shape, with_h0):
    """Scan inputs drawn from seed 1, and (da, db[, dh0]) of the
    reference's rglru_scan on them by jax.vjp."""
    a, x, h0, dy = _scan_inputs(1, *shape)
    if with_h0:
        ref = _vjp_h0(a, x, h0, dy)
    else:
        ref = _vjp(a, x, dy)
    return (a, x, h0, dy), [np.asarray(g) for g in ref]


def _port_bwd(a, x, h0, dy, with_h0, bwd=rglru_scan_bwd_plain):
    """(da, db[, dh0]) from a backward of the scan, with the carried-in
    state folded into b[:, 0] as ``models/rglru.py`` folds it and that
    fold's chain rule written out."""
    a, x, h0, dy = (torch.from_numpy(v) for v in (a, x, h0, dy))
    if with_h0:
        x = x.clone()
        x[:, 0] = x[:, 0] + a[:, 0] * h0
    h = rglru_scan_plain(a, x)
    da, db = bwd(a, h, dy)
    if not with_h0:
        return [da.numpy(), db.numpy()]
    da = da.clone()
    da[:, 0] = da[:, 0] + db[:, 0] * h0
    return [da.numpy(), db.numpy(), (db[:, 0] * a[:, 0]).numpy()]


SHAPES = [(2, 300, 7), (1, 1, 3), (3, 129, 16), (1, 4096, 4), (2, 128, 5)]


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_scan_bwd_plain_matches_jax_vjp(shape, with_h0):
    (a, x, h0, dy), want = _inputs_and_ref(shape, with_h0)
    got = _port_bwd(a, x, h0, dy, with_h0)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _max_close(g, w)


@pytest.mark.parametrize("shape", [(2, 300, 7), (3, 129, 16)])
def test_scan_bwd_plain_matches_autograd(shape):
    a, x, _, dy = (torch.from_numpy(v) for v in _scan_inputs(2, *shape))
    ins = [a.clone().requires_grad_(), x.clone().requires_grad_()]
    auto = torch.autograd.grad(rglru_scan_plain(*ins), ins, dy)
    got = rglru_scan_bwd_plain(a, rglru_scan_plain(a, x), dy)
    for g, w in zip(got, auto):
        _max_close(g.numpy(), w.numpy(), rel=1e-6)


def _kernel_constants():
    src = (build.CSRC / "rglru_scan_bwd.cu").read_text()
    nsub = int(re.search(r"constexpr int NSUB = (\d+);", src).group(1))
    ls = int(re.search(r"constexpr int LS = (\d+);", src).group(1))
    return nsub, ls


def _fma(x, y, z):
    """fmaf: x y + z rounded once to float32."""
    return (x.double() * y.double() + z.double()).float()


def _chunked_bwd(a, h, dy):
    """The arithmetic of ``csrc/rglru_scan_bwd.cu`` in float32, vectorised
    over (B, D): each sub-chunk folded from r = 0 into the map r_out = A
    r_in + B, the maps composed from the top sub-chunk down, the r handed
    from chunk to chunk from the last, then each sub-chunk scanned again
    from its r in. Steps past S are the identity (a 1, dy 0)."""
    nsub, ls = _kernel_constants()
    chunk = nsub * ls
    b, s, d = a.shape
    n = -(-s // chunk)
    pad = n * chunk - s
    hprev = torch.cat([torch.zeros(b, 1, d), h[:, :-1]], 1)
    ap = torch.cat([a, torch.ones(b, pad, d)], 1).reshape(b, n, nsub, ls, d)
    gp = torch.cat([dy, torch.zeros(b, pad, d)], 1).reshape(b, n, nsub, ls, d)
    hp = torch.cat([hprev, torch.zeros(b, pad, d)], 1).reshape(
        b, n, nsub, ls, d)
    sub_a = torch.ones(b, n, nsub, d)
    sub_b = torch.zeros(b, n, nsub, d)
    for i in range(ls - 1, -1, -1):
        sub_b = ap[:, :, :, i] * (gp[:, :, :, i] + sub_b)
        sub_a = sub_a * ap[:, :, :, i]
    into_a = torch.empty(b, n, nsub, d)
    into_b = torch.empty(b, n, nsub, d)
    pa, pb = torch.ones(b, n, d), torch.zeros(b, n, d)
    for k in range(nsub - 1, -1, -1):
        into_a[:, :, k], into_b[:, :, k] = pa, pb
        pb = _fma(sub_a[:, :, k], pb, sub_b[:, :, k])
        pa = pa * sub_a[:, :, k]
    carry_in = torch.empty(b, n, d)
    carry = torch.zeros(b, d)
    for c in range(n - 1, -1, -1):
        carry_in[:, c] = carry
        carry = _fma(pa[:, c], carry, pb[:, c])
    r = _fma(into_a, carry_in[:, :, None], into_b)
    da = torch.empty(b, n, nsub, ls, d)
    db = torch.empty(b, n, nsub, ls, d)
    for i in range(ls - 1, -1, -1):
        dh = gp[:, :, :, i] + r
        db[:, :, :, i] = dh
        da[:, :, :, i] = dh * hp[:, :, :, i]
        r = ap[:, :, :, i] * dh
    return (da.reshape(b, n * chunk, d)[:, :s],
            db.reshape(b, n * chunk, d)[:, :s])


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_kernel_chunks_match_jax_vjp(shape, with_h0):
    """The kernel's regrouping at sub-chunk and chunk boundaries stays
    within the reference's limit, from S 1 to recurrentgemma-9b's 4096
    (32 chunks) and S a multiple of the chunk."""
    (a, x, h0, dy), want = _inputs_and_ref(shape, with_h0)
    got = _port_bwd(a, x, h0, dy, with_h0, bwd=_chunked_bwd)
    for g, w in zip(got, want):
        _max_close(g, w)


# ==========================================================================
# the reduced hybrid's training step against the reference
# ==========================================================================
def _cluster_gates(params_np, cfg, seed):
    """Every local-attention block's gate weights clustered per head clear
    of tau, as ``test_torch_prefill.cluster_gate`` sets a dense block's:
    head h of repeat r admits (scores near sigmoid(0.5)) when r + h is
    even and rejects (near sigmoid(-5)) otherwise."""
    rng = np.random.default_rng(seed)
    for i, bt in enumerate(cfg.block_pattern):
        if bt != "local_attn":
            continue
        gate = params_np["blocks"][f"b{i}"]["attn"]["gate"]
        r, h, f, m = gate["w1"].shape
        gate["w1"] = (rng.standard_normal((r, h, f, m)) / np.sqrt(f)
                      ).astype(np.float32)
        gate["b1"] = (0.1 * rng.standard_normal((r, h, m))).astype(np.float32)
        gate["w2"] = (0.5 * rng.standard_normal((r, h, m, 1)) / np.sqrt(m)
                      ).astype(np.float32)
        admit = (np.arange(r)[:, None] + np.arange(h)[None]) % 2 == 0
        gate["b2"] = np.where(admit, 0.5, -5.0)[..., None].astype(np.float32)
    return params_np


@pytest.fixture(scope="module")
def setup():
    """The reduced hybrid (64-token window) with its stem and two repeats:
    [rglru, rglru] + 2 x (rglru, rglru, local_attn)."""
    jcfg = hybrid_cfg(n_repeats=2)
    params_np = jax.tree.map(np.asarray,
                             JT.init_model(jax.random.PRNGKey(5), jcfg))
    params_np = _cluster_gates(params_np, jcfg, 105)
    tcfg = port_cfg(jcfg)
    return (jcfg, jax.tree.map(jnp.asarray, params_np), tcfg,
            params_from_numpy(params_np, tcfg, "cpu"))


@pytest.mark.parametrize("masked", [False, True])
def test_train_step_matches_reference(setup, masked, monkeypatch):
    jcfg, jparams, tcfg, tparams = setup
    rec = GateRecorder(monkeypatch)
    (toks, mask), = _batches(tcfg.vocab_size, 11, 1, s=96, masked=masked)
    (jloss, jaux), jgrads = _ref_value_and_grad(jcfg, 0.3)(
        JTR.get_gates(jparams), jparams, _jbatch(toks, mask))
    tloss, taux, tgrads = TTR.loss_and_grads(
        TTR.get_gates(tparams), tparams, tcfg, _tbatch(toks, mask), lam=0.3)
    assert rec.margin() >= TAU_MARGIN
    assert float(taux["distill"]) > 0   # S 96 passes the 64-token window
    _rel_close(tloss, jloss)
    assert set(taux) == set(jaux)
    for k in jaux:
        _rel_close(taux[k], jaux[k])
    assert sorted(tgrads) == sorted(jgrads)
    assert "blocks/b2/attn/gate/w1" in tgrads
    for k in jgrads:
        _max_close(tgrads[k].numpy(), np.asarray(jgrads[k]))


def test_train_steps_track_the_reference(setup):
    """Three steps from the same state on the same tokens: each step's
    loss and aux within 1e-5 relative of the reference's."""
    jcfg, jparams, tcfg, tparams = setup
    js, ts = JTR.init_train_state(jparams), TTR.init_train_state(tparams)
    jstep = JTR.make_train_step(jcfg, lr=1e-3, donate=False)
    for toks, mask in _batches(tcfg.vocab_size, 12, 3, b=1, s=96):
        js, jm = jstep(js, jparams, batch=_jbatch(toks, mask))
        ts, tm = TTR.train_step(ts, tparams, tcfg, _tbatch(toks, mask),
                                lr=1e-3)
        for k in jm:
            _rel_close(tm[k], jm[k])


def test_remat_gives_the_same_gradients(setup):
    _, _, tcfg, tparams = setup
    (toks, mask), = _batches(tcfg.vocab_size, 13, 1, s=96)
    gates = TTR.get_gates(tparams)
    l0, _, g0 = TTR.loss_and_grads(gates, tparams, tcfg, _tbatch(toks, mask),
                                   lam=0.3)
    l1, _, g1 = TTR.loss_and_grads(gates, tparams, tcfg, _tbatch(toks, mask),
                                   lam=0.3, remat=True)
    assert torch.equal(l0, l1)
    for k in g0:
        torch.testing.assert_close(g1[k], g0[k], atol=1e-7, rtol=1e-6)


def test_train_cli_runs_the_reduced_hybrid():
    res = TLAUNCH.main(["--arch", "recurrentgemma-9b", "--reduced",
                        "--device", "cpu", "--steps", "3", "--batch", "1",
                        "--seq", "96"])
    hist = res["history"]
    assert [h["step"] for h in hist] == [0, 2]
    assert all(np.isfinite(h["loss"]) and h["distill"] > 0 for h in hist)
    assert res["cfg"].name == "recurrentgemma-9b"
