"""The port's prefill and write-gated forward vs the reference on the CPU:
masks, budgeted admission, the dual cache's initial population, the three
training attention modes, the budgeted vertical-slash prefill, the
full-sequence forward, ``I.prefill`` followed by greedy decode (at reduced
qwen3-0.6b and on the trained bench substrate) and serve's tau probe.

One set of weights for both packages: the reference's init carried over
with ``params_from_numpy``. The gate weights are drawn with numpy so that
every head's scores cluster well clear of tau (admitting heads around
sigmoid(0.5), rejecting heads around sigmoid(-5)): tau then sits outside
the gate-score cluster and admission cannot flip on float rounding
between the two frameworks. Each test asserts that margin (>= 1e-3).

Tolerances: single-layer results 5e-5 (float32 rounding of one
attention); logits and gates after several layers 1e-4, because the two
frameworks sum float32 matmuls in different orders. Integer DualCache
state and greedy tokens must be EXACT.
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_cfg
from repro.configs.base import ModelConfig as JModelConfig
from repro.configs.base import WGKVConfig as JWGKVConfig
from repro.core import admission as JADM
from repro.core import dual_cache as JDC
from repro.core import masks as JM
from repro.models import attention as JA
from repro.models import inference as JI
from repro.models import transformer as JT
from repro.training import checkpoint as JCK
from repro_torch.configs.base import ModelConfig as TModelConfig
from repro_torch.configs.base import WGKVConfig as TWGKVConfig
from repro_torch.convert import params_from_numpy
from repro_torch.core import admission as TADM
from repro_torch.core import dual_cache as TDC
from repro_torch.core import masks as TM
from repro_torch.kernels import ops as tops
from repro_torch.launch import serve as TSERVE
from repro_torch.models import attention as TA
from repro_torch.models import inference as TI
from repro_torch.models import transformer as TT
from test_torch_support import port_cfg

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
SUBSTRATE = REPO / "checkpoints" / "bench_model_lam0.15.npz"
TAU_MARGIN = 1e-3
INT_FIELDS = ("lpos", "gpos", "gcnt", "t", "ptr", "overflow")


def cluster_gate(params_np, seed: int):
    """Gate weights whose scores cluster per head, clear of tau = 0.1:
    head h of layer r admits (scores near sigmoid(0.5)) when r + h is
    even and rejects (near sigmoid(-5)) otherwise."""
    rng = np.random.default_rng(seed)
    gate = params_np["blocks"]["b0"]["attn"]["gate"]
    r, h, f, m = gate["w1"].shape
    gate["w1"] = (rng.standard_normal((r, h, f, m)) / np.sqrt(f)
                  ).astype(np.float32)
    gate["b1"] = (0.1 * rng.standard_normal((r, h, m))).astype(np.float32)
    gate["w2"] = (0.5 * rng.standard_normal((r, h, m, 1)) / np.sqrt(m)
                  ).astype(np.float32)
    admit = (np.arange(r)[:, None] + np.arange(h)[None]) % 2 == 0
    gate["b2"] = np.where(admit, 0.5, -5.0)[..., None].astype(np.float32)
    return params_np


def _setup(seed: int, **wgkv_kw):
    jcfg = make_cfg("qwen3-0.6b", **wgkv_kw)
    params_np = jax.tree.map(np.asarray,
                             JT.init_model(jax.random.PRNGKey(seed), jcfg))
    params_np = cluster_gate(params_np, seed + 100)
    tcfg = port_cfg(jcfg)
    return (jcfg, jax.tree.map(jnp.asarray, params_np), tcfg,
            params_from_numpy(params_np, tcfg, "cpu"))


@pytest.fixture(scope="module")
def setup():
    return _setup(0, w_local=32)


def _layer0(tree):
    return jax.tree.map(lambda x: x[0], tree)


def _tlayer0(tree):
    return {k: (v[0] if torch.is_tensor(v) else _tlayer0(v))
            for k, v in tree.items()}


def _margin(g, tau=0.1):
    return float(np.abs(np.asarray(g, np.float64) - tau).min())


class GateRecorder:
    """Records every gate score the port computes (prefill and decode both
    go through ``ops.write_gate``) so a test can assert its tau margin."""

    def __init__(self, monkeypatch):
        self.scores = []
        inner = tops.write_gate

        def rec(*a, **kw):
            g = inner(*a, **kw)
            self.scores.append(g.detach().numpy().ravel())
            return g
        monkeypatch.setattr(tops, "write_gate", rec)

    def margin(self, tau=0.1):
        return _margin(np.concatenate(self.scores), tau)


def _assert_cache_close(jc, tc, *, ftol=5e-5):
    for name in TDC.DualCache._fields:
        want = np.asarray(getattr(jc, name))
        got = getattr(tc, name).numpy()
        assert got.shape == want.shape, name
        if name in INT_FIELDS:
            assert got.dtype == np.int32, name
            np.testing.assert_array_equal(got, want, err_msg=name)
        else:
            np.testing.assert_allclose(got, want, atol=ftol, rtol=0,
                                       err_msg=name)


# ==========================================================================
# masks and admission
# ==========================================================================
def test_masks_match():
    rng = np.random.default_rng(0)
    g = rng.uniform(0, 0.3, (2, 3, 40)).astype(np.float32)
    tg = torch.from_numpy(g)
    for off in (0, 5):
        np.testing.assert_array_equal(
            TM.local_window_mask(7, 40, 8, off).numpy(),
            np.asarray(JM.local_window_mask(7, 40, 8, off)))
        np.testing.assert_array_equal(TM.causal_mask(7, 40, off).numpy(),
                                      np.asarray(JM.causal_mask(7, 40, off)))
        np.testing.assert_allclose(
            TM.write_gate_bias(tg, 7, 8, q_offset=off).numpy(),
            np.asarray(JM.write_gate_bias(jnp.asarray(g), 7, 8, q_offset=off)),
            atol=1e-6, rtol=1e-6)
        np.testing.assert_array_equal(
            TM.vertical_slash_mask(tg, 0.1, 7, 8, off, sink=3).numpy(),
            np.asarray(JM.vertical_slash_mask(jnp.asarray(g), 0.1, 7, 8, off,
                                              sink=3)))


@pytest.mark.parametrize("budget,sink,exclude_from", [
    (2, 4, None),      # the cut falls inside the sinks' 2.0 tie
    (6, 4, 30),        # sinks, then the highest gates, ties among them
    (12, 0, 24),       # no sinks; fewer eligible than budget in some heads
    (64, 4, 36),       # budget > S: clipped to S, mostly padding
])
def test_select_global_matches_exactly(budget, sink, exclude_from):
    """Gate scores quantized to a few values, so equal scores straddle
    the budget cut: the stable descending sort keeps the lower position
    first, as lax.top_k does."""
    rng = np.random.default_rng(budget)
    g = (rng.integers(0, 6, (3, 4, 40)) / 10.0).astype(np.float32)
    want = JADM.select_global(jnp.asarray(g), budget=budget, tau=0.1,
                              sink=sink, exclude_from=exclude_from)
    got = TADM.select_global(torch.from_numpy(g), budget=budget, tau=0.1,
                             sink=sink, exclude_from=exclude_from)
    assert got.idx.dtype == torch.int32 and got.count.dtype == torch.int32
    for name in ("idx", "valid", "count"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    eligible = ((g >= 0.1) | (np.arange(40) < sink))
    if exclude_from is not None:
        eligible &= np.arange(40) < exclude_from
    assert (got.count.numpy() <= np.minimum(budget, eligible.sum(-1))).all()


def test_admission_metrics_match():
    rng = np.random.default_rng(3)
    g = rng.uniform(0, 1, (2, 3, 50)).astype(np.float32)
    jg, tg = jnp.asarray(g), torch.from_numpy(g)
    assert TADM.tau_margin(tg, 0.1) == pytest.approx(
        JADM.tau_margin(jg, 0.1), abs=1e-7)
    np.testing.assert_allclose(TADM.admission_rate(tg, 0.1).numpy(),
                               np.asarray(JADM.admission_rate(jg, 0.1)))
    np.testing.assert_allclose(
        TADM.normalized_cache_size(tg, 0.1, 16).numpy(),
        np.asarray(JADM.normalized_cache_size(jg, 0.1, 16)), rtol=1e-6)
    with pytest.warns(RuntimeWarning, match="knife-edge"):
        TADM.check_tau_margin(tg, float(g[0, 0, 0]) + 1e-5)


# ==========================================================================
# the dual cache's initial population
# ==========================================================================
@pytest.mark.parametrize("s,w,c", [
    (64, 16, 32),    # S % W == 0: ring full, ptr 0, budget < eligible
    (40, 16, 64),    # S % W != 0, budget > S: padded to the budget
    (10, 16, 32),    # S < W: the ring holds slots 0..S-1
])
def test_prefill_populate_matches(s, w, c):
    rng = np.random.default_rng(s)
    b, h, hd = 2, 3, 8
    k = rng.standard_normal((b, h, s, hd)).astype(np.float32)
    v = rng.standard_normal((b, h, s, hd)).astype(np.float32)
    g = rng.uniform(0, 0.3, (b, h, s)).astype(np.float32)
    jc = jax.jit(lambda *a: JDC.prefill_populate(
        JDC.init_dual_cache(b, h, hd, w_local=w, budget=c), *a, tau=0.1,
        sink=3))(*map(jnp.asarray, (k, v, g)))
    tc = TDC.prefill_populate(TDC.init_dual_cache(b, h, hd, w_local=w,
                                                  budget=c),
                              *map(torch.from_numpy, (k, v, g)), tau=0.1,
                              sink=3)
    _assert_cache_close(jc, tc, ftol=0)
    # the selection the budgeted prefill already made gives the same cache
    sel = TADM.select_global(torch.from_numpy(g), budget=c, tau=0.1, sink=3,
                             exclude_from=s - min(w, s))
    tc_sel = TDC.prefill_populate(TDC.init_dual_cache(b, h, hd, w_local=w,
                                                      budget=c),
                                  *map(torch.from_numpy, (k, v, g)), tau=0.1,
                                  sink=3, sel=sel)
    for name in TDC.DualCache._fields:
        assert torch.equal(getattr(tc_sel, name), getattr(tc, name)), name
    np.testing.assert_array_equal(tc.memory_tokens().numpy(),
                                  np.asarray(jc.memory_tokens()))
    # the ring slots holding tokens are exactly the first min(t, W): the
    # invariant the two-segment decode read relies on
    n = min(s, w)
    lpos = tc.lpos.numpy()
    assert (lpos[:, :n] >= 0).all() and (lpos[:, n:] == -1).all()


def test_decode_read_after_prefill_sees_the_populated_cache(setup):
    """After ``prefill_populate`` the in-place two-segment read (global
    ``gcnt`` ‖ ring ``min(t, W)``) equals a softmax over the cache's own
    validity mask (``cache_kv_for_attention``)."""
    rng = np.random.default_rng(21)
    b, h, grp, s, w, c, hd = 2, 2, 2, 96, 32, 48, 16
    k, v = (torch.from_numpy(rng.standard_normal((b, h, s, hd))
                             .astype(np.float32)) for _ in range(2))
    g = torch.from_numpy(rng.uniform(0, 0.3, (b, h, s)).astype(np.float32))
    cache = TDC.prefill_populate(
        TDC.init_dual_cache(b, h, hd, w_local=w, budget=c), k, v, g,
        tau=0.1, sink=2)
    q = torch.from_numpy(rng.standard_normal((b, h * grp, hd))
                         .astype(np.float32))
    got = tops.dual_cache_attention(q, cache)
    kk, vv, valid = TDC.cache_kv_for_attention(cache)
    logits = torch.einsum("bhgd,bhkd->bhgk", q.reshape(b, h, grp, hd),
                          kk) * hd ** -0.5
    logits = torch.where(valid[:, :, None], logits,
                         torch.full_like(logits, -1e30))
    want = torch.einsum("bhgk,bhkd->bhgd", torch.softmax(logits, -1), vv)
    torch.testing.assert_close(got, want.reshape(b, h * grp, hd),
                               atol=5e-5, rtol=5e-5)


# ==========================================================================
# attention: the three training modes and the budgeted prefill
# ==========================================================================
@pytest.mark.parametrize("gate_mode,window,q_chunk", [
    ("off", None, None), ("off", 16, 16), ("gated", None, None),
    ("hard", None, 32),
])
def test_attn_train_matches(setup, gate_mode, window, q_chunk):
    jcfg, jparams, tcfg, tparams = setup
    rng = np.random.default_rng(5)
    b, s = 2, 64
    x = rng.standard_normal((b, s, tcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s))
    jy, jg = jax.jit(lambda p, x_, pos_: JA.attn_train(
        p, jcfg, x_, pos_, gate_mode=gate_mode, window=window,
        q_chunk=q_chunk))(_layer0(jparams["blocks"]["b0"]["attn"]),
                          jnp.asarray(x), jnp.asarray(pos))
    ty, tg = TA.attn_train(_tlayer0(tparams["blocks"]["b0"]["attn"]), tcfg,
                           torch.from_numpy(x), torch.from_numpy(pos.copy()),
                           gate_mode=gate_mode, window=window,
                           q_chunk=q_chunk)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=5e-5,
                               rtol=5e-5)
    if gate_mode == "off":
        assert tg is None and jg is None
    else:
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-5)
        assert _margin(jg) >= TAU_MARGIN


def test_attn_prefill_budgeted_matches(setup):
    jcfg, jparams, tcfg, tparams = setup
    rng = np.random.default_rng(6)
    b, s, budget = 2, 128, 32
    x = rng.standard_normal((b, s, tcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s))
    jr = jax.jit(lambda p, x_, pos_: JA.attn_prefill_budgeted(
        p, jcfg, x_, pos_, budget=budget))(
            _layer0(jparams["blocks"]["b0"]["attn"]), jnp.asarray(x),
            jnp.asarray(pos))
    tr = TA.attn_prefill_budgeted(_tlayer0(tparams["blocks"]["b0"]["attn"]),
                                  tcfg, torch.from_numpy(x),
                                  torch.from_numpy(pos.copy()), budget=budget)
    for name in ("out", "k_rope", "v", "g"):
        np.testing.assert_allclose(getattr(tr, name).numpy(),
                                   np.asarray(getattr(jr, name)), atol=5e-5,
                                   rtol=5e-5, err_msg=name)
    for name in ("idx", "valid", "count"):
        np.testing.assert_array_equal(getattr(tr.sel, name).numpy(),
                                      np.asarray(getattr(jr.sel, name)),
                                      err_msg=name)
    assert _margin(jr.g) >= TAU_MARGIN
    count = tr.sel.count.numpy()
    assert (count > 0).all() and (count <= budget).all()
    with pytest.raises(ValueError, match="multiple of the window"):
        TA.attn_prefill_budgeted(_tlayer0(tparams["blocks"]["b0"]["attn"]),
                                 tcfg, torch.from_numpy(x[:, :40]),
                                 torch.from_numpy(pos[:, :40].copy()),
                                 budget=budget)


# ==========================================================================
# the slice as a whole
# ==========================================================================
def test_forward_gated_matches(setup):
    jcfg, jparams, tcfg, tparams = setup
    toks = np.random.default_rng(7).integers(0, tcfg.vocab_size, (2, 96))
    jo = JT.forward(jparams, jcfg, jnp.asarray(toks, jnp.int32), mode="gated")
    to = TT.forward(tparams, tcfg, torch.from_numpy(toks), mode="gated")
    assert tuple(to.gates.shape) == (tcfg.n_layers, 2, tcfg.n_kv_heads, 96)
    np.testing.assert_allclose(to.gates.numpy(), np.asarray(jo.gates),
                               atol=1e-4)
    np.testing.assert_allclose(to.logits.numpy(), np.asarray(jo.logits),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(to.hidden.numpy(), np.asarray(jo.hidden),
                               atol=1e-4, rtol=1e-4)
    assert _margin(jo.gates) >= TAU_MARGIN
    # without logits, as serve's probe calls it; teacher mode has no gates
    lean = TT.forward(tparams, tcfg, torch.from_numpy(toks), mode="gated",
                      with_logits=False)
    assert lean.logits.ndim == 0
    torch.testing.assert_close(lean.gates, to.gates)
    assert TT.forward(tparams, tcfg, torch.from_numpy(toks)).gates is None


def _prefill_then_decode(jcfg, jparams, tcfg, tparams, toks, steps, **kw):
    """I.prefill in both packages, then ``steps`` greedy decode steps, each
    package feeding its own argmax. Checks logits, admission and the exact
    cache state after the prefill and after every step."""
    jprefill = jax.jit(lambda p, t: JI.prefill(p, jcfg, t, **kw))
    jdecode = jax.jit(lambda p, t, c: JI.decode_step(p, jcfg, t, c))
    jout, jc = jprefill(jparams, jnp.asarray(toks, jnp.int32))
    tout, tc = TI.prefill(tparams, tcfg, torch.from_numpy(toks), **kw)
    np.testing.assert_allclose(tout.logits.numpy(), np.asarray(jout.logits),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(tout.hidden.numpy(), np.asarray(jout.hidden),
                               atol=1e-4, rtol=1e-4)
    assert float(tout.mean_admission) == pytest.approx(
        float(jout.mean_admission), abs=1e-6)
    np.testing.assert_array_equal(tc["t"].numpy(), np.asarray(jc["t"]))
    _assert_cache_close(jc["blocks"]["b0"], tc["blocks"]["b0"], ftol=1e-4)
    jl, tl = jout.logits, tout.logits
    jtoks, ttoks = [], []
    for _ in range(steps):
        jn, tn = jnp.argmax(jl, -1), tl.argmax(-1)
        jtoks.append(np.asarray(jn))
        ttoks.append(tn.numpy())
        jl, jc, _ = jdecode(jparams, jn, jc)
        tl, tc, _ = TI.decode_step(tparams, tcfg, tn, tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=1e-4)
        _assert_cache_close(jc["blocks"]["b0"], tc["blocks"]["b0"],
                            ftol=1e-4)
    np.testing.assert_array_equal(np.stack(ttoks), np.stack(jtoks))
    return tout, tc


def test_prefill_then_decode_matches(setup, monkeypatch):
    """B = 2, S = 256, W = 32, budget 64 (< the admitting heads' eligible
    tokens, so the budget cut is taken), then 8 greedy tokens."""
    jcfg, jparams, tcfg, tparams = setup
    rec = GateRecorder(monkeypatch)
    toks = np.random.default_rng(8).integers(0, tcfg.vocab_size, (2, 256))
    tout, tc = _prefill_then_decode(jcfg, jparams, tcfg, tparams, toks, 8,
                                    budget=64)
    assert rec.margin() >= TAU_MARGIN
    gcnt = tc["blocks"]["b0"].gcnt.numpy()
    assert gcnt.max() == 64 and gcnt.min() > 0   # full and partial heads
    assert 0 < float(tout.mean_admission) < 1
    assert int(tc["t"][0]) == 256 + 8
    # the dense baseline on the same tokens: causal attention into a
    # dense cache of S + 64 slots (the port's rounded up to a page)
    jout, jc = JI.prefill(jparams, jcfg, jnp.asarray(toks, jnp.int32),
                          use_wgkv=False)
    dout, dc = TI.prefill(tparams, tcfg, torch.from_numpy(toks),
                          use_wgkv=False)
    np.testing.assert_allclose(dout.logits.numpy(), np.asarray(jout.logits),
                               atol=5e-5, rtol=0)
    jd, td = jc["blocks"]["b0"], dc["blocks"]["b0"]
    assert td.k.shape[-2] == 320 and jd.k.shape[-2] == 256 + 64
    np.testing.assert_array_equal(td.t.numpy(), np.asarray(jd.t))
    for name in ("k", "v"):
        np.testing.assert_allclose(getattr(td, name)[..., :256, :].numpy(),
                                   np.asarray(getattr(jd, name))[..., :256, :],
                                   atol=5e-5, rtol=0)


def _substrate_cfg(mod):
    """``benchmarks/common.py::bench_cfg(lam=0.15)``, field for field."""
    return mod[0](
        name="bench-tiny", arch_type="dense", d_model=128, n_heads=4,
        n_kv_heads=2, head_dim=32, d_ff=256, vocab_size=256,
        block_pattern=("attn",), n_repeats=2, rope_theta=10000.0,
        dtype="float32", wgkv=mod[1](enabled=True, w_local=16, tau=0.1,
                                     gate_hidden=32, global_budget_frac=1.0,
                                     sink=2, lam=0.15))


def test_prefill_substrate_matches(monkeypatch):
    """The trained bench substrate (distilled gates): a 128-token numpy
    prompt (seed 20, whose gate scores all stay >= 1e-3 from tau through
    prefill and decode) prefilled in both packages, then 16 greedy
    tokens."""
    jcfg = _substrate_cfg((JModelConfig, JWGKVConfig))
    tcfg = _substrate_cfg((TModelConfig, TWGKVConfig))
    jparams = JCK.restore(str(SUBSTRATE),
                          JT.init_model(jax.random.PRNGKey(0), jcfg))
    tparams = params_from_numpy(SUBSTRATE, tcfg, "cpu")
    rec = GateRecorder(monkeypatch)
    toks = np.random.default_rng(20).integers(0, 256, (1, 128))
    tout, tc = _prefill_then_decode(jcfg, jparams, tcfg, tparams, toks, 16)
    assert rec.margin() >= TAU_MARGIN
    assert 0 < float(tout.mean_admission) < 1


# ==========================================================================
# serve's startup tau probe
# ==========================================================================
def test_tau_probe_margin_matches_reference(setup, capsys):
    """The probe's margin is the reference's ``tau_margin`` of the same
    gated forward over the same 32 numpy tokens; clear of tau, it prints
    nothing."""
    jcfg, jparams, tcfg, tparams = setup
    margin = TSERVE.tau_probe(tparams, tcfg, prompt_len=64, seed=3,
                              device=torch.device("cpu"))
    ptoks = np.random.default_rng(3 + 99).integers(0, tcfg.vocab_size - 8,
                                                   size=(1, 32))
    g = JT.forward(jparams, jcfg, jnp.asarray(ptoks, jnp.int32),
                   mode="gated", with_logits=False).gates
    assert margin == pytest.approx(JADM.tau_margin(g, jcfg.wgkv.tau),
                                   abs=1e-5)
    assert margin >= TAU_MARGIN
    assert "knife-edge" not in capsys.readouterr().err


def test_tau_probe_warns_when_tau_sits_in_the_cluster(capsys):
    """Every gate near sigmoid(b2) = tau: the probe prints the
    reference's one-line stderr notice."""
    jcfg, _, tcfg, tparams = _setup(1)
    gate = tparams["blocks"]["b0"]["attn"]["gate"]
    gate["w2"] = gate["w2"] * 1e-4
    gate["b2"] = torch.full_like(gate["b2"], float(np.log(0.1 / 0.9)))
    margin = TSERVE.tau_probe(tparams, tcfg, prompt_len=8, seed=0,
                              device=torch.device("cpu"))
    err = capsys.readouterr().err
    assert margin < TAU_MARGIN
    assert "WARNING: knife-edge admission tau=0.1" in err
    assert "8-token probe" in err
