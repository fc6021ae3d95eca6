"""The port's RG-LRU recurrence vs the reference on the CPU: the linear
scan (the ``rglru_scan`` kernel's plain version and the model's
``rglru_scan`` with a carried-in state) against the Pallas kernel in
interpret mode and the scan oracle, and the recurrent block's functions
(``rglru_block``, ``rglru_step``, their pieces and init) against the
reference's on the reduced recurrentgemma config, plus the block-vs-step
and streaming-split invariants of ``tests/test_substrate.py``.

Inputs are numpy draws (``a = sigmoid(normal)``, ``b = normal``) handed to
both packages; weights are the reference's init carried over as numpy.
Tolerances: the scan 1e-5 (``tests/test_kernels.py``'s); the gates and
the conv, single elementwise results, 1e-5 (float32 rounding, which the
gate's ``sqrt(1 - a^2)`` amplifies near a = 1); the block's y
and h 5e-5, because the reference evaluates the recurrence with
``associative_scan`` and so rounds in another order than the port's
sequential scan.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config as jax_reduced
from repro.kernels import ref as jref
from repro.kernels.rglru_scan import rglru_scan_pallas
from repro.models import rglru as JRG
from repro_torch.configs import get_reduced_config as torch_reduced
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.rglru_scan import rglru_scan, rglru_scan_plain
from repro_torch.models import rglru as TRG

torch.set_num_threads(2)

SCAN_TOL = 1e-5
GATE_TOL = 1e-5
BLOCK_TOL = 5e-5


def _ab(seed, b, s, d):
    rng = np.random.default_rng(seed)
    a = (1.0 / (1.0 + np.exp(-rng.standard_normal((b, s, d))))
         ).astype(np.float32)
    bb = rng.standard_normal((b, s, d)).astype(np.float32)
    h0 = rng.standard_normal((b, d)).astype(np.float32)
    return a, bb, h0


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=0, err_msg=msg)


# ==========================================================================
# the scan: the kernel's plain version vs Pallas (interpret) vs the oracle
# ==========================================================================
@pytest.mark.parametrize("b,s,d,bt,bd", [
    (2, 256, 256, 64, 128), (1, 128, 512, 128, 128), (3, 64, 128, 32, 64),
])
def test_scan_plain_matches_pallas_and_oracle(b, s, d, bt, bd):
    a, bb, _ = _ab(3, b, s, d)
    got = rglru_scan(torch.from_numpy(a), torch.from_numpy(bb)).numpy()
    pallas = rglru_scan_pallas(jnp.asarray(a), jnp.asarray(bb), bt=bt,
                               bd=bd, interpret=True)
    _close(got, pallas, SCAN_TOL, "vs Pallas")
    _close(got, jref.rglru_scan_ref(jnp.asarray(a), jnp.asarray(bb)),
           SCAN_TOL, "vs oracle")
    _close(got, tref.rglru_scan_ref(torch.from_numpy(a),
                                    torch.from_numpy(bb)), 0, "vs torch ref")


@pytest.mark.parametrize("b,s,d,bt,bd", [
    (2, 256, 256, 64, 128), (1, 128, 512, 128, 128), (3, 64, 128, 32, 64),
])
def test_scan_with_h0_matches_pallas_and_oracle(b, s, d, bt, bd):
    """The model's ``rglru_scan(a, b, h0)`` folds h0 into ``b[:, 0]``, as
    the reference does; the Pallas kernel gets the same fold."""
    a, bb, h0 = _ab(4, b, s, d)
    got = TRG.rglru_scan(torch.from_numpy(a), torch.from_numpy(bb),
                         torch.from_numpy(h0)).numpy()
    ja, jb, jh0 = jnp.asarray(a), jnp.asarray(bb), jnp.asarray(h0)
    folded = jb.at[:, 0].add(ja[:, 0] * jh0)
    _close(got, rglru_scan_pallas(ja, folded, bt=bt, bd=bd, interpret=True),
           SCAN_TOL, "vs Pallas")
    _close(got, jref.rglru_scan_ref(ja, jb, jh0), SCAN_TOL, "vs oracle")
    _close(got, JRG.rglru_scan(ja, jb, jh0), SCAN_TOL, "vs the model's")
    _close(got, tref.rglru_scan_ref(torch.from_numpy(a), torch.from_numpy(bb),
                                    torch.from_numpy(h0)), SCAN_TOL,
           "vs torch ref")


@pytest.mark.parametrize("with_h0", [False, True])
def test_scan_odd_shape_matches_oracle(with_h0):
    """S 37, D 100: no multiple of any tile (the Pallas kernel's asserts
    are tiling artefacts; the port takes any S and D)."""
    a, bb, h0 = _ab(5, 2, 37, 100)
    ja, jb = jnp.asarray(a), jnp.asarray(bb)
    if with_h0:
        got = TRG.rglru_scan(torch.from_numpy(a), torch.from_numpy(bb),
                             torch.from_numpy(h0)).numpy()
        want = jref.rglru_scan_ref(ja, jb, jnp.asarray(h0))
    else:
        got = tops.rglru_linear_scan(torch.from_numpy(a),
                                     torch.from_numpy(bb)).numpy()
        want = jref.rglru_scan_ref(ja, jb)
    _close(got, want, SCAN_TOL)


def test_scan_plain_is_the_sequential_recurrence():
    """S = 1 and D = 1 edge shapes; the first step is b itself."""
    a, bb, _ = _ab(6, 1, 1, 1)
    np.testing.assert_array_equal(
        rglru_scan_plain(torch.from_numpy(a), torch.from_numpy(bb)).numpy(),
        bb)
    a, bb, _ = _ab(7, 2, 9, 1)
    got = rglru_scan_plain(torch.from_numpy(a), torch.from_numpy(bb)).numpy()
    h = np.zeros((2, 1), np.float32)
    for t in range(9):
        h = a[:, t] * h + bb[:, t]
        np.testing.assert_array_equal(got[:, t], h)


# ==========================================================================
# the RG-LRU block functions vs the reference
# ==========================================================================
@pytest.fixture(scope="module")
def block_setup():
    jcfg = jax_reduced("recurrentgemma-9b").replace(dtype="float32")
    tcfg = torch_reduced("recurrentgemma-9b").replace(dtype="float32")
    jp = JRG.init_rglru(jax.random.PRNGKey(0), jcfg)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    return jcfg, jp, tcfg, tp


def test_init_matches_reference_shapes_and_dtypes():
    """Every leaf of the port's init has the reference's shape and dtype,
    ``lam`` float32 under a bf16 ``param_dtype`` too, with Lambda in the
    Griffin range (a = sigmoid(lam)^8 in [0.9, 0.999])."""
    for dt in ("float32", "bfloat16"):
        jcfg = jax_reduced("recurrentgemma-9b").replace(param_dtype=dt)
        tcfg = torch_reduced("recurrentgemma-9b").replace(param_dtype=dt)
        jp = JRG.init_rglru(jax.random.PRNGKey(0), jcfg)
        tp = TRG.init_rglru(torch.Generator().manual_seed(0), tcfg, "cpu")
        assert set(tp) == set(jp)
        for k in jp:
            assert tuple(tp[k].shape) == jp[k].shape, k
            assert str(tp[k].dtype).split(".")[-1] == str(jp[k].dtype), k
        a = torch.sigmoid(tp["lam"]) ** 8
        assert float(a.min()) >= 0.9 - 1e-5 and float(a.max()) <= 0.999 + 1e-5
    js = JRG.init_rglru_state(jcfg, 3)
    ts = TRG.init_rglru_state(tcfg, 3)
    assert tuple(ts.conv.shape) == js.conv.shape
    assert tuple(ts.h.shape) == js.h.shape and ts.h.dtype == torch.float32


def test_gates_and_conv_match(block_setup):
    jcfg, jp, tcfg, tp = block_setup
    rng = np.random.default_rng(8)
    x = (0.5 * rng.standard_normal((2, 24, tcfg.d_model))).astype(np.float32)
    st = (0.5 * rng.standard_normal((2, 3, tcfg.d_model))).astype(np.float32)
    for state in (None, st):
        jy, jst = JRG._causal_conv(jnp.asarray(x), jp["conv"],
                                   None if state is None
                                   else jnp.asarray(state))
        ty, tst = TRG._causal_conv(torch.from_numpy(x), tp["conv"],
                                   None if state is None
                                   else torch.from_numpy(state))
        _close(ty.numpy(), jy, GATE_TOL, "conv y")
        _close(tst.numpy(), jst, 0, "conv state")
    ja, jg = JRG._rg_lru_gates(jp, jnp.asarray(x))
    ta, tg = TRG._rg_lru_gates(tp, torch.from_numpy(x))
    assert ta.dtype == torch.float32 and tg.dtype == torch.float32
    _close(ta.numpy(), ja, GATE_TOL, "a")
    _close(tg.numpy(), jg, GATE_TOL, "gated")


def test_rglru_block_matches_reference(block_setup):
    """Full sequence from zero state and from a carried-in state."""
    jcfg, jp, tcfg, tp = block_setup
    rng = np.random.default_rng(9)
    x = (0.5 * rng.standard_normal((2, 48, tcfg.d_model))).astype(np.float32)
    jy, jst = JRG.rglru_block(jp, jcfg, jnp.asarray(x))
    ty, tst = TRG.rglru_block(tp, tcfg, torch.from_numpy(x))
    _close(ty.numpy(), jy, BLOCK_TOL, "y")
    _close(tst.h.numpy(), jst.h, BLOCK_TOL, "h")
    _close(tst.conv.numpy(), jst.conv, 0, "conv")
    x2 = (0.5 * rng.standard_normal((2, 17, tcfg.d_model))).astype(np.float32)
    jy2, jst2 = JRG.rglru_block(jp, jcfg, jnp.asarray(x2), jst)
    ty2, tst2 = TRG.rglru_block(tp, tcfg, torch.from_numpy(x2), tst)
    _close(ty2.numpy(), jy2, BLOCK_TOL, "y (carried state)")
    _close(tst2.h.numpy(), jst2.h, BLOCK_TOL, "h (carried state)")


def test_rglru_step_matches_reference(block_setup):
    jcfg, jp, tcfg, tp = block_setup
    rng = np.random.default_rng(10)
    js = JRG.init_rglru_state(jcfg, 2)
    ts = TRG.init_rglru_state(tcfg, 2)
    for t in range(6):
        x = (0.5 * rng.standard_normal((2, tcfg.d_model))).astype(np.float32)
        jy, js = JRG.rglru_step(jp, jcfg, jnp.asarray(x), js)
        ty, ts = TRG.rglru_step(tp, tcfg, torch.from_numpy(x), ts)
        _close(ty.numpy(), jy, BLOCK_TOL, f"y at {t}")
        _close(ts.h.numpy(), js.h, BLOCK_TOL, f"h at {t}")
        _close(ts.conv.numpy(), js.conv, GATE_TOL, f"conv at {t}")


# ==========================================================================
# the port against itself (tests/test_substrate.py's invariants)
# ==========================================================================
def test_rglru_block_vs_step(block_setup):
    _, _, tcfg, tp = block_setup
    x = torch.from_numpy((0.5 * np.random.default_rng(11).standard_normal(
        (2, 24, tcfg.d_model))).astype(np.float32))
    y_full, st_full = TRG.rglru_block(tp, tcfg, x)
    st = TRG.init_rglru_state(tcfg, 2)
    outs = []
    for t in range(24):
        y, st = TRG.rglru_step(tp, tcfg, x[:, t], st)
        outs.append(y)
    _close(torch.stack(outs, 1).numpy(), y_full.numpy(), 2e-5)
    _close(st.h.numpy(), st_full.h.numpy(), 2e-5)
    _close(st.conv.numpy(), st_full.conv.numpy(), 0)


def test_rglru_streaming_split(block_setup):
    _, _, tcfg, tp = block_setup
    x = torch.from_numpy(np.random.default_rng(12).standard_normal(
        (1, 32, tcfg.d_model)).astype(np.float32))
    y_full, _ = TRG.rglru_block(tp, tcfg, x)
    y1, st = TRG.rglru_block(tp, tcfg, x[:, :16])
    y2, _ = TRG.rglru_block(tp, tcfg, x[:, 16:], st)
    _close(torch.cat([y1, y2], 1).numpy(), y_full.numpy(), 2e-5)
