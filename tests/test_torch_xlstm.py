"""The port's xLSTM (``models/xlstm.py``, xlstm-350m's ``("mlstm",
"slstm")`` blocks) against the reference on the CPU.

Reduced xlstm-350m (d 256, 2 heads; the mLSTM's up-projection 512 wide
with head dim 256; one repeat), f32, the reference's init carried over by
``params_from_numpy``, numpy inputs from a seed. WG-KV is off for this
arch (no KV cache), so no kernel of the port runs here.

Tolerances: floats 5e-5 absolute and relative, except where a test says
otherwise; the chunkwise mLSTM at S 2048 (four chunks of 512 combined in
the reference's ``associative_scan`` tree order) within 5e-5 of the
output's largest magnitude; greedy tokens and ``t`` exact; the LM loss
1e-5 relative and its gradients 1e-5 of each reference gradient's
largest magnitude (``tests/test_torch_training.py``'s limits).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_cfg
from repro import configs as JC
from repro.models import inference as JI
from repro.models import transformer as JT
from repro.models import xlstm as JX
from repro.training import trainer as JTR
from repro_torch import configs as TC
from repro_torch.convert import flat_paths, params_from_numpy
from repro_torch.models import inference as TI
from repro_torch.models import registry as TREG
from repro_torch.models import transformer as TT
from repro_torch.models import xlstm as TX
from repro_torch.training import trainer as TTR
from repro_torch.tree import tree_map
from test_torch_support import port_cfg
from test_torch_training import (_batches, _jbatch, _max_close, _rel_close,
                                 _tbatch)

torch.set_num_threads(2)

ARCH = "xlstm-350m"
TOL = 5e-5


@functools.lru_cache(maxsize=None)
def _setup():
    """(jax cfg, jax params, port cfg, port params, numpy params)."""
    jcfg = make_cfg(ARCH)
    init = jax.jit(JT.init_model, static_argnums=1)
    params_np = jax.tree.map(np.asarray, init(jax.random.PRNGKey(0), jcfg))
    tcfg = port_cfg(jcfg)
    return (jcfg, jax.tree.map(jnp.asarray, params_np), tcfg,
            params_from_numpy(params_np, tcfg, "cpu"), params_np)


def _cell(params, bt_index):
    """Block ``b<i>``'s cell of the single repeat."""
    return jax.tree.map(lambda a: a[0],
                        params["blocks"][f"b{bt_index}"]["cell"])


def _tcell(params, bt_index):
    return tree_map(lambda a: a[0], params["blocks"][f"b{bt_index}"]["cell"])


def _close(got, want, msg="", tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=tol, rtol=tol, err_msg=msg)


def _close_scaled(got, want, msg=""):
    got = got.detach().numpy().astype(np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, msg
    err = np.abs(got - want).max()
    assert err <= TOL * max(1.0, np.abs(want).max()), (msg, err)


def _state_close(tstate, jstate, msg):
    for name in tstate._fields:
        _close(getattr(tstate, name), getattr(jstate, name), f"{msg} {name}")


def _x(seed, b, s, d):
    return np.random.default_rng(seed).standard_normal(
        (b, s, d)).astype(np.float32)


# ==========================================================================
# config and the tree
# ==========================================================================
@pytest.mark.parametrize("reduced", [False, True])
def test_config_and_tree_count(reduced):
    """Field by field; the tree (on the meta device) counts what the
    analytic count says, which is the reference's."""
    jget = JC.get_reduced_config if reduced else JC.get_config
    tget = TC.get_reduced_config if reduced else TC.get_config
    j, t = jget(ARCH), tget(ARCH)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.block_pattern == ("mlstm", "slstm") and not t.wgkv_applicable()
    assert t.param_count() == j.param_count()
    tree = TT.init_model(t, torch.Generator(), "meta")
    assert TREG.count_params_tree(tree) == t.param_count()
    assert TREG.gate_params_tree(tree) == 0


def test_leaves_carry_over_path_for_path():
    """Every reference leaf (the cells' ``conv``, ``r``, norms and
    projections) reaches the port's tree at its path, untransposed."""
    *_, tparams, params_np = _setup()
    want = {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): np.asarray(a)
            for path, a in jax.tree_util.tree_flatten_with_path(
                params_np)[0]}
    got = dict(flat_paths(tparams))
    assert sorted(got) == sorted(want)
    for key, a in want.items():
        np.testing.assert_array_equal(got[key].numpy(), a, err_msg=key)


# ==========================================================================
# the blocks
# ==========================================================================
@pytest.mark.parametrize("form", ["quadratic", "chunkwise16", "state"])
def test_mlstm_forms_match(form):
    """B 2, S 64: the quadratic form, the chunkwise form at chunk 16
    (four chunks), and the chunkwise form continuing from the state a
    first 32 tokens left: outputs and the final (conv, C, n, m) state."""
    jcfg, _, tcfg, tparams, params_np = _setup()
    jp, tp = _cell(params_np, 0), _tcell(tparams, 0)
    x = _x(1, 2, 64, tcfg.d_model)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    if form == "quadratic":
        jy, js = JX.mlstm_block(jp, jcfg, jx)
        ty, ts = TX.mlstm_block(tp, tcfg, tx)
    elif form == "chunkwise16":
        jy, js = JX.mlstm_block_chunkwise(jp, jcfg, jx, chunk=16)
        ty, ts = TX.mlstm_block_chunkwise(tp, tcfg, tx, chunk=16)
    else:
        _, js0 = JX.mlstm_block(jp, jcfg, jx[:, :32])
        _, ts0 = TX.mlstm_block(tp, tcfg, tx[:, :32])
        jy, js = JX.mlstm_block_chunkwise(jp, jcfg, jx[:, 32:], js0, chunk=8)
        ty, ts = TX.mlstm_block_chunkwise(tp, tcfg, tx[:, 32:], ts0, chunk=8)
    _close(ty, jy, form)
    _state_close(ts, js, form)


def test_mlstm_chunkwise_long_matches():
    """B 1, S 2048 through ``mlstm_auto``, which takes the chunkwise form
    (chunk 512, four chunks): the chunk states are combined in the
    reference's tree order. Output within 5e-5 of its largest magnitude,
    the final state at 5e-5."""
    jcfg, _, tcfg, tparams, params_np = _setup()
    x = _x(2, 1, 2048, tcfg.d_model)
    jy, js = JX.mlstm_auto(_cell(params_np, 0), jcfg, jnp.asarray(x))
    ty, ts = TX.mlstm_auto(_tcell(tparams, 0), tcfg, torch.from_numpy(x))
    _close_scaled(ty, jy, "S 2048")
    _state_close(ts, js, "S 2048")


def test_associative_scan_order_matches_jax():
    """The port's scan takes ``jax.lax.associative_scan``'s tree order:
    with a combine that is not associative (a/2 + b/4, exact in f32 on
    these integers) the two give the same values on 2 to 9 elements."""
    for n in range(2, 10):
        vals = np.arange(1, n + 1, dtype=np.float32)
        j = jax.lax.associative_scan(lambda a, b: a * 0.5 + b * 0.25,
                                     jnp.asarray(vals))
        t, = TX.associative_scan(lambda a, b: [a[0] * 0.5 + b[0] * 0.25],
                                 [torch.from_numpy(vals)], axis=0)
        np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=n)


def test_mlstm_step_matches():
    """8 recurrent steps from the zero state: outputs and state."""
    jcfg, _, tcfg, tparams, params_np = _setup()
    jp, tp = _cell(params_np, 0), _tcell(tparams, 0)
    x = _x(3, 2, 8, tcfg.d_model)
    js = JX.init_mlstm_state(jcfg, 2)
    ts = TX.init_mlstm_state(tcfg, 2)
    for i in range(8):
        jy, js = JX.mlstm_step(jp, jcfg, jnp.asarray(x[:, i]), js)
        ty, ts = TX.mlstm_step(tp, tcfg, torch.from_numpy(x[:, i]), ts)
        _close(ty, jy, f"step {i}")
    _state_close(ts, js, "after 8 steps")


def test_slstm_block_matches_reference_and_its_steps():
    """B 2, S 24: the sequential block against the reference's scan, and
    against the port's own ``slstm_step`` run token by token."""
    jcfg, _, tcfg, tparams, params_np = _setup()
    jp, tp = _cell(params_np, 1), _tcell(tparams, 1)
    x = _x(4, 2, 24, tcfg.d_model)
    jy, js = JX.slstm_block(jp, jcfg, jnp.asarray(x))
    ty, ts = TX.slstm_block(tp, tcfg, torch.from_numpy(x))
    _close(ty, jy, "block")
    _state_close(ts, js, "block")
    st = TX.init_slstm_state(tcfg, 2)
    for i in range(24):
        yi, st = TX.slstm_step(tp, tcfg, torch.from_numpy(x[:, i]), st)
        _close(yi, ty[:, i].numpy(), f"step {i}")
    _state_close(st, ts, "steps")


# ==========================================================================
# the model
# ==========================================================================
def test_forward_matches():
    jcfg, jparams, tcfg, tparams, _ = _setup()
    toks = np.random.default_rng(5).integers(0, tcfg.vocab_size, (2, 48))
    j = JT.forward(jparams, jcfg, jnp.asarray(toks, jnp.int32))
    t = TT.forward(tparams, tcfg, torch.from_numpy(toks))
    _close(t.hidden, j.hidden, "hidden")
    _close(t.logits, j.logits, "logits")
    assert t.gates is None and j.gates is None


def test_prefill_then_decode_streams_match():
    """Prefill of B 2 x 40 tokens, then 8 greedy steps, each package
    feeding its own argmax: tokens and ``t`` exact, logits and every
    recurrent state at 5e-5."""
    jcfg, jparams, tcfg, tparams, _ = _setup()
    toks = np.random.default_rng(6).integers(0, tcfg.vocab_size, (2, 40))
    jout, jc = JI.prefill(jparams, jcfg, jnp.asarray(toks, jnp.int32))
    tout, tc = TI.prefill(tparams, tcfg, torch.from_numpy(toks))
    jdecode = jax.jit(lambda p, t, c: JI.decode_step(p, jcfg, t, c))
    jl, tl = jout.logits, tout.logits
    _close(tl, jl, "prefill logits")
    for step in range(8):
        jn, tn = jnp.argmax(jl, -1), tl.argmax(-1)
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
        jl, jc, _ = jdecode(jparams, jn, jc)
        tl, tc, _ = TI.decode_step(tparams, tcfg, tn, tc)
        _close(tl, jl, f"logits at step {step}")
    np.testing.assert_array_equal(tc["t"].numpy(), np.asarray(jc["t"]))
    assert int(tc["t"][0]) == 48
    for i in range(2):
        _state_close(tc["blocks"][f"b{i}"], jc["blocks"][f"b{i}"],
                     f"b{i} after decode")


def test_lm_train_step_matches_reference():
    """``lm_train_step`` on B 2 x 64 (every leaf trains; the arch has no
    gate to distill): its loss against the reference's ``lm_loss_fn`` at
    1e-5, and the gradient it took for every leaf (its first Adam moment
    is 0.1 x the gradient) at 1e-5 of each reference gradient's max."""
    jcfg, jparams, tcfg, tparams, _ = _setup()
    (toks, _), = _batches(tcfg.vocab_size, 11, 1)
    (jloss, jaux), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: JTR.lm_loss_fn(p, jcfg, b), has_aux=True))(
        jparams, _jbatch(toks, None))
    state, m = TTR.lm_train_step(TTR.init_lm_train_state(tparams), tcfg,
                                 _tbatch(toks, None), lr=1e-3)
    _rel_close(m["loss"], jloss)
    _rel_close(m["lm_loss"], jaux["lm_loss"])
    tgrads = {k: v / 0.1 for k, v in flat_paths(state.opt.m)}
    jflat = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    assert len(jflat) == len(tgrads)
    for path, leaf in jflat:
        key = "/".join(str(getattr(q, "key", getattr(q, "idx", q)))
                       for q in path)
        _max_close(tgrads[key].numpy(), np.asarray(leaf))
    assert float(tgrads["blocks/b1/cell/r"].abs().max()) > 0
