"""The port's Mixture-of-Experts (``models/moe.py``, ``attn_moe`` blocks)
against the reference on the CPU: granite-moe-3b-a800m and
qwen3-moe-235b-a22b at their reduced configs (4 experts, top 2, d 256;
``conftest.make_cfg``: f32, W 16), one set of weights (the reference's
init, the gate weights clustered per head clear of tau, carried over by
``params_from_numpy``) and the same numpy inputs.

MoE routing is the one piece whose output depends on how tokens are
batched: an expert takes at most C entries of its group (``capacity``),
in token order, so a token can be dropped because of its neighbours.
The tests make drops happen (a skewed input at the default capacity
factor; 8 serving slots at factor 0.5, so a decode step's capacity of 4
is below its 16 entries) and hold the kept set exactly.

Routing margin: a near-tie between the k-th and (k+1)-th probability
could flip an expert between XLA's float sums and torch's. Every test
that routes asserts that the port's probabilities clear
``ROUTE_MARGIN`` at that boundary (``moe.routing_margin``), and where
the reference's probabilities are at hand, that the two differ by less
than half of it, so that a flip would show as a margin failure.

Tolerances: floats 5e-5 absolute and relative; ``lb_loss`` and
``router_drop_frac`` 1e-6; greedy tokens, integer cache state, top-k
indices, per-expert load and the slot tables exact; training as in
``tests/test_torch_training.py`` (losses 1e-5 relative, gradients 1e-5 of
each reference gradient's largest magnitude).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_cfg
from repro.models import inference as JI
from repro.models import moe as JM
from repro.models import transformer as JT
from repro.serving.backend import make_backend as jax_make_backend
from repro.serving.orchestrator import SchedulerConfig as JSched
from repro.serving.orchestrator import ServeSession as JSession
from repro.training import checkpoint as JCK
from repro.training import trainer as JTR
from repro_torch.convert import flat_paths, params_from_numpy
from repro_torch.models import inference as TI
from repro_torch.models import moe as TM
from repro_torch.models import transformer as TT
from repro_torch.serving.backend import make_backend as torch_make_backend
from repro_torch.serving.orchestrator import SchedulerConfig as TSched
from repro_torch.serving.orchestrator import ServeSession as TSession
from repro_torch.training import trainer as TTR
from repro_torch.tree import tree_leaves_with_path
from test_torch_prefill import INT_FIELDS, cluster_gate
from test_torch_support import port_cfg
from test_torch_training import (_batches, _jbatch, _max_close, _rel_close,
                                 _ref_value_and_grad, _tbatch)

torch.set_num_threads(2)

ARCHS = ("granite-moe-3b-a800m", "qwen3-moe-235b-a22b")
TOL = 5e-5
LB_TOL = 1e-6
# about 30x the probability differences seen between the packages
# (under 3e-8 at these sizes)
ROUTE_MARGIN = 1e-6


def _with_factor(cfg, factor):
    return cfg.replace(moe=dataclasses.replace(cfg.moe,
                                               capacity_factor=factor))


def _nodrop(cfg):
    """Capacity factor E: C > Tg, so no entry is ever dropped (the
    reference's ``tests/test_archs.py::_nodrop``)."""
    return _with_factor(cfg, float(cfg.moe.n_experts))


@functools.lru_cache(maxsize=None)
def _setup(arch):
    """(jax cfg, jax params, port cfg, port params, numpy params)."""
    jcfg = make_cfg(arch)
    init = jax.jit(JT.init_model, static_argnums=1)
    params_np = jax.tree.map(np.asarray, init(jax.random.PRNGKey(0), jcfg))
    params_np = cluster_gate(params_np, 100)
    tcfg = port_cfg(jcfg)
    return (jcfg, jax.tree.map(jnp.asarray, params_np), tcfg,
            params_from_numpy(params_np, tcfg, "cpu"), params_np)


def _close(got, want, msg=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=TOL, rtol=TOL, err_msg=msg)


def _close_scaled(got, want, msg=""):
    """Within 5e-5 of the reference tensor's largest magnitude (at least
    1): the expert outputs of the reduced configs reach 1e3 (the
    reference's init scales ``[E, D, F]`` weights by E^-1/2), where f32
    sums in another order differ by about 1e-6 of that scale, also in
    entries that are themselves small."""
    got = got.detach().numpy().astype(np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, msg
    err = np.abs(got - want).max()
    assert err <= TOL * max(1.0, np.abs(want).max()), (msg, err)


class RouteRecorder:
    """Records the probabilities of every routing the port does, so a
    test can assert its margin at the top-k boundary."""

    def __init__(self, monkeypatch, top_k):
        self.k = top_k
        self.margins = []
        inner = TM.route

        def rec(*a, **kw):
            r = inner(*a, **kw)
            self.margins.append(TM.routing_margin(r.probs, self.k))
            return r
        monkeypatch.setattr(TM, "route", rec)

    def margin(self):
        assert self.margins, "nothing was routed"
        return min(self.margins)


# ==========================================================================
# configs, registry, weights
# ==========================================================================
def test_moe_leaves_carry_over_path_for_path(tmp_path):
    """The reference's flat checkpoint holds ``blocks/b0/moe/*`` stacked
    on the repeats; they load into the port's tree leaf for leaf, with no
    transpose, in the shapes of the port's own init (which holds no
    ``mlp`` in an ``attn_moe`` block). Total and tree counts are held in
    ``tests/test_torch_archs.py::test_config_matches_reference``."""
    jcfg, _, tcfg, tparams, params_np = _setup(ARCHS[0])
    own = TT.init_model(tcfg, torch.Generator().manual_seed(0), "meta")
    assert "mlp" not in own["blocks"]["b0"]
    e, d, f = tcfg.moe.n_experts, tcfg.d_model, tcfg.moe.expert_d_ff
    assert {k: tuple(v.shape) for k, v in own["blocks"]["b0"]["moe"].items()
            } == {k: (tcfg.n_repeats, *shp) for k, shp in (
                ("router", (d, e)), ("w_gate", (e, d, f)),
                ("w_up", (e, d, f)), ("w_down", (e, f, d)))}
    path = str(tmp_path / "moe.npz")
    JCK.save(path, params_np)
    loaded = params_from_numpy(path, tcfg, "cpu")
    got = dict(tree_leaves_with_path(loaded))
    for name in ("router", "w_gate", "w_up", "w_down"):
        key = ("blocks", "b0", "moe", name)
        want = params_np["blocks"]["b0"]["moe"][name]
        assert want.shape[0] == tcfg.n_repeats
        np.testing.assert_array_equal(got[key].numpy(), want)
    assert set(got) == set(dict(tree_leaves_with_path(tparams)))


# ==========================================================================
# moe_ffn: output, aux, routing and the dispatch tables
# ==========================================================================
@functools.partial(jax.jit, static_argnums=(1, 3))
def _ref_dispatch(p, cfg, x, groups):
    """The reference's routing and dispatch of ``moe_ffn``, step for step
    (``src/repro/models/moe.py:70-96``), returning the capacity too."""
    mc = cfg.moe
    b, s, d = x.shape
    tg = b * s // groups
    cap = JM._capacity(tg, mc.n_experts, mc.top_k, mc.capacity_factor)
    xf = x.reshape(groups, tg, d)
    probs = jax.nn.softmax((xf @ p["router"]).astype(jnp.float32), -1)
    top_w, top_idx = jax.lax.top_k(probs, mc.top_k)
    top_w = top_w / jnp.maximum(top_w.sum(-1, keepdims=True), 1e-9)
    disp = jax.vmap(lambda xx, pp, ti, tw: JM._dispatch_one_group(
        xx, pp, ti, tw, cap, mc.n_experts))(xf, probs, top_idx, top_w)
    return jnp.asarray(cap), probs, top_idx, disp


# the reference's moe_ffn, jitted as its callers run it (eager dispatch
# of its ops costs seconds per shape on the CPU)
_ref_moe_ffn = jax.jit(JM.moe_ffn, static_argnums=(1,),
                       static_argnames=("groups",))


def _moe_input(cfg, params_np, seed, skew):
    """[2, 64, D]: normal draws plus ``skew`` times a direction that the
    router maps to unequal expert logits, as shared structure in a real
    model's hidden states would, so experts fill unevenly."""
    rng = np.random.default_rng(seed)
    router = params_np["blocks"]["b0"]["moe"]["router"][0]
    v = router[:, 0] - router[:, 1:].mean(-1)
    v = v / np.linalg.norm(v) * np.sqrt(cfg.d_model)
    x = rng.standard_normal((2, 64, cfg.d_model)) + skew * v
    return x.astype(np.float32)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("case", ["default", "nodrop", "groups2", "ties"])
def test_moe_ffn_matches_reference(arch, case):
    """y, lb_loss and router_drop_frac against the reference's
    ``moe_ffn``; the top-k indices, per-expert load, the ``[G, E, C]``
    token and valid tables (so the kept (token, expert) set) exactly equal.
    default: the config's factor 1.25 over one [2, 64] group, with drops;
    nodrop: factor E; groups2: two groups of 64; ties: a zero router, so
    every probability ties and the lower expert index must win in both
    packages (and half the entries are dropped)."""
    jcfg, _, tcfg, _, params_np = _setup(arch)
    p_np = {k: v[0] for k, v in params_np["blocks"]["b0"]["moe"].items()}
    groups = 2 if case == "groups2" else 1
    if case == "nodrop":
        jcfg, tcfg = _nodrop(jcfg), _nodrop(tcfg)
    if case == "ties":
        p_np = dict(p_np, router=np.zeros_like(p_np["router"]))
    x = _moe_input(jcfg, params_np, seed=3, skew=0.0 if case == "ties"
                   else 1.5)
    jp = {k: jnp.asarray(v) for k, v in p_np.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in p_np.items()}
    jy, jaux = _ref_moe_ffn(jp, jcfg, jnp.asarray(x), groups=groups)
    ty, taux = TM.moe_ffn(tp, tcfg, torch.from_numpy(x), groups=groups)
    _close_scaled(ty, jy, "y")
    for k in ("lb_loss", "router_drop_frac"):
        assert abs(float(taux[k]) - float(jaux[k])) <= LB_TOL, k
    cap, jprobs, jidx, (_, jtok, jw, jvalid, jload) = _ref_dispatch(
        jp, jcfg, jnp.asarray(x), groups)
    cap = int(cap)
    xf = torch.from_numpy(x).reshape(groups, -1, tcfg.d_model)
    r = TM.route(tp, tcfg, xf)
    d = TM.dispatch(xf, r, TM.capacity(xf.shape[1], tcfg.moe.n_experts,
                                       tcfg.moe.top_k,
                                       tcfg.moe.capacity_factor),
                    tcfg.moe.n_experts)
    assert d.tok_ec.shape[-1] == cap
    np.testing.assert_array_equal(r.top_idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(d.load.numpy(), np.asarray(jload))
    np.testing.assert_array_equal(d.tok_ec.numpy(), np.asarray(jtok))
    np.testing.assert_array_equal(d.valid_ec.numpy(), np.asarray(jvalid))
    _close(d.w_ec, jw, "w_ec")
    kept = {(g, int(t), e) for g, e, c in zip(*np.nonzero(np.asarray(jvalid)))
            for t in [np.asarray(jtok)[g, e, c]]}
    assert kept == {(g, int(d.tok_ec[g, e, c]), e)
                    for g, e, c in zip(*np.nonzero(d.valid_ec.numpy()))}
    drop = float(taux["router_drop_frac"])
    if case == "nodrop":
        assert drop == 0.0
    else:
        assert drop > 0.0
    if case == "ties":
        assert (r.top_idx == torch.arange(tcfg.moe.top_k)).all()
    else:
        assert TM.routing_margin(r.probs, tcfg.moe.top_k) >= ROUTE_MARGIN
        assert np.abs(r.probs.numpy() - np.asarray(jprobs)).max() \
            < ROUTE_MARGIN / 2


# ==========================================================================
# the reduced models: forward, prefill + decode, and the invariant
# ==========================================================================
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mode", ["teacher", "gated", "hard"])
def test_forward_matches(arch, mode, monkeypatch):
    jcfg, jparams, tcfg, tparams, _ = _setup(arch)
    rec = RouteRecorder(monkeypatch, tcfg.moe.top_k)
    toks = np.random.default_rng(7).integers(0, tcfg.vocab_size, (2, 64))
    jo = JT.forward(jparams, jcfg, jnp.asarray(toks, jnp.int32), mode=mode)
    to = TT.forward(tparams, tcfg, torch.from_numpy(toks), mode=mode)
    _close(to.logits, jo.logits, "logits")
    _close(to.hidden, jo.hidden, "hidden")
    assert abs(float(to.lb_loss) - float(jo.lb_loss)) <= LB_TOL
    assert float(to.lb_loss) > 0
    if mode == "teacher":
        assert to.gates is None
    else:
        _close(to.gates, jo.gates, "gates")
    assert rec.margin() >= ROUTE_MARGIN


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_matches(arch, monkeypatch):
    """B 2, S 64 past the 16-token ring at budget 32, then 3 greedy
    steps, each package feeding its own argmax: tokens and integer cache
    state exact, floats at 5e-5."""
    jcfg, jparams, tcfg, tparams, _ = _setup(arch)
    rec = RouteRecorder(monkeypatch, tcfg.moe.top_k)
    toks = np.random.default_rng(8).integers(0, tcfg.vocab_size, (2, 64))
    jout, jc = JI.prefill(jparams, jcfg, jnp.asarray(toks, jnp.int32),
                          budget=32)
    tout, tc = TI.prefill(tparams, tcfg, torch.from_numpy(toks), budget=32)
    jdecode = jax.jit(lambda p, t, c: JI.decode_step(p, jcfg, t, c))
    jl, tl = jout.logits, tout.logits
    _close(tl, jl, "prefill logits")
    for step in range(4):
        jnode, tnode = jc["blocks"]["b0"], tc["blocks"]["b0"]
        np.testing.assert_array_equal(tc["t"].numpy(), np.asarray(jc["t"]))
        for name in tnode._fields:
            got, want = getattr(tnode, name).numpy(), np.asarray(
                getattr(jnode, name))
            if name in INT_FIELDS:
                np.testing.assert_array_equal(got, want, err_msg=name)
            else:
                np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL,
                                           err_msg=f"{name} at {step}")
        if step == 3:
            break
        jn, tn = jnp.argmax(jl, -1), tl.argmax(-1)
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
        jl, jc, _ = jdecode(jparams, jn, jc)
        tl, tc, _ = TI.decode_step(tparams, tcfg, tn, tc)
        _close(tl, jl, f"logits at step {step}")
    assert rec.margin() >= ROUTE_MARGIN
    assert int(tc["t"][0]) == 64 + 3


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_matches_forward(arch):
    """The port's own system invariant, without drops (the reference's
    ``tests/test_archs.py::test_prefill_decode_matches_forward``):
    budgeted prefill + dual-cache decode equals the hard-gated forward."""
    _, _, tcfg, tparams, _ = _setup(arch)
    cfg = _nodrop(tcfg)
    b, s, k_steps = 2, 64, 3
    toks = torch.from_numpy(np.random.default_rng(9).integers(
        0, cfg.vocab_size, (b, s + k_steps)))
    po, caches = TI.prefill(tparams, cfg, toks[:, :s], budget=64)
    ref = TT.forward(tparams, cfg, toks[:, :s], mode="hard").logits[:, -1]
    np.testing.assert_allclose(po.logits.numpy(), ref.numpy(), atol=2e-4)
    for i in range(k_steps):
        logits, caches, _ = TI.decode_step(tparams, cfg, toks[:, s + i],
                                           caches)
        refi = TT.forward(tparams, cfg, toks[:, :s + i + 1],
                          mode="hard").logits[:, -1]
        np.testing.assert_allclose(logits.numpy(), refi.numpy(), atol=2e-4)


# ==========================================================================
# serving: 8 slots whose decode capacity drops entries across rows
# ==========================================================================
def _serve(session, prompts, max_new):
    handles = [session.submit(p, max_new=max_new) for p in prompts]
    session.run()
    out = [h.tokens() for h in handles]
    session.close()
    return out


@pytest.mark.parametrize("backend", ["wgkv", "dense"])
def test_serve_ragged_slots_match_reference(backend, monkeypatch):
    """Five ragged prompts on 8 slots at capacity factor 0.5: a position
    step routes all 8 rows (16 entries) with a capacity of 4 per expert,
    so entries are dropped across rows, and the 3 empty slots and the
    finished prompts' rows take part. Streams identical to the
    reference's."""
    jcfg, jparams, tcfg, tparams, _ = _setup(ARCHS[0])
    jcfg, tcfg = _with_factor(jcfg, 0.5), _with_factor(tcfg, 0.5)
    assert TM.capacity(8, 4, 2, 0.5) == 4
    drops = []
    inner = TM.moe_ffn

    def rec(*a, **kw):
        y, aux = inner(*a, **kw)
        drops.append(float(aux["router_drop_frac"]))
        return y, aux
    monkeypatch.setattr(TM, "moe_ffn", rec)
    routes = RouteRecorder(monkeypatch, tcfg.moe.top_k)
    rng = np.random.default_rng(12)
    prompts = [rng.integers(0, 500, n).tolist() for n in (21, 9, 14, 5, 17)]
    kw = dict(slots=8, capacity=64, pool_pages=1024)
    jeng = jax_make_backend(backend, jparams, jcfg, **kw)
    teng = torch_make_backend(backend, tparams, tcfg, device="cpu", **kw)
    want = _serve(JSession(jeng, sched=JSched(chunk_tokens=16)), prompts, 4)
    got = _serve(TSession(teng, sched=TSched(chunk_tokens=16)), prompts, 4)
    assert got == want
    assert all(len(s) == 4 for s in got)
    assert max(drops) > 0
    assert routes.margin() >= ROUTE_MARGIN


# ==========================================================================
# training
# ==========================================================================
def test_train_step_matches_reference(monkeypatch):
    """One step of gate distillation on reduced granite (B 2 x 64 past
    the 16-token window): loss, aux and every gate gradient against
    ``jax.value_and_grad`` (the gradient runs back through the MoE FFNs
    of the later layer); then ``train_step`` takes the optimizer step."""
    jcfg, jparams, tcfg, tparams, _ = _setup(ARCHS[0])
    rec = RouteRecorder(monkeypatch, tcfg.moe.top_k)
    (toks, mask), = _batches(tcfg.vocab_size, 7, 1)
    (jloss, jaux), jgrads = _ref_value_and_grad(jcfg, 0.3)(
        JTR.get_gates(jparams), jparams, _jbatch(toks, mask))
    tloss, taux, tgrads = TTR.loss_and_grads(
        TTR.get_gates(tparams), tparams, tcfg, _tbatch(toks, mask), lam=0.3)
    _rel_close(tloss, jloss)
    assert set(taux) == set(jaux)
    for k in jaux:
        _rel_close(taux[k], jaux[k])
    assert float(taux["distill"]) > 0
    assert sorted(tgrads) == sorted(jgrads)
    for k in jgrads:
        _max_close(tgrads[k].numpy(), np.asarray(jgrads[k]))
    tstate, tm = TTR.train_step(TTR.init_train_state(tparams), tparams, tcfg,
                                _tbatch(toks, mask), lr=1e-3, lam=0.3)
    _rel_close(tm["loss"], jloss)
    assert int(tstate.opt.step) == 1
    assert rec.margin() >= ROUTE_MARGIN


def test_lm_loss_and_grads_match_reference(monkeypatch):
    """The LM loss with 0.01 x the summed load-balance loss on reduced
    qwen3-moe, and the gradient ``lm_train_step`` took for every leaf
    (router and experts included; its first Adam moment is 0.1 x the
    gradient), against the reference's ``lm_loss_fn``."""
    jcfg, jparams, tcfg, tparams, _ = _setup(ARCHS[1])
    rec = RouteRecorder(monkeypatch, tcfg.moe.top_k)
    (toks, _), = _batches(tcfg.vocab_size, 11, 1)
    (jloss, jaux), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: JTR.lm_loss_fn(p, jcfg, b), has_aux=True))(
        jparams, _jbatch(toks, None))
    state, m = TTR.lm_train_step(TTR.init_lm_train_state(tparams), tcfg,
                                 _tbatch(toks, None), lr=1e-3)
    _rel_close(m["loss"], jloss)
    for k in ("lm_loss", "lb_loss"):
        _rel_close(m[k], jaux[k])
    assert float(m["lb_loss"]) > 0
    tgrads = {k: v / 0.1 for k, v in flat_paths(state.opt.m)}
    jflat = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    assert len(jflat) == len(tgrads)
    for path, leaf in jflat:
        key = "/".join(str(getattr(q, "key", getattr(q, "idx", q)))
                       for q in path)
        _max_close(tgrads[key].numpy(), np.asarray(leaf))
    assert float(tgrads["blocks/b0/moe/router"].abs().max()) > 0
    assert rec.margin() >= ROUTE_MARGIN


@pytest.mark.parametrize("capacity", [64, 56])
def test_dense_retired_full_row_routes_as_reference(capacity, monkeypatch):
    """A dense row that ends at ``t == capacity`` (request 0: its prompt
    and 16 new tokens fill it) is retired and stepped masked beside four
    decoding rows on 8 slots at capacity factor 0.5, so its hidden state
    shares each decode step's expert capacity (4 of 16 entries) with
    theirs. The masked full row writes nothing, ropes at ``t`` and reads
    its first ``capacity`` entries, as the reference's
    (``repro/models/attention.py:54-61``): at capacity 64 the port's
    buffer is the reference's size, at 56 it is rounded up to 64. Streams
    and every row's length identical to the reference's."""
    jcfg, jparams, tcfg, tparams, _ = _setup(ARCHS[0])
    jcfg, tcfg = _with_factor(jcfg, 0.5), _with_factor(tcfg, 0.5)
    drops = []
    inner = TM.moe_ffn

    def rec(*a, **kw):
        y, aux = inner(*a, **kw)
        drops.append(float(aux["router_drop_frac"]))
        return y, aux
    monkeypatch.setattr(TM, "moe_ffn", rec)
    routes = RouteRecorder(monkeypatch, tcfg.moe.top_k)
    rng = np.random.default_rng(31)
    reqs = [(capacity - 15, 16), (9, 30), (14, 30), (5, 30), (17, 30)]
    prompts = [rng.integers(0, 500, n).tolist() for n, _ in reqs]

    def serve(session):
        hs = [session.submit(p, max_new=m) for p, (_, m) in zip(prompts,
                                                                 reqs)]
        session.run()
        session.close()
        return [h.tokens() for h in hs]

    kw = dict(slots=8, capacity=capacity)
    jeng = jax_make_backend("dense", jparams, jcfg, **kw)
    teng = torch_make_backend("dense", tparams, tcfg, device="cpu", **kw)
    want = serve(JSession(jeng, sched=JSched(chunk_tokens=16)))
    got = serve(TSession(teng, sched=TSched(chunk_tokens=16)))
    assert [len(s) for s in got] == [m for _, m in reqs]
    assert got == want
    assert max(drops) > 0
    assert routes.margin() >= ROUTE_MARGIN
