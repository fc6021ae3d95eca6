"""The port's encoder-decoder (whisper-medium: ``("enc_attn",)`` encoder
blocks, ``("attn_cross",)`` decoder blocks, LayerNorm, sinusoidal
positions, no RoPE) against the reference on the CPU.

Reduced whisper-medium (d 256, 4 / 4 heads of hd 64, two encoder and two
decoder layers; ``conftest.make_cfg``: f32, W 16, sink 4), the
reference's init with every write gate (self and cross) clustered per
head clear of tau, carried over by ``params_from_numpy``; frame
embeddings and tokens drawn with numpy from a seed.

Tolerances: floats 5e-5 absolute and relative; greedy tokens, integer
cache state, the cross memory's ``valid`` mask and the indices it keeps
exact; training as in ``tests/test_torch_training.py`` (losses and aux
1e-5 relative, gate gradients 1e-5 of each reference gradient's largest
magnitude).
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
from repro.core.admission import select_global as jselect_global
from repro.core.gate import gate_scores as jgate_scores
from repro.models import attention as JA
from repro.models import inference as JI
from repro.models import registry as JREG
from repro.models import transformer as JT
from repro.training import trainer as JTR
from repro_torch import configs as TC
from repro_torch.convert import flat_paths, params_from_numpy
from repro_torch.core.admission import select_global
from repro_torch.core.gate import gate_scores as tgate_scores
from repro_torch.models import attention as TA
from repro_torch.models import inference as TI
from repro_torch.models import registry as TREG
from repro_torch.models import transformer as TT
from repro_torch.training import trainer as TTR
from repro_torch.tree import tree_map
from test_torch_prefill import INT_FIELDS, GateRecorder
from test_torch_support import port_cfg
from test_torch_training import (_batches, _max_close, _ref_value_and_grad,
                                 _rel_close)

torch.set_num_threads(2)

ARCH = "whisper-medium"
TOL = 5e-5
TAU_MARGIN = 1e-3
S_ENC = 48


def cluster_gates(params_np, seed: int):
    """Every gate (each block's self and cross attention) drawn so that
    its scores cluster per (repeat, head) clear of tau = 0.1: head h of
    repeat r admits (scores near sigmoid(0.5)) when r + h is even, else
    rejects (near sigmoid(-5))."""
    rng = np.random.default_rng(seed)
    for mixer in ("attn", "xattn"):
        gate = params_np["blocks"]["b0"][mixer]["gate"]
        r, h, f, m = gate["w1"].shape
        gate["w1"] = (rng.standard_normal((r, h, f, m)) / np.sqrt(f)
                      ).astype(np.float32)
        gate["b1"] = (0.1 * rng.standard_normal((r, h, m))
                      ).astype(np.float32)
        gate["w2"] = (0.5 * rng.standard_normal((r, h, m, 1)) / np.sqrt(m)
                      ).astype(np.float32)
        admit = (np.arange(r)[:, None] + np.arange(h)[None]) % 2 == 0
        gate["b2"] = np.where(admit, 0.5, -5.0)[..., None].astype(np.float32)
    return params_np


@functools.lru_cache(maxsize=None)
def _setup():
    """(jax cfg, jax params, port cfg, port params, numpy params)."""
    jcfg = make_cfg(ARCH)
    init = jax.jit(JT.init_model, static_argnums=1)
    params_np = jax.tree.map(np.asarray, init(jax.random.PRNGKey(0), jcfg))
    params_np = cluster_gates(params_np, 100)
    tcfg = port_cfg(jcfg)
    return (jcfg, jax.tree.map(jnp.asarray, params_np), tcfg,
            params_from_numpy(params_np, tcfg, "cpu"), params_np)


def _frames(seed, b, s, d):
    return (0.1 * np.random.default_rng(seed).standard_normal(
        (b, s, d))).astype(np.float32)


def _close(got, want, msg=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=TOL, rtol=TOL, err_msg=msg)


# ==========================================================================
# config and the tree
# ==========================================================================
@pytest.mark.parametrize("reduced", [False, True])
def test_config_and_tree_count(reduced):
    """Field by field; the tree (on the meta device: encoder, LayerNorm
    biases, tied embeddings) counts the analytic count, which is the
    reference's, and its gate parameters are the reference's count."""
    jget = JC.get_reduced_config if reduced else JC.get_config
    tget = TC.get_reduced_config if reduced else TC.get_config
    j, t = jget(ARCH), tget(ARCH)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.is_encdec and t.rope_theta == 0 and t.tie_embeddings
    assert t.param_count() == j.param_count()
    tree = TT.init_model(t, torch.Generator(), "meta")
    assert TREG.count_params_tree(tree) == t.param_count()
    jtree = jax.eval_shape(lambda k: JT.init_model(k, j),
                           jax.random.PRNGKey(0))
    assert TREG.gate_params_tree(tree) == JREG.gate_params_tree(jtree) > 0


def test_leaves_carry_over_path_for_path():
    """The encoder, the cross attention and the LayerNorm biases reach
    the port's tree at their paths, untransposed."""
    *_, tparams, params_np = _setup()
    want = {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): np.asarray(a)
            for path, a in jax.tree_util.tree_flatten_with_path(
                params_np)[0]}
    got = dict(flat_paths(tparams))
    assert sorted(got) == sorted(want)
    assert "enc/blocks/b0/attn/w_q" in got and "blocks/b0/xattn/gate/w1" in got
    for key, a in want.items():
        np.testing.assert_array_equal(got[key].numpy(), a, err_msg=key)


# ==========================================================================
# the cross memory and the encoder
# ==========================================================================
@pytest.mark.parametrize("budget", [None, 20, 64])
def test_cross_cache_matches(budget):
    """The cross K/V of a [2, 48, D] encoder output: whole (no budget, or
    a budget past S_enc) or the gate's top 20 per head, sinks first:
    ``valid`` and the kept indices exact, K/V at 5e-5, and one attention
    of a [2, 5, D] decoder stream over it."""
    jcfg, _, tcfg, tparams, params_np = _setup()
    jp = jax.tree.map(lambda a: jnp.asarray(a[0]),
                      params_np["blocks"]["b0"]["xattn"])
    tp = tree_map(lambda a: a[0], tparams["blocks"]["b0"]["xattn"])
    enc = _frames(1, 2, S_ENC, tcfg.d_model) * 10
    jc = JA.build_cross_cache(jp, jcfg, jnp.asarray(enc), budget=budget)
    tc = TA.build_cross_cache(tp, tcfg, torch.from_numpy(enc), budget=budget)
    np.testing.assert_array_equal(tc.valid.numpy(), np.asarray(jc.valid))
    _close(tc.k, jc.k, "k")
    _close(tc.v, jc.v, "v")
    if budget is not None and budget < S_ENC:
        k = TA._heads(torch.from_numpy(enc) @ tp["w_k"], 4, 64)
        g = tgate_scores(tp["gate"], k, k)
        jk = JA._heads(jnp.asarray(enc) @ jp["w_k"], 4, 64)
        np.testing.assert_allclose(
            g.numpy(), np.asarray(jgate_scores(jp["gate"], jk, jk)),
            atol=TOL)
        assert float((g - tcfg.wgkv.tau).abs().min()) >= TAU_MARGIN
        sel = select_global(g, budget=budget, tau=tcfg.wgkv.tau,
                            sink=tcfg.wgkv.sink)
        jsel = jselect_global(jgate_scores(jp["gate"], jk, jk),
                              budget=budget, tau=jcfg.wgkv.tau,
                              sink=jcfg.wgkv.sink)
        np.testing.assert_array_equal(sel.idx.numpy(), np.asarray(jsel.idx))
        bi = torch.arange(2)[:, None, None]
        hi = torch.arange(4)[None, :, None]
        np.testing.assert_array_equal(
            tc.k.numpy(), k[bi, hi, sel.idx.long()].numpy())
        assert 0 < int(tc.valid.sum(-1).min()) <= budget
    x = _frames(2, 2, 5, tcfg.d_model) * 10
    _close(TA.attn_cross(tp, tcfg, torch.from_numpy(x), tc),
           JA.attn_cross(jp, jcfg, jnp.asarray(x), jc), "attn_cross")


def test_encoder_matches():
    jcfg, jparams, tcfg, tparams, _ = _setup()
    enc = _frames(3, 2, S_ENC, tcfg.d_model)
    _close(TT.encode(tparams, tcfg, torch.from_numpy(enc)),
           JT._encode(jparams, jcfg, jnp.asarray(enc)), "encoder output")


@pytest.mark.parametrize("mode", ["teacher", "hard", "gated"])
def test_forward_matches(mode):
    """B 2, S 40 past the 16-token window, over a 48-position encoder:
    hidden, logits and (gated / hard) the self-attention gates."""
    jcfg, jparams, tcfg, tparams, _ = _setup()
    toks = np.random.default_rng(4).integers(0, tcfg.vocab_size, (2, 40))
    enc = _frames(5, 2, S_ENC, tcfg.d_model)
    j = JT.forward(jparams, jcfg, jnp.asarray(toks, jnp.int32), mode=mode,
                   enc_embeds=jnp.asarray(enc))
    t = TT.forward(tparams, tcfg, torch.from_numpy(toks), mode=mode,
                   enc_embeds=torch.from_numpy(enc))
    _close(t.hidden, j.hidden, "hidden")
    _close(t.logits, j.logits, "logits")
    if mode == "teacher":
        assert t.gates is None and j.gates is None
    else:
        _close(t.gates, j.gates, "gates")


# ==========================================================================
# prefill and decode
# ==========================================================================
def test_prefill_then_decode_matches(monkeypatch):
    """B 2: a 32-token prompt over a 48-position encoder at budget 16
    (the cross memory keeps 16 of 48 per head), then 3 greedy steps, each
    package feeding its own argmax: tokens, integer self-cache state and
    the cross ``valid`` exact; logits and cache floats at 5e-5. Without
    RoPE the cache's keys are the pre-RoPE keys the gate scored."""
    jcfg, jparams, tcfg, tparams, _ = _setup()
    rec = GateRecorder(monkeypatch)
    toks = np.random.default_rng(8).integers(0, tcfg.vocab_size, (2, 32))
    enc = _frames(9, 2, S_ENC, tcfg.d_model)
    jout, jc = JI.prefill(jparams, jcfg, jnp.asarray(toks, jnp.int32),
                          enc_embeds=jnp.asarray(enc), budget=16)
    tout, tc = TI.prefill(tparams, tcfg, torch.from_numpy(toks),
                          enc_embeds=torch.from_numpy(enc), budget=16)
    _close(tout.hidden, jout.hidden, "prefill hidden")
    _rel_close(tout.mean_admission, jout.mean_admission, 1e-6)
    jdecode = jax.jit(lambda p, t, c: JI.decode_step(p, jcfg, t, c))
    jl, tl = jout.logits, tout.logits
    for step in range(4):
        jnode, tnode = jc["blocks"]["b0"], tc["blocks"]["b0"]
        np.testing.assert_array_equal(tc["t"].numpy(), np.asarray(jc["t"]))
        for name in tnode["self"]._fields:
            got = getattr(tnode["self"], name).numpy()
            want = np.asarray(getattr(jnode["self"], name))
            if name in INT_FIELDS:
                np.testing.assert_array_equal(got, want, err_msg=name)
            else:
                np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL,
                                           err_msg=f"{name} at {step}")
        np.testing.assert_array_equal(tnode["cross"].valid.numpy(),
                                      np.asarray(jnode["cross"].valid))
        _close(tnode["cross"].k, jnode["cross"].k, "cross k")
        assert tnode["cross"].k.shape[-2] == 16
        _close(tl, jl, f"logits at step {step}")
        if step == 3:
            break
        jn, tn = jnp.argmax(jl, -1), tl.argmax(-1)
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
        jl, jc, _ = jdecode(jparams, jn, jc)
        tl, tc, _ = TI.decode_step(tparams, tcfg, tn, tc)
    assert int(tc["t"][0]) == 32 + 3
    assert rec.margin() >= TAU_MARGIN


def test_decode_caches_match_reference_shapes():
    """``build_decode_caches`` for an encoder of 48 positions: WG-KV keeps
    ``global_budget(48)`` cross slots, the dense baseline all 48."""
    from repro.launch import specs as JS
    from repro_torch.launch import specs as TS
    jcfg, _, tcfg, _, _ = _setup()
    for use_wgkv in (True, False):
        j = JS.build_decode_caches(jcfg, 2, 64, use_wgkv=use_wgkv,
                                   s_enc=S_ENC)
        t = TS.build_decode_caches(tcfg, 2, 64, use_wgkv=use_wgkv,
                                   s_enc=S_ENC, device="cpu")
        jn, tn = j["blocks"]["b0"], t["blocks"]["b0"]
        for f in ("k", "v", "valid"):
            assert tuple(getattr(tn["cross"], f).shape) == \
                getattr(jn["cross"], f).shape
        if use_wgkv:
            assert tuple(tn["self"].gk.shape) == jn["self"].gk.shape


# ==========================================================================
# gate distillation
# ==========================================================================
def test_train_step_matches_reference():
    """One gate-distillation step on B 2 x 48 decoder tokens (past the
    16-token window) with ``enc_embeds`` in the batch: loss, aux and
    every gate gradient (the self-attention gates train; the cross gates
    get no gradient in training, as in the reference) against
    ``jax.value_and_grad``."""
    jcfg, jparams, tcfg, tparams, _ = _setup()
    (toks, _), = _batches(tcfg.vocab_size, 7, 1, s=48)
    enc = _frames(10, 2, S_ENC, tcfg.d_model)
    jbatch = {"tokens": jnp.asarray(toks), "loss_mask": None,
              "enc_embeds": jnp.asarray(enc)}
    tbatch = {"tokens": torch.from_numpy(toks), "loss_mask": None,
              "enc_embeds": torch.from_numpy(enc)}
    (jloss, jaux), jgrads = _ref_value_and_grad(jcfg, 0.3)(
        JTR.get_gates(jparams), jparams, jbatch)
    tloss, taux, tgrads = TTR.loss_and_grads(
        TTR.get_gates(tparams), tparams, tcfg, tbatch, lam=0.3)
    _rel_close(tloss, jloss)
    assert set(taux) == set(jaux)
    for k in jaux:
        _rel_close(taux[k], jaux[k])
    assert float(taux["distill"]) > 0
    assert sorted(tgrads) == sorted(jgrads)
    for k in jgrads:
        _max_close(tgrads[k].numpy(), np.asarray(jgrads[k]))
    assert float(tgrads["blocks/b0/attn/gate/w1"].abs().max()) > 0
