"""The port's dense archs smollm-360m, phi4-mini-3.8b and phi3-medium-14b
against the reference on the CPU.

The three are plain ``("attn",)`` RMSNorm decoders without qk_norm. Their
reduced configs bring the port's first odd GQA groups and head dims:
smollm-360m's 3 query heads on 1 kv head at hd 80 (gate F 160), phi4-mini's
and phi3-medium's 4 on 2 at hd 64; phi3-medium keeps its untied output
head (``unembed``). Full configs: smollm-360m G 3 at hd 64, phi4-mini G 3
at hd 128, phi3-medium G 4 at hd 128.

Covered: the configs field by field and their parameter counts (the
MoE archs granite-moe-3b-a800m and qwen3-moe-235b-a22b too, whose
parity tests are ``tests/test_torch_moe.py``; the trees built on the meta
device, full size included), the registry's ``all_configs`` / ``shape_applicable`` / ``SHAPES``, and on the
reduced configs (``conftest.make_cfg``: f32, W 16) with one set of weights
(the reference's init, the gate weights clustered per head clear of tau,
carried over by ``params_from_numpy``): the gated and teacher forward,
``prefill`` then greedy decode, and one ``train_step``'s loss, aux and
gate gradients (``tests/test_torch_training.py``'s limits).

Tolerances: forward and prefill/decode floats (logits, hidden, gates, cache
floats) 5e-5 absolute and relative (float32 sums in other orders over two
layers); greedy tokens and integer cache state EXACT; training as in
``tests/test_torch_training.py`` (losses and aux 1e-5 relative, gate
gradients 1e-5 of each reference gradient's largest magnitude).
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
from repro.training import trainer as JTR
from repro_torch import configs as TC
from repro_torch.convert import params_from_numpy
from repro_torch.models import inference as TI
from repro_torch.models import registry as TREG
from repro_torch.models import transformer as TT
from repro_torch.training import trainer as TTR
from test_torch_prefill import (INT_FIELDS, GateRecorder, _margin,
                                cluster_gate)
from test_torch_support import port_cfg
from test_torch_training import (_batches, _max_close, _rel_close,
                                 _ref_value_and_grad, _tbatch, _jbatch)

torch.set_num_threads(2)

ARCHS = ("smollm-360m", "phi4-mini-3.8b", "phi3-medium-14b")
MOE_ARCHS = ("granite-moe-3b-a800m", "qwen3-moe-235b-a22b")
# parity tests in tests/test_torch_{xlstm,whisper,vlm}.py
NEW_ARCHS = ("xlstm-350m", "whisper-medium", "qwen2-vl-7b")
TOL = 5e-5
TAU_MARGIN = 1e-3


# ==========================================================================
# configs and the registry
# ==========================================================================
@pytest.mark.parametrize("arch", ARCHS + MOE_ARCHS)
@pytest.mark.parametrize("reduced", [False, True])
def test_config_matches_reference(arch, reduced):
    """Field by field; the analytic counts (total and active) equal the
    reference's and the count of the port's tree (on the meta device)."""
    jget = JC.get_reduced_config if reduced else JC.get_config
    tget = TC.get_reduced_config if reduced else TC.get_config
    j, t = jget(arch), tget(arch)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    if arch in MOE_ARCHS:
        assert t.block_pattern == ("attn_moe",) and t.moe is not None
        assert t.active_param_count() < t.param_count()
    else:
        assert t.block_pattern == ("attn",) and not t.qk_norm
    assert t.param_count() == j.param_count()
    assert t.active_param_count() == j.active_param_count()
    assert t.n_layers == j.n_layers and t.wgkv_applicable()
    tree = TT.init_model(t, torch.Generator(), "meta")
    assert TREG.count_params_tree(tree) == t.param_count()


def test_the_port_registers_five_archs():
    """Five archs until the MoE slice added two and the xLSTM / whisper /
    VLM slice the last three: all ten of the reference's."""
    assert TC.ARCH_NAMES == ("qwen3-0.6b", "recurrentgemma-9b", *ARCHS,
                             *MOE_ARCHS, *NEW_ARCHS)
    assert set(TC.ARCH_NAMES) == set(JC.ARCH_NAMES)
    with pytest.raises(KeyError):
        TC.get_config("xlstm-1b")
    with pytest.raises(KeyError):
        TC.get_reduced_config("whisper-large")


@pytest.mark.parametrize("arch", ("qwen3-0.6b", "recurrentgemma-9b") + ARCHS
                         + MOE_ARCHS + NEW_ARCHS)
def test_registry_answers_as_the_reference(arch):
    tall, jall = TC.all_configs(), JC.all_configs()
    assert list(tall) == list(TC.ARCH_NAMES)
    assert dataclasses.asdict(tall[arch]) == dataclasses.asdict(jall[arch])
    assert sorted(TC.SHAPES) == sorted(JC.SHAPES)
    for name, jshape in JC.SHAPES.items():
        tshape = TC.get_shape(name)
        assert dataclasses.asdict(tshape) == dataclasses.asdict(jshape)
        assert TC.shape_applicable(tall[arch], tshape) == \
            JC.shape_applicable(jall[arch], jshape)


# ==========================================================================
# the reduced configs against the reference
# ==========================================================================
@functools.lru_cache(maxsize=None)
def _setup(arch):
    """(jax cfg, jax params, port cfg, port params): the reference's init
    of the reduced config (W 16) with gate weights clustered per head."""
    jcfg = make_cfg(arch)
    params_np = jax.tree.map(np.asarray,
                             JT.init_model(jax.random.PRNGKey(0), jcfg))
    params_np = cluster_gate(params_np, 100)
    tcfg = port_cfg(jcfg)
    return (jcfg, jax.tree.map(jnp.asarray, params_np), tcfg,
            params_from_numpy(params_np, tcfg, "cpu"))


def _close(got, want, msg=""):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL, err_msg=msg)


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_shapes(arch):
    _, jparams, tcfg, tparams = _setup(arch)
    groups = {"smollm-360m": (3, 80), "phi4-mini-3.8b": (2, 64),
              "phi3-medium-14b": (2, 64)}[arch]
    assert (tcfg.n_heads // tcfg.n_kv_heads, tcfg.head_dim) == groups
    gate = tparams["blocks"]["b0"]["attn"]["gate"]
    assert tuple(gate["w1"].shape[2:]) == (2 * tcfg.head_dim, 32)
    # phi3-medium's output head is its own matrix; the others tie it
    assert ("unembed" in tparams["embed"]) == (arch == "phi3-medium-14b")
    assert ("unembed" in jparams["embed"]) == (arch == "phi3-medium-14b")


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mode", ["gated", "teacher"])
def test_forward_matches(arch, mode):
    jcfg, jparams, tcfg, tparams = _setup(arch)
    toks = np.random.default_rng(7).integers(0, tcfg.vocab_size, (2, 64))
    jo = JT.forward(jparams, jcfg, jnp.asarray(toks, jnp.int32), mode=mode)
    to = TT.forward(tparams, tcfg, torch.from_numpy(toks), mode=mode)
    _close(to.logits, jo.logits, "logits")
    _close(to.hidden, jo.hidden, "hidden")
    if mode == "gated":
        assert tuple(to.gates.shape) == (tcfg.n_layers, 2, tcfg.n_kv_heads,
                                         64)
        _close(to.gates, jo.gates, "gates")
        assert _margin(jo.gates) >= TAU_MARGIN
    else:
        assert to.gates is None


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_matches(arch, monkeypatch):
    """B 2, S 96 past the 16-token ring, budget 32 (cut for the admitting
    heads), then 6 greedy steps, each package feeding its own argmax."""
    jcfg, jparams, tcfg, tparams = _setup(arch)
    rec = GateRecorder(monkeypatch)
    toks = np.random.default_rng(8).integers(0, tcfg.vocab_size, (2, 96))
    jout, jc = jax.jit(lambda p, t: JI.prefill(p, jcfg, t, budget=32))(
        jparams, jnp.asarray(toks, jnp.int32))
    tout, tc = TI.prefill(tparams, tcfg, torch.from_numpy(toks), budget=32)
    jdecode = jax.jit(lambda p, t, c: JI.decode_step(p, jcfg, t, c))
    jl, tl = jout.logits, tout.logits
    _close(tl, jl, "prefill logits")
    assert float(tout.mean_admission) == pytest.approx(
        float(jout.mean_admission), abs=1e-6)
    for step in range(7):
        jnode, tnode = jc["blocks"]["b0"], tc["blocks"]["b0"]
        np.testing.assert_array_equal(tc["t"].numpy(), np.asarray(jc["t"]))
        for name in tnode._fields:
            got, want = getattr(tnode, name).numpy(), np.asarray(
                getattr(jnode, name))
            assert got.shape == want.shape, name
            if name in INT_FIELDS:
                np.testing.assert_array_equal(got, want, err_msg=name)
            else:
                np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL,
                                           err_msg=f"{name} at {step}")
        if step == 6:
            break
        jn, tn = jnp.argmax(jl, -1), tl.argmax(-1)
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
        jl, jc, _ = jdecode(jparams, jn, jc)
        tl, tc, _ = TI.decode_step(tparams, tcfg, tn, tc)
        _close(tl, jl, f"logits at step {step}")
    assert rec.margin() >= TAU_MARGIN
    gcnt = tc["blocks"]["b0"].gcnt.numpy()
    # admitting heads reach the budget, rejecting ones keep their sinks
    assert gcnt.max() == 32 and gcnt.min() == tcfg.wgkv.sink
    assert int(tc["t"][0]) == 96 + 6


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch):
    """One step of gate distillation, B 2 x 64 tokens past the 16-token
    window: the loss, aux and every gate gradient against the
    reference's ``jax.value_and_grad``; then ``train_step`` reports them
    and takes one optimizer step."""
    jcfg, jparams, tcfg, tparams = _setup(arch)
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
