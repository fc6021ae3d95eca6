"""The port's VLM (qwen2-vl-7b: an ``("attn",)`` decoder with M-RoPE,
its vision frontend a stub of patch embeddings) against the reference on
the CPU.

Reduced qwen2-vl-7b (d 256, 4 / 2 heads of hd 64, two layers;
``conftest.make_cfg``: f32, W 16), the reference's init with the gates
clustered per head clear of tau, carried over by ``params_from_numpy``;
patch embeddings and tokens drawn with numpy from a seed.

Tolerances: ``build_vlm_embeds`` (the scattered embeddings and the (t, h,
w) ids), greedy tokens and integer cache state exact; ``apply_mrope``
1e-6 absolute (the two libraries' sin and cos differ by an ulp, see its
test); forward and prefill floats 5e-5 absolute and relative.
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
from repro.models import layers as JL
from repro.models import registry as JREG
from repro.models import transformer as JT
from repro.serving.backend import make_backend as jax_make_backend
from repro.serving.orchestrator import SchedulerConfig as JSched
from repro.serving.orchestrator import ServeSession as JSession
from repro_torch import configs as TC
from repro_torch.convert import params_from_numpy
from repro_torch.models import inference as TI
from repro_torch.models import layers as TL
from repro_torch.models import registry as TREG
from repro_torch.models import transformer as TT
from repro_torch.serving.backend import make_backend as torch_make_backend
from repro_torch.serving.orchestrator import SchedulerConfig as TSched
from repro_torch.serving.orchestrator import ServeSession as TSession
from test_torch_prefill import INT_FIELDS, GateRecorder, cluster_gate
from test_torch_support import port_cfg

torch.set_num_threads(2)

ARCH = "qwen2-vl-7b"
TOL = 5e-5
TAU_MARGIN = 1e-3


@functools.lru_cache(maxsize=None)
def _setup():
    """(jax cfg, jax params, port cfg, port params)."""
    jcfg = make_cfg(ARCH)
    init = jax.jit(JT.init_model, static_argnums=1)
    params_np = jax.tree.map(np.asarray, init(jax.random.PRNGKey(0), jcfg))
    params_np = cluster_gate(params_np, 100)
    tcfg = port_cfg(jcfg)
    return (jcfg, jax.tree.map(jnp.asarray, params_np), tcfg,
            params_from_numpy(params_np, tcfg, "cpu"))


def _close(got, want, msg=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=TOL, rtol=TOL, err_msg=msg)


def _vlm_inputs(seed, b, s, grid, d, vocab):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (b, s)).astype(np.int32)
    patches = rng.standard_normal((b, grid[0] * grid[1], d)).astype(
        np.float32) * 0.02
    return toks, patches


def _embeds(grid, seed=1, b=2, s=48):
    """Both packages' ``build_vlm_embeds`` of one numpy draw."""
    jcfg, jparams, tcfg, tparams = _setup()
    toks, patches = _vlm_inputs(seed, b, s, grid, tcfg.d_model,
                                tcfg.vocab_size)
    je, jp = JREG.build_vlm_embeds(jparams, jcfg, jnp.asarray(toks),
                                   jnp.asarray(patches), grid)
    te, tp = TREG.build_vlm_embeds(tparams, tcfg, torch.from_numpy(toks),
                                   torch.from_numpy(patches), grid)
    return je, jp, te, tp


@pytest.mark.parametrize("reduced", [False, True])
def test_config_and_tree_count(reduced):
    jget = JC.get_reduced_config if reduced else JC.get_config
    tget = TC.get_reduced_config if reduced else TC.get_config
    j, t = jget(ARCH), tget(ARCH)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.mrope and not t.tie_embeddings
    assert t.param_count() == j.param_count()
    tree = TT.init_model(t, torch.Generator(), "meta")
    assert TREG.count_params_tree(tree) == t.param_count()


@pytest.mark.parametrize("hd", [64, 128])
def test_apply_mrope_matches(hd):
    """[2, 3, 20, hd] against the reference with ids that differ per
    stream (vision-like t, h, w), at hd 64 (sections 8 / 12 / 12) and hd
    128 (the full config's 16 / 24 / 24). The sections and the angles are
    the reference's exactly, but XLA's and PyTorch's sin and cos on the
    CPU differ by up to an ulp (6e-8 at 1), which the rotation carries
    into about 3% of the outputs: held at 1e-6 absolute, under the 5e-5
    of every other float here and 50x the largest difference seen
    (2.4e-7)."""
    assert TL.mrope_sections(hd) == JL.mrope_sections(hd)
    rng = np.random.default_rng(hd)
    x = rng.standard_normal((2, 3, 20, hd)).astype(np.float32)
    pos = rng.integers(0, 300, (3, 2, 1, 20)).astype(np.int32)
    j = JL.apply_mrope(jnp.asarray(x), jnp.asarray(pos), 1e6)
    t = TL.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), 1e6)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-6, rtol=0)


@pytest.mark.parametrize("grid", [(4, 4), (3, 5)])
def test_build_vlm_embeds_matches(grid):
    """The patches in the leading slots, the token embeddings after
    them, and (t, h, w) = (0, row, col) then text ids from max(gh, gw):
    exact."""
    je, jp, te, tp = _embeds(grid)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    assert tuple(tp.shape) == (3, 2, 48) and tp.dtype == torch.int32


@pytest.mark.parametrize("mode", ["teacher", "gated", "hard"])
def test_forward_from_embeds_matches(mode):
    """B 2, S 48 whose first 16 slots are patches of a 4 x 4 grid, roped
    by M-RoPE positions [3, B, S]: hidden, logits and gates at 5e-5."""
    jcfg, jparams, tcfg, tparams = _setup()
    je, jp, te, tp = _embeds((4, 4), seed=2)
    j = JT.forward(jparams, jcfg, embeds=je, positions=jp, mode=mode)
    t = TT.forward(tparams, tcfg, embeds=te, positions=tp, mode=mode)
    _close(t.hidden, j.hidden, "hidden")
    _close(t.logits, j.logits, "logits")
    if mode != "teacher":
        _close(t.gates, j.gates, "gates")


def test_prefill_from_embeds_then_decode_matches(monkeypatch):
    """The M-RoPE prefill of a 48-slot VLM stream at budget 16, then 3
    greedy steps roped at the row's ``t`` (the reference's text decode):
    tokens and integer cache state exact, floats at 5e-5."""
    jcfg, jparams, tcfg, tparams = _setup()
    rec = GateRecorder(monkeypatch)
    je, jp, te, tp = _embeds((4, 4), seed=3)
    jout, jc = JI.prefill(jparams, jcfg, embeds=je, positions=jp, budget=16)
    tout, tc = TI.prefill(tparams, tcfg, embeds=te, positions=tp, budget=16)
    jdecode = jax.jit(lambda p, t, c: JI.decode_step(p, jcfg, t, c))
    jl, tl = jout.logits, tout.logits
    for step in range(4):
        jnode, tnode = jc["blocks"]["b0"], tc["blocks"]["b0"]
        for name in tnode._fields:
            got = getattr(tnode, name).numpy()
            want = np.asarray(getattr(jnode, name))
            if name in INT_FIELDS:
                np.testing.assert_array_equal(got, want, err_msg=name)
            else:
                np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL,
                                           err_msg=f"{name} at {step}")
        _close(tl, jl, f"logits at step {step}")
        if step == 3:
            break
        jn, tn = jnp.argmax(jl, -1), tl.argmax(-1)
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
        jl, jc, _ = jdecode(jparams, jn, jc)
        tl, tc, _ = TI.decode_step(tparams, tcfg, tn, tc)
    assert rec.margin() >= TAU_MARGIN


def test_text_serve_matches_reference_engine():
    """qwen2-vl serves text only, as in the reference: three ragged
    prompts through the ``wgkv`` backend on 2 slots, streams identical to
    the reference Engine's."""
    jcfg, jparams, tcfg, tparams = _setup()
    rng = np.random.default_rng(12)
    prompts = [rng.integers(0, 500, n).tolist() for n in (21, 9, 30)]

    def serve(session):
        hs = [session.submit(p, max_new=5) for p in prompts]
        session.run()
        session.close()
        return [h.tokens() for h in hs]

    kw = dict(slots=2, capacity=64, pool_pages=512)
    jeng = jax_make_backend("wgkv", jparams, jcfg, **kw)
    teng = torch_make_backend("wgkv", tparams, tcfg, device="cpu", **kw)
    want = serve(JSession(jeng, sched=JSched(chunk_tokens=16)))
    got = serve(TSession(teng, sched=TSched(chunk_tokens=16)))
    assert got == want and all(len(s) == 5 for s in got)
