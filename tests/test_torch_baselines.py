"""The port's baselines vs the reference on the CPU, with one set of
weights: the static admission gates, the dense full-attention baseline
(prefill, cache, decode), the offline prefill and decode under the
StreamingLLM and DuoAttention policies, and the three baseline serving
backends on the trained bench substrate.

Tolerances: floats (one attention, and logits and K/V after several
layers and steps) 5e-5 absolute in float32. Gates, integer cache state,
greedy tokens and memory counts are EXACT. The port's dense buffer is rounded up to a whole 16-token page, so
dense K/V are compared on their first ``t`` tokens.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import baselines as JBL
from repro.models import attention as JA
from repro.models import inference as JI
from repro.serving.backend import make_backend as jax_make_backend
from repro.serving.orchestrator import SchedulerConfig as JSched
from repro.serving.orchestrator import ServeSession as JSession
from repro.training import checkpoint as JCK
from repro.models import transformer as JT
from repro.configs.base import ModelConfig as JModelConfig
from repro.configs.base import WGKVConfig as JWGKVConfig
from repro_torch.configs.base import ModelConfig as TModelConfig
from repro_torch.configs.base import WGKVConfig as TWGKVConfig
from repro_torch.convert import params_from_numpy
from repro_torch.core import baselines as TBL
from repro_torch.kernels import ops as tops
from repro_torch.launch import serve as TSERVE
from repro_torch.models import attention as TA
from repro_torch.models import inference as TI
from repro_torch.serving.backend import make_backend as torch_make_backend
from repro_torch.serving.orchestrator import SchedulerConfig as TSched
from repro_torch.serving.orchestrator import ServeSession as TSession
from test_torch_prefill import SUBSTRATE, _assert_cache_close, _substrate_cfg
from test_torch_support import parity_setup

torch.set_num_threads(2)

POLICIES = ("streaming_llm", "duo")


@pytest.fixture(scope="module")
def setup():
    return parity_setup(seed=4)


def _layer0_attn(jparams, tparams):
    jp = jax.tree.map(lambda x: x[0], jparams["blocks"]["b0"]["attn"])
    tp = {k: v[0] for k, v in tparams["blocks"]["b0"]["attn"].items()
          if torch.is_tensor(v)}
    return jp, tp


def _assert_dense_close(jc, tc, *, ftol):
    """Stacked DenseCache [R, B, H, S, hd]: t exact, K/V on [:t]."""
    t = np.asarray(jc.t)
    np.testing.assert_array_equal(tc.t.numpy(), t)
    assert tc.t.dtype == torch.int32
    assert tc.k.shape[-2] % 16 == 0 and tc.k.shape[-2] >= jc.k.shape[-2]
    for r in range(t.shape[0]):
        for b in range(t.shape[1]):
            n = int(t[r, b])
            for name in ("k", "v"):
                np.testing.assert_allclose(
                    getattr(tc, name)[r, b, :, :n].numpy(),
                    np.asarray(getattr(jc, name))[r, b, :, :n],
                    atol=ftol, rtol=0, err_msg=f"{name} r{r} b{b}")


def _forbid_gate(monkeypatch):
    def boom(*a, **kw):
        raise AssertionError("the write gate ran under a static policy")
    monkeypatch.setattr(tops, "write_gate", boom)


# ==========================================================================
# static gates
# ==========================================================================
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("shape", [(3,), (2, 40)])
def test_gates_from_positions_match(policy, shape):
    pos = np.random.default_rng(1).integers(0, 40, shape).astype(np.int32)
    pos.flat[0], pos.flat[-1] = 3, 39       # a sink and a non-sink
    want = JBL.gates_from_positions(policy, jnp.asarray(pos), 4, sink=16,
                                    retrieval_heads=(1, 3))
    got = TBL.gates_from_positions(policy, torch.from_numpy(pos), 4,
                                   sink=16, retrieval_heads=(1, 3))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < float(got.mean()) < 1
    with pytest.raises(ValueError, match="unknown static admission"):
        TBL.gates_from_positions("bogus", torch.from_numpy(pos), 4, sink=1)


def test_static_gate_grids_match():
    retr = np.array([True, False, False, True])
    np.testing.assert_array_equal(
        TBL.local_attention_gates(2, 4, 40, sink=8).numpy(),
        np.asarray(JBL.local_attention_gates(2, 4, 40, sink=8)))
    np.testing.assert_array_equal(
        TBL.duo_attention_gates(2, torch.from_numpy(retr), 40,
                                sink=8).numpy(),
        np.asarray(JBL.duo_attention_gates(2, jnp.asarray(retr), 40,
                                           sink=8)))
    np.testing.assert_array_equal(
        TBL.full_attention_gates(2, 4, 40).numpy(),
        np.asarray(JBL.full_attention_gates(2, 4, 40)))
    scores = np.random.default_rng(2).uniform(0, 1, (2, 8, 30)).astype(
        np.float32)
    for ratio in (0.1, 0.25, 0.5):
        np.testing.assert_array_equal(
            TBL.identify_retrieval_heads(torch.from_numpy(scores),
                                         ratio).numpy(),
            np.asarray(JBL.identify_retrieval_heads(jnp.asarray(scores),
                                                    ratio)))


# ==========================================================================
# the dense full-attention baseline
# ==========================================================================
@pytest.mark.parametrize("window", [None, 16])
def test_attn_prefill_full_matches(setup, window):
    jcfg, jparams, tcfg, tparams = setup
    jp, tp = _layer0_attn(jparams, tparams)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 48, tcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(48, dtype=np.int32), (2, 48)).copy()
    jo = JA.attn_prefill_full(jp, jcfg, jnp.asarray(x), jnp.asarray(pos),
                              window=window)
    to = TA.attn_prefill_full(tp, tcfg, torch.from_numpy(x),
                              torch.from_numpy(pos), window=window)
    for a, b in zip(to, jo):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=5e-5,
                                   rtol=0)


@pytest.mark.parametrize("window", [None, 16])
def test_attn_decode_dense_matches(setup, window):
    """An unaligned buffer (37 slots; the port's holds 48) with rows at t
    0, 1 and 36 (the append fills the last slot)."""
    jcfg, jparams, tcfg, tparams = setup
    jp, tp = _layer0_attn(jparams, tparams)
    rng = np.random.default_rng(5)
    b, h, hd, s = 3, tcfg.n_kv_heads, tcfg.head_dim, 37
    k = rng.standard_normal((b, h, s, hd)).astype(np.float32)
    v = rng.standard_normal((b, h, s, hd)).astype(np.float32)
    t = np.array([0, 1, s - 1], np.int32)
    for i, n in enumerate(t):           # slots past t are never read
        k[i, :, n:] = 0.0
        v[i, :, n:] = 0.0
    jc = JA.DenseCache(jnp.asarray(k), jnp.asarray(v), jnp.asarray(t))
    tc = TA.init_dense_cache(b, h, hd, s)
    assert tc.k.shape[2] == 48
    tc.k[:, :, :s] = torch.from_numpy(k)
    tc.v[:, :, :s] = torch.from_numpy(v)
    tc.t.copy_(torch.from_numpy(t))
    x = rng.standard_normal((b, tcfg.d_model)).astype(np.float32)
    jy, jn = JA.attn_decode_dense(jp, jcfg, jnp.asarray(x), jc,
                                  window=window)
    ty, tn = TA.attn_decode_dense(tp, tcfg, torch.from_numpy(x), tc,
                                  window=window)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=5e-5, rtol=0)
    np.testing.assert_array_equal(tn.t.numpy(), t + 1)
    for i, n in enumerate(t + 1):
        np.testing.assert_allclose(tn.k[i, :, :n].numpy(),
                                   np.asarray(jn.k)[i, :, :n], atol=5e-5)
        np.testing.assert_allclose(tn.v[i, :, :n].numpy(),
                                   np.asarray(jn.v)[i, :, :n], atol=5e-5)
    # functional: the input cache is untouched; a full buffer raises
    assert tc.t.tolist() == t.tolist()
    full = TA.DenseCache(tc.k, tc.v, torch.full((b,), 48, dtype=torch.int32))
    with pytest.raises(IndexError):
        TA.dense_cache_append(full, tn.k[:, :, 0], tn.v[:, :, 0])


def test_prefill_dense_then_decode_matches(setup):
    """``prefill(use_wgkv=False)`` (causal attention into a dense cache of
    S + 64 = 104 slots, 112 in the port), then 6 greedy dense decode
    steps: logits, tokens, t and K/V on [:t]."""
    jcfg, jparams, tcfg, tparams = setup
    toks = np.random.default_rng(6).integers(0, tcfg.vocab_size, (2, 40))
    jout, jc = JI.prefill(jparams, jcfg, jnp.asarray(toks, jnp.int32),
                          use_wgkv=False)
    tout, tc = TI.prefill(tparams, tcfg, torch.from_numpy(toks),
                          use_wgkv=False)
    assert tc["blocks"]["b0"].k.shape[-2] == 112
    np.testing.assert_allclose(tout.logits.numpy(), np.asarray(jout.logits),
                               atol=5e-5, rtol=0)
    assert float(tout.mean_admission) == float(jout.mean_admission) == 0.0
    _assert_dense_close(jc["blocks"]["b0"], tc["blocks"]["b0"], ftol=5e-5)
    jdecode = jax.jit(lambda p, t, c: JI.decode_step(p, jcfg, t, c))
    jl, tl = jout.logits, tout.logits
    for _ in range(6):
        jn, tn = jnp.argmax(jl, -1), tl.argmax(-1)
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
        jl, jc, _ = jdecode(jparams, jn, jc)
        tl, tc, _ = TI.decode_step(tparams, tcfg, tn, tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=5e-5,
                                   rtol=0)
        _assert_dense_close(jc["blocks"]["b0"], tc["blocks"]["b0"],
                            ftol=5e-5)
    assert tc["t"].tolist() == [46, 46]
    with pytest.raises(ValueError, match="max_len"):
        TI.prefill(tparams, tcfg, torch.from_numpy(toks), use_wgkv=False,
                   max_len=20)


# ==========================================================================
# the offline prefill and decode under a static policy
# ==========================================================================
@pytest.mark.parametrize("policy", POLICIES)
def test_static_prefill_then_decode_matches(setup, policy, monkeypatch):
    """Budgeted prefill of 64 tokens and 6 greedy decode steps under the
    policy (sink 5, duo's retrieval head 1): no gate runs, and the dual
    cache's integer state is exact after the prefill and every step."""
    jcfg, jparams, tcfg, tparams = setup
    _forbid_gate(monkeypatch)
    kw = dict(admission_policy=policy, admission_sink=5,
              duo_retrieval_heads=(1,) if policy == "duo" else ())
    jopts, topts = JI.DecodeOptions(**kw), TI.DecodeOptions(**kw)
    toks = np.random.default_rng(7).integers(0, tcfg.vocab_size, (2, 64))
    jout, jc = JI.prefill(jparams, jcfg, jnp.asarray(toks, jnp.int32),
                          opts=jopts)
    tout, tc = TI.prefill(tparams, tcfg, torch.from_numpy(toks), opts=topts)
    np.testing.assert_allclose(tout.logits.numpy(), np.asarray(jout.logits),
                               atol=5e-5, rtol=0)
    assert float(tout.mean_admission) == pytest.approx(
        float(jout.mean_admission), abs=1e-7)
    _assert_cache_close(jc["blocks"]["b0"], tc["blocks"]["b0"], ftol=5e-5)
    gcnt = tc["blocks"]["b0"].gcnt
    if policy == "duo":        # head 1 admits all 48 pre-window tokens
        assert gcnt[:, :, 1].tolist() == [[48, 48]] * tcfg.n_repeats
        assert gcnt[:, :, 0].tolist() == [[5, 5]] * tcfg.n_repeats
    else:
        assert gcnt.unique().tolist() == [5]
    jdecode = jax.jit(lambda p, t, c: JI.decode_step(p, jcfg, t, c,
                                                     opts=jopts))
    jl, tl = jout.logits, tout.logits
    for _ in range(6):
        jn, tn = jnp.argmax(jl, -1), tl.argmax(-1)
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
        jl, jc, jst = jdecode(jparams, jn, jc)
        tl, tc, tst = TI.decode_step(tparams, tcfg, tn, tc, opts=topts)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=5e-5,
                                   rtol=0)
        np.testing.assert_array_equal(tst["mean_admission"].numpy(),
                                      np.asarray(jst["mean_admission"]))
        _assert_cache_close(jc["blocks"]["b0"], tc["blocks"]["b0"],
                            ftol=5e-5)


def test_decode_options_check_the_policy():
    assert TI.DecodeOptions(admission_policy="duo").admission_sink == 16
    with pytest.raises(ValueError, match="admission_policy"):
        TI.DecodeOptions(admission_policy="h2o")


# ==========================================================================
# the baseline serving backends on the trained substrate
# ==========================================================================
@pytest.fixture(scope="module")
def substrate():
    jcfg = _substrate_cfg((JModelConfig, JWGKVConfig))
    tcfg = _substrate_cfg((TModelConfig, TWGKVConfig))
    jparams = JCK.restore(str(SUBSTRATE),
                          JT.init_model(jax.random.PRNGKey(0), jcfg))
    return jcfg, jparams, tcfg, params_from_numpy(SUBSTRATE, tcfg, "cpu")


def _serve_recorded(session, eng, prompts, max_new, verify=None):
    """Serve ``prompts``; after every tick record the memory snapshot's
    KV tokens (and pool pages when paged). Returns (streams, per-tick
    records)."""
    handles = [session.submit(p, max_new=max_new) for p in prompts]
    rec = []
    for _ in range(500):
        if not session.tick():
            break
        session.orchestrator.drain()
        snap = eng.memory_snapshot()
        rec.append((snap["kv_tokens"], snap.get("pool_pages")))
        if verify is not None and any(eng.live):
            verify.append(eng.verify_paged())
    session.run()
    session.close()
    return [h.tokens() for h in handles], rec


@pytest.mark.parametrize("name", ["dense", "streaming_llm", "duo"])
def test_baseline_engines_match_reference(substrate, name):
    """Three numpy prompts (one past the 16-token ring and the 32-token
    chunk) through ``ServeSession`` over each backend in both packages:
    identical greedy streams and, tick by tick, identical resident KV
    tokens and pool pages; the paged backends' pool within 2e-3."""
    jcfg, jparams, tcfg, tparams = substrate
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, 256, n).tolist() for n in (70, 23, 41)]
    kw = dict(slots=2, capacity=128, pool_pages=512)
    jeng = jax_make_backend(name, jparams, jcfg, **kw)
    teng = torch_make_backend(name, tparams, tcfg, device="cpu", **kw)
    assert (dataclasses.asdict(teng.capabilities())
            == dataclasses.asdict(jeng.capabilities()))
    dev = []
    jres = _serve_recorded(JSession(jeng, sched=JSched(chunk_tokens=32)),
                           jeng, prompts, 8)
    tres = _serve_recorded(TSession(teng, sched=TSched(chunk_tokens=32)),
                           teng, prompts, 8,
                           dev if teng.capabilities().paged else None)
    assert tres[0] == jres[0]
    assert all(len(s) == 8 for s in tres[0])
    assert tres[1] == jres[1]
    assert max(k for k, _ in tres[1]) > 0
    if teng.capabilities().paged:
        assert dev and max(dev) < 2e-3
        assert teng.pool.pages_in_use == 0


def test_dense_row_at_capacity_beside_live_rows(substrate):
    """Capacity 64 (a whole number of pages, so the port's buffer is the
    reference's size): request 0 ends at exactly ``t == 64`` while other
    rows prefill and decode beside it, before and after its slot is
    freed. Its masked positions and its retired row keep being stepped;
    both packages serve identical streams and KV counts."""
    jcfg, jparams, tcfg, tparams = substrate
    rng = np.random.default_rng(12)
    reqs = [(49, 16), (8, 3), (40, 12), (30, 10)]
    prompts = [rng.integers(0, 256, n).tolist() for n, _ in reqs]

    def serve(session, eng):
        hs = [session.submit(p, max_new=m) for p, (_, m) in zip(prompts,
                                                                 reqs)]
        rec = []
        for _ in range(500):
            if not session.tick():
                break
            session.orchestrator.drain()
            rec.append(eng.memory_snapshot()["kv_tokens"])
        session.run()
        session.close()
        return [h.tokens() for h in hs], rec

    kw = dict(slots=2, capacity=64)
    jeng = jax_make_backend("dense", jparams, jcfg, **kw)
    teng = torch_make_backend("dense", tparams, tcfg, device="cpu", **kw)
    jres = serve(JSession(jeng, sched=JSched(chunk_tokens=16)), jeng)
    tres = serve(TSession(teng, sched=TSched(chunk_tokens=16)), teng)
    assert [len(s) for s in tres[0]] == [m for _, m in reqs]
    assert tres == jres


def test_dense_capacity_and_selection_guards(substrate):
    _, _, tcfg, tparams = substrate
    eng = torch_make_backend("dense", tparams, tcfg, slots=1, capacity=48,
                             device="cpu")
    with pytest.raises(ValueError, match="capacity"):
        eng.start_prefill(list(range(48)))
    sess = TSession(eng, sched=TSched(chunk_tokens=16))
    sess.submit(list(range(40)), max_new=20)
    with pytest.raises(RuntimeError, match="dense cache overflow"):
        sess.run()
    with pytest.raises(ValueError, match="selection_policy"):
        torch_make_backend("dense", tparams, tcfg, selection="quest:2",
                           device="cpu")
    # a mesh serves GQA attention, MoE and RG-LRU archs; an xLSTM arch on
    # a mesh raises before its weights are read
    # (tests/test_torch_sharded_serving.py and test_torch_mesh_archs.py
    # serve the supported ones)
    from repro_torch.configs import get_reduced_config
    with pytest.raises(NotImplementedError, match="mesh"):
        torch_make_backend("dense", {}, get_reduced_config(
            "xlstm-350m"), mesh=object(), device="cpu")
    with pytest.raises(TypeError, match="pool_page"):    # a misspelt option
        torch_make_backend("dense", tparams, tcfg, pool_page=64,
                           device="cpu")


@pytest.mark.parametrize("backend", ["dense", "streaming_llm", "duo"])
def test_serve_cli_baseline_backends(backend):
    """The serve CLI on the CPU with each baseline: every request returns
    its tokens; the paged static backends verify their pool."""
    res = TSERVE.main(["--arch", "qwen3-0.6b", "--reduced", "--device",
                       "cpu", "--backend", backend, "--requests", "2",
                       "--max-new", "3", "--prompt-len", "40",
                       "--quiet-stream", "--sink", "4"])
    assert [len(o) for o in res["outputs"]] == [3, 3]
    assert res["paged_dev"] < 2e-3
    assert res["summary"]["mean_admission"] is not None
