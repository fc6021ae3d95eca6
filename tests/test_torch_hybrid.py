"""The port's hybrid path vs the reference on the CPU: the reduced
recurrentgemma-9b config (RG-LRU and local-attention blocks, MQA, 64-token
sliding window) with a two-block RG-LRU stem added on both sides, so the
stem, the ``rglru`` blocks and the ``local_attn`` dual cache are all
covered. One set of weights: the reference's init carried over with
``params_from_numpy``, the write gate's weights set so that it admits
about half the tokens with scores far from tau (every test asserts a
margin >= 1e-3 from tau, so admission cannot flip on float rounding).

Covered: ``inference.prefill`` then greedy ``decode_step``s, the full
forward in its three modes (and per-attention-layer gate overrides), the
ragged extend, decode with SnapKV eviction (the observation window
indexed by the block's attention ordinal), splice/extract on the hybrid
tree, the serving Engine's streams, the parameter registry and the flat
npz stem.

Tolerances: integer cache state, greedy tokens, admission, trigger rows
and kept global entries EXACT; logits, hidden states and RGLRUState
within 2e-4 (``tests/test_archs.py``'s: float32 sums in other orders,
and the reference's associative scan, compounded over layers).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_full
from repro.configs import get_reduced_config as jax_reduced
from repro.launch import specs as JS
from repro.models import inference as JI
from repro.models import registry as JREG
from repro.models import transformer as JT
from repro.serving.backend import make_backend as jax_make_backend
from repro.serving.orchestrator import SchedulerConfig as JSched
from repro.serving.orchestrator import ServeSession as JSession
from repro.training import checkpoint as JCK
from repro_torch.configs import get_config as torch_full
from repro_torch.configs import get_reduced_config as torch_reduced
from repro_torch.convert import params_from_numpy
from repro_torch.launch import serve as TSERVE
from repro_torch.launch import specs as TS
from repro_torch.models import inference as TI
from repro_torch.models import registry as TREG
from repro_torch.models import transformer as TT
from repro_torch.serving.backend import make_backend as torch_make_backend
from repro_torch.serving.orchestrator import SchedulerConfig as TSched
from repro_torch.serving.orchestrator import ServeSession as TSession
from repro_torch.tree import tree_leaves_with_path, tree_map
from test_torch_model import _assert_tree_close
from test_torch_prefill import GateRecorder
from test_torch_support import port_cfg

torch.set_num_threads(2)

TAU_MARGIN = 1e-3
TOL = 2e-4
STEM = ("rglru", "rglru")


def hybrid_cfg(**kw):
    """The reduced recurrentgemma-9b (f32) with a two-block RG-LRU stem."""
    return jax_reduced("recurrentgemma-9b").replace(
        dtype="float32", stem_pattern=STEM, **kw)


def _steep_gate(params_np, cfg):
    """Every attention block's gate made to admit about half the tokens
    with scores far from tau: hidden unit 0 reads gate feature 0 (the
    RMS-normalised key's first coordinate, about N(0, 1)), the others are
    off, and ``g = sigmoid(200 * gelu(x0) - 4)``. Tokens with x0 < 0 score
    below sigmoid(-4) = 0.018; the rest rise steeply past tau = 0.1 near
    x0 = 0.018, so a score within 1e-3 of tau needs x0 inside a band of
    about 1e-4."""
    for i, bt in enumerate(cfg.block_pattern):
        if bt != "local_attn":
            continue
        gate = params_np["blocks"][f"b{i}"]["attn"]["gate"]
        r, h, f, m = gate["w1"].shape
        gate["w1"] = np.zeros((r, h, f, m), np.float32)
        gate["w1"][:, :, 0, 0] = 1.0
        gate["b1"] = np.zeros((r, h, m), np.float32)
        gate["w2"] = np.zeros((r, h, m, 1), np.float32)
        gate["w2"][:, :, 0, 0] = 200.0
        gate["b2"] = np.full((r, h, 1), -4.0, np.float32)
    return params_np


def _setup(seed=0, **kw):
    jcfg = hybrid_cfg(**kw)
    params_np = jax.tree.map(np.asarray,
                             JT.init_model(jax.random.PRNGKey(seed), jcfg))
    params_np = _steep_gate(params_np, jcfg)
    tcfg = port_cfg(jcfg)
    return (jcfg, jax.tree.map(jnp.asarray, params_np), tcfg,
            params_from_numpy(params_np, tcfg, "cpu"), params_np)


@pytest.fixture(scope="module")
def setup():
    return _setup(0)


def _close(got, want, tol=TOL, msg=""):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol,
                               rtol=tol, err_msg=msg)


# ==========================================================================
# offline prefill then greedy decode
# ==========================================================================
def test_prefill_then_decode_matches(setup, monkeypatch):
    """B 2, S 128 = 2 windows: 64 tokens leave the ring, so the budget (32
    of 64 eligible, sinks first) is cut; then 4 greedy decode steps."""
    jcfg, jparams, tcfg, tparams, _ = setup
    rec = GateRecorder(monkeypatch)
    toks = np.random.default_rng(8).integers(0, tcfg.vocab_size, (2, 128))
    jout, jc = jax.jit(lambda p, t: JI.prefill(p, jcfg, t))(
        jparams, jnp.asarray(toks, jnp.int32))
    tout, tc = TI.prefill(tparams, tcfg, torch.from_numpy(toks))
    assert isinstance(tc["stem"], tuple) and len(tc["stem"]) == 2
    assert tc["blocks"]["b2"].w_local == tcfg.sliding_window
    _close(tout.logits, jout.logits, msg="prefill logits")
    assert float(tout.mean_admission) == pytest.approx(
        float(jout.mean_admission), abs=1e-6)
    _assert_tree_close(jc, tc, ftol=TOL)
    gcnt = tc["blocks"]["b2"].gcnt
    assert int(gcnt.max()) == 32 and int(gcnt.min()) > 16
    jdecode = jax.jit(lambda p, t, c: JI.decode_step(p, jcfg, t, c))
    jl, tl = jout.logits, tout.logits
    for step in range(4):
        jn, tn = jnp.argmax(jl, -1), tl.argmax(-1)
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
        jl, jc, jst = jdecode(jparams, jn, jc)
        tl, tc, tst = TI.decode_step(tparams, tcfg, tn, tc)
        _close(tl, jl, msg=f"logits at step {step}")
        np.testing.assert_allclose(tst["mean_admission"].numpy(),
                                   np.asarray(jst["mean_admission"]),
                                   atol=1e-6)
        _assert_tree_close(jc, tc, ftol=TOL)
    assert int(tc["t"][0]) == 128 + 4
    assert rec.margin() >= TAU_MARGIN


# ==========================================================================
# the full-sequence forward
# ==========================================================================
@pytest.mark.parametrize("mode", ["teacher", "gated", "hard"])
def test_forward_matches(setup, monkeypatch, mode):
    jcfg, jparams, tcfg, tparams, _ = setup
    rec = GateRecorder(monkeypatch)
    toks = np.random.default_rng(9).integers(0, tcfg.vocab_size, (2, 96))
    jo = JT.forward(jparams, jcfg, jnp.asarray(toks, jnp.int32), mode=mode)
    to = TT.forward(tparams, tcfg, torch.from_numpy(toks), mode=mode)
    _close(to.logits, jo.logits, msg="logits")
    _close(to.hidden, jo.hidden, msg="hidden")
    if mode == "teacher":
        assert to.gates is None and jo.gates is None
        return
    n_attn = tcfg.n_repeats * tcfg.attn_blocks_per_pattern
    assert tuple(to.gates.shape) == (n_attn, 2, tcfg.n_kv_heads, 96)
    _close(to.gates, jo.gates, 1e-4, "gates")
    assert rec.margin() >= TAU_MARGIN


def test_forward_gate_overrides_match():
    """Per-attention-layer overrides [L_attn, B, Hkv, S] and one broadcast
    [B, Hkv, S], on a config with two repeats (two attention layers)."""
    jcfg, jparams, tcfg, tparams, _ = _setup(1, n_repeats=2)
    rng = np.random.default_rng(10)
    toks = rng.integers(0, tcfg.vocab_size, (1, 64))
    n_attn = tcfg.n_repeats * tcfg.attn_blocks_per_pattern
    per_layer = rng.uniform(0.2, 1.0, (n_attn, 1, 1, 64)).astype(np.float32)
    for ov in (per_layer, per_layer[0]):
        jo = JT.forward(jparams, jcfg, jnp.asarray(toks, jnp.int32),
                        mode="gated", gate_override=jnp.asarray(ov))
        to = TT.forward(tparams, tcfg, torch.from_numpy(toks), mode="gated",
                        gate_override=torch.from_numpy(ov))
        _close(to.logits, jo.logits, msg=f"override {ov.shape}")
        _close(to.gates, jo.gates, 0, "gates are the overrides")


# ==========================================================================
# ragged extend and eviction
# ==========================================================================
def test_prefill_extend_ragged_matches(setup, monkeypatch):
    """Two ragged rows (90 and 37 tokens) from empty caches: each row's
    last logits, the per-row stats and the whole tree (stem on axis 0,
    stacked RGLRUState and DualCache leaves on axis 1)."""
    jcfg, jparams, tcfg, tparams, _ = setup
    rec = GateRecorder(monkeypatch)
    lens = np.asarray([90, 37], np.int32)
    toks = np.random.default_rng(11).integers(
        0, tcfg.vocab_size, (2, 90)).astype(np.int32)
    jc = JS.build_decode_caches(jcfg, 2, 128, use_wgkv=True)
    tc = TS.build_decode_caches(tcfg, 2, 128, device="cpu")
    _assert_tree_close(jc, tc, ftol=0)
    jl, jc, jst = JI.prefill_extend_ragged(jparams, jcfg, jnp.asarray(toks),
                                           jnp.asarray(lens), jc)
    tl, tc, tst = TI.prefill_extend_ragged(tparams, tcfg,
                                           torch.from_numpy(toks), lens, tc)
    _close(tl, jl, msg="last logits")
    np.testing.assert_allclose(tst["adm_sum_rows"].numpy(),
                               np.asarray(jst["adm_sum_rows"]), atol=1e-5)
    _assert_tree_close(jc, tc, ftol=TOL)
    np.testing.assert_array_equal(tc["t"].numpy(), lens)
    assert rec.margin() >= TAU_MARGIN


def test_decode_with_eviction_matches(setup, monkeypatch):
    """Eviction on the hybrid: the observation window of the pattern's one
    attention block (index 2 of the pattern, ordinal 0 among attention
    blocks) is ``obs[r, 0]``. A ragged extend past the ring, then 4 greedy
    steps: trigger rows, kept global entries and the obs tree equal the
    reference's."""
    jcfg, jparams, tcfg, tparams, _ = setup
    rec = GateRecorder(monkeypatch)
    opts = dict(evict_hard_budget=12, w_obs=16)
    jopts, topts = JI.DecodeOptions(**opts), TI.DecodeOptions(**opts)
    lens = np.asarray([110, 96], np.int32)
    toks = np.random.default_rng(12).integers(
        0, tcfg.vocab_size, (2, 110)).astype(np.int32)
    jc = JS.build_decode_caches(jcfg, 2, 128, use_wgkv=True)
    jc["obs"] = JI._init_obs_tree(jcfg, 2, jopts)
    tc = TS.build_decode_caches(tcfg, 2, 128, device="cpu")
    tc["obs"] = TI._init_obs_tree(tcfg, 2, topts)
    assert tuple(tc["obs"].q.shape[:3]) == (1, 1, 2)
    jl, jc, jst = JI.prefill_extend_ragged(jparams, jcfg, jnp.asarray(toks),
                                           jnp.asarray(lens), jc, opts=jopts)
    tl, tc, tst = TI.prefill_extend_ragged(tparams, tcfg,
                                           torch.from_numpy(toks), lens, tc,
                                           opts=topts)
    np.testing.assert_array_equal(tst["evict_trigger_rows"].numpy(),
                                  np.asarray(jst["evict_trigger_rows"]))
    assert float(tst["evict_trigger_rows"].min()) > 0
    _assert_tree_close(jc, tc, ftol=TOL)
    jstep = jax.jit(lambda tok, c: JI.decode_step(jparams, jcfg, tok, c,
                                                  opts=jopts))
    jtok, ttok = jnp.argmax(jl, -1), tl.argmax(-1)
    for _ in range(4):
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
        jl, jc, jst = jstep(jtok.astype(jnp.int32), jc)
        tl, tc, tst = TI.decode_step(tparams, tcfg, ttok.to(torch.int32), tc,
                                     opts=topts)
        _close(tl, jl, msg="logits")
        np.testing.assert_array_equal(tst["evict_trigger_rows"].numpy(),
                                      np.asarray(jst["evict_trigger_rows"]))
        _assert_tree_close(jc, tc, ftol=TOL)
        jtok, ttok = jnp.argmax(jl, -1), tl.argmax(-1)
    assert int(tc["blocks"]["b2"].gcnt.max()) <= 32
    assert rec.margin() >= TAU_MARGIN


def test_splice_and_extract_round_trip(setup):
    """A batch-1 hybrid tree (stem, RGLRUState, DualCache, obs) spliced
    into row 1 of 3 reads back bit for bit, the other rows stay zero, and
    every leaf's batch axis is the reference's."""
    jcfg, _, tcfg, _, _ = setup
    opts = TI.DecodeOptions(evict_hard_budget=24, w_obs=8)
    one = TS.build_decode_caches(tcfg, 1, 64, device="cpu")
    one["obs"] = TI._init_obs_tree(tcfg, 1, opts)
    g = torch.Generator().manual_seed(0)
    one = tree_map(lambda x: torch.randint(1, 50, x.shape, generator=g)
                   .to(x.dtype), one)
    full = TS.alloc_batched_caches(one, 3)
    spliced = TS.splice_caches(full, one, 1)
    for p, a in tree_leaves_with_path(full):
        assert not a.any(), p
    back = TS.extract_slot_caches(spliced, 1)
    for (p, a), (_, b_) in zip(tree_leaves_with_path(one),
                               tree_leaves_with_path(back)):
        assert torch.equal(a, b_), p
    for row in (0, 2):
        for p, a in tree_leaves_with_path(TS.extract_slot_caches(spliced,
                                                                 row)):
            assert not a.any(), p
    jone = JS.build_decode_caches(jcfg, 1, 64, use_wgkv=True)
    jone["obs"] = JI._init_obs_tree(jcfg, 1, JI.DecodeOptions(
        evict_hard_budget=24, w_obs=8))
    jaxes = {tuple(getattr(k, "key", getattr(k, "name",
                                             getattr(k, "idx", None)))
                   for k in p): JS.cache_batch_axis(p)
             for p, _ in jax.tree_util.tree_flatten_with_path(jone)[0]}
    taxes = {p: TS.cache_batch_axis(p) for p, _ in tree_leaves_with_path(one)}
    assert taxes == jaxes
    assert taxes[("stem", 0, "h")] == 0 and taxes[("blocks", "b0", "h")] == 1


# ==========================================================================
# serving
# ==========================================================================
MAX_NEW = 6


def _serve(session, eng, prompts, dev):
    handles = [session.submit(p, max_new=MAX_NEW) for p in prompts]
    for _ in range(500):
        if not session.tick():
            break
        if dev is not None and any(eng.live):
            session.orchestrator.drain()
            dev.append(eng.verify_paged())
    session.run()
    out = [h.tokens() for h in handles]
    session.close()
    return out


def test_engine_streams_match_reference(setup, monkeypatch):
    """Three prompts (one past the 64-token ring) through both packages'
    ``ServeSession`` over the wgkv Engine: identical greedy streams, and
    the port's paged pool within 2e-3 of its logical caches at every
    tick (``verify_paged`` reads the first attention block)."""
    jcfg, jparams, tcfg, tparams, _ = setup
    rec = GateRecorder(monkeypatch)
    rng = np.random.default_rng(13)
    prompts = [rng.integers(0, 500, n).tolist() for n in (80, 30, 9)]
    kw = dict(slots=2, capacity=128, pool_pages=1024)
    jeng = jax_make_backend("wgkv", jparams, jcfg, **kw)
    teng = torch_make_backend("wgkv", tparams, tcfg, device="cpu", **kw)
    assert teng._w_align == jeng._w_align
    dev = []
    jout = _serve(JSession(jeng, sched=JSched(chunk_tokens=16)), jeng,
                  prompts, None)
    tout = _serve(TSession(teng, sched=TSched(chunk_tokens=16)), teng,
                  prompts, dev)
    assert tout == jout
    assert all(len(o) == MAX_NEW for o in tout)
    assert dev and max(dev) < 2e-3
    assert teng.pool.pages_in_use == 0
    assert rec.margin() >= TAU_MARGIN
    with pytest.raises(ValueError, match="no dual cache"):
        teng.verify_paged(block=0)


def test_serve_cli_runs_the_hybrid_and_sizes_its_pool(capsys):
    """``--arch recurrentgemma-9b --reduced --device cpu`` serves to the
    end with the pool verified; the pool is sized per attention layer
    with its own ring."""
    res = TSERVE.main(["--arch", "recurrentgemma-9b", "--reduced",
                       "--device", "cpu", "--requests", "2", "--max-new",
                       "3", "--prompt-len", "24", "--quiet-stream"])
    assert [len(o) for o in res["outputs"]] == [3, 3]
    assert res["paged_dev"] < 2e-3
    cfg = torch_reduced("recurrentgemma-9b")
    # one local_attn layer, one kv head: (64-token ring + 128 budget) / 16
    assert TSERVE.pool_pages_for(cfg, 2, 512) == 2 * (64 + 128) // 16 + 1
    full = torch_full("recurrentgemma-9b")
    assert TSERVE.pool_pages_for(full, 2, 512) == \
        2 * 12 * (2048 + 128) // 16 + 1
    qwen = torch_full("qwen3-0.6b")
    assert TSERVE.pool_pages_for(qwen, 2, 512) == \
        2 * 28 * 8 * (256 + 128) // 16 + 1


# ==========================================================================
# registry and weights
# ==========================================================================
@pytest.mark.parametrize("name", ["qwen3-0.6b", "recurrentgemma-9b"])
@pytest.mark.parametrize("full", [True, False])
def test_param_counts_match_reference(name, full):
    jcfg = jax_full(name) if full else jax_reduced(name)
    tcfg = torch_full(name) if full else torch_reduced(name)
    want = JREG.count_params_analytic(jcfg)
    assert TREG.count_params_analytic(tcfg) == want
    assert tcfg.param_count() == jcfg.param_count() == want
    assert tcfg.active_param_count() == want
    if name == "recurrentgemma-9b" and full:
        assert want == 8_578_807_308
    if not full:
        for cfg in (tcfg, tcfg.replace(stem_pattern=STEM)):
            params = TT.init_model(cfg, torch.Generator().manual_seed(0),
                                   "cpu")
            assert TREG.count_params_tree(params) == \
                TREG.count_params_analytic(cfg)


def test_flat_npz_stem_loads_as_a_tuple(setup, tmp_path):
    """The reference's checkpoint writes the stem as ``stem/0/...``; it
    loads into the port's stem tuple, leaf for leaf, and a tree whose stem
    does not match the config is refused."""
    jcfg, _, tcfg, tparams, params_np = setup
    path = str(tmp_path / "hybrid.npz")
    JCK.save(path, params_np)
    with np.load(path) as z:
        assert any(k.startswith("stem/1/rec/") for k in z.files)
    loaded = params_from_numpy(path, tcfg, "cpu")
    assert isinstance(loaded["stem"], tuple) and len(loaded["stem"]) == 2
    want = dict(tree_leaves_with_path(tparams))
    got = dict(tree_leaves_with_path(loaded))
    assert set(got) == set(want)
    for p in want:
        assert torch.equal(got[p], want[p]), p
    with pytest.raises(ValueError, match="stem"):
        params_from_numpy(path, tcfg.replace(stem_pattern=()), "cpu")
