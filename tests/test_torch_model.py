"""The port's model path vs the reference on the CPU, with one set of
weights (the reference's init, carried over by ``params_from_numpy``, with
numpy-drawn gate weights whose scores spread across tau).

Tolerances: single-op results (gate scores, one attention step) agree to
float32 rounding (1e-5 / 5e-5); logits after a ragged extend plus several
decode steps to 1e-4, because the two frameworks sum float32 matmuls in
different orders and the differences compound through layers and
positions. Integer DualCache state must be EXACT (the same tokens
admitted, in the same slots); float leaves agree within 5e-5; length-0
rows of the ragged extend come back bit-identical.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dual_cache as JDC
from repro.core import gate as JG
from repro.core import selection as JSEL
from repro.launch import specs as JS
from repro.models import attention as JA
from repro.models import inference as JI
from repro_torch.core import dual_cache as TDC
from repro_torch.core import gate as TG
from repro_torch.core import selection as TSEL
from repro_torch.launch import specs as TS
from repro_torch.models import attention as TA
from repro_torch.models import inference as TI
from repro_torch.tree import tree_leaves_with_path
from test_torch_support import parity_setup

torch.set_num_threads(2)

TAU_MARGIN = 1e-3
INT_LEAVES = {"lpos", "gpos", "gcnt", "t", "ptr", "overflow"}


@pytest.fixture(scope="module")
def setup():
    # seed 4: every gate score of these inputs is >= 1e-3 away from tau
    return parity_setup(seed=4)


def _layer0(tree):
    return jax.tree.map(lambda x: x[0], tree)


def _jax_leaves(tree):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = tuple(getattr(k, "key", getattr(k, "name",
                                              getattr(k, "idx", None)))
                    for k in path)
        out[key] = np.asarray(leaf)
    return out


def _assert_tree_close(jtree, ttree, *, ftol=5e-5):
    want = _jax_leaves(jtree)
    got = dict(tree_leaves_with_path(ttree))
    assert set(want) == set(got)
    for path, w in want.items():
        g = got[path].numpy()
        assert g.shape == w.shape, path
        if path[-1] in INT_LEAVES:
            assert g.dtype == np.int32, path
            np.testing.assert_array_equal(g, w, err_msg=str(path))
        else:
            np.testing.assert_allclose(g, w, atol=ftol, rtol=0,
                                       err_msg=str(path))


def _tau_margin(g, tau):
    return float(np.abs(np.asarray(g, np.float64) - tau).min())


def _random_cache(rng, b, h, w, c, hd, t, gcnt):
    """A reachable-looking DualCache state (numpy leaves): ring filled to
    min(t, W) with ptr = t % W, gate scores spread across tau."""
    lpos = np.full((b, w), -1, np.int32)
    for i in range(b):
        n = min(t[i], w)
        pos = np.arange(max(t[i] - w, 0), t[i])
        lpos[i, pos % w] = pos
    p = c // 16
    return dict(
        lk=rng.standard_normal((b, h, w, hd)).astype(np.float32),
        lv=rng.standard_normal((b, h, w, hd)).astype(np.float32),
        lg=rng.uniform(0.0, 0.3, (b, h, w)).astype(np.float32),
        lpos=lpos,
        gk=rng.standard_normal((b, h, c, hd)).astype(np.float32),
        gv=rng.standard_normal((b, h, c, hd)).astype(np.float32),
        gpos=rng.integers(0, 100, (b, h, c)).astype(np.int32),
        gcnt=np.asarray(gcnt, np.int32), t=np.asarray(t, np.int32),
        ptr=(np.asarray(t) % w).astype(np.int32),
        overflow=rng.integers(0, 3, (b, h)).astype(np.int32),
        pkmin=rng.standard_normal((b, h, p, hd)).astype(np.float32),
        pkmax=rng.standard_normal((b, h, p, hd)).astype(np.float32))


def _both_caches(leaves):
    return (JDC.DualCache(**{k: jnp.asarray(v) for k, v in leaves.items()}),
            TDC.DualCache(**{k: torch.from_numpy(v.copy())
                             for k, v in leaves.items()}))


# ==========================================================================
# per-module parity
# ==========================================================================
def test_gate_scores_match(setup):
    jcfg, jparams, tcfg, tparams = setup
    rng = np.random.default_rng(1)
    k_pre = rng.standard_normal((2, 2, 7, 64)).astype(np.float32)
    k_post = rng.standard_normal((2, 2, 7, 64)).astype(np.float32)
    jgate = _layer0(jparams["blocks"]["b0"]["attn"]["gate"])
    tgate = {k: v[0] for k, v in tparams["blocks"]["b0"]["attn"]["gate"].items()}
    want = np.asarray(JG.gate_scores(jgate, jnp.asarray(k_pre),
                                     jnp.asarray(k_post)))
    got = TG.gate_scores(tgate, torch.from_numpy(k_pre),
                         torch.from_numpy(k_post))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    # scores spread across tau and stay clear of it
    assert (want >= 0.1).any() and (want < 0.1).any()
    assert _tau_margin(want, 0.1) >= TAU_MARGIN


def test_lazy_promote_and_write_matches(setup):
    """Ring not yet full (victim empty), full ring promoting, and a full
    global cache that overflows: every leaf bit-identical."""
    rng = np.random.default_rng(2)
    b, h, w, c, hd = 3, 2, 16, 32, 8
    leaves = _random_cache(rng, b, h, w, c, hd, t=[5, 40, 100],
                           gcnt=[[0, 3], [15, 16], [32, 31]])
    jc, tc = _both_caches(leaves)
    k_new = rng.standard_normal((b, h, hd)).astype(np.float32)
    v_new = rng.standard_normal((b, h, hd)).astype(np.float32)
    g_new = rng.uniform(0, 0.3, (b, h)).astype(np.float32)
    want = JDC.lazy_promote_and_write(jc, jnp.asarray(k_new),
                                      jnp.asarray(v_new), jnp.asarray(g_new),
                                      tau=0.1)
    got = TDC.lazy_promote_and_write(tc, torch.from_numpy(k_new),
                                     torch.from_numpy(v_new),
                                     torch.from_numpy(g_new), tau=0.1)
    for name in TDC.DualCache._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    # the input is untouched (functional update)
    for name, v in leaves.items():
        np.testing.assert_array_equal(getattr(tc, name).numpy(), v)
    assert int(got.overflow.sum()) > int(leaves["overflow"].sum())


def test_page_metadata_matches():
    """Empty-lane sentinels and the from-scratch rebuild (ragged tail
    padded with invalid lanes) agree with the reference bit for bit."""
    rng = np.random.default_rng(5)
    k = rng.standard_normal((2, 3, 40, 8)).astype(np.float32)
    valid = rng.random((2, 3, 40)) < 0.6
    want = JSEL.build_page_meta(jnp.asarray(k), jnp.asarray(valid))
    got = TSEL.build_page_meta(torch.from_numpy(k), torch.from_numpy(valid))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for w, g in zip(JSEL.init_page_meta(2, 3, 40, 8),
                    TSEL.init_page_meta(2, 3, 40, 8)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_attn_decode_wgkv_matches(setup):
    jcfg, jparams, tcfg, tparams = setup
    rng = np.random.default_rng(3)
    b, h, w, hd = 3, tcfg.n_kv_heads, tcfg.wgkv.w_local, tcfg.head_dim
    c = tcfg.wgkv.global_budget(64)
    leaves = _random_cache(rng, b, h, w, c, hd, t=[0, 16, 37],
                           gcnt=[[0, 0], [1, 16], [21, 64]])
    jc, tc = _both_caches(leaves)
    x = rng.standard_normal((b, tcfg.d_model)).astype(np.float32)
    jp = _layer0(jparams["blocks"]["b0"]["attn"])
    tp = {k: (v[0] if torch.is_tensor(v) else {kk: vv[0] for kk, vv in v.items()})
          for k, v in tparams["blocks"]["b0"]["attn"].items()}
    jy, jnew, jg, _ = JA.attn_decode_wgkv(jp, jcfg, jnp.asarray(x), jc)
    ty, tnew, tg, tsel = TA.attn_decode_wgkv(tp, tcfg, torch.from_numpy(x),
                                             tc)
    assert tsel is None
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-5)
    assert _tau_margin(jg, 0.1) >= TAU_MARGIN
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=5e-5,
                               rtol=5e-5)
    _assert_tree_close(jnew, tnew)


# ==========================================================================
# the slice as a whole: ragged extend + decode steps
# ==========================================================================
def test_ragged_extend_then_decode_matches(setup):
    jcfg, jparams, tcfg, tparams = setup
    rng = np.random.default_rng(4)
    b, s, cap = 3, 24, 64
    jc = JS.build_decode_caches(jcfg, b, cap, use_wgkv=True)
    tc = TS.build_decode_caches(tcfg, b, cap, device="cpu")
    _assert_tree_close(jc, tc, ftol=0)
    margins = []

    def extend(jc, tc, lengths):
        toks = rng.integers(0, tcfg.vocab_size, (b, s)).astype(np.int32)
        jl, jc, jst = JI.prefill_extend_ragged(
            jparams, jcfg, jnp.asarray(toks), jnp.asarray(lengths), jc)
        tl, tc, tst = TI.prefill_extend_ragged(
            tparams, tcfg, torch.from_numpy(toks), lengths, tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=1e-4)
        np.testing.assert_allclose(tst["adm_sum_rows"].numpy(),
                                   np.asarray(jst["adm_sum_rows"]),
                                   rtol=1e-6, atol=1e-6)
        _assert_tree_close(jc, tc)
        margins.append(_tau_margin(np.asarray(jc["blocks"]["b0"].lg), 0.1))
        return jc, tc

    # rows of length 0, partial and full chunks; the last exceeds the ring
    jc, tc = extend(jc, tc, np.asarray([7, 3, 24], np.int32))
    before = tc
    jc, tc = extend(jc, tc, np.asarray([0, 11, 24], np.int32))
    # a length-0 row is bit-identical, leaf by leaf
    for path, old in tree_leaves_with_path(before):
        new = dict(tree_leaves_with_path(tc))[path]
        ax = TS.cache_batch_axis(path)
        assert torch.equal(new.select(ax, 0), old.select(ax, 0)), path
    assert int(tc["blocks"]["b0"].gcnt.sum()) > 0          # promotions ran
    for _ in range(4):
        tok = rng.integers(0, tcfg.vocab_size, (b,)).astype(np.int32)
        jl, jc, jst = JI.decode_step(jparams, jcfg, jnp.asarray(tok), jc)
        tl, tc, tst = TI.decode_step(tparams, tcfg, torch.from_numpy(tok), tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=1e-4)
        np.testing.assert_allclose(tst["mean_admission"].numpy(),
                                   np.asarray(jst["mean_admission"]),
                                   atol=1e-6)
        _assert_tree_close(jc, tc)
        margins.append(_tau_margin(np.asarray(jc["blocks"]["b0"].lg), 0.1))
    assert min(margins) >= TAU_MARGIN, margins


def test_decode_options_reject_unported():
    with pytest.raises(ValueError, match="admission_policy"):
        TI.DecodeOptions(admission_policy="h2o")
    duo = TI.DecodeOptions(admission_policy="duo", duo_retrieval_heads=(1,))
    assert (duo.admission_sink, duo.duo_retrieval_heads) == (16, (1,))
    opts = TI.DecodeOptions(quest_pages=2, selection_policy="quest:2",
                            evict_hard_budget=32)
    assert (opts.quest_pages, opts.selection_policy,
            opts.evict_hard_budget) == (2, "quest:2", 32)
    assert (opts.evict_frac, opts.w_obs) == (0.10, 256)


def test_splice_and_extract_round_trip(setup):
    """Splice a batch-1 tree into a row and read it back: the helpers are
    functional (the source tree is untouched) and bit-exact."""
    from repro_torch.tree import tree_map
    _, _, tcfg, _ = setup
    g = torch.Generator().manual_seed(0)
    one = tree_map(lambda x: torch.randint(0, 50, x.shape, generator=g)
                   .to(x.dtype), TS.build_decode_caches(tcfg, 1, 64,
                                                        device="cpu"))
    full = TS.alloc_batched_caches(one, 3)
    zeros = [x.clone() for _, x in tree_leaves_with_path(full)]
    spliced = TS.splice_caches(full, one, 2)
    for (_, a), z in zip(tree_leaves_with_path(full), zeros):
        assert torch.equal(a, z)
    back = TS.extract_slot_caches(spliced, 2)
    for (p, a), (_, b_) in zip(tree_leaves_with_path(one),
                               tree_leaves_with_path(back)):
        assert torch.equal(a, b_), p
    assert TS.cache_tree_bytes(spliced) == 3 * TS.cache_tree_bytes(one)
