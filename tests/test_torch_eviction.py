"""SnapKV eviction of the port vs the reference, on the CPU, with one set
of weights and numpy inputs.

``push_query`` and ``evict_global`` (given the same scores) are exact;
``snap_scores`` agrees to float32 rounding (1e-6), and ``maybe_evict``
keeps and compacts exactly the reference's entries, ties included: the
width-5 max-pool copies a score to its neighbours, and both packages
break the resulting exact ties by slot order (stable sorts). Where two
distinct scores sit at the eviction cut, the test asserts their gap
clears the two frameworks' rounding, so a flip would read as a near-tie,
not a fault.

Through the model: ``decode_step`` with ``evict_hard_budget`` gives the
reference's greedy tokens and exact integer state, its ``obs`` tree
splices and extracts on the right batch axis, and an Engine serve with
eviction keeps its paged pool within 2e-3 of the logical cache and its
incremental page metadata equal to a from-scratch rebuild through
eviction and slot churn.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dual_cache as JDC
from repro.core import eviction as JEV
from repro.launch import specs as JS
from repro.models import inference as JI
from repro.serving.backend import make_backend as jax_make_backend
from repro.serving.orchestrator import SchedulerConfig as JSched
from repro.serving.orchestrator import ServeSession as JSession
from repro_torch.core import dual_cache as TDC
from repro_torch.core import eviction as TEV
from repro_torch.core.selection import build_page_meta
from repro_torch.launch import specs as TS
from repro_torch.models import inference as TI
from repro_torch.serving.backend import make_backend as torch_make_backend
from repro_torch.serving.orchestrator import SchedulerConfig as TSched
from repro_torch.serving.orchestrator import ServeSession as TSession
from repro_torch.tree import tree_leaves_with_path, tree_map
from test_torch_model import _assert_tree_close
from test_torch_support import parity_setup

torch.set_num_threads(2)

CUT_GAP = 1e-5


@pytest.fixture(scope="module")
def setup():
    return parity_setup(seed=4)


def _obs(rng, b, hq, w, hd, n):
    q = rng.standard_normal((b, hq, w, hd)).astype(np.float32)
    n = np.asarray(n, np.int32)
    return (JEV.ObsWindow(jnp.asarray(q), jnp.asarray(n)),
            TEV.ObsWindow(torch.from_numpy(q), torch.from_numpy(n)))


def _cache(rng, b, h, c, hd, gcnt):
    leaves = dict(
        lk=np.zeros((b, h, 16, hd), np.float32),
        lv=np.zeros((b, h, 16, hd), np.float32),
        lg=np.zeros((b, h, 16), np.float32),
        lpos=np.full((b, 16), -1, np.int32),
        gk=rng.standard_normal((b, h, c, hd)).astype(np.float32),
        gv=rng.standard_normal((b, h, c, hd)).astype(np.float32),
        gpos=np.stack([np.stack([rng.permutation(500)[:c]
                                 for _ in range(h)]) for _ in range(b)]
                      ).astype(np.int32),
        gcnt=np.asarray(gcnt, np.int32), t=np.full((b,), 600, np.int32),
        ptr=np.zeros((b,), np.int32), overflow=np.zeros((b, h), np.int32),
        pkmin=rng.standard_normal((b, h, c // 16, hd)).astype(np.float32),
        pkmax=rng.standard_normal((b, h, c // 16, hd)).astype(np.float32))
    return (JDC.DualCache(**{k: jnp.asarray(v) for k, v in leaves.items()}),
            TDC.DualCache(**{k: torch.from_numpy(v.copy())
                             for k, v in leaves.items()}))


def _assert_cache_equal(jc, tc, names=TDC.DualCache._fields):
    for name in names:
        np.testing.assert_array_equal(getattr(tc, name).numpy(),
                                      np.asarray(getattr(jc, name)),
                                      err_msg=name)


def _cut_gap(scores: torch.Tensor, gcnt: torch.Tensor, frac: float) -> float:
    """Smallest nonzero gap between the last kept and the first evicted
    score over the heads that evict (exact ties break by slot order in
    both packages)."""
    srt = torch.sort(scores, dim=-1, descending=True).values
    n_ev = torch.clamp((gcnt * frac).to(torch.int32), min=1)
    keep = (gcnt - n_ev).long()
    gap = float("inf")
    for idx in zip(*torch.nonzero(gcnt > 1, as_tuple=True)):
        k = int(keep[idx])
        d = float(srt[idx][k - 1] - srt[idx][k])
        if d > 0:
            gap = min(gap, d)
    return gap


# ==========================================================================
# the SnapKV primitives
# ==========================================================================
def test_push_query_matches():
    """Ring writes at n % W_obs, before and after the window wraps."""
    rng = np.random.default_rng(50)
    jo, to = _obs(rng, 3, 4, 8, 16, n=[0, 5, 19])
    for _ in range(6):
        q = rng.standard_normal((3, 4, 16)).astype(np.float32)
        jo = JEV.push_query(jo, jnp.asarray(q))
        to = TEV.push_query(to, torch.from_numpy(q))
        np.testing.assert_array_equal(to.q.numpy(), np.asarray(jo.q))
        np.testing.assert_array_equal(to.n.numpy(), np.asarray(jo.n))


@pytest.mark.parametrize("n", [[0, 3], [8, 40]])
def test_snap_scores_match(n):
    """Valid masks with holes, an empty and a partial window, a full and
    a wrapped one; -inf on invalid entries and the max-pool's ties."""
    rng = np.random.default_rng(51)
    b, hkv, g, w, c, hd = 2, 2, 2, 8, 40, 16
    jo, to = _obs(rng, b, hkv * g, w, hd, n=n)
    k = rng.standard_normal((b, hkv, c, hd)).astype(np.float32)
    valid = rng.random((b, hkv, c)) < 0.8
    want = np.asarray(JEV.snap_scores(jo, jnp.asarray(k), jnp.asarray(valid)))
    got = TEV.snap_scores(to, torch.from_numpy(k), torch.from_numpy(valid))
    got = got.numpy()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    np.testing.assert_array_equal(np.isfinite(got), valid)
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], atol=1e-6, rtol=1e-6)
    # the pool spreads one value over neighbours: exact ties exist
    both = fin[..., 1:] & fin[..., :-1]
    assert (got[..., 1:] == got[..., :-1])[both].any()


@pytest.mark.parametrize("frac", [0.1, 0.3])
def test_evict_global_matches_on_tied_scores(frac):
    """Given the same scores — integer-valued, so ties are everywhere —
    the same entries are kept, compacted in position order, and the page
    metadata rebuilt, bit for bit."""
    rng = np.random.default_rng(52)
    b, h, c, hd = 2, 3, 48, 8
    jc, tc = _cache(rng, b, h, c, hd, gcnt=[[0, 1, 17], [48, 30, 9]])
    scores = rng.integers(0, 4, (b, h, c)).astype(np.float32)
    gvalid = np.arange(c)[None, None] < np.asarray(tc.gcnt)[..., None]
    scores = np.where(gvalid, scores, -np.inf).astype(np.float32)
    want = JEV.evict_global(jc, jnp.asarray(scores), evict_frac=frac)
    got = TEV.evict_global(tc, torch.from_numpy(scores), evict_frac=frac)
    _assert_cache_equal(want, got)
    assert int(got.gcnt.sum()) < int(tc.gcnt.sum())


@pytest.mark.parametrize("budget", [1, 20, 64])
def test_maybe_evict_matches(budget):
    """Scored from an observation window, triggered per head at the hard
    budget (all, some, none): the same cache leaves and triggers."""
    rng = np.random.default_rng(53)
    b, hkv, g, w, c, hd = 2, 2, 2, 8, 48, 16
    jc, tc = _cache(rng, b, hkv, c, hd, gcnt=[[48, 19], [33, 0]])
    jo, to = _obs(rng, b, hkv * g, w, hd, n=[3, 12])
    gvalid = torch.arange(c)[None, None] < tc.gcnt[..., None]
    gap = _cut_gap(TEV.snap_scores(to, tc.gk, gvalid), tc.gcnt, 0.1)
    assert gap > CUT_GAP, gap
    want, jtrig = JEV.maybe_evict(jc, jo, hard_budget=budget)
    got, ttrig = TEV.maybe_evict(tc, to, hard_budget=budget)
    np.testing.assert_array_equal(ttrig.numpy(), np.asarray(jtrig))
    _assert_cache_equal(want, got)
    assert 0 < int(ttrig.sum()) < ttrig.numel() or budget in (1, 64)


# ==========================================================================
# the obs subtree: batch axis 2 in splice / extract / ragged keep
# ==========================================================================
def test_obs_tree_splices_on_its_batch_axis(setup):
    """A batch-1 tree with ``obs`` spliced into row 1 of 2 reads back bit
    for bit, row 0 stays as it was, and every leaf's batch axis is the
    reference's (``obs`` leaves are [n_repeats, n_attn, B, ...])."""
    jcfg, _, tcfg, _ = setup
    opts = TI.DecodeOptions(evict_hard_budget=24, w_obs=8)
    one = TS.build_decode_caches(tcfg, 1, 64, device="cpu")
    one["obs"] = TI._init_obs_tree(tcfg, 1, opts)
    g = torch.Generator().manual_seed(0)
    one = tree_map(lambda x: torch.randint(1, 50, x.shape, generator=g)
                   .to(x.dtype), one)
    full = TS.alloc_batched_caches(one, 2)
    assert tuple(full["obs"].q.shape[:3]) == (tcfg.n_repeats, 1, 2)
    spliced = TS.splice_caches(full, one, 1)
    back = TS.extract_slot_caches(spliced, 1)
    for (p, a), (_, b_) in zip(tree_leaves_with_path(one),
                               tree_leaves_with_path(back)):
        assert torch.equal(a, b_), p
    row0 = TS.extract_slot_caches(spliced, 0)
    for p, a in tree_leaves_with_path(row0):
        assert not a.any(), p
    jone = JS.build_decode_caches(jcfg, 1, 64, use_wgkv=True)
    jone["obs"] = JI._init_obs_tree(jcfg, 1, JI.DecodeOptions(
        evict_hard_budget=24, w_obs=8))
    jaxes = {tuple(getattr(k, "key", getattr(k, "name", None)) for k in p):
             JS.cache_batch_axis(p)
             for p, _ in jax.tree_util.tree_flatten_with_path(jone)[0]}
    taxes = {p: TS.cache_batch_axis(p)
             for p, _ in tree_leaves_with_path(one)}
    assert taxes == jaxes


# ==========================================================================
# decode_step with eviction
# ==========================================================================
def test_decode_step_with_eviction_matches_reference(setup, monkeypatch):
    """A ragged extend and greedy decode steps with eviction on: the
    reference's greedy tokens, triggers and integer state exactly, float
    leaves within 5e-5, and the rebuilt page metadata equal to a rebuild
    over the port's own global cache."""
    jcfg, jparams, tcfg, tparams = setup
    opts = dict(evict_hard_budget=24, w_obs=16)
    jopts, topts = JI.DecodeOptions(**opts), TI.DecodeOptions(**opts)
    rng = np.random.default_rng(54)
    lens = np.asarray([60, 44], np.int32)
    b, cap = 2, 64
    jc = JS.build_decode_caches(jcfg, b, cap, use_wgkv=True)
    jc["obs"] = JI._init_obs_tree(jcfg, b, jopts)
    tc = TS.build_decode_caches(tcfg, b, cap, device="cpu")
    tc["obs"] = TI._init_obs_tree(tcfg, b, topts)
    _assert_tree_close(jc, tc, ftol=0)
    gaps = []
    inner = TEV.snap_scores

    def recording(obs, k, valid, *a, **kw):
        s = inner(obs, k, valid, *a, **kw)
        gaps.append(_cut_gap(s, valid.sum(-1).to(torch.int32), 0.1))
        return s
    monkeypatch.setattr(TEV, "snap_scores", recording)
    toks = rng.integers(0, tcfg.vocab_size, (b, int(lens.max()))).astype(
        np.int32)
    jl, jc, jst = JI.prefill_extend_ragged(jparams, jcfg, jnp.asarray(toks),
                                           jnp.asarray(lens), jc, opts=jopts)
    tl, tc, tst = TI.prefill_extend_ragged(tparams, tcfg,
                                           torch.from_numpy(toks), lens, tc,
                                           opts=topts)
    np.testing.assert_array_equal(tst["evict_trigger_rows"].numpy(),
                                  np.asarray(jst["evict_trigger_rows"]))
    assert float(tst["evict_trigger_rows"].min()) > 0
    _assert_tree_close(jc, tc)
    jstep = jax.jit(lambda tok, c: JI.decode_step(jparams, jcfg, tok, c,
                                                  opts=jopts))
    jtok, ttok = jnp.argmax(jl, -1), tl.argmax(-1)
    for _ in range(4):
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
        jl, jc, jst = jstep(jtok.astype(jnp.int32), jc)
        tl, tc, tst = TI.decode_step(tparams, tcfg, ttok.to(torch.int32), tc,
                                     opts=topts)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=1e-4)
        np.testing.assert_array_equal(tst["evict_trigger_rows"].numpy(),
                                      np.asarray(jst["evict_trigger_rows"]))
        _assert_tree_close(jc, tc)
        jtok, ttok = jnp.argmax(jl, -1), tl.argmax(-1)
    assert min(gaps) > CUT_GAP, min(gaps)
    _assert_meta_matches_rebuild(tc["blocks"]["b0"])
    assert int(tc["obs"].n.min()) == int(lens.min()) + 4


# ==========================================================================
# the Engine with eviction
# ==========================================================================
def _prompts():
    rng = np.random.default_rng(55)
    return [rng.integers(0, 200, n).tolist() for n in (60, 44, 52)]


def _assert_meta_matches_rebuild(dc):
    """The incremental page metadata of a stacked [R, B, ...] DualCache
    equals ``build_page_meta`` over its valid global entries, bit for
    bit (min and max are exact)."""
    r, b, h, c, hd = dc.gk.shape
    valid = torch.arange(c)[None, None] < dc.gcnt.reshape(r * b, h)[..., None]
    meta = build_page_meta(dc.gk.reshape(r * b, h, c, hd), valid)
    assert torch.equal(dc.pkmin, meta.kmin.reshape(dc.pkmin.shape))
    assert torch.equal(dc.pkmax, meta.kmax.reshape(dc.pkmax.shape))


def test_engine_serve_with_eviction_matches_reference(setup):
    jcfg, jparams, tcfg, tparams = setup
    kw = dict(slots=2, capacity=64, pool_pages=1024)
    jeng = jax_make_backend("wgkv", jparams, jcfg, opts=JI.DecodeOptions(
        evict_hard_budget=24, w_obs=16), **kw)
    teng = torch_make_backend("wgkv", tparams, tcfg, device="cpu",
                              opts=TI.DecodeOptions(evict_hard_budget=24,
                                                    w_obs=16), **kw)
    out, dev = [], []
    for eng, sess in ((jeng, JSession(jeng, sched=JSched(chunk_tokens=16))),
                      (teng, TSession(teng, sched=TSched(chunk_tokens=16)))):
        handles = [sess.submit(p, max_new=6) for p in _prompts()]
        for _ in range(500):
            if not sess.tick():
                break
            if eng is teng and any(eng.live):
                sess.orchestrator.drain()
                dev.append(eng.verify_paged())
        sess.run()
        out.append(([h.tokens() for h in handles],
                    eng.stats["evict_triggers"]))
        sess.close()
    (jtoks, jtrig), (ttoks, ttrig) = out
    assert all(len(t) == 6 for t in ttoks)
    assert ttoks == jtoks
    assert ttrig > 0 and ttrig == pytest.approx(jtrig)
    assert dev and max(dev) < 2e-3
    assert teng.pool.pages_in_use == 0


def test_engine_meta_matches_rebuild_after_eviction_and_churn(setup):
    """Offline prefill + insert, decode-only steps that trigger eviction,
    then a slot freed and refilled: the pool stays within 2e-3 of the
    logical cache and the page metadata equals a rebuild."""
    _, _, tcfg, tparams = setup
    eng = torch_make_backend("wgkv", tparams, tcfg, device="cpu", slots=2,
                             capacity=64, pool_pages=1024,
                             opts=TI.DecodeOptions(evict_hard_budget=24,
                                                   w_obs=16))
    prompts = _prompts()
    eng.insert(eng.prefill(prompts[0]), 0)
    eng.insert(eng.prefill(prompts[1]), 1)
    before = eng.stats["evict_triggers"]
    for _ in range(6):
        eng.collect(eng.step_batch([]))
    assert eng.stats["evict_triggers"] > before
    assert eng.verify_paged() < 2e-3
    _assert_meta_matches_rebuild(eng.caches["blocks"]["b0"])
    eng.free_slot(0)
    assert not eng._slot_evicted[0] and eng._slot_evicted[1]
    eng.insert(eng.prefill(prompts[2]), 0)
    for _ in range(6):
        eng.collect(eng.step_batch([]))
    assert eng.verify_paged() < 2e-3
    _assert_meta_matches_rebuild(eng.caches["blocks"]["b0"])
    for s in (0, 1):
        eng.free_slot(s)
    assert eng.pool.pages_in_use == 0
