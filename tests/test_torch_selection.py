"""Decode-time Quest page selection of the port vs the reference, on the
CPU, with one set of weights and numpy inputs.

Page scoring and ids must be EXACT, ties and -inf padding included (the
port keeps ``lax.top_k``'s lower-index-first order with a stable sort).
The selected read's plain version is held to the Pallas
``paged_decode_selected`` in interpret mode (5e-5 f32, 5e-2 bf16, as
``tests/test_kernels.py``) and is bitwise equal to ``paged_decode_plain``
when K covers every page. ``decode_step`` under gather and mask selection
gives the reference's tokens, integer cache state and
``selected_pages_rows`` exactly, logits within 5e-5. A reduced-config
``ServeSession`` serves the reference's streams; ``quest:ALL`` is
byte-identical to selection off.

Where a partial K could sit at a near-tie of page upper bounds, the test
records the gap between the K-th and (K+1)-th bound the port computed and
asserts it clears the two frameworks' rounding (1e-4), so a flip would be
read as a tie, not a fault.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import selection as JSEL
from repro.kernels import ref as jref
from repro.kernels.paged_decode import (paged_decode_selected as
                                        pallas_paged_decode_selected)
from repro.launch import specs as JS
from repro.models import inference as JI
from repro.serving.backend import make_backend as jax_make_backend
from repro.serving.orchestrator import SchedulerConfig as JSched
from repro.serving.orchestrator import ServeSession as JSession
from repro_torch.core import dual_cache as TDC
from repro_torch.core import selection as TSEL
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.paged_decode import (paged_decode_plain,
                                              paged_decode_selected,
                                              paged_decode_selected_plain)
from repro_torch.launch import specs as TS
from repro_torch.models import inference as TI
from repro_torch.serving.backend import make_backend as torch_make_backend
from repro_torch.serving.obs import Tracer
from repro_torch.serving.orchestrator import SchedulerConfig as TSched
from repro_torch.serving.orchestrator import ServeSession as TSession
from test_torch_model import _assert_tree_close
from test_torch_support import parity_setup

torch.set_num_threads(2)

TOL = {"float32": 5e-5, "bfloat16": 5e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
UB_GAP = 1e-4


@pytest.fixture(scope="module")
def setup():
    return parity_setup(seed=4)


class GapRecorder:
    """Records, for every top-K pick the port makes, the gap between the
    K-th and the (K+1)-th finite page upper bound (inf where fewer than
    K+1 pages are valid)."""

    def __init__(self, monkeypatch):
        self.gaps = []
        for name in ("topk_page_ids", "select_pages"):
            inner = getattr(TSEL, name)
            monkeypatch.setattr(TSEL, name, self._wrap(inner))

    def _wrap(self, inner):
        def wrapped(q, meta, k):
            ub = TSEL.page_upper_bound(q, meta)
            srt = torch.sort(ub, dim=-1, descending=True).values
            if k < srt.shape[-1]:
                gap = srt[..., k - 1] - srt[..., k]
                gap = torch.where(torch.isfinite(srt[..., k]), gap,
                                  torch.full_like(gap, float("inf")))
                self.gaps.append(float(gap.min()))
            return inner(q, meta, k)
        return wrapped

    def min_gap(self):
        return min(self.gaps, default=float("inf"))


# ==========================================================================
# scoring: upper bounds, masks and ids
# ==========================================================================
def _meta(rng, b, h, p, hd, gcnt, tie_pages):
    kmin = rng.standard_normal((b, h, p, hd)).astype(np.float32)
    kmax = kmin + rng.uniform(0.0, 1.0, (b, h, p, hd)).astype(np.float32)
    for src, dst in tie_pages:   # identical metadata: an exact tie
        kmin[:, :, dst] = kmin[:, :, src]
        kmax[:, :, dst] = kmax[:, :, src]
    gcnt = np.asarray(gcnt, np.int32)
    jmeta = JSEL.PageMeta(jnp.asarray(kmin), jnp.asarray(kmax),
                          JSEL.page_valid_from_count(jnp.asarray(gcnt), p))
    tmeta = TSEL.PageMeta(torch.from_numpy(kmin), torch.from_numpy(kmax),
                          TSEL.page_valid_from_count(torch.from_numpy(gcnt),
                                                     p))
    return jmeta, tmeta


@pytest.mark.parametrize("budget", [1, 2, 3, 5, 8, 12])
def test_page_scores_and_ids_match(budget):
    """Upper bounds to f32 rounding; masks, ids and counts exact, with
    exact ties (pages 1 = 4 and 2 = 6 in every head) and -inf pages
    (gcnt 0, a partial page, full)."""
    rng = np.random.default_rng(30)
    b, h, g, p, hd = 2, 3, 2, 8, 16
    jmeta, tmeta = _meta(rng, b, h, p, hd,
                         gcnt=[[0, 37, 128], [16, 90, 5]],
                         tie_pages=[(1, 4), (2, 6)])
    q = rng.standard_normal((b, h * g, hd)).astype(np.float32)
    jq, tq = jnp.asarray(q), torch.from_numpy(q)
    jub = np.asarray(JSEL.page_upper_bound(jq, jmeta))
    tub = TSEL.page_upper_bound(tq, tmeta).numpy()
    np.testing.assert_array_equal(np.isfinite(tub), np.isfinite(jub))
    fin = np.isfinite(jub)
    np.testing.assert_allclose(tub[fin], jub[fin], atol=1e-5, rtol=1e-5)
    # the exact ties are exact in both, and no other near-tie exists
    assert (tub[..., 1] == tub[..., 4])[fin[..., 4]].all()
    vals = np.sort(np.unique(jub[fin]))
    assert np.diff(vals).min() > UB_GAP
    np.testing.assert_array_equal(
        TSEL.select_pages(tq, tmeta, budget).numpy(),
        np.asarray(JSEL.select_pages(jq, jmeta, budget)))
    jids, jn = JSEL.topk_page_ids(jq, jmeta, budget)
    tids, tn = TSEL.topk_page_ids(tq, tmeta, budget)
    assert tids.dtype == torch.int32 and tn.dtype == torch.int32
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    # ascending ids put the valid pages first: exactly the first n_sel
    # ids address pages that hold a token
    tok0 = tids.numpy() * 16
    cnt = np.asarray([[0, 37, 128], [16, 90, 5]])[..., None]
    k = tids.shape[-1]
    assert ((tok0 < cnt) == (np.arange(k)[None, None]
                             < tn.numpy()[..., None])).all()


def test_page_mask_helpers_match():
    rng = np.random.default_rng(31)
    cnt = np.asarray([[0, 17, 64], [63, 1, 32]], np.int32)
    np.testing.assert_array_equal(
        TSEL.page_valid_from_count(torch.from_numpy(cnt), 4).numpy(),
        np.asarray(JSEL.page_valid_from_count(jnp.asarray(cnt), 4)))
    pmask = rng.random((2, 3, 4)) < 0.5
    np.testing.assert_array_equal(
        TSEL.token_mask_from_pages(torch.from_numpy(pmask)).numpy(),
        np.asarray(JSEL.token_mask_from_pages(jnp.asarray(pmask))))
    ids, n = TSEL.page_ids_from_mask(torch.from_numpy(pmask))
    for bi in range(2):
        for hi in range(3):
            want = np.flatnonzero(pmask[bi, hi])
            assert int(n[bi, hi]) == len(want)
            np.testing.assert_array_equal(ids[bi, hi, :len(want)].numpy(),
                                          want)


def test_gather_pages_matches():
    """The dense statement of what the selected read sees: same rows, same
    validity (tokens past gcnt masked, the ragged tail clamped)."""
    rng = np.random.default_rng(32)
    b, h, c, hd = 2, 2, 64, 8
    gk = rng.standard_normal((b, h, c, hd)).astype(np.float32)
    gv = rng.standard_normal((b, h, c, hd)).astype(np.float32)
    gcnt = np.asarray([[5, 64], [40, 0]], np.int32)
    ids = np.sort(rng.permutation(4)[:3][None, None].repeat(2, 0)
                  .repeat(2, 1), axis=-1).astype(np.int32)
    want = JSEL.gather_pages(*map(jnp.asarray, (gk, gv, gcnt, ids)))
    got = TSEL.gather_pages(*map(torch.from_numpy, (gk, gv, gcnt, ids)))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ==========================================================================
# the selected read: plain version vs Pallas (interpret) and the oracles
# ==========================================================================
def _selected_inputs(rng, n, hd, page, ptotal, mp, kp):
    q = rng.standard_normal((n, hd)).astype(np.float32)
    kpool = rng.standard_normal((ptotal, page, hd)).astype(np.float32)
    vpool = rng.standard_normal((ptotal, page, hd)).astype(np.float32)
    tbl = rng.integers(0, ptotal, (n, mp)).astype(np.int32)
    lens = rng.integers(1, mp * page, (n,)).astype(np.int32)
    sel = np.sort(np.argsort(rng.random((n, mp)), axis=-1)[:, :kp],
                  axis=-1).astype(np.int32)
    nsel = rng.integers(1, kp + 1, (n,)).astype(np.int32)
    return q, kpool, vpool, tbl, lens, sel, nsel


@pytest.mark.parametrize("n,hd,page,ptotal,mp,kp", [
    (6, 64, 16, 32, 8, 3), (2, 128, 16, 8, 4, 2), (4, 64, 32, 64, 16, 5),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_decode_selected_matches_pallas_and_oracles(n, hd, page, ptotal,
                                                          mp, kp, dtype):
    q, kpool, vpool, tbl, lens, sel, nsel = _selected_inputs(
        np.random.default_rng(6), n, hd, page, ptotal, mp, kp)
    jin = [jnp.asarray(a).astype(JDT[dtype]) for a in (q, kpool, vpool)]
    ji = [jnp.asarray(a) for a in (tbl, lens, sel, nsel)]
    pallas = np.asarray(jnp.asarray(
        pallas_paged_decode_selected(*jin, *ji), jnp.float32))
    jax_ref = np.asarray(jref.paged_decode_selected_ref(
        *(x.astype(jnp.float32) for x in jin), *ji))
    tin = [torch.from_numpy(a).to(TDT[dtype]) for a in (q, kpool, vpool)]
    ti = [torch.from_numpy(a) for a in (tbl, lens, sel, nsel)]
    out = paged_decode_selected(*tin, *ti)
    assert out.dtype == TDT[dtype]
    got = out.float().numpy()
    tol = TOL[dtype]
    np.testing.assert_allclose(got, pallas, atol=tol, rtol=tol)
    np.testing.assert_allclose(got, jax_ref, atol=tol, rtol=tol)
    oracle = tref.paged_decode_selected_ref(*(x.float() for x in tin), *ti)
    np.testing.assert_allclose(got, oracle.numpy(), atol=tol, rtol=tol)


@pytest.mark.parametrize("second", [False, True])
def test_selected_identity_is_bitwise_full_read(second):
    """K covering every page with the ascending ids: the same lanes in the
    same order as ``paged_decode_plain``, so the outputs are bitwise equal
    (with and without the second segment)."""
    rng = np.random.default_rng(7)
    n, hd, page, ptotal, mp = 5, 64, 16, 16, 6
    q, kpool, vpool, tbl, lens, _, _ = _selected_inputs(
        rng, n, hd, page, ptotal, mp, mp)
    lens[0] = 0
    t = [torch.from_numpy(a) for a in (q, kpool, vpool, tbl, lens)]
    sel = torch.arange(mp, dtype=torch.int32)[None].expand(n, mp).contiguous()
    nsel = torch.full((n,), mp, dtype=torch.int32)
    seg2 = None
    if second:
        seg2 = (t[1], t[2], t[3][:, :3].contiguous(), t[4] // 4)
    full = paged_decode_plain(*t, second=seg2)
    got = paged_decode_selected_plain(*t, sel, nsel, second=seg2)
    assert torch.equal(got, full)
    assert torch.equal(paged_decode_selected(*t, sel, nsel, second=seg2), full)
    assert torch.all(got[0] == 0) or second


def _dual_cache(rng, b, h, c, w, hd, gcnt, t):
    lpos = np.full((b, w), -1, np.int32)
    for i in range(b):
        pos = np.arange(max(t[i] - w, 0), t[i])
        lpos[i, pos % w] = pos
    p = c // 16
    leaves = dict(
        lk=rng.standard_normal((b, h, w, hd)), lv=rng.standard_normal(
            (b, h, w, hd)), lg=rng.uniform(0, 1, (b, h, w)), lpos=lpos,
        gk=rng.standard_normal((b, h, c, hd)),
        gv=rng.standard_normal((b, h, c, hd)),
        gpos=np.zeros((b, h, c), np.int32), gcnt=np.asarray(gcnt, np.int32),
        t=np.asarray(t, np.int32), ptr=(np.asarray(t) % w).astype(np.int32),
        overflow=np.zeros((b, h), np.int32),
        pkmin=np.zeros((b, h, p, hd)), pkmax=np.zeros((b, h, p, hd)))
    return TDC.DualCache(**{k: torch.from_numpy(np.asarray(
        v, np.int32 if v.dtype == np.int32 else np.float32))
        for k, v in leaves.items()})


def test_dual_cache_selected_read_matches_reference_gather():
    """The port's fold (global pages through the selected ids, the ring
    whole, ids repeated per GQA group) against the reference's gathered
    decode math (``gather_pages`` + ring, one softmax); at K = all it is
    bitwise the full two-segment read."""
    rng = np.random.default_rng(8)
    b, hkv, g, c, w, hd = 2, 2, 2, 64, 32, 16
    cache = _dual_cache(rng, b, hkv, c, w, hd, gcnt=[[0, 33], [64, 17]],
                        t=[20, 90])
    q = torch.from_numpy(rng.standard_normal((b, hkv * g, hd))
                         .astype(np.float32))
    ids = torch.tensor([[[0, 2], [1, 2]], [[1, 3], [0, 1]]], dtype=torch.int32)
    n_sel = torch.tensor([[0, 2], [2, 2]], dtype=torch.int32)
    got = tops.dual_cache_selected_attention(q, cache, ids, n_sel)
    gk, gv, gvalid = JSEL.gather_pages(
        jnp.asarray(cache.gk.numpy()), jnp.asarray(cache.gv.numpy()),
        jnp.asarray(cache.gcnt.numpy()), jnp.asarray(ids.numpy()))
    gvalid = gvalid & (jnp.arange(ids.shape[-1] * 16)[None, None] // 16
                       < jnp.asarray(n_sel.numpy())[..., None])
    k_all = jnp.concatenate([gk, jnp.asarray(cache.lk.numpy())], axis=2)
    v_all = jnp.concatenate([gv, jnp.asarray(cache.lv.numpy())], axis=2)
    lvalid = jnp.broadcast_to(jnp.asarray(cache.lpos.numpy() >= 0)[:, None],
                              (b, hkv, w))
    valid = jnp.concatenate([gvalid, lvalid], axis=2)
    qg = jnp.asarray(q.numpy()).reshape(b, hkv, g, hd)
    logits = jnp.einsum("bhgd,bhkd->bhgk", qg, k_all) * hd ** -0.5
    logits = jnp.where(valid[:, :, None], logits, -1e30)
    want = jnp.einsum("bhgk,bhkd->bhgd", jax.nn.softmax(logits, -1), v_all)
    np.testing.assert_allclose(got.numpy(), np.asarray(want).reshape(
        b, hkv * g, hd), atol=5e-5, rtol=5e-5)
    all_ids = torch.arange(4, dtype=torch.int32)[None, None].expand(
        b, hkv, 4).contiguous()
    n_all = (cache.gcnt + 15) // 16
    assert torch.equal(
        tops.dual_cache_selected_attention(q, cache, all_ids, n_all),
        tops.dual_cache_attention(q, cache))


# ==========================================================================
# decode_step under gather and mask selection
# ==========================================================================
@pytest.fixture(scope="module")
def extended(setup):
    """The same caches in both packages after one ragged extend of three
    rows (tokens leave the ring, so promotion fills global pages, some
    partly)."""
    jcfg, jparams, tcfg, tparams = setup
    rng = np.random.default_rng(40)
    lens = np.asarray([70, 58, 41], np.int32)
    b, s, cap = len(lens), int(lens.max()), 64
    jc = JS.build_decode_caches(jcfg, b, cap, use_wgkv=True)
    tc = TS.build_decode_caches(tcfg, b, cap, device="cpu")
    toks = rng.integers(0, tcfg.vocab_size, (b, s)).astype(np.int32)
    _, jc, _ = JI.prefill_extend_ragged(jparams, jcfg, jnp.asarray(toks),
                                        jnp.asarray(lens), jc)
    _, tc, _ = TI.prefill_extend_ragged(tparams, tcfg, torch.from_numpy(toks),
                                        lens, tc)
    _assert_tree_close(jc, tc)
    gcnt = tc["blocks"]["b0"].gcnt
    assert int(gcnt.max()) > 32 and int(gcnt.min()) < 64  # partial pages
    return jc, tc


@pytest.mark.parametrize("opts", [
    dict(selection_policy="quest:2"), dict(selection_policy="quest:4"),
    dict(quest_pages=2), dict(quest_pages=1)])
def test_decode_step_selection_matches_reference(setup, extended, opts,
                                                 monkeypatch):
    jcfg, jparams, tcfg, tparams = setup
    jc, tc = extended
    rng = np.random.default_rng(43)
    rec = GapRecorder(monkeypatch)
    jopts, topts = JI.DecodeOptions(**opts), TI.DecodeOptions(**opts)
    jstep = jax.jit(lambda tok, c: JI.decode_step(jparams, jcfg, tok, c,
                                                  opts=jopts))
    tok = rng.integers(0, tcfg.vocab_size, (3,)).astype(np.int32)
    for _ in range(4):
        jl, jc, jst = jstep(jnp.asarray(tok), jc)
        tl, tc, tst = TI.decode_step(tparams, tcfg, torch.from_numpy(tok), tc,
                                     opts=topts)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=5e-5,
                                   rtol=5e-5)
        # greedy: each package's own next tokens, identical
        tok = tl.argmax(-1).to(torch.int32).numpy()
        np.testing.assert_array_equal(tok, np.asarray(jnp.argmax(jl, -1)))
        np.testing.assert_array_equal(tst["selected_pages_rows"].numpy(),
                                      np.asarray(jst["selected_pages_rows"]))
        _assert_tree_close(jc, tc)
    # K below the page count picks at a recorded gap; K = 4 covers all
    assert rec.min_gap() > UB_GAP, rec.min_gap()
    assert bool(rec.gaps) == (opts != dict(selection_policy="quest:4"))
    if "selection_policy" in opts:
        assert float(tst["selected_pages_rows"].min()) > 0
    else:
        assert float(tst["selected_pages_rows"].abs().sum()) == 0


def test_quest_mask_is_the_reference_mask(setup, extended):
    """The port's page mask, as tokens and joined with the visible ring,
    is the reference's ``_quest_mask``."""
    jcfg, _, tcfg, _ = setup
    jc, tc = extended
    rng = np.random.default_rng(41)
    jdc = jax.tree.map(lambda x: x[0], jc["blocks"]["b0"])
    tdc = TDC.DualCache(*(x[0] for x in tc["blocks"]["b0"]))
    q = rng.standard_normal((3, tcfg.n_heads, tcfg.head_dim)).astype(
        np.float32)
    want = np.asarray(JI._quest_mask(jcfg, jdc, jnp.asarray(q), 2))
    pmask = TI._quest_mask(tcfg, tdc, torch.from_numpy(q), 2)
    c = tdc.budget
    gvalid = torch.arange(c)[None, None] < tdc.gcnt[..., None]
    tok = TSEL.token_mask_from_pages(pmask) & gvalid
    got = torch.cat([tok, torch.ones(tok.shape[:2] + (tdc.w_local,),
                                     dtype=torch.bool)], dim=-1)
    np.testing.assert_array_equal(got.numpy(), want)


def test_selection_options_are_checked(setup, extended):
    _, _, tcfg, tparams = setup
    with pytest.raises(ValueError, match="quest:K"):
        TI.parse_selection_policy("topk:2")
    assert TI.parse_selection_policy("quest:3") == 3
    _, tc = extended
    with pytest.raises(ValueError, match="exclusive"):
        TI.decode_step(tparams, tcfg, torch.zeros((3,), dtype=torch.int32),
                       tc, opts=TI.DecodeOptions(quest_pages=1,
                                                 selection_policy="quest:1"))
    with pytest.raises(ValueError, match="quest:K"):
        torch_make_backend("wgkv", tparams, tcfg, device="cpu",
                           selection="quest:0")


# ==========================================================================
# the slice as a whole: ServeSession with selection
# ==========================================================================
CAP = 64
ALL_PAGES = CAP // 16
MAX_NEW = 8


def _prompts():
    rng = np.random.default_rng(42)
    return [rng.integers(0, 200, 48 + 8 * i).tolist() for i in range(3)]


def _serve(make, sess_cls, sched_cls, params, cfg, selection, **kw):
    eng = make("wgkv", params, cfg, slots=2, capacity=CAP, temperature=0.0,
               seed=0, selection=selection, **kw)
    tracer = Tracer(capacity=1 << 14) if sess_cls is TSession else None
    extra = {"tracer": tracer} if tracer is not None else {}
    sess = sess_cls(eng, sched=sched_cls(chunk_tokens=16, dispatch_ahead=1),
                    **extra)
    handles = [sess.submit(p, max_new=MAX_NEW) for p in _prompts()]
    sess.run()
    streams = [tuple(h.tokens()) for h in handles]
    counters = dict(sess.orchestrator.telemetry.counters)
    sess.close()
    spans = [s.name for s in tracer.spans] if tracer is not None else []
    return streams, counters, spans, eng


@pytest.fixture(scope="module")
def served(setup):
    jcfg, jparams, tcfg, tparams = setup
    mp = pytest.MonkeyPatch()
    rec = GapRecorder(mp)
    try:
        port = {sel: _serve(torch_make_backend, TSession, TSched, tparams,
                            tcfg, sel, device="cpu")
                for sel in (None, f"quest:{ALL_PAGES}", "quest:2")}
    finally:
        mp.undo()
    ref = _serve(jax_make_backend, JSession, JSched, jparams, jcfg, "quest:2")
    return port, ref, rec


def test_serve_all_pages_is_byte_identical_to_off(served):
    port, _, _ = served
    base, c0, spans0, eng0 = port[None]
    sel_all, c_all, spans_all, eng_all = port[f"quest:{ALL_PAGES}"]
    assert eng0.capabilities().selection is None
    assert eng_all.capabilities().selection == f"quest:{ALL_PAGES}"
    assert all(len(s) == MAX_NEW for s in base)
    assert base == sel_all
    assert c_all["selected_pages"] > 0 and c_all["selection_time_s"] > 0
    assert "selection" in spans_all and "selection" not in spans0
    assert c0.get("selected_pages", 0) == 0


def test_serve_partial_k_matches_reference(served):
    port, ref, rec = served
    _, c_all, _, _ = port[f"quest:{ALL_PAGES}"]
    sel2, c2, spans2, eng2 = port["quest:2"]
    assert all(len(s) == MAX_NEW for s in sel2)
    assert 0 < c2["selected_pages"] < c_all["selected_pages"]
    assert "selection" in spans2
    assert rec.min_gap() > UB_GAP, rec.min_gap()
    jstreams, jc, _, _ = ref
    assert sel2 == jstreams
    assert c2["selected_pages"] == pytest.approx(jc["selected_pages"])
    assert eng2.pool.pages_in_use == 0
