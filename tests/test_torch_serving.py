"""One arrival trace through the reference's ``ServeSession`` over
``make_backend("wgkv", ...)`` and through the port's, both on the CPU,
with the same weights: greedy streams identical, per-request mean
admission equal (to float32 summation order), paged-pool occupancy equal
tick by tick, and the port's ``verify_paged`` < 2e-3.
"""
import numpy as np
import pytest
import torch

from repro.serving import paged as jpaged
from repro.serving.backend import make_backend as jax_make_backend
from repro.serving.orchestrator import SchedulerConfig as JSched
from repro.serving.orchestrator import ServeSession as JSession
from repro_torch.serving import paged as tpaged
from repro_torch.serving.backend import make_backend as torch_make_backend
from repro_torch.serving.orchestrator import SchedulerConfig as TSched
from repro_torch.serving.orchestrator import ServeSession as TSession
from test_torch_support import parity_setup

torch.set_num_threads(2)

MAX_NEW = 6


def _prompts():
    rng = np.random.default_rng(21)
    return [rng.integers(0, 500, n).tolist() for n in (37, 20, 9)]


def _serve(session, eng, prompts, pages, verify):
    handles = [session.submit(p, max_new=MAX_NEW) for p in prompts]
    for _ in range(500):
        if not session.tick():
            break
        if any(eng.live):
            # settle the mirror (both packages, so ticks stay aligned)
            session.orchestrator.drain()
            if verify is not None:
                verify.append(eng.verify_paged())
        pages.append(eng.pool.pages_in_use)
    session.run()
    recs = {r.rid: r.mean_admission for r in session.telemetry.records}
    out = [h.tokens() for h in handles], [recs[h.rid] for h in handles]
    session.close()
    return out


@pytest.fixture(scope="module")
def served():
    jcfg, jparams, tcfg, tparams = parity_setup(seed=4)
    prompts = _prompts()
    kw = dict(slots=2, capacity=64, pool_pages=2048)
    jeng = jax_make_backend("wgkv", jparams, jcfg, **kw)
    teng = torch_make_backend("wgkv", tparams, tcfg, device="cpu", **kw)
    jpages, tpages, dev = [], [], []
    jres = _serve(JSession(jeng, sched=JSched(chunk_tokens=16)), jeng,
                  prompts, jpages, None)
    tres = _serve(TSession(teng, sched=TSched(chunk_tokens=16)), teng,
                  prompts, tpages, dev)
    return jres, tres, jpages, tpages, dev, teng


def test_greedy_streams_identical(served):
    (jtoks, _), (ttoks, _), *_ = served
    assert all(len(t) == MAX_NEW for t in ttoks)
    assert ttoks == jtoks


def test_mean_admission_equal(served):
    (_, jadm), (_, tadm), *_ = served
    assert 0.0 < min(tadm) and max(tadm) < 1.0     # both gate branches ran
    np.testing.assert_allclose(tadm, jadm, rtol=1e-6)


def test_pool_pages_equal_tick_by_tick(served):
    *_, jpages, tpages, _dev, teng = served
    assert max(tpages) > 0
    assert tpages == jpages
    assert teng.pool.pages_in_use == 0


def test_verify_paged_within_bound(served):
    *_, dev, teng = served
    assert dev and max(dev) < 2e-3
    assert teng.stats["fused_steps"] > 0 and teng.stats["steps"] > 0


def test_paged_pool_matches_reference():
    """The same appends, ring overwrites and frees give the same page
    accounting, stream contents and kernel arguments in both pools."""
    rng = np.random.default_rng(8)
    jp, tp = jpaged.PagedKVPool(64, 8), tpaged.PagedKVPool(64, 8)
    keys = [(0, (0, 0), h, r) for h in range(2) for r in ("global", "local")]
    for step in range(60):
        key = keys[step % len(keys)]
        kv = rng.standard_normal((2, 8)).astype(np.float32)
        n = jp.table(key).length
        if key[3] == "local" and n >= 20:
            pos = step % 20
            jp.overwrite(key, pos, kv[0], kv[1])
            tp.overwrite(key, pos, kv[0], kv[1])
        else:
            jp.append(key, kv[0], kv[1])
            tp.append(key, kv[0], kv[1])
        if step == 40:
            jp.free_stream(keys[0])
            tp.free_stream(keys[0])
        assert tp.pages_in_use == jp.pages_in_use
        assert tp.utilization() == pytest.approx(jp.utilization())
    for key in keys:
        for a, b in zip(jp.gather(key), tp.gather(key)):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(jp.kernel_args(keys), tp.kernel_args(keys)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    with pytest.raises(tpaged.PoolExhausted):
        for _ in range(64 * 16):
            tp.append(("x",), kv[0], kv[1])


def test_offline_prefill_insert_decode_matches():
    """The offline prefix surface: chunked batch-1 ``prefill`` (first token
    from the prompt's own logits), ``insert`` into a slot, then decode-only
    fused steps — same tokens, admission and memory telemetry as JAX."""
    jcfg, jparams, tcfg, tparams = parity_setup(seed=4)
    prompt = _prompts()[0]
    kw = dict(slots=2, capacity=64, pool_pages=512)
    jeng = jax_make_backend("wgkv", jparams, jcfg, **kw)
    teng = torch_make_backend("wgkv", tparams, tcfg, device="cpu", **kw)
    out = []
    for eng in (jeng, teng):
        pre = eng.prefill(prompt, chunk_tokens=16)
        eng.insert(pre, 1)
        toks = [pre.first_token]
        for _ in range(4):
            toks.append(eng.collect(eng.step_batch([]))[1])
        out.append((toks, pre.mean_admission, eng.memory_snapshot(),
                    eng.verify_paged()))
        eng.free_slot(1)
        assert eng.pool.pages_in_use == 0
    (jt, ja, jm, _), (tt, ta, tm, tdev) = out
    assert tt == jt
    assert ta == pytest.approx(ja, rel=1e-6)
    assert tm == pytest.approx(jm)
    assert tdev < 2e-3
