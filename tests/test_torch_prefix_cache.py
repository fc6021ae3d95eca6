"""The port's content-addressed prefix store vs the reference on the CPU.

Three layers, as in the reference's ``tests/test_prefix_cache.py``:

  * the pool's refcounted pages and copy-on-write (serving/paged.py):
    ``share_stream`` pins pages by refcount, a write through a shared
    stream copies the page first, and the same operations give the same
    page accounting and bytes as the reference's pool;
  * the store (serving/prefix_cache.py): chained chunk hashes equal the
    reference's digests byte for byte, longest-prefix lookup, LRU
    eviction with deferred reclaim of referenced entries;
  * serving: a hit splices the stored post-admission tree and resumes at
    the suffix; streams equal cold prefill (and the reference's), through
    concurrent hits, cancellation and dispatch-ahead, for the WG-KV and
    dense backends; every page is reclaimed once the store is cleared.
"""
import numpy as np
import pytest
import torch

from repro.serving import paged as jpaged
from repro.serving import prefix_cache as jpc
from repro.serving.backend import make_backend as jax_make_backend
from repro.serving.orchestrator import SchedulerConfig as JSched
from repro.serving.orchestrator import ServeSession as JSession
from repro_torch.launch import serve as TSERVE
from repro_torch.serving import paged
from repro_torch.serving.backend import make_backend
from repro_torch.serving.orchestrator import (Orchestrator, SchedulerConfig,
                                              ServeSession)
from repro_torch.serving.prefix_cache import (CachedPrefix, PrefixCache,
                                              chain_hashes)
from test_torch_support import parity_setup

torch.set_num_threads(2)

CHUNK = 16


# ==========================================================================
# pool: refcounted pages + copy-on-write through shared streams
# ==========================================================================
def test_pool_share_stream_refcounts():
    pool = paged.PagedKVPool(64, head_dim=4)
    src = ("pfx", 0)
    for i in range(20):                      # 2 pages of 16 slots
        pool.append(src, np.full(4, i), np.full(4, -i))
    used = pool.pages_in_use
    pool.share_stream(src, ("slot", 0))
    assert pool.pages_in_use == used          # no new pages
    assert all(pool.refcount(p) == 2 for p in pool.table(src).pages)
    pool.free_stream(("slot", 0))             # decref; pages survive
    assert pool.pages_in_use == used
    assert all(pool.refcount(p) == 1 for p in pool.table(src).pages)
    pool.free_stream(src)
    assert pool.pages_in_use == 0
    with pytest.raises(ValueError, match="already exists"):
        pool.append(("a",), np.zeros(4), np.zeros(4))
        pool.share_stream(("a",), ("a",))


def test_pool_cow_append_isolates_sharers():
    pool = paged.PagedKVPool(64, head_dim=4)
    src = ("pfx", 0)
    for i in range(20):
        pool.append(src, np.full(4, i), np.full(4, i))
    k0, _ = pool.gather(src)
    pool.share_stream(src, ("slot", 0))
    # an append through the sharer lands on the shared tail page: COW
    pool.append(("slot", 0), np.full(4, 99.0), np.full(4, 99.0))
    assert pool.table(src).pages[-1] != pool.table(("slot", 0)).pages[-1]
    assert pool.table(src).pages[0] == pool.table(("slot", 0)).pages[0]
    np.testing.assert_array_equal(pool.gather(src)[0], k0)
    ks, _ = pool.gather(("slot", 0))
    assert ks.shape[0] == 21 and ks[-1, 0] == 99.0
    np.testing.assert_array_equal(ks[:20], k0)


def test_pool_cow_overwrite_isolates_sharers():
    pool = paged.PagedKVPool(64, head_dim=4)
    src = ("pfx", 0)
    for i in range(20):
        pool.append(src, np.full(4, i), np.full(4, i))
    pool.share_stream(src, ("a",))
    pool.share_stream(src, ("b",))
    pool.overwrite(("a",), 3, np.full(4, 7.0), np.full(4, 7.0))
    pool.overwrite(("b",), 3, np.full(4, 8.0), np.full(4, 8.0))
    ka, kb, k0 = (pool.gather(k)[0] for k in (("a",), ("b",), src))
    assert k0[3, 0] == 3.0 and ka[3, 0] == 7.0 and kb[3, 0] == 8.0


def test_pool_cow_matches_reference():
    """A random mix of shares, appends, overwrites and frees: the same page
    accounting, refcounts, stream bytes and kernel arguments as the
    reference's pool after every operation."""
    rng = np.random.default_rng(3)
    jp, tp = jpaged.PagedKVPool(96, 8), paged.PagedKVPool(96, 8)
    keys = [("s", i) for i in range(5)]
    for op in range(150):
        kv = rng.standard_normal((2, 8)).astype(np.float32)
        key = keys[int(rng.integers(len(keys)))]
        kind = rng.integers(4)
        live = [k for k in keys if k in tp.tables]
        if kind == 0 and live:
            src = live[int(rng.integers(len(live)))]
            if src != key:
                for p in (jp, tp):
                    p.free_stream(key)
                    p.share_stream(src, key)
        elif kind == 1 and key in tp.tables and tp.table(key).length:
            pos = int(rng.integers(tp.table(key).length))
            jp.overwrite(key, pos, kv[0], kv[1])
            tp.overwrite(key, pos, kv[0], kv[1])
        elif kind == 2 and op % 7 == 0:
            jp.free_stream(key)
            tp.free_stream(key)
        else:
            jp.append(key, kv[0], kv[1])
            tp.append(key, kv[0], kv[1])
        assert tp.pages_in_use == jp.pages_in_use
        assert tp._refs == jp._refs
    live = [k for k in keys if k in tp.tables]
    assert live
    for key in live:
        assert tp.table(key).pages == jp.table(key).pages
        for a, b in zip(jp.gather(key), tp.gather(key)):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(jp.kernel_args(live), tp.kernel_args(live)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


# ==========================================================================
# store: chained hashing, lookup, LRU + deferred eviction
# ==========================================================================
def test_chain_hashes_match_reference():
    rng = np.random.default_rng(4)
    for n, q in ((70, 16), (33, 16), (16, 16), (129, 32), (300, 64)):
        p = rng.integers(0, 151_936, n).tolist()
        assert chain_hashes(p, q) == jpc.chain_hashes(p, q)
    p = list(range(70))
    hs = chain_hashes(p, CHUNK)
    assert [n for n, _ in hs] == [16, 32, 48, 64]
    assert chain_hashes(p[:40], CHUNK)[-1] == hs[1]
    q = list(p)
    q[3] += 1                # an earlier chunk flips every later boundary
    assert chain_hashes(q, CHUNK)[1][1] != hs[1][1]
    assert [n for n, _ in chain_hashes(list(range(32)), CHUNK)] == [16]


def _entry(key, n_tokens, n_bytes=100):
    return CachedPrefix(key=key, n_tokens=n_tokens, caches=None,
                        n_bytes=n_bytes)


def test_store_lookup_longest_and_capture_target():
    store = PrefixCache(quantum=CHUNK, budget_bytes=1 << 20)
    p = list(range(70))
    hs = dict(chain_hashes(p, CHUNK))
    assert store.lookup(p) is None and store.misses == 1
    assert store.capture_target(p) == (64, hs[64])
    store.insert(_entry(hs[16], 16))
    store.insert(_entry(hs[48], 48))
    e = store.lookup(p)
    assert e is not None and e.n_tokens == 48    # the longest stored
    assert e.refs == 1 and store.hits == 1
    store.release(e)
    e2 = store.lookup(p[:20] + [999] * 50)       # diverges in chunk 2
    assert e2 is not None and e2.n_tokens == 16
    store.release(e2)
    with pytest.raises(ValueError, match="over-released"):
        store.release(e2)
    assert store.capture_target(p) == (64, hs[64])
    store.insert(_entry(hs[64], 64))
    assert store.capture_target(p) is None
    with pytest.raises(ValueError, match="quantum"):
        PrefixCache(quantum=0)


def test_store_lru_eviction_and_deferred_reclaim():
    freed = []
    store = PrefixCache(quantum=CHUNK, budget_bytes=250,
                        free_fn=freed.append)
    a, b, c = _entry("a", 16), _entry("b", 16), _entry("c", 16)
    store.insert(a)
    store.insert(b)
    store.insert(c)                     # 300 bytes > 250: evicts the LRU
    assert "a" not in store and freed == [a]
    assert store.evictions == 1 and store.bytes_used == 200
    b.refs += 1                         # pinned by an admitted request
    store.insert(_entry("d", 16))
    assert "b" not in store and freed == [a]     # deferred
    store.release(b)
    assert freed == [a, b]              # reclaimed at the last release
    dup = _entry("c", 16)               # raced duplicate: incumbent stays
    store.insert(dup)
    assert freed == [a, b, dup] and store._entries["c"] is c
    store.clear()
    assert len(store) == 0 and c in freed and store.bytes_used == 0
    assert store.counters()["prefix_evict"] == float(store.evictions)


# ==========================================================================
# serving: hit == cold bytes, cancel, concurrency, cleanup
# ==========================================================================
@pytest.fixture(scope="module")
def served():
    jcfg, jparams, tcfg, tparams = parity_setup(seed=0,
                                                global_budget_frac=0.5)
    eng = make_backend("wgkv", tparams, tcfg, slots=2, capacity=192,
                       device="cpu")
    return jcfg, jparams, tcfg, tparams, eng


def _prompts(cfg, shared=48, tails=(8, 8), seed=0):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, cfg.vocab_size - 8, size=shared).tolist()
    return [base + rng.integers(0, cfg.vocab_size - 8, size=t).tolist()
            for t in tails]


def _serve(eng, prompts, pc=None, max_new=4, session=ServeSession,
           sched=SchedulerConfig, **sched_kw):
    sess = session(eng, sched=sched(chunk_tokens=CHUNK, **sched_kw),
                   prefix_cache=pc)
    hs = [sess.submit(p, max_new=max_new) for p in prompts]
    sess.run()
    sess.close()
    return [h.tokens() for h in hs], sess


def test_quantum_must_match_chunk(served):
    eng = served[-1]
    with pytest.raises(ValueError, match="quantum"):
        Orchestrator(eng, sched=SchedulerConfig(chunk_tokens=CHUNK),
                     prefix_cache=PrefixCache(quantum=CHUNK + 1))


def test_hit_streams_cold_bytes(served):
    """Round 2 hits the store for every request and streams what cold
    prefill streamed, which is what the reference streams; the stored
    entry holds the reference's counts; telemetry reports the hit."""
    jcfg, jparams, tcfg, _, eng = served
    prompts = _prompts(tcfg)
    cold, _ = _serve(eng, prompts)
    pc = PrefixCache(quantum=CHUNK, free_fn=eng.release_prefix)
    warm1, _ = _serve(eng, prompts, pc)
    assert warm1 == cold                       # miss round: no effect
    assert pc.misses == 2 and pc.hits == 0 and len(pc) == 1
    warm2, sess = _serve(eng, prompts, pc)
    assert warm2 == cold and pc.hits == 2
    s = sess.telemetry.summary()
    assert s["prefix_hit_rate"] == 1.0
    assert s["prefix_tokens_reused"] == 2 * 48
    assert s["counters"]["prefix_hit"] == 2
    assert sess.telemetry.records[0].prefix_hit
    # the reference, same weights and prompts
    jeng = jax_make_backend("wgkv", jparams, jcfg, slots=2, capacity=192)
    jstore = jpc.PrefixCache(quantum=CHUNK, free_fn=jeng.release_prefix)
    jcold, _ = _serve(jeng, prompts, None, session=JSession, sched=JSched)
    _serve(jeng, prompts, jstore, session=JSession, sched=JSched)
    jwarm, _ = _serve(jeng, prompts, jstore, session=JSession, sched=JSched)
    assert cold == jcold and warm2 == jwarm
    (te,), (je,) = pc._entries.values(), jstore._entries.values()
    assert (te.key, te.n_tokens, te.kv_tokens, te.n_bytes) == \
        (je.key, je.n_tokens, je.kv_tokens, je.n_bytes)
    assert te.adm_weighted == pytest.approx(je.adm_weighted, abs=1e-5)
    for lkey, m in je.meta.items():
        np.testing.assert_array_equal(te.meta[lkey]["gcnt"], m["gcnt"])
        assert te.meta[lkey]["n_local"] == m["n_local"]
    pc.clear()
    assert eng.pool.pages_in_use == 0          # store pages all reclaimed


def test_concurrent_hits_never_share_mutable_state(served):
    """Two simultaneous hits on one entry decode different suffixes; the
    entry's pool bytes stay untouched and both streams are cold-exact."""
    tcfg, eng = served[2], served[-1]
    prompts = _prompts(tcfg, tails=(8, 12), seed=1)
    cold, _ = _serve(eng, prompts)
    pc = PrefixCache(quantum=CHUNK, free_fn=eng.release_prefix)
    _serve(eng, [prompts[0]], pc)              # populate (one miss)
    (entry,) = pc._entries.values()
    before = {k: eng.pool.gather(k)[0].copy() for k in entry.stream_keys}
    warm, _ = _serve(eng, prompts, pc)         # both hit the same entry
    assert pc.hits == 2 and warm == cold
    assert entry.refs == 0                     # pins dropped post-splice
    for k in entry.stream_keys:
        np.testing.assert_array_equal(eng.pool.gather(k)[0], before[k])
    pc.clear()
    assert eng.pool.pages_in_use == 0


def test_cancel_before_splice_releases_ref(served):
    """A request admitted on a hit but cancelled before its first dispatch
    drops its store pin, so eviction can reclaim the entry."""
    tcfg, eng = served[2], served[-1]
    prompts = _prompts(tcfg, tails=(8, 8), seed=2)
    pc = PrefixCache(quantum=CHUNK, free_fn=eng.release_prefix)
    _serve(eng, [prompts[0]], pc)              # populate
    (entry,) = pc._entries.values()
    orch = Orchestrator(eng, sched=SchedulerConfig(chunk_tokens=CHUNK,
                                                   max_prefill_batch=1),
                        prefix_cache=pc)
    r0 = orch.submit(prompts[0], max_new=2)
    r1 = orch.submit(prompts[1], max_new=2)
    orch.tick()
    assert entry.refs == 1                     # r0 released at dispatch
    assert orch.cancel(r1)
    assert entry.refs == 0                     # cancel released the pin
    orch.run()
    orch.telemetry.stop()
    assert len(orch.tokens(r0)) == 2
    pc.clear()
    assert eng.pool.pages_in_use == 0


def test_async_dispatch_hits_match_sync(served):
    """dispatch_ahead=1 over the store streams the same bytes."""
    tcfg, eng = served[2], served[-1]
    prompts = _prompts(tcfg, tails=(8, 8), seed=3)
    cold, _ = _serve(eng, prompts)
    pc = PrefixCache(quantum=CHUNK, free_fn=eng.release_prefix)
    _serve(eng, prompts, pc, dispatch_ahead=1)
    warm, _ = _serve(eng, prompts, pc, dispatch_ahead=1)
    assert warm == cold and pc.hits == 2
    pc.clear()
    assert eng.pool.pages_in_use == 0


def test_hit_row_pool_verifies(served):
    """A hit row past the 16-token ring, mid-decode: its pool streams
    (shared pages copied on write) read what the logical cache holds,
    through the ``paged_decode`` read of ``verify_paged``."""
    tcfg, eng = served[2], served[-1]
    prompts = _prompts(tcfg, shared=64, tails=(24,), seed=5)
    pc = PrefixCache(quantum=CHUNK, free_fn=eng.release_prefix)
    _serve(eng, prompts, pc)
    sess = ServeSession(eng, sched=SchedulerConfig(chunk_tokens=CHUNK),
                        prefix_cache=pc)
    h = sess.submit(prompts[0], max_new=6)
    devs = []
    while sess.tick():
        if h.state == "decode":
            sess.orchestrator.drain()
            devs.append(eng.verify_paged())
    sess.close()
    assert pc.hits == 1 and devs and max(devs) < 2e-3
    pc.clear()
    assert eng.pool.pages_in_use == 0


def test_dense_prefix_hits_match_cold(served):
    """The dense backend takes part in the store: its hits (the row's
    full-KV tree, no pool) stream what cold prefill streams."""
    _, _, tcfg, tparams, _ = served
    eng = make_backend("dense", tparams, tcfg, slots=2, capacity=192,
                       device="cpu")
    prompts = _prompts(tcfg, tails=(8, 12), seed=6)
    cold, _ = _serve(eng, prompts)
    pc = PrefixCache(quantum=CHUNK, free_fn=eng.release_prefix)
    _serve(eng, prompts, pc)
    warm, sess = _serve(eng, prompts, pc)
    assert warm == cold and pc.hits == 2
    (entry,) = pc._entries.values()
    assert entry.n_tokens == 48 and entry.stream_keys == ()
    layers = tcfg.n_repeats * len(tcfg.block_pattern)
    assert entry.kv_tokens == 48 * tcfg.n_kv_heads * layers
    assert sess.telemetry.summary()["prefix_hit_rate"] == 1.0
    pc.clear()


@pytest.mark.parametrize("backend", ["wgkv", "dense"])
def test_serve_cli_prefix_cache(backend):
    """``--prefix-cache`` on the CPU: the CLI's random prompts share no
    prefix, so every request misses, and all are served."""
    res = TSERVE.main(["--arch", "qwen3-0.6b", "--reduced", "--device",
                       "cpu", "--backend", backend, "--requests", "2",
                       "--max-new", "3", "--prompt-len", "40",
                       "--chunk-tokens", "16", "--quiet-stream",
                       "--prefix-cache"])
    assert [len(o) for o in res["outputs"]] == [3, 3]
    c = res["summary"]["counters"]
    assert c["prefix_miss"] == 2 and c["prefix_hit"] == 0
    assert res["paged_dev"] < 2e-3
