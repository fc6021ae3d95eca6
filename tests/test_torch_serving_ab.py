"""The reference's serving A/B (``benchmarks/bench_serving.py``) replayed
through the port on the CPU: the numbers that do not depend on hardware.

The trace is the reference's own ``record_trace`` (seed 1, burst, 12 x
96 tokens, 16 new), drawn with JAX under the PRNG setting that produced
the committed ``BENCH_serving.json`` (``jax_threefry_partitionable``
off: the arrival ticks then equal the record's), and handed to the port
as numpy prompts and ticks. The port replays it on the trained substrate
(``checkpoints/bench_model_lam0.15.npz``) with the bench's settings:
slots 4, capacity 192, chunk 32, dispatch-ahead 1, paged mirror off.

Held against the record: the trace, dense's ``kv_tokens_peak`` 1728 and
the multi-turn prefix ``hit_rate`` 0.667 for both backends. The record's
WG-KV admission (0.7166) and peak (1328) were measured on substrate
weights older than the committed checkpoint; the arbiter is the
reference's ``replay`` on the same trace and checkpoint, and the port
must equal it exactly (streams, peak) and in admission to 1e-6.
"""
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from benchmarks import bench_serving as B
from repro.configs.base import ModelConfig as JModelConfig
from repro.configs.base import WGKVConfig as JWGKVConfig
from repro.models import transformer as JT
from repro.serving.backend import make_backend as jax_make_backend
from repro.training import checkpoint as JCK
from repro_torch.configs.base import ModelConfig as TModelConfig
from repro_torch.configs.base import WGKVConfig as TWGKVConfig
from repro_torch.convert import params_from_numpy
from repro_torch.serving.backend import make_backend
from repro_torch.serving.orchestrator import SchedulerConfig, ServeSession
from repro_torch.serving.prefix_cache import PrefixCache
from test_torch_prefill import SUBSTRATE, _substrate_cfg

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
RECORD = json.loads((REPO / "BENCH_serving.json").read_text())


def _reference_trace():
    """``record_trace`` as the record drew it (legacy threefry split)."""
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", False)
    try:
        return B.record_trace(B.N_REQUESTS, 256, prompt_len=B.PROMPT_LEN,
                              max_new=B.MAX_NEW, seed=1)
    finally:
        jax.config.update("jax_threefry_partitionable", old)


def replay(eng, trace):
    """``bench_serving.replay`` over the port's ``ServeSession``."""
    sess = ServeSession(eng, sched=SchedulerConfig(
        chunk_tokens=B.CHUNK, dispatch_ahead=B.DISPATCH_AHEAD))
    handles, pending, tick = [], list(trace), 0
    while pending or not sess.orchestrator.queue.all_done():
        while pending and pending[0]["arrival_tick"] <= tick:
            r = pending.pop(0)
            handles.append(sess.submit(r["prompt"], max_new=r["max_new"]))
        sess.tick()
        tick += 1
        assert tick < 10_000, "trace replay did not drain"
    sess.close()
    return sess.telemetry.summary(), [h.tokens() for h in handles]


def multi_turn_replay(eng, *, convs, turns, user_tokens, plen, mnew,
                      vocab, seed=5, prefix_cache=None):
    """``bench_serving.multi_turn_replay`` over the port (numpy prompts,
    as the reference draws them): each turn resends the conversation
    plus the model's reply plus fresh user tokens."""
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, vocab - 8, size=plen).tolist()
               for _ in range(convs)]
    streams = [[] for _ in range(convs)]
    for _ in range(turns):
        sess = ServeSession(eng, sched=SchedulerConfig(
            chunk_tokens=B.CHUNK, dispatch_ahead=B.DISPATCH_AHEAD),
            prefix_cache=prefix_cache)
        hs = [sess.submit(p, max_new=mnew) for p in prompts]
        sess.run()
        sess.close()
        for c, h in enumerate(hs):
            out = h.tokens()
            streams[c].append(out)
            prompts[c] = prompts[c] + out + rng.integers(
                0, vocab - 8, size=user_tokens).tolist()
    return streams


@pytest.fixture(scope="module")
def ab():
    tcfg = _substrate_cfg((TModelConfig, TWGKVConfig))
    params = params_from_numpy(SUBSTRATE, tcfg, "cpu")
    trace = _reference_trace()
    out = {"trace": trace, "cfg": tcfg, "params": params}
    for name in ("wgkv", "dense"):
        eng = make_backend(name, params, tcfg, slots=B.SLOTS,
                           capacity=B.CAPACITY, device="cpu")
        eng.mirror = False
        out[name] = (eng,) + replay(eng, trace)
    return out


def test_trace_is_the_committed_one(ab):
    rec = RECORD["trace"]
    assert [r["arrival_tick"] for r in ab["trace"]] == rec["arrival_ticks"]
    assert (rec["requests"], rec["prompt_len"], rec["max_new"],
            rec["arrival"]) == (12, 96, 16, "burst")
    assert all(len(r["prompt"]) == 96 for r in ab["trace"])


def test_dense_matches_record(ab):
    _, s, toks = ab["dense"]
    rec = RECORD["backends"]["dense"]
    assert s["kv_tokens_peak"] == rec["kv_tokens_peak"] == 1728.0
    assert s["mean_admission"] == rec["mean_admission"] == 1.0
    assert s["requests"] == 12 and all(len(t) == 16 for t in toks)


def test_wgkv_matches_reference_replay(ab):
    """The arbiter: the reference's ``replay`` of the same trace on the
    same checkpoint. Streams and peak exact, admission to 1e-6; the
    memory fraction of dense follows."""
    jcfg = _substrate_cfg((JModelConfig, JWGKVConfig))
    jparams = JCK.restore(str(SUBSTRATE),
                          JT.init_model(jax.random.PRNGKey(0), jcfg))
    jeng = jax_make_backend("wgkv", jparams, jcfg, slots=B.SLOTS,
                            capacity=B.CAPACITY)
    jeng.mirror = False
    jsess, jtoks = B.replay(jeng, ab["trace"])
    js = jsess.telemetry.summary()
    _, s, toks = ab["wgkv"]
    assert toks == jtoks
    assert s["kv_tokens_peak"] == js["kv_tokens_peak"]
    assert s["mean_admission"] == pytest.approx(js["mean_admission"],
                                                abs=1e-6)
    assert 0.5 < s["mean_admission"] < 1.0
    dense_peak = ab["dense"][1]["kv_tokens_peak"]
    frac = s["kv_tokens_peak"] / dense_peak
    assert frac == js["kv_tokens_peak"] / 1728.0 and frac < 1.0


@pytest.mark.parametrize("name", ["wgkv", "dense"])
def test_prefix_hit_rate_matches_record(ab, name):
    """The multi-turn prefix A/B (4 conversations x 3 turns, 16 user
    tokens per turn): hit streams equal cold streams, and the hit rate
    is the record's 8 / 12."""
    eng = ab[name][0]
    kw = dict(plen=B.PROMPT_LEN, mnew=B.MAX_NEW, vocab=ab["cfg"].vocab_size,
              **B.MULTI_TURN)
    cold = multi_turn_replay(eng, **kw)
    pc = PrefixCache(quantum=B.CHUNK, free_fn=eng.release_prefix)
    warm = multi_turn_replay(eng, prefix_cache=pc, **kw)
    assert warm == cold
    rec = RECORD["backends"][name]["prefix"]
    assert (pc.hits, pc.misses, pc.inserts) == (rec["hits"], rec["misses"],
                                                rec["inserts"]) == (8, 4, 12)
    assert pc.hits / (pc.hits + pc.misses) == pytest.approx(rec["hit_rate"])
    pc.clear()
