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

The port's replays are its own bench's drivers
(``repro_torch.benchmarks.bench_serving``: ``replay``,
``multi_turn_replay``); this file also holds that module's trace and
flag handling. Its whole smoke A/B (``run(smoke=True)``, about 25 s on
the CPU) runs in ``tests/test_torch_bench_serving.py``, which keeps this
file under a minute.
"""
import json
from pathlib import Path

import jax
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
from repro_torch.benchmarks import bench_serving as PB
from repro_torch.convert import params_from_numpy
from repro_torch.serving.backend import make_backend
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
        sess, toks = PB.replay(eng, trace)
        out[name] = (eng, sess.telemetry.summary(), toks)
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
    cold, _ = PB.multi_turn_replay(eng, **kw)
    pc = PrefixCache(quantum=B.CHUNK, free_fn=eng.release_prefix)
    warm, _ = PB.multi_turn_replay(eng, prefix_cache=pc, **kw)
    assert warm == cold
    rec = RECORD["backends"][name]["prefix"]
    assert (pc.hits, pc.misses, pc.inserts) == (rec["hits"], rec["misses"],
                                                rec["inserts"]) == (8, 4, 12)
    assert pc.hits / (pc.hits + pc.misses) == pytest.approx(rec["hit_rate"])
    pc.clear()


@pytest.mark.parametrize("spec", ["burst", "poisson:0.5", "poisson:3",
                                  "poisson:0", "poisson:-1", "poisson:x",
                                  "poisson", "uniform", ""])
def test_poisson_rate_accepts_and_rejects_as_reference(spec):
    try:
        want = B.poisson_rate(spec)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            PB.poisson_rate(spec)
        assert str(got.value) == str(e)
    else:
        assert PB.poisson_rate(spec) == want


@pytest.mark.parametrize("arrival", ["burst", "poisson:0.5"])
def test_record_trace_is_deterministic_and_sorted(arrival):
    kw = dict(prompt_len=96, max_new=16, arrival=arrival)
    a = PB.record_trace(12, 256, seed=1, **kw)
    assert a == PB.record_trace(12, 256, seed=1, **kw)
    assert a != PB.record_trace(12, 256, seed=2, **kw)
    ticks = [r["arrival_tick"] for r in a]
    assert ticks == sorted(ticks) and len(a) == 12
    assert all(len(r["prompt"]) == 96 and r["max_new"] == 16
               and max(r["prompt"]) < 256 - 8 for r in a)
    if arrival == "burst":
        assert max(ticks) < 12


def test_bench_serving_mesh_exits_2(capsys, tmp_path):
    """``--mesh DxM`` replays the A/B on a mesh (README); a malformed
    mesh exits 2 before any rank starts, and writes nothing."""
    with pytest.raises(SystemExit) as ex:
        PB.main(["--mesh", "2x", "--device", "cpu",
                 "--json-out", str(tmp_path / "x.json")])
    assert ex.value.code == 2
    assert "mesh spec" in capsys.readouterr().err
    assert not (tmp_path / "x.json").exists()
    assert PB.JSON_PATH.endswith("BENCH_serving_torch.json")
