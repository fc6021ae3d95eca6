"""The port's figure benchmarks (``repro_torch.benchmarks``) held against
the reference's (``benchmarks/``) on the CPU.

The reference draws every batch with ``jax.random``, which torch cannot
reproduce, so each test draws the reference's batch, hands it to the
port as numpy, and compares the two packages on the same tokens and the
same weights: the committed substrate
(``checkpoints/bench_model_lam0.15.npz``, restored by the reference's
``training/checkpoint.py``; the reference's ``trained_model()`` is never
called, since it trains when its git-ignored file is missing) or the
reference's random init of ``bench_cfg``.
"""
import dataclasses
import json
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import bench_fig1_bottleneck as R1
from benchmarks import bench_fig7_memory_accuracy as R7
from benchmarks import bench_fig8_efficiency as R8
from benchmarks import bench_fig9_quest as R9
from benchmarks import bench_fig10_eviction as R10
from benchmarks import bench_fig11_pareto as R11
from benchmarks import bench_fig13_patterns as R13
from benchmarks import bench_roofline as RROOF
from benchmarks import common as RC
from repro.core.baselines import local_attention_gates as j_local_gates
from repro.data.synthetic import copy_task, needle_task, token_stream
from repro.models import inference as JI
from repro.models import transformer as JT
from repro.training import checkpoint as JCK
from repro.training import trainer as JTR
from repro_torch.benchmarks import bench_fig1_bottleneck as P1
from repro_torch.benchmarks import bench_fig7_memory_accuracy as P7
from repro_torch.benchmarks import bench_fig8_efficiency as P8
from repro_torch.benchmarks import bench_fig9_quest as P9
from repro_torch.benchmarks import bench_fig10_eviction as P10
from repro_torch.benchmarks import bench_fig11_pareto as P11
from repro_torch.benchmarks import bench_fig13_patterns as P13
from repro_torch.benchmarks import bench_roofline as PROOF
from repro_torch.benchmarks import common as PC
from repro_torch.benchmarks import run as PRUN
from repro_torch.convert import flat_paths, params_from_numpy
from repro_torch.core.baselines import local_attention_gates as t_local_gates
from repro_torch.models import attention as TA
from repro_torch.models import inference as TI
from repro_torch.training import trainer as TTR

torch.set_num_threads(2)

SEQ, VOCAB = RC.SEQ, RC.VOCAB


def _needle(seed, n):
    """The reference's needle batch of ``seed`` as numpy."""
    b = needle_task(jax.random.PRNGKey(seed), n, SEQ, VOCAB, payload=2)
    return {k: np.asarray(v) for k, v in b.items()}


@pytest.fixture(scope="module")
def substrate():
    jcfg = RC.bench_cfg(lam=0.15)
    like = jax.eval_shape(lambda: JT.init_model(jax.random.PRNGKey(0), jcfg))
    jparams = JCK.restore(str(PC.CHECKPOINTS / "bench_model_lam0.15.npz"),
                          like)
    tcfg, tparams = PC.trained_model(device="cpu")
    return jcfg, jparams, tcfg, tparams


def _tau(cfg, tau, **kw):
    return cfg.replace(wgkv=dataclasses.replace(cfg.wgkv, tau=tau, **kw))


@pytest.mark.parametrize("kw", [{}, {"lam": 0.15}, {"w_local": 64,
                                                    "global_budget_frac": 0.25},
                                {"w_local": 1}])
def test_bench_cfg_equals_reference(kw):
    assert (dataclasses.asdict(PC.bench_cfg(**kw))
            == dataclasses.asdict(RC.bench_cfg(**kw)))
    assert (PC.SEQ, PC.VOCAB, PC.W_LOCAL) == (RC.SEQ, RC.VOCAB, RC.W_LOCAL)


def test_trained_model_is_the_committed_substrate(substrate):
    _, jparams, _, tparams = substrate
    got = dict(flat_paths(tparams))
    ref = {"/".join(str(p.key) for p in path): np.asarray(v)
           for path, v in jax.tree_util.tree_flatten_with_path(jparams)[0]}
    assert sorted(got) == sorted(ref)
    for k, v in got.items():
        np.testing.assert_array_equal(v.numpy(), ref[k], err_msg=k)


def test_needle_accuracy_and_fig7_overrides_equal(substrate):
    """``needle_accuracy`` at tau 0.1, fig7's local window 48 and its duo
    ratio 0.5 (heads ranked on the seed-5 calibration batch): the same
    accuracies on the reference's seed-777 batch."""
    jcfg, jparams, tcfg, tparams = substrate
    batch, calib = _needle(777, 32), _needle(5, 8)
    assert (PC.needle_accuracy(tcfg, tparams, batch=batch)
            == RC.needle_accuracy(jcfg, jparams))
    jov = j_local_gates(32, jcfg.n_kv_heads, SEQ, sink=2)
    tov = t_local_gates(32, tcfg.n_kv_heads, SEQ, sink=2)
    assert (P7._acc_with_override(_tau(tcfg, 0.1, w_local=48), tparams, tov,
                                  batch=batch)
            == R7._acc_with_override(_tau(jcfg, 0.1, w_local=48), jparams,
                                     jov))
    gout = JT.forward(jparams, jcfg, jnp.asarray(calib["tokens"]),
                      mode="gated")
    jov = jnp.stack([
        R7.duo_attention_gates(32, R7.identify_retrieval_heads(g, 0.5), SEQ,
                               sink=2) for g in gout.gates])
    tov = P7._duo_overrides(tcfg, tparams, 0.5, 32, calib)
    np.testing.assert_array_equal(tov.numpy(), np.asarray(jov))
    assert (P7._acc_with_override(tcfg, tparams, tov, batch=batch)
            == R7._acc_with_override(jcfg, jparams, jov))


@pytest.mark.parametrize("tau", [0.1, 0.3])
def test_cache_size_at_matches(substrate, tau):
    jcfg, jparams, tcfg, tparams = substrate
    got = PC.cache_size_at(tcfg, tparams, tau, batch=_needle(778, 16))
    assert got == pytest.approx(RC.cache_size_at(jcfg, jparams, tau),
                                abs=1e-6)


def test_fig9_decode_acc_quest2_equal(substrate):
    jcfg, jparams, tcfg, tparams = substrate
    jc = jcfg.replace(wgkv=dataclasses.replace(jcfg.wgkv,
                                               global_budget_frac=0.5))
    tc = tcfg.replace(wgkv=dataclasses.replace(tcfg.wgkv,
                                               global_budget_frac=0.5))
    got = P9._decode_acc(tc, tparams, TI.DecodeOptions(quest_pages=2),
                         batch=_needle(881, 16))
    assert got == R9._decode_acc(jc, jparams, JI.DecodeOptions(quest_pages=2))


def test_fig10_run_policy_equal(substrate):
    """tau 0.1 under a 24-token bound: accuracy, evictions and the first
    block's mean ``gcnt`` ([R, B, H] in both trees)."""
    jcfg, jparams, tcfg, tparams = substrate
    got = P10._run_policy(tcfg, tparams, tau=0.1, hard_budget=24,
                          batch=_needle(91, 16))
    want = R10._run_policy(jcfg, jparams, tau=0.1, hard_budget=24)
    assert got == pytest.approx(want, abs=0, rel=0)
    assert got[1] > 0


def test_fig13_per_head_sizes_equal(substrate):
    jcfg, jparams, tcfg, tparams = substrate
    key = jax.random.PRNGKey(3)
    stream = np.asarray(token_stream(key, 8, SEQ, VOCAB))
    copy = np.asarray(copy_task(key, 8, 24, SEQ - 26, VOCAB)["tokens"])
    for toks in (stream, copy):
        np.testing.assert_array_equal(
            P13._per_head_sizes(tcfg, tparams, toks),
            np.asarray(R13._per_head_sizes(jcfg, jparams, jnp.asarray(toks))))
    rows = P13.run("cpu", tokens=(stream, copy))
    assert [r[0] for r in rows][0] == "fig13/stream_mean_admission"


def test_fig1_mlp_only_logits_within_tolerance():
    """On the reference's random init (its logits are O(1); the
    substrate's reach 70, where f32 rounding alone passes 5e-5)."""
    jcfg = RC.bench_cfg()
    jparams = JT.init_model(jax.random.PRNGKey(0), jcfg)
    tcfg = PC.bench_cfg()
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg,
                                "cpu")
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (1, 256), 0,
                                         VOCAB))
    got = P1._mlp_only(tparams, tcfg, torch.as_tensor(np.array(toks))).numpy()
    want = np.asarray(R1._mlp_only(jparams, jcfg, jnp.asarray(toks)))
    np.testing.assert_allclose(got, want, atol=5e-5, rtol=0)


def test_fig11_val_loss_within_tolerance(substrate):
    jcfg, jparams, tcfg, tparams = substrate
    got = P11._val_loss(tcfg, tparams, 0.1, batch=_needle(999, 8))
    assert got == pytest.approx(R11._val_loss(jcfg, jparams, 0.1), abs=1e-5)


def test_distill_two_steps_gates_within_tolerance(substrate):
    """``_distill(steps=2)`` from the substrate at lambda 0.05 on the
    reference's two batches (seeds 10,000 and 10,001)."""
    jcfg, jparams, tcfg, tparams = substrate
    jc, tc = RC.bench_cfg(lam=0.05), PC.bench_cfg(lam=0.05)
    batches = [np.asarray(needle_task(jax.random.PRNGKey(10_000 + i), 4, SEQ,
                                      VOCAB, payload=2)["tokens"])
               for i in range(2)]
    jout, jm = RC._distill(jc, jparams, 0.05, steps=2)
    tout, tm = PC._distill(tc, tparams, 0.05, steps=2, batches=batches)
    jg = {k: np.asarray(v) for k, v in JTR.get_gates(jout).items()}
    for k, v in TTR.get_gates(tout).items():
        np.testing.assert_allclose(v.numpy(), jg[k], atol=1e-5, rtol=0,
                                   err_msg=k)
    assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-4)


def test_fig8_small_s_matches_reference(substrate):
    """Fig. 8's method at S 256 (W 64, budget 64) on the substrate's
    weights and the reference's tokens: WG-KV bytes and admission equal,
    the dense bytes the reference's scaled by the page rounding of S + 8,
    both prefills' logits within 5e-5."""
    s, budget = 256, 64
    _, jparams, _, tparams = substrate
    jcfg = RC.bench_cfg(w_local=64, global_budget_frac=0.25)
    tcfg = PC.bench_cfg(w_local=64, global_budget_frac=0.25)
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(0), (1, s), 0,
                                         VOCAB))
    jfull, jdense = JI.prefill(jparams, jcfg, jnp.asarray(toks),
                               use_wgkv=False, max_len=s + 8)
    jwg, jdual = JI.prefill(jparams, jcfg, jnp.asarray(toks), use_wgkv=True,
                            budget=budget)
    with torch.no_grad():
        tfull, tdense, twg, tdual = P8.prefills(tparams, tcfg,
                                                torch.as_tensor(toks), budget)
    for t, j in ((tfull, jfull), (twg, jwg)):
        np.testing.assert_allclose(t.logits.numpy(), np.asarray(j.logits),
                                   atol=5e-5, rtol=0)
    assert float(twg.mean_admission) == float(jwg.mean_admission)

    def jbytes(c, kv):
        return sum(leaf.nbytes for path, leaf in
                   jax.tree_util.tree_flatten_with_path(c)[0]
                   if (getattr(path[-1], "name", None) in ("k", "v")) == kv)
    rounded = TA.dense_len(s + 8)
    assert rounded == 272
    assert P8.cache_bytes(tdual) == jbytes(jdual, True) + jbytes(jdual, False)
    assert (P8.cache_bytes(tdense)
            == jbytes(jdense, True) * rounded // (s + 8) + jbytes(jdense, False))
    assert P8.unpadded_bytes(tdense, s + 8) == (jbytes(jdense, True)
                                                + jbytes(jdense, False))
    rows = dict((r[0], r[2]) for r in P8.efficiency(tcfg, tparams, (s,),
                                                    tokens={s: toks}))
    mem = dict(kv.split("=") for kv in rows["fig8/cache_bytes_s256"].split(","))
    assert int(mem["wgkv"]) == P8.cache_bytes(tdual)
    assert int(mem["full"]) == P8.cache_bytes(tdense)
    assert int(mem["full_at_s+8"]) == P8.unpadded_bytes(tdense, s + 8)
    adm = dict(kv.split("=") for kv in rows["fig8/prefill_wgkv_s256"].split(","))
    assert float(adm["mean_admission"]) == pytest.approx(
        float(jwg.mean_admission), abs=1e-6)
    assert adm["launches"] == "none"  # the CPU runs the plain versions


def _roofline_files(tmp_path):
    roof = [
        {"arch": "qwen3-0.6b", "shape": "train_4k", "bottleneck": "compute",
         "compute_s": 0.123456, "memory_s": 0.01, "collective_s": 0.0,
         "useful_ratio": 0.81234},
        {"arch": "phi3-medium-14b", "shape": "decode_32k",
         "bottleneck": "memory", "compute_s": 1e-4, "memory_s": 2.5e-2,
         "collective_s": 0.0, "useful_ratio": 0.5},
        {"arch": "smollm-360m", "shape": "prefill_32k",
         "error": "RuntimeError: something broke in a long message"},
    ]
    dry = [{"arch": "qwen3-0.6b", "shape": "train_4k"},
           {"arch": "whisper-medium", "shape": "long_500k", "skipped": True},
           {"arch": "smollm-360m", "shape": "prefill_32k", "error": "x"}]
    (tmp_path / "roofline.json").write_text(json.dumps(roof))
    (tmp_path / "dryrun.json").write_text(json.dumps(dry))


def test_bench_roofline_rows_are_the_reference_rows(tmp_path, monkeypatch):
    _roofline_files(tmp_path)
    monkeypatch.setattr(RROOF, "ART", str(tmp_path))
    got = PROOF.run(roofline_path=str(tmp_path / "roofline.json"),
                    dryrun_path=str(tmp_path / "dryrun.json"))
    assert got == RROOF.run()
    missing = PROOF.run(roofline_path=str(tmp_path / "none.json"),
                        dryrun_path=str(tmp_path / "none.json"))
    assert [r[0] for r in missing] == ["roofline/missing"]


def test_run_prints_header_and_rows(capsys):
    assert PRUN.main(["--only", "fig13", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "cpu (plain PyTorch)"
    assert lines[1] == "name,us_per_call,derived"
    names = [ln.split(",")[0] for ln in lines[2:]]
    assert names[:6] == [r for r, _, _ in P13.run("cpu")]
    assert names[6] == "fig13/_wall_s"
    assert set(PRUN.MODULES) == {"fig1", "fig7", "fig8", "fig9", "fig10",
                                 "fig11", "fig12", "fig13", "roofline",
                                 "serving"}
    assert PRUN.MODULE_KWARGS == {"serving": {"backends": ("wgkv", "dense"),
                                              "smoke": True}}


def test_run_failing_module_gives_error_row_and_exit_1(capsys, monkeypatch):
    def boom(device=None):
        raise RuntimeError("planted failure")
    monkeypatch.setattr(P13, "run", boom)
    assert PRUN.main(["--only", "fig13,roofline", "--device", "cpu"]) == 1
    out = capsys.readouterr().out
    assert "fig13/_error,0," in out and "planted failure" in out
    assert "roofline/_wall_s" in out  # the other modules still run


def test_run_serving_record_goes_to_serving_json(tmp_path, monkeypatch):
    """The runner's serving module writes its record where
    ``--serving-json`` says, by default in the temp dir: never the
    committed ``BENCH_serving_torch.json`` at the root."""
    from repro_torch.benchmarks import bench_serving as PBS
    seen = []

    def fake_run(device=None, **kw):
        seen.append(kw)
        return []
    monkeypatch.setattr(PBS, "run", fake_run)
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path / "tmp"))
    path = tmp_path / "rec.json"
    assert PRUN.main(["--only", "serving", "--device", "cpu",
                      "--serving-json", str(path)]) == 0
    assert PRUN.main(["--only", "serving", "--device", "cpu"]) == 0
    assert seen == [dict(PRUN.MODULE_KWARGS["serving"], json_path=str(p))
                    for p in (path, tmp_path / "tmp" /
                              "BENCH_serving_torch.json")]
    assert PRUN.MODULE_KWARGS["serving"] == {"backends": ("wgkv", "dense"),
                                             "smoke": True}


def test_fig8_timed_needs_the_same_launches_in_every_call(monkeypatch):
    """``_timed`` divides each counter's growth by the calls; a growth
    that is not a whole number of launches per call raises."""
    class Counter:
        def __init__(self, name):
            self.name, self.count = name, 0
    a, b = Counter("gate_mlp"), Counter("paged_decode")
    monkeypatch.setattr(P8, "kernel_counters", lambda: [a, b])

    def fake_timeit(fn, *args, iters):
        for _ in range(1 + iters):
            fn()
        return 1.0

    def even():
        a.count += 2
    monkeypatch.setattr(P8, "timeit", fake_timeit)
    assert P8._timed(even, iters=3) == (1.0, {"gate_mlp": 2})
    calls = []

    def uneven():
        calls.append(1)
        b.count += 1 if len(calls) > 1 else 0
    with pytest.raises(RuntimeError, match="paged_decode"):
        P8._timed(uneven, iters=3)
