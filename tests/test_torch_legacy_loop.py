"""The port's fixed-slot loop (``Engine.add_request`` / ``step`` /
``run``), its step-shape counts, the run-time sentinels, and the smaller
``inference`` API (``prefill_extend``), held to the reference on the CPU
with one set of numpy-drawn weights.

* ``Engine.run`` gives the reference's token streams (wgkv and dense),
  and the port's orchestrator streams the same tokens as the loop.
* ``compiled_shape_counts()`` equals the reference's jit-cache counts
  after the same replay (the loop, a fused orchestrator serve, and one
  with ``quest:2`` selection).
* ``SyncSentinel``: a naked pull between dispatch and collect raises, a
  pull inside ``step_batch`` raises, every patch is undone after a raise;
  a whole serve passes under both sentinels.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import inference as JI
from repro.serving.backend import make_backend as jax_make_backend
from repro.serving.orchestrator import Orchestrator as JOrchestrator
from repro.serving.orchestrator import SchedulerConfig as JSched
from repro_torch.analysis import (CompileBudgetExceeded, CompileSentinel,
                                  SyncSentinel, SyncViolation)
from repro_torch.models import inference as TI
from repro_torch.serving import engine as engine_module
from repro_torch.serving.backend import make_backend as torch_make_backend
from repro_torch.serving.orchestrator import Orchestrator as TOrchestrator
from repro_torch.serving.orchestrator import SchedulerConfig as TSched
from test_torch_support import parity_setup

torch.set_num_threads(2)

CHUNK = 16


@pytest.fixture(scope="module")
def served():
    return parity_setup(seed=7, global_budget_frac=0.5)


def _prompts():
    rng = np.random.default_rng(31)
    return [rng.integers(0, 500, n).tolist() for n in (40, 21, 9)]


def _loop(eng, prompts, max_new=5):
    for p in prompts:
        eng.add_request(p, max_new=max_new)
    eng.run(max_steps=40)
    return [eng.requests[r].out for r in range(len(prompts))]


@pytest.mark.parametrize("name", ["wgkv", "dense"])
def test_engine_run_matches_reference(served, name):
    """Three prompts through two slots: the third waits for a free slot,
    so admission mid-run and slot reuse are both exercised; tokens and
    step-shape counts equal the reference's."""
    jcfg, jparams, tcfg, tparams = served
    kw = dict(slots=2, capacity=128, pool_pages=512)
    jeng = jax_make_backend(name, jparams, jcfg, **kw)
    teng = torch_make_backend(name, tparams, tcfg, device="cpu", **kw)
    prompts = _prompts()
    want = _loop(jeng, prompts)
    got = _loop(teng, prompts)
    assert got == want
    assert all(len(o) == 5 for o in got)
    assert all(r.done for r in teng.requests.values())
    assert teng.slot_rid == [None, None]
    assert teng.compiled_shape_counts() == jeng.compiled_shape_counts()
    assert teng.compiled_shape_counts()["fused_step"] == 1


def test_orchestrator_stream_matches_engine_run(served):
    _, _, tcfg, tparams = served
    prompts = [list(range(10 + i, 58 + i)) for i in range(3)]
    kw = dict(slots=2, capacity=128, mirror_paged=False, device="cpu")
    want = _loop(torch_make_backend("wgkv", tparams, tcfg, **kw), prompts)
    orch = TOrchestrator(torch_make_backend("wgkv", tparams, tcfg, **kw),
                         sched=TSched(chunk_tokens=CHUNK))
    streamed = {}
    for p in prompts:
        orch.submit(p, max_new=5, on_token=lambda r, t, last:
                    streamed.setdefault(r, []).append(t))
    orch.run()
    for rid in range(len(prompts)):
        assert orch.tokens(rid) == want[rid]
        assert streamed[rid] == want[rid]


def _fused_serve(orch_cls, sched_cls, eng, lens, max_new):
    orch = orch_cls(eng, sched=sched_cls(chunk_tokens=CHUNK,
                                         dispatch_ahead=1))
    for n in lens:
        orch.submit(list(range(2, 2 + n)), max_new=max_new)
    orch.run()
    return [orch.tokens(r) for r in range(len(lens))]


@pytest.mark.parametrize("selection", [None, "quest:2"])
def test_shape_counts_match_reference_replay(served, selection):
    """A fused serve (chunked prefill, decode-only ticks, dispatch-ahead
    1): the port dispatches the shapes the reference compiles, (slots,
    chunk) and (slots, 1), and with selection the (slots, 1) variant."""
    jcfg, jparams, tcfg, tparams = served
    kw = dict(slots=4, capacity=128, mirror_paged=False, selection=selection)
    lens, max_new = ((48, 55, 10, 33), 4) if selection is None \
        else ((48, 10), 6)
    jeng = jax_make_backend("wgkv", jparams, jcfg, **kw)
    teng = torch_make_backend("wgkv", tparams, tcfg, device="cpu", **kw)
    want = _fused_serve(JOrchestrator, JSched, jeng, lens, max_new)
    with CompileSentinel(teng) as cs, SyncSentinel(teng) as ss:
        got = _fused_serve(TOrchestrator, TSched, teng, lens, max_new)
        counts = cs.check()
    assert got == want
    assert counts == jeng.compiled_shape_counts()
    # with selection every decode-only tick runs the selection variant
    assert counts["fused_step"] == (1 if selection else 2)
    assert counts["extend_batch"] == 0
    assert counts.get("fused_step_sel", 0) == (1 if selection else 0)
    assert ss.syncs_in_collect > 0


def test_sync_sentinel_trips_on_naked_pull(served):
    """A pull between dispatch and collect raises, and every patch is
    undone after the raise."""
    _, _, tcfg, tparams = served
    eng = torch_make_backend("wgkv", tparams, tcfg, slots=4, capacity=128,
                             mirror_paged=False, device="cpu")
    origs = {n: getattr(torch.Tensor, n)
             for n in ("cpu", "item", "tolist", "numpy")}
    host = engine_module._host
    t = eng.start_prefill(list(range(2, 30)))
    t.slot = 0
    with pytest.raises(SyncViolation, match="Tensor.cpu"):
        with SyncSentinel(eng):
            step = eng.step_batch([t], CHUNK)
            step.tokens.cpu()                  # naked pre-collect pull
    assert {n: getattr(torch.Tensor, n) for n in origs} == origs
    assert all(n not in vars(torch.Tensor) for n in origs)
    assert engine_module._host is host
    assert "step_batch" not in vars(eng) and "collect" not in vars(eng)
    eng.collect(step)                          # settle for hygiene
    with SyncSentinel(eng) as ss:
        t2 = eng.start_prefill(list(range(5, 20)))
        t2.slot = 1
        step = eng.step_batch([t2], CHUNK)
        eng.memory_snapshot()                  # sanctioned: fine
        eng.collect(step)
        step.tokens.tolist()                   # collected: fine again
    assert ss.syncs_in_collect > 0


class _FakeEngine:
    COMPILE_SHAPE_BUDGETS = {"fused_step": 2}

    def __init__(self, shapes=2):
        self.shapes = shapes

    def compiled_shape_counts(self):
        return {"fused_step": self.shapes}

    def step_batch(self, tasks, chunk=16):
        return object()

    def collect(self, step):
        return engine_module._host(torch.zeros(1))

    def memory_snapshot(self):
        return {"x": torch.ones(()).item()}


def test_sync_sentinel_contract():
    eng = _FakeEngine()
    with SyncSentinel(eng) as ss:
        torch.zeros(1).tolist()                # nothing in flight: fine
        step = eng.step_batch([])
        with pytest.raises(SyncViolation, match="collect"):
            torch.zeros(1).item()              # naked pull mid-flight
        with pytest.raises(SyncViolation):
            engine_module._host(torch.zeros(1))
        eng.memory_snapshot()                  # sanctioned frame: fine
        eng.collect(step)
        torch.zeros(1).numpy()                 # collected: fine again
    assert ss.syncs_in_collect >= 2            # collect + memory_snapshot
    assert not ss.cuda                         # no device: no debug mode


def test_sync_sentinel_dispatch_must_not_block():
    class _BadDispatch(_FakeEngine):
        def step_batch(self, tasks, chunk=16):
            return torch.zeros(1).item()       # a pull inside dispatch

    eng = _BadDispatch()
    cpu = torch.Tensor.cpu
    with pytest.raises(SyncViolation):
        with SyncSentinel(eng):
            eng.step_batch([])
    assert torch.Tensor.cpu is cpu             # restored even on unwind
    assert "item" not in vars(torch.Tensor)
    assert "step_batch" not in vars(eng)


def test_compile_sentinel_within_and_over_budget():
    with CompileSentinel(_FakeEngine(2)) as cs:
        assert cs.check() == {"fused_step": 2}
    with pytest.raises(CompileBudgetExceeded, match="recompile stall"):
        with CompileSentinel(_FakeEngine(3)):
            pass
    with CompileSentinel(_FakeEngine(3), budgets={"fused_step": 5}):
        pass
    with pytest.raises(ValueError, match="no shape budgets"):
        CompileSentinel(object())


# ==========================================================================
# the smaller inference API
# ==========================================================================
def test_prefill_extend_matches_reference(served):
    jcfg, jparams, tcfg, tparams = served
    toks = np.random.default_rng(5).integers(0, 500, (2, 40)).astype(
        np.int32)
    _, jc = JI.prefill(jparams, jcfg, jnp.asarray(toks[:, :32]),
                       max_len=64)
    jl, jc, jst = JI.prefill_extend(jparams, jcfg, jnp.asarray(toks[:, 32:]),
                                    jc)
    with torch.no_grad():
        _, tc = TI.prefill(tparams, tcfg, torch.from_numpy(toks[:, :32]),
                           max_len=64)
        tl, tc, tst = TI.prefill_extend(tparams, tcfg,
                                        torch.from_numpy(toks[:, 32:]), tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=5e-5,
                               rtol=0)
    for k in ("evict_triggers", "mean_admission"):
        np.testing.assert_allclose(float(tst[k]), float(jst[k]), atol=1e-6)
    assert 0.0 < float(tst["mean_admission"]) < 1.0
    node, jnode = tc["blocks"]["b0"], jc["blocks"]["b0"]
    np.testing.assert_array_equal(node.gcnt.numpy(), np.asarray(jnode.gcnt))
    np.testing.assert_array_equal(tc["t"].numpy(), np.asarray(jc["t"]))
    np.testing.assert_allclose(node.lk.numpy(), np.asarray(jnode.lk),
                               atol=5e-5, rtol=0)
