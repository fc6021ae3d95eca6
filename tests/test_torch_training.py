"""The port's gate-distillation training against the reference on the CPU:
the losses, AdamW and its schedule, ``train_step`` (loss, aux and the
gate gradients) on reduced qwen3-0.6b and on the bench substrate's config,
``remat``, checkpoint files in both directions, ``run_training`` and the
synthetic needle task.

One set of weights for both packages (the reference's init or the
committed substrate, carried over with ``params_from_numpy``) and the
same numpy tokens: the port draws data from a ``torch.Generator``, which
cannot reproduce ``jax.random``. Limits: losses and aux 1e-5 relative;
gate gradients 1e-5 of the largest magnitude of each reference gradient
(float32 sums in other orders through several layers); the optimizer on
identical gradients 1e-6. Parameters after an Adam step are not compared
across the packages: its first step is about lr sign(grad), and a
gradient element near 0 may take either sign in two correct
implementations.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JModelConfig
from repro.configs.base import WGKVConfig as JWGKVConfig
from repro.core import losses as JL
from repro.data import synthetic as JSYN
from repro.models import transformer as JT
from repro.training import checkpoint as JCK
from repro.training import optimizer as JOPT
from repro.training import trainer as JTR
from repro_torch.configs.base import ModelConfig as TModelConfig
from repro_torch.configs.base import WGKVConfig as TWGKVConfig
from repro_torch.convert import flat_paths, params_from_numpy
from repro_torch.core import losses as TL
from repro_torch.data import synthetic as TSYN
from repro_torch.launch import train as TLAUNCH
from repro_torch.training import checkpoint as TCK
from repro_torch.training import optimizer as TOPT
from repro_torch.training import trainer as TTR
from test_torch_prefill import SUBSTRATE, _substrate_cfg
from test_torch_support import parity_setup

torch.set_num_threads(2)

REL = 1e-5


def _rel_close(got, want, rel=REL):
    got, want = float(got), float(want)
    assert abs(got - want) <= rel * max(abs(want), 1e-30), (got, want)


def _max_close(got, want, rel=REL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= rel, f"max |d| / max |ref| = {err:.3e} > {rel:.0e}"


# ==========================================================================
# losses and the optimizer
# ==========================================================================
@pytest.mark.parametrize("masked", [False, True])
def test_total_loss_matches(masked):
    rng = np.random.default_rng(0)
    hs = rng.standard_normal((2, 24, 16)).astype(np.float32)
    ht = rng.standard_normal((2, 24, 16)).astype(np.float32)
    gates = rng.uniform(0, 1, (3, 2, 4, 24)).astype(np.float32)
    mask = (rng.uniform(size=(2, 24)) < 0.4).astype(np.float32) \
        if masked else None
    jl, jaux = JL.total_loss(jnp.asarray(hs), jnp.asarray(ht),
                             jnp.asarray(gates), 0.3,
                             None if mask is None else jnp.asarray(mask))
    tl, taux = TL.total_loss(torch.from_numpy(hs), torch.from_numpy(ht),
                             torch.from_numpy(gates), 0.3,
                             None if mask is None else torch.from_numpy(mask))
    _rel_close(tl, jl)
    assert set(taux) == set(jaux)
    for k in jaux:
        _rel_close(taux[k], jaux[k])
    # the [B, T] mask also weights a flat [B, T] gate tensor
    if masked:
        _rel_close(TL.sparsity_loss(torch.from_numpy(gates[0, :, 0]),
                                    torch.from_numpy(mask)),
                   JL.sparsity_loss(jnp.asarray(gates[0, :, 0]),
                                    jnp.asarray(mask)))


def test_cosine_schedule_matches():
    jlr, tlr = JOPT.cosine_schedule(1e-3, 40), TOPT.cosine_schedule(1e-3, 40)
    for step in range(0, 45):
        assert abs(float(tlr(step)) - float(jlr(step))) <= 1e-9


def test_adamw_update_matches_on_identical_gradients():
    """Five steps of AdamW from the same parameters and the same gradient
    draws, with the cosine schedule and with a constant rate."""
    rng = np.random.default_rng(1)
    shapes = {"a": (3, 5), "b/c": (7,)}
    p_np = {k: rng.standard_normal(s).astype(np.float32)
            for k, s in shapes.items()}
    for lr in (JOPT.cosine_schedule(1e-2, 5), 1e-2):
        tlr = TOPT.cosine_schedule(1e-2, 5) if callable(lr) else lr
        jp = {k: jnp.asarray(v) for k, v in p_np.items()}
        tp = {k: torch.from_numpy(v.copy()) for k, v in p_np.items()}
        js, ts = JOPT.adamw_init(jp), TOPT.adamw_init(tp)
        for _ in range(5):
            g_np = {k: rng.standard_normal(s).astype(np.float32)
                    for k, s in shapes.items()}
            jp, js = JOPT.adamw_update({k: jnp.asarray(v)
                                        for k, v in g_np.items()},
                                       js, jp, lr=lr)
            tp, ts = TOPT.adamw_update({k: torch.from_numpy(v)
                                        for k, v in g_np.items()},
                                       ts, tp, lr=tlr)
            for k in shapes:
                np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                           atol=1e-6, rtol=0)
                np.testing.assert_allclose(ts.m[k].numpy(),
                                           np.asarray(js.m[k]), atol=1e-6,
                                           rtol=0)
                np.testing.assert_allclose(ts.v[k].numpy(),
                                           np.asarray(js.v[k]), atol=1e-6,
                                           rtol=0)
        assert int(ts.step) == int(js.step) == 5


# ==========================================================================
# train_step against the reference
# ==========================================================================
def _qwen3_setup():
    """Reduced qwen3-0.6b (``conftest.make_cfg``: W 16) with gate weights
    whose scores spread across tau."""
    return parity_setup(seed=4)


def _substrate_setup():
    jcfg = _substrate_cfg((JModelConfig, JWGKVConfig))
    tcfg = _substrate_cfg((TModelConfig, TWGKVConfig))
    jparams = JCK.restore(str(SUBSTRATE),
                          JT.init_model(jax.random.PRNGKey(0), jcfg))
    return jcfg, jparams, tcfg, params_from_numpy(SUBSTRATE, tcfg, "cpu")


def _batches(vocab, seed, n, b=2, s=64, masked=False):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        toks = rng.integers(0, vocab - 8, (b, s)).astype(np.int32)
        mask = ((rng.uniform(size=(b, s)) < 0.5).astype(np.float32)
                if masked else None)
        out.append((toks, mask))
    return out


def _jbatch(toks, mask):
    return {"tokens": jnp.asarray(toks),
            "loss_mask": None if mask is None else jnp.asarray(mask)}


def _tbatch(toks, mask):
    return {"tokens": torch.from_numpy(toks),
            "loss_mask": None if mask is None else torch.from_numpy(mask)}


def _ref_value_and_grad(jcfg, lam):
    """The reference's ``jax.value_and_grad`` of its distillation loss,
    jitted (the gates' gradient, as its ``train_step`` takes it)."""
    def fn(gates, params, batch):
        return JTR.distill_loss_fn(gates, params, jcfg, batch, lam=lam)
    return jax.jit(jax.value_and_grad(fn, has_aux=True))


def _assert_step_matches(setup, masked, lam):
    jcfg, jparams, tcfg, tparams = setup
    (toks, mask), = _batches(tcfg.vocab_size, 7, 1, masked=masked)
    (jloss, jaux), jgrads = _ref_value_and_grad(jcfg, lam)(
        JTR.get_gates(jparams), jparams, _jbatch(toks, mask))
    tloss, taux, tgrads = TTR.loss_and_grads(TTR.get_gates(tparams), tparams,
                                             tcfg, _tbatch(toks, mask),
                                             lam=lam)
    _rel_close(tloss, jloss)
    assert set(taux) == set(jaux)
    for k in jaux:
        _rel_close(taux[k], jaux[k])
    assert sorted(tgrads) == sorted(jgrads)
    assert "blocks/b0/attn/gate/w1" in tgrads
    for k in jgrads:
        _max_close(tgrads[k].numpy(), np.asarray(jgrads[k]))
    # train_step reports that loss and aux (the reference's train_step
    # reports its value_and_grad's) and takes one optimizer step
    tstate, tm = TTR.train_step(TTR.init_train_state(tparams), tparams, tcfg,
                                _tbatch(toks, mask), lr=1e-3, lam=lam)
    assert set(tm) == set(jaux) | {"loss"}
    _rel_close(tm["loss"], jloss)
    for k in jaux:
        _rel_close(tm[k], jaux[k])
    assert int(tstate.opt.step) == 1


@pytest.mark.parametrize("masked", [False, True])
def test_train_step_matches_reference_on_reduced_qwen3(masked):
    _assert_step_matches(_qwen3_setup(), masked, lam=0.3)


def test_train_step_matches_reference_on_the_substrate():
    _assert_step_matches(_substrate_setup(), False, lam=0.15)


def test_train_steps_track_the_reference_on_the_substrate():
    """Three steps from the same state on the same tokens: every step's
    loss and aux within 1e-5 relative of the reference's."""
    jcfg, jparams, tcfg, tparams = _substrate_setup()
    lr = 1e-3
    js, ts = JTR.init_train_state(jparams), TTR.init_train_state(tparams)
    jstep = JTR.make_train_step(jcfg, lr=lr, donate=False)
    for toks, mask in _batches(tcfg.vocab_size, 8, 3, s=128):
        js, jm = jstep(js, jparams, batch=_jbatch(toks, mask))
        ts, tm = TTR.train_step(ts, tparams, tcfg, _tbatch(toks, mask),
                                lr=lr)
        for k in jm:
            _rel_close(tm[k], jm[k])


def test_remat_gives_the_same_gradients():
    _, _, tcfg, tparams = _qwen3_setup()
    (toks, mask), = _batches(tcfg.vocab_size, 9, 1)
    gates = TTR.get_gates(tparams)
    l0, a0, g0 = TTR.loss_and_grads(gates, tparams, tcfg,
                                    _tbatch(toks, mask), lam=0.3)
    l1, a1, g1 = TTR.loss_and_grads(gates, tparams, tcfg,
                                    _tbatch(toks, mask), lam=0.3, remat=True)
    assert torch.equal(l0, l1)
    for k in g0:
        torch.testing.assert_close(g1[k], g0[k], atol=1e-7, rtol=1e-6)


def test_train_step_leaves_the_backbone_alone():
    _, _, tcfg, tparams = _qwen3_setup()
    before = {k: v.clone() for k, v in flat_paths(tparams)}
    state = TTR.init_train_state(tparams)
    (toks, mask), = _batches(tcfg.vocab_size, 10, 1)
    state2, _ = TTR.train_step(state, tparams, tcfg, _tbatch(toks, mask),
                               lr=1e-2, lam=0.3)
    merged = TTR.set_gates(tparams, state2.gates)
    for k, v in flat_paths(merged):
        if "gate" in k.split("/"):
            assert not torch.equal(v, before[k]), k
        else:
            assert torch.equal(v, before[k]) and not v.requires_grad, k


def test_lm_loss_and_step_match_reference():
    """Full-parameter LM training: the loss and the gradient of every
    leaf (the gates' are zero: the teacher forward does not use them)."""
    jcfg, jparams, tcfg, tparams = _qwen3_setup()
    (toks, _), = _batches(tcfg.vocab_size, 11, 1, s=32)
    (jl, jaux), jg = jax.jit(jax.value_and_grad(
        lambda p, b: JTR.lm_loss_fn(p, jcfg, b), has_aux=True))(
        jparams, _jbatch(toks, None))
    ts, tm = TTR.lm_train_step(TTR.init_lm_train_state(tparams), tcfg,
                               _tbatch(toks, None), lr=1e-3)
    _rel_close(tm["loss"], jl)
    _rel_close(tm["lm_loss"], jaux["lm_loss"])
    assert int(ts.opt.step) == 1
    # the gradient the step took: its first moment is (1 - b1) grad
    tgrads = {k: v / 0.1 for k, v in flat_paths(ts.opt.m)}
    for path, leaf in jax.tree_util.tree_flatten_with_path(jg)[0]:
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                       for p in path)
        _max_close(tgrads[key].numpy(), np.asarray(leaf), rel=1e-4)


# ==========================================================================
# checkpoints, the training entry point, data
# ==========================================================================
def test_gate_checkpoints_interchange(tmp_path):
    jcfg, jparams, tcfg, tparams = _qwen3_setup()
    tgates = {k: v + 0.5 for k, v in TTR.get_gates(tparams).items()}
    tpath = str(tmp_path / "port.npz")
    TCK.save(tpath, tgates, meta={"arch": tcfg.name})
    jgot = JCK.restore(tpath, JTR.get_gates(jparams))
    assert sorted(jgot) == sorted(tgates)
    for k in tgates:
        np.testing.assert_array_equal(np.asarray(jgot[k]), tgates[k].numpy())
    assert TCK.load_meta(tpath) == JCK.load_meta(tpath) == {"arch": tcfg.name}
    jgates = {k: v * 2.0 for k, v in JTR.get_gates(jparams).items()}
    jpath = str(tmp_path / "ref.npz")
    JCK.save(jpath, jgates)
    tgot = TCK.restore(jpath, TTR.get_gates(tparams), device="cpu")
    for k in jgates:
        np.testing.assert_array_equal(tgot[k].numpy(), np.asarray(jgates[k]))
    # the whole train state (a NamedTuple with the optimizer's) round-trips
    state = TTR.init_train_state(tparams)
    TCK.save(str(tmp_path / "state.npz"), state)
    back = TCK.restore(str(tmp_path / "state.npz"), state)
    assert isinstance(back, TTR.TrainState)
    assert back.opt.step.dtype == torch.int32


def test_run_training_reduces_loss_and_sparsifies():
    """The reference's ``test_training_reduces_loss_and_sparsifies`` for
    the port: 25 steps from a random backbone on the CPU."""
    tcfg = _qwen3_setup()[2]
    params, state, hist = TLAUNCH.run_training(
        tcfg, steps=25, batch=2, seq=96, lam=0.3, verbose=False,
        device="cpu")
    assert hist[-1]["loss"] < hist[0]["loss"]
    assert hist[-1]["mean_gate"] < 0.6  # pushed down from the ~0.73 init
    assert hist[-1]["distill"] < hist[0]["distill"] * 3
    assert all(np.isfinite(h["loss"]) for h in hist)


def test_train_cli_on_the_cpu_and_refusals(tmp_path):
    out = str(tmp_path / "gates.npz")
    res = TLAUNCH.main(["--arch", "qwen3-0.6b", "--reduced", "--device",
                        "cpu", "--steps", "2", "--batch", "1", "--seq", "32",
                        "--out", out, "--log-every", "1"])
    assert [h["step"] for h in res["history"]] == [0, 1]
    assert res["cfg"].dtype == "float32"
    assert TCK.load_meta(out)["steps"] == 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            TLAUNCH.main(["--arch", "qwen3-0.6b", "--reduced", "--steps",
                          "1"])


def test_needle_task_structure():
    """The reference's ``test_needle_task_structure`` for the port."""
    b = TSYN.needle_task(torch.Generator().manual_seed(0), 4, 128, 512,
                         payload=3)
    toks, ans = b["tokens"].numpy(), b["answer"].numpy()
    npos, qpos = b["needle_pos"].numpy(), int(b["query_pos"])
    for i in range(4):
        assert toks[i, npos[i]] == 511
        assert (toks[i, npos[i] + 1: npos[i] + 4] == ans[i]).all()
        assert toks[i, qpos] == 511
        assert (toks[i, qpos + 1: qpos + 4] == ans[i]).all()
    assert b["loss_mask"].sum() == 4 * 3
    assert b["tokens"].dtype == torch.int32
    t = TSYN.token_stream(torch.Generator().manual_seed(1), 2, 256, 1000)
    assert int(t.min()) >= 0 and int(t.max()) < 1000 - 8


def test_lm_loss_matches():
    rng = np.random.default_rng(12)
    logits = rng.standard_normal((2, 9, 33)).astype(np.float32)
    toks = rng.integers(0, 33, (2, 9)).astype(np.int32)
    mask = (rng.uniform(size=(2, 9)) < 0.5).astype(np.float32)
    for m in (None, mask):
        _rel_close(TSYN.lm_loss(torch.from_numpy(logits),
                                torch.from_numpy(toks),
                                None if m is None else torch.from_numpy(m)),
                   JSYN.lm_loss(jnp.asarray(logits), jnp.asarray(toks),
                                None if m is None else jnp.asarray(m)))
