"""xlstm-350m on a ``data x model`` mesh, full-parameter LM training on a
mesh, and the gradient through an MoE routing group gathered over
"data", held to the UNSHARDED reference on the CPU over ``gloo`` ranks.

Reduced xlstm-350m (d 256, 2 heads; the mLSTM 512 wide at head width
256, the sLSTM at 128, its MLP 170 wide; one repeat of (mLSTM, sLSTM);
f32), the reference's weights carried across by ``convert.py``. Two
worlds are spawned (2 and 4 ranks), each running two meshes, while the
parent runs the reference: 1 x 2 (the blocks split by head, the MLP by
its width), 2 x 1 (rows and FSDP over "data"), 2 x 2 (both), and 1 x 4
(2 heads do not divide 4: the blocks stay whole). On each, from the
rank bodies of ``tests/torch_xlstm_worker.py``:

* the train bundle's full-parameter step at 2 x 32 (remat, a loss mask
  with zeros), from AdamW step 749 so that it runs at the peak rate,
  against the reference's ``lm_train_step``: the loss within 1e-5
  relative; every leaf's gradient (``trainer.lm_loss_and_grads``, summed
  over the ranks) and both AdamW moments within 5e-5 of that leaf's own
  scale of the rank's block of the reference's (``rules.local_params``,
  FSDP placement); the new params within 5e-5 of their scale of the
  reference's AdamW step on the rank's blocks and gradient;
* a prefill at 2 x 32 and 8 greedy decode steps on its states: tokens
  equal, logits within 5e-5 of their scale, every state leaf's block
  (``rules.cache_placement``) within 5e-5;
* rank 0's collective bytes by axis equal to a ``fake``-group meta run
  of the same bundles and to ``torch_mesh_counts``' count from the
  shapes.

Where "data" has two ranks (2 x 1 and 2 x 2), reduced
granite-moe-3b-a800m's ``moe_ffn(groups=1)`` over 2 x 8 tokens split by
row: the gradients of ``<y, c> + 0.01 lb`` (a numpy cotangent ``c``,
scaled so that the load-balance term's share of the gradients shows)
with respect to x (the rank's rows), the router and the experts (the
rank's blocks, summed over "data") equal the reference's ``jax.grad`` of
the same whole group within 5e-5 of each gradient's largest magnitude.

At full width (xlstm-350m, d 1,024, 4 heads) the fake-group meta run's
collective bytes of train_4k and decode_32k on 16 x 16 (the blocks
whole) and 2 x 4 (split by head) equal the count from the shapes.
"""
import concurrent.futures
import multiprocessing

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_cfg
from repro.models import inference as JI
from repro.models import moe as JM
from repro.models import transformer as JT
from repro.sharding.rules import _path_keys
from repro.training import optimizer as JOPT
from repro.training import trainer as JTR
from repro.training.optimizer import cosine_schedule
from repro_torch.configs import get_config, get_shape
from repro_torch.kernels.ops import _identity_tables
from repro_torch.launch import mesh as M
from repro_torch.launch.steps import make_bundle
from repro_torch.roofline.counter import WorkCounter
from repro_torch.sharding import rules as R
from test_torch_support import port_cfg
from torch_mesh_counts import mesh_collective_bytes
from torch_xlstm_worker import (BATCH, DECODE_STEPS, PREFILL, S,
                                START_STEP, TRAIN, full_width_counts,
                                xlstm_meshes)

torch.set_num_threads(2)

WORLDS = {(1, 2): [(1, 2), (2, 1)], (2, 2): [(2, 2), (1, 4)]}
MESHES = [(1, 2), (2, 1), (2, 2), (1, 4)]
FULL_MESHES = [(16, 16), (2, 4)]
FULL_SHAPES = ["train_4k", "decode_32k"]
MOE_S = 8
TIMEOUT_S = 240
TOL = 5e-5


def _data():
    rng = np.random.default_rng(11)
    mask = np.ones((BATCH, S), np.float32)
    mask[1, -6:] = 0.0
    return {"train_tokens": rng.integers(0, 512, (BATCH, S),
                                         dtype=np.int32),
            "loss_mask": mask,
            "prefill_tokens": rng.integers(0, 512, (BATCH, S),
                                           dtype=np.int32)}


def _jtree(tree):
    return {_path_keys(p): np.asarray(x) for p, x in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _flat(tree):
    """{``/``-joined path: numpy} of a parameter tree."""
    return {"/".join(k): v for k, v in _jtree(tree).items()}


def _reference(jcfg, jparams, data, mcfg, mparams, x, c):
    out = {}
    batch = {"tokens": jnp.asarray(data["train_tokens"]),
             "loss_mask": jnp.asarray(data["loss_mask"])}
    lr = cosine_schedule(1e-3, 7500)
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p, b: JTR.lm_loss_fn(p, jcfg, b, remat=True),
        has_aux=True))(jparams, batch)
    state = JTR.init_lm_train_state(jparams)
    state = state._replace(opt=state.opt._replace(
        step=jnp.asarray(START_STEP, jnp.int32)))
    state, aux = jax.jit(lambda st, b: JTR.lm_train_step(
        st, jcfg, b, lr=lr, remat=True))(state, batch)
    out["train"] = {"loss": float(loss), "grads": _flat(grads),
                    "aux": {k: float(v) for k, v in aux.items()},
                    "m": _flat(state.opt.m), "v": _flat(state.opt.v),
                    "old": _flat(jparams)}
    o, caches = JI.prefill(jparams, jcfg, jnp.asarray(data["prefill_tokens"]),
                           use_wgkv=False, budget=jcfg.wgkv.global_budget(S),
                           max_len=S + 64)
    step = jax.jit(lambda t, cs: JI.decode_step(jparams, jcfg, t, cs))
    token = jnp.argmax(o.logits, -1).astype(jnp.int32)
    steps = []
    for _ in range(DECODE_STEPS):
        logits, caches, _ = step(token, caches)
        token = jnp.argmax(logits, -1).astype(jnp.int32)
        steps.append((np.asarray(logits), np.asarray(token)))
    out["serve"] = {"logits": np.asarray(o.logits), "steps": steps,
                    "states": _jtree(caches)}
    p0 = {k: v[0] for k, v in mparams["blocks"]["b0"]["moe"].items()}

    def moe_loss(xx, p):
        y, a = JM.moe_ffn(p, mcfg, xx, groups=1)
        return (y * c).sum() + 0.01 * a["lb_loss"]
    gx, gp = jax.grad(moe_loss, argnums=(0, 1))(jnp.asarray(x), p0)
    out["moe"] = {"x": np.asarray(gx),
                  **{k: np.asarray(v) for k, v in gp.items()}}
    return out


@pytest.fixture(scope="module")
def runs():
    jcfg = make_cfg("xlstm-350m")
    tcfg = port_cfg(jcfg)
    params_np = jax.tree.map(
        np.asarray, jax.jit(JT.init_model, static_argnums=1)(
            jax.random.PRNGKey(0), jcfg))
    mcfg = make_cfg("granite-moe-3b-a800m")
    mparams = jax.tree.map(
        np.asarray, jax.jit(JT.init_model, static_argnums=1)(
            jax.random.PRNGKey(1), mcfg))
    rng = np.random.default_rng(12)
    x = rng.standard_normal((BATCH, MOE_S, mcfg.d_model)).astype(np.float32)
    # the cotangent's scale puts <y, c>'s gradients within a few hundred
    # times 0.01 lb's, so a load-balance term counted per rank shows
    c = (1e-6 * rng.standard_normal(x.shape)).astype(np.float32)
    data = _data()
    moe = (port_cfg(mcfg), mparams, x, c)
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ThreadPoolExecutor(len(WORLDS)) as ex, \
            concurrent.futures.ProcessPoolExecutor(1, mp_context=ctx) as pe:
        full = pe.submit(full_width_counts, FULL_SHAPES, FULL_MESHES)
        futs = [ex.submit(M.spawn, xlstm_meshes, world,
                          args=(tcfg, params_np, data, shapes, moe),
                          device="cpu", timeout_s=TIMEOUT_S)
                for world, shapes in WORLDS.items()]
        ref = _reference(jcfg, jax.tree.map(jnp.asarray, params_np), data,
                         mcfg, jax.tree.map(jnp.asarray, mparams), x, c)
        mesh = {}
        for fut in futs:
            for rank, res in fut.result().items():
                for shape, out in res.items():
                    mesh.setdefault(shape, {})[rank] = out
        full = full.result()
    return tcfg, ref, mesh, full


def _close(got, want, tol, what, floor=1.0):
    """Within ``tol`` of the larger of ``want``'s largest magnitude and
    ``floor``; integers exact."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    if not np.issubdtype(want.dtype, np.floating):
        np.testing.assert_array_equal(got, want, err_msg=str(what))
        return
    scale = max(float(np.abs(want).max()), floor)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale,
                               err_msg=str(what))


def _mesh(shape):
    return dict(zip(("data", "model"), shape))


def _param_block(tcfg, shape, coords, key, leaf, replicate_fsdp=False):
    """The rank's block of a whole parameter leaf (``rules.local_params``'
    placement)."""
    path = tuple(key.split("/"))
    spec = R.param_placement(path, leaf.shape, _mesh(shape), tcfg,
                             replicate_fsdp=replicate_fsdp)
    return R.local_shard(torch.from_numpy(np.array(leaf)), spec, coords,
                         _mesh(shape), R.gate_parts(path, tcfg)).numpy()


def _rows(shape, coords, batch=BATCH):
    mesh = _mesh(shape)
    return R.block(batch, R.tokens_spec(mesh, batch, 0)[0], coords, mesh)


def test_xlstm_plans_split_by_head_or_stay_whole(runs):
    """The reduced config splits at model 2 (its MLP too) and stays whole
    at model 4; every rank holds the blocks the plan says."""
    tcfg, _, mesh, _ = runs
    assert R.tp_plan(tcfg, _mesh((1, 2))).xlstm
    assert not R.tp_plan(tcfg, _mesh((1, 4))).xlstm
    for shape in MESHES:
        for out in mesh[shape].values():
            split = R.tp_plan(tcfg, _mesh(shape)).xlstm
            w_q = out["train"]["params"]["blocks/b0/cell/w_q"]
            assert w_q.shape[-1] == 512 // (shape[1] if split else 1)


def _adamw_of(old, grads):
    """The reference's AdamW step from :data:`START_STEP` on the rank's
    blocks ``old`` with the gradients ``grads`` ({path: numpy})."""
    st = JOPT.AdamWState(jnp.asarray(START_STEP, jnp.int32),
                         {k: jnp.zeros_like(v) for k, v in old.items()},
                         {k: jnp.zeros_like(v) for k, v in old.items()})
    new, _ = JOPT.adamw_update(grads, st, old,
                               lr=cosine_schedule(1e-3, 7500))
    return {k: np.asarray(v) for k, v in new.items()}


@pytest.mark.parametrize("shape", MESHES)
def test_full_parameter_train_step_matches_reference(runs, shape):
    """The step runs at the schedule's peak rate (AdamW step 750), where
    its update (about 2.3e-3 an element) shows. Every gradient and both
    moments are held to the rank's block of the reference's within 5e-5
    of that leaf's own largest magnitude. The new params are held, at
    the same tolerance of their own scale, to the reference's AdamW step
    applied to the rank's blocks with the rank's gradient: at a rate
    that shows the update, AdamW's step of an element whose gradient
    lies within f32 rounding of 0 (slope lr / eps there) is not fixed
    by a gradient that agrees to the tolerance."""
    tcfg, ref, mesh, _ = runs
    want = ref["train"]
    for rank, out in mesh[shape].items():
        got = out["train"]
        assert abs(got["loss"] - want["loss"]) <= 1e-5 * abs(want["loss"])
        for k, v in want["aux"].items():
            assert abs(got["aux"][k] - v) <= 1e-5 * max(abs(v), 1e-3), \
                (shape, rank, k, got["aux"][k], v)
        for part in ("grads", "m", "v"):
            assert set(got[part]) == set(want[part]), part
            for key, leaf in want[part].items():
                block = _param_block(tcfg, shape, out["coords"], key, leaf)
                _close(got[part][key], block, TOL,
                       (shape, rank, part, key), 0.0)
        assert set(got["params"]) == set(want["old"])
        old = {key: _param_block(tcfg, shape, out["coords"], key, leaf)
               for key, leaf in want["old"].items()}
        new = _adamw_of(old, got["grads"])
        for key, leaf in new.items():
            assert np.abs(leaf - old[key]).max() > 1e-3, key
            _close(got["params"][key], leaf, TOL,
                   (shape, rank, "params", key), 0.0)


@pytest.mark.parametrize("shape", MESHES)
def test_prefill_and_decode_match_reference(runs, shape):
    tcfg, ref, mesh, _ = runs
    want = ref["serve"]
    m = _mesh(shape)
    for rank, out in mesh[shape].items():
        got = out["serve"]
        rows = _rows(shape, out["coords"])
        _close(got["logits"], want["logits"][rows], TOL,
               (shape, rank, "prefill"))
        for i, ((lg, tok), (rlg, rtok)) in enumerate(zip(
                got["steps"], want["steps"])):
            np.testing.assert_array_equal(tok, rtok[rows])
            _close(lg, rlg[rows], TOL, (shape, rank, "decode", i))
        assert set(got["states"]) == set(want["states"])
        for path, leaf in want["states"].items():
            spec = R.cache_placement(path, leaf.shape, m, tcfg)
            block = R.local_shard(torch.from_numpy(np.array(leaf)), spec,
                                  out["coords"], m).numpy()
            _close(got["states"][path], block, TOL, (shape, rank, path))


def _meta_collectives(tcfg, shape):
    """Rank (0, 0)'s collective bytes of the train step and the prefill
    on meta, over a fake group that stands for gloo."""
    out = {}
    with M.fake_mesh(shape, backend="gloo") as mesh:
        for name, kind in (("train", TRAIN), ("prefill", PREFILL)):
            bd = make_bundle(tcfg, kind, use_wgkv=False, mesh=mesh)
            _identity_tables.cache_clear()
            with WorkCounter() as wc:
                bd.fn(*bd.args)
            out[name] = dict(wc.record()["collective_bytes_by_axis"])
    return out


@pytest.mark.parametrize("shape", MESHES)
def test_rank0_collectives_equal_meta_and_the_count(runs, shape):
    tcfg, _, mesh, _ = runs
    got = mesh[shape][0]
    meta = _meta_collectives(tcfg, shape)
    for name, kind in (("train", TRAIN), ("prefill", PREFILL)):
        part = got["train" if name == "train" else "serve"]
        have = part["counts"]["collectives"]
        assert have == meta[name], (shape, name)
        assert have == mesh_collective_bytes(tcfg, kind, _mesh(shape),
                                             use_wgkv=False,
                                             backend="gloo"), (shape, name)


@pytest.mark.parametrize("shape", [(2, 1), (2, 2)])
def test_gathered_routing_group_gradient_matches_jax_grad(runs, shape):
    """One routing group over both data ranks' rows: the gather's
    backward sums the ranks' gradients and keeps each rank's rows, and
    the whole group's load-balance loss counts once (within 5e-5 of each
    gradient's own largest magnitude: 0.01 lb's share of x's and the
    router's gradients is above that)."""
    _, ref, mesh, _ = runs
    want = ref["moe"]
    mcfg = port_cfg(make_cfg("granite-moe-3b-a800m"))
    m = _mesh(shape)
    for rank, out in mesh[shape].items():
        got = out["moe"]
        rows = R.block(BATCH, "data", out["coords"], m)
        _close(got["x"], want["x"][rows], TOL, (shape, rank, "x"), 0.0)
        for key in ("router", "w_gate", "w_up", "w_down"):
            spec = R.param_placement(("blocks", "b0", "moe", key),
                                     (mcfg.n_repeats,) + want[key].shape,
                                     m, mcfg)[1:]
            block = R.local_shard(torch.from_numpy(np.array(want[key])), spec,
                                  out["coords"], m).numpy()
            _close(got[key], block, TOL, (shape, rank, key), 0.0)


@pytest.mark.parametrize("mshape", FULL_MESHES)
def test_full_width_meta_collectives_equal_the_count(runs, mshape):
    """xlstm-350m at full width: whole at 16 x 16 (4 heads), split by
    head at 2 x 4; the meta run's bytes by axis, the FSDP gradients'
    reduce-scatters included, equal the count from the shapes."""
    *_, full = runs
    cfg = get_config("xlstm-350m")
    assert R.tp_plan(cfg, _mesh(mshape)).xlstm == (mshape[1] == 4)
    for name in FULL_SHAPES:
        want = mesh_collective_bytes(cfg, get_shape(name), _mesh(mshape),
                                     use_wgkv=False)
        assert full[(mshape, name)] == want, (mshape, name)
        if name == "train_4k":
            assert "data" in want
