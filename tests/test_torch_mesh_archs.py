"""The MoE and hybrid archs on the port's ``data x model`` mesh
(expert-parallel ``models/moe.py``, channel-parallel ``models/rglru.py``,
``local_attn`` under "gather_q") held to the UNSHARDED reference on the
CPU, over ``gloo`` ranks.

Configs, reduced and f32 (``conftest.make_cfg``: ``w_local`` 16, tau 0.1,
gate_hidden 32, sink 4, budget fraction 1, ``sliding_window`` 32), the
reference's weights carried across by ``convert.py`` with numpy-drawn
gates spread across tau:

* qwen3-moe-235b-a22b (4 experts, top 2): the "experts" plan on every
  mesh with a "model" axis;
* granite-moe-3b-a800m with 6 experts: "experts" at model 2, the
  reference's "width" fallback (every expert's F split) at model 4;
* recurrentgemma-9b with a two-block RG-LRU stem (window 16): the RG-LRU channels
  split over "model", its 4 q / 1 kv heads under "gather_q".

The MoE configs run at capacity factor 0.5, so the reference drops
routed entries at these shapes (asserted). Two worlds are spawned (2 and
4 ranks), each running two meshes, while three processes run the
reference (one an arch) and the parent the flat engine and the meta
counts: 1 x 2, 2 x 1, 2 x 2 and 1 x 4 (recurrentgemma-9b on the first
three). On each, for each arch:

* one train step at 2 x 32 (remat; the reference's without, the same
  values; a loss mask with zeros): the loss
  terms within 1e-5 relative, every rank's block of the gate gradients
  (AdamW's first moment) and of the new gates within 1e-5 of their
  scale;
* one prefill at 2 x 32 and three greedy decode steps: the same tokens,
  logits within 5e-5 of their scale, each rank's block of every cache
  leaf (integer leaves exact, floats within 5e-5 of their scale); the
  MoE steps route in two groups of one row each, the reference's
  ``exec_knobs`` on a mesh with "data" 2 (each rank routes its own row's
  group there), an override elsewhere; the knobs of the three archs
  equal the reference's on its production meshes;
* on 2 x 1 and 2 x 2, three decode steps of one row whose global caches
  are split over "data" (context-parallel decode), from the prefill's
  row 0 (its own routing group);
* serving: ``dense`` (a request that fills its row and is stepped
  masked, parked, beside two decoding ones: the tick's one routing group
  gathered over "data" where the slots split) against the reference's
  flat engine, and ``wgkv`` (three requests) against the port's flat
  engine (held to the reference's by ``tests/test_torch_moe.py`` and
  ``tests/test_torch_hybrid.py``): tokens equal, cache blocks as above;
* every routing's top-k ids bitwise equal on the model ranks of one data
  index, and no top-k near-tie (``routing_margin``);
* rank (0, 0)'s counts equal a ``fake``-group meta run's, and its
  collective bytes the count from the shapes
  (``torch_mesh_counts.mesh_collective_bytes``).
"""
import concurrent.futures
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from conftest import make_cfg
from repro.launch.steps import exec_knobs as jax_exec_knobs
from repro.models import inference as JI
from repro.models import moe as JM
from repro.models import transformer as JT
from repro.serving.backend import make_backend as jax_make_backend
from repro.serving.orchestrator import Orchestrator as JOrchestrator
from repro.serving.orchestrator import SchedulerConfig as JSched
from repro.sharding.rules import _path_keys
from repro.training import trainer as JTR
from repro.training.optimizer import cosine_schedule
from repro_torch.kernels.ops import _identity_tables
from repro_torch.configs import get_config, get_shape
from repro_torch.convert import params_from_numpy
from repro_torch.launch import mesh as M
from repro_torch.launch.specs import cache_batch_axis
from repro_torch.launch.steps import exec_knobs, make_bundle
from repro_torch.models import moe as MoE
from repro_torch.roofline.counter import WorkCounter
from repro_torch.serving.backend import make_backend as torch_make_backend
from repro_torch.sharding import comm
from repro_torch.sharding import rules as R
from test_torch_support import port_cfg
from torch_archs_worker import (BATCH, CAPACITY, DECODE, DECODE_STEPS,
                                DENSE_REQS, MOE_GROUPS, PREFILL, S, SLOTS,
                                TRAIN, WGKV_REQS, arch_meshes, counts, drive,
                                host_tree, knobs, prompts)
from torch_mesh_counts import mesh_collective_bytes

torch.set_num_threads(2)

WORLDS = {(1, 2): [(1, 2), (2, 1)], (2, 2): [(2, 2), (1, 4)]}
MESHES = [(1, 2), (2, 1), (2, 2), (1, 4)]
ARCHS = ("qwen3-moe-235b-a22b", "granite-moe-3b-a800m", "recurrentgemma-9b")
# recurrentgemma-9b's plan at model 4 is its plan at model 2 (channels
# and the gathered q heads split further); its 1 x 4 run is left out for
# the file's time
CASES = [(a, m) for a in ARCHS for m in MESHES
         if (a, m) != ("recurrentgemma-9b", (1, 4))]
TIMEOUT_S = 300
TOL = 5e-5
# about 30x the probability differences seen between the packages
ROUTE_MARGIN = 1e-6


def _jcfg(arch):
    cfg = make_cfg(arch)
    if arch == "granite-moe-3b-a800m":
        return cfg.replace(moe=dataclasses.replace(
            cfg.moe, n_experts=6, capacity_factor=0.5))
    if cfg.moe is not None:
        return cfg.replace(moe=dataclasses.replace(cfg.moe,
                                                   capacity_factor=0.5))
    return cfg.replace(stem_pattern=("rglru", "rglru"), sliding_window=16)


def _spread_gates(params_np, cfg, seed: int):
    """Every attention block's gate: numpy draws whose scores spread
    across tau (both admit and reject branches taken)."""
    rng = np.random.default_rng(seed)
    for i, bt in enumerate(cfg.block_pattern):
        if "attn" not in bt:
            continue
        gate = params_np["blocks"][f"b{i}"]["attn"]["gate"]
        r, h, f, m = gate["w1"].shape
        gate["w1"] = (rng.standard_normal((r, h, f, m)) / np.sqrt(f)
                      ).astype(np.float32)
        gate["b1"] = (0.1 * rng.standard_normal((r, h, m))
                      ).astype(np.float32)
        gate["w2"] = (3.0 * rng.standard_normal((r, h, m, 1)) / np.sqrt(m)
                      ).astype(np.float32)
        gate["b2"] = (-1.5 + 0.3 * rng.standard_normal((r, h, 1))
                      ).astype(np.float32)
    return params_np


def _data():
    rng = np.random.default_rng(11)
    mask = np.ones((BATCH, S), np.float32)
    mask[1, -6:] = 0.0
    return {"train_tokens": rng.integers(0, 512, (BATCH, S), dtype=np.int32),
            "loss_mask": mask,
            "prefill_tokens": rng.integers(0, 512, (BATCH, S),
                                           dtype=np.int32),
            "seq_token": rng.integers(0, 512, (1,), dtype=np.int32)}


def _jtree(tree):
    return {_path_keys(p): np.asarray(x) for p, x in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


_DECODE_STEP = jax.jit(JI.decode_step, static_argnums=1,
                       static_argnames="moe_groups")


def _decode(jparams, jcfg, caches, token, groups):
    steps = []
    for _ in range(DECODE_STEPS):
        logits, caches, _ = _DECODE_STEP(jparams, jcfg, token, caches,
                                         moe_groups=groups)
        token = jnp.argmax(logits, -1).astype(jnp.int32)
        steps.append((np.asarray(logits), np.asarray(token)))
    return {"steps": steps, "caches": _jtree(caches)}


def _serve(jcfg, jparams, name, reqs, seed):
    eng = jax_make_backend(name, jparams, jcfg, slots=SLOTS,
                           capacity=CAPACITY, mirror_paged=False)
    orch = JOrchestrator(eng, sched=JSched(chunk_tokens=16))
    for p, (_, m) in zip(prompts(reqs, seed), reqs):
        orch.submit(p, max_new=m)
    orch.run()
    return {"tokens": [orch.tokens(r) for r in range(len(reqs))],
            "caches": _jtree(eng.caches)}


def _reference(jcfg, jparams, data):
    """The unsharded reference's runs: the train step, the prefill and its
    decode steps (in :data:`MOE_GROUPS` routing groups), the seq-sharded
    row's decode (one group), the two serving drives, and the drop
    fraction of layer 0's routing of the prefill's embeddings."""
    budget = jcfg.wgkv.global_budget(S)
    g = MOE_GROUPS
    batch = {"tokens": jnp.asarray(data["train_tokens"]),
             "loss_mask": jnp.asarray(data["loss_mask"])}
    # jitted, without remat (the same values; compiled, the step takes
    # a fifth of its eager time)
    step = JTR.make_train_step(jcfg, lr=cosine_schedule(1e-3, 7500),
                               moe_groups=g, donate=False)
    state, aux = step(JTR.init_train_state(jparams), jparams, batch=batch)
    out = {"train": {"aux": {k: float(v) for k, v in aux.items()},
                     "gates": {k: np.asarray(v)
                               for k, v in state.gates.items()},
                     "m": {k: np.asarray(v) for k, v in state.opt.m.items()}}}
    toks = jnp.asarray(data["prefill_tokens"])
    o, caches = JI.prefill(jparams, jcfg, toks, use_wgkv=True, budget=budget,
                           max_len=S + 64, moe_groups=g)
    out["prefill"] = {"logits": np.asarray(o.logits),
                      "adm": float(o.mean_admission),
                      "caches": _jtree(caches)}
    out["decode"] = _decode(jparams, jcfg, caches,
                            jnp.argmax(o.logits, -1).astype(jnp.int32), g)
    if jcfg.moe is not None:
        x = jparams["embed"]["tok"][toks]
        moe0 = jax.tree.map(lambda v: v[0], jparams["blocks"]["b0"]["moe"])
        out["drop"] = float(JM.moe_ffn(moe0, jcfg, x, groups=g)[1][
            "router_drop_frac"])
    # row 0's caches: a prefill of that row alone (its own routing group)
    one = jax.tree_util.tree_map_with_path(
        lambda p, x: jnp.take(x, jnp.arange(1), axis=cache_batch_axis(
            _path_keys(p))), caches)
    out["seq"] = _decode(jparams, jcfg, one, jnp.asarray(data["seq_token"]),
                         1)
    out["serve"] = {"dense": _serve(jcfg, jparams, "dense", DENSE_REQS, 2)}
    return out


def _flat_wgkv(tcfg, params_np):
    """The port's flat engine on the wgkv drive (its serving is held to
    the reference's by ``tests/test_torch_moe.py`` and
    ``tests/test_torch_hybrid.py``)."""
    eng = torch_make_backend("wgkv", params_from_numpy(params_np, tcfg,
                                                       "cpu"), tcfg,
                             slots=SLOTS, capacity=CAPACITY,
                             mirror_paged=False, device="cpu")
    return {"tokens": drive(eng, WGKV_REQS, 1),
            "caches": host_tree(eng.caches)}


def _setup(arch):
    """(jax cfg, port cfg, numpy params) of ``arch``."""
    jcfg = _jcfg(arch)
    init = jax.jit(JT.init_model, static_argnums=1)
    params_np = jax.tree.map(np.asarray, init(jax.random.PRNGKey(3), jcfg))
    return jcfg, port_cfg(jcfg), _spread_gates(params_np, jcfg, 103)


def _arch_reference(jcfg, params_np, data):
    """:func:`_reference` of one arch in a process of its own (the three
    archs' reference runs then take one arch's time)."""
    return _reference(jcfg, jax.tree.map(jnp.asarray, params_np), data)


@pytest.fixture(scope="module")
def runs():
    data = _data()
    setups = {arch: _setup(arch) for arch in ARCHS}
    jobs = {world: [(arch, tcfg, params_np,
                     [m for m in shapes if (arch, m) in CASES])
                    for arch, (_, tcfg, params_np) in setups.items()]
            for world, shapes in WORLDS.items()}
    spawn = torch.multiprocessing.get_context("spawn")
    with concurrent.futures.ThreadPoolExecutor(len(WORLDS)) as ex, \
            concurrent.futures.ProcessPoolExecutor(
                len(ARCHS), mp_context=spawn) as refs:
        ref_futs = {arch: refs.submit(_arch_reference, jcfg, params_np,
                                      data)
                    for arch, (jcfg, _, params_np) in setups.items()}
        futs = [ex.submit(M.spawn, arch_meshes, world,
                          args=(jobs[world], data), device="cpu",
                          timeout_s=TIMEOUT_S) for world in WORLDS]
        flat = {arch: _flat_wgkv(tcfg, params_np)
                for arch, (_, tcfg, params_np) in setups.items()}
        # host work beside the worlds: rank (0, 0)'s counts on meta
        meta = {(arch, shape): _meta_counts(setups[arch][1], shape)
                for arch, shape in CASES}
        ref = {arch: f.result(timeout=TIMEOUT_S)
               for arch, f in ref_futs.items()}
        for arch, f in flat.items():
            ref[arch]["serve"]["wgkv"] = f
        mesh = {}
        for fut in futs:
            for rank, res in fut.result().items():
                for key, out in res.items():
                    mesh.setdefault(key, {})[rank] = out
    return setups, ref, mesh, meta


def _close(got, want, tol, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    if not np.issubdtype(want.dtype, np.floating):
        np.testing.assert_array_equal(got, want, err_msg=str(what))
        return
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale,
                               err_msg=str(what))


def _mesh(shape):
    return dict(zip(("data", "model"), shape))


def _rows(shape, coords, batch):
    mesh = _mesh(shape)
    return R.block(batch, R.tokens_spec(mesh, batch, 0)[0], coords, mesh)


def _cache_blocks(tcfg, shape, coords, got, want, *, seq_shard=False,
                  what=""):
    mesh = _mesh(shape)
    assert set(got) == set(want), what
    for path, ref in want.items():
        spec = R.cache_placement(path, ref.shape, mesh, tcfg, seq_shard)
        block = R.local_shard(torch.from_numpy(np.ascontiguousarray(ref)),
                              spec, coords, mesh).numpy()
        _close(got[path], block, TOL, (what, path))


def test_plans_cover_experts_width_and_channels():
    """The three plans this file exercises, from the reference's specs:
    the expert split, granite's width fallback at model 4, the RG-LRU
    channels with the q heads gathered."""
    q3, gr, rg = (port_cfg(_jcfg(a)) for a in ARCHS)
    assert R.tp_plan(q3, {"data": 1, "model": 2}).moe == "experts"
    assert R.tp_plan(q3, {"data": 1, "model": 4}).moe == "experts"
    assert R.tp_plan(gr, {"data": 1, "model": 2}).moe == "experts"
    assert R.tp_plan(gr, {"data": 1, "model": 4}).moe == "width"
    assert R.tp_plan(gr, {"data": 2, "model": 1}).moe == "whole"
    for m in (2, 4):
        plan = R.tp_plan(rg, {"data": 1, "model": m})
        assert plan.rec and plan.attn == "gather_q" and plan.ffn


def test_gathered_routing_group_refuses_a_gradient():
    """``moe.spans_rows`` marks the group counts whose groups span the
    data ranks (an MoE arch only); such a group's rows are gathered with
    or without a graph. On meta the gradient reaches the rank's rows of
    x: the backward sums the ranks' gradients (one all-reduce on gloo)
    and keeps this rank's rows, and ``shared_term`` halves a whole-group
    term's gradient on each of the two ranks
    (``tests/test_torch_mesh_xlstm.py`` holds the values to jax.grad)."""
    gr, rg = port_cfg(_jcfg(ARCHS[1])), port_cfg(_jcfg(ARCHS[2]))
    assert MoE.spans_rows(gr, 1, 2) and MoE.spans_rows(gr, 3, 2)
    assert not MoE.spans_rows(gr, 2, 2) and not MoE.spans_rows(gr, 1, 1)
    assert not MoE.spans_rows(rg, 1, 2)
    with M.fake_mesh((2, 1), backend="gloo") as mesh:
        with comm.active(mesh, R.tp_plan(gr, mesh.shape), rows="data"):
            x = torch.zeros((1, 4, gr.d_model), device="meta",
                            requires_grad=True)
            with torch.no_grad():
                assert comm.gather_moe_rows(x).shape == (2, 4, gr.d_model)
            full = comm.gather_moe_rows(x)
            assert full.shape == (2, 4, gr.d_model) and full.requires_grad
            with WorkCounter() as wc:
                (gx,) = torch.autograd.grad(full.sum(), [x])
            assert gx.shape == x.shape and gx.device.type == "meta"
            assert dict(wc.record()["collective_bytes_by_axis"]) == {
                "data": 2 * 2 * 4 * gr.d_model * 4 // 2}
            lb = torch.ones((), requires_grad=True)
            (g,) = torch.autograd.grad(comm.shared_term(lb), [lb])
            assert float(g) == 0.5


@pytest.mark.parametrize("arch", ARCHS)
def test_knobs_equal_the_references_on_its_meshes(arch):
    """The routing groups (and the other knobs the port takes) of the
    full configs at the four shapes, as the reference's ``exec_knobs``
    sets them on (2, 4), (16, 16) and (2, 16, 16)."""
    from repro.configs import get_config as jax_get_config
    from repro.configs import get_shape as jax_get_shape
    jcfg, tcfg = jax_get_config(arch), get_config(arch)
    for shape, axes in (((2, 4), ("data", "model")),
                        ((16, 16), ("data", "model")),
                        ((2, 16, 16), ("pod", "data", "model"))):
        for name in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
            want = jax_exec_knobs(jcfg, jax_get_shape(name),
                                  AbstractMesh(shape, axes))
            got = exec_knobs(tcfg, get_shape(name), dict(zip(axes, shape)))
            assert got["moe_groups"] == want["moe_groups"], (shape, name)
            assert got["remat"] == want["remat"]


@pytest.mark.parametrize("arch", ARCHS[:2])
def test_reference_drops_routed_entries(runs, arch):
    _, ref, _, _ = runs
    assert ref[arch]["drop"] > 0


@pytest.mark.parametrize("arch,shape", CASES)
def test_train_step_matches_reference(runs, arch, shape):
    setups, _, mesh, _ = runs
    tcfg = setups[arch][1]
    want = runs[1][arch]["train"]
    for rank, out in mesh[(arch, shape)].items():
        got = out["train"]
        for k, v in want["aux"].items():
            assert abs(got["aux"][k] - v) <= 1e-5 * max(abs(v), 1e-3), \
                (arch, shape, rank, k, got["aux"][k], v)
        for part in ("m", "gates"):
            mine = {k[0]: v for k, v in got[part].items()}
            assert set(mine) == set(want[part])
            for key, ref_leaf in want[part].items():
                spec = R.param_placement(tuple(key.split("/")),
                                         ref_leaf.shape, _mesh(shape), tcfg,
                                         replicate_fsdp=False)
                block = R.local_shard(torch.from_numpy(np.array(ref_leaf)),
                                      spec, out["coords"],
                                      _mesh(shape)).numpy()
                _close(mine[key], block, 1e-5, (arch, shape, rank, part,
                                                key))


@pytest.mark.parametrize("arch,shape", CASES)
def test_prefill_and_decode_match_reference(runs, arch, shape):
    setups, _, mesh, _ = runs
    tcfg = setups[arch][1]
    ref = runs[1][arch]
    for rank, out in mesh[(arch, shape)].items():
        rows = _rows(shape, out["coords"], BATCH)
        got = out["prefill"]
        _close(got["logits"], ref["prefill"]["logits"][rows], TOL,
               (arch, shape, rank, "logits"))
        assert abs(got["adm"] - ref["prefill"]["adm"]) < TOL
        _cache_blocks(tcfg, shape, out["coords"], got["caches"],
                      ref["prefill"]["caches"],
                      what=(arch, shape, rank, "prefill"))
        for i, ((lg, tok), (rlg, rtok)) in enumerate(zip(
                out["decode"]["steps"], ref["decode"]["steps"])):
            np.testing.assert_array_equal(tok, rtok[rows])
            _close(lg, rlg[rows], TOL, (arch, shape, rank, "decode", i))
        _cache_blocks(tcfg, shape, out["coords"], out["decode"]["caches"],
                      ref["decode"]["caches"],
                      what=(arch, shape, rank, "decode"))


@pytest.mark.parametrize("arch,shape", [(a, m) for a in ARCHS
                                        for m in ((2, 1), (2, 2))])
def test_seq_sharded_decode_matches_reference(runs, arch, shape):
    setups, ref, mesh, _ = runs
    want = ref[arch]["seq"]
    for rank, out in mesh[(arch, shape)].items():
        for i, ((lg, tok), (rlg, rtok)) in enumerate(zip(
                out["seq"]["steps"], want["steps"])):
            np.testing.assert_array_equal(tok, rtok)
            _close(lg, rlg, TOL, (arch, shape, rank, "seq", i))
        _cache_blocks(setups[arch][1], shape, out["coords"],
                      out["seq"]["caches"], want["caches"], seq_shard=True,
                      what=(arch, shape, rank, "seq"))


@pytest.mark.parametrize("arch,shape", CASES)
def test_serving_matches_reference(runs, arch, shape):
    """Tokens equal for both drives, the dense drive's first request
    filling its row; every rank's block of each final cache tree."""
    setups, ref, mesh, _ = runs
    want = ref[arch]["serve"]
    assert [len(t) for t in want["dense"]["tokens"]] == \
        [m for _, m in DENSE_REQS]
    for rank, out in mesh[(arch, shape)].items():
        for name in ("wgkv", "dense"):
            got = out["serve"][name]
            assert got["tokens"] == want[name]["tokens"], (arch, shape,
                                                           rank, name)
            _cache_blocks(setups[arch][1], shape, out["coords"],
                          got["caches"], want[name]["caches"],
                          what=(arch, shape, rank, name))
        assert out["serve"]["wgkv"]["paged_dev"] < 2e-3


@pytest.mark.parametrize("arch,shape", [(a, m) for a in ARCHS[:2]
                                        for m in MESHES])
def test_routing_alike_on_every_model_rank(runs, arch, shape):
    """Each routing's top-k ids bitwise equal on the model ranks of one
    data index, and clear of near-ties."""
    _, _, mesh, _ = runs
    by_data = {}
    for rank, out in mesh[(arch, shape)].items():
        ids = out["routes"]["ids"]
        assert ids, "nothing was routed"
        assert min(out["routes"]["margins"]) >= ROUTE_MARGIN
        by_data.setdefault(out["coords"]["data"], []).append(ids)
    for lists in by_data.values():
        for other in lists[1:]:
            assert len(other) == len(lists[0])
            for a, b in zip(lists[0], other):
                np.testing.assert_array_equal(a, b)


def _meta_counts(tcfg, shape):
    """Rank (0, 0)'s counts of the train step, the prefill and the first
    decode step on meta, over a fake group that stands for gloo."""
    out = {}
    kn = knobs(tcfg)
    with M.fake_mesh(shape, backend="gloo") as mesh:
        tr = make_bundle(tcfg, TRAIN, use_wgkv=True, mesh=mesh,
                         knob_overrides=kn)
        _identity_tables.cache_clear()
        with WorkCounter() as wc:
            tr.fn(*tr.args)
        out["train"] = counts(wc)
        pre = make_bundle(tcfg, PREFILL, use_wgkv=True, mesh=mesh,
                          knob_overrides=kn)
        _identity_tables.cache_clear()
        with WorkCounter() as wc:
            _, _, caches = pre.fn(*pre.args)
        out["prefill"] = counts(wc)
        dec = make_bundle(tcfg, DECODE, use_wgkv=True, caches=caches,
                          mesh=mesh, knob_overrides=kn)
        _identity_tables.cache_clear()
        with WorkCounter() as wc:
            dec.fn(*dec.args)
        out["decode"] = counts(wc)
    return out


@pytest.mark.parametrize("arch,shape", CASES)
def test_rank0_counts_equal_meta_and_the_count_from_shapes(runs, arch,
                                                           shape):
    setups, _, mesh, meta = runs
    tcfg = setups[arch][1]
    got = mesh[(arch, shape)][0]
    want = meta[(arch, shape)]
    assert got["prefill"]["counts"] == want["prefill"]
    assert got["decode_counts"] == want["decode"]
    tr, wtr = got["train"]["counts"], want["train"]
    assert tr["collectives"] == wtr["collectives"]
    for k in ("gate_mlp", "gated_flash", "rglru_scan"):
        assert tr["kernels"].get(k) == wtr["kernels"].get(k)
    for kind, step, have in (("train", TRAIN, tr["collectives"]),
                             ("prefill", PREFILL,
                              got["prefill"]["counts"]["collectives"]),
                             ("decode", DECODE,
                              got["decode_counts"]["collectives"])):
        assert have == mesh_collective_bytes(
            tcfg, step, _mesh(shape), backend="gloo",
            moe_groups=knobs(tcfg).get("moe_groups")), (arch, shape, kind)
