"""The port's sharding rules (``repro_torch/sharding/rules.py``) held to the
reference's (``repro/sharding/rules.py``), shapes only.

* Every param leaf of all ten archs at full width, and every cache leaf
  (dual and dense caches, the eviction ``obs`` tree, ``seq_shard``), gets
  the reference's spec on the (2, 4), (16, 16) and (2, 16, 16) meshes,
  with and without ``replicate_fsdp``. The reference's leaves come from
  ``jax.eval_shape``, the port's from the ``meta`` device.
* ``parse_mesh_shape`` / ``build_mesh`` validate as the reference's do; a
  CUDA mesh with more ranks than cards and no ``gloo`` raises.
* ``local_shard`` takes the block ``shard_shape`` gives, and the blocks
  tile the leaf in GSPMD's order.
* The placement: qwen3-0.6b at 1 x 2 holds half of every projection and
  the embedding whole, as PERF.md predicts; a serving rank's rows and kv
  heads are its block under the reference's cache spec.
"""
import itertools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import get_config as jax_get_config
from repro.launch.specs import build_decode_caches as jax_caches
from repro.models import inference as JI
from repro.models import transformer as JT
from repro.sharding import rules as JR
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.launch import mesh as M
from repro_torch.launch.specs import build_decode_caches
from repro_torch.models import inference as TI
from repro_torch.models import transformer as TT
from repro_torch.serving import sharded as S
from repro_torch.sharding import rules as R
from repro_torch.tree import tree_leaves_with_path

torch.set_num_threads(2)

MESHES = [((2, 4), ("data", "model")), ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]


def _keys(path):
    return tuple(str(k) for k in path)


def _port_specs(tree, specs):
    """{path: spec} of every leaf of ``tree`` (specs are tuples, so the
    spec tree is read at the leaves' paths)."""
    out = {}
    for path, _ in tree_leaves_with_path(tree):
        node = specs
        for k in path:
            node = getattr(node, k) if isinstance(k, str) and \
                hasattr(node, "_fields") else node[k]
        out[_keys(path)] = node
    return out


def _jax_specs(tree_specs):
    return {JR._path_keys(p): tuple(ns.spec) for p, ns in
            jax.tree_util.tree_flatten_with_path(tree_specs)[0]}


@pytest.fixture(scope="module")
def trees():
    """Per arch: (reference cfg, reference param structs, port cfg, port
    params on meta)."""
    out = {}
    for arch in ARCH_NAMES:
        jcfg, tcfg = jax_get_config(arch), get_config(arch)
        jp = jax.eval_shape(lambda c=jcfg: JT.init_model(
            jax.random.PRNGKey(0), c))
        tp = TT.init_model(tcfg, torch.Generator(), "meta")
        out[arch] = (jcfg, jp, tcfg, tp)
    return out


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_specs_match_reference(trees, arch):
    jcfg, jp, tcfg, tp = trees[arch]
    for (shape, axes), fsdp in itertools.product(MESHES, (False, True)):
        jmesh = AbstractMesh(shape, axes)
        want = _jax_specs(JR.param_shardings(jp, jmesh, jcfg,
                                             replicate_fsdp=fsdp))
        got = _port_specs(tp, R.param_shardings(
            tp, dict(zip(axes, shape)), tcfg, replicate_fsdp=fsdp))
        assert set(got) == set(want), arch
        for k in want:
            assert got[k] == want[k], (arch, shape, fsdp, k)


def _cache_trees(arch, jcfg, tcfg, *, batch, capacity, use_wgkv):
    s_enc = 64 if tcfg.is_encdec else None
    jt = jax.eval_shape(lambda: jax_caches(jcfg, batch, capacity,
                                           use_wgkv=use_wgkv, s_enc=s_enc))
    tt = build_decode_caches(tcfg, batch, capacity, use_wgkv=use_wgkv,
                             device="meta", s_enc=s_enc)
    if tcfg.has_attention_cache and use_wgkv:
        jt["obs"] = jax.eval_shape(
            lambda: JI._init_obs_tree(jcfg, batch, JI.DecodeOptions()))
        tt["obs"] = TI._init_obs_tree(tcfg, batch, TI.DecodeOptions(),
                                      "meta")
    return jt, tt


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_cache_specs_match_reference(trees, arch):
    jcfg, _, tcfg, _ = trees[arch]
    for (batch, seq_shard), use_wgkv in itertools.product(
            ((4, False), (1, True), (3, False)), (True, False)):
        jt, tt = _cache_trees(arch, jcfg, tcfg, batch=batch, capacity=4096,
                              use_wgkv=use_wgkv)
        for shape, axes in MESHES[:2]:
            jmesh = AbstractMesh(shape, axes)
            want = _jax_specs(JR.cache_shardings(jt, jmesh, jcfg,
                                                 seq_shard=seq_shard))
            got = _port_specs(tt, R.cache_shardings(
                tt, dict(zip(axes, shape)), tcfg, seq_shard=seq_shard))
            assert set(got) == set(want), (arch, use_wgkv)
            for k in want:
                assert got[k] == want[k], (arch, batch, seq_shard, k)


def test_tokens_spec_and_pick_match_reference():
    for (shape, axes), batch in itertools.product(MESHES, (1, 2, 4, 32, 64)):
        jmesh = AbstractMesh(shape, axes)
        mesh = dict(zip(axes, shape))
        assert R.tokens_spec(mesh, batch, 2) == \
            tuple(JR.tokens_spec(jmesh, batch, 2))
        assert R.pick(batch, mesh, R.batch_axes(mesh), "data") == \
            JR.pick(batch, jmesh, JR.batch_axes(jmesh), "data")


# ==========================================================================
# mesh construction
# ==========================================================================
def test_build_mesh_validation(monkeypatch):
    assert S.build_mesh(None) is None
    assert S.parse_mesh_shape("2X4") == (2, 4)
    for bad in ("2x", "x4", "0x4", "2x4x2", "axb"):
        with pytest.raises(ValueError):
            S.parse_mesh_shape(bad)
    with pytest.raises(RuntimeError, match="devices"):
        S.build_mesh("8x8")
    assert M.make_debug_mesh() == {"data": 2, "model": 4}
    assert M.make_production_mesh() == {"data": 16, "model": 16}
    assert M.make_production_mesh(multi_pod=True)["pod"] == 2
    # the backend is explicit: a CPU mesh is gloo, nccl there is refused
    assert M.check_backend(4, None, "cpu")[0] == "gloo"
    with pytest.raises(ValueError):
        M.check_backend(2, "nccl", "cpu")
    # one card, two ranks: nccl (the default on CUDA) raises, gloo shares
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="devices"):
        M.check_backend(2, None, "cuda")
    with pytest.raises(RuntimeError, match="devices"):
        M.check_backend(2, "nccl", "cuda")
    assert M.check_backend(2, "gloo", "cuda")[0] == "gloo"
    assert M.check_backend(1, None, "cuda")[0] == "nccl"


# ==========================================================================
# blocks of a spec
# ==========================================================================
@pytest.mark.parametrize("spec", [
    (("pod", "data"), "model", None),
    ("data", None, ("pod", "model")),
    (None, "model", None),
])
def test_local_shard_takes_the_shard_shape_block(spec):
    mesh = {"pod": 2, "data": 2, "model": 2}
    x = torch.arange(8 * 4 * 12).reshape(8, 4, 12)
    want = R.shard_shape(x.shape, spec, mesh)
    seen = torch.zeros_like(x)
    for p, d, m in itertools.product(range(2), range(2), range(2)):
        coords = {"pod": p, "data": d, "model": m}
        blk = R.local_shard(x, spec, coords, mesh)
        assert tuple(blk.shape) == want
        # GSPMD's order: the block index is row-major over the entry's
        # axes, and the block is contiguous in that dim
        idx = []
        for i, e in enumerate(spec):
            axes = R._axes_of(e)
            k = 0
            for a in axes:
                k = k * mesh[a] + coords[a]
            idx.append(slice(k * want[i], (k + 1) * want[i]))
        assert torch.equal(blk, x[tuple(idx)])
        seen[tuple(idx)] += 1
    # every element is held by exactly the devices its spec replicates it
    # over
    reps = 8 // int(np.prod([R._axsize(mesh, R._axes_of(e) or None)
                             for e in spec]))
    assert bool((seen == reps).all())
    with pytest.raises(ValueError):
        R.shard_shape((3, 4), ("data", None), mesh)


# ==========================================================================
# the port's placement
# ==========================================================================
def test_placement_of_qwen3_at_1x2(trees):
    """Half of every projection on each rank, the embedding whole: the
    per-rank parameter counts PERF.md predicts."""
    _, _, tcfg, tp = trees["qwen3-0.6b"]
    mesh = {"data": 1, "model": 2}
    plan = R.tp_plan(tcfg, mesh, 1)
    assert (plan.attn, plan.ffn, plan.q_heads, plan.kv_heads) == \
        ("split", True, (8, 8), (4, 4))
    lcfg = R.local_config(tcfg, plan)
    assert (lcfg.n_heads, lcfg.n_kv_heads, lcfg.d_ff, lcfg.head_dim) == \
        (8, 4, 1536, 128)
    local = R.local_params(tp, tcfg, mesh, {"data": 0, "model": 1})
    proj = sum(x.numel() for p, x in tree_leaves_with_path(local)
               if p[-1] in ("w_q", "w_k", "w_v", "w_o", "w_gate", "w_up",
                            "w_down"))
    assert proj == 28 * 15_728_640 // 2 == 220_200_960
    total = sum(x.numel() for _, x in tree_leaves_with_path(local))
    assert local["embed"]["tok"].numel() == 155_582_464
    # + the rank's half of the gate (28 x 4 heads x 16,513) and the whole
    # norms (57,344 + 7,168 + 1,024)
    assert total == 220_200_960 + 155_582_464 + 1_849_456 + 65_536
    gate = local["blocks"]["b0"]["attn"]["gate"]
    assert gate["w1"].shape[1] == 4       # the rank's 4 of 8 kv heads
    assert R.held_whole(tp, tcfg, mesh) == {"embed/tok": 155_582_464 * 4}


@pytest.mark.parametrize("arch,m,attn", [
    ("qwen3-0.6b", 4, "split"), ("phi3-medium-14b", 4, "gather_q"),
    ("smollm-360m", 2, "whole"), ("phi4-mini-3.8b", 8, "split")])
def test_plan_follows_the_reference_specs(trees, arch, m, attn):
    """The plan's split or whole projections are the reference's serving
    spec: column-parallel where it says so, whole where it falls back to
    d_model (held whole), and the gate by kv heads only when they split."""
    jcfg, _, tcfg, tp = trees[arch]
    mesh = {"data": 2, "model": m}
    plan = R.tp_plan(tcfg, mesh)
    assert plan.attn == attn
    attn_p = {k: v for k, v in tp["blocks"]["b0"]["attn"].items()
              if k != "gate"}
    for name, leaf in attn_p.items():
        if not name.startswith("w_"):
            continue
        spec = R.param_placement(("blocks", "b0", "attn", name),
                                 tuple(leaf.shape), mesh, tcfg)
        split = spec != (None,) * leaf.ndim
        want = {"split": True, "whole": False,
                "gather_q": name in ("w_q", "w_o")}[attn]
        assert split == want, (arch, name, spec)
    w1 = tp["blocks"]["b0"]["attn"]["gate"]["w1"]
    gspec = R.param_placement(("blocks", "b0", "attn", "gate", "w1"),
                              tuple(w1.shape), mesh, tcfg)
    assert (gspec[1] == "model") == (attn == "split")


@pytest.mark.parametrize("arch,shape,slots", [
    ("qwen3-0.6b", (1, 2), 2), ("qwen3-0.6b", (2, 2), 4),
    ("qwen3-0.6b", (2, 2), 3), ("phi3-medium-14b", (2, 4), 2),
    ("smollm-360m", (1, 2), 2)])
def test_cache_blocks_are_the_cache_spec_blocks(trees, arch, shape, slots):
    """The rows and kv heads a serving rank holds (``cache_blocks``) are
    its block of the dual cache's keys under the reference's cache spec,
    and the kv heads are the plan's: split over "model" when they divide
    it, slots over "data" when they divide it, else whole."""
    jcfg, _, tcfg, _ = trees[arch]
    mesh = dict(zip(("data", "model"), shape))
    jmesh = AbstractMesh(shape, ("data", "model"))
    leaf = (tcfg.n_repeats, slots, tcfg.n_kv_heads, 4, tcfg.head_dim)
    jspec = JR._cache_leaf_spec(("blocks", "b0", "gk"), leaf, jmesh, jcfg,
                                False)
    x = torch.arange(slots * tcfg.n_kv_heads).reshape(
        1, slots, tcfg.n_kv_heads, 1, 1)
    for d, m in itertools.product(range(shape[0]), range(shape[1])):
        coords = {"data": d, "model": m}
        rows, heads = R.cache_blocks(tcfg, slots, mesh, coords)
        blk = R.local_shard(x, tuple(jspec), coords, mesh)
        assert torch.equal(blk, x[:, rows, heads])
        assert (heads.start, heads.stop - heads.start) == \
            R.tp_plan(tcfg, mesh, m).kv_heads


def test_unsupported_archs_raise_naming_8b(trees):
    """The mesh admits every arch: GQA attention (M-RoPE and cross
    attention included), MoE, RG-LRU, encoder and xLSTM blocks. xlstm-350m
    (4 heads) splits by head at 2 and 4 ways (the sLSTM's MLP, 1,364
    wide, too) and stays whole at 16, its leaves held whole there; its
    sLSTM ``w_in`` is sliced per gate. whisper-medium and qwen2-vl-7b plan
    on the production mesh: heads split (whole for qwen2-vl's 28 q heads
    at 16 ways), the GELU MLP's d_ff split with its ``b_in``."""
    for arch in ARCH_NAMES:
        R.check_mesh_arch(trees[arch][2])
    assert len(ARCH_NAMES) == 10
    xl = trees["xlstm-350m"][2]
    for m, split in ((2, True), (4, True), (16, False)):
        mesh = {"data": 2, "model": m}
        plan = R.tp_plan(xl, mesh, m - 1)
        assert plan.xlstm == split
        assert plan.attn == "whole" and not plan.ffn
        assert plan.xlstm_heads == (((m - 1) * (4 // m), 4 // m) if split
                                    else (0, 4))
        whole = R.held_whole(trees["xlstm-350m"][3], xl, mesh)
        assert ("blocks/b0/cell/w_up_x" in whole) == (not split)
    w_in = torch.arange(4 * 8, dtype=torch.float32).reshape(1, 2, 16)
    mesh = {"data": 1, "model": 2}
    blk = R.local_shard(w_in, (None, None, "model"), {"data": 0, "model": 1},
                        mesh, R.gate_parts(("blocks", "b1", "cell", "w_in"),
                                           xl))
    assert torch.equal(blk, w_in.reshape(1, 2, 4, 4)[..., 2:].reshape(
        1, 2, 8))
    mesh = {"data": 16, "model": 16}
    wh, vl = trees["whisper-medium"][2], trees["qwen2-vl-7b"][2]
    assert R.tp_plan(wh, mesh).attn == "split" and R.tp_plan(wh, mesh).ffn
    assert R.tp_plan(vl, mesh).attn == "whole" and R.tp_plan(vl, mesh).ffn
    assert R.param_placement(("blocks", "b0", "mlp", "b_in"),
                             (wh.n_repeats, wh.d_ff), mesh, wh) == \
        (None, "model")
