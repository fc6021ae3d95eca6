"""The port's sharded step bundles without ranks: their specs against the
reference's, the mesh dry run on a ``fake`` process group, and the lint
rule of the sharded path (TL002, the reference's JL002).

* ``make_bundle(..., mesh=shape).in_shardings`` equals the reference's
  ``make_bundle(cfg, shape, AbstractMesh(...))`` ``PartitionSpec``s leaf
  by leaf, for qwen3-0.6b (at "model" 16 the "gather_q" plan), smollm-360m
  (5 kv heads: the fallbacks) and phi3-medium-14b (40 q / 10 kv heads;
  FSDP decode at (2, 4)), at the four shapes on (2, 4), (16, 16) and (2,
  16, 16); the knobs equal the reference's but for ``block_chunk`` and
  the prefill's ``q_chunk``, which the port dropped (its prefill kernels
  tile themselves);
* the 16 x 16 meta dry run of qwen3-0.6b: rank (0, 0)'s collective bytes
  by axis equal ``torch_mesh_counts.mesh_collective_bytes``, a count from
  the shapes, at every shape, and its peak stays below the one-card dry
  run's;
* TL002 flags ``torch.cat`` / ``torch.stack`` on the sharded path and
  takes ``allow-concat(reason)``.
"""
import itertools

import jax
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import get_config as jax_get_config
from repro.configs import get_shape as jax_get_shape
from repro.launch import steps as JST
from repro.sharding.rules import _path_keys
from repro_torch.analysis.passes import ModuleContext, run_passes
from repro_torch.configs import get_config, get_shape
from repro_torch.launch import dryrun as D
from repro_torch.launch.steps import make_bundle, param_structs
from repro_torch.sharding import rules as R
from torch_mesh_counts import mesh_collective_bytes

torch.set_num_threads(2)

ARCHS = ("qwen3-0.6b", "smollm-360m", "phi3-medium-14b")
SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
MESHES = [((2, 4), ("data", "model")), ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]
# knobs the port's prefill does not take (its kernels tile the
# queries themselves); the train step keeps q_chunk
DROPPED = {"prefill": ("block_chunk", "q_chunk")}


@pytest.fixture(scope="module")
def params():
    return {a: param_structs(get_config(a)) for a in ARCHS}


def _ref_specs(bundle):
    return {_path_keys(p): tuple(ns.spec) for p, ns in
            jax.tree_util.tree_flatten_with_path(bundle.in_shardings)[0]}


@pytest.mark.parametrize("arch", ARCHS)
def test_bundle_specs_and_knobs_match_reference(params, arch):
    jcfg, tcfg = jax_get_config(arch), get_config(arch)
    for (shape, axes), name in itertools.product(MESHES, SHAPES):
        jb = JST.make_bundle(jcfg, jax_get_shape(name),
                             AbstractMesh(shape, axes),
                             use_wgkv=jcfg.wgkv.enabled)
        tb = make_bundle(tcfg, get_shape(name), use_wgkv=tcfg.wgkv.enabled,
                         params=params[arch], mesh=dict(zip(axes, shape)))
        want = _ref_specs(jb)
        got = R.specs_by_path(tb.args, tb.in_shardings)
        assert set(got) == set(want), (arch, shape, name)
        for k, spec in want.items():
            assert got[k] == spec, (arch, shape, name, k)
        drop = DROPPED.get(get_shape(name).kind, ("block_chunk",))
        assert {k: v for k, v in tb.knobs.items() if k not in drop} == \
            {k: v for k, v in jb.knobs.items() if k not in drop}, \
            (arch, shape, name)


def test_local_blocks_follow_the_placement(params):
    """The args are the rank's blocks: FSDP for training, the gate sliced
    by kv heads (and whole across "data"), the seq-sharded cache's global
    axis over "data" at long_500k."""
    cfg = get_config("qwen3-0.6b")
    mesh = {"data": 2, "model": 4}
    tb = make_bundle(cfg, get_shape("train_4k"), use_wgkv=True,
                     params=params["qwen3-0.6b"], mesh=mesh)
    state, local, inputs = tb.args
    blocks = local["blocks"]["b0"]
    assert tuple(blocks["attn"]["w_q"].shape) == (28, 512, 512)
    assert tuple(blocks["mlp"]["w_down"].shape) == (28, 768, 512)
    assert tuple(blocks["attn"]["gate"]["w1"].shape)[:2] == (28, 2)
    assert tuple(state.gates["blocks/b0/attn/gate/w1"].shape)[:2] == (28, 2)
    assert tuple(inputs["tokens"].shape) == (128, 4096)
    assert R.held_whole(params["qwen3-0.6b"], cfg, mesh,
                        replicate_fsdp=False) == {
        "embed/tok": 151936 * 1024 * 4}
    lb = make_bundle(cfg, get_shape("long_500k"), use_wgkv=True,
                     params=params["qwen3-0.6b"], mesh=mesh)
    c = lb.args[1]["blocks"]["b0"]
    budget = cfg.wgkv.global_budget(524288)
    assert tuple(c.gk.shape) == (28, 1, 2, budget // 2, cfg.head_dim)
    assert tuple(c.lk.shape)[3] == cfg.wgkv.w_local
    assert tuple(c.gcnt.shape) == (28, 1, 2)


@pytest.fixture(scope="module")
def single_runs():
    return {name: D.run_dryrun("qwen3-0.6b", name, mesh="single")
            for name in SHAPES}


@pytest.mark.parametrize("name", SHAPES)
def test_mesh_dryrun_collectives_equal_the_count_from_shapes(single_runs,
                                                             name):
    rec = single_runs[name]
    cfg = get_config("qwen3-0.6b")
    want = mesh_collective_bytes(cfg, get_shape(name),
                                 {"data": 16, "model": 16})
    assert rec["collectives"]["by_axis"] == want
    assert rec["collectives"]["per_chip_bytes"] == sum(want.values())
    assert rec["mesh"] == "16x16" and rec["devices"] == 256
    assert rec["coords"] == {"data": 0, "model": 0}
    assert rec["collectives"]["crosses_node"] == {k: True for k in want}
    assert rec["collective_s"] > 0 and rec["bottleneck"]
    launches = {k: v["launches"] for k, v in rec["cost"]["kernels"].items()}
    kind = get_shape(name).kind
    if kind == "train":   # forward, the remat recompute, and backward
        assert launches == {"gate_mlp": 56, "gated_flash": 56,
                            "gate_mlp_bwd": 28, "gated_flash_bwd": 28}
    elif kind == "prefill":
        assert launches == {"gate_mlp": 28, "vertical_slash": 28}
    else:
        assert launches == {"gate_mlp": 28, "paged_decode": 28}


def test_mesh_dryrun_peak_below_one_card(single_runs):
    one = D.run_dryrun("qwen3-0.6b", "train_4k")
    assert single_runs["train_4k"]["memory"]["peak_bytes"] < \
        one["memory"]["peak_bytes"]


def test_mesh_dryrun_cli_multi_pod(tmp_path):
    out = tmp_path / "dry.json"
    assert D.main(["--arch", "qwen3-0.6b", "--shape", "decode_32k",
                   "--mesh", "multi", "--out", str(out)]) == 0
    import json
    (rec,) = json.loads(out.read_text())
    assert rec["mesh"] == "2x16x16" and rec["devices"] == 512
    want = mesh_collective_bytes(get_config("qwen3-0.6b"),
                                 get_shape("decode_32k"),
                                 {"pod": 2, "data": 16, "model": 16})
    assert rec["collectives"]["by_axis"] == want


SRC = '''import torch


def plain(a, b):
    return torch.cat([a, b])


def helper(a, b):  # torchlint: sharded-path
    x = torch.cat([a, b], dim=0)
    y = torch.stack([a, b])  # torchlint: allow-concat(a new axis no mesh splits)
    # torchlint: allow-concat()
    z = torch.concatenate([a, b])
    return x, y, z
'''


@pytest.mark.parametrize("path", ["pkg/launch/steps.py",
                                  "src/repro_torch/serving/sharded.py"])
def test_tl002_flags_concat_on_the_sharded_path(path):
    found = run_passes(ModuleContext.parse(path, SRC))
    tl002 = [f.line for f in found if f.code == "TL002"]
    if path.endswith("serving/sharded.py"):
        assert tl002 == [5, 9, 12]   # the whole module is the sharded path
    else:
        assert tl002 == [9, 12]      # the marked function only
    # a reasonless allow-concat is itself a finding and suppresses nothing
    assert [f.line for f in found if f.code == "TL000"] == [11]
