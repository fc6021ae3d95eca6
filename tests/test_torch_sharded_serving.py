"""Mesh-sharded serving of the port (``serving/sharded.py``,
``sharding/comm.py``, ``launch/mesh.py``) held to the UNSHARDED reference
on the CPU, over ``gloo`` ranks.

The reference's own mesh tests are red on this tree (their helper builds
``AbstractMesh`` with an older signature), so the port's mesh is held to
the reference's flat backend and to the port's own flat run, in the
reference's parity setup (reduced qwen3-0.6b, f32, ``w_local`` 16, tau
0.1, gate_hidden 32, sink 4, slots 2, capacity 128, chunk 16, three
32-token prompts, 4 new tokens each):

* meshes 1 x 2 (heads split), 2 x 1 (slots split), 2 x 2, and 1 x 4 (the
  q heads split, the 2 kv heads whole: the "gather_q" plan). Two worlds
  are spawned (2 and 4 ranks), each serving two meshes, while the parent
  runs the reference; every world has its own timeout, so a deadlock
  fails instead of hanging;
* greedy tokens equal the reference's for ``wgkv`` (``dispatch_ahead``
  0 and 1) and ``dense`` (0); each rank's block of the final cache tree
  equals the matching block of the reference's (integer leaves exact,
  floats within 5e-5); ``quest:8`` (every page at capacity 128) streams
  the full read's tokens; a prefix store's second round (the
  ``dispatch_ahead`` 1 drive of ``wgkv``) hits every prompt and streams
  the first round's tokens, and under a budget it fills, every rank
  sizes its entries alike and evicts the same ones; temperature sampling
  draws what the port's flat engine draws; ``CompileSentinel`` and
  ``SyncSentinel`` hold; deadlines resolve the same on every rank; the
  pool mirror verifies;
* one decode step at 1 x 2 counts the collective bytes the ring formula
  gives.
"""
import concurrent.futures

import jax
import numpy as np
import pytest
import torch

from repro.serving.backend import make_backend as jax_make_backend
from repro.serving.orchestrator import Orchestrator as JOrchestrator
from repro.serving.orchestrator import SchedulerConfig as JSched
from repro.sharding.rules import _path_keys
from repro_torch.launch import mesh as M
from repro_torch.launch.specs import cache_batch_axis
from test_torch_support import parity_setup
from torch_mesh_worker import PROMPTS, flat_temperature, serve_meshes

torch.set_num_threads(2)

WORLDS = {(1, 2): [(1, 2), (2, 1)], (2, 2): [(2, 2), (1, 4)]}
MESHES = [(1, 2), (2, 1), (2, 2), (1, 4)]
TIMEOUT_S = 240


def _reference(jcfg, jparams, name):
    """The reference's flat backend on the drive: (tokens, final caches
    as {path: numpy})."""
    eng = jax_make_backend(name, jparams, jcfg, slots=2, capacity=128,
                           mirror_paged=False)
    orch = JOrchestrator(eng, sched=JSched(chunk_tokens=16))
    for p in PROMPTS:
        orch.submit(p, max_new=4)
    orch.run()
    caches = {_path_keys(p): np.asarray(x) for p, x in
              jax.tree_util.tree_flatten_with_path(eng.caches)[0]}
    return [orch.tokens(r) for r in range(len(PROMPTS))], caches


@pytest.fixture(scope="module")
def runs():
    jcfg, jparams, tcfg, _ = parity_setup(seed=0)
    params_np = jax.tree.map(np.asarray, jparams)
    with concurrent.futures.ThreadPoolExecutor(len(WORLDS)) as ex:
        futs = {world: ex.submit(M.spawn, serve_meshes, world,
                                 args=(tcfg, params_np, shapes),
                                 device="cpu", timeout_s=TIMEOUT_S)
                for world, shapes in WORLDS.items()}
        ref = {name: _reference(jcfg, jparams, name)
               for name in ("wgkv", "dense")}
        flat = flat_temperature(tcfg, params_np)
        mesh = {}
        for fut in futs.values():
            for rank, res in fut.result().items():
                for shape, out in res.items():
                    mesh.setdefault(shape, {})[rank] = out
    return ref, flat, mesh


def _ranks(runs, shape):
    return runs[2][shape]


@pytest.mark.parametrize("shape", MESHES)
def test_tokens_match_reference(runs, shape):
    ref = runs[0]
    for rank, out in _ranks(runs, shape).items():
        for name in ("wgkv", "dense"):
            want = ref[name][0]
            assert all(len(t) == 4 for t in want)
            assert out[name]["tokens"] == want, (shape, rank, name)
        assert out["wgkv_async"]["tokens"] == ref["wgkv"][0], (shape, rank)


@pytest.mark.parametrize("name", ["wgkv", "dense"])
@pytest.mark.parametrize("shape", MESHES)
def test_cache_blocks_match_reference(runs, shape, name):
    """Each rank's block of the final tree is the matching block of the
    reference's: its rows (slots over "data") and its kv heads."""
    full = runs[0][name][1]
    ints = floats = 0
    for rank, out in _ranks(runs, shape).items():
        local = out[name]["caches"]
        assert set(local) == set(full)
        r0, r1 = out["rows"]
        h0, nh = out["kv_heads"]
        for path, mine in local.items():
            want = full[path]
            ax = cache_batch_axis(path)
            want = np.take(want, range(r0, r1), axis=ax)
            if mine.ndim > ax + 1 and mine.shape[ax + 1] != want.shape[ax + 1]:
                want = np.take(want, range(h0, h0 + nh), axis=ax + 1)
            assert mine.shape == want.shape, (shape, rank, path)
            if np.issubdtype(want.dtype, np.integer):
                np.testing.assert_array_equal(mine, want, err_msg=str(path))
                ints += 1
            else:
                np.testing.assert_allclose(mine, want, rtol=0, atol=5e-5,
                                           err_msg=str(path))
                floats += 1
    assert ints and floats


@pytest.mark.parametrize("shape", MESHES)
def test_selection_of_every_page_streams_the_full_read(runs, shape):
    for out in _ranks(runs, shape).values():
        assert out["wgkv_sel_all"]["tokens"] == out["wgkv"]["tokens"]


@pytest.mark.parametrize("shape", MESHES)
def test_prefix_store_second_round_streams_the_first(runs, shape):
    """The ``wgkv`` drive is round 1 of a prefix store, the async drive
    round 2: every prompt hits, and the tokens are round 1's."""
    for out in _ranks(runs, shape).values():
        assert out["prefix"] == {"misses": 3, "hits": 3}
        assert out["wgkv_async"]["tokens"] == out["wgkv"]["tokens"]


@pytest.mark.parametrize("shape", MESHES)
def test_prefix_store_evicts_alike_on_every_rank(runs, shape):
    """An entry's size is the same on every rank (on a mesh, the sum over
    its model ranks, though each rank's heads admitted different counts),
    so a budget the store fills evicts the same entries everywhere: the
    first prompt's entry goes, and serving it again misses and streams
    round 1's tokens."""
    ranks = _ranks(runs, shape)
    evict = [out["prefix_evict"] for out in ranks.values()]
    assert all(e == evict[0] for e in evict), evict
    assert len(evict[0]["n_bytes"]) == 2
    assert evict[0]["evictions"] == 3
    assert (evict[0]["hits"], evict[0]["misses"]) == (3, 5)
    assert evict[0]["tokens"] == ranks[0]["wgkv"]["tokens"][0]


@pytest.mark.parametrize("shape", MESHES)
def test_temperature_draw_equals_flat(runs, shape):
    want = runs[1]
    assert want != runs[0]["wgkv"][0]            # the draw is not greedy
    for out in _ranks(runs, shape).values():
        assert out["wgkv_temp"]["tokens"] == want


@pytest.mark.parametrize("shape", MESHES)
def test_sentinels_hold_on_the_mesh(runs, shape):
    """The step-shape budget held (``CompileSentinel.check`` raised on the
    rank otherwise) and ``collect`` made the sanctioned host pulls."""
    for out in _ranks(runs, shape).values():
        for drive in ("wgkv", "wgkv_async", "dense", "wgkv_sel_all"):
            assert out[drive]["compiled"]["fused_step"] <= 2, drive
            assert out[drive]["collect_syncs"] > 0, drive
        assert out["wgkv_sel_all"]["compiled"]["fused_step_sel"] == 1


@pytest.mark.parametrize("shape,attn,rows", [
    ((1, 2), "split", [(0, 2)] * 2), ((2, 1), "whole", [(0, 1), (1, 2)]),
    ((2, 2), "split", [(0, 1)] * 2 + [(1, 2)] * 2),
    ((1, 4), "gather_q", [(0, 2)] * 4)])
def test_placement_deadlines_and_pool(runs, shape, attn, rows):
    ranks = _ranks(runs, shape)
    assert sorted(ranks) == list(range(shape[0] * shape[1]))
    for rank, out in sorted(ranks.items()):
        assert out["attn"] == attn
        assert out["rows"] == rows[rank]
        assert out["sharded"] is True
        assert out["devices"] == float(shape[0] * shape[1])
        assert out["deadline"] == ["cancelled", "done", "cancelled"]
        assert out["paged_dev"] < 2e-3


def test_collective_bytes_of_a_decode_step(runs):
    """One decode step of 2 rows at 1 x 2: per layer two sums of [2, 256]
    f32 over "model" (ring all-reduce: 2 x bytes x (n-1)/n = bytes), and
    one [5, 2] f32 sum over the mesh for the sampled tokens and stats;
    the counter counts them alike with and without aten ops, and one
    launch of each kernel a layer."""
    layers, rows, d = 2, 2, 256
    model = layers * 2 * rows * d * 4
    world = 5 * 2 * 4
    for out in _ranks(runs, (1, 2)).values():
        for counted, by_axis, launches in out["counted"]:
            assert by_axis == {"model": model, "world": world}
            assert counted == model + world
            assert launches == {"gate_mlp": layers, "paged_decode": layers}
