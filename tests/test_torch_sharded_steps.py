"""The sharded step bundles of the port (``launch/steps.py`` with a mesh,
``sharding/comm.py``'s autograd seams, FSDP and context-parallel decode)
held to the UNSHARDED reference on the CPU, over ``gloo`` ranks.

Reduced qwen3 (2 layers, d 64, 4 q / 2 kv heads, hd 16, d_ff 128, f32,
``w_local`` 16, tau 0.1, gate_hidden 32, sink 4, budget fraction 1), the
reference's weights carried across by ``convert.py`` with numpy-drawn
gates. Two worlds are spawned (2 and 4 ranks), each running two meshes,
while the parent runs the reference: 1 x 2 (heads split), 2 x 1 (rows
split, FSDP over "data"), 2 x 2, and 1 x 4 (the q heads split, the 2 kv
heads whole: the "gather_q" plan). On each:

* one train step at 2 x 64 (remat, a loss mask with zeros): the loss and
  its terms equal the reference's ``train_step`` within 1e-5 relative,
  and every rank's block of the gate gradients (AdamW's first moment
  after one step, 0.1 g) and of the new gates within 1e-5 of the
  reference's;
* one prefill at 2 x 64 (budget 64): each rank's rows of the logits and
  the mean admission within 5e-5, its block of every cache leaf equal
  (integer leaves exact, floats within 5e-5);
* three greedy decode steps on that prefill's caches: the same tokens,
  logits and cache blocks;
* on 2 x 1 and 2 x 2, six decode steps of one row whose global cache is
  split over "data" (context-parallel decode, from the flat prefill's
  cache): the reference's tokens and logits; the data-1 rank's block
  starts empty for some kv head (its read is -inf, weight 0);
* rank (0, 0)'s counts (FLOPs, bytes, launches, collective bytes by
  axis) equal a ``fake``-group meta run of the same bundles and coords
  (the train step: its collectives and forward launches; on the CPU
  autograd differentiates the plain versions).
"""
import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import inference as JI
from repro.models import transformer as JT
from repro.sharding.rules import _path_keys
from repro.training import trainer as JTR
from repro.training.optimizer import cosine_schedule
from repro_torch.kernels.ops import _identity_tables
from repro_torch.kernels.paged_decode import paged_decode_plain
from repro_torch.launch import mesh as M
from repro_torch.launch.steps import make_bundle
from repro_torch.roofline.counter import WorkCounter
from repro_torch.sharding import rules as R
from test_torch_support import make_cfg, port_cfg, spread_gate
from torch_steps_worker import (BATCH, DECODE, DECODE_STEPS, PREFILL,
                                S_PREFILL, S_TRAIN, SEQ_STEPS, TRAIN,
                                counts, step_meshes)

torch.set_num_threads(2)

WORLDS = {(1, 2): [(1, 2), (2, 1)], (2, 2): [(2, 2), (1, 4)]}
MESHES = [(1, 2), (2, 1), (2, 2), (1, 4)]
TIMEOUT_S = 240


def _cfg():
    jcfg = make_cfg("qwen3-0.6b").replace(
        d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128)
    return jcfg, port_cfg(jcfg)


def _data():
    rng = np.random.default_rng(7)
    mask = np.ones((BATCH, S_TRAIN), np.float32)
    mask[1, -8:] = 0.0
    return {"train_tokens": rng.integers(0, 512, (BATCH, S_TRAIN),
                                         dtype=np.int32),
            "loss_mask": mask,
            "prefill_tokens": rng.integers(0, 512, (BATCH, S_PREFILL),
                                           dtype=np.int32),
            "seq_token": rng.integers(0, 512, (1,), dtype=np.int32)}


def _jtree(tree):
    return {_path_keys(p): np.asarray(x) for p, x in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _reference(jcfg, jparams, data):
    out = {}
    batch = {"tokens": jnp.asarray(data["train_tokens"]),
             "loss_mask": jnp.asarray(data["loss_mask"])}
    state, aux = JTR.train_step(JTR.init_train_state(jparams), jparams,
                                jcfg, batch, lr=cosine_schedule(1e-3, 7500),
                                remat=True)
    out["train"] = {"aux": {k: float(v) for k, v in aux.items()},
                    "gates": {k: np.asarray(v)
                              for k, v in state.gates.items()},
                    "m": {k: np.asarray(v) for k, v in state.opt.m.items()}}
    budget = jcfg.wgkv.global_budget(S_PREFILL)
    o, caches = JI.prefill(jparams, jcfg, jnp.asarray(data["prefill_tokens"]),
                           use_wgkv=True, budget=budget,
                           max_len=S_PREFILL + 64)
    out["prefill"] = {"logits": np.asarray(o.logits),
                      "adm": float(o.mean_admission),
                      "caches": _jtree(caches)}
    out["decode"] = _decode(jparams, jcfg, caches,
                            jnp.argmax(o.logits, -1).astype(jnp.int32),
                            DECODE_STEPS)
    _, one = JI.prefill(jparams, jcfg,
                        jnp.asarray(data["prefill_tokens"][:1]),
                        use_wgkv=True, budget=budget, max_len=S_PREFILL + 64)
    out["seq"] = _decode(jparams, jcfg, one,
                         jnp.asarray(data["seq_token"]), SEQ_STEPS)
    return out


def _decode(jparams, jcfg, caches, token, n):
    steps = []
    for _ in range(n):
        logits, caches, _ = JI.decode_step(jparams, jcfg, token, caches)
        token = jnp.argmax(logits, -1).astype(jnp.int32)
        steps.append((np.asarray(logits), np.asarray(token)))
    return {"steps": steps, "caches": _jtree(caches)}


@pytest.fixture(scope="module")
def runs():
    jcfg, tcfg = _cfg()
    params_np = jax.tree.map(np.asarray,
                             JT.init_model(jax.random.PRNGKey(0), jcfg))
    params_np = spread_gate(params_np, jcfg, 100)
    data = _data()
    with concurrent.futures.ThreadPoolExecutor(len(WORLDS)) as ex:
        futs = {world: ex.submit(M.spawn, step_meshes, world,
                                 args=(tcfg, params_np, data, shapes),
                                 device="cpu", timeout_s=TIMEOUT_S)
                for world, shapes in WORLDS.items()}
        ref = _reference(jcfg, jax.tree.map(jnp.asarray, params_np), data)
        mesh = {}
        for fut in futs.values():
            for rank, res in fut.result().items():
                for shape, out in res.items():
                    mesh.setdefault(shape, {})[rank] = out
    return tcfg, ref, mesh


def _close(got, want, tol, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    if not np.issubdtype(want.dtype, np.floating):
        np.testing.assert_array_equal(got, want, err_msg=str(what))
        return
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale,
                               err_msg=str(what))


def _rows(shape, coords, batch):
    mesh = dict(zip(("data", "model"), shape))
    return R.block(batch, R.tokens_spec(mesh, batch, 0)[0], coords, mesh)


def _cache_blocks(tcfg, shape, coords, got, want, *, seq_shard=False,
                  what=""):
    mesh = dict(zip(("data", "model"), shape))
    assert set(got) == set(want), what
    for path, ref in want.items():
        spec = R.cache_placement(path, ref.shape, mesh, tcfg, seq_shard)
        block = R.local_shard(torch.from_numpy(np.ascontiguousarray(ref)),
                              spec, coords, mesh).numpy()
        _close(got[path], block, 5e-5, (what, path))


@pytest.mark.parametrize("shape", MESHES)
def test_sharded_train_step_matches_reference(runs, shape):
    tcfg, ref, mesh = runs
    want = ref["train"]
    m = dict(zip(("data", "model"), shape))
    for rank, out in mesh[shape].items():
        got = out["train"]
        for k, v in want["aux"].items():
            assert abs(got["aux"][k] - v) <= 1e-5 * max(abs(v), 1e-3), \
                (shape, rank, k, got["aux"][k], v)
        for part in ("m", "gates"):
            mine = {k[0]: v for k, v in got[part].items()}
            assert set(mine) == set(want[part])
            for key, ref_leaf in want[part].items():
                spec = R.param_placement(tuple(key.split("/")),
                                         ref_leaf.shape, m, tcfg,
                                         replicate_fsdp=False)
                block = R.local_shard(torch.from_numpy(np.array(ref_leaf)),
                                      spec, out["coords"], m).numpy()
                _close(mine[key], block, 1e-5, (shape, rank, part, key))


@pytest.mark.parametrize("shape", MESHES)
def test_sharded_prefill_and_decode_match_reference(runs, shape):
    tcfg, ref, mesh = runs
    for rank, out in mesh[shape].items():
        rows = _rows(shape, out["coords"], BATCH)
        got = out["prefill"]
        _close(got["logits"], ref["prefill"]["logits"][rows], 5e-5,
               (shape, rank, "logits"))
        assert abs(got["adm"] - ref["prefill"]["adm"]) < 5e-5
        _cache_blocks(tcfg, shape, out["coords"], got["caches"],
                      ref["prefill"]["caches"], what=(shape, rank, "prefill"))
        for i, ((lg, tok), (rlg, rtok)) in enumerate(zip(
                out["decode"]["steps"], ref["decode"]["steps"])):
            np.testing.assert_array_equal(tok, rtok[rows])
            _close(lg, rlg[rows], 5e-5, (shape, rank, "decode", i))
        _cache_blocks(tcfg, shape, out["coords"], out["decode"]["caches"],
                      ref["decode"]["caches"], what=(shape, rank, "decode"))


@pytest.mark.parametrize("shape", [(2, 1), (2, 2)])
def test_seq_sharded_decode_matches_unsharded(runs, shape):
    tcfg, ref, mesh = runs
    empty = False
    for rank, out in mesh[shape].items():
        seq = out["seq"]
        for i, ((lg, tok), (rlg, rtok)) in enumerate(zip(
                seq["steps"], ref["seq"]["steps"])):
            np.testing.assert_array_equal(tok, rtok)
            _close(lg, rlg, 5e-5, (shape, rank, "seq", i))
        _cache_blocks(tcfg, shape, out["coords"], seq["caches"],
                      ref["seq"]["caches"], seq_shard=True,
                      what=(shape, rank, "seq"))
        if out["coords"]["data"] == 1:
            empty |= bool((np.stack(seq["gcnt"]) <= seq["block"]).any())
    assert empty, "no data-1 block was ever empty"


def _meta_counts(tcfg, shape):
    """Rank (0, 0)'s counts of the train step, the prefill and the first
    decode step on meta, over a fake group that stands for gloo."""
    out = {}
    with M.fake_mesh(shape, backend="gloo") as mesh:
        tr = make_bundle(tcfg, TRAIN, use_wgkv=True, mesh=mesh)
        _identity_tables.cache_clear()
        with WorkCounter() as wc:
            tr.fn(*tr.args)
        out["train"] = counts(wc)
        pre = make_bundle(tcfg, PREFILL, use_wgkv=True, mesh=mesh)
        _identity_tables.cache_clear()
        with WorkCounter() as wc:
            logits, _, caches = pre.fn(*pre.args)
        out["prefill"] = counts(wc)
        dec = make_bundle(tcfg, DECODE, use_wgkv=True, caches=caches,
                          mesh=mesh)
        _identity_tables.cache_clear()
        with WorkCounter() as wc:
            dec.fn(*dec.args)
        out["decode"] = counts(wc)
    return out


@pytest.mark.parametrize("shape", MESHES)
def test_rank0_counts_equal_the_fake_group_meta_run(runs, shape):
    tcfg, _, mesh = runs
    got = mesh[shape][0]
    want = _meta_counts(tcfg, shape)
    assert got["prefill"]["counts"] == want["prefill"]
    assert got["decode_counts"] == want["decode"]
    tr, wtr = got["train"]["counts"], want["train"]
    assert tr["collectives"] == wtr["collectives"]
    for k in ("gate_mlp", "gated_flash"):
        assert tr["kernels"][k] == wtr["kernels"][k]


def test_paged_decode_plain_lse_is_the_logsumexp_of_its_scores():
    """The plain read's lse: ``logsumexp`` of the valid scaled scores of
    both segments, and -inf (with out 0) for a stream that reads none."""
    g = torch.Generator().manual_seed(3)
    hd, page, group = 16, 16, 2
    k1 = torch.randn(8, page, hd, generator=g)
    v1 = torch.randn(8, page, hd, generator=g)
    k2 = torch.randn(4, page, hd, generator=g)
    v2 = torch.randn(4, page, hd, generator=g)
    q = torch.randn(3 * group, hd, generator=g)
    t1 = torch.tensor([[0, 1], [2, 3], [4, 5]], dtype=torch.int32)
    t2 = torch.tensor([[0], [1], [2]], dtype=torch.int32)
    l1 = torch.tensor([20, 0, 32], dtype=torch.int32)
    l2 = torch.tensor([5, 0, 16], dtype=torch.int32)
    out, lse = paged_decode_plain(q, k1, v1, t1, l1, (k2, v2, t2, l2),
                                  group=group, lse=True)
    for n in range(q.shape[0]):
        s = n // group
        keys = torch.cat([k1[t1[s].long()].reshape(-1, hd)[:l1[s]],
                          k2[t2[s].long()].reshape(-1, hd)[:l2[s]]])
        if keys.shape[0] == 0:
            assert lse[n] == -float("inf")
            assert torch.equal(out[n], torch.zeros(hd))
            continue
        scores = keys @ q[n] * hd ** -0.5
        torch.testing.assert_close(lse[n], torch.logsumexp(scores, 0),
                                   rtol=0, atol=1e-5)
