"""whisper-medium and qwen2-vl-7b on the port's ``data x model`` mesh, and
the seq-sharded dense and Quest decode reads, held to the UNSHARDED
reference on the CPU over ``gloo`` ranks.

Configs, reduced and f32 (``conftest.make_cfg``: ``w_local`` 16, tau 0.1,
gate_hidden 32, sink 4), the reference's weights carried across by
``convert.py`` with numpy-drawn gates spread across tau (the self and the
cross attention's):

* whisper-medium (4 / 4 heads: "split" at model 2 and 4), at a budget
  fraction of 0.25: a 64-token decoder prompt over 32 encoder frames, its
  self cache and its cross memory 16 a head (the cross memory's top-16 of
  32 chosen by the gate on each rank's heads);
* qwen2-vl-7b (4 / 2 heads: "split" at model 2, "gather_q" at model 4),
  its stream 16 patches on a 4 x 4 grid and 16 text tokens with M-RoPE
  ids (``torch_archs_worker.small_vlm_grid``).

Two worlds are spawned (2 and 4 ranks), each running two meshes, while
three processes run the reference and the parent the flat engine and the
meta counts: 1 x 2, 2 x 1, 2 x 2 and 1 x 4. On each, for each arch:

* one gate-distillation step at 2 x S (remat): the loss terms within
  1e-5 relative, every rank's block of the gate gradients (AdamW's first
  moment) and of the new gates within 1e-5 of their scale;
* one prefill at 2 x S and three greedy decode steps: the same tokens,
  logits within 5e-5 of their scale, each rank's block of every cache
  leaf, the cross cache's included (integer and bool leaves exact,
  floats within 5e-5 of their scale);
* qwen2-vl served (``dense`` against the reference's flat engine,
  ``wgkv`` against the port's flat engine): tokens equal;
* rank (0, 0)'s counts equal a ``fake``-group meta run's, and its
  collective bytes the count from the shapes
  (``torch_mesh_counts.mesh_collective_bytes``).

The seq-sharded reads, one row: the dense baseline's buffer
(``prefill(use_wgkv=False)``) split over "data" at 2 x 1 and 2 x 2 for
qwen3-0.6b (its buffer of 96, so the second block holds no key and reads
nothing) and recurrentgemma-9b (a buffer of 64 and a window of 16 that
straddles the two blocks); and Quest selection on a global cache of four
pages split over "data" at 2 x 1, gather and mask modes, K 2 and K 4 (every
page). Three decode steps each against the reference's unsharded
``decode_step`` on the same cache: tokens equal, logits and cache blocks
as above; K 4 bitwise equal to the unselected seq-sharded read.
"""
import concurrent.futures
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_cfg
from repro.models import inference as JI
from repro.models import registry as JREG
from repro.models import transformer as JT
from repro.training import trainer as JTR
from repro.training.optimizer import cosine_schedule
from repro_torch.convert import params_from_numpy
from repro_torch.kernels.ops import _identity_tables
from repro_torch.launch import mesh as M
from repro_torch.launch.steps import make_bundle
from repro_torch.models import inference as TI
from repro_torch.roofline.counter import WorkCounter
from repro_torch.sharding import rules as R
from test_torch_mesh_archs import (_cache_blocks, _close, _decode,
                                   _flat_wgkv, _jtree, _mesh, _rows, _serve)
from test_torch_support import port_cfg
from torch_archs_worker import (BATCH, DECODE_STEPS, DENSE_REQS, S,
                                SMALL_GRID, counts, encdec_meshes,
                                encdec_shapes, small_vlm_grid)
from torch_mesh_counts import mesh_collective_bytes

torch.set_num_threads(2)

WORLDS = {(1, 2): [(1, 2), (2, 1)], (2, 2): [(2, 2), (1, 4)]}
MESHES = [(1, 2), (2, 1), (2, 2), (1, 4)]
ARCHS = ("whisper-medium", "qwen2-vl-7b")
CASES = [(a, m) for a in ARCHS for m in MESHES]
TIMEOUT_S = 300
TOL = 5e-5
# the seq-sharded reads: (name, arch, kind, meshes)
SEQ_DENSE = (("dense-qwen3", "qwen3-0.6b", (2, 1), (2, 2)),
             ("dense-rg", "recurrentgemma-9b", (2, 1), (2, 2)))
# the buffers: qwen3's default S + 64 (48 a block: the second reads
# nothing), recurrentgemma's 64 (32 a block: its window straddles them)
DENSE_MAX_LEN = {"dense-qwen3": S + 64, "dense-rg": 64}
QUEST_S = 64          # four pages of global cache, two a block at 2 x 1
QUEST = {"plain": {}, "gather2": {"selection_policy": "quest:2"},
         "gather4": {"selection_policy": "quest:4"},
         "mask2": {"quest_pages": 2}, "mask4": {"quest_pages": 4}}


def _jcfg(arch):
    if arch == "whisper-medium":
        return make_cfg(arch, global_budget_frac=0.25)
    if arch == "recurrentgemma-9b":
        return make_cfg(arch).replace(sliding_window=16)
    return make_cfg(arch)


def _spread_gates(params_np, cfg, seed: int):
    """Every gate (self and cross attention): numpy draws whose scores
    spread across tau (both admit and reject branches taken)."""
    rng = np.random.default_rng(seed)
    for i, bt in enumerate(cfg.block_pattern):
        if "attn" not in bt:
            continue
        node = params_np["blocks"][f"b{i}"]
        for mixer in ("attn", "xattn"):
            if mixer not in node:
                continue
            gate = node[mixer]["gate"]
            r, h, f, m = gate["w1"].shape
            gate["w1"] = (rng.standard_normal((r, h, f, m)) / np.sqrt(f)
                          ).astype(np.float32)
            gate["b1"] = (0.1 * rng.standard_normal((r, h, m))
                          ).astype(np.float32)
            gate["w2"] = (3.0 * rng.standard_normal((r, h, m, 1))
                          / np.sqrt(m)).astype(np.float32)
            gate["b2"] = (-1.5 + 0.3 * rng.standard_normal((r, h, 1))
                          ).astype(np.float32)
    return params_np


def _setup(arch):
    """(jax cfg, port cfg, numpy params) of ``arch``."""
    jcfg = _jcfg(arch)
    init = jax.jit(JT.init_model, static_argnums=1)
    params_np = jax.tree.map(np.asarray, init(jax.random.PRNGKey(3), jcfg))
    return jcfg, port_cfg(jcfg), _spread_gates(params_np, jcfg, 103)


def _draws(arch, tcfg, seed):
    """The arch's numpy inputs: tokens, a loss mask with zeros, and
    whisper's encoder frames or the VLM's patches."""
    rng = np.random.default_rng(seed)
    train, _, _ = encdec_shapes(tcfg)
    s = train.seq_len if tcfg.is_encdec else S
    mask = np.ones((BATCH, s), np.float32)
    mask[1, -6:] = 0.0
    if tcfg.is_encdec:
        extra = (BATCH, train.seq_len // tcfg.enc_seq_divisor, tcfg.d_model)
        scale = 0.1
    else:
        extra = (BATCH, SMALL_GRID[0] * SMALL_GRID[1], tcfg.d_model)
        scale = 0.02
    return {"train_tokens": rng.integers(0, 512, (BATCH, s), dtype=np.int32),
            "loss_mask": mask,
            "train_extra": (scale * rng.standard_normal(extra)
                            ).astype(np.float32),
            "prefill_tokens": rng.integers(0, 512, (BATCH, s),
                                           dtype=np.int32),
            "prefill_extra": (scale * rng.standard_normal(extra)
                              ).astype(np.float32)}


def _ref_batches(jparams, jcfg, d):
    """The reference's train batch and prefill keywords of draws ``d``:
    whisper's ``enc_embeds``; the VLM stream of
    ``registry.build_vlm_embeds`` (as its bundles build it)."""
    train = {"loss_mask": jnp.asarray(d["loss_mask"])}
    pre = {}
    if jcfg.is_encdec:
        train.update(tokens=jnp.asarray(d["train_tokens"]),
                     enc_embeds=jnp.asarray(d["train_extra"]))
        pre.update(tokens=jnp.asarray(d["prefill_tokens"]),
                   enc_embeds=jnp.asarray(d["prefill_extra"]))
        return train, pre
    emb, pos = JREG.build_vlm_embeds(jparams, jcfg,
                                     jnp.asarray(d["train_tokens"]),
                                     jnp.asarray(d["train_extra"]),
                                     SMALL_GRID)
    train.update(tokens=None, embeds=emb, positions=pos)
    emb, pos = JREG.build_vlm_embeds(jparams, jcfg,
                                     jnp.asarray(d["prefill_tokens"]),
                                     jnp.asarray(d["prefill_extra"]),
                                     SMALL_GRID)
    pre.update(tokens=None, embeds=emb, positions=pos)
    return train, pre


def _arch_reference(jcfg, params_np, d):
    """The unsharded reference's train step, prefill and decode steps
    (and for the VLM the dense serving drive), in a process of its own."""
    jparams = jax.tree.map(jnp.asarray, params_np)
    tr_shape, pre_shape, _ = encdec_shapes(jcfg)
    train, pre = _ref_batches(jparams, jcfg, d)
    step = JTR.make_train_step(jcfg, lr=cosine_schedule(1e-3, 7500),
                               donate=False)
    state, aux = step(JTR.init_train_state(jparams), jparams, batch=train)
    out = {"train": {"aux": {k: float(v) for k, v in aux.items()},
                     "gates": {k: np.asarray(v)
                               for k, v in state.gates.items()},
                     "m": {k: np.asarray(v) for k, v in state.opt.m.items()}}}
    o, caches = JI.prefill(jparams, jcfg, pre.pop("tokens"), use_wgkv=True,
                           budget=jcfg.wgkv.global_budget(pre_shape.seq_len),
                           max_len=pre_shape.seq_len + 64, **pre)
    out["prefill"] = {"logits": np.asarray(o.logits),
                      "adm": float(o.mean_admission),
                      "caches": _jtree(caches)}
    out["decode"] = _decode(jparams, jcfg, caches,
                            jnp.argmax(o.logits, -1).astype(jnp.int32), 1)
    if not jcfg.is_encdec:
        out["serve"] = {"dense": _serve(jcfg, jparams, "dense", DENSE_REQS,
                                        2)}
    return out


@functools.lru_cache(maxsize=None)
def _jdecode(jcfg, opts):
    return jax.jit(functools.partial(JI.decode_step, cfg=jcfg, opts=opts))


def _ref_steps(jparams, jcfg, caches, token, opts):
    steps = []
    for _ in range(DECODE_STEPS):
        logits, caches, _ = _jdecode(jcfg, opts)(jparams, token=token,
                                                 caches=caches)
        token = jnp.argmax(logits, -1).astype(jnp.int32)
        steps.append((np.asarray(logits), np.asarray(token)))
    return {"steps": steps, "caches": _jtree(caches)}


def _seq_reference(jobs):
    """The reference's unsharded decode steps of each seq-sharded job,
    from its own prefill of the same row."""
    out = {}
    for name, jcfg, params_np, kind, kw in jobs:
        jparams = jax.tree.map(jnp.asarray, params_np)
        tokens = jnp.asarray(kw["tokens"])
        token = jnp.asarray(kw["token"])
        if kind == "dense":
            _, caches = JI.prefill(jparams, jcfg, tokens, use_wgkv=False,
                                   max_len=kw["max_len"])
            out[name] = _ref_steps(jparams, jcfg, caches, token,
                                   JI.DecodeOptions())
            continue
        s = tokens.shape[1]
        _, caches = JI.prefill(jparams, jcfg, tokens, use_wgkv=True,
                               budget=jcfg.wgkv.global_budget(s),
                               max_len=s + 64)
        out[name] = {k: _ref_steps(jparams, jcfg, caches, token,
                                   JI.DecodeOptions(**o))
                     for k, o in QUEST.items()}
    return out


def _seq_jobs(setups):
    """(the ranks' jobs, the reference's jobs) of the seq-sharded reads."""
    rng = np.random.default_rng(21)
    ranks, refs = [], []
    for name, arch, *shapes in SEQ_DENSE:
        jcfg, tcfg, params_np = setups[arch]
        kw = {"tokens": rng.integers(0, 512, (1, S), dtype=np.int32),
              "token": rng.integers(0, 512, (1,), dtype=np.int32),
              "max_len": DENSE_MAX_LEN[name]}
        ranks.append((name, tcfg, params_np, "dense", shapes, kw))
        refs.append((name, jcfg, params_np, "dense", kw))
    jcfg, tcfg, params_np = setups["qwen3-0.6b"]
    kw = {"tokens": rng.integers(0, 512, (1, QUEST_S), dtype=np.int32),
          "token": rng.integers(0, 512, (1,), dtype=np.int32)}
    sel = {k: TI.DecodeOptions(**o) for k, o in QUEST.items()}
    ranks.append(("quest", tcfg, params_np, "quest", [(2, 1)],
                  dict(kw, selections=sel)))
    refs.append(("quest", jcfg, params_np, "quest", kw))
    return ranks, refs


def _meta_counts(tcfg, shape):
    """Rank (0, 0)'s counts of the train step, the prefill and the first
    decode step on meta, over a fake group that stands for gloo."""
    out = {}
    tr_shape, pre_shape, dec_shape = encdec_shapes(tcfg)
    with small_vlm_grid(), M.fake_mesh(shape, backend="gloo") as mesh:
        tr = make_bundle(tcfg, tr_shape, use_wgkv=True, mesh=mesh)
        _identity_tables.cache_clear()
        with WorkCounter() as wc:
            tr.fn(*tr.args)
        out["train"] = counts(wc)
        pre = make_bundle(tcfg, pre_shape, use_wgkv=True, mesh=mesh)
        _identity_tables.cache_clear()
        with WorkCounter() as wc:
            _, _, caches = pre.fn(*pre.args)
        out["prefill"] = counts(wc)
        dec = make_bundle(tcfg, dec_shape, use_wgkv=True, caches=caches,
                          mesh=mesh)
        _identity_tables.cache_clear()
        with WorkCounter() as wc:
            dec.fn(*dec.args)
        out["decode"] = counts(wc)
    return out


@pytest.fixture(scope="module")
def runs():
    setups = {a: _setup(a) for a in ARCHS + ("qwen3-0.6b",
                                             "recurrentgemma-9b")}
    draws = {a: _draws(a, setups[a][1], 11 + i) for i, a in enumerate(ARCHS)}
    seq_ranks, seq_refs = _seq_jobs(setups)
    jobs = {world: [(a, setups[a][1], setups[a][2], draws[a], shapes)
                    for a in ARCHS] for world, shapes in WORLDS.items()}
    seq = {world: [(name, cfg, p, kind, [m for m in ms if m in shapes], kw)
                   for name, cfg, p, kind, ms, kw in seq_ranks
                   if any(m in shapes for m in ms)]
           for world, shapes in WORLDS.items()}
    spawn = torch.multiprocessing.get_context("spawn")
    with concurrent.futures.ThreadPoolExecutor(len(WORLDS)) as ex, \
            concurrent.futures.ProcessPoolExecutor(
                len(ARCHS) + 1, mp_context=spawn) as refs:
        ref_futs = {a: refs.submit(_arch_reference, setups[a][0],
                                   setups[a][2], draws[a]) for a in ARCHS}
        seq_fut = refs.submit(_seq_reference, seq_refs)
        futs = [ex.submit(M.spawn, encdec_meshes, world,
                          args=(jobs[world], seq[world]), device="cpu",
                          timeout_s=TIMEOUT_S) for world in WORLDS]
        flat = _flat_wgkv(setups["qwen2-vl-7b"][1], setups["qwen2-vl-7b"][2])
        meta = {(a, m): _meta_counts(setups[a][1], m) for a, m in CASES}
        ref = {a: f.result(timeout=TIMEOUT_S) for a, f in ref_futs.items()}
        ref["qwen2-vl-7b"]["serve"]["wgkv"] = flat
        ref["seq"] = seq_fut.result(timeout=TIMEOUT_S)
        mesh = {}
        for fut in futs:
            for rank, res in fut.result().items():
                for key, out in res.items():
                    mesh.setdefault(key, {})[rank] = out
    return setups, ref, mesh, meta


def test_plans_split_and_gather_the_heads():
    """whisper's 4 / 4 heads split at model 2 and 4 (its 16 / 16 at 2, 4
    and 16); qwen2-vl's 4 / 2 split at 2 and gather the q heads at 4 (its
    28 / 4 split at 2 and 4, whole at 16); the GELU MLP's d_ff splits."""
    from repro_torch.configs import get_config
    wh, vl = port_cfg(_jcfg(ARCHS[0])), port_cfg(_jcfg(ARCHS[1]))
    for m in (2, 4):
        plan = R.tp_plan(wh, {"data": 1, "model": m})
        assert plan.attn == "split" and plan.ffn
    assert R.tp_plan(vl, {"data": 1, "model": 2}).attn == "split"
    assert R.tp_plan(vl, {"data": 1, "model": 4}).attn == "gather_q"
    for m in (2, 4, 16):
        assert R.tp_plan(get_config(ARCHS[0]),
                         {"data": 16, "model": m}).attn == "split"
    full = get_config(ARCHS[1])
    assert [R.tp_plan(full, {"data": 16, "model": m}).attn
            for m in (2, 4, 16)] == ["split", "split", "whole"]


def test_gelu_bias_and_cross_valid_follow_the_heads():
    """The placements that differ from the reference's spec: ``b_in``
    follows ``w_in``'s columns at every size, ``b_out`` stays whole, and
    the cross cache's ``valid`` is sliced by the rank's kv heads."""
    wh = port_cfg(_jcfg(ARCHS[0]))
    mesh = {"data": 1, "model": 2}
    for name, want in (("b_in", "model"), ("b_out", None)):
        spec = R.param_placement(("blocks", "b0", "mlp", name),
                                 (wh.n_repeats, wh.d_ff if name == "b_in"
                                  else wh.d_model), mesh, wh)
        assert spec == (None, want), name
    shape = (wh.n_repeats, 2, wh.n_kv_heads, 16)
    path = ("blocks", "b0", "cross", "valid")
    assert R.cache_placement(path, shape, mesh, wh)[2] == "model"
    assert R._cache_leaf_spec(path, shape, mesh, wh, False)[2] is None


@pytest.mark.parametrize("arch,shape", CASES)
def test_train_step_matches_reference(runs, arch, shape):
    setups, ref, mesh, _ = runs
    tcfg = setups[arch][1]
    want = ref[arch]["train"]
    assert want["aux"]["distill"] > 0
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
    """Tokens equal, logits and every cache leaf's block (the cross
    cache's included) as the module says; whisper's cross memory kept
    16 of 32 a head, and the rank's ``valid`` exact."""
    setups, ref, mesh, _ = runs
    tcfg = setups[arch][1]
    want = ref[arch]
    if tcfg.is_encdec:
        valid = want["prefill"]["caches"][("blocks", "b0", "cross",
                                           "valid")]
        assert valid.shape[-1] == 16 and not valid.all()
    for rank, out in mesh[(arch, shape)].items():
        rows = _rows(shape, out["coords"], BATCH)
        got = out["prefill"]
        _close(got["logits"], want["prefill"]["logits"][rows], TOL,
               (arch, shape, rank, "logits"))
        assert abs(got["adm"] - want["prefill"]["adm"]) < TOL
        _cache_blocks(tcfg, shape, out["coords"], got["caches"],
                      want["prefill"]["caches"],
                      what=(arch, shape, rank, "prefill"))
        for i, ((lg, tok), (rlg, rtok)) in enumerate(zip(
                out["decode"]["steps"], want["decode"]["steps"])):
            np.testing.assert_array_equal(tok, rtok[rows])
            _close(lg, rlg[rows], TOL, (arch, shape, rank, "decode", i))
        _cache_blocks(tcfg, shape, out["coords"], out["decode"]["caches"],
                      want["decode"]["caches"],
                      what=(arch, shape, rank, "decode"))


@pytest.mark.parametrize("shape", MESHES)
def test_vlm_serving_matches_reference(runs, shape):
    """qwen2-vl served on the mesh: ``dense`` tokens equal to the
    reference's flat engine's (the first request fills its row), ``wgkv``
    to the port's flat engine's; every rank's block of each final
    cache."""
    setups, ref, mesh, _ = runs
    arch = "qwen2-vl-7b"
    want = ref[arch]["serve"]
    assert [len(t) for t in want["dense"]["tokens"]] == \
        [m for _, m in DENSE_REQS]
    for rank, out in mesh[(arch, shape)].items():
        for name in ("wgkv", "dense"):
            got = out["serve"][name]
            assert got["tokens"] == want[name]["tokens"], (shape, rank, name)
            _cache_blocks(setups[arch][1], shape, out["coords"],
                          got["caches"], want[name]["caches"],
                          what=(shape, rank, name))
        assert out["serve"]["wgkv"]["paged_dev"] < 2e-3


@pytest.mark.parametrize("name,shape", [(n, m) for n, _, *ms in SEQ_DENSE
                                        for m in ms])
def test_seq_sharded_dense_read_matches_reference(runs, name, shape):
    """The dense baseline's buffer split over "data": only the block that
    holds position t writes it, each block reads its keys, and the reads
    combine by their log-sum-exp."""
    setups, ref, mesh, _ = runs
    arch = dict((n, a) for n, a, *_ in SEQ_DENSE)[name]
    want = ref["seq"][name]
    for rank, out in mesh[(name, shape)].items():
        got = out["seq"]
        for i, ((lg, tok), (rlg, rtok)) in enumerate(zip(got["steps"],
                                                         want["steps"])):
            np.testing.assert_array_equal(tok, rtok)
            _close(lg, rlg, TOL, (name, shape, rank, i))
        _cache_blocks(setups[arch][1], shape, out["coords"], got["caches"],
                      want["caches"], seq_shard=True,
                      what=(name, shape, rank))


@pytest.mark.parametrize("sel", sorted(QUEST))
def test_seq_sharded_quest_read_matches_reference(runs, sel):
    """Quest on a global cache split over "data" (2 x 1), gather and mask
    modes: every rank takes the same global ids and reads those its block
    holds; the selected-page counts are the global ones; at K = every
    page the read is bitwise the unselected seq-sharded read."""
    setups, ref, mesh, _ = runs
    want = ref["seq"]["quest"][sel]
    tcfg = setups["qwen3-0.6b"][1]
    sels = []
    for rank, out in mesh[("quest", (2, 1))].items():
        got = out["seq"][sel]
        for i, ((lg, tok), (rlg, rtok)) in enumerate(zip(got["steps"],
                                                         want["steps"])):
            np.testing.assert_array_equal(tok, rtok)
            _close(lg, rlg, TOL, (sel, rank, i))
        _cache_blocks(tcfg, (2, 1), out["coords"], got["caches"],
                      want["caches"], seq_shard=True, what=(sel, rank))
        if sel.endswith("4"):
            for (lg, _), (plg, _) in zip(got["steps"],
                                         out["seq"]["plain"]["steps"]):
                np.testing.assert_array_equal(lg, plg)
        sels.append(np.stack(got["sel"]))
    np.testing.assert_array_equal(sels[0], sels[1])
    if sel.startswith("gather"):
        assert sels[0].max() > 0


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
    for k in ("gate_mlp", "gated_flash", "vertical_slash"):
        assert tr["kernels"].get(k) == wtr["kernels"].get(k)
    for kind, step, have in zip(
            ("train", "prefill", "decode"), encdec_shapes(tcfg),
            (tr["collectives"], got["prefill"]["counts"]["collectives"],
             got["decode_counts"]["collectives"])):
        with small_vlm_grid():
            assert have == mesh_collective_bytes(
                tcfg, step, _mesh(shape), backend="gloo"), (arch, shape,
                                                            kind)
