"""Rank bodies for ``tests/test_torch_mesh_archs.py`` and
``tests/test_torch_mesh_encdec.py`` (torch only: the ranks are spawned
processes and never import JAX).

:func:`arch_meshes` runs on every rank of one ``gloo`` world on the CPU:
for each arch and each mesh shape it is given it builds the mesh over
that world and runs, from the parent's numpy weights, the sharded step
bundles of ``launch.steps.make_bundle`` (one train step, one prefill and
three greedy decode steps on its caches, and where "data" has two ranks a
seq-sharded decode of one row on the flat prefill's cache), then serves
two drives through the orchestrator: ``wgkv`` with three requests, and
``dense`` with a request that fills its row's capacity and stays parked
while the others decode. It returns what the parent compares: losses,
gate slices and first moments, logits, tokens, cache blocks, each step's
counts, and the top-k expert ids of every routing the rank did.

:func:`encdec_meshes` runs the same steps for whisper-medium (with its
encoder frames) and qwen2-vl-7b (with its patches, on a small grid; it
serves the two drives too), and the seq-sharded decode reads: the dense
baseline's buffer split over "data" (:func:`seq_dense`) and Quest
selection over a split global cache (:func:`seq_quest`).
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.configs.base import InputShape
from repro_torch.convert import params_from_numpy
from repro_torch.kernels.ops import _identity_tables
from repro_torch.launch import specs
from repro_torch.launch.mesh import init_mesh
from repro_torch.launch.steps import make_bundle
from repro_torch.models import inference as I
from repro_torch.models import moe as MoE
from repro_torch.roofline.counter import WorkCounter
from repro_torch.serving.backend import make_backend
from repro_torch.serving.orchestrator import Orchestrator, SchedulerConfig
from repro_torch.sharding import comm, rules
from repro_torch.tree import tree_leaves_with_path

S, BATCH = 32, 2
TRAIN = InputShape("train_cpu", S, BATCH, "train")
PREFILL = InputShape("prefill_cpu", S, BATCH, "prefill")
DECODE = InputShape("decode_cpu", S, BATCH, "decode")
DECODE_ONE = InputShape("decode_one", S, 1, "decode")
DECODE_STEPS = 3
# the routing groups of the batch-2 steps on every mesh: the reference's
# exec_knobs on a mesh with "data" 2 (there each rank routes its own row's
# group); a mesh with "data" 1 takes the same count as an override
MOE_GROUPS = 2
# serving: 4 slots (2 a data rank when "data" splits them); the dense
# drive's first request fills its row (its prompt and the new tokens but
# the last reach the capacity) and is stepped masked, parked, while the
# other two decode
SLOTS, CAPACITY = 4, 32
WGKV_REQS = [(12, 3), (18, 3), (24, 3)]
DENSE_REQS = [(CAPACITY - 5, 6), (9, 8), (14, 8)]


def prompts(reqs, seed: int):
    """The drive's prompts (token ids from a fixed numpy stream)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 500, n).tolist() for n, _ in reqs]


def host_tree(tree):
    """{path: numpy} of a tree's tensors."""
    return {tuple(str(k) for k in p): x.detach().numpy().copy()
            for p, x in tree_leaves_with_path(tree)}


def counts(wc: WorkCounter):
    """What the parent holds equal to the meta run: FLOPs, bytes,
    launches and collective bytes by axis."""
    rec = wc.record()
    return {"flops": rec["flops"], "bytes": rec["bytes"],
            "kernels": {k: v["launches"] for k, v in rec["kernels"].items()},
            "collectives": dict(rec["collective_bytes_by_axis"])}


class Routes:
    """Records the top-k ids and the probabilities of every routing."""

    def __init__(self):
        self.ids, self.probs = [], []
        self._inner = MoE.route

    def __enter__(self):
        def rec(p, cfg, xf):
            # host copies only: no op the work counter would count
            r = self._inner(p, cfg, xf)
            self.ids.append(r.top_idx.numpy().copy())
            self.probs.append(r.probs.numpy().copy())
            return r
        MoE.route = rec
        return self

    def __exit__(self, *exc):
        MoE.route = self._inner


def with_inputs(bundle, inputs, mesh):
    """The bundle's args with its inputs replaced by this rank's blocks
    of ``inputs`` (whole tensors)."""
    specs = bundle.in_shardings[-1]
    local = {k: rules.local_shard(v, specs[k], mesh.coords, mesh)
             for k, v in inputs.items()}
    return bundle.args[:-1] + (local,)


def knobs(cfg):
    """The bundles' knob overrides: :data:`MOE_GROUPS` for an MoE arch."""
    return {"moe_groups": MOE_GROUPS} if cfg.moe is not None else {}


def run_steps(mesh, cfg, params, data, *, shapes=(TRAIN, PREFILL, DECODE),
              train=None, prefill=None, seq=True):
    """The train, prefill and decode bundles of ``shapes`` (and, with
    ``seq``, the seq-sharded decode where "data" has two ranks). The
    train and prefill batches (whole tensors) default to ``data``'s
    tokens."""
    shape_tr, shape_pre, shape_dec = shapes
    if train is None:
        train = {"tokens": data["train_tokens"],
                 "loss_mask": data["loss_mask"]}
    if prefill is None:
        prefill = {"tokens": data["prefill_tokens"]}
    out = {"coords": mesh.coords}
    tr = make_bundle(cfg, shape_tr, use_wgkv=True, device="cpu",
                     params=params, mesh=mesh, knob_overrides=knobs(cfg))
    args = with_inputs(tr, train, mesh)
    _identity_tables.cache_clear()
    with WorkCounter() as wc:
        state, aux = tr.fn(*args)
    out["train"] = {"aux": {k: float(v) for k, v in aux.items()},
                    "gates": host_tree(state.gates),
                    "m": host_tree(state.opt.m), "counts": counts(wc)}
    pre = make_bundle(cfg, shape_pre, use_wgkv=True, device="cpu",
                      params=params, mesh=mesh, knob_overrides=knobs(cfg))
    args = with_inputs(pre, prefill, mesh)
    _identity_tables.cache_clear()
    with Routes() as routes:
        with WorkCounter() as wc:
            logits, adm, caches = pre.fn(*args)
        out["prefill"] = {"logits": logits.numpy().copy(),
                          "adm": float(adm), "caches": host_tree(caches),
                          "counts": counts(wc)}
        dec = make_bundle(cfg, shape_dec, use_wgkv=True, device="cpu",
                          params=params, caches=caches, mesh=mesh,
                          knob_overrides=knobs(cfg))
        token = logits.argmax(-1).to(torch.int32)
        steps = []
        for i in range(DECODE_STEPS):
            args = dec.args[:1] + (caches, {"token": token})
            _identity_tables.cache_clear()
            with WorkCounter() as wc:
                logits, caches = dec.fn(*args)
            if i == 0:
                out["decode_counts"] = counts(wc)
            token = logits.argmax(-1).to(torch.int32)
            steps.append((logits.numpy().copy(), token.numpy().copy()))
    out["decode"] = {"steps": steps, "caches": host_tree(caches)}
    out["routes"] = {"ids": routes.ids, "margins": [
        MoE.routing_margin(torch.from_numpy(p), cfg.moe.top_k)
        for p in routes.probs] if cfg.moe is not None else []}
    if seq and mesh.shape["data"] == 2:
        out["seq"] = seq_decode(mesh, cfg, params, data)
    return out


def seq_decode(mesh, cfg, params, data):
    """One row decoded with its global caches split over "data" (the
    context-parallel read), from the flat prefill's cache."""
    with torch.no_grad():
        _, flat = I.prefill(params, cfg, data["prefill_tokens"][:1],
                            use_wgkv=True,
                            budget=cfg.wgkv.global_budget(S),
                            max_len=S + 64)
    caches = rules.local_caches(flat, cfg, mesh, mesh.coords, seq_shard=True)
    dec = make_bundle(cfg, DECODE_ONE, use_wgkv=True, device="cpu",
                      params=params, caches=caches, mesh=mesh)
    token = data["seq_token"]
    steps = []
    for _ in range(DECODE_STEPS):
        logits, caches = dec.fn(dec.args[0], caches, {"token": token})
        token = logits.argmax(-1).to(torch.int32)
        steps.append((logits.numpy().copy(), token.numpy().copy()))
    return {"steps": steps, "caches": host_tree(caches)}


def drive(eng, reqs, seed: int):
    """The requests of ``reqs`` through ``eng`` (chunk 16)."""
    orch = Orchestrator(eng, sched=SchedulerConfig(chunk_tokens=16))
    for p, (_, m) in zip(prompts(reqs, seed), reqs):
        orch.submit(p, max_new=m)
    orch.run()
    return [orch.tokens(r) for r in range(len(reqs))]


def serve(mesh, cfg, params):
    """The wgkv and dense drives on ``mesh`` (None: flat): each one's
    tokens and final cache tree (this rank's block), and the dense
    engine's row block."""
    out = {}
    for name, reqs, seed in (("wgkv", WGKV_REQS, 1), ("dense", DENSE_REQS, 2)):
        eng = make_backend(name, params, cfg, slots=SLOTS, capacity=CAPACITY,
                           pool_pages=256, device="cpu", mesh=mesh,
                           mirror_paged=name == "wgkv")
        out[name] = {"tokens": drive(eng, reqs, seed),
                     "caches": host_tree(eng.caches)}
        if name == "wgkv":
            out[name]["paged_dev"] = eng.verify_paged()
    return out


def arch_meshes(world_mesh, jobs, data):
    """The rank body: for each ``(arch, cfg, params_np, shapes)`` of
    ``jobs``, :func:`run_steps` and :func:`serve` on each of ``shapes``
    (over this world)."""
    torch.set_num_threads(1)
    data = {k: torch.as_tensor(v) for k, v in data.items()}
    results = {}
    meshes = {}
    for arch, cfg, params_np, shapes in jobs:
        params = params_from_numpy(params_np, cfg, "cpu")
        for shape in shapes:
            shape = tuple(shape)
            if shape not in meshes:
                meshes[shape] = world_mesh if shape == (
                    world_mesh.shape["data"], world_mesh.shape["model"]) \
                    else init_mesh(shape, backend="gloo", device="cpu")
            mesh = meshes[shape]
            out = run_steps(mesh, cfg, params, data)
            out["serve"] = serve(mesh, cfg, params)
            results[(arch, shape)] = out
    return results


# ==========================================================================
# whisper-medium and qwen2-vl-7b on the mesh, and the seq-sharded dense
# and Quest reads (tests/test_torch_mesh_encdec.py)
# ==========================================================================
# the VLM grid of these runs (the bundles read ``specs.VLM_GRID``): 16
# patches lead a 32-token stream
SMALL_GRID = (4, 4)
# whisper's steps: the decoder prompt is ``dec_max_len`` (64 reduced),
# the encoder ``seq_len // 2`` = 32 frames, and at a budget fraction of
# 0.25 the self and cross caches keep 16 (the cross memory 16 of 32)
W_SEQ = 64
W_TRAIN = InputShape("train_w", W_SEQ, BATCH, "train")
W_PREFILL = InputShape("prefill_w", W_SEQ, BATCH, "prefill")
W_DECODE = InputShape("decode_w", W_SEQ, BATCH, "decode")


@contextlib.contextmanager
def small_vlm_grid():
    """``specs.VLM_GRID`` / ``VLM_N_IMG`` set to :data:`SMALL_GRID` for
    the block, restored after."""
    old = specs.VLM_GRID, specs.VLM_N_IMG
    specs.VLM_GRID = SMALL_GRID
    specs.VLM_N_IMG = SMALL_GRID[0] * SMALL_GRID[1]
    try:
        yield
    finally:
        specs.VLM_GRID, specs.VLM_N_IMG = old


def encdec_shapes(cfg):
    """(train, prefill, decode) shapes of ``cfg``'s steps."""
    if cfg.is_encdec:
        return W_TRAIN, W_PREFILL, W_DECODE
    return TRAIN, PREFILL, DECODE


def encdec_batches(cfg, d):
    """(train batch, prefill batch) of whole tensors from ``d`` (the
    arch's numpy draws): whisper's tokens and frames, the VLM's tokens
    and patches (and the zero positions the bundles rebuild)."""
    t = {k: torch.as_tensor(v) for k, v in d.items()}
    if cfg.is_encdec:
        return ({"tokens": t["train_tokens"], "loss_mask": t["loss_mask"],
                 "enc_embeds": t["train_extra"]},
                {"tokens": t["prefill_tokens"],
                 "enc_embeds": t["prefill_extra"]})
    pos = torch.zeros((3,) + tuple(t["train_tokens"].shape),
                      dtype=torch.int32)
    return ({"tokens": t["train_tokens"], "loss_mask": t["loss_mask"],
             "patch_embeds": t["train_extra"], "positions": pos},
            {"tokens": t["prefill_tokens"], "patch_embeds": t["prefill_extra"],
             "positions": pos})


def _steps(n, fn, token):
    """``n`` greedy steps of ``fn(token) -> (logits, caches)``."""
    steps, caches = [], None
    for _ in range(n):
        logits, caches = fn(token)
        token = logits.argmax(-1).to(torch.int32)
        steps.append((logits.numpy().copy(), token.numpy().copy()))
    return steps, caches


def seq_dense(mesh, cfg, params, tokens, token, max_len):
    """One row's dense baseline cache (``prefill(use_wgkv=False)`` of
    ``tokens`` [1, S] into a buffer of ``max_len``), its token axis split
    over "data", then the decode bundle's steps on it."""
    with torch.no_grad():
        _, flat = I.prefill(params, cfg, tokens, use_wgkv=False,
                            max_len=max_len)
    caches = rules.local_caches(flat, cfg, mesh, mesh.coords, seq_shard=True)
    dec = make_bundle(cfg, DECODE_ONE, use_wgkv=False, device="cpu",
                      params=params, caches=caches, mesh=mesh)
    state = {"caches": caches}

    def step(tok):
        logits, state["caches"] = dec.fn(dec.args[0], state["caches"],
                                         {"token": tok})
        return logits, state["caches"]
    steps, caches = _steps(DECODE_STEPS, step, token)
    return {"steps": steps, "caches": host_tree(caches)}


def seq_quest(mesh, cfg, params, tokens, token, selections):
    """One row's WG-KV cache (``prefill`` of ``tokens`` [1, S] at budget
    S), its global axis split over "data", then three decode steps per
    entry of ``selections`` ({name: DecodeOptions}) under the
    context-parallel read: the rank's model code under
    ``comm.active(seq="data")``, as the decode bundle runs it, with the
    options the bundle does not take."""
    s = tokens.shape[1]
    with torch.no_grad():
        _, flat = I.prefill(params, cfg, tokens, use_wgkv=True,
                            budget=cfg.wgkv.global_budget(s), max_len=s + 64)
    caches0 = rules.local_caches(flat, cfg, mesh, mesh.coords,
                                 seq_shard=True)
    plan = rules.tp_plan(cfg, mesh, mesh.coords["model"])
    lcfg = rules.local_config(cfg, plan)
    lparams = rules.local_params(params, cfg, mesh, mesh.coords)
    out = {}
    for name, opts in selections.items():
        state = {"caches": caches0, "sel": []}

        def step(tok, opts=opts, state=state):
            with torch.no_grad(), comm.active(mesh, plan, seq="data"):
                logits, state["caches"], st = I.decode_step(
                    lparams, lcfg, tok, state["caches"], opts=opts)
            state["sel"].append(st["selected_pages_rows"].numpy().copy())
            return logits, state["caches"]
        steps, caches = _steps(DECODE_STEPS, step, token)
        out[name] = {"steps": steps, "caches": host_tree(caches),
                     "sel": state["sel"]}
    return out


def _mesh_over(world_mesh, meshes, shape):
    shape = tuple(shape)
    if shape not in meshes:
        meshes[shape] = world_mesh if shape == (
            world_mesh.shape["data"], world_mesh.shape["model"]) \
            else init_mesh(shape, backend="gloo", device="cpu")
    return meshes[shape]


def encdec_meshes(world_mesh, jobs, seq_jobs):
    """The rank body of tests/test_torch_mesh_encdec.py: for each ``(arch,
    cfg, params_np, draws, shapes)`` of ``jobs`` :func:`run_steps` on each
    of ``shapes`` (and for the VLM :func:`serve`); for each ``(name, cfg,
    params_np, kind, shapes, kw)`` of ``seq_jobs`` :func:`seq_dense` or
    :func:`seq_quest` (``kind``) on each of ``shapes``."""
    torch.set_num_threads(1)
    results, meshes = {}, {}
    with small_vlm_grid():
        for arch, cfg, params_np, draws, shapes in jobs:
            params = params_from_numpy(params_np, cfg, "cpu")
            train, prefill = encdec_batches(cfg, draws)
            for shape in shapes:
                mesh = _mesh_over(world_mesh, meshes, shape)
                out = run_steps(mesh, cfg, params, None,
                                shapes=encdec_shapes(cfg), train=train,
                                prefill=prefill, seq=False)
                if not cfg.is_encdec:
                    out["serve"] = serve(mesh, cfg, params)
                results[(arch, tuple(shape))] = out
    for name, cfg, params_np, kind, shapes, kw in seq_jobs:
        params = params_from_numpy(params_np, cfg, "cpu")
        kw = dict(kw)
        tokens = torch.as_tensor(kw.pop("tokens"))
        token = torch.as_tensor(kw.pop("token"))
        for shape in shapes:
            mesh = _mesh_over(world_mesh, meshes, shape)
            fn = seq_dense if kind == "dense" else seq_quest
            out = fn(mesh, cfg, params, tokens, token, **kw)
            results[(name, tuple(shape))] = {"coords": mesh.coords,
                                             "seq": out}
    return results
