"""Rank bodies for ``tests/test_torch_sharded_steps.py`` (torch only: the
ranks are spawned processes and never import JAX).

:func:`step_meshes` runs on every rank of one ``gloo`` world on the CPU:
for each mesh shape it is given it builds the mesh over that world and
runs the sharded step bundles of ``launch.steps.make_bundle`` on the
parent's inputs: one train step, one prefill, decode steps on that
prefill's caches, and (where "data" has two ranks) a seq-sharded decode
of one row on the flat prefill's cache. It returns what the parent
compares: the rank's losses, gate slices and first moments, logits,
tokens and cache blocks, and each step's counts.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import InputShape
from repro_torch.convert import params_from_numpy
from repro_torch.kernels.ops import _identity_tables
from repro_torch.launch.mesh import init_mesh
from repro_torch.launch.steps import make_bundle
from repro_torch.models import inference as I
from repro_torch.roofline.counter import WorkCounter
from repro_torch.sharding import rules
from repro_torch.tree import tree_leaves_with_path, tree_map

S_TRAIN, S_PREFILL, BATCH = 64, 64, 2
TRAIN = InputShape("train_cpu", S_TRAIN, BATCH, "train")
PREFILL = InputShape("prefill_cpu", S_PREFILL, BATCH, "prefill")
DECODE = InputShape("decode_cpu", S_PREFILL, BATCH, "decode")
DECODE_ONE = InputShape("decode_one", S_PREFILL, 1, "decode")
DECODE_STEPS = 3
SEQ_STEPS = 6


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


def with_inputs(bundle, inputs, mesh):
    """The bundle's args with its inputs replaced by this rank's blocks
    of ``inputs`` (whole tensors)."""
    specs = bundle.in_shardings[-1]
    local = {k: rules.local_shard(v, specs[k], mesh.coords, mesh)
             for k, v in inputs.items()}
    return bundle.args[:-1] + (local,)


def run_steps(mesh, cfg, params, data):
    out = {"coords": mesh.coords}
    tr = make_bundle(cfg, TRAIN, use_wgkv=True, device="cpu",
                     params=params, mesh=mesh)
    args = with_inputs(tr, {"tokens": data["train_tokens"],
                            "loss_mask": data["loss_mask"]}, mesh)
    _identity_tables.cache_clear()
    with WorkCounter() as wc:
        state, aux = tr.fn(*args)
    out["train"] = {"loss": float(aux["loss"]),
                    "aux": {k: float(v) for k, v in aux.items()},
                    "gates": host_tree(state.gates),
                    "m": host_tree(state.opt.m), "counts": counts(wc)}
    pre = make_bundle(cfg, PREFILL, use_wgkv=True, device="cpu",
                      params=params, mesh=mesh)
    args = with_inputs(pre, {"tokens": data["prefill_tokens"]}, mesh)
    _identity_tables.cache_clear()
    with WorkCounter() as wc:
        logits, adm, caches = pre.fn(*args)
    out["prefill"] = {"logits": logits.numpy().copy(), "adm": float(adm),
                      "caches": host_tree(caches), "counts": counts(wc)}
    dec = make_bundle(cfg, DECODE, use_wgkv=True, device="cpu",
                      params=params, caches=caches, mesh=mesh)
    token = logits.argmax(-1).to(torch.int32)
    steps = []
    for i in range(DECODE_STEPS):
        args = dec.args[:1] + (caches, {"token": token})
        if i == 0:
            _identity_tables.cache_clear()
            with WorkCounter() as wc:
                logits, caches = dec.fn(*args)
            out["decode_counts"] = counts(wc)
            out["decode_shapes"] = {p: tuple(x.shape) for p, x in
                                    host_tree(args[1]).items()}
        else:
            logits, caches = dec.fn(*args)
        token = logits.argmax(-1).to(torch.int32)
        steps.append((logits.numpy().copy(), token.numpy().copy()))
    out["decode"] = {"steps": steps, "caches": host_tree(caches)}
    if mesh.shape["data"] == 2:
        out["seq"] = seq_decode(mesh, cfg, params, data)
    return out


def seq_decode(mesh, cfg, params, data):
    """One row decoded with its global cache split over "data" (the
    context-parallel read), from the flat prefill's cache."""
    with torch.no_grad():
        _, flat = I.prefill(params, cfg, data["prefill_tokens"][:1],
                            use_wgkv=True,
                            budget=cfg.wgkv.global_budget(S_PREFILL),
                            max_len=S_PREFILL + 64)
    caches = rules.local_caches(flat, cfg, mesh, mesh.coords, seq_shard=True)
    dec = make_bundle(cfg, DECODE_ONE, use_wgkv=True, device="cpu",
                      params=params, caches=caches, mesh=mesh)
    token = data["seq_token"]
    steps, gcnt = [], []
    for _ in range(SEQ_STEPS):
        gcnt.append(caches["blocks"]["b0"].gcnt.numpy().copy())
        logits, caches = dec.fn(dec.args[0], caches, {"token": token})
        token = logits.argmax(-1).to(torch.int32)
        steps.append((logits.numpy().copy(), token.numpy().copy()))
    return {"steps": steps, "caches": host_tree(caches), "gcnt": gcnt,
            "block": caches["blocks"]["b0"].gk.shape[3]}


def step_meshes(world_mesh, cfg, params_np, data, shapes):
    """The rank body: :func:`run_steps` on each of ``shapes`` (over this
    world)."""
    torch.set_num_threads(1)
    params = params_from_numpy(params_np, cfg, "cpu")
    data = tree_map(torch.as_tensor, data)
    results = {}
    for shape in shapes:
        mesh = world_mesh if tuple(shape) == (
            world_mesh.shape["data"], world_mesh.shape["model"]) \
            else init_mesh(shape, backend="gloo", device="cpu")
        results[tuple(shape)] = run_steps(mesh, cfg, params, data)
    return results
