"""Rank bodies for ``tests/test_torch_mesh_xlstm.py`` (torch only: the
ranks are spawned processes and never import JAX).

:func:`xlstm_meshes` runs on every rank of one ``gloo`` world on the CPU.
For each mesh shape it is given it builds the mesh over that world and
runs, from the parent's numpy weights, reduced xlstm-350m's sharded step
bundles (``launch.steps.make_bundle``): the full-parameter train step
(its gradients before AdamW too, ``trainer.lm_loss_and_grads`` under the
bundle's context), a prefill and :data:`DECODE_STEPS` greedy decode
steps on its states; and where "data" has two ranks, the gradient
through an MoE routing group gathered over "data" (:func:`moe_grad`,
reduced granite-moe-3b-a800m's ``moe_ffn(groups=1)``). It returns what
the parent compares: losses, the rank's blocks of every gradient, new
parameter and AdamW moment, logits, tokens, state blocks and counts.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import InputShape
from repro_torch.convert import flat_paths, params_from_numpy
from repro_torch.launch.mesh import init_mesh
from repro_torch.launch.steps import make_bundle
from repro_torch.models import moe as MoE
from repro_torch.roofline.counter import WorkCounter
from repro_torch.sharding import comm, rules
from repro_torch.training import trainer as TR
from torch_steps_worker import counts, host_tree, with_inputs

S, BATCH = 32, 2
TRAIN = InputShape("train_cpu", S, BATCH, "train")
PREFILL = InputShape("prefill_cpu", S, BATCH, "prefill")
DECODE = InputShape("decode_cpu", S, BATCH, "decode")
DECODE_STEPS = 8
# the train step starts from this AdamW step count, so that it runs at
# the schedule's peak rate (1e-3 at step 750 of cosine_schedule(1e-3,
# 7500)) and its update shows in the new parameters
START_STEP = 749


def flat(tree):
    """{``/``-joined path: numpy} of a parameter tree."""
    return {k: v.detach().numpy().copy() for k, v in flat_paths(tree)}


def train(mesh, cfg, params, data):
    """The train bundle's step from AdamW step :data:`START_STEP`, and its
    gradients before AdamW."""
    tr = make_bundle(cfg, TRAIN, use_wgkv=False, device="cpu",
                     params=params, mesh=mesh)
    args = with_inputs(tr, {"tokens": data["train_tokens"],
                            "loss_mask": data["loss_mask"]}, mesh)
    state, batch = args
    state = state._replace(opt=state.opt._replace(
        step=torch.tensor(START_STEP, dtype=torch.int32)))
    args = (state, batch)
    plan = rules.tp_plan(cfg, mesh, mesh.coords["model"])
    with comm.active(mesh, plan,
                     fsdp=rules.fsdp_placement(params, cfg, mesh),
                     rows=rules.tokens_spec(mesh, BATCH, 0)[0]):
        loss, _, grads = TR.lm_loss_and_grads(
            state.params, rules.local_config(cfg, plan), batch,
            remat=tr.knobs["remat"])
    with WorkCounter() as wc:
        new, aux = tr.fn(*args)
    return {"loss": float(loss), "grads": flat(grads),
            "aux": {k: float(v) for k, v in aux.items()},
            "params": flat(new.params), "m": flat(new.opt.m),
            "v": flat(new.opt.v), "counts": counts(wc)}


def serve(mesh, cfg, params, data):
    """A prefill and greedy decode steps on its states."""
    pre = make_bundle(cfg, PREFILL, use_wgkv=False, device="cpu",
                      params=params, mesh=mesh)
    args = with_inputs(pre, {"tokens": data["prefill_tokens"]}, mesh)
    with WorkCounter() as wc:
        logits, _, caches = pre.fn(*args)
    out = {"logits": logits.numpy().copy(), "caches": host_tree(caches),
           "counts": counts(wc)}
    dec = make_bundle(cfg, DECODE, use_wgkv=False, device="cpu",
                      params=params, caches=caches, mesh=mesh)
    token = logits.argmax(-1).to(torch.int32)
    steps = []
    for _ in range(DECODE_STEPS):
        logits, caches = dec.fn(dec.args[0], caches, {"token": token})
        token = logits.argmax(-1).to(torch.int32)
        steps.append((logits.numpy().copy(), token.numpy().copy()))
    out["steps"] = steps
    out["states"] = host_tree(caches)
    return out


def moe_grad(mesh, cfg, params_np, x, c):
    """The gradient of ``<y, c> + 0.01 lb`` through ``moe_ffn(groups=1)``
    of block 0's first repeat with the batch rows split over "data" (so
    the one group spans the data ranks): the rank's rows of x's gradient
    and its blocks of the router's and the experts' gradients, summed
    over "data"."""
    params = params_from_numpy(params_np, cfg, "cpu")
    local = rules.local_params(params, cfg, mesh, mesh.coords)
    p = {k: v[0].clone().requires_grad_()
         for k, v in local["blocks"]["b0"]["moe"].items()}
    rows = rules.block(x.shape[0], "data", mesh.coords, mesh)
    xl = x[rows].clone().requires_grad_()
    plan = rules.tp_plan(cfg, mesh, mesh.coords["model"])
    with comm.active(mesh, plan, rows="data"), torch.enable_grad():
        y, aux = MoE.moe_ffn(p, rules.local_config(cfg, plan), xl,
                             groups=1)
        dot = comm.sum_rows((y * c[rows]).sum()[None])[0]
        loss = dot + 0.01 * aux["lb_loss"]
        grads = torch.autograd.grad(loss, [xl] + list(p.values()))
    out = {"x": grads[0].numpy().copy(), "y": y.detach().numpy().copy(),
           "lb": float(aux["lb_loss"]), "loss": float(loss)}
    for k, g in zip(p, grads[1:]):
        out[k] = comm.all_reduce(g.clone(), mesh, "data").numpy().copy()
    return out


def xlstm_meshes(world_mesh, cfg, params_np, data, shapes, moe=None):
    """The rank body: :func:`train` and :func:`serve` on each of
    ``shapes`` (over this world), and :func:`moe_grad` (``moe``: the MoE
    config, its numpy weights, x and the cotangent) where "data" has two
    ranks."""
    torch.set_num_threads(1)
    params = params_from_numpy(params_np, cfg, "cpu")
    data = {k: torch.as_tensor(v) for k, v in data.items()}
    results = {}
    for shape in shapes:
        mesh = world_mesh if tuple(shape) == (
            world_mesh.shape["data"], world_mesh.shape["model"]) \
            else init_mesh(shape, backend="gloo", device="cpu")
        out = {"coords": mesh.coords,
               "train": train(mesh, cfg, params, data),
               "serve": serve(mesh, cfg, params, data)}
        if moe is not None and mesh.shape["data"] == 2:
            mcfg, mparams, x, c = moe
            out["moe"] = moe_grad(mesh, mcfg, mparams, torch.as_tensor(x),
                                  torch.as_tensor(c))
        results[tuple(shape)] = out
    return results


def full_width_counts(shapes, meshes):
    """{(mesh, shape name): collective bytes by axis} of xlstm-350m's
    bundles at full width (its config's dtype), each run on ``meta`` as
    rank 0 of a ``fake`` group standing for nccl: the count the parent
    holds to ``torch_mesh_counts``. Runs in a process of its own (a
    process holds one fake group at a time)."""
    from repro_torch.configs import get_config, get_shape
    from repro_torch.kernels.ops import _identity_tables
    from repro_torch.launch.mesh import fake_mesh
    cfg = get_config("xlstm-350m")
    out = {}
    for mshape in meshes:
        for name in shapes:
            with fake_mesh(mshape) as mesh:
                bd = make_bundle(cfg, get_shape(name), use_wgkv=False,
                                 mesh=mesh)
                _identity_tables.cache_clear()
                with WorkCounter() as wc:
                    bd.fn(*bd.args)
            out[(tuple(mshape), name)] = dict(
                wc.record()["collective_bytes_by_axis"])
    return out
