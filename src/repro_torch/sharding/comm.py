"""The mesh's explicit collectives (new in the port: the reference's GSPMD
inserts its collectives itself, so it has no counterpart module).

Serving on a mesh is multi-controller SPMD: every rank runs the same
orchestrator, scheduler and engine on the same inputs, holds its shard of
the weights and caches as plain local tensors, and calls the collectives
below where GSPMD would insert them. The engine enters :func:`active`
around each model call, the role ``rules.activation_sharding`` plays in
the reference; the model's seams then read the context:

* :func:`reduce_model` — sum the partials of a row-parallel product over
  "model" (``w_o`` after the attention, ``w_down`` after the FFN);
* :func:`gather_q` / :func:`local_q` — the "gather_q" plan (q heads split,
  kv heads whole): assemble every q head before the read, and keep this
  rank's heads' outputs for its ``w_o`` rows.

The engine and the scheduler call the others with their mesh:

* :func:`gather_rows` — assemble a batch-leading tensor from the "data"
  ranks' rows;
* :func:`all_reduce` — over "model", "data" or the whole mesh;
* :func:`host_all_reduce` — host numbers summed (or their max) over an
  axis, and :func:`bcast_from_root` — every rank takes rank 0's
  decision. These two travel on the mesh's ``gloo`` groups as CPU
  tensors whatever its backend, so a host decision never syncs the host
  with a card.

Every helper is the identity when no mesh is set, and a group of one rank
calls nothing. Only ``all_reduce`` and ``broadcast`` run, the two
collectives ``gloo`` moves CUDA tensors for: ``gather_rows`` is an
``all_reduce`` of a zero-filled buffer in which each rank writes its own
rows (adding exact zeros is exact). Each collective of device tensors
reports its bytes, in the ring accounting of
``roofline.counter.collective_bytes``, to an active
``roofline.counter.WorkCounter``, the one tally.
"""
from __future__ import annotations

import contextlib
from typing import Any, Iterator, List, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.roofline import counter
from repro_torch.tree import tree_leaves

# (mesh, plan) while the engine runs the model on a mesh
ACTIVE: Optional[tuple] = None


@contextlib.contextmanager
def active(mesh, plan) -> Iterator[None]:
    """Run model code on ``mesh`` under ``plan``
    (:class:`repro_torch.sharding.rules.TPPlan`); no-op for ``mesh=None``."""
    global ACTIVE
    prev = ACTIVE
    ACTIVE = None if mesh is None else (mesh, plan)
    try:
        yield
    finally:
        ACTIVE = prev


def _mesh(mesh):
    if mesh is not None:
        return mesh
    return ACTIVE[0] if ACTIVE is not None else None


def all_reduce(x: torch.Tensor, mesh=None,
               axis: str = "world") -> torch.Tensor:
    """``x`` summed in place over ``axis`` ("model", "data" or "world")
    of ``mesh`` (default: the active one)."""
    mesh = _mesh(mesh)
    if mesh is None:
        return x
    group, n = mesh.group(axis)
    if n == 1:
        return x
    dist.all_reduce(x, group=group)
    _count(axis, "all_reduce", x, n)
    return x


def reduce_model(x: torch.Tensor, part: str) -> torch.Tensor:
    """Sum a row-parallel product's partials over "model" when the active
    plan splits ``part`` ("attn" or "ffn"); else ``x``."""
    if ACTIVE is None:
        return x
    mesh, plan = ACTIVE
    if (part == "attn" and plan.attn == "whole") or \
            (part == "ffn" and not plan.ffn):
        return x
    return all_reduce(x.contiguous(), mesh, "model")


def gather_q(q: torch.Tensor) -> torch.Tensor:
    """[..., local q heads * hd] -> [..., all q heads * hd] under the
    "gather_q" plan (each rank writes its heads into a zero-filled
    buffer); else ``q``."""
    if ACTIVE is None or ACTIVE[1].attn != "gather_q":
        return q
    mesh, plan = ACTIVE
    first, n = plan.q_heads
    hd = q.shape[-1] // n
    buf = q.new_zeros(q.shape[:-1] + (plan.n_heads * hd,))
    buf[..., first * hd:(first + n) * hd] = q
    return all_reduce(buf, mesh, "model")


def local_q(o: torch.Tensor) -> torch.Tensor:
    """[..., all q heads * hd] -> this rank's heads under the "gather_q"
    plan, the rows its ``w_o`` holds; else ``o``."""
    if ACTIVE is None or ACTIVE[1].attn != "gather_q":
        return o
    plan = ACTIVE[1]
    first, n = plan.q_heads
    hd = o.shape[-1] // plan.n_heads
    return o[..., first * hd:(first + n) * hd]


def gather_rows(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """The data ranks' rows of a batch-leading tensor, assembled on every
    rank in data order: [rows, ...] -> [data * rows, ...]."""
    mesh = _mesh(mesh)
    if mesh is None:
        return x
    _, d = mesh.group("data")
    if d == 1:
        return x
    n = x.shape[0]
    i = mesh.coords["data"]
    buf = x.new_zeros((d * n,) + tuple(x.shape[1:]))
    buf[i * n:(i + 1) * n] = x
    return all_reduce(buf, mesh, "data")


def host_all_reduce(values: Sequence, mesh=None, axis: str = "world",
                    op: str = "sum") -> list:
    """Host numbers (ints, or floats) reduced over ``axis`` in one
    collective on the mesh's ``gloo`` group: every rank gets the same
    list."""
    vals = list(values)
    mesh = _mesh(mesh)
    if mesh is None:
        return vals
    group, n = mesh.group(axis, host=True)
    if n == 1:
        return vals
    ints = all(isinstance(v, int) for v in vals)
    t = torch.tensor(vals, dtype=torch.int64 if ints else torch.float64)
    dist.all_reduce(t, op=dist.ReduceOp.SUM if op == "sum"
                    else dist.ReduceOp.MAX, group=group)
    return t.tolist()


def bcast_from_root(obj: List[int], mesh=None) -> List[int]:
    """Rank 0's list of ints on every rank of ``mesh`` (a host decision,
    such as which requests a deadline expired), over its ``gloo``
    group."""
    mesh = _mesh(mesh)
    if mesh is None:
        return obj
    group, n = mesh.group("world", host=True)
    if n == 1:
        return obj
    size = torch.tensor([len(obj)], dtype=torch.int64)
    dist.broadcast(size, src=0, group=group)
    vals = torch.tensor(obj if mesh.rank == 0 else [0] * int(size[0]),
                        dtype=torch.int64)
    if vals.numel():
        dist.broadcast(vals, src=0, group=group)
    return vals.tolist()


def broadcast_tree(tree: Any, src_data: int, mesh=None) -> Any:
    """Every leaf of ``tree`` from the rank at data index ``src_data`` (and
    this rank's model index) to the other data ranks, in place."""
    mesh = _mesh(mesh)
    if mesh is None:
        return tree
    group, d = mesh.group("data")
    if d == 1:
        return tree
    src = mesh.global_rank(src_data, mesh.coords["model"])
    for leaf in tree_leaves(tree):
        dist.broadcast(leaf, src=src, group=group)
        _count("data", "broadcast", leaf, d)
    return tree


def _count(axis: str, kind: str, x: torch.Tensor, n: int) -> None:
    if counter.ACTIVE is not None:
        counter.ACTIVE.collective(counter.collective_bytes(
            kind, x.numel() * x.element_size(), n), axis)
