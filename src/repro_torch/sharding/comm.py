"""The mesh's explicit collectives (new in the port: the reference's GSPMD
inserts its collectives itself, so it has no counterpart module).

The mesh is multi-controller SPMD: every rank runs the same
orchestrator, scheduler and engine (or the same step bundle,
``launch/steps.py``) on the same inputs, holds its shard of the weights
and caches as plain local tensors, and calls the collectives below where
GSPMD would insert them. The engine and the bundles enter :func:`active`
around each model call, the role ``rules.activation_sharding`` plays in
the reference; the model's seams then read the context:

* :func:`reduce_model` — sum the partials of a row-parallel product over
  "model" (``w_o`` after the attention, ``w_down`` after the FFN);
* :func:`copy_to_model` — the input of a column-parallel product
  (``w_q``, ``w_k``, ``w_v``, ``w_gate``, ``w_up``), and under "gather_q"
  the whole k, v and gates a per-head read consumes: the identity, whose
  gradient is summed over "model" (each rank's gradient is the part its
  heads or columns give);
* :func:`gather_q` / :func:`local_q` — the "gather_q" plan (q heads split,
  kv heads whole): assemble every q head before the read, and keep this
  rank's heads' outputs for its ``w_o`` rows;
* :func:`gather_params` / :func:`gather_fsdp` — FSDP: a layer's leaves
  assembled from their "data" (and "pod") blocks just before the layer
  runs, and dropped after it;
* :func:`sum_rows` — loss terms (sums and counts) added over the axes
  the batch rows are split over (and over "model" for a per-kv-head
  term when the heads are split), and :func:`sum_grads` the gradients
  over the rows' axes (an FSDP leaf's were summed by its gather's
  backward, a reduce-scatter);
* :func:`combine_lse` — context-parallel decode: each "data" rank's read
  of its block of the global cache, combined by its log-sum-exp;
* :func:`gather_moe_rows` — an MoE block's input gathered over the rows'
  axes when its routing group spans the data ranks (:func:`rows_block`
  says where this rank's rows sit), and :func:`shared_term` — a term
  every such rank computes from the whole group, counted once in the
  summed gradients;
* :func:`gather_model` / :func:`sum_model` — the xLSTM blocks' seams:
  the rank's channels assembled over "model" (the mLSTM's before its
  heads' q / k / v, the sLSTM's cell outputs before its MLP), and the
  mLSTM ``out_norm``'s sum of squares over the whole width.

The first four, the gathers and the sums go through autograd: forward and backward are the
tensor-parallel pair (a sum over "model" forward is the identity
backward, and the reverse), written here because torch's ready-made
differentiable all-reduce also sums in its backward.

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
calls nothing. On ``gloo`` only ``all_reduce`` and ``broadcast`` run, the
two collectives ``gloo`` moves CUDA tensors for: ``gather_rows``, and on
``gloo`` ``gather_q`` and ``gather_fsdp``, are an ``all_reduce`` of a
zero-filled buffer in which each rank writes its own block (adding exact
zeros is exact); on ``nccl`` (and a ``fake`` group that stands for it,
``launch.mesh.fake_mesh``) ``gather_q`` and ``gather_fsdp`` are
``all_gather_into_tensor``. That is a choice by backend, not a
fallback. Each collective of device tensors reports the
bytes it really moves, in the ring accounting of
``roofline.counter.collective_bytes``, to an active
``roofline.counter.WorkCounter``, the one tally, under its group's key
(``Mesh.axes_key``: "model", "data", "pod+data", "world").
"""
from __future__ import annotations

import contextlib
from typing import (Any, Dict, Iterator, List, Mapping, NamedTuple,
                    Optional, Sequence, Tuple)

import torch
import torch.distributed as dist

from repro_torch.roofline import counter
from repro_torch.tree import tree_leaves, tree_map_with_path


class Active(NamedTuple):
    """What the model code runs under on a mesh: the mesh, the rank's
    :class:`~repro_torch.sharding.rules.TPPlan`, and for a step bundle
    the FSDP placement (``{path: spec}`` of the leaves held in "data"
    blocks), the spec entry the batch rows are split over (None: every
    data rank holds every row) and the entry the global token axis of a
    seq-sharded decode cache is split over (None: not seq-sharded)."""
    mesh: Any
    plan: Any
    fsdp: Mapping[str, tuple] = {}
    rows: Any = None
    seq: Any = None


# set while the engine or a step bundle runs the model on a mesh
ACTIVE: Optional[Active] = None


@contextlib.contextmanager
def active(mesh, plan, *, fsdp: Optional[Mapping[str, tuple]] = None,
           rows=None, seq=None) -> Iterator[None]:
    """Run model code on ``mesh`` under ``plan``
    (:class:`repro_torch.sharding.rules.TPPlan`) and, for a step bundle,
    its FSDP placement, rows and seq entries (:class:`Active`); no-op for
    ``mesh=None``."""
    global ACTIVE
    prev = ACTIVE
    ACTIVE = None if mesh is None else Active(mesh, plan, dict(fsdp or {}),
                                              rows, seq)
    try:
        yield
    finally:
        ACTIVE = prev


def _mesh(mesh):
    if mesh is not None:
        return mesh
    return ACTIVE.mesh if ACTIVE is not None else None


def all_reduce(x: torch.Tensor, mesh=None, axis="world",
               op: str = "sum") -> torch.Tensor:
    """``x`` summed (or its max, ``op="max"``) in place over ``axis``
    ("model", "data", a tuple of axes, or "world") of ``mesh`` (default:
    the active one)."""
    mesh = _mesh(mesh)
    if mesh is None:
        return x
    group, n = mesh.group(axis)
    if n == 1:
        return x
    dist.all_reduce(x, op=dist.ReduceOp.SUM if op == "sum"
                    else dist.ReduceOp.MAX, group=group)
    _count(mesh.axes_key(axis), "all_reduce", x, n)
    return x


def _wants_grad(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


class _SumForward(torch.autograd.Function):
    """Forward: the sum over ``axis``; backward: the identity (the
    output's gradient is the same on every rank of the axis, and it is
    each partial's)."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        return all_reduce(x.contiguous().clone(), mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _SumBackward(torch.autograd.Function):
    """Forward: the identity; backward: the gradient summed over
    ``axis`` (each rank's gradient is the part its own heads or columns
    give)."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.mesh, ctx.axis), \
            None, None


def _sum(x: torch.Tensor, mesh, axis) -> torch.Tensor:
    """``x`` summed over ``axis``: in place without a graph, else through
    :class:`_SumForward`."""
    if _wants_grad(x):
        return _SumForward.apply(x, mesh, axis)
    return all_reduce(x.contiguous(), mesh, axis)


def _splits(part: str, plan) -> bool:
    if part == "attn":
        return plan.attn != "whole"
    if part == "ffn":
        return plan.ffn
    if part == "kv":
        return plan.attn == "gather_q"
    if part == "moe":
        return plan.moe != "whole"
    if part == "rec":
        return plan.rec
    if part == "xlstm":
        return plan.xlstm
    raise ValueError(f"unknown part {part!r}")


def splits(part: str) -> bool:
    """The active plan splits ``part`` (``reduce_model``'s parts) over
    "model"."""
    return ACTIVE is not None and _splits(part, ACTIVE.plan)


def heads_split() -> bool:
    """The active plan splits the kv heads (and so ``w_k`` / ``w_v``)."""
    return ACTIVE is not None and ACTIVE.plan.attn == "split"


def reduce_model(x: torch.Tensor, part: str) -> torch.Tensor:
    """Sum a row-parallel product's partials over "model" when the active
    plan splits ``part`` ("attn", "ffn", "moe": the rank's experts' or
    expert-width share of the combine, "rec": the RG-LRU block's
    ``w_out`` over the rank's channels, "xlstm": the mLSTM's ``w_down``
    over the rank's heads and the sLSTM MLP's over its width block);
    else ``x``. Its backward is the identity."""
    if ACTIVE is None or not _splits(part, ACTIVE.plan):
        return x
    return _sum(x, ACTIVE.mesh, "model")


def copy_to_model(x: torch.Tensor, part: str) -> torch.Tensor:
    """``x`` as it enters a region whose gradient each "model" rank holds
    only in part: the input of a column-parallel product of ``part``
    ("attn": ``w_q`` always and ``w_k`` / ``w_v`` when the kv heads are
    split; "ffn": ``w_gate`` / ``w_up``), or, "kv", the whole k, v and
    gates that the "gather_q" plan's per-head read consumes on every
    rank; "moe": the MoE FFN's input (the router and the rank's experts);
    "rec": the RG-LRU block's input (``w_gelu`` / ``w_x`` columns);
    "xlstm": an xLSTM block's normed input (the mLSTM's up-projections,
    the sLSTM's ``w_in``, the rank's heads' columns) and the sLSTM MLP's
    (its width block's columns). The identity forward; backward sums the
    gradient over "model". Without a graph, or when the plan does not
    split ``part``, ``x``."""
    if ACTIVE is None or not _wants_grad(x) or \
            not _splits(part, ACTIVE.plan):
        return x
    return _SumBackward.apply(x, ACTIVE.mesh, "model")


def _gather_dim(x: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    """Every rank's block of dimension ``dim`` over ``axes`` assembled in
    the blocks' order: on ``gloo`` an ``all_reduce`` of a zero-filled
    buffer in which this rank writes its block (counted as an
    all-reduce), else ``all_gather_into_tensor`` (counted as an
    all-gather)."""
    group, n = mesh.group(axes)
    if n == 1:
        return x
    dim = dim % x.ndim
    if mesh.backend == "gloo":
        idx = 0
        for a in _axes_tuple(axes):
            idx = idx * mesh.shape[a] + mesh.coords[a]
        size = x.shape[dim]
        shape = list(x.shape)
        shape[dim] = size * n
        buf = x.new_zeros(shape)
        buf.narrow(dim, idx * size, size).copy_(x)
        return all_reduce(buf, mesh, axes)
    src = x.movedim(dim, 0).contiguous()
    out = src.new_empty((n * src.shape[0],) + tuple(src.shape[1:]))
    dist.all_gather_into_tensor(out, src, group=group)
    _count(mesh.axes_key(axes), "all_gather", out, n)
    return out.movedim(0, dim)


def _axes_tuple(axes) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


class _Gather(torch.autograd.Function):
    """Forward: every rank's block of dimension ``dim`` over ``axes``
    assembled (:func:`_gather_dim`); backward: this rank's block of the
    gradient, summed first over ``sum_axes`` (:func:`_scatter_sum`: over
    all of ``axes`` a reduce-scatter, over none a slice)."""

    @staticmethod
    def forward(ctx, x, mesh, axes, dim, sum_axes):
        ctx.mesh, ctx.axes, ctx.dim, ctx.sum_axes = mesh, axes, dim, sum_axes
        return _gather_dim(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return (_scatter_sum(g, ctx.mesh, ctx.axes, ctx.dim, ctx.sum_axes),
                None, None, None, None)


def gather_q(q: torch.Tensor) -> torch.Tensor:
    """[..., local q heads * hd] -> [..., all q heads * hd] under the
    "gather_q" plan; else ``q``. Backward keeps this rank's heads."""
    if ACTIVE is None or ACTIVE.plan.attn != "gather_q":
        return q
    # the rank's q heads are its block of the last dimension
    return _Gather.apply(q, ACTIVE.mesh, "model", -1, ())


def local_q(o: torch.Tensor) -> torch.Tensor:
    """[..., all q heads * hd] -> this rank's heads under the "gather_q"
    plan, the rows its ``w_o`` holds; else ``o``."""
    if ACTIVE is None or ACTIVE.plan.attn != "gather_q":
        return o
    plan = ACTIVE.plan
    first, n = plan.q_heads
    hd = o.shape[-1] // plan.n_heads
    return o[..., first * hd:(first + n) * hd]


def gather_model(x: torch.Tensor, part: str, *,
                 grad_sum: bool) -> torch.Tensor:
    """[..., c] -> [..., ways * c]: every "model" rank's channels of a
    tensor the active plan splits by ``part`` ("xlstm"), assembled in
    rank order (the mLSTM's conv output and up-projection before its
    heads' ``w_q`` / ``w_k`` / ``w_v``, the sLSTM's cell outputs before
    its MLP); else ``x``. Backward: this rank's block of the gradient,
    summed over "model" first when ``grad_sum`` (the gathered tensor
    feeds this rank's heads only), as it is when every rank computes the
    same downstream."""
    if ACTIVE is None or not _splits(part, ACTIVE.plan):
        return x
    x = x.contiguous()
    if _wants_grad(x):
        return _Gather.apply(x, ACTIVE.mesh, "model", -1,
                             ("model",) if grad_sum else ())
    return _gather_dim(x, ACTIVE.mesh, "model", -1)


class _SumBoth(torch.autograd.Function):
    """Forward and backward: the sum over ``axis`` (the summed tensor
    feeds each rank's own slice of the computation)."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return all_reduce(x.contiguous().clone(), mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.mesh, ctx.axis), \
            None, None


def sum_model(x: torch.Tensor, part: str) -> torch.Tensor:
    """``x`` summed over "model" when the active plan splits ``part``,
    for a statistic of the whole width that each rank's own channels
    then use (the mLSTM's ``out_norm`` sum of squares); its backward sums
    the ranks' gradients too. Else ``x``."""
    if ACTIVE is None or not _splits(part, ACTIVE.plan):
        return x
    if _wants_grad(x):
        return _SumBoth.apply(x, ACTIVE.mesh, "model")
    return all_reduce(x.contiguous(), ACTIVE.mesh, "model")


def xlstm_heads(n_heads: int) -> Tuple[int, int]:
    """(first, count) of the xLSTM heads this rank runs: its block when
    the active plan splits the xLSTM blocks, else all ``n_heads``."""
    if ACTIVE is None or not ACTIVE.plan.xlstm:
        return 0, n_heads
    return ACTIVE.plan.xlstm_heads


def _scatter_sum(g: torch.Tensor, mesh, axes, dim: int,
                 sum_axes: Tuple[str, ...]) -> torch.Tensor:
    """The backward of :func:`_gather_dim`: this rank's block of ``g``
    along ``dim`` over ``axes``, summed first over those of ``axes`` in
    ``sum_axes`` (() for none: a slice). Over all of ``axes`` on
    ``nccl`` (and a ``fake`` group standing for it) one
    ``reduce_scatter_tensor`` (counted as a reduce-scatter); else an
    ``all_reduce`` over them (counted) and the rank's slice."""
    axes = _axes_tuple(axes)
    sum_axes = tuple(a for a in axes if a in sum_axes)
    group, n = mesh.group(axes)
    if n == 1:
        return g
    dim = dim % g.ndim
    size = g.shape[dim] // n
    if sum_axes == axes and mesh.backend != "gloo":
        src = g.movedim(dim, 0).contiguous()
        out = src.new_empty((size,) + tuple(src.shape[1:]))
        dist.reduce_scatter_tensor(out, src, group=group)
        _count(mesh.axes_key(axes), "reduce_scatter", src, n)
        return out.movedim(0, dim)
    if sum_axes and mesh.group(sum_axes)[1] > 1:
        g = all_reduce(g.contiguous().clone(), mesh, sum_axes)
    idx = 0
    for a in axes:
        idx = idx * mesh.shape[a] + mesh.coords[a]
    return g.narrow(dim, idx * size, size).contiguous()


def rows_block() -> Tuple[Tuple[str, ...], int, int]:
    """(the axes the active batch rows are split over, this rank's index
    along them, their size); ((), 0, 1) when every rank holds every
    row."""
    if ACTIVE is None:
        return (), 0, 1
    axes = _fsdp_entry(ACTIVE.rows)
    if not axes:
        return (), 0, 1
    mesh = ACTIVE.mesh
    idx = 0
    for a in axes:
        idx = idx * mesh.shape[a] + mesh.coords[a]
    return axes, idx, mesh.group(axes)[1]


def gather_moe_rows(x: torch.Tensor) -> torch.Tensor:
    """An MoE block's input [rows, ...] assembled over the axes the batch
    rows are split over, for a routing group that spans data ranks (the
    reference routes serving's whole tick as one group): every rank's
    rows in their order, counted like every other gather. Under a
    gradient its backward sums the ranks' gradients and keeps this
    rank's rows; a term every rank computes from the whole group (the
    load-balance loss) must then enter the loss through
    :func:`shared_term`."""
    axes, _, n = rows_block()
    if n == 1:
        return x
    x = x.contiguous()
    if _wants_grad(x):
        # each rank differentiates its own rows' outputs and its share of
        # the group's terms: the gradient is the ranks' sum
        return _Gather.apply(x, ACTIVE.mesh, axes, 0, axes)
    return _gather_dim(x, ACTIVE.mesh, axes, 0)


class _ScaleGrad(torch.autograd.Function):
    """Forward: the identity; backward: the gradient times ``scale``."""

    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


def shared_term(x: torch.Tensor) -> torch.Tensor:
    """A loss term that every rank of the rows' axes computes whole and
    alike (an MoE routing group gathered over them): its value as it is,
    its gradient divided by the rows' ways, so that the ranks' gradients,
    summed over those axes, count it once."""
    _, _, n = rows_block()
    if n == 1 or not _wants_grad(x):
        return x
    return _ScaleGrad.apply(x, 1.0 / n)


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


# ==========================================================================
# FSDP: a leaf's "data" blocks assembled before use
# ==========================================================================
def _fsdp_entry(entry) -> Tuple[str, ...]:
    """The batch axes ("pod", "data") of one spec entry."""
    if entry is None:
        return ()
    axes = (entry,) if isinstance(entry, str) else tuple(entry)
    return tuple(a for a in axes if a in ("pod", "data"))


def gather_fsdp(x: torch.Tensor, mesh, spec) -> torch.Tensor:
    """The leaf whose local block is ``x`` under ``spec`` (its placement,
    :func:`repro_torch.sharding.rules.param_placement`), assembled over
    every entry's FSDP axes; its "model" entries stay split. On ``gloo``
    a zero-filled ``all_reduce`` (counted as one), else
    ``all_gather_into_tensor`` (counted as an all-gather). A frozen
    block (no grad) assembles without a graph; a trained one (the
    full-parameter step) through :class:`_Gather`, whose backward hands
    the rank its block of the gradient summed over the axes the batch
    rows split (each data rank's gradient is its rows' part; a
    reduce-scatter when they are all of the leaf's;
    :func:`sum_grads` adds the rest)."""
    rows = _fsdp_entry(ACTIVE.rows) if ACTIVE is not None else ()
    for dim, entry in enumerate(spec):
        axes = _fsdp_entry(entry)
        if axes:
            if _wants_grad(x):
                x = _Gather.apply(x, mesh, axes, dim, rows)
            else:
                x = _gather_dim(x.detach(), mesh, axes, dim)
    return x


def gather_params(tree: Any, prefix: Tuple[str, ...],
                  stacked: bool = False) -> Any:
    """A subtree of the params (at ``prefix``; ``stacked``: one repeat's
    view of stacked leaves, whose placement carries the repeat axis
    first) with every leaf the active FSDP placement holds in blocks
    assembled (:func:`gather_fsdp`); the other leaves as they are."""
    if ACTIVE is None or not ACTIVE.fsdp:
        return tree
    fsdp, mesh = ACTIVE.fsdp, ACTIVE.mesh

    def walk(path, leaf):
        spec = fsdp.get("/".join(prefix + tuple(str(k) for k in path)))
        if spec is None:
            return leaf
        return gather_fsdp(leaf, mesh, spec[1:] if stacked else spec)
    return tree_map_with_path(walk, tree)


# ==========================================================================
# loss terms and gradients over the batch rows
# ==========================================================================
def _loss_axes(heads: bool) -> Tuple[str, ...]:
    """The axes a loss term sums over: the rows' batch axes, and "model"
    for a per-kv-head term when the plan splits the kv heads."""
    axes = _fsdp_entry(ACTIVE.rows)
    if heads and ACTIVE.plan.attn == "split":
        axes = axes + ("model",)
    return axes


def sum_rows(x: torch.Tensor, heads: bool = False) -> torch.Tensor:
    """A loss term's local sums ``x`` (a small vector: sums and counts)
    added over the axes the batch rows are split over, and over "model"
    when ``heads`` (a term over the rank's kv heads) and the heads are
    split: every rank then holds the global sums. The backward is the
    identity, so each rank's gradient is its own rows' and heads' part
    (:func:`sum_grads` adds the rows')."""
    if ACTIVE is None:
        return x
    axes = _loss_axes(heads)
    if not axes or ACTIVE.mesh.group(axes)[1] == 1:
        return x
    return _sum(x, ACTIVE.mesh, axes)


def mean_blocks(x: torch.Tensor, heads: bool = True) -> torch.Tensor:
    """A mean over the rank's rows and kv heads (a tensor of equal-sized
    blocks) -> the mean over every row and head: the blocks' means added
    over the rows' axes and, when ``heads`` and the heads are split,
    "model", then divided by their count (``heads=False``: a mean over
    rows alone, such as the MoE load-balance loss of the rank's routing
    groups). ``x`` off a mesh or outside a bundle."""
    if ACTIVE is None:
        return x
    axes = _loss_axes(heads)
    if not axes:
        return x
    n = ACTIVE.mesh.group(axes)[1]
    return x if n == 1 else _sum(x, ACTIVE.mesh, axes) / n


def sum_grads(grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Gradients (by ``/``-joined path) summed in place over the axes the
    batch rows are split over, less those a leaf's FSDP gather already
    summed in its backward (:func:`gather_fsdp`): every leaf then holds,
    in the rank's block, the gradient of the global loss. Serves the gate
    step and the full-parameter step alike."""
    if ACTIVE is None:
        return grads
    rows = _fsdp_entry(ACTIVE.rows)
    for path, g in grads.items():
        done = {a for e in ACTIVE.fsdp.get(path, ())
                for a in _fsdp_entry(e)}
        left = tuple(a for a in rows if a not in done)
        if left and ACTIVE.mesh.group(left)[1] > 1:
            all_reduce(g, ACTIVE.mesh, left)
    return grads


# ==========================================================================
# context-parallel decode: the data ranks' reads combined
# ==========================================================================
def seq_block() -> Optional[Tuple[int, int]]:
    """(this rank's index, ranks) along the global token axis of a
    seq-sharded decode cache; None when the cache is not seq-sharded."""
    if ACTIVE is None or ACTIVE.seq is None:
        return None
    mesh = ACTIVE.mesh
    axes = _fsdp_entry(ACTIVE.seq)
    idx = 0
    for a in axes:
        idx = idx * mesh.shape[a] + mesh.coords[a]
    return idx, mesh.group(axes)[1]


def combine_lse(o: torch.Tensor, lse: torch.Tensor) -> torch.Tensor:
    """Context-parallel decode: ``o`` [..., hd] (this rank's read of its
    block of the keys) and ``lse`` [...] (its log-sum-exp in f32, -inf
    for a read of no key) -> the read over every rank's keys:
    ``M = max lse``, ``w = exp(lse - M)``, ``o = sum w o / sum w``. A
    rank whose block held no key has ``w = 0``; no rank's key at all
    gives 0, as an empty read does."""
    mesh = ACTIVE.mesh
    axes = _fsdp_entry(ACTIVE.seq)
    m = all_reduce(lse.clone(), mesh, axes, op="max")
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    w = torch.where(torch.isfinite(lse), torch.exp(lse - m_safe),
                    torch.zeros_like(lse))
    hd = o.shape[-1]
    buf = o.new_zeros(o.shape[:-1] + (hd + 1,), dtype=torch.float32)
    buf[..., :hd] = w[..., None] * o.float()
    buf[..., hd] = w
    all_reduce(buf, mesh, axes)
    den = buf[..., hd:].clamp_min(1e-30)
    return (buf[..., :hd] / den).to(o.dtype)
