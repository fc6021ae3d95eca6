"""Device meshes over ``torch.distributed`` (port of
``repro/launch/mesh.py``).

The reference's mesh is a ``jax.sharding.Mesh`` of devices, and one
program drives all of them. The port's is multi-controller: one process
per mesh position, each holding its shard, joined by process groups.
Rank ``r`` of a ``d x m`` mesh sits at data index ``r // m`` and model
index ``r % m``, ``jax.make_mesh``'s row-major order.

* :func:`make_production_mesh` / :func:`make_debug_mesh` give the
  reference's mesh shapes (shapes only: no process is started).
* :func:`init_mesh` builds the "data", "model" and whole-mesh process
  groups of an initialised world, on its backend and, for host
  decisions, on ``gloo``.
* :func:`spawn` starts the ``d * m`` ranks of a mesh on this host and runs
  a function on each (``torch.multiprocessing``, ``spawn`` start method);
  :func:`from_env` joins the world ``torchrun`` started.
* :func:`fake_mesh` makes this process ONE rank of a mesh of any size,
  the production 16 x 16 or 2 x 16 x 16 included, over torch's ``fake``
  process group: its collectives return at once, on ``meta`` tensors
  too, so the mesh dry run (``launch/dryrun.py``) runs rank (0, 0)'s step
  of a 256- or 512-rank mesh in one process without a card.

Across pods the mesh is ``("pod", "data", "model")``, row-major too; the
batch and FSDP axes are then ("pod", "data"), as the reference's
``rules.batch_axes``. ``spawn`` and ``init_mesh`` build ``data x model``
meshes; a pod axis exists only on a fake mesh here (one host, no pods).

The backend is explicit: ``nccl`` when every rank has its own card,
``gloo`` on the CPU, and ``gloo`` on CUDA only when the caller asks for
ranks that share a card. A CUDA mesh with more ranks than cards and no
explicit ``gloo`` raises; nothing downgrades quietly.
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os
import pickle
import queue as queue_mod
import tempfile
import traceback
from typing import (Any, Callable, Dict, Iterator, Optional, Sequence,
                    Tuple)

import torch
import torch.distributed as dist

AXES = ("data", "model")
POD_AXES = ("pod", "data", "model")


def shape_dict(shape) -> Dict[str, int]:
    """``{"data": d, "model": m}`` (or with "pod" first) of a shape tuple
    ``(d, m)`` / ``(p, d, m)`` or mapping."""
    if isinstance(shape, dict):
        return dict(shape)
    shape = tuple(shape)
    return dict(zip(POD_AXES if len(shape) == 3 else AXES, shape))


def make_production_mesh(*, multi_pod: bool = False) -> Dict[str, int]:
    """The reference's production mesh shape: 16 x 16, or 2 x 16 x 16
    across pods."""
    if multi_pod:
        return {"pod": 2, "data": 16, "model": 16}
    return {"data": 16, "model": 16}


def make_debug_mesh(shape=(2, 4), axes=AXES) -> Dict[str, int]:
    """A small mesh shape for tests (the reference's default 2 x 4)."""
    return dict(zip(axes, shape))


def axes_key(shape: Dict[str, int], axis) -> str:
    """The group key of ``axis`` (an axis name, a tuple of them, or
    "world") on a mesh of ``shape``: its axes joined by "+" in mesh
    order, "world" when they are all of them."""
    if axis == "world":
        return "world"
    axes = (axis,) if isinstance(axis, str) else tuple(axis)
    axes = tuple(a for a in shape if a in axes)
    return "world" if axes == tuple(shape) else "+".join(axes)


@dataclasses.dataclass
class Mesh:
    """One rank's view of a ``data x model`` mesh (``pod x data x model``
    across pods): its place, its device, and its process groups by axis
    (None for a group of one): ``groups`` on the mesh's backend for the
    model's tensors, ``host_groups`` on ``gloo`` for the host decisions
    every rank must share (they never stage a device tensor, so they
    never sync the host with a card). Groups are keyed by the axes they
    span, joined by "+" in mesh order ("model", "data", "pod+data"), and
    "world" for all of them."""
    shape: Dict[str, int]
    rank: int
    backend: str
    device: torch.device
    groups: Dict[str, Any]
    host_groups: Dict[str, Any]
    fake: bool = False      # a rank of torch's fake group (fake_mesh)

    @property
    def size(self) -> int:
        n = 1
        for v in self.shape.values():
            n *= v
        return n

    @property
    def coords(self) -> Dict[str, int]:
        out, r = {}, self.rank
        for a in reversed(list(self.shape)):
            out[a] = r % self.shape[a]
            r //= self.shape[a]
        return {a: out[a] for a in self.shape}

    def global_rank(self, data: int, model: int) -> int:
        """The rank at (data, model) of this rank's pod."""
        c = dict(self.coords, data=data, model=model)
        r = 0
        for a in self.shape:
            r = r * self.shape[a] + c[a]
        return r

    def axes_key(self, axis) -> str:
        """The group key of ``axis``: an axis name, a tuple of them, or
        "world"."""
        return axes_key(self.shape, axis)

    def group(self, axis, host: bool = False) -> Tuple[Any, int]:
        """(process group, ranks in it) of an axis ("data", "model",
        "pod"), a tuple of axes, or "world"; the ``gloo`` one for host
        values when ``host``."""
        key = self.axes_key(axis)
        axes = tuple(self.shape) if key == "world" else key.split("+")
        n = 1
        for a in axes:
            n *= self.shape[a]
        groups = self.host_groups if host else self.groups
        if key not in groups and self.fake:
            groups[key] = None if n == 1 else dist.new_group(
                self._members(axes))
        return groups.get(key), n

    def _members(self, axes) -> list:
        """Global ranks of this rank's group over ``axes`` (ascending:
        row-major over the axes, the order of a spec entry's blocks)."""
        names = list(self.shape)
        c = self.coords
        out = []
        for r in range(self.size):
            rc, rr = {}, r
            for a in reversed(names):
                rc[a] = rr % self.shape[a]
                rr //= self.shape[a]
            if all(rc[a] == c[a] for a in names if a not in axes):
                out.append(r)
        return out

    def describe(self) -> str:
        dims = "x".join(str(v) for v in self.shape.values())
        return (f"{dims} ({self.backend}, rank {self.rank} of {self.size} "
                f"on {self.device})")


def check_backend(world: int, backend: Optional[str],
                  device) -> Tuple[str, torch.device]:
    """The backend and this host's device type for a ``world``-rank mesh;
    raises where the request cannot run as asked."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        if backend not in (None, "gloo"):
            raise ValueError(f"backend {backend!r} needs CUDA; a CPU mesh "
                             "runs on gloo")
        return "gloo", dev
    if dev.type != "cuda":
        raise ValueError(f"a mesh runs on cuda or cpu, not {dev.type}")
    backend = backend or "nccl"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unknown backend {backend!r} (nccl or gloo)")
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have == 0:
        raise RuntimeError("a CUDA mesh needs a CUDA device and none is "
                           "available; pass device='cpu' for a gloo mesh "
                           "on the host")
    if backend == "nccl" and world > have:
        raise RuntimeError(
            f"mesh of {world} ranks needs {world} devices for nccl, found "
            f"{have}; pass backend='gloo' (--dist-backend gloo) to run "
            "ranks that share a card")
    return backend, dev


def rank_device(rank: int, backend: str, device) -> torch.device:
    """The device of ``rank``: the CPU, or card ``rank % cards`` (every
    rank on one card shares it, under gloo)."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return dev
    idx = rank % torch.cuda.device_count()
    torch.cuda.set_device(idx)
    return torch.device("cuda", idx)


def init_mesh(shape, *, backend: Optional[str] = None,
              device=None) -> Mesh:
    """This rank's :class:`Mesh` of ``shape`` (``(d, m)`` or
    ``{"data": d, "model": m}``) over the initialised default world of
    ``d * m`` ranks. Every rank calls it, in the same order as any other
    group creation (process groups are made collectively)."""
    shape = shape_dict(shape)
    if set(shape) != set(AXES):
        raise ValueError(f"init_mesh builds data x model meshes, got "
                         f"{shape}; a pod axis runs on fake_mesh")
    if not dist.is_initialized():
        raise RuntimeError("init_mesh needs an initialised process group "
                           "(launch.mesh.spawn, from_env or "
                           "torch.distributed.init_process_group)")
    d, m = shape["data"], shape["model"]
    world = dist.get_world_size()
    if world != d * m:
        raise RuntimeError(f"mesh {d}x{m} needs {d * m} ranks (devices), "
                           f"the world has {world}")
    backend, dev = check_backend(world, backend or dist.get_backend(), device)
    rank = dist.get_rank()
    return Mesh(shape=shape, rank=rank, backend=backend,
                device=rank_device(rank, backend, dev),
                groups=_axis_groups(rank, d, m, None),
                host_groups=_axis_groups(rank, d, m, "gloo"))


def _axis_groups(rank: int, d: int, m: int,
                 backend: Optional[str]) -> Dict[str, Any]:
    """This rank's "model", "data" and "world" groups of a ``d x m`` mesh
    on ``backend`` (None: the world's); every rank makes every group."""
    groups: Dict[str, Any] = {}
    for i in range(d):
        ranks = list(range(i * m, (i + 1) * m))
        g = dist.new_group(ranks, backend=backend) if m > 1 else None
        if rank in ranks:
            groups["model"] = g
    for j in range(m):
        ranks = list(range(j, d * m, m))
        g = dist.new_group(ranks, backend=backend) if d > 1 else None
        if rank in ranks:
            groups["data"] = g
    world = d * m
    if world == 1:
        groups["world"] = None
    elif backend is None:
        groups["world"] = dist.group.WORLD
    else:
        groups["world"] = dist.new_group(list(range(world)), backend=backend)
    return groups


def from_env(shape, *, backend: Optional[str] = None, device=None) -> Mesh:
    """Join the world ``torchrun`` started (``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR``, ``MASTER_PORT`` in the environment) and build this
    rank's mesh on it."""
    world = int(os.environ["WORLD_SIZE"])
    backend, _ = check_backend(world, backend, device)
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method="env://")
    return init_mesh(shape, backend=backend, device=device)


def under_torchrun() -> bool:
    return all(k in os.environ for k in ("RANK", "WORLD_SIZE",
                                         "MASTER_ADDR"))


def _rank_main(rank: int, shape: Dict[str, int], init_method: str,
               backend: str, device: str, call: str, results,
               timeout_s: float) -> None:
    try:
        with open(call, "rb") as f:
            fn, args, kwargs = pickle.load(f)
        world = shape["data"] * shape["model"]
        if torch.device(device).type == "cpu":
            # the ranks share the host's cores
            torch.set_num_threads(max(1, torch.get_num_threads() // world))
        dist.init_process_group(
            backend, init_method=init_method, rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=timeout_s))
        mesh = init_mesh(shape, backend=backend, device=device)
        out = fn(mesh, *args, **kwargs)
        results.put((rank, "ok", out))
    except BaseException:  # the parent must hear of any failure, then exit
        results.put((rank, "error", traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn: Callable, shape, args: Sequence = (),
          kwargs: Optional[Dict[str, Any]] = None, *,
          backend: Optional[str] = None, device="cuda",
          timeout_s: float = 3600.0) -> Dict[int, Any]:
    """Run ``fn(mesh, *args, **kwargs)`` on every rank of a ``shape`` mesh
    started on this host (``fn`` and its arguments are pickled: a
    module-level function and plain values). Returns ``{rank: fn's
    result}``; raises :class:`RuntimeError` with the failing rank's
    traceback if any rank fails, or when ``timeout_s`` passes (a deadlock
    fails, it does not hang), after stopping every rank."""
    shape = shape_dict(shape)
    world = shape["data"] * shape["model"]
    backend, dev = check_backend(world, backend, device)
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        init_method = "file://" + os.path.join(tmp, "rendezvous")
        # the call reaches the ranks in a file: arguments past a pipe's
        # buffer would hold each start until the rank before it had
        # imported torch
        call = os.path.join(tmp, "call.pkl")
        with open(call, "wb") as f:
            pickle.dump((fn, tuple(args), dict(kwargs or {})), f)
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(r, shape, init_method, backend, str(dev),
                                   call, results, timeout_s))
                 for r in range(world)]
        for p in procs:
            p.start()
        out: Dict[int, Any] = {}
        error = None
        deadline = datetime.datetime.now() + datetime.timedelta(
            seconds=timeout_s)
        try:
            while len(out) < world and error is None:
                left = (deadline - datetime.datetime.now()).total_seconds()
                if left <= 0:
                    error = f"mesh run timed out after {timeout_s:.0f} s"
                    break
                try:
                    rank, status, val = results.get(timeout=min(left, 5.0))
                except queue_mod.Empty:
                    dead = [p.exitcode for p in procs
                            if p.exitcode not in (None, 0)]
                    if dead:
                        error = f"a rank exited with code {dead[0]}"
                    continue
                if status == "ok":
                    out[rank] = val
                else:
                    error = f"rank {rank} failed:\n{val}"
        finally:
            for p in procs:
                p.join(timeout=30 if error is None else 1)
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
    if error is not None:
        raise RuntimeError(error)
    return out


@contextlib.contextmanager
def fake_mesh(shape, coords: Optional[Dict[str, int]] = None, *,
              backend: str = "nccl") -> Iterator[Mesh]:
    """This process as the rank at ``coords`` (default all 0) of a
    ``shape`` mesh over torch's ``fake`` process group, on the ``meta``
    device: every collective returns at once without moving data, so a
    step runs as that one rank of a mesh of any size, shapes only.
    ``backend``: the backend the group stands for ("nccl", the cards', or
    "gloo"), which decides the collectives ``sharding.comm`` calls and
    counts, so a meta run counts what a real mesh of that backend moves.
    The group is torn down on exit; a process runs one fake mesh at a
    time."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    shape = shape_dict(shape)
    if dist.is_initialized():
        raise RuntimeError("fake_mesh needs a process with no process "
                           "group initialised")
    world, rank = 1, 0
    for a, n in shape.items():
        c = (coords or {}).get(a, 0)
        if not 0 <= c < n:
            raise ValueError(f"coordinate {a}={c} outside the {a} axis "
                             f"of {n}")
        world *= n
        rank = rank * n + c
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)
    try:
        yield Mesh(shape=shape, rank=rank, backend=backend,
                   device=torch.device("meta"), groups={}, host_groups={},
                   fake=True)
    finally:
        dist.destroy_process_group()
