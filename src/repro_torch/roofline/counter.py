"""A counter of a step's work, the port's counterpart of XLA's
``cost_analysis()`` and ``memory_analysis()``.

:class:`WorkCounter` is a ``TorchDispatchMode``. While it is active it
records

- **FLOPs** of the aten ops ``torch.utils.flop_counter`` has a formula
  for (the matmul class), by rate class: float32 products on the CUDA
  cores (TF32 stays off), bf16 / fp16 on the tensor cores. Elementwise
  and other ops count bytes only;
- **bytes**: each op's tensor inputs read and outputs written. A view
  (an op whose result aliases an input and writes nothing, by the
  schema's alias information, or whose results share an input's storage,
  as ``_unsafe_view``'s do) counts 0; an
  in-place or ``out=`` op counts the inputs it reads and the tensors it
  writes; allocating ``empty*`` ops count 0, and so does scratch one
  device fills and another leaves empty (``_SCRATCH_OUTPUTS``). A copy
  between the host and a device is not HBM traffic of the step: it
  counts in ``host_copy_bytes``;
- **peak live bytes** of the storages made while it is active: added
  when an op makes one, dropped once it is freed (read from a weak
  reference, never from a device value);
- **each kernel's work and launches, by name**: a kernel wrapper
  decorated with :func:`counted` reports the work of its call
  (:mod:`repro_torch.roofline.work`), on any device. The counter counts
  no aten op until the wrapper returns, so neither a plain version's ops
  on the CPU nor a kernel's scratch on CUDA is counted twice; the
  wrapper's outputs count as made.

- **collective bytes** a chip moves, reported by the mesh's collectives
  (``sharding/comm.py``) in the ring accounting of
  :func:`collective_bytes`, the reference's ``roofline/hlo_parse.py``
  rules; 0 on one card. The collective ops themselves count no HBM
  bytes.

Everything read is a shape, a dtype or a storage's size: the counter
never syncs the host with the card.

With no counter active, a decorated wrapper checks :data:`ACTIVE` and
does nothing else::

    @counter.counted("gate_mlp", lambda x, w1, b1, w2, b2: W.gate_mlp(...))
    def gate_mlp(x, w1, b1, w2, b2): ...
"""
from __future__ import annotations

import functools
from collections import defaultdict
from typing import Any, Callable, Dict, Optional, Union

import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.roofline.work import BF16, F32, Work
from repro_torch.tree import tree_leaves

# the counter kernel wrappers report to; set while a WorkCounter is active
ACTIVE: Optional["WorkCounter"] = None

_LOW_PRECISION = (torch.bfloat16, torch.float16)
# scratch that one device's kernel fills and another's leaves empty is not
# traffic of the step: log_sigmoid's buffer (exp(-|x|) on the CPU and the
# meta device, an empty tensor on CUDA); the forward's outputs past the
# first n, and the backward's arguments of these names, are not counted
_SCRATCH_OUTPUTS = {"log_sigmoid_forward": 1}
_SCRATCH_ARGS = {"log_sigmoid_backward": ("buffer",)}


def counted(name: Union[str, Callable[..., str]],
            work: Callable[..., Work]):
    """Decorates the kernel wrapper of ``name``: while a
    :class:`WorkCounter` is active, a call reports ``work(*args, **kw)``
    (the same arguments as the wrapper's) under ``name`` (or
    ``name(*args, **kw)``, for a wrapper whose mode has a launch counter
    of its own) and runs with aten counting suspended
    (:meth:`WorkCounter.kernel`); with none, the wrapper runs straight
    through."""
    def wrap(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kw):
            if ACTIVE is None:
                return fn(*args, **kw)
            label = name if isinstance(name, str) else name(*args, **kw)
            return ACTIVE.kernel(label, work(*args, **kw), fn, *args, **kw)
        return wrapper
    return wrap


def collective_bytes(kind: str, nbytes: int, n: int) -> int:
    """Bytes one chip moves for a collective over ``n`` chips whose
    input (all-reduce, reduce-scatter, broadcast) or output (the others)
    is ``nbytes``, in ring accounting (``repro/roofline/hlo_parse.py``):
    all-reduce 2 x bytes x (n-1)/n, all-gather, reduce-scatter,
    all-to-all and broadcast bytes x (n-1)/n, collective-permute bytes."""
    if n <= 1:
        return 0
    if kind == "collective_permute":
        return nbytes
    factor = 2 if kind == "all_reduce" else 1
    return factor * nbytes * (n - 1) // n


def _tensors(tree) -> list:
    return [x for x in tree_leaves(tree) if isinstance(x, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _rate(args) -> str:
    for t in _tensors(args):
        if t.is_floating_point():
            return BF16 if t.dtype in _LOW_PRECISION else F32
    return F32


class WorkCounter(TorchDispatchMode):
    """Counts the work of everything run inside ``with WorkCounter() as
    wc:``; :meth:`record` returns it as plain integers. ``aten=False``
    counts only the kernel wrappers and the collectives: no dispatch mode
    is entered, so a timed run pays nothing per aten op."""

    def __init__(self, aten: bool = True):
        super().__init__()
        self._aten = aten
        self.flops: Dict[str, int] = defaultdict(int)
        self.bytes = 0
        self.host_copy_bytes = 0
        self.collective_bytes: Dict[str, int] = defaultdict(int)  # by axis
        # aten op -> [calls, flops, bytes]
        self.ops: Dict[str, list] = defaultdict(lambda: [0, 0, 0])
        # kernel -> [launches, flops, bytes, rate]
        self.kernels: Dict[str, list] = {}
        self._live: Dict[int, tuple] = {}  # storage id -> (weak ref, bytes)
        self._live_bytes = 0
        self.peak_bytes = 0
        self._suspended = 0
        self._outer: Optional[WorkCounter] = None

    def __enter__(self):
        global ACTIVE
        self._outer, ACTIVE = ACTIVE, self
        return super().__enter__() if self._aten else self

    def __exit__(self, *exc):
        global ACTIVE
        ACTIVE = self._outer
        return super().__exit__(*exc) if self._aten else None

    # ---- storages -------------------------------------------------------
    def _made(self, out) -> None:
        """Adds the storages of ``out`` not seen alive yet; the peak is
        read after a sweep of the freed ones whenever it could rise."""
        for t in _tensors(out):
            st = t.untyped_storage()
            key = st._cdata
            old = self._live.get(key)
            if old is not None and not old[0].expired():
                continue
            if old is not None:
                self._live_bytes -= old[1]
            n = st.nbytes()
            self._live[key] = (StorageWeakRef(st), n)
            self._live_bytes += n
        if self._live_bytes > self.peak_bytes:
            for key in [k for k, (ref, _) in self._live.items()
                        if ref.expired()]:
                self._live_bytes -= self._live.pop(key)[1]
            self.peak_bytes = max(self.peak_bytes, self._live_bytes)

    # ---- kernels --------------------------------------------------------
    def kernel(self, name: str, work: Work, fn: Callable, *args, **kw) -> Any:
        """Runs a kernel wrapper's body ``fn(*args, **kw)`` with aten
        counting suspended and records one launch of ``name`` with
        ``work``."""
        self._suspended += 1
        try:
            out = fn(*args, **kw)
        finally:
            self._suspended -= 1
        rec = self.kernels.setdefault(name, [0, 0, 0, work.rate])
        rec[0] += 1
        rec[1] += work.flops
        rec[2] += work.bytes
        self.flops[work.rate] += work.flops
        self.bytes += work.bytes
        self._made(out)
        return out

    def collective(self, nbytes: int, axis: str) -> None:
        """Records ``nbytes`` moved by one collective over the mesh's
        ``axis`` (:func:`collective_bytes`)."""
        self.collective_bytes[axis] += int(nbytes)

    # ---- aten ops -------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._suspended or func.namespace == "c10d":
            return out
        schema = func._schema
        op = func.overloadpacket.__name__
        rets = [r.alias_info for r in schema.returns]
        if any(a is not None and not a.is_write for a in rets) \
                or op.startswith("empty") or op == "new_empty":
            return out          # a view, or an allocation
        made = out
        if op in _SCRATCH_OUTPUTS:
            made = out[:_SCRATCH_OUTPUTS[op]]
        ins = _tensors((args, kwargs))
        if not any(r is not None for r in rets):
            # a view the schema does not annotate (``_unsafe_view``): its
            # results share the storage of an input
            held = {t.untyped_storage()._cdata for t in ins}
            outs = _tensors(made)
            if outs and all(t.untyped_storage()._cdata in held for t in outs):
                return out
        scratch = _SCRATCH_ARGS.get(op, ())
        written = []
        read = 0
        for arg, value in zip(schema.arguments,
                              list(args) + [kwargs.get(a.name) for a in
                                            schema.arguments[len(args):]]):
            tensors = _tensors(value)
            if arg.alias_info is not None and arg.alias_info.is_write:
                written += tensors
            elif arg.name not in scratch:
                read += sum(_nbytes(t) for t in tensors)
        if not written:
            written = _tensors(made)
        nbytes = read + sum(_nbytes(t) for t in written)
        name = str(func.overloadpacket)
        if name == "aten._to_copy" and ins and \
                (ins[0].device.type == "cpu") != (written[0].device.type == "cpu"):
            self.host_copy_bytes += nbytes
            nbytes = 0
        flops = 0
        formula = flop_registry.get(func.overloadpacket)
        if formula is not None:
            flops = int(formula(*args, **kwargs, out_val=out))
            self.flops[_rate(args)] += flops
        self.bytes += nbytes
        rec = self.ops[name]
        rec[0] += 1
        rec[1] += flops
        rec[2] += nbytes
        self._made(made)
        return out

    def record(self) -> Dict[str, Any]:
        """The counts as plain integers: FLOPs by rate class, bytes,
        host-copy bytes, collective bytes (in all and by mesh axis),
        peak live bytes of the storages made, each
        kernel's launches, FLOPs, bytes and rate, and each aten op's calls,
        FLOPs and bytes."""
        return {
            "flops": {c: int(self.flops.get(c, 0))
                      for c in ("f32", "3xtf32", "bf16")},
            "bytes": int(self.bytes),
            "host_copy_bytes": int(self.host_copy_bytes),
            "collective_bytes": int(sum(self.collective_bytes.values())),
            "collective_bytes_by_axis": dict(sorted(
                self.collective_bytes.items())),
            "peak_made_bytes": int(self.peak_bytes),
            "kernels": {k: {"launches": v[0], "flops": v[1], "bytes": v[2],
                            "rate": v[3]}
                        for k, v in sorted(self.kernels.items())},
            "aten": {k: {"calls": v[0], "flops": v[1], "bytes": v[2]}
                     for k, v in sorted(self.ops.items())},
        }
