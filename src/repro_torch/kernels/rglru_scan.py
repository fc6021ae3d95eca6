"""RG-LRU linear-scan kernel wrapper (port of
``repro/kernels/rglru_scan.py::rglru_scan_pallas``).

:func:`rglru_scan` launches the hand-written CUDA kernel
(``csrc/rglru_scan.cu``) for tensors on a CUDA device and runs
:func:`rglru_scan_plain`, its plain PyTorch version, for tensors on the
CPU. Nothing else decides: a CUDA tensor the kernel does not take (not
float32, not contiguous) raises.

The recurrence ``h_t = a_t * h_{t-1} + b_t`` over the time axis of
``[B, S, D]``, starting from zero; a carried-in state is folded into
``b[:, 0]`` by the caller (``models/rglru.py::rglru_scan``). The kernel
tiles itself, so the Pallas kernel's ``bt``/``bd`` block sizes have no
counterpart and any S >= 1, D >= 1 is taken.

The kernel scans in chunks of 128 steps and hands each chunk's carry to
the next in a fixed order, so two calls on the same inputs give the same
bits. It regroups the products at sub-chunk boundaries, as the
reference's associative scan does, so it is within a few ulps of |h| of
the plain loop, not bitwise equal to it (the limit on the card is 5e-5;
``tests/test_torch_scan_chunks.py`` emulates its arithmetic on the CPU).

Gradients. The TPU kernel is forward-only; the port's has a backward of
its own. On the CPU autograd differentiates :func:`rglru_scan_plain`. On
CUDA, when grad is enabled and an input requires it, :func:`rglru_scan`
runs through :class:`RGLRUScanFunction`: the forward kernel, and
:func:`rglru_scan_bwd` (``csrc/rglru_scan_bwd.cu``: the reverse scan in
the forward's chunks, from the forward's h; its plain version
:func:`rglru_scan_bwd_plain`) for da and db.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

launches = build.LaunchCounter("rglru_scan")
bwd_launches = build.LaunchCounter("rglru_scan_bwd")


def rglru_scan_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a, b: [B, S, D] -> h [B, S, D]: a loop over t of [B, D] products
    and sums, each rounded."""
    h = torch.zeros_like(b[:, 0])
    out = torch.empty_like(b)
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        out[:, t] = h
    return out


def rglru_scan_bwd_plain(a: torch.Tensor, h: torch.Tensor,
                         dy: torch.Tensor):
    """The gradients (da, db) of ``h = rglru_scan(a, b)`` for the gradient
    dy of h, from the forward's h: a reverse loop over t, ``dh_t = dy_t +
    r`` with ``r = a_{t+1} dh_{t+1}`` (0 past the end), ``da_t = dh_t
    h_{t-1}`` (``h_{-1} = 0``) and ``db_t = dh_t``; each product and sum
    rounded, in the kernel's order within a sub-chunk."""
    da, db = torch.empty_like(a), torch.empty_like(a)
    r = torch.zeros_like(dy[:, 0])
    for t in range(a.shape[1] - 1, -1, -1):
        dh = dy[:, t] + r
        db[:, t] = dh
        da[:, t] = dh * h[:, t - 1] if t > 0 else torch.zeros_like(dh)
        r = a[:, t] * dh
    return da, db


def _check_cuda(kernel: str, a: torch.Tensor, *others) -> None:
    """a and ``others`` (name, tensor): contiguous float32 [B, S, D] of one
    shape on a's device."""
    if a.dim() != 3:
        raise ValueError(f"{kernel}: a {tuple(a.shape)} must be [B, S, D]")
    for name, t in (("a", a),) + others:
        if tuple(t.shape) != tuple(a.shape):
            raise ValueError(f"{kernel}: {name} {tuple(t.shape)} and a "
                             f"{tuple(a.shape)} must both be [B, S, D]")
        if t.device != a.device:
            raise ValueError(f"{kernel}: {name} on {t.device}, a on "
                             f"{a.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{kernel} kernel takes float32, {name} is "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} must be contiguous")


def _forward_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    bsz, s, d = a.shape
    h = torch.empty_like(a)
    lib = build.load("rglru_scan")
    # the ticket counter and the chunks' carry words, zeroed on every call
    scratch = torch.zeros(lib.rglru_scan_scratch_words(bsz, s, d),
                          dtype=torch.int64, device=a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = lib.rglru_scan_f32(a.data_ptr(), b.data_ptr(), h.data_ptr(),
                                bsz, s, d, scratch.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"rglru_scan kernel launch failed: CUDA error {rc}")
    launches.count += 1
    return h


def rglru_scan_bwd(a: torch.Tensor, h: torch.Tensor, dy: torch.Tensor):
    """Gradients of ``rglru_scan`` -> (da, db) by the hand-written kernel
    from a, the forward's h and dy, on CUDA tensors only (on the CPU
    autograd differentiates :func:`rglru_scan_plain`)."""
    if a.device.type != "cuda":
        raise ValueError(f"rglru_scan_bwd: unsupported device {a.device}")
    _check_cuda("rglru_scan_bwd", a, ("h", h), ("dy", dy))
    bsz, s, d = a.shape
    da, db = torch.empty_like(a), torch.empty_like(a)
    lib = build.load("rglru_scan_bwd")
    # the ticket counter and the chunks' carry words, zeroed on every call
    scratch = torch.zeros(lib.rglru_scan_bwd_scratch_words(bsz, s, d),
                          dtype=torch.int64, device=a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = lib.rglru_scan_bwd_f32(a.data_ptr(), h.data_ptr(), dy.data_ptr(),
                                    da.data_ptr(), db.data_ptr(), bsz, s, d,
                                    scratch.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"rglru_scan_bwd kernel launch failed: CUDA "
                           f"error {rc}")
    bwd_launches.count += 1
    return da, db


class RGLRUScanFunction(torch.autograd.Function):
    """``rglru_scan`` on CUDA with its gradient: the forward kernel, and
    :func:`rglru_scan_bwd`'s kernel from the saved a and h for the
    backward. Under ``torch.utils.checkpoint`` the forward runs again
    before the backward and gives the same bits."""

    @staticmethod
    def forward(ctx, a, b):
        h = _forward_cuda(a, b)
        ctx.save_for_backward(a, h)
        return h

    @staticmethod
    def backward(ctx, dy):
        a, h = ctx.saved_tensors
        return rglru_scan_bwd(a, h, dy.contiguous())


def rglru_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The ``rglru_scan_pallas`` contract: a, b [B, S, D] float32 ->
    h [B, S, D] float32 with ``h[:, t] = a[:, t] * h[:, t-1] + b[:, t]``
    and ``h[:, -1] = 0``. Differentiable on both devices (see the
    module's note)."""
    if a.device.type == "cpu":
        return rglru_scan_plain(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"rglru_scan: unsupported device {a.device}")
    _check_cuda("rglru_scan", a, ("b", b))
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        return RGLRUScanFunction.apply(a, b)
    return _forward_cuda(a, b)
