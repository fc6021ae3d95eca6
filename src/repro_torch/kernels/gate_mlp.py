"""Write-gate MLP kernel wrapper (port of ``repro/kernels/gate_mlp.py``).

:func:`gate_mlp` launches the hand-written CUDA kernel
(``csrc/gate_mlp.cu``) for tensors on a CUDA device and runs
:func:`gate_mlp_plain`, its plain PyTorch version, for tensors on the
CPU. Nothing else decides: a CUDA tensor the kernel does not take raises.

The kernel takes F and M multiples of 8, F <= 2048 and M <= 128 (its
tensor-core tiles and 16-byte copies; every config has M 64 and F = 2 hd
in 128..512), with x and w1 16-byte aligned. :func:`plan` picks its path
from the shapes alone: the decode path for few tokens per head, the
tensor-core path with a tile of 64 or 16 tokens otherwise.

Gradients. On the CPU autograd differentiates :func:`gate_mlp_plain`. On
CUDA, when grad is enabled and an input requires it, :func:`gate_mlp`
runs through :class:`GateMLPFunction`: the forward kernel, then
:func:`gate_mlp_bwd` (``csrc/gate_mlp_bwd.cu``: the three F x M products
in 3xTF32 on the tensor cores, one CTA per head and chunk of its tokens,
the chunks chosen by the kernel's C side, :func:`bwd_scratch`; f32,
F M <= 32768; its plain version
:func:`gate_mlp_bwd_plain`) for the backward. A shape the backward does
not take raises in the forward, before any graph is built.

On the ``meta`` device both return empty outputs of the right shapes and
dtypes, through :class:`GateMLPFunction` when grad is wanted, as on CUDA:
no plain version runs, no kernel, no check of what the kernel takes.
While a :class:`repro_torch.roofline.counter.WorkCounter` is active,
every call on any device reports its work from its shapes
(:func:`repro_torch.roofline.counter.counted`).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import build
from repro_torch.roofline import counter
from repro_torch.roofline import work as W

launches = build.LaunchCounter("gate_mlp")
bwd_launches = build.LaunchCounter("gate_mlp_bwd")

DECODE_TOKENS = 16   # tokens per head up to which the decode path runs
SMS = 132            # streaming multiprocessors of the H100 SXM
MAX_F, MAX_M = 2048, 128
MAX_BWD_FM = 32768   # the backward stages w1[h] [F, M] whole in shared memory


def plan(r: int, s: int, h: int) -> int:
    """The kernel's tile for x [r, s, F] over h heads: 0 for the decode
    path (one CTA per head and 8 of its tokens, W1[h] read once), else
    the tensor-core path's tokens per CTA: 64 if that grid gives every SM
    a CTA, else 16."""
    if (r // h) * s <= DECODE_TOKENS:
        return 0
    return 64 if r * -(-s // 64) >= SMS else 16


def gate_mlp_plain(x, w1, b1, w2, b2):
    """x: [R, S, F]; w1: [H, F, M]; b1: [H, M]; w2: [H, M, 1]; b2: [H, 1]
    with R a multiple of H (row r uses head r % H) -> g [R, S] float32."""
    r, s, f = x.shape
    hh = w1.shape[0]
    xb = x.reshape(r // hh, hh, s, f)
    h = torch.einsum("bhsf,hfm->bhsm", xb, w1) + b1[None, :, None]
    h = F.gelu(h, approximate="tanh")
    y = torch.einsum("bhsm,hmo->bhso", h, w2) + b2[None, :, None]
    return torch.sigmoid(y[..., 0].float()).reshape(r, s)


def _gelu_tanh_and_grad(pre):
    c = 0.7978845608028654  # sqrt(2 / pi)
    t = torch.tanh(c * (pre + 0.044715 * pre ** 3))
    y = 0.5 * pre * (1.0 + t)
    dy = 0.5 * (1.0 + t) + 0.5 * pre * (1.0 - t * t) * c * (
        1.0 + 3.0 * 0.044715 * pre * pre)
    return y, dy


def gate_mlp_bwd_plain(x, w1, b1, w2, b2, g, dg):
    """The gradients of :func:`gate_mlp_plain` written out: from x [R, S,
    F], the weights, the forward's g [R, S] and dg [R, S] -> (dx [R, S, F],
    dw1 [H, F, M], db1 [H, M], dw2 [H, M, 1], db2 [H, 1]), summing each
    head's weight gradients over the rows ``r % H`` that use them."""
    r, s, f = x.shape
    hh, _, m = w1.shape
    xb = x.reshape(r // hh, hh, s, f).float()
    pre = torch.einsum("bhsf,hfm->bhsm", xb, w1) + b1[None, :, None]
    gel, dgel = _gelu_tanh_and_grad(pre)
    gb = g.reshape(r // hh, hh, s)
    dy = dg.reshape(r // hh, hh, s) * gb * (1.0 - gb)             # [b,h,s]
    dpre = dy[..., None] * w2[None, :, None, :, 0] * dgel           # [b,h,s,m]
    dx = torch.einsum("bhsm,hfm->bhsf", dpre, w1).reshape(r, s, f)
    dw1 = torch.einsum("bhsf,bhsm->hfm", xb, dpre)
    db1 = dpre.sum(dim=(0, 2))
    dw2 = torch.einsum("bhs,bhsm->hm", dy, gel)[..., None]
    db2 = dy.sum(dim=(0, 2))[:, None]
    return dx, dw1, db1, dw2, db2


def _check_cuda(x, w1, b1, w2, b2) -> None:
    r, s, f = x.shape
    hh, f2, m = w1.shape
    want = {"x": (x, (r, s, f)), "w1": (w1, (hh, f, m)), "b1": (b1, (hh, m)),
            "w2": (w2, (hh, m, 1)), "b2": (b2, (hh, 1))}
    for name, (t, shape) in want.items():
        if t.device != x.device:
            raise ValueError(f"gate_mlp: {name} on {t.device}, x on {x.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"gate_mlp kernel takes float32, {name} is {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"gate_mlp: {name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"gate_mlp: {name} must be contiguous")
    if r % hh:
        raise ValueError(f"gate_mlp: rows {r} not a multiple of heads {hh}")
    if f % 8 or f > MAX_F or m % 8 or m > MAX_M:
        raise ValueError(f"gate_mlp kernel takes F and M multiples of 8 with "
                         f"F <= {MAX_F} and M <= {MAX_M}, got F {f}, M {m}")
    for name, t in (("x", x), ("w1", w1)):
        if t.data_ptr() % 16:
            raise ValueError(f"gate_mlp: {name} must be 16-byte aligned")


def _forward_cuda(x, w1, b1, w2, b2):
    r, s, f = x.shape
    m = w1.shape[-1]
    g = torch.empty((r, s), dtype=torch.float32, device=x.device)
    if x.device.type == "meta":
        return g
    lib = build.load("gate_mlp")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.gate_mlp_f32(x.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                              w2.data_ptr(), b2.data_ptr(), g.data_ptr(),
                              r, s, f, m, w1.shape[0],
                              plan(r, s, w1.shape[0]), stream)
    if rc != 0:
        raise RuntimeError(f"gate_mlp kernel launch failed: CUDA error {rc}")
    launches.count += 1
    return g


def _check_bwd(w1) -> None:
    f, m = w1.shape[1], w1.shape[2]
    if f * m > MAX_BWD_FM:
        raise ValueError(f"gate_mlp backward kernel takes F M <= "
                         f"{MAX_BWD_FM}, got F {f}, M {m}")


def bwd_scratch(r: int, s: int, f: int, m: int, h: int):
    """The backward's chunks of each head's tokens (one CTA each) and the
    float32 scratch they need, for x [r, s, f], M m and h heads on the
    current CUDA device, both from the kernel's C side."""
    lib = build.load("gate_mlp_bwd")
    nch = lib.gate_mlp_bwd_chunks(r, s, f, m, h)
    if nch <= 0:
        raise ValueError(f"gate_mlp_bwd: no plan for x [{r}, {s}, {f}], "
                         f"M {m}, {h} heads on this device")
    return nch, lib.gate_mlp_bwd_scratch_floats(h, f, m, nch)


@counter.counted("gate_mlp_bwd", lambda x, w1, *a: W.gate_mlp_bwd(
    *x.shape, w1.shape[2], w1.shape[0]))
def gate_mlp_bwd(x, w1, b1, w2, b2, g, dg):
    """Gradients of ``gate_mlp`` -> (dx, dw1, db1, dw2, db2) by the
    hand-written kernel, on CUDA tensors only (on the CPU autograd
    differentiates :func:`gate_mlp_plain`; on ``meta``, the outputs'
    shapes)."""
    if x.device.type == "meta":
        return tuple(torch.empty_like(t) for t in (x, w1, b1, w2, b2))
    if x.device.type != "cuda":
        raise ValueError(f"gate_mlp_bwd: unsupported device {x.device}")
    _check_cuda(x, w1, b1, w2, b2)
    _check_bwd(w1)
    r, s, f = x.shape
    hh, _, m = w1.shape
    for name, t in (("g", g), ("dg", dg)):
        if t.device != x.device or t.dtype != torch.float32 \
                or tuple(t.shape) != (r, s) or not t.is_contiguous():
            raise ValueError(f"gate_mlp_bwd: {name} must be a contiguous "
                             f"float32 [{r}, {s}] on {x.device}")
    lib = build.load("gate_mlp_bwd")
    with torch.cuda.device(x.device):
        nch, floats = bwd_scratch(r, s, f, m, hh)
        part = torch.empty(floats, dtype=torch.float32, device=x.device)
        dx = torch.empty_like(x)
        dw1, db1 = torch.empty_like(w1), torch.empty_like(b1)
        dw2, db2 = torch.empty_like(w2), torch.empty_like(b2)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.gate_mlp_bwd_f32(
            x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
            g.data_ptr(), dg.data_ptr(), dx.data_ptr(), dw1.data_ptr(),
            db1.data_ptr(), dw2.data_ptr(), db2.data_ptr(), part.data_ptr(),
            r, s, f, m, hh, nch, stream)
    if rc != 0:
        raise RuntimeError(f"gate_mlp_bwd kernel launch failed: CUDA error "
                           f"{rc}")
    bwd_launches.count += 1
    return dx, dw1, db1, dw2, db2


class GateMLPFunction(torch.autograd.Function):
    """``gate_mlp`` on CUDA with its gradient: the forward kernel, and
    :func:`gate_mlp_bwd`'s kernel for the backward."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2):
        g = _forward_cuda(x, w1, b1, w2, b2)
        ctx.save_for_backward(x, w1, b1, w2, b2, g)
        return g

    @staticmethod
    def backward(ctx, dg):
        x, w1, b1, w2, b2, g = ctx.saved_tensors
        return gate_mlp_bwd(x, w1, b1, w2, b2, g, dg.contiguous())


@counter.counted("gate_mlp", lambda x, w1, *a: W.gate_mlp(
    *x.shape, w1.shape[2], w1.shape[0], plan(x.shape[0], x.shape[1],
                                             w1.shape[0]), x.element_size()))
def gate_mlp(x, w1, b1, w2, b2):
    """The ``gate_mlp`` contract: x [R, S, F] -> g [R, S] float32 with
    per-head weights indexed by ``row % H``. Differentiable on both
    devices (see the module's note)."""
    if x.device.type == "cpu":
        return gate_mlp_plain(x, w1, b1, w2, b2)
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"gate_mlp: unsupported device {x.device}")
    cuda = x.device.type == "cuda"
    if cuda:
        _check_cuda(x, w1, b1, w2, b2)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, w1, b1, w2, b2)):
        if cuda:
            _check_bwd(w1)
        return GateMLPFunction.apply(x, w1, b1, w2, b2)
    return _forward_cuda(x, w1, b1, w2, b2)
