"""Write-gated flash attention kernel wrapper (port of
``repro/kernels/gated_flash.py::gated_flash``, paper §3.2).

:func:`gated_flash` launches the hand-written CUDA kernel
(``csrc/gated_flash.cu``) for tensors on a CUDA device and runs
:func:`gated_flash_plain`, its plain PyTorch version, for tensors on the
CPU. Nothing else decides: a CUDA tensor the kernel does not take raises.

Causal attention with the log-space gate bias: 0 inside the local window
(i - j < W), ``log(g_j + eps)`` outside it. ``group`` query streams share
one kv stream (GQA): query stream n reads kv stream ``n // group``, so K,
V and g are never repeated.

Gradients. The TPU kernel is forward-only; the port's has a backward of
its own. On the CPU autograd differentiates :func:`gated_flash_plain`. On
CUDA, when grad is enabled and an input requires it, :func:`gated_flash`
runs through :class:`GatedFlashFunction`: the forward kernel also writes
each row's log-sum-exp, and :func:`gated_flash_bwd`
(``csrc/gated_flash_bwd.cu``: its five products in 3xTF32 on the tensor
cores, tiles through a ``cp.async`` ring; f32, hd a multiple of 8 up to
128, or 256 with hd split over warps and each kv stream's query heads
split over CTAs; its plain version :func:`gated_flash_bwd_plain`)
computes dq, dk, dv and dg.
Anything else that requires grad on CUDA (bf16, hd in 136..248) raises.

The hard window. :func:`gated_flash_window` runs the same kernel in its
hard-window mode (the dense baseline's windowed prefill of
local-attention blocks): query i sees key j iff 0 <= i - j < W, no gate.
Its plain version :func:`gated_flash_window_plain` is the reference's
windowed mask (``attn_prefill_full(window=)``). Forward only: on CUDA an
input that requires grad raises. Its launches count in
``window_launches``.

On the ``meta`` device every entry returns empty outputs of the right
shapes and dtypes (through :class:`GatedFlashFunction` when grad is
wanted, as on CUDA): no plain version runs, no kernel, no check of what
the kernel takes. While a
:class:`repro_torch.roofline.counter.WorkCounter` is active, every call
on any device reports its work from its shapes
(:func:`repro_torch.roofline.counter.counted`).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.roofline import counter
from repro_torch.roofline import work as W

NEG_INF = -1e30

launches = build.LaunchCounter("gated_flash")
bwd_launches = build.LaunchCounter("gated_flash_bwd")
window_launches = build.LaunchCounter("gated_flash_window")

# head dims of the backward kernel: multiples of 8 up to 128, and 256
BWD_HD = tuple(range(8, 129, 8)) + (256,)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _masks(s: int, w_local: int, device):
    qi = torch.arange(s, device=device)[:, None]
    kj = torch.arange(s, device=device)[None, :]
    causal = qi >= kj
    return causal, causal & (qi - kj < w_local)


def _logits(qg, k, g, w_local: int, eps: float):
    """Scaled scores plus the gate bias, NEG_INF above the diagonal:
    [Nk, group, S, S] in f32."""
    s, hd = qg.shape[2], qg.shape[3]
    causal, in_win = _masks(s, w_local, qg.device)
    logits = torch.einsum("ngqd,nkd->ngqk", qg, k.float()) * (hd ** -0.5)
    logg = torch.log(g.float() + eps)[:, None, None, :]       # [nk,1,1,S]
    bias = torch.where(in_win, torch.zeros_like(logg), logg)
    return logits + torch.where(causal, bias, torch.full_like(bias, NEG_INF))


def gated_flash_plain(q, k, v, g, *, w_local: int, eps: float = 1e-6,
                      group: int = 1, with_lse: bool = False):
    """q: [Nq, S, hd]; k, v: [Nq/group, S, hd]; g: [Nq/group, S]
    -> [Nq, S, hd] in q's dtype (f32 math); with ``with_lse`` also each
    row's log-sum-exp [Nq, S] f32 (max + log of the sum), as the kernel
    writes it for the backward."""
    nq, s, hd = q.shape
    nk = nq // group
    qg = q.reshape(nk, group, s, hd).float()
    logits = _logits(qg, k, g, w_local, eps)
    m = logits.amax(dim=-1, keepdim=True)
    m_safe = torch.where(m <= NEG_INF / 2, torch.zeros_like(m), m)
    p = torch.exp(logits - m_safe)
    denom = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("ngqk,nkd->ngqd", p, v.float()) / denom
    out = out.reshape(nq, s, hd).to(q.dtype)
    if not with_lse:
        return out
    return out, (m_safe + torch.log(denom)).reshape(nq, s)


def gated_flash_bwd_plain(q, k, v, g, o, lse, do, *, w_local: int,
                          eps: float = 1e-6, group: int = 1):
    """The gradients of :func:`gated_flash_plain` written out, from the
    forward's output o [Nq, S, hd] and log-sum-exp lse [Nq, S] and the
    output's gradient do -> (dq, dk, dv, dg) in f32: P = exp(s - lse),
    D = rowsum(do o), dS = P (do v^T - D); dv = P^T do, dk = dS^T q /
    sqrt(hd), dq = dS k / sqrt(hd), dg_j = the sum of dS_ij over the rows
    outside the window (i - j >= W) / (g_j + eps); dk, dv and dg summed
    over each kv stream's ``group`` query streams."""
    nq, s, hd = q.shape
    nk = nq // group
    scale = hd ** -0.5
    qg = q.reshape(nk, group, s, hd).float()
    dog = do.reshape(nk, group, s, hd).float()
    og = o.reshape(nk, group, s, hd).float()
    causal, in_win = _masks(s, w_local, q.device)
    p = torch.exp(_logits(qg, k, g, w_local, eps)
                  - lse.reshape(nk, group, s, 1).float())
    dvec = (dog * og).sum(-1, keepdim=True)
    dp = torch.einsum("ngqd,nkd->ngqk", dog, v.float())
    ds = p * (dp - dvec)
    dv = torch.einsum("ngqk,ngqd->nkd", p, dog)
    dq = torch.einsum("ngqk,nkd->ngqd", ds, k.float()) * scale
    dk = torch.einsum("ngqk,ngqd->nkd", ds, qg) * scale
    outside = causal & ~in_win
    dg = torch.where(outside, ds, torch.zeros_like(ds)).sum(dim=(1, 2)) \
        / (g.float() + eps)
    return dq.reshape(nq, s, hd), dk, dv, dg


def gated_flash_window_plain(q, k, v, *, window: int, group: int = 1):
    """q: [Nq, S, hd]; k, v: [Nq/group, S, hd] -> [Nq, S, hd] in q's
    dtype (f32 math): key j visible to query i iff 0 <= i - j < window."""
    nq, s, hd = q.shape
    nk = nq // group
    qg = q.reshape(nk, group, s, hd).float()
    _, in_win = _masks(s, window, q.device)
    logits = torch.einsum("ngqd,nkd->ngqk", qg, k.float()) * (hd ** -0.5)
    logits = torch.where(in_win, logits, torch.full_like(logits, NEG_INF))
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("ngqk,nkd->ngqd", w, v.float())
    return out.reshape(nq, s, hd).to(q.dtype)


def _check_cuda(q, k, v, g, group: int) -> None:
    nq, s, hd = q.shape
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"gated_flash kernel takes float32 or bfloat16, "
                        f"got {q.dtype}")
    if not 0 < hd <= 256 or hd % 8:
        raise ValueError(f"gated_flash kernel takes hd <= 256, a multiple "
                         f"of 8, got {hd}")
    if group < 1 or nq % group:
        raise ValueError(f"gated_flash: {nq} query streams are not a "
                         f"multiple of group {group}")
    nk = nq // group
    want = {"q": (q, (nq, s, hd)), "k": (k, (nk, s, hd)),
            "v": (v, (nk, s, hd))}
    if g is not None:
        want["g"] = (g, (nk, s))
    for name, (t, shape) in want.items():
        if t.device != q.device:
            raise ValueError(f"gated_flash: {name} on {t.device}, q on "
                             f"{q.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"gated_flash: {name} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"gated_flash: {name} must be contiguous")
        if name != "g" and t.data_ptr() % 16:
            raise ValueError(f"gated_flash: {name} must be 16-byte aligned")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"gated_flash: k and v must be {q.dtype}")
    if g is not None and g.dtype != torch.float32:
        raise TypeError(f"gated_flash: g must be float32, got {g.dtype}")


def _forward_cuda(q, k, v, g, w_local: int, eps: float, group: int,
                  with_lse: bool):
    nq, s, hd = q.shape
    out = torch.empty_like(q)
    lse = (torch.empty((nq, s), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if q.device.type == "meta":
        return out, lse
    lib = build.load("gated_flash")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.gated_flash(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                             g.data_ptr(), out.data_ptr(),
                             lse.data_ptr() if with_lse else None, nq, s, hd,
                             w_local, group, eps, _DTYPE_CODE[q.dtype],
                             stream)
    if rc != 0:
        raise RuntimeError(f"gated_flash kernel launch failed: CUDA error "
                           f"{rc}")
    launches.count += 1
    return out, lse


def _check_bwd(q) -> None:
    hd = q.shape[-1]
    if q.dtype != torch.float32 or hd not in BWD_HD:
        raise RuntimeError(
            f"gated_flash: the backward kernel takes float32 with hd a "
            f"multiple of 8 up to 128, or 256 (got {q.dtype}, hd {hd}); run "
            f"the forward under torch.no_grad() or in float32")


@counter.counted("gated_flash_bwd", lambda q, *a, group=1, **kw:
                 W.gated_flash_bwd(*q.shape, group))
def gated_flash_bwd(q, k, v, g, o, lse, do, *, w_local: int,
                    eps: float = 1e-6, group: int = 1):
    """Gradients of ``gated_flash`` -> (dq, dk, dv, dg) by the
    hand-written kernel, on CUDA tensors only (on the CPU autograd
    differentiates :func:`gated_flash_plain`; on ``meta``, the outputs'
    shapes)."""
    if q.device.type == "meta":
        return tuple(torch.empty_like(t) for t in (q, k, v, g))
    if q.device.type != "cuda":
        raise ValueError(f"gated_flash_bwd: unsupported device {q.device}")
    _check_cuda(q, k, v, g, group)
    _check_bwd(q)
    nq, s, hd = q.shape
    for name, t, shape in (("o", o, (nq, s, hd)), ("do", do, (nq, s, hd)),
                           ("lse", lse, (nq, s))):
        if t.device != q.device or t.dtype != torch.float32 \
                or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"gated_flash_bwd: {name} must be a contiguous "
                             f"float32 {list(shape)} on {q.device}")
    if do.data_ptr() % 16:
        raise ValueError("gated_flash_bwd: do must be 16-byte aligned")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dg = torch.empty_like(g)
    dvec = torch.empty((nq, s), dtype=torch.float32, device=q.device)
    lib = build.load("gated_flash_bwd")
    # hd 256: the partial dk, dv and dg sums of each kv stream's head splits
    floats = lib.gated_flash_bwd_scratch_floats(nq, s, hd, group)
    part = (torch.empty(floats, dtype=torch.float32, device=q.device)
            if floats else None)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.gated_flash_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            o.data_ptr(), lse.data_ptr(), do.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), dg.data_ptr(), dvec.data_ptr(),
            part.data_ptr() if part is not None else None,
            nq, s, hd, w_local, group, eps, stream)
    if rc != 0:
        raise RuntimeError(f"gated_flash_bwd kernel launch failed: CUDA "
                           f"error {rc}")
    bwd_launches.count += 1
    return dq, dk, dv, dg


class GatedFlashFunction(torch.autograd.Function):
    """``gated_flash`` on CUDA with its gradient: the forward kernel with
    its log-sum-exp, and :func:`gated_flash_bwd`'s kernels for the
    backward. Under ``torch.utils.checkpoint`` the forward, lse included,
    runs again before the backward."""

    @staticmethod
    def forward(ctx, q, k, v, g, w_local, eps, group):
        out, lse = _forward_cuda(q, k, v, g, w_local, eps, group, True)
        ctx.save_for_backward(q, k, v, g, out, lse)
        ctx.args = (w_local, eps, group)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, g, out, lse = ctx.saved_tensors
        w_local, eps, group = ctx.args
        dq, dk, dv, dg = gated_flash_bwd(q, k, v, g, out, lse, do.contiguous(),
                                         w_local=w_local, eps=eps, group=group)
        return dq, dk, dv, dg, None, None, None


def _flash_work(q, k, v, g, *, group=1, **kw):
    grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v, g))
    return W.gated_flash(*q.shape, group, q.element_size(), with_lse=grad)


@counter.counted("gated_flash", _flash_work)
def gated_flash(q, k, v, g, *, w_local: int, eps: float = 1e-6,
                group: int = 1):
    """Write-gated causal attention -> [Nq, S, hd]. Differentiable on
    both devices (see the module's note)."""
    if q.device.type == "cpu":
        return gated_flash_plain(q, k, v, g, w_local=w_local, eps=eps,
                                 group=group)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"gated_flash: unsupported device {q.device}")
    if q.ndim != 3:
        raise ValueError("gated_flash: q must be [Nq, S, hd]")
    cuda = q.device.type == "cuda"
    if cuda:
        _check_cuda(q, k, v, g, group)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v, g)):
        if cuda:
            _check_bwd(q)
        return GatedFlashFunction.apply(q, k, v, g, w_local, eps, group)
    return _forward_cuda(q, k, v, g, w_local, eps, group, False)[0]


@counter.counted("gated_flash_window", lambda q, k, v, *, window, group=1:
                 W.gated_flash_window(*q.shape, group, window,
                                      q.element_size()))
def gated_flash_window(q, k, v, *, window: int, group: int = 1):
    """Hard-window causal attention -> [Nq, S, hd]: the kernel's
    hard-window mode on CUDA (forward only), its plain version on the
    CPU."""
    if window < 1:
        raise ValueError(f"gated_flash_window: window must be >= 1, got "
                         f"{window}")
    if q.device.type == "cpu":
        return gated_flash_window_plain(q, k, v, window=window, group=group)
    if q.device.type == "meta":
        return torch.empty_like(q)
    if q.device.type != "cuda":
        raise ValueError(f"gated_flash_window: unsupported device "
                         f"{q.device}")
    if q.ndim != 3:
        raise ValueError("gated_flash_window: q must be [Nq, S, hd]")
    build.refuse_grad("gated_flash_window", (q, k, v))
    _check_cuda(q, k, v, None, group)
    nq, s, hd = q.shape
    out = torch.empty_like(q)
    lib = build.load("gated_flash")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.gated_flash_window(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                    out.data_ptr(), nq, s, hd, window, group,
                                    _DTYPE_CODE[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"gated_flash_window kernel launch failed: CUDA "
                           f"error {rc}")
    window_launches.count += 1
    return out
