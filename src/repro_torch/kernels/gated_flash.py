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

The TPU kernel is forward-only, and so is the CUDA kernel: on CUDA the
wrapper raises for inputs that require grad (a hand-written backward
arrives with the training slice). The plain version is ordinary
differentiable PyTorch.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

NEG_INF = -1e30

launches = build.LaunchCounter("gated_flash")

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def gated_flash_plain(q, k, v, g, *, w_local: int, eps: float = 1e-6,
                      group: int = 1):
    """q: [Nq, S, hd]; k, v: [Nq/group, S, hd]; g: [Nq/group, S]
    -> [Nq, S, hd] in q's dtype (f32 math)."""
    nq, s, hd = q.shape
    nk = nq // group
    dev = q.device
    qg = q.reshape(nk, group, s, hd).float()
    logits = torch.einsum("ngqd,nkd->ngqk", qg, k.float()) * (hd ** -0.5)
    qi = torch.arange(s, device=dev)[:, None]
    kj = torch.arange(s, device=dev)[None, :]
    causal = qi >= kj
    in_win = causal & (qi - kj < w_local)
    logg = torch.log(g.float() + eps)[:, None, None, :]       # [nk,1,1,S]
    bias = torch.where(in_win, torch.zeros_like(logg), logg)
    logits = logits + torch.where(causal, bias, torch.full_like(bias, NEG_INF))
    m = logits.amax(dim=-1, keepdim=True)
    m_safe = torch.where(m <= NEG_INF / 2, torch.zeros_like(m), m)
    p = torch.exp(logits - m_safe)
    denom = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("ngqk,nkd->ngqd", p, v.float()) / denom
    return out.reshape(nq, s, hd).to(q.dtype)


def _check_cuda(q, k, v, g, group: int) -> None:
    nq, s, hd = q.shape
    if any(t.requires_grad for t in (q, k, v, g)):
        raise RuntimeError(
            "gated_flash: the CUDA kernel is forward-only and its inputs "
            "require grad; run under torch.no_grad() (a hand-written "
            "backward is not ported yet)")
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
            "v": (v, (nk, s, hd)), "g": (g, (nk, s))}
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
    if g.dtype != torch.float32:
        raise TypeError(f"gated_flash: g must be float32, got {g.dtype}")


def gated_flash(q, k, v, g, *, w_local: int, eps: float = 1e-6,
                group: int = 1):
    """Write-gated causal attention -> [Nq, S, hd]."""
    if q.device.type == "cpu":
        return gated_flash_plain(q, k, v, g, w_local=w_local, eps=eps,
                                 group=group)
    if q.device.type != "cuda":
        raise ValueError(f"gated_flash: unsupported device {q.device}")
    if q.ndim != 3:
        raise ValueError("gated_flash: q must be [Nq, S, hd]")
    _check_cuda(q, k, v, g, group)
    nq, s, hd = q.shape
    out = torch.empty_like(q)
    lib = build.load("gated_flash")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.gated_flash(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                             g.data_ptr(), out.data_ptr(), nq, s, hd,
                             w_local, group, eps, _DTYPE_CODE[q.dtype],
                             stream)
    if rc != 0:
        raise RuntimeError(f"gated_flash kernel launch failed: CUDA error "
                           f"{rc}")
    launches.count += 1
    return out
