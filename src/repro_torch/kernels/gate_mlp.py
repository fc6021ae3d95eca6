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
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import build

launches = build.LaunchCounter("gate_mlp")

DECODE_TOKENS = 16   # tokens per head up to which the decode path runs
SMS = 132            # streaming multiprocessors of the H100 SXM
MAX_F, MAX_M = 2048, 128


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


def gate_mlp(x, w1, b1, w2, b2):
    """The ``gate_mlp`` contract: x [R, S, F] -> g [R, S] float32 with
    per-head weights indexed by ``row % H``."""
    if x.device.type == "cpu":
        return gate_mlp_plain(x, w1, b1, w2, b2)
    if x.device.type != "cuda":
        raise ValueError(f"gate_mlp: unsupported device {x.device}")
    _check_cuda(x, w1, b1, w2, b2)
    r, s, f = x.shape
    m = w1.shape[-1]
    g = torch.empty((r, s), dtype=torch.float32, device=x.device)
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
