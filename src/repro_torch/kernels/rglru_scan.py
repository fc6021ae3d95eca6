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
The kernel has no backward yet: on CUDA an input that requires grad
(with grad enabled) raises, so the hybrid's training path runs on the
CPU only.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

launches = build.LaunchCounter("rglru_scan")


def rglru_scan_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a, b: [B, S, D] -> h [B, S, D]: a loop over t of [B, D] products
    and sums, each rounded."""
    h = torch.zeros_like(b[:, 0])
    out = torch.empty_like(b)
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        out[:, t] = h
    return out


def _check_cuda(a: torch.Tensor, b: torch.Tensor) -> None:
    build.refuse_grad("rglru_scan", (a, b),
                      " (the hybrid's training path waits for an rglru_scan "
                      "backward kernel)")
    if a.dim() != 3 or tuple(a.shape) != tuple(b.shape):
        raise ValueError(f"rglru_scan: a {tuple(a.shape)} and b "
                         f"{tuple(b.shape)} must both be [B, S, D]")
    for name, t in (("a", a), ("b", b)):
        if t.device != a.device:
            raise ValueError(f"rglru_scan: {name} on {t.device}, a on "
                             f"{a.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"rglru_scan kernel takes float32, {name} is "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"rglru_scan: {name} must be contiguous")


def rglru_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The ``rglru_scan_pallas`` contract: a, b [B, S, D] float32 ->
    h [B, S, D] float32 with ``h[:, t] = a[:, t] * h[:, t-1] + b[:, t]``
    and ``h[:, -1] = 0``."""
    if a.device.type == "cpu":
        return rglru_scan_plain(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"rglru_scan: unsupported device {a.device}")
    _check_cuda(a, b)
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
