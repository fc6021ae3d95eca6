"""The write gate's product in 3xTF32 and in one TF32 pass, emulated on
the CPU against ``gate_mlp_plain``.

The tensor-core path of ``csrc/gate_mlp.cu`` multiplies x [T, F] by W1[h]
[F, M] on TF32 tensor cores. The tensor cores read the top 10 mantissa
bits of an f32 operand, so each operand is split (``flash_mma.cuh``):
hi is x with its 13 low mantissa bits cleared, lo is x - hi, of which the
tensor cores again read only the top bits, and a product is accumulated as
lo_a hi_b + hi_a lo_b + hi_a hi_b in f32. This file emulates that
arithmetic (products of truncated operands are exact in f32) and the rest
of the gate, at F 256 (qwen3-0.6b) and 512 (recurrentgemma-9b), over
several seeds:

* 3xTF32 stays within the gate's 1e-5 limit of the f32 plain version;
* one TF32 pass (hi_a hi_b alone) reads above it. That is why the
  operands are split.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.kernels.gate_mlp import gate_mlp_plain

torch.set_num_threads(2)

LIMIT = 1e-5  # the gate's limit on the card (tests/test_torch_cuda.py)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """x with its 13 low mantissa bits cleared: the value a TF32 tensor core
    reads."""
    return (x.view(torch.int32) & ~0x1FFF).view(torch.float32)


def _gate(x, w1, b1, w2, b2, terms: int):
    """The gate with x @ W1[h] from ``terms`` products of TF32 parts: 3 is
    the kernel's lo hi + hi lo + hi hi, 1 a single TF32 pass."""
    r, s, f = x.shape
    hh = w1.shape[0]
    xb = x.reshape(r // hh, hh, s, f)
    xh, wh = _tf32(xb), _tf32(w1)
    xl, wl = _tf32(xb - xh), _tf32(w1 - wh)
    prod = torch.einsum("bhsf,hfm->bhsm", xh, wh)
    if terms == 3:
        prod = (torch.einsum("bhsf,hfm->bhsm", xl, wh)
                + torch.einsum("bhsf,hfm->bhsm", xh, wl) + prod)
    h = F.gelu(prod + b1[None, :, None], approximate="tanh")
    y = torch.einsum("bhsm,hmo->bhso", h, w2) + b2[None, :, None]
    return torch.sigmoid(y[..., 0]).reshape(r, s)


def _inputs(seed, rows, s, hh, f, m=64):
    """The chip check's draws: x normal, W1 at f^-0.5, W2 at m^-0.5."""
    rng = np.random.default_rng(seed)

    def rn(*shape, scale=1.0):
        return torch.from_numpy(
            (scale * rng.standard_normal(shape)).astype(np.float32))
    return (rn(rows, s, f), rn(hh, f, m, scale=f ** -0.5),
            rn(hh, m, scale=0.1), rn(hh, m, 1, scale=m ** -0.5), rn(hh, 1))


@pytest.mark.parametrize("f,hh,rows", [(256, 8, 16), (512, 1, 2)])
@pytest.mark.parametrize("seed", range(4))
def test_3xtf32_holds_the_gate_limit_and_one_pass_does_not(f, hh, rows,
                                                           seed):
    args = _inputs(seed, rows, 256, hh, f)
    want = gate_mlp_plain(*args)
    three = float((_gate(*args, terms=3) - want).abs().max())
    one = float((_gate(*args, terms=1) - want).abs().max())
    assert three <= LIMIT, three
    assert one > LIMIT, one   # the reason the operands are split
    assert three < one / 100
