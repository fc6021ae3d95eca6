"""The chunked arithmetic of the CUDA ``rglru_scan`` kernel, emulated on the
CPU against the JAX reference.

``csrc/rglru_scan.cu`` cuts time into chunks of L = NSUB x LS steps and
each chunk into NSUB sub-chunks of LS steps. Each sub-chunk is folded
from zero into a map ``h_end = A h_start + B``; the maps are composed in
order into the map into each sub-chunk and the chunk's own; chunk c's
carry is ``A_{c-1} carry_{c-1} + B_{c-1}``, in sequence over chunks; then
each sub-chunk is scanned again from its carry in. This file repeats that
arithmetic in float32 (its own helper, not a function of the package),
with L and LS read from the kernel's source, and holds it to the
reference's sequential scan (``rglru_scan_ref``, a ``lax.scan``) and to
the model's associative scan (``repro.models.rglru.rglru_scan``) at the
kernel's limit on the card, 5e-5: S not a multiple of L, S < L, S 1,
D 1, a carried-in state folded into ``b[:, 0]``, and recurrentgemma-9b's
sequence length.
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.models import rglru as JRG
from repro_torch.kernels import build
from repro_torch.kernels.rglru_scan import rglru_scan_plain

torch.set_num_threads(2)

LIMIT = 5e-5


def _kernel_constants():
    src = (build.CSRC / "rglru_scan.cu").read_text()
    nsub = int(re.search(r"constexpr int NSUB = (\d+);", src).group(1))
    ls = int(re.search(r"constexpr int LS = (\d+);", src).group(1))
    return nsub, ls


NSUB, LS = _kernel_constants()
L = NSUB * LS


def _chunked_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The kernel's arithmetic over a, b [B, S, D] float32, vectorised over
    (B, D); steps past S are the identity (a 1, b 0)."""
    bsz, s, d = a.shape
    nchunks = -(-s // L)
    pad = nchunks * L - s
    ap = torch.cat([a, torch.ones(bsz, pad, d)], 1).reshape(
        bsz, nchunks, NSUB, LS, d)
    bp = torch.cat([b, torch.zeros(bsz, pad, d)], 1).reshape(
        bsz, nchunks, NSUB, LS, d)
    # 1. each sub-chunk's map from zero
    sub_a = torch.ones(bsz, nchunks, NSUB, d)
    sub_b = torch.zeros(bsz, nchunks, NSUB, d)
    for i in range(LS):
        sub_b = ap[:, :, :, i] * sub_b + bp[:, :, :, i]
        sub_a = sub_a * ap[:, :, :, i]
    # 2. the map into each sub-chunk, composed in order, and the chunk's
    into_a = torch.empty_like(sub_a)
    into_b = torch.empty_like(sub_b)
    pa = torch.ones(bsz, nchunks, d)
    pb = torch.zeros(bsz, nchunks, d)
    for k in range(NSUB):
        into_a[:, :, k], into_b[:, :, k] = pa, pb
        pb = sub_a[:, :, k] * pb + sub_b[:, :, k]
        pa = pa * sub_a[:, :, k]
    # 3. the carries, in sequence over chunks
    carry = torch.zeros(bsz, nchunks, d)
    for c in range(1, nchunks):
        carry[:, c] = pa[:, c - 1] * carry[:, c - 1] + pb[:, c - 1]
    # 4. each sub-chunk again from its carry in
    hv = into_a * carry[:, :, None] + into_b
    out = torch.empty_like(ap)
    for i in range(LS):
        hv = ap[:, :, :, i] * hv + bp[:, :, :, i]
        out[:, :, :, i] = hv
    return out.reshape(bsz, nchunks * L, d)[:, :s]


def _inputs(rng, b, s, d):
    a = (1.0 / (1.0 + np.exp(-rng.standard_normal((b, s, d))))).astype(
        np.float32)
    bb = rng.standard_normal((b, s, d)).astype(np.float32)
    h0 = rng.standard_normal((b, d)).astype(np.float32)
    return a, bb, h0


@pytest.mark.parametrize("b,s,d,with_h0", [
    (3, 1000, 200, True),    # S not a multiple of L, a carried-in state
    (2, 100, 70, False),     # S < L: one chunk
    (2, L + 1, 70, True),    # one step in the last chunk
    (2, 1, 300, True),       # S = 1
    (4, 257, 1, False),      # D = 1
    (1, 4096, 256, False),   # recurrentgemma-9b's length, a slice of dr
])
def test_chunked_scan_matches_the_reference(b, s, d, with_h0):
    a, bb, h0 = _inputs(np.random.default_rng(s + d), b, s, d)
    if with_h0:  # folded into b[:, 0], as models/rglru.py does
        bf = bb.copy()
        bf[:, 0] += a[:, 0] * h0
    else:
        bf = bb
    got = _chunked_scan(torch.from_numpy(a), torch.from_numpy(bf)).numpy()
    seq = np.asarray(jref.rglru_scan_ref(
        jnp.asarray(a), jnp.asarray(bb),
        jnp.asarray(h0) if with_h0 else None))
    assoc = np.asarray(JRG.rglru_scan(jnp.asarray(a), jnp.asarray(bb),
                                      jnp.asarray(h0) if with_h0 else None))
    assert got.shape == (b, s, d)
    np.testing.assert_allclose(got, seq, atol=LIMIT, rtol=0)
    np.testing.assert_allclose(got, assoc, atol=LIMIT, rtol=0)
    plain = rglru_scan_plain(torch.from_numpy(a), torch.from_numpy(bf))
    np.testing.assert_allclose(got, plain.numpy(), atol=LIMIT, rtol=0)
    if s <= LS:  # one sub-chunk from zero: the plain loop's own steps
        np.testing.assert_array_equal(got, plain.numpy())


def test_chunk_length_is_the_kernels():
    """The emulation follows the kernel's chunk (32-128 steps) and its
    sub-chunks."""
    assert 32 <= L <= 128 and L % LS == 0
