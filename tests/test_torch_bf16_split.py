"""bf16 P·V from one, two and three bf16 terms of P, emulated on the CPU.

The prefill attention kernels (``csrc/flash_mma.cuh``, shared by
``gated_flash`` and ``vertical_slash``) multiply P, an f32 value in the
accumulators, by bf16 V on the bf16 tensor cores. P enters as
``PV_TERMS`` bf16 terms, each the bf16 rounding of what the earlier ones
left; the products of bf16 values are exact in f32 and summed there, and
the output is rounded to bf16. This file emulates that arithmetic with
one, two and three terms against the kernels' plain versions, which keep
P in f32, at the shapes of the bf16 mutation check
(``tests/test_torch_cuda.py``) and a few seeds:

* two terms (the kernels' choice) stay within the bf16 limit of 1e-2;
* one term, P rounded to bf16 as the Pallas kernels round it
  (``p.astype(v.dtype)``), puts some outputs in [2, 4) a whole ulp of the
  output (1.5625e-2) off the plain version on the seeds below, over the
  limit. That is why P is split.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.gated_flash import gated_flash_plain
from repro_torch.kernels.vertical_slash import vertical_slash_plain

LIMIT = 1e-2          # the bf16 limit of tests/test_torch_cuda.py
NEG_INF = -1e30
ONE_TERM_OVER = {"gated_flash": (2, 3, 5), "vertical_slash": (0, 2)}


def _terms(p, n):
    """P as n bf16 terms, largest first."""
    out, rest = [], p
    for _ in range(n):
        t = rest.to(torch.bfloat16).float()
        out.append(t)
        rest = rest - t
    return out


def _emulate(logits, v, n):
    """The kernels' softmax and P V with P as n bf16 terms (added smallest
    first), output rounded to bf16. logits [N, G, Sq, K] f32, v [N, K,
    hd] bf16 values as f32."""
    m = logits.amax(-1, keepdim=True)
    m = torch.where(m <= NEG_INF / 2, torch.zeros_like(m), m)
    p = torch.exp(logits - m)
    l = p.sum(-1, keepdim=True).clamp_min(1e-30)
    acc = torch.zeros(logits.shape[:-1] + (v.shape[-1],))
    for t in reversed(_terms(p, n)):
        acc = acc + torch.einsum("ngqk,nkd->ngqd", t, v)
    return (acc / l).to(torch.bfloat16)


def _bf16(rng, *shape):
    return torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32)).bfloat16()


def _gated_case(seed):
    """16 q heads on 8 kv heads, S 256, hd 128, W 64, with gates."""
    rng = np.random.default_rng(seed)
    s, hd, w, grp = 256, 128, 64, 2
    q, k, v = _bf16(rng, 16, s, hd), _bf16(rng, 8, s, hd), _bf16(rng, 8, s, hd)
    g = torch.from_numpy(rng.uniform(0.0, 1.0, (8, s)).astype(np.float32))
    want = gated_flash_plain(q, k, v, g, w_local=w, eps=1e-6, group=grp)
    logits = torch.einsum("ngqd,nkd->ngqk", q.float().reshape(8, grp, s, hd),
                          k.float()) * hd ** -0.5
    qi, kj = torch.arange(s)[:, None], torch.arange(s)[None]
    causal = qi >= kj
    logg = torch.log(g + 1e-6)[:, None, None, :]
    bias = torch.where(causal & (qi - kj < w), torch.zeros_like(logg), logg)
    logits = logits + torch.where(causal, bias, torch.full_like(bias, NEG_INF))
    return logits, v.float(), want.reshape(8, grp, s, hd)


def _vertical_slash_case(seed):
    """16 q heads on 8 kv heads, S 1024, hd 128, W 256, C 96 unsorted
    globals with INT32_MAX padding."""
    rng = np.random.default_rng(seed)
    s, hd, w, c, grp = 1024, 128, 256, 96, 2
    q, k, v = _bf16(rng, 16, s, hd), _bf16(rng, 8, s, hd), _bf16(rng, 8, s, hd)
    gpos = rng.integers(0, s - w, (8, c))
    gpos = np.where(np.arange(c)[None] < rng.integers(1, c, (8, 1)), gpos,
                    np.iinfo(np.int32).max).astype(np.int32)
    safe = torch.from_numpy(np.minimum(gpos, s - 1)).long()
    rows = torch.arange(8)[:, None]
    kg, vg = k[rows, safe].contiguous(), v[rows, safe].contiguous()
    tg = torch.from_numpy(gpos)
    want = vertical_slash_plain(q, k, v, kg, vg, tg, w_local=w, group=grp)
    qg = q.float().reshape(8, grp, s, hd)
    qi, kj = torch.arange(s)[:, None], torch.arange(s)[None]
    band = torch.einsum("ngqd,nkd->ngqk", qg, k.float()) * hd ** -0.5
    band = torch.where((qi >= kj) & (qi - kj < w), band,
                       torch.full_like(band, NEG_INF))
    glob = torch.einsum("ngqd,ncd->ngqc", qg, kg.float()) * hd ** -0.5
    vis = tg.long()[:, None, None, :] <= (qi[None, None] - w)
    glob = torch.where(vis, glob, torch.full_like(glob, NEG_INF))
    logits = torch.cat([band, glob], dim=-1)
    return logits, torch.cat([v, vg], dim=1).float(), want.reshape(
        8, grp, s, hd)


CASES = {"gated_flash": _gated_case, "vertical_slash": _vertical_slash_case}


def _errors(kernel, seed):
    logits, v, want = CASES[kernel](seed)
    return {n: float((_emulate(logits, v, n).float() - want.float())
                     .abs().max()) for n in (1, 2, 3)}


@pytest.mark.parametrize("kernel,seed", [
    ("gated_flash", s) for s in range(6)] + [
    ("vertical_slash", s) for s in range(3)])
def test_two_bf16_terms_of_p_hold_the_bf16_limit(kernel, seed):
    err = _errors(kernel, seed)
    assert err[2] <= LIMIT and err[3] <= LIMIT, err
    assert err[3] <= err[2] <= err[1], err
    if seed in ONE_TERM_OVER[kernel]:
        assert err[1] > LIMIT, err  # the reason P is split
