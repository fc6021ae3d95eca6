"""xLSTM blocks (port of ``repro/models/xlstm.py``; Beck et al., 2024):
mLSTM (matrix memory, parallelizable) and sLSTM (scalar memory,
sequential exponential gating).

mLSTM runs its parallel form over a whole sequence: the quadratic form
(:func:`mlstm_block`) for short ones and the chunkwise form
(:func:`mlstm_block_chunkwise`, chunk 512) for long ones
(:func:`mlstm_auto`); its cross-chunk recurrence is combined in the
reference's ``jax.lax.associative_scan`` tree order
(:func:`associative_scan`), so the two packages round alike. Decode is the
O(1) recurrent form (C, n, m state, :func:`mlstm_step`). sLSTM is
sequential: :func:`slstm_block` loops over time in Python, one cell step
per token (the reference's ``jax.lax.scan``).

Neither block keeps a KV cache, so WG-KV does not apply
(``configs/xlstm_350m.py``); no kernel of the port runs here. The products
are plain ``torch.matmul`` / ``einsum``, as the reference computes them
outside any Pallas kernel.

On a mesh whose plan splits the xLSTM blocks (``rules.xlstm_split``: the
head count divides "model") a rank runs its heads, keeping the whole
model's head width. mLSTM: the normed input enters through
``comm.copy_to_model``, the up-projections and conv run on the rank's
channels (its heads' block of dm), ``comm.gather_model`` assembles the
conv output and the up-projection for ``w_q`` / ``w_k`` / ``w_v`` and
the gates over all of dm, ``out_norm``'s sum of squares is added over
"model" (``comm.sum_model``), and ``comm.reduce_model`` sums ``w_down``'s
partials. sLSTM: ``w_in`` holds the rank's heads' columns of each gate,
the recurrence runs on its heads with no collective inside the token
loop, the cell outputs are gathered once after it, and the gated MLP
splits over its width. Every state leaf holds the rank's heads.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.device import torch_dtype
from repro_torch.models import layers as L
from repro_torch.sharding import comm

Params = Dict[str, torch.Tensor]


# ==========================================================================
# mLSTM
# ==========================================================================
class MLSTMState(NamedTuple):
    conv: torch.Tensor   # [B, cw-1, dm] trailing conv inputs
    c: torch.Tensor      # [B, H, dh, dh] matrix memory
    n: torch.Tensor      # [B, H, dh] normalizer
    m: torch.Tensor      # [B, H] stabilizer


def _mdims(cfg: ModelConfig) -> Tuple[int, int, int]:
    dm = int(cfg.xlstm_proj_factor * cfg.d_model)
    h = cfg.n_heads
    return dm, h, dm // h


def _local_mdims(cfg: ModelConfig) -> Tuple[int, int, int]:
    """(the rank's channels of dm, its heads, the whole model's head
    width): the whole block off a mesh or when the plan keeps it
    whole."""
    _, h, dh = _mdims(cfg)
    hl = comm.xlstm_heads(h)[1]
    return hl * dh, hl, dh


def _split_rmsnorm(p: Params, x: torch.Tensor, width: int,
                   eps: float = 1e-6) -> torch.Tensor:
    """``layers.rmsnorm`` over a width of ``width`` channels of which
    ``x`` holds the rank's (``p``: their scales): the sum of squares is
    added over "model". The whole norm when the block is whole."""
    if x.shape[-1] == width:
        return L.rmsnorm(p, x, eps)
    x32 = x.float()
    ss = comm.sum_model(x32.square().sum(-1, keepdim=True), "xlstm")
    y = x32 * torch.rsqrt(ss / width + eps)
    return (y * p["scale"].float()).to(x.dtype)


def init_mlstm(gen: torch.Generator, cfg: ModelConfig, device) -> Params:
    dt = torch_dtype(cfg.param_dtype)
    d = cfg.d_model
    dm, h, _ = _mdims(cfg)

    def dense(shape, scale=None):
        return L.dense_init(gen, shape, dt, device, scale=scale)
    conv = torch.randn((cfg.xlstm_conv_width, dm), generator=gen,
                       device=device)
    return {
        "norm": L.init_rmsnorm(d, dt, device),
        "w_up_x": dense((d, dm)),
        "w_up_z": dense((d, dm)),
        "conv": (conv * 0.02).to(dt),
        "w_q": dense((dm, dm)),
        "w_k": dense((dm, dm)),
        "w_v": dense((dm, dm)),
        "w_i": dense((dm, h), scale=0.02),
        "b_i": torch.zeros((h,), dtype=dt, device=device),
        "w_f": dense((dm, h), scale=0.02),
        # positive forget bias => long memory at init
        "b_f": torch.full((h,), 3.0, dtype=dt, device=device),
        "out_norm": L.init_rmsnorm(dm, dt, device),
        "w_down": dense((dm, d)),
    }


def _mlstm_proj(p: Params, cfg: ModelConfig, x: torch.Tensor,
                conv_state: Optional[torch.Tensor]):
    """Shared projections. x: [B, S, D] (normed) -> (xm, z, q, k, v [B,
    H, S, dh], i_t, f_t [B, S, H] f32, the new conv state); on a split
    mesh the rank's heads and channels."""
    dm, h, dh = _local_mdims(cfg)
    dt = x.dtype
    x = comm.copy_to_model(x, "xlstm")
    xm = x @ p["w_up_x"].to(dt)                               # [B, S, dm]
    z = F.silu(x @ p["w_up_z"].to(dt))
    cw = p["conv"].shape[0]
    if conv_state is None:
        conv_state = torch.zeros((x.shape[0], cw - 1, dm), dtype=dt,
                                 device=x.device)
    xp = torch.cat([conv_state.to(dt), xm], dim=1)
    s = x.shape[1]
    xc = 0
    for i in range(cw):
        xc = xc + xp[:, i:i + s] * p["conv"][i].to(dt)
    xc = F.silu(xc)
    xc_all, xm_all = _gather_channels(xc, xm)

    def heads(y):
        return y.reshape(y.shape[0], y.shape[1], h, dh).transpose(1, 2)
    q = heads(xc_all @ p["w_q"].to(dt))
    k = heads(xc_all @ p["w_k"].to(dt)) / (dh ** 0.5)
    v = heads(xm_all @ p["w_v"].to(dt))
    i_t = xc_all @ p["w_i"].to(dt) + p["b_i"].to(dt)          # [B, S, H]
    f_t = xc_all @ p["w_f"].to(dt) + p["b_f"].to(dt)
    return (xm, z, q, k, v, i_t.float(), f_t.float(),
            xp[:, xp.shape[1] - (cw - 1):])


def _gather_channels(xc: torch.Tensor, xm: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The conv output and the up-projection over all of dm (one gather
    over "model" of both; their gradients reduce-scattered back), which
    the rank's heads' ``w_q`` / ``w_k`` / ``w_v`` and gates contract
    over; (xc, xm) when the block is whole."""
    if comm.splits("xlstm"):
        both = comm.gather_model(torch.stack([xc, xm]), "xlstm",
                                 grad_sum=True)
        return both[0], both[1]
    return xc, xm


def _mlstm_out(p: Params, cfg: ModelConfig, x: torch.Tensor,
               hsa: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """hsa [B, H, S, dh] f32 -> the block's output x + y."""
    b, h, s, dh = hsa.shape
    hsa = hsa.transpose(1, 2).reshape(b, s, h * dh).to(x.dtype)
    out = _split_rmsnorm(p["out_norm"], hsa, _mdims(cfg)[0]) * z
    return x + comm.reduce_model(out @ p["w_down"].to(x.dtype), "xlstm")


def mlstm_block(p: Params, cfg: ModelConfig, x: torch.Tensor,
                state: Optional[MLSTMState] = None
                ) -> Tuple[torch.Tensor, MLSTMState]:
    """The quadratic parallel form over a fresh stream (one chunk of the
    chunkwise form, O(S^2)); given a state it delegates to the chunkwise
    form with one chunk of S, as the reference."""
    if state is not None:
        return mlstm_block_chunkwise(p, cfg, x, state, chunk=x.shape[1])
    xin = L.rmsnorm(p["norm"], x)
    xm, z, q, k, v, i_t, f_t, new_conv = _mlstm_proj(p, cfg, xin, None)
    s = x.shape[1]
    logf = F.logsigmoid(f_t).transpose(1, 2)                  # [B, H, S]
    cum = torch.cumsum(logf, dim=-1)
    i_bh = i_t.transpose(1, 2)                                # [B, H, S]
    # log D_ij = i_j + cum_i - cum_j for j <= i
    ld = i_bh[:, :, None, :] + cum[:, :, :, None] - cum[:, :, None, :]
    causal = torch.ones((s, s), dtype=torch.bool, device=x.device).tril()
    ld = torch.where(causal, ld, torch.full_like(ld, float("-inf")))
    m_row = ld.amax(dim=-1)                                   # [B, H, S]
    dmat = torch.exp(ld - m_row[..., None])
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
    w = scores * dmat
    denom = torch.maximum(w.sum(-1).abs(), torch.exp(-m_row))
    hsa = torch.einsum("bhqk,bhkd->bhqd", w, v.float()) / denom[..., None]
    # the closed-form final recurrent state (prefill -> decode)
    tail = i_bh + cum[:, :, -1:] - cum
    m_fin = tail.amax(dim=-1)                                 # [B, H]
    wfin = torch.exp(tail - m_fin[..., None])                 # [B, H, S]
    c_fin = torch.einsum("bhs,bhsd,bhse->bhde", wfin, k.float(), v.float())
    n_fin = torch.einsum("bhs,bhsd->bhd", wfin, k.float())
    return (_mlstm_out(p, cfg, x, hsa, z),
            MLSTMState(conv=new_conv, c=c_fin, n=n_fin, m=m_fin))


def _chunk_combine(s1, s2):
    """Associative combine of stabilized (m, C, n, F) chunk states."""
    m1, c1, n1, f1 = s1
    m2, c2, n2, f2 = s2
    f = f1 + f2
    m = torch.maximum(m1 + f2, m2)
    w1 = torch.exp(m1 + f2 - m)
    w2 = torch.exp(m2 - m)
    c = w1[..., None, None] * c1 + w2[..., None, None] * c2
    n = w1[..., None] * n1 + w2[..., None] * n2
    return m, c, n, f


def _interleave(a: torch.Tensor, b: torch.Tensor, axis: int) -> torch.Tensor:
    """a[0], b[0], a[1], b[1], ... along ``axis`` (a may be one longer)."""
    n = a.shape[axis] + b.shape[axis]
    shape = list(a.shape)
    shape[axis] = n
    out = a.new_empty(shape)
    idx = torch.arange(n, device=a.device)
    out.index_copy_(axis, idx[0::2], a)
    out.index_copy_(axis, idx[1::2], b)
    return out


def associative_scan(fn: Callable, elems: Sequence[torch.Tensor],
                     axis: int) -> list:
    """Inclusive scan of ``fn`` over ``axis`` in ``jax.lax.associative_scan``'s
    order (pairs combined, the odd positions scanned recursively, the
    even ones combined from them), so its rounding is the reference's."""
    n = elems[0].shape[axis]
    if n < 2:
        return list(elems)

    def sl(e, start, stop=None, step=1):
        idx = torch.arange(e.shape[axis], device=e.device)[start:stop:step]
        return e.index_select(axis, idx)
    reduced = fn([sl(e, 0, -1, 2) for e in elems],
                 [sl(e, 1, None, 2) for e in elems])
    odd = associative_scan(fn, reduced, axis)
    if n % 2 == 0:
        even = fn([sl(e, 0, -1) for e in odd],
                  [sl(e, 2, None, 2) for e in elems])
    else:
        even = fn(odd, [sl(e, 2, None, 2) for e in elems])
    even = [torch.cat([sl(e, 0, 1), r], dim=axis)
            for e, r in zip(elems, even)]
    return [_interleave(a, b, axis) for a, b in zip(even, odd)]


def mlstm_block_chunkwise(p: Params, cfg: ModelConfig, x: torch.Tensor,
                          state: Optional[MLSTMState] = None, *,
                          chunk: int = 512
                          ) -> Tuple[torch.Tensor, MLSTMState]:
    """Chunkwise-parallel mLSTM: O(S/L * (L^2 + L*dh)*dh) instead of
    O(S^2*dh); the cross-chunk state recurrence runs through
    :func:`associative_scan`. The same semantics as :func:`mlstm_block`,
    and it continues a stream from ``state``."""
    xin = L.rmsnorm(p["norm"], x)
    conv_state = state.conv if state is not None else None
    xm, z, q, k, v, i_t, f_t, new_conv = _mlstm_proj(p, cfg, xin,
                                                     conv_state)
    b, s, _ = xin.shape
    _, h, dh = _local_mdims(cfg)
    nl = chunk
    if s % nl:
        raise ValueError(f"seq {s} must be a multiple of the chunk {nl}")
    nc = s // nl
    logf = F.logsigmoid(f_t).transpose(1, 2).reshape(b, h, nc, nl)
    i_bh = i_t.transpose(1, 2).reshape(b, h, nc, nl)
    qc = q.reshape(b, h, nc, nl, dh).float()
    kc = k.reshape(b, h, nc, nl, dh).float()
    vc = v.reshape(b, h, nc, nl, dh).float()
    bcum = torch.cumsum(logf, dim=-1)              # [B, H, nc, L] inclusive
    f_tot = bcum[..., -1]                          # [B, H, nc]
    # per-chunk stabilized state contribution
    loc = i_bh + f_tot[..., None] - bcum
    m_loc = loc.amax(dim=-1)                                  # [B, H, nc]
    w_loc = torch.exp(loc - m_loc[..., None])                 # [B, H, nc, L]
    c_loc = torch.einsum("bhcl,bhcld,bhcle->bhcde", w_loc, kc, vc)
    n_loc = torch.einsum("bhcl,bhcld->bhcd", w_loc, kc)
    # prefix (inclusive) states across chunks, then shifted: exclusive
    m_in, c_in, n_in, f_in = associative_scan(
        _chunk_combine, (m_loc, c_loc, n_loc, f_tot), axis=2)

    def shift(a, fill):
        return torch.cat([torch.full_like(a[:, :, :1], fill),
                          a[:, :, :-1]], dim=2)
    m_prev = shift(m_in, -1e30)
    c_prev = shift(c_in, 0.0)
    n_prev = shift(n_in, 0.0)
    if state is not None:
        # fold the incoming stream state into every prefix
        m0 = state.m[:, :, None]
        before = torch.cat([torch.zeros_like(f_in[:, :, :1]),
                            torch.cumsum(f_tot, 2)[:, :, :-1]], dim=2)
        mm = torch.maximum(m0 + before, m_prev)
        w0 = torch.exp(m0 + before - mm)
        wp = torch.exp(m_prev - mm)
        c_prev = (w0[..., None, None] * state.c[:, :, None]
                  + wp[..., None, None] * c_prev)
        n_prev = w0[..., None] * state.n[:, :, None] + wp[..., None] * n_prev
        m_prev = mm
    # per-token stabilizers and outputs
    intra = i_bh[:, :, :, None, :] + bcum[..., :, None] - bcum[..., None, :]
    causal = torch.ones((nl, nl), dtype=torch.bool, device=x.device).tril()
    intra = torch.where(causal, intra, torch.full_like(intra, float("-inf")))
    m_intra = intra.amax(dim=-1)                              # [B,H,nc,L]
    m_tot = torch.maximum(m_prev[..., None] + bcum, m_intra)  # [B,H,nc,L]
    w_intra = torch.exp(intra - m_tot[..., None])             # [B,H,nc,L,L]
    w_inter = torch.exp(m_prev[..., None] + bcum - m_tot)     # [B,H,nc,L]
    scores = torch.einsum("bhcld,bhcmd->bhclm", qc, kc)
    num = (torch.einsum("bhclm,bhclm,bhcme->bhcle", scores, w_intra, vc)
           + w_inter[..., None] * torch.einsum("bhcld,bhcde->bhcle", qc,
                                               c_prev))
    den = (torch.einsum("bhclm,bhclm->bhcl", scores, w_intra)
           + w_inter * torch.einsum("bhcld,bhcd->bhcl", qc, n_prev))
    den = torch.maximum(den.abs(), torch.exp(-m_tot))
    hsa = (num / den[..., None]).reshape(b, h, s, dh)
    # the final stream state: the last inclusive prefix (+ incoming state)
    m_fin, c_fin, n_fin = m_in[:, :, -1], c_in[:, :, -1], n_in[:, :, -1]
    if state is not None:
        ftot_all = f_tot.sum(dim=2)
        mm = torch.maximum(state.m + ftot_all, m_fin)
        w0 = torch.exp(state.m + ftot_all - mm)
        wp = torch.exp(m_fin - mm)
        c_fin = w0[..., None, None] * state.c + wp[..., None, None] * c_fin
        n_fin = w0[..., None] * state.n + wp[..., None] * n_fin
        m_fin = mm
    return (_mlstm_out(p, cfg, x, hsa, z),
            MLSTMState(conv=new_conv, c=c_fin, n=n_fin, m=m_fin))


def mlstm_auto(p: Params, cfg: ModelConfig, x: torch.Tensor,
               state: Optional[MLSTMState] = None
               ) -> Tuple[torch.Tensor, MLSTMState]:
    """The quadratic form for short sequences, chunkwise (chunk 512) iff
    S > 1024 and a multiple of 512, as the reference dispatches."""
    s = x.shape[1]
    if s > 1024 and s % 512 == 0:
        return mlstm_block_chunkwise(p, cfg, x, state, chunk=512)
    return mlstm_block(p, cfg, x, state)


def mlstm_step(p: Params, cfg: ModelConfig, x_t: torch.Tensor,
               state: MLSTMState) -> Tuple[torch.Tensor, MLSTMState]:
    """O(1) recurrent decode step. x_t: [B, D]."""
    xin = L.rmsnorm(p["norm"], x_t)[:, None]                  # [B, 1, D]
    dm, h, dh = _local_mdims(cfg)
    dt = xin.dtype
    xin = comm.copy_to_model(xin, "xlstm")
    xm = xin @ p["w_up_x"].to(dt)
    z = F.silu(xin @ p["w_up_z"].to(dt))
    window = torch.cat([state.conv.to(xm.dtype), xm], dim=1)  # [B, cw, dm]
    xc = F.silu(torch.einsum("bcd,cd->bd", window, p["conv"].to(xm.dtype)))
    b = x_t.shape[0]
    xc_all, xm_all = _gather_channels(xc, xm[:, 0])

    def heads(y):
        return y.reshape(b, h, dh)
    q = heads(xc_all @ p["w_q"].to(dt)).float()
    k = heads(xc_all @ p["w_k"].to(dt)).float() / (dh ** 0.5)
    v = heads(xm_all @ p["w_v"].to(dt)).float()
    i_t = (xc_all @ p["w_i"].to(dt) + p["b_i"].to(dt)).float()
    f_t = (xc_all @ p["w_f"].to(dt) + p["b_f"].to(dt)).float()
    logf = F.logsigmoid(f_t)                                  # [B, H]
    m_new = torch.maximum(logf + state.m, i_t)
    fprime = torch.exp(logf + state.m - m_new)
    iprime = torch.exp(i_t - m_new)
    c_new = (fprime[..., None, None] * state.c
             + iprime[..., None, None] * (k[..., :, None] * v[..., None, :]))
    n_new = fprime[..., None] * state.n + iprime[..., None] * k
    num = torch.einsum("bhde,bhd->bhe", c_new, q)
    den = torch.maximum(torch.einsum("bhd,bhd->bh", n_new, q).abs(),
                        torch.exp(-m_new))
    hsa = (num / den[..., None]).reshape(b, dm).to(x_t.dtype)
    out = _split_rmsnorm(p["out_norm"], hsa, _mdims(cfg)[0]) * z[:, 0]
    y = comm.reduce_model(out @ p["w_down"].to(x_t.dtype), "xlstm")
    return x_t + y, MLSTMState(conv=window[:, 1:], c=c_new, n=n_new,
                               m=m_new)


def init_mlstm_state(cfg: ModelConfig, batch: int, dtype=torch.float32,
                     device=None) -> MLSTMState:
    dm, h, dh = _mdims(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    return MLSTMState(
        conv=torch.zeros((batch, cfg.xlstm_conv_width - 1, dm), dtype=dtype,
                         device=device),
        c=torch.zeros((batch, h, dh, dh), **f32),
        n=torch.zeros((batch, h, dh), **f32),
        m=torch.full((batch, h), -1e30, **f32))


# ==========================================================================
# sLSTM
# ==========================================================================
class SLSTMState(NamedTuple):
    c: torch.Tensor   # [B, D]
    n: torch.Tensor   # [B, D]
    h: torch.Tensor   # [B, D]
    m: torch.Tensor   # [B, D]


def _slstm_dff(d: int) -> int:
    """The post-cell gated MLP's width (xLSTM: projection factor 4/3)."""
    return int(d * 4 / 3 / 2) * 2


def init_slstm(gen: torch.Generator, cfg: ModelConfig, device) -> Params:
    dt = torch_dtype(cfg.param_dtype)
    d, h = cfg.d_model, cfg.n_heads
    dh = d // h
    dff = _slstm_dff(d)

    def dense(shape, scale=None):
        return L.dense_init(gen, shape, dt, device, scale=scale)
    b = torch.zeros((4 * d,), dtype=torch.float32, device=device)
    b[2 * d:3 * d] = 3.0
    return {
        "norm": L.init_rmsnorm(d, dt, device),
        "w_in": dense((d, 4 * d)),                 # z, i, f, o pre-acts
        "r": dense((4, h, dh, dh), scale=dh ** -0.5),
        "b": b.to(dt),
        "out_norm": L.init_rmsnorm(d, dt, device),
        "w_up1": dense((d, dff)),
        "w_up2": dense((d, dff)),
        "w_down": dense((dff, d)),
    }


def _recurrent_weights(p: Params) -> torch.Tensor:
    """The block-diagonal recurrent weights r [4, H, dh, dh] laid out
    [H, dh, 4 * dh] for one batched product per step; built once per
    sequence, so autograd keeps one copy, not one per step."""
    g, h, dh, _ = p["r"].shape
    return p["r"].permute(1, 2, 0, 3).reshape(h, dh, g * dh)


def _slstm_cell(r_t: torch.Tensor, pre: torch.Tensor,
                state: SLSTMState) -> SLSTMState:
    """pre: [B, 4D] input pre-activations (W x + b), the z, i, f, o
    blocks in order; r_t: the recurrent weights of
    :func:`_recurrent_weights` [H, dh, 4 dh]. One time step, with the
    reference's arithmetic element by element. H and dh come from
    ``r_t``, so on a split mesh the cell runs the rank's heads (D their
    channels) at the whole model's head width."""
    h, dh = r_t.shape[0], r_t.shape[1]
    d = h * dh
    b = state.h.shape[0]
    hp = state.h.reshape(b, h, dh).transpose(0, 1)           # [H, B, dh]
    rec = torch.bmm(hp.to(r_t.dtype), r_t)                   # [H, B, 4 dh]
    rec = rec.reshape(h, b, 4, dh).permute(1, 2, 0, 3).reshape(b, 4 * d)
    g = pre.float() + rec.float()
    z_t = torch.tanh(g[:, :d])
    i_t = g[:, d:2 * d]
    f_t = F.logsigmoid(g[:, 2 * d:3 * d])
    o_t = torch.sigmoid(g[:, 3 * d:])
    fm = f_t + state.m
    m_new = torch.maximum(fm, i_t)
    ip = torch.exp(i_t - m_new)
    fp = torch.exp(fm - m_new)
    c_new = fp * state.c + ip * z_t
    n_new = torch.clamp(fp * state.n + ip, min=1e-6)
    return SLSTMState(c=c_new, n=n_new, h=o_t * c_new / n_new, m=m_new)


def _slstm_mlp(p: Params, x: torch.Tensor, hs: torch.Tensor
               ) -> torch.Tensor:
    """The post-cell gated MLP over the cell outputs ``hs`` -> x + y. On
    a split mesh ``hs`` holds the rank's heads' channels: they are
    gathered over "model" once, the norm runs whole, and the MLP over
    the rank's block of its width."""
    dt = x.dtype
    hs = comm.gather_model(hs, "xlstm", grad_sum=False)
    out = comm.copy_to_model(L.rmsnorm(p["out_norm"], hs.to(dt)), "xlstm")
    y = (F.gelu(out @ p["w_up1"].to(dt), approximate="tanh")
         * (out @ p["w_up2"].to(dt))) @ p["w_down"].to(dt)
    return x + comm.reduce_model(y, "xlstm")


def slstm_block(p: Params, cfg: ModelConfig, x: torch.Tensor,
                state: Optional[SLSTMState] = None
                ) -> Tuple[torch.Tensor, SLSTMState]:
    """Sequential forward over time, one cell step per token in a Python
    loop. x: [B, S, D]."""
    b, s, _ = x.shape
    if state is None:
        state = init_slstm_state(cfg, b, device=x.device,
                                 width=p["w_in"].shape[-1] // 4)
    xin = comm.copy_to_model(L.rmsnorm(p["norm"], x), "xlstm")
    pre = xin @ p["w_in"].to(x.dtype) + p["b"].to(x.dtype)   # [B, S, 4D]
    hs, state = _slstm_scan(_recurrent_weights(p), pre, state)
    return _slstm_mlp(p, x, hs), state


def _slstm_scan(r_t: torch.Tensor, pre: torch.Tensor,
                state: SLSTMState) -> Tuple[torch.Tensor, SLSTMState]:
    """The cell over pre [B, S, 4D], one step per token -> (the stacked
    cell outputs [B, S, D], the last state). On the ``meta`` device (the
    dry run) the loop does not run: the outputs are views of ``pre`` of
    the loop's shapes (so a backward reaches ``pre``), and the dry run
    adds the loop's recurrent products
    from ``roofline.analysis.slstm_hidden_flops``, as the reference adds
    them to XLA's count of its hidden scan."""
    if pre.device.type == "meta":
        # views of the input, so that a backward on meta reaches what the
        # loop reads, as it does on a device
        d = pre.shape[-1] // 4
        last = pre[:, -1, :d].float()
        return pre[..., :d].float(), SLSTMState(last, last, last, last)
    hs = []
    for t in range(pre.shape[1]):
        state = _slstm_cell(r_t, pre[:, t], state)
        hs.append(state.h)
    return torch.stack(hs, dim=1), state


def slstm_step(p: Params, cfg: ModelConfig, x_t: torch.Tensor,
               state: SLSTMState) -> Tuple[torch.Tensor, SLSTMState]:
    """One decode step. x_t: [B, D]."""
    xin = comm.copy_to_model(L.rmsnorm(p["norm"], x_t), "xlstm")
    pre = xin @ p["w_in"].to(x_t.dtype) + p["b"].to(x_t.dtype)
    st = _slstm_cell(_recurrent_weights(p), pre, state)
    return _slstm_mlp(p, x_t, st.h), st


def init_slstm_state(cfg: ModelConfig, batch: int, device=None,
                     width: Optional[int] = None) -> SLSTMState:
    """The zero state over ``width`` channels (default d_model; a split
    mesh rank's heads' channels)."""
    z = torch.zeros((batch, width or cfg.d_model), dtype=torch.float32,
                    device=device)
    return SLSTMState(c=z, n=z + 1e-6, h=z, m=z - 1e30)
