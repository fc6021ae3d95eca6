"""Griffin / RecurrentGemma recurrent block: temporal conv + RG-LRU (port of
``repro/models/rglru.py``).

RG-LRU (Real-Gated Linear Recurrent Unit):
    r_t = sigmoid(W_r x_t)          recurrence gate (block-diagonal per head)
    i_t = sigmoid(W_i x_t)          input gate
    a_t = exp(c * r_t * log sigmoid(Lambda))       (a = sigmoid(Λ)^(c·r))
    h_t = a_t ⊙ h_{t-1} + sqrt(1 - a_t^2) ⊙ (i_t ⊙ x_t)

The full-sequence form (:func:`rglru_block`) evaluates the linear
recurrence through ``ops.rglru_linear_scan``: on CUDA the hand-written
``rglru_scan`` kernel, on the CPU its plain loop. The reference evaluates
it with ``jax.lax.associative_scan``, which rounds in another order; the
port's scan is sequential in t, as the Pallas kernel and the oracle are.
Decoding (:func:`rglru_step`) advances the state one position at a time.
The gates and the recurrence run in float32 whatever the model dtype.

On a mesh (``sharding.comm``, the plan's ``rec``) the block is
channel-parallel: x enters through ``copy_to_model("rec")``, the rank
runs ``w_gelu``, ``w_x``, the causal conv, the block-diagonal gates and
the scan on its ``dr / ways`` channels (whole gate blocks), its state
holds those channels, and ``reduce_model("rec")`` sums ``w_out``'s
partials.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.device import torch_dtype
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.sharding import comm

Params = Dict[str, torch.Tensor]
_C = 8.0  # Griffin's gate sharpness constant


class RGLRUState(NamedTuple):
    conv: torch.Tensor  # [B, cw-1, dr] trailing conv inputs
    h: torch.Tensor     # [B, dr] float32


def init_rglru(gen: torch.Generator, cfg: ModelConfig, device) -> Params:
    """Random parameters, the reference's shapes and scales (its draws
    differ; carry weights across with ``convert.params_from_numpy``).
    ``lam`` is float32 whatever ``param_dtype`` is."""
    dt = torch_dtype(cfg.param_dtype)
    d = cfg.d_model
    dr = int(cfg.rglru_expand * d)
    hb = cfg.n_heads  # block-diagonal gate blocks
    dh = dr // hb
    # Lambda so that a = sigmoid(Lambda)^c ~ Uniform(0.9, 0.999)
    u = 0.9 + 0.099 * torch.rand((dr,), generator=gen, device=device)
    uc = u ** (1.0 / _C)
    lam = torch.log(uc / (1 - uc))
    return {
        "w_gelu": L.dense_init(gen, (d, dr), dt, device),
        "w_x": L.dense_init(gen, (d, dr), dt, device),
        "conv": (torch.randn((cfg.rglru_conv_width, dr), generator=gen,
                             device=device) * 0.02).to(dt),
        "w_r": L.dense_init(gen, (hb, dh, dh), dt, device),
        "b_r": torch.zeros((dr,), dtype=dt, device=device),
        "w_i": L.dense_init(gen, (hb, dh, dh), dt, device),
        "b_i": torch.zeros((dr,), dtype=dt, device=device),
        "lam": lam.float(),
        "w_out": L.dense_init(gen, (dr, d), dt, device),
    }


def _blockdiag(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: [..., dr]; w: [H, dh, dh] -> [..., dr]."""
    hb, dh, _ = w.shape
    xs = x.reshape(x.shape[:-1] + (hb, dh))
    y = torch.einsum("...hd,hde->...he", xs, w.to(x.dtype))
    return y.reshape(x.shape)


def _causal_conv(x: torch.Tensor, kernel: torch.Tensor,
                 state: Optional[torch.Tensor]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal temporal conv. x: [B, S, dr]; kernel: [cw, dr].
    state: [B, cw-1, dr] trailing context (zeros at sequence start).
    Returns (y [B, S, dr], new_state)."""
    cw = kernel.shape[0]
    if state is None:
        state = torch.zeros((x.shape[0], cw - 1, x.shape[2]), dtype=x.dtype,
                            device=x.device)
    xp = torch.cat([state.to(x.dtype), x], dim=1)          # [B, S+cw-1, dr]
    s = x.shape[1]
    y = xp[:, 0:s] * kernel[0].to(x.dtype)
    for i in range(1, cw):
        y = y + xp[:, i:i + s] * kernel[i].to(x.dtype)
    # a copy, so the state does not keep the whole padded input alive
    return y, xp[:, xp.shape[1] - (cw - 1):].clone()


def _rg_lru_gates(p: Params, xc: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(a, gated input), both float32."""
    r = torch.sigmoid(_blockdiag(xc, p["w_r"]) + p["b_r"].to(xc.dtype))
    i = torch.sigmoid(_blockdiag(xc, p["w_i"]) + p["b_i"].to(xc.dtype))
    log_a = _C * r.float() * F.logsigmoid(p["lam"].float())
    a = torch.exp(log_a)
    gated = (i.float() * xc.float()
             * torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a),
                                      min=1e-12)))
    return a, gated


def rglru_scan(a: torch.Tensor, b: torch.Tensor,
               h0: Optional[torch.Tensor]) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t over axis 1 (time). a, b: [B, S, dr]
    float32; h0: [B, dr] or None. A carried-in state is folded into
    ``b[:, 0]`` as the reference does, then the scan starts from zero."""
    if h0 is not None:
        b = b.clone()
        b[:, 0] = b[:, 0] + a[:, 0] * h0
    return ops.rglru_linear_scan(a, b)


def rglru_block(p: Params, cfg: ModelConfig, x: torch.Tensor,
                state: Optional[RGLRUState] = None
                ) -> Tuple[torch.Tensor, RGLRUState]:
    """Full-sequence forward. x: [B, S, D] -> (y [B, S, D], final state).
    On CUDA the recurrence is one ``rglru_scan`` launch."""
    x = comm.copy_to_model(x, "rec")
    x1 = F.gelu(x @ p["w_gelu"].to(x.dtype), approximate="tanh")
    x2 = x @ p["w_x"].to(x.dtype)
    conv_state = state.conv if state is not None else None
    xc, new_conv = _causal_conv(x2, p["conv"], conv_state)
    a, gated = _rg_lru_gates(p, xc)
    h0 = state.h if state is not None else None
    h = rglru_scan(a, gated, h0)
    y = comm.reduce_model((h.to(x.dtype) * x1) @ p["w_out"].to(x.dtype),
                          "rec")
    return y, RGLRUState(conv=new_conv, h=h[:, -1].clone())


def rglru_step(p: Params, cfg: ModelConfig, x_t: torch.Tensor,
               state: RGLRUState) -> Tuple[torch.Tensor, RGLRUState]:
    """Single decode step. x_t: [B, D]."""
    x_t = comm.copy_to_model(x_t, "rec")
    x1 = F.gelu(x_t @ p["w_gelu"].to(x_t.dtype), approximate="tanh")
    x2 = x_t @ p["w_x"].to(x_t.dtype)
    window = torch.cat([state.conv.to(x2.dtype), x2[:, None]], dim=1)
    xc = torch.einsum("bcd,cd->bd", window, p["conv"].to(x2.dtype))
    a, gated = _rg_lru_gates(p, xc)
    h = a * state.h.float() + gated
    y = comm.reduce_model((h.to(x_t.dtype) * x1) @ p["w_out"].to(x_t.dtype),
                          "rec")
    return y, RGLRUState(conv=window[:, 1:], h=h)


def init_rglru_state(cfg: ModelConfig, batch: int, dtype=torch.float32,
                     device=None) -> RGLRUState:
    dr = int(cfg.rglru_expand * cfg.d_model)
    return RGLRUState(
        conv=torch.zeros((batch, cfg.rglru_conv_width - 1, dr), dtype=dtype,
                         device=device),
        h=torch.zeros((batch, dr), dtype=torch.float32, device=device),
    )
