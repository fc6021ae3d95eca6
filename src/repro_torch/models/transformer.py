"""The decoder's parameter tree, init and full-sequence forward (port of
``repro/models/transformer.py`` for RMSNorm decoders whose blocks are
``"attn"``, ``"local_attn"`` or ``"rglru"``).

The tree mirrors the reference's, so weights carry across by path
(:mod:`repro_torch.convert`): ``{"embed": {"tok"}, "stem": (block, ...),
"blocks": {"b0": ...}, "ln_f": {"scale"}}`` with every block leaf stacked
on a leading ``n_repeats`` axis and the stem (only when the config has
one) a tuple of unstacked blocks run before the repeats.

:func:`forward` is the training / teacher / hard-eval forward
(``mode="teacher" | "gated" | "hard"``); on CUDA its gated mode runs the
``gated_flash`` kernel in every attention layer and every ``"rglru"``
block runs its recurrence through the ``rglru_scan`` kernel.
"""
from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ATTN_BLOCKS, ModelConfig
from repro_torch.device import DeviceLike, resolve_device, torch_dtype
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import rglru as RG
from repro_torch.tree import tree_leaves, tree_map

Params = Dict[str, Any]

# block types the port runs; the attention ones carry a dual cache
PORTED_BLOCKS = ("attn", "local_attn", "rglru")


def _norm(cfg: ModelConfig, p, x):
    """The reference's norm choice for the ported archs: RMSNorm."""
    return L.rmsnorm(p, x)


def _check_supported(cfg: ModelConfig) -> None:
    unported = [bt for bt in cfg.stem_pattern + cfg.block_pattern
                if bt not in PORTED_BLOCKS]
    if cfg.is_encdec or cfg.mrope or cfg.arch_type == "audio" or unported:
        raise NotImplementedError(
            f"{cfg.name}: repro_torch ports RMSNorm decoders of "
            f"{PORTED_BLOCKS} blocks only (pattern {cfg.block_pattern}, "
            f"stem {cfg.stem_pattern})")


def init_block(gen: torch.Generator, cfg: ModelConfig, bt: str,
               device) -> Params:
    """One block: ``"attn"`` / ``"local_attn"`` is GQA self-attention (with
    the write gate) and a SwiGLU FFN, ``"rglru"`` the temporal conv +
    RG-LRU recurrence and a SwiGLU FFN, each behind an RMSNorm."""
    dt = torch_dtype(cfg.param_dtype)
    if bt in ("attn", "local_attn"):
        mixer = {"attn": A.init_attention(gen, cfg, device)}
    elif bt == "rglru":
        mixer = {"rec": RG.init_rglru(gen, cfg, device)}
    else:
        raise NotImplementedError(f"block type {bt!r} is not ported")
    return {
        "ln1": L.init_rmsnorm(cfg.d_model, dt, device),
        **mixer,
        "ln2": L.init_rmsnorm(cfg.d_model, dt, device),
        "mlp": L.init_swiglu(gen, cfg.d_model, cfg.d_ff, dt, device),
    }


def init_model(cfg: ModelConfig, generator: torch.Generator,
               device: DeviceLike = None) -> Params:
    """Random parameters drawn from ``generator`` on ``device`` (default
    ``cuda``). The generator must live on that device. The draws differ
    from the reference's ``jax.random`` init; to compare the two
    packages, carry the reference's weights over with
    :func:`repro_torch.convert.params_from_numpy`."""
    _check_supported(cfg)
    dev = resolve_device(device)
    dt = torch_dtype(cfg.param_dtype)
    params: Params = {"embed": L.init_embedding(generator, cfg, dev)}
    if cfg.stem_pattern:
        params["stem"] = tuple(init_block(generator, cfg, bt, dev)
                               for bt in cfg.stem_pattern)
    # each repeat's draws go straight into the stacked leaves, so the peak
    # is the model and one repeat (phi3-medium-14b: 54.6 GiB in f32), not
    # twice the model
    blocks = None
    for r in range(cfg.n_repeats):
        layer = {f"b{i}": init_block(generator, cfg, bt, dev)
                 for i, bt in enumerate(cfg.block_pattern)}
        if blocks is None:
            blocks = tree_map(
                lambda x: x.new_empty((cfg.n_repeats,) + tuple(x.shape)),
                layer)
        tree_map(lambda dst, x: dst[r].copy_(x), blocks, layer)
    params["blocks"] = blocks
    params["ln_f"] = L.init_rmsnorm(cfg.d_model, dt, dev)
    return params


def stem_params(params: Params) -> Tuple[Params, ...]:
    """The stem blocks, in order (empty without a stem)."""
    return tuple(params.get("stem", ()))


def layer_params(params: Params, cfg: ModelConfig) -> List[Params]:
    """Per-layer views of the stacked block tree: ``[r]`` -> {"b0": ...}
    (one ``unbind`` per leaf, not one index op per leaf and layer)."""
    cols = [x.unbind(0) for x in tree_leaves(params["blocks"])]
    out = []
    for r in range(cfg.n_repeats):
        it = iter([c[r] for c in cols])
        out.append(tree_map(lambda _x, it=it: next(it), params["blocks"]))
    return out


# ==========================================================================
# full-sequence forward (teacher / write-gated / hard eval)
# ==========================================================================
class BlockAux(NamedTuple):
    gates: Optional[torch.Tensor]   # [1, B, Hkv, S] or None
    lb_loss: torch.Tensor


def block_forward(p: Params, cfg: ModelConfig, bt: str, x: torch.Tensor,
                  positions: torch.Tensor, *, mode: str,
                  q_chunk: Optional[int] = None,
                  gate_override: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, BlockAux]:
    """One block. mode: "teacher" | "gated" | "hard". ``gate_override``:
    [B, Hkv, S] static admission scores replacing the learned gate.
    ``local_attn`` blocks attend within ``cfg.sliding_window`` (which is
    also their W in the gate bias)."""
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    if bt in ("attn", "local_attn"):
        gate_mode = {"teacher": "off", "gated": "gated", "hard": "hard"}[mode]
        window = cfg.sliding_window if bt == "local_attn" else None
        h, g = A.attn_train(p["attn"], cfg, _norm(cfg, p["ln1"], x),
                            positions, gate_mode=gate_mode, window=window,
                            q_chunk=q_chunk, gate_override=gate_override)
        x = x + h
        x = x + L.swiglu(p["mlp"], _norm(cfg, p["ln2"], x))
        return x, BlockAux(None if g is None else g[None], zero)
    if bt == "rglru":
        y, _ = RG.rglru_block(p["rec"], cfg, _norm(cfg, p["ln1"], x))
        x = x + y
        x = x + L.swiglu(p["mlp"], _norm(cfg, p["ln2"], x))
        return x, BlockAux(None, zero)
    raise NotImplementedError(f"block type {bt!r} is not ported")


class ForwardResult(NamedTuple):
    logits: torch.Tensor              # [B, S, V] (a 0-d zero without logits)
    hidden: torch.Tensor              # final-layer hidden states [B, S, D]
    gates: Optional[torch.Tensor]     # [L_attn, B, Hkv, S]
    lb_loss: torch.Tensor


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor, *,
            positions: Optional[torch.Tensor] = None, mode: str = "teacher",
            q_chunk: Optional[int] = None, with_logits: bool = True,
            remat: bool = False,
            gate_override: Optional[torch.Tensor] = None) -> ForwardResult:
    """Full-sequence forward: the stem blocks, then the repeats. tokens:
    [B, S] int; positions: [B, S] (default 0..S-1). gate_override:
    [L_attn, B, Hkv, S] (one per attention layer, stem layers first) or
    [B, Hkv, S] (one policy for every attention layer). Gates come back
    [L_attn, B, Hkv, S] in the same order. ``remat``: each repeated block
    runs under ``torch.utils.checkpoint`` (non-reentrant), so its
    activations are recomputed in the backward instead of kept, as the
    reference's ``jax.checkpoint`` of its scan body; the stem is not
    rematerialized there either."""
    _check_supported(cfg)
    dt = torch_dtype(cfg.dtype)
    x = L.embed(params["embed"], tokens, dt)
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32,
                                 device=x.device)[None].expand(b, s)
    layers = ([(bt, p, False) for bt, p in zip(cfg.stem_pattern,
                                               stem_params(params))]
              + [(bt, lp[f"b{i}"], remat)
                 for lp in layer_params(params, cfg)
                 for i, bt in enumerate(cfg.block_pattern)])
    n_attn = sum(1 for bt, _, _ in layers if bt in ATTN_BLOCKS)
    overrides: List[Optional[torch.Tensor]] = [None] * n_attn
    if gate_override is not None:
        overrides = (list(gate_override.unbind(0)) if gate_override.ndim == 4
                     else [gate_override] * n_attn)
    gates = []
    lb_total = torch.zeros((), dtype=torch.float32, device=x.device)
    ai = 0
    for bt, p, ckpt in layers:
        ov = None
        if bt in ATTN_BLOCKS:
            ov = overrides[ai]
            ai += 1
        if ckpt:
            x, aux = checkpoint(block_forward, p, cfg, bt, x, positions,
                                mode=mode, q_chunk=q_chunk, gate_override=ov,
                                use_reentrant=False)
        else:
            x, aux = block_forward(p, cfg, bt, x, positions, mode=mode,
                                   q_chunk=q_chunk, gate_override=ov)
        if aux.gates is not None:
            gates.append(aux.gates)
        lb_total = lb_total + aux.lb_loss
    out_gates = None
    if mode != "teacher" and cfg.wgkv.enabled and gates:
        out_gates = torch.cat(gates, dim=0)
    hidden = _norm(cfg, params["ln_f"], x)
    logits = (L.unembed(params["embed"], hidden) if with_logits
              else torch.zeros((), dtype=torch.float32, device=x.device))
    return ForwardResult(logits, hidden, out_gates, lb_total)
