"""The model's parameter tree, init and full-sequence forward (port of
``repro/models/transformer.py``).

The tree mirrors the reference's, so weights carry across by path
(:mod:`repro_torch.convert`): ``{"embed": {"tok"}, "stem": (block, ...),
"blocks": {"b0": ...}, "ln_f": {...}, "enc": {"blocks", "ln_f"}}`` with
every block leaf stacked on a leading ``n_repeats`` axis (the encoder's
on ``n_enc_repeats``), the stem (only when the config has one) a tuple
of unstacked blocks run before the repeats, and the encoder only for an
encoder-decoder config. Norms are RMSNorm, or LayerNorm (scale and bias)
for ``arch_type == "audio"``.

Block types: ``"attn"`` / ``"local_attn"`` (GQA self-attention with the
write gate, SwiGLU FFN), ``"attn_moe"`` (the same attention, the
Mixture-of-Experts FFN of :mod:`repro_torch.models.moe`; its
load-balance loss is summed into ``ForwardResult.lb_loss``), ``"rglru"``
(the RG-LRU recurrence), ``"mlstm"`` / ``"slstm"`` (xLSTM blocks with
their own projections, :mod:`repro_torch.models.xlstm`),
``"attn_cross"`` (whisper's decoder block: self-attention, cross
attention over the encoder output, a GELU MLP) and ``"enc_attn"`` (the
encoder's bidirectional block).

:func:`forward` is the training / teacher / hard-eval forward
(``mode="teacher" | "gated" | "hard"``) over tokens or ``embeds`` (a VLM
stream), with M-RoPE ``positions`` [3, B, S] and, for the
encoder-decoder, ``enc_embeds``; on CUDA its gated mode runs the
``gated_flash`` kernel in every self-attention layer and every
``"rglru"`` block runs its recurrence through the ``rglru_scan`` kernel.
"""
from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ATTN_BLOCKS, ModelConfig
from repro_torch.device import DeviceLike, resolve_device, torch_dtype
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as MoE
from repro_torch.models import rglru as RG
from repro_torch.models import xlstm as XL
from repro_torch.sharding import comm
from repro_torch.tree import tree_leaves, tree_map

Params = Dict[str, Any]

def _norm_init(cfg: ModelConfig, dt, device):
    if cfg.arch_type == "audio":
        return L.init_layernorm(cfg.d_model, dt, device)
    return L.init_rmsnorm(cfg.d_model, dt, device)


def _norm(cfg: ModelConfig, p, x):
    """The reference's norm choice: LayerNorm for audio, else RMSNorm."""
    if cfg.arch_type == "audio":
        return L.layernorm(p, x)
    return L.rmsnorm(p, x)


def init_block(gen: torch.Generator, cfg: ModelConfig, bt: str,
               device) -> Params:
    """One block, its leaves in the reference's tree (module docstring).
    The draws come from ``gen`` in the tree's order; they differ from the
    reference's ``jax.random`` init."""
    dt = torch_dtype(cfg.param_dtype)
    d = cfg.d_model
    if bt == "mlstm":
        return {"cell": XL.init_mlstm(gen, cfg, device)}
    if bt == "slstm":
        return {"cell": XL.init_slstm(gen, cfg, device)}
    if bt == "attn_cross":
        return {
            "ln1": _norm_init(cfg, dt, device),
            "attn": A.init_attention(gen, cfg, device, kind="self"),
            "ln_x": _norm_init(cfg, dt, device),
            "xattn": A.init_attention(gen, cfg, device, kind="cross",
                                      with_gate=cfg.wgkv.enabled),
            "ln2": _norm_init(cfg, dt, device),
            "mlp": L.init_gelu_mlp(gen, d, cfg.d_ff, dt, device),
        }
    if bt == "enc_attn":
        return {
            "ln1": _norm_init(cfg, dt, device),
            "attn": A.init_attention(gen, cfg, device, kind="enc"),
            "ln2": _norm_init(cfg, dt, device),
            "mlp": L.init_gelu_mlp(gen, d, cfg.d_ff, dt, device),
        }
    if bt in ("attn", "local_attn", "attn_moe"):
        mixer = {"attn": A.init_attention(gen, cfg, device)}
    elif bt == "rglru":
        mixer = {"rec": RG.init_rglru(gen, cfg, device)}
    else:
        raise ValueError(f"unknown block type {bt!r}")
    if bt == "attn_moe":
        mlp = {"moe": MoE.init_moe(gen, cfg, device)}
    else:
        mlp = {"mlp": L.init_swiglu(gen, d, cfg.d_ff, dt, device)}
    return {
        "ln1": _norm_init(cfg, dt, device),
        **mixer,
        "ln2": _norm_init(cfg, dt, device),
        **mlp,
    }


def ffn(p: Params, cfg: ModelConfig, bt: str, x: torch.Tensor, *,
        moe_groups: int = 1) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """A block's FFN behind its second norm -> (the residual's increment,
    an ``"attn_moe"`` block's load-balance loss, else None)."""
    xin = _norm(cfg, p["ln2"], x)
    if bt == "attn_moe":
        y, aux = MoE.moe_ffn(p["moe"], cfg, xin, groups=moe_groups)
        return y, aux["lb_loss"]
    if bt in ("attn_cross", "enc_attn") or cfg.arch_type == "audio":
        return L.gelu_mlp(p["mlp"], xin), None
    return L.swiglu(p["mlp"], xin), None


def init_model(cfg: ModelConfig, generator: torch.Generator,
               device: DeviceLike = None) -> Params:
    """Random parameters drawn from ``generator`` on ``device`` (default
    ``cuda``). The generator must live on that device. The draws differ
    from the reference's ``jax.random`` init; to compare the two
    packages, carry the reference's weights over with
    :func:`repro_torch.convert.params_from_numpy`."""
    dev = resolve_device(device)
    dt = torch_dtype(cfg.param_dtype)
    params: Params = {"embed": L.init_embedding(generator, cfg, dev)}
    if cfg.stem_pattern:
        params["stem"] = tuple(init_block(generator, cfg, bt, dev)
                               for bt in cfg.stem_pattern)
    params["blocks"] = _init_stack(generator, cfg, cfg.block_pattern,
                                   cfg.n_repeats, dev)
    params["ln_f"] = _norm_init(cfg, dt, dev)
    if cfg.is_encdec:
        params["enc"] = {
            "blocks": _init_stack(generator, cfg, cfg.enc_block_pattern,
                                  cfg.n_enc_repeats, dev),
            "ln_f": _norm_init(cfg, dt, dev)}
    return params


def _init_stack(generator: torch.Generator, cfg: ModelConfig, pattern,
                repeats: int, dev) -> Params:
    """``repeats`` copies of ``pattern`` stacked leaf by leaf. Each
    repeat's draws go straight into the stacked leaves, so the peak is
    the model and one repeat (phi3-medium-14b: 54.6 GiB in f32), not
    twice the model."""
    blocks = None
    for r in range(repeats):
        layer = {f"b{i}": init_block(generator, cfg, bt, dev)
                 for i, bt in enumerate(pattern)}
        if blocks is None:
            blocks = tree_map(
                lambda x: x.new_empty((repeats,) + tuple(x.shape)), layer)
        tree_map(lambda dst, x: dst[r].copy_(x), blocks, layer)
    return blocks


def stem_params(params: Params) -> Tuple[Params, ...]:
    """The stem blocks, in order (empty without a stem)."""
    return tuple(params.get("stem", ()))


def unstack(tree) -> List[Any]:
    """A tree whose leaves are stacked on a leading axis -> one tree per
    entry of that axis (one ``unbind`` per leaf, not one index op per leaf
    and entry)."""
    cols = [x.unbind(0) for x in tree_leaves(tree)]
    out = []
    for r in range(len(cols[0])):
        it = iter([c[r] for c in cols])
        out.append(tree_map(lambda _x, it=it: next(it), tree))
    return out


def layer_params(params: Params, cfg: ModelConfig) -> List[Params]:
    """Per-layer views of the stacked block tree: ``[r]`` -> {"b0": ...}."""
    return unstack(params["blocks"])


# ==========================================================================
# full-sequence forward (teacher / write-gated / hard eval)
# ==========================================================================
class BlockAux(NamedTuple):
    gates: Optional[torch.Tensor]   # [1, B, Hkv, S] or None
    lb_loss: torch.Tensor


def block_forward(p: Params, cfg: ModelConfig, bt: str, x: torch.Tensor,
                  positions: torch.Tensor, *, mode: str,
                  enc_out: Optional[torch.Tensor] = None,
                  q_chunk: Optional[int] = None, moe_groups: int = 1,
                  gate_override: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, BlockAux]:
    """One block. mode: "teacher" | "gated" | "hard". ``gate_override``:
    [B, Hkv, S] static admission scores replacing the learned gate.
    ``local_attn`` blocks attend within ``cfg.sliding_window`` (which is
    also their W in the gate bias). An ``attn_moe`` block routes its
    ``B * S`` tokens in ``moe_groups`` groups and returns its
    load-balance loss. An ``attn_cross`` block attends to all of
    ``enc_out`` [B, S_enc, D] (no budget in training, as the
    reference)."""
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    if bt in ATTN_BLOCKS:
        gate_mode = {"teacher": "off", "gated": "gated", "hard": "hard"}[mode]
        window = cfg.sliding_window if bt == "local_attn" else None
        h, g = A.attn_train(p["attn"], cfg, _norm(cfg, p["ln1"], x),
                            positions, gate_mode=gate_mode, window=window,
                            q_chunk=q_chunk, gate_override=gate_override)
        x = x + h
        if bt == "attn_cross":
            cc = A.build_cross_cache(p["xattn"], cfg, enc_out)
            x = x + A.attn_cross(p["xattn"], cfg, _norm(cfg, p["ln_x"], x),
                                 cc)
        y, lb = ffn(p, cfg, bt, x, moe_groups=moe_groups)
        return x + y, BlockAux(None if g is None else g[None],
                               zero if lb is None else lb)
    if bt == "enc_attn":
        x = x + A.attn_encoder(p["attn"], cfg, _norm(cfg, p["ln1"], x))
        y, _ = ffn(p, cfg, bt, x)
        return x + y, BlockAux(None, zero)
    if bt == "rglru":
        y, _ = RG.rglru_block(p["rec"], cfg, _norm(cfg, p["ln1"], x))
        x = x + y
        x = x + L.swiglu(p["mlp"], _norm(cfg, p["ln2"], x))
        return x, BlockAux(None, zero)
    if bt == "mlstm":
        x, _ = XL.mlstm_auto(p["cell"], cfg, x)
        return x, BlockAux(None, zero)
    if bt == "slstm":
        x, _ = XL.slstm_block(p["cell"], cfg, x)
        return x, BlockAux(None, zero)
    raise ValueError(f"unknown block type {bt!r}")


def encode(params: Params, cfg: ModelConfig,
           enc_embeds: torch.Tensor) -> torch.Tensor:
    """The whisper encoder over precomputed (stub) frame embeddings
    [B, S_enc, D]: sinusoidal positions, the encoder blocks, its final
    norm. On an FSDP mesh each block's leaves are assembled just before
    it runs (:func:`gathered_block`), as the decoder's are."""
    s = enc_embeds.shape[1]
    x = enc_embeds + L.sinusoidal_positions(
        s, cfg.d_model, enc_embeds.device)[None].to(enc_embeds.dtype)
    zero = torch.zeros((1, 1), dtype=torch.int32, device=x.device)
    enc = params["enc"]
    for lp in unstack(enc["blocks"]):
        for i, bt in enumerate(cfg.enc_block_pattern):
            x, _ = gathered_block(lp[f"b{i}"], ("enc", "blocks", f"b{i}"),
                                  True, cfg, bt, x, zero, mode="teacher")
    return _norm(cfg, comm.gather_params(enc["ln_f"], ("enc", "ln_f")), x)


def embed_inputs(params: Params, cfg: ModelConfig,
                 tokens: Optional[torch.Tensor],
                 embeds: Optional[torch.Tensor],
                 enc_embeds: Optional[torch.Tensor]):
    """The decoder stream [B, S, D] (token embeddings, or ``embeds`` as
    given: a VLM stream) and the encoder output (None without an encoder;
    the decoder stream then carries whisper's sinusoidal positions)."""
    dt = torch_dtype(cfg.dtype)
    x = (L.embed(embed_params(params), tokens, dt) if embeds is None
         else embeds.to(dt))
    enc_out = None
    if cfg.is_encdec:
        if enc_embeds is None:
            raise ValueError(f"{cfg.name} is an encoder-decoder: pass "
                             "enc_embeds")
        enc_out = encode(params, cfg, enc_embeds.to(dt))
        x = x + L.sinusoidal_positions(x.shape[1], cfg.d_model,
                                       x.device)[None].to(dt)
    return x, enc_out


def embed_params(params: Params) -> Params:
    """The embedding's table as :func:`repro_torch.models.layers.embed`
    takes it; on an FSDP mesh assembled from its "data" blocks for this
    one use."""
    return comm.gather_params({"tok": params["embed"]["tok"]}, ("embed",))


def unembed_params(params: Params) -> Params:
    """The unembedding's leaf (``unembed``, or the tied ``tok``) as
    :func:`repro_torch.models.layers.unembed` takes it, assembled as
    :func:`embed_params`'."""
    e = params["embed"]
    key = "unembed" if "unembed" in e else "tok"
    return comm.gather_params({key: e[key]}, ("embed",))


def gathered_block(p: Params, prefix: Tuple[str, ...], stacked: bool,
                   cfg: ModelConfig, bt: str, x: torch.Tensor,
                   positions: torch.Tensor, **kw
                   ) -> Tuple[torch.Tensor, BlockAux]:
    """:func:`block_forward` of the block whose params are ``p`` (at
    ``prefix`` in the tree; ``stacked``: one repeat's view): on an FSDP
    mesh its leaves are assembled just before it runs and dropped after
    it (under ``remat`` the recompute assembles them again)."""
    return block_forward(comm.gather_params(p, prefix, stacked), cfg, bt,
                         x, positions, **kw)


class ForwardResult(NamedTuple):
    logits: torch.Tensor              # [B, S, V] (a 0-d zero without logits)
    hidden: torch.Tensor              # final-layer hidden states [B, S, D]
    gates: Optional[torch.Tensor]     # [L_attn, B, Hkv, S]
    lb_loss: torch.Tensor


def forward(params: Params, cfg: ModelConfig,
            tokens: Optional[torch.Tensor] = None, *,
            positions: Optional[torch.Tensor] = None, mode: str = "teacher",
            embeds: Optional[torch.Tensor] = None,
            enc_embeds: Optional[torch.Tensor] = None,
            q_chunk: Optional[int] = None, with_logits: bool = True,
            remat: bool = False, moe_groups: int = 1,
            gate_override: Optional[torch.Tensor] = None) -> ForwardResult:
    """Full-sequence forward: the stem blocks, then the repeats. tokens:
    [B, S] int, or ``embeds`` [B, S, D] (a VLM stream,
    ``registry.build_vlm_embeds``); positions: [B, S] (default 0..S-1)
    or [3, B, S] (M-RoPE); ``enc_embeds`` [B, S_enc, D]: the
    encoder-decoder's frame embeddings (``registry.whisper_frame_embeds``),
    encoded once and attended by every ``attn_cross`` block. gate_override:
    [L_attn, B, Hkv, S] (one per attention layer, stem layers first) or
    [B, Hkv, S] (one policy for every attention layer). Gates come back
    [L_attn, B, Hkv, S] in the same order. ``remat``: each repeated block
    runs under ``torch.utils.checkpoint`` (non-reentrant), so its
    activations are recomputed in the backward instead of kept, as the
    reference's ``jax.checkpoint`` of its scan body; the stem is not
    rematerialized there either. ``moe_groups``: the routing groups of
    every ``attn_moe`` block; ``lb_loss`` is the sum of their load-balance
    losses over the stem and the repeats (0 without MoE blocks). On an
    FSDP mesh (``sharding.comm.gather_params``) each block's leaves are
    assembled just before it runs."""
    x, enc_out = embed_inputs(params, cfg, tokens, embeds, enc_embeds)
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32,
                                 device=x.device)[None].expand(b, s)
    layers = ([(bt, p, ("stem", str(j)), False, False)
               for j, (bt, p) in enumerate(zip(cfg.stem_pattern,
                                               stem_params(params)))]
              + [(bt, lp[f"b{i}"], ("blocks", f"b{i}"), True, remat)
                 for lp in layer_params(params, cfg)
                 for i, bt in enumerate(cfg.block_pattern)])
    n_attn = sum(1 for bt, *_ in layers if bt in ATTN_BLOCKS)
    overrides: List[Optional[torch.Tensor]] = [None] * n_attn
    if gate_override is not None:
        overrides = (list(gate_override.unbind(0)) if gate_override.ndim == 4
                     else [gate_override] * n_attn)
    gates = []
    lb_total = torch.zeros((), dtype=torch.float32, device=x.device)
    ai = 0
    for bt, p, prefix, stacked, ckpt in layers:
        ov = None
        if bt in ATTN_BLOCKS:
            ov = overrides[ai]
            ai += 1
        kw = dict(mode=mode, enc_out=enc_out, q_chunk=q_chunk,
                  moe_groups=moe_groups, gate_override=ov)
        if ckpt:
            x, aux = checkpoint(gathered_block, p, prefix, stacked, cfg, bt,
                                x, positions, use_reentrant=False, **kw)
        else:
            x, aux = gathered_block(p, prefix, stacked, cfg, bt, x,
                                    positions, **kw)
        if aux.gates is not None:
            gates.append(aux.gates)
        lb_total = lb_total + aux.lb_loss
    out_gates = None
    if mode != "teacher" and cfg.wgkv.enabled and gates:
        out_gates = torch.cat(gates, dim=0)
    hidden = _norm(cfg, params["ln_f"], x)
    logits = (L.unembed(unembed_params(params), hidden) if with_logits
              else torch.zeros((), dtype=torch.float32, device=x.device))
    return ForwardResult(logits, hidden, out_gates, lb_total)
