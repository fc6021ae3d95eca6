"""Model registry (port of ``repro/models/registry.py``): analytic
parameter counting and the modality-frontend stubs.

The counting mirrors the reference's arithmetic block type by block type,
so ``ModelConfig.param_count`` answers for every config of the reference,
all ten of which the port registers (``configs/__init__.py``);
``active_only`` counts an ``attn_moe`` block's top-k experts.
:func:`build_vlm_embeds` scatters (stub) patch embeddings into a token
stream with Qwen2-VL's M-RoPE ids, and :func:`whisper_frame_embeds` draws
the (stub) frame embeddings that stand in for whisper's mel-spectrogram
and conv frontend, from a ``torch.Generator``.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.gate import gate_param_count
from repro_torch.device import torch_dtype
from repro_torch.tree import tree_leaves, tree_leaves_with_path


def _block_params(cfg: ModelConfig, bt: str, active_only: bool) -> int:
    d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    norm = 2 * d if cfg.arch_type == "audio" else d  # layernorm has bias

    def attn_p() -> int:
        n = d * hq * hd + 2 * d * hkv * hd + hq * hd * d
        if cfg.qk_norm:
            n += 2 * hd
        if cfg.wgkv.enabled:
            n += gate_param_count(cfg)
        return n

    if bt in ("attn", "local_attn"):
        return 2 * norm + attn_p() + 3 * d * cfg.d_ff
    if bt == "attn_moe":
        mc = cfg.moe
        full = mc.n_experts * 3 * d * mc.expert_d_ff
        act = mc.top_k * 3 * d * mc.expert_d_ff
        return (2 * norm + attn_p() + d * mc.n_experts
                + (act if active_only else full))
    if bt == "attn_cross":
        mlp = 2 * d * cfg.d_ff + cfg.d_ff + d  # gelu mlp with biases
        return 3 * norm + 2 * attn_p() + mlp
    if bt == "enc_attn":
        base = d * hq * hd + 2 * d * hkv * hd + hq * hd * d  # no gate on enc
        mlp = 2 * d * cfg.d_ff + cfg.d_ff + d
        return 2 * norm + base + mlp
    if bt == "rglru":
        dr = int(cfg.rglru_expand * d)
        dh = dr // hq
        rec = (2 * d * dr + cfg.rglru_conv_width * dr
               + 2 * hq * dh * dh + 2 * dr + dr + dr * d)
        return 2 * norm + rec + 3 * d * cfg.d_ff
    if bt == "mlstm":
        dm = int(cfg.xlstm_proj_factor * d)
        return (d + 2 * d * dm + cfg.xlstm_conv_width * dm + 3 * dm * dm
                + 2 * (dm * hq + hq) + dm + dm * d)
    if bt == "slstm":
        dh = d // hq
        dff = int(d * 4 / 3 / 2) * 2
        return (d + d * 4 * d + 4 * hq * dh * dh + 4 * d + d
                + 2 * d * dff + dff * d)
    raise ValueError(bt)


def count_params_analytic(cfg: ModelConfig, active_only: bool = False) -> int:
    """Parameters of ``cfg``'s tree, gates included, from the config
    alone (``active_only``: the top-k experts of each MoE block)."""
    n = cfg.vocab_size * cfg.d_model
    if not cfg.tie_embeddings:
        n += cfg.d_model * cfg.vocab_size
    for bt in cfg.stem_pattern:
        n += _block_params(cfg, bt, active_only)
    for bt in cfg.block_pattern:
        n += cfg.n_repeats * _block_params(cfg, bt, active_only)
    for bt in cfg.enc_block_pattern:
        n += cfg.n_enc_repeats * _block_params(cfg, bt, active_only)
    n += 2 * cfg.d_model if cfg.arch_type == "audio" else cfg.d_model  # ln_f
    if cfg.is_encdec:
        n += 2 * cfg.d_model if cfg.arch_type == "audio" else cfg.d_model
    return n


def count_params_tree(params) -> int:
    """Elements in a parameter tree."""
    return sum(int(x.numel()) for x in tree_leaves(params))


def gate_params_tree(params) -> int:
    """Parameters belonging to Write-Gate MLPs (paper: ~0.4% of total)."""
    return sum(int(x.numel()) for path, x in tree_leaves_with_path(params)
               if "gate" in path)


# ==========================================================================
# modality-frontend stubs
# ==========================================================================
def build_vlm_embeds(params, cfg: ModelConfig, tokens: torch.Tensor,
                     patch_embeds: torch.Tensor, grid_hw: Tuple[int, int]
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """embeds [B, S, D] with the image patches [B, n_img, D] in the
    leading slots, and positions3 [3, B, S] int32: (t, h, w) = (0, row,
    col) over the vision span, then equal text ids from max(gh, gw) on
    (Qwen2-VL's M-RoPE scheme). The token table is read through
    ``transformer.embed_params``, which assembles it on an FSDP mesh."""
    from repro_torch.models import layers as L
    from repro_torch.models.transformer import embed_params

    b, s = tokens.shape
    n_img = patch_embeds.shape[1]
    gh, gw = grid_hw
    if gh * gw != n_img or n_img > s:
        raise ValueError(f"grid {grid_hw} does not give {n_img} patches "
                         f"within {s} tokens")
    dev = tokens.device
    emb = L.embed(embed_params(params), tokens,
                  torch_dtype(cfg.dtype)).clone()
    emb[:, :n_img] = patch_embeds.to(emb.dtype)
    i32 = dict(dtype=torch.int32, device=dev)
    rows = torch.arange(gh, **i32).repeat_interleave(gw)
    cols = torch.arange(gw, **i32).repeat(gh)
    text = torch.arange(s - n_img, **i32) + max(gh, gw)
    pos3 = torch.stack([torch.cat([torch.zeros(n_img, **i32), text]),
                        torch.cat([rows, text]), torch.cat([cols, text])])
    return emb, pos3[:, None].expand(3, b, s)


def whisper_frame_embeds(gen: torch.Generator, cfg: ModelConfig, batch: int,
                         n_frames: int) -> torch.Tensor:
    """STUB for the mel-spectrogram and conv feature extractor: random
    frame embeddings [B, n_frames // enc_seq_divisor, D] (normal, times
    0.1) from ``gen``, on its device, standing in for the conv stack's
    output (its 2x temporal downsample)."""
    s_enc = n_frames // cfg.enc_seq_divisor
    x = torch.randn((batch, s_enc, cfg.d_model), generator=gen,
                    device=gen.device)
    return (x * 0.1).to(torch_dtype(cfg.dtype))
