"""Model registry (port of ``repro/models/registry.py``): analytic
parameter counting.

The counting mirrors the reference's arithmetic block type by block type,
including types whose modules the port has not brought over yet (MoE,
cross/encoder attention, xLSTM), so ``ModelConfig.param_count`` answers
for every config of the reference, the five the port registers
(``configs/__init__.py``) among them. The VLM patch and whisper frame
embedding helpers wait for their slice (ROADMAP.md Queue 1 item 7c).
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.core.gate import gate_param_count
from repro_torch.tree import tree_leaves


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
