"""qwen3-moe-235b-a22b [moe] — 128 experts, top-8. [hf:Qwen/Qwen3-30B-A3B card]

d_ff=1536 is the per-expert FFN width; every layer is attn + MoE FFN.
"""
from repro_torch.configs.base import MoEConfig, ModelConfig, WGKVConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    arch_type="moe",
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    head_dim=128,
    d_ff=1536,  # per-expert
    vocab_size=151_936,
    block_pattern=("attn_moe",),
    n_repeats=94,
    qk_norm=True,
    rope_theta=1_000_000.0,
    tie_embeddings=False,
    moe=MoEConfig(n_experts=128, top_k=8, expert_d_ff=1536),
    source="hf:Qwen/Qwen3-30B-A3B",
    wgkv=WGKVConfig(enabled=True),
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        d_model=256, n_heads=4, n_kv_heads=2, head_dim=64, d_ff=128,
        vocab_size=512, n_repeats=2,
        moe=MoEConfig(n_experts=4, top_k=2, expert_d_ff=128),
    )
