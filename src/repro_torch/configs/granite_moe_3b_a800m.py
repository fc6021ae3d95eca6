"""granite-moe-3b-a800m [moe] — 40 experts, top-8, per-expert d_ff=512.

[hf:ibm-granite/granite-3.0-1b-a400m-base family card]
"""
from repro_torch.configs.base import MoEConfig, ModelConfig, WGKVConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    arch_type="moe",
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    head_dim=64,
    d_ff=512,  # per-expert
    vocab_size=49_155,
    block_pattern=("attn_moe",),
    n_repeats=32,
    rope_theta=10000.0,
    tie_embeddings=True,
    moe=MoEConfig(n_experts=40, top_k=8, expert_d_ff=512),
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
    wgkv=WGKVConfig(enabled=True),
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        d_model=256, n_heads=4, n_kv_heads=2, head_dim=64, d_ff=128,
        vocab_size=512, n_repeats=2,
        moe=MoEConfig(n_experts=4, top_k=2, expert_d_ff=128),
    )
