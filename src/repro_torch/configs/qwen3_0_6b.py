"""qwen3-0.6b [dense] — qk_norm, GQA. [hf:Qwen/Qwen3-8B family card]

Qwen3 uses per-head RMSNorm on q and k (qk_norm) and 128-dim heads
decoupled from d_model (16 * 128 = 2048 != 1024).
"""
from repro_torch.configs.base import ModelConfig, WGKVConfig

CONFIG = ModelConfig(
    name="qwen3-0.6b",
    arch_type="dense",
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=3072,
    vocab_size=151_936,
    block_pattern=("attn",),
    n_repeats=28,
    qk_norm=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    source="hf:Qwen/Qwen3-8B",
    wgkv=WGKVConfig(enabled=True),
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        d_model=256, n_heads=4, n_kv_heads=2, head_dim=64, d_ff=512,
        vocab_size=512, n_repeats=2,
    )
