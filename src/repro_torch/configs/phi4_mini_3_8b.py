"""phi4-mini-3.8b [dense] — RoPE SwiGLU GQA. [arXiv:2412.08905]"""
from repro_torch.configs.base import ModelConfig, WGKVConfig

CONFIG = ModelConfig(
    name="phi4-mini-3.8b",
    arch_type="dense",
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=200_064,
    block_pattern=("attn",),
    n_repeats=32,
    rope_theta=10000.0,
    tie_embeddings=True,
    source="arXiv:2412.08905",
    wgkv=WGKVConfig(enabled=True),
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        d_model=256, n_heads=4, n_kv_heads=2, head_dim=64, d_ff=512,
        vocab_size=512, n_repeats=2,
    )
