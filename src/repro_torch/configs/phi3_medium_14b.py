"""phi3-medium-14b [dense] — RoPE SwiGLU GQA. [arXiv:2404.14219]"""
from repro_torch.configs.base import ModelConfig, WGKVConfig

CONFIG = ModelConfig(
    name="phi3-medium-14b",
    arch_type="dense",
    d_model=5120,
    n_heads=40,
    n_kv_heads=10,
    head_dim=128,
    d_ff=17920,
    vocab_size=100_352,
    block_pattern=("attn",),
    n_repeats=40,
    rope_theta=10000.0,
    tie_embeddings=False,
    source="arXiv:2404.14219",
    wgkv=WGKVConfig(enabled=True),
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        d_model=256, n_heads=4, n_kv_heads=2, head_dim=64, d_ff=512,
        vocab_size=512, n_repeats=2,
    )
