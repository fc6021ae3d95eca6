"""qwen2-vl-7b [vlm] — M-RoPE, dynamic resolution. [arXiv:2409.12191]

Transformer backbone only; the ViT vision encoder + projector is a STUB —
``input_specs()`` provides precomputed patch embeddings of shape
[B, n_img_tokens, d_model] that are scattered into the token stream, plus
3D (t, h, w) M-RoPE position ids.
"""
from repro_torch.configs.base import ModelConfig, WGKVConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b",
    arch_type="vlm",
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    head_dim=128,
    d_ff=18944,
    vocab_size=152_064,
    block_pattern=("attn",),
    n_repeats=28,
    mrope=True,
    rope_theta=1_000_000.0,
    tie_embeddings=False,
    source="arXiv:2409.12191",
    wgkv=WGKVConfig(enabled=True),
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        d_model=256, n_heads=4, n_kv_heads=2, head_dim=64, d_ff=512,
        vocab_size=512, n_repeats=2,
    )
