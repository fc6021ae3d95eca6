"""smollm-360m [dense] — llama-arch small. [hf:HuggingFaceTB/SmolLM-135M card]"""
from repro_torch.configs.base import ModelConfig, WGKVConfig

CONFIG = ModelConfig(
    name="smollm-360m",
    arch_type="dense",
    d_model=960,
    n_heads=15,
    n_kv_heads=5,
    head_dim=64,
    d_ff=2560,
    vocab_size=49_152,
    block_pattern=("attn",),
    n_repeats=32,
    rope_theta=10000.0,
    tie_embeddings=True,
    source="hf:HuggingFaceTB/SmolLM-135M",
    wgkv=WGKVConfig(enabled=True),
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        d_model=240, n_heads=3, n_kv_heads=1, head_dim=80, d_ff=512,
        vocab_size=512, n_repeats=2,
    )
