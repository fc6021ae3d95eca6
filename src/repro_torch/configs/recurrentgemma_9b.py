"""recurrentgemma-9b [hybrid] — RG-LRU + local attention, 1 attn : 2 recurrent.

[arXiv:2402.19427] (Griffin / RecurrentGemma). 38 layers = 2 RG-LRU stem +
12 x (RG-LRU, RG-LRU, local-attn). MQA (kv=1) on the attention layers,
sliding window 2048. WG-KV applies to the local-attn layers, giving them a
budgeted learned global cache beside a 2048-token ring (the RG-LRU layers
carry recurrent state and need no KV cache).
"""
from repro_torch.configs.base import ModelConfig, WGKVConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    arch_type="hybrid",
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    head_dim=256,  # RecurrentGemma-9B uses 256-dim heads (16*256=4096)
    d_ff=12288,
    vocab_size=256_000,
    block_pattern=("rglru", "rglru", "local_attn"),
    n_repeats=12,
    stem_pattern=("rglru", "rglru"),
    sliding_window=2048,
    rope_theta=10000.0,
    rglru_conv_width=4,
    rglru_expand=1.0,
    source="arXiv:2402.19427",
    wgkv=WGKVConfig(enabled=True, w_local=256, gate_hidden=64),
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        d_model=256,
        n_heads=4,
        n_kv_heads=1,
        head_dim=64,
        d_ff=512,
        vocab_size=512,
        n_repeats=1,
        stem_pattern=(),
        sliding_window=64,
        wgkv=CONFIG.wgkv,
    )
