"""whisper-medium [audio] — encoder-decoder, conv frontend STUB.

[arXiv:2212.04356]. 24 encoder + 24 decoder layers, MHA (kv=16=H),
sinusoidal positions. The mel-spectrogram + conv feature extractor is a
stub: ``input_specs()`` provides precomputed frame embeddings of shape
[B, seq_len // 2, d_model] (the conv stack's 2x temporal downsample).
Decoder blocks are self-attn + cross-attn + FFN; WG-KV applies to decoder
self-attention (and optionally to cross-attn KV as learned encoder-memory
pruning). ``long_500k`` is skipped for this arch (DESIGN.md §4).
"""
from repro_torch.configs.base import ModelConfig, WGKVConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    arch_type="audio",
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=51_865,
    block_pattern=("attn_cross",),
    n_repeats=24,
    enc_block_pattern=("enc_attn",),
    n_enc_repeats=24,
    enc_seq_divisor=2,
    dec_max_len=448,
    rope_theta=0.0,  # sinusoidal absolute positions, no RoPE
    tie_embeddings=True,
    source="arXiv:2212.04356",
    # w_local=64 divides the 448-token decoder prompt (whisper's max)
    wgkv=WGKVConfig(enabled=True, w_local=64),
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        d_model=256, n_heads=4, n_kv_heads=4, head_dim=64, d_ff=512,
        vocab_size=512, n_repeats=2, n_enc_repeats=2, dec_max_len=64,
    )
