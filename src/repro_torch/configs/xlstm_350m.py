"""xlstm-350m [ssm] — alternating mLSTM / sLSTM blocks.

[arXiv:2405.04517]. 24 layers = 12 x (mLSTM, sLSTM). d_ff=0: xLSTM blocks
carry their own up/down projections (proj factor 2). No attention KV cache
=> WG-KV inapplicable (noted in DESIGN.md §4); the arch runs with its native
O(1) recurrent state.
"""
from repro_torch.configs.base import ModelConfig, WGKVConfig

CONFIG = ModelConfig(
    name="xlstm-350m",
    arch_type="ssm",
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    head_dim=256,
    d_ff=0,
    vocab_size=50_304,
    block_pattern=("mlstm", "slstm"),
    n_repeats=12,
    xlstm_proj_factor=2.0,
    xlstm_conv_width=4,
    source="arXiv:2405.04517",
    wgkv=WGKVConfig(enabled=False),  # inapplicable: no KV cache
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        d_model=256,
        n_heads=2,
        n_kv_heads=2,
        head_dim=128,
        vocab_size=512,
        n_repeats=1,
    )
