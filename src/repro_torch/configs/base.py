"""Config dataclasses for the WG-KV framework.

Every assigned architecture gets a module in this package exporting
``CONFIG`` (the full production config, exact numbers from the assignment
table) and ``reduced()`` (a CPU-smoke-testable variant of the same family:
<=2 pattern super-blocks, d_model<=512, <=4 experts).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class WGKVConfig:
    """Write-Gated KV (the paper's technique) hyper-parameters."""

    enabled: bool = True
    # Sliding local window (ring buffer size); paper uses 256 for training
    # alignment and the local cache.
    w_local: int = 256
    # Binarization threshold tau (paper: 0.1).
    tau: float = 0.1
    # Hidden width of the Write-Gate MLP.
    gate_hidden: int = 64
    # Global-cache capacity as a fraction of max sequence length. The paper
    # reports 46-68% memory reduction at 75% sparsity; a 0.25 budget is the
    # matching operating point.
    global_budget_frac: float = 0.25
    # epsilon used inside log(m + eps) for the log-space bias.
    log_eps: float = 1e-6
    # sparsity-loss weight (lambda); swept by benchmarks.
    lam: float = 0.08
    # number of attention-sink tokens always admitted (StreamingLLM-style;
    # used by baselines and as a safety floor for WG-KV).
    sink: int = 16

    def global_budget(self, seq_len: int) -> int:
        b = int(seq_len * self.global_budget_frac)
        return max(16, min(b, seq_len))


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0
    top_k: int = 0
    expert_d_ff: int = 0
    # shared dense ffn alongside experts (0 = none)
    shared_d_ff: int = 0
    # capacity factor for fixed-shape dispatch
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01


# block types that carry a decoder-side KV cache
ATTN_BLOCKS = ("attn", "attn_moe", "local_attn", "attn_cross")


@dataclass(frozen=True)
class ModelConfig:
    """Architecture description.

    ``block_pattern`` lists the block types of one *pattern super-block*;
    the model is ``n_repeats`` copies of that pattern (scan-over-superblocks)
    plus optional non-repeated stem/head. Block types:
      "attn"   — GQA self-attention + dense FFN (SwiGLU)
      "attn_moe" — GQA self-attention + MoE FFN
      "local_attn" — sliding-window GQA attention + dense FFN
      "rglru"  — Griffin recurrent block (temporal conv + RG-LRU) + FFN
      "mlstm"  — xLSTM matrix-memory block (self-contained projections)
      "slstm"  — xLSTM scalar-memory block (self-contained projections)
    """

    name: str
    arch_type: str  # dense | moe | ssm | hybrid | vlm | audio
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    block_pattern: Tuple[str, ...]
    n_repeats: int
    # extra non-repeated blocks placed before the scanned repeats (used to
    # hit exact layer counts when n_layers % len(pattern) != 0, e.g.
    # recurrentgemma's 38 = 2 + 12*3).
    stem_pattern: Tuple[str, ...] = ()
    head_dim: int = 0  # 0 => d_model // n_heads
    source: str = ""  # citation from the assignment table

    # positional / attention details
    rope_theta: float = 10000.0
    qk_norm: bool = False
    mrope: bool = False  # Qwen2-VL multimodal 3D RoPE
    sliding_window: int = 2048  # for "local_attn" blocks
    tie_embeddings: bool = True

    # MoE
    moe: Optional[MoEConfig] = None

    # encoder-decoder (whisper): encoder layer stack
    n_enc_repeats: int = 0
    enc_block_pattern: Tuple[str, ...] = ()
    enc_seq_divisor: int = 2  # conv frontend downsampling factor (stub)
    dec_max_len: int = 448  # whisper decoder max length (training shapes)

    # rglru
    rglru_conv_width: int = 4
    rglru_expand: float = 1.0  # recurrence width = expand * d_model

    # xlstm
    xlstm_proj_factor: float = 2.0  # mLSTM up-projection factor
    xlstm_conv_width: int = 4

    # WG-KV
    wgkv: WGKVConfig = field(default_factory=WGKVConfig)

    # numerics
    dtype: str = "bfloat16"
    param_dtype: str = "float32"

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    # ---- derived ------------------------------------------------------
    @property
    def n_layers(self) -> int:
        return self.n_repeats * len(self.block_pattern) + len(self.stem_pattern)

    @property
    def n_enc_layers(self) -> int:
        return self.n_enc_repeats * len(self.enc_block_pattern)

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def is_encdec(self) -> bool:
        return self.n_enc_repeats > 0

    @property
    def has_attention_cache(self) -> bool:
        """Does any decoder block keep a KV cache (i.e. is WG-KV applicable)?"""
        return any(
            b in ATTN_BLOCKS for b in self.block_pattern + self.stem_pattern
        )

    @property
    def attn_blocks_per_pattern(self) -> int:
        return sum(1 for b in self.block_pattern if b in ATTN_BLOCKS)

    def wgkv_applicable(self) -> bool:
        return self.has_attention_cache

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # ---- parameter counting (exact, mirrors models/*.py) ---------------
    def param_count(self) -> int:
        """Exact parameter count of the tree (gates included)."""
        from repro_torch.models.registry import count_params_analytic

        return count_params_analytic(self)

    def active_param_count(self) -> int:
        from repro_torch.models.registry import count_params_analytic

        return count_params_analytic(self, active_only=True)


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"
