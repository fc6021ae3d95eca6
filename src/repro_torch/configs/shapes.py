"""The four assigned input shapes."""
from __future__ import annotations

from repro_torch.configs.base import InputShape

TRAIN_4K = InputShape("train_4k", seq_len=4_096, global_batch=256, kind="train")
PREFILL_32K = InputShape("prefill_32k", seq_len=32_768, global_batch=32, kind="prefill")
DECODE_32K = InputShape("decode_32k", seq_len=32_768, global_batch=128, kind="decode")
LONG_500K = InputShape("long_500k", seq_len=524_288, global_batch=1, kind="decode")

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}


def get_shape(name: str) -> InputShape:
    return SHAPES[name]
