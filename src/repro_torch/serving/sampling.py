"""Token sampling for the serving engine (port of
``repro/serving/sampling.py``)."""
from __future__ import annotations

from typing import Optional

import torch


def sample(generator: Optional[torch.Generator], logits: torch.Tensor, *,
           temperature: float = 0.0) -> torch.Tensor:
    """logits: [B, V] -> tokens [B] int32. Greedy is ``argmax``;
    temperature sampling draws from ``generator`` (on the logits' device).
    The draws differ from ``jax.random``'s for the same seed."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)
