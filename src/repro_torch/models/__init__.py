"""Decoder model math of the port (``"attn"`` blocks)."""
