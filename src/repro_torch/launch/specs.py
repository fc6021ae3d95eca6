"""Decode cache construction and batched splice helpers (port of the
serving half of ``repro/launch/specs.py``).

The splice helpers are functional: they return new trees and leave their
inputs untouched, so an in-flight step's before/after trees stay valid.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.dual_cache import init_dual_cache
from repro_torch.device import torch_dtype
from repro_torch.tree import tree_leaves, tree_map, tree_map_with_path


def build_decode_caches(cfg: ModelConfig, batch: int, capacity: int, *,
                        device=None) -> Dict[str, Any]:
    """Empty decode cache tree ``{"t", "blocks": {"b0": DualCache}}`` with
    block leaves stacked ``[n_repeats, batch, ...]``. Only the write-gated
    dual cache of ``"attn"`` blocks is ported (the dense cache and the
    eviction ``obs`` subtree are not)."""
    if cfg.stem_pattern or any(bt != "attn" for bt in cfg.block_pattern):
        raise NotImplementedError(
            f"decode caches for pattern {cfg.block_pattern} (stem "
            f"{cfg.stem_pattern}) are not ported yet; only 'attn' blocks")
    dt = torch_dtype(cfg.dtype)
    one = {f"b{i}": init_dual_cache(
        batch, cfg.n_kv_heads, cfg.head_dim, w_local=cfg.wgkv.w_local,
        budget=cfg.wgkv.global_budget(capacity), dtype=dt, device=device)
        for i, _ in enumerate(cfg.block_pattern)}
    caches: Dict[str, Any] = {
        "t": torch.zeros((batch,), dtype=torch.int32, device=device)}
    caches["blocks"] = tree_map(
        lambda x: x[None].expand((cfg.n_repeats,) + x.shape).contiguous(), one)
    return caches


def cache_batch_axis(path) -> int:
    """Batch axis of a decode-cache leaf given its tree path: stacked
    per-superblock caches carry [n_repeats, B, ...]; ``t`` is
    batch-leading."""
    return 1 if "blocks" in path else 0


def alloc_batched_caches(caches_one: Any, slots: int) -> Any:
    """Zeroed batch-``slots`` cache tree shaped like a batch-1 tree."""
    return tree_map_with_path(
        lambda p, x: torch.zeros_like(x).repeat_interleave(
            slots, dim=cache_batch_axis(p)),
        caches_one)


def splice_caches(batch_tree: Any, one_tree: Any, slot: int) -> Any:
    """Write a batch-1 cache tree into batch row ``slot`` of a copy of
    the batch tree (the JetStream ``insert`` primitive)."""
    def put(p, full, one):
        ax = cache_batch_axis(p)
        out = full.clone()
        out.select(ax, slot).copy_(one.select(ax, 0))
        return out
    return tree_map_with_path(put, batch_tree, one_tree)


def extract_slot_caches(batch_tree: Any, slot: int) -> Any:
    """Read batch row ``slot`` back out as a batch-1 cache tree (inverse
    of :func:`splice_caches`)."""
    return tree_map_with_path(
        lambda p, full: full.narrow(cache_batch_axis(p), slot, 1).clone(),
        batch_tree)


def cache_tree_bytes(tree: Any) -> int:
    """Device-buffer bytes a cache tree holds, from leaf metadata only."""
    return sum(int(x.numel()) * x.element_size() for x in tree_leaves(tree))
