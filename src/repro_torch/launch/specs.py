"""Step inputs, decode cache construction and batched splice helpers
(port of ``repro/launch/specs.py``).

The input constructors (:func:`train_inputs`, :func:`prefill_inputs`,
:func:`decode_inputs`) and :func:`decode_cache_structs` return tensors
where the reference returns ``ShapeDtypeStruct``s: on the ``meta`` device
(the default) they hold shapes and dtypes only, as the reference's
structs do. On a real device the token ids are drawn uniformly from the
vocabulary with seed 0 (on the CPU, so every device gets the same ids),
``loss_mask`` is ones, and the rest (embeddings, positions, caches) is
zeros. Dtypes: tokens and M-RoPE positions int32, as in the reference;
``loss_mask`` float32; embeddings in ``cfg.dtype``.

The splice helpers are functional: they return new trees and leave their
inputs untouched, so an in-flight step's before/after trees stay valid.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ATTN_BLOCKS, InputShape, ModelConfig
from repro_torch.core.dual_cache import init_dual_cache
from repro_torch.device import torch_dtype
from repro_torch.models import attention as A
from repro_torch.models import rglru as RG
from repro_torch.models import xlstm as XL
from repro_torch.tree import tree_leaves, tree_map, tree_map_with_path


# number of vision patches in the VLM stream (32x32 grid)
VLM_GRID = (32, 32)
VLM_N_IMG = VLM_GRID[0] * VLM_GRID[1]


def _zeros(shape, dtype, device):
    return torch.zeros(tuple(shape), dtype=dtype, device=device)


def _tokens(cfg: ModelConfig, shape, device) -> torch.Tensor:
    if torch.device(device).type == "meta":
        return torch.empty(tuple(shape), dtype=torch.int32, device=device)
    gen = torch.Generator().manual_seed(0)
    return torch.randint(0, cfg.vocab_size, tuple(shape), generator=gen,
                         dtype=torch.int32).to(device)


def _ones(shape, device) -> torch.Tensor:
    return torch.ones(tuple(shape), dtype=torch.float32, device=device)


# ==========================================================================
# token / embedding inputs per step kind
# ==========================================================================
def train_inputs(cfg: ModelConfig, shape: InputShape,
                 device="meta") -> Dict[str, Any]:
    b, s = shape.global_batch, shape.seq_len
    dt = torch_dtype(cfg.dtype)
    if cfg.arch_type == "audio":
        s_dec = cfg.dec_max_len
        return {
            "tokens": _tokens(cfg, (b, s_dec), device),
            "enc_embeds": _zeros((b, s // cfg.enc_seq_divisor, cfg.d_model),
                                 dt, device),
            "loss_mask": _ones((b, s_dec), device),
        }
    out = {
        "tokens": _tokens(cfg, (b, s), device),
        "loss_mask": _ones((b, s), device),
    }
    if cfg.arch_type == "vlm":
        out["patch_embeds"] = _zeros((b, VLM_N_IMG, cfg.d_model), dt, device)
        out["positions"] = _zeros((3, b, s), torch.int32, device)
    return out


def prefill_inputs(cfg: ModelConfig, shape: InputShape,
                   device="meta") -> Dict[str, Any]:
    b, s = shape.global_batch, shape.seq_len
    dt = torch_dtype(cfg.dtype)
    if cfg.arch_type == "audio":
        return {
            "tokens": _tokens(cfg, (b, cfg.dec_max_len), device),
            "enc_embeds": _zeros((b, s // cfg.enc_seq_divisor, cfg.d_model),
                                 dt, device),
        }
    out = {"tokens": _tokens(cfg, (b, s), device)}
    if cfg.arch_type == "vlm":
        out["patch_embeds"] = _zeros((b, VLM_N_IMG, cfg.d_model), dt, device)
        out["positions"] = _zeros((3, b, s), torch.int32, device)
    return out


def decode_inputs(cfg: ModelConfig, shape: InputShape,
                  device="meta") -> Dict[str, Any]:
    return {"token": _tokens(cfg, (shape.global_batch,), device)}


def _block_cache(cfg: ModelConfig, bt: str, batch: int, capacity: int,
                 use_wgkv: bool, device, s_enc: Optional[int] = None):
    """One block's empty decode cache. An attention block (``attn``,
    ``attn_moe``, ``local_attn``, ``attn_cross``) with WG-KV: the
    write-gated dual cache (ring ``cfg.sliding_window`` for
    ``local_attn``, else ``cfg.wgkv.w_local``). Without (the dense
    baseline): a ring-only dual cache for ``local_attn`` (a budget of
    ``max(sink, 16)`` that only sinks reach), else a dense cache of
    ``capacity`` (rounded up to a 16-token page). An ``attn_cross``
    block's is ``{"self": that cache, "cross": CrossCache}`` over
    ``global_budget(s_enc)`` encoder slots under WG-KV, else ``s_enc``.
    A recurrent block's (``rglru``, ``mlstm``, ``slstm``) zero state."""
    dt = torch_dtype(cfg.dtype)
    if bt in ATTN_BLOCKS:
        if use_wgkv:
            w_ring = (cfg.sliding_window if bt == "local_attn"
                      else cfg.wgkv.w_local)
            cache = init_dual_cache(batch, cfg.n_kv_heads, cfg.head_dim,
                                    w_local=w_ring,
                                    budget=cfg.wgkv.global_budget(capacity),
                                    dtype=dt, device=device)
        elif bt == "local_attn":
            cache = init_dual_cache(batch, cfg.n_kv_heads, cfg.head_dim,
                                    w_local=cfg.sliding_window,
                                    budget=max(cfg.wgkv.sink, 16), dtype=dt,
                                    device=device)
        else:
            cache = A.init_dense_cache(batch, cfg.n_kv_heads, cfg.head_dim,
                                       capacity, dt, device=device)
        if bt != "attn_cross":
            return cache
        if s_enc is None:
            raise ValueError("an attn_cross block's cache needs s_enc")
        n = cfg.wgkv.global_budget(s_enc) if use_wgkv else s_enc
        shape = (batch, cfg.n_kv_heads, n, cfg.head_dim)
        cross = A.CrossCache(
            k=torch.zeros(shape, dtype=dt, device=device),
            v=torch.zeros(shape, dtype=dt, device=device),
            valid=torch.ones(shape[:3], dtype=torch.bool, device=device))
        return {"self": cache, "cross": cross}
    if bt == "rglru":
        return RG.init_rglru_state(cfg, batch, dt, device=device)
    if bt == "mlstm":
        return XL.init_mlstm_state(cfg, batch, dt, device=device)
    if bt == "slstm":
        return XL.init_slstm_state(cfg, batch, device=device)
    raise ValueError(f"unknown block type {bt!r}")


def build_decode_caches(cfg: ModelConfig, batch: int, capacity: int, *,
                        use_wgkv: bool = True, device=None,
                        s_enc: Optional[int] = None) -> Dict[str, Any]:
    """Empty decode cache tree ``{"t", "stem": (...), "blocks": {"b0":
    ...}}`` with block leaves stacked ``[n_repeats, batch, ...]`` and the
    stem (only when the config has one) a tuple of batch-leading caches.
    ``use_wgkv=False`` builds the dense baseline's caches; ``s_enc``: the
    encoder length an ``attn_cross`` block's cross cache holds. The
    eviction ``obs`` subtree is added by the caller that evicts
    (``inference._init_obs_tree``), as in the reference."""
    def mk(bt):
        return _block_cache(cfg, bt, batch, capacity, use_wgkv, device,
                            s_enc)

    caches: Dict[str, Any] = {
        "t": torch.zeros((batch,), dtype=torch.int32, device=device)}
    if cfg.stem_pattern:
        caches["stem"] = tuple(mk(bt) for bt in cfg.stem_pattern)
    one = {f"b{i}": mk(bt) for i, bt in enumerate(cfg.block_pattern)}
    caches["blocks"] = tree_map(
        lambda x: x[None].expand((cfg.n_repeats,) + x.shape).contiguous(), one)
    return caches


def cache_batch_axis(path) -> int:
    """Batch axis of a decode-cache leaf given its tree path: stacked
    per-superblock caches carry [n_repeats, B, ...] (the recurrent states
    and an ``attn_cross`` block's self and cross caches too); the
    eviction observation tree is [n_repeats, n_attn, B, ...]; everything
    else (``t``, stem caches) is batch-leading."""
    if "obs" in path:
        return 2
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


def decode_cache_structs(cfg: ModelConfig, shape: InputShape, *,
                         use_wgkv: bool, device="meta") -> Dict[str, Any]:
    """The decode cache tree of ``shape``: batch ``global_batch``,
    capacity ``seq_len``, an encoder-decoder's cross memory over
    ``seq_len // enc_seq_divisor`` encoder positions; nothing prefilled."""
    b, s = shape.global_batch, shape.seq_len
    s_enc = s // cfg.enc_seq_divisor if cfg.is_encdec else None
    return build_decode_caches(cfg, b, s, use_wgkv=use_wgkv, device=device,
                               s_enc=s_enc)
