"""Decode-path inference (port of ``decode_step`` and
``prefill_extend_ragged`` of ``repro/models/inference.py``).

Cache tree, as in the reference: ``{"t": [B] int32, "blocks": {"b0":
DualCache}}`` with every DualCache leaf stacked ``[n_repeats, B, ...]``.
Updates are functional — each step returns a new tree and leaves its
input untouched.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.dual_cache import DualCache
from repro_torch.device import host_to_device, torch_dtype
from repro_torch.launch.specs import cache_batch_axis
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models.transformer import _norm, layer_params
from repro_torch.tree import tree_map_with_path

Params = Dict[str, Any]
CacheTree = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class DecodeOptions:
    """Decode-time options. The port serves the learned write gate with
    full attention over the dual cache; the reference's composition
    options (Quest mask/gather selection, SnapKV eviction, static
    admission) are not ported yet and raise when set."""
    quest_pages: Optional[int] = None
    selection_policy: Optional[str] = None
    evict_hard_budget: Optional[int] = None
    admission_policy: Optional[str] = None

    def __post_init__(self):
        for f in dataclasses.fields(self):
            if getattr(self, f.name) is not None:
                raise NotImplementedError(
                    f"DecodeOptions.{f.name} is not ported to repro_torch "
                    "yet (see ROADMAP.md)")


def _split_layers(node: DualCache) -> List[DualCache]:
    cols = [leaf.unbind(0) for leaf in node]
    return [DualCache(*(c[r] for c in cols)) for r in range(len(cols[0]))]


def _stack_layers(layers: List[DualCache]) -> DualCache:
    return DualCache(*(torch.stack(leaves) for leaves in zip(*layers)))


def decode_step(params: Params, cfg: ModelConfig, token: torch.Tensor,
                caches: CacheTree, *, opts: DecodeOptions = DecodeOptions(),
                layers: Optional[List[Params]] = None
                ) -> Tuple[torch.Tensor, CacheTree, Dict[str, torch.Tensor]]:
    """token: [B] int -> (logits [B, V], new caches, stats). ``layers``
    may pass precomputed per-layer parameter views
    (:func:`repro_torch.models.transformer.layer_params`)."""
    del opts  # every supported option is the default
    dt = torch_dtype(cfg.dtype)
    if layers is None:
        layers = layer_params(params, cfg)
    x = L.embed(params["embed"], token, dt)                     # [B, D]
    b = x.shape[0]
    dev = x.device
    per_block = {f"b{i}": _split_layers(caches["blocks"][f"b{i}"])
                 for i in range(len(cfg.block_pattern))}
    new_block = {k: [] for k in per_block}
    adm_sum = torch.zeros((b,), dtype=torch.float32, device=dev)
    adm_n = 0
    for r in range(cfg.n_repeats):
        for i, _bt in enumerate(cfg.block_pattern):
            key = f"b{i}"
            p = layers[r][key]
            xin = _norm(cfg, p["ln1"], x)
            h, nc, g_new = A.attn_decode_wgkv(p["attn"], cfg, xin,
                                              per_block[key][r])
            new_block[key].append(nc)
            adm_sum = adm_sum + (g_new >= cfg.wgkv.tau).float().mean(dim=-1)
            adm_n += 1
            x = x + h
            x = x + L.swiglu(p["mlp"], _norm(cfg, p["ln2"], x))
    hidden = _norm(cfg, params["ln_f"], x)
    logits = L.unembed(params["embed"], hidden)
    new_caches: CacheTree = {
        "t": caches["t"] + 1,
        "blocks": {k: _stack_layers(v) for k, v in new_block.items()}}
    zeros = torch.zeros((b,), dtype=torch.float32, device=dev)
    return logits, new_caches, {
        "evict_triggers": zeros.mean(),
        "evict_trigger_rows": zeros,
        "mean_admission": adm_sum / max(adm_n, 1),
        "selected_pages_rows": zeros}


def prefill_extend_ragged(params: Params, cfg: ModelConfig,
                          tokens: torch.Tensor, lengths,
                          caches: CacheTree, *,
                          opts: DecodeOptions = DecodeOptions()
                          ) -> Tuple[torch.Tensor, CacheTree,
                                     Dict[str, torch.Tensor]]:
    """Ragged multi-row chunked prefill: advance B rows position by
    position through :func:`decode_step`.

    ``tokens`` [B, S] holds each row's next chunk left-aligned;
    ``lengths`` [B] (host: a list, numpy array or CPU tensor) says how
    many are real. Every cache write at a position >= ``lengths[i]`` is
    masked out by a per-leaf select against the pre-step tree, so a
    length-0 row comes back bit-identical. Positions where no row is
    active are not run at all: they would change nothing. Returns
    (each row's logits at its LAST real position, zeros for length-0 rows;
    the advanced caches; per-row stats ``evict_trigger_rows``,
    ``adm_sum_rows``, ``selected_pages_rows``)."""
    b, s = tokens.shape
    lens = torch.as_tensor(lengths, dtype=torch.int32).cpu()
    steps = min(int(lens.max()), s) if b else 0
    dev = tokens.device
    lens_dev = host_to_device(lens, dev)
    layers = layer_params(params, cfg)
    last_logits = torch.zeros((b, cfg.vocab_size), dtype=torch_dtype(cfg.dtype),
                              device=dev)
    trig = torch.zeros((b,), dtype=torch.float32, device=dev)
    adm = torch.zeros_like(trig)
    selp = torch.zeros_like(trig)
    for j in range(steps):
        active = j < lens_dev                                   # [B] bool

        def keep(path, new_leaf, old_leaf):
            shape = [1] * new_leaf.ndim
            shape[cache_batch_axis(path)] = b
            return torch.where(active.reshape(shape), new_leaf, old_leaf)

        logits, new, st = decode_step(params, cfg, tokens[:, j], caches,
                                      opts=opts, layers=layers)
        caches = tree_map_with_path(keep, new, caches)
        last_logits = torch.where(active[:, None], logits, last_logits)
        zero = torch.zeros_like(trig)
        trig = trig + torch.where(active, st["evict_trigger_rows"], zero)
        adm = adm + torch.where(active, st["mean_admission"], zero)
        selp = selp + torch.where(active, st["selected_pages_rows"], zero)
    return last_logits, caches, {"evict_trigger_rows": trig,
                                 "adm_sum_rows": adm,
                                 "selected_pages_rows": selp}
