"""Inference (port of ``prefill``, ``decode_step`` and
``prefill_extend_ragged`` of ``repro/models/inference.py``).

:func:`prefill` is the offline budgeted vertical-slash prefill (paper
§4.2) that fills every layer's dual cache at once; :func:`decode_step`
continues from its caches. The serving engine instead ingests prompts
position by position through :func:`prefill_extend_ragged`.

Cache tree, as in the reference: ``{"t": [B] int32, "blocks": {"b0":
DualCache}, "obs": ObsWindow}`` with every DualCache leaf stacked
``[n_repeats, B, ...]`` and the eviction observation window (only when
eviction is on) stacked ``[n_repeats, n_attn, B, ...]``. Updates are
functional — each step returns a new tree and leaves its input untouched.

Composability (paper §5.4): ``DecodeOptions.quest_pages`` applies Quest
read-time selection as a page MASK, ``selection_policy = "quest:K"`` as a
GATHER of the top-K pages; on the port both read only the selected pages
through the ``paged_decode_selected`` kernel. ``evict_hard_budget``
applies SnapKV-style eviction when a head's global count hits the bound.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import eviction as EV
from repro_torch.core import selection as SEL
from repro_torch.core.dual_cache import (DualCache, init_dual_cache,
                                         prefill_populate)
from repro_torch.device import host_to_device, torch_dtype
from repro_torch.launch.specs import cache_batch_axis
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models.transformer import (_check_supported, _norm,
                                            layer_params)
from repro_torch.tree import tree_map, tree_map_with_path

Params = Dict[str, Any]
CacheTree = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class DecodeOptions:
    """Decode-time options, as in the reference. Static admission
    (``admission_policy``) is not ported yet and raises when set."""
    quest_pages: Optional[int] = None      # read-time Selection, MASK mode
    # gathered read-time Selection: None | "quest:K" (top-K pages read;
    # parse_selection_policy)
    selection_policy: Optional[str] = None
    evict_hard_budget: Optional[int] = None  # Eviction bound (tokens/head)
    evict_frac: float = 0.10
    w_obs: int = 256
    admission_policy: Optional[str] = None

    def __post_init__(self):
        if self.admission_policy is not None:
            raise NotImplementedError(
                "DecodeOptions.admission_policy is not ported to repro_torch "
                "yet (see ROADMAP.md)")


def parse_selection_policy(policy: Optional[str]) -> Optional[int]:
    """"quest:K" -> K (page budget); None -> None."""
    if policy is None:
        return None
    kind, _, arg = policy.partition(":")
    if kind != "quest" or not arg.isdigit() or int(arg) < 1:
        raise ValueError(
            f"unknown selection policy {policy!r} (expected 'quest:K')")
    return int(arg)


def _split_layers(node: DualCache) -> List[DualCache]:
    cols = [leaf.unbind(0) for leaf in node]
    return [DualCache(*(c[r] for c in cols)) for r in range(len(cols[0]))]


def _stack_layers(layers: List[DualCache]) -> DualCache:
    return DualCache(*(torch.stack(leaves) for leaves in zip(*layers)))


class PrefillOut(NamedTuple):
    logits: torch.Tensor           # [B, V] for the last position
    hidden: torch.Tensor           # [B, S, D]
    mean_admission: torch.Tensor   # scalar: fraction of tokens with g >= tau


def _attn_block_prefill(p: Params, cfg: ModelConfig, x: torch.Tensor,
                        positions: torch.Tensor, *, budget: int
                        ) -> Tuple[torch.Tensor, DualCache, torch.Tensor]:
    """One ``"attn"`` block of the budgeted prefill: vertical-slash
    attention, then the dual cache populated from its K/V/gates.
    Returns (x, cache, admitted fraction)."""
    b = x.shape[0]
    r = A.attn_prefill_budgeted(p["attn"], cfg, _norm(cfg, p["ln1"], x),
                                positions, budget=budget)
    cache = init_dual_cache(b, cfg.n_kv_heads, cfg.head_dim,
                            w_local=cfg.wgkv.w_local, budget=budget,
                            dtype=torch_dtype(cfg.dtype), device=x.device)
    cache = prefill_populate(cache, r.k_rope, r.v, r.g, tau=cfg.wgkv.tau,
                             sink=cfg.wgkv.sink, sel=r.sel)
    x = x + r.out
    x = x + L.swiglu(p["mlp"], _norm(cfg, p["ln2"], x))
    return x, cache, (r.g >= cfg.wgkv.tau).float().mean()


def prefill(params: Params, cfg: ModelConfig, tokens: torch.Tensor, *,
            positions: Optional[torch.Tensor] = None,
            use_wgkv: Optional[bool] = None, budget: Optional[int] = None,
            opts: DecodeOptions = DecodeOptions()
            ) -> Tuple[PrefillOut, CacheTree]:
    """Budgeted vertical-slash prefill of tokens [B, S] (S a multiple of
    W). Every layer's dual cache is filled at once and stacked
    ``[n_repeats, B, ...]``, so :func:`decode_step` continues from the
    returned tree. ``budget`` defaults to the config's global budget at
    S. On CUDA each layer runs the ``gate_mlp`` and
    ``vertical_slash`` kernels. With ``opts.evict_hard_budget`` the tree
    carries an empty eviction observation window (``"obs"``) for the
    decode steps that follow."""
    _check_supported(cfg)
    if use_wgkv is None:
        use_wgkv = cfg.wgkv.enabled
    if not use_wgkv:
        raise NotImplementedError(
            "prefill(use_wgkv=False): the dense full-attention baseline "
            "(attn_prefill_full, DenseCache) is not ported yet; see "
            "ROADMAP.md Queue 1 item 5")
    dt = torch_dtype(cfg.dtype)
    x = L.embed(params["embed"], tokens, dt)
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32,
                                 device=x.device)[None].expand(b, s)
    if budget is None:
        budget = cfg.wgkv.global_budget(s)
    per_block: Dict[str, List[DualCache]] = {
        f"b{i}": [] for i in range(len(cfg.block_pattern))}
    adm_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp in layer_params(params, cfg):
        for i, _bt in enumerate(cfg.block_pattern):
            x, cache, adm = _attn_block_prefill(lp[f"b{i}"], cfg, x,
                                                positions, budget=budget)
            per_block[f"b{i}"].append(cache)
            adm_sum = adm_sum + adm
    adm_n = cfg.n_repeats * max(cfg.attn_blocks_per_pattern, 1)
    caches: CacheTree = {
        "t": torch.full((b,), s, dtype=torch.int32, device=x.device),
        "blocks": {k: _stack_layers(v) for k, v in per_block.items()}}
    if opts.evict_hard_budget is not None:
        caches["obs"] = _init_obs_tree(cfg, b, opts, x.device)
    hidden = _norm(cfg, params["ln_f"], x)
    logits = L.unembed(params["embed"], hidden[:, -1])
    return PrefillOut(logits, hidden, adm_sum / adm_n), caches


def _init_obs_tree(cfg: ModelConfig, b: int, opts: DecodeOptions,
                   device=None) -> EV.ObsWindow:
    """Empty observation windows stacked ``[n_repeats, n_attn, B, ...]``."""
    one = EV.init_obs(b, cfg.n_heads, cfg.head_dim, opts.w_obs,
                      torch_dtype(cfg.dtype), device=device)
    lead = (cfg.n_repeats, cfg.attn_blocks_per_pattern)
    return tree_map(lambda x: x[None, None].expand(lead + x.shape)
                    .contiguous(), one)


def _quest_mask(cfg: ModelConfig, cache: DualCache, q: torch.Tensor,
                pages: int) -> torch.Tensor:
    """Read-time Selection over the global cache as a page mask
    [B, Hkv, P] (the ring is always read): the top ``pages`` pages by
    their upper bound, ties at the threshold included, scored from the
    incrementally maintained page metadata. The reference returns the
    token mask ``token_mask_from_pages(mask) & gvalid`` joined with an
    all-visible ring; the port reads the pages themselves. The budget is
    page-aligned (``attn_decode_wgkv`` checks it)."""
    meta = SEL.PageMeta(cache.pkmin, cache.pkmax,
                        SEL.page_valid_from_count(
                            cache.gcnt, cache.budget // SEL.PAGE_SIZE))
    return SEL.select_pages(q, meta, pages)


def decode_step(params: Params, cfg: ModelConfig, token: torch.Tensor,
                caches: CacheTree, *, opts: DecodeOptions = DecodeOptions(),
                layers: Optional[List[Params]] = None
                ) -> Tuple[torch.Tensor, CacheTree, Dict[str, torch.Tensor]]:
    """token: [B] int -> (logits [B, V], new caches, stats). ``layers``
    may pass precomputed per-layer parameter views
    (:func:`repro_torch.models.transformer.layer_params`).

    Per attention layer: the decode read (with Quest selection when
    ``opts`` asks), then, when the tree carries ``"obs"`` and
    ``opts.evict_hard_budget`` is set, the layer's observation window
    takes the step's query (``x @ w_q`` split into heads, before qk-norm
    and RoPE, as the reference) and ``maybe_evict`` runs. Stats are per
    row: ``evict_trigger_rows`` (triggered fraction of kv heads, summed
    over layers) and ``selected_pages_rows`` (valid gathered pages, mean
    over kv heads, summed over layers; zeros without gather
    selection)."""
    dt = torch_dtype(cfg.dtype)
    if layers is None:
        layers = layer_params(params, cfg)
    x = L.embed(params["embed"], token, dt)                     # [B, D]
    b = x.shape[0]
    dev = x.device
    per_block = {f"b{i}": _split_layers(caches["blocks"][f"b{i}"])
                 for i in range(len(cfg.block_pattern))}
    new_block = {k: [] for k in per_block}
    obs = caches.get("obs")
    evict = obs is not None and opts.evict_hard_budget is not None
    new_obs: List[List[EV.ObsWindow]] = []
    sel_fn = None
    if opts.quest_pages is not None:
        def sel_fn(cache, q):
            return _quest_mask(cfg, cache, q, opts.quest_pages)
    sel_k = parse_selection_policy(opts.selection_policy)
    adm_sum = torch.zeros((b,), dtype=torch.float32, device=dev)
    trig_sum = torch.zeros_like(adm_sum)
    sel_sum = torch.zeros_like(adm_sum)
    adm_n = 0
    for r in range(cfg.n_repeats):
        row_obs = []
        for i, _bt in enumerate(cfg.block_pattern):
            key = f"b{i}"
            p = layers[r][key]
            xin = _norm(cfg, p["ln1"], x)
            h, nc, g_new, sel_pages = A.attn_decode_wgkv(
                p["attn"], cfg, xin, per_block[key][r],
                token_select_fn=sel_fn, select_pages_k=sel_k)
            adm_sum = adm_sum + (g_new >= cfg.wgkv.tau).float().mean(dim=-1)
            adm_n += 1
            if sel_pages is not None:
                sel_sum = sel_sum + sel_pages.float().mean(dim=-1)
            if evict:
                ob = EV.ObsWindow(*(leaf[r, i] for leaf in obs))
                q_obs = A._heads(xin[:, None] @ p["attn"]["w_q"].to(
                    xin.dtype), cfg.n_heads, cfg.head_dim)[:, :, 0]
                ob = EV.push_query(ob, q_obs)
                nc, trg = EV.maybe_evict(
                    nc, ob, hard_budget=opts.evict_hard_budget,
                    evict_frac=opts.evict_frac)
                trig_sum = trig_sum + trg.float().mean(dim=-1)
                row_obs.append(ob)
            new_block[key].append(nc)
            x = x + h
            x = x + L.swiglu(p["mlp"], _norm(cfg, p["ln2"], x))
        new_obs.append(row_obs)
    hidden = _norm(cfg, params["ln_f"], x)
    logits = L.unembed(params["embed"], hidden)
    new_caches: CacheTree = {
        "t": caches["t"] + 1,
        "blocks": {k: _stack_layers(v) for k, v in new_block.items()}}
    if evict:
        new_caches["obs"] = EV.ObsWindow(*(
            torch.stack([torch.stack([getattr(ob, f) for ob in row])
                         for row in new_obs])
            for f in EV.ObsWindow._fields))
    elif obs is not None:
        new_caches["obs"] = obs
    return logits, new_caches, {
        "evict_triggers": trig_sum.mean(),
        "evict_trigger_rows": trig_sum,
        "mean_admission": adm_sum / max(adm_n, 1),
        "selected_pages_rows": sel_sum}


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
