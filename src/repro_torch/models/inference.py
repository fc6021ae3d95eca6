"""Inference (port of ``prefill``, ``decode_step``, ``prefill_extend``
and ``prefill_extend_ragged`` of ``repro/models/inference.py``).

:func:`prefill` is the offline budgeted vertical-slash prefill (paper
§4.2) that fills every layer's dual cache at once, or with
``use_wgkv=False`` the dense full-attention baseline's causal prefill
into a contiguous :class:`~repro_torch.models.attention.DenseCache`;
:func:`decode_step` continues from either (it dispatches on the cache
type). The serving engine instead ingests prompts position by position
through :func:`prefill_extend_ragged`; :func:`prefill_extend` is the
reference's non-ragged chunked extend. A VLM stream enters the prefill
as ``embeds`` with M-RoPE ``positions`` [3, B, S]; decode ropes at the
row's ``t`` (text). An encoder-decoder's prefill takes ``enc_embeds``.

Cache tree, as in the reference: ``{"t": [B] int32, "stem": (cache,
...), "blocks": {"b0": ..., "b1": ...}, "obs": ObsWindow}``. An
attention block (``"attn"``, ``"attn_moe"``, ``"local_attn"``) keeps a
DualCache whose
ring is ``cfg.wgkv.w_local`` or, for ``local_attn``, ``cfg.sliding_window``
tokens (the dense baseline: a DenseCache); an ``"attn_cross"`` block
``{"self": that cache, "cross": CrossCache}``, its encoder memory fixed
at prefill (budgeted by the gate under WG-KV); an ``"rglru"`` block its
RGLRUState, ``"mlstm"`` / ``"slstm"`` their MLSTMState / SLSTMState.
Every ``"blocks"`` leaf is stacked ``[n_repeats, B, ...]``;
the stem (only when the config has one) is a tuple of batch-leading
caches; the eviction observation window (only when eviction is on) is
stacked ``[n_repeats, n_attn, B, ...]`` and indexed by a block's ordinal
among the attention blocks of the pattern.
Updates are functional — each step returns a new tree and leaves its
input untouched.

An ``"attn_moe"`` block routes its FFN's tokens in ``moe_groups`` groups
(:func:`repro_torch.models.moe.moe_ffn`): the whole ``[B, S]`` prefill,
or the ``[B, 1]`` decode step with every row in it, the inactive slots of
a ragged serving tick included. Expert capacity is shared by a group, so
one row's output can depend on the others', as in the reference.

Composability (paper §5.4): ``DecodeOptions.quest_pages`` applies Quest
read-time selection as a page MASK, ``selection_policy = "quest:K"`` as a
GATHER of the top-K pages; on the port both read only the selected pages
through the ``paged_decode_selected`` kernel. ``evict_hard_budget``
applies SnapKV-style eviction when a head's global count hits the bound.
``admission_policy`` replaces the learned write gate with a static
position/head policy (StreamingLLM or DuoAttention, paper §5.2): the
``gate_mlp`` kernel then does not run, the reads do.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ATTN_BLOCKS, ModelConfig
from repro_torch.core import baselines as BL
from repro_torch.core import eviction as EV
from repro_torch.core import selection as SEL
from repro_torch.core.dual_cache import (DualCache, init_dual_cache,
                                         prefill_populate)
from repro_torch.device import host_to_device, torch_dtype
from repro_torch.launch.specs import cache_batch_axis
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import rglru as RG
from repro_torch.models import xlstm as XL
from repro_torch.models.transformer import (_norm, embed_inputs,
                                            embed_params, ffn, layer_params,
                                            stem_params, unembed_params,
                                            unstack)
from repro_torch.sharding import comm
from repro_torch.tree import tree_map, tree_map_with_path

Params = Dict[str, Any]
CacheTree = Dict[str, Any]


STATIC_POLICIES = ("streaming_llm", "duo")
INT32_MAX = torch.iinfo(torch.int32).max


@dataclasses.dataclass(frozen=True)
class DecodeOptions:
    """Decode-time options, as in the reference. ``admission_policy``
    ("streaming_llm": sinks only; "duo": ``duo_retrieval_heads`` admit
    all, the other heads sinks only; None: the learned gate) is checked
    here, where the reference checks it when the gate is first drawn."""
    quest_pages: Optional[int] = None      # read-time Selection, MASK mode
    # gathered read-time Selection: None | "quest:K" (top-K pages read;
    # parse_selection_policy)
    selection_policy: Optional[str] = None
    evict_hard_budget: Optional[int] = None  # Eviction bound (tokens/head)
    evict_frac: float = 0.10
    w_obs: int = 256
    admission_policy: Optional[str] = None
    admission_sink: int = 16
    duo_retrieval_heads: Tuple[int, ...] = ()

    def __post_init__(self):
        if self.admission_policy not in (None, *STATIC_POLICIES):
            raise ValueError(
                f"unknown admission_policy {self.admission_policy!r}; "
                f"known: {STATIC_POLICIES} or None (the learned gate)")


def parse_selection_policy(policy: Optional[str]) -> Optional[int]:
    """"quest:K" -> K (page budget); None -> None."""
    if policy is None:
        return None
    kind, _, arg = policy.partition(":")
    if kind != "quest" or not arg.isdigit() or int(arg) < 1:
        raise ValueError(
            f"unknown selection policy {policy!r} (expected 'quest:K')")
    return int(arg)


def _static_gates(cfg: ModelConfig, opts: Optional[DecodeOptions],
                  positions: torch.Tensor) -> Optional[torch.Tensor]:
    """Static admission gates at ``positions`` ([B] decode / [B, S]
    prefill; of an M-RoPE stack [3, B, S] the first); None when the
    learned gate is in effect."""
    if opts is None or opts.admission_policy is None:
        return None
    pos = positions if positions.ndim <= 2 else positions[0]
    return BL.gates_from_positions(
        opts.admission_policy, pos, cfg.n_kv_heads,
        sink=opts.admission_sink, retrieval_heads=opts.duo_retrieval_heads)


def _stack_layers(layers: list):
    """One cache per repeat -> the stacked per-block cache."""
    return tree_map(lambda *xs: torch.stack(xs), *layers)


class PrefillOut(NamedTuple):
    logits: torch.Tensor           # [B, V] for the last position
    hidden: torch.Tensor           # [B, S, D]
    mean_admission: torch.Tensor   # scalar: fraction of tokens with g >= tau


def _attn_block_prefill(p: Params, cfg: ModelConfig, bt: str,
                        x: torch.Tensor, positions: torch.Tensor, *,
                        use_wgkv: bool, budget: int, max_len: int,
                        moe_groups: int = 1,
                        opts: Optional[DecodeOptions] = None,
                        enc_out: Optional[torch.Tensor] = None):
    """One attention block of the prefill. With WG-KV: vertical-slash
    attention over the block's window (``cfg.sliding_window`` for
    ``local_attn``, else ``cfg.wgkv.w_local``) under the learned gate or
    ``opts``' static policy, then a dual cache with a ring of that window
    populated from its K/V/gates. Without: causal attention (windowed
    for ``local_attn``) and a dense cache of ``max_len`` holding all S
    tokens. An ``attn_moe`` block's FFN routes the whole ``[B, S]`` chunk
    in ``moe_groups`` groups. An ``attn_cross`` block then attends to the
    encoder output through a cross cache budgeted at ``budget`` (the
    self-attention's, as in the reference) under WG-KV, whole without;
    its cache is ``{"self": ..., "cross": CrossCache}``. Returns (x,
    cache, admitted fraction; 0 without WG-KV)."""
    b, s, _ = x.shape
    dt = torch_dtype(cfg.dtype)
    window = cfg.sliding_window if bt == "local_attn" else None
    xin = _norm(cfg, p["ln1"], x)
    adm = torch.zeros((), dtype=torch.float32, device=x.device)
    if use_wgkv:
        w_ring = window if window is not None else cfg.wgkv.w_local
        r = A.attn_prefill_budgeted(
            p["attn"], cfg, xin, positions, budget=budget, window=window,
            gate_override=_static_gates(cfg, opts, positions))
        cache = init_dual_cache(b, cfg.n_kv_heads, cfg.head_dim,
                                w_local=w_ring, budget=budget, dtype=dt,
                                device=x.device)
        cache = prefill_populate(cache, r.k_rope, r.v, r.g,
                                 tau=cfg.wgkv.tau, sink=cfg.wgkv.sink,
                                 sel=r.sel)
        h = r.out
        adm = (r.g >= cfg.wgkv.tau).float().mean()
    else:
        h, k_rope, v = A.attn_prefill_full(p["attn"], cfg, xin, positions,
                                           window=window)
        cache = A.init_dense_cache(b, cfg.n_kv_heads, cfg.head_dim, max_len,
                                   dt, device=x.device)
        cache.k[:, :, :s] = k_rope.to(dt)
        cache.v[:, :, :s] = v.to(dt)
        cache.t.fill_(s)
    x = x + h
    if bt == "attn_cross":
        cc = A.build_cross_cache(p["xattn"], cfg, enc_out,
                                 budget=budget if use_wgkv else None)
        x = x + A.attn_cross(p["xattn"], cfg, _norm(cfg, p["ln_x"], x), cc)
        cache = {"self": cache, "cross": cc}
    y, _ = ffn(p, cfg, bt, x, moe_groups=moe_groups)
    return x + y, cache, adm


def _block_prefill(p: Params, cfg: ModelConfig, bt: str, x: torch.Tensor,
                   positions: torch.Tensor, **kw):
    """One block of the prefill -> (x, its cache, admitted fraction; 0
    for a block without a gate)."""
    if bt in ATTN_BLOCKS:
        return _attn_block_prefill(p, cfg, bt, x, positions, **kw)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    if bt == "rglru":
        y, state = RG.rglru_block(p["rec"], cfg, _norm(cfg, p["ln1"], x))
        x = x + y
        x = x + L.swiglu(p["mlp"], _norm(cfg, p["ln2"], x))
        return x, state, zero
    if bt == "mlstm":
        x, state = XL.mlstm_auto(p["cell"], cfg, x)
        return x, state, zero
    if bt == "slstm":
        x, state = XL.slstm_block(p["cell"], cfg, x)
        return x, state, zero
    raise ValueError(f"unknown block type {bt!r}")


def prefill(params: Params, cfg: ModelConfig,
            tokens: Optional[torch.Tensor] = None, *,
            positions: Optional[torch.Tensor] = None,
            embeds: Optional[torch.Tensor] = None,
            enc_embeds: Optional[torch.Tensor] = None,
            use_wgkv: Optional[bool] = None, budget: Optional[int] = None,
            max_len: Optional[int] = None, moe_groups: int = 1,
            opts: DecodeOptions = DecodeOptions()
            ) -> Tuple[PrefillOut, CacheTree]:
    """Prefill of tokens [B, S] (or ``embeds`` [B, S, D], a VLM stream,
    with M-RoPE ``positions`` [3, B, S]; ``enc_embeds`` [B, S_enc, D] for
    the encoder-decoder, encoded once). Every layer's cache is filled at once —
    the stem's as a tuple, the repeats' stacked ``[n_repeats, B, ...]``
    — so :func:`decode_step` continues from the returned tree.

    With WG-KV (``use_wgkv``, default ``cfg.wgkv.enabled``): the budgeted
    vertical-slash prefill (S a multiple of every attention block's
    window); ``budget`` defaults to the config's global budget at
    ``max_len`` or S, as in the reference. On CUDA each attention layer
    runs the ``gate_mlp`` (not under a static ``opts.admission_policy``)
    and ``vertical_slash`` kernels. Without: the dense baseline, causal
    attention through the ``gated_flash`` kernel (its hard-window mode
    for ``local_attn``) and a dense cache of ``max_len`` (default S + 64,
    rounded up to a 16-token page) per layer. Each ``rglru`` layer runs
    the ``rglru_scan`` kernel. With ``opts.evict_hard_budget`` the
    tree carries an empty eviction observation window (``"obs"``) for
    the decode steps that follow.
    ``moe_groups``: the routing groups of each ``attn_moe`` block's FFN
    over the ``B * S`` tokens.

    ``mean_admission`` is the reference's: the admitted fractions summed
    over attention layers, divided by the stem's block count (of any
    type) plus ``n_repeats`` times the pattern's attention blocks."""
    if use_wgkv is None:
        use_wgkv = cfg.wgkv.enabled
    x, enc_out = embed_inputs(params, cfg, tokens, embeds, enc_embeds)
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32,
                                 device=x.device)[None].expand(b, s)
    if budget is None:
        budget = cfg.wgkv.global_budget(max_len or s)
    if max_len is None:
        max_len = s + 64
    if not use_wgkv and max_len < s:
        raise ValueError(f"max_len {max_len} < prompt length {s}")
    kw = dict(use_wgkv=use_wgkv, budget=budget, max_len=max_len,
              moe_groups=moe_groups, opts=opts, enc_out=enc_out)
    adm_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    stem_caches = []
    for j, (bt, p) in enumerate(zip(cfg.stem_pattern, stem_params(params))):
        x, cache, adm = _block_prefill(
            comm.gather_params(p, ("stem", str(j))), cfg, bt, x, positions,
            **kw)
        stem_caches.append(cache)
        adm_sum = adm_sum + adm
    per_block: Dict[str, list] = {
        f"b{i}": [] for i in range(len(cfg.block_pattern))}
    for lp in layer_params(params, cfg):
        for i, bt in enumerate(cfg.block_pattern):
            x, cache, adm = _block_prefill(
                comm.gather_params(lp[f"b{i}"], ("blocks", f"b{i}"), True),
                cfg, bt, x, positions, **kw)
            per_block[f"b{i}"].append(cache)
            adm_sum = adm_sum + adm
    adm_n = (len(cfg.stem_pattern)
             + cfg.n_repeats * max(cfg.attn_blocks_per_pattern, 1))
    caches: CacheTree = {
        "t": torch.full((b,), s, dtype=torch.int32, device=x.device)}
    if stem_caches:
        caches["stem"] = tuple(stem_caches)
    caches["blocks"] = {k: _stack_layers(v) for k, v in per_block.items()}
    if opts.evict_hard_budget is not None:
        caches["obs"] = _init_obs_tree(cfg, b, opts, x.device)
    hidden = _norm(cfg, params["ln_f"], x)
    logits = L.unembed(unembed_params(params), hidden[:, -1])
    return PrefillOut(logits, hidden,
                      comm.mean_blocks(adm_sum / adm_n)), caches


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
    page-aligned (``attn_decode_wgkv`` checks it); the page metadata is
    whole on every rank of a seq-sharded cache, so the mask is too."""
    meta = SEL.PageMeta(cache.pkmin, cache.pkmax,
                        SEL.page_valid_from_count(
                            cache.gcnt, cache.pkmin.shape[2]))
    return SEL.select_pages(q, meta, pages)


def _attn_block_decode(p: Params, cfg: ModelConfig, bt: str,
                       x: torch.Tensor, cache, *, opts: DecodeOptions,
                       sel_fn, sel_k: Optional[int],
                       obs: Optional[EV.ObsWindow], moe_groups: int = 1,
                       dense_limit: Optional[torch.Tensor] = None):
    """One attention block of a decode step. A DenseCache (the dense
    baseline) appends the token and reads its first ``t`` entries (the
    last ``cfg.sliding_window`` for ``local_attn``). A DualCache: the
    dual-cache read (with Quest selection when asked; the write gate
    replaced by ``opts``' static policy when set), then, given an
    observation window and ``opts.evict_hard_budget``, the window takes
    the step's query (``x @ w_q`` split into heads, before qk-norm and
    RoPE, as the reference) and ``maybe_evict`` runs. Returns (x, cache,
    obs, per-row admission or None (dense), per-row selected pages or
    None, per-row triggers or None). An ``attn_moe`` block routes the
    step's ``[B, 1]`` tokens, every row, in ``moe_groups`` groups. An
    ``attn_cross`` block's cache is ``{"self": ..., "cross": CrossCache}``:
    the self cache as above, then one query over the (fixed) cross
    memory."""
    def rest(x, nc):
        """The cross attention (``attn_cross``) and the FFN."""
        if bt == "attn_cross":
            x = x + A.attn_cross(p["xattn"], cfg,
                                 _norm(cfg, p["ln_x"], x[:, None]),
                                 cache["cross"])[:, 0]
            nc = {"self": nc, "cross": cache["cross"]}
        y, _ = ffn(p, cfg, bt, x[:, None], moe_groups=moe_groups)
        return x + y[:, 0], nc

    xin = _norm(cfg, p["ln1"], x)
    self_cache = cache["self"] if bt == "attn_cross" else cache
    if isinstance(self_cache, A.DenseCache):
        window = cfg.sliding_window if bt == "local_attn" else None
        h, nc = A.attn_decode_dense(p["attn"], cfg, xin, self_cache,
                                    window=window, limit=dense_limit)
        return (*rest(x + h, nc), obs, None, None, None)
    h, nc, g_new, sel_pages = A.attn_decode_wgkv(
        p["attn"], cfg, xin, self_cache, token_select_fn=sel_fn,
        select_pages_k=sel_k,
        gate_override=_static_gates(cfg, opts, self_cache.t))
    adm = (g_new >= cfg.wgkv.tau).float().mean(dim=-1)
    selp = None if sel_pages is None else sel_pages.float().mean(dim=-1)
    trig = None
    if obs is not None and opts.evict_hard_budget is not None:
        q_obs = A._heads(comm.gather_q(
            xin[:, None] @ p["attn"]["w_q"].to(xin.dtype)),
            cfg.n_heads, cfg.head_dim)[:, :, 0]
        obs = EV.push_query(obs, q_obs)
        nc, trg = EV.maybe_evict(nc, obs, hard_budget=opts.evict_hard_budget,
                                 evict_frac=opts.evict_frac)
        trig = trg.float().mean(dim=-1)
    return (*rest(x + h, nc), obs, adm, selp, trig)


def _rglru_block_decode(p: Params, cfg: ModelConfig, x: torch.Tensor,
                        state: RG.RGLRUState):
    y, state = RG.rglru_step(p["rec"], cfg, _norm(cfg, p["ln1"], x), state)
    x = x + y
    x = x + L.swiglu(p["mlp"], _norm(cfg, p["ln2"], x))
    return x, state


def decode_step(params: Params, cfg: ModelConfig, token: torch.Tensor,
                caches: CacheTree, *, moe_groups: int = 1,
                opts: DecodeOptions = DecodeOptions(),
                layers: Optional[List[Params]] = None,
                dense_limit: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, CacheTree, Dict[str, torch.Tensor]]:
    """token: [B] int -> (logits [B, V], new caches, stats). ``layers``
    may pass precomputed per-layer parameter views
    (:func:`repro_torch.models.transformer.layer_params`).
    ``dense_limit`` [B] int: every dense layer's ``limit``
    (``attention.attn_decode_dense``; the ragged scan's masked rows).

    The stem blocks run first, then the repeats. Per attention layer: the
    decode read (with Quest selection when ``opts`` asks), then, when the
    tree carries ``"obs"`` and ``opts.evict_hard_budget`` is set, the
    layer's observation window (``obs[r, ai]``, ``ai`` its ordinal among
    the pattern's attention blocks; the stem has none) takes the step's
    query and ``maybe_evict`` runs. An ``rglru`` layer advances its state
    by one position. An ``attn_moe`` layer routes all B rows' tokens in
    ``moe_groups`` groups. An ``mlstm`` / ``slstm`` layer takes one
    recurrent step. An encoder-decoder's token gets the sinusoid of its
    row's ``t``. Stats are per row: ``evict_trigger_rows`` (triggered
    fraction of kv heads, summed over layers), ``mean_admission`` (mean
    over attention layers) and ``selected_pages_rows`` (valid gathered
    pages, mean over kv heads, summed over layers; zeros without gather
    selection)."""
    dt = torch_dtype(cfg.dtype)
    if layers is None:
        layers = layer_params(params, cfg)
    x = L.embed(embed_params(params), token, dt)                # [B, D]
    b = x.shape[0]
    dev = x.device
    if cfg.is_encdec:
        # the decoder's sinusoid at each row's position t
        ang = caches["t"][:, None].float() * L.sinusoidal_inv(
            cfg.d_model, dev)[None]
        x = x + torch.cat([torch.sin(ang), torch.cos(ang)], -1).to(dt)
    obs = caches.get("obs")
    evict = obs is not None and opts.evict_hard_budget is not None
    sel_fn = None
    if opts.quest_pages is not None:
        def sel_fn(cache, q):
            return _quest_mask(cfg, cache, q, opts.quest_pages)
    sel_k = parse_selection_policy(opts.selection_policy)
    adm_sum = torch.zeros((b,), dtype=torch.float32, device=dev)
    trig_sum = torch.zeros_like(adm_sum)
    sel_sum = torch.zeros_like(adm_sum)
    adm_n = 0

    def run(bt, p, x, cache, ob):
        nonlocal adm_sum, trig_sum, sel_sum, adm_n
        if bt == "rglru":
            xo, nc = _rglru_block_decode(p, cfg, x, cache)
            return xo, nc, ob
        if bt == "mlstm":
            return (*XL.mlstm_step(p["cell"], cfg, x, cache), ob)
        if bt == "slstm":
            return (*XL.slstm_step(p["cell"], cfg, x, cache), ob)
        if bt not in ATTN_BLOCKS:
            raise ValueError(f"unknown block type {bt!r}")
        xo, nc, ob, adm, selp, trig = _attn_block_decode(
            p, cfg, bt, x, cache, opts=opts, sel_fn=sel_fn, sel_k=sel_k,
            obs=ob, moe_groups=moe_groups, dense_limit=dense_limit)
        if adm is not None:
            adm_sum = adm_sum + adm
            adm_n += 1
        if selp is not None:
            sel_sum = sel_sum + selp
        if trig is not None:
            trig_sum = trig_sum + trig
        return xo, nc, ob

    new_caches: CacheTree = {"t": caches["t"] + 1}
    if cfg.stem_pattern:
        stem_new = []
        for j, (bt, p, cache) in enumerate(zip(
                cfg.stem_pattern, stem_params(params), caches["stem"])):
            x, nc, _ = run(bt, comm.gather_params(p, ("stem", str(j))), x,
                           cache, None)
            stem_new.append(nc)
        new_caches["stem"] = tuple(stem_new)
    per_block = {f"b{i}": unstack(caches["blocks"][f"b{i}"])
                 for i in range(len(cfg.block_pattern))}
    new_block: Dict[str, list] = {k: [] for k in per_block}
    new_obs: List[List[EV.ObsWindow]] = []
    for r in range(cfg.n_repeats):
        row_obs = []
        ai = 0
        for i, bt in enumerate(cfg.block_pattern):
            key = f"b{i}"
            ob = None
            if evict and bt in ATTN_BLOCKS:
                ob = EV.ObsWindow(*(leaf[r, ai] for leaf in obs))
                ai += 1
            x, nc, ob = run(bt, comm.gather_params(
                layers[r][key], ("blocks", key), True), x,
                per_block[key][r], ob)
            if ob is not None:
                row_obs.append(ob)
            new_block[key].append(nc)
        new_obs.append(row_obs)
    hidden = _norm(cfg, params["ln_f"], x)
    logits = L.unembed(unembed_params(params), hidden)
    new_caches["blocks"] = {k: _stack_layers(v) for k, v in new_block.items()}
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


def prefill_extend(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                   caches: CacheTree, *, moe_groups: int = 1,
                   opts: DecodeOptions = DecodeOptions()
                   ) -> Tuple[torch.Tensor, CacheTree,
                              Dict[str, torch.Tensor]]:
    """Teacher-forced multi-token cache extension (chunked prefill):
    ``tokens`` [B, S] fed one position at a time through
    :func:`decode_step`, every row at every position. Returns (logits of
    the LAST fed position [B, V], caches, ``{"evict_triggers": summed
    over the positions, "mean_admission": mean over positions and
    rows}``), as the reference's scan does."""
    layers = layer_params(params, cfg)
    logits, trig, adm = None, [], []
    for j in range(tokens.shape[1]):
        logits, caches, st = decode_step(params, cfg, tokens[:, j], caches,
                                         moe_groups=moe_groups, opts=opts,
                                         layers=layers)
        trig.append(st["evict_triggers"])
        adm.append(st["mean_admission"])
    return logits, caches, {"evict_triggers": torch.stack(trig).sum(),
                            "mean_admission": torch.stack(adm).mean()}


def _dense_limit(caches: CacheTree, active: torch.Tensor,
                 capacity: Optional[int]) -> Optional[torch.Tensor]:
    """The per-row ``limit`` a ragged position step gives every dense
    read (``attention.attn_decode_dense``): ``capacity`` (default the
    dense buffer's length) for the rows masked at this position, so that
    a masked row at capacity (full, or retired full and still stepped)
    writes nothing, ropes at its ``t`` and reads its first ``capacity``
    entries, as in the reference, whose buffer is ``capacity`` long; no
    limit for the active rows, whose write past the buffer still fails.
    None without dense caches."""
    nodes = list(caches["blocks"].values()) + list(caches.get("stem", ()))
    dense = [c for c in (n["self"] if isinstance(n, dict) else n
                         for n in nodes) if isinstance(c, A.DenseCache)]
    if not dense:
        return None
    buf = dense[0].k.shape[-2]
    cap = buf if capacity is None else capacity
    if cap > buf:
        raise ValueError(f"dense capacity {cap} > its buffer {buf}")
    return torch.where(active, torch.full_like(active, INT32_MAX,
                                               dtype=torch.int32),
                       torch.full_like(active, cap, dtype=torch.int32))


# the loop body masks every row's cache writes (TL003 holds it to that)
# torchlint: masked-scan-body
def prefill_extend_ragged(params: Params, cfg: ModelConfig,
                          tokens: torch.Tensor, lengths,
                          caches: CacheTree, *, moe_groups: int = 1,
                          opts: DecodeOptions = DecodeOptions(),
                          capacity: Optional[int] = None,
                          steps: Optional[int] = None
                          ) -> Tuple[torch.Tensor, CacheTree,
                                     Dict[str, torch.Tensor]]:
    """Ragged multi-row chunked prefill: advance B rows position by
    position through :func:`decode_step`.

    ``tokens`` [B, S] holds each row's next chunk left-aligned;
    ``lengths`` [B] (host: a list, numpy array or CPU tensor) says how
    many are real. Every cache write at a position >= ``lengths[i]`` is
    masked out by a per-leaf select against the pre-step tree, so a
    length-0 row comes back bit-identical. Every row still runs each
    position, so an ``attn_moe`` layer routes the inactive rows' tokens
    beside the active ones (``moe_groups`` groups over all B rows), as the
    reference does. A dense row masked at capacity writes nothing and
    reads its first ``capacity`` entries (default the dense buffer's
    length; the port rounds the buffer up to a page, so a caller whose
    capacity is not a multiple of 16 passes it), as the reference's row
    does in its buffer of that size. Positions where no row is active are
    not run at all: they would change nothing. ``steps`` (default the
    longest row's length) sets the positions run: a mesh rank whose
    routing group spans the data ranks runs the whole tick's, so every
    rank takes part in every position's gather. Returns
    (each row's logits at its LAST real position, zeros for length-0 rows;
    the advanced caches; per-row stats ``evict_trigger_rows``,
    ``adm_sum_rows``, ``selected_pages_rows``)."""
    b, s = tokens.shape
    lens = torch.as_tensor(lengths, dtype=torch.int32, device="cpu")
    if steps is None:
        steps = int(lens.max()) if b else 0
    steps = min(steps, s)
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

        logits, new, st = decode_step(
            params, cfg, tokens[:, j], caches, moe_groups=moe_groups,
            opts=opts, layers=layers,
            dense_limit=_dense_limit(caches, active, capacity))
        caches = tree_map_with_path(keep, new, caches)
        last_logits = torch.where(active[:, None], logits, last_logits)
        zero = torch.zeros_like(trig)
        trig = trig + torch.where(active, st["evict_trigger_rows"], zero)
        adm = adm + torch.where(active, st["mean_admission"], zero)
        selp = selp + torch.where(active, st["selected_pages_rows"], zero)
    return last_logits, caches, {"evict_trigger_rows": trig,
                                 "adm_sum_rows": adm,
                                 "selected_pages_rows": selp}
