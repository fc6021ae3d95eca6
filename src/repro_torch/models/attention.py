"""GQA attention with first-class WG-KV (port of
``repro/models/attention.py``).

Modes:
  * train — full-sequence attention: the causal teacher (``off``), the
    write-gated student (``gated``, the paper's log-space bias) or the
    binary vertical-slash mask at tau (``hard``).
  * prefill — budgeted vertical-slash attention (paper §4.2): each query
    sees its local window and up to ``budget`` admitted tokens older than
    the window; its K/V/gates populate the dual cache.
  * decode — one token against the dual cache with lazy promotion,
    optionally reading only Quest-selected pages of the global cache.
  * the dense full-attention baseline — causal prefill
    (:func:`attn_prefill_full`) into a contiguous :class:`DenseCache`, and
    one token against its first ``t`` entries (:func:`attn_decode_dense`).
  * encoder-decoder (whisper) — the decoder's cross attention over the
    encoder memory (:func:`attn_cross`), budgeted by the write gate when
    WG-KV is on (:func:`build_cross_cache`), and the encoder's
    bidirectional attention (:func:`attn_encoder`).

A config with M-RoPE (qwen2-vl) ropes by the (t, h, w) ids when a
prefill or forward is given positions [3, B, S]; decode ropes at the
row's ``t``, as in the reference.

On CUDA the gate runs in the ``gate_mlp`` kernel, gated training
attention in ``gated_flash``, the budgeted prefill in ``vertical_slash``
and the decode read over [admitted global ‖ local ring] in the
two-segment ``paged_decode`` kernel (``paged_decode_selected`` under
Quest selection), straight from the cache buffers. The dense baseline
reuses two of them: its causal prefill runs ``gated_flash`` with every
key inside the window (bias 0), its decode read is one ``paged_decode``
segment over the dense buffer. Windowed (``local_attn`` blocks with WG-KV
off), the prefill runs ``gated_flash``'s hard-window mode and the decode
read ``paged_decode`` from a start offset. On the CPU each wrapper runs
its plain PyTorch version. The teacher and hard modes, the cross
attention and the encoder run plain PyTorch (:func:`sdpa`: an einsum and
a softmax) on either device, as the reference computes them outside any
Pallas kernel; the cross memory's gate runs in ``gate_mlp``.

On a ``data x model`` mesh (``sharding.comm``) every attention here,
cross attention and the encoder's included, runs the rank's heads and
sums its ``w_o`` partial over "model"; the decode reads of a cache whose
token axis is split over "data" (dual, dense and Quest-selected) read
the rank's block and combine by log-sum-exp.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import masks as M
from repro_torch.core import selection as SEL
from repro_torch.core.admission import GlobalSelection, select_global
from repro_torch.core.dual_cache import DualCache, lazy_promote_and_write
from repro_torch.core.gate import gate_scores, init_gate
from repro_torch.device import torch_dtype
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.sharding import comm

Params = Dict[str, torch.Tensor]

# ==========================================================================
# dense-cache baseline (full attention)
# ==========================================================================
class DenseCache(NamedTuple):
    k: torch.Tensor   # [B, Hkv, S_max, hd] post-RoPE keys
    v: torch.Tensor
    t: torch.Tensor   # [B] int32 current length


def dense_len(max_len: int) -> int:
    """The dense buffer's length: ``max_len`` rounded up to a whole
    16-token page, the page the decode kernel reads (the tokens past
    ``t`` stay masked by the lengths)."""
    return -(-max_len // SEL.PAGE_SIZE) * SEL.PAGE_SIZE


def init_dense_cache(batch: int, n_kv: int, head_dim: int, max_len: int,
                     dtype=torch.float32, device=None) -> DenseCache:
    """Empty dense cache of ``dense_len(max_len)`` slots per kv stream."""
    shape = (batch, n_kv, dense_len(max_len), head_dim)
    return DenseCache(torch.zeros(shape, dtype=dtype, device=device),
                      torch.zeros(shape, dtype=dtype, device=device),
                      torch.zeros((batch,), dtype=torch.int32, device=device))


def dense_cache_append(cache: DenseCache, k_new: torch.Tensor,
                       v_new: torch.Tensor,
                       write: Optional[torch.Tensor] = None,
                       block: Optional[Tuple[int, int]] = None
                       ) -> DenseCache:
    """k_new, v_new: [B, H, hd] appended at each row's position ``t``:
    one slot per row written into a copy of the buffers (the dual cache's
    functional style). ``write`` [B] bool: the rows whose token is
    written; the others keep their buffers (the ragged scan's masked rows
    at capacity, whose write the reference drops). Every row's ``t``
    advances. A write past the buffer fails (an index error on the CPU, a
    device-side assert on CUDA), never drops: the serving engine guards
    capacity on the host before it dispatches. ``block`` (i, n): the
    buffers are this rank's block i of a token axis split over n ranks
    (context-parallel decode; ``t`` global): only the rank whose block
    holds position ``t`` writes it (the last block takes a position past
    the buffer, and fails)."""
    bar = torch.arange(cache.k.shape[0], device=cache.k.device)
    t = cache.t.long()
    if block is not None:
        cb = cache.k.shape[2]
        t = t - block[0] * cb
        mine = t >= 0 if block[0] == block[1] - 1 else (t >= 0) & (t < cb)
        write = mine if write is None else write & mine
    k, v = cache.k.clone(), cache.v.clone()
    k_new, v_new = k_new.to(k.dtype), v_new.to(v.dtype)
    if write is not None:
        t = torch.where(write, t, torch.zeros_like(t))
        keep = ~write[:, None, None]
        k_new = torch.where(keep, k[bar, :, t], k_new)
        v_new = torch.where(keep, v[bar, :, t], v_new)
    k[bar, :, t] = k_new
    v[bar, :, t] = v_new
    return DenseCache(k, v, cache.t + 1)


def init_attention(gen: torch.Generator, cfg: ModelConfig, device, *,
                   kind: str = "self",
                   with_gate: Optional[bool] = None) -> Params:
    """Attention parameters. kind: "self" (causal), "cross" (the
    encoder-decoder's) or "enc" (bidirectional encoder). The write gate
    comes with ``with_gate``, by default when WG-KV is enabled and the
    kind is not "enc"."""
    dt = torch_dtype(cfg.param_dtype)
    d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p: Params = {
        "w_q": L.dense_init(gen, (d, hq * hd), dt, device),
        "w_k": L.dense_init(gen, (d, hkv * hd), dt, device),
        "w_v": L.dense_init(gen, (d, hkv * hd), dt, device),
        "w_o": L.dense_init(gen, (hq * hd, d), dt, device),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((hd,), dtype=dt, device=device)
        p["k_norm"] = torch.ones((hd,), dtype=dt, device=device)
    if with_gate is None:
        with_gate = cfg.wgkv.enabled and kind != "enc"
    if with_gate:
        p["gate"] = init_gate(gen, cfg, device)
    return p


def _heads(x: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    """[B, S, n*hd] -> [B, n, S, hd]"""
    b, s, _ = x.shape
    return x.reshape(b, s, n, hd).transpose(1, 2)


def _qk_norm(p: Params, q, k):
    if "q_norm" in p:
        q = L.rmsnorm_nowt(q) * p["q_norm"].to(q.dtype)
        k = L.rmsnorm_nowt(k) * p["k_norm"].to(k.dtype)
    return q, k


def project_qkv(p: Params, cfg: ModelConfig, x: torch.Tensor,
                positions: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                           torch.Tensor]:
    """x: [B, S, D]; positions: [B, S] int, or [3, B, S] for an M-RoPE
    config (the (t, h, w) ids). Returns (q_rope [B,Hq,S,hd],
    k_pre [B,Hkv,S,hd], k_rope, v).

    On a mesh (``sharding.comm``) x enters the column-parallel ``w_q``
    (and ``w_k`` / ``w_v`` when the kv heads are split) through
    ``copy_to_model``, and under the "gather_q" plan every rank's q heads
    are assembled after ``w_q``: ``cfg`` is then the rank's local config
    and q comes back with every head."""
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    xq = comm.copy_to_model(x, "attn")
    xkv = xq if comm.heads_split() else x
    q = _heads(comm.gather_q(xq @ p["w_q"].to(x.dtype)), hq, hd)
    k_pre = _heads(xkv @ p["w_k"].to(x.dtype), hkv, hd)
    v = _heads(xkv @ p["w_v"].to(x.dtype), hkv, hd)
    q, k_pre = _qk_norm(p, q, k_pre)
    if cfg.mrope and positions.ndim == 3:
        pos3 = positions[:, :, None, :]      # [3, B, 1, S] over the heads
        return (L.apply_mrope(q, pos3, cfg.rope_theta), k_pre,
                L.apply_mrope(k_pre, pos3, cfg.rope_theta), v)
    if cfg.rope_theta > 0:
        posq = positions[:, None, :]
        return (L.apply_rope(q, posq, cfg.rope_theta), k_pre,
                L.apply_rope(k_pre, posq, cfg.rope_theta), v)
    return q, k_pre, k_pre, v


def compute_gates(p: Params, k_pre: torch.Tensor,
                  k_rope: torch.Tensor) -> torch.Tensor:
    """g: [B, Hkv, S] float32."""
    return gate_scores(p["gate"], k_pre, k_rope)


def _merge_heads(out: torch.Tensor) -> torch.Tensor:
    """[B, H, S, hd] -> [B, S, H*hd]"""
    b, h, s, hd = out.shape
    return out.transpose(1, 2).reshape(b, s, h * hd)


# ==========================================================================
# scaled-dot-product attention with optional query chunking
# ==========================================================================
def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         bias_fn: Callable[[int, int], torch.Tensor], *,
         q_chunk: Optional[int] = None) -> torch.Tensor:
    """q: [B,Hq,Sq,hd]; k, v: [B,Hkv,Sk,hd]. ``bias_fn(q_start, q_len)``
    returns an additive f32 bias broadcastable to [B,Hkv,G,q_len,Sk]
    (``masks.NEG_INF`` where disallowed). Chunking bounds the
    materialized score tensor for long sequences."""
    b, hq, sq, hd = q.shape
    hkv = k.shape[1]
    g = hq // hkv
    qg = q.reshape(b, hkv, g, sq, hd)
    scale = hd ** -0.5

    def block(q_blk: torch.Tensor, q_start: int, q_len: int) -> torch.Tensor:
        logits = torch.einsum("bhgqd,bhkd->bhgqk", q_blk, k).float()
        logits = logits * scale + bias_fn(q_start, q_len)
        w = torch.softmax(logits, dim=-1)
        return torch.einsum("bhgqk,bhkd->bhgqd", w.to(v.dtype), v)

    if q_chunk is None or q_chunk >= sq:
        out = block(qg, 0, sq)
    else:
        if sq % q_chunk:
            raise ValueError(f"q_chunk {q_chunk} must divide {sq}")
        out = torch.cat([block(qg[:, :, :, i:i + q_chunk], i, q_chunk)
                         for i in range(0, sq, q_chunk)], dim=3)
    return out.reshape(b, hq, sq, hd)


# ==========================================================================
# train-mode forward (teacher / write-gated student / hard eval)
# ==========================================================================
def attn_train(p: Params, cfg: ModelConfig, x: torch.Tensor,
               positions: torch.Tensor, *, gate_mode: str = "off",
               window: Optional[int] = None,
               gate_override: Optional[torch.Tensor] = None,
               q_chunk: Optional[int] = None
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """gate_mode: "off" (causal teacher, windowed when ``window`` is
    given), "gated" (the log-space write-gate bias; on CUDA the
    ``gated_flash`` kernel) or "hard" (binary vertical-slash mask at
    tau). ``window`` doubles as W_local in the gate bias. Returns
    (out [B, S, D], g [B, Hkv, S] or None).

    On a mesh the read runs the rank's heads (every q head under
    "gather_q", whose whole k, v and gates enter the read through
    ``copy_to_model``: each rank's gradient of them is its heads'
    part), and ``w_o``'s partials are summed over "model"."""
    b, s, _ = x.shape
    if gate_mode not in ("off", "gated", "hard"):
        raise ValueError(gate_mode)
    q, k_pre, k_rope, v = project_qkv(p, cfg, x, positions)
    g = None
    if gate_mode != "off":
        g = (gate_override if gate_override is not None
             else compute_gates(p, k_pre, k_rope))
    w_local = window if window is not None else cfg.wgkv.w_local
    k_read, v_read = (comm.copy_to_model(k_rope, "kv"),
                      comm.copy_to_model(v, "kv"))
    if gate_mode == "gated":
        out = ops.gated_flash_attention(q, k_read, v_read,
                                        comm.copy_to_model(g.float(), "kv"),
                                        w_local=w_local,
                                        eps=cfg.wgkv.log_eps)
    else:
        dev = x.device

        def bias_fn(q_start: int, q_len: int) -> torch.Tensor:
            if gate_mode == "hard":
                vis = M.vertical_slash_mask(g, cfg.wgkv.tau, q_len, w_local,
                                            q_start, sink=cfg.wgkv.sink)
                vis = vis[:, :, None]                  # [B, Hkv, 1, q, S]
            elif window is not None:
                vis = M.local_window_mask(q_len, s, w_local, q_start, dev)
            else:
                vis = M.causal_mask(q_len, s, q_start, dev)
            zero = torch.zeros((), dtype=torch.float32, device=dev)
            neg = torch.full((), M.NEG_INF, dtype=torch.float32, device=dev)
            return torch.where(vis, zero, neg)

        out = sdpa(q, k_read, v_read, bias_fn, q_chunk=q_chunk)
    return _out_proj(p, out), g


def _out_proj(p: Params, out: torch.Tensor) -> torch.Tensor:
    """[B, H, S, hd] -> [B, S, D] through ``w_o``: on a mesh this rank's
    heads' rows, their partials summed over "model"."""
    y = comm.local_q(_merge_heads(out)) @ p["w_o"].to(out.dtype)
    return comm.reduce_model(y, "attn")


# ==========================================================================
# budgeted vertical-slash prefill (production, sub-quadratic)
# ==========================================================================
class PrefillResult(NamedTuple):
    out: torch.Tensor          # [B, S, D]
    k_rope: torch.Tensor       # [B, Hkv, S, hd]
    v: torch.Tensor
    g: torch.Tensor            # [B, Hkv, S]
    sel: GlobalSelection


def attn_prefill_budgeted(p: Params, cfg: ModelConfig, x: torch.Tensor,
                          positions: torch.Tensor, *, budget: int,
                          window: Optional[int] = None,
                          gate_override: Optional[torch.Tensor] = None
                          ) -> PrefillResult:
    """Vertical-slash attention (paper §4.2), budgeted for static shapes.

    Every query attends to its local window of width W (``window`` for
    ``local_attn`` blocks, else ``cfg.wgkv.w_local``: the slash) and to up
    to ``budget`` admitted tokens (g >= tau, sinks always) strictly older
    than the window (the vertical), in one softmax. The admitted keys/values are gathered
    here, outside the kernel; unused budget slots get ``gpos = INT32_MAX``
    and are never visible. The kernel tiles the queries itself, so the
    reference's ``block_chunk`` (a memory bound on its dense einsum) has
    no counterpart."""
    b, s, _ = x.shape
    w = window if window is not None else cfg.wgkv.w_local
    if s % w:
        raise ValueError(f"seq {s} must be a multiple of the window {w}")
    q, k_pre, k_rope, v = project_qkv(p, cfg, x, positions)
    g = (gate_override if gate_override is not None
         else compute_gates(p, k_pre, k_rope))
    # the top-budget choice is per kv head: on a mesh each rank chooses
    # for its own heads, with no collective
    sel = select_global(g, budget=budget, tau=cfg.wgkv.tau,
                        sink=cfg.wgkv.sink, exclude_from=s - min(w, s))
    hkv = cfg.n_kv_heads
    bi = torch.arange(b, device=x.device)[:, None, None]
    hi = torch.arange(hkv, device=x.device)[None, :, None]
    idx = sel.idx.long()
    kg = k_rope[bi, hi, idx]                                   # [B,Hkv,C,hd]
    vg = v[bi, hi, idx]
    gpos = torch.where(sel.valid, sel.idx,
                       torch.full_like(sel.idx, torch.iinfo(torch.int32).max))
    out = ops.vertical_slash_attention(q, k_rope, v, kg, vg, gpos, w_local=w)
    return PrefillResult(_out_proj(p, out), k_rope, v, g, sel)


def attn_prefill_full(p: Params, cfg: ModelConfig, x: torch.Tensor,
                      positions: torch.Tensor, *,
                      window: Optional[int] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full-attention baseline prefill: causal attention, windowed when
    ``window`` is given. Returns (out [B, S, D], k_rope [B, Hkv, S, hd],
    v). The causal form runs ``ops.causal_attention`` (on CUDA the
    ``gated_flash`` kernel with every key in its window), the windowed
    form ``ops.windowed_causal_attention`` (its hard-window mode). The
    reference's ``q_chunk`` (a memory bound on its dense einsum) has no
    counterpart: the kernel tiles the queries itself."""
    q, _, k_rope, v = project_qkv(p, cfg, x, positions)
    if window is None:
        out = ops.causal_attention(q, k_rope, v)
    else:
        out = ops.windowed_causal_attention(q, k_rope, v, window)
    return _out_proj(p, out), k_rope, v


# ==========================================================================
# decode
# ==========================================================================
def _rope_single(cfg: ModelConfig, x: torch.Tensor,
                 t: torch.Tensor) -> torch.Tensor:
    """x: [B, H, hd] at per-batch position t [B]."""
    if cfg.rope_theta <= 0:
        return x
    return L.apply_rope(x[:, :, None, :], t[:, None, None],
                        cfg.rope_theta)[:, :, 0]


def attn_decode_wgkv(p: Params, cfg: ModelConfig, x_t: torch.Tensor,
                     cache: DualCache, *,
                     gate_override: Optional[torch.Tensor] = None,
                     token_select_fn: Optional[Callable] = None,
                     select_pages_k: Optional[int] = None
                     ) -> Tuple[torch.Tensor, DualCache, torch.Tensor,
                                Optional[torch.Tensor]]:
    """One decode step against the dual cache. x_t: [B, D].

    The cache is updated FIRST (the victim at age W promoted iff
    admitted, the new token written into the ring), then attention runs
    over the updated cache, so the just-written token is visible — the
    reference's order (``attention.py:393-394``).

    Read-time Selection (Quest, paper §5.4) restricts the global segment
    of the read to some of its pages; the ring is always read whole:

    * ``select_pages_k`` (gather): score the cache's incremental page
      metadata against the live query and read only the top-K pages.
      With K covering every page the ascending ids are the identity and
      the output is bitwise equal to the full read.
    * ``token_select_fn(cache, q) -> [B, Hkv, P] bool`` (mask): the
      global pages to read. The reference's callable returns a token
      mask and masks a full-width read; the port's returns the page mask
      it is made of (``inference._quest_mask``) and reads the selected
      pages through the same kernel as gather mode.

    The two are exclusive, and both need a page-aligned global budget.

    On a seq-sharded cache (``comm.seq_block``: this rank holds block i
    of the global axis) the rank whose block holds the victim's slot
    promotes it, every rank reads its block (the ring on block 0 only)
    and the reads are combined by their log-sum-exp
    (``comm.combine_lse``). Under selection every rank scores the whole
    page metadata alike and takes the same global ids, and reads those
    its block holds (whole pages in each block).

    Returns (out [B, D], new cache, g_new [B, Hkv], sel_pages) where
    sel_pages is [B, Hkv] int32 valid selected-page counts of the gather
    mode (None otherwise)."""
    b, _ = x_t.shape
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    x = x_t[:, None, :]
    q = _heads(comm.gather_q(x @ p["w_q"].to(x.dtype)), hq, hd)[:, :, 0]
    k_pre = _heads(x @ p["w_k"].to(x.dtype), hkv, hd)[:, :, 0]
    v_new = _heads(x @ p["w_v"].to(x.dtype), hkv, hd)[:, :, 0]
    q, k_pre = _qk_norm(p, q[:, :, None], k_pre[:, :, None])
    q, k_pre = q[:, :, 0], k_pre[:, :, 0]
    q = _rope_single(cfg, q, cache.t)
    k_new = _rope_single(cfg, k_pre, cache.t)
    if gate_override is not None:
        g_new = gate_override
    else:
        g_new = gate_scores(p["gate"], k_pre[:, :, None],
                            k_new[:, :, None])[..., 0]
    # context-parallel decode (a seq-sharded cache): this rank's block of
    # the global axis, read and combined with the other data ranks'
    block = comm.seq_block()
    new_cache = lazy_promote_and_write(cache, k_new, v_new, g_new,
                                       tau=cfg.wgkv.tau, block=block)
    sel_pages = None
    if select_pages_k is None and token_select_fn is None:
        o = ops.dual_cache_attention(q, new_cache, block)        # [B,Hq,hd]
    else:
        if select_pages_k is not None and token_select_fn is not None:
            raise ValueError("mask and gather selection are exclusive")
        c = new_cache.budget
        if c % SEL.PAGE_SIZE:
            raise ValueError(f"Quest selection needs a page-aligned global "
                             f"budget (each block of a seq-sharded one "
                             f"page-aligned), got C={c}")
        # the page metadata is whole on every rank (and advances alike),
        # so every rank scores every page and takes the same ids
        pages = new_cache.pkmin.shape[2]
        if select_pages_k is not None:
            meta = SEL.PageMeta(
                new_cache.pkmin, new_cache.pkmax,
                SEL.page_valid_from_count(new_cache.gcnt, pages))
            ids, sel_pages = SEL.topk_page_ids(q, meta, select_pages_k)
            n_sel = sel_pages
        else:
            ids, n_sel = SEL.page_ids_from_mask(token_select_fn(new_cache, q))
        o = ops.dual_cache_selected_attention(q, new_cache, ids, n_sel,
                                              block)
    if block is not None:
        o = comm.combine_lse(*o)
    y = comm.reduce_model(
        comm.local_q(o.reshape(b, hq * hd)) @ p["w_o"].to(x_t.dtype), "attn")
    return y, new_cache, g_new, sel_pages


def attn_decode_dense(p: Params, cfg: ModelConfig, x_t: torch.Tensor,
                      cache: DenseCache, *, window: Optional[int] = None,
                      limit: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, DenseCache]:
    """Full-attention baseline decode step. x_t: [B, D]. The new token is
    appended first, then one query per head reads the cache's first
    ``t`` tokens (the last ``window`` of them when given, from a start
    offset on the same kernel) — the reference's order. ``limit`` [B]
    int: per row, the capacity of the reference's buffer: a row at ``t >=
    limit`` writes nothing, and every row reads at most ``limit`` entries,
    as the reference's ``where`` append and read over a buffer of that
    size do (the ragged scan's masked rows; its active rows pass
    ``INT32_MAX``); a window still starts ``window`` before ``t``. A
    masked row whose window lies wholly at or past ``limit`` reads no key;
    it returns the mean of V over its ``limit`` entries, as the
    reference's softmax over no valid key does (``ops.dense_cache_attention``).
    On a seq-sharded buffer (``comm.seq_block``) the rank whose block
    holds position ``t`` writes it, every rank reads its block (length
    and window clipped to it) and the reads are combined by their
    log-sum-exp; a window may straddle two blocks. Returns (out [B, D],
    new cache)."""
    b, _ = x_t.shape
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    x = x_t[:, None, :]
    q = _heads(comm.gather_q(x @ p["w_q"].to(x.dtype)), hq, hd)[:, :, 0]
    k_pre = _heads(x @ p["w_k"].to(x.dtype), hkv, hd)[:, :, 0]
    v_new = _heads(x @ p["w_v"].to(x.dtype), hkv, hd)[:, :, 0]
    q, k_pre = _qk_norm(p, q[:, :, None], k_pre[:, :, None])
    q, k_pre = q[:, :, 0], k_pre[:, :, 0]
    q = _rope_single(cfg, q, cache.t)
    k_new = _rope_single(cfg, k_pre, cache.t)
    # context-parallel decode (a seq-sharded buffer): the rank whose
    # block holds position t writes it, every rank reads its block, and
    # the reads are combined with the other data ranks'
    block = comm.seq_block()
    write = None if limit is None else cache.t < limit
    cache = dense_cache_append(cache, k_new, v_new, write=write, block=block)
    end = None if limit is None else torch.minimum(cache.t, limit)
    o = ops.dense_cache_attention(q, cache, window=window, end=end,
                                  block=block)
    if block is not None:
        o = comm.combine_lse(*o)
    y = comm.reduce_model(
        comm.local_q(o.reshape(b, hq * hd)) @ p["w_o"].to(x_t.dtype), "attn")
    return y, cache


# ==========================================================================
# cross-attention (the whisper decoder), with admission on the encoder
# memory; the bidirectional encoder
# ==========================================================================
class CrossCache(NamedTuple):
    k: torch.Tensor       # [B, Hkv, S_enc or budget, hd]
    v: torch.Tensor
    valid: torch.Tensor   # [B, Hkv, S] bool


def build_cross_cache(p: Params, cfg: ModelConfig, enc_out: torch.Tensor,
                      *, budget: Optional[int] = None) -> CrossCache:
    """The cross-attention K/V of the encoder output [B, S_enc, D]. Given
    ``budget`` (below S_enc) and a gate, the write gate scores the encoder
    keys (no RoPE: the pre- and post-RoPE features are the same keys) and
    only the top-``budget`` admitted tokens are kept, sinks first
    (``select_global``): WG-KV on the cross stream. On CUDA the gate runs
    in the ``gate_mlp`` kernel. On a mesh whose plan splits the kv heads
    the rank builds its heads' memory (its ``w_k`` / ``w_v`` columns and
    gate slice; the top-``budget`` choice is per head, so it is the
    whole memory's for those heads); else every head's. No gradient
    reaches it (the encoder is frozen), so it takes no autograd seam."""
    b, s, _ = enc_out.shape
    hkv, hd = cfg.n_kv_heads, cfg.head_dim
    k = _heads(enc_out @ p["w_k"].to(enc_out.dtype), hkv, hd)
    v = _heads(enc_out @ p["w_v"].to(enc_out.dtype), hkv, hd)
    if budget is not None and "gate" in p and budget < s:
        g = gate_scores(p["gate"], k, k)
        sel = select_global(g, budget=budget, tau=cfg.wgkv.tau,
                            sink=cfg.wgkv.sink)
        bi = torch.arange(b, device=k.device)[:, None, None]
        hi = torch.arange(hkv, device=k.device)[None, :, None]
        idx = sel.idx.long()
        return CrossCache(k[bi, hi, idx], v[bi, hi, idx], sel.valid)
    return CrossCache(k, v, torch.ones((b, hkv, s), dtype=torch.bool,
                                       device=k.device))


def attn_cross(p: Params, cfg: ModelConfig, x: torch.Tensor,
               cc: CrossCache) -> torch.Tensor:
    """x: [B, Sq, D], the decoder stream, attending to the (possibly
    budgeted) encoder memory: plain PyTorch on either device, as the
    reference computes it outside any Pallas kernel. On a mesh the read
    runs the rank's heads (every q head under "gather_q", over the whole
    memory) and ``w_o``'s partials are summed over "model", as
    :func:`attn_train`'s; x enters ``w_q`` through ``copy_to_model`` (in
    training it carries the gated self-attention's gradient)."""
    b, sq, _ = x.shape
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    xq = comm.copy_to_model(x, "attn")
    q = _heads(comm.gather_q(xq @ p["w_q"].to(x.dtype)), hq, hd)
    qg = q.reshape(b, hkv, hq // hkv, sq, hd)
    logits = torch.einsum("bhgqd,bhkd->bhgqk", qg, cc.k).float()
    logits = logits * (hd ** -0.5)
    logits = torch.where(cc.valid[:, :, None, None], logits,
                         torch.full_like(logits, M.NEG_INF))
    w = torch.softmax(logits, dim=-1)
    o = torch.einsum("bhgqk,bhkd->bhgqd", w.to(cc.v.dtype), cc.v)
    return _out_proj(p, o.reshape(b, hq, sq, hd))


def attn_encoder(p: Params, cfg: ModelConfig, x: torch.Tensor
                 ) -> torch.Tensor:
    """Bidirectional encoder self-attention (whisper) through the plain
    :func:`sdpa`, no mask and no RoPE; on a mesh over the rank's heads as
    :func:`attn_cross` (the encoder is frozen: no autograd seam)."""
    s = x.shape[1]
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = _heads(comm.gather_q(x @ p["w_q"].to(x.dtype)), hq, hd)
    k = _heads(x @ p["w_k"].to(x.dtype), hkv, hd)
    v = _heads(x @ p["w_v"].to(x.dtype), hkv, hd)
    zero = torch.zeros((1, 1, 1, 1, s), dtype=torch.float32, device=x.device)
    out = sdpa(q, k, v, lambda qs, ql: zero)
    return _out_proj(p, out)
