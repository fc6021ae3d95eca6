"""Logical-axis sharding rules with divisibility fallback (port of
``repro/sharding/rules.py``), and the port's placement on them.

Mesh axes: ("data", "model") on one host, ("pod", "data", "model") across
pods. "model" is tensor parallelism (attention heads, d_ff, experts);
"data" (with "pod") batches and, in training, shards weights FSDP-style.
A dimension is sharded only when its axis size divides it; otherwise the
rule falls back to its next preference, or to replication.

The rules are pure functions of a leaf's path and shape and a mesh
shape, given as ``{"data": d, "model": m}`` (``{"pod": p, "data": d,
"model": m}`` across pods) or any object with such a ``shape``. A spec is
a tuple with one entry per dimension: ``None`` (replicated), an axis name,
or a tuple of axis names, the entries of the reference's
``PartitionSpec``.

The reference's activation pinning (``activation_sharding``,
``constrain_tokens``, ``constrain_moe``) is not ported: it is a layout
hint to XLA's partitioner, and eager PyTorch has no partitioner to hint.

**The port's placement** (:func:`tp_plan`, :func:`local_config`,
:func:`local_params`) follows the spec with ``replicate_fsdp=True``, as
the reference's serving and its weights-stationary decode do, or, for
the training and prefill bundles, with the FSDP axes too
(``replicate_fsdp=False``: every "data" / ("pod", "data") entry of the
reference's spec, so each rank holds its "data" block of a backbone leaf
and the model assembles a layer's leaves just before it runs,
``sharding.comm.gather_params``). Its "model" entries go leaf by leaf
on the leaves that carry tensor parallelism: ``w_q`` / ``w_k`` / ``w_v`` column-parallel by whole
heads, ``w_o`` row-parallel (self attention, whisper's cross attention
and its encoder alike), the dense FFN's ``w_gate`` / ``w_up``
column-parallel and ``w_down`` row-parallel, the GELU MLP's ``w_in``
column-parallel with its bias ``b_in`` and ``w_out`` row-parallel (its
``b_out`` whole, added once after the sum), the MoE block's expert
leaves by expert or, where the experts do not divide, by the expert FFN
width (:func:`moe_split`; the router whole on every rank), and the
RG-LRU block's leaves by channel, its 1-D leaves too (:func:`rec_split`,
whose gate blocks must divide with the channels), and the xLSTM blocks'
leaves by head (:func:`xlstm_split`): the mLSTM's up-projections, conv
and ``w_q`` / ``w_k`` / ``w_v`` columns, ``w_down`` rows; the sLSTM's
``w_in`` and ``b`` by head within each of their four gate blocks
(:func:`gate_parts`; the reference's spec splits the 4D axis
contiguously), its block-diagonal ``r`` by head and its gated MLP over
its width. Each rank holds its block
as a plain local tensor (:func:`local_shard`); the model adds the
row-parallel partials with ``sharding.comm.reduce_model``. Leaves the
reference splits only by inserting another collective stay whole on
every rank: the embedding's d_model, a 1-D leaf of 4,096 or more, and
the row-parallel fallback of q/k/v over d_model. The write gate, which
the reference replicates, is sliced by the rank's kv heads: the kernel
picks weights by ``row % H``, so the local slice computes what the whole
gate computes for those heads. It is never held in "data" blocks, and
its optimizer state follows it. Two more placements differ from the
spec the same way: ``b_in`` follows ``w_in``'s columns at every size
(the reference splits a 1-D leaf only from 4,096, so a rank would
otherwise add the whole bias to its columns' slice), the cross
cache's ``valid`` [B, H, S], which the reference's generic rule keeps
whole over "model", is sliced by the rank's kv heads as its ``k`` and
``v`` are, and an xLSTM block that splits holds its heads' share of the
leaves the spec keeps whole: the mLSTM's ``w_i`` / ``w_f`` columns,
``b_i`` / ``b_f`` and ``out_norm``, and every leaf of its recurrent
state (the mLSTM's ``n`` and ``m``, the sLSTM's ``c``, ``n`` and ``m``).

Under ``seq_shard`` (a decode batch narrower than the batch axes, the
reference's long_500k) a cache's global token axis (``gk``, ``gv``,
``gpos``; the dense baseline's buffer ``k``, ``v``) goes over "data" and
the ring and the page metadata stay whole (:func:`local_caches`): the
context-parallel decode of ``models/attention.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Sequence, Tuple

import torch

from repro_torch.configs.base import ATTN_BLOCKS, ModelConfig
from repro_torch.tree import tree_map_with_path

Spec = Tuple[Any, ...]
# the block types the port runs on a mesh: GQA attention (global or
# windowed) with a dense FFN, with the MoE FFN, the RG-LRU block,
# whisper's decoder block (self and cross attention, a GELU MLP) and
# encoder block, and the xLSTM's mLSTM and sLSTM blocks
MESH_BLOCKS = ("attn", "local_attn", "attn_moe", "rglru", "attn_cross",
               "enc_attn", "mlstm", "slstm")
XLSTM_BLOCKS = ("mlstm", "slstm")
# the blocks whose FFN is dense, the SwiGLU or the GELU MLP (``plan.ffn``
# splits its d_ff)
DENSE_FFN_BLOCKS = ("attn", "local_attn", "rglru", "attn_cross", "enc_attn")


def mesh_shape(mesh) -> Dict[str, int]:
    """``{"data": d, "model": m}`` of a mesh, or the mapping itself."""
    return dict(getattr(mesh, "shape", mesh))


def fsdp_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in mesh_shape(mesh) if a in ("pod", "data"))


def batch_axes(mesh) -> Tuple[str, ...]:
    return fsdp_axes(mesh)


def _axsize(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    shape = mesh_shape(mesh)
    n = 1
    for a in axes:
        n *= shape[a]
    return n


def _fits(dim: int, mesh, axes) -> bool:
    return dim % _axsize(mesh, axes) == 0


def pick(dim: int, mesh, *prefs):
    """First preference (an axis name, tuple of names, or None) that divides
    ``dim``; None (replicate) if none fit."""
    for p in prefs:
        if p is None:
            return None
        if _fits(dim, mesh, p):
            return p
    return None


def _spec(entries) -> Spec:
    """A spec as ``PartitionSpec`` keeps it: a one-axis tuple is its
    name."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in entries)


# ==========================================================================
# parameter specs (path-based; mirrors models/* param trees)
# ==========================================================================
def _param_spec(path: Tuple[str, ...], shape: Tuple[int, ...], mesh,
                cfg: ModelConfig) -> Spec:
    fa = fsdp_axes(mesh)
    name = path[-1]
    # stacked super-block params carry a leading n_repeats axis
    stacked = "blocks" in path
    lead = (None,) if stacked else ()
    core = shape[1:] if stacked else shape

    def spec(*dims):
        return _spec(lead + dims)

    if len(core) == 0:
        return spec()
    if "gate" in path:
        # Write-Gate MLP: tiny (~0.4% params) — replicated by the rule
        return spec(*(None,) * len(core))
    if name in ("tok", "unembed"):
        v_or_d, d_or_v = core
        return spec(pick(v_or_d, mesh, fa, "data"), pick(d_or_v, mesh, "model"))
    if name in ("w_q", "w_k", "w_v"):
        din, dout = core
        # column-parallel over whole heads when the HEAD COUNT divides;
        # else row-parallel on d_model
        heads = cfg.n_heads if name == "w_q" else cfg.n_kv_heads
        out_ax = "model" if (_fits(heads, mesh, "model")
                             and _fits(dout, mesh, "model")) else None
        in_ax = pick(din, mesh, fa, "data") if out_ax else pick(din, mesh, "model", fa)
        if out_ax and in_ax == out_ax:
            in_ax = None
        return spec(in_ax, out_ax)
    if name == "w_o":
        din, dout = core
        in_ax = "model" if (_fits(cfg.n_heads, mesh, "model")
                            and _fits(din, mesh, "model")) else None
        out_ax = pick(dout, mesh, fa, "data")
        return spec(in_ax, out_ax)
    if name in ("w_gate", "w_up", "w_down", "router") and "moe" in path:
        if name == "router":
            d, e = core
            return spec(pick(d, mesh, fa), pick(e, mesh, "model"))
        e, a, b = core
        e_ax = pick(e, mesh, "model")
        if e_ax:
            return spec(e_ax, pick(a, mesh, fa), None)
        # experts not divisible (granite 40e): shard the expert FFN width
        if name == "w_down":
            return spec(None, pick(a, mesh, "model"), pick(b, mesh, fa))
        return spec(None, pick(a, mesh, fa), pick(b, mesh, "model"))
    if name in ("w_gate", "w_up"):        # dense SwiGLU
        d, f = core
        return spec(pick(d, mesh, fa, "data"), pick(f, mesh, "model"))
    if name == "w_down":
        f, d = core
        return spec(pick(f, mesh, "model"), pick(d, mesh, fa, "data"))
    if name in ("w_in",):                  # gelu mlp / slstm input
        d, f = core
        return spec(pick(d, mesh, fa, "data"), pick(f, mesh, "model"))
    if name == "w_out" and len(core) == 2:
        f, d = core
        return spec(pick(f, mesh, "model"), pick(d, mesh, fa, "data"))
    if name in ("w_gelu", "w_x", "w_up_x", "w_up_z", "w_up1", "w_up2"):
        d, f = core
        return spec(pick(d, mesh, fa, "data"), pick(f, mesh, "model"))
    if name in ("conv",):
        cw, dr = core
        return spec(None, pick(dr, mesh, "model"))
    if name in ("w_r", "w_i") and len(core) == 3:  # rglru block-diag [H,dh,dh]
        h, dh, _ = core
        return spec(pick(h, mesh, "model"), None, None)
    if name == "r" and len(core) == 4:     # slstm recurrent [4,H,dh,dh]
        _, h, dh, _ = core
        return spec(None, pick(h, mesh, "model"), None, None)
    if len(core) == 2 and min(core) >= 512:
        a, b = core
        return spec(pick(a, mesh, fa, "data"), pick(b, mesh, "model"))
    if len(core) == 1 and core[0] >= 4096:
        return spec(pick(core[0], mesh, "model"))
    return spec(*(None,) * len(core))


def _strip_fsdp(spec: Spec) -> Spec:
    """Drop the FSDP ("data"/"pod") axes from a spec: weights replicated
    across data, sharded only over "model"."""
    def fix(ax):
        if ax is None:
            return None
        axes = (ax,) if isinstance(ax, str) else tuple(ax)
        kept = tuple(a for a in axes if a == "model")
        return kept[0] if len(kept) == 1 else (kept if kept else None)
    return tuple(fix(a) for a in spec)


def param_shardings(params: Any, mesh, cfg: ModelConfig, *,
                    replicate_fsdp: bool = False) -> Any:
    """Spec tree matching ``params``. ``replicate_fsdp`` drops the FSDP
    axes from every spec (the serving placement: weights replicated
    across "data", sharded only over "model")."""
    def walk(path, leaf):
        spec = _param_spec(tuple(str(k) for k in path), tuple(leaf.shape),
                           mesh, cfg)
        return _strip_fsdp(spec) if replicate_fsdp else spec
    return tree_map_with_path(walk, params)


# ==========================================================================
# activation / cache specs
# ==========================================================================
def replicate_params(cfg: ModelConfig, mesh) -> bool:
    """The reference's weights-stationary rule for a decode step: the
    weights replicated over "data" when the model-sharded params (2 bytes
    each) fit 4 GiB a chip, which takes the per-step FSDP gathers away."""
    ways = mesh_shape(mesh).get("model", 1)
    return cfg.param_count() * 2 / ways / 2 ** 30 <= 4.0


def seq_shard(mesh, batch: int) -> bool:
    """Whether a decode batch of ``batch`` rows is narrower than the batch
    axes (the reference's long_500k): its caches' global token axis then
    goes over "data" (:func:`cache_placement`)."""
    return batch < _axsize(mesh, batch_axes(mesh))


def tokens_spec(mesh, batch: int, extra_dims: int = 1) -> Spec:
    ba = pick(batch, mesh, batch_axes(mesh), "data")
    return _spec((ba,) + (None,) * extra_dims)


def _cache_leaf_spec(path: Tuple[str, ...], shape, mesh, cfg: ModelConfig,
                     seq_shard: bool) -> Spec:
    """Cache trees: DualCache/DenseCache/recurrent states, possibly stacked
    with a leading n_repeats axis. When ``seq_shard`` (long_500k, batch=1)
    the long token axis goes to "data" (context-parallel decode)."""
    fa = batch_axes(mesh)
    if "obs" in path:
        # eviction observation windows: [n_repeats, n_attn, B, ...] (q ring)
        # or [n_repeats, n_attn, B] (counter)
        core = tuple(shape[2:])
        if not core:
            return (None, None)
        b_ax = pick(core[0], mesh, fa, "data")
        if len(core) >= 2:
            return _spec((None, None, b_ax, pick(core[1], mesh, "model"),
                          *(None,) * (len(core) - 2)))
        return _spec((None, None, b_ax))
    stacked = "blocks" in path
    lead = (None,) if stacked else ()
    core = tuple(shape[1:]) if stacked else tuple(shape)

    def spec(*dims):
        return _spec(lead + dims)

    if len(core) == 0:
        return spec()
    b_ax = pick(core[0], mesh, fa, "data")
    name = path[-1]
    if name in ("gk", "gv", "k", "v") and len(core) == 4:
        _, h, s, hd = core
        if b_ax is None and seq_shard:
            return spec(None, pick(h, mesh, "model"), pick(s, mesh, "data"), None)
        return spec(b_ax, pick(h, mesh, "model"), None, None)
    if name in ("pkmin", "pkmax") and len(core) == 4:
        _, h, p_pages, hd = core
        return spec(b_ax, pick(h, mesh, "model"), None, None)
    if name in ("gpos",) and len(core) == 3:
        _, h, s = core
        if b_ax is None and seq_shard:
            return spec(None, pick(h, mesh, "model"), pick(s, mesh, "data"))
        return spec(b_ax, pick(h, mesh, "model"), None)
    if name in ("lk", "lv") and len(core) == 4:
        _, h, w, hd = core
        return spec(b_ax, pick(h, mesh, "model"), None, None)
    if name in ("lg",) and len(core) == 3:
        return spec(b_ax, pick(core[1], mesh, "model"), None)
    if name == "c" and len(core) == 4:  # mLSTM matrix memory [B,H,dh,dh]
        return spec(b_ax, pick(core[1], mesh, "model"), None, None)
    if name == "conv" and len(core) == 3:  # [B,cw-1,dr]
        return spec(b_ax, None, pick(core[2], mesh, "model"))
    if name == "h" and len(core) == 2:  # rglru state [B,dr]
        return spec(b_ax, pick(core[1], mesh, "model"))
    if len(core) >= 2:
        return spec(b_ax, *(None,) * (len(core) - 1))
    return spec(b_ax)


def cache_shardings(caches: Any, mesh, cfg: ModelConfig, *,
                    seq_shard: bool = False) -> Any:
    return tree_map_with_path(
        lambda path, leaf: _cache_leaf_spec(
            tuple(str(k) for k in path), tuple(leaf.shape), mesh, cfg,
            seq_shard), caches)


# ==========================================================================
# blocks of a spec: GSPMD's order, the contiguous block of each split dim
# ==========================================================================
def _axes_of(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def shard_shape(shape: Sequence[int], spec: Spec, mesh) -> Tuple[int, ...]:
    """The shape of one device's block of a leaf of ``shape`` under
    ``spec``."""
    out = []
    for i, dim in enumerate(shape):
        n = _axsize(mesh, _axes_of(spec[i]) or None) if i < len(spec) else 1
        if dim % n:
            raise ValueError(f"dim {i} of {tuple(shape)} does not divide "
                             f"over {spec[i]!r} ({n} ways)")
        out.append(dim // n)
    return tuple(out)


def block(dim: int, entry, coords: Mapping[str, int], mesh) -> slice:
    """The part of a dimension of size ``dim`` that the device at
    ``coords`` (``{"data": i, "model": j}``) holds under one spec entry:
    the contiguous block, indexed row-major over the entry's axes, as
    GSPMD lays it out."""
    axes = _axes_of(entry)
    idx = 0
    for a in axes:
        idx = idx * mesh_shape(mesh)[a] + coords[a]
    n = dim // _axsize(mesh, axes or None)
    return slice(idx * n, (idx + 1) * n)


def local_shard(x: torch.Tensor, spec: Spec, coords: Mapping[str, int],
                mesh, parts: int = 1) -> torch.Tensor:
    """The block of ``x`` that the device at ``coords`` holds under
    ``spec`` (:func:`block` of each split dimension). A fresh contiguous
    tensor (the whole leaf can be freed). ``parts``: the last dimension
    holds that many equal parts (:func:`gate_parts`), and its spec entry
    splits each of them alike: the device's block of every part, in
    order."""
    if parts > 1 and _axes_of(spec[-1]):
        y = x.reshape(tuple(x.shape[:-1]) + (parts, x.shape[-1] // parts))
        y = local_shard(y, tuple(spec[:-1]) + (None, spec[-1]), coords,
                        mesh)
        return y.reshape(tuple(y.shape[:-2]) + (-1,))
    out = x
    for i, entry in enumerate(spec):
        if _axes_of(entry):
            b = block(out.shape[i], entry, coords, mesh)
            out = out.narrow(i, b.start, b.stop - b.start)
    return out.contiguous() if out is not x else x


def cache_blocks(cfg: ModelConfig, slots: int, mesh,
                 coords: Mapping[str, int]) -> Tuple[slice, slice]:
    """(rows, kv heads) of the device at ``coords``: its block of a
    batched dual cache's keys ``[n_repeats, slots, kv heads, S, hd]``
    under :func:`_cache_leaf_spec`, the block every leaf of a serving
    cache tree follows."""
    shape = (cfg.n_repeats, slots, cfg.n_kv_heads, 1, cfg.head_dim)
    spec = _cache_leaf_spec(("blocks", "b0", "gk"), shape, mesh, cfg, False)
    return (block(slots, spec[1], coords, mesh),
            block(cfg.n_kv_heads, spec[2], coords, mesh))


# ==========================================================================
# the port's tensor-parallel placement
# ==========================================================================
@dataclasses.dataclass(frozen=True)
class TPPlan:
    """What one rank of a "model" axis of ``ways`` computes.

    ``attn``: "split" (q and kv heads both divide: each rank holds
    ``n_heads / ways`` q heads and ``n_kv_heads / ways`` kv heads, the
    matching dual caches, and adds its ``w_o`` partial), "gather_q" (the q
    heads divide, the kv heads do not: ``w_q`` and ``w_o`` split, the kv
    projections, gate and caches whole on every rank; the q heads are
    gathered, every rank reads every head, and each multiplies its own
    heads' outputs by its ``w_o`` rows), or "whole" (nothing split, no
    sum). ``ffn``: the dense FFN's d_ff divides (``w_gate`` / ``w_up``
    columns, ``w_down`` rows, partials added). ``moe``: the MoE FFN's
    split (:func:`moe_split`): "experts" (the rank holds experts
    :attr:`experts`), "width" (every expert's ``expert_d_ff`` columns and
    rows split) or "whole"; the router is whole on every rank either way.
    ``rec``: the RG-LRU block's channels split (:func:`rec_split`).
    ``xlstm``: the xLSTM blocks split by head and the sLSTM's gated MLP
    by its width (:func:`xlstm_split`; the rank's heads are
    :attr:`xlstm_heads`)."""
    ways: int = 1
    index: int = 0
    attn: str = "whole"
    ffn: bool = False
    n_heads: int = 0
    n_kv_heads: int = 0
    moe: str = "whole"
    n_experts: int = 0
    rec: bool = False
    xlstm: bool = False

    @property
    def q_heads(self) -> Tuple[int, int]:
        """(first, count) of this rank's q heads of ``w_q`` / ``w_o``."""
        if self.attn == "whole":
            return 0, self.n_heads
        n = self.n_heads // self.ways
        return self.index * n, n

    @property
    def kv_heads(self) -> Tuple[int, int]:
        """(first, count) of this rank's kv heads: its caches and gate."""
        if self.attn != "split":
            return 0, self.n_kv_heads
        n = self.n_kv_heads // self.ways
        return self.index * n, n

    @property
    def xlstm_heads(self) -> Tuple[int, int]:
        """(first, count) of this rank's heads of an xLSTM block (all of
        them unless the plan splits the blocks)."""
        if not self.xlstm:
            return 0, self.n_heads
        n = self.n_heads // self.ways
        return self.index * n, n

    @property
    def experts(self) -> Tuple[int, int]:
        """(first, count) of this rank's experts (all of them unless the
        plan splits the experts)."""
        if self.moe != "experts":
            return 0, self.n_experts
        n = self.n_experts // self.ways
        return self.index * n, n


def check_mesh_arch(cfg: ModelConfig) -> None:
    """Raises for a block type the mesh does not take (every registered
    arch's are in :data:`MESH_BLOCKS`)."""
    odd = sorted({b for b in _blocks(cfg) + tuple(cfg.enc_block_pattern)
                  if b not in MESH_BLOCKS})
    if odd:
        raise NotImplementedError(
            f"{cfg.name}: the mesh takes GQA attention (M-RoPE and cross "
            "attention included), MoE, RG-LRU, encoder and xLSTM blocks, "
            f"not {', '.join(odd)}")


def _blocks(cfg: ModelConfig) -> Tuple[str, ...]:
    return tuple(cfg.stem_pattern) + tuple(cfg.block_pattern)


def moe_split(cfg: ModelConfig, mesh) -> str:
    """The reference's spec of the expert leaves on ``mesh``'s "model"
    axis: "experts" when the expert count divides it, else "width" when
    ``expert_d_ff`` does (granite's 40 experts at 16 ways), else
    "whole"."""
    if cfg.moe is None or "attn_moe" not in _blocks(cfg) or \
            mesh_shape(mesh).get("model", 1) == 1:
        return "whole"
    if _fits(cfg.moe.n_experts, mesh, "model"):
        return "experts"
    return "width" if _fits(cfg.moe.expert_d_ff, mesh, "model") else "whole"


def rglru_width(cfg: ModelConfig) -> int:
    """The RG-LRU recurrence width dr."""
    return int(cfg.rglru_expand * cfg.d_model)


def rec_split(cfg: ModelConfig, mesh) -> bool:
    """Whether the RG-LRU channels split over "model": dr and the
    block-diagonal gates' block count (``cfg.n_heads``) both divide it,
    so each rank holds whole gate blocks of its channels."""
    return ("rglru" in _blocks(cfg)
            and mesh_shape(mesh).get("model", 1) > 1
            and _fits(rglru_width(cfg), mesh, "model")
            and _fits(cfg.n_heads, mesh, "model"))


def mlstm_width(cfg: ModelConfig) -> int:
    """The mLSTM's up-projected width dm."""
    return int(cfg.xlstm_proj_factor * cfg.d_model)


def slstm_mlp_width(cfg: ModelConfig) -> int:
    """The sLSTM's post-cell gated MLP width (projection factor 4/3)."""
    return int(cfg.d_model * 4 / 3 / 2) * 2


def xlstm_split(cfg: ModelConfig, mesh) -> bool:
    """Whether the xLSTM blocks split by head over "model": the head
    count divides it, and with it the mLSTM's width dm and the sLSTM's
    d_model (heads are contiguous blocks of both), so each rank runs the
    mLSTM and the sLSTM recurrence on whole heads, and so does the
    sLSTM's MLP width (xlstm-350m's 1,364 at 2 and 4 ways). Else both
    blocks stay whole on every rank."""
    blocks = _blocks(cfg)
    return (any(b in XLSTM_BLOCKS for b in blocks)
            and mesh_shape(mesh).get("model", 1) > 1
            and _fits(cfg.n_heads, mesh, "model")
            and _fits(mlstm_width(cfg), mesh, "model")
            and _fits(cfg.d_model, mesh, "model")
            and ("slstm" not in blocks
                 or _fits(slstm_mlp_width(cfg), mesh, "model")))


def gate_parts(path: Tuple[str, ...], cfg: ModelConfig) -> int:
    """How many equal parts a leaf's last dimension holds, each split
    alike over "model": 4 for the sLSTM's ``w_in`` [D, 4D] and ``b``
    [4D], whose columns are the z, i, f, o gates in blocks of D (a rank
    takes its heads' columns of every gate), else 1."""
    if path[-1] in ("w_in", "b") and "cell" in path and \
            _block_type(path, cfg) == "slstm":
        return 4
    return 1


def _block_type(path: Tuple[str, ...], cfg: ModelConfig) -> str:
    """The block type of a leaf under ``blocks/bI`` or ``stem/J``, else
    ""."""
    if len(path) > 1 and path[0] == "blocks" and path[1].startswith("b"):
        return cfg.block_pattern[int(path[1][1:])]
    if len(path) > 1 and path[0] == "stem":
        return cfg.stem_pattern[int(path[1])]
    return ""


def tp_plan(cfg: ModelConfig, mesh, index: int = 0) -> TPPlan:
    """The tensor-parallel plan of ``cfg`` on ``mesh``'s "model" axis for
    the rank at model index ``index``; the reference's rules decide
    (``_param_spec`` of ``w_q``, ``w_k``, ``w_down``, the expert leaves,
    the RG-LRU and the xLSTM leaves). An arch without attention blocks
    has no attention plan ("whole")."""
    m = mesh_shape(mesh).get("model", 1)
    n_exp = cfg.moe.n_experts if cfg.moe is not None else 0
    if m == 1:
        return TPPlan(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                      n_experts=n_exp)
    blocks = _blocks(cfg) + tuple(cfg.enc_block_pattern)
    q_split = _fits(cfg.n_heads, mesh, "model")
    kv_split = _fits(cfg.n_kv_heads, mesh, "model")
    attn = ("split" if q_split and kv_split
            else "gather_q" if q_split else "whole")
    if not any(b in ATTN_BLOCKS or b == "enc_attn" for b in blocks):
        attn = "whole"
    dense_ffn = any(b in DENSE_FFN_BLOCKS for b in blocks)
    return TPPlan(ways=m, index=index, attn=attn,
                  ffn=dense_ffn and _fits(cfg.d_ff, mesh, "model"),
                  n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                  moe=moe_split(cfg, mesh), n_experts=n_exp,
                  rec=rec_split(cfg, mesh), xlstm=xlstm_split(cfg, mesh))


def local_config(cfg: ModelConfig, plan: TPPlan) -> ModelConfig:
    """The config one rank's model code runs: its head counts, its dense
    FFN's d_ff and its RG-LRU width (``head_dim`` stays explicit; the
    config derives it from ``d_model // n_heads`` only when it is 0). An
    MoE arch's ``d_ff`` is the per-expert width and ``plan.ffn`` is off
    for it; the MoE config stays whole (routing and capacity need every
    expert; the rank's expert products read :attr:`TPPlan.experts`)."""
    kw: Dict[str, Any] = {"head_dim": cfg.head_dim}
    if plan.attn == "split":
        kw.update(n_heads=plan.q_heads[1], n_kv_heads=plan.kv_heads[1])
    if plan.ffn:
        kw["d_ff"] = cfg.d_ff // plan.ways
    if plan.rec:
        dr = rglru_width(cfg) // plan.ways
        kw["rglru_expand"] = cfg.rglru_expand / plan.ways
        if int(kw["rglru_expand"] * cfg.d_model) != dr:
            raise ValueError(f"{cfg.name}: the RG-LRU width {dr} a rank is "
                             "not a width the config can express")
    return cfg.replace(**kw)


# the leaves the placement splits, and the dim (within the leaf's core)
# whose "model" entry it follows (q/k/v/o of self attention, cross
# attention and the encoder alike; the dense SwiGLU's and the GELU MLP's)
_TP_LEAVES = {"w_q": 1, "w_k": 1, "w_v": 1, "w_o": 0,
              "w_gate": 1, "w_up": 1, "w_down": 0, "w_in": 1, "w_out": 0}


def _fsdp_only(spec: Spec) -> Spec:
    """The FSDP ("data" / "pod") entries of a spec, None elsewhere."""
    def keep(ax):
        axes = _axes_of(ax)
        kept = tuple(a for a in axes if a in ("pod", "data"))
        return kept[0] if len(kept) == 1 else (kept if kept else None)
    return tuple(keep(a) for a in spec)


def param_placement(path: Tuple[str, ...], shape: Tuple[int, ...], mesh,
                    cfg: ModelConfig, *,
                    replicate_fsdp: bool = True) -> Spec:
    """The spec :func:`local_params` applies to one leaf: the reference's
    spec's "model" entries on the tensor-parallel leaves (attention, the
    dense FFN, the experts, the RG-LRU block), whole elsewhere (the MoE
    router included); the write gate split over its kv heads when they
    divide "model" (the reference replicates it). With
    ``replicate_fsdp=False`` (FSDP) every FSDP entry of the reference's
    spec too, the gate excepted."""
    full = _param_spec(path, shape, mesh, cfg)
    spec = _strip_fsdp(full)
    lead = 1 if "blocks" in path else 0
    out = [None] * len(shape)
    if "gate" in path:
        if len(shape) > lead and _fits(cfg.n_kv_heads, mesh, "model"):
            out[lead] = "model"
        return tuple(out)
    if "moe" in path:
        # the expert leaves as the reference's spec splits them (experts,
        # or the expert FFN width); the router stays whole: routing needs
        # every expert's logit
        if path[-1] != "router":
            out = [e if e == "model" else None for e in spec]
    elif "rec" in path:
        # the RG-LRU leaves by channel when the plan splits them; the 1-D
        # leaves (b_r, b_i, lam) too, at every size (the reference splits
        # a 1-D leaf only from 4,096)
        if rec_split(cfg, mesh):
            out = [e if e == "model" else None for e in spec]
            if len(shape) == lead + 1:
                out[lead] = "model"
    elif "cell" in path:
        out = _xlstm_placement(path, shape, lead, cfg, mesh)
    elif path[-1] == "b_in":
        # the GELU MLP's bias goes with w_in's columns whenever those
        # split (the reference splits a 1-D leaf only from 4,096); b_out
        # stays whole, added once after the sum
        if "mlp" in path and tp_plan(cfg, mesh).ffn:
            out[lead] = "model"
    else:
        dim = _TP_LEAVES.get(path[-1])
        if dim is not None and spec[lead + dim] == "model":
            out[lead + dim] = "model"
    if not replicate_fsdp:
        for i, e in enumerate(_fsdp_only(full)):
            if e is not None:
                out[i] = e
    return tuple(out)


# the mLSTM leaves a rank holds by its heads' columns
_MLSTM_COLS = ("w_up_x", "w_up_z", "conv", "w_q", "w_k", "w_v", "w_i",
               "w_f")


def _xlstm_placement(path: Tuple[str, ...], shape: Tuple[int, ...],
                     lead: int, cfg: ModelConfig, mesh) -> list:
    """The "model" entries of an xLSTM leaf (``.../cell/...``) when
    :func:`xlstm_split` holds, else none. mLSTM: the up-projections,
    conv, ``w_q`` / ``w_k`` / ``w_v`` and the port's ``w_i`` / ``w_f``
    by their columns, ``b_i`` / ``b_f`` and ``out_norm`` by head,
    ``w_down`` by its rows. sLSTM: ``w_in`` / ``b`` per gate
    (:func:`gate_parts`), ``r`` by head; its gated MLP's ``w_up1`` /
    ``w_up2`` columns and ``w_down`` rows; the norms whole."""
    out = [None] * len(shape)
    if not xlstm_split(cfg, mesh):
        return out
    name = path[-1]
    bt = _block_type(path, cfg)
    if bt == "mlstm":
        if name in _MLSTM_COLS:
            out[lead + 1] = "model"
        elif name in ("b_i", "b_f", "w_down") or "out_norm" in path:
            out[lead] = "model"
    elif bt == "slstm":
        if name in ("w_in", "r"):
            out[lead + 1] = "model"
        elif name == "b":
            out[lead] = "model"
        elif name in ("w_up1", "w_up2", "w_down"):
            out[lead + (0 if name == "w_down" else 1)] = "model"
    return out


def local_params(params: Any, cfg: ModelConfig, mesh,
                 coords: Mapping[str, int], *,
                 replicate_fsdp: bool = True) -> Any:
    """One rank's block of every leaf of ``params`` under
    :func:`param_placement` (whole leaves are shared, not copied)."""
    def walk(path, leaf):
        keys = tuple(str(k) for k in path)
        spec = param_placement(keys, tuple(leaf.shape), mesh, cfg,
                               replicate_fsdp=replicate_fsdp)
        return local_shard(leaf, spec, coords, mesh, gate_parts(keys, cfg))
    return tree_map_with_path(walk, params)


def fsdp_placement(params: Any, cfg: ModelConfig, mesh) -> Dict[str, Spec]:
    """``{path: placement}`` of the leaves FSDP holds in blocks: what
    ``sharding.comm.gather_params`` assembles before each use."""
    out: Dict[str, Spec] = {}

    def walk(path, leaf):
        keys = tuple(str(k) for k in path)
        spec = param_placement(keys, tuple(leaf.shape), mesh, cfg,
                               replicate_fsdp=False)
        if any(_fsdp_only(spec)):
            out["/".join(keys)] = spec
        return leaf
    tree_map_with_path(walk, params)
    return out


def held_whole(params: Any, cfg: ModelConfig, mesh, *,
               replicate_fsdp: bool = True) -> Dict[str, int]:
    """``{path: bytes}`` of the leaves the reference's spec splits (its
    serving spec, or with ``replicate_fsdp=False`` its FSDP spec) on a
    dimension the placement keeps whole on every rank."""
    out: Dict[str, int] = {}

    def walk(path, leaf):
        keys = tuple(str(k) for k in path)
        ref = _param_spec(keys, tuple(leaf.shape), mesh, cfg)
        if replicate_fsdp:
            ref = _strip_fsdp(ref)
        mine = param_placement(keys, tuple(leaf.shape), mesh, cfg,
                               replicate_fsdp=replicate_fsdp)
        if any(r is not None and m is None for r, m in zip(ref, mine)):
            out["/".join(keys)] = int(leaf.numel()) * leaf.element_size()
        return leaf
    tree_map_with_path(walk, params)
    return out


# per-kv-head cache leaves [B, H] the reference's rule keeps whole over
# "model" (GSPMD slices them where the heads are split)
_HEAD_COUNTERS = ("gcnt", "overflow")
# the cross cache's per-head mask [B, H, S], whole over "model" by the
# reference's generic rule
_HEAD_MASKS = ("valid",)
# an RG-LRU block's recurrent state leaves, [B, dr] and [B, cw - 1, dr]
_REC_STATES = ("h", "conv")


def cache_placement(path: Tuple[str, ...], shape: Tuple[int, ...], mesh,
                    cfg: ModelConfig, seq_shard: bool = False) -> Spec:
    """The spec of one rank's block of a cache leaf: the reference's
    (:func:`cache_shardings`), whose "model" entries are the plan's kv
    heads (:func:`tp_plan` and the cache rule both split the kv heads iff
    they divide "model"), and the per-head counters ``gcnt`` /
    ``overflow`` and the cross cache's ``valid`` split with them (a
    rank's model code counts and reads its own heads); an RG-LRU state
    by its channels when :func:`rec_split`, an xLSTM state by the rank's
    heads when :func:`xlstm_split` (every leaf: the spec keeps the
    mLSTM's ``n`` / ``m`` and the sLSTM's ``c`` / ``n`` / ``m`` whole,
    but a rank computes only its heads' part). Under ``seq_shard`` the
    global token axis of ``gk`` / ``gv`` / ``gpos`` (a dense cache's
    ``k`` / ``v``) goes over "data" while the ring, ``gcnt``, ``t``,
    ``ptr`` and the page metadata stay whole."""
    spec = list(_cache_leaf_spec(path, shape, mesh, cfg, seq_shard))
    lead = 1 if "blocks" in path else 0
    if _block_type(path, cfg) in XLSTM_BLOCKS:
        # an xLSTM state by the rank's heads when the blocks split (the
        # conv by its channels, every other leaf by its head or channel
        # dimension), else whole
        spec = [None if e == "model" else e for e in spec]
        if xlstm_split(cfg, mesh):
            spec[lead + (2 if path[-1] == "conv" else 1)] = "model"
        return tuple(spec)
    if path[-1] in _REC_STATES and not rec_split(cfg, mesh):
        # the RG-LRU state follows the plan's channels: whole unless the
        # gate blocks split with them
        spec = [None if e == "model" else e for e in spec]
    if ((path[-1] in _HEAD_COUNTERS and len(shape) == lead + 2)
            or (path[-1] in _HEAD_MASKS and len(shape) == lead + 3)) \
            and _fits(cfg.n_kv_heads, mesh, "model"):
        spec[lead + 1] = "model"
    return tuple(spec)


def local_caches(caches: Any, cfg: ModelConfig, mesh,
                 coords: Mapping[str, int], *,
                 seq_shard: bool = False) -> Any:
    """One rank's block of every leaf of a whole cache tree under
    :func:`cache_placement`."""
    return tree_map_with_path(
        lambda p, leaf: local_shard(
            leaf, cache_placement(tuple(str(k) for k in p),
                                  tuple(leaf.shape), mesh, cfg, seq_shard),
            coords, mesh), caches)


def specs_by_path(tree: Any, specs: Any) -> Dict[Tuple[str, ...], Spec]:
    """``{path: spec}`` of every leaf of ``tree`` in a spec tree of the
    same structure (specs are tuples, so they are read at the leaves'
    paths rather than flattened)."""
    from repro_torch.tree import tree_leaves_with_path
    out = {}
    for path, _ in tree_leaves_with_path(tree):
        node = specs
        for k in path:
            node = getattr(node, k) if isinstance(k, str) and \
                hasattr(node, "_fields") else node[k]
        out[tuple(str(k) for k in path)] = node
    return out
