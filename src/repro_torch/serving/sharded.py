"""Mesh-sharded serving (port of ``repro/serving/sharded.py``): every
backend serves across a ``data x model`` mesh without the orchestrator or
scheduler changing.

The reference jits its steps with explicit in/out shardings and lets
GSPMD place the collectives. The port is multi-controller SPMD over
``torch.distributed`` (``launch/mesh.py``): every rank runs the same
orchestrator, scheduler and engine on the same inputs, holds its shard
as plain local tensors, and the collectives are explicit
(``sharding/comm.py``). DTensor is not used on the model path: the
kernels are ``ctypes`` calls on raw pointers, and each would need a
dispatch route of its own.

* **params** are placed once with the reference's serving spec
  (``replicate_fsdp=True``): replicated across "data", tensor-parallel
  over "model" where the head and FFN counts divide
  (``sharding.rules.local_params``); the rank's model code runs its local
  head counts and d_ff (``rules.local_config``) and adds the row-parallel
  partials (``comm.reduce_model``).
* **cache trees**: decode slots split over "data" when the slot count
  divides it (else every data rank keeps every row), kv heads over
  "model" by the same plan. A rank's tree holds only its block.
* **an MoE arch**: the tick's rows are one routing group, as in the
  reference; with the slots split over "data" each rank gathers the
  group's rows (``models/moe.py``) and steps every position of the tick.
* **the fused step** runs the rank's rows; its sampled tokens and per-row
  stats are assembled inside the step (one ``all_reduce`` over the mesh),
  so ``collect`` still makes one host pull. Temperature sampling draws
  from the rows' logits gathered over "data" with every rank's identical
  generator, so the mesh draws what one device draws.
* **batch-1 trees** (prefill tasks, prefix-store entries) are replicated
  over "data": every data rank computes them, and a row captured from a
  slot is broadcast from the slot's data rank. A splice lands only on
  the rank that holds the slot.

Unmeshed (``mesh=None``) every helper is the unsharded path.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.launch.mesh import Mesh, init_mesh
from repro_torch.launch.specs import extract_slot_caches, splice_caches
from repro_torch.models import moe as MoE
from repro_torch.sharding import comm, rules


# ==========================================================================
# mesh construction from a CLI "dxm" spec
# ==========================================================================
def parse_mesh_shape(spec: str) -> Tuple[int, int]:
    """``"2x4"`` -> ``(2, 4)`` (data ways, model ways)."""
    try:
        d, m = spec.lower().split("x")
        shape = (int(d), int(m))
    except ValueError:
        raise ValueError(f"mesh spec must look like '2x4' (data x model), "
                         f"got {spec!r}") from None
    if shape[0] < 1 or shape[1] < 1:
        raise ValueError(f"mesh axes must be >= 1, got {spec!r}")
    return shape


def build_mesh(spec: Optional[str], *, backend: Optional[str] = None,
               device=None) -> Optional[Mesh]:
    """This rank's ("data", "model") mesh from a "dxm" spec (None ->
    None), over the initialised world of ``d * m`` ranks
    (``launch.mesh.spawn`` or ``torchrun`` start them)."""
    if not spec:
        return None
    shape = parse_mesh_shape(spec)
    need = shape[0] * shape[1]
    have = dist.get_world_size() if dist.is_initialized() else 1
    if have != need:
        raise RuntimeError(
            f"mesh {spec} needs {need} ranks (devices), found {have}; start "
            "them with repro_torch.launch.mesh.spawn, torchrun, or "
            "python -m repro_torch.launch.serve --mesh")
    return init_mesh(shape, backend=backend, device=device)


class ShardedDecodeMixin:
    """Mesh placement and the rank-local views the engine needs. The
    host class provides ``self.slots`` before :meth:`_sharding_setup`;
    with ``mesh=None`` every helper reduces to the unsharded path."""

    mesh: Optional[Mesh] = None
    plan: Optional[rules.TPPlan] = None

    # ------------------------------------------------------------------
    # setup / placement
    # ------------------------------------------------------------------
    def _sharding_setup(self, params, cfg, mesh: Optional[Mesh]):
        """Record the mesh and shard the params once; returns (this rank's
        params, its config)."""
        self.mesh = mesh
        self.full_cfg = cfg
        self._rows = slice(0, self.slots)
        self._rows_split = False
        if mesh is None:
            return params, cfg
        rules.check_mesh_arch(cfg)
        if not cfg.has_attention_cache:
            # as the reference's serve: an arch with no KV cache runs on a
            # mesh through the step bundles
            raise NotImplementedError(
                f"{cfg.name} has no KV cache; the mesh engine serves "
                "attention archs (the xLSTM runs on a mesh through the "
                "step bundles, launch/steps.py)")
        if cfg.is_encdec:
            # as the reference's serve: its mesh path is the step bundles
            raise NotImplementedError(
                f"{cfg.name}: enc-dec serving requires audio frontends; "
                "the encoder-decoder runs on a mesh through the step "
                "bundles (launch/steps.py)")
        coords = mesh.coords
        self.plan = rules.tp_plan(cfg, mesh, coords["model"])
        # the rows and kv heads of the rank's cache blocks: the reference's
        # cache spec decides (slots over "data" when they divide); the
        # plan's heads must be the spec's
        self._rows, heads = rules.cache_blocks(cfg, self.slots, mesh, coords)
        self._rows_split = self._n_rows < self.slots
        if (heads.start, heads.stop - heads.start) != self.plan.kv_heads:
            raise RuntimeError(
                f"{cfg.name}: the placement's kv heads {self.plan.kv_heads} "
                f"are not the cache spec's block {heads}")
        return (rules.local_params(params, cfg, mesh, coords),
                rules.local_config(cfg, self.plan))

    def _local_opts(self, opts):
        """``opts`` with DuoAttention's retrieval heads renumbered to this
        rank's kv heads."""
        if self.plan is None or opts is None or not opts.duo_retrieval_heads:
            return opts
        first, n = self.plan.kv_heads
        heads = tuple(h - first for h in opts.duo_retrieval_heads
                      if first <= h < first + n)
        return dataclasses.replace(opts, duo_retrieval_heads=heads)

    def _tick_steps(self, lengths) -> Optional[int]:
        """The positions a fused tick runs on this rank: the whole tick's
        longest row when the tick's one routing group (the reference's,
        ``prefill_extend_ragged``'s ``moe_groups=1``) spans the data
        ranks (``moe.spans_rows``: its gather needs every data rank at
        every position); else None (the rank's own rows decide)."""
        if not self._rows_split or not MoE.spans_rows(
                self.full_cfg, 1, self.mesh.shape["data"]):
            return None
        return int(lengths.max())

    @property
    def _n_rows(self) -> int:
        """Rows of this rank's batched cache tree."""
        return self._rows.stop - self._rows.start

    def _local_row(self, slot: int) -> Optional[int]:
        """The row of ``slot`` in this rank's tree (None: another data
        rank holds it)."""
        if self._rows.start <= slot < self._rows.stop:
            return slot - self._rows.start
        return None

    def _splice(self, batch_tree, one_tree, slot: int):
        """``splice_caches`` onto the rank that holds ``slot``."""
        row = self._local_row(slot)
        if row is None:
            return batch_tree
        return splice_caches(batch_tree, one_tree, row)

    def _slot_tree(self, batch_tree, slot: int):
        """Row ``slot`` as a batch-1 tree on every rank: the holding data
        rank extracts it, the others receive it (a broadcast over
        "data")."""
        row = self._local_row(slot)
        tree = extract_slot_caches(batch_tree, 0 if row is None else row)
        if self._rows_split:
            comm.broadcast_tree(tree, slot // self._n_rows, self.mesh)
        return tree

    # ------------------------------------------------------------------
    # per-head sums over "model"
    # ------------------------------------------------------------------
    @property
    def _heads_split(self) -> bool:
        return self.plan is not None and self.plan.attn == "split"

    def _head_sum(self, x: torch.Tensor) -> torch.Tensor:
        """A per-row sum over kv heads from this rank's heads: summed over
        "model" when the heads are split."""
        if not self._heads_split:
            return x
        return comm.all_reduce(x.clone(), self.mesh, "model")

    def _head_sum_host(self, *values: int) -> List[int]:
        """:meth:`_head_sum` of host counts, in one collective."""
        if not self._heads_split:
            return list(values)
        return comm.host_all_reduce(values, self.mesh, "model")

    def _head_mean(self, x: torch.Tensor) -> torch.Tensor:
        """A per-row mean over kv heads from this rank's heads."""
        if not self._heads_split:
            return x
        return comm.all_reduce(x / self.plan.ways, self.mesh, "model")

    def _mesh_max(self, value: float) -> float:
        """The largest ``value`` over the mesh's ranks."""
        return float(comm.host_all_reduce([float(value)], self.mesh,
                                          "world", op="max")[0])

    # ------------------------------------------------------------------
    # the fused step's outputs, assembled on every rank
    # ------------------------------------------------------------------
    def _gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """[local rows, ...] -> [slots, ...] (identity unless the rows are
        split over "data")."""
        return comm.gather_rows(x, self.mesh) if self._rows_split else x

    def _assemble_step(self, sampled: Optional[torch.Tensor],
                       stats: Dict[str, torch.Tensor]
                       ) -> Tuple[Optional[torch.Tensor], Dict]:
        """Every rank's rows of the step's sampled tokens (None: already
        whole) and per-row stats, as [slots] vectors on every rank, in
        ONE all_reduce over the mesh: a zero-filled [5, slots] buffer in
        which each value is written once (a model rank writes the head
        stats of its heads, scaled to their share of the mean; a value
        every model rank holds whole is written by model index 0; a row
        every data rank holds, by data index 0)."""
        c = self.mesh.coords
        rows_mine = self._rows_split or c["data"] == 0
        whole_w = 1.0 if c["model"] == 0 else 0.0
        head_w = 1.0 / self.plan.ways if self._heads_split else whole_w
        sum_w = 1.0 if self._heads_split else whole_w
        vals = [sampled.float() * whole_w if sampled is not None
                else torch.zeros_like(stats["adm_sum_rows"])]
        vals += [stats[k] * head_w for k in ("evict_trigger_rows",
                                             "adm_sum_rows",
                                             "selected_pages_rows")]
        vals.append(stats["kv_tokens_rows"].float() * sum_w)
        buf = torch.zeros((5, self.slots), dtype=torch.float32,
                          device=vals[0].device)
        if rows_mine:
            # torchlint: allow-concat(a new leading axis that no mesh splits)
            buf[:, self._rows] = torch.stack(vals)
        comm.all_reduce(buf, self.mesh, "world")
        out = dict(stats)
        for i, k in enumerate(("evict_trigger_rows", "adm_sum_rows",
                               "selected_pages_rows")):
            out[k] = buf[1 + i]
        out["kv_tokens_rows"] = buf[4].to(torch.int32)
        tokens = None if sampled is None else buf[0].to(torch.int32)
        return tokens, out

    # ------------------------------------------------------------------
    # telemetry
    # ------------------------------------------------------------------
    def _per_shard_snapshot(self, snap: Dict[str, float]) -> Dict[str, float]:
        """Annotate a memory snapshot with the mesh's rank count and the
        even-occupancy share of the resident KV one rank holds (its
        fraction of a cache leaf)."""
        if self.mesh is None:
            return snap
        snap["mesh_devices"] = float(self.mesh.size)
        frac = 1.0
        if self._heads_split:
            frac /= self.plan.ways
        if self._rows_split:
            frac /= self.mesh.shape["data"]
        snap["kv_bytes_per_shard"] = snap.get("kv_bytes", 0.0) * frac
        return snap
