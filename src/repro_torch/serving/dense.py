"""DenseEngine: the full-KV (no admission) baseline serving backend (port
of ``repro/serving/dense.py``).

The same :class:`~repro_torch.serving.backend.EngineBackend` protocol as
the WG-KV Engine over the uncompressed dense cache: every prompt and
generated token is written (admission 1.0), so one arrival trace replayed
through this backend and the WG-KV one gives the paper's comparison
(memory, decode speed) as a serving-level A/B.

It shares the batched slot machinery with :class:`Engine`; only these
differ:

  * prefill: every chunk rides the shared ragged scan from an empty
    DENSE cache tree (``decode_step`` dispatches on the cache type), so
    on CUDA serving's dense path runs one kernel, the one-segment
    ``paged_decode`` read of the dense buffer;
  * memory: no paged-pool mirror. The resident KV is ``t`` tokens per
    (layer, kv head) stream, reported by ``memory_snapshot``;
  * capacity: a dense row grows by one token per position, so the host
    tracks each slot's length and raises before a dispatch would write
    past ``capacity``.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.specs import build_decode_caches, cache_tree_bytes
from repro_torch.models import inference as I
from repro_torch.models.attention import DenseCache
from repro_torch.serving.backend import BackendCapabilities, PrefillTask
from repro_torch.serving.engine import Engine


class DenseEngine(Engine):
    """Full-KV baseline backend (admission 1.0, linear cache growth)."""

    def __init__(self, params, cfg: ModelConfig, *, slots: int = 4,
                 capacity: int = 4096, opts: Optional[I.DecodeOptions] = None,
                 eos: Optional[int] = None, temperature: float = 0.0,
                 seed: int = 0, device=None,
                 pool_pages: Optional[int] = None,
                 mirror_paged: bool = False, mesh=None):
        # dense caches are contiguous buffers: the paged mirror does not
        # apply, so pool_pages and mirror_paged (the WG-KV family's
        # keywords, taken so one call builds any backend) are ignored
        del pool_pages, mirror_paged
        if opts is not None and opts.selection_policy is not None:
            raise ValueError(
                "selection_policy requires the paged dual cache; the dense "
                "full-KV baseline has no page metadata to select against")
        super().__init__(params, cfg, slots=slots, capacity=capacity,
                         opts=opts, eos=eos, temperature=temperature,
                         seed=seed, mirror_paged=False, device=device,
                         mesh=mesh)
        # host-tracked length per slot: a write past the buffer must fail
        # before it is dispatched, never be dropped
        self._slot_len = [0] * slots

    def capabilities(self) -> BackendCapabilities:
        return BackendCapabilities(
            name="dense", gated=False, paged=False,
            description="uncompressed full-KV cache (no admission)",
            sharded=self.mesh is not None)

    def _dense_nodes(self, caches) -> List[DenseCache]:
        """The stacked DenseCache of every full-attention block."""
        return [caches["blocks"][f"b{i}"] for i in self._attn_blocks()
                if isinstance(caches["blocks"][f"b{i}"], DenseCache)]

    def _kv_tokens_device(self, caches) -> torch.Tensor:
        """[B] resident tokens per row: ``t`` times the kv heads, summed
        over full-attention layers."""
        total = torch.zeros_like(caches["t"])
        for dc in self._dense_nodes(caches):
            total = total + (dc.t * dc.k.shape[2]).sum(dim=0)
        return total.to(torch.int32)

    # ------------------------------------------------------------------
    def start_prefill(self, prompt: List[int]) -> PrefillTask:
        # the first token is sampled from the prefill's own last-position
        # logits, so the prompt alone must fit the buffer
        if len(prompt) >= self.capacity:
            raise ValueError(f"prompt {len(prompt)} needs dense capacity > "
                             f"{len(prompt)}, have {self.capacity}")
        return PrefillTask(prompt=list(prompt))

    def _extend_admission(self, adm_sum, take: int, full: bool) -> float:
        return 1.0 * take                  # dense admits every token

    def _decode_admission(self, adm_rows: np.ndarray,
                          rows: List[int]) -> float:
        return 1.0                         # the dense baseline writes all

    def _build_empty_caches(self):
        return build_decode_caches(self.cfg, 1, self.capacity,
                                   use_wgkv=False, device=self.device)

    # ------------------------------------------------------------------
    # capacity guard: a dense slot grows by one token per position
    # ------------------------------------------------------------------
    def insert(self, prefix, slot: int) -> None:
        super().insert(prefix, slot)
        self._slot_len[slot] = int(prefix.caches["t"][0])

    def _pre_fused_dispatch(self, prefill, decode_rows) -> None:
        for s, take in prefill:
            if self._slot_len[s] + take > self.capacity:
                raise RuntimeError(
                    f"dense cache overflow: slot {s} at t={self._slot_len[s]}"
                    f" + chunk {take} > capacity {self.capacity}")
            self._slot_len[s] += take
        for s in decode_rows:
            if self._slot_len[s] >= self.capacity:
                raise RuntimeError(
                    f"dense cache overflow: slot {s} at t={self._slot_len[s]}"
                    f" == capacity {self.capacity}; raise capacity or lower "
                    "max_new")
            self._slot_len[s] += 1

    def free_slot(self, slot: int) -> None:
        super().free_slot(slot)
        self._slot_len[slot] = 0

    # ------------------------------------------------------------------
    # prefix store hooks: the stored artifact is the row's full-KV tree
    # ------------------------------------------------------------------
    def _adopt_prefix(self, slot: int, entry) -> None:
        super()._adopt_prefix(slot, entry)
        self._slot_len[slot] = entry.n_tokens

    def capture_prefix(self, step, slot: int, key: str, *,
                       adm_weighted: float = 0.0):
        from repro_torch.serving.prefix_cache import CachedPrefix
        caches = self._slot_tree(step.after, slot)
        n = int(caches["t"][0])
        layers = sum(dc.k.shape[0] for dc in self._dense_nodes(caches))
        n_bytes, = self._head_sum_host(cache_tree_bytes(caches))
        return CachedPrefix(key=key, n_tokens=n, caches=caches,
                            adm_weighted=adm_weighted, meta={},
                            kv_tokens=n * self.full_cfg.n_kv_heads * layers,
                            n_bytes=n_bytes)
