"""StaticAdmissionEngine: the StreamingLLM and DuoAttention baselines as
serving backends (port of ``repro/serving/static_admission.py``).

The paper's §5.2 baselines are input-independent admission policies in
the write gate's interface (core/baselines.py): g depends only on a
token's absolute position (and, for DuoAttention, its head). Plugged into
the same dual cache — ring, lazy promotion, paged mirror, the two-phase
``step_batch`` / ``collect`` surface — each becomes a serving backend
behind the :class:`~repro_torch.serving.backend.EngineBackend` protocol,
so one arrival trace replays through WG-KV, dense full-KV and the static
baselines under the same scheduler. With a static policy the
``gate_mlp`` kernel does not run; the reads go through ``paged_decode``.

Policies:
  * ``streaming_llm`` — admit only the first ``sink`` tokens; everything
    else lives transiently in the local window.
  * ``duo`` — per-head split: ``retrieval_heads`` admit every token, the
    other (streaming) heads sinks only. Heads are given explicitly or
    taken as the first ``retrieval_ratio`` fraction.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

from repro_torch.configs.base import ModelConfig
from repro_torch.models import inference as I
from repro_torch.serving.backend import BackendCapabilities
from repro_torch.serving.engine import Engine


class StaticAdmissionEngine(Engine):
    """Dual-cache engine whose write gate is a static position/head
    policy."""

    def __init__(self, params, cfg: ModelConfig, *,
                 policy: str = "streaming_llm",
                 sink: Optional[int] = None,
                 retrieval_heads: Optional[Sequence[int]] = None,
                 retrieval_ratio: float = 0.25,
                 opts: Optional[I.DecodeOptions] = None, **kw):
        if policy not in I.STATIC_POLICIES:
            raise ValueError(f"policy must be one of {I.STATIC_POLICIES}, "
                             f"got {policy!r}")
        sink = cfg.wgkv.sink if sink is None else int(sink)
        if policy == "duo":
            if retrieval_heads is None:
                k = max(1, round(retrieval_ratio * cfg.n_kv_heads))
                retrieval_heads = range(k)
            retrieval_heads = tuple(int(h) for h in retrieval_heads)
        else:
            retrieval_heads = ()
        opts = dataclasses.replace(
            opts or I.DecodeOptions(), admission_policy=policy,
            admission_sink=sink, duo_retrieval_heads=retrieval_heads)
        # align the config's sink floor with the policy's: select_global
        # and prefill_populate force-admit cfg.wgkv.sink positions whatever
        # the gate, so a mismatched floor would make one-shot and chunked
        # prefill admit different tokens
        cfg = cfg.replace(wgkv=dataclasses.replace(cfg.wgkv, sink=sink))
        super().__init__(params, cfg, opts=opts, **kw)
        self.policy = policy

    def capabilities(self) -> BackendCapabilities:
        return BackendCapabilities(
            name=self.policy, gated=True, paged=self.mirror,
            description="static admission baseline "
                        "(position/head-only write gate)",
            sharded=self.mesh is not None, selection=self.selection)
