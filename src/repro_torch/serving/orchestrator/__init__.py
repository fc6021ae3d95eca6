"""Continuous-batching serving orchestrator (JetStream-style).

Layering:
  queue.py     — arrival-ordered RequestQueue with backpressure
                 (typed QueueFull) and boundary validation (InvalidRequest)
  scheduler.py — Scheduler policy + Orchestrator loop interleaving
                 chunked prefill with batched decode; with
                 ``SchedulerConfig.dispatch_ahead >= 1`` decode runs
                 through the two-phase dispatch/collect surface so host
                 work overlaps the in-flight device step
  session.py   — ServeSession, the public client API: submit -> handle,
                 sync/async token iteration, mid-stream cancellation,
                 per-request deadlines
  stream.py    — per-request token streaming with TTFT/TPOT timestamps
  telemetry.py — throughput / latency percentiles / memory snapshots /
                 admission-rate aggregation, on top of the
                 repro_torch.serving.obs metrics registry (tick-phase
                 wall-time breakdown + live windowed report line)

Observability (repro_torch.serving.obs): pass ``tracer=Tracer(...)`` to the
Orchestrator/ServeSession to record per-request lifecycle spans and
per-tick phase spans into a ring buffer, exportable as Chrome-trace JSON
(``repro_torch.serving.obs.export.write_chrome_trace``); pass
``metrics_interval_s=...`` for a live periodic metrics line.

The Orchestrator drives any backend implementing the
:class:`repro_torch.serving.backend.EngineBackend` protocol through its
prefill / insert / step_batch / collect API — the concrete WG-KV
Engine, the dense full-KV baseline, or a static-admission baseline
(``repro_torch.serving.backend.make_backend``). No concrete engine is imported
here: orchestrator code is protocol-only by construction.
"""
from repro_torch.serving.backend import (BackendCapabilities, EngineBackend,
                                   InflightStep, make_backend)
from repro_torch.serving.orchestrator.queue import (InvalidRequest, QueueFull,
                                              RequestQueue, ServeRequest)
from repro_torch.serving.orchestrator.scheduler import (Orchestrator, Scheduler,
                                                  SchedulerConfig)
from repro_torch.serving.orchestrator.session import RequestHandle, ServeSession
from repro_torch.serving.orchestrator.stream import StreamMux, TokenStream
from repro_torch.serving.orchestrator.telemetry import Telemetry

__all__ = ["BackendCapabilities", "EngineBackend", "InflightStep",
           "make_backend", "InvalidRequest", "QueueFull", "RequestQueue",
           "ServeRequest", "Orchestrator", "Scheduler", "SchedulerConfig",
           "RequestHandle", "ServeSession", "StreamMux", "TokenStream",
           "Telemetry"]
