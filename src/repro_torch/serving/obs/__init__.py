"""Serving observability: tracer + metrics registry + exporters.

Layering (all optional at runtime — the serving stack defaults to the
no-op :data:`NULL_TRACER` and pays one branch per instrumentation site):

  trace.py   — ring-buffer structured tracer: per-request lifecycle
               spans and per-tick engine-phase spans with monotonic
               timestamps and tick/rid/slot/batch attributes
  metrics.py — counter / gauge / rolling-window histogram registry;
               orchestrator Telemetry sits on top of it (its ``counters``
               dict is a live :class:`CounterView`)
  export.py  — Chrome-trace/Perfetto JSON exporter + structural
               validator (CI gates emitted artifacts through it), and
               the ``torch.profiler.record_function`` device bridge lives
               on the tracer itself (``annotate_device=True``)

Wired in by: serving/orchestrator/scheduler.py (tick phases + request
lifecycle), serving/engine.py (prefill_open / prefill_extend_ragged /
decode dispatch sub-phases on every backend), launch/serve.py
(``--trace-out`` / ``--metrics-interval``), benchmarks/bench_serving.py
(per-backend trace artifacts + phase-time breakdown columns).
"""
from repro_torch.serving.obs.export import (TRACE_SCHEMA_VERSION, chrome_trace,
                                      chrome_trace_events,
                                      validate_chrome_trace,
                                      write_chrome_trace)
from repro_torch.serving.obs.metrics import (Counter, CounterView, Gauge,
                                       Histogram, MetricsRegistry)
from repro_torch.serving.obs.trace import (CAT_ENGINE, CAT_REQUEST, LANE_REQ,
                                     LANE_TICK, NULL_TRACER, Span, Tracer)

__all__ = ["Tracer", "Span", "NULL_TRACER", "LANE_REQ", "LANE_TICK",
           "CAT_ENGINE", "CAT_REQUEST", "MetricsRegistry", "Counter",
           "CounterView", "Gauge", "Histogram", "chrome_trace",
           "chrome_trace_events", "write_chrome_trace",
           "validate_chrome_trace", "TRACE_SCHEMA_VERSION"]
