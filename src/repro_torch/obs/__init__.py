"""Telemetry of the port: structured tracing and metrics.

* **Spans** (:mod:`repro_torch.obs.tracer`) — ``with obs.span("compute",
  it=k): ...`` records a named interval into a thread-safe ring buffer.
  Off by default; ``REPRO_TRACE=1`` (or :func:`enable`) turns it on, and
  when off every instrumentation point is a single ``None``-check no-op.
  ``REPRO_TRACE_TORCH=1`` mirrors each span as a
  ``torch.profiler.record_function`` range.
* **Metrics** (:mod:`repro_torch.obs.metrics`) — the always-on
  process-wide registry (:data:`metrics`) of counters, gauges and
  fixed-bucket histograms.  ``obs.metrics.snapshot()`` renders it as one
  flat dict.
* **Exporters** (:mod:`repro_torch.obs.export`) — Chrome-trace/Perfetto
  JSON timelines (``main``, ``staging``, one lane per mesh device) and the
  schema-versioned run-report, both as the reference writes them.
"""
from . import export
from .metrics import (
    Counter, Gauge, Histogram, MetricsRegistry, REGISTRY,
    exp_bucket_edges, latency_bucket_edges, metrics,
)
from .tracer import (
    SpanEvent, Tracer, add_span, disable, enable, enabled, instant, span,
    tracer, tracing,
)

__all__ = [
    "span", "add_span", "instant", "enable", "disable", "enabled",
    "tracer", "tracing", "Tracer", "SpanEvent",
    "metrics", "REGISTRY", "MetricsRegistry",
    "Counter", "Gauge", "Histogram",
    "exp_bucket_edges", "latency_bucket_edges",
    "export",
]
