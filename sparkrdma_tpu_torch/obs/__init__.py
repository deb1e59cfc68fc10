"""Observability of the port: the process-wide metrics registry, the
span tracer, critical-path attribution (``critpath``, ``attr``), the
sampling profiler and the executor half of the telemetry plane
(``Heartbeater``): copies of the JAX package's ``obs/`` modules of the
same names. The telemetry hub, the journal and the rest of ``obs/`` come
with ROADMAP item M8."""

from sparkrdma_tpu_torch.obs.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    get_registry,
    metric_key,
    parse_metric_key,
    snapshot_delta,
    strip_label,
)
from sparkrdma_tpu_torch.obs.profiler import (
    ProfileHub,
    SamplingProfiler,
    acquire_profiler,
    get_profiler,
    release_profiler,
    render_flamegraph_html,
)
from sparkrdma_tpu_torch.obs.telemetry import Heartbeater
from sparkrdma_tpu_torch.obs.trace import (
    Span,
    SpanHandle,
    Tracer,
    all_tracers,
    collect_spans,
    collect_spans_with_epochs,
    export_chrome_trace,
    get_tracer,
    mint_trace_id,
    now,
    to_chrome_trace,
)

__all__ = [
    "Counter",
    "Gauge",
    "Heartbeater",
    "Histogram",
    "MetricsRegistry",
    "ProfileHub",
    "SamplingProfiler",
    "Span",
    "SpanHandle",
    "Tracer",
    "acquire_profiler",
    "all_tracers",
    "collect_spans",
    "collect_spans_with_epochs",
    "export_chrome_trace",
    "get_profiler",
    "get_registry",
    "get_tracer",
    "metric_key",
    "mint_trace_id",
    "now",
    "parse_metric_key",
    "release_profiler",
    "render_flamegraph_html",
    "snapshot_delta",
    "strip_label",
    "to_chrome_trace",
]
