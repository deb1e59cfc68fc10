"""Observability of the port: the process-wide metrics registry and the
span tracer (copies of the JAX package's ``obs/metrics.py`` and
``obs/trace.py``). The telemetry plane, the journal and the rest of
``obs/`` come with ROADMAP item M8."""

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
    "Histogram",
    "MetricsRegistry",
    "Span",
    "SpanHandle",
    "Tracer",
    "all_tracers",
    "collect_spans",
    "collect_spans_with_epochs",
    "export_chrome_trace",
    "get_registry",
    "get_tracer",
    "metric_key",
    "mint_trace_id",
    "now",
    "parse_metric_key",
    "snapshot_delta",
    "strip_label",
    "to_chrome_trace",
]
