"""Observability of the port: the metrics registry, span tracing,
critical-path attribution (``critpath``, ``attr``), the sampling
profiler and the cluster telemetry plane (heartbeats, the driver's
``TelemetryHub`` with its time-series rings, straggler detection, SLO
engine, diagnosis, capacity plane and OpenMetrics export, and the event
journal): copies of the JAX package's ``obs/`` modules of the same
names, with the same exports. The obs CLI is ``python -m
sparkrdma_tpu_torch.obs`` (``obs/__main__.py``); ``python -m
sparkrdma_tpu_torch.obs.trend`` runs the trend engine.
"""

from sparkrdma_tpu_torch.obs.capacity import CapacityPlane
from sparkrdma_tpu_torch.obs.export import (
    OpenMetricsServer,
    extract_snapshot,
    render_openmetrics,
    write_openmetrics,
)
from sparkrdma_tpu_torch.obs.journal import (
    HLC,
    EventJournal,
    JournalHub,
    active_journal,
    emit,
    events_to_chrome,
    extract_events,
    get_journal,
    render_timeline,
)
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
from sparkrdma_tpu_torch.obs.diagnose import build_diagnosis, render_diagnosis
from sparkrdma_tpu_torch.obs.slo import (
    Breach,
    Objective,
    SLOEngine,
    burn_rate,
    exceedance,
    judge,
    multi_window_burn,
)
from sparkrdma_tpu_torch.obs.telemetry import Heartbeater, TelemetryHub
from sparkrdma_tpu_torch.obs.timeseries import TimeSeriesRing, Window
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
    "Breach",
    "CapacityPlane",
    "Counter",
    "EventJournal",
    "Gauge",
    "HLC",
    "Heartbeater",
    "Histogram",
    "JournalHub",
    "MetricsRegistry",
    "Objective",
    "OpenMetricsServer",
    "SLOEngine",
    "ProfileHub",
    "SamplingProfiler",
    "Span",
    "SpanHandle",
    "TelemetryHub",
    "TimeSeriesRing",
    "Tracer",
    "Window",
    "acquire_profiler",
    "active_journal",
    "all_tracers",
    "build_diagnosis",
    "burn_rate",
    "collect_spans",
    "collect_spans_with_epochs",
    "emit",
    "events_to_chrome",
    "exceedance",
    "export_chrome_trace",
    "extract_events",
    "extract_snapshot",
    "get_journal",
    "get_profiler",
    "get_registry",
    "get_tracer",
    "judge",
    "metric_key",
    "mint_trace_id",
    "multi_window_burn",
    "now",
    "parse_metric_key",
    "release_profiler",
    "render_diagnosis",
    "render_flamegraph_html",
    "render_openmetrics",
    "render_timeline",
    "snapshot_delta",
    "strip_label",
    "to_chrome_trace",
    "write_openmetrics",
]
