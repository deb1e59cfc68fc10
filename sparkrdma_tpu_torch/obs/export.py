"""OpenMetrics / Prometheus text exposition for the metrics registry.

Renders a ``MetricsRegistry.snapshot()`` dict (live, or one saved
inside a bench/workload artifact) as OpenMetrics text:

- metric names map ``layer.metric`` -> ``layer_metric`` (dots and any
  other non-``[a-zA-Z0-9_:]`` characters become ``_``);
- labels pass through as-is (``role``, ``executor``, ``purpose``,
  ``type``, ...), with values escaped per the spec (``\\`` ``"`` and
  newline);
- counters expose as ``<name>_total``; gauges expose the value plus a
  ``<name>_hwm`` gauge family for the high-water mark; histograms
  expose cumulative ``_bucket{le=...}`` / ``_sum`` / ``_count``;
- the document ends with ``# EOF`` (OpenMetrics terminator).

Two egress paths: :class:`OpenMetricsServer` (a stdlib ``http.server``
thread for scrapes, conf ``obs.telemetry.httpPort``) and
:func:`write_openmetrics` (a file for scrape-less runs; the obs CLI's
``--openmetrics``, ``python -m sparkrdma_tpu_torch.obs``).

Stdlib-only and jax-free, like the rest of ``obs/``.
A copy of the JAX package's ``obs/export.py``, its imports rewritten
to this package. The exposition is the JAX package's byte for byte
(its ``# HELP`` lines keep the project's metric namespace,
``sparkrdma_tpu``), so one scraper reads both.

"""

from __future__ import annotations

import http.server
import logging
import re
import threading
from typing import Callable, Dict, List, Mapping, Optional

from sparkrdma_tpu_torch.obs.metrics import parse_metric_key

logger = logging.getLogger(__name__)

CONTENT_TYPE = "application/openmetrics-text; version=1.0.0; charset=utf-8"

_NAME_SANITIZE = re.compile(r"[^a-zA-Z0-9_:]")


def metric_name(dotted: str) -> str:
    """``transport.read_bytes`` -> ``transport_read_bytes``."""
    name = _NAME_SANITIZE.sub("_", dotted)
    if not name or not (name[0].isalpha() or name[0] in "_:"):
        name = "_" + name
    return name


def escape_label_value(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _labels_str(labels: Mapping[str, str], extra: Optional[Mapping[str, str]] = None) -> str:
    merged: Dict[str, str] = dict(labels)
    if extra:
        merged.update(extra)
    if not merged:
        return ""
    inner = ",".join(
        f'{metric_name(k)}="{escape_label_value(str(v))}"'
        for k, v in sorted(merged.items())
    )
    return "{" + inner + "}"


def _fmt(v) -> str:
    if v is None:
        return "NaN"
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, int):
        return str(v)
    return repr(float(v))


class _FamilyWriter:
    """Groups samples by family so HELP/TYPE render once per family."""

    def __init__(self):
        self._families: Dict[str, List[str]] = {}
        self._types: Dict[str, str] = {}
        self._order: List[str] = []

    def add(self, family: str, mtype: str, sample_lines: List[str]) -> None:
        if family not in self._families:
            self._families[family] = []
            self._types[family] = mtype
            self._order.append(family)
        self._families[family].extend(sample_lines)

    def render(self) -> List[str]:
        out: List[str] = []
        for family in self._order:
            out.append(f"# HELP {family} sparkrdma_tpu metric {family}")
            out.append(f"# TYPE {family} {self._types[family]}")
            out.extend(self._families[family])
        return out


def render_openmetrics(snapshot: Mapping[str, Mapping[str, object]],
                       extra_labels: Optional[Mapping[str, str]] = None) -> str:
    """One OpenMetrics document from a ``snapshot()`` dict."""
    w = _FamilyWriter()
    for key in sorted(snapshot.get("counters", {})):
        value = snapshot["counters"][key]
        dotted, labels = parse_metric_key(key)
        family = metric_name(dotted)
        w.add(family, "counter", [
            f"{family}_total{_labels_str(labels, extra_labels)} {_fmt(value)}"
        ])
    for key in sorted(snapshot.get("gauges", {})):
        g = snapshot["gauges"][key]
        dotted, labels = parse_metric_key(key)
        family = metric_name(dotted)
        ls = _labels_str(labels, extra_labels)
        w.add(family, "gauge", [f"{family}{ls} {_fmt(g.get('value', 0))}"])
        w.add(family + "_hwm", "gauge", [f"{family}_hwm{ls} {_fmt(g.get('hwm', 0))}"])
    for key in sorted(snapshot.get("histograms", {})):
        h = snapshot["histograms"][key]
        dotted, labels = parse_metric_key(key)
        family = metric_name(dotted)
        lines: List[str] = []
        cumulative = 0
        buckets = h.get("buckets") or {}
        for bname, count in buckets.items():
            if bname == "overflow":
                continue
            cumulative += count
            le = bname[3:] if bname.startswith("le_") else bname
            extra = dict(extra_labels or {})
            extra["le"] = le
            lines.append(f"{family}_bucket{_labels_str(labels, extra)} {cumulative}")
        extra = dict(extra_labels or {})
        extra["le"] = "+Inf"
        lines.append(
            f"{family}_bucket{_labels_str(labels, extra)} {_fmt(h.get('count', 0))}"
        )
        ls = _labels_str(labels, extra_labels)
        lines.append(f"{family}_sum{ls} {_fmt(h.get('sum', 0.0))}")
        lines.append(f"{family}_count{ls} {_fmt(h.get('count', 0))}")
        w.add(family, "histogram", lines)
    return "\n".join(w.render() + ["# EOF", ""])


def extract_snapshot(doc: Mapping) -> Dict[str, Dict[str, object]]:
    """Find a registry snapshot inside a saved JSON document.

    Accepts a raw ``snapshot()`` dict, a manager/context
    ``metrics_snapshot()`` (``"registry"`` key), or a bench/workload
    artifact (``"obs_registry"`` key)."""
    for key in ("obs_registry", "registry"):
        inner = doc.get(key)
        if isinstance(inner, Mapping) and "counters" in inner:
            return {
                "counters": dict(inner.get("counters", {})),
                "gauges": dict(inner.get("gauges", {})),
                "histograms": dict(inner.get("histograms", {})),
            }
    if "counters" in doc or "gauges" in doc or "histograms" in doc:
        return {
            "counters": dict(doc.get("counters", {})),
            "gauges": dict(doc.get("gauges", {})),
            "histograms": dict(doc.get("histograms", {})),
        }
    raise ValueError(
        "no registry snapshot found (expected 'counters'/'gauges'/'histograms', "
        "or an 'obs_registry'/'registry' key containing them)"
    )


def write_openmetrics(path: str, snapshot: Mapping[str, Mapping[str, object]],
                      extra_labels: Optional[Mapping[str, str]] = None) -> str:
    """File egress for scrape-less runs; returns the rendered text."""
    text = render_openmetrics(snapshot, extra_labels)
    with open(path, "w", encoding="utf-8") as f:
        f.write(text)
    return text


class OpenMetricsServer:
    """Stdlib HTTP scrape endpoint serving ``source()`` as OpenMetrics.

    ``source`` is any zero-arg callable returning the exposition text
    (typically ``lambda: render_openmetrics(get_registry().snapshot())``).
    Binds ``host:port`` (port 0 = ephemeral; read ``.port`` after
    construction) and serves on a daemon thread until :meth:`stop`.
    """

    def __init__(self, source: Callable[[], str], port: int = 0,
                 host: str = "127.0.0.1"):
        self._source = source

        server = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (stdlib API name)
                try:
                    body = server._source().encode("utf-8")
                    self.send_response(200)
                    self.send_header("Content-Type", CONTENT_TYPE)
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                except Exception:
                    logger.exception("openmetrics render failed")
                    self.send_response(500)
                    self.end_headers()

            def log_message(self, fmt, *args):
                logger.debug("openmetrics: " + fmt, *args)

        self._httpd = http.server.ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self.host = host
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="openmetrics-http",
            daemon=True,
        )
        self._thread.start()

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)
