"""Process-wide metrics registry: labeled counters, gauges, histograms.

The part of the JAX package's ``obs/metrics.py`` that the device reduce
stage and the exchange plane record into: one registry per process
(``get_registry()``), dotted ``layer.metric`` names with low-cardinality
labels, and the same
family names (``METRIC_FAMILIES`` lists the ones this package records),
so a snapshot of either package reads the same way.
"""

from __future__ import annotations

import threading
from typing import Dict, Mapping, Optional, Sequence, Tuple

# Exponential-ish latency bounds in milliseconds; the last bucket in a
# snapshot is the overflow (> bounds[-1]).
DEFAULT_BOUNDS: Tuple[float, ...] = (
    1, 2, 5, 10, 20, 50, 100, 200, 500, 1000, 2000, 5000, 10000,
)

# name -> (kind, frozenset of label keys), as declared by the JAX package
_L = frozenset
METRIC_FAMILIES: Dict[str, Tuple[str, frozenset]] = {
    # whole-stage collective shuffle (shuffle/collective.py)
    "collective.plans": ("counter", _L({"role"})),
    "collective.waves": ("counter", _L({"role", "schedule"})),
    "collective.blocks": ("counter", _L({"role"})),
    "collective.bytes": ("counter", _L({"role"})),
    "collective.fused_merges": ("counter", _L({"role"})),
    "collective.degrades": ("counter", _L({"role"})),
    "collective.compiles": ("counter", _L({"role"})),
    "collective.cache_hits": ("counter", _L({"role"})),
    "collective.plan_ms": ("histogram", _L({"role"})),
    "collective.wave_ms": ("histogram", _L({"role", "schedule"})),
    "collective.wave_dispatch_ms": ("histogram", _L({"role", "schedule"})),
    "collective.wave_inflight": ("histogram", _L({"role"})),
    "collective.wave_overlap_ms": ("counter", _L({"role"})),
    "collective.autotune_adjustments": ("counter", _L({"role"})),
    "collective.tuned_wave_bytes": ("gauge", _L({"role"})),
    # device fetch plane (shuffle/device_fetch.py)
    "device_fetch.plane.bytes": ("counter", _L({"role"})),
    "device_fetch.plane.fallbacks": ("counter", _L({"role"})),
    "device_fetch.plane.pulls": ("counter", _L({"role"})),
    "device_fetch.plane.plan_ms": ("histogram", _L({"role"})),
    # device exchange plane (ops/exchange.py)
    "exchange.exchanges": ("counter", _L({"schedule"})),
    "exchange.bytes_sent": ("counter", _L({"schedule"})),
    "exchange.bytes_received": ("counter", _L({"schedule"})),
    "exchange.bytes_received_valid": ("counter", _L({"schedule"})),
    "exchange.time_ms": ("histogram", _L({"schedule"})),
    # HBM arena (ops/hbm_arena.py)
    "hbm.pool_hits": ("counter", _L()),
    "hbm.pool_misses": ("counter", _L()),
    "hbm.spill_victims": ("counter", _L()),
    "hbm.disk_spills": ("counter", _L()),
    "hbm.in_use_bytes": ("gauge", _L()),
}
del _L


def metric_key(name: str, labels: Mapping[str, str]) -> str:
    """Canonical snapshot key: ``name`` or ``name{k=v,...}`` (sorted)."""
    if not labels:
        return name
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{inner}}}"


class Counter:
    """Monotonic counter. ``inc`` is the only mutator."""

    __slots__ = ("name", "labels", "_value", "_lock")

    def __init__(self, name: str, labels: Mapping[str, str]):
        self.name = name
        self.labels = dict(labels)
        self._value = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        return self._value


class Gauge:
    """Point-in-time value with a high-water mark."""

    __slots__ = ("name", "labels", "_value", "_hwm", "_lock")

    def __init__(self, name: str, labels: Mapping[str, str]):
        self.name = name
        self.labels = dict(labels)
        self._value = 0
        self._hwm = 0
        self._lock = threading.Lock()

    def set(self, v) -> None:
        with self._lock:
            self._value = v
            if v > self._hwm:
                self._hwm = v

    def add(self, n) -> None:
        with self._lock:
            self._value += n
            if self._value > self._hwm:
                self._hwm = self._value

    @property
    def value(self):
        return self._value

    @property
    def hwm(self):
        return self._hwm


class Histogram:
    """Fixed-bound histogram (count/sum/min/max + per-bucket counts);
    one extra overflow bucket catches everything above ``bounds[-1]``."""

    __slots__ = ("name", "labels", "bounds", "_counts", "_count", "_sum",
                 "_min", "_max", "_lock")

    def __init__(self, name: str, labels: Mapping[str, str],
                 bounds: Sequence[float] = DEFAULT_BOUNDS):
        self.name = name
        self.labels = dict(labels)
        self.bounds = tuple(bounds)
        self._counts = [0] * (len(self.bounds) + 1)
        self._count = 0
        self._sum = 0.0
        self._min = None
        self._max = None
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        idx = len(self.bounds)
        for i, b in enumerate(self.bounds):
            if v <= b:
                idx = i
                break
        with self._lock:
            self._counts[idx] += 1
            self._count += 1
            self._sum += v
            if self._min is None or v < self._min:
                self._min = v
            if self._max is None or v > self._max:
                self._max = v

    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            buckets = {}
            for b, c in zip(self.bounds, self._counts):
                buckets[f"le_{b:g}"] = c
            buckets["overflow"] = self._counts[-1]
            return {
                "count": self._count,
                "sum": self._sum,
                "min": self._min,
                "max": self._max,
                "buckets": buckets,
            }


class MetricsRegistry:
    """Thread-safe get-or-create registry of named, labeled instruments."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, object] = {}

    def _get_or_create(self, cls, name: str, labels: Mapping[str, str],
                       *extra):
        key = metric_key(name, labels)
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = cls(name, labels, *extra)
                self._metrics[key] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {key!r} already registered as "
                    f"{type(m).__name__}, requested {cls.__name__}"
                )
            return m

    def counter(self, name: str, **labels: str) -> Counter:
        return self._get_or_create(Counter, name, labels)

    def gauge(self, name: str, **labels: str) -> Gauge:
        return self._get_or_create(Gauge, name, labels)

    def histogram(self, name: str, bounds: Sequence[float] = DEFAULT_BOUNDS,
                  **labels: str) -> Histogram:
        return self._get_or_create(Histogram, name, labels, bounds)

    def snapshot(self, prefix: Optional[str] = None) -> Dict[str, Dict[str, object]]:
        """Point-in-time view: ``{"counters": {key: int}, "gauges":
        {key: {"value", "hwm"}}, "histograms": {key: {...}}}``, filtered
        by metric-name ``prefix`` when given."""
        with self._lock:
            items = list(self._metrics.items())
        snap = {"counters": {}, "gauges": {}, "histograms": {}}
        for key, m in items:
            if prefix and not m.name.startswith(prefix):
                continue
            if isinstance(m, Counter):
                snap["counters"][key] = m.value
            elif isinstance(m, Gauge):
                snap["gauges"][key] = {"value": m.value, "hwm": m.hwm}
            else:
                snap["histograms"][key] = m.snapshot()
        return snap


_DEFAULT = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-wide default registry all layers instrument against."""
    return _DEFAULT
