"""Bounded per-executor time-series ring buffers for the telemetry hub.

One :class:`TimeSeriesRing` per executor on the driver: each heartbeat
payload (a labeled ``MetricsRegistry.delta()`` plus in-flight gauge
samples) folds into a wall-bucketed :class:`Window`. Buckets are
``wall_ms // interval_ms``; two payloads landing in the same bucket
merge (counter/histogram deltas sum, gauges keep the latest sample), so
the ring is a fixed-rate timeline regardless of heartbeat jitter. The
ring is capped (``obs.telemetry.ringSize``) — the hub's memory is
O(executors × ringSize × instruments) no matter how long the job runs.

Everything here is stdlib-only and jax-free (same rule as
``obs/metrics.py``).
A copy of the JAX package's ``obs/timeseries.py``.

"""

from __future__ import annotations

import threading
from collections import deque
from typing import Dict, List, Mapping, Optional


class Window:
    """One wall bucket of one executor's telemetry.

    ``counters``/``histograms`` hold *deltas* over the bucket;
    ``gauges`` hold the latest point-in-time sample. ``gap`` marks that
    at least one heartbeat was lost or late immediately before this
    window (sequence jump or wall-clock staleness) — the timeline shows
    the hole instead of silently smearing it."""

    __slots__ = ("bucket", "wall_ms", "seq", "counters", "gauges",
                 "histograms", "gap")

    def __init__(self, bucket: int, wall_ms: int, seq: int,
                 counters: Dict[str, int],
                 gauges: Dict[str, Dict[str, object]],
                 histograms: Dict[str, Dict[str, float]],
                 gap: bool = False):
        self.bucket = bucket
        self.wall_ms = wall_ms
        self.seq = seq
        self.counters = counters
        self.gauges = gauges
        self.histograms = histograms
        self.gap = gap

    def merge(self, other: "Window") -> None:
        """Fold a same-bucket window in: deltas sum, gauges refresh."""
        for k, v in other.counters.items():
            self.counters[k] = self.counters.get(k, 0) + v
        for k, h in other.histograms.items():
            mine = self.histograms.get(k)
            if mine is None:
                self.histograms[k] = dict(h)
            else:
                mine["count"] = mine.get("count", 0) + h.get("count", 0)
                mine["sum"] = mine.get("sum", 0.0) + h.get("sum", 0.0)
                theirs = h.get("buckets")
                if theirs:
                    mb = mine.setdefault("buckets", {})
                    for b, c in theirs.items():
                        mb[b] = mb.get(b, 0) + c
        self.gauges.update(other.gauges)
        self.wall_ms = max(self.wall_ms, other.wall_ms)
        self.seq = max(self.seq, other.seq)
        self.gap = self.gap or other.gap

    def to_dict(self) -> Dict[str, object]:
        return {
            "bucket": self.bucket,
            "wall_ms": self.wall_ms,
            "seq": self.seq,
            "gap": self.gap,
            "counters": dict(self.counters),
            "gauges": dict(self.gauges),
            "histograms": {k: dict(v) for k, v in self.histograms.items()},
        }


class TimeSeriesRing:
    """Bounded, wall-bucketed window ring for one executor. Thread-safe."""

    def __init__(self, size: int, interval_ms: int):
        self.size = max(1, int(size))
        self.interval_ms = max(1, int(interval_ms))
        self._windows: "deque[Window]" = deque(maxlen=self.size)
        self._lock = threading.Lock()
        self.last_wall_ms: int = 0
        self.last_seq: int = 0

    def append(
        self,
        wall_ms: int,
        seq: int,
        counters: Optional[Mapping[str, int]] = None,
        gauges: Optional[Mapping[str, Dict[str, object]]] = None,
        histograms: Optional[Mapping[str, Dict[str, float]]] = None,
        gap: bool = False,
    ) -> Window:
        """Fold one heartbeat payload into its wall bucket."""
        bucket = int(wall_ms) // self.interval_ms
        win = Window(bucket, int(wall_ms), int(seq),
                     dict(counters or {}), dict(gauges or {}),
                     {k: dict(v) for k, v in (histograms or {}).items()},
                     gap=gap)
        with self._lock:
            if self._windows and self._windows[-1].bucket == bucket:
                self._windows[-1].merge(win)
                win = self._windows[-1]
            else:
                self._windows.append(win)
            self.last_wall_ms = max(self.last_wall_ms, int(wall_ms))
            self.last_seq = max(self.last_seq, int(seq))
        return win

    def windows(self, last: Optional[int] = None) -> List[Window]:
        with self._lock:
            wins = list(self._windows)
        if last is not None:
            wins = wins[-last:]
        return wins

    def __len__(self) -> int:
        with self._lock:
            return len(self._windows)

    def rollup(self, last: Optional[int] = None) -> Dict[str, Dict[str, float]]:
        """Sum of counter/histogram deltas (and latest gauges) over the
        retained (or last N) windows — the hub's cross-window view."""
        counters: Dict[str, float] = {}
        histograms: Dict[str, Dict[str, float]] = {}
        gauges: Dict[str, Dict[str, object]] = {}
        for w in self.windows(last):
            for k, v in w.counters.items():
                counters[k] = counters.get(k, 0) + v
            for k, h in w.histograms.items():
                agg = histograms.setdefault(k, {"count": 0, "sum": 0.0})
                agg["count"] += h.get("count", 0)
                agg["sum"] += h.get("sum", 0.0)
                hb = h.get("buckets")
                if hb:
                    ab = agg.setdefault("buckets", {})
                    for b, c in hb.items():
                        ab[b] = ab.get(b, 0) + c
            gauges.update(w.gauges)
        return {"counters": counters, "histograms": histograms,
                "gauges": gauges}

    def to_list(self, last: Optional[int] = None) -> List[Dict[str, object]]:
        return [w.to_dict() for w in self.windows(last)]
