"""Process-wide metrics registry: labeled counters, gauges, histograms.

One registry per process (``get_registry()``); every layer of the
shuffle stack registers named instruments against it and the e2e
artifacts (``metrics_snapshot()``, ``chip_smoke.py``'s phases) read a
point-in-time ``snapshot()``.

Conventions (see docs/OBSERVABILITY.md):

- names are dotted ``layer.metric`` (``transport.sends``,
  ``rpc.messages``, ``writer.spill_bytes``, ``mempool.hits``,
  ``hbm.spill_victims``, ``reader.remote_bytes``,
  ``exchange.bytes_sent``);
- labels are low-cardinality key=value pairs (``role=exec-0``,
  ``purpose=data``, ``type=FETCH_PARTITION_LOCATIONS``,
  ``schedule=ring``);
- snapshot keys render as ``name{k=v,...}`` with label keys sorted.

Everything here is stdlib-only and import-cycle-free: the rest of the
package may import this module unconditionally.

A copy of the JAX package's ``obs/metrics.py``: the same declared
families, keys and snapshot shape, so a snapshot of either package
reads the same way.
"""

from __future__ import annotations

import json
import threading
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

# Exponential-ish latency bounds in milliseconds; the last bucket in a
# snapshot is the overflow (> bounds[-1]).
DEFAULT_BOUNDS: Tuple[float, ...] = (
    1, 2, 5, 10, 20, 50, 100, 200, 500, 1000, 2000, 5000, 10000,
)

# -- declared metric families ---------------------------------------------
# name -> (kind, frozenset of label keys). The single source of truth
# the metric-families analysis pass checks every library call site
# against (the JAX package's analysis/metrics_pass.py): an undeclared name,
# a kind mismatch, or a label set that drops/invents a key fails the
# lint. Every family listed here must have an anchor in
# docs/OBSERVABILITY.md. Tests may mint ad-hoc instruments freely.
_L = frozenset
METRIC_FAMILIES: Dict[str, Tuple[str, frozenset]] = {
    # admission control (tenancy/admission.py)
    "admission.admitted": ("counter", _L({"tenant"})),
    "admission.queue_waits": ("counter", _L({"tenant"})),
    "admission.timeouts": ("counter", _L({"tenant"})),
    "admission.wait_ms": ("histogram", _L({"tenant"})),
    "admission.inflight": ("gauge", _L({"role"})),
    "admission.queue_depth": ("gauge", _L({"role"})),
    # columnar block format (shuffle/columnar.py, writer/columnar.py)
    "block.columnar_blocks": ("counter", _L({"role"})),
    "block.columnar_bytes": ("counter", _L({"role"})),
    "block.pickle_fallbacks": ("counter", _L({"role"})),
    "block.view_decodes": ("counter", _L({"role"})),
    # whole-stage collective shuffle (shuffle/collective.py, planner.py)
    "collective.plans": ("counter", _L({"role"})),
    "collective.waves": ("counter", _L({"role", "schedule"})),
    "collective.blocks": ("counter", _L({"role"})),
    "collective.bytes": ("counter", _L({"role"})),
    "collective.fused_merges": ("counter", _L({"role"})),
    "collective.degrades": ("counter", _L({"role"})),
    "collective.compiles": ("counter", _L({"role"})),
    "collective.cache_hits": ("counter", _L({"role"})),
    "collective.lane_plans": ("counter", _L({"role"})),
    "collective.plan_ms": ("histogram", _L({"role"})),
    "collective.wave_ms": ("histogram", _L({"role", "schedule"})),
    "collective.wave_dispatch_ms": ("histogram", _L({"role", "schedule"})),
    "collective.wave_inflight": ("histogram", _L({"role"})),
    "collective.wave_overlap_ms": ("counter", _L({"role"})),
    "collective.autotune_adjustments": ("counter", _L({"role"})),
    "collective.tuned_wave_bytes": ("gauge", _L({"role"})),
    # critical-path attribution (obs/critpath.py)
    "critpath.builds": ("counter", _L({"role"})),
    "critpath.build_ms": ("histogram", _L({"role"})),
    "critpath.coverage_pct": ("gauge", _L()),
    # continuous profiling plane (obs/profiler.py)
    "profile.samples": ("counter", _L({"role"})),
    "profile.dropped": ("counter", _L({"role"})),
    "profile.overhead_ms": ("counter", _L({"role"})),
    "profile.stacks": ("gauge", _L({"role"})),
    # device fetch plane (shuffle/device_fetch.py, device_io.py)
    "device_fetch.bytes": ("counter", _L()),
    "device_fetch.stage_ms": ("histogram", _L()),
    "device_fetch.transport_ms": ("histogram", _L()),
    "device_fetch.plane.bytes": ("counter", _L({"role"})),
    "device_fetch.plane.fallbacks": ("counter", _L({"role"})),
    "device_fetch.plane.pulls": ("counter", _L({"role"})),
    "device_fetch.plane.plan_ms": ("histogram", _L({"role"})),
    # elastic cluster: replication, speculation, service (elastic/)
    "elastic.publishes_dropped": ("counter", _L({"role"})),
    "elastic.replica_promotions": ("counter", _L({"role"})),
    "elastic.replica_accepts": ("counter", _L({"role"})),
    "elastic.replica_drops": ("counter", _L({"role"})),
    "elastic.replicated_maps": ("counter", _L({"role"})),
    "elastic.replicated_bytes": ("counter", _L({"role"})),
    "elastic.replica_errors": ("counter", _L({"role"})),
    "elastic.speculations": ("counter", _L({"role"})),
    "elastic.speculation_wins": ("counter", _L({"role"})),
    "elastic.clone_cancels": ("counter", _L({"role"})),
    "elastic.recoveries": ("counter", _L({"role"})),
    "elastic.recomputed_maps": ("counter", _L({"role"})),
    "elastic.handoff_maps": ("counter", _L({"role"})),
    # engine (engine/)
    "engine.stage_recomputes": ("counter", _L()),
    "engine.task_ms": ("histogram", _L({"kind", "role", "tenant"})),
    # device exchange plane (ops/)
    "exchange.exchanges": ("counter", _L({"schedule"})),
    "exchange.bytes_sent": ("counter", _L({"schedule"})),
    "exchange.bytes_received": ("counter", _L({"schedule"})),
    "exchange.bytes_received_valid": ("counter", _L({"schedule"})),
    "exchange.time_ms": ("histogram", _L({"schedule"})),
    # hash join (models/hashjoin.py; ops/sort.py probe_sorted's counters)
    "hashjoin.probes": ("counter", _L()),
    "hashjoin.probe_bucket_steps": ("counter", _L()),
    # HBM arena (ops/hbm_arena.py)
    "hbm.pool_hits": ("counter", _L()),
    "hbm.pool_misses": ("counter", _L()),
    "hbm.spill_victims": ("counter", _L()),
    "hbm.disk_spills": ("counter", _L()),
    "hbm.in_use_bytes": ("gauge", _L()),
    # registered-buffer pool (memory/)
    "mempool.hits": ("counter", _L()),
    "mempool.misses": ("counter", _L()),
    "mempool.returns": ("counter", _L()),
    "mempool.frees": ("counter", _L()),
    "mempool.registrations": ("counter", _L()),
    "mempool.deregistrations": ("counter", _L()),
    "mempool.in_use_bytes": ("gauge", _L()),
    # control-plane HA metadata hub (sparkrdma_tpu_torch/metastore)
    "metastore.shards": ("gauge", _L({"role"})),
    "metastore.epoch": ("gauge", _L({"role"})),
    "metastore.lease_renewals": ("counter", _L({"role"})),
    "metastore.lease_takeovers": ("counter", _L({"role"})),
    "metastore.stale_epoch_rejects": ("counter", _L({"role"})),
    "metastore.peer_kills": ("counter", _L({"role"})),
    "metastore.adoptions": ("counter", _L({"role"})),
    "metastore.readoption_ms": ("histogram", _L({"role"})),
    # adaptive partition planner (shuffle/planner.py)
    "planner.splits": ("counter", _L({"role"})),
    "planner.coalesces": ("counter", _L({"role"})),
    "planner.plan_ms": ("histogram", _L({"role"})),
    # push-based merge (shuffle/merge.py)
    "push.pushed_blocks": ("counter", _L({"role"})),
    "push.pushed_bytes": ("counter", _L({"role"})),
    "push.merged_bytes": ("counter", _L({"role"})),
    "push.merge_segments": ("counter", _L({"role"})),
    "push.budget_drops": ("counter", _L({"role"})),
    "push.dedup_drops": ("counter", _L({"role"})),
    "push.dropped": ("counter", _L({"role"})),
    "push.fallbacks": ("counter", _L({"role"})),
    "push.send_errors": ("counter", _L({"role"})),
    "push.skipped": ("counter", _L({"role"})),
    # reduce/reader plane (shuffle/reader/)
    "reader.local_blocks": ("counter", _L({"role"})),
    "reader.local_bytes": ("counter", _L({"role"})),
    "reader.remote_blocks": ("counter", _L({"role"})),
    "reader.remote_bytes": ("counter", _L({"role"})),
    "reader.merged_reads": ("counter", _L({"role"})),
    "reader.fetch_wait_ms": ("counter", _L({"role"})),
    "reader.fetch_ms": ("histogram", _L({"role"})),
    "reader.remote_fetch_ms": ("histogram", _L({"peer"})),
    "reader.inflight_bytes": ("gauge", _L({"role"})),
    "reader.pipeline.inflight": ("gauge", _L({"role"})),
    "reader.pipeline.stage_ms": ("histogram", _L({"role", "stage"})),
    "reader.pipeline.overlap_ms": ("histogram", _L({"role"})),
    # resilience ladder (shuffle/fetcher.py, resilience.py)
    "resilience.retries": ("counter", _L({"role"})),
    "resilience.failovers": ("counter", _L({"role"})),
    "resilience.splits": ("counter", _L({"role"})),
    "resilience.checksum_failures": ("counter", _L({"role"})),
    "resilience.circuit_open": ("counter", _L({"role"})),
    "resilience.circuit_close": ("counter", _L({"role"})),
    "resilience.circuit_fail_fast": ("counter", _L({"role"})),
    "resilience.straggler_advisories": ("counter", _L({"role"})),
    # control-plane RPC (shuffle/manager.py)
    "rpc.messages": ("counter", _L({"role", "type"})),
    "rpc.errors": ("counter", _L({"role"})),
    "rpc.handle_ms": ("histogram", _L({"role", "type"})),
    # cluster event journal (obs/journal.py)
    "journal.events": ("counter", _L({"role"})),
    "journal.merged": ("counter", _L({"role"})),
    "journal.duplicates": ("counter", _L({"role"})),
    "journal.gaps": ("counter", _L({"role"})),
    "journal.size": ("gauge", _L({"role"})),
    # USE-method capacity plane (obs/capacity.py)
    "capacity.evaluations": ("counter", _L({"role"})),
    "capacity.utilization": ("gauge", _L({"resource"})),
    "capacity.saturation": ("gauge", _L({"resource"})),
    "capacity.errors": ("gauge", _L({"resource"})),
    "capacity.binding_headroom": ("gauge", _L({"role"})),
    # SLO engine + automated diagnosis (obs/slo.py, obs/diagnose.py)
    "slo.evaluations": ("counter", _L({"role"})),
    "slo.objectives": ("gauge", _L({"role"})),
    "slo.breaches": ("counter", _L({"objective", "role", "severity"})),
    "slo.breaching": ("gauge", _L({"role"})),
    "slo.burn_rate": ("gauge", _L({"objective", "role", "window"})),
    "diagnosis.builds": ("counter", _L({"role"})),
    "diagnosis.build_ms": ("histogram", _L({"role"})),
    # cluster telemetry plane (obs/telemetry.py)
    "telemetry.heartbeats": ("counter", _L({"executor", "role"})),
    "telemetry.bad_payloads": ("counter", _L({"role"})),
    "telemetry.executors": ("gauge", _L({"role"})),
    "telemetry.missed_heartbeats": ("gauge", _L({"role"})),
    "telemetry.straggler": ("gauge", _L({"executor", "role"})),
    "telemetry.stragglers": ("gauge", _L({"role"})),
    # tenancy: fair share + quotas (tenancy/)
    "tenant.submits": ("counter", _L({"tenant", "pool"})),
    "tenant.tasks": ("counter", _L({"tenant", "pool"})),
    "tenant.task_ms": ("histogram", _L({"tenant", "pool"})),
    "tenant.wait_ms": ("histogram", _L({"tenant", "pool"})),
    "tenant.queued": ("gauge", _L({"tenant", "pool"})),
    "tenant.quota_blocks": ("counter", _L({"resource", "tenant"})),
    "tenant.quota_overruns": ("counter", _L({"resource", "tenant"})),
    "tenant.quota_wait_ms": ("histogram", _L({"resource", "tenant"})),
    "tenant.bytes": ("gauge", _L({"resource", "tenant"})),
    # perf-trend engine over bench ledgers (obs/trend.py)
    "trend.rounds": ("gauge", _L({"family"})),
    "trend.series": ("gauge", _L()),
    "trend.regressions": ("counter", _L()),
    "trend.skipped_rows": ("counter", _L()),
    # host transport (transport/)
    "transport.connects": ("counter", _L({"purpose"})),
    "transport.connect_retries": ("counter", _L({"purpose"})),
    "transport.accepts": ("counter", _L({"purpose"})),
    "transport.completions": ("counter", _L({"purpose"})),
    "transport.errors_latched": ("counter", _L({"purpose"})),
    "transport.sends": ("counter", _L({"purpose"})),
    "transport.send_bytes": ("counter", _L({"purpose"})),
    "transport.send_overflow": ("counter", _L({"purpose"})),
    "transport.recvs": ("counter", _L({"purpose"})),
    "transport.recv_bytes": ("counter", _L({"purpose"})),
    "transport.reads": ("counter", _L({"purpose"})),
    "transport.read_bytes": ("counter", _L({"purpose"})),
    "transport.reads_served": ("counter", _L({"purpose"})),
    "transport.read_bytes_served": ("counter", _L({"purpose"})),
    "transport.read_errors": ("counter", _L({"purpose"})),
    # native read submission plane (native/transport.cpp SubmissionPlane,
    # mirrored from the C++ atomics by transport/native_node.py);
    # process-global: multiple in-process nodes sum into one family
    "transport.sq.submits": ("counter", _L()),
    "transport.sq.batches": ("counter", _L()),
    "transport.sq.sqe_depth": ("gauge", _L()),
    "transport.sq.completions": ("counter", _L()),
    "transport.sq.backend_fallbacks": ("counter", _L()),
    "transport.consume.workers": ("gauge", _L()),
    "transport.consume.busy_ms": ("counter", _L()),
    # map/writer plane (shuffle/writer/)
    "writer.map_outputs": ("counter", _L({"method", "role"})),
    "writer.bytes_written": ("counter", _L({"role"})),
    "writer.flush_bytes": ("counter", _L({"role"})),
    "writer.partition_flushes": ("counter", _L({"role"})),
    "writer.partitions_written": ("counter", _L({"role"})),
    "writer.publishes": ("counter", _L({"role"})),
    "writer.incremental_publishes": ("counter", _L({"role"})),
    "writer.locations_published": ("counter", _L({"role"})),
    "writer.blocks_memory": ("counter", _L()),
    "writer.blocks_spilled": ("counter", _L()),
    "writer.spill_bytes": ("counter", _L()),
    "writer.chunk_allocations": ("counter", _L()),
    "writer.chunk_recycles": ("counter", _L()),
    "writer.pipeline.inflight": ("gauge", _L({"role"})),
    "writer.pipeline.stage_ms": ("histogram", _L({"role", "stage"})),
    "writer.pipeline.overlap_ms": ("histogram", _L({"role"})),
}
del _L


def metric_key(name: str, labels: Mapping[str, str]) -> str:
    """Canonical snapshot key: ``name`` or ``name{k=v,...}`` (sorted)."""
    if not labels:
        return name
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{inner}}}"


def parse_metric_key(key: str) -> Tuple[str, Dict[str, str]]:
    """Inverse of :func:`metric_key`: ``name{k=v,...}`` -> (name, labels).

    Label values are low-cardinality identifiers by convention (roles,
    purposes, message types) and never contain ``,`` or ``}``."""
    if not key.endswith("}"):
        return key, {}
    name, _, inner = key[:-1].partition("{")
    labels: Dict[str, str] = {}
    for kv in inner.split(","):
        if not kv:
            continue
        k, _, v = kv.partition("=")
        labels[k] = v
    return name, labels


def strip_label(key: str, *label_keys: str) -> str:
    """Canonical key with the given label keys removed (cross-executor
    comparison: drop ``role``/``executor`` so the same instrument on two
    executors folds to one comparable key)."""
    name, labels = parse_metric_key(key)
    for k in label_keys:
        labels.pop(k, None)
    return metric_key(name, labels)


def snapshot_delta(
    prev: Mapping[str, Mapping[str, object]],
    cur: Mapping[str, Mapping[str, object]],
) -> Dict[str, Dict[str, object]]:
    """Reset-safe diff of two ``snapshot()`` dicts.

    Counters and histogram count/sum/per-bucket counts are differenced;
    gauges report their current state. A *negative* difference means the instrument
    was zeroed (``reset()``) after ``prev`` was taken — the Prometheus
    counter-reset rule applies: the delta restarts from the current
    value instead of going negative, so a long-lived consumer holding a
    moving baseline (the telemetry Heartbeater) never resurrects
    pre-reset totals."""
    prev_c = prev.get("counters", {})
    prev_h = prev.get("histograms", {})
    out: Dict[str, Dict[str, object]] = {
        "counters": {},
        "gauges": dict(cur.get("gauges", {})),
        "histograms": {},
    }
    for key, v in cur.get("counters", {}).items():
        d = v - prev_c.get(key, 0)
        out["counters"][key] = v if d < 0 else d
    for key, h in cur.get("histograms", {}).items():
        ph = prev_h.get(key, {})
        dc = h["count"] - ph.get("count", 0)
        ds = h["sum"] - ph.get("sum", 0.0)
        cur_b = h.get("buckets") or {}
        prev_b = ph.get("buckets") or {}
        db = {b: c - prev_b.get(b, 0) for b, c in cur_b.items()}
        if dc < 0 or ds < 0 or any(v < 0 for v in db.values()):
            dc, ds, db = h["count"], h["sum"], dict(cur_b)
        entry: Dict[str, object] = {
            "count": dc,
            "sum": ds,
            "min": h["min"],
            "max": h["max"],
        }
        if cur_b:
            entry["buckets"] = db
        out["histograms"][key] = entry
    return out


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
    """Fixed-bound histogram (count/sum/min/max + per-bucket counts).

    ``bounds`` are inclusive upper edges; one extra overflow bucket
    catches everything above ``bounds[-1]``.
    """

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
        # hot: held for dict lookups only, every layer's instrument
        # resolution goes through it (lock-order detector, docs/ANALYSIS.md)
        from sparkrdma_tpu_torch.analysis.lockorder import named_lock

        self._lock = named_lock("metrics.registry", hot=True)
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

    # -- read side --------------------------------------------------------
    def _select(self, match: Optional[Mapping[str, str]],
                prefix: Optional[str]) -> List[Tuple[str, object]]:
        with self._lock:
            items = list(self._metrics.items())
        out = []
        for key, m in items:
            if prefix and not m.name.startswith(prefix):
                continue
            if match:
                # A metric matches if every requested label either equals
                # the requested value or is absent on the metric (shared /
                # process-global instruments stay visible in role views).
                labels = m.labels
                if any(labels.get(k, v) != v for k, v in match.items()):
                    continue
            out.append((key, m))
        return out

    def snapshot(self, match: Optional[Mapping[str, str]] = None,
                 prefix: Optional[str] = None) -> Dict[str, Dict[str, object]]:
        """Point-in-time view: ``{"counters": {key: int}, "gauges":
        {key: {"value", "hwm"}}, "histograms": {key: {...}}}``.

        ``match`` filters by labels (metrics lacking a requested label
        key are included); ``prefix`` filters by metric-name prefix.
        """
        snap = {"counters": {}, "gauges": {}, "histograms": {}}
        for key, m in self._select(match, prefix):
            if isinstance(m, Counter):
                snap["counters"][key] = m.value
            elif isinstance(m, Gauge):
                snap["gauges"][key] = {"value": m.value, "hwm": m.hwm}
            else:
                snap["histograms"][key] = m.snapshot()
        return snap

    def delta(self, prev: Mapping[str, Mapping[str, object]],
              match: Optional[Mapping[str, str]] = None,
              prefix: Optional[str] = None) -> Dict[str, Dict[str, object]]:
        """Change since a prior ``snapshot()``: counters and histogram
        count/sum are differenced (reset-safe, see
        :func:`snapshot_delta`); gauges report their current state."""
        return snapshot_delta(prev, self.snapshot(match, prefix))

    def to_json(self, match: Optional[Mapping[str, str]] = None,
                prefix: Optional[str] = None, indent: Optional[int] = None
                ) -> str:
        return json.dumps(self.snapshot(match, prefix), indent=indent,
                          sort_keys=True)

    def reset(self) -> None:
        """Zero every registered instrument in place (tests only).

        Instruments are NOT dropped: modules pre-resolve and cache them
        at import (e.g. the mempool counters in memory/buffer_manager),
        so clearing the dict would orphan those references — they would
        keep counting into objects no snapshot can see for the rest of
        the process.
        """
        with self._lock:
            for m in self._metrics.values():
                with m._lock:
                    if isinstance(m, Counter):
                        m._value = 0
                    elif isinstance(m, Gauge):
                        m._value = 0
                        m._hwm = 0
                    else:
                        m._counts = [0] * (len(m.bounds) + 1)
                        m._count = 0
                        m._sum = 0.0
                        m._min = None
                        m._max = None


    def family_violations(self) -> List[str]:
        """Registered instruments that contradict METRIC_FAMILIES.

        The runtime complement of the static metric-families lint: it
        sees instruments minted through dynamic helpers (e.g. the
        fair-share executor's cached ``getattr(reg, kind)`` factories)
        that no AST pass can. Undeclared names are ignored — tests mint
        ad-hoc instruments freely; only declared families are held to
        their kind and label set."""
        kinds = {Counter: "counter", Gauge: "gauge", Histogram: "histogram"}
        out: List[str] = []
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            fam = METRIC_FAMILIES.get(m.name)
            if fam is None:
                continue
            kind, labels = fam
            if kinds[type(m)] != kind:
                out.append(
                    f"{m.name}: registered as {kinds[type(m)]}, "
                    f"declared {kind}"
                )
            if frozenset(m.labels) != labels:
                out.append(
                    f"{m.name}: label set {sorted(m.labels)} != "
                    f"declared {sorted(labels)}"
                )
        return out


_DEFAULT = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-wide default registry all layers instrument against."""
    return _DEFAULT
