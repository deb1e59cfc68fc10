"""Cluster telemetry plane: executor heartbeats -> driver time-series.

Every process keeps its own registry; this module carries the
executors' signal to the driver while a job runs (the Dapper-style move
of centralizing cross-role signal, applied to metrics):

- :class:`Heartbeater` runs on each executor: every
  ``obs.telemetry.intervalMs`` it takes a role-filtered
  ``MetricsRegistry`` snapshot, diffs it against a *moving baseline*
  (reset-safe, :func:`~sparkrdma_tpu_torch.obs.metrics.snapshot_delta`), and
  ships the labeled delta + in-flight gauge samples either directly
  (in-process clusters: ``send=hub.ingest``) or into a bounded outbox
  the driver pulls over the engine control plane (the ``"telemetry"``
  task-protocol kind in ``engine/worker.py`` / ``engine/cluster.py``).
- :class:`TelemetryHub` runs on the driver: heartbeats fold into
  bounded per-executor :class:`~sparkrdma_tpu_torch.obs.timeseries.TimeSeriesRing`
  buffers (wall-bucketed at the heartbeat interval, capped by
  ``obs.telemetry.ringSize``), an online straggler/skew detector runs a
  per-stage robust z-score over ``writer.pipeline.*`` /
  ``reader.pipeline.*`` / ``engine.task_ms`` busy-ms and
  ``transport.read_bytes`` / ``writer.bytes_written`` work rates, and
  two egress paths serve the result: an OpenMetrics exposition
  (``obs/export.py``, HTTP scrape on ``obs.telemetry.httpPort`` or a
  file) and a flight recorder that dumps the last N ring windows +
  recent spans + circuit-breaker states to one JSON artifact on
  ``FetchFailedError``/abort.

Flagged executors surface as ``telemetry.straggler{executor=...}``
gauges and a structured :meth:`TelemetryHub.straggler_report`, which
``SourceHealthRegistry.apply_straggler_report`` consumes as an
*advisory* signal (suspects are recorded, circuits are not opened —
docs/RESILIENCE.md).

A copy of the JAX package's ``obs/telemetry.py``, its imports rewritten
to this package; the heartbeat payload is the JAX package's, so a JAX
executor's beats fold into a port hub and the reverse. The driver's
``TpuShuffleManager`` builds the hub when ``obs.telemetry.enabled`` is
true (the default); every ``TelemetryHub`` configures its process's
event journal (``obs/journal.py``), which is process-global.

Stdlib-only and jax-free, like the rest of ``obs/``.
"""

from __future__ import annotations

import json
import logging
import os
import statistics
import tempfile
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Mapping, Optional

from sparkrdma_tpu_torch.obs import journal as _journal
from sparkrdma_tpu_torch.obs.metrics import (
    MetricsRegistry,
    get_registry,
    parse_metric_key,
    snapshot_delta,
    strip_label,
)
from sparkrdma_tpu_torch.obs.profiler import ProfileHub, SamplingProfiler
from sparkrdma_tpu_torch.obs.timeseries import TimeSeriesRing

logger = logging.getLogger(__name__)

# Metric families the straggler detector reads. Busy families are
# time-spent signals (histogram sums / counters in ms): a straggler is
# an abnormally HIGH outlier. Work families are throughput signals
# (byte counters): a straggler is an abnormally LOW outlier.
BUSY_PREFIXES = ("writer.pipeline.stage_ms", "reader.pipeline.stage_ms",
                 "engine.task_ms")
WORK_PREFIXES = ("transport.read_bytes", "writer.bytes_written")

# Detection guards: a stage is only scored when at least MIN_PARTICIPANTS
# executors report nonzero activity on it (an executor that simply was
# not scheduled any reduce range is not a straggler), a busy flag needs
# a real absolute excess over the median, and a work flag needs the
# value to fall below half the median of a non-trivial workload.
MIN_PARTICIPANTS = 3
MIN_BUSY_EXCESS_MS = 50.0
MIN_WORK_MEDIAN_BYTES = 1 << 16
# MAD == 0 fallback: treat 15% of the median as one deviation unit so
# identical-but-for-jitter executors don't divide by zero into flags.
MAD_FALLBACK_FRACTION = 0.15
# A heartbeat is "missed" once nothing arrived for this many intervals.
MISSED_AFTER_INTERVALS = 2.5


def _hist_payload(h: Mapping) -> dict:
    """Wire form of one histogram delta: count/sum plus the FULL
    per-bucket delta vector — what the hub's rings need to evaluate
    latency SLOs. Zero entries are kept deliberately: the exceedance
    snap (obs/slo.py) derives the instrument's bound set from the keys,
    and a pruned vector would snap a threshold past absent bounds and
    under-count real exceedances. Idle instruments (zero count delta)
    are pruned entirely at the call site, so this costs nothing while
    nothing happens."""
    out = {"count": h["count"], "sum": h["sum"]}
    buckets = h.get("buckets")
    if buckets:
        out["buckets"] = dict(buckets)
    return out


def _robust_z(value: float, values: List[float]) -> float:
    """Robust z-score of ``value`` within ``values`` (median/MAD)."""
    med = statistics.median(values)
    mad = statistics.median(abs(v - med) for v in values)
    scale = 1.4826 * mad
    if scale <= 0.0:
        scale = max(MAD_FALLBACK_FRACTION * abs(med), 1e-9)
    return (value - med) / scale


class Heartbeater:
    """Executor-side heartbeat loop over a moving registry baseline.

    Each :meth:`beat` produces one payload::

        {"v": 1, "executor_id": ..., "seq": n, "wall_ms": ...,
         "interval_ms": ..., "counters": {key: delta != 0},
         "gauges": {key: {"value", "hwm"}},
         "histograms": {key: {"count": dc, "sum": ds,
                              "buckets": <full per-bucket deltas>}
                        for keys with dc != 0}

    With ``send`` the payload ships immediately (in-process hub);
    without, it lands in a bounded outbox the driver drains via the
    ``"telemetry"`` control-plane request (``seq`` keeps counting when
    the outbox overflows, so the hub sees the gap). ``pause()`` /
    ``resume()`` simulate a lost executor without stopping the thread.
    """

    def __init__(
        self,
        registry: MetricsRegistry,
        executor_id: str,
        interval_ms: int = 1000,
        send: Optional[Callable[[dict], None]] = None,
        match: Optional[Mapping[str, str]] = None,
        outbox_size: int = 256,
        clock: Callable[[], float] = time.time,
        profiler: Optional[SamplingProfiler] = None,
    ):
        self._registry = registry
        self.executor_id = executor_id
        self.interval_ms = max(1, int(interval_ms))
        self._send = send
        self._match = dict(match) if match else None
        self._clock = clock
        self._profiler = profiler
        self._outbox: "deque[dict]" = deque(maxlen=max(1, outbox_size))
        self._lock = threading.Lock()
        self._prev = registry.snapshot(self._match)
        self._seq = 0
        self._paused = False
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # event-journal shipping state: cursor into the process journal
        # plus the previous beat's batch (one-beat redundancy). The
        # journal is resolved per beat (active_journal) so a journal
        # configured after this heartbeater starts still ships.
        self._journal_override: Optional[_journal.EventJournal] = None
        self._journal_cursor = 0
        self._journal_prev: List[dict] = []

    def beat(self) -> Optional[dict]:
        """One sample: delta vs the moving baseline, then advance it."""
        with self._lock:
            if self._paused:
                return None
            cur = self._registry.snapshot(self._match)
            delta = snapshot_delta(self._prev, cur)
            self._prev = cur
            self._seq += 1
            seq = self._seq
        from sparkrdma_tpu_torch.obs.trace import epoch_anchor

        payload = {
            "v": 1,
            "executor_id": self.executor_id,
            "seq": seq,
            "wall_ms": int(self._clock() * 1000),
            "interval_ms": self.interval_ms,
            # wall-clock anchor of this process's span timeline: the
            # hub hands these to the trace exporter so cross-process
            # merges don't skew by per-process module-load epochs
            "epoch_ms": int(epoch_anchor() * 1000),
            "counters": {k: v for k, v in delta["counters"].items() if v},
            "gauges": {
                k: g for k, g in delta["gauges"].items()
                if g.get("value") or g.get("hwm")
            },
            "histograms": {
                k: _hist_payload(h)
                for k, h in delta["histograms"].items()
                if h["count"]
            },
        }
        # continuous-profiling piggyback: the collapsed-stack table
        # folded since the last beat rides the same payload/pull path
        if self._profiler is not None:
            profile = self._profiler.drain()
            if profile:
                payload["profile"] = profile
        # event-journal piggyback: heartbeats are the causality-carrying
        # messages of the journal's HLC protocol. Each beat ships the
        # PREVIOUS beat's batch again alongside the new events (one-beat
        # redundancy), so a single lost heartbeat loses nothing and the
        # hub's (origin, seq) dedupe folds the overlap to one copy.
        j = self._journal_override or _journal.active_journal()
        if j is not None:
            with self._lock:
                fresh = j.events_since(self._journal_cursor)
                if fresh:
                    self._journal_cursor = fresh[-1]["seq"]
                batch = self._journal_prev + fresh
                self._journal_prev = fresh
            if batch:
                payload["journal"] = batch
        if self._send is not None:
            try:
                self._send(payload)
            except Exception:
                logger.debug("heartbeat send failed", exc_info=True)
        else:
            self._outbox.append(payload)
        return payload

    def drain(self) -> List[dict]:
        """Pull-side: hand over (and clear) the buffered payloads."""
        out: List[dict] = []
        while True:
            try:
                out.append(self._outbox.popleft())
            except IndexError:
                return out

    def attach_profiler(self, profiler: Optional[SamplingProfiler]) -> None:
        """Piggyback a sampling profiler's drained collapsed-stack
        table onto every subsequent beat (``payload["profile"]``)."""
        self._profiler = profiler

    def attach_journal(self, journal) -> None:
        """Ship this journal's events instead of the process journal
        (tests / explicit wiring); None reverts to per-beat
        ``active_journal()`` resolution."""
        self._journal_override = journal

    def pause(self) -> None:
        with self._lock:
            self._paused = True

    def resume(self) -> None:
        with self._lock:
            self._paused = False

    def start(self) -> "Heartbeater":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._loop,
                name=f"heartbeat-{self.executor_id}",
                daemon=True,
            )
            self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_ms / 1000.0):
            try:
                self.beat()
            except Exception:
                logger.exception("heartbeat loop error")

    def stop(self, flush: bool = True) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        if flush:
            self.beat()


class TelemetryHub:
    """Driver-side fold of executor heartbeats into bounded time series.

    Passive unless fed: :meth:`ingest` does all online work (ring fold,
    gap accounting, straggler detection, optional OpenMetrics file
    write), so the hub adds no threads of its own beyond the optional
    HTTP scrape server.
    """

    _flight_seq = 0

    def __init__(
        self,
        conf=None,
        *,
        role: str = "driver",
        health=None,
        registry: Optional[MetricsRegistry] = None,
        interval_ms: Optional[int] = None,
        ring_size: Optional[int] = None,
        straggler_z: Optional[float] = None,
        http_port: Optional[int] = None,
        openmetrics_file: Optional[str] = None,
        flight_dir: Optional[str] = None,
        flight_windows: Optional[int] = None,
        clock: Callable[[], float] = time.time,
    ):
        self.role = role
        self._health = health
        self._registry = registry or get_registry()
        self._clock = clock
        self.interval_ms = int(
            interval_ms
            if interval_ms is not None
            else (conf.telemetry_interval_ms if conf is not None else 1000)
        )
        self.ring_size = int(
            ring_size
            if ring_size is not None
            else (conf.telemetry_ring_size if conf is not None else 128)
        )
        self.straggler_z = float(
            straggler_z
            if straggler_z is not None
            else (conf.telemetry_straggler_z if conf is not None else 3)
        )
        self._http_port = int(
            http_port
            if http_port is not None
            else (conf.telemetry_http_port if conf is not None else 0)
        )
        self._openmetrics_file = (
            openmetrics_file
            if openmetrics_file is not None
            else (conf.telemetry_openmetrics_file if conf is not None else "")
        )
        self._flight_dir = (
            flight_dir
            if flight_dir is not None
            else (conf.telemetry_flight_dir if conf is not None else "")
        )
        self.flight_windows = int(
            flight_windows
            if flight_windows is not None
            else (conf.telemetry_flight_windows if conf is not None else 16)
        )

        self._lock = threading.Lock()
        self._series: Dict[str, TimeSeriesRing] = {}
        # executor -> wall-clock span-timeline anchor (seconds), from
        # the heartbeat's epoch_ms; consumed by trace-merge exports
        self._epoch_anchors: Dict[str, float] = {}
        # per-executor missed-heartbeat accounting: True once the gap
        # was counted; cleared (and surfaced as a ring gap marker) when
        # the executor resumes
        self._missed_counted: Dict[str, bool] = {}
        self._last_report: dict = {"stragglers": []}
        # per-shuffle per-partition published byte totals, fed by the
        # driver's publish handler as map outputs (incremental windows
        # included) land — the adaptive partition planner's skew signal
        # (shuffle/planner.py). Bounded: oldest shuffle evicted.
        self._partition_bytes: Dict[int, Dict[int, int]] = {}
        self._partition_bytes_max_shuffles = 64
        # same totals split by SOURCE executor (the DMA "lane" of the
        # whole-stage collective schedule): shuffle -> source -> pid ->
        # bytes. Feeds the planner's lane-balanced cuts; bounded with
        # and evicted alongside _partition_bytes.
        self._partition_lane_bytes: Dict[int, Dict[str, Dict[int, int]]] = {}
        self._last_file_write_ms = 0
        self.last_flight_path: Optional[str] = None
        self.last_flight: Optional[dict] = None
        # cluster-wide merge of the executors' collapsed-stack profile
        # tables (heartbeat "profile" payloads, obs/profiler.py)
        self.profiles = ProfileHub(clock=clock)
        # cluster event journal: configure this process's journal from
        # conf (the driver-side transitions emit into it) and merge the
        # heartbeat-shipped batches into one causally-ordered record
        self.journal_flight_events = int(
            conf.journal_flight_events if conf is not None else 64
        )
        _journal.configure(conf, role=role, registry=self._registry,
                           clock=clock)
        journal_ring = int(
            conf.journal_ring_size if conf is not None else 512
        )
        self.journal = _journal.JournalHub(
            self._registry, role=role, ring_size=journal_ring * 4,
            clock=clock,
        )
        # USE-method capacity plane: evaluated on the ingest cadence
        # beside the SLO engine (obs/capacity.py)
        from sparkrdma_tpu_torch.obs.capacity import CapacityPlane

        if conf is not None:
            cap_conf = conf
        else:
            from sparkrdma_tpu_torch.utils.config import TpuShuffleConf

            cap_conf = TpuShuffleConf()
        self.capacity = CapacityPlane(
            cap_conf, self._registry, role=role, clock=clock
        )
        # last critical-path TimeBreakdown the engine attributed — the
        # diagnosis engine's dominant-category evidence (obs/attr.py)
        self.last_breakdown: Optional[dict] = None

        reg = self._registry
        self._g_executors = reg.gauge("telemetry.executors", role=role)
        self._g_missed = reg.gauge("telemetry.missed_heartbeats", role=role)
        self._g_stragglers = reg.gauge("telemetry.stragglers", role=role)
        self._c_bad = reg.counter("telemetry.bad_payloads", role=role)

        # SLO judgment layer: rides ingest() on its own cadence; every
        # page/warn transition is answered with an automated root-cause
        # diagnosis (obs/slo.py, obs/diagnose.py)
        from sparkrdma_tpu_torch.obs.slo import SLOEngine

        self.slo = SLOEngine(self, conf, registry=self._registry,
                             role=role, clock=clock)
        self.slo.on_breach = self._on_slo_breach

        self._http = None
        if self._http_port > 0:
            from sparkrdma_tpu_torch.obs.export import OpenMetricsServer

            self._http = OpenMetricsServer(
                self.render_openmetrics, port=self._http_port
            )

    # -- per-partition skew statistics (adaptive planner input) --------
    def record_partition_bytes(
        self, shuffle_id: int, pid: int, nbytes: int, source: str = ""
    ) -> None:
        """Accumulate one published location's bytes for (shuffle, pid).

        ``source`` (the publishing executor id) additionally files the
        bytes under that DMA lane for the planner's lane-balanced cuts;
        empty keeps the pre-existing totals-only accounting."""
        with self._lock:
            per = self._partition_bytes.get(shuffle_id)
            if per is None:
                while len(self._partition_bytes) >= self._partition_bytes_max_shuffles:
                    old = next(iter(self._partition_bytes))
                    self._partition_bytes.pop(old)
                    self._partition_lane_bytes.pop(old, None)
                per = self._partition_bytes[shuffle_id] = {}
            per[pid] = per.get(pid, 0) + int(nbytes)
            if source:
                lanes = self._partition_lane_bytes.setdefault(shuffle_id, {})
                lane = lanes.setdefault(source, {})
                lane[pid] = lane.get(pid, 0) + int(nbytes)

    def partition_bytes(self, shuffle_id: int) -> Dict[int, int]:
        """Per-partition byte totals observed so far for one shuffle."""
        with self._lock:
            return dict(self._partition_bytes.get(shuffle_id, ()))

    def partition_lane_bytes(self, shuffle_id: int) -> Dict[str, Dict[int, int]]:
        """Per-source per-partition byte totals (source -> pid -> bytes)."""
        with self._lock:
            lanes = self._partition_lane_bytes.get(shuffle_id, {})
            return {src: dict(per) for src, per in lanes.items()}

    def drop_partition_bytes(self, shuffle_id: int) -> None:
        with self._lock:
            self._partition_bytes.pop(shuffle_id, None)
            self._partition_lane_bytes.pop(shuffle_id, None)

    # -- ingest --------------------------------------------------------
    def ingest(self, payload: Mapping) -> None:
        """Fold one heartbeat payload into its executor's ring."""
        try:
            exec_id = str(payload["executor_id"])
            wall_ms = int(payload["wall_ms"])
            seq = int(payload.get("seq", 0))
        except (KeyError, TypeError, ValueError):
            self._c_bad.inc()
            return
        with self._lock:
            ring = self._series.get(exec_id)
            if ring is None:
                ring = TimeSeriesRing(self.ring_size, self.interval_ms)
                self._series[exec_id] = ring
            gap = False
            if ring.last_seq and seq > ring.last_seq + 1:
                gap = True
                self._g_missed.add(seq - ring.last_seq - 1)
            if self._missed_counted.pop(exec_id, False):
                gap = True  # resumed after a wall-clock gap
            anchor = payload.get("epoch_ms")
            if anchor:
                try:
                    self._epoch_anchors[exec_id] = float(anchor) / 1000.0
                except (TypeError, ValueError):
                    pass
            self._g_executors.set(len(self._series))
        ring.append(
            wall_ms,
            seq,
            counters=payload.get("counters"),
            gauges=payload.get("gauges"),
            histograms=payload.get("histograms"),
            gap=gap,
        )
        profile = payload.get("profile")
        if profile:
            try:
                self.profiles.ingest(exec_id, profile, wall_ms=wall_ms)
            except (KeyError, TypeError, ValueError):
                self._c_bad.inc()
        events = payload.get("journal")
        if events:
            try:
                # idempotent + gap-tolerant merge; folds each event's
                # HLC into the hub process's clock (message receive)
                self.journal.ingest(events)
            except (KeyError, TypeError, ValueError):
                self._c_bad.inc()
        self._registry.counter(
            "telemetry.heartbeats", role=self.role, executor=exec_id
        ).inc()
        self.check_missed(now_ms=wall_ms)
        self._update_stragglers()
        self.slo.maybe_evaluate(now_ms=wall_ms)
        self.capacity.maybe_evaluate(now_ms=wall_ms)
        self._maybe_write_file(wall_ms)

    def check_missed(self, now_ms: Optional[int] = None) -> List[str]:
        """Flag executors whose last heartbeat is stale; returns the
        newly-flagged ids. A gap is counted ONCE per outage (gauge
        ``telemetry.missed_heartbeats``); the executor's next heartbeat
        re-arms the check and marks the gap in its ring."""
        if now_ms is None:
            now_ms = int(self._clock() * 1000)
        stale_after = MISSED_AFTER_INTERVALS * self.interval_ms
        newly: List[str] = []
        with self._lock:
            for exec_id, ring in self._series.items():
                if self._missed_counted.get(exec_id):
                    continue
                if ring.last_wall_ms and now_ms - ring.last_wall_ms > stale_after:
                    self._missed_counted[exec_id] = True
                    self._g_missed.add(1)
                    newly.append(exec_id)
        for exec_id in newly:
            logger.warning(
                "telemetry: no heartbeat from %s for > %.0f ms",
                exec_id, stale_after,
            )
        return newly

    # -- read side -----------------------------------------------------
    def executors(self) -> List[str]:
        with self._lock:
            return sorted(self._series)

    def epoch_anchors(self) -> Dict[str, float]:
        """Role → wall-clock span-timeline anchor (seconds), learned
        from heartbeats. Hand to ``to_chrome_trace(epochs=...)`` /
        ``collect_spans_with_epochs`` when merging spans shipped from
        other processes, so per-process module-load epochs don't skew
        the merged timeline."""
        with self._lock:
            return dict(self._epoch_anchors)

    def series(self, executor_id: str) -> Optional[TimeSeriesRing]:
        with self._lock:
            return self._series.get(executor_id)

    def timeline(self, last: Optional[int] = None) -> Dict[str, List[dict]]:
        """JSON-able per-executor window lists (bench artifacts)."""
        with self._lock:
            items = list(self._series.items())
        return {eid: ring.to_list(last) for eid, ring in items}

    def rollups(self, last: Optional[int] = None) -> Dict[str, dict]:
        with self._lock:
            items = list(self._series.items())
        return {eid: ring.rollup(last) for eid, ring in items}

    def ring_windows(self, last: Optional[int] = None) -> Dict[str, list]:
        """Live per-executor :class:`Window` lists — the SLO engine's
        burn-rate input (same data as :meth:`timeline`, un-serialized)."""
        with self._lock:
            items = list(self._series.items())
        return {eid: ring.windows(last) for eid, ring in items}

    def missed_executors(self) -> List[str]:
        """Executors currently inside a counted heartbeat outage."""
        with self._lock:
            return sorted(e for e, v in self._missed_counted.items() if v)

    def last_straggler_report(self) -> dict:
        with self._lock:
            return self._last_report

    def source_health(self) -> Dict[str, str]:
        """Circuit-breaker states, or {} when no registry is attached."""
        return self._health.states() if self._health is not None else {}

    def note_breakdown(self, breakdown: Optional[dict]) -> None:
        """Record the engine's latest critical-path TimeBreakdown dict
        as diagnosis evidence (best-effort; None is ignored)."""
        if breakdown:
            self.last_breakdown = breakdown

    def _on_slo_breach(self, breach) -> None:
        """Answer a page/warn transition with an automated root-cause
        pass. Best-effort: diagnosis must never add a failure mode to
        the ingest path that detected the breach."""
        try:
            from sparkrdma_tpu_torch.obs.diagnose import build_diagnosis

            diag = build_diagnosis(self, breach, registry=self._registry,
                                   clock=self._clock)
            self.slo.note_diagnosis(diag)
        except Exception:
            logger.exception("automated diagnosis failed")

    def summary(self) -> dict:
        """Compact hub view for ``metrics_snapshot()`` on the driver."""
        with self._lock:
            execs = {
                eid: {
                    "windows": len(ring),
                    "last_wall_ms": ring.last_wall_ms,
                    "last_seq": ring.last_seq,
                    "missed": bool(self._missed_counted.get(eid)),
                }
                for eid, ring in self._series.items()
            }
        return {
            "interval_ms": self.interval_ms,
            "ring_size": self.ring_size,
            "executors": execs,
            "stragglers": list(self._last_report.get("stragglers", [])),
            "missed_heartbeats": self._g_missed.value,
            "profile": self.profiles.summary(),
            "journal": self.journal.summary(),
            "capacity": self.capacity.summary(),
        }

    # -- straggler / skew detection ------------------------------------
    def straggler_report(self) -> dict:
        """Online per-stage robust z-score over busy-ms and work rates.

        Keys are normalized (``role``/``executor`` labels stripped) so
        the same instrument on two executors compares directly. A stage
        is scored only when >= ``MIN_PARTICIPANTS`` executors report
        nonzero activity on it; an executor is a straggler when any
        busy stage scores ``> straggler_z`` with a real absolute excess,
        or any work family scores ``< -straggler_z`` at under half the
        median of a non-trivial workload."""
        rollups = self.rollups()
        busy_by_stage: Dict[str, Dict[str, float]] = {}
        work_by_family: Dict[str, Dict[str, float]] = {}
        for eid, roll in rollups.items():
            for key, h in roll["histograms"].items():
                name, _ = parse_metric_key(key)
                if name.startswith(BUSY_PREFIXES):
                    norm = strip_label(key, "role", "executor")
                    busy_by_stage.setdefault(norm, {})[eid] = (
                        busy_by_stage.get(norm, {}).get(eid, 0.0)
                        + float(h.get("sum", 0.0))
                    )
            for key, v in roll["counters"].items():
                name, _ = parse_metric_key(key)
                if name.startswith(BUSY_PREFIXES):
                    norm = strip_label(key, "role", "executor")
                    busy_by_stage.setdefault(norm, {})[eid] = (
                        busy_by_stage.get(norm, {}).get(eid, 0.0) + float(v)
                    )
                elif name.startswith(WORK_PREFIXES):
                    norm = strip_label(key, "role", "executor")
                    work_by_family.setdefault(norm, {})[eid] = (
                        work_by_family.get(norm, {}).get(eid, 0.0) + float(v)
                    )

        details: Dict[str, dict] = {
            eid: {"busy_ms": 0.0, "work_bytes": 0.0, "flags": []}
            for eid in rollups
        }
        stragglers: set = set()
        # (tenant, eid) pairs behind each flag: the tenant label
        # survives the role/executor strip, so the verdicts stay
        # tenant-scoped all the way into the health registry
        flagged_pairs: set = set()
        for stage, per_exec in busy_by_stage.items():
            for eid, v in per_exec.items():
                details[eid]["busy_ms"] += v
            participants = {e: v for e, v in per_exec.items() if v > 0}
            if len(participants) < MIN_PARTICIPANTS:
                continue
            values = list(participants.values())
            med = statistics.median(values)
            for eid, v in participants.items():
                z = _robust_z(v, values)
                if z > self.straggler_z and (v - med) > MIN_BUSY_EXCESS_MS:
                    stragglers.add(eid)
                    flagged_pairs.add(
                        (parse_metric_key(stage)[1].get("tenant", ""), eid)
                    )
                    details[eid]["flags"].append({
                        "kind": "busy", "stage": stage,
                        "z": round(z, 2), "value_ms": round(v, 3),
                        "median_ms": round(med, 3),
                    })
        for family, per_exec in work_by_family.items():
            for eid, v in per_exec.items():
                details[eid]["work_bytes"] += v
            participants = {e: v for e, v in per_exec.items() if v > 0}
            if len(participants) < MIN_PARTICIPANTS:
                continue
            values = list(participants.values())
            med = statistics.median(values)
            if med < MIN_WORK_MEDIAN_BYTES:
                continue
            for eid, v in participants.items():
                z = _robust_z(v, values)
                if z < -self.straggler_z and v < med / 2:
                    stragglers.add(eid)
                    flagged_pairs.add(
                        (parse_metric_key(family)[1].get("tenant", ""), eid)
                    )
                    details[eid]["flags"].append({
                        "kind": "work", "family": family,
                        "z": round(z, 2), "value_bytes": int(v),
                        "median_bytes": int(med),
                    })
        # breaker-registry-shaped suspect keys: bare executor id for
        # the default tenant, "<tenant>:<executor>" otherwise — the
        # exact format SourceHealthRegistry._key produces, so
        # apply_straggler_report needs no re-derivation
        from sparkrdma_tpu_torch.tenancy import DEFAULT_TENANT

        suspect_keys = sorted(
            eid if (not t or t == DEFAULT_TENANT) else f"{t}:{eid}"
            for t, eid in flagged_pairs
        )
        report = {
            "generated_wall_ms": int(self._clock() * 1000),
            "threshold_z": self.straggler_z,
            "executors": details,
            "stragglers": sorted(stragglers),
            "suspect_keys": suspect_keys,
        }
        return report

    def _update_stragglers(self) -> None:
        report = self.straggler_report()
        flagged = set(report["stragglers"])
        known = set(report["executors"])
        prev = set(self._last_report.get("stragglers", ()))
        for eid in sorted(flagged - prev):
            _journal.emit("straggler.flag", role=self.role, executor=eid)
        for eid in sorted(prev - flagged):
            _journal.emit("straggler.clear", role=self.role, executor=eid)
        self._g_stragglers.set(len(flagged))
        for eid in known:
            self._registry.gauge(
                "telemetry.straggler", role=self.role, executor=eid
            ).set(1 if eid in flagged else 0)
        self._last_report = report
        if self._health is not None:
            try:
                self._health.apply_straggler_report(report)
            except Exception:
                logger.exception("straggler advisory failed")

    # -- egress: OpenMetrics -------------------------------------------
    def render_openmetrics(self) -> str:
        from sparkrdma_tpu_torch.obs.export import render_openmetrics

        return render_openmetrics(self._registry.snapshot())

    def _maybe_write_file(self, now_ms: int) -> None:
        if not self._openmetrics_file:
            return
        if now_ms - self._last_file_write_ms < self.interval_ms:
            return
        self._last_file_write_ms = now_ms
        try:
            from sparkrdma_tpu_torch.obs.export import write_openmetrics

            write_openmetrics(self._openmetrics_file,
                              self._registry.snapshot())
        except OSError:
            logger.warning("openmetrics file write failed",
                           exc_info=True)

    @property
    def http_port(self) -> Optional[int]:
        return self._http.port if self._http is not None else None

    # -- egress: flight recorder ---------------------------------------
    def flight_record(self, reason: str, error: Optional[BaseException] = None,
                      path: Optional[str] = None,
                      breakdown: Optional[dict] = None) -> Optional[str]:
        """Dump the post-mortem artifact: last N ring windows per
        executor + recent spans + circuit-breaker states + the failed
        group (from the error's ``shuffle_id``/``partition_id``/
        ``manager_id`` attributes when present). ``breakdown`` attaches
        the failed window's critical-path TimeBreakdown dict
        (obs/attr.py) when the caller computed one. Best-effort:
        returns the written path, or None — never a new failure mode."""
        doc: dict = {
            "kind": "sparkrdma_flight_record",
            "version": 1,
            "generated_wall_ms": int(self._clock() * 1000),
            "role": self.role,
            "reason": reason,
            "interval_ms": self.interval_ms,
            "executors": self.timeline(last=self.flight_windows),
            "stragglers": self._last_report,
            "source_health": (
                self._health.states() if self._health is not None else {}
            ),
            "slo": self.slo.summary(),
            # last-N merged journal events around the failure: the
            # causally-ordered incident context (obs/journal.py);
            # rendered by journal.render_timeline
            "journal": self.journal.merged(last=self.journal_flight_events),
            "capacity": self.capacity.capacity_report(refresh=True),
        }
        # last profile window per executor: the collapsed-stack view of
        # what each process's CPUs were doing just before the failure
        profiles = self.profiles.last_windows()
        if profiles:
            doc["profiles"] = profiles
        if breakdown is not None:
            doc["breakdown"] = breakdown
        if error is not None:
            doc["error"] = {
                "type": type(error).__name__,
                "message": str(error),
            }
            failed = {}
            for attr in ("shuffle_id", "map_id", "partition_id"):
                v = getattr(error, attr, None)
                if v is not None:
                    failed[attr] = v
            mid = getattr(error, "manager_id", None)
            if mid is not None:
                failed["source"] = str(mid)
            if failed:
                doc["failed_group"] = failed
        try:
            from sparkrdma_tpu_torch.obs.trace import collect_spans

            doc["spans"] = [
                {
                    "name": sp.name,
                    "role": sp.role,
                    "trace_id": f"{sp.trace_id:#x}" if sp.trace_id else None,
                    "start": sp.start,
                    "end": sp.end,
                    "args": dict(sp.args),
                }
                for sp in collect_spans()[-200:]
            ]
        except Exception:
            doc["spans"] = []
        if path is None:
            base = self._flight_dir or tempfile.gettempdir()
            TelemetryHub._flight_seq += 1
            path = os.path.join(
                base,
                f"sparkrdma-flight-{os.getpid()}-{TelemetryHub._flight_seq}.json",
            )
        try:
            with open(path, "w", encoding="utf-8") as f:
                json.dump(doc, f, indent=1, default=str)
        except OSError:
            logger.warning("flight record write to %s failed", path,
                           exc_info=True)
            path = None
        else:
            logger.warning("flight record written: %s (%s)", path, reason)
        self.last_flight = doc
        self.last_flight_path = path
        return path

    def stop(self) -> None:
        if self._http is not None:
            self._http.stop()
            self._http = None
        if self._openmetrics_file:
            # final exposition so scrape-less runs keep the end state
            self._last_file_write_ms = 0
            self._maybe_write_file(int(self._clock() * 1000))
