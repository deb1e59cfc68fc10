"""Cluster telemetry plane, the executor half: heartbeats.

:class:`Heartbeater` runs on each executor: every
``obs.telemetry.intervalMs`` it takes a role-filtered
``MetricsRegistry`` snapshot, diffs it against a *moving baseline*
(reset-safe, :func:`~sparkrdma_tpu_torch.obs.metrics.snapshot_delta`), and
ships the labeled delta + in-flight gauge samples either directly
(in-process clusters: ``send=hub.ingest``) or into a bounded outbox the
driver pulls over the engine control plane (the ``"telemetry"``
task-protocol kind in ``engine/worker.py`` / ``engine/cluster.py``).

A copy of the executor half of the JAX package's ``obs/telemetry.py``
(``Heartbeater``, ``_hist_payload``, ``_robust_z``), its imports
rewritten to this package. The driver half, ``TelemetryHub`` (rings,
straggler detector, OpenMetrics egress, flight recorder), comes with
ROADMAP item M8: until then the port's driver keeps ``telemetry =
None`` (``shuffle/manager.py``), so no context starts a heartbeater and
a worker's outbox is never pulled. The journal the beats carry is
resolved per beat through ``utils/seams.py`` ``active_journal`` (None
until M8).

Stdlib-only and jax-free, like the rest of ``obs/``.
"""

from __future__ import annotations

import logging
import statistics
import threading
import time
from collections import deque
from typing import Callable, List, Mapping, Optional

from sparkrdma_tpu_torch.obs.metrics import MetricsRegistry, snapshot_delta
from sparkrdma_tpu_torch.obs.profiler import SamplingProfiler
from sparkrdma_tpu_torch.utils.seams import active_journal

logger = logging.getLogger(__name__)

# MAD == 0 fallback: treat 15% of the median as one deviation unit so
# identical-but-for-jitter executors don't divide by zero into flags.
MAD_FALLBACK_FRACTION = 0.15


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
        self._journal_override = None
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
        j = self._journal_override or active_journal()
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
