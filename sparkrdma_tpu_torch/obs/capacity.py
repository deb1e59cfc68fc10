"""USE-method capacity accounting over the stack's governed resources.

Brendan Gregg's USE method asks three questions of every resource:
**U**tilization (how full), **S**aturation (how much work is waiting),
**E**rrors. The shuffle stack already governs nine resources with hard
caps and queues — this module folds the instruments they already
publish into one per-resource table, a ``capacity.*`` metric family,
and a hub-side :meth:`CapacityPlane.capacity_report` that names the
**binding resource** (highest utilization) and its headroom fraction.
That report is the declared input contract for the ROADMAP-2
autoscaler: scale when the binding resource's headroom shrinks, and
scale the *right* axis because the report names which resource binds.

Per-resource definitions (docs/OBSERVABILITY.md "Event journal &
capacity plane"):

==================  =============================  ====================
resource            utilization                    saturation / errors
==================  =============================  ====================
mempool             max tenant usage/quota         quota blocks / overruns
hbm                 in-use / hbm.maxBytes          quota blocks / overruns
pagecache           max tenant usage/quota         quota blocks / overruns
admission           inflight / maxConcurrentJobs   queue depth / timeouts
fairshare           (backlog-only, no capacity)    queued tasks / —
transport_send      (permit pool, no gauge)        send overflows / latched
iouring_sq          SQE depth / sendQueueDepth     depth HWM / fallbacks
collective_pipe     inflight waves / pipelineDepth wave HWM / degrades
merge_buffer        (budget-drop governed)         — / budget drops
==================  =============================  ====================

For the quota-brokered byte ledgers the point-in-time usage ratio
understates backpressure (usage is released between charges), so two
corrections pin utilization at 1.0: a thread blocked at the quota at
evaluation time (``QuotaBroker.waiting``), or the resource's block
counter having grown since the previous evaluation
(``blocked_in_interval`` in the row detail).

A resource with no meaningful utilization gauge reports ``None`` and
can never be named binding — it still surfaces saturation/errors so a
drop-governed resource (merge buffer) is visible when it sheds load.
Utilization inputs are point-in-time gauges; saturation/errors are
cumulative counters, which is what an argmax over one report wants and
what a delta between two reports turns into rates.

Stdlib-only, jax-free; tenancy/quota is imported lazily (it imports
``obs`` for its instruments, so a module-level import here would cycle
through the package init).
A copy of the JAX package's ``obs/capacity.py``, its imports rewritten
to this package.

"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional

from sparkrdma_tpu_torch.obs.metrics import parse_metric_key

__all__ = ["CapacityPlane", "RESOURCES"]

RESOURCES = (
    "mempool",
    "hbm",
    "pagecache",
    "admission",
    "fairshare",
    "transport_send",
    "iouring_sq",
    "collective_pipe",
    "merge_buffer",
)


def _counter_sum(snap, name: str, **labels) -> int:
    total = 0
    for key, v in snap.get("counters", {}).items():
        n, kv = parse_metric_key(key)
        if n != name:
            continue
        if any(kv.get(lk) != lv for lk, lv in labels.items()):
            continue
        total += v
    return total


def _gauge_agg(snap, name: str, field: str = "value",
               agg=sum) -> Optional[float]:
    vals = []
    for key, v in snap.get("gauges", {}).items():
        n, _ = parse_metric_key(key)
        if n == name:
            vals.append(v.get(field, 0) or 0)
    return agg(vals) if vals else None


def _hist_max(snap, name: str) -> Optional[float]:
    best = None
    for key, h in snap.get("histograms", {}).items():
        n, _ = parse_metric_key(key)
        if n != name:
            continue
        m = h.get("max")
        if m is not None and (best is None or m > best):
            best = m
    return best


def _broker_utilization(resource: str) -> Optional[float]:
    """Max tenant usage/quota for a quota-brokered resource; None when
    no broker is installed or no tenant has a finite quota. A thread
    blocked at the quota RIGHT NOW pins utilization at 1.0 — the
    held-bytes ledger reads low between charges, but active blocking is
    the definition of a full resource."""
    from sparkrdma_tpu_torch.tenancy import quota as _quota

    b = _quota.broker(resource)
    if b is None:
        return None
    best = None
    for tenant, row in b.snapshot().items():
        q = row.get("quota", 0)
        if q <= 0:
            continue
        u = row.get("usage", 0) / q
        if best is None or u > best:
            best = u
    if b.waiting() > 0:
        best = 1.0 if best is None else max(best, 1.0)
    return best


class CapacityPlane:
    """Hub-side USE evaluation on the telemetry ingest cadence.

    Reads the process registry snapshot (which the hub's ring-fold has
    already merged across executors in-process; multi-process gauges
    arrive via their own role labels) + conf capacities + quota broker
    ledgers. ``maybe_evaluate`` is called from telemetry ingest beside
    ``slo.maybe_evaluate`` and is rate-limited by
    ``tpu.shuffle.obs.capacity.evalIntervalMs``."""

    def __init__(
        self,
        conf,
        registry=None,
        *,
        role: str = "driver",
        clock: Callable[[], float] = time.time,
    ):
        self.conf = conf
        self.role = role
        self.enabled = bool(conf.capacity_enabled)
        self._interval_ms = int(conf.capacity_eval_interval_ms)
        self._clock = clock
        if registry is None:
            from sparkrdma_tpu_torch.obs.metrics import get_registry

            registry = get_registry()
        self.registry = registry
        self._lock = threading.Lock()
        self._last_eval_ms = 0
        self._last_rows: List[dict] = []
        # per-resource saturation counters at the previous evaluation:
        # a brokered quota whose block counter grew within the interval
        # was driven to its cap during it, however the point-in-time
        # ledger reads at evaluation instant
        self._prev_sat: Dict[str, int] = {}
        self._c_evals = registry.counter("capacity.evaluations", role=role)
        self._g_util = lambda r: registry.gauge(
            "capacity.utilization", resource=r
        )
        self._g_sat = lambda r: registry.gauge(
            "capacity.saturation", resource=r
        )
        self._g_err = lambda r: registry.gauge("capacity.errors", resource=r)
        self._g_headroom = registry.gauge(
            "capacity.binding_headroom", role=role
        )

    # -- probes --------------------------------------------------------
    def _rows(self, snap) -> List[dict]:
        conf = self.conf
        rows: List[dict] = []

        def row(resource, util, sat, err, **detail):
            rows.append({
                "resource": resource,
                "utilization": (None if util is None
                                else max(0.0, min(float(util), 1.0))),
                "saturation": int(sat or 0),
                "errors": int(err or 0),
                "detail": detail,
            })

        # quota-brokered byte ledgers
        row(
            "mempool",
            _broker_utilization("mempool"),
            _counter_sum(snap, "tenant.quota_blocks", resource="mempool"),
            _counter_sum(snap, "tenant.quota_overruns", resource="mempool"),
            in_use_bytes=_gauge_agg(snap, "mempool.in_use_bytes") or 0,
        )
        hbm_cap = conf.hbm_max_bytes
        hbm_in_use = _gauge_agg(snap, "hbm.in_use_bytes") or 0
        hbm_util = _broker_utilization("hbm")
        if hbm_cap > 0:
            arena = hbm_in_use / hbm_cap
            hbm_util = arena if hbm_util is None else max(hbm_util, arena)
        row(
            "hbm",
            hbm_util,
            _counter_sum(snap, "tenant.quota_blocks", resource="hbm"),
            _counter_sum(snap, "tenant.quota_overruns", resource="hbm"),
            in_use_bytes=hbm_in_use,
            capacity_bytes=hbm_cap,
        )
        row(
            "pagecache",
            _broker_utilization("pagecache"),
            _counter_sum(snap, "tenant.quota_blocks", resource="pagecache"),
            _counter_sum(snap, "tenant.quota_overruns",
                         resource="pagecache"),
        )

        # admission slots + fair-share backlog
        slots = conf.tenancy_max_concurrent_jobs
        inflight = _gauge_agg(snap, "admission.inflight") or 0
        row(
            "admission",
            (inflight / slots) if slots > 0 else None,
            _gauge_agg(snap, "admission.queue_depth") or 0,
            _counter_sum(snap, "admission.timeouts"),
            inflight=inflight,
            slots=slots,
        )
        row(
            "fairshare",
            None,
            _gauge_agg(snap, "tenant.queued") or 0,
            0,
        )

        # host transport: send permit pool + native submission queue
        row(
            "transport_send",
            None,
            _counter_sum(snap, "transport.send_overflow"),
            _counter_sum(snap, "transport.errors_latched"),
        )
        sq_cap = conf.send_queue_depth
        sq_depth = _gauge_agg(snap, "transport.sq.sqe_depth")
        row(
            "iouring_sq",
            (None if sq_depth is None or sq_cap <= 0
             else sq_depth / sq_cap),
            _gauge_agg(snap, "transport.sq.sqe_depth", field="hwm") or 0,
            _counter_sum(snap, "transport.sq.backend_fallbacks"),
            depth=sq_depth or 0,
            capacity=sq_cap,
        )

        # device plane: pipelined DMA waves + merge-endpoint budget
        pipe_cap = conf.collective_pipeline_depth
        wave_peak = _hist_max(snap, "collective.wave_inflight")
        row(
            "collective_pipe",
            (None if wave_peak is None or pipe_cap <= 0
             else wave_peak / pipe_cap),
            int(wave_peak or 0),
            _counter_sum(snap, "collective.degrades"),
            pipeline_depth=pipe_cap,
        )
        row(
            "merge_buffer",
            None,
            0,
            _counter_sum(snap, "push.budget_drops"),
            budget_bytes=conf.push_max_buffer_bytes,
        )
        return rows

    # -- evaluation ----------------------------------------------------
    def evaluate(self, now_ms: Optional[int] = None) -> List[dict]:
        """Recompute the USE table, publish ``capacity.*`` gauges, and
        return the rows (also cached for :meth:`capacity_report`)."""
        if now_ms is None:
            now_ms = int(self._clock() * 1000)
        snap = self.registry.snapshot()
        rows = self._rows(snap)
        with self._lock:
            prev_sat = dict(self._prev_sat)
        for r in rows:
            if (r["resource"] in ("mempool", "hbm", "pagecache")
                    and r["utilization"] is not None):
                last = prev_sat.get(r["resource"])
                if last is not None and r["saturation"] > last:
                    r["utilization"] = 1.0
                    r["detail"]["blocked_in_interval"] = 1
        for r in rows:
            if r["utilization"] is not None:
                self._g_util(r["resource"]).set(round(r["utilization"], 4))
            self._g_sat(r["resource"]).set(r["saturation"])
            self._g_err(r["resource"]).set(r["errors"])
        binding = self._binding(rows)
        if binding is not None:
            self._g_headroom.set(
                round(1.0 - binding["utilization"], 4)
            )
        with self._lock:
            self._last_eval_ms = now_ms
            self._last_rows = rows
            self._prev_sat = {
                r["resource"]: r["saturation"] for r in rows
            }
        self._c_evals.inc()
        return rows

    def maybe_evaluate(self, now_ms: Optional[int] = None) -> bool:
        if not self.enabled:
            return False
        if now_ms is None:
            now_ms = int(self._clock() * 1000)
        with self._lock:
            due = now_ms - self._last_eval_ms >= self._interval_ms
        if due:
            self.evaluate(now_ms)
        return due

    @staticmethod
    def _binding(rows: List[dict]) -> Optional[dict]:
        known = [r for r in rows if r["utilization"] is not None]
        if not known:
            return None
        return max(
            known,
            key=lambda r: (r["utilization"], r["saturation"], r["errors"]),
        )

    def capacity_report(self, *, refresh: bool = True) -> dict:
        """The autoscaler-facing report: every resource's USE row plus
        the binding resource (argmax utilization, ties broken by
        saturation then errors) and its headroom fraction."""
        if refresh or not self._last_rows:
            rows = self.evaluate()
        else:
            with self._lock:
                rows = self._last_rows
        binding = self._binding(rows)
        report = {
            "enabled": self.enabled,
            "evaluations": self._c_evals.value,
            "resources": {
                r["resource"]: {
                    "utilization": r["utilization"],
                    "saturation": r["saturation"],
                    "errors": r["errors"],
                    "detail": r["detail"],
                }
                for r in rows
            },
            "binding": None,
        }
        if binding is not None:
            report["binding"] = {
                "resource": binding["resource"],
                "utilization": binding["utilization"],
                "headroom": round(1.0 - binding["utilization"], 4),
                "saturation": binding["saturation"],
                "errors": binding["errors"],
            }
        return report

    def summary(self) -> dict:
        """Compact form for hub ``summary()`` / soak ledgers."""
        rep = self.capacity_report(refresh=True)
        out = {
            "enabled": [str(rep["enabled"])],
            "evaluations": rep["evaluations"],
        }
        if rep["binding"]:
            out["binding_resource"] = [rep["binding"]["resource"]]
            out["binding_headroom"] = rep["binding"]["headroom"]
        return out
