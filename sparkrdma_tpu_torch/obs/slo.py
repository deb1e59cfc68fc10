"""Declarative SLO engine: burn-rate objectives over telemetry rings.

The soak harness (benchmarks/soak.py) accumulated ad-hoc serving
verdicts — p99 bars, fairness bands, HWM flatness — while production
runs had dashboards but no judge: nothing watched the
:class:`~sparkrdma_tpu_torch.obs.telemetry.TelemetryHub` rings and said
"this is now an incident". This module is that judgment layer:

- :class:`Objective` declares one service-level objective over
  existing registry/telemetry series — a fetch **error ratio**
  (``transport.read_errors`` / ``transport.reads``), a **latency**
  target (p99 task or admission-wait ms framed as a
  threshold-exceedance ratio over histogram bucket deltas), a
  **throughput floor** (MB/s per ring window), or executor
  **liveness** (the hub's missed-heartbeat accounting).
- :class:`SLOEngine` evaluates every objective against the hub's
  wall-bucketed windows with **multi-window burn rates** (the
  Google-SRE alerting shape): one objective produces both the
  fast-burn *page* (short horizon, high burn multiple) and the
  slow-burn *warn* (long horizon, low multiple), so a sudden outage
  and a slow leak alarm from the same declaration.
- every page/warn **transition** records a :class:`Breach`; the hub
  answers each with an automated root-cause
  :mod:`~sparkrdma_tpu_torch.obs.diagnose` pass, and both ride
  ``metrics_snapshot()["slo"]``, flight records, soak/bench ledgers,
  and the obs CLI's ``--diagnose`` renderer (``obs/__main__.py``).

Burn-rate semantics (unit-tested against hand-computed windows in
tests/test_slo.py):

- each ring window contributes ``(bad, total)`` event counts for the
  objective; windows from all executors folding into the same wall
  bucket sum (ratios are invariant to the in-process topology's
  duplication of process-global instruments across executor views);
- ``burn(span) = (Σ bad / Σ total) / budget`` over the last ``span``
  buckets — 0 when no events landed (an idle service burns nothing);
- **page** when ``burn(fast_windows)`` AND ``burn(fast_windows // 3)``
  both reach ``fast_burn``; **warn** analogously over ``slow_windows``
  with ``slow_burn``. The short confirmation window is what makes
  recovery drop the alert quickly instead of dragging the long
  window's average along;
- a latency objective "pX ≤ T ms" is the exceedance ratio "at most
  (100 - X)% of events above T", with T snapped UP to the nearest
  histogram bucket bound so a whole bucket is never split (optimistic:
  no false pages from bucket granularity);
- counter resets across heartbeat gaps are already absorbed upstream
  (:func:`~sparkrdma_tpu_torch.obs.metrics.snapshot_delta` restarts the
  delta instead of going negative), so burn math only ever sees
  non-negative event counts.

Stdlib-only and jax-free, like the rest of ``obs/``.
A copy of the JAX package's ``obs/slo.py``, its imports rewritten to
this package.

"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import (
    Callable,
    Dict,
    List,
    Mapping,
    Optional,
    Sequence,
    Tuple,
)

from sparkrdma_tpu_torch.obs.journal import emit as journal_emit
from sparkrdma_tpu_torch.obs.metrics import (
    MetricsRegistry,
    get_registry,
    parse_metric_key,
)

logger = logging.getLogger(__name__)

KINDS = ("ratio", "latency", "throughput", "liveness")
SEVERITIES = ("page", "warn")

# Defaults for conf-less construction (bench.py's local hub, tests).
DEFAULT_ERROR_RATIO = 0.02
DEFAULT_FAST_WINDOWS = 8
DEFAULT_SLOW_WINDOWS = 32
DEFAULT_FAST_BURN = 8.0
DEFAULT_SLOW_BURN = 2.0
DEFAULT_EVAL_INTERVAL_MS = 2000


# ---------------------------------------------------------------------------
# pure burn-rate math (hand-computable; tests/test_slo.py)
# ---------------------------------------------------------------------------
def burn_rate(points: Sequence[Tuple[float, float]], budget: float) -> float:
    """``(Σ bad / Σ total) / budget`` over (bad, total) pairs; 0 when
    no events landed or the budget is degenerate."""
    bad = sum(p[0] for p in points)
    total = sum(p[1] for p in points)
    if total <= 0 or budget <= 0:
        return 0.0
    return (bad / total) / budget


def multi_window_burn(
    points: Sequence[Tuple[float, float]],
    budget: float,
    long_windows: int,
    burn_threshold: float,
) -> Tuple[float, float, bool]:
    """(long burn, short burn, fired) for one alerting horizon.

    The short window is ``max(1, long_windows // 3)`` — both must clear
    the threshold, so a stale high average cannot keep paging after the
    service recovers."""
    long_n = max(1, int(long_windows))
    short_n = max(1, long_n // 3)
    b_long = burn_rate(points[-long_n:], budget)
    b_short = burn_rate(points[-short_n:], budget)
    return b_long, b_short, (
        b_long >= burn_threshold and b_short >= burn_threshold
    )


def exceedance(buckets: Mapping[str, object],
               threshold_ms: float) -> Tuple[int, int]:
    """(bad, total) event counts from one histogram bucket-delta dict.

    ``bad`` counts only buckets whose whole range lies above the
    threshold (snapped up to the nearest bucket bound), plus the
    overflow bucket — bucket granularity can hide a real exceedance
    but never invent one."""
    bounds = sorted(
        float(k[3:]) for k in buckets if k.startswith("le_")
    )
    eff = next((b for b in bounds if b >= threshold_ms), None)
    bad = 0
    total = 0
    for k, c in buckets.items():
        n = int(c)
        total += n
        if k == "overflow":
            bad += n
        elif eff is not None and float(k[3:]) > eff:
            bad += n
    return bad, total


# ---------------------------------------------------------------------------
# objectives
# ---------------------------------------------------------------------------
@dataclass
class Objective:
    """One declarative SLO over existing metric series.

    ``bad``/``total`` (ratio) and ``series`` (latency/throughput) are
    metric-NAME prefixes; ``labels`` filters matched keys (a missing
    ``tenant`` label on a key means the default tenant). ``tenant`` is
    folded into ``labels`` for convenience and kept for reporting."""

    name: str
    kind: str
    description: str = ""
    bad: Tuple[str, ...] = ()
    total: Tuple[str, ...] = ()
    series: Tuple[str, ...] = ()
    labels: Dict[str, str] = field(default_factory=dict)
    tenant: str = ""
    threshold_ms: float = 0.0
    percentile: float = 99.0
    floor_mbps: float = 0.0
    budget: float = DEFAULT_ERROR_RATIO
    fast_windows: int = DEFAULT_FAST_WINDOWS
    slow_windows: int = DEFAULT_SLOW_WINDOWS
    fast_burn: float = DEFAULT_FAST_BURN
    slow_burn: float = DEFAULT_SLOW_BURN

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(
                f"unknown objective kind {self.kind!r}; expected one of {KINDS}"
            )
        if self.tenant:
            self.labels = dict(self.labels, tenant=self.tenant)
        if self.kind == "latency":
            # "pX <= T" == "at most (100 - X)% of events above T"
            self.budget = max(1e-6, (100.0 - self.percentile) / 100.0)

    def matches(self, key: str, prefixes: Sequence[str]) -> bool:
        if not prefixes:
            return False
        name, key_labels = parse_metric_key(key)
        if not name.startswith(tuple(prefixes)):
            return False
        for k, want in self.labels.items():
            have = key_labels.get(k)
            if have is None and k == "tenant":
                from sparkrdma_tpu_torch.tenancy import DEFAULT_TENANT

                have = DEFAULT_TENANT
            if have != want:
                return False
        return True

    def window_events(self, window, interval_ms: int) -> Tuple[float, float]:
        """(bad, total) event counts this objective sees in one ring
        window. Liveness is not window-driven and always yields (0, 0)."""
        if self.kind == "ratio":
            bad = float(sum(
                v for k, v in window.counters.items()
                if self.matches(k, self.bad)
            ))
            total = float(sum(
                v for k, v in window.counters.items()
                if self.matches(k, self.total)
            ))
            # a total-series that excludes failures must never yield a
            # ratio above 1 (burn math would overshoot its own scale)
            return bad, max(total, bad)
        if self.kind == "latency":
            bad = 0
            total = 0
            for k, h in window.histograms.items():
                if not self.matches(k, self.series):
                    continue
                buckets = h.get("buckets")
                if not buckets:
                    continue  # pre-bucket payload: not evaluable
                b, t = exceedance(buckets, self.threshold_ms)
                bad += b
                total += t
            return float(bad), float(total)
        if self.kind == "throughput":
            nbytes = sum(
                v for k, v in window.counters.items()
                if self.matches(k, self.series)
            )
            if nbytes <= 0:
                return 0.0, 0.0  # idle window: not a violation
            mbps = nbytes / (max(1, interval_ms) / 1000.0) / 1e6
            return (1.0 if mbps < self.floor_mbps else 0.0), 1.0
        return 0.0, 0.0

    def judge(self, observed, target=None, comparator: str = "le",
              note: str = "") -> dict:
        """End-state verdict for offline harnesses (benchmarks/soak.py):
        compare one observed scalar against this objective's target with
        the SAME identity that the ring-driven evaluation enforces
        online. ``target`` defaults to the objective's own bar."""
        if target is None:
            target = {
                "ratio": self.budget,
                "latency": self.threshold_ms,
                "throughput": self.floor_mbps,
                "liveness": 0,
            }[self.kind]
        return judge(self.name, observed, target, comparator=comparator,
                     note=note)


def judge(objective: str, observed, target, comparator: str = "le",
          note: str = "") -> dict:
    """One shared verdict primitive: ``observed`` vs ``target`` under
    ``comparator`` ("le" | "ge" | "eq"). ``observed`` None is a failed
    verdict with an explanatory note (a bar that could not be measured
    never passes silently)."""
    if comparator not in ("le", "ge", "eq"):
        raise ValueError(f"unknown comparator {comparator!r}")
    if observed is None:
        ok = False
        note = note or "observed value unavailable"
    elif comparator == "le":
        ok = observed <= target
    elif comparator == "ge":
        ok = observed >= target
    else:
        ok = observed == target
    out = {
        "objective": objective,
        "observed": observed,
        "target": target,
        "comparator": comparator,
        "ok": bool(ok),
    }
    if note:
        out["note"] = note
    return out


@dataclass
class Breach:
    """One page/warn transition of one objective."""

    objective: str
    kind: str
    severity: str
    wall_ms: int
    tenant: str = ""
    executor: str = ""
    burn_fast: float = 0.0
    burn_fast_short: float = 0.0
    burn_slow: float = 0.0
    burn_slow_short: float = 0.0
    windows: int = 0
    observed: Dict[str, object] = field(default_factory=dict)
    description: str = ""

    def to_dict(self) -> dict:
        out = {
            "objective": self.objective,
            "kind": self.kind,
            "severity": self.severity,
            "wall_ms": self.wall_ms,
            "burn_fast": round(self.burn_fast, 4),
            "burn_fast_short": round(self.burn_fast_short, 4),
            "burn_slow": round(self.burn_slow, 4),
            "burn_slow_short": round(self.burn_slow_short, 4),
            "windows": self.windows,
            "observed": dict(self.observed),
        }
        if self.tenant:
            out["tenant"] = self.tenant
        if self.executor:
            out["executor"] = self.executor
        if self.description:
            out["description"] = self.description
        return out


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------
class SLOEngine:
    """Evaluates a set of objectives against a TelemetryHub's rings.

    Passive: :meth:`maybe_evaluate` rides the hub's ingest path on a
    bounded cadence (``obs.slo.evalIntervalMs``), so the evaluator's
    cost stays inside the telemetry interval budget no matter how fast
    heartbeats arrive. Every page/warn *transition* (not every breaching
    evaluation) records a :class:`Breach` and fires ``on_breach`` —
    the hub's automated-diagnosis hook."""

    def __init__(
        self,
        hub=None,
        conf=None,
        *,
        registry: Optional[MetricsRegistry] = None,
        role: str = "driver",
        clock: Callable[[], float] = time.time,
        enabled: Optional[bool] = None,
        eval_interval_ms: Optional[int] = None,
        install_defaults: bool = True,
    ):
        self.hub = hub
        self.role = role
        self._registry = registry or get_registry()
        self._clock = clock
        self.enabled = bool(
            enabled
            if enabled is not None
            else (conf.slo_enabled if conf is not None else True)
        )
        self.eval_interval_ms = int(
            eval_interval_ms
            if eval_interval_ms is not None
            else (conf.slo_eval_interval_ms if conf is not None
                  else DEFAULT_EVAL_INTERVAL_MS)
        )
        self._lock = threading.Lock()
        self.objectives: Dict[str, Objective] = {}
        # (objective, executor) -> current severity; transitions only
        self._breaching: Dict[Tuple[str, str], str] = {}
        self.breaches: "deque[Breach]" = deque(maxlen=256)
        self.diagnoses: "deque[dict]" = deque(maxlen=32)
        self.breach_total = 0
        self._last_eval_ms = 0
        self.on_breach: Optional[Callable[[Breach], None]] = None

        reg = self._registry
        self._c_evals = reg.counter("slo.evaluations", role=role)
        self._g_objectives = reg.gauge("slo.objectives", role=role)
        self._g_breaching = reg.gauge("slo.breaching", role=role)

        if install_defaults:
            self.install_defaults(conf)

    # -- objective registry --------------------------------------------
    def add(self, objective: Objective) -> Objective:
        with self._lock:
            self.objectives[objective.name] = objective
            self._g_objectives.set(len(self.objectives))
        return objective

    def objective(self, name: str) -> Optional[Objective]:
        with self._lock:
            return self.objectives.get(name)

    def install_defaults(self, conf=None) -> None:
        """The standing objective set. Error-ratio and liveness default
        ON (they cannot fire without real faults); latency and
        throughput objectives install only when their conf target is
        nonzero, so a conf-less hub never pages a healthy run."""
        fast_w = conf.slo_fast_windows if conf else DEFAULT_FAST_WINDOWS
        slow_w = conf.slo_slow_windows if conf else DEFAULT_SLOW_WINDOWS
        fast_b = conf.slo_fast_burn if conf else DEFAULT_FAST_BURN
        slow_b = conf.slo_slow_burn if conf else DEFAULT_SLOW_BURN
        common = dict(fast_windows=fast_w, slow_windows=slow_w,
                      fast_burn=fast_b, slow_burn=slow_b)
        self.add(Objective(
            "fetch-error-ratio", "ratio",
            description="one-sided READ error ratio within budget",
            bad=("transport.read_errors",),
            total=("transport.reads",),
            budget=(conf.slo_error_ratio if conf else DEFAULT_ERROR_RATIO),
            **common,
        ))
        self.add(Objective(
            "executor-liveness", "liveness",
            description="every known executor heartbeats within "
                        "the missed-heartbeat horizon",
            **common,
        ))
        task_p99 = conf.slo_task_p99_ms if conf else 0
        if task_p99 > 0:
            self.add(Objective(
                "task-p99", "latency",
                description=f"p99 task latency <= {task_p99} ms",
                series=("engine.task_ms",),
                threshold_ms=float(task_p99),
                **common,
            ))
        for tenant, bar in sorted(self._tenant_targets(conf).items()):
            self.add(Objective(
                f"task-p99-{tenant}", "latency",
                description=f"p99 task latency <= {bar} ms for {tenant}",
                series=("engine.task_ms",),
                tenant=tenant,
                threshold_ms=float(bar),
                **common,
            ))
        queue_p99 = conf.slo_queue_wait_p99_ms if conf else 0
        if queue_p99 > 0:
            self.add(Objective(
                "queue-wait-p99", "latency",
                description=f"p99 admission queue wait <= {queue_p99} ms",
                series=("admission.wait_ms",),
                threshold_ms=float(queue_p99),
                **common,
            ))
        floor = conf.slo_throughput_floor_mbps if conf else 0.0
        if floor > 0:
            self.add(Objective(
                "throughput-floor", "throughput",
                description=f"active-window write throughput >= "
                            f"{floor} MB/s",
                series=("writer.bytes_written",),
                floor_mbps=float(floor),
                **common,
            ))

    @staticmethod
    def _tenant_targets(conf) -> Dict[str, int]:
        """Per-tenant p99 bars: every declared fair-share tenant plus
        any ``obs.slo.tenant.<t>.taskP99Ms`` override names a tenant;
        only nonzero bars install an objective."""
        if conf is None:
            return {}
        from sparkrdma_tpu_torch.tenancy import declared_tenants

        tenants = set(declared_tenants(conf))
        from sparkrdma_tpu_torch.utils.config import PREFIX

        head, tail = PREFIX + "obs.slo.tenant.", ".taskP99Ms"
        for key in conf.to_dict():
            if key.startswith(head) and key.endswith(tail):
                seg = key[len(head):-len(tail)]
                if seg and "." not in seg:
                    tenants.add(seg)
        out = {}
        for t in tenants:
            bar = conf.slo_tenant_task_p99_ms(t)
            if bar > 0:
                out[t] = bar
        return out

    # -- evaluation ----------------------------------------------------
    def burn_points(self, objective: Objective) -> List[Tuple[int, float, float]]:
        """(bucket, bad, total) per wall bucket across all executors,
        oldest first — the exact sequence :meth:`evaluate` burns over
        (exposed so tests can hand-compute the same windows)."""
        if self.hub is None:
            return []
        interval_ms = self.hub.interval_ms
        acc: Dict[int, List[float]] = {}
        for wins in self.hub.ring_windows().values():
            for w in wins:
                bad, total = objective.window_events(w, interval_ms)
                if bad or total:
                    cell = acc.setdefault(w.bucket, [0.0, 0.0])
                    cell[0] += bad
                    cell[1] += total
        return [(b, acc[b][0], acc[b][1]) for b in sorted(acc)]

    def maybe_evaluate(self, now_ms: Optional[int] = None) -> List[Breach]:
        """Cadence-bounded evaluation (the hub's ingest hook)."""
        if not self.enabled:
            return []
        if now_ms is None:
            now_ms = int(self._clock() * 1000)
        with self._lock:
            if now_ms - self._last_eval_ms < self.eval_interval_ms:
                return []
            self._last_eval_ms = now_ms
        return self.evaluate(now_ms)

    def evaluate(self, now_ms: Optional[int] = None) -> List[Breach]:
        """Evaluate every objective now; returns the NEW breaches
        (page/warn transitions) this pass produced."""
        if not self.enabled or self.hub is None:
            return []
        if now_ms is None:
            now_ms = int(self._clock() * 1000)
        self._c_evals.inc()
        new: List[Breach] = []
        with self._lock:
            objectives = list(self.objectives.values())
        for obj in objectives:
            if obj.kind == "liveness":
                new.extend(self._evaluate_liveness(obj, now_ms))
            else:
                new.extend(self._evaluate_windows(obj, now_ms))
        self._g_breaching.set(len(self._breaching))
        for breach in new:
            self._registry.counter(
                "slo.breaches", role=self.role,
                objective=breach.objective, severity=breach.severity,
            ).inc()
            logger.warning(
                "SLO breach [%s] %s: burn fast %.2f/%.2f slow %.2f/%.2f %s",
                breach.severity, breach.objective,
                breach.burn_fast, breach.burn_fast_short,
                breach.burn_slow, breach.burn_slow_short,
                f"executor={breach.executor}" if breach.executor else "",
            )
            if self.on_breach is not None:
                try:
                    self.on_breach(breach)
                except Exception:
                    logger.exception("on_breach hook failed")
        return new

    def _evaluate_windows(self, obj: Objective, now_ms: int) -> List[Breach]:
        pts = [(bad, total) for _, bad, total in self.burn_points(obj)]
        bf, bfs, page = multi_window_burn(
            pts, obj.budget, obj.fast_windows, obj.fast_burn)
        bs, bss, warn = multi_window_burn(
            pts, obj.budget, obj.slow_windows, obj.slow_burn)
        self._registry.gauge(
            "slo.burn_rate", role=self.role, objective=obj.name,
            window="fast").set(round(bf, 4))
        self._registry.gauge(
            "slo.burn_rate", role=self.role, objective=obj.name,
            window="slow").set(round(bs, 4))
        severity = "page" if page else ("warn" if warn else None)
        return self._transition(
            obj, severity, now_ms,
            burn=(bf, bfs, bs, bss), windows=len(pts),
            observed={
                "bad": sum(p[0] for p in pts),
                "total": sum(p[1] for p in pts),
                "budget": obj.budget,
                "threshold_ms": obj.threshold_ms,
            },
        )

    def _evaluate_liveness(self, obj: Objective, now_ms: int) -> List[Breach]:
        missed = list(self.hub.missed_executors())
        known = self.hub.executors()
        out: List[Breach] = []
        for eid in missed:
            out.extend(self._transition(
                obj, "page", now_ms, executor=eid,
                observed={"missed": len(missed), "known": len(known)},
                description=f"executor {eid} stopped heartbeating",
            ))
        # recovered executors clear their per-executor breach state
        with self._lock:
            for key in [k for k in self._breaching
                        if k[0] == obj.name and k[1] not in missed]:
                del self._breaching[key]
        return out

    def _transition(
        self,
        obj: Objective,
        severity: Optional[str],
        now_ms: int,
        *,
        executor: str = "",
        burn: Tuple[float, float, float, float] = (0.0, 0.0, 0.0, 0.0),
        windows: int = 0,
        observed: Optional[dict] = None,
        description: str = "",
    ) -> List[Breach]:
        key = (obj.name, executor)
        with self._lock:
            prev = self._breaching.get(key)
            if severity is None:
                self._breaching.pop(key, None)
                if prev is not None:
                    journal_emit(
                        "slo.recover", role=self.role, executor=executor,
                        tenant=obj.tenant or "", wall_ms=now_ms,
                        objective=obj.name, was=prev,
                    )
                return []
            # re-record only on a fresh breach or a warn->page escalation
            if prev == severity or (prev == "page" and severity == "warn"):
                self._breaching[key] = (
                    severity if prev is None else prev
                )
                return []
            self._breaching[key] = severity
        journal_emit(
            f"slo.{severity}", role=self.role, executor=executor,
            tenant=obj.tenant or "", wall_ms=now_ms,
            objective=obj.name,
        )
        breach = Breach(
            objective=obj.name,
            kind=obj.kind,
            severity=severity,
            wall_ms=now_ms,
            tenant=obj.tenant,
            executor=executor,
            burn_fast=burn[0],
            burn_fast_short=burn[1],
            burn_slow=burn[2],
            burn_slow_short=burn[3],
            windows=windows,
            observed=observed or {},
            description=description or obj.description,
        )
        with self._lock:
            self.breaches.append(breach)
            self.breach_total += 1
        return [breach]

    # -- artifacts -----------------------------------------------------
    def note_diagnosis(self, diagnosis: dict) -> None:
        with self._lock:
            self.diagnoses.append(diagnosis)

    def summary(self) -> dict:
        """Ledger/snapshot view. Scalars at dict level are numeric and
        every string lives inside a list, so the trend flattener
        (obs/trend.py) charts the counts and skips the records."""
        with self._lock:
            breaches = [b.to_dict() for b in self.breaches]
            diagnoses = list(self.diagnoses)
            objectives = [
                {
                    "name": o.name,
                    "kind": o.kind,
                    "tenant": o.tenant,
                    "budget": o.budget,
                    "threshold_ms": o.threshold_ms,
                    "fast_windows": o.fast_windows,
                    "slow_windows": o.slow_windows,
                    "fast_burn": o.fast_burn,
                    "slow_burn": o.slow_burn,
                }
                for o in self.objectives.values()
            ]
            breaching = len(self._breaching)
            total = self.breach_total
        return {
            "enabled": self.enabled,
            "eval_interval_ms": self.eval_interval_ms,
            "objectives": len(objectives),
            "breaching": breaching,
            "breach_count": total,
            "diagnosis_count": len(diagnoses),
            "evaluations": self._c_evals.value,
            "objective_records": objectives,
            "breach_records": breaches,
            "diagnosis_records": diagnoses,
        }
