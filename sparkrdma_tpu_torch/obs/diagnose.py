"""Automated root-cause diagnosis for SLO breaches.

When :mod:`~sparkrdma_tpu_torch.obs.slo` records a breach, someone used to
open four artifacts by hand: the critical-path TimeBreakdown (which
category dominated the slow window?), the straggler report (is one
executor behind?), the circuit/quota state (is the system already
defending itself?), and the fault plan (did chaos testing do this on
purpose?). This module is that correlation walk, mechanised: one
breach in, one ``Diagnosis`` artifact out.

A Diagnosis is a plain JSON-able dict:

- ``evidence`` — the raw inputs, verbatim: active fault-plan state
  (spec/seed/injection counts), the last TimeBreakdown pushed by the
  engine (dominant category + profiler gap frames), the hub's
  straggler report, circuit-breaker states, missed-heartbeat set,
  per-tenant quota blocks, and (when a ledger dir is supplied) the
  latest trend deltas;
- ``causes`` — candidate root causes ranked by an **explicit rubric**
  (:data:`RUBRIC` — base scores by evidence class, plus
  :data:`CORROBORATION_BONUS` when two independent evidence sources
  name the same executor). Deterministic: equal scores tie-break by
  cause name, so the same evidence always yields the same ranking;
- ``top_cause`` — the ranked winner, duplicated at top level so
  downstream consumers (flight records, soak ledgers, CI assertions)
  don't have to index into the list.

The rubric, highest first:

====================  =====  ==========================================
cause                 score  evidence source
====================  =====  ==========================================
injected-fault          4.0  testing/faults.py plan actually fired
dead-executor           3.5  hub missed-heartbeat accounting
dead-metastore-peer     3.25 metastore.peer_kills / lease takeovers
straggler               3.0  robust-z straggler report
circuit-open            2.5  resilience SourceHealthRegistry states
quota-backpressure      2.0  tenant.quota_blocks counters
saturated-resource      1.75 capacity plane binding resource
dominant-category       1.5  TimeBreakdown critical path
trend-regression        1.0  ledger deltas vs committed trend
====================  =====  ==========================================

Two PR-20 evidence sources feed the walk without new top-level cause
machinery: the merged cluster **event journal** (time-windowed around
the breach) names executors for the corroboration bonus and backfills
ranked causes when a live metric source is silent (e.g. the breaker
already closed but ``circuit.open`` is in the journal), and the
**capacity plane**'s USE report contributes the ``saturated-resource``
row when the binding resource shows saturation, errors, or
near-exhausted headroom.

An injected fault outranks everything because it is the one cause we
*know* is real; infrastructure evidence (dead executor, straggler)
outranks symptom evidence (dominant category), which outranks
historical context (trend). Rendered by :func:`render` (the obs CLI's
``--diagnose <file>``, ``python -m sparkrdma_tpu_torch.obs``).

Stdlib-only, jax-free, and best-effort throughout: a diagnosis pass
must never add a failure mode to the breach path it explains.
A copy of the JAX package's ``obs/diagnose.py``, its imports rewritten
to this package.

"""

from __future__ import annotations

import logging
import time
from typing import Callable, Dict, List, Optional

from sparkrdma_tpu_torch.obs.metrics import (
    MetricsRegistry,
    get_registry,
    parse_metric_key,
)

logger = logging.getLogger(__name__)

# Base score per cause class — see the module docstring for the
# reasoning behind the ordering.
RUBRIC: Dict[str, float] = {
    "injected-fault": 4.0,
    "dead-executor": 3.5,
    # a dead metadata peer degrades EVERY job's control plane (routes
    # fail over, epochs fence in-flight publishes) but costs no shuffle
    # bytes — between the dead executor and the straggler
    "dead-metastore-peer": 3.25,
    "straggler": 3.0,
    "circuit-open": 2.5,
    "quota-backpressure": 2.0,
    # the USE-method binding resource: symptom-adjacent (the resource
    # is saturated *because* of load) but more actionable than the raw
    # dominant category — it names the knob to turn
    "saturated-resource": 1.75,
    "dominant-category": 1.5,
    "trend-regression": 1.0,
}

# Added when a cause's executor is independently named by the breach
# itself or by a second evidence source.
CORROBORATION_BONUS = 0.5

# Journal event kinds that can stand in for a live evidence source when
# the transient already resolved (breaker closed, tenant unblocked, peer
# re-adopted) by the time the diagnosis runs. Maps event kind -> RUBRIC
# cause class.
JOURNAL_CAUSE_KINDS: Dict[str, str] = {
    "driver.kill": "dead-metastore-peer",
    "meta.peer_kill": "dead-metastore-peer",
    "meta.takeover": "dead-metastore-peer",
    "circuit.open": "circuit-open",
    "straggler.flag": "straggler",
    "quota.block": "quota-backpressure",
}

# How far around the breach instant journal events count as evidence:
# everything in the half-minute leading up to it (causes precede
# symptoms) plus a short tail for events that race the breach emit.
JOURNAL_WINDOW_BEFORE_MS = 30_000
JOURNAL_WINDOW_AFTER_MS = 5_000


def _fault_evidence() -> dict:
    from sparkrdma_tpu_torch.testing.faults import active

    plan = active()
    if plan is None:
        return {"active": 0, "rules": []}
    return {
        "active": 1,
        "seed": plan.seed,
        "total_injected": plan.total_injected,
        "spec": [plan.spec],
        "rules": [
            {
                "rule": [f"{r.op}:{r.kind}"],
                "stage": [r.stage or ""],
                "peer": [r.peer or ""],
                "delay_ms": r.delay_ms,
                "injected": plan.injected_count(r.op, r.kind),
            }
            for r in plan.rules
        ],
    }


def _dominant_category(breakdown: Optional[dict]) -> Optional[dict]:
    if not breakdown:
        return None
    cats = breakdown.get("categories_ms") or {}
    busy = {k: v for k, v in cats.items()
            if k not in ("idle-untraced",) and v > 0}
    if not busy:
        return None
    name = max(sorted(busy), key=lambda k: busy[k])
    wall = breakdown.get("wall_ms") or 0
    return {
        "category": name,
        "ms": round(busy[name], 3),
        "share": round(busy[name] / wall, 4) if wall else 0.0,
    }


def _quota_evidence(registry: MetricsRegistry) -> Dict[str, int]:
    snap = registry.snapshot(prefix="tenant.quota_blocks")
    out: Dict[str, int] = {}
    for key, v in snap.get("counters", {}).items():
        if v > 0:
            _, labels = parse_metric_key(key)
            tenant = labels.get("tenant", "")
            out[tenant] = out.get(tenant, 0) + int(v)
    return out


def _metastore_evidence(registry: MetricsRegistry) -> Dict[str, int]:
    """Dead metadata peers (sparkrdma_tpu_torch/metastore): ``kill_peer``
    counts ``metastore.peer_kills`` and every route through the dead
    shard's range pays a ``metastore.lease_takeovers`` failover —
    control-plane degradation with zero shuffle bytes lost."""
    snap = registry.snapshot(prefix="metastore.")
    out: Dict[str, int] = {"peer_kills": 0, "lease_takeovers": 0}
    for key, v in snap.get("counters", {}).items():
        name, _ = parse_metric_key(key)
        if name == "metastore.peer_kills":
            out["peer_kills"] += int(v)
        elif name == "metastore.lease_takeovers":
            out["lease_takeovers"] += int(v)
    return out


def _journal_evidence(hub, breach_wall_ms) -> List[dict]:
    """Merged journal events time-windowed around the breach.

    Falls back to the journal tail when the window is empty (clock skew
    between emitters and the breach stamp must not erase evidence)."""
    journal = getattr(hub, "journal", None)
    if journal is None:
        return []
    merged = journal.merged(last=256)
    if not merged:
        return []
    if breach_wall_ms:
        lo = breach_wall_ms - JOURNAL_WINDOW_BEFORE_MS
        hi = breach_wall_ms + JOURNAL_WINDOW_AFTER_MS
        windowed = [e for e in merged
                    if lo <= e.get("wall_ms", 0) <= hi]
        if windowed:
            return windowed
    return merged[-64:]


def _capacity_evidence(hub) -> dict:
    plane = getattr(hub, "capacity", None)
    if plane is None:
        return {}
    return plane.capacity_report(refresh=True)


def _trend_evidence(trend_dir: Optional[str]) -> dict:
    if not trend_dir:
        return {}
    try:
        from sparkrdma_tpu_torch.obs.trend import build_trend

        trend = build_trend(trend_dir)
    except Exception:
        logger.debug("trend evidence unavailable", exc_info=True)
        return {}
    rows = sorted(
        (
            (name, t["rel_delta_latest"])
            for name, t in trend.get("series", {}).items()
            if t.get("rel_delta_latest") is not None
        ),
        key=lambda r: r[1],
    )
    return {
        "regressions": [r.get("series", "") for r in
                        trend.get("regressions", [])],
        "worst_series": [
            {"name": [n], "delta": d} for n, d in rows[:5]
        ],
    }


def build_diagnosis(
    hub,
    breach,
    *,
    registry: Optional[MetricsRegistry] = None,
    trend_dir: Optional[str] = None,
    clock: Callable[[], float] = time.time,
) -> dict:
    """Assemble and rank the root-cause artifact for one breach.

    ``breach`` is a :class:`~sparkrdma_tpu_torch.obs.slo.Breach` or its
    ``to_dict()`` form. Every evidence probe is independently
    best-effort; a probe that fails contributes nothing rather than
    failing the diagnosis."""
    reg = registry or get_registry()
    t0 = time.perf_counter()
    breach_d = breach if isinstance(breach, dict) else breach.to_dict()
    breach_exec = breach_d.get("executor", "")
    breach_tenant = breach_d.get("tenant", "")

    def probe(fn, default):
        try:
            return fn()
        except Exception:
            logger.debug("diagnosis evidence probe failed", exc_info=True)
            return default

    faults = probe(_fault_evidence, {"active": 0, "rules": []})
    breakdown = probe(
        lambda: getattr(hub, "last_breakdown", None), None) or {}
    stragglers = probe(
        lambda: hub.last_straggler_report(), {}) or {}
    health = probe(lambda: hub.source_health(), {}) or {}
    missed = probe(lambda: list(hub.missed_executors()), [])
    quota = probe(lambda: _quota_evidence(reg), {})
    metastore = probe(lambda: _metastore_evidence(reg), {})
    journal_events = probe(
        lambda: _journal_evidence(hub, breach_d.get("wall_ms")), [])
    capacity = probe(lambda: _capacity_evidence(hub), {}) or {}
    trend = probe(lambda: _trend_evidence(trend_dir), {})
    dominant = _dominant_category(breakdown)
    gap_frames = list(breakdown.get("gap_frames", []))[:5]

    straggler_ids = list(stragglers.get("stragglers", []))
    open_circuits = sorted(
        k for k, v in health.items() if "open" in str(v).lower()
    )

    # which executors does each independent evidence source name?
    named_by: Dict[str, set] = {}

    def name_executor(eid: str, source: str) -> None:
        if eid:
            named_by.setdefault(eid, set()).add(source)

    for eid in missed:
        name_executor(eid, "missed-heartbeat")
    for eid in straggler_ids:
        name_executor(eid, "straggler-report")
    for key in open_circuits:
        # breaker keys are "<executor>" or "<tenant>:<executor>"
        name_executor(key.rpartition(":")[2], "circuit")
    for ev in journal_events:
        name_executor(ev.get("executor", ""), "journal")
    if breach_exec:
        name_executor(breach_exec, "breach")

    def corroborated(eid: str, own_source: str) -> bool:
        others = named_by.get(eid, set()) - {own_source}
        return bool(others) or (bool(eid) and eid == breach_exec)

    causes: List[dict] = []

    def add_cause(kind: str, summary: str, *, executor: str = "",
                  category: str = "", source: str = "",
                  detail: Optional[dict] = None) -> None:
        score = RUBRIC[kind]
        corr = corroborated(executor, source) if executor else False
        if corr:
            score += CORROBORATION_BONUS
        causes.append({
            "cause": kind,
            "score": round(score, 2),
            "corroborated": 1 if corr else 0,
            "executor": executor,
            "category": category,
            "summary": [summary],
            "detail": detail or {},
        })

    for rule in faults.get("rules", []):
        if rule.get("injected", 0) <= 0:
            continue
        peer = (rule.get("peer") or [""])[0]
        stage = (rule.get("stage") or [""])[0]
        category = dominant["category"] if dominant else stage
        rname = (rule.get("rule") or ["?"])[0]
        add_cause(
            "injected-fault",
            f"fault plan rule {rname} fired "
            f"{rule.get('injected', 0)}x"
            + (f" against {peer}" if peer else ""),
            executor=peer, category=category, source="fault-plan",
            detail={"injected": rule.get("injected", 0),
                    "delay_ms": rule.get("delay_ms", 0),
                    "stage": [stage]},
        )
    for eid in missed:
        add_cause(
            "dead-executor",
            f"executor {eid} stopped heartbeating",
            executor=eid, source="missed-heartbeat",
        )
    if metastore.get("peer_kills", 0) > 0:
        add_cause(
            "dead-metastore-peer",
            f"{metastore['peer_kills']} metadata peer(s) lost their "
            f"shard lease; "
            f"{metastore.get('lease_takeovers', 0)} route failover(s)",
            source="metastore",
            detail=dict(metastore),
        )
    for eid in straggler_ids:
        flags = (stragglers.get("executors", {})
                 .get(eid, {}).get("flags", []))
        add_cause(
            "straggler",
            f"executor {eid} flagged by robust-z straggler detection",
            executor=eid, source="straggler-report",
            detail={"flags": flags[:3]},
        )
    for key in open_circuits:
        add_cause(
            "circuit-open",
            f"circuit breaker open for source {key}",
            executor=key.rpartition(":")[2], source="circuit",
            detail={"state": [str(health.get(key, ""))]},
        )
    for tenant, blocks in sorted(quota.items()):
        summary = (f"tenant {tenant} hit quota backpressure "
                   f"{blocks}x")
        cause_detail = {"tenant": [tenant], "blocks": blocks}
        if breach_tenant and tenant == breach_tenant:
            cause_detail["matches_breach_tenant"] = 1
        add_cause("quota-backpressure", summary, detail=cause_detail)
    binding = capacity.get("binding") or {}
    if binding and (
        binding.get("saturation", 0) > 0
        or binding.get("errors", 0) > 0
        or (binding.get("utilization") or 0.0) >= 0.9
    ):
        util = binding.get("utilization") or 0.0
        add_cause(
            "saturated-resource",
            f"binding resource {binding.get('resource', '?')} at "
            f"{util:.0%} utilization (headroom "
            f"{binding.get('headroom', 1.0):.0%}, saturation "
            f"{binding.get('saturation', 0)}, errors "
            f"{binding.get('errors', 0)})",
            source="capacity",
            detail={
                "resource": [binding.get("resource", "")],
                "utilization": round(util, 4),
                "headroom": round(binding.get("headroom", 1.0), 4),
                "saturation": binding.get("saturation", 0),
                "errors": binding.get("errors", 0),
            },
        )
    if dominant is not None:
        add_cause(
            "dominant-category",
            f"critical path dominated by {dominant['category']} "
            f"({dominant['ms']} ms, {dominant['share']:.0%} of wall)",
            category=dominant["category"], source="breakdown",
            detail=dict(dominant, category=dominant["category"]),
        )
    for name in trend.get("regressions", []):
        add_cause(
            "trend-regression",
            f"committed-trend regression on {name}",
            detail={"series": [name]},
        )

    # Journal evidence per cause class: when a live metric source
    # already produced the cause, the windowed events attach to it as
    # corroborating detail; when the transient resolved before the
    # diagnosis ran (breaker closed, peer re-adopted), the journal
    # events BECOME the ranked cause — the journal remembers what the
    # point-in-time probes no longer see.
    journal_grouped: Dict[tuple, List[dict]] = {}
    for ev in journal_events:
        kind = JOURNAL_CAUSE_KINDS.get(ev.get("kind", ""))
        if kind is None:
            continue
        key = (kind, ev.get("executor", ""))
        journal_grouped.setdefault(key, []).append(ev)
    for (kind, eid), evs in sorted(journal_grouped.items()):
        existing = next(
            (c for c in causes
             if c["cause"] == kind and c["executor"] == eid), None)
        if existing is not None:
            existing["detail"]["journal_events"] = evs[-3:]
            continue
        last = evs[-1]
        hlc = last.get("hlc") or [0, 0]
        add_cause(
            kind,
            f"journal: {len(evs)}x {last.get('kind', '?')}"
            + (f" on {eid}" if eid else "")
            + f" (last hlc=({hlc[0]},{hlc[1]}))",
            executor=eid, source="journal",
            detail={"events": evs[-3:], "count": len(evs)},
        )

    causes.sort(key=lambda c: (-c["score"], c["cause"], c["executor"]))
    build_ms = (time.perf_counter() - t0) * 1000
    role = getattr(hub, "role", "driver") if hub is not None else "driver"
    reg.counter("diagnosis.builds", role=role).inc()
    reg.histogram("diagnosis.build_ms", role=role).observe(build_ms)

    return {
        "kind": "sparkrdma_diagnosis",
        "version": 1,
        "generated_wall_ms": int(clock() * 1000),
        "build_ms": round(build_ms, 3),
        "role": role,
        "breach": breach_d,
        "evidence": {
            "faults": faults,
            "breakdown_dominant": dominant or {},
            "gap_frames": gap_frames,
            "stragglers": straggler_ids,
            "open_circuits": open_circuits,
            "missed_heartbeats": missed,
            "quota_blocks": quota,
            "metastore": metastore,
            "journal": journal_events[-16:],
            "capacity": capacity,
            "trend": trend,
        },
        "causes": causes,
        "top_cause": causes[0] if causes else {},
    }


def render(diag: dict) -> str:
    """Human-readable CLI view of one diagnosis artifact."""
    out: List[str] = []
    breach = diag.get("breach", {})
    out.append("SLO diagnosis")
    out.append(
        f"  breach     {breach.get('objective', '?')} "
        f"[{breach.get('severity', '?')}] kind={breach.get('kind', '?')}"
    )
    if breach.get("executor"):
        out.append(f"  executor   {breach['executor']}")
    if breach.get("tenant"):
        out.append(f"  tenant     {breach['tenant']}")
    if breach.get("kind") not in (None, "liveness"):
        out.append(
            "  burn       "
            f"fast {breach.get('burn_fast', 0):.2f}"
            f"/{breach.get('burn_fast_short', 0):.2f} "
            f"slow {breach.get('burn_slow', 0):.2f}"
            f"/{breach.get('burn_slow_short', 0):.2f} "
            f"over {breach.get('windows', 0)} windows"
        )
    top = diag.get("top_cause") or {}
    if top:
        summary = (top.get("summary") or ["?"])[0]
        out.append(
            f"  top cause  {top.get('cause', '?')} "
            f"(score {top.get('score', 0)}): {summary}"
        )
    causes = diag.get("causes", [])
    if causes:
        out.append(f"  ranked causes ({len(causes)}):")
        for c in causes:
            mark = "*" if c.get("corroborated") else " "
            extra = ""
            if c.get("executor"):
                extra += f" executor={c['executor']}"
            if c.get("category"):
                extra += f" category={c['category']}"
            out.append(
                f"   {mark} {c.get('score', 0):>4}  "
                f"{c.get('cause', '?')}{extra}"
            )
            summary = (c.get("summary") or [""])[0]
            if summary:
                out.append(f"         {summary}")
    else:
        out.append("  no candidate causes (breach without evidence)")
    ev = diag.get("evidence", {})
    gaps = ev.get("gap_frames", [])
    if gaps:
        out.append("  profiler gap frames:")
        for g in gaps[:3]:
            out.append(f"    {g}")
    binding = (ev.get("capacity") or {}).get("binding") or {}
    if binding:
        out.append(
            f"  capacity   binding={binding.get('resource', '?')} "
            f"headroom={binding.get('headroom', 1.0):.0%}"
        )
    jev = ev.get("journal", [])
    if jev:
        out.append(f"  journal    {len(jev)} event(s) in breach window")
    return "\n".join(out)


# package-namespace alias (sparkrdma_tpu_torch.obs already exports several
# render_* functions; the bare name stays for module-local callers)
render_diagnosis = render
