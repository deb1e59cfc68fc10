"""The port's SLO engine (``obs/slo.py``), diagnosis (``obs/diagnose.py``),
capacity plane (``obs/capacity.py``) and trend engine (``obs/trend.py``)
against the JAX package's: burn-rate math, page / warn transitions and
escalation, the liveness breach and the diagnosis it leaves, the
diagnosis ranking on the same evidence, the USE capacity report under a
blocked quota, and the trend over the repository's bench ledgers. Every
comparison runs the same inputs through both packages under one
injected clock."""

import json
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from sparkrdma_tpu.obs import capacity as jax_capacity
from sparkrdma_tpu.obs import diagnose as jax_diagnose
from sparkrdma_tpu.obs import journal as jax_journal
from sparkrdma_tpu.obs import metrics as jax_metrics
from sparkrdma_tpu.obs import slo as jax_slo
from sparkrdma_tpu.obs import telemetry as jax_telemetry
from sparkrdma_tpu.obs import timeseries as jax_timeseries
from sparkrdma_tpu.obs import trend as jax_trend
from sparkrdma_tpu.tenancy import quota as jax_quota
from sparkrdma_tpu.testing import faults as jax_faults
from sparkrdma_tpu.utils import config as jax_config

from sparkrdma_tpu_torch.obs import (capacity, diagnose, journal, metrics, slo, telemetry,
                                     timeseries, trend)
from sparkrdma_tpu_torch.tenancy import quota
from sparkrdma_tpu_torch.testing import faults
from sparkrdma_tpu_torch.utils import config

JAX = SimpleNamespace(capacity=jax_capacity, diagnose=jax_diagnose, journal=jax_journal,
                      metrics=jax_metrics, slo=jax_slo, telemetry=jax_telemetry,
                      timeseries=jax_timeseries, trend=jax_trend, quota=jax_quota,
                      faults=jax_faults, config=jax_config)
PORT = SimpleNamespace(capacity=capacity, diagnose=diagnose, journal=journal,
                       metrics=metrics, slo=slo, telemetry=telemetry,
                       timeseries=timeseries, trend=trend, quota=quota, faults=faults,
                       config=config)
BOTH = [JAX, PORT]
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _jax_registry_left_clean():
    """The JAX code run here counts into the JAX package's process
    registry, which later test files in this worker read (a diagnosis
    reads its quota and metastore counters): zero it when the module
    ends."""
    yield
    jax_metrics.get_registry().reset()


@pytest.fixture(autouse=True)
def _fresh_journals():
    for mod in BOTH:
        mod.journal.reset()
    yield
    for mod in BOTH:
        mod.journal.reset()


class Clock:
    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


def _without(doc, keys=("build_ms",)):
    """``doc`` less the diagnosis pass's own wall time (a perf_counter
    reading no clock injection reaches)."""
    if isinstance(doc, dict):
        return {k: _without(v, keys) for k, v in doc.items() if k not in keys}
    if isinstance(doc, list):
        return [_without(v, keys) for v in doc]
    return doc


# ---------------------------------------------------------------------------
# burn-rate math
# ---------------------------------------------------------------------------

def _burn_cases():
    rng = np.random.default_rng(1900)
    cases = [([(5, 100), (5, 100)], 0.01, 2, 8.0), ([], 0.01, 4, 2.0),
             ([(0, 0)], 0.01, 1, 8.0), ([(1, 10)], 0.0, 1, 8.0),
             ([(100, 100)] * 6 + [(0, 100)] * 2, 0.01, 8, 8.0),
             ([(3, 100)] * 32, 0.01, 32, 2.0)]
    for _ in range(4):
        n = int(rng.integers(1, 40))
        tot = rng.integers(0, 200, size=n)
        bad = (tot * rng.uniform(0, 0.3, size=n)).astype(int)
        cases.append(([(int(b), int(t)) for b, t in zip(bad, tot)],
                      float(rng.choice([0.001, 0.01, 0.05])), int(rng.integers(1, 40)),
                      float(rng.choice([2.0, 8.0, 14.4]))))
    return cases


@pytest.mark.parametrize("case", range(len(_burn_cases())))
def test_burn_rate_and_multi_window_equal_jax(case):
    pts, budget, long_n, thresh = _burn_cases()[case]
    out = [(mod.slo.burn_rate(pts, budget), mod.slo.multi_window_burn(pts, budget, long_n, thresh))
           for mod in BOTH]
    assert out[1] == out[0]


@pytest.mark.parametrize("threshold", [50, 100, 150, 200, 1000])
def test_exceedance_and_judge_equal_jax(threshold):
    buckets = {"le_100": 3, "le_200": 2, "overflow": 1}
    out = []
    for mod in BOTH:
        verdicts = [mod.slo.judge("o", v, threshold, c)
                    for v in (None, 5, threshold, 2000) for c in ("le", "ge", "eq")]
        with pytest.raises(ValueError):
            mod.slo.judge("o", 1, 1, "gt")
        out.append((mod.slo.exceedance(buckets, threshold), mod.slo.exceedance({}, threshold),
                    verdicts))
    assert out[1] == out[0]


def test_objective_window_events_equal_jax():
    out = []
    for mod in BOTH:
        ring = mod.timeseries.TimeSeriesRing(size=4, interval_ms=100)
        ring.append(100, 1, counters={"transport.read_errors{role=e0}": 5,
                                      "transport.reads{role=e0}": 3},
                    histograms={"engine.task_ms{role=e0,tenant=tenant-0}": {
                        "count": 10, "sum": 9000.0, "buckets": {"le_100": 1, "le_2000": 9}},
                        "engine.task_ms{role=e1}": {"count": 4, "sum": 4000.0}})
        w = ring.windows()[0]
        objs = [mod.slo.Objective("errs", "ratio", bad=("transport.read_errors",),
                                  total=("transport.reads",)),
                mod.slo.Objective("p99", "latency", series=("engine.task_ms",),
                                  threshold_ms=100.0),
                mod.slo.Objective("p99-t0", "latency", series=("engine.task_ms",),
                                  tenant="tenant-0", threshold_ms=100.0),
                mod.slo.Objective("p95", "latency", series=("x",), threshold_ms=10,
                                  percentile=95.0)]
        out.append([(o.window_events(w, 100), o.budget) for o in objs])
    assert out[1] == out[0]
    assert out[1][0][0] == (5.0, 5.0) and out[1][1][0] == (9.0, 10.0)


# ---------------------------------------------------------------------------
# the engine on a hub: transitions, escalation, liveness, diagnosis
# ---------------------------------------------------------------------------

def _lat_payload(eid, seq, wall, bad, good):
    return {"v": 1, "executor_id": eid, "seq": seq, "wall_ms": wall, "interval_ms": 100,
            "counters": {}, "gauges": {},
            "histograms": {f"engine.task_ms{{role={eid}}}": {
                "count": bad + good, "sum": float(bad * 1200 + good * 5),
                "buckets": {"le_100": good, "le_2000": bad}}}}


def _hub(mod, clock, conf=None):
    return mod.telemetry.TelemetryHub(conf, role="drv", registry=mod.metrics.MetricsRegistry(),
                                      interval_ms=100, ring_size=64, clock=clock)


# (bad, good) per beat, and where the engine evaluates
SLO_SCRIPTS = {
    "page_recover_repage": [(9, 1)] * 2 + ["eval"] + [(9, 1), "eval"] + [(0, 10)] * 4
    + ["eval"] + [(10, 0)] * 2 + ["eval"],
    "warn_then_page": [(4, 96)] * 8 + ["eval"] + [(20, 80)] * 4 + ["eval"],
    "healthy": [(0, 50)] * 10 + ["eval"],
}


@pytest.mark.parametrize("script", sorted(SLO_SCRIPTS))
def test_slo_transitions_equal_jax(script):
    out = []
    for mod in BOTH:
        clock = Clock(0.0)
        hub = _hub(mod, clock)
        try:
            hub.slo.add(mod.slo.Objective("task-p99", "latency", series=("engine.task_ms",),
                                          threshold_ms=100, fast_windows=4, slow_windows=8))
            seq, new = 0, []
            for step in SLO_SCRIPTS[script]:
                if step == "eval":
                    new.append([b.to_dict() for b in hub.slo.evaluate(now_ms=seq * 100)])
                    continue
                seq += 1
                clock.t = seq / 10.0
                hub.ingest(_lat_payload("e0", seq, seq * 100, *step))
            snap = hub._registry.snapshot()
            out.append((new, _without(hub.slo.summary()), hub.journal.merged(),
                        {k: v for k, v in snap["counters"].items() if k.startswith("slo.")},
                        {k: v for k, v in snap["gauges"].items() if k.startswith("slo.")}))
        finally:
            hub.stop()
    assert out[1] == out[0]
    severities = [[b["severity"] for b in n] for n in out[1][0]]
    summary = out[1][1]
    if script == "page_recover_repage":
        assert severities == [["page"], [], [], ["page"]]
        assert summary["breach_count"] == 2
    elif script == "warn_then_page":
        assert severities == [["warn"], ["page"]]
    else:
        assert severities == [[]] and summary["breach_count"] == 0
    # every page or warn transition left a diagnosis (the breach hook
    # swallows its errors, so a broken import would show only here)
    assert summary["diagnosis_count"] == summary["breach_count"]
    kinds = [e["kind"] for e in out[1][2]]
    assert kinds.count("slo.page") + kinds.count("slo.warn") == summary["breach_count"]


def test_liveness_breach_names_dead_executor_and_diagnoses_as_jax():
    out = []
    for mod in BOTH:
        clock = Clock(0.0)
        hub = _hub(mod, clock)
        try:
            base = {"v": 1, "interval_ms": 100, "counters": {}, "gauges": {}, "histograms": {}}
            hub.ingest(dict(base, executor_id="e0", seq=1, wall_ms=100))
            hub.ingest(dict(base, executor_id="e1", seq=1, wall_ms=110))
            clock.t = 0.6
            hub.ingest(dict(base, executor_id="e0", seq=2, wall_ms=600))
            first = [b.to_dict() for b in hub.slo.evaluate(now_ms=600)]
            again = hub.slo.evaluate(now_ms=700)
            diags = hub.slo.summary()["diagnosis_records"]
            text = mod.diagnose.render(diags[-1]) if diags else ""
            clock.t = 0.84
            hub.ingest(dict(base, executor_id="e1", seq=2, wall_ms=840))
            after = hub.slo.evaluate(now_ms=840)
            out.append((first, again, _without(diags), text, hub.missed_executors(), after,
                        hub.slo.summary()["breaching"]))
        finally:
            hub.stop()
    assert out[1] == out[0]
    first, _, diags = out[1][:3]
    assert [(b["objective"], b["severity"], b["executor"]) for b in first] == [
        ("executor-liveness", "page", "e1")]
    assert diags and diags[-1]["top_cause"]["cause"] == "dead-executor"
    assert diags[-1]["top_cause"]["executor"] == "e1"
    assert out[1][4:] == ([], [], 0)


def test_conf_installs_tenant_objectives_as_jax():
    out = []
    for mod in BOTH:
        conf = mod.config.TpuShuffleConf({
            "tpu.shuffle.obs.slo.taskP99Ms": "250",
            "tpu.shuffle.obs.slo.tenant.tenant-7.taskP99Ms": "90",
            "tpu.shuffle.tenancy.weights": "tenant-a:2,tenant-b:1",
        })
        hub = _hub(mod, Clock(1.0), conf)
        bare = _hub(mod, Clock(1.0))
        try:
            out.append((hub.slo.summary()["objective_records"],
                        sorted(bare.slo.objectives)))
        finally:
            hub.stop()
            bare.stop()
    assert out[1] == out[0]
    names = {o["name"] for o in out[1][0]}
    assert {"task-p99", "task-p99-tenant-a", "task-p99-tenant-b",
            "task-p99-tenant-7"} <= names
    assert out[1][1] == ["executor-liveness", "fetch-error-ratio"]


# ---------------------------------------------------------------------------
# diagnosis ranking on the same evidence
# ---------------------------------------------------------------------------

def _breach(mod, executor=""):
    return mod.slo.Breach(objective="task-p99", kind="latency", severity="page",
                          wall_ms=1000, executor=executor, burn_fast=31.2,
                          burn_fast_short=28.9)


@pytest.mark.parametrize("executor", ["", "e1", "e2"])
def test_diagnosis_ranks_injected_fault_as_jax(executor):
    out = []
    for mod in BOTH:
        with mod.faults.installed("stage:delay:0:delay_ms=1,stage=map_task,peer=e1") as plan:
            plan.on_stage("map_task", [], peer="e1")  # the rule fires
            diag = mod.diagnose.build_diagnosis(None, _breach(mod, executor),
                                                registry=mod.metrics.MetricsRegistry(),
                                                clock=Clock(2.0))
        out.append(_without(diag))
    assert out[1] == out[0]
    top = out[1]["top_cause"]
    assert top["cause"] == "injected-fault" and top["executor"] == "e1"
    assert top["corroborated"] == (1 if executor == "e1" else 0)


def test_diagnosis_with_breakdown_stragglers_capacity_and_journal_as_jax():
    out = []
    for mod in BOTH:
        clock = Clock(0.95)
        hub = _hub(mod, clock)
        try:
            for seq in (1, 2, 3):
                for eid, ms in (("e0", 10.0), ("e1", 400.0), ("e2", 12.0)):
                    hub.ingest({"v": 1, "executor_id": eid, "seq": seq, "wall_ms": 900 + seq,
                                "interval_ms": 100, "counters": {}, "gauges": {},
                                "histograms": {"engine.task_ms": {"count": 1, "sum": ms}}})
            hub.note_breakdown({"wall_ms": 100.0, "coverage": 0.9,
                                "categories_ms": {"dma-wave": 61.0, "compute": 20.0},
                                "gap_frames": ["a:device_put"]})
            mod.journal.emit("quota.block", tenant="hog", executor="e2")
            diag = mod.diagnose.build_diagnosis(hub, _breach(mod).to_dict(),
                                                registry=hub._registry, clock=clock)
            out.append((_without(diag), mod.diagnose.render(diag).splitlines()[:3]))
        finally:
            hub.stop()
    assert out[1] == out[0]
    causes = {c["cause"] for c in out[1][0]["causes"]}
    assert {"straggler", "dominant-category"} <= causes


def test_trend_evidence_is_non_empty_with_the_repository_ledgers():
    out = []
    for mod in BOTH:
        diag = mod.diagnose.build_diagnosis(None, _breach(mod), trend_dir=str(ROOT),
                                            registry=mod.metrics.MetricsRegistry(),
                                            clock=Clock(3.0))
        out.append(_without(diag))
    assert out[1] == out[0]
    ev = out[1]["evidence"]["trend"]
    assert ev and ev["worst_series"], "trend evidence lost (a swallowed import error?)"


# ---------------------------------------------------------------------------
# capacity plane
# ---------------------------------------------------------------------------

def _blocked_capacity(mod):
    mod.quota.reset()
    conf = mod.config.TpuShuffleConf({
        "tpu.shuffle.tenancy.quota.hog.mempoolBytes": "1k",
        "tpu.shuffle.tenancy.quotaBlockMaxMs": "2000",
    })
    mod.quota.install(conf)
    broker = mod.quota.broker("mempool")
    broker.charge("hog", 1024)
    broker.charge("quiet", 128)
    blocked = threading.Thread(target=broker.charge, args=("hog", 512), daemon=True)
    blocked.start()
    deadline = time.monotonic() + 5.0
    while broker.waiting() == 0 and time.monotonic() < deadline:
        time.sleep(0.005)
    try:
        assert broker.waiting() == 1
        plane = mod.capacity.CapacityPlane(conf, mod.metrics.MetricsRegistry(), role="driver",
                                           clock=Clock(4.0))
        report = plane.capacity_report(refresh=True)
        return report, plane.summary(), plane.maybe_evaluate(now_ms=4001)
    finally:
        broker.release("hog", 1024)
        blocked.join(timeout=5)
        assert not blocked.is_alive()
        mod.quota.reset()


def test_capacity_report_names_blocked_mempool_as_jax():
    out = [_blocked_capacity(mod) for mod in BOTH]
    assert out[1] == out[0]
    report = out[1][0]
    assert set(report["resources"]) == set(capacity.RESOURCES)
    assert report["binding"]["resource"] == "mempool"
    assert report["binding"]["utilization"] == 1.0 and report["binding"]["headroom"] == 0.0


def test_capacity_disabled_by_knob_as_jax():
    out = []
    for mod in BOTH:
        conf = mod.config.TpuShuffleConf({"tpu.shuffle.obs.capacity.enabled": "false"})
        plane = mod.capacity.CapacityPlane(conf, mod.metrics.MetricsRegistry(), clock=Clock(1.0))
        out.append((plane.maybe_evaluate(), plane.summary()))
    assert out[1] == out[0] and out[1][0] is False


# ---------------------------------------------------------------------------
# trend over the repository's ledgers
# ---------------------------------------------------------------------------

def _port_md(jax_md):
    """The JAX markdown as the port renders it: its header names the
    port's command."""
    return jax_md.replace("sparkrdma_tpu.obs.trend", "sparkrdma_tpu_torch.obs.trend")


def test_build_trend_and_markdown_equal_jax():
    out = [(t, mod.trend.render_markdown(t))
           for t, mod in ((mod.trend.build_trend(str(ROOT)), mod) for mod in BOTH)]
    assert out[1][0] == out[0][0]
    assert out[1][1] == _port_md(out[0][1])
    doc = out[1][0]
    assert doc["num_series"] > 0 and set(doc["rounds"]) == {"bench", "soak", "workloads"}
    assert doc["errors"] == []


def test_trend_cli_reads_the_ledgers_and_writes_only_where_asked(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    assert trend.main(["--dir", str(ROOT)]) == 0
    assert list(tmp_path.iterdir()) == []  # nothing written by default
    assert "nothing written" in capsys.readouterr().out
    assert trend.main(["--dir", str(ROOT), "--out", "t.json", "--md", "t.md",
                       "--check"]) == 0
    doc = json.loads((tmp_path / "t.json").read_text())
    assert doc == json.loads(json.dumps(jax_trend.build_trend(str(ROOT))))
    assert (tmp_path / "t.md").read_text() == _port_md(jax_trend.render_markdown(
        jax_trend.build_trend(str(ROOT))))
    assert trend.main(["--dir", str(tmp_path)]) == 2  # no ledgers there
