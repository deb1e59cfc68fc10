"""The port's driver half of the telemetry plane against the JAX
package's: ``TimeSeriesRing``, ``TelemetryHub`` (ingest, gaps, missed
heartbeats, the straggler detector, partition bytes, the flight
recorder) and the OpenMetrics egress (``obs/export.py``). The same
synthetic heartbeat payloads, made from one numpy seed, go into a JAX
hub and a port hub under one injected clock; what the two hubs say must
be equal, and the OpenMetrics text byte-equal. A JAX executor's
heartbeats fold into a port hub, and the reverse."""

import json
import re
import urllib.request
from types import SimpleNamespace

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from sparkrdma_tpu.obs import export as jax_export
from sparkrdma_tpu.obs import journal as jax_journal
from sparkrdma_tpu.obs import metrics as jax_metrics
from sparkrdma_tpu.obs import telemetry as jax_telemetry
from sparkrdma_tpu.obs import timeseries as jax_timeseries
from sparkrdma_tpu.resilience import health as jax_health
from sparkrdma_tpu.utils import config as jax_config

from sparkrdma_tpu_torch.obs import export, journal, metrics, telemetry, timeseries
from sparkrdma_tpu_torch.resilience import health
from sparkrdma_tpu_torch.utils import config

JAX = SimpleNamespace(export=jax_export, journal=jax_journal, metrics=jax_metrics,
                      telemetry=jax_telemetry, timeseries=jax_timeseries,
                      health=jax_health, config=jax_config)
PORT = SimpleNamespace(export=export, journal=journal, metrics=metrics,
                       telemetry=telemetry, timeseries=timeseries, health=health,
                       config=config)
BOTH = [JAX, PORT]


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
    """``doc`` less the diagnosis pass's own wall time (``build_ms``, a
    perf_counter reading no clock injection reaches)."""
    if isinstance(doc, dict):
        return {k: _without(v, keys) for k, v in doc.items() if k not in keys}
    if isinstance(doc, list):
        return [_without(v, keys) for v in doc]
    return doc


def _stable_openmetrics(text):
    return "\n".join(ln for ln in text.splitlines()
                     if not ln.startswith("diagnosis_build_ms"))


# ---------------------------------------------------------------------------
# the ring
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("size,interval_ms", [(4, 10), (8, 100), (64, 1000)])
def test_time_series_ring_equal_jax(size, interval_ms):
    rng = np.random.default_rng(size * 31 + interval_ms)
    walls = np.cumsum(rng.integers(0, 2 * interval_ms, size=40))
    out = []
    for mod in BOTH:
        ring = mod.timeseries.TimeSeriesRing(size, interval_ms)
        for seq, wall in enumerate(walls, 1):
            r = np.random.default_rng(seq)
            ring.append(int(wall), seq,
                        counters={"transport.read_bytes": int(r.integers(1, 1 << 20))},
                        gauges={"reader.inflight_bytes": {"value": int(r.integers(9)),
                                                          "hwm": 9}},
                        histograms={"engine.task_ms": {
                            "count": 2, "sum": float(r.uniform(1, 50)),
                            "buckets": {"le_5": int(r.integers(3)), "le_50": 1}}},
                        gap=seq % 7 == 0)
        out.append((ring.to_list(), ring.to_list(last=3), ring.rollup(), ring.rollup(last=2),
                    len(ring), ring.last_wall_ms, ring.last_seq))
    assert out[1] == out[0]
    assert out[1][4] <= size and out[1][6] == 40


# ---------------------------------------------------------------------------
# the hub on synthetic heartbeats
# ---------------------------------------------------------------------------

SCENARIOS = {
    # name: (executors, beats, seed)
    "fold": (3, 4, 1),
    "busy_outlier": (8, 6, 2),
    "work_outlier": (5, 5, 3),
    "two_participants": (2, 5, 4),
    "seq_gap": (4, 6, 5),
    "silence": (4, 8, 6),
    "tenant_outlier": (6, 4, 7),
    "journal_and_profile": (3, 5, 8),
}


def _payloads(scenario):
    """The scenario's heartbeat payloads, in ingest order."""
    n_exec, beats, seed = SCENARIOS[scenario]
    rng = np.random.default_rng(1800 + seed)
    out = []
    for seq in range(1, beats + 1):
        for i in range(n_exec):
            eid = f"exec-{i}"
            if scenario == "silence" and i == 1 and 2 <= seq <= 5:
                continue  # exec-1 goes silent, then resumes
            if scenario == "seq_gap" and i == 2 and seq in (3, 4):
                continue  # two beats lost in transit
            wall = 100_000 + seq * 100 + int(rng.integers(0, 10))
            busy = float(rng.uniform(9.0, 11.0))
            work = int(rng.integers(1 << 20, 1 << 21))
            if i == 3 and scenario in ("busy_outlier", "tenant_outlier"):
                busy *= 30.0
            if i == 1 and scenario == "work_outlier":
                work //= 16
            tenant = ",tenant=t1" if scenario == "tenant_outlier" else ""
            payload = {
                "v": 1, "executor_id": eid, "seq": seq, "wall_ms": wall,
                "interval_ms": 100, "epoch_ms": 99_000 + i,
                "counters": {f"transport.read_bytes{{role={eid}}}": work},
                "gauges": {f"reader.inflight_bytes{{role={eid}}}":
                           {"value": int(rng.integers(0, 4096)), "hwm": 4096}},
                "histograms": {f"engine.task_ms{{kind=map,role={eid}{tenant}}}": {
                    "count": 2, "sum": busy,
                    "buckets": {"le_5": 0, "le_50": 2 if busy < 50 else 0,
                                "le_2000": 0 if busy < 50 else 2}}},
            }
            if scenario == "journal_and_profile":
                payload["journal"] = [{
                    "kind": "circuit.open", "wall_ms": wall, "origin": f"proc-{i}",
                    "role": eid, "executor": "exec-0", "hlc": [wall, 0], "seq": seq}]
                payload["profile"] = {"hz": 19, "rows": [["t", "untraced", "a:b", seq]]}
            out.append(payload)
    return out


def _drive_hub(mod, scenario):
    reg = mod.metrics.MetricsRegistry()
    clock = Clock(100.0)
    healthreg = mod.health.SourceHealthRegistry(mod.config.TpuShuffleConf(), role="drv")
    hub = mod.telemetry.TelemetryHub(role="drv", registry=reg, health=healthreg,
                                     interval_ms=100, ring_size=16, straggler_z=3,
                                     clock=clock)
    try:
        for p in _payloads(scenario):
            clock.t = p["wall_ms"] / 1000.0
            hub.ingest(p)
        hub.ingest({"bogus": True})  # malformed: dropped and counted
        newly = hub.check_missed(now_ms=int(clock.t * 1000) + 1000)
        return {
            "executors": hub.executors(),
            "summary": hub.summary(),
            "report": hub.straggler_report(),
            "timeline": hub.timeline(),
            "timeline_last": hub.timeline(last=2),
            "rollups": hub.rollups(),
            "missed": hub.missed_executors(),
            "newly_missed": newly,
            "anchors": hub.epoch_anchors(),
            "suspects": sorted(healthreg.suspects()),
            "journal": hub.journal.merged(),
            "slo": _without(hub.slo.summary()),
            "capacity": hub.capacity.capacity_report(refresh=False),
            "openmetrics": _stable_openmetrics(hub.render_openmetrics()),
            "profiles": hub.profiles.summary(),
        }
    finally:
        hub.stop()


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_hub_equal_jax_on_synthetic_heartbeats(scenario):
    jax_view, port_view = (_drive_hub(mod, scenario) for mod in BOTH)
    for key in jax_view:
        assert port_view[key] == jax_view[key], key
    n_exec = SCENARIOS[scenario][0]
    assert port_view["executors"] == [f"exec-{i}" for i in range(n_exec)]
    assert "telemetry_bad_payloads_total{role=\"drv\"} 1" in port_view["openmetrics"]
    stragglers = port_view["report"]["stragglers"]
    if scenario in ("busy_outlier", "tenant_outlier"):
        assert stragglers == ["exec-3"]
    elif scenario == "work_outlier":
        assert stragglers == ["exec-1"]
    else:
        assert stragglers == []
    if scenario == "tenant_outlier":
        assert port_view["report"]["suspect_keys"] == ["t1:exec-3"]
    if scenario == "silence":
        # counted once per outage; the resume marks the gap
        assert port_view["summary"]["missed_heartbeats"] >= 1
        assert any(w["gap"] for w in port_view["timeline"]["exec-1"])
    if scenario == "seq_gap":
        assert port_view["summary"]["missed_heartbeats"] >= 2
    if scenario == "journal_and_profile":
        shipped = [e for e in port_view["journal"] if e["kind"] == "circuit.open"]
        assert len(shipped) == 3 * 5
        assert port_view["profiles"] == jax_view["profiles"]


def test_hub_flags_one_busy_outlier_among_eight_into_health():
    view = _drive_hub(PORT, "busy_outlier")
    assert view["suspects"] == ["exec-3"]
    flags = view["report"]["executors"]["exec-3"]["flags"]
    assert flags and flags[0]["kind"] == "busy"
    assert "telemetry_straggler{executor=\"exec-3\",role=\"drv\"} 1" in view["openmetrics"]
    last = [e for e in view["journal"] if e["executor"] == "exec-3"][-1]
    assert last["kind"] == "straggler.flag"


def test_partition_bytes_and_lanes_equal_jax():
    rng = np.random.default_rng(1810)
    ops = [(int(rng.integers(0, 70)), int(rng.integers(0, 8)), int(rng.integers(1, 1 << 20)),
            f"exec-{int(rng.integers(0, 3))}" if k % 3 else "")
           for k in range(400)]
    out = []
    for mod in BOTH:
        hub = mod.telemetry.TelemetryHub(role="drv", registry=mod.metrics.MetricsRegistry(),
                                         clock=Clock(1.0))
        try:
            for sid, pid, nbytes, src in ops:
                hub.record_partition_bytes(sid, pid, nbytes, source=src)
            hub.drop_partition_bytes(ops[-1][0])
            out.append({sid: (hub.partition_bytes(sid), hub.partition_lane_bytes(sid))
                        for sid in range(70)})
        finally:
            hub.stop()
    assert out[1] == out[0]
    assert sum(1 for v in out[1].values() if v[0]) <= 64  # oldest shuffles evicted


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_heartbeats_fold_into_the_other_package_hub(direction):
    """One package's Heartbeater (with its journal attached) feeds both
    packages' hubs; the hubs agree on everything the beats carried."""
    src = JAX if direction == "jax_to_port" else PORT
    reg = src.metrics.MetricsRegistry()
    clock = Clock(500.0)
    j = src.journal.EventJournal("exec-7", origin="proc-7", registry=reg, clock=clock)
    sent = []
    hb = src.telemetry.Heartbeater(reg, "exec-7", interval_ms=100, send=sent.append,
                                   match={"role": "exec-7"}, clock=clock)
    hb.attach_journal(j)
    for k in range(5):
        clock.t += 0.1
        reg.counter("transport.read_bytes", role="exec-7", purpose="data").inc(1000 * k)
        reg.histogram("engine.task_ms", role="exec-7", kind="map",
                      tenant="default").observe(3.0 * k)
        j.emit("quota.block", tenant="t", beat=k)
        hb.beat()
    views = []
    for mod in BOTH:
        hub = mod.telemetry.TelemetryHub(role="drv", registry=mod.metrics.MetricsRegistry(),
                                         interval_ms=100, clock=Clock(clock.t))
        try:
            for p in sent:
                hub.ingest(json.loads(json.dumps(p)))  # over the wire
            views.append((hub.summary(), hub.timeline(), hub.rollups(),
                          hub.journal.merged(), hub.epoch_anchors(),
                          hub.render_openmetrics()))
        finally:
            hub.stop()
    assert views[1] == views[0]
    summary, timeline, rollups, merged = views[1][:4]
    assert summary["executors"]["exec-7"]["last_seq"] == 5
    assert [e["attrs"]["beat"] for e in merged] == [0, 1, 2, 3, 4]
    assert rollups["exec-7"]["counters"][
        "transport.read_bytes{purpose=data,role=exec-7}"] == 10_000


# ---------------------------------------------------------------------------
# egress: OpenMetrics (render, file, HTTP) and the flight recorder
# ---------------------------------------------------------------------------

_SAMPLE_RE = re.compile(
    r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[a-zA-Z_][a-zA-Z0-9_]*="(\\.|[^"\\\n])*"'
    r'(,[a-zA-Z_][a-zA-Z0-9_]*="(\\.|[^"\\\n])*")*\})? \S+$'
)


def _validate_openmetrics(text):
    lines = text.splitlines()
    assert lines[-1] == "# EOF"
    typed = {}
    for ln in lines[:-1]:
        if ln.startswith("# HELP ") or ln.startswith("# TYPE "):
            _, kind, family, rest = ln.split(" ", 3)
            if kind == "TYPE":
                typed[family] = rest
            continue
        assert _SAMPLE_RE.match(ln), ln
        name = ln.split("{", 1)[0].split(" ", 1)[0]
        names = {name} | {name[: -len(s)] for s in ("_total", "_bucket", "_sum", "_count")
                          if name.endswith(s)}
        assert names & typed.keys(), ln
    return typed


def _registry(mod):
    reg = mod.metrics.MetricsRegistry()
    reg.counter("transport.read_bytes", role="exec-0", purpose="data").inc(42)
    reg.counter("telemetry.bad_payloads", role='q " b \\ s').inc()
    reg.gauge("reader.inflight_bytes", role="exec-0").set(7)
    h = reg.histogram("rpc.handle_ms", bounds=(1, 10), role="exec-0")
    for v in (0.5, 5, 100):
        h.observe(v)
    return reg


@pytest.mark.parametrize("extra", [None, {"cluster": "c1"}])
def test_render_and_write_openmetrics_byte_equal_jax(tmp_path, extra):
    texts = []
    for name, mod in (("jax", JAX), ("port", PORT)):
        snap = _registry(mod).snapshot()
        text = mod.export.render_openmetrics(snap, extra)
        path = tmp_path / f"{name}.om"
        assert mod.export.write_openmetrics(str(path), snap, extra) == text
        assert path.read_text() == text
        texts.append(text)
    assert texts[1] == texts[0]
    typed = _validate_openmetrics(texts[1])
    assert typed["rpc_handle_ms"] == "histogram"
    labels = 'cluster="c1",' if extra else ""
    assert f'rpc_handle_ms_bucket{{{labels}le="+Inf",role="exec-0"}} 3' in texts[1]
    assert 'role="q \\" b \\\\ s"' in texts[1]


@pytest.mark.parametrize("shape", ["raw", "registry", "obs_registry", "none"])
def test_extract_snapshot_equal_jax(shape):
    out = []
    for mod in BOTH:
        snap = _registry(mod).snapshot()
        doc = {"raw": snap, "registry": {"registry": snap},
               "obs_registry": {"obs_registry": snap, "x": 1},
               "none": {"workloads": []}}[shape]
        try:
            out.append(mod.export.extract_snapshot(doc))
        except ValueError as e:
            out.append(str(e))
    assert out[1] == out[0]


def test_openmetrics_http_scrape_on_an_ephemeral_port():
    hub = telemetry.TelemetryHub(role="drv", registry=_registry(PORT), clock=Clock(1.0))
    srv = export.OpenMetricsServer(hub.render_openmetrics, port=0)
    try:
        assert srv.port > 0
        with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/metrics",
                                    timeout=10) as resp:
            body = resp.read().decode("utf-8")
            ctype = resp.headers["Content-Type"]
    finally:
        srv.stop()
        hub.stop()
    assert "openmetrics-text" in ctype
    assert body == hub.render_openmetrics()
    assert "transport_read_bytes_total" in body
    _validate_openmetrics(body)


class _FetchFailed(Exception):
    shuffle_id = 3
    partition_id = 5
    manager_id = "exec-1@127.0.0.1:7000"


def test_flight_record_written_to_flight_dir_as_jax(tmp_path):
    docs = []
    for name, mod in (("jax", JAX), ("port", PORT)):
        clock = Clock(100.1)
        flight_dir = tmp_path / name
        flight_dir.mkdir()
        hub = mod.telemetry.TelemetryHub(role="drv", registry=mod.metrics.MetricsRegistry(),
                                         interval_ms=100, flight_dir=str(flight_dir),
                                         flight_windows=2, clock=clock)
        try:
            for p in _payloads("busy_outlier"):
                clock.t = p["wall_ms"] / 1000.0
                hub.ingest(p)
            hub.note_breakdown({"wall_ms": 10.0, "categories": {"dma-wave": 9.0}})
            path = hub.flight_record("fetch-failed", error=_FetchFailed("lost"),
                                     breakdown={"wall_ms": 10.0})
        finally:
            hub.stop()
        assert path is not None and path.startswith(str(flight_dir))
        assert re.fullmatch(r"sparkrdma-flight-\d+-\d+\.json", path.rsplit("/", 1)[1])
        doc = json.loads(open(path).read())
        assert doc == json.loads(json.dumps(hub.last_flight, default=str))
        doc.pop("spans")  # each package's own tracers
        docs.append(_without(doc))
    assert docs[1] == docs[0]
    doc = docs[1]
    assert doc["kind"] == "sparkrdma_flight_record" and doc["reason"] == "fetch-failed"
    assert doc["failed_group"] == {"shuffle_id": 3, "partition_id": 5,
                                   "source": "exec-1@127.0.0.1:7000"}
    assert doc["error"]["type"] == "_FetchFailed"
    assert all(len(w) == 2 for w in doc["executors"].values())
    assert doc["stragglers"]["stragglers"] == ["exec-3"]
    last = [e for e in doc["journal"] if e["executor"] == "exec-3"][-1]
    assert last["kind"] == "straggler.flag"
