"""The telemetry and journal plane wired into the port's engine and
shuffle path, end to end on the CPU: the driver's ``TelemetryHub`` under
``TpuContext`` and ``ClusterContext``, the journal across a
``driver:kill`` failover, the flight record of a failed job, and the
wave tuner's ``autotune.adjust`` event and breakdown gate held against
the JAX package's. No test waits on a fixed sleep: the in-process hub
is fed by ``telemetry_flush()``, and the cluster's poll loop is waited
for with a deadline of seconds."""

import dataclasses
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from sparkrdma_tpu import locations as jloc
from sparkrdma_tpu.obs import attr as jax_attr
from sparkrdma_tpu.obs import journal as jax_journal
from sparkrdma_tpu.obs import metrics as jax_metrics
from sparkrdma_tpu.ops.hbm_arena import DeviceBufferManager as JaxArena
from sparkrdma_tpu.shuffle import device_fetch as jdf
from sparkrdma_tpu.shuffle.autotune import WaveAutoTuner as JaxTuner
from sparkrdma_tpu.shuffle.autotune import WaveReport as JaxReport
from sparkrdma_tpu.shuffle.collective import ShuffleScheduleCompiler as JaxCompiler
from sparkrdma_tpu.utils.config import TpuShuffleConf as JaxConf

from sparkrdma_tpu_torch.convert import from_jax_state
from sparkrdma_tpu_torch.engine.cluster import ClusterContext
from sparkrdma_tpu_torch.engine.context import TpuContext
from sparkrdma_tpu_torch.obs import attr, journal
from sparkrdma_tpu_torch.obs.diagnose import build_diagnosis
from sparkrdma_tpu_torch.obs.telemetry import TelemetryHub
from sparkrdma_tpu_torch.ops.hbm_arena import DeviceBufferManager as TorchArena
from sparkrdma_tpu_torch.shuffle import device_fetch as tdf
from sparkrdma_tpu_torch.shuffle.autotune import MIN_DMA_WAVE_FRACTION, WaveAutoTuner, WaveReport
from sparkrdma_tpu_torch.shuffle.collective import ShuffleScheduleCompiler
from sparkrdma_tpu_torch.shuffle.errors import FetchFailedError, ShuffleError
from sparkrdma_tpu_torch.testing import faults
from sparkrdma_tpu_torch.utils.config import TpuShuffleConf

PYTHON = {"tpu.shuffle.transport": "python"}


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
    for mod in (jax_journal, journal):
        mod.reset()
    yield
    for mod in (jax_journal, journal):
        mod.reset()


def _heartbeat_threads():
    return {t for t in threading.enumerate() if t.name.startswith("heartbeat-")}


# ---------------------------------------------------------------------------
# the in-process engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("enabled", [True, False])
def test_driver_builds_a_hub_only_with_telemetry_enabled(enabled):
    before = _heartbeat_threads()
    conf = TpuShuffleConf(dict(PYTHON, **{
        "tpu.shuffle.obs.telemetry.enabled": str(enabled).lower()}))
    with TpuContext(num_executors=2, conf=conf) as ctx:
        hub = ctx.driver.telemetry
        assert isinstance(hub, TelemetryHub) if enabled else hub is None
        assert len(ctx.heartbeaters) == (2 if enabled else 0)
        snap = ctx.metrics_snapshot()
        assert ("telemetry" in snap["driver"]) is enabled and ("slo" in snap) is enabled
        assert all(e.telemetry is None for e in ctx.executors)
    assert _heartbeat_threads() == before  # stop() joined every heartbeater


def test_context_job_fills_the_hub_and_the_planner_bytes():
    conf = TpuShuffleConf(dict(PYTHON))
    with TpuContext(num_executors=2, conf=conf) as ctx:
        data = [(f"k{i % 37}", 1) for i in range(4000)]
        out = dict(ctx.parallelize(data, 6).reduce_by_key(lambda a, b: a + b, 4).collect())
        assert sum(out.values()) == 4000
        ctx.telemetry_flush()
        hub = ctx.driver.telemetry
        execs = sorted(e.executor_id for e in ctx.executors)
        assert hub.executors() == execs
        assert all(len(hub.series(e)) >= 1 for e in execs)
        snap = ctx.metrics_snapshot()
        summary = snap["driver"]["telemetry"]
        assert set(summary["executors"]) == set(execs)
        assert summary["missed_heartbeats"] == 0
        assert snap["slo"]["objectives"] >= 2
        # the executors' engine.task_ms crossed into the rings
        roll = hub.rollups()
        assert any(k.startswith("engine.task_ms") for e in roll
                   for k in roll[e]["histograms"])
        # the hub is the planner's per-partition byte source (JAX manager
        # partition_sizes): the shuffle's published bytes were recorded
        assert hub.partition_bytes(0) or hub.partition_bytes(1)
        assert hub.journal.summary()["events"] == len(hub.journal.merged())


def test_driver_kill_journal_orders_kill_takeover_adopt(tmp_path):
    """The merged journal's HLC order reproduces driver.kill ->
    meta.takeover -> meta.adopt; the flight record attaches the events
    and the diagnosis cites them."""
    conf = TpuShuffleConf(dict(PYTHON, **{
        "tpu.shuffle.faultPlan": "driver:kill:1:stage=reduce_phase"}))
    try:
        with TpuContext(num_executors=2, conf=conf) as ctx:
            data = [(f"k-{i % 53}", 1) for i in range(3000)]
            out = dict(ctx.parallelize(data, 6).reduce_by_key(lambda a, b: a + b).collect())
            assert sum(out.values()) == 3000
            ctx.telemetry_flush()
            hub = ctx.driver.telemetry
            merged = hub.journal.merged()
            flight = hub.flight_record("journal-e2e", path=str(tmp_path / "flight.json"))
            diag = build_diagnosis(hub, {"objective": "task-p99", "kind": "latency",
                                         "severity": "page",
                                         "wall_ms": merged[-1]["wall_ms"] + 1})
    finally:
        faults.uninstall()
    kinds = [e["kind"] for e in merged]
    ki = kinds.index("driver.kill")
    ti = next(i for i in range(ki + 1, len(kinds)) if kinds[i] == "meta.takeover")
    ai = next(i for i in range(ti + 1, len(kinds)) if kinds[i] == "meta.adopt")
    assert ki < ti < ai
    keys = [journal.sort_key(e) for e in merged]
    assert keys == sorted(keys)
    assert flight == str(tmp_path / "flight.json")
    doc = json.loads((tmp_path / "flight.json").read_text())
    assert any(e["kind"] == "driver.kill" for e in journal.extract_events(doc))
    assert doc["capacity"]["binding"] is not None
    cited = [c for c in diag["causes"]
             if c["detail"].get("events") or c["detail"].get("journal_events")]
    assert any(c["cause"] == "dead-metastore-peer" for c in cited), diag["causes"]


def test_failed_job_writes_a_flight_record_naming_the_failed_group(tmp_path):
    conf = TpuShuffleConf(dict(PYTHON, **{
        "tpu.shuffle.resilience.maxFetchAttempts": "2",
        "tpu.shuffle.resilience.retryBackoffMs": "5",
        "tpu.shuffle.obs.telemetry.flightDir": str(tmp_path),
    }))
    with faults.installed("read:fail:0"):
        with TpuContext(num_executors=2, conf=conf) as ctx:
            data = [(f"k{i % 10}", 1) for i in range(200)]
            with pytest.raises(ShuffleError):
                ctx.parallelize(data, 4).reduce_by_key(lambda a, b: a + b).collect()
            path = ctx.driver.telemetry.last_flight_path
    assert path is not None and path.startswith(str(tmp_path))
    doc = json.loads(open(path).read())
    assert doc["kind"] == "sparkrdma_flight_record"
    assert doc["error"]["type"] == FetchFailedError.__name__
    failed = doc["failed_group"]
    assert failed["shuffle_id"] >= 0 and "partition_id" in failed and "source" in failed
    assert {"executors", "source_health", "stragglers", "slo", "journal"} <= set(doc)


# ---------------------------------------------------------------------------
# worker processes: the poll loop and the workers' journals
# ---------------------------------------------------------------------------

def _make_pairs(i):
    def fn():
        return iter([(f"k{j % 20}", 1) for j in range(i * 300, (i + 1) * 300)])

    return fn


def _sum_values():
    def red(it):
        return sum(v for _, v in it)

    return red


def test_cluster_poll_builds_every_series_and_ships_worker_events():
    """Two workers: the driver's poll loop builds a series for each
    within a deadline, and the workers' own journal events reach the
    driver's merged journal. Each worker's first READ fails once (a
    transient fault); with a one-failure breaker that opens the circuit,
    the retry's half-open trial succeeds and closes it, and the job
    completes."""
    conf = TpuShuffleConf(dict(PYTHON, **{
        "tpu.shuffle.obs.telemetry.intervalMs": "50",
        "tpu.shuffle.faultPlan": "read:fail:1",
        "tpu.shuffle.resilience.circuitFailureThreshold": "1",
        "tpu.shuffle.resilience.circuitOpenMs": "1",
        "tpu.shuffle.resilience.retryBackoffMs": "5",
    }))
    try:
        with ClusterContext(num_executors=2, conf=conf) as cc:
            res = cc.run_map_reduce([_make_pairs(i) for i in range(4)], num_partitions=4,
                                    reduce_fn=_sum_values())
            assert sum(res) == 1200
            poll = _wait_for_worker_events(cc)
        assert not poll.is_alive()  # stop() joined the poll loop
    finally:
        faults.uninstall()


def _wait_for_worker_events(cc):
    hub = cc.driver.telemetry
    deadline = time.monotonic() + 20
    while time.monotonic() < deadline:
        worker_events = [e for e in hub.journal.merged()
                         if e.get("role", "").startswith("proc-exec")]
        if (len(hub.executors()) == 2
                and all(len(hub.series(e)) >= 2 for e in hub.executors())
                and worker_events):
            break
        time.sleep(0.05)
    assert hub.executors() == ["proc-exec-0", "proc-exec-1"]
    assert all(len(hub.series(e)) >= 2 for e in hub.executors())
    assert worker_events and {e["kind"] for e in worker_events} <= {
        "circuit.open", "circuit.half_open", "circuit.close"}
    # emitted in the worker processes, not in the driver's
    assert f"proc-{os.getpid()}" not in {e["origin"] for e in worker_events}
    poll = cc._telemetry_thread
    assert poll is not None and poll.is_alive()
    return poll


# ---------------------------------------------------------------------------
# the wave tuner: the autotune.adjust event and the breakdown gate
# ---------------------------------------------------------------------------

BLOCK = 64 << 10
EXECS = ["at-0", "at-1", "at-2"]


@pytest.fixture()
def staged():
    """Three executors stage one block per partition in JAX arenas; the
    port's arenas are built from a snapshot of them."""
    rng = np.random.default_rng(2000)
    jarenas = {e: JaxArena() for e in EXECS}
    jlocs, state = [], {}
    for k, e in enumerate(EXECS):
        for p in range(3):
            data = rng.integers(0, 256, BLOCK + 4 * (3 * k + p), np.uint8)
            buf = jarenas[e].stage_view(data, data.nbytes, np.uint32)
            jlocs.append(jloc.PartitionLocation(
                jloc.ShuffleManagerId("host", 1, e), p,
                jloc.BlockLocation(0, data.nbytes, 100 + 3 * k + p, device_coords=0,
                                   arena_handle=buf.handle)))
        state[e] = [(h, np.asarray(b.array), b.length) for h, b in jarenas[e]._handles.items()]
    tarenas, tlocs = from_jax_state(state, [dataclasses.asdict(x) for x in jlocs],
                                    device="cpu")
    red_j, red_t = JaxArena(), TorchArena("cpu")
    for e in EXECS:
        jdf.register_arena(e, jarenas[e])
        tdf.register_arena(e, tarenas[e])
    try:
        yield jlocs, tlocs, red_j, red_t
    finally:
        for e in EXECS:
            jdf.unregister_arena(e, jarenas[e])
            tdf.unregister_arena(e, tarenas[e])


def _adjusts(mod):
    return [(e["kind"], e["role"], e["attrs"]) for e in mod.active_journal().events()
            if e["kind"] == "autotune.adjust"]


def _breakdown(mod, fraction, gap_frames=None):
    return mod.TimeBreakdown(100.0, {mod.DMA_WAVE: 100.0 * fraction, "compute": 50.0},
                             0.9, [], gap_frames or {})


@pytest.mark.parametrize("fraction", [None, 0.01, 0.5])
def test_two_identical_stages_emit_the_same_autotune_adjust_as_jax(staged, monkeypatch,
                                                                  fraction):
    """Two identical device-path stages on the CPU plain path (the
    compiler's kernel branch with the wave pull's plain version): the
    first re-cuts the shape and emits ``autotune.adjust``, as the JAX
    compiler does; a breakdown whose dma-wave share is below
    ``MIN_DMA_WAVE_FRACTION`` vetoes it in both."""
    jlocs, tlocs, red_j, red_t = staged
    monkeypatch.setattr(ShuffleScheduleCompiler, "_kernel_path", lambda self: True)
    for mod in (jax_attr, attr):
        monkeypatch.setattr(mod, "_last_breakdown",
                            None if fraction is None else _breakdown(mod, fraction))
    knobs = {"tpu.shuffle.collective.waveBytes": "4m"}
    out = []
    for jmod, compiler, locs in ((jax_journal, JaxCompiler(JaxConf(knobs), red_j, "at-red"),
                                  jlocs),
                                 (journal, ShuffleScheduleCompiler(TpuShuffleConf(knobs),
                                                                   red_t, "at-red"), tlocs)):
        jmod.configure(role="driver", origin="proc-at")
        for _ in range(2):
            plan = compiler.plan(locs, np.uint32)
            results, degraded = compiler.execute(7, plan, np.uint32)
            assert degraded == []
            for r in results:
                r.dev.free()
        out.append(_adjusts(jmod))
    assert out[1] == out[0]
    if fraction == 0.01:
        assert out[1] == []
    else:
        assert len(out[1]) == 1
        kind, role, fields = out[1][0]
        assert role == "at-red" and fields["prev"] == 0 and fields["waves"] == 1
        assert fields["wave_bytes"] < (4 << 20)


@pytest.mark.parametrize("fraction,gaps,allows", [
    (None, None, True), (0.0, None, False), (MIN_DMA_WAVE_FRACTION / 2, None, False),
    (MIN_DMA_WAVE_FRACTION, None, True), (0.01, {"jax:device_put": 4}, True),
    (0.01, {"numpy:sort": 9}, False)])
def test_breakdown_gate_vetoes_where_jax_does(monkeypatch, fraction, gaps, allows):
    out = []
    for amod, jmod, tuner_cls, report_cls, conf in (
            (jax_attr, jax_journal, JaxTuner, JaxReport, JaxConf()),
            (attr, journal, WaveAutoTuner, WaveReport, TpuShuffleConf())):
        monkeypatch.setattr(amod, "_last_breakdown",
                            None if fraction is None else _breakdown(amod, fraction, gaps))
        jmod.configure(role="driver", origin="proc-gate")
        tuner = tuner_cls(conf, "gate-exec")
        sig = ("a2a", 3, 1, 2, "uint32")
        tuner.observe(sig, report_cls(stage_bytes=64 << 20, min_group_bytes=1 << 20, waves=1,
                                      depth=2, dispatch_ms=0.1, wave_ms=1.0, overlap_ms=0.0))
        out.append((tuner._breakdown_allows(), tuner.wave_bytes_for(sig), _adjusts(jmod)))
    assert out[1] == out[0]
    assert out[1][0] is allows
    assert (out[1][1] is not None) is allows and len(out[1][2]) == int(allows)


def test_chip_smoke_hub_alone_phase_on_the_cpu(monkeypatch):
    """``chip_smoke.py`` phase 16 (a) at a small size: the hub flags only
    the busy outlier, and the 8-process journal merges in ``sort_key``
    order without duplicates or gaps (the phase raises otherwise)."""
    import chip_smoke

    monkeypatch.setattr(chip_smoke, "OBS_BEATS", 40)
    monkeypatch.setattr(chip_smoke, "OBS_JOURNAL_EVENTS", 800)
    out = chip_smoke._obs_hub_alone()
    assert out["stragglers"] == [f"obs-exec-{chip_smoke.OBS_OUTLIER}"]
    assert out["ingests"] == 8 * 40 and out["windows_each"] == [40]
    assert out["journal"]["events"] == 800 and out["journal"]["duplicates"] > 0
    assert out["openmetrics_bytes"] > 0

