"""The port's cluster event journal (``obs/journal.py``) against the JAX
package's: HLC ticks and merges, the bounded process journal, the
driver's ``JournalHub`` merge (replay, one lost beat, gaps), the
exports (Chrome instants, artifact extraction, the timeline), and each
control-plane call site that emits into it. Every comparison runs the
same inputs through both packages under an injected clock; the
process-global journal of each package is reset around every test."""

import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from sparkrdma_tpu.obs import journal as jax_journal
from sparkrdma_tpu.obs import metrics as jax_metrics
from sparkrdma_tpu.obs import telemetry as jax_telemetry
from sparkrdma_tpu.obs import trace as jax_trace
from sparkrdma_tpu.resilience import health as jax_health
from sparkrdma_tpu.tenancy import admission as jax_admission
from sparkrdma_tpu.tenancy import quota as jax_quota
from sparkrdma_tpu.metastore import store as jax_store
from sparkrdma_tpu.utils import config as jax_config

from sparkrdma_tpu_torch.obs import journal, metrics, telemetry, trace
from sparkrdma_tpu_torch.resilience import health
from sparkrdma_tpu_torch.tenancy import admission, quota
from sparkrdma_tpu_torch.metastore import store
from sparkrdma_tpu_torch.utils import config

JAX = SimpleNamespace(journal=jax_journal, metrics=jax_metrics,
                      telemetry=jax_telemetry, trace=jax_trace,
                      health=jax_health, admission=jax_admission,
                      quota=jax_quota, store=jax_store, config=jax_config)
PORT = SimpleNamespace(journal=journal, metrics=metrics, telemetry=telemetry,
                       trace=trace, health=health, admission=admission,
                       quota=quota, store=store, config=config)
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
    """An injected wall clock (seconds) that tests step by hand."""

    def __init__(self, t: float = 1000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


def _journal_counters(reg) -> dict:
    snap = reg.snapshot()
    return {k: v for k, v in snap["counters"].items() if k.startswith("journal.")}


# ---------------------------------------------------------------------------
# HLC and the process journal
# ---------------------------------------------------------------------------

HLC_SCRIPTS = {
    "monotonic": [("tick", 100), ("tick", 100), ("tick", 99), ("tick", 101)],
    "remote_ahead": [("tick", 300), ("observe", (500, 2), 300), ("tick", 300),
                     ("tick", 501)],
    "tie": [("tick", 400), ("observe", (400, 7), 400), ("observe", (400, 1), 399),
            ("tick", 400), ("observe", (200, 0), 450)],
}


@pytest.mark.parametrize("script", sorted(HLC_SCRIPTS))
def test_hlc_tick_and_observe_equal_jax(script):
    out = []
    for mod in BOTH:
        clock = mod.journal.HLC()
        got = []
        for op in HLC_SCRIPTS[script]:
            if op[0] == "tick":
                got.append(clock.tick(op[1]))
            else:
                got.append(clock.observe(op[1], op[2]))
        got.append(clock.read())
        out.append(got)
    assert out[1] == out[0]
    assert out[1] == sorted(out[1])  # never backward


@pytest.mark.parametrize("ring_size", [8, 16, 512])
def test_event_journal_ring_bound_and_events_since_equal_jax(ring_size):
    rng = np.random.default_rng(1700 + ring_size)
    walls = np.cumsum(rng.integers(0, 3, size=100)) + 5000
    out = []
    for mod in BOTH:
        reg = mod.metrics.MetricsRegistry()
        clock = Clock()
        j = mod.journal.EventJournal("exec-1", origin="proc-a", ring_size=ring_size,
                                     registry=reg, clock=clock)
        for k, wall in enumerate(walls):
            clock.t = int(wall) / 1000.0
            j.emit("autotune.adjust", executor="exec-1", beat=k,
                   shuffle_id=k % 3 - 1, tenant="t" if k % 4 == 0 else "")
        out.append((j.events(), j.events(last=5), j.events_since(90),
                    j.events_since(0)[:3], j.seq, _journal_counters(reg)))
    assert out[1] == out[0]
    events = out[1][0]
    assert len(events) == max(8, ring_size if ring_size < 100 else 100)
    assert events[-1]["seq"] == 100  # the newest survive
    # a cursor older than the ring yields what survived
    assert [e["seq"] for e in out[1][2]] == list(range(max(91, 101 - len(events)), 101))


def test_configure_disable_and_set_enabled_equal_jax():
    out = []
    for mod in BOTH:
        conf = mod.config.TpuShuffleConf({"tpu.shuffle.obs.journal.enabled": "false"})
        reg = mod.metrics.MetricsRegistry()
        clock = Clock(2.0)
        steps = [mod.journal.configure(conf, role="proc"), mod.journal.active_journal(),
                 mod.journal.emit("quota.block", tenant="t")]
        with pytest.raises(RuntimeError):
            mod.journal.get_journal()
        j = mod.journal.configure(role="proc", registry=reg, clock=clock)
        j.emit("circuit.open")
        mod.journal.set_enabled(False)
        steps.append(mod.journal.emit("circuit.close"))  # swallowed
        mod.journal.set_enabled(True)
        steps.append(mod.journal.emit("circuit.close"))
        assert mod.journal.active_journal() is j  # the same object restored
        assert mod.journal.configure(role="other") is j  # idempotent
        steps.append(j.events())
        out.append(steps)
    assert out[1] == out[0]
    assert out[1][:3] == [None, None, None]
    assert out[1][4]["seq"] == 2


def test_heartbeat_payload_omits_journal_when_disabled():
    out = []
    for mod in BOTH:
        mod.journal.configure(enabled=False)
        reg = mod.metrics.MetricsRegistry()
        got = []
        hb = mod.telemetry.Heartbeater(reg, "e0", interval_ms=50, send=got.append,
                                       clock=Clock())
        reg.counter("engine.stage_recomputes", role="e0").inc()
        hb.beat()
        out.append("journal" in got[0])
    assert out == [False, False]


# ---------------------------------------------------------------------------
# the driver's merge: heartbeat shipping, replay, lost beats, gaps
# ---------------------------------------------------------------------------

def _ship(mod, lost, replay):
    """Ten beats of a journal that emits one to three events a beat; the
    hub ingests every payload not in ``lost`` (twice with ``replay``)."""
    reg = mod.metrics.MetricsRegistry()
    clock = Clock(50.0)
    j = mod.journal.EventJournal("exec-0", origin="proc-x", ring_size=64,
                                 registry=reg, clock=clock)
    got = []
    hb = mod.telemetry.Heartbeater(reg, "exec-0", interval_ms=100, send=got.append,
                                   clock=clock)
    hb.attach_journal(j)
    for k in range(10):
        j.emit("admission.enqueue", tenant="t", queue_depth=k)
        if k % 3 == 0:
            j.emit("quota.block", tenant="t", resource="mempool", bytes=k)
            j.emit("circuit.open", executor=f"exec-{k % 2}")
        clock.t += 0.1
        hb.beat()
    hub = mod.journal.JournalHub(reg, role="drv", ring_size=256, clock=clock)
    fresh = []
    for i, payload in enumerate(got):
        if i in lost:
            continue
        fresh.append(hub.ingest(payload.get("journal", [])))
        if replay:
            fresh.append(hub.ingest(list(reversed(payload.get("journal", [])))))
    return (hub.merged(), hub.summary(), fresh, _journal_counters(reg),
            [p.get("journal") for p in got], hub.merged(kinds=["quota.block"]),
            hub.merged(last=3, since_wall_ms=50_300, until_wall_ms=50_800))


@pytest.mark.parametrize("lost,replay", [((), False), ((), True), ((4,), False),
                                         ((4, 5), False), ((0, 4, 8), True)])
def test_journal_hub_merge_equal_jax(lost, replay):
    out = [_ship(mod, lost, replay) for mod in BOTH]
    assert out[1] == out[0]
    merged, summary = out[1][0], out[1][1]
    keys = [journal.sort_key(e) for e in merged]
    assert keys == sorted(keys) and len(set(keys)) == len(keys)
    if (4, 5) != lost:
        # one-beat redundancy: an isolated lost beat loses nothing
        assert [e["seq"] for e in merged] == list(range(1, 19))
        assert summary["gaps"] == 0
    else:
        assert summary["gaps"] > 0  # two lost in a row: counted, not fatal
    if replay:
        assert summary["duplicates"] > 0


def test_concurrent_emitters_merge_to_total_order():
    """Three journals, four threads each, batches shipped while they
    emit: the port's merged journal is totally ordered, keeps each
    emitter's seq order and loses or duplicates nothing."""
    reg = metrics.MetricsRegistry()
    hub = journal.JournalHub(reg, ring_size=1 << 14)
    journals = [journal.EventJournal(f"exec-{i}", origin=f"proc-{i}",
                                     ring_size=1 << 12, registry=reg)
                for i in range(3)]

    def emitter(j, t):
        cursor = 0
        for k in range(50):
            j.emit("autotune.adjust", executor=j.role, beat=k, thread=t)
            if k % 7 == 0:
                batch = j.events_since(cursor)
                if batch:
                    cursor = batch[-1]["seq"]
                    hub.ingest(batch)

    threads = [threading.Thread(target=emitter, args=(j, t))
               for j in journals for t in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=30)
        assert not th.is_alive()
    for j in journals:
        hub.ingest(j.events())
    merged = hub.merged()
    keys = [journal.sort_key(e) for e in merged]
    assert len(merged) == 600 and keys == sorted(keys) and len(set(keys)) == 600
    for i in range(3):
        seqs = [e["seq"] for e in merged if e["origin"] == f"proc-{i}"]
        assert seqs == list(range(1, 201))


def test_hub_ingest_folds_causality_into_local_clock():
    """A driver event emitted after ingesting a batch from an executor
    whose wall clock runs far ahead still sorts after that batch."""
    out = []
    for mod in BOTH:
        reg = mod.metrics.MetricsRegistry()
        remote = mod.journal.EventJournal("exec-9", origin="proc-9", registry=reg,
                                          clock=lambda: 10_000_000_000.0)
        local = mod.journal.configure(role="driver", origin="proc-drv",
                                      registry=reg, clock=Clock(5.0))
        hub = mod.journal.JournalHub(reg, clock=Clock(5.0))
        hub.ingest([remote.emit("circuit.open", executor="exec-9")])
        after = local.emit("slo.page")
        out.append((after, hub.merged()))
    assert out[1] == out[0]
    after, merged = out[1]
    assert journal.sort_key(after) > journal.sort_key(merged[0])
    assert [e["kind"] for e in merged] == ["circuit.open", "slo.page"]


# ---------------------------------------------------------------------------
# exports
# ---------------------------------------------------------------------------

def _events(mod):
    reg = mod.metrics.MetricsRegistry()
    clock = Clock(7.0)
    j = mod.journal.EventJournal("drv", origin="p", registry=reg, clock=clock)
    evs = []
    for kind, kw in [("meta.takeover", {"executor": "e0", "peer": "meta-1"}),
                     ("quota.block", {"tenant": "hog", "shuffle_id": 3, "bytes": 512}),
                     ("slo.page", {"span_id": 77}),
                     ("straggler.flag", {"executor": "e2", "shuffle_id": 0})]:
        clock.t += 0.005
        evs.append(j.emit(kind, **kw))
    return evs


ARTIFACTS = {
    "list": lambda ev: ev,
    "flight": lambda ev: {"kind": "sparkrdma_flight_record", "journal": ev},
    "nested": lambda ev: {"journal": {"events": ev}},
    "slo": lambda ev: {"slo": {"journal": ev}},
    "events": lambda ev: {"events": ev + [{"no": "kind"}]},
    "nothing": lambda ev: {"nothing": 1},
    "scalar": lambda ev: 42,
}


@pytest.mark.parametrize("shape", sorted(ARTIFACTS))
def test_extract_events_equal_jax(shape):
    out = [mod.journal.extract_events(ARTIFACTS[shape](_events(mod))) for mod in BOTH]
    assert out[1] == out[0]
    assert len(out[1]) == (0 if shape in ("nothing", "scalar") else 4)


def test_events_to_chrome_and_render_timeline_equal_jax():
    out = []
    for mod in BOTH:
        ev = _events(mod)
        out.append((mod.journal.events_to_chrome(list(reversed(ev)), pid=3),
                    mod.journal.render_timeline(ev), mod.journal.render_timeline(ev, limit=2),
                    mod.journal.render_timeline([])))
    assert out[1] == out[0]
    instants, text = out[1][0], out[1][1]
    assert [i["name"] for i in instants] == ["meta.takeover", "quota.block", "slo.page",
                                             "straggler.flag"]
    assert instants[0]["ts"] == 7005 * 1000 and instants[0]["ph"] == "i"
    assert "4 events" in text and "tenant=hog" in text


def test_to_chrome_trace_carries_journal_instants_as_jax():
    out = []
    for mod in BOTH:
        doc = mod.trace.to_chrome_trace(tracers=[], journal_events=_events(mod))
        out.append(doc)
    assert out[1] == out[0]
    instants = [e for e in out[1]["traceEvents"] if e.get("ph") == "i"]
    assert len(instants) == 4
    meta = [e for e in out[1]["traceEvents"] if e.get("ph") == "M"]
    assert meta[-1]["args"]["name"] == "journal"


# ---------------------------------------------------------------------------
# the call sites that emit (formerly inert seams in the port)
# ---------------------------------------------------------------------------

def _armed(mod):
    reg = mod.metrics.MetricsRegistry()
    return mod.journal.configure(role="driver", origin="proc-t", registry=reg,
                                 clock=Clock(9.0))


def _kinds(mod):
    return [(e["kind"], e.get("executor", ""), e.get("tenant", ""))
            for e in mod.journal.active_journal().events()]


def test_circuit_trip_half_open_and_close_emit_as_jax():
    out = []
    for mod in BOTH:
        _armed(mod)
        conf = mod.config.TpuShuffleConf({"tpu.shuffle.resilience.circuitOpenMs": "1"})
        reg = mod.health.SourceHealthRegistry(conf, role="drv")
        for _ in range(3):
            reg.record_failure("exec-4")
        time.sleep(0.01)
        assert reg.allow("exec-4")  # the half-open trial
        reg.record_success("exec-4")
        out.append(mod.journal.active_journal().events())
    assert out[1] == out[0]
    assert [e["kind"] for e in out[1]] == ["circuit.open", "circuit.half_open",
                                           "circuit.close"]
    assert {e["executor"] for e in out[1]} == {"exec-4"}


def test_quota_block_overrun_and_release_emit_as_jax():
    out = []
    for mod in BOTH:
        _armed(mod)
        mod.quota.reset()
        conf = mod.config.TpuShuffleConf({
            "tpu.shuffle.tenancy.quota.hog.mempoolBytes": "1k",
            "tpu.shuffle.tenancy.quotaBlockMaxMs": "20",
        })
        try:
            mod.quota.install(conf)
            broker = mod.quota.broker("mempool")
            broker.charge("hog", 1024)
            broker.charge("hog", 512)  # blocks, then overruns after 20 ms
            broker.release("hog", 1536)
            out.append([(e["kind"], e["tenant"], e["attrs"]["resource"],
                         e["attrs"]["bytes"])
                        for e in mod.journal.active_journal().events()])
        finally:
            mod.quota.reset()
    assert out[1] == out[0]
    assert [k for k, *_ in out[1]] == ["quota.block", "quota.overrun", "quota.release"]


def test_admission_enqueue_and_deadline_emit_as_jax():
    out = []
    for mod in BOTH:
        _armed(mod)
        ctl = mod.admission.AdmissionController(1, 10, role="drv")
        ctl.acquire("tenant-a")
        with pytest.raises(mod.admission.AdmissionTimeout):
            ctl.acquire("tenant-b", timeout_ms=10)
        ctl.release()
        out.append([(e["kind"], e["tenant"]) for e in mod.journal.active_journal().events()])
    assert out[1] == out[0]
    assert out[1] == [("admission.enqueue", "tenant-b"), ("admission.deadline", "tenant-b")]


def test_metastore_peer_kill_and_wipe_emit_as_jax():
    out = []
    for mod in BOTH:
        _armed(mod)
        conf = mod.config.TpuShuffleConf({"tpu.shuffle.metastore.peers": "3"})
        ms = mod.store.ShardedMetaStore(conf, role="drv", clock=Clock(3.0))
        ms.kill_peer("meta-1")
        ms.wipe()
        out.append(mod.journal.active_journal().events())
    assert out[1] == out[0]
    kinds = [e["kind"] for e in out[1]]
    assert kinds[:2] == ["meta.peer_kill", "meta.epoch_bump"]
    assert set(kinds[2:]) == {"meta.takeover"}
