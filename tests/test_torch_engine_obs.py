"""The port's job attribution and profiling (``sparkrdma_tpu_torch/obs/``:
``critpath``, ``attr``, ``profiler`` and the ``Heartbeater`` of
``telemetry``) against the JAX package's: the same synthetic span sets
give the same critical paths and breakdowns, the same stacks the same
flamegraph trees and pages, the same registry deltas the same heartbeat
payloads. Nothing here waits on a timer: every sample and every beat is
taken by the test."""

import collections
import threading
import types

import numpy as np
import pytest
import torch

from sparkrdma_tpu.obs import attr as jax_attr
from sparkrdma_tpu.obs import critpath as jax_critpath
from sparkrdma_tpu.obs import metrics as jax_metrics
from sparkrdma_tpu.obs import profiler as jax_profiler
from sparkrdma_tpu.obs import telemetry as jax_telemetry
from sparkrdma_tpu_torch import tenancy
from sparkrdma_tpu_torch.obs import attr, critpath, metrics, profiler, telemetry
from sparkrdma_tpu_torch.obs import trace as port_trace
from sparkrdma_tpu_torch.utils.config import TpuShuffleConf

torch.set_num_threads(1)

PORT = types.SimpleNamespace(attr=attr, critpath=critpath, metrics=metrics,
                             profiler=profiler, telemetry=telemetry)
JAX = types.SimpleNamespace(attr=jax_attr, critpath=jax_critpath, metrics=jax_metrics,
                            profiler=jax_profiler, telemetry=jax_telemetry)
NAMES = sorted(jax_attr.PREFIX_CATEGORIES) + ["user.compute", "shuffle.fetch.group",
                                             "shuffle.collective.wave.3"]


def _span_set(seed, n=40):
    """A seeded span DAG over a 10 s window: names across the attribution
    vocabulary, parents and follows edges to earlier spans, gaps between
    bursts. Rows: (name, role, span_id, parent_id, t0, t1, follows)."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(1, n + 1):
        t0 = float(rng.uniform(0.0, 9.5))
        t1 = min(10.0, t0 + float(rng.exponential(0.8)))
        parent = int(rng.integers(1, i)) if i > 1 and rng.random() < 0.4 else 0
        follows = [int(x) for x in rng.integers(1, i, size=int(rng.integers(0, 3)))] if i > 1 else []
        rows.append((NAMES[int(rng.integers(len(NAMES)))], f"exec-{i % 3}", i, parent,
                     t0, t1, follows))
    return rows


def _pspans(mod, rows):
    return [mod.critpath.PSpan(name, role, sid, pid, t0, t1, follows=list(fl),
                               args={"k": sid})
            for name, role, sid, pid, t0, t1, fl in rows]


def _live_spans(rows):
    """Span-like objects (``obs/trace.py`` ``Span``'s attributes, the
    follows edges as (trace, span) pairs) for ``place_spans``."""
    return [types.SimpleNamespace(name=name, role=role, span_id=sid, parent_id=pid,
                                  start=t0, end=t1, follows=[(7, f) for f in fl],
                                  args={"k": sid})
            for name, role, sid, pid, t0, t1, fl in rows]


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_extract_and_attribute_equal_jax(seed):
    rows = _span_set(seed)
    outs = []
    for mod in (JAX, PORT):
        path = mod.critpath.extract(_pspans(mod, rows), 0.5, 9.5, exclude={3})
        bd = mod.attr.attribute(path)
        outs.append((path.to_dict(), bd.to_dict(), bd.render(),
                     mod.attr.dma_wave_signal(bd)))
    assert outs[1] == outs[0]
    path_dict, bd_dict = outs[1][0], outs[1][1]
    assert path_dict["segments"]
    assert set(bd_dict["categories_ms"]) <= set(attr.CATEGORIES)
    assert sum(bd_dict["categories_ms"].values()) == pytest.approx(bd_dict["wall_ms"], abs=0.05)


def test_place_spans_with_epochs_equal_jax():
    rows = _span_set(5)
    epochs = {"exec-0": 100.0, "exec-2": 250.5}
    placed = []
    for mod in (JAX, PORT):
        ps = mod.critpath.place_spans(_live_spans(rows), epochs)
        placed.append([(p.name, p.role, p.span_id, p.parent_id, p.t0, p.t1, p.follows,
                        p.args) for p in ps])
    assert placed[1] == placed[0]
    assert placed[1][0][4] == rows[0][4] + epochs.get(rows[0][1], 0.0)


def test_job_breakdown_equal_jax(monkeypatch):
    """``job_breakdown`` over a job span's window, with the process
    profiler's gap annotation held off in both packages (what it adds
    depends on live samples): the verdicts are equal, and it publishes
    the verdict and counts the build."""
    rows = _span_set(7)
    job = types.SimpleNamespace(start=1.0, end=9.0, span_id=2)
    builds = metrics.get_registry().counter("critpath.builds", role="t-obs")
    b0 = builds.value
    out = []
    for mod in (JAX, PORT):
        monkeypatch.setattr(mod.profiler, "annotate_gaps", lambda path, top=3: 0)
        bd = mod.critpath.job_breakdown(job, spans=_live_spans(rows), role="t-obs")
        assert mod.attr.last_breakdown() is bd
        out.append(bd.to_dict())
    assert out[1] == out[0]
    assert builds.value == b0 + 1


def test_spans_from_chrome_equal_jax():
    doc = {"traceEvents": [
        {"ph": "M", "name": "process_name", "pid": 1, "args": {"name": "driver"}},
        {"ph": "M", "name": "process_name", "pid": 2, "args": {"name": "exec-0"}},
        {"ph": "X", "name": "job.run", "pid": 1, "ts": 0.0, "dur": 9e6,
         "args": {"span_id": 1}},
        {"ph": "X", "name": "shuffle.fetch", "pid": 2, "ts": 1e6, "dur": 3e6,
         "args": {"span_id": 2, "parent_span": 1}},
        {"ph": "X", "name": "reader.pipeline.decode", "pid": 2, "ts": 4e6, "dur": 2e6,
         "args": {"span_id": 3}},
        {"ph": "X", "name": "foreign", "pid": 2, "ts": 0.0, "dur": 1.0, "args": {}},
        {"ph": "s", "cat": "critpath", "name": "critpath", "pid": 2, "ts": 4e6,
         "args": {"from_span": 2, "to_span": 3}},
    ]}
    out = []
    for mod in (JAX, PORT):
        spans = mod.critpath.spans_from_chrome(doc)
        path = mod.critpath.extract(spans, 0.0, 9.0, exclude={1})
        out.append(([(s.name, s.role, s.span_id, s.parent_id, s.t0, s.t1, s.follows)
                     for s in spans], mod.attr.attribute(path).to_dict()))
    assert out[1] == out[0]
    assert out[1][0][2][6] == [2]


@pytest.mark.parametrize("name", NAMES)
def test_classify_equal_jax(name):
    assert attr.classify(name) == jax_attr.classify(name)


def _stacks(seed, n=60):
    rng = np.random.default_rng(seed)
    frames = [f"mod{i}:fn{j}" for i in range(4) for j in range(3)]
    return [([frames[int(f)] for f in rng.integers(0, len(frames), int(rng.integers(1, 6)))],
             int(rng.integers(1, 20))) for _ in range(n)]


@pytest.mark.parametrize("seed", [0, 1])
def test_flamegraph_tree_and_page_equal_jax(seed):
    stacks = _stacks(seed)
    tree = profiler._fold_tree(stacks)
    assert tree == jax_profiler._fold_tree(stacks)
    assert tree["v"] == sum(n for _, n in stacks)
    page = profiler.render_flamegraph_html(stacks, title="a <b> profile")
    assert page == jax_profiler.render_flamegraph_html(stacks, title="a <b> profile")
    assert "a &lt;b&gt; profile" in page and "http" not in page


def _hub_views(mod, stacks):
    hub = mod.profiler.ProfileHub(max_stacks=50, clock=lambda: 12.5)
    for i, (frames, n) in enumerate(stacks):
        rows = [["alice" if i % 2 else "bob", "host-read" if i % 3 else "untraced",
                 ";".join(frames), n]]
        hub.ingest(f"exec-{i % 3}", {"hz": 19 + i % 2, "rows": rows},
                   wall_ms=None if i % 4 else 1000.0 + i)
    hub.ingest("exec-9", None)
    return (hub.merged_rows(), hub.folded(), hub.folded(tags=False),
            hub.category_self_ms(), hub.last_windows(top_rows=3), hub.summary(),
            hub.executors(), hub.total_samples, hub.dropped,
            hub.flamegraph_html(title="cluster"))


def test_profile_hub_equal_jax():
    """The driver-side merge over the same heartbeat tables, past its
    stack cap (so drops count too)."""
    stacks = _stacks(3, n=80)
    views = _hub_views(PORT, stacks)
    assert views == _hub_views(JAX, stacks)
    assert views[8] > 0  # the cap dropped some samples


def test_frames_between_and_annotate_gaps_equal_jax(monkeypatch):
    """Gap annotation over the same recent-sample ring: the dominant leaf
    frames inside each gap segment, none on a span segment."""
    rows = [(1.0 + 0.01 * i, "t", "untraced", f"a:root;b:mid;c:leaf{i % 4}") for i in range(100)]
    out = []
    for mod in (JAX, PORT):
        p = mod.profiler.SamplingProfiler(mod.metrics.MetricsRegistry(), role="t", hz=50)
        p._recent.extend(rows)
        monkeypatch.setattr(mod.profiler, "_proc_profiler", p)
        path = mod.critpath.CriticalPath(1.0, 2.0, [
            mod.critpath.Seg("gap", "", "", 0, 1.2, 1.5),
            mod.critpath.Seg("span", "x", "r", 5, 1.5, 2.0)])
        annotated = mod.profiler.annotate_gaps(path, top=2)
        out.append((p.frames_between(1.1, 1.6, top=2), p.frames_between(3.0, 2.0),
                    annotated, [s.to_dict() for s in path.segments]))
    assert out[1] == out[0]
    leaves = collections.Counter(st.rsplit(";", 1)[-1] for t, _, _, st in rows if 1.2 <= t <= 1.5)
    want = sorted(leaves.items(), key=lambda kv: (-kv[1], kv[0]))[:2]
    assert out[1][2] == 1
    assert out[1][3][0]["frames"] == [list(kv) for kv in want]
    assert "frames" not in out[1][3][1]


def test_sampler_tags_span_category_and_tenant():
    """One synchronous sample of a thread parked inside an open
    ``shuffle.fetch`` span under a tenant scope: the row carries the
    tenant and the span's category, and the table drains once."""
    reg = metrics.MetricsRegistry()
    p = profiler.SamplingProfiler(reg, role="t1", hz=50)
    stop, ready = threading.Event(), threading.Event()

    def parked():
        with tenancy.tenant_scope("alice"):
            with port_trace.get_tracer("t1-tracer").span("shuffle.fetch.parked"):
                ready.set()
                stop.wait(10.0)

    port_trace.set_span_watch(True)
    t = threading.Thread(target=parked, daemon=True)
    try:
        t.start()
        assert ready.wait(10.0)
        assert p.sample_once() > 0
    finally:
        stop.set()
        t.join(10.0)
        port_trace.set_span_watch(False)
    assert not t.is_alive()
    profile = p.drain()
    assert profile["hz"] == 50
    tagged = [r for r in profile["rows"] if r[0] == "alice" and "parked" in r[2]]
    assert tagged and tagged[0][1] == attr.HOST_READ
    assert p.drain() is None
    assert reg.counter("profile.samples", role="t1").value > 0


def test_acquire_profiler_is_refcounted():
    conf = TpuShuffleConf({"tpu.shuffle.obs.profile.enabled": "true",
                           "tpu.shuffle.obs.profile.hz": "7"})
    a = profiler.acquire_profiler(conf, role="ref-a")
    b = profiler.acquire_profiler(conf, role="ref-b")
    try:
        assert a is b and a.running and a.hz == 7
        assert profiler.get_profiler() is a
    finally:
        profiler.release_profiler(b)
    assert a.running
    profiler.release_profiler(a)
    assert not a.running and profiler.get_profiler() is None
    off = TpuShuffleConf({"tpu.shuffle.obs.profile.enabled": "false"})
    assert profiler.acquire_profiler(off) is None


def _beats(mod):
    """Two beats and a drained outbox off one registry's deltas."""
    reg = mod.metrics.MetricsRegistry()
    sent = []
    hb = mod.telemetry.Heartbeater(reg, "exec-0", interval_ms=250, send=sent.append,
                                   match={"role": "exec-0"}, clock=lambda: 1234.5)
    reg.counter("critpath.builds", role="exec-0").inc(3)
    reg.counter("critpath.builds", role="exec-1").inc(5)  # another role: filtered out
    for v in (0.5, 3.0, 40.0, 7000.0):
        reg.histogram("engine.task_ms", role="exec-0", kind="map", tenant="t").observe(v)
    reg.gauge("profile.stacks", role="exec-0").set(9)
    hb.beat()
    reg.counter("critpath.builds", role="exec-0").inc()
    reg.histogram("engine.task_ms", role="exec-0", kind="reduce", tenant="t").observe(12.0)
    reg.gauge("profile.stacks", role="exec-0").set(0)
    hb.beat()
    hb.pause()
    assert hb.beat() is None
    hb.resume()
    outbox = mod.telemetry.Heartbeater(reg, "exec-0", interval_ms=250,
                                       match={"role": "exec-0"}, clock=lambda: 99.0)
    reg.counter("critpath.builds", role="exec-0").inc(2)
    outbox.beat()
    outbox.beat()
    drained = outbox.drain()
    assert outbox.drain() == []
    for payload in sent + drained:
        assert isinstance(payload.pop("epoch_ms"), int)
    return sent, drained


def test_heartbeat_payloads_equal_jax():
    sent, drained = _beats(PORT)
    assert (sent, drained) == _beats(JAX)
    assert [p["seq"] for p in sent] == [1, 2]
    assert sent[0]["counters"] == {"critpath.builds{role=exec-0}": 3}
    assert sent[1]["counters"] == {"critpath.builds{role=exec-0}": 1}
    assert drained[0]["counters"] == {"critpath.builds{role=exec-0}": 2}
    assert drained[1]["counters"] == {}
    assert "journal" not in sent[0]


def test_heartbeat_ships_an_attached_journal_and_profile():
    """With a journal attached (in place of the process journal) each
    beat carries the new events and the previous beat's again, and
    a profiler's drained table rides the payload, as in JAX."""
    class Journal:
        def __init__(self):
            self.events = []

        def events_since(self, cursor):
            return [e for e in self.events if e["seq"] > cursor]

    out = []
    for mod in (JAX, PORT):
        reg = mod.metrics.MetricsRegistry()
        prof = mod.profiler.SamplingProfiler(reg, role="exec-3", hz=19)
        prof._fold[("t", "untraced", "a:b")] = 4
        hb = mod.telemetry.Heartbeater(reg, "exec-3", send=lambda p: None,
                                       clock=lambda: 5.0, profiler=prof)
        j = Journal()
        hb.attach_journal(j)
        j.events += [{"seq": 1, "e": "a"}, {"seq": 2, "e": "b"}]
        first = hb.beat()
        j.events += [{"seq": 3, "e": "c"}]
        second = hb.beat()
        out.append((first["journal"], second["journal"], first.get("profile"),
                    second.get("profile")))
    assert out[1] == out[0]
    assert [e["seq"] for e in out[1][1]] == [1, 2, 3]
    assert out[1][2] == {"hz": 19, "rows": [["t", "untraced", "a:b", 4]]}
    assert out[1][3] is None


@pytest.mark.parametrize("values", [[1.0, 2.0, 3.0, 50.0], [4.0, 4.0, 4.0], [0.0, 0.0]])
def test_robust_z_and_hist_payload_equal_jax(values):
    assert telemetry._robust_z(values[-1], values) == jax_telemetry._robust_z(values[-1], values)
    h = {"count": 3, "sum": 7.5, "buckets": {"le_1": 0, "le_2": 3}, "min": 1.0}
    assert telemetry._hist_payload(h) == jax_telemetry._hist_payload(h)
    assert telemetry._hist_payload({"count": 0, "sum": 0.0}) == {"count": 0, "sum": 0.0}
