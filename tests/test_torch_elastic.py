"""The port's elastic plane (``sparkrdma_tpu_torch/elastic/``: map-output
replication and the shuffle-service daemon) against the JAX package's.

The counterparts of every test of ``tests/test_elastic.py`` and of
``tests/test_metastore.py::test_driver_kill_then_exec_kill_readopts_replicas_zero_recompute``:
each job runs from the same closures through both packages' engines
(real worker processes, killed mid-job), and the port's merged output
equals the JAX package's and plain Python's, while its ``elastic.*``
counters move as the JAX package's do. The wire, fault-grammar, quota
and health cases feed both packages the same inputs and compare what
comes out. One more case holds what the replica registry promises: a
replica never serves while its primary lives.

Every test that starts workers or a daemon runs under its own deadline
(``_deadline``). Executor losses wait out
``partitionLocationFetchTimeoutMs``, set to 2 s in both packages. The
JAX ``driver:kill`` rig keeps a race the port's rig waits out
(``engine/context.py`` ``await_published_maps``), so the chaos bar's
JAX half runs the executor kill alone. Map and reduce functions come
from factories, so cloudpickle ships them by value."""

import collections
import contextlib
import json
import os
import signal
import socket
import subprocess
import sys
import time

import pytest
import torch

from sparkrdma_tpu import locations as jloc
from sparkrdma_tpu import rpc as jrpc
from sparkrdma_tpu.elastic import replication as jax_replication
from sparkrdma_tpu.engine.cluster import ClusterContext as JaxCluster
from sparkrdma_tpu.engine.context import TpuContext as JaxContext
from sparkrdma_tpu.obs import get_registry as jax_registry
from sparkrdma_tpu.obs import journal as jax_journal
from sparkrdma_tpu.resilience.health import SourceHealthRegistry as JaxHealth
from sparkrdma_tpu.shuffle import handle as jhandle
from sparkrdma_tpu.shuffle.manager import TpuShuffleManager as JaxManager
from sparkrdma_tpu.tenancy import quota as jax_quota
from sparkrdma_tpu.testing import faults as jfaults
from sparkrdma_tpu.utils.config import TpuShuffleConf as JaxConf

from sparkrdma_tpu_torch import locations as tloc
from sparkrdma_tpu_torch import rpc as trpc
from sparkrdma_tpu_torch.elastic import replication
from sparkrdma_tpu_torch.engine.cluster import ClusterContext
from sparkrdma_tpu_torch.engine.context import TpuContext
from sparkrdma_tpu_torch.obs import get_registry, journal
from sparkrdma_tpu_torch.resilience.health import SourceHealthRegistry
from sparkrdma_tpu_torch.shuffle import handle as thandle
from sparkrdma_tpu_torch.shuffle.manager import TpuShuffleManager
from sparkrdma_tpu_torch.tenancy import quota
from sparkrdma_tpu_torch.testing import faults
from sparkrdma_tpu_torch.utils.config import TpuShuffleConf

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORDS = ["tpu", "shuffle", "rdma", "mesh", "ici", "dcn"]
# an executor loss defers the survivors' location fetches twice by this
LOSS = {"tpu.shuffle.partitionLocationFetchTimeoutMs": "2000"}
KILL_REDUCE = "exec:kill:1:peer=proc-exec-1,stage=reduce_task"
CLUSTER_S = 120


class _Pkg:
    """One package's entry points, so each case is written once."""

    def __init__(self, name, conf, cluster, context, registry, fault_mod, service):
        self.name, self.conf, self.cluster, self.context = name, conf, cluster, context
        self.registry, self.faults, self.service = registry, fault_mod, service


JAX = _Pkg("jax", JaxConf, JaxCluster, JaxContext, jax_registry, jfaults,
           "sparkrdma_tpu.elastic.service")
PORT = _Pkg("port", TpuShuffleConf, ClusterContext, TpuContext, get_registry, faults,
            "sparkrdma_tpu_torch.elastic.service")
BOTH = (JAX, PORT)


@pytest.fixture(autouse=True, scope="module")
def _process_state_left_clean():
    """The JAX code run here counts into the JAX package's process
    registry, which later test files in this worker read: zero it when
    the module ends. Both packages' journals and replica store
    registries are process-wide too."""
    for mod in (jax_journal, journal):
        mod.reset()
    yield
    for mod in (jax_journal, journal):
        mod.reset()
    for mod in (jax_replication, replication):
        with mod._stores_lock:
            mod._stores.clear()
    jax_registry().reset()


@contextlib.contextmanager
def _deadline(seconds):
    """Fail the test (``TimeoutError``) if its block runs longer than
    ``seconds``; the contexts' ``__exit__`` then stop their workers."""
    def expired(signum, frame):
        raise TimeoutError(f"the test ran over its {seconds} s deadline")

    old = signal.signal(signal.SIGALRM, expired)
    signal.setitimer(signal.ITIMER_REAL, seconds)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old)


# the workers are ``python -m <package>.engine.worker``: they find both
# packages from the checkout root, whatever the test's working directory
os.environ["PYTHONPATH"] = os.pathsep.join(
    [ROOT] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p])


def _make_map(seed, n=600):
    def fn():
        for i in range(n):
            yield (WORDS[(seed * 7 + i) % len(WORDS)], 1)

    return fn


def _counts_reducer():
    def red(it):
        acc = collections.Counter()
        for k, v in it:
            acc[k] += v
        return dict(acc)

    return red


def _expected(num_maps, n=600):
    expected = collections.Counter()
    for s in range(num_maps):
        for i in range(n):
            expected[WORDS[(s * 7 + i) % len(WORDS)]] += 1
    return expected


def _merged(parts):
    merged = collections.Counter()
    for p in parts:
        merged.update(p)
    return merged


def _collector():
    def collect(it):
        return sorted(it)

    return collect


def _counters(pkg, names):
    reg = pkg.registry()
    return {name: reg.counter(name, **labels).value for name, labels in names.items()}


def _moved(pkg, before, names):
    now = _counters(pkg, names)
    return {k: now[k] - before[k] for k in names}


DRIVER_ELASTIC = {
    "elastic.recomputed_maps": {"role": "driver"},
    "elastic.recoveries": {"role": "driver"},
    "elastic.replica_promotions": {"role": "driver"},
    "elastic.speculations": {"role": "driver"},
    "elastic.speculation_wins": {"role": "driver"},
    "metastore.adoptions": {"role": "driver"},
    "engine.stage_recomputes": {},
}


def _cluster_job(pkg, knobs, num_executors=3, num_maps=6, num_partitions=6, probe=None):
    """One map-reduce through ``pkg``'s ``ClusterContext``; returns the
    merged counts and the driver's counter deltas over the job (read
    before the context stops: the workers' exits are peer losses too)."""
    before = _counters(pkg, DRIVER_ELASTIC)
    try:
        with pkg.cluster(num_executors=num_executors, conf=pkg.conf(dict(knobs))) as cc:
            parts = cc.run_map_reduce(
                [_make_map(s) for s in range(num_maps)], num_partitions=num_partitions,
                reduce_fn=_counts_reducer(),
            )
            moved = _moved(pkg, before, DRIVER_ELASTIC)
            seen = probe(cc) if probe is not None else None
    finally:
        pkg.faults.uninstall()
    return _merged(parts), moved, seen


# ----------------------------------------------------------------------
# chaos: executor kill mid-reduce -> lineage recompute of ITS maps only
# ----------------------------------------------------------------------
def test_exec_kill_mid_reduce_recomputes_only_lost_maps():
    """proc-exec-1 is hard-killed at its first reduce task. Both
    packages finish with the same counts, re-run exactly the two maps
    exec-1 owned (maps 1 and 4 of 6 over 3 workers) in one recovery, and
    prune the dead worker."""
    knobs = {"tpu.shuffle.faultPlan": KILL_REDUCE, **LOSS}
    got = {}
    with _deadline(2 * CLUSTER_S):
        for pkg in BOTH:
            got[pkg.name] = _cluster_job(pkg, knobs, probe=lambda cc: len(cc.workers))
    (want, jd, jw), (merged, pd, pw) = got["jax"], got["port"]
    assert merged == want == _expected(6)
    assert pw == jw == 2
    for name in ("elastic.recomputed_maps", "elastic.recoveries", "engine.stage_recomputes",
                 "elastic.replica_promotions"):
        assert pd[name] == jd[name], name
    assert (pd["elastic.recomputed_maps"], pd["elastic.recoveries"],
            pd["engine.stage_recomputes"]) == (2, 1, 1)


# ----------------------------------------------------------------------
# chaos: same kill, but replicas cover the loss -> ZERO recompute
# ----------------------------------------------------------------------
def test_exec_kill_with_replication_skips_recompute():
    """With ``elastic.replicas=1`` every map output is mirrored to the
    next peer in the ring; the same kill recomputes nothing in either
    package, and both promote exec-1's replicas."""
    knobs = {"tpu.shuffle.faultPlan": KILL_REDUCE, "tpu.shuffle.elastic.replicas": "1",
             **LOSS}
    got = {}
    with _deadline(2 * CLUSTER_S):
        for pkg in BOTH:
            got[pkg.name] = _cluster_job(pkg, knobs)
    (want, jd, _), (merged, pd, _) = got["jax"], got["port"]
    assert merged == want == _expected(6)
    assert pd["elastic.recomputed_maps"] == jd["elastic.recomputed_maps"] == 0
    assert pd["engine.stage_recomputes"] == jd["engine.stage_recomputes"] == 0
    assert pd["elastic.replica_promotions"] > 0 and jd["elastic.replica_promotions"] > 0


# ----------------------------------------------------------------------
# speculation: the delayed executor gets flagged and its range cloned
# ----------------------------------------------------------------------
def test_speculation_clones_flagged_straggler():
    """proc-exec-2 is slowed at one map and wedged for 2.5 s at its
    reduce. With speculation on, both drivers flag exactly that
    executor, clone its range onto a healthy peer and take the clone's
    result."""
    knobs = {
        "tpu.shuffle.faultPlan": (
            "stage:delay:1:peer=proc-exec-2,stage=map_task,delay_ms=1200;"
            "stage:delay:1:peer=proc-exec-2,stage=reduce_task,delay_ms=2500"
        ),
        "tpu.shuffle.elastic.speculation": "true",
        "tpu.shuffle.elastic.speculationCheckMs": "100",
        "tpu.shuffle.obs.telemetry.intervalMs": "100",
        "tpu.shuffle.obs.telemetry.stragglerZ": "1",
    }

    def report(cc):
        rep = cc.driver.telemetry.straggler_report()
        return sorted(rep["stragglers"]), sorted(rep["suspect_keys"])

    got = {}
    with _deadline(2 * CLUSTER_S):
        for pkg in BOTH:
            got[pkg.name] = _cluster_job(pkg, knobs, num_executors=4, num_maps=8,
                                         num_partitions=4, probe=report)
    (want, jd, jrep), (merged, pd, prep) = got["jax"], got["port"]
    assert merged == want == _expected(8)
    for rep in (jrep, prep):
        assert "proc-exec-2" in rep[0] and "proc-exec-2" in rep[1]
    for d in (jd, pd):
        assert d["elastic.speculations"] > 0 and d["elastic.speculation_wins"] > 0


# ----------------------------------------------------------------------
# shuffle-service daemon: handoff, then survive the executor's death
# ----------------------------------------------------------------------
def _service_run(pkg):
    """The JAX test's rig through ``pkg``: a detached daemon adopts
    proc-exec-0's map outputs; while the executor lives the daemon is
    invisible; after a SIGKILL the survivor reads the same bytes from
    the daemon. Returns what it observed."""
    mod = __import__(pkg.service, fromlist=["_recv_obj"])

    def svc_request(port, obj):
        with socket.create_connection(("127.0.0.1", port), timeout=10) as s:
            s.settimeout(10)
            mod._send_obj(s, obj)
            return mod._recv_obj(s)

    seen = {}
    svc = None
    try:
        with pkg.cluster(num_executors=2, conf=pkg.conf(dict(LOSS))) as cc:
            handlemod = jhandle if pkg is JAX else thandle
            handle = handlemod.BaseShuffleHandle(
                shuffle_id=cc._next_shuffle_id(), num_maps=4,
                partitioner=handlemod.HashPartitioner(4),
            )
            cc.driver.register_shuffle(handle)
            items = list(enumerate(_make_map(s, n=300) for s in range(4)))
            cc._run_map_phase(handle, items, "default", recompute=False)
            owners = cc.driver.map_owners(handle.shuffle_id)

            def read_all(worker):
                return worker.request({
                    "kind": "reduce", "handle": handle, "start": 0, "end": 4,
                    "reduce_fn": _collector(), "tenant": "default",
                })

            seen["baseline"] = read_all(cc.workers[1])
            svc = subprocess.Popen(
                [sys.executable, "-m", pkg.service, "--service-id", f"svc-{pkg.name}",
                 "--conf", json.dumps(cc.conf.to_dict())],
                stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
            )
            port = None
            while port is None:
                line = svc.stdout.readline()
                if not line:
                    raise RuntimeError("service daemon exited before announcing")
                if line.startswith("SERVICE_PORT "):
                    port = int(line.split()[1])
            seen["ping"] = svc_request(port, {"kind": "ping"})["result"]
            seen["adopted"] = cc.workers[0].request(
                {"kind": "handoff", "service": ("127.0.0.1", port)})
            seen["exec0_maps"] = sorted(m for m, e in owners.items() if e == "proc-exec-0")
            seen["parked"] = read_all(cc.workers[1])
            w0 = cc.workers[0]
            w0.proc.kill()
            w0.proc.wait(timeout=10)
            seen["dead"] = [w.executor_id for w in cc._reap_dead()]
            seen["from_daemon"] = read_all(cc.workers[0])
            seen["stopped"] = svc_request(port, {"kind": "stop"})["ok"]
            svc.wait(timeout=15)
            seen["daemon_exit"] = svc.returncode
            svc = None
    finally:
        if svc is not None:
            svc.kill()
            svc.wait(timeout=10)
    return seen


def test_shuffle_service_handoff_survives_executor_kill():
    """``python -m sparkrdma_tpu_torch.elastic.service`` adopts
    proc-exec-0's two maps; the survivor's reads before the handoff,
    after it and after the kill are the same records, in both
    packages, and the same as the JAX package's."""
    with _deadline(2 * CLUSTER_S):
        want = _service_run(JAX)
        got = _service_run(PORT)
    assert len(want["baseline"]) == 4 * 300
    for seen in (want, got):
        assert seen["ping"] == "pong"
        assert seen["adopted"] == len(seen["exec0_maps"]) == 2
        assert seen["parked"] == seen["baseline"]
        assert seen["dead"] == ["proc-exec-0"]
        assert seen["from_daemon"] == seen["baseline"]
        assert seen["stopped"] and seen["daemon_exit"] == 0
    assert got["baseline"] == want["baseline"]
    assert got["exec0_maps"] == want["exec0_maps"]


# ----------------------------------------------------------------------
# fault grammar: the exec seam
# ----------------------------------------------------------------------
@pytest.mark.parametrize("spec", [
    "exec:kill:1:peer=proc-exec-1,stage=reduce_task",
    "exec:hang:2:delay_ms=50",
])
def test_exec_fault_rule_parse(spec):
    want = jfaults.FaultRule.parse(spec)
    got = faults.FaultRule.parse(spec)
    for field in ("op", "kind", "count", "peer", "stage", "delay_ms"):
        assert getattr(got, field) == getattr(want, field), field
    with pytest.raises(ValueError):
        faults.FaultRule.parse("exec:explode:1")
    with pytest.raises(ValueError):
        jfaults.FaultRule.parse("exec:explode:1")


def test_exec_hang_blocks_for_delay():
    plan = faults.FaultPlan.parse("exec:hang:1:delay_ms=30")
    t0 = time.perf_counter()
    plan.on_exec("exec-0", stage="map_task")
    assert time.perf_counter() - t0 >= 0.025
    assert plan.injected_count("exec", "hang") == 1
    # budget exhausted: the next entry sails through instantly
    t0 = time.perf_counter()
    plan.on_exec("exec-0", stage="map_task")
    assert time.perf_counter() - t0 < 0.02
    jplan = jfaults.FaultPlan.parse("exec:hang:1:delay_ms=1")
    jplan.on_exec("exec-0", stage="map_task")
    jplan.on_exec("exec-0", stage="map_task")
    assert jplan.injected_count("exec", "hang") == plan.injected_count("exec", "hang")


def test_exec_kill_filters_never_fire_off_target():
    """A kill rule scoped by peer/stage does not fire elsewhere (if it
    did, this process would be dead), in either package."""
    for mod in (jfaults, faults):
        plan = mod.FaultPlan.parse("exec:kill:1:peer=proc-exec-9,stage=reduce_task")
        plan.on_exec("proc-exec-1", stage="reduce_task")  # wrong peer
        plan.on_exec("proc-exec-9", stage="map_task")  # wrong stage
        assert plan.injected_count("exec", "kill") == 0
        plan2 = mod.FaultPlan.parse("read:fail:1")
        plan2.on_exec("proc-exec-1", stage="map_task")
        assert plan2.total_injected == 0


# ----------------------------------------------------------------------
# page-cache quota ledger (mapped zero-copy fetches)
# ----------------------------------------------------------------------
def test_pagecache_quota_broker_install_and_ledger():
    seen = {}
    for name, mod, conf in (("jax", jax_quota, JaxConf), ("port", quota, TpuShuffleConf)):
        mod.reset()
        try:
            mod.install(conf())
            unconfigured = mod.broker("pagecache")
            mod.reset()
            mod.install(conf({"tpu.shuffle.tenancy.pageCacheQuotaBytes": "1m"}))
            b = mod.broker("pagecache")
            b.charge("tenant-a", 512 * 1024)
            charged = b.usage("tenant-a")
            b.release("tenant-a", 512 * 1024)
            seen[name] = (unconfigured, charged, b.usage("tenant-a"))
        finally:
            mod.reset()
    assert seen["port"] == seen["jax"] == (None, 512 * 1024, 0)


# ----------------------------------------------------------------------
# wire: the elastic trailing extension
# ----------------------------------------------------------------------
def _loc(mod, pid, length, mkey, replica_of="", source_map=-1, eid="e"):
    return mod.PartitionLocation(
        mod.ShuffleManagerId("host", 1234, eid), pid,
        mod.BlockLocation(0, length, mkey, replica_of=replica_of, source_map=source_map),
    )


def _segments(locmod, rpcmod, sid, locs, seg, **kw):
    return rpcmod.PublishPartitionLocationsMsg(sid, -1, locs, **kw).to_segments(seg)


def test_publish_msg_elastic_extension_roundtrip():
    args = [(0, 100, 7, "proc-exec-1", 3, "svc"), (1, 200, 8, "", -1, "e")]
    segs = {}
    for name, locmod, rpcmod in (("jax", jloc, jrpc), ("port", tloc, trpc)):
        locs = [_loc(locmod, *a) for a in args]
        segs[name] = _segments(locmod, rpcmod, 5, locs, 4096, trace_id=0xE1A)
    assert segs["port"] == segs["jax"]
    out = [trpc.RpcMsg.parse_segment(s) for s in segs["jax"]]
    got = sorted((loc for m in out for loc in m.locations), key=lambda x: x.partition_id)
    assert got[0].block.replica_of == "proc-exec-1"
    assert got[0].block.source_map == 3
    assert got[0].block.is_replica
    assert not got[1].block.is_replica and got[1].block.source_map == -1
    assert all(m.trace_id == 0xE1A for m in out)


def test_publish_msg_without_elastic_tags_is_byte_identical_legacy():
    locs = [_loc(tloc, 0, 64, 3), _loc(tloc, 1, 64, 4)]
    baseline = [
        tloc.PartitionLocation(
            loc.manager_id, loc.partition_id,
            tloc.BlockLocation(loc.block.address, loc.block.length, loc.block.mkey),
        )
        for loc in locs
    ]
    tagged = _segments(tloc, trpc, 2, locs, 4096)
    assert tagged == _segments(tloc, trpc, 2, baseline, 4096)
    assert tagged == _segments(jloc, jrpc, 2, [_loc(jloc, 0, 64, 3), _loc(jloc, 1, 64, 4)],
                               4096)


def test_publish_msg_elastic_ext_survives_segmentation():
    """Replica identities stay attached to their location across segment
    splits, and the port's segments are the JAX package's bytes."""
    def locs(mod):
        return [_loc(mod, i, 10 + i, 100 + i, replica_of=f"proc-exec-{i % 4}",
                     source_map=i, eid="svc") for i in range(40)]

    segments = _segments(tloc, trpc, 9, locs(tloc), 256)
    assert len(segments) > 1
    assert segments == _segments(jloc, jrpc, 9, locs(jloc), 256)
    got = []
    for seg in segments:
        got.extend(trpc.RpcMsg.parse_segment(seg).locations)
    assert len(got) == 40
    for i, loc in enumerate(sorted(got, key=lambda x: x.partition_id)):
        assert loc.block.replica_of == f"proc-exec-{i % 4}"
        assert loc.block.source_map == i


# ----------------------------------------------------------------------
# advisory plumbing: tenant-scoped suspect keys
# ----------------------------------------------------------------------
def test_health_registry_applies_suspect_keys():
    reports = [
        {"suspect_keys": ["proc-exec-2", "team-b:proc-exec-3"],
         "stragglers": ["ignored-when-keys-present"], "generated_wall_ms": 1},
        {"stragglers": ["proc-exec-4"]},
        {"suspect_keys": []},
    ]
    seen = {}
    for name, cls, conf in (("jax", JaxHealth, JaxConf), ("port", SourceHealthRegistry,
                                                          TpuShuffleConf)):
        reg = cls(conf(), role="t")
        trail = []
        for rep in reports:
            reg.apply_straggler_report(rep)
            trail.append((sorted(reg.suspects()), reg.allow("proc-exec-2")))
        seen[name] = trail
    assert seen["port"] == seen["jax"]
    assert seen["port"] == [(["proc-exec-2", "team-b:proc-exec-3"], True),
                            (["proc-exec-4"], True), ([], True)]


# ----------------------------------------------------------------------
# in-process engine: executor loss behind the partition router
# ----------------------------------------------------------------------
def test_inprocess_context_survives_executor_loss_with_replication():
    """``TpuContext.lose_executor`` with ring replication on: the re-read
    of the same materialized shuffle equals the first, with zero stage
    recomputes and promoted replicas, in both packages."""
    words = [WORDS[i % 6] for i in range(3000)]
    seen = {}
    for pkg in BOTH:
        ctx = pkg.context(num_executors=3, conf=pkg.conf({"tpu.shuffle.elastic.replicas": "1"}))
        try:
            rdd = (ctx.parallelize(words, 6).map(lambda w: (w, 1))
                   .reduce_by_key(lambda a, b: a + b))
            first = dict(rdd.collect())
            reg = pkg.registry()
            recomputes = reg.counter("engine.stage_recomputes")
            promos = reg.counter("elastic.replica_promotions", role=ctx.driver.executor_id)
            r0, p0 = recomputes.value, promos.value
            ctx.lose_executor(ctx.executors[1].executor_id)
            again = dict(rdd.collect())
            seen[pkg.name] = (first, again, len(ctx.executors), recomputes.value - r0,
                              promos.value - p0)
        finally:
            ctx.stop()
    want = dict(collections.Counter(words))
    for first, again, n_exec, recomputed, promoted in seen.values():
        assert first == again == want
        assert n_exec == 2 and recomputed == 0 and promoted > 0
    assert seen["port"][4] == seen["jax"][4]


# ----------------------------------------------------------------------
# the chaos bar: hub wiped, then an executor killed mid-reduce
# ----------------------------------------------------------------------
def test_driver_kill_then_exec_kill_readopts_replicas_zero_recompute():
    """``driver:kill`` at reduce-phase entry, then proc-exec-1 killed at
    its first reduce, with ``elastic.replicas=1``: the port's
    re-adoption sweep restores the parked replica lineage, so the loss
    promotes replicas and recomputes nothing, and the counts equal the
    JAX package's run of the same job under the executor kill."""
    port_knobs = {"tpu.shuffle.faultPlan": f"driver:kill:1:stage=reduce_phase;{KILL_REDUCE}",
                  "tpu.shuffle.elastic.replicas": "1", **LOSS}
    jax_knobs = {"tpu.shuffle.faultPlan": KILL_REDUCE, "tpu.shuffle.elastic.replicas": "1",
                 **LOSS}
    with _deadline(2 * CLUSTER_S):
        want, jd, _ = _cluster_job(JAX, jax_knobs)
        merged, pd, _ = _cluster_job(PORT, port_knobs)
    assert merged == want == _expected(6)
    assert pd["metastore.adoptions"] > 0
    assert pd["elastic.replica_promotions"] > 0 and jd["elastic.replica_promotions"] > 0
    assert pd["elastic.recomputed_maps"] == jd["elastic.recomputed_maps"] == 0


# ----------------------------------------------------------------------
# the replica registry: parked while the primary lives
# ----------------------------------------------------------------------
def _replica_view(pkg, handlemod, manager_cls):
    """A driver and three executors in process, ``elastic.replicas=1``:
    each executor writes one map; the fetch replies before and after
    exec-1's loss, and the records read after it."""
    conf = pkg.conf({"tpu.shuffle.elastic.replicas": "1", "tpu.shuffle.transport": "python",
                     "tpu.shuffle.shuffleWriteMethod": "wrapper",
                     "tpu.shuffle.obs.telemetry.enabled": "false"})
    driver = manager_cls(conf, is_driver=True)
    execs = [manager_cls(conf, is_driver=False, executor_id=f"exec-{i}") for i in range(3)]
    try:
        handle = handlemod.BaseShuffleHandle(shuffle_id=0, num_maps=3,
                                             partitioner=handlemod.HashPartitioner(4))
        driver.register_shuffle(handle)
        for map_id, ex in enumerate(execs):
            w = ex.get_writer(handle, map_id)
            w.write(iter([(f"k{map_id}-{i}", i) for i in range(200)]))
            w.stop(True)
        for ex in execs:
            ex.finalize_maps(0)

        def reply():
            locs = execs[0].fetch_remote_partition_locations(0, 0, 4).result(timeout=30)
            return sorted((loc.partition_id, loc.manager_id.executor_id, loc.block.length,
                           loc.block.replica_of, loc.block.source_map) for loc in locs)

        before = reply()
        with driver._lock:
            parked = sum(len(v) for v in driver._replica_locations.get(0, {}).values())
        driver._on_peer_lost("exec-1")
        after = reply()
        records = sorted(kv for kv in execs[0].get_reader(handle, 0, 4).read())
        return before, parked, after, records
    finally:
        for m in execs + [driver]:
            m.stop()


def test_replica_never_serves_while_its_primary_lives():
    with _deadline(CLUSTER_S):
        want = _replica_view(JAX, jhandle, JaxManager)
        got = _replica_view(PORT, thandle, TpuShuffleManager)
    before, parked, after, records = got
    assert got == want
    # three maps, each mirrored to the next executor in the ring, parked
    assert parked > 0
    assert before and not any(replica_of for _, _, _, replica_of, _ in before)
    # exec-1's own blocks are gone; its replica on exec-2 now serves
    assert not any(eid == "exec-1" for _, eid, _, _, _ in after)
    promoted = [row for row in after if row[3]]
    assert promoted and all(row[3] == "exec-1" and row[1] == "exec-2" and row[4] == 1
                            for row in promoted)
    assert records == sorted((f"k{m}-{i}", i) for m in range(3) for i in range(200))


# ----------------------------------------------------------------------
# chip_smoke.py phase 17's own checks, at a small size
# ----------------------------------------------------------------------
def test_chip_smoke_expected_records_and_their_check(monkeypatch):
    """Phase 17's byte-for-byte check at 3,200 records: the reducers'
    digests of the records they read equal numpy's from ``np.sort`` of the
    generator's keys; one flipped record, a reducer's partition read
    twice, or one missing fails it."""
    import hashlib

    import chip_smoke

    n = 3_200
    rows, bounds = chip_smoke._el_expected(n)
    per = n // chip_smoke.EN_MAPS
    recs = sorted((k, v) for m in range(chip_smoke.EN_MAPS)
                  for k, v in chip_smoke._el_map_fn(chip_smoke.EN_MAP_SEED + m, m, per)())
    fn = chip_smoke._el_digest_fn(chip_smoke.EN_EDGES, ())
    half = chip_smoke.EN_EDGES[3]
    parts = [fn(iter([r for r in recs if r[0] < half])), fn(iter([r for r in recs if r[0] >= half]))]
    chip_smoke._el_check(parts, (rows, bounds), "small")
    assert parts[0]["parts"] == [0, 1, 2, 3] and parts[1]["parts"] == [4, 5, 6, 7]
    assert hashlib.sha256(rows.tobytes()).hexdigest() == fn(iter(recs))["sha"]
    k, v = recs[5]
    bad = fn(iter([(k, v[:-1] + b"y") if (k, v) == recs[5] else r
                   for r in recs if r[0] < half]))
    with pytest.raises(AssertionError, match="differ"):
        chip_smoke._el_check([bad, parts[1]], (rows, bounds), "small")
    with pytest.raises(AssertionError, match="read twice or missing"):
        chip_smoke._el_check([parts[0], parts[0]], (rows, bounds), "small")


def test_chip_smoke_chaos_and_service_phases_on_the_cpu(monkeypatch):
    """Phase 17 (c) and (d) at 3,200 records through their own functions:
    zero recompute with adoptions and promotions under ``driver:kill``
    then ``exec:kill``; the daemon adopts proc-exec-0's maps (linked, on
    one filesystem) and serves the same bytes after the worker's kill."""
    import tempfile

    import chip_smoke

    monkeypatch.setattr(chip_smoke, "EN_TENTH", 3_200)
    with _deadline(2 * CLUSTER_S):
        chaos = chip_smoke._el_chaos()
        with tempfile.TemporaryDirectory() as tmp:
            svc = chip_smoke._el_service(tmp)
    assert chaos["driver"]["elastic.recomputed_maps"] == 0
    assert chaos["driver"]["metastore.adoptions"] > 0
    assert chaos["driver"]["elastic.replica_promotions"] > 0
    assert chaos["workers"]["elastic.replicated_maps"] == chip_smoke.EN_MAPS
    assert svc["adopted"] == len(svc["exec0_maps"]) > 0
    assert svc["linked"] == svc["adopted"] and svc["copied"] == 0
    assert svc["dead"] == ["proc-exec-0"] and svc["daemon_exit"] == 0
