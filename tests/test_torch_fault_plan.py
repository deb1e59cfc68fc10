"""The port's fault plans (``testing/faults.py``) and the seams they fire
at, against the JAX package's: the same spec and seed make the same
decisions and flip the same bytes; through a port cluster transient
READ faults are absorbed, corruption is detected and refetched, an
endless fault surfaces promptly, the decode-stage seam is caught and
reordered, dropped or corrupted pushes fall back to the originals; and
the map and reduce pipelines keep order and drain on abort.

Nothing here waits on a sleep for a result: a push drop is a plan rule,
and every test waits on the reader's own result."""

import contextlib
import threading
import time

import numpy as np
import pytest
import torch

import chip_smoke
from sparkrdma_tpu.testing import faults as jfaults
from sparkrdma_tpu_torch.locations import BlockLocation, PartitionLocation
from sparkrdma_tpu_torch.obs import get_registry
from sparkrdma_tpu_torch.shuffle.device_io import DeviceShuffleIO
from sparkrdma_tpu_torch.shuffle.errors import ShuffleError
from sparkrdma_tpu_torch.shuffle.handle import BaseShuffleHandle, HashPartitioner
from sparkrdma_tpu_torch.shuffle.manager import TpuShuffleManager
from sparkrdma_tpu_torch.shuffle.reader.pipeline import ReduceTaskPipeline
from sparkrdma_tpu_torch.shuffle.writer.pipeline import MapTaskPipeline
from sparkrdma_tpu_torch.testing import faults
from sparkrdma_tpu_torch.utils.config import TpuShuffleConf

torch.set_num_threads(1)

pytestmark = pytest.mark.faults


def _total(reg, before, prefix):
    return sum(reg.delta(before, prefix=prefix).get("counters", {}).values())


# ----------------------------------------------------------------------
# the plan's decisions, seam by seam, against JAX's
# ----------------------------------------------------------------------
class _Listener:
    def __init__(self, log):
        self.log = log

    def on_success(self, payload):
        self.log.append(("ok", payload))

    def on_failure(self, e):
        self.log.append(("fail", type(e).__name__, str(e)))


class _Channel:
    peer_desc = "exec-1@host:1"

    def stop(self):
        pass


def _drive(mod, spec, seed):
    """Every seam of ``mod``'s plan, a fixed sequence of calls; returns
    what each call decided, what each flip did to its buffer, and the
    plan's injected counts."""
    plan = mod.FaultPlan.parse(spec, seed=seed)
    out = []
    for i in range(6):
        log, buf = [], bytearray(range(32))
        listener, handled = plan.on_read(_Channel(), _Listener(log), [memoryview(buf)], [])
        if not handled:
            listener.on_success(i)
        out.append(("read", handled, log, bytes(buf)))
        log = []
        listener, handled = plan.on_send(_Channel(), _Listener(log), [])
        out.append(("send", handled, log))
        out.append(("rpc",) + plan.on_rpc("exec-1", bytes(range(16))))
        buf = bytearray(range(64))
        try:
            plan.on_stage("decode", [memoryview(buf)], peer="exec-1")
            out.append(("stage", "ok", bytes(buf)))
        except mod.InjectedFault as e:
            out.append(("stage", str(e)))
        buf = bytearray(range(64))
        out.append(("push_send", plan.on_push("send", [], peer="exec-1")))
        out.append(("push_seal", plan.on_push("seal", [memoryview(buf)]), bytes(buf)))
        out.append(("meta", plan.on_meta(shard="meta-0")))
        out.append(("driver", plan.on_driver(stage="reduce_phase")))
    return out, sorted(plan.injected.items()), plan.total_injected


@pytest.mark.parametrize("spec, seed", [
    ("read:fail:2", 0),
    ("read:corrupt:1", 3),
    ("read:fail:2;read:corrupt:1", 3),
    ("read:drop:1:after=2", 5),
    ("read:fail:0:peer=exec-1", 0),
    ("send:drop:2;send:fail:1", 0),
    ("rpc:corrupt:3", 11),
    ("rpc:drop:1:after=1", 0),
    ("stage:corrupt:2:stage=decode", 7),
    ("stage:fail:1:stage=stage", 7),
    ("push:drop:3;push:corrupt:1", 13),
    ("meta:kill:1:shard=meta-0;driver:kill:1:stage=reduce_phase", 0),
    ("read:fail:1:peer=nobody", 0),
])
def test_fault_plan_decisions_equal_jax(spec, seed):
    assert _drive(faults, spec, seed) == _drive(jfaults, spec, seed)


@pytest.mark.parametrize("spec", ["bogus:fail:1", "read:explode:1", "read", "read:fail:x"])
def test_bad_specs_raise_as_jax(spec):
    with pytest.raises(ValueError) as want:
        jfaults.FaultPlan.parse(spec)
    with pytest.raises(ValueError) as got:
        faults.FaultPlan.parse(spec)
    assert str(got.value) == str(want.value)


def test_conf_fault_plan_installs_and_is_idempotent():
    spec = "read:fail:1:peer=nobody"
    conf = TpuShuffleConf({"tpu.shuffle.transport": "python",
                           "tpu.shuffle.faultPlan": spec,
                           "tpu.shuffle.faultPlanSeed": "4"})
    prev = faults.uninstall()
    try:
        driver = TpuShuffleManager(conf, is_driver=True)
        ex = TpuShuffleManager(conf, is_driver=False, executor_id="fp-conf-0")
        try:
            plan = faults.active()
            assert plan is not None and (plan.spec, plan.seed) == (spec, 4)
            assert faults.ensure_installed(spec, 4) is plan
        finally:
            ex.stop()
            driver.stop()
    finally:
        faults.uninstall()
        if prev is not None:
            faults.install(prev)
    assert faults.ensure_installed("") is None


# ----------------------------------------------------------------------
# the plan through a port cluster
# ----------------------------------------------------------------------
def _shuffle(tag, extra=None, method="wrapper", maps=4, partitions=4, n=1500,
             executors=2, plan_for=None):
    """A driver and ``executors`` executors; ``maps`` maps split over
    them, then each executor reads its share of the partitions. Returns
    the records sorted. ``plan_for(execs)``, when given, is a spec
    installed (seed 3) once the executors' nodes are up, for the whole
    shuffle; the plan is then returned too."""
    conf = TpuShuffleConf({"tpu.shuffle.transport": "python",
                           "tpu.shuffle.shuffleWriteMethod": method,
                           "tpu.shuffle.shuffleWriteBlockSize": "65536",
                           "tpu.shuffle.shuffleReadBlockSize": "65536",
                           **(extra or {})})
    driver = TpuShuffleManager(conf, is_driver=True)
    execs = [TpuShuffleManager(conf, is_driver=False, executor_id=f"fp-{tag}-{i}")
             for i in range(executors)]
    stack = contextlib.ExitStack()
    try:
        for ex in execs:
            ex.start_node_if_missing()
        # membership settles before any map runs: the push client routes
        # over the executors each one knows, so an announce still in
        # flight under load would leave pushes (and their faults) out
        ids = {ex.executor_id for ex in execs}
        deadline = time.monotonic() + 30.0
        while any(not ids <= set(ex.known_executor_ids()) for ex in execs):
            assert time.monotonic() < deadline, "executor membership did not settle"
            time.sleep(0.005)
        plan = None
        if plan_for is not None:
            plan = stack.enter_context(faults.installed(plan_for(execs), seed=3))
        handle = BaseShuffleHandle(shuffle_id=0, num_maps=maps,
                                   partitioner=HashPartitioner(partitions))
        driver.register_shuffle(handle)
        for map_id in range(maps):
            w = execs[map_id * executors // maps].get_writer(handle, map_id)
            w.write(iter((f"key-{(map_id * n + i) % 397}", map_id * n + i)
                         for i in range(n)))
            assert w.stop(True) is not None
        for ex in execs:
            ex.finalize_maps(0)
        out = []
        for e, ex in enumerate(execs):
            lo, hi = e * partitions // executors, (e + 1) * partitions // executors
            out.extend(ex.get_reader(handle, lo, hi).read())
        return (sorted(out), plan) if plan_for is not None else sorted(out)
    finally:
        stack.close()
        for ex in execs:
            ex.stop()
        driver.stop()


_EXPECTED = sorted((f"key-{v % 397}", v) for v in range(4 * 1500))


@pytest.mark.parametrize("spec, seed, kind, retries, detected", [
    ("read:fail:2", 0, "fail", 2, 0),
    ("read:corrupt:1", 3, "corrupt", 1, 1),
])
def test_transient_and_corrupt_reads_are_absorbed(spec, seed, kind, retries, detected):
    reg = get_registry()
    before = reg.snapshot(prefix="resilience.")
    with faults.installed(spec, seed=seed) as plan:
        out = _shuffle(f"abs-{kind}")
    assert out == _EXPECTED
    assert plan.injected_count("read", kind) == plan.total_injected == retries
    assert _total(reg, before, "resilience.retries") >= retries
    assert _total(reg, before, "resilience.checksum_failures") >= detected


def test_faults_spread_over_sources_are_absorbed():
    """``chip_smoke.py`` phase 13 (d)'s plan: two failed READs and one
    corrupted, each from its own source executor (``peer=`` its port), so
    no reader's circuit to a source sees the three consecutive failures
    that open it (``resilience.circuitFailureThreshold``)."""
    reg = get_registry()
    before = reg.snapshot(prefix="resilience.")
    out, plan = _shuffle("spread", executors=4, plan_for=lambda execs: chip_smoke.dp_fault_spec(
        [ex.node.port for ex in execs[1:]]))
    assert out == _EXPECTED
    assert (plan.injected_count("read", "fail"), plan.injected_count("read", "corrupt")) == (2, 1)
    assert _total(reg, before, "resilience.retries") >= 3
    assert _total(reg, before, "resilience.checksum_failures") >= 1
    assert _total(reg, before, "resilience.circuit_fail_fast") == 0


def test_endless_read_faults_surface_promptly():
    t0 = time.monotonic()
    with faults.installed("read:fail:0"):
        with pytest.raises(ShuffleError):
            _shuffle("endless", {"tpu.shuffle.resilience.maxFetchAttempts": "2",
                                 "tpu.shuffle.resilience.retryBackoffMs": "5",
                                 "tpu.shuffle.resilience.retryBackoffMaxMs": "10"})
    assert time.monotonic() - t0 < 60


def test_block_corrupt_header_detected_and_refetched():
    reg = get_registry()
    before = reg.snapshot(prefix="resilience.")
    conf = TpuShuffleConf({"tpu.shuffle.transport": "python",
                           "tpu.shuffle.shuffleWriteMethod": "wrapper",
                           "tpu.shuffle.block.format": "columnar"})
    driver = TpuShuffleManager(conf, is_driver=True)
    ex0 = TpuShuffleManager(conf, is_driver=False, executor_id="fp-blk-0")
    ex1 = TpuShuffleManager(conf, is_driver=False, executor_id="fp-blk-1")
    expected, got = {}, {}
    try:
        handle = BaseShuffleHandle(shuffle_id=0, num_maps=2, partitioner=HashPartitioner(2))
        driver.register_shuffle(handle)
        for map_id, ex in [(0, ex0), (1, ex1)]:
            recs = [(np.uint32((map_id * 5000 + i) % 499), np.int64(i * 7))
                    for i in range(3000)]
            for k, v in recs:
                expected.setdefault(int(k), []).append(int(v))
            w = ex.get_writer(handle, map_id)
            w.write(iter(recs))
            assert w.stop(True) is not None
        ex0.finalize_maps(0)
        ex1.finalize_maps(0)
        with faults.installed("block:corrupt_header:1", seed=17) as plan:
            # ex1's blocks land in ex0's writable registered slices
            for k, v in ex0.get_reader(handle, 0, 2).read():
                got.setdefault(int(k), []).append(int(v))
        assert plan.injected_count("block", "corrupt_header") == 1
    finally:
        ex1.stop()
        ex0.stop()
        driver.stop()
    assert {k: sorted(v) for k, v in got.items()} == {k: sorted(v) for k, v in expected.items()}
    assert _total(reg, before, "resilience.checksum_failures") >= 1
    assert _total(reg, before, "resilience.retries") >= 1


def test_stage_seam_corrupt_in_decode_detected_and_reordered():
    """A block corrupted in the reduce pipeline's decode stage, after the
    wire delivered it intact, is caught by ``verify_host_block``'s
    checksum, refetched once, and every group still arrives in source
    order with its bytes."""
    reg = get_registry()
    before = reg.snapshot(prefix="resilience.")
    conf = TpuShuffleConf({"tpu.shuffle.transport": "python"})
    driver = TpuShuffleManager(conf, is_driver=True)
    ex0 = TpuShuffleManager(conf, is_driver=False, executor_id="fp-stg-0")
    ex1 = TpuShuffleManager(conf, is_driver=False, executor_id="fp-stg-1")
    ex1.start_node_if_missing()
    regs, payloads, locs = [], [], []
    try:
        rng = np.random.default_rng(5)
        for p in range(4):
            payload = rng.integers(0, 256, 48_000, np.uint8).tobytes()
            payloads.append(payload)
            buf = ex1.buffer_manager.get(len(payload))
            regs.append(buf)
            np.frombuffer(buf.view, np.uint8, len(payload))[:] = np.frombuffer(payload, np.uint8)
            locs.append(PartitionLocation(ex1.local_manager_id, p,
                                          BlockLocation(0, len(payload), buf.mkey)))
        ex1.publish_partition_locations(77, -1, locs, num_map_outputs=1)
        io = DeviceShuffleIO(ex0, device="cpu")

        def fetch_group(r):
            return io.fetch_host_blocks(77, r, r + 1, timeout_s=30)[r]

        def verify_group(r, blocks):
            return [io.verify_host_block(hb) for hb in blocks]

        def take_bytes(r, blocks):
            out = [bytes(hb.data) for hb in blocks]
            for hb in blocks:
                hb.release()
            return (r, out)

        def discard(stage, _item, value):
            if stage in ("fetch", "decode") and value:
                for hb in value:
                    hb.release()

        pipe = ReduceTaskPipeline(fetch_group, verify_group, take_bytes, None,
                                  parallelism=2, depth=2, double_buffer=False,
                                  role="fp-stage-seam", discard_fn=discard)
        try:
            with faults.installed("stage:corrupt:1:stage=decode", seed=7) as plan:
                results = list(pipe.stream(range(4)))
        finally:
            io.stop()
        assert plan.injected_count("stage", "corrupt") == 1
        assert [r for r, _ in results] == [0, 1, 2, 3]
        for r, blobs in results:
            assert blobs == [payloads[r]], f"group {r} bytes differ"
        assert _total(reg, before, "resilience.checksum_failures") >= 1
        assert _total(reg, before, "resilience.retries") >= 1
    finally:
        for buf in regs:
            ex1.buffer_manager.put(buf)
        ex0.stop()
        ex1.stop()
        driver.stop()


_PUSH = {"tpu.shuffle.push.enabled": "true"}


@pytest.mark.parametrize("spec, seed, kind, n", [
    ("push:drop:3", 0, "drop", 3),
    ("push:corrupt:1", 13, "corrupt", 1),
])
def test_push_faults_fall_back_to_originals_byte_identical(spec, seed, kind, n):
    reg = get_registry()
    baseline = _shuffle(f"push-off-{kind}", {"tpu.shuffle.push.enabled": "false"},
                        method="chunkedpartitionagg", partitions=5)
    before = reg.snapshot(prefix="resilience.")
    before_push = reg.snapshot(prefix="push.")
    with faults.installed(spec, seed=seed) as plan:
        out = _shuffle(f"push-{kind}", _PUSH, method="chunkedpartitionagg", partitions=5)
    assert plan.injected_count("push", kind) == n
    assert out == baseline
    if kind == "corrupt":
        assert _total(reg, before, "resilience.checksum_failures") >= 1
        assert _total(reg, before_push, "push.fallbacks") >= 1


# ----------------------------------------------------------------------
# map and reduce pipelines: order kept, drain on abort
# ----------------------------------------------------------------------
def test_map_pipeline_keeps_results_in_item_order():
    def sort_fn(i):
        time.sleep(0.002 * ((7 * i) % 5))  # finish out of order
        return i * 10

    report = MapTaskPipeline(sort_fn, lambda i, s: s + 1, lambda i, s: (i, s),
                             parallelism=3, depth=2, role="fp-map-order").run(range(9))
    assert report.results == [(i, i * 10 + 1) for i in range(9)]
    assert set(report.stage_busy_s) == {"sort", "stage", "publish"}


def test_map_pipeline_abort_skips_publish():
    published, entered = [], threading.Event()

    def sort_fn(i):
        if i == 1:
            entered.wait(5)  # let item 0 get ahead
            raise RuntimeError("boom")
        return i

    def publish_fn(i, st):
        published.append(i)
        entered.set()
        return i

    with pytest.raises(RuntimeError, match="boom"):
        MapTaskPipeline(sort_fn, None, publish_fn, parallelism=2, depth=2,
                        role="fp-map-abort").run(range(8))
    assert 1 not in published and len(published) < 8


@pytest.mark.parametrize("parallelism", [1, 4])
def test_reduce_pipeline_keeps_source_order(parallelism):
    def decode_fn(i, fetched):
        time.sleep(0.01 if i % 3 == 0 else 0.001)  # successors finish first
        return ("dec", i)

    pipe = ReduceTaskPipeline(None, decode_fn, None, None, parallelism=parallelism,
                              depth=3, double_buffer=False,
                              role=f"fp-red-order-{parallelism}")
    assert list(pipe.stream(range(10))) == [("dec", i) for i in range(10)]


@pytest.mark.parametrize("how", ["error", "early_close"])
def test_reduce_pipeline_drains_on_abort(how):
    acquired, released, delivered = [], [], []
    role = f"fp-red-{how}"

    def fetch_fn(i):
        acquired.append(i)
        return ("blk", i)

    def decode_fn(i, blk):
        if how == "error" and i == 3:
            raise RuntimeError("decode boom")
        time.sleep(0.002)
        return ("dec", i)

    pipe = ReduceTaskPipeline(fetch_fn, decode_fn, None, None, parallelism=2, depth=2,
                              double_buffer=False, role=role,
                              discard_fn=lambda stage, item, value:
                                  released.append((stage, item)))
    if how == "error":
        with pytest.raises(RuntimeError, match="decode boom"):
            for out in pipe.stream(range(8)):
                delivered.append(out)
        assert ("dec", 3) not in delivered and len(delivered) < 8
    else:
        stream = pipe.stream(range(16))
        delivered.append(next(stream))
        stream.close()
    # every fetched item was delivered or discarded, exactly once
    assert len(delivered) + len(released) == len(acquired)
    snap = get_registry().snapshot(prefix="reader.pipeline")
    (gk,) = [k for k in snap["gauges"] if "inflight" in k and f"role={role}" in k]
    assert snap["gauges"][gk]["value"] == 0


def test_two_tenant_fault_isolation(monkeypatch):
    """The counterpart of tests/test_fault_injection.py's tenancy test on
    the port's ``TpuContext``, pinned to the python plane (the seam is
    the python channel's ``read_in_queue``): persistent READ faults
    scoped to ONE tenant's tasks fail that tenant's job and open only
    that tenant's breakers. A concurrent quiet tenant sharing the same
    executors, pools and peers completes with plain Python's counts,
    and none of its tenant-scoped breaker keys opens."""
    from sparkrdma_tpu_torch import tenancy
    from sparkrdma_tpu_torch.engine.context import TpuContext
    from sparkrdma_tpu_torch.transport.channel import ChannelError, TpuChannel

    state = {"injected": 0}
    lock = threading.Lock()
    original = TpuChannel.read_in_queue

    def noisy_only(self, listener, dst_views, blocks):
        # posted from a tenant-scoped thread (fair-share worker or the
        # fetcher's re-scoped retry rung): the scope names the tenant
        if tenancy.current_tenant() == "noisy":
            with lock:
                state["injected"] += 1
            listener.on_failure(ChannelError("injected noisy-tenant fault"))
            return
        return original(self, listener, dst_views, blocks)

    monkeypatch.setattr(TpuChannel, "read_in_queue", noisy_only)
    conf = TpuShuffleConf({
        "tpu.shuffle.transport": "python",
        "tpu.shuffle.resilience.maxFetchAttempts": "2",
        "tpu.shuffle.resilience.retryBackoffMs": "5",
        "tpu.shuffle.resilience.retryBackoffMaxMs": "10",
        "tpu.shuffle.resilience.circuitFailureThreshold": "2",
        "tpu.shuffle.resilience.circuitOpenMs": "60000",
    })
    results, errors = {}, {}

    with TpuContext(num_executors=2, conf=conf, task_threads=4) as ctx:
        def job(tenant, n, mod):
            try:
                rdd = (ctx.parallelize(range(n), 4)
                       .map(lambda x: (x % mod, 1))
                       .reduce_by_key(lambda a, b: a + b, num_partitions=4))
                results[tenant] = dict(ctx.run_job(rdd, tenant=tenant))
            except Exception as e:  # noqa: BLE001 — inspected below
                errors[tenant] = e

        threads = [threading.Thread(target=job, args=("noisy", 1200, 5)),
                   threading.Thread(target=job, args=("quiet", 2000, 9))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert all(type(m.node).__name__ == "TpuNode" for m in ctx.executors)
        assert isinstance(errors.get("noisy"), ShuffleError), errors
        assert state["injected"] >= 2
        assert "quiet" not in errors, errors.get("quiet")
        assert results["quiet"] == {k: len(range(k, 2000, 9)) for k in range(9)}
        states = {}
        for mgr in ctx.executors:
            states.update(mgr.health.states())
        assert any(k.startswith("noisy:") and v == "open" for k, v in states.items()), states
        for key, st in states.items():
            if key.startswith("quiet:") or ":" not in key:
                assert st == "closed", f"fault bled across tenants: breaker {key} is {st}"
