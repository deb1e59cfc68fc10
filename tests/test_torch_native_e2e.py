"""The port's native plane end to end, on the CPU: the counterparts of
``tests/test_cluster.py::test_multiprocess_native_transport``,
``tests/test_spill_and_stress.py::test_native_concurrent_large_reads``
and ``::test_native_send_budget_overflow_drains`` and the ``native`` case
of ``tests/test_device_io_multiprocess.py``, then ``chip_smoke.py``
phase 15 (b) and (c) at a small size through its own function: a
TeraSort over the native plane on ``"cpu"`` devices, held against the
same run over the python plane and against ``np.sort``.

The tests skip only where g++ is absent (``toolchain_available()``),
never on a failed build."""

import collections
import multiprocessing as mp
import threading

import numpy as np
import pytest
import torch

import chip_smoke
from sparkrdma_tpu_torch.native.transport_lib import toolchain_available
from sparkrdma_tpu_torch.shuffle.device_io import DeviceShuffleIO
from sparkrdma_tpu_torch.shuffle.handle import BaseShuffleHandle, HashPartitioner
from sparkrdma_tpu_torch.shuffle.manager import TpuShuffleManager
from sparkrdma_tpu_torch.transport import FnListener
from sparkrdma_tpu_torch.utils.config import TpuShuffleConf

torch.set_num_threads(1)

pytestmark = pytest.mark.skipif(
    not toolchain_available(), reason="g++ absent: the native plane cannot be built"
)

NATIVE = {"tpu.shuffle.transport": "native"}


def test_multiprocess_native_transport():
    """Executor processes shuffling over the C++ data plane; every
    worker runs a ``NativeTpuNode`` and never initialises CUDA."""
    from sparkrdma_tpu_torch.engine.cluster import ClusterContext
    from sparkrdma_tpu_torch.transport.native_node import NativeTpuNode

    conf = TpuShuffleConf(dict(NATIVE))

    def gen():
        return iter([(i % 5, i) for i in range(1000)])

    def collect(it):
        return sorted(it)

    with ClusterContext(num_executors=2, conf=conf) as cc:
        assert isinstance(cc.driver.node, NativeTpuNode)
        parts = cc.run_map_reduce([gen, gen], num_partitions=2, reduce_fn=collect)
        probes = cc.run_map_reduce([chip_smoke._en_map_fn(7, 64)], num_partitions=2,
                                   reduce_fn=chip_smoke._en_probe_fn())
    rows = [kv for p in parts for kv in p]
    assert len(rows) == 2000
    by_key = collections.Counter(k for k, _ in rows)
    assert all(by_key[k] == 400 for k in range(5))
    for p in probes:
        assert p["nodes"] == ["NativeTpuNode"]
        assert p["cuda_initialized"] is False and p["jax"] == []


def test_native_concurrent_large_reads():
    from sparkrdma_tpu_torch.transport.native_node import NativeTpuNode

    conf = TpuShuffleConf()
    a = NativeTpuNode(conf, "127.0.0.1", False, "stress-a")
    b = NativeTpuNode(conf, "127.0.0.1", True, "stress-b")
    try:
        n = 4 * 1024 * 1024
        src = np.random.default_rng(1).integers(0, 256, n, dtype=np.uint8)
        region = memoryview(bytearray(src.tobytes()))
        mkey = a.pd.register(region)
        ch = b.get_channel("127.0.0.1", a.port)

        results = []
        events = []
        for i in range(8):
            off = i * (n // 8)
            length = n // 8
            dst = memoryview(bytearray(length))
            ev = threading.Event()
            errs = []
            ch.read_in_queue(
                FnListener(
                    lambda _, e=ev: e.set(),
                    lambda ex, e=ev, er=errs: (er.append(ex), e.set()),
                ),
                [dst],
                [(mkey, off, length)],
            )
            results.append((off, length, dst, errs))
            events.append(ev)
        for ev in events:
            assert ev.wait(20), "stress read timed out"
        for off, length, dst, errs in results:
            assert not errs, errs
            assert bytes(dst) == src[off : off + length].tobytes()
    finally:
        b.stop()
        a.stop()


def test_native_send_budget_overflow_drains():
    """More posted WRs than permits: all must still complete in order
    of eligibility, with the overflow deque draining on completions."""
    from sparkrdma_tpu_torch.transport.native_node import NativeTpuNode

    conf = TpuShuffleConf({"tpu.shuffle.sendQueueDepth": "256"})
    got = []
    done = threading.Event()
    total = 600  # > budget

    def on_recv(ch, payload):
        got.append(payload)
        if len(got) == total:
            done.set()

    a = NativeTpuNode(conf, "127.0.0.1", False, "budget-a")
    b = NativeTpuNode(conf, "127.0.0.1", True, "budget-b", recv_listener=on_recv)
    try:
        ch = a.get_channel("127.0.0.1", b.port)
        for i in range(total):
            ch.send_in_queue(FnListener(), [b"m%06d" % i])
        assert done.wait(20), f"only {len(got)}/{total} arrived"
        assert sorted(got) == [b"m%06d" % i for i in range(total)]
        assert ch._budget <= conf.send_queue_depth
    finally:
        a.stop()
        b.stop()


SHUFFLE_ID = 31
PARTS = 3


def _pattern(pid: int) -> np.ndarray:
    rng = np.random.default_rng(1000 + pid)
    return rng.integers(0, 256, 3000 + 700 * pid, dtype=np.uint8)


def _publisher_main(conf_dict, q_out, q_in):
    torch.set_num_threads(1)
    conf = TpuShuffleConf(conf_dict)
    ex = TpuShuffleManager(conf, is_driver=False, executor_id="proc-pub")
    io = DeviceShuffleIO(ex, device="cpu")
    try:
        io.publish_device_blocks(
            SHUFFLE_ID, {p: _pattern(p) for p in range(PARTS)}
        )
        q_out.put("published")
        # keep serving one-sided READs until the parent is done
        assert q_in.get(timeout=120) == "stop"
    finally:
        io.stop()
        ex.stop()


def test_cross_process_device_block_shuffle_native():
    """A child process publishes device blocks from its own registered
    memory; the parent's executor READs them over real TCP and stages
    them into its ``"cpu"`` arena. Co-located processes: every READ
    rides the same-host fast path by mapped delivery, none streamed."""
    conf = TpuShuffleConf(dict(NATIVE))
    driver = TpuShuffleManager(conf, is_driver=True)
    handle = BaseShuffleHandle(
        shuffle_id=SHUFFLE_ID, num_maps=1, partitioner=HashPartitioner(PARTS)
    )
    driver.register_shuffle(handle)

    ctx = mp.get_context("spawn")
    q_out, q_in = ctx.Queue(), ctx.Queue()
    child_conf = {**NATIVE, "tpu.shuffle.driverPort": str(driver.node.port)}
    child = ctx.Process(
        target=_publisher_main, args=(child_conf, q_out, q_in), daemon=True
    )
    child.start()
    reader = TpuShuffleManager(
        TpuShuffleConf(dict(child_conf)), is_driver=False,
        executor_id="proc-read",
    )
    io = DeviceShuffleIO(reader, device="cpu")
    try:
        assert q_out.get(timeout=120) == "published"
        got = io.fetch_device_blocks(SHUFFLE_ID, 0, PARTS, timeout_s=60)
        assert set(got) == set(range(PARTS))
        for p in range(PARTS):
            (buf,) = got[p]
            want = _pattern(p)
            assert buf.length == want.nbytes
            assert buf.read(0, buf.length) == want.tobytes(), (
                f"partition {p} bytes differ across processes"
            )
            buf.free()
        m = io.metrics_snapshot()
        assert m["transport"] == "NativeTpuNode"
        assert m["reads_samehost_fast_path"] == PARTS
        assert m["reads_streamed"] == 0
        assert m["registered_pool_allocs_by_class"] == {}
    finally:
        q_in.put("stop")
        io.stop()
        reader.stop()
        child.join(timeout=30)
        if child.is_alive():
            child.terminate()
        driver.stop()


@pytest.fixture(scope="module")
def small_terasort():
    """Phase 15's data at 2^20 keys (64 KiB blocks, above
    ``deviceFetch.minBlockBytes``): 8 shards, 8 reducers."""
    rng = np.random.default_rng(12)
    shards = [rng.integers(0, 1 << 32, (1 << 20) // chip_smoke.EXECUTORS, dtype=np.uint32)
              for _ in range(chip_smoke.EXECUTORS)]
    edges = np.asarray([(r << 32) // chip_smoke.REDUCERS
                        for r in range(1, chip_smoke.REDUCERS)], np.uint32)
    return shards, edges, chip_smoke._expected(shards, edges)


def test_terasort_over_native_matches_python(small_terasort):
    """``chip_smoke.native_terasort`` (phase 15 (b) and (c)) on ``"cpu"``
    over each plane: every reducer's merged keys equal between the
    planes and equal to ``np.sort`` of its range (checked inside); on
    the native plane (c) takes mapped delivery for every remote block
    (fast-path READs == remote blocks, none streamed, no pooled
    registered buffer), on the python plane pooled buffers and no fast
    path."""
    dev = torch.device("cpu")
    native, n_outs = chip_smoke.native_terasort(
        torch, dev, small_terasort, chip_smoke.NATIVE_PLANE, "tnt-n", keep=True)
    python, p_outs = chip_smoke.native_terasort(
        torch, dev, small_terasort, chip_smoke.PY_PLANE, "tnt-p", keep=True)
    assert native["nodes"] == ["NativeTpuNode"] and python["nodes"] == ["TpuNode"]
    assert set(n_outs) == set(p_outs) == {"b_cold", "b_warm", "c_cold", "c_warm"}
    for run in n_outs:
        for (nm, nt), (pm, pt) in zip(n_outs[run], p_outs[run]):
            assert int(nt) == int(pt)
            assert torch.equal(nm[: int(nt)], pm[: int(pt)])
    c = native["c"]
    assert c["remote_blocks_two_reduces"] == 2 * 8 * 7
    assert c["fast_path_two_reduces"] == c["remote_blocks_two_reduces"]
    assert c["streamed_two_reduces"] == 0 and c["pool_gets_two_reduces"] == 0
    assert python["c"]["pool_gets_two_reduces"] == python["c"]["remote_blocks_two_reduces"]
    assert python["c"]["fast_path_two_reduces"] == 0
    assert native["sq"]["completions"] > 0
