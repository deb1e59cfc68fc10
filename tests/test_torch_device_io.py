"""shuffle/device_io.py of the port, on ``device="cpu"`` over the python
transport: the counterparts of tests/test_device_io.py (publish, location
RPC, one-sided READ, device staging; the deadline, ordering, fault and
ownership rules of the fetch loop, scripted at the python channel), the
roundtrip held against the JAX endpoint on the same inputs, and the
compiled waves' CUDA branch reached on the CPU: ``fetch_device_blocks``
launches ``srt_wave_pull`` / ``srt_pipelined_wave_pull`` (a fake library
that gathers through the row table it is handed) with the bytes of the
JAX fetch."""

import contextlib
import ctypes
import threading
import time

import numpy as np
import pytest
import torch

from sparkrdma_tpu.shuffle.device_io import DeviceShuffleIO as JaxIO
from sparkrdma_tpu.shuffle.handle import BaseShuffleHandle as JaxHandle
from sparkrdma_tpu.shuffle.handle import HashPartitioner as JaxPartitioner
from sparkrdma_tpu.shuffle.manager import TpuShuffleManager as JaxManager
from sparkrdma_tpu.utils.config import TpuShuffleConf as JaxConf
from sparkrdma_tpu_torch.obs import get_registry
from sparkrdma_tpu_torch.ops import _build
from sparkrdma_tpu_torch.ops import remote_copy as trc
from sparkrdma_tpu_torch.shuffle.collective import ShuffleScheduleCompiler
from sparkrdma_tpu_torch.shuffle.device_io import DeviceShuffleIO
from sparkrdma_tpu_torch.shuffle.errors import FetchFailedError
from sparkrdma_tpu_torch.shuffle.handle import BaseShuffleHandle, HashPartitioner
from sparkrdma_tpu_torch.shuffle.manager import TpuShuffleManager
from sparkrdma_tpu_torch.transport.channel import ChannelError, TpuChannel
from sparkrdma_tpu_torch.utils.config import TpuShuffleConf

torch.set_num_threads(1)

PY = {"tpu.shuffle.transport": "python"}


@contextlib.contextmanager
def _cluster(knobs=None, prefix="tdio", pkg="torch"):
    """A driver and two executors of one package; stopped on exit."""
    conf_cls, mgr_cls = ((TpuShuffleConf, TpuShuffleManager) if pkg == "torch"
                         else (JaxConf, JaxManager))
    conf = conf_cls(dict(PY, **(knobs or {})))
    driver = mgr_cls(conf, is_driver=True)
    ex0 = mgr_cls(conf, is_driver=False, executor_id=f"{prefix}-0")
    ex1 = mgr_cls(conf, is_driver=False, executor_id=f"{prefix}-1")
    try:
        yield conf, driver, ex0, ex1
    finally:
        ex0.stop()
        ex1.stop()
        driver.stop()


@pytest.fixture
def cluster():
    with _cluster() as c:
        yield c


def _ios(ex0, ex1):
    return DeviceShuffleIO(ex0, device="cpu"), DeviceShuffleIO(ex1, device="cpu")


def _free_all(got):
    for bufs in got.values():
        for b in bufs:
            b.free()


def _blocks(got):
    return {p: sorted(b.read(0, b.length) for b in bufs) for p, bufs in got.items()}


# ----------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["numpy", "torch"])
def test_device_block_shuffle_roundtrip_matches_jax(kind):
    """Each executor publishes two partitions; executor 0 pulls all four
    (two remote one-sided READs, two local short-circuits). The port
    returns the JAX endpoint's bytes for the same inputs, and its staged
    slabs live under the arena budget until freed."""
    rng = np.random.default_rng(2)
    a = {0: np.arange(100, dtype=np.uint8),
         1: rng.integers(0, 256, 300, dtype=np.uint8)}
    b = {2: np.full((50,), 7, np.uint8),
         3: rng.integers(0, 256, 200, dtype=np.uint8)}
    results = {}
    for pkg in ("jax", "torch"):
        with _cluster(prefix=f"rt-{pkg}", pkg=pkg) as (conf, driver, ex0, ex1):
            if pkg == "jax":
                handle = JaxHandle(shuffle_id=1, num_maps=2,
                                   partitioner=JaxPartitioner(4))
                io0, io1 = JaxIO(ex0), JaxIO(ex1)
                pa, pb = a, b
            else:
                handle = BaseShuffleHandle(shuffle_id=1, num_maps=2,
                                           partitioner=HashPartitioner(4))
                io0, io1 = _ios(ex0, ex1)
                wrap = torch.from_numpy if kind == "torch" else (lambda x: x)
                pa = {p: wrap(x) for p, x in a.items()}
                pb = {p: wrap(x) for p, x in b.items()}
            driver.register_shuffle(handle)
            try:
                io0.publish_device_blocks(1, pa)
                io1.publish_device_blocks(1, pb)
                got = io0.fetch_device_blocks(1, 0, 4, timeout_s=60)
                assert set(got) == {0, 1, 2, 3}
                results[pkg] = _blocks(got)
                assert io0.device_buffers.in_use_bytes > 0
                _free_all(got)
                assert io0.device_buffers.in_use_bytes == 0
            finally:
                io0.stop()
                io1.stop()
    assert results["torch"] == results["jax"]
    assert results["torch"][0] == [np.arange(100, dtype=np.uint8).tobytes()]


def test_stage_tags_checksums_and_types_slabs(cluster):
    """The map side tags every block with its checksum and keeps the
    arena copy typed: uint32 keys stage as uint32, and a CPU tensor
    stages the bytes its numpy twin does."""
    conf, driver, ex0, ex1 = cluster
    io0, _io1 = _ios(ex0, ex1)
    keys = np.random.default_rng(4).integers(0, 1 << 32, 6000, dtype=np.uint32)
    try:
        ln = io0.stage_device_blocks(3, {0: keys})
        lt = io0.stage_device_blocks(3, {0: torch.from_numpy(keys.copy())})
        for locs in (ln, lt):
            blk = locs[0].block
            assert blk.length == keys.nbytes and blk.checksum_algo
            assert blk.has_device and blk.device_coords == 0
            arena = io0.device_buffers.resolve(blk.arena_handle)
            assert arena.array.dtype == torch.uint32
            assert arena.read(0, blk.length) == keys.tobytes()
            view = ex0.node.pd.resolve(blk.mkey, 0, blk.length)
            assert bytes(view) == keys.tobytes()
        assert ln[0].block.checksum == lt[0].block.checksum
    finally:
        io0.stop()
        _io1.stop()


def test_fetch_under_hbm_budget_pressure_spills_and_survives():
    """A tight ``hbm.maxBytes`` forces staged blocks to spill to the host
    tier during a fetch; held buffers stay readable, restore on demand,
    and the budget never exceeds the cap."""
    with _cluster({"tpu.shuffle.hbm.maxBytes": str(64 * 1024)},
                  prefix="tdio-sp") as (conf, driver, ex0, ex1):
        parts = 6
        driver.register_shuffle(BaseShuffleHandle(
            shuffle_id=9, num_maps=2, partitioner=HashPartitioner(parts)))
        io0, io1 = _ios(ex0, ex1)
        rng = np.random.default_rng(5)
        # 12 blocks x 16 KiB class = 192 KiB of staging demand vs 64 KiB
        data = {(m, p): rng.integers(0, 256, 16 * 1024 - 128, dtype=np.uint8)
                for m in range(2) for p in range(parts)}
        try:
            io0.publish_device_blocks(9, {p: data[(0, p)] for p in range(parts)})
            io1.publish_device_blocks(9, {p: data[(1, p)] for p in range(parts)})
            held = io0.fetch_device_blocks(9, 0, parts, timeout_s=60)
            pool = io0.device_buffers
            assert pool.spill_count > 0, "cap of 4 slabs never spilled"
            assert pool.in_use_bytes <= 64 * 1024
            spilled = [b for bufs in held.values() for b in bufs if b.spilled]
            assert spilled, "no held buffer ended up on the host tier"
            for p, got in _blocks(held).items():
                assert got == sorted(data[(m, p)].tobytes() for m in range(2))
            spilled[0].ensure_device()
            assert not spilled[0].spilled
            assert pool.in_use_bytes <= 64 * 1024
            _free_all(held)
            assert pool.in_use_bytes == 0
        finally:
            io0.stop()
            io1.stop()


def test_fetch_fault_surfaces_and_leaks_nothing(cluster, monkeypatch):
    """A READ that fails at the channel surfaces as FetchFailedError and
    both pools drain; a clean retry is byte-exact."""
    conf, driver, ex0, ex1 = cluster
    driver.register_shuffle(BaseShuffleHandle(
        shuffle_id=5, num_maps=2, partitioner=HashPartitioner(4)))
    io0, io1 = _ios(ex0, ex1)
    rng = np.random.default_rng(3)
    try:
        io0.publish_device_blocks(
            5, {p: rng.integers(0, 256, 5000, np.uint8) for p in range(4)})
        io1.publish_device_blocks(
            5, {p: rng.integers(0, 256, 5000, np.uint8) for p in range(4)})
        state = {"remaining": 1}
        lock = threading.Lock()
        original = TpuChannel.read_in_queue

        def flaky(self, listener, dst_views, blocks):
            with lock:
                inject = state["remaining"] > 0
                if inject:
                    state["remaining"] -= 1
            if inject:
                listener.on_failure(ChannelError("injected device-fetch fault"))
                return
            return original(self, listener, dst_views, blocks)

        monkeypatch.setattr(TpuChannel, "read_in_queue", flaky)
        with pytest.raises(FetchFailedError):
            io0.fetch_device_blocks(5, 0, 4, timeout_s=30)
        assert io0.device_buffers.in_use_bytes == 0
        state["remaining"] = 0
        got = io0.fetch_device_blocks(5, 0, 4, timeout_s=30)
        assert sum(len(b) for b in got.values()) == 8
        _free_all(got)
        assert io0.device_buffers.in_use_bytes == 0
    finally:
        io0.stop()
        io1.stop()


def test_fetch_deadline_is_total_not_per_block(cluster, monkeypatch):
    """One slow peer costs at most ONE timeout: four wedged remote
    blocks fail the fetch after about ``timeout_s``, not 4x it."""
    conf, driver, ex0, ex1 = cluster
    driver.register_shuffle(BaseShuffleHandle(
        shuffle_id=11, num_maps=2, partitioner=HashPartitioner(4)))
    io0, io1 = _ios(ex0, ex1)
    rng = np.random.default_rng(7)
    timers = []
    try:
        io0.publish_device_blocks(
            11, {p: rng.integers(0, 256, 5000, np.uint8) for p in range(4)})
        io1.publish_device_blocks(
            11, {p: rng.integers(0, 256, 5000, np.uint8) for p in range(4)})

        def wedged(self, listener, dst_views, blocks):
            t = threading.Timer(30.0, lambda: listener.on_success(None))
            t.daemon = True
            timers.append(t)
            t.start()

        monkeypatch.setattr(TpuChannel, "read_in_queue", wedged)
        t0 = time.perf_counter()
        with pytest.raises(FetchFailedError, match="deadline"):
            io0.fetch_device_blocks(11, 0, 4, timeout_s=1.5)
        wall = time.perf_counter() - t0
        assert wall < 4.0, f"fetch wall {wall:.1f}s — deadline not shared"
        assert io0.device_buffers.in_use_bytes == 0
    finally:
        for t in timers:
            t.cancel()
        io0.stop()
        io1.stop()


def test_fetch_stages_in_arrival_order(cluster, monkeypatch):
    """A delayed block stages LAST: staging follows completions, not
    issue order."""
    conf, driver, ex0, ex1 = cluster
    driver.register_shuffle(BaseShuffleHandle(
        shuffle_id=12, num_maps=1, partitioner=HashPartitioner(4)))
    io0, io1 = _ios(ex0, ex1)
    rng = np.random.default_rng(9)
    slow_len = 7777
    try:
        io1.publish_device_blocks(12, {
            0: rng.integers(0, 256, slow_len, np.uint8),
            **{p: rng.integers(0, 256, 5000, np.uint8) for p in (1, 2, 3)},
        })
        original = TpuChannel.read_in_queue

        def delaying(self, listener, dst_views, blocks):
            if blocks[0][2] == slow_len:
                t = threading.Timer(
                    0.8, lambda: original(self, listener, dst_views, blocks))
                t.daemon = True
                t.start()
                return
            return original(self, listener, dst_views, blocks)

        monkeypatch.setattr(TpuChannel, "read_in_queue", delaying)
        staged_lens = []
        real_stage = io0.device_buffers.stage_view

        def recording(view, valid_len=None, dtype=np.uint8):
            staged_lens.append(valid_len)
            return real_stage(view, valid_len, dtype)

        monkeypatch.setattr(io0.device_buffers, "stage_view", recording)
        got = io0.fetch_device_blocks(12, 0, 4, timeout_s=30)
        assert sum(len(b) for b in got.values()) == 4
        assert staged_lens[-1] == slow_len, staged_lens
        _free_all(got)
    finally:
        io0.stop()
        io1.stop()


def test_mapped_fetch_fault_releases_late_delivery(cluster, monkeypatch):
    """When one mapped read fails and another's delivery arrives after
    the caller abandoned the fetch, the listener (now the last owner)
    releases it."""
    conf, driver, ex0, ex1 = cluster
    driver.register_shuffle(BaseShuffleHandle(
        shuffle_id=13, num_maps=1, partitioner=HashPartitioner(2)))
    io0, io1 = _ios(ex0, ex1)
    rng = np.random.default_rng(21)
    released = threading.Event()
    timers = []

    class FakeDelivery:
        def __init__(self, payload):
            self.views = [memoryview(payload)]
            self.mapped = True

        def release(self):
            released.set()

    try:
        io1.publish_device_blocks(
            13, {p: rng.integers(0, 256, 4000, np.uint8) for p in range(2)})
        calls = {"n": 0}

        def fake_mapped(listener, blocks):
            calls["n"] += 1
            if calls["n"] == 1:
                t = threading.Timer(0.5, lambda: listener.on_success(
                    FakeDelivery(b"z" * blocks[0][2])))
                t.daemon = True
                timers.append(t)
                t.start()
            else:
                listener.on_failure(ChannelError("injected mapped fault"))

        real_get = ex0.get_channel_to

        class MappedOnly:
            def __init__(self, ch):
                self._ch = ch

            def read_mapped_in_queue(self, listener, blocks):
                fake_mapped(listener, blocks)

        monkeypatch.setattr(ex0, "get_channel_to",
                            lambda mid, purpose="rpc": MappedOnly(real_get(mid, purpose)))
        with pytest.raises(FetchFailedError):
            io0.fetch_device_blocks(13, 0, 2, timeout_s=10)
        assert released.wait(5), "late mapped delivery leaked"
        assert io0.device_buffers.in_use_bytes == 0
    finally:
        for t in timers:
            t.cancel()
        io0.stop()
        io1.stop()


def test_unpublish_releases_registered_buffers(cluster):
    conf, driver, ex0, ex1 = cluster
    driver.register_shuffle(BaseShuffleHandle(
        shuffle_id=2, num_maps=1, partitioner=HashPartitioner(1)))
    io0 = DeviceShuffleIO(ex0, device="cpu")
    try:
        io0.publish_device_blocks(2, {0: np.arange(64, dtype=np.uint8)})
        regions = ex0.node.pd.region_count()
        io0.unpublish(2)
        assert io0.device_buffers.in_use_bytes == 0
        # the pooled registered buffer is reused by the next publish
        io0.publish_device_blocks(2, {0: np.arange(64, dtype=np.uint8)})
        assert ex0.node.pd.region_count() == regions
        io0.unpublish(2)
    finally:
        io0.stop()


# ----------------------------------------------------------------------
# the compiled waves' CUDA branch, reached on the CPU
# ----------------------------------------------------------------------
class _FakeWaveLib:
    """Stands in for the built library: each wave-pull entry gathers
    every row of the (src, byte offset, nbytes) table it is handed into
    the zeroed destination stack, so the table itself is under test."""

    def __init__(self):
        self.calls = []

    def _gather(self, table, dst, rows, bucket_bytes):
        t = (ctypes.c_uint64 * (3 * rows)).from_address(table)
        ctypes.memset(dst, 0, rows * bucket_bytes)
        for r in range(rows):
            src, off, nb = t[3 * r], t[3 * r + 1], t[3 * r + 2]
            if nb:
                ctypes.memmove(dst + r * bucket_bytes, src + off, nb)
        return 0

    def srt_wave_pull(self, table, dst, rows_b, bucket_bytes, stream):
        self.calls.append(("srt_wave_pull", rows_b, bucket_bytes))
        return self._gather(table, dst, rows_b, bucket_bytes)

    def srt_pipelined_wave_pull(self, table, dst, depth, rows_b, bucket_bytes,
                                stream):
        self.calls.append(("srt_pipelined_wave_pull", depth, rows_b))
        return self._gather(table, dst, depth * rows_b, bucket_bytes)

    def srt_error_string(self, rc):
        return b"unspecified launch failure"


@contextlib.contextmanager
def _cluster_n(pkg, n, knobs, prefix):
    """A driver and ``n`` executors of one package that each publish one
    uint32 block of 32 KiB and more per partition (above
    ``deviceFetch.minBlockBytes``, so every block is wave-eligible)."""
    conf_cls, mgr_cls, io_cls, h_cls, p_cls = (
        (TpuShuffleConf, TpuShuffleManager,
         lambda ex: DeviceShuffleIO(ex, device="cpu"), BaseShuffleHandle,
         HashPartitioner)
        if pkg == "torch"
        else (JaxConf, JaxManager, JaxIO, JaxHandle, JaxPartitioner)
    )
    conf = conf_cls(dict(PY, **knobs))
    driver = mgr_cls(conf, is_driver=True)
    execs = [mgr_cls(conf, is_driver=False, executor_id=f"{prefix}-{i}")
             for i in range(n)]
    ios = [io_cls(ex) for ex in execs]
    try:
        driver.register_shuffle(h_cls(shuffle_id=8, num_maps=n,
                                      partitioner=p_cls(n)))
        rng = np.random.default_rng(8)
        for io in ios:
            io.publish_device_blocks(8, {
                p: rng.integers(0, 1 << 32, 8192 + 32 * p + int(rng.integers(0, 9)),
                                dtype=np.uint32)
                for p in range(n)
            })
        yield ios
    finally:
        for io in ios:
            io.stop()
        for ex in execs:
            ex.stop()
        driver.stop()


def _landed(got, fused):
    """Each partition's landed bytes: per block, as a multiset (the
    arrival order is free), or the fused slab's bytes in merge order."""
    return {p: [b.read(0, b.length) for b in bufs] if fused
            else sorted(b.read(0, b.length) for b in bufs)
            for p, bufs in got.items()}


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("wave_bytes", ["64m", "64k"])
def test_fetch_launches_wave_kernels_with_jax_bytes(monkeypatch, fused,
                                                     wave_bytes):
    n = 4
    knobs = {"tpu.shuffle.collective.autoTune": "false",
             "tpu.shuffle.collective.waveBytes": wave_bytes}
    with _cluster_n("jax", n, knobs, "wk-jax") as ios:
        got = ios[0].fetch_device_blocks(8, 0, n, dtype=np.uint32,
                                         timeout_s=60, fused=fused)
        want = _landed(got, fused)
        _free_all(got)
    lib = _FakeWaveLib()
    monkeypatch.setattr(ShuffleScheduleCompiler, "_kernel_path",
                        lambda self: True)
    monkeypatch.setattr(trc, "_wave_kernel_path", lambda device: True)
    monkeypatch.setattr(_build, "_on_device",
                        lambda symbol, device: contextlib.nullcontext((lib, 0)))
    with _cluster_n("torch", n, knobs, "wk-torch") as ios:
        _build.reset_launch_counts()
        got = ios[0].fetch_device_blocks(8, 0, n, dtype=np.uint32,
                                         timeout_s=60, fused=fused)
        try:
            # fused: one merged slab per partition in the JAX merge order
            # where a partition fits one wave (64m); at 64k every
            # partition streams through waves of its own, unfused
            assert _landed(got, fused) == want
            if fused and wave_bytes == "64m":
                assert all(len(bufs) == 1 for bufs in got.values())
            assert all(b.array.dtype == torch.uint32
                       for bufs in got.values() for b in bufs)
        finally:
            _free_all(got)
    launched = _build.launches["srt_wave_pull"] + _build.launches["srt_pipelined_wave_pull"]
    assert launched == len(lib.calls) > 0
    if wave_bytes == "64k":
        # pipelined same-class runs at the default depth 2
        assert _build.launches["srt_pipelined_wave_pull"] > 0
    else:
        assert _build.launches["srt_wave_pull"] == 1


# ----------------------------------------------------------------------
# the split-phase host-block API, the tracer hook and the device default
# ----------------------------------------------------------------------
def _split_phase(ios, dtype, corrupt):
    """Executor 0 fetches every partition through fetch_host_blocks,
    verify_host_block and stage_host_block (the reduce pipeline's
    stages), after flipping one byte of each remote buffer block when
    ``corrupt`` (the verify gate then refetches it once)."""
    io0 = ios[0]
    in_use = io0.device_buffers.in_use_bytes  # its published arena copies
    got = io0.fetch_host_blocks(8, 0, len(ios), timeout_s=60, dtype=dtype)
    out = {}
    for p, hbs in got.items():
        for hb in hbs:
            if corrupt and getattr(hb, "kind", "") == "buffer":
                hb.view[0] ^= 0xFF
            dev = io0.stage_host_block(io0.verify_host_block(hb), dtype)
            out.setdefault(p, []).append(dev.read(0, dev.length))
            dev.free()
    assert io0.device_buffers.in_use_bytes == in_use
    return {p: sorted(v) for p, v in out.items()}


@pytest.mark.parametrize("corrupt", [False, True])
@pytest.mark.parametrize("device_fetch", ["true", "false"])
def test_split_phase_host_blocks_match_jax(corrupt, device_fetch):
    knobs = {"tpu.shuffle.collective.autoTune": "false",
             "tpu.shuffle.deviceFetch.enabled": device_fetch}
    with _cluster_n("jax", 3, knobs, "sp-jax") as ios:
        want = _split_phase(ios, np.uint32, corrupt=False)
    retries = get_registry().counter("resilience.retries", role="sp-torch-0")
    r0 = retries.value
    with _cluster_n("torch", 3, knobs, "sp-torch") as ios:
        got = _split_phase(ios, np.uint32, corrupt)
    assert got == want
    # with the device plane off, the 2 remote blocks of each of the 3
    # partitions arrive by READ into pooled buffers; each corrupted one
    # earned exactly one refetch
    assert retries.value - r0 == (6 if corrupt and device_fetch == "false" else 0)


def test_collective_spans_match_jax():
    """DeviceShuffleIO hands the manager's tracer to the compiler: one
    ``shuffle.collective`` span a compiled fetch and one
    ``shuffle.collective.wave`` span a wave, as the JAX compiler records."""
    knobs = {"tpu.shuffle.collective.autoTune": "false",
             "tpu.shuffle.collective.waveBytes": "64k"}
    names = {}
    for pkg in ("jax", "torch"):
        with _cluster_n(pkg, 3, knobs, f"tr-{pkg}") as ios:
            tracer = ios[0]._manager.tracer
            tracer.clear()
            got = ios[0].fetch_device_blocks(8, 0, 3, dtype=np.uint32,
                                             timeout_s=60)
            _free_all(got)
            spans = tracer.spans()
            names[pkg] = sorted(s.name for s in spans
                                if s.name.startswith("shuffle.collective"))
            outer = [s for s in spans if s.name == "shuffle.collective"]
            waves = [s for s in spans if s.name == "shuffle.collective.wave"]
            assert len(outer) == 1 and waves
            assert all(w.parent_id == outer[0].span_id for w in waves)
    assert names["torch"] == names["jax"]


def test_device_default_is_cuda_and_raises_without_a_card(cluster):
    conf, driver, ex0, ex1 = cluster
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default resolves to it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceShuffleIO(ex0)
