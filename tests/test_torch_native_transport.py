"""The port's native (C++) transport: the counterparts of
tests/test_native_transport.py on ``sparkrdma_tpu_torch`` (verb-level
tests, full shuffle e2e, python<->native wire interop, the same-host
file fast path, mapped delivery onto ``device="cpu"`` arenas, the
submission plane), then the cases of the port alone: a round trip
between a port native node, a JAX native node and a port python node;
the library's build location, stamp and failure; the ``auto`` and
``native`` resolution; the buffer backings.

The tests skip only where g++ is absent (``toolchain_available()``),
never on a failed build: a broken ``transport.cpp`` fails them."""

import threading

import pytest
import torch

from sparkrdma_tpu_torch.native.transport_lib import toolchain_available
from sparkrdma_tpu_torch.shuffle.handle import BaseShuffleHandle, HashPartitioner
from sparkrdma_tpu_torch.shuffle.manager import TpuShuffleManager
from sparkrdma_tpu_torch.transport import FnListener
from sparkrdma_tpu_torch.utils.config import TpuShuffleConf

torch.set_num_threads(1)

pytestmark = pytest.mark.skipif(
    not toolchain_available(), reason="g++ absent: the native plane cannot be built"
)


def _native_conf(extra=None):
    return TpuShuffleConf(
        {
            "tpu.shuffle.transport": "native",
            "tpu.shuffle.shuffleWriteBlockSize": "65536",
            "tpu.shuffle.shuffleReadBlockSize": "65536",
            **(extra or {}),
        }
    )


def test_send_read_roundtrip():
    from sparkrdma_tpu_torch.transport.native_node import NativeTpuNode

    conf = TpuShuffleConf()
    got = []
    ev = threading.Event()
    a = NativeTpuNode(conf, "127.0.0.1", False, "a")
    b = NativeTpuNode(
        conf, "127.0.0.1", True, "b",
        recv_listener=lambda ch, p: (got.append(p), ev.set()),
    )
    try:
        ch = a.get_channel("127.0.0.1", b.port)
        done = threading.Event()
        ch.send_in_queue(FnListener(lambda _: done.set()), [b"x" * 10000])
        assert done.wait(5) and ev.wait(5)
        assert got == [b"x" * 10000]

        src = memoryview(bytearray(range(256)) * 64)
        mkey = a.pd.register(src)
        ch_ba = b.get_channel("127.0.0.1", a.port)
        dst = memoryview(bytearray(4096))
        rdone = threading.Event()
        errs = []
        ch_ba.read_in_queue(
            FnListener(lambda _: rdone.set(), errs.append),
            [dst],
            [(mkey, 1024, 4096)],
        )
        assert rdone.wait(5), errs
        assert bytes(dst) == bytes(src[1024:5120])

        # bounds violation -> remote READ error, not silent corruption
        bad = threading.Event()
        failures = []
        ch_ba.read_in_queue(
            FnListener(None, lambda e: (failures.append(e), bad.set())),
            [memoryview(bytearray(8))],
            [(mkey, len(src) - 4, 8)],
        )
        assert bad.wait(5)
        assert "READ failed" in str(failures[0])
    finally:
        a.stop()
        b.stop()


def test_shuffle_e2e_over_native_transport():
    conf = _native_conf()
    driver = TpuShuffleManager(conf, is_driver=True)
    ex0 = TpuShuffleManager(conf, is_driver=False, executor_id="exec-0")
    ex1 = TpuShuffleManager(conf, is_driver=False, executor_id="exec-1")
    try:
        from sparkrdma_tpu_torch.transport.native_node import NativeTpuNode

        assert isinstance(driver.node, NativeTpuNode)
        handle = BaseShuffleHandle(
            shuffle_id=0, num_maps=4, partitioner=HashPartitioner(5)
        )
        driver.register_shuffle(handle)
        expected = {}
        for map_id, ex in [(0, ex0), (1, ex0), (2, ex1), (3, ex1)]:
            recs = [(f"key-{(map_id * 997 + i) % 131}", i) for i in range(2000)]
            for k, v in recs:
                expected.setdefault(k, []).append(v)
            w = ex.get_writer(handle, map_id)
            w.write(iter(recs))
            w.stop(True)
        ex0.finalize_maps(0)
        ex1.finalize_maps(0)
        got = {}
        for ex, (lo, hi) in [(ex0, (0, 3)), (ex1, (3, 5))]:
            reader = ex.get_reader(handle, lo, hi)
            for k, v in reader.read():
                got.setdefault(k, []).append(v)
            assert reader.metrics.remote_blocks > 0
        assert set(got) == set(expected)
        for k in expected:
            assert sorted(got[k]) == sorted(expected[k])
        # the record plane's remote reads rode MAPPED delivery off the
        # publishers' mmap-registered sort files (zero-copy page cache)
        f0, s0 = ex0.node.read_path_stats()
        assert f0 > 0 and s0 == 0, (f0, s0)
    finally:
        ex0.stop()
        ex1.stop()
        driver.stop()


def test_python_native_wire_interop():
    """Same wire format: a pure-Python executor shuffles against a
    native driver + native peer executor."""
    native_conf = _native_conf()
    driver = TpuShuffleManager(native_conf, is_driver=True)
    # python-transport executor inherits the negotiated driver port
    py_conf = TpuShuffleConf(
        {**native_conf.to_dict(), "tpu.shuffle.transport": "python"}
    )
    ex_native = TpuShuffleManager(native_conf, is_driver=False, executor_id="exec-n")
    ex_python = TpuShuffleManager(py_conf, is_driver=False, executor_id="exec-p")
    try:
        handle = BaseShuffleHandle(
            shuffle_id=0, num_maps=2, partitioner=HashPartitioner(2)
        )
        driver.register_shuffle(handle)
        expected = {}
        for map_id, ex in [(0, ex_native), (1, ex_python)]:
            recs = [(f"k{(map_id * 31 + i) % 17}", i) for i in range(500)]
            for k, v in recs:
                expected.setdefault(k, []).append(v)
            w = ex.get_writer(handle, map_id)
            w.write(iter(recs))
            w.stop(True)
        ex_native.finalize_maps(0)
        ex_python.finalize_maps(0)
        got = {}
        for ex, (lo, hi) in [(ex_native, (0, 1)), (ex_python, (1, 2))]:
            for k, v in ex.get_reader(handle, lo, hi).read():
                got.setdefault(k, []).append(v)
        assert set(got) == set(expected)
        for k in expected:
            assert sorted(got[k]) == sorted(expected[k])
    finally:
        ex_native.stop()
        ex_python.stop()
        driver.stop()


def test_peer_loss_detected_natively():
    conf = _native_conf()
    driver = TpuShuffleManager(conf, is_driver=True)
    ex0 = TpuShuffleManager(conf, is_driver=False, executor_id="exec-0")
    try:
        handle = BaseShuffleHandle(
            shuffle_id=0, num_maps=1, partitioner=HashPartitioner(1)
        )
        driver.register_shuffle(handle)
        w = ex0.get_writer(handle, 0)
        w.write(iter([("a", 1)]))
        w.stop(True)
        import time

        deadline = time.monotonic() + 5
        while time.monotonic() < deadline:
            with driver._lock:
                if driver._maps_done.get(0, 0) >= 1:
                    break
            time.sleep(0.02)
        ex0.stop()
        deadline = time.monotonic() + 5
        pruned = False
        while time.monotonic() < deadline:
            with driver._lock:
                locs = [
                    loc
                    for v in driver._partition_locations[0].values()
                    for loc in v
                ]
            if not locs:
                pruned = True
                break
            time.sleep(0.02)
        assert pruned, "driver did not prune lost native peer"
    finally:
        driver.stop()


def test_peer_death_fails_send_and_read_listeners():
    """Regression: a dying peer must fail every outstanding WR listener
    (queued sends included) — never orphan them."""
    import time

    from sparkrdma_tpu_torch.transport.native_node import NativeTpuNode

    conf = TpuShuffleConf()
    a = NativeTpuNode(conf, "127.0.0.1", False, "death-a")
    b = NativeTpuNode(conf, "127.0.0.1", True, "death-b")
    ch = a.get_channel("127.0.0.1", b.port)
    src = memoryview(bytes(1024))
    b.pd.register(src)
    b.stop()  # peer dies

    failures = []
    fired = threading.Event()
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline:
        ch.send_in_queue(
            FnListener(None, lambda e: (failures.append(e), fired.set())),
            [b"late"],
        )
        if fired.wait(0.3):
            break
    assert fired.is_set(), "send listener orphaned after peer death"
    a.stop()


def test_read_bounds_wraparound_rejected():
    """Regression: addr+len overflow in the native bounds check must be
    rejected as a remote error, not served from a wild pointer."""
    from sparkrdma_tpu_torch.transport.native_node import NativeTpuNode

    conf = TpuShuffleConf()
    a = NativeTpuNode(conf, "127.0.0.1", False, "wrap-a")
    b = NativeTpuNode(conf, "127.0.0.1", True, "wrap-b")
    try:
        src = memoryview(bytes(1024))
        mkey = a.pd.register(src)
        ch = b.get_channel("127.0.0.1", a.port)
        failures = []
        fired = threading.Event()
        ch.read_in_queue(
            FnListener(None, lambda e: (failures.append(e), fired.set())),
            [memoryview(bytearray(32))],
            [(mkey, (1 << 64) - 16, 32)],
        )
        assert fired.wait(5), "wraparound read neither failed nor completed"
        assert "READ failed" in str(failures[0]) or "resolve" in str(failures[0])
    finally:
        b.stop()
        a.stop()


def test_same_host_file_fast_path():
    """shm-backed registered buffers are served via the same-host pread
    fast path (READ_REQ2 -> READ_FILE): data must be byte-identical and
    the streamed fallback must still work for anonymous regions."""
    from sparkrdma_tpu_torch.memory.buffer import TpuBuffer
    from sparkrdma_tpu_torch.transport.native_node import NativeTpuNode

    conf = TpuShuffleConf()
    a = NativeTpuNode(conf, "127.0.0.1", False, "fp-srv")
    b = NativeTpuNode(conf, "127.0.0.1", True, "fp-cli")
    try:
        buf = TpuBuffer(a.pd, 1 << 20, register=True)
        assert buf._shm_path is not None, "pool buffer should be shm-backed"
        import numpy as np

        src = np.random.default_rng(7).integers(
            0, 256, size=1 << 20, dtype=np.uint8
        )
        np.frombuffer(buf.view, dtype=np.uint8)[:] = src

        ch = b.get_channel("127.0.0.1", a.port)
        dst = memoryview(bytearray(65536))
        done = threading.Event()
        errs = []
        ch.read_in_queue(
            FnListener(lambda _: done.set(), lambda e: (errs.append(e), done.set())),
            [dst],
            [(buf.mkey, 12345, 65536)],
        )
        assert done.wait(5), errs
        assert not errs, errs
        assert bytes(dst) == src[12345 : 12345 + 65536].tobytes()
        # provably served by the pread fast path, not streamed (the
        # mutable-slab identity must keep the fast path alive even
        # though the slab was written AFTER registration)
        assert b.read_path_stats() == (1, 0)

        # multi-block read spanning file-backed + file-backed
        dst2 = [memoryview(bytearray(1000)), memoryview(bytearray(2000))]
        done2 = threading.Event()
        ch.read_in_queue(
            FnListener(lambda _: done2.set(), lambda e: (errs.append(e), done2.set())),
            dst2,
            [(buf.mkey, 0, 1000), (buf.mkey, 500000, 2000)],
        )
        assert done2.wait(5), errs
        assert not errs, errs
        assert bytes(dst2[0]) == src[:1000].tobytes()
        assert bytes(dst2[1]) == src[500000:502000].tobytes()

        # anonymous region on the same channel: server must fall back to
        # streaming (mixed region kinds never corrupt)
        anon = memoryview(bytes(range(256)) * 16)
        mkey2 = a.pd.register(anon)
        dst3 = memoryview(bytearray(4096))
        done3 = threading.Event()
        ch.read_in_queue(
            FnListener(lambda _: done3.set(), lambda e: (errs.append(e), done3.set())),
            [dst3],
            [(mkey2, 0, 4096)],
        )
        assert done3.wait(5), errs
        assert not errs, errs
        assert bytes(dst3) == bytes(anon)
        # 3 fast-path completions: the single READ plus one per block of
        # the aligned multi-block read (posted as one request per block)
        file_reads, streamed_reads = b.read_path_stats()
        assert file_reads == 3 and streamed_reads == 1

        # freed buffer -> unlinked file + dereg -> late READ errors out
        buf.free()
        failures = []
        fired = threading.Event()
        ch.read_in_queue(
            FnListener(None, lambda e: (failures.append(e), fired.set())),
            [memoryview(bytearray(16))],
            [(buf.mkey, 0, 16)],
        )
        assert fired.wait(5), "read of freed region neither failed nor completed"
    finally:
        b.stop()
        a.stop()


def test_mapped_file_served_via_file_fast_path(tmp_path):
    """A registered mapped shuffle file advertises its real path; a
    same-host native peer preads it from page cache."""
    from sparkrdma_tpu_torch.memory.mapped_file import MappedFile
    from sparkrdma_tpu_torch.transport.native_node import NativeTpuNode

    conf = TpuShuffleConf()
    a = NativeTpuNode(conf, "127.0.0.1", False, "mf-srv")
    b = NativeTpuNode(conf, "127.0.0.1", True, "mf-cli")
    try:
        import numpy as np

        data = np.random.default_rng(11).integers(
            0, 256, size=200_000, dtype=np.uint8
        ).tobytes()
        path = tmp_path / "shuffle.data"
        path.write_bytes(data)
        mf = MappedFile(str(path), a.pd, block_size=65536, partition_lengths=[120_000, 80_000])

        ch = b.get_channel("127.0.0.1", a.port)
        loc = mf.get_partition_location(1)
        dst = memoryview(bytearray(loc.length))
        done = threading.Event()
        errs = []
        ch.read_in_queue(
            FnListener(lambda _: done.set(), lambda e: (errs.append(e), done.set())),
            [dst],
            [(loc.mkey, loc.address, loc.length)],
        )
        assert done.wait(5), errs
        assert not errs, errs
        assert bytes(dst) == data[120_000:200_000]
        mf.dispose()
    finally:
        b.stop()
        a.stop()


def test_rpc_data_channel_split_no_hol_blocking():
    """RPC vs DATA channel flavors (RdmaChannel.java:110-154): a small
    control round-trip completes while the data channel is continuously
    saturated with in-flight READs, because they ride separate
    connections. READs are re-posted until the reply lands, so the data
    plane is provably busy for the whole RPC round trip."""
    from sparkrdma_tpu_torch.transport.native_node import NativeTpuNode

    conf = TpuShuffleConf()
    rpc_reply = threading.Event()

    def server_recv(ch, payload):
        # echo back: the location-fetch request/response analogue
        ch.send_in_queue(None, [b"locs:" + payload])

    def client_recv(ch, payload):
        rpc_reply.set()

    a = NativeTpuNode(conf, "127.0.0.1", False, "hol-srv", recv_listener=server_recv)
    b = NativeTpuNode(conf, "127.0.0.1", True, "hol-cli", recv_listener=client_recv)
    try:
        ch_data = b.get_channel("127.0.0.1", a.port, purpose="data")
        ch_rpc = b.get_channel("127.0.0.1", a.port, purpose="rpc")
        # distinct connections per purpose (cached separately)
        assert ch_data is not ch_rpc
        assert ch_data.channel_id != ch_rpc.channel_id
        assert b.get_channel("127.0.0.1", a.port, purpose="data") is ch_data

        # 8 MiB registered region, streamed (no file hint -> no pread
        # fast path); 4 READ slots that repost on completion so the
        # data channel never idles until the rpc reply is observed
        from transport_harness import saturate_reads_until

        src = memoryview(bytearray(8 << 20))
        src[: 1 << 16] = bytes(range(256)) * 256
        mkey = a.pd.register(src)
        read_errs = []
        drained = threading.Event()
        dsts = [memoryview(bytearray(8 << 20)) for _ in range(4)]
        finish = saturate_reads_until(
            ch_data, mkey, 8 << 20, dsts, rpc_reply, read_errs, drained
        )
        # location-fetch round trip on the rpc channel while READs
        # saturate the data channel: must complete promptly, not once
        # the data stream goes idle
        ch_rpc.send_in_queue(None, [b"fetch-partition-locations"])
        assert rpc_reply.wait(10.0), "rpc starved behind in-flight data READs"
        finish()
        assert drained.wait(30), read_errs
        assert not read_errs, read_errs
        assert bytes(dsts[0][: 1 << 16]) == bytes(src[: 1 << 16])
    finally:
        b.stop()
        a.stop()


def test_file_fast_path_rejects_recreated_file(tmp_path):
    """A shuffle file unlinked and rewritten at the same path (task
    re-attempt) between registration and the client's pread must NOT
    serve the new file's bytes: the READ_FILE answer carries the
    registration-time (st_dev, st_ino) and the client falls back to
    streaming on mismatch, still yielding the registered bytes."""
    import os

    from sparkrdma_tpu_torch.transport.native_node import NativeTpuNode

    conf = TpuShuffleConf()
    a = NativeTpuNode(conf, "127.0.0.1", False, "inode-srv")
    b = NativeTpuNode(conf, "127.0.0.1", True, "inode-cli")
    try:
        old = bytes([i % 251 for i in range(200_000)])
        path = tmp_path / "attempt0.data"
        path.write_bytes(old)
        # region memory holds the ORIGINAL bytes (mmap analogue: the
        # registered view outlives the directory entry)
        src = memoryview(bytearray(old))
        mkey = a.pd.register(src, file_path=str(path), file_offset=0)

        # task re-attempt rewrites the same path with different bytes
        os.unlink(path)
        path.write_bytes(bytes([(i * 7 + 3) % 251 for i in range(200_000)]))

        ch = b.get_channel("127.0.0.1", a.port, purpose="data")
        dst = memoryview(bytearray(200_000))
        done = threading.Event()
        errs = []
        ch.read_in_queue(
            FnListener(lambda _: done.set(), lambda e: (errs.append(e), done.set())),
            [dst],
            [(mkey, 0, 200_000)],
        )
        assert done.wait(10), "read never completed"
        assert not errs, errs
        assert bytes(dst) == old, (
            "recreated file at the registered path leaked its bytes into "
            "a READ of the original region"
        )
        # the identity mismatch must have forced the streamed fallback
        file_reads, streamed_reads = b.read_path_stats()
        assert file_reads == 0 and streamed_reads == 1
    finally:
        b.stop()
        a.stop()


def test_mapped_read_zero_copy_and_fallback():
    """srt_post_read_mapped delivers same-host file-backed blocks as
    zero-copy page-cache mappings and unbacked regions as one copied
    blob; bytes byte-exact either way, release() idempotent."""
    import numpy as np

    from sparkrdma_tpu_torch.memory.buffer import TpuBuffer
    from sparkrdma_tpu_torch.transport.native_node import NativeTpuNode

    conf = TpuShuffleConf()
    srv = NativeTpuNode(conf, "127.0.0.1", False, "map-srv")
    cli = NativeTpuNode(conf, "127.0.0.1", True, "map-cli")
    try:
        rng = np.random.default_rng(11)
        buf = TpuBuffer(srv.pd, 300_000, register=True)  # shm-backed
        src = rng.integers(0, 256, 300_000, np.uint8)
        np.frombuffer(buf.view, np.uint8)[:] = src
        ch = cli.get_channel("127.0.0.1", srv.port, purpose="data")

        def mapped_read(blocks):
            box, ev = {}, threading.Event()
            ch.read_mapped_in_queue(
                FnListener(
                    lambda d: (box.update(d=d), ev.set()),
                    lambda e: (box.update(e=e), ev.set()),
                ),
                blocks,
            )
            assert ev.wait(10), "mapped read timed out"
            assert "e" not in box, box.get("e")
            return box["d"]

        # same-host, file-backed, odd offset -> zero-copy mmap
        d = mapped_read([(buf.mkey, 1003, 50_000)])
        assert d.mapped, "expected the mmap path"
        assert bytes(d.views[0]) == src[1003:51_003].tobytes()
        d.release()
        d.release()  # idempotent
        assert cli.read_path_stats()[0] == 1  # counted as fast-path read

        # unbacked region, two blocks -> streamed fallback blob
        anon = rng.integers(0, 256, 100_000, np.uint8)
        mk2 = srv.pd.register(memoryview(anon.data))
        d2 = mapped_read([(mk2, 5, 60_000), (mk2, 70_000, 20_000)])
        assert not d2.mapped
        assert bytes(d2.views[0]) == anon[5:60_005].tobytes()
        assert bytes(d2.views[1]) == anon[70_000:90_000].tobytes()
        d2.release()
        assert cli.read_path_stats()[1] == 1  # streamed fallback counted
    finally:
        cli.stop()
        srv.stop()


def test_streamed_read_of_file_backed_region_uses_sendfile_path():
    """fileFastPath=false forces the streamed plane even for file-backed
    regions; the server then serves them via sendfile (kernel zero-copy)
    with the pinned-memory path as silent fallback — either way the
    bytes must be exact and the read counted as streamed. Loopback
    peers normally skip sendfile (measured slower without a DMA NIC);
    forceSendfile exercises the mechanism itself."""
    import numpy as np

    from sparkrdma_tpu_torch.memory.buffer import TpuBuffer
    from sparkrdma_tpu_torch.transport.native_node import NativeTpuNode

    srv = NativeTpuNode(
        TpuShuffleConf({"tpu.shuffle.forceSendfile": "true"}),
        "127.0.0.1", False, "sf-srv",
    )
    cli = NativeTpuNode(
        TpuShuffleConf({"tpu.shuffle.fileFastPath": "false"}),
        "127.0.0.1", True, "sf-cli",
    )
    try:
        rng = np.random.default_rng(13)
        buf = TpuBuffer(srv.pd, 1 << 20, register=True)
        src = rng.integers(0, 256, 1 << 20, np.uint8)
        np.frombuffer(buf.view, np.uint8)[:] = src
        ch = cli.get_channel("127.0.0.1", srv.port, purpose="data")
        dst = memoryview(bytearray(500_000))
        done, errs = threading.Event(), []
        ch.read_in_queue(
            FnListener(lambda _: done.set(), lambda e: (errs.append(e), done.set())),
            [dst],
            [(buf.mkey, 7777, 500_000)],
        )
        assert done.wait(10) and not errs, errs
        assert bytes(dst) == src[7777 : 7777 + 500_000].tobytes()
        f, s = cli.read_path_stats()
        assert f == 0 and s == 1, (f, s)
    finally:
        cli.stop()
        srv.stop()


def test_device_fetch_uses_mapped_delivery_cross_process():
    """fetch_device_blocks on the native transport stages straight from
    mapped page-cache windows (no pooled destination buffer): the fetch
    must be byte-exact and counted as fast-path reads."""
    import numpy as np

    from sparkrdma_tpu_torch.shuffle.device_io import DeviceShuffleIO

    # device plane off: same-process arenas are mesh-visible, so HBM
    # pulls would short-circuit the mapped-delivery path under test
    conf = _native_conf({"tpu.shuffle.deviceFetch.enabled": "false"})
    driver = TpuShuffleManager(conf, is_driver=True)
    ex0 = TpuShuffleManager(conf, is_driver=False, executor_id="map-0")
    ex1 = TpuShuffleManager(conf, is_driver=False, executor_id="map-1")
    driver.register_shuffle(
        BaseShuffleHandle(shuffle_id=61, num_maps=1, partitioner=HashPartitioner(3))
    )
    io0, io1 = DeviceShuffleIO(ex0, device="cpu"), DeviceShuffleIO(ex1, device="cpu")
    rng = np.random.default_rng(5)
    data = {p: rng.integers(0, 256, 40_000 + p * 1000, np.uint8) for p in range(3)}
    try:
        io1.publish_device_blocks(61, data)
        got = io0.fetch_device_blocks(61, 0, 3, timeout_s=30)
        for p in range(3):
            assert bytes(got[p][0].read(0, len(data[p]))) == data[p].tobytes()
        f, s = ex0.node.read_path_stats()
        assert f == 3 and s == 0, (f, s)
        for bufs in got.values():
            for b in bufs:
                b.free()
    finally:
        io0.stop()
        io1.stop()
        ex0.stop()
        ex1.stop()
        driver.stop()


def test_mapped_fetch_under_hbm_pressure_spills_and_survives():
    """Mapped delivery + tight HBM budget: staged slabs spill to the
    host tier DURING a mapped fetch; bytes stay exact from any tier
    and the budget never exceeds the cap (the tiered-store guarantees
    must hold regardless of delivery mechanism)."""
    import numpy as np

    from sparkrdma_tpu_torch.shuffle.device_io import DeviceShuffleIO

    conf = _native_conf({"tpu.shuffle.hbm.maxBytes": str(64 * 1024)})
    driver = TpuShuffleManager(conf, is_driver=True)
    ex0 = TpuShuffleManager(conf, is_driver=False, executor_id="mp-0")
    ex1 = TpuShuffleManager(conf, is_driver=False, executor_id="mp-1")
    parts = 6
    driver.register_shuffle(
        BaseShuffleHandle(
            shuffle_id=71, num_maps=1, partitioner=HashPartitioner(parts)
        )
    )
    io0, io1 = DeviceShuffleIO(ex0, device="cpu"), DeviceShuffleIO(ex1, device="cpu")
    rng = np.random.default_rng(7)
    data = {
        p: rng.integers(0, 256, 16 * 1024 - 64, np.uint8) for p in range(parts)
    }
    try:
        io1.publish_device_blocks(71, data)
        held = io0.fetch_device_blocks(71, 0, parts, timeout_s=60)
        pool = io0.device_buffers
        assert pool.spill_count > 0, "tight cap never spilled"
        assert pool.in_use_bytes <= 64 * 1024
        # every mapped-fetched block byte-exact, whichever tier holds it
        for p in range(parts):
            got = held[p][0].read(0, len(data[p]))
            assert got == data[p].tobytes(), f"partition {p} differs"
        # and the reads took the mapped fast path
        f, s = ex0.node.read_path_stats()
        assert f == parts and s == 0
        for bufs in held.values():
            for b in bufs:
                b.free()
        assert pool.in_use_bytes == 0
    finally:
        io0.stop()
        io1.stop()
        ex0.stop()
        ex1.stop()
        driver.stop()


def test_multiblock_file_read_splits_across_workers():
    """A single READ naming several file-backed blocks fans its preads
    over the worker pool (the WR-list striping analogue): one combined
    destination, one completion, bytes exact, counted as ONE fast-path
    read."""
    import numpy as np

    from sparkrdma_tpu_torch.memory.buffer import TpuBuffer
    from sparkrdma_tpu_torch.transport.native_node import NativeTpuNode

    srv = NativeTpuNode(TpuShuffleConf(), "127.0.0.1", False, "split-srv")
    cli = NativeTpuNode(
        TpuShuffleConf({"tpu.shuffle.fileWorkers": "4"}),
        "127.0.0.1", True, "split-cli",
    )
    try:
        rng = np.random.default_rng(23)
        buf = TpuBuffer(srv.pd, 16 << 20, register=True)
        src = rng.integers(0, 256, 16 << 20, np.uint8)
        np.frombuffer(buf.view, np.uint8)[:] = src
        ch = cli.get_channel("127.0.0.1", srv.port, purpose="data")
        # one dst covering three discontiguous blocks totalling > 4 MiB
        # (the split floor) -> the scatter path posts ONE multi-block
        # read -> one byte-balanced split file task
        blocks = [(buf.mkey, 0, 3 << 20), (buf.mkey, 4 << 20, 5 << 20),
                  (buf.mkey, 10 << 20, 2 << 20)]
        total = sum(b[2] for b in blocks)
        dst = memoryview(bytearray(total))
        done, errs = threading.Event(), []
        ch.read_in_queue(
            FnListener(lambda _: done.set(), lambda e: (errs.append(e), done.set())),
            [dst],
            blocks,
        )
        assert done.wait(10) and not errs, errs
        want = b"".join(src[a:a+l].tobytes() for _mk, a, l in blocks)
        assert bytes(dst) == want, "split multi-block read bytes differ"
        f, s = cli.read_path_stats()
        assert f == 1 and s == 0, (f, s)
        # the split actually engaged (not just the whole-task path)
        assert cli.split_parts() >= 2, cli.split_parts()
    finally:
        cli.stop()
        srv.stop()


def test_single_block_pread_stripes_across_workers():
    """ONE fat block (the common single-partition fetch) is expanded
    into contiguous sub-ranges so its pread spreads over file_workers
    threads instead of riding one: bytes exact, one fast-path read,
    stripe counter engaged."""
    import numpy as np

    from sparkrdma_tpu_torch.memory.buffer import TpuBuffer
    from sparkrdma_tpu_torch.transport.native_node import NativeTpuNode

    srv = NativeTpuNode(TpuShuffleConf(), "127.0.0.1", False, "stripe-srv")
    cli = NativeTpuNode(
        TpuShuffleConf({"tpu.shuffle.fileWorkers": "4"}),
        "127.0.0.1", True, "stripe-cli",
    )
    try:
        rng = np.random.default_rng(29)
        buf = TpuBuffer(srv.pd, 8 << 20, register=True)
        src = rng.integers(0, 256, 8 << 20, np.uint8)
        np.frombuffer(buf.view, np.uint8)[:] = src
        ch = cli.get_channel("127.0.0.1", srv.port, purpose="data")
        # one 8 MiB block: above the 4 MiB stripe floor, enough for
        # >= 2 sub-ranges of >= 1 MiB each across 4 workers
        dst = memoryview(bytearray(8 << 20))
        done, errs = threading.Event(), []
        ch.read_in_queue(
            FnListener(lambda _: done.set(), lambda e: (errs.append(e), done.set())),
            [dst],
            [(buf.mkey, 0, 8 << 20)],
        )
        assert done.wait(10) and not errs, errs
        assert bytes(dst) == src.tobytes(), "striped single-block bytes differ"
        f, s = cli.read_path_stats()
        assert f == 1 and s == 0, (f, s)
        assert cli.block_stripes() >= 2, cli.block_stripes()
        # the byte-balanced split then fans the sub-ranges out as parts
        assert cli.split_parts() >= 2, cli.split_parts()
    finally:
        cli.stop()
        srv.stop()

def _read_into(ch, mkey, off, length, timeout=15):
    dst = memoryview(bytearray(length))
    done, errs = threading.Event(), []
    ch.read_in_queue(
        FnListener(lambda _: done.set(), lambda e: (errs.append(e), done.set())),
        [dst],
        [(mkey, off, length)],
    )
    assert done.wait(timeout), "read timed out"
    assert not errs, errs
    return dst


def test_read_backend_byte_identity_across_backends():
    """Acceptance gate for the submission plane (DESIGN.md §24): every
    backend — auto, iouring, pread, mapped-copy — returns byte-identical
    data for the same read set, including a striped >4 MiB block and an
    unaligned offset; where io_uring is absent the iouring request
    degrades to pread with the SAME bytes."""
    import numpy as np

    from sparkrdma_tpu_torch.memory.buffer import TpuBuffer
    from sparkrdma_tpu_torch.transport.native_node import NativeTpuNode

    srv = NativeTpuNode(TpuShuffleConf(), "127.0.0.1", False, "bk-srv")
    cli = NativeTpuNode(TpuShuffleConf(), "127.0.0.1", True, "bk-cli")
    try:
        rng = np.random.default_rng(31)
        size = 6 << 20
        buf = TpuBuffer(srv.pd, size, register=True)
        src = rng.integers(0, 256, size, np.uint8)
        np.frombuffer(buf.view, np.uint8)[:] = src
        ch = cli.get_channel("127.0.0.1", srv.port, purpose="data")
        blocks = [(1003, 50_000), (0, 5 << 20), (5 << 20, 1 << 20)]
        n_reads = 0
        for backend in ("auto", "iouring", "pread", "mapped"):
            cli.set_read_backend(backend)
            for off, ln in blocks:
                got = _read_into(ch, buf.mkey, off, ln)
                assert bytes(got) == src[off:off + ln].tobytes(), backend
                n_reads += 1
        stats = cli.sq_stats()
        # every read went through the plane: one submit+completion per
        # resolved run, at least one run per read, batches counted
        assert stats["completions"] >= n_reads, stats
        assert stats["submits"] >= stats["completions"], stats
        assert stats["batches"] >= 1, stats
        f, s = cli.read_path_stats()
        assert f == n_reads and s == 0, (f, s)
        buf.free()
    finally:
        cli.stop()
        srv.stop()


def test_iouring_forced_enosys_falls_back_counted():
    """force_uring_probe_fail makes the availability probe behave like
    an ENOSYS kernel: reads degrade to pread byte-identically,
    transport.sq.backend_fallbacks ticks exactly once for the latch,
    and clearing the seam un-latches auto-detection."""
    import numpy as np

    from sparkrdma_tpu_torch.memory.buffer import TpuBuffer
    from sparkrdma_tpu_torch.transport.native_node import NativeTpuNode

    srv = NativeTpuNode(TpuShuffleConf(), "127.0.0.1", False, "en-srv")
    cli = NativeTpuNode(TpuShuffleConf(), "127.0.0.1", True, "en-cli")
    try:
        rng = np.random.default_rng(37)
        buf = TpuBuffer(srv.pd, 1 << 20, register=True)
        src = rng.integers(0, 256, 1 << 20, np.uint8)
        np.frombuffer(buf.view, np.uint8)[:] = src
        ch = cli.get_channel("127.0.0.1", srv.port, purpose="data")

        cli.force_uring_probe_fail(True)
        # first probe (sq_stats resolves the effective backend) latches
        # the forced-ENOSYS state and counts the fallback once
        assert cli.sq_stats()["backend"] == "pread"
        assert cli.sq_stats()["backend_fallbacks"] == 1
        got = _read_into(ch, buf.mkey, 12345, 500_000)
        assert bytes(got) == src[12345:512_345].tobytes()
        # the latch counts ONCE, not per read
        assert cli.sq_stats()["backend_fallbacks"] == 1

        cli.force_uring_probe_fail(False)
        stats = cli.sq_stats()
        if stats["uring_compiled"] and stats["backend"] == "iouring":
            # real kernel support: auto-detection recovered and the
            # uring plane serves the same bytes
            got2 = _read_into(ch, buf.mkey, 12345, 500_000)
            assert bytes(got2) == src[12345:512_345].tobytes()
        buf.free()
    finally:
        cli.stop()
        srv.stop()


def test_read_enosys_fault_seam():
    """The ``read:enosys`` fault kind (testing/faults.py) drives the
    same degradation through the fault grammar: the probe latches
    unavailable, the read itself proceeds and the bytes are untouched."""
    import numpy as np

    from sparkrdma_tpu_torch.memory.buffer import TpuBuffer
    from sparkrdma_tpu_torch.testing import faults
    from sparkrdma_tpu_torch.transport.native_node import NativeTpuNode

    srv = NativeTpuNode(TpuShuffleConf(), "127.0.0.1", False, "fe-srv")
    cli = NativeTpuNode(TpuShuffleConf(), "127.0.0.1", True, "fe-cli")
    try:
        rng = np.random.default_rng(41)
        buf = TpuBuffer(srv.pd, 1 << 20, register=True)
        src = rng.integers(0, 256, 1 << 20, np.uint8)
        np.frombuffer(buf.view, np.uint8)[:] = src
        ch = cli.get_channel("127.0.0.1", srv.port, purpose="data")
        with faults.installed("read:enosys:1") as plan:
            got = _read_into(ch, buf.mkey, 777, 300_000)
            assert bytes(got) == src[777:300_777].tobytes()
            assert plan.injected_count("read", "enosys") == 1
        stats = cli.sq_stats()
        assert stats["backend"] == "pread", stats
        assert stats["backend_fallbacks"] >= 1, stats
        # the plan is spent: later reads are untouched and identical
        got2 = _read_into(ch, buf.mkey, 0, 1 << 20)
        assert bytes(got2) == src.tobytes()
        buf.free()
    finally:
        cli.stop()
        srv.stop()


def test_consume_sharded_lanes_bytes_and_errors():
    """consumeWorkers > 1 shards READ_DONE completion work across lane
    threads (DESIGN.md §24): bytes stay identical, completions for one
    channel keep arriving (buffer and mapped flavors both), failure
    completions still surface after peer death, and stop() drains the
    lanes without orphaning listeners."""
    import numpy as np

    from sparkrdma_tpu_torch.memory.buffer import TpuBuffer
    from sparkrdma_tpu_torch.transport.native_node import NativeTpuNode

    srv = NativeTpuNode(TpuShuffleConf(), "127.0.0.1", False, "cw-srv")
    cli = NativeTpuNode(
        TpuShuffleConf({"tpu.shuffle.native.consumeWorkers": "3"}),
        "127.0.0.1", True, "cw-cli",
    )
    try:
        assert cli.sq_stats()["consume_workers"] == 3
        rng = np.random.default_rng(43)
        size = 4 << 20
        buf = TpuBuffer(srv.pd, size, register=True)
        src = rng.integers(0, 256, size, np.uint8)
        np.frombuffer(buf.view, np.uint8)[:] = src
        chans = [
            cli.get_channel("127.0.0.1", srv.port, purpose=f"data-{j}")
            for j in range(3)
        ]
        # many outstanding reads spread over the lanes; record the
        # thread each completion ran on to prove the lanes engaged
        n = 24
        block = size // n
        dsts = [memoryview(bytearray(block)) for _ in range(n)]
        evs, errs, lane_threads = [], [], set()
        for i in range(n):
            ev = threading.Event()

            def ok(_, ev=ev):
                lane_threads.add(threading.current_thread().name)
                ev.set()

            def fail(e, ev=ev):
                errs.append(e)
                ev.set()

            chans[i % 3].read_in_queue(
                FnListener(ok, fail),
                [dsts[i]], [(buf.mkey, i * block, block)],
            )
            evs.append(ev)
        for ev in evs:
            assert ev.wait(15), "sharded-consume read timed out"
        assert not errs, errs
        for i in range(n):
            assert bytes(dsts[i]) == src[i * block:(i + 1) * block].tobytes()
        assert any(t.startswith("srt-consume-") for t in lane_threads), (
            "no completion ran on a consume lane", lane_threads)

        # mapped delivery rides the same lanes
        box, mev = {}, threading.Event()
        chans[0].read_mapped_in_queue(
            FnListener(lambda d: (box.update(d=d), mev.set()),
                       lambda e: (box.update(e=e), mev.set())),
            [(buf.mkey, 1003, 100_000)],
        )
        assert mev.wait(15) and "e" not in box, box.get("e")
        assert bytes(box["d"].views[0]) == src[1003:101_003].tobytes()
        box["d"].release()

        # failure completions still surface through the sharded plane
        import time

        srv.stop()
        fired = threading.Event()
        failures = []
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline and not fired.is_set():
            chans[1].read_in_queue(
                FnListener(None, lambda e: (failures.append(e), fired.set())),
                [memoryview(bytearray(16))],
                [(buf.mkey, 0, 16)],
            )
            fired.wait(0.3)
        assert fired.is_set(), "failure listener orphaned under sharded consume"
    finally:
        cli.stop()
        srv.stop()


# ----------------------------------------------------------------------
# the port alone: interop with the JAX plane, the build, the backings


def test_port_native_jax_native_port_python_round_trip():
    """A port native node, a JAX native node and a port python node:
    SEND and one-sided READ in every direction on seeded numpy bytes,
    byte-identical, and the two native nodes count the same read paths
    (the other native node's shm slab by the same-host file fast path,
    the python node's anonymous region streamed)."""
    import numpy as np

    from sparkrdma_tpu.memory.buffer import TpuBuffer as JaxBuffer
    from sparkrdma_tpu.transport import FnListener as JaxListener
    from sparkrdma_tpu.transport.native_node import NativeTpuNode as JaxNative
    from sparkrdma_tpu.utils.config import TpuShuffleConf as JaxConf
    from sparkrdma_tpu_torch.memory.buffer import TpuBuffer
    from sparkrdma_tpu_torch.transport.native_node import NativeTpuNode
    from sparkrdma_tpu_torch.transport.node import TpuNode

    rng = np.random.default_rng(16)
    size = 256 * 1024
    names = ("port-native", "jax-native", "port-python")
    got = {n: [] for n in names}
    recv = {n: threading.Event() for n in names}

    def on_recv(name):
        def f(ch, payload):
            got[name].append(bytes(payload))
            if len(got[name]) == 2:
                recv[name].set()
        return f

    nodes = {
        "port-native": NativeTpuNode(
            TpuShuffleConf(), "127.0.0.1", True, names[0],
            recv_listener=on_recv(names[0])),
        "jax-native": JaxNative(
            JaxConf(), "127.0.0.1", True, names[1],
            recv_listener=on_recv(names[1])),
        "port-python": TpuNode(
            TpuShuffleConf({"tpu.shuffle.transport": "python"}), "127.0.0.1",
            True, names[2], recv_listener=on_recv(names[2])),
    }
    bufs, src = {}, {}
    try:
        for n in names:
            cls = JaxBuffer if n == "jax-native" else TpuBuffer
            bufs[n] = cls(nodes[n].pd, size, register=True)
            src[n] = rng.integers(0, 256, size, np.uint8)
            np.frombuffer(bufs[n].view, np.uint8)[:] = src[n]
        assert bufs["port-native"]._shm_path is not None
        assert bufs["jax-native"]._shm_path is not None
        assert bufs["port-python"]._shm_path is None
        for dst in names:
            for s in names:
                if s == dst:
                    continue
                ch = nodes[dst].get_channel("127.0.0.1", nodes[s].port)
                off, n = 4097 + 13 * names.index(s), 100_003
                out = memoryview(bytearray(n))
                done, errs = threading.Event(), []
                listener = (JaxListener if dst == "jax-native" else FnListener)(
                    lambda _: done.set(), lambda e: (errs.append(e), done.set()))
                ch.read_in_queue(listener, [out], [(bufs[s].mkey, off, n)])
                assert done.wait(15) and not errs, (dst, s, errs)
                assert bytes(out) == src[s][off:off + n].tobytes(), (dst, s)
                msg = rng.integers(0, 256, 70_000 + names.index(dst),
                                   np.uint8).tobytes() + dst.encode()
                sent = threading.Event()
                ch.send_in_queue(
                    (JaxListener if dst == "jax-native" else FnListener)(
                        lambda _: sent.set()),
                    [msg])
                assert sent.wait(15)
                src.setdefault(("msg", s), []).append(msg)
        for n in names:
            assert recv[n].wait(15), n
            assert sorted(got[n]) == sorted(src[("msg", n)]), n
        assert nodes["port-native"].read_path_stats() == (1, 1)
        assert nodes["jax-native"].read_path_stats() == (1, 1)
    finally:
        for b in bufs.values():
            b.free()
        for node in nodes.values():
            node.stop()


def test_port_sources_are_the_jax_sources():
    """The wire format (every trailing extension 0xFFF9-0xFFFF included)
    and the arena are the JAX package's, byte for byte."""
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    for name in ("transport.cpp", "arena.cpp"):
        assert ((root / "sparkrdma_tpu_torch" / "native" / name).read_bytes()
                == (root / "sparkrdma_tpu" / "native" / name).read_bytes())


def test_library_lands_under_build_native_and_nothing_in_the_package():
    from pathlib import Path

    from sparkrdma_tpu_torch.native import arena, transport_lib as tl

    tl.require()
    arena.require()
    root = Path(__file__).resolve().parents[1]
    for lib in (tl.LIBRARY, arena.LIBRARY):
        assert lib.so.parent == root / "build" / "native"
        assert lib.so.exists()
        assert lib.so.with_name(lib.so.name + ".sha256").read_text() == (
            tl.sources_hash(lib.src, tl._build_flags()))
    pkg = root / "sparkrdma_tpu_torch"
    built = [p for pat in ("*.so", "*.so.*", "*.sha256", "*.tmp", "*.o")
             for p in pkg.rglob(pat)]
    assert built == []


def test_second_load_does_not_rebuild(tmp_path):
    """A library built from the same source and flags is loaded, not
    rebuilt: in a fresh process, and for a second build call."""
    import os
    import shutil
    import subprocess
    import sys
    from pathlib import Path

    from sparkrdma_tpu_torch.native import transport_lib as tl

    tl.require()
    root = Path(__file__).resolve().parents[1]
    script = (
        "from sparkrdma_tpu_torch.native import transport_lib as tl, arena\n"
        "tl.require(); tl.load(); arena.require()\n"
        "print(sorted(tl.build_seconds))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", script], cwd=root, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"

    src = tmp_path / "arena.cpp"
    shutil.copy(root / "sparkrdma_tpu_torch" / "native" / "arena.cpp", src)
    lib = tmp_path / "out" / "libx.so"
    tl.build_library(src, lib, tl._build_flags())
    first = lib.stat().st_mtime_ns
    assert "libx.so" in tl.build_seconds
    del tl.build_seconds["libx.so"]
    tl.build_library(src, lib, tl._build_flags())
    assert lib.stat().st_mtime_ns == first
    assert "libx.so" not in tl.build_seconds
    # a changed source is rebuilt
    src.write_text(src.read_text() + "\n// changed\n")
    tl.build_library(src, lib, tl._build_flags())
    assert "libx.so" in tl.build_seconds
    assert sorted(p.name for p in lib.parent.iterdir()) == [
        "libx.so", "libx.so.lock", "libx.so.sha256"]


def test_broken_source_raises_for_require_and_native(tmp_path, monkeypatch):
    """A copy of transport.cpp that does not compile: ``require()``
    raises with g++'s stderr, every time; ``transport=native`` and
    ``auto`` raise instead of handing back a python node; ``load()``
    and ``available()`` alone say None / False."""
    from pathlib import Path

    from sparkrdma_tpu_torch.native import transport_lib as tl
    from sparkrdma_tpu_torch.transport import create_node

    root = Path(__file__).resolve().parents[1]
    broken = tmp_path / "transport.cpp"
    broken.write_text(
        (root / "sparkrdma_tpu_torch" / "native" / "transport.cpp").read_text()
        + "\nint srt_broken( { syntax error here\n")
    monkeypatch.setattr(tl, "LIBRARY", tl.Library(
        broken, tmp_path / "build" / "libsrt_transport.so", tl._bind))
    with pytest.raises(tl.NativeBuildError, match="srt_broken"):
        tl.require()
    with pytest.raises(tl.NativeBuildError, match="srt_broken"):
        tl.require()
    assert tl.load() is None and not tl.available()
    assert not (tmp_path / "build" / "libsrt_transport.so").exists()
    assert list((tmp_path / "build").glob("*.tmp")) == []
    native = TpuShuffleConf({"tpu.shuffle.transport": "native"})
    with pytest.raises(tl.NativeBuildError):
        create_node(native, "127.0.0.1", True, "broken")
    with pytest.raises(tl.NativeBuildError):
        TpuShuffleConf({}).transport
    with pytest.raises(tl.NativeBuildError):
        TpuShuffleManager(native, is_driver=True)
    assert TpuShuffleConf({"tpu.shuffle.transport": "python"}).transport == "python"


def test_transport_resolution(monkeypatch, tmp_path):
    """``auto`` is ``native`` where g++ builds it, as in JAX, and
    ``python`` without g++ and without a built library; ``python`` is
    the escape hatch; ``create_node`` gives the plane asked for."""
    from sparkrdma_tpu_torch.native import transport_lib as tl
    from sparkrdma_tpu_torch.transport import create_node
    from sparkrdma_tpu_torch.transport.native_node import NativeTpuNode
    from sparkrdma_tpu_torch.transport.node import TpuNode

    for raw, plane, cls in (("auto", "native", NativeTpuNode),
                            ("native", "native", NativeTpuNode),
                            ("python", "python", TpuNode),
                            ("bogus", "native", NativeTpuNode)):
        conf = TpuShuffleConf({"tpu.shuffle.transport": raw})
        assert conf.transport == plane
        node = create_node(conf, "127.0.0.1", True, f"res-{raw}")
        try:
            assert type(node) is cls
        finally:
            node.stop()
    monkeypatch.setattr(tl.shutil, "which", lambda _: None)
    monkeypatch.setattr(tl.LIBRARY, "so", tmp_path / "absent.so")
    assert not tl.toolchain_available()
    assert TpuShuffleConf({}).transport == "python"


def test_buffer_backings_counted(monkeypatch):
    """Registered buffers of a native PD are ``/dev/shm`` slabs named
    ``srt-<pid>-<hex>`` with the mapping fd's identity; a slab whose
    ``posix_fallocate`` fails (ENOSPC on a small ``/dev/shm``) falls
    back to anonymous memory and is counted so; ``arena=True`` takes
    the native arena; a python PD maps anonymously."""
    import errno
    import os
    import re

    import numpy as np

    from sparkrdma_tpu_torch.memory import buffer as B
    from sparkrdma_tpu_torch.memory.registry import ProtectionDomain
    from sparkrdma_tpu_torch.native.arena import NativeArena
    from sparkrdma_tpu_torch.transport.native_node import NativeTpuNode

    node = NativeTpuNode(TpuShuffleConf(), "127.0.0.1", True, "backings")
    try:
        c0 = B.backing_counts()
        shm = B.TpuBuffer(node.pd, 1 << 16)
        assert re.fullmatch(rf"/dev/shm/srt-{os.getpid()}-[0-9a-f]{{32}}",
                            shm._shm_path)
        st = os.stat(shm._shm_path)
        assert st.st_size == 1 << 16
        np.frombuffer(shm.view, np.uint8)[:] = 7
        with open(shm._shm_path, "rb") as f:
            assert f.read() == bytes([7]) * (1 << 16)
        c1 = B.backing_counts()
        assert c1["shm"] == c0["shm"] + 1

        def enospc(fd, off, n):
            raise OSError(errno.ENOSPC, "No space left on device")

        with monkeypatch.context() as m:
            m.setattr(B.os, "posix_fallocate", enospc)
            before = set(os.listdir("/dev/shm"))
            anon = B.TpuBuffer(node.pd, 1 << 16)
            assert set(os.listdir("/dev/shm")) == before
        assert anon._shm_path is None and anon.mkey
        c2 = B.backing_counts()
        assert c2["shm_fallback"] == c1["shm_fallback"] + 1

        live0 = NativeArena.shared().stats()[2]
        scratch = B.TpuBuffer(None, 1 << 16, register=False, arena=True)
        assert NativeArena.shared().stats()[2] == live0 + 1
        scratch.write(b"abc", 10)
        assert scratch.read(10, 3) == b"abc"
        scratch.free()
        assert NativeArena.shared().stats()[2] == live0
        plain = B.TpuBuffer(ProtectionDomain(), 4096)
        c3 = B.backing_counts()
        assert c3["arena"] == c2["arena"] + 1
        assert c3["anonymous"] == c2["anonymous"] + 1
        path = shm._shm_path
        for b in (shm, anon, plain):
            b.free()
        assert not os.path.exists(path)
    finally:
        node.stop()


def test_shm_sweeps_of_both_packages_spare_live_files(tmp_path):
    """Both packages sweep ``/dev/shm/srt-*`` files of dead owners at
    import. A live process's port slab survives the JAX sweep and the
    port's; once its owner is killed (no atexit), the port's sweep
    reclaims it and its host-proof token."""
    import os
    import signal
    import subprocess
    import sys
    from pathlib import Path

    from sparkrdma_tpu.memory.buffer import sweep_stale_shm_files as jax_sweep
    from sparkrdma_tpu_torch.memory.buffer import sweep_stale_shm_files

    root = Path(__file__).resolve().parents[1]
    script = (
        "import sys, time\n"
        "from sparkrdma_tpu_torch.memory.buffer import TpuBuffer\n"
        "from sparkrdma_tpu_torch.transport.native_node import NativeTpuNode\n"
        "from sparkrdma_tpu_torch.utils.config import TpuShuffleConf\n"
        "n = NativeTpuNode(TpuShuffleConf(), '127.0.0.1', True, 'sweep')\n"
        "b = TpuBuffer(n.pd, 4096)\n"
        "print(b._shm_path, flush=True)\n"
        "time.sleep(120)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.Popen([sys.executable, "-c", script], cwd=root, env=env,
                            stdout=subprocess.PIPE, text=True)
    try:
        path = proc.stdout.readline().strip()
        token = f"srt-host-{proc.pid}-"
        assert path.startswith(f"/dev/shm/srt-{proc.pid}-")
        assert any(n.startswith(token) for n in os.listdir("/dev/shm"))
        jax_sweep()
        sweep_stale_shm_files()
        assert os.path.exists(path)
    finally:
        proc.send_signal(signal.SIGKILL)
        proc.wait(30)
    assert sweep_stale_shm_files() >= 2
    assert not os.path.exists(path)
    assert not any(n.startswith(token) for n in os.listdir("/dev/shm"))
