"""The port's host plane against the JAX package's, on the CPU over the
python transport.

Dryrun sections 4 and 5 (``__graft_entry__.dryrun_multichip``: a driver
and four executors, device-block publish, the location protocol, READ
and device staging, then the compiled-collective reduce stage three
ways and at pipeline depths 1 and 2) run on the port over
``make_mesh(["cpu"] * 4)`` through ``chip_smoke.host_plane_sections`` and
on the JAX package over four of the conftest's CPU devices: the same
bytes and the same collective counter deltas.

The headline test mixes the packages: a JAX executor and a port
executor share one driver (a JAX driver, then a port driver), each
publishes its blocks, the other fetches them over one-sided READs, and
the bytes are equal. Neither side can see the other's arena, so every
block crosses by the host triple."""

import contextlib

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from sparkrdma_tpu.obs import get_registry as jax_registry
from sparkrdma_tpu.shuffle.device_io import DeviceShuffleIO as JaxIO
from sparkrdma_tpu.shuffle.handle import BaseShuffleHandle as JaxHandle
from sparkrdma_tpu.shuffle.handle import HashPartitioner as JaxPartitioner
from sparkrdma_tpu.shuffle.manager import TpuShuffleManager as JaxManager
from sparkrdma_tpu.utils.config import TpuShuffleConf as JaxConf
from sparkrdma_tpu_torch.parallel import make_mesh
from sparkrdma_tpu_torch.shuffle.device_io import DeviceShuffleIO
from sparkrdma_tpu_torch.shuffle.handle import BaseShuffleHandle, HashPartitioner
from sparkrdma_tpu_torch.shuffle.manager import TpuShuffleManager
from sparkrdma_tpu_torch.utils.config import TpuShuffleConf

torch.set_num_threads(1)

PY = {"tpu.shuffle.transport": "python"}
N_EXEC = 4


def _jax_sections(devices, prefix):
    """Dryrun sections 4 and 5 on the JAX package, as
    ``__graft_entry__.dryrun_multichip`` runs them (python transport);
    returns what ``chip_smoke.host_plane_sections`` returns."""
    n_exec = len(devices)
    conf = JaxConf(PY)
    driver = JaxManager(conf, is_driver=True)
    execs = [JaxManager(conf, is_driver=False, executor_id=f"{prefix}-{i}")
             for i in range(n_exec)]
    ios = [JaxIO(ex, device=devices[i]) for i, ex in enumerate(execs)]
    seen = {}
    try:
        driver.register_shuffle(JaxHandle(shuffle_id=7, num_maps=n_exec,
                                          partitioner=JaxPartitioner(n_exec)))

        def pattern(m, p):
            return bytes([(m * 16 + p) % 256]) * (512 + 64 * m + p)

        for m, io in enumerate(ios):
            io.publish_device_blocks(7, {p: np.frombuffer(pattern(m, p), np.uint8)
                                         for p in range(n_exec)})
        seen["section4"] = {}
        for p, io in enumerate(ios):
            got = io.fetch_device_blocks(7, p, p + 1, timeout_s=60)
            seen["section4"][p] = sorted(b.read(0, b.length) for b in got[p])
            assert all(b.array.devices() == {devices[p]} for b in got[p])
            for b in got[p]:
                b.free()

        driver.register_shuffle(JaxHandle(shuffle_id=8, num_maps=n_exec,
                                          partitioner=JaxPartitioner(n_exec)))

        def big(m, p):
            return bytes([(m * 8 + p + 1) % 256]) * (32768 + 128 * m + p)

        for m, io in enumerate(ios):
            io.publish_device_blocks(8, {p: np.frombuffer(big(m, p), np.uint8)
                                         for p in range(n_exec)})
        io0 = ios[0]

        def reduce_stage(fused=False):
            got = io0.fetch_device_blocks(8, 0, n_exec, timeout_s=60, fused=fused)
            try:
                return {p: sorted(bytes(b.read(0, b.length)) for b in got[p])
                        for p in range(n_exec)}
            finally:
                for bufs in got.values():
                    for b in bufs:
                        b.free()

        reg = jax_registry()
        role = f"{prefix}-0"
        c_plans = reg.counter("collective.plans", role=role)
        c_blocks = reg.counter("collective.blocks", role=role)
        c_fused = reg.counter("collective.fused_merges", role=role)
        p0, b0, f0 = c_plans.value, c_blocks.value, c_fused.value
        seen["collective"] = reduce_stage()
        fused_got = io0.fetch_device_blocks(8, 0, n_exec, timeout_s=60, fused=True)
        try:
            seen["fused"] = {p: bytes(fused_got[p][0].read(0, fused_got[p][0].length))
                             for p in range(n_exec)}
            assert all(len(fused_got[p]) == 1 for p in range(n_exec))
        finally:
            for bufs in fused_got.values():
                for b in bufs:
                    b.free()
        seen["deltas"] = {"plans": c_plans.value - p0, "blocks": c_blocks.value - b0,
                          "fused_merges": c_fused.value - f0}
        conf.set("tpu.shuffle.collective.enabled", "false")
        try:
            seen["per_block"] = reduce_stage()
        finally:
            conf.set("tpu.shuffle.collective.enabled", "true")
        c_overlap = reg.counter("collective.wave_overlap_ms", role=role)
        conf.set("tpu.shuffle.collective.autoTune", "false")
        conf.set("tpu.shuffle.collective.waveBytes", "128k")
        try:
            conf.set("tpu.shuffle.collective.pipelineDepth", "1")
            o0 = c_overlap.value
            assert reduce_stage() == seen["collective"]
            seen["overlap_depth1"] = c_overlap.value - o0
            conf.set("tpu.shuffle.collective.pipelineDepth", "2")
            assert reduce_stage() == seen["collective"]
            seen["overlap_depth2_positive"] = c_overlap.value > o0
        finally:
            conf.set("tpu.shuffle.collective.pipelineDepth", "2")
            conf.set("tpu.shuffle.collective.waveBytes", "64m")
            conf.set("tpu.shuffle.collective.autoTune", "true")
    finally:
        for io in ios:
            io.stop()
        for ex in execs:
            ex.stop()
        driver.stop()
    return seen


def test_dryrun_sections_4_and_5_match_jax():
    want = _jax_sections(jax.devices()[:N_EXEC], "hp-jax")
    got = chip_smoke.host_plane_sections(
        make_mesh(["cpu"] * N_EXEC).devices, knobs=PY, prefix="hp-port")
    assert set(got) == set(want)
    for key in want:
        assert got[key] == want[key], key
    # over the collective reduce and the fused one: every block rode a
    # wave twice, one fused slab per partition
    assert got["deltas"]["plans"] > 0
    assert got["deltas"]["blocks"] == 2 * N_EXEC * N_EXEC
    assert got["deltas"]["fused_merges"] == N_EXEC
    assert got["overlap_depth1"] == 0 and got["overlap_depth2_positive"]


# ----------------------------------------------------------------------
# one driver, a JAX executor and a port executor
# ----------------------------------------------------------------------
@contextlib.contextmanager
def _mixed(driver_pkg):
    """A driver of ``driver_pkg`` and one executor of each package."""
    if driver_pkg == "jax":
        driver = JaxManager(JaxConf(PY), is_driver=True)
    else:
        driver = TpuShuffleManager(TpuShuffleConf(PY), is_driver=True)
    knobs = dict(PY, **{"tpu.shuffle.driverPort": str(driver.node.port)})
    jex = JaxManager(JaxConf(knobs), is_driver=False,
                     executor_id=f"mix-{driver_pkg}-jax")
    tex = TpuShuffleManager(TpuShuffleConf(knobs), is_driver=False,
                            executor_id=f"mix-{driver_pkg}-port")
    jio, tio = JaxIO(jex), DeviceShuffleIO(tex, device="cpu")
    try:
        yield driver, jio, tio
    finally:
        jio.stop()
        tio.stop()
        jex.stop()
        tex.stop()
        driver.stop()


def _keys(seed, n):
    return np.random.default_rng(seed).integers(0, 1 << 32, n, dtype=np.uint32)


@pytest.mark.parametrize("driver_pkg", ["jax", "port"])
def test_jax_and_port_executors_share_one_driver(driver_pkg):
    parts = 3
    with _mixed(driver_pkg) as (driver, jio, tio):
        handle_cls, part_cls = ((JaxHandle, JaxPartitioner) if driver_pkg == "jax"
                                else (BaseShuffleHandle, HashPartitioner))
        driver.register_shuffle(handle_cls(shuffle_id=21, num_maps=2,
                                           partitioner=part_cls(parts)))
        # uint32 keys, above deviceFetch.minBlockBytes on both sides, so
        # each publish carries its device coordinates too
        jblocks = {p: _keys(10 + p, 5000 + 97 * p) for p in range(parts)}
        tblocks = {p: _keys(20 + p, 7000 + 31 * p) for p in range(parts)}
        jio.publish_device_blocks(21, jblocks)
        tio.publish_device_blocks(21, tblocks)
        for p in range(parts):
            want = sorted([jblocks[p].tobytes(), tblocks[p].tobytes()])
            # the port executor reads the JAX executor's block, and back
            got_t = tio.fetch_device_blocks(21, p, p + 1, dtype=np.uint32,
                                            timeout_s=60)
            got_j = jio.fetch_device_blocks(21, p, p + 1, dtype=np.uint32,
                                            timeout_s=60)
            try:
                assert sorted(b.read(0, b.length) for b in got_t[p]) == want
                assert sorted(bytes(b.read(0, b.length)) for b in got_j[p]) == want
                assert all(b.array.dtype == torch.uint32 for b in got_t[p])
            finally:
                for b in got_t[p] + got_j[p]:
                    b.free()
        # the JAX blocks reached the port by the host path (its own block
        # is a device pull from its own arena, which fetch_bytes skips)
        assert tio.metrics_snapshot()["fetch_bytes"] == sum(
            b.nbytes for b in jblocks.values())
