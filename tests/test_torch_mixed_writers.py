"""One driver hosts a JAX executor and a port executor. Each writes map
output through its own package's record writers, each reads every
partition, so each fetches the other's blocks by one-sided READ over the
python transport, and the records equal a one-package run's byte for
byte: under both writer methods, both block formats, and a driver of
either package."""

import contextlib
import pickle

import numpy as np
import pytest
import torch

from sparkrdma_tpu.obs import get_registry as jax_registry
from sparkrdma_tpu.shuffle import handle as jhandle
from sparkrdma_tpu.shuffle.manager import TpuShuffleManager as JaxManager
from sparkrdma_tpu.utils.config import TpuShuffleConf as JaxConf
from sparkrdma_tpu_torch.obs import get_registry
from sparkrdma_tpu_torch.shuffle import handle as thandle
from sparkrdma_tpu_torch.shuffle.manager import TpuShuffleManager
from sparkrdma_tpu_torch.utils.config import TpuShuffleConf

torch.set_num_threads(1)

PKGS = {"jax": (JaxManager, JaxConf, jhandle),
        "port": (TpuShuffleManager, TpuShuffleConf, thandle)}
MAPS = 4  # two on each executor
PARTS = 3
ROWS = 1500


def _knobs(method, block_format):
    return {"tpu.shuffle.transport": "python",
            "tpu.shuffle.shuffleWriteMethod": method,
            "tpu.shuffle.block.format": block_format,
            "tpu.shuffle.block.columnarBatchRows": "256",
            "tpu.shuffle.shuffleWriteBlockSize": "65536",
            "tpu.shuffle.shuffleReadBlockSize": "65536"}


def _records(map_id):
    keys = (np.arange(map_id * ROWS, (map_id + 1) * ROWS, dtype=np.uint32) * 7919) % 997
    return list(zip(keys.astype(np.uint32), np.arange(ROWS, dtype=np.int64) + map_id * ROWS))


@contextlib.contextmanager
def _cluster(driver_pkg, exec_pkgs, knobs, tag):
    manager, conf_cls, h = PKGS[driver_pkg]
    driver = manager(conf_cls(knobs), is_driver=True)
    ek = dict(knobs, **{"tpu.shuffle.driverPort": str(driver.node.port)})
    execs = []
    try:
        for i, pkg in enumerate(exec_pkgs):
            m, c, _ = PKGS[pkg]
            execs.append(m(c(ek), is_driver=False, executor_id=f"mix-{tag}-{pkg}-{i}"))
        handle = h.BaseShuffleHandle(shuffle_id=0, num_maps=MAPS,
                                     partitioner=h.HashPartitioner(PARTS))
        driver.register_shuffle(handle)
        yield execs, handle
    finally:
        for ex in execs:
            ex.stop()
        driver.stop()


def _shuffle(driver_pkg, exec_pkgs, method, block_format, tag):
    """Maps 0, 1 on the first executor and 2, 3 on the second; then each
    executor reads every partition. Returns, per reading executor, its
    rows sorted, and its reader's metrics."""
    with _cluster(driver_pkg, exec_pkgs, _knobs(method, block_format), tag) as (execs, h):
        for map_id in range(MAPS):
            w = execs[map_id // 2].get_writer(h, map_id)
            w.write(iter(_records(map_id)))
            assert w.stop(True) is not None
        for ex in execs:
            ex.finalize_maps(0)
        out = []
        for ex in execs:
            reader = ex.get_reader(h, 0, PARTS)
            rows = sorted(reader.read(), key=lambda r: (int(r[0]), int(r[1])))
            out.append((rows, reader.metrics))
        return out


_BASELINES = {}


def _baseline(method, block_format):
    """The same shuffle on a JAX driver and two JAX executors."""
    key = (method, block_format)
    if key not in _BASELINES:
        (rows, _), _ = _shuffle("jax", ["jax", "jax"], method, block_format, "one")
        _BASELINES[key] = pickle.dumps(rows)
    return _BASELINES[key]


@pytest.mark.parametrize("block_format", ["pickle", "columnar"])
@pytest.mark.parametrize("method", ["wrapper", "chunkedpartitionagg"])
@pytest.mark.parametrize("driver_pkg", ["jax", "port"])
def test_jax_and_port_executors_read_each_others_blocks(driver_pkg, method, block_format):
    want = _baseline(method, block_format)
    roles = {"jax": (jax_registry(), f"mix-{driver_pkg}-jax-0"),
             "port": (get_registry(), f"mix-{driver_pkg}-port-1")}
    decodes = {k: reg.counter("block.view_decodes", role=r) for k, (reg, r) in roles.items()}
    before = {k: c.value for k, c in decodes.items()}
    got = _shuffle(driver_pkg, ["jax", "port"], method, block_format, driver_pkg)
    columnar = method == "wrapper" and block_format == "columnar"
    for k, c in decodes.items():
        # each side decoded columnar frames as views, its own and the other's
        assert (c.value > before[k]) == columnar, k
    for who, (rows, metrics) in zip(("jax", "port"), got):
        assert len(rows) == MAPS * ROWS
        assert pickle.dumps(rows) == want, who
        # half of every partition was written by the other package's
        # executor; it came by READ (push never crosses packages)
        assert metrics.remote_blocks > 0 and metrics.local_blocks > 0, who
