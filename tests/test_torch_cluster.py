"""The port's ``ClusterContext`` (``sparkrdma_tpu_torch/engine/cluster.py``):
a driver and executor processes (``python -m
sparkrdma_tpu_torch.engine.worker``) over real TCP, closures shipped by
cloudpickle. The counterparts of ``tests/test_cluster.py`` (wordcount, a
map failure surfacing at the driver, a task that checks its worker
loaded neither jax nor the JAX package and never initialised CUDA), and
``chip_smoke.py`` phase 14's cluster runs at a small size through its
own functions: a range-partitioned sort of ``default_rng`` keys, and the
push route that only cluster mode fills (``PushClient.routes`` from the
workers' task ports). Results that plain Python or the JAX package's
in-process ``TpuContext`` can compute are held against both.

Two cluster starts of two workers each, to keep the tier-1 run light.
Map and reduce functions come from factories, so cloudpickle ships them
by value: a worker cannot import this module."""

import collections

import pytest
import torch

import chip_smoke
from sparkrdma_tpu.engine.context import TpuContext as JaxContext
from sparkrdma_tpu.utils.config import TpuShuffleConf as JaxConf
from sparkrdma_tpu_torch.engine.cluster import ClusterContext
from sparkrdma_tpu_torch.utils.config import TpuShuffleConf

torch.set_num_threads(1)

KNOBS = {"tpu.shuffle.transport": "python"}
WORDS = ["tpu", "shuffle", "rdma", "mesh", "ici", "dcn"]


@pytest.fixture(scope="module")
def cluster():
    cc = ClusterContext(num_executors=2, conf=TpuShuffleConf(dict(KNOBS)))
    yield cc
    cc.stop()


def _make_words(seed, n=600):
    def fn():
        for i in range(n):
            yield (WORDS[(seed * 7 + i) % len(WORDS)], 1)

    return fn


def _counts():
    def red(it):
        acc = collections.Counter()
        for k, v in it:
            acc[k] += v
        return dict(acc)

    return red


def _merged(parts):
    out = collections.Counter()
    for p in parts:
        out.update(p)
    return out


def test_multiprocess_wordcount(cluster):
    parts = cluster.run_map_reduce([_make_words(s) for s in range(4)], num_partitions=4,
                                   reduce_fn=_counts())
    assert len(parts) == 2
    expected = collections.Counter()
    for s in range(4):
        expected.update(w for w, _ in _make_words(s)())
    assert _merged(parts) == expected
    with JaxContext(num_executors=2, conf=JaxConf(dict(KNOBS))) as ctx:
        jax_counts = dict(ctx.generate(lambda s: _make_words(s)(), 4)
                          .reduce_by_key(lambda a, b: a + b, 4).collect())
    assert _merged(parts) == jax_counts
    bd = cluster.last_breakdown
    assert bd is not None and bd.wall_ms > 0
    assert set(bd.to_dict()["categories_ms"]) <= {
        "device-compute", "dma-wave", "host-read", "decode", "rpc", "queue-wait",
        "other", "idle-untraced"}


def test_map_failure_surfaces_to_driver(cluster):
    def bad():
        raise RuntimeError("boom in a worker process")

    with pytest.raises(RuntimeError, match="boom"):
        cluster.run_map_reduce([bad], num_partitions=1)


def test_worker_loads_no_jax_and_no_cuda(cluster):
    import os

    parts = cluster.run_map_reduce([_make_words(1, 50)], num_partitions=2,
                                   reduce_fn=chip_smoke._en_probe_fn())
    assert len({p["pid"] for p in parts} | {os.getpid()}) == 3
    assert sum(p["records"] for p in parts) == 50
    for p in parts:
        assert p["main"] == "sparkrdma_tpu_torch.engine.worker"
        assert p["jax"] == []
        assert p["cuda_initialized"] is False


def test_range_partitioned_sort_shape(cluster):
    """``chip_smoke.py`` phase 14 (d) at a small size, through its own
    functions: 8 map functions generate their keys in the workers from
    their own seeds, a ``RangePartitioner`` cuts at ``((r + 1) << 32) //
    8``; every reducer's count, xor, min and max against the generator's
    keys of its partitions, the ranges disjoint and ordered."""
    parts, keys, _wall = chip_smoke._en_cluster_job(cluster, 12_000)
    assert len(keys) == 12_000 and len(parts) == 2
    chip_smoke._en_check_ranges(parts, keys, "(d) small")
    # the check's own teeth: one reducer's xor off by one bit fails it
    parts[0]["xor"] ^= 1
    with pytest.raises(AssertionError, match="count/xor/min/max"):
        chip_smoke._en_check_ranges(parts, keys, "(d) small")


def test_cluster_push_route_reads_merged_segments():
    """The chunked-agg writer with push on, in cluster mode (phase 14
    (e)'s first run at a small size): the workers' push clients take
    their routes from the map batch (``push_routes``), ship sealed
    blocks to the reducer's task port, and the reducers read merged
    segments; the output is the records the maps generated."""
    conf = TpuShuffleConf({**KNOBS, "tpu.shuffle.shuffleWriteMethod": "chunkedpartitionagg",
                           "tpu.shuffle.push.enabled": "true"})
    with ClusterContext(num_executors=2, conf=conf) as cc:
        parts, keys, _wall = chip_smoke._en_cluster_job(
            cc, 6_400, counters=("push.pushed_blocks", "reader.merged_reads"))
    chip_smoke._en_check_ranges(parts, keys, "(e) push small")
    assert sum(p["counters"]["push.pushed_blocks"] for p in parts) > 0
    assert sum(p["counters"]["reader.merged_reads"] for p in parts) > 0
