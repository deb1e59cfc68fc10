"""The port's engine (``sparkrdma_tpu_torch/engine/``: the RDD lineage and
``TpuContext``) against the JAX package's: the same jobs on the same
seeded inputs through both contexts give the same output. Jobs whose
reduce side keeps arrival order (group values, ties of ``sort_by_key``)
compare as per-key multisets; every other job compares exactly. Both
fault runs of the engine (the driver's hub killed between map and
reduce; an executor lost between two reads of a materialized shuffle)
give the fault-free output and move the same counters in both packages.

Every context runs the python transport (the JAX ``auto`` resolves to
native here)."""

import collections
import time

import numpy as np
import pytest
import torch

from sparkrdma_tpu.engine.context import TpuContext as JaxContext
from sparkrdma_tpu.obs import attr as jax_attr
from sparkrdma_tpu.obs import get_registry as jax_registry
from sparkrdma_tpu.testing import faults as jax_faults
from sparkrdma_tpu.utils.config import TpuShuffleConf as JaxConf
from sparkrdma_tpu_torch.engine.context import TpuContext
from sparkrdma_tpu_torch.obs import attr as port_attr
from sparkrdma_tpu_torch.obs import get_registry
from sparkrdma_tpu_torch.testing import faults
from sparkrdma_tpu_torch.utils.config import TpuShuffleConf

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _jax_registry_left_clean():
    """The JAX code run here counts into the JAX package's process
    registry, which later test files in this worker read (a diagnosis
    reads its quota and metastore counters): zero it when the module
    ends."""
    yield
    jax_registry().reset()


KNOBS = {"tpu.shuffle.transport": "python"}
# an executor lost between two reads defers every later location fetch
# until this timeout (twice: the fetch and its re-resolve) before the
# stage recompute; the default 30 s would hold each fault run a minute
LOST_KNOBS = {**KNOBS, "tpu.shuffle.partitionLocationFetchTimeoutMs": "3000"}
WORDS = "the quick brown fox jumps over the lazy dog".split()


@pytest.fixture(scope="module")
def ctxs():
    jax_ctx = JaxContext(num_executors=2, conf=JaxConf(dict(KNOBS)))
    port_ctx = TpuContext(num_executors=2, conf=TpuShuffleConf(dict(KNOBS)))
    yield jax_ctx, port_ctx
    port_ctx.stop()
    jax_ctx.stop()


def _both(ctxs, job):
    """``job(ctx)`` on the JAX context, then on the port's."""
    return [job(c) for c in ctxs]


def _records(n, seed, hi):
    keys = np.random.default_rng(seed).integers(0, hi, n, dtype=np.uint64)
    return [(int(k), i) for i, k in enumerate(keys)]


def _multisets(rows):
    """Per-key multisets of values, keys in output order."""
    out = collections.OrderedDict()
    for k, v in rows:
        out.setdefault(k, collections.Counter())[v] += 1
    return out


def test_quick_start(ctxs):
    """The README's Quick start on both contexts, and plain Python."""
    def job(ctx):
        rdd = (ctx.parallelize(range(10000), 8)
                  .map(lambda x: (x % 100, x))
                  .reduce_by_key(lambda a, b: a + b))
        return sorted(rdd.collect())

    jax_out, port_out = _both(ctxs, job)
    want = sorted((k, sum(range(k, 10000, 100))) for k in range(100))
    assert port_out == jax_out == want
    assert port_out[:3] == [(0, 495000), (1, 495100), (2, 495200)]


def test_reduce_by_key(ctxs):
    words = [WORDS[i] for i in np.random.default_rng(7).integers(0, len(WORDS), 5000)]

    def job(ctx):
        return sorted(ctx.parallelize(words, 4).map(lambda w: (w, 1))
                      .reduce_by_key(lambda a, b: a + b, 3).collect())

    jax_out, port_out = _both(ctxs, job)
    assert port_out == jax_out
    assert dict(port_out) == collections.Counter(words)


def test_group_by_key(ctxs):
    data = _records(700, 3, 7)

    def job(ctx):
        return {k: sorted(vs) for k, vs in ctx.parallelize(data, 3).group_by_key(4).collect()}

    jax_out, port_out = _both(ctxs, job)
    assert port_out == jax_out
    assert sum(len(v) for v in port_out.values()) == 700


@pytest.mark.parametrize("n,hi,parts", [(6000, 500, 5), (3000, 1 << 32, 8)],
                         ids=["duplicates", "uint32"])
def test_sort_by_key(ctxs, n, hi, parts):
    """Keys from ``default_rng`` (many duplicates in the first case): the
    key sequence equals the JAX package's exactly, values per key as
    multisets, and the whole is a total order of the input."""
    data = _records(n, 11, hi)

    def job(ctx):
        return ctx.parallelize(data, 4).sort_by_key(num_partitions=parts).collect()

    jax_out, port_out = _both(ctxs, job)
    assert [k for k, _ in port_out] == [k for k, _ in jax_out]
    assert _multisets(port_out) == _multisets(jax_out)
    keys = [k for k, _ in port_out]
    assert keys == sorted(k for k, _ in data)
    assert sorted(port_out) == sorted(data)


def test_sample_bounds_equal_jax(ctxs):
    """``_sample_bounds`` seeds ``random.Random(17 + p)`` in both
    packages, so over partitions large enough to be sampled (more than
    200 records each) the bounds, and ``sort_by_key``'s partitioner, are
    the JAX package's."""
    data = _records(8 * 600, 5, 1 << 32)

    def job(ctx):
        rdd = ctx.parallelize(data, 8)
        return rdd._sample_bounds(6), rdd.sort_by_key(num_partitions=6).partitioner.bounds

    (jax_bounds, jax_part), (port_bounds, port_part) = _both(ctxs, job)
    assert len(port_bounds) == 5
    assert port_bounds == jax_bounds == port_part == jax_part


def test_join(ctxs):
    left = [(i % 5, f"l{i}") for i in range(20)]
    right = [(i % 5, f"r{i}") for i in range(10)]

    def job(ctx):
        return sorted(ctx.parallelize(left, 2).join(ctx.parallelize(right, 2)).collect())

    jax_out, port_out = _both(ctxs, job)
    assert port_out == jax_out
    assert port_out == sorted((k, (lv, rv)) for k, lv in left for k2, rv in right if k == k2)


def test_union_and_narrow_ops(ctxs):
    """``union``, ``filter``, ``flat_map``, ``map_partitions`` and
    ``key_by`` run no shuffle: their output order is the lineage's, and
    equal to the JAX package's exactly."""
    def job(ctx):
        a = ctx.parallelize(range(40), 3).filter(lambda x: x % 3 != 0)
        b = ctx.parallelize(range(10), 2).flat_map(lambda x: [x] * (x % 3))
        c = a.union(b).map_partitions(lambda it: (x * 10 for x in it)).key_by(lambda x: x % 7)
        return c.num_partitions, c.collect()

    jax_out, port_out = _both(ctxs, job)
    assert port_out == jax_out
    assert port_out[0] == 5


def test_count_and_reduce(ctxs):
    data = _records(2000, 9, 1000)

    def job(ctx):
        rdd = ctx.parallelize(data, 4).reduce_by_key(lambda a, b: a + b)
        return rdd.count(), rdd.map(lambda kv: kv[1]).reduce(lambda a, b: a + b)

    jax_out, port_out = _both(ctxs, job)
    assert port_out == jax_out
    assert port_out[1] == sum(v for _, v in data)


def test_chained_shuffles(ctxs):
    """shuffle -> narrow -> shuffle: the multi-stage lineage."""
    data = [(i % 10, 1) for i in range(1000)]

    def job(ctx):
        return (ctx.parallelize(data, 4).reduce_by_key(lambda a, b: a + b)
                .map(lambda kv: (kv[1], kv[0])).sort_by_key(num_partitions=3).collect())

    jax_out, port_out = _both(ctxs, job)
    assert [k for k, _ in port_out] == [k for k, _ in jax_out] == [100] * 10
    assert sorted(port_out) == sorted(jax_out)


def test_task_histograms_and_breakdown(ctxs):
    """A job records ``engine.task_ms`` for its maps (on the executors'
    roles) and reduces (the driver's role) in both packages, and leaves a
    breakdown whose categories are JAX's vocabulary."""
    def job(ctx, reg):
        before = reg.snapshot(prefix="engine.task_ms")
        ctx.parallelize(range(400), 4).map(lambda x: (x % 9, x)).reduce_by_key(
            lambda a, b: a + b, 3).collect()
        delta = reg.delta(before, prefix="engine.task_ms")["histograms"]
        counts = collections.Counter()
        for key, h in delta.items():
            kind = "map" if "kind=map" in key else "reduce"
            counts[kind] += h["count"]
        bd = ctx.last_breakdown.to_dict()
        # gap frames appear only where the profiler sampled inside a gap
        return dict(counts), sorted(set(bd) - {"gap_frames"}), set(bd["categories_ms"])

    jax_ctx, port_ctx = ctxs
    port_counts, port_keys, port_cats = job(port_ctx, get_registry())
    jax_counts, jax_keys, jax_cats = job(jax_ctx, jax_registry())
    assert port_counts == jax_counts == {"map": 4, "reduce": 3}
    assert port_keys == jax_keys == ["categories_ms", "coverage", "critical_path", "wall_ms"]
    assert port_cats <= set(port_attr.CATEGORIES)
    assert port_attr.CATEGORIES == jax_attr.CATEGORIES


# ----------------------------------------------------------------------
# fault runs (chip_smoke.py phase 14 (c) at a small size)
# ----------------------------------------------------------------------
SORT_RECORDS = [(int(k), b"x" * 90) for k in
                np.random.default_rng(0).integers(0, 1 << 32, 4000, dtype=np.uint64)]


def _sort_job(ctx):
    return ctx.parallelize(SORT_RECORDS, 8).sort_by_key(num_partitions=8).collect()


def _driver_kill(ctx_cls, conf_cls, fault_mod, reg):
    with ctx_cls(num_executors=2, conf=conf_cls(dict(KNOBS))) as ctx:
        baseline = _sort_job(ctx)
    adoptions = reg.counter("metastore.adoptions", role="driver")
    a0 = adoptions.value
    conf = conf_cls({**KNOBS, "tpu.shuffle.faultPlan": "driver:kill:1:stage=reduce_phase"})
    try:
        with ctx_cls(num_executors=2, conf=conf) as ctx:
            got = _sort_job(ctx)
    finally:
        fault_mod.uninstall()
    return baseline, got, adoptions.value - a0


def test_driver_kill_between_map_and_reduce():
    """``driver:kill:1:stage=reduce_phase``: the hub is wiped after the
    map barrier; the job finishes equal to the fault-free run through
    re-adoption, with as many adoptions as the JAX package's. The port's
    output is held against the JAX package's fault-free output: the JAX
    rig can lose records when a pre-crash publish is handled after the
    wipe (see the next test)."""
    jax_base, _jax_got, jax_adopted = _driver_kill(JaxContext, JaxConf, jax_faults, jax_registry())
    base, got, adopted = _driver_kill(TpuContext, TpuShuffleConf, faults, get_registry())
    assert got == base
    assert [k for k, _ in got] == [k for k, _ in jax_base] == sorted(k for k, _ in SORT_RECORDS)
    assert _multisets(got) == _multisets(jax_base)
    assert adopted == jax_adopted == 8


def test_driver_kill_waits_for_pre_crash_publishes(monkeypatch):
    """The driver handles map 3's original publish 0.3 s late, after the
    rig's wipe would have run. Without the rig's wait the late publish
    and the re-adoption sweep both count map 3, the barrier fills with
    another map missing, and its records are lost (the JAX rig's race);
    with it the output equals the fault-free run's."""
    from sparkrdma_tpu_torch.shuffle.manager import TpuShuffleManager

    handle_publish = TpuShuffleManager._handle_publish

    def late(self, msg):
        if (self.is_driver and not msg.meta_epoch and msg.partition_id < 0
                and msg.locations and msg.locations[0].block.source_map == 3):
            time.sleep(0.3)
        return handle_publish(self, msg)

    monkeypatch.setattr(TpuShuffleManager, "_handle_publish", late)
    conf = TpuShuffleConf({**KNOBS, "tpu.shuffle.faultPlan": "driver:kill:1:stage=reduce_phase"})
    try:
        with TpuContext(num_executors=2, conf=conf) as ctx:
            got = _sort_job(ctx)
    finally:
        faults.uninstall()
    assert [k for k, _ in got] == sorted(k for k, _ in SORT_RECORDS)
    assert all(v == b"x" * 90 for _, v in got)


def _lost_executor(ctx_cls, conf_cls, reg):
    recomputes = reg.counter("engine.stage_recomputes")
    with ctx_cls(num_executors=2, conf=conf_cls(dict(LOST_KNOBS))) as ctx:
        rdd = ctx.parallelize(SORT_RECORDS, 8).sort_by_key(num_partitions=8)
        first = rdd.collect()
        r0 = recomputes.value
        ctx.lose_executor("exec-1")
        assert [m.executor_id for m in ctx.executors] == ["exec-0"]
        again = rdd.collect()
        return first, again, recomputes.value - r0


def test_lost_executor_recomputes_its_maps_on_the_survivor():
    """``lose_executor("exec-1")`` between two reads of one materialized
    shuffle, no replicas: the second read's fetch fails, the stage is
    recomputed once on the survivor, and the output is unchanged."""
    jax_first, jax_again, jax_recomputes = _lost_executor(JaxContext, JaxConf, jax_registry())
    first, again, recomputes = _lost_executor(TpuContext, TpuShuffleConf, get_registry())
    assert again == first
    assert [k for k, _ in again] == [k for k, _ in jax_again]
    assert _multisets(again) == _multisets(jax_first)
    assert recomputes == jax_recomputes == 1
