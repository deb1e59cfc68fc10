"""The port's record shuffle end to end over the python transport: a
driver and two executors, both writer methods, remote one-sided READs,
aggregation, key ordering through ``ExternalSorter`` with spills,
executor-loss pruning and the chunked-agg poison rule, against the JAX
package's cluster on the same inputs. ``MappedFile`` and
``ExternalSorter`` are held against the JAX copies directly."""

import os
import pickle
import random
import time

import numpy as np
import pytest
import torch

from sparkrdma_tpu.memory import MappedFile as JaxMappedFile
from sparkrdma_tpu.memory import ProtectionDomain as JaxPD
from sparkrdma_tpu.shuffle import handle as jhandle
from sparkrdma_tpu.shuffle.manager import TpuShuffleManager as JaxManager
from sparkrdma_tpu.utils.config import TpuShuffleConf as JaxConf
from sparkrdma_tpu.utils.external_sorter import ExternalSorter as JaxSorter
from sparkrdma_tpu_torch.memory import MappedFile, ProtectionDomain
from sparkrdma_tpu_torch.shuffle import handle as thandle
from sparkrdma_tpu_torch.shuffle.errors import MetadataFetchFailedError, ShuffleError
from sparkrdma_tpu_torch.shuffle.manager import TpuShuffleManager
from sparkrdma_tpu_torch.utils.config import TpuShuffleConf
from sparkrdma_tpu_torch.utils.external_sorter import ExternalSorter

torch.set_num_threads(1)

PKGS = {"port": (TpuShuffleManager, TpuShuffleConf, thandle),
        "jax": (JaxManager, JaxConf, jhandle)}


class _Cluster:
    """A driver and two executors of one package over the python
    transport; stopped in ``close``."""

    def __init__(self, pkg, method="wrapper", extra=None, prefix="e2e"):
        manager, conf_cls, self.h = PKGS[pkg]
        self.conf = conf_cls({
            "tpu.shuffle.transport": "python",
            "tpu.shuffle.shuffleWriteMethod": method,
            "tpu.shuffle.shuffleWriteBlockSize": "65536",
            "tpu.shuffle.shuffleReadBlockSize": "65536",
            **(extra or {}),
        })
        self.driver = manager(self.conf, is_driver=True)
        self.execs = [manager(self.conf, is_driver=False,
                              executor_id=f"{prefix}-{pkg}-{i}") for i in range(2)]

    def handle(self, num_maps, partitions, **kw):
        handle = self.h.BaseShuffleHandle(
            shuffle_id=0, num_maps=num_maps,
            partitioner=self.h.HashPartitioner(partitions), **kw)
        self.driver.register_shuffle(handle)
        return handle

    def close(self):
        for m in self.execs + [self.driver]:
            m.stop()


def _records(map_id, n=1500):
    return [(f"key-{(map_id * n + i) % 397}", map_id * n + i) for i in range(n)]


def _run(pkg, method, records=_records, agg=None, key_ordering=False):
    """4 maps (2 an executor), 5 partitions read as [0, 3) and [3, 5);
    returns each reader's records as read, and the readers' metrics."""
    c = _Cluster(pkg, method)
    try:
        kw = {}
        if agg is not None:
            kw = dict(aggregator=c.h.Aggregator(**agg), map_side_combine=True)
        handle = c.handle(4, 5, key_ordering=key_ordering, **kw)
        for map_id, ex in enumerate([c.execs[0], c.execs[0], c.execs[1], c.execs[1]]):
            w = ex.get_writer(handle, map_id)
            w.write(iter(records(map_id)))
            assert w.stop(True).map_id == map_id
        for ex in c.execs:
            ex.finalize_maps(0)
        outs, metrics = [], []
        for ex, (lo, hi) in zip(c.execs, [(0, 3), (3, 5)]):
            reader = ex.get_reader(handle, lo, hi)
            outs.append(list(reader.read()))
            metrics.append(reader.metrics)
        return outs, metrics
    finally:
        c.close()


@pytest.mark.parametrize("method", ["wrapper", "chunkedpartitionagg"])
def test_both_writer_methods_give_jax_records(method):
    got, metrics = _run("port", method)
    want, _ = _run("jax", method)
    for g, w in zip(got, want):
        assert pickle.dumps(sorted(g)) == pickle.dumps(sorted(w))
    assert sum(len(g) for g in got) == 4 * 1500
    for m in metrics:
        # data crossed executors as remote READs or push-merged segments
        assert m.remote_blocks > 0 or m.merged_blocks > 0
        assert m.local_blocks > 0


def test_aggregation_and_key_ordering_as_jax():
    agg = dict(create_combiner=lambda v: v, merge_value=lambda c, v: c + v,
               merge_combiners=lambda a, b: a + b)
    got, _ = _run("port", "wrapper", agg=agg, key_ordering=True)
    want, _ = _run("jax", "wrapper", agg=agg, key_ordering=True)
    assert got == want
    for part in got:
        assert part == sorted(part, key=lambda kv: kv[0])


@pytest.mark.parametrize("threshold, n, spills", [(1000, 500, 0), (100, 1750, 17)])
def test_external_sorter_as_jax(threshold, n, spills):
    rng = random.Random(n)
    data = [(rng.randrange(10_000), i) for i in range(n)]
    got, want = ExternalSorter(spill_threshold=threshold), JaxSorter(spill_threshold=threshold)
    out = list(got.sort(iter(data)))
    assert out == list(want.sort(iter(data)))
    assert [k for k, _ in out] == sorted(k for k, _ in data)
    assert got.spill_count == want.spill_count == spills
    assert got.spilled_records == want.spilled_records


def test_reader_orders_through_external_sorter_with_spills():
    rng = random.Random(2)
    recs = [(rng.randrange(100_000), i) for i in range(5000)]
    outs = {}
    for pkg in ("port", "jax"):
        c = _Cluster(pkg, extra={"tpu.shuffle.reader.sortSpillThreshold": "1024"},
                     prefix="sort")
        try:
            handle = c.handle(1, 1, key_ordering=True)
            w = c.execs[0].get_writer(handle, 0)
            w.write(iter(recs))
            w.stop(True)
            reader = c.execs[0].get_reader(handle, 0, 1)
            outs[pkg] = list(reader.read())
            assert reader.metrics.sort_spills >= 4  # 5000 records / 1024
        finally:
            c.close()
    assert [k for k, _ in outs["port"]] == sorted(k for k, _ in recs)
    assert sorted(outs["port"]) == sorted(outs["jax"])


def _wait(pred, what, timeout_s=10.0):
    deadline = time.monotonic() + timeout_s
    while not pred():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.02)


def test_executor_loss_prunes_locations_and_rearms_the_barrier():
    c = _Cluster("port", extra={"tpu.shuffle.partitionLocationFetchTimeoutMs": "1000"},
                 prefix="loss")
    lost = c.execs[1].executor_id
    try:
        handle = c.handle(2, 2)
        for map_id, ex in enumerate(c.execs):
            w = ex.get_writer(handle, map_id)
            w.write(iter([(f"m{map_id}-{i}", i) for i in range(100)]))
            w.stop(True)
        driver = c.driver

        def maps_done():
            with driver._lock:
                return driver._maps_done.get(0, 0)

        _wait(lambda: maps_done() >= 2, "both map outputs")
        c.execs[1].stop()  # abrupt loss: the driver prunes on peer loss

        def locations():
            with driver._lock:
                return [loc for v in driver._partition_locations[0].values() for loc in v]

        _wait(lambda: all(loc.manager_id.executor_id != lost for loc in locations()),
              "the lost executor's locations to be pruned")
        _wait(lambda: maps_done() < 2, "the map-output barrier to re-arm")
        with pytest.raises(MetadataFetchFailedError):
            list(c.execs[0].get_reader(handle, 0, 2).read())
    finally:
        c.close()


@pytest.mark.parametrize("dirty", [True, False])
def test_chunked_agg_poisoned_only_by_a_dirty_failed_map(dirty):
    c = _Cluster("port", "chunkedpartitionagg",
                 {"tpu.shuffle.shuffleWriteFlushSize": "4096"}, prefix="poison")
    try:
        handle = c.handle(2, 1)
        ok = c.execs[0].get_writer(handle, 0)
        ok.write(iter([("a", i) for i in range(50)]))
        ok.stop(True)
        bad = c.execs[0].get_writer(handle, 1)
        # past the flush size the failed map has flushed frames into
        # the shared logs; one small record stays buffered
        bad.write(iter([("b", "x" * 256) for _ in range(100)] if dirty else [("b", 2)]))
        bad.stop(False)
        if dirty:
            with pytest.raises(ShuffleError):
                c.execs[0].finalize_maps(0)
        else:
            c.execs[0].finalize_maps(0)
    finally:
        c.close()


@pytest.mark.parametrize("lengths, block_size", [
    ([5000, 0, 12000, 300, 70000, 1, 0, 9999], 16384),
    ([10, 20, 30], 8 << 20),
])
def test_mapped_file_locations_equal_jax(tmp_path, lengths, block_size):
    payload = b"".join(bytes([i % 251]) * n for i, n in enumerate(lengths))
    files = {}
    for pkg, (mf_cls, pd_cls) in (("port", (MappedFile, ProtectionDomain)),
                                  ("jax", (JaxMappedFile, JaxPD))):
        path = str(tmp_path / f"{pkg}.data")
        with open(path, "wb") as f:
            f.write(payload)
        pd = pd_cls()
        files[pkg] = (mf_cls(path, pd, block_size=block_size, partition_lengths=lengths),
                      pd, path)
    (mf, pd, path), (jmf, jpd, _) = files["port"], files["jax"]
    off = 0
    for pid, n in enumerate(lengths):
        loc, jloc = mf.get_partition_location(pid), jmf.get_partition_location(pid)
        assert (loc.address, loc.length, loc.mkey) == (jloc.address, jloc.length, jloc.mkey)
        if n:
            got = bytes(pd.resolve(loc.mkey, loc.address, loc.length))
            assert got == payload[off:off + n] == bytes(mf.get_partition_view(pid))
        off += n
    assert pd.region_count() == jpd.region_count()
    mf.dispose()
    jmf.dispose()
    assert pd.region_count() == 0 and not os.path.exists(path)
    with open(path, "wb") as f:
        f.write(b"x" * 100)
    with pytest.raises(ValueError):
        MappedFile(path, ProtectionDomain(), block_size=4096, partition_lengths=[99])
    os.unlink(path)


def test_columnar_records_cross_executors_as_jax():
    """The wrapper writer with ``block.format=auto`` on numpy records:
    columnar blocks, zero-copy decode, and the JAX cluster's records."""
    def recs(map_id, n=1200):
        k = np.arange(map_id * n, (map_id + 1) * n, dtype=np.uint32) % np.uint32(389)
        return list(zip(k, k.astype(np.int64) * 3))

    got, _ = _run("port", "wrapper", records=recs)
    want, _ = _run("jax", "wrapper", records=recs)
    key = lambda r: (int(r[0]), int(r[1]))  # noqa: E731
    for g, w in zip(got, want):
        assert pickle.dumps(sorted(g, key=key)) == pickle.dumps(sorted(w, key=key))
