"""The port's push/merge plane (``shuffle/merge.py``: ``PushClient``,
``MergeEndpoint``) against the JAX package's: the endpoint's dedup,
complete-coverage seal and budget drop take the same pushes to the same
counters and the same merged segment, and a chunked-agg shuffle reads
one merged segment a partition with the JAX cluster's records; push off
gives the same records and no merged location."""

import time

import pytest
import torch

from sparkrdma_tpu.obs import get_registry as jax_registry
from sparkrdma_tpu.shuffle import handle as jhandle
from sparkrdma_tpu.shuffle.manager import TpuShuffleManager as JaxManager
from sparkrdma_tpu.utils.config import TpuShuffleConf as JaxConf
from sparkrdma_tpu_torch.obs import get_registry
from sparkrdma_tpu_torch.shuffle import handle as thandle
from sparkrdma_tpu_torch.shuffle import merge
from sparkrdma_tpu_torch.shuffle.manager import TpuShuffleManager
from sparkrdma_tpu_torch.utils.config import TpuShuffleConf

torch.set_num_threads(1)

PKGS = {"port": (TpuShuffleManager, TpuShuffleConf, thandle, get_registry),
        "jax": (JaxManager, JaxConf, jhandle, jax_registry)}


def _counters(reg, before, prefix, role):
    delta = reg.delta(before, prefix=prefix).get("counters", {})
    out = {}
    for k, v in delta.items():
        if f"role={role}" in k or "role" not in k:
            name = k.split("{")[0]
            out[name] = out.get(name, 0) + v
    return out


def _merged_locations(driver, sid, pid, timeout_s=10.0):
    """The driver's merged locations of (sid, pid), once the executor's
    publish has landed (it travels asynchronously)."""
    deadline = time.monotonic() + timeout_s
    while True:
        locs = driver._partition_locations.get(sid, {}).get(pid, [])
        merged_locs = [loc for loc in locs if loc.block.merged_cover]
        if merged_locs or time.monotonic() > deadline:
            return merged_locs
        time.sleep(0.02)


def _endpoint_run(pkg, tag, conf_extra, num_maps, pushes):
    """One executor's merge endpoint fed ``pushes`` (source, blocks,
    final) for shuffle 31, pid 0. Returns the push.* counter deltas and
    the merged segments the driver holds, with their bytes."""
    manager, conf_cls, h, registry = PKGS[pkg]
    conf = conf_cls({"tpu.shuffle.transport": "python", **conf_extra})
    driver = manager(conf, is_driver=True)
    ex = manager(conf, is_driver=False, executor_id=f"mep-{tag}-{pkg}")
    reg = registry()
    try:
        assert ex.merge_endpoint is not None and ex.push_client is not None
        driver.register_shuffle(h.BaseShuffleHandle(
            shuffle_id=31, num_maps=num_maps, partitioner=h.HashPartitioner(1)))
        before = reg.snapshot(prefix="push.")
        for source, blocks, final in pushes:
            ex.merge_endpoint.push_blocks(31, source, blocks, final=final)
        counters = _counters(reg, before, "push.", ex.executor_id)
        sealed = counters.get("push.merge_segments", 0)
        merged_locs = _merged_locations(driver, 31, 0) if sealed else []
        segments = [(loc.block.merged_cover, bytes(ex.node.pd.resolve(
            loc.block.mkey, 0, loc.block.length))) for loc in merged_locs]
        return counters, segments
    finally:
        ex.stop()
        driver.stop()


def _final(counts, num_maps):
    return {"counts": counts, "committed": 1, "num_maps": num_maps}


def test_merge_endpoint_dedup_and_coverage_seal_as_jax():
    pushes = [
        ("src-a", [(0, 0, b"aaaa")], None),
        ("src-a", [(0, 0, b"aaaa")], None),  # duplicate delivery
        ("src-a", [], _final({0: 1}, 2)),
        ("src-b", [(0, 0, b"bbbb")], _final({0: 1}, 2)),
    ]
    got = _endpoint_run("port", "seal", {}, 2, pushes)
    assert got == _endpoint_run("jax", "seal", {}, 2, pushes)
    counters, segments = got
    assert counters["push.dedup_drops"] == 1 and counters["push.merge_segments"] == 1
    # sources in natural order, then seq; the cover is both sources' blocks
    assert segments == [(2, b"aaaabbbb")]


def test_merge_endpoint_waits_for_every_source():
    pushes = [("src-a", [(0, 0, b"aaaa")], _final({0: 1}, 2))]
    counters, segments = _endpoint_run("port", "wait", {}, 2, pushes)
    assert counters.get("push.merge_segments", 0) == 0 and segments == []


def test_merge_endpoint_budget_drop_as_jax():
    # 64 KiB is the knob's floor; two ~40 KB pushes blow it
    conf = {"tpu.shuffle.push.maxBufferBytes": "65536"}
    pushes = [
        ("src-a", [(0, 0, b"x" * 40_000)], None),
        ("src-a", [(0, 1, b"y" * 40_000)], None),
        ("src-a", [], _final({0: 2}, 1)),
    ]
    got = _endpoint_run("port", "budget", conf, 1, pushes)
    assert got == _endpoint_run("jax", "budget", conf, 1, pushes)
    counters, segments = got
    assert counters["push.budget_drops"] >= 1 and segments == []
    assert counters.get("push.merge_segments", 0) == 0


def _push_shuffle(pkg, push_on, partitions=5):
    """Four chunked-agg maps on two executors, then each executor reads
    its slice. Returns the records, the readers' merged reads and the
    push.* deltas."""
    manager, conf_cls, h, registry = PKGS[pkg]
    conf = conf_cls({"tpu.shuffle.transport": "python",
                     "tpu.shuffle.shuffleWriteMethod": "chunkedpartitionagg",
                     "tpu.shuffle.shuffleWriteBlockSize": "65536",
                     "tpu.shuffle.shuffleReadBlockSize": "65536",
                     "tpu.shuffle.push.enabled": "true" if push_on else "false"})
    driver = manager(conf, is_driver=True)
    tag = "on" if push_on else "off"
    execs = [manager(conf, is_driver=False, executor_id=f"pe2e-{tag}-{pkg}-{i}")
             for i in range(2)]
    reg = registry()
    before = reg.snapshot(prefix="push.")
    try:
        assert all((ex.push_client is not None) == push_on for ex in execs)
        handle = h.BaseShuffleHandle(shuffle_id=0, num_maps=4,
                                     partitioner=h.HashPartitioner(partitions))
        driver.register_shuffle(handle)
        for map_id in range(4):
            w = execs[map_id // 2].get_writer(handle, map_id)
            w.write(iter((f"key-{(map_id * 3000 + i) % 997}", map_id * 3000 + i)
                         for i in range(3000)))
            assert w.stop(True) is not None
        for ex in execs:
            ex.finalize_maps(0)
        out, merged_reads = [], 0
        for ex, (lo, hi) in zip(execs, [(0, 3), (3, partitions)]):
            reader = ex.get_reader(handle, lo, hi)
            out.extend(reader.read())
            merged_reads += reader.metrics.merged_blocks
        pushed = sum(_counters(reg, before, "push.", ex.executor_id)
                     .get("push.merge_segments", 0) for ex in execs)
        return sorted(out), merged_reads, pushed
    finally:
        for ex in execs:
            ex.stop()
        driver.stop()


@pytest.mark.parametrize("push_on", [True, False])
def test_push_shuffle_reads_merged_segments_as_jax(push_on):
    out, merged_reads, sealed = _push_shuffle("port", push_on)
    want, jax_merged_reads, jax_sealed = _push_shuffle("jax", push_on)
    assert out == want
    assert len(out) == 4 * 3000
    if push_on:
        # every partition sealed and was read as its one merged segment
        assert sealed == jax_sealed == 5
        assert merged_reads == jax_merged_reads == 5
    else:
        assert sealed == merged_reads == 0


def test_endpoint_registry_keys_by_driver_port_and_executor():
    manager, conf_cls, _, _ = PKGS["port"]
    conf = conf_cls({"tpu.shuffle.transport": "python"})
    driver = manager(conf, is_driver=True)
    ex = manager(conf, is_driver=False, executor_id="reg-0")
    try:
        ep = ex.merge_endpoint
        assert merge.endpoint_for(conf.driver_port, "reg-0") is ep
        assert merge.endpoint_for(conf.driver_port + 1, "reg-0") is None
    finally:
        ex.stop()
        driver.stop()
    assert merge.endpoint_for(conf.driver_port, "reg-0") is None
