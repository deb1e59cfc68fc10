"""The whole slice, JAX package against port: 4 map executors sort and
cut their shards, stage the blocks into their arenas, and 4 reducers
compile their partitions into waves, pull them and merge. Each
reducer's merged keys are byte-identical between the two flows and
equal to np.sort of its key range."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparkrdma_tpu import locations as jloc
from sparkrdma_tpu.models.terasort import MapShardSorter as JaxSorter
from sparkrdma_tpu.ops.hbm_arena import DeviceBufferManager as JaxArena
from sparkrdma_tpu.ops.sort import merge_received as jax_merge
from sparkrdma_tpu.shuffle import device_fetch as jdf
from sparkrdma_tpu.shuffle.collective import ShuffleScheduleCompiler as JaxCompiler
from sparkrdma_tpu.utils.config import TpuShuffleConf as JaxConf
from sparkrdma_tpu_torch import locations as tloc
from sparkrdma_tpu_torch.models.terasort import MapShardSorter, merge_blocks
from sparkrdma_tpu_torch.obs import get_registry
from sparkrdma_tpu_torch.ops.hbm_arena import DeviceBufferManager as TorchArena
from sparkrdma_tpu_torch.shuffle import device_fetch as tdf
from sparkrdma_tpu_torch.shuffle.collective import ShuffleScheduleCompiler
from sparkrdma_tpu_torch.utils.config import TpuShuffleConf

torch.set_num_threads(1)

EXECUTORS = 4
REDUCERS = 4
KEYS_PER_SHARD = 1 << 15
SENTINEL = 0xFFFFFFFF


def _shards(dist):
    rng = np.random.default_rng(12)
    if dist == "uniform":
        return [rng.integers(0, 1 << 32, KEYS_PER_SHARD, dtype=np.uint32)
                for _ in range(EXECUTORS)]
    # zipf-skewed, spread over the key space: ragged block lengths
    return [((np.minimum(rng.zipf(1.5, KEYS_PER_SHARD), 1 << 20)
              .astype(np.uint64) * 2654435761) % (1 << 32)).astype(np.uint32)
            for _ in range(EXECUTORS)]


EDGES = np.asarray([(r << 32) // REDUCERS for r in range(1, REDUCERS)], np.uint32)


def _map_phase(side, shards, tag):
    """Sort + cut every shard, stage each block; returns the arenas, the
    per-reducer locations and the executor ids."""
    if side == "jax":
        sorter, mk_arena, loc, df = JaxSorter(), JaxArena, jloc, jdf
    else:
        sorter, loc, df = MapShardSorter("cpu"), tloc, tdf

        def mk_arena():
            return TorchArena("cpu")
    ids = [f"{tag}-{side}-{e}" for e in range(EXECUTORS)]
    arenas = [mk_arena() for _ in ids]
    locs = {r: [] for r in range(REDUCERS)}
    for e, (eid, arena) in enumerate(zip(ids, arenas)):
        df.register_arena(eid, arena)
        keys, bounds = sorter.sort_partition(shards[e], EDGES)
        for r in range(REDUCERS):
            blk = np.ascontiguousarray(keys[bounds[r]:bounds[r + 1]])
            buf = arena.stage_view(blk, blk.nbytes, np.uint32)
            locs[r].append(loc.PartitionLocation(
                loc.ShuffleManagerId("localhost", 0, eid), r,
                loc.BlockLocation(0, blk.nbytes, e + 1, device_coords=0,
                                  arena_handle=buf.handle),
            ))
    return arenas, locs, ids


def _reduce_jax(arenas, locs, knobs, fused):
    out = []
    for r in range(REDUCERS):
        comp = JaxCompiler(JaxConf(knobs), arenas[r], f"slice-jax-{r}")
        results, degraded = comp.execute(
            0, comp.plan(locs[r], np.uint32), np.uint32, fused=fused
        )
        assert not degraded
        blocks = [np.asarray(res.dev.array)[: res.dev.length // 4]
                  for res in results]
        for res in results:
            res.dev.free()
        counts = np.asarray([len(b) for b in blocks], np.int32)
        slab = np.zeros((len(blocks), max(counts)), np.uint32)
        for i, b in enumerate(blocks):
            slab[i, : len(b)] = b
        merged, total = jax_merge(jnp.asarray(slab), jnp.asarray(counts),
                                  SENTINEL)
        out.append(np.asarray(merged)[: int(total)])
    return out


def _reduce_torch(arenas, ids, locs, knobs, fused):
    out, fused_merges = [], 0
    for r in range(REDUCERS):
        comp = ShuffleScheduleCompiler(TpuShuffleConf(knobs), arenas[r], ids[r])
        counter = get_registry().counter("collective.fused_merges", role=ids[r])
        f0 = counter.value
        results, degraded = comp.execute(
            0, comp.plan(locs[r], np.uint32), np.uint32, fused=fused
        )
        assert not degraded
        merged, total = merge_blocks(
            [res.dev.array[: res.dev.length // 4] for res in results]
        )
        for res in results:
            res.dev.free()
        fused_merges += counter.value - f0
        out.append(merged[: int(total)].numpy())
    return out, fused_merges


RUNS = {
    "default": ({}, False),
    "pipelined": ({"tpu.shuffle.collective.waveBytes": "64k"}, False),
    "fused": ({"tpu.shuffle.collective.waveBytes": "512m"}, True),
}


@pytest.mark.parametrize("kernel_path", [False, True])
@pytest.mark.parametrize("run", sorted(RUNS))
@pytest.mark.parametrize("dist", ["uniform", "zipf"])
def test_slice_matches_jax_and_np_sort(monkeypatch, dist, run, kernel_path):
    if kernel_path:
        # the CUDA branch of the compiler with the wave pull's plain version
        monkeypatch.setattr(ShuffleScheduleCompiler, "_kernel_path",
                            lambda self: True)
    knobs, fused = RUNS[run]
    shards = _shards(dist)
    tag = f"{dist}-{run}-{kernel_path}"
    jarenas, jlocs, jids = _map_phase("jax", shards, tag)
    tarenas, tlocs, tids = _map_phase("torch", shards, tag)
    try:
        want = _reduce_jax(jarenas, jlocs, knobs, fused)
        got, fused_merges = _reduce_torch(tarenas, tids, tlocs, knobs, fused)
    finally:
        for eid, a in zip(jids, jarenas):
            jdf.unregister_arena(eid, a)
        for eid, a in zip(tids, tarenas):
            tdf.unregister_arena(eid, a)
    everything = np.sort(np.concatenate(shards))
    cuts = np.concatenate([[0], np.searchsorted(everything, EDGES),
                           [len(everything)]])
    for r in range(REDUCERS):
        assert got[r].dtype == np.uint32
        assert got[r].tobytes() == want[r].tobytes()
        np.testing.assert_array_equal(got[r], everything[cuts[r]:cuts[r + 1]])
    assert fused_merges == (REDUCERS if fused else 0)
