"""The port's sharded metadata store against the JAX package's: the same
seeded sequence of publishes, resolves, executor sweeps, peer kills and a
hub wipe with its fenced re-adoption gives the same primary view, the
same resolve answers and the same epochs on both."""

import dataclasses

import numpy as np
import pytest
import torch

from sparkrdma_tpu import locations as jloc
from sparkrdma_tpu.metastore import ShardedMetaStore as JaxStore
from sparkrdma_tpu.metastore import StaleEpochError as JaxStale
from sparkrdma_tpu.utils.config import TpuShuffleConf as JaxConf
from sparkrdma_tpu_torch import locations as tloc
from sparkrdma_tpu_torch.metastore import ShardedMetaStore as TorchStore
from sparkrdma_tpu_torch.metastore import StaleEpochError as TorchStale
from sparkrdma_tpu_torch.utils.config import TpuShuffleConf

torch.set_num_threads(1)

EXECS = [f"ms-exec-{i}" for i in range(5)]


class _Clock:
    """A lease clock the test advances by hand."""

    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def _view(store):
    return {
        sid: {pid: sorted((dataclasses.astuple(loc.manager_id),
                           dataclasses.astuple(loc.block)) for loc in locs)
              for pid, locs in parts.items()}
        for sid, parts in store.all_entries().items()
    }


def _resolve(store, sid, lo, hi):
    return [(loc.partition_id, loc.manager_id.executor_id, loc.block.mkey)
            for loc in store.resolve_range(sid, lo, hi)]


def _run(mod, store_cls, stale_cls, conf, seed):
    """The seeded sequence on one package; returns what it observed."""
    rng = np.random.default_rng(seed)
    clock = _Clock()
    store = store_cls(conf, role=f"ms-{seed}", clock=clock)
    seen = []

    def locs_for(exec_id, n, parts):
        return [
            mod.PartitionLocation(
                mod.ShuffleManagerId("127.0.0.1", 7000 + EXECS.index(exec_id),
                                     exec_id),
                int(rng.integers(0, parts)),
                mod.BlockLocation(0, int(rng.integers(1, 1 << 20)),
                                  int(rng.integers(1, 1 << 30)),
                                  device_coords=int(rng.integers(-1, 2)),
                                  arena_handle=int(rng.integers(0, 99))),
            )
            for _ in range(n)
        ]

    for sid, parts in ((3, 40), (4, 7)):
        store.ensure_shuffle(sid, parts)
        for e in EXECS:
            store.publish(sid, locs_for(e, int(rng.integers(1, 12)), parts))
    seen.append(("published", _view(store), _resolve(store, 3, 5, 30)))
    # a dead executor's locations go, shard by shard
    seen.append(("swept", store.sweep_executor(EXECS[2], 3)))
    seen.append(("after_sweep", _view(store), _resolve(store, 3, 0, 40)))
    # a metadata peer dies: its ranges remap, the follower copies serve
    gen = store.kill_peer(store.live_peers()[1])
    seen.append(("killed", gen, sorted(store.live_peers()),
                 _view(store), _resolve(store, 4, 0, 7)))
    # leases lapse and are taken over on the next write
    clock.t += 3600.0
    store.publish(4, locs_for(EXECS[0], 3, 7))
    seen.append(("takeover", _view(store)))
    # hub wipe; a re-adoption under the new generation lands, one under
    # the old is refused whole
    gen = store.wipe()
    store.publish(3, locs_for(EXECS[1], 4, 40), fence_generation=gen)
    try:
        store.publish(3, locs_for(EXECS[3], 4, 40), fence_generation=gen - 1)
        refused = False
    except stale_cls:
        refused = True
    seen.append(("readopted", gen, refused, _view(store),
                 _resolve(store, 3, 0, 40)))
    store.drop_shuffle(4)
    seen.append(("dropped", sorted(store.shuffle_ids()), _view(store)))
    return seen


@pytest.mark.parametrize("knobs", [
    {},
    {"tpu.shuffle.metastore.peers": "5", "tpu.shuffle.metastore.replicas": "2",
     "tpu.shuffle.metastore.rangeSize": "3"},
])
@pytest.mark.parametrize("seed", [0, 1])
def test_metastore_sequence_matches_jax(knobs, seed):
    want = _run(jloc, JaxStore, JaxStale, JaxConf(knobs), seed)
    got = _run(tloc, TorchStore, TorchStale, TpuShuffleConf(knobs), seed)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g == w, g[0]
    # the sequence really exercised the store
    assert want[0][1][3] and want[1][1] > 0 and want[-2][2]
