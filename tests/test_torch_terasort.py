"""models/terasort.py of the port against the JAX package's on the same
keys and edges, uniform and zipf-skewed: MapShardSorter's sorted keys
and bounds (also after ``warm``), the one-device TeraSorter step and a
two-shard sort (the SPMD path in full:
tests/test_torch_spmd_terasort.py). Exact comparisons."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparkrdma_tpu.models.terasort import MapShardSorter as JaxSorter
from sparkrdma_tpu.models.terasort import TeraSorter as JaxTeraSorter
from sparkrdma_tpu.parallel.mesh import make_mesh
from sparkrdma_tpu_torch.models.terasort import (
    MapShardSorter,
    TeraSorter,
    merge_blocks,
)
from sparkrdma_tpu_torch.parallel import make_mesh as make_port_mesh

torch.set_num_threads(1)


def _keys(kind, n, seed=11):
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        k = rng.integers(0, 1 << 32, n, dtype=np.uint32)
    else:
        # zipf-skewed: a few hot keys, spread over the whole key space
        z = np.minimum(rng.zipf(1.2, n), 1 << 20).astype(np.uint64)
        k = ((z * 2654435761) % (1 << 32)).astype(np.uint32)
    k[: min(n, 3)] = [0xFFFFFFFF, 1 << 31, 0][: min(n, 3)]
    return k


def _edges(kind, keys, reducers):
    if kind == "static":
        return np.asarray([(r << 32) // reducers for r in range(1, reducers)],
                          np.uint32)
    return np.quantile(keys, np.arange(1, reducers) / reducers).astype(np.uint32)


@pytest.mark.parametrize("n", [5, 1000, 3000, 1 << 15])
@pytest.mark.parametrize("dist", ["uniform", "zipf"])
@pytest.mark.parametrize("edge_kind", ["static", "sampled"])
def test_map_shard_sorter_matches_jax(n, dist, edge_kind):
    keys = _keys(dist, n)
    edges = _edges(edge_kind, keys, 4)
    j_sorted, j_bounds = JaxSorter().sort_partition(keys, edges)
    t_sorted, t_bounds = MapShardSorter("cpu").sort_partition(keys, edges)
    assert t_sorted.dtype == np.uint32
    np.testing.assert_array_equal(t_sorted, j_sorted)
    np.testing.assert_array_equal(t_bounds, np.asarray(j_bounds))
    np.testing.assert_array_equal(t_sorted, np.sort(keys))


def test_map_shard_sorter_clamps_cuts_to_valid_count():
    keys = np.arange(10, dtype=np.uint32)
    # an edge above every real key must not reach the sentinel padding
    edges = np.asarray([5, 0xFFFFFFFF], np.uint32)
    _, bounds = MapShardSorter("cpu").sort_partition(keys, edges)
    np.testing.assert_array_equal(bounds, [0, 5, 10, 10])


def test_map_shard_sorter_warm_then_sorts_as_jax():
    keys = _keys("zipf", 3000)
    edges = _edges("sampled", keys, 4)
    jax_sorter, sorter = JaxSorter(), MapShardSorter("cpu")
    assert jax_sorter.warm(len(keys), len(edges)) is None
    assert sorter.warm(len(keys), len(edges)) is None
    t_sorted, t_bounds = sorter.sort_partition(keys, edges)
    j_sorted, j_bounds = jax_sorter.sort_partition(keys, edges)
    np.testing.assert_array_equal(t_sorted, j_sorted)
    np.testing.assert_array_equal(t_bounds, np.asarray(j_bounds))


@pytest.mark.parametrize("dist", ["uniform", "zipf"])
def test_one_device_step_matches_jax(dist):
    n_local = 1 << 12
    keys = _keys(dist, n_local)
    j_step = JaxTeraSorter(make_mesh(jax.devices()[:1])).step(n_local)
    jm, jt, jo = j_step(jnp.asarray(keys))
    tm, tt, to = TeraSorter(device="cpu").step(n_local)(torch.from_numpy(keys))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    assert int(to) == int(jo) == 0
    np.testing.assert_array_equal(
        TeraSorter(device="cpu").sort(keys), np.sort(keys)
    )


def test_more_than_one_shard_waits_for_the_exchange():
    """More than one shard runs the exchange: a two-shard mesh sorts."""
    keys = _keys("zipf", 3001)
    sorter = TeraSorter(make_port_mesh(["cpu"] * 2))
    assert sorter.num_shards == 2
    np.testing.assert_array_equal(sorter.sort(keys), np.sort(keys))
    np.testing.assert_array_equal(
        sorter.sort(keys), JaxTeraSorter(make_mesh(jax.devices()[:2])).sort(keys)
    )


def test_merge_blocks_sorts_the_partition():
    blocks = [np.sort(_keys("uniform", n, seed=n)) for n in (700, 0, 33)]
    merged, total = merge_blocks([torch.from_numpy(b) for b in blocks])
    want = np.sort(np.concatenate(blocks))
    assert int(total) == len(want)
    np.testing.assert_array_equal(merged[: int(total)].numpy(), want)
