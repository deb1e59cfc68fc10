"""The port's SPMD TeraSorter against the JAX package's on the 8-device
CPU mesh, fed the same numpy keys: ``step``'s merged / totals /
overflowed shard by shard at E in {2, 4, 8} (static and sampled range
edges, with and without overflow), and ``sort`` against JAX and
``np.sort`` — the all-zero overflow retry with as many attempts as JAX,
the adaptive plan, the (dcn, exec) mesh, a length that is not a
multiple of E. Exact comparisons."""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

from sparkrdma_tpu.models.terasort import TeraSorter as JaxTeraSorter
from sparkrdma_tpu.parallel import mesh as jmesh
from sparkrdma_tpu.shuffle.planner import plan_edges
from sparkrdma_tpu_torch.convert import shards_from_jax
from sparkrdma_tpu_torch.models.terasort import TeraSorter
from sparkrdma_tpu_torch.parallel import make_mesh

torch.set_num_threads(1)


def _keys(kind, n, seed=11):
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        return rng.integers(0, 1 << 32, n, dtype=np.uint32)
    # zipf-skewed: a few hot keys, spread over the whole key space
    z = np.minimum(rng.zipf(1.2, n), 1 << 20).astype(np.uint64)
    return ((z * 2654435761) % (1 << 32)).astype(np.uint32)


def _meshes(e, num_slices=None):
    return (jmesh.make_mesh(jax.devices()[:e], num_slices=num_slices),
            make_mesh(["cpu"] * e, num_slices=num_slices))


def _spy(sorter):
    """Record the capacity class of every step ``sorter.sort`` builds."""
    calls = []
    step = sorter.step

    def spied(n_local, capacity=None, adaptive=False):
        calls.append(capacity)
        return step(n_local, capacity, adaptive=adaptive)

    sorter.step = spied
    return calls


@pytest.mark.parametrize("e", [2, 4, 8])
@pytest.mark.parametrize("case", ["uniform", "skewed_overflow", "adaptive_edges"])
def test_step_matches_jax(e, case):
    n_local = 512
    keys = _keys("uniform" if case == "uniform" else "zipf", e * n_local, seed=e)
    jm, tm = _meshes(e)
    jsorter, tsorter = JaxTeraSorter(jm), TeraSorter(tm)
    # shard i of the JAX array is shard i of the port's stack
    sharded = jax.device_put(keys, NamedSharding(jm, jmesh.shard_spec(jm)))
    tkeys = shards_from_jax(np.asarray(sharded), tm).reshape(-1)
    capacity = 80 if case == "skewed_overflow" else None
    if case == "adaptive_edges":
        edges = plan_edges(keys[::7], e)
        cap = tsorter.default_capacity(n_local)
        jout = jsorter.step(n_local, cap, adaptive=True)(sharded, jax.numpy.asarray(edges))
        tout = tsorter.step(n_local, cap, adaptive=True)(tkeys, torch.from_numpy(edges))
    else:
        jout = jsorter.step(n_local, capacity)(sharded)
        tout = tsorter.step(n_local, capacity)(tkeys)
    jm_, jt, jo = (np.asarray(x) for x in jout)
    tm_, tt, to = tout
    assert tm_.dtype == torch.uint32 and tt.dtype == torch.int32
    assert tm_.shape == jm_.shape and tt.shape == jt.shape == (e,)
    for i in range(e):  # shard by shard
        np.testing.assert_array_equal(tm_.numpy().reshape(e, -1)[i],
                                      jm_.reshape(e, -1)[i])
    np.testing.assert_array_equal(tt.numpy(), jt)
    assert int(to) == int(jo) == (1 if case == "skewed_overflow" else 0)


@pytest.mark.parametrize("e", [2, 4, 8])
@pytest.mark.parametrize("n", [1000, 4096])
def test_sort_matches_jax_and_numpy(e, n):
    keys = _keys("uniform", n, seed=n + e)
    jm, tm = _meshes(e)
    got = TeraSorter(tm).sort(keys)
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, JaxTeraSorter(jm).sort(keys))
    np.testing.assert_array_equal(got, np.sort(keys))


@pytest.mark.parametrize("adaptive", [False, True])
def test_skewed_overflow_retry_matches_jax(adaptive):
    """All keys in one range: the static plan overflows and doubles its
    capacity as often as JAX does; the adaptive plan sizes it from the
    sample and runs once."""
    keys = np.zeros(4096, dtype=np.uint32)
    jm, tm = _meshes(8)
    jsorter = JaxTeraSorter(jm, capacity_factor=1.25)
    tsorter = TeraSorter(tm, capacity_factor=1.25)
    jcalls, tcalls = _spy(jsorter), _spy(tsorter)
    want = jsorter.sort(keys, adaptive=adaptive)
    got = tsorter.sort(keys, adaptive=adaptive)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, keys)
    assert tcalls == jcalls == tsorter.last_capacities
    assert len(tcalls) == (1 if adaptive else 4)
    assert tcalls[-1] == 512  # capped at n_local


@pytest.mark.parametrize("e", [4, 8])
def test_adaptive_sort_of_zipf_keys_matches_jax(e):
    keys = _keys("zipf", 6000, seed=5)
    jm, tm = _meshes(e)
    jsorter, tsorter = JaxTeraSorter(jm), TeraSorter(tm)
    jcalls, tcalls = _spy(jsorter), _spy(tsorter)
    got = tsorter.sort(keys, adaptive=True)
    np.testing.assert_array_equal(got, jsorter.sort(keys, adaptive=True))
    np.testing.assert_array_equal(got, np.sort(keys))
    assert tcalls == jcalls


def test_two_d_mesh_matches_jax():
    keys = _keys("uniform", 8192, seed=7)
    jm, tm = _meshes(8, num_slices=2)
    assert tm.shape == {"dcn": 2, "exec": 4}
    got = TeraSorter(tm).sort(keys)
    np.testing.assert_array_equal(got, JaxTeraSorter(jm).sort(keys))
    np.testing.assert_array_equal(got, np.sort(keys))


def test_length_not_a_multiple_of_the_shards():
    keys = _keys("uniform", 1003, seed=3)  # 1003 % 8 != 0
    jm, tm = _meshes(8)
    got = TeraSorter(tm).sort(keys)
    np.testing.assert_array_equal(got, JaxTeraSorter(jm).sort(keys))
    np.testing.assert_array_equal(got, np.sort(keys))


def test_sorter_checks():
    with pytest.raises(ValueError, match="power-of-two"):
        TeraSorter(make_mesh(["cpu"] * 6))
    sorter = TeraSorter(make_mesh(["cpu"] * 4))
    fn = sorter.step(64)
    with pytest.raises(ValueError):
        fn(torch.zeros(64, dtype=torch.uint32))  # one shard's worth, not four
    with pytest.raises(ValueError):
        fn(torch.zeros(256, dtype=torch.int32))
    with pytest.raises(ValueError, match="edges"):
        sorter.step(64, adaptive=True)(torch.zeros(256, dtype=torch.uint32))
    assert sorter.step(64) is fn  # one step per shape class
    assert sorter.device == torch.device("cpu") and sorter.num_shards == 4
