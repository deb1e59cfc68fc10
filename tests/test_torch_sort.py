"""ops/sort.py of the port against the JAX package's, on the same numpy
inputs: uint32 keys at and above 2^31, the 0xFFFFFFFF sentinel, and
overflowing capacities. Every comparison is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparkrdma_tpu.ops import sort as jsort
from sparkrdma_tpu_torch.ops import sort as tsort

torch.set_num_threads(1)

SENTINEL = 0xFFFFFFFF


def _keys(seed, n, high=True):
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 1 << 32, n, dtype=np.uint32)
    if high:
        # keys at and above 2^31 and the sentinel itself
        k[: min(n, 6)] = [0, (1 << 31) - 1, 1 << 31, (1 << 31) + 1,
                          SENTINEL, SENTINEL][: min(n, 6)]
    return k


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _eq(jax_out, torch_out):
    a, b = np.asarray(jax_out), _np(torch_out)
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    assert a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("shape", [(1,), (1000,), (4097,), (8, 300)])
@pytest.mark.parametrize("dtype", [np.uint32, np.int32, np.uint8])
def test_device_sort(shape, dtype):
    rng = np.random.default_rng(1)
    info = np.iinfo(dtype)
    x = rng.integers(info.min, int(info.max) + 1, shape, dtype=dtype)
    if dtype == np.uint32:
        flat = x.reshape(-1)
        flat[:6] = _keys(1, 6)[: flat.size]
    _eq(jsort.device_sort(jnp.asarray(x)), tsort.device_sort(torch.from_numpy(x)))


@pytest.mark.parametrize("side", ["left", "right"])
def test_searchsorted(side):
    keys = np.sort(_keys(2, 5000))
    q = np.concatenate([_keys(3, 100), keys[::97]])
    want = jnp.searchsorted(jnp.asarray(keys), jnp.asarray(q), side=side)
    got = tsort.searchsorted(torch.from_numpy(keys), torch.from_numpy(q), side=side)
    _eq(want, got)


@pytest.mark.parametrize("p", [1, 2, 8, 64])
def test_radix_partition(p):
    keys = _keys(4, 3000)
    _eq(jsort.radix_partition(jnp.asarray(keys), p),
        tsort.radix_partition(torch.from_numpy(keys), p))
    signed = np.random.default_rng(5).integers(-(1 << 31), 1 << 31, 3000,
                                               dtype=np.int32)
    _eq(jsort.radix_partition(jnp.asarray(signed), p),
        tsort.radix_partition(torch.from_numpy(signed), p))


def test_radix_partition_rejects_non_power_of_two():
    with pytest.raises(ValueError):
        tsort.radix_partition(torch.zeros(4, dtype=torch.int32), 3)


@pytest.mark.parametrize("capacity", [400, 64, 1])
@pytest.mark.parametrize("dtype", [np.uint32, np.int32])
def test_pack_by_partition(capacity, dtype):
    rng = np.random.default_rng(6)
    n, p = 1000, 8
    values = (_keys(6, n) if dtype == np.uint32
              else rng.integers(-(1 << 31), 1 << 31, n, dtype=np.int32))
    dest = rng.integers(0, p, n, dtype=np.int32)
    dest[:300] = 3  # one hot partition: overflows the small capacities
    fill = SENTINEL if dtype == np.uint32 else -7
    j = jsort.pack_by_partition(jnp.asarray(values), jnp.asarray(dest), p,
                                capacity, fill=fill)
    t = tsort.pack_by_partition(torch.from_numpy(values), torch.from_numpy(dest),
                                p, capacity, fill=fill)
    for a, b in zip(j, t):
        _eq(a, b)
    assert bool(t[2]) == (capacity < 300)


@pytest.mark.parametrize("p,capacity", [(2, 4000), (8, 1500), (8, 200)])
def test_split_sorted(p, capacity):
    keys = np.sort(_keys(7, 6000))
    j = jsort.split_sorted(jnp.asarray(keys), p, capacity, fill=SENTINEL)
    t = tsort.split_sorted(torch.from_numpy(keys), p, capacity, fill=SENTINEL)
    for a, b in zip(j, t):
        _eq(a, b)
    assert bool(t[2]) == (capacity == 200)


@pytest.mark.parametrize("capacity", [5000, 100])
def test_split_sorted_edges(capacity):
    rng = np.random.default_rng(8)
    # zipf-skewed keys, three partitions at sampled quantiles
    keys = np.sort(np.minimum(rng.zipf(1.3, 6000), SENTINEL).astype(np.uint32)
                   * np.uint32(2654435761 % (1 << 31)))
    edges = np.quantile(keys, [1 / 3, 2 / 3]).astype(np.uint32)
    j = jsort.split_sorted_edges(jnp.asarray(keys), jnp.asarray(edges),
                                 capacity, fill=SENTINEL)
    t = tsort.split_sorted_edges(torch.from_numpy(keys), torch.from_numpy(edges),
                                 capacity, fill=SENTINEL)
    for a, b in zip(j, t):
        _eq(a, b)


@pytest.mark.parametrize("dtype", [np.uint32, np.int32])
def test_merge_received(dtype):
    rng = np.random.default_rng(9)
    slab = (_keys(9, 4 * 700).reshape(4, 700) if dtype == np.uint32
            else rng.integers(-(1 << 31), 1 << 31, (4, 700), dtype=np.int32))
    counts = np.array([700, 0, 313, 1], np.int32)
    sentinel = SENTINEL if dtype == np.uint32 else (1 << 31) - 1
    j = jsort.merge_received(jnp.asarray(slab), jnp.asarray(counts), sentinel)
    t = tsort.merge_received(torch.from_numpy(slab), torch.from_numpy(counts),
                             sentinel)
    _eq(j[0], t[0])
    assert int(j[1]) == int(t[1]) == 1014
    assert t[1].dtype == torch.int32
