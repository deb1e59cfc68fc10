"""The port's HashJoin against the JAX package's on 8-shard meshes, fed
the same numpy tables: the [m, 3] int64 output byte for byte (its row
order included) for matches and misses, all misses, duplicate build
keys, skew that climbs the capacity ladder, a length that E does not
divide, a probe key equal to SENTINEL (dropped by both) and the (dcn 2,
exec 4) mesh; then the error cases. Each JAX output is computed once
for the module."""

import jax
import numpy as np
import pytest
import torch

from sparkrdma_tpu.models.hashjoin import HashJoin as JaxHashJoin
from sparkrdma_tpu.parallel import mesh as jmesh
from sparkrdma_tpu_torch.models.hashjoin import HashJoin
from sparkrdma_tpu_torch.parallel import make_mesh

torch.set_num_threads(1)

SENTINEL = 0xFFFFFFFF


def _tables(n_build, n_probe, seed, key_space=1 << 20):
    """Unique build keys under ``key_space``; ~70% of probes hit."""
    rng = np.random.default_rng(seed)
    build_keys = rng.choice(key_space, size=n_build, replace=False).astype(np.uint32)
    build_vals = rng.integers(0, 1 << 20, n_build).astype(np.int32)
    hit = rng.random(n_probe) < 0.7
    probe_keys = np.where(
        hit, rng.choice(build_keys, size=n_probe),
        rng.integers(0, key_space, n_probe),
    ).astype(np.uint32)
    return build_keys, build_vals, probe_keys, np.arange(n_probe, dtype=np.int32)


def _spread(seed):
    # keys mixed over the whole 32-bit space reach every shard
    bk, bv, pk, pv = _tables(400, 3000, seed)
    mix = lambda k: ((k.astype(np.uint64) * 0x9E3779B1) % (1 << 32)).astype(np.uint32)  # noqa: E731
    return mix(bk), bv, mix(pk), pv


def _with_sentinel_probe():
    bk, bv, pk, pv = _spread(4)
    pk = pk.copy()
    pk[[5, 77, 2999]] = SENTINEL
    return bk, bv, pk, pv


def _duplicates():
    # build keys repeated: which value joins depends on the stable order
    bk, bv, pk, pv = _spread(5)
    bk = np.concatenate([bk, bk[:50]])
    bv = np.concatenate([bv, bv[:50] + 7])
    return bk, bv, pk, pv


CASES = {
    # name: (tables, capacity_factor, num_slices)
    "matches_and_misses": (lambda: _tables(300, 2000, 0), 2.0, None),
    "spread_over_every_shard": (lambda: _spread(1), 2.0, None),
    "all_misses": (lambda: (np.array([1, 2, 3], np.uint32),
                            np.array([10, 20, 30], np.int32),
                            np.array([100, 200], np.uint32),
                            np.array([0, 1], np.int32)), 2.0, None),
    "skew_climbs_the_ladder": (lambda: (np.arange(100, dtype=np.uint32),
                                        np.arange(100, dtype=np.int32),
                                        np.zeros(500, np.uint32),
                                        np.arange(500, dtype=np.int32)), 1.1, None),
    "length_not_divisible_by_e": (lambda: _tables(301, 1999, 2), 2.0, None),
    "sentinel_probe_dropped": (_with_sentinel_probe, 2.0, None),
    "duplicate_build_keys": (_duplicates, 2.0, None),
    "mesh_2d": (lambda: _spread(3), 2.0, 2),
}


def _jax_join(name):
    tables, factor, slices = CASES[name]
    mesh = jmesh.make_mesh(jax.devices()[:8], num_slices=slices)
    return JaxHashJoin(mesh, capacity_factor=factor).join(*tables())


@pytest.fixture(scope="module")
def jax_outputs():
    return {name: _jax_join(name) for name in CASES}


@pytest.mark.parametrize("name", sorted(CASES))
def test_join_byte_identical_to_jax(name, jax_outputs):
    tables, factor, slices = CASES[name]
    hj = HashJoin(make_mesh(["cpu"] * 8, num_slices=slices), capacity_factor=factor)
    got, want = hj.join(*tables()), jax_outputs[name]
    assert got.dtype == want.dtype == np.int64
    assert got.shape == want.shape
    assert got.tobytes() == want.tobytes()
    if name == "skew_climbs_the_ladder":
        assert len(hj.last_capacities) > 1
        assert (got[:, 2] == 0).all()
    if name == "sentinel_probe_dropped":
        assert len(got) == 3000 - 3 and SENTINEL not in got[:, 0]
    if name == "all_misses":
        assert (got[:, 2] == -1).all()


def test_join_matches_dict_reference():
    bk, bv, pk, pv = _spread(6)
    out = HashJoin(make_mesh(["cpu"] * 8)).join(bk, bv, pk, pv)
    lookup = dict(zip(bk.tolist(), bv.tolist()))
    assert len(out) == len(pk)
    assert out[:, 2].tolist() == [lookup.get(k, -1) for k in out[:, 0].tolist()]
    assert sorted(out[:, 1].tolist()) == list(range(len(pk)))
    assert (pk[out[:, 1]] == out[:, 0]).all()


def test_non_power_of_two_shards_raise_as_in_jax():
    with pytest.raises(ValueError, match="power-of-two"):
        JaxHashJoin(jmesh.make_mesh(jax.devices()[:6]))
    with pytest.raises(ValueError, match="power-of-two"):
        HashJoin(make_mesh(["cpu"] * 6))


def test_ladder_gives_up_after_eight_doublings():
    # every probe key 0 lands on shard 0: 1025 rows a sender outgrow
    # the last class (8 << 7 = 1024)
    hj = HashJoin(make_mesh(["cpu"] * 8), capacity_factor=0.001)
    pk = np.zeros(8 * 1025, np.uint32)
    with pytest.raises(RuntimeError, match="after 8 capacity doublings"):
        hj.join(np.arange(4, dtype=np.uint32), np.arange(4, dtype=np.int32),
                pk, np.arange(len(pk), dtype=np.int32))
    assert [c[1] for c in hj.last_capacities] == [8 << i for i in range(8)]


def test_one_shard_on_the_cpu_when_asked():
    hj = HashJoin(device="cpu")
    assert hj.num_shards == 1 and hj.device.type == "cpu"
    bk, bv, pk, pv = _tables(50, 200, 7)
    out = hj.join(bk, bv, pk, pv)
    lookup = dict(zip(bk.tolist(), bv.tolist()))
    assert out[:, 2].tolist() == [lookup.get(k, -1) for k in out[:, 0].tolist()]
