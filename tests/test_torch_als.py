"""The port's ALS against the JAX package's on 8-shard meshes, fed the
same numpy ratings: ``prepare`` byte for byte (padded per-user and
per-item lists in insertion order), the start factors exactly, ``u``
and ``v`` after one iteration within the JAX tests' rtol 2e-3 / atol
2e-4, the RMSE after 8 within 5e-3 of JAX's, cold rows exactly 0, on
the exec and the (dcn 2, exec 4) mesh. Each JAX result is computed once
for the module."""

import jax
import numpy as np
import pytest
import torch

from sparkrdma_tpu.models.als import ALS as JaxALS
from sparkrdma_tpu.models.als import reference_als as jax_reference
from sparkrdma_tpu.models.als import rmse as jax_rmse
from sparkrdma_tpu.parallel import mesh as jmesh
from sparkrdma_tpu_torch.models.als import ALS, reference_als, rmse
from sparkrdma_tpu_torch.parallel import make_mesh

torch.set_num_threads(1)


def _ratings(n_users, n_items, m, seed=0):
    """Low-rank ground truth + noise, so ALS has signal to recover."""
    rng = np.random.default_rng(seed)
    true_u = rng.normal(size=(n_users, 4))
    true_v = rng.normal(size=(n_items, 4))
    users = rng.integers(0, n_users, m)
    items = rng.integers(0, n_items, m)
    vals = (true_u[users] * true_v[items]).sum(1) + 0.01 * rng.normal(size=m)
    return np.stack([users, items, vals], axis=1).astype(np.float64)


CASES = {
    # name: (ratings, n_users, n_items, rank, reg, iters, num_slices)
    "one_iteration": (lambda: _ratings(48, 40, 600), 48, 40, 4, 0.1, 1, None),
    "converges": (lambda: _ratings(64, 56, 1500, seed=2), 64, 56, 6, 0.05, 8, None),
    "cold_rows": (lambda: np.array([[0, 0, 1.0], [1, 1, 2.0]]), 10, 10, 3, 0.1, 3, None),
    "mesh_2d": (lambda: _ratings(50, 37, 500, seed=3), 50, 37, 4, 0.1, 1, 2),
}


def _meshes(slices):
    return (jmesh.make_mesh(jax.devices()[:8], num_slices=slices),
            make_mesh(["cpu"] * 8, num_slices=slices))


@pytest.fixture(scope="module")
def jax_results():
    out = {}
    for name, (ratings, nu, ni, rank, reg, iters, slices) in CASES.items():
        als = JaxALS(_meshes(slices)[0], rank=rank, reg=reg)
        out[name] = (als.prepare(ratings(), nu, ni),
                     als.fit(ratings(), nu, ni, iters=iters, seed=0))
    return out


def _port(name):
    _, _, _, rank, reg, _, slices = CASES[name]
    return ALS(_meshes(slices)[1], rank=rank, reg=reg)


@pytest.mark.parametrize("name", sorted(CASES))
def test_prepare_byte_identical_to_jax(name, jax_results):
    ratings, nu, ni = CASES[name][:3]
    got = _port(name).prepare(ratings(), nu, ni)
    want = jax_results[name][0]
    assert got[4:] == want[4:]  # nu, ni
    for g, w in zip(got[:4], want[:4]):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()


@pytest.mark.parametrize("name", sorted(CASES))
def test_start_factors_are_jax_draws(name):
    # no iteration: fit returns the start factors, drawn as JAX draws them
    ratings, nu, ni, rank, reg, _, slices = CASES[name]
    want = JaxALS(_meshes(slices)[0], rank=rank, reg=reg).fit(
        ratings(), nu, ni, iters=0, seed=3)
    got = _port(name).fit(ratings(), nu, ni, iters=0, seed=3)
    for g, w in zip(got, want):
        assert g.tobytes() == w.tobytes()


@pytest.mark.parametrize("name", sorted(CASES))
def test_factors_match_jax(name, jax_results):
    ratings, nu, ni, _, _, iters, _ = CASES[name]
    u, v = _port(name).fit(ratings(), nu, ni, iters=iters, seed=0)
    ju, jv = jax_results[name][1]
    assert u.dtype == np.float32 and u.shape == ju.shape and v.shape == jv.shape
    if iters == 1:
        np.testing.assert_allclose(u, ju, rtol=2e-3, atol=2e-4)
        np.testing.assert_allclose(v, jv, rtol=2e-3, atol=2e-4)
    got, want = rmse(u, v, ratings()), jax_rmse(ju, jv, ratings())
    assert abs(got - want) < 5e-3
    if name == "converges":
        assert got < 0.5  # recovered the rank-4 signal
    if name == "cold_rows":
        assert np.isfinite(u).all() and np.isfinite(v).all()
        assert not u[2:].any() and not v[2:].any()  # no ratings: exactly 0


def test_one_iteration_matches_float64_reference():
    ratings, nu, ni, rank, reg, _, _ = CASES["one_iteration"]
    als = _port("one_iteration")
    u, v = als.fit(ratings(), nu, ni, iters=1, seed=0)
    u0, v0 = als.initial(6, 5, seed=0)
    ru, rv = reference_als(ratings(), nu, ni, rank=rank, reg=reg, iters=1,
                           u0=u0[:nu], v0=v0[:ni])
    np.testing.assert_allclose(u, ru, rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(v, rv, rtol=2e-3, atol=2e-4)


def test_references_are_the_jax_references():
    r = _ratings(12, 9, 80, seed=5)
    u, v = reference_als(r, 12, 9, rank=3, iters=2)
    ju, jv = jax_reference(r, 12, 9, rank=3, iters=2)
    assert u.tobytes() == ju.tobytes() and v.tobytes() == jv.tobytes()
    assert rmse(u, v, r) == jax_rmse(u, v, r)
