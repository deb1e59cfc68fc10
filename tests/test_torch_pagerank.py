"""The port's PageRank against the JAX package's on 8-shard meshes, fed
the same numpy edges: ``prepare`` byte for byte (packed blocks, degrees,
n_local), the ranks within the JAX tests' rtol 1e-4 / atol 1e-6 on a
random graph, a graph with dangling nodes, a vertex count that E does
not divide, no edges at all and the (dcn 2, exec 4) mesh. Each JAX
result is computed once for the module."""

import jax
import numpy as np
import pytest
import torch

from sparkrdma_tpu.models.pagerank import PageRank as JaxPageRank
from sparkrdma_tpu.models.pagerank import reference_pagerank as jax_reference
from sparkrdma_tpu.parallel import mesh as jmesh
from sparkrdma_tpu_torch.models.pagerank import PageRank, reference_pagerank
from sparkrdma_tpu_torch.parallel import make_mesh

torch.set_num_threads(1)


def _random_graph(n, m, seed):
    return np.random.default_rng(seed).integers(0, n, size=(m, 2), dtype=np.int64)


CASES = {
    # name: (edges, num_vertices, iters, num_slices)
    "random": (lambda: _random_graph(200, 1500, 0), 200, 15, None),
    "dangling_path": (lambda: np.array([[0, 1], [1, 2]]), 3, 30, None),
    "vertices_not_divisible_by_e": (lambda: _random_graph(203, 1200, 1), 203, 12, None),
    "no_edges": (lambda: np.zeros((0, 2), np.int64), 20, 5, None),
    "mesh_2d": (lambda: _random_graph(128, 800, 3), 128, 10, 2),
}


def _meshes(slices):
    return (jmesh.make_mesh(jax.devices()[:8], num_slices=slices),
            make_mesh(["cpu"] * 8, num_slices=slices))


@pytest.fixture(scope="module")
def jax_results():
    out = {}
    for name, (edges, n, iters, slices) in CASES.items():
        pr = JaxPageRank(_meshes(slices)[0])
        out[name] = (pr.prepare(edges(), n), pr.run(edges(), n, iters=iters))
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_prepare_byte_identical_to_jax(name, jax_results):
    edges, n, _, slices = CASES[name]
    got = PageRank(_meshes(slices)[1]).prepare(edges(), n)
    want = jax_results[name][0]
    assert got[2] == want[2]  # n_local
    for g, w in zip(got[:2], want[:2]):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()


@pytest.mark.parametrize("name", sorted(CASES))
def test_ranks_match_jax(name, jax_results):
    edges, n, iters, slices = CASES[name]
    pr = PageRank(_meshes(slices)[1])
    out = pr.run(edges(), n, iters=iters)
    assert out.dtype == np.float32 and out.shape == (n,)
    np.testing.assert_allclose(out, jax_results[name][1], rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(out, reference_pagerank(edges(), n, iters=iters),
                               rtol=1e-4, atol=1e-6)
    assert abs(out.sum() - 1.0) < 1e-3
    if name == "dangling_path":
        assert out[2] > out[1] > out[0]  # rank accumulates down the path


def test_reference_is_the_jax_reference():
    edges = _random_graph(60, 300, 4)
    assert (reference_pagerank(edges, 60, iters=7).tobytes()
            == jax_reference(edges, 60, iters=7).tobytes())


def test_step_is_cached_and_checks_its_shapes():
    pr = PageRank(make_mesh(["cpu"] * 4))
    packed, deg, n_local = pr.blocks(torch.from_numpy(_random_graph(40, 100, 5)), 40)
    fn = pr.step(n_local, packed.shape[2], 3, 40)
    assert pr.step(n_local, packed.shape[2], 3, 40) is fn
    rank0, valid = pr.initial(n_local, 40)
    with pytest.raises(ValueError, match="step built for"):
        fn(rank0[:-1], deg, valid, packed)
    assert torch.isfinite(fn(rank0, deg, valid, packed)).all()
