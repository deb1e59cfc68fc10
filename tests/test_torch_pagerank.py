"""The port's PageRank against the JAX package's on 8-shard meshes, fed
the same numpy edges: ``prepare`` byte for byte (packed blocks, degrees,
n_local), the ranks within the JAX tests' rtol 1e-4 / atol 1e-6 on a
random graph, a graph with dangling nodes, a vertex count that E does
not divide, no edges at all, the (dcn 2, exec 4) mesh and a Graph500
Kronecker graph at SCALE 11 (the benchmark generator's rule: hubs,
duplicates, self-loops, dangling vertices). Each JAX result is computed
once for the module. Besides: the bucketing's radix pack against the
plain pack (and through the CUDA branch on a fake library), meshes the
radix pack's kernel cannot take, and the capacity a caller asks for."""

import contextlib
import ctypes
import types

import jax
import numpy as np
import pytest
import torch

from sparkrdma_tpu.models.pagerank import PageRank as JaxPageRank
from sparkrdma_tpu.models.pagerank import reference_pagerank as jax_reference
from sparkrdma_tpu.parallel import mesh as jmesh
from shufflebench import generator
from shufflebench.generators import graph as kronecker
from sparkrdma_tpu_torch.models import pagerank as tpagerank
from sparkrdma_tpu_torch.models.pagerank import PageRank, reference_pagerank
from sparkrdma_tpu_torch.ops import sort as tsort
from sparkrdma_tpu_torch.parallel import make_mesh

torch.set_num_threads(1)


def _random_graph(n, m, seed):
    return np.random.default_rng(seed).integers(0, n, size=(m, 2), dtype=np.int64)


def _kronecker(scale, seed):
    """The benchmark's Graph500 Kronecker edges at ``scale``, as numpy."""
    config = {"scale": scale, "edgefactor": 16, "initiator": [0.57, 0.19, 0.19, 0.05]}
    cpu = torch.device("cpu")
    edges = kronecker.make({}, config, generator.seeded(seed, cpu), cpu)["edges"]
    return edges.numpy().astype(np.int64)


CASES = {
    # name: (edges, num_vertices, iters, num_slices)
    "kronecker": (lambda: _kronecker(11, 2**31 + 9), 1 << 11, 10, None),
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


def test_kronecker_graph_has_what_the_cell_stresses():
    edges = _kronecker(11, 2**31 + 9)
    n = 1 << 11
    indeg = np.bincount(edges[:, 1], minlength=n)
    outdeg = np.bincount(edges[:, 0], minlength=n)
    assert edges.shape == (16 * n, 2)
    assert indeg.max() > 50 * indeg.mean()  # a hub
    assert (outdeg == 0).mean() > 0.2  # dangling vertices carry mass
    assert (edges[:, 0] == edges[:, 1]).any()  # self-loops
    assert len(np.unique(edges[:, 0] * n + edges[:, 1])) < len(edges)  # duplicates


@pytest.mark.parametrize("shards", [1, 3, 8])
def test_radix_pack_matches_the_plain_pack(shards):
    """``_pack_radix`` (P = E^2 rounded up to a power of two: 1, 16, 64)
    byte for byte against ``_pack_plain`` on a Kronecker graph."""
    edges = torch.from_numpy(_kronecker(10, 7)).to(torch.int32)
    n_local = -(-(1 << 10) // shards)
    src, dst = edges[:, 0], edges[:, 1]
    lg, b = (shards * shards - 1).bit_length(), max(1, (n_local - 1).bit_length())
    got = tpagerank._pack_radix(src, dst, shards, n_local, lg, b)
    want = tpagerank._pack_plain(src, dst, shards, n_local)
    assert got.dtype == want.dtype == torch.int32
    assert torch.equal(got, want)


@pytest.mark.parametrize("kernel", [False, True])
def test_meshes_beyond_the_kernel_take_the_plain_pack(kernel, monkeypatch):
    """32 shards (1,024 partitions): the CPU's radix pack takes any power
    of two; on CUDA, beyond the kernel's 256, the plain pack. The same
    ranks as the reference either way."""
    calls = []
    real = tpagerank._pack_plain
    monkeypatch.setattr(tpagerank, "_pack_plain",
                        lambda *a: calls.append(1) or real(*a))
    monkeypatch.setattr(tsort, "_pack_kernel_path", lambda keys: kernel)
    edges = _kronecker(9, 3)
    out = PageRank(make_mesh(["cpu"] * 32)).run(edges, 1 << 9, iters=8)
    assert calls == ([1] if kernel else [])
    np.testing.assert_allclose(out, reference_pagerank(edges, 1 << 9, iters=8),
                               rtol=1e-4, atol=1e-6)


class _FakePackLib:
    """``srt_radix_pack`` computing the plain version through the
    pointers it is given (the argument order checked end to end)."""

    def __init__(self):
        self.calls = []

    def srt_radix_pack_scratch(self, e, n, p):
        return e * p * 3

    def srt_radix_pack(self, *args):
        self.calls.append(args)
        (kp, vp, ksp, vsp, cp, fp, _scratch, e, n, p, key_bits, cap, key_fill,
         val_fill, _stream) = args

        def at(ptr, shape, dtype):
            count = int(np.prod(shape))
            if count == 0:
                return torch.empty(shape, dtype=dtype)
            raw = (ctypes.c_uint8 * (count * torch.empty((), dtype=dtype).element_size())
                   ).from_address(ptr)
            return torch.frombuffer(raw, dtype=dtype, count=count).view(shape)

        want = tsort.radix_pack_pairs_reference(
            at(kp, (e, n), torch.int32).view(torch.uint32), at(vp, (e, n), torch.int32),
            p, cap, key_bits, key_fill & 0xFFFFFFFF, val_fill)
        for ptr, w in zip((ksp, vsp, cp, fp), want):
            at(ptr, w.shape, w.dtype).copy_(w)
        return 0


def test_blocks_through_the_kernel_branch(monkeypatch):
    """On CUDA the bucketing is one ``srt_radix_pack`` call over the
    ``[1, m]`` stack: P 64 and 29-bit keys for 8 shards of 2^23 vertices'
    share (here 2^10 vertices: 7 bits of local index, 13 bits of key),
    fills -1 and 0xFFFFFFFF, and ``prepare`` byte for byte as before."""
    from sparkrdma_tpu_torch.ops import _build

    lib = _FakePackLib()
    monkeypatch.setattr(tsort, "_pack_kernel_path", lambda keys: True)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: types.SimpleNamespace(cuda_stream=77))
    monkeypatch.setattr(_build, "load_radix_pack", lambda: lib)
    edges = _kronecker(10, 11)
    pr = PageRank(make_mesh(["cpu"] * 8))
    got = pr.prepare(edges, 1 << 10)
    (args,) = lib.calls
    e, n, p, key_bits, cap, key_fill, val_fill, stream = args[7:]
    assert (e, n, p, key_bits, key_fill, val_fill, stream) == (
        1, len(edges), 64, 6 + 7, -1, -1, 77)
    assert cap == got[0].shape[2]
    monkeypatch.setattr(tsort, "_pack_kernel_path", lambda keys: False)
    want = pr.prepare(edges, 1 << 10)
    for g, w in zip(got[:2], want[:2]):
        assert g.tobytes() == w.tobytes()


@pytest.mark.parametrize("pack", ["radix", "plain"])
def test_blocks_pad_to_the_capacity_asked_for(pack, monkeypatch):
    """``capacity`` above the largest block pads every block to it
    (each block's edges, then -1); below it, the largest block rules.
    The ranks are the same at any capacity, rows of a multiple of
    ``SLOT_ALIGN`` slots or not."""
    if pack == "plain":
        monkeypatch.setattr(tpagerank, "_pack_radix", lambda src, dst, e, n_local, lg, b,
                            capacity: tpagerank._pack_plain(src, dst, e, n_local, capacity))
    edges = torch.from_numpy(_kronecker(10, 5))
    n = 1 << 10
    pr = PageRank(make_mesh(["cpu"] * 8))
    exact, deg, n_local = pr.blocks(edges, n)
    cap = exact.shape[2]
    assert pr.blocks(edges, n, capacity=cap - 5)[0].shape[2] == cap
    wide = cap + tpagerank.SLOT_ALIGN + 3
    padded, deg2, _ = pr.blocks(edges, n, capacity=wide)
    assert padded.shape == (8, 8, wide, 2) and torch.equal(deg, deg2)
    assert torch.equal(padded[:, :, :cap], exact)
    assert bool((padded[:, :, cap:] == -1).all())
    rank0, valid = pr.initial(n_local, n)
    a = pr.step(n_local, cap, 10, n)(rank0, deg, valid, exact)
    b = pr.step(n_local, wide, 10, n)(rank0, deg, valid, padded)
    assert torch.equal(a, b)
