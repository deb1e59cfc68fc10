"""The port's PageRank against the JAX package's on 8-shard meshes, fed
the same numpy edges: ``prepare`` byte for byte (packed blocks, degrees,
n_local), the ranks within the JAX tests' rtol 1e-4 / atol 1e-6 on a
random graph, a graph with dangling nodes, a vertex count that E does
not divide, no edges at all, the (dcn 2, exec 4) mesh and a Graph500
Kronecker graph at SCALE 11 (the benchmark generator's rule: hubs,
duplicates, self-loops, dangling vertices). Each JAX result is computed
once for the module. Besides: the bucketing's radix pack against the
plain pack (and through the CUDA branch on a fake library), meshes the
radix pack's kernel cannot take, the capacity a caller asks for, and the
step's CSR build and pull: bit for bit against the push they replaced,
and through the CUDA branch on a fake library that emulates the
kernels' split."""

import contextlib
import ctypes

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
from sparkrdma_tpu_torch.ops import _build, csr
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


def _at(ptr, shape, dtype):
    """A CPU tensor over the memory at ``ptr``, as a fake library sees it."""
    count = int(np.prod(shape))
    if count == 0:
        return torch.empty(shape, dtype=dtype)
    raw = (ctypes.c_uint8 * (count * torch.empty((), dtype=dtype).element_size())
           ).from_address(ptr)
    return torch.frombuffer(raw, dtype=dtype, count=count).view(shape)


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
        want = tsort.radix_pack_pairs_reference(
            _at(kp, (e, n), torch.int32).view(torch.uint32), _at(vp, (e, n), torch.int32),
            p, cap, key_bits, key_fill & 0xFFFFFFFF, val_fill)
        for ptr, w in zip((ksp, vsp, cp, fp), want):
            _at(ptr, w.shape, w.dtype).copy_(w)
        return 0


def test_blocks_through_the_kernel_branch(monkeypatch):
    """On CUDA the bucketing is one ``srt_radix_pack`` call over the
    ``[1, m]`` stack: P 64 and 29-bit keys for 8 shards of 2^23 vertices'
    share (here 2^10 vertices: 7 bits of local index, 13 bits of key),
    fills -1 and 0xFFFFFFFF, and ``prepare`` byte for byte as before."""
    lib = _FakePackLib()
    monkeypatch.setattr(tsort, "_pack_kernel_path", lambda keys: True)
    monkeypatch.setattr(_build, "_on_device",
                        lambda symbol, device: contextlib.nullcontext((lib, 77)))
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
    The ranks are the same at any capacity: the step's CSR drops the
    padding."""
    if pack == "plain":
        monkeypatch.setattr(tpagerank, "_pack_radix", lambda src, dst, e, n_local, lg, b,
                            capacity: tpagerank._pack_plain(src, dst, e, n_local, capacity))
    edges = torch.from_numpy(_kronecker(10, 5))
    n = 1 << 10
    pr = PageRank(make_mesh(["cpu"] * 8))
    exact, deg, n_local = pr.blocks(edges, n)
    cap = exact.shape[2]
    assert pr.blocks(edges, n, capacity=cap - 5)[0].shape[2] == cap
    wide = cap + 1027
    padded, deg2, _ = pr.blocks(edges, n, capacity=wide)
    assert padded.shape == (8, 8, wide, 2) and torch.equal(deg, deg2)
    assert torch.equal(padded[:, :, :cap], exact)
    assert bool((padded[:, :, cap:] == -1).all())
    rank0, valid = pr.initial(n_local, n)
    a = pr.step(n_local, cap, 10, n)(rank0, deg, valid, exact)
    b = pr.step(n_local, wide, 10, n)(rank0, deg, valid, padded)
    assert torch.equal(a, b)


# ---- the step's CSR build and pull (ops/csr.py)

def _push(packed, n_local, outc):
    """The step's scatter before its CSR, kept as the oracle: every slot
    of the padded blocks gathers its source's out-contribution by
    ``index_select`` (padding an appended zero) and adds it into its
    destination's row of the contribution stack by ``index_add_``."""
    e = packed.shape[0]
    shard = torch.arange(e)
    s_loc, d_loc = packed[..., 0].long(), packed[..., 1].long()
    src_at = torch.where(s_loc >= 0, s_loc + (shard * n_local)[:, None, None], e * n_local)
    dst_at = (torch.where(d_loc >= 0, d_loc, 0)
              + ((shard[:, None] * e + shard[None, :]) * n_local)[:, :, None])
    vals = torch.index_select(torch.cat([outc, torch.zeros(1)]), 0, src_at.reshape(-1))
    return torch.zeros(e * e * n_local).index_add_(0, dst_at.reshape(-1), vals)


def _hub_graph(n, m, hub, hub_edges, seed):
    """``m`` random edges and ``hub_edges`` more into vertex ``hub``."""
    rng = np.random.default_rng(seed)
    into = np.stack([rng.integers(0, n, hub_edges), np.full(hub_edges, hub)], 1)
    return np.concatenate([_random_graph(n, m, seed), into])


CSR_CASES = {
    # name: (edges, num_vertices, shards, slots of padding past the largest block)
    "padding_ignored": (lambda: _random_graph(96, 700, 20), 96, 4, 333),
    "empty_rows": (lambda: np.stack([np.arange(300) % 300, np.arange(300) % 7 * 40], 1),
                   300, 4, 0),
    # one row of ~4,500 edges in a block: past a kernel tile's 3,072 steps
    "hub_row_past_a_tile": (lambda: _hub_graph(200, 900, 5, 9000, 21), 200, 2, 0),
    "vertices_not_divisible_by_e": (lambda: _random_graph(203, 1200, 1), 203, 8, 0),
    "one_shard": (lambda: _kronecker(9, 22), 1 << 9, 1, 5),
    "eight_shards": (lambda: _kronecker(10, 23), 1 << 10, 8, 0),
}


@pytest.mark.parametrize("name", sorted(CSR_CASES))
def test_csr_pull_matches_the_push(name):
    """The plain CSR build and pull against the push they replace, bit for
    bit: both add each row's edges in block slot order from 0 (padding
    adds an exact 0), so every float32 sum is the same. The CSR holds
    the edges and no padding slot; empty rows read 0."""
    edges, n, shards, extra = CSR_CASES[name]
    pr = PageRank(make_mesh(["cpu"] * shards))
    exact, _, n_local = pr.blocks(torch.from_numpy(edges()), n)
    packed, _, _ = pr.blocks(torch.from_numpy(edges()), n,
                             capacity=exact.shape[2] + extra)
    graph = csr.csr_build(packed, n_local)
    m = len(edges())
    assert graph.offsets.shape == (shards * shards * n_local + 1,)
    assert int(graph.offsets[-1]) == m and graph.src.shape == (m,)
    assert bool((graph.offsets[1:] >= graph.offsets[:-1]).all())
    outc = torch.from_numpy(np.random.default_rng(len(name)).random(
        shards * n_local, dtype=np.float32))
    got = csr.csr_pull(outc, graph)
    want = _push(packed, n_local, outc)
    assert got.dtype == torch.float32 and torch.equal(got, want)
    empty = graph.offsets[1:] == graph.offsets[:-1]
    assert bool(empty.any()) and bool((got[empty] == 0).all())


class _FakeCsrLib:
    """``srt_csr_*`` emulated on the CPU through the pointers they are
    given, with the kernels' own split: merge-path tiles of THREADS *
    ITEMS steps, a float32 sum a thread, the threads' segmented scan
    within a tile, a carry a tile added after; placement by decrementing
    cursors, so that rows hold their edges in reverse slot order, not the
    plain version's order. Rows the pull leaves unwritten read NaN."""

    THREADS, ITEMS = 4, 3

    def __init__(self):
        self.calls = []

    def srt_csr_tile_steps(self):
        return self.THREADS * self.ITEMS

    def srt_csr_scratch_bytes(self, e, cap, n_local, wide):
        return 16

    def srt_csr_build(self, packed, ends, src, coords, scratch, e, cap, n_local, tiles,
                      wide, stream):
        self.calls.append(("build", wide, stream))
        idx = torch.int64 if wide else torch.int32
        rows = e * e * n_local
        p = _at(packed, (e * e, cap, 2), torch.int32).numpy()
        a = _at(ends, (rows + 2,), idx).numpy()
        s = _at(src, (e * e * cap,), torch.int32).numpy()
        c = _at(coords, (tiles + 1, 2), idx).numpy()
        a[:] = 0
        b, j = np.nonzero(p[..., 0] >= 0)
        np.add.at(a, 1 + b * n_local + p[b, j, 1], 1)
        a[1:rows + 1] = np.cumsum(a[1:rows + 1])
        a[rows + 1] = a[rows]
        for b, j in zip(b, j):
            r = 1 + b * n_local + p[b, j, 1]
            a[r] -= 1
            s[a[r]] = b // e * n_local + p[b, j, 0]
        offsets, steps = a[1:], self.srt_csr_tile_steps()
        edges = int(offsets[rows])
        for t in range(tiles + 1):
            diag = min(t * steps, rows + edges)
            lo, hi = max(diag - edges, 0), min(diag, rows)
            while lo < hi:
                mid = (lo + hi) // 2
                if offsets[mid + 1] <= diag - mid - 1:
                    lo = mid + 1
                else:
                    hi = mid
            c[t] = lo, diag - lo
        self.sources = e * n_local
        return 0

    def srt_csr_pull(self, outc, offsets, src, coords, carry, y, rows, tiles, wide,
                     stream):
        self.calls.append(("pull", wide, stream))
        f32, idx = np.float32, torch.int64 if wide else torch.int32
        o = _at(offsets, (rows + 1,), idx).numpy()
        c = _at(coords, (tiles + 1, 2), idx).numpy()
        s = _at(src, (int(o[rows]),), torch.int32).numpy()
        x = _at(outc, (self.sources,), torch.float32).numpy()
        out, cv = _at(y, (rows,), torch.float32).numpy(), _at(
            carry, (tiles,), torch.float32).numpy()
        out[:] = np.nan
        for t in range(tiles):
            (r0, n0), (r1, n1) = (int(v) for v in c[t]), (int(v) for v in c[t + 1])
            nrows, nnz = r1 - r0, n1 - n0
            steps = nrows + nnz
            if steps == 0:
                continue
            vals = x[s[n0:n1]]
            ends = [min(int(o[r0 + i + 1]) - n0, nnz) if r0 + i < rows else nnz
                    for i in range(nrows + 1)]
            scan = f32(0)
            for tid in range(self.THREADS):
                diag = min(tid * self.ITEMS, steps)
                stop = min(diag + self.ITEMS, steps)
                lo, hi = max(diag - nnz, 0), min(diag, nrows)
                while lo < hi:
                    mid = (lo + hi) // 2
                    if ends[mid] <= diag - mid - 1:
                        lo = mid + 1
                    else:
                        hi = mid
                row, nz, acc, first = lo, diag - lo, f32(0), None
                for _ in range(diag, stop):
                    if nz < ends[row]:
                        acc = f32(acc + vals[nz])
                        nz += 1
                    else:
                        if first is None:
                            first = (row, acc)
                        else:
                            out[r0 + row] = acc
                        acc = f32(0)
                        row += 1
                if first is not None:
                    out[r0 + first[0]] = f32(first[1] + scan)
                scan = acc if first is not None else f32(scan + acc)
            if r1 < rows:
                cv[t] = scan
        for t in range(tiles):
            r = int(c[t + 1][0])
            if r < rows and cv[t] != 0:
                out[r] = f32(out[r] + cv[t])
        return 0


@pytest.fixture
def fake_csr(monkeypatch):
    lib = _FakeCsrLib()
    monkeypatch.setattr(csr, "_kernel_path", lambda t: True)
    monkeypatch.setattr(_build, "_on_device",
                        lambda symbol, device: contextlib.nullcontext((lib, 77)))
    _build.reset_launch_counts()
    return lib


@pytest.mark.parametrize("wide", [False, True])
def test_csr_kernel_branch_split_and_launches(wide, fake_csr, monkeypatch):
    """The CUDA branch on the kernels' emulated split (tiles of 12 steps:
    the hub's row crosses hundreds of them; int32 and int64 indices).
    Integer-valued out-contributions sum exactly in any order, so the
    pull equals the plain version's bit for bit; a 10-iteration job makes
    one build and 10 pulls, and its ranks match the plain
    path's."""
    if wide:
        monkeypatch.setattr(csr, "index_dtype", lambda rows, slots: torch.int64)
    edges, n = _hub_graph(160, 1500, 7, 3000, 24), 160
    pr = PageRank(make_mesh(["cpu"] * 4))
    packed, deg, n_local = pr.blocks(torch.from_numpy(edges), n, capacity=900)
    graph = csr.csr_build(packed, n_local)
    assert graph.offsets.dtype == (torch.int64 if wide else torch.int32)
    plain = csr.csr_build_reference(packed, n_local)
    assert torch.equal(graph.offsets, plain.offsets)
    outc = torch.from_numpy(np.random.default_rng(3).integers(
        0, 4, 4 * n_local).astype(np.float32))
    assert torch.equal(csr.csr_pull(outc, graph),
                       csr.csr_pull_reference(outc, plain.offsets, plain.src))
    assert [k for k, _, _ in fake_csr.calls] == ["build", "pull"]
    assert all(w == int(wide) and s == 77 for _, w, s in fake_csr.calls)

    _build.reset_launch_counts()
    rank0, valid = pr.initial(n_local, n)
    got = pr.step(n_local, packed.shape[2], 10, n)(rank0, deg, valid, packed)
    assert (_build.launches["srt_csr_build"], _build.launches["srt_csr_pull"]) == (1, 10)
    monkeypatch.setattr(csr, "_kernel_path", lambda t: False)
    want = pr.step(n_local, packed.shape[2], 10, n)(rank0, deg, valid, packed)
    # the hub's ~3,400-term float32 sum in two orders, over ten iterations
    torch.testing.assert_close(got, want, rtol=1e-5, atol=0)
    np.testing.assert_allclose(got[:n].numpy(), reference_pagerank(edges, n, iters=10),
                               rtol=1e-4, atol=1e-6)


def test_csr_checks_its_arguments():
    pr = PageRank(make_mesh(["cpu"] * 2))
    packed, _, n_local = pr.blocks(torch.from_numpy(_random_graph(20, 50, 6)), 20)
    graph = csr.csr_build(packed, n_local)
    with pytest.raises(ValueError, match="float32 out-contributions"):
        csr.csr_pull(torch.zeros(2 * n_local + 1), graph)
    with pytest.raises(ValueError, match="float32 out-contributions"):
        csr.csr_pull(torch.zeros(2 * n_local, dtype=torch.float64), graph)
    with pytest.raises(ValueError, match="int32 blocks"):
        csr.csr_build(packed.to(torch.int64), n_local)
    with pytest.raises(ValueError, match="contiguous"):
        csr.csr_build(packed.transpose(0, 1), n_local)
    with pytest.raises(ValueError, match="n_local"):
        csr.csr_build(packed, 2**30 + 1)
    assert csr.index_dtype(2**30, 2**31 - 2**30 - 1) == torch.int32
    assert csr.index_dtype(2**30, 2**31 - 2**30) == torch.int64
