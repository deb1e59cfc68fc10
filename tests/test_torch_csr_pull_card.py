"""``srt_csr_*`` on an NVIDIA card, against their plain versions.

The build: offsets equal to the plain version's, every row's sources the
same multiset (the kernel places a row's edges in the order its atomics
run). The pull: with integer-valued out-contributions every partial sum
is an integer below 2^24, exact in float32 in any order, so the kernel
equals the plain version bit for bit; with random ones, every row lies
within the first-order error bound of the kernel's summation order of a
float64 sum. Graphs: rows of lengths around a tile's steps (row ends on
and beside tile boundaries), one row of 1,200,000 edges, a power-law
graph on 8 shards, int64 indices, and 40,000,000 rows a block (past the
bucketed build's shared counters: the build by global atomics). Then a
10-iteration ``PageRank.step`` builds once, pulls 10 times and launches
no ``index_add_``, ``index_select`` or zero fill of the contributions.
Every test needs a card and skips without one; the file imports no JAX,
so that it runs on the card's machine:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_csr_pull_card.py
"""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from sparkrdma_tpu_torch.ops import _build, csr

pytestmark = pytest.mark.card

U = 2.0 ** -24  # float32's unit roundoff
THREADS = 256  # csr_pull's threads a tile (csrc/csr_pull.cu kThreads)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)


def _tile_steps():
    return _build._load("libsrt_csr_pull.so").srt_csr_tile_steps()


def _launches():
    """CSR builds and pulls launched so far."""
    return _build.launches["srt_csr_build"], _build.launches["srt_csr_pull"]


def _boundary_rows(dev, n, seed):
    """Into vertices 0, 1, 2, ...: in-degrees cycling through a tile's
    steps T - 2 .. T + 1, 0, 1 and 2T, so row ends fall on and beside tile
    boundaries (a tile holds rows and edges together); sources random."""
    t = _tile_steps()
    lengths = [t - 2, t - 1, t, t + 1, 0, 1, 2 * t, 0, 3]
    deg = torch.tensor([lengths[v % len(lengths)] for v in range(64)], device=dev)
    dst = torch.repeat_interleave(torch.arange(64, device=dev), deg)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    src = torch.randint(0, n, dst.shape, device=dev, generator=g)
    return torch.stack([src, dst], 1).to(torch.int32)


def _hub(dev, n, seed):
    """1,200,000 edges into vertex 3, and 2,000,000 random ones."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    rand = torch.randint(0, n, (2_000_000, 2), device=dev, generator=g)
    hub = torch.stack([torch.randint(0, n, (1_200_000,), device=dev, generator=g),
                       torch.full((1_200_000,), 3, device=dev)], 1)
    return torch.cat([rand, hub]).to(torch.int32)


def _power_law(dev, n, seed):
    """A Graph500 Kronecker graph, the smoke's generator."""
    import chip_smoke

    return chip_smoke.kronecker_edges(torch, n.bit_length() - 1, chip_smoke.CP_EDGEFACTOR,
                                      chip_smoke.CP_INITIATOR, seed, dev)


GRAPHS = {
    # name: (edges, vertices, shards, int64 indices)
    "tile_boundaries": (_boundary_rows, 5000, 2, False),
    "tile_boundaries_one_shard": (_boundary_rows, 5000, 1, False),
    "hub_1m2_row": (_hub, 1 << 20, 1, False),
    "power_law_8_shards": (_power_law, 1 << 18, 8, False),
    "power_law_int64": (_power_law, 1 << 16, 8, True),
    "hub_int64": (_hub, 1 << 20, 2, True),
    # more buckets a block than the build's shared counters: its other path
    "global_atomics_40m_rows": (_hub, 40_000_000, 1, False),
    "global_atomics_int64": (_hub, 40_000_000, 1, True),
}


def _graph(name, dev):
    from sparkrdma_tpu_torch.models.pagerank import PageRank
    from sparkrdma_tpu_torch.parallel.mesh import make_mesh

    make, n, shards, wide = GRAPHS[name]
    edges = make(dev, n, 4_250_000_001 + len(name))
    packed, _, n_local = PageRank(make_mesh([dev] * shards)).blocks(edges, n)
    return packed, n_local, wide


def _csr_build(packed, n_local, wide):
    if wide:
        return csr._launch_build(packed, n_local, torch.int64)
    return csr.csr_build(packed, n_local)


def _sorted_rows(offsets, src):
    """Each edge as (row, source), sorted: the rows' multisets."""
    rows = offsets.shape[0] - 1
    edges = int(offsets[-1])
    row = torch.repeat_interleave(torch.arange(rows, device=src.device),
                                  (offsets[1:] - offsets[:-1]).to(torch.int64))
    return torch.sort(row * (1 << 32) + src[:edges].to(torch.int64)).values


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_kernels_match_plain_versions(name, card):
    packed, n_local, wide = _graph(name, card)
    builds, pulls = _launches()
    got = _csr_build(packed, n_local, wide)
    want = csr.csr_build_reference(packed, n_local)
    torch.cuda.synchronize()
    assert got.offsets.dtype == (torch.int64 if wide else torch.int32)
    assert torch.equal(got.offsets.to(torch.int64), want.offsets.to(torch.int64))
    assert torch.equal(_sorted_rows(got.offsets, got.src),
                       _sorted_rows(want.offsets, want.src))

    g = torch.Generator(device=card)
    g.manual_seed(7)
    whole = torch.randint(0, 4, (got.sources,), device=card, generator=g).float()
    assert torch.equal(csr.csr_pull(whole, got),
                       csr.csr_pull_reference(whole, want.offsets, want.src))

    outc = torch.rand((got.sources,), device=card, generator=g)
    y = csr.csr_pull(outc, got)
    torch.cuda.synchronize()
    assert _launches() == (builds + 1, pulls + 2)
    exact = csr.csr_pull_reference(outc.double(), want.offsets, want.src)
    length = (want.offsets[1:] - want.offsets[:-1]).double()
    # the kernel adds a row's edges in runs of at most kItems (tile steps
    # / THREADS) a thread, then over at most THREADS threads by a scan
    # (depth 5 within a warp, then 8 warps in turn, and the run's first
    # row and the tile's carry once more each), then the carries of the
    # tiles the row crosses in turn: a first-order bound on the error of
    # that order is (additions in sequence) * u * the sum
    steps = _tile_steps()
    terms = steps // THREADS + 5 + THREADS // 32 + 3 + torch.ceil(length / steps)
    err = (y.double() - exact).abs()
    assert bool((err <= terms * U * exact).all()), float((err / (terms * U * exact)).max())


def test_a_ten_iteration_job_builds_once_and_pulls_ten_times(card):
    from sparkrdma_tpu_torch.models.pagerank import PageRank
    from sparkrdma_tpu_torch.parallel.mesh import make_mesh

    n, iters = 1 << 16, 10
    edges = _power_law(card, n, 4_250_000_099)
    pr = PageRank(make_mesh([card] * 8))
    packed, deg, n_local = pr.blocks(edges, n)
    rank0, valid = pr.initial(n_local, n)
    fn = pr.step(n_local, packed.shape[2], iters, n)
    fn(rank0, deg, valid, packed)  # builds the library, warms the allocator
    torch.cuda.synchronize()
    builds, pulls = _launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        ranks = fn(rank0, deg, valid, packed)
        torch.cuda.synchronize()
    assert _launches() == (builds + 1, pulls + iters)

    # against a float64 power iteration from the raw edges
    src, dst = edges[:, 0].long(), edges[:, 1].long()
    outdeg = torch.bincount(src, minlength=n).double()
    want = torch.full((n,), 1.0 / n, dtype=torch.float64, device=card)
    for _ in range(iters):
        outc = torch.where(outdeg > 0, want / outdeg.clamp(min=1), 0.0)
        contrib = torch.zeros_like(want).index_add_(0, dst, outc[src])
        want = (1 - pr.damping) / n + pr.damping * (contrib + want[outdeg == 0].sum() / n)
    torch.testing.assert_close(ranks[:n].double(), want, rtol=2e-5, atol=1e-9 / n)

    events = list(prof.profiler.kineto_results.events())
    names = {x.name() for x in events}
    assert not names & {"aten::index_add_", "aten::index_select"}
    assert any("csr_pull" in x for x in names)
    scatters = [(x.start_thread_id(), x.start_ns(), x.end_ns()) for x in events
                if x.name() == "pagerank.scatter"]
    assert len(scatters) == iters
    inside = {x.name() for x in events if x.name().startswith("aten::")
              and any(t == x.start_thread_id() and s <= x.start_ns() <= f
                      for t, s, f in scatters)}
    assert not inside & {"aten::zeros", "aten::zero_", "aten::fill_"}, inside
