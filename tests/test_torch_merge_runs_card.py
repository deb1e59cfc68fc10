"""``srt_merge_runs`` on an NVIDIA card, against its plain version.

Bit for bit, ``merged`` (the sentinel tail included) and ``totals``:
E shards of R = E runs for E 1, 2, 4, 8 and 16, at a capacity that is no
multiple of the kernel's tile, with ragged counts (0 and ``cap`` among
them) and random keys past every count; one key everywhere; only the
keys 0 and 0xFFFFFFFF, so the sentinel is a real key too; and the sort
cell's shape, ``[8, 8, 2^23]``, where the plain version is the parent's
path (``merge_received`` shard by shard). Then: one launch a call and no
synchronising CUDA call (``torch.cuda.set_sync_debug_mode("error")``);
shapes beyond the kernel's limits raise before any launch; and
``TeraSorter.step`` merges once a stage, each shard's range sorted with
the sentinel after it. Every test needs a card and skips without one;
the file imports no JAX, so that it runs on the card's machine:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_merge_runs_card.py
"""

import pytest
import torch

from sparkrdma_tpu_torch.ops import _build
from sparkrdma_tpu_torch.ops import sort as tsort

pytestmark = pytest.mark.card

SENTINEL = 0xFFFFFFFF

# name: (E, R, cap, kind)
SHAPES = {
    **{f"ragged_e{e}": (e, e, 100_003, "ragged") for e in (1, 2, 4, 8, 16)},
    "equal_e8": (8, 8, 50_001, "equal"),
    "extremes_e4": (4, 4, 70_001, "extremes"),
    "extremes_e16": (16, 16, 9_999, "extremes"),
    "cap_one_e16": (16, 16, 1, "ragged"),
    "cell": (8, 8, 1 << 23, "cell"),
}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)


def _as_u32(x):
    """int64 values in [0, 2^32) as uint32 bits."""
    return (x - (x >= 1 << 31).to(torch.int64) * (1 << 32)).to(torch.int32).view(torch.uint32)


def _runs(dev, e, r, cap, kind, seed):
    """A contiguous uint32 ``[E, R, cap]`` slab ascending in each row's
    first ``counts`` slots and random past them, and the int32 counts."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    if kind == "cell":
        # the sort cell's rows: about 2^22 keys each, shard i's in key range i
        counts = cap // 2 + torch.randint(-(cap >> 6), (cap >> 6) + 1, (e, r), device=dev,
                                           generator=g)
        keys = torch.randint(0, 1 << 29, (e, r, cap), device=dev, generator=g)
        keys += (torch.arange(e, device=dev) << 29).view(e, 1, 1)
    else:
        counts = torch.randint(0, cap + 1, (e, r), device=dev, generator=g)
        if kind == "ragged":
            keys = torch.randint(0, 1 << 32, (e, r, cap), device=dev, generator=g)
        elif kind == "equal":
            keys = torch.full((e, r, cap), 0x9E3779B1, device=dev)
        else:
            keys = torch.randint(0, 2, (e, r, cap), device=dev, generator=g) * SENTINEL
    counts = counts.to(torch.int32).view(-1)
    counts[0] = cap
    if counts.numel() > 1:
        counts[1] = 0
    counts = counts.view(e, r)
    valid = torch.arange(cap, device=dev) < counts.unsqueeze(-1)
    keys = torch.sort(torch.where(valid, keys, SENTINEL), dim=-1).values
    garbage = torch.randint(0, 1 << 32, (e, r, cap), device=dev, generator=g)
    slab = _as_u32(torch.where(valid, keys, garbage)).contiguous()
    return slab, counts


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_kernel_matches_plain_version(shape, card):
    e, r, cap, kind = SHAPES[shape]
    slab, counts = _runs(card, e, r, cap, kind, seed=4_270_000_001 + len(shape))
    want = tsort.merge_sorted_runs_reference(slab, counts, SENTINEL)
    launches = _build.launches["srt_merge_runs"]
    got = tsort.merge_sorted_runs(slab, counts, SENTINEL)
    torch.cuda.synchronize()
    assert _build.launches["srt_merge_runs"] == launches + 1
    for name, a, b in zip(("merged", "totals"), want, got):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.equal(a, b), name


def test_one_launch_and_no_sync(card):
    slab, counts = _runs(card, 8, 8, 300_007, "ragged", seed=4_270_000_101)
    tsort.merge_sorted_runs(slab.clone(), counts, SENTINEL)  # builds the library
    torch.cuda.synchronize()
    launches = _build.launches["srt_merge_runs"]
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = tsort.merge_sorted_runs(slab, counts, SENTINEL)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert _build.launches["srt_merge_runs"] == launches + 1
    assert int(got[1].sum()) == int(counts.sum())


@pytest.mark.parametrize("shape", [(65536, 1, 1), (1, 1025, 1), (1, 2, 1 << 30)],
                         ids=["shards", "runs", "slots"])
def test_out_of_limit_shapes_raise(shape, card):
    slab = torch.empty(shape, dtype=torch.uint32, device=card)
    counts = torch.zeros(shape[:2], dtype=torch.int32, device=card)
    launches = _build.launches["srt_merge_runs"]
    with pytest.raises(ValueError, match="srt_merge_runs takes at most"):
        tsort.merge_sorted_runs(slab, counts, SENTINEL)
    assert _build.launches["srt_merge_runs"] == launches


def test_terasorter_step_merges_once_a_stage(card):
    from sparkrdma_tpu_torch.models.terasort import TeraSorter
    from sparkrdma_tpu_torch.parallel.mesh import make_mesh

    e, n_local = 8, 1 << 21
    g = torch.Generator(device=card)
    g.manual_seed(4_270_000_201)
    wide = torch.randint(0, 1 << 32, (e * n_local,), device=card, generator=g)
    wide[:3] = SENTINEL
    keys = _as_u32(wide)
    fn = TeraSorter(make_mesh([card] * e)).step(n_local)
    fn(keys)
    torch.cuda.synchronize()
    launches = _build.launches["srt_merge_runs"]
    merged, totals, overflowed = fn(keys)
    torch.cuda.synchronize()
    assert _build.launches["srt_merge_runs"] == launches + 1
    assert not bool(overflowed)
    rows = merged.view(e, -1).view(torch.int32).to(torch.int64) & SENTINEL
    want = torch.sort(wide).values
    shard = want >> 29
    for i, t in enumerate(totals.tolist()):
        assert torch.equal(rows[i, :t], want[shard == i])
        assert bool((rows[i, t:] == SENTINEL).all())
