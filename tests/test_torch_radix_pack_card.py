"""``srt_radix_pack`` on an NVIDIA card, against its plain version.

Bit for bit, slabs, counts and overflow flags: at the join cell's shape
(8 shards of 16,000,000 rows into 8 partitions of 4,000,000 slots), at
capacities that overflow (the last row in the last slot, from a tile
other than the one that filled the partition), at row counts that are no
multiple of the kernel's tile, and at 1 and 256 partitions. Then
``HashJoin.step`` on the card makes no synchronising CUDA call inside
its ``hashjoin.pack`` spans (the profiler count that the benchmark's
``step.syncs.join`` reads). Every test needs a card and skips without
one; the file imports no JAX, so that it runs on the card's machine:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_radix_pack_card.py
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from sparkrdma_tpu_torch.ops import _build
from sparkrdma_tpu_torch.ops import sort as tsort

pytestmark = pytest.mark.card

SENTINEL = 0xFFFFFFFF
VAL_FILL = -1

# name: (E, n, P, capacity, share of rows sent to one hot partition,
# whether a partition overflows)
SHAPES = {
    "cell": (8, 16_000_000, 8, 4_000_000, 0.0, False),
    "cell_overflowing": (8, 16_000_000, 8, 1_999_999, 0.0, True),
    "hot_overflowing": (8, 1_000_003, 8, 100_000, 0.5, True),
    "ragged_256": (3, 12_345, 256, 60, 0.3, True),
    "ragged_one_partition": (2, 4_097, 1, 5_000, 0.0, False),
    "capacity_one": (2, 10_001, 2, 1, 0.0, True),
    "tiny": (1, 1, 8, 8, 0.0, False),
}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)


def _stack(dev, e, n, p, hot, seed):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    keys = torch.randint(-(1 << 31), 1 << 31, (e, n), dtype=torch.int64, device=dev,
                         generator=g).to(torch.int32)
    keys[:, :5] = -1  # the sentinel
    if hot and p > 1:
        shift = 32 - (p.bit_length() - 1)
        sel = torch.rand((e, n), device=dev, generator=g) < hot
        moved = ((keys & ((1 << shift) - 1)) | ((p // 2) << shift)).to(torch.int32)
        keys = torch.where(sel, moved, keys)
    vals = torch.randint(-(1 << 31), 1 << 31, (e, n), dtype=torch.int64, device=dev,
                         generator=g).to(torch.int32)
    return keys.view(torch.uint32).contiguous(), vals.contiguous()


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_kernel_matches_plain_version(shape, card):
    e, n, p, cap, hot, overflows = SHAPES[shape]
    keys, vals = _stack(card, e, n, p, hot, seed=4_200_000_001 + len(shape))
    launches = _build.launches["srt_radix_pack"]
    got = tsort.radix_pack_pairs(keys, vals, p, cap, key_fill=SENTINEL,
                                 val_fill=VAL_FILL)
    torch.cuda.synchronize()
    assert _build.launches["srt_radix_pack"] == launches + 1
    want = tsort.radix_pack_pairs_reference(keys, vals, p, cap, 32, SENTINEL, VAL_FILL)
    for name, a, b in zip(("kslab", "vslab", "counts", "overflowed"), want, got):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.equal(a, b), name
    assert bool(got[3].any()) == overflows


def test_hashjoin_pack_never_syncs(card):
    from sparkrdma_tpu_torch.models.hashjoin import HashJoin
    from sparkrdma_tpu_torch.parallel.mesh import make_mesh

    e, n = 8, 1 << 20
    rng = np.random.default_rng(7)
    bk = (rng.permutation(e * n).astype(np.uint64) * 0x9E3779B1 % 2**32).astype(np.uint32)
    pk = bk[rng.permutation(e * n)]
    join = HashJoin(make_mesh([card] * e))
    args, nb, npl = join.place(bk, np.arange(e * n, dtype=np.int32),
                               pk, np.arange(e * n, dtype=np.int32))
    fn = join.step(nb, npl, 2 * nb // e, 2 * npl // e)
    fn(*args)  # builds the library and warms the allocator
    torch.cuda.synchronize()
    launches = _build.launches["srt_radix_pack"]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = fn(*args)
        torch.cuda.synchronize()
    assert _build.launches["srt_radix_pack"] == launches + 2
    assert not bool(out[4])
    events = list(prof.profiler.kineto_results.events())
    packs = [(x.start_thread_id(), x.start_ns(), x.end_ns()) for x in events
             if x.name() == "hashjoin.pack"]
    assert len(packs) == 2
    syncs = [x.name() for x in events if "Synchronize" in x.name()
             and any(t == x.start_thread_id() and s <= x.start_ns() <= f
                     for t, s, f in packs)]
    assert syncs == []
