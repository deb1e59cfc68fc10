"""``srt_radix_pack64`` (8-byte rows) on an NVIDIA card, against its plain
version, and ``srt_radix_pack`` (4-byte rows) beside it.

Bit for bit, slabs, counts and overflow flags: at the wide join cell's
probe shape (8 shards of 2^25 rows into 8 partitions of 2^23 slots), at
capacities that overflow, at row counts that are no multiple of the
kernel's tile, at 1 and 256 partitions and below 64 key bits; the 4-byte
kernel at the same shape. Then ``HashJoin.step`` at 8-byte rows on the
card returns what the same step returns on the CPU, launches
``srt_radix_pack64`` once a side and makes no synchronising CUDA call
inside its ``hashjoin.pack`` spans. Every test needs a card and skips
without one; the file imports no JAX, so that it runs on the card's
machine:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_radix_pack64_card.py
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from sparkrdma_tpu_torch.ops import _build
from sparkrdma_tpu_torch.ops import sort as tsort

pytestmark = pytest.mark.card

PAD64 = (1 << 64) - 1
VAL_FILL = -1

# name: (E, n, P, capacity, key_bits, share of rows sent to one hot
# partition, whether a partition overflows)
SHAPES = {
    "cell_probe": (8, 1 << 25, 8, 1 << 23, 64, 0.0, False),
    "cell_probe_overflowing": (8, 1 << 25, 8, 4_000_000, 64, 0.0, True),
    "hot_overflowing": (8, 1_000_003, 8, 100_000, 64, 0.5, True),
    "ragged_256": (3, 12_345, 256, 60, 64, 0.3, True),
    "ragged_one_partition": (2, 4_097, 1, 5_000, 64, 0.0, False),
    "capacity_one": (2, 10_001, 2, 1, 64, 0.0, True),
    "key_bits_40": (4, 100_003, 16, 10_000, 40, 0.0, False),
    "tiny": (1, 1, 8, 8, 64, 0.0, False),
}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)


def _stack64(dev, e, n, p, key_bits, hot, seed):
    """[E, n] uint64 keys below 2^key_bits (the padding key among them at
    64 bits) and int64 payloads."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    keys = torch.randint(-(1 << 63), (1 << 63) - 1, (e, n), dtype=torch.int64,
                         device=dev, generator=g)
    if key_bits < 64:
        keys &= (1 << key_bits) - 1
    else:
        keys[:, :5] = -1  # the padding key
    if hot and p > 1:
        shift = key_bits - (p.bit_length() - 1)
        top = (p // 2) << shift
        top = top - (1 << 64) if top >= 1 << 63 else top
        sel = torch.rand((e, n), device=dev, generator=g) < hot
        keys = torch.where(sel, (keys & ((1 << shift) - 1)) | top, keys)
    vals = torch.randint(-(1 << 63), (1 << 63) - 1, (e, n), dtype=torch.int64,
                         device=dev, generator=g)
    return keys.view(torch.uint64).contiguous(), vals.contiguous()


def _check(got, want, overflows=None):
    for name, a, b in zip(("kslab", "vslab", "counts", "overflowed"), want, got):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.equal(a.view(torch.int64) if a.dtype == torch.uint64 else a,
                           b.view(torch.int64) if b.dtype == torch.uint64 else b), name
    if overflows is not None:
        assert bool(got[3].any()) == overflows


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_kernel64_matches_plain_version(shape, card):
    e, n, p, cap, key_bits, hot, overflows = SHAPES[shape]
    keys, vals = _stack64(card, e, n, p, key_bits, hot, seed=4_290_000_001 + len(shape))
    launches = _build.launches["srt_radix_pack64"]
    got = tsort.radix_pack_pairs(keys, vals, p, cap, key_bits, key_fill=PAD64,
                                 val_fill=VAL_FILL)
    torch.cuda.synchronize()
    assert _build.launches["srt_radix_pack64"] == launches + 1
    want = tsort.radix_pack_pairs_reference(keys, vals, p, cap, key_bits, PAD64, VAL_FILL)
    _check(got, want, overflows)


def test_kernel32_at_the_wide_cells_shape(card):
    """The 4-byte kernel, beside the 8-byte one in the same template,
    still equals its plain version at [8, 2^25] into [8, 8, 2^23]."""
    e, n, p, cap = 8, 1 << 25, 8, 1 << 23
    keys64, vals64 = _stack64(card, e, n, p, 64, 0.0, seed=4_290_000_777)
    keys = (keys64.view(torch.int64) >> 32).to(torch.int32).view(torch.uint32).contiguous()
    vals = vals64.to(torch.int32)
    del keys64, vals64
    launches = _build.launches["srt_radix_pack"]
    got = tsort.radix_pack_pairs(keys, vals, p, cap, key_fill=0xFFFFFFFF, val_fill=VAL_FILL)
    torch.cuda.synchronize()
    assert _build.launches["srt_radix_pack"] == launches + 1
    want = tsort.radix_pack_pairs_reference(keys, vals, p, cap, 32, 0xFFFFFFFF, VAL_FILL)
    for name, a, b in zip(("kslab", "vslab", "counts", "overflowed"), want, got):
        assert a.dtype == b.dtype and torch.equal(a, b), name


def _wide_tables(e, n, seed):
    rng = np.random.default_rng(seed)
    bk = np.arange(1, e * n + 1, dtype=np.uint64) * np.uint64(0x9E3779B97F4A7C15)
    bk = bk[rng.permutation(e * n)]
    pk = bk[rng.integers(0, e * n, 4 * e * n)]
    pk[:1000] = rng.integers(0, 1 << 63, 1000, dtype=np.uint64)  # misses
    return (bk, np.arange(e * n, dtype=np.int64), pk,
            np.arange(len(pk), dtype=np.int64))


def test_wide_step_matches_the_cpu_step_and_never_syncs(card):
    from sparkrdma_tpu_torch.models.hashjoin import HashJoin
    from sparkrdma_tpu_torch.parallel.mesh import make_mesh

    e, n = 8, 1 << 17
    tables = _wide_tables(e, n, seed=29)
    outs = []
    for dev in (card, torch.device("cpu")):
        join = HashJoin(make_mesh([dev] * e))
        args, nb, npl = join.place(*tables)
        fn = join.step(nb, npl, 2 * nb // e, 2 * npl // e)
        outs.append([t.cpu() for t in fn(*args)])
    for name, a, b in zip(("pk2", "pv2", "joined", "pcnt", "overflow"), *outs):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.equal(a.view(torch.int64) if a.dtype == torch.uint64 else a,
                           b.view(torch.int64) if b.dtype == torch.uint64 else b), name
    assert not bool(outs[0][4]) and int((outs[0][2] == -1).sum()) >= 1000

    join = HashJoin(make_mesh([card] * e))
    args, nb, npl = join.place(*tables)
    fn = join.step(nb, npl, 2 * nb // e, 2 * npl // e)
    fn(*args)
    torch.cuda.synchronize()
    launches = _build.launches["srt_radix_pack64"], _build.launches["srt_radix_pack"]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn(*args)
        torch.cuda.synchronize()
    assert (_build.launches["srt_radix_pack64"], _build.launches["srt_radix_pack"]) == (
        launches[0] + 2, launches[1])
    events = list(prof.profiler.kineto_results.events())
    packs = [(x.start_thread_id(), x.start_ns(), x.end_ns()) for x in events
             if x.name() == "hashjoin.pack"]
    assert len(packs) == 2
    syncs = [x.name() for x in events if "Synchronize" in x.name()
             and any(t == x.start_thread_id() and s <= x.start_ns() <= f
                     for t, s, f in packs)]
    assert syncs == []
