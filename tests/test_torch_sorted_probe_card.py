"""``srt_sorted_probe`` (4-byte rows) and ``srt_sorted_probe64`` (8-byte
rows) on an NVIDIA card, against their plain version.

Bit for bit, ``joined``: at both join cells' probe shapes ([8, 8,
4,000,000] probe slots into 8 build rows of 32,000,000 slots, 4-byte
rows; [8, 8, 2^23] into 8 rows of 2^22, 8-byte rows), with uniform keys
partitioned by their top bits as the join sends them, with every build
key of a shard in one directory bucket, and with Zipf-drawn build keys
(long runs of one key); the probe's counters against the valid slots.
Then ``HashJoin.step`` on the card returns what the same step returns on
the CPU at both widths, launches the probe once a step, makes no
synchronising CUDA call inside its ``hashjoin.probe`` span, and counts
``sum(pcnt)`` probes in ``last_probe_stats``. Every test needs a card
and skips without one; the file imports no JAX, so that it runs on the
card's machine:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_sorted_probe_card.py
"""

import math

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from sparkrdma_tpu_torch.ops import _build
from sparkrdma_tpu_torch.ops import sort as tsort

pytestmark = pytest.mark.card

MISS = -1
# width: (key dtype, the keys' bit dtype, bits)
WIDTHS = {32: (torch.uint32, torch.int32, 32), 64: (torch.uint64, torch.int64, 64)}
SYMBOL = {32: "srt_sorted_probe", 64: "srt_sorted_probe64"}
# name: (E, slots a build row, probe slots a source, width)
CELLS = {"join_cell": (8, 32_000_000, 4_000_000, 32),
         "wide_cell": (8, 1 << 22, 1 << 23, 64)}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)


def _wrap(x: torch.Tensor, bits: int) -> torch.Tensor:
    """int64 values as the bit pattern of a ``bits``-bit key (int32 or
    int64)."""
    if bits == 64:
        return x
    x = x & 0xFFFFFFFF
    return (x - ((x >> 31) << 32)).to(torch.int32)


def _build_keys(g, dev, e, m, bits, kind):
    """[E, m] int64 raw build keys of each shard (the low ``bits`` bits
    used): ``uniform`` keys whose top log2 E bits are the shard, as the
    join's partition sends them; ``one_bucket``: 0, the largest key
    below the maximum, and every other key in a range of 4,096, so that
    they share one directory bucket; ``zipf``: hashed Zipf ranks
    (exponent 1.5), long runs of one key."""
    lg = int(math.log2(e))
    if kind == "uniform":
        keys = torch.randint(-(1 << 62), 1 << 62, (e, m), device=dev, generator=g)
        low = (1 << (bits - lg)) - 1
        shard = torch.arange(e, device=dev, dtype=torch.int64).view(e, 1)
        return (keys & low) | (shard << (bits - lg))  # at 64 bits, wrapping to the sign
    if kind == "one_bucket":
        keys = torch.randint(0, 4096, (e, m), device=dev, generator=g) + (1 << (bits - 2))
        keys[:, 0] = 0
        keys[:, 1] = (1 << bits) - 2 if bits < 64 else -2
        return keys
    u = torch.rand((e, m), device=dev, generator=g, dtype=torch.float64)
    ranks = (1.0 - u).pow(-2.0).floor().clamp_(max=float(1 << 40)).to(torch.int64)
    return ranks * -7046029254386353131  # 0x9E3779B97F4A7C15 as int64, wrapping


def _stacks(dev, e, m, cap_p, width, kind, seed):
    """What ``hashjoin.build_sort`` leaves and a probe slab: ``(bkeys_s,
    bvals_s, bcnt, pkeys, pcnt)``. Each shard's E build counts lie near
    half of cap_b = m / E, the rows masked to the maximum past them and
    sorted stably; each probe row's counts near half of cap_p; 7 of 8
    valid probe keys are the shard's build keys, the rest random, a few
    the padding key; slots past the counts hold random keys."""
    key_dtype, bit_dtype, bits = WIDTHS[width]
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    cap_b = m // e
    bcnt = (cap_b // 2 + torch.randint(-(cap_b >> 6), (cap_b >> 6) + 1, (e, e), device=dev,
                                       generator=g)).to(torch.int32)
    raw = _wrap(_build_keys(g, dev, e, m, bits, kind), bits)
    col = torch.arange(cap_b, device=dev)
    valid = (col < bcnt.unsqueeze(-1).to(torch.int64)).view(e, m)
    masked = torch.where(valid, raw, -1).view(key_dtype)
    del raw, valid
    order = tsort.device_argsort(masked)
    bkeys_s = torch.gather(masked.view(bit_dtype), 1, order)
    del masked
    bvals = torch.randint(-(1 << 30), 1 << 30, (e, m), device=dev, generator=g,
                          dtype=torch.int64).to(bit_dtype)
    bvals_s = torch.gather(bvals, 1, order)
    del bvals, order
    pcnt = (cap_p // 2 + torch.randint(-(cap_p >> 6), (cap_p >> 6) + 1, (e, e), device=dev,
                                       generator=g)).to(torch.int32)
    pcnt[0, 0], pcnt[0, 1] = 0, cap_p  # an empty and a full probe row
    n = bcnt.to(torch.int64).sum(1, keepdim=True)
    at = (torch.rand((e, e * cap_p), device=dev, generator=g, dtype=torch.float64) * n
          ).to(torch.int64)
    pkeys = torch.gather(bkeys_s, 1, at)
    del at
    miss = torch.rand((e, e * cap_p), device=dev, generator=g) < 0.125
    noise = _wrap(torch.randint(-(1 << 62), 1 << 62, (e, e * cap_p), device=dev,
                                generator=g), bits)
    pkeys = torch.where(miss, noise, pkeys)
    del miss, noise
    pkeys[:, :64] = -1  # the padding key
    return (bkeys_s.view(key_dtype), bvals_s, bcnt,
            pkeys.view(e, e, cap_p).view(key_dtype), pcnt)


def _check(dev, e, m, cap_p, width, kind, seed):
    bkeys_s, bvals_s, bcnt, pkeys, pcnt = _stacks(dev, e, m, cap_p, width, kind, seed)
    launches = _build.launches[SYMBOL[width]]
    got, stats = tsort.probe_sorted(bkeys_s, bvals_s, bcnt, pkeys, pcnt, MISS)
    torch.cuda.synchronize()
    assert _build.launches[SYMBOL[width]] == launches + 1
    want, _ = tsort.probe_sorted_reference(bkeys_s, bvals_s, bcnt, pkeys, pcnt, MISS)
    assert got.dtype == want.dtype and got.shape == want.shape == (e, e * cap_p)
    assert torch.equal(got, want)
    assert int((got != MISS).sum()) > 0
    probes = pcnt.clamp(0, cap_p).to(torch.int64).sum(1)
    assert torch.equal(stats[:, 0], probes)
    return stats[:, 1].sum().item() / probes.sum().item(), bcnt


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_kernel_matches_plain_version_at_the_cells_shape(cell, card):
    e, m, cap_p, width = CELLS[cell]
    steps, _ = _check(card, e, m, cap_p, width, "uniform", seed=3_000_000_001 + width)
    # 8-16 keys a bucket: a search of about log2 of that
    assert 1.0 <= steps <= 5.0, steps


@pytest.mark.parametrize("kind", ["one_bucket", "zipf"])
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_kernel_matches_plain_version_under_skew(cell, kind, card):
    e, m, cap_p, width = CELLS[cell]
    steps, bcnt = _check(card, e, m, cap_p, width, kind, seed=3_000_000_101 + width)
    if kind == "one_bucket":
        # every key in one bucket: the 7 of 8 probes drawn from the build
        # keys search the shard's whole row
        n = int(bcnt.to(torch.int64).sum(1).min())
        assert steps >= 0.75 * (math.log2(n) - 1), steps


def _tables(e, n, width, seed):
    rng = np.random.default_rng(seed)
    if width == 64:
        bk = np.arange(1, e * n + 1, dtype=np.uint64) * np.uint64(0x9E3779B97F4A7C15)
        vt = np.int64
    else:
        bk = (np.arange(1, e * n + 1, dtype=np.uint64) * np.uint64(0x9E3779B1)
              % np.uint64(1 << 32)).astype(np.uint32)
        vt = np.int32
    bk = bk[rng.permutation(e * n)]
    pk = bk[rng.integers(0, e * n, 4 * e * n)]
    pk[:1000] = rng.integers(0, np.iinfo(bk.dtype).max, 1000, dtype=bk.dtype)  # misses
    return bk, np.arange(e * n, dtype=vt), pk, np.arange(len(pk), dtype=vt)


@pytest.mark.parametrize("width", [32, 64])
def test_step_matches_the_cpu_step_and_never_syncs(width, card):
    from sparkrdma_tpu_torch.models.hashjoin import HashJoin
    from sparkrdma_tpu_torch.parallel.mesh import make_mesh

    e, n = 8, 1 << 17
    tables = _tables(e, n, width, seed=30 + width)
    outs = []
    for dev in (card, torch.device("cpu")):
        join = HashJoin(make_mesh([dev] * e))
        args, nb, npl = join.place(*tables)
        fn = join.step(nb, npl, 2 * nb // e, 2 * npl // e)
        outs.append([t.cpu() for t in fn(*args)])
    for name, a, b in zip(("pk2", "pv2", "joined", "pcnt", "overflow"), *outs):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.equal(tsort._bits(a), tsort._bits(b)), name
    assert not bool(outs[0][4]) and int((outs[0][2] == -1).sum()) >= 1000

    join = HashJoin(make_mesh([card] * e))
    args, nb, npl = join.place(*tables)
    cap_p = 2 * npl // e
    fn = join.step(nb, npl, 2 * nb // e, cap_p)
    fn(*args)
    torch.cuda.synchronize()
    launches = _build.launches["srt_sorted_probe"], _build.launches["srt_sorted_probe64"]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = fn(*args)
        torch.cuda.synchronize()
    wide = width == 64
    assert (_build.launches["srt_sorted_probe"], _build.launches["srt_sorted_probe64"]) == (
        launches[0] + (not wide), launches[1] + wide)
    pcnt = out[3]
    assert int(join.last_probe_stats[:, 0].sum()) == int(pcnt.clamp(0, cap_p).sum())
    events = list(prof.profiler.kineto_results.events())
    probes = [(x.start_thread_id(), x.start_ns(), x.end_ns()) for x in events
              if x.name() == "hashjoin.probe"]
    assert len(probes) == 1
    syncs = [x.name() for x in events if "Synchronize" in x.name()
             and any(t == x.start_thread_id() and s <= x.start_ns() <= f
                     for t, s, f in probes)]
    assert syncs == []
