"""``ops/sort.py`` ``probe_sorted``, the hash join's probe, on the CPU.

The plain version against a NumPy oracle of the join's semantics (the
first slot of the build row holding the probe key, else ``miss``; slots
past ``pcnt`` miss) at both row widths: an empty shard and a row with no
padding tail, probe keys below and above every build key, the padding
key as a probe key with and without a build key equal to it, repeated
build keys, probe counts of 0 and of ``cap_p``, and keys at and above
2^31 and 2^63. Then the kernel's design (``csrc/sorted_probe.cu``: the
span, the directory of each bucket's lower bound, none for an empty
shard, one bucket's search a probe, the clamp, the counters) emulated
through the launch's
pointers, against the plain version; the arguments refused before a
launch; ``HashJoin``'s one launch a step and its registry counters."""

import contextlib
import ctypes

import numpy as np
import pytest
import torch

from sparkrdma_tpu_torch.ops import _build
from sparkrdma_tpu_torch.ops import sort as tsort

torch.set_num_threads(1)

MISS = -7
# width: (numpy key, numpy payload, torch key, torch payload)
WIDTHS = {32: (np.uint32, np.int32, torch.uint32, torch.int32),
          64: (np.uint64, np.int64, torch.uint64, torch.int64)}


def _pad(width):
    return (1 << width) - 1


def _random_keys(rng, width, n, lo=0, hi=None):
    hi = (1 << width) - 1 if hi is None else hi  # the padding key left out
    return rng.integers(lo, hi, n, dtype=np.uint64).astype(WIDTHS[width][0])


def _sides(width, rng, build, probe, e=4, cap_b=16, cap_p=24):
    """The stacks ``hashjoin.build_sort`` leaves, and a probe slab.

    ``build[d]`` is shard d's valid build keys, spread over its E source
    segments (at most cap_b each) in order; ``probe[d]`` is its probe
    rows: E lists of valid keys (at most cap_p each). Padding build slots
    hold the padding key and a random payload before the stable sort;
    probe slots past their count hold random keys."""
    kt, vt, tk, tv = WIDTHS[width]
    m = e * cap_b
    raw = np.full((e, m), _pad(width), dtype=kt)
    vals = rng.integers(-(1 << 30), 1 << 30, (e, m)).astype(vt)
    bcnt = np.zeros((e, e), np.int32)
    for d, keys in enumerate(build):
        keys = np.asarray(keys, dtype=kt)
        assert len(keys) <= m
        left = len(keys)
        for s in range(e):
            c = min(cap_b, -(-left // (e - s)))
            off = len(keys) - left
            raw[d, s * cap_b:s * cap_b + c] = keys[off:off + c]
            bcnt[d, s] = c
            left -= c
    order = np.argsort(raw, axis=1, kind="stable")
    bkeys_s = np.take_along_axis(raw, order, 1)
    bvals_s = np.take_along_axis(vals, order, 1)
    pkeys = _random_keys(rng, width, e * e * cap_p).reshape(e, e, cap_p)
    pcnt = np.zeros((e, e), np.int32)
    for d, rows in enumerate(probe):
        for s, keys in enumerate(rows):
            pkeys[d, s, :len(keys)] = keys
            pcnt[d, s] = len(keys)
    signed = {32: np.int32, 64: np.int64}[width]
    return (torch.from_numpy(bkeys_s.view(signed)).view(tk), torch.from_numpy(bvals_s),
            torch.from_numpy(bcnt), torch.from_numpy(pkeys.view(signed)).view(tk),
            torch.from_numpy(pcnt))


def _oracle(bkeys_s, bvals_s, pkeys, pcnt, miss):
    """For each valid probe slot, the payload of the first slot of its
    shard's build row that holds its key; ``miss`` elsewhere."""
    bk = tsort._bits(bkeys_s).numpy()
    bv = bvals_s.numpy()
    pk = tsort._bits(pkeys).numpy()
    e, _, cap_p = pk.shape
    out = np.full((e, e, cap_p), miss, dtype=bv.dtype)
    for d in range(e):
        first = {}
        for i, k in enumerate(bk[d]):
            first.setdefault(int(k), i)
        for s in range(e):
            for j in range(min(max(int(pcnt[d, s]), 0), cap_p)):
                i = first.get(int(pk[d, s, j]))
                if i is not None:
                    out[d, s, j] = bv[d, i]
    return out.reshape(e, e * cap_p)


def _probes_from(rng, keys, n):
    """n probe keys drawn from ``keys``; none if it is empty."""
    return keys[rng.integers(0, len(keys), n)] if len(keys) else keys[:0]


def _case(name, width, rng, e=4, cap_b=16, cap_p=24):
    """(build, probe) of a named case: each shard's valid build keys and
    its E probe rows, each row's named keys first, then keys drawn from
    the shard's build keys, then random ones."""
    kt = WIDTHS[width][0]
    pad = _pad(width)
    top = 1 << (width - 1)
    third = (1 << width) // 3
    m = e * cap_b
    build, probe = [], []
    for d in range(e):
        keys = _random_keys(rng, width, m // 2 + d)
        extra = []
        if name == "empty_shard" and d == 0:
            keys, extra = keys[:0], [pad, 0, 1]
        elif name == "full_row" and d < 2:
            keys = _random_keys(rng, width, m)
            extra = [pad, keys.max(), keys.min()]
        elif name == "outside_span":
            keys = _random_keys(rng, width, len(keys), third, 2 * third)
            extra = [0, third - 1, 2 * third, pad - 1, pad, keys.min(), keys.max()]
        elif name == "pad_key_in_prefix":
            keys = np.concatenate([keys[:-3], np.full(3, pad, kt)])
            extra = [pad, pad]
        elif name == "pad_key_in_tail_only":
            extra = [pad, pad]
            if d == 1:  # a full row: the padding key's search runs past it
                keys = _random_keys(rng, width, m)
        elif name == "duplicates":
            keys = np.repeat(_random_keys(rng, width, 5), len(keys) // 5 + 1)[:len(keys)]
            rng.shuffle(keys)
        elif name == "high_keys":
            keys = np.concatenate([np.array([top - 1, top, top + 1, pad - 1], kt),
                                   _random_keys(rng, width, len(keys) - 4, top - 50, top + 50)])
            extra = [top - 1, top, top + 1, pad - 1, top + 60, top - 60]
        rows = []
        for s in range(e):
            if name == "pcnt_zero_and_full":
                c = [0, cap_p][s % 2]
            else:
                c = int(rng.integers(len(extra), cap_p + 1))
            drawn = _probes_from(rng, keys, (c - len(extra)) // 2)
            rows.append(np.concatenate([np.asarray(extra, kt), drawn,
                                        _random_keys(rng, width, cap_p)])[:c])
        build.append(keys)
        probe.append(rows)
    return build, probe


CASES = ["empty_shard", "full_row", "outside_span", "pad_key_in_prefix",
         "pad_key_in_tail_only", "duplicates", "pcnt_zero_and_full", "high_keys"]


@pytest.mark.parametrize("width", [32, 64])
@pytest.mark.parametrize("case", CASES)
def test_plain_version_matches_the_oracle(case, width):
    rng = np.random.default_rng(1000 + CASES.index(case) * 2 + width)
    build, probe = _case(case, width, rng)
    bkeys_s, bvals_s, bcnt, pkeys, pcnt = _sides(width, rng, build, probe)
    got, stats = tsort.probe_sorted(bkeys_s, bvals_s, bcnt, pkeys, pcnt, MISS)
    assert got.dtype == bvals_s.dtype and got.shape == (4, 4 * 24)
    assert stats.dtype == torch.int64 and stats.shape == (4, 2)
    np.testing.assert_array_equal(got.numpy(), _oracle(bkeys_s, bvals_s, pkeys, pcnt, MISS))
    assert stats[:, 0].tolist() == pcnt.sum(1).tolist() and stats[:, 1].tolist() == [0] * 4
    if case == "pad_key_in_tail_only":
        # the padding key finds a padding slot's payload, as the
        # composition always did, except in the full row, where it misses
        pad_rows = (tsort._bits(pkeys) == -1).view(4, -1) & (got != MISS)
        assert pad_rows[0].any() and not pad_rows[1].any()
    if case == "duplicates":
        assert (got != MISS).sum() > 20


def test_plain_version_is_the_composition_it_replaced():
    """``searchsorted`` over the whole row, the clamp, the gathers, the
    valid mask and the where, as ``HashJoin.step`` wrote them."""
    rng = np.random.default_rng(7)
    build, probe = _case("outside_span", 32, rng)
    bkeys_s, bvals_s, bcnt, pkeys, pcnt = _sides(32, rng, build, probe)
    e, cap_p = 4, 24
    pk = tsort._bits(pkeys).view(e, -1)
    pos = tsort.searchsorted(bkeys_s, pkeys.view(e, -1)).clamp_(max=bkeys_s.shape[1] - 1)
    pos = pos.to(torch.int64)
    col = torch.arange(cap_p, dtype=torch.int32)
    valid = (col[None, None, :] < pcnt[:, :, None]).view(e, -1)
    hit = (torch.gather(tsort._bits(bkeys_s), 1, pos) == pk) & valid
    want = torch.where(hit, torch.gather(bvals_s, 1, pos), MISS)
    got, _ = tsort.probe_sorted_reference(bkeys_s, bvals_s, bcnt, pkeys, pcnt, MISS)
    assert torch.equal(got, want)


# ----------------------------------------------------------------------
# the kernel's design, emulated through the launch's pointers
# ----------------------------------------------------------------------
class _FakeProbeLib:
    """``srt_sorted_probe`` / ``srt_sorted_probe64`` as
    ``csrc/sorted_probe.cu`` computes them: ``bits_of(m)``, each shard's
    span and shift, the directory entry by entry, each the lower bound of
    its bucket's first key in the valid keys (none for an empty shard),
    then for each valid slot the bucket's lower-bound search (its steps
    counted), the clamp, the compare and the payload. Records its
    arguments and each shard's directory (None where none is written);
    returns ``rc``."""

    SLOTS_PER_BUCKET_LOG = 2

    def __init__(self, rc=0):
        self.rc = rc
        self.calls = []
        self.dirs = []

    @classmethod
    def bits_of(cls, m):
        return max(m.bit_length() - 1 - cls.SLOTS_PER_BUCKET_LOG, 1)

    def srt_sorted_probe_scratch(self, e, m):
        return e * 8 + e * ((1 << self.bits_of(m)) + 1)

    def srt_error_string(self, rc):
        return b"invalid argument"

    def srt_sorted_probe(self, *args):
        return self._probe(32, args)

    def srt_sorted_probe64(self, *args):
        return self._probe(64, args)

    def _probe(self, width, args):
        self.calls.append(args)
        if self.rc:
            return self.rc
        bk_p, bv_p, bc_p, pk_p, pc_p, out_p, st_p, _scratch, e, m, cap_p, miss, _ = args
        kt = ctypes.c_uint32 if width == 32 else ctypes.c_uint64
        vt = ctypes.c_int32 if width == 32 else ctypes.c_int64

        def at(ptr, n, ctype):
            return np.ctypeslib.as_array((ctype * n).from_address(ptr))

        bkeys = at(bk_p, e * m, kt).reshape(e, m)
        bvals = at(bv_p, e * m, vt).reshape(e, m)
        bcnt = at(bc_p, e * e, ctypes.c_int32).reshape(e, e)
        pkeys = at(pk_p, e * e * cap_p, kt).reshape(e, e * cap_p)
        pcnt = at(pc_p, e * e, ctypes.c_int32).reshape(e, e)
        joined = at(out_p, e * e * cap_p, vt).reshape(e, e * cap_p)
        stats = at(st_p, 2 * e, ctypes.c_int64).reshape(e, 2)
        bits = self.bits_of(m)
        buckets = 1 << bits
        self.dirs = []
        for d in range(e):
            row = [int(k) for k in bkeys[d]]
            n = min(sum(max(int(c), 0) for c in bcnt[d]), m)
            lo, hi = (row[0], row[n - 1]) if n else (0, 0)
            shift = max(((hi - lo) % (1 << width)).bit_length() - bits, 0)

            def lower_bound(j):
                if j == buckets:
                    return n
                off = j << shift
                assert off < 1 << width  # the kernel's K holds it
                if off > hi - lo:
                    return n
                a, b = 0, n
                while a < b:
                    mid = (a + b) // 2
                    a, b = (mid + 1, b) if row[mid] < lo + off else (a, mid)
                return a

            directory = [lower_bound(j) for j in range(buckets + 1)] if n else None
            self.dirs.append(directory)
            probes = steps = 0
            for slot in range(e * cap_p):
                key = int(pkeys[d, slot])
                if not slot % cap_p < pcnt[d, slot // cap_p]:
                    joined[d, slot] = miss
                    continue
                probes += 1
                a = b = 0
                if n and key > hi:
                    a = b = n
                elif n and key >= lo:
                    j = ((key - lo) % (1 << width)) >> shift
                    a, b = directory[j], directory[j + 1]
                while a < b:
                    mid = (a + b) // 2
                    a, b = (mid + 1, b) if row[mid] < key else (a, mid)
                    steps += 1
                pos = min(a, m - 1)
                joined[d, slot] = bvals[d, pos] if row[pos] == key else miss
            stats[d] = probes, steps
        return 0


@pytest.fixture
def fake_probe(monkeypatch):
    lib = _FakeProbeLib()
    monkeypatch.setattr(tsort, "_probe_kernel_path", lambda bkeys_s: True)
    monkeypatch.setattr(_build, "_on_device",
                        lambda symbol, device: contextlib.nullcontext((lib, 79)))
    _build.reset_launch_counts()
    return lib


@pytest.mark.parametrize("width", [32, 64])
@pytest.mark.parametrize("case", CASES)
def test_kernel_design_matches_plain_version(case, width, fake_probe):
    rng = np.random.default_rng(2000 + CASES.index(case) * 2 + width)
    build, probe = _case(case, width, rng)
    args = _sides(width, rng, build, probe)
    got, stats = tsort.probe_sorted(*args, MISS)
    (call,) = fake_probe.calls
    assert call[0] == args[0].data_ptr() and call[5] == got.data_ptr()
    assert call[6] == stats.data_ptr() and call[8:] == (4, 64, 24, MISS, 79)
    symbol = "srt_sorted_probe" if width == 32 else "srt_sorted_probe64"
    assert _build.launches == {symbol: 1}
    assert torch.equal(got, tsort.probe_sorted_reference(*args, MISS)[0])
    assert stats[:, 0].tolist() == args[4].sum(1).tolist()
    assert [x is None for x in fake_probe.dirs] == [case == "empty_shard"] + [False] * 3


@pytest.mark.parametrize("width", [32, 64])
@pytest.mark.parametrize("spread", ["uniform", "one_bucket", "empty_shard", "on_starts"])
def test_directory_sizes_and_steps(spread, width, fake_probe):
    """A directory of 2^(floor(log2 M) - 2) buckets over the span of the
    valid keys, entry j the first key whose bucket is j or later: uniform
    keys take a few steps a probe; keys that share one bucket (a dense
    range and two far outliers) take a search of the whole row; an empty
    shard gets no directory; keys that equal buckets' first keys, each
    twice, tie with the entries' searches."""
    rng = np.random.default_rng(3000 + width)
    e, cap_b, cap_p = 2, 700, 300
    m = e * cap_b
    top = 1 << (width - 1)
    build, probe = [], []
    for d in range(e):
        if spread == "one_bucket":
            keys = np.concatenate([np.array([0, _pad(width) - 1], WIDTHS[width][0]),
                                   _random_keys(rng, width, m // 2 - 2, top, top + 64)])
        elif spread == "empty_shard" and d == 0:
            keys = _random_keys(rng, width, 0)
        elif spread == "on_starts":  # span 1,396: shift 3, every other key a first key
            keys = np.repeat(np.arange(d, d + 2800, 8, dtype=WIDTHS[width][0]), 2)
            keys[1::2] += np.asarray(4, keys.dtype)
            keys = np.repeat(keys, 2)[:m // 2]
        else:
            keys = _random_keys(rng, width, m // 2)
        build.append(keys)
        probe.append([_probes_from(rng, keys, cap_p) if len(keys) else
                      _random_keys(rng, width, cap_p) for _ in range(e)])
    args = _sides(width, rng, build, probe, e=e, cap_b=cap_b, cap_p=cap_p)
    got, stats = tsort.probe_sorted(*args, MISS)
    assert torch.equal(got, tsort.probe_sorted_reference(*args, MISS)[0])
    buckets = 2**8  # 1,400 slots: 2^(10 - 2)
    for d, directory in enumerate(fake_probe.dirs):
        keys = np.sort(build[d]).astype(object)
        if not len(keys):
            assert directory is None
            continue
        span = int(keys[-1] - keys[0])
        shift = max(span.bit_length() - 8, 0)
        bucket = [min(int(k - keys[0]) >> shift, buckets) for k in keys] + [buckets]
        assert span >> shift < buckets
        assert directory == [next(i for i, b in enumerate(bucket) if b >= j)
                             for j in range(buckets + 1)]
    assert stats[:, 0].tolist() == [e * cap_p] * e
    per_probe = stats[:, 1].sum().item() / (e * e * cap_p)
    if spread == "one_bucket":
        assert per_probe >= 8  # log2(700) = 9.5
    elif spread == "uniform":
        assert 1 <= per_probe <= 3  # ~2.7 keys a bucket
    elif spread == "on_starts":
        assert 1 <= per_probe <= 4  # 4 slots a bucket
    else:
        assert stats[0, 1] == 0 and 1 <= stats[1, 1] / (e * cap_p) <= 3


def test_nonzero_return_raises(fake_probe):
    fake_probe.rc = 1
    rng = np.random.default_rng(4)
    args = _sides(32, rng, *_case("duplicates", 32, rng))
    with pytest.raises(RuntimeError, match="srt_sorted_probe launch failed: invalid argument"):
        tsort.probe_sorted(*args, MISS)
    assert _build.launches["srt_sorted_probe"] == 0


BAD_PROBES = {
    "int32_keys": lambda a: (a[0].view(torch.int32), *a[1:4], a[4], MISS),
    "int64_vals": lambda a: (a[0], a[1].to(torch.int64), *a[2:5], MISS),
    "probe_dtype_differs": lambda a: (*a[:3], a[3].view(torch.int32), a[4], MISS),
    "one_dim": lambda a: (a[0][0], a[1][0], *a[2:5], MISS),
    "probe_two_dim": lambda a: (*a[:3], a[3].reshape(4, -1), a[4], MISS),
    "probe_shards_differ": lambda a: (*a[:3], a[3][:, :3].contiguous(), a[4], MISS),
    "int64_counts": lambda a: (*a[:2], a[2].to(torch.int64), *a[3:5], MISS),
    "counts_shape": lambda a: (*a[:4], a[4][:, :3].contiguous(), MISS),
    "non_contiguous": lambda a: (a[0].t().contiguous().t(), *a[1:5], MISS),
    "miss_too_wide": lambda a: (*a[:5], 1 << 31),
    "miss_too_low": lambda a: (*a[:5], -(1 << 31) - 1),
    "counts_on_another_device": lambda a: (*a[:4], a[4].to("meta"), MISS),
}


@pytest.mark.parametrize("bad", sorted(BAD_PROBES))
def test_rejects_before_launch(bad, fake_probe):
    rng = np.random.default_rng(5)
    args = _sides(32, rng, *_case("duplicates", 32, rng))
    with pytest.raises(ValueError):
        tsort.probe_sorted(*BAD_PROBES[bad](args))
    assert fake_probe.calls == [] and _build.launches["srt_sorted_probe"] == 0


@pytest.mark.parametrize("width", [32, 64])
def test_hashjoin_step_probes_once_and_join_counts(width, fake_probe, monkeypatch):
    """HashJoin.step's CUDA branch: one probe call a step, its outputs
    those of the plain path; ``join`` adds each step's counters to the
    registry."""
    from sparkrdma_tpu_torch.models.hashjoin import HashJoin
    from sparkrdma_tpu_torch.obs import get_registry
    from sparkrdma_tpu_torch.parallel.mesh import make_mesh

    kt, vt = WIDTHS[width][:2]
    e = 4
    rng = np.random.default_rng(44 + width)
    bk = (rng.permutation(e * 50).astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15)
          >> np.uint64(64 - width)).astype(kt)
    pk = np.concatenate([bk[rng.integers(0, len(bk), e * 60)], _random_keys(rng, width, 9)])
    bv, pv = np.arange(len(bk), dtype=vt), np.arange(len(pk), dtype=vt)
    join = HashJoin(make_mesh(["cpu"] * e))
    args, nb, npl = join.place(bk, bv, pk, pv)
    fn = join.step(nb, npl, 2 * nb // e, 2 * npl // e)
    got = fn(*args)
    symbol = "srt_sorted_probe" if width == 32 else "srt_sorted_probe64"
    assert _build.launches[symbol] == 1 and len(fake_probe.calls) == 1
    stats = join.last_probe_stats.clone()
    monkeypatch.setattr(tsort, "_probe_kernel_path", lambda bkeys_s: False)
    want = fn(*args)
    for a, b in zip(want, got):
        assert torch.equal(tsort._bits(a), tsort._bits(b))
    assert stats[:, 0].sum().item() == e * npl == int(want[3].sum())
    assert torch.equal(join.last_probe_stats[:, 0], stats[:, 0])

    reg = get_registry()
    before = (reg.counter("hashjoin.probes").value,
              reg.counter("hashjoin.probe_bucket_steps").value)
    rows = join.join(bk, bv, pk, pv)
    assert len(rows) == len(pk)
    probes = int(join.last_probe_stats[:, 0].sum())
    assert probes == e * npl
    assert (reg.counter("hashjoin.probes").value - before[0],
            reg.counter("hashjoin.probe_bucket_steps").value - before[1]) == (
                probes * len(join.last_capacities), 0)
