"""ops/sort.py of the port against the JAX package's, on the same numpy
inputs: uint32 keys at and above 2^31, the 0xFFFFFFFF sentinel, and
overflowing capacities. Every comparison is exact."""

import contextlib
import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparkrdma_tpu.ops import sort as jsort
from sparkrdma_tpu_torch.ops import _build
from sparkrdma_tpu_torch.ops import sort as tsort

torch.set_num_threads(1)

SENTINEL = 0xFFFFFFFF


def _keys(seed, n, high=True):
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 1 << 32, n, dtype=np.uint32)
    if high:
        # keys at and above 2^31 and the sentinel itself
        k[: min(n, 6)] = [0, (1 << 31) - 1, 1 << 31, (1 << 31) + 1,
                          SENTINEL, SENTINEL][: min(n, 6)]
    return k


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _eq(jax_out, torch_out):
    a, b = np.asarray(jax_out), _np(torch_out)
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    assert a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("shape", [(1,), (1000,), (4097,), (8, 300)])
@pytest.mark.parametrize("dtype", [np.uint32, np.int32, np.uint8])
def test_device_sort(shape, dtype):
    rng = np.random.default_rng(1)
    info = np.iinfo(dtype)
    x = rng.integers(info.min, int(info.max) + 1, shape, dtype=dtype)
    if dtype == np.uint32:
        flat = x.reshape(-1)
        flat[:6] = _keys(1, 6)[: flat.size]
    _eq(jsort.device_sort(jnp.asarray(x)), tsort.device_sort(torch.from_numpy(x)))


@pytest.mark.parametrize("side", ["left", "right"])
def test_searchsorted(side):
    keys = np.sort(_keys(2, 5000))
    q = np.concatenate([_keys(3, 100), keys[::97]])
    want = jnp.searchsorted(jnp.asarray(keys), jnp.asarray(q), side=side)
    got = tsort.searchsorted(torch.from_numpy(keys), torch.from_numpy(q), side=side)
    _eq(want, got)


@pytest.mark.parametrize("p", [1, 2, 8, 64])
def test_radix_partition(p):
    keys = _keys(4, 3000)
    _eq(jsort.radix_partition(jnp.asarray(keys), p),
        tsort.radix_partition(torch.from_numpy(keys), p))
    signed = np.random.default_rng(5).integers(-(1 << 31), 1 << 31, 3000,
                                               dtype=np.int32)
    _eq(jsort.radix_partition(jnp.asarray(signed), p),
        tsort.radix_partition(torch.from_numpy(signed), p))


def test_radix_partition_rejects_non_power_of_two():
    with pytest.raises(ValueError):
        tsort.radix_partition(torch.zeros(4, dtype=torch.int32), 3)


@pytest.mark.parametrize("capacity", [400, 64, 1])
@pytest.mark.parametrize("dtype", [np.uint32, np.int32])
def test_pack_by_partition(capacity, dtype):
    rng = np.random.default_rng(6)
    n, p = 1000, 8
    values = (_keys(6, n) if dtype == np.uint32
              else rng.integers(-(1 << 31), 1 << 31, n, dtype=np.int32))
    dest = rng.integers(0, p, n, dtype=np.int32)
    dest[:300] = 3  # one hot partition: overflows the small capacities
    fill = SENTINEL if dtype == np.uint32 else -7
    j = jsort.pack_by_partition(jnp.asarray(values), jnp.asarray(dest), p,
                                capacity, fill=fill)
    t = tsort.pack_by_partition(torch.from_numpy(values), torch.from_numpy(dest),
                                p, capacity, fill=fill)
    for a, b in zip(j, t):
        _eq(a, b)
    assert bool(t[2]) == (capacity < 300)


@pytest.mark.parametrize("p,capacity", [(2, 4000), (8, 1500), (8, 200)])
def test_split_sorted(p, capacity):
    keys = np.sort(_keys(7, 6000))
    j = jsort.split_sorted(jnp.asarray(keys), p, capacity, fill=SENTINEL)
    t = tsort.split_sorted(torch.from_numpy(keys), p, capacity, fill=SENTINEL)
    for a, b in zip(j, t):
        _eq(a, b)
    assert bool(t[2]) == (capacity == 200)


@pytest.mark.parametrize("capacity", [5000, 100])
def test_split_sorted_edges(capacity):
    rng = np.random.default_rng(8)
    # zipf-skewed keys, three partitions at sampled quantiles
    keys = np.sort(np.minimum(rng.zipf(1.3, 6000), SENTINEL).astype(np.uint32)
                   * np.uint32(2654435761 % (1 << 31)))
    edges = np.quantile(keys, [1 / 3, 2 / 3]).astype(np.uint32)
    j = jsort.split_sorted_edges(jnp.asarray(keys), jnp.asarray(edges),
                                 capacity, fill=SENTINEL)
    t = tsort.split_sorted_edges(torch.from_numpy(keys), torch.from_numpy(edges),
                                 capacity, fill=SENTINEL)
    for a, b in zip(j, t):
        _eq(a, b)


@pytest.mark.parametrize("dtype", [np.uint32, np.int32])
def test_merge_received(dtype):
    rng = np.random.default_rng(9)
    slab = (_keys(9, 4 * 700).reshape(4, 700) if dtype == np.uint32
            else rng.integers(-(1 << 31), 1 << 31, (4, 700), dtype=np.int32))
    counts = np.array([700, 0, 313, 1], np.int32)
    sentinel = SENTINEL if dtype == np.uint32 else (1 << 31) - 1
    j = jsort.merge_received(jnp.asarray(slab), jnp.asarray(counts), sentinel)
    t = tsort.merge_received(torch.from_numpy(slab), torch.from_numpy(counts),
                             sentinel)
    _eq(j[0], t[0])
    assert int(j[1]) == int(t[1]) == 1014
    assert t[1].dtype == torch.int32


# ----------------------------------------------------------------------
# radix_pack_pairs: the hash join's pack of a whole [E, n] stack
# ----------------------------------------------------------------------
PACK_N = 700
PACK_VAL_FILL = -7


def _pack_stack(e, p, seed, n=PACK_N):
    """[E, n] uint32 keys (the sentinel, keys at 2^31 and a hot
    partition: a third of each shard's rows in partition p // 2) and
    int32 payloads."""
    rng = np.random.default_rng(seed)
    keys = np.stack([_keys(seed + i, n) for i in range(e)])
    if p > 1:
        shift = 32 - (p.bit_length() - 1)
        hot = rng.random((e, n)) < 1 / 3
        keys[hot] = ((keys[hot] & ((1 << shift) - 1))
                     | np.uint32((p // 2) << shift)).astype(np.uint32)
    vals = rng.integers(-(1 << 31), 1 << 31, (e, n), dtype=np.int32)
    return keys, vals


def _jax_pack(keys, vals, p, cap):
    """The JAX package's radix_partition + two pack_by_partition calls,
    shard by shard."""
    cols = []
    for k, v in zip(keys, vals):
        dest = jsort.radix_partition(jnp.asarray(k), p)
        ks, counts, flag = jsort.pack_by_partition(jnp.asarray(k), dest, p, cap,
                                                   fill=SENTINEL)
        vs, vcounts, vflag = jsort.pack_by_partition(jnp.asarray(v), dest, p, cap,
                                                     fill=PACK_VAL_FILL)
        cols.append([np.asarray(x) for x in (ks, vs, counts, flag)])
    return [np.stack(c) for c in zip(*cols)]


def _largest_partition(keys, p):
    if p == 1:
        return keys.shape[1]
    top = keys >> np.uint32(32 - (p.bit_length() - 1))
    return max(int(np.bincount(row, minlength=p).max()) for row in top)


@pytest.mark.parametrize("cap_kind", ["roomy", "just_overflowing", "one"])
@pytest.mark.parametrize("p", [1, 2, 8, 256])
@pytest.mark.parametrize("e", [1, 2, 8])
def test_radix_pack_pairs_matches_jax(e, p, cap_kind):
    keys, vals = _pack_stack(e, p, seed=10 + e + p)
    largest = _largest_partition(keys, p)
    cap = {"roomy": PACK_N, "just_overflowing": largest - 1, "one": 1}[cap_kind]
    want = _jax_pack(keys, vals, p, cap)
    got = tsort.radix_pack_pairs(torch.from_numpy(keys), torch.from_numpy(vals), p,
                                 cap, key_fill=SENTINEL, val_fill=PACK_VAL_FILL)
    assert [g.dtype for g in got] == [torch.uint32, torch.int32, torch.int32,
                                     torch.bool]
    for name, a, b in zip(("kslab", "vslab", "counts", "overflowed"), want, got):
        assert a.dtype == b.numpy().dtype, name
        np.testing.assert_array_equal(a, b.numpy(), err_msg=name)
    assert got[3].any().item() == (cap < largest)


@pytest.mark.parametrize("p", [512, 1024])
def test_radix_pack_pairs_plain_takes_more_than_256_partitions(p):
    """The kernel's limit of 256 partitions does not bind the plain
    version: a CPU stack packs into any power of two, as
    pack_by_partition does."""
    keys, vals = _pack_stack(2, p, seed=50 + p, n=3 * p)
    cap = _largest_partition(keys, p) - 1
    want = _jax_pack(keys, vals, p, cap)
    got = tsort.radix_pack_pairs(torch.from_numpy(keys), torch.from_numpy(vals), p,
                                 cap, key_fill=SENTINEL, val_fill=PACK_VAL_FILL)
    for name, a, b in zip(("kslab", "vslab", "counts", "overflowed"), want, got):
        np.testing.assert_array_equal(a, b.numpy(), err_msg=name)
    assert got[3].any().item()


class _FakePackLib:
    """``srt_radix_pack`` that records its arguments and computes the
    plain version through the pointers it is given (so the argument
    order is checked end to end); returns ``rc``."""

    def __init__(self, rc=0):
        self.rc = rc
        self.calls = []

    def srt_radix_pack_scratch(self, e, n, p):
        return e * p * 3

    def srt_error_string(self, rc):
        return b"invalid argument"

    def srt_radix_pack(self, *args):
        self.calls.append(args)
        if self.rc:
            return self.rc
        (kp, vp, ksp, vsp, cp, fp, _scratch, e, n, p, key_bits, cap, key_fill,
         val_fill, _stream) = args

        def at(ptr, shape, dtype):
            count = int(np.prod(shape))
            raw = (ctypes.c_uint8 * (count * torch.empty((), dtype=dtype).element_size())
                   ).from_address(ptr)
            return torch.frombuffer(raw, dtype=dtype, count=count).view(shape)

        keys = at(kp, (e, n), torch.int32).view(torch.uint32)
        want = tsort.radix_pack_pairs_reference(
            keys, at(vp, (e, n), torch.int32), p, cap, key_bits,
            key_fill & 0xFFFFFFFF, val_fill)
        for ptr, w in zip((ksp, vsp, cp, fp), want):
            at(ptr, w.shape, w.dtype).copy_(w)
        return 0


@pytest.fixture
def fake_pack(monkeypatch):
    lib = _FakePackLib()
    monkeypatch.setattr(tsort, "_pack_kernel_path", lambda keys: True)
    monkeypatch.setattr(_build, "_on_device",
                        lambda symbol, device: contextlib.nullcontext((lib, 77)))
    _build.reset_launch_counts()
    return lib


def test_radix_pack_launch_arguments(fake_pack):
    e, n, p, cap = 4, 300, 8, 60
    keys, vals = _pack_stack(e, p, seed=40, n=n)
    k, v = torch.from_numpy(keys), torch.from_numpy(vals)
    got = tsort.radix_pack_pairs(k, v, p, cap, key_fill=SENTINEL, val_fill=PACK_VAL_FILL)
    (args,) = fake_pack.calls
    assert args[0] == k.data_ptr() and args[1] == v.data_ptr()
    assert args[2] == got[0].data_ptr() and args[3] == got[1].data_ptr()
    assert args[4] == got[2].data_ptr() and args[5] == got[3].data_ptr()
    assert all(isinstance(a, int) and a > 0 for a in args[:7])
    # the fill as its int32 bits, and the stream last
    assert args[7:] == (e, n, p, 32, cap, -1, PACK_VAL_FILL, 77)
    want = tsort.radix_pack_pairs_reference(k, v, p, cap, 32, SENTINEL, PACK_VAL_FILL)
    for a, b in zip(want, got):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert _build.launches["srt_radix_pack"] == 1


def test_radix_pack_nonzero_return_raises(fake_pack):
    fake_pack.rc = 1
    keys, vals = _pack_stack(2, 8, seed=41, n=50)
    with pytest.raises(RuntimeError, match="srt_radix_pack launch failed: invalid argument"):
        tsort.radix_pack_pairs(torch.from_numpy(keys), torch.from_numpy(vals), 8, 20)
    assert _build.launches["srt_radix_pack"] == 0


BAD_PACKS = {
    "int32_keys": lambda k, v: (k.view(torch.int32), v, 8, 20),
    "int64_vals": lambda k, v: (k, v.to(torch.int64), 8, 20),
    "one_dim": lambda k, v: (k[0], v[0], 8, 20),
    "shapes_differ": lambda k, v: (k, v[:, :-1].contiguous(), 8, 20),
    "non_contiguous": lambda k, v: (k.t().contiguous().t(), v, 8, 20),
    "p_not_power_of_two": lambda k, v: (k, v, 6, 20),
    "p_above_256": lambda k, v: (k, v, 512, 20),
    "zero_capacity": lambda k, v: (k, v, 8, 0),
}


@pytest.mark.parametrize("bad", sorted(BAD_PACKS))
def test_radix_pack_rejects_before_launch(bad, fake_pack):
    keys, vals = _pack_stack(2, 8, seed=42, n=50)
    args = BAD_PACKS[bad](torch.from_numpy(keys), torch.from_numpy(vals))
    with pytest.raises(ValueError):
        tsort.radix_pack_pairs(*args)
    assert fake_pack.calls == [] and _build.launches["srt_radix_pack"] == 0


def test_hashjoin_step_packs_once_a_side(fake_pack, monkeypatch):
    """HashJoin.step's CUDA branch: one srt_radix_pack call a side, and
    the step's outputs those of the plain path."""
    from sparkrdma_tpu_torch.models.hashjoin import HashJoin
    from sparkrdma_tpu_torch.parallel.mesh import make_mesh

    e = 4
    rng = np.random.default_rng(43)
    bk = (rng.permutation(e * 200).astype(np.uint64) * 0x9E3779B1 % 2**32).astype(np.uint32)
    pk = bk[rng.integers(0, len(bk), e * 300)]
    join = HashJoin(make_mesh(["cpu"] * e))
    args, nb, npl = join.place(bk, np.arange(len(bk), dtype=np.int32),
                               pk, np.arange(len(pk), dtype=np.int32))
    fn = join.step(nb, npl, 2 * nb // e, 2 * npl // e)
    got = fn(*args)
    assert _build.launches["srt_radix_pack"] == 2 and len(fake_pack.calls) == 2
    assert [c[7:12] for c in fake_pack.calls] == [(e, nb, e, 32, 2 * nb // e),
                                                  (e, npl, e, 32, 2 * npl // e)]
    monkeypatch.setattr(tsort, "_pack_kernel_path", lambda keys: False)
    want = fn(*args)
    for a, b in zip(want, got):
        assert torch.equal(a, b)


# ----------------------------------------------------------------------
# merge_sorted_runs: the SPMD sort's merge of [E, R, cap] sorted runs
# ----------------------------------------------------------------------
RUN_CAP = 40


def _runs(e, r, kind, seed, cap=RUN_CAP):
    """A uint32 ``[E, R, cap]`` slab whose rows are ascending in their
    first ``counts`` slots, and those int32 ``[E, R]`` counts: ragged,
    with 0 and ``cap`` among them; the slots past a count hold random
    keys, not the sentinel. ``kind``: ``ragged`` (uniform keys, 0, 2^31
    and the sentinel among them), ``equal`` (one key everywhere) or
    ``extremes`` (only 0 and 0xFFFFFFFF)."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, cap + 1, (e, r)).astype(np.int32)
    counts.flat[0] = cap
    if counts.size > 1:
        counts.flat[1] = 0
    slab = rng.integers(0, 1 << 32, (e, r, cap), dtype=np.uint32)
    for i in range(e):
        for j in range(r):
            c = counts[i, j]
            if kind == "ragged":
                run = _keys(seed + i * r + j, c)
            elif kind == "equal":
                run = np.full(c, 0x9E3779B1, np.uint32)
            else:
                run = rng.choice(np.array([0, SENTINEL], np.uint32), c)
            slab[i, j, :c] = np.sort(run)
    return slab, counts


def _jax_merge(slab, counts):
    """The JAX package's merge_received, shard by shard."""
    got = [jsort.merge_received(jnp.asarray(s), jnp.asarray(c), SENTINEL)
           for s, c in zip(slab, counts)]
    return (np.stack([np.asarray(m) for m, _ in got]),
            np.array([int(t) for _, t in got], np.int32))


@pytest.mark.parametrize("kind", ["ragged", "equal", "extremes"])
@pytest.mark.parametrize("e,r", [(1, 1), (2, 2), (3, 5), (4, 4), (8, 8), (2, 16)])
def test_merge_sorted_runs_matches_jax(e, r, kind):
    slab, counts = _runs(e, r, kind, seed=60 + 7 * e + r)
    want_merged, want_totals = _jax_merge(slab, counts)
    before = slab.copy()
    merged, totals = tsort.merge_sorted_runs(torch.from_numpy(slab),
                                             torch.from_numpy(counts), SENTINEL)
    assert merged.dtype == torch.uint32 and merged.shape == (e, r * RUN_CAP)
    assert totals.dtype == torch.int32 and totals.shape == (e,)
    np.testing.assert_array_equal(want_merged, merged.numpy())
    np.testing.assert_array_equal(want_totals, totals.numpy())
    np.testing.assert_array_equal(before, slab)  # the plain version reads only


class _FakeMergeLib:
    """``srt_merge_runs`` as ``csrc/merge_runs.cu`` computes it, through
    the pointers it is given, at a small tile (``THREADS`` x ``ITEMS``
    outputs): the clamped counts' prefix, then each pass's merge-path
    split of every tile and every thread's merge, ping-ponging between
    the slab and ``merged``. Records its arguments; returns ``rc``."""

    THREADS, ITEMS = 4, 3
    TILE = THREADS * ITEMS

    def __init__(self, rc=0):
        self.rc = rc
        self.calls = []

    @staticmethod
    def passes(r):
        p = max(0, (r - 1).bit_length())
        return p if p % 2 else p + 1

    def tiles(self, w, r, cap):
        return -(-min(w, r) * cap // self.TILE)

    def srt_merge_runs_scratch(self, e, r, cap):
        parts = max(-(-r // 2**p) * (self.tiles(2**p, r, cap) + 1)
                    for p in range(1, self.passes(r) + 1))
        return e * (r + 1) + e * parts

    def srt_error_string(self, rc):
        return b"invalid argument"

    @staticmethod
    def _path(a, b, diag):
        lo, hi = max(0, diag - len(b)), min(diag, len(a))
        while lo < hi:
            mid = (lo + hi) // 2
            if a[mid] <= b[diag - 1 - mid]:
                lo = mid + 1
            else:
                hi = mid
        return lo

    def _tile(self, keys, na):
        n = len(keys)
        out = np.empty_like(keys)
        for t in range(self.THREADS):
            diag = min(t * self.ITEMS, n)
            ai = self._path(keys[:na], keys[na:], diag)
            bi = na + diag - ai
            for j in range(min(self.ITEMS, n - diag)):
                take_a = bi >= n or (ai < na and keys[ai] <= keys[bi])
                out[diag + j] = keys[ai] if take_a else keys[bi]
                ai, bi = (ai + 1, bi) if take_a else (ai, bi + 1)
        return out

    def srt_merge_runs(self, *args):
        self.calls.append(args)
        if self.rc:
            return self.rc
        slab_p, counts_p, merged_p, totals_p, _scratch, e, r, cap, sentinel, _ = args

        def at(ptr, n, ctype):
            return np.ctypeslib.as_array((ctype * n).from_address(ptr))

        row = r * cap
        bufs = [at(slab_p, e * row, ctypes.c_uint32).reshape(e, row),
                at(merged_p, e * row, ctypes.c_uint32).reshape(e, row)]
        counts = np.clip(at(counts_p, e * r, ctypes.c_int32).reshape(e, r), 0, cap)
        pre = np.concatenate([np.zeros((e, 1), np.int64), np.cumsum(counts, 1)], 1)
        totals = at(totals_p, e, ctypes.c_int32)
        tile = self.TILE
        for p in range(1, self.passes(r) + 1):
            src, dst = bufs[(p + 1) % 2], bufs[p % 2]
            w, last = 2**p, p == self.passes(r)
            for s in range(e):
                for g in range(-(-r // w)):
                    lo, mid, hi = g * w, min(r, g * w + w // 2), min(r, g * w + w)
                    na, nb = pre[s, mid] - pre[s, lo], pre[s, hi] - pre[s, mid]
                    a = src[s, lo * cap:lo * cap + na].copy()
                    b = src[s, mid * cap:mid * cap + nb].copy()
                    n = na + nb
                    tiles = self.tiles(w, r, cap)
                    parts = [self._path(a, b, min(k * tile, n)) for k in range(tiles + 1)]
                    out = dst[s, lo * cap:]
                    for k in range(tiles):
                        d0 = k * tile
                        end = min(d0 + tile, row) if last else d0
                        if d0 < n:
                            size = min(tile, n - d0)
                            a0, a1 = parts[k], parts[k + 1]
                            keys = np.concatenate([a[a0:a1], b[d0 - a0:d0 - a0 + size - (a1 - a0)]])
                            out[d0:d0 + size] = self._tile(keys, a1 - a0)
                            d0 += size
                        out[d0:end] = sentinel
                    if last:
                        totals[s] = n
        return 0


@pytest.fixture
def fake_merge(monkeypatch):
    lib = _FakeMergeLib()
    monkeypatch.setattr(tsort, "_merge_kernel_path", lambda slab: True)
    monkeypatch.setattr(_build, "_on_device",
                        lambda symbol, device: contextlib.nullcontext((lib, 78)))
    _build.reset_launch_counts()
    return lib


@pytest.mark.parametrize("e,r", [(1, 1), (2, 2), (3, 5), (4, 4), (8, 8), (2, 16)])
def test_merge_runs_kernel_design_matches_plain_version(e, r, fake_merge):
    """The kernel's passes, tiles and per-thread merges (emulated through
    the launch's pointers) give the plain version's bytes; the slab is
    the scratch of more than two runs."""
    slab, counts = _runs(e, r, "ragged", seed=70 + e + r)
    want = tsort.merge_sorted_runs_reference(torch.from_numpy(slab.copy()),
                                             torch.from_numpy(counts), SENTINEL)
    s, c = torch.from_numpy(slab), torch.from_numpy(counts)
    got = tsort.merge_sorted_runs(s, c, SENTINEL)
    (args,) = fake_merge.calls
    assert args[0] == s.data_ptr() and args[1] == c.data_ptr()
    assert args[2] == got[0].data_ptr() and args[3] == got[1].data_ptr()
    assert all(isinstance(a, int) and a > 0 for a in args[:5])
    assert args[5:] == (e, r, RUN_CAP, SENTINEL, 78)
    for a, b in zip(want, got):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert _build.launches["srt_merge_runs"] == 1


def test_merge_runs_nonzero_return_raises(fake_merge):
    fake_merge.rc = 1
    slab, counts = _runs(2, 2, "ragged", seed=80)
    with pytest.raises(RuntimeError, match="srt_merge_runs launch failed: invalid argument"):
        tsort.merge_sorted_runs(torch.from_numpy(slab), torch.from_numpy(counts), SENTINEL)
    assert _build.launches["srt_merge_runs"] == 0


BAD_MERGES = {
    "int32_slab": lambda s, c: (s.view(torch.int32), c, SENTINEL),
    "two_dim": lambda s, c: (s[0], c, SENTINEL),
    "int64_counts": lambda s, c: (s, c.to(torch.int64), SENTINEL),
    "counts_shape": lambda s, c: (s, c[:, :-1].contiguous(), SENTINEL),
    "non_contiguous": lambda s, c: (s.transpose(0, 1).contiguous().transpose(0, 1), c,
                                    SENTINEL),
    "sentinel_not_max": lambda s, c: (s, c, 0),
    "empty": lambda s, c: (s[:, :, :0], c, SENTINEL),
    "runs_above_1024": lambda s, c: (torch.zeros((1, 1025, 1), dtype=torch.uint32),
                                     torch.zeros((1, 1025), dtype=torch.int32), SENTINEL),
}


@pytest.mark.parametrize("bad", sorted(BAD_MERGES))
def test_merge_runs_rejects_before_launch(bad, fake_merge):
    slab, counts = _runs(2, 3, "ragged", seed=81)
    args = BAD_MERGES[bad](torch.from_numpy(slab), torch.from_numpy(counts))
    with pytest.raises(ValueError):
        tsort.merge_sorted_runs(*args)
    assert fake_merge.calls == [] and _build.launches["srt_merge_runs"] == 0


def test_merge_runs_plain_version_takes_more_than_1024_runs():
    """The kernel's limit of 1024 runs a shard does not bind the plain
    version."""
    slab, counts = _runs(1, 1030, "ragged", seed=82, cap=2)
    want_merged, want_totals = _jax_merge(slab, counts)
    merged, totals = tsort.merge_sorted_runs(torch.from_numpy(slab),
                                             torch.from_numpy(counts), SENTINEL)
    np.testing.assert_array_equal(want_merged, merged.numpy())
    np.testing.assert_array_equal(want_totals, totals.numpy())


@pytest.mark.parametrize("adaptive", [False, True])
def test_terasorter_step_merges_once_a_stage(adaptive, fake_merge, monkeypatch):
    """TeraSorter.step's CUDA branch: one srt_merge_runs call a stage over
    all shards' received runs, and the step's outputs those of the plain
    path."""
    from sparkrdma_tpu_torch.models.terasort import TeraSorter
    from sparkrdma_tpu_torch.parallel.mesh import make_mesh

    e, n_local = 4, 300
    keys = torch.from_numpy(_keys(83, e * n_local))
    edges = torch.from_numpy(np.sort(_keys(84, e - 1, high=False)))
    sorter = TeraSorter(make_mesh(["cpu"] * e))
    fn = sorter.step(n_local, adaptive=adaptive)
    args = (keys, edges) if adaptive else (keys,)
    got = [fn(*args) for _ in range(2)]
    assert _build.launches["srt_merge_runs"] == 2
    assert [c[5:8] for c in fake_merge.calls] == [(e, e, sorter.default_capacity(n_local))] * 2
    monkeypatch.setattr(tsort, "_merge_kernel_path", lambda slab: False)
    want = fn(*args)
    for g in got:
        for a, b in zip(want, g):
            assert a.dtype == b.dtype and torch.equal(a, b)
