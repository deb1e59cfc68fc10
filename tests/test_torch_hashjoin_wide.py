"""HashJoin at 8-byte rows (uint64 keys, int64 payloads) on the CPU.

The step against the plain reference of the benchmark's wide join cell
(``shufflebench/reference/equi_join_wide.py``, plain PyTorch that imports
nothing of the program) on 1, 2 and 8 shards: misses, a probe side that
is no multiple of E, keys with the top bit set, a capacity that
overflows; ``join()``'s rows against the same reference. Then the pieces
the wide step stands on: ``radix_pack_pairs`` at 64 bits against a numpy
pack (and its CUDA branch through a fake library), ``place()`` keeping
uint64 keys at 64 bits and refusing mixed widths, the unsigned order of
``device_sort`` / ``device_argsort`` / ``searchsorted`` above 2^63, and
the exchange counting 8 bytes an element."""

import contextlib
import ctypes

import numpy as np
import pytest
import torch

from shufflebench.reference import equi_join_wide as ref
from sparkrdma_tpu_torch.models.hashjoin import HashJoin
from sparkrdma_tpu_torch.obs import get_registry
from sparkrdma_tpu_torch.ops import _build
from sparkrdma_tpu_torch.ops import sort as tsort
from sparkrdma_tpu_torch.ops.exchange import ExchangeProgram
from sparkrdma_tpu_torch.parallel import make_mesh

torch.set_num_threads(1)

PAD = (1 << 64) - 1
MIX = 0x9E3779B97F4A7C15  # the 64-bit Fibonacci bijection
MISS = -1


def _tables(n_build, n_probe, seed, miss_share=0.1):
    """Unique build keys ``i * MIX mod 2^64`` (half of them at or above
    2^63), each probed about n_probe / n_build times; ``miss_share`` of
    the probes draw keys no build row holds."""
    rng = np.random.default_rng(seed)
    bk = (rng.permutation(n_build).astype(np.uint64) + np.uint64(1)) * np.uint64(MIX)
    pk = bk[rng.integers(0, n_build, n_probe)]
    miss = rng.random(n_probe) < miss_share
    pk[miss] = (rng.integers(n_build + 1, 1 << 40, int(miss.sum())).astype(np.uint64)
                * np.uint64(MIX))
    bv = rng.integers(-(1 << 62), 1 << 62, n_build, dtype=np.int64)
    return bk, bv, pk, np.arange(n_probe, dtype=np.int64)


def _inputs(tables):
    bk, bv, pk, pv = tables
    return {"build_keys": torch.from_numpy(bk.view(np.int64)).view(torch.uint64),
            "build_vals": torch.from_numpy(bv),
            "probe_keys": torch.from_numpy(pk.view(np.int64)).view(torch.uint64),
            "probe_vals": torch.from_numpy(pv)}


# name: (E, |R|, |S|, capacity factor, whether the first step overflows)
CASES = {
    "one_shard": (1, 300, 4000, 2.0, False),
    "two_shards_padded": (2, 301, 4001, 2.0, False),
    "eight_shards_padded": (8, 1000, 16_003, 2.0, False),
    "eight_shards_overflowing": (8, 1000, 16_000, 1.0, True),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_wide_step_matches_the_reference(name):
    e, nb_rows, np_rows, factor, overflows = CASES[name]
    tables = _tables(nb_rows, np_rows, seed=len(name))
    assert (tables[0] >= np.uint64(1 << 63)).any() and (tables[0] < np.uint64(1 << 63)).any()
    join = HashJoin(make_mesh(["cpu"] * e), capacity_factor=factor, miss_value=MISS)
    args, nb, npl = join.place(*tables)
    assert [a.dtype for a in args] == [torch.uint64, torch.int64] * 2
    cap_b = max(8, int(-(-nb // e) * factor))
    cap_p = max(8, int(-(-npl // e) * factor))
    pk2, pv2, joined, pcnt, overflow = join.step(nb, npl, cap_b, cap_p)(*args)
    assert (pk2.dtype, pv2.dtype, joined.dtype) == (torch.uint64, torch.int64, torch.int64)
    assert bool(overflow) == overflows
    config = {"shards": e, "miss_value": MISS}
    numbers, bad = ref.compare({"pk2": pk2, "pv2": pv2, "joined": joined, "pcnt": pcnt},
                               [pcnt.tolist()], _inputs(tables), config)
    if overflows:
        assert numbers["row_mismatch"] > 0 and bad
        return
    assert numbers == {"count_mismatch": 0, "row_mismatch": 0} and bad == 0
    assert int((joined == MISS).sum()) > 0  # the misses, and the padding rows


def _reference_rows(tables, e):
    """The reference's rows in ``join()``'s order (destination shard,
    source shard, slot), the padding key dropped."""
    by = {}
    for s, _, rows in ref.expected(_inputs(tables), {"shards": e, "miss_value": MISS},
                                   ref.Lookup(_inputs(tables), MISS)):
        for d, cols in enumerate(rows):
            by[d, s] = torch.stack(cols, dim=1)
    out = torch.cat([by[d, s] for d in range(e) for s in range(e)])
    return out[out[:, 0] != -1].numpy()


@pytest.mark.parametrize("e,factor", [(1, 2.0), (2, 2.0), (8, 2.0), (8, 0.3)])
def test_wide_join_rows_match_the_reference(e, factor):
    tables = _tables(500, 6001, seed=e)
    join = HashJoin(make_mesh(["cpu"] * e), capacity_factor=factor)
    out = join.join(*tables)
    assert out.dtype == np.int64 and out.shape == (6001, 3)
    np.testing.assert_array_equal(out, _reference_rows(tables, e))
    assert (len(join.last_capacities) > 1) == (factor < 1)
    # the key column is the uint64 key's bit pattern
    assert (tables[2][out[:, 1]] == out[:, 0].view(np.uint64)).all()


def _halves_tables(e, seed):
    """Build keys in threes that share a half: ``k``, ``k ^ 2^40`` (the
    low 32 bits the same) and ``k ^ 1`` (the top 32 bits the same), all
    three on one shard; the probes draw from them and miss on ``k ^ 2^20``
    and ``k ^ 2^50``, which share a half with a build key too."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 1 << 63, 300, dtype=np.int64).astype(np.uint64) << np.uint64(1)
    base[::2] |= np.uint64(1 << 63)
    bk = np.concatenate([base, base ^ np.uint64(1 << 40), base ^ np.uint64(1)])
    bk = bk[rng.permutation(len(bk))]
    misses = np.concatenate([base ^ np.uint64(1 << 20), base ^ np.uint64(1 << 50)])
    pool = np.concatenate([bk, misses])
    pk = pool[rng.integers(0, len(pool), 40 * e + 3)]
    bv = rng.integers(-(1 << 62), 1 << 62, len(bk), dtype=np.int64)
    return bk, bv, pk, np.arange(len(pk), dtype=np.int64)


@pytest.mark.parametrize("e", [1, 2, 8])
def test_wide_step_tells_keys_apart_by_both_halves(e):
    tables = _halves_tables(e, seed=100 + e)
    join = HashJoin(make_mesh(["cpu"] * e), miss_value=MISS)
    args, nb, npl = join.place(*tables)
    pk2, pv2, joined, pcnt, overflow = join.step(nb, npl, 4 * nb // e + 8,
                                                 4 * npl // e + 8)(*args)
    assert not bool(overflow)
    config = {"shards": e, "miss_value": MISS}
    inputs = _inputs(tables)
    judged = {"pk2": pk2, "pv2": pv2, "joined": joined, "pcnt": pcnt}
    assert ref.compare(judged, [pcnt.tolist()], inputs, config) == (
        {"count_mismatch": 0, "row_mismatch": 0}, 0)
    assert int((joined == MISS).sum()) > 0
    # a join on either half alone answers these probes wrongly
    for half in (lambda k: k >> 32, lambda k: k & 0xFFFFFFFF):
        cut = {k: (half(v.view(torch.int64)).view(torch.uint64) if "keys" in k else v)
               for k, v in inputs.items()}
        lookup = ref.Lookup(cut, MISS)
        want = ref.Lookup(inputs, MISS)(inputs["probe_keys"].view(torch.int64))
        got = lookup(half(inputs["probe_keys"].view(torch.int64)))
        assert int((got != want).sum()) > 0


def test_one_step_runs_both_widths():
    """One cached step joins uint32 keys with int32 payloads and uint64
    keys with int64 ones: keys ``k`` and ``k << 32`` land on the same
    shard in the same order, so the two joins agree slot for slot."""
    e, rng = 2, np.random.default_rng(114)
    bk = rng.choice(0xFFFFFFFF, 200, replace=False).astype(np.uint32)
    pk = np.concatenate([bk, rng.integers(0, 0xFFFFFFFF, 100).astype(np.uint32)])
    pk = pk[rng.permutation(len(pk))]
    bv = rng.integers(-(1 << 30), 1 << 30, len(bk)).astype(np.int32)
    pv = np.arange(len(pk), dtype=np.int32)
    join = HashJoin(make_mesh(["cpu"] * e))
    narrow_args, nb, npl = join.place(bk, bv, pk, pv)
    wide_args, nb2, npl2 = join.place(bk.astype(np.uint64) << np.uint64(32),
                                      bv.astype(np.int64), pk.astype(np.uint64) << np.uint64(32),
                                      pv.astype(np.int64))
    assert (nb, npl) == (nb2, npl2)
    fn = join.step(nb, npl, nb, npl)
    assert join.step(nb, npl, nb, npl) is fn
    narrow, wide = fn(*narrow_args), fn(*wide_args)
    assert [t.dtype for t in narrow[:3]] == [torch.uint32, torch.int32, torch.int32]
    assert [t.dtype for t in wide[:3]] == [torch.uint64, torch.int64, torch.int64]
    assert torch.equal(narrow[3], wide[3]) and not bool(narrow[4]) and not bool(wide[4])
    assert torch.equal(narrow[0].view(torch.int32).to(torch.int64) & 0xFFFFFFFF,
                       (wide[0].view(torch.int64) >> 32) & 0xFFFFFFFF)
    for a, b in zip(narrow[1:3], wide[1:3]):
        assert torch.equal(a.to(torch.int64), b)
    keys = torch.zeros(2 * nb, dtype=torch.uint64)
    with pytest.raises(ValueError, match="step built for"):  # payloads a width down
        fn(keys, torch.zeros(2 * nb, dtype=torch.int32), torch.zeros(2 * npl, dtype=torch.uint64),
           torch.zeros(2 * npl, dtype=torch.int32))
    with pytest.raises(ValueError, match="uint32 or uint64"):
        fn(keys.view(torch.int64), keys.view(torch.int64), keys, keys.view(torch.int64))


# ----------------------------------------------------------------------
# place(): 64 bits kept, mixed widths refused
# ----------------------------------------------------------------------
def test_place_keeps_uint64_keys_at_64_bits():
    bk, bv, pk, pv = _tables(100, 203, seed=3)
    join = HashJoin(make_mesh(["cpu"] * 4))
    (gbk, gbv, gpk, gpv), nb, npl = join.place(bk, bv, pk, pv)
    assert (nb, npl) == (25, 51)
    assert gbk.dtype == gpk.dtype == torch.uint64 and gbv.dtype == gpv.dtype == torch.int64
    np.testing.assert_array_equal(gbk.view(torch.int64).numpy().view(np.uint64)[:100], bk)
    np.testing.assert_array_equal(gpk.view(torch.int64).numpy()[203:], [-1])  # the padding
    np.testing.assert_array_equal(gpv.numpy(), np.append(pv, MISS))
    np.testing.assert_array_equal(gbv.numpy(), bv)


MIXED = {
    "uint64_keys_int32_payloads": lambda bk, bv, pk, pv: (bk, bv.astype(np.int32),
                                                          pk, pv.astype(np.int32)),
    "wide_build_narrow_probe": lambda bk, bv, pk, pv: (bk, bv, pk.astype(np.uint32),
                                                       pv.astype(np.int32)),
    "narrow_build_wide_probe": lambda bk, bv, pk, pv: (bk.astype(np.uint32), bv, pk, pv),
    "one_payload_narrow": lambda bk, bv, pk, pv: (bk, bv, pk, pv.astype(np.int32)),
}


@pytest.mark.parametrize("case", sorted(MIXED))
def test_place_refuses_mixed_widths(case):
    join = HashJoin(make_mesh(["cpu"] * 2))
    with pytest.raises(ValueError, match="uint64 keys with int64 payloads"):
        join.place(*MIXED[case](*_tables(10, 20, seed=4)))


def test_narrow_inputs_are_cast_as_before():
    join = HashJoin(make_mesh(["cpu"] * 2))
    args, _, _ = join.place(np.arange(4, dtype=np.int64), np.arange(4, dtype=np.int64),
                            np.arange(6, dtype=np.uint32), np.arange(6, dtype=np.int64))
    assert [a.dtype for a in args] == [torch.uint32, torch.int32] * 2


# ----------------------------------------------------------------------
# unsigned 64-bit order
# ----------------------------------------------------------------------
def _u64(seed, n):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, np.iinfo(np.uint64).max, n, dtype=np.uint64, endpoint=True)
    x[:6] = [0, (1 << 63) - 1, 1 << 63, (1 << 63) + 1, PAD, PAD]
    return x


def _t(x):
    return torch.from_numpy(x.view(np.int64)).view(torch.uint64)


def test_uint64_order_above_2_63():
    x = _u64(5, 3001)
    order = tsort.device_argsort(_t(x))
    np.testing.assert_array_equal(order.numpy(), np.argsort(x, kind="stable"))
    got = tsort.device_sort(_t(x))
    assert got.dtype == torch.uint64
    np.testing.assert_array_equal(got.view(torch.int64).numpy().view(np.uint64), np.sort(x))
    keys = np.sort(_u64(6, 5000))
    q = np.concatenate([_u64(7, 200), keys[::37]])
    for side in ("left", "right"):
        pos = tsort.searchsorted(_t(keys), _t(q), side=side)
        assert pos.dtype == torch.int32
        np.testing.assert_array_equal(pos.numpy(), np.searchsorted(keys, q, side=side))


def test_radix_partition_takes_the_top_bits_of_64():
    x = _u64(8, 1000)
    for p in (1, 2, 8, 256):
        shift = 64 - (p.bit_length() - 1)
        want = (x >> np.uint64(shift)).astype(np.int32) if p > 1 else np.zeros(1000, np.int32)
        got = tsort.radix_partition(_t(x), p, 64)
        np.testing.assert_array_equal(got.numpy(), want)


# ----------------------------------------------------------------------
# radix_pack_pairs at 64 bits
# ----------------------------------------------------------------------
def _np_pack(keys, vals, p, cap, key_bits, key_fill, val_fill):
    """numpy, shard by shard: a stable sort of the destinations, each
    partition's rows in input order, an overflowing partition's last
    row in its last slot."""
    e, _ = keys.shape
    ks = np.full((e, p, cap), key_fill, np.uint64)
    vs = np.full((e, p, cap), val_fill, np.int64)
    counts = np.zeros((e, p), np.int32)
    flags = np.zeros(e, bool)
    lg = p.bit_length() - 1
    for i in range(e):
        dest = (keys[i] >> np.uint64(key_bits - lg)) % np.uint64(p) if lg else \
            np.zeros(keys.shape[1], np.uint64)
        for d in range(p):
            rows = np.flatnonzero(dest == d)
            if len(rows) > cap:
                flags[i] = True
                rows = np.append(rows[:cap - 1], rows[-1])
            ks[i, d, :len(rows)], vs[i, d, :len(rows)] = keys[i, rows], vals[i, rows]
            counts[i, d] = len(rows)
    return ks, vs, counts, flags


def _stack(e, n, p, seed, key_bits=64):
    rng = np.random.default_rng(seed)
    keys = np.stack([_u64(seed + i, n) for i in range(e)])
    if key_bits < 64:
        keys &= np.uint64((1 << key_bits) - 1)
    if p > 1:  # a hot partition: a third of each shard's rows in p // 2
        shift = np.uint64(key_bits - (p.bit_length() - 1))
        hot = rng.random((e, n)) < 1 / 3
        keys[hot] = (keys[hot] & ((np.uint64(1) << shift) - np.uint64(1))) | \
            (np.uint64(p // 2) << shift)
    vals = rng.integers(-(1 << 63), (1 << 63) - 1, (e, n), dtype=np.int64)
    return keys, vals


@pytest.mark.parametrize("cap_kind", ["roomy", "overflowing", "one"])
@pytest.mark.parametrize("p", [1, 2, 8, 256])
@pytest.mark.parametrize("e", [1, 2, 8])
def test_radix_pack_pairs_64_matches_numpy(e, p, cap_kind):
    keys, vals = _stack(e, 700, p, seed=60 + e + p)
    cap = {"roomy": 700, "overflowing": 700 // max(p, 2), "one": 1}[cap_kind]
    want = _np_pack(keys, vals, p, cap, 64, PAD, -7)
    got = tsort.radix_pack_pairs(_t(keys), torch.from_numpy(vals), p, cap, 64,
                                 key_fill=PAD, val_fill=-7)
    assert [g.dtype for g in got] == [torch.uint64, torch.int64, torch.int32, torch.bool]
    got = [got[0].view(torch.int64).numpy().view(np.uint64)] + [g.numpy() for g in got[1:]]
    for name, a, b in zip(("kslab", "vslab", "counts", "overflowed"), want, got):
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_radix_pack_pairs_64_below_64_key_bits():
    keys, vals = _stack(4, 500, 16, seed=70, key_bits=40)
    want = _np_pack(keys, vals, 16, 80, 40, PAD, 0)
    got = tsort.radix_pack_pairs(_t(keys), torch.from_numpy(vals), 16, 80, 40, PAD, 0)
    np.testing.assert_array_equal(got[0].view(torch.int64).numpy().view(np.uint64), want[0])
    for a, b in zip(want[1:], got[1:]):
        np.testing.assert_array_equal(a, b.numpy())


@pytest.mark.parametrize("bad", ["key_bits_65", "val_fill_beyond_int64",
                                 "int32_payloads", "uint32_keys_int64_payloads"])
def test_radix_pack_pairs_64_refuses(bad):
    keys, vals = _stack(2, 50, 8, seed=71)
    k, v = _t(keys), torch.from_numpy(vals)
    args = {"key_bits_65": (k, v, 8, 20, 65),
            "val_fill_beyond_int64": (k, v, 8, 20, 64, 0, 1 << 63),
            "int32_payloads": (k, v.to(torch.int32), 8, 20, 64),
            "uint32_keys_int64_payloads": (k.view(torch.int64).to(torch.int32)
                                           .view(torch.uint32), v, 8, 20, 32)}[bad]
    with pytest.raises(ValueError):
        tsort.radix_pack_pairs(*args)


class _FakePack64Lib:
    """``srt_radix_pack64`` that records its arguments and computes the
    plain version through the pointers it is given."""

    def __init__(self):
        self.calls = []

    def srt_radix_pack_scratch(self, e, n, p):
        return e * p * 3

    def srt_error_string(self, rc):
        return b"invalid argument"

    def srt_radix_pack(self, *args):
        raise AssertionError("the 4-byte kernel launched for 8-byte rows")

    def srt_radix_pack64(self, *args):
        self.calls.append(args)
        (kp, vp, ksp, vsp, cp, fp, _scratch, e, n, p, key_bits, cap, key_fill,
         val_fill, _stream) = args

        def at(ptr, shape, dtype):
            count = int(np.prod(shape))
            raw = (ctypes.c_uint8 * (count * torch.empty((), dtype=dtype).element_size())
                   ).from_address(ptr)
            return torch.frombuffer(raw, dtype=dtype, count=count).view(shape)

        want = tsort.radix_pack_pairs_reference(
            at(kp, (e, n), torch.int64).view(torch.uint64), at(vp, (e, n), torch.int64),
            p, cap, key_bits, key_fill % (1 << 64), val_fill)
        for ptr, w in zip((ksp, vsp, cp, fp), want):
            at(ptr, w.shape, torch.int64 if w.dtype == torch.uint64 else w.dtype).copy_(
                w.view(torch.int64) if w.dtype == torch.uint64 else w)
        return 0


@pytest.fixture
def fake_pack64(monkeypatch):
    lib = _FakePack64Lib()
    monkeypatch.setattr(tsort, "_pack_kernel_path", lambda keys: True)
    monkeypatch.setattr(_build, "_on_device",
                        lambda symbol, device: contextlib.nullcontext((lib, 77)))
    _build.reset_launch_counts()
    return lib


def test_radix_pack64_launch_arguments(fake_pack64):
    e, n, p, cap = 4, 300, 8, 60
    keys, vals = _stack(e, n, p, seed=72)
    k, v = _t(keys), torch.from_numpy(vals)
    got = tsort.radix_pack_pairs(k, v, p, cap, 64, key_fill=PAD, val_fill=-7)
    (args,) = fake_pack64.calls
    assert args[0] == k.data_ptr() and args[1] == v.data_ptr()
    assert args[2] == got[0].data_ptr() and args[3] == got[1].data_ptr()
    # the padding key as its int64 bits, and the stream last
    assert args[7:] == (e, n, p, 64, cap, -1, -7, 77)
    want = tsort.radix_pack_pairs_reference(k, v, p, cap, 64, PAD, -7)
    for a, b in zip(want, got):
        assert a.dtype == b.dtype
        assert torch.equal(a.view(torch.int64) if a.dtype == torch.uint64 else a,
                           b.view(torch.int64) if b.dtype == torch.uint64 else b)
    assert _build.launches == {"srt_radix_pack64": 1}


def test_wide_step_packs_once_a_side_on_the_kernel(fake_pack64, monkeypatch):
    e = 4
    tables = _tables(400, 3001, seed=73)
    join = HashJoin(make_mesh(["cpu"] * e))
    args, nb, npl = join.place(*tables)
    fn = join.step(nb, npl, 2 * nb // e, 2 * npl // e)
    got = fn(*args)
    assert _build.launches == {"srt_radix_pack64": 2} and len(fake_pack64.calls) == 2
    assert [c[7:12] for c in fake_pack64.calls] == [(e, nb, e, 64, 2 * nb // e),
                                                    (e, npl, e, 64, 2 * npl // e)]
    monkeypatch.setattr(tsort, "_pack_kernel_path", lambda keys: False)
    want = fn(*args)
    for a, b in zip(want, got):
        assert torch.equal(a.view(torch.int64) if a.dtype == torch.uint64 else a,
                           b.view(torch.int64) if b.dtype == torch.uint64 else b)


# ----------------------------------------------------------------------
# the exchange counts 8 bytes an element
# ----------------------------------------------------------------------
def test_exchange_program_counts_int64_bytes():
    e, cap = 4, 10
    prog = ExchangeProgram(make_mesh(["cpu"] * e)).program_for(e, cap, torch.int64)
    reg = get_registry()
    sent = reg.counter("exchange.bytes_sent", schedule="a2a")
    received = reg.counter("exchange.bytes_received", schedule="a2a")
    before = sent.value, received.value
    send = torch.arange(e * e * cap, dtype=torch.int64).view(e * e, cap) << 40
    recv, _ = prog(send, torch.full((e * e,), cap, dtype=torch.int32))
    assert recv.dtype == torch.int64
    assert torch.equal(recv.view(e, e, cap), send.view(e, e, cap).transpose(0, 1))
    assert (sent.value - before[0], received.value - before[1]) == (8 * e * e * cap,) * 2
