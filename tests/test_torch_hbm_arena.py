"""ops/hbm_arena.py of the port against the JAX arena: size classes,
the budget, pins, the eviction-race guard, and a host/disk spill and
restore round trip that stays byte-equal under one op sequence."""

import numpy as np
import pytest
import torch

from sparkrdma_tpu.ops import hbm_arena as jarena
from sparkrdma_tpu_torch.ops import hbm_arena as tarena

torch.set_num_threads(1)

KIB = 1024


def _pair(**kw):
    return (jarena.DeviceBufferManager(**kw),
            tarena.DeviceBufferManager(device="cpu", **kw))


@pytest.mark.parametrize("n", [0, 1, 16 * KIB - 1, 16 * KIB, 16 * KIB + 1,
                               100_000, 1 << 22])
def test_size_classes_match(n):
    assert tarena._size_class(n) == jarena._size_class(n)
    j, t = _pair()
    assert t.get(n).capacity == j.get(n).capacity


def test_pooling_statistics_match():
    j, t = _pair()
    for arena in (j, t):
        bufs = [arena.get(n) for n in (20 * KIB, 20 * KIB, 70 * KIB)]
        bufs[0].free()
        arena.get(30 * KIB).free()
        bufs[0].free()  # double free tolerated
    assert t.stats() == j.stats()
    assert t.in_use_bytes == j.in_use_bytes


def test_budget_memory_error():
    j, t = _pair(max_bytes=64 * KIB)
    for arena in (j, t):
        bufs = [arena.get(16 * KIB) for _ in range(4)]
        with pytest.raises(MemoryError):
            with arena.pinned_on_device(bufs + [arena.get(16 * KIB)]):
                pass
        with arena.pinned_on_device(bufs):
            # every resident slab is pinned by this thread: no room
            with pytest.raises(MemoryError):
                arena.get(16 * KIB)


def test_pins_protect_from_spill():
    t = tarena.DeviceBufferManager(device="cpu", max_bytes=48 * KIB)
    a, b, c = (t.stage_bytes(bytes([k]) * 100) for k in (1, 2, 3))
    with t.pinned_on_device([a]):
        t.get(16 * KIB)  # must spill b (LRU unpinned), never a
        assert a.array is not None and b.spilled
    assert not c.spilled


def test_pinned_if_resident_on_freed_and_spilled():
    t = tarena.DeviceBufferManager(device="cpu")
    live = t.stage_bytes(b"x" * 100)
    spilled = t.stage_bytes(b"y" * 100)
    freed = t.stage_bytes(b"z" * 100)
    spilled.spill_to_host()
    freed.free()
    with t.pinned_if_resident(live.handle) as got:
        assert got is live
    with t.pinned_if_resident(spilled.handle) as got:
        assert got is None
    with t.pinned_if_resident(freed.handle) as got:
        assert got is None
    with t.pinned_if_resident(999) as got:
        assert got is None
    assert spilled.spilled  # the guard never climbs a spilled slab back


def test_put_array_zero_pads_like_jax():
    import jax.numpy as jnp

    vals = np.arange(1000, dtype=np.uint32) * np.uint32(2654435761)
    j, t = _pair()
    jb = j.get(vals.nbytes).put_array(jnp.asarray(vals))
    tb = t.get(vals.nbytes).put_array(torch.from_numpy(vals))
    assert tb.read(0, tb.capacity) == jb.read(0, jb.capacity)
    assert tb.length == jb.length == vals.nbytes
    assert tb.array.dtype == torch.uint32
    with pytest.raises(ValueError):
        t.get(16).put_array(torch.zeros(2, 2))


def test_spill_restore_round_trip_matches_jax(tmp_path):
    rng = np.random.default_rng(21)
    payloads = [rng.integers(0, 1 << 32, n, dtype=np.uint32)
                for n in (3000, 5000, 4096, 1000, 7000)]
    raw = rng.integers(0, 256, 9000, dtype=np.uint8).tobytes()
    kw = dict(max_bytes=64 * KIB, max_host_bytes=32 * KIB)
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    j = jarena.DeviceBufferManager(spill_dir=str(tmp_path / "j"), **kw)
    t = tarena.DeviceBufferManager(device="cpu", spill_dir=str(tmp_path / "t"),
                                   **kw)
    sides = []
    for arena in (j, t):
        bufs = [arena.stage_view(p, p.nbytes, np.uint32) for p in payloads]
        bufs.append(arena.stage_bytes(raw))
        sides.append(bufs)
    # the same spill/cascade history on both sides
    assert t.spill_count == j.spill_count > 0
    assert t.disk_spill_count == j.disk_spill_count > 0
    assert (t.in_use_bytes, t.host_bytes) == (j.in_use_bytes, j.host_bytes)
    assert [b.on_disk for b in sides[1]] == [b.on_disk for b in sides[0]]
    for jb, tb in zip(*sides):
        assert tb.read() == jb.read()
    # climb everything back, one working set at a time
    for k in range(len(payloads) + 1):
        with j.pinned_on_device([sides[0][k]]), t.pinned_on_device([sides[1][k]]):
            assert sides[1][k].array is not None
            assert (sides[1][k].read(0, sides[1][k].capacity)
                    == sides[0][k].read(0, sides[0][k].capacity))
    for k, p in enumerate(payloads):
        assert sides[1][k].read() == p.tobytes()
        assert sides[1][k].array is None or sides[1][k].array.dtype == torch.uint32
    for jb, tb in zip(*sides):
        jb.free()
        tb.free()
    assert t.host_bytes == j.host_bytes == 0
    assert not list((tmp_path / "t").iterdir())


def test_put_at_keeps_the_given_handle():
    t = tarena.DeviceBufferManager(device="cpu")
    buf = t.put_at(7, torch.arange(10, dtype=torch.int32), 40)
    assert t.resolve(7) is buf and buf.length == 40
    assert t.get(100).handle == 8
    with pytest.raises(ValueError):
        t.put_at(7, torch.zeros(4), 16)
