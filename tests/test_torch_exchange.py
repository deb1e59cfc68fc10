"""The port's exchange plane against the JAX package's on the 8-device
CPU mesh, fed the same numpy inputs: the neighbor pull against the
XLA twin of the TPU kernel (a ``shard_map`` of ``lax.ppermute`` by one
hop to the left), ``ExchangeProgram.exchange`` / ``ring_exchange``
byte for byte in ``recv`` and ``rcounts``, their stats, the mesh and
the planner. The CUDA branches run on the CPU through a fake kernel
library that does the rotation from the pointer table it is given."""

import contextlib
import ctypes
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from sparkrdma_tpu.ops.exchange import ExchangeProgram as JaxProgram
from sparkrdma_tpu.parallel import mesh as jmesh
from sparkrdma_tpu.shuffle import planner as jplanner
from sparkrdma_tpu.utils.jax_compat import shard_map
from sparkrdma_tpu_torch.convert import shards_from_jax
from sparkrdma_tpu_torch.obs import get_registry
from sparkrdma_tpu_torch.ops import _build
from sparkrdma_tpu_torch.ops import remote_copy as trc
from sparkrdma_tpu_torch.ops.exchange import (
    ExchangeProgram,
    pack_blocks,
    round_rows,
    unpack_blocks,
)
from sparkrdma_tpu_torch.parallel import mesh as tmesh
from sparkrdma_tpu_torch.shuffle import planner as tplanner

torch.set_num_threads(1)

CPU8 = ["cpu"] * 8


# ----------------------------------------------------------------------
# the neighbor pull
# ----------------------------------------------------------------------
def _ppermute_left(x: np.ndarray) -> np.ndarray:
    """Kernel #1's XLA twin: device i receives device (i+1) mod n's shard."""
    n = x.shape[0]
    mesh = Mesh(np.array(jax.devices()[:n]), ("x",))
    perm = [((i + 1) % n, i) for i in range(n)]
    f = jax.jit(shard_map(lambda s: jax.lax.ppermute(s, "x", perm), mesh=mesh,
                          in_specs=P("x"), out_specs=P("x"), check_vma=False))
    return np.asarray(f(jax.device_put(x, NamedSharding(mesh, P("x")))))


def _stack(n, shape, dtype, seed):
    raw = np.random.default_rng(seed).integers(
        0, 256, n * int(np.prod(shape)) * np.dtype(dtype).itemsize, np.uint8)
    return raw.view(dtype).reshape(n, *shape)


DTYPES = {
    "uint8": (np.uint8, torch.uint8),
    "int32": (np.int32, torch.int32),
    "float32": (np.float32, torch.float32),
    "bfloat16": (jnp.bfloat16, torch.bfloat16),
}


@pytest.mark.parametrize("n", [1, 2, 8])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_neighbor_pull_matches_ppermute(n, dtype):
    np_dt, t_dt = DTYPES[dtype]
    x = _stack(n, (3, 5), np_dt, seed=n)
    want = _ppermute_left(x)
    blocks = torch.from_numpy(x.view(np.uint8)).view(t_dt)
    trc.reset_launch_counts()
    got = trc.neighbor_pull(blocks)
    assert got.dtype == t_dt and got.shape == blocks.shape
    assert got.data_ptr() != blocks.data_ptr()
    np.testing.assert_array_equal(got.view(torch.uint8).numpy(), want.view(np.uint8))
    np.testing.assert_array_equal(want.view(np.uint8), np.roll(x, -1, 0).view(np.uint8))
    assert trc.neighbor_pull_launches == 0  # the CPU runs the plain version


def test_neighbor_pull_into_out_and_its_checks():
    x = torch.arange(24, dtype=torch.int32).view(4, 6)
    out = torch.full_like(x, -1)
    assert trc.neighbor_pull(x, out=out) is out
    assert torch.equal(out, torch.roll(x, -1, 0))
    for bad in (x, x[1:3].new_empty((4, 6))[:, :5], torch.empty(4, 6),
                torch.empty(3, 6, dtype=torch.int32)):
        with pytest.raises(ValueError):
            trc.neighbor_pull(x, out=bad)
    # an out that overlaps the source by one row
    buf = torch.zeros(30, dtype=torch.int32)
    with pytest.raises(ValueError, match="overlaps"):
        trc.neighbor_pull(buf[:24].view(4, 6), out=buf[6:].view(4, 6))
    with pytest.raises(ValueError):
        trc.neighbor_pull(x.t())  # not contiguous
    with pytest.raises(ValueError):
        trc.neighbor_pull(torch.tensor(3))  # no shard axis
    with pytest.raises(ValueError):
        trc.neighbor_pull(x.to("meta"))


# ----------------------------------------------------------------------
# the CUDA branch, reached on the CPU through a fake library
# ----------------------------------------------------------------------
class _FakeLib:
    """Stands in for the built library: ``srt_neighbor_pull`` does the
    rotation through the (src, dst) pointer table it is handed, so the
    table itself is under test; returns ``rc``."""

    def __init__(self, rc=0):
        self.rc = rc
        self.calls = []

    def srt_neighbor_pull(self, table, n, shard_bytes, stream):
        self.calls.append((n, shard_bytes, stream))
        if self.rc:
            return self.rc
        t = (ctypes.c_uint64 * (2 * n)).from_address(table)
        for i in range(n):
            ctypes.memmove(t[2 * i + 1], t[2 * ((i + 1) % n)], shard_bytes)
        return 0

    def srt_error_string(self, rc):
        return b"invalid configuration argument"


@pytest.fixture
def kernel_path(monkeypatch):
    lib = _FakeLib()
    monkeypatch.setattr(trc, "_kernel_path", lambda b: True)
    monkeypatch.setattr(_build, "load", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: types.SimpleNamespace(cuda_stream=77))
    return lib


@pytest.mark.parametrize("n,shape,dtype", [
    (1, (7,), "uint8"), (3, (5,), "int32"), (8, (4, 33), "uint8"),
    (2, (4097,), "bfloat16"),
])
def test_kernel_branch_launches_once(kernel_path, n, shape, dtype):
    np_dt, t_dt = DTYPES[dtype]
    x = torch.from_numpy(_stack(n, shape, np_dt, seed=5).view(np.uint8)).view(t_dt)
    trc.reset_launch_counts()
    got = trc.neighbor_pull(x)
    (call,) = kernel_path.calls
    assert call == (n, x[0].numel() * x.element_size(), 77)
    assert torch.equal(got.view(torch.uint8), torch.roll(x, -1, 0).view(torch.uint8))
    assert trc.neighbor_pull_launches == 1


def test_kernel_branch_errors_propagate(kernel_path):
    kernel_path.rc = 9
    trc.reset_launch_counts()
    with pytest.raises(RuntimeError, match="srt_neighbor_pull launch failed"):
        trc.neighbor_pull(torch.zeros(2, 4))
    prog = ExchangeProgram(tmesh.make_mesh(CPU8))
    send, counts = _dryrun_send(8)
    with pytest.raises(RuntimeError, match="launch failed"):
        prog.ring_exchange(send, counts)
    assert trc.neighbor_pull_launches == 0


def test_ring_through_the_kernel_branch(kernel_path):
    e = 8
    send, counts = _dryrun_send(e)
    want = JaxProgram(jmesh.make_mesh()).ring_exchange(send, counts)
    prog = ExchangeProgram(tmesh.make_mesh(CPU8))
    trc.reset_launch_counts()
    recv, rcounts = prog.ring_exchange(send, counts)
    assert trc.neighbor_pull_launches == 2 * (e - 1)
    np.testing.assert_array_equal(recv.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(rcounts.numpy(), np.asarray(want[1]))
    prog.ring_exchange(send, counts)
    assert trc.neighbor_pull_launches == 4 * (e - 1)


def test_zero_byte_shards_launch_nothing(kernel_path):
    trc.reset_launch_counts()
    assert trc.neighbor_pull(torch.zeros(4, 0)).shape == (4, 0)
    assert kernel_path.calls == [] and trc.neighbor_pull_launches == 0


def test_binding_declares_neighbor_pull():
    fns = ("srt_wave_pull", "srt_pipelined_wave_pull", "srt_neighbor_pull",
           "srt_flash_attn_fwd", "srt_flash_attn_fwd_sm90",
           "srt_flash_attn_bwd_dq", "srt_flash_attn_bwd_dkv",
           "srt_flash_attn_bwd_dq_sm90", "srt_flash_attn_bwd_dkv_sm90",
           "srt_error_string")
    lib = _build._bind(types.SimpleNamespace(
        **{f: types.SimpleNamespace() for f in fns}))
    fn = lib.srt_neighbor_pull
    assert fn.argtypes == [ctypes.c_void_p, ctypes.c_longlong,
                           ctypes.c_longlong, ctypes.c_void_p]
    assert fn.restype is ctypes.c_int


# ----------------------------------------------------------------------
# ExchangeProgram against the JAX program
# ----------------------------------------------------------------------
def _dryrun_send(e):
    """__graft_entry__'s dryrun blocks: (src*16+dst) % 256, 1+src+dst
    bytes, 64-byte buckets."""
    blocks = [bytes([(src * 16 + dst) % 256]) * (1 + src + dst)
              for src in range(e) for dst in range(e)]
    return pack_blocks(blocks, 64)


def _ragged_send(e, block, rpp, seed):
    """Random payloads of random lengths, ``rpp`` rows per peer."""
    rng = np.random.default_rng(seed)
    blocks = [rng.integers(0, 256, int(rng.integers(0, block + 1)),
                           np.uint8).tobytes() for _ in range(e * e * rpp)]
    return pack_blocks(blocks, block)


def _same(got, want):
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def _stats(prog):
    return {k: {f: v for f, v in s.items() if f != "time_s"}
            for k, s in prog.stats.items()}


@pytest.mark.parametrize("schedule", ["exchange", "ring_exchange"])
@pytest.mark.parametrize("payload", ["dryrun", "ragged"])
def test_schedules_match_jax(schedule, payload):
    e = 8
    send, counts = (_dryrun_send(e) if payload == "dryrun"
                    else _ragged_send(e, 96, 1, seed=4))
    jprog = JaxProgram(jmesh.make_mesh())
    tprog = ExchangeProgram(tmesh.make_mesh(CPU8))
    want = getattr(jprog, schedule)(send, counts)
    got = getattr(tprog, schedule)(send, counts)
    _same(got, want)
    assert got[0].dtype == torch.uint8 and got[1].dtype == torch.int32
    # twice more, from torch tensors: the stats follow JAX's
    getattr(jprog, schedule)(send, counts)
    getattr(tprog, schedule)(torch.from_numpy(send), torch.from_numpy(counts))
    assert _stats(tprog) == _stats(jprog)
    assert tprog.exchanges == jprog.exchanges == 2
    assert tprog.bytes_moved == jprog.bytes_moved
    label = "a2a" if schedule == "exchange" else "ring"
    assert tprog.stats[label]["time_s"] > 0.0


def test_dryrun_blocks_delivered():
    e = 8
    send, counts = _dryrun_send(e)
    tprog = ExchangeProgram(tmesh.make_mesh(CPU8))
    for fn in (tprog.exchange, tprog.ring_exchange):
        recv, rcounts = fn(send, counts)
        r = recv.numpy().reshape(e, e, 64)
        c = rcounts.numpy().reshape(e, e)
        for dst in range(e):
            assert unpack_blocks(r[dst], c[dst]) == [
                bytes([(src * 16 + dst) % 256]) * (1 + src + dst)
                for src in range(e)]


@pytest.mark.parametrize("dtype", [np.uint32, np.float32, np.uint16])
def test_typed_sends_match_jax(dtype):
    e = 8
    send = _stack(e * e, (40,), dtype, seed=9).reshape(e * e, 40)
    counts = np.random.default_rng(2).integers(0, 41, e * e).astype(np.int32)
    tprog = ExchangeProgram(tmesh.make_mesh(CPU8))
    for schedule in ("exchange", "ring_exchange"):
        want = getattr(JaxProgram(jmesh.make_mesh()), schedule)(send, counts)
        got = getattr(tprog, schedule)(send, counts)
        assert got[0].numpy().dtype == dtype
        _same(got, want)


def test_row_bucketing_matches_jax_cache():
    """3 and 5 rows per peer pad to the classes 4 and 8: byte-exact after
    the pad rows are stripped, and the same number of cached programs."""
    e, block = 8, 48
    jprog = JaxProgram(jmesh.make_mesh())
    tprog = ExchangeProgram(tmesh.make_mesh(CPU8))
    for rpp in (3, 5, 4):
        send, counts = _ragged_send(e, block, rpp, seed=rpp)
        want = jprog.exchange(send, counts)
        got = tprog.exchange(send, counts)
        assert got[0].shape == (e * e * rpp, block)
        _same(got, want)
    assert len(tprog._all_to_all_cache) == len(jprog._all_to_all_cache) == 2
    assert round_rows(3) == round_rows(4) == 4 and round_rows(5) == 8
    assert _stats(tprog) == _stats(jprog)


def test_two_d_mesh_all_to_all_matches_jax():
    e = 8
    send, counts = _ragged_send(e, 64, 1, seed=8)
    want = JaxProgram(jmesh.make_mesh(num_slices=2)).exchange(send, counts)
    tprog = ExchangeProgram(tmesh.make_mesh(CPU8, num_slices=2))
    assert tprog.axes == ("dcn", "exec") and tprog.num_shards == e
    _same(tprog.exchange(send, counts), want)


def test_ring_refuses_what_it_cannot_run():
    e = 8
    send, counts = _dryrun_send(e)
    with pytest.raises(NotImplementedError, match="1-D mesh"):
        ExchangeProgram(tmesh.make_mesh(CPU8, num_slices=2)).ring_exchange(
            send, counts)
    prog = ExchangeProgram(tmesh.make_mesh(CPU8))
    two = np.concatenate([send, send]), np.concatenate([counts, counts])
    with pytest.raises(ValueError, match="one row per peer"):
        prog.ring_exchange(*two)
    with pytest.raises(ValueError):
        prog.exchange(send[:63], counts[:63])  # not a multiple of E
    with pytest.raises(ValueError):
        prog.exchange(send, counts.astype(np.int64))
    with pytest.raises(ValueError):
        prog.exchange(send[:, 0], counts)  # no block axis


def test_exchange_records_the_metric_families():
    reg = get_registry()
    before = {k: reg.counter(f"exchange.{k}", schedule="ring").value
              for k in ("exchanges", "bytes_sent", "bytes_received_valid")}
    hist = reg.histogram("exchange.time_ms", schedule="ring")
    n0 = hist.snapshot()["count"]
    send, counts = _dryrun_send(8)
    ExchangeProgram(tmesh.make_mesh(CPU8)).ring_exchange(send, counts)
    assert reg.counter("exchange.exchanges", schedule="ring").value == \
        before["exchanges"] + 1
    assert reg.counter("exchange.bytes_sent", schedule="ring").value == \
        before["bytes_sent"] + send.nbytes
    assert reg.counter("exchange.bytes_received_valid", schedule="ring").value \
        == before["bytes_received_valid"] + int(counts.sum())
    assert hist.snapshot()["count"] == n0 + 1


# ----------------------------------------------------------------------
# the mesh, the planner, shards_from_jax
# ----------------------------------------------------------------------
@pytest.mark.parametrize("num_slices", [None, 1, 2, 4])
def test_make_mesh_matches_jax(num_slices):
    j = jmesh.make_mesh(jax.devices()[:8], num_slices=num_slices)
    t = tmesh.make_mesh(CPU8, num_slices=num_slices)
    assert t.axis_names == tuple(j.axis_names)
    assert t.shape == dict(j.shape)
    assert t.num_shards == 8 and t.device == torch.device("cpu")
    assert tmesh.all_exchange_axes(t) == jmesh.all_exchange_axes(j)
    for axis in t.axis_names:
        assert tmesh.mesh_axis_size(t, axis) == jmesh.mesh_axis_size(j, axis)
    # shard order: dcn-major, exec-minor, as the JAX sharding's
    flat = np.array(j.devices).reshape(-1)
    for i in range(8):
        c = t.coords(i)
        assert flat[i] == j.devices[tuple(c[a] for a in j.axis_names)]
    assert tmesh.exec_axis() == jmesh.exec_axis() == "exec"
    assert tmesh.dcn_axis() == jmesh.dcn_axis() == "dcn"


def test_make_mesh_device_rules():
    with pytest.raises(ValueError, match="divide"):
        tmesh.make_mesh(CPU8, num_slices=3)
    with pytest.raises(ValueError, match="mix"):
        tmesh.make_mesh(["cpu", "cuda:0"])
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        tmesh.make_mesh(["cuda:0", "cuda:1"])
    with pytest.raises(ValueError):
        tmesh.make_mesh([])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tmesh.make_mesh(["cuda:0"] * 4)


@pytest.mark.parametrize("num_shards", [1, 2, 8, 5])
@pytest.mark.parametrize("dist", ["uniform", "skewed", "empty"])
def test_planner_matches_jax(num_shards, dist):
    rng = np.random.default_rng(num_shards)
    sample = {
        "uniform": rng.integers(0, 1 << 32, 4096, dtype=np.uint32),
        "skewed": (rng.zipf(1.3, 4096) % 1000).astype(np.uint32) << 20,
        "empty": np.zeros(0, np.uint32),
    }[dist]
    edges = tplanner.plan_edges(sample, num_shards)
    np.testing.assert_array_equal(edges, jplanner.plan_edges(sample, num_shards))
    assert edges.dtype == np.uint32
    for ed in (None, edges):
        assert tplanner.capacity_from_sample(sample, num_shards, 1 << 15, edges=ed) \
            == jplanner.capacity_from_sample(sample, num_shards, 1 << 15, edges=ed)
    for p, r in ((10, 3), (7, 7), (1, 4)):
        assert tplanner.static_bounds(p, r) == jplanner.static_bounds(p, r)


def test_shards_from_jax():
    mesh = tmesh.make_mesh(CPU8)
    jm = jmesh.make_mesh()
    x = np.arange(8 * 6 * 3, dtype=np.int32).reshape(8 * 6, 3)
    arr = jax.device_put(x, NamedSharding(jm, P("exec")))
    shards = [np.asarray(s.data) for s in sorted(
        arr.addressable_shards, key=lambda s: s.index[0].start)]
    t = shards_from_jax(np.asarray(arr), mesh)
    assert t.shape == (8, 6, 3) and t.device == mesh.device
    for i in range(8):
        np.testing.assert_array_equal(t[i].numpy(), shards[i])
    with pytest.raises(ValueError):
        shards_from_jax(x[:7], mesh)
