"""The device path of the host plane for every dtype numpy and torch share,
and for ``torch.bfloat16``, on ``device="cpu"`` over the python transport.

Each case publishes one block from each of two executors, one above and
one below ``deviceFetch.minBlockBytes`` (16 KiB), and executor 0 fetches
both typed (one local short-circuit, one remote): the fetched bytes equal
the input's and the JAX ``DeviceShuffleIO``'s for the same numpy input,
and the fetched slabs carry the requested dtype. The JAX endpoint runs
uint64 under ``jax.enable_x64``: with 64-bit types off (its default) it
narrows a uint64 slab to uint32. Torch float16, bfloat16 and bool tensors
go through ``stage_device_blocks`` and a typed fetch the same way; JAX
takes the bfloat16 twin as an ``ml_dtypes`` array (the port needs no
``ml_dtypes``: it only copies and views the tensor's bytes)."""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparkrdma_tpu.shuffle.device_io import DeviceShuffleIO as JaxIO
from sparkrdma_tpu.shuffle.handle import BaseShuffleHandle as JaxHandle
from sparkrdma_tpu.shuffle.handle import HashPartitioner as JaxPartitioner
from sparkrdma_tpu.shuffle.manager import TpuShuffleManager as JaxManager
from sparkrdma_tpu.utils.config import TpuShuffleConf as JaxConf
from sparkrdma_tpu_torch.shuffle.device_io import DeviceShuffleIO
from sparkrdma_tpu_torch.shuffle.handle import BaseShuffleHandle, HashPartitioner
from sparkrdma_tpu_torch.shuffle.manager import TpuShuffleManager
from sparkrdma_tpu_torch.utils import torch_compat as tc
from sparkrdma_tpu_torch.utils.config import TpuShuffleConf

torch.set_num_threads(1)

PY = {"tpu.shuffle.transport": "python"}
MIN_BLOCK = 16 << 10  # deviceFetch.minBlockBytes' default
BIG, SMALL = 1 << 15, 64  # elements: above and below the minimum for each dtype


@contextlib.contextmanager
def _ios(pkg, prefix):
    """A driver and two executors of one package with a shuffle of two
    maps and two partitions registered; yields both endpoints."""
    if pkg == "jax":
        conf_cls, mgr_cls, handle = JaxConf, JaxManager, JaxHandle(
            shuffle_id=1, num_maps=2, partitioner=JaxPartitioner(2))
    else:
        conf_cls, mgr_cls, handle = TpuShuffleConf, TpuShuffleManager, BaseShuffleHandle(
            shuffle_id=1, num_maps=2, partitioner=HashPartitioner(2))
    conf = conf_cls(dict(PY))
    driver = mgr_cls(conf, is_driver=True)
    execs = [mgr_cls(conf, is_driver=False, executor_id=f"{prefix}-{pkg}-{i}")
             for i in range(2)]
    ios = ([JaxIO(e) for e in execs] if pkg == "jax"
           else [DeviceShuffleIO(e, device="cpu") for e in execs])
    try:
        driver.register_shuffle(handle)
        yield ios
    finally:
        for io in ios:
            io.stop()
        for e in execs:
            e.stop()
        driver.stop()


def _roundtrip(pkg, blocks, dtype, prefix):
    """Executor ``p`` publishes ``blocks[p]`` as partition ``p``; executor
    0 fetches both typed. Returns ``{p: (bytes, slab dtype, slab)}``."""
    with _ios(pkg, prefix) as ios:
        for p, io in enumerate(ios):
            io.publish_device_blocks(1, {p: blocks[p]})
        got = ios[0].fetch_device_blocks(1, 0, 2, dtype=dtype, timeout_s=60)
        out = {}
        for p in range(2):
            (b,) = got[p]
            arr = b.array
            out[p] = (b.read(0, b.length), arr.dtype,
                      arr.clone() if isinstance(arr, torch.Tensor) else None)
            b.free()
        return out


def _make(dtype, n, seed):
    rng = np.random.default_rng(seed)
    dt = np.dtype(dtype)
    if dt == np.bool_:
        return rng.integers(0, 2, n).astype(np.bool_)
    if dt.kind == "c":
        return (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(dt)
    if dt.kind == "f":
        return rng.normal(size=n).astype(dt)
    info = np.iinfo(dt)
    return rng.integers(info.min, info.max, n, dtype=dt, endpoint=True)


# ----------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["bool", "float16", "uint16", "uint64",
                                   "complex64", "int32"])
def test_numpy_blocks_match_jax(dtype):
    """One block above and one below the minimum, for each dtype (int32,
    which the device path always took, is the control)."""
    big, small = _make(dtype, BIG, 1), _make(dtype, SMALL, 2)
    assert big.nbytes >= MIN_BLOCK > small.nbytes
    with jax.enable_x64(dtype == "uint64"):
        want = _roundtrip("jax", [big, small], np.dtype(dtype), f"nj{dtype}")
    got = _roundtrip("torch", [big, small], np.dtype(dtype), f"nt{dtype}")
    for p, src in enumerate((big, small)):
        assert got[p][0] == src.tobytes() == want[p][0], (dtype, p)
        assert got[p][1] == tc.torch_dtype(dtype)
        assert np.dtype(want[p][1]) == np.dtype(dtype)
        np.testing.assert_array_equal(got[p][2][: src.size].numpy(), src)


@pytest.mark.parametrize("n", [1 << 20, SMALL])
@pytest.mark.parametrize("dtype", ["float16", "bool"])
def test_probe_publishes_and_fetches_every_byte(dtype, n):
    """The fault's probes: ``np.arange(1 << 20).astype(np.float16)`` (2
    MiB, above the minimum; past 65504 the values round to inf), the
    same count of bools (1 MiB), and 64-element blocks below it."""
    with np.errstate(over="ignore"):
        block = (np.arange(n) % 3 == 1) if dtype == "bool" else np.arange(n).astype(dtype)
        other = block[::-1].copy()
    want = _roundtrip("jax", [block, other], np.dtype(dtype), f"pj{dtype}{n}")
    got = _roundtrip("torch", [block, other], np.dtype(dtype), f"pt{dtype}{n}")
    assert len(got[0][0]) == block.nbytes == n * np.dtype(dtype).itemsize
    assert got[0][0] == block.tobytes() == want[0][0]
    assert got[1][0] == other.tobytes() == want[1][0]
    assert got[0][2].dtype == tc.torch_dtype(dtype)


@pytest.mark.parametrize("n", [BIG, SMALL])
@pytest.mark.parametrize("dtype", ["float16", "bfloat16", "bool"])
def test_torch_tensor_blocks_match_jax(dtype, n):
    """CPU tensors through ``stage_device_blocks`` and a fetch typed with
    the torch dtype; the JAX endpoint gets their numpy twins."""
    rng = np.random.default_rng(5)
    if dtype == "bool":
        bits = rng.integers(0, 2, (2, n)).astype(np.bool_)
        tensors = [torch.from_numpy(b) for b in bits]
        twins = list(bits)
    else:
        vals = rng.normal(size=(2, n)).astype(np.float32)
        twins = [np.array(jnp.asarray(v, getattr(jnp, dtype))) for v in vals]
        tensors = [torch.from_numpy(t.view(np.uint16)).view(getattr(torch, dtype))
                   for t in twins]
    want = _roundtrip("jax", twins, twins[0].dtype, f"tj{dtype}{n}")
    got = _roundtrip("torch", tensors, getattr(torch, dtype), f"tt{dtype}{n}")
    for p in range(2):
        assert got[p][0] == twins[p].tobytes() == want[p][0], (dtype, p)
        assert got[p][1] == getattr(torch, dtype)
        assert torch.equal(got[p][2][:n], tensors[p])


def test_staged_slab_keeps_a_tensors_dtype():
    """``stage_device_blocks`` types the arena copy with the tensor's own
    dtype, bfloat16 included, and publishes its bytes unchanged."""
    t = torch.arange(1 << 14, dtype=torch.float32).to(torch.bfloat16)
    with _ios("torch", "stage") as ios:
        (loc,) = ios[0].stage_device_blocks(1, {0: t})
        assert loc.block.has_device and loc.block.length == 2 * t.numel()
        slab = ios[0].device_buffers.resolve(loc.block.arena_handle)
        assert slab.array.dtype == torch.bfloat16
        assert torch.equal(slab.array[: t.numel()], t)
        assert slab.read(0, loc.block.length) == t.view(torch.uint8).numpy().tobytes()
        ios[0].publish_staged(1, [loc])


@pytest.mark.parametrize("dtype", ["bool", "uint8", "int8", "int16", "uint16",
                                   "int32", "uint32", "int64", "uint64",
                                   "float16", "float32", "float64",
                                   "complex64", "complex128"])
def test_dtype_maps_cover_every_shared_dtype(dtype):
    t = tc.torch_dtype(dtype)
    assert tc.itemsize(t) == tc.itemsize(dtype) == np.dtype(dtype).itemsize
    assert tc.dtype_name(t) == tc.dtype_name(dtype) == dtype
    assert torch.from_numpy(np.zeros(2, dtype)).dtype == t


def test_bfloat16_has_no_numpy_dtype_but_a_byte_path():
    assert tc.torch_dtype(torch.bfloat16) is torch.bfloat16
    assert tc.itemsize(torch.bfloat16) == 2
    assert tc.dtype_name(torch.bfloat16) == "bfloat16"
