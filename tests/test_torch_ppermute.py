"""``ops/remote_copy.py``'s general shard permutation (``lax.ppermute`` on
co-resident shards) over the ``srt_neighbor_pull`` kernel's pointer table:
the hop along each axis of a ``(2, 2, 2)`` and a ``(2, 3, 4)`` stack,
both directions, against ``torch.roll`` of the unflattened stack; the left rotation byte-equal to
``neighbor_pull_reference``; partial perms refused; ``PPermute``'s
backward (the inverse permutation) by ``gradcheck`` in float64. The CUDA
branch runs on the CPU through a fake library that moves the bytes the
way the kernel does (``dst[i] <- table[(i + 1) mod n].src``), so the
table that encodes the permutation is itself under test."""

import contextlib
import ctypes

import numpy as np
import pytest
import torch

from sparkrdma_tpu_torch.ops import _build
from sparkrdma_tpu_torch.ops import remote_copy as trc

torch.set_num_threads(1)

MESH = (2, 2, 2)


def _stack(shape=MESH, local=(3, 5), dtype=torch.float32, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(*shape, *local, generator=g).to(dtype)


def _hop(stack, axis, shift, mesh=MESH):
    """Through :func:`ppermute` on the flat ``[E, ...]`` view."""
    e = int(np.prod(mesh))
    flat = stack.reshape(e, -1)
    out = trc.ppermute(flat, trc.axis_shift_perm(mesh, axis, shift))
    return out.reshape(stack.shape)


class _FakeLib:
    """``srt_neighbor_pull`` as the kernel computes it, through the (src,
    dst) pointer table it is handed."""

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
    monkeypatch.setattr(_build, "_on_device",
                        lambda symbol, device: contextlib.nullcontext((lib, 5)))
    return lib


# ----------------------------------------------------------------------
@pytest.mark.parametrize("mesh", [MESH, (2, 3, 4)])
@pytest.mark.parametrize("shift", [1, -1])
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_hop_along_each_axis_is_a_roll(axis, shift, mesh):
    """Shard ``c`` sends to ``c + shift`` along the axis, so it ends up
    holding shard ``c - shift``'s block: ``torch.roll`` by ``shift``
    (the ring's hop is ``shift = 1``, kv moving right)."""
    x = _stack(shape=mesh, seed=axis)
    got = _hop(x, axis, shift, mesh)
    assert torch.equal(got, torch.roll(x, shift, dims=axis))
    for c in np.ndindex(*mesh):
        src = list(c)
        src[axis] = (src[axis] - shift) % mesh[axis]
        assert torch.equal(got[c], x[tuple(src)])


@pytest.mark.parametrize("n", [1, 2, 5, 8])
def test_one_axis_hop_is_the_jax_ring_perm(n):
    assert trc.axis_shift_perm((n,), 0, 1) == [(i, (i + 1) % n) for i in range(n)]


@pytest.mark.parametrize("shift", [1, -1])
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_kernel_branch_hop_is_one_launch(kernel_path, axis, shift):
    mesh = (2, 3, 4)
    x = _stack(shape=mesh, local=(4, 33), dtype=torch.bfloat16, seed=3 + axis)
    _build.reset_launch_counts()
    got = _hop(x, axis, shift, mesh)
    assert kernel_path.calls == [(24, 4 * 33 * 2, 5)]
    assert _build.launches["srt_neighbor_pull"] == 1
    assert torch.equal(got.view(torch.uint8),
                       torch.roll(x, shift, dims=axis).view(torch.uint8))


@pytest.mark.parametrize("n", [1, 2, 3, 8])
def test_left_rotation_is_neighbor_pull(n):
    x = torch.arange(n * 7, dtype=torch.uint8).reshape(n, 7)
    perm = [(i, (i - 1) % n) for i in range(n)]
    want = trc.neighbor_pull_reference(x)
    assert trc.ppermute(x, perm).numpy().tobytes() == want.numpy().tobytes()
    assert trc.ppermute_reference(x, perm).numpy().tobytes() == want.numpy().tobytes()
    assert trc.neighbor_pull(x).numpy().tobytes() == want.numpy().tobytes()


def test_kernel_branch_left_rotation_table(kernel_path):
    """``neighbor_pull`` and the same rotation as a ``perm`` hand the
    kernel the same table and get the same bytes."""
    x = torch.arange(5 * 12, dtype=torch.int32).reshape(5, 12)
    _build.reset_launch_counts()
    a = trc.neighbor_pull(x)
    b = trc.ppermute(x, [(i, (i - 1) % 5) for i in range(5)])
    assert torch.equal(a, trc.neighbor_pull_reference(x)) and torch.equal(a, b)
    assert _build.launches["srt_neighbor_pull"] == 2


@pytest.mark.parametrize("perm", [
    [(0, 1), (1, 0), (2, 3)],           # shard 3 sends nothing
    [(0, 1), (1, 1), (2, 3), (3, 0)],   # shard 1 receives twice
    [(0, 1), (1, 2), (2, 3), (3, 4)],   # past the last shard
    [],
])
def test_partial_perm_raises(perm):
    x = torch.zeros(4, 2)
    with pytest.raises(ValueError):
        trc.ppermute(x, perm)
    with pytest.raises(ValueError):
        trc.perm_sources(perm, 4)


def test_out_and_layout_rules():
    x = torch.arange(8.0).reshape(4, 2)
    perm = [(i, (i + 1) % 4) for i in range(4)]
    out = torch.empty_like(x)
    assert trc.ppermute(x, perm, out=out) is out
    assert torch.equal(out, torch.roll(x, 1, 0))
    with pytest.raises(ValueError, match="overlaps"):
        trc.ppermute(x, perm, out=x)
    with pytest.raises(ValueError, match="contiguous"):
        trc.ppermute(x.t(), [(0, 1), (1, 0)])


def test_gradcheck_float64():
    x = _stack(local=(3,), dtype=torch.float64, seed=7).reshape(8, 3)
    x.requires_grad_(True)
    for axis in range(3):
        perm = trc.axis_shift_perm(MESH, axis, 1)
        assert torch.autograd.gradcheck(lambda t: trc.PPermute.apply(t, perm), (x,))
    cyc = [(0, 5), (5, 2), (2, 0), (1, 1), (3, 4), (4, 3), (6, 7), (7, 6)]
    assert torch.autograd.gradcheck(lambda t: trc.PPermute.apply(t, cyc), (x,))


def test_kernel_branch_backward_is_the_inverse(kernel_path):
    """Forward and backward each launch once; the cotangent comes back
    through the inverse permutation."""
    x = _stack((2, 3, 4), local=(6,), seed=9).reshape(24, 6).requires_grad_(True)
    ct = _stack((2, 3, 4), local=(6,), seed=10).reshape(24, 6)
    perm = trc.axis_shift_perm((2, 3, 4), 2, 1)
    _build.reset_launch_counts()
    y = trc.PPermute.apply(x, perm)
    y.backward(ct)
    assert _build.launches["srt_neighbor_pull"] == 2
    inv = trc.ppermute_reference(ct, trc.inverse_perm(perm))
    assert torch.equal(x.grad, inv)
    assert torch.equal(trc.ppermute_reference(x.grad, perm), ct)
