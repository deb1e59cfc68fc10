"""Sequence parallelism over a ShardMesh (dryrun section 2): the port's
RingAttention and UlyssesAttention on ``make_mesh(["cpu"] * E)`` against
the JAX package's classes on ``make_mesh(jax.devices()[:E])`` of the
conftest's 8 CPU devices, the same numpy inputs to both, and against the
dense reference. fp32 at rtol 2e-4 / atol 2e-5 (the dryrun's and the JAX
SP tests' bound), the ring in bf16 at 5e-2 / 5e-2 (the JAX ring bf16
test's). Then the CUDA branch on the CPU: the 8-shard ring launches 14
``srt_neighbor_pull`` (k and v at each of 7 hops) and Ulysses one flash
forward, through a fake library that moves bytes as the neighbor-pull
kernel does and computes the flash entry points with their plain
versions."""

import contextlib
import ctypes
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparkrdma_tpu.ops.ring_attention import RingAttention as JaxRing
from sparkrdma_tpu.ops.ring_attention import reference_attention as jax_reference
from sparkrdma_tpu.ops.ulysses_attention import UlyssesAttention as JaxUlysses
from sparkrdma_tpu.parallel.mesh import make_mesh as jax_mesh
from sparkrdma_tpu_torch.ops import _build
from sparkrdma_tpu_torch.ops import pallas_attention as tpa
from sparkrdma_tpu_torch.ops import remote_copy as trc
from sparkrdma_tpu_torch.ops.ring_attention import RingAttention, reference_attention
from sparkrdma_tpu_torch.ops.ulysses_attention import UlyssesAttention
from sparkrdma_tpu_torch.parallel import make_mesh

torch.set_num_threads(1)

F32_TOL = dict(rtol=2e-4, atol=2e-5)
RING_BF16_TOL = dict(rtol=5e-2, atol=5e-2)
CLASSES = {"ring": (RingAttention, JaxRing), "ulysses": (UlyssesAttention, JaxUlysses)}


def _inputs(e, b=1, s_per=8, h=8, d=8, seed=0):
    """The dryrun's layout: S = 8 E, heads divisible by every E."""
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, s_per * e, h, d)).astype(np.float32)
            for _ in range(3)]


def _jax(arrays, dtype=jnp.float32):
    return [jnp.asarray(x, dtype) for x in arrays]


def _torch(arrays, dtype=torch.float32):
    return [torch.from_numpy(x).to(dtype) for x in arrays]


# ----------------------------------------------------------------------
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("e", [2, 4, 8])
@pytest.mark.parametrize("schedule", ["ring", "ulysses"])
def test_schedule_on_the_exec_mesh_matches_jax(schedule, e, causal):
    cls, jax_cls = CLASSES[schedule]
    arrays = _inputs(e, b=2, seed=e + 10 * causal)
    want = np.asarray(jax_cls(jax_mesh(jax.devices()[:e]))(*_jax(arrays),
                                                           causal=causal))
    dense = np.asarray(jax_reference(*_jax(arrays), causal=causal))
    attn = cls(make_mesh(["cpu"] * e))
    assert attn.num_shards == e and attn.axis == "exec"
    got = attn(*_torch(arrays), causal=causal)
    assert got.shape == arrays[0].shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)
    np.testing.assert_allclose(got.numpy(), dense, **F32_TOL)


@pytest.mark.parametrize("e", [2, 8])
def test_ring_bf16_matches_jax(e):
    arrays = _inputs(e, b=2, s_per=6, seed=20 + e)
    want = JaxRing(jax_mesh(jax.devices()[:e]))(*_jax(arrays, jnp.bfloat16),
                                                causal=True)
    got = RingAttention(make_mesh(["cpu"] * e))(*_torch(arrays, torch.bfloat16),
                                                causal=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)), **RING_BF16_TOL)


@pytest.mark.parametrize("axis", ["exec", "dcn"])
@pytest.mark.parametrize("schedule", ["ring", "ulysses"])
def test_dcn_exec_mesh_matches_jax(schedule, axis):
    """A ``(dcn 2, exec 4)`` mesh: the sequence splits over one axis and
    the other holds copies."""
    cls, jax_cls = CLASSES[schedule]
    arrays = _inputs(4, seed=31)
    want = jax_cls(jax_mesh(jax.devices()[:8], num_slices=2), axis=axis)(
        *_jax(arrays), causal=True)
    attn = cls(make_mesh(["cpu"] * 8, num_slices=2), axis=axis)
    assert attn.num_shards == attn.mesh.shape[axis]
    got = attn(*_torch(arrays), causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


def test_default_axis_is_the_last():
    mesh = make_mesh(["cpu"] * 8, num_slices=2)
    assert RingAttention(mesh).axis == UlyssesAttention(mesh).axis == "exec"
    assert RingAttention(mesh).num_shards == 4
    with pytest.raises(ValueError, match="not the mesh's"):
        RingAttention(mesh, device="meta")


@pytest.mark.parametrize("schedule", ["ring", "ulysses"])
def test_gradients_through_the_mesh_equal_the_dense_path(schedule):
    """The ring's hops differentiate through ``PPermute`` (the inverse
    permutation), Ulysses' exchanges through their permutes and the
    flash backward."""
    e = 4
    arrays = _inputs(e, seed=40)
    ct = torch.from_numpy(_inputs(e, seed=41)[0])
    grads = {}
    for name, run in ((schedule, CLASSES[schedule][0](make_mesh(["cpu"] * e))),
                      ("dense", reference_attention)):
        q, k, v = (t.requires_grad_(True) for t in _torch(arrays))
        run(q, k, v, causal=True).backward(ct)
        grads[name] = [t.grad.numpy() for t in (q, k, v)]
    for got, want in zip(grads[schedule], grads["dense"]):
        np.testing.assert_allclose(got, want, **F32_TOL)


# ----------------------------------------------------------------------
# the CUDA branch, reached on the CPU through a fake library
# ----------------------------------------------------------------------
def _read(ptr, shape):
    buf = (ctypes.c_float * math.prod(shape)).from_address(ptr)
    return torch.frombuffer(buf, dtype=torch.float32).reshape(shape).clone()


def _write(ptr, t):
    t = t.contiguous()
    ctypes.memmove(ptr, t.data_ptr(), t.numel() * t.element_size())


class _FakeLib:
    """``srt_neighbor_pull`` moves bytes through its (src, dst) table as
    the kernel does; every flash entry point (f32 only) computes its
    outputs with the plain versions. Records the entry points called."""

    def __init__(self):
        self.calls = []

    def srt_neighbor_pull(self, table, n, shard_bytes, stream):
        self.calls.append("srt_neighbor_pull")
        t = (ctypes.c_uint64 * (2 * n)).from_address(table)
        for i in range(n):
            ctypes.memmove(t[2 * i + 1], t[2 * ((i + 1) % n)], shard_bytes)
        return 0

    def __getattr__(self, name):
        if not name.startswith("srt_flash_attn"):
            raise AttributeError(name)
        return lambda *args: self._flash(name, args)

    def _flash(self, name, args):
        self.calls.append(name)
        b, s, h, d, code, causal = args[-7:-1]
        assert code == 0, "the fake computes float32 only"
        q, k, v = (_read(p, (b, s, h, d)) for p in args[:3])
        out, lse = tpa.flash_attention_reference(q, k, v, bool(causal), want_lse=True)
        if "_fwd" in name:
            _write(args[3], out)
            if args[4] is not None:
                _write(args[4], lse)
            return 0
        do = _read(args[3], (b, s, h, d))
        dq, dk, dv = tpa.flash_attention_bwd_reference(q, k, v, out, lse, do,
                                                       bool(causal))
        if "_dq" in name:
            _write(args[6], dq)
        else:
            _write(args[6], dk)
            _write(args[7], dv)
        return 0

    def srt_error_string(self, rc):
        return b"invalid argument"


@pytest.fixture
def kernel_path(monkeypatch):
    lib = _FakeLib()
    monkeypatch.setattr(trc, "_kernel_path", lambda b: True)
    monkeypatch.setattr(tpa, "_kernel_path", lambda q: True)
    monkeypatch.setattr(_build, "_on_device",
                        lambda symbol, device: contextlib.nullcontext((lib, 77)))
    return lib


def test_kernel_branch_ring_is_14_launches_at_8_shards(kernel_path):
    arrays = _inputs(8, seed=50)
    want = np.asarray(JaxRing(jax_mesh(jax.devices()[:8]))(*_jax(arrays), causal=True))
    _build.reset_launch_counts()
    got = RingAttention(make_mesh(["cpu"] * 8))(*_torch(arrays), causal=True)
    assert _build.launches["srt_neighbor_pull"] == 14
    assert kernel_path.calls == ["srt_neighbor_pull"] * 14
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)
    # the backward runs each hop's inverse through the kernel too
    q, k, v = (t.requires_grad_(True) for t in _torch(arrays))
    RingAttention(make_mesh(["cpu"] * 8))(q, k, v).sum().backward()
    assert _build.launches["srt_neighbor_pull"] == 14 + 28


def test_kernel_branch_ulysses_is_one_flash_launch(kernel_path):
    arrays = _inputs(8, s_per=4, h=8, d=64, seed=51)
    want = np.asarray(JaxUlysses(jax_mesh(jax.devices()[:8]))(*_jax(arrays)))
    _build.reset_launch_counts()
    got = UlyssesAttention(make_mesh(["cpu"] * 8))(*_torch(arrays))
    # f32, D 64, aligned: the 3xTF32 forward, with the 8 shards in its batch
    assert kernel_path.calls == ["srt_flash_attn_fwd_tf32x3"]
    assert _build.launches == {"srt_flash_attn_fwd_tf32x3": 1}
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)
