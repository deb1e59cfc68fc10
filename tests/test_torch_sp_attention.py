"""The attention serving path as a whole: the port's UlyssesAttention and
RingAttention for one shard against the JAX package's classes on a
one-device mesh (``tests/test_torch_sp_mesh.py`` takes them over meshes), and the dense reference against the JAX one. The same
numpy inputs go to both packages. fp32 tolerance rtol 2e-4 / atol 2e-5
(the JAX package's own SP tests); bf16 1e-2 / 1e-2 (outputs round to
bf16)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparkrdma_tpu.ops.ring_attention import RingAttention as JaxRing
from sparkrdma_tpu.ops.ring_attention import reference_attention as jax_reference
from sparkrdma_tpu.ops.ulysses_attention import UlyssesAttention as JaxUlysses
from sparkrdma_tpu.parallel.mesh import make_mesh
from sparkrdma_tpu_torch.ops import RingAttention, UlyssesAttention
from sparkrdma_tpu_torch.ops import pallas_attention as tpa
from sparkrdma_tpu_torch.ops.ring_attention import reference_attention
from sparkrdma_tpu_torch.ops.ulysses_attention import ulysses_shard_attention
from sparkrdma_tpu_torch.parallel import make_mesh as torch_mesh

torch.set_num_threads(1)

F32_TOL = dict(rtol=2e-4, atol=2e-5)
BF16_TOL = dict(rtol=1e-2, atol=1e-2)


def _inputs(b=2, s=64, h=4, d=16, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, s, h, d)).astype(np.float32) for _ in range(3)]


def _mesh1():
    return make_mesh(jax.devices()[:1])


def _torch(arrays, dtype=torch.float32):
    return [torch.tensor(x).to(dtype) for x in arrays]


@pytest.mark.parametrize("use_flash", [True, False])
@pytest.mark.parametrize("causal", [False, True])
def test_ulysses_matches_jax(causal, use_flash):
    arrays = _inputs(seed=1)
    want = JaxUlysses(_mesh1())(*(jnp.asarray(x) for x in arrays),
                                causal=causal, use_flash=use_flash)
    tpa.reset_launch_counts()
    got = UlyssesAttention(device="cpu")(*_torch(arrays), causal=causal,
                                            use_flash=use_flash)
    assert got.shape == arrays[0].shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
    assert tpa.flash_fwd_launches == 0  # CPU: the plain version


@pytest.mark.parametrize("causal", [False, True])
def test_ring_matches_jax(causal):
    arrays = _inputs(seed=2)
    want = JaxRing(_mesh1())(*(jnp.asarray(x) for x in arrays), causal=causal)
    got = RingAttention(device="cpu")(*_torch(arrays), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


def test_ring_bf16_matches_jax():
    arrays = _inputs(s=48, seed=4)
    want = JaxRing(_mesh1())(*(jnp.asarray(x, jnp.bfloat16) for x in arrays),
                             causal=True)
    got = RingAttention(device="cpu")(*_torch(arrays, torch.bfloat16),
                                         causal=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)), **BF16_TOL)


def test_ulysses_matches_ring():
    arrays = _inputs(seed=3)
    out_u = UlyssesAttention(device="cpu")(*_torch(arrays))
    out_r = RingAttention(device="cpu")(*_torch(arrays))
    np.testing.assert_allclose(out_u.numpy(), out_r.numpy(), **F32_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
def test_reference_attention_matches_jax(causal, dtype):
    arrays = _inputs(s=40, seed=5)
    want = jax_reference(*(jnp.asarray(x, getattr(jnp, dtype)) for x in arrays),
                         causal=causal)
    got = reference_attention(*_torch(arrays, getattr(torch, dtype)),
                              causal=causal)
    assert got.dtype == getattr(torch, dtype)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)), **tol)


def test_classes_move_inputs_to_their_device():
    arrays = _inputs(s=16, seed=6)
    for cls in (UlyssesAttention, RingAttention):
        out = cls(device="cpu")(*arrays)  # numpy in, tensor on the device out
        assert isinstance(out, torch.Tensor) and out.device.type == "cpu"


def test_ulysses_rejects_indivisible_heads():
    q, k, v = (t[None] for t in _torch(_inputs(h=3, seed=7)))  # a 1-shard stack
    with pytest.raises(ValueError, match="divide"):
        ulysses_shard_attention(q, k, v, dim=0, num_shards=2)
    with pytest.raises(ValueError, match="must divide by shard count 2"):
        UlyssesAttention(torch_mesh(["cpu"] * 2))(*_inputs(h=3, seed=7))


@pytest.mark.parametrize("cls", [UlyssesAttention, RingAttention])
def test_more_than_one_rank_waits_for_the_multi_gpu_slice(cls):
    """Two shards on the CPU run (and equal one shard); shards on several
    CUDA devices still wait for peer memory, the multi-GPU slice."""
    with pytest.raises(NotImplementedError, match="multi-GPU slice"):
        cls(torch_mesh(["cuda:0", "cuda:1"]))
    arrays = _inputs(h=4, seed=8)
    two = cls(torch_mesh(["cpu"] * 2))
    assert two.num_shards == 2 and two.device.type == "cpu"
    np.testing.assert_allclose(two(*arrays, causal=True).numpy(),
                               cls(device="cpu")(*arrays, causal=True).numpy(),
                               **F32_TOL)
    q, k, v = _torch(arrays)
    stack = [t.reshape(2, 2, 32, 4, 16).transpose(0, 1).contiguous() for t in (q, k, v)]
    out = ulysses_shard_attention(*stack, dim=0, num_shards=2)
    np.testing.assert_allclose(out.transpose(0, 1).reshape(q.shape).numpy(),
                               reference_attention(q, k, v).numpy(), **F32_TOL)


def test_flash_path_with_grad_inputs_raises():
    """The training slice has landed: gradients flow through the flash
    path of UlyssesAttention (the flash backward) and through
    RingAttention (autograd), keep the graph of inputs already on the
    class's device, and equal the dense path's (fp32 2e-4 / 2e-5)."""
    arrays = _inputs(seed=9)
    ct = torch.from_numpy(_inputs(seed=10)[0])
    grads = {}
    for name, run in (
        ("flash", lambda q, k, v: UlyssesAttention(device="cpu")(q, k, v)),
        ("dense", lambda q, k, v: UlyssesAttention(device="cpu")(
            q, k, v, use_flash=False)),
        ("ring", lambda q, k, v: RingAttention(device="cpu")(q, k, v)),
    ):
        q, k, v = _torch(arrays)
        k.requires_grad_(True)
        run(q, k, v).backward(ct)
        assert k.grad is not None and torch.isfinite(k.grad).all()
        grads[name] = k.grad.numpy()
    np.testing.assert_allclose(grads["flash"], grads["dense"], **F32_TOL)
    np.testing.assert_allclose(grads["ring"], grads["dense"], **F32_TOL)
