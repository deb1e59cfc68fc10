"""The port's flash attention forward against the JAX package's Pallas
kernel (interpret mode on the CPU). The same numpy inputs go to both;
on the CPU the port's wrapper runs its plain version, so these tests
hold the plain version's arithmetic, blocking and logsumexp against the
TPU kernel's. Tolerances: fp32 out rtol 2e-4 / atol 2e-5 (the JAX
package's own tests); lse rtol 2e-5 / atol 1e-4 (f32 sums in another
order); bf16 out 1e-2 / 1e-2 (the output rounds to bf16, whose unit step
at 1.0 is 2^-7)."""

import contextlib
import ctypes
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparkrdma_tpu.ops import pallas_attention as jpa
from sparkrdma_tpu_torch.ops import _build
from sparkrdma_tpu_torch.ops import pallas_attention as tpa

torch.set_num_threads(1)

F32_TOL = dict(rtol=2e-4, atol=2e-5)
LSE_TOL = dict(rtol=2e-5, atol=1e-4)
BF16_TOL = dict(rtol=1e-2, atol=1e-2)


def _inputs(b, s, h, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, s, h, d)).astype(np.float32) for _ in range(3)]


def _jax_lse(lse, b, h, s, block_q, block_k):
    """The JAX kernel's [B, H, 8, nq * L] lse tile as plain [B, H, S]."""
    bq, _, s_pad = jpa._resolve_blocks(s, block_q, block_k)
    L = max(bq, 128)
    nq = s_pad // bq
    lse = np.asarray(lse)[:, :, 0, :].reshape(b, h, nq, L)[..., :bq]
    return lse.reshape(b, h, s_pad)[..., :s]


def _jax_fwd(arrays, causal, block_q, block_k, dtype=jnp.float32):
    q, k, v = (jnp.asarray(x, dtype) for x in arrays)
    out = jpa.flash_attention(q, k, v, causal=causal, block_q=block_q,
                              block_k=block_k, interpret=True)
    _, lse = jpa._fwd_impl(q, k, v, causal, block_q, block_k, True,
                           jax.lax.Precision.HIGHEST, True)
    return np.asarray(out.astype(jnp.float32)), lse


# (b, s, h, d, causal, block_q, block_k)
CASES = {
    "dense": (1, 96, 2, 8, False, 32, 32),
    "dense_causal": (1, 96, 2, 8, True, 32, 32),
    "padded_seq": (1, 50, 2, 4, False, 32, 32),
    "padded_seq_causal": (1, 50, 2, 4, True, 32, 32),
    "multi_kv_blocks": (1, 256, 2, 8, False, 64, 32),
    "mismatched_blocks": (1, 128, 2, 8, True, 128, 96),
    "seq_below_block": (2, 300, 2, 64, True, 512, 512),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_flash_matches_jax_kernel(case):
    b, s, h, d, causal, bq, bk = CASES[case]
    arrays = _inputs(b, s, h, d, seed=len(case))
    want, want_lse = _jax_fwd(arrays, causal, bq, bk)
    q, k, v = (torch.from_numpy(x) for x in arrays)
    tpa.reset_launch_counts()
    out = tpa.flash_attention(q, k, v, causal=causal, block_q=bq, block_k=bk)
    out2, lse = tpa.flash_attention_fwd(q, k, v, causal, bq, bk, want_lse=True)
    assert out.shape == q.shape and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), want, **F32_TOL)
    np.testing.assert_array_equal(out2.numpy(), out.numpy())
    assert lse.shape == (b, h, s) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(),
                               _jax_lse(want_lse, b, h, s, bq, bk), **LSE_TOL)
    # on the CPU the wrapper runs the plain version and launches nothing
    assert tpa.flash_fwd_launches == 0


def test_flash_bf16_matches_jax_kernel():
    b, s, h, d, causal, bq, bk = 1, 96, 2, 64, True, 32, 32
    arrays = _inputs(b, s, h, d, seed=17)
    # both sides round the same f32 values to bf16, to nearest even
    want, want_lse = _jax_fwd(arrays, causal, bq, bk, jnp.bfloat16)
    q, k, v = (torch.tensor(x).to(torch.bfloat16) for x in arrays)
    out, lse = tpa.flash_attention_fwd(q, k, v, causal, bq, bk, want_lse=True)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), want, **BF16_TOL)
    np.testing.assert_allclose(lse.numpy(),
                               _jax_lse(want_lse, b, h, s, bq, bk), **LSE_TOL)


def test_default_blocks_match_resolve_blocks():
    for s, bq, bk in [(300, 512, 512), (50, 32, 32), (128, 128, 96),
                      (2048, 512, 512), (1, 512, 512)]:
        assert tpa._resolve_blocks(s, bq, bk) == jpa._resolve_blocks(s, bq, bk)


def test_strided_view_input_matches_contiguous():
    arrays = _inputs(1, 40, 2, 8, seed=3)
    q, k, v = (torch.from_numpy(x) for x in arrays)
    qs = q.transpose(1, 2).contiguous().transpose(1, 2)  # same values, strided
    assert not qs.is_contiguous()
    np.testing.assert_array_equal(
        tpa.flash_attention(qs, k, v, causal=True).numpy(),
        tpa.flash_attention(q, k, v, causal=True).numpy(),
    )


def test_requires_grad_raises_until_the_training_slice():
    """The training slice has landed: an input that requires grad no
    longer raises; its gradient flows and equals the JAX custom VJP's
    (fp32 2e-4 / 2e-5), and under no_grad the output is the same."""
    arrays = _inputs(1, 16, 1, 4, seed=1)
    q, k, v = (torch.from_numpy(x) for x in arrays)
    q.requires_grad_(True)
    out = tpa.flash_attention(q, k, v)
    assert out.requires_grad
    out.sum().backward()
    jq, jk, jv = (jnp.asarray(x) for x in arrays)
    want = jax.grad(lambda q: jpa.flash_attention(q, jk, jv, interpret=True).sum())(jq)
    np.testing.assert_allclose(q.grad.numpy(), np.asarray(want), **F32_TOL)
    with torch.no_grad():
        np.testing.assert_array_equal(tpa.flash_attention(q, k, v).numpy(),
                                      out.detach().numpy())


@pytest.mark.parametrize("bad", ["rank", "shape", "dtype", "mixed_dtype",
                                 "block", "numpy", "meta_device"])
def test_input_checks(bad):
    q, k, v = (torch.from_numpy(x) for x in _inputs(1, 16, 2, 4, seed=2))
    kw = {}
    if bad == "rank":
        q, k, v = q[0], k[0], v[0]
    elif bad == "shape":
        k = k[:, :8]
    elif bad == "dtype":
        q, k, v = q.half(), k.half(), v.half()
    elif bad == "mixed_dtype":
        v = v.to(torch.bfloat16)
    elif bad == "block":
        kw = {"block_q": 0}
    elif bad == "numpy":
        q = q.numpy()
    elif bad == "meta_device":
        q, k, v = q.to("meta"), k.to("meta"), v.to("meta")
    with pytest.raises((ValueError, TypeError)):
        tpa.flash_attention(q, k, v, **kw)


# ----------------------------------------------------------------------
# the CUDA route, reached on the CPU by forcing the kernel path
# ----------------------------------------------------------------------
class _FakeLib:
    """Stands in for the built library: records the launch arguments and
    returns ``rc``."""

    def __init__(self, rc):
        self.rc = rc
        self.calls = []

    def srt_flash_attn_fwd(self, *args):
        self.calls.append(args)
        return self.rc

    def srt_error_string(self, rc):
        return b"invalid argument"


@pytest.fixture
def kernel_path(monkeypatch):
    monkeypatch.setattr(tpa, "_kernel_path", lambda q: True)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: types.SimpleNamespace(cuda_stream=77))

    def use(load):
        monkeypatch.setattr(_build, "load", load)

    return use


@pytest.mark.parametrize("causal,want_lse,dtype",
                         [(False, False, torch.float32),
                          (True, True, torch.bfloat16)])
def test_kernel_launch_arguments(kernel_path, causal, want_lse, dtype):
    lib = _FakeLib(0)
    kernel_path(lambda: lib)
    q, k, v = (torch.from_numpy(x).to(dtype) for x in _inputs(2, 24, 3, 16, 4))
    tpa.reset_launch_counts()
    out, lse = tpa.flash_attention_fwd(q, k, v, causal, want_lse=want_lse)
    (args,) = lib.calls
    assert args[:4] == (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    assert args[4] == (lse.data_ptr() if want_lse else None)
    assert args[5:] == (2, 24, 3, 16, int(dtype == torch.bfloat16), int(causal), 77)
    assert out.shape == q.shape and out.dtype == dtype and out.is_contiguous()
    assert (lse is not None) == want_lse
    assert tpa.flash_fwd_launches == 1


def test_kernel_errors_propagate(kernel_path):
    """A launch or build failure is an error out of every entry point,
    never a silent fall back to the plain version."""
    from sparkrdma_tpu_torch.ops import UlyssesAttention

    q, k, v = (torch.from_numpy(x) for x in _inputs(1, 16, 2, 8, seed=5))
    lib = _FakeLib(1)
    kernel_path(lambda: lib)
    tpa.reset_launch_counts()
    with pytest.raises(RuntimeError, match="srt_flash_attn_fwd launch failed"):
        tpa.flash_attention(q, k, v)
    with pytest.raises(RuntimeError, match="launch failed"):
        UlyssesAttention(device="cpu")(q, k, v)
    assert tpa.flash_fwd_launches == 0

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    kernel_path(no_nvcc)
    with pytest.raises(RuntimeError, match="nvcc"):
        UlyssesAttention(device="cpu")(q, k, v, causal=True)


def test_head_dim_above_the_kernel_maximum_raises(kernel_path):
    lib = _FakeLib(0)
    kernel_path(lambda: lib)
    q = torch.zeros((1, 4, 1, tpa.MAX_HEAD_DIM + 1))
    with pytest.raises(ValueError, match="head dim"):
        tpa.flash_attention(q, q, q)
    assert lib.calls == []


def test_binding_passes_pointers_as_void_p():
    fns = ("srt_wave_pull", "srt_pipelined_wave_pull", "srt_neighbor_pull",
           "srt_flash_attn_fwd", "srt_flash_attn_bwd_dq",
           "srt_flash_attn_bwd_dkv", "srt_error_string")
    lib = _build._bind(types.SimpleNamespace(
        **{f: types.SimpleNamespace() for f in fns}))
    fa = lib.srt_flash_attn_fwd
    assert fa.argtypes[:5] == [ctypes.c_void_p] * 5
    assert fa.argtypes[5:11] == [ctypes.c_longlong] * 6
    assert fa.argtypes[11] is ctypes.c_void_p and fa.restype is ctypes.c_int
