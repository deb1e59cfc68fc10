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
import math
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


def test_requires_grad_gradient_matches_jax_custom_vjp():
    """An input that requires grad gets a gradient equal to the JAX
    custom VJP's (fp32 2e-4 / 2e-5), and under no_grad the output is the
    same."""
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
    elif bad == "dtype":  # float16 is taken since it has a kernel route
        q, k, v = q.double(), k.double(), v.double()
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
    """Stands in for the built library: records each launch's entry point
    and arguments and returns ``rc`` (``rc_sm90`` for the tensor-core
    entry, ``rc`` unless given)."""

    def __init__(self, rc, rc_sm90=None):
        self.rc = rc
        self.rc_sm90 = rc if rc_sm90 is None else rc_sm90
        self.calls = []
        self.entries = []

    def srt_flash_attn_fwd(self, *args):
        self.calls.append(args)
        self.entries.append("srt_flash_attn_fwd")
        return self.rc

    def srt_flash_attn_fwd_sm90(self, *args):
        self.calls.append(args)
        self.entries.append("srt_flash_attn_fwd_sm90")
        return self.rc_sm90

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
           "srt_flash_attn_fwd", "srt_flash_attn_fwd_sm90",
           "srt_flash_attn_bwd_dq", "srt_flash_attn_bwd_dkv",
           "srt_flash_attn_bwd_dq_sm90", "srt_flash_attn_bwd_dkv_sm90",
           "srt_error_string")
    lib = _build._bind(types.SimpleNamespace(
        **{f: types.SimpleNamespace() for f in fns}))
    for fa in (lib.srt_flash_attn_fwd, lib.srt_flash_attn_fwd_sm90):
        assert fa.argtypes[:5] == [ctypes.c_void_p] * 5
        assert fa.argtypes[5:11] == [ctypes.c_longlong] * 6
        assert fa.argtypes[11] is ctypes.c_void_p and len(fa.argtypes) == 12
        assert fa.restype is ctypes.c_int


# ----------------------------------------------------------------------
# the route between the two forward kernels, chosen before the launch
# ----------------------------------------------------------------------
@pytest.mark.parametrize("want_lse", [False, True])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [64, 128])
def test_bf16_route_takes_the_tensor_core_kernel(kernel_path, d, causal, want_lse):
    """bf16 with D 64 or 128 on 16-byte boundaries reaches
    srt_flash_attn_fwd_sm90 with srt_flash_attn_fwd's argument tuple and
    raises both counters by one."""
    lib = _FakeLib(0)
    kernel_path(lambda: lib)
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16) for x in _inputs(2, 24, 3, d, 8))
    tpa.reset_launch_counts()
    out, lse = tpa.flash_attention_fwd(q, k, v, causal, want_lse=want_lse)
    assert lib.entries == ["srt_flash_attn_fwd_sm90"]
    (args,) = lib.calls
    assert args == (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    lse.data_ptr() if want_lse else None, 2, 24, 3, d, 1,
                    int(causal), 77)
    assert out.dtype == torch.bfloat16 and (lse is not None) == want_lse
    assert (tpa.flash_fwd_launches, tpa.flash_fwd_sm90_launches) == (1, 1)


@pytest.mark.parametrize("case", ["fp32", "bf16_d20", "bf16_misaligned_q"])
def test_other_inputs_take_the_simt_kernel(kernel_path, case):
    """fp32 (the JAX HIGHEST), other head dims and a q off its 16-byte
    boundary go to srt_flash_attn_fwd; the sm90 counter stays at 0."""
    lib = _FakeLib(0)
    kernel_path(lambda: lib)
    dtype = torch.float32 if case == "fp32" else torch.bfloat16
    d = 20 if case == "bf16_d20" else 64
    q, k, v = (torch.from_numpy(x).to(dtype) for x in _inputs(1, 16, 2, d, 9))
    if case == "bf16_misaligned_q":  # one element (2 bytes) past the boundary
        qm = torch.empty(q.numel() + 1, dtype=dtype)[1:].view_as(q)
        qm.copy_(q)
        q = qm
        assert q.is_contiguous() and q.data_ptr() % 16 != 0
    tpa.reset_launch_counts()
    out, _ = tpa.flash_attention_fwd(q, k, v, True)
    assert lib.entries == ["srt_flash_attn_fwd"]
    assert lib.calls[0][0] == q.data_ptr()  # the view itself, not a copy
    assert tpa.fwd_entry(q, k, v, out) == "srt_flash_attn_fwd"
    assert (tpa.flash_fwd_launches, tpa.flash_fwd_sm90_launches) == (1, 0)


def test_tensor_core_kernel_errors_raise_without_retry(kernel_path):
    """A nonzero return from the sm90 entry raises; nothing retries on
    the SIMT kernel or falls back to the plain version."""
    lib = _FakeLib(0, rc_sm90=1)
    kernel_path(lambda: lib)
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16)
               for x in _inputs(1, 16, 2, 64, 10))
    tpa.reset_launch_counts()
    with pytest.raises(RuntimeError, match="srt_flash_attn_fwd_sm90 launch failed"):
        tpa.flash_attention(q, k, v, causal=True)
    assert lib.entries == ["srt_flash_attn_fwd_sm90"]
    assert (tpa.flash_fwd_launches, tpa.flash_fwd_sm90_launches) == (0, 0)


# ----------------------------------------------------------------------
# the tensor-core kernel's arithmetic against the TPU kernel
# ----------------------------------------------------------------------
def _sm90_emulation(q, k, v, causal):
    """srt_flash_attn_fwd_sm90's arithmetic in torch (f32 on the CPU):
    128-row q tiles over 128-key kv tiles in ascending order, stopping
    after the last live one; scores from the bf16 operands into f32, in
    base 2 (scale * log2 e folded in); p rounded to bf16 before p.v; l
    summed from the f32 p. q, k, v: [B, S, H, D] bf16. Returns (out bf16
    [B, S, H, D], lse f32 [B, H, S])."""
    b, s, h, d = q.shape
    c = torch.tensor(math.log2(math.e) / math.sqrt(d), dtype=torch.float32)
    qt, kt, vt = (x.permute(0, 2, 1, 3).float() for x in (q, k, v))
    out = torch.empty((b, h, s, d))
    lse = torch.empty((b, h, s))
    for q0 in range(0, s, 128):
        qb = qt[:, :, q0:q0 + 128]
        rows = q0 + torch.arange(qb.shape[2])[:, None]
        m = torch.full(qb.shape[:3], tpa.NEG_INF)
        l = torch.zeros(qb.shape[:3])
        acc = torch.zeros(qb.shape)
        n_tiles = -(-s // 128)
        if causal:
            n_tiles = min(n_tiles, q0 // 128 + 1)
        for k0 in range(0, 128 * n_tiles, 128):
            kb, vb = kt[:, :, k0:k0 + 128], vt[:, :, k0:k0 + 128]
            x = torch.matmul(qb, kb.transpose(-1, -2)) * c
            if causal:
                cols = k0 + torch.arange(kb.shape[2])[None, :]
                x = torch.where(rows >= cols, x, tpa.NEG_INF)
            m_new = torch.maximum(m, x.amax(-1))
            corr = torch.exp2(m - m_new)
            p = torch.exp2(x - m_new[..., None])
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.matmul(p.bfloat16().float(), vb)
            m = m_new
        denom = torch.where(l > 0, l, 1.0)
        out[:, :, q0:q0 + 128] = acc / denom[..., None]
        lse[:, :, q0:q0 + 128] = torch.where(
            l > 0, m * math.log(2) + torch.log(denom), -tpa.NEG_INF)
    return out.permute(0, 2, 1, 3).bfloat16(), lse


@pytest.mark.parametrize("b,s,h,d,causal", [(2, 300, 2, 128, True),
                                            (1, 257, 3, 64, False)])
def test_tensor_core_numerics_match_jax_kernel(b, s, h, d, causal):
    """bf16 p before p.v is the TPU kernel's own rounding at its bf16
    precision=DEFAULT; here the emulated kernel is held against the Pallas
    kernel in interpret mode (f32 throughout, the more precise of the two
    references) at BF16_TOL for out and LSE_TOL for lse, and against the
    port's plain version at the tolerance chip_smoke.py holds the kernel
    to."""
    arrays = _inputs(b, s, h, d, seed=s + d)
    want, want_lse = _jax_fwd(arrays, causal, 512, 512, jnp.bfloat16)
    q, k, v = (torch.tensor(x).to(torch.bfloat16) for x in arrays)
    out, lse = _sm90_emulation(q, k, v, causal)
    np.testing.assert_allclose(out.float().numpy(), want, **BF16_TOL)
    np.testing.assert_allclose(lse.numpy(),
                               _jax_lse(want_lse, b, h, s, 512, 512), **LSE_TOL)
    plain, plain_lse = tpa.flash_attention_reference(q, k, v, causal, want_lse=True)
    np.testing.assert_allclose(out.float().numpy(), plain.float().numpy(), **BF16_TOL)
    np.testing.assert_allclose(lse.numpy(), plain_lse.numpy(), **LSE_TOL)
    # the rounding of p is in effect: the output is not the f32-p one
    assert not torch.equal(out, plain)
