"""The route to the 3xTF32 flash-attention forward
(``srt_flash_attn_fwd_tf32x3``) and its arithmetic, on the CPU.

- ``flash_attention_tf32x3_reference``, the kernel's function (both
  products ``hi*lo + lo*hi + hi*hi`` of the operands' TF32 split), is
  held against the JAX package's Pallas flash attention in interpret mode
  at ``precision=HIGHEST`` and against the port's f32 plain forward: out
  at the fp32 tolerance of the JAX package's tests (rtol 2e-4 / atol
  2e-5), lse at rtol 2e-5 / atol 1e-4 (f32 sums in another order). Plain
  TF32 (the ``lo`` terms dropped) fails the same check, so the tolerance
  tells the two apart.
- ``fwd_entry`` picks the kernel from dtype, precision, head dim and
  alignment alone; the CUDA branch is reached through a fake kernel
  library that records the ctypes arguments (and writes given outputs
  through the pointers, so autograd is checked end to end).
"""

import contextlib
import ctypes
import functools

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
TF32X3 = "srt_flash_attn_fwd_tf32x3"
SIMT = "srt_flash_attn_fwd"
SM90 = "srt_flash_attn_fwd_sm90"
BWD_TF32X3 = ["srt_flash_attn_bwd_dq_tf32x3", "srt_flash_attn_bwd_dkv_tf32x3"]


def _inputs(b, s, h, d, seed, n=3):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, s, h, d)).astype(np.float32) for _ in range(n)]


def _misaligned(x):
    """The same values one element past a 16-byte boundary."""
    y = torch.empty(x.numel() + 1, dtype=x.dtype)[1:].view_as(x)
    y.copy_(x)
    assert y.is_contiguous() and y.data_ptr() % 16 != 0
    return y


def _jax_lse(lse, b, h, s, block_q, block_k):
    """The JAX kernel's [B, H, 8, nq * L] lse tile as plain [B, H, S]."""
    bq, _, s_pad = jpa._resolve_blocks(s, block_q, block_k)
    L = max(bq, 128)
    nq = s_pad // bq
    lse = np.asarray(lse)[:, :, 0, :].reshape(b, h, nq, L)[..., :bq]
    return lse.reshape(b, h, s_pad)[..., :s]


# ----------------------------------------------------------------------
# the kernel's arithmetic against the TPU kernel at precision=HIGHEST
# ----------------------------------------------------------------------
CASES = [(1, s, 2, d, causal) for d in (64, 128) for causal in (False, True)
         for s in (1, 77, 129, 300)] + [(1, 2048, 1, 64, False)]  # the workload's length


def _case_id(c):
    return f"b{c[0]}_s{c[1]}_h{c[2]}_d{c[3]}_{'causal' if c[4] else 'full'}"


@functools.lru_cache(maxsize=None)
def _arrays(case):
    b, s, h, d, causal = case
    return tuple(_inputs(b, s, h, d, seed=s + d + causal))


@functools.lru_cache(maxsize=None)
def _jax_fwd(case):
    """(out, lse [B, H, S]) of the JAX flash attention at HIGHEST."""
    b, s, h, _, causal = case
    q, k, v = (jnp.asarray(x) for x in _arrays(case))
    highest = jax.lax.Precision.HIGHEST
    out = jpa.flash_attention(q, k, v, causal=causal, interpret=True, precision=highest)
    _, lse = jpa._fwd_impl(q, k, v, causal, 512, 512, True, highest, True)
    return np.asarray(out), _jax_lse(lse, b, h, s, 512, 512)


def _tf32x3_fwd(case):
    q, k, v = (torch.from_numpy(x) for x in _arrays(case))
    return tpa.flash_attention_tf32x3_reference(q, k, v, case[4], want_lse=True)


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_tf32x3_reference_matches_jax_highest(case):
    out, lse = _tf32x3_fwd(case)
    want, want_lse = _jax_fwd(case)
    b, s, h, d, _ = case
    assert out.shape == (b, s, h, d) and out.dtype == torch.float32
    assert lse.shape == (b, h, s) and lse.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), want, **F32_TOL)
    np.testing.assert_allclose(lse.numpy(), want_lse, **LSE_TOL)


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_tf32x3_reference_matches_f32_plain_forward(case):
    out, lse = _tf32x3_fwd(case)
    q, k, v = (torch.from_numpy(x) for x in _arrays(case))
    want, want_lse = tpa.flash_attention_reference(q, k, v, case[4], want_lse=True)
    np.testing.assert_allclose(out.numpy(), want.numpy(), **F32_TOL)
    np.testing.assert_allclose(lse.numpy(), want_lse.numpy(), **LSE_TOL)


def test_plain_tf32_fails_the_fp32_tolerance(monkeypatch):
    """The same plain version with the ``lo`` terms dropped (one TF32
    product, ``hi*hi``) misses rtol 2e-4 / atol 2e-5 at the workload's
    length, while 3xTF32 meets it (above)."""
    case = CASES[-1]
    want, _ = _jax_fwd(case)
    monkeypatch.setattr(tpa, "_tf32_split",
                        lambda x: (tpa._tf32_round(x), torch.zeros_like(x)))
    out, _ = _tf32x3_fwd(case)
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(out.numpy(), want, **F32_TOL)


# ----------------------------------------------------------------------
# fwd_entry: a pure function of dtype, precision, D and alignment
# ----------------------------------------------------------------------
def _zeros(d, dtype, n=4):
    return [torch.zeros((1, 8, 2, d), dtype=dtype) for _ in range(n)]


@pytest.mark.parametrize("precision", [None, *tpa.PRECISIONS])
@pytest.mark.parametrize("d", [64, 128])
def test_fwd_entry_fp32_takes_tf32x3_at_every_precision(d, precision):
    assert tpa.fwd_entry(*_zeros(d, torch.float32), precision) == TF32X3


@pytest.mark.parametrize("d,dtype", [(32, torch.float32), (256, torch.float32),
                                     (64, torch.float16), (128, torch.float16)])
def test_fwd_entry_other_head_dims_and_float16_take_simt(d, dtype):
    assert tpa.fwd_entry(*_zeros(d, dtype)) == SIMT


@pytest.mark.parametrize("which", ["q", "k", "v", "out"])
def test_fwd_entry_misaligned_fp32_tensor_takes_simt(which):
    t = dict(zip(("q", "k", "v", "out"), _zeros(64, torch.float32)))
    assert tpa.fwd_entry(*t.values()) == TF32X3
    t[which] = _misaligned(t[which])
    assert tpa.fwd_entry(*t.values()) == SIMT


@pytest.mark.parametrize("precision,want", [("default", SM90), ("high", SIMT)])
def test_fwd_entry_bf16_keeps_its_routes(precision, want):
    assert tpa.fwd_entry(*_zeros(128, torch.bfloat16), precision) == want


# ----------------------------------------------------------------------
# the CUDA branch through a fake library
# ----------------------------------------------------------------------
def _write(ptr, t):
    t = t.contiguous()
    ctypes.memmove(ptr, t.data_ptr(), t.numel() * t.element_size())


class _FakeLib:
    """Records each launch's entry point and arguments; with ``results``
    writes the given tensors where a kernel writes its outputs. Returns
    ``rc[name]`` (0 by default)."""

    def __init__(self, results=None, rc=None):
        self.results = results or {}
        self.rc = rc or {}
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith("srt_flash_attn"):
            raise AttributeError(name)
        return lambda *args: self._launch(name, args)

    def _launch(self, name, args):
        outs = {"_fwd": ((3, "out"), (4, "lse")), "_dq": ((6, "dq"),),
                "_dkv": ((6, "dk"), (7, "dv"))}
        kind = next(k for k in ("_fwd", "_dkv", "_dq") if k in name)
        for i, key in outs[kind]:
            if args[i] is not None and key in self.results:
                _write(args[i], self.results[key])
        self.calls.append((name, args))
        return self.rc.get(name, 0)

    def srt_error_string(self, rc):
        return b"invalid argument"

    def names(self):
        return [name for name, _ in self.calls]


@pytest.fixture
def kernel_path(monkeypatch):
    monkeypatch.setattr(tpa, "_kernel_path", lambda q: True)

    def use(lib):
        monkeypatch.setattr(_build, "_on_device",
                            lambda symbol, device: contextlib.nullcontext((lib, 77)))
        return lib

    return use


def _counts():
    """Launches of the SIMT, the tensor-core and the 3xTF32 forward."""
    return tuple(_build.launches[s] for s in (SIMT, SM90, TF32X3))


@pytest.mark.parametrize("want_lse", [False, True])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [64, 128])
def test_tf32x3_launch_arguments_and_counters(kernel_path, d, causal, want_lse):
    """fp32 with D 64 or 128 reaches the 3xTF32 kernel with the SIMT
    kernel's argument tuple; it counts one launch."""
    lib = kernel_path(_FakeLib())
    q, k, v = (torch.from_numpy(x) for x in _inputs(2, 24, 3, d, seed=8))
    _build.reset_launch_counts()
    out, lse = tpa.flash_attention_fwd(q, k, v, causal, want_lse=want_lse)
    assert lib.names() == [TF32X3]
    (_, args), = lib.calls
    assert args == (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    lse.data_ptr() if want_lse else None, 2, 24, 3, d, 0,
                    int(causal), 77)
    assert out.shape == q.shape and out.dtype == torch.float32 and out.is_contiguous()
    assert out.data_ptr() % 16 == 0 and (lse is not None) == want_lse
    assert _counts() == (0, 0, 1)


def test_tf32x3_launch_failure_raises_without_simt_retry(kernel_path):
    """A nonzero return raises with the entry's name; nothing retries on
    the SIMT kernel or falls back to the plain version, and no counter
    moves."""
    lib = kernel_path(_FakeLib(rc={TF32X3: 1}))
    q, k, v = (torch.from_numpy(x) for x in _inputs(1, 16, 2, 64, seed=10))
    _build.reset_launch_counts()
    with pytest.raises(RuntimeError, match=f"{TF32X3} launch failed"):
        tpa.flash_attention(q, k, v, causal=True)
    assert lib.names() == [TF32X3]
    assert _counts() == (0, 0, 0)


@pytest.mark.parametrize("d", [64, 128])
def test_autograd_through_the_tf32x3_kernels(kernel_path, d):
    """Training at fp32 D 64/128 launches the 3xTF32 forward with lse, then
    the 3xTF32 dq and dk/dv once each, and each kernel output lands on the
    right input's grad; inference launches the forward without lse."""
    q, k, v, ct = (torch.from_numpy(x) for x in _inputs(1, 32, 2, d, seed=12, n=4))
    out, lse = tpa.flash_attention_tf32x3_reference(q, k, v, True, want_lse=True)
    dq, dk, dv = tpa.flash_attention_bwd_tf32x3_reference(q, k, v, out, lse, ct, True)
    lib = kernel_path(_FakeLib(dict(out=out, lse=lse, dq=dq, dk=dk, dv=dv)))

    _build.reset_launch_counts()
    with torch.no_grad():
        got = tpa.flash_attention(q, k, v, causal=True)
    assert lib.names() == [TF32X3] and lib.calls[0][1][4] is None  # no lse
    torch.testing.assert_close(got, out, rtol=0, atol=0)

    lib.calls.clear()
    _build.reset_launch_counts()
    qg, kg, vg = (x.clone().requires_grad_(True) for x in (q, k, v))
    got = tpa.flash_attention(qg, kg, vg, causal=True)
    assert lib.calls[0][1][4] is not None  # training: the lse variant
    got.backward(ct)
    assert lib.names() == [TF32X3, *BWD_TF32X3]
    assert _counts() == (0, 0, 1)
    assert [_build.launches[s] for s in BWD_TF32X3] == [1, 1]
    for g, w in ((qg.grad, dq), (kg.grad, dk), (vg.grad, dv)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
