"""The port's flash attention backward against the JAX package's custom
VJP (the Pallas dq and dk/dv kernels in interpret mode on the CPU). The
same numpy inputs and cotangent go to both; on the CPU the port's
wrappers run their plain versions, so these tests hold the plain
backward's blocking, masks and causal skips against the TPU kernels'.
Tolerances: fp32 rtol 2e-4 / atol 2e-5 (the JAX package's own backward
tests); bf16 1e-2 / 1e-2 (gradients round to bf16, whose unit step at
1.0 is 2^-7). The CUDA branch is reached on the CPU through a fake
kernel library that records the ctypes arguments."""

import contextlib
import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparkrdma_tpu.ops import pallas_attention as jpa
from sparkrdma_tpu_torch.ops import _build
from sparkrdma_tpu_torch.ops import pallas_attention as tpa
from sparkrdma_tpu_torch.ops.ring_attention import reference_attention

torch.set_num_threads(1)

F32_TOL = dict(rtol=2e-4, atol=2e-5)
BF16_TOL = dict(rtol=1e-2, atol=1e-2)


def _inputs(b, s, h, d, seed, n=4):
    """q, k, v and the output's cotangent."""
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, s, h, d)).astype(np.float32) for _ in range(n)]


def _jax_grads(arrays, causal, block_q, block_k, dtype=jnp.float32):
    q, k, v, ct = (jnp.asarray(x, dtype) for x in arrays)
    _, vjp = jax.vjp(
        lambda q, k, v: jpa.flash_attention(q, k, v, causal=causal,
                                            block_q=block_q, block_k=block_k,
                                            interpret=True), q, k, v)
    return [np.asarray(g.astype(jnp.float32)) for g in vjp(ct)]


def _port_grads(arrays, causal, block_q, block_k, dtype=torch.float32):
    q, k, v, ct = (torch.tensor(x).to(dtype) for x in arrays)
    for x in (q, k, v):
        x.requires_grad_(True)
    out = tpa.flash_attention(q, k, v, causal=causal, block_q=block_q,
                              block_k=block_k)
    assert out.dtype == dtype and out.requires_grad
    out.backward(ct)
    return [x.grad for x in (q, k, v)]


# the JAX package's backward geometries: (b, s, h, d, block_q, block_k)
GEOMETRIES = {
    "s96_blocks32": (1, 96, 2, 8, 32, 32),
    "s50_padded_blocks32": (1, 50, 2, 4, 32, 32),
    "s128_mismatched_blocks": (1, 128, 2, 8, 64, 32),
}


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_grads_match_jax_vjp(geometry, causal):
    b, s, h, d, bq, bk = GEOMETRIES[geometry]
    arrays = _inputs(b, s, h, d, seed=len(geometry) + causal)
    want = _jax_grads(arrays, causal, bq, bk)
    _build.reset_launch_counts()
    got = _port_grads(arrays, causal, bq, bk)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == (b, s, h, d) and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w, **F32_TOL, err_msg=name)
    # on the CPU the wrappers run the plain versions and launch nothing
    assert not _build.launches


def test_bf16_grads_match_jax_vjp():
    arrays = _inputs(1, 64, 2, 16, seed=23)
    # both sides round the same f32 values to bf16, to nearest even
    want = _jax_grads(arrays, True, 32, 32, jnp.bfloat16)
    got = _port_grads(arrays, True, 32, 32, torch.bfloat16)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.bfloat16
        np.testing.assert_allclose(g.float().numpy(), w, **BF16_TOL, err_msg=name)


@pytest.mark.parametrize("causal", [False, True])
def test_plain_backward_matches_dense_autograd(causal):
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(2, 40, 2, 8, seed=31))
    out, lse = tpa.flash_attention_fwd(q, k, v, causal, 16, 8, want_lse=True)
    got = tpa.flash_attention_bwd_reference(q, k, v, out, lse, do, causal, 16, 8)
    qr, kr, vr = (x.clone().requires_grad_(True) for x in (q, k, v))
    reference_attention(qr, kr, vr, causal=causal).backward(do)
    for name, g, x in zip(("dq", "dk", "dv"), got, (qr, kr, vr)):
        np.testing.assert_allclose(g.numpy(), x.grad.numpy(), **F32_TOL,
                                   err_msg=name)


def test_plain_backward_sequence_of_one():
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(1, 1, 1, 4, seed=2))
    out, lse = tpa.flash_attention_fwd(q, k, v, True, want_lse=True)
    dq, dk, dv = tpa.flash_attention_bwd(q, k, v, out, lse, do, causal=True)
    # one key: p = 1, so dv = do and dq = dk = 0
    np.testing.assert_allclose(dv.numpy(), do.numpy(), rtol=1e-6)
    assert float(dq.abs().max()) < 1e-6 and float(dk.abs().max()) < 1e-6


def test_only_the_inputs_that_require_grad_get_one():
    q, k, v, ct = (torch.from_numpy(x) for x in _inputs(1, 32, 2, 8, seed=9))
    k.requires_grad_(True)
    tpa.flash_attention(q, k, v, causal=True).backward(ct)
    assert q.grad is None and v.grad is None and k.grad is not None
    assert torch.isfinite(k.grad).all() and float(k.grad.abs().max()) > 0


@pytest.mark.parametrize("bad", ["out_shape", "do_dtype", "lse_shape", "lse_dtype"])
def test_bwd_input_checks(bad):
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(1, 16, 2, 4, seed=2))
    out, lse = tpa.flash_attention_fwd(q, k, v, want_lse=True)
    if bad == "out_shape":
        out = out[:, :8]
    elif bad == "do_dtype":
        do = do.to(torch.bfloat16)
    elif bad == "lse_shape":
        lse = lse[:, :, :8]
    elif bad == "lse_dtype":
        lse = lse.double()
    with pytest.raises(ValueError):
        tpa.flash_attention_bwd(q, k, v, out, lse, do)


# ----------------------------------------------------------------------
# the CUDA route, reached on the CPU by forcing the kernel path
# ----------------------------------------------------------------------
def _write(ptr, t):
    """Copy tensor ``t``'s bytes to the address ``ptr`` (a CPU tensor)."""
    t = t.contiguous()
    ctypes.memmove(ptr, t.data_ptr(), t.numel() * t.element_size())


def _read_f32(ptr, shape):
    n = int(np.prod(shape))
    return np.frombuffer((ctypes.c_float * n).from_address(ptr), np.float32,
                         n).reshape(shape).copy()


class _FakeLib:
    """Stands in for the built library. Records every launch's arguments
    and the ``delta`` each backward launch was given; with ``results``
    it writes the given tensors where a kernel would write its outputs,
    so autograd through the forced CUDA branch can be checked end to end.
    Returns ``rc[name]`` (0 by default)."""

    def __init__(self, results=None, rc=None):
        self.results = results or {}
        self.rc = rc or {}
        self.calls = []
        self.deltas = []

    def _record(self, name, args):
        self.calls.append((name, args))
        return self.rc.get(name, 0)

    def srt_flash_attn_fwd(self, *args):
        q, k, v, out, lse, b, s, h, d, dtype, causal, stream = args
        if "out" in self.results:
            _write(out, self.results["out"])
        if lse is not None and "lse" in self.results:
            _write(lse, self.results["lse"])
        return self._record("srt_flash_attn_fwd", args)

    def srt_flash_attn_bwd_dq(self, *args):
        self.deltas.append(_read_f32(args[5], (args[7], args[9], args[8])))
        if "dq" in self.results:
            _write(args[6], self.results["dq"])
        return self._record("srt_flash_attn_bwd_dq", args)

    def srt_flash_attn_bwd_dkv(self, *args):
        if "dk" in self.results:
            _write(args[6], self.results["dk"])
            _write(args[7], self.results["dv"])
        return self._record("srt_flash_attn_bwd_dkv", args)

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


@pytest.mark.parametrize("causal,dtype", [(False, torch.float32),
                                          (True, torch.bfloat16)])
def test_bwd_launch_arguments(kernel_path, causal, dtype):
    lib = kernel_path(_FakeLib())
    q, k, v, do, out = (torch.from_numpy(x).to(dtype)
                        for x in _inputs(2, 24, 3, 16, seed=4, n=5))
    lse = torch.randn(2, 3, 24)
    _build.reset_launch_counts()
    dq, dk, dv = tpa.flash_attention_bwd(q, k, v, out, lse, do, causal)
    assert lib.names() == ["srt_flash_attn_bwd_dq", "srt_flash_attn_bwd_dkv"]
    (_, a_dq), (_, a_dkv) = lib.calls
    ins = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr())
    tail = (2, 24, 3, 16, int(dtype == torch.bfloat16), int(causal), 77)
    assert a_dq[:5] == ins and a_dkv[:5] == ins
    assert a_dq[5] == a_dkv[5]  # one delta for both launches
    assert a_dq[6:] == (dq.data_ptr(),) + tail
    assert a_dkv[6:] == (dk.data_ptr(), dv.data_ptr()) + tail
    for g, like in zip((dq, dk, dv), (q, k, v)):
        assert g.shape == like.shape and g.dtype == dtype and g.is_contiguous()
    # delta = rowsum(do * out) in f32 from `out` as given (bf16: rounded)
    want = torch.einsum("bshd,bshd->bhs", do.float(), out.float()).numpy()
    np.testing.assert_allclose(lib.deltas[0], want, rtol=1e-6, atol=1e-6)
    assert _build.launches == {"srt_flash_attn_bwd_dq": 1, "srt_flash_attn_bwd_dkv": 1}


def test_strided_do_is_made_contiguous(kernel_path):
    lib = kernel_path(_FakeLib())
    q, k, v, out = (torch.from_numpy(x) for x in _inputs(1, 16, 2, 8, seed=6))
    do = torch.from_numpy(_inputs(1, 16, 2, 8, seed=7)[0])
    do_strided = do.transpose(1, 2).contiguous().transpose(1, 2)
    assert not do_strided.is_contiguous()
    lse = torch.zeros(1, 2, 16)
    tpa.flash_attention_bwd(q, k, v, out, lse, do_strided)
    (_, args), _ = lib.calls
    assert args[3] != do_strided.data_ptr()
    want = torch.einsum("bshd,bshd->bhs", do, out).numpy()
    np.testing.assert_allclose(lib.deltas[0], want, rtol=1e-6, atol=1e-6)


def test_autograd_through_the_kernel_path(kernel_path):
    """Training launches the forward with lse, then dq and dk/dv once each,
    and each kernel output lands on the right input's grad; inference
    keeps the forward without lse."""
    arrays = _inputs(1, 32, 2, 8, seed=12)
    q, k, v, ct = (torch.from_numpy(x) for x in arrays)
    out, lse = tpa.flash_attention_reference(q, k, v, True, want_lse=True)
    dq, dk, dv = tpa.flash_attention_bwd_reference(q, k, v, out, lse, ct, True)
    lib = kernel_path(_FakeLib(dict(out=out, lse=lse, dq=dq, dk=dk, dv=dv)))

    _build.reset_launch_counts()
    with torch.no_grad():
        tpa.flash_attention(q, k, v, causal=True)
    tpa.flash_attention(q, k, v, causal=True)  # nothing requires grad
    assert lib.names() == ["srt_flash_attn_fwd"] * 2
    assert all(args[4] is None for _, args in lib.calls)  # no lse
    assert _build.launches == {"srt_flash_attn_fwd": 2}

    lib.calls.clear()
    _build.reset_launch_counts()
    qg, kg, vg = (x.clone().requires_grad_(True) for x in (q, k, v))
    got = tpa.flash_attention(qg, kg, vg, causal=True)
    torch.testing.assert_close(got, out, rtol=0, atol=0)
    assert lib.calls[0][1][4] is not None  # training: the lse variant
    got.backward(ct.transpose(1, 2).contiguous().transpose(1, 2))  # strided
    assert lib.names() == ["srt_flash_attn_fwd", "srt_flash_attn_bwd_dq",
                           "srt_flash_attn_bwd_dkv"]
    assert _build.launches == {"srt_flash_attn_fwd": 1, "srt_flash_attn_bwd_dq": 1,
                               "srt_flash_attn_bwd_dkv": 1}
    for g, w in ((qg.grad, dq), (kg.grad, dk), (vg.grad, dv)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.parametrize("failing", ["srt_flash_attn_bwd_dq",
                                     "srt_flash_attn_bwd_dkv"])
def test_bwd_kernel_errors_propagate(kernel_path, failing):
    lib = kernel_path(_FakeLib(rc={failing: 1}))
    q, k, v, do, out = (torch.from_numpy(x) for x in _inputs(1, 16, 2, 8, 5, n=5))
    _build.reset_launch_counts()
    with pytest.raises(RuntimeError, match=f"{failing} launch failed"):
        tpa.flash_attention_bwd(q, k, v, out, torch.zeros(1, 2, 16), do)
    dq_ok = failing == "srt_flash_attn_bwd_dkv"
    assert _build.launches["srt_flash_attn_bwd_dq"] == int(dq_ok)
    assert _build.launches["srt_flash_attn_bwd_dkv"] == 0
    assert lib.names()[-1] == failing


def test_bwd_head_dim_above_the_kernel_maximum_raises(kernel_path):
    lib = kernel_path(_FakeLib())
    x = torch.zeros((1, 4, 1, tpa.MAX_HEAD_DIM + 1))
    with pytest.raises(ValueError, match="head dim"):
        tpa.flash_attention_bwd(x, x, x, x, torch.zeros(1, 1, 4), x)
    assert lib.calls == []
