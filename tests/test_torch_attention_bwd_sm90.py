"""The route to the tensor-core flash-attention backward
(``srt_flash_attn_bwd_dq_sm90`` / ``srt_flash_attn_bwd_dkv_sm90``) and
its arithmetic, on the CPU.

- ``bwd_entry`` picks the pair from dtype, head dim and alignment alone.
- The CUDA branch is reached through a fake kernel library that records
  the ctypes arguments (and writes given gradients through the output
  pointers, so autograd is checked end to end).
- ``flash_attention_bwd_sm90_reference``, the kernels' function (p and ds
  rounded to bf16 before their products, the JAX kernels' own bf16
  ``precision=DEFAULT``), is held against ``jax.vjp`` of the Pallas flash
  attention in interpret mode (f32 throughout, the more precise of the
  two) and against the port's f32 plain backward, at the bf16 tolerance
  1e-2 / 1e-2 (gradients round to bf16, whose unit step at 1.0 is 2^-7).
"""

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

BF16_TOL = dict(rtol=1e-2, atol=1e-2)
SM90 = ("srt_flash_attn_bwd_dq_sm90", "srt_flash_attn_bwd_dkv_sm90")
SIMT = ("srt_flash_attn_bwd_dq", "srt_flash_attn_bwd_dkv")
BOUND = ("srt_wave_pull", "srt_pipelined_wave_pull", "srt_neighbor_pull",
         "srt_flash_attn_fwd", "srt_flash_attn_fwd_sm90",
         "srt_flash_attn_bwd_dq", "srt_flash_attn_bwd_dkv",
         "srt_flash_attn_bwd_dq_sm90", "srt_flash_attn_bwd_dkv_sm90",
         "srt_error_string")


def _inputs(b, s, h, d, seed, n=4):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, s, h, d)).astype(np.float32) for _ in range(n)]


def _misaligned(x):
    """The same values one element past a 16-byte boundary."""
    y = torch.empty(x.numel() + 1, dtype=x.dtype)[1:].view_as(x)
    y.copy_(x)
    assert y.is_contiguous() and y.data_ptr() % 16 != 0
    return y


# ----------------------------------------------------------------------
# bwd_entry: a pure function of dtype, D and alignment
# ----------------------------------------------------------------------
@pytest.mark.parametrize("d", [32, 64, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_bwd_entry_by_dtype_and_head_dim(dtype, d):
    q, k, v, do = (torch.zeros((1, 8, 2, d), dtype=dtype) for _ in range(4))
    grads = [torch.empty_like(q) for _ in range(3)]
    want = SM90 if dtype == torch.bfloat16 and d in (64, 128) else SIMT
    assert tpa.bwd_entry(q, k, v, do, *grads) == want


@pytest.mark.parametrize("which", ["q", "k", "v", "do", "dq", "dk", "dv"])
def test_bwd_entry_misaligned_tensor_takes_simt(which):
    t = dict(zip(("q", "k", "v", "do", "dq", "dk", "dv"),
                 (torch.zeros((1, 8, 2, 64), dtype=torch.bfloat16) for _ in range(7))))
    assert tpa.bwd_entry(*t.values()) == SM90
    t[which] = _misaligned(t[which])
    assert tpa.bwd_entry(*t.values()) == SIMT


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

    def _fwd(self, name, args):
        out, lse = args[3], args[4]
        if "out" in self.results:
            _write(out, self.results["out"])
        if lse is not None and "lse" in self.results:
            _write(lse, self.results["lse"])
        self.calls.append((name, args))
        return self.rc.get(name, 0)

    def _dq(self, name, args):
        if "dq" in self.results:
            _write(args[6], self.results["dq"])
        self.calls.append((name, args))
        return self.rc.get(name, 0)

    def _dkv(self, name, args):
        if "dk" in self.results:
            _write(args[6], self.results["dk"])
            _write(args[7], self.results["dv"])
        self.calls.append((name, args))
        return self.rc.get(name, 0)

    def srt_flash_attn_fwd(self, *args):
        return self._fwd("srt_flash_attn_fwd", args)

    def srt_flash_attn_fwd_sm90(self, *args):
        return self._fwd("srt_flash_attn_fwd_sm90", args)

    def srt_flash_attn_bwd_dq(self, *args):
        return self._dq("srt_flash_attn_bwd_dq", args)

    def srt_flash_attn_bwd_dq_sm90(self, *args):
        return self._dq("srt_flash_attn_bwd_dq_sm90", args)

    def srt_flash_attn_bwd_dkv(self, *args):
        return self._dkv("srt_flash_attn_bwd_dkv", args)

    def srt_flash_attn_bwd_dkv_sm90(self, *args):
        return self._dkv("srt_flash_attn_bwd_dkv_sm90", args)

    def srt_error_string(self, rc):
        return b"invalid argument"

    def names(self):
        return [name for name, _ in self.calls]


@pytest.fixture
def kernel_path(monkeypatch):
    monkeypatch.setattr(tpa, "_kernel_path", lambda q: True)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: types.SimpleNamespace(cuda_stream=77))

    def use(lib):
        monkeypatch.setattr(_build, "load", lambda: lib)
        return lib

    return use


def _counts():
    return (tpa.flash_bwd_dq_launches, tpa.flash_bwd_dkv_launches,
            tpa.flash_bwd_dq_sm90_launches, tpa.flash_bwd_dkv_sm90_launches)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [64, 128])
def test_sm90_launch_arguments_and_counters(kernel_path, d, causal):
    """bf16 with D 64 or 128 reaches the tensor-core pair with the SIMT
    pair's argument lists; every counter of the pair goes up by one."""
    lib = kernel_path(_FakeLib())
    q, k, v, do, out = (torch.from_numpy(x).to(torch.bfloat16)
                        for x in _inputs(2, 24, 3, d, seed=4, n=5))
    lse = torch.randn(2, 3, 24)
    tpa.reset_launch_counts()
    dq, dk, dv = tpa.flash_attention_bwd(q, k, v, out, lse, do, causal)
    assert lib.names() == list(SM90)
    (_, a_dq), (_, a_dkv) = lib.calls
    ins = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr())
    tail = (2, 24, 3, d, 1, int(causal), 77)
    assert a_dq[:5] == ins and a_dkv[:5] == ins
    assert a_dq[5] == a_dkv[5]  # one delta for both launches
    assert a_dq[6:] == (dq.data_ptr(),) + tail
    assert a_dkv[6:] == (dk.data_ptr(), dv.data_ptr()) + tail
    for g, like in zip((dq, dk, dv), (q, k, v)):
        assert g.shape == like.shape and g.dtype == torch.bfloat16 and g.is_contiguous()
    assert _counts() == (1, 1, 1, 1)


@pytest.mark.parametrize("case", ["fp32", "bf16_d32", "bf16_misaligned_do"])
def test_other_inputs_keep_the_simt_pair(kernel_path, case):
    lib = kernel_path(_FakeLib())
    dtype = torch.float32 if case == "fp32" else torch.bfloat16
    d = 32 if case == "bf16_d32" else 64
    q, k, v, do, out = (torch.from_numpy(x).to(dtype)
                        for x in _inputs(1, 16, 2, d, seed=5, n=5))
    if case == "bf16_misaligned_do":
        do = _misaligned(do)
    tpa.reset_launch_counts()
    tpa.flash_attention_bwd(q, k, v, out, torch.zeros(1, 2, 16), do, True)
    assert lib.names() == list(SIMT)
    assert lib.calls[0][1][3] == do.data_ptr()  # the view itself, not a copy
    assert _counts() == (1, 1, 0, 0)


@pytest.mark.parametrize("failing", SM90)
def test_sm90_launch_failure_raises_without_simt_retry(kernel_path, failing):
    lib = kernel_path(_FakeLib(rc={failing: 1}))
    q, k, v, do, out = (torch.from_numpy(x).to(torch.bfloat16)
                        for x in _inputs(1, 16, 2, 64, seed=6, n=5))
    tpa.reset_launch_counts()
    with pytest.raises(RuntimeError, match=f"{failing} launch failed"):
        tpa.flash_attention_bwd(q, k, v, out, torch.zeros(1, 2, 16), do)
    assert lib.names() == list(SM90[:SM90.index(failing) + 1])
    dq_ok = failing == SM90[1]
    assert _counts() == (int(dq_ok), 0, int(dq_ok), 0)


def test_binding_declares_every_symbol():
    lib = _build._bind(types.SimpleNamespace(
        **{f: types.SimpleNamespace() for f in BOUND}))
    for name, n_ptr in ((SM90[0], 7), (SM90[1], 8)):
        fn = getattr(lib, name)
        assert fn.argtypes == getattr(lib, name[:-5]).argtypes
        assert fn.argtypes[:n_ptr] == [ctypes.c_void_p] * n_ptr
        assert fn.argtypes[n_ptr:n_ptr + 6] == [ctypes.c_longlong] * 6
        assert fn.argtypes[-1] is ctypes.c_void_p and len(fn.argtypes) == n_ptr + 7
        assert fn.restype is ctypes.c_int


@pytest.mark.parametrize("d", [64, 128])
def test_autograd_through_the_sm90_kernel_path(kernel_path, d):
    """Training at bf16 D 64/128 launches the tensor-core forward with
    lse, then the tensor-core dq and dk/dv once each, and each kernel
    output lands on the right input's grad."""
    arrays = _inputs(1, 32, 2, d, seed=12)
    q, k, v, ct = (torch.from_numpy(x).to(torch.bfloat16) for x in arrays)
    out, lse = tpa.flash_attention_reference(q, k, v, True, want_lse=True)
    dq, dk, dv = tpa.flash_attention_bwd_sm90_reference(q, k, v, out, lse, ct, True)
    lib = kernel_path(_FakeLib(dict(out=out, lse=lse, dq=dq, dk=dk, dv=dv)))
    tpa.reset_launch_counts()
    qg, kg, vg = (x.clone().requires_grad_(True) for x in (q, k, v))
    got = tpa.flash_attention(qg, kg, vg, causal=True)
    torch.testing.assert_close(got, out, rtol=0, atol=0)
    got.backward(ct.transpose(1, 2).contiguous().transpose(1, 2))  # strided
    assert lib.names() == ["srt_flash_attn_fwd_sm90", *SM90]
    assert lib.calls[0][1][4] is not None  # training: the lse variant
    assert (tpa.flash_fwd_launches, tpa.flash_fwd_sm90_launches) == (1, 1)
    assert _counts() == (1, 1, 1, 1)
    for g, w in ((qg.grad, dq), (kg.grad, dk), (vg.grad, dv)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


# ----------------------------------------------------------------------
# the tensor-core pair's arithmetic against the TPU kernels
# ----------------------------------------------------------------------
SHAPES = [(1, 77, 2, 64), (2, 130, 2, 128)]


def _bf16(arrays):
    return [torch.tensor(x).to(torch.bfloat16) for x in arrays]


def _sm90_grads(arrays, causal):
    q, k, v, ct = _bf16(arrays)
    out, lse = tpa.flash_attention_fwd(q, k, v, causal, want_lse=True)
    return tpa.flash_attention_bwd_sm90_reference(q, k, v, out, lse, ct, causal), \
        (q, k, v, ct, out, lse)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_sm90_reference_matches_jax_vjp(shape, causal):
    arrays = _inputs(*shape, seed=sum(shape) + causal)
    got, _ = _sm90_grads(arrays, causal)
    jq, jk, jv, jct = (jnp.asarray(x, jnp.bfloat16) for x in arrays)
    _, vjp = jax.vjp(lambda q, k, v: jpa.flash_attention(
        q, k, v, causal=causal, interpret=True), jq, jk, jv)
    want = [np.asarray(g.astype(jnp.float32)) for g in vjp(jct)]
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == shape and g.dtype == torch.bfloat16
        np.testing.assert_allclose(g.float().numpy(), w, **BF16_TOL, err_msg=name)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_sm90_reference_matches_f32_plain_backward(shape, causal):
    arrays = _inputs(*shape, seed=sum(shape) + 2 + causal)
    got, (q, k, v, ct, out, lse) = _sm90_grads(arrays, causal)
    want = tpa.flash_attention_bwd_reference(q, k, v, out, lse, ct, causal)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.float().numpy(), w.float().numpy(), **BF16_TOL,
                                   err_msg=name)
    # the roundings of p and ds are in effect
    assert not all(torch.equal(g, w) for g, w in zip(got, want))
