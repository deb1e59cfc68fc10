"""The route to the 3xTF32 flash-attention backward
(``srt_flash_attn_bwd_dq_tf32x3`` / ``srt_flash_attn_bwd_dkv_tf32x3``)
and its arithmetic, on the CPU.

- The TF32 split: ``hi`` is x rounded to 10 mantissa bits (ties away from
  zero, as ``cvt.rna.tf32.f32``), ``lo`` the remainder rounded the same
  way, and ``hi + lo`` is x to within 2^-22 relative.
- ``flash_attention_bwd_tf32x3_reference``, the kernels' function (every
  product ``hi*lo + lo*hi + hi*hi``), is held against ``jax.vjp`` of the
  Pallas flash attention in interpret mode at ``precision=HIGHEST`` and
  against the port's f32 plain backward, at the fp32 tolerance of the
  JAX package's backward tests (rtol 2e-4 / atol 2e-5). Plain TF32 (the
  ``lo`` terms dropped) fails the same check, so the tolerance tells the
  two apart.
- ``bwd_entry`` picks the pair from dtype, head dim and alignment alone;
  the CUDA branch is reached through a fake kernel library that records
  the ctypes arguments (and writes given gradients through the output
  pointers, so autograd is checked end to end).
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
TF32X3 = ("srt_flash_attn_bwd_dq_tf32x3", "srt_flash_attn_bwd_dkv_tf32x3")
SIMT = ("srt_flash_attn_bwd_dq", "srt_flash_attn_bwd_dkv")
SM90 = ("srt_flash_attn_bwd_dq_sm90", "srt_flash_attn_bwd_dkv_sm90")


def _inputs(b, s, h, d, seed, n=4):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, s, h, d)).astype(np.float32) for _ in range(n)]


def _misaligned(x):
    """The same values one element past a 16-byte boundary."""
    y = torch.empty(x.numel() + 1, dtype=x.dtype)[1:].view_as(x)
    y.copy_(x)
    assert y.is_contiguous() and y.data_ptr() % 16 != 0
    return y


def _bits(x):
    return x.view(torch.int32).numpy().astype(np.int64) & 0xFFFFFFFF


# ----------------------------------------------------------------------
# the TF32 split
# ----------------------------------------------------------------------
SCALES = {"random": 1.0, "tiny": 1e-30, "large": 1e30}


@pytest.mark.parametrize("scale", sorted(SCALES))
def test_split_hi_and_lo_are_tf32_and_recover_x(scale):
    rng = np.random.default_rng(3)
    x = torch.from_numpy((rng.normal(size=4096) * SCALES[scale]).astype(np.float32))
    hi, lo = tpa._tf32_split(x)
    assert not (_bits(hi) & 0x1FFF).any() and not (_bits(lo) & 0x1FFF).any()
    err = (hi.double() + lo.double() - x.double()).abs()
    assert bool((err <= 2.0 ** -22 * x.double().abs()).all())
    # hi alone is the TF32 rounding: within 2^-11 relative, and lo is not 0
    assert bool(((hi.double() - x.double()).abs() <= 2.0 ** -11 * x.double().abs()).all())
    assert bool((lo != 0).any())


@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_tf32_round_ties_away_from_zero(sign):
    # 1 + 2^-11 and 1 + 3 * 2^-11 sit halfway between two TF32 values;
    # round to nearest even would send the first down
    x = torch.tensor([1 + 2.0 ** -11, 1 + 3 * 2.0 ** -11, 1 + 2.0 ** -11 - 2.0 ** -23],
                     dtype=torch.float32) * sign
    got = tpa._tf32_round(x).double().numpy()
    want = np.array([1 + 2.0 ** -10, 1 + 2 * 2.0 ** -10, 1.0]) * sign
    np.testing.assert_array_equal(got, want)


# ----------------------------------------------------------------------
# the kernels' arithmetic against the TPU kernels at precision=HIGHEST
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
def _jax_grads(case):
    causal = case[4]
    jq, jk, jv, jct = (jnp.asarray(x) for x in _arrays(case))
    _, vjp = jax.vjp(lambda q, k, v: jpa.flash_attention(
        q, k, v, causal=causal, interpret=True,
        precision=jax.lax.Precision.HIGHEST), jq, jk, jv)
    return tuple(np.asarray(g) for g in vjp(jct))


def _tf32x3_grads(case):
    q, k, v, ct = (torch.from_numpy(x) for x in _arrays(case))
    out, lse = tpa.flash_attention_fwd(q, k, v, case[4], want_lse=True)
    got = tpa.flash_attention_bwd_tf32x3_reference(q, k, v, out, lse, ct, case[4])
    return got, (q, k, v, ct, out, lse)


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_tf32x3_reference_matches_jax_vjp_highest(case):
    got, _ = _tf32x3_grads(case)
    for name, g, w in zip(("dq", "dk", "dv"), got, _jax_grads(case)):
        assert g.shape == case[:4] and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w, **F32_TOL, err_msg=name)


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_tf32x3_reference_matches_f32_plain_backward(case):
    got, (q, k, v, ct, out, lse) = _tf32x3_grads(case)
    want = tpa.flash_attention_bwd_reference(q, k, v, out, lse, ct, case[4])
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **F32_TOL, err_msg=name)


def test_plain_tf32_fails_the_fp32_tolerance(monkeypatch):
    """The same emulation with the ``lo`` terms dropped (one TF32 product,
    ``hi*hi``) misses rtol 2e-4 / atol 2e-5 at the workload's length in
    each of dq, dk and dv, while 3xTF32 meets it (above)."""
    case = CASES[-1]
    want = _jax_grads(case)
    monkeypatch.setattr(tpa, "_tf32_split",
                        lambda x: (tpa._tf32_round(x), torch.zeros_like(x)))
    got, _ = _tf32x3_grads(case)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        with pytest.raises(AssertionError):
            np.testing.assert_allclose(g.numpy(), w, **F32_TOL, err_msg=name)


# ----------------------------------------------------------------------
# bwd_entry: a pure function of dtype, D and alignment
# ----------------------------------------------------------------------
def _zeros(d, dtype, n=7):
    return [torch.zeros((1, 8, 2, d), dtype=dtype) for _ in range(n)]


@pytest.mark.parametrize("precision", [None, *tpa.PRECISIONS])
@pytest.mark.parametrize("d", [64, 128])
def test_bwd_entry_fp32_takes_tf32x3_at_every_precision(d, precision):
    assert tpa.bwd_entry(*_zeros(d, torch.float32), precision) == TF32X3


@pytest.mark.parametrize("d,dtype", [(32, torch.float32), (256, torch.float32),
                                     (64, torch.float16), (128, torch.float16)])
def test_bwd_entry_other_head_dims_and_float16_take_simt(d, dtype):
    assert tpa.bwd_entry(*_zeros(d, dtype)) == SIMT


@pytest.mark.parametrize("which", ["q", "k", "v", "do", "dq", "dk", "dv"])
def test_bwd_entry_misaligned_fp32_tensor_takes_simt(which):
    t = dict(zip(("q", "k", "v", "do", "dq", "dk", "dv"), _zeros(64, torch.float32)))
    assert tpa.bwd_entry(*t.values()) == TF32X3
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

    def srt_flash_attn_fwd_tf32x3(self, *args):
        return self._fwd("srt_flash_attn_fwd_tf32x3", args)

    def srt_flash_attn_bwd_dq(self, *args):
        return self._dq("srt_flash_attn_bwd_dq", args)

    def srt_flash_attn_bwd_dq_sm90(self, *args):
        return self._dq("srt_flash_attn_bwd_dq_sm90", args)

    def srt_flash_attn_bwd_dq_tf32x3(self, *args):
        return self._dq("srt_flash_attn_bwd_dq_tf32x3", args)

    def srt_flash_attn_bwd_dkv(self, *args):
        return self._dkv("srt_flash_attn_bwd_dkv", args)

    def srt_flash_attn_bwd_dkv_sm90(self, *args):
        return self._dkv("srt_flash_attn_bwd_dkv_sm90", args)

    def srt_flash_attn_bwd_dkv_tf32x3(self, *args):
        return self._dkv("srt_flash_attn_bwd_dkv_tf32x3", args)

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
    """Launches of the SIMT, the tensor-core and the 3xTF32 pair."""
    return tuple(_build.launches[s] for s in SIMT + SM90 + TF32X3)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [64, 128])
def test_tf32x3_launch_arguments_and_counters(kernel_path, d, causal):
    """fp32 with D 64 or 128 reaches the 3xTF32 pair with the SIMT pair's
    argument lists; each of the pair counts one launch."""
    lib = kernel_path(_FakeLib())
    q, k, v, do, out = (torch.from_numpy(x) for x in _inputs(2, 24, 3, d, seed=4, n=5))
    lse = torch.randn(2, 3, 24)
    _build.reset_launch_counts()
    dq, dk, dv = tpa.flash_attention_bwd(q, k, v, out, lse, do, causal)
    assert lib.names() == list(TF32X3)
    (_, a_dq), (_, a_dkv) = lib.calls
    ins = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr())
    tail = (2, 24, 3, d, 0, int(causal), 77)
    assert a_dq[:5] == ins and a_dkv[:5] == ins
    assert a_dq[5] == a_dkv[5]  # one delta for both launches
    assert a_dq[6:] == (dq.data_ptr(),) + tail
    assert a_dkv[6:] == (dk.data_ptr(), dv.data_ptr()) + tail
    for g, like in zip((dq, dk, dv), (q, k, v)):
        assert g.shape == like.shape and g.dtype == torch.float32 and g.is_contiguous()
        assert g.data_ptr() % 16 == 0
    assert _counts() == (0, 0, 0, 0, 1, 1)


@pytest.mark.parametrize("failing", TF32X3)
def test_tf32x3_launch_failure_raises_without_simt_retry(kernel_path, failing):
    lib = kernel_path(_FakeLib(rc={failing: 1}))
    q, k, v, do, out = (torch.from_numpy(x) for x in _inputs(1, 16, 2, 64, seed=6, n=5))
    _build.reset_launch_counts()
    with pytest.raises(RuntimeError, match=f"{failing} launch failed"):
        tpa.flash_attention_bwd(q, k, v, out, torch.zeros(1, 2, 16), do)
    assert lib.names() == list(TF32X3[:TF32X3.index(failing) + 1])
    dq_ok = int(failing == TF32X3[1])
    assert _counts() == (0, 0, 0, 0, dq_ok, 0)


@pytest.mark.parametrize("d", [64, 128])
def test_autograd_through_the_tf32x3_kernel_path(kernel_path, d):
    """Training at fp32 D 64/128 launches the 3xTF32 forward with lse, then
    the 3xTF32 dq and dk/dv once each, and each kernel output lands on the
    right input's grad."""
    arrays = _inputs(1, 32, 2, d, seed=12)
    q, k, v, ct = (torch.from_numpy(x) for x in arrays)
    out, lse = tpa.flash_attention_reference(q, k, v, True, want_lse=True)
    dq, dk, dv = tpa.flash_attention_bwd_tf32x3_reference(q, k, v, out, lse, ct, True)
    lib = kernel_path(_FakeLib(dict(out=out, lse=lse, dq=dq, dk=dk, dv=dv)))
    _build.reset_launch_counts()
    qg, kg, vg = (x.clone().requires_grad_(True) for x in (q, k, v))
    got = tpa.flash_attention(qg, kg, vg, causal=True)
    torch.testing.assert_close(got, out, rtol=0, atol=0)
    got.backward(ct.transpose(1, 2).contiguous().transpose(1, 2))  # strided
    assert lib.names() == ["srt_flash_attn_fwd_tf32x3", *TF32X3]
    assert lib.calls[0][1][4] is not None  # training: the lse variant
    assert (_build.launches["srt_flash_attn_fwd"], _build.launches["srt_flash_attn_fwd_sm90"],
            _build.launches["srt_flash_attn_fwd_tf32x3"]) == (0, 0, 1)
    assert _counts() == (0, 0, 0, 0, 1, 1)
    for g, w in ((qg.grad, dq), (kg.grad, dk), (vg.grad, dv)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
