"""float16 inputs, the ``precision=`` argument and the per-device kernel
configuration of the port's flash attention.

- float16 forward and backward against the JAX package's Pallas kernels
  in interpret mode (f32 inside, as the port's plain versions), at the
  bf16 tolerance 1e-2 / 1e-2 (float16 outputs round to a finer step, so
  the tolerance has room).
- ``precision`` picks the kernel before the launch (a fake kernel library
  records it): bf16 at ``"default"`` (the JAX default for bf16) takes the
  tensor-core kernels, ``"high"`` and ``"highest"`` the SIMT ones;
  float32 and float16 take the SIMT kernels at every precision.
- Each kernel's dynamic shared-memory limit is raised once per device,
  not once per process: no launcher keeps a process-wide flag.
"""

import contextlib
import pathlib
import re
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
CSRC = pathlib.Path(tpa.__file__).resolve().parent / "csrc"


def _inputs(b, s, h, d, seed, n=4):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, s, h, d)).astype(np.float32) for _ in range(n)]


# ----------------------------------------------------------------------
# float16 against the JAX kernels
# ----------------------------------------------------------------------
@pytest.mark.parametrize("causal", [False, True])
def test_float16_forward_matches_jax_kernel(causal):
    arrays = _inputs(1, 77, 2, 64, seed=60 + causal, n=3)
    want = jpa.flash_attention(*(jnp.asarray(x, jnp.float16) for x in arrays),
                               causal=causal, interpret=True)
    q, k, v = (torch.from_numpy(x).half() for x in arrays)
    out, lse = tpa.flash_attention_fwd(q, k, v, causal, want_lse=True)
    assert out.dtype == torch.float16 and lse.dtype == torch.float32
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(want.astype(jnp.float32)), **BF16_TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_float16_backward_matches_jax_vjp(causal):
    arrays = _inputs(1, 77, 2, 64, seed=70 + causal)
    jq, jk, jv, jct = (jnp.asarray(x, jnp.float16) for x in arrays)
    _, vjp = jax.vjp(lambda q, k, v: jpa.flash_attention(
        q, k, v, causal=causal, interpret=True), jq, jk, jv)
    want = [np.asarray(g.astype(jnp.float32)) for g in vjp(jct)]
    q, k, v, ct = (torch.from_numpy(x).half() for x in arrays)
    for x in (q, k, v):
        x.requires_grad_(True)
    tpa.flash_attention(q, k, v, causal=causal).backward(ct)
    for name, x, w in zip(("dq", "dk", "dv"), (q, k, v), want):
        assert x.grad.dtype == torch.float16
        np.testing.assert_allclose(x.grad.float().numpy(), w, **BF16_TOL, err_msg=name)


# ----------------------------------------------------------------------
# precision
# ----------------------------------------------------------------------
@pytest.mark.parametrize("dtype,want", [(torch.float32, "highest"),
                                        (torch.bfloat16, "default"),
                                        (torch.float16, "default")])
def test_precision_none_picks_as_jax_does(dtype, want):
    assert tpa.resolve_precision(None, dtype) == want
    for p in tpa.PRECISIONS:
        assert tpa.resolve_precision(p, dtype) == p


@pytest.mark.parametrize("bad", ["low", "HIGHEST", "bfloat16_3x", 1, 0.5])
def test_bad_precision_raises(bad):
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(1, 16, 2, 8, seed=3))
    out, lse = tpa.flash_attention_fwd(q, k, v, want_lse=True)
    with pytest.raises(ValueError, match="precision"):
        tpa.flash_attention(q, k, v, precision=bad)
    with pytest.raises(ValueError, match="precision"):
        tpa.flash_attention_fwd(q, k, v, precision=bad)
    with pytest.raises(ValueError, match="precision"):
        tpa.flash_attention_bwd(q, k, v, out, lse, do, precision=bad)


def test_precision_leaves_the_cpu_path_unchanged():
    """On the CPU every precision runs the plain version in f32."""
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16)
               for x in _inputs(1, 40, 2, 64, seed=4, n=3))
    outs = [tpa.flash_attention(q, k, v, causal=True, precision=p)
            for p in (None, *tpa.PRECISIONS)]
    for out in outs[1:]:
        assert torch.equal(out, outs[0])


class _FakeLib:
    """Records each launch's entry point and arguments; returns 0."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith("srt_flash_attn"):
            raise AttributeError(name)
        return lambda *args: self.calls.append((name, args)) or 0

    def names(self):
        return [name for name, _ in self.calls]


@pytest.fixture
def fake_lib(monkeypatch):
    lib = _FakeLib()
    monkeypatch.setattr(tpa, "_kernel_path", lambda q: True)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: types.SimpleNamespace(cuda_stream=77))
    monkeypatch.setattr(_build, "load", lambda: lib)
    return lib


ROUTES = {
    "sm90": ["srt_flash_attn_fwd_sm90", "srt_flash_attn_bwd_dq_sm90",
             "srt_flash_attn_bwd_dkv_sm90"],
    "simt": ["srt_flash_attn_fwd", "srt_flash_attn_bwd_dq", "srt_flash_attn_bwd_dkv"],
}


@pytest.mark.parametrize("precision,route", [(None, "sm90"), ("default", "sm90"),
                                             ("high", "simt"), ("highest", "simt")])
def test_precision_routes_bf16(fake_lib, precision, route):
    q, k, v, do, out = (torch.from_numpy(x).to(torch.bfloat16)
                        for x in _inputs(1, 24, 2, 128, seed=5, n=5))
    lse = torch.zeros(1, 2, 24)
    tpa.flash_attention_fwd(q, k, v, True, precision=precision)
    tpa.flash_attention_bwd(q, k, v, out, lse, do, True, precision=precision)
    assert fake_lib.names() == ROUTES[route]
    assert tpa.fwd_entry(q, k, v, out, precision) == ROUTES[route][0]
    assert list(tpa.bwd_entry(q, k, v, do, q, k, v, precision)) == ROUTES[route][1:]


@pytest.mark.parametrize("precision", [None, *tpa.PRECISIONS])
@pytest.mark.parametrize("dtype,code", [(torch.float32, 0), (torch.float16, 2)])
def test_float32_and_float16_take_simt_at_every_precision(fake_lib, dtype, code,
                                                         precision):
    q, k, v, do, out = (torch.from_numpy(x).to(dtype)
                        for x in _inputs(2, 24, 3, 64, seed=6, n=5))
    tpa.flash_attention_fwd(q, k, v, False, precision=precision)
    tpa.flash_attention_bwd(q, k, v, out, torch.zeros(2, 3, 24), do, False,
                            precision=precision)
    assert fake_lib.names() == ROUTES["simt"]
    for _, args in fake_lib.calls:  # (..., B, S, H, D, dtype, causal, stream)
        assert args[-7:] == (2, 24, 3, 64, code, 0, 77)


def test_autograd_keeps_the_precision_for_the_backward(fake_lib):
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True)
               for x in _inputs(1, 16, 2, 64, seed=7, n=3))
    tpa.flash_attention(q, k, v, causal=True, precision="highest").sum().backward()
    assert fake_lib.names() == ROUTES["simt"]
    fake_lib.calls.clear()
    for x in (q, k, v):
        x.grad = None
    tpa.flash_attention(q, k, v, causal=True).sum().backward()
    assert fake_lib.names() == ROUTES["sm90"]


# ----------------------------------------------------------------------
# the shared-memory limit is raised per device
# ----------------------------------------------------------------------
def test_no_process_wide_kernel_configuration_flag():
    sources = {p.name: p.read_text() for p in sorted(CSRC.glob("*.cu*"))}
    launchers = [n for n, s in sources.items() if "MaxDynamicSharedMemorySize" in s
                 or "raise_smem_limit(" in s]
    assert "flash_attn_bwd_sm90.cu" in launchers
    for name, src in sources.items():
        assert not re.search(r"static\s+bool", src), name
        assert "configured" not in src, name
        if name != "launch_config.cuh":
            # the attribute is set only through the per-device helper
            assert not re.search(r"cudaFuncSetAttribute\s*\(", src), name
    helper = sources["launch_config.cuh"]
    assert "cudaGetDevice" in helper and "cudaFuncSetAttribute" in helper
    # every launcher over 48 KiB: flash_attn_{fwd,bwd}{,_sm90}.cu
    for name in ("flash_attn_fwd.cu", "flash_attn_bwd.cu", "flash_attn_fwd_sm90.cu",
                 "flash_attn_bwd_sm90.cu"):
        n_launch = len(re.findall(r"<<<", sources[name]))
        assert sources[name].count("raise_smem_limit(") == n_launch, name
