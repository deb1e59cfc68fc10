"""The (dp, sp, tp) training step over a ShardMesh (dryrun section 2b):
the port's TransformerStep on ``make_training_mesh(["cpu"] * n)`` against
the JAX package's TransformerStep on ``make_training_mesh(jax.devices()[:n])``
of the conftest's 8 CPU devices, and against ``reference_step``, with the
same numpy parameters and data. Bounds are the JAX tests' own
(``tests/test_transformer_step.py``): loss rtol 1e-6, parameters rtol
1e-5 / atol 1e-7 for the ring and 1e-4 / 1e-6 for Ulysses (the flash
kernel sums in another order). One case per isolated axis: ``(1, 1, 2)``
fails on a wrong tp adjoint (w1 and w2 off by exactly tp), ``(1, 2, 1)``
on the sp exchanges' adjoints, ``(2, 1, 1)`` on the gradient reduction.
Then the CUDA branch on the CPU through a fake library: a Ulysses step
launches one flash forward, one dq and one dk/dv kernel, a ring step on
(2, 2, 2) four ``srt_neighbor_pull`` (k and v, forward and backward)."""

import collections
import contextlib
import ctypes
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from sparkrdma_tpu.models import transformer_step as jts
from sparkrdma_tpu_torch.models import transformer_step as tts
from sparkrdma_tpu_torch.ops import _build
from sparkrdma_tpu_torch.ops import pallas_attention as tpa
from sparkrdma_tpu_torch.ops import remote_copy as trc
from sparkrdma_tpu_torch.parallel import named_mesh, shard

torch.set_num_threads(1)

LOSS_RTOL = 1e-6
PARAM_TOL = {"ring": dict(rtol=1e-5, atol=1e-7), "ulysses": dict(rtol=1e-4, atol=1e-6)}
GRAD_REL = 1e-5  # of each gradient's largest value
D_MODEL, HEADS, D_HIDDEN, S = 16, 4, 32, 16


def _data(b, seed=0, s=S):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, s, D_MODEL)).astype(np.float32) for _ in range(2)]


def _params(seed=0):
    return jts.init_params(D_MODEL, HEADS, D_HIDDEN, tp=1, seed=seed)


def _meshes(shape):
    """The JAX and port meshes of one ``(dp, sp, tp)`` shape."""
    n = math.prod(shape)
    jmesh = Mesh(np.array(jax.devices()[:n]).reshape(shape), ("dp", "sp", "tp"))
    return jmesh, named_mesh(["cpu"] * n, ("dp", "sp", "tp"), shape)


def _jax_step(jmesh, attn, params, x, y):
    step = jts.TransformerStep(jmesh, n_heads=HEADS, lr=0.1, attn=attn)
    loss, new = step.step(*step.place(params, jnp.asarray(x), jnp.asarray(y)))
    return float(loss), {k: np.asarray(v) for k, v in new.items()}


def _check(loss, new, want_loss, want, attn):
    np.testing.assert_allclose(float(loss), want_loss, rtol=LOSS_RTOL)
    assert sorted(new) == sorted(want)
    for k in want:
        got = new[k].detach().numpy()
        assert got.shape == want[k].shape, k
        np.testing.assert_allclose(got, want[k], **PARAM_TOL[attn], err_msg=f"param {k}")


def _reference(params, x, y):
    loss, new = tts.reference_step(params, x, y, HEADS, 0.1)
    return float(loss), {k: v.numpy() for k, v in new.items()}


# ----------------------------------------------------------------------
@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 8])
def test_make_training_mesh_is_the_jax_rule(n):
    want = jts.make_training_mesh(jax.devices()[:n])
    got = tts.make_training_mesh(["cpu"] * n)
    assert got.axis_names == tuple(want.axis_names) == ("dp", "sp", "tp")
    assert got.shape == dict(want.shape)
    assert got.num_shards == want.devices.size


def test_make_training_mesh_past_eight_shards():
    assert tts.make_training_mesh(["cpu"] * 12).axis_sizes == (3, 2, 2)
    assert tts.make_training_mesh(["cpu"] * 16).axis_sizes == (4, 2, 2)
    assert tts.make_training_mesh(["cpu"] * 10).axis_sizes == (5, 2, 1)
    assert tts.make_training_mesh(["cpu"] * 7).axis_sizes == (1, 1, 1)


@pytest.mark.parametrize("attn", ["ring", "ulysses"])
@pytest.mark.parametrize("n", [8, 6])
def test_step_on_the_training_mesh_matches_jax(n, attn):
    """8 shards are (2, 2, 2), 6 are (3, 2, 1); the batch scales with dp
    as in the dryrun."""
    tmesh = tts.make_training_mesh(["cpu"] * n)
    jmesh = jts.make_training_mesh(jax.devices()[:n])
    assert tmesh.axis_sizes == tuple(jmesh.shape.values())
    params = _params(seed=n)
    x, y = _data(4 * tmesh.shape["dp"], seed=n)
    want_loss, want = _jax_step(jmesh, attn, params, x, y)
    step = tts.TransformerStep(tmesh, n_heads=HEADS, lr=0.1, attn=attn)
    loss, new = step.step(params, x, y)
    assert loss.shape == () and loss.dtype == torch.float32
    _check(loss, new, want_loss, want, attn)
    _check(loss, new, *_reference(params, x, y), attn)


@pytest.mark.parametrize("shape", [(1, 1, 2), (1, 2, 1), (2, 1, 1)])
def test_isolated_axis_matches_jax(shape):
    jmesh, tmesh = _meshes(shape)
    params = _params(seed=7)
    x, y = _data(4, seed=7)
    ref = _reference(params, x, y)
    for attn in ("ring", "ulysses"):
        loss, new = tts.TransformerStep(tmesh, n_heads=HEADS, lr=0.1,
                                        attn=attn).step(params, x, y)
        _check(loss, new, *_jax_step(jmesh, attn, params, x, y), attn)
        _check(loss, new, *ref, attn)


def _reference_grads(params, x, y):
    """The gradients of the whole batch's sum of squares under the JAX
    ``reference_step``: its new parameters are ``p - lr * g`` with ``g``
    the mean's gradient, so ``-d new / d lr`` is ``g`` exactly."""
    _, tan = jax.jvp(
        lambda lr: jts.reference_step(params, jnp.asarray(x), jnp.asarray(y), HEADS, lr)[1],
        (jnp.float32(0.0),), (jnp.float32(1.0),))
    return {k: -np.asarray(v) * x.size for k, v in tan.items()}


@pytest.mark.parametrize("attn", ["ring", "ulysses"])
@pytest.mark.parametrize("shape", [(1, 1, 2), (1, 2, 1), (2, 1, 1), (2, 2, 2), (3, 2, 1)])
def test_gradients_on_every_shard_match_jax_reference(shape, attn):
    """Every shard's copy of the gradients, held against the reference's
    laid out as the parameters are: the new parameters hide them (``lr *
    g`` is far below their tolerance), so a wrong tp adjoint, a dropped
    dp or sp shard or a wrong exchange adjoint shows here."""
    _, tmesh = _meshes(shape)
    params = _params(seed=5)
    x, y = _data(4 * shape[0], seed=5)
    want = _reference_grads(params, x, y)
    got = tts.TransformerStep(tmesh, n_heads=HEADS, lr=0.1, attn=attn).gradients(params, x, y)
    assert sorted(got) == sorted(want)
    for k in want:
        w = shard(tmesh, torch.from_numpy(want[k]), tts.PARAM_SPECS[k])
        assert got[k].shape == w.shape, k
        rel = float((got[k] - w).abs().max()) / float(np.abs(want[k]).max())
        assert rel <= GRAD_REL, f"grad {k} off by {rel} of its largest value"


@pytest.mark.parametrize("attn", ["ring", "ulysses"])
def test_run_steps_equals_stepwise(attn):
    tmesh = tts.make_training_mesh(["cpu"] * 8)
    params = _params(seed=2)
    x, y = _data(8, seed=2)
    step = tts.TransformerStep(tmesh, n_heads=HEADS, lr=0.1, attn=attn)
    l1, p1 = step.step(params, x, y)
    l2, p2 = step.step(p1, x, y)
    l_loop, p_loop = step.run_steps(params, x, y, 2)
    assert float(l_loop) == float(l2) and float(l1) != float(l2)
    for k in p2:
        assert torch.equal(p_loop[k], p2[k]), k
    l0, p0 = step.run_steps(params, x, y, 0)
    assert float(l0) == 0.0
    assert all(np.array_equal(p0[k].numpy(), params[k]) for k in params)


def test_loss_decreases_over_steps_on_the_mesh():
    tmesh = tts.make_training_mesh(["cpu"] * 8)
    params = tts.init_params(D_MODEL, HEADS, D_HIDDEN, tp=2, seed=1)
    x, y = _data(8, seed=1)
    for attn in ("ring", "ulysses"):
        step = tts.TransformerStep(tmesh, n_heads=HEADS, lr=0.2, attn=attn)
        p, losses = params, []
        for _ in range(4):
            loss, p = step.step(p, x, y)
            losses.append(float(loss))
        assert all(np.isfinite(losses)) and losses[-1] < losses[0], attn


def test_true_tp_adjoint_would_scale_w1_w2_by_tp(monkeypatch):
    """The reason for ``_TpPsum``'s identity backward: with the true
    adjoint of the sum (its ``sum(dim=tp)``) the w1/w2 updates come out
    exactly tp times too large."""
    jmesh, tmesh = _meshes((1, 1, 2))
    params = _params(seed=9)
    x, y = _data(4, seed=9)
    _, want = _jax_step(jmesh, "ring", params, x, y)
    monkeypatch.setattr(tts, "_tp_psum", tts._tp_all_reduce)
    _, new = tts.TransformerStep(tmesh, n_heads=HEADS, lr=0.1).step(params, x, y)
    for k in ("w1", "w2"):
        np.testing.assert_allclose(new[k].numpy() - params[k],
                                   2 * (want[k] - params[k]), rtol=1e-4, atol=1e-8)


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


@pytest.mark.parametrize("attn", ["ring", "ulysses"])
def test_kernel_branch_step_launches(kernel_path, attn):
    """On (2, 2, 2) at the workload's head dim (64): Ulysses one launch
    each of the 3xTF32 forward, dq and dk/dv a step; the ring four
    neighbor pulls a step. Both still match the JAX step."""
    d_model, heads = 128, 2
    params = jts.init_params(d_model, heads, 64, tp=1, seed=3)
    rng = np.random.default_rng(3)
    x, y = (rng.normal(size=(4, 16, d_model)).astype(np.float32) for _ in range(2))
    jstep = jts.TransformerStep(jts.make_training_mesh(jax.devices()[:8]),
                                n_heads=heads, lr=0.1, attn=attn)
    want_loss, want = jstep.step(*jstep.place(params, jnp.asarray(x), jnp.asarray(y)))
    step = tts.TransformerStep(tts.make_training_mesh(["cpu"] * 8), n_heads=heads,
                               lr=0.1, attn=attn)
    _build.reset_launch_counts()
    loss, new = step.step(params, x, y)
    assert _build.launches == collections.Counter(kernel_path.calls)
    if attn == "ring":
        assert kernel_path.calls == ["srt_neighbor_pull"] * 4
    else:
        assert kernel_path.calls == ["srt_flash_attn_fwd_tf32x3",
                                     "srt_flash_attn_bwd_dq_tf32x3",
                                     "srt_flash_attn_bwd_dkv_tf32x3"]
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=LOSS_RTOL)
    for k in want:
        np.testing.assert_allclose(new[k].numpy(), np.asarray(want[k]),
                                   **PARAM_TOL[attn], err_msg=f"param {k}")
