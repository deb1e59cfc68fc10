"""The training path as a whole: the port's TransformerStep for one shard
against the JAX package's TransformerStep on a one-device mesh
(``tests/test_torch_transformer_mesh.py`` takes it over meshes) (the
Pallas flash kernel in interpret mode under "ulysses"), and the port's
reference_step against JAX's. The same numpy parameters and data go to
both. Tolerances are the JAX package's own train-step test's: loss rtol
1e-5, parameters rtol 1e-4 / atol 1e-6 (f32 sums in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparkrdma_tpu.models import transformer_step as jts
from sparkrdma_tpu_torch.convert import params_from_jax, params_to_jax
from sparkrdma_tpu_torch.models import transformer_step as tts
from sparkrdma_tpu_torch.ops import _build
from sparkrdma_tpu_torch.parallel import mesh as tmesh

torch.set_num_threads(1)

LOSS_RTOL = 1e-5
PARAM_TOL = dict(rtol=1e-4, atol=1e-6)
# d_model 32, 4 heads, d_hidden 64, b 2, s 64
D_MODEL, HEADS, D_HIDDEN, B, S = 32, 4, 64, 2, 64


def _data(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, S, D_MODEL)).astype(np.float32)
    y = rng.normal(size=(B, S, D_MODEL)).astype(np.float32)
    return x, y


def _params(seed=0):
    return jts.init_params(D_MODEL, HEADS, D_HIDDEN, tp=1, seed=seed)


def _assert_params_close(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]),
                                   **PARAM_TOL, err_msg=f"param {k}")


@pytest.mark.parametrize("shape", [(32, 4, 64, 1, 0), (512, 8, 2048, 1, 0),
                                   (16, 4, 32, 2, 5)])
def test_init_params_byte_equal_to_jax(shape):
    d_model, heads, d_hidden, tp, seed = shape
    want = jts.init_params(d_model, heads, d_hidden, tp, seed=seed)
    got = tts.init_params(d_model, heads, d_hidden, tp, seed=seed)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        assert got[k].tobytes() == want[k].tobytes()


def test_params_from_jax_round_trip():
    params = _params(seed=3)
    ported = params_from_jax(params, device="cpu")
    for k, w in params.items():
        assert ported[k].device.type == "cpu"
        assert ported[k].dtype == torch.float32 and tuple(ported[k].shape) == w.shape
        np.testing.assert_array_equal(ported[k].numpy(), w)
    back = params_to_jax(ported)
    assert all(back[k].tobytes() == params[k].tobytes() for k in params)
    # copies both ways: updating the port's tensors touches neither side
    before = params["wq"].copy()
    ported["wq"] += 1
    np.testing.assert_array_equal(params["wq"], before)
    np.testing.assert_array_equal(back["wq"], before)


@pytest.mark.parametrize("attn", ["ulysses", "ring"])
def test_step_matches_jax(attn):
    params = _params()
    x, y = _data()
    mesh = jts.make_training_mesh(jax.devices()[:1])
    jstep = jts.TransformerStep(mesh, n_heads=HEADS, lr=0.1, attn=attn)
    want_loss, want = jstep.step(*jstep.place(params, x, y))

    _build.reset_launch_counts()
    step = tts.TransformerStep(n_heads=HEADS, lr=0.1, attn=attn, device="cpu")
    loss, new = step.step(params_from_jax(params, device="cpu"), x, y)
    assert loss.shape == () and loss.dtype == torch.float32
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=LOSS_RTOL)
    _assert_params_close(params_to_jax(new), want)
    # on the CPU the flash wrappers run their plain versions
    assert not _build.launches


def test_schedules_agree_with_reference_step():
    params = _params(seed=1)
    x, y = _data(seed=1)
    ref_loss, ref_new = tts.reference_step(params, x, y, HEADS, 0.1)
    for attn in ("ulysses", "ring"):
        step = tts.TransformerStep(n_heads=HEADS, lr=0.1, attn=attn, device="cpu")
        loss, new = step.step(params, x, y)
        np.testing.assert_allclose(float(loss), float(ref_loss), rtol=LOSS_RTOL)
        _assert_params_close(params_to_jax(new), params_to_jax(ref_new))


def test_reference_step_matches_jax():
    params = _params(seed=2)
    x, y = _data(seed=2)
    want_loss, want = jts.reference_step(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x),
        jnp.asarray(y), n_heads=HEADS, lr=0.1)
    loss, new = tts.reference_step(params, x, y, HEADS, 0.1)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=LOSS_RTOL)
    _assert_params_close(params_to_jax(new), want)


def test_run_steps_equals_stepwise():
    params = _params(seed=2)
    x, y = _data(seed=2)
    step = tts.TransformerStep(n_heads=HEADS, lr=0.1, attn="ulysses", device="cpu")
    l1, p1 = step.step(params, x, y)
    l2, p2 = step.step(p1, x, y)
    l_loop, p_loop = step.run_steps(params, x, y, 2)
    assert float(l_loop) == float(l2) and float(l1) != float(l2)
    for k in p2:
        assert torch.equal(p_loop[k], p2[k]), k
    l0, p0 = step.run_steps(params, x, y, 0)
    assert float(l0) == 0.0
    assert all(np.array_equal(p0[k].numpy(), params[k]) for k in params)


@pytest.mark.parametrize("attn", ["ulysses", "ring"])
def test_loss_decreases_over_steps(attn):
    params = tts.init_params(16, 4, 32, tp=1, seed=1)
    rng = np.random.default_rng(1)
    x, y = (rng.normal(size=(4, 16, 16)).astype(np.float32) for _ in range(2))
    step = tts.TransformerStep(n_heads=4, lr=0.2, attn=attn, device="cpu")
    params, x, y = step.place(params, x, y)
    losses = []
    for _ in range(5):
        loss, params = step.step(params, x, y)
        losses.append(float(loss))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]


def test_gelu_is_jax_default_tanh_form():
    xs = np.linspace(-6, 6, 4001, dtype=np.float32)
    want = np.asarray(jax.nn.gelu(jnp.asarray(xs)))
    got = tts.gelu(torch.from_numpy(xs)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    # the exact erf form is a different function at this tolerance
    exact = torch.nn.functional.gelu(torch.from_numpy(xs)).numpy()
    assert np.abs(exact - want).max() > 1e-4


def test_block_parameters_keep_jax_shapes_and_storage():
    ported = params_from_jax(_params(), device="cpu")
    block = tts.TransformerBlock(ported, HEADS, "ring")
    for name, p in block.named_parameters():
        assert tuple(p.shape) == tuple(ported[name].shape)
        assert p.data_ptr() == ported[name].data_ptr()  # shared, not copied
    x = torch.from_numpy(_data()[0])
    assert block(x).shape == x.shape


def test_wider_than_one_rank_raises():
    """A mesh wider than one shard runs (``tests/test_torch_transformer_mesh.py``
    holds it against JAX); shards on several CUDA devices wait for the
    multi-GPU slice; the JAX step's own checks hold."""
    with pytest.raises(NotImplementedError, match="multi-GPU slice"):
        tts.TransformerStep(tts.make_training_mesh(["cuda:0", "cuda:1"]))
    with pytest.raises(NotImplementedError, match="multi-GPU slice"):
        tts.TransformerStep(tmesh.named_mesh(["cuda:0", "cuda:1"], tts.AXES, (2, 1, 1)),
                            attn="ulysses")
    sp2 = tmesh.named_mesh(["cpu"] * 2, tts.AXES, (1, 2, 1))
    with pytest.raises(ValueError, match="divisible"):
        tts.TransformerStep(sp2, n_heads=3, attn="ulysses")
    with pytest.raises(ValueError, match="unknown attn"):
        tts.TransformerStep(attn="dense", device="cpu")
    with pytest.raises(ValueError, match="axes"):
        tts.TransformerStep(tmesh.make_mesh(["cpu"] * 2))
    step = tts.TransformerStep(sp2, n_heads=HEADS, lr=0.1)
    assert step.mesh.shape == {"dp": 1, "sp": 2, "tp": 1}
    params = _params(seed=4)
    x, y = _data(seed=4)
    ref_loss, _ = tts.reference_step(params, x, y, HEADS, 0.1)
    loss, new = step.step(params, x, y)
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=LOSS_RTOL)
    assert {k: tuple(v.shape) for k, v in new.items()} == {
        k: v.shape for k, v in params.items()}
