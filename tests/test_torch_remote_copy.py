"""The wave pull's plain version against the JAX package's CPU-mesh
result: the zero host stack the JAX compiler assembles on TPU, landed
through ``emulated_wave_pull``. Ragged lengths, offsets, pad rows,
uint8 and uint32, one wave and two pipelined waves. On the CPU the
wrappers run the plain version and launch (and count) nothing."""

import jax
import numpy as np
import pytest
import torch

from sparkrdma_tpu.ops import remote_copy as jrc
from sparkrdma_tpu_torch.ops import remote_copy as trc

torch.set_num_threads(1)


def _rows(dtype, rows_b, bucket_elems, live, seed):
    """``live`` rows of (source slab bytes, byte offset, nbytes); offsets
    and lengths whole elements, some rows empty or bucket-full."""
    rng = np.random.default_rng(seed)
    item = np.dtype(dtype).itemsize
    rows = []
    for i in range(live):
        slab = rng.integers(0, 256, bucket_elems * item + 64 * item,
                            dtype=np.uint8)
        off = int(rng.integers(0, 64)) * item
        elems = [0, bucket_elems, int(rng.integers(1, bucket_elems))][i % 3]
        rows.append((slab, off, elems * item))
    return rows


def _jax_landed(dtype, rows_b, bucket_elems, rows):
    """The JAX compiler's TPU-branch assembly (collective.py) landed
    through the emulated mover."""
    item = np.dtype(dtype).itemsize
    stacked = np.zeros((rows_b, bucket_elems), dtype=dtype)
    for i, (slab, off, nb) in enumerate(rows):
        host = slab.view(dtype)
        stacked[i, : nb // item] = host[off // item : off // item + nb // item]
    return np.asarray(jrc.emulated_wave_pull(stacked, jax.devices()[0]))


def _torch_args(rows, rows_b):
    srcs = [torch.from_numpy(r[0]) for r in rows]
    return srcs, [r[1] for r in rows], [r[2] for r in rows]


CASES = [(1, 1, 256), (2, 2, 1024), (8, 5, 512), (64, 40, 256)]


@pytest.mark.parametrize("rows_b,live,bucket_elems", CASES)
@pytest.mark.parametrize("dtype", [np.uint8, np.uint32])
def test_single_wave_matches_jax(dtype, rows_b, live, bucket_elems):
    rows = _rows(dtype, rows_b, bucket_elems, live, seed=rows_b)
    want = _jax_landed(dtype, rows_b, bucket_elems, rows)
    srcs, offs, nbs = _torch_args(rows, rows_b)
    ref = trc.wave_pull_reference(srcs, offs, nbs, rows_b, bucket_elems, dtype)
    assert ref.shape == (1, rows_b, bucket_elems)
    np.testing.assert_array_equal(ref[0].numpy(), want)
    trc.reset_launch_counts()
    got = trc.wave_pull(srcs, offs, nbs, rows_b, bucket_elems, dtype)
    np.testing.assert_array_equal(got.numpy(), want)
    assert trc.wave_pull_launches == 0


@pytest.mark.parametrize("rows_b,live,bucket_elems", CASES[:3])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint32])
def test_two_pipelined_waves_match_jax(dtype, rows_b, live, bucket_elems):
    waves = [_rows(dtype, rows_b, bucket_elems, live, seed=s) for s in (3, 4)]
    want = np.stack([_jax_landed(dtype, rows_b, bucket_elems, w) for w in waves])
    srcs, offs, nbs = [], [], []
    for w in waves:
        s, o, n = _torch_args(w, rows_b)
        pad = rows_b - len(w)
        srcs += s + [None] * pad
        offs += o + [0] * pad
        nbs += n + [0] * pad
    trc.reset_launch_counts()
    got = trc.pipelined_wave_pull(srcs, offs, nbs, rows_b, bucket_elems,
                                  dtype, 2)
    assert got.shape == (2, rows_b, bucket_elems)
    np.testing.assert_array_equal(got.numpy(), want)
    assert trc.pipelined_wave_pull_launches == 0


def test_unaligned_byte_offsets():
    slab = np.arange(300, dtype=np.uint8)
    got = trc.wave_pull([torch.from_numpy(slab)], [3], [17], 2, 32, np.uint8)
    want = np.zeros((2, 32), np.uint8)
    want[0, :17] = slab[3:20]
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("bad", ["past_slab", "over_bucket", "pad_bytes",
                                 "too_many_rows", "other_device"])
def test_row_checks(bad):
    src = torch.zeros(64, dtype=torch.uint8)
    args = {
        "past_slab": ([src], [60], [8], 1, 16),
        "over_bucket": ([src], [0], [17], 1, 16),
        "pad_bytes": ([None], [0], [4], 1, 16),
        "too_many_rows": ([src, src], [0, 0], [1, 1], 1, 16),
        "other_device": ([src], [0], [1], 1, 16),
    }[bad]
    kw = {"device": "meta"} if bad == "other_device" else {}
    with pytest.raises(ValueError):
        trc.wave_pull(*args, np.uint8, **kw)


def test_emulated_pull_is_an_independent_copy():
    src = torch.arange(8, dtype=torch.int32)
    pulled = trc.pull_block(src, torch.device("cpu"))
    src.zero_()
    np.testing.assert_array_equal(pulled.numpy(), np.arange(8))
    stack = trc.emulated_wave_pull(torch.ones(2, 4), torch.device("cpu"))
    assert stack.shape == (2, 4)
