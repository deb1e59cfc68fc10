"""Bucket classing and host-side block packing of the exchange plane.

The jax-free part of the JAX package's ``ops/exchange.py``: every
peer-to-peer block rides in a power-of-two bucket with its true length
beside it, and ragged row counts pad up to a power-of-two class, so one
program shape serves many stages. The all-to-all program itself waits
for the multi-GPU slice.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

MIN_BUCKET = 1024


def round_bucket(nbytes: int, lo: int = MIN_BUCKET, hi: int = 1 << 31) -> int:
    """Round a block size up to its power-of-two bucket class."""
    n = max(lo, min(hi, nbytes))
    return 1 << max(n - 1, 1).bit_length() if n > lo else lo


def round_rows(rows: int, lo: int = 1) -> int:
    """Round a row count up to its power-of-two class — the leading-axis
    twin of :func:`round_bucket`; pad rows carry a zero length."""
    n = max(lo, rows)
    return 1 << max(n - 1, 1).bit_length() if n > lo else lo


def pack_blocks(
    blocks: Sequence[bytes], block_bytes: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Pack one peer-block per row into a [E, block_bytes] send buffer
    plus its length-prefix vector. A block longer than the bucket is a
    caller bug."""
    e = len(blocks)
    out = np.zeros((e, block_bytes), dtype=np.uint8)
    counts = np.zeros((e,), dtype=np.int32)
    for i, b in enumerate(blocks):
        if len(b) > block_bytes:
            raise ValueError(f"block {i} ({len(b)}B) exceeds bucket {block_bytes}B")
        out[i, : len(b)] = np.frombuffer(b, dtype=np.uint8)
        counts[i] = len(b)
    return out, counts


def unpack_blocks(recv: np.ndarray, counts: np.ndarray) -> List[bytes]:
    """Inverse of :func:`pack_blocks` on the received side."""
    return [recv[i, : int(counts[i])].tobytes() for i in range(recv.shape[0])]
