"""On-device partition / pack / merge ops of the shuffle compute path.

The PyTorch counterparts of the JAX package's ``ops/sort.py``, with the
same arguments, results and overflow contract:

- ``device_sort``: the exact device sort (``torch.sort``), the primitive
  under every other op here, and ``device_argsort``, its stable
  permutation,
- ``searchsorted``: run boundaries in a sorted key array,
- ``radix_partition``: destination partition from the key's top bits,
- ``split_sorted`` / ``split_sorted_edges``: partition an already-sorted
  key array into a [num_partitions, capacity] bucketed slab by slicing
  at range boundaries,
- ``pack_by_partition``: stable counting-sort layout of arbitrary
  (dest, value) pairs into the same slab shape,
- ``merge_received``: mask + sort of a received slab.

uint32 keys. PyTorch implements few operators for ``torch.uint32``
(no ``searchsorted``, ``>>``, ``minimum`` or comparisons), so this
module converts at its own boundary: a uint32 tensor is reinterpreted
as int32 and XORed with 0x80000000, which maps unsigned order onto
signed order; the op runs in int32 and the result is mapped back.
Data that only moves (slab fill, gathers) moves as its int32 bit
pattern. Callers keep handing in and getting back uint32 bytes that are
identical to the JAX package's.
"""

from __future__ import annotations

from typing import Tuple

import torch

_SIGN = -(1 << 31)  # the int32 bit pattern 0x80000000


def _ordered(x: torch.Tensor) -> torch.Tensor:
    """uint32 -> order-preserving int32; other dtypes unchanged."""
    if x.dtype == torch.uint32:
        return x.view(torch.int32) ^ _SIGN
    return x


def _unordered(y: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Inverse of :func:`_ordered` for a result that should be ``dtype``."""
    if dtype == torch.uint32:
        return (y ^ _SIGN).view(torch.uint32)
    return y


def _bits(x: torch.Tensor) -> torch.Tensor:
    """uint32 data as its int32 bit pattern (for moves, not compares)."""
    return x.view(torch.int32) if x.dtype == torch.uint32 else x


def _bits_scalar(v: int, dtype: torch.dtype) -> int:
    """A fill value in the representation :func:`_bits` uses."""
    if dtype == torch.uint32:
        v &= 0xFFFFFFFF
        return v - (1 << 32) if v >= (1 << 31) else v
    return v


def _from_bits(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return x.view(torch.uint32) if dtype == torch.uint32 else x


def device_sort(x: torch.Tensor) -> torch.Tensor:
    """The exact device sort: ascending along the last axis."""
    return _unordered(torch.sort(_ordered(x), dim=-1).values, x.dtype)


def device_argsort(x: torch.Tensor) -> torch.Tensor:
    """int64 indices of the stable ascending sort along the last axis
    (``jnp.argsort``'s contract: ties keep their input order)."""
    return torch.sort(_ordered(x), dim=-1, stable=True).indices


def searchsorted(sorted_seq: torch.Tensor, values: torch.Tensor,
                 side: str = "left") -> torch.Tensor:
    """int32 insertion points of ``values`` into ascending ``sorted_seq``
    (``jnp.searchsorted``'s contract; both of one dtype)."""
    values = values.to(sorted_seq.device)
    if values.dtype != sorted_seq.dtype:
        raise TypeError(
            f"searchsorted dtypes differ: {sorted_seq.dtype} vs {values.dtype}"
        )
    return torch.searchsorted(
        _ordered(sorted_seq).contiguous(), _ordered(values).contiguous(),
        right=(side == "right"), out_int32=True,
    )


def radix_partition(keys: torch.Tensor, num_partitions: int,
                    key_bits: int = 32) -> torch.Tensor:
    """Destination partition per key from its top log2(P) bits (int32).

    ``num_partitions`` must be a power of two."""
    if num_partitions & (num_partitions - 1):
        raise ValueError("num_partitions must be a power of two")
    shift = key_bits - (num_partitions.bit_length() - 1)
    if shift >= key_bits:
        return torch.zeros(keys.shape, dtype=torch.int32, device=keys.device)
    if keys.dtype == torch.uint32:
        # a logical shift: arithmetic shift of the bit pattern, then
        # mask off the copies of the sign bit
        return (keys.view(torch.int32) >> shift) & ((1 << (32 - shift)) - 1)
    return (keys >> shift).to(torch.int32)


def pack_by_partition(
    values: torch.Tensor, dest: torch.Tensor, num_partitions: int,
    capacity: int, fill: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Stable counting-sort scatter of ``values`` ``[n, ...]`` into fixed
    rows (one stable sort of ``dest``, whatever the trailing dims).

    Returns ``(slab [P, capacity, ...], counts [P], overflowed scalar
    bool)``. Rows hold each partition's values in input order, padded
    with ``fill``. A partition above ``capacity`` keeps its first
    ``capacity - 1`` values and its LAST value in the final slot (the
    clamped scatter of the JAX package, whose last write wins), and
    ``overflowed`` is set: callers retry with a larger capacity class.
    """
    n = values.shape[0]
    dev = values.device
    dest = dest.to(torch.int64)
    counts = torch.bincount(dest, minlength=num_partitions).to(torch.int32)
    overflowed = torch.any(counts > capacity)
    order = torch.argsort(dest, stable=True)
    sorted_vals = _bits(values)[order]
    sorted_dest = dest[order]
    starts = torch.cumsum(counts, 0, dtype=torch.int32) - counts
    rank = torch.arange(n, dtype=torch.int32, device=dev) - starts[sorted_dest]
    # one writer per slot: the clamped overflow slot takes the run's
    # last value, so the result is deterministic on every device
    keep = (rank < capacity - 1) | (rank == counts[sorted_dest] - 1)
    pos = torch.clamp(rank, max=capacity - 1).to(torch.int64)
    slab = torch.full(
        (num_partitions, capacity, *values.shape[1:]),
        _bits_scalar(fill, values.dtype),
        dtype=sorted_vals.dtype, device=dev,
    )
    slab[sorted_dest[keep], pos[keep]] = sorted_vals[keep]
    return (_from_bits(slab, values.dtype),
            torch.clamp(counts, max=capacity), overflowed)


def _slab_from_starts(sorted_keys: torch.Tensor, starts: torch.Tensor,
                      capacity: int, fill: int):
    """Rows ``sorted_keys[starts[e] : starts[e] + capacity]`` past the run
    ends filled with ``fill``, plus the run counts and overflow flag."""
    n = sorted_keys.shape[0]
    dev = sorted_keys.device
    ends = torch.cat([starts[1:], torch.tensor([n], dtype=torch.int32, device=dev)])
    counts = ends - starts
    overflowed = torch.any(counts > capacity)
    bits = _bits(sorted_keys)
    fill_bits = _bits_scalar(fill, sorted_keys.dtype)
    padded = torch.cat(
        [bits, torch.full((capacity,), fill_bits, dtype=bits.dtype, device=dev)]
    )
    col = torch.arange(capacity, dtype=torch.int64, device=dev)
    slab = padded[starts.to(torch.int64)[:, None] + col[None, :]]
    valid = col[None, :] < counts[:, None]
    slab = torch.where(valid, slab, torch.full_like(slab, fill_bits))
    return (_from_bits(slab, sorted_keys.dtype),
            torch.clamp(counts, max=capacity), overflowed)


def split_sorted(
    sorted_keys: torch.Tensor, num_partitions: int, capacity: int,
    key_bits: int = 32, fill: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Bucketed send slab from an ALREADY-SORTED key array: partition
    ``e`` owns keys in ``[e << shift, (e+1) << shift)``; the runs are
    found with a searchsorted against those edges, no scatter.

    Returns ``(slab [P, capacity], counts [P], overflowed)`` with
    :func:`pack_by_partition`'s semantics."""
    if num_partitions & (num_partitions - 1):
        raise ValueError("num_partitions must be a power of two")
    p = num_partitions
    shift = key_bits - (p.bit_length() - 1)
    edges = torch.tensor(
        [_bits_scalar(e << shift, sorted_keys.dtype) for e in range(1, p)],
        dtype=_bits(sorted_keys).dtype, device=sorted_keys.device,
    )
    edges = _from_bits(edges, sorted_keys.dtype)
    starts = torch.cat([
        torch.zeros((1,), dtype=torch.int32, device=sorted_keys.device),
        searchsorted(sorted_keys, edges),
    ])
    return _slab_from_starts(sorted_keys, starts, capacity, fill)


def split_sorted_edges(
    sorted_keys: torch.Tensor, edges: torch.Tensor, capacity: int,
    fill: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`split_sorted` with the range edges given: an ascending
    ``[P-1]`` tensor of the keys' dtype; partition ``e`` owns keys in
    ``[edges[e-1], edges[e])``. ``P`` need not be a power of two."""
    starts = torch.cat([
        torch.zeros((1,), dtype=torch.int32, device=sorted_keys.device),
        searchsorted(sorted_keys, edges),
    ])
    return _slab_from_starts(sorted_keys, starts, capacity, fill)


def merge_received(
    slab: torch.Tensor, counts: torch.Tensor, sentinel: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mask padding to ``sentinel`` and sort the flattened slab.

    Returns ``(sorted flat values, total valid count)``; valid entries
    occupy the prefix when ``sentinel`` is the dtype max."""
    p, cap = slab.shape
    col = torch.arange(cap, dtype=torch.int32, device=slab.device)
    valid = col[None, :] < counts.to(slab.device)[:, None]
    bits = _bits(slab)
    sent = torch.full_like(bits, _bits_scalar(sentinel, slab.dtype))
    flat = _from_bits(torch.where(valid, bits, sent), slab.dtype).reshape(-1)
    return device_sort(flat), counts.sum(dtype=torch.int32)
