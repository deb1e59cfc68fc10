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
- ``radix_pack_pairs``: the hash join's pack, ``radix_partition`` and
  two ``pack_by_partition`` calls (keys and payloads) for every shard of
  an ``[E, n]`` stack at once, at 4-byte rows (uint32 keys, int32
  payloads) or 8-byte rows (uint64, int64). On CUDA it launches the
  hand-written ``srt_radix_pack`` or ``srt_radix_pack64``
  (``csrc/radix_pack.cu``, one template, a library of its own); on the
  CPU it runs :func:`radix_pack_pairs_reference`, the plain
  version; nothing falls back. Each launch counts in
  ``_build.launches``. PageRank's bucketing packs by it too;
  ``pack_by_partition`` stays the plain op of any ``dest`` (ALS, and
  PageRank's meshes beyond the kernel),
- ``merge_received``: mask + sort of a received slab, any slab,
- ``merge_sorted_runs``: the SPMD sort's merge of ``[E, R, cap]``
  received runs, each already sorted in its valid prefix, for every
  shard at once. On CUDA it launches the hand-written ``srt_merge_runs``
  (``csrc/merge_runs.cu``, a library of its own: pairwise merge-path
  passes that use the slab as their scratch); on the CPU it runs
  :func:`merge_sorted_runs_reference`, ``merge_received`` shard by
  shard; nothing falls back,
- ``probe_sorted``: the hash join's probe of its sorted build side, for
  every shard at once, at 4- or 8-byte rows: the lower bound of each
  valid probe slot's key in its shard's build row, the key there
  compared, the payload taken or ``miss``. On CUDA it launches the
  hand-written ``srt_sorted_probe`` or ``srt_sorted_probe64``
  (``csrc/sorted_probe.cu``, one template, a library of its own: a
  per-shard key directory, then a search of one directory bucket a
  probe); on the CPU it runs :func:`probe_sorted_reference`, the plain
  version (``searchsorted``, the clamp, two gathers, the masks and the
  where); nothing falls back,
- ``device_put_columns``: the columns of one columnar block (DESIGN.md
  §25), each staged to the device by one host-to-device copy.

uint32 and uint64 keys. PyTorch implements few operators for
``torch.uint32`` and ``torch.uint64`` (no ``searchsorted``, ``>>``,
``minimum`` or comparisons), so this module converts at its own
boundary: an unsigned tensor is reinterpreted as the signed type of its
width and XORed with the sign bit (0x80000000, 2^63), which maps
unsigned order onto signed order; the op runs in int32 or int64 and the
result is mapped back. Data that only moves (slab fill, gathers) moves
as its signed bit pattern. Callers keep handing in and getting back
uint32 bytes that are identical to the JAX package's.
"""

from __future__ import annotations

import ctypes
from typing import List, Tuple

import numpy as np
import torch

from sparkrdma_tpu_torch.ops import _build
from sparkrdma_tpu_torch.utils.torch_compat import resolve_device, torch_dtype

_SIGN = -(1 << 31)  # the int32 bit pattern 0x80000000
# unsigned key dtype -> (the signed dtype of its bit pattern, its sign bit
# there, its width in bits)
_UNSIGNED = {torch.uint32: (torch.int32, _SIGN, 32),
             torch.uint64: (torch.int64, -(1 << 63), 64)}
# the pack's two row widths: key dtype -> payload dtype
_PACK_ROWS = {torch.uint32: torch.int32, torch.uint64: torch.int64}
_PACK_SYMBOL = {torch.uint32: "srt_radix_pack", torch.uint64: "srt_radix_pack64"}
_PROBE_SYMBOL = {torch.uint32: "srt_sorted_probe", torch.uint64: "srt_sorted_probe64"}
RADIX_PACK_MAX_PARTITIONS = 256  # the kernel's per-block histogram
MERGE_RUNS_MAX_RUNS = 1024  # srt_merge_runs: a shard's runs summed in one block
MERGE_RUNS_MAX_SLOTS = 2**31 - 1  # R * cap: int32 places in a shard's row


def _ordered(x: torch.Tensor) -> torch.Tensor:
    """uint32 / uint64 -> order-preserving int32 / int64; other dtypes
    unchanged."""
    if x.dtype in _UNSIGNED:
        bits, sign, _ = _UNSIGNED[x.dtype]
        return x.view(bits) ^ sign
    return x


def _unordered(y: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Inverse of :func:`_ordered` for a result that should be ``dtype``."""
    if dtype in _UNSIGNED:
        return (y ^ _UNSIGNED[dtype][1]).view(dtype)
    return y


def _bits(x: torch.Tensor) -> torch.Tensor:
    """uint32 / uint64 data as its int32 / int64 bit pattern (for moves,
    not compares)."""
    return x.view(_UNSIGNED[x.dtype][0]) if x.dtype in _UNSIGNED else x


def _bits_scalar(v: int, dtype: torch.dtype) -> int:
    """A fill value in the representation :func:`_bits` uses."""
    if dtype in _UNSIGNED:
        width = _UNSIGNED[dtype][2]
        v &= (1 << width) - 1
        return v - (1 << width) if v >= (1 << (width - 1)) else v
    return v


def _from_bits(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return x.view(dtype) if dtype in _UNSIGNED else x


def _host_tensor(col: np.ndarray) -> torch.Tensor:
    """A CPU tensor over ``col``'s memory, never a copy of it. Fetched
    frames are often read-only (registered slices, mapped windows), and
    ``torch.from_numpy`` / ``torch.frombuffer`` warn on a read-only
    buffer; the tensor here only feeds one copy and is never written
    through, so a read-only column is aliased by address instead. The
    caller keeps ``col`` alive until that copy has run."""
    dtype = torch_dtype(col.dtype)
    if col.size == 0:
        return torch.empty((0,), dtype=dtype)
    if col.flags.writeable:
        return torch.from_numpy(col)
    raw = (ctypes.c_uint8 * col.nbytes).from_address(col.ctypes.data)
    return torch.frombuffer(raw, dtype=dtype, count=col.size)


def device_put_columns(frame, device=None) -> List[torch.Tensor]:
    """Pickle-free device staging of one columnar block (DESIGN.md §25).

    ``frame`` is a columnar frame's bytes/memoryview as landed by the
    fetch path (``shuffle/columnar.py``). Its fixed-width columns decode
    as ``np.frombuffer`` views aliasing the landed buffer, and each view
    goes to ``device`` (``cuda`` unless the caller passes ``"cpu"``) by
    one host-to-device copy, with no host copy before it. Returns one
    tensor per column, each a copy that no longer aliases ``frame``.
    Column dtypes are kept: a uint64 column stays ``torch.uint64``."""
    from sparkrdma_tpu_torch.shuffle import columnar

    dev = resolve_device(device)
    cols = columnar.decode_columns(frame)
    return [_host_tensor(c).to(dev, copy=True) for c in cols]


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
    if keys.dtype == torch.uint64:
        top = keys.view(torch.int64) >> shift
        return (top & ((1 << (64 - shift)) - 1) if shift else top).to(torch.int32)
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


def _pack_kernel_path(keys: torch.Tensor) -> bool:
    return keys.device.type == "cuda"


def radix_pack_pairs_reference(
    keys: torch.Tensor, vals: torch.Tensor, num_partitions: int, capacity: int,
    key_bits: int = 32, key_fill: int = 0, val_fill: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain version of :func:`radix_pack_pairs`: for each shard
    ``i``, ``radix_partition`` of ``keys[i]`` and ``pack_by_partition`` of
    ``keys[i]`` and of ``vals[i]`` by that one ``dest``."""
    packed = []
    for k, v in zip(keys, vals):
        dest = radix_partition(k, num_partitions, key_bits)
        kslab, counts, flag = pack_by_partition(k, dest, num_partitions, capacity,
                                                fill=key_fill)
        vslab, _, _ = pack_by_partition(v, dest, num_partitions, capacity,
                                        fill=val_fill)
        packed.append((kslab, vslab, counts, flag))
    return tuple(torch.stack(col) for col in zip(*packed))


def _check_pack_pairs(keys, vals, num_partitions, capacity, key_bits, val_fill):
    if _PACK_ROWS.get(keys.dtype) != vals.dtype:
        raise ValueError(
            f"radix_pack_pairs takes uint32 keys and int32 payloads or uint64 keys "
            f"and int64 payloads, not {keys.dtype} and {vals.dtype}")
    if keys.dim() != 2 or keys.shape != vals.shape or keys.shape[0] < 1:
        raise ValueError(
            f"radix_pack_pairs takes two [E, n] stacks (E >= 1), not "
            f"{list(keys.shape)} and {list(vals.shape)}")
    if keys.device != vals.device:
        raise ValueError("keys and payloads lie on different devices")
    if not (keys.is_contiguous() and vals.is_contiguous()):
        raise ValueError("radix_pack_pairs takes contiguous stacks")
    p = num_partitions
    if p < 1 or p & (p - 1):
        raise ValueError(f"num_partitions must be a power of two, not {p}")
    width = _UNSIGNED[keys.dtype][2]
    if not p.bit_length() - 1 <= key_bits <= width:
        raise ValueError(f"key_bits {key_bits} outside [log2 P, {width}]")
    if capacity < 1:
        raise ValueError(f"capacity must be at least 1, not {capacity}")
    if not -(1 << (width - 1)) <= val_fill < 1 << (width - 1):
        raise ValueError(f"val_fill {val_fill} is not an int{width}")


def _check_kernel_limits(keys, num_partitions, capacity):
    """The kernel's own limits, beyond what the plain version takes: its
    per-block histogram and its int32 row indices."""
    if num_partitions > RADIX_PACK_MAX_PARTITIONS:
        raise ValueError(
            f"srt_radix_pack takes at most {RADIX_PACK_MAX_PARTITIONS} "
            f"partitions, not {num_partitions}")
    if capacity >= 1 << 31 or keys.shape[1] >= 1 << 31:
        raise ValueError("srt_radix_pack takes capacity and rows a shard below 2^31")


def radix_pack_pairs(
    keys: torch.Tensor, vals: torch.Tensor, num_partitions: int, capacity: int,
    key_bits: int = 32, key_fill: int = 0, val_fill: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pack each shard of a contiguous ``[E, n]`` stack of uint32 keys and
    one of int32 payloads (4-byte rows), or of uint64 keys and int64
    payloads (8-byte rows), by the keys' top bits.

    Returns ``(kslab [E, P, capacity] uint32 / uint64, vslab [E, P,
    capacity] int32 / int64, counts [E, P] int32, overflowed [E] bool)``:
    for every shard
    ``i``, byte for byte :func:`pack_by_partition` of ``keys[i]`` (fill
    ``key_fill``) and of ``vals[i]`` (fill ``val_fill``) by
    ``radix_partition(keys[i], P, key_bits)``. ``P`` is a power of two
    (up to 256 on CUDA); keys lie below ``2^key_bits``, at most the key's
    width.

    CUDA stacks: one ``srt_radix_pack`` (4-byte rows) or
    ``srt_radix_pack64`` (8-byte rows) call on the current stream (three
    kernels), not waited on and with nothing read back; the outputs and
    the scratch come from ``torch.empty``. CPU stacks: the plain
    version."""
    _check_pack_pairs(keys, vals, num_partitions, capacity, key_bits, val_fill)
    args = (keys, vals, num_partitions, capacity, key_bits, key_fill, val_fill)
    if _pack_kernel_path(keys):
        _check_kernel_limits(keys, num_partitions, capacity)
        return _launch_radix_pack(*args)
    if keys.device.type == "cpu":
        return radix_pack_pairs_reference(*args)
    raise ValueError(f"radix_pack_pairs runs on cuda or cpu, not {keys.device}")


def _launch_radix_pack(keys, vals, p, capacity, key_bits, key_fill, val_fill):
    e, n = keys.shape
    dev = keys.device
    with _build.launch(_PACK_SYMBOL[keys.dtype], dev) as k:
        kslab = torch.empty((e, p, capacity), dtype=vals.dtype, device=dev)
        vslab = torch.empty_like(kslab)
        counts = torch.empty((e, p), dtype=torch.int32, device=dev)
        flags = torch.empty((e,), dtype=torch.bool, device=dev)
        scratch = torch.empty((k.lib.srt_radix_pack_scratch(e, n, p),),
                              dtype=torch.int32, device=dev)
        k.check(k.fn(
            keys.data_ptr(), vals.data_ptr(), kslab.data_ptr(), vslab.data_ptr(),
            counts.data_ptr(), flags.data_ptr(), scratch.data_ptr(), e, n, p,
            key_bits, capacity, _bits_scalar(key_fill, keys.dtype), val_fill,
            k.stream))
    return kslab.view(keys.dtype), vslab, counts, flags


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
    return split_sorted_edges(sorted_keys, _from_bits(edges, sorted_keys.dtype),
                              capacity, fill)


def split_sorted_edges(
    sorted_keys: torch.Tensor, edges: torch.Tensor, capacity: int,
    fill: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`split_sorted` with the range edges given: an ascending
    ``[P-1]`` tensor of the keys' dtype; partition ``e`` owns keys in
    ``[edges[e-1], edges[e])``. ``P`` need not be a power of two."""
    n = sorted_keys.shape[0]
    dev = sorted_keys.device
    starts = torch.cat([
        torch.zeros((1,), dtype=torch.int32, device=dev),
        searchsorted(sorted_keys, edges),
    ])
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


def merge_sorted_runs_reference(
    slab: torch.Tensor, counts: torch.Tensor, sentinel: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of :func:`merge_sorted_runs`: ``merge_received``
    of each shard's rows, stacked."""
    merged = [merge_received(rows, cnt, sentinel) for rows, cnt in zip(slab, counts)]
    return tuple(torch.stack(col) for col in zip(*merged))


def _merge_kernel_path(slab: torch.Tensor) -> bool:
    return slab.device.type == "cuda"


def _check_merge_runs(slab, counts, sentinel):
    if slab.dtype != torch.uint32 or slab.dim() != 3 or min(slab.shape) < 1:
        raise ValueError(f"merge_sorted_runs takes a uint32 [E, R, cap] slab, not "
                         f"{list(slab.shape)} {slab.dtype}")
    if counts.dtype != torch.int32 or counts.shape != slab.shape[:2]:
        raise ValueError(f"merge_sorted_runs takes int32 [E, R] counts, not "
                         f"{list(counts.shape)} {counts.dtype}")
    if counts.device != slab.device:
        raise ValueError("slab and counts lie on different devices")
    if not (slab.is_contiguous() and counts.is_contiguous()):
        raise ValueError("merge_sorted_runs takes a contiguous slab and counts")
    if sentinel != 0xFFFFFFFF:
        raise ValueError(f"the sentinel must sort last (0xFFFFFFFF), not {sentinel:#x}")


def _check_merge_limits(slab):
    """The kernel's own limits: a grid dimension of shards, one block's
    prefix of a shard's runs, and int32 places in a shard's row."""
    e, r, cap = slab.shape
    if e > 65535 or r > MERGE_RUNS_MAX_RUNS or r * cap > MERGE_RUNS_MAX_SLOTS:
        raise ValueError(
            f"srt_merge_runs takes at most 65535 shards, {MERGE_RUNS_MAX_RUNS} runs "
            f"and {MERGE_RUNS_MAX_SLOTS} slots a shard, not {list(slab.shape)}")


def merge_sorted_runs(
    slab: torch.Tensor, counts: torch.Tensor, sentinel: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge each shard's sorted runs: ``slab`` is a contiguous uint32
    ``[E, R, cap]`` stack whose row ``(i, j)`` is ascending in its first
    ``counts[i, j]`` slots (int32 ``[E, R]``, each in ``[0, cap]``); the
    slots past them are never read.

    Returns ``(merged [E, R * cap] uint32, totals [E] int32)``: byte for
    byte :func:`merge_received` of ``slab[i]`` and ``counts[i]`` stacked
    over ``i``, so row ``i`` holds its valid keys ascending, then
    ``sentinel``, which must be 0xFFFFFFFF.

    CUDA slabs: one ``srt_merge_runs`` call on the current stream, not
    waited on and with nothing read back; the outputs and a small scratch
    come from ``torch.empty``, and ``slab`` is the merge's scratch: its
    bytes are undefined after a call of more than two runs. CPU slabs:
    the plain version, which leaves ``slab`` as it was."""
    _check_merge_runs(slab, counts, sentinel)
    if _merge_kernel_path(slab):
        _check_merge_limits(slab)
        return _launch_merge_runs(slab, counts, sentinel)
    if slab.device.type == "cpu":
        return merge_sorted_runs_reference(slab, counts, sentinel)
    raise ValueError(f"merge_sorted_runs runs on cuda or cpu, not {slab.device}")


def _launch_merge_runs(slab, counts, sentinel):
    e, r, cap = slab.shape
    dev = slab.device
    with _build.launch("srt_merge_runs", dev) as k:
        merged = torch.empty((e, r * cap), dtype=torch.uint32, device=dev)
        totals = torch.empty((e,), dtype=torch.int32, device=dev)
        scratch = torch.empty((k.lib.srt_merge_runs_scratch(e, r, cap),),
                              dtype=torch.int32, device=dev)
        k.check(k.fn(slab.data_ptr(), counts.data_ptr(), merged.data_ptr(),
                     totals.data_ptr(), scratch.data_ptr(), e, r, cap, sentinel,
                     k.stream))
    return merged, totals


def probe_sorted_reference(
    bkeys_s: torch.Tensor, bvals_s: torch.Tensor, bcnt: torch.Tensor,
    pkeys: torch.Tensor, pcnt: torch.Tensor, miss: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of :func:`probe_sorted`: ``searchsorted`` (left)
    of every probe slot in its shard's whole build row, clamped to the
    row's last slot, the key there gathered and compared, ``&`` the valid
    slots of ``pcnt``, then the payload gathered or ``miss``. ``bcnt`` is
    not read. Its ``stats`` hold each shard's valid probes and 0 bucket
    steps: it searches no directory."""
    e, m = bkeys_s.shape
    cap_p = pkeys.shape[-1]
    pk = pkeys.reshape(e, -1)
    pos = searchsorted(bkeys_s, pk).clamp_(max=m - 1).to(torch.int64)
    col = torch.arange(cap_p, dtype=torch.int32, device=pcnt.device)
    valid = (col[None, None, :] < pcnt[:, :, None]).view(e, -1)
    hit = (torch.gather(_bits(bkeys_s), 1, pos) == _bits(pk)) & valid
    stats = torch.stack([valid.sum(1), torch.zeros(e, dtype=torch.int64, device=pk.device)], 1)
    return torch.where(hit, torch.gather(bvals_s, 1, pos), miss), stats


def _probe_kernel_path(bkeys_s: torch.Tensor) -> bool:
    return bkeys_s.device.type == "cuda"


def _check_probe_sorted(bkeys_s, bvals_s, bcnt, pkeys, pcnt, miss):
    if _PACK_ROWS.get(bkeys_s.dtype) != bvals_s.dtype or pkeys.dtype != bkeys_s.dtype:
        raise ValueError(
            f"probe_sorted takes uint32 keys and int32 payloads or uint64 keys and int64 "
            f"payloads, not build keys {bkeys_s.dtype}, payloads {bvals_s.dtype} and "
            f"probe keys {pkeys.dtype}")
    if bkeys_s.dim() != 2 or bvals_s.shape != bkeys_s.shape or min(bkeys_s.shape) < 1:
        raise ValueError(f"probe_sorted takes [E, M] build rows (E, M >= 1), not "
                         f"{list(bkeys_s.shape)} and {list(bvals_s.shape)}")
    e = bkeys_s.shape[0]
    if pkeys.dim() != 3 or pkeys.shape[:2] != (e, e) or pkeys.shape[2] < 1:
        raise ValueError(f"probe_sorted takes an [{e}, {e}, cap_p] probe slab, not "
                         f"{list(pkeys.shape)}")
    for name, cnt in (("bcnt", bcnt), ("pcnt", pcnt)):
        if cnt.dtype != torch.int32 or cnt.shape != (e, e):
            raise ValueError(f"probe_sorted takes int32 [{e}, {e}] {name}, not "
                             f"{list(cnt.shape)} {cnt.dtype}")
    tensors = [bkeys_s, bvals_s, bcnt, pkeys, pcnt]
    if any(t.device != bkeys_s.device for t in tensors):
        raise ValueError("probe_sorted's tensors lie on different devices")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("probe_sorted takes contiguous tensors")
    width = _UNSIGNED[bkeys_s.dtype][2]
    if not -(1 << (width - 1)) <= miss < 1 << (width - 1):
        raise ValueError(f"miss {miss} is not an int{width}")


def _check_probe_limits(bkeys_s, pkeys):
    """The kernel's own limits: a grid dimension of shards and int32
    places in a build row and in a shard's probe slots."""
    e, m = bkeys_s.shape
    if e > 65535 or m >= 1 << 31 or e * pkeys.shape[2] >= 1 << 31:
        raise ValueError(
            f"srt_sorted_probe takes at most 65535 shards and rows and probe slots a "
            f"shard below 2^31, not {list(bkeys_s.shape)} and {list(pkeys.shape)}")


def probe_sorted(
    bkeys_s: torch.Tensor, bvals_s: torch.Tensor, bcnt: torch.Tensor,
    pkeys: torch.Tensor, pcnt: torch.Tensor, miss: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The hash join's probe, every shard at once. ``bkeys_s`` ``[E, M]``
    holds each shard's build keys ascending (uint32 or uint64) and
    ``bvals_s`` their payloads (int32 or int64), as
    ``hashjoin.build_sort`` leaves them: at most ``bcnt[d].sum()`` keys
    of row ``d`` lie below the key type's maximum (``bcnt`` int32
    ``[E, E]``, the build side's received counts). ``pkeys`` is the
    ``[E, E, cap_p]`` probe slab of the same key dtype, its slot ``(d,
    s, j)`` valid when ``j < pcnt[d, s]`` (int32 ``[E, E]``).

    Returns ``(joined, stats)``. ``joined`` ``[E, E * cap_p]`` of the
    payloads' dtype: for each valid slot whose key equals the key at its
    clamped lower bound in its shard's row, the payload there (the first
    row of a repeated key); ``miss`` elsewhere. Byte for byte
    :func:`probe_sorted_reference`'s. ``stats`` int64 ``[E, 2]``: each
    shard's valid probes and its bucket search steps.

    CUDA tensors: one ``srt_sorted_probe`` (4-byte rows) or
    ``srt_sorted_probe64`` (8-byte rows) call on the current stream (two
    kernels), not waited on and with nothing read back; ``joined``,
    ``stats`` and the scratch come from ``torch.empty``. CPU tensors:
    the plain version."""
    _check_probe_sorted(bkeys_s, bvals_s, bcnt, pkeys, pcnt, miss)
    args = (bkeys_s, bvals_s, bcnt, pkeys, pcnt, miss)
    if _probe_kernel_path(bkeys_s):
        _check_probe_limits(bkeys_s, pkeys)
        return _launch_sorted_probe(*args)
    if bkeys_s.device.type == "cpu":
        return probe_sorted_reference(*args)
    raise ValueError(f"probe_sorted runs on cuda or cpu, not {bkeys_s.device}")


def _launch_sorted_probe(bkeys_s, bvals_s, bcnt, pkeys, pcnt, miss):
    e, m = bkeys_s.shape
    cap_p = pkeys.shape[2]
    dev = bkeys_s.device
    with _build.launch(_PROBE_SYMBOL[bkeys_s.dtype], dev) as k:
        joined = torch.empty((e, e * cap_p), dtype=bvals_s.dtype, device=dev)
        stats = torch.empty((e, 2), dtype=torch.int64, device=dev)
        scratch = torch.empty((k.lib.srt_sorted_probe_scratch(e, m),), dtype=torch.int32,
                              device=dev)
        k.check(k.fn(
            bkeys_s.data_ptr(), bvals_s.data_ptr(), bcnt.data_ptr(), pkeys.data_ptr(),
            pcnt.data_ptr(), joined.data_ptr(), stats.data_ptr(), scratch.data_ptr(),
            e, m, cap_p, miss, k.stream))
    return joined, stats
