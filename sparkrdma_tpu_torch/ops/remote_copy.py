"""Device-to-device block pull — the device fetch plane's data mover.

The PyTorch counterpart of the JAX package's ``ops/remote_copy.py``.

- ``wave_pull`` / ``pipelined_wave_pull``: one wave (or ``depth``
  same-class waves) of block pulls landed as a zero-padded
  ``[rows_b, bucket_elems]`` (``[depth, rows_b, bucket_elems]``) stack.
  On a CUDA destination each launches the hand-written kernel of
  ``csrc/wave_pull.cu`` (``srt_wave_pull`` / ``srt_pipelined_wave_pull``),
  which reads the source arena slabs directly; on a CPU destination it
  runs :func:`wave_pull_reference`, the plain version. A kernel that
  does not build or launch raises; nothing falls back.
- ``ppermute``: ``lax.ppermute`` over the rows of a ``[n, *shard]``
  stack, for any permutation of the shards (the ring's hop along one
  axis of a multi-axis mesh: :func:`axis_shift_perm`); ``PPermute`` is
  its autograd Function, whose backward is the inverse permutation.
  ``neighbor_pull`` is the rotation left by one shard (row ``i`` holds
  row ``(i + 1) mod n``), one hop of the ring exchange; its ``last``
  puts a separate tensor (the receive buffer of a hop from another
  rank) in the place of row 0 as the last row's source. On CUDA each
  launches ``srt_neighbor_pull`` (``csrc/neighbor_pull.cu``) over a
  per-shard (src, dst) pointer table, which carries the permutation;
  on the CPU they run :func:`ppermute_reference` /
  :func:`neighbor_pull_reference`.
- the emulated issue/wait halves and ``pull_block``: the CPU movers the
  schedule compiler and the per-block planner use off CUDA, each an
  independent copy (``clone``) of the source.

Every launch counts under its C function in ``_build.launches``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from sparkrdma_tpu_torch.ops import _build
from sparkrdma_tpu_torch.utils.torch_compat import torch_dtype


def _bytes_of(src: torch.Tensor) -> torch.Tensor:
    return src.reshape(-1).view(torch.uint8)


def _dst_device(sources, device) -> torch.device:
    if device is not None:
        return torch.device(device)
    for src in sources:
        if src is not None:
            return src.device
    raise ValueError("a wave with no source rows needs an explicit device")


def _check_rows(sources, offsets, nbytes, rows_total: int,
                bucket_bytes: int, device: torch.device) -> np.ndarray:
    """Validate one launch's rows; return the row table (src pointer,
    byte offset, payload bytes), uint64 ``[rows_total, 3]``."""
    if not (len(sources) == len(offsets) == len(nbytes)):
        raise ValueError("sources, offsets and nbytes differ in length")
    if len(sources) > rows_total:
        raise ValueError(f"{len(sources)} rows exceed the {rows_total}-row stack")
    table = np.zeros((rows_total, 3), dtype=np.uint64)
    for i, (src, off, nb) in enumerate(zip(sources, offsets, nbytes)):
        off, nb = int(off), int(nb)
        if src is None:
            if nb:
                raise ValueError(f"pad row {i} has {nb} payload bytes")
            continue
        if src.device != device:
            raise ValueError(
                f"row {i} source lies on {src.device}, destination on {device}"
            )
        if not src.is_contiguous():
            raise ValueError(f"row {i} source is not contiguous")
        cap = src.numel() * src.element_size()
        if off < 0 or nb < 0 or off + nb > cap:
            raise ValueError(
                f"row {i} reads [{off}, {off + nb}) past its {cap}-byte source"
            )
        if nb > bucket_bytes:
            raise ValueError(
                f"row {i} carries {nb}B, more than the {bucket_bytes}B bucket"
            )
        table[i] = (src.data_ptr(), off, nb)
    return table


def wave_pull_reference(sources: Sequence[Optional[torch.Tensor]],
                        offsets: Sequence[int], nbytes: Sequence[int],
                        rows_b: int, bucket_elems: int, dtype, depth: int = 1,
                        device=None) -> torch.Tensor:
    """The plain version of both kernels: a zero ``[depth, rows_b,
    bucket_elems]`` stack of ``dtype`` where destination row ``r``
    (wave-major: wave ``d``'s row ``i`` is ``r = d * rows_b + i``) holds
    ``nbytes[r]`` bytes of ``sources[r]`` from byte ``offsets[r]`` on. A
    None source, or a row past the end of the lists, is a pad row."""
    dtype = torch_dtype(dtype)
    item = torch.empty((), dtype=dtype).element_size()
    device = _dst_device(sources, device)
    _check_rows(sources, offsets, nbytes, depth * rows_b,
                bucket_elems * item, device)
    out = torch.zeros((depth * rows_b, bucket_elems * item), dtype=torch.uint8,
                      device=device)
    for r, (src, off, nb) in enumerate(zip(sources, offsets, nbytes)):
        if src is not None and nb:
            out[r, :nb].copy_(_bytes_of(src)[off : off + nb])
    return out.view(dtype).view(depth, rows_b, bucket_elems)


def _upload(table: np.ndarray, device: torch.device) -> torch.Tensor:
    """A kernel's uint64 table as an int64 tensor on ``device``. To CUDA
    it is an asynchronous copy from pinned memory (a pageable copy would
    wait for the stream to drain and stall the pipeline); the stream
    orders it before the kernel, and the allocators keep both ends
    alive."""
    t = torch.from_numpy(table.view(np.int64))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def _wave_kernel_path(device: torch.device) -> bool:
    """A wave lands through the kernel iff its destination is CUDA."""
    return device.type == "cuda"


def _launch(pipelined: bool, sources, offsets, nbytes, rows_b: int,
            bucket_elems: int, dtype: torch.dtype, depth: int,
            device: torch.device) -> torch.Tensor:
    item = torch.empty((), dtype=dtype).element_size()
    bucket_bytes = bucket_elems * item
    rows_total = depth * rows_b
    table = _check_rows(sources, offsets, nbytes, rows_total, bucket_bytes,
                        device)
    symbol, rows = (("srt_pipelined_wave_pull", (depth, rows_b)) if pipelined
                    else ("srt_wave_pull", (rows_b,)))
    dst = torch.empty((rows_total, bucket_bytes), dtype=torch.uint8,
                      device=device)
    with _build.launch(symbol, device) as k:
        dev_table = _upload(table, device)
        k.check(k.fn(dev_table.data_ptr(), dst.data_ptr(), *rows, bucket_bytes,
                     k.stream))
    return dst.view(dtype).view(depth, rows_b, bucket_elems)


def wave_pull(sources: Sequence[Optional[torch.Tensor]],
              offsets: Sequence[int], nbytes: Sequence[int], rows_b: int,
              bucket_elems: int, dtype, device=None) -> torch.Tensor:
    """Land one wave as a zero-padded ``[rows_b, bucket_elems]`` stack
    (row layout as in :func:`wave_pull_reference`). CUDA destination:
    one ``srt_wave_pull`` launch on the current stream, not waited on.
    CPU destination: the plain version."""
    dtype = torch_dtype(dtype)
    device = _dst_device(sources, device)
    if not _wave_kernel_path(device):
        return wave_pull_reference(sources, offsets, nbytes, rows_b,
                                   bucket_elems, dtype, 1, device)[0]
    return _launch(False, sources, offsets, nbytes, rows_b, bucket_elems,
                   dtype, 1, device)[0]


def pipelined_wave_pull(sources: Sequence[Optional[torch.Tensor]],
                        offsets: Sequence[int], nbytes: Sequence[int],
                        rows_b: int, bucket_elems: int, dtype, depth: int,
                        device=None) -> torch.Tensor:
    """Land ``depth`` same-class waves as one ``[depth, rows_b,
    bucket_elems]`` stack (rows wave-major). CUDA destination: one
    ``srt_pipelined_wave_pull`` launch, not waited on. CPU destination:
    the plain version."""
    dtype = torch_dtype(dtype)
    device = _dst_device(sources, device)
    if not _wave_kernel_path(device):
        return wave_pull_reference(sources, offsets, nbytes, rows_b,
                                   bucket_elems, dtype, depth, device)
    return _launch(True, sources, offsets, nbytes, rows_b, bucket_elems,
                   dtype, depth, device)


# ----------------------------------------------------------------------
# shard permutations: the mesh rotation (the JAX package's
# pallas_neighbor_pull) and lax.ppermute on co-resident shards
# ----------------------------------------------------------------------
def _kernel_path(blocks: torch.Tensor) -> bool:
    """A stack permutes through the kernel iff it lies on CUDA."""
    return blocks.device.type == "cuda"


def neighbor_pull_reference(blocks: torch.Tensor,
                            last: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain version of the rotation: a fresh stack in which row
    ``i`` holds row ``(i + 1) mod n`` of ``blocks``; with ``last``, row
    ``n - 1`` holds ``last`` instead of row 0."""
    if last is None:
        return torch.roll(blocks, -1, 0)
    return torch.cat([blocks[1:], last.reshape(1, *blocks.shape[1:])])


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def perm_sources(perm: Sequence[Tuple[int, int]], n: int) -> List[int]:
    """``sources[i]``: the row that row ``i`` receives under ``perm``, a
    list of ``(src, dst)`` pairs as ``lax.ppermute`` takes them. Raises
    unless ``perm`` sends one row to every one of the ``n`` shards and
    receives one from every shard: the kernel writes every destination
    row, so a partial ``ppermute`` (zeros where nothing arrives) is not
    one launch."""
    sources = [-1] * n
    sent = set()
    for src, dst in perm:
        src, dst = int(src), int(dst)
        if not (0 <= src < n and 0 <= dst < n):
            raise ValueError(f"perm pair ({src}, {dst}) is outside {n} shards")
        if sources[dst] >= 0 or src in sent:
            raise ValueError(f"perm sends or receives twice at ({src}, {dst})")
        sources[dst] = src
        sent.add(src)
    if len(sent) != n:
        raise ValueError(
            f"perm moves {len(sent)} of {n} shards: a partial ppermute is "
            "not a permutation"
        )
    return sources


def inverse_perm(perm: Sequence[Tuple[int, int]]) -> List[Tuple[int, int]]:
    return [(int(dst), int(src)) for src, dst in perm]


def axis_shift_perm(shape: Sequence[int], axis: int,
                    shift: int = 1) -> List[Tuple[int, int]]:
    """``(src, dst)`` pairs over the shards of a row-major mesh of
    ``shape``: every shard sends to the one ``shift`` steps on along mesh
    axis ``axis`` (mod its size), the other coordinates kept; the ring's
    hop, as ``[(i, (i + 1) % n)]`` is along a 1-D mesh."""
    idx = np.arange(int(np.prod(shape, dtype=np.int64))).reshape(shape)
    dst = np.roll(idx, -shift, axis=axis)  # dst[c] = c + shift
    return list(zip(idx.reshape(-1).tolist(), dst.reshape(-1).tolist()))


def ppermute_reference(blocks: torch.Tensor,
                       perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """The plain version of :func:`ppermute`: a fresh stack in which row
    ``dst`` holds row ``src`` of ``blocks`` for every pair of ``perm``."""
    sources = perm_sources(perm, blocks.shape[0])
    return blocks[torch.tensor(sources, dtype=torch.long, device=blocks.device)]


def _check_stack(blocks: torch.Tensor, out: Optional[torch.Tensor],
                 what: str) -> torch.Tensor:
    """Validate a permutation's source stack and ``out``; returns the
    destination (``out``, or a fresh stack)."""
    if not isinstance(blocks, torch.Tensor) or blocks.dim() < 1:
        raise ValueError(f"{what} takes a tensor with a shard axis")
    if not blocks.is_contiguous():
        raise ValueError(f"{what} takes a contiguous stack")
    if out is None:
        return torch.empty_like(blocks, memory_format=torch.contiguous_format)
    if (out.shape != blocks.shape or out.dtype != blocks.dtype
            or out.device != blocks.device or not out.is_contiguous()):
        raise ValueError(
            "out must be a contiguous stack of the source's shape, dtype "
            "and device"
        )
    a, b = blocks.data_ptr(), out.data_ptr()
    if a < b + _nbytes(out) and b < a + _nbytes(blocks):
        # in place, the permutation would overwrite a row before it is read
        raise ValueError("out overlaps the source stack")
    return out


def _check_last(blocks: torch.Tensor, out: torch.Tensor,
                last: torch.Tensor) -> torch.Tensor:
    """Validate the boundary row's source: one contiguous shard of the
    stack's dtype and device that shares no byte with ``out``."""
    n = blocks.shape[0]
    if (not isinstance(last, torch.Tensor) or last.dtype != blocks.dtype
            or last.device != blocks.device or not last.is_contiguous()
            or n == 0 or _nbytes(last) != _nbytes(blocks) // n):
        raise ValueError(
            "last must be one contiguous shard of the stack's dtype and device"
        )
    a, b = last.data_ptr(), out.data_ptr()
    if a < b + _nbytes(out) and b < a + _nbytes(last):
        raise ValueError("last overlaps out")
    return last


def neighbor_pull(blocks: torch.Tensor,
                  out: Optional[torch.Tensor] = None,
                  last: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Rotate a contiguous ``[n, *shard]`` stack of any dtype left by one
    shard: row ``i`` of the result holds row ``(i + 1) mod n``. ``out``,
    if given, receives the result: a contiguous tensor of the same shape,
    dtype and device that shares no byte with ``blocks``. The special
    case of :func:`ppermute` with ``perm = [(i, (i - 1) mod n)]``.
    ``last``, if given, is row ``n - 1``'s source in place of row 0: one
    contiguous shard outside the stack, such as the receive buffer of
    the ring's hop from the next rank (``ops/exchange.py``).

    CUDA stack: one ``srt_neighbor_pull`` launch on the current stream,
    not waited on. CPU stack: the plain version."""
    out = _check_stack(blocks, out, "neighbor_pull")
    if last is not None:
        last = _check_last(blocks, out, last)
    if _kernel_path(blocks):
        n = blocks.shape[0]
        sources: List = [(i + 1) % n for i in range(n)]
        if last is not None:
            sources[-1] = last
        return _launch_neighbor_pull(blocks, out, sources)
    if blocks.device.type != "cpu":
        raise ValueError(f"neighbor_pull runs on cuda or cpu, not {blocks.device}")
    return out.copy_(neighbor_pull_reference(blocks, last))


def ppermute(blocks: torch.Tensor, perm: Sequence[Tuple[int, int]],
             out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``lax.ppermute`` over the rows of a contiguous ``[n, *shard]``
    stack of any dtype: row ``dst`` of the result holds row ``src`` for
    every ``(src, dst)`` pair of ``perm``, which must be a permutation of
    the ``n`` shards (:func:`perm_sources`). ``out`` as in
    :func:`neighbor_pull`.

    CUDA stack: one ``srt_neighbor_pull`` launch on the current stream,
    not waited on; the kernel is unchanged, the permutation is its
    pointer table. CPU stack: the plain version."""
    out = _check_stack(blocks, out, "ppermute")
    sources = perm_sources(perm, blocks.shape[0])
    if _kernel_path(blocks):
        return _launch_neighbor_pull(blocks, out, sources)
    if blocks.device.type != "cpu":
        raise ValueError(f"ppermute runs on cuda or cpu, not {blocks.device}")
    return out.copy_(ppermute_reference(blocks, perm))


class PPermute(torch.autograd.Function):
    """Differentiable :func:`ppermute`: the adjoint of a permutation is
    its inverse, launched through the same kernel."""

    @staticmethod
    def forward(ctx, blocks, perm):
        ctx.inverse = inverse_perm(perm)
        return ppermute(blocks.contiguous(), perm)

    @staticmethod
    def backward(ctx, ct):
        return ppermute(ct.contiguous(), ctx.inverse), None


def _launch_neighbor_pull(blocks: torch.Tensor, out: torch.Tensor,
                          sources: Sequence) -> torch.Tensor:
    """One ``srt_neighbor_pull`` launch in which row ``i`` of ``out``
    receives row ``sources[i]`` of ``blocks``, or, where ``sources[i]``
    is a tensor, that shard-sized tensor (checked by the caller). The
    kernel writes ``table[i].dst`` from ``table[(i + 1) mod n].src``, so
    the source of row ``i`` sits one entry on."""
    n = blocks.shape[0]
    shard_bytes = _nbytes(blocks) // n if n else 0
    if shard_bytes == 0:
        return out
    # one (src, dst) pair per shard: rows of the two stacks, or a receive
    # buffer from another rank (the ring over ranks); another card's
    # peer-mapped rows in the multi-GPU slice (ROADMAP M7)
    sb = np.uint64(shard_bytes)
    rows = np.arange(n, dtype=np.uint64) * sb
    base = blocks.data_ptr()
    srcs = np.roll(np.array(
        [s.data_ptr() if isinstance(s, torch.Tensor) else base + int(s) * shard_bytes
         for s in sources], dtype=np.uint64), 1)
    table = np.stack([srcs, np.uint64(out.data_ptr()) + rows], axis=1)
    with _build.launch("srt_neighbor_pull", blocks.device) as k:
        dev_table = _upload(table, blocks.device)
        k.check(k.fn(dev_table.data_ptr(), n, shard_bytes, k.stream))
    return out


# ----------------------------------------------------------------------
# CPU movers (the JAX package's emulated transfer-engine halves)
# ----------------------------------------------------------------------
def emulated_pull(src_array: torch.Tensor, dst_device) -> torch.Tensor:
    """Pull ``src_array`` onto ``dst_device`` as an independent copy —
    the caller may unpin (and the arena later recycle) the source."""
    return src_array.to(dst_device, copy=True)


def emulated_row_pull_start(src_array: torch.Tensor, dst_device) -> torch.Tensor:
    """START one row's pull (an independent copy); the wave's consume
    half waits on it with :func:`emulated_wave_wait`."""
    return emulated_pull(src_array, dst_device)


def emulated_wave_issue(stacked_host: torch.Tensor, dst_device) -> torch.Tensor:
    """ISSUE an assembled ``[rows, bucket]`` stack toward the destination."""
    return stacked_host.to(dst_device)


def emulated_wave_wait(inflight):
    """Wait for issued copies to land: a no-op for copies the CPU has
    already made; kept as the consume half's seam."""
    return inflight


def emulated_wave_pull(stacked_host: torch.Tensor, dst_device) -> torch.Tensor:
    """Issue + wait of one assembled stack."""
    return emulated_wave_wait(emulated_wave_issue(stacked_host, dst_device))


def pull_block(src_array: torch.Tensor, dst_device) -> torch.Tensor:
    """Single-block pull used by the per-block planner. Errors propagate:
    only residency misses degrade, and the planner checks those before
    it calls the mover."""
    return emulated_pull(src_array, dst_device)

