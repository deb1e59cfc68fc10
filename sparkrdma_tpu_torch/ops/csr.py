"""PageRank's edges grouped by destination (CSR), and the pull over them.

:func:`csr_build` turns PageRank's padded blocks (``packed [E, E, cap,
2]``: local ``(src, dst)`` int32 pairs, -1 padding) into one CSR of
``rows = E * E * n_local`` rows: row ``(s * E + d) * n_local + v`` holds
the sources of block ``(s, d)``'s edges into local destination ``v``, each
as its vertex id ``s * n_local + src_local``. Padding is dropped.
:func:`csr_pull` then gives every row the float32 sum of its sources'
``outc``: the flat ``[E_src, E_dst, n_local]`` contribution stack that
PageRank's all-to-all sends.

On CUDA each is one call of the hand-written kernels of
``csrc/csr_pull.cu``, a library of its own: the build a two-level
counting sort by row (buckets of rows, then rows, on shared-memory
counters) and the pull's merge-path split; the pull one pass and a pass
of one carry a tile. Nothing is read back to the host. Each launch
counts under its C function in ``_build.launches``. On the CPU they run
the plain versions, :func:`csr_build_reference` and
:func:`csr_pull_reference`; nothing falls back. Offsets are int32, or
int64 where rows and slots together reach 2^31.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from sparkrdma_tpu_torch.ops import _build


class Csr(NamedTuple):
    """Row ``r``'s sources are ``src[offsets[r]:offsets[r + 1]]``."""

    offsets: torch.Tensor  # [rows + 1] int32 or int64; offsets[rows] the edge count
    src: torch.Tensor  # int32 vertex ids, at least offsets[rows] of them
    coords: Optional[torch.Tensor]  # the kernel's merge-path split; None on the CPU
    sources: int  # the out-contributions a pull reads: E * n_local


def index_dtype(rows: int, slots: int) -> torch.dtype:
    return torch.int32 if rows + slots < 2**31 else torch.int64


def _kernel_path(t: torch.Tensor) -> bool:
    return t.device.type == "cuda"


def _check_packed(packed: torch.Tensor, n_local: int) -> None:
    if (packed.dtype != torch.int32 or packed.dim() != 4
            or packed.shape[0] != packed.shape[1] or packed.shape[3] != 2
            or packed.shape[0] < 1 or packed.shape[2] < 1):
        raise ValueError(f"csr_build takes [E, E, cap, 2] int32 blocks, not "
                         f"{list(packed.shape)} {packed.dtype}")
    if not packed.is_contiguous():
        raise ValueError("csr_build takes contiguous blocks")
    if not 1 <= n_local <= 2**31 // packed.shape[0]:
        raise ValueError(f"n_local {n_local} outside [1, 2^31 / E]")


def csr_build(packed: torch.Tensor, n_local: int) -> Csr:
    """The CSR of ``packed``'s valid slots; on CUDA, the build kernels on
    the current stream, not waited on; ``src`` then has one place a slot,
    of which the first ``offsets[rows]`` hold the edges."""
    _check_packed(packed, n_local)
    if _kernel_path(packed):
        e, cap = packed.shape[0], packed.shape[2]
        return _launch_build(packed, n_local, index_dtype(e * e * n_local, e * e * cap))
    if packed.device.type == "cpu":
        return csr_build_reference(packed, n_local)
    raise ValueError(f"csr_build runs on cuda or cpu, not {packed.device}")


def csr_pull(outc: torch.Tensor, graph: Csr) -> torch.Tensor:
    """``[rows]`` float32: each row's sum of ``outc`` over its sources,
    an empty row 0; on CUDA the pull kernels on the current stream."""
    if outc.dtype != torch.float32 or outc.shape != (graph.sources,):
        raise ValueError(f"csr_pull takes [{graph.sources}] float32 out-contributions, "
                         f"not {list(outc.shape)} {outc.dtype}")
    if outc.device != graph.src.device or not outc.is_contiguous():
        raise ValueError("csr_pull takes contiguous out-contributions beside the graph")
    if _kernel_path(outc):
        return _launch_pull(outc, graph)
    if outc.device.type == "cpu":
        return csr_pull_reference(outc, graph.offsets, graph.src)
    raise ValueError(f"csr_pull runs on cuda or cpu, not {outc.device}")


def csr_build_reference(packed: torch.Tensor, n_local: int) -> Csr:
    """The plain version of :func:`csr_build`: a stable sort of the valid
    slots by row, so each row keeps its block's slot order."""
    e, cap = packed.shape[0], packed.shape[2]
    rows = e * e * n_local
    dev = packed.device
    flat = packed.view(e * e, cap, 2)
    valid = flat[..., 0] >= 0
    block = torch.arange(e * e, device=dev)[:, None].expand(e * e, cap)[valid]
    row = block * n_local + flat[..., 1][valid]
    dtype = index_dtype(rows, e * e * cap)
    offsets = torch.zeros((rows + 1,), dtype=dtype, device=dev)
    offsets[1:] = torch.cumsum(torch.bincount(row, minlength=rows), 0)
    order = torch.argsort(row, stable=True)
    src = (torch.div(block, e, rounding_mode="floor") * n_local
           + flat[..., 0][valid]).to(torch.int32)[order]
    return Csr(offsets, src, None, e * n_local)


def csr_pull_reference(outc: torch.Tensor, offsets: torch.Tensor,
                       src: torch.Tensor) -> torch.Tensor:
    """The plain version of :func:`csr_pull`: every edge's value, then
    ``index_add_`` into its row."""
    rows = offsets.shape[0] - 1
    edges = int(offsets[-1])
    row = torch.repeat_interleave(torch.arange(rows, device=outc.device),
                                  (offsets[1:] - offsets[:-1]).to(torch.int64))
    return torch.zeros((rows,), dtype=outc.dtype, device=outc.device).index_add_(
        0, row, outc[src[:edges].to(torch.int64)])


def _launch_build(packed: torch.Tensor, n_local: int, dtype: torch.dtype) -> Csr:
    e, cap = packed.shape[0], packed.shape[2]
    rows, slots = e * e * n_local, e * e * cap
    wide = int(dtype == torch.int64)
    dev = packed.device
    with _build.launch("srt_csr_build", dev) as k:
        nbytes = k.lib.srt_csr_scratch_bytes(e, cap, n_local, wide)
        if nbytes < 0:
            raise ValueError(f"srt_csr_build takes no [{e}, {e}, {cap}, 2] blocks of "
                             f"{n_local} rows")
        tiles = -(-(rows + slots) // k.lib.srt_csr_tile_steps())
        ends = torch.empty((rows + 2,), dtype=dtype, device=dev)
        src = torch.empty((slots,), dtype=torch.int32, device=dev)
        coords = torch.empty((tiles + 1, 2), dtype=dtype, device=dev)
        scratch = torch.empty((nbytes,), dtype=torch.uint8, device=dev)
        k.check(k.fn(packed.data_ptr(), ends.data_ptr(), src.data_ptr(), coords.data_ptr(),
                     scratch.data_ptr(), e, cap, n_local, tiles, wide, k.stream))
    return Csr(ends[1:], src, coords, e * n_local)


def _launch_pull(outc: torch.Tensor, graph: Csr) -> torch.Tensor:
    if graph.coords is None:
        raise ValueError("csr_pull on CUDA takes a graph that csr_build made there")
    rows, tiles = graph.offsets.shape[0] - 1, graph.coords.shape[0] - 1
    dev = outc.device
    y = torch.empty((rows,), dtype=torch.float32, device=dev)
    carry = torch.empty((tiles,), dtype=torch.float32, device=dev)
    with _build.launch("srt_csr_pull", dev) as k:
        k.check(k.fn(outc.data_ptr(), graph.offsets.data_ptr(), graph.src.data_ptr(),
                     graph.coords.data_ptr(), carry.data_ptr(), y.data_ptr(), rows, tiles,
                     int(graph.offsets.dtype == torch.int64), k.stream))
    return y
