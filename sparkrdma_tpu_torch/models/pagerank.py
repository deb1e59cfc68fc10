"""Device-resident distributed PageRank — the multi-round all-to-all workload.

The PyTorch counterpart of the JAX package's ``models/pagerank.py``
(GraphX PageRank on twitter-2010). Vertices are block-sharded over the
mesh (``[E, n_local]`` ranks). Edges are bucketed into per-(src shard,
dst shard) padded blocks, so each shard sums its contributions into E
destination-shard vectors, the vectors ride one all-to-all
(``ExchangeProgram`` over the shard stack), and each shard sums what it
receives:

  contrib[d] = sum over the edges (s -> t) into shard d of rank[s] / outdeg[s]
  rank' = (1 - alpha) / N + alpha * (received contrib + dangling share)

The bucketing (``blocks``) packs one int32 key an edge, its block above
its source's local index, with its destination's local index as the
payload, in one ``radix_pack_pairs`` call (on CUDA the ``srt_radix_pack``
kernel): beside the edges it holds about four int32 columns of one
value an edge at its peak, so a graph of 2^30 edges buckets on one 80 GB
card (24.8-25.5 GiB of set-up peak on an H100, edges included).

The step groups the blocks' edges by destination once a call
(``ops/csr.py`` ``csr_build``: one CSR row a destination of a block,
padding dropped), and each iteration pulls every row's sum of its
sources' out-contributions (``csr_pull``), written once a row: on CUDA
the ``srt_csr_*`` kernels, with no float atomic an edge. It opens spans
(``obs/trace.py``): ``pagerank.step`` around the call, and directly in
it ``pagerank.index`` once (the CSR), then each iteration
``pagerank.gather`` (out-contributions, dangling sum),
``pagerank.scatter`` (the pull, with the edge gather inside it), the
exchange's ``exchange.a2a`` and ``pagerank.apply``.
"""

from __future__ import annotations

import math
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from sparkrdma_tpu_torch.obs.trace import span
from sparkrdma_tpu_torch.ops import sort as sort_ops
from sparkrdma_tpu_torch.ops.csr import csr_build, csr_pull
from sparkrdma_tpu_torch.ops.exchange import ExchangeProgram
from sparkrdma_tpu_torch.ops.sort import (RADIX_PACK_MAX_PARTITIONS, pack_by_partition,
                                          radix_pack_pairs)
from sparkrdma_tpu_torch.parallel.mesh import ShardMesh, mesh_or_one_shard


class PageRank:
    """Power iteration over a mesh of E shards. ``mesh`` defaults to one
    shard on ``device`` (``cuda`` unless ``"cpu"`` is asked for)."""

    def __init__(self, mesh: Optional[ShardMesh] = None, damping: float = 0.85,
                 device=None):
        self.mesh = mesh_or_one_shard(mesh, device)
        self.device = self.mesh.device
        self.num_shards = self.mesh.num_shards
        self.damping = damping
        self._exchange = ExchangeProgram(self.mesh)
        self._cache = {}
        # walls of the last ``run``: edges to the device, bucketing,
        # the iterations (ending in the ranks' readback)
        self.last_walls: Dict[str, float] = {}

    # ------------------------------------------------------------------
    def blocks(self, edges: torch.Tensor, num_vertices: int, capacity: int = 1
               ) -> Tuple[torch.Tensor, torch.Tensor, int]:
        """:meth:`prepare` on the mesh's device: ``edges`` is an ``[m, 2]``
        integer tensor there. Returns the tensors ``(packed [E, E, cap,
        2] int32, deg [E * n_local] float32, n_local)``, ``cap`` the
        largest block or ``capacity``, whichever is more (a caller that
        sizes its buffers once for graphs of one size passes it).

        Each (src shard, dst shard) block keeps its edges in input order,
        as the JAX package's E^2 masks do. Where the packed key fits 31
        bits, one ``radix_pack_pairs`` call packs every edge; otherwise,
        and on CUDA where the pack's partitions (E^2, rounded up to a
        power of two) or rows exceed its kernel's, one
        ``pack_by_partition`` of int64 block ids does."""
        e = self.num_shards
        n_local = int(math.ceil(num_vertices / e))
        src, dst = edges[:, 0].to(torch.int32), edges[:, 1].to(torch.int32)
        outdeg = torch.bincount(src, minlength=num_vertices).to(torch.float32)
        deg = torch.zeros((e * n_local,), dtype=torch.float32, device=edges.device)
        deg[:num_vertices] = outdeg
        del outdeg
        lg, b = (e * e - 1).bit_length(), max(1, (n_local - 1).bit_length())
        kernel = sort_ops._pack_kernel_path(src)
        if lg + b <= 31 and not (kernel and (1 << lg > RADIX_PACK_MAX_PARTITIONS
                                             or len(src) >= 1 << 31)):
            packed = _pack_radix(src, dst, e, n_local, lg, b, capacity)
        else:
            packed = _pack_plain(src, dst, e, n_local, capacity)
        return packed.view(e, e, -1, 2), deg, n_local

    def prepare(self, edges: np.ndarray, num_vertices: int):
        """Host-side contract of the JAX package: pad per-(src, dst)-shard
        edge blocks. ``edges``: [m, 2] int array of (src, dst); vertex v
        lives on shard v // n_local. Returns numpy ``(packed [E, E, cap,
        2] int32 with -1 padding, deg [E * n_local] float32, n_local)``,
        byte-identical to the JAX package's; the bucketing runs on the
        mesh's device."""
        packed, deg, n_local = self.blocks(self._upload(edges), num_vertices)
        return packed.cpu().numpy(), deg.cpu().numpy(), n_local

    def _upload(self, edges: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(edges)).to(self.device)

    # ------------------------------------------------------------------
    def _build(self, n_local: int, cap: int, iters: int, num_vertices: int):
        e = self.num_shards
        alpha = self.damping
        all_to_all = self._exchange.program_for(e, n_local, torch.float32)

        def fn(rank, deg, valid, blocks):
            # rank/deg/valid: [E * n_local] stacks; blocks: [E_src, E_dst,
            # cap, 2] local indices, -1 padding. ``valid`` masks the slots
            # that exist only because E does not divide the vertex count:
            # they hold zero rank and shed no dangling mass.
            with span("pagerank.step"):
                if blocks.shape != (e, e, cap, 2) or rank.shape != (e * n_local,):
                    raise ValueError(
                        f"step built for [{e}, {e}, {cap}, 2] blocks and "
                        f"[{e * n_local}] ranks, got {list(blocks.shape)}, "
                        f"{list(rank.shape)}")
                dev = rank.device
                with span("pagerank.index"):
                    # the edges grouped by destination: CSR row (s * E +
                    # d) * n_local + v holds block (s, d)'s edges into v,
                    # and its sum is that slot of the contribution stack
                    graph = csr_build(blocks, n_local)
                    safe_deg, has_out = deg.clamp(min=1.0), deg > 0
                    dangles = (deg == 0) & (valid > 0)
                    counts = torch.full((e * e,), n_local, dtype=torch.int32, device=dev)
                    zero = torch.zeros((), dtype=torch.float32, device=dev)
                    outc = torch.empty((e * n_local,), dtype=torch.float32, device=dev)
                r = rank
                for _ in range(iters):
                    with span("pagerank.gather"):
                        torch.where(has_out, r / safe_deg, zero, out=outc)
                        # dangling mass is redistributed uniformly; its psum
                        # over every shard is the sum over the whole stack
                        dangling = torch.where(dangles, r, 0.0).sum()
                    with span("pagerank.scatter"):
                        contribs = csr_pull(outc, graph)
                    # one all-to-all per iteration: shard i's row d -> shard d
                    recv, _ = all_to_all(contribs.view(e * e, n_local), counts)
                    del contribs  # before the next pull allocates its own
                    with span("pagerank.apply"):
                        inflow = recv.view(e, e, n_local).sum(dim=1).view(-1)
                        del recv
                        r_new = (1.0 - alpha) / num_vertices + alpha * (
                            inflow + dangling / num_vertices)
                        r = torch.where(valid > 0, r_new, 0.0)
                return r

        return fn

    def step(self, n_local: int, cap: int, iters: int, num_vertices: int) -> Callable:
        """The cached power iteration ``fn(rank, deg, valid, blocks) ->
        ranks`` (``iters`` iterations) over shard stacks on the mesh's
        device."""
        key = (n_local, cap, iters, num_vertices)
        fn = self._cache.get(key)
        if fn is None:
            fn = self._build(n_local, cap, iters, num_vertices)
            self._cache[key] = fn
        return fn

    def initial(self, n_local: int, num_vertices: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The uniform start ranks and the ``valid`` mask, ``[E * n_local]``
        float32 stacks on the mesh's device."""
        valid = torch.zeros((self.num_shards * n_local,), dtype=torch.float32,
                            device=self.device)
        valid[:num_vertices] = 1.0
        return torch.where(valid > 0, 1.0 / num_vertices, 0.0), valid

    # ------------------------------------------------------------------
    def run(self, edges: np.ndarray, num_vertices: int, iters: int = 20) -> np.ndarray:
        t0 = time.perf_counter()
        dev_edges = self._upload(edges)
        t1 = time.perf_counter()
        packed, deg, n_local = self.blocks(dev_edges, num_vertices)
        del dev_edges
        t2 = time.perf_counter()
        rank0, valid = self.initial(n_local, num_vertices)
        fn = self.step(n_local, packed.shape[2], iters, num_vertices)
        out = fn(rank0, deg, valid, packed)[:num_vertices].cpu().numpy()
        self.last_walls = {"upload_s": t1 - t0, "prepare_s": t2 - t1,
                           "run_s": time.perf_counter() - t2}
        return out


def _pack_radix(src: torch.Tensor, dst: torch.Tensor, e: int, n_local: int, lg: int,
                b: int, capacity: int = 1) -> torch.Tensor:
    """``[E * E, cap, 2]`` int32 blocks by one ``radix_pack_pairs`` over
    the ``[1, m]`` stack of keys ``block << b | src % n_local`` (``block
    = (src // n_local) * E + dst // n_local``, below ``2^lg``) with
    payloads ``dst % n_local``."""
    keys = torch.div(src, n_local, rounding_mode="floor")
    keys.mul_(e).add_(torch.div(dst, n_local, rounding_mode="floor"))
    cap = max(capacity, int(torch.bincount(keys, minlength=e * e).max()))
    keys.bitwise_left_shift_(b).add_(torch.remainder(src, n_local))
    vals = torch.remainder(dst, n_local)
    kslab, vslab, _, _ = radix_pack_pairs(
        keys.view(torch.uint32).view(1, -1), vals.view(1, -1), 1 << lg, cap, lg + b,
        key_fill=0xFFFFFFFF, val_fill=-1)
    del keys, vals
    # a valid key lies below 2^31; the padding's is all ones, so its
    # arithmetic shift by 31 is -1 (the fill) and a valid key's 0
    k = kslab.view(torch.int32)
    sign = k >> 31
    k.bitwise_and_((1 << b) - 1).bitwise_or_(sign)
    del sign
    return torch.stack((k[0, :e * e], vslab[0, :e * e]), dim=-1)


def _pack_plain(src: torch.Tensor, dst: torch.Tensor, e: int, n_local: int,
                capacity: int = 1) -> torch.Tensor:
    """The same blocks by one ``pack_by_partition`` of int64 block ids,
    for keys over 31 bits and CUDA meshes beyond the radix pack's kernel."""
    src, dst = src.to(torch.int64), dst.to(torch.int64)
    block = torch.div(src, n_local, rounding_mode="floor") * e + torch.div(
        dst, n_local, rounding_mode="floor")
    cap = max(capacity, int(torch.bincount(block, minlength=e * e).max()))
    local = torch.stack([(v % n_local).to(torch.int32) for v in (src, dst)], 1)
    packed, _, _ = pack_by_partition(local, block, e * e, cap, fill=-1)
    return packed


def reference_pagerank(
    edges: np.ndarray, num_vertices: int, iters: int = 20, damping: float = 0.85
) -> np.ndarray:
    """Dense numpy power iteration for correctness checks."""
    rank = np.full((num_vertices,), 1.0 / num_vertices, dtype=np.float64)
    outdeg = np.bincount(edges[:, 0], minlength=num_vertices).astype(np.float64)
    for _ in range(iters):
        contrib = np.zeros(num_vertices, dtype=np.float64)
        outc = np.divide(rank, outdeg, out=np.zeros_like(rank), where=outdeg > 0)
        np.add.at(contrib, edges[:, 1], outc[edges[:, 0]])
        dangling = rank[outdeg == 0].sum()
        rank = (1 - damping) / num_vertices + damping * (
            contrib + dangling / num_vertices
        )
    return rank.astype(np.float32)
