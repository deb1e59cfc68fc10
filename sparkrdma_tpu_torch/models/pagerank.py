"""Device-resident distributed PageRank — the multi-round all-to-all workload.

The PyTorch counterpart of the JAX package's ``models/pagerank.py``
(GraphX PageRank on twitter-2010). Vertices are block-sharded over the
mesh (``[E, n_local]`` ranks). Edges are bucketed into per-(src shard,
dst shard) padded blocks, so each shard scatter-adds its contributions
into E destination-shard vectors, the vectors ride one all-to-all
(``ExchangeProgram`` over the shard stack), and each shard sums what it
receives:

  contrib[d] = sum over the edges (s -> t) into shard d of rank[s] / outdeg[s]
  rank' = (1 - alpha) / N + alpha * (received contrib + dangling share)
"""

from __future__ import annotations

import math
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from sparkrdma_tpu_torch.ops.exchange import ExchangeProgram
from sparkrdma_tpu_torch.ops.sort import pack_by_partition
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
    def blocks(self, edges: torch.Tensor, num_vertices: int
               ) -> Tuple[torch.Tensor, torch.Tensor, int]:
        """:meth:`prepare` on the mesh's device: ``edges`` is an ``[m, 2]``
        integer tensor there. Returns the tensors ``(packed [E, E, cap,
        2] int32, deg [E * n_local] float32, n_local)``."""
        e = self.num_shards
        n_local = int(math.ceil(num_vertices / e))
        src, dst = edges[:, 0].to(torch.int64), edges[:, 1].to(torch.int64)
        outdeg = torch.bincount(src, minlength=num_vertices).to(torch.float32)
        # bucket (src shard, dst shard); one stable sort keeps each
        # block's edges in input order, as the JAX package's E^2 masks do
        block = torch.div(src, n_local, rounding_mode="floor") * e + torch.div(
            dst, n_local, rounding_mode="floor")
        cap = max(1, int(torch.bincount(block, minlength=e * e).max()))
        local = torch.stack([(v % n_local).to(torch.int32) for v in (src, dst)], 1)
        packed, _, _ = pack_by_partition(local, block, e * e, cap, fill=-1)
        deg = torch.zeros((e * n_local,), dtype=torch.float32, device=edges.device)
        deg[:num_vertices] = outdeg
        return packed.view(e, e, cap, 2), deg, n_local

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
            if blocks.shape != (e, e, cap, 2) or rank.shape != (e * n_local,):
                raise ValueError(
                    f"step built for [{e}, {e}, {cap}, 2] blocks and "
                    f"[{e * n_local}] ranks, got {list(blocks.shape)}, "
                    f"{list(rank.shape)}")
            dev = rank.device
            safe_deg = deg.clamp(min=1.0)
            s_idx = blocks[..., 0].to(torch.int64)
            live = (s_idx >= 0).view(-1)
            # flat indices into the rank stack (source shard i's slots) and
            # into the [E_src, E_dst, n_local] contribution stack; padding
            # slots point at slot 0 and add 0
            shard = torch.arange(e, dtype=torch.int64, device=dev)
            src_at = (shard[:, None, None] * n_local + s_idx.clamp(min=0)).view(-1)
            row = (shard[:, None] * e + shard[None, :])[:, :, None]
            dst_at = (row * n_local
                      + blocks[..., 1].to(torch.int64).clamp(min=0)).view(-1)
            del s_idx, row
            dangles = (deg == 0) & (valid > 0)
            counts = torch.full((e * e,), n_local, dtype=torch.int32, device=dev)
            r = rank
            for _ in range(iters):
                outc = torch.where(deg > 0, r / safe_deg, 0.0)
                # dangling mass is redistributed uniformly; its psum over
                # every shard is the sum over the whole stack
                dangling = torch.where(dangles, r, 0.0).sum()
                vals = torch.where(live, outc[src_at], 0.0)
                contribs = torch.zeros((e * e * n_local,), dtype=torch.float32,
                                       device=dev).index_add_(0, dst_at, vals)
                del vals
                # one all-to-all per iteration: shard i's row d -> shard d
                recv, _ = all_to_all(contribs.view(e * e, n_local), counts)
                inflow = recv.view(e, e, n_local).sum(dim=1).view(-1)
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
