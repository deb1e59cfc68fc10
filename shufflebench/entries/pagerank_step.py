"""``PageRank(mesh).step(...)`` over the bucketed edges.

Set-up, once, as GraphX partitions and caches a graph:
``PageRank(make_mesh([device] * shards)).blocks(edges, 2^scale,
capacity)`` and ``initial()``. ``capacity`` is the mean block's edges
and the configuration's ``block_headroom`` above it: the deployment
sizes its blocks once for graphs of one size, so a graph whose largest
block fits holds the same memory and runs the same shapes as any other. A stage is one job of the traffic's iterations,
``fn(rank0, deg, valid, packed)``, ending in the read of the rank sum
(float64 on the device), every stage's count. ``stage_bytes`` is the
edge list read once, as the other cells count their input once.
Judged: the sampled stage's ranks of the ``2^scale`` vertices."""

from __future__ import annotations

import math
import sys
import time

import torch

from shufflebench.entries import Out


class Entry:
    def __init__(self, cell, inputs, device):
        from sparkrdma_tpu_torch.models.pagerank import PageRank
        from sparkrdma_tpu_torch.parallel.mesh import make_mesh

        cfg = cell.config
        iters = int(cell.traffic["iterations"])
        if iters != int(cfg["iterations"]):
            raise ValueError(f"the traffic runs {iters} iterations a job, the "
                             f"configuration defines {cfg['iterations']}")
        self.n = 1 << int(cfg["scale"])
        edges = inputs["edges"]
        self.pr = PageRank(make_mesh([device] * int(cfg["shards"])),
                           damping=float(cfg["damping"]))
        timed = device.type == "cuda"
        if timed:
            torch.cuda.reset_peak_memory_stats(device)
        mean_block = edges.shape[0] / self.pr.num_shards ** 2
        capacity = math.ceil(mean_block * (1 + float(cfg["block_headroom"])))
        self.packed, self.deg, n_local = self.pr.blocks(edges, self.n, capacity)
        self.rank0, self.valid = self.pr.initial(n_local, self.n)
        self.fn = self.pr.step(n_local, self.packed.shape[2], iters, self.n)
        if timed:
            print(f"shufflebench: pagerank set-up peak "
                  f"{torch.cuda.max_memory_allocated(device)} B (edges resident), "
                  f"blocks [{self.pr.num_shards}, {self.pr.num_shards}, "
                  f"{self.packed.shape[2]}, 2]", file=sys.stderr, flush=True)
        self.stage_bytes = edges.numel() * edges.element_size()

    def stage(self, end) -> Out:
        t0 = time.perf_counter()
        ranks = self.fn(self.rank0, self.deg, self.valid, self.packed)
        enqueue_s = time.perf_counter() - t0
        total = ranks.sum(dtype=torch.float64)
        if end is not None:
            end.record()
        return Out(ranks, True, [float(total)], enqueue_s)

    def judged(self, output) -> dict:
        return {"ranks": output[:self.n]}

    def close(self) -> None:
        self.fn = self.packed = self.deg = self.rank0 = self.valid = self.pr = None
