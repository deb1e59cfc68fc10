"""``TeraSorter(mesh).step(n_local)`` on device-resident keys.

The mesh is ``make_mesh([device] * executors)``, the capacity the
step's default; each stage sorts the same keys and ends in the read of
``overflowed``. Judged: each shard's valid prefix of ``merged``."""

from __future__ import annotations

import time

from shufflebench.entries import Out


class Entry:
    def __init__(self, cell, inputs, device):
        from sparkrdma_tpu_torch.models.terasort import TeraSorter
        from sparkrdma_tpu_torch.parallel.mesh import make_mesh

        self.shards = int(cell.config["executors"])
        self.keys = inputs["keys"]
        n = self.keys.numel()
        if n % self.shards:
            raise ValueError(f"{n} keys do not split over {self.shards} shards")
        self.sorter = TeraSorter(make_mesh([device] * self.shards))
        self.fn = self.sorter.step(n // self.shards)
        self.stage_bytes = n * self.keys.element_size()

    def stage(self, end) -> Out:
        t0 = time.perf_counter()
        merged, totals, overflowed = self.fn(self.keys)
        enqueue_s = time.perf_counter() - t0
        if end is not None:
            end.record()
        ok = not bool(overflowed)
        return Out((merged, totals), ok, totals.cpu().tolist(), enqueue_s)

    def judged(self, output) -> dict:
        merged, totals = output
        rows = merged.view(self.shards, -1)
        return {"ranges": [rows[i, :t] for i, t in enumerate(totals.cpu().tolist())]}

    def close(self) -> None:
        self.fn = self.sorter = self.keys = None
