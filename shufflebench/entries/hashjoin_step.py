"""``HashJoin(mesh).step(nb_local, np_local, cap_b, cap_p)`` on the
``place()``d shard stacks, the capacities as ``join()`` first sets
them. Each stage joins the same stacks and ends in the read of
``overflow``. Judged: ``(pk2, pv2, joined, pcnt)``."""

from __future__ import annotations

import math
import time

from shufflebench.entries import Out


class Entry:
    def __init__(self, cell, inputs, device):
        from sparkrdma_tpu_torch.models.hashjoin import HashJoin
        from sparkrdma_tpu_torch.parallel.mesh import make_mesh

        e = int(cell.config["shards"])
        self.join = HashJoin(make_mesh([device] * e),
                             miss_value=int(cell.config["miss_value"]))
        host = {k: v.cpu().numpy() for k, v in inputs.items()}
        self.args, nb, npl = self.join.place(
            host["build_keys"], host["build_vals"],
            host["probe_keys"], host["probe_vals"])
        del host
        factor = self.join.capacity_factor
        cap_b = max(8, int(math.ceil(nb / e) * factor))
        cap_p = max(8, int(math.ceil(npl / e) * factor))
        self.fn = self.join.step(nb, npl, cap_b, cap_p)
        self.stage_bytes = sum(v.numel() * v.element_size() for v in inputs.values())

    def stage(self, end) -> Out:
        t0 = time.perf_counter()
        pk2, pv2, joined, pcnt, overflow = self.fn(*self.args)
        enqueue_s = time.perf_counter() - t0
        if end is not None:
            end.record()
        ok = not bool(overflow)
        return Out((pk2, pv2, joined, pcnt), ok, pcnt.cpu().tolist(), enqueue_s)

    def judged(self, output) -> dict:
        pk2, pv2, joined, pcnt = output
        return {"pk2": pk2, "pv2": pv2, "joined": joined, "pcnt": pcnt}

    def close(self) -> None:
        self.fn = self.args = self.join = None
