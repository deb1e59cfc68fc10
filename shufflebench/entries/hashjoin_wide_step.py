"""``HashJoin(mesh).step(nb_local, np_local, cap_b, cap_p)`` on the
``place()``d shard stacks of uint64 keys and int64 payloads, the
capacities as ``join()`` first sets them (``pack_roofline.capacities``);
a ``place()`` that does not keep the keys at 64 bits is refused at
set-up.
A stage, its output and what is judged are ``hashjoin_step``'s: each
stage joins the same stacks and ends in the read of ``overflow``;
judged: ``(pk2, pv2, joined, pcnt)``."""

from __future__ import annotations

import numpy as np
import torch

from shufflebench.entries import hashjoin_step
from shufflebench.pack_roofline import CAPACITY_FACTOR, capacities


def host(t: torch.Tensor) -> np.ndarray:
    """A device column as a numpy array of its dtype (a uint64 column
    crosses as its int64 bit pattern)."""
    if t.dtype == torch.uint64:
        return t.view(torch.int64).cpu().numpy().view(np.uint64)
    return t.cpu().numpy()


class Entry(hashjoin_step.Entry):
    def __init__(self, cell, inputs, device):
        from sparkrdma_tpu_torch.models.hashjoin import HashJoin
        from sparkrdma_tpu_torch.parallel.mesh import make_mesh

        e = int(cell.config["shards"])
        self.join = HashJoin(make_mesh([device] * e), capacity_factor=CAPACITY_FACTOR,
                             miss_value=int(cell.config["miss_value"]))
        cols = {k: host(v) for k, v in inputs.items()}
        self.args, nb, npl = self.join.place(
            cols["build_keys"], cols["build_vals"], cols["probe_keys"], cols["probe_vals"])
        del cols
        if [a.dtype for a in self.args] != [torch.uint64, torch.int64] * 2:
            raise ValueError("place() did not keep the rows at 64 bits: "
                             f"{[a.dtype for a in self.args]}")
        want_nb, want_np, cap_b, cap_p = capacities(cell.config)
        if (nb, npl) != (want_nb, want_np):
            raise ValueError(f"place() laid out {nb} / {npl} rows a shard, "
                             f"not {want_nb} / {want_np}")
        self.fn = self.join.step(nb, npl, cap_b, cap_p)
        self.stage_bytes = sum(v.numel() * v.element_size() for v in inputs.values())
