"""PageRank by a float64 power iteration from the raw edge list.

The job of ``config["iterations"]`` iterations over ``N = 2^scale``
vertices from the uniform ranks ``1 / N``, damping ``a =
config["damping"]``:

  rank'[v] = (1 - a) / N + a * (sum over the edges (s -> v) of
             rank[s] / outdeg[s] + (rank of the vertices with no
             out-edge) / N)

Every edge counts once an iteration, duplicates and self-loops
included. The edges are read from ``inputs["edges"]`` (not from what
the program bucketed), ``CHUNK`` at a time, each chunk's contributions
added by ``index_add_``: beside the edges the reference holds a few
``[N]`` float64 vectors and one chunk, so it fits on the card after the
program's state is freed.

Judged: ``{"ranks": [N] float32}``; each stage's counts: ``[rank sum]``.
Numbers, each limit 0:

- ``rank_mismatch``: the vertices of the sampled stage whose rank ``r``
  departs from the float64 rank ``r64`` by more than ``RTOL * r64 +
  ATOL``, plus the difference in length;
- ``mass_mismatch``: the stages whose rank sum departs from 1 by more
  than ``MASS_TOL``.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

CHUNK = 1 << 26  # edges a chunk: 0.5 GB of int64 indices a column

# RTOL: the program adds an iteration's contributions into each vertex
# in float32, in whatever order its atomics land. Summing k positive
# terms rounds each partial sum to 2^-24 of itself, so the hottest
# vertex of a SCALE 26 graph (k ~ 855,000 in-edges) carries a relative
# error of about 2^-24 * sqrt(k) ~ 5e-5 at most at random rounding, the
# other vertices less. Measured on an H100 at SCALE 26 (two seeds): the
# worst vertex 5.6e-6 and 4.3e-6 (the hub), none above 1e-5. 2e-5 leaves
# it 3.6 times that; contributions rounded to bfloat16 (2^-9 each) move
# 25.4 million of the 67.1 million vertices past it, a job one
# iteration short 66.9 million.
RTOL = 2e-5
# ATOL: every rank is at least (1 - a) / N (the teleport), so a
# relative bound alone suffices; ATOL only absorbs the float32 rounding
# of the smallest ranks, 1e-9 of the mean rank 1 / N.
ATOL_OF_MEAN = 1e-9
# MASS_TOL: the float32 ranks sum to 1 up to the rounding of N terms
# and of the iterations' updates: measured 1.2e-7 to 2.2e-7 at SCALE 26
# (the sum itself is taken in float64). Contributions rounded to
# bfloat16 moved it by 4.7e-5; a stage that drops or doubles one edge
# in a hundred thousand moves it by about 1e-5.
MASS_TOL = 1e-5


def power_iteration(edges: torch.Tensor, n: int, iters: int, damping: float,
                    contribution: Optional[Callable] = None) -> torch.Tensor:
    """``[n]`` float64 ranks after ``iters`` iterations. ``contribution``
    (the control's) maps each edge's float64 contribution before it is
    added."""
    dev = edges.device
    m = edges.shape[0]
    outdeg = torch.zeros((n,), dtype=torch.float64, device=dev)
    for at in range(0, m, CHUNK):
        outdeg += torch.bincount(edges[at:at + CHUNK, 0].to(torch.int64),
                                 minlength=n).to(torch.float64)
    dangles = outdeg == 0
    rank = torch.full((n,), 1.0 / n, dtype=torch.float64, device=dev)
    for _ in range(iters):
        outc = torch.where(dangles, 0.0, rank / outdeg.clamp(min=1.0))
        inflow = torch.zeros_like(rank)
        for at in range(0, m, CHUNK):
            chunk = edges[at:at + CHUNK]
            vals = outc[chunk[:, 0].to(torch.int64)]
            if contribution is not None:
                vals = contribution(vals)
            inflow.index_add_(0, chunk[:, 1].to(torch.int64), vals)
            del vals
        dangling = rank[dangles].sum()
        rank = (1.0 - damping) / n + damping * (inflow + dangling / n)
    return rank


def _job(config: Dict):
    return (1 << int(config["scale"]), int(config["iterations"]),
            float(config["damping"]))


def compare(judged: Dict, stage_counts, inputs: Dict, config: Dict):
    n, iters, damping = _job(config)
    r64 = power_iteration(inputs["edges"], n, iters, damping)
    got = judged["ranks"].reshape(-1).to(device=r64.device, dtype=torch.float64)
    k = min(got.numel(), n)
    tol = RTOL * r64[:k] + ATOL_OF_MEAN / n
    # a NaN departs by more than any tolerance
    ranks_off = int((~((got[:k] - r64[:k]).abs() <= tol)).sum()) + abs(got.numel() - n)
    mass_off = sum(1 for counts in stage_counts
                   if len(counts) != 1 or not abs(float(counts[0]) - 1.0) <= MASS_TOL)
    numbers = {"rank_mismatch": ranks_off, "mass_mismatch": mass_off}
    return numbers, mass_off + (ranks_off > 0 and mass_off == 0)


def _bfloat16(vals: torch.Tensor) -> torch.Tensor:
    return vals.to(torch.bfloat16).to(torch.float64)


def control(inputs: Dict, config: Dict):
    """The reference at the next precision down: each edge's
    contribution rounded to bfloat16 before it is added (float64 sums
    otherwise). Returns ``(judged, counts)`` in the program's place."""
    n, iters, damping = _job(config)
    r = power_iteration(inputs["edges"], n, iters, damping, contribution=_bfloat16)
    ranks = r.to(torch.float32)
    return {"ranks": ranks}, [float(ranks.sum(dtype=torch.float64))]
