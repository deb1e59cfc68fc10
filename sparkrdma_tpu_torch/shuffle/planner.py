"""Partition planning: the uniform reduce split and the SPMD TeraSort's
sampled range edges.

The numpy-only part of the JAX package's ``shuffle/planner.py``, kept
as the port's own copy:

- ``static_bounds``: the uniform id-space split reduce plans use when no
  sizes exist;
- ``plan_edges``: ascending quantile key edges from a host-side key
  sample, so the all-to-all's receive counts balance under any key
  distribution (``TeraSorter.sort(adaptive=True)``);
- ``capacity_from_sample``: the receive capacity class those edges (or
  the static top-bits ranges) call for.

The byte-balancing ``AdaptivePartitioner`` waits for the host-plane
slice.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def static_bounds(num_partitions: int, num_reducers: int) -> List[Tuple[int, int]]:
    """The uniform id-space split reduce plans use when no sizes exist."""
    return [
        (w * num_partitions // num_reducers,
         (w + 1) * num_partitions // num_reducers)
        for w in range(num_reducers)
    ]


def plan_edges(sample, num_shards: int) -> np.ndarray:
    """Ascending quantile key edges (len ``num_shards - 1``) from a
    host-side key sample: shard ``i`` owns keys in ``[edges[i-1],
    edges[i])``."""
    arr = np.asarray(sample, dtype=np.uint32)
    if num_shards <= 1 or arr.size == 0:
        return np.zeros((max(0, num_shards - 1),), dtype=np.uint32)
    qs = np.arange(1, num_shards) / num_shards
    edges = np.quantile(arr.astype(np.float64), qs)
    return np.minimum(edges, float(np.iinfo(np.uint32).max)).astype(np.uint32)


def capacity_from_sample(sample, num_shards: int, n_local: int,
                         edges=None, slack: float = 1.25) -> int:
    """Receive-capacity estimate from a sample: the largest shard share
    seen in the sample, scaled to ``n_local`` keys per shard with
    ``slack`` headroom. With quantile ``edges`` the shares are near
    uniform; without edges it measures the static top-bits skew."""
    arr = np.asarray(sample, dtype=np.uint32)
    if arr.size == 0 or num_shards <= 1:
        return max(8, n_local)
    if edges is None:
        shift = 32 - (num_shards.bit_length() - 1)
        dest = (arr >> np.uint32(shift)).astype(np.int64)
    else:
        dest = np.searchsorted(np.asarray(edges, dtype=np.uint32), arr,
                               side="right").astype(np.int64)
    counts = np.bincount(dest, minlength=num_shards)
    max_share = counts.max() / arr.size
    # every shard contributes up to n_local keys to the hottest receiver
    est = int(max_share * n_local * slack) + 8
    return max(8, est)
