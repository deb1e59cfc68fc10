"""Partition planning: the uniform reduce split, the byte-balanced
reduce ranges and the SPMD TeraSort's sampled range edges.

A copy of the JAX package's ``shuffle/planner.py``, its imports
rewritten to this package:

- ``static_bounds``: the uniform id-space split reduce plans use when no
  sizes exist;
- ``AdaptivePartitioner``: contiguous reduce ranges balanced against the
  map stage's published per-partition bytes (hot partitions isolated,
  tiny neighbours coalesced; the static plan kept when it is already
  balanced), which ``engine/cluster.py`` plans its reduce fan-out with;
- ``plan_edges``: ascending quantile key edges from a host-side key
  sample, so the all-to-all's receive counts balance under any key
  distribution (``TeraSorter.sort(adaptive=True)``);
- ``capacity_from_sample``: the receive capacity class those edges (or
  the static top-bits ranges) call for.
"""

from __future__ import annotations

import logging
import time
from typing import Dict, List, Sequence, Tuple

import numpy as np

from sparkrdma_tpu_torch.obs.metrics import get_registry
from sparkrdma_tpu_torch.utils.config import TpuShuffleConf

logger = logging.getLogger(__name__)


def static_bounds(num_partitions: int, num_reducers: int) -> List[Tuple[int, int]]:
    """The uniform id-space split reduce plans use when no sizes exist."""
    return [
        (w * num_partitions // num_reducers,
         (w + 1) * num_partitions // num_reducers)
        for w in range(num_reducers)
    ]


class AdaptivePartitioner:
    """Byte-balanced contiguous reduce ranges from published sizes."""

    def __init__(self, conf: TpuShuffleConf = None):
        self.conf = conf or TpuShuffleConf()
        self.hot_factor = max(1.0, float(self.conf.planner_hot_factor))
        reg = get_registry()
        self._m_splits = reg.counter("planner.splits", role="driver")
        self._m_coalesces = reg.counter("planner.coalesces", role="driver")
        self._m_plan_ms = reg.histogram("planner.plan_ms", role="driver")

    # ------------------------------------------------------------------
    def plan(
        self, sizes: Sequence[int], num_reducers: int,
        lane_sizes: Dict[str, Sequence[int]] = None,
    ) -> List[Tuple[int, int]]:
        """Contiguous ``(lo, hi)`` ranges covering ``[0, P)``, at most
        ``num_reducers`` of them, byte-balanced against ``sizes``.

        Greedy boundary placement with a recomputed target
        (remaining_bytes / remaining_ranges) so early over-full ranges
        don't starve the tail, plus hot-partition isolation: a
        partition whose size is >= hot_factor * ideal gets its own
        range when possible (cut before it and after it).

        ``lane_sizes`` (source executor -> per-partition bytes) switches
        the cost function from byte totals to DMA-LANE cost: the
        collective schedule's wave wall is set by its hottest source
        lane, not the byte sum, so a partition fed overwhelmingly by one
        source costs ``num_lanes * max_lane_bytes`` even when its total
        looks benign. Cuts then balance lane occupancy across reducers
        (the whole-stage schedule compiler's wave planner, DESIGN.md
        §22)."""
        t0 = time.perf_counter()
        if lane_sizes:
            sizes = self._lane_costs(sizes, lane_sizes)
        p = len(sizes)
        n = max(1, int(num_reducers))
        if p == 0:
            return []
        uniform = static_bounds(p, n)
        total = sum(sizes)
        if total <= 0 or n == 1:
            return uniform if n > 1 else [(0, p)]
        ideal = total / n
        hot = self.hot_factor * ideal
        # conservatism: keep the static plan when it is already balanced
        static_max = max(sum(sizes[lo:hi]) for lo, hi in uniform)
        if static_max <= hot:
            self._m_plan_ms.observe((time.perf_counter() - t0) * 1000.0)
            return uniform

        ranges: List[Tuple[int, int]] = []
        lo = 0
        acc = 0
        remaining = total
        for pid in range(p):
            ranges_left = n - len(ranges)
            if ranges_left <= 1:
                break  # last range takes everything left
            target = remaining / ranges_left
            s = sizes[pid]
            # cut BEFORE a hot partition so it starts its own range
            if s >= hot and acc > 0:
                ranges.append((lo, pid))
                remaining -= acc
                lo, acc = pid, 0
                ranges_left = n - len(ranges)
                if ranges_left <= 1:
                    break
                target = remaining / ranges_left
            acc += s
            # cut AFTER a range reaching target (or after a hot pid)
            if acc >= target or s >= hot:
                ranges.append((lo, pid + 1))
                remaining -= acc
                lo, acc = pid + 1, 0
        if lo < p:
            ranges.append((lo, p))
        elif not ranges or ranges[-1][1] < p:
            # defensive: never under-cover the id space
            start = ranges[-1][1] if ranges else 0
            ranges.append((start, p))

        # metrics: splits = hot partitions isolated into 1-wide ranges;
        # coalesces = ranges wider than the uniform width (tiny
        # neighbors folded together)
        uniform_width = -(-p // n)  # ceil
        splits = sum(
            1 for (a, b) in ranges if b - a == 1 and sizes[a] >= hot
        )
        coalesces = sum(1 for (a, b) in ranges if b - a > uniform_width)
        if splits:
            self._m_splits.inc(splits)
        if coalesces:
            self._m_coalesces.inc(coalesces)
        self._m_plan_ms.observe((time.perf_counter() - t0) * 1000.0)
        logger.debug(
            "adaptive plan: %d ranges over %d partitions "
            "(%d splits, %d coalesces, max load %.2fx ideal)",
            len(ranges), p, splits, coalesces,
            max(sum(sizes[a:b]) for a, b in ranges) / ideal if ideal else 0.0,
        )
        return ranges

    # ------------------------------------------------------------------
    def _lane_costs(
        self, sizes: Sequence[int], lane_sizes: Dict[str, Sequence[int]]
    ) -> List[int]:
        """Per-partition DMA-lane cost: ``max(total, L * hottest_lane)``.

        A ring-scheduled wave moves one source lane at a time, so a
        partition's fetch wall is its hottest lane times the lane
        count when one source dominates — and never better than its
        byte total when sources are balanced (then the two coincide)."""
        lanes = [list(v) for v in lane_sizes.values() if v]
        if not lanes:
            return list(sizes)
        n_lanes = len(lanes)
        costs: List[int] = []
        for pid in range(len(sizes)):
            hottest = max(
                (lane[pid] if pid < len(lane) else 0) for lane in lanes
            )
            costs.append(max(sizes[pid], n_lanes * hottest))
        get_registry().counter("collective.lane_plans", role="driver").inc()
        return costs

    # ------------------------------------------------------------------
    def plan_weights(self, sizes: Dict[int, int]) -> List[int]:
        """Partition ids heaviest-first — the scheduling order signal
        (TpuContext.run_job submits hot partitions first)."""
        return sorted(sizes, key=lambda pid: -sizes[pid])


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
