"""Push/merge read planning: the reduce side's merged-else-original rule.

The part of the JAX package's ``shuffle/merge.py`` that the device fetch
path calls (``DeviceShuffleIO._apply_merged_plan``): ``plan_reads``,
copied line for line. The push client, the merge endpoint and the
0xFFFD merged-segment publishes come with ROADMAP item M4; until then
no merged location is ever published, and ``plan_reads`` hands every
location list back unchanged.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

from sparkrdma_tpu_torch.locations import PartitionLocation


def plan_reads(
    locations: Sequence[PartitionLocation],
) -> Tuple[List[PartitionLocation], Dict[int, List[PartitionLocation]]]:
    """Select, per partition, the merged segment OR the originals.

    Returns ``(selected, fallbacks)``: ``selected`` replaces the input
    for fetch planning; ``fallbacks[pid]`` holds the suppressed
    original locations of every partition whose merged segment was
    chosen (the read path re-issues them if the merged read fails).
    A merged location is chosen only when its ``merged_cover`` equals
    the partition's original-location count — anything else (partial
    coverage, duplicate publish, foreign writer in the mix) keeps the
    originals authoritative and drops the merged candidate.
    """
    originals: Dict[int, List[PartitionLocation]] = {}
    merged: Dict[int, List[PartitionLocation]] = {}
    for loc in locations:
        bucket = merged if loc.block.merged_cover else originals
        bucket.setdefault(loc.partition_id, []).append(loc)
    if not merged:
        return list(locations), {}
    selected: List[PartitionLocation] = []
    fallbacks: Dict[int, List[PartitionLocation]] = {}
    for pid in sorted(set(originals) | set(merged)):
        origs = originals.get(pid, [])
        chosen = next(
            (
                m
                for m in merged.get(pid, ())
                if origs and m.block.merged_cover == len(origs)
            ),
            None,
        )
        if chosen is not None:
            selected.append(chosen)
            fallbacks[pid] = origs
        else:
            selected.extend(origs)
    return selected, fallbacks
