"""A range-partitioned sort: part ``r`` of ``P`` holds every input key
in ``[r * 2^32 / P, (r + 1) * 2^32 / P)``, ascending, each exactly as
often as the input holds it.

Judged: ``{"ranges": [P 1-D uint32 tensors]}``, each part as the
program reports it (its valid prefix by its own count). Numbers:

- ``count_mismatch``: over every completed stage of the window, the
  sum of ``|count - reference count|`` of each part;
- ``key_mismatch``: in the sampled stage, the keys that differ from
  the reference at their position, plus each part's length difference.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

MASK = 0xFFFFFFFF


def u64(x: torch.Tensor) -> torch.Tensor:
    """uint32 keys as int64 values in [0, 2^32)."""
    return x.view(torch.int32).to(torch.int64) & MASK


def edges(parts: int, device) -> torch.Tensor:
    return torch.tensor([(r << 32) // parts for r in range(1, parts)],
                        dtype=torch.int64, device=device)


def part_of(k64: torch.Tensor, parts: int) -> torch.Tensor:
    return torch.bucketize(k64, edges(parts, k64.device), right=True)


def expected(keys: torch.Tensor, parts: int):
    """``(counts, part r's sorted keys as int64 for r in range(parts))``,
    the parts made one at a time."""
    k64 = u64(keys)
    dest = part_of(k64, parts)
    counts = torch.bincount(dest, minlength=parts).tolist()
    for r in range(parts):
        yield counts, torch.sort(k64[dest == r]).values


def count_mismatch(stage_counts: Sequence[Sequence[int]], want: List[int]) -> Tuple[int, int]:
    """``(summed |difference|, stages with any)`` over the stages."""
    total = bad = 0
    for counts in stage_counts:
        if len(counts) != len(want):
            d = sum(want)
        else:
            d = sum(abs(int(c) - int(w)) for c, w in zip(counts, want))
        total += d
        bad += d > 0
    return total, bad


def compare(judged: Dict, stage_counts, inputs: Dict, config: Dict):
    ranges = judged["ranges"]
    keys_mismatched = 0
    want = None
    for r, (counts, ref) in enumerate(expected(inputs["keys"], len(ranges))):
        want = counts
        got = u64(ranges[r].reshape(-1).to(ref.device))
        m = min(got.numel(), ref.numel())
        keys_mismatched += int((got[:m] != ref[:m]).sum()) + abs(got.numel() - ref.numel())
    counts_off, bad = count_mismatch(stage_counts, want)
    numbers = {"count_mismatch": counts_off, "key_mismatch": keys_mismatched}
    return numbers, bad + (keys_mismatched > 0 and bad == 0)


def as_u32(k64: torch.Tensor) -> torch.Tensor:
    return (k64 - ((k64 >> 31) << 32)).to(torch.int32).view(torch.uint32)


def control(inputs: Dict, config: Dict):
    """The reference at the next width down: each of
    ``config["reducers"]`` parts sorted by the key's top 16 bits only,
    ties in input order (a 16-bit prefix sort). Returns ``(judged,
    counts)`` in the program's place."""
    parts = int(config["reducers"])
    k64 = u64(inputs["keys"])
    dest = part_of(k64, parts)
    ranges = []
    for r in range(parts):
        kr = k64[dest == r]
        ranges.append(as_u32(kr[torch.sort(kr >> 16, stable=True).indices]))
    return {"ranges": ranges}, [t.numel() for t in ranges]
