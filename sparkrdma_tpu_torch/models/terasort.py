"""Device-resident TeraSort — the framework's flagship workload.

The PyTorch counterpart of the JAX package's ``models/terasort.py``:

- ``MapShardSorter``: the map plane's compute — pad one map shard with
  the key-space sentinel up to a power-of-two size class (floor 1024),
  sort it on the device, and cut it at the reducer range edges with a
  device ``searchsorted`` clamped to the valid count, so the shard
  comes back sorted AND cut and staging is pure slicing;
- ``TeraSorter``: the global sorter, for a one-device world (the JAX
  step's ``e == 1`` branch: a single shard sorts locally, no split and
  no exchange). More than one shard needs the exchange of the
  multi-GPU slice and raises ``NotImplementedError``;
- ``merge_blocks``: the reduce side's merge of one partition's landed
  blocks (``merge_received`` over a sentinel-padded slab).
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

import numpy as np
import torch

from sparkrdma_tpu_torch.ops.sort import device_sort, merge_received, searchsorted
from sparkrdma_tpu_torch.utils.torch_compat import resolve_device

KEY_BITS = 32
SENTINEL = 0xFFFFFFFF


class MapShardSorter:
    """Device sort + range cut of ONE map shard (uint32 keys)."""

    def __init__(self, device=None):
        self._device = resolve_device(device)

    @staticmethod
    def _size_class(n: int) -> int:
        return max(1024, 1 << (n - 1).bit_length())

    def sort_partition(
        self, keys: np.ndarray, edges: np.ndarray
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Sort ``keys`` (uint32) and cut at ``edges`` (ascending reducer
        range boundaries, len = num_reducers - 1).

        Returns ``(sorted_keys [n], bounds [num_reducers + 1])`` with
        reducer r's keys at ``sorted_keys[bounds[r]:bounds[r + 1]]``.
        """
        n = len(keys)
        cap = self._size_class(n)
        padded = np.full((cap,), SENTINEL, dtype=np.uint32)
        padded[:n] = keys
        s = device_sort(torch.from_numpy(padded).to(self._device))
        # sentinels sort to the tail; clamp every cut to the valid count
        # so an edge above the max real key cannot reach the padding
        cuts = searchsorted(
            s, torch.from_numpy(np.ascontiguousarray(edges, np.uint32))
        ).clamp_(max=n)
        local = s[:n].cpu().numpy()
        bounds = np.concatenate(
            [[0], cuts.cpu().numpy().astype(np.int64), [n]]
        )
        return local, bounds


def merge_blocks(blocks: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reduce side's merge of one partition: its landed uint32
    blocks (each 1-D, payload only) become the rows of a sentinel-padded
    slab, and ``merge_received`` sorts it. Returns ``(sorted keys, valid
    count)``; the valid keys are the prefix."""
    if not blocks:
        raise ValueError("a partition with no blocks has nothing to merge")
    dev = blocks[0].device
    counts = [b.numel() for b in blocks]
    slab = torch.zeros((len(blocks), max(counts)), dtype=torch.int32,
                       device=dev)
    for i, b in enumerate(blocks):
        slab[i, : counts[i]] = b.view(torch.int32)
    return merge_received(
        slab.view(torch.uint32),
        torch.tensor(counts, dtype=torch.int32, device=dev), SENTINEL,
    )


class TeraSorter:
    """Global sorter over a one-device world.

    ``step(n_local)`` maps ``[n_local]`` uint32 keys on the device to
    ``(sorted keys [n_local], totals [1] int32, overflowed int32)``, the
    JAX step's contract for one shard."""

    def __init__(self, world_size: int = 1, device=None):
        if world_size != 1:
            raise NotImplementedError(
                "TeraSorter over more than one shard needs the exchange "
                "plane of the multi-GPU slice"
            )
        self.num_shards = world_size
        self.device = resolve_device(device)

    def step(self, n_local: int) -> Callable:
        """The sort step for ``[n_local]`` keys (one shard: no split, no
        exchange, so no capacity class and no overflow)."""

        def fn(keys: torch.Tensor):
            if keys.shape != (n_local,):
                raise ValueError(
                    f"step built for [{n_local}] keys, got {list(keys.shape)}"
                )
            merged = device_sort(keys)
            total = torch.tensor([n_local], dtype=torch.int32,
                                 device=keys.device)
            return merged, total, torch.zeros((), dtype=torch.int32,
                                              device=keys.device)

        return fn

    def sort(self, keys: np.ndarray) -> np.ndarray:
        """Host-facing total sort of uint32 keys."""
        n = len(keys)
        dev = torch.from_numpy(np.ascontiguousarray(keys, np.uint32)).to(
            self.device
        )
        merged, totals, _ = self.step(n)(dev)
        return merged.cpu().numpy()[: int(totals[0])]
