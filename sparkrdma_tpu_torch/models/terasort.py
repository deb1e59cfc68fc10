"""Device-resident TeraSort — the framework's flagship workload.

The PyTorch counterpart of the JAX package's ``models/terasort.py``:

- ``MapShardSorter``: the map plane's compute — pad one map shard with
  the key-space sentinel up to a power-of-two size class (floor 1024),
  sort it on the device, and cut it at the reducer range edges with a
  device ``searchsorted`` clamped to the valid count, so the shard
  comes back sorted AND cut and staging is pure slicing; ``warm`` runs
  one such sort ahead of the timed path;
- ``TeraSorter``: the global SPMD sorter over a mesh of E shards: local
  sort, range split into a bucketed send slab, the all-to-all of
  ``ExchangeProgram``, one merge of the received sorted runs
  (``merge_sorted_runs``) for every shard; overflow retry with
  doubled capacity and sampled (adaptive) range edges. One shard sorts
  locally, no split and no exchange (the JAX step's ``e == 1`` branch);
- ``merge_blocks``: the reduce side's merge of one partition's landed
  blocks (``merge_received`` over a sentinel-padded slab).

A ``TeraSorter`` step opens spans (``obs/trace.py`` ``span``), per stage
of E shards: ``terasort.step`` once around ``_build_step``'s ``fn`` (and
``short`` on one shard), the whole step; directly in it, per shard,
``terasort.local_sort`` (``device_sort``) and ``terasort.split``
(``split_sorted`` / ``split_sorted_edges`` and its send copy), then the
exchange's ``exchange.a2a`` once and ``terasort.merge``
(``merge_sorted_runs``) once.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from sparkrdma_tpu_torch.obs.trace import span
from sparkrdma_tpu_torch.ops.exchange import ExchangeProgram
from sparkrdma_tpu_torch.ops.sort import (
    device_sort,
    merge_received,
    merge_sorted_runs,
    searchsorted,
    split_sorted,
    split_sorted_edges,
)
from sparkrdma_tpu_torch.parallel.mesh import ShardMesh, make_mesh
from sparkrdma_tpu_torch.shuffle.planner import capacity_from_sample, plan_edges
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

    def warm(self, n: int, num_edges: int) -> None:
        """Run one sort and cut at ``n``'s size class ahead of the timed
        path (the JVM-startup analogue the ledger excludes): the device's
        sort and search get their workspaces and first-launch costs
        here."""
        s = device_sort(torch.full((self._size_class(n),), -1, dtype=torch.int32,
                                   device=self._device).view(torch.uint32))
        cuts = searchsorted(s, torch.zeros((num_edges,), dtype=torch.uint32,
                                           device=self._device))
        int(cuts.sum())  # waits for the device

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

    def sort_columnar_partition(
        self, frame, edges: np.ndarray
    ) -> Tuple[np.ndarray, np.ndarray]:
        """:meth:`sort_partition` taken straight off a columnar block
        (DESIGN.md §25): column 0 of ``frame`` is the uint32 key column,
        decoded as an ``np.frombuffer`` view aliasing the landed bytes;
        the view feeds the size-class pad copy directly. No pickle, no
        per-record tuples."""
        from sparkrdma_tpu_torch.shuffle import columnar

        keys = columnar.decode_columns(frame)[0]
        if keys.dtype != np.uint32:
            raise TypeError(
                f"columnar key column is {keys.dtype}, expected uint32"
            )
        return self.sort_partition(keys, edges)


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
    """Global sorter over a mesh of E shards (E a power of two).

    ``step(n_local)`` maps ``[E * n_local]`` uint32 keys on the mesh's
    device (shard ``i``'s keys at ``[i * n_local, (i + 1) * n_local)``)
    to ``(merged [E * E * capacity], totals [E] int32, overflowed int32
    scalar)``, the JAX step's contract: shard ``i``'s row of ``merged``
    (``merged.view(E, -1)[i]``) holds the globally ``i``-th key range,
    sorted, its ``totals[i]`` valid keys first. One shard short-circuits:
    ``merged`` is the ``[n_local]`` sorted keys, no split, no exchange.
    ``mesh`` defaults to one shard on ``device`` (``cuda`` unless
    ``"cpu"`` is asked for)."""

    def __init__(self, mesh: Optional[ShardMesh] = None,
                 capacity_factor: float = 2.0, device=None):
        self.mesh = mesh if mesh is not None else make_mesh(
            None if device is None else [device])
        self.device = self.mesh.device
        self.num_shards = self.mesh.num_shards
        if self.num_shards & (self.num_shards - 1):
            raise ValueError("TeraSorter requires a power-of-two shard count")
        self.capacity_factor = capacity_factor
        self._exchange = ExchangeProgram(self.mesh)
        self._step_cache = {}
        # the capacity class of each step the last ``sort`` ran
        self.last_capacities: List[int] = []

    # ------------------------------------------------------------------
    def _build_step(self, n_local: int, capacity: int, adaptive: bool):
        e = self.num_shards

        def check(keys: torch.Tensor):
            if keys.shape != (e * n_local,):
                raise ValueError(
                    f"step built for [{e * n_local}] keys, got {list(keys.shape)}"
                )
            if keys.dtype != torch.uint32:
                raise ValueError(f"TeraSorter sorts uint32 keys, not {keys.dtype}")

        if e == 1:
            def short(keys: torch.Tensor, edges=None):
                # one shard: no split, no exchange
                with span("terasort.step"):
                    check(keys)
                    with span("terasort.local_sort"):
                        merged = device_sort(keys)
                    total = torch.tensor([n_local], dtype=torch.int32,
                                         device=keys.device)
                    return merged, total, torch.zeros((), dtype=torch.int32,
                                                      device=keys.device)

            return short

        all_to_all = self._exchange.program_for(e, capacity, torch.uint32)

        def fn(keys: torch.Tensor, edges: Optional[torch.Tensor] = None):
            with span("terasort.step"):
                check(keys)
                if adaptive and edges is None:
                    raise ValueError("the adaptive step takes the range edges")
                dev = keys.device
                shards = keys.view(e, n_local)
                # uint32 data moves as its int32 bit pattern (ops/sort.py)
                send = torch.empty((e, e, capacity), dtype=torch.int32, device=dev)
                counts = torch.empty((e, e), dtype=torch.int32, device=dev)
                flags = torch.empty((e,), dtype=torch.bool, device=dev)
                for i in range(e):
                    # local sort first: destinations are key ranges, so the
                    # send slab falls out of range-edge slices
                    with span("terasort.local_sort"):
                        local = device_sort(shards[i])
                    with span("terasort.split"):
                        if adaptive:
                            slab, cnt, flags[i] = split_sorted_edges(
                                local, edges, capacity, fill=SENTINEL)
                        else:
                            slab, cnt, flags[i] = split_sorted(
                                local, e, capacity, KEY_BITS, fill=SENTINEL)
                        send[i] = slab.view(torch.int32)
                        counts[i] = cnt
                    del local, slab
                recv, rcounts = all_to_all(send.view(e * e, capacity),
                                           counts.view(-1))
                del send
                # every received row is a slice of one sender's sorted
                # keys: one merge of the runs for all shards (recv is its
                # scratch)
                with span("terasort.merge"):
                    merged, totals = merge_sorted_runs(
                        recv.view(e, e, capacity).view(torch.uint32),
                        rcounts.view(e, e), SENTINEL)
                # any shard overflowing aborts the round everywhere
                overflowed = flags.any().to(torch.int32)
                return merged.view(-1), totals, overflowed

        return fn

    def step(self, n_local: int, capacity: Optional[int] = None,
             adaptive: bool = False) -> Callable:
        """The sort step for ``[E * n_local]`` keys: ``fn(keys)``, or
        ``fn(keys, edges)`` when ``adaptive`` (``edges``: ascending
        ``[E - 1]`` uint32 range edges on the mesh's device)."""
        if capacity is None:
            capacity = self.default_capacity(n_local)
        key = (n_local, capacity, adaptive)
        fn = self._step_cache.get(key)
        if fn is None:
            fn = self._build_step(n_local, capacity, adaptive)
            self._step_cache[key] = fn
        return fn

    def default_capacity(self, n_local: int) -> int:
        cap = int(math.ceil(n_local / self.num_shards) * self.capacity_factor)
        return max(8, cap)

    # ------------------------------------------------------------------
    def sort(self, keys: np.ndarray, adaptive: bool = False,
             sample_size: int = 4096) -> np.ndarray:
        """Host-facing total sort of uint32 keys (padded to a shard
        multiple with the sentinel). A bucket overflow retries with
        doubled capacity, at most 8 times and capped at ``n_local``. With
        ``adaptive`` the range edges come from a key sample
        (``shuffle/planner.py`` ``plan_edges``) and the capacity class
        from the sampled shares."""
        n = len(keys)
        e = self.num_shards
        n_local = int(math.ceil(n / e))
        padded = np.full((e * n_local,), SENTINEL, dtype=np.uint32)
        padded[:n] = keys
        dev = torch.from_numpy(padded).to(self.device)

        use_adaptive = adaptive and e > 1 and n > 0
        if use_adaptive:
            sample = keys[:: max(1, n // max(1, sample_size))][:sample_size]
            edges_np = plan_edges(sample, e)
            # + e covers the injected sentinel padding (< e keys, all
            # routed to the last shard); a sender holds no more than
            # n_local
            capacity = min(
                n_local,
                capacity_from_sample(sample, e, n_local, edges=edges_np) + e,
            )
        else:
            edges_np = np.zeros((max(0, e - 1),), dtype=np.uint32)
            capacity = self.default_capacity(n_local)
        edges = torch.from_numpy(edges_np).to(self.device)

        self.last_capacities = []
        for _ in range(8):
            fn = self.step(n_local, capacity, adaptive=use_adaptive)
            self.last_capacities.append(capacity)
            merged, totals, overflowed = (
                fn(dev, edges) if use_adaptive else fn(dev)
            )
            if not bool(overflowed):
                break
            # n_local is a hard ceiling: no per-destination run is longer
            capacity = min(n_local, capacity * 2)
        else:
            raise RuntimeError("terasort bucket overflow after 8 capacity doublings")

        merged = merged.cpu().numpy().reshape(e, -1)
        totals = totals.cpu().numpy().reshape(-1)
        out = np.concatenate([merged[i, : totals[i]] for i in range(e)])
        # drop the padding sentinels (they sort to the tail)
        return out[:n] if n < len(out) else out
