"""Minimal resilient-dataset API hosting the shuffle framework.

The reference is a plugin inside Spark; Spark itself supplies the
DAGScheduler, ShuffledRDD and task execution (SURVEY.md §1 "Sits
above"). This module supplies that host role so workloads (TeraSort,
WordCount, PageRank, ALS — BASELINE.md configs) can run end-to-end on
the TPU shuffle manager: lazy lineage of narrow ops, wide ops cut at
shuffle dependencies, stage recompute on fetch failure.

A copy of the JAX package's ``engine/rdd.py``, its imports rewritten to
this package; ``sort_by_key``'s sampled bounds are the JAX package's
(the same seeds, ``random.Random(17 + p)``).
"""

from __future__ import annotations

import itertools
import random
from typing import Callable, Iterator, List, Optional

from sparkrdma_tpu_torch.shuffle.handle import (
    Aggregator,
    BaseShuffleHandle,
    HashPartitioner,
    Partitioner,
    RangePartitioner,
)


class RDD:
    def __init__(self, ctx, num_partitions: int):
        self.ctx = ctx
        self.num_partitions = num_partitions
        self.rdd_id = ctx._next_rdd_id()

    def compute(self, partition: int) -> Iterator:
        raise NotImplementedError

    # -- narrow transformations ----------------------------------------
    def map(self, f: Callable) -> "RDD":
        return MapPartitionsRDD(self, lambda it: (f(x) for x in it))

    def flat_map(self, f: Callable) -> "RDD":
        return MapPartitionsRDD(
            self, lambda it: (y for x in it for y in f(x))
        )

    def filter(self, f: Callable) -> "RDD":
        return MapPartitionsRDD(self, lambda it: (x for x in it if f(x)))

    def map_partitions(self, f: Callable[[Iterator], Iterator]) -> "RDD":
        return MapPartitionsRDD(self, f)

    def key_by(self, f: Callable) -> "RDD":
        return self.map(lambda x: (f(x), x))

    # -- wide transformations (shuffle boundaries) ---------------------
    def partition_by(self, partitioner: Partitioner) -> "RDD":
        return ShuffledRDD(self, partitioner)

    def reduce_by_key(self, f: Callable, num_partitions: Optional[int] = None) -> "RDD":
        agg = Aggregator(lambda v: v, f, f)
        return ShuffledRDD(
            self,
            HashPartitioner(num_partitions or self.num_partitions),
            aggregator=agg,
            map_side_combine=True,
        )

    def group_by_key(self, num_partitions: Optional[int] = None) -> "RDD":
        agg = Aggregator(
            lambda v: [v],
            lambda c, v: (c.append(v), c)[1],
            lambda a, b: a + b,
        )
        return ShuffledRDD(
            self,
            HashPartitioner(num_partitions or self.num_partitions),
            aggregator=agg,
        )

    def sort_by_key(self, num_partitions: Optional[int] = None) -> "RDD":
        """Total order: range-partition on sampled bounds + per-partition sort."""
        n = num_partitions or self.num_partitions
        bounds = self._sample_bounds(n)
        return ShuffledRDD(self, RangePartitioner(bounds), key_ordering=True)

    def _sample_bounds(self, num_partitions: int, sample_per_part: int = 200) -> List:
        if num_partitions <= 1:
            return []
        sample: List = []
        for p in range(self.num_partitions):
            it = self.compute_via_ctx(p)
            part_sample = list(itertools.islice(it, sample_per_part * 5))
            if len(part_sample) > sample_per_part:
                part_sample = random.Random(17 + p).sample(part_sample, sample_per_part)
            sample.extend(k for k, _ in part_sample)
        if not sample:
            return []
        sample.sort()
        step = len(sample) / num_partitions
        bounds = [sample[int(step * i)] for i in range(1, num_partitions)]
        # dedupe to keep RangePartitioner sound on skewed keys
        out: List = []
        for b in bounds:
            if not out or b > out[-1]:
                out.append(b)
        return out

    def join(self, other: "RDD", num_partitions: Optional[int] = None) -> "RDD":
        """Hash join via cogroup semantics on a shared shuffle."""
        n = num_partitions or max(self.num_partitions, other.num_partitions)
        tagged = self.map(lambda kv: (kv[0], (0, kv[1]))).union(
            other.map(lambda kv: (kv[0], (1, kv[1])))
        )
        grouped = tagged.group_by_key(n)

        def emit(kv):
            k, vals = kv
            left = [v for tag, v in vals if tag == 0]
            right = [v for tag, v in vals if tag == 1]
            return [(k, (loc, r)) for loc in left for r in right]

        return grouped.flat_map(emit)

    def union(self, other: "RDD") -> "RDD":
        return UnionRDD(self, other)

    # -- actions --------------------------------------------------------
    def collect(self) -> List:
        return self.ctx.run_job(self)

    def count(self) -> int:
        return len(self.collect())

    def reduce(self, f: Callable):
        vals = self.collect()
        import functools

        return functools.reduce(f, vals)

    def compute_via_ctx(self, partition: int) -> Iterator:
        """Compute one partition, materializing parent shuffles first."""
        self.ctx.ensure_parents(self)
        return self.compute(partition)


class ParallelCollectionRDD(RDD):
    def __init__(self, ctx, data: List, num_partitions: int):
        super().__init__(ctx, num_partitions)
        self._slices: List[List] = [[] for _ in range(num_partitions)]
        for i, item in enumerate(data):
            self._slices[i % num_partitions].append(item)

    def compute(self, partition: int) -> Iterator:
        return iter(self._slices[partition])


class GeneratorRDD(RDD):
    """Partitions produced by a generator fn(partition_index) → iterator."""

    def __init__(self, ctx, gen: Callable[[int], Iterator], num_partitions: int):
        super().__init__(ctx, num_partitions)
        self._gen = gen

    def compute(self, partition: int) -> Iterator:
        return self._gen(partition)


class MapPartitionsRDD(RDD):
    def __init__(self, parent: RDD, f: Callable[[Iterator], Iterator]):
        super().__init__(parent.ctx, parent.num_partitions)
        self.parent = parent
        self.f = f

    def compute(self, partition: int) -> Iterator:
        return self.f(self.parent.compute(partition))


class UnionRDD(RDD):
    def __init__(self, a: RDD, b: RDD):
        super().__init__(a.ctx, a.num_partitions + b.num_partitions)
        self.a = a
        self.b = b

    def compute(self, partition: int) -> Iterator:
        if partition < self.a.num_partitions:
            return self.a.compute(partition)
        return self.b.compute(partition - self.a.num_partitions)


class ShuffledRDD(RDD):
    def __init__(
        self,
        parent: RDD,
        partitioner: Partitioner,
        aggregator: Optional[Aggregator] = None,
        map_side_combine: bool = False,
        key_ordering: bool = False,
    ):
        super().__init__(parent.ctx, partitioner.num_partitions)
        self.parent = parent
        self.partitioner = partitioner
        self.aggregator = aggregator
        self.map_side_combine = map_side_combine
        self.key_ordering = key_ordering
        self.handle: Optional[BaseShuffleHandle] = None  # set when materialized

    def compute(self, partition: int) -> Iterator:
        assert self.handle is not None, "shuffle not materialized"
        executor = self.ctx.executor_for_partition(partition)
        reader = executor.get_reader(self.handle, partition, partition + 1)

        def closing():
            # reader.close() on exit (success OR mid-iteration abandon):
            # unconsumed fetched streams release deterministically
            try:
                yield from reader.read()
            finally:
                reader.close()

        return closing()
