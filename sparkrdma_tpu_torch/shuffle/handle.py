"""Shuffle handles and the pluggable job-semantics interfaces.

Analogue of Spark's BaseShuffleHandle/SerializedShuffleHandle choice the
reference makes in registerShuffle (reference: RdmaShuffleManager.scala:
231-238) plus the dependency attributes (partitioner, serializer,
aggregator, ordering) the reader/writer paths consume
(RdmaShuffleReader.scala:69-112).

A copy of the JAX package's ``shuffle/handle.py``, its imports rewritten
to this package.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

from sparkrdma_tpu_torch.engine.serializer import PickleSerializer, Serializer


@dataclass
class Aggregator:
    """combineValuesByKey/combineCombinersByKey semantics.

    create_combiner(v) → c; merge_value(c, v) → c; merge_combiners(c1, c2) → c.
    """

    create_combiner: Callable
    merge_value: Callable
    merge_combiners: Callable


def combine_by_key(records, agg: "Aggregator", values_are_combiners: bool = False) -> dict:
    """The shared combineValuesByKey / combineCombinersByKey fold.

    Used by both writer methods (map-side combine) and the reader
    (reduce-side), keeping the symmetric contract in one place.
    """
    combined: dict = {}
    if values_are_combiners:
        for k, c in records:
            if k in combined:
                combined[k] = agg.merge_combiners(combined[k], c)
            else:
                combined[k] = c
    else:
        for k, v in records:
            if k in combined:
                combined[k] = agg.merge_value(combined[k], v)
            else:
                combined[k] = agg.create_combiner(v)
    return combined


class Partitioner:
    num_partitions: int

    def partition(self, key) -> int:  # pragma: no cover - interface
        raise NotImplementedError


class HashPartitioner(Partitioner):
    def __init__(self, num_partitions: int):
        self.num_partitions = num_partitions

    def partition(self, key) -> int:
        return hash(key) % self.num_partitions


class RangePartitioner(Partitioner):
    """Sorted-output partitioner: keys ≤ bounds[i] go to partition i."""

    def __init__(self, bounds):
        self.bounds = list(bounds)
        self.num_partitions = len(self.bounds) + 1

    def partition(self, key) -> int:
        import bisect

        return bisect.bisect_left(self.bounds, key)


@dataclass
class BaseShuffleHandle:
    shuffle_id: int
    num_maps: int
    partitioner: Partitioner
    serializer: Serializer = field(default_factory=PickleSerializer)
    aggregator: Optional[Aggregator] = None
    map_side_combine: bool = False
    key_ordering: bool = False

    @property
    def num_partitions(self) -> int:
        return self.partitioner.num_partitions
