"""Failure types surfaced to the scheduler for recompute.

Analogues of Spark's FetchFailedException / MetadataFetchFailedException
as the reference raises them (RdmaShuffleFetcherIterator.scala:381-391,
226-237): failures never hang the iterator — they surface so the
scheduler can re-run the producing stage (SURVEY.md §5.1 #9).

A copy of the JAX package's ``shuffle/errors.py``, its imports rewritten
to this package.
"""

from __future__ import annotations

from typing import Optional

from sparkrdma_tpu_torch.locations import ShuffleManagerId


class ShuffleError(Exception):
    pass


class FetchFailedError(ShuffleError):
    def __init__(
        self,
        manager_id: Optional[ShuffleManagerId],
        shuffle_id: int,
        map_id: int,
        partition_id: int,
        message: str,
    ):
        self.manager_id = manager_id
        self.shuffle_id = shuffle_id
        self.map_id = map_id
        self.partition_id = partition_id
        super().__init__(
            f"fetch failed: shuffle {shuffle_id} partition {partition_id} "
            f"from {manager_id}: {message}"
        )


class MetadataFetchFailedError(ShuffleError):
    def __init__(self, shuffle_id: int, partition_id: int, message: str):
        self.shuffle_id = shuffle_id
        self.partition_id = partition_id
        super().__init__(
            f"metadata fetch failed: shuffle {shuffle_id} partition {partition_id}: {message}"
        )


class ChecksumError(IOError):
    """A fetched block's bytes do not match the published checksum.

    Deliberately an IOError, not a ShuffleError: inside the fetcher it
    is a *retryable* transport-grade fault (the retry ladder re-reads
    the block); only retry exhaustion promotes it into the
    FetchFailedError that triggers stage recompute."""

    def __init__(self, shuffle_id: int, partition_id: int, message: str):
        self.shuffle_id = shuffle_id
        self.partition_id = partition_id
        super().__init__(
            f"checksum mismatch: shuffle {shuffle_id} partition {partition_id}: {message}"
        )
