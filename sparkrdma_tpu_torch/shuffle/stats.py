"""Opt-in per-remote-endpoint fetch-latency histograms.

Analogue of RdmaShuffleReaderStats.scala (reference: RdmaShuffleReaderStats.scala): fixed buckets of
``fetch_time_num_buckets × fetch_time_bucket_size_ms``, printed at
manager stop (:48-75; RdmaShuffleManager.scala:333-335).

A copy of the JAX package's ``shuffle/stats.py``, its imports rewritten
to this package.
"""

from __future__ import annotations

import logging
import threading
from typing import Dict, List

from sparkrdma_tpu_torch.locations import ShuffleManagerId
from sparkrdma_tpu_torch.obs import get_registry
from sparkrdma_tpu_torch.utils.config import TpuShuffleConf

logger = logging.getLogger(__name__)


class RemoteFetchHistogram:
    """Fixed-bucket latency histogram (reference :25-46)."""

    def __init__(self, num_buckets: int, bucket_size_ms: int):
        # clamp degenerate shapes instead of deferring the blow-up to
        # add(): bucket_size_ms <= 0 was a ZeroDivisionError there
        self.num_buckets = max(1, int(num_buckets))
        self.bucket_size_ms = max(1, int(bucket_size_ms))
        self._buckets = [0] * (self.num_buckets + 1)  # +1 overflow bucket
        self._lock = threading.Lock()

    def add(self, latency_ms: float) -> None:
        # negative latencies (clock skew between timers) floor-divide to
        # a negative index — i.e. silently count in the overflow bucket
        # via Python's negative indexing; clamp them into bucket 0
        if latency_ms < 0:
            latency_ms = 0.0
        idx = min(int(latency_ms // self.bucket_size_ms), self.num_buckets)
        with self._lock:
            self._buckets[idx] += 1

    def snapshot(self) -> List[int]:
        with self._lock:
            return list(self._buckets)

    def format(self) -> str:
        parts = []
        buckets = self.snapshot()
        for i, count in enumerate(buckets[:-1]):
            lo = i * self.bucket_size_ms
            hi = (i + 1) * self.bucket_size_ms
            parts.append(f"[{lo}-{hi}ms: {count}]")
        parts.append(f"[>{self.num_buckets * self.bucket_size_ms}ms: {buckets[-1]}]")
        return " ".join(parts)


class ShuffleReaderStats:
    def __init__(self, conf: TpuShuffleConf):
        self._num_buckets = conf.fetch_time_num_buckets
        self._bucket_size_ms = conf.fetch_time_bucket_size_ms
        self._per_remote: Dict[ShuffleManagerId, RemoteFetchHistogram] = {}
        self._lock = threading.Lock()

    def update_remote_fetch_histogram(
        self, remote: ShuffleManagerId, latency_ms: float
    ) -> None:
        with self._lock:
            hist = self._per_remote.get(remote)
            if hist is None:
                hist = RemoteFetchHistogram(self._num_buckets, self._bucket_size_ms)
                self._per_remote[remote] = hist
        hist.add(latency_ms)
        # mirror into the unified registry so snapshots see the same
        # distribution without opting into reader_stats
        get_registry().histogram(
            "reader.remote_fetch_ms", peer=remote.executor_id
        ).observe(latency_ms)

    def snapshot(self) -> Dict[str, List[int]]:
        """Live queryable form of what ``print_stats`` logs at stop:
        remote endpoint -> bucket counts (last bucket = overflow)."""
        with self._lock:
            items = list(self._per_remote.items())
        return {
            f"{mid.executor_id}@{mid.host}:{mid.port}": hist.snapshot()
            for mid, hist in items
        }

    def print_stats(self) -> None:
        with self._lock:
            items = list(self._per_remote.items())
        for remote, hist in items:
            logger.info(
                "fetch latency from %s:%d (%s): %s",
                remote.host,
                remote.port,
                remote.executor_id,
                hist.format(),
            )
