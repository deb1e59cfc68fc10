"""RetryPolicy — bounded, deterministic retry/backoff for group READs.

The fetcher's retry ladder (shuffle/fetcher.py) walks one rung per
failed attempt of a group:

  attempt 0   initial READ
  attempt 1   retry the same source (transient channel hiccups)
  attempt 2   re-resolve locations from the driver and failover
              (stale mkeys / respawned writers)
  attempt 3+  split the aggregated group and retry blocks one by one
              (isolates a single poisoned block)
  exhausted   FetchFailedError -> stage recompute (the reference's
              only move, now the LAST resort)

Backoff jitter is deterministic — a hash of (shuffle, partition,
attempt) — so fault-plan tests reproduce byte-identical schedules run
to run, and concurrent reducers still decorrelate.

A copy of the JAX package's ``resilience/retry.py``, its imports
rewritten to this package.
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass


@dataclass(frozen=True)
class RetryPolicy:
    """Knobs live under ``tpu.shuffle.resilience.*`` (utils/config.py)."""

    max_attempts: int = 4
    backoff_ms: int = 50
    backoff_max_ms: int = 2000
    deadline_ms: int = 0  # 0 = unbounded (per-group wall budget)

    @classmethod
    def from_conf(cls, conf) -> "RetryPolicy":
        return cls(
            max_attempts=conf.max_fetch_attempts,
            backoff_ms=conf.retry_backoff_ms,
            backoff_max_ms=conf.retry_backoff_max_ms,
            deadline_ms=conf.fetch_deadline_ms,
        )

    def allows(self, attempt: int) -> bool:
        """True if attempt number ``attempt`` (0-based) may be issued."""
        return attempt < self.max_attempts

    def deadline_s(self) -> float:
        """Per-group wall budget in seconds; +inf when unbounded."""
        return self.deadline_ms / 1000.0 if self.deadline_ms > 0 else float("inf")

    def backoff_s(self, attempt: int, *keys) -> float:
        """Delay before re-issuing after failed attempt ``attempt``.

        Exponential base with deterministic jitter in [0.5, 1.0]× drawn
        from a crc32 of (attempt, *keys) — stable across runs, varied
        across groups.
        """
        base = min(self.backoff_ms * (2 ** attempt), self.backoff_max_ms)
        h = zlib.crc32(repr((attempt,) + keys).encode()) & 0xFFFFFFFF
        return base * (0.5 + 0.5 * (h / 0xFFFFFFFF)) / 1000.0
