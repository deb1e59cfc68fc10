"""Resilience layer for the remote-read path (docs/RESILIENCE.md).

The reference degrades EVERY fetch failure to whole-stage recompute
(FetchFailedException -> scheduler re-run; SURVEY.md §5.1 #9). This
package is the strategy the reference lacks:

- :mod:`retry` — RetryPolicy: bounded attempts, exponential backoff
  with deterministic jitter, per-fetch deadline budget.
- :mod:`health` — per-remote-manager circuit breaker so a dead peer
  fails fast instead of burning every reducer's retry budget.

Checksums (utils/checksum.py) and the fault-injection subsystem
(testing/faults.py) complete the picture.

A copy of the JAX package's ``resilience/__init__.py``, its imports
rewritten to this package.
"""

from sparkrdma_tpu_torch.resilience.health import (
    CircuitBreaker,
    CircuitOpenError,
    SourceHealthRegistry,
)
from sparkrdma_tpu_torch.resilience.retry import RetryPolicy

__all__ = [
    "CircuitBreaker",
    "CircuitOpenError",
    "RetryPolicy",
    "SourceHealthRegistry",
]
