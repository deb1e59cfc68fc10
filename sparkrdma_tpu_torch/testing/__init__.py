"""Test/bench support subsystems shipped with the framework.

:mod:`faults` — the seeded, config-driven fault-injection plan hooked
at the transport and RPC seams (docs/RESILIENCE.md). Importing this
package costs nothing at runtime: the hot-path check is a single
module-level ``active()`` None test.

A copy of the JAX package's ``testing/__init__.py``, its imports
rewritten to this package.
"""

from sparkrdma_tpu_torch.testing import faults

__all__ = ["faults"]
