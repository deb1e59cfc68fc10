"""Protocol model checker — deterministic-schedule interleaving exploration.

The invariant suite (sparkrdma_tpu_torch/analysis/) checks locks, knobs,
metrics, and wire markers; this subpackage checks the level above:
protocol *interleavings*. The real protocol code — merge seal
(shuffle/merge.py), replica promotion (shuffle/manager.py +
elastic/replication.py), speculative reduce (elastic/speculation.py),
quota backpressure (tenancy/quota.py) — runs unmodified under a
cooperative scheduler (:mod:`.sched`) that intercepts the schedule
points the lock-order plane already named (``OrderedLock``
acquire/release, pipeline queue handoffs, task-protocol send/recv,
timer fires) and explores
thread interleavings systematically (:mod:`.explore`): seeded random
walks for CI, bounded exhaustive search with sleep-set partial-order
reduction for nightly. Invariant oracles (:mod:`.models`) run at every
quiescent point; seeded protocol mutants (:mod:`.mutants`) prove the
oracles have teeth. Failing schedules serialize to replayable JSON
artifacts. See docs/ANALYSIS.md "Model checking".

A copy of the JAX package's ``analysis/modelcheck/``, its imports
rewritten to this package: the models run the port's protocol code,
and every port ``OrderedLock`` and ``schedule_point`` reaches this
scheduler (``analysis/lockorder.py``, the host-plane modules).
"""

from sparkrdma_tpu_torch.analysis.modelcheck.sched import (  # noqa: F401
    CooperativeScheduler,
    DeadlockError,
    OracleViolation,
    schedule_point,
)
