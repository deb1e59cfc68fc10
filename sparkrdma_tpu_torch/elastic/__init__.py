"""Elastic cluster layer: executor-loss survival, speculative task
cloning, and the detachable shuffle-service daemon.

Three pillars, all behind the existing resolver/locations API
(docs/DESIGN.md §21):

- **Map-output durability** (:mod:`~sparkrdma_tpu_torch.elastic.replication`):
  every committed map output is best-effort copied to
  ``tpu.shuffle.elastic.replicas`` peer executors. Replica locations
  publish with a lineage tag (``BlockLocation.replica_of`` /
  ``source_map``) and divert into a driver-side replica registry —
  invisible to reducers until the primary's executor is lost, at which
  point ``TpuShuffleManager._on_peer_lost`` promotes them and the
  completeness barrier only drops by the maps no replica covers.
  ``engine/cluster.py`` recomputes exactly that uncovered remainder.

- **Speculative execution** (:mod:`~sparkrdma_tpu_torch.elastic.speculation`):
  the cluster driver consumes ``TelemetryHub.straggler_report()`` and
  clones a flagged executor's in-flight tasks onto a healthy peer.
  First finisher wins (the driver's first-finisher publish dedup makes
  map clones safe); the loser drains through the reader pipeline's
  existing abort latch via a ``cancel_reduce`` task request.

- **Shuffle-service daemon** (:mod:`~sparkrdma_tpu_torch.elastic.service`):
  ``python -m sparkrdma_tpu_torch.elastic.service`` runs a detachable
  process that adopts an executor's committed map outputs by file path
  — hard-link + mmap re-registration, no byte copy — and publishes
  them as replicas of that executor. Registered in the locations
  registry as a first-class source, served by the same transport, and
  covered by the circuit breakers like any peer.

A copy of the JAX package's ``elastic/__init__.py``, its imports
rewritten to this package, with the same exports.
"""

from sparkrdma_tpu_torch.elastic.replication import (
    ReplicaClient,
    ReplicaStore,
    register_store,
    store_for,
    unregister_store,
)

__all__ = [
    "ReplicaClient",
    "ReplicaStore",
    "register_store",
    "store_for",
    "unregister_store",
]
