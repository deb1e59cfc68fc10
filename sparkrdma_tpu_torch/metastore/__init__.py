"""Control-plane HA: sharded, lease-replicated metadata hub.

The driver has always been the metadata hub for every published
``(address, length, mkey)`` partition location (SURVEY §0,
shuffle/manager.py). The elastic layer makes the *data* plane survive
executor loss; this package removes the matching control-plane single
point of failure:

- :mod:`~sparkrdma_tpu_torch.metastore.shardmap` — a consistent-hash ring
  that shards the locations registry by ``(shuffle_id, partition
  range)`` across logical metadata peers, with the full-cover and
  minimal-movement properties pinned by tests;
- :mod:`~sparkrdma_tpu_torch.metastore.lease` — the explicit lease/epoch
  protocol: each peer serves its shards under a renewable lease, every
  write carries the epoch it routed against, and a stale epoch is a
  typed rejection (:class:`StaleEpochError`) retried through the
  resilience retry ladder;
- :mod:`~sparkrdma_tpu_torch.metastore.store` — the sharded store itself:
  epoch-fenced publish/resolve, per-shard executor tombstones (the
  swept-publisher check holds per shard, not per process), follower
  replication with single-primary serving, peer kill with follower
  takeover, and driver-crash ``wipe()`` + generation-fenced
  re-adoption from executors.

See docs/RESILIENCE.md "Control-plane HA" for the state machine and
the chaos bar (driver killed mid-job → the job resumes and completes
byte-identically).

A copy of the JAX package's ``metastore/__init__.py``, its imports
rewritten to this package.
"""

from sparkrdma_tpu_torch.metastore.lease import LeaseTable, ShardLease, StaleEpochError
from sparkrdma_tpu_torch.metastore.shardmap import ShardMap
from sparkrdma_tpu_torch.metastore.store import MetaShard, ShardedMetaStore

__all__ = [
    "LeaseTable",
    "MetaShard",
    "ShardLease",
    "ShardMap",
    "ShardedMetaStore",
    "StaleEpochError",
]
