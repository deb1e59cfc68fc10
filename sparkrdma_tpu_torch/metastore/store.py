"""The sharded, lease-replicated locations store the driver serves from.

Replaces the driver's monolithic ``_partition_locations`` dict
(shuffle/manager.py) as the authoritative registry:

- every ``(shuffle_id, partition range)`` key routes through the
  consistent-hash ring (:mod:`shardmap`) to a primary peer plus
  ``metastore.replicas`` followers; writes apply to every owner,
  reads serve the primary's copy only (:meth:`_read_copies`);
- every write carries the epoch it routed against; the apply-side
  check (:meth:`MetaShard._epoch_ok`) fences writes routed under a
  lease that expired, was revoked, or was taken over in between —
  :class:`StaleEpochError`, retried through the resilience retry ladder
  after re-routing;
- executor tombstones live **per shard** (:meth:`MetaShard._blocked`):
  a publish racing ``_on_peer_lost`` either lands before that shard's
  sweep (and is pruned by it) or serializes after it (and sees the
  tombstone) — there is no per-process window (the manager.py:490
  hazard, pinned by the ``meta_lease`` modelcheck model);
- ``kill_peer`` drops a metadata peer: its lease is revoked, the ring
  remaps only its ranges (minimal movement), and the former follower
  — which already holds the copies — becomes primary with zero
  metadata loss;
- ``wipe`` models driver death: every entry is gone, every lease
  re-grants under a bumped epoch, and the **generation** counter
  advances so re-adoption publishes from executors
  (``republish_for_readoption``) are fenced against sweeps started
  under an older takeover (:meth:`_fence_generation`).

Lock order (enforced by the lock-order detector): ``manager.shuffle``
OUTER → ``metastore.topology`` → ``metastore.shard`` leaf. Shard locks
are only ever held for dict mutation; lease transitions run under the
topology lock with shard epochs mirrored in (so the apply path needs
the leaf lock only).

A copy of the JAX package's ``metastore/store.py``, its imports
rewritten to this package (the lock-order, model-checker and journal
calls go to the inert seams of ``utils/seams.py``).
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Tuple

from sparkrdma_tpu_torch.utils.seams import named_lock
from sparkrdma_tpu_torch.utils.seams import schedule_point
from sparkrdma_tpu_torch.locations import PartitionLocation
from sparkrdma_tpu_torch.metastore.lease import LeaseTable, StaleEpochError
from sparkrdma_tpu_torch.metastore.shardmap import ShardMap
from sparkrdma_tpu_torch.obs import get_registry
from sparkrdma_tpu_torch.utils.seams import journal_emit
from sparkrdma_tpu_torch.resilience.retry import RetryPolicy
from sparkrdma_tpu_torch.utils.seams import faults as _faults

Key = Tuple[int, int]  # (shuffle_id, partition_id)


class MetaShard:
    """One metadata peer's slice of the registry."""

    def __init__(self, name: str):
        self.name = name
        self.lock = named_lock("metastore.shard")
        self.epoch = 1  # mirror of the peer's lease epoch (topology-synced)
        self.alive = True
        # (shuffle_id, partition_id) -> [(location, generation applied)]
        self.entries: Dict[Key, List[Tuple[PartitionLocation, int]]] = {}
        # executors swept by _on_peer_lost, per shard: the swept-publisher
        # check holds HERE, not in one process-wide set
        self.tombstones: set = set()

    # -- named decision points (mutation-gate targets) ---------------------
    def _epoch_ok(self, epoch: int) -> bool:
        """May a write routed under ``epoch`` apply here? Only while the
        shard is alive and the epoch is its current one — anything else
        was routed under a lease that no longer holds."""
        return self.alive and epoch == self.epoch

    def _blocked(self, executor_id: str) -> bool:
        """Is this publisher tombstoned on THIS shard? Accepting its
        locations after the sweep would double-serve next to a
        promoted replica."""
        return executor_id in self.tombstones


class ShardedMetaStore:
    """Sharded, epoch-fenced partition-location registry (driver)."""

    def __init__(self, conf, role: str = "driver",
                 clock: Optional[Callable[[], float]] = None):
        self.role = role
        peers = [f"meta-{i}" for i in range(conf.metastore_peers)]
        self.replicas = min(conf.metastore_replicas, len(peers) - 1)
        self._ring = ShardMap(peers, conf.metastore_vnodes,
                              conf.metastore_range_size)
        self._leases = LeaseTable(peers, conf.metastore_lease_ttl_ms / 1000.0,
                                  clock)
        self._shards: Dict[str, MetaShard] = {p: MetaShard(p) for p in peers}
        self.generation = 1
        self.retry = RetryPolicy(
            max_attempts=conf.metastore_max_write_attempts,
            backoff_ms=conf.metastore_retry_backoff_ms,
            backoff_max_ms=conf.metastore_retry_backoff_ms * 8,
            deadline_ms=0,
        )
        # guards ring/lease/generation transitions; shard locks are leaves
        self._topology = named_lock("metastore.topology")
        self._reg = get_registry()
        self._reg.gauge("metastore.shards", role=role).set(len(peers))
        self._reg.gauge("metastore.epoch", role=role).set(self.generation)

    # -- named decision points (mutation-gate targets) ---------------------
    @staticmethod
    def _read_copies(owners: List[Tuple[str, int]]) -> List[Tuple[str, int]]:
        """Owners whose copy a resolve may serve: the primary ONLY.
        Serving a follower's copy beside the primary's is the
        double-serve the replication design must never produce."""
        return owners[:1]

    def _fence_generation(self, carried: int) -> bool:
        """Is a generation-fenced publish stale? Re-adoption sweeps tag
        their publishes with the generation of the takeover that
        started them; a sweep from an older takeover must be rejected
        whole, never retried into the new era."""
        return carried != 0 and carried != self.generation

    # -- routing -----------------------------------------------------------
    def _route(self, shuffle_id: int, partition_id: int
               ) -> Tuple[int, List[Tuple[str, int]]]:
        """Resolve the owner list + epochs a write/read must carry.
        Expired leases take over (epoch bump) HERE — the next apply
        under the old epoch fences."""
        plan = _faults.active()
        while True:
            with self._topology:
                owners = self._ring.owners(shuffle_id, partition_id,
                                           self.replicas)
                routed: List[Tuple[str, int]] = []
                for peer in owners:
                    if not self._leases.live(peer):
                        epoch = self._leases.takeover(peer)
                        self._sync_shard_epoch(peer, epoch)
                        self._reg.counter(
                            "metastore.lease_takeovers", role=self.role
                        ).inc()
                        journal_emit(
                            "meta.takeover", role=self.role,
                            peer=peer, epoch=epoch,
                        )
                    else:
                        epoch = self._leases.epoch(peer)
                    routed.append((peer, epoch))
                gen = self.generation
            if plan is not None:
                killed = [p for p, _ in routed if plan.on_meta(shard=p)]
                if killed:
                    for peer in killed:
                        self.kill_peer(peer)
                    continue  # ranges moved: route again
            return gen, routed

    def _sync_shard_epoch(self, peer: str, epoch: int) -> None:
        shard = self._shards[peer]
        with shard.lock:
            shard.epoch = epoch

    def _renew(self, routed: List[Tuple[str, int]]) -> None:
        with self._topology:
            for peer, epoch in routed:
                try:
                    self._leases.renew(peer, epoch)
                except StaleEpochError:
                    continue  # expired between apply and renew: benign
                self._reg.counter(
                    "metastore.lease_renewals", role=self.role
                ).inc()

    def _stale(self, err: StaleEpochError) -> StaleEpochError:
        self._reg.counter(
            "metastore.stale_epoch_rejects", role=self.role
        ).inc()
        return err

    # -- write path --------------------------------------------------------
    def publish(self, shuffle_id: int, locations: List[PartitionLocation],
                fence_generation: int = 0) -> int:
        """Epoch-fenced scatter of ``locations`` into their shards.

        Returns how many locations were applied; tombstoned publishers'
        locations drop silently (the caller re-checks its lost set for
        barrier accounting). Raises :class:`StaleEpochError` without
        retry when ``fence_generation`` names an older takeover era —
        a stale re-adoption sweep must die, not merge into the new one.
        """
        if fence_generation:
            with self._topology:
                if self._fence_generation(fence_generation):
                    raise self._stale(StaleEpochError(
                        "generation", fence_generation, self.generation))
        applied = 0
        by_key: Dict[Key, List[PartitionLocation]] = {}
        for loc in locations:
            by_key.setdefault((shuffle_id, loc.partition_id), []).append(loc)
        for key, locs in by_key.items():
            applied += self._publish_key(key, locs, fence_generation)
        return applied

    def _publish_key(self, key: Key, locs: List[PartitionLocation],
                     fence_generation: int) -> int:
        attempt = 0
        while True:
            attempt += 1
            gen, routed = self._route(*key)
            if fence_generation and gen != fence_generation:
                raise self._stale(StaleEpochError(
                    "generation", fence_generation, gen))
            schedule_point("proto", "meta.lease")
            try:
                applied = self._apply(key, locs, routed, gen)
            except StaleEpochError as err:
                self._stale(err)
                if not self.retry.allows(attempt + 1):
                    raise
                time.sleep(self.retry.backoff_s(attempt, "meta", *map(str, key)))
                continue
            self._renew(routed)
            return applied

    def _apply(self, key: Key, locs: List[PartitionLocation],
               routed: List[Tuple[str, int]], gen: int) -> int:
        """Apply one key's locations to every owner. Idempotent per
        (owner, location): a retry after a partial apply (one owner
        accepted, the next fenced) never duplicates an entry."""
        applied = 0
        for i, (peer, epoch) in enumerate(routed):
            shard = self._shards[peer]
            with shard.lock:
                if not shard._epoch_ok(epoch):
                    raise StaleEpochError(peer, epoch, shard.epoch)
                bucket = shard.entries.setdefault(key, [])
                for loc in locs:
                    if shard._blocked(loc.manager_id.executor_id):
                        continue
                    if any(have == loc for have, _ in bucket):
                        continue
                    bucket.append((loc, gen))
                    if i == 0:  # count primary copies once, not per replica
                        applied += 1
        return applied

    # -- read path ---------------------------------------------------------
    def resolve(self, shuffle_id: int, partition_id: int
                ) -> List[PartitionLocation]:
        """Epoch-fenced read of one partition's locations (primary copy)."""
        attempt = 0
        while True:
            attempt += 1
            _, routed = self._route(shuffle_id, partition_id)
            schedule_point("proto", "meta.lease")
            out: List[PartitionLocation] = []
            try:
                for peer, epoch in self._read_copies(routed):
                    shard = self._shards[peer]
                    with shard.lock:
                        if not shard._epoch_ok(epoch):
                            raise StaleEpochError(peer, epoch, shard.epoch)
                        bucket = shard.entries.get(
                            (shuffle_id, partition_id), ())
                        out.extend(loc for loc, _ in bucket)
            except StaleEpochError as err:
                self._stale(err)
                if not self.retry.allows(attempt + 1):
                    raise
                time.sleep(self.retry.backoff_s(
                    attempt, "meta", str(shuffle_id), str(partition_id)))
                continue
            return out

    def resolve_range(self, shuffle_id: int, start: int, end: int
                      ) -> List[PartitionLocation]:
        out: List[PartitionLocation] = []
        for pid in range(start, end):
            out.extend(self.resolve(shuffle_id, pid))
        return out

    def entries_for_shuffle(self, shuffle_id: int
                            ) -> Dict[int, List[PartitionLocation]]:
        """Primary-copy view of one shuffle: pid -> locations. Seeded
        partitions appear with empty lists (register parity)."""
        out: Dict[int, List[PartitionLocation]] = {}
        with self._topology:
            ring = self._ring
        for shard in self._shards.values():
            with shard.lock:
                items = [(k, [loc for loc, _ in v])
                         for k, v in shard.entries.items()
                         if k[0] == shuffle_id]
            for (_, pid), locs in items:
                if ring.primary(shuffle_id, pid) != shard.name:
                    continue
                out.setdefault(pid, []).extend(locs)
        return out

    def shuffle_ids(self) -> List[int]:
        sids: set = set()
        for shard in self._shards.values():
            with shard.lock:
                sids.update(k[0] for k in shard.entries)
        return sorted(sids)

    def all_entries(self) -> Dict[int, Dict[int, List[PartitionLocation]]]:
        """Primary-copy view of every shuffle (legacy/test surface —
        the shape ``_partition_locations`` always had)."""
        return {sid: self.entries_for_shuffle(sid)
                for sid in self.shuffle_ids()}

    # -- lifecycle ---------------------------------------------------------
    def ensure_shuffle(self, shuffle_id: int, num_partitions: int) -> None:
        """Seed empty buckets on every owner so resolves of an
        unpublished partition answer [] (register_shuffle parity)."""
        for pid in range(num_partitions):
            _, routed = self._route(shuffle_id, pid)
            for peer, _ in routed:
                shard = self._shards[peer]
                with shard.lock:
                    shard.entries.setdefault((shuffle_id, pid), [])

    def drop_shuffle(self, shuffle_id: int) -> None:
        for shard in self._shards.values():
            with shard.lock:
                for key in [k for k in shard.entries if k[0] == shuffle_id]:
                    del shard.entries[key]

    def sweep_executor(self, executor_id: str,
                       shuffle_id: Optional[int] = None) -> int:
        """Tombstone + prune a dead executor, shard by shard. The
        tombstone and the prune commit atomically per shard: a racing
        publish either lands before the sweep of that shard (pruned
        here) or after it (dropped by :meth:`MetaShard._blocked`)."""
        pruned = 0
        for shard in self._shards.values():
            with shard.lock:
                shard.tombstones.add(executor_id)
                for key, bucket in shard.entries.items():
                    if shuffle_id is not None and key[0] != shuffle_id:
                        continue
                    keep = [(loc, g) for loc, g in bucket
                            if loc.manager_id.executor_id != executor_id]
                    pruned += len(bucket) - len(keep)
                    shard.entries[key] = keep
        return pruned

    def kill_peer(self, peer: str) -> int:
        """Metadata-peer death: revoke its lease, remap only its ranges
        (ring minimal movement), clear its slice. The former follower
        already holds every copy, so reads keep answering — zero
        metadata loss at replication >= 1. Returns the new generation."""
        with self._topology:
            if peer not in self._shards or len(self._ring.peers) <= 1:
                return self.generation
            if peer not in self._ring.peers:
                return self.generation
            self._leases.revoke(peer)
            self._ring = self._ring.without_peer(peer)
            self.generation += 1
            self._reg.gauge("metastore.epoch", role=self.role).set(
                self.generation)
            self._reg.gauge("metastore.shards", role=self.role).set(
                len(self._ring.peers))
            self._reg.counter("metastore.peer_kills", role=self.role).inc()
            journal_emit(
                "meta.peer_kill", role=self.role, peer=peer,
                generation=self.generation,
            )
        shard = self._shards[peer]
        with shard.lock:
            shard.alive = False
            shard.entries.clear()
            # replication below the requested factor now that a peer is
            # gone: surviving writes re-replicate on their next publish
        self.replicas = min(self.replicas, len(self._ring.peers) - 1)
        return self.generation

    def wipe(self) -> int:
        """Driver crash: every entry is gone, every lease re-grants
        under a bumped epoch, generation advances. Recovery is the
        re-adoption sweep (re-publish, not recompute) fenced by the
        returned generation."""
        schedule_point("proto", "meta.adopt")
        with self._topology:
            self.generation += 1
            self._leases.bump_all()
            journal_emit(
                "meta.epoch_bump", role=self.role,
                generation=self.generation,
            )
            for peer in self._ring.peers:
                epoch = self._leases.epoch(peer)
                shard = self._shards[peer]
                with shard.lock:
                    shard.entries.clear()
                    shard.epoch = epoch
                # every lease re-granted under the bumped epoch is a
                # takeover of that peer's slice — journaled per peer so
                # the chaos timeline shows kill -> takeover -> adopt
                journal_emit(
                    "meta.takeover", role=self.role, peer=peer, epoch=epoch,
                )
            self._reg.gauge("metastore.epoch", role=self.role).set(
                self.generation)
            return self.generation

    def live_peers(self) -> List[str]:
        with self._topology:
            return list(self._ring.peers)

    def snapshot(self) -> Dict[str, object]:
        with self._topology:
            leases = self._leases.snapshot()
            peers = list(self._ring.peers)
            gen = self.generation
        entries = 0
        for shard in self._shards.values():
            with shard.lock:
                entries += sum(len(v) for v in shard.entries.values())
        return {
            "generation": gen,
            "peers": peers,
            "replicas": self.replicas,
            "entries": entries,
            "leases": leases,
        }
