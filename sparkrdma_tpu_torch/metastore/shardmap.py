"""Consistent-hash shard map: ``(shuffle_id, partition range)`` → peers.

The locations registry shards by partition *range* (``range_size``
consecutive partitions share a shard key) so one reduce task's
``[start, end)`` resolve touches few shards, and the ring hashes each
shard key onto the metadata peers with virtual nodes so load spreads
evenly. Two properties the tests pin (tests/test_metastore.py):

- **full cover** — every key maps to exactly one primary (and, with
  replication, a deterministic follower list of distinct peers);
- **minimal movement** — removing a peer only remaps keys that peer
  owned; adding one only steals keys from its ring neighbours. A
  metadata-peer death therefore invalidates only its own ranges.

Deterministic throughout (sha1, no RNG): the modelcheck scheduler can
replay any interleaving byte-for-byte.

A copy of the JAX package's ``metastore/shardmap.py``, its imports
rewritten to this package.
"""

from __future__ import annotations

import bisect
import hashlib
from typing import List, Sequence, Tuple


def _point(token: str) -> int:
    """64-bit ring coordinate of a token (stable across processes)."""
    return int.from_bytes(hashlib.sha1(token.encode()).digest()[:8], "big")


class ShardMap:
    """Immutable consistent-hash ring over metadata peer names."""

    def __init__(self, peers: Sequence[str], vnodes: int = 16,
                 range_size: int = 8):
        if not peers:
            raise ValueError("shard map needs at least one peer")
        if vnodes < 1:
            raise ValueError("vnodes must be >= 1")
        if range_size < 1:
            raise ValueError("range_size must be >= 1")
        self.peers: Tuple[str, ...] = tuple(sorted(set(peers)))
        self.vnodes = vnodes
        self.range_size = range_size
        points: List[Tuple[int, str]] = []
        for peer in self.peers:
            for i in range(vnodes):
                points.append((_point(f"{peer}#{i}"), peer))
        points.sort()
        self._points = [p for p, _ in points]
        self._owners = [o for _, o in points]

    # -- key space ---------------------------------------------------------
    def shard_key(self, shuffle_id: int, partition_id: int) -> Tuple[int, int]:
        """The ``(shuffle_id, range index)`` bucket a partition lives in."""
        return (shuffle_id, partition_id // self.range_size)

    # -- lookups -----------------------------------------------------------
    def _walk(self, key: Tuple[int, int]) -> List[str]:
        """Distinct peers in ring order starting at the key's point."""
        h = _point(f"{key[0]}:{key[1]}")
        idx = bisect.bisect_right(self._points, h) % len(self._points)
        seen: List[str] = []
        for off in range(len(self._points)):
            owner = self._owners[(idx + off) % len(self._points)]
            if owner not in seen:
                seen.append(owner)
                if len(seen) == len(self.peers):
                    break
        return seen

    def primary(self, shuffle_id: int, partition_id: int) -> str:
        """The peer that serves reads for this partition's shard."""
        return self._walk(self.shard_key(shuffle_id, partition_id))[0]

    def owners(self, shuffle_id: int, partition_id: int,
               replicas: int = 0) -> List[str]:
        """Primary + up to ``replicas`` distinct followers, ring order.
        Writes apply to every owner; reads serve from the primary only
        (store._serving_copy), so replication never double-serves."""
        walk = self._walk(self.shard_key(shuffle_id, partition_id))
        return walk[: 1 + max(0, replicas)]

    # -- membership (immutable: new map per change) ------------------------
    def without_peer(self, peer: str) -> "ShardMap":
        rest = [p for p in self.peers if p != peer]
        return ShardMap(rest, self.vnodes, self.range_size)

    def with_peer(self, peer: str) -> "ShardMap":
        return ShardMap(list(self.peers) + [peer], self.vnodes,
                        self.range_size)
