"""Lease/epoch protocol for metadata shard peers.

Every logical metadata peer serves its shards under a time-bounded
lease tagged with a monotonically increasing **epoch**. The protocol
is three rules, each a small named method so the modelcheck mutation
gate can disarm exactly one decision (analysis/modelcheck/mutants.py):

- a write must carry the epoch it routed against, and the apply-side
  check (:meth:`LeaseTable.check`) rejects any epoch that is not the
  peer's *current* one — :class:`StaleEpochError`, retried through the
  resilience retry ladder after re-routing;
- a lease renews only while live (:meth:`LeaseTable.renew`): renewal
  after expiry must go through takeover, never silently resurrect;
- expiry or an explicit revoke **bumps the epoch**
  (:meth:`LeaseTable.takeover`), so every write routed under the old
  lease is fenced the moment the new holder starts serving.

The table never sleeps and never spawns threads: the store drives it
with an injectable clock, so unit tests and the ``meta_lease``
modelcheck model control time explicitly.

A copy of the JAX package's ``metastore/lease.py``, its imports
rewritten to this package.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence


class StaleEpochError(RuntimeError):
    """A write/resolve carried an epoch the peer no longer serves."""

    def __init__(self, peer: str, carried: int, current: int):
        super().__init__(
            f"stale epoch for {peer}: write carried {carried}, "
            f"peer serves {current}"
        )
        self.peer = peer
        self.carried = carried
        self.current = current


@dataclass
class ShardLease:
    """One peer's serving right: who holds it, which epoch, until when."""

    holder: str
    epoch: int
    deadline: float
    alive: bool = True


class LeaseTable:
    """Peer name → lease. NOT thread-safe by itself: the store calls it
    under its shard/topology locks (docs/RESILIENCE.md lock order)."""

    def __init__(self, peers: Sequence[str], ttl_s: float,
                 clock: Optional[Callable[[], float]] = None):
        self.ttl_s = ttl_s
        self.clock = clock or time.monotonic
        now = self.clock()
        self._leases: Dict[str, ShardLease] = {
            p: ShardLease(holder=p, epoch=1, deadline=now + ttl_s)
            for p in peers
        }

    # -- named decision points (mutation-gate targets) ---------------------
    @staticmethod
    def _expired(lease: ShardLease, now: float) -> bool:
        """Has this lease lapsed? Serving past the deadline is exactly
        the double-serve window the lease exists to close."""
        return now > lease.deadline

    def check(self, peer: str, epoch: int) -> None:
        """Apply-side fence: the carried epoch must be current and the
        lease live. Raises :class:`StaleEpochError` otherwise."""
        lease = self._leases.get(peer)
        if lease is None or not lease.alive:
            raise StaleEpochError(peer, epoch, 0)
        if epoch != lease.epoch:
            raise StaleEpochError(peer, epoch, lease.epoch)

    # -- transitions --------------------------------------------------------
    def epoch(self, peer: str) -> int:
        lease = self._leases.get(peer)
        if lease is None or not lease.alive:
            raise StaleEpochError(peer, 0, 0)
        return lease.epoch

    def live(self, peer: str) -> bool:
        lease = self._leases.get(peer)
        return (
            lease is not None
            and lease.alive
            and not self._expired(lease, self.clock())
        )

    def renew(self, peer: str, epoch: int) -> None:
        """Extend a live lease (the holder touches it on every served
        write). Renewal of an expired or superseded lease raises — the
        old holder must re-acquire through :meth:`takeover`."""
        lease = self._leases.get(peer)
        if lease is None or not lease.alive:
            raise StaleEpochError(peer, epoch, 0)
        if epoch != lease.epoch:
            raise StaleEpochError(peer, epoch, lease.epoch)
        now = self.clock()
        if self._expired(lease, now):
            raise StaleEpochError(peer, epoch, lease.epoch)
        lease.deadline = now + self.ttl_s

    def takeover(self, peer: str, holder: Optional[str] = None) -> int:
        """Grant the shard to ``holder`` (default: the peer itself —
        an in-place restart) under a BUMPED epoch. Every write routed
        under the previous epoch is fenced from this point on."""
        lease = self._leases.get(peer)
        now = self.clock()
        if lease is None:
            lease = ShardLease(holder=holder or peer, epoch=1,
                               deadline=now + self.ttl_s)
            self._leases[peer] = lease
            return lease.epoch
        lease.holder = holder or peer
        lease.epoch += 1
        lease.deadline = now + self.ttl_s
        lease.alive = True
        return lease.epoch

    def revoke(self, peer: str) -> None:
        """Peer death: the lease dies with it. Writes routed to it
        fence immediately; the ring reroutes its ranges elsewhere."""
        lease = self._leases.get(peer)
        if lease is not None:
            lease.alive = False

    def bump_all(self) -> None:
        """Driver crash: a fresh hub serves nothing it didn't re-adopt,
        so every surviving lease re-grants under a new epoch."""
        for peer in list(self._leases):
            self.takeover(peer)

    def snapshot(self) -> Dict[str, Dict[str, object]]:
        return {
            p: {"holder": l.holder, "epoch": l.epoch, "alive": l.alive,
                "live": self.live(p)}
            for p, l in sorted(self._leases.items())
        }
