"""Seeded protocol mutants — the checker's mutation-testing gate.

Each mutant reintroduces one specific protocol bug by monkeypatching a
real method for the duration of one checker run (:func:`apply_mutant`
is a context manager; :func:`run_gate` drives the full matrix). The
gate is green when EVERY mutant is caught by at least one explored
schedule while the unmutated tree explores its full budget clean —
together those prove the oracles have teeth and aren't tautologies.

Most guards under test are factored as small named predicates in the
protocol code (``MergeEndpoint._dup_locked``,
``TpuShuffleManager._claim_map_owner``,
``SpeculativeReducePhase._already_settled``,
``QuotaBroker._must_block``, ...) precisely so a mutant swaps ONE
decision, not a hand-copied method body that drifts from the original.
The two body copies that remain (partial seal, silent release) keep
their seams so the schedule space stays comparable.

A copy of the JAX package's ``analysis/modelcheck/mutants.py``, its
imports rewritten to this package: each mutant patches the port's
class by the JAX method name.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, List, Optional, Tuple

from sparkrdma_tpu_torch.analysis.modelcheck.sched import schedule_point

#: mutant name -> (model expected to catch it, description)
MUTANTS: Dict[str, Tuple[str, str]] = {
    "merge-skip-dedup": (
        "merge_seal",
        "drop the (source, seq) redelivery dedup: duplicate pushes "
        "double-count the buffer ledger",
    ),
    "merge-seal-partial": (
        "merge_seal",
        "seal on partial coverage: merged segment misses blocks yet "
        "advertises full cover",
    ),
    "merge-ledger-leak": (
        "merge_seal",
        "abandon a partition without refunding its buffered bytes",
    ),
    "merge-sealed-reentry": (
        "merge_seal",
        "accept pushes for sealed/abandoned partitions (late re-entry)",
    ),
    "promo-unshared-lock": (
        "replica_promotion",
        "per-call shuffle locks: publish/loss critical sections no "
        "longer exclude each other",
    ),
    "promo-skip-owner-dedup": (
        "replica_promotion",
        "claim map ownership unconditionally: a losing speculative "
        "publish double-serves its map",
    ),
    "replica-no-divert": (
        "replica_promotion",
        "serve replica publishes as primaries while the primary lives",
    ),
    "spec-double-settle": (
        "speculation",
        "drop the late-loser guard: a loser crossing the line "
        "overwrites the settled winner",
    ),
    "spec-skip-cancel": (
        "speculation",
        "never drain the losing attempt (no cancel_reduce)",
    ),
    "quota-global-usage": (
        "quota_stall",
        "block on GLOBAL usage instead of per-tenant: one tenant at "
        "quota blocks everyone",
    ),
    "quota-silent-release": (
        "quota_stall",
        "release bytes without notifying blocked chargers",
    ),
    "meta-skip-epoch-check": (
        "meta_lease",
        "apply writes without the shard epoch fence: a write routed "
        "under a pre-crash lease lands in the post-crash registry",
    ),
    "meta-tombstone-skip": (
        "meta_lease",
        "ignore per-shard executor tombstones: a swept publisher's "
        "straggling locations double-serve beside promoted replicas",
    ),
    "meta-serve-follower": (
        "meta_lease",
        "resolve from every owner instead of the primary copy only: "
        "one slot answers twice",
    ),
    "meta-lease-serve-expired": (
        "meta_lease",
        "leases never lapse: an expired holder keeps serving without "
        "a takeover epoch bump",
    ),
    "meta-renew-after-expiry": (
        "meta_lease",
        "renew silently resurrects expired/superseded leases instead "
        "of forcing re-acquire through takeover",
    ),
    "meta-adopt-no-bump": (
        "meta_lease",
        "driver-crash wipe advances neither generation nor lease "
        "epochs: a stale re-adoption sweep merges into the new era",
    ),
    "meta-adopt-partial-sweep": (
        "meta_lease",
        "driver-crash wipe clears only one shard: pre-crash entries "
        "survive into the post-crash registry",
    ),
}


def _patch(cls, name: str, fn) -> Tuple:
    orig = cls.__dict__[name]
    setattr(cls, name, fn)
    return (cls, name, orig)


@contextlib.contextmanager
def apply_mutant(name: Optional[str]) -> Iterator[None]:
    """Arm one mutant (or none) for the enclosed checker run."""
    if name is None:
        yield
        return
    if name not in MUTANTS:
        raise KeyError(f"unknown mutant {name!r} (see MUTANTS)")
    patches: List[Tuple] = []
    try:
        patches.extend(_ARMERS[name]())
        yield
    finally:
        for cls, attr, orig in reversed(patches):
            setattr(cls, attr, orig)


# -- the mutants ----------------------------------------------------------
def _arm_merge_skip_dedup() -> List[Tuple]:
    from sparkrdma_tpu_torch.shuffle.merge import MergeEndpoint

    return [
        _patch(
            MergeEndpoint,
            "_dup_locked",
            staticmethod(lambda per, source, seq: False),
        )
    ]


def _arm_merge_seal_partial() -> List[Tuple]:
    from sparkrdma_tpu_torch.shuffle.merge import MergeEndpoint, _natural

    def sealable(self, st):
        # copied from _sealable_locked, coverage check REMOVED: seals
        # whatever arrived, so the merged segment can miss blocks while
        # merged_cover still claims them
        num_maps = max((nm for (_, _, nm) in st.markers.values()), default=0)
        committed = sum(c for (_, c, _) in st.markers.values())
        if num_maps <= 0 or committed < num_maps:
            return []
        out = []
        all_pids = set()
        for counts, _, _ in st.markers.values():
            all_pids.update(p for p, n in counts.items() if n)
        for pid in sorted(all_pids):
            if pid in st.sealed or pid in st.abandoned:
                continue
            need = [
                (src, seq)
                for src, (counts, _, _) in sorted(st.markers.items())
                for seq in range(counts.get(pid, 0))
            ]
            have = st.blocks.get(pid, {})
            need = [k for k in need if k in have]  # BUG: partial cover
            if not need:
                continue
            payloads = st.blocks.pop(pid)
            self._buffered -= sum(len(v) for v in payloads.values())
            st.sealed[pid] = None
            need.sort(key=lambda k: (_natural(k[0]), k[1]))
            out.append((pid, need, payloads))
        return out

    return [_patch(MergeEndpoint, "_sealable_locked", sealable)]


def _arm_merge_ledger_leak() -> List[Tuple]:
    from sparkrdma_tpu_torch.shuffle.merge import MergeEndpoint

    def abandon(self, st, pid):
        st.blocks.pop(pid, None)  # BUG: buffered bytes never refunded
        st.abandoned.add(pid)

    return [_patch(MergeEndpoint, "_abandon_locked", abandon)]


def _arm_merge_sealed_reentry() -> List[Tuple]:
    from sparkrdma_tpu_torch.shuffle.merge import MergeEndpoint

    return [
        _patch(MergeEndpoint, "_closed_locked", lambda self, st, pid: False)
    ]


def _arm_promo_unshared_lock() -> List[Tuple]:
    from sparkrdma_tpu_torch.analysis.lockorder import named_lock
    from sparkrdma_tpu_torch.shuffle.manager import TpuShuffleManager

    def shuffle_lock(self, shuffle_id):
        # BUG: fresh lock per call — same park structure, no exclusion
        with self._lock:
            return named_lock("manager.shuffle")

    return [_patch(TpuShuffleManager, "_shuffle_lock", shuffle_lock)]


def _arm_promo_skip_owner_dedup() -> List[Tuple]:
    from sparkrdma_tpu_torch.shuffle.manager import TpuShuffleManager

    def claim(self, owner_map, map_id, exec_id):
        schedule_point("proto", "manager.publish.claim")
        owner_map[map_id] = exec_id  # BUG: never checks a prior owner
        return True

    return [_patch(TpuShuffleManager, "_claim_map_owner", claim)]


def _arm_replica_no_divert() -> List[Tuple]:
    from sparkrdma_tpu_torch.shuffle.manager import TpuShuffleManager

    return [
        _patch(
            TpuShuffleManager,
            "_is_replica_publish",
            staticmethod(lambda msg: False),
        )
    ]


def _arm_spec_double_settle() -> List[Tuple]:
    from sparkrdma_tpu_torch.elastic.speculation import SpeculativeReducePhase

    return [
        _patch(
            SpeculativeReducePhase,
            "_already_settled",
            lambda self, idx, done, failures: False,
        )
    ]


def _arm_spec_skip_cancel() -> List[Tuple]:
    from sparkrdma_tpu_torch.elastic.speculation import SpeculativeReducePhase

    return [
        _patch(
            SpeculativeReducePhase, "_cancel", lambda self, worker, rng: None
        )
    ]


def _arm_quota_global_usage() -> List[Tuple]:
    from sparkrdma_tpu_torch.tenancy.quota import QuotaBroker

    def must_block(self, tenant, nbytes, quota):
        held = sum(self._usage.values())  # BUG: global, not per-tenant
        return held > 0 and held + nbytes > quota

    return [_patch(QuotaBroker, "_must_block", must_block)]


def _arm_quota_silent_release() -> List[Tuple]:
    from sparkrdma_tpu_torch.tenancy.quota import QuotaBroker

    def release(self, tenant, nbytes):
        schedule_point("proto", "quota.release")
        with self._cond:
            self._usage[tenant] = max(0, self._usage.get(tenant, 0) - nbytes)
            self._g_bytes(tenant).set(self._usage[tenant])
            # BUG: no notify_all — blocked chargers sleep to the deadline

    return [_patch(QuotaBroker, "release", release)]


def _arm_meta_skip_epoch_check() -> List[Tuple]:
    from sparkrdma_tpu_torch.metastore.store import MetaShard

    return [_patch(MetaShard, "_epoch_ok", lambda self, epoch: True)]


def _arm_meta_tombstone_skip() -> List[Tuple]:
    from sparkrdma_tpu_torch.metastore.store import MetaShard

    return [_patch(MetaShard, "_blocked", lambda self, executor_id: False)]


def _arm_meta_serve_follower() -> List[Tuple]:
    from sparkrdma_tpu_torch.metastore.store import ShardedMetaStore

    return [
        _patch(
            ShardedMetaStore,
            "_read_copies",
            staticmethod(lambda owners: list(owners)),
        )
    ]


def _arm_meta_lease_serve_expired() -> List[Tuple]:
    from sparkrdma_tpu_torch.metastore.lease import LeaseTable

    return [
        _patch(
            LeaseTable, "_expired", staticmethod(lambda lease, now: False)
        )
    ]


def _arm_meta_renew_after_expiry() -> List[Tuple]:
    from sparkrdma_tpu_torch.metastore.lease import LeaseTable, StaleEpochError

    def renew(self, peer, epoch):
        lease = self._leases.get(peer)
        if lease is None:
            raise StaleEpochError(peer, epoch, 0)
        # BUG: no aliveness/epoch/expiry fence — a lapsed or superseded
        # holder silently resurrects instead of re-acquiring via takeover
        lease.deadline = self.clock() + self.ttl_s

    return [_patch(LeaseTable, "renew", renew)]


def _arm_meta_adopt_no_bump() -> List[Tuple]:
    from sparkrdma_tpu_torch.metastore.store import ShardedMetaStore

    def wipe(self):
        # copied from wipe, fencing REMOVED: neither the generation nor
        # the lease epochs advance, so a re-adoption sweep fenced at the
        # pre-crash generation merges straight into the new era
        schedule_point("proto", "meta.adopt")
        with self._topology:
            for peer in self._ring.peers:
                shard = self._shards[peer]
                with shard.lock:
                    shard.entries.clear()
            self._reg.gauge("metastore.epoch", role=self.role).set(
                self.generation
            )
            return self.generation

    return [_patch(ShardedMetaStore, "wipe", wipe)]


def _arm_meta_adopt_partial_sweep() -> List[Tuple]:
    from sparkrdma_tpu_torch.metastore.store import ShardedMetaStore

    def wipe(self):
        # copied from wipe, sweep truncated: only the FIRST peer's slice
        # clears, so pre-crash entries survive into the new generation
        schedule_point("proto", "meta.adopt")
        with self._topology:
            self.generation += 1
            self._leases.bump_all()
            for i, peer in enumerate(self._ring.peers):
                epoch = self._leases.epoch(peer)
                shard = self._shards[peer]
                with shard.lock:
                    if i == 0:  # BUG: the other shards keep their entries
                        shard.entries.clear()
                    shard.epoch = epoch
            self._reg.gauge("metastore.epoch", role=self.role).set(
                self.generation
            )
            return self.generation

    return [_patch(ShardedMetaStore, "wipe", wipe)]


_ARMERS = {
    "merge-skip-dedup": _arm_merge_skip_dedup,
    "merge-seal-partial": _arm_merge_seal_partial,
    "merge-ledger-leak": _arm_merge_ledger_leak,
    "merge-sealed-reentry": _arm_merge_sealed_reentry,
    "promo-unshared-lock": _arm_promo_unshared_lock,
    "promo-skip-owner-dedup": _arm_promo_skip_owner_dedup,
    "replica-no-divert": _arm_replica_no_divert,
    "spec-double-settle": _arm_spec_double_settle,
    "spec-skip-cancel": _arm_spec_skip_cancel,
    "quota-global-usage": _arm_quota_global_usage,
    "quota-silent-release": _arm_quota_silent_release,
    "meta-skip-epoch-check": _arm_meta_skip_epoch_check,
    "meta-tombstone-skip": _arm_meta_tombstone_skip,
    "meta-serve-follower": _arm_meta_serve_follower,
    "meta-lease-serve-expired": _arm_meta_lease_serve_expired,
    "meta-renew-after-expiry": _arm_meta_renew_after_expiry,
    "meta-adopt-no-bump": _arm_meta_adopt_no_bump,
    "meta-adopt-partial-sweep": _arm_meta_adopt_partial_sweep,
}


def run_gate(
    walks: int = 60, seed: int = 0, max_schedules: int = 400
) -> Dict[str, Dict[str, object]]:
    """The full mutation matrix: every mutant must be CAUGHT.

    Random walks first (cheap); a mutant the walks miss gets the
    bounded exhaustive pass. Returns {mutant: {"caught": bool, ...}};
    ``"failure"`` is the caught schedule as an artifact (the port keeps
    it, so each caught failure can be replayed; the JAX gate drops it).
    """
    from sparkrdma_tpu_torch.analysis.modelcheck.explore import (
        exhaustive,
        random_walk,
    )

    results: Dict[str, Dict[str, object]] = {}
    for name, (model, _desc) in MUTANTS.items():
        outcome = random_walk(model, walks, seed=seed, mutant=name)
        how = "random"
        if outcome["failure"] is None:
            outcome = exhaustive(
                model, max_schedules=max_schedules, mutant=name
            )
            how = "exhaustive"
        failure = outcome["failure"]
        results[name] = {
            "caught": failure is not None,
            "how": how if failure is not None else None,
            "model": model,
            "violation": (failure or {}).get("violation"),
            "schedules": outcome["schedules"],
            "failure": failure,
        }
    return results


__all__ = ["MUTANTS", "apply_mutant", "run_gate"]
