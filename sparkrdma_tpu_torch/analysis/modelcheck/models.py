"""Protocol models: the REAL state machines under tiny fixed configs.

Each model wires real protocol objects (``MergeEndpoint``,
``TpuShuffleManager``'s publish/loss mutators, ``SpeculativeReducePhase``,
``QuotaBroker``) to a handful of sim threads representing the concurrent
actors of one documented race, plus the invariant oracles that must hold
at every quiescent point. Configs are deliberately minimal — 2 maps,
2 partitions, 2-5 threads — because exhaustive exploration cost is
exponential in schedule points; the races these protocols can exhibit
(the postmortems in docs/RESILIENCE.md) all fit in this window.

A model exposes:

- ``build(sched)`` — construct protocol state, spawn the actor threads;
- ``check()`` — quiescent-point invariants, returning violation strings;
- ``final()`` — end-of-schedule invariants (byte identity, metric
  deltas, counts);
- ``result()`` — canonical bytes for the byte-identity-vs-serial oracle
  (schedule-dependent detail like which executor won must NOT leak in).

Only the driver-side/in-process protocol surfaces run here; the
transport is represented by the call boundary itself (a push/publish
call IS the message arrival — in-process clusters already work this
way, see merge.register_endpoint).

A copy of the JAX package's ``analysis/modelcheck/models.py``, its
imports rewritten to this package: the models run the port's
``shuffle/merge.py``, ``shuffle/manager.py``,
``elastic/{replication,speculation}.py``, ``tenancy/quota.py`` and
``metastore/``.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Set, Tuple

from sparkrdma_tpu_torch.analysis.modelcheck.sched import (
    CooperativeScheduler,
    SimPool,
    schedule_point,
)

MODELS: Dict[str, Callable[[], "ProtocolModel"]] = {}


def register_model(cls):
    MODELS[cls.name] = cls
    return cls


class ProtocolModel:
    """Base: a named scenario over real protocol code."""

    name = ""

    def build(self, sched: CooperativeScheduler) -> None:
        raise NotImplementedError

    def check(self) -> List[str]:
        return []

    def final(self) -> List[str]:
        return []

    def result(self) -> bytes:
        return b""


# ----------------------------------------------------------------------
# shared stubs: the minimum manager surface MergeEndpoint/ReplicaStore
# need — a real ProtectionDomain (so MemoryWriterBlock registration and
# resolve are the real code paths) plus a recording publish sink
# ----------------------------------------------------------------------
class _StubConf:
    driver_port = 0
    push_max_buffer_bytes = 1 << 20


class _StubResolver:
    def reserve_inmemory_bytes(self, n: int) -> bool:
        return True

    def release_inmemory_bytes(self, n: int) -> None:
        pass


class _StubNode:
    def __init__(self):
        from sparkrdma_tpu_torch.memory.registry import ProtectionDomain

        self.pd = ProtectionDomain()


class _SinkManager:
    """Duck-typed manager for endpoint/store objects under test."""

    def __init__(self, executor_id: str = "mc-exec"):
        from sparkrdma_tpu_torch.locations import ShuffleManagerId

        self.conf = _StubConf()
        self.executor_id = executor_id
        self.resolver = _StubResolver()
        self.node = _StubNode()
        self.local_manager_id = ShuffleManagerId("mc", 1, executor_id)
        self.published: List[Tuple[int, int, list, int]] = []
        self._pub_lock = threading.Lock()  # raw: no schedule point inside

    def start_node_if_missing(self) -> None:
        pass

    def publish_partition_locations(
        self, shuffle_id, partition_id, locations, num_map_outputs=0,
        meta_epoch=0,
    ) -> None:
        schedule_point("proto", "sink.publish")
        with self._pub_lock:
            self.published.append(
                (shuffle_id, partition_id, list(locations), num_map_outputs)
            )


def _concat(payloads: Dict[Tuple[str, int], bytes], keys) -> bytes:
    return b"".join(payloads[k] for k in keys)


# ----------------------------------------------------------------------
# model 1: merge seal vs late/duplicate pushes (shuffle/merge.py)
# ----------------------------------------------------------------------
@register_model
class MergeSealModel(ProtocolModel):
    """Two sources push toward one MergeEndpoint; one source's windows
    arrive as two concurrent deliveries (the map pool ships windows in
    parallel, so a final marker CAN land before an earlier window);
    a duplicate delivery of the first source's window races everything.
    The byte budget is sized so the serial schedule abandons one
    partition (fallback-to-originals is part of the explored space).

    Oracles: buffer ledger == live payload bytes; sealed/abandoned
    disjoint; sealed partitions hold no buffered blocks; every published
    merged segment's bytes equal the canonical original concatenation
    and its cover equals the partition's original count; final output
    (merged-else-original planning over everything published) is
    byte-identical across schedules.
    """

    name = "merge_seal"
    SID = 7

    # (pid, seq, payload) per source; payload bytes double as originals
    M0 = [(0, 0, b"a00"), (1, 0, b"a10")]
    M1W = [(0, 0, b"b00")]
    M1F = [(0, 1, b"b01"), (1, 0, b"b10")]
    FINAL_M0 = {"counts": {0: 1, 1: 1}, "committed": 1, "num_maps": 2}
    FINAL_M1 = {"counts": {0: 2, 1: 1}, "committed": 1, "num_maps": 2}

    def build(self, sched: CooperativeScheduler) -> None:
        from sparkrdma_tpu_torch.shuffle.merge import MergeEndpoint

        self.manager = _SinkManager()
        # total pushed bytes are 15; 12 forces the serial schedule to
        # abandon whichever partition tips the ledger over
        self.manager.conf.push_max_buffer_bytes = 12
        self.ep = MergeEndpoint(self.manager)
        ep, sid = self.ep, self.SID
        sched.spawn(
            "push_m0", lambda: ep.push_blocks(sid, "m0", self.M0, self.FINAL_M0)
        )
        sched.spawn("push_m1w", lambda: ep.push_blocks(sid, "m1", self.M1W, None))
        sched.spawn(
            "push_m1f", lambda: ep.push_blocks(sid, "m1", self.M1F, self.FINAL_M1)
        )
        # duplicate delivery of m0's window (no final): dedup must drop
        sched.spawn("push_dup", lambda: ep.push_blocks(sid, "m0", self.M0, None))

    # canonical truth: originals per pid in (natural source, seq) order
    def _originals(self) -> Dict[int, Dict[Tuple[str, int], bytes]]:
        out: Dict[int, Dict[Tuple[str, int], bytes]] = {}
        for src, blocks in (("m0", self.M0), ("m1", self.M1W + self.M1F)):
            for pid, seq, payload in blocks:
                out.setdefault(pid, {})[(src, seq)] = payload
        return out

    def check(self) -> List[str]:
        v: List[str] = []
        ep = self.ep
        live = sum(
            len(p)
            for st in ep._shuffles.values()
            for per in st.blocks.values()
            for p in per.values()
        )
        if ep._buffered != live:
            v.append(f"merge ledger drift: buffered={ep._buffered} live={live}")
        if ep._buffered < 0:
            v.append(f"merge ledger negative: {ep._buffered}")
        for st in ep._shuffles.values():
            both = set(st.sealed) & st.abandoned
            if both:
                v.append(f"pids both sealed and abandoned: {sorted(both)}")
            resealed = set(st.sealed) & set(st.blocks)
            if resealed:
                v.append(
                    f"sealed pids still buffering blocks: {sorted(resealed)}"
                )
        return v

    def final(self) -> List[str]:
        v = self.check()
        origs = self._originals()
        pd = self.manager.node.pd
        for _sid, _pid, locs, _n in self.manager.published:
            for loc in locs:
                cover = loc.block.merged_cover
                if not cover:
                    v.append("merge endpoint published a non-merged location")
                    continue
                per = origs.get(loc.partition_id, {})
                if cover != len(per):
                    v.append(
                        f"pid {loc.partition_id}: merged_cover {cover} != "
                        f"{len(per)} originals"
                    )
                want = _concat(per, sorted(per))
                got = bytes(
                    pd.resolve(loc.block.mkey, loc.block.address, loc.block.length)
                )
                if got != want:
                    v.append(
                        f"pid {loc.partition_id}: merged bytes diverge from "
                        f"original concatenation"
                    )
        return v

    def result(self) -> bytes:
        """Planner-visible bytes per pid under merged-else-original."""
        from sparkrdma_tpu_torch.locations import PartitionLocation, ShuffleManagerId
        from sparkrdma_tpu_torch.locations import BlockLocation
        from sparkrdma_tpu_torch.shuffle.merge import plan_reads

        origs = self._originals()
        mid = ShuffleManagerId("mc", 1, "origin")
        locations: List[PartitionLocation] = []
        payload_of: Dict[int, bytes] = {}
        mkey = 1 << 20  # synthetic original mkeys, disjoint from pd's
        for pid, per in sorted(origs.items()):
            for key in sorted(per):
                locations.append(
                    PartitionLocation(mid, pid, BlockLocation(0, len(per[key]), mkey))
                )
                payload_of[mkey] = per[key]
                mkey += 1
        for _sid, _pid, locs, _n in self.manager.published:
            locations.extend(locs)
        selected, _fallbacks = plan_reads(locations)
        pd = self.manager.node.pd
        out: Dict[int, List[bytes]] = {}
        for loc in sorted(
            selected, key=lambda loc: (loc.partition_id, loc.block.merged_cover, loc.block.mkey)
        ):
            if loc.block.merged_cover:
                data = bytes(
                    pd.resolve(loc.block.mkey, loc.block.address, loc.block.length)
                )
            else:
                data = payload_of[loc.block.mkey]
            out.setdefault(loc.partition_id, []).append(data)
        return b"|".join(
            b"%d:%s" % (pid, b"".join(chunks)) for pid, chunks in sorted(out.items())
        )


# ----------------------------------------------------------------------
# model 2: replica promotion vs publish vs speculative re-publish
# (shuffle/manager.py + elastic/replication.py)
# ----------------------------------------------------------------------
@register_model
class ReplicaPromotionModel(ProtocolModel):
    """The driver's location registry under a racing executor loss.

    exec-a publishes map 0; exec-b publishes map 1 and holds a replica
    of map 0 (published with the 0xFFFC lineage tag, diverted into the
    replica registry); exec-c re-publishes map 0 (a speculative/
    recompute duplicate); exec-a is lost concurrently. All five actors
    call the REAL ``_handle_publish`` / ``_on_peer_lost`` bodies.

    Oracles: a replica never double-serves while its primary lives
    (no is_replica location in the primary registry before the loss);
    at most one serving location per (pid, map); the barrier stays in
    [0, num_maps], never exceeds the distinct serving maps, and only
    decreases across the loss event.
    """

    name = "replica_promotion"
    SID = 1
    NUM_MAPS = 2

    def _publish_msg(self, exec_id: str, map_id: int, mkey: int):
        from sparkrdma_tpu_torch.locations import (
            BlockLocation,
            PartitionLocation,
            ShuffleManagerId,
        )
        from sparkrdma_tpu_torch.rpc import PublishPartitionLocationsMsg

        mid = ShuffleManagerId("mc", 1, exec_id)
        locs = [
            PartitionLocation(
                mid, pid, BlockLocation(0, 3, mkey + pid, source_map=map_id)
            )
            for pid in (0, 1)
        ]
        return PublishPartitionLocationsMsg(
            self.SID, -1, locs, num_map_outputs=1
        )

    def _replica_msg(self):
        from sparkrdma_tpu_torch.locations import (
            BlockLocation,
            PartitionLocation,
            ShuffleManagerId,
        )
        from sparkrdma_tpu_torch.rpc import PublishPartitionLocationsMsg

        mid = ShuffleManagerId("mc", 1, "exec-b")
        locs = [
            PartitionLocation(
                mid,
                pid,
                BlockLocation(0, 3, 90 + pid, replica_of="exec-a", source_map=0),
            )
            for pid in (0, 1)
        ]
        return PublishPartitionLocationsMsg(self.SID, -1, locs, num_map_outputs=0)

    def build(self, sched: CooperativeScheduler) -> None:
        from sparkrdma_tpu_torch.analysis.lockorder import named_lock
        from sparkrdma_tpu_torch.metastore import ShardedMetaStore
        from sparkrdma_tpu_torch.obs import get_registry
        from sparkrdma_tpu_torch.obs.trace import Tracer
        from sparkrdma_tpu_torch.shuffle.handle import BaseShuffleHandle, HashPartitioner
        from sparkrdma_tpu_torch.shuffle.manager import TpuShuffleManager
        from sparkrdma_tpu_torch.utils.config import TpuShuffleConf

        # storage-only construction: the protocol methods under test
        # (_handle_publish, _on_peer_lost) are pure registry mutators —
        # they need the driver-side dicts and locks, not a transport.
        # The location registry itself is a REAL sharded metastore (the
        # control-plane HA hub): publishes here run the epoch-fenced
        # route/apply path, not a plain dict insert
        m = object.__new__(TpuShuffleManager)
        m.is_driver = True
        m.executor_id = "driver"
        m.tracer = Tracer(role="driver", enabled=False)
        m.registry = get_registry()
        m.telemetry = None
        m._lock = named_lock("manager.state", hot=True)
        m._shuffle_locks = {}
        m.metastore = ShardedMetaStore(TpuShuffleConf({}), role="driver")
        m._registered = {
            self.SID: BaseShuffleHandle(self.SID, self.NUM_MAPS, HashPartitioner(2))
        }
        m._maps_done = {}
        m._maps_by_exec = {}
        m._deferred_fetches = {}
        m._map_owner = {}
        m._replica_locations = {}
        m._manager_ids = {}
        m._lost_executors = set()
        self.m = m
        self.loss_started = False
        self._last_done: Optional[int] = None

        def lose() -> None:
            self.loss_started = True
            m._on_peer_lost("exec-a")

        sched.spawn("pub_a", lambda: m._handle_publish(self._publish_msg("exec-a", 0, 10)))
        sched.spawn("pub_b", lambda: m._handle_publish(self._publish_msg("exec-b", 1, 20)))
        sched.spawn("pub_spec", lambda: m._handle_publish(self._publish_msg("exec-c", 0, 30)))
        sched.spawn("replica", lambda: m._handle_publish(self._replica_msg()))
        sched.spawn("loss", lose)

    def _serving(self) -> Dict[Tuple[int, int], List]:
        by_key: Dict[Tuple[int, int], List] = {}
        for pid, locs in self.m._partition_locations.get(self.SID, {}).items():
            for loc in locs:
                by_key.setdefault((pid, loc.block.source_map), []).append(loc)
        return by_key

    def check(self) -> List[str]:
        v: List[str] = []
        m = self.m
        serving = self._serving()
        done = m._maps_done.get(self.SID, 0)
        if not self.loss_started:
            if any(loc.block.is_replica for locs in serving.values() for loc in locs):
                v.append("replica serving while its primary lives")
        for (pid, map_id), locs in serving.items():
            if len(locs) > 1:
                v.append(
                    f"double-serve: {len(locs)} locations for partition "
                    f"{pid} map {map_id}"
                )
        if not 0 <= done <= self.NUM_MAPS:
            v.append(f"barrier out of range: {done}")
        maps_serving = {k[1] for k in serving}
        if done > len(maps_serving):
            v.append(
                f"barrier {done} exceeds {len(maps_serving)} serving maps"
            )
        if self._last_done is not None and done < self._last_done:
            if not self.loss_started:
                v.append(
                    f"barrier decreased {self._last_done}->{done} without loss"
                )
        self._last_done = done
        return v

    def final(self) -> List[str]:
        v = self.check()
        # replicas in the replica registry must never ALSO serve
        serving_ids = {
            id(loc)
            for locs in self.m._partition_locations.get(self.SID, {}).values()
            for loc in locs
        }
        for locs in self.m._replica_locations.get(self.SID, {}).values():
            for loc in locs:
                if id(loc) in serving_ids:
                    v.append("location in both replica and primary registries")
        return v

    def result(self) -> bytes:
        # canonical: which (pid, map) pairs ended up serving — identical
        # across schedules is NOT required (loss ordering legitimately
        # changes coverage), so the serial-identity oracle gets a
        # constant here and the registry invariants above carry the load
        return b"replica_promotion"


# ----------------------------------------------------------------------
# model 3: speculative reduce first-finisher-wins vs cancel
# ----------------------------------------------------------------------
class _SpecWorker:
    """Task-protocol stub: one executor's reduce/cancel surface."""

    def __init__(self, model: "SpeculationModel", executor_id: str, delay: float):
        self.model = model
        self.executor_id = executor_id
        self.delay = delay

    def request(self, req, timeout_s: Optional[float] = None):
        kind = req["kind"]
        if kind == "reduce":
            with self.model.lock:
                self.model.events.append(("issue", self.executor_id))
            schedule_point("proto", f"reduce:{self.executor_id}")
            time.sleep(self.delay)  # virtual under the scheduler
            with self.model.lock:
                self.model.events.append(("finish", self.executor_id))
            return {"by": self.executor_id, "range": (req["start"], req["end"])}
        if kind == "cancel_reduce":
            with self.model.lock:
                self.model.events.append(("cancel", self.executor_id))
            return True
        raise AssertionError(f"unexpected request {kind}")


class _SpecDriver:
    executor_id = "driver"

    def __init__(self, suspects: Set[str]):
        self._suspects = suspects

    @property
    def health(self):
        return self

    def suspects(self) -> Set[str]:
        return set(self._suspects)


class _SpecConf:
    elastic_speculation = True
    elastic_speculation_check_ms = 100


@register_model
class SpeculationModel(ProtocolModel):
    """One reduce range lands on a flagged executor; the REAL
    SpeculativeReducePhase monitor clones it onto a healthy peer and the
    two attempts race to settle. Attempt scheduling (SimPool), the
    monitor's poll timer, and completion callbacks are all explored.

    Oracles: at most two attempts ever issued and at most one clone
    (exactly one speculation in flight); exactly one winner publishes —
    the first SETTLER wins and atomically cancels everyone else still
    in flight, so the published winner can never be an attempt that was
    cancelled (a cancelled winner means a late loser overwrote the
    settled result); the loser is drained (a cancel reaches it)
    whenever both attempts were issued.
    """

    name = "speculation"

    def build(self, sched: CooperativeScheduler) -> None:
        from sparkrdma_tpu_torch.elastic.speculation import SpeculativeReducePhase

        self.lock = threading.Lock()  # raw: guards the event log only
        self.events: List[Tuple[str, str]] = []
        self.outcome: Optional[Tuple[Dict, Dict]] = None
        # the monitor's first poll fires at virtual 0.1 and clones onto
        # exec-fast, whose 0.5 sleep lands on the SAME virtual deadline
        # as exec-slow's 0.6 — both attempts wake at t=0.6, so the
        # picker explores both settle orders (the late-loser race the
        # first-finisher guard defends against)
        slow = _SpecWorker(self, "exec-slow", delay=0.6)
        fast = _SpecWorker(self, "exec-fast", delay=0.5)
        phase = SpeculativeReducePhase(
            driver=_SpecDriver({"exec-slow"}),
            pool=SimPool(sched, prefix="attempt"),
            conf=_SpecConf(),
            live_workers=lambda: [slow, fast],
            handle=type("H", (), {"shuffle_id": 3})(),
            reduce_fn=None,
            tenant=None,
        )

        def run_phase() -> None:
            self.outcome = phase.run([(0, (0, 2), slow)])

        sched.spawn("phase", run_phase)

    def _counts(self) -> Dict[str, int]:
        with self.lock:
            evs = list(self.events)
        return {
            kind: sum(1 for k, _ in evs if k == kind)
            for kind in ("issue", "finish", "cancel")
        }

    def check(self) -> List[str]:
        v: List[str] = []
        c = self._counts()
        if c["issue"] > 2:
            v.append(f"{c['issue']} attempts issued for one range (max 2)")
        inflight = c["issue"] - c["finish"]
        if inflight > 2:
            v.append(f"{inflight} attempts in flight (max 2)")
        return v

    def final(self) -> List[str]:
        v = self.check()
        c = self._counts()
        if self.outcome is None:
            v.append("phase.run never returned")
            return v
        results, failures = self.outcome
        if failures:
            v.append(f"unexpected failures: {failures}")
        if set(results) != {0}:
            v.append(f"expected exactly range 0 settled, got {sorted(results)}")
            return v
        # either attempt may legally settle first (settle order is the
        # picker's choice), but the first settler cancels every other
        # attempt still in flight before anyone else can run — so a
        # winner that RECEIVED a cancel must have overwritten the
        # settled result after losing
        with self.lock:
            cancelled = {eid for kind, eid in self.events if kind == "cancel"}
        winner = results[0]["by"]
        if winner in cancelled:
            v.append(
                f"winner {winner} was cancelled as a loser: a late loser "
                f"overwrote the settled result"
            )
        if c["issue"] == 2 and c["cancel"] == 0:
            v.append("loser attempt was never drained (no cancel issued)")
        return v

    def result(self) -> bytes:
        if self.outcome is None:
            return b""
        results, _ = self.outcome
        # canonical: the settled range payload minus the executor tag
        # (which executor won is legitimately schedule-dependent)
        return repr(sorted((idx, r["range"]) for idx, r in results.items())).encode()


# ----------------------------------------------------------------------
# model 4: quota backpressure vs frees (tenancy/quota.py)
# ----------------------------------------------------------------------
@register_model
class QuotaModel(ProtocolModel):
    """Tenant A fills its quota, blocks on a second charge, and a
    peer thread frees A's bytes; tenant B charges concurrently. The
    REAL QuotaBroker condition-variable protocol runs under virtual
    time (the overrun deadline is a logical timer).

    Oracles: a blocked tenant holds bytes (B, holding zero, is never
    blocked — isolation); no overrun fires while a releaser exists
    (blocked charges are woken by releases, the deadline is a last
    resort); the ledger never goes negative and drains to zero.
    """

    name = "quota_stall"

    def build(self, sched: CooperativeScheduler) -> None:
        from sparkrdma_tpu_torch.obs import get_registry
        from sparkrdma_tpu_torch.tenancy.quota import QuotaBroker

        self.broker = QuotaBroker("modelcheck", 100, block_max_ms=1000)
        self.threads_tenant = {"tA": "A", "tR": "A", "tB": "B"}
        self._overruns = get_registry().counter(
            "tenant.quota_overruns", tenant="A", resource="modelcheck"
        )
        self._overruns0 = self._overruns.value
        self.sched = sched
        charged80 = threading.Event()
        broker = self.broker

        def t_a() -> None:
            broker.charge("A", 80)
            charged80.set()
            broker.charge("A", 50)  # blocks until tR frees (quota 100)
            broker.release("A", 130)

        def t_r() -> None:
            # a peer of tenant A frees the first batch — strictly after
            # it was charged, as any real release pairs with its get
            charged80.wait()
            broker.release("A", 80)

        def t_b() -> None:
            broker.charge("B", 30)
            broker.release("B", 30)

        sched.spawn("tA", t_a)
        sched.spawn("tR", t_r)
        sched.spawn("tB", t_b)

    def check(self) -> List[str]:
        v: List[str] = []
        for t, u in self.broker._usage.items():
            if u < 0:
                v.append(f"negative usage for tenant {t}: {u}")
        # a thread blocked on the broker's condition must hold bytes
        cond_key = id(self.broker._cond)
        for t in self.sched.threads:
            if (
                t.state == "blocked"
                and t.pending.key == cond_key
                and t.name in self.threads_tenant
            ):
                tenant = self.threads_tenant[t.name]
                if self.broker._usage.get(tenant, 0) <= 0:
                    v.append(
                        f"{t.name} blocked on quota while tenant {tenant} "
                        f"holds no bytes (isolation breach)"
                    )
        return v

    def final(self) -> List[str]:
        v = self.check()
        overruns = self._overruns.value - self._overruns0
        if overruns:
            v.append(
                f"{overruns} quota overrun(s) fired although a releaser "
                f"frees the blocked tenant's bytes"
            )
        for t in ("A", "B"):
            u = self.broker._usage.get(t, 0)
            if u != 0:
                v.append(f"ledger not drained for tenant {t}: {u}")
        for t in self.sched.threads:
            if t.name == "tB" and t.block_count:
                v.append(
                    "tenant B (zero held bytes) blocked "
                    f"{t.block_count} time(s) — isolation breach"
                )
        return v

    def result(self) -> bytes:
        return b"quota_stall"


# ----------------------------------------------------------------------
# model 5: sharded metastore under lease fencing, sweep, and driver
# crash (sparkrdma_tpu_torch/metastore, docs/RESILIENCE.md "Control-plane HA")
# ----------------------------------------------------------------------
@register_model
class MetaLeaseModel(ProtocolModel):
    """The REAL ShardedMetaStore under the three control-plane hazards
    at once: a publisher racing its own ``sweep_executor`` tombstone, a
    driver crash (``wipe``: entries gone, leases re-grant under bumped
    epochs, generation advances) racing in-flight epoch-fenced writes,
    and a re-adoption sweep from an OLDER takeover era racing the new
    one (generation fencing). Time is an injected clock the chaos
    thread advances past the lease TTL.

    Threads: pub_a (exec-a's map, swept mid-flight), pub_b (exec-b's
    map, survives), chaos (sweep exec-a -> wipe -> expire leases ->
    generation-fenced adopt re-publish of exec-b), stale_pub (adopt
    sweep fenced at the PRE-wipe generation — must die, not merge),
    reader (epoch-fenced resolves).

    Oracles: no entry predates the wipe (a write routed under a
    pre-crash lease can never land in the post-crash registry); a dead
    shard serves nothing; no tombstoned publisher's location survives
    the final state; the stale-generation sweep leaves no trace; a
    resolve never returns two copies of one (pid, source_map) slot
    (follower double-serve); expired leases cannot renew or serve
    without a takeover epoch bump. ``result()`` is the canonical final
    registry — byte-identical across schedules.
    """

    name = "meta_lease"
    SID = 5

    def _locs(self, exec_id: str, map_id: int, mkey: int):
        from sparkrdma_tpu_torch.locations import (
            BlockLocation,
            PartitionLocation,
            ShuffleManagerId,
        )

        mid = ShuffleManagerId("mc", 1, exec_id)
        return [
            PartitionLocation(
                mid, pid, BlockLocation(0, 3, mkey + pid, source_map=map_id)
            )
            for pid in (0, 1)
        ]

    def build(self, sched: CooperativeScheduler) -> None:
        from sparkrdma_tpu_torch.metastore import ShardedMetaStore, StaleEpochError
        from sparkrdma_tpu_torch.utils.config import TpuShuffleConf

        self.now = [0.0]  # injected clock: ONLY chaos advances it
        conf = TpuShuffleConf({
            "tpu.shuffle.metastore.peers": 3,
            "tpu.shuffle.metastore.vnodes": 4,
            "tpu.shuffle.metastore.rangeSize": 1,
            "tpu.shuffle.metastore.leaseTtlMs": 5000,
            "tpu.shuffle.metastore.replicas": 1,
            "tpu.shuffle.metastore.retryBackoffMs": 1,
        })
        self.store = ShardedMetaStore(
            conf, role="mc-meta", clock=lambda: self.now[0]
        )
        self.StaleEpochError = StaleEpochError
        self.gen0 = self.store.generation  # the pre-crash era
        self.wipe_gen: Optional[int] = None
        self.post_wipe_epochs: Dict[str, int] = {}
        self.reads: List[List] = []
        store = self.store

        def pub(exec_id: str, map_id: int, mkey: int) -> None:
            try:
                store.publish(self.SID, self._locs(exec_id, map_id, mkey))
            except StaleEpochError:
                pass  # retry ladder exhausted: dropped whole, by contract

        def chaos() -> None:
            store.sweep_executor("exec-a", self.SID)
            gen = store.wipe()
            self.wipe_gen = gen
            # record the post-crash epochs, then lapse every lease: any
            # serving past this point must go through takeover
            self.post_wipe_epochs = {
                p: store._leases.epoch(p) for p in store.live_peers()
            }
            self.now[0] += store._leases.ttl_s + 1.0
            try:
                # the re-adoption sweep of the CURRENT era (an executor
                # re-publishing its committed map, generation-fenced)
                store.publish(
                    self.SID, self._locs("exec-b", 1, 20),
                    fence_generation=gen,
                )
            except StaleEpochError:
                pass

        def stale_pub() -> None:
            # an adoption sweep still fenced at the PRE-wipe generation:
            # before the wipe it applies (and is wiped with everything
            # else); after it, it must be rejected whole
            try:
                store.publish(
                    self.SID, self._locs("exec-stale", 2, 40),
                    fence_generation=self.gen0,
                )
            except StaleEpochError:
                pass

        def reader() -> None:
            for _ in range(2):
                try:
                    self.reads.append(store.resolve(self.SID, 0))
                except StaleEpochError:
                    pass

        sched.spawn("pub_a", lambda: pub("exec-a", 0, 10))
        sched.spawn("pub_b", lambda: pub("exec-b", 1, 20))
        sched.spawn("chaos", chaos)
        sched.spawn("stale_pub", stale_pub)
        sched.spawn("reader", reader)

    def _entries(self) -> List[Tuple[str, int, int, int]]:
        """(executor, pid, source_map, gen_applied) across all shards."""
        out = []
        for shard in self.store._shards.values():
            for (sid, pid), bucket in list(shard.entries.items()):
                for loc, gen in list(bucket):
                    out.append(
                        (loc.manager_id.executor_id, pid,
                         loc.block.source_map, gen)
                    )
        return out

    def check(self) -> List[str]:
        v: List[str] = []
        for shard in self.store._shards.values():
            if not shard.alive and shard.entries:
                v.append(f"dead shard {shard.name} still holds entries")
        if self.wipe_gen is not None:
            for exec_id, pid, _sm, gen in self._entries():
                if gen < self.wipe_gen:
                    v.append(
                        f"entry from {exec_id} pid {pid} predates the "
                        f"wipe (applied gen {gen} < {self.wipe_gen}): a "
                        f"pre-crash write landed in the post-crash "
                        f"registry"
                    )
        for locs in self.reads:
            slots: Dict[Tuple[int, int], int] = {}
            for loc in locs:
                k = (loc.partition_id, loc.block.source_map)
                slots[k] = slots.get(k, 0) + 1
            for (pid, sm), n in slots.items():
                if n > 1:
                    v.append(
                        f"double-serve: resolve returned {n} copies of "
                        f"partition {pid} map {sm}"
                    )
        return v

    def final(self) -> List[str]:
        v = self.check()
        entries = self._entries()
        execs = {e for e, _, _, _ in entries}
        if "exec-a" in execs:
            v.append(
                "tombstoned publisher exec-a survives in the registry "
                "(the per-shard sweep check has a window)"
            )
        if "exec-stale" in execs:
            v.append(
                "stale-generation adoption sweep merged into the new era"
            )
        for pid in (0, 1):
            n = sum(
                1 for e, p, _sm, _g in entries
                if e == "exec-b" and p == pid
            )
            # one copy per owner (primary + follower), never more
            if not 1 <= n <= 1 + self.store.replicas:
                v.append(
                    f"re-adoption incomplete or duplicated: exec-b pid "
                    f"{pid} held {n} times (want 1..{1 + self.store.replicas})"
                )
        # expired leases must not serve without a takeover epoch bump
        _, routed = self.store._route(self.SID, 0)
        for peer, epoch in routed:
            before = self.post_wipe_epochs.get(peer)
            if before is not None and epoch <= before:
                v.append(
                    f"peer {peer} serves epoch {epoch} although its "
                    f"lease lapsed at epoch {before}: expired lease "
                    f"served without takeover"
                )
        # a renew carrying a superseded epoch must fence
        leases = self.store._leases
        peer = self.store.live_peers()[0]
        cur = leases.epoch(peer)
        if cur > 1:
            try:
                leases.renew(peer, cur - 1)
                v.append("renew accepted a superseded epoch")
            except self.StaleEpochError:
                pass
        # ... and so must a renew of a lapsed lease (re-acquire via
        # takeover, never silently resurrect)
        self.now[0] += leases.ttl_s + 1.0
        try:
            leases.renew(peer, leases.epoch(peer))
            v.append("renew resurrected an expired lease")
        except self.StaleEpochError:
            pass
        return v

    def result(self) -> bytes:
        # canonical final registry: primary-copy (executor, pid, map)
        # triples — identical across schedules (exec-a swept, stale
        # sweep dead, exec-b re-adopted exactly once per slot)
        ents = self.store.entries_for_shuffle(self.SID)
        return repr(sorted(
            (loc.manager_id.executor_id, pid, loc.block.source_map)
            for pid, locs in sorted(ents.items())
            for loc in locs
        )).encode()
