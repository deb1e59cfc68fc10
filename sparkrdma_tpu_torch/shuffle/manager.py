"""TpuShuffleManager — the top-level shuffle plugin entry point.

Analogue of RdmaShuffleManager.scala (reference: RdmaShuffleManager.scala).
Semantics preserved (SURVEY.md §5.1):

- the **driver** is the metadata hub: executors publish partition
  locations to it and fetch locations from it; executors never gossip
  (:108-119, 376-420),
- driver constructor starts the transport node immediately and writes
  the negotiated port back into the conf (:180-184); executors start
  their node lazily on first writer/reader and introduce themselves
  with a hello RPC (:241-289),
- every hello triggers a full-membership announce to all executors,
  which pre-warm connections in the background (:121-169),
- executor loss prunes its locations from the driver registry
  (:199-221) — detected here via transport peer-loss events,
- RPC dispatch runs on completion threads and must not block
  (:65-178).

A copy of the JAX package's ``shuffle/manager.py``, cut only where
another plane is missing from the port:

- ``get_writer``, ``get_reader`` and the writer-backed shuffle data
  raise ``NotImplementedError`` until the writers and readers come with
  ROADMAP item M4; device blocks publish and fetch through
  ``shuffle/device_io.py`` (``DeviceShuffleIO``);
- the driver's telemetry hub stays None until ROADMAP item M8, so
  ``partition_sizes`` reads the location registry (JAX's branch with
  telemetry off);
- the push/merge plane (``push.enabled``) rides the chunked-agg writer,
  so with no writer there is nothing to push: ``push_client`` and
  ``merge_endpoint`` stay None until M4;
- the elastic replica store (``elastic.replicas`` > 0) raises
  ``NotImplementedError`` until ROADMAP item M8;
- the lock-order detector, the model checker's schedule points, the
  journal and the fault plan are the inert seams of ``utils/seams.py``.

Nothing here touches the device; ``DeviceShuffleIO`` owns the card.
"""

from __future__ import annotations

import logging
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import replace
from typing import Dict, List, Optional, Set, Tuple

from sparkrdma_tpu_torch.utils.seams import OrderedLock, named_lock
from sparkrdma_tpu_torch.utils.seams import schedule_point
from sparkrdma_tpu_torch.locations import PartitionLocation, ShuffleManagerId
from sparkrdma_tpu_torch.metastore import ShardedMetaStore, StaleEpochError
from sparkrdma_tpu_torch.obs import SpanHandle, Tracer, get_registry, mint_trace_id
from sparkrdma_tpu_torch.obs import now as obs_now
from sparkrdma_tpu_torch.utils.seams import journal_emit
from sparkrdma_tpu_torch.resilience import SourceHealthRegistry
from sparkrdma_tpu_torch.tenancy import AdmissionController, FairShareExecutor
from sparkrdma_tpu_torch.tenancy import quota as _tquota
from sparkrdma_tpu_torch.utils.seams import faults as _faults
from sparkrdma_tpu_torch.utils import checksum as _checksum
from sparkrdma_tpu_torch.rpc import (
    AnnounceManagersMsg,
    FetchPartitionLocationsMsg,
    ManagerHelloMsg,
    PublishPartitionLocationsMsg,
    RpcMsg,
)
from sparkrdma_tpu_torch.shuffle.handle import BaseShuffleHandle
from sparkrdma_tpu_torch.shuffle.resolver import TpuShuffleBlockResolver
from sparkrdma_tpu_torch.shuffle.stats import ShuffleReaderStats
from sparkrdma_tpu_torch.transport import FnListener, TpuNode, create_node
from sparkrdma_tpu_torch.utils.config import PREFIX, TpuShuffleConf

logger = logging.getLogger(__name__)


class TpuShuffleManager:
    def __init__(
        self,
        conf: TpuShuffleConf,
        is_driver: bool,
        executor_id: Optional[str] = None,
        host: str = "127.0.0.1",
    ):
        # drop-in SPI contract: a foreign engine may pass any plain
        # mapping (its own conf object, the SparkConf role). The driver
        # writes the negotiated listener port back INTO that mapping so
        # executors constructed from it afterwards inherit it — exactly
        # conf.setDriverPort semantics (RdmaShuffleManager.scala:183-184)
        self._external_conf = None
        if not isinstance(conf, TpuShuffleConf):
            self._external_conf = conf
            conf = TpuShuffleConf(dict(conf))
        self.conf = conf
        self.is_driver = is_driver
        self.executor_id = executor_id or ("driver" if is_driver else "executor")
        self.host = host

        self.node: Optional[TpuNode] = None
        self._node_lock = named_lock("manager.node")

        # driver state
        self._manager_ids: Dict[str, ShuffleManagerId] = {}
        # the locations registry: sharded by (shuffle_id, partition
        # range) across lease-replicated metadata peers (control-plane
        # HA, sparkrdma_tpu_torch/metastore). The old monolithic
        # ``_partition_locations`` dict survives as a read-only
        # property materializing the store's primary-copy view.
        self.metastore: Optional[ShardedMetaStore] = (
            ShardedMetaStore(conf, role=self.executor_id) if is_driver else None
        )
        self._registered: Dict[int, BaseShuffleHandle] = {}
        # map-output tracking: fetch replies wait for shuffle completeness
        self._maps_done: Dict[int, int] = {}
        self._deferred_fetches: Dict[int, List[FetchPartitionLocationsMsg]] = {}
        # per-executor attribution of published map outputs, so peer loss
        # can re-arm the barrier (shuffle_id -> executor_id -> count)
        self._maps_by_exec: Dict[int, Dict[str, int]] = {}
        # elastic layer (sparkrdma_tpu_torch/elastic/): first-finisher map
        # ownership (shuffle_id -> map_id -> executor_id; a later
        # publish of an owned map — a speculative clone losing the race
        # — is dropped whole) and the replica registry (shuffle_id ->
        # partition_id -> replica locations). Replicas never enter
        # fetch replies; _on_peer_lost promotes them when their primary
        # executor dies.
        self._map_owner: Dict[int, Dict[int, str]] = {}
        self._replica_locations: Dict[int, Dict[int, List[PartitionLocation]]] = {}
        # executors already processed by _on_peer_lost: a straggling
        # publish from one (a speculative finish racing the loss event)
        # must be dropped whole — accepting it would double-serve next
        # to a promoted replica and corrupt the barrier (found by the
        # modelcheck replica_promotion model)
        self._lost_executors: Set[str] = set()
        # publish/fetch mutation of ONE shuffle's registry serializes on
        # that shuffle's lock, not the manager-wide ``_lock`` — under a
        # contended map pool, concurrent shuffles' publishes used to
        # queue on one lock (WORKLOADS: 21.2 s contended vs 3.2 s
        # uncontended publish busy). ``_lock`` stays the guard for the
        # registry-of-shuffles structure itself and everything not
        # keyed by shuffle id. Ordering: shuffle lock OUTER, ``_lock``
        # inner (held only for dict lookups, never across handler work).
        self._shuffle_locks: Dict[int, OrderedLock] = {}

        # executor state
        self._fetch_futures: Dict[Tuple[int, int], Future] = {}
        self._fetch_acc: Dict[Tuple[int, int], List[PartitionLocation]] = {}
        self._known_managers: List[ShuffleManagerId] = []
        # critical-path attribution: span id of the driver's resolve
        # span per (shuffle_id, start_partition), learned from the
        # location reply's follows extension so the fetch spans it
        # caused can declare the causal edge (obs/critpath.py)
        self._resolve_origins: Dict[Tuple[int, int], SpanHandle] = {}
        # driver side of the same chain: handles of the per-writer
        # publish record spans, so resolve spans follow the publishes
        # they serve (publish -> resolve -> fetch in the Perfetto DAG)
        self._publish_origins: Dict[int, List[SpanHandle]] = {}

        # hot: dict lookups only (see _shuffle_locks comment above) —
        # the lock-order detector enforces that no blocking call runs
        # under it
        self._lock = named_lock("manager.state", hot=True)
        self._stopped = False
        # bounded map-task pool (conf map.parallelism): the engine runs
        # this executor's map tasks through here instead of a sequential
        # loop, so one executor overlaps several shards' write pipelines
        self._map_pool: Optional[ThreadPoolExecutor] = None

        self.reader_stats = (
            ShuffleReaderStats(conf) if conf.collect_shuffle_read_stats else None
        )

        # observability: process-wide registry + per-role tracer. Reader
        # ShuffleMetrics objects are retained (they are tiny dataclasses
        # with no back-references) so metrics_snapshot() can aggregate
        # the read path even after readers are dropped.
        self.registry = get_registry()
        self.tracer = Tracer(
            role=self.executor_id,
            max_spans=conf.trace_max_spans,
            enabled=conf.trace_enabled,
        )
        self._reader_metrics: List[object] = []

        # resilience: per-remote-manager circuit breakers (fetchers and
        # the device IO path consult these before issuing READs) and
        # the conf-driven fault plan for reproducible chaos runs
        self.health = SourceHealthRegistry(conf, role=self.executor_id)
        _faults.ensure_installed(conf.fault_plan, conf.fault_plan_seed)

        # tenancy: the driver admits jobs (bounded in-flight + FIFO
        # queue-with-deadline); every manager installs the process-wide
        # quota brokers (idempotent — first tenancy-enabled conf wins)
        self.admission: Optional[AdmissionController] = None
        if conf.tenancy_enabled:
            _tquota.install(conf)
            if is_driver:
                self.admission = AdmissionController(
                    conf.tenancy_max_concurrent_jobs,
                    conf.tenancy_admit_timeout_ms,
                    role=self.executor_id,
                )

        # cluster telemetry plane: the driver (already the metadata hub
        # for every shuffle) folds executor heartbeats into per-executor
        # time series and runs the straggler detector; its report feeds
        # the health registry as an advisory signal (obs/telemetry.py)
        # (the hub is ROADMAP item M8: until then the driver runs as
        # JAX's does with obs.telemetry.enabled off)
        self.telemetry = None

        if is_driver:
            # driver starts its node eagerly and records the negotiated
            # port for executors (:180-184)
            self.node = create_node(
                conf,
                host,
                is_executor=False,
                executor_id=self.executor_id,
                recv_listener=self._receive_listener,
                peer_lost_listener=self._on_peer_lost,
            )
            conf.set_driver_port(self.node.port)
            if self._external_conf is not None:
                try:
                    self._external_conf[PREFIX + "driverPort"] = str(self.node.port)
                except TypeError:
                    pass  # immutable mapping: executors need the port passed

        self.resolver = TpuShuffleBlockResolver(self)

        # push/merge plane (shuffle/merge.py): every manager hosts a
        # merge endpoint (receiving pushed blocks for partitions it
        # will reduce) and a push client (shipping its own sealed map
        # blocks toward their reducers). Both are strictly best-effort
        # overlays on the locations API — disabling them changes
        # nothing but read amplification.
        #
        # In the port the plane pushes the chunked-agg writer's blocks,
        # and the writers are ROADMAP item M4: with no writer there is
        # nothing to push, so both stay None whatever push.enabled says.
        self.push_client = None
        self.merge_endpoint = None
        # elastic replication plane (sparkrdma_tpu_torch/elastic/): executors
        # host a replica store (receiving peers' map-output copies) and
        # a replica client (shipping their own) when durability is on.
        # Like push/merge, a best-effort overlay on the locations API.
        self.replica_client = None
        self.replica_store = None
        if conf.elastic_replicas > 0 and not is_driver:
            raise NotImplementedError(
                "tpu.shuffle.elastic.replicas > 0 needs the elastic plane, "
                "which the port brings with ROADMAP item M8"
            )
        # publish-time checksum tagging pool (lazy; see _checksummed)
        self._ck_pool: Optional[ThreadPoolExecutor] = None

    # ------------------------------------------------------------------
    # node lifecycle
    # ------------------------------------------------------------------
    @property
    def local_manager_id(self) -> ShuffleManagerId:
        assert self.node is not None, "node not started"
        return ShuffleManagerId(self.host, self.node.port, self.executor_id)

    def start_node_if_missing(self) -> None:
        """Executor lazy init + hello to driver (:241-289)."""
        if self.node is not None:
            return
        with self._node_lock:
            if self.node is not None:
                return
            node = create_node(
                self.conf,
                self.host,
                is_executor=True,
                executor_id=self.executor_id,
                recv_listener=self._receive_listener,
            )
            self.node = node
        ch = self.node.get_channel(self.conf.driver_host, self.conf.driver_port)
        hello = ManagerHelloMsg(self.local_manager_id)
        done = threading.Event()
        ch.send_in_queue(
            FnListener(lambda _: done.set(), lambda e: done.set()),
            hello.to_segments(self.conf.recv_wr_size),
        )
        done.wait(self.conf.connect_timeout_ms / 1000.0)

    # ------------------------------------------------------------------
    # RPC dispatch (reference receiveListener, :65-178)
    # ------------------------------------------------------------------
    def _receive_listener(self, channel, payload: bytes) -> None:
        t0 = time.perf_counter()
        plan = _faults.active()
        if plan is not None:
            payload, handled = plan.on_rpc(
                getattr(channel, "peer_desc", ""), payload
            )
            if handled:
                return
        try:
            msg = RpcMsg.parse_segment(payload)
            if isinstance(msg, ManagerHelloMsg):
                self._handle_hello(msg)
            elif isinstance(msg, FetchPartitionLocationsMsg):
                self._handle_fetch(msg)
            elif isinstance(msg, PublishPartitionLocationsMsg):
                self._handle_publish(msg)
            elif isinstance(msg, AnnounceManagersMsg):
                self._handle_announce(msg)
        except Exception:
            self.registry.counter("rpc.errors", role=self.executor_id).inc()
            logger.exception("error dispatching rpc message")
        else:
            mtype = msg.msg_type.name
            self.registry.counter(
                "rpc.messages", role=self.executor_id, type=mtype
            ).inc()
            self.registry.histogram(
                "rpc.handle_ms", role=self.executor_id, type=mtype
            ).observe((time.perf_counter() - t0) * 1e3)

    def _shuffle_lock(self, shuffle_id: int) -> OrderedLock:
        """Per-shuffle registry lock (driver side). Sharding by
        shuffle_id lets concurrent publishes for independent shuffles
        proceed in parallel; the global ``_lock`` is only held for the
        dict lookup (lock order: shuffle lock OUTER, ``_lock`` inner)."""
        with self._lock:
            return self._shuffle_locks.setdefault(
                shuffle_id, named_lock("manager.shuffle")
            )

    @property
    def _partition_locations(
        self,
    ) -> Dict[int, Dict[int, List[PartitionLocation]]]:
        """Read-only primary-copy view of the sharded registry, in the
        shape the monolithic dict always had (shuffle_id -> pid ->
        locations). Kept for tests and diagnostics; every mutation
        goes through the metastore's epoch-fenced publish/sweep."""
        if self.metastore is None:
            return {}
        return self.metastore.all_entries()

    def _handle_hello(self, msg: ManagerHelloMsg) -> None:
        """Driver: record membership, connect back, announce to all (:121-161)."""
        if not self.is_driver:
            return
        mid = msg.manager_id
        with self._lock:
            self._manager_ids[mid.executor_id] = mid
            members = list(self._manager_ids.values())
        assert self.node is not None
        # warm the driver's active channel back to the new executor (:126-128)
        try:
            self.node.get_channel(mid.host, mid.port)
        except IOError:
            logger.warning("could not connect back to %s", mid)
            return
        announce = AnnounceManagersMsg(members)
        segments = announce.to_segments(self.conf.recv_wr_size)
        for member in members:
            try:
                ch = self.node.get_channel(member.host, member.port)
                ch.send_in_queue(FnListener(), segments)
            except IOError:
                logger.warning("announce to %s failed", member)

    def _handle_announce(self, msg: AnnounceManagersMsg) -> None:
        """Executor: learn membership, pre-warm connections (:163-169)."""
        with self._lock:
            for mid in msg.manager_ids:
                if mid not in self._known_managers:
                    self._known_managers.append(mid)
            to_warm = [m for m in self._known_managers if m.executor_id != self.executor_id]

        def warm():
            for m in to_warm:
                try:
                    assert self.node is not None
                    self.node.get_channel(m.host, m.port, must_retry=False)
                except IOError:
                    pass

        # analysis: ignore[tenant-scope]: cluster-membership pre-warm, no tenant-attributed work
        threading.Thread(target=warm, name="prewarm", daemon=True).start()

    def _handle_fetch(self, msg: FetchPartitionLocationsMsg) -> None:
        """Driver: answer a location fetch for [start, end) (:108-119).

        Replies are deferred until every map output of the shuffle has
        been published (the MapOutputTracker barrier the reference
        delegates to Spark).
        """
        if not self.is_driver:
            return
        with self._shuffle_lock(msg.shuffle_id):
            with self._lock:
                handle = self._registered.get(msg.shuffle_id)
            if handle is not None and self._maps_done.get(msg.shuffle_id, 0) < handle.num_maps:
                self._deferred_fetches.setdefault(msg.shuffle_id, []).append(msg)
                return
        self._reply_fetch(msg)

    def _reply_fetch(self, msg: FetchPartitionLocationsMsg) -> None:
        with self._lock:
            pub_origins = list(self._publish_origins.get(msg.shuffle_id, ()))
        with self.tracer.span(
            "shuffle.resolve",
            shuffle_id=msg.shuffle_id,
            trace_id=msg.trace_id,
            follows=[SpanHandle(msg.trace_id, msg.origin_span)] + pub_origins,
            requester=msg.requester.executor_id,
            partitions=f"{msg.start_partition}:{msg.end_partition}",
        ) as rsp:
            locs: List[PartitionLocation] = []
            with self._shuffle_lock(msg.shuffle_id):
                assert self.metastore is not None
                try:
                    locs = self.metastore.resolve_range(
                        msg.shuffle_id, msg.start_partition, msg.end_partition
                    )
                except StaleEpochError:
                    # every retry re-routed into another takeover: serve
                    # what we can (nothing) rather than wedge the reply
                    logger.warning(
                        "resolve of shuffle %d [%d:%d) exhausted epoch retries",
                        msg.shuffle_id, msg.start_partition, msg.end_partition,
                    )
            reply = PublishPartitionLocationsMsg(
                msg.shuffle_id,
                msg.start_partition,
                locs,
                trace_id=self.tracer.trace_for(msg.shuffle_id) or msg.trace_id,
                origin_span=rsp.span_id if rsp is not None else 0,
            )
            assert self.node is not None
            try:
                ch = self.node.get_channel(msg.requester.host, msg.requester.port)
                ch.send_in_queue(FnListener(), reply.to_segments(self.conf.recv_wr_size))
            except IOError:
                logger.warning("publish reply to %s failed", msg.requester)

    @staticmethod
    def _is_replica_publish(msg: PublishPartitionLocationsMsg) -> bool:
        """A replica publish must divert into the replica registry —
        serving it beside its live primary would read the same map
        output twice. Named so the modelcheck mutation gate can disarm
        the divert and prove the double-serve oracle notices."""
        return bool(msg.locations) and msg.locations[0].block.is_replica

    def _claim_map_owner(
        self, owner_map: Dict[int, str], map_id: int, exec_id: str
    ) -> bool:
        """First-finisher map-ownership claim (caller holds the shuffle
        lock). False = a different executor already owns the map — the
        publish is a speculative clone that lost the race and must be
        dropped whole. The seam between the read and the write is a
        model-checker schedule point: the shuffle lock is what makes
        check-then-claim atomic, and the modelcheck mutation gate proves
        the checker notices when it is not."""
        prev = owner_map.get(map_id)
        if prev is not None and prev != exec_id:
            return False
        schedule_point("proto", "manager.publish.claim")
        owner_map[map_id] = exec_id
        return True

    def _handle_publish(self, msg: PublishPartitionLocationsMsg) -> None:
        if self.is_driver:
            schedule_point("proto", "manager.publish")
            if msg.is_last and msg.partition_id < 0:
                # one span per completed writer publish (not per segment)
                t = obs_now()
                psp = self.tracer.record(
                    "shuffle.publish",
                    t,
                    t,
                    shuffle_id=msg.shuffle_id,
                    trace_id=msg.trace_id,
                    follows=SpanHandle(msg.trace_id, msg.origin_span),
                    locations=len(msg.locations),
                    map_outputs=msg.num_map_outputs,
                )
                if psp is not None:
                    with self._lock:
                        origins = self._publish_origins.setdefault(
                            msg.shuffle_id, []
                        )
                        if len(origins) < 256:  # bound per-shuffle growth
                            origins.append(psp.handle())
            # replica publishes (elastic layer) divert whole into the
            # replica registry: they must never reach fetch replies or
            # the planner's byte totals until a promotion makes them
            # primary (_on_peer_lost)
            if self._is_replica_publish(msg):
                with self._shuffle_lock(msg.shuffle_id):
                    with self._lock:
                        reg = self._replica_locations.setdefault(msg.shuffle_id, {})
                        lost = set(self._lost_executors)
                    for loc in msg.locations:
                        # a replica whose holder is already gone would
                        # never be pruned again — drop it here
                        if loc.manager_id.executor_id in lost:
                            continue
                        if loc.block.is_replica:
                            reg.setdefault(loc.partition_id, []).append(loc)
                return
            # writers publish with partition_id = -1; re-key every location
            # by its own partition id (:68-95). Three phases:
            #   1. under the shuffle lock: generation fence, swept-
            #      publisher fast check, first-finisher ownership claim;
            #   2. OUTSIDE it: per-shard epoch-fenced inserts (the
            #      metastore re-routes and retries stale epochs through
            #      the ladder);
            #   3. under the shuffle lock again: barrier accounting —
            #      AFTER the inserts landed, and only if the publisher
            #      was not swept meanwhile (the per-shard tombstones
            #      dropped its locations; counting it would complete a
            #      barrier whose locations never landed).
            assert self.metastore is not None
            to_reply: List[FetchPartitionLocationsMsg] = []
            exec_id = (
                msg.locations[0].manager_id.executor_id if msg.locations else ""
            )
            with self._shuffle_lock(msg.shuffle_id):
                if msg.meta_epoch and msg.meta_epoch != self.metastore.generation:
                    # a re-adoption sweep started under an older
                    # takeover: reject it whole before it claims
                    # ownership it could block a recompute with
                    self.registry.counter(
                        "metastore.stale_epoch_rejects", role=self.executor_id
                    ).inc()
                    return
                # first-finisher-wins dedup for attributed map publishes:
                # a speculative clone of a map whose original already
                # published (or vice versa) is dropped whole, so the
                # barrier and the location registry never double-count
                owner_map = self._map_owner.setdefault(msg.shuffle_id, {})
                if (
                    msg.num_map_outputs > 0
                    and msg.locations
                    and msg.locations[0].block.source_map >= 0
                ):
                    map_id = msg.locations[0].block.source_map
                    if exec_id in self._lost_executors:
                        # publisher already swept by _on_peer_lost: its
                        # replicas were promoted and its counts pruned;
                        # this straggler's blocks live on a dead node
                        self.registry.counter(
                            "elastic.publishes_dropped", role=self.executor_id
                        ).inc()
                        return
                    if not self._claim_map_owner(owner_map, map_id, exec_id):
                        self.registry.counter(
                            "elastic.publishes_dropped", role=self.executor_id
                        ).inc()
                        return
            try:
                self.metastore.publish(
                    msg.shuffle_id, msg.locations,
                    fence_generation=msg.meta_epoch,
                )
            except StaleEpochError:
                # counted by the store; an adoption-era mismatch or an
                # exhausted retry ladder drops the message whole — the
                # barrier below never runs, so completeness stays honest
                return
            if msg.meta_epoch and msg.num_map_outputs > 0:
                # a generation-matched re-publish after a hub wipe: the
                # crashed registry just re-adopted this map's state
                self.registry.counter(
                    "metastore.adoptions", role=self.executor_id
                ).inc()
                journal_emit(
                    "meta.adopt", role=self.executor_id, executor=exec_id,
                    shuffle_id=msg.shuffle_id, generation=msg.meta_epoch,
                )
            with self._shuffle_lock(msg.shuffle_id):
                with self._lock:
                    handle = self._registered.get(msg.shuffle_id)
                if msg.is_last and msg.num_map_outputs > 0:
                    if exec_id and exec_id in self._lost_executors:
                        # swept between the claim and the inserts: the
                        # per-shard tombstones dropped the locations
                        # (or the sweep pruned them); counting this
                        # publish would complete a barrier whose
                        # locations never landed (meta_lease model)
                        self.registry.counter(
                            "elastic.publishes_dropped", role=self.executor_id
                        ).inc()
                        return
                    done = self._maps_done.get(msg.shuffle_id, 0) + msg.num_map_outputs
                    self._maps_done[msg.shuffle_id] = done
                    if msg.locations:
                        # attribute to the publishing executor so its loss
                        # re-arms the barrier; empty publishes (maps with
                        # no output data) have nothing to lose and stay
                        # counted unconditionally
                        by_exec = self._maps_by_exec.setdefault(msg.shuffle_id, {})
                        by_exec[exec_id] = by_exec.get(exec_id, 0) + msg.num_map_outputs
                    if handle is not None and done >= handle.num_maps:
                        to_reply = self._deferred_fetches.pop(msg.shuffle_id, [])
            # feed the adaptive planner: per-partition byte totals of
            # ORIGINAL locations (merged segments re-cover the same
            # bytes and would double-count; re-adoption publishes were
            # counted the first time around)
            if self.telemetry is not None and msg.partition_id < 0 and not msg.meta_epoch:
                for loc in msg.locations:
                    if not loc.block.merged_cover:
                        # source executor = the DMA lane this block will
                        # pull over (collective schedule lane balancing)
                        self.telemetry.record_partition_bytes(
                            msg.shuffle_id, loc.partition_id,
                            loc.block.length,
                            source=loc.manager_id.executor_id,
                        )
            for fetch in to_reply:
                self._reply_fetch(fetch)
            return
        # executor: location-fetch responses, accumulated until is_last
        self.tracer.bind_shuffle(msg.shuffle_id, msg.trace_id)
        key = (msg.shuffle_id, msg.partition_id)
        with self._lock:
            self._fetch_acc.setdefault(key, []).extend(msg.locations)
            if msg.origin_span:
                # the driver resolve span this reply hands off from;
                # the fetch spans it causes follow it (resolve→fetch)
                self._resolve_origins[key] = SpanHandle(
                    msg.trace_id, msg.origin_span
                )
            if not msg.is_last:
                return
            locs = self._fetch_acc.pop(key, [])
            future = self._fetch_futures.pop(key, None)
        if future is not None:
            future.set_result(locs)

    def resolve_origin(
        self, shuffle_id: int, start_partition: int
    ) -> Optional[SpanHandle]:
        """Causal handle of the driver resolve span that answered this
        (shuffle, range) location fetch, if the reply carried one."""
        with self._lock:
            return self._resolve_origins.get((shuffle_id, start_partition))

    def _on_peer_lost(self, executor_id: str) -> None:
        """Driver: prune a lost executor's locations (:199-221).

        Also subtracts the executor's published map outputs from the
        completeness barrier, so later fetches defer (and eventually
        time out into MetadataFetchFailedError on the reducer) instead
        of receiving a complete-looking but incomplete location set —
        the reference's missing-MapStatus semantics.

        Elastic layer: before re-arming the barrier, any replica of the
        lost executor's blocks (elastic/replication.py, the service
        daemon) is *promoted* into the primary registry — the barrier
        only drops by the maps no replica covers, so a fully replicated
        executor's death costs zero recompute."""
        if not self.is_driver:
            return
        schedule_point("proto", "manager.peer_lost")
        assert self.metastore is not None
        with self._lock:
            self._manager_ids.pop(executor_id, None)
            self._lost_executors.add(executor_id)
            shuffle_ids = set(self._maps_by_exec) | set(self._replica_locations)
        shuffle_ids |= set(self.metastore.shuffle_ids())
        for shuffle_id in shuffle_ids:
            promoted_maps: set = set()
            # per-shuffle seam OUTSIDE the shuffle lock: publishes for
            # other shuffles may interleave between prune steps
            schedule_point("proto", "manager.peer_lost.shuffle")
            with self._shuffle_lock(shuffle_id):
                with self._lock:
                    by_exec = self._maps_by_exec.get(shuffle_id)
                    replicas = self._replica_locations.get(shuffle_id)
                    owner_map = self._map_owner.get(shuffle_id)
                # tombstone + prune shard by shard: a publish racing this
                # sweep either lands before a shard's sweep (pruned) or
                # after it (dropped by the shard's tombstone) — the
                # check holds PER SHARD, never per process
                self.metastore.sweep_executor(executor_id, shuffle_id)
                promoted_locs: List[PartitionLocation] = []
                if replicas is not None:
                    # drop replicas the lost executor itself was holding,
                    # then promote its surviving replicas into the
                    # primary registry (replica_of stays set so the
                    # fetchers' failover rung can identity-match them)
                    promoted_by_holder: Dict[str, set] = {}
                    promoted_slots: set = set()
                    for pid in list(replicas.keys()):
                        keep: List[PartitionLocation] = []
                        for loc in replicas[pid]:
                            if loc.manager_id.executor_id == executor_id:
                                continue
                            if loc.block.replica_of == executor_id:
                                sm = loc.block.source_map
                                if (
                                    sm >= 0
                                    and owner_map is not None
                                    and owner_map.get(sm, executor_id)
                                    != executor_id
                                ):
                                    # the map is owned by a LIVE primary
                                    # (the lost executor lost the dedup
                                    # race to a speculative clone):
                                    # promoting this replica would serve
                                    # the same map twice — drop it
                                    continue
                                if sm >= 0 and (pid, sm) in promoted_slots:
                                    # second replica of the same slot
                                    # (replication factor > 1): one
                                    # promotion serves it, spares drop
                                    continue
                                if sm >= 0:
                                    promoted_slots.add((pid, sm))
                                promoted_locs.append(loc)
                                if loc.block.source_map >= 0:
                                    promoted_maps.add(loc.block.source_map)
                                    promoted_by_holder.setdefault(
                                        loc.manager_id.executor_id, set()
                                    ).add(loc.block.source_map)
                            else:
                                keep.append(loc)
                        replicas[pid] = keep
                    # re-attribute the covered maps to their new holders
                    # so a later loss of the holder re-arms the barrier.
                    # A promoted map may have NO owner/attribution entry
                    # yet (its primary publish raced the loss event and
                    # was tombstone-dropped): claim it for the holder
                    # anyway — and credit the barrier for it, since the
                    # promoted replica IS that map's output — so a
                    # straggling duplicate publish is deduped instead of
                    # double-serving beside the promoted replica (found
                    # by the modelcheck replica_promotion model)
                    if promoted_maps:
                        if by_exec is None or owner_map is None:
                            with self._lock:
                                by_exec = self._maps_by_exec.setdefault(
                                    shuffle_id, {}
                                )
                                owner_map = self._map_owner.setdefault(
                                    shuffle_id, {}
                                )
                        for holder, maps in promoted_by_holder.items():
                            by_exec[holder] = by_exec.get(holder, 0) + len(maps)
                            for m in maps:
                                owner_map[m] = holder
                if promoted_locs:
                    # promoted replicas become primary REGISTRY entries:
                    # epoch-fenced inserts like any publish (their
                    # holders are live, so no tombstone drops them)
                    try:
                        self.metastore.publish(shuffle_id, promoted_locs)
                    except StaleEpochError:
                        logger.warning(
                            "replica promotion for shuffle %d exhausted "
                            "epoch retries", shuffle_id,
                        )
                if owner_map is not None:
                    # uncovered maps lose their owner: the recompute's
                    # re-publish must be accepted, not deduped away
                    for m in [
                        m for m, e in owner_map.items()
                        if e == executor_id and m not in promoted_maps
                    ]:
                        del owner_map[m]
                if by_exec is not None:
                    lost = by_exec.pop(executor_id, 0)
                    # barrier delta: every promoted map is now served by
                    # its replica (+1 each, whether or not the lost
                    # executor's publish ever counted — a tombstone-
                    # dropped publish never did), every counted map of
                    # the lost executor stops being served (-lost);
                    # promoted maps it did publish cancel out
                    delta = len(promoted_maps) - lost
                    if delta:
                        self._maps_done[shuffle_id] = (
                            self._maps_done.get(shuffle_id, 0) + delta
                        )
            if promoted_maps:
                self.registry.counter(
                    "elastic.replica_promotions", role=self.executor_id
                ).inc(len(promoted_maps))
                journal_emit(
                    "elastic.promote", role=self.executor_id,
                    executor=executor_id, shuffle_id=shuffle_id,
                    maps=len(promoted_maps),
                    holders=len(promoted_by_holder),
                )
        logger.info("pruned locations of lost executor %s", executor_id)

    # ------------------------------------------------------------------
    # metadata API (reference :343-420)
    # ------------------------------------------------------------------
    def _with_checksum(self, loc: PartitionLocation) -> PartitionLocation:
        """Attach the publish-time integrity tag to one location.

        Computed HERE — the single funnel every publish path (wrapper
        writer, chunked-agg finalize, device IO, manual test publishes)
        already flows through — by resolving the advertised
        ``(mkey, address, length)`` in the local ProtectionDomain,
        exactly the view a remote READ will be served from. Resolution
        failure (foreign publisher, unregistered test triple) leaves
        the location untagged: integrity is best-effort, never a new
        failure mode."""
        if loc.block.checksum_algo or loc.block.length == 0:
            return loc
        node = self.node
        if node is None:
            return loc
        try:
            view = node.pd.resolve(loc.block.mkey, loc.block.address, loc.block.length)
        except Exception:
            return loc
        algo, crc = _checksum.compute(view)
        if algo == _checksum.ALGO_NONE:
            return loc
        return replace(loc, block=replace(loc.block, checksum=crc, checksum_algo=algo))

    def _checksummed(
        self, locations: List[PartitionLocation]
    ) -> List[PartitionLocation]:
        """Tag a publish batch, sharding the checksum compute across a
        small pool for large batches (conf ``publish.checksumWorkers``;
        0/1 = inline). The contended-publish ledger rows showed the
        tagging loop dominating publish busy time when every executor's
        finalize lands at once — order is preserved, tagging stays the
        single funnel of :meth:`_with_checksum`."""
        workers = self.conf.publish_checksum_workers
        if workers <= 1 or len(locations) < 4 * workers:
            return [self._with_checksum(loc) for loc in locations]
        with self._lock:
            if self._stopped:
                # create-vs-close race: never spin up a pool that
                # stop() has already swept past (it would leak)
                raise RuntimeError(
                    f"manager {self.executor_id} is stopped; cannot publish"
                )
            if self._ck_pool is None:
                self._ck_pool = ThreadPoolExecutor(
                    max_workers=workers,
                    thread_name_prefix=f"ck-{self.executor_id}",
                )
            pool = self._ck_pool
        chunk = (len(locations) + workers - 1) // workers
        parts = [locations[i : i + chunk] for i in range(0, len(locations), chunk)]
        futs = [
            pool.submit(lambda ls=ls: [self._with_checksum(loc) for loc in ls])
            for ls in parts
        ]
        out: List[PartitionLocation] = []
        for f in futs:
            out.extend(f.result())
        return out

    def publish_partition_locations(
        self,
        shuffle_id: int,
        partition_id: int,
        locations: List[PartitionLocation],
        num_map_outputs: int = 0,
        meta_epoch: int = 0,
    ) -> None:
        if self.conf.resilience_checksums:
            locations = self._checksummed(locations)
        msg = PublishPartitionLocationsMsg(
            shuffle_id,
            partition_id,
            locations,
            num_map_outputs=num_map_outputs,
            trace_id=self.tracer.trace_for(shuffle_id),
            meta_epoch=meta_epoch,
        )
        self.registry.counter("writer.publishes", role=self.executor_id).inc()
        self.registry.counter("writer.locations_published", role=self.executor_id).inc(
            len(locations)
        )
        if self.is_driver:
            self._handle_publish(msg)
            return
        assert self.node is not None
        with self.tracer.span(
            "shuffle.publish", shuffle_id=shuffle_id, locations=len(locations)
        ) as sp:
            if sp is not None:
                # the driver's publish record follows this span: the
                # executor→driver leg of the cross-role critical path
                msg.origin_span = sp.span_id
            ch = self.node.get_channel(self.conf.driver_host, self.conf.driver_port)
            ch.send_in_queue(FnListener(), msg.to_segments(self.conf.recv_wr_size))

    def metastore_crash(self) -> int:
        """Driver: model hub death (the ``driver:kill`` fault). Every
        registry entry, barrier count, ownership claim, and parked
        replica is gone; leases re-grant under bumped epochs and the
        generation advances. What survives — registered handles,
        deferred fetches, the lost-executor set — is exactly what a
        restarted hub process re-derives from its own job state.
        Returns the new generation; re-adoption sweeps
        (:meth:`republish_for_readoption`) must carry it."""
        assert self.is_driver and self.metastore is not None
        journal_emit("driver.kill", role=self.executor_id)
        generation = self.metastore.wipe()
        with self._lock:
            self._maps_done.clear()
            self._maps_by_exec.clear()
            self._map_owner.clear()
            self._replica_locations.clear()
            self._publish_origins.clear()
        logger.warning(
            "metastore wiped (driver crash); generation now %d", generation
        )
        return generation

    def republish_for_readoption(self, meta_epoch: int = 0) -> int:
        """Executor: re-publish every committed map output (and every
        parked replica) so a wiped hub re-adopts authoritative state —
        a re-publish sweep, never a recompute. Locations rebuild from
        the writer-committed files (committed_map_locations) plus the
        replica registry's lineage tags; ``meta_epoch`` fences the
        sweep against a takeover that started after it. Returns how
        many map publishes were sent."""
        if self.node is None:
            return 0  # never wrote anything: nothing to re-adopt
        count = 0
        for shuffle_id in self.resolver.shuffle_ids():
            data = self.resolver.get_shuffle_data(shuffle_id)
            fn = getattr(data, "committed_map_locations", None)
            if fn is None:
                continue
            for _map_id, locs in sorted(fn(self.local_manager_id).items()):
                self.publish_partition_locations(
                    shuffle_id, -1, locs,
                    num_map_outputs=1, meta_epoch=meta_epoch,
                )
                count += 1
        if self.replica_store is not None:
            count += self.replica_store.republish(meta_epoch)
        return count

    def fetch_remote_partition_locations(
        self, shuffle_id: int, start_partition: int, end_partition: int
    ) -> Future:
        """Async fetch; resolves to List[PartitionLocation] (:376-420)."""
        future: Future = Future()
        key = (shuffle_id, start_partition)
        with self._lock:
            self._fetch_futures[key] = future
            self._fetch_acc.pop(key, None)
        msg = FetchPartitionLocationsMsg(
            self.local_manager_id,
            shuffle_id,
            start_partition,
            end_partition,
            trace_id=self.tracer.trace_for(shuffle_id),
        )
        assert self.node is not None

        def on_fail(e: Exception) -> None:
            with self._lock:
                pending = self._fetch_futures.pop(key, None)
            if pending is not None and not pending.done():
                pending.set_exception(e)

        try:
            # the request span's handle rides the frame so the driver's
            # resolve span follows it (request→resolve causal leg)
            with self.tracer.span(
                "shuffle.fetch_request",
                shuffle_id=shuffle_id,
                partitions=f"{start_partition}:{end_partition}",
            ) as sp:
                if sp is not None:
                    msg.origin_span = sp.span_id
                ch = self.node.get_channel(
                    self.conf.driver_host, self.conf.driver_port
                )
                ch.send_in_queue(
                    FnListener(None, on_fail),
                    msg.to_segments(self.conf.recv_wr_size),
                )
        except IOError as e:
            on_fail(e)
        return future

    # ------------------------------------------------------------------
    # shuffle SPI (reference :187-330)
    # ------------------------------------------------------------------
    def register_shuffle(self, handle) -> BaseShuffleHandle:
        """Driver-only: build the per-partition location registry (:187-239).

        Returns the canonical handle the engine must pass to
        ``get_writer``/``get_reader`` — a foreign engine's duck-typed
        handle (``shuffle_id``, ``num_maps``, ``partitioner`` with
        ``num_partitions`` + ``partition(key)``) is adapted here, the
        same place the reference chooses its own handle class
        (RdmaShuffleManager.scala:231-238)."""
        assert self.is_driver, "register_shuffle must run on the driver"
        if not isinstance(handle, BaseShuffleHandle):
            extra = {}
            serializer = getattr(handle, "serializer", None)
            if serializer is not None:
                extra["serializer"] = serializer
            handle = BaseShuffleHandle(
                shuffle_id=handle.shuffle_id,
                num_maps=handle.num_maps,
                partitioner=handle.partitioner,
                aggregator=getattr(handle, "aggregator", None),
                map_side_combine=bool(getattr(handle, "map_side_combine", False)),
                key_ordering=bool(getattr(handle, "key_ordering", False)),
                **extra,
            )
        with self._lock:
            self._registered[handle.shuffle_id] = handle
        assert self.metastore is not None
        self.metastore.ensure_shuffle(handle.shuffle_id, handle.num_partitions)
        # mint the shuffle's trace id; it rides every Publish/Fetch frame
        # touching this shuffle so spans correlate across roles
        trace_id = mint_trace_id()
        self.tracer.bind_shuffle(handle.shuffle_id, trace_id)
        with self.tracer.span(
            "shuffle.register",
            shuffle_id=handle.shuffle_id,
            num_maps=handle.num_maps,
            num_partitions=handle.num_partitions,
        ):
            pass
        return handle

    def get_writer(self, handle: BaseShuffleHandle, map_id: int):
        """A record writer for one map task: ``shuffle/writer/*``, which
        the port brings with ROADMAP item M4."""
        raise NotImplementedError(
            "shuffle writers come to the port with ROADMAP item M4; "
            "publish device blocks through DeviceShuffleIO"
        )

    def get_reader(self, handle: BaseShuffleHandle, start_partition: int, end_partition: int):
        """A record reader for one reduce range: ``shuffle/reader/*``,
        which the port brings with ROADMAP item M4."""
        raise NotImplementedError(
            "shuffle readers come to the port with ROADMAP item M4; "
            "fetch device blocks through DeviceShuffleIO"
        )

    @property
    def map_pool(self):
        """This executor's bounded map-task pool (lazy; size = conf
        ``map.parallelism``). Map dispatch layers (engine/context,
        engine/worker) submit map tasks here so per-executor map
        concurrency is a config knob, not a scheduler accident.

        With tenancy enabled the pool dispatches deficit-round-robin
        per tenant (FairShareExecutor) instead of FIFO. Creation and
        the stop() swap share ``_lock`` and creation re-checks
        ``_stopped`` — a lazy create racing close() can neither leak a
        live pool past shutdown nor hand one out (post-close access
        raises instead)."""
        with self._lock:
            if self._stopped:
                raise RuntimeError(
                    f"manager {self.executor_id} is stopped; map_pool is gone"
                )
            if self._map_pool is None:
                if self.conf.tenancy_enabled:
                    self._map_pool = FairShareExecutor(
                        max_workers=self.conf.map_parallelism,
                        weights=self.conf.tenancy_weights,
                        default_weight=self.conf.tenancy_default_weight,
                        quantum_ms=self.conf.tenancy_quantum_ms,
                        thread_name_prefix=f"map-{self.executor_id}",
                        pool=f"map-{self.executor_id}",
                    )
                else:
                    self._map_pool = ThreadPoolExecutor(
                        max_workers=self.conf.map_parallelism,
                        thread_name_prefix=f"map-{self.executor_id}",
                    )
            return self._map_pool

    def finalize_maps(self, shuffle_id: int) -> None:
        """Map-stage barrier hook: chunked-agg data publishes here. The
        port has no writer-backed shuffle data until ROADMAP item M4, so
        there is nothing to finalize."""

    def known_executor_ids(self) -> List[str]:
        """Executor ids this manager can name as push destinations:
        announced membership plus itself (executors only — the driver
        never reduces)."""
        with self._lock:
            ids = {m.executor_id for m in self._known_managers}
            ids.update(self._manager_ids.keys())
        if not self.is_driver:
            ids.add(self.executor_id)
        return sorted(ids)

    def map_owners(self, shuffle_id: int) -> Dict[int, str]:
        """Driver: snapshot of first-finisher map ownership (elastic
        layer): map_id -> executor_id of the publish that won. Maps
        whose owner died uncovered are absent — exactly the set a
        partial stage recompute must re-run."""
        with self._shuffle_lock(shuffle_id):
            with self._lock:
                return dict(self._map_owner.get(shuffle_id, {}))

    def unaccounted_maps(self, shuffle_id: int, map_ids) -> List[int]:
        """Driver: the subset of ``map_ids`` with no surviving owner —
        neither the original publish nor a promoted replica covers
        them, so lineage recompute must re-run them."""
        owners = self.map_owners(shuffle_id)
        return sorted(m for m in map_ids if m not in owners)

    def partition_sizes(self, shuffle_id: int) -> Dict[int, int]:
        """Driver: published per-partition byte totals (original
        locations only — merged segments re-cover the same bytes). The
        adaptive partition planner's input; prefers the telemetry
        hub's running totals, falls back to the location registry."""
        if self.telemetry is not None:
            sizes = self.telemetry.partition_bytes(shuffle_id)
            if sizes:
                return sizes
        out: Dict[int, int] = {}
        with self._shuffle_lock(shuffle_id):
            shuffle = (
                self.metastore.entries_for_shuffle(shuffle_id)
                if self.metastore is not None else {}
            )
            for pid, locs in shuffle.items():
                out[pid] = sum(
                    loc.block.length
                    for loc in locs
                    if not loc.block.merged_cover
                )
        return out

    def partition_lane_sizes(self, shuffle_id: int) -> Dict[str, Dict[int, int]]:
        """Driver: the same byte totals split by SOURCE executor
        (source -> pid -> bytes) — the planner's DMA-lane signal for
        lane-balanced reduce cuts (shuffle/planner.py). Telemetry-fed;
        empty when no telemetry hub runs (static/total-bytes planning
        proceeds unchanged)."""
        if self.telemetry is not None:
            return self.telemetry.partition_lane_bytes(shuffle_id)
        return {}

    def unregister_shuffle(self, shuffle_id: int) -> None:
        if self.merge_endpoint is not None:
            self.merge_endpoint.drop_shuffle(shuffle_id)
        if self.replica_store is not None:
            self.replica_store.drop_shuffle(shuffle_id)
        if self.telemetry is not None:
            self.telemetry.drop_partition_bytes(shuffle_id)
        self.resolver.remove_shuffle(shuffle_id)
        if self.metastore is not None:
            self.metastore.drop_shuffle(shuffle_id)
        with self._lock:
            self._registered.pop(shuffle_id, None)
            self._maps_done.pop(shuffle_id, None)
            self._deferred_fetches.pop(shuffle_id, None)
            self._maps_by_exec.pop(shuffle_id, None)
            self._map_owner.pop(shuffle_id, None)
            self._replica_locations.pop(shuffle_id, None)
            self._publish_origins.pop(shuffle_id, None)
            self._shuffle_locks.pop(shuffle_id, None)

    # ------------------------------------------------------------------
    def get_channel_to(self, mid: ShuffleManagerId, purpose: str = "rpc"):
        assert self.node is not None
        return self.node.get_channel(mid.host, mid.port, purpose=purpose)

    @property
    def buffer_manager(self):
        assert self.node is not None
        return self.node.buffer_manager

    def metrics_snapshot(self) -> dict:
        """One live observability dict for this manager.

        The reference scatters its observability across shutdown logs
        (pool stats RdmaBufferManager.java:131-141, fetch histograms
        RdmaShuffleReaderStats.scala:48-75) — here the same counters
        are queryable mid-run so workload artifacts can record them
        (benchmarks/run_workloads.py writes one per e2e run)."""
        snap: dict = {
            "executor_id": self.executor_id,
            "is_driver": self.is_driver,
        }
        node = self.node
        if node is not None:
            snap["transport"] = type(node).__name__
            snap["registered_pool_allocs_by_class"] = {
                str(k): v for k, v in node.buffer_manager.stats().items()
            }
            rps = getattr(node, "read_path_stats", None)
            if rps is not None:
                fast, streamed = rps()
                snap["reads_samehost_fast_path"] = fast
                snap["reads_streamed"] = streamed
        if self.reader_stats is not None:
            snap["fetch_latency_histograms"] = self.reader_stats.snapshot()
        # read-path ShuffleMetrics aggregated over every reader this
        # manager created (live + finished)
        agg = {
            "local_blocks": 0,
            "remote_blocks": 0,
            "local_bytes": 0,
            "remote_bytes": 0,
            "fetch_wait_ms": 0,
            "records_read": 0,
            "sort_spills": 0,
        }
        with self._lock:
            readers = list(self._reader_metrics)
        for m in readers:
            for k in agg:
                agg[k] += getattr(m, k, 0)
        snap["shuffle_read"] = agg
        # circuit-breaker states per tracked remote peer (resilience)
        snap["source_health"] = self.health.states()
        if self.telemetry is not None:
            snap["telemetry"] = self.telemetry.summary()
            snap["slo"] = self.telemetry.slo.summary()
        # the unified registry view: every instrument whose labels are
        # compatible with this manager's role (process-global metrics
        # without a role label are included)
        snap["registry"] = self.registry.snapshot(match={"role": self.executor_id})
        return snap

    def stop(self) -> None:
        with self._lock:
            if self._stopped:
                return
            self._stopped = True
            map_pool, self._map_pool = self._map_pool, None
            ck_pool, self._ck_pool = self._ck_pool, None
        if self.admission is not None:
            self.admission.close()  # queued jobs raise AdmissionClosed
        if map_pool is not None:
            map_pool.shutdown(wait=True)
        if ck_pool is not None:
            ck_pool.shutdown(wait=True)
        if self.telemetry is not None:
            self.telemetry.stop()
        if self.reader_stats is not None:
            self.reader_stats.print_stats()
        self.resolver.stop()
        if self.node is not None:
            self.node.stop()
