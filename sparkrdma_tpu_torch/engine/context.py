"""TpuContext — driver + executors + stage scheduler.

The Spark-role host: owns one driver TpuShuffleManager (metadata hub)
and N executor managers (each a full transport endpoint, as in the
reference's process topology — SURVEY.md §1 "Process topology"), cuts
the RDD lineage at shuffle dependencies, runs map stages with a
barrier, and recomputes stages on fetch failure (the reference
delegates recompute to Spark via FetchFailedException;
RdmaShuffleFetcherIterator.scala:381-391).

A copy of the JAX package's ``engine/context.py``, its imports
rewritten to this package. The engine does no tensor work and touches
no device. With ``obs.telemetry.enabled`` (the default) the driver's
``TelemetryHub`` runs (``shuffle/manager.py``): each executor's
heartbeater sends into it, failures leave a flight record, and the
breakdown and SLO summary reach it; attribution (``last_breakdown``)
and the process profiler run as in JAX. One fix the JAX module lacks:
the ``driver:kill`` rig waits for the finished maps' publishes before
it wipes the hub (:func:`await_published_maps`), where the JAX rig can
count a map twice and lose another's records.
"""

from __future__ import annotations

import logging
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

from sparkrdma_tpu_torch.engine.rdd import (
    GeneratorRDD,
    ParallelCollectionRDD,
    RDD,
    ShuffledRDD,
)
from sparkrdma_tpu_torch.obs.metrics import get_registry
from sparkrdma_tpu_torch.obs.profiler import acquire_profiler, release_profiler
from sparkrdma_tpu_torch.obs.telemetry import Heartbeater
from sparkrdma_tpu_torch.shuffle.errors import ShuffleError
from sparkrdma_tpu_torch.shuffle.handle import BaseShuffleHandle
from sparkrdma_tpu_torch.shuffle.manager import TpuShuffleManager
from sparkrdma_tpu_torch import tenancy
from sparkrdma_tpu_torch.tenancy import FairShareExecutor
from sparkrdma_tpu_torch.testing import faults as _faults
from sparkrdma_tpu_torch.utils.config import TpuShuffleConf

logger = logging.getLogger(__name__)

# bound on the driver:kill rigs' wait for pre-crash publishes (below)
PUBLISH_SETTLE_S = 5.0


def await_published_maps(driver, timeout_s: float = PUBLISH_SETTLE_S) -> List[int]:
    """Wait until the driver's completeness barrier of every registered
    shuffle is full (each map's publish handled), or ``timeout_s``.
    Returns the shuffle ids still short.

    The ``driver:kill`` rigs wipe the hub in process, so its channels
    outlive the simulated crash: a writer publish sent before the wipe
    and handled after it counts toward the new generation's barrier, and
    the re-adoption sweep's publish of the same map counts again. The
    barrier then releases the reducers with another map's locations
    missing, and records are lost without an error (the JAX package's
    rigs keep this race). A real crash drops such a message with its
    connection; the rigs wait it out before they wipe. A shuffle whose
    barrier an executor loss re-armed never fills, and the wait ends at
    the timeout."""
    deadline = time.monotonic() + timeout_s
    while True:
        with driver._lock:
            short = [
                sid for sid, handle in driver._registered.items()
                if driver._maps_done.get(sid, 0) < handle.num_maps
            ]
        if not short or time.monotonic() >= deadline:
            return short
        time.sleep(0.001)


class TpuContext:
    def __init__(
        self,
        num_executors: int = 2,
        conf: Optional[TpuShuffleConf] = None,
        task_threads: int = 4,
    ):
        self.conf = conf or TpuShuffleConf()
        self.driver = TpuShuffleManager(self.conf, is_driver=True)
        self.executors: List[TpuShuffleManager] = [
            TpuShuffleManager(self.conf, is_driver=False, executor_id=f"exec-{i}")
            for i in range(num_executors)
        ]
        # reduce-task pool: deficit-round-robin across tenants when
        # tenancy is on (one tenant's 1000 queued partitions cannot
        # convoy another's 10), plain FIFO otherwise
        if self.conf.tenancy_enabled:
            self._pool = FairShareExecutor(
                max_workers=task_threads,
                weights=self.conf.tenancy_weights,
                default_weight=self.conf.tenancy_default_weight,
                quantum_ms=self.conf.tenancy_quantum_ms,
                thread_name_prefix="reduce",
                pool="reduce",
            )
        else:
            self._pool = ThreadPoolExecutor(max_workers=task_threads)
        self._id_lock = threading.Lock()
        self._rdd_counter = 0
        self._shuffle_counter = 0
        self._stopped = False
        # last finished job's critical-path attribution verdict
        # (obs/attr.py TimeBreakdown), surfaced via metrics_snapshot()
        self.last_breakdown = None
        # continuous profiling (obs/profiler.py): one refcounted sampler
        # for the whole process — the in-process topology shares every
        # thread, so its table rides the FIRST executor's heartbeat
        self.profiler = acquire_profiler(self.conf, role="proc")
        # in-process topology: heartbeats push straight into the driver
        # hub (no control-plane hop); each executor samples its own
        # role-filtered view of the shared process registry
        self.heartbeaters: List[Heartbeater] = []
        if self.driver.telemetry is not None:
            for executor in self.executors:
                self.heartbeaters.append(
                    Heartbeater(
                        get_registry(),
                        executor.executor_id,
                        interval_ms=self.conf.telemetry_interval_ms,
                        send=self.driver.telemetry.ingest,
                        match={"role": executor.executor_id},
                    ).start()
                )
            if self.heartbeaters:
                self.heartbeaters[0].attach_profiler(self.profiler)

    # ------------------------------------------------------------------
    def _next_rdd_id(self) -> int:
        with self._id_lock:
            self._rdd_counter += 1
            return self._rdd_counter

    def _next_shuffle_id(self) -> int:
        with self._id_lock:
            self._shuffle_counter += 1
            return self._shuffle_counter

    def executor_for_partition(self, partition: int) -> TpuShuffleManager:
        return self.executors[partition % len(self.executors)]

    def lose_executor(self, executor_id: str) -> None:
        """Simulate executor death in the in-process topology
        (DESIGN.md §21): drop the executor from the partition router,
        run the driver's peer-loss path — prune, replica promotion,
        barrier re-arm — then release the lost manager's resources
        (a dead process never unpublishes, so the teardown happens
        only AFTER the prune, and quietly).

        With replica coverage (`tpu.shuffle.elastic.replicas` > 0)
        later reads complete against the promoted holders with zero
        recompute; without it they defer into
        MetadataFetchFailedError and ``run_job``'s stage-recompute
        attempt re-runs the lost maps on the survivors."""
        lost = next(
            (m for m in self.executors if m.executor_id == executor_id), None
        )
        if lost is None:
            raise KeyError(f"unknown executor {executor_id!r}")
        if len(self.executors) == 1:
            raise ValueError("cannot lose the last executor")
        self.executors = [m for m in self.executors if m is not lost]
        self.driver._on_peer_lost(lost.executor_id)
        lost.stop()

    def _driver_failover(self) -> None:
        """In-process control-plane HA chaos rig (the ``driver:kill``
        fault): wipe the metadata hub, sweep every live executor's
        committed map outputs and parked replicas back in (fenced by
        the new generation), then replay pre-crash executor losses so
        their re-parked replicas promote again — re-publish, never
        recompute (docs/RESILIENCE.md "Control-plane HA"). The wipe
        waits until every publish of the finished maps was handled
        (:func:`await_published_maps`)."""
        t0 = time.perf_counter()
        await_published_maps(self.driver)
        generation = self.driver.metastore_crash()
        for executor in self.executors:
            executor.republish_for_readoption(generation)
        with self.driver._lock:
            lost = sorted(self.driver._lost_executors)
        for exec_id in lost:
            self.driver._on_peer_lost(exec_id)
        get_registry().histogram(
            "metastore.readoption_ms", role=self.driver.executor_id
        ).observe((time.perf_counter() - t0) * 1e3)
        logger.warning(
            "driver failover complete: generation %d, %d pre-crash "
            "losses replayed", generation, len(lost),
        )

    # ------------------------------------------------------------------
    def parallelize(self, data, num_partitions: int = None) -> RDD:
        n = num_partitions or len(self.executors)
        return ParallelCollectionRDD(self, list(data), n)

    def generate(self, gen, num_partitions: int) -> RDD:
        return GeneratorRDD(self, gen, num_partitions)

    # ------------------------------------------------------------------
    # scheduling
    # ------------------------------------------------------------------
    def ensure_parents(self, rdd: RDD) -> None:
        """Materialize every un-materialized shuffle below rdd."""
        for dep in self._shuffle_deps(rdd):
            if dep.handle is None:
                self._run_map_stage(dep)

    def _shuffle_deps(self, rdd: RDD) -> List[ShuffledRDD]:
        """Direct shuffle dependencies (stage boundary cut)."""
        out: List[ShuffledRDD] = []
        seen = set()

        def walk(r: RDD) -> None:
            if id(r) in seen:
                return
            seen.add(id(r))
            if isinstance(r, ShuffledRDD):
                out.append(r)
                return  # deeper deps handled when r's map stage runs
            for attr in ("parent", "a", "b"):
                child = getattr(r, attr, None)
                if isinstance(child, RDD):
                    walk(child)

        walk(rdd)
        return out

    def _run_map_stage(self, dep: ShuffledRDD, attempts: int = 2) -> None:
        """Run the parent stage of a shuffle with a completion barrier.

        Transient map-task failures retry the whole stage under a fresh
        shuffle id (the failed id is unregistered so its deferred-fetch
        state doesn't linger on the driver).
        """
        parent = dep.parent
        self.ensure_parents(parent)  # recursive stage materialization

        last_error: Optional[Exception] = None
        for attempt in range(attempts):
            shuffle_id = self._next_shuffle_id()
            handle = BaseShuffleHandle(
                shuffle_id=shuffle_id,
                num_maps=parent.num_partitions,
                partitioner=dep.partitioner,
                aggregator=dep.aggregator,
                map_side_combine=dep.map_side_combine,
                key_ordering=dep.key_ordering,
            )
            self.driver.register_shuffle(handle)

            def run_map(map_id: int) -> None:
                executor = self.executor_for_partition(map_id)
                t0 = time.perf_counter()
                plan = _faults.active()
                if plan is not None:
                    plan.on_stage("map_task", [], peer=executor.executor_id)
                try:
                    with executor.tracer.span(
                        "engine.task", kind="map", partition=map_id
                    ):
                        writer = executor.get_writer(handle, map_id)
                        try:
                            writer.write(parent.compute(map_id))
                            writer.stop(True)
                        except Exception:
                            writer.stop(False)
                            raise
                finally:
                    get_registry().histogram(
                        "engine.task_ms", role=executor.executor_id,
                        kind="map", tenant=tenancy.current_tenant(),
                    ).observe((time.perf_counter() - t0) * 1000.0)

            # dispatch each map through ITS executor's bounded map pool
            # (conf map.parallelism) — per-executor concurrency is the
            # config knob, not an artifact of the context's task pool
            futures = [
                self.executor_for_partition(m).map_pool.submit(run_map, m)
                for m in range(parent.num_partitions)
            ]
            errors = [f.exception() for f in futures if f.exception() is not None]
            if not errors:
                for executor in self.executors:
                    executor.finalize_maps(shuffle_id)
                dep.handle = handle
                return
            last_error = errors[0]
            logger.warning(
                "map stage for shuffle %d failed (attempt %d/%d): %s",
                shuffle_id,
                attempt + 1,
                attempts,
                last_error,
            )
            self.driver.unregister_shuffle(shuffle_id)
            for executor in self.executors:
                executor.unregister_shuffle(shuffle_id)
        assert last_error is not None
        raise last_error

    def _partition_weights(self, rdd: RDD) -> Dict[int, int]:
        """Published per-partition byte totals of rdd's direct shuffle
        dependency, when the partition counts line up — the adaptive
        scheduling signal (shuffle/planner.py): the heaviest reduce
        partitions are SUBMITTED first so a hot partition never starts
        last and stretches the stage tail behind the task-pool bound.
        Results still collect in partition order."""
        if not self.conf.planner_enabled:
            return {}
        for dep in self._shuffle_deps(rdd):
            if (
                dep.handle is not None
                and dep.partitioner.num_partitions == rdd.num_partitions
            ):
                sizes = self.driver.partition_sizes(dep.handle.shuffle_id)
                if sizes:
                    return sizes
        return {}

    def run_job(self, rdd: RDD, tenant: Optional[str] = None) -> List:
        """Compute all partitions of rdd; recompute stages on fetch failure.

        ``tenant`` names the job's owner for admission, fair-share
        dispatch, quotas, breaker scoping, and obs labels (defaults to
        the calling thread's tenant scope). Admission brackets the
        WHOLE job including recompute attempts — the in-flight bound
        counts jobs, not stages."""
        t = tenant or tenancy.current_tenant()
        admission = self.driver.admission
        with tenancy.tenant_scope(t):
            if admission is None:
                return self._run_job_admitted(rdd, t)
            with admission.admit(t):
                return self._run_job_admitted(rdd, t)

    def _run_job_admitted(self, rdd: RDD, tenant: str) -> List:
        for attempt in range(2):
            jsp = None
            try:
                # the job span bounds the critical-path window
                # (obs/critpath.py); every map/reduce span of this
                # attempt lands inside it on the shared timeline
                with self.driver.tracer.span(
                    "job.run", tenant=tenant, attempt=attempt
                ) as jsp:
                    self.ensure_parents(rdd)
                    # driver:kill chaos seam (testing/faults.py): the
                    # hub dies between the map barrier and the reduce
                    # fan-out — worst case for metadata loss — and the
                    # job must finish byte-identical via re-adoption
                    plan = _faults.active()
                    if plan is not None and plan.on_driver(
                        stage="reduce_phase"
                    ):
                        self._driver_failover()
                    order = list(range(rdd.num_partitions))
                    weights = self._partition_weights(rdd)
                    if weights:
                        order.sort(key=lambda p: -weights.get(p, 0))

                    def run_reduce(p: int) -> List:
                        t0 = time.perf_counter()
                        try:
                            # task span: keeps the critical path lit
                            # across user compute (obs/attr.py)
                            with self.driver.tracer.span(
                                "engine.task", kind="reduce", partition=p
                            ):
                                return list(rdd.compute(p))
                        finally:
                            get_registry().histogram(
                                "engine.task_ms", role="driver", kind="reduce",
                                tenant=tenancy.current_tenant(),
                            ).observe((time.perf_counter() - t0) * 1000.0)

                    futures = {
                        p: self._pool.submit(run_reduce, p)
                        for p in order
                    }
                    out: List = []
                    errors = []
                    for p in range(rdd.num_partitions):
                        f = futures[p]
                        e = f.exception()
                        if e is not None:
                            errors.append(e)
                        else:
                            out.extend(f.result())
                    if errors:
                        raise errors[0]
                self._attribute_job(jsp)
                return out
            except ShuffleError as e:
                if self.driver.telemetry is not None:
                    # post-mortem artifact BEFORE recompute mutates state
                    bd = self._attribute_job(jsp)
                    self.driver.telemetry.flight_record(
                        "fetch_failed", error=e,
                        breakdown=bd.to_dict() if bd is not None else None,
                    )
                if attempt == 1:
                    raise
                get_registry().counter("engine.stage_recomputes").inc()
                logger.warning("fetch failed (%s); recomputing stages", e)
                # invalidate materialized shuffles below rdd and retry
                for dep in self._shuffle_deps(rdd):
                    dep.handle = None
        raise RuntimeError("unreachable")

    def _attribute_job(self, job_span):
        """Fold the finished (or failed) job span's window into a
        TimeBreakdown (obs/critpath.py). Best-effort: attribution can
        never fail a job. Returns the verdict (also kept as
        ``self.last_breakdown``) or None when gated off."""
        if job_span is None or not self.conf.critpath_enabled:
            return None
        try:
            from sparkrdma_tpu_torch.obs.critpath import job_breakdown

            self.last_breakdown = job_breakdown(job_span, role="driver")
            if self.driver.telemetry is not None:
                # diagnosis evidence: the SLO engine's root-cause pass
                # reads the dominant category from the hub
                self.driver.telemetry.note_breakdown(
                    self.last_breakdown.to_dict()
                )
            return self.last_breakdown
        except Exception:
            logger.exception("critical-path attribution failed")
            return None

    # ------------------------------------------------------------------
    def metrics_snapshot(self) -> Dict[str, dict]:
        """Per-role manager snapshots plus the process-wide registry.

        In this in-process topology every manager shares one registry,
        so ``registry`` is reported once at the top level (the per-role
        entries keep their role-filtered view from
        ``TpuShuffleManager.metrics_snapshot``)."""
        snap: Dict[str, dict] = {
            "driver": self.driver.metrics_snapshot(),
        }
        for executor in self.executors:
            snap[executor.executor_id] = executor.metrics_snapshot()
        snap["registry"] = get_registry().snapshot()
        if self.last_breakdown is not None:
            snap["breakdown"] = self.last_breakdown.to_dict()
        if self.driver.telemetry is not None:
            snap["slo"] = self.driver.telemetry.slo.summary()
        return snap

    def telemetry_flush(self) -> None:
        """Force one heartbeat from every executor NOW (tests/benches:
        deterministic hub state without waiting out the interval)."""
        for hb in self.heartbeaters:
            hb.beat()

    def export_trace(self, path: str) -> dict:
        """Write the Chrome-trace JSON for every role's tracer."""
        from sparkrdma_tpu_torch.obs import export_chrome_trace

        return export_chrome_trace(path)

    def stop(self) -> None:
        if self._stopped:
            return
        self._stopped = True
        self._pool.shutdown(wait=True)
        for hb in self.heartbeaters:
            hb.stop(flush=True)  # final delta lands in the hub
        release_profiler(self.profiler)
        self.profiler = None
        for executor in self.executors:
            executor.stop()
        self.driver.stop()

    def __enter__(self) -> "TpuContext":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()
