"""ClusterContext — real multi-process map/shuffle/reduce jobs.

The in-process :class:`~sparkrdma_tpu_torch.engine.context.TpuContext` runs
executors as threads; this runs them as genuine OS processes (the
reference's one-endpoint-per-JVM topology, SURVEY.md §1): the driver
process owns the metadata-hub manager, each executor subprocess owns a
full transport endpoint, map outputs stage in the *executor's*
registered memory, and reducers pull them executor-to-executor with
one-sided READs — the driver never touches data.

Closures ship via cloudpickle over a tiny task protocol
(`engine/worker.py`); the shuffle itself rides the framework's own
control + data planes (python or native transport per conf).

Elastic behavior (docs/DESIGN.md §21): the driver survives executor
loss. Map and reduce phases both run under a bounded recovery loop —
when a worker process dies, the driver prunes it (``_on_peer_lost``
promotes any replicas), re-runs exactly the *unaccounted* maps (those
neither a surviving publish nor a promoted replica covers) on
survivors, and re-issues the dead worker's reduce ranges. The reduce
fan-out itself is the speculative phase from elastic/speculation.py:
straggler-flagged attempts get cloned, first finisher wins.

A copy of the JAX package's ``engine/cluster.py``, its imports rewritten
to this package: it spawns this package's worker (``python -m
sparkrdma_tpu_torch.engine.worker``), so the children need this package
on their ``sys.path`` (the driver's working directory, or
``PYTHONPATH``). With ``obs.telemetry.enabled`` (the default) a poll
thread drains each worker's heartbeat outbox into the driver's
``TelemetryHub``; the driver's breakdown covers the driver's own spans,
as in JAX. The ``driver:kill`` rig waits for the finished maps'
publishes before it wipes the hub, as ``TpuContext``'s does
(``engine/context.py`` ``await_published_maps``; the JAX rig lacks the
wait).
"""

from __future__ import annotations

import json
import logging
import socket
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Sequence

from sparkrdma_tpu_torch import tenancy
from sparkrdma_tpu_torch.engine.context import await_published_maps
from sparkrdma_tpu_torch.engine.worker import _recv_obj, _send_obj
from sparkrdma_tpu_torch.testing import faults as _faults
from sparkrdma_tpu_torch.obs.profiler import acquire_profiler, release_profiler
from sparkrdma_tpu_torch.shuffle.handle import BaseShuffleHandle, HashPartitioner, Partitioner
from sparkrdma_tpu_torch.shuffle.manager import TpuShuffleManager
from sparkrdma_tpu_torch.utils.config import TpuShuffleConf

logger = logging.getLogger(__name__)


class WorkerHandle:
    def __init__(self, proc: subprocess.Popen, executor_id: str, task_port: int):
        self.proc = proc
        self.executor_id = executor_id
        self.task_port = task_port

    def request(self, obj, timeout_s: float = 120.0):
        with socket.create_connection(("127.0.0.1", self.task_port), timeout=timeout_s) as s:
            s.settimeout(timeout_s)
            _send_obj(s, obj)
            resp = _recv_obj(s)
        if not resp.get("ok"):
            raise RuntimeError(
                f"task failed on {self.executor_id}: {resp.get('error')}\n"
                f"{resp.get('traceback', '')}"
            )
        return resp.get("result")


class ClusterContext:
    """Driver-side handle to a multi-process executor cluster."""

    def __init__(
        self,
        num_executors: int = 2,
        conf: Optional[TpuShuffleConf] = None,
        start_timeout_s: float = 30.0,
    ):
        self.conf = conf or TpuShuffleConf()
        self.driver = TpuShuffleManager(self.conf, is_driver=True)
        self.workers: List[WorkerHandle] = []
        self._shuffle_counter = 0
        self._lock = threading.Lock()
        self._pool = ThreadPoolExecutor(max_workers=max(4, num_executors * 2))
        # last finished job's critical-path verdict (obs/attr.py)
        self.last_breakdown = None
        # driver-process sampler: workers run their own (engine/worker.py)
        # and ship tables in heartbeats; the driver's feeds gap-frame
        # annotation and is folded into the hub by the poll loop below
        self.profiler = acquire_profiler(self.conf, role="driver")

        conf_json = json.dumps(self.conf.to_dict())  # includes driverPort
        for i in range(num_executors):
            executor_id = f"proc-exec-{i}"
            proc = subprocess.Popen(
                [
                    sys.executable, "-m", "sparkrdma_tpu_torch.engine.worker",
                    "--executor-id", executor_id,
                    "--conf", conf_json,
                ],
                stdout=subprocess.PIPE,
                stderr=subprocess.DEVNULL,
                text=True,
            )
            port = self._await_port(proc, start_timeout_s)
            self.workers.append(WorkerHandle(proc, executor_id, port))
        # liveness check
        for w in self.workers:
            assert w.request({"kind": "ping"}) == "pong"

        # telemetry pull loop: drain each worker's heartbeat outbox over
        # the task protocol and fold it into the driver hub. A worker
        # that fails a poll is skipped this round (its gap shows up as a
        # missed heartbeat), never a job failure.
        self._telemetry_stop = threading.Event()
        self._telemetry_thread: Optional[threading.Thread] = None
        if self.driver.telemetry is not None:
            self._telemetry_thread = threading.Thread(
                target=self._poll_telemetry, name="telemetry-poll", daemon=True
            )
            self._telemetry_thread.start()

    @staticmethod
    def _await_port(proc: subprocess.Popen, timeout_s: float) -> int:
        deadline = time.monotonic() + timeout_s
        assert proc.stdout is not None
        while time.monotonic() < deadline:
            line = proc.stdout.readline()
            if not line:
                raise RuntimeError("worker exited before announcing its port")
            if line.startswith("WORKER_PORT "):
                return int(line.split()[1])
        raise TimeoutError("worker did not announce its task port in time")

    def _poll_telemetry(self) -> None:
        hub = self.driver.telemetry
        interval_s = hub.interval_ms / 1000.0
        while not self._telemetry_stop.wait(interval_s):
            for w in list(self.workers):
                try:
                    payloads = w.request({"kind": "telemetry"}, timeout_s=10.0)
                except Exception:
                    logger.debug("telemetry poll of %s failed", w.executor_id,
                                 exc_info=True)
                    continue
                for p in payloads or []:
                    hub.ingest(p)
            # the driver's own profile table joins the cluster merge
            hub.profiles.ingest_local(self.profiler, "driver")
            hub.check_missed()

    def _next_shuffle_id(self) -> int:
        with self._lock:
            self._shuffle_counter += 1
            return self._shuffle_counter

    # ------------------------------------------------------------------
    def run_map_reduce(
        self,
        map_fns: Sequence[Callable[[], "object"]],
        num_partitions: int,
        reduce_fn: Optional[Callable] = None,
        partitioner: Optional[Partitioner] = None,
        tenant: Optional[str] = None,
    ) -> List:
        """One full distributed job: every ``map_fns[i]`` runs on a
        worker process and yields (k, v) records; records repartition by
        key across all workers; ``reduce_fn(iterator)`` runs per
        partition range on its worker. Returns the per-worker reduce
        results in worker order.

        ``tenant`` rides every task request so the workers' fair-share
        pools, quotas, and breaker keys attribute the job correctly;
        the driver's admission controller brackets the whole job."""
        t = tenant or tenancy.current_tenant()
        handle = BaseShuffleHandle(
            shuffle_id=self._next_shuffle_id(),
            num_maps=len(map_fns),
            partitioner=partitioner or HashPartitioner(num_partitions),
        )
        self.driver.register_shuffle(handle)
        admission = self.driver.admission
        jsp = None
        try:
            with tenancy.tenant_scope(t):
                # the job span bounds the critical-path window
                # (obs/critpath.py) for the driver-visible spans
                with self.driver.tracer.span(
                    "job.run", shuffle_id=handle.shuffle_id, tenant=t
                ) as jsp:
                    if admission is None:
                        out = self._run_map_reduce(
                            handle, map_fns, num_partitions, reduce_fn, t
                        )
                    else:
                        with admission.admit(t):
                            out = self._run_map_reduce(
                                handle, map_fns, num_partitions, reduce_fn, t
                            )
            self._attribute_job(jsp)
            return out
        except Exception as e:
            if self.driver.telemetry is not None:
                bd = self._attribute_job(jsp)
                self.driver.telemetry.flight_record(
                    "job_failed", error=e,
                    breakdown=bd.to_dict() if bd is not None else None,
                )
            raise

    def _attribute_job(self, job_span):
        """Best-effort per-job TimeBreakdown (obs/critpath.py) over the
        driver-process spans; kept as ``self.last_breakdown``."""
        if job_span is None or not self.conf.critpath_enabled:
            return None
        try:
            from sparkrdma_tpu_torch.obs.critpath import job_breakdown

            self.last_breakdown = job_breakdown(job_span, role="driver")
            if self.driver.telemetry is not None:
                self.driver.telemetry.note_breakdown(
                    self.last_breakdown.to_dict()
                )
            return self.last_breakdown
        except Exception:
            logger.exception("critical-path attribution failed")
            return None

    def _run_map_reduce(self, handle, map_fns, num_partitions, reduce_fn, tenant):
        items = list(enumerate(map_fns))
        self._run_map_phase(handle, items, tenant, recompute=False)
        bounds = self._plan_bounds(handle, num_partitions)
        return self._run_reduce_phase(handle, bounds, reduce_fn, tenant, items)

    # -- elastic plumbing ----------------------------------------------
    def _live_workers(self) -> List[WorkerHandle]:
        return [w for w in self.workers if w.proc.poll() is None]

    def _reap_dead(self) -> List[WorkerHandle]:
        """Detect dead worker processes and prune them everywhere: the
        driver's location registry (which promotes any replicas the
        dead executor's maps left behind) and this context's dispatch
        set. Idempotent per worker."""
        dead = [w for w in self.workers if w.proc.poll() is not None]
        for w in dead:
            logger.warning(
                "executor %s died (exit %s); pruning and promoting replicas",
                w.executor_id, w.proc.poll(),
            )
            self.driver._on_peer_lost(w.executor_id)
            self.workers.remove(w)
        return dead

    def _run_map_phase(self, handle, items, tenant, recompute: bool) -> None:
        """Run every map task to an *accounted* publish, surviving
        executor loss. Each round ships the still-unaccounted maps as
        one map_batch per live worker (one socket round trip, bounded
        worker-side concurrency) and finalizes; a round that lost
        executors re-runs exactly ``driver.unaccounted_maps`` — maps a
        surviving publish or a promoted replica covers are never
        recomputed. Recovery rounds are bounded by
        ``elastic.maxRecoveries``.

        ``recompute=True`` (the reduce phase's recovery call) makes the
        first round count as lineage recompute too; when replicas
        already cover every map it is a no-op.

        Accounting has two tiers: the wrapper writer publishes with
        per-map lineage tags, so ``driver.map_owners`` is authoritative
        (and replica promotion keeps covered maps owned); the
        chunked-agg writer publishes whole-executor aggregates with no
        per-map attribution, so for it "accounted" falls back to
        "batch succeeded and its executor is still alive" — and
        executor loss is only recoverable under the wrapper method
        (re-publishing an aggregate writer's maps piecemeal could
        double-count surviving data)."""
        sid = handle.shuffle_id
        fns = dict(items)
        all_ids = [mid for mid, _ in items]
        # batch-success accounting for writers without lineage tags
        assigned: Dict[int, str] = {}

        def unaccounted() -> List[int]:
            owners = self.driver.map_owners(sid)
            return [
                mid for mid in all_ids
                if mid not in owners and mid not in assigned
            ]

        pending = unaccounted()
        if recompute:
            if not pending:
                return  # promoted replicas cover everything: zero recompute
            self._note_recompute(len(pending))
        recoveries = 0
        while True:
            if not pending:
                return
            workers = self._live_workers()
            if not workers:
                raise RuntimeError("no live executors left for map stage")
            # push + replica routes: where each executor reaches its
            # peers' task servers (shuffle/merge.py, elastic/)
            routes = {
                w.executor_id: ("127.0.0.1", w.task_port) for w in workers
            }
            by_worker: Dict[WorkerHandle, List] = {}
            for j, mid in enumerate(pending):
                by_worker.setdefault(workers[j % len(workers)], []).append(
                    (mid, fns[mid])
                )
            futures = {
                w: self._pool.submit(
                    w.request,
                    {
                        "kind": "map_batch",
                        "handle": handle,
                        "tasks": tasks,
                        "push_routes": routes,
                        "tenant": tenant,
                    },
                )
                for w, tasks in by_worker.items()
            }
            errors: List[Exception] = []
            for w, f in futures.items():
                try:
                    f.result()
                except Exception as e:
                    errors.append(e)
                else:
                    for mid, _fn in by_worker[w]:
                        assigned[mid] = w.executor_id
            for w in workers:  # every live worker, not just batch targets
                if w.proc.poll() is not None:
                    continue
                try:
                    w.request({"kind": "finalize", "shuffle_id": sid})
                except Exception as e:
                    errors.append(e)
            dead = self._reap_dead()
            dead_ids = {w.executor_id for w in dead}
            if dead_ids:
                for mid, eid in list(assigned.items()):
                    if eid in dead_ids:
                        del assigned[mid]
            pending = unaccounted()
            if not pending and not errors:
                return
            if errors and not dead:
                # a genuine task failure (not executor loss) is the
                # job's failure — recompute can't fix a deterministic
                # exception
                raise errors[0]
            if not dead and pending:
                raise RuntimeError(
                    f"maps {pending} unaccounted with all executors live"
                )
            if dead and not self._elastic_recovery_ok():
                raise errors[0] if errors else RuntimeError(
                    f"executors {sorted(dead_ids)} lost and the "
                    "chunked-agg writer cannot recompute piecemeal"
                )
            if recoveries >= self.conf.elastic_max_recoveries:
                raise errors[0] if errors else RuntimeError(
                    f"maps {pending} still unaccounted after "
                    f"{recoveries} recoveries"
                )
            recoveries += 1
            self._note_recompute(len(pending))
            logger.warning(
                "map recovery %d: re-running %d unaccounted maps %s on "
                "%d survivors", recoveries, len(pending), pending,
                len(self._live_workers()),
            )

    def _driver_failover(self) -> None:
        """Control-plane HA chaos rig (the ``driver:kill`` fault): the
        metadata hub dies mid-job and recovers by RE-PUBLISH, never
        recompute. Three rungs (docs/RESILIENCE.md "Control-plane HA"):

        1. wipe — every registry entry, barrier count, ownership claim,
           and parked replica is gone; leases re-grant under bumped
           epochs and the generation advances;
        2. re-adoption sweep — every live executor re-publishes its
           committed map outputs (rebuilt from the writer-committed
           files) and parked replicas (lineage tags intact), fenced by
           the new generation so a stale sweep can never merge in;
        3. re-promotion — executors that died BEFORE the crash get
           their loss replayed, so their re-parked replicas promote
           again instead of recomputing."""
        from sparkrdma_tpu_torch.obs import get_registry

        t0 = time.perf_counter()
        # the workers' publishes of the finished maps handled first, as
        # in-process (engine/context.py await_published_maps)
        await_published_maps(self.driver)
        generation = self.driver.metastore_crash()
        for w in self._live_workers():
            try:
                w.request({"kind": "republish", "meta_epoch": generation})
            except Exception:
                logger.warning(
                    "re-adoption sweep on %s failed", w.executor_id,
                    exc_info=True,
                )
        with self.driver._lock:
            lost = sorted(self.driver._lost_executors)
        for exec_id in lost:
            self.driver._on_peer_lost(exec_id)
        get_registry().histogram(
            "metastore.readoption_ms", role=self.driver.executor_id
        ).observe((time.perf_counter() - t0) * 1e3)
        logger.warning(
            "driver failover complete: generation %d, %d pre-crash losses "
            "replayed", generation, len(lost),
        )

    def _elastic_recovery_ok(self) -> bool:
        """Executor-loss recovery needs per-map lineage tags on the
        published locations — only the wrapper writer provides them."""
        from sparkrdma_tpu_torch.utils.config import ShuffleWriterMethod

        return self.conf.shuffle_writer_method == ShuffleWriterMethod.WRAPPER

    def _note_recompute(self, num_maps: int) -> None:
        from sparkrdma_tpu_torch.obs import get_registry

        reg = get_registry()
        reg.counter("engine.stage_recomputes").inc()
        reg.counter(
            "elastic.recoveries", role=self.driver.executor_id
        ).inc()
        reg.counter(
            "elastic.recomputed_maps", role=self.driver.executor_id
        ).inc(num_maps)

    def _plan_bounds(self, handle, num_partitions) -> List:
        """Split the partition range across live workers: contiguous
        static bounds, re-planned from the published per-partition
        sizes by the adaptive partitioner when enabled
        (shuffle/planner.py) so a hot partition's worker is not also
        loaded with its neighbors."""
        n = len(self._live_workers())
        bounds = [
            (w * num_partitions // n, (w + 1) * num_partitions // n)
            for w in range(n)
        ]
        if self.conf.planner_enabled:
            from sparkrdma_tpu_torch.shuffle.planner import AdaptivePartitioner

            size_map = self.driver.partition_sizes(handle.shuffle_id)
            sizes = [size_map.get(p, 0) for p in range(num_partitions)]
            if any(sizes):
                lane_sizes = None
                if self.conf.collective_lane_balance:
                    # per-source lanes: cuts balance DMA-lane occupancy
                    # (the collective schedule's wave wall), not just
                    # byte totals
                    lanes = self.driver.partition_lane_sizes(
                        handle.shuffle_id
                    )
                    if len(lanes) > 1:
                        lane_sizes = {
                            src: [per.get(p, 0) for p in range(num_partitions)]
                            for src, per in lanes.items()
                        }
                ranges = AdaptivePartitioner(self.conf).plan(
                    sizes, n, lane_sizes=lane_sizes
                )
                # pad with empty ranges so every worker keeps a slot
                bounds = ranges + [
                    (num_partitions, num_partitions)
                ] * (n - len(ranges))
        return bounds

    def _run_reduce_phase(self, handle, bounds, reduce_fn, tenant, items):
        """Reduce fan-out with speculation and executor-loss recovery.

        Ranges are fixed up front (results must align regardless of
        later deaths); each round runs the outstanding ranges through a
        :class:`SpeculativeReducePhase`. Ranges whose every attempt
        failed trigger recovery when the failure was an executor death:
        prune + promote, re-run unaccounted maps, then re-issue just
        the failed ranges on survivors."""
        from sparkrdma_tpu_torch.elastic.speculation import SpeculativeReducePhase

        # driver-death seam: the hub dies between map and reduce — the
        # worst moment, every barrier complete, nothing fetched yet.
        # The failover ladder must leave the reduce phase able to
        # resolve every location it would have seen (chaos bar:
        # byte-identical results, metastore.adoptions > 0)
        plan = _faults.active()
        if plan is not None and plan.on_driver(stage="reduce_phase"):
            self._driver_failover()
        workers = self._live_workers()
        assignments = [
            (i, rng, workers[i]) for i, rng in enumerate(bounds) if rng[1] > rng[0]
        ]
        rng_by_idx = {idx: rng for idx, rng, _ in assignments}
        results: Dict[int, object] = {}
        todo = assignments
        recoveries = 0
        while todo:
            phase = SpeculativeReducePhase(
                self.driver, self._pool, self.conf, self._live_workers,
                handle, reduce_fn, tenant,
            )
            done, failed = phase.run(todo)
            results.update(done)
            if not failed:
                break
            dead = self._reap_dead()
            if (
                not dead
                or not self._elastic_recovery_ok()
                or recoveries >= self.conf.elastic_max_recoveries
            ):
                raise next(iter(failed.values()))
            recoveries += 1
            # re-run the maps the dead executors took with them, then
            # re-issue only the failed ranges on survivors (fresh
            # locations resolve on fetch)
            self._run_map_phase(handle, items, tenant, recompute=True)
            survivors = self._live_workers()
            if not survivors:
                raise RuntimeError("no live executors left for reduce stage")
            todo = [
                (idx, rng_by_idx[idx], survivors[k % len(survivors)])
                for k, idx in enumerate(sorted(failed))
            ]
        return [results[idx] for idx, _rng, _w in assignments]

    # ------------------------------------------------------------------
    def stop(self) -> None:
        self._telemetry_stop.set()
        if self._telemetry_thread is not None:
            self._telemetry_thread.join(timeout=5)
            self._telemetry_thread = None
        for w in self.workers:
            try:
                w.request({"kind": "stop"}, timeout_s=5.0)
            except Exception:
                pass
        for w in self.workers:
            try:
                w.proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                w.proc.kill()
        self._pool.shutdown(wait=False)
        release_profiler(self.profiler)
        self.profiler = None
        self.driver.stop()

    def __enter__(self) -> "ClusterContext":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()
