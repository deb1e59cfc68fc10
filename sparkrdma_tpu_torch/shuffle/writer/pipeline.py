"""MapTaskPipeline — the pipelined device-accelerated map plane.

WORKLOADS_r05 pinned the e2e TeraSort loss on the map side: a
sequential host-sort -> stage -> publish loop whose 22.95 s wall
exceeded the whole host baseline job. The fix is structural, the same
one the reduce side already uses (fetch/merge overlap, SURVEY §2.3):
run the three map stages as a pipeline over shards,

    sort (device, MapShardSorter)     shard k+1
      -> stage into registered memory  shard k      (writer -> memory/)
        -> publish locations           shard k-1    (driver RPC)

so while shard k stages, shard k+1 sorts on device and shard k-1's
locations upload. Stage concurrency:

- ``parallelism`` sort workers (conf ``map.parallelism``) — the bounded
  map-task pool; sorts are the heavy stage and the device serializes
  them anyway, but extra workers overlap the host-side pad/readback
  halves of adjacent shards,
- one stage worker and one publish worker, fed by bounded queues
  (conf ``map.pipelineDepth``) so at most ``parallelism + depth``
  shards hold staging memory at once.

Abort semantics: the first stage error latches, everything not yet
published drains WITHOUT publishing, and ``run`` re-raises — a map
shard's locations go out atomically (one publish per shard) or not at
all, so an abort can never leave a partial location set for any shard
(the driver's map barrier stays incomplete and fetches keep
deferring).

Observability (docs/OBSERVABILITY.md): per-stage latency histograms
``writer.pipeline.stage_ms{stage=sort|stage|publish}``, the live
``writer.pipeline.inflight`` gauge, and ``writer.pipeline.overlap_ms``
— per-run sum-of-stage-busy minus wall, the measured time the overlap
SAVED (zero means the pipeline degenerated to sequential).

A copy of the JAX package's ``shuffle/writer/pipeline.py``, its imports
rewritten to this package (the lock-order and model-checker calls go to the
port's ``analysis/lockorder.py`` and ``analysis/modelcheck``).
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence

from sparkrdma_tpu_torch import tenancy
from sparkrdma_tpu_torch.analysis.modelcheck import schedule_point
from sparkrdma_tpu_torch.obs import get_registry, get_tracer

STAGES = ("sort", "stage", "publish")

# stage latencies range from sub-ms (publish RPC enqueue) to multi-s
# (device sort of a GiB shard)
_STAGE_BOUNDS = (1, 5, 10, 50, 100, 500, 1000, 5000, 10000, 60000)

_CLOSE = object()  # queue sentinel: producer is done


@dataclass
class PipelineReport:
    """What one ``run`` measured — the ledger's map-plane attribution."""

    wall_s: float
    stage_busy_s: Dict[str, float]
    overlap_s: float
    results: List[Any] = field(default_factory=list)

    @property
    def busy_total_s(self) -> float:
        return sum(self.stage_busy_s.values())


class MapTaskPipeline:
    """Three-stage bounded pipeline over map-shard items.

    ``sort_fn(item)``, ``stage_fn(item, sorted)``, ``publish_fn(item,
    staged)`` are the stage bodies; any may be None to skip that stage
    (its input passes through). ``run(items)`` returns a
    :class:`PipelineReport` whose ``results[i]`` is the last stage's
    return value for ``items[i]``.
    """

    def __init__(
        self,
        sort_fn: Optional[Callable[[Any], Any]],
        stage_fn: Optional[Callable[[Any, Any], Any]],
        publish_fn: Optional[Callable[[Any, Any], Any]],
        *,
        parallelism: int = 2,
        depth: int = 2,
        role: str = "writer",
    ):
        self._sort_fn = sort_fn
        self._stage_fn = stage_fn
        self._publish_fn = publish_fn
        self._parallelism = max(1, int(parallelism))
        self._depth = max(1, int(depth))
        self._role = role

    # ------------------------------------------------------------------
    def run(self, items: Sequence[Any]) -> PipelineReport:
        items = list(items)
        # the stage/publish threads and sort pool are bare threads: they
        # must inherit the submitting task's tenant so buffer charges
        # and breaker keys stay attributed to the right tenant
        tenant = tenancy.current_tenant()
        reg = get_registry()
        inflight = reg.gauge("writer.pipeline.inflight", role=self._role)
        hists = {
            s: reg.histogram(
                "writer.pipeline.stage_ms",
                bounds=_STAGE_BOUNDS,
                role=self._role,
                stage=s,
            )
            for s in STAGES
        }
        busy = {s: 0.0 for s in STAGES}
        busy_lock = threading.Lock()
        abort = threading.Event()
        errbox: List[BaseException] = []
        err_lock = threading.Lock()
        results: List[Any] = [None] * len(items)

        def fail(e: BaseException) -> None:
            with err_lock:
                if not errbox:
                    errbox.append(e)
            abort.set()

        tracer = get_tracer(self._role)

        def timed(stage: str, follows, fn: Callable, *args):
            """Run one stage body inside a ``writer.pipeline.<stage>``
            span that causally follows the item's previous stage span
            (the queue hand-off edge). Returns (result, span)."""
            t0 = time.perf_counter()
            try:
                with tracer.span(
                    "writer.pipeline." + stage, follows=follows
                ) as sp:
                    return fn(*args), sp
            finally:
                dt = time.perf_counter() - t0
                hists[stage].observe(dt * 1e3)
                with busy_lock:
                    busy[stage] += dt

        # stage-to-stage handoff: bounded, so a slow downstream stage
        # backpressures instead of accumulating every shard's output
        stage_q: "queue.Queue" = queue.Queue(self._depth)
        publish_q: "queue.Queue" = queue.Queue(self._depth)

        def sort_one(idx: int) -> None:
            inflight.add(1)
            try:
                if abort.is_set():
                    inflight.add(-1)
                    return
                out, sp = (
                    timed("sort", None, self._sort_fn, items[idx])
                    if self._sort_fn is not None
                    else (items[idx], None)
                )
                # blocking put IS the backpressure; an abort raised
                # downstream closes the queues only after draining, so
                # this never deadlocks
                schedule_point("queue", "writer.stage_q.put")
                stage_q.put((idx, out, sp))
            except BaseException as e:  # noqa: BLE001 — latch and drain
                inflight.add(-1)
                fail(e)

        def stage_main() -> None:
            while True:
                schedule_point("queue", "writer.stage_q.get")
                got = stage_q.get()
                if got is _CLOSE:
                    publish_q.put(_CLOSE)
                    return
                idx, sorted_out, prev = got
                if abort.is_set():
                    inflight.add(-1)
                    continue
                try:
                    staged, sp = (
                        timed("stage", prev, self._stage_fn, items[idx], sorted_out)
                        if self._stage_fn is not None
                        else (sorted_out, prev)
                    )
                    schedule_point("queue", "writer.publish_q.put")
                    publish_q.put((idx, staged, sp))
                except BaseException as e:  # noqa: BLE001
                    inflight.add(-1)
                    fail(e)

        def publish_main() -> None:
            while True:
                schedule_point("queue", "writer.publish_q.get")
                got = publish_q.get()
                if got is _CLOSE:
                    return
                idx, staged, prev = got
                if abort.is_set():
                    inflight.add(-1)
                    continue
                try:
                    results[idx] = (
                        timed("publish", prev, self._publish_fn, items[idx], staged)[0]
                        if self._publish_fn is not None
                        else staged
                    )
                except BaseException as e:  # noqa: BLE001
                    fail(e)
                finally:
                    inflight.add(-1)

        t_wall0 = time.perf_counter()
        stage_t = threading.Thread(
            target=tenancy.scoped(tenant, stage_main),
            name="map-pipeline-stage",
            daemon=True,
        )
        publish_t = threading.Thread(
            target=tenancy.scoped(tenant, publish_main),
            name="map-pipeline-publish",
            daemon=True,
        )
        stage_t.start()
        publish_t.start()
        pool = ThreadPoolExecutor(
            self._parallelism, thread_name_prefix="map-pipeline-sort"
        )
        try:
            sort_scoped = tenancy.scoped(tenant, sort_one)
            futures = [pool.submit(sort_scoped, i) for i in range(len(items))]
            for f in futures:
                f.result()  # sort_one never raises; this is a join
        finally:
            pool.shutdown(wait=True)
            stage_q.put(_CLOSE)
            stage_t.join()
            publish_t.join()
        wall = time.perf_counter() - t_wall0

        if errbox:
            raise errbox[0]
        overlap = max(0.0, sum(busy.values()) - wall)
        reg.histogram(
            "writer.pipeline.overlap_ms", bounds=_STAGE_BOUNDS, role=self._role
        ).observe(overlap * 1e3)
        return PipelineReport(
            wall_s=wall,
            stage_busy_s=dict(busy),
            overlap_s=overlap,
            results=results,
        )
