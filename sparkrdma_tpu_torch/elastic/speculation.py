"""Speculative reduce execution — first finisher wins (docs/DESIGN.md §21).

The telemetry hub's straggler detector produces *advisory* verdicts
(``TelemetryHub.straggler_report`` → ``SourceHealthRegistry`` suspect
keys); this module is their first actuator. While a stage's reduce
ranges are in flight, :class:`SpeculativeReducePhase` polls those
verdicts and clones any range whose only attempt sits on a flagged
executor onto a healthy peer. Both attempts race:

- the first to finish settles the range (a clone win counts under
  ``elastic.speculation_wins``),
- every other attempt is drained through the worker's ``cancel_reduce``
  request, which closes the in-flight reader and fires the reduce
  pipeline's abort latch (``elastic.clone_cancels``) — the loser
  unwinds instead of burning its executor to the end.

Reduce tasks are safe to run twice by construction: they only *read*
published map outputs and the winner's result is taken whole, so the
race needs no output commit protocol. The phase also serves as the
cluster driver's failure collector — ranges whose every attempt failed
come back in the ``failures`` map for the executor-loss recovery path
(engine/cluster.py) rather than raising mid-phase.

Everything here runs on the driver: the monitor loop borrows the
calling thread, attempts ride the cluster's task pool.

A copy of the JAX package's ``elastic/speculation.py``, its imports
rewritten to this package (the model checker's schedule points go to
the port's ``analysis/modelcheck``; journal events to
``obs/journal.py``). The suspects are the health registry's, which the
driver's telemetry hub feeds with its straggler report.
"""

from __future__ import annotations

import logging
import threading
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

from sparkrdma_tpu_torch.analysis.modelcheck import schedule_point
from sparkrdma_tpu_torch.obs import get_registry
from sparkrdma_tpu_torch.obs.journal import emit as journal_emit

logger = logging.getLogger(__name__)

# (range_index, (start_partition, end_partition), WorkerHandle)
Assignment = Tuple[int, Tuple[int, int], object]


def suspect_executors(driver) -> Set[str]:
    """Executor ids currently flagged by the advisory plane: the health
    registry's suspects (keys may be tenant-scoped ``<tenant>:<eid>`` —
    the verdict applies to the executor either way here, since a slow
    process is slow for every tenant's clone decision) plus a fresh
    straggler report when a telemetry hub is live."""
    out: Set[str] = set()
    health = getattr(driver, "health", None)
    if health is not None:
        for key in health.suspects():
            out.add(key.rsplit(":", 1)[-1])
    hub = getattr(driver, "telemetry", None)
    if hub is not None:
        try:
            out.update(hub.straggler_report().get("stragglers") or ())
        except Exception:
            logger.debug("straggler report failed", exc_info=True)
    return out


class SpeculativeReducePhase:
    """One stage's reduce fan-out with straggler cloning.

    ``live_workers`` is a callable (not a snapshot) so clone targets
    are chosen among executors still alive at decision time."""

    def __init__(
        self,
        driver,
        pool,
        conf,
        live_workers: Callable[[], List],
        handle,
        reduce_fn,
        tenant: Optional[str],
    ):
        self._driver = driver
        self._pool = pool
        self._conf = conf
        self._live_workers = live_workers
        self._handle = handle
        self._reduce_fn = reduce_fn
        self._tenant = tenant
        reg = get_registry()
        role = driver.executor_id
        self._m_specs = reg.counter("elastic.speculations", role=role)
        self._m_wins = reg.counter("elastic.speculation_wins", role=role)
        self._m_cancels = reg.counter("elastic.clone_cancels", role=role)

    # -- one attempt ----------------------------------------------------
    def _reduce_once(self, worker, rng: Tuple[int, int]):
        return worker.request(
            {
                "kind": "reduce",
                "handle": self._handle,
                "start": rng[0],
                "end": rng[1],
                "reduce_fn": self._reduce_fn,
                "tenant": self._tenant,
            }
        )

    def _cancel(self, worker, rng: Tuple[int, int]) -> None:
        try:
            hit = worker.request(
                {
                    "kind": "cancel_reduce",
                    "shuffle_id": self._handle.shuffle_id,
                    "start": rng[0],
                    "end": rng[1],
                },
                timeout_s=10.0,
            )
        except Exception:
            return  # loser already finished or died; nothing to drain
        if hit:
            self._m_cancels.inc()

    def _already_settled(
        self, idx: int, done: Dict[int, object], failures: Dict[int, Exception]
    ) -> bool:
        """Late-loser guard (caller holds the phase lock): once a range
        settled, every other attempt crossing the line is discarded —
        the first finisher's result must never be overwritten. Named so
        the modelcheck mutation gate can disarm exactly this guard."""
        return idx in done or idx in failures

    def _pick_peer(self, suspects: Set[str], tried: Set[str]):
        for w in self._live_workers():
            if w.executor_id in suspects or w.executor_id in tried:
                continue
            return w
        return None

    # -- the race -------------------------------------------------------
    def run(
        self, assignments: Sequence[Assignment]
    ) -> Tuple[Dict[int, object], Dict[int, Exception]]:
        """Run every assignment to first-finisher resolution. Returns
        ``(results, failures)`` keyed by range index; a range fails only
        when ALL of its attempts failed."""
        rngs = {idx: rng for idx, rng, _ in assignments}
        done: Dict[int, object] = {}
        failures: Dict[int, Exception] = {}
        # idx -> {executor_id: worker} still racing / ever tried
        inflight: Dict[int, Dict[str, object]] = {}
        tried: Dict[int, Set[str]] = {}
        lock = threading.Lock()
        wake = threading.Event()

        def issue(idx: int, worker, clone: bool) -> None:
            schedule_point("proto", "spec.issue")
            with lock:
                inflight.setdefault(idx, {})[worker.executor_id] = worker
                tried.setdefault(idx, set()).add(worker.executor_id)
            fut = self._pool.submit(self._reduce_once, worker, rngs[idx])
            fut.add_done_callback(
                lambda f: settle(idx, worker, f, clone)
            )

        def settle(idx: int, worker, fut, clone: bool) -> None:
            schedule_point("proto", "spec.settle")
            losers: List = []
            with lock:
                flight = inflight.get(idx, {})
                flight.pop(worker.executor_id, None)
                if self._already_settled(idx, done, failures):
                    wake.set()
                    return  # a loser crossing the line late
                err = fut.exception()
                if err is None:
                    done[idx] = fut.result()
                    if clone:
                        self._m_wins.inc()
                        journal_emit(
                            "elastic.spec_win",
                            role=self._driver.executor_id,
                            executor=worker.executor_id,
                            shuffle_id=self._handle.shuffle_id,
                            range=list(rngs[idx]),
                        )
                    losers = list(flight.values())
                    flight.clear()
                elif not flight:
                    # every attempt for this range has now failed
                    failures[idx] = err
                else:
                    logger.warning(
                        "reduce range %s failed on %s (%s); racing attempt "
                        "still in flight", rngs[idx], worker.executor_id, err,
                    )
            for w in losers:
                self._cancel(w, rngs[idx])
            wake.set()

        for idx, _rng, worker in assignments:
            issue(idx, worker, clone=False)

        speculate = self._conf.elastic_speculation
        check_s = self._conf.elastic_speculation_check_ms / 1000.0
        while True:
            with lock:
                if len(done) + len(failures) == len(assignments):
                    break
            wake.wait(timeout=check_s if speculate else 1.0)
            wake.clear()
            if not speculate:
                continue
            suspects = suspect_executors(self._driver)
            if not suspects:
                continue
            clones: List[Tuple[int, object]] = []
            with lock:
                for idx in rngs:
                    if idx in done or idx in failures:
                        continue
                    flight = inflight.get(idx, {})
                    # clone only a range with exactly one attempt, and
                    # only when that attempt sits on a suspect
                    if len(flight) != 1:
                        continue
                    (eid,) = flight
                    if eid not in suspects:
                        continue
                    peer = self._pick_peer(suspects, tried.get(idx, set()))
                    if peer is not None:
                        clones.append((idx, peer))
            for idx, worker in clones:
                self._m_specs.inc()
                journal_emit(
                    "elastic.spec", role=self._driver.executor_id,
                    executor=worker.executor_id,
                    tenant=self._tenant or "",
                    shuffle_id=self._handle.shuffle_id,
                    range=list(rngs[idx]),
                )
                logger.warning(
                    "speculating reduce range %s: cloning off flagged "
                    "executor onto %s", rngs[idx], worker.executor_id,
                )
                issue(idx, worker, clone=True)
        return dict(done), dict(failures)
