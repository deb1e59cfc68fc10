"""FairShareExecutor — deficit-round-robin task pool keyed by tenant.

Drop-in for the bounded ``ThreadPoolExecutor``s on the map and reduce
planes (same ``submit``/``shutdown`` surface, returns real
``concurrent.futures.Future``s), replacing FIFO dispatch with weighted
deficit round robin (DRR) over per-tenant submit queues:

- submit order within one tenant is preserved (FIFO per queue),
- dispatch order across tenants follows DRR: each round credits every
  *backlogged* tenant ``quantum × weight`` seconds of deficit, and a
  tenant is served while its deficit is positive,
- the deficit is charged with the task's **measured runtime** on
  completion, not a per-task constant — so fairness is in task-seconds
  and a tenant whose tasks run 100× longer gets 100× fewer of them
  through per round. A 1000-shard tenant queues 1000 tasks but only
  drains its fair share while a 10-shard tenant's queue empties.

Debt is remembered across backlog gaps (a tenant that just burned the
pool on one huge task waits out its debt) but clamped, and credit
never accumulates while idle — the classic DRR anti-hoarding rules.
With a single tenant the whole mechanism degenerates to plain FIFO.

A copy of the JAX package's ``tenancy/fairshare.py``, its imports
rewritten to this package (the lock-order and model-checker calls go to the
port's ``analysis/lockorder.py`` and ``analysis/modelcheck``).
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Any, Callable, Deque, Dict, Optional, Tuple

from sparkrdma_tpu_torch.analysis.lockorder import named_lock
from sparkrdma_tpu_torch.obs import get_registry, get_tracer
from sparkrdma_tpu_torch.tenancy import current_tenant, tenant_scope

logger = logging.getLogger(__name__)

# positive credit is capped at this many top-up rounds; debt at
# _DEBT_CAP_S seconds (scaled by weight). Both bound how far one
# tenant's history can skew a round without erasing runtime memory.
_CREDIT_CAP_ROUNDS = 2
_DEBT_CAP_S = 2.0

_Item = Tuple[Future, Callable, tuple, dict, str, float]


class FairShareExecutor:
    """Bounded worker pool with weighted per-tenant DRR dispatch."""

    def __init__(
        self,
        max_workers: int,
        weights: Optional[Dict[str, int]] = None,
        default_weight: int = 1,
        quantum_ms: int = 20,
        thread_name_prefix: str = "fair",
        pool: str = "pool",
    ):
        self._weights = dict(weights or {})
        self._default_weight = max(1, default_weight)
        self._quantum = max(1, quantum_ms) / 1000.0
        self._pool_label = pool
        # one graph vertex per pool role; instances of different pools
        # never nest, and the detector would flag it if they did
        self._lock = named_lock("fairshare.state", allow_self_nest=False)
        self._cond = threading.Condition(self._lock)
        self._queues: Dict[str, Deque[_Item]] = {}
        self._deficit: Dict[str, float] = {}
        self._active: Deque[str] = deque()  # backlogged tenants, RR order
        self._pending = 0
        self._shutdown = False
        reg = get_registry()
        self._m_submits: Dict[str, Any] = {}
        self._m_tasks: Dict[str, Any] = {}
        self._h_task: Dict[str, Any] = {}
        self._h_wait: Dict[str, Any] = {}
        self._g_queued: Dict[str, Any] = {}
        self._reg = reg
        self._tracer = get_tracer("fairshare")
        self._threads = [
            threading.Thread(
                target=self._worker,
                name=f"{thread_name_prefix}-{i}",
                daemon=True,
            )
            for i in range(max(1, max_workers))
        ]
        for t in self._threads:
            t.start()

    # -- metric handles (cached per tenant; registry lookups are locked) --
    def _metric(self, cache: Dict[str, Any], kind: str, name: str, tenant: str):
        m = cache.get(tenant)
        if m is None:
            factory = getattr(self._reg, kind)
            m = factory(name, tenant=tenant, pool=self._pool_label)
            cache[tenant] = m
        return m

    def _weight(self, tenant: str) -> int:
        return self._weights.get(tenant, self._default_weight)

    # -- scheduling core --------------------------------------------------
    def _pop_locked(self) -> Optional[_Item]:
        """Pick the next task under DRR, or None on drained shutdown.

        Serves the front-of-rotation tenant while its deficit is
        positive; a full rotation with no positive deficit triggers a
        credit round for every backlogged tenant (idle tenants earn
        nothing). Converges because deficits strictly increase each
        round and debt is clamped."""
        while True:
            if self._pending == 0:
                if self._shutdown:
                    return None
                self._cond.wait()
                continue
            scanned = 0
            while scanned < len(self._active):
                tenant = self._active[0]
                if self._deficit.get(tenant, 0.0) > 0.0:
                    q = self._queues[tenant]
                    item = q.popleft()
                    self._pending -= 1
                    if not q:
                        self._active.popleft()
                    self._metric(
                        self._g_queued, "gauge", "tenant.queued", tenant
                    ).set(len(q))
                    return item
                self._active.rotate(-1)
                scanned += 1
            for tenant in self._active:
                cap = self._quantum * self._weight(tenant) * _CREDIT_CAP_ROUNDS
                self._deficit[tenant] = min(
                    self._deficit.get(tenant, 0.0)
                    + self._quantum * self._weight(tenant),
                    cap,
                )

    def _charge(self, tenant: str, seconds: float) -> None:
        with self._lock:
            floor = -_DEBT_CAP_S * self._weight(tenant)
            self._deficit[tenant] = max(
                self._deficit.get(tenant, 0.0) - seconds, floor
            )

    def _worker(self) -> None:
        while True:
            with self._cond:
                item = self._pop_locked()
            if item is None:
                return
            fut, fn, args, kwargs, tenant, t_submit = item
            if not fut.set_running_or_notify_cancel():
                continue
            t_dispatch = time.perf_counter()
            self._metric(self._h_wait, "histogram", "tenant.wait_ms", tenant).observe(
                (t_dispatch - t_submit) * 1e3
            )
            # queue-wait attribution span (obs/attr.py): the submit→
            # dispatch interval this task spent parked behind DRR
            self._tracer.record(
                "tenant.queue_wait",
                t_submit,
                t_dispatch,
                tenant=tenant,
                pool=self._pool_label,
            )
            t0 = time.perf_counter()
            with tenant_scope(tenant):
                try:
                    result = fn(*args, **kwargs)
                except BaseException as e:  # noqa: BLE001 — future carries it
                    fut.set_exception(e)
                else:
                    fut.set_result(result)
            dt = time.perf_counter() - t0
            self._charge(tenant, dt)
            self._metric(self._m_tasks, "counter", "tenant.tasks", tenant).inc()
            self._metric(self._h_task, "histogram", "tenant.task_ms", tenant).observe(
                dt * 1e3
            )

    # -- executor surface -------------------------------------------------
    def submit(self, fn: Callable, *args, **kwargs) -> Future:
        """Queue fn under the calling thread's tenant; returns a Future."""
        tenant = current_tenant()
        fut: Future = Future()
        with self._cond:
            if self._shutdown:
                raise RuntimeError("cannot schedule new futures after shutdown")
            q = self._queues.get(tenant)
            if q is None:
                q = self._queues[tenant] = deque()
            if not q and tenant not in self._active:
                self._active.append(tenant)
                # fresh backlog starts with one round of credit so a
                # lone tenant never waits out a top-up loop
                self._deficit.setdefault(tenant, 0.0)
                if self._deficit[tenant] <= 0.0 and len(self._active) == 1:
                    self._deficit[tenant] = self._quantum * self._weight(tenant)
            q.append((fut, fn, args, kwargs, tenant, time.perf_counter()))
            self._pending += 1
            self._metric(self._g_queued, "gauge", "tenant.queued", tenant).set(
                len(q)
            )
            self._cond.notify()
        self._metric(self._m_submits, "counter", "tenant.submits", tenant).inc()
        return fut

    def shutdown(self, wait: bool = True, cancel_futures: bool = False) -> None:
        with self._cond:
            self._shutdown = True
            if cancel_futures:
                for q in self._queues.values():
                    while q:
                        q[0][0].cancel()
                        q.popleft()
                        self._pending -= 1
                self._active.clear()
            self._cond.notify_all()
        if wait:
            for t in self._threads:
                t.join()

    def __enter__(self) -> "FairShareExecutor":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown(wait=True)
