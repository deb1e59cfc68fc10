"""Per-job admission control — bounded in-flight jobs, FIFO queue
with a deadline beyond the bound.

The driver owns one controller. `run_job` (and the cluster context's
`run_map_reduce`) brackets the whole job — map stage, reduce stage,
and any fetch-failure recompute attempts — in :meth:`admit`, so the
in-flight bound is a bound on *jobs*, not stages. Queued jobs are
served strictly FIFO; a job that waits past its deadline raises
:class:`AdmissionTimeout` so the caller fails fast instead of camping
on the queue forever.

A copy of the JAX package's ``tenancy/admission.py``, its imports
rewritten to this package (the lock-order and model-checker calls go to the
port's ``analysis/lockorder.py`` and ``analysis/modelcheck``; journal events to ``obs/journal.py``).
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import deque
from typing import Deque, Iterator, Optional

from sparkrdma_tpu_torch.analysis.lockorder import named_lock
from sparkrdma_tpu_torch.obs import get_registry
from sparkrdma_tpu_torch.obs.journal import emit as journal_emit


class AdmissionTimeout(RuntimeError):
    """Job refused: the admission queue deadline expired."""


class AdmissionClosed(RuntimeError):
    """Job refused: the controller was closed (manager stopping)."""


class _Waiter:
    __slots__ = ("admitted",)

    def __init__(self) -> None:
        self.admitted = False


class AdmissionController:
    """Bounded in-flight job counter with a FIFO overflow queue."""

    def __init__(
        self,
        max_inflight: int,
        queue_timeout_ms: int,
        role: str = "driver",
    ):
        self._max = max(1, max_inflight)
        self._timeout_s = max(1, queue_timeout_ms) / 1000.0
        self._lock = named_lock("admission.state")
        self._cond = threading.Condition(self._lock)
        self._inflight = 0
        self._waiters: Deque[_Waiter] = deque()
        self._closed = False
        reg = get_registry()
        self._m_admitted = lambda t: reg.counter("admission.admitted", tenant=t)
        self._m_queued = lambda t: reg.counter("admission.queue_waits", tenant=t)
        self._m_timeouts = lambda t: reg.counter("admission.timeouts", tenant=t)
        self._m_wait = lambda t: reg.histogram("admission.wait_ms", tenant=t)
        self._g_inflight = reg.gauge("admission.inflight", role=role)
        self._g_queue = reg.gauge("admission.queue_depth", role=role)

    # -- internals --------------------------------------------------------
    def _promote_locked(self) -> None:
        while self._inflight < self._max and self._waiters:
            w = self._waiters.popleft()
            w.admitted = True
            self._inflight += 1
        self._g_queue.set(len(self._waiters))

    # -- API --------------------------------------------------------------
    def acquire(self, tenant: str, timeout_ms: Optional[int] = None) -> None:
        t0 = time.perf_counter()
        timeout_s = self._timeout_s if timeout_ms is None else max(1, timeout_ms) / 1e3
        with self._cond:
            if self._closed:
                raise AdmissionClosed("admission controller closed")
            if self._inflight < self._max and not self._waiters:
                self._inflight += 1
            else:
                w = _Waiter()
                self._waiters.append(w)
                self._g_queue.set(len(self._waiters))
                self._m_queued(tenant).inc()
                journal_emit(
                    "admission.enqueue", tenant=tenant,
                    queue_depth=len(self._waiters), inflight=self._inflight,
                )
                deadline = t0 + timeout_s
                while not w.admitted:
                    if self._closed:
                        if w in self._waiters:
                            self._waiters.remove(w)
                        self._g_queue.set(len(self._waiters))
                        raise AdmissionClosed("admission controller closed")
                    remaining = deadline - time.perf_counter()
                    if remaining <= 0:
                        self._waiters.remove(w)
                        self._g_queue.set(len(self._waiters))
                        self._m_timeouts(tenant).inc()
                        journal_emit(
                            "admission.deadline", tenant=tenant,
                            waited_ms=round(timeout_s * 1e3),
                        )
                        raise AdmissionTimeout(
                            f"tenant {tenant!r} job queued past its "
                            f"{timeout_s * 1e3:.0f} ms admission deadline"
                        )
                    self._cond.wait(remaining)
            self._g_inflight.set(self._inflight)
        self._m_admitted(tenant).inc()
        self._m_wait(tenant).observe((time.perf_counter() - t0) * 1e3)

    def release(self) -> None:
        with self._cond:
            self._inflight = max(0, self._inflight - 1)
            self._promote_locked()
            self._g_inflight.set(self._inflight)
            self._cond.notify_all()

    @contextlib.contextmanager
    def admit(self, tenant: str, timeout_ms: Optional[int] = None) -> Iterator[None]:
        """Hold an admission slot for the duration of a job."""
        self.acquire(tenant, timeout_ms)
        try:
            yield
        finally:
            self.release()

    def close(self) -> None:
        """Refuse new jobs and wake queued waiters (they raise
        :class:`AdmissionClosed`). In-flight jobs finish normally."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    @property
    def inflight(self) -> int:
        with self._lock:
            return self._inflight

    @property
    def queued(self) -> int:
        with self._lock:
            return len(self._waiters)
