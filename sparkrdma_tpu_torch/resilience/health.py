"""Source health tracking — per-remote-manager circuit breakers.

A dead peer must fail FAST: without a breaker, every reducer fetching
from it independently burns its full retry budget (attempts × backoff)
before surfacing FetchFailedError, multiplying a single executor loss
into minutes of cluster-wide stall. The breaker is the classic
three-state machine:

  CLOSED     normal operation; consecutive failures count up
  OPEN       >= failure_threshold consecutive failures: every fetch to
             the peer fails immediately (CircuitOpenError) for
             ``open_ms``
  HALF_OPEN  after ``open_ms`` ONE probe fetch is allowed through;
             success closes the circuit, failure re-opens it

State transitions are counted in the process-wide obs registry under
``resilience.circuit_open`` / ``resilience.circuit_close``.

A copy of the JAX package's ``resilience/health.py``, its imports
rewritten to this package (the lock-order and model-checker calls go to the
port's ``analysis/lockorder.py`` and ``analysis/modelcheck``; journal events to ``obs/journal.py``).
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Dict, Optional

from sparkrdma_tpu_torch import tenancy
from sparkrdma_tpu_torch.obs import get_registry
from sparkrdma_tpu_torch.obs.journal import emit as journal_emit

logger = logging.getLogger(__name__)

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"


class CircuitOpenError(IOError):
    """Fetch refused because the source's circuit is open (fail-fast).

    Deliberately NOT retryable by the fetcher's ladder: the breaker IS
    the retry governor for a peer presumed dead; the failure surfaces
    straight to FetchFailedError so the engine can recompute the stage
    elsewhere.
    """


class CircuitBreaker:
    """One peer's health state machine. Thread-safe."""

    def __init__(
        self,
        failure_threshold: int = 3,
        open_ms: int = 5000,
        clock: Callable[[], float] = time.monotonic,
    ):
        self._threshold = max(1, failure_threshold)
        self._open_s = open_ms / 1000.0
        self._clock = clock
        self._lock = threading.Lock()
        self._state = CLOSED
        self._consecutive_failures = 0
        self._opened_at = 0.0
        self._probe_out = False

    @property
    def state(self) -> str:
        with self._lock:
            return self._observe_locked()

    def _observe_locked(self) -> str:
        if self._state == OPEN and self._clock() - self._opened_at >= self._open_s:
            self._state = HALF_OPEN
            self._probe_out = False
        return self._state

    def allow(self) -> bool:
        """May a fetch be issued to this peer right now?

        HALF_OPEN admits exactly one in-flight probe; concurrent
        callers keep failing fast until the probe reports back.
        """
        with self._lock:
            state = self._observe_locked()
            if state == CLOSED:
                return True
            if state == HALF_OPEN and not self._probe_out:
                self._probe_out = True
                return True
            return False

    def record_success(self) -> bool:
        """Report a completed fetch; True if this closed the circuit."""
        with self._lock:
            was_open = self._state != CLOSED
            self._state = CLOSED
            self._consecutive_failures = 0
            self._probe_out = False
            return was_open

    def record_failure(self) -> bool:
        """Report a failed fetch; True if this opened the circuit."""
        with self._lock:
            state = self._observe_locked()
            if state == HALF_OPEN:
                # the probe failed: straight back to OPEN for a full window
                self._state = OPEN
                self._opened_at = self._clock()
                self._probe_out = False
                return True
            self._consecutive_failures += 1
            if state == CLOSED and self._consecutive_failures >= self._threshold:
                self._state = OPEN
                self._opened_at = self._clock()
                return True
            return False


class SourceHealthRegistry:
    """Circuit breakers keyed by remote executor_id, one per manager.

    The breaker keys on executor identity (not host:port) to match
    ShuffleManagerId equality semantics: a respawned executor under the
    same id inherits — and must re-earn — its predecessor's health.

    Tenancy: breakers are additionally scoped per tenant
    (``"<tenant>:<executor_id>"``) so one tenant's fault plan tripping
    a peer's circuit cannot fail-fast ANOTHER tenant's fetches from
    the same peer. The default tenant keeps the bare executor_id key —
    single-tenant deployments see exactly the pre-tenancy keyspace.
    """

    def __init__(self, conf, role: str = ""):
        self._threshold = conf.circuit_failure_threshold
        self._open_ms = conf.circuit_open_ms
        self._role = role
        self._lock = threading.Lock()
        self._breakers: Dict[str, CircuitBreaker] = {}
        self._suspects: Dict[str, dict] = {}
        reg = get_registry()
        self._m_open = reg.counter("resilience.circuit_open", role=role)
        self._m_close = reg.counter("resilience.circuit_close", role=role)
        self._m_advisory = reg.counter(
            "resilience.straggler_advisories", role=role
        )

    @staticmethod
    def _key(executor_id: str, tenant: Optional[str]) -> str:
        t = tenant if tenant is not None else tenancy.current_tenant()
        if t == tenancy.DEFAULT_TENANT:
            return executor_id
        return f"{t}:{executor_id}"

    def get(
        self, executor_id: str, tenant: Optional[str] = None
    ) -> CircuitBreaker:
        key = self._key(executor_id, tenant)
        with self._lock:
            br = self._breakers.get(key)
            if br is None:
                br = CircuitBreaker(self._threshold, self._open_ms)
                self._breakers[key] = br
            return br

    def allow(self, executor_id: str, tenant: Optional[str] = None) -> bool:
        br = self.get(executor_id, tenant)
        was_half_open = br.state == HALF_OPEN
        ok = br.allow()
        if ok and was_half_open:
            journal_emit(
                "circuit.half_open", role=self._role, executor=executor_id,
            )
        return ok

    def record_success(
        self, executor_id: str, tenant: Optional[str] = None
    ) -> None:
        if self.get(executor_id, tenant).record_success():
            self._m_close.inc()
            journal_emit(
                "circuit.close", role=self._role, executor=executor_id,
            )
            logger.info("circuit to %s closed (probe succeeded)", executor_id)

    def record_failure(
        self, executor_id: str, tenant: Optional[str] = None
    ) -> None:
        if self.get(executor_id, tenant).record_failure():
            self._m_open.inc()
            journal_emit(
                "circuit.open", role=self._role, executor=executor_id,
            )
            logger.warning(
                "circuit to %s opened after consecutive failures",
                self._key(executor_id, tenant),
            )

    def states(self) -> Dict[str, str]:
        """Snapshot of every tracked peer's state (metrics_snapshot)."""
        with self._lock:
            items = list(self._breakers.items())
        return {peer: br.state for peer, br in items}

    # -- telemetry advisory path (docs/RESILIENCE.md) ---------------------
    def apply_straggler_report(self, report: Dict) -> None:
        """Advisory signal from the telemetry hub's straggler detector.

        A straggler is SLOW, not DEAD: the report marks the executor as
        a suspect (visible in :meth:`suspects` and counted under
        ``resilience.straggler_advisories``) but never opens its
        circuit — only the breaker's own consecutive fetch failures do
        that. Suspects that fall out of the report are cleared.

        Suspect keys match :meth:`_key` — bare executor id for the
        default tenant, ``<tenant>:<executor>`` otherwise — so a
        straggler verdict derived from one tenant's task metrics never
        smears that executor for other tenants. Reports from older
        hubs without ``suspect_keys`` fall back to the tenant-blind
        ``stragglers`` list.
        """
        flagged = set(
            report.get("suspect_keys") or report.get("stragglers") or ()
        )
        wall_ms = report.get("generated_wall_ms", 0)
        with self._lock:
            new = flagged - set(self._suspects)
            self._suspects = {
                eid: self._suspects.get(eid, {"first_wall_ms": wall_ms})
                for eid in flagged
            }
            for eid in flagged:
                self._suspects[eid]["last_wall_ms"] = wall_ms
        for eid in sorted(new):
            self._m_advisory.inc()
            logger.warning(
                "telemetry advisory: %s flagged as straggler (circuit NOT "
                "opened; advisory only)", eid,
            )

    def suspects(self) -> Dict[str, dict]:
        """Executors currently flagged by the straggler advisory."""
        with self._lock:
            return {eid: dict(info) for eid, info in self._suspects.items()}
