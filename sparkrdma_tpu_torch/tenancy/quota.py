"""Per-tenant byte quotas with backpressure — mempool, HBM arena, and
mapped-fetch page cache.

A broker tracks *held* bytes per tenant for one resource (capacity is
charged at ``get`` and released at ``put``/``free``, so spilling a
slab to host does not un-block its tenant — the capacity is still
owned). ``charge`` blocks the calling thread — i.e. the offending
tenant's own stage/push worker — while the tenant is at its quota,
and wakes on any of that tenant's releases. Two hard guarantees:

- **progress**: a tenant holding zero bytes is always admitted, even
  for a request larger than its quota (a single oversized buffer must
  not deadlock), and a blocked charge proceeds anyway after
  ``block_max_ms`` (counted under ``tenant.quota_overruns``) — the
  quota is backpressure, never an OOM or a permanent wedge;
- **isolation**: usage is per-tenant, so one tenant at its quota never
  blocks another's allocations.

Brokers are installed process-wide (the mempool/arena are process
singletons per node) from the first tenancy-enabled manager init;
:func:`broker` returns None while unconfigured so the allocation hot
paths pay nothing when quotas are off.

A copy of the JAX package's ``tenancy/quota.py``, its imports rewritten
to this package (the lock-order and model-checker calls go to the port's ``analysis/lockorder.py``
and ``analysis/modelcheck``; journal events to ``obs/journal.py``).
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Dict, Optional

from sparkrdma_tpu_torch.analysis.lockorder import named_lock
from sparkrdma_tpu_torch.analysis.modelcheck import schedule_point
from sparkrdma_tpu_torch.obs import get_registry
from sparkrdma_tpu_torch.obs.journal import emit as journal_emit

logger = logging.getLogger(__name__)


class QuotaBroker:
    """Byte ledger + backpressure gate for one resource."""

    def __init__(
        self,
        resource: str,
        quota_bytes: int,
        block_max_ms: int = 60000,
        per_tenant: Optional[Dict[str, int]] = None,
    ):
        self.resource = resource
        self._quota = max(0, quota_bytes)  # 0 = unlimited
        self._per_tenant = dict(per_tenant or {})
        self._block_max_s = max(1, block_max_ms) / 1000.0
        self._lock = named_lock(f"quota.{resource}")
        self._cond = threading.Condition(self._lock)
        self._usage: Dict[str, int] = {}
        self._waiting = 0  # threads currently blocked at this quota
        reg = get_registry()
        self._m_blocks = lambda t: reg.counter(
            "tenant.quota_blocks", tenant=t, resource=resource
        )
        self._m_overruns = lambda t: reg.counter(
            "tenant.quota_overruns", tenant=t, resource=resource
        )
        self._h_wait = lambda t: reg.histogram(
            "tenant.quota_wait_ms", tenant=t, resource=resource
        )
        self._g_bytes = lambda t: reg.gauge(
            "tenant.bytes", tenant=t, resource=resource
        )

    def quota_for(self, tenant: str) -> int:
        return self._per_tenant.get(tenant, self._quota)

    def usage(self, tenant: str) -> int:
        with self._lock:
            return self._usage.get(tenant, 0)

    def waiting(self) -> int:
        """Threads blocked at this quota right now — a nonzero value
        means the resource is at 100% utilization regardless of how the
        held-bytes ledger reads between charges (capacity plane)."""
        with self._lock:
            return self._waiting

    def snapshot(self) -> Dict[str, Dict[str, int]]:
        """Per-tenant ``{usage, quota}`` view (capacity plane input)."""
        with self._lock:
            held = dict(self._usage)
        return {
            t: {"usage": u, "quota": self.quota_for(t)}
            for t, u in held.items()
        }

    def over_quota(self, tenant: str) -> bool:
        q = self.quota_for(tenant)
        return q > 0 and self.usage(tenant) > q

    def _must_block(self, tenant: str, nbytes: int, quota: int) -> bool:
        """Backpressure predicate (caller holds the broker lock): block
        only while THIS tenant already holds bytes and the charge would
        overshoot. Per-tenant by design — isolation means one tenant at
        its quota never blocks another — and named so the modelcheck
        mutation gate can swap in the global-usage bug it guards
        against."""
        held = self._usage.get(tenant, 0)
        return held > 0 and held + nbytes > quota

    def charge(self, tenant: str, nbytes: int) -> None:
        """Account nbytes to tenant, blocking at the quota.

        Blocks only while the tenant already holds bytes (progress
        guarantee) and only the offending tenant's thread — other
        tenants charge through the same lock without waiting."""
        schedule_point("proto", "quota.charge")
        quota = self.quota_for(tenant)
        blocked_at: Optional[float] = None
        with self._cond:
            if quota > 0:
                deadline = None
                while self._must_block(tenant, nbytes, quota):
                    now = time.perf_counter()
                    if blocked_at is None:
                        blocked_at = now
                        deadline = now + self._block_max_s
                        self._waiting += 1
                        self._m_blocks(tenant).inc()
                        journal_emit(
                            "quota.block", tenant=tenant,
                            resource=self.resource, bytes=nbytes,
                        )
                    if now >= deadline:
                        self._m_overruns(tenant).inc()
                        journal_emit(
                            "quota.overrun", tenant=tenant,
                            resource=self.resource, bytes=nbytes,
                        )
                        logger.warning(
                            "tenant %s overran its %s quota wait "
                            "(%.0f ms); admitting %d bytes anyway",
                            tenant, self.resource,
                            self._block_max_s * 1e3, nbytes,
                        )
                        break
                    self._cond.wait(deadline - now)
                if blocked_at is not None:
                    self._waiting -= 1
            self._usage[tenant] = self._usage.get(tenant, 0) + nbytes
            self._g_bytes(tenant).set(self._usage[tenant])
        if blocked_at is not None:
            wait_ms = (time.perf_counter() - blocked_at) * 1e3
            self._h_wait(tenant).observe(wait_ms)
            journal_emit(
                "quota.release", tenant=tenant, resource=self.resource,
                bytes=nbytes, wait_ms=round(wait_ms, 1),
            )

    def release(self, tenant: str, nbytes: int) -> None:
        schedule_point("proto", "quota.release")
        with self._cond:
            self._usage[tenant] = max(0, self._usage.get(tenant, 0) - nbytes)
            self._g_bytes(tenant).set(self._usage[tenant])
            self._cond.notify_all()


# -- process-wide broker table -------------------------------------------
_table_lock = named_lock("quota.table")
_brokers: Dict[str, QuotaBroker] = {}


def _per_tenant_overrides(conf, resource_key: str) -> Dict[str, int]:
    """Scan conf for ``tenancy.quota.<tenant>.<resource_key>`` entries."""
    from sparkrdma_tpu_torch.utils.config import PREFIX
    from sparkrdma_tpu_torch.utils.units import parse_bytes

    head = PREFIX + "tenancy.quota."
    tail = "." + resource_key
    out: Dict[str, int] = {}
    for key, raw in conf.to_dict().items():
        if key.startswith(head) and key.endswith(tail):
            tenant = key[len(head) : -len(tail)]
            if not tenant:
                continue
            try:
                out[tenant] = parse_bytes(str(raw))
            except ValueError:
                continue
    return out


def install(conf) -> None:
    """Install the mempool/hbm brokers from conf (idempotent; first
    tenancy-enabled manager in the process wins). A resource with no
    default quota and no per-tenant override gets NO broker, keeping
    the allocation hot paths untouched when quotas are off."""
    specs = {
        "mempool": (conf.tenancy_mempool_quota_bytes, "mempoolBytes"),
        "hbm": (conf.tenancy_hbm_quota_bytes, "hbmBytes"),
        # mapped zero-copy fetches bypass the mempool entirely, so
        # their page-cache footprint gets its own ledger (fetcher.py
        # charges per mapped group, releases on delivery/failure)
        "pagecache": (conf.tenancy_pagecache_quota_bytes, "pageCacheBytes"),
    }
    with _table_lock:
        for resource, (default_quota, key) in specs.items():
            if resource in _brokers:
                continue
            per_tenant = _per_tenant_overrides(conf, key)
            if default_quota <= 0 and not per_tenant:
                continue
            _brokers[resource] = QuotaBroker(
                resource,
                default_quota,
                block_max_ms=conf.tenancy_quota_block_max_ms,
                per_tenant=per_tenant,
            )


def broker(resource: str) -> Optional[QuotaBroker]:
    return _brokers.get(resource)


def charge_pagecache(tenant: str, nbytes: int):
    """THE page-cache charge seam for the read submission plane
    (DESIGN.md §24): every mapped-delivery path — the fetcher's mapped
    group READs and anything else that hands out page-cache windows
    outside the mempool ledger — charges ``tenancy.pageCacheQuotaBytes``
    through this one call site, so the backpressure semantics
    (per-tenant blocking, ``block_max_ms`` overrun escape, isolation)
    cannot drift between paths.

    Charges ``nbytes`` now (blocking at the quota, exactly like
    :meth:`QuotaBroker.charge`) and returns a release-once callable:
    safe to invoke from both the failure-cleanup and the
    last-stream-closed paths — only the first call releases. When no
    ``pagecache`` broker is installed, returns a no-op without
    touching any ledger."""
    b = _brokers.get("pagecache")
    if b is None:
        return lambda: None
    b.charge(tenant, nbytes)
    once = threading.Lock()

    def release() -> None:
        if once.acquire(blocking=False):
            b.release(tenant, nbytes)

    return release


def reset() -> None:
    """Drop installed brokers (tests only)."""
    with _table_lock:
        _brokers.clear()
