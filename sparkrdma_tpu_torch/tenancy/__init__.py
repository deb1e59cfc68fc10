"""Tenancy — multi-tenant serving primitives for concurrent shuffles.

One `TpuShuffleManager`/`TpuContext` serves N concurrent jobs from
competing tenants. The layer has three independent mechanisms, all
keyed by a thread-local *tenant id* that rides every task the engine
dispatches:

- admission control (:mod:`.admission`) — bounded in-flight jobs with
  a FIFO queue-with-deadline beyond the bound,
- weighted fair-share scheduling (:mod:`.fairshare`) — a
  deficit-round-robin submit queue replacing raw ThreadPoolExecutor
  FIFO on the bounded map/reduce pools, charged by *measured task
  runtime* so a 1000-shard tenant cannot convoy a 10-shard tenant,
- byte quotas (:mod:`.quota`) — per-tenant caps on mempool and HBM
  arena bytes that apply backpressure (block the offending tenant's
  own workers, never OOM, never block other tenants).

The tenant id is context, not identity: `tenant_scope("alice")` tags
everything the current thread does — pool submits, buffer charges,
breaker keys, `obs` labels — until the scope exits. Threads without a
scope belong to ``DEFAULT_TENANT``, and every mechanism degenerates to
the pre-tenancy behavior for that single default tenant (FIFO order,
unscoped breaker keys, no quota), so the layer is safe to leave on.

A copy of the JAX package's ``tenancy/__init__.py``, its imports
rewritten to this package.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, Iterator, List, Optional

DEFAULT_TENANT = "default"

_tls = threading.local()

# Thread-ident → tenant side table for cross-thread readers (the
# sampling profiler, obs/profiler.py, reads OTHER threads' tenants
# from its timer thread — a threading.local can't serve that). Plain
# dict ops are atomic under the GIL; entries for the default tenant
# are dropped so idle/finished threads don't accumulate.
_tenant_by_ident: Dict[int, str] = {}


def _publish_ident(tenant: str) -> None:
    ident = threading.get_ident()
    if tenant == DEFAULT_TENANT:
        _tenant_by_ident.pop(ident, None)
    else:
        _tenant_by_ident[ident] = tenant


def current_tenant() -> str:
    """The tenant id owning the current thread's work."""
    return getattr(_tls, "tenant", DEFAULT_TENANT)


def tenant_of_ident(ident: int) -> str:
    """Tenant owning thread ``ident``'s work right now — readable from
    ANY thread (unlike :func:`current_tenant`). Used by the sampling
    profiler to tag wall-clock samples."""
    return _tenant_by_ident.get(ident, DEFAULT_TENANT)


def set_current_tenant(tenant: Optional[str]) -> None:
    t = tenant or DEFAULT_TENANT
    _tls.tenant = t
    _publish_ident(t)


@contextlib.contextmanager
def tenant_scope(tenant: Optional[str]) -> Iterator[str]:
    """Run the enclosed block as ``tenant`` (restores the previous
    scope on exit; None means the default tenant)."""
    prev = getattr(_tls, "tenant", DEFAULT_TENANT)
    t = tenant or DEFAULT_TENANT
    _tls.tenant = t
    _publish_ident(t)
    try:
        yield t
    finally:
        _tls.tenant = prev
        _publish_ident(prev)


def scoped(tenant: Optional[str], fn):
    """Wrap fn to run under ``tenant_scope(tenant)`` — for handing
    work to bare threads/pools that don't inherit thread-locals."""

    def _run(*args, **kwargs):
        with tenant_scope(tenant):
            return fn(*args, **kwargs)

    return _run


def declared_tenants(conf) -> List[str]:
    """Tenant names a configuration declares up front (fair-share
    weight entries), sorted. Per-tenant SLO objectives (obs/slo.py)
    install one objective per declared tenant; tenants that only ever
    appear at runtime ride the global objective instead."""
    return sorted(conf.tenancy_weights)


def parse_weights(spec: str) -> Dict[str, int]:
    """Parse a ``"alice:4,bob:1"`` weight spec (bad entries dropped)."""
    out: Dict[str, int] = {}
    for part in (spec or "").split(","):
        part = part.strip()
        if not part or ":" not in part:
            continue
        name, _, raw = part.rpartition(":")
        try:
            w = int(raw)
        except ValueError:
            continue
        if name.strip() and w > 0:
            out[name.strip()] = w
    return out


from sparkrdma_tpu_torch.tenancy.admission import (  # noqa: E402
    AdmissionClosed,
    AdmissionController,
    AdmissionTimeout,
)
from sparkrdma_tpu_torch.tenancy.fairshare import FairShareExecutor  # noqa: E402
from sparkrdma_tpu_torch.tenancy import quota  # noqa: E402
from sparkrdma_tpu_torch.tenancy.quota import QuotaBroker  # noqa: E402

__all__ = [
    "DEFAULT_TENANT",
    "current_tenant",
    "tenant_of_ident",
    "set_current_tenant",
    "tenant_scope",
    "scoped",
    "parse_weights",
    "declared_tenants",
    "AdmissionController",
    "AdmissionTimeout",
    "AdmissionClosed",
    "FairShareExecutor",
    "QuotaBroker",
    "quota",
]
