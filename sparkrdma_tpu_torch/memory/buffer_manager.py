"""TpuBufferManager — size-classed pool of registered buffers.

TPU-native analogue of RdmaBufferManager.java (reference: RdmaBufferManager.java). Semantics preserved:

- requests round up to the next power of two with a 16 KiB floor
  (reference MIN_BLOCK_SIZE = 16*1024, :26, and getNextPowerOf2,
  :103-118),
- one allocator stack per size class, LIFO reuse (:31-71),
- optional preallocation of ``max_agg_block``-sized buffers on
  executors (:84-91),
- ``put`` returns a buffer to its stack; foreign sizes are freed
  (:120-127),
- ``stop`` prints per-size allocation statistics (:131-141).

A copy of the JAX package's ``memory/buffer_manager.py``, its imports
rewritten to this package (the lock-order, model-checker and journal
calls go to the inert seams of ``utils/seams.py``).
"""

from __future__ import annotations

import logging
from collections import deque
from typing import Deque, Dict

from sparkrdma_tpu_torch.utils.seams import named_lock
from sparkrdma_tpu_torch.memory.buffer import TpuBuffer
from sparkrdma_tpu_torch.memory.registry import ProtectionDomain
from sparkrdma_tpu_torch.obs import get_registry
from sparkrdma_tpu_torch.tenancy import current_tenant
from sparkrdma_tpu_torch.tenancy import quota as _quota

logger = logging.getLogger(__name__)

MIN_BLOCK_SIZE = 16 * 1024

# pool counters are process-global (the pools are per-node but share one
# allocation discipline); resolved once at import so get()/put() stay hot
_M_POOL_HITS = get_registry().counter("mempool.hits")
_M_POOL_MISSES = get_registry().counter("mempool.misses")
_M_POOL_RETURNS = get_registry().counter("mempool.returns")
_M_POOL_FREES = get_registry().counter("mempool.frees")
_G_IN_USE = get_registry().gauge("mempool.in_use_bytes")


def release_charge(buf: TpuBuffer) -> None:
    """Retire a buffer's outstanding accounting tag (idempotent)."""
    tag = getattr(buf, "_mempool_charge", None)
    if tag is None:
        return
    buf._mempool_charge = None
    broker, tenant, cls = tag
    _G_IN_USE.add(-cls)
    if broker is not None:
        broker.release(tenant, cls)


def next_power_of_2(n: int) -> int:
    if n <= MIN_BLOCK_SIZE:
        return MIN_BLOCK_SIZE
    return 1 << (n - 1).bit_length()


class _AllocatorStack:
    """LIFO stack of free buffers of one size class (reference :31-71)."""

    def __init__(self, pd: ProtectionDomain, length: int):
        self.pd = pd
        self.length = length
        self.stack: Deque[TpuBuffer] = deque()
        self.total_alloc = 0
        # hot: pop/append only; allocation itself happens outside
        self.lock = named_lock("mempool.stack", hot=True)
        self.closed = False

    def get(self) -> TpuBuffer:
        with self.lock:
            if self.stack:
                _M_POOL_HITS.inc()
                return self.stack.pop()
            self.total_alloc += 1
        _M_POOL_MISSES.inc()
        return TpuBuffer(self.pd, self.length)

    def put(self, buf: TpuBuffer) -> bool:
        """Return buf to the stack; False if the stack is already closed."""
        with self.lock:
            if self.closed:
                return False
            self.stack.append(buf)
            return True

    def close(self) -> None:
        with self.lock:
            self.closed = True
            while self.stack:
                self.stack.pop().free()


class TpuBufferManager:
    """Pool of registered buffers keyed by power-of-two size class."""

    def __init__(
        self,
        pd: ProtectionDomain,
        is_executor: bool = True,
        max_agg_block: int = 2 * 1024 * 1024,
        max_agg_prealloc: int = 0,
    ):
        self.pd = pd
        self._stacks: Dict[int, _AllocatorStack] = {}
        # hot: guards the size-class table only, never held across
        # registration or frees
        self._lock = named_lock("mempool.manager", hot=True)
        self._stopped = False
        # Preallocation of aggregation-block buffers on executors
        # (reference :84-91).
        if is_executor and max_agg_prealloc > 0:
            count = max_agg_prealloc
            stack = self._stack_for(next_power_of_2(max_agg_block))
            pre = [stack.get() for _ in range(count)]
            for buf in pre:
                stack.put(buf)

    def _stack_for(self, length: int) -> _AllocatorStack:
        with self._lock:
            stack = self._stacks.get(length)
            if stack is None:
                stack = _AllocatorStack(self.pd, length)
                self._stacks[length] = stack
            return stack

    def get(self, length: int) -> TpuBuffer:
        """Get a registered buffer of capacity ≥ length (pooled).

        The tenant quota charge gates the allocation: an over-quota
        tenant's worker blocks HERE (backpressure on its own stage/push
        thread) until its earlier buffers are released. The charge tag
        rides the buffer so release (put or free, whichever retires it
        first) is idempotent."""
        if self._stopped:
            raise RuntimeError("buffer manager stopped")
        cls = next_power_of_2(length)
        broker = _quota.broker("mempool")
        tenant = current_tenant() if broker is not None else None
        if broker is not None:
            broker.charge(tenant, cls)
        try:
            buf = self._stack_for(cls).get()
        except BaseException:
            if broker is not None:
                broker.release(tenant, cls)
            raise
        buf._mempool_charge = (broker, tenant, cls)
        _G_IN_USE.add(cls)
        return buf

    def put(self, buf: TpuBuffer) -> None:
        """Return a buffer to the pool (or free, if foreign or unregistered).

        Unregistered scratch buffers (mkey == 0) must never enter the
        registered pool — a consumer would publish mkey 0 and remote
        READs would fail at the peer's PD.
        """
        release_charge(buf)
        with self._lock:
            stack = self._stacks.get(buf.length) if buf.mkey else None
        if stack is None or self._stopped or not stack.put(buf):
            _M_POOL_FREES.inc()
            buf.free()
        else:
            _M_POOL_RETURNS.inc()

    def get_unregistered(self, length: int) -> TpuBuffer:
        """Non-pooled, unregistered scratch allocation (chunk staging).

        Arena-backed: scratch lifetime is framework-controlled, so the
        native arena's unconditional free applies (see TpuBuffer)."""
        return TpuBuffer(None, length, register=False, arena=True)

    def stats(self) -> Dict[int, int]:
        with self._lock:
            return {size: s.total_alloc for size, s in self._stacks.items()}

    def stop(self) -> None:
        """Free all pooled buffers, log per-size-class allocation stats."""
        if self._stopped:
            return
        self._stopped = True
        for size, count in sorted(self.stats().items()):
            if count:
                logger.info(
                    "buffer pool: size class %d bytes — %d buffers allocated", size, count
                )
        with self._lock:
            stacks = list(self._stacks.values())
            self._stacks.clear()
        for stack in stacks:
            stack.close()
