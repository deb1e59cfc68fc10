"""Device fetch plane — arena registry and per-block device pulls.

The PyTorch counterpart of the JAX package's ``shuffle/device_fetch.py``.
Map executors stage shards in their device arena and publish
``(device_coords, arena_handle, arena_offset)`` beside the host triple;
a reducer that can see the source arena pulls the bytes device to
device instead of through the host. The visible set is the arenas
registered in this process (``register_arena``).

Planner decision table (every outcome but a pull is a silent fallback
to the host triple, which always stays valid):

| condition                                   | outcome        |
|---------------------------------------------|----------------|
| ``deviceFetch.enabled`` off                  | host (silent)  |
| location has no device extension             | host (silent)  |
| block < ``deviceFetch.minBlockBytes``        | host, fallback++|
| source arena not visible                     | host, fallback++|
| arena slab freed / spilled / being spilled   | host, fallback++|
| stale arena coordinates                      | host, fallback++|
| staged dtype != requested dtype              | host, fallback++|
| otherwise                                    | device pull    |

Unlike the JAX plane, a failing mover is an error, not a fallback: only
residency misses degrade.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Dict, Optional

import numpy as np

from sparkrdma_tpu_torch.locations import PartitionLocation
from sparkrdma_tpu_torch.obs import get_registry
from sparkrdma_tpu_torch.ops import remote_copy
from sparkrdma_tpu_torch.ops.hbm_arena import DeviceBuffer, DeviceBufferManager
from sparkrdma_tpu_torch.utils.torch_compat import torch_dtype

logger = logging.getLogger(__name__)

# visible arena registry: executor_id -> that endpoint's arena
_arenas: Dict[str, DeviceBufferManager] = {}
_arenas_lock = threading.Lock()


def register_arena(executor_id: str, dev: DeviceBufferManager) -> None:
    with _arenas_lock:
        _arenas[executor_id] = dev


def unregister_arena(executor_id: str, dev: DeviceBufferManager) -> None:
    """Drop the registration iff it is still ``dev`` (a newer arena under
    the same executor id keeps its registration)."""
    with _arenas_lock:
        if _arenas.get(executor_id) is dev:
            del _arenas[executor_id]


def visible_arena(executor_id: str) -> Optional[DeviceBufferManager]:
    with _arenas_lock:
        return _arenas.get(executor_id)


class DevicePulledBlock:
    """A block that arrived device to device, already staged in a local
    arena slab; ``release`` frees it, ``take`` hands it on."""

    kind = "device"

    __slots__ = ("shuffle_id", "loc", "length", "dev", "_released")

    def __init__(self, shuffle_id: int, loc: PartitionLocation, dev: DeviceBuffer):
        self.shuffle_id = shuffle_id
        self.loc = loc
        self.length = loc.block.length
        self.dev = dev
        self._released = False

    def release(self) -> None:
        """Abort-drain path: discard the pulled slab."""
        if self._released:
            return
        self._released = True
        self.dev.free()

    def take(self) -> DeviceBuffer:
        """Ownership transfer to the consumer (release becomes a no-op)."""
        self._released = True
        return self.dev


class DeviceFetchPlane:
    """Per-endpoint planner + mover for device pulls."""

    def __init__(self, conf, dev: DeviceBufferManager, executor_id: str):
        self._conf = conf
        self._dev = dev
        self._executor_id = executor_id
        reg = get_registry()
        self._m_pulls = reg.counter("device_fetch.plane.pulls", role=executor_id)
        self._m_bytes = reg.counter("device_fetch.plane.bytes", role=executor_id)
        self._m_fallbacks = reg.counter(
            "device_fetch.plane.fallbacks", role=executor_id
        )
        self._m_plan_ms = reg.histogram(
            "device_fetch.plane.plan_ms", role=executor_id
        )

    def _fallback(self, reason: str) -> None:
        self._m_fallbacks.inc()
        logger.debug("device pull fallback: %s", reason)

    def try_pull(self, loc: PartitionLocation, dtype=np.uint8) -> Optional[DeviceBuffer]:
        """Plan + execute one block pull; None means 'use the host path'."""
        t0 = time.perf_counter()
        try:
            return self._try_pull(loc, dtype)
        finally:
            self._m_plan_ms.observe((time.perf_counter() - t0) * 1e3)

    def _try_pull(self, loc: PartitionLocation, dtype) -> Optional[DeviceBuffer]:
        block = loc.block
        if not self._conf.device_fetch_enabled or not block.has_device:
            return None  # silent: the publisher never offered a device copy
        if block.length < self._conf.device_fetch_min_block_bytes:
            self._fallback("below minBlockBytes")
            return None
        src_arena = visible_arena(loc.manager_id.executor_id)
        if src_arena is None:
            self._fallback("source arena not visible")
            return None
        with src_arena.pinned_if_resident(block.arena_handle) as src:
            if src is None:
                self._fallback("arena slab not device-resident")
                return None
            if block.arena_offset + block.length > src.capacity:
                self._fallback("stale arena coordinates")
                return None
            if src.array.dtype != torch_dtype(dtype):
                self._fallback("staged dtype mismatch")
                return None
            pulled = remote_copy.pull_block(src.array, self._dev.device)
            # source and destination size classes match, so the pulled
            # slab-capacity tensor fits the local slab exactly
            local = self._dev.get(block.length)
            try:
                local = local.put_array(pulled)
            except BaseException:
                local.free()
                raise
            local.length = block.length
        self._m_pulls.inc()
        self._m_bytes.inc(block.length)
        return local
