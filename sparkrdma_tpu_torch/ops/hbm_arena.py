"""Device slab pool + handle table — the device registered-memory plane.

The PyTorch counterpart of the JAX package's ``ops/hbm_arena.py``:
size-classed stacks of uint8 slabs resident in device memory,
power-of-two classes with a 16 KiB floor, a handle table that resolves
``(handle, offset, length)`` to live bytes, the ``hbm.maxBytes``
budget, and the tiered store device -> host RAM -> disk under budget
pressure.

One difference from the JAX arena. A ``jax.Array`` is immutable, so
there a write stages a new array under the same handle. Here every slab
is a real preallocated ``torch.uint8`` tensor, and ``stage``,
``stage_view`` and ``put_array`` write INTO it in place; the budget
therefore counts exactly the arena's own slabs (never the caching
allocator's figures, which keep freed blocks). A slab may hold typed
contents: ``array`` is a view of the slab in the dtype last staged
(uint32 keys stay uint32 bytes, byte-identical with the JAX arena).
Spilled slabs release their device memory; the host tier is pinned
memory when the arena lives on CUDA.

Tenancy quota charging works as in the JAX arena: with an ``hbm``
quota broker installed (``tenancy/quota.py``), ``get`` charges the
calling tenant a slab class for the get-to-put lifetime, ``put``
releases it, and an over-quota tenant's slabs are the first spill
victims. The tables' locks are the JAX arena's named locks
(``hbm.buffer`` outer, ``hbm.manager`` inner, ``hbm.evict``), which the
lock-order detector (``analysis/lockorder.py``) watches when it is
enabled.
"""

from __future__ import annotations

import contextlib
import logging
import os
import tempfile
import threading
import time
import warnings
from typing import Dict, List, Optional

import numpy as np
import torch

from sparkrdma_tpu_torch.analysis.lockorder import named_lock
from sparkrdma_tpu_torch.obs import get_registry
from sparkrdma_tpu_torch.tenancy import current_tenant, tenant_scope
from sparkrdma_tpu_torch.tenancy import quota as _quota
from sparkrdma_tpu_torch.utils.torch_compat import resolve_device, torch_dtype

logger = logging.getLogger(__name__)

_M_POOL_HITS = get_registry().counter("hbm.pool_hits")
_M_POOL_MISSES = get_registry().counter("hbm.pool_misses")
_M_SPILL_VICTIMS = get_registry().counter("hbm.spill_victims")
_M_DISK_SPILLS = get_registry().counter("hbm.disk_spills")
_G_IN_USE = get_registry().gauge("hbm.in_use_bytes")

MIN_BLOCK_SIZE = 16 * 1024


def _size_class(nbytes: int) -> int:
    """Round up to a power of two, floored at MIN_BLOCK_SIZE."""
    n = max(nbytes, MIN_BLOCK_SIZE)
    return 1 << (n - 1).bit_length()


def host_tensor(a: np.ndarray) -> torch.Tensor:
    """A CPU tensor sharing ``a``'s memory. A read-only array (bytes
    from ``np.frombuffer``) is wrapped too; callers only read it."""
    if a.flags.writeable:
        return torch.from_numpy(a)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return torch.from_numpy(a)


class DeviceBuffer:
    """One pooled device slab plus the typed view of its contents.

    ``length`` is the caller-requested byte length; ``capacity`` the
    size-class slab length. ``array`` is the slab viewed in its staged
    dtype while device-resident, None while a lower tier holds the
    bytes; a spilled buffer climbs back on its next device use."""

    __slots__ = (
        "handle", "capacity", "length", "_slab", "_dtype", "_manager",
        "_host", "_disk", "_tier_lock", "last_use", "tenant", "_quota_tag",
    )

    def __init__(self, handle: int, capacity: int, slab: torch.Tensor,
                 manager: "DeviceBufferManager"):
        self.handle = handle
        self.capacity = capacity
        self.length = 0
        self._slab: Optional[torch.Tensor] = slab
        self._dtype = torch.uint8  # dtype of the staged contents
        self._manager = manager
        self._host: Optional[torch.Tensor] = None  # uint8, while in host tier
        self._disk = None  # spill-file path while in disk tier
        # serializes tier moves of this buffer; buffer lock OUTER,
        # manager lock inner (the JAX arena's ordering rules)
        self._tier_lock = named_lock("hbm.buffer", allow_self_nest=True)
        self.last_use = 0
        self.tenant = None  # owning tenant id (spill-victim preference)
        self._quota_tag = None  # (broker, tenant, cls) while charged

    @property
    def array(self) -> Optional[torch.Tensor]:
        if self._slab is None:
            return None
        return self._slab.view(self._dtype)

    @property
    def spilled(self) -> bool:
        return self._host is not None or self._disk is not None

    @property
    def on_disk(self) -> bool:
        return self._disk is not None

    @property
    def device(self) -> torch.device:
        return self._manager.device

    def spill_to_host(self) -> None:
        """Device -> host RAM; releases device budget, keeps the handle.
        The host-tier cascade runs after this buffer's lock is released
        (it may pick this very buffer)."""
        with self._tier_lock:
            if self._slab is None:
                return  # raced: someone else already moved it
            with self._manager._lock:
                if self.handle not in self._manager._handles:
                    return  # raced a free(): the slab is pooled again
            slab = self._slab
            host = torch.empty(
                slab.shape, dtype=torch.uint8, pin_memory=slab.is_cuda
            )
            host.copy_(slab)
            self._host = host
            self._slab = None
            self._manager._on_spill_accounting(self)
        self._manager._cascade_host_tier()

    def spill_to_disk(self) -> None:
        """Host RAM -> disk; releases host budget, keeps the handle."""
        with self._tier_lock:
            if self._host is None:
                return
            path = self._manager._disk_path(self.handle)
            self._host.numpy().tofile(path)
            self._disk = path
            self._host = None
            self._manager._on_disk_spill(self)

    def _ensure_host_locked(self) -> None:
        """Disk -> host RAM (tier lock held); budget rolls back if the
        spill file cannot be read."""
        if self._disk is None:
            return
        path = self._disk
        self._manager._reserve_host(self)
        try:
            host = np.fromfile(path, dtype=np.uint8, count=self.capacity)
            if host.shape[0] != self.capacity:
                raise IOError(f"spill file truncated: {path}")
        except BaseException:
            self._manager._unreserve_host(self)
            raise
        os.unlink(path)
        self._host = torch.from_numpy(host)
        self._disk = None

    def _climb_locked(self) -> None:
        """To device residency; tier lock held, self pinned."""
        if self._slab is not None:
            return
        if self._host is None and self._disk is None:
            return  # freed out from under a concurrent climb
        self._ensure_host_locked()
        self._manager._reserve_for_restore(self)
        host, self._host = self._host, None
        slab = torch.empty(self.capacity, dtype=torch.uint8,
                           device=self._manager.device)
        slab.copy_(host)
        self._slab = slab

    def ensure_device(self) -> "DeviceBuffer":
        """Restore a spilled buffer to device memory from whichever tier
        holds it, pinned for the climb so room-making never picks it."""
        if self._slab is not None:
            return self
        m = self._manager
        m._pin(self.handle)
        try:
            with self._tier_lock:
                self._climb_locked()
        finally:
            m._unpin(self.handle)
        return self

    def _write(self, src: torch.Tensor, dtype: torch.dtype) -> None:
        """Copy the uint8 tensor ``src`` into the slab's head IN PLACE,
        zero the tail and retype the contents; pinned and tier-locked
        so a concurrent spill cannot move the slab mid-write. A copy
        from pageable host memory has consumed its source when
        ``copy_`` returns, so callers may recycle the source."""
        n = src.shape[0]
        if n > self.capacity:
            raise ValueError(f"{n}B exceeds slab capacity {self.capacity}B")
        m = self._manager
        m._pin(self.handle)
        try:
            with self._tier_lock:
                self._climb_locked()
                self._slab[:n].copy_(src)
                if n < self.capacity:
                    self._slab[n:].zero_()
                self._dtype = dtype
        finally:
            m._unpin(self.handle)
        m._touch(self)

    def stage(self, data: bytes) -> "DeviceBuffer":
        """Host -> device: replace the slab contents (zero-padded)."""
        self._write(host_tensor(np.frombuffer(data, dtype=np.uint8)),
                    torch.uint8)
        self.length = len(data)
        return self

    def put_array(self, arr: torch.Tensor) -> "DeviceBuffer":
        """Write a 1-D tensor of any dtype as the slab contents
        (``length`` stays in BYTES; the tail is zeroed)."""
        if arr.ndim != 1:
            raise ValueError("slab contents must be 1-D")
        nbytes = arr.numel() * arr.element_size()
        if nbytes > self.capacity:
            raise ValueError("array exceeds slab capacity")
        self._write(arr.contiguous().view(torch.uint8), arr.dtype)
        self.length = nbytes
        return self

    def read(self, offset: int = 0, length: Optional[int] = None) -> bytes:
        """Readback of BYTES ``[offset, offset+length)`` from whichever
        tier holds the slab, regardless of the staged dtype."""
        if length is None:
            length = self.length - offset
        if offset < 0 or length < 0 or offset + length > self.capacity:
            raise ValueError("read out of slab bounds")
        with self._tier_lock:
            if self._disk is not None:
                mm = np.memmap(self._disk, dtype=np.uint8, mode="r",
                               shape=(self.capacity,))
                return mm[offset : offset + length].tobytes()
            if self._host is not None:
                return self._host[offset : offset + length].numpy().tobytes()
            self._manager._touch(self)
            return self._slab[offset : offset + length].cpu().numpy().tobytes()

    def free(self) -> None:
        self._manager.put(self)


class _AllocatorStack:
    """Per-size-class free stack with a cumulative allocation counter."""

    __slots__ = ("size", "stack", "total_alloc", "total_gets")

    def __init__(self, size: int):
        self.size = size
        self.stack: List[DeviceBuffer] = []
        self.total_alloc = 0
        self.total_gets = 0


class DeviceBufferManager:
    """Size-classed pool of device slabs for one device (``cuda`` unless
    the caller passes ``device="cpu"``)."""

    def __init__(self, device=None, max_bytes: int = 0, prealloc: int = 0,
                 prealloc_size: int = 0, max_host_bytes: int = 0,
                 spill_dir: Optional[str] = None):
        self.device = resolve_device(device)
        self.max_bytes = max_bytes  # 0 = unbounded
        self.max_host_bytes = max_host_bytes  # host tier cap; 0 = unbounded
        self._spill_dir = spill_dir
        self._run_token = os.urandom(4).hex()
        self._stacks: Dict[int, _AllocatorStack] = {}
        self._handles: Dict[int, DeviceBuffer] = {}
        self._next_handle = 1
        self._in_use_bytes = 0
        self._host_bytes = 0
        self._use_clock = 0
        self._spill_count = 0
        self._disk_spill_count = 0
        self._pins: Dict[int, int] = {}  # handle -> pin refcount
        self._pin_threads: Dict[int, List[int]] = {}  # handle -> owner idents
        # budget reserved by get() for slabs not yet in the handle table
        self._allocating = 0
        self._evict_cond = threading.Condition(named_lock("hbm.evict"))
        self._lock = named_lock("hbm.manager")
        self._stopped = False
        # optional warm-up (reference maxAggPrealloc,
        # RdmaBufferManager.java:84-91): ``prealloc`` slabs of
        # ``prealloc_size`` bytes' class, allocated and pooled
        if prealloc > 0 and prealloc_size > 0:
            bufs = [self.get(prealloc_size) for _ in range(prealloc)]
            for b in bufs:
                b.free()

    # ------------------------------------------------------------------
    def _touch(self, buf: DeviceBuffer) -> None:
        with self._lock:
            self._use_clock += 1
            buf.last_use = self._use_clock

    def _disk_path(self, handle: int) -> str:
        d = self._spill_dir or tempfile.gettempdir()
        return f"{d}/hbm-spill-{os.getpid()}-{self._run_token}-{handle}.bin"

    def _pin(self, handle: int) -> None:
        with self._lock:
            self._pins[handle] = self._pins.get(handle, 0) + 1
            self._pin_threads.setdefault(handle, []).append(
                threading.get_ident()
            )

    def _unpin(self, handle: int) -> None:
        with self._lock:
            c = self._pins.get(handle, 0) - 1
            if c > 0:
                self._pins[handle] = c
            else:
                self._pins.pop(handle, None)
            owners = self._pin_threads.get(handle)
            if owners:
                try:
                    owners.remove(threading.get_ident())
                except ValueError:
                    pass
                if not owners:
                    self._pin_threads.pop(handle, None)
        with self._evict_cond:
            self._evict_cond.notify_all()

    def _on_spill_accounting(self, buf: DeviceBuffer) -> None:
        with self._lock:
            self._in_use_bytes -= buf.capacity
            self._host_bytes += buf.capacity
            self._spill_count += 1
        _G_IN_USE.add(-buf.capacity)
        _M_SPILL_VICTIMS.inc()
        with self._evict_cond:
            self._evict_cond.notify_all()

    def _on_disk_spill(self, buf: DeviceBuffer) -> None:
        with self._lock:
            self._host_bytes -= buf.capacity
            self._disk_spill_count += 1
        _M_DISK_SPILLS.inc()

    def _pick_host_victim(self, exclude_handle: int) -> Optional[DeviceBuffer]:
        with self._lock:
            candidates = [
                b
                for b in self._handles.values()
                if b.handle != exclude_handle
                and b.handle not in self._pins
                and b._host is not None
            ]
            if not candidates:
                return None
            return min(candidates, key=lambda b: b.last_use)

    def _cascade_host_tier(self, exclude_handle: int = -1) -> None:
        """Push LRU host-tier residents to disk while over the host cap."""
        while True:
            with self._lock:
                if not self.max_host_bytes or self._host_bytes <= self.max_host_bytes:
                    return
            victim = self._pick_host_victim(exclude_handle)
            if victim is None:
                return
            victim.spill_to_disk()

    def _reserve_host(self, buf: DeviceBuffer) -> None:
        with self._lock:
            self._host_bytes += buf.capacity
        self._cascade_host_tier(exclude_handle=buf.handle)

    def _unreserve_host(self, buf: DeviceBuffer) -> None:
        with self._lock:
            self._host_bytes -= buf.capacity

    def _pick_spill_victim(self, pinned) -> Optional[DeviceBuffer]:
        with self._lock:
            candidates = [
                b
                for b in self._handles.values()
                if b.handle not in pinned
                and b.handle not in self._pins
                and not b.spilled
                and b._slab is not None
            ]
            if not candidates:
                return None
            broker = _quota.broker("hbm")
            if broker is not None:
                # an over-quota tenant's slabs go first: its own hoard
                # pays for the pressure it created, LRU breaks ties
                return min(
                    candidates,
                    key=lambda b: (
                        not (b.tenant and broker.over_quota(b.tenant)),
                        b.last_use,
                    ),
                )
            return min(candidates, key=lambda b: b.last_use)

    def _make_room(self, cls: int, pinned=frozenset()) -> None:
        """Spill LRU device-resident buffers (never a pinned one) until
        ``cls`` bytes fit. Waits while other threads' pins block the
        way; raises MemoryError when only this thread's pins do, or
        after a deadline."""
        me = threading.get_ident()
        deadline = time.monotonic() + 30.0
        while True:
            with self._lock:
                if not self.max_bytes or self._in_use_bytes + cls <= self.max_bytes:
                    return
            victim = self._pick_spill_victim(pinned)
            if victim is not None:
                victim.spill_to_host()
                continue
            with self._lock:
                foreign_pins = any(
                    self._handles.get(h) is not None
                    and any(t != me for t in self._pin_threads.get(h, ()))
                    for h in self._pins
                ) or self._allocating > 0
                in_use = self._in_use_bytes
            if not foreign_pins or time.monotonic() > deadline:
                raise MemoryError(
                    f"HBM shuffle budget exceeded: in-use {in_use}B + {cls}B "
                    f"> cap {self.max_bytes}B and nothing left to spill"
                )
            with self._evict_cond:
                self._evict_cond.wait(0.05)

    def _reserve_for_restore(self, buf: DeviceBuffer) -> None:
        self._make_room(buf.capacity, {buf.handle})
        with self._lock:
            self._in_use_bytes += buf.capacity
            self._host_bytes -= buf.capacity  # leaving the host tier
            self._use_clock += 1
            buf.last_use = self._use_clock
        _G_IN_USE.add(buf.capacity)

    @contextlib.contextmanager
    def pinned_on_device(self, bufs):
        """Pin a working set device-resident for the ``with`` body: every
        member is resident and never a spill victim there, so direct
        ``.array`` access is safe exactly for the body. Raises
        MemoryError up front if the set cannot fit the budget."""
        bufs = list(bufs)
        if self.max_bytes:
            need = sum(b.capacity for b in bufs)
            if need > self.max_bytes:
                raise MemoryError(
                    f"working set of {need}B cannot fit HBM budget "
                    f"{self.max_bytes}B; consume in smaller batches"
                )
        handles = [b.handle for b in bufs]
        for h in handles:
            self._pin(h)
        try:
            for b in bufs:
                b.ensure_device()
                self._touch(b)
            yield
        finally:
            for h in handles:
                self._unpin(h)

    @contextlib.contextmanager
    def pinned_if_resident(self, handle: int):
        """Pin ``handle`` for the block iff it is live AND still
        device-resident; yield the buffer, or None otherwise. Never
        climbs a spilled buffer back (the device fetch plane's
        eviction-race guard)."""
        try:
            buf = self.resolve(handle)
        except KeyError:
            yield None
            return
        self._pin(handle)
        try:
            if buf._slab is None or buf.spilled:
                yield None
            else:
                with self._lock:
                    live = self._handles.get(handle) is buf
                yield buf if live else None
        finally:
            self._unpin(handle)

    def ensure_device_all(self, bufs) -> None:
        """Restore a working set to device memory without the set
        victimizing itself. NOTE: protection ends when this returns:
        consumers that touch ``.array`` directly should hold
        ``pinned_on_device(bufs)`` across the access instead."""
        with self.pinned_on_device(bufs):
            pass

    def prefetch(self, bufs) -> threading.Event:
        """Start climbing ``bufs`` back toward the device on a
        background thread, overlapping tier restores with whatever the
        caller computes next. Returns an Event set when the pass
        finishes (success or not). The climb uses the same pinned
        restore as ``ensure_device_all`` (its slabs are allocated on
        the arena's explicit device, so the thread needs no current
        device); consumers still wrap their access in
        ``pinned_on_device`` (a fast no-op once prefetched). Best
        effort: under budget pressure later traffic may re-spill."""
        bufs = list(bufs)
        done = threading.Event()
        # the climb re-spills victims and re-charges restores under the
        # CALLER's tenant, so the background thread must re-enter its
        # scope; otherwise the work bills the default tenant
        tenant = current_tenant()

        def run():
            with tenant_scope(tenant):
                try:
                    self.ensure_device_all(bufs)
                except Exception:
                    logger.exception("device prefetch pass failed")
                finally:
                    done.set()

        threading.Thread(target=run, daemon=True, name="hbm-prefetch").start()
        return done

    def get(self, nbytes: int) -> DeviceBuffer:
        """Allocate (or reuse) a slab whose class covers ``nbytes``;
        under budget pressure LRU slabs spill to host first,
        MemoryError only when nothing is spillable.

        When an hbm quota broker is installed, the tenant's charge
        gates the allocation — an over-quota tenant blocks here, on
        its own worker thread, until its earlier slabs are put back
        (capacity is charged for the get→put lifetime, so spilling a
        slab to host does NOT un-block its tenant)."""
        broker = _quota.broker("hbm")
        if broker is None:
            return self._get_slab(nbytes, None)
        tenant = current_tenant()
        cls = _size_class(nbytes)
        broker.charge(tenant, cls)
        try:
            buf = self._get_slab(nbytes, tenant)
        except BaseException:
            broker.release(tenant, cls)
            raise
        buf._quota_tag = (broker, tenant, cls)
        return buf

    def _get_slab(self, nbytes: int, tenant) -> DeviceBuffer:
        cls = _size_class(nbytes)
        with self._lock:
            if self._stopped:
                raise RuntimeError("DeviceBufferManager is stopped")
            stack = self._stacks.setdefault(cls, _AllocatorStack(cls))
            stack.total_gets += 1
            pooled = stack.stack.pop() if stack.stack else None
            if pooled is not None:
                pooled.length = nbytes
                pooled.tenant = tenant
                pooled._quota_tag = None
                self._in_use_bytes += cls
                self._handles[pooled.handle] = pooled
                self._use_clock += 1
                pooled.last_use = self._use_clock
        if pooled is not None:
            _M_POOL_HITS.inc()
            _G_IN_USE.add(cls)
            self._make_room(0, {pooled.handle})
            return pooled
        _M_POOL_MISSES.inc()
        self._make_room(cls)
        with self._lock:
            handle = self._next_handle
            self._next_handle += 1
            stack.total_alloc += 1
            self._in_use_bytes += cls
            self._allocating += 1
        _G_IN_USE.add(cls)
        try:
            buf = self._materialize(handle, cls, nbytes)
            buf.tenant = tenant
            return buf
        finally:
            with self._lock:
                self._allocating -= 1
            with self._evict_cond:
                self._evict_cond.notify_all()

    def _materialize(self, handle: int, cls: int, nbytes: int) -> DeviceBuffer:
        slab = torch.zeros(cls, dtype=torch.uint8, device=self.device)
        buf = DeviceBuffer(handle, cls, slab, self)
        buf.length = nbytes
        with self._lock:
            self._handles[handle] = buf
            self._use_clock += 1
            buf.last_use = self._use_clock
        return buf

    def put_at(self, handle: int, arr: torch.Tensor, length: int) -> DeviceBuffer:
        """Stage ``arr`` into a new slab under a GIVEN handle (the handle
        another arena published), with ``length`` payload bytes. Raises
        if the handle is live."""
        cls = _size_class(arr.numel() * arr.element_size())
        with self._lock:
            if self._stopped:
                raise RuntimeError("DeviceBufferManager is stopped")
            if handle in self._handles:
                raise ValueError(f"handle {handle} is live")
        self._make_room(cls)
        with self._lock:
            stack = self._stacks.setdefault(cls, _AllocatorStack(cls))
            stack.total_alloc += 1
            stack.total_gets += 1
            self._next_handle = max(self._next_handle, handle + 1)
            self._in_use_bytes += cls
        _G_IN_USE.add(cls)
        buf = self._materialize(handle, cls, length)
        buf.put_array(arr)
        buf.length = length
        return buf

    def put(self, buf: DeviceBuffer) -> None:
        """Return a slab to its class stack (a double free is a no-op)."""
        with buf._tier_lock:
            with self._lock:
                if self._handles.pop(buf.handle, None) is None:
                    return
                # freeing while pinned is a caller bug; don't let the
                # stale pin shield a recycled slab from eviction forever
                self._pins.pop(buf.handle, None)
                self._pin_threads.pop(buf.handle, None)
                if buf.spilled:
                    if buf._host is not None:
                        self._host_bytes -= buf.capacity
                        buf._host = None
                    disk, buf._disk = buf._disk, None
                else:
                    disk = None
            tag, buf._quota_tag = buf._quota_tag, None
            if tag is not None:
                # held-capacity quota retires with the slab, whatever
                # tier the bytes ended up in
                tag[0].release(tag[1], tag[2])
            if disk is not None:
                try:
                    os.unlink(disk)
                except OSError:
                    pass
            if buf._slab is None:
                return
            with self._lock:
                self._in_use_bytes -= buf.capacity
                stopped = self._stopped
                if stopped:
                    buf._slab = None
                else:
                    self._stacks[buf.capacity].stack.append(buf)
            _G_IN_USE.add(-buf.capacity)
            with self._evict_cond:
                self._evict_cond.notify_all()
            if not stopped:
                buf.length = 0

    def resolve(self, handle: int) -> DeviceBuffer:
        """Handle table lookup — the mkey/rkey resolution analogue."""
        with self._lock:
            buf = self._handles.get(handle)
        if buf is None:
            raise KeyError(f"no live device buffer for handle {handle}")
        return buf

    def stage_bytes(self, data: bytes) -> DeviceBuffer:
        """Pool + stage in one step (host bytes -> device slab)."""
        return self.get(len(data)).stage(data)

    def stage_view(self, view, valid_len: Optional[int] = None,
                   dtype=np.uint8) -> DeviceBuffer:
        """Pool + stage from a buffer-protocol object (bytes, memoryview,
        a contiguous numpy array) with one host-to-device copy into the
        slab. ``valid_len`` (default: the whole view) is the byte length
        of the real contents; up to a slab class of the source rides
        along and the rest is zeroed. ``dtype`` types the staged bytes
        (e.g. uint32 keys a device merge consumes directly). The copy
        has finished reading the source when this returns, so callers
        may recycle it. It must stay synchronous: mapped delivery
        (``shuffle/device_io.py``) unmaps the page-cache window right
        after this returns, so a ``non_blocking`` copy here would unmap
        it under an in-flight transfer."""
        src = np.frombuffer(view, dtype=np.uint8)
        n = src.nbytes if valid_len is None else valid_len
        buf = self.get(n)
        k = min(src.nbytes, buf.capacity)
        try:
            buf._write(host_tensor(src[:k]), torch_dtype(dtype))
        except BaseException:
            buf.free()
            raise
        buf.length = n
        return buf

    # ------------------------------------------------------------------
    @property
    def in_use_bytes(self) -> int:
        with self._lock:
            return self._in_use_bytes

    @property
    def spill_count(self) -> int:
        with self._lock:
            return self._spill_count

    @property
    def disk_spill_count(self) -> int:
        with self._lock:
            return self._disk_spill_count

    @property
    def host_bytes(self) -> int:
        with self._lock:
            return self._host_bytes

    def stats(self) -> Dict[int, Dict[str, int]]:
        with self._lock:
            return {
                size: {
                    "total_alloc": s.total_alloc,
                    "total_gets": s.total_gets,
                    "pooled": len(s.stack),
                }
                for size, s in self._stacks.items()
            }

    def stop(self) -> None:
        """Free everything; log per-class stats."""
        with self._lock:
            if self._stopped:
                return
            self._stopped = True
            stacks = list(self._stacks.values())
            leaked = list(self._handles.values())
        for s in stacks:
            if s.total_alloc:
                logger.info(
                    "hbm pool class %dB: allocated %d, gets %d, pooled %d",
                    s.size, s.total_alloc, s.total_gets, len(s.stack),
                )
            for buf in s.stack:
                buf._slab = None
            s.stack.clear()
        for buf in leaked:
            logger.warning("hbm slab handle %d leaked (freeing)", buf.handle)
            buf._slab = None
            buf._host = None
            if buf._disk is not None:
                try:
                    os.unlink(buf._disk)
                except OSError:
                    pass
                buf._disk = None
