"""TpuBuffer — one off-heap, optionally-registered allocation.

TPU-native analogue of RdmaBuffer.java (reference: RdmaBuffer.java). The reference
allocates off-JVM-heap memory with ``sun.misc.Unsafe.allocateMemory``
(:55-64), optionally registers it as an RDMA memory region with
LOCAL_WRITE|REMOTE_WRITE|REMOTE_READ access (:81-88), and wraps the raw
address as a DirectByteBuffer (:114-136).

Here the allocation is an anonymous ``mmap`` (page-aligned, outside the
Python object heap) by default: ``mmap.close()`` refuses to free while
exported sub-views (open streams) exist, which makes ``free()``
leak-safe instead of use-after-free under still-open readers. The
native C++ arena (sparkrdma_tpu_torch.native) backs allocations whose
lifetime the framework fully controls (``arena=True`` — staging copies,
bench buffers); its ``free()`` is unconditional, so it must never be
handed to consumer-owned streams. Registration inserts the region into
the endpoint's :class:`~sparkrdma_tpu_torch.memory.registry.ProtectionDomain`,
yielding the ``mkey`` used by remote one-sided READs.

A copy of the JAX package's ``memory/buffer.py``, its imports rewritten
to this package, with one addition: :func:`backing_counts` counts the
allocations by backing, so a ``/dev/shm`` that is too small (the slab
falls back to anonymous memory, and the same-host fast path never
engages) cannot pass unseen. The ``srt-<pid>-<hex>`` names are the JAX
package's, so the two packages' sweeps of dead owners' files never
remove a live file of the other.
"""

from __future__ import annotations

import atexit
import mmap
import os
import secrets
import threading
from typing import Optional

from sparkrdma_tpu_torch.memory.registry import ProtectionDomain
from sparkrdma_tpu_torch.native.arena import NativeArena, native_arena_available

# Registered buffers are backed by /dev/shm files when possible so the
# native transport can advertise a (path, offset) same-host fast path
# (peers pread the bytes from page cache instead of streaming them).
# Unguessable names prevent cross-host path collisions: a peer that can
# open the path IS on this host. Files unlink on free() and at normal
# exit (atexit). atexit does NOT run on SIGKILL/OOM, so names embed the
# owning pid and every import sweeps files whose owner is gone — a
# crashed executor's slabs are reclaimed by the next one on the host.
_SHM_DIR = "/dev/shm"
_shm_files: set = set()
_shm_lock = threading.Lock()

# allocations by backing since import: "arena" (native arena),
# "shm" (/dev/shm slab), "shm_fallback" (a slab whose posix_fallocate or
# mmap failed, ENOSPC on a small /dev/shm, so anonymous memory instead)
# and "anonymous"
_backings = {"arena": 0, "shm": 0, "shm_fallback": 0, "anonymous": 0}


def _count_backing(kind: str) -> None:
    with _shm_lock:
        _backings[kind] += 1


def backing_counts() -> dict:
    """Allocations by backing since import (see ``_backings``)."""
    with _shm_lock:
        return dict(_backings)


def _sweep_shm_files() -> None:
    with _shm_lock:
        leftover = list(_shm_files)
        _shm_files.clear()
    for path in leftover:
        try:
            os.unlink(path)
        except OSError:
            pass


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
        return True
    except ProcessLookupError:
        return False
    except PermissionError:
        return True


def sweep_stale_shm_files() -> int:
    """Unlink srt shm files (buffer slabs + native host-proof tokens)
    whose owning process no longer exists. Returns the count removed."""
    removed = 0
    try:
        names = os.listdir(_SHM_DIR)
    except OSError:
        return 0
    for name in names:
        pid = None
        if name.startswith("srt-host-"):
            parts = name.split("-")  # srt-host-<pid>-<hex>
            if len(parts) >= 4 and parts[2].isdigit():
                pid = int(parts[2])
        elif name.startswith("srt-"):
            parts = name.split("-")  # srt-<pid>-<hex>
            if len(parts) >= 3 and parts[1].isdigit():
                pid = int(parts[1])
        if pid is None or pid == os.getpid() or _pid_alive(pid):
            continue
        try:
            os.unlink(os.path.join(_SHM_DIR, name))
            removed += 1
        except OSError:
            pass
    return removed


atexit.register(_sweep_shm_files)
sweep_stale_shm_files()


def _shm_usable() -> bool:
    return os.path.isdir(_SHM_DIR) and os.access(_SHM_DIR, os.W_OK)


class TpuBuffer:
    """A single allocation with optional PD registration."""

    def __init__(
        self,
        pd: Optional[ProtectionDomain],
        length: int,
        register: bool = True,
        arena: bool = False,
    ):
        if length <= 0:
            raise ValueError(f"buffer length must be positive, got {length}")
        if register and pd is None:
            # validate before allocating: a failed constructor must not
            # leave an shm file behind (free() never runs on it)
            raise ValueError("registration requested but no ProtectionDomain")
        self.length = length
        self._arena: Optional[NativeArena] = None
        self._mmap: Optional[mmap.mmap] = None
        self._shm_path: Optional[str] = None
        if arena and native_arena_available():
            self._arena = NativeArena.shared()
            self._alloc_id, view = self._arena.alloc(length)
            _count_backing("arena")
        elif (
            register
            and getattr(pd, "supports_file_regions", False)
            and _shm_usable()
        ):
            path = os.path.join(
                _SHM_DIR, f"srt-{os.getpid()}-{secrets.token_hex(16)}"
            )
            fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_RDWR, 0o600)
            shm_stat = None
            try:
                # posix_fallocate actually reserves tmpfs pages (ENOSPC
                # now) where a sparse ftruncate would SIGBUS on first
                # write past a small container /dev/shm
                os.posix_fallocate(fd, 0, length)
                self._mmap = mmap.mmap(fd, length, mmap.MAP_SHARED)
                # identity of the SAME inode the mapping covers, for the
                # native fast path's registration (never a path re-stat)
                shm_stat = os.fstat(fd)
                os.close(fd)
            except OSError:
                os.close(fd)
                os.unlink(path)
                # fall back to anonymous memory (no fast path, no SIGBUS)
                self._mmap = mmap.mmap(-1, length)
                path = None
            self._shm_path = path
            if path is not None:
                with _shm_lock:
                    _shm_files.add(path)
            _count_backing("shm" if path is not None else "shm_fallback")
            view = memoryview(self._mmap)
        else:
            self._mmap = mmap.mmap(-1, length)
            _count_backing("anonymous")
            view = memoryview(self._mmap)
        self._view: Optional[memoryview] = view
        self._pd = pd
        self.mkey = 0
        if register:
            # slabs are rewritten in place across pooled reuses; their
            # shm file pages ARE this memory, so the backing is declared
            # mutable (identity = dev/ino; content can't diverge)
            self.mkey = pd.register(
                view, file_path=self._shm_path, file_offset=0,
                file_mutable=True,
                file_stat=shm_stat if self._shm_path else None,
            )
        self._freed = False

    # -- accessors --------------------------------------------------------
    @property
    def view(self) -> memoryview:
        if self._freed:
            raise ValueError("buffer already freed")
        assert self._view is not None
        return self._view

    @property
    def address(self) -> int:
        """Base offset of this buffer within its own region: always 0.

        The reference exposes the raw virtual address (RdmaBuffer.java:70);
        here addresses in :class:`BlockLocation` are offsets relative to
        the registered region identified by ``mkey``.
        """
        return 0

    def write(self, data, offset: int = 0) -> None:
        """Copy bytes in (reference Unsafe.copyMemory path, :101-112)."""
        n = len(data)
        self.view[offset : offset + n] = bytes(data) if not isinstance(
            data, (bytes, bytearray, memoryview)
        ) else data

    def read(self, offset: int = 0, length: Optional[int] = None) -> bytes:
        if length is None:
            length = self.length - offset
        return bytes(self.view[offset : offset + length])

    # -- lifecycle --------------------------------------------------------
    def free(self) -> None:
        if self._freed:
            return
        self._freed = True
        if getattr(self, "_mempool_charge", None) is not None:
            # pool-tagged buffer retired without passing through
            # TpuBufferManager.put — release its accounting here so the
            # tenant quota and in-use gauge never leak (tag is only
            # ever set by the manager, so the module is loaded)
            from sparkrdma_tpu_torch.memory.buffer_manager import release_charge

            release_charge(self)
        if self._pd is not None and self.mkey:
            self._pd.deregister(self.mkey)
        view, self._view = self._view, None
        if view is not None:
            view.release()
        if self._arena is not None:
            # arena memory is framework-owned; no consumer views may
            # outlive it (see class docstring), so the free is immediate
            self._arena.free(self._alloc_id)
            self._arena = None
        if self._mmap is not None:
            try:
                self._mmap.close()
            except BufferError:
                # live sub-views (unclosed streams): the mapping stays
                # until they die — leak-safe, never use-after-free
                pass
            self._mmap = None
        if self._shm_path is not None:
            with _shm_lock:
                _shm_files.discard(self._shm_path)
            try:
                os.unlink(self._shm_path)
            except OSError:
                pass
            self._shm_path = None

    def __len__(self) -> int:
        return self.length
