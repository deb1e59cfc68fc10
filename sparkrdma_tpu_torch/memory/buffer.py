"""TpuBuffer — one off-heap, optionally-registered allocation.

TPU-native analogue of RdmaBuffer.java (reference: RdmaBuffer.java). The reference
allocates off-JVM-heap memory with ``sun.misc.Unsafe.allocateMemory``
(:55-64), optionally registers it as an RDMA memory region with
LOCAL_WRITE|REMOTE_WRITE|REMOTE_READ access (:81-88), and wraps the raw
address as a DirectByteBuffer (:114-136).

Here the allocation is an anonymous ``mmap`` (page-aligned, outside the
Python object heap): ``mmap.close()`` refuses to free while exported
sub-views (open streams) exist, which makes ``free()`` leak-safe instead
of use-after-free under still-open readers. Registration inserts the
region into the endpoint's
:class:`~sparkrdma_tpu_torch.memory.registry.ProtectionDomain`, yielding
the ``mkey`` used by remote one-sided READs.

A copy of the JAX package's ``memory/buffer.py`` on its pure-Python
path. The JAX buffer has two more backings, both for its native plane:
the native C++ arena (``arena=True``) and ``/dev/shm`` files that the
native transport serves by ``pread``. The port's python transport uses
neither (its ProtectionDomain takes no file regions), so ``arena=True``
takes the anonymous mapping too until ROADMAP item M4b ports the native
plane.
"""

from __future__ import annotations

import mmap
from typing import Optional

from sparkrdma_tpu_torch.memory.registry import ProtectionDomain


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
            raise ValueError("registration requested but no ProtectionDomain")
        self.length = length
        del arena  # the native arena is ROADMAP M4b; scratch maps anonymously
        self._mmap: Optional[mmap.mmap] = mmap.mmap(-1, length)
        view = memoryview(self._mmap)
        self._view: Optional[memoryview] = view
        self._pd = pd
        self.mkey = 0
        if register:
            self.mkey = pd.register(view)
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
        if self._mmap is not None:
            try:
                self._mmap.close()
            except BufferError:
                # live sub-views (unclosed streams): the mapping stays
                # until they die — leak-safe, never use-after-free
                pass
            self._mmap = None

    def __len__(self) -> int:
        return self.length
