"""RegisteredBuffer — ref-counted slicing over one pooled buffer.

TPU-native analogue of RdmaRegisteredBuffer.java (reference: RdmaRegisteredBuffer.java). Carves sequential slices out of one pooled
:class:`TpuBuffer` with a bump pointer (:79-107); when the refcount
drops to zero the underlying buffer returns to the pool (:52-69).

A copy of the JAX package's ``memory/registered_buffer.py``, its imports
rewritten to this package.
"""

from __future__ import annotations

import threading
from typing import Optional

from sparkrdma_tpu_torch.memory.buffer import TpuBuffer
from sparkrdma_tpu_torch.memory.buffer_manager import TpuBufferManager


class RegisteredBuffer:
    def __init__(self, manager: TpuBufferManager, length: int):
        self._manager = manager
        self._buffer: Optional[TpuBuffer] = manager.get(length)
        self._lock = threading.Lock()
        self._refcount = 0
        self._block_offset = 0

    @property
    def mkey(self) -> int:
        assert self._buffer is not None
        return self._buffer.mkey

    @property
    def capacity(self) -> int:
        assert self._buffer is not None
        return self._buffer.length

    def retain(self) -> None:
        with self._lock:
            self._refcount += 1

    def release(self) -> None:
        with self._lock:
            self._refcount -= 1
            if self._refcount > 0:
                return
            buf, self._buffer = self._buffer, None
        if buf is not None:
            self._manager.put(buf)

    def ref_count(self) -> int:
        with self._lock:
            return self._refcount

    def slice(self, length: int) -> "BufferSlice":
        """Carve the next `length` bytes; caller holds one reference."""
        with self._lock:
            if self._buffer is None:
                raise ValueError("buffer already released")
            offset = self._block_offset
            if offset + length > self._buffer.length:
                raise ValueError(
                    f"slice of {length} bytes exceeds remaining capacity "
                    f"({self._buffer.length - offset})"
                )
            self._block_offset += length
            view = self._buffer.view[offset : offset + length]
            self._refcount += 1
        return BufferSlice(self, view, offset, length)


class BufferSlice:
    """One carved slice; address/mkey visible for location publication.

    Analogue of RdmaByteBufferManagedBuffer (reference
    RdmaByteBufferManagedBuffer.java — getAddress/getLkey/getLength plus
    retain/release delegation).
    """

    def __init__(self, owner: RegisteredBuffer, view: memoryview, offset: int, length: int):
        self._owner = owner
        self.view = view
        self.address = offset  # offset within the registered region
        self.length = length

    @property
    def mkey(self) -> int:
        return self._owner.mkey

    def retain(self) -> None:
        self._owner.retain()

    def release(self) -> None:
        self._owner.release()
