"""Writer storage blocks: registered memory or registered file-backed.

Analogue of RdmaWriterBlock.scala (reference: writer/chunkedpartitionagg/
RdmaWriterBlock.scala): a block SPI with two implementations —
``MemoryWriterBlock`` over a registered buffer (:39-93) and
``FileWriterBlock`` over a registered mapping of a scratch file
(:95-149). Both track the actual readable length and emit
``(address, length, mkey)`` locations for remote one-sided READ.

A copy of the JAX package's ``shuffle/writer/blocks.py``, its imports
rewritten to this package.
"""

from __future__ import annotations

import mmap
import os
import threading
from typing import BinaryIO

from sparkrdma_tpu_torch.locations import BlockLocation
from sparkrdma_tpu_torch.memory.buffer import TpuBuffer
from sparkrdma_tpu_torch.memory.registry import ProtectionDomain
from sparkrdma_tpu_torch.memory.streams import MemoryviewInputStream


class WriterBlock:
    """Append-only fixed-capacity storage block."""

    capacity: int

    def remaining(self) -> int:
        raise NotImplementedError

    def append(self, data) -> int:
        """Append up to remaining() bytes; returns bytes written."""
        raise NotImplementedError

    def location(self) -> BlockLocation:
        raise NotImplementedError

    def input_stream(self) -> BinaryIO:
        raise NotImplementedError

    def dispose(self) -> None:
        raise NotImplementedError


class MemoryWriterBlock(WriterBlock):
    def __init__(self, pd: ProtectionDomain, capacity: int):
        self.capacity = capacity
        self._buf = TpuBuffer(pd, capacity)
        self._len = 0
        self._lock = threading.Lock()

    def remaining(self) -> int:
        with self._lock:
            return self.capacity - self._len

    def append(self, data) -> int:
        with self._lock:
            n = min(len(data), self.capacity - self._len)
            if n:
                self._buf.view[self._len : self._len + n] = data[:n]
                self._len += n
            return n

    def location(self) -> BlockLocation:
        with self._lock:
            return BlockLocation(0, self._len, self._buf.mkey)

    def input_stream(self) -> BinaryIO:
        with self._lock:
            return MemoryviewInputStream(self._buf.view[: self._len])

    def dispose(self) -> None:
        self._buf.free()


class FileWriterBlock(WriterBlock):
    """Scratch-file block, mmap'd read-write and registered.

    The reference creates the file through diskBlockManager and maps it
    with RdmaMappedFile (:95-149); here the rw mapping itself is the
    registered region, so appended bytes are immediately remotely
    readable.
    """

    def __init__(self, pd: ProtectionDomain, capacity: int, path: str):
        self.capacity = capacity
        self.path = path
        self._pd = pd
        with open(path, "wb") as f:
            f.truncate(capacity)
        self._file = open(path, "r+b")
        self._mm = mmap.mmap(self._file.fileno(), capacity)
        self._view = memoryview(self._mm)
        self._mkey = pd.register(self._view)
        self._len = 0
        self._lock = threading.Lock()

    def remaining(self) -> int:
        with self._lock:
            return self.capacity - self._len

    def append(self, data) -> int:
        with self._lock:
            n = min(len(data), self.capacity - self._len)
            if n:
                self._view[self._len : self._len + n] = data[:n]
                self._len += n
            return n

    def location(self) -> BlockLocation:
        with self._lock:
            return BlockLocation(0, self._len, self._mkey)

    def input_stream(self) -> BinaryIO:
        with self._lock:
            return MemoryviewInputStream(self._view[: self._len])

    def dispose(self) -> None:
        self._pd.deregister(self._mkey)
        try:
            self._view.release()
            self._mm.close()
        except BufferError:
            pass  # live sub-views keep the mapping alive until GC
        self._file.close()
        try:
            os.unlink(self.path)
        except OSError:
            pass
