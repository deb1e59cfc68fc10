"""Zero-copy streams over memoryviews.

Analogue of ByteBufferBackedInputStream / ByteBufferBackedOutputStream
(reference: ByteBufferBacked{Input,Output}Stream.java) — minimal stream shims used
by RPC serialization and partition reads, without copying the
underlying registered memory.

A copy of the JAX package's ``memory/streams.py``, its imports
rewritten to this package.
"""

from __future__ import annotations

import io
from typing import Optional


class MemoryviewInputStream(io.RawIOBase):
    def __init__(self, view: memoryview, on_close=None):
        self._view: Optional[memoryview] = view
        self._pos = 0
        self._on_close = on_close

    def readable(self) -> bool:
        return True

    def readinto(self, b) -> int:
        if self._view is None:
            raise ValueError("read on closed stream")
        n = min(len(b), len(self._view) - self._pos)
        if n <= 0:
            return 0
        b[:n] = self._view[self._pos : self._pos + n]
        self._pos += n
        return n

    def read(self, size: int = -1) -> bytes:
        if self._view is None:
            raise ValueError("read on closed stream")
        if size is None or size < 0:
            size = len(self._view) - self._pos
        n = min(size, len(self._view) - self._pos)
        out = bytes(self._view[self._pos : self._pos + n])
        self._pos += n
        return out

    def read_view(self, size: int = -1) -> memoryview:
        """Zero-copy ``read``: a memoryview slice of the backing buffer
        instead of a bytes copy. The slice is only guaranteed valid
        until :meth:`close` — the backing registered buffer / mapped
        window recycles then — so consumers must finish decoding
        (decompress / deserialize) before closing the stream.
        """
        if self._view is None:
            raise ValueError("read on closed stream")
        if size is None or size < 0:
            size = len(self._view) - self._pos
        n = min(size, len(self._view) - self._pos)
        out = self._view[self._pos : self._pos + n]
        self._pos += n
        return out

    def close(self) -> None:
        # release the exported view eagerly so the owning buffer/mapping
        # can be freed deterministically at dispose time
        view, self._view = self._view, None
        if view is not None:
            view.release()
        if not self.closed and self._on_close is not None:
            cb, self._on_close = self._on_close, None
            cb()
        super().close()


class MemoryviewOutputStream(io.RawIOBase):
    def __init__(self, view: memoryview):
        self._view = view
        self._pos = 0

    def writable(self) -> bool:
        return True

    def write(self, b) -> int:
        n = len(b)
        if self._pos + n > len(self._view):
            raise ValueError("write past end of buffer")
        self._view[self._pos : self._pos + n] = b
        self._pos += n
        return n

    @property
    def position(self) -> int:
        return self._pos
