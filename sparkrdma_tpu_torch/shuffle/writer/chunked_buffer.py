"""Growable chunked byte buffers over fixed-size scratch allocations.

Analogues of RdmaChunkedByteBuffer.scala and
RdmaChunkedByteBufferOutputStream.scala (reference: writer/chunkedpartitionagg/).
An output stream grows by fixed-size **unregistered** chunks (:38-41),
supports chunk recycling across flushes (:28-32), and converts one-shot
into an immutable chunk list, freeing unused chunks (:81-100).

A copy of the JAX package's ``shuffle/writer/chunked_buffer.py``, its imports
rewritten to this package. Its chunks ask for ``arena=True``, the
port's native C++ arena (``native/arena.cpp``), whose ``free()`` is
unconditional; where g++ cannot build it, ``memory/buffer.py`` maps the
chunk anonymously.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

from sparkrdma_tpu_torch.memory.buffer import TpuBuffer
from sparkrdma_tpu_torch.obs import get_registry

_M_CHUNK_ALLOCS = get_registry().counter("writer.chunk_allocations")
_M_CHUNK_RECYCLES = get_registry().counter("writer.chunk_recycles")


class ChunkedByteBuffer:
    """Immutable view over (buffer, used_length) chunk list (:45)."""

    def __init__(self, chunks: List[Tuple[TpuBuffer, int]]):
        self._chunks = chunks

    @property
    def length(self) -> int:
        return sum(used for _, used in self._chunks)

    def get_chunks(self) -> List[memoryview]:
        return [buf.view[:used] for buf, used in self._chunks]

    def take_buffers(self) -> List[Tuple[TpuBuffer, int]]:
        """Hand off ownership of the underlying chunks (for recycling)."""
        chunks, self._chunks = self._chunks, []
        return chunks

    def dispose(self) -> None:
        for buf, _ in self._chunks:
            buf.free()
        self._chunks = []


class ChunkedByteBufferOutputStream:
    """OutputStream over a growable list of fixed-size scratch chunks."""

    def __init__(
        self,
        chunk_size: int,
        allocate: Optional[Callable[[int], TpuBuffer]] = None,
        recycled: Optional[List[TpuBuffer]] = None,
    ):
        self.chunk_size = chunk_size
        # chunk scratch is framework-owned (copied out at flush, freed or
        # recycled by the writer; no consumer view outlives it) — the
        # native C++ arena's unconditional free is safe here, and this is
        # the serialize-hot-path the reference used Unsafe.allocateMemory
        # for (RdmaBuffer.java:55-64)
        self._allocate = allocate or (
            lambda n: TpuBuffer(None, n, register=False, arena=True)
        )
        self._recycled = recycled or []
        self._chunks: List[TpuBuffer] = []
        self._pos_in_chunk = 0
        self._closed = False

    @property
    def length(self) -> int:
        if not self._chunks:
            return 0
        return (len(self._chunks) - 1) * self.chunk_size + self._pos_in_chunk

    def write(self, data) -> int:
        if self._closed:
            raise ValueError("stream closed")
        mv = memoryview(data) if not isinstance(data, memoryview) else data
        written = 0
        while written < len(mv):
            if not self._chunks or self._pos_in_chunk == self.chunk_size:
                if self._recycled:
                    _M_CHUNK_RECYCLES.inc()
                    self._chunks.append(self._recycled.pop())
                else:
                    _M_CHUNK_ALLOCS.inc()
                    self._chunks.append(self._allocate(self.chunk_size))
                self._pos_in_chunk = 0
            chunk = self._chunks[-1]
            n = min(len(mv) - written, self.chunk_size - self._pos_in_chunk)
            chunk.view[self._pos_in_chunk : self._pos_in_chunk + n] = mv[
                written : written + n
            ]
            self._pos_in_chunk += n
            written += n
        return written

    def to_chunked_byte_buffer(self) -> ChunkedByteBuffer:
        """One-shot conversion; frees nothing here (all chunks are used)."""
        if self._closed:
            raise ValueError("already converted")
        self._closed = True
        out: List[Tuple[TpuBuffer, int]] = []
        for i, chunk in enumerate(self._chunks):
            used = self.chunk_size if i < len(self._chunks) - 1 else self._pos_in_chunk
            if used:
                out.append((chunk, used))
            else:
                chunk.free()
        self._chunks = []
        return ChunkedByteBuffer(out)
