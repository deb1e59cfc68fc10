"""PartitionWriter — per-(shuffle, partition) append-only block log.

Analogue of RdmaShufflePartitionWriter.scala (reference: writer/
chunkedpartitionagg/RdmaShufflePartitionWriter.scala). Semantics
preserved:

- storage is a list of ``shuffle_write_block_size`` blocks; new blocks
  are **memory** while the executor-wide in-memory budget admits them,
  else **file-backed** scratch blocks (:42-52),
- bump-pointer offset allocation under a lock so concurrent map tasks
  append without interleaving corruption (:54-72),
- exposes every block's ``(address, length, mkey)`` location and local
  input streams (:109-122).

A copy of the JAX package's ``shuffle/writer/partition_writer.py``, its imports
rewritten to this package.
"""

from __future__ import annotations

import threading
from typing import BinaryIO, List

from sparkrdma_tpu_torch.locations import BlockLocation
from sparkrdma_tpu_torch.memory.registry import ProtectionDomain
from sparkrdma_tpu_torch.obs import get_registry
from sparkrdma_tpu_torch.shuffle.writer.blocks import (
    FileWriterBlock,
    MemoryWriterBlock,
    WriterBlock,
)

_M_MEM_BLOCKS = get_registry().counter("writer.blocks_memory")
_M_SPILL_BLOCKS = get_registry().counter("writer.blocks_spilled")
_M_SPILL_BYTES = get_registry().counter("writer.spill_bytes")


class PartitionWriter:
    def __init__(self, resolver, shuffle_id: int, partition_id: int, block_size: int):
        self._resolver = resolver
        self.shuffle_id = shuffle_id
        self.partition_id = partition_id
        self.block_size = block_size
        self._blocks: List[WriterBlock] = []
        self._lock = threading.Lock()

    def _add_block(self, capacity: int) -> WriterBlock:
        """Memory while under budget, else spill to a scratch file (:42-52)."""
        pd: ProtectionDomain = self._resolver.pd
        if self._resolver.reserve_inmemory_bytes(capacity):
            block = MemoryWriterBlock(pd, capacity)
            block.reserved_bytes = capacity
            _M_MEM_BLOCKS.inc()
            return block
        path = self._resolver.scratch_path(
            f"shuffle_{self.shuffle_id}_p{self.partition_id}_b{len(self._blocks)}"
        )
        block = FileWriterBlock(pd, capacity, path)
        block.reserved_bytes = 0
        _M_SPILL_BLOCKS.inc()
        _M_SPILL_BYTES.inc(capacity)
        return block

    def append_frame(self, framed) -> int:
        """Append one self-delimiting frame, never spanning blocks.

        Frame alignment is a deliberate departure from the reference
        (whose chunked-agg read path could split a compressed stream
        across writer blocks — part of why that method was experimental):
        a frame that does not fit the current block starts a fresh one,
        and an oversized frame gets a dedicated block of its exact size,
        so every published BlockLocation is independently parseable by
        the reader regardless of fetch grouping order.
        """
        mv = memoryview(framed) if not isinstance(framed, memoryview) else framed
        n = len(mv)
        with self._lock:
            if n > self.block_size:
                block = self._add_block(n)
                self._blocks.append(block)
            else:
                if not self._blocks or self._blocks[-1].remaining() < n:
                    self._blocks.append(self._add_block(self.block_size))
                block = self._blocks[-1]
            written = block.append(mv)
            assert written == n
        return n

    def locations(self) -> List[BlockLocation]:
        with self._lock:
            return [b.location() for b in self._blocks if b.location().length > 0]

    def sealed_count(self) -> int:
        """Number of blocks that can no longer change: ``append_frame``
        only ever writes into the LAST block (or starts a new one), so
        every non-tail block is immutable — safe to publish before the
        map barrier (incremental publish, chunked_agg.py)."""
        with self._lock:
            return max(0, len(self._blocks) - 1)

    def locations_range(self, start: int, end: int) -> List[BlockLocation]:
        """Block locations for indices [start, end) — the incremental
        publisher's cursor window. ``end`` may exceed the current block
        count (clamped); callers pass ``sealed_count()`` results so the
        window never includes the mutable tail."""
        with self._lock:
            blocks = self._blocks[start:end]
        return [b.location() for b in blocks if b.location().length > 0]

    def input_streams(self) -> List[BinaryIO]:
        with self._lock:
            return [b.input_stream() for b in self._blocks]

    @property
    def total_length(self) -> int:
        with self._lock:
            return sum(b.location().length for b in self._blocks)

    def dispose(self) -> None:
        with self._lock:
            blocks, self._blocks = self._blocks, []
        for b in blocks:
            reserved = getattr(b, "reserved_bytes", 0)
            b.dispose()
            if reserved:
                self._resolver.release_inmemory_bytes(reserved)
