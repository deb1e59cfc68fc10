"""MappedFile — mmap+register shuffle files for remote one-sided READ.

TPU-native analogue of RdmaMappedFile.java (reference: RdmaMappedFile.java).
Semantics preserved:

- partition-aware **chunked** mapping: consecutive partitions are
  coalesced until the chunk reaches ``block_size`` bytes, each chunk is
  mapped at a 4 KiB-aligned offset and registered as its own region,
  and a per-partition ``(address, length, mkey)`` table is computed
  (reference :135-209),
- a single mapping never exceeds 2 GiB (reference :219-222),
- regions are registered read-only for remote access (reference
  IBV_ACCESS_REMOTE_READ only, :42),
- the backing file is deleted on dispose (reference deleteOnExit +
  dispose, :132, 251-260).

A copy of the JAX package's ``memory/mapped_file.py``, its imports
rewritten to this package.
"""

from __future__ import annotations

import mmap
import os
from dataclasses import dataclass
from typing import List, Optional, Sequence

from sparkrdma_tpu_torch.locations import BlockLocation
from sparkrdma_tpu_torch.memory.registry import ProtectionDomain

ALIGN = 4096
MAX_MAPPING = (1 << 31) - ALIGN  # ≤2 GiB per mapping (reference :219-222)


@dataclass
class _FileMapping:
    """One mmap'd, registered chunk of the file (reference RdmaFileMapping)."""

    mm: mmap.mmap
    view: memoryview
    mkey: int
    file_offset: int  # aligned file offset this mapping starts at
    length: int


class MappedFile:
    def __init__(
        self,
        path: str,
        pd: ProtectionDomain,
        block_size: int,
        partition_lengths: Sequence[int],
    ):
        self.path = path
        self._pd = pd
        self._mappings: List[_FileMapping] = []
        # per-partition location (address = offset inside its mapping)
        self._partition_locations: List[Optional[BlockLocation]] = []
        self._partition_mapping: List[Optional[int]] = []  # index into _mappings
        self._disposed = False
        self._fd = os.open(path, os.O_RDONLY)
        try:
            self._map_partitions(block_size, partition_lengths)
        except Exception:
            os.close(self._fd)
            raise

    def _map_partitions(self, block_size: int, partition_lengths: Sequence[int]) -> None:
        file_size = os.fstat(self._fd).st_size
        if sum(partition_lengths) != file_size:
            raise ValueError(
                f"partition lengths sum {sum(partition_lengths)} != file size {file_size}"
            )
        # Coalesce consecutive partitions into ≥block_size chunks
        # (reference :165-209), capped at MAX_MAPPING.
        chunks: List[List[int]] = []  # lists of partition ids
        acc = 0
        current: List[int] = []
        for pid, length in enumerate(partition_lengths):
            if length > MAX_MAPPING:
                # the reference raises for >2 GiB single registrations
                # (RdmaMappedFile.java:219-222); lengths must also fit the
                # 4-byte field in BlockLocation.
                raise ValueError(
                    f"partition {pid} is {length} bytes; single-mapping "
                    f"limit is {MAX_MAPPING}"
                )
            if current and acc + length > MAX_MAPPING:
                chunks.append(current)
                current, acc = [], 0
            current.append(pid)
            acc += length
            if acc >= block_size:
                chunks.append(current)
                current, acc = [], 0
        if current:
            chunks.append(current)

        offsets = [0] * len(partition_lengths)
        off = 0
        for pid, length in enumerate(partition_lengths):
            offsets[pid] = off
            off += length

        self._partition_locations = [None] * len(partition_lengths)
        self._partition_mapping = [None] * len(partition_lengths)

        for chunk in chunks:
            chunk_start = offsets[chunk[0]]
            chunk_end = offsets[chunk[-1]] + partition_lengths[chunk[-1]]
            if chunk_end == chunk_start:
                # all-empty chunk: no mapping needed
                for pid in chunk:
                    self._partition_locations[pid] = BlockLocation(0, 0, 0)
                continue
            aligned_start = chunk_start & ~(ALIGN - 1)
            map_len = chunk_end - aligned_start
            mm = mmap.mmap(
                self._fd, map_len, mmap.MAP_SHARED, mmap.PROT_READ, offset=aligned_start
            )
            view = memoryview(mm)
            # advertise the backing file so same-host peers can pread
            # the chunk from page cache instead of streaming it; the
            # identity comes from fstat of the mapping's own fd so a
            # concurrent same-path rewrite can't be mistaken for it
            mkey = self._pd.register(
                view, file_path=os.path.abspath(self.path),
                file_offset=aligned_start,
                file_stat=os.fstat(self._fd),
            )
            mapping_index = len(self._mappings)
            self._mappings.append(_FileMapping(mm, view, mkey, aligned_start, map_len))
            for pid in chunk:
                addr = offsets[pid] - aligned_start
                self._partition_locations[pid] = BlockLocation(
                    addr, partition_lengths[pid], mkey
                )
                self._partition_mapping[pid] = mapping_index

    # -- accessors (reference :306-327) -----------------------------------
    def partition_count(self) -> int:
        return len(self._partition_locations)

    def get_partition_location(self, pid: int) -> BlockLocation:
        loc = self._partition_locations[pid]
        assert loc is not None
        return loc

    def get_partition_view(self, pid: int) -> memoryview:
        """Local short-circuit read path (no network loop-through)."""
        loc = self.get_partition_location(pid)
        if loc.length == 0:
            return memoryview(b"")
        idx = self._partition_mapping[pid]
        assert idx is not None
        mapping = self._mappings[idx]
        return mapping.view[loc.address : loc.address + loc.length]

    def dispose(self) -> None:
        """Deregister, unmap, close, and delete the backing file."""
        if self._disposed:
            return
        self._disposed = True
        for m in self._mappings:
            self._pd.deregister(m.mkey)
            try:
                m.view.release()
                m.mm.close()
            except BufferError:
                # a partition view from a still-open stream keeps the
                # mapping alive; the OS unmaps when the last view dies
                pass
        self._mappings.clear()
        os.close(self._fd)
        try:
            os.unlink(self.path)
        except OSError:
            pass
