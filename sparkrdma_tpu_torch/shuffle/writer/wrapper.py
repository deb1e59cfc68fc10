"""Wrapper writer method (default): sort-shuffle file, mmap'd+registered.

Analogue of wrapper/RdmaWrapperShuffleWriter.scala (reference: writer/wrapper/
RdmaWrapperShuffleWriter.scala). Semantics preserved:

- record writing is delegated to the sort-shuffle machinery
  (:85-101 → sort_file.write_sorted_file here),
- ``write_index_file_and_commit`` renames the tmp data file and
  mmaps+registers it chunked by ``shuffle_write_block_size`` with
  per-partition locations (:57-74),
- on successful ``stop()`` the writer collects every **non-empty**
  partition's location from the mapped file and publishes to the
  driver with partition_id = -1 (:106-140; the driver re-keys each
  location by its own partition id),
- partitions are servable locally as streams (:40-44).

A copy of the JAX package's ``shuffle/writer/wrapper.py``, its imports
rewritten to this package.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass, replace
from typing import BinaryIO, Dict, List, Optional, Sequence

from sparkrdma_tpu_torch.locations import PartitionLocation
from sparkrdma_tpu_torch.memory.mapped_file import MappedFile
from sparkrdma_tpu_torch.obs import get_registry
from sparkrdma_tpu_torch.memory.streams import MemoryviewInputStream
from sparkrdma_tpu_torch.shuffle.handle import BaseShuffleHandle
from sparkrdma_tpu_torch.shuffle.writer import ShuffleData
from sparkrdma_tpu_torch.shuffle.writer.sort_file import write_sorted_file


@dataclass
class MapStatus:
    map_id: int
    partition_lengths: List[int]


class WrapperShuffleData(ShuffleData):
    def __init__(self, resolver, shuffle_id: int, num_partitions: int):
        self._resolver = resolver
        self.shuffle_id = shuffle_id
        self.num_partitions = num_partitions
        self._mapped: Dict[int, MappedFile] = {}
        # per-map per-partition block formats (BlockLocation.FORMAT_*):
        # the columnar negotiation outcome travels with the mapped file
        # so every publish path — writer stop, HA re-adoption sweep —
        # advertises the same encoding tag
        self._formats: Dict[int, List[int]] = {}
        self._lock = threading.Lock()

    def new_shuffle_writer(self) -> None:
        pass  # no per-writer state for this method

    def write_index_file_and_commit(
        self,
        map_id: int,
        partition_lengths: Sequence[int],
        data_tmp_path: str,
        partition_formats: Optional[Sequence[int]] = None,
    ) -> None:
        final_path = self._resolver.data_file_path(self.shuffle_id, map_id)
        os.replace(data_tmp_path, final_path)
        mf = MappedFile(
            final_path,
            self._resolver.pd,
            self._resolver.conf.shuffle_write_block_size,
            list(partition_lengths),
        )
        with self._lock:
            old = self._mapped.pop(map_id, None)
            self._mapped[map_id] = mf
            if partition_formats is not None:
                self._formats[map_id] = list(partition_formats)
            else:
                self._formats.pop(map_id, None)
        if old is not None:
            old.dispose()  # speculative re-run replaced the output

    def partition_format(self, map_id: int, pid: int) -> int:
        with self._lock:
            formats = self._formats.get(map_id)
        return formats[pid] if formats else 0

    def get_mapped_file(self, map_id: int) -> MappedFile:
        with self._lock:
            return self._mapped[map_id]

    def handoff_manifest(self) -> List[dict]:
        """Elastic layer: describe every committed map output by file
        path + per-partition lengths — everything the shuffle-service
        daemon needs to re-mmap and re-register the same bytes
        (elastic/service.py) without copying them."""
        with self._lock:
            items = sorted(self._mapped.items())
        return [
            {
                "map_id": map_id,
                "path": os.path.abspath(mf.path),
                "partition_lengths": [
                    mf.get_partition_location(pid).length
                    for pid in range(mf.partition_count())
                ],
            }
            for map_id, mf in items
        ]

    def committed_map_locations(
        self, manager_id
    ) -> Dict[int, List[PartitionLocation]]:
        """Control-plane HA (sparkrdma_tpu_torch/metastore): rebuild the
        publishable locations of every committed map output — the same
        non-empty-partition collection WrapperShuffleWriter.stop()
        published the first time. A wiped hub re-adopts from this sweep
        instead of recomputing; an all-empty map yields [] and is still
        re-published so the map-output barrier re-completes."""
        with self._lock:
            items = sorted(self._mapped.items())
        return {
            map_id: [
                PartitionLocation(
                    manager_id,
                    pid,
                    replace(
                        mf.get_partition_location(pid),
                        source_map=map_id,
                        block_format=self.partition_format(map_id, pid),
                    ),
                )
                for pid in range(mf.partition_count())
                if mf.get_partition_location(pid).length > 0
            ]
            for map_id, mf in items
        }

    def get_input_streams(self, partition_id: int) -> List[BinaryIO]:
        with self._lock:
            files = list(self._mapped.values())
        return [
            MemoryviewInputStream(mf.get_partition_view(partition_id))
            for mf in files
            if mf.get_partition_location(partition_id).length > 0
        ]

    def remove_data_by_map(self, map_id: int) -> None:
        with self._lock:
            mf = self._mapped.pop(map_id, None)
        if mf is not None:
            mf.dispose()

    def dispose(self) -> None:
        with self._lock:
            files = list(self._mapped.values())
            self._mapped.clear()
        for mf in files:
            mf.dispose()


class WrapperShuffleWriter:
    """One map task's writer (reference :80-140)."""

    def __init__(self, manager, handle: BaseShuffleHandle, map_id: int):
        self._manager = manager
        self._handle = handle
        self.map_id = map_id
        self._data: WrapperShuffleData = manager.resolver.get_or_create_shuffle_data(handle)
        self._data.new_shuffle_writer()
        self._lengths: Optional[List[int]] = None
        self._formats: Optional[List[int]] = None
        self._stopped = False

    def write(self, records) -> None:
        resolver = self._manager.resolver
        conf = self._manager.conf
        tmp = resolver.data_tmp_path(self._handle.shuffle_id, self.map_id)
        res = write_sorted_file(
            records, self._handle, resolver.codec, tmp,
            block_format=conf.block_format,
            batch_rows=conf.block_columnar_batch_rows,
        )
        self._data.write_index_file_and_commit(
            self.map_id, res.lengths, tmp, partition_formats=res.formats
        )
        self._lengths = res.lengths
        self._formats = res.formats
        if res.columnar_frames or res.pickle_fallbacks:
            role = self._manager.executor_id
            reg = get_registry()
            reg.counter("block.columnar_blocks", role=role).inc(
                res.columnar_frames
            )
            reg.counter("block.columnar_bytes", role=role).inc(
                res.columnar_bytes
            )
            if res.pickle_fallbacks:
                reg.counter("block.pickle_fallbacks", role=role).inc(
                    res.pickle_fallbacks
                )

    def stop(self, success: bool) -> Optional[MapStatus]:
        if self._stopped:
            return None
        self._stopped = True
        if not success or self._lengths is None:
            self._data.remove_data_by_map(self.map_id)
            return None
        # collect non-empty partition locations and publish (:121-136);
        # an all-empty map output still publishes so the driver's
        # map-output count completes
        mf = self._data.get_mapped_file(self.map_id)
        formats = self._formats or [0] * self._handle.num_partitions
        locs = [
            PartitionLocation(
                self._manager.local_manager_id,
                pid,
                replace(
                    mf.get_partition_location(pid),
                    source_map=self.map_id,
                    block_format=formats[pid],
                ),
            )
            for pid in range(self._handle.num_partitions)
            if mf.get_partition_location(pid).length > 0
        ]
        role = self._manager.executor_id
        reg = get_registry()
        reg.counter("writer.map_outputs", role=role, method="wrapper").inc()
        reg.counter("writer.partitions_written", role=role).inc(len(locs))
        reg.counter("writer.bytes_written", role=role).inc(sum(self._lengths))
        self._manager.publish_partition_locations(
            self._handle.shuffle_id, -1, locs, num_map_outputs=1
        )
        # elastic layer: best-effort replication of this map's bytes to
        # peer executors (conf elastic.replicas; never a write failure)
        client = getattr(self._manager, "replica_client", None)
        if client is not None and locs:
            client.replicate_map(self._handle.shuffle_id, self.map_id, mf)
        return MapStatus(self.map_id, self._lengths)
