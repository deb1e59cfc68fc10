"""TpuShuffleBlockResolver — per-executor shuffle storage registry.

Analogue of RdmaShuffleBlockResolver.scala (reference: RdmaShuffleBlockResolver.scala). Semantics preserved:

- maps shuffle_id → ShuffleData, created writer-method-specifically
  (:49-66),
- executor-wide in-memory budget accounting
  ``reserve_inmemory_bytes``/``release_inmemory_bytes`` against
  ``shuffle_write_max_inmemory_per_executor`` (:38-47),
- routes ``write_index_file_and_commit``/``remove_data_by_map``
  (:77-87),
- serves local partitions as input streams (:95-100).

A copy of the JAX package's ``shuffle/resolver.py``, its imports
rewritten to this package.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import threading
from typing import BinaryIO, Dict, List, Optional

from sparkrdma_tpu_torch.engine.serializer import CompressionCodec
from sparkrdma_tpu_torch.shuffle.handle import BaseShuffleHandle
from sparkrdma_tpu_torch.shuffle.writer import ShuffleData
from sparkrdma_tpu_torch.utils.config import ShuffleWriterMethod, TpuShuffleConf


class TpuShuffleBlockResolver:
    def __init__(self, manager):
        self._manager = manager
        self.conf: TpuShuffleConf = manager.conf
        self.codec = CompressionCodec(enabled=True)
        self._data: Dict[int, ShuffleData] = {}
        self._lock = threading.Lock()
        self._inmemory_used = 0
        self._budget = self.conf.shuffle_write_max_inmemory_per_executor
        self._local_dir = tempfile.mkdtemp(prefix=f"tpu-shuffle-{manager.executor_id}-")

    @property
    def pd(self):
        return self._manager.node.pd

    # -- in-memory budget (:38-47) ----------------------------------------
    def reserve_inmemory_bytes(self, n: int) -> bool:
        with self._lock:
            if self._inmemory_used + n > self._budget:
                return False
            self._inmemory_used += n
            return True

    def release_inmemory_bytes(self, n: int) -> None:
        with self._lock:
            self._inmemory_used = max(0, self._inmemory_used - n)

    @property
    def inmemory_used(self) -> int:
        with self._lock:
            return self._inmemory_used

    # -- paths -------------------------------------------------------------
    def data_file_path(self, shuffle_id: int, map_id: int) -> str:
        return os.path.join(self._local_dir, f"shuffle_{shuffle_id}_{map_id}.data")

    def data_tmp_path(self, shuffle_id: int, map_id: int) -> str:
        return os.path.join(self._local_dir, f"shuffle_{shuffle_id}_{map_id}.data.tmp")

    def scratch_path(self, name: str) -> str:
        return os.path.join(self._local_dir, name)

    # -- shuffle data lifecycle (:49-66) -----------------------------------
    def get_or_create_shuffle_data(self, handle: BaseShuffleHandle) -> ShuffleData:
        from sparkrdma_tpu_torch.shuffle.writer.chunked_agg import ChunkedAggShuffleData
        from sparkrdma_tpu_torch.shuffle.writer.wrapper import WrapperShuffleData

        with self._lock:
            data = self._data.get(handle.shuffle_id)
            if data is None:
                if self.conf.shuffle_writer_method == ShuffleWriterMethod.WRAPPER:
                    data = WrapperShuffleData(self, handle.shuffle_id, handle.num_partitions)
                else:
                    data = ChunkedAggShuffleData(
                        self,
                        handle.shuffle_id,
                        handle.num_partitions,
                        num_maps=handle.num_maps,
                    )
                self._data[handle.shuffle_id] = data
            return data

    def get_shuffle_data(self, shuffle_id: int) -> Optional[ShuffleData]:
        with self._lock:
            return self._data.get(shuffle_id)

    def shuffle_ids(self) -> List[int]:
        """Snapshot of the shuffles with live local data (elastic
        layer: the handoff path walks these to build its manifest)."""
        with self._lock:
            return sorted(self._data)

    def get_local_partition_streams(self, shuffle_id: int, partition_id: int) -> List[BinaryIO]:
        data = self.get_shuffle_data(shuffle_id)
        return data.get_input_streams(partition_id) if data is not None else []

    def remove_shuffle(self, shuffle_id: int) -> None:
        with self._lock:
            data = self._data.pop(shuffle_id, None)
        if data is not None:
            data.dispose()

    def stop(self) -> None:
        with self._lock:
            datas = list(self._data.values())
            self._data.clear()
        for d in datas:
            d.dispose()
        shutil.rmtree(self._local_dir, ignore_errors=True)
