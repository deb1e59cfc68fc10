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

A copy of the JAX package's ``shuffle/resolver.py``. The writer-backed
shuffle data (``get_or_create_shuffle_data``) raises
``NotImplementedError`` until the writers come with ROADMAP item M4;
what the manager calls at start and stop (``shuffle_ids``,
``get_shuffle_data``, ``remove_shuffle``, ``stop``) works as in JAX.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import threading
from typing import BinaryIO, Dict, List, Optional

from sparkrdma_tpu_torch.engine.serializer import CompressionCodec
from sparkrdma_tpu_torch.shuffle.handle import BaseShuffleHandle
from sparkrdma_tpu_torch.utils.config import TpuShuffleConf


class TpuShuffleBlockResolver:
    def __init__(self, manager):
        self._manager = manager
        self.conf: TpuShuffleConf = manager.conf
        self.codec = CompressionCodec(enabled=True)
        self._data: Dict[int, "object"] = {}
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
    def get_or_create_shuffle_data(self, handle: BaseShuffleHandle):
        """The writer-backed shuffle data of ``handle``. The writers
        (``shuffle/writer/*``) come to the port with ROADMAP item M4;
        until then no shuffle data is ever created, and every other
        method here serves an empty table."""
        raise NotImplementedError(
            "writer-backed shuffle data needs shuffle/writer/*, which the "
            "port brings with ROADMAP item M4"
        )

    def get_shuffle_data(self, shuffle_id: int) -> Optional[object]:
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
