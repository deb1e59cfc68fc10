"""Shuffle write data plane (L5).

``ShuffleData`` is the per-shuffle storage abstraction shared by both
writer strategies — analogue of the RdmaShuffleData trait (reference:
writer/
RdmaShuffleData.scala:22-28). Both implementations expose identical
semantics and are chosen purely by config (SURVEY.md §5.1 #6).

A copy of the JAX package's ``shuffle/writer/__init__.py``, its imports
rewritten to this package.
"""

from __future__ import annotations

from typing import BinaryIO, List, Optional, Sequence


class ShuffleData:
    def new_shuffle_writer(self) -> None:
        """A map-task writer for this shuffle started on this executor."""
        raise NotImplementedError

    def get_input_streams(self, partition_id: int) -> List[BinaryIO]:
        """Local short-circuit read of a partition (no network loop)."""
        raise NotImplementedError

    def remove_data_by_map(self, map_id: int) -> None:
        raise NotImplementedError

    def write_index_file_and_commit(
        self,
        map_id: int,
        partition_lengths: Sequence[int],
        data_tmp_path: str,
        partition_formats: Optional[Sequence[int]] = None,
    ) -> None:
        raise NotImplementedError

    def dispose(self) -> None:
        raise NotImplementedError


from sparkrdma_tpu_torch.shuffle.writer.wrapper import (  # noqa: E402
    WrapperShuffleData,
    WrapperShuffleWriter,
)
from sparkrdma_tpu_torch.shuffle.writer.chunked_agg import (  # noqa: E402
    ChunkedAggShuffleData,
    ChunkedAggShuffleWriter,
)
from sparkrdma_tpu_torch.shuffle.writer.pipeline import (  # noqa: E402
    MapTaskPipeline,
    PipelineReport,
)

__all__ = [
    "ShuffleData",
    "WrapperShuffleData",
    "WrapperShuffleWriter",
    "ChunkedAggShuffleData",
    "ChunkedAggShuffleWriter",
    "MapTaskPipeline",
    "PipelineReport",
]
