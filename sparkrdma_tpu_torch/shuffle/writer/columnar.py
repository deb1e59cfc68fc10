"""ColumnarPartitionWriter — batched columnar framing for one partition.

The map-side half of the columnar block format (DESIGN.md §25,
shuffle/columnar.py): records for one partition accumulate into a
batch; a conforming batch (same-arity tuples of fixed-width numpy
scalars) serializes into ONE columnar frame — column vectors laid out
contiguously so device staging and the reduce-side decode are raw byte
views — and a non-conforming batch falls back to ONE pickle-stream
frame through the same codec the legacy writer uses. The two frame
kinds interleave freely inside a partition block; the reduce side
sniffs the per-frame magic.

A partition whose every frame came out columnar is tagged
``BlockLocation.FORMAT_COLUMNAR`` at publish (the collective compiler's
wave-eligibility signal: such blocks are 8-aligned by construction);
any pickle fallback keeps the tag at the pickle default.

A copy of the JAX package's ``shuffle/writer/columnar.py``, its imports
rewritten to this package.
"""

from __future__ import annotations

import pickle
import struct
from typing import List, Tuple

from sparkrdma_tpu_torch.engine.serializer import (
    CompressionCodec,
    frame_columnar,
    frame_compressed,
)
from sparkrdma_tpu_torch.shuffle.columnar import encode_batch

_LEN_PACK = struct.Struct(">I").pack


class ColumnarPartitionWriter:
    """Accumulates records, emits columnar-or-pickle frames per batch."""

    __slots__ = (
        "_codec", "_sink", "_batch", "_batch_rows",
        "columnar_frames", "columnar_bytes", "pickle_fallbacks",
    )

    def __init__(self, codec: CompressionCodec, sink, batch_rows: int = 4096):
        self._codec = codec
        self._sink = sink  # callable(bytes) -> None
        self._batch: List[Tuple] = []
        self._batch_rows = max(1, batch_rows)
        self.columnar_frames = 0
        self.columnar_bytes = 0
        self.pickle_fallbacks = 0

    @property
    def all_columnar(self) -> bool:
        """True when every emitted frame was columnar (and one exists)."""
        return self.columnar_frames > 0 and self.pickle_fallbacks == 0

    def write_record(self, rec: Tuple) -> None:
        self._batch.append(rec)
        if len(self._batch) >= self._batch_rows:
            self.flush_batch()

    def flush_batch(self) -> None:
        if not self._batch:
            return
        payload = encode_batch(self._batch)
        if payload is not None:
            framed = frame_columnar(payload)
            self._sink(framed)
            self.columnar_frames += 1
            self.columnar_bytes += len(framed)
        else:
            # the universal fallback: this batch as one pickle frame
            buf = bytearray()
            for rec in self._batch:
                data = pickle.dumps(rec, protocol=pickle.HIGHEST_PROTOCOL)
                buf += _LEN_PACK(len(data))
                buf += data
            self._sink(frame_compressed(self._codec, bytes(buf)))
            self.pickle_fallbacks += 1
        self._batch.clear()
