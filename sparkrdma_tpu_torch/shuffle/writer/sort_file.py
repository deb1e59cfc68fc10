"""Sort-shuffle file writer — the Spark sort/spill machinery stand-in.

The reference's Wrapper method delegates record writing to Spark's own
UnsafeShuffleWriter/SortShuffleWriter (reference: wrapper/
RdmaWrapperShuffleWriter.scala:85-101), which produce one data file per
map task with partitions laid out consecutively plus an index of
lengths. This module reproduces that contract: records are routed to
their partition, serialized and compressed into per-partition spooled
scratch streams (spilling to disk past a threshold, the ExternalSorter
role), then concatenated into the final data-tmp file.

A copy of the JAX package's ``shuffle/writer/sort_file.py``, its imports
rewritten to this package.
"""

from __future__ import annotations

import itertools
import tempfile
from typing import Iterable, List, NamedTuple, Tuple

from sparkrdma_tpu_torch.engine.serializer import (
    CompressedBlockWriter,
    CompressionCodec,
)
from sparkrdma_tpu_torch.locations import BlockLocation
from sparkrdma_tpu_torch.shuffle.handle import BaseShuffleHandle, combine_by_key

SPOOL_MAX = 8 << 20  # per-partition in-memory spool before spilling to disk


class SortFileResult(NamedTuple):
    """Per-partition byte lengths + block formats, plus frame stats for
    the writer's ``block.*`` metric family (obs/metrics.py)."""

    lengths: List[int]
    formats: List[int]  # BlockLocation.FORMAT_* per partition
    columnar_frames: int
    columnar_bytes: int
    pickle_fallbacks: int


def _conforms(rec) -> bool:
    """Cheap auto-negotiation sniff: does ONE record look columnar-able?
    (The per-batch encoder re-checks the whole batch; this only decides
    whether ``auto`` engages the columnar writers at all.)"""
    import numpy as np

    from sparkrdma_tpu_torch.shuffle.columnar import _code_for

    return (
        type(rec) is tuple
        and len(rec) > 0
        and all(
            isinstance(v, np.generic) and _code_for(v.dtype) is not None
            for v in rec
        )
    )


def write_sorted_file(
    records: Iterable[Tuple],
    handle: BaseShuffleHandle,
    codec: CompressionCodec,
    data_tmp_path: str,
    block_format: str = "pickle",
    batch_rows: int = 4096,
) -> SortFileResult:
    """Write records partitioned+serialized+compressed; returns lengths,
    per-partition block formats, and frame stats.

    Applies map-side combine when the handle requests it (the reference
    reader/writer split this with Spark; SURVEY.md §3.3).

    ``block_format`` negotiates the payload encoding (DESIGN.md §25):
    ``pickle`` is the legacy frame stream; ``columnar`` batches records
    through :class:`ColumnarPartitionWriter` (per-batch pickle fallback
    for non-conforming batches); ``auto`` sniffs the first record and
    picks — fixed-width numpy tuples go columnar, everything else stays
    on the byte-identical legacy path.
    """
    num_partitions = handle.num_partitions
    part = handle.partitioner.partition

    if handle.aggregator is not None and handle.map_side_combine:
        records = combine_by_key(records, handle.aggregator).items()

    if block_format == "auto":
        it = iter(records)
        first = next(it, None)
        if first is None:
            records = ()
        else:
            records = itertools.chain([first], it)
        block_format = (
            "columnar" if first is not None and _conforms(first) else "pickle"
        )

    spools = [tempfile.SpooledTemporaryFile(max_size=SPOOL_MAX) for _ in range(num_partitions)]
    formats = [BlockLocation.FORMAT_PICKLE] * num_partitions
    col_frames = col_bytes = fallbacks = 0

    if block_format == "columnar":
        from sparkrdma_tpu_torch.shuffle.writer.columnar import ColumnarPartitionWriter

        cwriters = [
            ColumnarPartitionWriter(codec, spools[p].write, batch_rows)
            for p in range(num_partitions)
        ]
        for rec in records:
            cwriters[part(rec[0])].write_record(rec)
        for p, w in enumerate(cwriters):
            w.flush_batch()
            if w.all_columnar:
                formats[p] = BlockLocation.FORMAT_COLUMNAR
            col_frames += w.columnar_frames
            col_bytes += w.columnar_bytes
            fallbacks += w.pickle_fallbacks
    else:
        writers = [CompressedBlockWriter(codec, spools[p].write) for p in range(num_partitions)]

        import pickle
        import struct

        pack = struct.Struct(">I").pack
        dumps = pickle.dumps
        flush_size = 256 << 10
        for rec in records:
            data = dumps(rec, protocol=pickle.HIGHEST_PROTOCOL)
            w = writers[part(rec[0])]
            w.write(pack(len(data)))
            w.write(data)
            if w.pending >= flush_size:
                w.flush_block()
        for p in range(num_partitions):
            writers[p].flush_block()

    lengths = [0] * num_partitions
    with open(data_tmp_path, "wb") as out:
        for p in range(num_partitions):
            spool = spools[p]
            spool.seek(0)
            start = out.tell()
            while True:
                chunk = spool.read(1 << 20)
                if not chunk:
                    break
                out.write(chunk)
            lengths[p] = out.tell() - start
            spool.close()
    return SortFileResult(lengths, formats, col_frames, col_bytes, fallbacks)
