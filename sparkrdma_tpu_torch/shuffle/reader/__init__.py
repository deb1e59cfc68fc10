"""TpuShuffleReader — records out of fetched partition streams.

Analogue of RdmaShuffleReader.scala (reference: RdmaShuffleReader.scala):
wraps the fetcher iterator's streams with the symmetric decompression +
deserialization (:52-67), merges metrics, applies the aggregator
(map-side-combine aware, :81-96) and optional key ordering (:99-112 —
the ExternalSorter role).

Two structural upgrades over the reference's serial loop
(DESIGN.md §16):

- decode runs on the :class:`ReduceTaskPipeline` (reader/pipeline.py):
  a pool of ``reduce.parallelism`` workers decompresses + deserializes
  fetched streams OFF the fetch thread while further group READs are
  in flight, with delivery re-sequenced to fetch order so any
  parallelism yields the exact serial sequence;
- the consume path is zero-copy end to end: compressed frames slice
  out of the fetched stream via ``read_view`` (no intermediate bytes),
  and records deserialize straight from the decompressed buffer via
  ``load_buffer`` (no ``BytesIO(block)`` copy per block).

A copy of the JAX package's ``shuffle/reader/__init__.py``, its imports
rewritten to this package.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Tuple

from sparkrdma_tpu_torch.engine.serializer import PickleSerializer, iter_compressed_blocks
from sparkrdma_tpu_torch.obs import get_registry
from sparkrdma_tpu_torch.shuffle import columnar
from sparkrdma_tpu_torch.shuffle.fetcher import TpuShuffleFetcherIterator
from sparkrdma_tpu_torch.shuffle.handle import BaseShuffleHandle, combine_by_key
from sparkrdma_tpu_torch.shuffle.reader.pipeline import ReduceTaskPipeline


class TpuShuffleReader:
    def __init__(
        self,
        manager,
        handle: BaseShuffleHandle,
        start_partition: int,
        end_partition: int,
    ):
        self._manager = manager
        self._handle = handle
        self._fetcher = TpuShuffleFetcherIterator(
            manager, handle, start_partition, end_partition
        )
        self._serializer = PickleSerializer()
        self._pipe: Optional[ReduceTaskPipeline] = None

    @property
    def metrics(self):
        return self._fetcher.metrics

    def _decode_stream(self, item, _fetched) -> List[Tuple]:
        """Decode one fetched (pid, stream) fully: checksum-verified
        bytes -> decompressed block views -> record tuples. Runs on a
        decode-pool worker; the stream's registered slice / mapped
        window releases as soon as its last record materializes, so
        zero-copy views never outlive their backing buffer.

        Columnar frames (per-block magic sniff, shuffle/columnar.py)
        skip deserialization entirely: decode is header validation +
        ``np.frombuffer`` column views over the landed bytes, rows
        materialize straight off the aliased columns — the split-phase
        decode stage degenerated to view construction (DESIGN.md §25)."""
        _pid, stream = item
        codec = self._manager.resolver.codec
        records: List[Tuple] = []
        view_decodes = 0
        try:
            for block in iter_compressed_blocks(stream, codec):
                if columnar.is_columnar(block):
                    records.extend(columnar.iter_records(block))
                    view_decodes += 1
                else:
                    records.extend(self._serializer.load_buffer(block))
        finally:
            stream.close()
        if view_decodes:
            get_registry().counter(
                "block.view_decodes", role=self._manager.executor_id
            ).inc(view_decodes)
        return records

    @staticmethod
    def _discard(stage: str, item, value) -> None:
        """Abort-drain hook: an undecoded stream still owns its
        registered slice / mapped window — close it. Decoded record
        lists hold no resources."""
        if stage == "fetch" and item is not None:
            _pid, stream = item
            try:
                stream.close()
            except Exception:
                pass

    def _record_iter(self) -> Iterator[Tuple]:
        conf = self._manager.conf
        metrics = self._fetcher.metrics
        self._pipe = ReduceTaskPipeline(
            None,  # the fetcher iterator IS the fetch stage
            self._decode_stream,
            None,
            None,
            parallelism=conf.reduce_parallelism,
            depth=conf.reduce_pipeline_depth,
            double_buffer=False,  # no staging stage on the record plane
            role=self._manager.executor_id,
            discard_fn=self._discard,
        )
        stream = self._pipe.stream(self._fetcher)
        try:
            for records in stream:
                for rec in records:
                    metrics.records_read += 1
                    yield rec
        finally:
            # completion OR abandonment (generator finalization): abort
            # the pipeline, unblock its fetch thread by closing the
            # fetcher (sweeping unconsumed streams — the reference's
            # task-completion cleanup, RdmaShuffleFetcherIterator.scala:
            # 90-106), then drain the pipeline so every in-flight
            # stream's registered slice / mapped window releases
            self._pipe.abort()
            self._fetcher.close()
            stream.close()

    def close(self) -> None:
        """Release unconsumed fetched streams NOW (the reference's
        task-completion cleanup, RdmaShuffleFetcherIterator.scala:
        90-106). Generator finalization alone cannot cover a consumer
        that abandons `read()` without ever starting iteration — task
        runners call this from a finally. Idempotent."""
        if self._pipe is not None:
            self._pipe.abort()
        self._fetcher.close()

    def read(self) -> Iterator[Tuple]:
        """Iterator of (key, value) with aggregation/ordering applied."""
        records = self._record_iter()
        agg = self._handle.aggregator
        if agg is not None:
            # with map-side combine the incoming values are combiners (:87-90)
            combined = combine_by_key(
                records, agg, values_are_combiners=self._handle.map_side_combine
            )
            records = iter(combined.items())
        if self._handle.key_ordering:
            # spillable ordering (the ExternalSorter role, :99-112)
            from sparkrdma_tpu_torch.utils.external_sorter import ExternalSorter

            sorter = ExternalSorter(
                spill_threshold=self._manager.conf.sort_spill_threshold
            )
            records = sorter.sort(records)
            self._fetcher.metrics.sort_spills = sorter.spill_count
        return records
