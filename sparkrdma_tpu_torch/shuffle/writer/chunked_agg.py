"""ChunkedPartitionAgg writer method: serialize straight into registered
chunks, aggregated per partition across all map tasks of an executor.

Analogue of chunkedpartitionagg/RdmaChunkedPartitionAggShuffleWriter.scala
(reference: writer/chunkedpartitionagg/). Semantics preserved:

- per-partition stream stacks: serializer → compressor → chunked
  scratch buffers (:114-130), flushed into the shared per-partition
  :class:`PartitionWriter` once ``shuffle_write_flush_size`` bytes
  accumulate, with chunk recycling (:154-191),
- all map tasks of one executor append into the same partition logs,
  so the executor publishes **one aggregated location set** instead of
  one per map task (:45-73),
- publication happens at the map-stage barrier via
  ``finalize_and_publish`` (driven by the engine / manager), replacing
  the reference's fragile "last active writer publishes" trigger — and
  per-map partition lengths are tracked accurately, fixing the known
  wrong-MapStatus-lengths quirk (reference TODO at :217-218;
  SURVEY.md §5.1 "known quirks").

Trade-off vs Wrapper (as in the reference): no per-map data removal —
aggregated logs mix map outputs, so a failed map task that already
flushed frames **poisons** the shuffle's data on this executor:
``finalize_and_publish`` then refuses to publish (raising
ShuffleError), forcing the stage to re-run under a fresh shuffle id —
which is exactly how the engine retries failed map stages. A failed
map that never flushed leaves the logs clean and does not poison.

A copy of the JAX package's ``shuffle/writer/chunked_agg.py``, its imports
rewritten to this package.
"""

from __future__ import annotations

import logging
import pickle
import struct
import threading
from typing import BinaryIO, Dict, List, Optional

from sparkrdma_tpu_torch.engine.serializer import frame_compressed
from sparkrdma_tpu_torch.locations import PartitionLocation
from sparkrdma_tpu_torch.obs import get_registry
from sparkrdma_tpu_torch.shuffle.handle import BaseShuffleHandle, combine_by_key
from sparkrdma_tpu_torch.shuffle.writer import ShuffleData
from sparkrdma_tpu_torch.shuffle.writer.chunked_buffer import ChunkedByteBufferOutputStream
from sparkrdma_tpu_torch.shuffle.writer.partition_writer import PartitionWriter
from sparkrdma_tpu_torch.shuffle.writer.wrapper import MapStatus

logger = logging.getLogger(__name__)

_LEN = struct.Struct(">I")


class ChunkedAggShuffleData(ShuffleData):
    def __init__(self, resolver, shuffle_id: int, num_partitions: int, num_maps: int = 0):
        self._resolver = resolver
        self.shuffle_id = shuffle_id
        self.num_partitions = num_partitions
        self.num_maps = num_maps
        self._writers: Dict[int, PartitionWriter] = {}
        self._lock = threading.Lock()
        self._active_shuffle_writers = 0
        self._committed_maps = 0
        self._published = False
        self._poisoned = False
        # incremental publish (conf map.incrementalPublish): sealed
        # (non-tail) blocks are immutable, so their locations upload as
        # maps commit; per-pid cursor of blocks already published
        self._incremental = bool(
            getattr(resolver.conf, "map_incremental_publish", False)
        )
        self._sealed_published: Dict[int, int] = {}
        # push/merge plane (shuffle/merge.py): independent per-pid
        # cursors so sealed blocks push toward their reducer whether or
        # not incremental publish is on; seq is a dense per-pid counter
        # assigned under the lock so concurrent commits keep block order
        self._push_cursor: Dict[int, int] = {}
        self._push_seq: Dict[int, int] = {}

    def partition_writer(self, pid: int) -> PartitionWriter:
        with self._lock:
            pw = self._writers.get(pid)
            if pw is None:
                pw = PartitionWriter(
                    self._resolver,
                    self.shuffle_id,
                    pid,
                    self._resolver.conf.shuffle_write_block_size,
                )
                self._writers[pid] = pw
            return pw

    def new_shuffle_writer(self) -> None:
        with self._lock:
            self._active_shuffle_writers += 1

    def commit_map_output(self, manager=None) -> None:
        """A map task finished successfully; counts toward the barrier.

        With ``map.incrementalPublish`` on (and a manager to publish
        through), every SEALED writer block whose location has not gone
        out yet uploads now, overlapping the remaining map compute.
        These segments carry ``num_map_outputs=0`` — the driver treats
        them as location-only and completes the barrier ONLY on the
        final ``finalize_and_publish`` count, so a fetch can never be
        answered from a partial location set (tail blocks and the last
        flushes only ship at finalize)."""
        with self._lock:
            self._active_shuffle_writers -= 1
            self._committed_maps += 1
            publishable = (
                self._incremental
                and manager is not None
                and not self._poisoned
                and not self._published
            )
            window = []
            if publishable:
                for pid, pw in self._writers.items():
                    sealed = pw.sealed_count()
                    cursor = self._sealed_published.get(pid, 0)
                    if sealed > cursor:
                        window.append((pid, pw, cursor, sealed))
                        self._sealed_published[pid] = sealed
            push_blocks = self._collect_push_locked(manager)
        if window:
            locs: List[PartitionLocation] = []
            for pid, pw, start, end in window:
                for block_loc in pw.locations_range(start, end):
                    locs.append(
                        PartitionLocation(manager.local_manager_id, pid, block_loc)
                    )
            if locs:
                get_registry().counter(
                    "writer.incremental_publishes", role=manager.executor_id
                ).inc()
                manager.publish_partition_locations(
                    self.shuffle_id, -1, locs, num_map_outputs=0
                )
        if push_blocks:
            self._push_blocks(manager, push_blocks)

    def _collect_push_locked(self, manager, tail: bool = False) -> List:
        """Under ``self._lock``: advance the push cursors over newly
        sealed blocks (ALL remaining blocks when ``tail``, at finalize)
        and assign each a dense per-pid seq — order fixed here, under
        the lock, so concurrent map commits cannot interleave seqs out
        of block order. Payload resolution happens later, outside."""
        if (
            manager is None
            or getattr(manager, "push_client", None) is None
            or self._poisoned
            or self._published and not tail
        ):
            return []
        out = []
        for pid, pw in self._writers.items():
            sealed = (1 << 30) if tail else pw.sealed_count()
            cursor = self._push_cursor.get(pid, 0)
            if sealed <= cursor:
                continue
            blocks = pw.locations_range(cursor, sealed)
            self._push_cursor[pid] = cursor + len(blocks) if tail else sealed
            for bl in blocks:
                seq = self._push_seq.get(pid, 0)
                self._push_seq[pid] = seq + 1
                out.append((pid, seq, bl))
        return out

    def _push_blocks(self, manager, blocks, final=None) -> None:
        """Resolve block payloads and hand them to the push client.
        Best-effort by design: any failure here is logged and dropped —
        the original locations stay authoritative."""
        client = getattr(manager, "push_client", None)
        if client is None or (not blocks and final is None):
            return
        try:
            manager.start_node_if_missing()
            pd = manager.node.pd
            payloads = [
                (pid, seq, bytes(pd.resolve(bl.mkey, bl.address, bl.length)))
                for pid, seq, bl in blocks
            ]
            client.push_window(
                self.shuffle_id, payloads, self.num_partitions, final=final
            )
        except Exception:
            logger.debug(
                "push window for shuffle %d failed", self.shuffle_id, exc_info=True
            )

    def abort_map_output(self, dirty: bool = False) -> None:
        """A map task failed: it must NOT count toward the driver's
        map-output barrier (its stage will re-run). ``dirty`` means the
        task already flushed frames into the shared logs, which cannot
        be excised — the whole shuffle's data here is now unpublishable.
        Locations already uploaded incrementally are harmless: the
        barrier count never went out, so the driver keeps deferring
        fetches, and the stage re-run's ``unregister_shuffle`` of this
        id drops them."""
        with self._lock:
            self._active_shuffle_writers -= 1
            if dirty:
                self._poisoned = True

    def finalize_and_publish(self, manager) -> None:
        """Publish the aggregated location set once, at the map barrier.

        Publishes even with zero locations (all-empty map outputs) so
        the driver's map-output count completes.
        """
        with self._lock:
            if self._poisoned:
                # a failed map's frames are interleaved in the shared
                # logs; publishing would duplicate its records when the
                # stage re-runs — refuse, forcing a fresh shuffle id
                from sparkrdma_tpu_torch.shuffle.errors import ShuffleError

                raise ShuffleError(
                    f"shuffle {self.shuffle_id} chunked-agg data poisoned by a "
                    "failed map task; stage must re-run under a fresh shuffle id"
                )
            if self._published or self._committed_maps == 0:
                return
            if self._active_shuffle_writers > 0:
                # engine called finalize before every writer stopped —
                # publishing now would expose a partial location set
                logger.warning(
                    "finalize_and_publish with %d active writers on shuffle %d; deferring",
                    self._active_shuffle_writers,
                    self.shuffle_id,
                )
                return
            self._published = True
            writers = dict(self._writers)
            committed = self._committed_maps
            cursors = dict(self._sealed_published)
            push_blocks = self._collect_push_locked(manager, tail=True)
            push_final = None
            if getattr(manager, "push_client", None) is not None:
                push_final = {
                    "counts": {p: n for p, n in self._push_seq.items() if n},
                    "committed": committed,
                    "num_maps": self.num_maps,
                }
        # push the remainder plus the final coverage marker BEFORE the
        # barrier-completing publish below: merge endpoints seal and
        # publish their merged segments inside this synchronous call,
        # so merged locations reach the driver ahead of any deferred
        # fetch reply the barrier releases
        if push_final is not None:
            self._push_blocks(manager, push_blocks, final=push_final)
        # publish everything past each pid's incremental cursor (all of
        # it when incremental mode is off — cursors are then empty); the
        # full map-output count rides THIS message, completing the
        # driver's barrier only once every location is registered there
        locs: List[PartitionLocation] = []
        for pid, pw in writers.items():
            start = cursors.get(pid, 0)
            for block_loc in pw.locations_range(start, 1 << 30):
                locs.append(PartitionLocation(manager.local_manager_id, pid, block_loc))
        reg = get_registry()
        role = manager.executor_id
        reg.counter("writer.map_outputs", role=role, method="chunked_agg").inc(
            committed
        )
        reg.counter("writer.partitions_written", role=role).inc(len(writers))
        manager.publish_partition_locations(
            self.shuffle_id, -1, locs, num_map_outputs=committed
        )

    def get_input_streams(self, partition_id: int) -> List[BinaryIO]:
        with self._lock:
            pw = self._writers.get(partition_id)
        return pw.input_streams() if pw is not None else []

    def write_index_file_and_commit(self, map_id, partition_lengths, data_tmp_path):
        raise NotImplementedError("chunked-agg method does not use index files")

    def remove_data_by_map(self, map_id: int) -> None:
        # aggregated logs cannot excise one map's bytes; see module docstring
        pass

    def dispose(self) -> None:
        with self._lock:
            writers = list(self._writers.values())
            self._writers.clear()
        for pw in writers:
            pw.dispose()


class ChunkedAggShuffleWriter:
    """One map task's writer serializing into the executor-shared logs."""

    def __init__(self, manager, handle: BaseShuffleHandle, map_id: int):
        self._manager = manager
        self._handle = handle
        self.map_id = map_id
        self._data: ChunkedAggShuffleData = manager.resolver.get_or_create_shuffle_data(handle)
        self._data.new_shuffle_writer()
        self._conf = manager.conf
        self._codec = manager.resolver.codec
        self._streams: Dict[int, ChunkedByteBufferOutputStream] = {}
        self._recycled: List = []
        self._lengths = [0] * handle.num_partitions
        self._stopped = False
        self._dirty = False  # True once a frame reached the shared logs

    def _stream(self, pid: int) -> ChunkedByteBufferOutputStream:
        s = self._streams.get(pid)
        if s is None:
            s = ChunkedByteBufferOutputStream(
                self._conf.shuffle_write_chunk_size, recycled=self._recycled
            )
            self._streams[pid] = s
        return s

    def _flush(self, pid: int) -> None:
        """Compress the accumulated chunk data into the partition log."""
        s = self._streams.pop(pid, None)
        if s is None or s.length == 0:
            return
        cbb = s.to_chunked_byte_buffer()
        raw = b"".join(bytes(v) for v in cbb.get_chunks())
        # recycle chunk buffers for the next stream (:173-189)
        for buf, _ in cbb.take_buffers():
            self._recycled.append(buf)
        framed = frame_compressed(self._codec, raw)
        self._data.partition_writer(pid).append_frame(framed)
        self._lengths[pid] += len(framed)
        self._dirty = True
        reg = get_registry()
        role = self._manager.executor_id
        reg.counter("writer.partition_flushes", role=role).inc()
        reg.counter("writer.flush_bytes", role=role).inc(len(framed))

    def write(self, records) -> None:
        part = self._handle.partitioner.partition
        flush_size = self._conf.shuffle_write_flush_size
        if self._handle.aggregator is not None and self._handle.map_side_combine:
            records = combine_by_key(records, self._handle.aggregator).items()
        for rec in records:
            data = pickle.dumps(rec, protocol=pickle.HIGHEST_PROTOCOL)
            pid = part(rec[0])
            s = self._stream(pid)
            s.write(_LEN.pack(len(data)))
            s.write(data)
            if s.length >= flush_size:
                self._flush(pid)

    def stop(self, success: bool) -> Optional[MapStatus]:
        if self._stopped:
            return None
        self._stopped = True
        if success:
            for pid in list(self._streams.keys()):
                self._flush(pid)
        for s in self._streams.values():
            s.to_chunked_byte_buffer().dispose()
        self._streams.clear()
        for buf in self._recycled:
            buf.free()
        self._recycled.clear()
        if success:
            self._data.commit_map_output(self._manager)
            return MapStatus(self.map_id, self._lengths)
        self._data.abort_map_output(dirty=self._dirty)
        return None
