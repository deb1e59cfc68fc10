"""Device shuffle IO — HBM staging on both ends of the shuffle.

The north-star data path (SURVEY.md §7, BASELINE.json): map outputs
stage from device HBM into *registered* host memory, locations publish
to the driver hub, and reducers pull with one-sided READs landing
blocks back into pooled HBM slabs for device compute — the tiered
HBM -> host-registered -> HBM store of SURVEY.md §7.3(4).

This is the raw-block sibling of the record-oriented writer/reader
stack: same control plane (publish / fetch-locations / barrier), same
registered-memory data plane, no serializer in the way. Each published
partition block is one pooled registered buffer whose
``(mkey, 0, length)`` triple is the advertised location.

A copy of the JAX package's ``shuffle/device_io.py`` on the port's
arena (``ops/hbm_arena.py``), device fetch plane and schedule compiler,
whose waves move through the hand-written wave-pull kernels on CUDA.
What differs:

- the endpoint runs on ``cuda`` unless the caller passes
  ``device="cpu"`` (``utils/torch_compat.resolve_device``); without a
  CUDA device it raises;
- a CUDA tensor handed to ``stage_device_blocks`` reads back into the
  registered buffer's view in one device-to-host copy, and its arena
  copy is a device-to-device copy of the same tensor; numpy arrays and
  CPU tensors take the host path of the JAX endpoint (one host copy,
  then a host-to-device copy into the arena);
- mapped delivery is the native plane's (ROADMAP M4), so every host
  READ lands in a pooled registered buffer;
- the fault-plan seams (``stage=decode``, ``stage=stage``) are inert
  until ``testing/faults.py`` comes with ROADMAP item M4.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from sparkrdma_tpu_torch.locations import BlockLocation, PartitionLocation
from sparkrdma_tpu_torch.obs import get_registry
from sparkrdma_tpu_torch.ops.hbm_arena import (
    DeviceBuffer,
    DeviceBufferManager,
    _size_class,
    host_tensor,
)
from sparkrdma_tpu_torch.shuffle.collective import ShuffleScheduleCompiler
from sparkrdma_tpu_torch.shuffle.device_fetch import (
    DeviceFetchPlane,
    DevicePulledBlock,
    register_arena,
    unregister_arena,
)
from sparkrdma_tpu_torch.shuffle.errors import FetchFailedError, MetadataFetchFailedError
from sparkrdma_tpu_torch.utils.seams import faults as _faults
from sparkrdma_tpu_torch.transport import FnListener, mapped_delivery_enabled
from sparkrdma_tpu_torch.utils import checksum as _checksum

logger = logging.getLogger(__name__)


def _start_read_mapped(mgr, arrivals, idx, loc, ch):
    """Issue one mapped-delivery READ (native transport): no pooled
    destination buffer at all. Same-host blocks arrive as zero-copy
    page-cache mappings; remote ones as one malloc'd blob. Each
    in-flight read OWNS its delivery through its completion listener:
    whoever turns out to be the last owner (caller or listener)
    releases — never a timeout racing a late payload. Returns
    ``(loc, box, done, errbox, abandon_or_reclaim)``; every completion
    (success or failure) posts ``idx`` to ``arrivals``."""
    done = threading.Event()
    errbox: list = []
    box: dict = {}
    lock = threading.Lock()
    owner = {"who": "caller"}

    def on_ok(delivery):
        box["d"] = delivery
        done.set()
        with lock:
            release = owner["who"] == "listener" and not owner.get("done")
            if release:
                owner["done"] = True
        if release and delivery is not None:
            delivery.release()
        arrivals.put(idx)

    def on_fail(e):
        errbox.append(e)
        done.set()
        arrivals.put(idx)

    def abandon_or_reclaim():
        with lock:
            if done.is_set():
                completed = not owner.get("done")
                owner["done"] = True
            else:
                owner["who"] = "listener"
                completed = False
        if completed:
            d = box.get("d")
            if d is not None:
                d.release()

    ch.read_mapped_in_queue(
        FnListener(on_ok, on_fail),
        [(loc.block.mkey, loc.block.address, loc.block.length)],
    )
    return (loc, box, done, errbox, abandon_or_reclaim)


def _start_read(mgr, arrivals, idx, loc, reg, ch):
    """Issue one buffer-landing READ into pooled registered memory
    ``reg``. Same ownership dance and return shape as
    :func:`_start_read_mapped` (the second element is ``reg``)."""
    done = threading.Event()
    errbox: list = []
    lock = threading.Lock()
    owner = {"who": "caller"}  # flipped to "listener" on abandon

    def on_done(err=None):
        if err is not None:
            errbox.append(err)
        done.set()
        with lock:
            # on_failure may legally fire more than once; recycle
            # exactly once
            recycle = owner["who"] == "listener" and not owner.get("recycled")
            if recycle:
                owner["recycled"] = True
        if recycle:
            mgr.buffer_manager.put(reg)
        # duplicate posts are harmless: the arrival loop skips
        # indices it has already consumed
        arrivals.put(idx)

    def abandon_or_reclaim():
        """Caller gives up: recycle now if the read already
        completed, else hand ownership to the listener."""
        with lock:
            if done.is_set():
                completed = True
            else:
                owner["who"] = "listener"
                completed = False
        if completed:
            mgr.buffer_manager.put(reg)

    ch.read_in_queue(
        FnListener(lambda _: on_done(), on_done),
        [reg.view[: loc.block.length]],
        [(loc.block.mkey, loc.block.address, loc.block.length)],
    )
    return (loc, reg, done, errbox, abandon_or_reclaim)


class HostBlock:
    """A fetched-but-unverified shuffle block in host memory — the
    hand-off unit between the reduce pipeline's fetch stage (transport:
    :meth:`DeviceShuffleIO.fetch_host_blocks`) and its decode/staging
    stages (:meth:`verify_host_block` / :meth:`stage_host_block`).

    ``view`` spans the whole backing resource (a full slab-class pooled
    buffer, a local registered span, or a mapped window) so staging can
    hit ``stage_view``'s copy-free branch; payload bytes are
    ``data`` (= ``view[:length]``). ``release()`` is idempotent and
    returns the backing resource to wherever it came from."""

    __slots__ = ("shuffle_id", "loc", "length", "view", "kind", "_release", "_released")

    def __init__(self, shuffle_id, loc, view, kind, release):
        self.shuffle_id = shuffle_id
        self.loc = loc
        self.length = loc.block.length
        self.view = view
        self.kind = kind  # "local" | "buffer" | "mapped"
        self._release = release
        self._released = False

    @property
    def data(self):
        return self.view[: self.length]

    def release(self) -> None:
        if self._released:
            return
        self._released = True
        if self._release is not None:
            self._release()


class DeviceShuffleIO:
    """Per-executor device-block shuffle endpoint."""

    def __init__(self, manager, device=None):
        self._manager = manager
        manager.start_node_if_missing()
        conf = manager.conf
        self._dev = DeviceBufferManager(
            device=device,
            max_bytes=conf.hbm_max_bytes,
            prealloc=conf.max_agg_prealloc,
            prealloc_size=conf.max_agg_block,
            max_host_bytes=conf.hbm_host_spill_max_bytes,
            spill_dir=conf.hbm_spill_dir or None,
        )
        # published host-side registered buffers per shuffle (kept alive
        # until unpublish — the serving side of one-sided READs)
        self._published: Dict[int, List] = {}
        # device fetch plane (DESIGN.md §17): arena-staged copies of the
        # same published blocks, served HBM->HBM to mesh-visible pullers;
        # the registry entry is what makes THIS endpoint's arena visible
        self._arena_published: Dict[int, List[DeviceBuffer]] = {}
        register_arena(manager.executor_id, self._dev)
        self._plane = DeviceFetchPlane(conf, self._dev, manager.executor_id)
        # whole-stage schedule compiler (DESIGN.md §22): batches the
        # stage's device-resident blocks into compiled DMA waves; the
        # per-block plane above stays the path for its passthrough set
        self._collective = ShuffleScheduleCompiler(
            conf, self._dev, manager.executor_id,
            tracer=getattr(manager, "tracer", None),
        )
        self._lock = threading.Lock()
        # fetch-phase accounting (tunnel-vs-framework attribution):
        #   transport_s — waiting for bytes to ARRIVE in host memory
        #     (RPC, one-sided READ, pread/mmap, sockets): framework.
        #   stage_s — host -> device transfers (stage_view's copy into
        #     an arena slab): the host link, NOT framework code.
        self._fetch_stats = {
            "fetch_transport_s": 0.0,
            "fetch_stage_s": 0.0,
            "fetch_bytes": 0,
        }
        # map-side accounting (the port's addition): the readback into
        # registered memory, the checksum and the arena copy of
        # stage_device_blocks, each in seconds, and the bytes staged
        self._stage_stats = {
            "stage_copy_s": 0.0,
            "stage_checksum_s": 0.0,
            "stage_arena_s": 0.0,
            "stage_bytes": 0,
        }

    @property
    def device_buffers(self) -> DeviceBufferManager:
        return self._dev

    # ------------------------------------------------------------------
    # map side: device -> registered host memory -> locations
    # ------------------------------------------------------------------
    def stage_device_blocks(
        self,
        shuffle_id: int,
        partitions: Dict[int, "object"],
        block_format: int = 0,
    ) -> List[PartitionLocation]:
        """Stage per-partition device arrays into registered buffers and
        return their locations WITHOUT publishing — the stage half of
        the map pipeline, so the next shard's device sort can overlap
        this shard's driver RPC (publish_staged).

        ``block_format`` tags every staged block's encoding
        (``BlockLocation.FORMAT_*``). Device-staged bytes already carry
        their layout in the array dtype, so columnar-encoded payloads
        (DESIGN.md §25) advertise ``FORMAT_COLUMNAR`` here and reducers
        consume them pickle-free straight off the arena."""
        mgr = self._manager
        conf = mgr.conf
        dev_plane = conf.device_fetch_enabled
        dev_min = conf.device_fetch_min_block_bytes
        locs: List[PartitionLocation] = []
        staged = []
        arena_staged: List[DeviceBuffer] = []
        t_copy = t_ck = t_arena = 0.0
        n_bytes = 0
        for pid, arr in partitions.items():
            t0 = time.perf_counter()
            # device -> registered memory in ONE host copy: the readback
            # lands straight in the registered view (no intermediate
            # tobytes()/write() materializations — SURVEY.md §7.3(3))
            src = None
            if isinstance(arr, torch.Tensor):
                src = arr.detach().reshape(-1).contiguous()
                nbytes = src.numel() * src.element_size()
                dtype = src.dtype  # torch: bfloat16 has no numpy dtype
                buf = mgr.buffer_manager.get(nbytes)
                flat = np.frombuffer(buf.view, dtype=np.uint8, count=nbytes)
                host_tensor(flat).copy_(src.view(torch.uint8))
            else:
                host = np.asarray(arr)
                nbytes = host.nbytes
                dtype = host.dtype
                flat = host.reshape(-1).view(np.uint8)
                buf = mgr.buffer_manager.get(nbytes)
                np.frombuffer(buf.view, dtype=np.uint8, count=nbytes)[:] = flat
            staged.append(buf)
            t1 = time.perf_counter()
            t_copy += t1 - t0
            n_bytes += nbytes
            # integrity tag computed HERE, while the bytes are still
            # cache-hot from the copy above and this runs on the map
            # pool's parallel stage workers — the manager's publish-time
            # funnel (_with_checksum) skips already-tagged locations, so
            # the serial publish RPC no longer pays a CRC per block
            ck_algo = ck = 0
            if conf.resilience_checksums and nbytes:
                ck_algo, ck = _checksum.compute(flat)
            block = BlockLocation(
                0, nbytes, buf.mkey, checksum=ck, checksum_algo=ck_algo,
                block_format=block_format,
            )
            t2 = time.perf_counter()
            t_ck += t2 - t1
            if dev_plane and nbytes >= dev_min:
                # keep a second, device-resident copy in the arena and
                # advertise its coordinates: a visible reducer pulls it
                # device to device (device_fetch.py, collective.py)
                # while the host triple above stays the durable
                # fallback. A source already on the card copies device
                # to device; host bytes copy host to device. Best-effort
                # — arena pressure (MemoryError) just skips the
                # extension.
                try:
                    if src is not None and src.is_cuda:
                        abuf = self._dev.get(nbytes)
                        try:
                            abuf.put_array(src)
                        except BaseException:
                            abuf.free()
                            raise
                    else:
                        abuf = self._dev.stage_view(flat, nbytes, dtype=dtype)
                except MemoryError:
                    abuf = None
                if abuf is not None:
                    arena_staged.append(abuf)
                    block = BlockLocation(
                        0, nbytes, buf.mkey,
                        checksum=ck, checksum_algo=ck_algo,
                        device_coords=self._dev.device.index or 0,
                        arena_handle=abuf.handle,
                        arena_offset=0,
                        block_format=block_format,
                    )
            t_arena += time.perf_counter() - t2
            locs.append(PartitionLocation(mgr.local_manager_id, pid, block))
        # buffers go under shuffle ownership as soon as they're staged:
        # a publish failure (or an aborted pipeline) still releases them
        # through unpublish/stop
        with self._lock:
            self._published.setdefault(shuffle_id, []).extend(staged)
            self._arena_published.setdefault(shuffle_id, []).extend(arena_staged)
            self._stage_stats["stage_copy_s"] += t_copy
            self._stage_stats["stage_checksum_s"] += t_ck
            self._stage_stats["stage_arena_s"] += t_arena
            self._stage_stats["stage_bytes"] += n_bytes
        return locs

    def publish_staged(
        self,
        shuffle_id: int,
        locs: List[PartitionLocation],
        num_map_outputs: int = 1,
    ) -> None:
        """Publish previously staged locations (one publish = one map
        output for the driver's completeness barrier)."""
        self._manager.publish_partition_locations(
            shuffle_id, -1, locs, num_map_outputs=num_map_outputs
        )

    def publish_staged_batch(
        self,
        shuffle_id: int,
        windows: List[List[PartitionLocation]],
        num_map_outputs_each: int = 1,
    ) -> None:
        """Publish N staged shards' location windows in ONE driver RPC.

        The driver's publish handler already *sums* ``num_map_outputs``
        into its completeness barrier and keys every location by its
        own partition id, so a batch is just the concatenated windows
        plus the summed count — no new RPC type. This is the map loop's
        answer to publish contention: instead of N serial round-trips
        through the driver's per-shuffle lock, the executor pays one."""
        if not windows:
            return
        locs = [loc for window in windows for loc in window]
        self._manager.publish_partition_locations(
            shuffle_id, -1, locs,
            num_map_outputs=num_map_outputs_each * len(windows),
        )

    def publish_device_blocks(
        self,
        shuffle_id: int,
        partitions: Dict[int, "object"],
        num_map_outputs: int = 1,
    ) -> None:
        """Stage + publish in one call (the non-pipelined composition)."""
        locs = self.stage_device_blocks(shuffle_id, partitions)
        self.publish_staged(shuffle_id, locs, num_map_outputs=num_map_outputs)

    # ------------------------------------------------------------------
    # reduce side: one-sided READ -> HBM slab
    # ------------------------------------------------------------------
    def _apply_merged_plan(
        self, locations: List[PartitionLocation], my_id: str
    ) -> List[PartitionLocation]:
        """Merged-else-original read selection (shuffle/merge.py).

        A partition fully covered by a push-merged segment reads as ONE
        sequential block instead of N per-map fetches. The device plane
        only takes LOCAL merged segments (push routing lands them on
        the reducing executor; a mis-routed segment just uses the
        originals) and verifies them here — the local short-circuit in
        the fetch loops skips the per-block checksum gate, and a
        corrupted seal must detect and fall back, never surface."""
        from sparkrdma_tpu_torch.shuffle import merge as _merge

        selected, fallbacks = _merge.plan_reads(locations)
        if not fallbacks:
            return selected
        out: List[PartitionLocation] = []
        for loc in selected:
            if not loc.block.merged_cover:
                out.append(loc)
                continue
            origs = fallbacks.get(loc.partition_id, [])
            if loc.manager_id.executor_id != my_id:
                out.extend(origs)
                continue
            try:
                pd = self._manager.node.pd
                view = pd.resolve(
                    loc.block.mkey, loc.block.address, loc.block.length
                )
                if not _checksum.verify(
                    view, loc.block.checksum, loc.block.checksum_algo
                ):
                    raise ValueError("merged segment checksum mismatch")
            except Exception:
                logger.warning(
                    "merged segment for partition %d failed verification; "
                    "reading originals", loc.partition_id,
                )
                get_registry().counter("push.fallbacks", role=my_id).inc()
                get_registry().counter(
                    "resilience.checksum_failures", role=my_id
                ).inc()
                out.extend(origs)
                continue
            get_registry().counter("reader.merged_reads", role=my_id).inc()
            out.append(loc)
        return out

    def fetch_device_blocks(
        self,
        shuffle_id: int,
        start_partition: int,
        end_partition: int,
        dtype=np.uint8,
        timeout_s: Optional[float] = None,
        fused: bool = False,
    ) -> Dict[int, List[DeviceBuffer]]:
        """Pull every block of ``[start, end)`` into HBM slabs.

        Local blocks short-circuit from the publisher's own registered
        buffer (never looping through the network, SURVEY.md §5.1 #2).
        ``dtype`` types the staged slabs (host-side reinterpret; see
        ``DeviceBufferManager.stage_view``) so device consumers read
        keys, not bytes. Returns pid -> list of DeviceBuffers (caller
        frees).

        ``timeout_s`` is ONE deadline for the whole fetch (the
        reference's future-timeout wrapper semantics,
        RdmaShuffleFetcherIterator.scala:108-122) — not a per-block
        allowance, so one slow peer costs at most one timeout, never
        ``n_blocks ×``. The clock starts BEFORE the metadata RPC: the
        location fetch and the data reads share the same wall budget,
        so the worst case is 1× ``timeout_s``, not metadata-timeout +
        data-timeout. Fetched blocks are validated against their
        published checksum before staging; a mismatch earns one
        same-source refetch, then FetchFailedError.
        Arrived buffers stage in COMPLETION order while
        slower reads are still in flight: staging (the expensive
        host->device transfer) overlaps the waiting instead of
        serializing behind issue order.

        Device-resident blocks route through the whole-stage schedule
        compiler (shuffle/collective.py, DESIGN.md §22): the host READs
        for the non-device remainder are issued FIRST, then the
        compiled DMA waves run while those reads are in flight. With
        ``fused=True`` a partition fully covered by one wave lands as
        ONE merged slab (its blocks concatenated in deterministic
        source order) — callers opt in because it changes the result
        shape; the ``collective.fusedMerge`` knob is the global
        off-switch."""
        mgr = self._manager
        conf = mgr.conf
        if timeout_s is None:
            timeout_s = conf.fetch_location_timeout_ms / 1000.0
        t_transport = t_stage = 0.0
        n_bytes = 0
        # the deadline covers metadata + data: started before the
        # location RPC, and the data-wait loop below runs on whatever
        # budget that RPC left over
        deadline = time.monotonic() + timeout_s
        future = mgr.fetch_remote_partition_locations(
            shuffle_id, start_partition, end_partition
        )
        tw = time.perf_counter()
        try:
            locations: List[PartitionLocation] = future.result(
                timeout=max(0.0, deadline - time.monotonic())
            )
        except Exception as e:
            raise MetadataFetchFailedError(shuffle_id, start_partition, str(e))
        finally:
            # the location RPC is transport: bytes can't arrive before
            # the driver answers where they are
            t_transport += time.perf_counter() - tw
            with self._lock:
                self._fetch_stats["fetch_transport_s"] += t_transport
            t_transport = 0.0

        out: Dict[int, List[DeviceBuffer]] = {}
        my_id = mgr.executor_id
        locations = self._apply_merged_plan(locations, my_id)
        # whole-stage compile: device-resident blocks batch into DMA
        # waves; everything the compiler declines comes back in
        # cplan.passthrough and takes the per-block loop unchanged
        cplan = self._collective.plan(locations, dtype)
        # Each in-flight read OWNS its destination buffer through its
        # completion listener: the buffer returns to the pool only once
        # the transport is provably done writing into it (completion or
        # channel latch) — never on a timeout racing a late payload.
        pending: List[Optional[Tuple]] = []
        # completion-order wake-ups: every read completion (success or
        # failure) posts its pending index here, so the caller stages
        # whatever arrived FIRST and learns of failures immediately
        # rather than when issue order reaches them
        arrivals: "queue.Queue[int]" = queue.Queue()

        try:
            def _issue(loc, allow_pull=True):
                nonlocal t_stage, n_bytes
                if allow_pull:
                    # device plane: an arena-resident source pulls
                    # HBM->HBM and skips host transport AND staging;
                    # any planner refusal (spilled, too small, foreign
                    # arena, dtype) silently continues into the host
                    # path below
                    dev = self._plane.try_pull(loc, dtype)
                    if dev is not None:
                        out.setdefault(loc.partition_id, []).append(dev)
                        return
                if loc.manager_id.executor_id == my_id:
                    # local short-circuit straight from the registered
                    # region — DMA'd directly, never copied to bytes.
                    # Resolve up to a full slab class past the block's
                    # start (pooled regions span one, so this usually
                    # covers it) to hit stage_view's compile- and
                    # copy-free branch; only a region tail (mapped-file
                    # chunk) falls back to the host-pad branch.
                    pd = mgr.node.pd
                    avail = (
                        pd.region_length(loc.block.mkey) - loc.block.address
                    )
                    span = min(_size_class(loc.block.length), avail)
                    view = pd.resolve(loc.block.mkey, loc.block.address, span)
                    ts = time.perf_counter()
                    dev = self._dev.stage_view(view, loc.block.length, dtype)
                    t_stage += time.perf_counter() - ts
                    n_bytes += loc.block.length
                    out.setdefault(loc.partition_id, []).append(dev)
                    return
                ch = mgr.get_channel_to(loc.manager_id, purpose="data")
                if mapped_delivery_enabled(conf, ch):
                    pending.append(
                        _start_read_mapped(mgr, arrivals, len(pending), loc, ch)
                    )
                else:
                    reg = mgr.buffer_manager.get(loc.block.length)
                    pending.append(
                        _start_read(mgr, arrivals, len(pending), loc, reg, ch)
                    )

            refetched: set = set()

            def _process_arrival(idx):
                """Consume one posted completion: error gate, checksum
                gate (one same-source refetch), then host->HBM staging.
                Shared by the blocking drain loop below and the
                non-blocking drain the wave pipeline calls between
                entries — passthrough READs stage WHILE waves are in
                flight instead of queueing behind the last one."""
                nonlocal t_stage, n_bytes
                entry = pending[idx]
                if entry is None:
                    return  # duplicate completion post
                loc, obj, done, errbox, _abandon = entry
                if not done.is_set():
                    # stale post from a superseded (refetched) attempt;
                    # the live read posts idx again on completion
                    return
                if errbox:
                    mgr.health.record_failure(loc.manager_id.executor_id)
                    raise FetchFailedError(
                        loc.manager_id, shuffle_id, -1, loc.partition_id,
                        str(errbox[0]),
                    )
                # integrity gate before the expensive host->HBM stage
                if isinstance(obj, dict):
                    d = obj["d"]
                    ck_view = d.views[0] if d.views else b""
                else:
                    ck_view = obj.view[: loc.block.length]
                if not _checksum.verify(
                    ck_view, loc.block.checksum, loc.block.checksum_algo
                ):
                    if isinstance(obj, dict):
                        obj["d"].release()
                    else:
                        mgr.buffer_manager.put(obj)
                    get_registry().counter(
                        "resilience.checksum_failures", role=my_id
                    ).inc()
                    if idx in refetched:
                        mgr.health.record_failure(loc.manager_id.executor_id)
                        raise FetchFailedError(
                            loc.manager_id, shuffle_id, -1, loc.partition_id,
                            "checksum mismatch persisted across refetch",
                        )
                    refetched.add(idx)
                    get_registry().counter(
                        "resilience.retries", role=my_id
                    ).inc()
                    ch = mgr.get_channel_to(loc.manager_id, purpose="data")
                    if isinstance(obj, dict):
                        pending[idx] = _start_read_mapped(mgr, arrivals, idx, loc, ch)
                    else:
                        reg2 = mgr.buffer_manager.get(loc.block.length)
                        pending[idx] = _start_read(mgr, arrivals, idx, loc, reg2, ch)
                    return
                mgr.health.record_success(loc.manager_id.executor_id)
                ts = time.perf_counter()
                if isinstance(obj, dict):
                    # mapped delivery: stage straight from the page-cache
                    # mapping (or fallback blob) — the socket/pread copy
                    # of the buffer path never happened. stage_view
                    # blocks until the device transfer completes, so
                    # releasing the mapping right after is safe.
                    d = obj["d"]
                    view = d.views[0] if d.views else b""
                    dev = self._dev.stage_view(view, loc.block.length, dtype)
                    d.release()
                else:
                    # registered buffer -> device slab directly (one
                    # copy: the pooled source spans a full slab class);
                    # the buffer returns to the pool only after the
                    # transfer, which stage_view completes before it
                    # returns
                    dev = self._dev.stage_view(obj.view, loc.block.length, dtype)
                    mgr.buffer_manager.put(obj)  # pooled reuse, not a cold free
                t_stage += time.perf_counter() - ts
                n_bytes += loc.block.length
                pending[idx] = None
                out.setdefault(loc.partition_id, []).append(dev)

            def _drain_ready():
                # non-blocking: consume whatever already landed, return
                # the moment the queue is dry — never waits on transport
                while True:
                    try:
                        idx = arrivals.get_nowait()
                    except queue.Empty:
                        return
                    _process_arrival(idx)

            for loc in cplan.passthrough:
                _issue(loc)
            # compiled waves run NOW, while the host READs issued above
            # are in flight — DMA epochs overlap host-plane transport,
            # and the drain callback consumes landed READs between
            # pipeline entries (before the waves finish)
            results, degraded = self._collective.execute(
                shuffle_id, cplan, dtype, fused=fused, drain=_drain_ready
            )
            for r in results:
                out.setdefault(r.pid, []).append(r.dev)
            # rows the waves lost (evicted mid-stage, mover surprise)
            # re-issue through the host path: silent, byte-identical
            for loc in degraded:
                _issue(loc, allow_pull=False)

            while any(e is not None for e in pending):
                budget = deadline - time.monotonic()
                tw = time.perf_counter()
                try:
                    if budget > 0:
                        idx = arrivals.get(timeout=budget)
                    else:
                        # the deadline bounds the WAITING, not the
                        # consumption of reads that already landed:
                        # staging time (host->HBM transfers) may have
                        # eaten the budget while completions queued up —
                        # drain those without blocking before failing
                        idx = arrivals.get_nowait()
                except queue.Empty:
                    # the final (possibly full-budget) wait is transport
                    # time too — without this the failure case records
                    # near-zero transport for a fetch that spent its
                    # whole wall waiting on it
                    t_transport += time.perf_counter() - tw
                    # deadline spent with reads still outstanding
                    left = [e for e in pending if e is not None]
                    slow = left[0][0]
                    raise FetchFailedError(
                        slow.manager_id, shuffle_id, -1, slow.partition_id,
                        f"fetch deadline ({timeout_s:.1f}s) exceeded with "
                        f"{len(left)} block(s) outstanding",
                    )
                t_transport += time.perf_counter() - tw
                _process_arrival(idx)
            return out
        except Exception:
            # release everything: staged device slabs are freed here;
            # each unconsumed destination buffer is recycled atomically
            # by whichever side (caller / completion listener) turns out
            # to be its last owner
            for bufs in out.values():
                for dev in bufs:
                    dev.free()
            for entry in pending:
                if entry is None:
                    continue
                entry[4]()  # abandon_or_reclaim
            raise
        finally:
            with self._lock:
                self._fetch_stats["fetch_transport_s"] += t_transport
                self._fetch_stats["fetch_stage_s"] += t_stage
                self._fetch_stats["fetch_bytes"] += n_bytes
            reg = get_registry()
            reg.histogram("device_fetch.transport_ms").observe(t_transport * 1e3)
            reg.histogram("device_fetch.stage_ms").observe(t_stage * 1e3)
            reg.counter("device_fetch.bytes").inc(n_bytes)

    # ------------------------------------------------------------------
    # reduce side, split-phase: the ReduceTaskPipeline's stage bodies
    # (DESIGN.md §16). fetch_host_blocks is transport only; checksum
    # verification moves to verify_host_block (a decode-pool worker) and
    # host->HBM transfer to stage_host_block (the staging thread), so
    # the three overlap across groups instead of serializing per block
    # the way fetch_device_blocks does.
    # ------------------------------------------------------------------
    def fetch_host_blocks(
        self,
        shuffle_id: int,
        start_partition: int,
        end_partition: int,
        timeout_s: Optional[float] = None,
        dtype=np.uint8,
    ) -> Dict[int, List[HostBlock]]:
        """Transport half of a reduce-group fetch: pull every block of
        ``[start, end)`` into host memory and return unverified
        :class:`HostBlock` handles (pid -> blocks, each list in
        completion order). No checksum, no HBM staging — those belong
        to :meth:`verify_host_block` / :meth:`stage_host_block` on
        later pipeline stages. Same single-deadline semantics and
        ownership rules as :meth:`fetch_device_blocks`; the caller owns
        every returned handle (``release()`` in a finally).

        ``dtype`` is the slab type :meth:`stage_host_block` will later
        be asked for: the device-pull planner needs it up front (a
        pulled slab arrives typed), so callers that stage non-uint8
        pass it here too. Blocks the planner claims come back as
        :class:`DevicePulledBlock` entries — already in HBM, flowing
        through the same verify/stage seams."""
        mgr = self._manager
        conf = mgr.conf
        if timeout_s is None:
            timeout_s = conf.fetch_location_timeout_ms / 1000.0
        t_transport = 0.0
        n_bytes = 0
        deadline = time.monotonic() + timeout_s
        future = mgr.fetch_remote_partition_locations(
            shuffle_id, start_partition, end_partition
        )
        tw = time.perf_counter()
        try:
            locations: List[PartitionLocation] = future.result(
                timeout=max(0.0, deadline - time.monotonic())
            )
        except Exception as e:
            raise MetadataFetchFailedError(shuffle_id, start_partition, str(e))
        finally:
            t_transport += time.perf_counter() - tw

        out: Dict[int, List[HostBlock]] = {}
        my_id = mgr.executor_id
        locations = self._apply_merged_plan(locations, my_id)
        # whole-stage compile, UNFUSED: the split-phase pipeline's
        # verify/stage seams are per block, so every wave row comes
        # back as its own DevicePulledBlock
        cplan = self._collective.plan(locations, dtype)
        pending: List[Optional[Tuple]] = []
        arrivals: "queue.Queue[int]" = queue.Queue()
        try:
            def _issue(loc, allow_pull=True):
                nonlocal n_bytes
                if allow_pull:
                    dev = self._plane.try_pull(loc, dtype)
                    if dev is not None:
                        out.setdefault(loc.partition_id, []).append(
                            DevicePulledBlock(shuffle_id, loc, dev)
                        )
                        return
                if loc.manager_id.executor_id == my_id:
                    # local short-circuit: the handle aliases the
                    # publisher's registered span directly (released by
                    # unpublish, so release() is a no-op); span up to a
                    # full slab class for stage_view's copy-free branch
                    pd = mgr.node.pd
                    avail = (
                        pd.region_length(loc.block.mkey) - loc.block.address
                    )
                    span = min(_size_class(loc.block.length), avail)
                    view = pd.resolve(loc.block.mkey, loc.block.address, span)
                    n_bytes += loc.block.length
                    out.setdefault(loc.partition_id, []).append(
                        HostBlock(shuffle_id, loc, view, "local", None)
                    )
                    return
                ch = mgr.get_channel_to(loc.manager_id, purpose="data")
                if mapped_delivery_enabled(conf, ch):
                    pending.append(
                        _start_read_mapped(mgr, arrivals, len(pending), loc, ch)
                    )
                else:
                    reg = mgr.buffer_manager.get(loc.block.length)
                    pending.append(
                        _start_read(mgr, arrivals, len(pending), loc, reg, ch)
                    )

            def _process_arrival(idx):
                """Wrap one landed READ as a HostBlock handle. Shared
                by the blocking drain loop and the wave pipeline's
                between-entry drain (host transport completes while
                DMA waves are still in flight)."""
                nonlocal n_bytes
                entry = pending[idx]
                if entry is None:
                    return  # duplicate completion post
                loc, obj, done, errbox, _abandon = entry
                if not done.is_set():
                    return
                if errbox:
                    mgr.health.record_failure(loc.manager_id.executor_id)
                    raise FetchFailedError(
                        loc.manager_id, shuffle_id, -1, loc.partition_id,
                        str(errbox[0]),
                    )
                mgr.health.record_success(loc.manager_id.executor_id)
                if isinstance(obj, dict):
                    d = obj["d"]
                    view = d.views[0] if d.views else memoryview(b"")
                    hb = HostBlock(shuffle_id, loc, view, "mapped", d.release)
                else:
                    hb = HostBlock(
                        shuffle_id, loc, obj.view, "buffer",
                        lambda o=obj: mgr.buffer_manager.put(o),
                    )
                n_bytes += loc.block.length
                pending[idx] = None
                out.setdefault(loc.partition_id, []).append(hb)

            def _drain_ready():
                while True:
                    try:
                        idx = arrivals.get_nowait()
                    except queue.Empty:
                        return
                    _process_arrival(idx)

            for loc in cplan.passthrough:
                _issue(loc)
            # waves overlap the in-flight host READs issued above; the
            # drain callback consumes landed READs between pipeline
            # entries
            results, degraded = self._collective.execute(
                shuffle_id, cplan, dtype, fused=False, drain=_drain_ready
            )
            for r in results:
                out.setdefault(r.pid, []).append(
                    DevicePulledBlock(shuffle_id, r.locs[0], r.dev)
                )
            for loc in degraded:
                _issue(loc, allow_pull=False)

            while any(e is not None for e in pending):
                budget = deadline - time.monotonic()
                tw = time.perf_counter()
                try:
                    if budget > 0:
                        idx = arrivals.get(timeout=budget)
                    else:
                        idx = arrivals.get_nowait()
                except queue.Empty:
                    t_transport += time.perf_counter() - tw
                    left = [e for e in pending if e is not None]
                    slow = left[0][0]
                    raise FetchFailedError(
                        slow.manager_id, shuffle_id, -1, slow.partition_id,
                        f"fetch deadline ({timeout_s:.1f}s) exceeded with "
                        f"{len(left)} block(s) outstanding",
                    )
                t_transport += time.perf_counter() - tw
                _process_arrival(idx)
            return out
        except Exception:
            for blocks in out.values():
                for hb in blocks:
                    hb.release()
            for entry in pending:
                if entry is None:
                    continue
                entry[4]()  # abandon_or_reclaim
            raise
        finally:
            with self._lock:
                self._fetch_stats["fetch_transport_s"] += t_transport
                self._fetch_stats["fetch_bytes"] += n_bytes
            reg_ = get_registry()
            reg_.histogram("device_fetch.transport_ms").observe(t_transport * 1e3)
            reg_.counter("device_fetch.bytes").inc(n_bytes)

    def _refetch_host_block(self, hb: HostBlock) -> HostBlock:
        """One bounded synchronous re-read of a block whose payload
        failed the decode-stage checksum gate. ``hb`` must already be
        released by the caller."""
        mgr = self._manager
        loc = hb.loc
        if loc.manager_id.executor_id == mgr.executor_id:
            pd = mgr.node.pd
            avail = pd.region_length(loc.block.mkey) - loc.block.address
            span = min(_size_class(loc.block.length), avail)
            view = pd.resolve(loc.block.mkey, loc.block.address, span)
            return HostBlock(hb.shuffle_id, loc, view, "local", None)
        conf = mgr.conf
        timeout_s = conf.fetch_location_timeout_ms / 1000.0
        arrivals: "queue.Queue[int]" = queue.Queue()
        ch = mgr.get_channel_to(loc.manager_id, purpose="data")
        tw = time.perf_counter()
        if mapped_delivery_enabled(conf, ch):
            entry = _start_read_mapped(mgr, arrivals, 0, loc, ch)
        else:
            reg = mgr.buffer_manager.get(loc.block.length)
            entry = _start_read(mgr, arrivals, 0, loc, reg, ch)
        _loc, obj, done, errbox, abandon = entry
        ok = done.wait(timeout_s)
        t = time.perf_counter() - tw
        with self._lock:
            self._fetch_stats["fetch_transport_s"] += t
            if ok and not errbox:
                self._fetch_stats["fetch_bytes"] += loc.block.length
        get_registry().histogram("device_fetch.transport_ms").observe(t * 1e3)
        if not ok:
            abandon()  # read still in flight: listener becomes the owner
            raise FetchFailedError(
                loc.manager_id, hb.shuffle_id, -1, loc.partition_id,
                f"refetch deadline ({timeout_s:.1f}s) exceeded",
            )
        if errbox:
            abandon()  # completed with error: recycles the destination
            mgr.health.record_failure(loc.manager_id.executor_id)
            raise FetchFailedError(
                loc.manager_id, hb.shuffle_id, -1, loc.partition_id,
                str(errbox[0]),
            )
        get_registry().counter("device_fetch.bytes").inc(loc.block.length)
        if isinstance(obj, dict):
            d = obj["d"]
            view = d.views[0] if d.views else memoryview(b"")
            return HostBlock(hb.shuffle_id, loc, view, "mapped", d.release)
        return HostBlock(
            hb.shuffle_id, loc, obj.view, "buffer",
            lambda o=obj: mgr.buffer_manager.put(o),
        )

    def verify_host_block(self, hb: HostBlock) -> HostBlock:
        """Decode-stage integrity gate (runs on a decode-pool worker):
        validate ``hb`` against its published checksum. A mismatch
        earns one synchronous same-source refetch, then
        FetchFailedError — the same ladder as the fused path, moved off
        the transport thread so refetches stall one group's decode, not
        every group's fetch. Returns the verified handle (possibly a
        fresh one; the failed one is released). The ``stage`` fault
        seam (``stage=decode``) fires here, modeling corruption that
        happens AFTER the wire delivered intact bytes."""
        mgr = self._manager
        my_id = mgr.executor_id
        if isinstance(hb, DevicePulledBlock):
            # device path: the checksum was verified at publish on the
            # same staged bytes and the pull is a DMA, not a socket —
            # trusted, no host bytes to gate (DESIGN.md §17)
            return hb
        plan = _faults.active()
        if plan is not None:
            plan.on_stage("decode", [hb.data])
        loc = hb.loc
        if _checksum.verify(hb.data, loc.block.checksum, loc.block.checksum_algo):
            return hb
        hb.release()
        reg_ = get_registry()
        reg_.counter("resilience.checksum_failures", role=my_id).inc()
        reg_.counter("resilience.retries", role=my_id).inc()
        fresh = self._refetch_host_block(hb)
        if _checksum.verify(
            fresh.data, loc.block.checksum, loc.block.checksum_algo
        ):
            mgr.health.record_success(loc.manager_id.executor_id)
            return fresh
        fresh.release()
        reg_.counter("resilience.checksum_failures", role=my_id).inc()
        mgr.health.record_failure(loc.manager_id.executor_id)
        raise FetchFailedError(
            loc.manager_id, hb.shuffle_id, -1, loc.partition_id,
            "checksum mismatch persisted across refetch",
        )

    def stage_host_block(self, hb: HostBlock, dtype=np.uint8) -> DeviceBuffer:
        """Host -> HBM half (runs on the staging thread): transfer a
        verified block into a pooled device slab and release the host
        resource. ``stage_view`` blocks until the device transfer
        completes, so releasing right after is safe. The ``stage``
        fault seam (``stage=stage``) fires before the transfer.

        A :class:`DevicePulledBlock` is already an HBM slab: ownership
        transfers to the caller with no transfer, no release, no fault
        seam (there are no host bytes to corrupt)."""
        if isinstance(hb, DevicePulledBlock):
            return hb.take()
        plan = _faults.active()
        if plan is not None:
            plan.on_stage("stage", [hb.data])
        ts = time.perf_counter()
        try:
            dev = self._dev.stage_view(hb.view, hb.length, dtype)
        finally:
            hb.release()
            t = time.perf_counter() - ts
            with self._lock:
                self._fetch_stats["fetch_stage_s"] += t
            get_registry().histogram("device_fetch.stage_ms").observe(t * 1e3)
        return dev

    # ------------------------------------------------------------------
    def metrics_snapshot(self) -> dict:
        """Manager counters + the device (HBM) pool's: allocation per
        size class, live budget, and host-tier spill count."""
        snap = self._manager.metrics_snapshot()
        snap["hbm_pool_allocs_by_class"] = {
            str(k): v for k, v in self._dev.stats().items()
        }
        snap["hbm_in_use_bytes"] = self._dev.in_use_bytes
        snap["hbm_spill_count"] = self._dev.spill_count
        snap["hbm_disk_spill_count"] = self._dev.disk_spill_count
        with self._lock:
            snap.update(
                {k: round(v, 3) if isinstance(v, float) else v
                 for k, v in self._fetch_stats.items()}
            )
            snap.update(self._stage_stats)
        return snap

    def unpublish(self, shuffle_id: int) -> None:
        """Release the registered buffers serving a shuffle's blocks,
        and the arena copies the device plane advertised. A puller
        racing this free sees the handle gone (or the slab recycled)
        at its residency re-check and degrades to host fetch — which
        then also finds the host buffer gone only if the whole shuffle
        is being torn down, the pre-existing contract."""
        with self._lock:
            staged = self._published.pop(shuffle_id, [])
            arena = self._arena_published.pop(shuffle_id, [])
        for buf in staged:
            self._manager.buffer_manager.put(buf)
        for abuf in arena:
            abuf.free()

    def stop(self) -> None:
        with self._lock:
            shuffles = set(self._published.keys()) | set(
                self._arena_published.keys()
            )
        for sid in shuffles:
            self.unpublish(sid)
        unregister_arena(self._manager.executor_id, self._dev)
        self._dev.stop()
