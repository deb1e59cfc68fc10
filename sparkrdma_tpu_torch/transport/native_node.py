"""NativeTpuNode / NativeTpuChannel — host transport over the C++ data plane.

Same public surface as the pure-Python :class:`TpuNode`/:class:`TpuChannel`
(node.py / channel.py) and the same wire format, but every per-byte
operation — frame parsing, the passive one-sided READ service, payload
streaming into destination buffers, socket IO — runs inside
``transport.cpp``'s epoll loop. Python keeps orchestration only:
channel caching, retry policy, listener dispatch (one CQ-poll thread
per node, the RdmaThread analogue pinned to ``srt_poll_cq``).

This is the framework's libdisni equivalent (SURVEY.md §2.2): the
reference's JVM held the same division — Scala/Java orchestration above,
native verbs doing the bytes below. Selected via
``tpu.shuffle.transport = native`` (``auto`` resolves to it where the
library builds); both transports interoperate on the wire, so a cluster
can mix them.

A copy of the JAX package's ``transport/native_node.py``, its imports
rewritten to this package; the node takes its library from the port's
loader (``native/transport_lib.py``), which raises when g++ cannot build
it.
"""

from __future__ import annotations

import ctypes
import logging
import os
import queue
import threading
import time
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np

from sparkrdma_tpu_torch.memory.buffer_manager import TpuBufferManager
from sparkrdma_tpu_torch.native import transport_lib as tl
from sparkrdma_tpu_torch.obs import get_registry
from sparkrdma_tpu_torch.testing import faults as _faults
from sparkrdma_tpu_torch.transport import wire
from sparkrdma_tpu_torch.transport.channel import ChannelError
from sparkrdma_tpu_torch.transport.completion import CompletionListener
from sparkrdma_tpu_torch.utils.config import TpuShuffleConf

logger = logging.getLogger(__name__)


def _addr_of(view) -> int:
    """Raw address of a buffer-protocol object without copying (works
    for read-only buffers too, unlike ctypes.from_buffer)."""
    return np.frombuffer(view, dtype=np.uint8).ctypes.data


class MappedDelivery:
    """Result of a mapped one-sided READ (``read_mapped_in_queue``).

    ``views`` holds one read-only memoryview per requested block, in
    request order. On the same-host fast path the views are mmap'd
    page-cache windows of the peer's backing files — the bytes were
    never copied anywhere; consumers read them in place (stage to the
    device, checksum, parse) and then MUST call :meth:`release` to
    drop the mappings. On the streamed fallback (remote peer, unbacked
    region) the views slice one malloc'd blob that release() frees.
    Either way: views are INVALID after release()."""

    __slots__ = ("views", "mapped", "_free", "_released")

    def __init__(self, views, mapped: bool, free_fn):
        self.views = views
        self.mapped = mapped  # True: zero-copy mmap; False: copied blob
        self._free = free_fn
        self._released = False

    def release(self) -> None:
        if self._released:
            return
        self._released = True
        self.views = []
        self._free()

    def __del__(self):  # leak guard: mappings must not outlive the GC
        try:
            self.release()
        except Exception:
            pass


class NativeProtectionDomain:
    """PD over the native region registry.

    ``register`` inserts the region into the C++ registry (so remote
    one-sided READs are served entirely natively) and mirrors it in a
    Python dict so local consumers can still ``resolve`` views."""

    supports_file_regions = True  # file hints feed the same-host pread path

    def __init__(self, node: "NativeTpuNode"):
        self._node = node
        self._mirror: Dict[int, memoryview] = {}
        self._lock = threading.Lock()

    def register(
        self,
        view: memoryview,
        file_path: Optional[str] = None,
        file_offset: int = 0,
        file_mutable: bool = False,
        file_stat: Optional[os.stat_result] = None,
    ) -> int:
        """Register a region; when ``file_path`` names a file whose
        bytes at ``file_offset`` are identical to the region (an shm
        slab or a mapped shuffle file), same-host peers serve READs by
        pread-ing it straight from page cache instead of streaming.

        ``file_stat`` should be the caller's ``os.fstat`` of the SAME
        fd that backs the region's mapping — identity taken from a
        fresh ``os.stat(path)`` (the fallback) can race a concurrent
        rewrite of the path. ``file_mutable`` declares the backing's
        content may change after registration while staying equal to
        the region memory (shm slabs: the file pages ARE the region);
        immutable backings (committed shuffle files) get a full
        (dev, ino, size, mtime_ns) identity check so a task re-attempt
        rewriting the same path can never serve wrong bytes
        (transport.cpp READ_FILE wire doc)."""
        np_handle = self._node._np
        if not np_handle:
            raise RuntimeError("native node stopped; cannot register regions")
        if file_path:
            if file_stat is None:
                try:
                    file_stat = os.stat(file_path)
                except OSError:
                    file_stat = None
            if file_stat is None:
                # unverifiable backing: plain streamed region
                mkey = tl.require().srt_reg(np_handle, _addr_of(view), len(view))
            else:
                size_id = 0 if file_mutable else file_stat.st_size
                mtime_id = 0 if file_mutable else file_stat.st_mtime_ns
                mkey = tl.require().srt_reg_file(
                    np_handle, _addr_of(view), len(view),
                    file_path.encode(), file_offset,
                    file_stat.st_dev, file_stat.st_ino, size_id, mtime_id,
                )
        else:
            mkey = tl.require().srt_reg(np_handle, _addr_of(view), len(view))
        with self._lock:
            self._mirror[mkey] = view
        return mkey

    def deregister(self, mkey: int) -> None:
        np_handle = self._node._np
        if np_handle:
            tl.require().srt_dereg(np_handle, mkey)
        with self._lock:
            self._mirror.pop(mkey, None)

    def region_length(self, mkey: int) -> int:
        from sparkrdma_tpu_torch.memory.registry import RegionError

        with self._lock:
            view = self._mirror.get(mkey)
        if view is None:
            raise RegionError(f"unknown mkey {mkey}")
        return len(view)

    def resolve(self, mkey: int, offset: int, length: int) -> memoryview:
        from sparkrdma_tpu_torch.memory.registry import RegionError

        with self._lock:
            view = self._mirror.get(mkey)
        if view is None:
            raise RegionError(f"unknown mkey {mkey}")
        if offset < 0 or length < 0 or offset + length > len(view):
            raise RegionError(
                f"resolve out of bounds: mkey {mkey} [{offset}, {offset + length}) "
                f"in region of {len(view)}"
            )
        return view[offset : offset + length]

    def region_count(self) -> int:
        with self._lock:
            return len(self._mirror)

    def dealloc(self) -> None:
        with self._lock:
            keys = list(self._mirror.keys())
            self._mirror.clear()
        lib = tl.require()
        if lib is not None and self._node._np:
            for mkey in keys:
                lib.srt_dereg(self._node._np, mkey)


class NativeTpuChannel:
    """Handle to one native connection (id-based).

    Carries the reference's **send-budget** semantics
    (RdmaChannel.java:54-56, 330-358): ``send_queue_depth`` permits per
    channel, one per WR (send segment or read block); WRs that cannot
    acquire permits queue in an overflow deque drained as completions
    reclaim, with a one-time oversubscription warning."""

    def __init__(self, node: "NativeTpuNode", channel_id: int, peer_desc: str,
                 purpose: str = "rpc"):
        self._node = node
        self.channel_id = channel_id
        self.peer_desc = peer_desc
        self.purpose = purpose
        self._dead = threading.Event()
        self._budget = node.conf.send_queue_depth
        self._budget_lock = threading.Lock()
        self._overflow: "list" = []
        self._warned_oversubscription = False
        # same metric names as the pure-Python TpuChannel so registry
        # views stay transport-agnostic; per-byte completions live in
        # the C++ loop, so only the Python-visible verbs are counted
        reg = get_registry()
        self._m_sends = reg.counter("transport.sends", purpose=purpose)
        self._m_send_bytes = reg.counter("transport.send_bytes", purpose=purpose)
        self._m_reads = reg.counter("transport.reads", purpose=purpose)
        self._m_read_bytes = reg.counter("transport.read_bytes", purpose=purpose)
        self._m_overflow = reg.counter("transport.send_overflow", purpose=purpose)

    def _acquire_or_queue(self, permits: int, item) -> bool:
        with self._budget_lock:
            if self._budget >= permits:
                self._budget -= permits
                return True
            if not self._warned_oversubscription:
                self._warned_oversubscription = True
                logger.warning(
                    "channel %s send queue oversubscribed; consider raising "
                    "tpu.shuffle.sendQueueDepth (current %d)",
                    self.peer_desc, self._node.conf.send_queue_depth,
                )
            self._m_overflow.inc()
            self._overflow.append(item)
            return False

    def _reclaim(self, permits: int) -> None:
        runnable = []
        with self._budget_lock:
            self._budget += permits
            while self._overflow:
                p, fn = self._overflow[0]
                if self._budget < p:
                    break
                self._budget -= p
                runnable.append(fn)
                self._overflow.pop(0)
        for fn in runnable:
            fn()

    def _wrap_reclaim(self, listener: Optional[CompletionListener], permits: int):
        from sparkrdma_tpu_torch.transport.completion import FnListener

        def ok(payload):
            self._reclaim(permits)
            if listener:
                listener.on_success(payload)

        def err(e):
            self._reclaim(permits)
            if listener:
                listener.on_failure(e)

        return FnListener(ok, err)

    def _ring_wrap(self, listener: Optional[CompletionListener], nbytes: int):
        """Stamp the READ's submit→complete interval into the node's
        timestamp ring (critical-path attribution, obs/critpath.py):
        the native data plane is otherwise span-dark — completions fire
        on the C++ epoll loop with no Python frame to trace."""
        from sparkrdma_tpu_torch.transport.completion import FnListener

        t0 = time.perf_counter()
        ring = self._node._read_ring

        def ok(payload):
            ring.append((t0, time.perf_counter(), nbytes))
            if listener:
                listener.on_success(payload)

        def err(e):
            if listener:
                listener.on_failure(e)

        return FnListener(ok, err)

    # -- verb API (parity with TpuChannel) -----------------------------
    def send_in_queue(self, listener: CompletionListener, segments: Sequence[bytes]) -> None:
        plan = _faults.active()
        if plan is not None:
            listener, handled = plan.on_send(self, listener, segments)
            if handled:
                return
        segments = [bytes(s) for s in segments]
        self._m_sends.inc(len(segments))
        self._m_send_bytes.inc(sum(len(s) for s in segments))
        permits = max(1, len(segments))
        wrapped = self._wrap_reclaim(listener, permits)
        def post():
            self._node._post_send(self, wrapped, segments)

        if self._acquire_or_queue(permits, (permits, post)):
            post()

    def read_in_queue(
        self,
        listener: CompletionListener,
        dst_views: List[memoryview],
        blocks: List[Tuple[int, int, int]],
    ) -> None:
        plan = _faults.active()
        if plan is not None:
            listener, handled = plan.on_read(self, listener, dst_views, blocks)
            if handled:
                return
        total = sum(b[2] for b in blocks)
        if sum(len(v) for v in dst_views) != total:
            raise ValueError("destination size != total remote block length")
        self._m_reads.inc(len(blocks))
        self._m_read_bytes.inc(total)
        permits = max(1, len(blocks))
        wrapped = self._wrap_reclaim(self._ring_wrap(listener, total), permits)
        def post():
            self._node._post_read(self, wrapped, dst_views, blocks)

        if self._acquire_or_queue(permits, (permits, post)):
            post()

    def read_mapped_in_queue(
        self,
        listener: CompletionListener,
        blocks: List[Tuple[int, int, int]],
    ) -> None:
        """One-sided READ with mapped delivery: no destination buffer.
        ``listener.on_success`` receives a :class:`MappedDelivery` —
        same-host file-backed blocks arrive as zero-copy page-cache
        mappings; anything else falls back to one streamed copy. The
        listener owns the delivery and must release() it."""
        plan = _faults.active()
        if plan is not None:
            # dst_views=None marks the mapped (read-only delivery) flavor
            listener, handled = plan.on_read(self, listener, None, blocks)
            if handled:
                return
        total = sum(b[2] for b in blocks)
        self._m_reads.inc(len(blocks))
        self._m_read_bytes.inc(total)
        permits = max(1, len(blocks))
        wrapped = self._wrap_reclaim(self._ring_wrap(listener, total), permits)
        def post():
            self._node._post_read_mapped(self, wrapped, blocks)

        if self._acquire_or_queue(permits, (permits, post)):
            post()

    @property
    def is_connected(self) -> bool:
        return not self._dead.is_set()

    def stop(self) -> None:
        self._node._close_channel(self)


class NativeTpuNode:
    """Per-process endpoint over the native event loop (TpuNode parity)."""

    def __init__(
        self,
        conf: TpuShuffleConf,
        host: str,
        is_executor: bool,
        executor_id: str,
        recv_listener: Optional[Callable] = None,
        peer_lost_listener: Optional[Callable[[str], None]] = None,
    ):
        # a failed build raises NativeBuildError with g++'s stderr: a
        # native node is never quietly replaced by another plane
        lib = tl.require()
        self._lib = lib
        self.conf = conf
        self.host = host
        self.is_executor = is_executor
        self.executor_id = executor_id
        self._recv_listener = recv_listener
        self._peer_lost_listener = peer_lost_listener

        base_port = conf.executor_port if is_executor else conf.driver_port
        self._np = lib.srt_node_create(
            host.encode(), base_port, conf.port_max_retries
        )
        if not self._np:
            raise ChannelError("could not bind a listener port (native)")
        self.port = lib.srt_node_port(self._np)

        self.pd = NativeProtectionDomain(self)
        self.buffer_manager = TpuBufferManager(
            self.pd,
            is_executor=is_executor,
            max_agg_block=conf.max_agg_block,
            max_agg_prealloc=conf.max_agg_prealloc,
        )

        self._channels: Dict[int, NativeTpuChannel] = {}  # id -> handle
        self._active: Dict[Tuple[str, int, str], NativeTpuChannel] = {}
        # passive channels per (peer executor_id, kind): an RPC and a
        # DATA connection from the same peer coexist (reference channel
        # roles, RdmaChannel.java:110-154)
        self._passive: Dict[Tuple[str, int, int], NativeTpuChannel] = {}
        self._peer_of_channel: Dict[int, str] = {}
        self._connect_locks: Dict[Tuple[str, int, str], threading.Lock] = {}
        self._lock = threading.Lock()

        # outstanding work requests: wr_id -> (listener, keepalive)
        self._wrs: Dict[int, Tuple[CompletionListener, object]] = {}
        self._next_wr = 1
        # READ submit→complete timestamp ring (bounded; appended from
        # completion threads, drained by the fetcher into
        # ``transport.native_read`` spans — obs/critpath.py host-read
        # attribution). deque ops are atomic, so no extra lock.
        self._read_ring: Deque[Tuple[float, float, int]] = deque(maxlen=4096)
        # mapped READs in flight: wr_id -> block lengths (for slicing a
        # streamed-fallback blob back into per-block views)
        self._mapped_wrs: Dict[int, List[int]] = {}

        if not conf.file_fastpath:
            # bench/remote-simulation knob: stream every non-mapped READ
            lib.srt_set_file_fastpath(self._np, 0)
        if conf.file_workers > 1:
            lib.srt_set_file_workers(self._np, conf.file_workers)
        if conf.force_sendfile:
            lib.srt_set_force_sendfile(self._np, 1)
        backend = conf.native_read_backend
        if backend != "auto":
            lib.srt_set_read_backend(self._np, tl.READ_BACKENDS[backend])

        # consume lanes: READ_DONE checksum+decode sharded across
        # threads, routed by channel so per-source completion order is
        # preserved (the reduce pipeline's sequencer restores global
        # order — delivery stays byte-identical). 1 lane degenerates to
        # the old inline consume on the poll thread.
        reg = get_registry()
        self._consume_workers = conf.native_consume_workers
        self._m_consume_busy = reg.counter("transport.consume.busy_ms")
        self._consume_lanes: List["queue.SimpleQueue"] = []
        self._consume_threads: List[threading.Thread] = []
        if self._consume_workers > 1:
            # gauge counts lanes actually running: inline consume
            # (workers == 1) contributes nothing (OBSERVABILITY.md)
            reg.gauge("transport.consume.workers").add(self._consume_workers)
            for i in range(self._consume_workers):
                lane: "queue.SimpleQueue" = queue.SimpleQueue()
                t = threading.Thread(
                    target=self._consume_loop, args=(lane,),
                    name=f"srt-consume-{executor_id}-{i}", daemon=True,
                )
                self._consume_lanes.append(lane)
                self._consume_threads.append(t)
                t.start()

        # submission-plane counter mirror: native atomics -> registry
        # counters, synced as deltas from the poll thread (~1 Hz)
        self._sq_synced = {
            "submits": 0, "batches": 0, "completions": 0,
            "backend_fallbacks": 0,
        }
        self._sq_next_sync = 0.0

        self._stopped = threading.Event()
        self._cq_thread = threading.Thread(
            target=self._poll_loop, name=f"srt-cq-{executor_id}", daemon=True
        )
        self._cq_thread.start()
        logger.info(
            "NativeTpuNode %s listening on %s:%d (%s)",
            executor_id, host, self.port,
            "executor" if is_executor else "driver",
        )

    # ------------------------------------------------------------------
    # verb posting
    # ------------------------------------------------------------------
    def _alloc_wr(self, listener: CompletionListener, keepalive=None) -> int:
        with self._lock:
            wr = self._next_wr
            self._next_wr += 1
            self._wrs[wr] = (listener, keepalive)
        return wr

    def _post_send(self, ch: NativeTpuChannel, listener, segments: Sequence[bytes]) -> None:
        if ch._dead.is_set():
            if listener:
                listener.on_failure(ChannelError(f"channel {ch.peer_desc} is down"))
            return
        wr = self._alloc_wr(listener)
        n = len(segments)
        for i, seg in enumerate(segments):
            seg = bytes(seg)
            # only the last frame of the batch is signalled (the
            # reference signals only the last WR of a list, :383-390)
            self._lib.srt_post_send(
                self._np, ch.channel_id, seg, len(seg),
                wr if i == n - 1 else 0, 1 if i == n - 1 else 0,
            )
        if n == 0:
            self._complete_wr(wr, None, None)

    def _post_read(self, ch, listener, dst_views: List[memoryview], blocks) -> None:
        if ch._dead.is_set():
            if listener:
                listener.on_failure(ChannelError(f"channel {ch.peer_desc} is down"))
            return
        # pair destinations with blocks 1:1 where lengths align (the
        # fetcher always does); otherwise stage contiguously and scatter
        aligned = len(dst_views) == len(blocks) and all(
            len(v) == b[2] for v, b in zip(dst_views, blocks)
        )
        if aligned and len(blocks) > 0:
            remaining = [len(blocks)]
            failed = [False]
            lock = threading.Lock()

            def sub_listener(i):
                def ok(_):
                    with lock:
                        remaining[0] -= 1
                        done = remaining[0] == 0 and not failed[0]
                    if done and listener:
                        listener.on_success(None)

                def err(e):
                    with lock:
                        first = not failed[0]
                        failed[0] = True
                    if first and listener:
                        listener.on_failure(e)

                from sparkrdma_tpu_torch.transport.completion import FnListener

                return FnListener(ok, err)

            for i, (view, block) in enumerate(zip(dst_views, blocks)):
                arr = (ctypes.c_uint64 * 3)(block[0], block[1], block[2])
                wr = self._alloc_wr(sub_listener(i), keepalive=view)
                self._lib.srt_post_read(
                    self._np, ch.channel_id, wr, _addr_of(view), arr, 1
                )
            return
        # general case: one staging buffer, scatter on completion
        total = sum(b[2] for b in blocks)
        staging = np.empty((total,), dtype=np.uint8)

        def scatter(_):
            off = 0
            for view in dst_views:
                n = len(view)
                view[:] = staging[off : off + n].tobytes()
                off += n
            if listener:
                listener.on_success(None)

        from sparkrdma_tpu_torch.transport.completion import FnListener

        wr = self._alloc_wr(
            FnListener(scatter, listener.on_failure if listener else None),
            keepalive=staging,
        )
        flat = (ctypes.c_uint64 * (3 * len(blocks)))()
        for i, b in enumerate(blocks):
            flat[3 * i], flat[3 * i + 1], flat[3 * i + 2] = b
        self._lib.srt_post_read(
            self._np, ch.channel_id, wr, staging.ctypes.data, flat, len(blocks)
        )

    def _post_read_mapped(self, ch, listener, blocks) -> None:
        if ch._dead.is_set():
            if listener:
                listener.on_failure(ChannelError(f"channel {ch.peer_desc} is down"))
            return
        wr = self._alloc_wr(listener)
        with self._lock:
            # remember the block lengths so the completion can slice a
            # streamed-fallback blob back into per-block views
            self._mapped_wrs[wr] = [b[2] for b in blocks]
        flat = (ctypes.c_uint64 * (3 * len(blocks)))()
        for i, b in enumerate(blocks):
            flat[3 * i], flat[3 * i + 1], flat[3 * i + 2] = b
        self._lib.srt_post_read_mapped(
            self._np, ch.channel_id, wr, flat, len(blocks)
        )

    def _mapped_delivery(self, c, lens) -> MappedDelivery:
        """Build the delivery object for a mapped READ completion."""
        lib = self._lib
        if c.aux == 1:
            # n x 32B host-endian records [user_ptr, len, base, map_len]
            n = c.payload_len // 32 if c.payload else 0
            rec = (
                np.ctypeslib.as_array(
                    ctypes.cast(c.payload, ctypes.POINTER(ctypes.c_uint64)),
                    shape=(n * 4,),
                ).reshape(n, 4).copy()
                if n
                else np.zeros((0, 4), np.uint64)
            )
            views = [
                memoryview(
                    (ctypes.c_ubyte * int(r[1])).from_address(int(r[0]))
                ).cast("B").toreadonly()  # writes would SIGSEGV PROT_READ pages
                for r in rec
            ]

            def free():
                for r in rec:
                    lib.srt_unmap(
                        ctypes.c_void_p(int(r[2])), ctypes.c_uint64(int(r[3]))
                    )

            return MappedDelivery(views, True, free)
        # aux == 0: contiguous copied blob; we take ownership (the poll
        # loop's blanket free is skipped by nulling c.payload)
        addr, total = c.payload, c.payload_len
        c.payload = None
        blob = (
            memoryview((ctypes.c_ubyte * total).from_address(addr))
            .cast("B")
            .toreadonly()  # match the mmap path: views are read-only
            if addr
            else memoryview(b"")
        )
        views = []
        off = 0
        for ln in lens:
            views.append(blob[off : off + ln])
            off += ln

        def free_blob(addr=addr):
            if addr:
                lib.srt_free_payload(ctypes.c_void_p(addr))

        return MappedDelivery(views, False, free_blob)

    def _complete_wr(self, wr_id: int, payload, error: Optional[Exception]) -> None:
        with self._lock:
            entry = self._wrs.pop(wr_id, None)
        if entry is None:
            return
        listener, _keep = entry
        if listener is None:
            return
        try:
            if error is None:
                listener.on_success(payload)
            else:
                listener.on_failure(error)
        except Exception:
            logger.exception("completion listener raised")

    # ------------------------------------------------------------------
    # consume lanes (sharded READ_DONE checksum+decode)
    # ------------------------------------------------------------------
    def _consume(self, wr_id: int, payload, error: Optional[Exception]) -> None:
        t0 = time.monotonic()
        try:
            self._complete_wr(wr_id, payload, error)
        finally:
            self._m_consume_busy.inc(int((time.monotonic() - t0) * 1000))

    def _consume_loop(self, lane: "queue.SimpleQueue") -> None:
        while True:
            item = lane.get()
            if item is None:
                return
            self._consume(*item)

    def _sync_sq_metrics(self) -> None:
        """Mirror the native SubmissionPlane atomics into the process
        registry as deltas (multiple nodes sum into one family)."""
        self._sq_next_sync = time.monotonic() + 1.0
        np_handle = self._np
        if not np_handle:
            return
        lib, reg = self._lib, get_registry()
        cur = {
            "submits": lib.srt_stat_sq_submits(np_handle),
            "batches": lib.srt_stat_sq_batches(np_handle),
            "completions": lib.srt_stat_sq_completions(np_handle),
            "backend_fallbacks": lib.srt_stat_sq_backend_fallbacks(np_handle),
        }
        d = cur["submits"] - self._sq_synced["submits"]
        if d > 0:
            reg.counter("transport.sq.submits").inc(d)
        d = cur["batches"] - self._sq_synced["batches"]
        if d > 0:
            reg.counter("transport.sq.batches").inc(d)
        d = cur["completions"] - self._sq_synced["completions"]
        if d > 0:
            reg.counter("transport.sq.completions").inc(d)
        d = cur["backend_fallbacks"] - self._sq_synced["backend_fallbacks"]
        if d > 0:
            reg.counter("transport.sq.backend_fallbacks").inc(d)
        self._sq_synced = cur
        depth = lib.srt_stat_sq_depth_hwm(np_handle)
        gauge = reg.gauge("transport.sq.sqe_depth")
        if depth > gauge.value:
            gauge.set(depth)

    # ------------------------------------------------------------------
    # CQ poll loop (RdmaThread analogue)
    # ------------------------------------------------------------------
    def _poll_loop(self) -> None:
        # the node-wide CQ thread takes the first configured vector
        # (RdmaThread pinning analogue)
        from sparkrdma_tpu_torch.utils.affinity import CpuVectorAllocator, pin_current_thread

        pin_current_thread(CpuVectorAllocator(self.conf.cpu_list).next_vector())
        comps = (tl.SrtComp * 64)()
        while not self._stopped.is_set():
            k = self._lib.srt_poll_cq(self._np, comps, 64, 100)
            for i in range(k):
                c = comps[i]
                try:
                    self._dispatch(c)
                except Exception:
                    logger.exception("error dispatching native completion")
                finally:
                    if c.payload:
                        self._lib.srt_free_payload(c.payload)
            if time.monotonic() >= self._sq_next_sync:
                self._sync_sq_metrics()

    def _dispatch(self, c: tl.SrtComp) -> None:
        if c.kind == tl.COMP_ACCEPT:
            peer_id = (
                ctypes.string_at(c.payload, c.payload_len).decode("utf-8")
                if c.payload
                else ""
            )
            # aux is the raw 32-bit hello word (wire.pack_hello layout)
            peer_port, chan_kind, chan_index = wire.split_hello_word(c.aux)
            purpose = "data" if chan_kind == wire.KIND_DATA else "rpc"
            get_registry().counter("transport.accepts", purpose=purpose).inc()
            ch = NativeTpuChannel(
                self, c.channel, f"{peer_id}:{peer_port}", purpose=purpose
            )
            with self._lock:
                self._channels[c.channel] = ch
                # keyed by (peer, kind, index): index-distinct striped
                # data connections from one peer coexist instead of
                # stale-replacing each other (wire.index_of)
                stale = self._passive.get((peer_id, chan_kind, chan_index))
                self._passive[(peer_id, chan_kind, chan_index)] = ch
                self._peer_of_channel[c.channel] = peer_id
            if stale is not None and stale.is_connected:
                logger.info("replacing stale passive channel for %s", peer_id)
                stale.stop()
            return
        if c.kind == tl.COMP_RECV:
            payload = (
                ctypes.string_at(c.payload, c.payload_len) if c.payload else b""
            )
            with self._lock:
                ch = self._channels.get(c.channel)
            if ch is not None and self._recv_listener is not None:
                self._recv_listener(ch, payload)
            return
        if c.kind == tl.COMP_SEND_DONE:
            err = (
                None
                if c.status == tl.ST_OK
                else ChannelError("send failed (channel down)")
            )
            self._complete_wr(c.wr_id, None, err)
            return
        if c.kind == tl.COMP_READ_DONE:
            with self._lock:
                lens = self._mapped_wrs.pop(c.wr_id, None)
            # materialize the payload/error NOW, on the poll thread:
            # the comps array is reused next batch and c.payload is
            # freed in the poll loop's finally — nothing native may
            # leak into a consume lane
            error: Optional[Exception] = None
            payload = None
            if c.status == tl.ST_OK:
                payload = (
                    self._mapped_delivery(c, lens) if lens is not None else None
                )
            elif c.status == tl.ST_REMOTE_ERR:
                msg = (
                    ctypes.string_at(c.payload, c.payload_len).decode("utf-8")
                    if c.payload
                    else "remote error"
                )
                error = ChannelError(f"remote READ failed: {msg}")
            else:
                error = ChannelError("READ failed (channel down)")
            if self._consume_lanes:
                # shard checksum+decode across the lanes; channel-keyed
                # routing keeps per-source FIFO order (error READ_DONEs
                # posted by a dying channel stay ordered with its data)
                lane = self._consume_lanes[c.channel % len(self._consume_lanes)]
                lane.put((c.wr_id, payload, error))
            else:
                self._consume(c.wr_id, payload, error)
            return
        if c.kind == tl.COMP_CHANNEL_DOWN:
            lost_peer: Optional[str] = None
            with self._lock:
                ch = self._channels.pop(c.channel, None)
                peer = self._peer_of_channel.pop(c.channel, None)
                if peer is not None:
                    was_tracked = False
                    for key, p in list(self._passive.items()):
                        if p is ch:
                            del self._passive[key]
                            was_tracked = True
                    # peer loss is per-peer, not per-channel-flavor: only
                    # signal once the peer has no surviving passive
                    # channel of any kind (reference treats CM DISCONNECT
                    # as peer-scoped, RdmaNode.java:186-195). A stale
                    # channel already replaced out of _passive must not
                    # re-signal a loss the replacement already implied.
                    if was_tracked and not any(k[0] == peer for k in self._passive):
                        lost_peer = peer
                for key, a in list(self._active.items()):
                    if a is ch:
                        del self._active[key]
            if ch is not None:
                ch._dead.set()
            if (
                lost_peer is not None
                and not self._stopped.is_set()
                and self._peer_lost_listener is not None
            ):
                self._peer_lost_listener(lost_peer)
            return

    # ------------------------------------------------------------------
    # channel cache (TpuNode.get_channel parity)
    # ------------------------------------------------------------------
    def get_channel(
        self,
        host: str,
        port: int,
        must_retry: bool = True,
        purpose: str = "rpc",
    ) -> NativeTpuChannel:
        """Cached active channel per (host, port, purpose) — same
        contract as TpuNode.get_channel (node.py): ``purpose``
        ("rpc" | "data") selects the channel flavor so bulk READ
        payloads never head-of-line block control messages
        (RdmaChannel.java:110-154)."""
        key = (host, port, purpose)
        # srt_connect's kind arg carries the composed (kind, index) pair;
        # the C side places it in hello-word bits 31-16 so the acceptor's
        # wire.split_hello_word sees kind in byte 3, index in byte 2
        kind = (wire.kind_of(purpose) << 8) | wire.index_of(purpose)
        with self._lock:
            ch = self._active.get(key)
            if ch is not None and ch.is_connected:
                return ch
            connect_lock = self._connect_locks.setdefault(key, threading.Lock())
        with connect_lock:
            with self._lock:
                ch = self._active.get(key)
                if ch is not None and ch.is_connected:
                    return ch
            attempts = self.conf.max_connection_attempts if must_retry else 1
            cid = 0
            for attempt in range(attempts):
                cid = self._lib.srt_connect(
                    self._np, host.encode(), port, self.port,
                    self.executor_id.encode(), self.conf.connect_timeout_ms,
                    kind,
                )
                if cid:
                    get_registry().counter(
                        "transport.connects", purpose=purpose
                    ).inc()
                    break
                get_registry().counter(
                    "transport.connect_retries", purpose=purpose
                ).inc()
                time.sleep(min(0.05 * (2 ** attempt), 1.0))
            if not cid:
                raise ChannelError(
                    f"could not connect to {host}:{port} after {attempts} attempts"
                )
            ch = NativeTpuChannel(self, cid, f"{host}:{port}", purpose=purpose)
            with self._lock:
                self._channels[cid] = ch
                self._active[key] = ch
            return ch

    def drain_read_ring(self) -> List[Tuple[float, float, int]]:
        """Pop and return every buffered READ ``(t_submit, t_complete,
        nbytes)`` stamp (oldest first). Consumers turn these into
        ``transport.native_read`` spans; the ring is bounded, so stamps
        nobody drains age out instead of accumulating."""
        out: List[Tuple[float, float, int]] = []
        ring = self._read_ring
        while True:
            try:
                out.append(ring.popleft())
            except IndexError:
                return out

    def read_path_stats(self) -> Tuple[int, int]:
        """(file_fast_path_reads, streamed_reads) completed by this
        node's client side — observability for tests and the bench."""
        np_handle = self._np  # capture once: stop() nulls it concurrently
        if not np_handle:
            return (0, 0)
        return (
            self._lib.srt_stat_file_reads(np_handle),
            self._lib.srt_stat_streamed_reads(np_handle),
        )

    def split_parts(self) -> int:
        """Parts created by splitting multi-block pread tasks across
        the worker pool (0 = the split never engaged)."""
        np_handle = self._np
        if not np_handle:
            return 0
        return self._lib.srt_stat_split_parts(np_handle)

    def block_stripes(self) -> int:
        """Sub-ranges created by striping single large blocks' preads
        across the worker pool (0 = the stripe never engaged)."""
        np_handle = self._np
        if not np_handle:
            return 0
        return self._lib.srt_stat_block_stripes(np_handle)

    def sq_stats(self) -> Dict[str, object]:
        """Submission-plane accounting (transport.cpp SubmissionPlane):
        SQ counters, the resolved read backend (`auto` probed), and
        whether io_uring support was compiled in."""
        np_handle = self._np
        if not np_handle:
            return {}
        lib = self._lib
        return {
            "submits": lib.srt_stat_sq_submits(np_handle),
            "batches": lib.srt_stat_sq_batches(np_handle),
            "sqe_depth": lib.srt_stat_sq_depth_hwm(np_handle),
            "completions": lib.srt_stat_sq_completions(np_handle),
            "backend_fallbacks": lib.srt_stat_sq_backend_fallbacks(np_handle),
            "backend": {1: "iouring", 2: "pread", 3: "mapped"}.get(
                lib.srt_read_backend_effective(np_handle), "pread"
            ),
            "uring_compiled": bool(lib.srt_uring_compiled()),
            "consume_workers": self._consume_workers,
        }

    def force_uring_probe_fail(self, on: bool) -> None:
        """Test seam (and the ``read:enosys`` fault kind): make the
        io_uring availability probe behave like an ENOSYS kernel, so
        degradation to pread is exercised deterministically."""
        np_handle = self._np
        if np_handle:
            self._lib.srt_sq_force_probe_fail(np_handle, 1 if on else 0)

    def set_read_backend(self, backend: str) -> None:
        """Switch the submission-plane backend at runtime (normally
        fixed by ``tpu.shuffle.native.readBackend`` at init) — the
        per-backend A/Bs and byte-identity tests flip it between sides
        on one node."""
        np_handle = self._np
        if np_handle:
            self._lib.srt_set_read_backend(
                np_handle, tl.READ_BACKENDS[backend]
            )

    def _close_channel(self, ch: NativeTpuChannel) -> None:
        ch._dead.set()
        if not self._stopped.is_set():
            self._lib.srt_close_channel(self._np, ch.channel_id)

    # ------------------------------------------------------------------
    def stop(self) -> None:
        if self._stopped.is_set():
            return
        self._stopped.set()
        # srt_node_stop frees the Node, so the poll thread must be OUT
        # of srt_poll_cq first — the loop re-checks _stopped every
        # 100 ms poll timeout, so this join is bounded unless a
        # completion listener wedged
        self._cq_thread.join(timeout=10.0)
        if self._cq_thread.is_alive():
            # a wedged listener: leak the native node rather than free
            # it under the still-running poller (use-after-free)
            logger.error("cq poll thread failed to stop; leaking native node")
            self._np = None
        # drain the consume lanes: the poll thread is out, so every
        # READ_DONE it routed is already queued; sentinels let each lane
        # finish its FIFO before the node tears down underneath it
        for lane in self._consume_lanes:
            lane.put(None)
        for t in self._consume_threads:
            t.join(timeout=10.0)
        if self._consume_threads:
            get_registry().gauge("transport.consume.workers").add(
                -self._consume_workers
            )
        self._sync_sq_metrics()
        with self._lock:
            channels = list(self._channels.values())
            self._channels.clear()
        for ch in channels:
            ch._dead.set()
        # teardown order matters twice over: pooled buffers deregister
        # their regions through the native node (so it must be alive for
        # buffer_manager.stop), and the epoll loop may still be streaming
        # READ payloads into destination buffers referenced only by _wrs
        # keepalives — so the loop must be FULLY joined (srt_node_stop)
        # before those references are dropped
        self.buffer_manager.stop()
        self.pd.dealloc()
        np_handle, self._np = self._np, None
        if np_handle:
            self._lib.srt_node_stop(np_handle)
        # loop is dead now: fail anything still outstanding (latch
        # semantics) and release the keepalives
        with self._lock:
            wrs = list(self._wrs.items())
            self._wrs.clear()
        err = ChannelError("node stopped")
        for _, (listener, _keep) in wrs:
            if listener is not None:
                try:
                    listener.on_failure(err)
                except Exception:
                    logger.exception("listener on_failure raised")
