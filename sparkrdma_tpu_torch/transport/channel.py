"""TpuChannel — one reliable peer connection with verbs-like semantics.

TPU-native analogue of RdmaChannel.java (reference: RdmaChannel.java). Preserved
semantics:

- two work-request types only: two-sided SEND for RPC segments
  (:395-424) and one-sided READ for data (:360-393); a READ names
  remote ``(mkey, address, length)`` triples and completes once for the
  whole WR list (reference signals only the last WR),
- **send budget**: ``send_queue_depth`` permits; WRs that cannot
  acquire permits go to an overflow queue drained as completions
  reclaim permits, with a one-time oversubscription warning
  (:54-56, 330-358, 589-625),
- a dedicated completion-processing thread per channel (the
  RdmaThread/CQ analogue, RdmaThread.java:44-57) that also serves the
  *passive* side of one-sided READs directly from the endpoint's
  ProtectionDomain — application code never runs per served byte,
- error latching: the first transport error fails every outstanding
  listener exactly once and poisons the channel (:525-529, 576-579,
  659-666); ``on_failure`` may be called multiple times per listener
  and must tolerate it.

A copy of the JAX package's ``transport/channel.py``, its imports
rewritten to this package (the lock-order, model-checker and journal
calls go to the inert seams of ``utils/seams.py``). The fault-plan seam
(``testing/faults.py``, ROADMAP M4) is inert here (``utils/seams.py``).
"""

from __future__ import annotations

import logging
import socket
import struct
import threading
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Sequence, Tuple

from sparkrdma_tpu_torch.memory.registry import ProtectionDomain, RegionError
from sparkrdma_tpu_torch.obs import get_registry
from sparkrdma_tpu_torch.utils.seams import faults as _faults
from sparkrdma_tpu_torch.transport import wire
from sparkrdma_tpu_torch.transport.completion import CompletionListener
from sparkrdma_tpu_torch.utils.config import TpuShuffleConf

logger = logging.getLogger(__name__)


class ChannelError(IOError):
    pass


@dataclass
class _PendingRead:
    """Reference CompletionInfo (RdmaChannel.java:97-108)."""

    listener: CompletionListener
    dst_views: List[memoryview]
    permits: int


@dataclass
class _QueuedWr:
    """Overflow send WR (reference PostRecvWr / sendWrQueue)."""

    kind: str  # "send" | "read"
    permits: int
    payloads: List[bytes] = field(default_factory=list)
    listener: Optional[CompletionListener] = None
    req_id: int = 0
    dst_views: List[memoryview] = field(default_factory=list)
    blocks: List[Tuple[int, int, int]] = field(default_factory=list)


class TpuChannel:
    """One connected peer endpoint over a full-duplex stream."""

    def __init__(
        self,
        conf: TpuShuffleConf,
        pd: ProtectionDomain,
        sock: socket.socket,
        peer_desc: str,
        on_recv=None,
        on_disconnect=None,
        cpu_vector: Optional[int] = None,
        purpose: str = "rpc",
    ):
        self.conf = conf
        self.pd = pd
        self.peer_desc = peer_desc
        self.purpose = purpose
        self._sock = sock
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._on_recv = on_recv
        self._on_disconnect = on_disconnect

        self._write_lock = threading.Lock()
        self._state_lock = threading.Lock()
        self._pending_reads: Dict[int, _PendingRead] = {}
        self._next_req_id = 1
        self._send_budget = conf.send_queue_depth
        self._overflow: Deque[_QueuedWr] = deque()
        self._warned_oversubscription = False
        self._error: Optional[Exception] = None
        self._stopped = False
        self._cpu_vector = cpu_vector

        # counters pre-resolved once per channel so the hot verb paths
        # never pay a registry lookup (labels: connection purpose)
        reg = get_registry()
        self._m_sends = reg.counter("transport.sends", purpose=purpose)
        self._m_send_bytes = reg.counter("transport.send_bytes", purpose=purpose)
        self._m_recvs = reg.counter("transport.recvs", purpose=purpose)
        self._m_recv_bytes = reg.counter("transport.recv_bytes", purpose=purpose)
        self._m_reads = reg.counter("transport.reads", purpose=purpose)
        self._m_read_bytes = reg.counter("transport.read_bytes", purpose=purpose)
        self._m_reads_served = reg.counter("transport.reads_served", purpose=purpose)
        self._m_read_bytes_served = reg.counter(
            "transport.read_bytes_served", purpose=purpose
        )
        self._m_completions = reg.counter("transport.completions", purpose=purpose)
        self._m_read_errors = reg.counter("transport.read_errors", purpose=purpose)
        self._m_overflow = reg.counter("transport.send_overflow", purpose=purpose)
        self._m_errors = reg.counter("transport.errors_latched", purpose=purpose)

        self._recv_thread = threading.Thread(
            target=self._process_completions, name=f"cq-{peer_desc}", daemon=True
        )
        self._recv_thread.start()

    # ------------------------------------------------------------------
    # public verb API (reference rdmaSendInQueue / rdmaReadInQueue)
    # ------------------------------------------------------------------
    def send_in_queue(self, listener: CompletionListener, segments: Sequence[bytes]) -> None:
        """Post RPC segments as SEND WRs; one completion for the batch."""
        plan = _faults.active()
        if plan is not None:
            listener, handled = plan.on_send(self, listener, segments)
            if handled:
                return
        payloads = [wire.pack_send(seg) for seg in segments]
        self._m_sends.inc(len(payloads))
        self._m_send_bytes.inc(sum(len(p) for p in payloads))
        wr = _QueuedWr(kind="send", permits=len(payloads), payloads=payloads, listener=listener)
        self._post(wr)

    def read_in_queue(
        self,
        listener: CompletionListener,
        dst_views: List[memoryview],
        blocks: List[Tuple[int, int, int]],
    ) -> None:
        """Post a one-sided READ of remote (mkey, addr, len) blocks.

        ``dst_views`` receive the bytes in order; total destination size
        must equal total block length. Completes once for the whole list
        (reference: only the last WR is signaled, :383-390).
        """
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
        wr = _QueuedWr(
            kind="read",
            permits=max(1, len(blocks)),
            listener=listener,
            dst_views=dst_views,
            blocks=blocks,
        )
        self._post(wr)

    # ------------------------------------------------------------------
    # send budget + posting (reference :330-358, 589-625)
    # ------------------------------------------------------------------
    def _post(self, wr: _QueuedWr) -> None:
        with self._state_lock:
            if self._error is not None or self._stopped:
                err = self._error or ChannelError("channel stopped")
                if wr.listener:
                    wr.listener.on_failure(err)
                return
            if self._send_budget >= wr.permits:
                self._send_budget -= wr.permits
            else:
                self._m_overflow.inc()
                if not self._warned_oversubscription:
                    self._warned_oversubscription = True
                    logger.warning(
                        "channel %s send queue oversubscribed; consider raising "
                        "tpu.shuffle.sendQueueDepth (current %d)",
                        self.peer_desc,
                        self.conf.send_queue_depth,
                    )
                self._overflow.append(wr)
                return
        self._execute(wr)

    def _reclaim(self, permits: int) -> None:
        """Return permits; drain overflow WRs that now fit (reference :589-625)."""
        runnable: List[_QueuedWr] = []
        with self._state_lock:
            self._send_budget += permits
            while self._overflow and self._send_budget >= self._overflow[0].permits:
                wr = self._overflow.popleft()
                self._send_budget -= wr.permits
                runnable.append(wr)
        for wr in runnable:
            self._execute(wr)

    def _execute(self, wr: _QueuedWr) -> None:
        req_id = 0
        try:
            if wr.kind == "send":
                with self._write_lock:
                    for p in wr.payloads:
                        self._sock.sendall(p)
                # stream accepted the bytes == send WC
                self._reclaim(wr.permits)
                if wr.listener:
                    wr.listener.on_success(None)
                return
            with self._state_lock:
                req_id = self._next_req_id
                self._next_req_id += 1
                self._pending_reads[req_id] = _PendingRead(
                    wr.listener, wr.dst_views, wr.permits
                )
            with self._write_lock:
                self._sock.sendall(wire.pack_read_req(req_id, wr.blocks))
            # if the error latched between _post's check and the pending
            # registration above, the latch may have missed this WR —
            # flush it ourselves so its listener is never orphaned
            with self._state_lock:
                latched = self._error
                stale = self._pending_reads.pop(req_id, None) if latched else None
            if stale is not None and stale.listener:
                stale.listener.on_failure(latched)
        except OSError as e:
            err = ChannelError(f"send to {self.peer_desc} failed: {e}")
            self._latch_error(err)
            # the latch may have run before our pending registration (or
            # this was a send WR it never saw) — fail this WR directly
            with self._state_lock:
                stale = self._pending_reads.pop(req_id, None)
            listener = stale.listener if stale is not None else wr.listener
            if listener:
                listener.on_failure(err)

    # ------------------------------------------------------------------
    # completion processing (reference exhaustCq/processCompletions)
    # ------------------------------------------------------------------
    def _process_completions(self) -> None:
        # per-channel CQ thread pins to its CPU vector (RdmaThread.java:44-46)
        from sparkrdma_tpu_torch.utils.affinity import pin_current_thread

        pin_current_thread(self._cpu_vector)
        try:
            while True:
                op_raw = self._sock.recv(1)
                if not op_raw:
                    raise ConnectionError("peer closed connection")
                op = op_raw[0]
                if op == wire.OP_SEND:
                    n = struct.unpack(">I", wire.read_exact(self._sock, 4))[0]
                    payload = wire.read_exact(self._sock, n)
                    self._m_recvs.inc()
                    self._m_recv_bytes.inc(n)
                    if self._on_recv is not None:
                        self._on_recv(self, payload)
                elif op == wire.OP_READ_REQ or op == wire.OP_READ_REQ2:
                    # REQ2 (a native file-capable peer) gets the same
                    # streamed READ_RESP: this plane has no file path
                    self._serve_read()
                elif op == wire.OP_READ_RESP:
                    self._complete_read()
                elif op == wire.OP_READ_ERR:
                    self._complete_read_err()
                elif op == wire.OP_GOODBYE:
                    raise ConnectionError("peer disconnected")
                else:
                    raise ChannelError(f"unknown opcode {op} from {self.peer_desc}")
        except (OSError, ChannelError) as e:
            graceful = self._stopped or (
                isinstance(e, ConnectionError) and "disconnected" in str(e)
            )
            self._latch_error(
                ChannelError(f"channel {self.peer_desc}: {e}"), quiet=graceful
            )
            if self._on_disconnect is not None:
                self._on_disconnect(self)

    def _serve_read(self) -> None:
        """Passive one-sided READ service: PD-resolve and stream back.

        Runs on the completion thread — the application layer is never
        involved, preserving SURVEY.md §5.1 invariant #3.
        """
        req_id, blocks = wire.unpack_read_req(self._sock)
        try:
            views = [self.pd.resolve(mkey, addr, length) for mkey, addr, length in blocks]
        except RegionError as e:
            with self._write_lock:
                self._sock.sendall(wire.pack_read_err(req_id, str(e)))
            return
        total = sum(len(v) for v in views)
        self._m_reads_served.inc(len(views))
        self._m_read_bytes_served.inc(total)
        with self._write_lock:
            self._sock.sendall(wire.pack_read_resp_header(req_id, total))
            for v in views:
                self._sock.sendall(v)

    def _complete_read(self) -> None:
        req_id = struct.unpack(">Q", wire.read_exact(self._sock, 8))[0]
        total = struct.unpack(">Q", wire.read_exact(self._sock, 8))[0]
        with self._state_lock:
            pending = self._pending_reads.pop(req_id, None)
        if pending is None:
            # unknown completion: drain the payload to keep framing intact
            wire.read_exact(self._sock, total)
            return
        try:
            for view in pending.dst_views:
                wire.read_into(self._sock, view)
        except Exception as e:
            # the entry was already popped from _pending_reads, so the
            # error latch can no longer see it — fail its listener here
            # before propagating, or the reduce task waits forever
            if pending.listener:
                try:
                    pending.listener.on_failure(
                        ChannelError(f"READ payload from {self.peer_desc} truncated: {e}")
                    )
                except Exception:
                    logger.exception("listener on_failure raised")
            raise
        self._m_completions.inc()
        self._reclaim(pending.permits)
        if pending.listener:
            pending.listener.on_success(total)

    def _complete_read_err(self) -> None:
        req_id = struct.unpack(">Q", wire.read_exact(self._sock, 8))[0]
        n = struct.unpack(">I", wire.read_exact(self._sock, 4))[0]
        msg = wire.read_exact(self._sock, n).decode("utf-8")
        with self._state_lock:
            pending = self._pending_reads.pop(req_id, None)
        if pending is not None:
            self._m_read_errors.inc()
            self._reclaim(pending.permits)
            if pending.listener:
                pending.listener.on_failure(ChannelError(f"remote READ failed: {msg}"))

    # ------------------------------------------------------------------
    # error latching + teardown (reference :525-529, 653-733)
    # ------------------------------------------------------------------
    def _latch_error(self, err: ChannelError, quiet: bool = False) -> None:
        with self._state_lock:
            if self._error is not None:
                return
            self._error = err
            self._m_errors.inc()
            pending = list(self._pending_reads.values())
            self._pending_reads.clear()
            overflow = list(self._overflow)
            self._overflow.clear()
        if not quiet:
            logger.warning("latching channel error: %s", err)
        for p in pending:
            if p.listener:
                try:
                    p.listener.on_failure(err)
                except Exception:
                    logger.exception("listener on_failure raised")
        for wr in overflow:
            if wr.listener:
                try:
                    wr.listener.on_failure(err)
                except Exception:
                    logger.exception("listener on_failure raised")
        try:
            self._sock.close()
        except OSError:
            pass

    @property
    def is_connected(self) -> bool:
        with self._state_lock:
            return self._error is None and not self._stopped

    def stop(self) -> None:
        with self._state_lock:
            if self._stopped:
                return
            self._stopped = True
        try:
            with self._write_lock:
                self._sock.sendall(bytes([wire.OP_GOODBYE]))
        except OSError:
            pass
        self._latch_error(ChannelError("channel stopped"), quiet=True)
        if threading.current_thread() is not self._recv_thread:
            self._recv_thread.join(timeout=self.conf.teardown_timeout_ms / 1000.0)
