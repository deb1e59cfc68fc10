"""TpuNode — the per-process transport endpoint.

TPU-native analogue of RdmaNode.java (reference: RdmaNode.java). Preserved
semantics:

- binds a listener with port retries and a connection backlog
  (:75-97),
- owns the ProtectionDomain and the registered buffer pool (:99-104),
- a listener thread accepts incoming connections (the CM event loop
  analogue, :115-219) including **stale-channel replacement**: a new
  incoming connection from a peer we already track replaces the old
  passive channel (:134-148, 186-195),
- ``get_channel(host, port)`` caches active channels per remote
  address with connect retries and timeout; concurrent connect races
  resolve by keeping the first cached channel (:281-353),
- ``stop()`` tears down all channels then the listener (:369-396).

The reference pins one CQ thread per channel to a CPU vector from
``cpuList`` (:221-277); on this single-core host CPU pinning is a
deliberate no-op, but the per-channel completion-thread model is kept.

A copy of the JAX package's ``transport/node.py``, its imports rewritten
to this package (the lock-order and model-checker calls go to the port's ``analysis/lockorder.py``
and ``analysis/modelcheck``).
"""

from __future__ import annotations

import logging
import socket
import threading
import time
from typing import Callable, Dict, Optional, Tuple

from sparkrdma_tpu_torch.analysis.modelcheck import schedule_point
from sparkrdma_tpu_torch.memory.buffer_manager import TpuBufferManager
from sparkrdma_tpu_torch.memory.registry import ProtectionDomain
from sparkrdma_tpu_torch.obs import get_registry
from sparkrdma_tpu_torch.transport import wire
from sparkrdma_tpu_torch.transport.channel import ChannelError, TpuChannel
from sparkrdma_tpu_torch.utils.config import TpuShuffleConf

logger = logging.getLogger(__name__)

RecvCallback = Callable[[TpuChannel, bytes], None]


class TpuNode:
    def __init__(
        self,
        conf: TpuShuffleConf,
        host: str,
        is_executor: bool,
        executor_id: str,
        recv_listener: Optional[RecvCallback] = None,
        peer_lost_listener: Optional[Callable[[str], None]] = None,
    ):
        self.conf = conf
        self.host = host
        self.is_executor = is_executor
        self.executor_id = executor_id
        self._recv_listener = recv_listener
        self._peer_lost_listener = peer_lost_listener

        self.pd = ProtectionDomain()
        self.buffer_manager = TpuBufferManager(
            self.pd,
            is_executor=is_executor,
            max_agg_block=conf.max_agg_block,
            max_agg_prealloc=conf.max_agg_prealloc,
        )

        from sparkrdma_tpu_torch.utils.affinity import CpuVectorAllocator

        self._cpu_vectors = CpuVectorAllocator(conf.cpu_list)
        self._active: Dict[Tuple[str, int, str], TpuChannel] = {}
        # passive channels per (peer executor_id, kind, index): an RPC
        # and a DATA connection from the same peer coexist, and striped
        # data-N connections get distinct index slots
        self._passive: Dict[Tuple[str, int, int], TpuChannel] = {}
        self._lock = threading.Lock()
        self._connect_locks: Dict[Tuple[str, int, str], threading.Lock] = {}
        self._stopped = False

        base_port = conf.executor_port if is_executor else conf.driver_port
        self._listener = self._bind(base_port)
        self.port = self._listener.getsockname()[1]
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name=f"listener-{executor_id}", daemon=True
        )
        self._accept_thread.start()
        logger.info(
            "TpuNode %s listening on %s:%d (%s)",
            executor_id,
            host,
            self.port,
            "executor" if is_executor else "driver",
        )

    # ------------------------------------------------------------------
    def _bind(self, base_port: int) -> socket.socket:
        last_err: Optional[OSError] = None
        for attempt in range(self.conf.port_max_retries):
            port = 0 if base_port == 0 else base_port + attempt
            s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            try:
                s.bind((self.host, port))
                s.listen(128)  # reference backlog 128, RdmaNode.java:86
                return s
            except OSError as e:
                last_err = e
                s.close()
        raise ChannelError(f"could not bind a listener port: {last_err}")

    def _accept_loop(self) -> None:
        while True:
            try:
                sock, addr = self._listener.accept()
            except OSError:
                return  # listener closed
            try:
                op = wire.read_exact(sock, 1)[0]
                if op != wire.OP_HELLO:
                    sock.close()
                    continue
                peer_port, peer_id, kind, index = wire.unpack_hello(sock)
            except OSError:
                sock.close()
                continue
            purpose = "data" if kind == wire.KIND_DATA else "rpc"
            get_registry().counter("transport.accepts", purpose=purpose).inc()
            channel = TpuChannel(
                self.conf,
                self.pd,
                sock,
                peer_desc=f"{peer_id}@{addr[0]}:{peer_port}",
                on_recv=self._recv_listener,
                on_disconnect=self._on_passive_disconnect,
                cpu_vector=self._cpu_vectors.next_vector(),
                purpose=purpose,
            )
            with self._lock:
                if self._stopped:
                    # connection was sitting in the backlog while stop()
                    # snapshotted the passive list — don't leak a live
                    # channel past teardown
                    stale = channel
                    channel = None
                else:
                    # passive channels are per (peer, kind, index): an RPC
                    # and a DATA connection from the same peer coexist
                    # (reference channel roles, RdmaChannel.java:110-154),
                    # and index-distinct data connections stripe
                    # (rdma_channel_conn_count analogue)
                    stale = self._passive.get((peer_id, kind, index))
                    self._passive[(peer_id, kind, index)] = channel
            if stale is not None and stale.is_connected:
                # stale-channel replacement (reference :134-148)
                logger.info("replacing stale passive channel for %s", peer_id)
                stale.stop()

    def _on_passive_disconnect(self, channel: TpuChannel) -> None:
        lost: Optional[str] = None
        with self._lock:
            stopped = self._stopped
            for key, ch in list(self._passive.items()):
                if ch is channel:
                    peer_id = key[0]
                    del self._passive[key]
                    # peer loss is per-peer, not per-channel-flavor: a
                    # dying data channel while the rpc channel is healthy
                    # (or vice versa) must not prune the peer's locations
                    if not any(k[0] == peer_id for k in self._passive):
                        lost = peer_id
                    break
        if lost is not None and not stopped and self._peer_lost_listener is not None:
            # peer-loss detection hook: the reference learns this from CM
            # DISCONNECTED events (RdmaNode.java:186-195) and the driver
            # prunes the peer's locations (RdmaShuffleManager.scala:199-221)
            self._peer_lost_listener(lost)

    # ------------------------------------------------------------------
    def get_channel(
        self,
        host: str,
        port: int,
        must_retry: bool = True,
        purpose: str = "rpc",
    ) -> TpuChannel:
        """Get or create the active channel to (host, port, purpose).

        Reference getRdmaChannel(addr, mustRetry), RdmaNode.java:281-353:
        cached per remote address; connect with attempts × timeout;
        dead cached channels are replaced. ``purpose`` ("rpc" | "data")
        selects the channel flavor (RdmaChannel.java:110-154): control
        messages and bulk READ payloads ride separate connections so an
        8 MiB in-flight READ never head-of-line blocks a location fetch.
        """
        key = (host, port, purpose)
        with self._lock:
            ch = self._active.get(key)
            if ch is not None and ch.is_connected:
                return ch
            connect_lock = self._connect_locks.setdefault(key, threading.Lock())
        # serialize concurrent connects to one peer: a duplicate
        # connection would trigger the peer's stale-channel replacement
        # and kill the live channel from under its users (the reference
        # resolves this race with putIfAbsent, :303-305; serializing
        # avoids creating the duplicate at all)
        with connect_lock:
            with self._lock:
                ch = self._active.get(key)
                if ch is not None and ch.is_connected:
                    return ch
            attempts = self.conf.max_connection_attempts if must_retry else 1
            last_err: Optional[Exception] = None
            ch = None
            for attempt in range(attempts):
                try:
                    ch = self._connect(host, port, purpose)
                    get_registry().counter("transport.connects", purpose=purpose).inc()
                    break
                except OSError as e:
                    last_err = e
                    get_registry().counter(
                        "transport.connect_retries", purpose=purpose
                    ).inc()
                    schedule_point("timer", "transport.backoff")
                    time.sleep(min(0.05 * (2**attempt), 1.0))
            if ch is None:
                raise ChannelError(
                    f"could not connect to {host}:{port} after {attempts} attempts: {last_err}"
                )
            with self._lock:
                self._active[key] = ch
            return ch

    def _connect(self, host: str, port: int, purpose: str = "rpc") -> TpuChannel:
        start = time.monotonic()
        sock = socket.create_connection(
            (host, port), timeout=self.conf.connect_timeout_ms / 1000.0
        )
        sock.settimeout(None)
        sock.sendall(
            wire.pack_hello(
                self.port, self.executor_id,
                wire.kind_of(purpose), wire.index_of(purpose),
            )
        )
        ch = TpuChannel(
            self.conf,
            self.pd,
            sock,
            peer_desc=f"{host}:{port}",
            on_recv=self._recv_listener,
            cpu_vector=self._cpu_vectors.next_vector(),
            purpose=purpose,
        )
        logger.debug(
            "connected to %s:%d in %.1f ms", host, port, (time.monotonic() - start) * 1e3
        )
        return ch

    # ------------------------------------------------------------------
    def stop(self) -> None:
        """Teardown: active channels, then listener, then passive (:369-396)."""
        with self._lock:
            if self._stopped:
                return
            self._stopped = True
            active = list(self._active.values())
            passive = list(self._passive.values())
            self._active.clear()
            self._passive.clear()
        for ch in active:
            ch.stop()
        try:
            self._listener.close()
        except OSError:
            pass
        self._accept_thread.join(timeout=self.conf.teardown_timeout_ms / 1000.0)
        for ch in passive:
            ch.stop()
        self.buffer_manager.stop()
        self.pd.dealloc()
