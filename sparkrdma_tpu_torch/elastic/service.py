"""Detachable shuffle-service daemon — ``python -m
sparkrdma_tpu_torch.elastic.service``.

The third pillar of the elastic layer (docs/DESIGN.md §21): a process
that outlives executors and takes ownership of their committed map
outputs, so an executor can restart (rolling upgrade, preemption)
without losing shuffle state. The handoff is metadata only — file
paths plus per-partition lengths (``WrapperShuffleData
.handoff_manifest``). The daemon hard-links each data file into its
own directory (same inode — zero byte copy; a cross-device fallback
copies), mmaps + registers the bytes in its OWN protection domain, and
publishes the locations as *replicas* of the source executor
(``replica_of`` set, ``num_map_outputs`` 0).

That replica tagging is what makes the daemon safe AND first-class:
while the executor lives, its own locations serve every fetch and the
daemon's stay parked in the driver's replica registry; the moment the
executor is lost, ``TpuShuffleManager._on_peer_lost`` promotes the
daemon's locations into the primary registry and reducers pull from
the daemon over the exact same transport, circuit breakers and all —
no duplication window, no special read path.

Control protocol (length-prefixed cloudpickle, one request per
connection, the engine task-protocol idiom): ``{"kind": "ping" |
"adopt" | "stop"}``; the daemon announces ``SERVICE_PORT <n>`` on
stdout. Executors trigger the handoff via their own ``{"kind":
"handoff", "service": (host, port)}`` task request (engine/worker.py).

A copy of the JAX package's ``elastic/service.py``, its imports
rewritten to this package. Run as ``python -m
sparkrdma_tpu_torch.elastic.service``: the daemon needs this package on
its ``sys.path`` (the working directory, or ``PYTHONPATH``), as the
engine's workers do. It does no tensor work and never initialises CUDA.
Its manager resolves ``transport=auto`` as an executor's does: the
native plane where g++ is on PATH, and a failed build raises. A hard
link that crosses filesystems falls back to a copy; the adopted file's
link count (``st_nlink`` 2 while the executor's entry exists) tells the
two apart.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import shutil
import socket
import struct
import tempfile
import threading
import traceback
from typing import Dict, List, Tuple

import cloudpickle

from sparkrdma_tpu_torch.locations import BlockLocation, PartitionLocation
from sparkrdma_tpu_torch.memory.mapped_file import MappedFile
from sparkrdma_tpu_torch.obs import get_registry
from sparkrdma_tpu_torch.utils.config import TpuShuffleConf

logger = logging.getLogger(__name__)

_LEN = struct.Struct(">I")


def _recv_obj(sock: socket.socket):
    hdr = b""
    while len(hdr) < 4:
        chunk = sock.recv(4 - len(hdr))
        if not chunk:
            raise ConnectionError("peer closed")
        hdr += chunk
    (n,) = _LEN.unpack(hdr)
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(min(1 << 20, n - len(buf)))
        if not chunk:
            raise ConnectionError("peer closed")
        buf += chunk
    return cloudpickle.loads(bytes(buf))


def _send_obj(sock: socket.socket, obj) -> None:
    data = cloudpickle.dumps(obj)
    sock.sendall(_LEN.pack(len(data)) + data)


def send_adopt(
    addr: Tuple[str, int], source: str, manifests: Dict[int, List[dict]]
) -> int:
    """Client half of the handoff: ship ``{shuffle_id: [{map_id, path,
    partition_lengths}]}`` to a running daemon. Returns the number of
    map outputs adopted."""
    with socket.create_connection(addr, timeout=30.0) as s:
        s.settimeout(30.0)
        _send_obj(s, {"kind": "adopt", "source": source, "manifests": manifests})
        resp = _recv_obj(s)
    if not resp.get("ok"):
        raise RuntimeError(f"handoff to shuffle service failed: {resp.get('error')}")
    return resp.get("result", 0)


class ShuffleService:
    """One daemon: a full shuffle manager endpoint + the adopt logic.

    Usable in-process (tests construct it directly and call
    :meth:`adopt`) or as the detached ``__main__`` process."""

    def __init__(self, conf: TpuShuffleConf, service_id: str = "shuffle-svc-0"):
        # deliberately a plain executor-role manager: the daemon IS a
        # first-class location source — hello/announce membership, the
        # same transport node serving one-sided reads, the same breaker
        # keys on the fetcher side
        from sparkrdma_tpu_torch.shuffle.manager import TpuShuffleManager

        self.manager = TpuShuffleManager(conf, is_driver=False, executor_id=service_id)
        self.manager.start_node_if_missing()
        self._dir = tempfile.mkdtemp(prefix=f"tpu-shuffle-svc-{service_id}-")
        # (shuffle_id, source, map_id) -> MappedFile, so a repeated
        # handoff of the same map (executor retried it) is idempotent
        self._adopted: Dict[Tuple[int, str, int], MappedFile] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._m_maps = get_registry().counter(
            "elastic.handoff_maps", role=service_id
        )

    @property
    def executor_id(self) -> str:
        return self.manager.executor_id

    def adopt(self, source: str, manifests: Dict[int, List[dict]]) -> int:
        """Take ownership of ``source``'s map outputs. Returns how many
        map outputs were adopted this call."""
        adopted = 0
        for shuffle_id, maps in sorted(manifests.items()):
            for entry in maps:
                if self._adopt_one(int(shuffle_id), source, entry):
                    adopted += 1
        if adopted:
            self._m_maps.inc(adopted)
        return adopted

    def _adopt_one(self, shuffle_id: int, source: str, entry: dict) -> bool:
        map_id = int(entry["map_id"])
        key = (shuffle_id, source, map_id)
        with self._lock:
            if key in self._adopted:
                return False
        src_path = entry["path"]
        lengths = [int(n) for n in entry["partition_lengths"]]
        own_path = os.path.join(
            self._dir, f"shuffle_{shuffle_id}_{source}_{map_id}.data"
        )
        try:
            # hard link = shared inode, zero copy; the executor's later
            # dispose() unlinks only its own directory entry
            try:
                os.link(src_path, own_path)
            except OSError:
                shutil.copy(src_path, own_path)  # cross-device fallback
            mf = MappedFile(
                own_path,
                self.manager.node.pd,
                self.manager.conf.shuffle_write_block_size,
                lengths,
            )
        except Exception:
            logger.exception(
                "adopting %s map %d of shuffle %d failed", source, map_id, shuffle_id
            )
            return False
        with self._lock:
            if self._stop.is_set():
                mf.dispose()
                return False
            self._adopted[key] = mf
        locs = [
            PartitionLocation(
                self.manager.local_manager_id,
                pid,
                BlockLocation(
                    block.address,
                    block.length,
                    block.mkey,
                    replica_of=source,
                    source_map=map_id,
                ),
            )
            for pid in range(mf.partition_count())
            for block in (mf.get_partition_location(pid),)
            if block.length > 0
        ]
        if locs:
            self.manager.publish_partition_locations(
                shuffle_id, -1, locs, num_map_outputs=0
            )
        return True

    def handle(self, req: dict) -> dict:
        kind = req.get("kind")
        if kind == "ping":
            return {"ok": True, "result": "pong"}
        if kind == "adopt":
            n = self.adopt(req["source"], req.get("manifests") or {})
            return {"ok": True, "result": n}
        if kind == "stop":
            self._stop.set()
            return {"ok": True}
        return {"ok": False, "error": f"unknown service request {kind!r}"}

    def serve(self) -> None:
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind(("127.0.0.1", 0))
        srv.listen(16)
        srv.settimeout(0.2)
        print(f"SERVICE_PORT {srv.getsockname()[1]}", flush=True)

        def one(conn):
            try:
                req = _recv_obj(conn)
                try:
                    resp = self.handle(req)
                except Exception as e:
                    resp = {
                        "ok": False,
                        "error": f"{type(e).__name__}: {e}",
                        "traceback": traceback.format_exc(),
                    }
                _send_obj(conn, resp)
            except Exception:
                pass
            finally:
                conn.close()

        while not self._stop.is_set():
            try:
                conn, _ = srv.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            threading.Thread(target=one, args=(conn,), daemon=True).start()
        srv.close()
        self.close()

    def close(self) -> None:
        self._stop.set()
        with self._lock:
            adopted = list(self._adopted.values())
            self._adopted.clear()
        for mf in adopted:
            mf.dispose()
        shutil.rmtree(self._dir, ignore_errors=True)
        self.manager.stop()


def main() -> None:
    ap = argparse.ArgumentParser(
        description="Detachable shuffle-service daemon (docs/DESIGN.md §21)"
    )
    ap.add_argument("--service-id", default="shuffle-svc-0")
    ap.add_argument("--conf", required=True, help="JSON dict of tpu.shuffle.* keys")
    args = ap.parse_args()
    conf = TpuShuffleConf(json.loads(args.conf))
    ShuffleService(conf, args.service_id).serve()


if __name__ == "__main__":
    main()
