"""Executor worker process — `python -m sparkrdma_tpu_torch.engine.worker`.

The reference's process topology is one endpoint per *JVM*: executors
are separate processes that register with the driver and serve/pull
shuffle blocks over the network (SURVEY.md §1 "Process topology").
This module is that executor process for the TPU framework: it owns a
full `TpuShuffleManager` (transport endpoint, registered memory,
writers/readers) plus a small task server through which the driver
dispatches map/reduce closures (the Spark-core role the reference
delegates to Spark; closures travel via cloudpickle).

Task protocol (length-prefixed cloudpickle, one request per
connection): {"kind": "map" | "map_batch" | "reduce" | "finalize" |
"ping" | "stop", ...} -> {"ok": bool, "result"/"error": ...}.

Map tasks — single or batched — run through the manager's bounded
``map_pool`` (conf ``map.parallelism``), so per-process map concurrency
is the config knob regardless of how many task connections the driver
opens. ``map_batch`` ships a whole stage's tasks for this worker in ONE
request (one socket round trip instead of one per map) and runs them
concurrently up to the pool bound.

A copy of the JAX package's ``engine/worker.py``, its imports rewritten
to this package (the model checker's schedule points go to the port's
``analysis/modelcheck``). Run as ``python -m
sparkrdma_tpu_torch.engine.worker``; ``engine/cluster.py`` spawns it, so
the child must find this package on its ``sys.path`` (the driver's
working directory, or ``PYTHONPATH``). The worker does no tensor work:
it never initialises CUDA. With telemetry on it arms the process event
journal (``obs/journal.py``) before its heartbeater starts, so its
events ride the beats the driver pulls. The shuffle-service ``handoff``
request sends the committed map outputs' manifests to the daemon
(``elastic/service.py`` ``send_adopt``), as in JAX.
"""

from __future__ import annotations

import argparse
import json
import socket
import struct
import threading
import time
import traceback

import cloudpickle

from sparkrdma_tpu_torch import tenancy
from sparkrdma_tpu_torch.analysis.modelcheck import schedule_point
from sparkrdma_tpu_torch.obs.metrics import get_registry
from sparkrdma_tpu_torch.obs.profiler import acquire_profiler, release_profiler
from sparkrdma_tpu_torch.obs.telemetry import Heartbeater
from sparkrdma_tpu_torch.shuffle.manager import TpuShuffleManager
from sparkrdma_tpu_torch.testing import faults as _faults
from sparkrdma_tpu_torch.utils.config import TpuShuffleConf

_LEN = struct.Struct(">I")


def _recv_obj(sock: socket.socket):
    schedule_point("proto", "task.recv")
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
    schedule_point("proto", "task.send")
    data = cloudpickle.dumps(obj)
    sock.sendall(_LEN.pack(len(data)) + data)


class Worker:
    def __init__(self, conf: TpuShuffleConf, executor_id: str):
        self.manager = TpuShuffleManager(conf, is_driver=False, executor_id=executor_id)
        self.manager.start_node_if_missing()  # hello to driver now
        self._stop = threading.Event()
        # in-flight reduce readers keyed (shuffle_id, start, end) so a
        # cancel_reduce request can fire the pipeline's abort latch
        self._reduces: dict = {}
        self._reduce_lock = threading.Lock()
        # continuous profiling: this process's wall-clock sampler; its
        # collapsed-stack tables ride the heartbeat payloads below
        self.profiler = acquire_profiler(conf, role=executor_id)
        # outbox-mode heartbeater: samples role-filtered registry deltas
        # on a timer; the driver pulls them with {"kind": "telemetry"}
        self.heartbeater = None
        if conf.telemetry_enabled:
            # arm the process event journal: this worker's control-plane
            # transitions (circuit trips, quota blocks) ride the
            # heartbeat payloads below into the driver's merged journal
            from sparkrdma_tpu_torch.obs import journal as _journal

            _journal.configure(conf, role=executor_id)
            self.heartbeater = Heartbeater(
                get_registry(),
                executor_id,
                interval_ms=conf.telemetry_interval_ms,
                match={"role": executor_id},
                profiler=self.profiler,
            ).start()

    def _run_map(self, handle, map_id, records_fn) -> None:
        t0 = time.perf_counter()
        plan = _faults.active()
        if plan is not None:
            plan.on_exec(self.manager.executor_id, stage="map_task")
            plan.on_stage("map_task", [], peer=self.manager.executor_id)
        try:
            with self.manager.tracer.span(
                "engine.task", kind="map", partition=map_id
            ):
                writer = self.manager.get_writer(handle, map_id)
                try:
                    writer.write(records_fn())
                    writer.stop(True)
                except Exception:
                    writer.stop(False)
                    raise
        finally:
            get_registry().histogram(
                "engine.task_ms", role=self.manager.executor_id, kind="map",
                tenant=tenancy.current_tenant(),
            ).observe((time.perf_counter() - t0) * 1000.0)

    def handle(self, req):
        kind = req["kind"]
        if kind == "ping":
            return {"ok": True, "result": "pong"}
        if kind == "map":
            # single map: still bounded by the pool so concurrent task
            # connections can't oversubscribe the process
            with tenancy.tenant_scope(req.get("tenant")):
                self.manager.map_pool.submit(
                    self._run_map, req["handle"], req["map_id"], req["records_fn"]
                ).result()
            return {"ok": True}
        if kind == "map_batch":
            # one request, N map tasks, bounded concurrency: every task
            # goes through the map pool; the first failure propagates
            # after ALL have settled (writers must reach stop() so a
            # failed task poisons/aborts cleanly before the reply)
            routes = req.get("push_routes")
            if routes and self.manager.push_client is not None:
                # {executor_id: (host, task_port)}: where this worker's
                # push client ships sealed blocks (shuffle/merge.py)
                self.manager.push_client.set_routes(routes)
            if routes and self.manager.replica_client is not None:
                # the replication plane rides the same routes (elastic/)
                self.manager.replica_client.set_routes(routes)
            # the submit captures the tenant scope, so the fair-share
            # pool queues this batch under the requesting tenant
            with tenancy.tenant_scope(req.get("tenant")):
                futures = [
                    self.manager.map_pool.submit(
                        self._run_map, req["handle"], mid, fn
                    )
                    for mid, fn in req["tasks"]
                ]
            errors = [f.exception() for f in futures]
            errors = [e for e in errors if e is not None]
            if errors:
                raise errors[0]
            return {"ok": True}
        if kind == "finalize":
            self.manager.finalize_maps(req["shuffle_id"])
            return {"ok": True}
        if kind == "republish":
            # control-plane HA re-adoption ladder (sparkrdma_tpu_torch/
            # metastore): the driver's hub was wiped; re-publish every
            # committed map output and parked replica this executor
            # holds, fenced by the new generation
            n = self.manager.republish_for_readoption(
                req.get("meta_epoch", 0)
            )
            return {"ok": True, "result": n}
        if kind == "push_blocks":
            # push/merge plane ingest (shuffle/merge.py): the reply is
            # sent only after any seal-and-publish this batch triggers,
            # so a synchronous pushing finalizer gets ordering for free
            ep = self.manager.merge_endpoint
            accepted = 0
            if ep is not None:
                blocks = req.get("blocks") or []
                if req.get("blocks_rd"):
                    # descriptor mode (transport/staging.py): the bytes
                    # are staged in the sender's ProtectionDomain —
                    # pull them over the data plane before merging; the
                    # reply below releases the sender's registrations
                    from sparkrdma_tpu_torch.transport.staging import pull_payloads

                    payloads = pull_payloads(
                        self.manager.node,
                        req["data_addr"],
                        [(mk, ln) for _, _, mk, ln in req["blocks_rd"]],
                    )
                    blocks = [
                        (pid, seq, data)
                        for (pid, seq, _, _), data in zip(
                            req["blocks_rd"], payloads
                        )
                    ]
                accepted = ep.push_blocks(
                    req["shuffle_id"],
                    req["source"],
                    blocks,
                    req.get("final"),
                    req.get("origin_span", 0),
                    req.get("origin_trace", 0),
                )
            return {"ok": True, "result": accepted}
        if kind == "reduce":
            handle = req["handle"]
            t0 = time.perf_counter()
            plan = _faults.active()
            if plan is not None:
                plan.on_exec(self.manager.executor_id, stage="reduce_task")
                plan.on_stage("reduce_task", [], peer=self.manager.executor_id)
            rkey = (handle.shuffle_id, req["start"], req["end"])
            with tenancy.tenant_scope(req.get("tenant")):
                reader = self.manager.get_reader(handle, req["start"], req["end"])
                with self._reduce_lock:
                    self._reduces[rkey] = reader
                try:
                    with self.manager.tracer.span(
                        "engine.task", kind="reduce", start=req["start"],
                        end=req["end"],
                    ):
                        it = reader.read()
                        fn = req.get("reduce_fn")
                        result = fn(it) if fn is not None else list(it)
                finally:
                    with self._reduce_lock:
                        if self._reduces.get(rkey) is reader:
                            del self._reduces[rkey]
                    # task-completion sweep: a reduce_fn that bails without
                    # consuming must not strand fetched streams until GC
                    reader.close()
                    get_registry().histogram(
                        "engine.task_ms", role=self.manager.executor_id,
                        kind="reduce", tenant=tenancy.current_tenant(),
                    ).observe((time.perf_counter() - t0) * 1000.0)
            return {"ok": True, "result": result}
        if kind == "cancel_reduce":
            # speculation loser drain (elastic/speculation.py): closing
            # the in-flight reader fires the reduce pipeline's abort
            # latch; the losing task thread unwinds instead of finishing
            rkey = (req["shuffle_id"], req["start"], req["end"])
            with self._reduce_lock:
                reader = self._reduces.pop(rkey, None)
            if reader is not None:
                try:
                    reader.close()
                except Exception:
                    pass
            return {"ok": True, "result": reader is not None}
        if kind == "replicate_blocks":
            # elastic replication ingest (elastic/replication.py): the
            # reply is sent only after the replica locations published,
            # so the source's map task never outruns its durability
            store = self.manager.replica_store
            accepted = 0
            if store is not None:
                blocks = req.get("blocks") or []
                if req.get("blocks_rd"):
                    # descriptor mode (transport/staging.py): replica
                    # bytes ride the data plane; the reply releases the
                    # source's registrations
                    from sparkrdma_tpu_torch.transport.staging import pull_payloads

                    payloads = pull_payloads(
                        self.manager.node,
                        req["data_addr"],
                        [(mk, ln) for _, mk, ln in req["blocks_rd"]],
                    )
                    blocks = [
                        (pid, data)
                        for (pid, _, _), data in zip(
                            req["blocks_rd"], payloads
                        )
                    ]
                accepted = store.accept(
                    req["shuffle_id"],
                    req["source"],
                    req["map_id"],
                    blocks,
                )
            return {"ok": True, "result": accepted}
        if kind == "handoff":
            # shuffle-service handoff (elastic/service.py): describe all
            # committed map outputs by file path + partition lengths and
            # ask the daemon to adopt them — no byte copy; the daemon
            # hard-links and re-mmaps the same inodes
            from sparkrdma_tpu_torch.elastic.service import send_adopt

            host, port = req["service"]
            manifests = {}
            for sid in self.manager.resolver.shuffle_ids():
                data = self.manager.resolver.get_shuffle_data(sid)
                manifest = getattr(data, "handoff_manifest", None)
                if manifest is not None:
                    maps = manifest()
                    if maps:
                        manifests[sid] = maps
            adopted = send_adopt(
                (host, port), self.manager.executor_id, manifests
            )
            return {"ok": True, "result": adopted}
        if kind == "telemetry":
            # control-plane pull: hand buffered heartbeats to the driver
            payloads = (
                self.heartbeater.drain() if self.heartbeater is not None else []
            )
            return {"ok": True, "result": payloads}
        if kind == "stop":
            self._stop.set()
            return {"ok": True}
        return {"ok": False, "error": f"unknown task kind {kind!r}"}

    def serve(self) -> None:
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind(("127.0.0.1", 0))
        srv.listen(16)
        srv.settimeout(0.2)
        # announce the task port to the parent (driver) on stdout
        print(f"WORKER_PORT {srv.getsockname()[1]}", flush=True)

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
        if self.heartbeater is not None:
            self.heartbeater.stop(flush=False)  # nobody left to pull
        release_profiler(self.profiler)
        self.profiler = None
        self.manager.stop()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--executor-id", required=True)
    ap.add_argument("--conf", required=True, help="JSON dict of tpu.shuffle.* keys")
    args = ap.parse_args()
    conf = TpuShuffleConf(json.loads(args.conf))
    Worker(conf, args.executor_id).serve()


if __name__ == "__main__":
    main()
