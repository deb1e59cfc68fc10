"""The resident exchange program — all-to-all block transfer over a mesh.

The PyTorch counterpart of the JAX package's ``ops/exchange.py``: every
peer-to-peer block rides in a power-of-two bucket with its true length
beside it (an int32 length prefix), and ragged row counts pad up to a
power-of-two class, so one program shape serves many stages.

``ExchangeProgram`` runs the two transfer schedules over a
``ShardMesh`` (``parallel/mesh.py``), whose E shards share one device:

- ``exchange``: the dense all-to-all. With co-resident shards JAX's
  tiled ``lax.all_to_all`` (an XLA collective, not a Pallas kernel) is a
  transpose of the ``[E, E, rows, block]`` view on its first two axes.
- ``ring_exchange``: E-1 neighbour hops, each a rotation of every
  shard's whole slab (and of its counts) by the ``srt_neighbor_pull``
  kernel (``ops/remote_copy.py``), the arriving row peeled off after
  each hop. Byte-identical to ``exchange``.

Both account bytes in each direction, wall time and the ``exchange.*``
metric families as the JAX program does. The program that
``program_for`` returns (the path of the device steps, which call it
directly) counts ``exchange.exchanges``, ``exchange.bytes_sent`` and
``exchange.bytes_received`` itself, from the shapes, with no device
sync, and runs inside an ``exchange.a2a`` span (``obs/trace.py``
``span``) around its transpose copies, nested directly in the calling
step's span: once a TeraSort step, four times a join step, once an
iteration of a PageRank call.

On a mesh that spans the ranks of a process group
(``parallel/multihost.global_mesh``), ``send`` and ``counts`` are this
rank's rows only, in global shard order, and each call returns this
rank's received rows in the same layout: the counterpart of the JAX
program fed by ``jax.make_array_from_process_local_data``. Shapes stay
exact (no row bucketing), as the JAX multi-host path keeps them.

- ``exchange``: the in-rank part of the transpose is a tensor op; the
  cross-rank part is one ``all_to_all_single`` of raw bytes (each
  peer's blocks and counts in one segment, this rank's own segment
  empty) with explicit split sizes.
- ``ring_exchange``: E-1 hops. Each hop is one ``batch_isend_irecv``
  that sends this rank's first shard's slab (and counts) to rank r-1
  and receives rank r+1's, then one ``srt_neighbor_pull`` each for the
  slabs and the counts whose last row reads the receive buffer
  (``remote_copy.neighbor_pull(..., last=...)``).

The cross-rank leg moves bytes (gloo refuses some dtypes, uint32 among
them). CPU shards, and CUDA shards on ``nccl``, go direct. On a
``gloo`` group, CUDA shards go direct through ``all_to_all_single``
(gloo stages CUDA tensors itself there), but gloo's ``isend`` /
``irecv`` write from the raw pointer (on an H100 with torch 2.11 a CUDA
tensor aborts the process: ``writev ... Bad address``), so the ring's
hops stage through pinned host buffers in explicit copies. The rule
reads the backend and the device only, never a failure.
``cross_rank_path`` names each schedule's leg, and
``cross_rank_bytes`` counts the bytes this rank sent to others, per
schedule. All byte counters are per process, as in the JAX program.
"""

from __future__ import annotations

import time
from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from sparkrdma_tpu_torch.obs import get_registry
from sparkrdma_tpu_torch.obs.trace import span
from sparkrdma_tpu_torch.ops import remote_copy
from sparkrdma_tpu_torch.parallel.mesh import ShardMesh
from sparkrdma_tpu_torch.utils.torch_compat import torch_dtype

MIN_BUCKET = 1024


def round_bucket(nbytes: int, lo: int = MIN_BUCKET, hi: int = 1 << 31) -> int:
    """Round a block size up to its power-of-two bucket class."""
    n = max(lo, min(hi, nbytes))
    return 1 << max(n - 1, 1).bit_length() if n > lo else lo


def round_rows(rows: int, lo: int = 1) -> int:
    """Round a row count up to its power-of-two class — the leading-axis
    twin of :func:`round_bucket`; pad rows carry a zero length."""
    n = max(lo, rows)
    return 1 << max(n - 1, 1).bit_length() if n > lo else lo


def pack_blocks(
    blocks: Sequence[bytes], block_bytes: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Pack one peer-block per row into a [E, block_bytes] send buffer
    plus its length-prefix vector. A block longer than the bucket is a
    caller bug."""
    e = len(blocks)
    out = np.zeros((e, block_bytes), dtype=np.uint8)
    counts = np.zeros((e,), dtype=np.int32)
    for i, b in enumerate(blocks):
        if len(b) > block_bytes:
            raise ValueError(f"block {i} ({len(b)}B) exceeds bucket {block_bytes}B")
        out[i, : len(b)] = np.frombuffer(b, dtype=np.uint8)
        counts[i] = len(b)
    return out, counts


def unpack_blocks(recv: np.ndarray, counts: np.ndarray) -> List[bytes]:
    """Inverse of :func:`pack_blocks` on the received side."""
    return [recv[i, : int(counts[i])].tobytes() for i in range(recv.shape[0])]


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


class ExchangeProgram:
    """All-to-all exchange over a mesh of co-resident shards.

    Global layout, as in the JAX package: ``send`` is ``[E*rows, block]``
    with shard ``i``'s local ``[rows, block]`` slab at rows ``[i*rows,
    (i+1)*rows)``; its row ``j`` (of ``rows == E * rpp``, in peer-major
    chunks of ``rpp``) is bound for peer ``j // rpp``. ``counts`` is the
    int32 length-prefix array of the same leading shape. Afterwards shard
    ``i``'s chunk ``j`` holds what shard ``j`` staged for shard ``i``.
    Both take torch tensors (moved to the mesh's device if elsewhere) or
    numpy arrays.
    """

    def __init__(self, mesh: ShardMesh):
        self.mesh = mesh
        self.axes = tuple(mesh.axis_names)
        self.num_shards = mesh.num_shards
        self._all_to_all_cache = {}
        self._ring_cache = {}
        #: per schedule, "in-process", "direct" or "host-staged" (see the
        #: module's doc)
        self.cross_rank_path = {label: _cross_rank_path(mesh, label)
                                for label in ("a2a", "ring")}
        self.cross_rank_bytes = {"a2a": 0, "ring": 0}
        self.exchanges = 0
        self.bytes_moved = 0
        self.stats = {
            label: {
                "exchanges": 0,
                "bytes_sent": 0,            # bucket capacity dispatched
                "bytes_received": 0,        # bucket capacity landed
                "bytes_received_valid": 0,  # sum of recv length prefixes
                "time_s": 0.0,              # wall incl. device sync
            }
            for label in ("a2a", "ring")
        }

    def _account(self, label: str, send: torch.Tensor, recv: torch.Tensor,
                 rcounts: torch.Tensor, t0: float, counted: bool = False):
        """Wait for the step's outputs and record both directions. The
        valid-byte readback is the call's one device sync: it waits for
        the stream, on which the exchange's own work ran before it, so
        the wall time is a step time. ``counted``: the program has
        already counted the call and its capacity bytes in the
        registry."""
        valid = int(rcounts.sum(dtype=torch.int64))
        dt = time.perf_counter() - t0
        cap = send.numel() * send.element_size()
        recv_cap = recv.numel() * recv.element_size()
        s = self.stats[label]
        s["exchanges"] += 1
        s["bytes_sent"] += cap
        s["bytes_received"] += recv_cap
        s["bytes_received_valid"] += valid
        s["time_s"] += dt
        self.exchanges += 1
        self.bytes_moved += cap
        reg = get_registry()
        if not counted:
            reg.counter("exchange.exchanges", schedule=label).inc()
            reg.counter("exchange.bytes_sent", schedule=label).inc(cap)
            reg.counter("exchange.bytes_received", schedule=label).inc(recv_cap)
        reg.counter("exchange.bytes_received_valid", schedule=label).inc(valid)
        reg.histogram("exchange.time_ms", schedule=label).observe(dt * 1e3)
        return recv, rcounts

    def _placed(self, send, counts) -> Tuple[torch.Tensor, torch.Tensor]:
        """Both arrays as contiguous tensors on the mesh's device."""
        dev = self.mesh.device
        out = []
        for a in (send, counts):
            if isinstance(a, np.ndarray):
                a = torch.from_numpy(np.ascontiguousarray(a))
            out.append(a.to(dev).contiguous())
        send, counts = out
        e = self.mesh.num_local_shards
        if send.dim() < 2 or send.shape[0] % e:
            raise ValueError(
                f"send {tuple(send.shape)} is not [E*rows, block] rows that "
                f"split into {e} shards"
            )
        if tuple(counts.shape) != tuple(send.shape[:1]):
            raise ValueError(
                f"counts {tuple(counts.shape)} do not match send's rows "
                f"{send.shape[0]}"
            )
        if counts.dtype != torch.int32:
            raise ValueError(f"counts are int32 length prefixes, not {counts.dtype}")
        return send, counts

    # -- schedule 1: the dense all-to-all -----------------------------------
    def _build_all_to_all(self, rows: int) -> Callable:
        e = self.num_shards
        if rows % e:
            raise ValueError(f"{rows} rows a shard do not split over {e} peers")
        rpp = rows // e
        # resolved once: the call counts from the shapes, with no sync
        reg = get_registry()
        exchanges = reg.counter("exchange.exchanges", schedule="a2a")
        sent = reg.counter("exchange.bytes_sent", schedule="a2a")
        received = reg.counter("exchange.bytes_received", schedule="a2a")

        def fn(send: torch.Tensor, counts: torch.Tensor):
            with span("exchange.a2a"):
                # shard i's chunk j goes to shard j, landing as its chunk i
                tail = send.shape[1:]
                recv = send.view(e, e, rpp, *tail).transpose(0, 1).contiguous()
                rcounts = counts.view(e, e, rpp).transpose(0, 1).contiguous()
            nbytes = send.numel() * send.element_size()  # recv has send's shape
            exchanges.inc()
            sent.inc(nbytes)
            received.inc(nbytes)
            return recv.view(send.shape), rcounts.view(counts.shape)

        return fn

    def program_for(self, rows: int, block: int, dtype) -> Callable:
        """The cached program ``fn(send, counts) -> (recv, rcounts)`` for
        a shape class, ``rows`` per shard, over co-resident shards. It
        counts each call in the registry (``exchange.exchanges``,
        ``exchange.bytes_sent``, ``exchange.bytes_received``; no
        ``stats``, no sync)."""
        if self.mesh.spans_ranks:
            raise NotImplementedError(
                "a mesh over ranks runs exchange() and ring_exchange(), not a "
                "program over co-resident shards"
            )
        key = ("a2a", rows, (block,), _dtype_name(torch_dtype(dtype)))
        fn = self._all_to_all_cache.get(key)
        if fn is None:
            fn = self._build_all_to_all(rows)
            self._all_to_all_cache[key] = fn
        return fn

    def exchange(self, send, counts):
        """Dense exchange; returns ``(recv, recv_counts)`` with the input
        shapes. Rows-per-peer are bucketed to power-of-two classes
        (:func:`round_rows`) as in the JAX program: pad rows ride with a
        zero length prefix and are stripped before returning, so the
        result is byte-identical to the exact-shape program. On a mesh
        over ranks, this rank's rows in and out, exact shapes."""
        send, counts = self._placed(send, counts)
        if self.mesh.spans_ranks:
            t0 = time.perf_counter()
            recv, rcounts = self._exchange_ranks(send, counts)
            return self._account("a2a", send, recv, rcounts, t0)
        e = self.num_shards
        rows = send.shape[0] // e
        rpp = rows // e if (rows % e == 0 and rows > 0) else 0
        pad = 0
        if rpp > 0:
            rb = round_rows(rpp)
            pad = rb - rpp
            if pad:
                tail = send.shape[1:]
                s = send.new_zeros((e, e, rb, *tail))
                s[:, :, :rpp] = send.view(e, e, rpp, *tail)
                c = counts.new_zeros((e, e, rb))
                c[:, :, :rpp] = counts.view(e, e, rpp)
                send, counts = s.view(e * e * rb, *tail), c.view(-1)
                rows = e * rb
        fn = self.program_for(rows, send.shape[1], send.dtype)
        t0 = time.perf_counter()
        recv, rcounts = fn(send, counts)
        recv, rcounts = self._account("a2a", send, recv, rcounts, t0, counted=True)
        if pad:
            # receivers see each peer's chunk padded at its tail
            rb = rpp + pad
            tail = recv.shape[1:]
            recv = recv.view(e, e, rb, *tail)[:, :, :rpp].reshape(
                e * e * rpp, *tail)
            rcounts = rcounts.view(e, e, rb)[:, :, :rpp].reshape(-1)
        return recv, rcounts

    # -- schedule 2: the staged ring -----------------------------------------
    def _build_ring(self) -> Callable:
        e = self.num_shards

        def fn(send: torch.Tensor, counts: torch.Tensor):
            # the hops move bytes: every row as its raw bytes, so any
            # dtype rides (torch indexes few ops of some, e.g. uint32)
            raw = send.view(torch.uint8)
            slab = raw.reshape(e, e, raw.numel() // (e * e))  # slab[me]: [E, row]
            ccnt = counts.view(e, e)
            me = torch.arange(e, device=send.device)
            recv = torch.empty_like(slab)
            rcounts = torch.empty_like(ccnt)

            def peel(k: int) -> None:
                # the kernel rotates left: after k hops shard me holds the
                # slab of shard (me + k) mod E, whose row me was staged
                # for me. Rows are peeled by one copy each: advanced
                # indexing of byte rows runs far below the copy rate
                for i in range(e):
                    recv[i, (i + k) % e].copy_(slab[i, i])
                rcounts[me, (me + k) % e] = ccnt[me, me]

            peel(0)  # my own row short-circuits locally
            # two ping-pong stacks each for the slabs and the counts: hop
            # k reads one and writes the other, never in place
            bufs = [torch.empty_like(slab), torch.empty_like(slab)]
            cbufs = [torch.empty_like(ccnt), torch.empty_like(ccnt)]
            for k in range(1, e):
                slab = remote_copy.neighbor_pull(slab, out=bufs[k % 2])
                ccnt = remote_copy.neighbor_pull(ccnt, out=cbufs[k % 2])
                peel(k)
            return (recv.view(raw.shape).view(send.dtype),
                    rcounts.view(counts.shape))

        return fn

    def ring_exchange(self, send, counts):
        """Staged exchange: E-1 hops, each one ``srt_neighbor_pull`` of the
        slabs and one of the counts (2(E-1) launches on CUDA). Same result
        as :meth:`exchange`; the ring takes one row per peer. On a mesh
        over ranks, this rank's rows in and out; each hop also sends and
        receives one slab across ranks."""
        send, counts = self._placed(send, counts)
        e, n = self.num_shards, self.mesh.num_local_shards
        if len(self.axes) != 1:
            raise NotImplementedError("ring schedule requires a 1-D mesh")
        if send.shape[0] != n * e:
            raise ValueError(
                f"the ring takes one row per peer ({e} a shard), not "
                f"{send.shape[0] // n}"
            )
        if self.mesh.spans_ranks:
            t0 = time.perf_counter()
            recv, rcounts = self._ring_ranks(send, counts)
            return self._account("ring", send, recv, rcounts, t0)
        key = ("ring", tuple(send.shape[1:]), _dtype_name(send.dtype))
        fn = self._ring_cache.get(key)
        if fn is None:
            fn = self._build_ring()
            self._ring_cache[key] = fn
        t0 = time.perf_counter()
        recv, rcounts = fn(send, counts)
        return self._account("ring", send, recv, rcounts, t0)

    # -- both schedules over ranks -------------------------------------------
    def _staged(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` as the ring's cross-rank leg carries it: itself, or a copy
        in pinned host memory on the host-staged path."""
        if self.cross_rank_path["ring"] != "host-staged":
            return t
        return self._landing(t).copy_(t)

    def _landing(self, like: torch.Tensor) -> torch.Tensor:
        """A receive buffer for the ring's cross-rank leg, shaped as
        ``like``."""
        if self.cross_rank_path["ring"] != "host-staged":
            return torch.empty_like(like)
        return torch.empty(like.shape, dtype=like.dtype, pin_memory=True)

    def _exchange_ranks(self, send: torch.Tensor, counts: torch.Tensor):
        mesh = self.mesh
        e, n, ranks, me = self.num_shards, mesh.num_local_shards, mesh.num_ranks, mesh.rank
        rows = send.shape[0] // n
        if rows % e:
            raise ValueError(f"{rows} rows a shard do not split over {e} peers")
        # [src local, dst rank, dst local, bytes]: every (shard, peer) chunk
        data = send.view(torch.uint8).reshape(n, ranks, n, -1)
        cnt = counts.view(torch.uint8).reshape(n, ranks, n, -1)
        recv = torch.empty((n, ranks, n, data.shape[-1]), dtype=torch.uint8,
                           device=send.device)  # [dst local, src rank, src local, bytes]
        rcnt = torch.empty((n, ranks, n, cnt.shape[-1]), dtype=torch.uint8,
                           device=send.device)
        # this rank's own chunks never leave it: the in-rank transpose
        recv[:, me] = data[:, me].transpose(0, 1)
        rcnt[:, me] = cnt[:, me].transpose(0, 1)
        if ranks > 1:
            db = n * n * data.shape[-1]
            seg = db + n * n * cnt.shape[-1]
            peers = [q for q in range(ranks) if q != me]
            out = torch.empty((len(peers), seg), dtype=torch.uint8, device=send.device)
            for i, q in enumerate(peers):
                out[i, :db].view(n, n, -1).copy_(data[:, q])
                out[i, db:].view(n, n, -1).copy_(cnt[:, q])
            got = torch.empty_like(out)
            splits = [0 if q == me else seg for q in range(ranks)]
            dist.all_to_all_single(got.view(-1), out.view(-1), output_split_sizes=splits,
                                   input_split_sizes=splits, group=mesh.group)
            for i, p in enumerate(peers):
                recv[:, p] = got[i, :db].view(n, n, -1).transpose(0, 1)
                rcnt[:, p] = got[i, db:].view(n, n, -1).transpose(0, 1)
            self.cross_rank_bytes["a2a"] += out.numel()
        return (recv.view(send.dtype).view(send.shape),
                rcnt.view(counts.dtype).view(counts.shape))

    def _ring_ranks(self, send: torch.Tensor, counts: torch.Tensor):
        mesh = self.mesh
        e, n, lo = self.num_shards, mesh.num_local_shards, mesh.local.start
        group = mesh.group
        prev = dist.get_global_rank(group, (mesh.rank - 1) % mesh.num_ranks)
        nxt = dist.get_global_rank(group, (mesh.rank + 1) % mesh.num_ranks)
        raw = send.view(torch.uint8)
        slab = raw.reshape(n, e, raw.numel() // (n * e))  # slab[i]: shard lo+i's [E, row]
        ccnt = counts.view(n, e)
        mine = torch.arange(n, device=send.device)
        recv = torch.empty_like(slab)
        rcounts = torch.empty_like(ccnt)

        def peel(k: int) -> None:
            # after k hops local row i holds the slab of shard lo+i+k,
            # whose row lo+i was staged for this shard
            for i in range(n):
                recv[i, (lo + i + k) % e].copy_(slab[i, lo + i])
            rcounts[mine, (lo + mine + k) % e] = ccnt[mine, lo + mine]

        peel(0)
        bufs = [torch.empty_like(slab), torch.empty_like(slab)]
        cbufs = [torch.empty_like(ccnt), torch.empty_like(ccnt)]
        rslab, rcnt = self._landing(slab[0]), self._landing(ccnt[0].view(torch.uint8))
        for k in range(1, e):
            # the boundary row: shard lo's slab goes to rank r-1, rank
            # r+1's first shard's arrives for row n-1
            ops = [dist.P2POp(dist.isend, self._staged(slab[0]), prev, group, 0),
                   dist.P2POp(dist.irecv, rslab, nxt, group, 0),
                   dist.P2POp(dist.isend, self._staged(ccnt[0].view(torch.uint8)), prev,
                              group, 1),
                   dist.P2POp(dist.irecv, rcnt, nxt, group, 1)]
            for w in dist.batch_isend_irecv(ops):
                w.wait()
            last, lastc = rslab, rcnt
            if rslab.device != send.device:
                last, lastc = rslab.to(send.device), rcnt.to(send.device)
            self.cross_rank_bytes["ring"] += slab[0].numel() + rcnt.numel()
            slab = remote_copy.neighbor_pull(slab, out=bufs[k % 2], last=last)
            ccnt = remote_copy.neighbor_pull(ccnt, out=cbufs[k % 2],
                                             last=lastc.view(torch.int32))
            peel(k)
        return (recv.view(raw.shape).view(send.dtype), rcounts.view(counts.shape))


def _cross_rank_path(mesh: ShardMesh, label: str) -> str:
    """How schedule ``label``'s cross-rank leg moves bytes: ``in-process``
    without ranks; ``host-staged`` for the ring's hops of CUDA shards on
    a gloo group; else ``direct``."""
    if not mesh.spans_ranks:
        return "in-process"
    if (label == "ring" and mesh.device.type == "cuda"
            and dist.get_backend(mesh.group) == "gloo"):
        return "host-staged"
    return "direct"
