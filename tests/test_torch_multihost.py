"""The port's multi-process bootstrap (``parallel/multihost.py``) and the
exchange program over ranks, against the JAX package.

First the counterparts of every case of ``tests/test_multihost.py``, with
``torch.distributed.init_process_group`` mocked where the JAX tests mock
``jax.distributed.initialize``. Then real two-rank ``gloo`` runs over
loopback with 2 and 4 shards a rank: a cross-rank sum over the global
mesh, and the exchange study's payload (``benchmarks/exchange_study.py``
``_build_send`` / ``_payload``, copied here), a uint32 and a float32
payload through ``exchange`` and ``ring_exchange``, each rank feeding its
own rows. Both ranks' rows, side by side, must be byte-identical to the
JAX single-process ``ExchangeProgram`` on an E-device CPU mesh (the
conftest's 8 devices) and to the port's single-process result. Last, the
neighbor pull's boundary row (a last row read from a separate tensor,
the ring's receive buffer) against its plain version, through the CUDA
branch on a fake kernel library.

Each two-rank run is two child processes drained at once, under a
timeout, on a free port of their own.
"""

from __future__ import annotations

import contextlib
import ctypes
import datetime
import json
import os
import socket
import subprocess
import sys
import textwrap
from unittest import mock

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from sparkrdma_tpu.ops.exchange import ExchangeProgram as JaxProgram
from sparkrdma_tpu.parallel import mesh as jmesh
from sparkrdma_tpu_torch.ops import _build
from sparkrdma_tpu_torch.ops import remote_copy as trc
from sparkrdma_tpu_torch.ops.exchange import ExchangeProgram, pack_blocks
from sparkrdma_tpu_torch.parallel import mesh as tmesh
from sparkrdma_tpu_torch.parallel import multihost

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANKS = 2
CHILD_TIMEOUT_S = 150


# -- the counterparts of tests/test_multihost.py -----------------------------


def test_initialize_single_process_is_noop():
    # num_processes <= 1 must never touch torch.distributed
    with mock.patch.object(dist, "init_process_group") as init:
        multihost.initialize(num_processes=1)
        multihost.initialize(num_processes=0)
    init.assert_not_called()


def test_initialize_plumbs_args():
    with mock.patch.object(dist, "init_process_group") as init:
        multihost.initialize(
            coordinator_address="host0:1234", num_processes=4, process_id=2
        )
    init.assert_called_once_with(
        backend="gloo", init_method="tcp://host0:1234", world_size=4, rank=2,
        timeout=datetime.timedelta(seconds=multihost.DEFAULT_TIMEOUT_S),
    )


@pytest.mark.parametrize("message", [
    "distributed runtime is already initialized",
    "trying to initialize the default process group twice; it should only be called once",
])
def test_initialize_idempotent_on_already_initialized(message):
    # the reference's startRdmaNodeIfMissing semantics: a second call
    # must be a no-op, not an error
    with mock.patch.object(dist, "init_process_group",
                           side_effect=RuntimeError(message)):
        multihost.initialize(
            coordinator_address="host0:1234", num_processes=4, process_id=2
        )


def test_initialize_propagates_real_errors():
    with mock.patch.object(dist, "init_process_group",
                           side_effect=RuntimeError("connection refused")):
        with pytest.raises(RuntimeError, match="connection refused"):
            multihost.initialize(
                coordinator_address="host0:1234", num_processes=4, process_id=1
            )


def test_global_mesh_spans_all_devices():
    for n in (1, 3):
        mesh = multihost.global_mesh(shards_per_rank=n, device="cpu")
        assert mesh.num_shards == n and mesh.num_local_shards == n
        # single-slice meshes collapse to the exec axis; multi-slice adds dcn
        assert "exec" in mesh.axis_names
        assert set(mesh.axis_names) <= {"dcn", "exec"}
        assert not mesh.spans_ranks and mesh.group is None
    mesh = multihost.global_mesh(num_slices=2, shards_per_rank=4, device="cpu")
    assert mesh.shape == {"dcn": 2, "exec": 2}


def test_local_device_indices_cover_local_devices():
    idx = multihost.local_device_indices(shards_per_rank=3)
    assert idx == [0, 1, 2]
    assert sorted(idx) == list(idx)


# -- what the port adds to the bootstrap -------------------------------------


def test_initialize_without_a_coordinator_reads_the_environment():
    with mock.patch.object(dist, "init_process_group") as init:
        multihost.initialize()
    assert init.call_args.kwargs["init_method"] == "env://"
    assert init.call_args.kwargs["world_size"] == -1
    assert init.call_args.kwargs["rank"] == -1


def test_initialize_skips_a_group_that_is_up():
    with mock.patch.object(dist, "is_initialized", return_value=True), \
            mock.patch.object(dist, "init_process_group") as init:
        multihost.initialize(coordinator_address="host0:1234", num_processes=2,
                             process_id=0)
    init.assert_not_called()


def test_mesh_over_ranks_keeps_global_shape_and_refuses_one_process_layouts():
    group = object()
    mesh = tmesh.ShardMesh(["cpu"] * 8, ("exec",), (8,), group=group, local=range(4, 8))
    assert (mesh.num_shards, mesh.num_local_shards, mesh.rank, mesh.num_ranks) == (8, 4, 1, 2)
    assert mesh.spans_ranks and mesh.group is group and mesh.shape == {"exec": 8}
    with pytest.raises(NotImplementedError, match="ranks"):
        tmesh.shard(mesh, torch.zeros(8, 2), ("exec",))
    with pytest.raises(NotImplementedError, match="ranks"):
        tmesh.unshard(mesh, torch.zeros(8, 2), ("exec",))
    for local in (range(3, 7), range(0, 3), range(0, 8, 2)):
        with pytest.raises(ValueError, match="local shards"):
            tmesh.ShardMesh(["cpu"] * 8, ("exec",), (8,), group=group, local=local)
    with pytest.raises(ValueError, match="process group"):
        tmesh.ShardMesh(["cpu"] * 8, ("exec",), (8,), local=range(0, 4))


# -- the exchange study's payload (benchmarks/exchange_study.py) ------------


def _payload(src: int, dst: int, block: int) -> bytes:
    """Deterministic per-(src,dst) block, distinct lengths under the bucket."""
    n = max(1, (block // 2) + ((37 * src + 11 * dst) % (block // 2)))
    return bytes([(src * 16 + dst) % 251]) * n


def _build_send(e: int, block: int):
    rows, counts = [], []
    for src in range(e):
        slab, cnt = pack_blocks([_payload(src, dst, block) for dst in range(e)], block)
        rows.append(slab)
        counts.append(cnt)
    return np.concatenate(rows, axis=0), np.concatenate(counts, axis=0)


def _payloads(e: int):
    """{kind: (send, counts, rows per peer)}: every kind goes through
    ``exchange``; those of one row per peer through ``ring_exchange``."""
    rng = np.random.default_rng(19 + e)
    study = _build_send(e, 256)
    u32 = rng.integers(0, 1 << 32, (e * e * 2, 16), dtype=np.uint32)
    f32 = rng.standard_normal((e * e, 8)).astype(np.float32)
    return {
        "study_uint8": (*study, 1),
        "uint32_rpp2": (u32, rng.integers(0, 65, e * e * 2).astype(np.int32), 2),
        "float32": (f32, rng.integers(0, 33, e * e).astype(np.int32), 1),
    }


_WORKER = textwrap.dedent(
    """
    import contextlib, ctypes, json, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    rank, port, n, out = int(sys.argv[1]), sys.argv[2], int(sys.argv[3]), sys.argv[4]

    from sparkrdma_tpu_torch.obs import get_registry
    from sparkrdma_tpu_torch.ops import _build
    from sparkrdma_tpu_torch.ops import remote_copy as rc
    from sparkrdma_tpu_torch.ops.exchange import ExchangeProgram
    from sparkrdma_tpu_torch.parallel import multihost

    multihost.initialize(f"127.0.0.1:{port}", 2, rank)
    # idempotence under a LIVE group, not a mock
    multihost.initialize(f"127.0.0.1:{port}", 2, rank)
    mesh = multihost.global_mesh(shards_per_rank=n, device="cpu")
    idx = multihost.local_device_indices(n)
    # one collective proves the bootstrap wired the processes together:
    # every shard contributes its global index
    total = torch.tensor([float(sum(idx))])
    dist.all_reduce(total)
    res = {"backend": dist.get_backend(), "world": dist.get_world_size(),
           "rank": dist.get_rank(), "idx": idx, "sum": total.item(),
           "shape": mesh.shape, "local": [mesh.local.start, mesh.local.stop]}
    e = mesh.num_shards
    data = np.load(f"{out}/payloads.npz")
    arrays, stats = {}, {}
    reg = get_registry()

    def counters(label):
        return {f: reg.counter(f"exchange.{f}", schedule=label).value
                for f in ("exchanges", "bytes_sent", "bytes_received",
                          "bytes_received_valid")}

    for kind in sorted({k.rsplit("_", 1)[0] for k in data.files}):
        send, counts, rpp = data[kind + "_send"], data[kind + "_counts"], int(data[kind + "_rpp"])
        rows = n * e * rpp
        mine = slice(rank * rows, (rank + 1) * rows)
        prog = ExchangeProgram(mesh)
        c0 = {label: counters(label) for label in ("a2a", "ring")}
        arrays[kind + "_a2a"], arrays[kind + "_a2a_counts"] = [
            t.numpy() for t in prog.exchange(send[mine], counts[mine])]
        if rpp == 1:
            arrays[kind + "_ring"], arrays[kind + "_ring_counts"] = [
                t.numpy() for t in prog.ring_exchange(send[mine], counts[mine])]
        stats[kind] = {"stats": prog.stats, "path": prog.cross_rank_path,
                       "cross_rank_bytes": prog.cross_rank_bytes,
                       "local_send_bytes": send[mine].nbytes,
                       "registry": {label: {f: v - c0[label][f] for f, v in
                                            counters(label).items()}
                                    for label in ("a2a", "ring")}}
    res["stats"] = stats
    try:
        prog.program_for(n * e, 16, torch.uint8)
    except NotImplementedError as err:
        res["program_for"] = str(err)

    # the dense exchange over a (dcn 2, exec E/2) mesh of the same ranks
    mesh2 = multihost.global_mesh(num_slices=2, shards_per_rank=n, device="cpu")
    send, counts = data["study_uint8_send"], data["study_uint8_counts"]
    mine = slice(rank * n * e, (rank + 1) * n * e)
    prog2 = ExchangeProgram(mesh2)
    arrays["dcn_a2a"], arrays["dcn_a2a_counts"] = [
        t.numpy() for t in prog2.exchange(send[mine], counts[mine])]
    res["mesh2"] = mesh2.shape
    try:
        prog2.ring_exchange(send[mine], counts[mine])
    except NotImplementedError as err:
        res["ring_2d"] = str(err)

    # the ring over ranks through the kernel branch, on a fake library
    # that rotates through the (src, dst) pointer table it is handed
    class FakeLib:
        def srt_neighbor_pull(self, table, rows, shard_bytes, stream):
            t = (ctypes.c_uint64 * (2 * rows)).from_address(table)
            for i in range(rows):
                ctypes.memmove(t[2 * i + 1], t[2 * ((i + 1) % rows)], shard_bytes)
            return 0

    rc._kernel_path = lambda b: True
    _build._on_device = lambda symbol, device: contextlib.nullcontext((FakeLib(), 0))
    _build.reset_launch_counts()
    arrays["kernel_ring"], arrays["kernel_ring_counts"] = [
        t.numpy() for t in ExchangeProgram(mesh).ring_exchange(send[mine], counts[mine])]
    res["kernel_ring_launches"] = _build.launches["srt_neighbor_pull"]
    np.savez(f"{out}/rank{rank}.npz", **arrays)
    dist.destroy_process_group()
    print("RESULT " + json.dumps(res))
    """
)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_ranks(tmp, n: int):
    """Both ranks as child processes, drained together; each rank's
    result line and arrays."""
    script = tmp / "worker.py"
    script.write_text(_WORKER)
    env = {**os.environ, "PYTHONPATH": ROOT}
    env.pop("SPARKRDMA_LOCK_ORDER", None)
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, str(script), str(r), str(port), str(n), str(tmp)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=env, cwd=ROOT)
             for r in range(RANKS)]
    outs = [""] * RANKS
    try:
        # one thread a pipe, so neither child can block on a full pipe
        # while the other is waited for
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(RANKS) as pool:
            outs = list(pool.map(lambda p: p.communicate(timeout=CHILD_TIMEOUT_S)[0], procs))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    results = []
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out}"
        line = [ln for ln in out.splitlines() if ln.startswith("RESULT ")][-1]
        results.append((json.loads(line[len("RESULT "):]), dict(np.load(tmp / f"rank{r}.npz"))))
    return results


@pytest.fixture(scope="module", params=[2, 4], ids=["2-shards-a-rank", "4-shards-a-rank"])
def two_ranks(request, tmp_path_factory):
    n = request.param
    e = RANKS * n
    tmp = tmp_path_factory.mktemp(f"ranks{n}")
    payloads = _payloads(e)
    np.savez(tmp / "payloads.npz", **{
        f"{kind}_{part}": v for kind, (send, counts, rpp) in payloads.items()
        for part, v in (("send", send), ("counts", counts), ("rpp", np.int64(rpp)))})
    return {"n": n, "e": e, "payloads": payloads, "ranks": _run_ranks(tmp, n)}


def _both(two_ranks, key):
    return np.concatenate([arrays[key] for _, arrays in two_ranks["ranks"]])


def _jax_exchange(e, send, counts, schedule="exchange", num_slices=None):
    prog = JaxProgram(jmesh.make_mesh(jax.devices()[:e], num_slices=num_slices))
    recv, rcounts = getattr(prog, schedule)(send, counts)
    return np.asarray(recv), np.asarray(rcounts)


def _port_exchange(e, send, counts, schedule="exchange", num_slices=None):
    prog = ExchangeProgram(tmesh.make_mesh(["cpu"] * e, num_slices=num_slices))
    recv, rcounts = getattr(prog, schedule)(send, counts)
    return recv.numpy(), rcounts.numpy()


def test_two_rank_bootstrap(two_ranks):
    """Real gloo over loopback: a global mesh of 2 x n shards, a
    cross-rank sum of every shard's global index, initialize idempotent
    under the live group, each rank's indices sorted and its own."""
    n, e = two_ranks["n"], two_ranks["e"]
    for r, (res, _) in enumerate(two_ranks["ranks"]):
        assert (res["backend"], res["world"], res["rank"]) == ("gloo", RANKS, r)
        assert res["idx"] == sorted(res["idx"]) == list(range(r * n, (r + 1) * n))
        assert res["local"] == [r * n, (r + 1) * n]
        assert res["shape"] == {"exec": e}
        assert res["sum"] == sum(range(e))
    if n == 2:
        assert two_ranks["ranks"][0][0]["sum"] == 0.0 + 1 + 2 + 3


@pytest.mark.parametrize("kind", ["study_uint8", "uint32_rpp2", "float32"])
def test_exchange_over_ranks_matches_jax(two_ranks, kind):
    e = two_ranks["e"]
    send, counts, _ = two_ranks["payloads"][kind]
    got = _both(two_ranks, kind + "_a2a"), _both(two_ranks, kind + "_a2a_counts")
    for want in (_jax_exchange(e, send, counts), _port_exchange(e, send, counts)):
        assert got[0].dtype == want[0].dtype and got[0].shape == want[0].shape
        assert got[0].tobytes() == want[0].tobytes()
        assert got[1].tobytes() == want[1].tobytes()


@pytest.mark.parametrize("kind", ["study_uint8", "float32"])
def test_ring_over_ranks_matches_jax(two_ranks, kind):
    e = two_ranks["e"]
    send, counts, _ = two_ranks["payloads"][kind]
    got = _both(two_ranks, kind + "_ring"), _both(two_ranks, kind + "_ring_counts")
    for want in (_jax_exchange(e, send, counts, "ring_exchange"),
                 _port_exchange(e, send, counts, "ring_exchange")):
        assert got[0].tobytes() == want[0].tobytes()
        assert got[1].tobytes() == want[1].tobytes()


def test_ring_over_ranks_through_the_kernel_branch(two_ranks):
    """The ring over ranks with the kernel branch taken (a fake library):
    2(E-1) launches a rank, each row from the pointer table, the last
    row from the receive buffer; the rows equal the JAX ring's."""
    e = two_ranks["e"]
    send, counts, _ = two_ranks["payloads"]["study_uint8"]
    want = _jax_exchange(e, send, counts, "ring_exchange")
    assert _both(two_ranks, "kernel_ring").tobytes() == want[0].tobytes()
    assert _both(two_ranks, "kernel_ring_counts").tobytes() == want[1].tobytes()
    for res, _ in two_ranks["ranks"]:
        assert res["kernel_ring_launches"] == 2 * (e - 1)


def test_dense_exchange_on_a_dcn_exec_mesh_over_ranks(two_ranks):
    e = two_ranks["e"]
    send, counts, _ = two_ranks["payloads"]["study_uint8"]
    for res, _ in two_ranks["ranks"]:
        assert res["mesh2"] == {"dcn": 2, "exec": e // 2}
    got = _both(two_ranks, "dcn_a2a"), _both(two_ranks, "dcn_a2a_counts")
    for want in (_jax_exchange(e, send, counts, num_slices=2),
                 _port_exchange(e, send, counts, num_slices=2)):
        assert got[0].tobytes() == want[0].tobytes()
        assert got[1].tobytes() == want[1].tobytes()


def test_ring_and_programs_refuse_what_ranks_cannot_run(two_ranks):
    for res, _ in two_ranks["ranks"]:
        assert res["ring_2d"] == "ring schedule requires a 1-D mesh"
        assert "exchange() and ring_exchange()" in res["program_for"]
    with pytest.raises(NotImplementedError, match="1-D mesh"):
        _port_exchange(4, *_payloads(4)["study_uint8"][:2], "ring_exchange", num_slices=2)


def test_counters_are_per_process(two_ranks):
    """``bytes_sent`` is this rank's local capacity, ``bytes_received_valid``
    the sum of its received length prefixes (0 < valid <= the global
    total), and the ``exchange.*`` families move by the same amounts;
    the CPU ranks' leg goes direct."""
    for kind, (send, counts, rpp) in two_ranks["payloads"].items():
        total = int(counts.sum())
        valid = []
        for r, (res, arrays) in enumerate(two_ranks["ranks"]):
            st = res["stats"][kind]
            assert st["path"] == {"a2a": "direct", "ring": "direct"}
            for label in (("a2a", "ring") if rpp == 1 else ("a2a",)):
                s = st["stats"][label]
                assert s["exchanges"] == 1
                assert s["bytes_sent"] == st["local_send_bytes"] == send.nbytes // RANKS
                assert s["bytes_received"] == arrays[f"{kind}_{label}"].nbytes
                got = int(arrays[f"{kind}_{label}_counts"].sum())
                assert s["bytes_received_valid"] == got and 0 < got <= total
                assert st["registry"][label] == {f: s[f] for f in (
                    "exchanges", "bytes_sent", "bytes_received", "bytes_received_valid")}
                if label == "a2a":
                    valid.append(got)
            # the cross-rank leg carries half of each rank's blocks
            assert st["cross_rank_bytes"]["a2a"] == (
                (send.nbytes + counts.nbytes) // RANKS // RANKS)
        assert sum(valid) == total


# -- the neighbor pull's boundary row ----------------------------------------


class _FakeLib:
    """The built library's stand-in: ``srt_neighbor_pull`` rotates through
    the (src, dst) pointer table it is handed, so the table is under
    test."""

    def __init__(self):
        self.calls = 0

    def srt_neighbor_pull(self, table, n, shard_bytes, stream):
        self.calls += 1
        t = (ctypes.c_uint64 * (2 * n)).from_address(table)
        for i in range(n):
            ctypes.memmove(t[2 * i + 1], t[2 * ((i + 1) % n)], shard_bytes)
        return 0


@pytest.fixture
def kernel_path(monkeypatch):
    lib = _FakeLib()
    monkeypatch.setattr(trc, "_kernel_path", lambda b: True)
    monkeypatch.setattr(_build, "_on_device",
                        lambda symbol, device: contextlib.nullcontext((lib, 0)))
    return lib


def _stack_and_last(n, shape, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    raw = torch.randint(0, 256, ((n + 1) * int(np.prod(shape)) * torch.empty(
        (), dtype=dtype).element_size(),), dtype=torch.uint8, generator=g)
    both = raw.view(dtype).view(n + 1, *shape)
    return both[:n].clone(), both[n].clone()


@pytest.mark.parametrize("n,shape,dtype", [
    (1, (7,), torch.uint8), (3, (5,), torch.int32), (4, (8, 33), torch.uint8),
    (2, (4097,), torch.bfloat16), (8, (3,), torch.float32),
])
def test_boundary_row_plain_version(n, shape, dtype):
    blocks, last = _stack_and_last(n, shape, dtype, seed=n)
    got = trc.neighbor_pull(blocks, last=last)
    want = torch.cat([torch.roll(blocks, -1, 0)[: n - 1], last[None]])
    assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))
    assert torch.equal(trc.neighbor_pull_reference(blocks, last).view(torch.uint8),
                       want.view(torch.uint8))


@pytest.mark.parametrize("n,shape,dtype", [
    (1, (7,), torch.uint8), (3, (5,), torch.int32), (4, (8, 33), torch.uint8),
    (2, (4097,), torch.bfloat16), (8, (3,), torch.float32),
])
def test_boundary_row_through_the_kernel_branch(kernel_path, n, shape, dtype):
    """One launch; row n-1 reads the separate tensor through the pointer
    table; equal to the plain version byte for byte."""
    blocks, last = _stack_and_last(n, shape, dtype, seed=10 + n)
    out = torch.zeros_like(blocks)
    _build.reset_launch_counts()
    got = trc.neighbor_pull(blocks, out=out, last=last)
    assert got.data_ptr() == out.data_ptr()
    assert kernel_path.calls == 1 and _build.launches["srt_neighbor_pull"] == 1
    want = trc.neighbor_pull_reference(blocks, last)
    assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))


def test_boundary_row_is_checked():
    blocks = torch.zeros(3, 4, dtype=torch.int32)
    out = torch.empty_like(blocks)
    for bad in (torch.zeros(5, dtype=torch.int32), torch.zeros(4, dtype=torch.float32),
                torch.zeros(4, 2, dtype=torch.int32)[:, 0], out[1]):
        with pytest.raises(ValueError, match="last"):
            trc.neighbor_pull(blocks, out=out, last=bad)
