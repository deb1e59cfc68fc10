"""Multi-process bootstrap — scaling the mesh across ranks.

The PyTorch counterpart of the JAX package's ``parallel/multihost.py``.
Each process calls :func:`initialize` (a thin wrapper over
``torch.distributed.init_process_group``, where the JAX module wraps
``jax.distributed.initialize``), after which :func:`global_mesh` builds
the framework's ``(exec,)`` or ``(dcn, exec)`` mesh over every shard of
every rank, row-major in global order as ``make_mesh`` lays it out, and
``ops/exchange.py``'s ``ExchangeProgram`` moves each rank's rows over
it.

torch has no virtual devices: where the JAX package forces a process's
local device count (``--xla_force_host_platform_device_count``), a rank
here holds ``shards_per_rank`` co-resident shards on its one device.
Every rank passes the same count.

Backends: ``gloo`` carries CPU shards, and CUDA shards through pinned
host buffers (``ops/exchange.py``); ``nccl`` needs one GPU per rank, so
a one-card machine cannot run it. The backend is named at
:func:`initialize` and logged; nothing switches it after a failure.

The host control plane (driver hub, location RPC) is transport-
independent and keeps working unchanged across hosts — executors just
pass real hostnames instead of 127.0.0.1.
"""

from __future__ import annotations

import datetime
import logging
from typing import List, Optional

import torch.distributed as dist

from sparkrdma_tpu_torch.parallel.mesh import ShardMesh, make_mesh
from sparkrdma_tpu_torch.utils.torch_compat import resolve_device

logger = logging.getLogger(__name__)

#: how long ``init_process_group`` waits for every rank (torch's default
#: waits 30 minutes on a coordinator that never answers)
DEFAULT_TIMEOUT_S = 120.0


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: str = "gloo",
) -> None:
    """Join the process group (no-op for single-process runs).

    With a coordinator (``host0:port``), the world size and this
    process's rank, the group rendezvouses at ``tcp://host0:port``;
    without a coordinator it reads ``MASTER_ADDR``, ``MASTER_PORT``,
    ``WORLD_SIZE`` and ``RANK`` (``env://``, what ``torchrun`` sets),
    the counterpart of JAX's auto-detection. A second call, or a call
    with a group already up, does nothing."""
    if num_processes is not None and num_processes <= 1:
        return
    # idempotent like startRdmaNodeIfMissing: skip when a group is up
    if dist.is_initialized():
        logger.debug("torch.distributed already initialized; skipping")
        return
    if coordinator_address is None:
        init_method = "env://"
    else:
        init_method = f"tcp://{coordinator_address}"
    try:
        dist.init_process_group(
            backend=backend,
            init_method=init_method,
            world_size=-1 if num_processes is None else num_processes,
            rank=-1 if process_id is None else process_id,
            timeout=datetime.timedelta(seconds=DEFAULT_TIMEOUT_S),
        )
    except RuntimeError as e:
        # a group another caller started between the check and the call
        msg = str(e).lower()
        if "already" not in msg and "only be called once" not in msg:
            raise
        logger.debug("torch.distributed already initialized: %s", e)
        return
    logger.info("process group: backend %s at %s, rank %s of %s", backend,
                init_method, process_id, num_processes)


def _world() -> tuple:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def global_mesh(num_slices: Optional[int] = None, shards_per_rank: int = 1,
                device=None) -> ShardMesh:
    """The framework mesh over every shard of every rank: ``(exec,)``, or
    ``(dcn, exec)`` with ``num_slices > 1``, E = ranks x
    ``shards_per_rank`` shards in global order. This rank's shards lie
    on ``device`` (``cuda`` unless ``"cpu"`` is asked for). Without a
    process group it is the one-process mesh of ``shards_per_rank``
    shards."""
    n = int(shards_per_rank)
    if n < 1:
        raise ValueError(f"a rank holds at least one shard, not {n}")
    dev = resolve_device(device)
    rank, world = _world()
    mesh = make_mesh([dev] * (n * world), num_slices=num_slices)
    if world == 1:
        return mesh
    return ShardMesh(mesh.devices, mesh.axis_names, mesh.axis_sizes,
                     group=dist.group.WORLD, local=range(rank * n, (rank + 1) * n))


def local_device_indices(shards_per_rank: int = 1) -> List[int]:
    """Global shard indices owned by this rank, sorted (for feeding
    per-rank input pipelines into a mesh over ranks)."""
    rank, _ = _world()
    n = int(shards_per_rank)
    return list(range(rank * n, (rank + 1) * n))
