"""Mesh construction for the exchange plane and the training step.

The PyTorch counterpart of the JAX package's ``parallel/mesh.py``. A
``ShardMesh`` names E shards, the device each lives on and the mesh's
named axes, laid out as a JAX ``Mesh`` of
``np.array(devices).reshape(shape)``: shard ``i`` sits at the row-major
coordinates of ``i`` in ``shape``. ``make_mesh`` builds the exchange
plane's ``(exec,)`` or ``(dcn, exec)`` layout, exactly as the JAX mesh
is:

- the ``"exec"`` axis is the executor ring inside one slice,
- the optional ``"dcn"`` axis is the inter-slice dimension,

and ``named_mesh`` any other, such as the training step's ``(dp, sp,
tp)`` (``models/transformer_step.make_training_mesh``).

The shards of one mesh share one device: ``make_mesh([dev] * 8)`` is
eight shards on one card, the twin of the JAX package's farm of eight
virtual devices on one host. A sharded array is one tensor of leading
shape ``shape`` (or leading size E) on that device: :func:`shard` lays a
global tensor out over the mesh by a ``PartitionSpec``-like tuple,
replicating it over the axes the spec does not name, and :func:`unshard`
is its inverse. Shards spread over several CUDA devices need peer memory and
wait for the multi-GPU slice (ROADMAP M7).

A mesh may span the ranks of a ``torch.distributed`` process group
(``parallel/multihost.global_mesh``): its ``shape``, ``axis_names`` and
``num_shards`` stay global, and each rank holds the contiguous run
``local`` of shards (rank ``r`` of R holds ``[r * E / R, (r + 1) * E /
R)``, in global shard order) on its one device. Such a mesh carries
each rank's rows through ``ops/exchange.py``'s ``exchange`` and
``ring_exchange``; :func:`shard` and :func:`unshard`, which lay a
global tensor out in one process, refuse it.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from sparkrdma_tpu_torch.utils.torch_compat import resolve_device

# Canonical axis names, as in the JAX package.
EXEC_AXIS = "exec"
DCN_AXIS = "dcn"


def exec_axis() -> str:
    return EXEC_AXIS


def dcn_axis() -> str:
    return DCN_AXIS


class ShardMesh:
    """E shards on one device, with named axes ordered row-major over
    ``shape`` (``{"exec": E}``, ``{"dcn": s, "exec": E // s}``, ``{"dp":
    ., "sp": ., "tp": .}``, ...).

    ``group``, when given, is the process group the mesh spans, and
    ``local`` the run of global shard indices this rank holds; every
    entry of ``devices`` then names this rank's device (the other ranks'
    are not addressable here)."""

    def __init__(self, devices: Sequence[torch.device],
                 axis_names: Sequence[str], shape: Sequence[int],
                 group=None, local: Optional[range] = None):
        self.devices: List[torch.device] = list(devices)
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        sizes = tuple(int(n) for n in shape)
        if len(sizes) != len(self.axis_names) or len(set(self.axis_names)) != len(sizes):
            raise ValueError(f"axes {self.axis_names} do not name shape {sizes}")
        if math.prod(sizes) != len(self.devices):
            raise ValueError(
                f"{len(self.devices)} devices do not fill a {sizes} mesh"
            )
        self.shape: Dict[str, int] = dict(zip(self.axis_names, sizes))
        e = len(self.devices)
        self.group = group
        self.local: range = range(e) if local is None else local
        n = len(self.local)
        if (n == 0 or self.local.step != 1 or e % n or self.local.start % n
                or self.local.stop > e):
            raise ValueError(f"local shards {self.local} are not one rank's run of {e}")
        if group is None and n != e:
            raise ValueError("a mesh without a process group holds every shard")
        #: this rank and the number of ranks (0 and 1 without a group)
        self.rank = self.local.start // n
        self.num_ranks = e // n

    @property
    def spans_ranks(self) -> bool:
        """True when the shards lie on more than one rank."""
        return self.num_ranks > 1

    @property
    def num_local_shards(self) -> int:
        return len(self.local)

    @property
    def num_shards(self) -> int:
        return len(self.devices)

    @property
    def axis_sizes(self) -> Tuple[int, ...]:
        return tuple(self.shape.values())

    def axis_index(self, axis: str) -> int:
        """The position of ``axis`` among the mesh's axes (and the leading
        dims of a shard stack)."""
        if axis not in self.shape:
            raise ValueError(f"the mesh has no axis {axis!r}: {self.axis_names}")
        return self.axis_names.index(axis)

    @property
    def device(self) -> torch.device:
        """The one device every shard of this rank lives on."""
        return self.devices[0]

    def coords(self, shard: int) -> Dict[str, int]:
        """Shard ``shard``'s index on each axis (row-major, the first axis
        outermost)."""
        idx = np.unravel_index(shard, self.axis_sizes)
        return {a: int(i) for a, i in zip(self.axis_names, idx)}


def _one_device(devices: Sequence[torch.device]) -> torch.device:
    """The device every shard names; raises unless there is exactly one."""
    types = {d.type for d in devices}
    if len(types) > 1:
        raise ValueError(f"a mesh cannot mix device types: {sorted(types)}")
    (kind,) = types
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"a mesh runs on cuda or cpu, not {kind}")
    if kind == "cpu":
        return torch.device("cpu")
    # a bare "cuda" names the current device
    current = torch.cuda.current_device() if torch.cuda.is_available() else 0
    indices = {current if d.index is None else d.index for d in devices}
    if len(indices) > 1:
        raise NotImplementedError(
            f"shards on several CUDA devices ({sorted(map(str, devices))}) "
            "need peer memory: that is the multi-GPU slice"
        )
    resolve_device(devices[0])  # raises without a CUDA device
    return torch.device("cuda", indices.pop())


def named_mesh(devices: Sequence, axis_names: Sequence[str],
               shape: Sequence[int]) -> ShardMesh:
    """A mesh of ``devices`` (one per shard, all the same device) with
    the given axes, as a JAX ``Mesh(np.array(devices).reshape(shape),
    axis_names)``."""
    devices = [torch.device(d) for d in devices]
    if not devices:
        raise ValueError("a mesh needs at least one shard")
    dev = _one_device(devices)
    return ShardMesh([dev] * len(devices), axis_names, shape)


def make_mesh(devices: Optional[Sequence] = None,
              num_slices: Optional[int] = None) -> ShardMesh:
    """Build the framework mesh: ``(dcn, exec)`` if ``num_slices > 1``,
    else ``(exec,)``. ``devices`` names one device per shard (all the
    same device); the default is one shard on ``cuda``, which raises
    without a CUDA device."""
    if devices is None:
        devices = [resolve_device(None)]
    n = len(devices)
    num_slices = 1 if num_slices is None else int(num_slices)
    if num_slices <= 1:
        return named_mesh(devices, (EXEC_AXIS,), (n,))
    if n % num_slices != 0:
        raise ValueError(f"{n} devices do not divide into {num_slices} slices")
    return named_mesh(devices, (DCN_AXIS, EXEC_AXIS), (num_slices, n // num_slices))


def mesh_or_one_shard(mesh: Optional[ShardMesh], device=None) -> ShardMesh:
    """``mesh``, or one shard on ``device`` (``cuda`` unless ``"cpu"`` is
    asked for) when it is None; a ``device`` given with a mesh must be
    the mesh's."""
    if mesh is None:
        return make_mesh([resolve_device(device)])
    if device is not None and resolve_device(device) != mesh.device:
        raise ValueError(f"device {device} is not the mesh's {mesh.device}")
    return mesh


def mesh_axis_size(mesh: ShardMesh, axis: str = EXEC_AXIS) -> int:
    return mesh.shape[axis]


def all_exchange_axes(mesh: ShardMesh) -> Tuple[str, ...]:
    """Every mesh axis, innermost (exec) first."""
    return tuple(reversed(mesh.axis_names))


def _full_spec(spec: Sequence[Optional[str]], ndim: int) -> Tuple[Optional[str], ...]:
    spec = tuple(spec)
    if len(spec) > ndim:
        raise ValueError(f"spec {spec} names more than {ndim} dims")
    return spec + (None,) * (ndim - len(spec))


def _one_process(mesh: ShardMesh, what: str) -> None:
    if mesh.spans_ranks:
        raise NotImplementedError(
            f"{what} lays a global tensor out in one process; a mesh over "
            f"{mesh.num_ranks} ranks takes each rank's rows"
        )


def shard(mesh: ShardMesh, x: torch.Tensor,
          spec: Sequence[Optional[str]]) -> torch.Tensor:
    """Lay the global tensor ``x`` out as a shard stack: a contiguous
    ``[*mesh.axis_sizes, *local]`` tensor in which the shard at mesh
    coordinates ``c`` holds its block of ``x``. ``spec`` names, per dim
    of ``x``, the mesh axis that splits it or None (a JAX
    ``PartitionSpec``; trailing dims may be left out); the axes it does
    not name hold copies. Differentiable (its adjoint sums the copies)."""
    _one_process(mesh, "shard")
    spec = _full_spec(spec, x.dim())
    names, k = mesh.axis_names, len(mesh.axis_names)
    split, at = [], {}
    for d, ax in enumerate(spec):
        if ax is None:
            split.append(x.shape[d])
            continue
        mesh.axis_index(ax)  # raises for an axis the mesh lacks
        n = mesh.shape[ax]
        if ax in at or x.shape[d] % n:
            raise ValueError(
                f"dim {d} of {tuple(x.shape)} does not split over axis {ax!r} ({n})"
            )
        at[ax] = len(split)
        split += [n, x.shape[d] // n]
    local = [i for i in range(len(split)) if i not in at.values()]
    t = x.reshape(split).permute([at[a] for a in names if a in at] + local)
    lead = [mesh.shape[a] if a in at else 1 for a in names]
    t = t.reshape(lead + [split[i] for i in local])
    return t.expand(*mesh.axis_sizes, *t.shape[k:]).contiguous()


def unshard(mesh: ShardMesh, stack: torch.Tensor,
            spec: Sequence[Optional[str]]) -> torch.Tensor:
    """The inverse of :func:`shard`: the global tensor from a shard stack,
    reading the copy at coordinate 0 of every axis ``spec`` does not
    name."""
    _one_process(mesh, "unshard")
    names, k = mesh.axis_names, len(mesh.axis_names)
    if tuple(stack.shape[:k]) != mesh.axis_sizes:
        raise ValueError(f"a {tuple(stack.shape)} stack is not over a {mesh.axis_sizes} mesh")
    local = stack.shape[k:]
    spec = _full_spec(spec, len(local))
    t, order, out = stack, [], []
    for i, a in enumerate(names):
        if a not in spec:
            t = t.narrow(i, 0, 1)
            order.append(i)
    for d, ax in enumerate(spec):
        if ax is None:
            order.append(k + d)
            out.append(local[d])
        else:
            order += [names.index(ax), k + d]
            out.append(mesh.shape[ax] * local[d])
    return t.permute(order).reshape(out)
