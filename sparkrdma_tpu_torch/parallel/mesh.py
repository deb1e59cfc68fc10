"""Mesh construction for the exchange plane.

The PyTorch counterpart of the JAX package's ``parallel/mesh.py``. A
``ShardMesh`` names E shards and the device each lives on, laid out as
``(exec,)`` or ``(dcn, exec)`` exactly as the JAX mesh is:

- the ``"exec"`` axis is the executor ring inside one slice,
- the optional ``"dcn"`` axis is the inter-slice dimension.

Shards are ordered dcn-major and exec-minor, the JAX sharding's global
order, so shard ``i`` of a mesh here is shard ``i`` of the JAX mesh
built from the same device count and ``num_slices``.

The shards of one mesh share one device: ``make_mesh([dev] * 8)`` is
eight shards on one card, the twin of the JAX package's farm of eight
virtual devices on one host. A sharded array is one tensor of leading
size E on that device, row ``i`` holding shard ``i``. Shards spread over
several CUDA devices need peer memory and wait for the multi-GPU slice.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

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
    """E shards on one device, shaped ``{"exec": E}`` or ``{"dcn": s,
    "exec": E // s}``."""

    def __init__(self, devices: Sequence[torch.device], num_slices: int):
        self.devices: List[torch.device] = list(devices)
        n = len(self.devices)
        if num_slices <= 1:
            self.axis_names: Tuple[str, ...] = (EXEC_AXIS,)
            self.shape: Dict[str, int] = {EXEC_AXIS: n}
        else:
            self.axis_names = (DCN_AXIS, EXEC_AXIS)
            self.shape = {DCN_AXIS: num_slices, EXEC_AXIS: n // num_slices}

    @property
    def num_shards(self) -> int:
        return len(self.devices)

    @property
    def device(self) -> torch.device:
        """The one device every shard lives on."""
        return self.devices[0]

    def coords(self, shard: int) -> Dict[str, int]:
        """Shard ``shard``'s index on each axis (dcn-major order)."""
        ex = self.shape[EXEC_AXIS]
        if len(self.axis_names) == 1:
            return {EXEC_AXIS: shard}
        return {DCN_AXIS: shard // ex, EXEC_AXIS: shard % ex}


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


def make_mesh(devices: Optional[Sequence] = None,
              num_slices: Optional[int] = None) -> ShardMesh:
    """Build the framework mesh: ``(dcn, exec)`` if ``num_slices > 1``,
    else ``(exec,)``. ``devices`` names one device per shard (all the
    same device); the default is one shard on ``cuda``, which raises
    without a CUDA device."""
    if devices is None:
        devices = [resolve_device(None)]
    devices = [torch.device(d) for d in devices]
    if not devices:
        raise ValueError("a mesh needs at least one shard")
    dev = _one_device(devices)
    n = len(devices)
    num_slices = 1 if num_slices is None else int(num_slices)
    if num_slices > 1 and n % num_slices != 0:
        raise ValueError(f"{n} devices do not divide into {num_slices} slices")
    return ShardMesh([dev] * n, num_slices)


def mesh_axis_size(mesh: ShardMesh, axis: str = EXEC_AXIS) -> int:
    return mesh.shape[axis]


def all_exchange_axes(mesh: ShardMesh) -> Tuple[str, ...]:
    """Every mesh axis, innermost (exec) first."""
    return tuple(reversed(mesh.axis_names))
