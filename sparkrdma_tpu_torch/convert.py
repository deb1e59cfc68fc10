"""Carry the JAX package's staged state over to this package.

This system has no weights: its state is data, the blocks staged in
executor arenas and the locations that name them. ``from_jax_state``
takes a snapshot of the JAX side's arenas as numpy arrays plus its
locations' fields, and builds port arenas holding the same bytes under
the same handles, so every location resolves on both sides. The
attention path holds no state either: q, k and v are its inputs, so
nothing of it is converted. The training path's state is the
transformer's parameters: ``params_from_jax`` carries the JAX package's
``init_params``/``TransformerStep`` parameters across unchanged (both
packages keep ``[d_in, d_out]`` weights used as ``x @ w``), and
``params_to_jax`` carries them back.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Sequence, Tuple

import numpy as np
import torch

from sparkrdma_tpu_torch.locations import (
    BlockLocation,
    PartitionLocation,
    ShuffleManagerId,
)
from sparkrdma_tpu_torch.ops.hbm_arena import DeviceBufferManager, host_tensor
from sparkrdma_tpu_torch.utils.torch_compat import resolve_device


def from_jax_state(
    arenas: Mapping[str, Sequence[Tuple[int, np.ndarray, int]]],
    locations: Sequence[Mapping],
    device=None,
) -> Tuple[Dict[str, DeviceBufferManager], List[PartitionLocation]]:
    """Build port arenas and locations from the JAX side's state.

    ``arenas`` maps an executor id to its live slabs as ``(handle,
    contents, length)``: ``contents`` is the slab's full array (its
    dtype is the staged dtype), ``length`` the payload bytes.
    ``locations`` holds each ``PartitionLocation``'s fields as
    ``dataclasses.asdict`` gives them. Returns ``({executor_id: arena},
    [PartitionLocation])``; registering the arenas is the caller's
    choice."""
    out: Dict[str, DeviceBufferManager] = {}
    for exec_id, slabs in arenas.items():
        arena = DeviceBufferManager(device=device)
        for handle, contents, length in slabs:
            arr = host_tensor(np.ascontiguousarray(contents).reshape(-1))
            arena.put_at(int(handle), arr, int(length))
        out[exec_id] = arena
    locs = [
        PartitionLocation(
            ShuffleManagerId(**f["manager_id"]),
            int(f["partition_id"]),
            BlockLocation(**f["block"]),
        )
        for f in locations
    ]
    return out, locs


def params_from_jax(params: Mapping[str, np.ndarray],
                    device=None) -> Dict[str, torch.Tensor]:
    """The JAX package's transformer parameters (as numpy arrays, or
    anything ``np.asarray`` takes) as port tensors of the same shapes,
    dtypes and values, on ``device`` (``cuda`` unless ``"cpu"`` is asked
    for)."""
    dev = resolve_device(device)
    return {name: torch.from_numpy(np.array(w)).to(dev)
            for name, w in params.items()}


def params_to_jax(params: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The inverse of :func:`params_from_jax`: numpy arrays the JAX
    package's ``TransformerStep`` takes."""
    return {name: np.array(w.detach().cpu()) for name, w in params.items()}
