"""Carry the JAX package's staged state over to this package.

This system has no weights: its state is data, the blocks staged in
executor arenas and the locations that name them. ``from_jax_state``
takes a snapshot of the JAX side's arenas as numpy arrays plus its
locations' fields, and builds port arenas holding the same bytes under
the same handles, so every location resolves on both sides. The
attention path holds no state either: q, k and v are its inputs, so
nothing of it is converted.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Sequence, Tuple

import numpy as np

from sparkrdma_tpu_torch.locations import (
    BlockLocation,
    PartitionLocation,
    ShuffleManagerId,
)
from sparkrdma_tpu_torch.ops.hbm_arena import DeviceBufferManager, host_tensor


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
