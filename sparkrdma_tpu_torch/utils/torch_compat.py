"""Device resolution, dtype mapping and the CUDA toolkit locator.

The counterpart of the JAX package's ``utils/jax_compat.py``: the small
surface every other module of this package goes through to pick its
device. Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; without a CUDA device they raise instead of carrying
on quietly on the CPU.
"""

from __future__ import annotations

import os
import shutil
from typing import Optional

import numpy as np
import torch

# every dtype numpy and torch share; only byte copies and views run on
# the unsigned 16/32/64-bit ones (torch lacks most compute ops on them)
_NP_TO_TORCH = {
    np.dtype(np.bool_): torch.bool,
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.uint16): torch.uint16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.uint32): torch.uint32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.uint64): torch.uint64,
    np.dtype(np.float16): torch.float16,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
    np.dtype(np.complex64): torch.complex64,
    np.dtype(np.complex128): torch.complex128,
}
_TORCH_TO_NP = {v: k for k, v in _NP_TO_TORCH.items()}


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` by default, the CPU
    only when asked for. Raises when a CUDA device is wanted and none
    is available. A bare ``cuda`` is pinned to the caller's current
    device, so tensors made later on other threads (whose current
    device is ``cuda:0``) land where the entry point was built."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def is_cuda(t: torch.Tensor) -> bool:
    return t.device.type == "cuda"


def torch_dtype(dtype) -> torch.dtype:
    """A numpy dtype (or anything ``np.dtype`` takes, or a torch dtype)
    as a torch dtype. A torch dtype numpy lacks (``torch.bfloat16``)
    passes through: the device path only copies and views its bytes."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return _NP_TO_TORCH[np.dtype(dtype)]


def itemsize(dtype) -> int:
    """Bytes per element of a torch or numpy dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype.itemsize
    return np.dtype(dtype).itemsize


def dtype_name(dtype) -> str:
    """A torch or numpy dtype's name, the same for both (``float16``,
    ``bool``, ``bfloat16``)."""
    if isinstance(dtype, torch.dtype):
        np_dt = _TORCH_TO_NP.get(dtype)
        return np_dt.name if np_dt is not None else str(dtype).removeprefix("torch.")
    return np.dtype(dtype).name


def find_nvcc() -> Optional[str]:
    """The CUDA compiler: on ``PATH``, then in ``$CUDA_HOME/bin``, then
    in ``/usr/local/cuda/bin``; None when none is found."""
    found = shutil.which("nvcc")
    if found:
        return found
    homes = [os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"]
    for home in homes:
        if home:
            cand = os.path.join(home, "bin", "nvcc")
            if os.path.isfile(cand) and os.access(cand, os.X_OK):
                return cand
    return None
