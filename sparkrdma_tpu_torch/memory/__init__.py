"""Registered host memory of the port: the protection domain, buffers,
the size-classed buffer pool, registered slices, mapped sort files and
memoryview streams (copies of the JAX package's ``memory/registry.py``,
``buffer.py``, ``buffer_manager.py``, ``registered_buffer.py``,
``mapped_file.py`` and ``streams.py``)."""

from sparkrdma_tpu_torch.memory.registry import ProtectionDomain
from sparkrdma_tpu_torch.memory.buffer import TpuBuffer
from sparkrdma_tpu_torch.memory.buffer_manager import TpuBufferManager
from sparkrdma_tpu_torch.memory.registered_buffer import RegisteredBuffer
from sparkrdma_tpu_torch.memory.mapped_file import MappedFile

__all__ = [
    "ProtectionDomain",
    "TpuBuffer",
    "TpuBufferManager",
    "RegisteredBuffer",
    "MappedFile",
]
