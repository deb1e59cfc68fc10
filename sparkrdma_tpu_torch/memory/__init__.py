"""Registered host memory of the port: the protection domain, buffers
and the size-classed buffer pool (copies of the JAX package's
``memory/registry.py``, ``buffer.py`` and ``buffer_manager.py``).
``registered_buffer.py``, ``mapped_file.py`` and ``streams.py`` serve
the writers and the engine, and come with ROADMAP item M4."""

from sparkrdma_tpu_torch.memory.registry import ProtectionDomain
from sparkrdma_tpu_torch.memory.buffer import TpuBuffer
from sparkrdma_tpu_torch.memory.buffer_manager import TpuBufferManager

__all__ = ["ProtectionDomain", "TpuBuffer", "TpuBufferManager"]
