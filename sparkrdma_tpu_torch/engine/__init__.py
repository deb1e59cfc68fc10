"""The engine's serializer (a copy of the JAX package's
``engine/serializer.py``: the shuffle handle and the resolver need it).
The engine itself (``TpuContext``, the cluster and the workers) comes
with ROADMAP item M5."""

from sparkrdma_tpu_torch.engine.serializer import PickleSerializer, Serializer

__all__ = ["PickleSerializer", "Serializer"]
