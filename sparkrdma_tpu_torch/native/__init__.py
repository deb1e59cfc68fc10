"""The port's native host libraries: the transport data plane
(``transport.cpp``, bound in ``transport_lib.py``) and the off-heap
arena (``arena.cpp``, ``arena.py``), copies of the JAX package's
sources built with g++ into ``build/native/`` at first use."""

from sparkrdma_tpu_torch.native.arena import NativeArena, native_arena_available

__all__ = ["NativeArena", "native_arena_available"]
