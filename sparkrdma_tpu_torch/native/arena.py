"""ctypes binding for the native off-heap arena (arena.cpp).

A copy of the JAX package's ``native/arena.py`` on the port's loader
(``native/transport_lib.py``): the library builds with g++ into
``build/native/`` at first use, under the same lock, stamp and
``SPARKRDMA_NATIVE_SANITIZE`` contract as the transport. If it cannot
be built the caller falls back to anonymous ``mmap`` allocations
(``memory/buffer.py``): same semantics, same page alignment, slightly
slower alloc path; :func:`require` raises with g++'s stderr.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

from sparkrdma_tpu_torch.native.transport_lib import (
    _HERE,
    _SANITIZE,
    BUILD_DIR,
    Library,
)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.srt_arena_create.restype = ctypes.c_void_p
    lib.srt_arena_destroy.argtypes = [ctypes.c_void_p]
    lib.srt_alloc.restype = ctypes.c_uint64
    lib.srt_alloc.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.srt_addr.restype = ctypes.c_void_p
    lib.srt_addr.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.srt_size.restype = ctypes.c_uint64
    lib.srt_size.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.srt_free.restype = ctypes.c_int
    lib.srt_free.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.srt_copy.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint64]
    lib.srt_arena_stats.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_uint64),
        ctypes.POINTER(ctypes.c_uint64),
        ctypes.POINTER(ctypes.c_uint64),
    ]
    return lib


LIBRARY = Library(
    _HERE / "arena.cpp",
    BUILD_DIR / (
        "libsrt_arena.%s.so" % _SANITIZE.replace(",", "-").replace("=", "_")
        if _SANITIZE
        else "libsrt_arena.so"
    ),
    _bind,
)


def require() -> ctypes.CDLL:
    """The arena library; raises ``NativeBuildError`` when it cannot be
    built."""
    return LIBRARY.require()


def native_arena_available() -> bool:
    return LIBRARY.load() is not None


class NativeArena:
    """One native arena; usually the process-wide shared instance."""

    _shared: Optional["NativeArena"] = None
    _shared_lock = threading.Lock()

    def __init__(self):
        self._lib = require()
        self._arena = ctypes.c_void_p(self._lib.srt_arena_create())

    @classmethod
    def shared(cls) -> "NativeArena":
        with cls._shared_lock:
            if cls._shared is None:
                cls._shared = cls()
            return cls._shared

    def alloc(self, size: int) -> Tuple[int, memoryview]:
        alloc_id = self._lib.srt_alloc(self._arena, size)
        if alloc_id == 0:
            raise MemoryError(f"native arena failed to allocate {size} bytes")
        addr = self._lib.srt_addr(self._arena, alloc_id)
        buf = (ctypes.c_char * size).from_address(addr)
        return alloc_id, memoryview(buf).cast("B")

    def free(self, alloc_id: int) -> None:
        self._lib.srt_free(self._arena, alloc_id)

    def stats(self) -> Tuple[int, int, int]:
        """(total_allocs, live_bytes, live_count)."""
        t = ctypes.c_uint64()
        b = ctypes.c_uint64()
        c = ctypes.c_uint64()
        self._lib.srt_arena_stats(self._arena, ctypes.byref(t), ctypes.byref(b), ctypes.byref(c))
        return t.value, b.value, c.value
