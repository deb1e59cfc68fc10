"""ctypes binding for the native transport data plane (transport.cpp).

A copy of the JAX package's ``native/transport_lib.py`` with three
differences, in the pattern of ``ops/_build.py``:

- the library builds with g++ into ``build/native/`` under the checkout
  root, beside a stamp holding the hash of the source and flags, and is
  rebuilt at first use whenever that hash changes; nothing is written
  next to the source;
- the build writes a temporary name and ``os.replace``s it into place
  under a file lock, so processes that start the first build together
  (test workers) never load a half-written library;
- a failed build is never silent: :func:`require` raises with g++'s
  stderr. :func:`load` returning None stays, for :func:`available` only.

Nothing is built at import time.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Dict, Optional, Sequence

_HERE = Path(__file__).resolve().parent
_SRC = _HERE / "transport.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"

# SPARKRDMA_NATIVE_SANITIZE="thread,undefined" rebuilds the plane with
# -fsanitize=... under a library name of its own. TSan-instrumented
# objects need the runtime loaded first: run under
# LD_PRELOAD=$(g++ -print-file-name=libtsan.so) or dlopen dies
# allocating static TLS.
_SANITIZE = os.environ.get("SPARKRDMA_NATIVE_SANITIZE", "").strip()

# SPARKRDMA_NATIVE_NO_IOURING=1 compiles the io_uring read backend OUT
# (-DSRT_NO_IOURING) under a library name of its own: the submission
# plane then reports the pread fallback.
_NO_IOURING = os.environ.get(
    "SPARKRDMA_NATIVE_NO_IOURING", ""
).strip() not in ("", "0")


def _lib_name(base: str) -> str:
    tags = []
    if _SANITIZE:
        tags.append(_SANITIZE.replace(",", "-").replace("=", "_"))
    if _NO_IOURING:
        tags.append("nouring")
    if tags:
        return f"{base}.{'.'.join(tags)}.so"
    return f"{base}.so"


def _build_flags() -> list:
    flags = ["-O2", "-std=c++17", "-shared", "-fPIC", "-pthread"]
    if _SANITIZE:
        flags += [f"-fsanitize={_SANITIZE}", "-fno-sanitize-recover=all", "-g"]
    if _NO_IOURING:
        flags.append("-DSRT_NO_IOURING")
    return flags


class NativeBuildError(RuntimeError):
    """g++ could not build a native library; the message holds its
    stderr."""


# seconds each library's build took in this process (absent: loaded a
# library already built from the same source and flags)
build_seconds: Dict[str, float] = {}


def sources_hash(src: Path, flags: Sequence[str]) -> str:
    h = hashlib.sha256()
    h.update(src.name.encode())
    h.update(src.read_bytes())
    h.update(" ".join(flags).encode())
    return h.hexdigest()


def build_library(src: Path, out: Path, flags: Sequence[str]) -> Path:
    """``out``, built from ``src`` with g++ ``flags`` unless the library
    on disk was built from the same source and flags (its stamp holds
    their hash). Several processes may call this at once: one builds
    under the library's lock file and the rest find its result."""
    digest = sources_hash(src, flags)
    stamp = out.with_name(out.name + ".sha256")

    def fresh() -> bool:
        return (out.exists() and stamp.exists()
                and stamp.read_text() == digest)

    if fresh():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    # one lock a library: the arena's short build never queues behind
    # another process's transport build
    with open(out.with_name(out.name + ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if fresh():
                return out
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            t0 = time.perf_counter()
            try:
                proc = subprocess.run(
                    ["g++", *flags, "-o", str(tmp), str(src)],
                    capture_output=True, text=True,
                )
            except OSError as e:
                raise NativeBuildError(f"g++ could not run: {e}") from e
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise NativeBuildError(
                    f"g++ failed ({proc.returncode}) building {src}:\n"
                    f"{proc.stderr}"
                )
            build_seconds[out.name] = time.perf_counter() - t0
            os.replace(tmp, out)
            stamp.write_text(digest)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return out


class Library:
    """One g++-built library of ``src``, built into ``so`` and bound by
    ``bind`` at the first :meth:`require`. A failed build is remembered
    and raised again at every later call, never retried quietly."""

    def __init__(self, src: Path, so: Path, bind: Callable[[ctypes.CDLL], ctypes.CDLL]):
        self.src, self.so, self._bind = src, so, bind
        self.lib: Optional[ctypes.CDLL] = None
        self.error: Optional[BaseException] = None
        self._lock = threading.Lock()

    def require(self) -> ctypes.CDLL:
        """The library; raises :class:`NativeBuildError` (with g++'s
        stderr) when it cannot be built."""
        if self.lib is not None:
            return self.lib
        with self._lock:
            if self.lib is None:
                if self.error is not None:
                    raise NativeBuildError(str(self.error)) from self.error
                try:
                    self.lib = self._bind(ctypes.CDLL(str(
                        build_library(self.src, self.so, _build_flags()))))
                except (OSError, NativeBuildError) as e:
                    self.error = e
                    raise NativeBuildError(str(e)) from e
        return self.lib

    def load(self) -> Optional[ctypes.CDLL]:
        """:meth:`require`, or None when the library cannot be built."""
        try:
            return self.require()
        except NativeBuildError:
            return None

# completion kinds (transport.cpp)
COMP_SEND_DONE = 1
COMP_READ_DONE = 2
COMP_RECV = 3
COMP_CHANNEL_DOWN = 4
COMP_ACCEPT = 5

ST_OK = 0
ST_ERR = 1
ST_REMOTE_ERR = 2

# tpu.shuffle.native.readBackend values -> srt_set_read_backend codes
# (RB_* enum in transport.cpp)
READ_BACKENDS = {"auto": 0, "iouring": 1, "pread": 2, "mapped": 3}


class SrtComp(ctypes.Structure):
    _fields_ = [
        ("kind", ctypes.c_uint32),
        ("status", ctypes.c_uint32),
        ("channel", ctypes.c_uint64),
        ("wr_id", ctypes.c_uint64),
        ("payload", ctypes.c_void_p),
        ("payload_len", ctypes.c_uint64),
        ("aux", ctypes.c_uint32),
        ("_pad", ctypes.c_uint32),
    ]


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.srt_node_create.restype = ctypes.c_void_p
    lib.srt_node_create.argtypes = [ctypes.c_char_p, ctypes.c_uint16, ctypes.c_int]
    lib.srt_node_port.restype = ctypes.c_uint16
    lib.srt_node_port.argtypes = [ctypes.c_void_p]
    lib.srt_reg.restype = ctypes.c_uint32
    lib.srt_reg.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint64]
    lib.srt_reg_file.restype = ctypes.c_uint32
    lib.srt_reg_file.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint64,
        ctypes.c_char_p, ctypes.c_uint64,
        # backing-file identity from the caller's fstat of the
        # mapping fd: dev, ino, size, mtime_ns
        ctypes.c_uint64, ctypes.c_uint64, ctypes.c_uint64,
        ctypes.c_uint64,
    ]
    lib.srt_dereg.restype = ctypes.c_int
    lib.srt_dereg.argtypes = [ctypes.c_void_p, ctypes.c_uint32]
    lib.srt_region_count.restype = ctypes.c_uint64
    lib.srt_region_count.argtypes = [ctypes.c_void_p]
    lib.srt_stat_file_reads.restype = ctypes.c_uint64
    lib.srt_stat_file_reads.argtypes = [ctypes.c_void_p]
    lib.srt_stat_streamed_reads.restype = ctypes.c_uint64
    lib.srt_stat_streamed_reads.argtypes = [ctypes.c_void_p]
    lib.srt_stat_split_parts.restype = ctypes.c_uint64
    lib.srt_stat_split_parts.argtypes = [ctypes.c_void_p]
    lib.srt_stat_block_stripes.restype = ctypes.c_uint64
    lib.srt_stat_block_stripes.argtypes = [ctypes.c_void_p]
    # submission plane: backend knob, availability probe, SQ stats
    lib.srt_set_read_backend.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.srt_uring_compiled.restype = ctypes.c_int
    lib.srt_uring_compiled.argtypes = []
    lib.srt_read_backend_effective.restype = ctypes.c_int
    lib.srt_read_backend_effective.argtypes = [ctypes.c_void_p]
    lib.srt_sq_force_probe_fail.argtypes = [ctypes.c_void_p, ctypes.c_int]
    for _stat in ("submits", "batches", "depth_hwm", "completions",
                  "backend_fallbacks"):
        fn = getattr(lib, f"srt_stat_sq_{_stat}")
        fn.restype = ctypes.c_uint64
        fn.argtypes = [ctypes.c_void_p]
    lib.srt_connect.restype = ctypes.c_uint64
    lib.srt_connect.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint16,
        ctypes.c_uint16, ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
    ]
    lib.srt_post_send.restype = ctypes.c_int
    lib.srt_post_send.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, ctypes.c_void_p,
        ctypes.c_uint64, ctypes.c_uint64, ctypes.c_int,
    ]
    lib.srt_post_read.restype = ctypes.c_int
    lib.srt_post_read.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint64, ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_uint64), ctypes.c_uint32,
    ]
    lib.srt_post_read_mapped.restype = ctypes.c_int
    lib.srt_post_read_mapped.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_uint64), ctypes.c_uint32,
    ]
    lib.srt_unmap.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.srt_set_file_fastpath.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.srt_set_file_workers.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.srt_set_force_sendfile.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.srt_close_channel.restype = ctypes.c_int
    lib.srt_close_channel.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.srt_poll_cq.restype = ctypes.c_int
    lib.srt_poll_cq.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(SrtComp), ctypes.c_int, ctypes.c_int,
    ]
    lib.srt_free_payload.argtypes = [ctypes.c_void_p]
    lib.srt_node_stop.argtypes = [ctypes.c_void_p]
    return lib


LIBRARY = Library(_SRC, BUILD_DIR / _lib_name("libsrt_transport"), _bind)


def require() -> ctypes.CDLL:
    """The transport library, built from the checkout's source if
    needed. Raises :class:`NativeBuildError` (with g++'s stderr) when
    it cannot be built, every time it is asked."""
    return LIBRARY.require()


def load() -> Optional[ctypes.CDLL]:
    """:func:`require`, or None when the library cannot be built."""
    return LIBRARY.load()


def available() -> bool:
    return load() is not None


def toolchain_available() -> bool:
    """True when the native plane is *buildable* here: g++ on PATH or
    a library already built. Distinct from ``available()``, which also
    returns False when the build itself fails: tests gate their skip on
    THIS so a transport.cpp compile breakage fails loudly instead of
    silently skipping. Cheap (no build triggered), so safe to call at
    pytest collection time."""
    return shutil.which("g++") is not None or LIBRARY.so.exists()
