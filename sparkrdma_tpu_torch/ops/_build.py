"""Build and bind the package's own CUDA kernels.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` for ``sm_90a``
(all started together; ``csrc/*.cuh`` are their shared headers), and
the objects are linked into one shared library with a plain C
interface, loaded with ``ctypes``. Nothing links ``-lcuda``: the one
driver function a kernel needs (``cuTensorMapEncodeTiled``, for the
tensor-core kernels' TMA maps, ``flash_attn_sm90_common.cuh``) is
reached through the runtime's ``cudaGetDriverEntryPoint``. The library goes to
``build/torch_kernels/libsrt_torch_kernels.so`` under the checkout
root, beside a stamp holding the hash of the sources and headers it was
built from; it is rebuilt at first use whenever they change. Nothing is
built at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional

from sparkrdma_tpu_torch.utils.torch_compat import find_nvcc

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
LIB_NAME = "libsrt_torch_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# what the last build in this process took and printed (None: loaded a
# library already built from the same sources)
build_seconds: Optional[float] = None
build_log: str = ""


def _sources():
    return sorted(CSRC.glob("*.cu"))


def sources_hash() -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cu*")):  # the .cu sources and their headers
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()


def _run(cmd) -> str:
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}"
        )
    return proc.stdout + proc.stderr


def _build(out: Path, digest: str) -> None:
    global build_seconds, build_log
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found on PATH, in $CUDA_HOME/bin or in "
            "/usr/local/cuda/bin: the CUDA kernels cannot be built"
        )
    out.parent.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    srcs = _sources()
    objs = [out.with_name(f"{src.stem}.{tag}.o") for src in srcs]
    tmp = out.with_name(f"{out.name}.{tag}")
    t0 = time.perf_counter()
    try:
        # one nvcc per source, all running at once; then one link
        with ThreadPoolExecutor(max_workers=len(srcs)) as pool:
            logs = list(pool.map(
                lambda so: _run([nvcc, *NVCC_FLAGS, "-c", "-o", str(so[1]),
                                 str(so[0])]),
                zip(srcs, objs),
            ))
        logs.append(_run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                          "-shared", "-o", str(tmp), *map(str, objs)]))
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    build_seconds = time.perf_counter() - t0
    build_log = "".join(logs)
    os.replace(tmp, out)
    out.with_name(out.name + ".sha256").write_text(digest)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    vp, ll = ctypes.c_void_p, ctypes.c_longlong
    lib.srt_wave_pull.argtypes = [vp, vp, ll, ll, vp]
    lib.srt_wave_pull.restype = ctypes.c_int
    lib.srt_pipelined_wave_pull.argtypes = [vp, vp, ll, ll, ll, vp]
    lib.srt_pipelined_wave_pull.restype = ctypes.c_int
    lib.srt_neighbor_pull.argtypes = [vp, ll, ll, vp]
    lib.srt_neighbor_pull.restype = ctypes.c_int
    lib.srt_flash_attn_fwd.argtypes = [vp, vp, vp, vp, vp,
                                       ll, ll, ll, ll, ll, ll, vp]
    lib.srt_flash_attn_fwd.restype = ctypes.c_int
    lib.srt_flash_attn_fwd_sm90.argtypes = [vp] * 5 + [ll] * 6 + [vp]
    lib.srt_flash_attn_fwd_sm90.restype = ctypes.c_int
    lib.srt_flash_attn_bwd_dq.argtypes = [vp] * 7 + [ll] * 6 + [vp]
    lib.srt_flash_attn_bwd_dq.restype = ctypes.c_int
    lib.srt_flash_attn_bwd_dkv.argtypes = [vp] * 8 + [ll] * 6 + [vp]
    lib.srt_flash_attn_bwd_dkv.restype = ctypes.c_int
    lib.srt_flash_attn_bwd_dq_sm90.argtypes = [vp] * 7 + [ll] * 6 + [vp]
    lib.srt_flash_attn_bwd_dq_sm90.restype = ctypes.c_int
    lib.srt_flash_attn_bwd_dkv_sm90.argtypes = [vp] * 8 + [ll] * 6 + [vp]
    lib.srt_flash_attn_bwd_dkv_sm90.restype = ctypes.c_int
    lib.srt_error_string.argtypes = [ctypes.c_int]
    lib.srt_error_string.restype = ctypes.c_char_p
    return lib


def load() -> ctypes.CDLL:
    """The kernel library, built from the checkout's sources if the
    library on disk is missing or was built from other sources."""
    global _lib
    with _lock:
        if _lib is None:
            out = BUILD_DIR / LIB_NAME
            stamp = out.with_name(out.name + ".sha256")
            digest = sources_hash()
            if not (out.exists() and stamp.exists()
                    and stamp.read_text() == digest):
                _build(out, digest)
            _lib = _bind(ctypes.CDLL(str(out)))
        return _lib
