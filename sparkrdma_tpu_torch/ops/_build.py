"""Build and bind the package's own CUDA kernels.

Every ``csrc/*.cu`` file but those of :data:`OWN_LIBRARIES` is compiled
by its own ``nvcc`` for ``sm_90a`` (all started together; ``csrc/*.cuh``
are their shared headers), and the objects are linked into one shared
library with a plain C interface, loaded with ``ctypes``. A library of
:data:`OWN_LIBRARIES` is built from its own sources alone, beside the
main one with a stamp of its own, so that a path that needs only it
(the hash join's pack: :func:`load_radix_pack`) builds one file, in
seconds, and not every attention kernel; PageRank's CSR pull,
:func:`load_csr_pull`, likewise. Nothing links ``-lcuda``: the one
driver function a kernel needs (``cuTensorMapEncodeTiled``, for the
tensor-core kernels' TMA maps, ``flash_attn_sm90_common.cuh``) is
reached through the runtime's ``cudaGetDriverEntryPoint``. Each library
goes to ``build/torch_kernels/`` under the checkout root
(``libsrt_torch_kernels.so``, ``libsrt_radix_pack.so``,
``libsrt_csr_pull.so``), beside a stamp
holding the hash of the sources and headers it was built from; it is
rebuilt at first use whenever they change. Nothing is built at import
time.
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
from typing import Callable, Dict, List, Tuple

from sparkrdma_tpu_torch.utils.torch_compat import find_nvcc

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
LIB_NAME = "libsrt_torch_kernels.so"
# library name -> its sources under csrc/, which the main library leaves out
OWN_LIBRARIES = {"libsrt_radix_pack.so": ("radix_pack.cu",),
                 "libsrt_csr_pull.so": ("csr_pull.cu",)}
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# library name -> what its build in this process took and printed (none:
# loaded a library already built from the same sources)
builds: Dict[str, Tuple[float, str]] = {}


def _sources(name: str = LIB_NAME) -> List[Path]:
    if name in OWN_LIBRARIES:
        return [CSRC / src for src in OWN_LIBRARIES[name]]
    own = {src for srcs in OWN_LIBRARIES.values() for src in srcs}
    return sorted(p for p in CSRC.glob("*.cu") if p.name not in own)


def sources_hash(name: str = LIB_NAME) -> str:
    """The hash of a library's sources, the headers (``csrc/*.cuh``)
    and the flags."""
    h = hashlib.sha256()
    for p in sorted(_sources(name) + list(CSRC.glob("*.cuh"))):
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


def _build(out: Path, digest: str) -> Tuple[float, str]:
    """Compile ``out``'s sources, link, write the stamp; returns the
    seconds and the compiler's output."""
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found on PATH, in $CUDA_HOME/bin or in "
            "/usr/local/cuda/bin: the CUDA kernels cannot be built"
        )
    out.parent.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    srcs = _sources(out.name)
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
    seconds = time.perf_counter() - t0
    os.replace(tmp, out)
    out.with_name(out.name + ".sha256").write_text(digest)
    return seconds, "".join(logs)


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
    lib.srt_flash_attn_fwd_tf32x3.argtypes = [vp] * 5 + [ll] * 6 + [vp]
    lib.srt_flash_attn_fwd_tf32x3.restype = ctypes.c_int
    lib.srt_flash_attn_bwd_dq.argtypes = [vp] * 7 + [ll] * 6 + [vp]
    lib.srt_flash_attn_bwd_dq.restype = ctypes.c_int
    lib.srt_flash_attn_bwd_dkv.argtypes = [vp] * 8 + [ll] * 6 + [vp]
    lib.srt_flash_attn_bwd_dkv.restype = ctypes.c_int
    lib.srt_flash_attn_bwd_dq_sm90.argtypes = [vp] * 7 + [ll] * 6 + [vp]
    lib.srt_flash_attn_bwd_dq_sm90.restype = ctypes.c_int
    lib.srt_flash_attn_bwd_dkv_sm90.argtypes = [vp] * 8 + [ll] * 6 + [vp]
    lib.srt_flash_attn_bwd_dkv_sm90.restype = ctypes.c_int
    lib.srt_flash_attn_bwd_dq_tf32x3.argtypes = [vp] * 7 + [ll] * 6 + [vp]
    lib.srt_flash_attn_bwd_dq_tf32x3.restype = ctypes.c_int
    lib.srt_flash_attn_bwd_dkv_tf32x3.argtypes = [vp] * 8 + [ll] * 6 + [vp]
    lib.srt_flash_attn_bwd_dkv_tf32x3.restype = ctypes.c_int
    lib.srt_error_string.argtypes = [ctypes.c_int]
    lib.srt_error_string.restype = ctypes.c_char_p
    return lib


def _bind_radix_pack(lib: ctypes.CDLL) -> ctypes.CDLL:
    vp, ll = ctypes.c_void_p, ctypes.c_longlong
    lib.srt_radix_pack.argtypes = [vp] * 7 + [ll] * 7 + [vp]
    lib.srt_radix_pack.restype = ctypes.c_int
    lib.srt_radix_pack_scratch.argtypes = [ll, ll, ll]
    lib.srt_radix_pack_scratch.restype = ll
    lib.srt_error_string.argtypes = [ctypes.c_int]
    lib.srt_error_string.restype = ctypes.c_char_p
    return lib


def _bind_csr_pull(lib: ctypes.CDLL) -> ctypes.CDLL:
    vp, ll = ctypes.c_void_p, ctypes.c_longlong
    lib.srt_csr_tile_steps.argtypes = []
    lib.srt_csr_tile_steps.restype = ll
    lib.srt_csr_scratch_bytes.argtypes = [ll] * 4
    lib.srt_csr_scratch_bytes.restype = ll
    lib.srt_csr_build.argtypes = [vp] * 5 + [ll] * 5 + [vp]
    lib.srt_csr_build.restype = ctypes.c_int
    lib.srt_csr_pull.argtypes = [vp] * 6 + [ll] * 3 + [vp]
    lib.srt_csr_pull.restype = ctypes.c_int
    lib.srt_error_string.argtypes = [ctypes.c_int]
    lib.srt_error_string.restype = ctypes.c_char_p
    return lib


def _load(name: str, bind: Callable[[ctypes.CDLL], ctypes.CDLL]) -> ctypes.CDLL:
    """Library ``name``, built from the checkout's sources if the library
    on disk is missing or was built from other sources."""
    with _lock:
        if name not in _libs:
            out = BUILD_DIR / name
            stamp = out.with_name(out.name + ".sha256")
            digest = sources_hash(name)
            if not (out.exists() and stamp.exists()
                    and stamp.read_text() == digest):
                builds[name] = _build(out, digest)
            _libs[name] = bind(ctypes.CDLL(str(out)))
        return _libs[name]


def load() -> ctypes.CDLL:
    """The main kernel library (every kernel but the own libraries')."""
    return _load(LIB_NAME, _bind)


def load_radix_pack() -> ctypes.CDLL:
    """The hash join's pack, ``srt_radix_pack`` (``csrc/radix_pack.cu``),
    a library of its own."""
    return _load("libsrt_radix_pack.so", _bind_radix_pack)


def load_csr_pull() -> ctypes.CDLL:
    """PageRank's CSR build and pull, ``srt_csr_build`` and
    ``srt_csr_pull`` (``csrc/csr_pull.cu``), a library of its own."""
    return _load("libsrt_csr_pull.so", _bind_csr_pull)
