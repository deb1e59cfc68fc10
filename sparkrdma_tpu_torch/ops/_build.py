"""Build, bind and launch the package's own CUDA kernels: the one seam
between an op and a hand-written kernel.

:data:`LIBRARIES` declares each shared library: its file, its sources
under ``csrc/`` by name, and every C function it exports with its ctypes
``(argtypes, restype)``. Each source is compiled by its own ``nvcc`` for
``sm_90a`` (all started together; ``csrc/*.cuh`` are their shared
headers), and the objects are linked into the library, which has a
plain C interface and is loaded with ``ctypes``. The hash join's pack
and probe, the sort's merge and PageRank's CSR kernels are libraries of
their own, so that a path that needs only them builds one file, in
seconds, and not every attention kernel. Nothing links ``-lcuda``: the one driver function a
kernel needs (``cuTensorMapEncodeTiled``, for the tensor-core kernels'
TMA maps, ``flash_attn_sm90_common.cuh``) is reached through the
runtime's ``cudaGetDriverEntryPoint``. Each library goes to
``build/torch_kernels/`` under the checkout root, beside a stamp holding
the hash of the sources and headers it was built from; :func:`_load`
rebuilds it at first use whenever they change. Nothing is built at
import time.

An op launches a kernel through :func:`launch`, which names the C
function; the table says which library holds it::

    with _build.launch("srt_csr_pull", dev) as k:
        k.check(k.fn(outc.data_ptr(), ..., k.stream))

Inside the block the device is current, ``k.fn`` is the bound function
and ``k.stream`` the device's current stream. ``k.check`` takes back the
return code: a nonzero one raises ``RuntimeError`` with the library's
``srt_error_string``, a zero one adds one to :data:`launches` under the
function's name. The call itself stays in the op's own function: the
profiler gives a kernel's device time to the innermost package frame
open at its launch (``shufflebench/trace.py``), so a helper here that
made the call would take that time from the op.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import hashlib
import os
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Iterator, List, NamedTuple, Tuple

import torch

from sparkrdma_tpu_torch.utils.torch_compat import find_nvcc

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_vp, _ll, _int = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
# (argtypes, restype): pointers, then sizes, then the stream
_FWD = ((_vp,) * 5 + (_ll,) * 6 + (_vp,), _int)  # q k v out lse
_BWD_DQ = ((_vp,) * 7 + (_ll,) * 6 + (_vp,), _int)  # q k v do lse delta dq
_BWD_DKV = ((_vp,) * 8 + (_ll,) * 6 + (_vp,), _int)  # ... dk dv
_PACK = ((_vp,) * 7 + (_ll,) * 7 + (_vp,), _int)  # keys vals kslab vslab counts flags scratch
# bkeys bvals bcnt pkeys pcnt joined stats scratch; e m cap_p miss
_PROBE = ((_vp,) * 8 + (_ll,) * 4 + (_vp,), _int)
_ERROR_STRING = ((_int,), ctypes.c_char_p)


class Library(NamedTuple):
    sources: Tuple[str, ...]  # under csrc/; the stamp also hashes csrc/*.cuh
    symbols: Dict[str, Tuple[tuple, type]]  # C function -> (argtypes, restype)


LIB_NAME = "libsrt_torch_kernels.so"
LIBRARIES: Dict[str, Library] = {
    LIB_NAME: Library(
        ("flash_attn_bwd.cu", "flash_attn_bwd_sm90.cu", "flash_attn_bwd_tf32x3.cu",
         "flash_attn_fwd.cu", "flash_attn_fwd_sm90.cu", "flash_attn_fwd_tf32x3.cu",
         "neighbor_pull.cu", "wave_pull.cu"),
        {"srt_wave_pull": ((_vp, _vp, _ll, _ll, _vp), _int),
         "srt_pipelined_wave_pull": ((_vp, _vp, _ll, _ll, _ll, _vp), _int),
         "srt_neighbor_pull": ((_vp, _ll, _ll, _vp), _int),
         "srt_flash_attn_fwd": _FWD,
         "srt_flash_attn_fwd_sm90": _FWD,
         "srt_flash_attn_fwd_tf32x3": _FWD,
         "srt_flash_attn_bwd_dq": _BWD_DQ,
         "srt_flash_attn_bwd_dq_sm90": _BWD_DQ,
         "srt_flash_attn_bwd_dq_tf32x3": _BWD_DQ,
         "srt_flash_attn_bwd_dkv": _BWD_DKV,
         "srt_flash_attn_bwd_dkv_sm90": _BWD_DKV,
         "srt_flash_attn_bwd_dkv_tf32x3": _BWD_DKV,
         "srt_error_string": _ERROR_STRING}),
    "libsrt_radix_pack.so": Library(
        ("radix_pack.cu",),
        {"srt_radix_pack": _PACK,
         "srt_radix_pack64": _PACK,
         "srt_radix_pack_scratch": ((_ll,) * 3, _ll),
         "srt_error_string": _ERROR_STRING}),
    "libsrt_merge_runs.so": Library(
        ("merge_runs.cu",),
        {"srt_merge_runs": ((_vp,) * 5 + (_ll,) * 4 + (_vp,), _int),
         "srt_merge_runs_scratch": ((_ll,) * 3, _ll),
         "srt_error_string": _ERROR_STRING}),
    "libsrt_csr_pull.so": Library(
        ("csr_pull.cu",),
        {"srt_csr_tile_steps": ((), _ll),
         "srt_csr_scratch_bytes": ((_ll,) * 4, _ll),
         "srt_csr_build": ((_vp,) * 5 + (_ll,) * 5 + (_vp,), _int),
         "srt_csr_pull": ((_vp,) * 6 + (_ll,) * 3 + (_vp,), _int),
         "srt_error_string": _ERROR_STRING}),
    "libsrt_sorted_probe.so": Library(
        ("sorted_probe.cu",),
        {"srt_sorted_probe": _PROBE,
         "srt_sorted_probe64": _PROBE,
         "srt_sorted_probe_scratch": ((_ll,) * 2, _ll),
         "srt_error_string": _ERROR_STRING}),
}
# C function -> the library that holds it (each holds its own srt_error_string)
_LIBRARY_OF = {symbol: name for name, lib in LIBRARIES.items()
               for symbol in lib.symbols if symbol != "srt_error_string"}

# successful launches by C function, since the last reset_launch_counts()
launches: "collections.Counter[str]" = collections.Counter()

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# library name -> what its build in this process took and printed (none:
# loaded a library already built from the same sources)
builds: Dict[str, Tuple[float, str]] = {}


def reset_launch_counts() -> None:
    launches.clear()


def _sources(name: str) -> List[Path]:
    return [CSRC / src for src in LIBRARIES[name].sources]


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


def _bind(lib, name: str):
    """Set every function of library ``name`` to its table signature."""
    for symbol, (argtypes, restype) in LIBRARIES[name].symbols.items():
        fn = getattr(lib, symbol)
        fn.argtypes, fn.restype = argtypes, restype
    return lib


def _load(name: str) -> ctypes.CDLL:
    """Library ``name`` of :data:`LIBRARIES`, bound; built from the
    checkout's sources if the library on disk is missing or was built
    from other sources."""
    with _lock:
        if name not in _libs:
            out = BUILD_DIR / name
            stamp = out.with_name(out.name + ".sha256")
            digest = sources_hash(name)
            if not (out.exists() and stamp.exists()
                    and stamp.read_text() == digest):
                builds[name] = _build(out, digest)
            _libs[name] = _bind(ctypes.CDLL(str(out)), name)
        return _libs[name]


class Launch:
    """A launch site's handle: ``fn``, the bound C function ``symbol``;
    ``stream``, the device's current stream; ``lib``, its library, for
    the helper functions beside the kernel (scratch sizes)."""

    __slots__ = ("symbol", "lib", "fn", "stream")

    def __init__(self, symbol: str, lib, stream: int):
        self.symbol, self.lib, self.stream = symbol, lib, stream
        self.fn = getattr(lib, symbol)

    def check(self, rc: int) -> None:
        """Raise on a nonzero return code; count a zero one."""
        if rc != 0:
            raise RuntimeError(f"{self.symbol} launch failed: "
                               f"{self.lib.srt_error_string(rc).decode()} ({rc})")
        launches[self.symbol] += 1


@contextlib.contextmanager
def _on_device(symbol: str, device) -> Iterator[Tuple[ctypes.CDLL, int]]:
    """``symbol``'s library and ``device``'s current stream, with the
    device current: all that a launch takes from CUDA, and the one point
    a test's fake library replaces."""
    lib = _load(_LIBRARY_OF[symbol])
    with torch.cuda.device(device):
        yield lib, torch.cuda.current_stream(device).cuda_stream


@contextlib.contextmanager
def launch(symbol: str, device) -> Iterator[Launch]:
    """The :class:`Launch` of C function ``symbol`` on ``device``."""
    with _on_device(symbol, device) as (lib, stream):
        yield Launch(symbol, lib, stream)
