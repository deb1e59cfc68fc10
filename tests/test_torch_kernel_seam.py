"""The kernel seam, ``ops/_build.py``: its table of libraries against the
C declarations of ``ops/csrc/*.cu``, the signatures it binds, and the
launch contract every op goes through (the device guard, the current
stream, the error text, the launch counter, and the call made in the
op's own module). On the CPU, with fake libraries: nothing is built."""

import contextlib
import ctypes
import re
import sys
import types
from pathlib import Path

import pytest
import torch

from sparkrdma_tpu_torch.ops import _build
from sparkrdma_tpu_torch.ops import csr
from sparkrdma_tpu_torch.ops import pallas_attention as tpa
from sparkrdma_tpu_torch.ops import remote_copy as trc
from sparkrdma_tpu_torch.ops import sort as tsort

torch.set_num_threads(1)

C_TYPES = {"void*": ctypes.c_void_p, "const void*": ctypes.c_void_p,
           "long long": ctypes.c_longlong, "int": ctypes.c_int,
           "const char*": ctypes.c_char_p}
DECLARATION = re.compile(
    r"(?:^|[;}\n])\s*(const char\s*\*|long long|int)\s+(srt_\w+)\s*\(([^)]*)\)\s*\{")
SYMBOLS = [(name, symbol) for name, lib in _build.LIBRARIES.items()
           for symbol in lib.symbols]
LAUNCHES = [symbol for name, symbol in SYMBOLS if symbol != "srt_error_string"
            and _build.LIBRARIES[name].symbols[symbol][1] is ctypes.c_int]


def _ctype(decl: str):
    return C_TYPES[re.sub(r"\s*\*", "*", " ".join(decl.split()))]


def _declarations(path: Path):
    """``{symbol: (argtypes, restype)}`` of the ``srt_*`` functions that
    the ``extern "C"`` blocks of ``path`` define."""
    text = re.sub(r"//[^\n]*", "", path.read_text())
    out = {}
    for m in re.finditer(r'extern "C"\s*\{', text):
        depth, i = 1, m.end()
        while depth:
            depth += {"{": 1, "}": -1}.get(text[i], 0)
            i += 1
        for ret, symbol, params in DECLARATION.findall(text[m.end():i - 1]):
            args = [p.strip() for p in params.split(",") if p.strip()]
            argtypes = tuple(_ctype(re.fullmatch(r"(.*?)\s*\w+", a).group(1))
                             for a in args)
            out[symbol] = (argtypes, _ctype(ret))
    return out


def test_every_source_belongs_to_one_library():
    listed = [src for lib in _build.LIBRARIES.values() for src in lib.sources]
    assert sorted(listed) == sorted(p.name for p in _build.CSRC.glob("*.cu"))


@pytest.mark.parametrize("path", sorted(_build.CSRC.glob("*.cu")), ids=lambda p: p.name)
def test_table_matches_the_c_declarations(path):
    """Every ``srt_*`` function a source declares sits, with its C
    signature mapped by kind, in the one entry whose sources include that
    file."""
    declared = _declarations(path)
    assert declared, f"no extern \"C\" srt_* function in {path.name}"
    for symbol, signature in declared.items():
        owners = [name for name, lib in _build.LIBRARIES.items()
                  if symbol in lib.symbols and path.name in lib.sources]
        assert len(owners) == 1, (symbol, owners)
        assert _build.LIBRARIES[owners[0]].symbols[symbol] == signature, symbol


@pytest.mark.parametrize("name", sorted(_build.LIBRARIES))
def test_every_table_symbol_is_declared_in_its_sources(name):
    """An entry lists no function that none of its sources declares."""
    lib = _build.LIBRARIES[name]
    declared = {}
    for src in lib.sources:
        declared.update(_declarations(_build.CSRC / src))
    assert set(lib.symbols) == set(declared)


@pytest.mark.parametrize("name,symbol", SYMBOLS, ids=[s for _, s in SYMBOLS])
def test_binding_sets_the_table_signature(name, symbol):
    """``_bind`` gives each function its table signature. A launch takes
    its pointers as ``c_void_p``, then its sizes as ``c_longlong``, then
    the stream; a variant of an entry point (``_sm90``, ``_tf32x3``)
    takes the entry point's argument list; the table names the library
    that holds each function."""
    lib = _build._bind(types.SimpleNamespace(
        **{s: types.SimpleNamespace() for s in _build.LIBRARIES[name].symbols}), name)
    argtypes, restype = _build.LIBRARIES[name].symbols[symbol]
    fn = getattr(lib, symbol)
    assert (fn.argtypes, fn.restype) == (argtypes, restype)
    if symbol == "srt_error_string":
        assert (argtypes, restype) == ((ctypes.c_int,), ctypes.c_char_p)
        return
    assert _build._LIBRARY_OF[symbol] == name
    if restype is ctypes.c_int:
        kinds = [t is ctypes.c_void_p for t in argtypes[:-1]]
        assert argtypes[-1] is ctypes.c_void_p and kinds == sorted(kinds, reverse=True)
        assert set(argtypes[:-1]) <= {ctypes.c_void_p, ctypes.c_longlong}
    else:  # the helpers beside a kernel: sizes in, a size out
        assert restype is ctypes.c_longlong and set(argtypes) <= {ctypes.c_longlong}
    base = re.sub(r"_(sm90|tf32x3)$", "", symbol)
    if base != symbol:
        assert argtypes == _build.LIBRARIES[name].symbols[base][0]


# ----------------------------------------------------------------------
# the launch contract
# ----------------------------------------------------------------------
class _FakeLib:
    """Every function returns ``rc`` (the scratch and tile helpers 1) and
    records its arguments and the file and function of its caller."""

    def __init__(self, rc=0):
        self.rc = rc
        self.calls = []

    def __getattr__(self, symbol):
        if not symbol.startswith("srt_"):
            raise AttributeError(symbol)

        def fn(*args):
            caller = sys._getframe(1).f_code
            self.calls.append((symbol, args, Path(caller.co_filename).name,
                               caller.co_name))
            return 1 if ("scratch" in symbol or "tile" in symbol) else self.rc

        return fn

    def srt_error_string(self, rc):
        return b"an illegal memory access was encountered"


@pytest.fixture
def cuda(monkeypatch):
    """The real ``_on_device`` over a fake library and a fake CUDA: the
    device guard and the current stream are recorded."""
    state = types.SimpleNamespace(lib=_FakeLib(), loaded=[], guard=[], streams=[])

    @contextlib.contextmanager
    def device(d):
        state.guard.append(("enter", d))
        try:
            yield
        finally:
            state.guard.append(("exit", d))

    def current_stream(d=None):
        state.streams.append(d)
        return types.SimpleNamespace(cuda_stream=4096 + len(state.guard))

    def load(name):
        state.loaded.append(name)
        return state.lib

    monkeypatch.setattr(_build, "_load", load)
    monkeypatch.setattr(torch.cuda, "device", device)
    monkeypatch.setattr(torch.cuda, "current_stream", current_stream)
    _build.reset_launch_counts()
    return state


@pytest.mark.parametrize("symbol", LAUNCHES)
def test_launch_gives_the_current_stream_inside_the_device_guard(cuda, symbol):
    dev = torch.device("cpu")
    with _build.launch(symbol, dev) as k:
        assert cuda.guard == [("enter", dev)] and cuda.streams == [dev]
        assert k.stream == 4097  # the stream current on dev, inside its guard
        k.check(k.fn(11, 22, k.stream))
    assert cuda.guard == [("enter", dev), ("exit", dev)]
    assert cuda.loaded == [_build._LIBRARY_OF[symbol]]
    assert [c[:2] for c in cuda.lib.calls] == [(symbol, (11, 22, 4097))]
    assert _build.launches == {symbol: 1}


def test_nonzero_code_raises_with_the_error_text_and_counts_nothing(cuda):
    cuda.lib.rc = 700
    with pytest.raises(RuntimeError) as err:
        with _build.launch("srt_csr_pull", torch.device("cpu")) as k:
            k.check(k.fn(k.stream))
    assert str(err.value) == ("srt_csr_pull launch failed: an illegal memory "
                              "access was encountered (700)")
    assert cuda.guard[-1][0] == "exit" and sum(_build.launches.values()) == 0


def test_zero_code_counts_one_under_the_symbol_until_reset(cuda):
    for symbol in ("srt_radix_pack", "srt_radix_pack", "srt_flash_attn_fwd_sm90"):
        with _build.launch(symbol, torch.device("cpu")) as k:
            k.check(k.fn(k.stream))
    assert _build.launches == {"srt_radix_pack": 2, "srt_flash_attn_fwd_sm90": 1}
    assert _build.launches["srt_flash_attn_fwd"] == 0  # one count a function, no family
    counter = _build.launches
    _build.reset_launch_counts()
    assert _build.launches is counter and not counter


def _ops():
    def packed():
        p = torch.full((1, 1, 4, 2), -1, dtype=torch.int32)
        p[0, 0, :2] = torch.tensor([[0, 1], [1, 0]], dtype=torch.int32)
        return p

    q = torch.zeros((1, 8, 1, 20))
    return {
        "srt_wave_pull": ("remote_copy.py", lambda: trc.wave_pull(
            [torch.arange(4, dtype=torch.int32)], [0], [16], 2, 4, torch.int32)),
        "srt_pipelined_wave_pull": ("remote_copy.py", lambda: trc.pipelined_wave_pull(
            [torch.arange(4, dtype=torch.int32)], [0], [16], 2, 4, torch.int32, 2)),
        "srt_neighbor_pull": ("remote_copy.py", lambda: trc.ppermute(
            torch.zeros((4, 3)), [(i, (i + 1) % 4) for i in range(4)])),
        "srt_flash_attn_fwd": ("pallas_attention.py",
                               lambda: tpa.flash_attention_fwd(q, q, q)),
        "srt_flash_attn_bwd_dkv": ("pallas_attention.py", lambda: tpa.flash_attention_bwd(
            q, q, q, q, torch.zeros((1, 1, 8)), q)),
        "srt_radix_pack": ("sort.py", lambda: tsort.radix_pack_pairs(
            torch.zeros((1, 16), dtype=torch.uint32), torch.zeros((1, 16), dtype=torch.int32),
            4, 8)),
        "srt_radix_pack64": ("sort.py", lambda: tsort.radix_pack_pairs(
            torch.zeros((1, 16), dtype=torch.uint64), torch.zeros((1, 16), dtype=torch.int64),
            4, 8, 64)),
        "srt_merge_runs": ("sort.py", lambda: tsort.merge_sorted_runs(
            torch.zeros((2, 2, 8), dtype=torch.uint32), torch.zeros((2, 2), dtype=torch.int32),
            0xFFFFFFFF)),
        "srt_sorted_probe": ("sort.py", lambda: tsort.probe_sorted(
            torch.zeros((2, 16), dtype=torch.uint32), torch.zeros((2, 16), dtype=torch.int32),
            torch.zeros((2, 2), dtype=torch.int32), torch.zeros((2, 2, 4), dtype=torch.uint32),
            torch.zeros((2, 2), dtype=torch.int32), -1)),
        "srt_sorted_probe64": ("sort.py", lambda: tsort.probe_sorted(
            torch.zeros((2, 16), dtype=torch.uint64), torch.zeros((2, 16), dtype=torch.int64),
            torch.zeros((2, 2), dtype=torch.int32), torch.zeros((2, 2, 4), dtype=torch.uint64),
            torch.zeros((2, 2), dtype=torch.int32), -1)),
        "srt_csr_build": ("csr.py", lambda: csr.csr_build(packed(), 2)),
        "srt_csr_pull": ("csr.py", lambda: csr.csr_pull(
            torch.zeros(2), csr.csr_build(packed(), 2))),
    }


@pytest.mark.parametrize("symbol", sorted(_ops()))
def test_the_kernel_call_is_made_in_the_op_module(cuda, monkeypatch, symbol):
    """The ctypes call runs in a function of the op's own module, not in
    ``_build.py``: the profiler gives a kernel's device time to the
    innermost package frame open at its launch."""
    for mod, path in ((trc, "_kernel_path"), (trc, "_wave_kernel_path"),
                      (tpa, "_kernel_path"), (tsort, "_pack_kernel_path"),
                      (tsort, "_merge_kernel_path"), (tsort, "_probe_kernel_path"),
                      (csr, "_kernel_path")):
        monkeypatch.setattr(mod, path, lambda t: True)
    module, run = _ops()[symbol]
    run()
    (caller,) = [(f, fn) for s, _, f, fn in cuda.lib.calls if s == symbol]
    assert caller[0] == module and caller[1].startswith("_launch"), caller
    assert _build.launches[symbol] == 1
