"""wire-markers pass — extension markers/structs agree across codec.

The trailing-extension scheme in ``rpc.py`` (checksum 0xFFFF, device
0xFFFE, merged 0xFFFD, elastic 0xFFFC) stays legacy-compatible only
while a set of hand-maintained invariants hold. This pass re-derives
them from the AST of any class that declares ``_<X>_MARKER``
attributes:

- markers are integer literals, pairwise distinct, and >= 0xFF00 (the
  disambiguation against host-count words relies on markers being
  impossible as real list lengths),
- every marker ``X`` has companion ``_<X>_HDR`` and ``_<X>_ITEM``
  ``struct.Struct`` attributes, and all extension headers share one
  format (the parser peeks a single fixed-size header to dispatch),
- each of ``_<X>_MARKER`` / ``_<X>_HDR`` / ``_<X>_ITEM`` is referenced
  in BOTH the encoder (``to_segments``/``to_bytes``) and the parser
  (``from_payload``/``from_bytes``) — an extension wired into one side
  only is a silent wire break,
- a ``_TRACE_EXT`` trailer, when present, must pack strictly fewer
  bytes than the minimum serialized PartitionLocation (28): the parser
  tells "trailing trace ext" from "one more location" by size alone,
- FULL ORDERING: every marker must be dispatched from ONE ``while``
  peek loop in the parser, each marker branch must end in ``continue``
  (re-peek — extensions decode in any on-wire order, including orders
  an older encoder never emits), and when a ``_TRACE_EXT`` trailer
  exists the loop guard must reference it so the trace tail survives
  any number of preceding extensions.

Any ``struct.Struct`` class attribute in ``rpc.py``/``locations.py``
that is used by an encoder method but not a parser method (or vice
versa) is likewise reported.
"""

from __future__ import annotations

import ast
import re
import struct
from pathlib import Path
from typing import Dict, Iterable, List, Optional

from sparkrdma_tpu_torch.analysis import Finding, SourceFile

PASS_ID = "wire-markers"

_MARKER_RE = re.compile(r"^_([A-Z0-9]+)_MARKER$")
_ENCODERS = ("to_segments", "to_bytes")
_PARSERS = ("from_payload", "from_bytes")
#: minimum serialized PartitionLocation: 16-byte block triple + the
#: shortest ShuffleManagerId (two >H-prefixed strings + >i port = 12)
MIN_LOCATION_BYTES = 28


def _struct_fmt(node: ast.AST) -> Optional[str]:
    """The format literal if node is ``struct.Struct("<fmt>")``."""
    if (
        isinstance(node, ast.Call)
        and isinstance(node.func, ast.Attribute)
        and node.func.attr == "Struct"
        and node.args
        and isinstance(node.args[0], ast.Constant)
        and isinstance(node.args[0].value, str)
    ):
        return node.args[0].value
    return None


def _names_used(fn: ast.AST) -> set:
    used = set()
    for n in ast.walk(fn):
        if isinstance(n, ast.Attribute):
            used.add(n.attr)
        elif isinstance(n, ast.Name):
            used.add(n.id)
    return used


def _ordering_findings(
    sf: SourceFile,
    markers: Dict[str, ast.Assign],
    structs: Dict[str, str],
    parsers: List[ast.FunctionDef],
) -> List[Finding]:
    """The any-order invariant: one peek loop dispatches every marker,
    every marker branch re-peeks via ``continue``, and the loop guard
    keeps the trace trailer reachable."""
    findings: List[Finding] = []
    marker_attrs = {f"_{x}_MARKER": x for x in markers}
    whiles = [
        n for p in parsers for n in ast.walk(p) if isinstance(n, ast.While)
    ]
    loop = None
    for w in whiles:
        if set(marker_attrs) <= _names_used(w):
            loop = w
            break
    if loop is None:
        for x, stmt in sorted(markers.items()):
            findings.append(
                Finding(
                    PASS_ID, sf.path, stmt.lineno,
                    f"no single parser peek loop dispatches _{x}_MARKER "
                    "alongside the other markers — extension parse order "
                    "is fixed, not any-order",
                )
            )
        return findings
    for node in ast.walk(loop):
        if not isinstance(node, ast.If):
            continue
        hit = sorted(_names_used(node.test) & set(marker_attrs))
        if not hit or not node.body:
            continue
        if not isinstance(node.body[-1], ast.Continue):
            findings.append(
                Finding(
                    PASS_ID, sf.path, node.lineno,
                    f"marker branch for {'/'.join(hit)} does not end in "
                    "'continue' — the loop stops re-peeking and any "
                    "extension after it parses order-dependently",
                )
            )
    if "_TRACE_EXT" in structs and "_TRACE_EXT" not in _names_used(loop.test):
        findings.append(
            Finding(
                PASS_ID, sf.path, loop.lineno,
                "the marker peek loop's guard does not reserve "
                "_TRACE_EXT's tail — a trace trailer after N extensions "
                "would be consumed as a truncated extension header",
            )
        )
    return findings


def _check_class(sf: SourceFile, cls: ast.ClassDef) -> List[Finding]:
    findings: List[Finding] = []
    markers: Dict[str, ast.Assign] = {}
    structs: Dict[str, str] = {}  # attr name -> format
    struct_lines: Dict[str, int] = {}
    for stmt in cls.body:
        if not (isinstance(stmt, ast.Assign) and len(stmt.targets) == 1):
            continue
        tgt = stmt.targets[0]
        if not isinstance(tgt, ast.Name):
            continue
        m = _MARKER_RE.match(tgt.id)
        if m:
            markers[m.group(1)] = stmt
        fmt = _struct_fmt(stmt.value)
        if fmt is not None:
            structs[tgt.id] = fmt
            struct_lines[tgt.id] = stmt.lineno

    methods = {
        n.name: n for n in cls.body if isinstance(n, ast.FunctionDef)
    }
    encoders = [methods[n] for n in _ENCODERS if n in methods]
    parsers = [methods[n] for n in _PARSERS if n in methods]
    enc_used = set().union(*(_names_used(f) for f in encoders)) if encoders else set()
    par_used = set().union(*(_names_used(f) for f in parsers)) if parsers else set()

    if markers:
        values: Dict[str, int] = {}
        for x, stmt in markers.items():
            v = stmt.value
            if not (isinstance(v, ast.Constant) and isinstance(v.value, int)):
                findings.append(
                    Finding(
                        PASS_ID, sf.path, stmt.lineno,
                        f"_{x}_MARKER must be an integer literal",
                    )
                )
                continue
            values[x] = v.value
            if v.value < 0xFF00:
                findings.append(
                    Finding(
                        PASS_ID, sf.path, stmt.lineno,
                        f"_{x}_MARKER 0x{v.value:X} < 0xFF00 — collides "
                        "with plausible host-count words",
                    )
                )
        if len(set(values.values())) != len(values):
            findings.append(
                Finding(
                    PASS_ID, sf.path, cls.lineno,
                    f"duplicate extension marker values in {cls.name}: "
                    f"{values}",
                )
            )
        hdr_fmts = set()
        shared_hdr = "_EXT_HDR" in structs
        if shared_hdr:
            hdr_fmts.add(structs["_EXT_HDR"])
        for x, stmt in markers.items():
            if f"_{x}_HDR" in structs:
                hdr_fmts.add(structs[f"_{x}_HDR"])
            elif not shared_hdr:
                findings.append(
                    Finding(
                        PASS_ID, sf.path, stmt.lineno,
                        f"marker _{x}_MARKER has neither a _{x}_HDR "
                        "companion nor a shared _EXT_HDR struct",
                    )
                )
            if f"_{x}_ITEM" not in structs:
                findings.append(
                    Finding(
                        PASS_ID, sf.path, stmt.lineno,
                        f"marker _{x}_MARKER has no companion "
                        f"_{x}_ITEM struct",
                    )
                )
            candidates = [f"_{x}_MARKER"]
            if f"_{x}_ITEM" in structs:
                candidates.append(f"_{x}_ITEM")
            for attr in candidates:
                if encoders and attr not in enc_used:
                    findings.append(
                        Finding(
                            PASS_ID, sf.path, stmt.lineno,
                            f"{attr} is not referenced by the encoder "
                            f"({'/'.join(_ENCODERS)}) — one-sided "
                            "extension wiring",
                        )
                    )
                if parsers and attr not in par_used:
                    findings.append(
                        Finding(
                            PASS_ID, sf.path, stmt.lineno,
                            f"{attr} is not referenced by the parser "
                            f"({'/'.join(_PARSERS)}) — one-sided "
                            "extension wiring",
                        )
                    )
        if len(hdr_fmts) > 1:
            findings.append(
                Finding(
                    PASS_ID, sf.path, cls.lineno,
                    f"extension header formats differ ({sorted(hdr_fmts)}) — "
                    "the parser dispatches on ONE peeked header shape",
                )
            )
        if parsers:
            findings.extend(
                _ordering_findings(sf, markers, structs, parsers)
            )

    if "_TRACE_EXT" in structs:
        try:
            size = struct.calcsize(structs["_TRACE_EXT"])
        except struct.error:
            size = None
        if size is not None and size >= MIN_LOCATION_BYTES:
            findings.append(
                Finding(
                    PASS_ID, sf.path, struct_lines["_TRACE_EXT"],
                    f"_TRACE_EXT packs {size} bytes >= minimum location "
                    f"size {MIN_LOCATION_BYTES}; the tail would parse as "
                    "a location",
                )
            )

    # generic: any codec struct used on one side only
    if encoders and parsers:
        for attr, fmt in structs.items():
            in_enc, in_par = attr in enc_used, attr in par_used
            if in_enc != in_par:
                side = "parser" if in_enc else "encoder"
                findings.append(
                    Finding(
                        PASS_ID, sf.path, struct_lines[attr],
                        f"struct {attr} ({fmt!r}) is never referenced by "
                        f"the {side} side of {cls.name}",
                    )
                )
    return findings


def run(files: Iterable[SourceFile], root: Path) -> List[Finding]:
    findings: List[Finding] = []
    for sf in files:
        if not (
            sf.path.endswith("rpc.py") or sf.path.endswith("locations.py")
        ):
            continue
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.ClassDef):
                findings.extend(_check_class(sf, node))
    return findings
