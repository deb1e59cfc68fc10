"""knob-registry pass — every ``tpu.shuffle.*`` read must be declared.

Candidates are collected from three shapes:

- plain string literals starting with the prefix (tests, benches,
  example configs),
- ``PREFIX + "suffix"`` concatenations (the idiom inside
  ``utils/config.py`` raw reads and the quota per-tenant scan),
- the first argument of ``self._int/_float/_bytes/_bool`` calls inside
  ``utils/config.py`` (the clamped typed getters take bare suffixes).

Each candidate must resolve against ``DECLARED_KNOBS`` /
``PATTERN_KNOBS`` in :mod:`sparkrdma_tpu_torch.utils.config`: exactly, via a
pattern (``<seg>`` matches one dot-free segment), or — when the
candidate ends with ``.`` — as a namespace scan prefix of at least one
declared knob. The inverse is checked too: a declared knob that no
file references is dead weight and is reported.
"""

from __future__ import annotations

import ast
import re
from pathlib import Path
from typing import Dict, Iterable, List, Tuple

from sparkrdma_tpu_torch.analysis import Finding, SourceFile

PASS_ID = "knob-registry"

_GETTERS = {"_int", "_float", "_bytes", "_bool"}


def _pattern_regexes() -> List[re.Pattern]:
    from sparkrdma_tpu_torch.utils.config import PATTERN_KNOBS

    out = []
    for pat in PATTERN_KNOBS:
        out.append(
            re.compile(
                "^"
                + re.escape(pat).replace(re.escape("<seg>"), r"[^.]+")
                + "$"
            )
        )
    return out


def _collect(sf: SourceFile, prefix: str) -> List[Tuple[int, str]]:
    """(line, full-key-or-suffix-candidate) pairs found in one file."""
    found: List[Tuple[int, str]] = []
    in_config = sf.path.endswith("utils/config.py")
    for node in ast.walk(sf.tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            if node.value.startswith(prefix):
                found.append((node.lineno, node.value))
        elif (
            isinstance(node, ast.BinOp)
            and isinstance(node.op, ast.Add)
            and isinstance(node.left, ast.Name)
            and node.left.id == "PREFIX"
            and isinstance(node.right, ast.Constant)
            and isinstance(node.right.value, str)
        ):
            found.append((node.lineno, prefix + node.right.value))
        elif (
            in_config
            and isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr in _GETTERS
            and node.args
            and isinstance(node.args[0], ast.Constant)
            and isinstance(node.args[0].value, str)
        ):
            found.append((node.lineno, prefix + node.args[0].value))
    return found


def run(files: Iterable[SourceFile], root: Path) -> List[Finding]:
    from sparkrdma_tpu_torch.utils.config import DECLARED_KNOBS, PATTERN_KNOBS, PREFIX

    patterns = _pattern_regexes()
    declared = set(DECLARED_KNOBS)
    referenced: Dict[str, bool] = {k: False for k in declared}
    findings: List[Finding] = []

    def resolve(suffix: str) -> bool:
        if suffix in declared:
            referenced[suffix] = True
            return True
        if suffix.endswith("."):  # namespace scan (e.g. quota override scan)
            hits = [k for k in declared if k.startswith(suffix)]
            for k in hits:
                referenced[k] = True
            return bool(hits) or any(
                pat.startswith(suffix) for pat in PATTERN_KNOBS
            )
        return any(p.match(suffix) for p in patterns)

    key_shape = re.compile(r"^[\w.]*$")
    for sf in files:
        for line, key in _collect(sf, PREFIX):
            suffix = key[len(PREFIX):]
            if not suffix:
                continue  # the PREFIX constant itself
            if not key_shape.match(suffix):
                continue  # prose mentioning the prefix, not a key
            if not resolve(suffix):
                findings.append(
                    Finding(
                        PASS_ID,
                        sf.path,
                        line,
                        f"knob {key!r} is not in DECLARED_KNOBS "
                        "(utils/config.py) — declare it or fix the typo",
                    )
                )

    config_path = next(
        (f.path for f in files if f.path.endswith("utils/config.py")), None
    )
    if config_path is not None:
        for k, seen in sorted(referenced.items()):
            if not seen:
                findings.append(
                    Finding(
                        PASS_ID,
                        config_path,
                        1,
                        f"declared knob {PREFIX + k!r} is never read "
                        "anywhere in the tree",
                    )
                )
    return findings
