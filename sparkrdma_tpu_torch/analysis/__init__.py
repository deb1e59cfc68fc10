"""Invariant analysis suite — project-specific static lint passes.

The framework's correctness rests on a handful of cross-file
invariants that ordinary linters cannot see: every ``tpu.shuffle.*``
knob read must resolve against the declared-knobs table in
``utils/config.py``; every metrics-registry instrument must belong to
a declared family with a consistent label set and an OBSERVABILITY.md
anchor; the wire-extension markers (0xFFFF/0xFFFE/0xFFFD/0xFFFC) and
their struct formats must agree between encoder and parser, with every
marker dispatched from the parser's single peek loop so extensions and
the trace trailer parse in ANY order; and thread
spawns on tenancy-sensitive paths must re-enter ``tenant_scope``.
This package encodes each invariant as an AST pass over the tree and
exposes them behind ``python -m sparkrdma_tpu_torch.analysis`` (gated in
CI) plus a runtime lock-order detector (:mod:`.lockorder`) that tier-1
can run under.

Suppression: a finding is silenced by an inline comment on the same
line (or the line immediately above) of the form::

    # analysis: ignore[<pass-id>]: <reason>

The reason is mandatory — a bare ``ignore[...]`` is itself reported.
``ignore[all]`` silences every pass for that line. See
docs/ANALYSIS.md for the catalogue of passes.

A copy of the JAX package's ``analysis/`` (``__init__``, ``__main__``,
``knobs``, ``metrics_pass``, ``tenancy_pass``, ``wire``, ``lockorder``,
``pytest_plugin``, ``modelcheck/``), its imports rewritten to this package and its
passes pointed at the port's tree: ``load_tree`` reads
``sparkrdma_tpu_torch/`` and the port's tests (``tests/test_torch_*.py``),
skipping ``build``/``dist``/cache directories inside the checkout only
(the JAX walk also skips a whole checkout that sits under one),
the knob pass this package's ``utils/config.py`` tables, the metric pass
its ``obs/metrics.py`` families (the anchors of docs/OBSERVABILITY.md
serve both packages: the tables are equal), and the path-scoped passes
take ``sparkrdma_tpu_torch/`` prefixes. The model checker
(``analysis/modelcheck``) runs the port's protocol code, and its
scheduler is the one every ``OrderedLock`` and ``schedule_point`` of
the port reaches.
"""

from __future__ import annotations

import ast
import dataclasses
import re
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

__all__ = [
    "Finding",
    "SourceFile",
    "PASS_IDS",
    "load_tree",
    "repo_root",
    "run_passes",
]

#: pass-id -> one-line description; the runner modules live next door.
PASS_IDS = {
    "knob-registry": "tpu.shuffle.* reads resolve against DECLARED_KNOBS",
    "metric-families": "registry instruments match a declared metric family",
    "wire-markers": "wire-extension markers/structs agree encoder vs parser",
    "tenant-scope": "thread spawns on tenancy paths re-enter tenant_scope",
}

_SUPPRESS_RE = re.compile(
    r"#\s*analysis:\s*ignore\[([a-z\-,\s]+)\](?::\s*(\S.*))?"
)


@dataclasses.dataclass(frozen=True)
class Finding:
    """One invariant violation at a source location."""

    pass_id: str
    path: str  # repo-relative, forward slashes
    line: int
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}: [{self.pass_id}] {self.message}"


class SourceFile:
    """A parsed Python source file plus its suppression table."""

    def __init__(self, path: str, source: str):
        self.path = path
        self.source = source
        self.tree = ast.parse(source, filename=path)
        self.lines = source.splitlines()
        # line -> set of suppressed pass ids ("all" suppresses any)
        self.suppressions: Dict[int, Set[str]] = {}
        #: well-formed suppressions as (line, pass_ids, reason) — the
        #: ``--audit-ignores`` inventory
        self.suppression_records: List[Tuple[int, Set[str], str]] = []
        #: malformed suppressions (missing reason) found while parsing
        self.bad_suppressions: List[Finding] = []
        self._scan_suppressions()

    def _scan_suppressions(self) -> None:
        for i, text in enumerate(self.lines, start=1):
            m = _SUPPRESS_RE.search(text)
            if not m:
                continue
            ids = {p.strip() for p in m.group(1).split(",") if p.strip()}
            if not m.group(2):
                self.bad_suppressions.append(
                    Finding(
                        "suppression",
                        self.path,
                        i,
                        "analysis: ignore[...] requires a ': <reason>'",
                    )
                )
                continue
            unknown = ids - set(PASS_IDS) - {"all"}
            if unknown:
                self.bad_suppressions.append(
                    Finding(
                        "suppression",
                        self.path,
                        i,
                        f"unknown pass id(s) in suppression: {sorted(unknown)}",
                    )
                )
                ids -= unknown
            if ids:
                self.suppression_records.append((i, set(ids), m.group(2)))
            # a comment-only line suppresses the NEXT line too
            target_lines = [i]
            if text.lstrip().startswith("#"):
                target_lines.append(i + 1)
            for ln in target_lines:
                self.suppressions.setdefault(ln, set()).update(ids)

    def suppressed(self, pass_id: str, line: int) -> bool:
        ids = self.suppressions.get(line)
        return bool(ids) and (pass_id in ids or "all" in ids)


def repo_root() -> Path:
    """The checkout root (parent of the ``sparkrdma_tpu_torch`` package)."""
    return Path(__file__).resolve().parents[2]


_SKIP_PARTS = {"__pycache__", ".git", "build", "dist"}


def load_tree(
    root: Optional[Path] = None,
    subdirs: Sequence[str] = ("sparkrdma_tpu_torch", "tests/test_torch_*.py"),
) -> List[SourceFile]:
    """Parse every analysable .py file under ``root``'s code subdirs; an
    entry that is not a directory is a glob of files under ``root``."""
    root = root or repo_root()
    files: List[SourceFile] = []
    for sub in subdirs:
        base = root / sub
        paths = sorted(base.rglob("*.py")) if base.is_dir() else sorted(root.glob(sub))
        for p in paths:
            # the parts under the root only: a checkout unpacked beneath a
            # ``build`` directory is still linted whole
            rel_path = p.relative_to(root)
            if _SKIP_PARTS.intersection(rel_path.parts) or not p.is_file():
                continue
            rel = rel_path.as_posix()
            try:
                files.append(SourceFile(rel, p.read_text()))
            except SyntaxError as e:
                # a file that does not parse fails the whole run loudly
                raise SyntaxError(f"{rel}: {e}") from e
    return files


def run_passes(
    files: Iterable[SourceFile],
    root: Optional[Path] = None,
    only: Optional[Sequence[str]] = None,
) -> List[Finding]:
    """Run the selected passes, returning unsuppressed findings."""
    from sparkrdma_tpu_torch.analysis import knobs, metrics_pass, tenancy_pass, wire

    root = root or repo_root()
    files = list(files)
    runners = {
        "knob-registry": knobs.run,
        "metric-families": metrics_pass.run,
        "wire-markers": wire.run,
        "tenant-scope": tenancy_pass.run,
    }
    selected = list(only) if only else list(runners)
    by_path = {f.path: f for f in files}
    out: List[Finding] = []
    for f in files:
        out.extend(f.bad_suppressions)
    for pid in selected:
        for finding in runners[pid](files, root):
            sf = by_path.get(finding.path)
            if sf is not None and sf.suppressed(finding.pass_id, finding.line):
                continue
            out.append(finding)
    return sorted(out, key=lambda f: (f.path, f.line, f.pass_id))
