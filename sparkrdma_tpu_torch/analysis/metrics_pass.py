"""metric-families pass — instruments must match a declared family.

Every static call site of the shape ``<obj>.counter("name", k=v, ...)``
(likewise ``gauge``/``histogram``) is checked against
``METRIC_FAMILIES`` in :mod:`sparkrdma_tpu_torch.obs.metrics`:

- the name must be declared,
- the declared kind must match the method used,
- the keyword-argument label keys must equal the declared label set
  exactly (a site that drops or invents a label fragments the family
  across OpenMetrics series),
- and the family name must have an anchor in docs/OBSERVABILITY.md
  (metrics that operators cannot look up are write-only telemetry).

Sites whose name argument is not a string literal (e.g. the fair-share
executor's cached ``getattr(reg, kind)`` helper) are invisible here;
the registry validates those at runtime against the same table.
"""

from __future__ import annotations

import ast
from pathlib import Path
from typing import Iterable, List

from sparkrdma_tpu_torch.analysis import Finding, SourceFile

PASS_ID = "metric-families"

_KINDS = ("counter", "gauge", "histogram")


def run(files: Iterable[SourceFile], root: Path) -> List[Finding]:
    from sparkrdma_tpu_torch.obs.metrics import METRIC_FAMILIES

    findings: List[Finding] = []
    seen_names = set()
    for sf in files:
        # library tree only: tests legitimately mint ad-hoc families to
        # exercise the registry itself
        if not sf.path.startswith("sparkrdma_tpu_torch/"):
            continue
        if sf.path.endswith("obs/metrics.py"):
            continue  # the registry's own method definitions/table
        for node in ast.walk(sf.tree):
            if not (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in _KINDS
            ):
                continue
            if not (
                node.args
                and isinstance(node.args[0], ast.Constant)
                and isinstance(node.args[0].value, str)
            ):
                continue
            name = node.args[0].value
            if "." not in name:
                # not a registry family (e.g. collections.Counter("x"))
                continue
            kind = node.func.attr
            seen_names.add(name)
            fam = METRIC_FAMILIES.get(name)
            if fam is None:
                findings.append(
                    Finding(
                        PASS_ID,
                        sf.path,
                        node.lineno,
                        f"metric {name!r} is not in METRIC_FAMILIES "
                        "(obs/metrics.py) — declare the family or fix "
                        "the typo",
                    )
                )
                continue
            decl_kind, decl_labels = fam
            if kind != decl_kind:
                findings.append(
                    Finding(
                        PASS_ID,
                        sf.path,
                        node.lineno,
                        f"metric {name!r} declared as a {decl_kind} but "
                        f"instantiated via .{kind}()",
                    )
                )
            if any(kw.arg is None for kw in node.keywords):
                continue  # **labels splat — runtime validation covers it
            # ``bounds`` is the histogram constructor's bucket spec,
            # not a label
            labels = frozenset(
                kw.arg for kw in node.keywords
                if not (kind == "histogram" and kw.arg == "bounds")
            )
            if labels != decl_labels:
                findings.append(
                    Finding(
                        PASS_ID,
                        sf.path,
                        node.lineno,
                        f"metric {name!r} label set {sorted(labels)} != "
                        f"declared {sorted(decl_labels)}",
                    )
                )

    # doc anchors: every declared family must appear in OBSERVABILITY.md
    doc = root / "docs" / "OBSERVABILITY.md"
    doc_text = doc.read_text() if doc.is_file() else ""
    metrics_path = next(
        (f.path for f in files if f.path.endswith("obs/metrics.py")),
        "sparkrdma_tpu_torch/obs/metrics.py",
    )
    for name in sorted(METRIC_FAMILIES):
        if name not in doc_text:
            findings.append(
                Finding(
                    PASS_ID,
                    metrics_path,
                    1,
                    f"metric family {name!r} has no anchor in "
                    "docs/OBSERVABILITY.md",
                )
            )
    return findings


def dump(files: Iterable[SourceFile]) -> List[str]:
    """Maintenance helper: observed (kind, name, labels) tuples."""
    rows = {}
    for sf in files:
        for node in ast.walk(sf.tree):
            if (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in _KINDS
                and node.args
                and isinstance(node.args[0], ast.Constant)
                and isinstance(node.args[0].value, str)
                and "." in node.args[0].value
            ):
                labels = tuple(
                    sorted(kw.arg for kw in node.keywords if kw.arg)
                )
                rows.setdefault(
                    (node.args[0].value, node.func.attr), set()
                ).add(labels)
    return [
        f"{name} {kind} {sorted(labelsets)}"
        for (name, kind), labelsets in sorted(rows.items())
    ]
