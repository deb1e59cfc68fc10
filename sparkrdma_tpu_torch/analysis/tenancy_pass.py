"""tenant-scope pass — thread spawns on tenancy paths re-enter scope.

Tenant identity rides a thread-local (``tenancy.current_tenant``), so
every thread or timer spawned on a path that does per-tenant work
(buffer charges, quota gates, fair-share accounting, breaker keys)
must re-establish it — otherwise the child thread silently bills the
default tenant. The accepted shapes, both used across the tree:

- ``threading.Thread(target=tenancy.scoped(tenant, fn))`` — the
  closure re-enters the scope around ``fn``,
- a target function whose own body contains ``with tenant_scope(...)``
  (the retry-timer idiom in ``fetcher.py``).

A spawn in a tenancy-sensitive module matching neither is reported.
Spawns that genuinely do no tenant-attributed work (connection
pre-warm, thread joiners) carry an inline suppression with the reason.
"""

from __future__ import annotations

import ast
from pathlib import Path
from typing import Dict, Iterable, List, Optional

from sparkrdma_tpu_torch.analysis import Finding, SourceFile

PASS_ID = "tenant-scope"

#: repo-relative path prefixes where spawned threads do tenant work
SENSITIVE_PREFIXES = (
    "sparkrdma_tpu_torch/shuffle/",
    "sparkrdma_tpu_torch/tenancy/",
    "sparkrdma_tpu_torch/memory/",
    "sparkrdma_tpu_torch/ops/hbm_arena.py",
)

_SCOPE_MARKERS = ("tenant_scope", "scoped")


def _is_spawn(node: ast.Call) -> Optional[str]:
    """'Thread'/'Timer' when node constructs one, else None."""
    f = node.func
    if isinstance(f, ast.Attribute) and f.attr in ("Thread", "Timer"):
        if isinstance(f.value, ast.Name) and f.value.id == "threading":
            return f.attr
    if isinstance(f, ast.Name) and f.id in ("Thread", "Timer"):
        return f.id
    return None


def _target_expr(node: ast.Call, kind: str) -> Optional[ast.AST]:
    for kw in node.keywords:
        if kw.arg == ("function" if kind == "Timer" else "target"):
            return kw.value
    if kind == "Timer" and len(node.args) >= 2:
        return node.args[1]
    if kind == "Thread" and len(node.args) >= 2:
        return node.args[1]
    return None


def _is_scoped_call(expr: ast.AST) -> bool:
    """True for ``tenancy.scoped(...)`` / ``scoped(...)`` closures."""
    if not isinstance(expr, ast.Call):
        return False
    f = expr.func
    if isinstance(f, ast.Attribute) and f.attr == "scoped":
        return True
    return isinstance(f, ast.Name) and f.id == "scoped"


def _re_enters_scope(fn: ast.FunctionDef) -> bool:
    for n in ast.walk(fn):
        if isinstance(n, ast.Call):
            f = n.func
            name = (
                f.attr if isinstance(f, ast.Attribute)
                else f.id if isinstance(f, ast.Name)
                else None
            )
            if name in _SCOPE_MARKERS:
                return True
    return False


def _function_index(tree: ast.AST) -> Dict[str, ast.FunctionDef]:
    """Every function/method in the module, by bare name (last wins)."""
    out: Dict[str, ast.FunctionDef] = {}
    for n in ast.walk(tree):
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out[n.name] = n
    return out


def run(files: Iterable[SourceFile], root: Path) -> List[Finding]:
    findings: List[Finding] = []
    for sf in files:
        if not sf.path.startswith(SENSITIVE_PREFIXES):
            continue
        fns = _function_index(sf.tree)
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.Call):
                continue
            kind = _is_spawn(node)
            if kind is None:
                continue
            target = _target_expr(node, kind)
            if target is None:
                continue
            if _is_scoped_call(target):
                continue
            # resolve a Name / self.<attr> target to a same-module def
            tgt_name = None
            if isinstance(target, ast.Name):
                tgt_name = target.id
            elif isinstance(target, ast.Attribute):
                tgt_name = target.attr
            fn = fns.get(tgt_name) if tgt_name else None
            if fn is not None and _re_enters_scope(fn):
                continue
            where = f"function {tgt_name!r}" if tgt_name else "its target"
            findings.append(
                Finding(
                    PASS_ID,
                    sf.path,
                    node.lineno,
                    f"threading.{kind} on a tenancy-sensitive path: "
                    f"{where} neither wraps tenancy.scoped(...) nor "
                    "re-enters tenant_scope",
                )
            )
    return findings
