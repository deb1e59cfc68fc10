"""``python -m sparkrdma_tpu_torch.analysis`` — run the invariant passes.

Exit status 0 when the tree is clean, 1 when any pass reports an
unsuppressed finding. This is the entry point the CI ``analysis`` job
gates on; docs/ANALYSIS.md documents each pass and the suppression
syntax.

A copy of the JAX package's ``analysis/__main__.py``, its imports
rewritten to this package: it lints the port's tree
(``sparkrdma_tpu_torch/`` and ``tests/test_torch_*.py``).
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from sparkrdma_tpu_torch.analysis import PASS_IDS, load_tree, repo_root, run_passes


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m sparkrdma_tpu_torch.analysis",
        description="project invariant lint (see docs/ANALYSIS.md)",
    )
    ap.add_argument(
        "--root", type=Path, default=None,
        help="checkout root (default: auto-detected from the package)",
    )
    ap.add_argument(
        "--pass", dest="passes", action="append", choices=sorted(PASS_IDS),
        help="run only this pass (repeatable; default: all)",
    )
    ap.add_argument(
        "--dump-metrics", action="store_true",
        help="print observed (name, kind, labelsets) tuples and exit",
    )
    ap.add_argument(
        "--list", action="store_true", help="list pass ids and exit",
    )
    ap.add_argument(
        "--audit-ignores", action="store_true",
        help="list every '# analysis: ignore' suppression with its "
        "reason and exit (malformed suppressions still fail the run)",
    )
    args = ap.parse_args(argv)

    if args.list:
        for pid, desc in sorted(PASS_IDS.items()):
            print(f"{pid:16s} {desc}")
        return 0

    root = args.root or repo_root()
    files = load_tree(root)
    if args.audit_ignores:
        total = 0
        for sf in files:
            for line, ids, reason in sf.suppression_records:
                total += 1
                print(
                    f"{sf.path}:{line}: "
                    f"ignore[{','.join(sorted(ids))}] — {reason}"
                )
        bad = [f for sf in files for f in sf.bad_suppressions]
        for f in bad:
            print(f.render())
        print(
            f"\naudit: {total} suppression(s), {len(bad)} malformed",
            file=sys.stderr,
        )
        return 1 if bad else 0
    if args.dump_metrics:
        from sparkrdma_tpu_torch.analysis import metrics_pass

        for row in metrics_pass.dump(files):
            print(row)
        return 0

    findings = run_passes(files, root, only=args.passes)
    for f in findings:
        print(f.render())
    n_files = len(files)
    if findings:
        print(
            f"\nanalysis: {len(findings)} finding(s) across {n_files} files",
            file=sys.stderr,
        )
        return 1
    print(f"analysis: clean ({n_files} files, {len(PASS_IDS)} passes)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
