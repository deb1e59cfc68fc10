"""CLI for the protocol model checker.

CI tier-1 (random-walk smoke, prints the failing seed):

    python -m sparkrdma_tpu_torch.analysis.modelcheck --walks 25

Nightly (bounded exhaustive + sleep-set POR, artifacts on failure):

    python -m sparkrdma_tpu_torch.analysis.modelcheck --exhaustive \\
        --max-schedules 2000 --emit-dir mc-artifacts

Mutation gate (every seeded mutant must be caught):

    python -m sparkrdma_tpu_torch.analysis.modelcheck --mutants

Replay a recorded failing schedule:

    python -m sparkrdma_tpu_torch.analysis.modelcheck --replay artifact.json

Exit status: 0 = clean (or failure reproduced under --replay),
1 = violation found / mutant missed / replay did not reproduce.

A copy of the JAX package's ``analysis/modelcheck/__main__.py``, its
imports rewritten to this package: the same flags and exit codes.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional

from sparkrdma_tpu_torch.analysis.modelcheck.explore import (
    DEFAULT_MAX_STEPS,
    exhaustive,
    load_artifact,
    random_walk,
    replay_artifact,
    save_artifact,
)
from sparkrdma_tpu_torch.analysis.modelcheck.models import MODELS
from sparkrdma_tpu_torch.analysis.modelcheck.mutants import MUTANTS, run_gate


def _emit(failure: dict, emit_dir: Optional[str]) -> None:
    if not emit_dir:
        return
    os.makedirs(emit_dir, exist_ok=True)
    stamp = f"{failure['model']}-{failure['kind']}-{failure.get('seed')}"
    path = os.path.join(emit_dir, f"{stamp}.json")
    save_artifact(failure, path)
    print(f"  artifact: {path}")


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m sparkrdma_tpu_torch.analysis.modelcheck",
        description="deterministic-schedule model checker for the "
        "shuffle protocol state machines",
    )
    ap.add_argument(
        "--model",
        action="append",
        choices=sorted(MODELS),
        help="protocol model(s) to explore (default: all)",
    )
    ap.add_argument(
        "--walks", type=int, default=25,
        help="random schedules per model (CI smoke; default 25)",
    )
    ap.add_argument("--seed", type=int, default=0, help="base walk seed")
    ap.add_argument(
        "--exhaustive", action="store_true",
        help="bounded exhaustive DFS with sleep-set POR (nightly)",
    )
    ap.add_argument(
        "--max-schedules", type=int, default=2000,
        help="complete-schedule budget for --exhaustive (default 2000)",
    )
    ap.add_argument(
        "--no-por", action="store_true",
        help="disable sleep-set reduction (debugging the reducer)",
    )
    ap.add_argument(
        "--max-steps", type=int, default=DEFAULT_MAX_STEPS,
        help="per-schedule step bound (livelock guard)",
    )
    ap.add_argument(
        "--mutants", action="store_true",
        help="run the mutation-testing gate (every mutant must be caught)",
    )
    ap.add_argument(
        "--replay", metavar="ARTIFACT",
        help="replay one recorded failing-schedule JSON artifact",
    )
    ap.add_argument(
        "--emit-dir", metavar="DIR",
        help="write failing schedules as replayable JSON artifacts here",
    )
    args = ap.parse_args(argv)

    if args.replay:
        artifact = load_artifact(args.replay)
        violation = replay_artifact(artifact, max_steps=args.max_steps)
        if violation is None:
            print(f"replay of {args.replay}: did NOT reproduce")
            return 1
        print(f"replay of {args.replay}: reproduced\n  {violation}")
        return 0

    if args.mutants:
        results = run_gate(
            walks=max(args.walks, 40),
            seed=args.seed,
            max_schedules=args.max_schedules,
        )
        missed = [m for m, r in results.items() if not r["caught"]]
        for name, r in sorted(results.items()):
            status = f"caught ({r['how']})" if r["caught"] else "MISSED"
            print(f"mutant {name:24s} [{r['model']}] {status}")
            if r["violation"]:
                print(f"    {r['violation']}")
        if missed:
            print(f"\nmutation gate RED: {len(missed)} mutant(s) missed: "
                  f"{', '.join(missed)}")
            print(f"({len(MUTANTS)} mutants total)")
            return 1
        print(f"\nmutation gate green: {len(results)} mutants all caught")
        return 0

    models = args.model or sorted(MODELS)
    rc = 0
    for name in models:
        if args.exhaustive:
            outcome = exhaustive(
                name,
                max_schedules=args.max_schedules,
                max_steps=args.max_steps,
                por=not args.no_por,
            )
            tag = "complete" if outcome.get("complete") else "truncated"
            summary = f"{outcome['schedules']} schedules ({tag})"
        else:
            outcome = random_walk(
                name, args.walks, seed=args.seed, max_steps=args.max_steps
            )
            summary = f"{outcome['schedules']} schedules"
        failure = outcome["failure"]
        if failure is None:
            print(f"model {name:20s} clean: {summary}")
            continue
        rc = 1
        print(f"model {name:20s} VIOLATION after {summary}")
        print(f"  {failure['violation']}")
        if failure.get("seed") is not None:
            print(
                f"  reproduce: python -m sparkrdma_tpu_torch.analysis.modelcheck "
                f"--model {name} --walks 1 --seed {failure['seed']}"
            )
        else:
            print(f"  trace: {json.dumps(failure['trace'])}")
        _emit(failure, args.emit_dir)
    return rc


if __name__ == "__main__":
    sys.exit(main())
