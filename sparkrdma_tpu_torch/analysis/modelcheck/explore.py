"""Exploration strategies over the cooperative scheduler.

Three pickers drive :meth:`CooperativeScheduler.run`:

- :class:`MinPicker` — always the lowest-index runnable thread. This is
  the *serial schedule*: the deterministic reference execution whose
  result bytes every explored schedule must reproduce.
- :class:`RandomPicker` — seeded uniform choice at every step. A seed
  fully determines the schedule, so any failure replays from its seed.
- :class:`FixedPicker` — replays a recorded thread-name trace exactly
  (the artifact/regression-fixture path), raising
  :class:`ReplayDivergence` when the trace names a thread that is not
  currently runnable (model or code drifted since recording).

:func:`random_walk` is the CI entrypoint: serial baseline first (must
be violation-free — it doubles as the byte-identity reference), then N
seeded walks. :func:`exhaustive` is the nightly entrypoint: stateless
DFS with re-execution and Godefroid-style sleep sets, treating two lock
actions on distinct lock instances as independent (everything else is
conservatively dependent — sound, just less reduction).

Failures serialize to JSON artifacts (:func:`save_artifact`) carrying
the model name, seed/trace, and violation text; :func:`replay_artifact`
re-runs one under :class:`FixedPicker`.

A copy of the JAX package's ``analysis/modelcheck/explore.py``, its
imports rewritten to this package; artifacts are interchangeable
between the packages. One change: :func:`exhaustive`'s re-execution
follows the forced moves past its prefix (a frontier of one thread the
sleep set does not hold) in the same run (:class:`_PrefixPicker`),
where the JAX search re-executes the prefix from scratch for each. Given
the same frontiers it visits the JAX search's nodes in the JAX order
(both searches read lock identities, ``id()``, which vary from run to
run); about nine in ten frontiers of ``replica_promotion`` are forced,
so its search at 2000 schedules runs several times faster.
"""

from __future__ import annotations

import json
import random
from typing import Dict, List, Optional, Tuple

from sparkrdma_tpu_torch.analysis.modelcheck.models import MODELS
from sparkrdma_tpu_torch.analysis.modelcheck.sched import (
    CooperativeScheduler,
    OracleViolation,
    ReplayDivergence,
    SimThread,
)

DEFAULT_MAX_STEPS = 20000


class MinPicker:
    """The serial schedule: lowest spawn-index runnable thread."""

    def pick(self, step: int, runnable: List[SimThread]) -> SimThread:
        return runnable[0]


class RandomPicker:
    """Seeded uniform schedule; the seed IS the schedule."""

    def __init__(self, seed: int):
        self.seed = seed
        self._rng = random.Random(seed)

    def pick(self, step: int, runnable: List[SimThread]) -> SimThread:
        return runnable[self._rng.randrange(len(runnable))]


class FixedPicker:
    """Replay a recorded thread-name trace; serial past its end."""

    def __init__(self, trace: List[str]):
        self.trace = list(trace)

    def pick(self, step: int, runnable: List[SimThread]) -> SimThread:
        if step < len(self.trace):
            want = self.trace[step]
            for t in runnable:
                if t.name == want:
                    return t
            raise ReplayDivergence(
                f"step {step}: recorded thread {want!r} not runnable "
                f"(runnable: {[t.name for t in runnable]})"
            )
        return runnable[0]


class _FrontierStop(Exception):
    """Internal: prefix consumed; abort the run to inspect the frontier."""


class _PrefixPicker:
    """Follow a fixed prefix, then the forced moves past it, then capture
    the frontier and stop.

    A forced move is a frontier of one thread that ``sleep`` does not
    hold: exploring it has one child, the same prefix one step longer
    with the sleep set narrowed to what commutes with that thread, so
    the picker takes it in the same run (``forced``, ``sleep``) instead
    of the search re-executing the longer prefix from scratch. The
    search visits the same nodes in the same order.
    """

    def __init__(self, prefix: List[str], sleep: Optional[set] = None,
                 por: bool = True):
        self.prefix = prefix
        self.sleep = set(sleep or ())
        self.por = por
        self.forced: List[str] = []
        self.frontier: List[Tuple[str, str, Optional[int]]] = []

    def pick(self, step: int, runnable: List[SimThread]) -> SimThread:
        if step < len(self.prefix):
            want = self.prefix[step]
            for t in runnable:
                if t.name == want:
                    return t
            raise ReplayDivergence(
                f"exhaustive prefix diverged at step {step}: {want!r} not in "
                f"{[t.name for t in runnable]}"
            )
        frontier = [
            (t.name, t.pending.kind, t.pending.key) for t in runnable
        ]
        if len(frontier) == 1 and frontier[0] not in self.sleep:
            cand = frontier[0]
            self.sleep = (
                {c for c in self.sleep if _independent(c, cand)}
                if self.por else set()
            )
            self.forced.append(cand[0])
            return runnable[0]
        self.frontier = frontier
        raise _FrontierStop()


def run_schedule(
    model_name: str,
    picker,
    max_steps: int = DEFAULT_MAX_STEPS,
    mutant: Optional[str] = None,
) -> Tuple[bytes, List[str]]:
    """One complete schedule of ``model_name`` under ``picker``.

    Builds a fresh model, runs it to completion with the quiescent
    oracle armed, then runs the final oracles. Returns ``(result_bytes,
    trace)``; raises :class:`OracleViolation` (or Deadlock/Crash/...)
    on the first violation. ``mutant`` arms a seeded protocol mutant
    (:mod:`.mutants`) for the duration of the run.
    """
    from sparkrdma_tpu_torch.analysis.modelcheck.mutants import apply_mutant

    model = MODELS[model_name]()
    sched = CooperativeScheduler()

    def quiescent() -> None:
        violations = model.check()
        if violations:
            raise OracleViolation(
                f"[{model_name}] " + "; ".join(violations)
            )

    with apply_mutant(mutant):
        model.build(sched)
        sched.on_quiescent = quiescent
        try:
            sched.run(picker, max_steps=max_steps)
        except BaseException as e:
            e.mc_trace = list(sched.trace)  # type: ignore[attr-defined]
            raise
        violations = model.final()
        if violations:
            err = OracleViolation(f"[{model_name}] " + "; ".join(violations))
            err.mc_trace = list(sched.trace)  # type: ignore[attr-defined]
            raise err
        return model.result(), list(sched.trace)


def random_walk(
    model_name: str,
    walks: int,
    seed: int = 0,
    max_steps: int = DEFAULT_MAX_STEPS,
    mutant: Optional[str] = None,
) -> Dict[str, object]:
    """Serial baseline + ``walks`` seeded random schedules.

    Returns ``{"schedules": n, "failure": None}`` on success, or the
    first failure as ``{"kind", "seed", "trace", "violation"}`` — the
    caller prints the seed; ``seed`` alone reproduces the schedule.
    """
    try:
        baseline, _ = run_schedule(
            model_name, MinPicker(), max_steps=max_steps, mutant=mutant
        )
    except BaseException as e:
        return {
            "schedules": 0,
            "failure": {
                "model": model_name,
                "kind": "serial",
                "seed": None,
                "trace": getattr(e, "mc_trace", []),
                "violation": f"{type(e).__name__}: {e}",
                "mutant": mutant,
            },
        }
    ran = 1
    for i in range(walks):
        walk_seed = seed + i
        try:
            result, _trace = run_schedule(
                model_name,
                RandomPicker(walk_seed),
                max_steps=max_steps,
                mutant=mutant,
            )
        except BaseException as e:
            return {
                "schedules": ran,
                "failure": {
                    "model": model_name,
                    "kind": "random",
                    "seed": walk_seed,
                    "trace": getattr(e, "mc_trace", []),
                    "violation": f"{type(e).__name__}: {e}",
                    "mutant": mutant,
                },
            }
        ran += 1
        if result != baseline:
            return {
                "schedules": ran,
                "failure": {
                    "model": model_name,
                    "kind": "random",
                    "seed": walk_seed,
                    "trace": _trace,
                    "violation": (
                        "byte-identity: schedule result diverges from the "
                        f"serial schedule ({result!r} != {baseline!r})"
                    ),
                    "mutant": mutant,
                },
            }
    return {"schedules": ran, "failure": None}


def _independent(
    a: Tuple[str, str, Optional[int]], b: Tuple[str, str, Optional[int]]
) -> bool:
    """Conservative independence for sleep sets: only lock actions on
    DISTINCT lock instances commute for sure. Proto seams, waits, and
    timers all touch shared protocol state — treated dependent."""
    _, akind, akey = a
    _, bkind, bkey = b
    if not akind.startswith("lock.") or not bkind.startswith("lock."):
        return False
    return akey is not None and bkey is not None and akey != bkey


def exhaustive(
    model_name: str,
    max_schedules: int = 2000,
    max_steps: int = DEFAULT_MAX_STEPS,
    mutant: Optional[str] = None,
    por: bool = True,
) -> Dict[str, object]:
    """Bounded DFS over all schedules, sleep-set reduced.

    Stateless search with re-execution: a prefix (list of thread names)
    re-runs from scratch to reach its frontier, so protocol state never
    needs checkpointing. ``max_schedules`` bounds COMPLETE schedules
    (budget exhaustion is reported, never silent). Returns the same
    shape as :func:`random_walk` plus ``"complete"`` — True when the
    whole space fit the budget.
    """
    from sparkrdma_tpu_torch.analysis.modelcheck.mutants import apply_mutant

    baseline: List[bytes] = []
    stats = {"schedules": 0, "truncated": False}

    def frontier_of(prefix: List[str], sleep: set):
        """Re-execute ``prefix`` and the forced moves past it; return
        those moves, the sleep set after them and the runnable set just
        past them ([] when the schedule is then complete)."""
        from sparkrdma_tpu_torch.analysis.modelcheck.models import MODELS as _M

        model = _M[model_name]()
        sched = CooperativeScheduler()
        picker = _PrefixPicker(prefix, sleep, por)
        with apply_mutant(mutant):
            model.build(sched)
            try:
                sched.run(picker, max_steps=max_steps)
            except _FrontierStop:
                return picker.forced, picker.sleep, picker.frontier
        return picker.forced, picker.sleep, []

    def complete(prefix: List[str]) -> None:
        """Run ``prefix`` as a full schedule with every oracle armed."""
        stats["schedules"] += 1
        result, _ = run_schedule(
            model_name,
            FixedPicker(prefix),
            max_steps=max_steps,
            mutant=mutant,
        )
        if not baseline:
            baseline.append(result)
        elif result != baseline[0]:
            err = OracleViolation(
                "byte-identity: schedule result diverges from the serial "
                f"schedule ({result!r} != {baseline[0]!r})"
            )
            err.mc_trace = list(prefix)  # type: ignore[attr-defined]
            raise err

    def explore(prefix: List[str], sleep: set) -> None:
        if stats["schedules"] >= max_schedules:
            stats["truncated"] = True
            return
        forced, sleep, frontier = frontier_of(prefix, sleep)
        prefix = prefix + forced
        if not frontier:
            complete(prefix)
            return
        sleep = set(sleep)
        for cand in frontier:
            name = cand[0]
            if cand in sleep:
                continue
            if stats["schedules"] >= max_schedules:
                stats["truncated"] = True
                return
            child_sleep = (
                {c for c in sleep if _independent(c, cand)} if por else set()
            )
            explore(prefix + [name], child_sleep)
            if por:
                sleep.add(cand)

    try:
        # serial first so the byte-identity baseline is the serial result
        complete(_serial_trace(model_name, max_steps, mutant))
        explore([], set())
    except BaseException as e:
        return {
            "schedules": stats["schedules"],
            "complete": False,
            "failure": {
                "model": model_name,
                "kind": "exhaustive",
                "seed": None,
                "trace": getattr(e, "mc_trace", []),
                "violation": f"{type(e).__name__}: {e}",
                "mutant": mutant,
            },
        }
    return {
        "schedules": stats["schedules"],
        "complete": not stats["truncated"],
        "failure": None,
    }


def _serial_trace(
    model_name: str, max_steps: int, mutant: Optional[str]
) -> List[str]:
    _, trace = run_schedule(
        model_name, MinPicker(), max_steps=max_steps, mutant=mutant
    )
    return trace


# -- artifacts ------------------------------------------------------------
def save_artifact(failure: Dict[str, object], path: str) -> None:
    """Write one failing schedule as a replayable JSON artifact."""
    with open(path, "w") as f:
        json.dump(failure, f, indent=2, sort_keys=True)
        f.write("\n")


def load_artifact(path: str) -> Dict[str, object]:
    with open(path) as f:
        return json.load(f)


def replay_artifact(
    artifact: Dict[str, object], max_steps: int = DEFAULT_MAX_STEPS
) -> Optional[str]:
    """Re-run a recorded failing schedule; returns the reproduced
    violation text, or None when the failure no longer reproduces
    (fixed — or the model drifted: ReplayDivergence says which)."""
    model_name = str(artifact["model"])
    mutant = artifact.get("mutant")
    trace = artifact.get("trace") or []
    seed = artifact.get("seed")
    if trace:
        picker = FixedPicker([str(t) for t in trace])
    elif seed is not None:
        picker = RandomPicker(int(seed))  # type: ignore[arg-type]
    else:
        raise ValueError("artifact has neither trace nor seed")
    try:
        run_schedule(
            model_name,
            picker,
            max_steps=max_steps,
            mutant=str(mutant) if mutant else None,
        )
    except ReplayDivergence:
        raise
    except BaseException as e:  # noqa: BLE001 — the violation IS the result
        return f"{type(e).__name__}: {e}"
    return None


def walk_all(
    walks: int, seed: int = 0, mutant: Optional[str] = None
) -> Dict[str, Dict[str, object]]:
    """Random-walk every registered model; {model: outcome}."""
    return {
        name: random_walk(name, walks, seed=seed, mutant=mutant)
        for name in sorted(MODELS)
    }


__all__ = [
    "FixedPicker",
    "MinPicker",
    "RandomPicker",
    "exhaustive",
    "load_artifact",
    "random_walk",
    "replay_artifact",
    "run_schedule",
    "save_artifact",
    "walk_all",
]
