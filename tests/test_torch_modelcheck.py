"""The port's model checker (``sparkrdma_tpu_torch/analysis/modelcheck``)
against the JAX package's.

First the counterparts of every case of ``tests/test_modelcheck.py``, run
on the port: the JAX package's recorded failing schedules
(``tests/fixtures/modelcheck/*.json``, read as data) replay under the
port's scheduler, models and mutants to the recorded violation text,
three times each, and clean without their mutants; artifacts round-trip;
a short random walk of each model is clean. Then the two packages side
by side: the same models and mutants, the same mutation gate, the same
exhaustive schedule counts, artifacts that replay across packages, and
the same CLI output and exit codes.

A hung schedule cannot be unwound in process (a sim thread blocked on a
real lock never parks again), so every replay and walk in this process
runs under :func:`deadline`, which ends the process with every thread's
stack after a few seconds; CLI runs are children with a timeout.
"""

from __future__ import annotations

import contextlib
import faulthandler
import glob
import importlib
import logging
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import pytest
import torch

from sparkrdma_tpu.analysis.modelcheck import explore as jax_explore
from sparkrdma_tpu.analysis.modelcheck import models as jax_models
from sparkrdma_tpu.analysis.modelcheck import mutants as jax_mutants
from sparkrdma_tpu_torch.analysis import lockorder
from sparkrdma_tpu_torch.analysis.modelcheck import explore, sched
from sparkrdma_tpu_torch.analysis.modelcheck.explore import (
    load_artifact,
    random_walk,
    replay_artifact,
    save_artifact,
)
from sparkrdma_tpu_torch.analysis.modelcheck.models import MODELS
from sparkrdma_tpu_torch.analysis.modelcheck.mutants import MUTANTS, run_gate

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE_DIR = os.path.join(ROOT, "tests", "fixtures", "modelcheck")
FIXTURES = sorted(glob.glob(os.path.join(FIXTURE_DIR, "*.json")))
PACKAGES = ("sparkrdma_tpu", "sparkrdma_tpu_torch")
#: seconds a replay or a walk of these tiny models may take (each runs
#: in well under one on a CPU host)
LIMIT_S = 30
CLI_LIMIT_S = 400


@contextlib.contextmanager
def deadline(seconds: float = LIMIT_S):
    """End the process, dumping every thread's stack, if the block runs
    past ``seconds``: the test fails instead of hanging the suite."""
    faulthandler.dump_traceback_later(seconds, exit=True)
    try:
        yield
    finally:
        faulthandler.cancel_dump_traceback_later()


@pytest.fixture(autouse=True)
def _quiet_speculation():
    # every speculation schedule logs its clone at WARNING, in both packages
    logging.disable(logging.WARNING)
    yield
    logging.disable(logging.NOTSET)


def _cli(package: str, *args: str) -> subprocess.CompletedProcess:
    env = {**os.environ, "PYTHONPATH": ROOT, "JAX_PLATFORMS": "cpu"}
    return subprocess.run(
        [sys.executable, "-m", f"{package}.analysis.modelcheck", *args],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=CLI_LIMIT_S,
    )


# -- the counterparts of tests/test_modelcheck.py ----------------------------


def test_fixture_per_model():
    # one recorded failing schedule per registered protocol model
    covered = {load_artifact(p)["model"] for p in FIXTURES}
    assert covered == set(MODELS)


@pytest.mark.parametrize(
    "path", FIXTURES, ids=[os.path.basename(p) for p in FIXTURES]
)
def test_recorded_seed_replays_deterministically(path):
    artifact = load_artifact(path)
    assert artifact["mutant"] in MUTANTS  # fixture names a live mutant
    with deadline():
        reproduced = [replay_artifact(artifact) for _ in range(3)]
    assert reproduced[0] is not None, f"{os.path.basename(path)} no longer reproduces"
    # identical violation text every run: replay is deterministic
    assert len(set(reproduced)) == 1
    assert reproduced[0] == artifact["violation"]


@pytest.mark.parametrize(
    "path", FIXTURES, ids=[os.path.basename(p) for p in FIXTURES]
)
def test_unmutated_tree_passes_recorded_schedule(path):
    # the same schedule is CLEAN without the mutant: the fixture pins the
    # oracle's teeth, not a bug in the port's tree
    artifact = dict(load_artifact(path))
    artifact.pop("mutant", None)
    with deadline():
        assert replay_artifact(artifact) is None


def test_artifact_round_trip(tmp_path):
    artifact = load_artifact(FIXTURES[0])
    out = tmp_path / "roundtrip.json"
    save_artifact(artifact, str(out))
    assert load_artifact(str(out)) == artifact


@pytest.mark.parametrize("model_name", sorted(MODELS))
def test_random_walk_smoke(model_name):
    with deadline():
        outcome = random_walk(model_name, walks=5, seed=0)
    assert outcome["failure"] is None, outcome["failure"]


# -- the two packages side by side -------------------------------------------


def test_models_and_mutants_match_jax():
    assert sorted(MODELS) == sorted(jax_models.MODELS)
    assert {m: v[0] for m, v in MUTANTS.items()} == {
        m: v[0] for m, v in jax_mutants.MUTANTS.items()}
    assert len(MUTANTS) == 18


def test_mutation_gate_catches_every_mutant_as_jax_does():
    """Every mutant caught, by the same means, after the same number of
    schedules, with the same violation text as the JAX gate."""
    keys = ("caught", "how", "model", "violation", "schedules")
    with deadline(120):
        port = run_gate(walks=40)
        jax = jax_mutants.run_gate(walks=40)
    assert sorted(port) == sorted(MUTANTS)
    assert all(r["caught"] for r in port.values()), [m for m, r in port.items()
                                                     if not r["caught"]]
    assert {m: {k: r[k] for k in keys} for m, r in port.items()} == {
        m: {k: r[k] for k in keys} for m, r in jax.items()}


def test_gate_failures_replay_deterministically():
    """The gate keeps each caught schedule (the JAX gate drops it); each
    replays three times to its violation text, and without its mutant
    either runs clean or cannot be followed (the mutant made a thread
    runnable that is not), never to a violation."""
    outcomes = {}
    with deadline(120):
        for name, r in run_gate(walks=40).items():
            failure = r["failure"]
            assert failure["mutant"] == name and failure["violation"] == r["violation"]
            assert {replay_artifact(failure) for _ in range(3)} == {r["violation"]}
            plain = dict(failure, mutant=None)
            try:
                outcomes[name] = replay_artifact(plain)
            except sched.ReplayDivergence:
                outcomes[name] = "diverged"
    assert set(outcomes.values()) <= {None, "diverged"}, outcomes
    assert list(outcomes.values()).count(None) >= len(MUTANTS) // 2


@pytest.fixture(scope="module")
def exhaustive_counts():
    """Both packages' CLI, ``--exhaustive --max-schedules 300`` over every
    model, as children run at once (the JAX search of
    ``replica_promotion``, the slowest, in one of its own):
    {package: {model: (n, tag)}}."""
    slow = ["--model", "replica_promotion"]
    rest = [a for m in sorted(MODELS) if m != "replica_promotion" for a in ("--model", m)]
    runs = [(PACKAGES[0], slow), (PACKAGES[0], rest), (PACKAGES[1], [])]
    with ThreadPoolExecutor(len(runs)) as pool:
        done = list(pool.map(
            lambda r: _cli(r[0], *r[1], "--exhaustive", "--max-schedules", "300"), runs))
    out = {p: {} for p in PACKAGES}
    for (package, _), res in zip(runs, done):
        assert res.returncode == 0, res.stdout + res.stderr[-2000:]
        out[package].update({m: (int(n), tag) for m, n, tag in re.findall(
            r"model (\S+)\s+clean: (\d+) schedules \((\w+)\)", res.stdout)})
    return out


@pytest.mark.parametrize("model_name", sorted(MODELS))
def test_exhaustive_schedule_counts_match_jax(exhaustive_counts, model_name):
    port = exhaustive_counts["sparkrdma_tpu_torch"][model_name]
    assert port == exhaustive_counts["sparkrdma_tpu"][model_name]
    if model_name == "speculation":
        assert port == (51, "complete")
    else:
        assert port == (300, "truncated")


@pytest.mark.parametrize("mutant", [
    "merge-skip-dedup", "spec-double-settle", "quota-silent-release",
    "meta-serve-follower", "replica-no-divert",
])
def test_exhaustive_search_with_a_mutant_finds_what_jax_finds(mutant):
    """The port's search follows forced moves within one run (the JAX
    search re-executes each one from scratch); it finds the same failing
    schedule after the same number of complete schedules."""
    model = MUTANTS[mutant][0]
    with deadline(60):
        port = explore.exhaustive(model, max_schedules=300, mutant=mutant)
        jax = jax_explore.exhaustive(model, max_schedules=300, mutant=mutant)
    assert port["failure"] is not None
    assert port == jax


@pytest.mark.parametrize("emitter", ["port", "jax"])
def test_emitted_artifact_replays_under_the_other_package(tmp_path, emitter):
    """A failing schedule written by one package's ``--emit-dir`` path
    replays under the other package's replayer, in process and through
    its CLI, to the same violation text."""
    main = {p: importlib.import_module(f"{p}.analysis.modelcheck.__main__")
            for p in PACKAGES}
    walk = {"port": random_walk, "jax": jax_explore.random_walk}[emitter]
    replay = {"port": jax_explore.replay_artifact, "jax": replay_artifact}[emitter]
    with deadline():
        failure = walk("merge_seal", 40, seed=0, mutant="merge-skip-dedup")["failure"]
    assert failure is not None
    src = PACKAGES[1] if emitter == "port" else PACKAGES[0]
    other = PACKAGES[0] if emitter == "port" else PACKAGES[1]
    main[src]._emit(failure, str(tmp_path))
    (path,) = glob.glob(str(tmp_path / "*.json"))
    with deadline():
        assert replay(load_artifact(path)) == failure["violation"]
    res = _cli(other, "--replay", path)
    assert res.returncode == 0, res.stdout + res.stderr[-2000:]
    assert failure["violation"] in res.stdout


def _same_output(a: str, b: str) -> bool:
    return a.replace("sparkrdma_tpu_torch", "sparkrdma_tpu") == b


@pytest.mark.parametrize("args, rc", [
    (["--model", "merge_seal", "--walks", "3", "--seed", "5"], 0),
    (["--model", "speculation", "--model", "quota_stall", "--exhaustive",
      "--max-schedules", "60"], 0),
    (["--model", "speculation", "--exhaustive", "--no-por", "--max-schedules", "20"], 0),
    (["--model", "merge_seal", "--walks", "2", "--max-steps", "5", "--emit-dir", "{tmp}"], 1),
    (["--mutants", "--walks", "40"], 0),
    (["--replay", "{fixture}"], 0),
    (["--replay", "{unmutated}"], 1),
    (["--model", "no_such_model"], 2),
], ids=["walks", "exhaustive", "no-por", "max-steps-emit", "mutants", "replay",
        "replay-clean", "bad-model"])
def test_cli_flags_give_the_jax_exit_codes(tmp_path, args, rc):
    """Each flag of the CLI, on both packages: the same exit code and,
    the package name aside, the same output."""
    fixture = os.path.join(FIXTURE_DIR, "quota_stall.json")
    unmutated = tmp_path / "unmutated.json"
    save_artifact(dict(load_artifact(fixture), mutant=None), str(unmutated))
    for package in PACKAGES:
        (tmp_path / package).mkdir()
    runs = {}
    with ThreadPoolExecutor(2) as pool:
        for package in PACKAGES:
            argv = [a.format(tmp=tmp_path / package, fixture=fixture, unmutated=unmutated)
                    for a in args]
            runs[package] = pool.submit(_cli, package, *argv)
        outs = {p: f.result() for p, f in runs.items()}
    for package, res in outs.items():
        assert res.returncode == rc, (package, res.stdout, res.stderr[-2000:])
    jax, port = outs["sparkrdma_tpu"], outs["sparkrdma_tpu_torch"]
    if rc == 2:
        assert "invalid choice" in port.stderr and "invalid choice" in jax.stderr
        return
    strip = lambda text, p: text.replace(str(tmp_path / p), "{tmp}")  # noqa: E731
    assert _same_output(strip(port.stdout, PACKAGES[1]), strip(jax.stdout, PACKAGES[0]))
    if "--emit-dir" in args:
        emitted = {p: sorted(os.listdir(tmp_path / p)) for p in PACKAGES}
        assert emitted[PACKAGES[0]] == emitted[PACKAGES[1]] != []


def test_schedulers_restore_what_they_patched():
    """The JAX and port schedulers run one after the other in one process,
    and the lock-order detector's ``time.sleep`` probe under them: after
    each run the patched functions are what they were before it, and
    the port's ``OrderedLock`` reads the live scheduler."""
    import threading
    import time

    def patched():
        return (threading.Condition.wait, threading.Condition.notify,
                threading.Condition.notify_all, threading.Event.wait,
                threading.Event.set, time.sleep, time.monotonic, time.perf_counter)

    before = patched()
    seen = []
    real_before = lockorder.OrderedLock.acquire

    def spy(self, *a, **kw):
        seen.append(sched.active)
        return real_before(self, *a, **kw)

    with deadline():
        lockorder.OrderedLock.acquire = spy
        try:
            assert random_walk("replica_promotion", walks=1)["failure"] is None
        finally:
            lockorder.OrderedLock.acquire = real_before
        assert patched() == before
        assert jax_explore.random_walk("merge_seal", walks=2)["failure"] is None
        assert patched() == before
        det = lockorder.LockOrderDetector()
        det.enable()
        try:
            probe = time.sleep
            assert random_walk("quota_stall", walks=2)["failure"] is None
            assert time.sleep is probe
        finally:
            det.disable()
    assert patched() == before
    assert sched.active is None
    assert any(s is not None for s in seen), "OrderedLock never saw the scheduler"


def test_a_second_scheduler_in_the_same_package_is_refused():
    first = sched.CooperativeScheduler()
    sched.active = first
    try:
        with pytest.raises(RuntimeError, match="another CooperativeScheduler is active"):
            sched.CooperativeScheduler().run(explore.MinPicker())
    finally:
        sched.active = None
