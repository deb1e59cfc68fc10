"""The port's invariant suite (``sparkrdma_tpu_torch/analysis/``) against
the JAX package's: the counterparts of every test of
``tests/test_analysis.py``, run on the port's passes and detector.

Each lint pass gets a planted violation in a synthetic ``SourceFile``
under the port's prefix (``sparkrdma_tpu_torch/``) and must report
exactly that plant, with the message the JAX pass gives the same plant
under the JAX prefix; the lock-order detector gets an AB/BA cycle, a
same-name nesting and a sleep under a hot lock, each on a private
detector. Then: the port's tree is clean; both packages' detectors
armed in one process each see the blocking call planted under their own
hot lock, and ``time.sleep`` is the real one again after both disarm;
and a pytest run of port test files under ``SPARKRDMA_LOCK_ORDER=1``
with the port's plugin reports a clean lock order.

Planted sources are built with string concatenation where a literal
would otherwise trip the passes (or the suppression scanner) on this
file when either package's CLI lints the tests."""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import textwrap
import time

import pytest
import torch

from sparkrdma_tpu import analysis as jax_analysis
from sparkrdma_tpu.analysis import lockorder as jax_lockorder
from sparkrdma_tpu_torch.analysis import (
    PASS_IDS,
    SourceFile,
    load_tree,
    repo_root,
    run_passes,
)
from sparkrdma_tpu_torch.analysis import lockorder
from sparkrdma_tpu_torch.analysis.lockorder import LockOrderDetector, named_lock

torch.set_num_threads(1)

ROOT = repo_root()

# assembled so the knob pass / suppression scanner never match literals
# in this test file itself
_KNOB_PREFIX = "tpu." + "shuffle."
_SUPPRESS = "# analysis: " + "ignore"


def _findings(source_file, pass_id):
    return run_passes([source_file], ROOT, only=[pass_id])


def _as_jax(path, source, pass_id):
    """The JAX pass's findings on the same plant under the JAX prefix,
    rendered with the port's path."""
    jpath = path.replace("sparkrdma_tpu_torch/", "sparkrdma_tpu/", 1)
    found = jax_analysis.run_passes([jax_analysis.SourceFile(jpath, source)], ROOT,
                                    only=[pass_id])
    return [(f.pass_id, f.path.replace("sparkrdma_tpu/", "sparkrdma_tpu_torch/", 1)
             if f.path == jpath else f.path, f.line, f.message) for f in found]


def _same_as_jax(path, source, pass_id):
    found = _findings(SourceFile(path, source), pass_id)
    assert [(f.pass_id, f.path, f.line, f.message) for f in found] == _as_jax(
        path, source, pass_id)
    return found


# -- knob-registry ---------------------------------------------------------


def test_knob_pass_catches_planted_typo():
    found = _same_as_jax("tests/fake_knob_user.py",
                         f'K = "{_KNOB_PREFIX}fetch.bogus_typo_knob"\n', "knob-registry")
    assert len(found) == 1
    assert found[0].pass_id == "knob-registry"
    assert "bogus_typo_knob" in found[0].message
    assert found[0].line == 1


def test_knob_pass_accepts_declared_key():
    assert _same_as_jax("tests/fake_knob_user.py",
                        f'K = "{_KNOB_PREFIX}recvQueueDepth"\n', "knob-registry") == []


# -- metric-families -------------------------------------------------------


def test_metric_pass_catches_label_mismatch():
    found = _same_as_jax("sparkrdma_tpu_torch/fake_metrics_user.py",
                         'c = reg.counter("mempool.hits", bogus_label="x")\n', "metric-families")
    assert len(found) == 1
    assert "label set" in found[0].message
    assert "bogus_label" in found[0].message


def test_metric_pass_catches_undeclared_family_and_wrong_kind():
    src = textwrap.dedent(
        """\
        a = reg.counter("no.such_family_xyz")
        b = reg.gauge("mempool.hits")
        """
    )
    found = _same_as_jax("sparkrdma_tpu_torch/fake_metrics_user.py", src, "metric-families")
    assert len(found) == 2
    assert "not in METRIC_FAMILIES" in found[0].message
    assert "declared as a counter" in found[1].message


def test_metric_pass_ignores_test_tree_and_registry_module():
    bad = 'c = reg.counter("no.such_family_xyz")\n'
    for path in ("tests/fake.py", "sparkrdma_tpu_torch/obs/metrics.py",
                 "sparkrdma_tpu/fake_jax_user.py"):
        assert _findings(SourceFile(path, bad), "metric-families") == []


# -- wire-markers ----------------------------------------------------------

_WIRE_TEMPLATE = """\
import struct


class Codec:
    _EXT_HDR = struct.Struct(">HI")
    _DEV_MARKER = {marker}
    _DEV_ITEM = struct.Struct(">II")

    def to_bytes(self):
        return self._EXT_HDR.pack(self._DEV_MARKER, 1) + self._DEV_ITEM.pack(1, 2)

    def from_bytes(self, b):
        {parser_body}
"""


# a parser that satisfies the ordering invariant: one while peek loop
# dispatching every marker, each branch ending in `continue`
_LOOPED_PARSER = """\
i = 0
        while i < len(b):
            m = self._EXT_HDR.unpack_from(b, i)[0]
            if m == self._DEV_MARKER:
                self._DEV_ITEM.unpack_from(b, i + 6)
                i += 14
                continue
            break
        return i"""

_RPC = "sparkrdma_tpu_torch/fake_rpc.py"


def test_wire_pass_catches_low_marker_value():
    src = _WIRE_TEMPLATE.format(marker="0x0010", parser_body=_LOOPED_PARSER)
    found = _same_as_jax(_RPC, src, "wire-markers")
    assert len(found) == 1
    assert "0xFF00" in found[0].message


def test_wire_pass_catches_one_sided_extension():
    src = _WIRE_TEMPLATE.format(marker="0xFF10",
                                parser_body="return self._EXT_HDR.unpack_from(b)")
    found = _same_as_jax(_RPC, src, "wire-markers")
    assert found, "parser never touches _DEV_MARKER/_DEV_ITEM"
    assert all("parser" in f.message for f in found)
    assert any("one-sided" in f.message for f in found)


def test_wire_pass_clean_fixture_and_path_scoping():
    src = _WIRE_TEMPLATE.format(marker="0xFF10", parser_body=_LOOPED_PARSER)
    assert _same_as_jax(_RPC, src, "wire-markers") == []
    # the same planted breakage outside *rpc.py/*locations.py is out of scope
    bad = _WIRE_TEMPLATE.format(marker="0x0010", parser_body="return b")
    assert _findings(SourceFile("sparkrdma_tpu_torch/fake_other.py", bad),
                     "wire-markers") == []


def test_wire_pass_ordering_requires_peek_loop():
    # marker dispatched straight-line (no while loop): parse order is fixed
    src = _WIRE_TEMPLATE.format(
        marker="0xFF10",
        parser_body="return self._EXT_HDR, self._DEV_MARKER, self._DEV_ITEM",
    )
    found = _same_as_jax(_RPC, src, "wire-markers")
    assert len(found) == 1
    assert "peek loop" in found[0].message


def test_wire_pass_ordering_requires_continue_per_branch():
    # loop dispatches the marker but the branch falls through instead of
    # re-peeking: every extension after it parses order-dependently
    body = _LOOPED_PARSER.replace("                continue\n", "")
    src = _WIRE_TEMPLATE.format(marker="0xFF10", parser_body=body)
    found = _same_as_jax(_RPC, src, "wire-markers")
    assert len(found) == 1
    assert "continue" in found[0].message


def test_wire_pass_reads_the_ports_codecs():
    """The pass reaches the port's trailing extensions 0xFFF9-0xFFFF in
    ``rpc.py`` and ``locations.py``, and they satisfy it."""
    files = [f for f in load_tree(ROOT) if f.path in (
        "sparkrdma_tpu_torch/rpc.py", "sparkrdma_tpu_torch/locations.py")]
    markers = {n.value.value for f in files for n in __import__("ast").walk(f.tree)
               if isinstance(n, __import__("ast").Assign) and len(n.targets) == 1
               and getattr(n.targets[0], "id", "").endswith("_MARKER")
               and isinstance(n.value, __import__("ast").Constant)}
    assert set(range(0xFFF9, 0x10000)) <= markers
    assert run_passes(files, ROOT, only=["wire-markers"]) == []


# -- tenant-scope ----------------------------------------------------------


def test_tenant_pass_catches_unscoped_spawn():
    src = textwrap.dedent(
        """\
        import threading


        def _worker():
            return 1


        def spawn():
            t = threading.Thread(target=_worker, daemon=True)
            t.start()
        """
    )
    found = _same_as_jax("sparkrdma_tpu_torch/shuffle/fake_spawn.py", src, "tenant-scope")
    assert len(found) == 1
    assert "_worker" in found[0].message
    assert "tenant_scope" in found[0].message


def test_tenant_pass_accepts_scoped_closure_and_reentering_target():
    src = textwrap.dedent(
        """\
        import threading

        from sparkrdma_tpu_torch import tenancy
        from sparkrdma_tpu_torch.tenancy import tenant_scope


        def _retry(tenant):
            with tenant_scope(tenant):
                return 1


        def spawn(tenant, fn):
            threading.Thread(target=tenancy.scoped(tenant, fn)).start()
            threading.Timer(0.1, _retry).start()
        """
    )
    assert _same_as_jax("sparkrdma_tpu_torch/shuffle/fake_spawn.py", src,
                        "tenant-scope") == []


# -- suppression syntax ----------------------------------------------------


def test_bare_suppression_is_itself_a_finding():
    sf = SourceFile(
        "tests/fake_knob_user.py",
        f'K = "{_KNOB_PREFIX}fetch.bogus_typo_knob"  {_SUPPRESS}[knob-registry]\n',
    )
    found = _findings(sf, "knob-registry")
    # the knob finding survives AND the reasonless ignore is reported
    assert {f.pass_id for f in found} == {"knob-registry", "suppression"}
    assert any("requires a ': <reason>'" in f.message for f in found)


def test_reasoned_suppression_silences_the_finding():
    sf = SourceFile(
        "tests/fake_knob_user.py",
        f'K = "{_KNOB_PREFIX}fetch.bogus_typo_knob"  '
        f"{_SUPPRESS}[knob-registry]: fixture for the docs example\n",
    )
    assert _findings(sf, "knob-registry") == []


def test_comment_line_suppression_covers_next_line():
    sf = SourceFile(
        "tests/fake_knob_user.py",
        f"{_SUPPRESS}[all]: fixture for the docs example\n"
        f'K = "{_KNOB_PREFIX}fetch.bogus_typo_knob"\n',
    )
    assert _findings(sf, "knob-registry") == []


def test_unknown_pass_id_in_suppression_is_reported():
    sf = SourceFile(
        "tests/fake_knob_user.py",
        f"x = 1  {_SUPPRESS}[no-such-pass]: whatever\n",
    )
    found = run_passes([sf], ROOT, only=["knob-registry"])
    assert len(found) == 1
    assert found[0].pass_id == "suppression"
    assert "unknown pass id" in found[0].message


# -- lock-order detector ---------------------------------------------------


def test_detector_flags_ab_ba_cycle():
    det = LockOrderDetector()
    a = named_lock("t.cycle.A", detector=det)
    b = named_lock("t.cycle.B", detector=det)
    det.enable()
    try:
        with a:
            with b:
                pass
        with b:
            with a:  # closes the cycle — flagged without a real deadlock
                pass
    finally:
        det.disable()
    assert any("lock-order cycle" in v for v in det.violations)
    assert any("t.cycle.A" in v and "t.cycle.B" in v for v in det.violations)


def test_detector_consistent_order_is_clean():
    det = LockOrderDetector()
    a = named_lock("t.ord.A", detector=det)
    b = named_lock("t.ord.B", detector=det)
    det.enable()
    try:
        for _ in range(3):
            with a:
                with b:
                    pass
    finally:
        det.disable()
    assert det.violations == []
    assert det.edges == {"t.ord.A": {"t.ord.B"}}


def test_detector_flags_same_name_nesting_unless_opted_in():
    det = LockOrderDetector()
    l1 = named_lock("t.pair", detector=det)
    l2 = named_lock("t.pair", detector=det)
    det.enable()
    try:
        with l1:
            with l2:
                pass
    finally:
        det.disable()
    assert any("same-name lock nesting" in v for v in det.violations)

    det2 = LockOrderDetector()
    m1 = named_lock("t.pair2", allow_self_nest=True, detector=det2)
    m2 = named_lock("t.pair2", allow_self_nest=True, detector=det2)
    det2.enable()
    try:
        with m1:
            with m2:
                pass
    finally:
        det2.disable()
    assert det2.violations == []


def test_detector_flags_sleep_under_hot_lock():
    det = LockOrderDetector()
    hot = named_lock("t.hotpath", hot=True, detector=det)
    cold = named_lock("t.coldpath", detector=det)
    det.enable()
    try:
        with cold:
            time.sleep(0)  # cold lock: allowed
        with hot:
            time.sleep(0)  # hot lock: flagged
    finally:
        det.disable()
    assert len([v for v in det.violations if "time.sleep" in v]) == 1
    assert any("t.hotpath" in v for v in det.violations)


def test_detector_recursive_reacquire_is_not_self_nesting():
    det = LockOrderDetector()
    r = named_lock("t.rec", recursive=True, detector=det)
    det.enable()
    try:
        with r:
            with r:
                pass
    finally:
        det.disable()
    assert det.violations == []


def test_disabled_detector_records_nothing():
    det = LockOrderDetector()
    a = named_lock("t.off.A", detector=det)
    b = named_lock("t.off.B", detector=det)
    with a:
        with b:
            pass
    with b:
        with a:
            pass
    assert det.edges == {}
    assert det.violations == []


def test_seams_are_the_detectors_locks():
    """The host-plane copies' seams are the port's analysis planes: their
    ``named_lock`` / ``OrderedLock`` are the detector's (a lock a port
    module makes is recorded), and their ``schedule_point`` is the model
    checker's, which does nothing while no scheduler runs."""
    from sparkrdma_tpu_torch.analysis.modelcheck import sched
    from sparkrdma_tpu_torch.metastore import store as store_module
    from sparkrdma_tpu_torch.shuffle import manager

    assert manager.named_lock is named_lock and manager.OrderedLock is lockorder.OrderedLock
    assert store_module.schedule_point is sched.schedule_point
    assert lockorder._sched is sched and sched.active is None
    sched.schedule_point("lock", "idle")
    from sparkrdma_tpu_torch.metastore.store import ShardedMetaStore
    from sparkrdma_tpu_torch.utils.config import TpuShuffleConf

    store = ShardedMetaStore(TpuShuffleConf(), role="t-seam")
    assert isinstance(store._topology, lockorder.OrderedLock)
    assert store._topology.name == "metastore.topology"
    assert store._topology._det is lockorder.default
    det = lockorder.default
    was = det.enabled
    if not was:
        det.reset()
    det.enable()
    try:
        outer, inner = named_lock("t.seam.outer"), named_lock("t.seam.inner")
        with outer:
            with store._topology:
                with inner:
                    pass
        edges = {a: set(bs) for a, bs in det.edges.items()}
    finally:
        if not was:
            det.disable()
            det.reset()
    assert {"metastore.topology", "t.seam.inner"} <= edges["t.seam.outer"]
    assert "t.seam.inner" in edges["metastore.topology"]


# -- both packages' detectors in one process --------------------------------


@pytest.mark.parametrize("port_disarms_first", [True, False])
def test_both_detectors_see_their_planted_blocking_calls(port_disarms_first):
    """Armed as a pytest session arms them (the JAX package's first, the
    port's on top), each detector reports the sleep and the connect
    planted under its own hot lock, in either package; after both
    disarm, ``time.sleep`` and ``socket.create_connection`` are what
    they were before (the real functions, unless a session detector is
    armed)."""
    idle = not jax_lockorder._active and not lockorder._active
    sleep0, connect0 = time.sleep, socket.create_connection
    jdet, tdet = jax_lockorder.LockOrderDetector(), LockOrderDetector()
    jhot = jax_lockorder.named_lock("t.jax.hot", hot=True, detector=jdet)
    thot = named_lock("t.port.hot", hot=True, detector=tdet)
    srv = socket.create_server(("127.0.0.1", 0))
    try:
        jdet.enable()
        tdet.enable()
        try:
            with jhot:
                time.sleep(0)
            with thot:
                time.sleep(0)
                socket.create_connection(srv.getsockname(), timeout=5).close()
        finally:
            order = (tdet, jdet) if port_disarms_first else (jdet, tdet)
            for det in order:
                det.disable()
    finally:
        srv.close()
    assert [v.split(" (")[0] for v in jdet.violations] == [
        "blocking call time.sleep while holding hot-path lock 't.jax.hot'"]
    assert [v.split(" (")[0] for v in tdet.violations] == [
        "blocking call time.sleep while holding hot-path lock 't.port.hot'",
        "blocking call socket.create_connection while holding hot-path lock 't.port.hot'"]
    assert time.sleep is sleep0 and socket.create_connection is connect0
    if idle:
        assert time.sleep is lockorder._real_sleep is jax_lockorder._real_sleep
        assert socket.create_connection is lockorder._real_create_connection


# -- whole-tree gate -------------------------------------------------------


def test_cli_lists_all_passes(capsys):
    from sparkrdma_tpu_torch.analysis.__main__ import main

    assert main(["--list"]) == 0
    assert set(PASS_IDS) == {
        "knob-registry",
        "metric-families",
        "wire-markers",
        "tenant-scope",
    }
    assert set(capsys.readouterr().out.split()) >= set(PASS_IDS)


def test_tree_is_clean():
    """The port's tree (``sparkrdma_tpu_torch/`` and ``tests/test_torch_*.py``)
    carries zero unsuppressed findings."""
    files = load_tree(ROOT)
    assert len(files) > 50  # sanity: the walk actually found the tree
    paths = {f.path for f in files}
    assert "sparkrdma_tpu_torch/utils/config.py" in paths
    assert "tests/test_torch_analysis.py" in paths
    assert not any(p.startswith("sparkrdma_tpu/") or p == "tests/test_analysis.py"
                   for p in paths)
    findings = run_passes(files, ROOT)
    assert findings == [], "\n" + "\n".join(f.render() for f in findings)


def test_load_tree_lints_a_checkout_beneath_a_build_directory(tmp_path):
    """A checkout unpacked under ``build/`` (as a ``git archive`` check
    is) is linted whole; ``build`` inside the checkout is skipped."""
    root = tmp_path / "build" / "checkout"
    for rel in ("sparkrdma_tpu_torch/a.py", "sparkrdma_tpu_torch/sub/b.py",
                "tests/test_torch_c.py", "tests/test_other.py",
                "sparkrdma_tpu_torch/build/skipped.py"):
        (root / rel).parent.mkdir(parents=True, exist_ok=True)
        (root / rel).write_text("x = 1\n")
    assert [f.path for f in load_tree(root)] == [
        "sparkrdma_tpu_torch/a.py", "sparkrdma_tpu_torch/sub/b.py", "tests/test_torch_c.py"]


def test_cli_exits_zero_on_the_tree_and_nonzero_on_a_finding(tmp_path):
    env = dict(os.environ)
    out = subprocess.run([sys.executable, "-m", "sparkrdma_tpu_torch.analysis"], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.startswith("analysis: clean (")
    # a checkout with one planted typo in a port test fails the run
    (tmp_path / "sparkrdma_tpu_torch").mkdir()
    (tmp_path / "tests").mkdir()
    (tmp_path / "tests" / "test_torch_plant.py").write_text(
        f'K = "{_KNOB_PREFIX}fetch.bogus_typo_knob"\n')
    out = subprocess.run([sys.executable, "-m", "sparkrdma_tpu_torch.analysis", "--root",
                          str(tmp_path), "--pass", "knob-registry"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 1
    assert "tests/test_torch_plant.py:1: [knob-registry]" in out.stdout


def test_lock_order_plugin_run_of_port_tests_is_clean():
    """Port test files under ``SPARKRDMA_LOCK_ORDER=1`` with the port's
    plugin: the session passes and the port's section reports a clean
    lock order with edges recorded."""
    env = dict(os.environ, SPARKRDMA_LOCK_ORDER="1", JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider", "-p", "no:xdist",
         "-p", "no:randomly", "-p", "sparkrdma_tpu_torch.analysis.pytest_plugin",
         "tests/test_torch_metastore.py",
         "tests/test_torch_elastic.py::test_replica_never_serves_while_its_primary_lives",
         "tests/test_torch_elastic.py::test_inprocess_context_survives_executor_loss_with_replication"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stdout[-4000:] + out.stderr[-2000:]
    text = out.stdout
    assert "lock-order: sparkrdma_tpu_torch" in text
    section = text.split("lock-order: sparkrdma_tpu_torch", 1)[1]
    line = next(ln for ln in section.splitlines() if ln.startswith("clean:"))
    names, edges = int(line.split()[1]), int(line.split(",")[1].split()[0])
    assert names > 0 and edges > 0 and line.endswith("0 violations")
