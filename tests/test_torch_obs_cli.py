"""The port's obs CLI (``python -m sparkrdma_tpu_torch.obs``) against the
JAX package's (``python -m sparkrdma_tpu.obs``): the counterparts of the
CLI tests of ``tests/test_critpath.py``, ``tests/test_slo.py``,
``tests/test_telemetry.py``, ``tests/test_obs.py`` and
``tests/test_profiler.py``, plus ``--timeline`` and ``--folded``.

Each artifact is made once by the port (a ``TpuContext`` job's Chrome
trace and breakdown, a diagnosis, a registry snapshot, a flight record
with profile windows and journal events) and saved; both CLIs render
the same file, and their outputs are compared. The ``--demo`` runs are
child processes of the port's CLI (``chip_smoke.obs_cli``), which also
report that the child loaded neither jax nor the JAX package and never
initialised CUDA."""

import json
import re

import pytest
import torch

import chip_smoke
from sparkrdma_tpu.obs import get_registry as jax_registry
from sparkrdma_tpu.obs import journal as jax_journal
from sparkrdma_tpu.obs.__main__ import main as jax_main

from sparkrdma_tpu_torch.engine.context import TpuContext
from sparkrdma_tpu_torch.obs import journal, to_chrome_trace
from sparkrdma_tpu_torch.obs.__main__ import main as port_main
from sparkrdma_tpu_torch.obs.diagnose import build_diagnosis
from sparkrdma_tpu_torch.obs.metrics import MetricsRegistry
from sparkrdma_tpu_torch.obs.slo import Breach
from sparkrdma_tpu_torch.obs.telemetry import TelemetryHub
from sparkrdma_tpu_torch.utils.config import TpuShuffleConf

torch.set_num_threads(1)

DEMO_S = 240


@pytest.fixture(autouse=True, scope="module")
def _process_state_left_clean():
    """The JAX CLI runs here count into nothing, but both journals are
    process-wide: reset them, and zero the JAX registry at the end."""
    for mod in (jax_journal, journal):
        mod.reset()
    yield
    for mod in (jax_journal, journal):
        mod.reset()
    jax_registry().reset()


def _both(argv, capsys):
    """``argv`` through the JAX CLI, then the port's: each one's exit
    code and standard output."""
    out = []
    for main in (jax_main, port_main):
        capsys.readouterr()
        rc = main(list(argv))
        out.append((rc, capsys.readouterr().out))
    return out


@pytest.fixture(scope="module")
def job_artifacts():
    """A port ``TpuContext`` job's output, breakdown and Chrome trace (the
    JAX test's ``job_artifacts``, through the port)."""
    with TpuContext(num_executors=2, conf=TpuShuffleConf({}), task_threads=4) as ctx:
        rdd = (ctx.parallelize(range(8000), 4).map(lambda x: (x % 97, 1))
               .reduce_by_key(lambda a, b: a + b, num_partitions=4))
        out = dict(ctx.run_job(rdd))
        bd = ctx.last_breakdown
        doc = to_chrome_trace()
    return {"out": out, "breakdown": bd, "trace": doc}


def test_critical_path_cli_over_saved_trace(job_artifacts, tmp_path, capsys):
    f = tmp_path / "trace.json"
    f.write_text(json.dumps(job_artifacts["trace"]))
    (jrc, want), (rc, got) = _both(["--critical-path", str(f)], capsys)
    assert rc == jrc == 0
    assert got == want
    assert "window: job.run span" in got
    assert "coverage" in got
    assert "top segments:" in got


def test_critical_path_cli_over_stored_breakdown(job_artifacts, tmp_path, capsys):
    f = tmp_path / "artifact.json"
    f.write_text(json.dumps({"workloads": [],
                             "breakdown": job_artifacts["breakdown"].to_dict()}))
    (jrc, want), (rc, got) = _both(["--critical-path", str(f)], capsys)
    assert rc == jrc == 0
    assert got == want
    assert "stored breakdown" in got


def _breach(executor=""):
    return Breach(objective="task-p99", kind="latency", severity="page", wall_ms=1000,
                  executor=executor, burn_fast=31.2, burn_fast_short=28.9)


def test_obs_cli_diagnose_renders_artifacts_and_ledgers(tmp_path, capsys):
    diag = build_diagnosis(None, _breach(executor="e1"))
    solo = tmp_path / "diag.json"
    solo.write_text(json.dumps(diag))
    (jrc, want), (rc, got) = _both(["--diagnose", str(solo)], capsys)
    assert rc == jrc == 0 and got == want
    assert "SLO diagnosis" in got
    ledger = tmp_path / "ledger.json"
    ledger.write_text(json.dumps({"slo": {
        "breach_records": [_breach(executor="e1").to_dict()],
        "diagnosis_records": [diag],
    }}))
    (jrc, want), (rc, got) = _both(["--diagnose", str(ledger)], capsys)
    assert rc == jrc == 0 and got == want
    assert "task-p99" in got
    bare = tmp_path / "bare.json"
    bare.write_text(json.dumps({"workloads": []}))
    assert [r for r, _ in _both(["--diagnose", str(bare)], capsys)] == [2, 2]


_SAMPLE_RE = re.compile(
    r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[a-zA-Z_][a-zA-Z0-9_]*="(\\.|[^"\\\n])*"'
    r'(,[a-zA-Z_][a-zA-Z0-9_]*="(\\.|[^"\\\n])*")*\})? \S+$'
)


def _validate_openmetrics(text):
    """``tests/test_telemetry.py``'s line-format validator: every line is
    HELP, TYPE, EOF, or a sample of the exposition grammar whose family a
    TYPE line declared first; the document ends with # EOF."""
    lines = text.splitlines()
    assert lines[-1] == "# EOF"
    typed = {}
    for ln in lines[:-1]:
        if ln.startswith("# HELP ") or ln.startswith("# TYPE "):
            _, kind, family, rest = ln.split(" ", 3)
            if kind == "TYPE":
                typed[family] = rest
            continue
        assert _SAMPLE_RE.match(ln), f"bad sample line: {ln!r}"
        name = ln.split("{", 1)[0].split(" ", 1)[0]
        candidates = {name}
        for suffix in ("_total", "_bucket", "_sum", "_count"):
            if name.endswith(suffix):
                candidates.add(name[: -len(suffix)])
        assert candidates & typed.keys(), f"sample without TYPE: {ln!r}"
    return typed


def test_obs_cli_openmetrics_and_from_snapshot(tmp_path, capsys):
    reg_file = tmp_path / "artifact.json"
    reg = MetricsRegistry()
    reg.counter("cli.n", role="x").inc(5)
    reg_file.write_text(json.dumps({"obs_registry": reg.snapshot()}))
    texts = []
    for name, main in (("jax", jax_main), ("port", port_main)):
        out_file = tmp_path / f"{name}.prom"
        assert main(["--openmetrics", str(out_file), "--from-snapshot", str(reg_file)]) == 0
        texts.append(out_file.read_text())
    assert texts[1] == texts[0]
    _validate_openmetrics(texts[1])
    assert 'cli_n_total{role="x"} 5' in texts[1]
    # '-' writes to standard output, the same text
    (jrc, want), (rc, got) = _both(["--openmetrics", "-", "--from-snapshot", str(reg_file)],
                                   capsys)
    assert rc == jrc == 0 and got == want == texts[0]


def _flight_record(tmp_path):
    """A port hub's flight record: one executor's window with a profile
    table, a failed group, and the process journal's events."""
    journal.reset()
    reg = MetricsRegistry()
    hub = TelemetryHub(role="drv", registry=reg, interval_ms=100, ring_size=8)
    hub.ingest({"v": 1, "executor_id": "e0", "seq": 1, "wall_ms": 100, "interval_ms": 100,
                "counters": {"c": 1}, "gauges": {}, "histograms": {},
                "profile": {"hz": 199.0, "rows": [
                    ["alice", "host-read", "main;fetch;socket.recv", 7],
                    ["alice", "decode", "main;reader;decode", 3],
                    ["bob", "other", "main;idle", 2]]}})
    for kind, ex in (("circuit.open", "e0"), ("quota.block", "e1"), ("elastic.promote", "e0")):
        journal.emit(kind, role="drv", executor=ex)
    err = RuntimeError("boom")
    err.shuffle_id, err.partition_id = 7, 3
    path = hub.flight_record("unit_abort", error=err, path=str(tmp_path / "flight.json"))
    hub.stop()
    return path


def test_obs_cli_flight_recorder_pretty_printer(tmp_path, capsys):
    path = _flight_record(tmp_path)
    (jrc, want), (rc, got) = _both(["--flight-recorder", path], capsys)
    assert rc == jrc == 0 and got == want
    assert "unit_abort" in got
    assert "shuffle_id=7" in got and "partition_id=3" in got
    assert "e0: 1 windows" in got


def test_obs_cli_timeline_over_flight_record_and_event_list(tmp_path, capsys):
    path = _flight_record(tmp_path)
    (jrc, want), (rc, got) = _both(["--timeline", path], capsys)
    assert rc == jrc == 0 and got == want
    assert "circuit.open" in got and "elastic.promote" in got
    events = tmp_path / "events.json"
    with open(path) as f:
        events.write_text(json.dumps(json.load(f)["journal"]))
    (jrc, want2), (rc, got2) = _both(["--timeline", str(events)], capsys)
    assert rc == jrc == 0 and got2 == want2 == got
    empty = tmp_path / "empty.json"
    empty.write_text(json.dumps({"workloads": []}))
    assert [r for r, _ in _both(["--timeline", str(empty)], capsys)] == [2, 2]


def test_obs_cli_folded_and_flamegraph_from_flight_record(tmp_path, capsys):
    path = _flight_record(tmp_path)
    (jrc, want), (rc, got) = _both(["--folded", "-", "--from-snapshot", path], capsys)
    assert rc == jrc == 0 and got == want
    assert "tenant:alice" in got and "socket.recv 7" in got
    pages = []
    for name, main in (("jax", jax_main), ("port", port_main)):
        html = tmp_path / f"{name}.html"
        assert main(["--flamegraph", str(html), "--from-snapshot", path]) == 0
        pages.append(html.read_text())
    assert pages[1] == pages[0] and "</html>" in pages[1]
    # no samples: both refuse
    bare = tmp_path / "bare.json"
    bare.write_text(json.dumps({"kind": "sparkrdma_flight_record"}))
    assert [r for r, _ in _both(["--folded", "-", "--from-snapshot", str(bare)], capsys)] \
        == [2, 2]


def test_obs_cli_demo(tmp_path):
    trace_path = tmp_path / "cli_trace.json"
    rc, out, err, probe = chip_smoke.obs_cli(
        ["--demo", "--trace-out", str(trace_path), "--indent", "0"], timeout=DEMO_S)
    assert rc == 0, err[-2000:]
    assert probe == {"jax": [], "cuda_initialized": False}
    snap = json.loads(out)
    layers = {k.split(".")[0] for k in snap["counters"]}
    assert {"transport", "rpc", "writer", "mempool", "reader"} <= layers
    doc = json.loads(trace_path.read_text())
    names = {e["name"] for e in doc["traceEvents"] if e.get("ph") == "X"}
    assert {"shuffle.publish", "shuffle.resolve", "shuffle.fetch"} <= names


def test_cli_demo_writes_folded_and_flamegraph(tmp_path):
    html = tmp_path / "flame.html"
    folded = tmp_path / "stacks.folded"
    rc, out, err, probe = chip_smoke.obs_cli(
        ["--demo", "--flamegraph", str(html), "--folded", str(folded)], timeout=DEMO_S)
    assert rc == 0, err[-2000:]
    assert probe == {"jax": [], "cuda_initialized": False}
    text = folded.read_text()
    lines = [ln for ln in text.splitlines() if ln.strip()]
    assert lines and all(ln.rsplit(" ", 1)[1].isdigit() for ln in lines)
    assert "tenant:" in text and "span:" in text
    page = html.read_text()
    assert "</html>" in page and "tenant:" in page
    # the saved folded text renders alike through both CLIs' profile hubs
    assert f"wrote {folded}" in out and f"wrote {html}" in out


def test_cli_probe_sees_the_jax_package():
    """The probe's teeth: the JAX CLI's child reports the JAX package."""
    rc, out, err, probe = chip_smoke.obs_cli(["--prefix", "no.such.prefix."],
                                             module="sparkrdma_tpu.obs", timeout=DEMO_S)
    assert rc == 0, err[-2000:]
    assert "sparkrdma_tpu.obs" in probe["jax"]
    rc, out, err, probe = chip_smoke.obs_cli(["--prefix", "no.such.prefix."], timeout=DEMO_S)
    assert rc == 0 and probe["jax"] == [] and json.loads(out)["counters"] == {}
