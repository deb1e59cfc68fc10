"""The port package stands alone: it loads neither jax nor the JAX
package, and its entry points never pick the CPU unless asked."""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "sparkrdma_tpu_torch"

FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+sparkrdma_tpu(?!_torch)\b"
    r"|from\s+sparkrdma_tpu(?!_torch)\b)",
    re.MULTILINE,
)


def _port_sources():
    return (sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
            + sorted((ROOT / "scripts").glob("*.py")))


def test_importing_every_port_module_loads_no_jax():
    script = (
        "import importlib, json, pkgutil, sys\n"
        "import sparkrdma_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, 'sparkrdma_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'sparkrdma_tpu' or m.startswith('sparkrdma_tpu.'))\n"
        "print(json.dumps({'imported': names, 'bad': bad}))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", script], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    # every module of the port: a subpackage that fails to import
    # would drop its modules from the walk
    # (117 before the model checker's 6 modules and multihost came and
    # utils/seams went)
    assert len(res["imported"]) >= 123
    assert set(ENGINE_MODULES) <= set(res["imported"])
    assert set(NATIVE_MODULES) <= set(res["imported"])
    assert set(OBS_MODULES) <= set(res["imported"])
    assert set(ELASTIC_CLI_ANALYSIS_MODULES) <= set(res["imported"])
    assert set(MODELCHECK_MULTIHOST_MODULES) <= set(res["imported"])
    assert res["bad"] == []


ENGINE_MODULES = [
    "sparkrdma_tpu_torch.engine.rdd",
    "sparkrdma_tpu_torch.engine.context",
    "sparkrdma_tpu_torch.engine.worker",
    "sparkrdma_tpu_torch.engine.cluster",
    "sparkrdma_tpu_torch.obs.critpath",
    "sparkrdma_tpu_torch.obs.attr",
    "sparkrdma_tpu_torch.obs.profiler",
    "sparkrdma_tpu_torch.obs.telemetry",
    "sparkrdma_tpu_torch.elastic",
    "sparkrdma_tpu_torch.elastic.speculation",
]


def test_engine_modules_alone_load_no_jax():
    """The engine's modules, each imported first in a fresh interpreter
    (no other port module imported before it), load neither jax nor the
    JAX package; ``TpuContext`` resolves through the package's lazy
    export."""
    script = (
        "import importlib, json, sys\n"
        f"names = {ENGINE_MODULES!r}\n"
        "for n in names: importlib.import_module(n)\n"
        "from sparkrdma_tpu_torch.engine import TpuContext\n"
        "assert TpuContext.__module__ == 'sparkrdma_tpu_torch.engine.context'\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'sparkrdma_tpu' or m.startswith('sparkrdma_tpu.'))\n"
        "print(json.dumps(bad))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", script], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


NATIVE_MODULES = [
    "sparkrdma_tpu_torch.native",
    "sparkrdma_tpu_torch.native.transport_lib",
    "sparkrdma_tpu_torch.native.arena",
    "sparkrdma_tpu_torch.transport.native_node",
]


def test_native_modules_alone_load_no_jax_and_build_nothing():
    """The native plane's modules, imported first in a fresh
    interpreter, load neither jax nor the JAX package, and importing
    them builds and loads no library (that happens at first use)."""
    script = (
        "import importlib, json, sys\n"
        f"names = {NATIVE_MODULES!r}\n"
        "for n in names: importlib.import_module(n)\n"
        "from sparkrdma_tpu_torch.native import arena, transport_lib as tl\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'sparkrdma_tpu' or m.startswith('sparkrdma_tpu.'))\n"
        "print(json.dumps([bad, tl.LIBRARY.lib is None and arena.LIBRARY.lib is None,"
        " tl.build_seconds]))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", script], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == [[], True, {}]


OBS_MODULES = [
    "sparkrdma_tpu_torch.obs.journal",
    "sparkrdma_tpu_torch.obs.timeseries",
    "sparkrdma_tpu_torch.obs.export",
    "sparkrdma_tpu_torch.obs.capacity",
    "sparkrdma_tpu_torch.obs.trend",
    "sparkrdma_tpu_torch.obs.diagnose",
    "sparkrdma_tpu_torch.obs.slo",
    "sparkrdma_tpu_torch.obs.telemetry",
]


@pytest.mark.parametrize("name", OBS_MODULES)
def test_obs_module_alone_loads_no_jax_and_arms_nothing(name):
    """Each module of the telemetry and journal plane, imported first in
    a fresh interpreter, loads neither jax nor the JAX package, arms no
    process journal and starts no thread (the hub does that when a
    driver builds it)."""
    script = (
        "import importlib, json, sys, threading\n"
        f"importlib.import_module({name!r})\n"
        "from sparkrdma_tpu_torch.obs import journal, TelemetryHub\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'sparkrdma_tpu' or m.startswith('sparkrdma_tpu.'))\n"
        "print(json.dumps([bad, journal.active_journal() is None,"
        " threading.active_count()]))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", script], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == [[], True, 1]


ELASTIC_CLI_ANALYSIS_MODULES = [
    "sparkrdma_tpu_torch.elastic.replication",
    "sparkrdma_tpu_torch.elastic.service",
    "sparkrdma_tpu_torch.obs.__main__",
    "sparkrdma_tpu_torch.version",
    "sparkrdma_tpu_torch.analysis",
    "sparkrdma_tpu_torch.analysis.__main__",
    "sparkrdma_tpu_torch.analysis.knobs",
    "sparkrdma_tpu_torch.analysis.metrics_pass",
    "sparkrdma_tpu_torch.analysis.tenancy_pass",
    "sparkrdma_tpu_torch.analysis.wire",
    "sparkrdma_tpu_torch.analysis.lockorder",
    "sparkrdma_tpu_torch.analysis.pytest_plugin",
]


@pytest.mark.parametrize("name", ELASTIC_CLI_ANALYSIS_MODULES)
def test_elastic_cli_and_analysis_module_alone_loads_no_jax(name):
    """Each module of the elastic plane, the obs CLI and the invariant
    suite, imported first in a fresh interpreter, loads neither jax nor
    the JAX package, initialises no CUDA, patches no blocking call and
    starts no thread."""
    script = (
        "import importlib, json, socket, sys, threading, time\n"
        "sleep0, connect0 = time.sleep, socket.create_connection\n"
        f"importlib.import_module({name!r})\n"
        "t = sys.modules.get('torch')\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'sparkrdma_tpu' or m.startswith('sparkrdma_tpu.'))\n"
        "print(json.dumps([bad, bool(t is not None and t.cuda.is_initialized()),"
        " time.sleep is sleep0 and socket.create_connection is connect0,"
        " threading.active_count()]))\n"
    )
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "SPARKRDMA_LOCK_ORDER")}
    out = subprocess.run(
        [sys.executable, "-c", script], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == [[], False, True, 1]


MODELCHECK_MULTIHOST_MODULES = [
    "sparkrdma_tpu_torch.analysis.modelcheck",
    "sparkrdma_tpu_torch.analysis.modelcheck.__main__",
    "sparkrdma_tpu_torch.analysis.modelcheck.explore",
    "sparkrdma_tpu_torch.analysis.modelcheck.models",
    "sparkrdma_tpu_torch.analysis.modelcheck.mutants",
    "sparkrdma_tpu_torch.analysis.modelcheck.sched",
    "sparkrdma_tpu_torch.parallel.multihost",
]


@pytest.mark.parametrize("name", MODELCHECK_MULTIHOST_MODULES)
def test_modelcheck_and_multihost_module_alone_loads_no_jax(name):
    """Each module of the model checker and the multi-process bootstrap,
    imported first in a fresh interpreter, loads neither jax nor the JAX
    package, initialises no CUDA, patches neither the blocking calls nor
    ``threading``'s waits, starts no thread and joins no process group."""
    script = (
        "import importlib, json, socket, sys, threading, time\n"
        "before = (time.sleep, time.monotonic, socket.create_connection,"
        " threading.Condition.wait, threading.Event.wait, threading.Event.set)\n"
        f"importlib.import_module({name!r})\n"
        "t = sys.modules.get('torch')\n"
        "d = sys.modules.get('torch.distributed')\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'sparkrdma_tpu' or m.startswith('sparkrdma_tpu.'))\n"
        "after = (time.sleep, time.monotonic, socket.create_connection,"
        " threading.Condition.wait, threading.Event.wait, threading.Event.set)\n"
        "print(json.dumps([bad, bool(t is not None and t.cuda.is_initialized()),"
        " before == after, threading.active_count(),"
        " bool(d is not None and d.is_available() and d.is_initialized())]))\n"
    )
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "SPARKRDMA_LOCK_ORDER")}
    out = subprocess.run(
        [sys.executable, "-c", script], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == [[], False, True, 1, False]


@pytest.mark.parametrize("module, args, says", [
    ("sparkrdma_tpu_torch.obs", ["--prefix", "no.such.prefix."], '"counters": {}'),
    ("sparkrdma_tpu_torch.elastic.service", ["--help"], "--service-id"),
    ("sparkrdma_tpu_torch.analysis", ["--list"], "knob-registry"),
    ("sparkrdma_tpu_torch.analysis.modelcheck",
     ["--model", "speculation", "--model", "quota_stall", "--walks", "3"],
     "model speculation          clean: 4 schedules"),
])
def test_port_entry_points_run_as_modules_without_jax(module, args, says):
    """``python -m`` of the obs CLI, the shuffle-service daemon, the
    analysis runner and the model checker: each exits 0 and, when it exits, has loaded neither
    jax nor the JAX package and never initialised CUDA."""
    import chip_smoke

    rc, out, err, probe = chip_smoke.obs_cli(args, module=module, timeout=120)
    assert rc == 0, err[-2000:]
    assert says in out
    assert probe == {"jax": [], "cuda_initialized": False}


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: p.name)
def test_port_source_imports_nothing_of_jax(path):
    assert not FORBIDDEN.findall(path.read_text())


def test_forbidden_pattern_spares_the_port_prefix():
    assert FORBIDDEN.search("from sparkrdma_tpu.ops import sort")
    assert FORBIDDEN.search("import sparkrdma_tpu.locations")
    assert FORBIDDEN.search("import jax.numpy as jnp")
    assert not FORBIDDEN.search("from sparkrdma_tpu_torch.ops import sort")
    assert not FORBIDDEN.search("import sparkrdma_tpu_torch")


def _entry_points():
    from sparkrdma_tpu_torch.convert import from_jax_state, params_from_jax
    from sparkrdma_tpu_torch.models import ALS, HashJoin, PageRank
    from sparkrdma_tpu_torch.models.terasort import MapShardSorter, TeraSorter
    from sparkrdma_tpu_torch.models.transformer_step import TransformerStep
    from sparkrdma_tpu_torch.ops import (
        ExchangeProgram,
        RingAttention,
        UlyssesAttention,
        make_mesh,
    )
    from sparkrdma_tpu_torch.ops.hbm_arena import DeviceBufferManager
    from sparkrdma_tpu_torch.ops.sort import device_put_columns
    from sparkrdma_tpu_torch.parallel.multihost import global_mesh
    from sparkrdma_tpu_torch.shuffle.columnar import encode_columns
    from sparkrdma_tpu_torch.utils.torch_compat import resolve_device

    frame = encode_columns([__import__("numpy").zeros(4, "uint32")])
    return {
        "make_mesh": lambda: make_mesh().device,
        "global_mesh": lambda: global_mesh().device,
        "ExchangeProgram": lambda: ExchangeProgram(make_mesh()).mesh.device,
        "resolve_device": lambda: resolve_device(),
        "DeviceBufferManager": lambda: DeviceBufferManager().device,
        "MapShardSorter": lambda: MapShardSorter()._device,
        "TeraSorter": lambda: TeraSorter().device,
        "HashJoin": lambda: HashJoin().device,
        "PageRank": lambda: PageRank().device,
        "ALS": lambda: ALS().device,
        "UlyssesAttention": lambda: UlyssesAttention().device,
        "RingAttention": lambda: RingAttention().device,
        "from_jax_state": lambda: from_jax_state(
            {"e": [(1, __import__("numpy").zeros(4, "uint8"), 4)]}, []
        )[0]["e"].device,
        "TransformerStep": lambda: TransformerStep().device,
        "device_put_columns": lambda: device_put_columns(frame)[0].device,
        "params_from_jax": lambda: params_from_jax(
            {"wq": __import__("numpy").zeros((2, 2), "float32")})["wq"].device,
    }


@pytest.mark.parametrize("name", sorted(_entry_points()))
def test_entry_points_default_to_cuda(name):
    make = _entry_points()[name]
    if torch.cuda.is_available():
        assert make().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            make()


def test_cpu_only_when_asked():
    from sparkrdma_tpu_torch.ops.hbm_arena import DeviceBufferManager
    from sparkrdma_tpu_torch.utils.torch_compat import resolve_device

    from sparkrdma_tpu_torch.models import ALS, HashJoin, PageRank
    from sparkrdma_tpu_torch.models.transformer_step import TransformerStep
    from sparkrdma_tpu_torch.ops import RingAttention, UlyssesAttention

    assert resolve_device("cpu").type == "cpu"
    for model in (HashJoin, PageRank, ALS):
        assert model(device="cpu").device.type == "cpu"
    assert DeviceBufferManager("cpu").device.type == "cpu"
    assert UlyssesAttention(device="cpu").device.type == "cpu"
    assert RingAttention(device="cpu").device.type == "cpu"
    assert TransformerStep(device="cpu").device.type == "cpu"
    from sparkrdma_tpu_torch.ops.sort import device_put_columns
    from sparkrdma_tpu_torch.parallel.multihost import global_mesh
    from sparkrdma_tpu_torch.shuffle.columnar import encode_columns

    frame = encode_columns([__import__("numpy").zeros(4, "uint32")])
    assert device_put_columns(frame, "cpu")[0].device.type == "cpu"
