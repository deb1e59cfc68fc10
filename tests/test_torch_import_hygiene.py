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
    assert len(res["imported"]) >= 15
    assert res["bad"] == []


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
    from sparkrdma_tpu_torch.utils.torch_compat import resolve_device

    return {
        "make_mesh": lambda: make_mesh().device,
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
