"""Finding a cell's files by name.

``BENCHMARK.json`` at the checkout's root lists the cells and metrics;
each of them has files of its own here:

- ``workloads/<cell>.json``: the cell's configuration, traffic, entry,
  check, the limits of the numbers its check compares;
- ``configs/<config>.json``: the deployment (sizes, guarantees);
- ``traffic/<traffic>.json``: parameters only; its ``kind`` names the
  ``generators/<kind>.py`` that ``generator.py`` hands them to;
- ``entries/<entry>.py``: set-up and one stage of the path under test;
- ``reference/<check>.py``: the plain reference and its comparison;
- ``metrics/<metric>.py``: the reader of one metric.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent
CHECKOUT = HERE.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
MODULE = re.compile(r"^[A-Za-z_][A-Za-z0-9_]{0,63}$")


def _named(name: str, pattern=NAME) -> str:
    if not isinstance(name, str) or not pattern.match(name):
        raise ValueError(f"not a valid name: {name!r}")
    return name


def load_json(path: Path) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def benchmark(root: Path = CHECKOUT) -> dict:
    return load_json(root / "BENCHMARK.json")


def _reported(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


@dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    entry: str
    check: str
    limits: Dict[str, float]
    end_to_end: List[dict] = field(default_factory=list)
    per_layer: List[dict] = field(default_factory=list)


def load_cell(name: str, bench: Optional[dict] = None) -> Cell:
    """The cell ``name`` with everything its files say."""
    bench = benchmark() if bench is None else bench
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"BENCHMARK.json has no workload {name!r}")
    listed = entries[name]
    wl = load_json(HERE / "workloads" / f"{_named(name)}.json")
    for key in ("config", "traffic"):
        if wl[key] != listed[key]:
            raise ValueError(f"{name}: workloads/{name}.json names {key} "
                             f"{wl[key]!r}, BENCHMARK.json {listed[key]!r}")
    return Cell(
        name=name,
        chips=int(listed["chips"]),
        config_name=wl["config"],
        config=load_json(HERE / "configs" / f"{_named(wl['config'])}.json"),
        traffic_name=wl["traffic"],
        traffic=load_json(HERE / "traffic" / f"{_named(wl['traffic'])}.json"),
        entry=_named(wl["entry"], MODULE),
        check=_named(wl["check"], MODULE),
        limits={k: float(v) for k, v in wl["limits"].items()},
        end_to_end=[m for m in bench["end_to_end"] if _reported(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reported(m, name)],
    )


def entry_module(name: str):
    return importlib.import_module(f"shufflebench.entries.{_named(name, MODULE)}")


def check_module(name: str):
    """``reference/<name>.py``: ``compare(judged, stage_counts, inputs,
    config)`` and ``control(inputs, config)``."""
    return importlib.import_module(f"shufflebench.reference.{_named(name, MODULE)}")


def generator_module(kind: str):
    """``generators/<kind>.py``: ``make(traffic, config, g, device)``."""
    return importlib.import_module(f"shufflebench.generators.{_named(kind, MODULE)}")


def metric_reader(name: str) -> Callable:
    """``read(run) -> float or None`` from ``metrics/<name>.py`` (a file
    name may hold dots, so it is loaded by path)."""
    path = HERE / "metrics" / f"{_named(name)}.py"
    spec = importlib.util.spec_from_file_location(
        "shufflebench.metrics." + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
