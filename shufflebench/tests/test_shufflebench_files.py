"""BENCHMARK.json and the files it names hang together and keep to the
benchmark's contract."""

import json
import re

import pytest

from shufflebench import cells

BENCH = cells.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert len((cells.CHECKOUT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert BENCH["paths"] == ["shufflebench"]
    assert BENCH["command"][:2] == ["python3", "-m"]


@pytest.mark.parametrize("cell", CELLS)
def test_workload_names_existing_files(cell):
    c = cells.load_cell(cell)  # raises where a file is missing or disagrees
    assert cells.entry_module(c.entry).Entry
    check = cells.check_module(c.check)
    assert callable(check.compare) and callable(check.control)
    assert callable(cells.generator_module(c.traffic["kind"]).make)
    assert c.limits and all(v == 0 for v in c.limits.values())


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(cfg):
    path = cells.CHECKOUT / cfg["file"]
    assert path.parent == cells.HERE / "configs"
    body = json.loads(path.read_text())
    assert body["name"] == cfg["name"] == path.stem
    assert body["source"] == cfg["source"]
    assert body["reduced"] == cfg["reduced"]
    assert all(k in body for k in cfg["reduced"])
    assert any(w["config"] == cfg["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_has_reader_and_reports_its_moves(metric):
    assert callable(cells.metric_reader(metric["name"]))
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    if "moves" in metric:
        moved = e2e[metric["moves"]]
        for cell in metric["workloads"]:
            assert "workloads" not in moved or cell in moved["workloads"], cell
    for cell in metric.get("workloads", []):
        assert cell in CELLS


def test_names_units_and_text_fields():
    names = [m["name"] for m in METRICS] + CELLS + [c["name"] for c in BENCH["configs"]]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in BENCH["workloads"]]:
        assert NAME.match(n), n
    for m in METRICS:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for text in ([w["why"] for w in BENCH["workloads"]] + [c["why"] for c in BENCH["configs"]]
                 + [m["layer"] for m in BENCH["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    for cell in CELLS:
        c = cells.load_cell(cell)
        e2e = {m["name"] for m in c.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert c.per_layer
        assert {w["config"] for w in BENCH["workloads"]}
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_bounds_and_sources():
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert "bound" not in m
        assert m["source"] in ("device_trace", "program_span", "program_counter",
                               "host_clock")
        assert m["workloads"]


def test_run_seconds_fit_a_full_check():
    rs = BENCH["run_seconds"]
    assert 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
