"""Each entry at a tiny size on the CPU against the reference, the
generator, the result line, and the runs that must print no result."""

import json
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

from shufflebench import cells, generator, run

CELLS = [w["name"] for w in cells.benchmark()["workloads"]]
SEED = 2 ** 31 + 1234  # more than 32 signed bits hold


@pytest.mark.parametrize("name", CELLS)
def test_entry_against_reference_on_cpu(name, tiny_cell, cpu):
    cell = tiny_cell(name)
    res = run.run_cell(cell, SEED, 0.2, False, cpu, time.perf_counter())
    assert res["correct"], res["numbers"]
    assert set(res["numbers"]) == set(cell.limits)
    assert all(v == 0 for v in res["numbers"].values())
    assert res["attempted"] >= 1 and res["failed"] == 0


@pytest.mark.parametrize("name", CELLS)
def test_result_line_keys(name, tiny_cell, cpu):
    cell = tiny_cell(name)
    res = run.run_cell(cell, 7, 0.05, False, cpu, time.perf_counter())
    line = run.result_line(res, cell, traced=False)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    for k, c in line["checks"].items():
        assert c == {"value": res["numbers"][k], "limit": cell.limits[k]}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    json.dumps(line)
    per_layer = run.result_line(res, cell, traced=True)["metrics"]
    assert set(per_layer) <= {m["name"] for m in cell.per_layer}


@pytest.mark.parametrize("cfg", [c["name"] for c in cells.benchmark()["configs"]])
def test_generator_is_seeded_and_sized(cfg, cpu):
    from shufflebench.tests.conftest import TINY

    wl = next(w for w in cells.benchmark()["workloads"] if w["config"] == cfg)
    cell = cells.load_cell(wl["name"])
    config = {**cell.config, **TINY[cfg]}
    a = generator.make(cell.traffic, config, SEED, cpu)
    b = generator.make(cell.traffic, config, SEED, cpu)
    c = generator.make(cell.traffic, config, SEED + 1, cpu)
    assert a.keys() == b.keys() == c.keys()
    assert all(torch.equal(a[k].view(torch.int32), b[k].view(torch.int32)) for k in a)
    assert any(not torch.equal(a[k].view(torch.int32), c[k].view(torch.int32)) for k in a)
    assert all(a[k].shape == c[k].shape for k in a)


def test_each_once_and_pkfk(cpu):
    g = generator.seeded(5, cpu)
    perm = generator.draw(1000, {"distribution": "each_once"}, 1000, g, cpu)
    assert sorted(perm.tolist()) == list(range(1000))
    twice = generator.draw(2000, {"distribution": "each_once"}, 1000, g, cpu)
    assert torch.bincount(twice, minlength=1000).tolist() == [2] * 1000
    config = {"build_rows": 3000, "probe_rows": 3000}
    traffic = cells.load_cell("join.pkfk.128m").traffic
    got = generator.make(traffic, config, 9, cpu)
    bk = got["build_keys"].view(torch.int32).sort().values
    pk = got["probe_keys"].view(torch.int32).sort().values
    assert torch.equal(bk, pk) and torch.unique(bk).numel() == 3000


def test_zipf_and_fibonacci(cpu):
    g = generator.seeded(3, cpu)
    r = generator.zipf_ranks(20000, 1.1, 1000, g, cpu)
    assert int(r.min()) >= 0 and int(r.max()) < 1000
    assert int((r == 0).sum()) > int((r == 999).sum())
    ids = torch.arange(1, 5000, dtype=torch.int64)
    assert torch.unique(generator.fibonacci(ids)).numel() == ids.numel()
    u = generator.as_u32(torch.tensor([0, 2 ** 32 - 1, 2 ** 31], dtype=torch.int64))
    assert u.view(torch.int32).tolist() == [0, -1, -(2 ** 31)]


def test_forbidden_modules_compare_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "sparkrdma_tpu_torch_x", sys)
    assert "sparkrdma_tpu" not in run.forbidden_loaded()
    monkeypatch.setitem(sys.modules, "sparkrdma_tpu.sub", sys)
    assert "sparkrdma_tpu" in run.forbidden_loaded()


def _cli(cwd, env=None):
    return subprocess.run(
        [sys.executable, "-m", "shufflebench", "--workload", "sort.u32.spmd",
         "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=120, env=env)


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("this process sees a card")
    p = _cli(cells.CHECKOUT)
    assert p.returncode == run.EXIT_NO_CARD
    assert p.stdout == ""
    assert "no result" in p.stderr


def test_benchmark_alone_fails_without_result(tmp_path):
    shutil.copy(cells.CHECKOUT / "BENCHMARK.json", tmp_path)
    shutil.copytree(cells.HERE, tmp_path / "shufflebench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = _cli(tmp_path, env)
    assert p.returncode != 0
    assert p.stdout == ""


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_cell_on_card(name, card):
    """A short run of every cell on the card, ``correct`` true."""
    p = subprocess.run(
        [sys.executable, "-m", "shufflebench", "--workload", name, "--seed", str(SEED),
         "--seconds", "2", "--trace", "0"],
        cwd=cells.CHECKOUT, capture_output=True, text=True, timeout=1200)
    assert p.returncode == 0, p.stderr[-4000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, p.stderr[-4000:]
