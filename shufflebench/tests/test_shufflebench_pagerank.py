"""The PageRank cell (``pagerank.g500-s26``) on the CPU: its files
against ``BENCHMARK.json``, the Kronecker generator, the entry at a
small size against ``reference/pagerank_ranks.py``, the control, the
span readers on synthetic traces, and runs with the program broken
underneath (ranks unchanged, one iteration fewer, no exchange, the
exchanged contributions rounded to bfloat16), each of which must come
out not correct.

The CPU size is SCALE 14 (2^18 edges): below it ten iterations have
converged so far that a job one iteration short stays inside the
tolerances. ``conftest.TINY`` has no size for this configuration, so
the harness's shared tests skip it (``shufflebench/conftest.py``) and
this module runs what they would: the entry against the reference,
the result line, the seeded generator and the control."""

import json
import time

import pytest
import torch

from shufflebench import cells, generator, pagerank_spans, run
from shufflebench.generators import graph
from shufflebench.reference import pagerank_ranks
from shufflebench.run import Run
from shufflebench.trace import Ev, Trace

CELL = "pagerank.g500-s26"
CONFIG = "pagerank.graph500-toy"
SMALL = {"scale": 14}
NEW_METRICS = ["phase.index_ms.pagerank", "phase.gather_ms.pagerank",
               "phase.scatter_ms.pagerank", "phase.exchange_ms.pagerank",
               "phase.apply_ms.pagerank", "step.syncs.pagerank",
               "device.idle_share.pagerank"]


@pytest.fixture
def small():
    cell = cells.load_cell(CELL)
    cell.config.update(SMALL)
    return cell


def _run(cell, cpu, seed=2 ** 31 + 77):
    return run.run_cell(cell, seed, 0.05, False, cpu, time.perf_counter())


# ---- the files
def test_files_agree_with_the_benchmark():
    bench = cells.benchmark()
    cfg = next(c for c in bench["configs"] if c["name"] == CONFIG)
    body = json.loads((cells.CHECKOUT / cfg["file"]).read_text())
    assert (body["scale"], body["edgefactor"], body["shards"]) == (26, 16, 8)
    assert body["reduced"] == cfg["reduced"] == []
    assert body["initiator"] == [0.57, 0.19, 0.19, 0.05]
    assert (body["damping"], body["iterations"]) == (0.85, 10)
    cell = cells.load_cell(CELL)
    assert cell.chips == 1 and cell.traffic["kind"] == "graph"
    assert cell.traffic["iterations"] == body["iterations"]
    assert set(cell.limits) == {"rank_mismatch", "mass_mismatch"}
    e2e = {m["name"] for m in cell.end_to_end}
    assert e2e == {"shuffle_gbps.terasort", "stage_ms.p95.terasort", "peak_hbm_gib", "setup_s"}
    assert [m["name"] for m in cell.per_layer] == NEW_METRICS
    assert all(m["moves"] == "shuffle_gbps.terasort" and m["workloads"] == [CELL]
               for m in cell.per_layer)


# ---- the generator
def test_kronecker_graph_is_skewed_seeded_and_sized(cpu):
    config = {**cells.load_cell(CELL).config, **SMALL}
    a = generator.make({"kind": "graph"}, config, 5, cpu)["edges"]
    b = generator.make({"kind": "graph"}, config, 5, cpu)["edges"]
    assert a.dtype == torch.int32 and a.shape == (16 << 14, 2)
    assert torch.equal(a, b)
    n = 1 << 14
    assert int(a.min()) >= 0 and int(a.max()) < n
    indeg = torch.bincount(a[:, 1].long(), minlength=n)
    outdeg = torch.bincount(a[:, 0].long(), minlength=n)
    assert int(indeg.max()) > 100 * 16  # power law: a hub far above the mean
    assert 0.2 < float((outdeg == 0).float().mean()) < 0.6  # dangling vertices
    assert int((a[:, 0] == a[:, 1]).sum()) > 0  # self-loops kept
    assert torch.unique(a[:, 0].long() * n + a[:, 1].long()).numel() < a.shape[0]


def test_initiator_must_sum_to_one(cpu):
    config = {**cells.load_cell(CELL).config, **SMALL, "initiator": [0.5, 0.2, 0.2, 0.2]}
    with pytest.raises(ValueError, match="does not sum to 1"):
        graph.make({}, config, generator.seeded(1, cpu), cpu)


# ---- the entry and the reference
def test_small_run_is_correct(small, cpu):
    res = _run(small, cpu)
    assert res["correct"], res["numbers"]
    assert res["numbers"] == {"rank_mismatch": 0, "mass_mismatch": 0}
    assert all(abs(s.counts[0] - 1.0) < 1e-6 for s in res["run"].stages)
    assert res["run"].stage_bytes == (16 << 14) * 8


def test_result_line_keys(small, cpu):
    res = run.run_cell(small, 7, 0.05, False, cpu, time.perf_counter())
    line = run.result_line(res, small, traced=False)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert line["checks"] == {k: {"value": res["numbers"][k], "limit": small.limits[k]}
                              for k in ("rank_mismatch", "mass_mismatch")}
    assert all(set(m) == {"value", "unit"} for m in line["metrics"].values())
    json.dumps(line)
    assert set(run.result_line(res, small, traced=True)["metrics"]) <= {
        m["name"] for m in small.per_layer}


def test_exact_reference_in_the_programs_place_passes(small, cpu):
    inputs = generator.make(small.traffic, small.config, 3, cpu)
    r = pagerank_ranks.power_iteration(inputs["edges"], 1 << 14, 10, 0.85)
    numbers, bad = pagerank_ranks.compare(
        {"ranks": r.float()}, [[float(r.sum())]] * 3, inputs, small.config)
    assert numbers == {"rank_mismatch": 0, "mass_mismatch": 0} and bad == 0


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_control_fails(seed, small, cpu):
    inputs = generator.make(small.traffic, small.config, seed, cpu)
    judged, counts = pagerank_ranks.control(inputs, small.config)
    numbers, bad = pagerank_ranks.compare(judged, [counts], inputs, small.config)
    assert numbers["rank_mismatch"] > 0 and bad > 0, numbers


# ---- faults in the program
def _wrap_build(monkeypatch, change):
    from sparkrdma_tpu_torch.models.pagerank import PageRank

    real = PageRank._build

    def build(self, n_local, cap, iters, num_vertices):
        return change(real, self, n_local, cap, iters, num_vertices)

    monkeypatch.setattr(PageRank, "_build", build)


def _unchanged(real, self, n_local, cap, iters, nv):
    fn = real(self, n_local, cap, iters, nv)
    return lambda rank, deg, valid, blocks: (fn(rank, deg, valid, blocks), rank)[1]


def _one_fewer(real, self, n_local, cap, iters, nv):
    return real(self, n_local, cap, iters - 1, nv)


def _no_exchange(monkeypatch):
    from sparkrdma_tpu_torch.ops.exchange import ExchangeProgram

    monkeypatch.setattr(ExchangeProgram, "program_for",
                        lambda self, rows, block, dtype: lambda send, counts: (send, counts))


def _bfloat16_exchange(monkeypatch):
    from sparkrdma_tpu_torch.ops.exchange import ExchangeProgram

    real = ExchangeProgram.program_for

    def program_for(self, rows, block, dtype):
        fn = real(self, rows, block, dtype)
        return lambda send, counts: fn(send.to(torch.bfloat16).to(send.dtype), counts)

    monkeypatch.setattr(ExchangeProgram, "program_for", program_for)


@pytest.mark.parametrize("fault", ["unchanged", "one_fewer", "no_exchange", "bfloat16"])
def test_faults_are_not_correct(fault, monkeypatch, small, cpu):
    if fault == "no_exchange":
        _no_exchange(monkeypatch)
    elif fault == "bfloat16":
        _bfloat16_exchange(monkeypatch)
    else:
        _wrap_build(monkeypatch, {"unchanged": _unchanged, "one_fewer": _one_fewer}[fault])
    res = _run(small, cpu)
    assert not res["correct"], res["numbers"]
    assert res["numbers"]["rank_mismatch"] > 0


def test_mass_off_by_more_than_its_tolerance_fails(small, cpu):
    inputs = generator.make(small.traffic, small.config, 4, cpu)
    r = pagerank_ranks.power_iteration(inputs["edges"], 1 << 14, 10, 0.85).float()
    tol = pagerank_ranks.MASS_TOL
    numbers, _ = pagerank_ranks.compare(
        {"ranks": r}, [[1.0], [1.0 + 2 * tol], [1.0 - tol / 2], [float("nan")]],
        inputs, small.config)
    assert numbers == {"rank_mismatch": 0, "mass_mismatch": 2}


# ---- the span readers
def op(name, s, t, corr=0, thread=1):
    return Ev(name, "op", s, t, corr, 0, thread)


def rt(name, s, t, corr, thread=1):
    return Ev(name, "runtime", s, t, corr, 0, thread)


def dev(s, t, corr=0, linked=0):
    return Ev("kernel", "device", s, t, corr, linked, 0)


STEP = [
    op("pagerank.step", 0, 1000),
    op("pagerank.index", 10, 100),
    rt("cudaLaunchKernel", 20, 30, corr=1),
    op("pagerank.gather", 100, 200),
    op("aten::index", 110, 190, corr=7),
    op("pagerank.scatter", 200, 300),
    rt("cudaLaunchKernel", 210, 220, corr=2),
    op("exchange.a2a", 300, 400),
    rt("cudaLaunchKernel", 310, 320, corr=3),
    op("pagerank.apply", 400, 500),
    rt("cudaLaunchKernel", 410, 420, corr=4),
    rt("cudaStreamSynchronize", 600, 610, corr=5),  # inside the step
    rt("cudaLaunchKernel", 1100, 1110, corr=6),  # after it
    rt("cudaStreamSynchronize", 1200, 1210, corr=8),
    dev(2000, 2010, corr=1),
    dev(2010, 2110, corr=99, linked=7),  # found by its linked op only
    dev(2110, 2410, corr=2),
    dev(2410, 2450, corr=3),
    dev(2450, 2470, corr=4),
    dev(2470, 2480, corr=6),
]


def traced_run(events, stages=2):
    a = Trace(events, stages, 1.0)
    return Run(cell=None, seed=0, setup_s=1.0, window_s=1.0, stages=[],
               peak_bytes=None, device_kind="card", stage_bytes=1,
               traced={"a": a, "b": Trace([], stages, 1.0), "by_module_ns": {}})


def test_pagerank_spans_take_their_kernels():
    assert pagerank_spans.device_ns_by_span(STEP) == {
        "pagerank.index": 10, "pagerank.gather": 100, "pagerank.scatter": 300,
        "exchange.a2a": 40, "pagerank.apply": 20, None: 10}
    run_ = traced_run(STEP)
    got = {m: cells.metric_reader(m)(run_) for m in NEW_METRICS}
    assert got["phase.gather_ms.pagerank"] == pytest.approx(100 / 2 / 1e6)
    assert got["phase.scatter_ms.pagerank"] == pytest.approx(300 / 2 / 1e6)
    assert got["phase.exchange_ms.pagerank"] == pytest.approx(40 / 2 / 1e6)
    assert got["phase.index_ms.pagerank"] == pytest.approx(10 / 2 / 1e6)
    assert got["phase.apply_ms.pagerank"] == pytest.approx(20 / 2 / 1e6)
    assert got["step.syncs.pagerank"] == 0.5
    assert got["device.idle_share.pagerank"] == pytest.approx(1 - 480e-9)


@pytest.mark.parametrize("name", NEW_METRICS)
def test_readers_without_the_step_read_none(name):
    other = [e for e in STEP if not e.name.startswith("pagerank.")]
    read = cells.metric_reader(name)
    if name not in ("phase.exchange_ms.pagerank", "device.idle_share.pagerank"):
        assert read(traced_run(other)) is None
    assert read(Run(cell=None, seed=0, setup_s=1.0, window_s=1.0, stages=[],
                    peak_bytes=None, device_kind=None, stage_bytes=1)) is None


def test_the_programs_own_spans_are_found(cpu):
    """A real PageRank call traced on the CPU: its ranges are the
    readers' spans, each phase directly in the step."""
    from torch.profiler import ProfilerActivity, profile

    from shufflebench.trace import _kind
    from sparkrdma_tpu_torch.models.pagerank import PageRank
    from sparkrdma_tpu_torch.parallel.mesh import make_mesh

    pr = PageRank(make_mesh([cpu] * 4))
    edges = torch.randint(0, 64, (400, 2), generator=torch.Generator().manual_seed(1))
    packed, deg, n_local = pr.blocks(edges, 64)
    rank0, valid = pr.initial(n_local, 64)
    fn = pr.step(n_local, packed.shape[2], 3, 64)
    fn(rank0, deg, valid, packed)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn(rank0, deg, valid, packed)
    cuda = torch.autograd.DeviceType.CUDA
    evs = [Ev(e.name(), _kind(e, cuda), e.start_ns(), e.end_ns(), e.correlation_id(),
              e.linked_correlation_id(), e.start_thread_id())
           for e in prof.profiler.kineto_results.events()]
    names = sorted(s.name for s in pagerank_spans.program_spans(evs))
    assert names == sorted(["pagerank.step", "pagerank.index"] + [
        "pagerank.gather", "pagerank.scatter", "exchange.a2a", "pagerank.apply"] * 3)
    run_ = traced_run(evs, stages=1)
    assert pagerank_spans.phase_ms(run_, "pagerank.scatter") == 0.0
    assert pagerank_spans.sync_count(run_) == 0
