"""The harness's arithmetic on synthetic inputs: rates, tails, spreads,
device busy time, attribution by module, the breakdown."""

import json
import statistics

import pytest

from shufflebench import readers, stats, trace
from shufflebench.run import Run, Stage
from shufflebench.trace import Ev, Trace


def stage(wall, device=None, ok=True, nbytes=100):
    return Stage(wall_s=wall, device_s=device, enqueue_s=wall / 10, ok=ok,
                 bytes=nbytes if ok else 0, counts=[])


def make_run(stages, window_s=1.0, traced=None):
    return Run(cell=None, seed=0, setup_s=3.0, window_s=window_s, stages=stages,
               peak_bytes=2 ** 31, device_kind="card", stage_bytes=100,
               traced=traced)


def test_rate_counts_completed_stages_over_the_whole_window():
    run = make_run([stage(0.1), stage(0.1, ok=False), stage(0.1)], window_s=0.5)
    assert readers.completed_gbps(run) == pytest.approx(200 / 0.5 / 1e9)
    assert stats.rate_per_s(5, 0) is None


def test_p95_of_all_stages():
    run = make_run([stage(1.0, device=i / 1000) for i in range(1, 101)])
    assert readers.device_p95_ms(run) == pytest.approx(95.05)
    assert stats.percentile([4.0], 95) == 4.0
    assert stats.percentile([], 95) is None
    # inclusive: never beyond the largest value
    assert stats.percentile([1.0, 2.0], 95) <= 2.0


def test_quartile_spread_is_statistics_quantiles():
    vals = [10.0, 11.0, 9.0, 10.5, 9.5, 10.2]
    q1, q2, q3 = statistics.quantiles(vals, n=4)
    assert stats.quartile_spread(vals) == pytest.approx((q3 - q1) / q2)


def dev(name, s, t, corr=0, linked=0):
    return Ev(name, "device", s, t, corr, linked, 0)


def test_union_and_gaps_merge_overlaps():
    evs = [dev("a", 0, 10), dev("b", 5, 20), dev("c", 30, 40), dev("d", 40, 45),
           Ev("op", "op", 0, 100, 1, 0, 1)]
    assert trace.union_ns(evs) == 20 + 15
    assert trace.gaps(evs) == [(20, 30)]


def test_idle_share_from_union_over_stretch():
    a = Trace([dev("k", 0, 300_000_000)], 3, 1.0)
    run = make_run([], traced={"a": a, "b": a, "by_module_ns": {}})
    assert readers.idle_share(run) == pytest.approx(0.7)
    assert readers.idle_share(make_run([])) is None


def frame(path, s, t, thread=1):
    return Ev(f"/x/sparkrdma_tpu_torch/{path}(1): f", "python", s, t, 0, 0, thread)


def test_attribution_to_innermost_package_frame():
    evs = [
        frame("models/terasort.py", 0, 1000),
        frame("ops/sort.py", 100, 400),
        Ev("aten::sort", "op", 200, 300, 7, 0, 1),          # under ops/sort.py
        Ev("aten::copy_", "op", 500, 600, 8, 0, 1),          # under models/terasort.py
        Ev("cudaLaunchKernel", "runtime", 700, 710, 99, 0, 1),  # a ctypes launch
        frame("ops/remote_copy.py", 690, 720),
        dev("sortKernel", 2000, 2500, corr=50, linked=7),
        dev("copyKernel", 2500, 2600, corr=51, linked=8),
        dev("wave_pull_kernel", 2600, 2900, corr=99, linked=0),
        dev("orphan", 3000, 3100, corr=77, linked=0),
    ]
    assert trace.by_module(evs) == {"ops/sort.py": 500, "models/terasort.py": 100,
                                    "ops/remote_copy.py": 300, trace.OTHER: 100}
    assert trace.module_of("a/sparkrdma_tpu_torch/ops/sort.py(1): f") == "ops/sort.py"
    assert trace.module_of("torch/x.py(1): f") is None


def test_module_ms_per_traced_stage():
    b = Trace([], 4, 1.0)
    run = make_run([], traced={"a": b, "b": b,
                               "by_module_ns": {"ops/sort.py": 8_000_000}})
    assert readers.module_ms(run, "ops/sort.py") == pytest.approx(2.0)
    assert readers.module_ms(run, "ops/exchange.py") is None


def test_breakdown_lists():
    evs = [dev("k1", 0, 100), dev("k2", 200, 250), dev("k1", 300, 400), dev("k3", 500, 510),
           Ev("aten::x", "op", 0, 10, 1, 0, 1),
           frame("shuffle/manager.py", 90, 320),
           frame("shuffle/collective.py", 110, 190)]
    assert trace.top_device_ops(evs)[:2] == [["k1", 200e-9], ["k2", 50e-9]]
    gaps = dict(trace.gaps_by_host(evs))
    assert gaps == {"shuffle/collective.py(1): f": 100e-9,
                    "shuffle/manager.py(1): f": 50e-9,
                    "host (no package frame open)": 100e-9}


def test_spread_tool_groups_runs_by_cell_and_set(tmp_path, capsys):
    from shufflebench import spread

    for seed, v in ((1, 10.0), (2, 11.0), (3, 12.0)):
        line = {"correct": True, "metrics": {"shuffle_gbps.terasort": {"value": v, "unit": "GB/s"}}}
        (tmp_path / f"sort.u32.spmd.set1.{seed}.out").write_text("noise\n" + json.dumps(line))
    assert spread.main(sorted(tmp_path.iterdir())) == 0
    out = capsys.readouterr().out
    assert "sort.u32.spmd set1: 3 runs" in out
    assert f"median 11.0 spread {stats.quartile_spread([10.0, 11.0, 12.0]):.6f}" in out
