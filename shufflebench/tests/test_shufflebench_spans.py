"""The readers of the program's spans (``spans.py``) on synthetic
traces: the innermost span takes a kernel's time, a kernel is found by
its runtime launch or else its linked op, only the synchronising calls
inside the step span count, and a trace without spans reads None."""

import pytest
import torch

from shufflebench import cells, spans
from shufflebench.run import Run
from shufflebench.trace import Ev, Trace

PROGRAM_SPAN_METRICS = [m["name"] for m in cells.benchmark()["per_layer"]
                        if m["source"] == "program_span"]


def op(name, s, t, corr=0, thread=1):
    return Ev(name, "op", s, t, corr, 0, thread)


def rt(name, s, t, corr, thread=1):
    return Ev(name, "runtime", s, t, corr, 0, thread)


def dev(s, t, corr=0, linked=0):
    return Ev("kernel", "device", s, t, corr, linked, 0)


def traced_run(events, stages=2):
    a = Trace(events, stages, 1.0)
    return Run(cell=None, seed=0, setup_s=1.0, window_s=1.0, stages=[],
               peak_bytes=None, device_kind="card", stage_bytes=1,
               traced={"a": a, "b": Trace([], stages, 1.0), "by_module_ns": {}})


SORT = [
    op("terasort.step", 0, 1000),
    op("terasort.local_sort", 10, 200),
    op("aten::sort", 20, 190, corr=5),
    rt("cudaLaunchKernel", 30, 40, corr=101),
    op("terasort.split", 200, 400),
    rt("cudaLaunchKernel", 250, 260, corr=102),
    op("exchange.a2a", 420, 500),
    op("aten::copy_", 430, 490, corr=6),         # its kernel has no runtime event
    rt("cudaLaunchKernel", 600, 610, corr=103),  # under the step alone
    rt("cudaLaunchKernel", 1100, 1110, corr=104),  # after the step returned
    dev(2000, 2300, corr=101, linked=5),
    dev(2300, 2400, corr=102),
    dev(2400, 2450, corr=999, linked=6),         # found by its linked op only
    dev(2450, 2460, corr=103),
    dev(2460, 2500, corr=104),
    dev(2500, 2510, corr=998),                   # neither: no span
]


def test_innermost_span_takes_the_time_by_runtime_or_linked_op():
    assert spans.device_ns_by_span(SORT) == {
        "terasort.local_sort": 300, "terasort.split": 100, "exchange.a2a": 50,
        "terasort.step": 10, None: 50}


def test_runtime_launch_wins_over_the_linked_op():
    evs = [op("hashjoin.step", 0, 100), op("hashjoin.probe", 10, 20, corr=7),
           rt("cudaLaunchKernel", 50, 55, corr=9), dev(200, 260, corr=9, linked=7)]
    assert spans.device_ns_by_span(evs) == {"hashjoin.step": 60}


def test_phase_ms_a_stage():
    run = traced_run(SORT, stages=2)
    assert spans.phase_ms(run, "terasort.local_sort") == pytest.approx(300 / 2 / 1e6)
    assert spans.phase_ms(run, "terasort.merge") is None  # never opened
    assert cells.metric_reader("phase.exchange_ms.terasort")(run) == pytest.approx(25e-6)


def test_only_syncs_inside_the_step_span_on_its_thread_count():
    evs = [
        op("hashjoin.step", 0, 1000),
        op("hashjoin.pack", 100, 300),
        rt("cudaStreamSynchronize", 150, 170, corr=1),       # in a phase: counts
        rt("cudaStreamSynchronize", 500, 540, corr=2),       # in the step: counts
        rt("cudaLaunchKernel", 550, 560, corr=3),            # no sync
        rt("cudaStreamSynchronize", 600, 610, corr=4, thread=2),  # other thread
        rt("cudaDeviceSynchronize", 1200, 1300, corr=5),     # after the step
        rt("cudaStreamSynchronize", 1500, 1520, corr=6),
        op("hashjoin.step", 2000, 3000),
        rt("cudaEventSynchronize", 2100, 2130, corr=7),
    ]
    assert spans.syncs(evs, "hashjoin.step") == (3, 20 + 40 + 30)
    assert spans.syncs(evs, "terasort.step") is None
    run = traced_run(evs, stages=2)
    assert cells.metric_reader("step.syncs.join")(run) == 1.5
    assert cells.metric_reader("step.sync_ms.join")(run) == pytest.approx(45e-6)


@pytest.mark.parametrize("name", PROGRAM_SPAN_METRICS)
def test_no_spans_read_none(name):
    # the parent's trace: the same kernels and syncs, no program span
    evs = [e for e in SORT if not e.name.startswith(spans.PREFIXES)]
    evs.append(rt("cudaStreamSynchronize", 700, 710, corr=50))
    read = cells.metric_reader(name)
    assert read(traced_run(evs)) is None
    assert read(traced_run([])) is None
    assert read(Run(cell=None, seed=0, setup_s=1.0, window_s=1.0, stages=[],
                    peak_bytes=None, device_kind=None, stage_bytes=1)) is None


def test_the_programs_own_spans_are_found(cpu):
    """A real step traced on the CPU: its ranges are the readers' spans
    (no device events there, so every phase reads 0 ms)."""
    from torch.profiler import ProfilerActivity, profile

    from sparkrdma_tpu_torch.models.terasort import TeraSorter
    from sparkrdma_tpu_torch.parallel.mesh import make_mesh
    from shufflebench.trace import _kind

    fn = TeraSorter(make_mesh([cpu] * 4)).step(1024)
    keys = torch.arange(4096, dtype=torch.int64).to(torch.uint32)
    fn(keys)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn(keys)
    cuda = torch.autograd.DeviceType.CUDA
    evs = [Ev(e.name(), _kind(e, cuda), e.start_ns(), e.end_ns(), e.correlation_id(),
              e.linked_correlation_id(), e.start_thread_id())
           for e in prof.profiler.kineto_results.events()]
    names = sorted(s.name for s in spans.program_spans(evs))
    assert names == sorted(["terasort.step", "exchange.a2a"]
                           + ["terasort.local_sort", "terasort.split", "terasort.merge"] * 4)
    run = traced_run(evs, stages=1)
    assert spans.phase_ms(run, "terasort.merge") == 0.0
    assert spans.sync_count(run, "terasort.step") == 0
