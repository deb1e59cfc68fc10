"""The device steps' spans and the exchange program's counts.

``TeraSorter.step``, ``HashJoin.step`` and ``PageRank.step`` open a
span at the step and one at each phase, and the program of
``ExchangeProgram.program_for`` one around its transpose
(``obs/trace.py`` ``span``). Checked here on CPU shards: the names,
their number a stage and what nests in what under ``torch.profiler``;
the three states (off, profiler, tracer); the ``exchange.*`` counts the
program records. Two tests run a program under CUDA's sync debug mode
and skip without a CUDA device."""

import contextlib
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from sparkrdma_tpu_torch.models.hashjoin import HashJoin
from sparkrdma_tpu_torch.models.pagerank import PageRank
from sparkrdma_tpu_torch.models.terasort import TeraSorter
from sparkrdma_tpu_torch.obs import attr, get_registry
from sparkrdma_tpu_torch.obs import trace
from sparkrdma_tpu_torch.ops.exchange import ExchangeProgram
from sparkrdma_tpu_torch.parallel.mesh import make_mesh

E = 4
N_LOCAL = 256
PREFIXES = ("terasort.", "hashjoin.", "pagerank.", "exchange.")
ITERS = 10


def _keys(n, seed=0):
    return torch.from_numpy(
        np.random.default_rng(seed).integers(0, 2**32, n, dtype=np.uint32))


def _sort_step(shards=E, adaptive=False):
    sorter = TeraSorter(make_mesh(["cpu"] * shards))
    keys = _keys(shards * N_LOCAL)
    fn = sorter.step(N_LOCAL, adaptive=adaptive)
    if adaptive:
        edges = torch.tensor([(i << 32) // shards for i in range(1, shards)],
                             dtype=torch.int64).to(torch.uint32)
        return lambda: fn(keys, edges)
    return lambda: fn(keys)


def _join_step():
    join = HashJoin(make_mesh(["cpu"] * E))
    rng = np.random.default_rng(1)
    bkeys = (rng.permutation(E * N_LOCAL).astype(np.uint64) * 0x9E3779B1
             % 2**32).astype(np.uint32)
    pkeys = bkeys[rng.integers(0, len(bkeys), E * N_LOCAL)]
    args, nb, npl = join.place(bkeys, np.arange(len(bkeys), dtype=np.int32),
                               pkeys, np.arange(len(pkeys), dtype=np.int32))
    fn = join.step(nb, npl, 2 * nb // E, 2 * npl // E)
    return lambda: fn(*args)


def _pagerank_step(device="cpu"):
    pr = PageRank(make_mesh([device] * E))
    n = E * N_LOCAL
    edges = np.random.default_rng(2).integers(0, n, size=(8 * n, 2))
    packed, deg, n_local = pr.blocks(torch.from_numpy(edges).to(device), n)
    rank0, valid = pr.initial(n_local, n)
    fn = pr.step(n_local, packed.shape[2], ITERS, n)
    return lambda: fn(rank0, deg, valid, packed)


STEPS = {
    "sort": _sort_step,
    "sort-adaptive": lambda: _sort_step(adaptive=True),
    "sort-one-shard": lambda: _sort_step(shards=1),
    "join": _join_step,
    "pagerank": _pagerank_step,
}
# per step: each span's number a stage, and the span it nests in
SPANS = {
    "sort": ({"terasort.step": 1, "terasort.local_sort": E, "terasort.split": E,
              "exchange.a2a": 1, "terasort.merge": 1},
             {"terasort.local_sort": "terasort.step", "terasort.split": "terasort.step",
              "exchange.a2a": "terasort.step", "terasort.merge": "terasort.step",
              "terasort.step": None}),
    "sort-one-shard": ({"terasort.step": 1, "terasort.local_sort": 1},
                       {"terasort.local_sort": "terasort.step", "terasort.step": None}),
    "join": ({"hashjoin.step": 1, "hashjoin.pack": 2, "exchange.a2a": 4,
              "hashjoin.build_sort": 1, "hashjoin.probe": 1},
             {"hashjoin.pack": "hashjoin.step", "exchange.a2a": "hashjoin.step",
              "hashjoin.build_sort": "hashjoin.step",
              "hashjoin.probe": "hashjoin.step", "hashjoin.step": None}),
}
SPANS["sort-adaptive"] = SPANS["sort"]
SPANS["pagerank"] = (
    {"pagerank.step": 1, "pagerank.index": 1, "pagerank.gather": ITERS,
     "pagerank.scatter": ITERS, "exchange.a2a": ITERS, "pagerank.apply": ITERS},
    {"pagerank.index": "pagerank.step", "pagerank.gather": "pagerank.step",
     "pagerank.scatter": "pagerank.step", "exchange.a2a": "pagerank.step",
     "pagerank.apply": "pagerank.step", "pagerank.step": None})


def _profiled_ranges(run):
    """The program's ranges of one traced call: ``[(name, start, end)]``."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
    return [(e.name(), e.start_ns(), e.end_ns())
            for e in prof.profiler.kineto_results.events()
            if e.name().startswith(PREFIXES)]


def _parents(ranges):
    """Each range's innermost enclosing range (by containment)."""
    out = []
    for name, s, t in ranges:
        around = [(t2 - s2, n2) for n2, s2, t2 in ranges
                  if (n2, s2, t2) != (name, s, t) and s2 <= s and t <= t2]
        out.append((name, min(around)[1] if around else None))
    return out


@pytest.mark.parametrize("step", sorted(STEPS))
def test_spans_under_the_profiler(step):
    run = STEPS[step]()
    run()  # the first call builds and caches
    ranges = _profiled_ranges(run)
    counts, parents = SPANS[step]
    assert Counter(n for n, _, _ in ranges) == counts
    assert dict(_parents(ranges)) == parents
    for name, _, _ in ranges:
        assert attr.classify(name) == attr.DEVICE_COMPUTE


class _CountingRange:
    built = 0

    def __init__(self, name):
        type(self).built += 1

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


@pytest.mark.parametrize("state", ["off", "disabled-tracer", "profiler", "tracer"])
@pytest.mark.parametrize("step", ["sort", "join", "pagerank"])
def test_three_states(step, state, monkeypatch):
    run = STEPS[step]()
    run()
    built = []

    class CountingSpan(trace.Span):
        __slots__ = ()

        def __init__(self, *a, **k):
            built.append(a[0])
            super().__init__(*a, **k)

    monkeypatch.setattr(trace, "Span", CountingSpan)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", _CountingRange)
    monkeypatch.setattr(_CountingRange, "built", 0)
    tracer = trace.Tracer(role="steps", enabled=state == "tracer")
    with contextlib.ExitStack() as stack:
        if state == "profiler":
            stack.enter_context(profile(activities=[ProfilerActivity.CPU]))
        if state in ("disabled-tracer", "tracer"):
            stack.enter_context(tracer.span("job"))
        run()
    n = sum(SPANS[step][0].values())
    if state == "tracer":
        assert _CountingRange.built == 0
        spans = tracer.spans()
        assert len(built) == len(spans) == n + 1
        by_id = {sp.span_id: sp for sp in spans}
        parent = {sp.name: by_id[sp.parent_id].name if sp.parent_id else None
                  for sp in spans}
        # the step nests in the enclosing span, each phase as under the profiler
        assert parent == {"job": None,
                          **{k: v or "job" for k, v in SPANS[step][1].items()}}
        assert Counter(sp.name for sp in spans) == {"job": 1, **SPANS[step][0]}
    else:
        assert built == []
        assert _CountingRange.built == (n if state == "profiler" else 0)
        assert tracer.spans() == []


def test_disabled_spans_share_one_null_context():
    assert trace.span("terasort.step") is trace._NULL
    assert trace.Tracer(enabled=False).span("engine.task", kind="map") is trace._NULL
    with trace.span("terasort.step") as sp:
        assert sp is None


@pytest.mark.parametrize("enabled", [False, True])
def test_tracer_span_is_a_profiler_range(enabled):
    tracer = trace.Tracer(role="bridge", enabled=enabled)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracer.span("engine.task", kind="map") as sp:
            assert (sp is not None) == enabled
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    assert names.count("engine.task") == 1
    assert [s.name for s in tracer.spans()] == (["engine.task"] if enabled else [])


def _a2a_counts():
    reg = get_registry()
    return {k: reg.counter(f"exchange.{k}", schedule="a2a").value
            for k in ("exchanges", "bytes_sent", "bytes_received",
                      "bytes_received_valid")}


@pytest.mark.parametrize("call", ["sort", "join", "exchange"])
def test_exchange_counts(call):
    cap = TeraSorter(make_mesh(["cpu"] * E)).default_capacity(N_LOCAL)
    if call == "exchange":
        prog = ExchangeProgram(make_mesh(["cpu"] * E))
        rows = E * 3  # 3 rows a peer, bucketed to 4
        send = torch.arange(E * rows * 8, dtype=torch.int32).view(E * rows, 8)
        counts = torch.full((E * rows,), 3, dtype=torch.int32)
        run = lambda: prog.exchange(send, counts)  # noqa: E731
        want = (1, E * (E * 4) * 8 * 4, E * rows * 3)
    elif call == "sort":
        run = STEPS["sort"]()
        want = (1, E * E * cap * 4, 0)
    else:
        run = STEPS["join"]()
        want = (4, 2 * E * E * (2 * N_LOCAL // E) * 4 * 2, 0)
    before = _a2a_counts()
    run()
    after = _a2a_counts()
    got = {k: after[k] - before[k] for k in after}
    assert got == {"exchanges": want[0], "bytes_sent": want[1],
                   "bytes_received": want[1], "bytes_received_valid": want[2]}


@pytest.mark.parametrize("state", ["off", "profiler"])
def test_exchange_program_never_syncs(state):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    prog = ExchangeProgram(make_mesh(["cuda"] * E)).program_for(2 * E, 1024, torch.int32)
    send = torch.randint(-2**31, 2**31 - 1, (E * 2 * E, 1024), dtype=torch.int32,
                         device="cuda")
    counts = torch.randint(0, 1024, (E * 2 * E,), dtype=torch.int32, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            if state == "profiler" else contextlib.nullcontext():
        torch.cuda.set_sync_debug_mode("error")
        try:
            recv, rcounts = prog(send, counts)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
    want = send.view(E, E, 2, 1024).transpose(0, 1).reshape(send.shape)
    assert torch.equal(recv, want)
    assert torch.equal(rcounts, counts.view(E, E, 2).transpose(0, 1).reshape(-1))


@pytest.mark.parametrize("state", ["off", "profiler"])
def test_pagerank_step_never_syncs(state):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    run = STEPS["pagerank"]("cuda")
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            if state == "profiler" else contextlib.nullcontext() as prof:
        torch.cuda.set_sync_debug_mode("error")
        try:
            run()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
    if state == "profiler":
        events = list(prof.profiler.kineto_results.events())
        steps = [(e.start_ns(), e.end_ns()) for e in events if e.name() == "pagerank.step"]
        assert len(steps) == 1
        syncs = [e for e in events if "Synchronize" in e.name()
                 and steps[0][0] <= e.start_ns() <= steps[0][1]]
        assert syncs == []
