"""The wide join cell (``join.pkfk.u64.256m``) on the CPU: its files
against ``BENCHMARK.json``, the seeded generator, the entry at a small
size against ``reference/equi_join_wide.py``, the control, the readers
of its metrics on synthetic traces, and runs with the program broken
underneath (an unchanged step, half the counts, no exchange, an altered
answer, keys cut to 32 bits), each of which must come out not correct.

``conftest.TINY`` has no size for this configuration, so the harness's
shared tests skip it (``shufflebench/conftest.py``) and this module runs
what they would, at |R| = 4,096 and |S| = 65,541 (no multiple of 8, so
the last shard pads)."""

import json
import time

import pytest
import torch

from shufflebench import cells, generator, pack_roofline, run
from shufflebench.generators import join_wide
from shufflebench.reference import equi_join_wide
from shufflebench.run import Run
from shufflebench.trace import Ev, Trace

CELL = "join.pkfk.u64.256m"
CONFIG = "join.balkesen13-a"
SMALL = {"build_rows": 4096, "probe_rows": 65541}
NEW_METRICS = ["phase.pack_ms.join_u64", "phase.exchange_ms.join_u64",
               "phase.build_sort_ms.join_u64", "phase.probe_ms.join_u64",
               "step.syncs.join_u64", "device.idle_share.join_u64",
               "pack.roofline_share.join_u64"]
# the narrow join cell's metrics that read the wide one too
SHARED_METRICS = ["step.enqueue_ms.join", "sort.device_ms.join", "exchange.device_ms.join",
                  "step.sync_ms.join"]


@pytest.fixture
def small():
    cell = cells.load_cell(CELL)
    cell.config.update(SMALL)
    return cell


def _run(cell, cpu, seed=2 ** 31 + 29):
    return run.run_cell(cell, seed, 0.05, False, cpu, time.perf_counter())


# ---- the files
def test_files_agree_with_the_benchmark():
    bench = cells.benchmark()
    cfg = next(c for c in bench["configs"] if c["name"] == CONFIG)
    body = json.loads((cells.CHECKOUT / cfg["file"]).read_text())
    assert (body["build_rows"], body["probe_rows"]) == (16 << 20, 256 << 20)
    assert (body["key_bytes"], body["payload_bytes"], body["shards"]) == (8, 8, 8)
    assert body["reduced"] == cfg["reduced"] == []
    cell = cells.load_cell(CELL)
    assert cell.chips == 1 and cell.traffic["kind"] == "join_wide"
    assert cell.traffic["probe_keys"] == {"distribution": "uniform"}
    assert cell.limits == {"count_mismatch": 0, "row_mismatch": 0}
    e2e = {m["name"] for m in cell.end_to_end}
    assert e2e == {"shuffle_gbps.join", "stage_ms.p95.join", "peak_hbm_gib", "setup_s"}
    assert [m["name"] for m in cell.per_layer] == SHARED_METRICS + NEW_METRICS
    assert all(m["moves"] == "shuffle_gbps.join" for m in cell.per_layer)
    assert all(m["workloads"] == [CELL] for m in cell.per_layer[len(SHARED_METRICS):])
    assert all(m["workloads"] == ["join.pkfk.128m", CELL]
               for m in cell.per_layer[:len(SHARED_METRICS)])


def test_pack_bytes_of_the_cell():
    config = cells.load_cell(CELL).config
    assert pack_roofline.capacities(config) == (1 << 21, 1 << 25, 524_288, 8_388_608)
    assert pack_roofline.pack_bytes(config) == 13_690_208_256
    assert pack_roofline.bound_ms(config) == pytest.approx(4.0866, abs=1e-4)


# ---- the generator
def test_generator_is_seeded_sized_and_a_foreign_key(cpu):
    config = {**cells.load_cell(CELL).config, **SMALL}
    traffic = cells.load_cell(CELL).traffic
    a = generator.make(traffic, config, 5, cpu)
    b = generator.make(traffic, config, 5, cpu)
    c = generator.make(traffic, config, 2 ** 31 + 5, cpu)
    assert {k: v.dtype for k, v in a.items()} == {
        "build_keys": torch.uint64, "build_vals": torch.int64,
        "probe_keys": torch.uint64, "probe_vals": torch.int64}
    assert a["build_keys"].shape == (4096,) and a["probe_keys"].shape == (65541,)
    bits = {k: v.view(torch.int64) for k, v in a.items()}
    assert all(torch.equal(bits[k], b[k].view(torch.int64)) for k in a)
    assert not torch.equal(bits["probe_keys"], c["probe_keys"].view(torch.int64))
    bk = bits["build_keys"]
    assert torch.unique(bk).numel() == 4096 and not bool((bk == -1).any())
    assert bool((bk < 0).any()) and bool((bk > 0).any())  # keys on both sides of 2^63
    # the hashed keys 1..|R|, in a seeded order
    want = join_wide.fibonacci64(torch.arange(1, 4097))
    assert torch.equal(torch.sort(bk).values, torch.sort(want).values)
    assert bool(torch.isin(bits["probe_keys"], bk).all())
    assert torch.equal(bits["probe_vals"], torch.arange(65541))


def test_generator_refuses_the_padding_key(cpu, monkeypatch):
    monkeypatch.setattr(join_wide, "fibonacci64", lambda ids: ids - ids.max())
    config = {**cells.load_cell(CELL).config, **SMALL}
    with pytest.raises(ValueError, match="padding key"):
        join_wide.make({"probe_keys": {"distribution": "uniform"}}, config,
                       generator.seeded(1, cpu), cpu)


# ---- the entry and the reference
def test_small_run_is_correct(small, cpu):
    res = _run(small, cpu)
    assert res["correct"], res["numbers"]
    assert res["numbers"] == {"count_mismatch": 0, "row_mismatch": 0}
    assert res["run"].stage_bytes == (4096 + 65541) * 16
    assert res["failed"] == 0


def test_result_line_keys(small, cpu):
    res = _run(small, cpu, seed=7)
    line = run.result_line(res, small, traced=False)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert line["checks"] == {k: {"value": res["numbers"][k], "limit": small.limits[k]}
                              for k in ("count_mismatch", "row_mismatch")}
    assert all(set(m) == {"value", "unit"} for m in line["metrics"].values())
    json.dumps(line)
    assert set(run.result_line(res, small, traced=True)["metrics"]) <= {
        m["name"] for m in small.per_layer}


def test_exact_reference_in_the_programs_place_passes(small, cpu):
    inputs = generator.make(small.traffic, small.config, 3, cpu)
    judged, counts = equi_join_wide.control(inputs, small.config, bits=64)
    numbers, bad = equi_join_wide.compare(judged, [counts] * 3, inputs, small.config)
    assert numbers == {"count_mismatch": 0, "row_mismatch": 0} and bad == 0


@pytest.mark.parametrize("seed", [1, 2 ** 31 + 5, 99])
def test_control_fails(seed, small, cpu):
    """The control joins on a folded fingerprint of each key. At the
    cell's 2^24 build keys the 32-bit one collides 31,238 times; at this
    size's 4,096 keys a 32-bit fingerprint almost never collides, so the
    control is held here at 16 bits (~100 colliding pairs)."""
    inputs = generator.make(small.traffic, small.config, seed, cpu)
    judged, counts = equi_join_wide.control(inputs, small.config, bits=16)
    numbers, bad = equi_join_wide.compare(judged, [counts], inputs, small.config)
    assert numbers["row_mismatch"] > 0 and bad > 0, numbers


def test_the_fingerprint_folds_the_key():
    k = torch.tensor([0x0123_4567_89AB_CDEF, -1, 1 << 40])
    assert equi_join_wide.fingerprint(k, 32).tolist() == [
        0x0123_4567 ^ 0x89AB_CDEF, 0, 1 << 8]
    assert equi_join_wide.fingerprint(k, 16).tolist() == [
        0x0123 ^ 0x4567 ^ 0x89AB ^ 0xCDEF, 0, 1 << 8]
    assert equi_join_wide.fingerprint(k, 64).tolist() == [
        0x0123_4567_89AB_CDEF - (1 << 63), (1 << 63) - 1, (1 << 40) - (1 << 63)]


# ---- faults in the program
def _wrap_join(monkeypatch, change):
    from sparkrdma_tpu_torch.models.hashjoin import HashJoin

    real = HashJoin._build

    def build(self, nb, npl, cap_b, cap_p):
        fn = real(self, nb, npl, cap_b, cap_p)
        return lambda bk, bv, pk, pv: change(self, (bk, bv, pk, pv), *fn(bk, bv, pk, pv))

    monkeypatch.setattr(HashJoin, "_build", build)


def _unchanged(self, args, pk2, pv2, joined, pcnt, ovf):
    return (torch.zeros_like(pk2.view(torch.int64)).view(torch.uint64),
            torch.zeros_like(pv2), torch.zeros_like(joined), torch.zeros_like(pcnt), ovf)


def _half(self, args, pk2, pv2, joined, pcnt, ovf):
    pcnt = pcnt.clone()
    pcnt[:, self.num_shards // 2:] = 0
    return pk2, pv2, joined, pcnt, ovf


def _altered(self, args, pk2, pv2, joined, pcnt, ovf):
    j = joined.clone()
    j[0, 0, 0] += 1
    return pk2, pv2, j, pcnt, ovf


def _cut_to_32_bits(self, args, pk2, pv2, joined, pcnt, ovf):
    return ((pk2.view(torch.int64) & 0xFFFFFFFF).view(torch.uint64), pv2, joined, pcnt, ovf)


def _no_exchange(monkeypatch):
    from sparkrdma_tpu_torch.ops.exchange import ExchangeProgram

    monkeypatch.setattr(ExchangeProgram, "program_for",
                        lambda self, rows, block, dtype: lambda send, counts: (send, counts))


@pytest.mark.parametrize("fault", ["unchanged", "half", "no_exchange", "altered",
                                   "cut_to_32_bits"])
def test_faults_are_not_correct(fault, monkeypatch, small, cpu):
    if fault == "no_exchange":
        _no_exchange(monkeypatch)
    else:
        _wrap_join(monkeypatch, {"unchanged": _unchanged, "half": _half,
                                 "altered": _altered, "cut_to_32_bits": _cut_to_32_bits}[fault])
    res = _run(small, cpu)
    assert not res["correct"], res["numbers"]


# ---- the readers on synthetic traces
def _ev(name, kind, s, t, corr=0, thread=1):
    return Ev(name, kind, s, t, corr, 0, thread)


def _traced(events, stages=2):
    cell = cells.load_cell(CELL)
    a = Trace(events, stages, 1.0)
    return Run(cell=cell, seed=0, setup_s=1.0, window_s=1.0, stages=[], peak_bytes=None,
               device_kind="card", stage_bytes=1,
               traced={"a": a, "b": Trace([], stages, 1.0), "by_module_ns": {}})


KERNEL64 = "void (anonymous namespace)::radix_{}<long long{}>(long long const*, int*)"
KERNEL32 = "void (anonymous namespace)::radix_{}<int{}>(int const*, int*)"


def test_roofline_share_reads_the_8_byte_kernels_only():
    events = [_ev(KERNEL64.format("hist", ""), "device", 0, 1_000_000),
              _ev(KERNEL64.format("scan", ""), "device", 1_000_000, 1_010_000),
              _ev(KERNEL64.format("scatter", ", 3"), "device", 1_010_000, 5_000_000),
              _ev(KERNEL32.format("scatter", ", 4"), "device", 5_000_000, 9_000_000),
              _ev("void at::native::searchsorted_cuda_kernel<long, int>", "device", 0, 7),
              _ev(KERNEL64.format("scatter", ", 3"), "op", 0, 9_000_000)]
    read = cells.metric_reader("pack.roofline_share.join_u64")
    ms = 5.0 / 2  # 5 ms of the 8-byte pack's kernels over 2 stages
    assert pack_roofline.kernel_ms(_traced(events)) == pytest.approx(ms)
    assert read(_traced(events)) == pytest.approx(4.0866 / ms * 100, rel=1e-4)


def test_a_trace_without_the_8_byte_pack_reads_none():
    read = cells.metric_reader("pack.roofline_share.join_u64")
    assert read(_traced([_ev(KERNEL32.format("scatter", ", 4"), "device", 0, 9)])) is None
    assert read(_traced([])) is None
    assert read(Run(cell=cells.load_cell(CELL), seed=0, setup_s=1.0, window_s=1.0,
                    stages=[], peak_bytes=None, device_kind=None, stage_bytes=1)) is None


def test_the_wide_step_opens_the_readers_spans(cpu):
    """A wide step traced on the CPU: the spans its phase metrics read
    (no device events there, so every phase reads 0 ms)."""
    from torch.profiler import ProfilerActivity, profile

    from shufflebench import spans
    from shufflebench.trace import _kind
    from sparkrdma_tpu_torch.models.hashjoin import HashJoin
    from sparkrdma_tpu_torch.parallel.mesh import make_mesh

    config = {**cells.load_cell(CELL).config, **SMALL}
    inputs = generator.make(cells.load_cell(CELL).traffic, config, 3, cpu)
    join = HashJoin(make_mesh([cpu] * 8))
    host = {k: v.view(torch.int64).numpy() for k, v in inputs.items()}
    args, nb, npl = join.place(host["build_keys"].view("u8"), host["build_vals"],
                               host["probe_keys"].view("u8"), host["probe_vals"])
    fn = join.step(nb, npl, 2 * nb // 8, 2 * npl // 8)
    fn(*args)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn(*args)
    cuda = torch.autograd.DeviceType.CUDA
    evs = [Ev(e.name(), _kind(e, cuda), e.start_ns(), e.end_ns(), e.correlation_id(),
              e.linked_correlation_id(), e.start_thread_id())
           for e in prof.profiler.kineto_results.events()]
    names = sorted(s.name for s in spans.program_spans(evs))
    assert names == sorted(["hashjoin.step", "hashjoin.build_sort", "hashjoin.probe"]
                           + ["hashjoin.pack"] * 2 + ["exchange.a2a"] * 4)
    run_ = _traced(evs, stages=1)
    for name in NEW_METRICS[:4]:
        assert cells.metric_reader(name)(run_) == 0.0
    assert cells.metric_reader("step.syncs.join_u64")(run_) == 0
