"""shuffle/collective.py of the port against the JAX compiler: the same
plan for the same locations (the location sets of
test_collective_shuffle.py), and byte-identical execution — per-block
multisets and fused slabs — over arenas carried across with
``from_jax_state``, on the CPU movers and on the kernel path's plain
version. Depth 2 equals depth 1, with overlap only at depth 2."""

import dataclasses

import numpy as np
import pytest
import torch

from sparkrdma_tpu import locations as jloc
from sparkrdma_tpu.ops.hbm_arena import DeviceBufferManager as JaxArena
from sparkrdma_tpu.shuffle import device_fetch as jdf
from sparkrdma_tpu.shuffle.collective import ShuffleScheduleCompiler as JaxCompiler
from sparkrdma_tpu.utils.config import TpuShuffleConf as JaxConf
from sparkrdma_tpu_torch import locations as tloc
from sparkrdma_tpu_torch.convert import from_jax_state
from sparkrdma_tpu_torch.obs import get_registry
from sparkrdma_tpu_torch.ops.hbm_arena import DeviceBufferManager as TorchArena
from sparkrdma_tpu_torch.shuffle import device_fetch as tdf
from sparkrdma_tpu_torch.shuffle.collective import ShuffleScheduleCompiler
from sparkrdma_tpu_torch.utils.config import TpuShuffleConf

torch.set_num_threads(1)

BLOCK = 64 << 10


def _loc(mod, pid, length, exec_id, mkey=1, handle=1, coords=0):
    return mod.PartitionLocation(
        mod.ShuffleManagerId("host", 1234, exec_id), pid,
        mod.BlockLocation(0, length, mkey, device_coords=coords,
                          arena_handle=handle),
    )


def _norm(plan):
    return (
        plan.schedule,
        [(w.rows_b, w.bucket_elems, w.lane,
          [(r.loc.partition_id, r.loc.manager_id.executor_id, r.loc.block.mkey,
            r.loc.block.arena_handle, r.elems) for r in w.rows])
         for w in plan.waves],
        [(x.partition_id, x.manager_id.executor_id, x.block.mkey)
         for x in plan.passthrough],
        sorted(plan.fusable_pids), plan.device_blocks, plan.sig,
        plan.stage_bytes, plan.max_group_bytes,
    )


@pytest.fixture()
def lanes():
    """Lane names registered on both sides (plan needs visibility only)."""
    names = ["cs-lane-0", "cs-lane-1", "cs-lane-2", "cs-lane-w"]
    ja, ta = JaxArena(), TorchArena("cpu")
    for n in names:
        jdf.register_arena(n, ja)
        tdf.register_arena(n, ta)
    try:
        yield ja, ta
    finally:
        for n in names:
            jdf.unregister_arena(n, ja)
            tdf.unregister_arena(n, ta)


def _plan_case(name, mod):
    three = [_loc(mod, p, BLOCK, f"cs-lane-{p}", mkey=10 + p) for p in range(3)]
    if name == "three_lanes":
        return three, {}
    if name == "two_lanes":
        return [_loc(mod, p, BLOCK, f"cs-lane-{p % 2}", mkey=20 + p)
                for p in range(3)], {}
    if name == "ring_knob":
        return three, {"tpu.shuffle.collective.schedule": "ring"}
    if name == "solo":
        return [_loc(mod, 0, BLOCK, "cs-lane-0")], {}
    if name == "mixed":
        return three + [_loc(mod, 9, BLOCK, "cs-lane-0", handle=0)], {}
    if name == "disabled":
        return three, {"tpu.shuffle.collective.enabled": "false"}
    ragged = [_loc(mod, p, BLOCK + 1000 * k, "cs-lane-w", mkey=30 + 2 * p + k)
              for p in range(3) for k in range(2)]
    if name == "ragged":
        return ragged, {}
    if name == "ragged_tight":
        return ragged, {"tpu.shuffle.collective.waveBytes": "192k"}
    if name == "unregistered":
        return three + [_loc(mod, 4, BLOCK, "nobody")], {}
    raise KeyError(name)


PLAN_CASES = ["three_lanes", "two_lanes", "ring_knob", "solo", "mixed",
              "disabled", "ragged", "ragged_tight", "unregistered"]


@pytest.mark.parametrize("dtype", [np.uint8, np.uint32])
@pytest.mark.parametrize("case", PLAN_CASES)
def test_plan_matches_jax(lanes, case, dtype):
    ja, ta = lanes
    jlocs, knobs = _plan_case(case, jloc)
    tlocs, _ = _plan_case(case, tloc)
    jplan = JaxCompiler(JaxConf(dict(knobs)), ja, "cs-plan").plan(jlocs, dtype)
    tplan = ShuffleScheduleCompiler(TpuShuffleConf(dict(knobs)), ta,
                                    "cs-plan").plan(tlocs, dtype)
    assert _norm(tplan) == _norm(jplan)


# ----------------------------------------------------------------------
# execution over one staged stage carried across
# ----------------------------------------------------------------------
EXECS = ["cx-0", "cx-1", "cx-2"]


@pytest.fixture()
def staged(request):
    """Every executor stages one block per partition (3 pids) in a JAX
    arena, typed as the test asks (uint32 by default); the port's arenas
    are built from a snapshot of them."""
    dtype = getattr(request, "param", np.uint32)
    rng = np.random.default_rng(77)
    jarenas = {e: JaxArena() for e in EXECS}
    jlocs, state = [], {}
    for k, e in enumerate(EXECS):
        for p in range(3):
            data = rng.integers(0, 256, BLOCK + 4 * (3 * k + p), np.uint8)
            buf = jarenas[e].stage_view(data, data.nbytes, dtype)
            jlocs.append(jloc.PartitionLocation(
                jloc.ShuffleManagerId("host", 1, e), p,
                jloc.BlockLocation(0, data.nbytes, 100 + 3 * k + p,
                                   device_coords=0, arena_handle=buf.handle),
            ))
        state[e] = [(h, np.asarray(b.array), b.length)
                    for h, b in jarenas[e]._handles.items()]
    tarenas, tlocs = from_jax_state(
        state, [dataclasses.asdict(x) for x in jlocs], device="cpu"
    )
    red_j, red_t = JaxArena(), TorchArena("cpu")
    for e in EXECS:
        jdf.register_arena(e, jarenas[e])
        tdf.register_arena(e, tarenas[e])
    try:
        yield jlocs, tlocs, red_j, red_t, tarenas, np.dtype(dtype)
    finally:
        for e in EXECS:
            jdf.unregister_arena(e, jarenas[e])
            tdf.unregister_arena(e, tarenas[e])


def _by_pid(results):
    out = {}
    for r in results:
        out.setdefault(r.pid, []).append(bytes(r.dev.read(0, r.dev.length)))
        r.dev.free()
    return out


def _run(compiler, locs, dtype, fused):
    plan = compiler.plan(locs, dtype)
    results, degraded = compiler.execute(7, plan, dtype, fused=fused)
    return _by_pid(results), degraded


KNOBS = {"tpu.shuffle.collective.autoTune": "false"}


@pytest.mark.parametrize("kernel_path", [False, True])
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("staged", [np.uint8, np.uint32], indirect=True)
def test_execute_matches_jax(staged, monkeypatch, fused, kernel_path):
    jlocs, tlocs, red_j, red_t, _, dtype = staged
    if kernel_path:
        # the CUDA branch's logic, with the wave pull's plain version
        monkeypatch.setattr(ShuffleScheduleCompiler, "_kernel_path",
                            lambda self: True)
    want, jdeg = _run(JaxCompiler(JaxConf(KNOBS), red_j, "cx-red"), jlocs,
                      dtype, fused)
    got, tdeg = _run(ShuffleScheduleCompiler(TpuShuffleConf(KNOBS), red_t,
                                             "cx-red"), tlocs, dtype, fused)
    assert jdeg == [] and tdeg == []
    if fused:
        assert all(len(v) == 1 for v in got.values())
        assert got == want  # one slab per pid, same merge order
    else:
        assert {p: sorted(v) for p, v in got.items()} == \
            {p: sorted(v) for p, v in want.items()}


@pytest.mark.parametrize("kernel_path", [False, True])
def test_depth_two_equals_depth_one_and_overlaps(staged, monkeypatch,
                                                 kernel_path):
    _, tlocs, _, red_t, _, _ = staged
    if kernel_path:
        monkeypatch.setattr(ShuffleScheduleCompiler, "_kernel_path",
                            lambda self: True)
    overlap = get_registry().counter("collective.wave_overlap_ms",
                                     role="cx-depth")
    out = {}
    for depth in (1, 2):
        conf = TpuShuffleConf(dict(KNOBS, **{
            "tpu.shuffle.collective.waveBytes": "128k",
            "tpu.shuffle.collective.pipelineDepth": str(depth),
        }))
        o0 = overlap.value
        comp = ShuffleScheduleCompiler(conf, red_t, "cx-depth")
        plan = comp.plan(tlocs, np.uint32)
        assert len(plan.waves) > 2
        results, degraded = comp.execute(7, plan, np.uint32)
        assert not degraded
        out[depth] = {p: sorted(v) for p, v in _by_pid(results).items()}
        if depth == 1:
            assert overlap.value == o0
        else:
            assert overlap.value > o0
    assert out[1] == out[2]


def test_dtype_mismatch_degrades_like_jax(staged):
    jlocs, tlocs, red_j, red_t, _, _ = staged
    # blocks staged as uint32, fetched as uint8: every row misses
    want, jdeg = _run(JaxCompiler(JaxConf(KNOBS), red_j, "cx-dt"), jlocs,
                      np.uint8, False)
    got, tdeg = _run(ShuffleScheduleCompiler(TpuShuffleConf(KNOBS), red_t,
                                             "cx-dt"), tlocs, np.uint8, False)
    assert got == want == {}
    assert [dataclasses.asdict(x) for x in tdeg] == \
        [dataclasses.asdict(x) for x in jdeg]
    assert len(tdeg) == len(tlocs)


def test_residency_miss_degrades_like_jax(staged):
    jlocs, tlocs, red_j, red_t, tarenas, _ = staged
    victim = 4  # cx-1's pid-1 block
    jcomp = JaxCompiler(JaxConf(KNOBS), red_j, "cx-deg")
    tcomp = ShuffleScheduleCompiler(TpuShuffleConf(KNOBS), red_t, "cx-deg")
    jplan = jcomp.plan(jlocs, np.uint32)
    tplan = tcomp.plan(tlocs, np.uint32)
    # the slab is spilled between plan and pin on both sides
    jdf.visible_arena("cx-1").resolve(jlocs[victim].block.arena_handle).spill_to_host()
    tarenas["cx-1"].resolve(tlocs[victim].block.arena_handle).spill_to_host()
    degrades = get_registry().counter("collective.degrades", role="cx-deg")
    d0 = degrades.value
    jres, jdeg = jcomp.execute(7, jplan, np.uint32, fused=True)
    tres, tdeg = tcomp.execute(7, tplan, np.uint32, fused=True)
    assert [dataclasses.asdict(x) for x in tdeg] == \
        [dataclasses.asdict(x) for x in jdeg]
    assert len(tdeg) == 1 and degrades.value - d0 == 1
    # the degraded pid unfuses; survivors land per block
    assert _by_pid(tres) == _by_pid(jres)


def test_kernel_errors_propagate(staged, monkeypatch):
    """A failing mover is an error, never a silent degrade."""
    from sparkrdma_tpu_torch.ops import remote_copy

    _, tlocs, _, red_t, _, _ = staged
    monkeypatch.setattr(ShuffleScheduleCompiler, "_kernel_path",
                        lambda self: True)

    def broken(*a, **k):
        raise RuntimeError("srt_wave_pull launch failed")

    monkeypatch.setattr(remote_copy, "wave_pull", broken)
    comp = ShuffleScheduleCompiler(TpuShuffleConf(KNOBS), red_t, "cx-err")
    plan = comp.plan(tlocs, np.uint32)
    with pytest.raises(RuntimeError, match="launch failed"):
        comp.execute(7, plan, np.uint32)
    assert red_t.in_use_bytes == 0
    # every pin was released on the way out
    for e in EXECS:
        assert not tdf.visible_arena(e)._pins



# ----------------------------------------------------------------------
# the per-block planner and the bucket helpers the compiler builds on
# ----------------------------------------------------------------------
@pytest.mark.parametrize("case", ["pull", "below_min", "no_device",
                                  "not_visible", "spilled", "stale",
                                  "dtype", "disabled"])
def test_device_fetch_plane_matches_jax(staged, case):
    from sparkrdma_tpu.shuffle.device_fetch import DeviceFetchPlane as JaxPlane
    from sparkrdma_tpu_torch.shuffle.device_fetch import DeviceFetchPlane

    jlocs, tlocs, red_j, red_t, tarenas, _ = staged
    jl, tl = jlocs[4], tlocs[4]
    knobs, dtype = dict(KNOBS), np.uint32
    if case == "below_min":
        knobs["tpu.shuffle.deviceFetch.minBlockBytes"] = "1m"
    elif case == "disabled":
        knobs["tpu.shuffle.deviceFetch.enabled"] = "false"
    elif case == "dtype":
        dtype = np.uint8
    elif case in ("no_device", "not_visible", "stale"):
        change = {"no_device": {"arena_handle": 0},
                  "stale": {"arena_offset": 1 << 20}}.get(case, {})
        if case == "not_visible":
            jl = dataclasses.replace(jl, manager_id=jloc.ShuffleManagerId("h", 1, "x"))
            tl = dataclasses.replace(tl, manager_id=tloc.ShuffleManagerId("h", 1, "x"))
        else:
            jl = dataclasses.replace(jl, block=dataclasses.replace(jl.block, **change))
            tl = dataclasses.replace(tl, block=dataclasses.replace(tl.block, **change))
    elif case == "spilled":
        jdf.visible_arena("cx-1").resolve(jl.block.arena_handle).spill_to_host()
        tarenas["cx-1"].resolve(tl.block.arena_handle).spill_to_host()
    jplane = JaxPlane(JaxConf(knobs), red_j, "cx-plane")
    tplane = DeviceFetchPlane(TpuShuffleConf(knobs), red_t, "cx-plane")
    fb = get_registry().counter("device_fetch.plane.fallbacks", role="cx-plane")
    f0 = fb.value
    jgot = jplane.try_pull(jl, dtype)
    tgot = tplane.try_pull(tl, dtype)
    assert (jgot is None) == (tgot is None) == (case != "pull")
    if tgot is not None:
        assert tgot.read() == jgot.read() and tgot.length == jl.block.length
        assert tgot.array.dtype == torch.uint32
    silent = case in ("no_device", "disabled")
    assert fb.value - f0 == (0 if silent or case == "pull" else 1)


def test_exchange_helpers_match_jax():
    from sparkrdma_tpu.ops import exchange as jex
    from sparkrdma_tpu_torch.ops import exchange as tex

    for n in (0, 1, 1023, 1024, 1025, 4096, 70_000, (1 << 31) + 5):
        assert tex.round_bucket(n) == jex.round_bucket(n)
    for n in (0, 1, 2, 3, 5, 64, 65):
        assert tex.round_rows(n) == jex.round_rows(n)
    blocks = [b"a" * 10, b"", bytes(range(64))]
    js, jc = jex.pack_blocks(blocks, 64)
    ts, tc = tex.pack_blocks(blocks, 64)
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_array_equal(tc, jc)
    assert tex.unpack_blocks(ts, tc) == jex.unpack_blocks(js, jc) == blocks
    with pytest.raises(ValueError):
        tex.pack_blocks([b"x" * 65], 64)
