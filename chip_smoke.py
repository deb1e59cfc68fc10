#!/usr/bin/env python3
"""Drive the port's main path once on one NVIDIA GPU and check it.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA device and ``nvcc`` (the kernels are built from the checkout's
sources at first use). Without a CUDA device, or outside a checkout, it
exits nonzero and prints no result. Phases, each one JSON line:

0. environment: card, power limit, torch and CUDA versions, build time;
1. every wave-pull kernel entry point against its plain version, byte
   for byte, over ragged, offset, padded and large shapes;
2. the device-resident TeraSort reduce stage at the README's end-to-end
   size (2^28 uniform uint32 keys, 1 GiB; 8 map executors, 8 reducers):
   map shards sorted and cut on the device, blocks staged into each
   executor's arena, every reducer's partition compiled into waves,
   pulled by the kernels and merged. Run (a) uses the default knobs
   (pipelined 2-row waves), run (b) ``collective.waveBytes=512m`` with
   fusion (one single-wave launch and one fused slab per reducer).
   Every reducer's output is checked against ``np.sort`` of its key
   range and against the input's count, sum and xor;
3. ``TeraSorter.step`` for one device at the ``entry()`` shape;
4. ``attention_kernel``: ``srt_flash_attn_fwd`` against its plain
   version (``flash_attention_reference`` on the card) over eight shapes,
   f32 and bf16, causal and not, S from 1 to 4096, D from 4 to 256, out
   and lse (fp32 rtol 2e-4 / atol 2e-5, bf16 1e-2 / 1e-2, lse atol 1e-4),
   plus a misaligned q; together they reach both of the kernel's load
   paths and all four of its tile variants;
5. ``attention_path``: the attention serving path through its public
   entry points at the repo's two full widths (bench.py's B4 S2048 H8
   D128 bf16 causal, the transformer workload's B4 S2048 H8 D64 fp32
   non-causal): ``UlyssesAttention(1)`` answers 3 calls, each checked
   against the plain version, and ``RingAttention(1)`` against Ulysses;
   per-call wall, flash launches and peak device memory.

Then the timing phase (every kernel at its main path's shapes: the
kernel's time against its bound, the plain version's and, for flash
attention, ``scaled_dot_product_attention``'s as a yardstick), the
kernels line (launches on the main path), and last ``{"ok": true,
"device": ...}``. f32 matrix products run in full f32 (TF32 off).
Any failed check raises and the script exits nonzero.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
BF16_TENSOR_FLOPS = 989e12  # dense bf16 tensor-core peak, same sheet
F32_FLOPS = 67e12  # f32 outside the tensor cores, same sheet
KEYS = 1 << 28
EXECUTORS = 8
REDUCERS = 8


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def device_busy_us(torch, prof):
    """Device time of the activities a profile recorded on the GPU
    (kernels, copies, fills), in microseconds. Host-side operators are
    left out: their device time is their kernels' again."""
    cuda = torch.autograd.DeviceType.CUDA
    return sum(e.self_device_time_total for e in prof.key_averages()
               if getattr(e, "device_type", None) == cuda)


def device_ms_per_call(torch, fn, n):
    """Device time per call of ``fn``, or None when the profiler
    records no device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    us = device_busy_us(torch, prof)
    return us / 1e3 / n if us > 0 else None


def event_ms_per_call(torch, fn, n):
    """Time per call between CUDA events over ``n`` queued calls, after
    one warm-up call."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


# ----------------------------------------------------------------------
def phase_environment(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    from sparkrdma_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.load()
    emit(0, nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
         device=torch.cuda.get_device_name(0),
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
         float32_matmul_precision=torch.get_float32_matmul_precision(),
         build_s=_build.build_seconds, load_s=time.perf_counter() - t0,
         ptxas=[ln.strip() for ln in _build.build_log.splitlines()
                if "ptxas info" in ln or "spill" in ln])


def _cases(torch, dev):
    """(dtype, rows_b, bucket_elems, rows) per case; a row is (source,
    byte offset, nbytes) or None for a pad row."""
    g = torch.Generator(device="cpu").manual_seed(7)

    def slab(nbytes):
        return torch.randint(0, 256, (nbytes,), dtype=torch.uint8,
                             generator=g).to(dev)

    u8, u32 = torch.uint8, torch.uint32
    big = slab(48 << 20)
    cases = [
        (u8, 1, 1024, [(slab(4096), 0, 0)]),
        (u8, 1, 1024, [(slab(4096), 512, 1024)]),
        (u8, 2, 4096, [(slab(8192), 3, 1000), (slab(8192), 17, 4096)]),
        (u8, 2, 1000, [(slab(2048), 1, 999), None]),
        (u32, 8, 16 << 10,
         [(slab(1 << 17).view(u32), 4 * k, 4 * (3000 * k % (16 << 10)))
          for k in range(5)] + [None, None, None]),
        (u8, 64, 16 << 10,
         [None if k % 7 == 3 else (slab(40 << 10), (k * 131) % 4096,
                                   (k * 977) % (16 << 10) + (k == 5))
          for k in range(60)]),
        (u32, 2, 8 << 20,
         [(big.view(u32), 0, 32 << 20), (big.view(u32), 16, (16 << 20) + 12)]),
        (u8, 2, 32 << 20, [(big, 5, (32 << 20) - 7), (big, 0, 0)]),
    ]
    return cases


def phase_kernels(torch, dev):
    from sparkrdma_tpu_torch.ops import remote_copy as rc

    checked = 0
    for dtype, rows_b, be, rows in _cases(torch, dev):
        srcs = [r[0] if r else None for r in rows]
        offs = [r[1] if r else 0 for r in rows]
        nbs = [r[2] if r else 0 for r in rows]
        got = rc.wave_pull(srcs, offs, nbs, rows_b, be, dtype)
        want = rc.wave_pull_reference(srcs, offs, nbs, rows_b, be, dtype)[0]
        # the pipelined form: this wave, then the same rows reversed
        pad = [None] * (rows_b - len(rows))
        prows = rows + pad + rows[::-1] + pad
        rsrcs = [r[0] if r else None for r in prows]
        roffs = [r[1] if r else 0 for r in prows]
        rnbs = [r[2] if r else 0 for r in prows]
        gotp = rc.pipelined_wave_pull(rsrcs, roffs, rnbs, rows_b, be, dtype, 2)
        wantp = rc.wave_pull_reference(rsrcs, roffs, rnbs, rows_b, be, dtype, 2)
        torch.cuda.synchronize()
        for a, b, name in ((got, want, "srt_wave_pull"),
                           (gotp, wantp, "srt_pipelined_wave_pull")):
            if not torch.equal(a.view(torch.uint8), b.view(torch.uint8)):
                raise AssertionError(
                    f"{name} differs from its plain version: dtype {dtype}, "
                    f"rows_b {rows_b}, bucket_elems {be}"
                )
        checked += 1
    emit(1, cases=checked, launches={
        "srt_wave_pull": rc.wave_pull_launches,
        "srt_pipelined_wave_pull": rc.pipelined_wave_pull_launches,
    }, equal=True)


# ----------------------------------------------------------------------
def _expected(shards, edges):
    """Per-reducer expected keys (np.sort of its range) and checksums."""
    everything = np.sort(np.concatenate(shards))
    cuts = np.concatenate([[0], np.searchsorted(everything, edges), [len(everything)]])
    want = []
    for r in range(REDUCERS):
        part = everything[cuts[r]:cuts[r + 1]]
        with np.errstate(over="ignore"):
            s = part.sum(dtype=np.uint32)
        x = np.bitwise_xor.reduce(part) if len(part) else np.uint32(0)
        want.append((part, len(part), int(s), int(x)))
    # count, sum and xor also from the unsorted input, independently
    cnt = np.zeros(REDUCERS, np.int64)
    s = np.zeros(REDUCERS, np.uint32)
    x = np.zeros(REDUCERS, np.uint32)
    for sh in shards:
        dest = np.searchsorted(edges, sh, side="right")
        for r in range(REDUCERS):
            sel = sh[dest == r]
            cnt[r] += len(sel)
            with np.errstate(over="ignore"):
                s[r] += sel.sum(dtype=np.uint32)
            x[r] ^= np.bitwise_xor.reduce(sel) if len(sel) else np.uint32(0)
    for r in range(REDUCERS):
        if (int(cnt[r]), int(s[r]), int(x[r])) != want[r][1:]:
            raise AssertionError(f"reference checksums disagree for reducer {r}")
    return want


def phase_main_path(torch, dev):
    from sparkrdma_tpu_torch.locations import (
        BlockLocation, PartitionLocation, ShuffleManagerId,
    )
    from sparkrdma_tpu_torch.models.terasort import MapShardSorter, merge_blocks
    from sparkrdma_tpu_torch.obs import get_registry
    from sparkrdma_tpu_torch.ops import remote_copy as rc
    from sparkrdma_tpu_torch.ops.hbm_arena import DeviceBufferManager
    from sparkrdma_tpu_torch.shuffle import device_fetch
    from sparkrdma_tpu_torch.shuffle.collective import ShuffleScheduleCompiler
    from sparkrdma_tpu_torch.utils.config import TpuShuffleConf

    rng = np.random.default_rng(12)
    shards = [rng.integers(0, 1 << 32, KEYS // EXECUTORS, dtype=np.uint32)
              for _ in range(EXECUTORS)]
    edges = np.asarray([(r << 32) // REDUCERS for r in range(1, REDUCERS)],
                       np.uint32)
    t0 = time.perf_counter()
    want = _expected(shards, edges)
    reference_s = time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    base_conf = TpuShuffleConf()
    ids = [f"exec-{e}" for e in range(EXECUTORS)]
    arenas = [DeviceBufferManager(dev, max_bytes=base_conf.hbm_max_bytes)
              for _ in ids]
    for i, a in zip(ids, arenas):
        device_fetch.register_arena(i, a)
    sorter = MapShardSorter(dev)
    locs = {r: [] for r in range(REDUCERS)}

    # ---- map phase: device sort + cut, stage each block into the arena
    torch.cuda.synchronize()
    t_map = time.perf_counter()
    for e, (eid, arena) in enumerate(zip(ids, arenas)):
        keys, bounds = sorter.sort_partition(shards[e], edges)
        for r in range(REDUCERS):
            blk = keys[bounds[r]:bounds[r + 1]]
            buf = arena.stage_view(blk, blk.nbytes, np.uint32)
            locs[r].append(PartitionLocation(
                ShuffleManagerId("localhost", 0, eid), r,
                BlockLocation(0, blk.nbytes, e + 1, device_coords=0,
                              arena_handle=buf.handle, arena_offset=0),
            ))
    torch.cuda.synchronize()
    map_s = time.perf_counter() - t_map

    reg = get_registry()

    def counter_sum(name):
        return sum(reg.counter(name, role=i).value for i in ids)

    def reduce_stage(conf, fused, check):
        outs, kernel_ms = [], []
        torch.cuda.synchronize()
        t = time.perf_counter()
        for r in range(REDUCERS):
            comp = ShuffleScheduleCompiler(conf, arenas[r], ids[r])
            plan = comp.plan(locs[r], np.uint32)
            if plan.passthrough or plan.device_blocks != EXECUTORS:
                raise AssertionError(f"reducer {r}: blocks left the schedule")
            results, degraded = comp.execute(0, plan, np.uint32, fused=fused)
            if degraded:
                raise AssertionError(f"reducer {r}: {len(degraded)} rows degraded")
            merged, total = merge_blocks(
                [res.dev.array[: res.dev.length // 4] for res in results]
            )
            for res in results:
                res.dev.free()
            outs.append((merged, total))
            kernel_ms.extend(comp.kernel_ms)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        if check:
            for r, (merged, total) in enumerate(outs):
                part, cnt, s, x = want[r]
                got = merged[: int(total)].cpu().numpy()
                if int(total) != cnt or not np.array_equal(got, part):
                    raise AssertionError(f"reducer {r} output differs from np.sort")
                with np.errstate(over="ignore"):
                    gs = int(got.sum(dtype=np.uint32))
                gx = int(np.bitwise_xor.reduce(got)) if len(got) else 0
                if (gs, gx) != (s, x):
                    raise AssertionError(f"reducer {r} checksums differ")
        return wall, kernel_ms

    runs = {
        "a": (TpuShuffleConf(), False),
        "b": (TpuShuffleConf({"tpu.shuffle.collective.waveBytes": "512m"}), True),
    }
    # ---- the main path: counts from 0 just before, read just after
    rc.reset_launch_counts()
    report = {}
    for name, (conf, fused) in runs.items():
        before = {k: counter_sum(f"collective.{k}")
                  for k in ("blocks", "degrades", "fused_merges")}
        w0, p0 = rc.wave_pull_launches, rc.pipelined_wave_pull_launches
        reduce_s, kernel_ms = reduce_stage(conf, fused, check=True)
        deltas = {k: counter_sum(f"collective.{k}") - v for k, v in before.items()}
        report[name] = {
            "wave_bytes": conf.collective_wave_bytes, "fused": fused,
            "map_s": map_s, "reduce_s": reduce_s, "total_s": map_s + reduce_s,
            "e2e_gbps": KEYS * 4 / (map_s + reduce_s) / 1e9,
            "reduce_gbps": KEYS * 4 / reduce_s / 1e9,
            "kernel_ms": kernel_ms, "kernel_ms_sum": sum(kernel_ms),
            "srt_wave_pull_launches": rc.wave_pull_launches - w0,
            "srt_pipelined_wave_pull_launches":
                rc.pipelined_wave_pull_launches - p0,
            **{f"collective.{k}": v for k, v in deltas.items()},
        }
    launches = {"srt_wave_pull": rc.wave_pull_launches,
                "srt_pipelined_wave_pull": rc.pipelined_wave_pull_launches}
    peak = torch.cuda.max_memory_allocated()
    for name, r in report.items():
        if r["collective.blocks"] != EXECUTORS * REDUCERS:
            raise AssertionError(f"run {name}: {r['collective.blocks']} blocks rode waves")
        if r["collective.degrades"] != 0:
            raise AssertionError(f"run {name}: rows degraded")
    if report["b"]["collective.fused_merges"] != REDUCERS:
        raise AssertionError("run b: not one fused merge per reducer")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel was never launched on the main path: {launches}")

    # ---- device idle share over each reduce stage, from a profiled repeat
    from torch.profiler import ProfilerActivity, profile

    for name, (conf, fused) in runs.items():
        # the first reduce above paid the arenas' first allocations; a
        # second one, unprofiled, is the warm figure
        warm_s, warm_kernel_ms = reduce_stage(conf, fused, check=False)
        report[name]["reduce_warm_s"] = warm_s
        report[name]["reduce_warm_gbps"] = KEYS * 4 / warm_s / 1e9
        report[name]["e2e_warm_gbps"] = KEYS * 4 / (map_s + warm_s) / 1e9
        report[name]["idle_share_wave_kernels_warm"] = (
            1 - sum(warm_kernel_ms) / (warm_s * 1e3)
        )
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            wall, _ = reduce_stage(conf, fused, check=False)
        busy_ms = device_busy_us(torch, prof) / 1e3
        cuda = torch.autograd.DeviceType.CUDA
        top = sorted((e for e in prof.key_averages()
                      if getattr(e, "device_type", None) == cuda),
                     key=lambda e: -e.self_device_time_total)[:6]
        report[name]["top_device_ops_ms"] = [
            [e.key[:60], e.self_device_time_total / 1e3, e.count] for e in top
        ]
        report[name]["profiled_reduce_s"] = wall
        report[name]["device_busy_ms"] = busy_ms
        report[name]["idle_share_profiler"] = (
            1 - busy_ms / (wall * 1e3) if busy_ms > 0 else None
        )
        report[name]["idle_share_wave_kernels"] = (
            1 - report[name]["kernel_ms_sum"] / (report[name]["reduce_s"] * 1e3)
        )
    emit(2, keys=KEYS, executors=EXECUTORS, reducers=REDUCERS,
         reference_s=reference_s, peak_device_bytes=peak,
         launches=launches, runs=report)
    return arenas, ids, locs, launches


def phase_timing(torch, dev, arenas, ids, locs):
    """Each kernel at the main path's own shapes (reducer 0's first
    pipelined entry in run a, its single wave in run b): the kernel, the
    plain version and a same-bytes ``copy_``."""
    from sparkrdma_tpu_torch.ops import _build
    from sparkrdma_tpu_torch.ops import remote_copy as rc
    from sparkrdma_tpu_torch.shuffle import device_fetch
    from sparkrdma_tpu_torch.shuffle.collective import ShuffleScheduleCompiler
    from sparkrdma_tpu_torch.utils.config import TpuShuffleConf

    def entry_rows(conf, want_waves):
        comp = ShuffleScheduleCompiler(conf, arenas[0], ids[0])
        for r in range(REDUCERS):
            plan = comp.plan(locs[r], np.uint32)
            for group in comp._coalesce(plan.waves, conf.collective_pipeline_depth):
                if len(group) == want_waves:
                    srcs, offs, nbs = [], [], []
                    for w in group:
                        for row in w.rows:
                            b = row.loc.block
                            arena = device_fetch.visible_arena(row.loc.manager_id.executor_id)
                            srcs.append(arena.resolve(b.arena_handle).array)
                            offs.append(b.arena_offset)
                            nbs.append(b.length)
                        pad = w.rows_b - len(w.rows)
                        srcs += [None] * pad
                        offs += [0] * pad
                        nbs += [0] * pad
                    return group[0].rows_b, group[0].bucket_elems, srcs, offs, nbs
        raise AssertionError(f"no {want_waves}-wave entry on the main path")

    out = []
    shapes = {
        "srt_wave_pull": (TpuShuffleConf({"tpu.shuffle.collective.waveBytes": "512m"}), 1),
        "srt_pipelined_wave_pull": (TpuShuffleConf(), 2),
    }
    for name, (conf, depth) in shapes.items():
        rows_b, be, srcs, offs, nbs = entry_rows(conf, depth)
        if depth == 1:
            def kernel():
                return rc.wave_pull(srcs, offs, nbs, rows_b, be, np.uint32)
        else:
            def kernel():
                return rc.pipelined_wave_pull(srcs, offs, nbs, rows_b, be,
                                              np.uint32, depth)

        def plain():
            out = rc.wave_pull_reference(srcs, offs, nbs, rows_b, be,
                                         np.uint32, depth)
            return out[0] if depth == 1 else out

        got, ref = kernel(), plain()
        torch.cuda.synchronize()
        if not torch.equal(got.view(torch.uint8), ref.view(torch.uint8)):
            raise AssertionError(f"{name} differs from its plain version")
        max_err = 0
        read_b = sum(nbs)
        write_b = depth * rows_b * be * 4
        moved = read_b + write_b
        half = moved // 2
        a = torch.empty(half, dtype=torch.uint8, device=dev)
        b = torch.empty(half, dtype=torch.uint8, device=dev)

        def copy():
            b.copy_(a)

        # the kernel alone: back-to-back launches of the C entry point
        # on a prebuilt row table (the wrapper's Python work excluded)
        lib = _build.load()
        table = torch.from_numpy(rc._check_rows(
            srcs, offs, nbs, depth * rows_b, be * 4, dev).view(np.int64)).to(dev)
        dst = torch.empty((depth * rows_b, be * 4), dtype=torch.uint8, device=dev)
        stream = torch.cuda.current_stream().cuda_stream

        def raw():
            if depth == 1:
                code = lib.srt_wave_pull(table.data_ptr(), dst.data_ptr(),
                                         rows_b, be * 4, stream)
            else:
                code = lib.srt_pipelined_wave_pull(
                    table.data_ptr(), dst.data_ptr(), depth, rows_b, be * 4,
                    stream)
            if code:
                raise RuntimeError(f"{name} launch failed ({code})")

        kernel_ms = event_ms_per_call(torch, raw, 50)
        plain_dev = device_ms_per_call(torch, plain, 20)
        copy_ms = event_ms_per_call(torch, copy, 50)
        copy_bw = 2 * half / (copy_ms / 1e3)
        out.append({
            "name": name, "route": "cuda",
            "source": "sparkrdma_tpu_torch/ops/csrc/wave_pull.cu",
            "replaces": ("sparkrdma_tpu/ops/remote_copy.py:206" if depth == 1
                         else "sparkrdma_tpu/ops/remote_copy.py:353"),
            "max_abs_err": max_err,
            "ms": kernel_ms,
            "plain_ms": plain_dev if plain_dev is not None
            else event_ms_per_call(torch, plain, 20),
            "bound_ms": moved / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "library_ms": None,
            "copy_ms": copy_ms, "copy_gbps": copy_bw / 1e9,
            "bound_measured_ms": moved / copy_bw * 1e3,
            "wrapper_event_ms": event_ms_per_call(torch, kernel, 20),
            "kernel_profiler_ms": device_ms_per_call(torch, raw, 20),
            "plain_timer": "profiler" if plain_dev is not None else "cuda_events",
            "shape": {"depth": depth, "rows_b": rows_b, "bucket_elems": be,
                      "live_rows": sum(1 for s in srcs if s is not None),
                      "read_bytes": read_b, "written_bytes": write_b},
        })
    emit("timing", kernels=out)
    return out


def phase_terasort_step(torch, dev):
    from sparkrdma_tpu_torch.models.terasort import TeraSorter

    n_local = 1 << 16
    keys = np.random.default_rng(0).integers(0, 1 << 32, size=n_local,
                                             dtype=np.uint32)
    fn = TeraSorter(device=dev).step(n_local)
    merged, total, overflowed = fn(torch.from_numpy(keys).to(dev))
    got = merged.cpu().numpy()
    if int(total[0]) != n_local or int(overflowed) or not np.array_equal(got, np.sort(keys)):
        raise AssertionError("TeraSorter.step differs from np.sort")
    emit(3, n_local=n_local, equal=True)

# ----------------------------------------------------------------------
# attention: the flash forward kernel and the serving path above it
# ----------------------------------------------------------------------
TOL = {"float32": (2e-4, 2e-5), "bfloat16": (1e-2, 1e-2)}
LSE_ATOL = 1e-4
# (B, S, H, D, dtype, causal)
ATTN_KERNEL_SHAPES = [
    (1, 1, 1, 4, "float32", False),
    (2, 300, 3, 8, "float32", True),
    (1, 2000, 2, 64, "float32", False),
    (2, 1000, 4, 128, "bfloat16", True),
    (1, 4096, 4, 128, "bfloat16", True),
    (1, 1024, 2, 256, "float32", False),
    # D not a multiple of the 16-byte vector: the kernel's scalar loads
    (1, 77, 2, 6, "float32", True),
    (1, 130, 3, 20, "bfloat16", False),
]
# bench.py's flash headline; the transformer workload's attention
ATTN_PATH_SHAPES = {
    "bench_bf16_causal": (4, 2048, 8, 128, "bfloat16", True),
    "workload_f32": (4, 2048, 8, 64, "float32", False),
}


def _qkv(torch, dev, shape, seed):
    b, s, h, d, dtype, _ = shape
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((b, s, h, d), dtype=np.float32))
            .to(getattr(torch, dtype)).to(dev) for _ in range(3)]


def _max_err(torch, got, want, dtype, what):
    rtol, atol = TOL[dtype]
    g, w = got.float(), want.float()
    if not torch.isfinite(g).all():
        raise AssertionError(f"{what}: non-finite values")
    err = (g - w).abs()
    bad = err > atol + rtol * w.abs()
    if bad.any():
        raise AssertionError(
            f"{what}: {int(bad.sum())} of {g.numel()} values off, max abs "
            f"error {float(err.max())}"
        )
    return float(err.max())


def phase_attention_kernel(torch, dev):
    from sparkrdma_tpu_torch.ops import pallas_attention as pa

    cases = []
    for i, shape in enumerate(ATTN_KERNEL_SHAPES):
        b, s, h, d, dtype, causal = shape
        q, k, v = _qkv(torch, dev, shape, 100 + i)
        want, want_lse = pa.flash_attention_reference(q, k, v, causal,
                                                      want_lse=True)
        got = pa.flash_attention_fwd(q, k, v, causal)[0]
        got2, lse = pa.flash_attention_fwd(q, k, v, causal, want_lse=True)
        torch.cuda.synchronize()
        what = f"srt_flash_attn_fwd {shape}"
        err = _max_err(torch, got, want, dtype, what)
        err2 = _max_err(torch, got2, want, dtype, what + " (lse variant)")
        if lse.shape != (b, h, s):
            raise AssertionError(f"{what}: lse shape {tuple(lse.shape)}")
        lse_err = (lse - want_lse).abs()
        if not torch.isfinite(lse).all() or float(lse_err.max()) > LSE_ATOL:
            raise AssertionError(f"{what}: lse max abs error {float(lse_err.max())}")
        cases.append({"shape": [b, s, h, d], "dtype": dtype, "causal": causal,
                      "max_abs_err": max(err, err2),
                      "lse_max_abs_err": float(lse_err.max())})
    # a q 4 bytes past a 16-byte boundary: the scalar loads again
    shape = (1, 129, 2, 64, "float32", True)
    q, k, v = _qkv(torch, dev, shape, 99)
    qm = torch.empty(q.numel() + 1, dtype=q.dtype, device=dev)[1:].view_as(q)
    qm.copy_(q)
    got = pa.flash_attention(qm, k, v, causal=True)
    err = _max_err(torch, got, pa.flash_attention_reference(q, k, v, True)[0],
                   "float32", "srt_flash_attn_fwd misaligned q")
    cases.append({"shape": list(shape[:4]), "dtype": "float32", "causal": True,
                  "misaligned_q": True, "max_abs_err": err})
    emit(4, name="attention_kernel", cases=cases, launches=pa.flash_fwd_launches)


def phase_attention_path(torch, dev):
    """The serving path at full width: counts from 0 just before each
    shape's run, read just after."""
    from sparkrdma_tpu_torch.ops import RingAttention, UlyssesAttention
    from sparkrdma_tpu_torch.ops import pallas_attention as pa

    report, launches = {}, 0
    for name, shape in ATTN_PATH_SHAPES.items():
        b, s, h, d, dtype, causal = shape
        q, k, v = _qkv(torch, dev, shape, 21)
        want = pa.flash_attention_reference(q, k, v, causal)[0]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()  # inputs and earlier phases' arenas
        pa.reset_launch_counts()
        ul = UlyssesAttention(1)
        walls, outs = [], []
        for _ in range(3):
            t = time.perf_counter()
            outs.append(ul(q, k, v, causal=causal))
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
        t = time.perf_counter()
        ring_out = RingAttention(1)(q, k, v, causal=causal)
        torch.cuda.synchronize()
        ring_s = time.perf_counter() - t
        n = pa.flash_fwd_launches
        peak = torch.cuda.max_memory_allocated()
        if n <= 0:
            raise AssertionError(f"{name}: srt_flash_attn_fwd never launched")
        errs = []
        for i, out in enumerate(outs):
            if out.shape != q.shape or out.dtype != q.dtype:
                raise AssertionError(f"{name} call {i}: {out.shape} {out.dtype}")
            errs.append(_max_err(torch, out, want, dtype, f"{name} call {i}"))
        ring_err = _max_err(torch, ring_out, outs[0], dtype, f"{name} ring")
        launches += n
        flops = 4 * b * h * d * (s * (s + 1) // 2 if causal else s * s)
        report[name] = {
            "shape": [b, s, h, d], "dtype": dtype, "causal": causal,
            "ulysses_call_s": walls, "ring_call_s": ring_s,
            "ulysses_tflops_warm": flops / min(walls[1:]) / 1e12,
            "srt_flash_attn_fwd_launches": n, "peak_device_bytes": peak,
            "peak_above_baseline_bytes": peak - base,
            "max_abs_err_vs_plain": errs, "ring_vs_ulysses_max_abs_err": ring_err,
        }
    emit(5, name="attention_path", runs=report, launches=launches)
    return launches


def time_flash_attention(torch, dev):
    """srt_flash_attn_fwd at the serving path's two shapes: the C entry
    point alone on prebuilt outputs, the plain version, and
    ``scaled_dot_product_attention`` on [B, H, S, D] copies (a yardstick
    the port never calls)."""
    from sparkrdma_tpu_torch.ops import _build
    from sparkrdma_tpu_torch.ops import pallas_attention as pa

    F = torch.nn.functional
    lib = _build.load()
    stream = torch.cuda.current_stream().cuda_stream
    rec = {}
    for name, shape in ATTN_PATH_SHAPES.items():
        b, s, h, d, dtype, causal = shape
        q, k, v = _qkv(torch, dev, shape, 21)
        out = torch.empty_like(q)
        code = {"float32": 0, "bfloat16": 1}[dtype]

        def raw():
            rc = lib.srt_flash_attn_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                        out.data_ptr(), None, b, s, h, d, code,
                                        int(causal), stream)
            if rc:
                raise RuntimeError(f"srt_flash_attn_fwd launch failed ({rc})")

        def plain():
            return pa.flash_attention_reference(q, k, v, causal)[0]

        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))

        def library():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)

        raw()
        want = plain()
        torch.cuda.synchronize()
        err = _max_err(torch, out, want, dtype, f"timing {name}")
        # the yardstick's own accuracy is recorded, not gated
        lib_err = float((library().transpose(1, 2).float() - want.float())
                        .abs().max())
        kernel_ms = event_ms_per_call(torch, raw, 20)
        plain_ms = event_ms_per_call(torch, plain, 5)
        library_ms = event_ms_per_call(torch, library, 20)
        item = q.element_size()
        moved = 4 * b * s * h * d * item  # q, k, v read once, out written once
        flops = 4 * b * h * d * (s * (s + 1) // 2 if causal else s * s)
        peak = BF16_TENSOR_FLOPS if dtype == "bfloat16" else F32_FLOPS
        bytes_ms = moved / HBM_BYTES_PER_S * 1e3
        ops_ms = flops / peak * 1e3
        rec[name] = {
            "shape": [b, s, h, d], "dtype": dtype, "causal": causal,
            "max_abs_err": err, "ms": kernel_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "library_max_abs_err": lib_err,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "bytes": moved, "flops": flops, "peak_flops": peak,
            "tflops": flops / kernel_ms / 1e9,
        }
    head = rec["bench_bf16_causal"]
    entry = {
        "name": "srt_flash_attn_fwd", "route": "cuda",
        "source": "sparkrdma_tpu_torch/ops/csrc/flash_attn_fwd.cu",
        "replaces": "sparkrdma_tpu/ops/pallas_attention.py:189",
        **{k: head[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                "bound_by", "library_ms")},
        "timer": "cuda_events", "shapes": rec,
    }
    emit("timing_attention", kernels=[entry])
    return entry


def main():
    if not os.path.isdir(os.path.join(HERE, "sparkrdma_tpu_torch")):
        sys.exit("chip_smoke.py must run from a checkout of the repository")
    import torch

    if not torch.cuda.is_available():
        sys.exit("no CUDA device is available")
    sys.path.insert(0, HERE)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    # the plain versions' f32 products in full f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    t0 = time.perf_counter()
    phase_environment(torch)
    phase_kernels(torch, dev)
    arenas, ids, locs, launches = phase_main_path(torch, dev)
    kernels = phase_timing(torch, dev, arenas, ids, locs)
    phase_terasort_step(torch, dev)
    phase_attention_kernel(torch, dev)
    launches["srt_flash_attn_fwd"] = phase_attention_path(torch, dev)
    kernels.append(time_flash_attention(torch, dev))
    for k in kernels:
        k["launches"] = launches[k["name"]]
    for r in range(REDUCERS):
        for loc in locs[r]:
            arenas[ids.index(loc.manager_id.executor_id)].resolve(
                loc.block.arena_handle).free()
    for a in arenas:
        a.stop()
    emit("done", seconds=time.perf_counter() - t0)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
