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
4. ``attention_kernel``: the three forward kernels against their plain
   version (``flash_attention_reference`` on the card), out and lse
   (fp32 rtol 2e-4 / atol 2e-5, bf16 1e-2 / 1e-2, lse atol 1e-4), each
   case asserted to have gone through the kernel the route rule names
   (two launches a shape): ``srt_flash_attn_fwd`` on f32 and bf16 at
   odd D (4 to 256, S 1 to 1024) and two misaligned q's (f32 D 64, bf16
   D 128), together both of its load paths and all four of its tile
   variants; ``srt_flash_attn_fwd_sm90`` on ten bf16 shapes, D 64 and
   128, S 1, 77, 130, 1000 and 4096, causal and not, B and H above 1;
   ``srt_flash_attn_fwd_tf32x3`` on thirteen f32 shapes, D 64 and 128,
   causal and not, S 1, 77, 129, 1000 and 2048 (the workload's B4 S2048
   H8 D64 among them), each also held against its own plain version
   (``flash_attention_tf32x3_reference``) at the fp32 tolerance; two
   float16 shapes on ``srt_flash_attn_fwd`` at the bf16 tolerance;
5. ``attention_path``: the attention serving path through its public
   entry points at the repo's two full widths (bench.py's B4 S2048 H8
   D128 bf16 causal, the transformer workload's B4 S2048 H8 D64 fp32
   non-causal): ``UlyssesAttention()`` (one shard) answers 3 calls, each
   checked against the plain version, and ``RingAttention()`` against
   Ulysses;
   per-call wall, flash launches (every bench-shape launch on
   ``srt_flash_attn_fwd_sm90``, every workload launch on
   ``srt_flash_attn_fwd_tf32x3``) and peak device memory;
6. ``attention_bwd_kernel``: the three backward pairs against the plain
   backward (``flash_attention_bwd_reference`` on the card; fp32 rtol
   2e-4 / atol 2e-5, bf16 and float16 1e-2 / 1e-2), each case asserted
   to have gone through the pair the route rule names. The SIMT pair
   (``srt_flash_attn_bwd_dq``, ``srt_flash_attn_bwd_dkv``): f32 with D
   4, 6 and 256, bf16 with D 20 and 256, float16, S from 1 to 2048, and
   a misaligned ``do`` in f32 D 64 and in bf16 D 128. The bf16
   tensor-core pair (``srt_flash_attn_bwd_dq_sm90``,
   ``srt_flash_attn_bwd_dkv_sm90``): twelve bf16 shapes, D 64 and 128,
   causal and not, S 1, 77, 96, 129, 1000 and 2048, B and H above 1,
   each also held against its own plain version
   (``flash_attention_bwd_sm90_reference``, the same bf16 roundings of p
   and ds) within one bf16 step of the output (2^-7 relative) plus 1e-3,
   the summation order's share. The 3xTF32 pair
   (``srt_flash_attn_bwd_dq_tf32x3``, ``srt_flash_attn_bwd_dkv_tf32x3``):
   22 f32 shapes, D 64 and 128, causal and not, S 1, 50, 77, 129, 1000
   and 2048, each also held against its own plain version
   (``flash_attention_bwd_tf32x3_reference``) at the fp32 tolerance;
7. ``training_path``: ``TransformerStep(attn="ulysses")`` at the
   transformer workload's full width (``benchmarks/run_workloads.py``
   ``bench_transformer_train``: B4 S2048, d_model 512, 8 heads, d_hidden
   2048, fp32, lr 0.01, ``init_params`` seed 0, data from
   ``default_rng(3)``): step 1 held against ``reference_step`` and
   against ``attn="ring"`` on the card (loss rtol 1e-5, params rtol 1e-4
   / atol 1e-6; the block's gradients through the flash kernels within
   1e-3 of their largest value of the ring schedule's), then
   ``run_steps`` of 9 more with the workload's check that the loss ends
   at most 1.01 x the first; one launch a step each of
   ``srt_flash_attn_fwd_tf32x3``, ``srt_flash_attn_bwd_dq_tf32x3`` and
   ``srt_flash_attn_bwd_dkv_tf32x3`` and none of the SIMT forward;
   per-step wall, kernel launches per step,
   the kernels' share of a profiled step and peak device memory. Then
   bench.py's flash training step (B4 S2048 H8 D128 bf16 causal,
   ``flash_attention(...).float().sum()`` backward: one launch each of
   ``srt_flash_attn_fwd_sm90`` (with the lse),
   ``srt_flash_attn_bwd_dq_sm90`` and ``srt_flash_attn_bwd_dkv_sm90``,
   and none of the SIMT kernels), its gradients held against both plain
   backwards as in phase 6;
8. ``neighbor_pull_kernel``: ``srt_neighbor_pull`` against its plain
   version (``torch.roll``) byte for byte over 24 stacks: n 1, 2, 3 and
   8; shards of 1, 15, 4097 and 64 KiB + 3 bytes up to 128 MiB; uint8,
   int32, float32 and bfloat16; sources and destinations off their
   16-byte alignment; then both exchange schedules on a 3-shard mesh;
9. ``spmd_path``: the SPMD shuffle step on ``make_mesh([dev] * 8)``,
   eight shards on the card: (a) the dryrun's exchange
   (``__graft_entry__``: 64-byte buckets of ``1+src+dst`` bytes) through
   ``exchange`` and ``ring_exchange``; (b) the exchange study's 1 GiB
   send (``benchmarks/exchange_study.py``, 16 MiB buckets) through both
   schedules, 3 calls each, byte-equal to the sent blocks and to each
   other, equal stats, 14 neighbor-pull launches a ring call; (c)
   ``TeraSorter(mesh).sort`` of phase 2's 2^28 keys against one
   ``torch.sort`` on the card and the input's count, sum and xor, then
   the warm step; (d) at 2^24 keys the all-zero skew with
   ``capacity_factor=1.25`` (3 capacity doublings), ``adaptive=True``
   on it (one run) and a ``(dcn 2, exec 4)`` mesh;
10. ``host_plane_path``: the host plane on the card over the python
   transport, ``TpuShuffleManager`` and ``DeviceShuffleIO``: (a) dryrun
   sections 4 and 5 (``__graft_entry__``) on ``make_mesh([dev] * 4)``
   with their assertions (the pattern shuffle byte-equal and staged on
   the card; the big stage through the compiled waves, fused and per
   block, 16 blocks on the waves, 4 fused merges, overlap only at depth
   2), then CUDA-tensor blocks of int32, float16 and bfloat16 through
   ``stage_device_blocks`` and fetches typed with their dtypes; (b)
   phase 2's 1 GiB keys through a driver and 8 executors: every shard
   sorted by ``MapShardSorter``, staged and published, every reducer
   fetching its partition through the location RPC and the waves and
   merging, with default knobs and with ``waveBytes=512m`` fused (64
   blocks on the waves a reduce, 0 degrades, 8 fused merges, both
   wave-pull kernels launched), each reducer against ``np.sort`` of its
   range and the input's count, sum and xor; the map wall split (sort,
   stage: readback, checksum, arena copy; publish), the map again on
   warm pools, cold and warm reduce walls, fetch stats, peak device and
   registered host bytes, the driver's RPC counts; (c) the same
   published blocks with ``deviceFetch.enabled=false``: one-sided READs
   and host-to-device staging, byte-equal, no wave launch;
11. ``sp_training_path``: sequence parallelism and the (dp, sp, tp)
   training step on meshes of 8 shards of the card: (a) dryrun sections 2
   and 2b (``__graft_entry__``) at their own sizes with their assertions
   (``RingAttention`` and ``UlyssesAttention`` on ``make_mesh([dev] *
   8)`` within rtol 2e-4 / atol 2e-5 of the dense reference; both
   schedules of ``TransformerStep(make_training_mesh([dev] * 8))`` within
   loss rtol 1e-4 of ``reference_step``); (b) both classes on the 8-shard
   exec mesh at phase 5's two full widths, 3 calls each: the ring (14
   ``srt_neighbor_pull`` launches a call) against the one-shard ring
   (bench 1e-2 / 1e-2, workload 2e-4 / 2e-5) and against Ulysses on the
   mesh (bench 5e-2 / 5e-2, workload 2e-4 / 2e-5), Ulysses (one flash
   forward a call, on the route phase 5 names) against the one-shard
   Ulysses (bench 1e-2 / 1e-2, workload 2e-4 / 2e-5); per-call walls,
   launches, peak device memory and a profiled call of each; then the
   ring on the mesh once more at the workload width made causal, against
   the one-shard ring at 2e-4 / 2e-5 (the mask is what tells the hops'
   direction apart); (c) phase 7's workload step on
   (dp 2, sp 2, tp 2) with both schedules: step 1 against
   ``reference_step`` and phase 7's one-shard step (phase 7's bounds),
   every shard's gradients against the one-shard block's within
   TRAIN_GRAD_REL of their largest value (the new parameters hide
   them), ``run_steps`` of 9 more ending at most 1.01 x the first loss; Ulysses
   one launch a step each of the 3xTF32 forward, dq and dk/dv kernels,
   the ring 4 ``srt_neighbor_pull`` a step; warm step wall beside phase
   7's, launches, peak memory and a profiled step.
12. ``spmd_models``: the SPMD models on ``make_mesh([dev] * 8)`` at their
   users' sizes, data from fixed seeds: (a) ``HashJoin`` on TPC-DS SF100
   q72's ``catalog_sales`` (143,997,065 rows) joined to ``item``
   (204,000 unique keys, mixed over the 32-bit space by a multiplicative
   bijection so the radix split spreads them), exact: every probe row
   once, with its own key and the value a lookup in the sorted build
   keys on the card gives; (b) ``PageRank`` on a tenth of twitter-2010
   (4,165,223 vertices, 146,836,518 uniform edges, 20 iterations)
   against a float64 power iteration on the card (rtol 1e-4, atol 1e-4
   over the vertex count; the ranks sum to 1 within 1e-3); (c) ``ALS``
   at MovieLens-20M's counts (138,493 users, 26,744 items, 20,000,263
   ratings of a rank-4 model plus noise; rank 10, reg 0.1, 10
   iterations): one iteration against a float64 plain version on the
   card from the same start factors (rtol 2e-3, atol 2e-4), the RMSE
   after 10 within 5e-3 of the plain version's. Walls (data, upload,
   prepare, steps cold and warm, readback), peak device bytes and a
   profiled step each; no kernel launches (their exchanges are the dense
   all-to-all); ``MapShardSorter.warm`` once;

Then the timing phases (every kernel at its main path's shapes: the
kernel's time against its bound, the plain version's and, where one
PyTorch call computes the same function, its time as a yardstick:
``scaled_dot_product_attention`` forward and backward, ``torch.roll``;
at the bench shape the sm90 and SIMT forward kernels, in turns, and
both backward pairs; at the workload shape the 3xTF32 and SIMT forward
kernels, in turns, and the SIMT and the 3xTF32 backward pairs, a 3xTF32
kernel's bound 3 x its flops at the TF32 peak), ``second_device`` (bf16 B1 S256 H2 D128, launches above 48 KiB
of shared memory, through every flash entry point on ``cuda:1`` after
``cuda:0``, when there are two devices; with one it prints that it was
skipped and why),
the card's name and power limit again, the kernels line (launches on
the main paths), and last ``{"ok": true, "device": ...}``. f32 matrix
products run in full f32 (TF32 off). Any failed check raises and the
script exits nonzero.
"""

import contextlib
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
BF16_TENSOR_FLOPS = 989e12  # dense bf16 tensor-core peak, same sheet
F32_FLOPS = 67e12  # f32 outside the tensor cores, same sheet
TF32_TENSOR_FLOPS = 495e12  # dense TF32 tensor-core peak, same sheet
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


def ptxas_summary(log, key):
    """Registers, stack frame and spill bytes of each kernel whose mangled
    name holds ``key``, from the build's ``-Xptxas -v`` lines."""
    out, fn = {}, None
    for ln in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)", ln)
        if m:
            fn = m.group(1)
            continue
        if fn is None or key not in fn:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m:
            out.setdefault(fn, {}).update(zip(("stack", "spill_stores", "spill_loads"),
                                              map(int, m.groups())))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out.setdefault(fn, {})["registers"] = int(m.group(1))
    return out


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
                if "ptxas info" in ln or "spill" in ln or "warning" in ln],
         tf32x3_ptxas=ptxas_summary(_build.build_log, "tf32x3"))
    return smi


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


def _check_reducer(r, merged, total, want_r):
    """Reducer ``r``'s merged keys against ``np.sort`` of its range and
    the input's count, sum and xor."""
    part, cnt, s, x = want_r
    got = merged[: int(total)].cpu().numpy()
    if int(total) != cnt or not np.array_equal(got, part):
        raise AssertionError(f"reducer {r} output differs from np.sort")
    with np.errstate(over="ignore"):
        gs = int(got.sum(dtype=np.uint32))
    gx = int(np.bitwise_xor.reduce(got)) if len(got) else 0
    if (gs, gx) != (s, x):
        raise AssertionError(f"reducer {r} checksums differ")


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
                _check_reducer(r, merged, total, want[r])
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
    return arenas, ids, locs, launches, (shards, edges, want)


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
TOL = {"float32": (2e-4, 2e-5), "bfloat16": (1e-2, 1e-2), "float16": (1e-2, 1e-2)}
LSE_ATOL = 1e-4
# (B, S, H, D, dtype, causal)
ATTN_KERNEL_SHAPES = [
    # the SIMT kernel, srt_flash_attn_fwd: f32 at D other than 64 and 128
    (1, 1, 1, 4, "float32", False),
    (2, 300, 3, 8, "float32", True),
    (1, 1000, 2, 96, "float32", True),
    (1, 1024, 2, 256, "float32", False),
    # D not a multiple of the 16-byte vector: the kernel's scalar loads
    (1, 77, 2, 6, "float32", True),
    (1, 130, 3, 20, "bfloat16", False),
    # f32 with D 64 or 128: the 3xTF32 kernel, srt_flash_attn_fwd_tf32x3
    (1, 1, 1, 64, "float32", False),
    (2, 77, 2, 64, "float32", True),
    (3, 129, 2, 64, "float32", False),
    (2, 1000, 3, 64, "float32", True),
    (1, 2000, 2, 64, "float32", False),
    (1, 2048, 2, 64, "float32", True),
    (4, 2048, 8, 64, "float32", False),  # the transformer workload's attention
    (1, 1, 2, 128, "float32", True),
    (2, 77, 3, 128, "float32", False),
    (1, 129, 2, 128, "float32", True),
    (1, 1000, 2, 128, "float32", True),
    (2, 1000, 2, 128, "float32", False),
    (1, 2048, 2, 128, "float32", True),
    # bf16 with D 64 or 128: the tensor-core kernel, srt_flash_attn_fwd_sm90
    (2, 1, 3, 64, "bfloat16", False),
    (1, 1, 2, 128, "bfloat16", True),
    (2, 77, 2, 128, "bfloat16", True),
    (3, 130, 2, 64, "bfloat16", True),
    (2, 130, 3, 128, "bfloat16", False),
    (2, 1000, 3, 64, "bfloat16", True),
    (2, 1000, 4, 128, "bfloat16", True),
    (2, 1000, 2, 128, "bfloat16", False),
    (1, 4096, 2, 64, "bfloat16", False),
    (1, 4096, 4, 128, "bfloat16", True),
    # float16: the SIMT kernel, held at the bf16 tolerance
    (1, 77, 2, 64, "float16", True),
    (2, 130, 3, 128, "float16", False),
]
# bench.py's flash headline; the transformer workload's attention
ATTN_PATH_SHAPES = {
    "bench_bf16_causal": (4, 2048, 8, 128, "bfloat16", True),
    "workload_f32": (4, 2048, 8, 64, "float32", False),
}
FWD_KERNELS = ("srt_flash_attn_fwd", "srt_flash_attn_fwd_sm90", "srt_flash_attn_fwd_tf32x3")


def _qkv(torch, dev, shape, seed):
    b, s, h, d, dtype, _ = shape
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((b, s, h, d), dtype=np.float32))
            .to(getattr(torch, dtype)).to(dev) for _ in range(3)]


def _max_err(torch, got, want, dtype, what, tol=None):
    rtol, atol = tol or TOL[dtype]
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


def _fwd_entry(shape):
    """The forward kernel pallas_attention.fwd_entry names for these
    (aligned) inputs: bf16 with D 64 or 128 the tensor-core kernel, f32
    with D 64 or 128 the 3xTF32 kernel, the rest SIMT."""
    if shape[3] in (64, 128) and shape[4] in ("bfloat16", "float32"):
        return FWD_KERNELS[1] if shape[4] == "bfloat16" else FWD_KERNELS[2]
    return FWD_KERNELS[0]


def _lse_err(torch, lse, want, what):
    err = (lse - want).abs()
    if not torch.isfinite(lse).all() or float(err.max()) > LSE_ATOL:
        raise AssertionError(f"{what}: lse max abs error {float(err.max())}")
    return float(err.max())


def phase_attention_kernel(torch, dev):
    """The three forward kernels against the plain forward, each case
    asserted to have gone through the kernel the route rule names; the
    3xTF32 kernel also against its own plain version at the fp32
    tolerance."""
    from sparkrdma_tpu_torch.ops import pallas_attention as pa

    cases = []
    for i, shape in enumerate(ATTN_KERNEL_SHAPES):
        b, s, h, d, dtype, causal = shape
        entry = _fwd_entry(shape)
        q, k, v = _qkv(torch, dev, shape, 100 + i)
        want, want_lse = pa.flash_attention_reference(q, k, v, causal,
                                                      want_lse=True)
        before = _flash_launches(pa)
        got = pa.flash_attention_fwd(q, k, v, causal)[0]
        got2, lse = pa.flash_attention_fwd(q, k, v, causal, want_lse=True)
        torch.cuda.synchronize()
        took = _took(pa, before)
        what = f"{entry} {shape}"
        if took != {entry: 2}:
            raise AssertionError(f"{what}: launched {took}, expected 2 of {entry}")
        if lse.shape != (b, h, s):
            raise AssertionError(f"{what}: lse shape {tuple(lse.shape)}")
        case = {"shape": [b, s, h, d], "dtype": dtype, "causal": causal,
                "entry": entry,
                "max_abs_err": max(_max_err(torch, got, want, dtype, what),
                                   _max_err(torch, got2, want, dtype,
                                            what + " (lse variant)")),
                "lse_max_abs_err": _lse_err(torch, lse, want_lse, what)}
        if entry == "srt_flash_attn_fwd_tf32x3":
            own, own_lse = pa.flash_attention_tf32x3_reference(q, k, v, causal,
                                                               want_lse=True)
            what += " vs the tf32x3 plain version"
            case["max_abs_err_vs_tf32x3_plain"] = max(
                _max_err(torch, got, own, dtype, what),
                _max_err(torch, got2, own, dtype, what + " (lse variant)"))
            case["lse_max_abs_err_vs_tf32x3_plain"] = _lse_err(torch, lse, own_lse, what)
        cases.append(case)
    # a q off its 16-byte boundary (4 bytes f32, 2 bytes bf16): the SIMT
    # kernel and its scalar loads, also for f32 D 64 and bf16 D 128
    for shape in ((1, 129, 2, 64, "float32", True),
                  (1, 1000, 2, 128, "bfloat16", True)):
        dtype = shape[4]
        q, k, v = _qkv(torch, dev, shape, 99)
        qm = torch.empty(q.numel() + 1, dtype=q.dtype, device=dev)[1:].view_as(q)
        qm.copy_(q)
        before = _flash_launches(pa)
        got = pa.flash_attention(qm, k, v, causal=True)
        took = _took(pa, before)
        if took != {"srt_flash_attn_fwd": 1}:
            raise AssertionError(f"misaligned q {shape}: launched {took}, not the SIMT kernel")
        err = _max_err(torch, got, pa.flash_attention_reference(q, k, v, True)[0],
                       dtype, f"srt_flash_attn_fwd misaligned q {shape}")
        cases.append({"shape": list(shape[:4]), "dtype": dtype, "causal": True,
                      "entry": "srt_flash_attn_fwd", "misaligned_q": True,
                      "max_abs_err": err})
    emit(4, name="attention_kernel", cases=cases,
         launches={k: n for k, n in _flash_launches(pa).items() if k in FWD_KERNELS})


def phase_attention_path(torch, dev):
    """The serving path at full width: counts from 0 just before each
    shape's run, read just after."""
    from sparkrdma_tpu_torch.ops import RingAttention, UlyssesAttention
    from sparkrdma_tpu_torch.ops import pallas_attention as pa

    report = {}
    launches = dict.fromkeys(FWD_KERNELS, 0)
    for name, shape in ATTN_PATH_SHAPES.items():
        entry = _fwd_entry(shape)
        b, s, h, d, dtype, causal = shape
        q, k, v = _qkv(torch, dev, shape, 21)
        want = pa.flash_attention_reference(q, k, v, causal)[0]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()  # inputs and earlier phases' arenas
        pa.reset_launch_counts()
        ul = UlyssesAttention()
        walls, outs = [], []
        for _ in range(3):
            t = time.perf_counter()
            outs.append(ul(q, k, v, causal=causal))
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
        t = time.perf_counter()
        ring_out = RingAttention()(q, k, v, causal=causal)
        torch.cuda.synchronize()
        ring_s = time.perf_counter() - t
        n = pa.flash_fwd_launches
        took = {k: c for k, c in _flash_launches(pa).items() if c}
        peak = torch.cuda.max_memory_allocated()
        if n <= 0:
            raise AssertionError(f"{name}: the flash forward never launched")
        # the bench shape (bf16, D 128) runs the tensor-core kernel only, the
        # workload's (f32, D 64) the 3xTF32 kernel only
        if took != {entry: n}:
            raise AssertionError(f"{name}: forward launches {took}, not {n} of {entry}")
        errs = []
        for i, out in enumerate(outs):
            if out.shape != q.shape or out.dtype != q.dtype:
                raise AssertionError(f"{name} call {i}: {out.shape} {out.dtype}")
            errs.append(_max_err(torch, out, want, dtype, f"{name} call {i}"))
        ring_err = _max_err(torch, ring_out, outs[0], dtype, f"{name} ring")
        launches[entry] += n
        flops = 4 * b * h * d * (s * (s + 1) // 2 if causal else s * s)
        report[name] = {
            "shape": [b, s, h, d], "dtype": dtype, "causal": causal,
            "ulysses_call_s": walls, "ring_call_s": ring_s,
            "ulysses_tflops_warm": flops / min(walls[1:]) / 1e12,
            "flash_fwd_launches": n, "launches": took,
            "peak_device_bytes": peak,
            "peak_above_baseline_bytes": peak - base,
            "max_abs_err_vs_plain": errs, "ring_vs_ulysses_max_abs_err": ring_err,
        }
    emit(5, name="attention_path", runs=report, launches=launches)
    return launches


def time_flash_attention(torch, dev):
    """The forward kernels at the serving path's two shapes: each C entry
    point alone on prebuilt outputs (the tensor-core kernel the route rule
    names for the shape, ``srt_flash_attn_fwd_sm90`` at the bench shape
    and ``srt_flash_attn_fwd_tf32x3`` at the workload's, and the SIMT
    ``srt_flash_attn_fwd`` at both), each kernel's plain version (the
    3xTF32 products for tf32x3, f32 otherwise), and
    ``scaled_dot_product_attention`` on [B, H, S, D] copies (a yardstick
    the port never calls). The two kernels of a shape are timed in turns,
    tensor-core, SIMT, SIMT, tensor-core, and each reports the mean of its
    two readings. A 3xTF32 kernel's bound is 3 x its flops at the TF32
    peak (``bound_f32_ms`` its flops at the f32 peak, as the SIMT rows)."""
    from sparkrdma_tpu_torch.ops import _build
    from sparkrdma_tpu_torch.ops import pallas_attention as pa

    F = torch.nn.functional
    lib = _build.load()
    stream = torch.cuda.current_stream().cuda_stream
    rec = {}
    for name, shape in ATTN_PATH_SHAPES.items():
        b, s, h, d, dtype, causal = shape
        q, k, v = _qkv(torch, dev, shape, 21)
        code = {"float32": 0, "bfloat16": 1}[dtype]
        entries = (_fwd_entry(shape), FWD_KERNELS[0])
        outs = {e: torch.empty_like(q) for e in entries}
        plains = {e: (pa.flash_attention_tf32x3_reference if e.endswith("_tf32x3")
                      else pa.flash_attention_reference) for e in entries}

        def raw(entry):
            def call():
                rc = getattr(lib, entry)(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                         outs[entry].data_ptr(), None, b, s, h, d,
                                         code, int(causal), stream)
                if rc:
                    raise RuntimeError(f"{entry} launch failed ({rc})")
            return call

        def plain(fn):
            return lambda: fn(q, k, v, causal)[0]

        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))

        def library():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)

        want = pa.flash_attention_reference(q, k, v, causal)[0]
        for e in entries:
            raw(e)()
        torch.cuda.synchronize()
        errs = {e: _max_err(torch, outs[e], want, dtype, f"timing {name} {e}")
                for e in entries}
        for e in entries:
            if plains[e] is not pa.flash_attention_reference:
                _max_err(torch, outs[e], plain(plains[e])(), dtype,
                         f"timing {name} {e} vs its own plain version")
        # the yardstick's own accuracy is recorded, not gated
        lib_err = float((library().transpose(1, 2).float() - want.float())
                        .abs().max())
        readings = {e: [] for e in entries}
        for e in entries + entries[::-1]:
            readings[e].append(event_ms_per_call(torch, raw(e), 20))
        plain_ms = {e: event_ms_per_call(torch, plain(plains[e]), 5) for e in entries}
        library_ms = event_ms_per_call(torch, library, 20)
        item = q.element_size()
        moved = 4 * b * s * h * d * item  # q, k, v read once, out written once
        flops = 4 * b * h * d * (s * (s + 1) // 2 if causal else s * s)
        bytes_ms = moved / HBM_BYTES_PER_S * 1e3
        kernels = {}
        for e in entries:
            # the operations this kernel does on the card: 3 TF32 products a
            # product for tf32x3, one bf16 or f32 product otherwise
            ops, peak = {"srt_flash_attn_fwd_tf32x3": (3 * flops, TF32_TENSOR_FLOPS),
                         "srt_flash_attn_fwd_sm90": (flops, BF16_TENSOR_FLOPS)
                         }.get(e, (flops, F32_FLOPS))
            ops_ms = ops / peak * 1e3
            bound_ms = max(bytes_ms, ops_ms)
            ms = sum(readings[e]) / len(readings[e])
            kernels[e] = {"ms": ms, "ms_readings": readings[e], "max_abs_err": errs[e],
                          "tflops": flops / ms / 1e9, "plain_ms": plain_ms[e],
                          "bound_ms": bound_ms, "bound_share": bound_ms / ms,
                          "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
                          "bound_f32_ms": max(bytes_ms, flops / F32_FLOPS * 1e3),
                          "device_ops": ops, "peak_flops": peak}
        rec[name] = {
            "shape": [b, s, h, d], "dtype": dtype, "causal": causal,
            "kernels": kernels,
            "library_ms": library_ms, "library_max_abs_err": lib_err,
            "library_tflops": flops / library_ms / 1e9,
            "bytes": moved, "flops": flops,
        }

    def entry(kernel, source, shape_name):
        head = rec[shape_name]
        return {
            "name": kernel, "route": "cuda", "source": source,
            "replaces": "sparkrdma_tpu/ops/pallas_attention.py:189",
            **{k: head["kernels"][kernel][k]
               for k in ("max_abs_err", "ms", "tflops", "plain_ms", "bound_ms",
                         "bound_by", "bound_f32_ms")},
            "library_ms": head["library_ms"],
            "timer": "cuda_events", "shape_name": shape_name,
        }

    # each kernel's headline is the shape its main path gives it: the bench
    # shape goes to the bf16 tensor-core kernel, the workload's f32 to the
    # 3xTF32 kernel; the SIMT kernel keeps its workload_f32 reading, which
    # no main path runs now
    src = "sparkrdma_tpu_torch/ops/csrc/"
    out = [entry("srt_flash_attn_fwd", src + "flash_attn_fwd.cu", "workload_f32"),
           entry("srt_flash_attn_fwd_sm90", src + "flash_attn_fwd_sm90.cu",
                 "bench_bf16_causal"),
           entry("srt_flash_attn_fwd_tf32x3", src + "flash_attn_fwd_tf32x3.cu",
                 "workload_f32")]
    emit("timing_attention", kernels=out, shapes=rec)
    return out


# ----------------------------------------------------------------------
# training: the flash backward kernels and the transformer step above them
# ----------------------------------------------------------------------
# (B, S, H, D, dtype, causal)
ATTN_BWD_SHAPES = [
    (1, 1, 1, 4, "float32", False),
    (2, 50, 2, 64, "float32", True),
    (1, 96, 3, 128, "bfloat16", True),
    (1, 96, 2, 256, "float32", False),
    (2, 300, 2, 256, "bfloat16", True),
    (1, 2048, 2, 64, "float32", True),
    (1, 2048, 2, 128, "bfloat16", False),
    # D not a multiple of the 16-byte vector: the kernels' scalar loads
    (1, 77, 2, 6, "float32", True),
    (1, 130, 3, 20, "bfloat16", False),
    # bf16 with D 64 or 128: the tensor-core pair, srt_flash_attn_bwd_*_sm90
    (1, 1, 1, 64, "bfloat16", True),
    (2, 77, 2, 64, "bfloat16", True),
    (2, 77, 3, 128, "bfloat16", False),
    (3, 129, 2, 64, "bfloat16", False),
    (1, 129, 2, 128, "bfloat16", True),
    (2, 1000, 3, 64, "bfloat16", True),
    (2, 1000, 2, 128, "bfloat16", False),
    (1, 1000, 4, 128, "bfloat16", True),
    (1, 2048, 2, 64, "bfloat16", False),
    (2, 2048, 2, 128, "bfloat16", True),
    # float16: the SIMT pair, held at the bf16 tolerance
    (1, 77, 2, 64, "float16", True),
    (2, 130, 2, 128, "float16", False),
] + [
    # f32 with D 64 or 128: the 3xTF32 pair, srt_flash_attn_bwd_*_tf32x3
    (b, s, h, d, "float32", causal)
    for d in (64, 128) for causal in (False, True)
    for b, s, h in ((1, 1, 1), (2, 77, 2), (3, 129, 2), (2, 1000, 3), (1, 2048, 2))
]
# The tensor-core pair against its own plain version (the same bf16
# roundings of p and ds): the two differ only in the order of the f32
# sums, and a p or ds that lands on the other side of a bf16 rounding
# boundary. That is one bf16 step of the output (2^-7 relative) plus 1e-3.
SM90_BWD_TOL = (2.0 ** -7, 1e-3)
# the backward's (dq, dk/dv) pair on each route of pallas_attention.bwd_entry
BWD_PAIRS = {
    "simt": ("srt_flash_attn_bwd_dq", "srt_flash_attn_bwd_dkv"),
    "sm90": ("srt_flash_attn_bwd_dq_sm90", "srt_flash_attn_bwd_dkv_sm90"),
    "tf32x3": ("srt_flash_attn_bwd_dq_tf32x3", "srt_flash_attn_bwd_dkv_tf32x3"),
}
# bench_transformer_train's widths (benchmarks/run_workloads.py)
TRAIN = {"b": 4, "s": 2048, "heads": 8, "d_model": 512, "d_hidden": 2048,
         "lr": 0.01, "steps_after_first": 9}
TRAIN_LOSS_RTOL = 1e-5
TRAIN_PARAM_TOL = (1e-4, 1e-6)
TRAIN_GRAD_REL = 1e-3
# the workload's f32 step: each C entry point and its device kernel's name
FLASH_KERNELS = {"srt_flash_attn_fwd_tf32x3": "flash_fwd_tf32x3_kernel",
                 "srt_flash_attn_bwd_dq_tf32x3": "flash_bwd_dq_tf32x3_kernel",
                 "srt_flash_attn_bwd_dkv_tf32x3": "flash_bwd_dkv_tf32x3_kernel"}


def _bwd_route(shape):
    """The route pallas_attention.bwd_entry takes for these (aligned)
    inputs: bf16 with D 64 or 128 the tensor-core pair, f32 with D 64 or
    128 the 3xTF32 pair, the rest SIMT."""
    if shape[3] in (64, 128) and shape[4] in ("bfloat16", "float32"):
        return "sm90" if shape[4] == "bfloat16" else "tf32x3"
    return "simt"


def _flash_launches(pa):
    """Launches per C entry point since the last reset: the SIMT kernels'
    counts are the wrappers' totals less the tensor-core kernels'."""
    return {"srt_flash_attn_fwd": (pa.flash_fwd_launches - pa.flash_fwd_sm90_launches
                                   - pa.flash_fwd_tf32x3_launches),
            "srt_flash_attn_fwd_sm90": pa.flash_fwd_sm90_launches,
            "srt_flash_attn_fwd_tf32x3": pa.flash_fwd_tf32x3_launches,
            "srt_flash_attn_bwd_dq": (pa.flash_bwd_dq_launches - pa.flash_bwd_dq_sm90_launches
                                      - pa.flash_bwd_dq_tf32x3_launches),
            "srt_flash_attn_bwd_dkv": (pa.flash_bwd_dkv_launches
                                       - pa.flash_bwd_dkv_sm90_launches
                                       - pa.flash_bwd_dkv_tf32x3_launches),
            "srt_flash_attn_bwd_dq_sm90": pa.flash_bwd_dq_sm90_launches,
            "srt_flash_attn_bwd_dkv_sm90": pa.flash_bwd_dkv_sm90_launches,
            "srt_flash_attn_bwd_dq_tf32x3": pa.flash_bwd_dq_tf32x3_launches,
            "srt_flash_attn_bwd_dkv_tf32x3": pa.flash_bwd_dkv_tf32x3_launches}


def _took(pa, before):
    """The entry points launched since ``before`` (a :func:`_flash_launches`),
    with their counts."""
    return {k: n - before[k] for k, n in _flash_launches(pa).items() if n != before[k]}


def _bwd_errs(torch, got, want, dtype, what, tol=None):
    errs = [_max_err(torch, g, w, dtype, f"{n} {what}", tol)
            for g, w, n in zip(got, want, ("dq", "dk", "dv"))]
    return dict(zip(("dq", "dk", "dv"), errs))


def _bwd_inputs(torch, dev, shape, seed):
    """q, k, v, do and the kernel forward's out and lse."""
    from sparkrdma_tpu_torch.ops import pallas_attention as pa

    q, k, v = _qkv(torch, dev, shape, seed)
    do = _qkv(torch, dev, shape, seed + 1000)[0]
    out, lse = pa.flash_attention_fwd(q, k, v, shape[5], want_lse=True)
    return q, k, v, do, out, lse


def phase_attention_bwd_kernel(torch, dev):
    """The three backward pairs against the plain backward, each case
    asserted to have gone through the pair the route rule names; the
    tensor-core pairs also against their own plain versions (sm90 at
    SM90_BWD_TOL, 3xTF32 at the fp32 tolerance)."""
    from sparkrdma_tpu_torch.ops import pallas_attention as pa

    own_plain = {"sm90": (pa.flash_attention_bwd_sm90_reference, SM90_BWD_TOL),
                 "tf32x3": (pa.flash_attention_bwd_tf32x3_reference, None)}
    cases = []
    for i, shape in enumerate(ATTN_BWD_SHAPES):
        b, s, h, d, dtype, causal = shape
        route = _bwd_route(shape)
        q, k, v, do, out, lse = _bwd_inputs(torch, dev, shape, 200 + i)
        want = pa.flash_attention_bwd_reference(q, k, v, out, lse, do, causal)
        before = _flash_launches(pa)
        got = pa.flash_attention_bwd(q, k, v, out, lse, do, causal)
        torch.cuda.synchronize()
        took = _took(pa, before)
        entry = BWD_PAIRS[route]
        if took != dict.fromkeys(entry, 1):
            raise AssertionError(f"{shape}: launched {took}, expected {entry}")
        case = {"shape": [b, s, h, d], "dtype": dtype, "causal": causal,
                "entry": list(entry),
                "max_abs_err": _bwd_errs(torch, got, want, dtype, str(shape))}
        if route in own_plain:
            fn, tol = own_plain[route]
            case[f"max_abs_err_vs_{route}_plain"] = _bwd_errs(
                torch, got, fn(q, k, v, out, lse, do, causal), dtype,
                f"{shape} vs the {route} plain version", tol)
        cases.append(case)
    # off a 16-byte boundary: a do 4 bytes past it (f32, the scalar loads
    # again), and a bf16 D 128 do 2 bytes past it (the SIMT bf16 pair)
    for shape in ((1, 129, 2, 64, "float32", True), (2, 300, 2, 128, "bfloat16", True)):
        dtype = shape[4]
        q, k, v, do, out, lse = _bwd_inputs(torch, dev, shape, 199)
        dom = torch.empty(do.numel() + 1, dtype=do.dtype, device=dev)[1:].view_as(do)
        dom.copy_(do)
        want = pa.flash_attention_bwd_reference(q, k, v, out, lse, do, True)
        before = _flash_launches(pa)
        got = pa.flash_attention_bwd(q, k, v, out, lse, dom, True)
        took = _took(pa, before)
        if took != dict.fromkeys(BWD_PAIRS["simt"], 1):
            raise AssertionError(f"misaligned do {shape}: launched {took}, not the SIMT pair")
        cases.append({"shape": list(shape[:4]), "dtype": dtype, "causal": True,
                      "misaligned_do": True, "entry": list(BWD_PAIRS["simt"]),
                      "max_abs_err": _bwd_errs(torch, got, want, dtype,
                                               f"misaligned do {shape}")})
    emit(6, name="attention_bwd_kernel", cases=cases,
         launches={k: n for k, n in _flash_launches(pa).items() if "_bwd_" in k})


def _train_data(torch, dev):
    from sparkrdma_tpu_torch.convert import params_from_jax
    from sparkrdma_tpu_torch.models.transformer_step import init_params

    t = TRAIN
    params = params_from_jax(init_params(t["d_model"], t["heads"],
                                         t["d_hidden"], tp=1), dev)
    rng = np.random.default_rng(3)
    x, y = (torch.from_numpy(rng.normal(size=(t["b"], t["s"], t["d_model"]))
                             .astype(np.float32)).to(dev) for _ in range(2))
    return params, x, y


def _close_params(got, want, what):
    """The JAX test's bounds on the new parameters, and the gradients they
    imply within TRAIN_GRAD_REL of their largest value."""
    rtol, atol = TRAIN_PARAM_TOL
    errs = {}
    for k in want:
        err = (got[k] - want[k]).abs()
        if bool((err > atol + rtol * want[k].abs()).any()):
            raise AssertionError(f"{what}: param {k} max abs error {float(err.max())}")
        errs[k] = float(err.max())
    return errs


def _block_grads(torch, params, x, y, attn):
    """Gradients of the step's sum of squares through the block itself:
    the new parameters hide them (``lr * g`` is ~1e-7 of a weight)."""
    from sparkrdma_tpu_torch.models.transformer_step import TransformerBlock

    block = TransformerBlock(params, TRAIN["heads"], attn)
    names, ps = zip(*block.named_parameters())
    return dict(zip(names, torch.autograd.grad(((block(x) - y) ** 2).sum(), ps)))


def _grad_rel_err(got, want, what):
    """Largest gradient error of each parameter over its largest value."""
    errs = {}
    for k in want:
        rel = float((got[k] - want[k]).abs().max() / want[k].abs().max())
        if not rel <= TRAIN_GRAD_REL:
            raise AssertionError(f"{what}: grad {k} off by {rel} of its largest value")
        errs[k] = rel
    return errs


def phase_training_path(torch, dev):
    """The training path at full width: counts from 0 just before each run,
    read just after."""
    from torch.profiler import ProfilerActivity, profile

    from sparkrdma_tpu_torch.models.transformer_step import (
        TransformerStep, reference_step,
    )
    from sparkrdma_tpu_torch.ops import pallas_attention as pa

    t = TRAIN
    params, x, y = _train_data(torch, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    step = TransformerStep(n_heads=t["heads"], lr=t["lr"], attn="ulysses")

    # ---- the main path: step 1, then run_steps of 9 more
    pa.reset_launch_counts()
    t0 = time.perf_counter()
    loss1, new1 = step.step(params, x, y)
    torch.cuda.synchronize()
    step1_s = time.perf_counter() - t0
    after_step1 = _flash_launches(pa)
    t0 = time.perf_counter()
    loss_k, _ = step.run_steps(new1, x, y, t["steps_after_first"])
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = _flash_launches(pa)
    peak = torch.cuda.max_memory_allocated()
    n_steps = 1 + t["steps_after_first"]
    # f32 D 64: the 3xTF32 forward and backward pair, one launch each a step
    per_step = {k: int(k in FLASH_KERNELS) for k in launches}
    if after_step1 != per_step or launches != {k: n * n_steps for k, n in per_step.items()}:
        raise AssertionError(f"launches not 1/1/1 a step: {after_step1}, {launches}")
    l1, lk = float(loss1), float(loss_k)
    if not (np.isfinite(lk) and lk <= l1 * 1.01):
        raise AssertionError(f"training diverged: loss {l1} -> {lk}")

    # ---- step 1 against reference_step and the ring schedule
    ref_loss, ref_new = reference_step(params, x, y, t["heads"], t["lr"])
    ring_loss, ring_new = TransformerStep(
        n_heads=t["heads"], lr=t["lr"], attn="ring").step(params, x, y)
    checks = {}
    for name, (lw, pw) in (("reference_step", (ref_loss, ref_new)),
                           ("ring", (ring_loss, ring_new))):
        rel = abs(l1 - float(lw)) / abs(float(lw))
        if not rel <= TRAIN_LOSS_RTOL:
            raise AssertionError(f"step 1 vs {name}: loss {l1} vs {float(lw)}")
        checks[name] = {
            "loss": float(lw), "loss_rel_err": rel,
            "param_max_abs_err": _close_params(new1, pw, f"step 1 vs {name}"),
        }
    checks["grad_rel_err_ulysses_vs_ring"] = _grad_rel_err(
        _block_grads(torch, params, x, y, "ulysses"),
        _block_grads(torch, params, x, y, "ring"), "step 1 gradients")
    for v in new1.values():
        if not bool(torch.isfinite(v).all()):
            raise AssertionError("step 1: non-finite parameters")

    # ---- one profiled warm step: the kernels' share of it
    step.step(params, x, y)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step.step(params, x, y)
        torch.cuda.synchronize()
        prof_wall_s = time.perf_counter() - t0
    cuda = torch.autograd.DeviceType.CUDA
    dev_ops = [e for e in prof.key_averages()
               if getattr(e, "device_type", None) == cuda]
    busy_ms = sum(e.self_device_time_total for e in dev_ops) / 1e3
    kernel_ms = {name: sum(e.self_device_time_total for e in dev_ops
                           if kernel in e.key) / 1e3
                 for name, kernel in FLASH_KERNELS.items()}
    top = sorted(dev_ops, key=lambda e: -e.self_device_time_total)[:8]

    train = {
        "shape": {k: v for k, v in t.items() if k != "steps_after_first"},
        "dtype": "float32", "attn": "ulysses", "causal": False,
        "step1_s": step1_s, "steps_after_first_s": run_s,
        "step_s_warm": run_s / t["steps_after_first"],
        "loss_first": l1, "loss_last": lk, "steps": n_steps,
        "launches": launches,
        "launches_per_step": {k: v / n_steps for k, v in launches.items()},
        "step1_checks": checks,
        "profiled_step_s": prof_wall_s, "device_busy_ms": busy_ms,
        "idle_share": 1 - busy_ms / (prof_wall_s * 1e3) if busy_ms > 0 else None,
        "kernel_device_ms": kernel_ms,
        "kernels_share_of_profiled_step": (
            sum(kernel_ms.values()) / (prof_wall_s * 1e3) if busy_ms > 0 else None),
        "kernels_share_of_warm_step": (
            sum(kernel_ms.values()) / (run_s / t["steps_after_first"] * 1e3)
            if busy_ms > 0 else None),
        "top_device_ops_ms": [[e.key[:60], e.self_device_time_total / 1e3, e.count]
                              for e in top],
        "peak_device_bytes": peak, "peak_above_baseline_bytes": peak - base,
    }
    del new1, ref_new, ring_new

    # ---- bench.py's flash training step
    shape = ATTN_PATH_SHAPES["bench_bf16_causal"]
    q, k, v = (x_.requires_grad_(True) for x_ in _qkv(torch, dev, shape, 31))
    torch.cuda.synchronize()
    pa.reset_launch_counts()
    t0 = time.perf_counter()
    pa.flash_attention(q, k, v, causal=True).float().sum().backward()
    torch.cuda.synchronize()
    flash_s = time.perf_counter() - t0
    flash_launches = _flash_launches(pa)
    # bf16 D 128: the tensor-core kernels only, one launch each
    want_launches = {k: int(k.endswith("_sm90")) for k in flash_launches}
    if flash_launches != want_launches:
        raise AssertionError(f"flash training step launches {flash_launches}")
    with torch.no_grad():
        out, lse = pa.flash_attention_fwd(q, k, v, True, want_lse=True)
        ones = torch.ones_like(out)
        want = pa.flash_attention_bwd_reference(q, k, v, out, lse, ones, True)
        own = pa.flash_attention_bwd_sm90_reference(q, k, v, out, lse, ones, True)
    grads = (q.grad, k.grad, v.grad)

    def flash_step():
        for x_ in (q, k, v):
            x_.grad = None
        pa.flash_attention(q, k, v, causal=True).float().sum().backward()

    warm_s = []  # after the checks, so the launch counts above hold the main path alone
    for _ in range(5):
        t0 = time.perf_counter()
        flash_step()
        torch.cuda.synchronize()
        warm_s.append(time.perf_counter() - t0)
    flash = {"shape": list(shape[:4]), "dtype": "bfloat16", "causal": True,
             "step_s": flash_s, "step_s_warm": warm_s,
             "profiled_step": _profiled(torch, flash_step), "launches": flash_launches,
             "max_abs_err_vs_plain": _bwd_errs(torch, grads, want, "bfloat16",
                                               "flash training step"),
             "max_abs_err_vs_sm90_plain": _bwd_errs(
                 torch, grads, own, "bfloat16",
                 "flash training step vs the sm90 plain version", SM90_BWD_TOL)}
    emit(7, name="training_path", transformer_step=train, flash_train_step=flash)
    # per kernel: the workload's f32 steps ran the 3xTF32 forward and
    # backward, the flash step the bf16 tensor-core kernels
    return ({k: launches[k] + flash_launches[k] for k in launches},
            train["step_s_warm"])


def _sdpa_backend(torch, fn):
    """``(name, context)`` of the first SDPA backend, in the order SDPA
    itself prefers, that runs ``fn``; ``(None, nullcontext)`` when the
    backends cannot be forced."""
    try:
        from torch.nn.attention import SDPBackend, sdpa_kernel
    except ImportError:
        return None, contextlib.nullcontext
    for name in ("FLASH_ATTENTION", "CUDNN_ATTENTION", "EFFICIENT_ATTENTION", "MATH"):
        backend = getattr(SDPBackend, name, None)
        if backend is None:
            continue
        try:
            with sdpa_kernel(backend):
                fn()
                torch.cuda.synchronize()
        except RuntimeError:  # this backend does not take these inputs
            continue
        return name, lambda: sdpa_kernel(backend)
    return None, contextlib.nullcontext


def time_flash_attention_bwd(torch, dev):
    """The backward kernels at the training path's two shapes: each C
    entry point alone on prebuilt inputs (the SIMT pair at both shapes,
    the tensor-core pair of the route rule at each), each sweep of its
    plain version (``pa._bwd_reference(..., sweeps=...)``, with the bf16
    roundings for the sm90 pair and the 3xTF32 products for the tf32x3
    pair), and ``scaled_dot_product_attention``'s backward (forward +
    ``autograd.grad``, less the forward) on [B, H, S, D] copies, a
    yardstick the port never calls, for dq and dk/dv together. A 3xTF32
    kernel's bound is 3 x its flops at the TF32 peak (``bound_f32_ms``
    its flops at the f32 peak, as the SIMT rows)."""
    from sparkrdma_tpu_torch.ops import _build
    from sparkrdma_tpu_torch.ops import pallas_attention as pa

    F = torch.nn.functional
    lib = _build.load()
    stream = torch.cuda.current_stream().cuda_stream
    rec = {k: {} for pair in BWD_PAIRS.values() for k in pair}
    own = {"sm90": (pa.flash_attention_bwd_sm90_reference, SM90_BWD_TOL),
           "tf32x3": (pa.flash_attention_bwd_tf32x3_reference, None)}
    plains = {"simt": "f32", "sm90": "sm90 roundings", "tf32x3": "3xTF32 products"}
    for name, shape in ATTN_PATH_SHAPES.items():
        b, s, h, d, dtype, causal = shape
        q, k, v, do, out, lse = _bwd_inputs(torch, dev, shape, 41)
        delta = torch.einsum("bshd,bshd->bhs", do.float(), out.float()).contiguous()
        code = {"float32": 0, "bfloat16": 1}[dtype]
        ins = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
               lse.data_ptr(), delta.data_ptr())
        tail = (b, s, h, d, code, int(causal), stream)
        routes = ["simt"] + ([_bwd_route(shape)] if _bwd_route(shape) != "simt" else [])
        want = pa.flash_attention_bwd_reference(q, k, v, out, lse, do, causal)
        runs = {}
        for route in routes:
            dq_name, dkv_name = BWD_PAIRS[route]
            dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))

            def raw_dq(dq_name=dq_name, dq=dq):
                if getattr(lib, dq_name)(*ins, dq.data_ptr(), *tail):
                    raise RuntimeError(f"{dq_name} launch failed")

            def raw_dkv(dkv_name=dkv_name, dk=dk, dv=dv):
                if getattr(lib, dkv_name)(*ins, dk.data_ptr(), dv.data_ptr(), *tail):
                    raise RuntimeError(f"{dkv_name} launch failed")

            raw_dq()
            raw_dkv()
            torch.cuda.synchronize()
            errs = _bwd_errs(torch, (dq, dk, dv), want, dtype, f"timing {name} {dq_name}")
            if route in own:
                fn, tol = own[route]
                _bwd_errs(torch, (dq, dk, dv), fn(q, k, v, out, lse, do, causal), dtype,
                          f"timing {name} {dq_name} vs the {route} plain version", tol)
            runs[dq_name] = (route, raw_dq, "dq", 1, 3, errs["dq"])
            runs[dkv_name] = (route, raw_dkv, "dkv", 2, 4, max(errs["dk"], errs["dv"]))
        del want

        # the yardstick: SDPA forward + backward, less its forward
        qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_(True)
                      for x in (q, k, v))
        dot = do.transpose(1, 2).contiguous()

        def sdpa_fwd():
            with torch.no_grad():
                return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)

        def sdpa_fwd_bwd():
            o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
            return torch.autograd.grad(o, (qt, kt, vt), dot)

        backend, forced = _sdpa_backend(torch, sdpa_fwd_bwd)
        with forced():
            lib_total_ms = event_ms_per_call(torch, sdpa_fwd_bwd, 10)
            lib_fwd_ms = event_ms_per_call(torch, sdpa_fwd, 10)
        library_ms = lib_total_ms - lib_fwd_ms

        item = q.element_size()
        elems = b * s * h * d
        rows = b * h * s
        n_pairs = s * (s + 1) // 2 if causal else s * s
        for kname, (route, run, sweep, n_out, fma_per_d, err) in runs.items():
            kernel_ms = event_ms_per_call(torch, run, 20)

            def plain(sweep=sweep, route=route):
                return pa._bwd_reference(q, k, v, out, lse, do, causal, 512, 512,
                                         sweeps=(sweep,), round_bf16=route == "sm90",
                                         split_tf32=route == "tf32x3")

            plain_ms = event_ms_per_call(torch, plain, 5)
            # q, k, v, do read once, lse and delta read once, outputs written once
            moved = (4 + n_out) * elems * item + 2 * rows * 4
            flops = 2 * fma_per_d * b * h * d * n_pairs
            # the operations this kernel does on the card: 3 TF32 products
            # a product for tf32x3, one f32 or bf16 product otherwise
            ops, peak = {"tf32x3": (3 * flops, TF32_TENSOR_FLOPS),
                         "sm90": (flops, BF16_TENSOR_FLOPS)}.get(route, (flops, F32_FLOPS))
            bytes_ms = moved / HBM_BYTES_PER_S * 1e3
            ops_ms = ops / peak * 1e3
            bound_ms = max(bytes_ms, ops_ms)
            rec[kname][name] = {
                "shape": [b, s, h, d], "dtype": dtype, "causal": causal,
                "max_abs_err": err, "ms": kernel_ms, "plain_ms": plain_ms,
                "plain": plains[route],
                "library_ms": library_ms, "library_scope": "dq+dkv",
                "library_backend": backend,
                "library_fwd_ms": lib_fwd_ms, "library_fwd_bwd_ms": lib_total_ms,
                "bound_ms": bound_ms, "bound_share": bound_ms / kernel_ms,
                "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
                "bound_f32_ms": max(bytes_ms, flops / F32_FLOPS * 1e3),
                "bytes": moved, "flops": flops, "device_ops": ops, "peak_flops": peak,
                "tflops": flops / kernel_ms / 1e9,
            }
        del qt, kt, vt, dot
    entries = []
    # each kernel's headline is the shape its main path gives it: the
    # workload's f32 to the 3xTF32 pair (the SIMT pair keeps the other
    # inputs), the bench shape to the bf16 tensor-core pair
    for kname, source, replaces, headline in (
            ("srt_flash_attn_bwd_dq", "flash_attn_bwd.cu", 364, "workload_f32"),
            ("srt_flash_attn_bwd_dkv", "flash_attn_bwd.cu", 394, "workload_f32"),
            ("srt_flash_attn_bwd_dq_sm90", "flash_attn_bwd_sm90.cu", 364, "bench_bf16_causal"),
            ("srt_flash_attn_bwd_dkv_sm90", "flash_attn_bwd_sm90.cu", 394,
             "bench_bf16_causal"),
            ("srt_flash_attn_bwd_dq_tf32x3", "flash_attn_bwd_tf32x3.cu", 364, "workload_f32"),
            ("srt_flash_attn_bwd_dkv_tf32x3", "flash_attn_bwd_tf32x3.cu", 394,
             "workload_f32")):
        head = rec[kname][headline]
        entries.append({
            "name": kname, "route": "cuda",
            "source": f"sparkrdma_tpu_torch/ops/csrc/{source}",
            "replaces": f"sparkrdma_tpu/ops/pallas_attention.py:{replaces}",
            **{k: head[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                    "bound_by", "library_ms", "tflops", "bound_f32_ms")},
            "timer": "cuda_events", "shape_name": headline, "shapes": rec[kname],
        })
    emit("timing_attention_bwd", kernels=entries)
    return entries


def phase_second_device(torch):
    """bf16 B1 S256 H2 D128, causal (launches above 48 KiB of shared
    memory) through every flash entry point on cuda:1 after cuda:0, in
    one process: each kernel's shared-memory limit is raised per device.
    Needs two devices; with one it says so."""
    from sparkrdma_tpu_torch.ops import pallas_attention as pa

    n = torch.cuda.device_count()
    if n < 2:
        emit("second_device", skipped=True,
             reason=f"{n} CUDA device: the per-device kernel configuration "
                    "needs two to be shown")
        return
    shape = (1, 256, 2, 128, "bfloat16", True)
    results = {}
    for i in (0, 1):
        dev = torch.device("cuda", i)
        with torch.cuda.device(dev):
            q, k, v = _qkv(torch, dev, shape, 51)
            do = _qkv(torch, dev, shape, 52)[0]
            pa.reset_launch_counts()
            got = {}
            for precision in ("default", "highest"):  # tensor-core, then SIMT
                out, lse = pa.flash_attention_fwd(q, k, v, True, want_lse=True,
                                                  precision=precision)
                out0 = pa.flash_attention_fwd(q, k, v, True, precision=precision)[0]
                grads = pa.flash_attention_bwd(q, k, v, out, lse, do, True,
                                               precision=precision)
                torch.cuda.synchronize()
                want = pa.flash_attention_reference(q, k, v, True)[0]
                _max_err(torch, out, want, "bfloat16", f"cuda:{i} {precision} fwd")
                _max_err(torch, out0, want, "bfloat16", f"cuda:{i} {precision} fwd")
                _bwd_errs(torch, grads, pa.flash_attention_bwd_reference(
                    q, k, v, out, lse, do, True), "bfloat16", f"cuda:{i} {precision}")
                got[precision] = [x.cpu() for x in (out, out0, *grads)]
            launches = _flash_launches(pa)
            # bf16: no 3xTF32 launch; each forward twice, each backward once
            if any(count != (0 if entry.endswith("_tf32x3")
                             else 2 if entry.startswith("srt_flash_attn_fwd") else 1)
                   for entry, count in launches.items()):
                raise AssertionError(f"cuda:{i}: launches {launches}")
            results[i] = got
    equal = all(torch.equal(a, b) for p in results[0]
                for a, b in zip(results[0][p], results[1][p]))
    emit("second_device", skipped=False, devices=[torch.cuda.get_device_name(i)
                                                  for i in (0, 1)],
         bitwise_equal_across_devices=equal)


# ----------------------------------------------------------------------
# the SPMD shuffle step: the neighbor-pull kernel, the exchange program's
# two schedules and TeraSorter over a mesh of shards on one card
# ----------------------------------------------------------------------
MESH = 8
STUDY_BLOCK = 16 << 20  # benchmarks/exchange_study.py's payload, 16 MiB buckets
SPMD_SMALL_KEYS = 1 << 24
_SIGN = -(1 << 31)  # uint32 order as int32 order: XOR the sign bit


def _np_cases(torch):
    """(n, shard shape, dtype, source byte offset, destination byte offset)."""
    u8 = torch.uint8
    cases = [(n, (sb,), u8, 0, 0) for n in (1, 2, 3, 8)
             for sb in (1, 15, 4097, (64 << 10) + 3)]
    return cases + [
        (3, (1025,), torch.int32, 0, 0),
        (8, (33, 7), torch.float32, 0, 0),
        (2, (4097,), torch.bfloat16, 0, 0),     # 8194 B: not a multiple of 16
        (3, (3,), torch.int32, 0, 0),           # the [E, E] counts at odd E
        (8, (4097,), u8, 1, 0),                 # source 1 byte past alignment
        (5, (1000,), u8, 0, 3),                 # destination 3 bytes past
        (2, (1 << 20,), torch.int32, 4, 4),     # both 4 bytes past: the head loop
        (8, (32 << 20,), torch.float32, 0, 0),  # 128 MiB a shard
    ]


def _offset_stack(torch, dev, n, shape, dtype, offset, fill=None):
    """A contiguous [n, *shape] stack starting ``offset`` bytes into a
    fresh byte buffer, random bytes unless ``fill`` is given."""
    item = torch.empty((), dtype=dtype).element_size()
    nbytes = n * int(np.prod(shape)) * item
    buf = torch.empty(nbytes + offset, dtype=torch.uint8, device=dev)
    if fill is None:
        g = torch.Generator(device=dev).manual_seed(nbytes + offset)
        buf.random_(0, 256, generator=g)
    else:
        buf.fill_(fill)
    return buf[offset:].view(dtype).view(n, *shape)


def phase_neighbor_pull_kernel(torch, dev):
    """srt_neighbor_pull against its plain version, byte for byte, and
    both schedules on an odd mesh."""
    from sparkrdma_tpu_torch.ops import remote_copy as rc
    from sparkrdma_tpu_torch.ops.exchange import ExchangeProgram
    from sparkrdma_tpu_torch.parallel import make_mesh

    n0 = rc.neighbor_pull_launches
    cases = []
    for n, shape, dtype, soff, doff in _np_cases(torch):
        src = _offset_stack(torch, dev, n, shape, dtype, soff)
        out = _offset_stack(torch, dev, n, shape, dtype, doff, fill=0xA5)
        got = rc.neighbor_pull(src, out=out)
        want = rc.neighbor_pull_reference(src)
        torch.cuda.synchronize()
        if got.data_ptr() != out.data_ptr() or not torch.equal(
                got.reshape(n, -1).view(torch.uint8),
                want.reshape(n, -1).view(torch.uint8)):
            raise AssertionError(
                f"srt_neighbor_pull differs from its plain version: n {n}, "
                f"shard {shape} {dtype}, offsets {soff}/{doff}")
        cases.append({"n": n, "shard": list(shape), "dtype": str(dtype),
                      "shard_bytes": src[0].numel() * src.element_size(),
                      "src_offset": soff, "dst_offset": doff})
        del src, out, got, want
    # both schedules on a 3-shard mesh: the counts' 12-byte shards
    e = 3
    prog = ExchangeProgram(make_mesh([dev] * e))
    g = torch.Generator(device=dev).manual_seed(3)
    send = torch.randint(0, 1 << 30, (e * e, 77), dtype=torch.int32,
                         device=dev, generator=g)
    counts = torch.randint(0, 78, (e * e,), dtype=torch.int32, device=dev,
                           generator=g)
    a2a = prog.exchange(send, counts)
    ring = prog.ring_exchange(send, counts)
    want = send.view(e, e, 77).transpose(0, 1).reshape(e * e, 77)
    if not (torch.equal(a2a[0], want) and torch.equal(ring[0], want)
            and torch.equal(a2a[1], ring[1])):
        raise AssertionError("the 3-shard exchange schedules disagree")
    emit(8, name="neighbor_pull_kernel", cases=cases, equal=True,
         odd_mesh_schedules_equal=True,
         launches={"srt_neighbor_pull": rc.neighbor_pull_launches - n0})


def _study_payload_len(src, dst, block):
    """benchmarks/exchange_study.py ``_payload``'s length and byte."""
    n = max(1, (block // 2) + ((37 * src + 11 * dst) % (block // 2)))
    return n, (src * 16 + dst) % 251


def _study_send(torch, dev, e, block):
    """The exchange study's send ([e*e, block] uint8, row src*e+dst holds
    its (src, dst) payload), its counts, and the blocks each shard must
    receive, all built on the card."""
    send = torch.zeros((e * e, block), dtype=torch.uint8, device=dev)
    want = torch.zeros_like(send)
    counts = np.zeros(e * e, np.int32)
    want_counts = np.zeros(e * e, np.int32)
    for src in range(e):
        for dst in range(e):
            n, v = _study_payload_len(src, dst, block)
            send[src * e + dst, :n] = v
            want[dst * e + src, :n] = v
            counts[src * e + dst] = n
            want_counts[dst * e + src] = n
    return (send, torch.from_numpy(counts).to(dev), want,
            torch.from_numpy(want_counts).to(dev))


def _checksums(torch, keys):
    """(count, sum mod 2^32, xor) of uint32 keys on the card."""
    bits = keys.view(torch.int32)
    total = int((bits.to(torch.int64) & 0xFFFFFFFF).sum()) & 0xFFFFFFFF
    x = bits
    while x.numel() > 1:
        if x.numel() % 2:
            x = torch.cat([x, x.new_zeros(1)])
        x = x[: x.numel() // 2] ^ x[x.numel() // 2:]
    return keys.numel(), total, (int(x[0]) & 0xFFFFFFFF) if x.numel() else 0


def _card_sort(torch, keys):
    """One torch.sort of uint32 keys on the card (through the
    order-preserving int32 view)."""
    return (torch.sort(keys.view(torch.int32) ^ _SIGN).values ^ _SIGN).view(
        torch.uint32)


def _check_sorted(torch, dev, out, keys_dev, what):
    got = torch.from_numpy(out).to(dev)
    if got.numel() != keys_dev.numel() or not torch.equal(
            got.view(torch.int32), _card_sort(torch, keys_dev).view(torch.int32)):
        raise AssertionError(f"{what}: differs from torch.sort of its keys")
    if _checksums(torch, got) != _checksums(torch, keys_dev):
        raise AssertionError(f"{what}: count, sum or xor differ from the input's")


def _profiled(torch, fn):
    """One profiled call of ``fn``: its wall (ending in a sync), the
    device busy time and the top device ops by self time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    busy_ms = device_busy_us(torch, prof) / 1e3
    cuda = torch.autograd.DeviceType.CUDA
    top = sorted((e for e in prof.key_averages()
                  if getattr(e, "device_type", None) == cuda),
                 key=lambda e: -e.self_device_time_total)[:6]
    return {"profiled_wall_s": wall, "device_busy_ms": busy_ms,
            "idle_share": 1 - busy_ms / (wall * 1e3) if busy_ms > 0 else None,
            "top_device_ops_ms": [[e.key[:60], e.self_device_time_total / 1e3,
                                   e.count] for e in top]}


def phase_spmd_path(torch, dev):
    """The SPMD shuffle step on ``make_mesh([dev] * 8)``: counts from 0
    just before, read just after."""
    from sparkrdma_tpu_torch.models.terasort import TeraSorter
    from sparkrdma_tpu_torch.ops import remote_copy as rc
    from sparkrdma_tpu_torch.ops.exchange import (
        ExchangeProgram, pack_blocks, unpack_blocks,
    )
    from sparkrdma_tpu_torch.parallel import make_mesh

    e = MESH
    mesh = make_mesh([dev] * e)
    rc.reset_launch_counts()
    report = {}

    # ---- (a) the dryrun's exchange: 64-byte buckets of 1+src+dst bytes
    prog = ExchangeProgram(mesh)
    blocks = [bytes([(src * 16 + dst) % 256]) * (1 + src + dst)
              for src in range(e) for dst in range(e)]
    send, counts = pack_blocks(blocks, 64)
    for fn in (prog.exchange, prog.ring_exchange):
        recv, rcounts = fn(torch.from_numpy(send).to(dev),
                           torch.from_numpy(counts).to(dev))
        r = recv.cpu().numpy().reshape(e, e, 64)
        c = rcounts.cpu().numpy().reshape(e, e)
        for dst in range(e):
            if unpack_blocks(r[dst], c[dst]) != [
                    bytes([(src * 16 + dst) % 256]) * (1 + src + dst)
                    for src in range(e)]:
                raise AssertionError(f"dryrun exchange misdelivered for shard {dst}")
    report["dryrun_exchange"] = {"equal": True, "block": 64}

    # ---- (b) the exchange study's 1 GiB send through both schedules
    send, counts, want, want_counts = _study_send(torch, dev, e, STUDY_BLOCK)
    torch.cuda.synchronize()
    prog = ExchangeProgram(mesh)
    walls, outs, ring_launches = {}, {}, None
    for label, fn in (("a2a", prog.exchange), ("ring", prog.ring_exchange)):
        walls[label] = []
        for i in range(3):
            n0 = rc.neighbor_pull_launches
            t = time.perf_counter()
            recv, rcounts = fn(send, counts)
            torch.cuda.synchronize()
            walls[label].append(time.perf_counter() - t)
            if label == "ring" and i == 0:
                ring_launches = rc.neighbor_pull_launches - n0
            if i == 0:
                if not (torch.equal(recv, want) and torch.equal(rcounts, want_counts)):
                    raise AssertionError(f"{label}: received blocks differ from the sent")
                outs[label] = (recv, rcounts)
            del recv, rcounts
    if not (torch.equal(outs["a2a"][0], outs["ring"][0])
            and torch.equal(outs["a2a"][1], outs["ring"][1])):
        raise AssertionError("a2a and ring disagree")
    stats = {k: {f: v for f, v in s.items() if f != "time_s"}
             for k, s in prog.stats.items()}
    if stats["a2a"] != stats["ring"]:
        raise AssertionError(f"schedule stats differ: {stats}")
    if ring_launches != 2 * (e - 1):
        raise AssertionError(f"one ring call launched srt_neighbor_pull "
                             f"{ring_launches} times, not {2 * (e - 1)}")
    gib = send.numel()
    report["exchange_study"] = {
        "block": STUDY_BLOCK, "send_bytes": gib, "equal": True,
        "wall_s": walls, "stats": prog.stats,
        "profiled": {label: _profiled(torch, lambda fn=fn: fn(send, counts))
                     for label, fn in (("a2a", prog.exchange),
                                       ("ring", prog.ring_exchange))},
        "ring_neighbor_pull_launches_per_call": ring_launches,
        "a2a_gbps_warm": gib / min(walls["a2a"][1:]) / 1e9,
        "ring_gbps_warm": gib / min(walls["ring"][1:]) / 1e9,
    }
    del send, counts, want, want_counts, outs

    # ---- (c) TeraSorter on phase 2's 2^28 keys
    rng = np.random.default_rng(12)
    keys = np.concatenate([rng.integers(0, 1 << 32, KEYS // EXECUTORS,
                                        dtype=np.uint32)
                           for _ in range(EXECUTORS)])
    keys_dev = torch.from_numpy(keys).to(dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    sorter = TeraSorter(mesh)
    t = time.perf_counter()
    out = sorter.sort(keys)
    sort_s = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated()
    _check_sorted(torch, dev, out, keys_dev, "TeraSorter(8).sort, 2^28 keys")
    del out
    fn = sorter.step(KEYS // e, sorter.last_capacities[-1])
    step_s = []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        merged, totals, overflowed = fn(keys_dev)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
        del merged, totals, overflowed
    report["terasort"] = {
        "profiled_step": _profiled(torch, lambda: fn(keys_dev)),
        "keys": KEYS, "shards": e, "capacity": sorter.last_capacities,
        "sort_s": sort_s, "step_s": step_s, "step_s_warm": min(step_s[1:]),
        "step_gbps_warm": KEYS * 4 / min(step_s[1:]) / 1e9,
        "peak_device_bytes": peak, "peak_above_baseline_bytes": peak - base,
        "equal_to_torch_sort": True, "checksums_equal": True,
    }
    del keys, keys_dev

    # ---- (d) 2^24 keys: the skewed overflow retry, adaptive, a 2-D mesh
    zeros = np.zeros(SPMD_SMALL_KEYS, np.uint32)
    zeros_dev = torch.from_numpy(zeros).to(dev)
    skew = {}
    for adaptive in (False, True):
        sk = TeraSorter(mesh, capacity_factor=1.25)
        t = time.perf_counter()
        out = sk.sort(zeros, adaptive=adaptive)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        _check_sorted(torch, dev, out, zeros_dev, f"all-zero keys, adaptive={adaptive}")
        skew["adaptive" if adaptive else "static"] = {
            "capacities": sk.last_capacities, "attempts": len(sk.last_capacities),
            "sort_s": wall}
    if skew["static"]["attempts"] != 4 or skew["adaptive"]["attempts"] != 1:
        raise AssertionError(f"overflow retries: {skew}")
    uniform = np.random.default_rng(13).integers(0, 1 << 32, SPMD_SMALL_KEYS,
                                                 dtype=np.uint32)
    mesh2 = make_mesh([dev] * e, num_slices=2)
    t = time.perf_counter()
    out = TeraSorter(mesh2).sort(uniform)
    wall2 = time.perf_counter() - t
    _check_sorted(torch, dev, out, torch.from_numpy(uniform).to(dev),
                  "TeraSorter on the (dcn 2, exec 4) mesh")
    report["small"] = {"keys": SPMD_SMALL_KEYS, "all_zero": skew,
                       "mesh_2d": {"shape": mesh2.shape, "sort_s": wall2,
                                   "equal": True}}
    launches = rc.neighbor_pull_launches
    if launches <= 0:
        raise AssertionError("srt_neighbor_pull never launched on the SPMD path")
    emit(9, name="spmd_path", launches={"srt_neighbor_pull": launches}, **report)
    return launches


def time_neighbor_pull(torch, dev):
    """srt_neighbor_pull at the full-width ring hop (the exchange study's
    [8, 8 x 16 MiB] slab stack): the C entry point alone on a prebuilt
    table, the wrapper, the plain version (``torch.roll`` into a fresh
    tensor), ``torch.roll`` itself as the library yardstick, and a
    same-bytes ``copy_``."""
    from sparkrdma_tpu_torch.ops import _build
    from sparkrdma_tpu_torch.ops import remote_copy as rc

    e, shard = MESH, MESH * STUDY_BLOCK
    x = _offset_stack(torch, dev, e, (shard,), torch.uint8, 0)
    out = torch.empty_like(x)
    rows = np.arange(e, dtype=np.uint64) * np.uint64(shard)
    table = torch.from_numpy(np.stack(
        [np.uint64(x.data_ptr()) + rows, np.uint64(out.data_ptr()) + rows],
        axis=1).view(np.int64)).to(dev)
    lib = _build.load()
    stream = torch.cuda.current_stream().cuda_stream

    def raw():
        code = lib.srt_neighbor_pull(table.data_ptr(), e, shard, stream)
        if code:
            raise RuntimeError(f"srt_neighbor_pull launch failed ({code})")

    def wrapper():
        return rc.neighbor_pull(x, out=out)

    def plain():
        return rc.neighbor_pull_reference(x)

    def library():
        return torch.roll(x, -1, 0)

    raw()
    torch.cuda.synchronize()
    if not torch.equal(out, plain()):
        raise AssertionError("srt_neighbor_pull differs from its plain version")
    moved = 2 * x.numel()  # every shard read once, written once
    a = torch.empty(moved // 2, dtype=torch.uint8, device=dev)
    b = torch.empty_like(a)

    def copy():
        b.copy_(a)

    kernel_ms = event_ms_per_call(torch, raw, 20)
    copy_ms = event_ms_per_call(torch, copy, 20)
    entry = {
        "name": "srt_neighbor_pull", "route": "cuda",
        "source": "sparkrdma_tpu_torch/ops/csrc/neighbor_pull.cu",
        "replaces": "sparkrdma_tpu/ops/remote_copy.py:115",
        "max_abs_err": 0,
        "ms": kernel_ms,
        "plain_ms": event_ms_per_call(torch, plain, 20),
        "bound_ms": moved / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "library_ms": event_ms_per_call(torch, library, 20),
        "wrapper_event_ms": event_ms_per_call(torch, wrapper, 20),
        "kernel_profiler_ms": device_ms_per_call(torch, raw, 10),
        "copy_ms": copy_ms, "copy_gbps": moved / (copy_ms / 1e3) / 1e9,
        "kernel_gbps": moved / (kernel_ms / 1e3) / 1e9,
        "timer": "cuda_events",
        "shape": {"n": e, "shard_bytes": shard, "read_bytes": moved // 2,
                  "written_bytes": moved // 2},
    }
    emit("timing_neighbor_pull", kernels=[entry])
    return entry


# ----------------------------------------------------------------------
# the host plane: TpuShuffleManager (the driver hub over the python
# transport) and DeviceShuffleIO publish and fetch
# ----------------------------------------------------------------------
HOST_EXECUTORS = 4  # dryrun sections 4 and 5 (__graft_entry__.py)
# phase 10 (b)'s base knobs: none, the defaults (a rehearsal at a small
# KEYS shrinks collective.waveBytes so the default run still pipelines)
HOST_PLANE_KNOBS = {}


def host_plane_sections(devices, knobs=None, prefix="dry"):
    """Dryrun sections 4 and 5 (``__graft_entry__.dryrun_multichip``) on
    the port, with their conditions and assertions: a driver and one
    executor per device, each with ``DeviceShuffleIO(ex, device=...)``.
    Shuffle 7: every executor publishes the ``pattern`` blocks and
    reduces its own partition, byte-equal, staged on its device.
    Shuffle 8: the ``big`` blocks (above ``deviceFetch.minBlockBytes``);
    executor 0 reduces the stage through the compiled waves, fused,
    per block (``collective.enabled`` off), and at pipeline depth 1 and
    2 with 128 KiB waves. Returns what it saw: the bytes and the counter
    deltas the JAX run is held to."""
    from sparkrdma_tpu_torch.obs import get_registry
    from sparkrdma_tpu_torch.shuffle.device_io import DeviceShuffleIO
    from sparkrdma_tpu_torch.shuffle.handle import BaseShuffleHandle, HashPartitioner
    from sparkrdma_tpu_torch.shuffle.manager import TpuShuffleManager
    from sparkrdma_tpu_torch.utils.config import TpuShuffleConf

    n_exec = len(devices)
    conf = TpuShuffleConf(knobs)
    driver = TpuShuffleManager(conf, is_driver=True)
    execs = [TpuShuffleManager(conf, is_driver=False, executor_id=f"{prefix}-{i}")
             for i in range(n_exec)]
    ios = [DeviceShuffleIO(ex, device=devices[i]) for i, ex in enumerate(execs)]
    seen = {}
    try:
        driver.register_shuffle(BaseShuffleHandle(
            shuffle_id=7, num_maps=n_exec, partitioner=HashPartitioner(n_exec)))

        def pattern(m, p):
            return bytes([(m * 16 + p) % 256]) * (512 + 64 * m + p)

        for m, io in enumerate(ios):
            io.publish_device_blocks(7, {p: np.frombuffer(pattern(m, p), np.uint8)
                                         for p in range(n_exec)})
        seen["section4"] = {}
        for p, io in enumerate(ios):  # executor p reduces partition p
            got = io.fetch_device_blocks(7, p, p + 1, timeout_s=60)
            blobs = sorted(b.read(0, b.length) for b in got[p])
            if blobs != sorted(pattern(m, p) for m in range(n_exec)):
                raise AssertionError(f"shuffle plane bytes differ for partition {p}")
            if not all(b.array.device == devices[p] for b in got[p]):
                raise AssertionError("staged block landed on the wrong device")
            seen["section4"][p] = blobs
            for b in got[p]:
                b.free()

        driver.register_shuffle(BaseShuffleHandle(
            shuffle_id=8, num_maps=n_exec, partitioner=HashPartitioner(n_exec)))

        def big(m, p):
            return bytes([(m * 8 + p + 1) % 256]) * (32768 + 128 * m + p)

        for m, io in enumerate(ios):
            io.publish_device_blocks(8, {p: np.frombuffer(big(m, p), np.uint8)
                                         for p in range(n_exec)})
        io0 = ios[0]
        want = {p: sorted(big(m, p) for m in range(n_exec)) for p in range(n_exec)}

        def reduce_stage(fused=False):
            got = io0.fetch_device_blocks(8, 0, n_exec, timeout_s=60, fused=fused)
            try:
                return {p: sorted(b.read(0, b.length) for b in got[p])
                        for p in range(n_exec)}
            finally:
                for bufs in got.values():
                    for b in bufs:
                        b.free()

        reg = get_registry()
        role = f"{prefix}-0"
        c_plans = reg.counter("collective.plans", role=role)
        c_blocks = reg.counter("collective.blocks", role=role)
        c_fused = reg.counter("collective.fused_merges", role=role)
        p0, b0, f0 = c_plans.value, c_blocks.value, c_fused.value
        via_collective = reduce_stage()
        if c_plans.value <= p0:
            raise AssertionError("collective compiler never planned")
        if c_blocks.value - b0 != n_exec * n_exec:
            raise AssertionError("not every block rode a compiled wave")
        if via_collective != want:
            raise AssertionError("collective stage bytes differ")
        seen["collective"] = via_collective

        fused_got = io0.fetch_device_blocks(8, 0, n_exec, timeout_s=60, fused=True)
        try:
            seen["fused"] = {}
            for p in range(n_exec):
                if len(fused_got[p]) != 1:
                    raise AssertionError("fusion must land one slab")
                blob = fused_got[p][0].read(0, fused_got[p][0].length)
                if len(blob) != sum(len(x) for x in want[p]) or not all(
                        x in blob for x in want[p]):
                    raise AssertionError(f"fused slab misses a block (p={p})")
                seen["fused"][p] = blob
        finally:
            for bufs in fused_got.values():
                for b in bufs:
                    b.free()
        if c_fused.value - f0 != n_exec:
            raise AssertionError("fused merges not counted")
        seen["deltas"] = {"plans": c_plans.value - p0, "blocks": c_blocks.value - b0,
                          "fused_merges": c_fused.value - f0}

        conf.set("tpu.shuffle.collective.enabled", "false")
        try:
            seen["per_block"] = reduce_stage()
            if seen["per_block"] != want:
                raise AssertionError("per-block stage bytes differ")
        finally:
            conf.set("tpu.shuffle.collective.enabled", "true")

        c_overlap = reg.counter("collective.wave_overlap_ms", role=role)
        conf.set("tpu.shuffle.collective.autoTune", "false")
        conf.set("tpu.shuffle.collective.waveBytes", "128k")
        try:
            conf.set("tpu.shuffle.collective.pipelineDepth", "1")
            o0 = c_overlap.value
            if reduce_stage() != want:
                raise AssertionError("depth-1 stage bytes differ")
            if c_overlap.value != o0:
                raise AssertionError("depth-1 engine overlapped")
            seen["overlap_depth1"] = c_overlap.value - o0
            conf.set("tpu.shuffle.collective.pipelineDepth", "2")
            if reduce_stage() != want:
                raise AssertionError("depth-2 stage bytes differ")
            if c_overlap.value <= o0:
                raise AssertionError("depth-2 engine never overlapped")
            seen["overlap_depth2_positive"] = True
        finally:
            conf.set("tpu.shuffle.collective.pipelineDepth", "2")
            conf.set("tpu.shuffle.collective.waveBytes", "64m")
            conf.set("tpu.shuffle.collective.autoTune", "true")
    finally:
        for io in ios:
            io.stop()
        for ex in execs:
            ex.stop()
        driver.stop()
    return seen


def _tensor_publish_check(torch, dev):
    """Blocks handed to ``stage_device_blocks`` as CUDA tensors of int32,
    float16 and bfloat16 (one shuffle each): one device-to-host readback
    into registered memory, a device-to-device arena copy, and a reducer
    that pulls them byte-equal with a fetch typed with the tensors' own
    dtype. The endpoints take the default device (``cuda``, pinned to the
    current one)."""
    from sparkrdma_tpu_torch.shuffle.device_io import DeviceShuffleIO
    from sparkrdma_tpu_torch.shuffle.handle import BaseShuffleHandle, HashPartitioner
    from sparkrdma_tpu_torch.shuffle.manager import TpuShuffleManager
    from sparkrdma_tpu_torch.utils.config import TpuShuffleConf

    conf = TpuShuffleConf()
    driver = TpuShuffleManager(conf, is_driver=True)
    execs = [TpuShuffleManager(conf, is_driver=False, executor_id=f"tens-{i}")
             for i in range(2)]
    ios = [DeviceShuffleIO(ex) for ex in execs]
    if any(io.device_buffers.device != dev for io in ios):
        raise AssertionError("the default device is not the current card")
    g = torch.Generator(device="cpu").manual_seed(9)
    out = {}
    try:
        for sid, dtype in ((9, torch.int32), (19, torch.float16), (29, torch.bfloat16)):
            driver.register_shuffle(BaseShuffleHandle(
                shuffle_id=sid, num_maps=2, partitioner=HashPartitioner(2)))
            sent = {}
            for m, io in enumerate(ios):
                parts = {p: torch.randint(0, 1 << 31, (20000 + 7 * m + p,),
                                          generator=g, dtype=torch.int64)
                         .to(torch.int32).to(dev) for p in range(2)}
                if dtype != torch.int32:
                    parts = {p: (t.double() / (1 << 31) - 0.5).to(dtype)
                             for p, t in parts.items()}
                locs = io.stage_device_blocks(sid, parts)
                if not all(loc.block.has_device for loc in locs):
                    raise AssertionError("a CUDA block lost its device coordinates")
                io.publish_staged(sid, locs)
                sent.update({(m, p): t.cpu().view(torch.uint8).numpy().tobytes()
                             for p, t in parts.items()})
            for p, io in enumerate(ios):
                got = io.fetch_device_blocks(sid, p, p + 1, dtype=dtype, timeout_s=60)
                blobs = sorted(b.read(0, b.length) for b in got[p])
                if blobs != sorted(sent[(m, p)] for m in range(2)):
                    raise AssertionError(f"{dtype} CUDA-tensor blocks differ after the shuffle")
                if any(b.array.dtype != dtype for b in got[p]):
                    raise AssertionError(f"a {dtype} block came back typed otherwise")
                for b in got[p]:
                    b.free()
            out[str(dtype).removeprefix("torch.")] = "equal"
        snap = ios[0].metrics_snapshot()
        return {"equal": out, "stage_bytes": snap["stage_bytes"]}
    finally:
        for io in ios:
            io.stop()
        for ex in execs:
            ex.stop()
        driver.stop()


def phase_host_plane_path(torch, dev, data):
    """Phase 10: the host plane on the card. (a) dryrun sections 4 and 5
    on ``make_mesh([dev] * 4)``, and CUDA-tensor blocks through
    ``stage_device_blocks``; (b) phase 2's 1 GiB TeraSort through a
    driver and 8 executors: map (sort, stage, publish), then every
    reducer fetches its partition through the location RPC and the
    compiled waves and merges, run "default" (default knobs) and run
    "fused_512m" (``collective.waveBytes=512m``, fused); (c) the same
    published blocks with ``deviceFetch.enabled=false``: one-sided
    READs over the python transport and host-to-device staging. Counts
    from 0 just before, read just after."""
    from sparkrdma_tpu_torch.models.terasort import MapShardSorter, merge_blocks
    from sparkrdma_tpu_torch.obs import get_registry
    from sparkrdma_tpu_torch.ops import remote_copy as rc
    from sparkrdma_tpu_torch.parallel import make_mesh
    from sparkrdma_tpu_torch.shuffle.device_io import DeviceShuffleIO
    from sparkrdma_tpu_torch.shuffle.handle import BaseShuffleHandle, HashPartitioner
    from sparkrdma_tpu_torch.shuffle.manager import TpuShuffleManager
    from sparkrdma_tpu_torch.utils.config import TpuShuffleConf

    shards, edges, want = data
    reg = get_registry()
    rc.reset_launch_counts()
    report = {}

    def launches():
        return (rc.wave_pull_launches, rc.pipelined_wave_pull_launches)

    def degrades(ids):
        return sum(reg.counter("collective.degrades", role=i).value for i in ids)

    # ---- (a) dryrun sections 4 and 5, then CUDA-tensor blocks
    l0 = launches()
    dry_ids = [f"dry-{i}" for i in range(HOST_EXECUTORS)]
    d0 = degrades(dry_ids)
    t = time.perf_counter()
    seen = host_plane_sections(make_mesh([dev] * HOST_EXECUTORS).devices)
    report["a"] = {
        "wall_s": time.perf_counter() - t, "deltas": seen["deltas"],
        "collective.degrades": degrades(dry_ids) - d0,
        "wave_launches": [x - y for x, y in zip(launches(), l0)],
        "tensor_blocks": _tensor_publish_check(torch, dev),
    }
    if report["a"]["collective.degrades"] or sum(report["a"]["wave_launches"]) <= 0:
        raise AssertionError(f"run (a): {report['a']}")

    # ---- (b) the 1 GiB TeraSort through driver, publish and fetch
    sid = 10
    conf = TpuShuffleConf(HOST_PLANE_KNOBS)
    driver = TpuShuffleManager(conf, is_driver=True)
    ids = [f"host-{e}" for e in range(EXECUTORS)]
    execs = [TpuShuffleManager(conf, is_driver=False, executor_id=i) for i in ids]
    ios = [DeviceShuffleIO(ex, device=dev) for ex in execs]
    rpc = {k: reg.counter("rpc.messages", role="driver", type=k)
           for k in ("PUBLISH_PARTITION_LOCATIONS", "FETCH_PARTITION_LOCATIONS")}
    try:
        driver.register_shuffle(BaseShuffleHandle(
            shuffle_id=sid, num_maps=EXECUTORS, partitioner=HashPartitioner(REDUCERS)))
        rpc0 = {k: c.value for k, c in rpc.items()}
        sorter = MapShardSorter(dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()

        def map_phase(shuffle_id):
            """Sort, stage and publish every executor's shard; returns
            the wall, its split and the staged locations."""
            split = {"sort_s": 0.0, "stage_s": 0.0, "publish_s": 0.0}
            staged = []
            torch.cuda.synchronize()
            t_map = time.perf_counter()
            for e, io in enumerate(ios):
                t = time.perf_counter()
                keys, bounds = sorter.sort_partition(shards[e], edges)
                t1 = time.perf_counter()
                locs = io.stage_device_blocks(shuffle_id, {
                    r: keys[bounds[r]:bounds[r + 1]] for r in range(REDUCERS)})
                t2 = time.perf_counter()
                io.publish_staged(shuffle_id, locs)
                t3 = time.perf_counter()
                split["sort_s"] += t1 - t
                split["stage_s"] += t2 - t1
                split["publish_s"] += t3 - t2
                staged.extend(locs)
            torch.cuda.synchronize()
            return time.perf_counter() - t_map, split, staged

        map_s, split, staged_locs = map_phase(sid)
        if not all(loc.block.has_device for loc in staged_locs):
            raise AssertionError("a staged block has no device coordinates")
        stage = {k: sum(io.metrics_snapshot()[k] for io in ios)
                 for k in ("stage_copy_s", "stage_checksum_s", "stage_arena_s",
                           "stage_bytes")}

        def reduce_all(fused, check):
            outs = []
            torch.cuda.synchronize()
            t = time.perf_counter()
            for r, io in enumerate(ios):
                got = io.fetch_device_blocks(sid, r, r + 1, dtype=np.uint32,
                                             timeout_s=600, fused=fused)
                merged, total = merge_blocks(
                    [b.array[: b.length // 4] for b in got[r]])
                for b in got[r]:
                    b.free()
                outs.append((merged, total))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            if check:
                for r, (merged, total) in enumerate(outs):
                    _check_reducer(r, merged, total, want[r])
            return wall

        # (knobs, their defaults, fused); each run restores what it set
        runs = {"default": ({}, {}, False),
                "fused_512m": ({"tpu.shuffle.collective.waveBytes": "512m"},
                               {"tpu.shuffle.collective.waveBytes": "64m"}, True),
                "c_device_fetch_off": ({"tpu.shuffle.deviceFetch.enabled": "false"},
                                       {"tpu.shuffle.deviceFetch.enabled": "true"},
                                       False)}
        fetch_keys = ("fetch_transport_s", "fetch_stage_s", "fetch_bytes")
        report["b"] = {"keys": KEYS, "executors": EXECUTORS, "reducers": REDUCERS,
                       "map_s": map_s, "map_split": split, "stage": stage,
                       "arena_copy_from": "host (MapShardSorter returns numpy)"}
        for name, (knobs, defaults, fused) in runs.items():
            restore = {k: conf.get(k, d) for k, d in defaults.items()}
            for k, v in knobs.items():
                conf.set(k, v)
            try:
                before = {k: sum(reg.counter(f"collective.{k}", role=i).value
                                 for i in ids)
                          for k in ("blocks", "degrades", "fused_merges")}
                f0 = {k: sum(io.metrics_snapshot()[k] for io in ios) for k in fetch_keys}
                l0 = launches()
                cold = reduce_all(fused, check=True)
                warm = reduce_all(fused, check=False)
                deltas = {f"collective.{k}": sum(
                    reg.counter(f"collective.{k}", role=i).value for i in ids) - v
                    for k, v in before.items()}
                fetch = {k: sum(io.metrics_snapshot()[k] for io in ios) - f0[k]
                         for k in fetch_keys}
            finally:
                for k, v in restore.items():
                    conf.set(k, v)
            report[name] = {
                "knobs": knobs, "fused": fused, "reduce_cold_s": cold,
                "reduce_warm_s": warm, "reduce_gbps_warm": KEYS * 4 / warm / 1e9,
                "e2e_s": map_s + cold, "e2e_gbps": KEYS * 4 / (map_s + cold) / 1e9,
                "fetch_stats_two_reduces": fetch,
                "wave_launches": [x - y for x, y in zip(launches(), l0)],
                **deltas,
            }
        report["b"]["peak_device_bytes_above_baseline"] = (
            torch.cuda.max_memory_allocated() - base)
        report["b"]["registered_host_bytes"] = sum(
            size * n for io in ios for size, n in
            ((int(k), v) for k, v in
             io.metrics_snapshot()["registered_pool_allocs_by_class"].items()))
        report["b"]["driver_rpc"] = {k: c.value - rpc0[k] for k, c in rpc.items()}
        # the driver's view: every location it serves carries device coordinates
        report["b"]["served_with_device"] = all(
            loc.block.has_device
            for r, ex in enumerate(execs)
            for loc in ex.fetch_remote_partition_locations(sid, r, r + 1).result(60))
        # the map again on warm pools: unpublish returns the registered
        # buffers and arena slabs, a second shuffle reuses them (no
        # first-touch page faults); timed only, its blocks never fetched
        s0 = {k: sum(io.metrics_snapshot()[k] for io in ios)
              for k in ("stage_copy_s", "stage_checksum_s", "stage_arena_s")}
        for io in ios:
            io.unpublish(sid)
        driver.register_shuffle(BaseShuffleHandle(
            shuffle_id=sid + 1, num_maps=EXECUTORS,
            partitioner=HashPartitioner(REDUCERS)))
        warm_s, warm_split, _ = map_phase(sid + 1)
        report["b"]["map_warm_pools"] = {
            "map_s": warm_s, "map_split": warm_split,
            "stage": {k: sum(io.metrics_snapshot()[k] for io in ios) - v
                      for k, v in s0.items()}}
    finally:
        for io in ios:
            io.stop()
        for ex in execs:
            ex.stop()
        driver.stop()

    blocks = EXECUTORS * REDUCERS
    for name in ("default", "fused_512m"):
        r = report[name]
        if r["collective.blocks"] != 2 * blocks or r["collective.degrades"]:
            raise AssertionError(f"run {name}: {r}")
    if report["fused_512m"]["collective.fused_merges"] != 2 * REDUCERS:
        raise AssertionError("run fused_512m: not one fused merge per reducer and reduce")
    if report["default"]["wave_launches"][1] <= 0 or report["fused_512m"]["wave_launches"][0] <= 0:
        raise AssertionError("a wave-pull kernel never launched in run (b)")
    off = report["c_device_fetch_off"]
    if sum(off["wave_launches"]) or off["collective.blocks"]:
        raise AssertionError(f"run (c) used the waves: {off}")
    if not report["b"]["served_with_device"]:
        raise AssertionError("the driver served a location without device coordinates")
    counts = {"srt_wave_pull": rc.wave_pull_launches,
              "srt_pipelined_wave_pull": rc.pipelined_wave_pull_launches}
    emit(10, name="host_plane_path", launches=counts, **report)
    return counts


# ----------------------------------------------------------------------
# phase 11: sequence parallelism and the (dp, sp, tp) step over a mesh
# ----------------------------------------------------------------------
SP_SHARDS = 8
SP_CALLS = 3
# (rtol, atol) of each comparison at each serving shape. Both rings fold
# in f32 and round once, so they agree within a bf16 ulp; the bf16 flash
# kernel under Ulysses rounds p to bf16 as well
SP_TOL = {"bench_bf16_causal": {"ring_vs_one_shard_ring": (1e-2, 1e-2),
                                "ring_vs_ulysses": (5e-2, 5e-2),
                                "ulysses_vs_one_shard": (1e-2, 1e-2)},
          "workload_f32": dict.fromkeys(("ring_vs_one_shard_ring", "ring_vs_ulysses",
                                         "ulysses_vs_one_shard"), (2e-4, 2e-5))}
DRY_ATTN_TOL = (2e-4, 2e-5)  # __graft_entry__ dryrun section 2
DRY_LOSS_RTOL = 1e-4  # section 2b


def sp_dryrun_sections(torch, dev, e=SP_SHARDS):
    """Dryrun sections 2 and 2b (``__graft_entry__``) at their own sizes
    on ``make_mesh([dev] * e)`` and ``make_training_mesh([dev] * e)``,
    with their assertions and the same ``default_rng(2)`` draws."""
    from sparkrdma_tpu_torch.models.transformer_step import (
        TransformerStep, init_params, make_training_mesh, reference_step,
    )
    from sparkrdma_tpu_torch.ops import RingAttention, UlyssesAttention
    from sparkrdma_tpu_torch.ops.ring_attention import reference_attention
    from sparkrdma_tpu_torch.parallel import make_mesh

    out = {}
    mesh1d = make_mesh([dev] * e)
    rng = np.random.default_rng(2)

    def mk():
        return torch.from_numpy(rng.normal(size=(1, 8 * e, e, 8))
                                .astype(np.float32)).to(dev)

    q, k, v = mk(), mk(), mk()
    ref = reference_attention(q, k, v, causal=True)
    for sp in (RingAttention(mesh1d), UlyssesAttention(mesh1d)):
        name = type(sp).__name__
        out[name] = _max_err(torch, sp(q, k, v, causal=True), ref, "float32",
                             f"dryrun 2 {name}", DRY_ATTN_TOL)
    tmesh = make_training_mesh([dev] * e)
    tparams = init_params(16, n_heads=4, d_hidden=32, tp=tmesh.shape["tp"])
    bsz = 4 * tmesh.shape["dp"]
    tx = rng.normal(size=(bsz, 16, 16)).astype(np.float32)
    ty = rng.normal(size=(bsz, 16, 16)).astype(np.float32)
    ref_loss, _ = reference_step(tparams, torch.from_numpy(tx).to(dev),
                                 torch.from_numpy(ty).to(dev), 4, 0.1)
    for schedule in ("ring", "ulysses"):
        tstep = TransformerStep(tmesh, n_heads=4, lr=0.1, attn=schedule)
        loss, _ = tstep.step(*tstep.place(tparams, tx, ty))
        rel = abs(float(loss) - float(ref_loss)) / abs(float(ref_loss))
        if not rel <= DRY_LOSS_RTOL:
            raise AssertionError(f"dryrun 2b train step ({schedule}) loss diverged: "
                                 f"{float(loss)} vs {float(ref_loss)}")
        out[f"train_{schedule}_loss_rel_err"] = rel
    out["training_mesh"] = tmesh.shape
    return out


def _sp_counts(rc, pa):
    """The kernels of this phase's path and their launches since the last
    resets."""
    return {"srt_neighbor_pull": rc.neighbor_pull_launches, **_flash_launches(pa)}


def phase_sp_training_path(torch, dev, step7_s):
    """Phase 11: sequence parallelism and the (dp, sp, tp) training step
    on meshes of ``SP_SHARDS`` shards of the card. (a) dryrun sections 2
    and 2b at their own sizes; (b) serving at the two full widths on the
    8-shard exec mesh, ``SP_CALLS`` calls of each class, the ring held
    against the one-shard ring and Ulysses on the mesh, Ulysses against
    the one-shard Ulysses; (c) the workload's training step on
    ``make_training_mesh`` (dp 2, sp 2, tp 2) with both schedules, step 1
    against ``reference_step`` and phase 7's one-shard step, then
    ``run_steps`` of 9 more, and each schedule's gradients on every
    shard against the one-shard block's. The path's counts from 0 just
    before each run of (a), (b) and (c), read just after."""
    from sparkrdma_tpu_torch.models.transformer_step import (
        PARAM_SPECS, TransformerStep, make_training_mesh, reference_step,
    )
    from sparkrdma_tpu_torch.ops import RingAttention, UlyssesAttention
    from sparkrdma_tpu_torch.ops import pallas_attention as pa
    from sparkrdma_tpu_torch.ops import remote_copy as rc
    from sparkrdma_tpu_torch.parallel import make_mesh, shard

    def reset():
        rc.reset_launch_counts()
        pa.reset_launch_counts()

    report = {}
    total = dict.fromkeys(_sp_counts(rc, pa), 0)

    def add(counts):
        for k, n in counts.items():
            total[k] += n

    # ---- (a) dryrun sections 2 and 2b
    reset()
    t = time.perf_counter()
    report["a"] = sp_dryrun_sections(torch, dev)
    torch.cuda.synchronize()
    report["a"]["wall_s"] = time.perf_counter() - t
    counts = _sp_counts(rc, pa)
    add(counts)
    report["a"]["launches"] = {k: n for k, n in counts.items() if n}

    # ---- (b) serving on the 8-shard exec mesh at both full widths
    mesh = make_mesh([dev] * SP_SHARDS)
    for name, shape in ATTN_PATH_SHAPES.items():
        b, s, h, d, dtype, causal = shape
        entry = _fwd_entry(shape)
        tol = SP_TOL[name]
        q, k, v = _qkv(torch, dev, shape, 21)
        want_ul = UlyssesAttention()(q, k, v, causal=causal)
        want_ring = RingAttention()(q, k, v, causal=causal)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        run = {"shape": [b, s, h, d], "dtype": dtype, "causal": causal,
               "shards": SP_SHARDS}
        outs = {}
        for cls, key in ((UlyssesAttention, "ulysses"), (RingAttention, "ring")):
            attn = cls(mesh)
            walls = []
            reset()
            outs[key] = []
            for _ in range(SP_CALLS):
                t = time.perf_counter()
                outs[key].append(attn(q, k, v, causal=causal))
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t)
            counts = _sp_counts(rc, pa)
            add(counts)
            run[f"{key}_call_s"] = walls
            run[f"{key}_launches_per_call"] = {
                k_: n / SP_CALLS for k_, n in counts.items() if n}
        run["peak_above_baseline_bytes"] = torch.cuda.max_memory_allocated() - base
        for key, cls in (("ulysses", UlyssesAttention), ("ring", RingAttention)):
            attn = cls(mesh)
            run[f"{key}_profiled_call"] = _profiled(
                torch, lambda: attn(q, k, v, causal=causal))
        per_ul, per_ring = run["ulysses_launches_per_call"], run["ring_launches_per_call"]
        if per_ul != {entry: 1.0}:
            raise AssertionError(f"{name}: Ulysses launches a call {per_ul}, not 1 of {entry}")
        if per_ring != {"srt_neighbor_pull": 2.0 * (SP_SHARDS - 1)}:
            raise AssertionError(f"{name}: ring launches a call {per_ring}")
        errs = {"ulysses_vs_one_shard": [], "ring_vs_one_shard_ring": [],
                "ring_vs_ulysses": []}
        for i, (ul, ring) in enumerate(zip(outs["ulysses"], outs["ring"])):
            for key, out in (("ulysses", ul), ("ring", ring)):
                if out.shape != q.shape or out.dtype != q.dtype:
                    raise AssertionError(f"{name} {key} call {i}: {out.shape} {out.dtype}")
            for key, got, want in (("ulysses_vs_one_shard", ul, want_ul),
                                   ("ring_vs_one_shard_ring", ring, want_ring),
                                   ("ring_vs_ulysses", ring, ul)):
                errs[key].append(_max_err(torch, got, want, dtype,
                                          f"{name} {key} call {i}", tol[key]))
        run["max_abs_err"] = errs
        report[f"b_{name}"] = run
        del q, k, v, want_ul, want_ring, outs

    # ---- (b') the ring on the mesh at the workload width, causal: its
    # hops' direction shows only under the mask (outside the counts)
    b, s, h, d, dtype, _ = ATTN_PATH_SHAPES["workload_f32"]
    q, k, v = _qkv(torch, dev, (b, s, h, d, dtype, True), 22)
    report["b_workload_f32_causal_ring_vs_one_shard_ring_max_abs_err"] = _max_err(
        torch, RingAttention(mesh)(q, k, v, causal=True),
        RingAttention()(q, k, v, causal=True), dtype, "causal f32 ring on the mesh",
        SP_TOL["workload_f32"]["ring_vs_one_shard_ring"])
    del q, k, v

    # ---- (c) the workload's training step on (dp 2, sp 2, tp 2)
    t_ = TRAIN
    params, x, y = _train_data(torch, dev)
    tmesh = make_training_mesh([dev] * SP_SHARDS)
    ref_loss, ref_new = reference_step(params, x, y, t_["heads"], t_["lr"])
    one_loss, one_new = TransformerStep(n_heads=t_["heads"], lr=t_["lr"],
                                        attn="ulysses").step(params, x, y)
    one_grads = _block_grads(torch, params, x, y, "ring")
    n_steps = 1 + t_["steps_after_first"]
    for schedule in ("ulysses", "ring"):
        step = TransformerStep(tmesh, n_heads=t_["heads"], lr=t_["lr"], attn=schedule)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        reset()
        t = time.perf_counter()
        loss1, new1 = step.step(params, x, y)
        torch.cuda.synchronize()
        step1_s = time.perf_counter() - t
        after1 = {k: n for k, n in _sp_counts(rc, pa).items() if n}
        t = time.perf_counter()
        loss_k, _ = step.run_steps(new1, x, y, t_["steps_after_first"])
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t
        counts = _sp_counts(rc, pa)
        add(counts)
        peak = torch.cuda.max_memory_allocated() - base
        want1 = ({"srt_flash_attn_fwd_tf32x3": 1, "srt_flash_attn_bwd_dq_tf32x3": 1,
                  "srt_flash_attn_bwd_dkv_tf32x3": 1} if schedule == "ulysses"
                 else {"srt_neighbor_pull": 4})
        if after1 != want1 or {k: n for k, n in counts.items() if n} != {
                k: n * n_steps for k, n in want1.items()}:
            raise AssertionError(f"{schedule} step launches {after1}, {counts}")
        l1, lk = float(loss1), float(loss_k)
        if not (np.isfinite(lk) and lk <= l1 * 1.01):
            raise AssertionError(f"{schedule} on the mesh diverged: loss {l1} -> {lk}")
        checks = {}
        for what, (lw, pw) in (("reference_step", (ref_loss, ref_new)),
                               ("phase7_one_shard", (one_loss, one_new))):
            rel = abs(l1 - float(lw)) / abs(float(lw))
            if not rel <= TRAIN_LOSS_RTOL:
                raise AssertionError(f"{schedule} step 1 vs {what}: loss {l1} vs {float(lw)}")
            checks[what] = {"loss_rel_err": rel, "param_max_abs_err": _close_params(
                new1, pw, f"{schedule} step 1 vs {what}")}
        checks["grad_rel_err_every_shard_vs_one_shard_block"] = _grad_rel_err(
            step.gradients(params, x, y),
            {k: shard(tmesh, g, PARAM_SPECS[k]) for k, g in one_grads.items()},
            f"{schedule} step 1 gradients on the mesh")
        report[f"c_{schedule}"] = {
            "mesh": tmesh.shape, "step1_s": step1_s,
            "step_s_warm": run_s / t_["steps_after_first"],
            "phase7_one_shard_step_s_warm": step7_s,
            "loss_first": l1, "loss_last": lk, "steps": n_steps,
            "launches_per_step": {k: n / n_steps for k, n in counts.items() if n},
            "peak_above_baseline_bytes": peak, "step1_checks": checks,
            "profiled_step": _profiled(torch, lambda: step.step(params, x, y)),
        }
        del new1
    emit(11, name="sp_training_path", launches=total, **report)
    return total



# ---- phase 12: the SPMD models at their users' sizes
SPMD_MODEL_SHARDS = 8
# (a) TPC-DS SF100 q72: catalog_sales JOIN item on cs_item_sk = i_item_sk
# (TPC-DS v3 spec, table 3-2 row counts)
HJ_BUILD = 204_000
HJ_PROBE = 143_997_065
HJ_MIX = 0x9E3779B1  # Fibonacci hashing: a bijection on 32-bit keys
# (b) a tenth of twitter-2010 (41,652,230 vertices, 1,468,365,182 edges)
PR_VERTICES = 4_165_223
PR_EDGES = 146_836_518
PR_ITERS = 20
PR_RTOL = 1e-4
PR_ATOL_N = 1e-4  # over the vertex count
# (c) MovieLens-20M's counts; Spark MLlib ALS defaults
ALS_USERS = 138_493
ALS_ITEMS = 26_744
ALS_RATINGS = 20_000_263
ALS_RANK = 10
ALS_ITERS = 10
ALS_REG = 0.1
ALS_TOL = (2e-3, 2e-4)  # one iteration against float64 (tests/test_als.py)
ALS_RMSE_TOL = 5e-3
ALS_CHUNK = 1 << 22  # ratings per index_add_ of the float64 plain version


def _all_counts(rc, pa):
    """Every kernel's launches since the last resets."""
    return {"srt_wave_pull": rc.wave_pull_launches,
            "srt_pipelined_wave_pull": rc.pipelined_wave_pull_launches,
            **_sp_counts(rc, pa)}


def _peak_run(torch, fn):
    """``fn()``'s result, wall (ending in a sync) and peak device bytes
    above the baseline at its start."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t, torch.cuda.max_memory_allocated() - base


def _synced_s(torch, fn):
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


def _models_hashjoin(torch, dev, mesh):
    """(a) The q72 join at SF100; exact against a lookup in the sorted
    build keys on the card."""
    from sparkrdma_tpu_torch.models import HashJoin

    t = time.perf_counter()
    rng = np.random.default_rng(31)
    # surrogate keys mixed over the 32-bit space as Spark's hash
    # partitioner spreads them: raw keys below 2^29 have zero top bits
    # and radix_partition would send every row to shard 0
    bk = ((np.arange(1, HJ_BUILD + 1, dtype=np.uint64) * HJ_MIX)
          % (1 << 32)).astype(np.uint32)
    if (bk == 0xFFFFFFFF).any() or len(np.unique(bk)) != HJ_BUILD:
        raise AssertionError("a mixed item key is SENTINEL or not unique")
    bv = rng.integers(0, (1 << 31) - 1, HJ_BUILD, dtype=np.int32)
    pk = bk[rng.integers(0, HJ_BUILD, HJ_PROBE, dtype=np.int32)]
    pv = np.arange(HJ_PROBE, dtype=np.int32)
    gen_s = time.perf_counter() - t

    hj = HashJoin(mesh)
    out, join_s, peak = _peak_run(torch, lambda: hj.join(bk, bv, pk, pv))
    run = {"build_rows": HJ_BUILD, "probe_rows": HJ_PROBE, "data_s": gen_s,
           "join_s": join_s, "walls": hj.last_walls,
           "capacities": hj.last_capacities, "tries": len(hj.last_capacities),
           "peak_above_baseline_bytes": peak}

    # exact: every probe row once (its values a permutation of arange),
    # with its own key, joined to the build value of that key
    got = torch.from_numpy(out).to(dev)
    del out
    if tuple(got.shape) != (HJ_PROBE, 3):
        raise AssertionError(f"join output {tuple(got.shape)}, not ({HJ_PROBE}, 3)")
    rows = got[:, 1]
    if not torch.equal(torch.sort(rows).values,
                       torch.arange(HJ_PROBE, dtype=torch.int64, device=dev)):
        raise AssertionError("probe values are not a permutation of arange")
    pk_dev = torch.from_numpy(pk.view(np.int32)).to(dev).to(torch.int64) & 0xFFFFFFFF
    if not torch.equal(pk_dev[rows], got[:, 0]):
        raise AssertionError("a joined row carries another row's probe key")
    del pk_dev, rows
    keys, order = torch.sort(torch.from_numpy(bk.astype(np.int64)).to(dev))
    pos = torch.searchsorted(keys, got[:, 0].contiguous()).clamp_(max=HJ_BUILD - 1)
    if not torch.equal(keys[pos], got[:, 0]):
        raise AssertionError("a probe key missed the build side")
    want = torch.from_numpy(bv).to(dev).to(torch.int64)[order[pos]]
    if not torch.equal(want, got[:, 2]):
        raise AssertionError("a joined value differs from the lookup's")
    del got, keys, order, pos, want
    run["exact"] = True

    # the step again, warm, and the row assembly and readback apart
    args, nb, npl = hj.place(bk, bv, pk, pv)
    fn = hj.step(nb, npl, *hj.last_capacities[-1])
    res, run["step_warm_s"] = _synced_s(torch, lambda: fn(*args))
    rows_dev, run["rows_s"] = _synced_s(torch, lambda: hj._rows(*res[:4]))
    del res
    _, run["readback_s"] = _synced_s(torch, lambda: rows_dev.cpu())
    run["readback_gbps"] = rows_dev.numel() * 8 / run["readback_s"] / 1e9
    del rows_dev
    run["profiled_step"] = _profiled(torch, lambda: fn(*args))
    del args
    return run


def _models_pagerank(torch, dev, mesh):
    """(b) PageRank on a tenth of twitter-2010, against a float64 power
    iteration on the card."""
    from sparkrdma_tpu_torch.models import PageRank

    t = time.perf_counter()
    rng = np.random.default_rng(32)
    # benchmarks/run_workloads.py's draw: uniform (src, dst) pairs
    edges = rng.integers(0, PR_VERTICES, size=(PR_EDGES, 2), dtype=np.int64)
    gen_s = time.perf_counter() - t
    n = PR_VERTICES
    pr = PageRank(mesh)
    out, run_s, peak = _peak_run(torch, lambda: pr.run(edges, n, iters=PR_ITERS))
    run = {"vertices": n, "edges": PR_EDGES, "iters": PR_ITERS, "data_s": gen_s,
           "run_s": run_s, "walls": pr.last_walls,
           "peak_above_baseline_bytes": peak}

    ed = torch.from_numpy(edges).to(dev)
    del edges
    src, dst = ed[:, 0], ed[:, 1]
    outdeg = torch.bincount(src, minlength=n).to(torch.float64)
    want = torch.full((n,), 1.0 / n, dtype=torch.float64, device=dev)
    for _ in range(PR_ITERS):
        outc = torch.where(outdeg > 0, want / outdeg.clamp(min=1), 0.0)
        contrib = torch.zeros_like(want).index_add_(0, dst, outc[src])
        dangling = want[outdeg == 0].sum()
        want = (1 - pr.damping) / n + pr.damping * (contrib + dangling / n)
    del src, dst, outdeg, outc, contrib
    got = torch.from_numpy(out).to(dev).to(torch.float64)
    err = (got - want).abs()
    if not bool((err <= PR_ATOL_N / n + PR_RTOL * want.abs()).all()):
        raise AssertionError(f"PageRank differs from float64: max abs {float(err.max())}")
    total = float(out.sum(dtype=np.float64))
    if abs(total - 1.0) > 1e-3:
        raise AssertionError(f"ranks sum to {total}")
    run.update(max_abs_err=float(err.max()), max_rel_err=float((err / want).max()),
               rank_sum=total, tolerance={"rtol": PR_RTOL, "atol": PR_ATOL_N / n})
    del got, want, err

    packed, deg, n_local = pr.blocks(ed, n)
    del ed
    rank0, valid = pr.initial(n_local, n)
    fn = pr.step(n_local, packed.shape[2], PR_ITERS, n)
    _, wall = _synced_s(torch, lambda: fn(rank0, deg, valid, packed))
    run.update(n_local=n_local, cap=packed.shape[2], packed_bytes=packed.numel() * 4,
               iterations_warm_s=wall, ms_per_iter_warm=wall / PR_ITERS * 1e3,
               profiled_run=_profiled(torch, lambda: fn(rank0, deg, valid, packed)))
    return run


def _als_plain(torch, users, items, vals, u, v, iters, reg):
    """float64 ALS on the card written apart from the port's padded
    lists: each row's normal equations summed over its ratings by
    ``index_add_``, then one batched solve."""
    k = u.shape[1]
    eye = torch.eye(k, dtype=torch.float64, device=u.device)

    def half(rows, cols, n_rows, other):
        a = torch.zeros((n_rows, k * k), dtype=torch.float64, device=u.device)
        b = torch.zeros((n_rows, k), dtype=torch.float64, device=u.device)
        for c in range(0, len(rows), ALS_CHUNK):
            r, f = rows[c:c + ALS_CHUNK], other[cols[c:c + ALS_CHUNK]]
            a.index_add_(0, r, (f[:, :, None] * f[:, None, :]).view(-1, k * k))
            b.index_add_(0, r, f * vals[c:c + ALS_CHUNK, None])
        n = torch.bincount(rows, minlength=n_rows).clamp(min=1).to(torch.float64)
        a = a.view(n_rows, k, k) + reg * n[:, None, None] * eye
        return torch.linalg.solve(a, b)

    for _ in range(iters):
        u = half(users, items, u.shape[0], v)
        v = half(items, users, v.shape[0], u)
    return u, v


def _models_als(torch, dev, mesh):
    """(c) ALS at MovieLens-20M's counts, against a float64 plain version
    on the card from the same start factors."""
    from sparkrdma_tpu_torch.models import ALS, rmse

    t = time.perf_counter()
    rng = np.random.default_rng(33)
    # tests/test_als.py's ratings: a rank-4 true model plus 0.01 noise
    true_u = rng.normal(size=(ALS_USERS, 4))
    true_v = rng.normal(size=(ALS_ITEMS, 4))
    users = rng.integers(0, ALS_USERS, ALS_RATINGS)
    items = rng.integers(0, ALS_ITEMS, ALS_RATINGS)
    vals = (true_u[users] * true_v[items]).sum(1) + 0.01 * rng.normal(size=ALS_RATINGS)
    ratings = np.stack([users, items, vals], axis=1).astype(np.float64)
    del true_u, true_v, users, items, vals
    gen_s = time.perf_counter() - t

    als = ALS(mesh, rank=ALS_RANK, reg=ALS_REG)
    run = {"users": ALS_USERS, "items": ALS_ITEMS, "ratings": ALS_RATINGS,
           "rank": ALS_RANK, "reg": ALS_REG, "data_s": gen_s}
    (u1, v1), run["fit_1_s"], _ = _peak_run(
        torch, lambda: als.fit(ratings, ALS_USERS, ALS_ITEMS, iters=1, seed=0))
    (u, v), run["fit_s"], run["peak_above_baseline_bytes"] = _peak_run(
        torch, lambda: als.fit(ratings, ALS_USERS, ALS_ITEMS, iters=ALS_ITERS, seed=0))
    run["walls"] = als.last_walls

    r = torch.from_numpy(ratings).to(dev)
    ru, ri, rv = r[:, 0].to(torch.int64), r[:, 1].to(torch.int64), r[:, 2]
    nu = -(-ALS_USERS // mesh.num_shards)
    ni = -(-ALS_ITEMS // mesh.num_shards)
    u0, v0 = (torch.from_numpy(x).to(dev).to(torch.float64)
              for x in als.initial(nu, ni, seed=0))
    u0, v0 = u0[:ALS_USERS], v0[:ALS_ITEMS]
    (pu1, pv1), plain_1_s = _synced_s(
        torch, lambda: _als_plain(torch, ru, ri, rv, u0, v0, 1, ALS_REG))
    rtol, atol = ALS_TOL
    errs = {}
    for what, got, want in (("u", u1, pu1), ("v", v1, pv1)):
        err = (torch.from_numpy(got).to(dev).to(torch.float64) - want).abs()
        errs[what] = float(err.max())
        if not bool((err <= atol + rtol * want.abs()).all()):
            raise AssertionError(f"ALS one iteration: {what} differs from float64 "
                                 f"by {errs[what]}")
    (pu, pv), plain_s = _synced_s(
        torch, lambda: _als_plain(torch, ru, ri, rv, u0, v0, ALS_ITERS, ALS_REG))
    del r, ru, ri, rv
    got_rmse = rmse(u, v, ratings)
    want_rmse = rmse(pu.float().cpu().numpy(), pv.float().cpu().numpy(), ratings)
    if not (np.isfinite(got_rmse) and abs(got_rmse - want_rmse) < ALS_RMSE_TOL):
        raise AssertionError(f"ALS RMSE {got_rmse} against float64's {want_rmse}")
    run.update(one_iteration_max_abs_err=errs, rmse=got_rmse, plain_rmse=want_rmse,
               plain_fit_1_s=plain_1_s, plain_fit_s=plain_s)
    del u1, v1, pu1, pv1, pu, pv

    u_idx, u_val, i_idx, i_val, nu, ni = als.lists(
        torch.from_numpy(ratings).to(dev), ALS_USERS, ALS_ITEMS)
    del ratings
    u0, v0 = (torch.from_numpy(x).to(dev) for x in als.initial(nu, ni, seed=0))
    fn = als.step(nu, ni, u_idx.shape[1], i_idx.shape[1], ALS_ITERS)
    _, wall = _synced_s(torch, lambda: fn(u_idx, u_val, i_idx, i_val, u0, v0))
    run.update(cap_u=u_idx.shape[1], cap_i=i_idx.shape[1],
               gather_bytes={"users": u_idx.numel() * ALS_RANK * 4,
                             "items": i_idx.numel() * ALS_RANK * 4},
               iterations_warm_s=wall, ms_per_iter_warm=wall / ALS_ITERS * 1e3,
               profiled_fit=_profiled(
                   torch, lambda: fn(u_idx, u_val, i_idx, i_val, u0, v0)))
    return run


def phase_spmd_models(torch, dev):
    """Phase 12: HashJoin, PageRank and ALS on ``make_mesh([dev] * 8)`` at
    their users' sizes, each checked against an independent version on
    the card. The models launch no hand-written kernel (their exchanges
    are the dense all-to-all's transpose): every count is 0 from just
    before to just after."""
    from sparkrdma_tpu_torch.models import MapShardSorter
    from sparkrdma_tpu_torch.ops import pallas_attention as pa
    from sparkrdma_tpu_torch.ops import remote_copy as rc
    from sparkrdma_tpu_torch.parallel import make_mesh

    mesh = make_mesh([dev] * SPMD_MODEL_SHARDS)
    t0 = time.perf_counter()
    rc.reset_launch_counts()
    pa.reset_launch_counts()
    report = {"shards": SPMD_MODEL_SHARDS}
    _, report["map_sorter_warm_s"] = _synced_s(
        torch, lambda: MapShardSorter(dev).warm(KEYS // EXECUTORS, REDUCERS - 1))
    report["a_hashjoin"] = _models_hashjoin(torch, dev, mesh)
    report["b_pagerank"] = _models_pagerank(torch, dev, mesh)
    report["c_als"] = _models_als(torch, dev, mesh)
    launched = {k: n for k, n in _all_counts(rc, pa).items() if n}
    if launched:
        raise AssertionError(f"the SPMD models launched kernels: {launched}")
    emit(12, name="spmd_models", launches={}, seconds=time.perf_counter() - t0,
         **report)


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
    smi = phase_environment(torch)
    phase_kernels(torch, dev)
    arenas, ids, locs, launches, data = phase_main_path(torch, dev)
    kernels = phase_timing(torch, dev, arenas, ids, locs)
    phase_terasort_step(torch, dev)
    phase_attention_kernel(torch, dev)
    serving = phase_attention_path(torch, dev)
    kernels.extend(time_flash_attention(torch, dev))
    phase_attention_bwd_kernel(torch, dev)
    training, step7_s = phase_training_path(torch, dev)
    kernels.extend(time_flash_attention_bwd(torch, dev))
    phase_second_device(torch)
    phase_neighbor_pull_kernel(torch, dev)
    spmd = phase_spmd_path(torch, dev)
    kernels.append(time_neighbor_pull(torch, dev))
    host_plane = phase_host_plane_path(torch, dev, data)
    del data
    sp_training = phase_sp_training_path(torch, dev, step7_s)
    phase_spmd_models(torch, dev)
    launches.update(training)
    for k, n in serving.items():
        launches[k] += n
    launches["srt_neighbor_pull"] = spmd
    for k, n in host_plane.items():
        launches[k] += n
    for k, n in sp_training.items():
        launches[k] += n
    for k in kernels:
        k["launches"] = launches[k["name"]]
    for r in range(REDUCERS):
        for loc in locs[r]:
            arenas[ids.index(loc.manager_id.executor_id)].resolve(
                loc.block.arena_handle).free()
    for a in arenas:
        a.stop()
    emit("done", seconds=time.perf_counter() - t0)
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
