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
   the warm step, one ``srt_merge_runs`` launch a step; (d) at 2^24 keys the all-zero skew with
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
   profiled step each; ``HashJoin`` launches ``srt_radix_pack`` once a
   side a step and ``srt_sorted_probe`` once a step (at 8-byte rows
   ``srt_radix_pack64`` and ``srt_sorted_probe64``), ``PageRank.blocks``
   once a call (its bucketing),
   ``PageRank``'s step one CSR build a call and one ``srt_csr_pull`` an
   iteration (three calls of 20: 3 and 60), and nothing else, ALS no
   kernel (the exchanges are the dense all-to-all);
   ``MapShardSorter.warm`` once; ``timing_csr_pull`` then checks the
   CSR build block by block against its plain version at the PageRank
   cell's shapes and times the pull beside its byte bound and cuSPARSE's
   SpMV over the same CSR; ``timing_merge_runs`` checks ``srt_merge_runs``
   bit for bit against its plain version at the sort cell's merge
   (``[8, 8, 2^23]``) and times it beside its byte bound, the plain
   version, ``torch.sort`` of the same masked slab and the per-shard
   path it replaced; ``timing_sorted_probe`` and ``timing_sorted_probe64``
   check ``srt_sorted_probe`` and ``srt_sorted_probe64`` bit for bit
   against their plain version at the two join cells' probes and time
   them beside their byte bounds, the plain version and
   ``torch.searchsorted`` alone;
13. ``data_planes``: the host plane's record writers and readers over the
   python transport at HiBench TeraSort's small profile (3,200,000
   records of a uint32 key and 12 uint64 payload words, word j = key *
   (j + 1), keys uniform from ``default_rng(13)``), a driver and 4
   executors, 8 map tasks on the executors' map pools, a
   ``RangePartitioner`` at ``(r << 32) // 8`` and 8 reducers each
   reading one partition through ``get_reader``: (a) the wrapper writer
   with ``block.format=auto``, which must negotiate columnar blocks and
   zero-copy view decodes; (b) the chunked-agg writer with push/merge on
   (a tenth of the records), merged and remote blocks reported; (c) over
   (a)'s committed blocks, every reducer's fetched columnar frames
   through ``device_put_columns`` to the card, the key columns sorted
   there by ``device_sort``, one frame a reducer through
   ``sort_columnar_partition`` against ``sort_partition``; (d) a fault
   plan (two failed READs, one corrupted) over a tenth of the records,
   against the same run without it: equal output, retries and a
   detected corruption. Every reducer's count, keys (against ``np.sort``
   of its range) and payload words are checked in every run; walls,
   bytes READ, pool bytes, host-to-device bytes and peak device bytes
   reported; no kernel launches;
14. ``engine``: the engine on the card's host, the card's name and power
   limit beside it: (a) the README's Quick start on the port's
   ``TpuContext``, run as written, against plain Python; (b) HiBench
   TeraSort small (3,200,000 records ``(int key, b"x" * 90)``, keys from
   ``default_rng(0)``, ``bench_engine_terasort``'s job:
   ``TpuContext(num_executors=2, task_threads=4)``,
   ``parallelize(data, 8).sort_by_key(8)``): the whole output sorted,
   its keys ``np.sort`` of the input's, every payload intact; job wall,
   records/s, logical GB/s, the job's critical-path breakdown,
   ``engine.task_ms`` by kind, no stage recompute; (c) at a tenth,
   ``driver:kill:1:stage=reduce_phase`` (output equal, adoptions rise)
   and an executor lost between two reads of one shuffle (output equal,
   one stage recompute); (d) the same size through ``ClusterContext``'s
   4 worker processes, 8 map functions making their keys in the
   workers, a ``RangePartitioner`` at ``((r + 1) << 32) // 8``: every
   reducer's count, xor, min and max against the generator's, the
   ranges disjoint and ordered, and each worker without a CUDA context
   and without jax; start-up and job walls; (e) at a tenth, the
   chunked-agg writer with push in cluster mode (merged segments read)
   and ``exec:kill`` of one worker at its first reduce under the wrapper
   writer (output as (d)'s, one recovery, the worker exits 1); no kernel
   launches;
15. ``native_plane``: the native plane (``transport=native``: the C++
   data plane, the native arena, ``/dev/shm`` slabs, mapped delivery) on
   the card's machine, with the libraries' g++ build seconds, io_uring
   compiled in and the effective read backend, ``/dev/shm``'s free
   bytes, the registered buffers by backing and ``transport.sq.*``:
   (a) two native nodes and a python node, one-sided READ and SEND in
   every direction, byte-equal, each native node counting one fast-path
   and one streamed READ; (b) phase 10 (b)'s TeraSort over native
   (every node a ``NativeTpuNode``, no slab fallen back to anonymous
   memory, each reducer checked as in phase 2, the wave kernels
   launched), the map split cold and on warm pools beside phase 10's;
   (c) its blocks with ``deviceFetch.enabled=false`` by mapped
   delivery: fast-path READs equal to the remote blocks, none streamed,
   no pooled registered buffer taken, every block byte-equal to the
   map's, the reduce beside phase 10 (c)'s; (d) phase 13 (a) over
   native with its checks; (e) phase 14 (d) at a tenth over native, each
   of the 4 workers running a ``NativeTpuNode`` without CUDA. Phases 10,
   13 and 14 run the python plane;
16. ``operations_planes``: the telemetry and journal plane on the card's
   host, the card's name and power limit beside it. Phases 10 and 13-15
   run with the driver's ``TelemetryHub`` on (``obs.telemetry.enabled``,
   the default), and phase 14 (b) reports what the hub held after its
   job. (a) The hub alone: 600 synthetic heartbeats from each of 8
   executors, one of them 20 times busier, through
   ``TelemetryHub.ingest`` with the SLO engine and the capacity plane
   on: microseconds per ingest (p50, p99), only the outlier flagged; the
   OpenMetrics render of the process registry (ms, bytes); a
   10,000-event journal from 8 processes merged through ``JournalHub``
   as heartbeats ship it (each beat re-ships the last): microseconds per
   event, the merge in ``sort_key`` order without duplicates or gaps.
   (b) Phase 14 (b)'s job with ``obs.telemetry.enabled=false`` beside
   phase 14 (b)'s wall with the hub on (the difference is the hub's
   cost; at a tenth, printed, if phase 14 (b) took over 45 s): both
   outputs ``np.sort`` of the keys, both executors in phase 14 (b)'s
   hub, no missed heartbeat. (c) ``ClusterContext``'s 4 workers at phase
   14 (d)'s shape at a tenth, each worker's first READ failing once
   under a one-failure breaker: the poll loop builds a series for every
   worker, the workers' circuit events reach the driver's merged
   journal, and rounds of the poll loop's request are timed. (d) Phase
   10 (b)'s default run (1 GiB, a driver and 8 executors, python plane)
   reduced twice, as phase 10 (b) ran (no engine breakdown published):
   the ``autotune.adjust`` events equal the tuners' adjustment counters,
   the wave launches phase 10 (b)'s, every reducer ``np.sort`` of its
   range; the breakdown gate's verdict on the last engine job's
   breakdown is printed;
17. ``elastic_planes``: the elastic plane, the obs CLI and the
   invariant suite on the card's host, the card's name and power limit
   beside it. (a) HiBench TeraSort small (3,200,000 records of an int key
   and a 90-byte value naming its map and row; keys as phase 14 (d)'s)
   through ``ClusterContext``'s 4 workers and a ``RangePartitioner``,
   three times: without replicas, with ``elastic.replicas=1``, and with
   it and ``exec:kill`` of proc-exec-1 at its first reduce. Each
   reducer's records (count and SHA-256, sorted) equal those numpy
   computes from ``np.sort`` of the generator's keys, so the three runs
   agree byte for byte; the killed run recomputes no map and promotes
   replicas. Replicated bytes, the map stage's wall with and without
   replicas, and the recovery's wall (from the driver seeing the dead
   worker to the job's end). (b) ``TpuContext`` with replicas at a
   tenth: ``lose_executor`` between two reads of one sort, equal, no
   stage recompute, promotions. (c) At a tenth, ``driver:kill`` at
   reduce-phase entry then ``exec:kill``: no recompute, adoptions and
   promotions, the output exact. (d) ``python -m
   sparkrdma_tpu_torch.elastic.service`` adopts proc-exec-0's maps
   (``transport=auto``, a tenth): the adopted maps are that worker's,
   linked or copied is printed, and the survivor's reads before the
   handoff, after it and after the worker's SIGKILL are the same bytes;
   the handoff's wall. (e) Phase 10 (b)'s default run with the port's
   lock-order detector enabled (``analysis.lockorder.default``): 0
   violations, the lock names and order edges, the wave launches phase
   10 (b)'s, the warm reduce again with the detector off (its cost);
   then ``python -m sparkrdma_tpu_torch.analysis`` on the checkout exits
   0, clean. (f) The obs CLI as child processes over (a)-(d)'s
   artifacts (the driver's flight record of (a)'s killed run, the
   process's Chrome trace and registry snapshot): ``--openmetrics``,
   ``--timeline``, ``--diagnose``, ``--critical-path``,
   ``--flamegraph``, ``--flight-recorder`` and ``--demo``, each exiting
   0 with output, none loading jax or initialising CUDA;
18. ``models_and_ranks``: the model checker, two ranks and the live
   schedule-point seam, the card's name and power limit beside them.
   (a) The model checker as child processes on the card's host, none
   loading jax or initialising CUDA: ``python -m
   sparkrdma_tpu_torch.analysis.modelcheck --walks 25`` (every model
   clean), ``--mutants`` (18 of 18 caught), a child that runs the gate
   and replays each caught schedule three times (identical text) and
   once without its mutant (clean, or unable to follow the schedule,
   never a violation), ``--replay`` of one caught schedule a model, and
   ``--exhaustive --max-schedules 2000`` of each model, all started
   together and alone on the host: schedules
   explored, complete or not, walls. (b) Two ranks on the card (the
   default compute mode, read from ``nvidia-smi``, is required):
   ``multihost.initialize`` over loopback (gloo), 4 shards a rank on
   ``cuda:0`` (E = 8), each rank feeding its half of phase 9's 1 GiB
   study send through ``exchange`` and ``ring_exchange``, 6 calls each:
   every received shard's SHA-256 equal to the one-process program's,
   computed here; cold and warm walls, per-process ``exchange.*``
   deltas, 14 ``srt_neighbor_pull`` launches a ring call on each rank,
   the bytes that crossed ranks and the path they took (gloo's
   ``all_to_all_single`` takes CUDA tensors; the ring's hops stage
   through pinned host buffers). Before it, ``srt_neighbor_pull`` with
   its last row read from a separate tensor against its plain version.
   (c) Phase 10 (b)'s map and reduces with the live ``schedule_point``
   and no scheduler active: the schedule points reached, the wave
   launches of the cold and warm reduce equal to phase 10 (b)'s, then
   warm reduces with the seam live and stubbed, in turns;

Then the timing phases (every kernel at its main path's shapes: the
kernel's time against its bound, the plain version's and, where one
PyTorch call computes the same function, its time as a yardstick:
``scaled_dot_product_attention`` forward and backward, ``torch.roll``;
``srt_radix_pack`` at the join cell's shape against the plain version
and the per-shard ``pack_by_partition`` pair it replaced;
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
import hashlib
import json
import math
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


# what earlier phases measured, for later phases to print beside their own
_REPORTS = {}


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def _launched(*symbols):
    """Launches of the C entry points ``symbols`` since the last reset,
    summed."""
    from sparkrdma_tpu_torch.ops import _build

    return sum(_build.launches[s] for s in symbols)


def _wave_launches():
    return _launched("srt_wave_pull"), _launched("srt_pipelined_wave_pull")


def _reset_launches():
    from sparkrdma_tpu_torch.ops import _build

    _build.reset_launch_counts()


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
    _build._load(_build.LIB_NAME)
    build_s, build_log = _build.builds.get(_build.LIB_NAME, (None, ""))
    emit(0, nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
         device=torch.cuda.get_device_name(0),
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
         float32_matmul_precision=torch.get_float32_matmul_precision(),
         build_s=build_s, load_s=time.perf_counter() - t0,
         ptxas=[ln.strip() for ln in build_log.splitlines()
                if "ptxas info" in ln or "spill" in ln or "warning" in ln],
         tf32x3_ptxas=ptxas_summary(build_log, "tf32x3"))
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
        "srt_wave_pull": _launched("srt_wave_pull"),
        "srt_pipelined_wave_pull": _launched("srt_pipelined_wave_pull"),
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
    _reset_launches()
    report = {}
    for name, (conf, fused) in runs.items():
        before = {k: counter_sum(f"collective.{k}")
                  for k in ("blocks", "degrades", "fused_merges")}
        w0, p0 = _launched("srt_wave_pull"), _launched("srt_pipelined_wave_pull")
        reduce_s, kernel_ms = reduce_stage(conf, fused, check=True)
        deltas = {k: counter_sum(f"collective.{k}") - v for k, v in before.items()}
        report[name] = {
            "wave_bytes": conf.collective_wave_bytes, "fused": fused,
            "map_s": map_s, "reduce_s": reduce_s, "total_s": map_s + reduce_s,
            "e2e_gbps": KEYS * 4 / (map_s + reduce_s) / 1e9,
            "reduce_gbps": KEYS * 4 / reduce_s / 1e9,
            "kernel_ms": kernel_ms, "kernel_ms_sum": sum(kernel_ms),
            "srt_wave_pull_launches": _launched("srt_wave_pull") - w0,
            "srt_pipelined_wave_pull_launches":
                _launched("srt_pipelined_wave_pull") - p0,
            **{f"collective.{k}": v for k, v in deltas.items()},
        }
    launches = {"srt_wave_pull": _launched("srt_wave_pull"),
                "srt_pipelined_wave_pull": _launched("srt_pipelined_wave_pull")}
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
        lib = _build._load(_build.LIB_NAME)
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
FLASH_ENTRIES = FWD_KERNELS + (
    "srt_flash_attn_bwd_dq", "srt_flash_attn_bwd_dkv", "srt_flash_attn_bwd_dq_sm90",
    "srt_flash_attn_bwd_dkv_sm90", "srt_flash_attn_bwd_dq_tf32x3",
    "srt_flash_attn_bwd_dkv_tf32x3")


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
        before = _flash_launches()
        got = pa.flash_attention_fwd(q, k, v, causal)[0]
        got2, lse = pa.flash_attention_fwd(q, k, v, causal, want_lse=True)
        torch.cuda.synchronize()
        took = _took(before)
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
        before = _flash_launches()
        got = pa.flash_attention(qm, k, v, causal=True)
        took = _took(before)
        if took != {"srt_flash_attn_fwd": 1}:
            raise AssertionError(f"misaligned q {shape}: launched {took}, not the SIMT kernel")
        err = _max_err(torch, got, pa.flash_attention_reference(q, k, v, True)[0],
                       dtype, f"srt_flash_attn_fwd misaligned q {shape}")
        cases.append({"shape": list(shape[:4]), "dtype": dtype, "causal": True,
                      "entry": "srt_flash_attn_fwd", "misaligned_q": True,
                      "max_abs_err": err})
    emit(4, name="attention_kernel", cases=cases,
         launches={k: n for k, n in _flash_launches().items() if k in FWD_KERNELS})


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
        _reset_launches()
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
        n = _launched(*FWD_KERNELS)
        took = {k: c for k, c in _flash_launches().items() if c}
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
    lib = _build._load(_build.LIB_NAME)
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


def _flash_launches():
    """Launches per flash C entry point since the last reset."""
    return {k: _launched(k) for k in FLASH_ENTRIES}


def _took(before):
    """The entry points launched since ``before`` (a :func:`_flash_launches`),
    with their counts."""
    return {k: n - before[k] for k, n in _flash_launches().items() if n != before[k]}


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
        before = _flash_launches()
        got = pa.flash_attention_bwd(q, k, v, out, lse, do, causal)
        torch.cuda.synchronize()
        took = _took(before)
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
        before = _flash_launches()
        got = pa.flash_attention_bwd(q, k, v, out, lse, dom, True)
        took = _took(before)
        if took != dict.fromkeys(BWD_PAIRS["simt"], 1):
            raise AssertionError(f"misaligned do {shape}: launched {took}, not the SIMT pair")
        cases.append({"shape": list(shape[:4]), "dtype": dtype, "causal": True,
                      "misaligned_do": True, "entry": list(BWD_PAIRS["simt"]),
                      "max_abs_err": _bwd_errs(torch, got, want, dtype,
                                               f"misaligned do {shape}")})
    emit(6, name="attention_bwd_kernel", cases=cases,
         launches={k: n for k, n in _flash_launches().items() if "_bwd_" in k})


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
    _reset_launches()
    t0 = time.perf_counter()
    loss1, new1 = step.step(params, x, y)
    torch.cuda.synchronize()
    step1_s = time.perf_counter() - t0
    after_step1 = _flash_launches()
    t0 = time.perf_counter()
    loss_k, _ = step.run_steps(new1, x, y, t["steps_after_first"])
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = _flash_launches()
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
    _reset_launches()
    t0 = time.perf_counter()
    pa.flash_attention(q, k, v, causal=True).float().sum().backward()
    torch.cuda.synchronize()
    flash_s = time.perf_counter() - t0
    flash_launches = _flash_launches()
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
    lib = _build._load(_build.LIB_NAME)
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
            _reset_launches()
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
            launches = _flash_launches()
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

    n0 = _launched("srt_neighbor_pull")
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
         launches={"srt_neighbor_pull": _launched("srt_neighbor_pull") - n0})


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
    from sparkrdma_tpu_torch.ops.exchange import (
        ExchangeProgram, pack_blocks, unpack_blocks,
    )
    from sparkrdma_tpu_torch.parallel import make_mesh

    e = MESH
    mesh = make_mesh([dev] * e)
    _reset_launches()
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
            n0 = _launched("srt_neighbor_pull")
            t = time.perf_counter()
            recv, rcounts = fn(send, counts)
            torch.cuda.synchronize()
            walls[label].append(time.perf_counter() - t)
            if label == "ring" and i == 0:
                ring_launches = _launched("srt_neighbor_pull") - n0
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
    launches = {"srt_neighbor_pull": _launched("srt_neighbor_pull"),
                "srt_merge_runs": _launched("srt_merge_runs")}
    if launches["srt_neighbor_pull"] <= 0:
        raise AssertionError("srt_neighbor_pull never launched on the SPMD path")
    # a step a launch: (c) one sort and four steps; (d) 4 + 1 + 1 sorts
    if launches["srt_merge_runs"] != 11:
        raise AssertionError(f"the SPMD path launched srt_merge_runs "
                             f"{launches['srt_merge_runs']} times, not 11")
    emit(9, name="spmd_path", launches=launches, **report)
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
    lib = _build._load(_build.LIB_NAME)
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
# phases 10, 13 and 14 run the python plane, as before the native plane
# came (``transport=auto`` would now pick native), so their numbers stay
# comparable; phase 15 runs their paths over the native plane
PY_PLANE = {"tpu.shuffle.transport": "python"}
NATIVE_PLANE = {"tpu.shuffle.transport": "native"}
# phase 10 (b)'s and phase 15 (b)'s base knobs: none, the defaults (a
# rehearsal at a small KEYS shrinks collective.waveBytes so the default
# run still pipelines)
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
    conf = TpuShuffleConf({**PY_PLANE, **(knobs or {})})
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

    conf = TpuShuffleConf(PY_PLANE)
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


def _sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _hp_map_phase(torch, dev, sorter, ios, shards, edges, shuffle_id):
    """Phase 10 (b)'s map: sort, stage and publish every executor's
    shard. Returns the wall, its split (sort, stage, publish), the
    staged locations and every executor's sorted keys and cuts."""
    split = {"sort_s": 0.0, "stage_s": 0.0, "publish_s": 0.0}
    staged, sorted_keys = [], []
    _sync(torch, dev)
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
        sorted_keys.append((keys, bounds))
    _sync(torch, dev)
    return time.perf_counter() - t_map, split, staged, sorted_keys


def _hp_reduce_all(torch, dev, ios, sid, want=None, fused=False, blocks=None):
    """Every reducer ``r`` (on executor ``r``) fetches its partition and
    merges it. Returns the wall and the merged outputs; with ``want``,
    each is checked against ``np.sort`` of its range and the input's
    count, sum and xor; with ``blocks`` (a list), each reducer's fetched
    blocks' bytes are appended to it, read back after the wall."""
    from sparkrdma_tpu_torch.models.terasort import merge_blocks

    outs, fetched = [], []
    _sync(torch, dev)
    t = time.perf_counter()
    for r, io in enumerate(ios):
        got = io.fetch_device_blocks(sid, r, r + 1, dtype=np.uint32,
                                     timeout_s=600, fused=fused)
        merged, total = merge_blocks([b.array[: b.length // 4] for b in got[r]])
        if blocks is None:
            for b in got[r]:
                b.free()
        else:
            fetched.append(got[r])
        outs.append((merged, total))
    _sync(torch, dev)
    wall = time.perf_counter() - t
    for bufs in fetched:
        blocks.append(sorted(b.read(0, b.length) for b in bufs))
        for b in bufs:
            b.free()
    if want is not None:
        for r, (merged, total) in enumerate(outs):
            _check_reducer(r, merged, total, want[r])
    return wall, outs


def phase_host_plane_path(torch, dev, data):
    """Phase 10: the host plane on the card. (a) dryrun sections 4 and 5
    on ``make_mesh([dev] * 4)``, and CUDA-tensor blocks through
    ``stage_device_blocks``; (b) phase 2's 1 GiB TeraSort through a
    driver and 8 executors: map (sort, stage, publish), then every
    reducer fetches its partition through the location RPC and the
    compiled waves and merges, run "default" (default knobs) and run
    "fused_512m" (``collective.waveBytes=512m``, fused); (c) the same
    published blocks with ``deviceFetch.enabled=false``: one-sided
    READs over the python transport and host-to-device staging. Every
    run is on the python plane (phase 15 runs (b) and (c) on the native
    one). Counts from 0 just before, read just after."""
    from sparkrdma_tpu_torch.models.terasort import MapShardSorter
    from sparkrdma_tpu_torch.obs import get_registry
    from sparkrdma_tpu_torch.parallel import make_mesh
    from sparkrdma_tpu_torch.shuffle.device_io import DeviceShuffleIO
    from sparkrdma_tpu_torch.shuffle.handle import BaseShuffleHandle, HashPartitioner
    from sparkrdma_tpu_torch.shuffle.manager import TpuShuffleManager
    from sparkrdma_tpu_torch.utils.config import TpuShuffleConf

    shards, edges, want = data
    reg = get_registry()
    _reset_launches()
    report = {}

    def degrades(ids):
        return sum(reg.counter("collective.degrades", role=i).value for i in ids)

    # ---- (a) dryrun sections 4 and 5, then CUDA-tensor blocks
    l0 = _wave_launches()
    dry_ids = [f"dry-{i}" for i in range(HOST_EXECUTORS)]
    d0 = degrades(dry_ids)
    t = time.perf_counter()
    seen = host_plane_sections(make_mesh([dev] * HOST_EXECUTORS).devices)
    report["a"] = {
        "wall_s": time.perf_counter() - t, "deltas": seen["deltas"],
        "collective.degrades": degrades(dry_ids) - d0,
        "wave_launches": [x - y for x, y in zip(_wave_launches(), l0)],
        "tensor_blocks": _tensor_publish_check(torch, dev),
    }
    if report["a"]["collective.degrades"] or sum(report["a"]["wave_launches"]) <= 0:
        raise AssertionError(f"run (a): {report['a']}")

    # ---- (b) the 1 GiB TeraSort through driver, publish and fetch
    sid = 10
    conf = TpuShuffleConf({**PY_PLANE, **HOST_PLANE_KNOBS})
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
            return _hp_map_phase(torch, dev, sorter, ios, shards, edges, shuffle_id)

        map_s, split, staged_locs, _ = map_phase(sid)
        if not all(loc.block.has_device for loc in staged_locs):
            raise AssertionError("a staged block has no device coordinates")
        stage = {k: sum(io.metrics_snapshot()[k] for io in ios)
                 for k in ("stage_copy_s", "stage_checksum_s", "stage_arena_s",
                           "stage_bytes")}

        def reduce_all(fused, check):
            return _hp_reduce_all(torch, dev, ios, sid, want if check else None,
                                  fused)[0]

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
                l0 = _wave_launches()
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
                "wave_launches": [x - y for x, y in zip(_wave_launches(), l0)],
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
        warm_s, warm_split, _, _ = map_phase(sid + 1)
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
    counts = {"srt_wave_pull": _launched("srt_wave_pull"),
              "srt_pipelined_wave_pull": _launched("srt_pipelined_wave_pull")}
    emit(10, name="host_plane_path", launches=counts, **report)
    _REPORTS[10] = report
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


def _sp_counts():
    """The kernels of this phase's path and their launches since the last
    resets."""
    return {"srt_neighbor_pull": _launched("srt_neighbor_pull"), **_flash_launches()}


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
    from sparkrdma_tpu_torch.parallel import make_mesh, shard

    def reset():
        _reset_launches()

    report = {}
    total = dict.fromkeys(_sp_counts(), 0)

    def add(counts):
        for k, n in counts.items():
            total[k] += n

    # ---- (a) dryrun sections 2 and 2b
    reset()
    t = time.perf_counter()
    report["a"] = sp_dryrun_sections(torch, dev)
    torch.cuda.synchronize()
    report["a"]["wall_s"] = time.perf_counter() - t
    counts = _sp_counts()
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
            counts = _sp_counts()
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
        after1 = {k: n for k, n in _sp_counts().items() if n}
        t = time.perf_counter()
        loss_k, _ = step.run_steps(new1, x, y, t_["steps_after_first"])
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t
        counts = _sp_counts()
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
# (a2) the join at 8-byte rows: 4,194,304 x 67,108,864 tuples of uint64
# keys (i * 0x9E3779B97F4A7C15 mod 2^64, a bijection) and int64 payloads
HJW_BUILD = 1 << 22
HJW_PROBE = 1 << 26
HJW_MIX = 0x9E3779B97F4A7C15
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


def _all_counts():
    """Every kernel's launches since the last resets."""
    return {"srt_wave_pull": _launched("srt_wave_pull"),
            "srt_pipelined_wave_pull": _launched("srt_pipelined_wave_pull"),
            **_sp_counts()}


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


def _models_hashjoin_wide(torch, dev, mesh):
    """(a2) The join at 8-byte rows, uint64 keys at and above 2^63 with
    int64 payloads; exact against a lookup in the sorted build keys on
    the card."""
    from sparkrdma_tpu_torch.models import HashJoin

    t = time.perf_counter()
    rng = np.random.default_rng(37)
    bk = np.arange(1, HJW_BUILD + 1, dtype=np.uint64) * np.uint64(HJW_MIX)
    bv = rng.integers(-(1 << 62), 1 << 62, HJW_BUILD, dtype=np.int64)
    pk = bk[rng.integers(0, HJW_BUILD, HJW_PROBE)]
    pv = np.arange(HJW_PROBE, dtype=np.int64)
    gen_s = time.perf_counter() - t

    hj = HashJoin(mesh)
    out, join_s, peak = _peak_run(torch, lambda: hj.join(bk, bv, pk, pv))
    run = {"build_rows": HJW_BUILD, "probe_rows": HJW_PROBE, "data_s": gen_s,
           "join_s": join_s, "walls": hj.last_walls,
           "capacities": hj.last_capacities, "tries": len(hj.last_capacities),
           "peak_above_baseline_bytes": peak}
    got = torch.from_numpy(out).to(dev)  # the key column: the uint64 key's int64 bits
    del out
    if tuple(got.shape) != (HJW_PROBE, 3):
        raise AssertionError(f"wide join output {tuple(got.shape)}, not ({HJW_PROBE}, 3)")
    rows = got[:, 1]
    if not torch.equal(torch.sort(rows).values,
                       torch.arange(HJW_PROBE, dtype=torch.int64, device=dev)):
        raise AssertionError("wide probe values are not a permutation of arange")
    pk_dev = torch.from_numpy(pk.view(np.int64)).to(dev)
    if not torch.equal(pk_dev[rows], got[:, 0]):
        raise AssertionError("a wide joined row carries another row's probe key")
    del pk_dev, rows
    sign = -(1 << 63)  # uint64 order as int64 order: XOR the sign bit
    keys, order = torch.sort(torch.from_numpy(bk.view(np.int64)).to(dev) ^ sign)
    probe = got[:, 0].contiguous() ^ sign
    pos = torch.searchsorted(keys, probe).clamp_(max=HJW_BUILD - 1)
    if not torch.equal(keys[pos], probe):
        raise AssertionError("a wide probe key missed the build side")
    want = torch.from_numpy(bv).to(dev)[order[pos]]
    if not torch.equal(want, got[:, 2]):
        raise AssertionError("a wide joined value differs from the lookup's")
    del got, keys, order, pos, want, probe
    run["exact"] = True
    args, nb, npl = hj.place(bk, bv, pk, pv)
    fn = hj.step(nb, npl, *hj.last_capacities[-1])
    _, run["step_warm_s"] = _synced_s(torch, lambda: fn(*args))
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
    the card. The join's packs launch ``srt_radix_pack``, one a side a
    step, and PageRank's bucketing one a ``blocks`` call (two: ``run``'s
    and the warm step's); the join's probe launches ``srt_sorted_probe``
    once a step; the join at 8-byte rows (a2) launches
    ``srt_radix_pack64`` and ``srt_sorted_probe64`` in their place;
    PageRank's
    step builds its CSR once a call and launches ``srt_csr_pull`` once
    an iteration; nothing else launches a
    hand-written kernel (the exchanges are the dense all-to-all's
    transpose). Returns the pack's and the CSR kernels' launches."""
    from sparkrdma_tpu_torch.models import MapShardSorter
    from sparkrdma_tpu_torch.parallel import make_mesh

    mesh = make_mesh([dev] * SPMD_MODEL_SHARDS)
    t0 = time.perf_counter()
    _reset_launches()
    report = {"shards": SPMD_MODEL_SHARDS}
    _, report["map_sorter_warm_s"] = _synced_s(
        torch, lambda: MapShardSorter(dev).warm(KEYS // EXECUTORS, REDUCERS - 1))
    report["a_hashjoin"] = _models_hashjoin(torch, dev, mesh)
    # join()'s tries, the warm step and the profiled step: two packs and
    # one probe each
    steps = report["a_hashjoin"]["tries"] + 2
    want = 2 * steps
    if (_launched("srt_radix_pack"), _launched("srt_sorted_probe")) != (want, steps):
        raise AssertionError(
            f"the join launched srt_radix_pack {_launched('srt_radix_pack')} and "
            f"srt_sorted_probe {_launched('srt_sorted_probe')} times, not {want} and {steps}")
    report["a2_hashjoin_wide"] = _models_hashjoin_wide(torch, dev, mesh)
    # join()'s tries and the warm step: two 8-byte packs and one 8-byte
    # probe each, no 4-byte one
    wide_steps = report["a2_hashjoin_wide"]["tries"] + 1
    wide = 2 * wide_steps
    got = (_launched("srt_radix_pack64"), _launched("srt_radix_pack"),
           _launched("srt_sorted_probe64"), _launched("srt_sorted_probe"))
    if got != (wide, want, wide_steps, steps):
        raise AssertionError(
            f"the wide join launched srt_radix_pack64, srt_radix_pack, srt_sorted_probe64 "
            f"and srt_sorted_probe {got} times, not {(wide, want, wide_steps, steps)}")
    report["b_pagerank"] = _models_pagerank(torch, dev, mesh)
    by_model = {"a_hashjoin": want, "b_pagerank": _launched("srt_radix_pack") - want}
    if by_model["b_pagerank"] != 2:  # its two ``blocks`` calls, one pack each
        raise AssertionError(
            f"PageRank launched srt_radix_pack {by_model['b_pagerank']} times, not 2")
    want = _launched("srt_radix_pack")
    report["srt_radix_pack_launches"] = by_model
    # run(), the warm and the profiled job: a CSR build a call, a pull an
    # iteration, and the join launched neither
    pulls = (_launched("srt_csr_build"), _launched("srt_csr_pull"))
    if pulls != (3, 3 * PR_ITERS):
        raise AssertionError(f"PageRank made {pulls[0]} CSR builds and {pulls[1]} pulls, "
                             f"not 3 and {3 * PR_ITERS}")
    report["c_als"] = _models_als(torch, dev, mesh)
    launched = {k: n for k, n in _all_counts().items() if n}
    if (launched or _launched("srt_radix_pack") != want
            or (_launched("srt_csr_build"), _launched("srt_csr_pull")) != pulls):
        raise AssertionError(
            f"the SPMD models launched kernels: {launched}, "
            f"srt_radix_pack {_launched('srt_radix_pack')}, CSR builds and pulls "
            f"{_launched('srt_csr_build')} and {_launched('srt_csr_pull')}")
    if _launched("srt_radix_pack64") != wide:
        raise AssertionError("a model past (a2) launched srt_radix_pack64")
    if (_launched("srt_sorted_probe"), _launched("srt_sorted_probe64")) != (steps, wide_steps):
        raise AssertionError("a model past (a2) launched srt_sorted_probe or srt_sorted_probe64")
    launches = {"srt_radix_pack": _launched("srt_radix_pack"),
                "srt_radix_pack64": _launched("srt_radix_pack64"),
                "srt_sorted_probe": steps, "srt_sorted_probe64": wide_steps,
                "srt_csr_build": _launched("srt_csr_build"),
                "srt_csr_pull": _launched("srt_csr_pull")}
    emit(12, name="spmd_models", launches=launches, seconds=time.perf_counter() - t0,
         **report)
    return launches


# the join cell's pack (shufflebench join.pkfk.128m): 8 shards of
# 16,000,000 rows into 8 partitions of 4,000,000 slots, a side
RP_SHARDS = 8
RP_ROWS = 16_000_000
RP_CAP = 4_000_000
# the wide join cell's probe side (shufflebench join.pkfk.u64.256m): 8
# shards of 2^25 rows of 8-byte keys and payloads into 8 partitions of
# 2^23 slots
RP64_ROWS = 1 << 25
RP64_CAP = 1 << 23


def time_radix_pack(torch, dev, wide=False):
    """srt_radix_pack at the join cell's shape, one side (``wide``:
    srt_radix_pack64 at the wide join cell's probe side): checked bit for
    bit against the plain version, then timed as the C entry point alone
    on prebuilt outputs, the wrapper, the plain version
    (``radix_pack_pairs_reference``) and the path it replaced (per
    shard, ``radix_partition`` and two ``pack_by_partition`` calls and
    the slab copies), each by CUDA events over back-to-back calls."""
    from sparkrdma_tpu_torch.models.terasort import KEY_BITS, SENTINEL
    from sparkrdma_tpu_torch.ops import _build
    from sparkrdma_tpu_torch.ops import sort as so

    e, p = RP_SHARDS, RP_SHARDS
    n, cap = (RP64_ROWS, RP64_CAP) if wide else (RP_ROWS, RP_CAP)
    symbol = "srt_radix_pack64" if wide else "srt_radix_pack"
    bits = torch.int64 if wide else torch.int32
    key_bits, key_fill = (64, (1 << 64) - 1) if wide else (KEY_BITS, SENTINEL)
    row = 2 * (8 if wide else 4)  # a key and a payload
    g = torch.Generator(device=dev)
    g.manual_seed(4_230_000_001)
    if wide:
        keys = torch.randint(-(1 << 63), (1 << 63) - 1, (e, n), dtype=torch.int64,
                             device=dev, generator=g).view(torch.uint64)
    else:
        keys = torch.randint(-(1 << 31), 1 << 31, (e, n), dtype=torch.int64, device=dev,
                             generator=g).to(torch.int32).view(torch.uint32)
    vals = torch.arange(e * n, dtype=bits, device=dev).view(e, n)
    t = time.perf_counter()
    lib = _build._load("libsrt_radix_pack.so")
    load_s = time.perf_counter() - t
    built = _build.builds.get("libsrt_radix_pack.so")
    got = so.radix_pack_pairs(keys, vals, p, cap, key_bits, key_fill, -1)
    want = so.radix_pack_pairs_reference(keys, vals, p, cap, key_bits, key_fill, -1)
    for name, a, b in zip(("kslab", "vslab", "counts", "overflowed"), want, got):
        if not torch.equal(so._bits(a), so._bits(b)):
            raise AssertionError(f"{symbol}'s {name} differs from the plain version's")
    del want
    kslab, vslab, counts, flags = got
    scratch = torch.empty((lib.srt_radix_pack_scratch(e, n, p),), dtype=torch.int32,
                          device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    fn = getattr(lib, symbol)

    def raw():
        code = fn(
            keys.data_ptr(), vals.data_ptr(), kslab.data_ptr(), vslab.data_ptr(),
            counts.data_ptr(), flags.data_ptr(), scratch.data_ptr(), e, n, p, key_bits,
            cap, -1, -1, stream)
        if code:
            raise RuntimeError(f"{symbol} launch failed ({code})")

    def wrapper():
        return so.radix_pack_pairs(keys, vals, p, cap, key_bits, key_fill, -1)

    def plain():
        return so.radix_pack_pairs_reference(keys, vals, p, cap, key_bits, key_fill, -1)

    ks = torch.empty((e, p, cap), dtype=bits, device=dev)
    vs = torch.empty_like(ks)
    cs = torch.empty((e, p), dtype=torch.int32, device=dev)
    fs = torch.empty((e,), dtype=torch.bool, device=dev)

    def replaced():
        for i in range(e):
            dest = so.radix_partition(keys[i], p, key_bits)
            k, cs[i], fs[i] = so.pack_by_partition(keys[i], dest, p, cap, fill=key_fill)
            vs[i], _, _ = so.pack_by_partition(vals[i], dest, p, cap, fill=-1)
            ks[i] = so._bits(k)

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            raw()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    by_kernel = {k: ev.self_device_time_total / 1e3 / 10
                 for ev in prof.key_averages()
                 if getattr(ev, "device_type", None) == cuda
                 for k in ("radix_hist", "radix_scan", "radix_scatter") if k in ev.key}
    read = e * n * row  # what the pack needs: keys and payloads once
    written = e * p * cap * row  # both slabs, padding included
    hist_read = e * n * row // 2  # this design's second read of the keys
    kernel_ms = event_ms_per_call(torch, raw, 20)
    entry = {
        "name": symbol, "route": "cuda",
        "source": "sparkrdma_tpu_torch/ops/csrc/radix_pack.cu",
        "replaces": "none (the JAX pack is plain jnp: sparkrdma_tpu/ops/sort.py "
                    "radix_partition + pack_by_partition)",
        "max_abs_err": 0,
        "ms": kernel_ms,
        "plain_ms": event_ms_per_call(torch, plain, 3),
        "replaced_path_ms": event_ms_per_call(torch, replaced, 3),
        "bound_ms": (read + written) / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "bound_share": (read + written) / HBM_BYTES_PER_S * 1e3 / kernel_ms,
        "wrapper_event_ms": event_ms_per_call(torch, wrapper, 20),
        "kernel_profiler_ms": device_ms_per_call(torch, raw, 10),
        "by_kernel_profiler_ms": by_kernel,
        "kernel_gbps": (read + written) / (kernel_ms / 1e3) / 1e9,
        "design_bound_ms": (read + hist_read + written) / HBM_BYTES_PER_S * 1e3,
        "build_s": built[0] if built else None, "load_s": load_s,
        "ptxas": [ln.strip() for ln in (built[1] if built else "").splitlines()
                  if "registers" in ln or "spill" in ln or "smem" in ln],
        "timer": "cuda_events",
        "shape": {"shards": e, "rows_a_shard": n, "partitions": p, "capacity": cap,
                  "read_bytes": read, "hist_read_bytes": hist_read,
                  "written_bytes": written,
                  "overflowed": bool(flags.any())},
    }
    emit("timing_radix_pack64" if wide else "timing_radix_pack", kernels=[entry])
    return entry


# the PageRank cell's pull (shufflebench pagerank.g500-s26): the Graph500
# toy graph, SCALE 26 (2^30 Kronecker edges), on 8 shards of 2^23
# vertices, blocks of the mean block plus 6%
CP_SCALE = 26
CP_EDGEFACTOR = 16
CP_SHARDS = 8
CP_HEADROOM = 0.06
CP_INITIATOR = (0.57, 0.19, 0.19, 0.05)
CP_SEED = 4_250_000_123


def kronecker_edges(torch, scale, edgefactor, initiator, seed, dev):
    """The Graph500 Kronecker edge list (graph500.org specification,
    section 3): ``edgefactor * 2^scale`` edges, ``[m, 2]`` int32 rows
    ``(start, end)`` on ``dev``, drawn from ``seed``. At each of
    ``scale`` levels every edge sets one bit of its start, 1 with
    probability C + D of the initiator (A, B, C, D), and one of its end,
    then 1 with probability D / (C + D), else B / (A + B). The vertex
    labels are then permuted. Self-loops and duplicates are kept; the
    spec's shuffle of the edges is left out, as each edge is drawn on
    its own. The smoke and the card tests draw their graphs here, so
    that what they time and check does not follow the benchmark's
    generator."""
    n, m = 1 << scale, edgefactor << scale
    a, b, c, d = initiator
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    ends = [torch.zeros((m,), dtype=torch.int32, device=dev) for _ in range(2)]
    u = torch.empty((m,), dtype=torch.float32, device=dev)
    for level in range(scale):
        u.uniform_(generator=g)
        start_bit = u > a + b
        u.uniform_(generator=g)
        end_bit = torch.where(start_bit, u > c / (c + d), u > a / (a + b))
        for col, bit in zip(ends, (start_bit, end_bit)):
            col.bitwise_or_(bit.to(torch.int32).bitwise_left_shift_(level))
        del start_bit, end_bit
    del u
    label = torch.randperm(n, generator=g, device=dev).to(torch.int32)
    return torch.stack([torch.index_select(label, 0, col) for col in ends], 1)


def check_csr_build(torch, csr, packed, n_local, graph, whole):
    """Holds ``srt_csr_build``'s ``graph`` of ``packed`` against
    ``csr_build_reference``, built on its own a block at a time (the
    plain CSR of one ``[1, 1, cap, 2]`` block; its sources are the
    block's local ones): every row's offsets equal, every row's sources
    the same multiset (the kernel places a row's edges in the order its
    atomics run). Then ``csr_pull(whole, graph)`` against the plain pull
    over the plain blocks; ``whole`` holds integers, so every sum is
    exact in any order. Raises on any difference; returns the edges."""
    e, dev = packed.shape[0], packed.device
    y = csr.csr_pull(whole, graph)
    done = 0
    for b in range(e * e):
        s, d = divmod(b, e)
        ref = csr.csr_build_reference(packed[s, d][None, None], n_local)
        edges = int(ref.offsets[-1])
        lo = b * n_local
        if not torch.equal(graph.offsets[lo:lo + n_local + 1].to(torch.int64) - done,
                           ref.offsets.to(torch.int64)):
            raise AssertionError(f"srt_csr_build's offsets of block {b} differ "
                                 "from the plain version's")
        row = torch.repeat_interleave(torch.arange(n_local, device=dev),
                                      ref.offsets.diff().to(torch.int64)) * n_local
        got = graph.src[done:done + edges].to(torch.int64) - s * n_local
        if not torch.equal(torch.sort(row + got).values,
                           torch.sort(row + ref.src.to(torch.int64)).values):
            raise AssertionError(f"srt_csr_build's sources of block {b} differ "
                                 "from the plain version's")
        want = csr.csr_pull_reference(whole[s * n_local:(s + 1) * n_local],
                                      ref.offsets, ref.src)
        if not torch.equal(y[lo:lo + n_local], want):
            raise AssertionError(f"srt_csr_pull differs from the plain version in block {b}")
        done += edges
    if int(graph.offsets[-1]) != done:
        raise AssertionError("srt_csr_build's edge count differs from the plain version's")
    return done


def time_csr_pull(torch, dev):
    """srt_csr_pull at the PageRank cell's shapes: the build once, held
    block by block against its plain version (``check_csr_build``), and
    the pull, checked there bit for bit on integer out-contributions
    (exact in any order), timed by CUDA events beside its byte bound, the
    plain version (``csr_pull_reference``), the library's CSR SpMV over
    the same CSR (cuSPARSE through ``torch.sparse``) and the pair it
    replaced (``index_select`` of every padded slot's out-contribution,
    ``index_add_`` into the zeroed contributions)."""
    from sparkrdma_tpu_torch.models import PageRank
    from sparkrdma_tpu_torch.ops import _build
    from sparkrdma_tpu_torch.ops import csr
    from sparkrdma_tpu_torch.parallel import make_mesh

    e, n = CP_SHARDS, 1 << CP_SCALE
    edges = kronecker_edges(torch, CP_SCALE, CP_EDGEFACTOR, CP_INITIATOR, CP_SEED, dev)
    m = edges.shape[0]
    pr = PageRank(make_mesh([dev] * e))
    capacity = math.ceil(m / e ** 2 * (1 + CP_HEADROOM))
    packed, _, n_local = pr.blocks(edges, n, capacity)
    del edges
    t = time.perf_counter()
    lib = _build._load("libsrt_csr_pull.so")
    load_s = time.perf_counter() - t
    built = _build.builds.get("libsrt_csr_pull.so")
    rows, sources = e * e * n_local, e * n_local
    build_ms = event_ms_per_call(torch, lambda: csr.csr_build(packed, n_local), 3)
    g = csr.csr_build(packed, n_local)
    gen = torch.Generator(device=dev)
    gen.manual_seed(CP_SEED + 1)
    whole = torch.randint(0, 4, (sources,), device=dev, generator=gen).float()
    edges_n = check_csr_build(torch, csr, packed, n_local, g, whole)
    # the library's CSR SpMV over the same rows, its values (ones) set up untimed
    spmv = torch.sparse_csr_tensor(
        g.offsets, g.src[:edges_n], torch.ones((edges_n,), device=dev),
        size=(rows, sources), check_invariants=False)
    library_exact = torch.equal(torch.mv(spmv, whole), csr.csr_pull(whole, g))
    del whole
    outc = torch.rand((sources,), device=dev, generator=gen)
    y = torch.empty((rows,), dtype=torch.float32, device=dev)
    tiles = g.coords.shape[0] - 1
    carry = torch.empty((tiles,), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream().cuda_stream

    def raw():
        code = lib.srt_csr_pull(outc.data_ptr(), g.offsets.data_ptr(), g.src.data_ptr(),
                                g.coords.data_ptr(), carry.data_ptr(), y.data_ptr(), rows,
                                tiles, 0, stream)
        if code:
            raise RuntimeError(f"srt_csr_pull launch failed ({code})")

    kernel_ms = event_ms_per_call(torch, raw, 20)
    profiler_ms = device_ms_per_call(torch, raw, 10)
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            raw()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    by_kernel = {k: ev.self_device_time_total / 1e3 / 10
                 for ev in prof.key_averages()
                 if getattr(ev, "device_type", None) == cuda
                 for k in ("csr_pull", "csr_carry") if k in ev.key}
    plain_ms = event_ms_per_call(
        torch, lambda: csr.csr_pull_reference(outc, g.offsets, g.src), 3)
    library_ms = event_ms_per_call(torch, lambda: torch.mv(spmv, outc), 10)
    library_profiler_ms = device_ms_per_call(torch, lambda: torch.mv(spmv, outc), 5)
    del spmv
    # the replaced pair, over every padded slot as the step had it
    shard = torch.arange(e, dtype=torch.int32, device=dev)
    s_loc, d_loc = packed[..., 0], packed[..., 1]
    src_at = torch.where(s_loc >= 0, s_loc + (shard * n_local)[:, None, None],
                         sources).view(-1)
    spread = torch.arange(packed.shape[2], dtype=torch.int32, device=dev) % n_local
    dst_at = (torch.where(d_loc >= 0, d_loc, spread)
              + ((shard[:, None] * e + shard[None, :]) * n_local)[:, :, None]).view(-1)
    padded = torch.cat([outc, outc.new_zeros(1)])

    def replaced():
        vals = torch.index_select(padded, 0, src_at)
        return torch.zeros((rows,), dtype=torch.float32, device=dev).index_add_(
            0, dst_at, vals)

    replaced_ms = event_ms_per_call(torch, replaced, 3)
    del src_at, dst_at, padded
    longest = int((g.offsets[1:] - g.offsets[:-1]).max())
    # what a pull needs: each edge's source and each row's offset read
    # once, each row written once, each out-contribution read once
    need = 4 * edges_n + g.offsets.element_size() * (rows + 1) + 4 * rows + 4 * sources
    entry = {
        "name": "srt_csr_pull", "route": "cuda",
        "source": "sparkrdma_tpu_torch/ops/csrc/csr_pull.cu",
        "replaces": "none (the JAX scatter is plain jnp: sparkrdma_tpu/models/pagerank.py:100 "
                    "jnp.zeros(...).at[d_idx].add(...))",
        "max_abs_err": 0,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "replaced_path_ms": replaced_ms,
        "library_ms": library_ms, "library_profiler_ms": library_profiler_ms,
        "library": "torch.mv on a sparse CSR tensor (cuSPARSE SpMV), int32 indices",
        "library_exact": library_exact, "build_checked": True,
        "bound_ms": need / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "bound_share": need / HBM_BYTES_PER_S * 1e3 / kernel_ms,
        "kernel_profiler_ms": profiler_ms,
        "by_kernel_profiler_ms": by_kernel,
        "build_ms": build_ms,
        "l2_sectors_gathered": edges_n, "l2_gather_bytes": 32 * edges_n,
        "build_s": built[0] if built else None, "load_s": load_s,
        "ptxas": [ln.strip() for ln in (built[1] if built else "").splitlines()
                  if "registers" in ln or "spill" in ln or "smem" in ln],
        "timer": "cuda_events",
        "shape": {"shards": e, "n_local": n_local, "rows": rows, "edges": edges_n,
                  "longest_row": longest,
                  "capacity": packed.shape[2], "tiles": tiles, "need_bytes": need},
    }
    emit("timing_csr_pull", kernels=[entry])
    return entry


# the sort cell's merge (shufflebench sort.u32.spmd): 8 shards, each
# receiving 8 sorted runs of capacity 2^23 with about 2^22 keys each
MR_SHARDS = 8
MR_CAP = 1 << 23
MR_SEED = 4_270_000_777


def time_merge_runs(torch, dev):
    """srt_merge_runs at the sort cell's merge: checked bit for bit
    against its plain version (``merge_sorted_runs_reference``, the
    parent's ``merge_received`` shard by shard), then timed by CUDA
    events, the slab restored before each call (it is the kernel's
    scratch), beside its byte bound, the plain version, the one PyTorch
    call it replaces (``torch.sort`` of the same masked slab, ordered as
    int32, all shards in one call) and the replaced path (the mask and
    sort of each shard and its copy into ``merged``)."""
    from sparkrdma_tpu_torch.models.terasort import SENTINEL
    from sparkrdma_tpu_torch.ops import _build
    from sparkrdma_tpu_torch.ops import sort as so

    e = r = MR_SHARDS
    cap = MR_CAP
    g = torch.Generator(device=dev)
    g.manual_seed(MR_SEED)
    counts = (cap // 2 + torch.randint(-(cap >> 6), (cap >> 6) + 1, (e, r), device=dev,
                                       generator=g)).to(torch.int32)
    # shard i's keys in key range i, as the cell's static split sends them
    keys = torch.randint(0, 1 << 29, (e, r, cap), device=dev, generator=g)
    keys += (torch.arange(e, device=dev) << 29).view(e, 1, 1)
    valid = torch.arange(cap, device=dev) < counts.unsqueeze(-1)
    keys = torch.sort(torch.where(valid, keys, SENTINEL), dim=-1).values
    keys = torch.where(valid, keys, 0)  # no sentinel padding: the kernel reads counts
    pristine = (keys - (keys >= 1 << 31).to(torch.int64) * (1 << 32)).to(torch.int32)
    del keys, valid
    pristine = pristine.view(torch.uint32).contiguous()
    slab = pristine.clone()
    t = time.perf_counter()
    lib = _build._load("libsrt_merge_runs.so")
    load_s = time.perf_counter() - t
    built = _build.builds.get("libsrt_merge_runs.so")
    want = so.merge_sorted_runs_reference(pristine, counts, SENTINEL)
    got = so.merge_sorted_runs(slab, counts, SENTINEL)
    for name, a, b in zip(("merged", "totals"), want, got):
        if not torch.equal(a, b):
            raise AssertionError(f"srt_merge_runs's {name} differs from the plain version's")
    del want
    merged, totals = got
    scratch = torch.empty((lib.srt_merge_runs_scratch(e, r, cap),), dtype=torch.int32,
                          device=dev)
    stream = torch.cuda.current_stream().cuda_stream

    def raw():
        code = lib.srt_merge_runs(slab.data_ptr(), counts.data_ptr(), merged.data_ptr(),
                                  totals.data_ptr(), scratch.data_ptr(), e, r, cap,
                                  SENTINEL, stream)
        if code:
            raise RuntimeError(f"srt_merge_runs launch failed ({code})")

    def restored_ms(fn, n):
        """CUDA-event ms a call of ``fn`` on a freshly restored slab."""
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        total = 0.0
        for i in range(n + 1):
            slab.copy_(pristine)
            a.record()
            fn()
            b.record()
            b.synchronize()
            if i:  # the first call warms up
                total += a.elapsed_time(b)
        return total / n

    def plain():
        return so.merge_sorted_runs_reference(pristine, counts, SENTINEL)

    col = torch.arange(cap, dtype=torch.int32, device=dev)
    masked = torch.where(col < counts.unsqueeze(-1), pristine.view(torch.int32),
                         -1).view(e, r * cap) ^ (-(1 << 31))
    out = torch.empty((e, r * cap), dtype=torch.int32, device=dev)
    out_totals = torch.empty((e,), dtype=torch.int32, device=dev)

    def library():
        return torch.sort(masked, dim=-1)

    def replaced():
        for i in range(e):
            m, out_totals[i] = so.merge_received(pristine[i], counts[i], SENTINEL)
            out[i] = m.view(torch.int32)

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            slab.copy_(pristine)
            raw()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    by_kernel = {k: ev.self_device_time_total / 1e3 / 5
                 for ev in prof.key_averages()
                 if getattr(ev, "device_type", None) == cuda
                 for k in ("run_prefix", "merge_partition", "merge_tile") if k in ev.key}
    total_keys = int(counts.sum())
    read = total_keys * 4  # what the merge needs: the valid keys once
    written = e * r * cap * 4  # merged, the sentinel tail included
    passes = 3  # log2(8) pairwise passes, each reading and writing the valid keys
    design = passes * 2 * read + (written - read)
    kernel_ms = restored_ms(raw, 20)
    entry = {
        "name": "srt_merge_runs", "route": "cuda",
        "source": "sparkrdma_tpu_torch/ops/csrc/merge_runs.cu",
        "replaces": "none (the JAX merge is plain jnp: sparkrdma_tpu/ops/sort.py "
                    "merge_received)",
        "max_abs_err": 0,
        "ms": kernel_ms,
        "plain_ms": event_ms_per_call(torch, plain, 3),
        "library_ms": event_ms_per_call(torch, library, 5),
        "library": "torch.sort of the masked [8, 2^26] int32 slab along the last axis",
        "replaced_path_ms": event_ms_per_call(torch, replaced, 3),
        "bound_ms": (read + written) / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "bound_share": (read + written) / HBM_BYTES_PER_S * 1e3 / kernel_ms,
        "design_bound_ms": design / HBM_BYTES_PER_S * 1e3,
        "design_bound_share": design / HBM_BYTES_PER_S * 1e3 / kernel_ms,
        "wrapper_event_ms": restored_ms(
            lambda: so.merge_sorted_runs(slab, counts, SENTINEL), 10),
        "by_kernel_profiler_ms": by_kernel,
        "kernel_gbps": (read + written) / (kernel_ms / 1e3) / 1e9,
        "build_s": built[0] if built else None, "load_s": load_s,
        "ptxas": [ln.strip() for ln in (built[1] if built else "").splitlines()
                  if "registers" in ln or "spill" in ln or "smem" in ln],
        "timer": "cuda_events",
        "shape": {"shards": e, "runs": r, "capacity": cap, "valid_keys": total_keys,
                  "read_bytes": read, "written_bytes": written, "design_bytes": design},
    }
    emit("timing_merge_runs", kernels=[entry])
    return entry


# the join cells' probes: 8 shards, [8, 8, 4,000,000] probe slots into
# build rows of 32,000,000 slots at 4-byte rows (shufflebench
# join.pkfk.128m), [8, 8, 2^23] into rows of 2^22 at 8-byte rows
# (join.pkfk.u64.256m); the counts near half of each capacity
SP_SHARDS = 8
SP_SHAPES = {False: (32_000_000, 4_000_000), True: (1 << 22, 1 << 23)}
SP_SEED = 4_300_000_001


def _probe_inputs(torch, dev, wide, kind="uniform"):
    """What ``hashjoin.build_sort`` leaves and a probe slab at a join
    cell's probe shape: uniform keys whose top 3 bits are the shard, as
    the join partitions them; 15 of 16 valid probe keys from the shard's
    build keys. ``kind`` ``one_bucket``: every build key in a range of
    4,096 but 0 and the largest key below the maximum, so that one
    directory bucket holds all but two; ``empty``: no valid build key in
    any shard."""
    from sparkrdma_tpu_torch.ops import sort as so

    e = SP_SHARDS
    m, cap_p = SP_SHAPES[wide]
    cap_b = m // e
    bits = 64 if wide else 32
    bit_dtype, key_dtype = (torch.int64, torch.uint64) if wide else (torch.int32, torch.uint32)
    g = torch.Generator(device=dev)
    g.manual_seed(SP_SEED + wide)
    bcnt = (cap_b // 2 + torch.randint(-(cap_b >> 6), (cap_b >> 6) + 1, (e, e), device=dev,
                                       generator=g)).to(torch.int32)
    if kind == "empty":
        bcnt.zero_()
    if kind == "one_bucket":
        keys = torch.randint(0, 4096, (e, m), device=dev, generator=g) + (1 << (bits - 2))
        keys[:, 0], keys[:, 1] = 0, (1 << bits) - 2 if not wide else -2
    else:
        keys = torch.randint(0, 1 << 61, (e, m), device=dev, generator=g)
        keys &= (1 << (bits - 3)) - 1
        keys |= torch.arange(e, device=dev).view(e, 1) << (bits - 3)
    if not wide:
        keys = (keys - ((keys >> 31) << 32)).to(torch.int32)
    valid = (torch.arange(cap_b, device=dev) < bcnt.unsqueeze(-1)).view(e, m)
    masked = torch.where(valid, keys, -1).view(key_dtype)
    del keys, valid
    order = so.device_argsort(masked)
    bkeys_s = torch.gather(masked.view(bit_dtype), 1, order)
    del masked
    bvals_s = torch.gather(torch.arange(e * m, dtype=bit_dtype, device=dev).view(e, m), 1,
                           order)
    del order
    pcnt = (cap_p // 2 + torch.randint(-(cap_p >> 6), (cap_p >> 6) + 1, (e, e), device=dev,
                                       generator=g)).to(torch.int32)
    n = bcnt.to(torch.int64).sum(1, keepdim=True).clamp_(min=1)
    at = (torch.rand((e, e * cap_p), device=dev, generator=g, dtype=torch.float64) * n
          ).to(torch.int64)
    pkeys = torch.gather(bkeys_s, 1, at)
    del at
    noise = torch.rand((e, e * cap_p), device=dev, generator=g) < 1 / 16
    pkeys = torch.where(noise, pkeys ^ 1, pkeys)
    del noise
    return (bkeys_s.view(key_dtype), bvals_s, bcnt, pkeys.view(e, e, cap_p).view(key_dtype),
            pcnt)


def time_sorted_probe(torch, dev, wide=False):
    """srt_sorted_probe at the join cell's probe (``wide``:
    srt_sorted_probe64 at the wide join cell's): checked bit for bit
    against the plain version, then timed as the C entry point alone on
    prebuilt outputs, the wrapper, the plain version
    (``probe_sorted_reference``: the composition it replaced) and
    ``torch.searchsorted`` of the ordered keys alone, each by CUDA events
    over back-to-back calls, beside the bytes the probe needs. Then the
    kernel again, checked and timed, with every build key but two in one
    directory bucket and with every shard empty (``_probe_inputs``'
    ``one_bucket`` and ``empty``), its two kernels apart by the
    profiler."""
    from sparkrdma_tpu_torch.ops import _build
    from sparkrdma_tpu_torch.ops import sort as so

    e = SP_SHARDS
    m, cap_p = SP_SHAPES[wide]
    symbol = "srt_sorted_probe64" if wide else "srt_sorted_probe"
    width = 8 if wide else 4
    t = time.perf_counter()
    lib = _build._load("libsrt_sorted_probe.so")
    load_s = time.perf_counter() - t
    built = _build.builds.get("libsrt_sorted_probe.so")
    args = _probe_inputs(torch, dev, wide)
    bkeys_s, bvals_s, bcnt, pkeys, pcnt = args
    got, stats = so.probe_sorted(*args, -1)
    if not torch.equal(got, so.probe_sorted_reference(*args, -1)[0]):
        raise AssertionError(f"{symbol}'s joined differs from the plain version's")
    probes, steps = (int(x) for x in stats.sum(0).tolist())
    valid_probes = int(pcnt.to(torch.int64).clamp(0, cap_p).sum())
    if probes != valid_probes:
        raise AssertionError(f"{symbol} counted {probes} probes, not {valid_probes}")
    hits = int((got != -1).sum())
    scratch = torch.empty((lib.srt_sorted_probe_scratch(e, m),), dtype=torch.int32,
                          device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    fn = getattr(lib, symbol)

    def raw():
        code = fn(bkeys_s.data_ptr(), bvals_s.data_ptr(), bcnt.data_ptr(), pkeys.data_ptr(),
                  pcnt.data_ptr(), got.data_ptr(), stats.data_ptr(), scratch.data_ptr(), e, m,
                  cap_p, -1, stream)
        if code:
            raise RuntimeError(f"{symbol} launch failed ({code})")

    ordered_b = so._ordered(bkeys_s).contiguous()
    ordered_p = so._ordered(pkeys.view(e, -1)).contiguous()

    def library():
        return torch.searchsorted(ordered_b, ordered_p, out_int32=True)

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            raw()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    by_kernel = {k: ev.self_device_time_total / 1e3 / 10
                 for ev in prof.key_averages()
                 if getattr(ev, "device_type", None) == cuda
                 for k in ("probe_directory", "probe_search") if k in ev.key}
    n_valid = int(bcnt.to(torch.int64).clamp(min=0).sum())
    read = valid_probes * width + n_valid * 2 * width  # probe keys, build keys and payloads
    written = e * e * cap_p * width  # joined
    kernel_ms = event_ms_per_call(torch, raw, 20)
    bound_ms = (read + written) / HBM_BYTES_PER_S * 1e3
    entry = {
        "name": symbol, "route": "cuda",
        "source": "sparkrdma_tpu_torch/ops/csrc/sorted_probe.cu",
        "replaces": "none (the JAX join's search is plain jnp: sparkrdma_tpu/models/"
                    "hashjoin.py, jnp.searchsorted)",
        "max_abs_err": 0,
        "ms": kernel_ms,
        "plain_ms": event_ms_per_call(torch, lambda: so.probe_sorted_reference(*args, -1), 3),
        "library_ms": event_ms_per_call(torch, library, 5),
        "library": f"torch.searchsorted of the ordered [8, {e * cap_p}] probe keys in the "
                   f"[8, {m}] build rows alone",
        "bound_ms": bound_ms, "bound_by": "bytes", "bound_share": bound_ms / kernel_ms,
        "wrapper_event_ms": event_ms_per_call(
            torch, lambda: so.probe_sorted(*args, -1), 20),
        "kernel_profiler_ms": device_ms_per_call(torch, raw, 10),
        "by_kernel_profiler_ms": by_kernel,
        "kernel_gbps": (read + written) / (kernel_ms / 1e3) / 1e9,
        "build_s": built[0] if built else None, "load_s": load_s,
        "ptxas": [ln.strip() for ln in (built[1] if built else "").splitlines()
                  if "registers" in ln or "spill" in ln or "smem" in ln],
        "timer": "cuda_events",
        "shape": {"shards": e, "build_slots": m, "probe_cap": cap_p, "valid_build": n_valid,
                  "valid_probes": valid_probes, "hits": hits, "search_steps": steps,
                  "read_bytes": read, "written_bytes": written},
    }
    del ordered_b, ordered_p, args, bkeys_s, bvals_s, pkeys, got, scratch
    entry["skew"] = {kind: _time_probe_skew(torch, dev, so, wide, kind)
                     for kind in ("one_bucket", "empty")}
    emit("timing_sorted_probe64" if wide else "timing_sorted_probe", kernels=[entry])
    return entry


def _time_probe_skew(torch, dev, so, wide, kind):
    """probe_sorted on ``_probe_inputs(..., kind)``: checked bit for bit
    against the plain version, then timed by CUDA events and, kernel by
    kernel, by the profiler."""
    from torch.profiler import ProfilerActivity, profile

    args = _probe_inputs(torch, dev, wide, kind)
    got, stats = so.probe_sorted(*args, -1)
    if not torch.equal(got, so.probe_sorted_reference(*args, -1)[0]):
        raise AssertionError(f"the probe's joined differs from the plain version's ({kind})")
    del got
    probes, steps = (int(x) for x in stats.sum(0).tolist())
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            so.probe_sorted(*args, -1)
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    return {"ms": event_ms_per_call(torch, lambda: so.probe_sorted(*args, -1), 10),
            "by_kernel_profiler_ms": {
                k: ev.self_device_time_total / 1e3 / 10 for ev in prof.key_averages()
                if getattr(ev, "device_type", None) == cuda
                for k in ("probe_directory", "probe_search") if k in ev.key},
            "valid_probes": probes, "search_steps": steps}


DP_RECORDS = 3_200_000  # HiBench TeraSort "small" (hibench.terasort.small.datasize)
# run (b), cut to a tenth: the chunked-agg writer pickles each record
# (~50 us a 13-field record on one core against ~14 us columnar), so at
# full size (b) alone would outlast the phase's 120 s budget
DP_PUSH_RECORDS = 320_000
DP_FAULT_RECORDS = 320_000  # run (d): a tenth
DP_WORDS = 12  # payload words: with the uint32 key, HiBench's 100-byte record
DP_EXECUTORS = 4
DP_MAPS = 8  # two an executor
DP_REDUCERS = 8  # two an executor
DP_SEED = 13
DP_EDGES = [(r << 32) // DP_REDUCERS for r in range(1, DP_REDUCERS)]
DP_FAULT_SEED = 3
DP_KNOBS = {}


def dp_fault_spec(ports):
    """Run (d)'s fault plan: tests/test_fault_injection.py's transient
    READ fault and its corruption, one a source executor (``peer=`` its
    port, three ports): two failed READs, then a corrupted one. Spread
    so, no reader's circuit to a source sees the three consecutive
    failures that open it (``resilience.circuitFailureThreshold``) and
    fail the job fast."""
    kinds = ("fail", "fail", "corrupt")
    return ";".join(f"read:{k}:1:peer={p}" for k, p in zip(kinds, ports))


def _dp_records(keys):
    """One map task's records, made lazily from its key slice: the key
    and word j = key * (j + 1) mod 2^64, all numpy scalars."""
    words = keys.astype(np.uint64)[:, None] * np.arange(1, DP_WORDS + 1, dtype=np.uint64)
    return zip(keys, *words.T)


def _dp_expected(keys):
    """Each reducer's keys, sorted: the RangePartitioner's rule (keys at
    most bounds[i] go to partition i) applied with ``np.searchsorted``."""
    part = np.searchsorted(np.asarray(DP_EDGES, np.uint64), keys, side="left")
    return [np.sort(keys[part == r]) for r in range(DP_REDUCERS)]


def _dp_check_rows(r, rows, want_r, what):
    """A reducer's rows against its key range: count, key multiset and
    order, and every payload word. Returns the rows sorted by key."""
    keys = rows[:, 0]
    if len(keys) != len(want_r):
        raise AssertionError(f"{what} reducer {r}: {len(keys)} records, "
                             f"{len(want_r)} expected")
    order = np.argsort(keys, kind="stable")
    rows = rows[order]
    if not np.array_equal(rows[:, 0], want_r):
        raise AssertionError(f"{what} reducer {r}: keys differ from np.sort of its range")
    mult = np.arange(1, DP_WORDS + 1, dtype=np.uint64)
    if not np.array_equal(rows[:, 1:], rows[:, :1] * mult):
        raise AssertionError(f"{what} reducer {r}: a payload word differs from its key's")
    return rows


def _dp_cluster(method, prefix, knobs=None):
    from sparkrdma_tpu_torch.shuffle.manager import TpuShuffleManager
    from sparkrdma_tpu_torch.utils.config import TpuShuffleConf

    conf = TpuShuffleConf({"tpu.shuffle.shuffleWriteMethod": method,
                           **PY_PLANE, **DP_KNOBS, **(knobs or {})})
    driver = TpuShuffleManager(conf, is_driver=True)
    execs = [TpuShuffleManager(conf, is_driver=False, executor_id=f"{prefix}-{e}")
             for e in range(DP_EXECUTORS)]
    return driver, execs


def _dp_stop(driver, execs):
    for ex in execs:
        ex.stop()
    driver.stop()


def _dp_pool_bytes(execs):
    """Registered bytes the executors' buffer pools have allocated (a
    pool keeps what it allocated, so this is its peak)."""
    return sum(size * n for ex in execs for size, n in ex.buffer_manager.stats().items())


def _dp_shuffle(driver, execs, sid, keys, want, what):
    """Map (8 tasks on the executors' map pools), finalize, then 8
    reducers each reading one partition through ``get_reader``. Returns
    the report and every reducer's rows sorted by key."""
    import itertools
    from concurrent.futures import ThreadPoolExecutor

    from sparkrdma_tpu_torch.shuffle.handle import BaseShuffleHandle, RangePartitioner

    handle = BaseShuffleHandle(shuffle_id=sid, num_maps=DP_MAPS,
                               partitioner=RangePartitioner(DP_EDGES))
    driver.register_shuffle(handle)
    per = len(keys) // DP_MAPS
    per_exec = DP_MAPS // DP_EXECUTORS

    def map_task(m):
        ex = execs[m // per_exec]
        t = time.perf_counter()
        w = ex.get_writer(handle, m)
        w.write(_dp_records(keys[m * per:(m + 1) * per]))
        t1 = time.perf_counter()
        status = w.stop(True)
        if status is None or sum(status.partition_lengths) <= 0:
            raise AssertionError(f"{what} map {m}: no output")
        return t1 - t, time.perf_counter() - t1, sum(status.partition_lengths)

    t = time.perf_counter()
    futs = [execs[m // per_exec].map_pool.submit(map_task, m) for m in range(DP_MAPS)]
    splits = [f.result() for f in futs]
    map_s = time.perf_counter() - t
    t = time.perf_counter()
    for ex in execs:
        ex.finalize_maps(sid)
    finalize_s = time.perf_counter() - t
    pool_after_map = _dp_pool_bytes(execs)

    def reduce_task(r):
        reader = execs[r // (DP_REDUCERS // DP_EXECUTORS)].get_reader(handle, r, r + 1)
        flat = np.fromiter(itertools.chain.from_iterable(reader.read()), dtype=np.uint64)
        rows = _dp_check_rows(r, flat.reshape(-1, DP_WORDS + 1), want[r], what)
        return rows, reader.metrics

    t = time.perf_counter()
    with ThreadPoolExecutor(DP_REDUCERS) as pool:
        out = list(pool.map(reduce_task, range(DP_REDUCERS)))
    reduce_s = time.perf_counter() - t
    metrics = [m for _, m in out]
    logical = len(keys) * (4 + 8 * DP_WORDS)
    report = {
        "records": len(keys), "logical_bytes": logical,
        "map_s": map_s, "finalize_maps_s": finalize_s, "reduce_s": reduce_s,
        "logical_gbps": logical / (map_s + finalize_s + reduce_s) / 1e9,
        "map_task_busy_s": {"write": sum(s[0] for s in splits),
                            "stop": sum(s[1] for s in splits)},
        # registered with the executors' protection domains: the
        # wrapper's mapped sort files, the chunked-agg writer's blocks
        "map_output_bytes": sum(s[2] for s in splits),
        "bytes_read_remote": sum(m.remote_bytes for m in metrics),
        "bytes_local": sum(m.local_bytes for m in metrics),
        "local_blocks": sum(m.local_blocks for m in metrics),
        "remote_blocks": sum(m.remote_blocks for m in metrics),
        "merged_blocks": sum(m.merged_blocks for m in metrics),
        "records_read": sum(m.records_read for m in metrics),
        "pool_bytes_peak": max(pool_after_map, _dp_pool_bytes(execs)),
    }
    return report, handle, [rows for rows, _ in out]


def _dp_device_consumer(torch, dev, execs, handle, want):
    """(c) Every reducer takes its fetched stream from the fetcher, frames
    it, and sends every columnar frame's columns to the card; the key
    columns are concatenated and sorted there. One frame a reducer also
    goes through ``sort_columnar_partition``."""
    from sparkrdma_tpu_torch.engine.serializer import iter_compressed_blocks
    from sparkrdma_tpu_torch.models.terasort import MapShardSorter
    from sparkrdma_tpu_torch.ops.sort import device_put_columns, device_sort
    from sparkrdma_tpu_torch.shuffle import columnar
    from sparkrdma_tpu_torch.shuffle.fetcher import TpuShuffleFetcherIterator

    sorter = MapShardSorter(dev)
    edges = np.asarray(DP_EDGES, np.uint32)
    mult = torch.arange(1, DP_WORDS + 1, dtype=torch.int64, device=dev)
    run = {"h2d_bytes": 0, "frames": 0, "device_s": 0.0, "columnar_sorts": 0}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    for r in range(DP_REDUCERS):
        ex = execs[r // (DP_REDUCERS // DP_EXECUTORS)]
        it = TpuShuffleFetcherIterator(ex, handle, r, r + 1)
        key_cols, first = [], None
        try:
            for _pid, stream in it:
                try:
                    for block in iter_compressed_blocks(stream, ex.resolver.codec):
                        if not columnar.is_columnar(block):
                            raise AssertionError(f"reducer {r}: a pickle frame in a "
                                                 "columnar partition")
                        t = time.perf_counter()
                        cols = device_put_columns(block, dev)
                        torch.cuda.synchronize()
                        run["device_s"] += time.perf_counter() - t
                        run["h2d_bytes"] += sum(c.numel() * c.element_size() for c in cols)
                        run["frames"] += 1
                        k64 = cols[0].view(torch.int32).to(torch.int64) & 0xFFFFFFFF
                        words = torch.stack([c.view(torch.int64) for c in cols[1:]], 1)
                        if not torch.equal(words, k64[:, None] * mult):
                            raise AssertionError(f"reducer {r}: a payload word on the "
                                                 "card differs from its key's")
                        key_cols.append(cols[0])
                        if first is None:
                            first = sorter.sort_columnar_partition(block, edges)
                            plain = sorter.sort_partition(
                                np.array(columnar.decode_columns(block)[0]), edges)
                            if not all(np.array_equal(a, b) for a, b in zip(first, plain)):
                                raise AssertionError(f"reducer {r}: sort_columnar_partition "
                                                     "differs from sort_partition")
                            run["columnar_sorts"] += 1
                finally:
                    stream.close()
        finally:
            it.close()
        t = time.perf_counter()
        merged = device_sort(torch.cat([k.view(torch.int32) for k in key_cols])
                             .view(torch.uint32))
        torch.cuda.synchronize()
        run["device_s"] += time.perf_counter() - t
        if not np.array_equal(merged.cpu().numpy(), want[r]):
            raise AssertionError(f"reducer {r}: the card's sorted keys differ from np.sort")
    torch.cuda.synchronize()
    run["wall_s"] = time.perf_counter() - t0
    run["peak_device_bytes_above_baseline"] = torch.cuda.max_memory_allocated() - base
    run["h2d_gbps_of_device_s"] = run["h2d_bytes"] / run["device_s"] / 1e9
    return run


def phase_data_planes(torch, dev):
    """Phase 13: the host plane's data planes over the python transport at
    HiBench TeraSort's small profile: (a) the wrapper writer with
    ``block.format=auto`` (negotiating columnar) and the record readers;
    (b) the chunked-agg writer with push/merge; (c) a device consumer
    over (a)'s committed blocks (``device_put_columns``, ``device_sort``,
    ``sort_columnar_partition``); (d) a fault plan over a tenth of the
    data, against the same run without it. No hand-written kernel runs:
    every count is 0 from just before to just after."""
    from sparkrdma_tpu_torch.obs import get_registry
    from sparkrdma_tpu_torch.testing import faults

    reg = get_registry()
    t0 = time.perf_counter()
    _reset_launches()
    report = {}

    t = time.perf_counter()
    keys = np.random.default_rng(DP_SEED).integers(0, 1 << 32, DP_RECORDS, dtype=np.uint32)
    want = _dp_expected(keys)
    report["data_s"] = time.perf_counter() - t

    def count(name, ids):
        return sum(reg.counter(name, role=i).value for i in ids)

    # ---- (a) wrapper writer, block.format=auto, then (c) on its blocks
    driver, execs = _dp_cluster("wrapper", "dp-a")
    ids = [ex.executor_id for ex in execs]
    try:
        report["a"], handle, _ = _dp_shuffle(driver, execs, 130, keys, want, "(a)")
        report["a"]["columnar_blocks"] = count("block.columnar_blocks", ids)
        report["a"]["view_decodes"] = count("block.view_decodes", ids)
        report["a"]["pickle_fallbacks"] = count("block.pickle_fallbacks", ids)
        if (report["a"]["columnar_blocks"] <= 0 or report["a"]["view_decodes"] <= 0
                or report["a"]["pickle_fallbacks"]):
            raise AssertionError(f"(a) did not negotiate columnar blocks: {report['a']}")
        report["c"] = _dp_device_consumer(torch, dev, execs, handle, want)
    finally:
        _dp_stop(driver, execs)

    # ---- (b) chunked-agg writer, push.enabled at its default (true)
    push_keys = keys[:DP_PUSH_RECORDS]
    push_want = _dp_expected(push_keys)
    driver, execs = _dp_cluster("chunkedpartitionagg", "dp-b")
    try:
        if any(ex.push_client is None or ex.merge_endpoint is None for ex in execs):
            raise AssertionError("push.enabled built no push client or merge endpoint")
        report["b"], _, _ = _dp_shuffle(driver, execs, 131, push_keys, push_want, "(b)")
        if report["b"]["remote_blocks"] + report["b"]["merged_blocks"] <= 0:
            raise AssertionError(f"(b) read nothing across executors: {report['b']}")
    finally:
        _dp_stop(driver, execs)

    # ---- (d) a fault plan over a tenth of the data, layout (a)
    fault_keys = keys[:DP_FAULT_RECORDS]
    fault_want = _dp_expected(fault_keys)
    outs = {}
    for name in ("fault_free", "faulted"):
        driver, execs = _dp_cluster("wrapper", f"dp-d-{name}")
        ids = [ex.executor_id for ex in execs]
        try:
            r0 = count("resilience.retries", ids)
            c0 = count("resilience.checksum_failures", ids)
            f0 = count("resilience.circuit_fail_fast", ids)
            ctx = contextlib.nullcontext()
            if name == "faulted":
                for ex in execs:
                    ex.start_node_if_missing()
                spec = dp_fault_spec([ex.node.port for ex in execs[1:]])
                ctx = faults.installed(spec, seed=DP_FAULT_SEED)
            with ctx as plan:
                run, _, outs[name] = _dp_shuffle(driver, execs, 132, fault_keys,
                                                 fault_want, f"(d) {name}")
            run["retries"] = count("resilience.retries", ids) - r0
            run["checksum_failures"] = count("resilience.checksum_failures", ids) - c0
            run["circuit_fail_fast"] = count("resilience.circuit_fail_fast", ids) - f0
            if plan is not None:
                run["plan"] = spec
                run["injected"] = {"read_fail": plan.injected_count("read", "fail"),
                                   "read_corrupt": plan.injected_count("read", "corrupt")}
            report[f"d_{name}"] = run
        finally:
            _dp_stop(driver, execs)
    d = report["d_faulted"]
    if d["injected"] != {"read_fail": 2, "read_corrupt": 1}:
        raise AssertionError(f"(d) the plan did not fire as written: {d['injected']}")
    if d["retries"] <= 0 or d["checksum_failures"] <= 0:
        raise AssertionError(f"(d) no retry or no detected corruption: {d}")
    if not all(np.array_equal(a, b) for a, b in zip(outs["fault_free"], outs["faulted"])):
        raise AssertionError("(d) the faulted run's output differs from the fault-free run's")

    launched = {k: n for k, n in _all_counts().items() if n}
    if launched:
        raise AssertionError(f"the data planes launched kernels: {launched}")
    emit(13, name="data_planes", launches={}, seconds=time.perf_counter() - t0, **report)



EN_RECORDS = 3_200_000  # HiBench TeraSort "small", as phase 13
# (c) and (e) at a tenth: each fault run is a job and its fault-free
# twin, and the executor-loss runs wait out two location-fetch timeouts
EN_TENTH = 320_000
EN_PAYLOAD = b"x" * 90  # bench_engine_terasort's record: an int key and 90 bytes
EN_RECORD_BYTES = 100
EN_SEED = 0  # bench_engine_terasort's default_rng(0)
EN_EXECUTORS = 2  # TpuContext, as bench_engine_terasort
EN_TASK_THREADS = 4
EN_PARTS = 8
EN_WORKERS = 4  # ClusterContext's worker processes
EN_MAPS = 8
EN_MAP_SEED = 1400  # ClusterContext map m's keys: default_rng(EN_MAP_SEED + m)
EN_EDGES = [((r + 1) << 32) // EN_PARTS for r in range(EN_PARTS - 1)]
EN_KNOBS = dict(PY_PLANE)
# an executor lost under a materialized shuffle defers the later location
# fetches until this timeout (twice: the fetch and its re-resolve) before
# the recompute; the default 30 s would hold each loss run a minute
EN_LOST_KNOBS = {"tpu.shuffle.partitionLocationFetchTimeoutMs": "2000"}
# README.md's Quick start, the import renamed to the port
QUICK_START = """\
from sparkrdma_tpu_torch.engine.context import TpuContext

with TpuContext(num_executors=2) as ctx:
    rdd = (ctx.parallelize(range(10000), 8)
              .map(lambda x: (x % 100, x))
              .reduce_by_key(lambda a, b: a + b))
    print(sorted(rdd.collect())[:3])
"""


def _en_quick_start():
    """(a) The Quick start, run as written with its ``print`` captured,
    then its whole result against plain Python."""
    from sparkrdma_tpu_torch.engine.context import TpuContext

    printed = []
    t = time.perf_counter()
    exec(compile(QUICK_START, "README.md Quick start", "exec"), {"print": printed.append})
    wall = time.perf_counter() - t
    want = sorted((k, sum(range(k, 10000, 100))) for k in range(100))
    if printed != [want[:3]]:
        raise AssertionError(f"(a) the Quick start printed {printed}, plain Python {want[:3]}")
    with TpuContext(num_executors=2) as ctx:
        got = sorted(ctx.parallelize(range(10000), 8).map(lambda x: (x % 100, x))
                     .reduce_by_key(lambda a, b: a + b).collect())
    if got != want:
        raise AssertionError("(a) the Quick start's reduction differs from plain Python")
    return {"printed": repr(printed[0]), "wall_s": wall}


def _en_task_ms(hists):
    """``engine.task_ms`` deltas summed by task kind: count, mean, and the
    bucket bounds that hold the 50th and 99th percentiles."""
    from sparkrdma_tpu_torch.obs import parse_metric_key

    acc = {}
    for key, h in hists.items():
        name, labels = parse_metric_key(key)
        if name != "engine.task_ms" or not h["count"]:
            continue
        a = acc.setdefault(labels.get("kind", "?"), {"count": 0, "sum": 0.0, "buckets": {}})
        a["count"] += h["count"]
        a["sum"] += h["sum"]
        for b, c in h.get("buckets", {}).items():
            a["buckets"][b] = a["buckets"].get(b, 0) + c
    out = {}
    for kind, a in acc.items():
        bounds = sorted(a["buckets"].items(),
                        key=lambda bc: float("inf") if bc[0] == "overflow" else float(bc[0][3:]))

        def le(q):
            seen = 0
            for b, c in bounds:
                seen += c
                if seen >= q * a["count"]:
                    return b
            return "overflow"

        out[kind] = {"count": a["count"], "mean_ms": a["sum"] / a["count"],
                     "p50_bucket": le(0.5), "p99_bucket": le(0.99)}
    return out


def _en_check_sorted(out, keys, what):
    """The whole output sorted, its keys ``np.sort`` of the input's, every
    payload intact."""
    if len(out) != len(keys):
        raise AssertionError(f"{what}: {len(out)} records, {len(keys)} expected")
    got = np.fromiter((k for k, _ in out), dtype=np.uint64, count=len(out))
    if not np.all(got[:-1] <= got[1:]):
        raise AssertionError(f"{what}: the output is not sorted")
    if not np.array_equal(got, np.sort(keys)):
        raise AssertionError(f"{what}: the keys differ from np.sort of the input")
    if any(v != EN_PAYLOAD for _, v in out):
        raise AssertionError(f"{what}: a payload differs from the record's")


def _en_ctx(knobs=None):
    from sparkrdma_tpu_torch.engine.context import TpuContext
    from sparkrdma_tpu_torch.utils.config import TpuShuffleConf

    return TpuContext(num_executors=EN_EXECUTORS, task_threads=EN_TASK_THREADS,
                      conf=TpuShuffleConf({**EN_KNOBS, **(knobs or {})}))


def _en_sort(ctx, data):
    return ctx.parallelize(data, EN_PARTS).sort_by_key(num_partitions=EN_PARTS)


def _en_hub_view(ctx, since_ms):
    """What the driver's telemetry hub holds after a job, one beat from
    every executor flushed in first: executors and windows, missed
    heartbeats, stragglers, SLO pages and warns, and the journal events
    from ``since_ms`` on (the process journal also holds earlier
    phases' events)."""
    hub = ctx.driver.telemetry
    ctx.telemetry_flush()
    summary = hub.summary()
    slo = hub.slo.summary()
    merged = hub.journal.merged(since_wall_ms=since_ms)
    kinds = {}
    for e in merged:
        kinds[e["kind"]] = kinds.get(e["kind"], 0) + 1
    severities = [b["severity"] for b in slo["breach_records"]]
    return {"executors": {e: v["windows"] for e, v in summary["executors"].items()},
            "missed_heartbeats": summary["missed_heartbeats"],
            "stragglers": summary["stragglers"],
            "slo_pages": severities.count("page"), "slo_warns": severities.count("warn"),
            "slo_diagnoses": slo["diagnosis_count"], "slo_evaluations": slo["evaluations"],
            "journal_events": len(merged), "journal_kinds": kinds}


def _en_terasort(keys, knobs=None):
    """(b) bench_engine_terasort's job through ``TpuContext``; with the
    telemetry hub on (the default), what the hub holds after it."""
    from sparkrdma_tpu_torch.obs import get_registry

    reg = get_registry()
    before = reg.snapshot(prefix="engine.")
    hub = None
    since_ms = int(time.time() * 1000)
    with _en_ctx(knobs) as ctx:
        t = time.perf_counter()
        data = [(int(k), EN_PAYLOAD) for k in keys]
        data_s = time.perf_counter() - t
        t = time.perf_counter()
        out = ctx.run_job(_en_sort(ctx, data))
        wall = time.perf_counter() - t
        bd = ctx.last_breakdown
        execs = sorted(ex.executor_id for ex in ctx.executors)
        if ctx.driver.telemetry is not None:
            hub = _en_hub_view(ctx, since_ms)
    if hub is not None and (sorted(hub["executors"]) != execs or hub["missed_heartbeats"]):
        raise AssertionError(f"(b) the hub holds {hub}, the executors are {execs}")
    if bd is None:
        raise AssertionError("(b) the job left no breakdown")
    _en_check_sorted(out, keys, "(b)")
    delta = reg.delta(before, prefix="engine.")
    recomputes = delta["counters"].get("engine.stage_recomputes", 0)
    if recomputes:
        raise AssertionError(f"(b) {recomputes} stage recomputes in a fault-free job")
    bdd = bd.to_dict()
    n = len(keys)
    return {"records": n, "data_s": data_s, "wall_s": wall, "records_per_s": n / wall,
            "logical_gbps": n * EN_RECORD_BYTES / wall / 1e9,
            "breakdown": {"wall_ms": bdd["wall_ms"], "coverage": bdd["coverage"],
                          "categories_ms": bdd["categories_ms"],
                          "gap_frames": dict(list(bdd.get("gap_frames", {}).items())[:5])},
            "stage_recomputes": recomputes, "task_ms": _en_task_ms(delta["histograms"]),
            "telemetry_hub": hub}


def _en_faults(keys):
    """(c) ``driver:kill`` between map and reduce, and an executor lost
    between two reads of one materialized shuffle, each against the job
    without the fault."""
    from sparkrdma_tpu_torch.obs import get_registry
    from sparkrdma_tpu_torch.testing import faults

    reg = get_registry()
    data = [(int(k), EN_PAYLOAD) for k in keys]
    report = {"records": len(keys)}
    with _en_ctx() as ctx:
        t = time.perf_counter()
        base = _en_sort(ctx, data).collect()
        report["fault_free_s"] = time.perf_counter() - t
    _en_check_sorted(base, keys, "(c) fault-free")

    adoptions = reg.counter("metastore.adoptions", role="driver")
    a0 = adoptions.value
    try:
        with _en_ctx({"tpu.shuffle.faultPlan": "driver:kill:1:stage=reduce_phase"}) as ctx:
            t = time.perf_counter()
            got = _en_sort(ctx, data).collect()
            report["driver_kill_s"] = time.perf_counter() - t
    finally:
        faults.uninstall()
    report["adoptions"] = adoptions.value - a0
    if got != base:
        raise AssertionError("(c) driver:kill: the output differs from the fault-free run's")
    if report["adoptions"] <= 0:
        raise AssertionError("(c) driver:kill: metastore.adoptions did not rise")

    recomputes = reg.counter("engine.stage_recomputes")
    with _en_ctx(EN_LOST_KNOBS) as ctx:
        rdd = _en_sort(ctx, data)
        first = rdd.collect()
        r0 = recomputes.value
        ctx.lose_executor("exec-1")
        t = time.perf_counter()
        again = rdd.collect()
        report["lost_executor_reread_s"] = time.perf_counter() - t
        report["survivors"] = [m.executor_id for m in ctx.executors]
    report["stage_recomputes"] = recomputes.value - r0
    if first != base or again != base:
        raise AssertionError("(c) lost executor: the output differs from the fault-free run's")
    if report["stage_recomputes"] != 1 or report["survivors"] != ["exec-0"]:
        raise AssertionError(f"(c) lost executor: {report}")
    return report


def _en_map_fn(seed, n):
    """A ClusterContext map function: its keys made in the worker."""
    def fn():
        keys = np.random.default_rng(seed).integers(0, 1 << 32, n, dtype=np.uint64)
        return ((int(k), b"x" * 90) for k in keys)

    return fn


def _en_summary_fn(edges, counters=()):
    """A ClusterContext reduce function: count, min, max and xor of the
    keys, the partitions they fall in, payloads that differ, and the
    worker process's totals of ``counters`` after the read."""
    def fn(it):
        import bisect

        count, lo, hi, xor, parts, bad = 0, None, None, 0, set(), 0
        for k, v in it:
            count += 1
            lo = k if lo is None or k < lo else lo
            hi = k if hi is None or k > hi else hi
            xor ^= k
            parts.add(bisect.bisect_left(edges, k))
            bad += v != b"x" * 90
        out = {"count": count, "min": lo, "max": hi, "xor": xor, "parts": sorted(parts),
               "bad": bad}
        if counters:
            from sparkrdma_tpu_torch.obs import get_registry

            reg = get_registry()
            out["counters"] = {c: sum(reg.snapshot(prefix=c)["counters"].values())
                               for c in counters}
        return out

    return fn


def _en_probe_fn():
    """A reduce function that reports what its worker process loaded and
    the transport node it runs."""
    def fn(it):
        import os
        import sys
        import threading

        import torch as worker_torch

        # each node names its event thread: a NativeTpuNode its CQ
        # poller ``srt-cq-<id>``, a TpuNode its acceptor ``listener-<id>``
        kinds = {"srt-cq-": "NativeTpuNode", "listener-": "TpuNode"}
        return {"pid": os.getpid(), "records": sum(1 for _ in it),
                "cuda_initialized": worker_torch.cuda.is_initialized(),
                "nodes": sorted({kind for t in threading.enumerate()
                                 for prefix, kind in kinds.items()
                                 if t.name.startswith(prefix)}),
                "jax": sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
                              or m == "sparkrdma_tpu" or m.startswith("sparkrdma_tpu.")),
                "main": getattr(sys.modules["__main__"].__spec__, "name", None)}

    return fn


def _en_keys(n):
    per = n // EN_MAPS
    return per, np.concatenate([
        np.random.default_rng(EN_MAP_SEED + m).integers(0, 1 << 32, per, dtype=np.uint64)
        for m in range(EN_MAPS)])


def _en_check_ranges(parts, keys, what):
    """Each reducer's count, xor, min and max against the keys of the
    partitions it read; the ranges disjoint and ordered; every payload
    intact; every key read once."""
    part = np.searchsorted(np.asarray(EN_EDGES, np.uint64), keys, side="left")
    seen, prev_max = [], -1
    for i, p in enumerate(parts):
        if not p["count"]:
            continue
        mine = keys[np.isin(part, p["parts"])]
        if (p["count"], p["xor"], p["min"], p["max"]) != (
                len(mine), int(np.bitwise_xor.reduce(mine)), int(mine.min()), int(mine.max())):
            raise AssertionError(f"{what} reducer {i}: count/xor/min/max differ from the "
                                 "generator's keys of its partitions")
        if p["bad"]:
            raise AssertionError(f"{what} reducer {i}: {p['bad']} payloads differ")
        if p["min"] <= prev_max:
            raise AssertionError(f"{what} reducer {i}: its range overlaps the previous one")
        prev_max = p["max"]
        seen.extend(p["parts"])
    if seen != sorted(set(seen)) or sum(p["count"] for p in parts) != len(keys):
        raise AssertionError(f"{what}: partitions read twice or records missing")


def _en_cluster(knobs=None):
    from sparkrdma_tpu_torch.engine.cluster import ClusterContext
    from sparkrdma_tpu_torch.utils.config import TpuShuffleConf

    t = time.perf_counter()
    cc = ClusterContext(num_executors=EN_WORKERS,
                        conf=TpuShuffleConf({**EN_KNOBS, **(knobs or {})}))
    return cc, time.perf_counter() - t


def _en_cluster_job(cc, n, counters=()):
    from sparkrdma_tpu_torch.shuffle.handle import RangePartitioner

    per, keys = _en_keys(n)
    t = time.perf_counter()
    parts = cc.run_map_reduce([_en_map_fn(EN_MAP_SEED + m, per) for m in range(EN_MAPS)],
                              num_partitions=EN_PARTS, partitioner=RangePartitioner(EN_EDGES),
                              reduce_fn=_en_summary_fn(EN_EDGES, counters))
    return parts, keys, time.perf_counter() - t


def _en_cluster_sort(n, knobs=None, what="(d)"):
    """(d) The range-partitioned sort through ``ClusterContext``: 4 worker
    processes, 8 map functions making their keys in the workers, then a
    probe of what each worker loaded and which transport node it runs
    (the plane ``knobs`` name: python unless they say otherwise)."""
    plane = ("NativeTpuNode"
             if (knobs or {}).get("tpu.shuffle.transport") == "native" else "TpuNode")
    cc, startup = _en_cluster(knobs)
    try:
        if type(cc.driver.node).__name__ != plane:
            raise AssertionError(f"{what} the driver's node is not a {plane}")
        parts, keys, wall = _en_cluster_job(cc, n)
        bd = cc.last_breakdown
        probes = cc.run_map_reduce([_en_map_fn(7, 64)], num_partitions=EN_WORKERS,
                                   reduce_fn=_en_probe_fn())
    finally:
        cc.stop()
    if bd is None:
        raise AssertionError(f"{what} the job left no breakdown")
    _en_check_ranges(parts, keys, what)
    if len({p["pid"] for p in probes} | {os.getpid()}) != EN_WORKERS + 1:
        raise AssertionError(f"{what} the probe did not run on {EN_WORKERS} worker processes")
    for p in probes:
        if (p["cuda_initialized"] or p["jax"]
                or p["main"] != "sparkrdma_tpu_torch.engine.worker"):
            raise AssertionError(f"{what} a worker touched CUDA or loaded jax: {p}")
        if p["nodes"] != [plane]:
            raise AssertionError(f"{what} a worker runs {p['nodes']}, not a {plane}")
    bdd = bd.to_dict()
    return {"records": len(keys), "startup_s": startup, "job_s": wall,
            "records_per_s": len(keys) / wall,
            "logical_gbps": len(keys) * EN_RECORD_BYTES / wall / 1e9,
            "reducer_records": [p["count"] for p in parts],
            "breakdown": {"wall_ms": bdd["wall_ms"], "coverage": bdd["coverage"],
                          "categories_ms": bdd["categories_ms"]},
            "workers": [{k: p[k] for k in ("pid", "cuda_initialized", "jax", "main",
                                           "nodes")}
                        for p in probes]}


def _en_cluster_faults(n):
    """(e) The chunked-agg writer with push in cluster mode (the push
    client's routes come from the workers' task ports), then
    ``exec:kill`` of one worker at its first reduce under the wrapper
    writer."""
    from sparkrdma_tpu_torch.obs import get_registry
    from sparkrdma_tpu_torch.testing import faults

    report = {}
    cc, startup = _en_cluster({"tpu.shuffle.shuffleWriteMethod": "chunkedpartitionagg",
                               "tpu.shuffle.push.enabled": "true"})
    try:
        parts, keys, wall = _en_cluster_job(
            cc, n, counters=("push.pushed_blocks", "reader.merged_reads"))
    finally:
        cc.stop()
    _en_check_ranges(parts, keys, "(e) push")
    pushed = sum(p["counters"]["push.pushed_blocks"] for p in parts)
    merged = sum(p["counters"]["reader.merged_reads"] for p in parts)
    report["push"] = {"records": len(keys), "startup_s": startup, "job_s": wall,
                      "pushed_blocks": pushed, "merged_blocks": merged}
    if pushed <= 0 or merged <= 0:
        raise AssertionError(f"(e) push: no merged segment read: {report['push']}")

    reg = get_registry()
    recoveries = reg.counter("elastic.recoveries", role="driver")
    recomputed = reg.counter("elastic.recomputed_maps", role="driver")
    r0, m0 = recoveries.value, recomputed.value
    try:
        cc, startup = _en_cluster({
            "tpu.shuffle.faultPlan": "exec:kill:1:peer=proc-exec-1,stage=reduce_task",
            **EN_LOST_KNOBS})
        try:
            handles = list(cc.workers)
            parts, keys, wall = _en_cluster_job(cc, n)
            live = [w.executor_id for w in cc.workers]
        finally:
            cc.stop()
    finally:
        faults.uninstall()
    _en_check_ranges(parts, keys, "(e) exec:kill")
    killed = next(w for w in handles if w.executor_id == "proc-exec-1")
    report["exec_kill"] = {"records": len(keys), "startup_s": startup, "job_s": wall,
                           "live_after": live, "killed_exit": killed.proc.returncode,
                           "recoveries": recoveries.value - r0,
                           "recomputed_maps": recomputed.value - m0}
    if (report["exec_kill"]["recoveries"] < 1 or "proc-exec-1" in live
            or killed.proc.returncode != 1):
        raise AssertionError(f"(e) exec:kill: {report['exec_kill']}")
    return report


def phase_engine(torch, dev):
    """Phase 14: the engine on the card's host. (a) the README's Quick
    start; (b) HiBench TeraSort small through ``TpuContext``
    (bench_engine_terasort's job); (c) its fault runs at a tenth; (d) the
    range-partitioned sort through ``ClusterContext``'s worker processes;
    (e) the cluster's push route and executor loss at a tenth. The engine
    does no device work: no hand-written kernel runs, every count is 0
    from just before to just after, and no worker initialises CUDA."""

    # the workers are ``python -m sparkrdma_tpu_torch.engine.worker``: they
    # find the package on PYTHONPATH from any working directory
    os.environ["PYTHONPATH"] = os.pathsep.join(
        [HERE] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p])
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    import cloudpickle

    t0 = time.perf_counter()
    _reset_launches()
    report = {"card": smi, "cloudpickle": f"{cloudpickle.__version__} {cloudpickle.__file__}"}
    report["a"] = _en_quick_start()
    keys = np.random.default_rng(EN_SEED).integers(0, 1 << 32, EN_RECORDS, dtype=np.uint64)
    report["b"] = _en_terasort(keys)
    report["c"] = _en_faults(keys[:EN_TENTH])
    report["d"] = _en_cluster_sort(EN_RECORDS)
    report["e"] = _en_cluster_faults(EN_TENTH)
    launched = {k: n for k, n in _all_counts().items() if n}
    if launched:
        raise AssertionError(f"the engine launched kernels: {launched}")
    emit(14, name="engine", launches={}, seconds=time.perf_counter() - t0, **report)
    _REPORTS[14] = report


# ----------------------------------------------------------------------
# phase 15: the native plane
# ----------------------------------------------------------------------
NP_RT_BYTES = 8 << 20  # (a): each node's registered slab
NP_RT_SEED = 15


def native_plane_facts():
    """What the native plane got on this machine: each library's build
    seconds in this process (absent: loaded one already built from the
    same source), io_uring compiled in, ``/dev/shm``'s free and total
    bytes, and the registered buffers by backing so far."""
    from sparkrdma_tpu_torch.memory import buffer
    from sparkrdma_tpu_torch.native import arena
    from sparkrdma_tpu_torch.native import transport_lib as tl

    t = time.perf_counter()
    lib = tl.require()
    arena.require()
    st = os.statvfs("/dev/shm")
    return {"build_s": dict(tl.build_seconds), "load_s": time.perf_counter() - t,
            "uring_compiled": bool(lib.srt_uring_compiled()),
            "dev_shm_free_bytes": st.f_bavail * st.f_frsize,
            "dev_shm_total_bytes": st.f_blocks * st.f_frsize,
            "backings": buffer.backing_counts()}


def native_round_trip(size=NP_RT_BYTES, seed=NP_RT_SEED):
    """(a) Two port native nodes and a port python node: one-sided READ
    and SEND in every direction on ``default_rng(seed)`` bytes,
    byte-equal. Each native node reads the other's ``/dev/shm`` slab by
    the same-host file fast path and the python node's anonymous region
    streamed, so each counts read paths (1, 1)."""
    import threading

    from sparkrdma_tpu_torch.memory.buffer import TpuBuffer
    from sparkrdma_tpu_torch.transport import FnListener
    from sparkrdma_tpu_torch.transport.native_node import NativeTpuNode
    from sparkrdma_tpu_torch.transport.node import TpuNode
    from sparkrdma_tpu_torch.utils.config import TpuShuffleConf

    rng = np.random.default_rng(seed)
    names = ("native-0", "native-1", "python")
    got = {n: [] for n in names}
    lock = threading.Lock()

    def on_recv(name):
        def f(ch, payload):
            with lock:
                got[name].append(bytes(payload))
        return f

    nodes, bufs, sent = {}, {}, {n: [] for n in names}
    t0 = time.perf_counter()
    try:
        for n in names:
            cls, knobs = ((TpuNode, PY_PLANE) if n == "python"
                          else (NativeTpuNode, NATIVE_PLANE))
            nodes[n] = cls(TpuShuffleConf(knobs), "127.0.0.1", True, f"rt-{n}",
                           recv_listener=on_recv(n))
        src = {}
        for n in names:
            bufs[n] = TpuBuffer(nodes[n].pd, size)
            src[n] = rng.integers(0, 256, size, np.uint8)
            np.frombuffer(bufs[n].view, np.uint8)[:] = src[n]
        if [bufs[n]._shm_path is not None for n in names] != [True, True, False]:
            raise AssertionError("(a) a native slab is not on /dev/shm, or the python one is")
        for dst in names:
            for s in names:
                if s == dst:
                    continue
                ch = nodes[dst].get_channel("127.0.0.1", nodes[s].port, purpose="data")
                off = 4097 + 13 * names.index(s)
                n_bytes = size - off - 1
                out = memoryview(bytearray(n_bytes))
                done, errs = threading.Event(), []
                ch.read_in_queue(FnListener(lambda _: done.set(),
                                            lambda e: (errs.append(e), done.set())),
                                 [out], [(bufs[s].mkey, off, n_bytes)])
                if not done.wait(60) or errs:
                    raise AssertionError(f"(a) READ {dst} <- {s} failed: {errs}")
                if bytes(out) != src[s][off:off + n_bytes].tobytes():
                    raise AssertionError(f"(a) READ {dst} <- {s}: bytes differ")
                msg = rng.integers(0, 256, 70_000, np.uint8).tobytes() + dst.encode()
                done = threading.Event()
                ch.send_in_queue(FnListener(lambda _: done.set()), [msg])
                if not done.wait(60):
                    raise AssertionError(f"(a) SEND {dst} -> {s} never completed")
                sent[s].append(msg)
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            with lock:
                if all(len(got[n]) == len(sent[n]) for n in names):
                    break
            time.sleep(0.01)
        for n in names:
            if sorted(got[n]) != sorted(sent[n]):
                raise AssertionError(f"(a) {n} received other SENDs than were sent")
        stats = {n: nodes[n].read_path_stats() for n in names[:2]}
        if any(v != (1, 1) for v in stats.values()):
            raise AssertionError(f"(a) read paths (fast path, streamed) {stats}, not (1, 1)")
        return {"wall_s": time.perf_counter() - t0, "bytes_read_each": size,
                "reads": 6, "sends": 6, "read_path_stats": stats,
                "sq": nodes["native-0"].sq_stats()}
    finally:
        for b in bufs.values():
            b.free()
        for node in nodes.values():
            node.stop()


def native_terasort(torch, dev, data, knobs=None, prefix="np", sid=150,
                    keep=False):
    """(b) and (c): phase 10 (b)'s TeraSort on the plane ``knobs`` name
    (native unless they say otherwise): a driver and one executor a
    shard, map (sort, stage, publish), then (b) every reducer fetches
    its partition through the location RPC and the compiled waves and
    merges, cold and warm, default knobs; (c) the same published blocks
    with ``deviceFetch.enabled=false``, cold and warm: on the native
    plane every remote block arrives by mapped delivery on the same-host
    fast path (fast-path READs == remote blocks, none streamed, no
    pooled registered buffer taken), byte-equal to the map's blocks;
    then the map again on warm pools. Every reducer is checked against
    ``np.sort`` of its range and the input's count, sum and xor. With
    ``keep``, returns each run's merged outputs too."""
    from sparkrdma_tpu_torch.models.terasort import MapShardSorter
    from sparkrdma_tpu_torch.obs import get_registry
    from sparkrdma_tpu_torch.shuffle.device_io import DeviceShuffleIO
    from sparkrdma_tpu_torch.shuffle.handle import BaseShuffleHandle, HashPartitioner
    from sparkrdma_tpu_torch.shuffle.manager import TpuShuffleManager
    from sparkrdma_tpu_torch.transport.native_node import NativeTpuNode
    from sparkrdma_tpu_torch.utils.config import TpuShuffleConf

    shards, edges, want = data
    n_exec = len(shards)
    knobs = {**NATIVE_PLANE, **HOST_PLANE_KNOBS, **(knobs or {})}
    native = knobs["tpu.shuffle.transport"] == "native"
    reg = get_registry()
    conf = TpuShuffleConf(knobs)
    driver = TpuShuffleManager(conf, is_driver=True)
    ids = [f"{prefix}-{e}" for e in range(n_exec)]
    execs = [TpuShuffleManager(conf, is_driver=False, executor_id=i) for i in ids]
    ios = [DeviceShuffleIO(ex, device=dev) for ex in execs]
    report, outs = {"knobs": knobs}, {}

    def fetch_counts():
        snaps = [io.metrics_snapshot() for io in ios]
        return {"fast_path": sum(s.get("reads_samehost_fast_path", 0) for s in snaps),
                "streamed": sum(s.get("reads_streamed", 0) for s in snaps),
                **{k: sum(s[k] for s in snaps)
                   for k in ("fetch_transport_s", "fetch_stage_s", "fetch_bytes")},
                "pool_gets": (reg.counter("mempool.hits").value
                              + reg.counter("mempool.misses").value),
                **{f"collective.{k}": sum(reg.counter(f"collective.{k}", role=i).value
                                          for i in ids)
                   for k in ("blocks", "degrades")}}

    try:
        nodes = {type(ex.node).__name__ for ex in [driver, *execs]}
        if native and nodes != {NativeTpuNode.__name__}:
            raise AssertionError(f"the native run's nodes are {nodes}")
        report["nodes"] = sorted(nodes)
        driver.register_shuffle(BaseShuffleHandle(
            shuffle_id=sid, num_maps=n_exec, partitioner=HashPartitioner(REDUCERS)))
        sorter = MapShardSorter(dev)
        map_s, split, staged, sorted_keys = _hp_map_phase(
            torch, dev, sorter, ios, shards, edges, sid)
        if not all(loc.block.has_device for loc in staged):
            raise AssertionError("a staged block has no device coordinates")
        report["map_s"], report["map_split"] = map_s, split
        report["stage"] = {k: sum(io.metrics_snapshot()[k] for io in ios)
                           for k in ("stage_copy_s", "stage_checksum_s",
                                     "stage_arena_s", "stage_bytes")}
        remote = sum(1 for loc in staged
                     if loc.manager_id.executor_id != ids[loc.partition_id])

        for name, run_knobs in (("b", {}),
                                ("c", {"tpu.shuffle.deviceFetch.enabled": "false"})):
            for k, v in run_knobs.items():
                conf.set(k, v)
            try:
                c0, l0 = fetch_counts(), _wave_launches()
                blobs = [] if name == "c" else None
                cold, outs[f"{name}_cold"] = _hp_reduce_all(torch, dev, ios, sid, want,
                                                           blocks=blobs)
                warm, outs[f"{name}_warm"] = _hp_reduce_all(torch, dev, ios, sid)
                c1 = fetch_counts()
            finally:
                for k in run_knobs:
                    conf.set(k, "true")
            run = {"knobs": run_knobs, "reduce_cold_s": cold, "reduce_warm_s": warm,
                   "reduce_gbps_warm": sum(len(x) for x in shards) * 4 / warm / 1e9,
                   "e2e_s": map_s + cold,
                   "wave_launches": [x - y for x, y in zip(_wave_launches(), l0)],
                   **{f"{k}_two_reduces": c1[k] - c0[k] for k in c0}}
            report[name] = run
            if name == "b":
                if (run["collective.blocks_two_reduces"] != 2 * len(staged)
                        or run["collective.degrades_two_reduces"]):
                    raise AssertionError(f"(b) not every block rode a wave: {run}")
            else:
                if sum(run["wave_launches"]) or run["collective.blocks_two_reduces"]:
                    raise AssertionError(f"(c) used the waves: {run}")
                want_blobs = [sorted(k[b[r]:b[r + 1]].tobytes() for k, b in sorted_keys)
                              for r in range(REDUCERS)]
                if blobs != want_blobs:
                    raise AssertionError("(c) a fetched block differs from the map's")
                run["remote_blocks_two_reduces"] = 2 * remote
                if native and (run["fast_path_two_reduces"] != 2 * remote
                               or run["streamed_two_reduces"]
                               or run["pool_gets_two_reduces"]):
                    raise AssertionError(
                        f"(c) not every remote block came by mapped delivery on the "
                        f"same-host fast path without a pooled buffer: {run}")

        # the map again on warm pools: unpublish returns the registered
        # buffers and arena slabs, a second shuffle reuses them
        for io in ios:
            io.unpublish(sid)
        driver.register_shuffle(BaseShuffleHandle(
            shuffle_id=sid + 1, num_maps=n_exec, partitioner=HashPartitioner(REDUCERS)))
        s0 = {k: sum(io.metrics_snapshot()[k] for io in ios)
              for k in ("stage_copy_s", "stage_checksum_s", "stage_arena_s")}
        warm_s, warm_split, _, _ = _hp_map_phase(torch, dev, sorter, ios, shards, edges,
                                                 sid + 1)
        report["map_warm_pools"] = {
            "map_s": warm_s, "map_split": warm_split,
            "stage": {k: sum(io.metrics_snapshot()[k] for io in ios) - v
                      for k, v in s0.items()}}
        if native:
            report["sq"] = execs[0].node.sq_stats()
    finally:
        for io in ios:
            io.stop()
        for ex in execs:
            ex.stop()
        driver.stop()
    return (report, outs) if keep else report


def phase_native_plane(torch, dev, data):
    """Phase 15: the native plane (``transport=native``: the C++ data
    plane, the native arena, ``/dev/shm`` slabs and mapped delivery) on
    the card's machine. (a) two native nodes and a python node, SEND
    and READ every way; (b) phase 10 (b)'s 1 GiB TeraSort over native,
    the wave-pull kernels launched; (c) its blocks again with
    ``deviceFetch.enabled=false``, by mapped delivery; (d) phase 13 (a)
    over native; (e) phase 14 (d) at a tenth over native, in 4 worker
    processes. Every run asserts its nodes are ``NativeTpuNode``s.
    Counts from 0 just before, read just after."""
    from sparkrdma_tpu_torch.memory import buffer
    from sparkrdma_tpu_torch.obs import get_registry

    reg = get_registry()
    t0 = time.perf_counter()
    report = {"facts": native_plane_facts()}
    _reset_launches()
    report["a"] = native_round_trip()

    # ---- (b) and (c): phase 10's TeraSort over native
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    b0 = buffer.backing_counts()
    tera = native_terasort(torch, dev, data)
    report["b_c"] = tera
    report["b_c"]["backings"] = {k: v - b0[k] for k, v in buffer.backing_counts().items()}
    report["b_c"]["peak_device_bytes_above_baseline"] = torch.cuda.max_memory_allocated() - base
    p10 = _REPORTS.get(10)
    if p10 is not None:
        report["b_c"]["phase10_python_plane"] = {
            "map_s": p10["b"]["map_s"], "map_split": p10["b"]["map_split"],
            "stage": p10["b"]["stage"], "map_warm_pools": p10["b"]["map_warm_pools"],
            "b_reduce_cold_warm_s": [p10["default"]["reduce_cold_s"],
                                     p10["default"]["reduce_warm_s"]],
            "c_reduce_cold_warm_s": [p10["c_device_fetch_off"]["reduce_cold_s"],
                                     p10["c_device_fetch_off"]["reduce_warm_s"]],
            "c_fetch_stats_two_reduces": p10["c_device_fetch_off"]["fetch_stats_two_reduces"]}
    if report["b_c"]["backings"]["shm_fallback"]:
        raise AssertionError(f"(b) slabs fell back to anonymous memory: "
                             f"{report['b_c']['backings']}")
    if tera["b"]["wave_launches"][1] <= 0:
        raise AssertionError("(b) the pipelined wave-pull kernel never launched")

    # ---- (d) phase 13 (a) over native
    keys = np.random.default_rng(DP_SEED).integers(0, 1 << 32, DP_RECORDS, dtype=np.uint32)
    want = _dp_expected(keys)
    driver, execs = _dp_cluster("wrapper", "np-d", NATIVE_PLANE)
    ids = [ex.executor_id for ex in execs]
    try:
        for ex in execs:
            ex.start_node_if_missing()
        nodes = {type(m.node).__name__ for m in [driver, *execs]}
        if nodes != {"NativeTpuNode"}:
            raise AssertionError(f"(d) the nodes are {nodes}")
        f0 = [ex.node.read_path_stats() for ex in execs]
        report["d"], _, _ = _dp_shuffle(driver, execs, 153, keys, want, "(d)")
        for k in ("columnar_blocks", "view_decodes", "pickle_fallbacks"):
            report["d"][k] = sum(reg.counter(f"block.{k}", role=i).value for i in ids)
        report["d"]["read_path_stats"] = [
            [x - y for x, y in zip(ex.node.read_path_stats(), f)] for ex, f in zip(execs, f0)]
        if (report["d"]["columnar_blocks"] <= 0 or report["d"]["view_decodes"] <= 0
                or report["d"]["pickle_fallbacks"]):
            raise AssertionError(f"(d) did not negotiate columnar blocks: {report['d']}")
    finally:
        _dp_stop(driver, execs)
    del keys, want

    # ---- (e) phase 14 (d) at a tenth over native, in worker processes
    os.environ["PYTHONPATH"] = os.pathsep.join(
        [HERE] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p])
    report["e"] = _en_cluster_sort(EN_TENTH, NATIVE_PLANE, "(e)")

    report["backings_total"] = buffer.backing_counts()
    report["transport.sq"] = {
        k: reg.counter(f"transport.sq.{k}").value
        for k in ("submits", "batches", "completions", "backend_fallbacks")}
    report["transport.sq"]["sqe_depth"] = reg.gauge("transport.sq.sqe_depth").value
    counts = {"srt_wave_pull": _launched("srt_wave_pull"),
              "srt_pipelined_wave_pull": _launched("srt_pipelined_wave_pull")}
    emit(15, name="native_plane", launches=counts, seconds=time.perf_counter() - t0,
         **report)
    return counts


# ----------------------------------------------------------------------
# phase 16: the operations planes (telemetry hub, SLO, capacity, journal)
# ----------------------------------------------------------------------
OBS_EXECUTORS = 8
OBS_BEATS = 600  # heartbeats from each executor into the hub alone
OBS_OUTLIER = 5  # obs-exec-5's map tasks run 20 times longer
OBS_SEED = 16
OBS_JOURNAL_EVENTS = 10_000
OBS_JOURNAL_BATCH = 16  # events a heartbeat ships, besides the last beat's again
OBS_DEADLINE_S = 20.0
# (c): one transient READ fault in each worker under a one-failure
# breaker: the circuit opens, the retry's half-open trial closes it, and
# the workers' circuit events ride their heartbeats to the driver
OBS_CLUSTER_KNOBS = {
    "tpu.shuffle.faultPlan": "read:fail:1",
    "tpu.shuffle.resilience.circuitFailureThreshold": "1",
    "tpu.shuffle.resilience.circuitOpenMs": "1",
    "tpu.shuffle.resilience.retryBackoffMs": "5",
}
OBS_PULL_ROUNDS = 5
# (b) runs at a tenth when phase 14 (b)'s job took longer than this
OBS_B_BUDGET_S = 45.0


def _obs_beat(rng, seq):
    """One synthetic heartbeat from every executor at beat ``seq``: the
    payloads ``Heartbeater.beat`` ships (map-task latencies with their
    buckets, read and write bytes, an in-flight gauge)."""
    out = []
    for i in range(OBS_EXECUTORS):
        eid = f"obs-exec-{i}"
        n = int(rng.integers(8, 12))
        task_ms = float(rng.uniform(90.0, 110.0)) * (20.0 if i == OBS_OUTLIER else 1.0)
        slow = i == OBS_OUTLIER
        out.append({
            "v": 1, "executor_id": eid, "seq": seq,
            "wall_ms": 1_000_000 + seq * 1000 + int(rng.integers(0, 50)),
            "interval_ms": 1000, "epoch_ms": 940_000,
            "counters": {f"transport.read_bytes{{role={eid}}}": int(rng.integers(60 << 20, 70 << 20)),
                         f"writer.bytes_written{{role={eid}}}": int(rng.integers(60 << 20, 70 << 20))},
            "gauges": {f"reader.inflight_bytes{{role={eid}}}":
                       {"value": int(rng.integers(0, 1 << 24)), "hwm": 1 << 24}},
            "histograms": {f"engine.task_ms{{kind=map,role={eid},tenant=default}}": {
                "count": n, "sum": task_ms * n,
                "buckets": {"le_250": 0 if slow else n, "le_2500": n if slow else 0,
                            "overflow": 0}}},
        })
    return out


def _obs_hub_alone():
    """(a) The driver's hub alone: ``OBS_BEATS`` synthetic beats from each
    of 8 executors (one busy outlier) through ``TelemetryHub.ingest``
    with the SLO engine and the capacity plane on, on the process
    registry, under a clock that follows the beats; then the OpenMetrics
    render of that registry; then a 10,000-event journal from 8
    processes merged through ``JournalHub`` as heartbeats ship it (each
    beat re-ships the previous beat's batch)."""
    from sparkrdma_tpu_torch.obs import journal as _journal
    from sparkrdma_tpu_torch.obs.metrics import MetricsRegistry
    from sparkrdma_tpu_torch.obs.telemetry import TelemetryHub
    from sparkrdma_tpu_torch.utils.config import TpuShuffleConf

    rng = np.random.default_rng(OBS_SEED)
    now = [1_000.0]
    hub = TelemetryHub(TpuShuffleConf(), role="obs-hub", clock=lambda: now[0])
    ingest_ns = []
    try:
        for seq in range(1, OBS_BEATS + 1):
            for p in _obs_beat(rng, seq):
                now[0] = p["wall_ms"] / 1000.0
                t = time.perf_counter_ns()
                hub.ingest(p)
                ingest_ns.append(time.perf_counter_ns() - t)
        report = hub.straggler_report()
        summary = hub.summary()
        slo = hub.slo.summary()
        t = time.perf_counter()
        text = hub.render_openmetrics()
        render_ms = (time.perf_counter() - t) * 1e3
    finally:
        hub.stop()
    us = np.asarray(ingest_ns, np.float64) / 1e3
    out = {"executors": OBS_EXECUTORS, "beats_each": OBS_BEATS, "ingests": len(us),
           "ingest_us_p50": float(np.percentile(us, 50)),
           "ingest_us_p99": float(np.percentile(us, 99)),
           "ingest_us_mean": float(us.mean()),
           "windows_each": sorted({v["windows"] for v in summary["executors"].values()}),
           "stragglers": report["stragglers"], "missed_heartbeats": summary["missed_heartbeats"],
           "slo_evaluations": slo["evaluations"], "slo_breaches": slo["breach_count"],
           "capacity_evaluations": summary["capacity"]["evaluations"],
           "openmetrics_render_ms": render_ms, "openmetrics_bytes": len(text.encode()),
           "openmetrics_lines": text.count("\n")}
    if report["stragglers"] != [f"obs-exec-{OBS_OUTLIER}"]:
        raise AssertionError(f"(a) flagged {report['stragglers']}, not obs-exec-{OBS_OUTLIER}")

    # the journal merge
    reg = MetricsRegistry()
    per = OBS_JOURNAL_EVENTS // OBS_EXECUTORS
    kinds = ("circuit.open", "quota.block", "autotune.adjust", "straggler.flag")
    clocks = [[2_000.0] for _ in range(OBS_EXECUTORS)]
    journals = [_journal.EventJournal(f"obs-exec-{i}", origin=f"obs-proc-{i}",
                                      ring_size=2 * per, registry=reg,
                                      clock=lambda c=clocks[i]: c[0])
                for i in range(OBS_EXECUTORS)]
    for k in range(per):
        for i, j in enumerate(journals):
            clocks[i][0] += float(rng.integers(0, 3)) / 1000.0
            j.emit(kinds[(k + i) % len(kinds)], executor=f"obs-exec-{(k + i) % 8}", beat=k)
    beats = []
    for j in journals:
        events, prev = j.events(), []
        for lo in range(0, len(events), OBS_JOURNAL_BATCH):
            fresh = events[lo:lo + OBS_JOURNAL_BATCH]
            beats.append(prev + fresh)
            prev = fresh
    jhub = _journal.JournalHub(reg, role="obs-hub", ring_size=2 * OBS_JOURNAL_EVENTS)
    t = time.perf_counter()
    for b in beats:
        jhub.ingest(b)
    merge_s = time.perf_counter() - t
    merged = [e for e in jhub.merged() if e["origin"].startswith("obs-proc-")]
    keys = [_journal.sort_key(e) for e in merged]
    jsum = jhub.summary()
    out["journal"] = {"events": len(merged), "shipped": sum(len(b) for b in beats),
                      "beats": len(beats), "merge_s": merge_s,
                      "us_per_event": merge_s * 1e6 / OBS_JOURNAL_EVENTS,
                      "duplicates": jsum["duplicates"], "gaps": jsum["gaps"]}
    if (len(merged) != OBS_JOURNAL_EVENTS or keys != sorted(keys)
            or len(set(keys)) != len(keys) or jsum["gaps"]):
        raise AssertionError(f"(a) the merged journal: {out['journal']}")
    return out


def _obs_cluster(n):
    """(c) ``ClusterContext``'s 4 workers at phase 14 (d)'s shape, each
    worker's first READ failing once (``OBS_CLUSTER_KNOBS``): the poll
    loop must build a series for every worker and carry the workers'
    circuit events into the driver's merged journal. Then rounds of the
    poll loop's request to every worker, timed."""
    from sparkrdma_tpu_torch.testing import faults

    try:
        cc, startup = _en_cluster(OBS_CLUSTER_KNOBS)
        try:
            parts, keys, wall = _en_cluster_job(cc, n)
            hub = cc.driver.telemetry
            ids = sorted(w.executor_id for w in cc.workers)
            t = time.perf_counter()
            deadline = t + OBS_DEADLINE_S
            while True:
                events = [e for e in hub.journal.merged() if e.get("role") in ids]
                have = hub.executors()
                if (have == ids and all(len(hub.series(e)) for e in ids) and events) \
                        or time.perf_counter() > deadline:
                    break
                time.sleep(0.05)
            waited = time.perf_counter() - t
            pull_ms = []
            for _ in range(OBS_PULL_ROUNDS):
                t = time.perf_counter()
                for w in cc.workers:
                    for p in w.request({"kind": "telemetry"}, timeout_s=10.0) or []:
                        hub.ingest(p)
                pull_ms.append((time.perf_counter() - t) * 1e3)
            summary = hub.summary()
            poll = cc._telemetry_thread
        finally:
            cc.stop()
    finally:
        faults.uninstall()
    _en_check_ranges(parts, keys, "(c)")
    kinds = {}
    for e in events:
        kinds[e["kind"]] = kinds.get(e["kind"], 0) + 1
    out = {"records": len(keys), "knobs": OBS_CLUSTER_KNOBS, "startup_s": startup,
           "job_s": wall, "waited_s": waited,
           "windows": {e: v["windows"] for e, v in summary["executors"].items()},
           "worker_events": kinds,
           "worker_event_roles": sorted({e["role"] for e in events}),
           "pull_round_ms": pull_ms, "pull_round_ms_p50": float(np.median(pull_ms)),
           "poll_thread_joined": poll is not None and not poll.is_alive()}
    if have != ids or not all(out["windows"].get(e) for e in ids):
        raise AssertionError(f"(c) the poll loop built series for {out['windows']}, not {ids}")
    if not events:
        raise AssertionError("(c) no worker event reached the driver's merged journal")
    if not out["poll_thread_joined"]:
        raise AssertionError("(c) stop() did not join the poll loop")
    return out


def _obs_wave_pulls(torch, dev, data):
    """(d) Phase 10 (b)'s default run under the hub: the 1 GiB keys
    through a driver and 8 executors (python plane, default knobs), the
    stage reduced twice so the wave tuner sees one shape twice. It runs
    as phase 10 (b) ran, before any engine job had published a
    breakdown; the breakdown gate's verdict on the last engine job's
    breakdown is read after. The journal's ``autotune.adjust`` events of
    these executors must equal their tuners' adjustment counters, the
    wave launches phase 10 (b)'s, every reducer ``np.sort`` of its
    range."""
    from sparkrdma_tpu_torch.models.terasort import MapShardSorter
    from sparkrdma_tpu_torch.obs import attr, get_registry
    from sparkrdma_tpu_torch.shuffle.autotune import WaveAutoTuner
    from sparkrdma_tpu_torch.shuffle.device_io import DeviceShuffleIO
    from sparkrdma_tpu_torch.shuffle.handle import BaseShuffleHandle, HashPartitioner
    from sparkrdma_tpu_torch.shuffle.manager import TpuShuffleManager
    from sparkrdma_tpu_torch.utils.config import TpuShuffleConf

    shards, edges, want = data
    reg = get_registry()
    sid = 16
    conf = TpuShuffleConf({**PY_PLANE, **HOST_PLANE_KNOBS})
    ids = [f"obs-{e}" for e in range(EXECUTORS)]
    engine_bd = attr.last_breakdown()
    attr.publish_breakdown(None)
    driver = TpuShuffleManager(conf, is_driver=True)
    execs = [TpuShuffleManager(conf, is_driver=False, executor_id=i) for i in ids]
    ios = [DeviceShuffleIO(ex, device=dev) for ex in execs]
    try:
        if driver.telemetry is None:
            raise AssertionError("(d) the driver built no telemetry hub")
        driver.register_shuffle(BaseShuffleHandle(
            shuffle_id=sid, num_maps=EXECUTORS, partitioner=HashPartitioner(REDUCERS)))
        sorter = MapShardSorter(dev)
        map_s, _, _, _ = _hp_map_phase(torch, dev, sorter, ios, shards, edges, sid)
        adj0 = sum(reg.counter("collective.autotune_adjustments", role=i).value for i in ids)
        l0 = _wave_launches()
        cold = _hp_reduce_all(torch, dev, ios, sid, want)[0]
        warm = _hp_reduce_all(torch, dev, ios, sid, want)[0]
        launches = [x - y for x, y in zip(_wave_launches(), l0)]
        adjusts = sum(reg.counter("collective.autotune_adjustments", role=i).value
                      for i in ids) - adj0
        events = driver.telemetry.journal.merged(kinds=["autotune.adjust"])
        events = [e for e in events if e.get("role") in ids]
        hub_summary = driver.telemetry.summary()
    finally:
        attr.publish_breakdown(engine_bd)
        for io in ios:
            io.stop()
        for ex in execs:
            ex.stop()
        driver.stop()
    gate = {"engine_breakdown": engine_bd is not None}
    if engine_bd is not None:
        fraction, transfer = attr.dma_wave_signal(engine_bd)
        gate.update(dma_wave_fraction=fraction, transfer_gap_frames=transfer,
                    allows=WaveAutoTuner(conf, "obs-gate")._breakdown_allows())
    p10 = _REPORTS.get(10, {}).get("default", {}).get("wave_launches")
    out = {"keys": KEYS, "executors": EXECUTORS, "map_s": map_s, "reduce_cold_s": cold,
           "reduce_warm_s": warm, "wave_launches": launches,
           "phase10_default_wave_launches": p10,
           "autotune_adjust_events": len(events), "autotune_adjustments": adjusts,
           "events": [{"role": e["role"], **e.get("attrs", {})} for e in events],
           "gate_on_last_engine_breakdown": gate,
           "hub_journal": hub_summary["journal"]}
    if len(events) != adjusts:
        raise AssertionError(f"(d) {len(events)} autotune.adjust events for {adjusts} "
                             "adjustments")
    if p10 is not None and launches != p10:
        raise AssertionError(f"(d) wave launches {launches}, phase 10 (b)'s {p10}")
    if launches[1] <= 0:
        raise AssertionError("(d) the pipelined wave-pull kernel never launched")
    return out


def phase_operations_planes(torch, dev, data):
    """Phase 16: the telemetry and journal plane on the card's host. (a)
    the hub alone on synthetic heartbeats and a 10,000-event journal
    merge; (b) phase 14 (b)'s job once with ``obs.telemetry.enabled=false``
    beside phase 14 (b)'s run with the hub on, and what the hub held
    then; (c) ``ClusterContext``'s poll loop and the workers' journals;
    (d) phase 10 (b)'s wave pulls under the hub, the tuner's journal
    events against its counters."""

    os.environ["PYTHONPATH"] = os.pathsep.join(
        [HERE] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p])
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    _reset_launches()
    report = {"card": smi}
    t = time.perf_counter()
    report["a"] = _obs_hub_alone()
    report["a"]["seconds"] = time.perf_counter() - t

    # ---- (b) the engine job with the hub off, beside phase 14 (b)'s
    p14 = _REPORTS.get(14, {}).get("b")
    n = EN_RECORDS
    if p14 is not None and p14["wall_s"] > OBS_B_BUDGET_S:
        n = EN_TENTH
    keys = np.random.default_rng(EN_SEED).integers(0, 1 << 32, n, dtype=np.uint64)
    t = time.perf_counter()
    off = _en_terasort(keys, {"tpu.shuffle.obs.telemetry.enabled": "false"})
    del keys
    report["b"] = {"records": n, "cut": None if n == EN_RECORDS else
                   f"a tenth: phase 14 (b) took {p14['wall_s']:.1f} s",
                   "hub_off_wall_s": off["wall_s"], "hub_off_records_per_s": off["records_per_s"],
                   "hub_off_telemetry": off["telemetry_hub"],
                   "seconds": time.perf_counter() - t}
    if p14 is not None:
        on = p14["telemetry_hub"]
        report["b"].update(
            phase14_hub_on_wall_s=p14["wall_s"],
            hub_cost_s=p14["wall_s"] - off["wall_s"] if n == EN_RECORDS else None,
            phase14_hub=on)
        if on is None or len(on["executors"]) != EN_EXECUTORS or on["missed_heartbeats"]:
            raise AssertionError(f"(b) phase 14 (b)'s hub: {on}")
    if off["telemetry_hub"] is not None:
        raise AssertionError("(b) the hub ran with obs.telemetry.enabled=false")

    # ---- (c) the cluster's poll loop and the workers' journals
    t = time.perf_counter()
    report["c"] = _obs_cluster(EN_TENTH)
    report["c"]["seconds"] = time.perf_counter() - t

    # ---- (d) phase 10 (b)'s wave pulls under the hub
    _reset_launches()
    t = time.perf_counter()
    report["d"] = _obs_wave_pulls(torch, dev, data)
    report["d"]["seconds"] = time.perf_counter() - t
    launched = {k: v for k, v in _all_counts().items()
                if v and k not in ("srt_wave_pull", "srt_pipelined_wave_pull")}
    if launched:
        raise AssertionError(f"phase 16 launched other kernels: {launched}")
    counts = {"srt_wave_pull": _launched("srt_wave_pull"),
              "srt_pipelined_wave_pull": _launched("srt_pipelined_wave_pull")}
    emit(16, name="operations_planes", launches=counts, seconds=time.perf_counter() - t0,
         **report)
    return counts


# ----------------------------------------------------------------------
# phase 17: the elastic plane, the obs CLI and the invariant suite
# ----------------------------------------------------------------------
EL_REPLICAS = {"tpu.shuffle.elastic.replicas": "1"}
EL_KILL = "exec:kill:1:peer=proc-exec-1,stage=reduce_task"
EL_SERVICE_ID = "svc-17"
EL_FILLER = b"x" * 84  # a record's value: map id (2 bytes), row (4), filler: 90 bytes
EL_DEADLINE_S = 30.0
EL_ANALYSIS_MIN_FILES = 150  # the port's package and tests held 163 files when this was set
EL_COUNTERS = ("elastic.replicated_bytes", "elastic.replicated_maps", "elastic.replica_accepts",
               "elastic.replica_drops", "elastic.replica_errors")
# the obs CLI's flags in (f), each over an artifact of (a)-(d) ("{dir}")
EL_CLI = {
    "openmetrics": ["--openmetrics", "-", "--from-snapshot", "{dir}/snapshot.json"],
    "timeline": ["--timeline", "{dir}/flight.json"],
    "diagnose": ["--diagnose", "{dir}/flight.json"],
    "critical_path": ["--critical-path", "{dir}/trace.json"],
    "flamegraph": ["--flamegraph", "{dir}/flame.html", "--from-snapshot", "{dir}/flight.json"],
    "flight_recorder": ["--flight-recorder", "{dir}/flight.json"],
    "demo": ["--demo", "--trace-out", "{dir}/demo_trace.json", "--indent", "0"],
}
CLI_PROBE = "CLI_PROBE "
# runs ``python -m <argv[1]> <argv[2:]>`` and, at exit, prints which
# jax modules the child loaded and whether it initialised CUDA
_CLI_WRAPPER = """\
import atexit, json, runpy, sys
def _probe():
    t = sys.modules.get("torch")
    print(%r + json.dumps({
        "jax": sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
                      or m == "sparkrdma_tpu" or m.startswith("sparkrdma_tpu.")),
        "cuda_initialized": bool(t is not None and t.cuda.is_initialized())}),
        file=sys.stderr, flush=True)
atexit.register(_probe)
sys.argv = sys.argv[1:]
runpy.run_module(sys.argv[0], run_name="__main__", alter_sys=True)
""" % CLI_PROBE


def _cli_env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [HERE] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    return env


def start_obs_cli(args, module="sparkrdma_tpu_torch.obs"):
    """Start ``python -m <module> <args>`` as a child process from the
    checkout root; :func:`finish_obs_cli` collects it."""
    return subprocess.Popen([sys.executable, "-c", _CLI_WRAPPER, module, *args], cwd=HERE,
                            env=_cli_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def finish_obs_cli(proc, timeout=240):
    """The child's exit code, standard output and error, and what it
    loaded: ``{"jax": [...], "cuda_initialized": bool}`` (None when the
    child died before its exit handlers ran)."""
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    lines = [ln for ln in err.splitlines() if ln.startswith(CLI_PROBE)]
    probe = json.loads(lines[-1][len(CLI_PROBE):]) if lines else None
    return proc.returncode, out, err, probe


def obs_cli(args, module="sparkrdma_tpu_torch.obs", timeout=240):
    """``python -m <module> <args>`` in a child process (see
    :func:`finish_obs_cli`)."""
    return finish_obs_cli(start_obs_cli(args, module), timeout)


def _el_map_fn(seed, m, n):
    """A map function making map ``m``'s keys in the worker; each
    record's value names its map and row, so a record read twice or
    read from the wrong copy changes the output's bytes."""
    def fn():
        keys = np.random.default_rng(seed).integers(0, 1 << 32, n, dtype=np.uint64)
        head = m.to_bytes(2, "big")
        return ((int(k), head + i.to_bytes(4, "big") + EL_FILLER) for i, k in enumerate(keys))

    return fn


def _el_digest_fn(edges, counters=EL_COUNTERS):
    """A reduce function: the records sorted, their count and SHA-256
    (each record its key's 8 big-endian bytes, then its value), the
    partitions they fall in, and the worker's totals of ``counters``."""
    def fn(it):
        import bisect
        import hashlib as _hashlib

        from sparkrdma_tpu_torch.obs import get_registry

        recs = sorted(it)
        h = _hashlib.sha256()
        for k, v in recs:
            h.update(k.to_bytes(8, "big"))
            h.update(v)
        reg = get_registry()
        return {"count": len(recs), "sha": h.hexdigest(),
                "parts": sorted({bisect.bisect_left(edges, k) for k, _ in recs}),
                "counters": {c: sum(reg.snapshot(prefix=c)["counters"].values())
                             for c in counters}}

    return fn


def _el_expected(n):
    """What ``n`` records of ``_el_map_fn`` must come out as: per
    partition, the count and the SHA-256 of its records sorted, computed
    from ``np.sort`` of the generator's keys (numpy, no engine)."""
    import hashlib

    per, keys = _en_keys(n)
    m = np.repeat(np.arange(EN_MAPS, dtype=np.uint64), per)
    i = np.tile(np.arange(per, dtype=np.uint64), EN_MAPS)
    order = np.lexsort((i, m, keys))
    keys, m, i = keys[order], m[order], i[order]
    rows = np.empty((len(keys), 8 + 6 + len(EL_FILLER)), np.uint8)
    rows[:, :8] = keys.astype(">u8").view(np.uint8).reshape(-1, 8)
    rows[:, 8:10] = m.astype(">u2").view(np.uint8).reshape(-1, 2)
    rows[:, 10:14] = i.astype(">u4").view(np.uint8).reshape(-1, 4)
    rows[:, 14:] = np.frombuffer(EL_FILLER, np.uint8)
    cuts = np.searchsorted(keys, np.asarray(EN_EDGES, np.uint64), side="left")
    bounds = [0, *cuts.tolist(), len(keys)]
    return rows, bounds


def _el_check(parts, expected, what):
    """Each reducer's records byte-equal to the expected records of the
    partitions it read; every partition read once."""
    rows, bounds = expected
    seen = []
    for r, p in enumerate(parts):
        if not p["count"]:
            continue
        lo, hi = bounds[p["parts"][0]], bounds[p["parts"][-1] + 1]
        if (p["count"], p["sha"]) != (hi - lo, hashlib.sha256(rows[lo:hi].tobytes()).hexdigest()):
            raise AssertionError(f"{what} reducer {r}: its records differ from np.sort of "
                                 "the generator's keys")
        seen.extend(p["parts"])
    if sorted(seen) != list(range(len(bounds) - 1)) or len(seen) != len(set(seen)):
        raise AssertionError(f"{what}: partitions read twice or missing: {seen}")


def _el_instrument(cc):
    """Time ``cc``'s map-stage calls and note when its driver first sees
    a dead worker."""
    marks = {"map_s": [], "dead_at": None}
    run_map, reap = cc._run_map_phase, cc._reap_dead

    def timed_map(handle, items, tenant, recompute):
        t = time.perf_counter()
        try:
            return run_map(handle, items, tenant, recompute)
        finally:
            marks["map_s"].append({"recompute": recompute, "s": time.perf_counter() - t})

    def noted_reap():
        dead = reap()
        if dead and marks["dead_at"] is None:
            marks["dead_at"] = time.perf_counter()
        return dead

    cc._run_map_phase = timed_map
    cc._reap_dead = noted_reap
    return marks


def _el_job(n, knobs, expected, what, keep=None):
    """One range-partitioned job of ``n`` records through 4 worker
    processes (``_el_map_fn``, ``_el_digest_fn``), checked byte for byte
    against ``expected``. ``keep(cc)`` runs before the context stops.
    Returns the walls, the driver's and the workers' elastic counters."""
    from sparkrdma_tpu_torch.obs import get_registry
    from sparkrdma_tpu_torch.shuffle.handle import RangePartitioner
    from sparkrdma_tpu_torch.testing import faults

    reg = get_registry()
    names = ("elastic.recomputed_maps", "elastic.recoveries", "elastic.replica_promotions",
             "metastore.adoptions")
    before = {c: reg.counter(c, role="driver").value for c in names}
    recomputes = reg.counter("engine.stage_recomputes")
    r0 = recomputes.value
    per = n // EN_MAPS
    kept = None
    try:
        cc, startup = _en_cluster(knobs)
        try:
            marks = _el_instrument(cc)
            t = time.perf_counter()
            parts = cc.run_map_reduce(
                [_el_map_fn(EN_MAP_SEED + m, m, per) for m in range(EN_MAPS)],
                num_partitions=EN_PARTS, partitioner=RangePartitioner(EN_EDGES),
                reduce_fn=_el_digest_fn(EN_EDGES))
            end = time.perf_counter()
            live = sorted(w.executor_id for w in cc.workers)
            # read before stop(): the workers' exits are peer losses too
            driver = {c: reg.counter(c, role="driver").value - before[c] for c in names}
            stage_recomputes = recomputes.value - r0
            if keep is not None:
                kept = keep(cc)
        finally:
            cc.stop()
    finally:
        faults.uninstall()
    _el_check(parts, expected, what)
    first_map = next(m["s"] for m in marks["map_s"] if not m["recompute"])
    out = {"records": n, "knobs": knobs, "startup_s": startup, "job_s": end - t,
           "map_stage_s": first_map,
           "recovery_map_calls": [m for m in marks["map_s"] if m["recompute"]],
           "recovery_s": None if marks["dead_at"] is None else end - marks["dead_at"],
           "live_after": live, "driver": driver, "stage_recomputes": stage_recomputes,
           "workers": {c: sum(p["counters"][c] for p in parts) for c in EL_COUNTERS}}
    return out, kept


def _el_artifacts(cc, tmp):
    """Keep the driver's flight record (with the workers' profile
    windows and the journal) of a cluster job for (f)."""
    hub = cc.driver.telemetry
    deadline = time.perf_counter() + EL_DEADLINE_S
    while not hub.profiles.total_samples:
        if time.perf_counter() > deadline:
            raise AssertionError(f"(a) no profile window within {EL_DEADLINE_S} s")
        time.sleep(0.05)
    path = hub.flight_record("phase17_exec_kill", path=os.path.join(tmp, "flight.json"))
    if path is None:
        raise AssertionError("(a) the driver's hub wrote no flight record")
    with open(path) as f:
        doc = json.load(f)
    return {"journal_events": len(doc.get("journal") or []),
            "profiles": sorted(doc.get("profiles") or {}), "slo": "slo" in doc}


def _el_replication(tmp):
    """(a) HiBench TeraSort small through 4 worker processes: without
    replicas, with ``elastic.replicas=1``, and with it and ``exec:kill``
    of proc-exec-1 at its first reduce."""
    expected = _el_expected(EN_RECORDS)
    plain, _ = _el_job(EN_RECORDS, dict(EN_KNOBS), expected, "(a) no replicas")
    rep, _ = _el_job(EN_RECORDS, {**EN_KNOBS, **EL_REPLICAS}, expected, "(a) replicas")
    kill, flight = _el_job(
        EN_RECORDS, {**EN_KNOBS, **EL_REPLICAS, **EN_LOST_KNOBS,
                     "tpu.shuffle.faultPlan": EL_KILL},
        expected, "(a) replicas, exec:kill", keep=lambda cc: _el_artifacts(cc, tmp))
    del expected
    report = {"no_replicas": plain, "replicas": rep, "replicas_exec_kill": kill,
              "flight_record": flight,
              "replication_cost_map_s": rep["map_stage_s"] - plain["map_stage_s"],
              "replication_cost_job_s": rep["job_s"] - plain["job_s"],
              "loss_cost_job_s": kill["job_s"] - rep["job_s"]}
    p14 = _REPORTS.get(14, {}).get("e", {}).get("exec_kill")
    if p14 is not None:
        report["phase14_exec_kill_no_replicas_tenth"] = {
            k: p14[k] for k in ("records", "job_s", "recoveries", "recomputed_maps")}
    if rep["workers"]["elastic.replicated_bytes"] <= 0 or rep["workers"]["elastic.replica_errors"]:
        raise AssertionError(f"(a) replication: {rep['workers']}")
    if plain["workers"]["elastic.replicated_bytes"]:
        raise AssertionError("(a) bytes were replicated with elastic.replicas=0")
    if plain["driver"]["elastic.replica_promotions"] or rep["driver"]["elastic.replica_promotions"]:
        raise AssertionError("(a) a replica was promoted in a run that lost no executor")
    d = kill["driver"]
    if d["elastic.recomputed_maps"] or kill["stage_recomputes"]:
        raise AssertionError(f"(a) exec:kill under replicas recomputed maps: {d}")
    if d["elastic.replica_promotions"] <= 0 or "proc-exec-1" in kill["live_after"]:
        raise AssertionError(f"(a) exec:kill: no promotion, or proc-exec-1 lived: {kill}")
    if kill["recovery_s"] is None:
        raise AssertionError("(a) exec:kill: the driver never saw a dead worker")
    return report


def _el_inprocess():
    """(b) ``TpuContext`` with ``elastic.replicas=1`` at a tenth: a
    materialized sort read, ``lose_executor("exec-1")``, and read again."""
    from sparkrdma_tpu_torch.obs import get_registry

    reg = get_registry()
    keys = np.random.default_rng(EN_SEED).integers(0, 1 << 32, EN_TENTH, dtype=np.uint64)
    data = [(int(k), EN_PAYLOAD) for k in keys]
    recomputes = reg.counter("engine.stage_recomputes")
    with _en_ctx({**EL_REPLICAS, **EN_LOST_KNOBS}) as ctx:
        promos = reg.counter("elastic.replica_promotions", role=ctx.driver.executor_id)
        rdd = _en_sort(ctx, data)
        t = time.perf_counter()
        first = rdd.collect()
        first_s = time.perf_counter() - t
        r0, p0 = recomputes.value, promos.value
        ctx.lose_executor("exec-1")
        t = time.perf_counter()
        again = rdd.collect()
        again_s = time.perf_counter() - t
        survivors = [m.executor_id for m in ctx.executors]
    _en_check_sorted(first, keys, "(b)")
    out = {"records": EN_TENTH, "first_read_s": first_s, "reread_after_loss_s": again_s,
           "survivors": survivors, "stage_recomputes": recomputes.value - r0,
           "replica_promotions": promos.value - p0}
    if again != first:
        raise AssertionError("(b) the re-read after the loss differs from the first read")
    if out["stage_recomputes"] or out["replica_promotions"] <= 0 or survivors != ["exec-0"]:
        raise AssertionError(f"(b) {out}")
    p14 = _REPORTS.get(14, {}).get("c")
    if p14 is not None:
        out["phase14_lost_executor_reread_s"] = p14["lost_executor_reread_s"]
    return out


def _el_chaos():
    """(c) The chaos bar at a tenth: ``driver:kill`` at reduce-phase
    entry, then ``exec:kill`` of proc-exec-1 at its first reduce, under
    ``elastic.replicas=1``: zero recompute, adoptions and promotions."""
    expected = _el_expected(EN_TENTH)
    out, _ = _el_job(EN_TENTH, {**EN_KNOBS, **EL_REPLICAS, **EN_LOST_KNOBS,
                                "tpu.shuffle.faultPlan":
                                    f"driver:kill:1:stage=reduce_phase;{EL_KILL}"},
                     expected, "(c)")
    d = out["driver"]
    if d["elastic.recomputed_maps"] or out["stage_recomputes"]:
        raise AssertionError(f"(c) maps recomputed: {out}")
    if d["metastore.adoptions"] <= 0 or d["elastic.replica_promotions"] <= 0:
        raise AssertionError(f"(c) no adoption or no promotion: {d}")
    return out


def _el_service(tmp):
    """(d) The daemon: ``python -m sparkrdma_tpu_torch.elastic.service``
    adopts proc-exec-0's maps (4 workers, a tenth, ``transport=auto``);
    the reads before the handoff, after it and after proc-exec-0's
    SIGKILL are the same bytes."""
    import glob
    import tempfile

    from sparkrdma_tpu_torch.elastic.service import _recv_obj, _send_obj
    from sparkrdma_tpu_torch.shuffle.handle import BaseShuffleHandle, RangePartitioner

    def ask(port, obj):
        import socket

        with socket.create_connection(("127.0.0.1", port), timeout=10) as s:
            s.settimeout(10)
            _send_obj(s, obj)
            return _recv_obj(s)

    expected = _el_expected(EN_TENTH)
    per = EN_TENTH // EN_MAPS
    report = {"records": EN_TENTH, "transport": "auto"}
    svc = None
    cc, startup = _en_cluster({"tpu.shuffle.transport": "auto", **EN_LOST_KNOBS})
    try:
        handle = BaseShuffleHandle(shuffle_id=cc._next_shuffle_id(), num_maps=EN_MAPS,
                                   partitioner=RangePartitioner(EN_EDGES))
        cc.driver.register_shuffle(handle)
        items = [(m, _el_map_fn(EN_MAP_SEED + m, m, per)) for m in range(EN_MAPS)]
        t = time.perf_counter()
        cc._run_map_phase(handle, items, "default", recompute=False)
        report["map_stage_s"] = time.perf_counter() - t
        mine = sorted(m for m, e in cc.driver.map_owners(handle.shuffle_id).items()
                      if e == "proc-exec-0")

        def read_all(worker, what):
            got = worker.request({"kind": "reduce", "handle": handle, "start": 0,
                                  "end": EN_PARTS, "reduce_fn": _el_digest_fn(EN_EDGES, ()),
                                  "tenant": "default"})
            _el_check([got], expected, what)
            return got["sha"]

        base = read_all(cc.workers[1], "(d) before the handoff")
        t = time.perf_counter()
        svc = subprocess.Popen(
            [sys.executable, "-m", "sparkrdma_tpu_torch.elastic.service",
             "--service-id", EL_SERVICE_ID, "--conf", json.dumps(cc.conf.to_dict())],
            cwd=HERE, env=_cli_env(), stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
            text=True)
        port = None
        while port is None:
            line = svc.stdout.readline()
            if not line:
                raise AssertionError("(d) the daemon exited before it announced its port")
            if line.startswith("SERVICE_PORT "):
                port = int(line.split()[1])
        report["daemon_start_s"] = time.perf_counter() - t
        if ask(port, {"kind": "ping"}).get("result") != "pong":
            raise AssertionError("(d) the daemon did not answer its ping")
        t = time.perf_counter()
        adopted = cc.workers[0].request({"kind": "handoff", "service": ("127.0.0.1", port)})
        report["handoff_s"] = time.perf_counter() - t
        files = sorted(glob.glob(os.path.join(tempfile.gettempdir(),
                                              f"tpu-shuffle-svc-{EL_SERVICE_ID}-*",
                                              f"shuffle_{handle.shuffle_id}_*.data")))
        maps = sorted(int(os.path.basename(f)[:-5].rsplit("_", 1)[1]) for f in files)
        links = [os.stat(f).st_nlink for f in files]
        report.update(adopted=adopted, exec0_maps=mine, daemon_maps=maps,
                      adopted_bytes=sum(os.path.getsize(f) for f in files),
                      linked=sum(1 for n in links if n > 1),
                      copied=sum(1 for n in links if n == 1))
        if adopted != len(mine) or maps != mine or not mine:
            raise AssertionError(f"(d) adopted {adopted} maps {maps}, proc-exec-0's are {mine}")
        parked = read_all(cc.workers[1], "(d) after the handoff")
        w0 = cc.workers[0]
        w0.proc.kill()
        w0.proc.wait(timeout=10)
        dead = [w.executor_id for w in cc._reap_dead()]
        t = time.perf_counter()
        served = read_all(cc.workers[0], "(d) from the daemon")
        report["read_after_kill_s"] = time.perf_counter() - t
        report["dead"] = dead
        if dead != ["proc-exec-0"] or not (base == parked == served):
            raise AssertionError(f"(d) the reads differ, or the wrong worker died: {report}")
        if not ask(port, {"kind": "stop"}).get("ok"):
            raise AssertionError("(d) the daemon refused to stop")
        report["daemon_exit"] = svc.wait(timeout=15)
        svc = None
        if report["daemon_exit"] != 0:
            raise AssertionError(f"(d) the daemon exited {report['daemon_exit']}")
    finally:
        if svc is not None:
            svc.kill()
            svc.wait(timeout=10)
        cc.stop()
    report["startup_s"] = startup
    return report


def _el_lock_order(torch, dev, data):
    """(e) Phase 10 (b)'s default run with the port's lock-order detector
    enabled: the map, then the stage reduced cold and warm, then warm
    again with the detector off; then ``python -m
    sparkrdma_tpu_torch.analysis`` on the checkout."""
    from sparkrdma_tpu_torch.analysis import lockorder
    from sparkrdma_tpu_torch.models.terasort import MapShardSorter
    from sparkrdma_tpu_torch.shuffle.device_io import DeviceShuffleIO
    from sparkrdma_tpu_torch.shuffle.handle import BaseShuffleHandle, HashPartitioner
    from sparkrdma_tpu_torch.shuffle.manager import TpuShuffleManager
    from sparkrdma_tpu_torch.utils.config import TpuShuffleConf

    shards, edges, want = data
    sid = 17
    det = lockorder.default
    conf = TpuShuffleConf({**PY_PLANE, **HOST_PLANE_KNOBS})
    ids = [f"lo-{e}" for e in range(EXECUTORS)]
    det.reset()
    det.enable()
    try:
        driver = TpuShuffleManager(conf, is_driver=True)
        execs = [TpuShuffleManager(conf, is_driver=False, executor_id=i) for i in ids]
        ios = [DeviceShuffleIO(ex, device=dev) for ex in execs]
        try:
            driver.register_shuffle(BaseShuffleHandle(
                shuffle_id=sid, num_maps=EXECUTORS, partitioner=HashPartitioner(REDUCERS)))
            map_s, _, _, _ = _hp_map_phase(torch, dev, MapShardSorter(dev), ios, shards,
                                           edges, sid)
            l0 = _wave_launches()
            cold = _hp_reduce_all(torch, dev, ios, sid, want)[0]
            warm = _hp_reduce_all(torch, dev, ios, sid, want)[0]
            launches = [x - y for x, y in zip(_wave_launches(), l0)]
            det.disable()
            off = _hp_reduce_all(torch, dev, ios, sid, want)[0]
        finally:
            for io in ios:
                io.stop()
            for ex in execs:
                ex.stop()
            driver.stop()
    finally:
        det.disable()
    edges_seen = sorted(f"{a} -> {b}" for a, bs in det.edges.items() for b in bs)
    names = sorted(set(det.edges) | {b for bs in det.edges.values() for b in bs})
    p10 = _REPORTS.get(10, {}).get("default", {})
    out = {"keys": KEYS, "executors": EXECUTORS, "map_s": map_s, "reduce_cold_s": cold,
           "reduce_warm_s": warm, "reduce_warm_detector_off_s": off,
           "detector_cost_warm_s": warm - off, "wave_launches": launches,
           "phase10_default_wave_launches": p10.get("wave_launches"),
           "phase10_reduce_cold_warm_s": [p10.get("reduce_cold_s"), p10.get("reduce_warm_s")],
           "lock_names": names, "order_edges": edges_seen, "violations": list(det.violations)}
    if det.violations:
        raise AssertionError(f"(e) lock-order violations: {det.violations}")
    if not edges_seen:
        raise AssertionError("(e) the detector recorded no lock order")
    if p10.get("wave_launches") is not None and launches != p10["wave_launches"]:
        raise AssertionError(f"(e) wave launches {launches}, phase 10 (b)'s "
                             f"{p10['wave_launches']}")
    if launches[1] <= 0:
        raise AssertionError("(e) the pipelined wave-pull kernel never launched")
    t = time.perf_counter()
    rc_, text, err, probe = obs_cli([], module="sparkrdma_tpu_torch.analysis")
    out["analysis"] = {"rc": rc_, "stdout": text.strip(), "seconds": time.perf_counter() - t,
                       "probe": probe}
    files = re.match(r"analysis: clean \((\d+) files", text)
    if rc_ != 0 or files is None or int(files.group(1)) < EL_ANALYSIS_MIN_FILES:
        raise AssertionError(f"(e) python -m sparkrdma_tpu_torch.analysis: rc {rc_}\n{text}\n"
                             f"{err[-2000:]}")
    return out


def _el_obs_cli(tmp):
    """(f) The obs CLI as child processes over (a)-(d)'s artifacts, all
    started together: each exits 0 with output, and none loads jax or
    initialises CUDA."""
    from sparkrdma_tpu_torch.obs import export_chrome_trace, get_registry

    export_chrome_trace(os.path.join(tmp, "trace.json"))
    with open(os.path.join(tmp, "snapshot.json"), "w") as f:
        json.dump({"obs_registry": get_registry().snapshot()}, f)
    t = time.perf_counter()
    procs = {name: start_obs_cli([a.format(dir=tmp) for a in args])
             for name, args in EL_CLI.items()}
    out = {}
    for name, p in procs.items():
        rc_, text, err, probe = finish_obs_cli(p)
        if name == "flamegraph":
            with open(os.path.join(tmp, "flame.html")) as f:
                text += f.read()
        out[name] = {"rc": rc_, "bytes": len(text), "first_line": text.split("\n", 1)[0][:160],
                     "probe": probe}
        if rc_ != 0 or not text.strip():
            raise AssertionError(f"(f) {name}: rc {rc_}, {len(text)} bytes\n{err[-2000:]}")
        if probe is None or probe["jax"] or probe["cuda_initialized"]:
            raise AssertionError(f"(f) {name} loaded jax or initialised CUDA: {probe}")
    out["seconds"] = time.perf_counter() - t
    return out


def phase_elastic_planes(torch, dev, data):
    """Phase 17: the elastic plane, the obs CLI and the invariant suite on
    the card's host. (a) Replication in cluster mode at HiBench TeraSort
    small; (b) an in-process executor loss under replication; (c) the
    chaos bar (``driver:kill``, then ``exec:kill``); (d) the
    shuffle-service daemon; (e) phase 10 (b)'s wave pulls under the
    lock-order detector, and the static passes; (f) the obs CLI."""
    import shutil
    import tempfile


    os.environ["PYTHONPATH"] = _cli_env()["PYTHONPATH"]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    _reset_launches()
    report = {"card": smi}
    tmp = tempfile.mkdtemp(prefix="phase17-")
    try:
        for key, run in (("a", lambda: _el_replication(tmp)), ("b", _el_inprocess),
                         ("c", _el_chaos), ("d", lambda: _el_service(tmp))):
            t = time.perf_counter()
            report[key] = run()
            report[key]["seconds"] = time.perf_counter() - t
        launched = {k: n for k, n in _all_counts().items() if n}
        if launched:
            raise AssertionError(f"(a)-(d) launched kernels: {launched}")
        t = time.perf_counter()
        report["e"] = _el_lock_order(torch, dev, data)
        report["e"]["seconds"] = time.perf_counter() - t
        t = time.perf_counter()
        report["f"] = _el_obs_cli(tmp)
        report["f"]["seconds"] = time.perf_counter() - t
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    launched = {k: v for k, v in _all_counts().items()
                if v and k not in ("srt_wave_pull", "srt_pipelined_wave_pull")}
    if launched:
        raise AssertionError(f"phase 17 launched other kernels: {launched}")
    counts = {"srt_wave_pull": _launched("srt_wave_pull"),
              "srt_pipelined_wave_pull": _launched("srt_pipelined_wave_pull")}
    emit(17, name="elastic_planes", launches=counts, seconds=time.perf_counter() - t0,
         **report)
    return counts


# ----------------------------------------------------------------------
# phase 18: the model checker on the card's host, two ranks on the card,
# and the live schedule-point seam on the device path
# ----------------------------------------------------------------------
MC_MODULE = "sparkrdma_tpu_torch.analysis.modelcheck"
MC_MODELS = ("merge_seal", "meta_lease", "quota_stall", "replica_promotion", "speculation")
MC_WALKS = 25  # the CI smoke's walks (python -m ... --walks 25)
MC_MAX_SCHEDULES = 2000  # the nightly's bound (python -m ... --exhaustive --max-schedules 2000)
MC_MUTANTS = 18
MC_TIMEOUT_S = 300
RK_RANKS = 2
RK_SHARDS = 4  # shards a rank holds on the one card: E = 8, phase 9's mesh
RK_CALLS = 6  # one cold call and five warm a schedule
RK_TIMEOUT_S = 300
SEAM_ORDER = ("live", "stub", "stub", "live") * 2  # warm reduces, in turns
# runs ``python -c <code>`` (argv[1]) with argv[2:] as its arguments and,
# at exit, prints what the child loaded, as _CLI_WRAPPER does
_CODE_WRAPPER = _CLI_WRAPPER.split("sys.argv = sys.argv[1:]")[0] + """\
code = sys.argv[1]
sys.argv = sys.argv[1:]
exec(compile(code, "<child>", "exec"), {"__name__": "__main__"})
"""


def start_code_child(code, args=()):
    """Start ``python -c <code> <args>`` from the checkout root, probed as
    :func:`start_obs_cli`'s children are; :func:`finish_obs_cli` collects
    it."""
    return subprocess.Popen([sys.executable, "-c", _CODE_WRAPPER, code, *map(str, args)],
                            cwd=HERE, env=_cli_env(), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def start_mc_exhaustive():
    """The bounded exhaustive search of every model, one CLI child a
    model, all started together; their output goes to files, so no
    child blocks on a pipe while another is waited for. Each step of a
    search is two thread handoffs between cores, and searches that share
    the cores slow each other several times over (two on an 8-core x86
    host: 107 s against 35 s alone), so where the host has a core to
    spare for each, each search is pinned to a core of its own
    (``cpus``; two pinned there: 35 s)."""
    import tempfile

    t = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="phase18-exhaustive-")
    cores = sorted(os.sched_getaffinity(0))
    cpus = dict(zip(MC_MODELS, cores[-len(MC_MODELS):])) if len(cores) > len(MC_MODELS) else {}
    procs, files = {}, {}
    for m in MC_MODELS:
        files[m] = (open(os.path.join(tmp, m + ".out"), "w+"),
                    open(os.path.join(tmp, m + ".err"), "w+"))
        pin = (lambda c=cpus[m]: os.sched_setaffinity(0, {c})) if m in cpus else None
        procs[m] = subprocess.Popen(
            [sys.executable, "-c", _CLI_WRAPPER, MC_MODULE, "--model", m, "--exhaustive",
             "--max-schedules", str(MC_MAX_SCHEDULES)],
            cwd=HERE, env=_cli_env(), stdout=files[m][0], stderr=files[m][1],
            text=True, preexec_fn=pin)
    return {"procs": procs, "files": files, "dir": tmp, "t0": t, "cpus": cpus}


def _finish_file_child(proc, files, timeout):
    """As :func:`finish_obs_cli`, for a child whose output went to files."""
    try:
        proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        raise
    texts = []
    for f in files:
        f.seek(0)
        texts.append(f.read())
        f.close()
    out, err = texts
    lines = [ln for ln in err.splitlines() if ln.startswith(CLI_PROBE)]
    probe = json.loads(lines[-1][len(CLI_PROBE):]) if lines else None
    return proc.returncode, out, err, probe


def stop_children(procs):
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


_MC_GATE_CODE = """\
import json, logging, os, sys, time
logging.disable(logging.WARNING)  # every speculation schedule logs its clone
from sparkrdma_tpu_torch.analysis.modelcheck.explore import replay_artifact, save_artifact
from sparkrdma_tpu_torch.analysis.modelcheck.mutants import run_gate
from sparkrdma_tpu_torch.analysis.modelcheck.sched import ReplayDivergence
out = sys.argv[1]
t = time.perf_counter()
gate = run_gate(walks=40)
gate_s = time.perf_counter() - t
rows = {}
t = time.perf_counter()
for name, r in sorted(gate.items()):
    f = r["failure"]
    row = {"model": r["model"], "how": r["how"], "kind": f and f["kind"],
           "trace_steps": f and len(f["trace"]), "violation": r["violation"]}
    if f is not None:
        save_artifact(f, os.path.join(out, name + ".json"))
        texts = [replay_artifact(f) for _ in range(3)]
        row["replays_identical"] = len(set(texts)) == 1 and texts[0] == r["violation"]
        try:
            row["without_mutant"] = replay_artifact(dict(f, mutant=None)) or "clean"
        except ReplayDivergence as e:
            row["without_mutant"] = "diverged: " + str(e).split(":")[0]
    rows[name] = row
print("GATE " + json.dumps({"gate_s": gate_s, "replay_s": time.perf_counter() - t,
                             "mutants": rows}))
"""


def _mc_children(tmp):
    """(a) The model checker as children, all started together: the
    CLI's walks, mutation gate, replays and exhaustive search, and the
    gate's caught schedules replayed in a child of their own."""
    import shutil

    out = {}
    t = time.perf_counter()
    exhaustive = start_mc_exhaustive()
    try:
        _mc_collect(tmp, exhaustive, out)
    finally:
        stop_children(exhaustive["procs"].values())
    out["seconds"] = time.perf_counter() - t
    shutil.rmtree(tmp, ignore_errors=True)
    shutil.rmtree(exhaustive["dir"], ignore_errors=True)
    return out


def _mc_collect(tmp, exhaustive, out):
    t = time.perf_counter()
    cli = {"walks": start_obs_cli(["--walks", str(MC_WALKS)], module=MC_MODULE),
           "mutants": start_obs_cli(["--mutants"], module=MC_MODULE)}
    gate = start_code_child(_MC_GATE_CODE, [tmp])
    rc_, text, err, probe = finish_obs_cli(gate, timeout=MC_TIMEOUT_S)
    lines = [ln for ln in text.splitlines() if ln.startswith("GATE ")]
    if rc_ != 0 or not lines:
        raise AssertionError(f"(a) the gate's replay child: rc {rc_}\n{err[-3000:]}")
    g = json.loads(lines[-1][len("GATE "):])
    rows = g["mutants"]
    caught = [m for m, r in rows.items() if r["how"] is not None]
    if len(rows) != MC_MUTANTS or len(caught) != MC_MUTANTS:
        raise AssertionError(f"(a) the gate caught {len(caught)} of {len(rows)} mutants")
    bad = {m: r for m, r in rows.items() if not r["replays_identical"] or not (
        r["without_mutant"] == "clean" or r["without_mutant"].startswith("diverged"))}
    if bad:
        raise AssertionError(f"(a) replays of the gate's failures: {bad}")
    out["gate"] = {"mutants": len(rows), "caught": len(caught), "gate_s": g["gate_s"],
                   "replay_s": g["replay_s"], "replayed_three_times_identical": len(rows),
                   "without_mutant_clean": sorted(m for m, r in rows.items()
                                                  if r["without_mutant"] == "clean"),
                   "without_mutant_diverged": {m: r["without_mutant"] for m, r in rows.items()
                                               if r["without_mutant"] != "clean"},
                   "how": {m: [r["how"], r["kind"], r["trace_steps"]] for m, r in rows.items()},
                   "probe": probe}
    # the CLI replays one caught schedule of each model
    first = {}
    for m, r in sorted(rows.items()):
        first.setdefault(r["model"], m)
    cli.update({f"replay_{model}": start_obs_cli(
        ["--replay", os.path.join(tmp, m + ".json")], module=MC_MODULE)
        for model, m in first.items()})
    runs = {}
    for name, p in cli.items():
        rc_, text, err, probe = finish_obs_cli(p, timeout=MC_TIMEOUT_S)
        runs[name] = {"rc": rc_, "last_line": text.strip().splitlines()[-1][:200] if text.strip()
                      else "", "probe": probe}
        if rc_ != 0:
            raise AssertionError(f"(a) modelcheck {name}: rc {rc_}\n{text[-2000:]}{err[-2000:]}")
        if name == "walks":
            runs[name]["schedules"] = {m: int(n) for m, n in re.findall(
                r"model (\S+)\s+clean: (\d+) schedules", text)}
            if runs[name]["schedules"] != {m: MC_WALKS + 1 for m in MC_MODELS}:
                raise AssertionError(f"(a) the walks: {text[-2000:]}")
    out["cli"] = runs
    out["cli_s"] = time.perf_counter() - t
    ex = {}
    walls = {}
    deadline = exhaustive["t0"] + MC_TIMEOUT_S
    while len(walls) < len(exhaustive["procs"]) and time.perf_counter() < deadline:
        for m, p in exhaustive["procs"].items():
            if m not in walls and p.poll() is not None:
                walls[m] = time.perf_counter() - exhaustive["t0"]
        time.sleep(0.1)
    for m, p in exhaustive["procs"].items():
        rc_, text, err, probe = _finish_file_child(p, exhaustive["files"][m], 1.0)
        found = re.search(r"clean: (\d+) schedules \((\w+)\)", text)
        if rc_ != 0 or found is None:
            raise AssertionError(f"(a) exhaustive {m}: rc {rc_}\n{text[-2000:]}{err[-2000:]}")
        ex[m] = {"rc": rc_, "schedules": int(found.group(1)),
                 "complete": found.group(2) == "complete", "wall_s": walls[m], "probe": probe}
    out["exhaustive"] = ex
    out["exhaustive_cpus"] = exhaustive["cpus"]
    out["exhaustive_wall_s"] = time.perf_counter() - exhaustive["t0"]
    probes = [r["probe"] for r in list(runs.values()) + list(ex.values())] + [
        out["gate"]["probe"]]
    if any(p is None or p["jax"] or p["cuda_initialized"] for p in probes):
        raise AssertionError(f"(a) a model-checker child loaded jax or initialised CUDA: {probes}")


def _study_rows(torch, dev, e, block, srcs):
    """The exchange study's send rows of the shards ``srcs`` (row src*e+dst
    holds its (src, dst) payload) and their counts, built on the card."""
    srcs = list(srcs)
    send = torch.zeros((len(srcs) * e, block), dtype=torch.uint8, device=dev)
    counts = np.zeros(len(srcs) * e, np.int32)
    for i, src in enumerate(srcs):
        for dst in range(e):
            n, v = _study_payload_len(src, dst, block)
            send[i * e + dst, :n] = v
            counts[i * e + dst] = n
    return send, torch.from_numpy(counts).to(dev)


def _shard_digests(torch, recv, rcounts, e):
    """SHA-256 of each shard's received rows and counts."""
    r = recv.view(-1, e, recv.shape[-1])
    c = rcounts.view(-1, e)
    out = []
    for i in range(r.shape[0]):
        h = hashlib.sha256(r[i].cpu().numpy().tobytes())
        h.update(c[i].cpu().numpy().tobytes())
        out.append(h.hexdigest())
    return out


_RANK_CODE = """\
import sys
import chip_smoke
chip_smoke.rank_worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], int(sys.argv[4]))
"""


def rank_worker(rank, port, device="cuda", block=STUDY_BLOCK):
    """One rank of (b): joins the group over loopback, holds RK_SHARDS
    shards on ``device`` (the card's first, unless a CPU rehearsal asks
    for ``cpu``) and feeds its rows of phase 9's study send (``block``
    bytes a bucket) through both schedules; prints one ``RANK`` JSON
    line."""
    import statistics

    import torch
    import torch.distributed as dist

    from sparkrdma_tpu_torch.obs import get_registry
    from sparkrdma_tpu_torch.ops.exchange import ExchangeProgram
    from sparkrdma_tpu_torch.parallel import multihost

    dev = torch.device(device, 0) if device == "cuda" else torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    t = time.perf_counter()
    multihost.initialize(f"127.0.0.1:{port}", RK_RANKS, rank, backend="gloo")
    mesh = multihost.global_mesh(shards_per_rank=RK_SHARDS, device=dev)
    init_s = time.perf_counter() - t
    e = mesh.num_shards
    send, counts = _study_rows(torch, dev, e, block, mesh.local)
    _sync(torch, dev)
    prog = ExchangeProgram(mesh)
    reg = get_registry()
    fams = ("exchanges", "bytes_sent", "bytes_received", "bytes_received_valid")
    res = {"rank": rank, "backend": dist.get_backend(), "world": dist.get_world_size(),
           "local": [mesh.local.start, mesh.local.stop], "mesh": mesh.shape,
           "init_s": init_s, "cross_rank_path": prog.cross_rank_path,
           "local_send_bytes": send.numel()}
    for label, fn in (("a2a", prog.exchange), ("ring", prog.ring_exchange)):
        c0 = {f: reg.counter(f"exchange.{f}", schedule=label).value for f in fams}
        x0 = prog.cross_rank_bytes[label]
        walls, launches = [], []
        for i in range(RK_CALLS):
            dist.barrier()
            _sync(torch, dev)
            n0 = _launched("srt_neighbor_pull")
            t = time.perf_counter()
            recv, rcounts = fn(send, counts)
            _sync(torch, dev)
            walls.append(time.perf_counter() - t)
            launches.append(_launched("srt_neighbor_pull") - n0)
            if i == 0:
                digests = _shard_digests(torch, recv, rcounts, e)
            del recv, rcounts
        res[label] = {
            "digests": digests, "cold_s": walls[0], "warm_s": walls[1:],
            "warm_median_s": statistics.median(walls[1:]),
            "neighbor_pull_launches_per_call": launches,
            "cross_rank_bytes_per_call": (prog.cross_rank_bytes[label] - x0) // RK_CALLS,
            "exchange_deltas": {f: reg.counter(f"exchange.{f}", schedule=label).value - c0[f]
                                for f in fams},
            "stats": prog.stats[label]}
    res["neighbor_pull_launches"] = _launched("srt_neighbor_pull")
    dist.barrier()
    dist.destroy_process_group()
    print("RANK " + json.dumps(res), flush=True)


def _boundary_row_kernel(torch, dev):
    """srt_neighbor_pull with its last row read from a separate tensor
    (the ring's receive buffer) against its plain version, byte for byte:
    small, odd and misaligned stacks and the ring's [4, 128 MiB] hop."""
    from sparkrdma_tpu_torch.ops import remote_copy as rc

    n0 = _launched("srt_neighbor_pull")
    cases = [(1, (7,), torch.uint8, 0, 0), (3, (1025,), torch.int32, 0, 0),
             (4, (MESH,), torch.int32, 0, 0), (2, (4097,), torch.bfloat16, 0, 0),
             (4, ((64 << 10) + 3,), torch.uint8, 1, 3),
             (RK_SHARDS, (MESH * STUDY_BLOCK,), torch.uint8, 0, 0)]
    out = []
    for n, shape, dtype, soff, doff in cases:
        both = _offset_stack(torch, dev, n + 1, shape, dtype, soff)
        blocks, last = both[:n], both[n].clone()
        dst = _offset_stack(torch, dev, n, shape, dtype, doff, fill=0xA5)
        got = rc.neighbor_pull(blocks, out=dst, last=last)
        want = rc.neighbor_pull_reference(blocks, last)
        torch.cuda.synchronize()
        if not torch.equal(got.reshape(n, -1).view(torch.uint8),
                           want.reshape(n, -1).view(torch.uint8)):
            raise AssertionError(f"the boundary row differs from its plain version: n {n}, "
                                 f"shard {shape} {dtype}, offsets {soff}/{doff}")
        out.append({"n": n, "shard_bytes": last.numel() * last.element_size(),
                    "dtype": str(dtype), "src_offset": soff, "dst_offset": doff})
        del both, blocks, last, dst, got, want
    return {"cases": out, "equal": True,
            "comparison_launches": _launched("srt_neighbor_pull") - n0}


def _two_ranks(torch, dev):
    """(b) Two ranks on the card, E = 8: phase 9's study send, each rank
    its half, through both schedules; every received shard's SHA-256
    against the single-process program's, computed here."""
    import socket
    from concurrent.futures import ThreadPoolExecutor

    from sparkrdma_tpu_torch.ops import _build
    from sparkrdma_tpu_torch.ops.exchange import ExchangeProgram
    from sparkrdma_tpu_torch.parallel import make_mesh

    mode = subprocess.run(["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    if "exclusive" in mode.lower():
        raise AssertionError(f"(b) the card's compute mode is {mode}: two processes cannot "
                             "share it (the default mode is needed)")
    e = RK_RANKS * RK_SHARDS
    send, counts, want, want_counts = _study_send(torch, dev, e, STUDY_BLOCK)
    ref = {}
    prog = ExchangeProgram(make_mesh([dev] * e))
    for label, fn in (("a2a", prog.exchange), ("ring", prog.ring_exchange)):
        recv, rcounts = fn(send, counts)
        if not (torch.equal(recv, want) and torch.equal(rcounts, want_counts)):
            raise AssertionError(f"(b) the one-process {label} differs from the sent blocks")
        ref[label] = _shard_digests(torch, recv, rcounts, e)
        del recv, rcounts
    if ref["a2a"] != ref["ring"]:
        raise AssertionError("(b) the one-process schedules' digests differ")
    reference_launches = _launched("srt_neighbor_pull")
    _reset_launches()  # the reference's launches are a comparison's
    del send, counts, want, want_counts, prog
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        _build._load(_build.LIB_NAME)  # built once here, loaded by both ranks
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    t = time.perf_counter()
    procs = [start_code_child(_RANK_CODE, [r, port, dev.type, STUDY_BLOCK])
             for r in range(RK_RANKS)]
    try:
        with ThreadPoolExecutor(RK_RANKS) as pool:
            done = list(pool.map(lambda p: finish_obs_cli(p, timeout=RK_TIMEOUT_S), procs))
    finally:
        stop_children(procs)
    wall = time.perf_counter() - t
    ranks = []
    for r, (rc_, text, err, probe) in enumerate(done):
        lines = [ln for ln in text.splitlines() if ln.startswith("RANK ")]
        if rc_ != 0 or not lines:
            raise AssertionError(f"(b) rank {r}: rc {rc_}\n{text[-2000:]}\n{err[-4000:]}")
        res = json.loads(lines[-1][len("RANK "):])
        res["probe"] = probe
        ranks.append(res)
    for res in ranks:
        lo, hi = res["local"]
        for label in ("a2a", "ring"):
            if res[label]["digests"] != ref[label][lo:hi]:
                raise AssertionError(f"(b) rank {res['rank']}'s {label} rows differ from the "
                                     "one-process program's")
        # a CPU rehearsal's ranks take the plain version
        per_call = 2 * (e - 1) if dev.type == "cuda" else 0
        if res["ring"]["neighbor_pull_launches_per_call"] != [per_call] * RK_CALLS:
            raise AssertionError(f"(b) rank {res['rank']} ring launches "
                                 f"{res['ring']['neighbor_pull_launches_per_call']}")
        if res["probe"] is None or res["probe"]["jax"]:
            raise AssertionError(f"(b) rank {res['rank']} loaded jax: {res['probe']}")
        # gloo's all-to-all takes CUDA tensors, its isend / irecv do not
        path = {"a2a": "direct", "ring": "host-staged" if dev.type == "cuda" else "direct"}
        if res["backend"] != "gloo" or res["cross_rank_path"] != path:
            raise AssertionError(f"(b) rank {res['rank']}: backend {res['backend']}, "
                                 f"path {res['cross_rank_path']}")
    return {"ranks": RK_RANKS, "shards_a_rank": RK_SHARDS, "e": e, "compute_mode": mode,
            "send_bytes": e * e * STUDY_BLOCK, "one_process_digests": ref["a2a"],
            "one_process_reference_launches": reference_launches,
            "digests_equal": True, "children_wall_s": wall, "per_rank": ranks}


def _seam_modules():
    """Every loaded port module outside the model checker that holds its
    ``schedule_point``."""
    from sparkrdma_tpu_torch.analysis.modelcheck import sched

    return [m for name, m in sorted(sys.modules.items())
            if name.startswith("sparkrdma_tpu_torch.") and m is not None
            and not name.startswith(MC_MODULE)
            and getattr(m, "schedule_point", None) is sched.schedule_point]


@contextlib.contextmanager
def _seam(mode):
    """``live``: the port as it ships (``schedule_point`` and
    ``OrderedLock`` read the scheduler module's ``active``); ``stub``: a
    no-op ``schedule_point`` and a stand-in scheduler module in every
    port module that holds them; ``count``: live, each call counted."""
    import types

    from sparkrdma_tpu_torch.analysis import lockorder
    from sparkrdma_tpu_torch.analysis.modelcheck import sched

    calls = {"schedule_point": 0}
    if mode == "live":
        yield calls
        return
    mods = _seam_modules()
    real = sched.schedule_point

    def counted(kind, name):
        calls["schedule_point"] += 1
        real(kind, name)

    fn = counted if mode == "count" else (lambda kind, name: None)
    for m in mods:
        m.schedule_point = fn
    if mode == "stub":
        lockorder._sched = types.SimpleNamespace(active=None)
    try:
        yield calls
    finally:
        for m in mods:
            m.schedule_point = real
        lockorder._sched = sched


def _live_seam(torch, dev, data):
    """(c) Phase 10 (b)'s map and reduces with the live seam and no
    scheduler active: the cold and warm reduce's wave launches against
    phase 10 (b)'s, then warm reduces with the seam live and stubbed, in
    turns."""
    import statistics

    from sparkrdma_tpu_torch.analysis.modelcheck import sched
    from sparkrdma_tpu_torch.models.terasort import MapShardSorter
    from sparkrdma_tpu_torch.shuffle.device_io import DeviceShuffleIO
    from sparkrdma_tpu_torch.shuffle.handle import BaseShuffleHandle, HashPartitioner
    from sparkrdma_tpu_torch.shuffle.manager import TpuShuffleManager
    from sparkrdma_tpu_torch.utils.config import TpuShuffleConf

    if sched.active is not None:
        raise AssertionError("(c) a scheduler is active")
    shards, edges, want = data
    sid = 18
    conf = TpuShuffleConf({**PY_PLANE, **HOST_PLANE_KNOBS})
    ids = [f"seam-{e}" for e in range(EXECUTORS)]
    driver = TpuShuffleManager(conf, is_driver=True)
    execs = [TpuShuffleManager(conf, is_driver=False, executor_id=i) for i in ids]
    ios = [DeviceShuffleIO(ex, device=dev) for ex in execs]
    walls = {"live": [], "stub": []}
    try:
        driver.register_shuffle(BaseShuffleHandle(
            shuffle_id=sid, num_maps=EXECUTORS, partitioner=HashPartitioner(REDUCERS)))
        with _seam("count") as calls:
            map_s = _hp_map_phase(torch, dev, MapShardSorter(dev), ios, shards, edges, sid)[0]
            map_calls = calls["schedule_point"]
            l0 = _wave_launches()
            cold = _hp_reduce_all(torch, dev, ios, sid, want)[0]
            warm = _hp_reduce_all(torch, dev, ios, sid, want)[0]
            launches = [x - y for x, y in zip(_wave_launches(), l0)]
            reduce_calls = calls["schedule_point"] - map_calls
        for mode in SEAM_ORDER:
            with _seam(mode):
                walls[mode].append(_hp_reduce_all(torch, dev, ios, sid)[0])
    finally:
        for io in ios:
            io.stop()
        for ex in execs:
            ex.stop()
        driver.stop()
    p10 = _REPORTS.get(10, {}).get("default", {})
    out = {"keys": KEYS, "map_s": map_s, "reduce_cold_s": cold, "reduce_warm_s": warm,
           "wave_launches_cold_and_warm": launches,
           "phase10_default_wave_launches": p10.get("wave_launches"),
           "schedule_point_calls": {"map": map_calls, "cold_and_warm_reduce": reduce_calls},
           "order": list(SEAM_ORDER), "warm_live_s": walls["live"], "warm_stub_s": walls["stub"],
           "warm_live_median_s": statistics.median(walls["live"]),
           "warm_stub_median_s": statistics.median(walls["stub"]),
           "live_minus_stub_median_s": (statistics.median(walls["live"])
                                        - statistics.median(walls["stub"]))}
    if p10.get("wave_launches") is not None and launches != p10["wave_launches"]:
        raise AssertionError(f"(c) wave launches {launches}, phase 10 (b)'s "
                             f"{p10['wave_launches']}")
    if launches[1] <= 0:
        raise AssertionError("(c) the pipelined wave-pull kernel never launched")
    if map_calls <= 0:
        raise AssertionError("(c) no schedule point was reached on the map")
    return out


def phase_models_and_ranks(torch, dev, data):
    """Phase 18: (a) the model checker as child processes on the card's
    host; (b) two ranks on the card through ``torch.distributed``; (c)
    phase 10 (b)'s reduce with the live schedule-point seam. Launches of
    ``srt_neighbor_pull`` on the main path: the two ranks' ring calls."""
    import tempfile


    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    os.environ["PYTHONPATH"] = _cli_env()["PYTHONPATH"]
    t0 = time.perf_counter()
    report = {"card": smi}
    report["a"] = _mc_children(tempfile.mkdtemp(prefix="phase18-"))
    emit("18a", name="model_checker", card=smi, **report["a"])
    t = time.perf_counter()
    report["boundary_row_kernel"] = _boundary_row_kernel(torch, dev)
    _reset_launches()
    report["b"] = _two_ranks(torch, dev)
    report["b"]["seconds"] = time.perf_counter() - t
    emit("18b", name="two_ranks", card=smi,
         boundary_row_kernel=report["boundary_row_kernel"], **report["b"])
    launched = {k: n for k, n in _all_counts().items() if n}
    if launched:
        raise AssertionError(f"(b) launched kernels in the parent: {launched}")
    ring = sum(r["neighbor_pull_launches"] for r in report["b"]["per_rank"])
    t = time.perf_counter()
    report["c"] = _live_seam(torch, dev, data)
    report["c"]["seconds"] = time.perf_counter() - t
    emit("18c", name="live_seam", card=smi, **report["c"])
    launched = {k: v for k, v in _all_counts().items()
                if v and k not in ("srt_wave_pull", "srt_pipelined_wave_pull")}
    if launched:
        raise AssertionError(f"phase 18 launched other kernels: {launched}")
    counts = {"srt_neighbor_pull": ring, "srt_wave_pull": _launched("srt_wave_pull"),
              "srt_pipelined_wave_pull": _launched("srt_pipelined_wave_pull")}
    emit(18, name="models_and_ranks", card=smi, launches=counts,
         seconds=time.perf_counter() - t0, parts=["18a", "18b", "18c"],
         seconds_by_part={k: report[k]["seconds"] for k in ("a", "b", "c")})
    return counts


def main():
    if not os.path.isdir(os.path.join(HERE, "sparkrdma_tpu_torch")):
        sys.exit("chip_smoke.py must run from a checkout of the repository")
    import torch

    if not torch.cuda.is_available():
        sys.exit("no CUDA device is available")
    sys.path.insert(0, HERE)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    _main(torch, dev)


def _main(torch, dev):
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
    sp_training = phase_sp_training_path(torch, dev, step7_s)
    join_launches = phase_spmd_models(torch, dev)
    kernels.append(time_radix_pack(torch, dev))
    kernels.append(time_radix_pack(torch, dev, wide=True))
    kernels.append(time_csr_pull(torch, dev))
    kernels.append(time_merge_runs(torch, dev))
    kernels.append(time_sorted_probe(torch, dev))
    kernels.append(time_sorted_probe(torch, dev, wide=True))
    phase_data_planes(torch, dev)
    phase_engine(torch, dev)
    native_plane = phase_native_plane(torch, dev, data)
    operations = phase_operations_planes(torch, dev, data)
    elastic = phase_elastic_planes(torch, dev, data)
    ranks = phase_models_and_ranks(torch, dev, data)
    del data
    launches.update(training)
    for k, n in serving.items():
        launches[k] += n
    launches.update(spmd)
    launches.update(join_launches)
    for k, n in host_plane.items():
        launches[k] += n
    for k, n in sp_training.items():
        launches[k] += n
    for k, n in native_plane.items():
        launches[k] += n
    for k, n in operations.items():
        launches[k] += n
    for k, n in elastic.items():
        launches[k] += n
    for k, n in ranks.items():
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
