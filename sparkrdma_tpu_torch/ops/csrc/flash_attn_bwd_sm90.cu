// flash_attn_bwd_sm90.cu — the bf16 flash-attention backward on Hopper's
// tensor cores (wgmma + TMA), for sm_90a.
//
// Replaces the two Pallas TPU kernels of the JAX package's flash attention
// backward for bf16 inputs, sparkrdma_tpu/ops/pallas_attention.py (_bwd_impl):
//   srt_flash_attn_bwd_dkv_sm90  <- _dkv_kernel (pallas_call at :394)
//   srt_flash_attn_bwd_dq_sm90   <- _dq_kernel  (pallas_call at :364)
// The wrapper (ops/pallas_attention.py, bwd_entry) sends bf16 inputs with D
// in {64, 128}, precision "default" and 16-byte-aligned q/k/v/do and
// outputs here; every other input takes srt_flash_attn_bwd_dq/_dkv
// (flash_attn_bwd.cu), whose argument lists these share.
//
// What they compute is the SIMT pair's function, on q, k, v, do laid out
// [B, S, H, D] (contiguous bf16), the forward's lse[b, h, s] and
// delta[b, h, s] = rowsum(do * out) (both f32), with scale = 1/sqrt(D):
//   p  = exp(scale * q k^T + mask - lse)     re-materialised tile by tile
//   ds = p * (do v^T - delta)
//   dq = scale * ds k     dk = scale * ds^T q     dv = p^T do      (bf16)
// with the TPU kernels' numerics for bf16 (`precision=DEFAULT`, one bf16
// MXU pass a product): every product takes bf16 operands into f32, p
// rounds to bf16 before p^T do and ds to bf16 before ds k and ds^T q (to
// nearest even), and ds is formed from the f32 p. The exponent runs in
// base 2 (scale * log2 e folded into the scores, lse * log2 e); masked
// scores take the sentinel NEG_INF = -1e30 after the fold, never -inf;
// rows past S take lse = +1e30, so their p is 0. The mask drops kv >= S,
// q >= S and, if causal, kv > q.
//
// What bounds them on this card: operations. dk/dv costs 8*B*H*D per live
// (q, kv) pair in flops (k.q, v.do, p.do, ds.q) and dq 6*B*H*D (q.k,
// do.v, ds.k), against (4 + outputs) * B*S*H*D*2 bytes: at the bench shape
// (B4 S2048 H8 D128 causal) 68.8 and 51.6 GFLOP against 83.9 and 67.1 MB,
// so the 989 TFLOP/s bf16 tensor-core rate, not the 3.35 TB/s of memory,
// sets the floor.
//
// What the design does about it (the tensor-core forward's pieces,
// shared through flash_attn_sm90_common.cuh):
//   - every product runs on the tensor cores with wgmma. The score-like
//     products (s^T = k q^T and dp^T = v do^T for dk/dv; s = q k^T and
//     dp = do v^T for dq) are m64n64k16 with both operands read from
//     shared memory K-major. The accumulating products (dv += p^T do,
//     dk += ds^T q; dq += ds k) are m64n{D}k16 with the A operand in
//     registers: the f32 fragment of p or ds packed to bf16 in place (its
//     layout is the A operand's), and B read MN-major (the transpose flag),
//     as the forward reads V;
//   - dk/dv: one CTA owns a (b, h, 128-key kv tile): two consumer
//     warpgroups of 64 keys each, K and V loaded once with TMA. The q side
//     streams in 64-row tiles of Q and dO through a 2-stage ring behind
//     "full" and "empty" mbarriers; a second producer warp writes the
//     tile's lse * log2 e and delta rows beside them with guarded plain
//     loads (TMA would need S % 4 == 0). Causal: the q loop starts at the
//     first live tile (k0 / 64) and a warpgroup skips the one tile that
//     lies wholly above its keys; kv tiles are issued longest first across
//     the grid;
//   - dq: one CTA owns a (b, h, 128-row q tile): two consumer warpgroups of
//     64 rows, Q and dO loaded once, K and V streaming in 64-key tiles
//     through the same ring. Causal: the kv loop stops after the last live
//     tile, q tiles are issued longest first. No atomics and no split of
//     the kv sweep, as in the TPU kernel, so results are deterministic;
//   - masks only on the causal diagonal tiles and the ragged ones;
//     setmaxnreg moves registers from the producer to the consumers (dk/dv
//     at D = 128 holds dk 64 + dv 64 + s^T 32 + dp^T 32 floats a thread);
//   - the epilogue scales dk and dq once, rounds to bf16 (nearest even),
//     stages each warpgroup's 64 rows in shared memory and writes them with
//     16-byte stores.

#include "flash_attn_sm90_common.cuh"
#include "launch_config.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kOwnRows = 128;      // rows a CTA owns: keys (dk/dv) or queries (dq)
constexpr int kStepRows = 64;      // rows of a streamed tile
constexpr int kConsumers = 256;    // two warpgroups
constexpr int kThreadsSm90 = 384;  // + the producer warpgroup

// Shared memory of one CTA: the two owned 128-row tiles (K, V or Q, dO),
// two stages of the two streamed 64-row tiles, the epilogue's staging, two
// stages of the streamed rows' lse * log2 e and delta, five mbarriers.
template <int D>
struct BwdSmem {
  static constexpr int kSlabs = D / 64;
  static constexpr int kOwnSlab = kOwnRows * kBoxBytes;    // one 64-column box
  static constexpr int kStepSlab = kStepRows * kBoxBytes;
  static constexpr int kOwn = kSlabs * kOwnSlab;    // an owned tile
  static constexpr int kStep = kSlabs * kStepSlab;  // a streamed tile
  static constexpr int kOld = D + 8;  // staging row, bf16: 16 bytes of skew
  static constexpr int kA = 0;                     // K (dk/dv) or Q (dq)
  static constexpr int kB = kOwn;                  // V (dk/dv) or dO (dq)
  static constexpr int kX = 2 * kOwn;              // stage s at kX + s * kStep: Q or K
  static constexpr int kY = kX + 2 * kStep;        // stage s at kY + s * kStep: dO or V
  static constexpr int kStage = kY + 2 * kStep;    // [2 warpgroups][64][kOld] bf16
  static constexpr int kRows = kStage + 2 * 64 * kOld * 2;  // [2 stages][lse2, delta][64] f32
  static constexpr int kBar = kRows + 2 * 2 * kStepRows * 4;
  static constexpr int kBytes = kBar + 5 * 8 + 1024;  // + alignment slack
};

// Accumulator fragment of a 64-row wgmma, thread t of the warpgroup,
// element i: row 16 * (t / 32) + (t % 32) / 4 + 8 * ((i / 2) % 2), column
// 8 * (i / 4) + 2 * (t % 4) + i % 2. Columns 16 kk .. 16 kk + 15 of an
// m64n64 fragment are the register A fragment of k-step kk: packs
// (8 kk + 2 r, 8 kk + 2 r + 1), r = 0..3.
__device__ __forceinline__ void pack_a(const float (&x)[32], uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) a[kk][r] = pack_bf16(x[8 * kk + 2 * r], x[8 * kk + 2 * r + 1]);
}

// Write a warpgroup's 64 x D accumulator times `mul` as bf16 rows
// [row0, row0 + 64) of the (b, h) slice of dst, rows >= S left out:
// staged in shared memory, then 16-byte stores.
template <int D>
__device__ __forceinline__ void store_tile(const float (&acc)[D / 2], float mul,
                                           __nv_bfloat16* stg, __nv_bfloat16* __restrict__ dst,
                                           int b, int h, int row0, int S, int H, int g, int tid) {
  using L = BwdSmem<D>;
  const int w = tid >> 5, lane = tid & 31, tig = lane & 3;
  const int r_loc = 16 * w + (lane >> 2);
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      *reinterpret_cast<__nv_bfloat162*>(stg + (r_loc + 8 * hh) * L::kOld + 8 * j + 2 * tig) =
          __floats2bfloat162_rn(acc[4 * j + 2 * hh] * mul, acc[4 * j + 2 * hh + 1] * mul);
    }
  }
  asm volatile("bar.sync %0, 128;" ::"r"(1 + g) : "memory");  // this warpgroup only
  constexpr int kChunks = D / 8;  // 16-byte chunks a row
  for (int idx = tid; idx < 64 * kChunks; idx += 128) {
    const int r = idx / kChunks, ch = idx % kChunks;
    const int pos = row0 + r;
    if (pos < S) {
      *reinterpret_cast<uint4*>(dst + ((static_cast<long long>(b) * S + pos) * H + h) * D +
                                8 * ch) = *reinterpret_cast<const uint4*>(stg + r * L::kOld + 8 * ch);
    }
  }
  asm volatile("bar.sync %0, 128;" ::"r"(1 + g) : "memory");  // staging free again
}

// ---------------------------------------------------------------------------
// dk/dv: the CTA's 128 keys, two warpgroups of 64; q tiles of 64 stream by.
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kThreadsSm90, 1)
flash_bwd_dkv_sm90_kernel(const __grid_constant__ CUtensorMap tk,   // 128-row boxes
                          const __grid_constant__ CUtensorMap tv,   // 128-row boxes
                          const __grid_constant__ CUtensorMap tq,   // 64-row boxes
                          const __grid_constant__ CUtensorMap tdo,  // 64-row boxes
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int S,
                          int H, float c, float scale, int causal) {
  using L = BwdSmem<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzled tiles: 1024-aligned
  uint8_t* const gbase = smem_raw + (base - raw);
  float* const rows = reinterpret_cast<float*>(gbase + L::kRows);
  const uint32_t bar_kv = base + L::kBar;
  const auto bar_full = [&](int st) { return bar_kv + 8 * (1 + st); };
  const auto bar_empty = [&](int st) { return bar_kv + 8 * (3 + st); };

  // kv tiles longest first over the whole grid (with a causal mask kv tile
  // 0 meets every q tile): the kv tile is the slowest-moving part of the
  // linear block index
  const int bh = gridDim.y * gridDim.z;
  const int lin = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);
  const int h = (lin % bh) % H, b = (lin % bh) / H;
  const int k0 = (lin / bh) * kOwnRows;
  const int nq = (S + kStepRows - 1) / kStepRows;
  const int t0 = causal ? k0 / kStepRows : 0;  // the first live q tile

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int st = 0; st < 2; ++st) {
      mbar_init(bar_full(st), 33);  // the TMA lane (with the bytes) + the rows warp
      mbar_init(bar_empty(st), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // ---- producer warpgroup: warp 0 issues every TMA load, warp 1 writes
    // each q tile's rows (two warps, so each fits in the 24 registers left)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    const int pw = (threadIdx.x - kConsumers) >> 5, lane = threadIdx.x & 31;
    if (pw == 0 && lane == 0) {
      mbar_expect_tx(bar_kv, 2 * L::kOwn);
#pragma unroll
      for (int sl = 0; sl < L::kSlabs; ++sl) {
        tma_load(base + L::kA + sl * L::kOwnSlab, &tk, bar_kv, 64 * sl, h, k0, b);
        tma_load(base + L::kB + sl * L::kOwnSlab, &tv, bar_kv, 64 * sl, h, k0, b);
      }
      for (int t = t0; t < nq; ++t) {
        const int n = t - t0, st = n & 1;
        mbar_wait(bar_empty(st), ((n >> 1) & 1) ^ 1);  // the first round passes
        mbar_expect_tx(bar_full(st), 2 * L::kStep);
#pragma unroll
        for (int sl = 0; sl < L::kSlabs; ++sl) {
          tma_load(base + L::kX + st * L::kStep + sl * L::kStepSlab, &tq, bar_full(st),
                   64 * sl, h, t * kStepRows, b);
          tma_load(base + L::kY + st * L::kStep + sl * L::kStepSlab, &tdo, bar_full(st),
                   64 * sl, h, t * kStepRows, b);
        }
      }
    } else if (pw == 1) {
      const long long row_base = (static_cast<long long>(b) * H + h) * S;
      const float* const lse_bh = lse + row_base;
      const float* const delta_bh = delta + row_base;
      for (int t = t0; t < nq; ++t) {
        const int n = t - t0, st = n & 1;
        mbar_wait(bar_empty(st), ((n >> 1) & 1) ^ 1);
        float* r = rows + st * 2 * kStepRows;
        for (int i = lane; i < kStepRows; i += 32) {
          const int qpos = t * kStepRows + i;
          // rows past S: the forward's +1e30 pin, so their p is 0
          r[i] = qpos < S ? lse_bh[qpos] * kLog2e : -kNegInf * kLog2e;
          r[kStepRows + i] = qpos < S ? delta_bh[qpos] : 0.f;
        }
        mbar_arrive(bar_full(st));  // releases this lane's rows
      }
    }
  } else {
    // ---- two consumer warpgroups, 64 keys each
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
    const int g = threadIdx.x >> 7, tid = threadIdx.x & 127;
    const int w = tid >> 5, lane = tid & 31, tig = lane & 3;
    const int kg0 = k0 + 64 * g;                // this warpgroup's first key
    const int kpos0 = kg0 + 16 * w + (lane >> 2);  // the thread's first key
    const uint32_t ka = base + L::kA + g * 64 * kBoxBytes;
    const uint32_t va = base + L::kB + g * 64 * kBoxBytes;

    float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

    mbar_wait(bar_kv, 0);
    for (int t = t0; t < nq; ++t) {
      const int n = t - t0, st = n & 1;
      const int q0 = t * kStepRows;
      const uint32_t qb = base + L::kX + st * L::kStep, ob = base + L::kY + st * L::kStep;
      mbar_wait(bar_full(st), (n >> 1) & 1);
      if (causal && q0 + kStepRows - 1 < kg0) {  // every query before every key here
        mbar_arrive(bar_empty(st));
        continue;
      }

      // s^T = K Q^T and dp^T = V dO^T, 64 keys x 64 queries each
      float s[32], dp[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t col = (kk % 4) * 32;
        wgmma_ss_n64(s, kmajor_desc(ka + (kk / 4) * L::kOwnSlab + col),
                     kmajor_desc(qb + (kk / 4) * L::kStepSlab + col), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t col = (kk % 4) * 32;
        wgmma_ss_n64(dp, kmajor_desc(va + (kk / 4) * L::kOwnSlab + col),
                     kmajor_desc(ob + (kk / 4) * L::kStepSlab + col), kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        fence_reg(s[i]);
        fence_reg(dp[i]);
      }

      // scores in base 2: x = s * scale * log2(e); masked -> NEG_INF
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] *= c;
      if ((causal && q0 < kg0 + 63) || q0 + kStepRows > S || kg0 + 64 > S) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int qpos = q0 + 8 * (i / 4) + 2 * tig + (i % 2);
          const int kpos = kpos0 + 8 * ((i / 2) % 2);
          if (qpos >= S || kpos >= S || (causal && qpos < kpos)) s[i] = kNegInf;
        }
      }
      // p^T = exp2(x - lse * log2 e), ds^T = p^T (dp^T - delta), from the f32
      // p; each pair packed to bf16 as soon as it is made, so s and dp die
      // as the packs fill (dk and dv hold 128 registers at D = 128)
      const float* r = rows + st * 2 * kStepRows;
      uint32_t pa[4][4], da[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int rr = 0; rr < 4; ++rr) {
          const int i = 8 * kk + 2 * rr;                 // elements i, i + 1
          const int qc = 8 * (2 * kk + rr / 2) + 2 * tig;  // their query columns
          const float2 l2 = *reinterpret_cast<const float2*>(r + qc);
          const float2 dl = *reinterpret_cast<const float2*>(r + kStepRows + qc);
          const float p0 = exp2f(s[i] - l2.x), p1 = exp2f(s[i + 1] - l2.y);
          pa[kk][rr] = pack_bf16(p0, p1);
          da[kk][rr] = pack_bf16(p0 * (dp[i] - dl.x), p1 * (dp[i + 1] - dl.y));
        }
      }

      // dV += P^T dO and dK += dS^T Q: B MN-major, 16 queries a k-step
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs(dv_acc, pa[kk], mnmajor_desc(ob + kk * 16 * kBoxBytes, L::kStepSlab));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs(dk_acc, da[kk], mnmajor_desc(qb + kk * 16 * kBoxBytes, L::kStepSlab));
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int i = 0; i < D / 2; ++i) {
        fence_reg(dk_acc[i]);
        fence_reg(dv_acc[i]);
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          fence_reg(pa[kk][q]);
          fence_reg(da[kk][q]);
        }
      mbar_arrive(bar_empty(st));
    }

    // ---- epilogue: dv, then scale * dk, as bf16 rows
    __nv_bfloat16* stg = reinterpret_cast<__nv_bfloat16*>(gbase + L::kStage) + g * 64 * L::kOld;
    store_tile<D>(dv_acc, 1.f, stg, dv, b, h, kg0, S, H, g, tid);
    store_tile<D>(dk_acc, scale, stg, dk, b, h, kg0, S, H, g, tid);
  }
}

// ---------------------------------------------------------------------------
// dq: the CTA's 128 queries, two warpgroups of 64; kv tiles of 64 stream by.
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kThreadsSm90, 1)
flash_bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap tq,   // 128-row boxes
                         const __grid_constant__ CUtensorMap tdo,  // 128-row boxes
                         const __grid_constant__ CUtensorMap tk,   // 64-row boxes
                         const __grid_constant__ CUtensorMap tv,   // 64-row boxes
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         __nv_bfloat16* __restrict__ dq, int S, int H, float c, float scale,
                         int causal) {
  using L = BwdSmem<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - raw);
  const uint32_t bar_q = base + L::kBar;
  const auto bar_full = [&](int st) { return bar_q + 8 * (1 + st); };
  const auto bar_empty = [&](int st) { return bar_q + 8 * (3 + st); };

  // longest causal q tiles first over the whole grid
  const int nqt = gridDim.x;
  const int bh = gridDim.y * gridDim.z;
  const int lin = blockIdx.x + nqt * (blockIdx.y + gridDim.y * blockIdx.z);
  const int q0 = (nqt - 1 - lin / bh) * kOwnRows;
  const int h = (lin % bh) % H, b = (lin % bh) / H;
  int n_tiles = (S + kStepRows - 1) / kStepRows;
  if (causal) n_tiles = min(n_tiles, (q0 + kOwnRows - 1) / kStepRows + 1);

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int st = 0; st < 2; ++st) {
      mbar_init(bar_full(st), 1);
      mbar_init(bar_empty(st), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // ---- producer warpgroup: one thread issues every TMA load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x == kConsumers) {
      mbar_expect_tx(bar_q, 2 * L::kOwn);
#pragma unroll
      for (int sl = 0; sl < L::kSlabs; ++sl) {
        tma_load(base + L::kA + sl * L::kOwnSlab, &tq, bar_q, 64 * sl, h, q0, b);
        tma_load(base + L::kB + sl * L::kOwnSlab, &tdo, bar_q, 64 * sl, h, q0, b);
      }
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t & 1;
        mbar_wait(bar_empty(st), ((t >> 1) & 1) ^ 1);  // the first round passes
        mbar_expect_tx(bar_full(st), 2 * L::kStep);
#pragma unroll
        for (int sl = 0; sl < L::kSlabs; ++sl) {
          tma_load(base + L::kX + st * L::kStep + sl * L::kStepSlab, &tk, bar_full(st), 64 * sl,
                   h, t * kStepRows, b);
          tma_load(base + L::kY + st * L::kStep + sl * L::kStepSlab, &tv, bar_full(st), 64 * sl,
                   h, t * kStepRows, b);
        }
      }
    }
  } else {
    // ---- two consumer warpgroups, 64 query rows each
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int g = threadIdx.x >> 7, tid = threadIdx.x & 127;
    const int w = tid >> 5, lane = tid & 31, tig = lane & 3;
    const int qg0 = q0 + 64 * g;                // this warpgroup's first query
    const int qpos0 = qg0 + 16 * w + (lane >> 2);  // the thread's first query
    const uint32_t qa = base + L::kA + g * 64 * kBoxBytes;
    const uint32_t oa = base + L::kB + g * 64 * kBoxBytes;

    // the thread's two rows: lse * log2 e and delta (rows past S: the
    // forward's +1e30 pin, so their p is 0)
    float lse2[2], dlt[2];
    const long long row_base = (static_cast<long long>(b) * H + h) * S;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int qpos = qpos0 + 8 * hh;
      lse2[hh] = qpos < S ? lse[row_base + qpos] * kLog2e : -kNegInf * kLog2e;
      dlt[hh] = qpos < S ? delta[row_base + qpos] : 0.f;
    }
    // the last kv tile with a key at or before this warpgroup's last query
    const int last = causal ? min(n_tiles - 1, (qg0 + 63) / kStepRows) : n_tiles - 1;

    float dq_acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq_acc[i] = 0.f;

    mbar_wait(bar_q, 0);
    for (int t = 0; t < n_tiles; ++t) {
      const int st = t & 1;
      const int k0 = t * kStepRows;
      const uint32_t kb = base + L::kX + st * L::kStep, vb = base + L::kY + st * L::kStep;
      mbar_wait(bar_full(st), (t >> 1) & 1);
      if (t > last) {  // every key after every query here
        mbar_arrive(bar_empty(st));
        continue;
      }

      // s = Q K^T and dp = dO V^T, 64 queries x 64 keys each
      float s[32], dp[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t col = (kk % 4) * 32;
        wgmma_ss_n64(s, kmajor_desc(qa + (kk / 4) * L::kOwnSlab + col),
                     kmajor_desc(kb + (kk / 4) * L::kStepSlab + col), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t col = (kk % 4) * 32;
        wgmma_ss_n64(dp, kmajor_desc(oa + (kk / 4) * L::kOwnSlab + col),
                     kmajor_desc(vb + (kk / 4) * L::kStepSlab + col), kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        fence_reg(s[i]);
        fence_reg(dp[i]);
      }

#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] *= c;
      if ((causal && k0 + 63 > qg0) || k0 + kStepRows > S) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int kpos = k0 + 8 * (i / 4) + 2 * tig + (i % 2);
          const int qpos = qpos0 + 8 * ((i / 2) % 2);
          if (kpos >= S || (causal && kpos > qpos)) s[i] = kNegInf;
        }
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int hh = (i / 2) % 2;
        const float p = exp2f(s[i] - lse2[hh]);
        dp[i] = p * (dp[i] - dlt[hh]);
      }
      uint32_t da[4][4];
      pack_a(dp, da);

      // dQ += dS K: B = the K tile MN-major, 16 keys a k-step
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs(dq_acc, da[kk], mnmajor_desc(kb + kk * 16 * kBoxBytes, L::kStepSlab));
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int i = 0; i < D / 2; ++i) fence_reg(dq_acc[i]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int q = 0; q < 4; ++q) fence_reg(da[kk][q]);
      mbar_arrive(bar_empty(st));
    }

    __nv_bfloat16* stg = reinterpret_cast<__nv_bfloat16*>(gbase + L::kStage) + g * 64 * L::kOld;
    store_tile<D>(dq_acc, scale, stg, dq, b, h, qg0, S, H, g, tid);
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------
struct Args {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *dq, *dk, *dv;
  long long B, S, H;
  int causal;
  cudaStream_t stream;
};

// 1 / sqrt(D), and the scores' factor log2(e) / sqrt(D): the exponent
// runs in base 2
float scale_of(int d) { return static_cast<float>(1.0 / sqrt(static_cast<double>(d))); }
float fold_of(int d) { return scale_of(d) * kLog2e; }

dim3 grid_of(const Args& a) {
  return dim3(static_cast<unsigned>((a.S + kOwnRows - 1) / kOwnRows),
              static_cast<unsigned>(a.H), static_cast<unsigned>(a.B));
}

template <int D>
int launch_dkv(const Args& a) {
  using L = BwdSmem<D>;
  auto kernel = flash_bwd_dkv_sm90_kernel<D>;
  static PerDevice raised;
  cudaError_t e = raise_smem_limit(kernel, L::kBytes, raised);
  if (e != cudaSuccess) return static_cast<int>(e);
  EncodeTiled fn;
  if ((e = encoder(&fn)) != cudaSuccess) return static_cast<int>(e);
  CUtensorMap tk, tv, tq, tdo;
  if ((e = encode(fn, &tk, a.k, a.B, a.S, a.H, D, kOwnRows)) != cudaSuccess ||
      (e = encode(fn, &tv, a.v, a.B, a.S, a.H, D, kOwnRows)) != cudaSuccess ||
      (e = encode(fn, &tq, a.q, a.B, a.S, a.H, D, kStepRows)) != cudaSuccess ||
      (e = encode(fn, &tdo, a.dout, a.B, a.S, a.H, D, kStepRows)) != cudaSuccess)
    return static_cast<int>(e);
  kernel<<<grid_of(a), kThreadsSm90, L::kBytes, a.stream>>>(
      tk, tv, tq, tdo, static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<__nv_bfloat16*>(a.dk), static_cast<__nv_bfloat16*>(a.dv),
      static_cast<int>(a.S), static_cast<int>(a.H), fold_of(D), scale_of(D), a.causal);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dq(const Args& a) {
  using L = BwdSmem<D>;
  auto kernel = flash_bwd_dq_sm90_kernel<D>;
  static PerDevice raised;
  cudaError_t e = raise_smem_limit(kernel, L::kBytes, raised);
  if (e != cudaSuccess) return static_cast<int>(e);
  EncodeTiled fn;
  if ((e = encoder(&fn)) != cudaSuccess) return static_cast<int>(e);
  CUtensorMap tq, tdo, tk, tv;
  if ((e = encode(fn, &tq, a.q, a.B, a.S, a.H, D, kOwnRows)) != cudaSuccess ||
      (e = encode(fn, &tdo, a.dout, a.B, a.S, a.H, D, kOwnRows)) != cudaSuccess ||
      (e = encode(fn, &tk, a.k, a.B, a.S, a.H, D, kStepRows)) != cudaSuccess ||
      (e = encode(fn, &tv, a.v, a.B, a.S, a.H, D, kStepRows)) != cudaSuccess)
    return static_cast<int>(e);
  kernel<<<grid_of(a), kThreadsSm90, L::kBytes, a.stream>>>(
      tq, tdo, tk, tv, static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<__nv_bfloat16*>(a.dq), static_cast<int>(a.S), static_cast<int>(a.H), fold_of(D),
      scale_of(D), a.causal);
  return static_cast<int>(cudaGetLastError());
}

constexpr int kNothingToDo = -1;

bool aligned(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// 0: launch; kNothingToDo: an empty problem; else a cudaError_t
int check(const Args& a, long long D, long long dtype) {
  if (a.B < 0 || a.S < 0 || a.H < 0 || dtype != 1 || (D != 64 && D != 128) || !aligned(a.q) ||
      !aligned(a.k) || !aligned(a.v) || !aligned(a.dout))
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.S > 0x7fffffffLL || a.H > 65535 || a.B > 65535)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  return a.B == 0 || a.S == 0 || a.H == 0 ? kNothingToDo : 0;
}

}  // namespace

extern "C" {

// srt_flash_attn_bwd_dq's arguments: q, k, v, dout, dq contiguous
// [B, S, H, D]; lse, delta [B, H, S] f32. Takes dtype 1 (bf16) with D 64 or
// 128 and 16-byte-aligned q, k, v, dout and dq only; returns
// cudaErrorInvalidValue for anything else. Enqueued on `stream`, not waited.
int srt_flash_attn_bwd_dq_sm90(const void* q, const void* k, const void* v, const void* dout,
                               const void* lse, const void* delta, void* dq, long long B,
                               long long S, long long H, long long D, long long dtype,
                               long long causal, void* stream) {
  const Args a{q, k, v, dout, lse, delta, dq, nullptr, nullptr,
               B, S, H, causal != 0, static_cast<cudaStream_t>(stream)};
  if (!aligned(dq)) return static_cast<int>(cudaErrorInvalidValue);
  const int c = check(a, D, dtype);
  if (c != 0) return c == kNothingToDo ? 0 : c;
  return D == 64 ? launch_dq<64>(a) : launch_dq<128>(a);
}

// as srt_flash_attn_bwd_dq_sm90, writing dk and dv ([B, S, H, D] bf16,
// 16-byte-aligned)
int srt_flash_attn_bwd_dkv_sm90(const void* q, const void* k, const void* v, const void* dout,
                                const void* lse, const void* delta, void* dk, void* dv,
                                long long B, long long S, long long H, long long D,
                                long long dtype, long long causal, void* stream) {
  const Args a{q, k, v, dout, lse, delta, nullptr, dk, dv,
               B, S, H, causal != 0, static_cast<cudaStream_t>(stream)};
  if (!aligned(dk) || !aligned(dv)) return static_cast<int>(cudaErrorInvalidValue);
  const int c = check(a, D, dtype);
  if (c != 0) return c == kNothingToDo ? 0 : c;
  return D == 64 ? launch_dkv<64>(a) : launch_dkv<128>(a);
}

}  // extern "C"
