// flash_attn_fwd_sm90.cu — the bf16 flash-attention forward on Hopper's
// tensor cores (wgmma + TMA), for sm_90a.
//
// Replaces the Pallas TPU kernel of the JAX package's flash attention
// forward for bf16 inputs, sparkrdma_tpu/ops/pallas_attention.py:
//   srt_flash_attn_fwd_sm90  <- _fwd_impl's pallas_call (:189; _kernel with
//                               the per-row logsumexp, _kernel_no_lse without)
// The wrapper (ops/pallas_attention.py) sends bf16 inputs with D in {64, 128}
// and 16-byte-aligned q/k/v/out here; every other input takes
// srt_flash_attn_fwd (flash_attn_fwd.cu).
//
// What it computes is srt_flash_attn_fwd's function, on q, k, v laid out
// [B, S, H, D] (contiguous bf16) with scale = 1/sqrt(D):
//   out[b, s, h, :] = softmax(scale * q k^T + mask) v      (bf16)
//   lse[b, h, s]    = m + log(l)                           (f32, optional)
// with the TPU kernel's numerics for bf16 (`precision=DEFAULT`): q.k^T
// from bf16 operands with f32 accumulation, p rounded to bf16 before p.v
// with f32 accumulation (the MXU's one bf16 pass), l summed from the f32 p.
// Masked scores take the sentinel NEG_INF = -1e30; kv >= S is masked and,
// if causal, kv > q; rows with l == 0 get the lse pin -NEG_INF.
//
// What bounds it on this card: operations. 4*B*H*D*S^2 flops (about half
// of that causal) against 8*B*S*H*D bytes moved: at the bench shape (B4
// S2048 H8 D128 causal) 34.4 GFLOP and 33.6 MB, so the 989 TFLOP/s bf16
// tensor-core rate, not the 3.35 TB/s of memory, sets the floor.
//
// What the design does about it:
//   - both products run on the tensor cores with wgmma: S = Q K^T as
//     m64n128k16 with Q and K read from shared memory (K-major), and
//     O += P V as m64n{D}k16 with P in registers (the S accumulator
//     converted to bf16 in place: its fragment is the A operand's) and V
//     read from shared memory MN-major (the transpose flag);
//   - one CTA owns a (b, h, 128-row q tile): two consumer warpgroups of 64
//     query rows each, and one producer warp that issues every load with
//     TMA. K/V tiles of 128 keys cycle through a 2-stage ring in shared
//     memory behind "full" (TMA bytes) and "empty" (consumer) mbarriers,
//     so the next tile's loads overlap this tile's products. setmaxnreg
//     moves registers from the producer to the consumers;
//   - tiles arrive 128-byte swizzled (one box is 64 bf16 = 128 bytes, so a
//     D = 128 row is two boxes), the layout wgmma's descriptors read
//     without bank conflicts. Rows >= S come back zero-filled: no pad;
//   - the online softmax runs on the accumulator fragment in registers:
//     a row lives in 4 lanes (max by shfl_xor 1, 2), exp2 with
//     scale * log2(e) folded in, masks only on the causal diagonal tile
//     and the ragged last tile, and the kv loop stops after the last live
//     tile (the TPU kernel's block skip). q tiles are issued longest first
//     across the whole grid, so the short causal tiles fill the tail;
//   - the epilogue divides by l, rounds to bf16 (nearest even), stages the
//     tile in shared memory and writes it with 16-byte stores.

#include <cstdint>
#include <cuda.h>  // CUtensorMap and its enums only: the encoder is reached
                   // through cudaGetDriverEntryPoint, so nothing links -lcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kRows = 128;         // q rows of a CTA, keys of a kv tile
constexpr int kBoxBytes = 128;     // one swizzled box row: 64 bf16
constexpr int kHalfBytes = kRows * kBoxBytes;  // one 64-column slab of a tile
constexpr int kConsumers = 256;    // two warpgroups
constexpr int kThreadsSm90 = 384;  // + the producer warpgroup

template <int D>
struct Smem {
  static constexpr int kSlabs = D / 64;
  static constexpr int kTile = kSlabs * kHalfBytes;  // a Q, K or V tile
  static constexpr int kOld = D + 8;  // staging row, bf16: 16 bytes of skew
  static constexpr int kQ = 0;
  static constexpr int kK = kTile;       // K stage s at kK + s * kTile
  static constexpr int kV = 3 * kTile;   // V stage s at kV + s * kTile
  static constexpr int kO = 5 * kTile;   // [2 warpgroups][64][kOld] bf16
  static constexpr int kBar = kO + 2 * 64 * kOld * 2;
  static constexpr int kBytes = kBar + 7 * 8 + 1024;  // + alignment slack
};

// ---- PTX wrappers -----------------------------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// Returns once the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int d0, int h, int s0, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(d0), "r"(h), "r"(s0), "r"(b), "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets, all in 16-byte units.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 | 1ull << 62;
}
// K-major (Q and K rows, d contiguous): 8-row groups 1024 bytes apart; the
// leading offset is unused inside one swizzle span.
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr) {
  return sw128_desc(addr, 16, 1024);
}
// MN-major (V rows read as B = keys x d): 8-key groups 1024 bytes apart,
// the next 64 columns of d one slab further on.
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t addr) {
  return sw128_desc(addr, kHalfBytes, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// Keep the compiler from moving reads of an accumulator, or reuse of an A
// register, across the asynchronous products.
__device__ __forceinline__ void fence_reg(float& r) { asm volatile("" : "+f"(r)::"memory"); }
__device__ __forceinline__ void fence_reg(uint32_t& r) { asm volatile("" : "+r"(r)::"memory"); }

#define SRT_ACC8(d, i)                                                              \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),       \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d[64] (+)= A[64x16] B[16x128]: A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : SRT_ACC8(d, 0), SRT_ACC8(d, 8), SRT_ACC8(d, 16), SRT_ACC8(d, 24), SRT_ACC8(d, 32),
        SRT_ACC8(d, 40), SRT_ACC8(d, 48), SRT_ACC8(d, 56)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64] += A[64x16] B[16x128]: A in registers, B MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : SRT_ACC8(d, 0), SRT_ACC8(d, 8), SRT_ACC8(d, 16), SRT_ACC8(d, 24), SRT_ACC8(d, 32),
        SRT_ACC8(d, 40), SRT_ACC8(d, 48), SRT_ACC8(d, 56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[32] += A[64x16] B[16x64]: A in registers, B MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : SRT_ACC8(d, 0), SRT_ACC8(d, 8), SRT_ACC8(d, 16), SRT_ACC8(d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef SRT_ACC8

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // nearest even
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Accumulator fragment of a 64-row wgmma, thread t of the warpgroup,
// element i: row 16 * (t / 32) + (t % 32) / 4 + 8 * ((i / 2) % 2), column
// 8 * (i / 4) + 2 * (t % 4) + i % 2. So a thread holds two rows (hh = 0,
// 1) and a row lives in the 4 lanes of a quad.
template <int D>
__global__ void __launch_bounds__(kThreadsSm90, 1)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ out,
                      float* __restrict__ lse, int S, int H, float c, int causal) {
  using L = Smem<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzled tiles: 1024-aligned
  uint8_t* const gbase = smem_raw + (base - raw);
  const uint32_t bar_q = base + L::kBar;
  const auto bar_k = [&](int st) { return bar_q + 8 * (1 + st); };
  const auto bar_v = [&](int st) { return bar_q + 8 * (3 + st); };
  const auto bar_empty = [&](int st) { return bar_q + 8 * (5 + st); };

  // longest causal q tiles first over the whole grid: the q tile is the
  // slowest-moving part of the linear block index
  const int nq = gridDim.x;
  const int bh = gridDim.y * gridDim.z;
  const int lin = blockIdx.x + nq * (blockIdx.y + gridDim.y * blockIdx.z);
  const int qt = nq - 1 - lin / bh;
  const int h = (lin % bh) % H, b = (lin % bh) / H;
  const int q0 = qt * kRows;
  int n_tiles = (S + kRows - 1) / kRows;
  if (causal) n_tiles = min(n_tiles, qt + 1);

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int st = 0; st < 2; ++st) {
      mbar_init(bar_k(st), 1);
      mbar_init(bar_v(st), 1);
      mbar_init(bar_empty(st), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // ---- producer warpgroup: one thread issues every TMA load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x == kConsumers) {
      mbar_expect_tx(bar_q, L::kTile);
#pragma unroll
      for (int sl = 0; sl < L::kSlabs; ++sl)
        tma_load(base + L::kQ + sl * kHalfBytes, &tq, bar_q, 64 * sl, h, q0, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t & 1;
        mbar_wait(bar_empty(st), ((t >> 1) & 1) ^ 1);  // the first round passes
        const uint32_t kb = base + L::kK + st * L::kTile, vb = base + L::kV + st * L::kTile;
        mbar_expect_tx(bar_k(st), L::kTile);
#pragma unroll
        for (int sl = 0; sl < L::kSlabs; ++sl)
          tma_load(kb + sl * kHalfBytes, &tk, bar_k(st), 64 * sl, h, t * kRows, b);
        mbar_expect_tx(bar_v(st), L::kTile);
#pragma unroll
        for (int sl = 0; sl < L::kSlabs; ++sl)
          tma_load(vb + sl * kHalfBytes, &tv, bar_v(st), 64 * sl, h, t * kRows, b);
      }
    }
  } else {
    // ---- two consumer warpgroups, 64 query rows each
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int g = threadIdx.x >> 7, tid = threadIdx.x & 127;
    const int w = tid >> 5, lane = tid & 31, tig = lane & 3;
    const int r_loc = 16 * w + (lane >> 2);  // the thread's first row in its 64
    const int row0 = 64 * g + r_loc;         // ... in the CTA's 128
    const uint32_t qa = base + L::kQ + g * 64 * kBoxBytes;

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

    mbar_wait(bar_q, 0);
    for (int t = 0; t < n_tiles; ++t) {
      const int st = t & 1;
      const uint32_t par = (t >> 1) & 1;
      const uint32_t kb = base + L::kK + st * L::kTile, vb = base + L::kV + st * L::kTile;

      // S = Q K^T, 64 x 128 per warpgroup
      float s[64];
      mbar_wait(bar_k(st), par);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk / 4) * kHalfBytes + (kk % 4) * 32;
        wgmma_ss_n128(s, kmajor_desc(qa + off), kmajor_desc(kb + off), kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int i = 0; i < 64; ++i) fence_reg(s[i]);

      // scores in base 2: x = s * scale * log2(e); masked -> NEG_INF
      const int k0 = t * kRows;
#pragma unroll
      for (int i = 0; i < 64; ++i) s[i] *= c;
      if (k0 + kRows > S || (causal && k0 + kRows - 1 > q0)) {
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          const int kpos = k0 + 8 * (i / 4) + 2 * tig + (i % 2);
          const int qpos = q0 + row0 + 8 * ((i / 2) % 2);
          if (kpos >= S || (causal && kpos > qpos)) s[i] = kNegInf;
        }
      }

      // online softmax, _kernel's order: m_new, corr, p, l, acc
      float corr[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float mx = m[hh];
#pragma unroll
        for (int j = 0; j < 16; ++j)
          mx = fmaxf(mx, fmaxf(s[4 * j + 2 * hh], s[4 * j + 2 * hh + 1]));
        mx = quad_max(mx);
        corr[hh] = exp2f(m[hh] - mx);
        m[hh] = mx;
        l[hh] *= corr[hh];
      }
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= corr[(i / 2) % 2];
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        s[i] = exp2f(s[i] - m[(i / 2) % 2]);
        l[(i / 2) % 2] += s[i];  // this thread's share; the quad sums at the end
      }

      // P to bf16 in registers: columns 16 kk .. 16 kk + 15 of the S
      // fragment are the A fragment of k-step kk
      uint32_t pa[8][4];
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) pa[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);

      // O += P V
      mbar_wait(bar_v(st), par);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) wgmma_rs(o, pa[kk], mnmajor_desc(vb + kk * 16 * kBoxBytes));
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int i = 0; i < D / 2; ++i) fence_reg(o[i]);
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) fence_reg(pa[kk][r]);
      mbar_arrive(bar_empty(st));
    }

    // ---- epilogue: O / l to bf16, staged, then 16-byte stores
    float denom[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      l[hh] = quad_sum(l[hh]);
      denom[hh] = l[hh] > 0.f ? l[hh] : 1.f;
    }
    __nv_bfloat16* stg = reinterpret_cast<__nv_bfloat16*>(gbase + L::kO) + g * 64 * L::kOld;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        *reinterpret_cast<__nv_bfloat162*>(stg + (r_loc + 8 * hh) * L::kOld + 8 * j + 2 * tig) =
            __floats2bfloat162_rn(o[4 * j + 2 * hh] / denom[hh], o[4 * j + 2 * hh + 1] / denom[hh]);
      }
    }
    if (lse != nullptr && tig == 0) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int qpos = q0 + row0 + 8 * hh;
        if (qpos < S) {
          lse[(static_cast<long long>(b) * H + h) * S + qpos] =
              l[hh] > 0.f ? m[hh] * 0.69314718055994531f + logf(l[hh]) : -kNegInf;
        }
      }
    }
    asm volatile("bar.sync %0, 128;" ::"r"(1 + g) : "memory");  // this warpgroup only
    constexpr int kChunks = D / 8;  // 16-byte chunks a row
    for (int idx = tid; idx < 64 * kChunks; idx += 128) {
      const int r = idx / kChunks, ch = idx % kChunks;
      const int qpos = q0 + 64 * g + r;
      if (qpos < S) {
        *reinterpret_cast<uint4*>(out + ((static_cast<long long>(b) * S + qpos) * H + h) * D +
                                  8 * ch) =
            *reinterpret_cast<const uint4*>(stg + r * L::kOld + 8 * ch);
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded.
cudaError_t encoder(EncodeTiled* fn) {
  static EncodeTiled cached = nullptr;
  if (cached == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
    if (e != cudaSuccess) return e;
    if (found != cudaDriverEntryPointSuccess || p == nullptr) return cudaErrorSymbolNotFound;
    cached = reinterpret_cast<EncodeTiled>(p);
  }
  *fn = cached;
  return cudaSuccess;
}

// One map over the [B, S, H, D] tensor as the 4-D (D, H, S, B), innermost
// first; a box is 64 columns of d x 1 head x 128 rows x 1 batch, 128-byte
// swizzled; rows past S read as zeros.
cudaError_t encode(EncodeTiled fn, CUtensorMap* map, const void* ptr, long long B, long long S,
                   long long H, long long D) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(S), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(D * 2), static_cast<cuuint64_t>(H * D * 2),
                                 static_cast<cuuint64_t>(S * H * D * 2)};
  const cuuint32_t box[4] = {64, 1, kRows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r =
      fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box,
         unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
         CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, void* lse, long long B,
           long long S, long long H, long long causal, cudaStream_t stream) {
  using L = Smem<D>;
  auto kernel = flash_fwd_sm90_kernel<D>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  EncodeTiled fn;
  cudaError_t e = encoder(&fn);
  if (e != cudaSuccess) return static_cast<int>(e);
  CUtensorMap tq, tk, tv;
  if ((e = encode(fn, &tq, q, B, S, H, D)) != cudaSuccess ||
      (e = encode(fn, &tk, k, B, S, H, D)) != cudaSuccess ||
      (e = encode(fn, &tv, v, B, S, H, D)) != cudaSuccess)
    return static_cast<int>(e);
  const long long q_tiles = (S + kRows - 1) / kRows;
  // log2(e) / sqrt(D): the softmax runs in base 2
  const float c = static_cast<float>(1.4426950408889634 / sqrt(static_cast<double>(D)));
  kernel<<<dim3(static_cast<unsigned>(q_tiles), static_cast<unsigned>(H),
                static_cast<unsigned>(B)),
           kThreadsSm90, L::kBytes, stream>>>(tq, tk, tv, static_cast<__nv_bfloat16*>(out),
                                              static_cast<float*>(lse), static_cast<int>(S),
                                              static_cast<int>(H), c, causal != 0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// srt_flash_attn_fwd's arguments: q, k, v, out contiguous [B, S, H, D];
// lse [B, H, S] f32 or null. Takes dtype 1 (bf16) with D 64 or 128 and
// 16-byte-aligned q, k, v and out only; returns cudaErrorInvalidValue for
// anything else. Enqueued on `stream`, not waited.
int srt_flash_attn_fwd_sm90(const void* q, const void* k, const void* v, void* out, void* lse,
                            long long B, long long S, long long H, long long D,
                            long long dtype, long long causal, void* stream) {
  const auto aligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  if (B < 0 || S < 0 || H < 0 || dtype != 1 || (D != 64 && D != 128) || !aligned(q) ||
      !aligned(k) || !aligned(v) || !aligned(out))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || S == 0 || H == 0) return 0;
  if (S > 0x7fffffffLL || H > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return D == 64 ? launch<64>(q, k, v, out, lse, B, S, H, causal, st)
                 : launch<128>(q, k, v, out, lse, B, S, H, causal, st);
}

}  // extern "C"
