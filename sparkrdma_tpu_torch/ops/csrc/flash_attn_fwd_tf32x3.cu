// flash_attn_fwd_tf32x3.cu — the float32 flash-attention forward on the tensor
// cores, by 3xTF32 warp-level mma.sync, for sm_90a.
//
// Replaces, for float32 inputs with D 64 or 128, the Pallas TPU kernel of the
// JAX package's flash-attention forward, sparkrdma_tpu/ops/pallas_attention.py,
// which runs both of its products at precision=HIGHEST (full f32):
//   srt_flash_attn_fwd_tf32x3  <- _fwd_impl's pallas_call (:189): _kernel with
//                                 the per-row logsumexp, _kernel_no_lse without
// The SIMT srt_flash_attn_fwd (flash_attn_fwd.cu) keeps every other input.
//
// What it computes is what the SIMT kernel computes, on q, k, v laid out
// [B, S, H, D] (contiguous f32, 16-byte aligned) with scale = 1/sqrt(D):
//   out[b, s, h, :] = softmax(scale * q k^T + mask) v
//   lse[b, h, s]    = m + log(l)       (optional; +1e30 where l = 0)
// with the same masks (kv >= S; kv > q when causal), the -1e30 sentinel, the
// kv tiles in ascending order and the causal stop after the last live tile.
// Each product is three TF32 products of the operands' split, hi*lo + lo*hi +
// hi*hi (flash_attn_tf32x3_common.cuh): about 22 bits of each operand, the
// accuracy of an f32 product. The plain version is
// pallas_attention.flash_attention_tf32x3_reference.
//
// What bounds it on this card: arithmetic. Each (q, kv) pair costs 4*D flops
// (q k^T and p v), and each product runs as three TF32 tensor-core products,
// so the bound is 3 x 4*B*H*S^2*D flops (half of it causal) at 495 TFLOP/s.
//
// What the design does about it: the dq kernel of flash_attn_bwd_tf32x3.cu
// with one product fewer.
//   - One CTA per (b, h, 64-row q tile), the longest causal tiles first. Each
//     of its 4 warps owns 16 q rows; a lane holds rows g and g + 8 (g = lane
//     / 4), so the running max m and sum l are two floats a lane, and the
//     16 x D accumulator stays in registers for the whole walk over kv.
//   - q stays f32 in shared memory and is split into hi and lo as its A
//     fragments load; each streamed k and v tile (32 rows at both D) is
//     split once, as it is staged, into hi and lo planes that every warp
//     reads. The next tile's rows are loaded into registers before this
//     tile's products are issued (16 floats a thread of each of k and v at
//     D 64, 32 at D 128), so the global loads run under the products and
//     staging is a split and a store between two barriers.
//   - s = q k^T is issued term by term across its 4 independent
//     accumulators, the two small terms first (dependent terms stall a
//     warp), its loop over D unrolled in full.
//   - The online softmax runs in the C layout of s: a row's max and sum
//     reduce over the 4 lanes of a quad (shuffles by 1 and 2), and the
//     correction scales c0, c1 by row g's factor, c2, c3 by row g + 8's.
//   - p stays f32 in registers, is split there and becomes the A operand of
//     p v by the C->A permutation; v's B fragments read rows 2t and 2t + 1
//     (accumulate()). Nothing goes back through shared memory.
//   - Causal: a warp whose 16 rows all lie above a kv tile skips it (it still
//     joins both barriers) and leaves m, l and its accumulator as they are.
//   - Shared memory above 48 KiB through raise_smem_limit (launch_config.cuh):
//     52 KB a CTA at D 64 (3 CTAs an SM at its 150 registers), 101 KB at
//     D 128 (2 at 234). No atomics, so results are deterministic run to run.
// Each of these was chosen by timing it against its alternative on an
// H100 at the workload's B4 S2048 H8 D64 (PERF.md, section 6): 64-row kv
// tiles (2 CTAs an SM), 16-row tiles and q's split fragments held in
// registers ran slower; the register prefetch and the unrolled loop ran
// faster, and so did the explicit minimum of one CTA in __launch_bounds__
// (ptxas then schedules the D 64 kernel in 150 registers, not 141). At
// D 128, 32-row tiles with the prefetch ran faster than 16-row tiles.

#include "flash_attn_tf32x3_common.cuh"

namespace {

// Shared memory: the CTA's q rows as f32, then the streamed k and v tiles
// as hi and lo planes
template <int D, int TK>
struct FwdTiles {
  static constexpr int kLd = D + 4;
  static constexpr int kQPlane = kFixedRows * kLd;
  static constexpr int kStreamPlane = TK * kLd;
  static constexpr size_t kSmemBytes = sizeof(float) * (kQPlane + 4 * kStreamPlane);
};

// s = A B^T for a warp's 16 q rows (f32 plane a at the warp's first row,
// split as loaded) against the N streamed rows (hi/lo planes bh/bl): s[j] is
// the 16 x 8 C tile of streamed rows 8j..8j+7. The one-product form of
// flash_attn_bwd_tf32x3.cu's scores().
template <int D, int N>
__device__ __forceinline__ void scores(float (&s)[N / 8][4], const float* a, const float* bh,
                                       const float* bl, int g, int t) {
  constexpr int kLd = D + 4, J = N / 8;
#pragma unroll
  for (int j = 0; j < J; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
  for (int d0 = 0; d0 < D; d0 += 8) {
    uint32_t x_hi[4], x_lo[4];
    load_a_split(x_hi, x_lo, a + d0, kLd, g, t);
    uint32_t u_hi[J][2], u_lo[J][2];
#pragma unroll
    for (int j = 0; j < J; ++j) {
      load_b_rows(u_hi[j], bh + j * 8 * kLd + d0, kLd, g, t);
      load_b_rows(u_lo[j], bl + j * 8 * kLd + d0, kLd, g, t);
    }
#pragma unroll
    for (int j = 0; j < J; ++j) mma_tf32(s[j], x_hi, u_lo[j]);
#pragma unroll
    for (int j = 0; j < J; ++j) mma_tf32(s[j], x_lo, u_hi[j]);
#pragma unroll
    for (int j = 0; j < J; ++j) mma_tf32(s[j], x_hi, u_hi[j]);
  }
}

// Rows [row0, row0 + TK) of one (b, h) slice of an f32 [B, S, H, D] tensor
// held in registers, kPer float4 a thread; rows >= S are 0. `src` points at
// (b, 0, h, 0), 16-byte aligned; consecutive rows are `rs` apart.
template <int D, int TK>
struct TileRegs {
  static constexpr int kPerRow = D / 4, kPer = TK * kPerRow / kThreads;
  static_assert(TK * kPerRow % kThreads == 0, "a tile is a whole number of float4 a thread");
  float4 x[kPer];

  __device__ __forceinline__ void load(const float* __restrict__ src, long long rs, int row0,
                                       int S) {
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int i = threadIdx.x + u * kThreads;
      const int r = i / kPerRow, c = (i - r * kPerRow) * 4;
      x[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row0 + r < S) x[u] = __ldg(reinterpret_cast<const float4*>(src + (row0 + r) * rs + c));
    }
  }

  // the rows as hi and lo planes (row stride D + 4), as stage_split stores them
  __device__ __forceinline__ void store_split(float* __restrict__ hi,
                                              float* __restrict__ lo) const {
    constexpr int kLd = D + 4;
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int i = threadIdx.x + u * kThreads;
      const int r = i / kPerRow, c = (i - r * kPerRow) * 4;
      uint32_t h[4], l[4];
      split(x[u].x, h[0], l[0]);
      split(x[u].y, h[1], l[1]);
      split(x[u].z, h[2], l[2]);
      split(x[u].w, h[3], l[3]);
      *reinterpret_cast<uint4*>(hi + r * kLd + c) = make_uint4(h[0], h[1], h[2], h[3]);
      *reinterpret_cast<uint4*>(lo + r * kLd + c) = make_uint4(l[0], l[1], l[2], l[3]);
    }
  }
};

// max and sum over the 4 lanes of a quad (the lanes that hold one row)
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <int D, int TK>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_tf32x3_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, float* __restrict__ out,
                        float* __restrict__ lse, int S, int H, float scale, int causal) {
  using C = FwdTiles<D, TK>;
  constexpr int kLd = C::kLd;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Kh = Qs + C::kQPlane;
  float* Kl = Kh + C::kStreamPlane;
  float* Vh = Kl + C::kStreamPlane;
  float* Vl = Vh + C::kStreamPlane;

  // longest causal tiles first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kFixedRows;
  const int h = blockIdx.y, b = blockIdx.z;
  const long long rs = static_cast<long long>(H) * D;
  const long long base = (static_cast<long long>(b) * S * H + h) * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int qw = q0 + warp * kWarpRows;  // the warp's first q row

  stage_rows(Qs, kLd, D, q + base, rs, q0, kFixedRows, S, D, true);
  const float* qs = Qs + warp * kWarpRows * kLd;

  // the lane's two rows, g and g + 8: running max and sum
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  int n_tiles = (S + TK - 1) / TK;
  if (causal) n_tiles = min(n_tiles, (q0 + kFixedRows - 1) / TK + 1);
  TileRegs<D, TK> kn, vn;  // the next k and v tiles
  kn.load(k + base, rs, 0, S);
  vn.load(v + base, rs, 0, S);
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * TK;
    __syncthreads();  // every warp is done with the previous k/v tile
    kn.store_split(Kh, Kl);
    vn.store_split(Vh, Vl);
    __syncthreads();
    if (tile + 1 < n_tiles) {  // the next tile's loads run under this tile's products
      kn.load(k + base, rs, k0 + TK, S);
      vn.load(v + base, rs, k0 + TK, S);
    }
    // causal: every kv of this tile is above every q row of this warp
    if (causal && k0 > qw + kWarpRows - 1) continue;

    float s[TK / 8][4];
    scores<D, TK>(s, qs, Kh, Kl, g, t);

    // mask, then the online-softmax update in _kernel's order:
    // m_new = max(m, rowmax s), corr = exp(m - m_new), p = exp(s - m_new),
    // l = l corr + rowsum p, acc = acc corr + p v
    float m_new[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < TK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qpos = qw + g + (e >> 1) * 8;
        const int kpos = k0 + 8 * j + 2 * t + (e & 1);
        const bool live = kpos < S && (!causal || qpos >= kpos);
        s[j][e] = live ? s[j][e] * scale : kNegInf;
        m_new[e >> 1] = fmaxf(m_new[e >> 1], s[j][e]);
      }
    }
    float corr[2], psum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m_new[r] = quad_max(m_new[r]);
      corr[r] = expf(m[r] - m_new[r]);
      m[r] = m_new[r];
    }
#pragma unroll
    for (int j = 0; j < TK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[j][e] - m[e >> 1]);
        s[j][e] = p;
        psum[e >> 1] += p;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + quad_sum(psum[r]);
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }

    // acc += p v
    accumulate<D, TK, 8>(acc, s, Vh, Vl, g, t);
  }

  // finalize: l == 0 cannot occur for q < S (every row sees kv 0), but keep
  // the TPU kernel's guard and its lse pin; rows >= S are never written
  const long long row_base = (static_cast<long long>(b) * H + h) * S;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = qw + g + 8 * half;
    if (row >= S) continue;
    const float denom = l[half] > 0.f ? l[half] : 1.f;
    float* p = out + base + row * rs + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<float2*>(p + 8 * n) =
          make_float2(acc[n][2 * half] / denom, acc[n][2 * half + 1] / denom);
    if (lse != nullptr && t == 0)
      lse[row_base + row] = l[half] > 0.f ? m[half] + logf(denom) : -kNegInf;
  }
}

template <int D, int TK>
int launch(const float* q, const float* k, const float* v, float* out, float* lse,
           long long B, long long S, long long H, long long causal, cudaStream_t stream) {
  auto kernel = flash_fwd_tf32x3_kernel<D, TK>;
  constexpr size_t kBytes = FwdTiles<D, TK>::kSmemBytes;
  static PerDevice raised;
  if (const cudaError_t e = raise_smem_limit(kernel, static_cast<int>(kBytes), raised))
    return static_cast<int>(e);
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(D)));
  kernel<<<dim3(static_cast<unsigned>((S + kFixedRows - 1) / kFixedRows),
                static_cast<unsigned>(H), static_cast<unsigned>(B)),
           kThreads, kBytes, stream>>>(q, k, v, out, lse, static_cast<int>(S),
                                       static_cast<int>(H), scale, causal != 0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// q, k, v, out: contiguous f32 [B, S, H, D], 16-byte aligned, D 64 or 128;
// lse: [B, H, S] f32 or null; dtype must be 0 (f32). The SIMT
// srt_flash_attn_fwd's argument list; the inputs pallas_attention.fwd_entry
// sends here. Enqueued on `stream`, not waited.
int srt_flash_attn_fwd_tf32x3(const void* q, const void* k, const void* v, void* out, void* lse,
                              long long B, long long S, long long H, long long D,
                              long long dtype, long long causal, void* stream) {
  const auto aligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  if (B < 0 || S < 0 || H < 0 || (D != 64 && D != 128) || dtype != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!(aligned(q) && aligned(k) && aligned(v) && aligned(out)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (S > 0x7fffffffLL || H > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  if (B == 0 || S == 0 || H == 0) return 0;
  const auto* fq = static_cast<const float*>(q);
  const auto* fk = static_cast<const float*>(k);
  const auto* fv = static_cast<const float*>(v);
  auto* fo = static_cast<float*>(out);
  auto* fl = static_cast<float*>(lse);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return D == 64 ? launch<64, 32>(fq, fk, fv, fo, fl, B, S, H, causal, st)
                 : launch<128, 32>(fq, fk, fv, fo, fl, B, S, H, causal, st);
}

}  // extern "C"
