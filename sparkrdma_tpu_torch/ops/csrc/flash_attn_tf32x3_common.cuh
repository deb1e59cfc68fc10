// flash_attn_tf32x3_common.cuh — the 3xTF32 warp-level mma.sync building
// blocks shared by the float32 flash-attention kernels on the tensor cores
// (flash_attn_fwd_tf32x3.cu, flash_attn_bwd_tf32x3.cu): the TF32 split, the
// m16n8k8 product, its fragment loads, the staging of a streamed tile as hi
// and lo planes, the accumulator-as-A product and the row stores. Each .cu
// file includes it into its own translation unit.
//
// 3xTF32: each f32 operand x is split as hi = x rounded to TF32 (10 mantissa
// bits, to nearest, ties away from zero: cvt.rna.tf32.f32, done here on the
// bits) and lo = (x - hi) rounded the same way; x - hi is exact. Then
// a*b ~ hi_a*lo_b + lo_a*hi_b + hi_a*hi_b, accumulated in f32, the two small
// terms first, lo_a*lo_b (below 2^-22 of the product) dropped.
//
// Fragments of mma.sync.m16n8k8 (g = lane / 4, t = lane % 4): A a0 (g, t),
// a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4); B b0 (k t, n g), b1 (k t+4, n g);
// C c0, c1 at (g, 2t), (g, 2t+1), c2, c3 at (g+8, 2t), (g+8, 2t+1). Planes
// in shared memory have rows D + 4 floats apart, so both load patterns,
// [g][t] and [2t][g], are free of bank conflicts.
#pragma once

#include "flash_attn_common.cuh"

namespace {

constexpr int kWarpRows = 16;                    // fixed rows a warp owns
constexpr int kFixedRows = kWarps * kWarpRows;   // fixed rows a CTA owns

// ---------------------------------------------------------------------------
// the split, the mma, the fragment loads
// ---------------------------------------------------------------------------
// x rounded to TF32, to nearest with ties away from zero (cvt.rna.tf32.f32 on
// finite x), as the bits of an f32 whose low 13 bits are clear
__device__ __forceinline__ uint32_t tf32_round(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_round(x);
  lo = tf32_round(x - __uint_as_float(hi));
}

// d += a b, one m16n8k8 TF32 product into f32
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t lds(const float* p) { return __float_as_uint(*p); }

// A fragment of 16 rows x 8 columns of a row-major f32 plane (row stride
// ld), split into hi and lo
__device__ __forceinline__ void load_a_split(uint32_t (&hi)[4], uint32_t (&lo)[4], const float* p,
                                             int ld, int g, int t) {
  split(p[g * ld + t], hi[0], lo[0]);
  split(p[(g + 8) * ld + t], hi[1], lo[1]);
  split(p[g * ld + t + 4], hi[2], lo[2]);
  split(p[(g + 8) * ld + t + 4], hi[3], lo[3]);
}

// B fragment b[k][n] = plane[n][k] (the plane's rows are B's columns)
__device__ __forceinline__ void load_b_rows(uint32_t (&b)[2], const float* p, int ld, int g,
                                            int t) {
  b[0] = lds(p + g * ld + t);
  b[1] = lds(p + g * ld + t + 4);
}

// B fragment b[k][n] = plane[k'][n], k' the permuted k: k t -> row 2t,
// k t+4 -> row 2t+1 (the accumulator-as-A order)
__device__ __forceinline__ void load_b_permuted(uint32_t (&b)[2], const float* p, int ld, int g,
                                                int t) {
  b[0] = lds(p + (2 * t) * ld + g);
  b[1] = lds(p + (2 * t + 1) * ld + g);
}

// Stage rows [row0, row0 + nrows) of one (b, h) slice of an f32 [B, S, H, D]
// tensor as hi and lo planes (row stride D + 4); rows >= S are 0. `src`
// points at (b, 0, h, 0), 16-byte aligned; consecutive rows are `rs` apart.
template <int D>
__device__ __forceinline__ void stage_split(float* __restrict__ hi, float* __restrict__ lo,
                                            const float* __restrict__ src, long long rs,
                                            int row0, int nrows, int S) {
  constexpr int kLd = D + 4, kPerRow = D / 4;
  for (int i = threadIdx.x; i < nrows * kPerRow; i += kThreads) {
    const int r = i / kPerRow, c = (i - r * kPerRow) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < S) x = __ldg(reinterpret_cast<const float4*>(src + (row0 + r) * rs + c));
    uint32_t h[4], l[4];
    split(x.x, h[0], l[0]);
    split(x.y, h[1], l[1]);
    split(x.z, h[2], l[2]);
    split(x.w, h[3], l[3]);
    *reinterpret_cast<uint4*>(hi + r * kLd + c) = make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(lo + r * kLd + c) = make_uint4(l[0], l[1], l[2], l[3]);
  }
}

// The three terms of a 3xTF32 product a b into one accumulator depend on
// each other, and a warp issues in order: so every product below is issued
// term by term across several independent accumulators (hi lo, then lo hi,
// then hi hi: the two small terms first, lo lo dropped), keeping the tensor
// cores fed from the few warps (2 or 3) a scheduler holds.

// acc += P B for a warp's 16 rows: P (16 x N) in the C layout of scores(),
// B the N streamed rows x D (planes bh/bl); acc[n] is the 16 x 8 C tile of
// columns 8n..8n+7, issued NG column tiles at a time
template <int D, int N, int NG>
__device__ __forceinline__ void accumulate(float (&acc)[D / 8][4], const float (&pc)[N / 8][4],
                                           const float* bh, const float* bl, int g, int t) {
  constexpr int kLd = D + 4;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    // A column t is P column 2t, A column t+4 is P column 2t+1
    uint32_t a_hi[4], a_lo[4];
    split(pc[j][0], a_hi[0], a_lo[0]);
    split(pc[j][2], a_hi[1], a_lo[1]);
    split(pc[j][1], a_hi[2], a_lo[2]);
    split(pc[j][3], a_hi[3], a_lo[3]);
#pragma unroll
    for (int n0 = 0; n0 < D / 8; n0 += NG) {
      uint32_t b_hi[NG][2], b_lo[NG][2];
#pragma unroll
      for (int n = 0; n < NG; ++n) {
        load_b_permuted(b_hi[n], bh + j * 8 * kLd + (n0 + n) * 8, kLd, g, t);
        load_b_permuted(b_lo[n], bl + j * 8 * kLd + (n0 + n) * 8, kLd, g, t);
      }
#pragma unroll
      for (int n = 0; n < NG; ++n) mma_tf32(acc[n0 + n], a_hi, b_lo[n]);
#pragma unroll
      for (int n = 0; n < NG; ++n) mma_tf32(acc[n0 + n], a_lo, b_hi[n]);
#pragma unroll
      for (int n = 0; n < NG; ++n) mma_tf32(acc[n0 + n], a_hi, b_hi[n]);
    }
  }
}

// Write a warp's 16 x D accumulator times `mul` to rows row0.. (< S)
template <int D>
__device__ __forceinline__ void store_rows(float* __restrict__ dst, long long rs, int row0,
                                           int S, const float (&acc)[D / 8][4], float mul, int g,
                                           int t) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + g + 8 * half;
    if (row >= S) continue;
    float* p = dst + row * rs + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<float2*>(p + 8 * n) =
          make_float2(acc[n][2 * half] * mul, acc[n][2 * half + 1] * mul);
  }
}

}  // namespace
