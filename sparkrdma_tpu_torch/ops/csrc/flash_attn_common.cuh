// flash_attn_common.cuh — staging helpers shared by the flash-attention
// kernels (flash_attn_fwd.cu, flash_attn_bwd.cu): 128-thread CTAs, the TPU
// kernels' NEG_INF sentinel, and [B, S, H, D] rows staged into shared
// memory as f32. Each .cu file includes it into its own translation unit.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_as(float* p, float x) { *p = x; }
// __float2bfloat16 rounds to nearest even, as torch and XLA do
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// 16 bytes of T widened to f32
__device__ __forceinline__ void widen(const uint4& raw, float* f, float) {
  const float4 v = *reinterpret_cast<const float4*>(&raw);
  f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
}
__device__ __forceinline__ void widen(const uint4& raw, float* f, __nv_bfloat16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

// Stage rows [row0, row0 + nrows) of one (b, h) slice into dst (row
// stride ld floats, dp columns), as f32; columns >= D and rows >= S are 0.
// `src` points at (b, 0, h, 0); consecutive rows are `rs` elements apart.
template <typename T>
__device__ __forceinline__ void stage_rows(float* __restrict__ dst, int ld, int dp,
                                           const T* __restrict__ src, long long rs,
                                           int row0, int nrows, int S, int D, bool vec) {
  if (vec) {  // D % (16 / sizeof(T)) == 0 and every row 16-byte aligned
    constexpr int V = 16 / sizeof(T);
    const int per_row = dp / V;
    for (int i = threadIdx.x; i < nrows * per_row; i += kThreads) {
      const int r = i / per_row, c = (i - r * per_row) * V;
      const int s = row0 + r;
      float f[V];
      if (s < S && c < D) {
        widen(__ldg(reinterpret_cast<const uint4*>(src + s * rs + c)), f, T());
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j) f[j] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < V; j += 4) {
        *reinterpret_cast<float4*>(dst + r * ld + c + j) =
            make_float4(f[j], f[j + 1], f[j + 2], f[j + 3]);
      }
    }
  } else {
    for (int i = threadIdx.x; i < nrows * dp; i += kThreads) {
      const int r = i / dp, c = i - r * dp;
      const int s = row0 + r;
      dst[r * ld + c] = (s < S && c < D) ? to_f32(src[s * rs + c]) : 0.f;
    }
  }
}

}  // namespace
