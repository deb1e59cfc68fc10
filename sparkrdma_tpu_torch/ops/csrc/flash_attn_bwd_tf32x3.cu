// flash_attn_bwd_tf32x3.cu — the float32 flash-attention backward on the tensor
// cores, by 3xTF32 warp-level mma.sync, for sm_90a.
//
// Replaces, for float32 inputs with D 64 or 128, the two Pallas TPU kernels of
// the JAX package's flash-attention backward, sparkrdma_tpu/ops/pallas_attention.py
// (_bwd_impl), which run every product at precision=HIGHEST (full f32):
//   srt_flash_attn_bwd_dkv_tf32x3  <- _dkv_kernel (pallas_call at :394)
//   srt_flash_attn_bwd_dq_tf32x3   <- _dq_kernel  (pallas_call at :364)
// The SIMT pair (flash_attn_bwd.cu) keeps every other input.
//
// What they compute is what the SIMT kernels compute (flash_attn_bwd.cu:1-48),
// on q, k, v, do laid out [B, S, H, D] (contiguous f32, 16-byte aligned), the
// forward's lse[b, h, s] and delta[b, h, s] = rowsum(do * out), scale = 1/sqrt(D):
//   p  = exp(scale * q k^T + mask - lse)      ds = p * (do v^T - delta)
//   dq = scale * ds k     dk = scale * ds^T q     dv = p^T do
// with the same masks (kv >= S, q >= S, causal kv > q), the -1e30 sentinel,
// lse's +1e30 pin on padded rows, the causal tile skips and the ascending
// order of the streamed tiles.
//
// What bounds them on this card: arithmetic. Each product is three TF32
// tensor-core products (below), so the bound is 3 x flops at 495 TFLOP/s.
//
// 3xTF32. Each f32 operand x is split as hi = x rounded to TF32 (10 mantissa
// bits, to nearest, ties away from zero: cvt.rna.tf32.f32, done here on the
// bits) and lo = (x - hi) rounded the same way; x - hi is exact. Then
// a*b ~ hi_a*lo_b + lo_a*hi_b + hi_a*hi_b, accumulated in f32, the two small
// terms first, lo_a*lo_b (below 2^-22 of the product) dropped: about 22 bits
// of each operand, the accuracy of an f32 product. The plain version is
// pallas_attention.flash_attention_bwd_tf32x3_reference.
//
// What the design does about it:
//   - mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 on registers loaded
//     from shared memory by plain loads, so any transpose is a choice of
//     addresses: no TMA, no descriptors (TF32 wgmma reads shared memory
//     K-major only, and three of the five products need a transpose).
//   - The SIMT kernels' CTA structure: dk/dv, one CTA per (b, h, 64-row kv
//     tile) walking the q tiles from the first live one; dq, one CTA per
//     (b, h, 64-row q tile) walking the live kv tiles. Each of the 4 warps
//     owns 16 of the CTA's 64 "fixed" rows; the accumulators (dk and dv, or
//     dq: 16 x D a warp) stay in registers for the whole walk.
//   - The streamed tile (q, do or k, v), read by every warp, is split once,
//     when staged: shared memory holds its hi and lo planes. The fixed rows
//     (k, v or q, do), each read by one warp, stay f32 and are split as their
//     A fragments load: 70 KB a CTA at D 64, so 3 CTAs (12 warps) share an SM,
//     2 at D 128. p and ds are split in registers. Rows are D + 4 floats apart.
//   - Fragments (g = lane / 4, t = lane % 4): A a0 (g, t), a1 (g+8, t),
//     a2 (g, t+4), a3 (g+8, t+4); B b0 (k t, n g), b1 (k t+4, n g); C c0, c1
//     at (g, 2t), (g, 2t+1), c2, c3 at (g+8, 2t), (g+8, 2t+1).
//   - The scores s = fixed . streamed^T and dp read A from the fixed rows and
//     B from the streamed rows, both at [row g][col t]: banks (4g + t) mod 32
//     with the D + 4 stride (68 or 132 floats), conflict-free.
//   - The accumulator as A: p (or ds) ends in C layout, and becomes the A
//     operand of p^T do, ds^T q or ds k without a trip through shared memory
//     by permuting k inside each 8-wide slice: A column t stands for column
//     2t and A column t+4 for 2t+1, so a0 = c0, a1 = c2, a2 = c1, a3 = c3.
//     B reads the streamed rows of the same permutation, b0 from row 2t and
//     b1 from row 2t+1: banks (8t + g) and (8t + 4 + g) mod 32, conflict-free.
//   - Shared memory above 48 KiB through raise_smem_limit (launch_config.cuh).
//     No atomics, so results are deterministic run to run.

#include "flash_attn_tf32x3_common.cuh"

namespace {

// scores() issues its products term by term across its accumulators, as
// accumulate() does (flash_attn_tf32x3_common.cuh).

// s = A1 B1^T and dp = A2 B2^T for a warp's 16 fixed rows (f32 planes a1,
// a2 at the warp's first row, split as loaded) against the N streamed rows
// (hi/lo planes b1h/b1l, b2h/b2l): s[j], dp[j] are the 16 x 8 C tiles of
// streamed rows 8j..8j+7
template <int D, int N>
__device__ __forceinline__ void scores(float (&s)[N / 8][4], float (&dp)[N / 8][4],
                                       const float* a1, const float* b1h, const float* b1l,
                                       const float* a2, const float* b2h, const float* b2l,
                                       int g, int t) {
  constexpr int kLd = D + 4, J = N / 8;
#pragma unroll
  for (int j = 0; j < J; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll 2
  for (int d0 = 0; d0 < D; d0 += 8) {
    uint32_t x_hi[4], x_lo[4], y_hi[4], y_lo[4];  // A of s, A of dp
    load_a_split(x_hi, x_lo, a1 + d0, kLd, g, t);
    load_a_split(y_hi, y_lo, a2 + d0, kLd, g, t);
    uint32_t u_hi[J][2], u_lo[J][2], w_hi[J][2], w_lo[J][2];  // B of s, B of dp
#pragma unroll
    for (int j = 0; j < J; ++j) {
      load_b_rows(u_hi[j], b1h + j * 8 * kLd + d0, kLd, g, t);
      load_b_rows(u_lo[j], b1l + j * 8 * kLd + d0, kLd, g, t);
      load_b_rows(w_hi[j], b2h + j * 8 * kLd + d0, kLd, g, t);
      load_b_rows(w_lo[j], b2l + j * 8 * kLd + d0, kLd, g, t);
    }
#pragma unroll
    for (int j = 0; j < J; ++j) {
      mma_tf32(s[j], x_hi, u_lo[j]);
      mma_tf32(dp[j], y_hi, w_lo[j]);
    }
#pragma unroll
    for (int j = 0; j < J; ++j) {
      mma_tf32(s[j], x_lo, u_hi[j]);
      mma_tf32(dp[j], y_lo, w_hi[j]);
    }
#pragma unroll
    for (int j = 0; j < J; ++j) {
      mma_tf32(s[j], x_hi, u_hi[j]);
      mma_tf32(dp[j], y_hi, w_hi[j]);
    }
  }
}


// Shared memory: the fixed rows' two operands as f32 (their A fragments are
// split as loaded, which keeps 3 CTAs an SM at D 64), the streamed tile's two
// as hi and lo planes (read by every warp), then (dk/dv) the streamed rows'
// lse and delta
template <int D, int N>
struct Tiles {
  static constexpr int kLd = D + 4;
  static constexpr int kFixedPlane = kFixedRows * kLd;
  static constexpr int kStreamPlane = N * kLd;
  static constexpr size_t kSmemBytes =
      sizeof(float) * (2 * kFixedPlane + 4 * kStreamPlane + 2 * N);
};

// ---------------------------------------------------------------------------
// dk/dv: fixed rows k and v (a 64-row kv tile), streamed q and do (TQ rows)
// ---------------------------------------------------------------------------
template <int D, int TQ>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_tf32x3_kernel(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, const float* __restrict__ dout,
                            const float* __restrict__ lse, const float* __restrict__ delta,
                            float* __restrict__ dk, float* __restrict__ dv, int S, int H,
                            float scale, int causal) {
  using C = Tiles<D, TQ>;
  constexpr int kLd = C::kLd;
  constexpr int kDkvGroup = D == 64 ? 8 : 4;  // D 128: 128 accumulator registers already
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + C::kFixedPlane;
  float* Qh = Vs + C::kFixedPlane;
  float* Ql = Qh + C::kStreamPlane;
  float* Oh = Ql + C::kStreamPlane;  // do
  float* Ol = Oh + C::kStreamPlane;
  float* Ls = Ol + C::kStreamPlane;  // [TQ] lse
  float* Dl = Ls + TQ;               // [TQ] delta

  // kv tile 0 sees every q tile when causal: issued first
  const int k0 = blockIdx.x * kFixedRows;
  const int h = blockIdx.y, b = blockIdx.z;
  const long long rs = static_cast<long long>(H) * D;
  const long long base = (static_cast<long long>(b) * S * H + h) * D;
  const long long row_base = (static_cast<long long>(b) * H + h) * S;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int kw = k0 + warp * kWarpRows;  // the warp's first kv row

  stage_rows(Ks, kLd, D, k + base, rs, k0, kFixedRows, S, D, true);
  stage_rows(Vs, kLd, D, v + base, rs, k0, kFixedRows, S, D, true);
  const int fo = warp * kWarpRows * kLd;

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  const int n_tiles = (S + TQ - 1) / TQ;
  const int t0 = causal ? k0 / TQ : 0;  // q tiles above the diagonal see none of this kv tile
  for (int tile = t0; tile < n_tiles; ++tile) {
    const int qs0 = tile * TQ;
    __syncthreads();  // every warp is done with the previous q tile
    stage_split<D>(Qh, Ql, q + base, rs, qs0, TQ, S);
    stage_split<D>(Oh, Ol, dout + base, rs, qs0, TQ, S);
    for (int i = threadIdx.x; i < TQ; i += kThreads) {
      const int qpos = qs0 + i;
      Ls[i] = qpos < S ? lse[row_base + qpos] : -kNegInf;
      Dl[i] = qpos < S ? delta[row_base + qpos] : 0.f;
    }
    __syncthreads();
    // causal: every q of this tile is above every kv row of this warp
    if (causal && qs0 + TQ - 1 < kw) continue;

    // s^T = k q^T and dp^T = v do^T
    float s[TQ / 8][4], dp[TQ / 8][4];
    scores<D, TQ>(s, dp, Ks + fo, Qh, Ql, Vs + fo, Oh, Ol, g, t);

    // p^T = exp(s^T - lse) under the mask and ds^T = p^T (dp^T - delta), in place
#pragma unroll
    for (int j = 0; j < TQ / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = kw + g + (e >> 1) * 8;
        const int qi = 8 * j + 2 * t + (e & 1);
        const int qpos = qs0 + qi;
        const bool live = qpos < S && kpos < S && (!causal || qpos >= kpos);
        const float sc = live ? s[j][e] * scale : kNegInf;
        const float p = expf(sc - Ls[qi]);
        s[j][e] = p;
        dp[j][e] = p * (dp[j][e] - Dl[qi]);
      }
    }

    // dv += p^T do, dk += ds^T q
    accumulate<D, TQ, kDkvGroup>(dv_acc, s, Oh, Ol, g, t);
    accumulate<D, TQ, kDkvGroup>(dk_acc, dp, Qh, Ql, g, t);
  }

  store_rows<D>(dk + base, rs, kw, S, dk_acc, scale, g, t);
  store_rows<D>(dv + base, rs, kw, S, dv_acc, 1.f, g, t);
}

// ---------------------------------------------------------------------------
// dq: fixed rows q and do (a 64-row q tile), streamed k and v (TK rows)
// ---------------------------------------------------------------------------
template <int D, int TK>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_tf32x3_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, const float* __restrict__ dout,
                           const float* __restrict__ lse, const float* __restrict__ delta,
                           float* __restrict__ dq, int S, int H, float scale, int causal) {
  using C = Tiles<D, TK>;
  constexpr int kLd = C::kLd;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Os = Qs + C::kFixedPlane;  // do
  float* Kh = Os + C::kFixedPlane;
  float* Kl = Kh + C::kStreamPlane;
  float* Vh = Kl + C::kStreamPlane;
  float* Vl = Vh + C::kStreamPlane;

  // longest causal tiles first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kFixedRows;
  const int h = blockIdx.y, b = blockIdx.z;
  const long long rs = static_cast<long long>(H) * D;
  const long long base = (static_cast<long long>(b) * S * H + h) * D;
  const long long row_base = (static_cast<long long>(b) * H + h) * S;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int qw = q0 + warp * kWarpRows;  // the warp's first q row

  stage_rows(Qs, kLd, D, q + base, rs, q0, kFixedRows, S, D, true);
  stage_rows(Os, kLd, D, dout + base, rs, q0, kFixedRows, S, D, true);
  const int fo = warp * kWarpRows * kLd;

  // the lane's two q rows (g, g + 8); rows past S: the forward's +1e30 pin, so their p is 0
  float lse_r[2], dlt_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = qw + g + 8 * r;
    lse_r[r] = qpos < S ? lse[row_base + qpos] : -kNegInf;
    dlt_r[r] = qpos < S ? delta[row_base + qpos] : 0.f;
  }
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  int n_tiles = (S + TK - 1) / TK;
  if (causal) n_tiles = min(n_tiles, (q0 + kFixedRows - 1) / TK + 1);
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * TK;
    __syncthreads();  // every warp is done with the previous k/v tile
    stage_split<D>(Kh, Kl, k + base, rs, k0, TK, S);
    stage_split<D>(Vh, Vl, v + base, rs, k0, TK, S);
    __syncthreads();
    // causal: every kv of this tile is above every q row of this warp
    if (causal && k0 > qw + kWarpRows - 1) continue;

    // s = q k^T and dp = do v^T
    float s[TK / 8][4], dp[TK / 8][4];
    scores<D, TK>(s, dp, Qs + fo, Kh, Kl, Os + fo, Vh, Vl, g, t);

    // p = exp(s - lse) under the mask, ds = p (dp - delta), into s
#pragma unroll
    for (int j = 0; j < TK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qpos = qw + g + (e >> 1) * 8;
        const int kpos = k0 + 8 * j + 2 * t + (e & 1);
        const bool live = kpos < S && (!causal || qpos >= kpos);
        const float sc = live ? s[j][e] * scale : kNegInf;
        const float p = expf(sc - lse_r[e >> 1]);
        s[j][e] = p * (dp[j][e] - dlt_r[e >> 1]);
      }
    }

    // dq += ds k
    accumulate<D, TK, 8>(acc, s, Kh, Kl, g, t);
  }

  store_rows<D>(dq + base, rs, qw, S, acc, scale, g, t);
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------
struct Args {
  const float *q, *k, *v, *dout, *lse, *delta;
  float *dq, *dk, *dv;
  long long B, S, H, D, causal;
  cudaStream_t stream;
};

template <int D, int TQ>
int launch_dkv(const Args& a) {
  auto kernel = flash_bwd_dkv_tf32x3_kernel<D, TQ>;
  constexpr size_t kBytes = Tiles<D, TQ>::kSmemBytes;
  static PerDevice raised;
  if (const cudaError_t e = raise_smem_limit(kernel, static_cast<int>(kBytes), raised))
    return static_cast<int>(e);
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(D)));
  kernel<<<dim3(static_cast<unsigned>((a.S + kFixedRows - 1) / kFixedRows),
                static_cast<unsigned>(a.H), static_cast<unsigned>(a.B)),
           kThreads, kBytes, a.stream>>>(a.q, a.k, a.v, a.dout, a.lse, a.delta, a.dk, a.dv,
                                         static_cast<int>(a.S), static_cast<int>(a.H), scale,
                                         a.causal != 0);
  return static_cast<int>(cudaGetLastError());
}

template <int D, int TK>
int launch_dq(const Args& a) {
  auto kernel = flash_bwd_dq_tf32x3_kernel<D, TK>;
  constexpr size_t kBytes = Tiles<D, TK>::kSmemBytes;
  static PerDevice raised;
  if (const cudaError_t e = raise_smem_limit(kernel, static_cast<int>(kBytes), raised))
    return static_cast<int>(e);
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(D)));
  kernel<<<dim3(static_cast<unsigned>((a.S + kFixedRows - 1) / kFixedRows),
                static_cast<unsigned>(a.H), static_cast<unsigned>(a.B)),
           kThreads, kBytes, a.stream>>>(a.q, a.k, a.v, a.dout, a.lse, a.delta, a.dq,
                                         static_cast<int>(a.S), static_cast<int>(a.H), scale,
                                         a.causal != 0);
  return static_cast<int>(cudaGetLastError());
}

constexpr int kNothingToDo = -1;

// 0: launch; kNothingToDo: an empty problem; else a cudaError_t. Takes f32
// (dtype 0) with D 64 or 128 and every tensor on a 16-byte boundary, the
// inputs pallas_attention.bwd_entry sends here.
int check(const Args& a, long long dtype, const void* out0, const void* out1) {
  const auto aligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  if (a.B < 0 || a.S < 0 || a.H < 0 || (a.D != 64 && a.D != 128) || dtype != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!(aligned(a.q) && aligned(a.k) && aligned(a.v) && aligned(a.dout) && aligned(out0) &&
        aligned(out1)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.S > 0x7fffffffLL || a.H > 65535 || a.B > 65535)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  return a.B == 0 || a.S == 0 || a.H == 0 ? kNothingToDo : 0;
}

}  // namespace

extern "C" {

// q, k, v, dout, dq: contiguous f32 [B, S, H, D], 16-byte aligned, D 64 or
// 128; lse, delta: [B, H, S] f32; dtype must be 0 (f32). The SIMT
// srt_flash_attn_bwd_dq's argument list. Enqueued on `stream`, not waited.
int srt_flash_attn_bwd_dq_tf32x3(const void* q, const void* k, const void* v, const void* dout,
                                 const void* lse, const void* delta, void* dq, long long B,
                                 long long S, long long H, long long D, long long dtype,
                                 long long causal, void* stream) {
  const Args a{static_cast<const float*>(q),    static_cast<const float*>(k),
               static_cast<const float*>(v),    static_cast<const float*>(dout),
               static_cast<const float*>(lse),  static_cast<const float*>(delta),
               static_cast<float*>(dq),         nullptr,
               nullptr,                         B,
               S,                               H,
               D,                               causal,
               static_cast<cudaStream_t>(stream)};
  const int c = check(a, dtype, dq, dq);
  if (c != 0) return c == kNothingToDo ? 0 : c;
  return D == 64 ? launch_dq<64, 32>(a) : launch_dq<128, 16>(a);
}

// as srt_flash_attn_bwd_dq_tf32x3, writing dk and dv (f32 [B, S, H, D])
int srt_flash_attn_bwd_dkv_tf32x3(const void* q, const void* k, const void* v, const void* dout,
                                  const void* lse, const void* delta, void* dk, void* dv,
                                  long long B, long long S, long long H, long long D,
                                  long long dtype, long long causal, void* stream) {
  const Args a{static_cast<const float*>(q),    static_cast<const float*>(k),
               static_cast<const float*>(v),    static_cast<const float*>(dout),
               static_cast<const float*>(lse),  static_cast<const float*>(delta),
               nullptr,                         static_cast<float*>(dk),
               static_cast<float*>(dv),         B,
               S,                               H,
               D,                               causal,
               static_cast<cudaStream_t>(stream)};
  const int c = check(a, dtype, dk, dv);
  if (c != 0) return c == kNothingToDo ? 0 : c;
  return D == 64 ? launch_dkv<64, 32>(a) : launch_dkv<128, 16>(a);
}

}  // extern "C"
