// flash_attn_bwd.cu — exact attention backward (FlashAttention-2 shape), for sm_90a.
//
// Replaces the two Pallas TPU kernels of the JAX package's flash attention
// backward, sparkrdma_tpu/ops/pallas_attention.py (_bwd_impl):
//   srt_flash_attn_bwd_dq   <- _dq_kernel  (pallas_call at :364)
//   srt_flash_attn_bwd_dkv  <- _dkv_kernel (pallas_call at :394)
//
// What they compute, on q, k, v, do laid out [B, S, H, D] (contiguous, f32,
// bf16 or fp16), the forward's lse[b, h, s] and delta[b, h, s] = rowsum(do * out)
// (both f32), with scale = 1/sqrt(D):
//   p  = exp(scale * q k^T + mask - lse)   re-materialised tile by tile
//   ds = p * (do v^T - delta)
//   dq = scale * ds k        dk = scale * ds^T q        dv = p^T do
// The mask drops kv positions >= S, q positions >= S and, if causal, kv > q.
// Masked scores take the TPU kernels' sentinel NEG_INF = -1e30; a row
// whose lse is the forward's +1e30 pin gets p = exp(-1e30 - 1e30) = 0,
// never NaN. Outputs round to the input dtype (bf16 and fp16 to nearest
// even).
//
// What bounds them on this card: arithmetic. Per (q, kv) pair dq costs
// 3*D FMAs (q.k, do.v, ds.k) and dk/dv 4*D (k.q, v.do, p.do, ds.q):
// 6*B*H*D*S^2 and 8*B*H*D*S^2 flops (about half causal), against a few
// bytes per element of each [B, S, H, D] operand. Like the forward, these
// kernels compute in f32 FMA on the CUDA cores for every dtype (the TPU
// kernel bodies upcast to f32), so the bound is the 67 TFLOP/s non-tensor
// f32 peak. They take f32, fp16, bf16 at precision "high"/"highest", and
// the bf16 inputs the tensor-core pair (flash_attn_bwd_sm90.cu) does not.
//
// What the design does about it:
//   - dq: one CTA owns a (b, h, q tile) and walks the kv tiles in ascending
//     order in a loop — the TPU's kv grid axis, whose VMEM scratch carried
//     acc, becomes this loop with acc in registers. Causal: the loop ends
//     after the last live tile, and q tiles are issued longest first. The
//     forward's warp layout carries over: a warp owns R query rows; for
//     s = q.k and dp = do.v the lanes split the tile's keys (each lane a
//     full dot product over D, k and v rows padded by 4 floats so lanes
//     hit different banks); for ds.k the lanes split the head dim.
//   - dk/dv: one CTA owns a (b, h, kv tile) and walks the q tiles from the
//     first live one ((k0 / Tq) when causal: the transpose of the forward's
//     skip), with the two accumulators dk and dv in registers. A warp owns
//     R kv rows; the lanes split the q tile's rows for k.q and v.do, and
//     the head dim for p.do and ds.q. At D = 128 that is twice the
//     forward's accumulator load, so the kv tile shrinks (R = 8, 32 keys)
//     instead of spilling, and the dv and dk sums run as two passes.
//   - Every block over 48 KB of shared memory takes it as dynamic shared
//     memory (cudaFuncSetAttribute, once per instantiation and device).
//   - No host-side pad or transpose; the ragged edge is masked in the
//     kernel; no atomics, so results are deterministic run to run.

#include "flash_attn_common.cuh"

namespace {

// KPER values of one row, at the head-dim positions a lane owns when the
// lanes split D: c * 32 * kVec + lane * kVec + e (the forward's p.v layout)
template <int KPER, int kVec>
__device__ __forceinline__ void load_lane_cols(const float* __restrict__ row, int lane,
                                               float* out) {
  const float* p = row + lane * kVec;
#pragma unroll
  for (int c = 0; c < KPER / kVec; ++c) {
    if constexpr (kVec == 4) {
      const float4 t = *reinterpret_cast<const float4*>(p + c * 128);
      out[4 * c] = t.x; out[4 * c + 1] = t.y; out[4 * c + 2] = t.z; out[4 * c + 3] = t.w;
    } else if constexpr (kVec == 2) {
      const float2 t = *reinterpret_cast<const float2*>(p + c * 64);
      out[2 * c] = t.x; out[2 * c + 1] = t.y;
    } else {
      out[c] = p[c * 32];
    }
  }
}

__device__ __forceinline__ void fma4(float& acc, const float4& a, const float4& b) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  acc = fmaf(a.w, b.w, acc);
}

// Write the R x KPER lane-owned values of rows [pos0, pos0 + R) times `mul`
template <typename T, int R, int KPER, int kVec>
__device__ __forceinline__ void store_rows(T* __restrict__ dst, long long base, long long rs,
                                           int pos0, int S, int D, int lane,
                                           const float (&acc)[R][KPER], float mul) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int pos = pos0 + r;
    if (pos >= S) continue;
    T* row = dst + base + pos * rs;
#pragma unroll
    for (int i = 0; i < KPER; ++i) {
      const int d = (i / kVec) * 32 * kVec + lane * kVec + (i % kVec);
      if (d < D) store_as(row + d, acc[r][i] * mul);
    }
  }
}

// ---------------------------------------------------------------------------
// dq: KPER head-dim values a lane owns (D <= 32 * KPER); R query rows a
// warp owns (Tq = 4 * R); TK keys per kv tile (TK / 32 per lane).
// ---------------------------------------------------------------------------
template <int KPER, int R, int TK>
struct DqTile {
  static constexpr int kTq = kWarps * R;
  static constexpr int kDp = 32 * KPER;   // staged head dim, zero padded
  static constexpr int kKld = kDp + 4;    // k/v row stride: conflict-free lanes
  static constexpr int kVec = KPER < 4 ? KPER : 4;
  static constexpr int kKpl = TK / 32;    // keys per lane in s and dp
  static constexpr int kSmemFloats = 2 * kTq * kDp + 2 * TK * kKld + kTq * TK;
  static constexpr size_t kSmemBytes = sizeof(float) * kSmemFloats;
};

template <typename T, int KPER, int R, int TK>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq, int S, int H, int D,
                    float scale, int causal, int vec) {
  using C = DqTile<KPER, R, TK>;
  constexpr int kTq = C::kTq, kDp = C::kDp, kKld = C::kKld, kVec = C::kVec, kKpl = C::kKpl;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // [Tq][Dp]
  float* Os = Qs + kTq * kDp;                   // [Tq][Dp]   do
  float* Ks = Os + kTq * kDp;                   // [TK][Dp + 4]
  float* Vs = Ks + TK * kKld;                   // [TK][Dp + 4]
  float* Ps = Vs + TK * kKld;                   // [Tq][TK]   ds

  // longest causal tiles first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTq;
  const int h = blockIdx.y, b = blockIdx.z;
  const long long rs = static_cast<long long>(H) * D;
  const long long base = (static_cast<long long>(b) * S * H + h) * D;
  const long long row_base = (static_cast<long long>(b) * H + h) * S;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = warp * R;

  stage_rows(Qs, kDp, kDp, q + base, rs, q0, kTq, S, D, vec != 0);
  stage_rows(Os, kDp, kDp, dout + base, rs, q0, kTq, S, D, vec != 0);

  float lse_r[R], dlt_r[R], acc[R][KPER];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int qpos = q0 + row0 + r;
    // rows past S: the forward's +1e30 pin, so their p is 0
    lse_r[r] = qpos < S ? lse[row_base + qpos] : -kNegInf;
    dlt_r[r] = qpos < S ? delta[row_base + qpos] : 0.f;
#pragma unroll
    for (int i = 0; i < KPER; ++i) acc[r][i] = 0.f;
  }

  int n_tiles = (S + TK - 1) / TK;
  if (causal) n_tiles = min(n_tiles, (q0 + kTq - 1) / TK + 1);
  const int d4 = (D + 3) & ~3;  // dot-product bound; staged zeros past D
  const float* qw = Qs + row0 * kDp;
  const float* ow = Os + row0 * kDp;
  float* pw = Ps + row0 * TK;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * TK;
    __syncthreads();  // every warp is done with the previous k/v tile
    stage_rows(Ks, kKld, kDp, k + base, rs, k0, TK, S, D, vec != 0);
    stage_rows(Vs, kKld, kDp, v + base, rs, k0, TK, S, D, vec != 0);
    __syncthreads();

    // s = q.k and dp = do.v: lane owns keys lane + 32 * j
    float s[R][kKpl], dp[R][kKpl];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int j = 0; j < kKpl; ++j) s[r][j] = dp[r][j] = 0.f;
#pragma unroll 1
    for (int d = 0; d < d4; d += 4) {
      float4 kv[kKpl], vv[kKpl];
#pragma unroll
      for (int j = 0; j < kKpl; ++j) {
        kv[j] = *reinterpret_cast<const float4*>(Ks + (lane + 32 * j) * kKld + d);
        vv[j] = *reinterpret_cast<const float4*>(Vs + (lane + 32 * j) * kKld + d);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(qw + r * kDp + d);
        const float4 ov = *reinterpret_cast<const float4*>(ow + r * kDp + d);
#pragma unroll
        for (int j = 0; j < kKpl; ++j) {
          fma4(s[r][j], qv, kv[j]);
          fma4(dp[r][j], ov, vv[j]);
        }
      }
    }

    // p = exp(s - lse) under the mask, ds = p * (dp - delta), in _dq_kernel's order
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int qpos = q0 + row0 + r;
#pragma unroll
      for (int j = 0; j < kKpl; ++j) {
        const int kpos = k0 + lane + 32 * j;
        const bool live = kpos < S && (!causal || qpos >= kpos);
        const float sc = live ? s[r][j] * scale : kNegInf;
        const float p = expf(sc - lse_r[r]);
        pw[r * TK + lane + 32 * j] = p * (dp[r][j] - dlt_r[r]);
      }
    }
    __syncwarp();

    // acc += ds k: lane owns dims c * 32 * kVec + lane * kVec + e
#pragma unroll 1
    for (int j = 0; j < TK; j += 4) {
      float kk[4][KPER];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        load_lane_cols<KPER, kVec>(Ks + (j + jj) * kKld, lane, kk[jj]);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float4 d4v = *reinterpret_cast<const float4*>(pw + r * TK + j);
#pragma unroll
        for (int i = 0; i < KPER; ++i) {
          float a = acc[r][i];
          a = fmaf(d4v.x, kk[0][i], a);
          a = fmaf(d4v.y, kk[1][i], a);
          a = fmaf(d4v.z, kk[2][i], a);
          a = fmaf(d4v.w, kk[3][i], a);
          acc[r][i] = a;
        }
      }
    }
  }

  store_rows<T, R, KPER, kVec>(dq, base, rs, q0 + row0, S, D, lane, acc, scale);
}

// ---------------------------------------------------------------------------
// dk/dv: KPER head-dim values a lane owns; R kv rows a warp owns
// (Tk = 4 * R); TQ query rows per q tile (TQ / 32 per lane).
// ---------------------------------------------------------------------------
template <int KPER, int R, int TQ>
struct DkvTile {
  static constexpr int kTk = kWarps * R;
  static constexpr int kDp = 32 * KPER;
  static constexpr int kQld = kDp + 4;    // q/do row stride: conflict-free lanes
  static constexpr int kVec = KPER < 4 ? KPER : 4;
  static constexpr int kQpl = TQ / 32;    // q rows per lane in s and dp
  static constexpr int kSmemFloats = 2 * kTk * kDp + 2 * TQ * kQld + 2 * kTk * TQ + 2 * TQ;
  static constexpr size_t kSmemBytes = sizeof(float) * kSmemFloats;
};

template <typename T, int KPER, int R, int TQ>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                     int S, int H, int D, float scale, int causal, int vec) {
  using C = DkvTile<KPER, R, TQ>;
  constexpr int kTk = C::kTk, kDp = C::kDp, kQld = C::kQld, kVec = C::kVec, kQpl = C::kQpl;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);  // [Tk][Dp]
  float* Vs = Ks + kTk * kDp;                   // [Tk][Dp]
  float* Qs = Vs + kTk * kDp;                   // [TQ][Dp + 4]
  float* Os = Qs + TQ * kQld;                   // [TQ][Dp + 4]  do
  float* Ps = Os + TQ * kQld;                   // [Tk][TQ]      p^T
  float* Ds = Ps + kTk * TQ;                    // [Tk][TQ]      ds^T
  float* Ls = Ds + kTk * TQ;                    // [TQ]          lse
  float* Dl = Ls + TQ;                          // [TQ]          delta

  // kv tile 0 sees every q tile when causal: issued first
  const int k0 = blockIdx.x * kTk;
  const int h = blockIdx.y, b = blockIdx.z;
  const long long rs = static_cast<long long>(H) * D;
  const long long base = (static_cast<long long>(b) * S * H + h) * D;
  const long long row_base = (static_cast<long long>(b) * H + h) * S;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = warp * R;

  stage_rows(Ks, kDp, kDp, k + base, rs, k0, kTk, S, D, vec != 0);
  stage_rows(Vs, kDp, kDp, v + base, rs, k0, kTk, S, D, vec != 0);

  float dk_acc[R][KPER], dv_acc[R][KPER];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int i = 0; i < KPER; ++i) dk_acc[r][i] = dv_acc[r][i] = 0.f;

  const int n_tiles = (S + TQ - 1) / TQ;
  const int t0 = causal ? k0 / TQ : 0;  // q tiles above the diagonal see none of this kv tile
  const int d4 = (D + 3) & ~3;
  const float* kw = Ks + row0 * kDp;
  const float* vw = Vs + row0 * kDp;
  float* pw = Ps + row0 * TQ;
  float* dw = Ds + row0 * TQ;

  for (int t = t0; t < n_tiles; ++t) {
    const int qs0 = t * TQ;
    __syncthreads();  // every warp is done with the previous q tile
    stage_rows(Qs, kQld, kDp, q + base, rs, qs0, TQ, S, D, vec != 0);
    stage_rows(Os, kQld, kDp, dout + base, rs, qs0, TQ, S, D, vec != 0);
    for (int i = threadIdx.x; i < TQ; i += kThreads) {
      const int qpos = qs0 + i;
      Ls[i] = qpos < S ? lse[row_base + qpos] : -kNegInf;
      Dl[i] = qpos < S ? delta[row_base + qpos] : 0.f;
    }
    __syncthreads();

    // s^T = k.q and dp^T = v.do: lane owns q rows lane + 32 * j
    float s[R][kQpl], dp[R][kQpl];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int j = 0; j < kQpl; ++j) s[r][j] = dp[r][j] = 0.f;
#pragma unroll 1
    for (int d = 0; d < d4; d += 4) {
      float4 qv[kQpl], ov[kQpl];
#pragma unroll
      for (int j = 0; j < kQpl; ++j) {
        qv[j] = *reinterpret_cast<const float4*>(Qs + (lane + 32 * j) * kQld + d);
        ov[j] = *reinterpret_cast<const float4*>(Os + (lane + 32 * j) * kQld + d);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float4 kv = *reinterpret_cast<const float4*>(kw + r * kDp + d);
        const float4 vv = *reinterpret_cast<const float4*>(vw + r * kDp + d);
#pragma unroll
        for (int j = 0; j < kQpl; ++j) {
          fma4(s[r][j], kv, qv[j]);
          fma4(dp[r][j], vv, ov[j]);
        }
      }
    }

    // p^T = exp(s^T - lse), ds^T = p^T * (dp^T - delta), in _dkv_kernel's order
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int kpos = k0 + row0 + r;
#pragma unroll
      for (int j = 0; j < kQpl; ++j) {
        const int qi = lane + 32 * j;
        const int qpos = qs0 + qi;
        const bool live = qpos < S && kpos < S && (!causal || qpos >= kpos);
        const float sc = live ? s[r][j] * scale : kNegInf;
        const float p = expf(sc - Ls[qi]);
        pw[r * TQ + qi] = p;
        dw[r * TQ + qi] = p * (dp[r][j] - Dl[qi]);
      }
    }
    __syncwarp();

    // dv += p^T do, then dk += ds^T q: lane owns dims as in dq
#pragma unroll 1
    for (int j = 0; j < TQ; j += 4) {
      float oo[4][KPER];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        load_lane_cols<KPER, kVec>(Os + (j + jj) * kQld, lane, oo[jj]);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float4 p4 = *reinterpret_cast<const float4*>(pw + r * TQ + j);
#pragma unroll
        for (int i = 0; i < KPER; ++i) {
          float a = dv_acc[r][i];
          a = fmaf(p4.x, oo[0][i], a);
          a = fmaf(p4.y, oo[1][i], a);
          a = fmaf(p4.z, oo[2][i], a);
          a = fmaf(p4.w, oo[3][i], a);
          dv_acc[r][i] = a;
        }
      }
    }
#pragma unroll 1
    for (int j = 0; j < TQ; j += 4) {
      float qq[4][KPER];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        load_lane_cols<KPER, kVec>(Qs + (j + jj) * kQld, lane, qq[jj]);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float4 d4v = *reinterpret_cast<const float4*>(dw + r * TQ + j);
#pragma unroll
        for (int i = 0; i < KPER; ++i) {
          float a = dk_acc[r][i];
          a = fmaf(d4v.x, qq[0][i], a);
          a = fmaf(d4v.y, qq[1][i], a);
          a = fmaf(d4v.z, qq[2][i], a);
          a = fmaf(d4v.w, qq[3][i], a);
          dk_acc[r][i] = a;
        }
      }
    }
  }

  store_rows<T, R, KPER, kVec>(dk, base, rs, k0 + row0, S, D, lane, dk_acc, scale);
  store_rows<T, R, KPER, kVec>(dv, base, rs, k0 + row0, S, D, lane, dv_acc, 1.f);
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------
struct Args {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *dq, *dk, *dv;
  long long B, S, H, D, causal;
  cudaStream_t stream;
};

template <typename T>
int vector_ok(const Args& a) {
  constexpr int V = 16 / sizeof(T);
  const auto aligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  return a.D % V == 0 && aligned(a.q) && aligned(a.k) && aligned(a.v) && aligned(a.dout);
}

template <typename T, int KPER, int R, int TK>
int launch_dq(const Args& a) {
  using C = DqTile<KPER, R, TK>;
  auto kernel = flash_bwd_dq_kernel<T, KPER, R, TK>;
  static PerDevice raised;
  if (const cudaError_t e = raise_smem_limit(kernel, static_cast<int>(C::kSmemBytes), raised))
    return static_cast<int>(e);
  const long long tiles = (a.S + C::kTq - 1) / C::kTq;
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(a.D)));
  kernel<<<dim3(static_cast<unsigned>(tiles), static_cast<unsigned>(a.H),
                static_cast<unsigned>(a.B)),
           kThreads, C::kSmemBytes, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<T*>(a.dq), static_cast<int>(a.S),
      static_cast<int>(a.H), static_cast<int>(a.D), scale, a.causal != 0, vector_ok<T>(a));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int KPER, int R, int TQ>
int launch_dkv(const Args& a) {
  using C = DkvTile<KPER, R, TQ>;
  auto kernel = flash_bwd_dkv_kernel<T, KPER, R, TQ>;
  static PerDevice raised;
  if (const cudaError_t e = raise_smem_limit(kernel, static_cast<int>(C::kSmemBytes), raised))
    return static_cast<int>(e);
  const long long tiles = (a.S + C::kTk - 1) / C::kTk;
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(a.D)));
  kernel<<<dim3(static_cast<unsigned>(tiles), static_cast<unsigned>(a.H),
                static_cast<unsigned>(a.B)),
           kThreads, C::kSmemBytes, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<T*>(a.dk), static_cast<T*>(a.dv),
      static_cast<int>(a.S), static_cast<int>(a.H), static_cast<int>(a.D), scale,
      a.causal != 0, vector_ok<T>(a));
  return static_cast<int>(cudaGetLastError());
}

// tile variants per D class
template <typename T>
int dispatch_dq(const Args& a) {
  if (a.D <= 32) return launch_dq<T, 1, 16, 64>(a);
  if (a.D <= 64) return launch_dq<T, 2, 16, 64>(a);
  if (a.D <= 128) return launch_dq<T, 4, 16, 32>(a);
  return launch_dq<T, 8, 8, 32>(a);
}

template <typename T>
int dispatch_dkv(const Args& a) {
  if (a.D <= 32) return launch_dkv<T, 1, 16, 64>(a);
  if (a.D <= 64) return launch_dkv<T, 2, 16, 32>(a);
  if (a.D <= 128) return launch_dkv<T, 4, 8, 32>(a);
  return launch_dkv<T, 8, 4, 32>(a);
}

constexpr int kNothingToDo = -1;

// 0: launch; kNothingToDo: an empty problem; else a cudaError_t
int check(const Args& a, long long dtype) {
  if (a.B < 0 || a.S < 0 || a.H < 0 || a.D < 1 || a.D > 256 || dtype < 0 || dtype > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.S > 0x7fffffffLL || a.H > 65535 || a.B > 65535)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  return a.B == 0 || a.S == 0 || a.H == 0 ? kNothingToDo : 0;
}

}  // namespace

extern "C" {

// q, k, v, dout, dq: contiguous [B, S, H, D]; lse, delta: [B, H, S] f32;
// dtype 0 = f32, 1 = bf16, 2 = fp16; 1 <= D <= 256. Enqueued on `stream`,
// not waited.
int srt_flash_attn_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                          const void* lse, const void* delta, void* dq, long long B,
                          long long S, long long H, long long D, long long dtype,
                          long long causal, void* stream) {
  const Args a{q, k, v, dout, lse, delta, dq, nullptr, nullptr,
               B, S, H, D, causal, static_cast<cudaStream_t>(stream)};
  const int c = check(a, dtype);
  if (c != 0) return c == kNothingToDo ? 0 : c;
  if (dtype == 0) return dispatch_dq<float>(a);
  return dtype == 1 ? dispatch_dq<__nv_bfloat16>(a) : dispatch_dq<__half>(a);
}

// as srt_flash_attn_bwd_dq, writing dk and dv ([B, S, H, D], input dtype)
int srt_flash_attn_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                           const void* lse, const void* delta, void* dk, void* dv,
                           long long B, long long S, long long H, long long D,
                           long long dtype, long long causal, void* stream) {
  const Args a{q, k, v, dout, lse, delta, nullptr, dk, dv,
               B, S, H, D, causal, static_cast<cudaStream_t>(stream)};
  const int c = check(a, dtype);
  if (c != 0) return c == kNothingToDo ? 0 : c;
  if (dtype == 0) return dispatch_dkv<float>(a);
  return dtype == 1 ? dispatch_dkv<__nv_bfloat16>(a) : dispatch_dkv<__half>(a);
}

}  // extern "C"
