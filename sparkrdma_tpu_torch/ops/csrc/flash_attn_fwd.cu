// flash_attn_fwd.cu — exact attention forward by online softmax, for sm_90a.
//
// Replaces the Pallas TPU kernel of the JAX package's flash attention
// forward, sparkrdma_tpu/ops/pallas_attention.py:
//   srt_flash_attn_fwd  <- _fwd_impl's pallas_call (_kernel with the
//                          per-row logsumexp, _kernel_no_lse without)
//
// What it computes, on q, k, v laid out [B, S, H, D] (contiguous, f32 or
// bf16) with scale = 1/sqrt(D):
//   out[b, s, h, :] = softmax(scale * q k^T + mask) v      (input dtype)
//   lse[b, h, s]    = m + log(l)                           (f32, optional)
// The mask drops kv positions >= S and, if causal, kv > q. Masked scores
// take the TPU kernel's sentinel NEG_INF = -1e30 (not -inf), so a row's
// running max is finite from its first tile on and the correction
// exp(m_prev - m_new) is never exp(-inf + inf).
//
// What bounds it on this card: arithmetic. Each (q, kv) pair costs 2*D
// FMAs (scores and p.v), 4*B*H*S^2*D flops in all (half of that causal),
// against 2*B*S*H*D*size bytes of q/out and of k/v each read once. This
// first version computes in f32 FMA on the CUDA cores for both dtypes, as
// the TPU kernel body does (operands upcast to f32, f32 products), so its
// bound is the 67 TFLOP/s non-tensor f32 peak, not the tensor cores.
//
// What the design does about it:
//   - one CTA owns a (b, h, 64-row q tile) and walks the kv tiles in a
//     loop: the TPU's sequential kv grid axis, whose VMEM scratch carried
//     m, l and acc from step to step, becomes this loop, and the three
//     carries live in registers for the whole sweep;
//   - each warp owns R query rows. For the scores, the lanes split the kv
//     tile's keys (each lane a full dot product over D); for p.v, the
//     lanes split the head dim, so acc is R x D/32 floats a lane. Row max
//     and row sum are warp shuffles. Every shared-memory read feeds R rows
//     (or 4 keys) of FMAs, so the inner loops are FMA-bound, not load-bound;
//   - q, k and v tiles are staged in shared memory as f32 (bf16 is widened
//     on the way in, 16-byte global loads when D allows), k rows padded by
//     4 floats so lanes reading different keys hit different banks;
//   - causal: the kv loop stops after the CTA's last live tile,
//     (q0 + Tq - 1) / Tk — the TPU kernel's block skip — and the q tiles
//     are issued longest first so the short ones fill the tail;
//   - the ragged edge is masked in the kernel: no host-side pad or
//     transpose. Rows q >= S are computed on zeros and never written.
// Tensor cores (wgmma/mma.sync with TMA staging) are later work.

#include "flash_attn_common.cuh"

namespace {

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// KPER: head-dim values a lane owns in p.v (D <= 32 * KPER); R: query rows
// a warp owns (Tq = 4 * R); TK: keys per kv tile (TK / 32 per lane).
template <int KPER, int R, int TK>
struct Tile {
  static constexpr int kTq = kWarps * R;
  static constexpr int kDp = 32 * KPER;   // staged head dim, zero padded
  static constexpr int kKld = kDp + 4;    // k row stride: conflict-free lanes
  static constexpr int kVec = KPER < 4 ? KPER : 4;
  static constexpr int kKpl = TK / 32;    // keys per lane in the scores
  static constexpr int kSmemFloats = kTq * kDp + TK * kKld + TK * kDp + kTq * TK;
  static constexpr size_t kSmemBytes = sizeof(float) * kSmemFloats;
};

template <typename T, int KPER, int R, int TK>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ out, float* __restrict__ lse, int S, int H, int D,
                 float scale, int causal, int vec) {
  using C = Tile<KPER, R, TK>;
  constexpr int kTq = C::kTq, kDp = C::kDp, kKld = C::kKld, kVec = C::kVec, kKpl = C::kKpl;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // [Tq][Dp]
  float* Ks = Qs + kTq * kDp;                   // [TK][Dp + 4]
  float* Vs = Ks + TK * kKld;                   // [TK][Dp]
  float* Ps = Vs + TK * kDp;                    // [Tq][TK]

  // longest causal tiles first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTq;
  const int h = blockIdx.y, b = blockIdx.z;
  const long long rs = static_cast<long long>(H) * D;
  const long long base = (static_cast<long long>(b) * S * H + h) * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = warp * R;  // this warp's first row in the tile

  stage_rows(Qs, kDp, kDp, q + base, rs, q0, kTq, S, D, vec != 0);

  float m[R], l[R], acc[R][KPER];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < KPER; ++i) acc[r][i] = 0.f;
  }

  int n_tiles = (S + TK - 1) / TK;
  if (causal) n_tiles = min(n_tiles, (q0 + kTq - 1) / TK + 1);
  const int d4 = (D + 3) & ~3;  // score loop bound; staged zeros past D
  const float* qw = Qs + row0 * kDp;
  float* pw = Ps + row0 * TK;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * TK;
    __syncthreads();  // every warp is done with the previous k/v tile
    stage_rows(Ks, kKld, kDp, k + base, rs, k0, TK, S, D, vec != 0);
    stage_rows(Vs, kDp, kDp, v + base, rs, k0, TK, S, D, vec != 0);
    __syncthreads();

    // scores: lane owns keys lane + 32 * j
    float s[R][kKpl];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int j = 0; j < kKpl; ++j) s[r][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < d4; d += 4) {
      float4 kv[kKpl];
#pragma unroll
      for (int j = 0; j < kKpl; ++j)
        kv[j] = *reinterpret_cast<const float4*>(Ks + (lane + 32 * j) * kKld + d);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(qw + r * kDp + d);
#pragma unroll
        for (int j = 0; j < kKpl; ++j) {
          s[r][j] = fmaf(qv.x, kv[j].x, s[r][j]);
          s[r][j] = fmaf(qv.y, kv[j].y, s[r][j]);
          s[r][j] = fmaf(qv.z, kv[j].z, s[r][j]);
          s[r][j] = fmaf(qv.w, kv[j].w, s[r][j]);
        }
      }
    }

    // mask, then the online-softmax update in _kernel's order
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int qpos = q0 + row0 + r;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kKpl; ++j) {
        const int kpos = k0 + lane + 32 * j;
        const bool live = kpos < S && (!causal || qpos >= kpos);
        s[r][j] = live ? s[r][j] * scale : kNegInf;
        mx = fmaxf(mx, s[r][j]);
      }
      const float m_new = fmaxf(m[r], warp_max(mx));
      const float corr = expf(m[r] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < kKpl; ++j) {
        const float p = expf(s[r][j] - m_new);
        pw[r * TK + lane + 32 * j] = p;
        psum += p;
      }
      l[r] = l[r] * corr + warp_sum(psum);
      m[r] = m_new;
#pragma unroll
      for (int i = 0; i < KPER; ++i) acc[r][i] *= corr;
    }
    __syncwarp();

    // acc += p v: lane owns dims c * 32 * kVec + lane * kVec + e
#pragma unroll 1
    for (int j = 0; j < TK; j += 4) {
      float vv[4][KPER];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float* vrow = Vs + (j + jj) * kDp + lane * kVec;
#pragma unroll
        for (int c = 0; c < KPER / kVec; ++c) {
          if constexpr (kVec == 4) {
            const float4 t4 = *reinterpret_cast<const float4*>(vrow + c * 128);
            vv[jj][4 * c] = t4.x; vv[jj][4 * c + 1] = t4.y;
            vv[jj][4 * c + 2] = t4.z; vv[jj][4 * c + 3] = t4.w;
          } else if constexpr (kVec == 2) {
            const float2 t2 = *reinterpret_cast<const float2*>(vrow + c * 64);
            vv[jj][2 * c] = t2.x; vv[jj][2 * c + 1] = t2.y;
          } else {
            vv[jj][c] = vrow[c * 32];
          }
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float4 p4 = *reinterpret_cast<const float4*>(pw + r * TK + j);
#pragma unroll
        for (int i = 0; i < KPER; ++i) {
          float a = acc[r][i];
          a = fmaf(p4.x, vv[0][i], a);
          a = fmaf(p4.y, vv[1][i], a);
          a = fmaf(p4.z, vv[2][i], a);
          a = fmaf(p4.w, vv[3][i], a);
          acc[r][i] = a;
        }
      }
    }
  }

  // finalize: rows with l == 0 cannot occur for q < S (every row sees
  // kv 0), but keep the TPU kernel's guard and its lse pin
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int qpos = q0 + row0 + r;
    if (qpos >= S) continue;
    const float denom = l[r] > 0.f ? l[r] : 1.f;
    T* orow = out + base + qpos * rs;
#pragma unroll
    for (int i = 0; i < KPER; ++i) {
      const int d = (i / kVec) * 32 * kVec + lane * kVec + (i % kVec);
      if (d < D) store_as(orow + d, acc[r][i] / denom);
    }
    if (lse != nullptr && lane == 0) {
      lse[(static_cast<long long>(b) * H + h) * S + qpos] =
          l[r] > 0.f ? m[r] + logf(denom) : -kNegInf;
    }
  }
}

template <typename T, int KPER, int R, int TK>
int launch(const void* q, const void* k, const void* v, void* out, void* lse,
           long long B, long long S, long long H, long long D, long long causal,
           cudaStream_t stream) {
  using C = Tile<KPER, R, TK>;
  auto kernel = flash_fwd_kernel<T, KPER, R, TK>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(C::kSmemBytes));
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const long long q_tiles = (S + C::kTq - 1) / C::kTq;
  if (S > 0x7fffffffLL || H > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  constexpr int V = 16 / sizeof(T);
  const auto aligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  const int vec = D % V == 0 && aligned(q) && aligned(k) && aligned(v);
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(D)));
  kernel<<<dim3(static_cast<unsigned>(q_tiles), static_cast<unsigned>(H),
                static_cast<unsigned>(B)),
           kThreads, C::kSmemBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), static_cast<float*>(lse), static_cast<int>(S),
      static_cast<int>(H), static_cast<int>(D), scale, causal != 0, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, void* lse,
             long long B, long long S, long long H, long long D, long long causal,
             cudaStream_t stream) {
  if (D <= 32) return launch<T, 1, 16, 64>(q, k, v, out, lse, B, S, H, D, causal, stream);
  if (D <= 64) return launch<T, 2, 16, 64>(q, k, v, out, lse, B, S, H, D, causal, stream);
  if (D <= 128) return launch<T, 4, 16, 32>(q, k, v, out, lse, B, S, H, D, causal, stream);
  return launch<T, 8, 8, 32>(q, k, v, out, lse, B, S, H, D, causal, stream);
}

}  // namespace

extern "C" {

// q, k, v, out: contiguous [B, S, H, D]; dtype 0 = f32, 1 = bf16; lse:
// [B, H, S] f32 or null; 1 <= D <= 256. Enqueued on `stream`, not waited.
int srt_flash_attn_fwd(const void* q, const void* k, const void* v, void* out, void* lse,
                       long long B, long long S, long long H, long long D, long long dtype,
                       long long causal, void* stream) {
  if (B < 0 || S < 0 || H < 0 || D < 1 || D > 256 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || S == 0 || H == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? dispatch<float>(q, k, v, out, lse, B, S, H, D, causal, st)
                    : dispatch<__nv_bfloat16>(q, k, v, out, lse, B, S, H, D, causal, st);
}

}  // extern "C"
