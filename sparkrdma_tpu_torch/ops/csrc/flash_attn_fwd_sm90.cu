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
// The PTX wrappers, descriptors and tensor-map encoding are shared with the
// backward (flash_attn_sm90_common.cuh).

#include "flash_attn_sm90_common.cuh"
#include "launch_config.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kRows = 128;         // q rows of a CTA, keys of a kv tile
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

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, void* lse, long long B,
           long long S, long long H, long long causal, cudaStream_t stream) {
  using L = Smem<D>;
  auto kernel = flash_fwd_sm90_kernel<D>;
  static PerDevice raised;
  cudaError_t e = raise_smem_limit(kernel, L::kBytes, raised);
  if (e != cudaSuccess) return static_cast<int>(e);
  EncodeTiled fn;
  e = encoder(&fn);
  if (e != cudaSuccess) return static_cast<int>(e);
  CUtensorMap tq, tk, tv;
  if ((e = encode(fn, &tq, q, B, S, H, D, kRows)) != cudaSuccess ||
      (e = encode(fn, &tk, k, B, S, H, D, kRows)) != cudaSuccess ||
      (e = encode(fn, &tv, v, B, S, H, D, kRows)) != cudaSuccess)
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
