// radix_pack.cu — the hash join's partition pack, for sm_90a.
//
// Replaces no TPU kernel: the JAX package's pack (sparkrdma_tpu/ops/
// sort.py radix_partition + pack_by_partition) is plain jnp, a stable
// sort of the destinations and a scatter. On this card that plain form
// costs a full stable argsort, gathers, a whole-slab fill and host syncs
// for every shard and column; this kernel is the one-pass partitioning
// a GPU does instead.
//
// Two row widths, one template (T, the keys' and payloads' type):
//   srt_radix_pack:   4-byte rows, uint32 keys (as their int32 bits) and
//                     int32 payloads, key_bits in [log2 P, 32];
//   srt_radix_pack64: 8-byte rows, uint64 keys (as their int64 bits) and
//                     int64 payloads, key_bits in [log2 P, 64].
// Both take srt_radix_pack_scratch's scratch: the tile is the same.
//
// What it computes, for each shard i of an [E, n] stack of keys and an
// [E, n] payload column:
//   dest    = the key's top log2(P) bits below key_bits (radix_partition),
//   kslab[i], counts[i], flags[i] = pack_by_partition(keys[i], dest, P, cap, key_fill),
//   vslab[i]                      = pack_by_partition(vals[i], dest, P, cap, val_fill),
// byte for byte: row d of a slab holds partition d's rows in input
// order; a partition above cap keeps its first cap - 1 rows and its last
// row in slot cap - 1; slots past the count hold the fill; counts are
// clamped to cap and flags[i] says whether any partition of shard i
// overflowed. Keys must lie below 2^key_bits (the plain version's
// contract); the kernel keeps the destination's low log2(P) bits.
//
// What bounds it: device memory bandwidth. A side reads its keys twice
// and its payloads once, and writes two [E, P, cap] slabs, padding
// included; there is no arithmetic to speak of. Three launches on the
// caller's stream, nothing read back to the host:
//   1. radix_hist: one block a tile of kTile rows of one shard counts
//      the tile's rows per destination (warp ballots aggregate equal
//      destinations, one shared atomic per group);
//   2. radix_scan: one block a (shard, dest) scans that destination's
//      tile counts into each tile's first rank in the partition, and
//      writes the partition's total and its clamped count;
//   3. radix_scatter: one block a tile re-reads its rows, ranks each
//      stably inside the tile (warp ballots in row order, then per-warp
//      counts scanned in warp order), stages the tile in shared memory
//      grouped by destination and stores each destination's run
//      contiguously, keys and payloads in the same pass. The same block
//      then writes the fill into its share of every row's padding slots
//      [count, cap), and only those: no slab is filled first.
// Scratch (tile counts, totals) comes from the caller; the kernel
// allocates nothing. The 8-byte scatter stages 32 KB of rows a block
// (44 KB of static shared memory in all) and holds twice the registers
// for its rows, so it runs fewer blocks an SM than the 4-byte one.

#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerThread = 8;
constexpr int kTile = kThreads * kRowsPerThread;  // rows a block
constexpr int kMaxPartitions = 256;
constexpr int kScanThreads = 1024;
// radix_scatter's blocks an SM at 4-byte rows: at 64 registers a thread
// four fit the registers (and eight the shared memory, 27 KB each);
// fewer blocks of more registers, tiles of 4,096 rows, or loading the
// payloads only after the ranking each measured slower at the join's
// shape
constexpr int kScatterBlocksPerSM = 4;
// at 8-byte rows: three blocks an SM leave a thread 85 registers (its
// rows take 32 of them; ptxas uses 79, no spills) and 44 KB of shared
// memory a block
constexpr int kScatterBlocksPerSM64 = 3;
constexpr unsigned kFull = 0xffffffffu;

struct Shape {
  long long n;      // rows a shard
  long long tiles;  // tiles a shard: ceil(n / kTile)
  int p;            // partitions, a power of two <= kMaxPartitions
  int lg;           // log2(p)
  int shift;        // key_bits - lg
  long long cap;    // slots a partition
};

template <typename T>
__device__ __forceinline__ int dest_of(T key, const Shape& s) {
  using U = typename std::make_unsigned<T>::type;
  return s.lg == 0 ? 0 : static_cast<int>((static_cast<U>(key) >> s.shift) &
                                          static_cast<U>(s.p - 1));
}

// The lanes of this warp whose row is valid and has destination d
// (every lane of the warp calls it).
__device__ __forceinline__ unsigned peers_of(int d, bool valid, int lg) {
  unsigned peers = __ballot_sync(kFull, valid);
  for (int b = 0; b < lg; ++b) {
    const bool set = (d >> b) & 1;
    const unsigned bits = __ballot_sync(kFull, set);
    peers &= set ? bits : ~bits;
  }
  return peers;
}

__device__ __forceinline__ long long tile_rows(long long tile, const Shape& s) {
  const long long left = s.n - tile * kTile;
  return left < kTile ? (left > 0 ? left : 0) : kTile;
}

// hist[(shard * p + d) * tiles + tile] = rows of the tile with destination d
template <typename T>
__global__ void __launch_bounds__(kThreads)
radix_hist(const T* __restrict__ keys, int* __restrict__ hist, Shape s) {
  __shared__ int h[kMaxPartitions];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long tile = blockIdx.x, shard = blockIdx.y;
  for (int d = tid; d < s.p; d += kThreads) h[d] = 0;
  __syncthreads();
  const long long rows = tile_rows(tile, s);
  const T* src = keys + shard * s.n + tile * kTile;
  const int first = warp * 32 * kRowsPerThread + lane;
  T key[kRowsPerThread];
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const int i = first + r * 32;
    key[r] = i < rows ? __ldg(src + i) : T(0);
  }
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const bool valid = first + r * 32 < rows;
    const int d = dest_of(key[r], s);
    const unsigned peers = peers_of(d, valid, s.lg);
    if (valid && lane == __ffs(peers) - 1) atomicAdd(&h[d], __popc(peers));
  }
  __syncthreads();
  for (int d = tid; d < s.p; d += kThreads) hist[(shard * s.p + d) * s.tiles + tile] = h[d];
}

// Exclusive scan of one (shard, d) row of hist over its tiles, in place;
// totals[shard * p + d] = the partition's rows, counts = min(total, cap).
// T names the row width in the kernel's name only (its device time then
// goes to its width in a trace); the scan reads tile counts.
template <typename T>
__global__ void __launch_bounds__(kScanThreads)
radix_scan(int* __restrict__ hist, int* __restrict__ totals, int* __restrict__ counts,
           Shape s) {
  __shared__ int warp_sums[kScanThreads / 32];
  __shared__ int carry;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long row = static_cast<long long>(blockIdx.y) * s.p + blockIdx.x;
  int* a = hist + row * s.tiles;
  if (tid == 0) carry = 0;
  __syncthreads();
  for (long long base = 0; base < s.tiles; base += kScanThreads) {
    const long long i = base + tid;
    const int v = i < s.tiles ? a[i] : 0;
    int incl = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += t;
    }
    if (lane == 31) warp_sums[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      int w = warp_sums[lane];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int t = __shfl_up_sync(kFull, w, o);
        if (lane >= o) w += t;
      }
      warp_sums[lane] = w;  // inclusive over warps
    }
    __syncthreads();
    const int before = carry + (warp ? warp_sums[warp - 1] : 0);
    if (i < s.tiles) a[i] = before + incl - v;
    __syncthreads();
    if (tid == 0) carry += warp_sums[kScanThreads / 32 - 1];
    __syncthreads();
  }
  if (tid == 0) {
    totals[row] = carry;
    counts[row] = carry < s.cap ? carry : static_cast<int>(s.cap);
  }
}

template <typename T, int kBlocksPerSM>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
radix_scatter(const T* __restrict__ keys, const T* __restrict__ vals,
              const int* __restrict__ hist, const int* __restrict__ totals,
              T* __restrict__ kslab, T* __restrict__ vslab,
              unsigned char* __restrict__ flags, Shape s, T key_fill, T val_fill) {
  __shared__ T sk[kTile];
  __shared__ T sv[kTile];
  __shared__ int wcount[kWarps][kMaxPartitions];  // per-warp counts, then offsets
  __shared__ int tstart[kMaxPartitions];          // a destination's first slot in sk
  __shared__ int goff[kMaxPartitions];            // the tile's first rank in the partition
  __shared__ int total[kMaxPartitions];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long tile = blockIdx.x, shard = blockIdx.y;
  const long long rows = tile < s.tiles ? tile_rows(tile, s) : 0;
  for (int j = tid; j < kWarps * kMaxPartitions; j += kThreads) (&wcount[0][0])[j] = 0;
  for (int d = tid; d < s.p; d += kThreads) {
    total[d] = totals[shard * s.p + d];
    goff[d] = tile < s.tiles ? hist[(shard * s.p + d) * s.tiles + tile] : 0;
  }
  __syncthreads();
  if (tile == 0 && tid == 0) {
    bool over = false;
    for (int d = 0; d < s.p; ++d) over |= total[d] > s.cap;
    flags[shard] = over;
  }

  // the tile's rows: warp w owns rows [w * 32 * K, (w + 1) * 32 * K), and
  // in round r lane l holds row w * 32 * K + r * 32 + l, so rounds then
  // lanes walk the rows in order
  const long long at = shard * s.n + tile * kTile;
  const int first = warp * 32 * kRowsPerThread + lane;
  T key[kRowsPerThread], val[kRowsPerThread];
  int rank[kRowsPerThread];
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const int i = first + r * 32;
    key[r] = i < rows ? __ldg(keys + at + i) : T(0);
    val[r] = i < rows ? __ldg(vals + at + i) : T(0);
  }
  const unsigned lower = (1u << lane) - 1;
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const bool valid = first + r * 32 < rows;
    const int d = dest_of(key[r], s);
    const unsigned peers = peers_of(d, valid, s.lg);
    const int seen = valid ? wcount[warp][d] : 0;
    __syncwarp();
    if (valid && lane == __ffs(peers) - 1) wcount[warp][d] = seen + __popc(peers);
    __syncwarp();
    rank[r] = seen + __popc(peers & lower);  // among the warp's rows of d so far
  }
  __syncthreads();
  // per destination: the warps' counts into offsets in warp order, and
  // the tile's count
  for (int d = tid; d < s.p; d += kThreads) {
    int run = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int c = wcount[w][d];
      wcount[w][d] = run;
      run += c;
    }
    tstart[d] = run;
  }
  __syncthreads();
  // tile counts into the destinations' first slots in sk (warp 0)
  if (warp == 0) {
    const int per = (s.p + 31) / 32;
    const int lo = lane * per;
    int sum = 0;
    for (int j = lo; j < lo + per && j < s.p; ++j) sum += tstart[j];
    int incl = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += t;
    }
    int run = incl - sum;
    for (int j = lo; j < lo + per && j < s.p; ++j) {
      const int c = tstart[j];
      tstart[j] = run;
      run += c;
    }
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    if (first + r * 32 < rows) {
      const int d = dest_of(key[r], s);
      const int pos = tstart[d] + wcount[warp][d] + rank[r];
      sk[pos] = key[r];
      sv[pos] = val[r];
    }
  }
  __syncthreads();

  // each destination's run to its row of the slabs, neighbouring threads
  // on neighbouring slots
  const long long last = s.cap - 1;
  for (int i = tid; i < rows; i += kThreads) {
    const T k = sk[i];
    const int d = dest_of(k, s);
    const long long r = static_cast<long long>(goff[d]) + (i - tstart[d]);
    const long long slot = r < last ? r : (r == total[d] - 1 ? last : -1);
    if (slot >= 0) {
      const long long o = (shard * s.p + d) * s.cap + slot;
      kslab[o] = k;
      vslab[o] = sv[i];
    }
  }

  // this block's share of every row's padding
  const long long chunk = (s.cap + gridDim.x - 1) / gridDim.x;
  const long long lo = tile * chunk;
  const long long hi = lo + chunk < s.cap ? lo + chunk : s.cap;
  for (int d = 0; d < s.p; ++d) {
    const long long c = total[d] < s.cap ? total[d] : s.cap;
    const long long row = (shard * s.p + d) * s.cap;
    for (long long j = (lo > c ? lo : c) + tid; j < hi; j += kThreads) {
      kslab[row + j] = key_fill;
      vslab[row + j] = val_fill;
    }
  }
}

long long tiles_of(long long n) { return (n + kTile - 1) / kTile; }

// One pack of T-wide rows: the three launches on the caller's stream.
template <typename T, int kBlocksPerSM>
int radix_pack(const void* keys, const void* vals, void* kslab, void* vslab,
               void* counts, void* flags, void* scratch, long long e, long long n,
               long long p, long long key_bits, long long cap, long long key_fill,
               long long val_fill, void* stream) {
  constexpr long long kKeyBits = 8 * sizeof(T);
  int lg = 0;
  while ((1ll << lg) < p) ++lg;
  if (e < 0 || e > 65535 || n < 0 || n > 0x7fffffffll || p < 1 || p > kMaxPartitions ||
      (1ll << lg) != p || key_bits < lg || key_bits > kKeyBits || cap < 1 ||
      cap > 0x7fffffffll)
    return static_cast<int>(cudaErrorInvalidValue);
  if (e == 0) return 0;
  Shape s;
  s.n = n;
  s.tiles = tiles_of(n);
  s.p = static_cast<int>(p);
  s.lg = lg;
  s.shift = static_cast<int>(key_bits) - lg;
  s.cap = cap;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* hist = static_cast<int*>(scratch);
  int* totals = hist + e * p * s.tiles;
  const unsigned ue = static_cast<unsigned>(e);
  if (s.tiles > 0) {
    radix_hist<T><<<dim3(static_cast<unsigned>(s.tiles), ue), kThreads, 0, st>>>(
        static_cast<const T*>(keys), hist, s);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  radix_scan<T><<<dim3(static_cast<unsigned>(p), ue), kScanThreads, 0, st>>>(
      hist, totals, static_cast<int*>(counts), s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = static_cast<unsigned>(s.tiles > 0 ? s.tiles : 1);
  radix_scatter<T, kBlocksPerSM><<<dim3(blocks, ue), kThreads, 0, st>>>(
      static_cast<const T*>(keys), static_cast<const T*>(vals), hist, totals,
      static_cast<T*>(kslab), static_cast<T*>(vslab),
      static_cast<unsigned char*>(flags), s, static_cast<T>(key_fill),
      static_cast<T>(val_fill));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// int32 elements of the scratch that srt_radix_pack and srt_radix_pack64
// take for an [e, n] stack into p partitions: the tile counts and the
// totals.
long long srt_radix_pack_scratch(long long e, long long n, long long p) {
  return e * p * (tiles_of(n) + 1);
}

// keys, vals: [e, n] int32 (the keys as their uint32 bits); kslab, vslab:
// [e, p, cap] int32; counts: [e, p] int32; flags: [e] bytes (bool);
// scratch: srt_radix_pack_scratch(e, n, p) int32. p a power of two in
// [1, 256], key_bits in [log2 p, 32], cap >= 1, n < 2^31; key_fill and
// val_fill as int32 values. Returns a cudaError_t code.
int srt_radix_pack(const void* keys, const void* vals, void* kslab, void* vslab,
                   void* counts, void* flags, void* scratch, long long e, long long n,
                   long long p, long long key_bits, long long cap, long long key_fill,
                   long long val_fill, void* stream) {
  return radix_pack<int, kScatterBlocksPerSM>(keys, vals, kslab, vslab, counts, flags,
                                               scratch, e, n, p, key_bits, cap, key_fill,
                                               val_fill, stream);
}

// srt_radix_pack at 8-byte rows: keys, vals [e, n] int64 (the keys as
// their uint64 bits); kslab, vslab [e, p, cap] int64; key_bits in
// [log2 p, 64]; key_fill and val_fill as int64 values. Everything else
// as srt_radix_pack.
int srt_radix_pack64(const void* keys, const void* vals, void* kslab, void* vslab,
                     void* counts, void* flags, void* scratch, long long e, long long n,
                     long long p, long long key_bits, long long cap, long long key_fill,
                     long long val_fill, void* stream) {
  return radix_pack<long long, kScatterBlocksPerSM64>(
      keys, vals, kslab, vslab, counts, flags, scratch, e, n, p, key_bits, cap, key_fill,
      val_fill, stream);
}

const char* srt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
