// merge_runs.cu — the merge of a sort's received sorted runs, for sm_90a.
//
// Replaces no TPU kernel: the JAX package's merge (sparkrdma_tpu/ops/
// sort.py merge_received) is plain jnp, a mask of the padding and a sort of
// the whole padded slab. On this card that form is a radix sort of every
// slot, padding included, behind a masked copy and two XOR copies, with
// int64 indices that nothing reads. The rows it sorts arrive sorted: each
// is a slice of one sender's sorted keys. This file merges them instead.
//
// What it computes, for each shard i of a uint32 slab [E, R, cap] whose row
// (i, j) is ascending in its first counts[i, j] slots (counts clamped to
// [0, cap]; the slots past them are never read):
//   merged[i] = the shard's valid keys ascending, then the sentinel up to
//               R * cap slots,
//   totals[i] = the shard's valid keys,
// byte for byte the per-shard mask-and-sort (merge_received) when the
// sentinel is 0xFFFFFFFF. Keys compare as unsigned 32-bit values.
//
// Design: log2(R) passes of pairwise merge-path merges (rounded up; and a
// last pass that copies where that count is even, so that the last pass
// lands in merged). Pass p merges, for each shard, the runs that cover
// original rows [g * 2^p, (g + 1) * 2^p) from the two runs of pass p - 1
// that cover its halves; a run starts at its first original row's slot,
// so every pass keeps the slab's layout. Passes ping-pong: odd passes read
// the slab (pass 1) or merged and write merged, even passes read merged and
// write the slab. The slab is the scratch: no buffer as large as it is
// allocated, and its bytes are undefined after a call of more than two
// runs. Each pass is two launches:
//   1. merge_partition: one thread a tile boundary searches the merge path
//      of its pair of runs (a binary search over global memory) and stores
//      where the tile starts in the first run;
//   2. merge_tile: one block a tile of kTile outputs of one pair loads the
//      two slices the boundaries give it, coalesced, into shared memory;
//      each thread finds its kItems outputs by a merge-path search there
//      and merges them in registers; the block stages them back through
//      shared memory (kItems is odd: the stride kItems is conflict-free)
//      and stores them coalesced. Blocks past the pair's valid keys return
//      at once; in the last pass they, and the last block of the valid
//      keys, write the sentinel into the row's tail, and block 0 of each
//      shard writes its total.
// A prologue launch (run_prefix) clamps the counts and sums them into each
// shard's run offsets, so no pass reads more than the valid keys.
//
// Why pairwise: a one-pass R-way merge moves the least bytes, but each of
// its tiles needs an R-way co-rank, a search over the key space with R
// binary searches a step. The pairwise merge-path split is one binary
// search a tile, proven and cheap, and log2(R) passes cost only bandwidth.
//
// What bounds it: device memory bandwidth. At the sort cell's shape
// ([8, 8, 2^23], 2^28 valid keys) the merge needs 3.22 GB: the valid keys
// read once (1.07 GB) and [8, 2^26] written (2.15 GB, the sentinel tail
// included), 0.96 ms at 3.35 TB/s. This design reads and writes the valid
// keys in each of its three passes and writes the tail once: 7.52 GB,
// 2.24 ms. Measured on an H100 at that shape: 2.76 ms, 81% of that, with
// tiles of 512 threads x 19 outputs. The partitions are one search a tile
// boundary, so larger tiles need fewer: at 256 x 15 they took 0.28 ms of
// 2.95. With plain loads and stores, other tiles read 256 x 15 2.87 ms,
// 384 x 15 2.95, 512 x 13 3.34, 512 x 15 2.80, 512 x 17 2.79, 512 x 21
// 3.07, 512 x 23 3.06, 768 x 15 3.99, 1024 x 11 4.15, 256 x 31 3.50;
// evict-first loads and stores (__ldcs, __stcs) read 0.06-0.08 ms slower
// at 256 x 15 and 512 x 15.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;             // merge_tile's threads
constexpr int kItems = 19;                // outputs a thread: odd, see above
constexpr int kTile = kThreads * kItems;  // outputs a tile
constexpr int kPartThreads = 256;
constexpr int kMaxRuns = 1024;            // run_prefix: a shard's runs in one block

struct Pass {
  const unsigned* src;
  unsigned* dst;
  const int* prefix;  // [e, r + 1]: each shard's clamped counts, summed
  int* parts;         // [e, groups, tiles + 1]: the tiles' starts in the first run
  long long cap;      // slots an original row
  long long row;      // slots a shard: r * cap
  long long tiles;    // tiles a pair: ceil(min(w, r) * cap / kTile)
  int r;              // original rows a shard
  int w;              // original rows a pass-p run covers: 2^p
  int groups;         // pairs a shard: ceil(r / w)
  bool last;          // writes merged's tail and the totals
  unsigned sentinel;
  int* totals;
};

// One pair of runs of a shard: the first covers original rows [lo, mid),
// the second [mid, hi); both start at their first row's slot.
struct Pair {
  const unsigned* a;
  const unsigned* b;
  unsigned* out;
  int na, nb;
};

__device__ __forceinline__ Pair pair_of(const Pass& s, long long shard, int g) {
  const int lo = g * s.w;
  const int mid = min(s.r, lo + s.w / 2);
  const int hi = min(s.r, lo + s.w);
  const int* pre = s.prefix + shard * (s.r + 1);
  const long long base = shard * s.row;
  Pair p;
  p.a = s.src + base + lo * s.cap;
  p.b = s.src + base + mid * s.cap;
  p.out = s.dst + base + lo * s.cap;
  p.na = pre[mid] - pre[lo];
  p.nb = pre[hi] - pre[mid];
  return p;
}

// How many of the first `diag` outputs of merging a and b come from a;
// ties go to a first (the merge below takes a's key when a <= b).
template <typename LoadA, typename LoadB>
__device__ __forceinline__ int merge_path(int na, int nb, int diag, LoadA load_a,
                                          LoadB load_b) {
  int lo = diag > nb ? diag - nb : 0;
  int hi = diag < na ? diag : na;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (load_a(mid) <= load_b(diag - 1 - mid)) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// prefix[shard][j] = sum of the first j counts of the shard, each clamped
// to [0, cap]
__global__ void __launch_bounds__(kMaxRuns)
run_prefix(const int* __restrict__ counts, int* __restrict__ prefix, int r, long long cap) {
  __shared__ int c[kMaxRuns];
  const long long shard = blockIdx.x;
  const int t = threadIdx.x;
  if (t < r) {
    const int v = counts[shard * r + t];
    c[t] = v < 0 ? 0 : (v > cap ? static_cast<int>(cap) : v);
  }
  __syncthreads();
  if (t == 0) {
    int* pre = prefix + shard * (r + 1);
    int run = 0;
    pre[0] = 0;
    for (int j = 0; j < r; ++j) {
      run += c[j];
      pre[j + 1] = run;
    }
  }
}

__global__ void __launch_bounds__(kPartThreads)
merge_partition(Pass s) {
  const long long k = static_cast<long long>(blockIdx.x) * kPartThreads + threadIdx.x;
  if (k > s.tiles) return;
  const long long shard = blockIdx.z;
  const int g = blockIdx.y;
  const Pair p = pair_of(s, shard, g);
  const long long n = static_cast<long long>(p.na) + p.nb;
  const int diag = static_cast<int>(k * kTile < n ? k * kTile : n);
  const unsigned* a = p.a;
  const unsigned* b = p.b;
  s.parts[(shard * s.groups + g) * (s.tiles + 1) + k] = merge_path(
      p.na, p.nb, diag, [a](int i) { return __ldg(a + i); },
      [b](int i) { return __ldg(b + i); });
}

__device__ __forceinline__ void fill(unsigned* out, long long from, long long to,
                                     unsigned v) {
  for (long long j = from + threadIdx.x; j < to; j += kThreads) out[j] = v;
}

__global__ void __launch_bounds__(kThreads)
merge_tile(Pass s) {
  __shared__ unsigned keys[kTile + 1];
  const int tid = threadIdx.x;
  const long long tile = blockIdx.x, shard = blockIdx.z;
  const int g = blockIdx.y;
  const Pair p = pair_of(s, shard, g);
  const int n = p.na + p.nb;
  const long long d0 = tile * kTile;
  if (s.last && tile == 0 && g == 0 && tid == 0) s.totals[shard] = n;
  if (d0 >= n) {
    if (s.last) fill(p.out, d0, d0 + kTile < s.row ? d0 + kTile : s.row, s.sentinel);
    return;
  }
  const int len = static_cast<int>(d0 + kTile < n ? kTile : n - d0);
  const int* part = s.parts + (shard * s.groups + g) * (s.tiles + 1) + tile;
  const int a0 = part[0], a1 = part[1];
  const int b0 = static_cast<int>(d0) - a0;
  const int na = a1 - a0;
  // the tile's slice of a, then its slice of b
  const unsigned* a = p.a + a0;
  const unsigned* b = p.b + b0 - na;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int i = tid + j * kThreads;
    if (i < len) keys[i] = i < na ? a[i] : b[i];
  }
  __syncthreads();

  const int diag = tid * kItems < len ? tid * kItems : len;
  int ai = merge_path(na, len - na, diag, [](int i) { return keys[i]; },
                      [na](int i) { return keys[na + i]; });
  int bi = na + diag - ai;
  // keys[len] may be read, never used; a thread past the tile's end runs
  // on a's side, clamped
  unsigned ka = keys[ai], kb = keys[bi];
  unsigned out[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const bool take_a = bi >= len || (ai < na && ka <= kb);
    out[j] = take_a ? ka : kb;
    if (take_a) {
      ++ai;
      ka = keys[ai < len ? ai : len];
    } else {
      kb = keys[++bi];
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kItems; ++j)
    if (diag + j < len) keys[diag + j] = out[j];
  __syncthreads();
  unsigned* dst = p.out + d0;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int i = tid + j * kThreads;
    if (i < len) dst[i] = keys[i];
  }
  if (s.last && len < kTile)
    fill(p.out, d0 + len, d0 + kTile < s.row ? d0 + kTile : s.row, s.sentinel);
}

int passes_of(long long r) {
  int p = 0;
  while ((1ll << p) < r) ++p;
  return p % 2 ? p : p + 1;  // odd: the last pass writes merged
}

long long tiles_of(long long w, long long r, long long cap) {
  const long long rows = w < r ? w : r;
  return (rows * cap + kTile - 1) / kTile;
}

}  // namespace

extern "C" {

// int32 elements of the scratch that srt_merge_runs takes for e shards of
// r runs of cap slots: the run offsets and the largest pass's tile starts.
long long srt_merge_runs_scratch(long long e, long long r, long long cap) {
  long long parts = 0;
  const int passes = passes_of(r);
  for (int p = 1; p <= passes; ++p) {
    const long long w = 1ll << p;
    const long long groups = (r + w - 1) / w;
    const long long n = groups * (tiles_of(w, r, cap) + 1);
    parts = n > parts ? n : parts;
  }
  return e * (r + 1) + e * parts;
}

// slab: [e, r, cap] uint32, row (i, j) ascending in its first counts[i, j]
// slots, overwritten (undefined after the call) where r > 2; counts: [e, r]
// int32; merged: [e, r * cap] uint32; totals: [e] int32; scratch:
// srt_merge_runs_scratch(e, r, cap) int32. e in [1, 65535], r in [1, 1024],
// cap >= 1, r * cap < 2^31. Returns a cudaError_t code.
int srt_merge_runs(void* slab, const void* counts, void* merged, void* totals,
                   void* scratch, long long e, long long r, long long cap,
                   long long sentinel, void* stream) {
  if (e < 1 || e > 65535 || r < 1 || r > kMaxRuns || cap < 1 ||
      r * cap > 0x7fffffffll || sentinel < 0 || sentinel > 0xffffffffll)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* prefix = static_cast<int*>(scratch);
  run_prefix<<<static_cast<unsigned>(e), kMaxRuns, 0, st>>>(
      static_cast<const int*>(counts), prefix, static_cast<int>(r), cap);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  unsigned* bufs[2] = {static_cast<unsigned*>(slab), static_cast<unsigned*>(merged)};
  const int passes = passes_of(r);
  for (int p = 1; p <= passes; ++p) {
    Pass s;
    s.src = bufs[(p + 1) % 2];  // pass 1 reads the slab
    s.dst = bufs[p % 2];
    s.prefix = prefix;
    s.parts = prefix + e * (r + 1);
    s.cap = cap;
    s.row = r * cap;
    s.r = static_cast<int>(r);
    s.w = 1 << p;
    s.groups = static_cast<int>((r + s.w - 1) / s.w);
    s.tiles = tiles_of(s.w, r, cap);
    s.last = p == passes;
    s.sentinel = static_cast<unsigned>(sentinel);
    s.totals = static_cast<int*>(totals);
    const dim3 grid_part(static_cast<unsigned>((s.tiles + kPartThreads) / kPartThreads),
                         static_cast<unsigned>(s.groups), static_cast<unsigned>(e));
    merge_partition<<<grid_part, kPartThreads, 0, st>>>(s);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid(static_cast<unsigned>(s.tiles), static_cast<unsigned>(s.groups),
                    static_cast<unsigned>(e));
    merge_tile<<<grid, kThreads, 0, st>>>(s);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

const char* srt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
