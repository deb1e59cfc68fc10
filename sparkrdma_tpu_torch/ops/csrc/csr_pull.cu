// csr_pull.cu — PageRank's edge pull over destination-grouped (CSR) edges,
// for sm_90a.
//
// Replaces no TPU kernel: the JAX package's scatter is plain jnp
// (sparkrdma_tpu/models/pagerank.py:100, jnp.zeros(...).at[d_idx].add(...), no
// pallas_call). On this card that form is ATen's float index_add_: one
// random float atomic an edge into the 2.1 GB contribution stack, behind
// an index_select that writes every edge's value out and reads it back,
// padding slots included. This file pulls instead: the edges are grouped
// by destination once a stage, and every iteration each destination's sum
// is gathered in registers and written once, with no float atomic an edge.
//
// Layout. PageRank's blocks arrive as packed [E*E, cap] pairs (src_local,
// dst_local) of int32, -1 padding; block b = s*E + d. Row r = b*n_local + v
// of the CSR is destination v of block b, the slot of the contribution
// stack that the all-to-all sends. The CSR is one array `ends` of rows + 2
// indices (offsets = ends + 1: offsets[r] is row r's first edge and
// offsets[rows] the edge count) and `src`, each edge's source as its index
// into the out-contributions (s * n_local + src_local: the vertex id).
// Indices are int32, or int64 (the template's Idx) where rows plus slots
// reach 2^31.
//
// The build, once a stage, one call: a counting sort of the valid slots by
// row, in two levels so that its counters live in shared memory and its
// stores go out in runs. One counter an edge in global memory (an L2
// atomic for the count and another for the place, then a 4-byte store to
// a random place of a block's 67 MB) measured 92.5 ms at the cell's shape.
// A bucket is kBucketRows rows of one block.
//   1. csr_bucket_count: a CTA a tile of kSortTile slots of one block
//      counts its valid slots a bucket (shared atomics) into hist[(b * nb
//      + bucket) * t1 + tile];
//   2. csr_scan_*: an inclusive scan of hist in place. Row-major CSR order
//      is (block, bucket, tile) order, so it gives every tile's first place
//      in each bucket, and every bucket's range;
//   3. csr_bucket_place: the same CTAs stage their tiles in shared memory
//      grouped by bucket (shared cursors) and store each bucket's run in
//      one piece: each edge's source into tsrc and its row within the
//      bucket into tdl (uint16);
//   4. csr_bucket_rows: a CTA a bucket counts its edges a row (shared
//      atomics), scans the counts, writes the bucket's rows' offsets and
//      places each source in its row (shared cursors), staged in shared
//      memory where the bucket fits, into src.
// Placement by shared atomic cursors: a row's edges land in the order the
// atomics run, which changes from run to run, and so does the order of each
// float sum. A stable placement would rank every edge among the earlier
// edges of its row, a sort. Padding is dropped. Where a block's buckets
// outnumber the shared counters (n_local > kMaxBuckets * kBucketRows), the
// build counts into ends by global atomics, scans, and places by global
// atomic cursors (csr_count, csr_place). That path stays beside the
// bucketed one because the bucketed layout is sized by shared memory at
// both levels: csr_bucket_place holds 8,192 bucket counters and a staged
// tile (192 KB), csr_bucket_rows 4,096 row counters, and tdl keeps a row
// within its bucket in 16 bits. Wider buckets would need passes of
// csr_bucket_rows over each bucket's edges, one a 4,096 rows, and a 32-bit
// tdl past 2^16 rows a bucket (n_local > 2^29, which E = 1 or 2 allow);
// the 32-bit tdl on every shape would add 4.3 GB of scratch traffic to the
// cell's build. The global path is two short kernels; the card tests run
// it at 40,000,000 rows a block. Measured on an H100 at the cell's
// shape: 27.4 ms (count 4.3, scan 2.0, place 14.5, rows 6.2, split 0.5);
// unstaged, with 65,536-slot tiles, 103 ms; staged with 8,192-slot tiles 36.9.
//   5. csr_partition: the merge-path coordinates (rows done, edges done) at
//      every tile's first step (the split of CUB's DeviceSpmv). The path
//      walks the rows' ends and the edges together, rows + edges steps, and
//      a tile takes kTile steps, so every tile holds kTile rows and edges
//      together whatever the in-degrees: the cell's top hub has ~107,000
//      edges in one block's row, the mean row 2.
// The pull, every iteration (two launches):
//   6. csr_pull: a block a tile loads its edges' sources (streaming: read
//      once), gathers their out-contributions into shared memory (kItems
//      independent loads a thread in flight), and loads its rows' ends.
//      Each thread finds its kItems path steps by a merge-path search in
//      shared memory and sums them in registers; a segmented scan over the
//      block's threads adds each thread's first finished row the partial
//      sums of the threads before it; every row that ends in the tile is
//      then stored once, coalesced, an empty row as 0. The partial sum of
//      the row still open at the tile's end goes to carry[tile].
//   7. csr_carry: one thread a tile adds its carry into that row (float
//      atomics: at most one a tile, against one an edge before).
//
// What bounds the pull: memory latency, the random gather's above all. The
// bytes it needs at the cell's shape (2^30 edges, 2^29 rows): src 4.29 GB
// and the offsets 2.15 GB read, the contributions 2.15 GB written, the
// out-contributions 0.27 GB read, 8.86 GB or 2.64 ms at 3.35 TB/s. But each
// edge's out-contribution is a random 4-byte read that moves a 32-byte
// sector: 2^30 sectors, 34.4 GB through L2 an iteration. Tiles run in row
// order, so the E blocks of one source shard run together and read that
// shard's 33.5 MB of out-contributions; src and the offsets are read with
// evict-first hints (__ldcs) so that they do not push them out of L2.
// Measured on an H100 at the cell's shape: 10.3 ms; 9.7 ms with no sums
// (loads and stores alone), 6.9 ms with every gather aimed into 16 KB and
// 9.2 ms into 16.7 MB. Each of these read the same or slower: an L2
// evict-last hint on the gathers; 6, 7, 10 or 12 steps a thread; 128
// threads a block; 6 or 8 blocks an SM; the row ends loaded beside the
// sources; cp.async copies in place of the loads; persistent blocks that
// fetch the next tile during the sums.

#include <cstdint>
#include <cuda_runtime.h>

#include "launch_config.cuh"

namespace {

constexpr int kThreads = 256;             // csr_pull's threads
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 8;                 // path steps a thread
constexpr int kTile = kThreads * kItems;  // path steps a tile
constexpr int kPullBlocksPerSM = 4;
constexpr int kBucketBits = 12;
constexpr int kBucketRows = 1 << kBucketBits;  // rows a bucket
constexpr int kMaxBuckets = 8192;              // a block's buckets: shared counters
constexpr int kSortThreads = 1024;             // csr_bucket_count / _place
constexpr int kSortTile = 16384;               // slots a tile of those
constexpr int kBucketsPerThread = kMaxBuckets / kSortThreads;
constexpr int kRowThreads = 512;               // csr_bucket_rows
constexpr int kRowItems = kBucketRows / kRowThreads;
constexpr int kStageEdges = 12288;  // a bucket's edges csr_bucket_rows stages in shared memory
constexpr int kScanThreads = 1024;
constexpr int kScanItems = 16;
constexpr int kScanChunk = kScanThreads * kScanItems;
constexpr int kBuildThreads = 256;  // csr_count / csr_place
constexpr int kBuildSlots = 4;      // slots a thread of those
constexpr int kBuildTile = kBuildThreads * kBuildSlots;
constexpr int kLoads = 4;           // slots in flight a thread of the sort
constexpr unsigned kFull = 0xffffffffu;

struct Build {
  long long e;        // shards
  long long cap;      // slots a block
  long long n_local;  // rows a block
  long long rows;     // e * e * n_local
  long long nb;       // buckets a block: ceil(n_local / kBucketRows)
  long long t1;       // sort tiles a block: ceil(cap / kSortTile)
  long long tiles;    // csr_count / csr_place tiles a block: ceil(cap / kBuildTile)
  long long hist;     // hist's entries: e * e * nb * t1
};

Build build_of(long long e, long long cap, long long n_local) {
  Build g;
  g.e = e;
  g.cap = cap;
  g.n_local = n_local;
  g.rows = e * e * n_local;
  g.nb = (n_local + kBucketRows - 1) / kBucketRows;
  g.t1 = (cap + kSortTile - 1) / kSortTile;
  g.tiles = (cap + kBuildTile - 1) / kBuildTile;
  g.hist = e * e * g.nb * g.t1;
  return g;
}

bool bucketed(const Build& g) { return g.nb <= kMaxBuckets; }

// An exclusive scan of one value a thread over the block; *total gets the
// block's sum. warp_tot: blockDim.x / 32 entries of shared memory.
template <typename T>
__device__ __forceinline__ T block_exclusive(T v, T* warp_tot, T* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  T incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const T t = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += t;
  }
  if (lane == 31) warp_tot[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    T w = lane < warps ? warp_tot[lane] : T(0);
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const T t = __shfl_up_sync(kFull, w, o);
      if (lane >= o) w += t;
    }
    if (lane < warps) warp_tot[lane] = w;
  }
  __syncthreads();
  const T before = warp ? warp_tot[warp - 1] : T(0);
  *total = warp_tot[warps - 1];
  __syncthreads();  // warp_tot is free again on return
  return before + incl - v;
}

// ---- an inclusive scan of a[0, n) in place: chunk sums, their scan, chunks

template <typename Idx>
__global__ void __launch_bounds__(kScanThreads)
csr_scan_sums(const Idx* __restrict__ a, Idx* __restrict__ part, long long n) {
  __shared__ Idx warp_tot[kScanThreads / 32];
  const long long lo = static_cast<long long>(blockIdx.x) * kScanChunk;
  const long long hi = lo + kScanChunk < n ? lo + kScanChunk : n;
  Idx sum = 0;
  for (long long i = lo + threadIdx.x; i < hi; i += kScanThreads) sum += a[i];
  Idx total;
  block_exclusive(sum, warp_tot, &total);
  if (threadIdx.x == 0) part[blockIdx.x] = total;
}

// part[0, chunks) into its exclusive scan, by one block
template <typename Idx>
__global__ void __launch_bounds__(kScanThreads)
csr_scan_parts(Idx* __restrict__ part, long long chunks) {
  __shared__ Idx warp_tot[kScanThreads / 32];
  Idx carry = 0;
  for (long long base = 0; base < chunks; base += kScanThreads) {
    const long long i = base + threadIdx.x;
    const Idx v = i < chunks ? part[i] : Idx(0);
    Idx total;
    const Idx excl = block_exclusive(v, warp_tot, &total);
    if (i < chunks) part[i] = carry + excl;
    carry += total;
  }
}

template <typename Idx>
__global__ void __launch_bounds__(kScanThreads)
csr_scan_chunks(Idx* __restrict__ a, const Idx* __restrict__ part, long long n) {
  __shared__ Idx warp_tot[kScanThreads / 32];
  const long long lo =
      static_cast<long long>(blockIdx.x) * kScanChunk + threadIdx.x * kScanItems;
  Idx v[kScanItems];
  Idx sum = 0;
#pragma unroll
  for (int k = 0; k < kScanItems; ++k) {
    v[k] = lo + k < n ? a[lo + k] : Idx(0);
    sum += v[k];
  }
  Idx total;
  Idx run = part[blockIdx.x] + block_exclusive(sum, warp_tot, &total);
#pragma unroll
  for (int k = 0; k < kScanItems; ++k) {
    run += v[k];
    if (lo + k < n) a[lo + k] = run;
  }
}

template <typename Idx>
cudaError_t scan(Idx* a, Idx* part, long long n, cudaStream_t st) {
  if (n == 0) return cudaSuccess;
  const long long chunks = (n + kScanChunk - 1) / kScanChunk;
  const unsigned grid = static_cast<unsigned>(chunks);
  csr_scan_sums<Idx><<<grid, kScanThreads, 0, st>>>(a, part, n);
  csr_scan_parts<Idx><<<1, kScanThreads, 0, st>>>(part, chunks);
  csr_scan_chunks<Idx><<<grid, kScanThreads, 0, st>>>(a, part, n);
  return cudaGetLastError();
}

// ---- the bucketed build

// hist[(b * nb + bucket) * t1 + tile] = the tile's valid slots in the bucket
template <typename Idx>
__global__ void __launch_bounds__(kSortThreads)
csr_bucket_count(const int2* __restrict__ packed, Idx* __restrict__ hist, Build g) {
  __shared__ int h[kMaxBuckets];
  const long long b = blockIdx.x / g.t1, t = blockIdx.x - b * g.t1;
  for (long long k = threadIdx.x; k < g.nb; k += kSortThreads) h[k] = 0;
  __syncthreads();
  const int2* slots = packed + b * g.cap;
  const long long lo = t * kSortTile;
  const long long hi = lo + kSortTile < g.cap ? lo + kSortTile : g.cap;
  for (long long j = lo + threadIdx.x; j < hi; j += kLoads * kSortThreads) {
    int2 p[kLoads];
#pragma unroll
    for (int k = 0; k < kLoads; ++k) {
      const long long at = j + k * kSortThreads;
      p[k] = at < hi ? __ldcs(slots + at) : make_int2(-1, -1);
    }
#pragma unroll
    for (int k = 0; k < kLoads; ++k)
      if (p[k].x >= 0) atomicAdd(&h[p[k].y >> kBucketBits], 1);
  }
  __syncthreads();
  for (long long k = threadIdx.x; k < g.nb; k += kSortThreads)
    hist[(b * g.nb + k) * g.t1 + t] = h[k];
}

// the first place of entry i of the scanned hist (i in [0, g.hist]: the
// place past the last edge at g.hist)
template <typename Idx>
__device__ __forceinline__ long long first_place(const Idx* hist, long long i) {
  return i == 0 ? 0 : static_cast<long long>(hist[i - 1]);
}

// Bytes of dynamic shared memory: csr_bucket_place's for nb buckets, and
// csr_bucket_rows'.
long long place_smem(long long nb) { return 8 * nb + 8ll * kSortTile; }
constexpr int kRowsSmem = 4 * (kBucketRows + kStageEdges);

// Each valid slot into its bucket: tsrc its source, tdl its row in the
// bucket. The tile is staged in shared memory grouped by bucket, and each
// bucket's run is stored contiguously: stores to 4 bytes of random places
// measured ~3x slower than the same bytes in runs.
template <typename Idx>
__global__ void __launch_bounds__(kSortThreads)
csr_bucket_place(const int2* __restrict__ packed, const Idx* __restrict__ hist,
                 int* __restrict__ tsrc, unsigned short* __restrict__ tdl, Build g) {
  extern __shared__ int smem[];
  int* cur = smem;           // nb: a bucket's next place in the staged tile
  int* delta = smem + g.nb;  // nb: its run's place from the block's first edge, less its first
  int* ssrc = smem + 2 * g.nb;
  unsigned short* sdl = reinterpret_cast<unsigned short*>(ssrc + kSortTile);
  unsigned short* sbk = sdl + kSortTile;
  __shared__ int warp_tot[kSortThreads / 32];
  const int tid = threadIdx.x;
  const long long b = blockIdx.x / g.t1, t = blockIdx.x - b * g.t1;
  const long long base = first_place(hist, b * g.nb * g.t1);
  const int2* slots = packed + b * g.cap;
  const long long lo = t * kSortTile;
  const long long hi = lo + kSortTile < g.cap ? lo + kSortTile : g.cap;
  // the tile's slots a bucket (hist held them before its scan); the tile
  // stays in L2 for the second read below
  for (long long k = tid; k < g.nb; k += kSortThreads) cur[k] = 0;
  __syncthreads();
  for (long long j = lo + tid; j < hi; j += kLoads * kSortThreads) {
    int2 p[kLoads];
#pragma unroll
    for (int k = 0; k < kLoads; ++k) {
      const long long at = j + k * kSortThreads;
      p[k] = at < hi ? slots[at] : make_int2(-1, -1);
    }
#pragma unroll
    for (int k = 0; k < kLoads; ++k)
      if (p[k].x >= 0) atomicAdd(&cur[p[k].y >> kBucketBits], 1);
  }
  __syncthreads();
  // their exclusive scan over the buckets: each bucket's first place in
  // the staged tile; thread i takes buckets [i * per, (i + 1) * per)
  const int per = static_cast<int>((g.nb + kSortThreads - 1) / kSortThreads);
  int c[kBucketsPerThread];
  int sum = 0;
#pragma unroll
  for (int i = 0; i < kBucketsPerThread; ++i) {
    const long long k = static_cast<long long>(tid) * per + i;
    c[i] = i < per && k < g.nb ? cur[k] : 0;
    sum += c[i];
  }
  int staged;
  int run = block_exclusive(sum, warp_tot, &staged);
#pragma unroll
  for (int i = 0; i < kBucketsPerThread; ++i) {
    const long long k = static_cast<long long>(tid) * per + i;
    if (i < per && k < g.nb) {
      cur[k] = run;
      delta[k] = static_cast<int>(first_place(hist, (b * g.nb + k) * g.t1 + t) - base) - run;
      run += c[i];
    }
  }
  __syncthreads();
  const int src_base = static_cast<int>((b / g.e) * g.n_local);
  for (long long j = lo + tid; j < hi; j += kLoads * kSortThreads) {
    int2 p[kLoads];
#pragma unroll
    for (int k = 0; k < kLoads; ++k) {
      const long long at = j + k * kSortThreads;
      p[k] = at < hi ? slots[at] : make_int2(-1, -1);
    }
#pragma unroll
    for (int k = 0; k < kLoads; ++k) {
      if (p[k].x >= 0) {
        const int bucket = p[k].y >> kBucketBits;
        const int at = atomicAdd(&cur[bucket], 1);
        ssrc[at] = src_base + p[k].x;
        sdl[at] = static_cast<unsigned short>(p[k].y & (kBucketRows - 1));
        sbk[at] = static_cast<unsigned short>(bucket);
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < staged; i += kSortThreads) {
    const long long at = base + delta[sbk[i]] + i;
    tsrc[at] = ssrc[i];
    tdl[at] = sdl[i];
  }
}

// One bucket: its rows' offsets into ends[1 + row], its sources into src in
// row order, staged in shared memory where they fit.
template <typename Idx>
__global__ void __launch_bounds__(kRowThreads)
csr_bucket_rows(const Idx* __restrict__ hist, const int* __restrict__ tsrc,
                const unsigned short* __restrict__ tdl, Idx* __restrict__ ends,
                int* __restrict__ src, Build g) {
  extern __shared__ int smem[];
  int* cnt = smem;                 // kBucketRows
  int* stage = smem + kBucketRows;  // kStageEdges
  __shared__ int warp_tot[kRowThreads / 32];
  const long long q = blockIdx.x;  // b * nb + bucket
  const long long b = q / g.nb, row0 = (q - b * g.nb) * kBucketRows;
  const long long start = first_place(hist, q * g.t1);
  const long long end = first_place(hist, (q + 1) * g.t1);
  const int tid = threadIdx.x;
  for (int i = tid; i < kBucketRows; i += kRowThreads) cnt[i] = 0;
  __syncthreads();
  for (long long j = start + tid; j < end; j += kRowThreads) atomicAdd(&cnt[__ldcs(tdl + j)], 1);
  __syncthreads();
  int c[kRowItems];
  int sum = 0;
#pragma unroll
  for (int k = 0; k < kRowItems; ++k) {
    c[k] = cnt[tid * kRowItems + k];
    sum += c[k];
  }
  int total;
  int run = block_exclusive(sum, warp_tot, &total);
#pragma unroll
  for (int k = 0; k < kRowItems; ++k) {
    cnt[tid * kRowItems + k] = run;  // the row's first place in the bucket
    run += c[k];
  }
  __syncthreads();
  const long long rows = g.n_local - row0 < kBucketRows ? g.n_local - row0 : kBucketRows;
  Idx* first = ends + 1 + b * g.n_local + row0;
  for (int i = tid; i < rows; i += kRowThreads) first[i] = static_cast<Idx>(start + cnt[i]);
  __syncthreads();
  if (end - start <= kStageEdges) {
    for (long long j = start + tid; j < end; j += kRowThreads)
      stage[atomicAdd(&cnt[tdl[j]], 1)] = tsrc[j];
    __syncthreads();
    for (int i = tid; i < total; i += kRowThreads) src[start + i] = stage[i];
  } else {
    for (long long j = start + tid; j < end; j += kRowThreads)
      src[start + atomicAdd(&cnt[tdl[j]], 1)] = tsrc[j];
  }
  if (q == gridDim.x - 1 && tid == 0)
    ends[g.rows + 1] = static_cast<Idx>(first_place(hist, g.hist));
}

// ---- the build by global atomics, for blocks of more buckets than kMaxBuckets

__device__ __forceinline__ void add_one(int* p) { atomicAdd(p, 1); }
__device__ __forceinline__ void add_one(long long* p) {
  atomicAdd(reinterpret_cast<unsigned long long*>(p), 1ull);
}
// the new value of *p after taking one from it
__device__ __forceinline__ int take_one(int* p) { return atomicSub(p, 1) - 1; }
__device__ __forceinline__ long long take_one(long long* p) {
  return static_cast<long long>(
             atomicAdd(reinterpret_cast<unsigned long long*>(p), ~0ull)) - 1;
}

// ends[1 + b * n_local + dst] += 1 for every valid slot of every block.
template <typename Idx>
__global__ void __launch_bounds__(kBuildThreads)
csr_count(const int2* __restrict__ packed, Idx* __restrict__ ends, Build g) {
  const long long b = blockIdx.x / g.tiles;
  const long long first = (blockIdx.x - b * g.tiles) * kBuildTile + threadIdx.x;
  const int2* slots = packed + b * g.cap;
  Idx* row = ends + 1 + b * g.n_local;
  int2 p[kBuildSlots];
#pragma unroll
  for (int k = 0; k < kBuildSlots; ++k) {
    const long long j = first + k * kBuildThreads;
    p[k] = j < g.cap ? __ldcs(slots + j) : make_int2(-1, -1);
  }
#pragma unroll
  for (int k = 0; k < kBuildSlots; ++k)
    if (p[k].x >= 0) add_one(row + p[k].y);
}

// Each valid slot's source into its row: ends[1 + r] holds the row's end on
// entry and its first edge on return.
template <typename Idx>
__global__ void __launch_bounds__(kBuildThreads)
csr_place(const int2* __restrict__ packed, Idx* __restrict__ ends, int* __restrict__ src,
          Build g) {
  const long long b = blockIdx.x / g.tiles;
  const long long first = (blockIdx.x - b * g.tiles) * kBuildTile + threadIdx.x;
  const int2* slots = packed + b * g.cap;
  Idx* row = ends + 1 + b * g.n_local;
  const int base = static_cast<int>((b / g.e) * g.n_local);  // the source shard's first vertex
  int2 p[kBuildSlots];
#pragma unroll
  for (int k = 0; k < kBuildSlots; ++k) {
    const long long j = first + k * kBuildThreads;
    p[k] = j < g.cap ? __ldcs(slots + j) : make_int2(-1, -1);
  }
#pragma unroll
  for (int k = 0; k < kBuildSlots; ++k)
    if (p[k].x >= 0) src[take_one(row + p[k].y)] = base + p[k].x;
}

// coords[t] = (rows done, edges done) at path step min(t * kTile, rows +
// edges), t in [0, tiles]: the split where the path's steps before it hold
// exactly the row ends a[i] = offsets[i + 1] with a[i] <= edges done.
template <typename Idx>
__global__ void __launch_bounds__(kThreads)
csr_partition(const Idx* __restrict__ offsets, Idx* __restrict__ coords, long long rows,
              long long tiles) {
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t > tiles) return;
  const long long edges = offsets[rows];
  const long long path = rows + edges;
  const long long diag = t * kTile < path ? t * kTile : path;
  long long lo = diag > edges ? diag - edges : 0;
  long long hi = diag < rows ? diag : rows;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (static_cast<long long>(offsets[mid + 1]) <= diag - mid - 1)
      lo = mid + 1;
    else
      hi = mid;
  }
  coords[2 * t] = static_cast<Idx>(lo);
  coords[2 * t + 1] = static_cast<Idx>(diag - lo);
}

template <typename Idx>
__global__ void __launch_bounds__(kThreads, kPullBlocksPerSM)
csr_pull(const float* __restrict__ outc, const Idx* __restrict__ offsets,
         const int* __restrict__ src, const Idx* __restrict__ coords,
         float* __restrict__ y, float* __restrict__ carry, long long rows) {
  __shared__ float vals[kTile];  // the tile's edges' out-contributions
  __shared__ int ends[kTile + 1];  // the tile's rows' ends, from its first edge
  __shared__ float out[kTile];  // the tile's finished rows
  __shared__ float warp_sum[kWarps];
  __shared__ int warp_flag[kWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long t = blockIdx.x;
  const Idx r0 = coords[2 * t], n0 = coords[2 * t + 1];
  const Idx r1 = coords[2 * t + 2], n1 = coords[2 * t + 3];
  const int nrows = static_cast<int>(r1 - r0), nnz = static_cast<int>(n1 - n0);
  const int steps = nrows + nnz;
  if (steps == 0) return;  // past the path's end

  int s[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int i = k * kThreads + tid;
    s[k] = i < nnz ? __ldcs(src + n0 + i) : -1;
  }
#pragma unroll
  for (int k = 0; k < kItems; ++k)
    if (s[k] >= 0) vals[k * kThreads + tid] = __ldg(outc + s[k]);
  // row i's end, counted from n0 and clamped to nnz: the row still open at
  // the tile's end (i = nrows) may end far past it, or be none (r1 = rows)
  for (int i = tid; i <= nrows; i += kThreads) {
    const long long r = static_cast<long long>(r0) + i;
    const long long end = r < rows ? static_cast<long long>(__ldcs(offsets + r + 1)) - n0 : nnz;
    ends[i] = end < nnz ? static_cast<int>(end) : nnz;
  }
  __syncthreads();

  // this thread's steps [diag, stop) of the tile's path
  const int diag = tid * kItems < steps ? tid * kItems : steps;
  const int stop = diag + kItems < steps ? diag + kItems : steps;
  int lo = diag > nnz ? diag - nnz : 0;
  int hi = diag < nrows ? diag : nrows;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (ends[mid] <= diag - mid - 1)
      lo = mid + 1;
    else
      hi = mid;
  }
  int row = lo, nz = diag - lo;
  float acc = 0.f, first_sum = 0.f;
  int first_row = -1;  // the first row this thread finishes
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    if (diag + k < stop) {
      if (nz < ends[row]) {
        acc += vals[nz];
        ++nz;
      } else {
        if (first_row < 0) {
          first_row = row;
          first_sum = acc;
        } else {
          out[row] = acc;
        }
        acc = 0.f;
        ++row;
      }
    }
  }

  // segmented inclusive scan over the threads of (flag, acc): a thread
  // that finished a row starts a new segment
  float v = acc;
  int f = first_row >= 0;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float pv = __shfl_up_sync(kFull, v, o);
    const int pf = __shfl_up_sync(kFull, f, o);
    if (lane >= o) {
      if (!f) v += pv;
      f |= pf;
    }
  }
  if (lane == 31) {
    warp_sum[warp] = v;
    warp_flag[warp] = f;
  }
  __syncthreads();
  float before = 0.f;  // the scan over the warps before this one
  for (int w = 0; w < warp; ++w) before = warp_flag[w] ? warp_sum[w] : before + warp_sum[w];
  const float incl = f ? v : before + v;
  float excl = __shfl_up_sync(kFull, incl, 1);
  if (lane == 0) excl = before;
  if (first_row >= 0) out[first_row] = first_sum + excl;
  if (tid == kThreads - 1 && r1 < rows) carry[t] = incl;
  __syncthreads();
  float* dst = y + r0;
  for (int i = tid; i < nrows; i += kThreads) dst[i] = out[i];
}

// y[row open at tile t's end] += carry[t]
template <typename Idx>
__global__ void __launch_bounds__(kThreads)
csr_carry(const Idx* __restrict__ coords, const float* __restrict__ carry,
          float* __restrict__ y, long long rows, long long tiles) {
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= tiles) return;
  const Idx r = coords[2 * t + 2];  // below rows only where tile t held steps
  if (r < rows) {
    const float c = carry[t];
    if (c != 0.f) atomicAdd(y + r, c);
  }
}

unsigned blocks_for(long long n, int threads) {
  return static_cast<unsigned>((n + threads - 1) / threads);
}

bool check_blocks(long long e, long long cap, long long n_local) {
  return e >= 1 && cap >= 1 && n_local >= 1 && e * n_local <= (1ll << 31) &&
         cap < (1ll << 31) && (e * e * cap + kBuildTile - 1) / kBuildTile < (1ll << 31) &&
         e * e * ((n_local + kBucketRows - 1) / kBucketRows) < (1ll << 31);
}

long long align16(long long bytes) { return (bytes + 15) / 16 * 16; }

// Scratch layout: the bucketed build's hist, the scan's chunk sums, tsrc,
// tdl; the other build's chunk sums alone.
struct Scratch {
  long long hist, part, tsrc, tdl, bytes;  // byte offsets and the size
};

Scratch scratch_of(const Build& g, long long idx_bytes) {
  Scratch s;
  const long long n = bucketed(g) ? g.hist : g.rows;
  s.hist = 0;
  s.part = bucketed(g) ? align16(g.hist * idx_bytes) : 0;
  s.tsrc = align16(s.part + (n + kScanChunk - 1) / kScanChunk * idx_bytes);
  const long long slots = bucketed(g) ? g.e * g.e * g.cap : 0;
  s.tdl = align16(s.tsrc + slots * 4);
  s.bytes = align16(s.tdl + slots * 2);
  return s;
}

template <typename Idx>
int build(const void* packed, void* ends, void* src, void* coords, void* scratch,
          long long e, long long cap, long long n_local, long long tiles, cudaStream_t st) {
  const Build g = build_of(e, cap, n_local);
  const Scratch s = scratch_of(g, sizeof(Idx));
  char* base = static_cast<char*>(scratch);
  const int2* slots = static_cast<const int2*>(packed);
  Idx* a = static_cast<Idx*>(ends);
  Idx* part = reinterpret_cast<Idx*>(base + s.part);
  int* out = static_cast<int*>(src);
  cudaError_t err;
  if (bucketed(g)) {
    Idx* hist = reinterpret_cast<Idx*>(base + s.hist);
    int* tsrc = reinterpret_cast<int*>(base + s.tsrc);
    unsigned short* tdl = reinterpret_cast<unsigned short*>(base + s.tdl);
    static PerDevice place_raised, rows_raised;
    if ((err = raise_smem_limit(csr_bucket_place<Idx>, static_cast<int>(place_smem(kMaxBuckets)),
                                place_raised)) != cudaSuccess ||
        (err = raise_smem_limit(csr_bucket_rows<Idx>, kRowsSmem, rows_raised)) != cudaSuccess)
      return static_cast<int>(err);
    const unsigned sorts = static_cast<unsigned>(e * e * g.t1);
    csr_bucket_count<Idx><<<sorts, kSortThreads, 0, st>>>(slots, hist, g);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    if ((err = scan(hist, part, g.hist, st)) != cudaSuccess) return static_cast<int>(err);
    csr_bucket_place<Idx><<<sorts, kSortThreads, place_smem(g.nb), st>>>(
        slots, hist, tsrc, tdl, g);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    csr_bucket_rows<Idx><<<static_cast<unsigned>(e * e * g.nb), kRowThreads, kRowsSmem, st>>>(
        hist, tsrc, tdl, a, out, g);
  } else {
    if ((err = cudaMemsetAsync(a, 0, (g.rows + 2) * sizeof(Idx), st)) != cudaSuccess)
      return static_cast<int>(err);
    const unsigned grid = static_cast<unsigned>(e * e * g.tiles);
    csr_count<Idx><<<grid, kBuildThreads, 0, st>>>(slots, a, g);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    if ((err = scan(a + 1, part, g.rows, st)) != cudaSuccess) return static_cast<int>(err);
    // offsets[rows] = the edge count, the last row's end, before the
    // placement takes that end down to the row's first edge
    err = cudaMemcpyAsync(a + g.rows + 1, a + g.rows, sizeof(Idx), cudaMemcpyDeviceToDevice, st);
    if (err != cudaSuccess) return static_cast<int>(err);
    csr_place<Idx><<<grid, kBuildThreads, 0, st>>>(slots, a, out, g);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  csr_partition<Idx><<<blocks_for(tiles + 1, kThreads), kThreads, 0, st>>>(
      a + 1, static_cast<Idx*>(coords), g.rows, tiles);
  return static_cast<int>(cudaGetLastError());
}

template <typename Idx>
int pull(const void* outc, const void* offsets, const void* src, const void* coords,
         void* carry, void* y, long long rows, long long tiles, cudaStream_t st) {
  const Idx* c = static_cast<const Idx*>(coords);
  csr_pull<Idx><<<static_cast<unsigned>(tiles), kThreads, 0, st>>>(
      static_cast<const float*>(outc), static_cast<const Idx*>(offsets),
      static_cast<const int*>(src), c, static_cast<float*>(y), static_cast<float*>(carry),
      rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  csr_carry<Idx><<<blocks_for(tiles, kThreads), kThreads, 0, st>>>(
      c, static_cast<const float*>(carry), static_cast<float*>(y), rows, tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Path steps a tile of csr_pull: the merge-path coordinates come one a
// tile, ceil((rows + slots) / tile) tiles and one more.
long long srt_csr_tile_steps() { return kTile; }

// Bytes of scratch that srt_csr_build takes (-1: shapes it refuses).
long long srt_csr_scratch_bytes(long long e, long long cap, long long n_local, long long wide) {
  if (!check_blocks(e, cap, n_local)) return -1;
  return scratch_of(build_of(e, cap, n_local), wide ? 8 : 4).bytes;
}

// The CSR of packed ([e*e, cap] int2, int32 pairs, -1 padding): ends, rows
// + 2 indices (rows = e*e*n_local; int64 if wide else int32), of which ends
// + 1 are the offsets; src, e*e*cap int32, the first offsets[rows] written;
// coords, (tiles + 1) * 2 indices, the pull's split; scratch,
// srt_csr_scratch_bytes. Returns a cudaError_t code.
int srt_csr_build(const void* packed, void* ends, void* src, void* coords, void* scratch,
                  long long e, long long cap, long long n_local, long long tiles,
                  long long wide, void* stream) {
  if (!check_blocks(e, cap, n_local) || tiles < 1 || tiles >= (1ll << 31) - 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return wide ? build<long long>(packed, ends, src, coords, scratch, e, cap, n_local, tiles, st)
              : build<int>(packed, ends, src, coords, scratch, e, cap, n_local, tiles, st);
}

// y[r] = sum of outc[src[j]] over j in [offsets[r], offsets[r + 1]) for
// every r < rows (offsets = the build's ends + 1, coords its split); carry:
// tiles floats of scratch.
int srt_csr_pull(const void* outc, const void* offsets, const void* src, const void* coords,
                 void* carry, void* y, long long rows, long long tiles, long long wide,
                 void* stream) {
  if (rows < 1 || tiles < 1 || tiles >= (1ll << 31) - 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return wide ? pull<long long>(outc, offsets, src, coords, carry, y, rows, tiles, st)
              : pull<int>(outc, offsets, src, coords, carry, y, rows, tiles, st);
}

const char* srt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
