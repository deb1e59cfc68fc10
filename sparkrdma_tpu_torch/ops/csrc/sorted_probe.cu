// sorted_probe.cu — the hash join's probe of its sorted build side, for sm_90a.
//
// Replaces no TPU kernel: the JAX join's search (sparkrdma_tpu/models/
// hashjoin.py) is plain jnp, a searchsorted of every probe slot in the
// whole padded build row, a gather of the keys found, a compare, a gather
// of the payloads and a where. On this card that form is a binary search
// of 22-25 dependent loads a slot, padding slots included, and then five
// more passes over the probe slab in device memory (int32 positions, their
// int64 copy, the gathered keys, the mask, the gathered payloads). This
// file is one pass instead.
//
// Two row widths, one template (K the keys' unsigned type, V the
// payloads'):
//   srt_sorted_probe:   uint32 keys (as their int32 bits), int32 payloads;
//   srt_sorted_probe64: uint64 keys (as their int64 bits), int64 payloads.
// Keys compare as unsigned values of their width.
//
// What it computes, for each shard d of an [e, m] stack of build rows
// (bkeys ascending, bvals beside them), an [e, e * cap_p] probe stack and
// counts pcnt [e, e] (slot j of source s valid when j < pcnt[d, s]):
//   joined[d, slot] = bvals[d, pos] if the slot is valid and
//                     bkeys[d, pos] == its key, else miss,
//   where pos = min(lower_bound(bkeys[d], key), m - 1),
// byte for byte the plain composition (ops/sort.py probe_sorted_reference)
// when no more than n_d = sum of bcnt[d] (each below 0 taken as 0, the sum
// at most m) keys of the row lie below the key type's maximum: then the
// row's slots from n_d on hold the maximum, and the lower bound in the
// whole row is the lower bound in its first n_d slots. That is the row
// hashjoin.build_sort leaves: the padding masked to the maximum, sorted.
//
// What bounds it: the bytes it must move, and the random loads. At the
// join cell's shape (4-byte rows, [8, 8, 4,000,000] probe slots into rows
// of 32,000,000, each shard's valid 16,000,000) the probe needs 2.56 GB:
// the valid probe keys read once (0.51 GB), the build side read once (1.02
// GB) and joined written (1.02 GB), 0.76 ms at 3.35 TB/s. At the wide
// cell's (8-byte rows, [8, 8, 2^23] slots into rows of 2^22) it needs 6.7
// GB, 2.0 ms. A binary search in the whole row is a chain of 22-25
// dependent loads whose lower levels miss the 50 MB L2. Two launches on
// the caller's stream, nothing read back to the host:
//   1. probe_directory: a directory of 2^bits bucket starts a shard, bits
//      from m (4 slots of the row a bucket: 2-4 valid keys at the join's
//      capacity factor of 2). Its block 0 of a shard writes the shard's
//      span, its first and last valid keys, and zeroes its counters. Entry
//      j is the lower bound of the key lo + (j << shift), where shift sizes
//      the span to the directory, so uniform keys fill the buckets evenly
//      under any partitioning and skewed keys only make some buckets
//      longer. Each entry is its own binary search of the shard's valid
//      keys, the entries spread over the threads, so that the directory
//      costs the same whatever the keys' skew (a warp's 32 adjacent
//      entries share their searches' upper levels); an empty shard writes
//      none, since no search reads it.
//   2. probe_search: one block a tile of probe slots of one shard,
//      shard-major, so that one shard's build side is hot in L2 at a time
//      (the wide cell's 32 MB of valid keys and payloads a shard fits). A
//      slot past its count writes miss and reads nothing. A valid slot
//      reads its key (coalesced, evict-first), two adjacent directory
//      entries (one sector), and binary-searches that bucket alone, within
//      a sector or two; keys outside the span resolve to 0 or n_d without a
//      search and read the key at that bound. The search keeps the last key
//      it found at or above the probe's, which is the key at the bound, so
//      only a match reads more: its payload (one sector). joined is written
//      coalesced, evict-first. A thread keeps 4 probes in flight (3 at
//      8-byte rows), each step of their searches issued together, and the
//      search blocks are held to 64 registers a thread (48), so that an SM
//      keeps 4,096 (3,840) probes in flight. Each block adds its valid
//      probes and its search steps into the shard's counters, one atomic a
//      block a field.
// The scratch (the spans and the directories) comes from the caller; the
// kernels allocate nothing.
//
// Measured on an H100 (700 W) at the two cells' probes, uniform keys, the
// C entry point alone: a first version with buckets of 16 slots, 8 probes
// a thread and no register cap took 15.16 and 16.80 ms. Its 74-130
// registers left one or two blocks an SM. Capping the registers, buckets
// of 4 slots (2.6 and 2.1 search steps a probe, not 4.2 and 3.4) and
// keeping the key found took it to 11.5-11.8 and 12.9-13.3 ms. Of those,
// reading and writing the slab alone takes 1.4 and 2.7 ms, and the
// payload reads 3.8 and 4.4 ms; what is left is the directory and bucket
// loads, near the rate at which L2 answers random sector requests. Slower
// at both shapes: buckets of 2 or 8 slots, (start, end) directory pairs
// read as one 8-byte load, a linear scan of each bucket's first 4 or 8
// keys, 2, 6, 8 or 16 probes a thread, 128 or 512 threads a block. Within
// 4% either way, and slower at one of the two shapes: a scan of the first
// 2 keys, and plain or L2-only (__ldcg) loads in place of the evict-first
// and __ldg ones.
//
// The directory: a search an entry takes 0.70 and 0.18 ms at the two
// shapes with uniform keys, 0.47 and 0.12 with every key but two in one
// bucket, and 0.002 with every shard empty. Filled key by key, each
// thread writing the entries of the gap below its key, it took 0.46 and
// 0.08 ms with uniform keys, but 12.2 and 3.0 ms with one bucket and 16.0
// and 3.9 ms with empty shards (one thread writing millions of entries).
// A merge of the keys with the buckets' first keys, each thread walking 8
// to 64 merged items from a search along its diagonal, took 1.2-4.6 and
// 0.20-0.59 ms with uniform keys.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kDirBlocks = 1024;       // directory blocks, all shards together
constexpr int kSlotsPerBucketLog = 2;  // 4 slots of a build row a bucket
constexpr long long kSpanBytes = 32;   // a shard's span in the scratch

// The probes a search thread keeps in flight, and the search blocks an SM
// (which caps a thread's registers: 64 at 4-byte rows, 48 at 8-byte rows).
template <typename K>
struct Tune;
template <>
struct Tune<unsigned> {
  static constexpr int kItems = 4, kBlocks = 4;
};
template <>
struct Tune<unsigned long long> {
  static constexpr int kItems = 3, kBlocks = 5;
};

template <typename K>
struct Span {
  K lo;       // the first of the shard's n valid keys
  K hi;       // the last
  int n;      // sum of the shard's build counts
  int shift;  // a key's bucket: (key - lo) >> shift
};
static_assert(sizeof(Span<unsigned long long>) <= kSpanBytes, "a span outgrows its slot");

template <typename K, typename V>
struct Args {
  const K* bkeys;   // [e, m], each row ascending
  const V* bvals;   // [e, m]
  const int* bcnt;  // [e, e]
  const K* pkeys;   // [e, e * cap_p]
  const int* pcnt;  // [e, e]
  V* joined;        // [e, e * cap_p]
  unsigned long long* stats;  // [e, 2]: valid probes, search steps
  Span<K>* spans;   // [e]
  int* dir;         // [e, (1 << bits) + 1]
  long long e, m, cap_p;
  int bits;         // log2 of the buckets a shard
  V miss;
};

template <typename K>
__device__ __forceinline__ int bit_length(K x) {
  if (sizeof(K) == 8) return x ? 64 - __clzll(static_cast<long long>(x)) : 0;
  return x ? 32 - __clz(static_cast<int>(x)) : 0;
}

template <typename K, typename V>
__global__ void __launch_bounds__(kThreads)
probe_directory(Args<K, V> a) {
  __shared__ Span<K> span;
  const long long d = blockIdx.y;
  const K* row = a.bkeys + d * a.m;
  if (threadIdx.x == 0) {
    long long n = 0;
    for (long long s = 0; s < a.e; ++s) {
      const int c = a.bcnt[d * a.e + s];
      n += c > 0 ? c : 0;
    }
    Span<K> sp;
    sp.n = static_cast<int>(n < a.m ? n : a.m);
    sp.lo = sp.n ? row[0] : K(0);
    sp.hi = sp.n ? row[sp.n - 1] : K(0);
    const int width = bit_length<K>(sp.hi - sp.lo);
    sp.shift = width > a.bits ? width - a.bits : 0;  // at most the width less 1
    span = sp;
    if (blockIdx.x == 0) {
      a.spans[d] = sp;
      a.stats[2 * d] = a.stats[2 * d + 1] = 0;
    }
  }
  __syncthreads();
  const Span<K> sp = span;
  if (sp.n == 0) return;
  const long long buckets = 1ll << a.bits;
  int* dir = a.dir + d * (buckets + 1);
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long j = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; j <= buckets;
       j += stride) {
    // the lower bound of lo + (j << shift), which fits in K for j below
    // 2^bits; past hi it is n
    const K off = static_cast<K>(j) << sp.shift;
    int lo = sp.n, hi = sp.n;
    if (j < buckets && off <= sp.hi - sp.lo) {
      const K target = sp.lo + off;
      lo = 0;
      while (lo < hi) {
        const int mid = static_cast<int>((static_cast<unsigned>(lo) + hi) >> 1);
        if (__ldg(row + mid) < target) lo = mid + 1;
        else hi = mid;
      }
    }
    dir[j] = lo;
  }
}

template <typename K, typename V>
__global__ void __launch_bounds__(kThreads, Tune<K>::kBlocks)
probe_search(Args<K, V> a) {
  constexpr int kItems = Tune<K>::kItems;
  const long long d = blockIdx.y;
  const Span<K> sp = a.spans[d];
  const long long slots = a.e * a.cap_p;
  const int* dir = a.dir + d * ((1ll << a.bits) + 1);
  const int* pcnt = a.pcnt + d * a.e;
  const K* bkeys = a.bkeys + d * a.m;
  const K* pkeys = a.pkeys + d * slots;
  const long long first = static_cast<long long>(blockIdx.x) * kThreads * kItems + threadIdx.x;

  K key[kItems];
  bool valid[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const long long slot = first + k * kThreads;
    valid[k] = false;
    if (slot < slots) {
      // slots < 2^31: the source in 32 bits
      const unsigned src = static_cast<unsigned>(slot) / static_cast<unsigned>(a.cap_p);
      valid[k] = slot - static_cast<long long>(src) * a.cap_p < __ldg(pcnt + src);
    }
    key[k] = valid[k] ? __ldcs(pkeys + slot) : K(0);
  }
  // [lo, hi): the bucket of a key inside the span; a key outside it
  // resolves to 0 or n at once
  int lo[kItems], hi[kItems];
  bool inside[kItems];
  unsigned probes = 0, steps = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    lo[k] = hi[k] = 0;
    inside[k] = false;
    if (!valid[k]) continue;
    ++probes;
    if (sp.n == 0 || key[k] < sp.lo) continue;  // below every key: 0
    if (key[k] > sp.hi) {                        // above every valid key: n
      lo[k] = hi[k] = sp.n;
      continue;
    }
    inside[k] = true;
    const long long j = static_cast<long long>((key[k] - sp.lo) >> sp.shift);
    // clamped into [0, n], so that no directory can send a load astray
    const int b0 = __ldg(dir + j), b1 = __ldg(dir + j + 1);
    lo[k] = b0 < 0 ? 0 : (b0 > sp.n ? sp.n : b0);
    hi[k] = b1 < lo[k] ? lo[k] : (b1 > sp.n ? sp.n : b1);
  }
  // the lower bound in [lo, hi), every probe's step issued together; the
  // last key found at or above the probe's is the one at the bound. A
  // search that finds none ends at the next bucket's first key or at n,
  // both above the probe's key: a miss, with nothing more to read
  K found[kItems];
  bool seen[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) seen[k] = false;
  for (;;) {
    K v[kItems];
#pragma unroll
    for (int k = 0; k < kItems; ++k)
      if (lo[k] < hi[k])
        v[k] = __ldg(bkeys + ((static_cast<unsigned>(lo[k]) + hi[k]) >> 1));
    bool more = false;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      if (lo[k] < hi[k]) {
        const int mid = static_cast<int>((static_cast<unsigned>(lo[k]) + hi[k]) >> 1);
        if (v[k] < key[k]) {
          lo[k] = mid + 1;
        } else {
          hi[k] = mid;
          found[k] = v[k];
          seen[k] = true;
        }
        ++steps;
        more |= lo[k] < hi[k];
      }
    }
    if (!more) break;
  }
  // a key outside the span reads the key at its clamped bound
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    if (valid[k] && !inside[k]) {
      if (lo[k] == a.m) lo[k] = static_cast<int>(a.m - 1);  // the clamp: a full row
      found[k] = __ldg(bkeys + lo[k]);
      seen[k] = true;
    }
  }
  const V* bvals = a.bvals + d * a.m;
  V* joined = a.joined + d * slots;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const long long slot = first + k * kThreads;
    const V out = valid[k] && seen[k] && found[k] == key[k] ? __ldg(bvals + lo[k]) : a.miss;
    if (slot < slots) __stcs(joined + slot, out);
  }

  __shared__ unsigned sums[2][kWarps];
  const unsigned p = __reduce_add_sync(0xffffffffu, probes);
  const unsigned s = __reduce_add_sync(0xffffffffu, steps);
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    sums[0][warp] = p;
    sums[1][warp] = s;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long tp = 0, ts = 0;
    for (int w = 0; w < kWarps; ++w) {
      tp += sums[0][w];
      ts += sums[1][w];
    }
    atomicAdd(a.stats + 2 * d, tp);
    atomicAdd(a.stats + 2 * d + 1, ts);
  }
}

// log2 of a shard's buckets for build rows of m slots
int bits_of(long long m) {
  int lg = 0;
  while ((2ll << lg) <= m) ++lg;  // floor(log2(m))
  return lg - kSlotsPerBucketLog > 1 ? lg - kSlotsPerBucketLog : 1;
}

template <typename K, typename V>
int sorted_probe(const void* bkeys, const void* bvals, const void* bcnt, const void* pkeys,
                 const void* pcnt, void* joined, void* stats, void* scratch, long long e,
                 long long m, long long cap_p, long long miss, void* stream) {
  if (e < 1 || e > 65535 || m < 1 || m > 0x7fffffffll || cap_p < 1 ||
      e * cap_p > 0x7fffffffll)
    return static_cast<int>(cudaErrorInvalidValue);
  Args<K, V> a;
  a.bkeys = static_cast<const K*>(bkeys);
  a.bvals = static_cast<const V*>(bvals);
  a.bcnt = static_cast<const int*>(bcnt);
  a.pkeys = static_cast<const K*>(pkeys);
  a.pcnt = static_cast<const int*>(pcnt);
  a.joined = static_cast<V*>(joined);
  a.stats = static_cast<unsigned long long*>(stats);
  a.spans = static_cast<Span<K>*>(scratch);
  a.dir = reinterpret_cast<int*>(static_cast<char*>(scratch) + e * kSpanBytes);
  a.e = e;
  a.m = m;
  a.cap_p = cap_p;
  a.bits = bits_of(m);
  a.miss = static_cast<V>(miss);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long per_shard = kDirBlocks / e > 0 ? kDirBlocks / e : 1;
  const long long needed = ((1ll << a.bits) + kThreads) / kThreads;  // 2^bits + 1 entries
  const unsigned ue = static_cast<unsigned>(e);
  probe_directory<K, V><<<dim3(static_cast<unsigned>(needed < per_shard ? needed : per_shard),
                               ue), kThreads, 0, st>>>(a);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tile = kThreads * Tune<K>::kItems;
  const long long tiles = (e * cap_p + tile - 1) / tile;
  probe_search<K, V><<<dim3(static_cast<unsigned>(tiles), ue), kThreads, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// int32 elements of the scratch that srt_sorted_probe and
// srt_sorted_probe64 take for e build rows of m slots: each shard's span
// (32 bytes) and its directory of 2^bits + 1 bucket starts.
long long srt_sorted_probe_scratch(long long e, long long m) {
  return e * (kSpanBytes / 4) + e * ((1ll << bits_of(m)) + 1);
}

// bkeys: [e, m] int32 (the uint32 keys' bits), each row ascending as
// uint32 with at most sum(bcnt[d]) keys below 0xFFFFFFFF; bvals: [e, m]
// int32; bcnt: [e, e] int32; pkeys: [e, e * cap_p] int32 (uint32 bits);
// pcnt: [e, e] int32; joined: [e, e * cap_p] int32; stats: [e, 2] int64,
// overwritten with each shard's valid probes and bucket search steps;
// scratch: srt_sorted_probe_scratch(e, m) int32. e in [1, 65535],
// m in [1, 2^31), cap_p >= 1, e * cap_p < 2^31; miss as an int32 value.
// Returns a cudaError_t code.
int srt_sorted_probe(const void* bkeys, const void* bvals, const void* bcnt,
                     const void* pkeys, const void* pcnt, void* joined, void* stats,
                     void* scratch, long long e, long long m, long long cap_p, long long miss,
                     void* stream) {
  return sorted_probe<unsigned, int>(bkeys, bvals, bcnt, pkeys, pcnt, joined, stats, scratch,
                                     e, m, cap_p, miss, stream);
}

// srt_sorted_probe at 8-byte rows: bkeys, pkeys int64 (the uint64 keys'
// bits, ascending as uint64 with at most sum(bcnt[d]) keys below 2^64 - 1);
// bvals, joined int64; miss as an int64 value. Everything else as
// srt_sorted_probe.
int srt_sorted_probe64(const void* bkeys, const void* bvals, const void* bcnt,
                       const void* pkeys, const void* pcnt, void* joined, void* stats,
                       void* scratch, long long e, long long m, long long cap_p,
                       long long miss, void* stream) {
  return sorted_probe<unsigned long long, long long>(bkeys, bvals, bcnt, pkeys, pcnt, joined,
                                                     stats, scratch, e, m, cap_p, miss,
                                                     stream);
}

const char* srt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
