// neighbor_pull.cu — the mesh rotation of the exchange plane, for sm_90a.
//
// Replaces the Pallas TPU kernel _neighbor_pull_program of the JAX
// package (sparkrdma_tpu/ops/remote_copy.py): every device starts one
// one-sided remote DMA of its shard toward its left neighbour, so device
// i ends up holding device (i+1) mod n's shard — lax.ppermute by one hop,
// done as RDMA. The ring exchange schedule is E-1 such hops.
//
// What it computes: `table` holds n (src, dst) device address pairs, one
// per shard, and dst[i] receives the shard_bytes bytes at src[(i+1) mod n].
// n = 1 is a copy. In the single-GPU mesh the shards are rows of one
// stack on one card; another card's memory is read the same way once it
// is peer-mapped (the multi-GPU slice), so the table is per shard and not
// a base pointer and a stride. Sources and destinations never overlap
// (the wrapper guarantees it): read in place, the rotation would
// overwrite src[i+1] before it is read.
//
// What bounds it: device memory bandwidth. It reads every source byte
// once and writes every destination byte once, and does no arithmetic.
// The design keeps enough 16-byte loads and stores in flight:
//   - one flat grid over (shard, 64 KiB chunk of the shard), so a few
//     large shards still spread over every SM;
//   - 16-byte vector loads and stores where source and destination share
//     their alignment modulo 16 (every row when both stacks are 16-byte
//     aligned and shard_bytes % 16 == 0); a byte loop covers the head up
//     to the destination's 16-byte boundary and the ragged tail;
//   - a source misaligned against its destination is read bytewise and
//     still stored as 16-byte vectors.
// On the TPU each copy completes on its send and receive DMA semaphores;
// here the launch completes on the caller's stream, which also orders the
// ring's hops one after another.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

struct ShardPair {
  unsigned long long src;  // device address of shard i's source
  unsigned long long dst;  // device address of shard i's destination
};

constexpr int kThreads = 256;
constexpr unsigned long long kChunk = 64ull << 10;

__global__ void __launch_bounds__(kThreads)
neighbor_pull_kernel(const ShardPair* __restrict__ table, unsigned long long n,
                     unsigned long long shard_bytes, unsigned long long chunks) {
  const unsigned long long bid = blockIdx.x;
  const unsigned long long shard = bid / chunks;
  const unsigned long long lo = (bid % chunks) * kChunk;
  const unsigned long long hi = min(lo + kChunk, shard_bytes);
  const unsigned long long right = shard + 1 == n ? 0 : shard + 1;
  uint8_t* __restrict__ d = reinterpret_cast<uint8_t*>(table[shard].dst);
  const uint8_t* __restrict__ s = reinterpret_cast<const uint8_t*>(table[right].src);

  // bytes up to the destination's next 16-byte boundary
  const unsigned long long head =
      min(hi, lo + ((16 - (reinterpret_cast<uintptr_t>(d + lo) & 15)) & 15));
  for (unsigned long long i = lo + threadIdx.x; i < head; i += kThreads) d[i] = s[i];
  const unsigned long long vend = head + ((hi - head) & ~15ull);
  if ((reinterpret_cast<uintptr_t>(s + head) & 15) == 0) {
#pragma unroll 4
    for (unsigned long long i = head + 16ull * threadIdx.x; i < vend; i += 16ull * kThreads) {
      *reinterpret_cast<uint4*>(d + i) = __ldg(reinterpret_cast<const uint4*>(s + i));
    }
  } else {
    for (unsigned long long i = head + 16ull * threadIdx.x; i < vend; i += 16ull * kThreads) {
      uint4 v;
      uint8_t* b = reinterpret_cast<uint8_t*>(&v);
#pragma unroll
      for (int k = 0; k < 16; ++k) b[k] = __ldg(s + i + k);
      *reinterpret_cast<uint4*>(d + i) = v;
    }
  }
  for (unsigned long long i = vend + threadIdx.x; i < hi; i += kThreads) d[i] = s[i];
}

}  // namespace

extern "C" {

// One rotation: `table` holds n ShardPairs in device memory; dst[i] <-
// src[(i + 1) % n], shard_bytes bytes each. Returns a cudaError_t code.
int srt_neighbor_pull(const void* table, long long n, long long shard_bytes,
                      void* stream) {
  if (n < 0 || shard_bytes < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0 || shard_bytes == 0) return 0;
  const unsigned long long sb = static_cast<unsigned long long>(shard_bytes);
  const unsigned long long chunks = (sb + kChunk - 1) / kChunk;
  const unsigned long long blocks = chunks * static_cast<unsigned long long>(n);
  if (blocks > 0x7fffffffull) return static_cast<int>(cudaErrorInvalidConfiguration);
  neighbor_pull_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const ShardPair*>(table), static_cast<unsigned long long>(n), sb,
      chunks);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
