// wave_pull.cu — the batched wave pull of the device fetch plane, for sm_90a.
//
// Replaces two Pallas TPU kernels of the JAX package, sparkrdma_tpu/ops/
// remote_copy.py:
//   srt_wave_pull            <- _wave_pull_program (one epoch of `rows`
//                               remote DMAs, all started, then all waited)
//   srt_pipelined_wave_pull  <- _pipelined_wave_pull_program (`depth`
//                               same-class waves, wave d+1 started before
//                               wave d is waited)
//
// What both compute: row i of a [rows, bucket_bytes] destination receives
// `nbytes` bytes read at `src + src_byte_offset`, and the rest of the row
// is zero; a pad row (nbytes 0) is all zeros. The row table holds one
// RowDesc per destination row, wave-major for the pipelined form, and lives
// in device memory. In this single-GPU slice a source is another
// executor's arena slab on the same card; peer memory of another card is
// read the same way once it is mapped (the multi-GPU slice).
//
// What bounds it: device memory bandwidth. The kernel reads the payload
// bytes once and writes every destination byte once (payload plus zero
// tail); it does no arithmetic. The design therefore only has to keep
// enough 16-byte loads and stores in flight:
//   - one flat grid over (row, 64 KiB chunk of the row), so a wave of a
//     few large rows still spreads over every SM, and the blocks of wave
//     0 come first in the grid for the pipelined form;
//   - 16-byte vector loads and stores when the destination rows are
//     16-byte aligned and the source is too; a misaligned source (an
//     arbitrary arena offset) is read bytewise and still stored as
//     16-byte vectors; a byte loop covers the ragged head and tail;
//   - the zero tail is written with vector stores, never read.
// On the TPU all rows of an entry complete on their DMA semaphores; here
// the whole launch completes on one CUDA event the caller records behind
// it. Both entry points launch the same kernel: the pipelined form is
// `depth` waves laid out in one grid, all in flight at once.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

struct RowDesc {
  unsigned long long src;     // device address of the source slab
  unsigned long long offset;  // byte offset of the payload in the slab
  unsigned long long nbytes;  // payload bytes; <= bucket_bytes
};

constexpr int kThreads = 256;
constexpr unsigned long long kChunk = 64ull << 10;

__device__ __forceinline__ void copy_bytes(uint8_t* __restrict__ d,
                                           const uint8_t* __restrict__ s,
                                           unsigned long long lo,
                                           unsigned long long hi) {
  for (unsigned long long i = lo + threadIdx.x; i < hi; i += kThreads) d[i] = s[i];
}

__device__ __forceinline__ void zero_bytes(uint8_t* __restrict__ d,
                                           unsigned long long lo,
                                           unsigned long long hi) {
  for (unsigned long long i = lo + threadIdx.x; i < hi; i += kThreads) d[i] = 0;
}

__global__ void __launch_bounds__(kThreads)
wave_pull_kernel(const RowDesc* __restrict__ table, uint8_t* __restrict__ dst,
                 unsigned long long bucket_bytes, unsigned long long chunks_per_row,
                 int dst_vec) {
  const unsigned long long bid = blockIdx.x;
  const unsigned long long row = bid / chunks_per_row;
  const unsigned long long lo = (bid % chunks_per_row) * kChunk;
  const unsigned long long hi = min(lo + kChunk, bucket_bytes);
  const RowDesc desc = table[row];
  uint8_t* __restrict__ d = dst + row * bucket_bytes;
  const uint8_t* __restrict__ s =
      reinterpret_cast<const uint8_t*>(desc.src) + desc.offset;
  // this chunk copies [lo, mid) and zero-fills [mid, hi)
  const unsigned long long mid = desc.nbytes <= lo ? lo : min(desc.nbytes, hi);

  if (!dst_vec) {  // rows not 16-byte aligned: plain byte loops
    copy_bytes(d, s, lo, mid);
    zero_bytes(d, mid, hi);
    return;
  }
  // lo and hi are multiples of 16 here (bucket_bytes % 16 == 0)
  const unsigned long long vmid = lo + ((mid - lo) & ~15ull);
  if ((reinterpret_cast<uintptr_t>(s) & 15) == 0) {
#pragma unroll 4
    for (unsigned long long i = lo + 16ull * threadIdx.x; i < vmid; i += 16ull * kThreads) {
      *reinterpret_cast<uint4*>(d + i) = __ldg(reinterpret_cast<const uint4*>(s + i));
    }
  } else {
    for (unsigned long long i = lo + 16ull * threadIdx.x; i < vmid; i += 16ull * kThreads) {
      uint4 v;
      uint8_t* b = reinterpret_cast<uint8_t*>(&v);
#pragma unroll
      for (int k = 0; k < 16; ++k) b[k] = __ldg(s + i + k);
      *reinterpret_cast<uint4*>(d + i) = v;
    }
  }
  copy_bytes(d, s, vmid, mid);
  // zero fill: bytes up to the next 16-byte boundary, then vectors
  const unsigned long long zvec = min((mid + 15) & ~15ull, hi);
  zero_bytes(d, mid, zvec);
  const uint4 z = make_uint4(0, 0, 0, 0);
  for (unsigned long long i = zvec + 16ull * threadIdx.x; i < hi; i += 16ull * kThreads) {
    *reinterpret_cast<uint4*>(d + i) = z;
  }
}

int launch(const void* table, void* dst, long long rows, long long bucket_bytes,
           void* stream) {
  if (rows <= 0 || bucket_bytes <= 0) return 0;
  const unsigned long long bb = static_cast<unsigned long long>(bucket_bytes);
  const unsigned long long chunks = (bb + kChunk - 1) / kChunk;
  const unsigned long long blocks = chunks * static_cast<unsigned long long>(rows);
  if (blocks > 0x7fffffffull) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int dst_vec = (bb % 16 == 0) && (reinterpret_cast<uintptr_t>(dst) % 16 == 0);
  wave_pull_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const RowDesc*>(table), static_cast<uint8_t*>(dst), bb, chunks, dst_vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// One wave: `table` holds rows_b RowDescs; dst is [rows_b, bucket_bytes].
int srt_wave_pull(const void* table, void* dst, long long rows_b,
                  long long bucket_bytes, void* stream) {
  return launch(table, dst, rows_b, bucket_bytes, stream);
}

// `depth` same-class waves: `table` holds depth * rows_b RowDescs,
// wave-major; dst is [depth, rows_b, bucket_bytes].
int srt_pipelined_wave_pull(const void* table, void* dst, long long depth,
                            long long rows_b, long long bucket_bytes, void* stream) {
  return launch(table, dst, depth * rows_b, bucket_bytes, stream);
}

const char* srt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
