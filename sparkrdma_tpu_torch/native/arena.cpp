// Native off-heap arena for sparkrdma_tpu.
//
// TPU-native replacement for the reference's below-the-VM memory pokes:
// sun.misc.Unsafe.allocateMemory/copyMemory/freeMemory (reference:
// RdmaBuffer.java:41-53, 101-112) and the raw-address DirectByteBuffer
// constructor (RdmaBuffer.java:114-136). Provides page-aligned
// allocations outside the Python heap, addressable by id, with a
// process-wide allocation-statistics view (the RdmaBufferManager
// stop-time stats analogue, RdmaBufferManager.java:131-141).
//
// Exposed to Python via ctypes (no pybind11 in this environment).

#include <atomic>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <unordered_map>

namespace {

struct Allocation {
  void* ptr;
  uint64_t size;
};

struct Arena {
  std::mutex mu;
  std::unordered_map<uint64_t, Allocation> allocs;
  std::atomic<uint64_t> next_id{1};
  std::atomic<uint64_t> live_bytes{0};
  std::atomic<uint64_t> total_allocs{0};
};

constexpr size_t kPageSize = 4096;

}  // namespace

extern "C" {

void* srt_arena_create() { return new Arena(); }

void srt_arena_destroy(void* arena_ptr) {
  Arena* a = static_cast<Arena*>(arena_ptr);
  {
    std::lock_guard<std::mutex> lock(a->mu);
    for (auto& kv : a->allocs) std::free(kv.second.ptr);
    a->allocs.clear();
  }
  delete a;
}

// Returns the allocation id, or 0 on failure. Address retrieved via srt_addr.
uint64_t srt_alloc(void* arena_ptr, uint64_t size) {
  Arena* a = static_cast<Arena*>(arena_ptr);
  void* ptr = nullptr;
  size_t padded = (size + kPageSize - 1) & ~(kPageSize - 1);
  if (posix_memalign(&ptr, kPageSize, padded) != 0) return 0;
  uint64_t id = a->next_id.fetch_add(1);
  {
    std::lock_guard<std::mutex> lock(a->mu);
    a->allocs[id] = {ptr, size};
  }
  a->live_bytes.fetch_add(size);
  a->total_allocs.fetch_add(1);
  return id;
}

void* srt_addr(void* arena_ptr, uint64_t id) {
  Arena* a = static_cast<Arena*>(arena_ptr);
  std::lock_guard<std::mutex> lock(a->mu);
  auto it = a->allocs.find(id);
  return it == a->allocs.end() ? nullptr : it->second.ptr;
}

uint64_t srt_size(void* arena_ptr, uint64_t id) {
  Arena* a = static_cast<Arena*>(arena_ptr);
  std::lock_guard<std::mutex> lock(a->mu);
  auto it = a->allocs.find(id);
  return it == a->allocs.end() ? 0 : it->second.size;
}

int srt_free(void* arena_ptr, uint64_t id) {
  Arena* a = static_cast<Arena*>(arena_ptr);
  Allocation alloc{nullptr, 0};
  {
    std::lock_guard<std::mutex> lock(a->mu);
    auto it = a->allocs.find(id);
    if (it == a->allocs.end()) return -1;
    alloc = it->second;
    a->allocs.erase(it);
  }
  std::free(alloc.ptr);
  a->live_bytes.fetch_sub(alloc.size);
  return 0;
}

void srt_copy(void* dst, const void* src, uint64_t n) { std::memcpy(dst, src, n); }

void srt_arena_stats(void* arena_ptr, uint64_t* total_allocs, uint64_t* live_bytes,
                     uint64_t* live_count) {
  Arena* a = static_cast<Arena*>(arena_ptr);
  *total_allocs = a->total_allocs.load();
  *live_bytes = a->live_bytes.load();
  std::lock_guard<std::mutex> lock(a->mu);
  *live_count = a->allocs.size();
}

}  // extern "C"
