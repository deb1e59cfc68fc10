// srt transport — the native data plane of the sparkrdma_tpu host path.
//
// Role: the libdisni/DiSNI equivalent of the reference (SURVEY.md §2.2).
// The reference is inoperable without a native verbs layer doing the
// actual per-byte work (ibv_post_send / ibv_poll_cq / connection
// management); this library is that layer for the TPU framework's host
// transport: a per-process endpoint ("node") with
//
//   - a region registry (the ProtectionDomain): mkey -> (ptr, len),
//     served under a mutex (IbvPd.regMr analogue, RdmaBuffer.java:81-88),
//   - an epoll event loop thread owning every socket: accepts, frame
//     parsing, passive one-sided READ service straight out of the
//     registry — application code never runs per served byte
//     (IBV_WR_RDMA_READ service, RdmaChannel.java:360-393),
//   - a completion queue the host language polls (ibv_poll_cq analogue):
//     SEND_DONE / READ_DONE / RECV / ACCEPT / CHANNEL_DOWN,
//   - one-sided READ: bytes stream directly into the caller-provided
//     destination buffer as they arrive, no staging copy.
//
// Wire format: byte-identical to sparkrdma_tpu/transport/wire.py (all
// big-endian), so native and pure-Python nodes interoperate:
//   SEND      = op(1) payload_len(4) payload
//   READ_REQ  = op(1) req_id(8) n(4) then n x [mkey(4) addr(8) len(4)]
//   READ_RESP = op(1) req_id(8) total_len(8) payload
//   READ_ERR  = op(1) req_id(8) msg_len(4) msg
//   HELLO     = op(1) port(4) id_len(2) executor_id
//   GOODBYE   = op(1)
//
// Threading: all public calls are thread-safe. Mutations of socket/epoll
// state are shipped to the loop thread via an eventfd-signalled command
// queue; the registry and completion queue have their own locks.

#include <arpa/inet.h>
#include <errno.h>
#include <fcntl.h>
#include <netdb.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <signal.h>
#include <stdint.h>
#include <stdio.h>
#include <string.h>
#include <sys/epoll.h>
#include <sys/eventfd.h>
#include <sys/mman.h>
#include <sys/sendfile.h>
#include <sys/socket.h>
#include <sys/stat.h>
#include <sys/types.h>
#include <sys/uio.h>
#include <limits.h>
#include <unistd.h>

#include <algorithm>
#include <array>
#include <atomic>
#include <memory>
#include <chrono>
#include <condition_variable>
#include <deque>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

// io_uring backend: raw syscalls against <linux/io_uring.h> so no
// liburing dependency is ever required. Compiled out when the uapi
// header is missing or SRT_NO_IOURING is defined (the CI no-liburing
// matrix leg); availability on the RUNNING kernel is a separate
// runtime probe that latches ENOSYS/EPERM into a pread fallback.
#if defined(__linux__) && !defined(SRT_NO_IOURING) && \
    __has_include(<linux/io_uring.h>)
#define SRT_HAVE_IOURING 1
#include <linux/io_uring.h>
#include <sys/syscall.h>
#endif

namespace {

// A pthread_cond_timedwait that TIMES OUT corrupts this toolchain's
// TSan lock model (gcc-10 libtsan + glibc 2.31): the interceptor loses
// the waiter's internal release/reacquire, and from then on every
// operation on that mutex reports phantom double-locks and data races
// (reproduced with a 30-line provably-correct producer/consumer — the
// phantoms track cv.wait_for timeouts exactly and vanish with untimed
// waits). Under TSan, emulate the timed predicate wait with short
// untimed sleeps taken OUTSIDE the lock: identical semantics, wake
// latency bounded by the slice, and the instrumented build stays
// phantom-free so real races fail the CI job loudly.
template <class Pred>
bool cv_wait_ms(std::condition_variable& cv, std::unique_lock<std::mutex>& lk,
                int64_t timeout_ms, Pred pred) {
#if defined(__SANITIZE_THREAD__)
  (void)cv;
  auto deadline = std::chrono::steady_clock::now() +
                  std::chrono::milliseconds(timeout_ms);
  while (!pred()) {
    if (std::chrono::steady_clock::now() >= deadline) return pred();
    lk.unlock();
    std::this_thread::sleep_for(std::chrono::milliseconds(1));
    lk.lock();
  }
  return true;
#else
  return cv.wait_for(lk, std::chrono::milliseconds(timeout_ms), pred);
#endif
}

constexpr uint8_t OP_SEND = 1;
constexpr uint8_t OP_READ_REQ = 2;
constexpr uint8_t OP_READ_RESP = 3;
constexpr uint8_t OP_READ_ERR = 4;
constexpr uint8_t OP_HELLO = 5;
constexpr uint8_t OP_GOODBYE = 6;
// READ_REQ2: same layout as READ_REQ but announces the requester can
// read the server's files directly (same-host fast path). The server
// may answer READ_FILE instead of streaming READ_RESP when every block
// resolves to a file-backed region. The READ_FILE body leads with the
// server's host-proof path (an unguessable /dev/shm name); a client
// that cannot stat it is on another host and falls back to streaming,
// so colliding file paths across hosts can never serve wrong bytes.
// Wire v2 ops: both planes in this repo accept REQ2 (the Python plane
// streams); there is no cross-version negotiation with older binaries.
//   READ_REQ2 = op(1) req_id(8) n(4) then n x [mkey(4) addr(8) len(4)]
//   READ_FILE = op(1) req_id(8) body_len(4) body
//     body    = proof_len(2) proof_path n(4)
//               then n x [file_off(8) dev(8) ino(8) size(8) mtime_ns(8)
//                         plen(2) path]
// dev/ino/size/mtime_ns are the backing file's identity captured at
// REGISTRATION: the client checks them against fstat of the fd it
// opens, so a shuffle file unlinked and rewritten at the same path (a
// task re-attempt) between the READ_FILE answer and the pread can
// never serve the new file's bytes — identity mismatch falls back to
// streaming. dev+ino alone is NOT enough: ext4/tmpfs recycle inode
// numbers immediately, so a same-size rewrite can land on the same
// (dev, ino); the ns-resolution mtime (stable because shuffle files
// are immutable once committed and registered) breaks the tie.
constexpr uint8_t OP_READ_REQ2 = 9;
constexpr uint8_t OP_READ_FILE = 10;

constexpr uint32_t COMP_SEND_DONE = 1;
constexpr uint32_t COMP_READ_DONE = 2;
constexpr uint32_t COMP_RECV = 3;
constexpr uint32_t COMP_CHANNEL_DOWN = 4;
constexpr uint32_t COMP_ACCEPT = 5;

constexpr uint32_t ST_OK = 0;
constexpr uint32_t ST_ERR = 1;
constexpr uint32_t ST_REMOTE_ERR = 2;

inline uint16_t load_be16(const uint8_t* p) {
  return (uint16_t(p[0]) << 8) | uint16_t(p[1]);
}
inline uint32_t load_be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}
inline uint64_t load_be64(const uint8_t* p) {
  return (uint64_t(load_be32(p)) << 32) | load_be32(p + 4);
}
inline void store_be32(uint8_t* p, uint32_t v) {
  p[0] = v >> 24; p[1] = v >> 16; p[2] = v >> 8; p[3] = v;
}
inline void store_be64(uint8_t* p, uint64_t v) {
  store_be32(p, v >> 32);
  store_be32(p + 4, (uint32_t)v);
}

struct Completion {
  uint32_t kind;
  uint32_t status;
  uint64_t channel;
  uint64_t wr_id;
  void* payload;        // RECV: data; ACCEPT: executor-id string (not NUL-terminated)
  uint64_t payload_len;
  uint32_t aux;         // ACCEPT: peer listen port
};

struct OutBuf {
  std::vector<uint8_t> data;
  size_t pos = 0;
  uint64_t wr_id = 0;    // nonzero: emit SEND_DONE when fully written
  bool last_of_wr = false;
  // zero-copy payload: when ext != nullptr the bytes are sent straight
  // from the registered region (pinned under pin_mkey) — the NIC-DMA
  // analogue of serving an RDMA READ without touching the data
  const uint8_t* ext = nullptr;
  uint64_t ext_len = 0;
  uint32_t pin_mkey = 0;
  // kernel-side zero-copy: when sf_fd >= 0 the bytes leave via
  // sendfile(socket <- backing file) — ZERO userspace copies on the
  // serving side (vs one for ext, two for data). ext stays set as the
  // memory fallback at the same pos when sendfile errors. The fd is
  // owned by this OutBuf (closed on completion or conn failure).
  int sf_fd = -1;
  uint64_t sf_off = 0;
};

struct PendingRead {
  uint64_t wr_id;
  uint8_t* dst;
  uint64_t expected;
  uint64_t received = 0;
  // original request blocks: kept for the same-host file path (per-
  // block pread placement) and for re-posting a plain READ_REQ when a
  // READ_FILE answer turns out not to be readable from here
  std::vector<std::array<uint64_t, 3>> blocks;
  // mapped delivery (srt_post_read_mapped): no caller dst — same-host
  // blocks come back as mmap records (completion aux=1), streamed
  // fallback lands in `owned` (malloc'd here, ownership passes to the
  // completion payload, aux=0)
  bool mapped = false;
  uint8_t* owned = nullptr;
};

// incremental frame-parser states
enum class RxState {
  OP,
  SEND_HDR, SEND_BODY,
  READQ_HDR, READQ_BLOCKS,
  READR_HDR, READR_BODY, READR_DRAIN,
  READE_HDR, READE_BODY,
  READF_HDR, READF_BODY,
  HELLO_HDR, HELLO_BODY,
};

struct Conn {
  int fd = -1;
  uint64_t id = 0;
  bool hello_done = false;       // inbound conns announce themselves first
  bool outbound = false;
  bool down = false;
  // loopback peers skip the sendfile serve path: measured on this rig,
  // loopback sendfile moves ~18% SLOWER than a userspace send (the
  // kernel page-pinning dance buys nothing without a DMA-capable NIC);
  // real remote peers get sendfile's zero-copy. Node::force_sendfile
  // overrides for tests/benches of the mechanism itself.
  bool peer_loopback = false;
  std::deque<OutBuf> outq;
  bool want_write = false;

  RxState st = RxState::OP;
  uint8_t hdr[16];
  size_t hdr_need = 0, hdr_got = 0;
  std::vector<uint8_t> body;
  size_t body_need = 0, body_got = 0;
  uint64_t cur_req = 0;
  uint64_t drain_left = 0;
  bool cur_req2 = false;            // server: READ_REQ2 (file-capable peer)
  PendingRead* cur_read = nullptr;  // owned by reads map

  std::unordered_map<uint64_t, PendingRead> reads;  // req_id -> pending

  // same-host fast-path state (client side): -1 unknown, 0 proven not
  // same-host (proof stat failed — permanent for this conn), 1 proven.
  // Transient file errors do NOT latch 0; they just stream that read.
  int files_ok = -1;
};

struct Command {
  enum Kind {
    ADD_CONN, SEND, READ, CLOSE_CONN, EVICT_MKEY,
    FILE_DONE, FILE_FALLBACK, STOP
  } kind;
  uint64_t channel = 0;
  int fd = -1;
  bool outbound = false;
  std::vector<uint8_t> data;
  uint64_t wr_id = 0;
  bool last_of_wr = false;
  // READ only: pending-read registration shipped to the loop thread,
  // which solely owns Conn::reads (no cross-thread map access)
  uint64_t req_id = 0;
  uint8_t* dst = nullptr;
  uint64_t expected = 0;
  std::vector<std::array<uint64_t, 3>> blocks;
  bool mapped = false;  // READ: mapped delivery requested
};

// one advertised backing file: path + offset + the registration-time
// identity the client must see when it opens the path
struct FileRef {
  std::string path;
  uint64_t off = 0;
  uint64_t dev = 0;
  uint64_t ino = 0;
  uint64_t size = 0;
  uint64_t mtime_ns = 0;
};

inline uint64_t stat_mtime_ns(const struct stat& st) {
  return (uint64_t)st.st_mtim.tv_sec * 1000000000ull +
         (uint64_t)st.st_mtim.tv_nsec;
}

inline bool stat_matches(const struct stat& st, uint64_t dev, uint64_t ino,
                         uint64_t size, uint64_t mtime_ns) {
  if ((uint64_t)st.st_dev != dev || (uint64_t)st.st_ino != ino) return false;
  // size==0 && mtime_ns==0 marks a MUTABLE backing (an shm slab whose
  // pages ARE the region memory: pread always returns current region
  // content, and its unguessable O_EXCL name makes a same-path rewrite
  // impossible) — dev/ino identity is sufficient there. Immutable
  // backings (committed shuffle files) carry the full identity because
  // ext4/tmpfs recycle inode numbers immediately on unlink+create.
  if (size == 0 && mtime_ns == 0) return true;
  return (uint64_t)st.st_size == size && stat_mtime_ns(st) == mtime_ns;
}

// one same-host pread job, executed on the file worker thread so a
// cold-cache disk read can never head-of-line block the epoll loop
// shared completion state for a SPLIT file task: a multi-block pread
// task fans out over the worker pool (the WR-list-striping analogue);
// the LAST part to finish posts the single FILE_DONE / FILE_FALLBACK,
// so no part can still be writing into dst when a fallback re-streams
struct TaskGroup {
  std::atomic<int> remaining{0};
  std::atomic<bool> failed{false};
};

struct FileTask {
  uint64_t channel = 0;
  uint64_t req_id = 0;
  uint8_t* dst = nullptr;
  std::vector<uint64_t> lens;
  std::vector<FileRef> files;
  bool mapped = false;           // mmap instead of pread
  std::vector<uint8_t> records;  // mapped result: n x 32B (ptr,len,base,maplen)
  std::shared_ptr<TaskGroup> group;  // non-null: one part of a split task
};

// one resolved read descriptor: a contiguous run of one validated file
// (fd already identity-checked) landing in a contiguous destination.
// `lens` keeps the block boundaries inside the run so the preadv2
// scatter backend can submit them as iovecs; io_uring submits the run
// as one SQE (the destination is contiguous across the run anyway).
struct ReadSqe {
  int fd = -1;
  uint64_t off = 0;
  uint8_t* dst = nullptr;
  std::vector<uint64_t> lens;
  uint64_t total = 0;
};

// read-backend knob values (mirrors tpu.shuffle.native.readBackend)
enum { RB_AUTO = 0, RB_IOURING = 1, RB_PREAD = 2, RB_MAPPED = 3 };

// SubmissionPlane: the single seam every same-host file read goes
// through. The loop thread enqueues logical read requests via
// plane_submit (which owns the striping/splitting policy that used to
// live inline in the READF_BODY frame handler); file workers drain
// them via plane_execute, which resolves blocks into ReadSqe runs and
// hands the runs to ONE of the interchangeable backends:
//
//   backend      submit path                    degradation
//   io_uring     batched SQEs, READ_FIXED when  ENOSYS/EPERM/old kernel
//                dst is inside a registered     -> pread (latched once,
//                segment snapshot               backend_fallbacks++);
//                                               short/failed CQE ->
//                                               per-run pread
//   pread        preadv2 scatter per run        ENOSYS -> pread loop
//   mapped-copy  mmap(MAP_POPULATE)+memcpy      mmap failure -> pread
//
// Mapped DELIVERY (records handed to the consumer in place, aux=1
// completions) is a completion mode, not a backend: plane_execute
// routes it internally, so no caller ever branches on
// pread-vs-mapped-vs-scatter.
//
// Fixed buffers: srt_reg/srt_reg_file record writable registered
// segments here; each worker's ring snapshots the list ONCE at ring
// creation and registers it via IORING_REGISTER_BUFFERS. Deregistering
// a recorded segment bumps seg_dead_gen, which disables READ_FIXED on
// every ring built against an older snapshot (plain IORING_OP_READ
// still flows) — a freed slab can never be written through a stale
// buf_index.
struct SubmissionPlane {
  std::atomic<int> backend{RB_AUTO};
  // io_uring availability: 0 unknown, 1 available, -1 unavailable
  // (probe failed), -2 forced unavailable (test seam)
  std::atomic<int> uring_state{0};
  std::atomic<int> force_probe_fail{0};
  // observable submission-queue accounting (transport.sq.* families)
  std::atomic<uint64_t> sq_submits{0};
  std::atomic<uint64_t> sq_batches{0};
  std::atomic<uint64_t> sq_depth_hwm{0};
  std::atomic<uint64_t> sq_completions{0};
  std::atomic<uint64_t> sq_backend_fallbacks{0};
  // fixed-buffer candidates: registered segments whose memory is
  // writable for the process lifetime of the rings built on them
  std::mutex seg_mu;
  std::vector<std::pair<uint64_t, uint64_t>> segs;
  std::atomic<uint64_t> seg_dead_gen{0};

  void add_segment(const void* ptr, uint64_t len) {
    if (!ptr || !len) return;
    std::lock_guard<std::mutex> g(seg_mu);
    // IORING_REGISTER_BUFFERS caps the iovec table at 1024 entries
    if (segs.size() >= 1024) return;
    segs.emplace_back((uint64_t)ptr, len);
  }
  void remove_segment(const void* ptr) {
    std::lock_guard<std::mutex> g(seg_mu);
    for (auto it = segs.begin(); it != segs.end(); ++it) {
      if (it->first == (uint64_t)ptr) {
        segs.erase(it);
        seg_dead_gen.fetch_add(1, std::memory_order_release);
        return;
      }
    }
  }
  void note_depth(uint64_t d) {
    uint64_t cur = sq_depth_hwm.load(std::memory_order_relaxed);
    while (d > cur && !sq_depth_hwm.compare_exchange_weak(cur, d)) {
    }
  }
};

struct Node {
  int listen_fd = -1;
  int epfd = -1;
  int evfd = -1;
  uint16_t port = 0;
  std::thread loop;
  std::atomic<bool> stopping{false};
  // host-identity proof for the same-host file fast path: an
  // unguessably-named empty file in /dev/shm. Its path rides in every
  // READ_FILE answer; a client that can stat it shares this host's
  // filesystem, so advertised backing-file paths are meaningful. This
  // is what prevents a deterministic shuffle-file path (same layout on
  // every host) from being opened on the WRONG host and silently
  // serving that host's bytes.
  std::string host_proof;

  struct Region {
    const uint8_t* ptr = nullptr;
    uint64_t len = 0;
    // pins: queued zero-copy sends referencing this memory. Dereg of a
    // pinned region BLOCKS until its last queued byte is flushed (the
    // MR-invalidation-ordering guarantee the reference gets from verbs:
    // memory may be reclaimed by the caller as soon as dereg returns)
    uint32_t pins = 0;
    bool dereg_wanted = false;
    // file backing (shm slab or mapped shuffle file): lets a same-host
    // peer pread the bytes straight from page cache instead of
    // streaming them through the socket
    std::string path;
    uint64_t file_off = 0;
    bool file_backed = false;
    // backing-file identity at registration time (READ_FILE wire doc)
    uint64_t file_dev = 0;
    uint64_t file_ino = 0;
    uint64_t file_size = 0;
    uint64_t file_mtime_ns = 0;
  };
  std::mutex reg_mu;
  std::condition_variable reg_cv;
  std::unordered_map<uint32_t, Region> regions;
  uint32_t next_mkey = 1;

  // client-side read-path accounting: how many READs completed via the
  // same-host pread fast path vs the streamed socket path (observable
  // from Python for tests and the bench harness)
  std::atomic<uint64_t> stat_file_reads{0};
  std::atomic<uint64_t> stat_streamed_reads{0};
  // sub-ranges created by striping a single large block's pread across
  // the worker pool (observable: tests assert the stripe engaged)
  std::atomic<uint64_t> stat_block_stripes{0};
  // parts created by splitting multi-block pread tasks (observable so
  // tests can assert the split actually engaged)
  std::atomic<uint64_t> stat_split_parts{0};
  // client knob: 0 forces plain READ_REQ (streamed) even when the peer
  // could answer READ_FILE — used to exercise/bench the remote path on
  // a single host. Mapped reads always probe the file path.
  std::atomic<int> file_fastpath{1};
  // server knob: serve file-backed regions via sendfile even to
  // loopback peers (tests/benches of the mechanism; see Conn comment)
  std::atomic<int> force_sendfile{0};

  std::mutex cq_mu;
  std::condition_variable cq_cv;
  std::deque<Completion> cq;

  std::mutex cmd_mu;
  std::deque<Command> cmds;

  std::mutex conn_mu;  // guards id->Conn* map (loop thread owns Conn bodies)
  std::unordered_map<uint64_t, Conn*> conns;
  uint64_t next_conn = 1;
  std::vector<Conn*> graveyard;  // loop-thread-only: dead conns awaiting free

  // file worker: executes same-host preads off the epoll loop.
  // file_pending is loop-thread-only: a PendingRead parks here while
  // its task is with the worker, so a dying Conn cannot free it
  // mid-pread and the destination keepalive stays owned until a
  // completion is posted.
  // Striped: several workers drain the task queue concurrently. On
  // rigs with spare kernel-side parallelism (this box: nproc=1 yet
  // 2-thread pread measures ~1.5x one thread) concurrent read groups
  // overlap their page-cache copies — the thread-pool analogue of the
  // reference posting WR lists on multiple QPs (RdmaChannel.java:54-56).
  // The vector itself is guarded by fw_mu (srt_set_file_workers can
  // grow it mid-run); the epoll loop never touches the vector — it
  // reads the atomic count, published AFTER each thread is live.
  std::vector<std::thread> file_workers;
  std::mutex fw_mu;
  std::atomic<size_t> file_worker_count{0};
  std::mutex ft_mu;
  std::condition_variable ft_cv;
  std::deque<FileTask> ftq;
  std::map<std::pair<uint64_t, uint64_t>, PendingRead> file_pending;

  // the read submission plane (backend choice, SQ stats, fixed-buffer
  // segment registry) — see the SubmissionPlane comment
  SubmissionPlane plane;

  void post(Completion c) {
    {
      std::lock_guard<std::mutex> g(cq_mu);
      cq.push_back(c);
    }
    cq_cv.notify_one();
  }
  void wake() {
    uint64_t one = 1;
    ssize_t r = write(evfd, &one, sizeof(one));
    (void)r;
  }
  void enqueue(Command c) {
    {
      std::lock_guard<std::mutex> g(cmd_mu);
      cmds.push_back(std::move(c));
    }
    wake();
  }
};

int set_nonblock(int fd) {
  int fl = fcntl(fd, F_GETFL, 0);
  return fcntl(fd, F_SETFL, fl | O_NONBLOCK);
}

// large socket buffers + no Nagle: the data plane moves 8 MiB READ
// groups; default loopback buffers throttle the pipeline hard
void tune_socket(int fd) {
  int one = 1;
  setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  int sz = 4 << 20;
  setsockopt(fd, SOL_SOCKET, SO_SNDBUF, &sz, sizeof(sz));
  setsockopt(fd, SOL_SOCKET, SO_RCVBUF, &sz, sizeof(sz));
}

// release one zero-copy pin; completes a deferred dereg at pin zero
void unpin_region(Node* n, uint32_t mkey) {
  bool erased = false;
  {
    std::lock_guard<std::mutex> g(n->reg_mu);
    auto it = n->regions.find(mkey);
    if (it == n->regions.end()) return;
    if (it->second.pins > 0) it->second.pins--;
    if (it->second.pins == 0 && it->second.dereg_wanted) {
      n->regions.erase(it);
      erased = true;
    }
  }
  if (erased) n->reg_cv.notify_all();
}

void arm(Node* n, Conn* c) {
  epoll_event ev{};
  ev.events = EPOLLIN | (c->want_write ? EPOLLOUT : 0);
  ev.data.ptr = c;
  epoll_ctl(n->epfd, EPOLL_CTL_MOD, c->fd, &ev);
}

void fail_conn(Node* n, Conn* c) {
  if (c->down) return;
  c->down = true;
  // fail every outstanding one-sided READ on this channel
  for (auto& kv : c->reads) {
    if (kv.second.owned) free(kv.second.owned);  // fallback blob undelivered
    Completion comp{};
    comp.kind = COMP_READ_DONE;
    comp.status = ST_ERR;
    comp.channel = c->id;
    comp.wr_id = kv.second.wr_id;
    n->post(comp);
  }
  c->reads.clear();
  // ...and every queued-but-unflushed send, so no listener is orphaned
  // (the latch invariant of the Python channel, channel.py _latch_error)
  for (auto& ob : c->outq) {
    if (ob.sf_fd >= 0) close(ob.sf_fd);
    if (ob.ext) unpin_region(n, ob.pin_mkey);
    if (ob.wr_id && ob.last_of_wr) {
      Completion comp{};
      comp.kind = COMP_SEND_DONE;
      comp.status = ST_ERR;
      comp.channel = c->id;
      comp.wr_id = ob.wr_id;
      n->post(comp);
    }
  }
  c->outq.clear();
  Completion comp{};
  comp.kind = COMP_CHANNEL_DOWN;
  comp.channel = c->id;
  n->post(comp);
  epoll_ctl(n->epfd, EPOLL_CTL_DEL, c->fd, nullptr);
  close(c->fd);
  c->fd = -1;
  // retire the Conn: out of the id map now (commands will fail cleanly),
  // freed at the next loop iteration so events already fetched in this
  // epoll batch can still look at c->down safely
  {
    std::lock_guard<std::mutex> g(n->conn_mu);
    n->conns.erase(c->id);
  }
  n->graveyard.push_back(c);
}

void queue_out(Node* n, Conn* c, std::vector<uint8_t> data, uint64_t wr_id,
               bool last) {
  if (c->down) {
    if (wr_id && last) {
      Completion comp{};
      comp.kind = COMP_SEND_DONE;
      comp.status = ST_ERR;
      comp.channel = c->id;
      comp.wr_id = wr_id;
      n->post(comp);
    }
    return;
  }
  OutBuf ob;
  ob.data = std::move(data);
  ob.wr_id = wr_id;
  ob.last_of_wr = last;
  c->outq.push_back(std::move(ob));
  if (!c->want_write) {
    c->want_write = true;
    arm(n, c);
  }
}

void flush_out(Node* n, Conn* c) {
  while (!c->outq.empty()) {
    OutBuf& ob = c->outq.front();
    const uint8_t* base = ob.ext ? ob.ext : ob.data.data();
    const size_t size = ob.ext ? (size_t)ob.ext_len : ob.data.size();
    // kernel path first: sendfile moves page-cache pages into the
    // socket with no userspace copy. Any failure (EINVAL on an exotic
    // fs, etc.) degrades to the pinned-memory send at the same pos —
    // the file and the region hold identical bytes by construction.
    while (ob.sf_fd >= 0 && ob.pos < size) {
      off_t off = (off_t)(ob.sf_off + ob.pos);
      ssize_t w = sendfile(c->fd, ob.sf_fd, &off, size - ob.pos);
      if (w > 0) {
        ob.pos += (size_t)w;
      } else if (w < 0 && (errno == EAGAIN || errno == EWOULDBLOCK)) {
        return;  // EPOLLOUT stays armed
      } else {
        close(ob.sf_fd);
        ob.sf_fd = -1;  // degrade to memory send below
      }
    }
    while (ob.pos < size) {
      ssize_t w = send(c->fd, base + ob.pos, size - ob.pos, MSG_NOSIGNAL);
      if (w > 0) {
        ob.pos += (size_t)w;
      } else if (w < 0 && (errno == EAGAIN || errno == EWOULDBLOCK)) {
        return;  // EPOLLOUT stays armed
      } else {
        fail_conn(n, c);
        return;
      }
    }
    if (ob.sf_fd >= 0) close(ob.sf_fd);
    if (ob.ext) unpin_region(n, ob.pin_mkey);
    if (ob.wr_id && ob.last_of_wr) {
      Completion comp{};
      comp.kind = COMP_SEND_DONE;
      comp.status = ST_OK;
      comp.channel = c->id;
      comp.wr_id = ob.wr_id;
      n->post(comp);
    }
    c->outq.pop_front();
  }
  if (c->want_write) {
    c->want_write = false;
    arm(n, c);
  }
}

// serve a one-sided READ_REQ entirely in native code: resolve each
// (mkey, addr, len) block against the registry, pin the regions, and
// queue zero-copy responses sent straight out of registered memory —
// no per-byte application copy, the NIC-DMA analogue. A concurrent
// dereg of a pinned region blocks until its bytes are flushed
// (verbs MR-invalidation ordering, RdmaBuffer.java:81-88).
void serve_read(Node* n, Conn* c, uint64_t req_id,
                const std::vector<std::array<uint64_t, 3>>& blocks) {
  uint64_t total = 0;
  std::vector<std::pair<const uint8_t*, uint64_t>> views;
  // per-block backing file for the sendfile path: (path, abs offset,
  // identity) when the region is file-backed, else empty path
  struct SfRef { std::string path; uint64_t off, dev, ino, size, mtime_ns; };
  std::vector<SfRef> sf;
  {
    std::lock_guard<std::mutex> g(n->reg_mu);
    for (auto& b : blocks) {
      auto it = n->regions.find((uint32_t)b[0]);
      // overflow-safe bounds check: addr+len can wrap in uint64
      if (it == n->regions.end() || it->second.dereg_wanted ||
          b[1] > it->second.len || b[2] > it->second.len - b[1]) {
        std::string msg = "region resolve failed (mkey " +
                          std::to_string(b[0]) + ")";
        std::vector<uint8_t> out(1 + 8 + 4 + msg.size());
        out[0] = OP_READ_ERR;
        store_be64(&out[1], req_id);
        store_be32(&out[9], (uint32_t)msg.size());
        memcpy(&out[13], msg.data(), msg.size());
        queue_out(n, c, std::move(out), 0, false);
        return;
      }
      views.emplace_back(it->second.ptr + b[1], b[2]);
      if (it->second.file_backed) {
        sf.push_back({it->second.path, it->second.file_off + b[1],
                      it->second.file_dev, it->second.file_ino,
                      it->second.file_size, it->second.file_mtime_ns});
      } else {
        sf.push_back({std::string(), 0, 0, 0, 0, 0});
      }
      total += b[2];
    }
    // pin while still under the lock so no dereg can slip between
    // resolution and enqueue
    for (auto& b : blocks) n->regions[(uint32_t)b[0]].pins++;
  }
  std::vector<uint8_t> hdr(1 + 8 + 8);
  hdr[0] = OP_READ_RESP;
  store_be64(&hdr[1], req_id);
  store_be64(&hdr[9], total);
  queue_out(n, c, std::move(hdr), 0, false);
  if (c->down) {
    // queue_out dropped the header; drop the pins too
    for (auto& b : blocks) unpin_region(n, (uint32_t)b[0]);
    return;
  }
  for (size_t i = 0; i < blocks.size(); i++) {
    OutBuf ob;
    ob.ext = views[i].first;
    ob.ext_len = views[i].second;
    ob.pin_mkey = (uint32_t)blocks[i][0];
    if (!sf[i].path.empty() &&
        (!c->peer_loopback || n->force_sendfile.load())) {
      // file-backed region: serve by sendfile (zero userspace copies)
      // when the path still names the registered file; the pinned
      // memory view above remains the in-place fallback either way.
      // Loopback peers keep the userspace send — see Conn::peer_loopback.
      int fd = open(sf[i].path.c_str(), O_RDONLY);
      if (fd >= 0) {
        struct stat fst;
        if (fstat(fd, &fst) == 0 &&
            stat_matches(fst, sf[i].dev, sf[i].ino, sf[i].size,
                         sf[i].mtime_ns)) {
          ob.sf_fd = fd;
          ob.sf_off = sf[i].off;
        } else {
          close(fd);
        }
      }
    }
    c->outq.push_back(std::move(ob));
  }
  if (!c->want_write && !blocks.empty()) {
    c->want_write = true;
    arm(n, c);
  }
  // push what the socket will take right away rather than waiting a
  // poll cycle
  if (!c->down) flush_out(n, c);
}

// READ_REQ2 from a file-capable peer: when every block resolves to a
// file-backed region, answer with (path, offset) metadata instead of
// bytes — the peer preads straight from page cache. Falls back to the
// streaming serve_read otherwise.
void serve_read2(Node* n, Conn* c, uint64_t req_id,
                 const std::vector<std::array<uint64_t, 3>>& blocks) {
  std::vector<FileRef> files;
  if (!n->host_proof.empty()) {
    std::lock_guard<std::mutex> g(n->reg_mu);
    for (auto& b : blocks) {
      auto it = n->regions.find((uint32_t)b[0]);
      if (it == n->regions.end() || it->second.dereg_wanted ||
          b[1] > it->second.len || b[2] > it->second.len - b[1] ||
          !it->second.file_backed) {
        files.clear();
        break;
      }
      files.push_back({it->second.path, it->second.file_off + b[1],
                       it->second.file_dev, it->second.file_ino,
                       it->second.file_size, it->second.file_mtime_ns});
    }
  }
  if (files.empty() || blocks.empty()) {
    serve_read(n, c, req_id, blocks);  // mixed/unbacked/invalid: stream
    return;
  }
  size_t body_len = 2 + n->host_proof.size() + 4;
  for (auto& f : files) body_len += 8 * 5 + 2 + f.path.size();
  if (body_len > (2u << 20)) {
    // the client hard-fails READ_FILE bodies over 4 MiB as malformed;
    // an enormous block count is better served by streaming anyway
    serve_read(n, c, req_id, blocks);
    return;
  }
  std::vector<uint8_t> out(1 + 8 + 4 + body_len);
  out[0] = OP_READ_FILE;
  store_be64(&out[1], req_id);
  store_be32(&out[9], (uint32_t)body_len);
  size_t off = 13;
  out[off] = (uint8_t)(n->host_proof.size() >> 8);
  out[off + 1] = (uint8_t)(n->host_proof.size() & 0xff);
  memcpy(&out[off + 2], n->host_proof.data(), n->host_proof.size());
  off += 2 + n->host_proof.size();
  store_be32(&out[off], (uint32_t)files.size());
  off += 4;
  for (auto& f : files) {
    store_be64(&out[off], f.off);
    store_be64(&out[off + 8], f.dev);
    store_be64(&out[off + 16], f.ino);
    store_be64(&out[off + 24], f.size);
    store_be64(&out[off + 32], f.mtime_ns);
    out[off + 40] = (uint8_t)(f.path.size() >> 8);
    out[off + 41] = (uint8_t)(f.path.size() & 0xff);
    memcpy(&out[off + 42], f.path.data(), f.path.size());
    off += 42 + f.path.size();
  }
  queue_out(n, c, std::move(out), 0, false);
  if (!c->down) flush_out(n, c);
}

// (re)send a READ request frame for an already-registered PendingRead.
// use_file_op selects READ_REQ2 (file-capable) vs plain READ_REQ.
void send_read_frame(Node* n, Conn* c, uint64_t req_id,
                     const std::vector<std::array<uint64_t, 3>>& blocks,
                     bool use_file_op) {
  std::vector<uint8_t> frame(1 + 8 + 4 + blocks.size() * 16);
  frame[0] = use_file_op ? OP_READ_REQ2 : OP_READ_REQ;
  store_be64(&frame[1], req_id);
  store_be32(&frame[9], (uint32_t)blocks.size());
  for (size_t i = 0; i < blocks.size(); i++) {
    uint8_t* b = &frame[13 + i * 16];
    store_be32(b, (uint32_t)blocks[i][0]);
    store_be64(b + 4, blocks[i][1]);
    store_be32(b + 12, (uint32_t)blocks[i][2]);
  }
  queue_out(n, c, std::move(frame), 0, false);
  if (!c->down) flush_out(n, c);
}

// same-host pread execution, on the file worker thread. Every fd —
// cached or freshly opened — is validated against the (dev, ino) the
// server captured at REGISTRATION, so neither a stale cached fd nor a
// shuffle file unlinked and rewritten at the same path (a task
// re-attempt) can serve wrong bytes; mismatch falls back to streaming.
// mapped delivery: mmap each block's file range instead of pread-ing
// it — ZERO copies on the client too; the consumer reads page-cache
// pages in place (the true same-host DMA analogue). Record layout per
// block: user_ptr(8) len(8) map_base(8) map_len(8), all host-endian —
// this never crosses the wire, it goes straight to the local caller.
bool do_file_task_mapped(FileTask& t) {
  size_t page = (size_t)sysconf(_SC_PAGESIZE);
  std::vector<std::array<uint64_t, 4>> maps;
  bool ok = true;
  for (size_t i = 0; i < t.files.size() && ok; i++) {
    const FileRef& f = t.files[i];
    int fd = open(f.path.c_str(), O_RDONLY);
    if (fd < 0) { ok = false; break; }
    struct stat fst;
    if (fstat(fd, &fst) != 0 ||
        !stat_matches(fst, f.dev, f.ino, f.size, f.mtime_ns)) {
      close(fd);
      ok = false;
      break;
    }
    uint64_t aligned = f.off & ~(uint64_t)(page - 1);
    uint64_t delta = f.off - aligned;
    uint64_t map_len = t.lens[i] + delta;
    // MAP_POPULATE prefaults the whole window on the file worker
    // thread: the consumer's first pass then runs at touch speed
    // instead of soft-faulting once per page mid-sum (the measured
    // gap between mapped-consumed and the consume roofline). Kernels
    // or filesystems that refuse populate fall back to plain mmap —
    // correctness is identical, only first-touch cost moves.
    int flags = MAP_SHARED;
#ifdef MAP_POPULATE
    flags |= MAP_POPULATE;
#endif
    void* base = mmap(nullptr, (size_t)map_len, PROT_READ, flags, fd,
                      (off_t)aligned);
#ifdef MAP_POPULATE
    if (base == MAP_FAILED)
      base = mmap(nullptr, (size_t)map_len, PROT_READ, MAP_SHARED, fd,
                  (off_t)aligned);
#endif
    close(fd);  // the mapping keeps the inode alive
    if (base == MAP_FAILED) { ok = false; break; }
    maps.push_back({(uint64_t)base + delta, t.lens[i], (uint64_t)base,
                    map_len});
  }
  if (!ok) {
    for (auto& m : maps) munmap((void*)m[2], (size_t)m[3]);
    return false;
  }
  t.records.resize(maps.size() * 32);
  for (size_t i = 0; i < maps.size(); i++)
    memcpy(t.records.data() + i * 32, maps[i].data(), 32);
  return true;
}

// Reclaim the mappings described by an n x 32B mapped-read record blob
// (user_ptr, len, map_base, map_len per record, host-endian) that will
// never reach its consumer. Dropped queued FILE_DONE commands and
// undelivered aux=1 completions must come through here before their
// blob is freed, else every record's page-cache mmap leaks for the
// process lifetime.
void unmap_mapped_records(const void* recs, size_t len) {
  const uint8_t* p = (const uint8_t*)recs;
  for (size_t off = 0; off + 32 <= len; off += 32) {
    uint64_t base, mlen;
    memcpy(&base, p + off + 16, sizeof(base));
    memcpy(&mlen, p + off + 24, sizeof(mlen));
    if (base) munmap((void*)base, (size_t)mlen);
  }
}

// scatter-read one contiguous file run into a contiguous destination:
// one preadv2 per <=IOV_MAX iovec batch (the block boundaries become
// iovec entries, so a reducer's run of adjacent partition chunks costs
// one syscall instead of one per chunk). ENOSYS — no preadv2 on this
// kernel — and short reads degrade to the plain pread loop; bytes and
// layout are identical either way.
static bool read_run_scatter(int fd, uint64_t off, uint8_t* dst,
                             const uint64_t* lens, size_t n_lens) {
  uint64_t total = 0;
  for (size_t i = 0; i < n_lens; i++) total += lens[i];
  uint64_t got = 0;
#if defined(__linux__) && defined(RWF_NOWAIT)
  static std::atomic<bool> preadv2_ok{true};
  if (preadv2_ok.load(std::memory_order_relaxed) && n_lens > 1) {
    std::vector<struct iovec> iov(n_lens);
    uint64_t o = 0;
    for (size_t i = 0; i < n_lens; i++) {
      iov[i].iov_base = dst + o;
      iov[i].iov_len = (size_t)lens[i];
      o += lens[i];
    }
    size_t first = 0;
    while (got < total) {
      // drop fully-read iovecs, trim the partial head
      while (first < iov.size() && iov[first].iov_len == 0) first++;
      int cnt = (int)std::min((size_t)IOV_MAX, iov.size() - first);
      ssize_t r = preadv2(fd, &iov[first], cnt, (off_t)(off + got), 0);
      if (r < 0 && errno == ENOSYS) {
        preadv2_ok.store(false, std::memory_order_relaxed);
        break;  // pread fallback below finishes the run
      }
      if (r <= 0) break;
      got += (uint64_t)r;
      uint64_t adv = (uint64_t)r;
      for (size_t i = first; i < iov.size() && adv; i++) {
        size_t take = std::min((size_t)adv, iov[i].iov_len);
        iov[i].iov_base = (uint8_t*)iov[i].iov_base + take;
        iov[i].iov_len -= take;
        adv -= take;
      }
    }
  }
#endif
  while (got < total) {
    ssize_t r = pread(fd, dst + got, (size_t)(total - got),
                      (off_t)(off + got));
    if (r <= 0) return false;
    got += (uint64_t)r;
  }
  return true;
}

// resolve a FileTask's (path, identity, off, len) blocks into coalesced
// contiguous runs with validated fds — shared by EVERY backend, so the
// identity checks and the run coalescing can never diverge between
// them. fds stay owned by the worker's fd_cache; descriptors borrow.
static bool resolve_runs(FileTask& t,
                         std::unordered_map<std::string, int>& fd_cache,
                         std::vector<ReadSqe>& out) {
  uint64_t dst_off = 0;
  for (size_t i = 0; i < t.files.size(); i++) {
    uint64_t len = t.lens[i];
    const FileRef& f = t.files[i];
    int fd = -1;
    auto it = fd_cache.find(f.path);
    if (it != fd_cache.end()) {
      struct stat fst;
      if (fstat(it->second, &fst) == 0 &&
          stat_matches(fst, f.dev, f.ino, f.size, f.mtime_ns)) {
        fd = it->second;
      } else {
        close(it->second);  // unlinked/recreated: drop the stale fd
        fd_cache.erase(it);
      }
    }
    if (fd < 0) {
      fd = open(f.path.c_str(), O_RDONLY);
      if (fd < 0) return false;
      struct stat fst;
      if (fstat(fd, &fst) != 0 ||
          !stat_matches(fst, f.dev, f.ino, f.size, f.mtime_ns)) {
        // the path now names a DIFFERENT file than the one registered
        close(fd);
        return false;
      }
      if (fd_cache.size() >= 64) {
        // bound the cache: never pin unlinked tmpfs inodes (and fds)
        // for the process lifetime
        for (auto& kv : fd_cache) close(kv.second);
        fd_cache.clear();
      }
      fd_cache[f.path] = fd;
    }
    // coalesce the contiguous run starting at i — same inode, offsets
    // back-to-back (a reducer's adjacent partition chunks in one spill
    // file) — into one descriptor instead of one per block
    ReadSqe s;
    s.fd = fd;
    s.off = f.off;
    s.dst = t.dst + dst_off;
    s.lens.push_back(len);
    s.total = len;
    size_t j = i + 1;
    while (j < t.files.size() && t.files[j].path == f.path &&
           t.files[j].dev == f.dev && t.files[j].ino == f.ino &&
           t.files[j].off == f.off + s.total) {
      s.lens.push_back(t.lens[j]);
      s.total += t.lens[j];
      j++;
    }
    dst_off += s.total;
    out.push_back(std::move(s));
    i = j - 1;
  }
  return true;
}

// mapped-COPY backend: mmap the run's file window and memcpy into the
// destination — the same page-cache bytes as pread through a different
// kernel path (page-table walk instead of a read syscall per run).
// Distinct from mapped DELIVERY, which hands the mapping itself to the
// consumer. mmap refusal degrades to pread in the caller.
static bool sqe_mapped_copy(const ReadSqe& s) {
  size_t page = (size_t)sysconf(_SC_PAGESIZE);
  uint64_t aligned = s.off & ~(uint64_t)(page - 1);
  uint64_t delta = s.off - aligned;
  size_t map_len = (size_t)(s.total + delta);
  int flags = MAP_SHARED;
#ifdef MAP_POPULATE
  flags |= MAP_POPULATE;
#endif
  void* base = mmap(nullptr, map_len, PROT_READ, flags, s.fd, (off_t)aligned);
#ifdef MAP_POPULATE
  if (base == MAP_FAILED)
    base = mmap(nullptr, map_len, PROT_READ, MAP_SHARED, s.fd, (off_t)aligned);
#endif
  if (base == MAP_FAILED) return false;
  memcpy(s.dst, (const uint8_t*)base + delta, (size_t)s.total);
  munmap(base, map_len);
  return true;
}

#ifdef SRT_HAVE_IOURING
static int sys_io_uring_setup(unsigned entries, struct io_uring_params* p) {
  return (int)syscall(__NR_io_uring_setup, entries, p);
}
static int sys_io_uring_enter(int fd, unsigned to_submit,
                              unsigned min_complete, unsigned flags) {
  return (int)syscall(__NR_io_uring_enter, fd, to_submit, min_complete, flags,
                      nullptr, 0);
}
static int sys_io_uring_register(int fd, unsigned opcode, const void* arg,
                                 unsigned nr_args) {
  return (int)syscall(__NR_io_uring_register, fd, opcode, arg, nr_args);
}

// One ring per file-worker thread: single submitter by construction,
// so no ring locking anywhere. Created lazily on the worker's first
// uring-backed task, torn down when the worker exits. SQPOLL is
// deliberately NOT requested — it needs privileges/5.13+ for unpinned
// use and burns a core busy-polling, which the consume lanes want.
struct UringRing {
  int ring_fd = -1;
  unsigned entries = 0;
  uint8_t* sq_ring = nullptr;
  size_t sq_ring_len = 0;
  uint8_t* cq_ring = nullptr;
  size_t cq_ring_len = 0;
  struct io_uring_sqe* sqes = nullptr;
  size_t sqes_len = 0;
  unsigned* sq_head = nullptr;
  unsigned* sq_tail = nullptr;
  unsigned* sq_mask = nullptr;
  unsigned* sq_array = nullptr;
  unsigned* cq_head = nullptr;
  unsigned* cq_tail = nullptr;
  unsigned* cq_mask = nullptr;
  struct io_uring_cqe* cqes = nullptr;
  // fixed-buffer snapshot: registered ONCE at ring creation; READ_FIXED
  // is used only while plane.seg_dead_gen still matches dead_gen
  bool fixed_ok = false;
  uint64_t dead_gen = 0;
  std::vector<std::pair<uint64_t, uint64_t>> bufs;
  bool ready = false;

  void destroy() {
    if (sqes) munmap(sqes, sqes_len);
    if (cq_ring && cq_ring != sq_ring) munmap(cq_ring, cq_ring_len);
    if (sq_ring) munmap(sq_ring, sq_ring_len);
    if (ring_fd >= 0) close(ring_fd);
    sqes = nullptr;
    cq_ring = nullptr;
    sq_ring = nullptr;
    ring_fd = -1;
    ready = false;
  }
  ~UringRing() { destroy(); }
};

static bool uring_init(UringRing& r, SubmissionPlane& plane) {
  struct io_uring_params p;
  memset(&p, 0, sizeof(p));
  int fd = sys_io_uring_setup(64, &p);
  if (fd < 0) return false;
  r.ring_fd = fd;
  r.entries = p.sq_entries;
  size_t sq_len = p.sq_off.array + p.sq_entries * sizeof(unsigned);
  size_t cq_len = p.cq_off.cqes + p.cq_entries * sizeof(struct io_uring_cqe);
  bool single = (p.features & IORING_FEAT_SINGLE_MMAP) != 0;
  if (single) sq_len = cq_len = std::max(sq_len, cq_len);
  void* sq = mmap(nullptr, sq_len, PROT_READ | PROT_WRITE, MAP_SHARED, fd,
                  IORING_OFF_SQ_RING);
  if (sq == MAP_FAILED) {
    r.destroy();
    return false;
  }
  r.sq_ring = (uint8_t*)sq;
  r.sq_ring_len = sq_len;
  if (single) {
    r.cq_ring = r.sq_ring;
    r.cq_ring_len = sq_len;
  } else {
    void* cq = mmap(nullptr, cq_len, PROT_READ | PROT_WRITE, MAP_SHARED, fd,
                    IORING_OFF_CQ_RING);
    if (cq == MAP_FAILED) {
      r.destroy();
      return false;
    }
    r.cq_ring = (uint8_t*)cq;
    r.cq_ring_len = cq_len;
  }
  r.sqes_len = p.sq_entries * sizeof(struct io_uring_sqe);
  void* se = mmap(nullptr, r.sqes_len, PROT_READ | PROT_WRITE, MAP_SHARED, fd,
                  IORING_OFF_SQES);
  if (se == MAP_FAILED) {
    r.destroy();
    return false;
  }
  r.sqes = (struct io_uring_sqe*)se;
  r.sq_head = (unsigned*)(r.sq_ring + p.sq_off.head);
  r.sq_tail = (unsigned*)(r.sq_ring + p.sq_off.tail);
  r.sq_mask = (unsigned*)(r.sq_ring + p.sq_off.ring_mask);
  r.sq_array = (unsigned*)(r.sq_ring + p.sq_off.array);
  r.cq_head = (unsigned*)(r.cq_ring + p.cq_off.head);
  r.cq_tail = (unsigned*)(r.cq_ring + p.cq_off.tail);
  r.cq_mask = (unsigned*)(r.cq_ring + p.cq_off.ring_mask);
  r.cqes = (struct io_uring_cqe*)(r.cq_ring + p.cq_off.cqes);
  // fixed-buffer registration: ONE snapshot, ONE register call, for
  // the ring's whole lifetime. Registration pins the pages, so a slab
  // deregistered later stays resident until the ring closes — the
  // dead_gen check above only stops NEW READ_FIXED submissions from
  // addressing it. Failure (RLIMIT_MEMLOCK, unmappable segment)
  // degrades to plain IORING_OP_READ; never fatal.
  {
    std::lock_guard<std::mutex> g(plane.seg_mu);
    r.bufs = plane.segs;
  }
  r.dead_gen = plane.seg_dead_gen.load(std::memory_order_acquire);
  if (!r.bufs.empty()) {
    std::vector<struct iovec> iov;
    bool fits = true;
    for (auto& s : r.bufs) {
      if (s.second > (1ull << 30)) {  // kernel per-iovec cap
        fits = false;
        break;
      }
      iov.push_back({(void*)s.first, (size_t)s.second});
    }
    if (fits && !iov.empty() &&
        sys_io_uring_register(fd, IORING_REGISTER_BUFFERS, iov.data(),
                              (unsigned)iov.size()) == 0)
      r.fixed_ok = true;
    if (!r.fixed_ok) r.bufs.clear();
  }
  r.ready = true;
  return true;
}

// submit the resolved runs as batched SQEs and reap their CQEs. One
// SQE per run (the destination is contiguous across a run); batches
// bounded by the ring size. Short or failed CQEs are finished by the
// pread scatter path per run — bytes identical, counted as fallbacks.
static bool uring_exec(SubmissionPlane& pl, UringRing& r,
                       const std::vector<ReadSqe>& rs) {
  bool fixed_usable =
      r.fixed_ok &&
      pl.seg_dead_gen.load(std::memory_order_acquire) == r.dead_gen;
  std::vector<uint64_t> got(rs.size(), 0);
  size_t done = 0;
  while (done < rs.size()) {
    unsigned batch = (unsigned)std::min((size_t)r.entries, rs.size() - done);
    unsigned tail = *r.sq_tail;
    for (unsigned k = 0; k < batch; k++) {
      const ReadSqe& s = rs[done + k];
      unsigned idx = (tail + k) & *r.sq_mask;
      struct io_uring_sqe* e = &r.sqes[idx];
      memset(e, 0, sizeof(*e));
      e->fd = s.fd;
      e->addr = (uint64_t)s.dst;
      // sqe.len is 32-bit: cap the request; a capped (short) read is
      // completed by the pread fallback below
      e->len = (uint32_t)std::min<uint64_t>(s.total, 1u << 30);
      e->off = s.off;
      e->user_data = done + k;
      int bi = -1;
      if (fixed_usable) {
        for (size_t b = 0; b < r.bufs.size(); b++) {
          uint64_t lo = r.bufs[b].first;
          uint64_t hi = lo + r.bufs[b].second;
          if ((uint64_t)s.dst >= lo && (uint64_t)s.dst + s.total <= hi) {
            bi = (int)b;
            break;
          }
        }
      }
      if (bi >= 0) {
        e->opcode = IORING_OP_READ_FIXED;
        e->buf_index = (uint16_t)bi;
      } else {
        e->opcode = IORING_OP_READ;
      }
      r.sq_array[idx] = idx;
    }
    __atomic_store_n(r.sq_tail, tail + batch, __ATOMIC_RELEASE);
    pl.sq_submits.fetch_add(batch, std::memory_order_relaxed);
    pl.note_depth(batch);
    unsigned submitted = 0;
    while (submitted < batch) {
      int ret = sys_io_uring_enter(r.ring_fd, batch - submitted,
                                   batch - submitted, IORING_ENTER_GETEVENTS);
      if (ret < 0) {
        if (errno == EINTR) continue;
        return false;  // ring wedged: caller degrades the whole task
      }
      submitted += (unsigned)ret;
    }
    pl.sq_batches.fetch_add(1, std::memory_order_relaxed);
    unsigned head = *r.cq_head;
    unsigned reaped = 0;
    while (reaped < batch) {
      unsigned ctail = __atomic_load_n(r.cq_tail, __ATOMIC_ACQUIRE);
      if (head == ctail) {
        int ret = sys_io_uring_enter(r.ring_fd, 0, 1, IORING_ENTER_GETEVENTS);
        if (ret < 0 && errno != EINTR) return false;
        continue;
      }
      while (head != ctail && reaped < batch) {
        struct io_uring_cqe* cqe = &r.cqes[head & *r.cq_mask];
        uint64_t ud = cqe->user_data;
        if (cqe->res > 0 && ud < rs.size()) got[ud] = (uint64_t)cqe->res;
        head++;
        reaped++;
      }
      __atomic_store_n(r.cq_head, head, __ATOMIC_RELEASE);
    }
    done += batch;
  }
  for (size_t i = 0; i < rs.size(); i++) {
    const ReadSqe& s = rs[i];
    if (got[i] < s.total) {
      // short or failed: redo the run via the scatter path (the rare
      // path re-reads a prefix; correctness over cleverness here)
      pl.sq_backend_fallbacks.fetch_add(1, std::memory_order_relaxed);
      if (!read_run_scatter(s.fd, s.off, s.dst, s.lens.data(),
                            s.lens.size()))
        return false;
    }
    pl.sq_completions.fetch_add(1, std::memory_order_relaxed);
  }
  return true;
}
#endif  // SRT_HAVE_IOURING

// per-worker backend state: the lazily-created ring (when compiled in)
struct WorkerRing {
#ifdef SRT_HAVE_IOURING
  UringRing ring;
#endif
  bool tried = false;
  bool counted_fail = false;
};

// availability probe, latched once per node: can this kernel do
// io_uring at all? The force_probe_fail seam makes the probe behave
// exactly like an ENOSYS kernel (tests + the read:enosys fault kind).
static bool plane_uring_probe(SubmissionPlane& pl) {
#ifndef SRT_HAVE_IOURING
  int st = pl.uring_state.load(std::memory_order_relaxed);
  if (st == 0 && pl.uring_state.compare_exchange_strong(st, -1))
    pl.sq_backend_fallbacks.fetch_add(1, std::memory_order_relaxed);
  return false;
#else
  if (pl.force_probe_fail.load(std::memory_order_relaxed)) {
    int st = pl.uring_state.load(std::memory_order_relaxed);
    if (st != -2 && pl.uring_state.compare_exchange_strong(st, -2))
      pl.sq_backend_fallbacks.fetch_add(1, std::memory_order_relaxed);
    return false;
  }
  int st = pl.uring_state.load(std::memory_order_relaxed);
  if (st < 0) return false;
  if (st == 0) {
    struct io_uring_params p;
    memset(&p, 0, sizeof(p));
    int fd = sys_io_uring_setup(4, &p);
    int now = fd >= 0 ? 1 : -1;
    if (fd >= 0) close(fd);
    int expect = 0;
    if (pl.uring_state.compare_exchange_strong(expect, now)) {
      if (now < 0)
        pl.sq_backend_fallbacks.fetch_add(1, std::memory_order_relaxed);
    }
    return pl.uring_state.load(std::memory_order_relaxed) == 1;
  }
  return true;
#endif
}

static bool plane_uring_ready(Node* n, WorkerRing& wr) {
  if (!plane_uring_probe(n->plane)) return false;
#ifndef SRT_HAVE_IOURING
  (void)wr;
  return false;
#else
  if (!wr.tried) {
    wr.tried = true;
    uring_init(wr.ring, n->plane);
  }
  if (!wr.ring.ready && !wr.counted_fail) {
    // the node-level probe passed but THIS worker's ring failed
    // (fd/memlock limits): this worker degrades to pread, once
    wr.counted_fail = true;
    n->plane.sq_backend_fallbacks.fetch_add(1, std::memory_order_relaxed);
  }
  return wr.ring.ready;
#endif
}

// SubmissionPlane execution, worker-thread side: resolve the task's
// blocks into runs and drive them through the selected backend. THE
// place where pread-vs-mapped-vs-scatter-vs-uring is decided — no
// caller branches on it.
bool plane_execute(Node* n, FileTask& t,
                   std::unordered_map<std::string, int>& fd_cache,
                   WorkerRing& wr) {
  SubmissionPlane& pl = n->plane;
  if (t.mapped) {
    // mapped DELIVERY: completion mode, not a backend (see plane doc)
    pl.sq_batches.fetch_add(1, std::memory_order_relaxed);
    pl.sq_submits.fetch_add(t.files.size(), std::memory_order_relaxed);
    pl.note_depth(t.files.size());
    if (!do_file_task_mapped(t)) return false;
    pl.sq_completions.fetch_add(t.files.size(), std::memory_order_relaxed);
    return true;
  }
  std::vector<ReadSqe> runs;
  if (!resolve_runs(t, fd_cache, runs)) return false;
  int want = pl.backend.load(std::memory_order_relaxed);
  if (want == RB_AUTO || want == RB_IOURING) {
#ifdef SRT_HAVE_IOURING
    if (plane_uring_ready(n, wr)) {
      if (uring_exec(pl, wr.ring, runs)) return true;
      // wedged ring mid-task: count and degrade this task to pread
      pl.sq_backend_fallbacks.fetch_add(1, std::memory_order_relaxed);
    }
#else
    plane_uring_ready(n, wr);  // latches the fallback, counted once
#endif
  }
  bool mapped_copy = want == RB_MAPPED;
  pl.sq_batches.fetch_add(1, std::memory_order_relaxed);
  pl.note_depth(runs.size());
  for (auto& s : runs) {
    pl.sq_submits.fetch_add(1, std::memory_order_relaxed);
    bool ok = mapped_copy
                  ? sqe_mapped_copy(s)
                  : read_run_scatter(s.fd, s.off, s.dst, s.lens.data(),
                                     s.lens.size());
    if (!ok && mapped_copy) {
      // filesystem refused the mapping: degrade the run to pread
      pl.sq_backend_fallbacks.fetch_add(1, std::memory_order_relaxed);
      ok = read_run_scatter(s.fd, s.off, s.dst, s.lens.data(),
                            s.lens.size());
    }
    if (!ok) return false;
    pl.sq_completions.fetch_add(1, std::memory_order_relaxed);
  }
  return true;
}

void file_worker_main(Node* n) {
  std::unordered_map<std::string, int> fd_cache;
  WorkerRing ring;
  while (true) {
    FileTask t;
    {
      std::unique_lock<std::mutex> lk(n->ft_mu);
      n->ft_cv.wait(lk, [&] { return !n->ftq.empty() || n->stopping.load(); });
      if (n->ftq.empty()) break;  // stopping and drained
      t = std::move(n->ftq.front());
      n->ftq.pop_front();
    }
    bool ok = plane_execute(n, t, fd_cache, ring);
    if (t.group) {
      // one part of a split task: only the LAST finisher completes
      // the request (success only if every part succeeded)
      if (!ok) t.group->failed.store(true);
      if (t.group->remaining.fetch_sub(1) != 1) continue;
      ok = !t.group->failed.load();
    }
    Command cmd;
    cmd.kind = ok ? Command::FILE_DONE : Command::FILE_FALLBACK;
    cmd.channel = t.channel;
    cmd.req_id = t.req_id;
    cmd.data = std::move(t.records);  // mapped: mmap records for the CQ
    n->enqueue(std::move(cmd));
  }
  for (auto& kv : fd_cache) close(kv.second);
}

// SubmissionPlane entry point, loop-thread side: schedule one logical
// read request (already parked in file_pending) onto the worker pool.
// The striping/splitting policy lives HERE — behind the plane seam —
// not in the frame handler, so every backend composes with it.
void plane_submit(Node* n, FileTask&& t) {
  // multi-block pread tasks fan out over the worker pool (the
  // WR-list striping analogue): contiguous block ranges, each
  // part's dst pre-offset, one shared completion. Mapped tasks
  // stay whole (their records must keep request order). The pool
  // can grow mid-run (srt_set_file_workers), so read the atomic
  // count — never the vector, which mutates under fw_mu.
  size_t nworkers = n->file_worker_count.load(std::memory_order_acquire);
  uint64_t total_bytes = 0;
  for (uint64_t L : t.lens) total_bytes += L;
  // intra-block striping: a single fat block (the common
  // one-partition fetch) would otherwise ride one worker while
  // the rest of the pool idles. Expand any block >= 4MB into
  // contiguous sub-ranges of the SAME file (offset advanced,
  // identity fields unchanged) so the byte-balanced split below
  // can spread ONE block across file_workers threads. Only for
  // the pread path: dst placement is cumulative over lens, so
  // sub-block boundaries are invisible downstream; mapped tasks
  // keep per-block records and must stay whole.
  if (!t.mapped && nworkers > 1) {
    std::vector<FileRef> xfiles;
    std::vector<uint64_t> xlens;
    for (size_t i = 0; i < t.files.size(); i++) {
      uint64_t blen = t.lens[i];
      // each sub-range stays >= 1MB so the stripe never degrades
      // into syscall-overhead-dominated slivers
      size_t sparts = (size_t)std::min<uint64_t>(
          (uint64_t)nworkers, blen / (1ull << 20));
      if (blen >= (4ull << 20) && sparts > 1) {
        uint64_t chunk = (blen + sparts - 1) / sparts;
        for (uint64_t done = 0; done < blen; done += chunk) {
          FileRef sub = t.files[i];
          sub.off += done;
          xfiles.push_back(std::move(sub));
          xlens.push_back(std::min(chunk, blen - done));
        }
        n->stat_block_stripes.fetch_add((blen + chunk - 1) / chunk);
        continue;
      }
      xfiles.push_back(std::move(t.files[i]));
      xlens.push_back(blen);
    }
    t.files = std::move(xfiles);
    t.lens = std::move(xlens);
  }
  // split only when the work amortizes the dispatch (a few MB
  // floor) and balance parts by BYTES, not block count — one fat
  // block among small ones must not leave a part doing all the
  // copying while the others pay pure thread overhead
  if (!t.mapped && nworkers > 1 && t.files.size() > 1 &&
      total_bytes >= (4ull << 20)) {
    size_t parts = std::min(nworkers, t.files.size());
    auto grp = std::make_shared<TaskGroup>();
    std::vector<FileTask> subs;
    uint64_t off = 0, acc = 0, remaining_bytes = total_bytes;
    FileTask s;
    s.channel = t.channel;
    s.req_id = t.req_id;
    s.group = grp;
    s.dst = t.dst;
    for (size_t i = 0; i < t.files.size(); i++) {
      s.files.push_back(std::move(t.files[i]));
      s.lens.push_back(t.lens[i]);
      acc += t.lens[i];
      off += t.lens[i];
      remaining_bytes -= t.lens[i];
      bool more_parts = subs.size() + 1 < parts;
      bool more_files = i + 1 < t.files.size();
      if (more_parts && more_files) {
        // close this part when stopping NOW lands closer to its
        // fair share (remaining bytes / remaining parts) than
        // absorbing the next block would — keeps parts byte-
        // balanced even when one fat block sits among small ones
        uint64_t share = (acc + remaining_bytes) / (parts - subs.size());
        uint64_t next = t.lens[i + 1];
        uint64_t over = acc + next > share ? acc + next - share : 0;
        uint64_t under = share > acc ? share - acc : 0;
        if (acc >= share || over > under) {
          subs.push_back(std::move(s));
          s = FileTask();
          s.channel = t.channel;
          s.req_id = t.req_id;
          s.group = grp;
          s.dst = t.dst + off;
          acc = 0;
        }
      }
    }
    subs.push_back(std::move(s));
    // set the count BEFORE any part is enqueued
    grp->remaining.store((int)subs.size());
    n->stat_split_parts.fetch_add(subs.size());
    {
      std::lock_guard<std::mutex> g(n->ft_mu);
      for (auto& sub : subs) n->ftq.push_back(std::move(sub));
    }
    n->ft_cv.notify_all();
  } else {
    {
      std::lock_guard<std::mutex> g(n->ft_mu);
      n->ftq.push_back(std::move(t));
    }
    n->ft_cv.notify_one();
  }
}

void handle_frame_ingest(Node* n, Conn* c, const uint8_t* data, size_t len);

// consume as many bytes as the state machine wants from [data, data+len)
size_t ingest(Node* n, Conn* c, const uint8_t* data, size_t len) {
  size_t used = 0;
  while (used < len && !c->down) {
    switch (c->st) {
      case RxState::OP: {
        uint8_t op = data[used++];
        c->hdr_got = 0;
        switch (op) {
          case OP_SEND: c->st = RxState::SEND_HDR; c->hdr_need = 4; break;
          case OP_READ_REQ:
            c->cur_req2 = false;
            c->st = RxState::READQ_HDR; c->hdr_need = 12; break;
          case OP_READ_REQ2:
            c->cur_req2 = true;
            c->st = RxState::READQ_HDR; c->hdr_need = 12; break;
          case OP_READ_RESP: c->st = RxState::READR_HDR; c->hdr_need = 16; break;
          case OP_READ_ERR: c->st = RxState::READE_HDR; c->hdr_need = 12; break;
          case OP_READ_FILE: c->st = RxState::READF_HDR; c->hdr_need = 12; break;
          case OP_HELLO: c->st = RxState::HELLO_HDR; c->hdr_need = 6; break;
          case OP_GOODBYE: fail_conn(n, c); return used;
          default: fail_conn(n, c); return used;
        }
        break;
      }
      case RxState::SEND_HDR:
      case RxState::READQ_HDR:
      case RxState::READR_HDR:
      case RxState::READE_HDR:
      case RxState::READF_HDR:
      case RxState::HELLO_HDR: {
        size_t take = std::min(len - used, c->hdr_need - c->hdr_got);
        memcpy(c->hdr + c->hdr_got, data + used, take);
        c->hdr_got += take;
        used += take;
        if (c->hdr_got < c->hdr_need) break;
        if (c->st == RxState::SEND_HDR) {
          c->body_need = load_be32(c->hdr);
          c->body.resize(c->body_need);
          c->body_got = 0;
          c->st = c->body_need ? RxState::SEND_BODY : RxState::OP;
          if (!c->body_need) {
            Completion comp{};
            comp.kind = COMP_RECV;
            comp.channel = c->id;
            comp.payload = nullptr;
            comp.payload_len = 0;
            n->post(comp);
          }
        } else if (c->st == RxState::READQ_HDR) {
          c->cur_req = load_be64(c->hdr);
          c->body_need = (size_t)load_be32(c->hdr + 8) * 16;
          c->body.resize(c->body_need);
          c->body_got = 0;
          if (c->body_need == 0) {
            // zero-block READ: answer an empty response immediately
            serve_read(n, c, c->cur_req, {});
            c->st = RxState::OP;
          } else {
            c->st = RxState::READQ_BLOCKS;
          }
        } else if (c->st == RxState::READR_HDR) {
          uint64_t req = load_be64(c->hdr);
          uint64_t total = load_be64(c->hdr + 8);
          auto it = c->reads.find(req);
          if (it == c->reads.end() || it->second.expected != total) {
            // unknown or mismatched: drain to keep framing intact
            if (it != c->reads.end()) {
              Completion comp{};
              comp.kind = COMP_READ_DONE;
              comp.status = ST_ERR;
              comp.channel = c->id;
              comp.wr_id = it->second.wr_id;
              n->post(comp);
              c->reads.erase(it);
            }
            c->drain_left = total;
            c->st = total ? RxState::READR_DRAIN : RxState::OP;
          } else {
            c->cur_req = req;
            c->cur_read = &it->second;
            if (it->second.mapped && !it->second.dst && total) {
              // mapped request answered by streaming (remote peer or
              // unbacked region): land in a malloc'd blob whose
              // ownership passes to the completion payload
              it->second.owned = (uint8_t*)malloc(total);
              if (!it->second.owned) {
                // allocation failure fails THIS read, not the process:
                // drain the body to keep framing intact
                Completion comp{};
                comp.kind = COMP_READ_DONE;
                comp.status = ST_ERR;
                comp.channel = c->id;
                comp.wr_id = it->second.wr_id;
                n->post(comp);
                c->reads.erase(it);
                c->cur_read = nullptr;
                c->drain_left = total;
                c->st = RxState::READR_DRAIN;
                break;
              }
              it->second.dst = it->second.owned;
            }
            c->st = total ? RxState::READR_BODY : RxState::OP;
            if (!total) {
              n->stat_streamed_reads++;
              Completion comp{};
              comp.kind = COMP_READ_DONE;
              comp.status = ST_OK;
              comp.channel = c->id;
              comp.wr_id = it->second.wr_id;
              n->post(comp);
              c->reads.erase(it);
              c->cur_read = nullptr;
            }
          }
        } else if (c->st == RxState::READE_HDR) {
          c->cur_req = load_be64(c->hdr);
          c->body_need = load_be32(c->hdr + 8);
          c->body.resize(c->body_need);
          c->body_got = 0;
          if (c->body_need == 0) {
            // empty error message: still complete the pending read
            c->st = RxState::READE_BODY;
            handle_frame_ingest(n, c, c->body.data(), 0);
            c->st = RxState::OP;
          } else {
            c->st = RxState::READE_BODY;
          }
        } else if (c->st == RxState::READF_HDR) {
          c->cur_req = load_be64(c->hdr);
          c->body_need = load_be32(c->hdr + 8);
          if (c->body_need == 0 || c->body_need > (4u << 20)) {
            fail_conn(n, c);  // malformed READ_FILE
            return used;
          }
          c->body.resize(c->body_need);
          c->body_got = 0;
          c->st = RxState::READF_BODY;
        } else {  // HELLO_HDR
          c->body_need = load_be16(c->hdr + 4);
          c->body.resize(c->body_need);
          c->body_got = 0;
          c->st = RxState::HELLO_BODY;
          if (!c->body_need) {
            // zero-length id: still emit ACCEPT
            Completion comp{};
            comp.kind = COMP_ACCEPT;
            comp.channel = c->id;
            comp.aux = load_be32(c->hdr);
            comp.payload = nullptr;
            comp.payload_len = 0;
            n->post(comp);
            c->hello_done = true;
            c->st = RxState::OP;
          }
        }
        break;
      }
      case RxState::SEND_BODY:
      case RxState::READQ_BLOCKS:
      case RxState::READE_BODY:
      case RxState::READF_BODY:
      case RxState::HELLO_BODY: {
        size_t take = std::min(len - used, c->body_need - c->body_got);
        memcpy(c->body.data() + c->body_got, data + used, take);
        c->body_got += take;
        used += take;
        if (c->body_got < c->body_need) break;
        handle_frame_ingest(n, c, c->body.data(), c->body.size());
        c->st = RxState::OP;
        break;
      }
      case RxState::READR_BODY: {
        PendingRead* pr = c->cur_read;
        size_t take = std::min<uint64_t>(len - used, pr->expected - pr->received);
        memcpy(pr->dst + pr->received, data + used, take);
        pr->received += take;
        used += take;
        if (pr->received == pr->expected) {
          n->stat_streamed_reads++;
          Completion comp{};
          comp.kind = COMP_READ_DONE;
          comp.status = ST_OK;
          comp.channel = c->id;
          comp.wr_id = pr->wr_id;
          if (pr->owned) {
            // mapped request, streamed answer: deliver the blob
            // (aux=0 -> contiguous copied bytes, receiver frees)
            comp.payload = pr->owned;
            comp.payload_len = pr->expected;
            comp.aux = 0;
            pr->owned = nullptr;
          }
          n->post(comp);
          c->reads.erase(c->cur_req);
          c->cur_read = nullptr;
          c->st = RxState::OP;
        }
        break;
      }
      case RxState::READR_DRAIN: {
        size_t take = std::min<uint64_t>(len - used, c->drain_left);
        c->drain_left -= take;
        used += take;
        if (!c->drain_left) c->st = RxState::OP;
        break;
      }
    }
  }
  return used;
}

// completed-body dispatch for SEND / READ_REQ / READ_ERR / HELLO
void handle_frame_ingest(Node* n, Conn* c, const uint8_t* data, size_t len) {
  switch (c->st) {
    case RxState::SEND_BODY: {
      void* p = malloc(len ? len : 1);
      memcpy(p, data, len);
      Completion comp{};
      comp.kind = COMP_RECV;
      comp.channel = c->id;
      comp.payload = p;
      comp.payload_len = len;
      n->post(comp);
      break;
    }
    case RxState::READQ_BLOCKS: {
      std::vector<std::array<uint64_t, 3>> blocks(len / 16);
      for (size_t i = 0; i < blocks.size(); i++) {
        const uint8_t* b = data + i * 16;
        blocks[i] = {load_be32(b), load_be64(b + 4), load_be32(b + 12)};
      }
      if (c->cur_req2)
        serve_read2(n, c, c->cur_req, blocks);
      else
        serve_read(n, c, c->cur_req, blocks);
      break;
    }
    case RxState::READF_BODY: {
      auto it = c->reads.find(c->cur_req);
      if (it == c->reads.end()) break;  // late/unknown: nothing to do
      // parse proof_len(2) proof_path then
      // n x [file_off(8) dev(8) ino(8) size(8) mtime_ns(8) plen(2) path]
      std::vector<FileRef> files;
      bool parsed = len >= 2;
      bool same_host = false;
      size_t off = 0;
      if (parsed) {
        uint16_t prooflen = load_be16(data);
        parsed = (size_t)2 + prooflen + 4 <= len && prooflen > 0;
        if (parsed) {
          // host-identity gate: the proof path is unguessable, so being
          // able to stat it proves we share the server's filesystem.
          // Without this, a deterministic shuffle-file path existing on
          // BOTH hosts would silently serve the wrong host's bytes.
          std::string proof((const char*)data + 2, prooflen);
          struct stat st;
          same_host = stat(proof.c_str(), &st) == 0;
          off = 2 + prooflen;
        }
      }
      if (parsed && same_host) {
        uint32_t nf = load_be32(data + off);
        off += 4;
        parsed = false;
        if (nf == it->second.blocks.size()) {
          parsed = true;
          for (uint32_t i = 0; parsed && i < nf; i++) {
            if (off + 42 > len) { parsed = false; break; }
            uint64_t foff = load_be64(data + off);
            uint64_t fdev = load_be64(data + off + 8);
            uint64_t fino = load_be64(data + off + 16);
            uint64_t fsize = load_be64(data + off + 24);
            uint64_t fmt = load_be64(data + off + 32);
            uint16_t plen = load_be16(data + off + 40);
            if (off + 42 + plen > len) { parsed = false; break; }
            files.push_back({std::string((const char*)data + off + 42, plen),
                             foff, fdev, fino, fsize, fmt});
            off += 42 + plen;
          }
        }
      }
      if (parsed && same_host) {
        // hand the preads to the file worker; the pending read parks in
        // the node-level map so this Conn's death cannot free it while
        // the worker is writing into its destination
        c->files_ok = 1;
        FileTask t;
        t.channel = c->id;
        t.req_id = c->cur_req;
        t.dst = it->second.dst;
        t.mapped = it->second.mapped;
        for (auto& b : it->second.blocks) t.lens.push_back(b[2]);
        t.files = std::move(files);
        n->file_pending.emplace(std::make_pair(c->id, c->cur_req),
                                std::move(it->second));
        c->reads.erase(it);
        // hand the request to the submission plane: striping,
        // splitting and backend choice all live behind that one seam
        plane_submit(n, std::move(t));
      } else {
        // different host (proof unreachable): latch the fast path off
        // for this conn. A malformed frame just streams this one read.
        if (parsed && !same_host) c->files_ok = 0;
        send_read_frame(n, c, c->cur_req, it->second.blocks, false);
      }
      break;
    }
    case RxState::READE_BODY: {
      auto it = c->reads.find(c->cur_req);
      if (it != c->reads.end()) {
        void* p = malloc(len ? len : 1);
        memcpy(p, data, len);
        Completion comp{};
        comp.kind = COMP_READ_DONE;
        comp.status = ST_REMOTE_ERR;
        comp.channel = c->id;
        comp.wr_id = it->second.wr_id;
        comp.payload = p;
        comp.payload_len = len;
        n->post(comp);
        c->reads.erase(it);
      }
      break;
    }
    case RxState::HELLO_BODY: {
      void* p = malloc(len ? len : 1);
      memcpy(p, data, len);
      Completion comp{};
      comp.kind = COMP_ACCEPT;
      comp.channel = c->id;
      comp.aux = load_be32(c->hdr);
      comp.payload = p;
      comp.payload_len = len;
      n->post(comp);
      c->hello_done = true;
      break;
    }
    default:
      break;
  }
}

bool fd_peer_is_loopback(int fd) {
  sockaddr_in a{};
  socklen_t l = sizeof a;
  if (getpeername(fd, (sockaddr*)&a, &l) != 0) return false;
  return a.sin_family == AF_INET &&
         (ntohl(a.sin_addr.s_addr) >> 24) == 127;
}

void loop_main(Node* n) {
  epoll_event evs[64];
  std::vector<uint8_t> bufv(1 << 18);  // per-loop staging for headers/RPC
  uint8_t* buf = bufv.data();
  const size_t buf_sz = bufv.size();
  while (true) {
    for (Conn* dead : n->graveyard) delete dead;
    n->graveyard.clear();
    int k = epoll_wait(n->epfd, evs, 64, 100);
    if (k < 0) {
      if (errno == EINTR) continue;
      break;
    }
    for (int i = 0; i < k; i++) {
      void* tag = evs[i].data.ptr;
      if (tag == &n->evfd) {
        uint64_t junk;
        ssize_t r = read(n->evfd, &junk, sizeof(junk));
        (void)r;
        // drain commands
        while (true) {
          Command cmd;
          {
            std::lock_guard<std::mutex> g(n->cmd_mu);
            if (n->cmds.empty()) break;
            cmd = std::move(n->cmds.front());
            n->cmds.pop_front();
          }
          if (cmd.kind == Command::STOP) {
            // fail every live conn FIRST: this releases all zero-copy
            // pins (unblocking any dereg waiter safely) and fails all
            // outstanding reads/sends before the loop dies
            std::vector<Conn*> live;
            {
              std::lock_guard<std::mutex> g(n->conn_mu);
              for (auto& kv : n->conns) live.push_back(kv.second);
            }
            for (Conn* v : live) fail_conn(n, v);
            // parked file-pending reads complete as errors
            for (auto& kv : n->file_pending) {
              Completion comp{};
              comp.kind = COMP_READ_DONE;
              comp.status = ST_ERR;
              comp.channel = kv.first.first;
              comp.wr_id = kv.second.wr_id;
              n->post(comp);
            }
            n->file_pending.clear();
            // fail_conn pushed every conn into the graveyard; the
            // normal top-of-loop sweep will never run again, so free
            // them here (srt_node_stop only frees what's in n->conns)
            for (Conn* dead : n->graveyard) delete dead;
            n->graveyard.clear();
            return;
          }
          Conn* c = nullptr;
          {
            std::lock_guard<std::mutex> g(n->conn_mu);
            auto it = n->conns.find(cmd.channel);
            if (it != n->conns.end()) c = it->second;
          }
          if (cmd.kind == Command::ADD_CONN && c) {
            c->peer_loopback = fd_peer_is_loopback(c->fd);
            epoll_event ev{};
            ev.events = EPOLLIN;
            ev.data.ptr = c;
            epoll_ctl(n->epfd, EPOLL_CTL_ADD, c->fd, &ev);
          } else if (cmd.kind == Command::SEND && c) {
            queue_out(n, c, std::move(cmd.data), cmd.wr_id, cmd.last_of_wr);
            if (!c->down) flush_out(n, c);
          } else if (cmd.kind == Command::SEND && !c) {
            if (cmd.wr_id && cmd.last_of_wr) {
              Completion comp{};
              comp.kind = COMP_SEND_DONE;
              comp.status = ST_ERR;
              comp.channel = cmd.channel;
              comp.wr_id = cmd.wr_id;
              n->post(comp);
            }
          } else if (cmd.kind == Command::READ) {
            if (!c || c->down) {
              Completion comp{};
              comp.kind = COMP_READ_DONE;
              comp.status = ST_ERR;
              comp.channel = cmd.channel;
              comp.wr_id = cmd.wr_id;
              n->post(comp);
            } else {
              PendingRead pr;
              pr.wr_id = cmd.wr_id;
              pr.dst = cmd.dst;
              pr.expected = cmd.expected;
              pr.blocks = cmd.blocks;
              pr.mapped = cmd.mapped;
              c->reads.emplace(cmd.req_id, std::move(pr));
              // first try the same-host file path unless this channel
              // already proved the peer's files unreachable (or the
              // node knob forces streaming; mapped reads always probe)
              send_read_frame(n, c, cmd.req_id, cmd.blocks,
                              c->files_ok != 0 &&
                                  (cmd.mapped ||
                                   n->file_fastpath.load() != 0));
            }
          } else if (cmd.kind == Command::CLOSE_CONN && c) {
            // flush what we can, then drop
            if (!c->down) flush_out(n, c);
            fail_conn(n, c);
          } else if (cmd.kind == Command::EVICT_MKEY) {
            // a dereg timed out on this mkey's pins: kill every conn
            // still holding queued zero-copy sends from it (fail_conn
            // unpins), so the blocked dereg can complete safely
            uint32_t mk = (uint32_t)cmd.req_id;
            std::vector<Conn*> victims;
            {
              std::lock_guard<std::mutex> g(n->conn_mu);
              for (auto& kv : n->conns) {
                for (auto& ob : kv.second->outq) {
                  if (ob.ext && ob.pin_mkey == mk) {
                    victims.push_back(kv.second);
                    break;
                  }
                }
              }
            }
            for (Conn* v : victims) fail_conn(n, v);
          } else if (cmd.kind == Command::FILE_DONE ||
                     cmd.kind == Command::FILE_FALLBACK) {
            auto key = std::make_pair(cmd.channel, cmd.req_id);
            auto fit = n->file_pending.find(key);
            if (fit == n->file_pending.end()) {
              // the pending read is gone (STOP already errored it):
              // a mapped FILE_DONE still carries live mmap records
              if (cmd.kind == Command::FILE_DONE && !cmd.data.empty())
                unmap_mapped_records(cmd.data.data(), cmd.data.size());
            } else {
              PendingRead pr = std::move(fit->second);
              n->file_pending.erase(fit);
              if (cmd.kind == Command::FILE_DONE) {
                n->stat_file_reads++;
                Completion comp{};
                comp.kind = COMP_READ_DONE;
                comp.status = ST_OK;
                comp.channel = cmd.channel;
                comp.wr_id = pr.wr_id;
                if (pr.mapped) {
                  // aux=1: payload is n x 32B mmap records; receiver
                  // owns the mappings (srt_unmap) and the record blob
                  comp.aux = 1;
                  comp.payload_len = cmd.data.size();
                  if (!cmd.data.empty()) {
                    comp.payload = malloc(cmd.data.size());
                    memcpy(comp.payload, cmd.data.data(), cmd.data.size());
                  }
                }
                n->post(comp);
              } else if (c && !c->down) {
                // transient file failure: stream THIS read; the conn's
                // files_ok latch is untouched (only a host-proof miss
                // disables the fast path permanently)
                c->reads.emplace(cmd.req_id, std::move(pr));
                auto rit = c->reads.find(cmd.req_id);
                send_read_frame(n, c, cmd.req_id, rit->second.blocks, false);
              } else {
                Completion comp{};
                comp.kind = COMP_READ_DONE;
                comp.status = ST_ERR;
                comp.channel = cmd.channel;
                comp.wr_id = pr.wr_id;
                n->post(comp);
              }
            }
          }
        }
        continue;
      }
      if (tag == &n->listen_fd) {
        while (true) {
          int fd = accept4(n->listen_fd, nullptr, nullptr, SOCK_NONBLOCK);
          if (fd < 0) break;
          tune_socket(fd);
          Conn* c = new Conn();
          c->fd = fd;
          c->peer_loopback = fd_peer_is_loopback(fd);
          {
            std::lock_guard<std::mutex> g(n->conn_mu);
            c->id = n->next_conn++;
            n->conns[c->id] = c;
          }
          epoll_event ev{};
          ev.events = EPOLLIN;
          ev.data.ptr = c;
          epoll_ctl(n->epfd, EPOLL_CTL_ADD, fd, &ev);
        }
        continue;
      }
      Conn* c = (Conn*)tag;
      if (c->down) continue;
      if (evs[i].events & (EPOLLHUP | EPOLLERR)) {
        fail_conn(n, c);
        continue;
      }
      if (evs[i].events & EPOLLOUT) flush_out(n, c);
      if (c->down) continue;
      if (evs[i].events & EPOLLIN) {
        while (true) {
          // mid-READ-payload: receive straight into the caller's
          // destination buffer — one kernel->user copy, no staging
          if (c->st == RxState::READR_BODY && c->cur_read) {
            PendingRead* pr = c->cur_read;
            size_t want = (size_t)(pr->expected - pr->received);
            ssize_t r = recv(c->fd, pr->dst + pr->received, want, 0);
            if (r > 0) {
              pr->received += (uint64_t)r;
              if (pr->received == pr->expected) {
                n->stat_streamed_reads++;
                Completion comp{};
                comp.kind = COMP_READ_DONE;
                comp.status = ST_OK;
                comp.channel = c->id;
                comp.wr_id = pr->wr_id;
                if (pr->owned) {
                  // mapped request, streamed answer (same hand-off as
                  // the ingest-path completion below): blob ownership
                  // passes to the completion payload
                  comp.payload = pr->owned;
                  comp.payload_len = pr->expected;
                  comp.aux = 0;
                  pr->owned = nullptr;
                }
                n->post(comp);
                c->reads.erase(c->cur_req);
                c->cur_read = nullptr;
                c->st = RxState::OP;
              }
              continue;
            } else if (r == 0) {
              fail_conn(n, c);
              break;
            } else if (errno == EAGAIN || errno == EWOULDBLOCK) {
              break;
            } else {
              fail_conn(n, c);
              break;
            }
          }
          ssize_t r = recv(c->fd, buf, buf_sz, 0);
          if (r > 0) {
            size_t used = 0;
            while (used < (size_t)r && !c->down)
              used += ingest(n, c, buf + used, (size_t)r - used);
            if (c->down) break;
          } else if (r == 0) {
            fail_conn(n, c);
            break;
          } else if (errno == EAGAIN || errno == EWOULDBLOCK) {
            break;
          } else {
            fail_conn(n, c);
            break;
          }
        }
      }
    }
  }
}

}  // namespace

extern "C" {

struct srt_comp_c {
  uint32_t kind;
  uint32_t status;
  uint64_t channel;
  uint64_t wr_id;
  void* payload;
  uint64_t payload_len;
  uint32_t aux;
  uint32_t _pad;
};

void* srt_node_create(const char* host, uint16_t base_port, int max_retries) {
  // A peer dying mid-transfer turns the next write() into SIGPIPE,
  // which would kill the whole process instead of surfacing EPIPE to
  // the channel's failure path. Ignore it process-wide so broken pipes
  // degrade to ordinary send errors the retry ladder can handle.
  signal(SIGPIPE, SIG_IGN);
  Node* n = new Node();
  n->epfd = epoll_create1(0);
  n->evfd = eventfd(0, EFD_NONBLOCK);
  // bind with port retries (RdmaNode.java:75-97)
  for (int attempt = 0; attempt < max_retries; attempt++) {
    uint16_t port = base_port == 0 ? 0 : base_port + attempt;
    int fd = socket(AF_INET, SOCK_STREAM, 0);
    int one = 1;
    setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_port = htons(port);
    inet_pton(AF_INET, host, &addr.sin_addr);
    if (bind(fd, (sockaddr*)&addr, sizeof(addr)) == 0 && listen(fd, 128) == 0) {
      set_nonblock(fd);
      n->listen_fd = fd;
      socklen_t alen = sizeof(addr);
      getsockname(fd, (sockaddr*)&addr, &alen);
      n->port = ntohs(addr.sin_port);
      break;
    }
    close(fd);
  }
  if (n->listen_fd < 0) {
    close(n->epfd);
    close(n->evfd);
    delete n;
    return nullptr;
  }
  epoll_event ev{};
  ev.events = EPOLLIN;
  ev.data.ptr = &n->listen_fd;
  epoll_ctl(n->epfd, EPOLL_CTL_ADD, n->listen_fd, &ev);
  ev.events = EPOLLIN;
  ev.data.ptr = &n->evfd;
  epoll_ctl(n->epfd, EPOLL_CTL_ADD, n->evfd, &ev);
  // host-identity proof for the same-host file fast path (see the
  // READ_FILE wire comment): 128 random bits from /dev/urandom. The
  // pid in the name lets the Python-side sweeper reclaim proofs of
  // crashed processes (atexit never runs on SIGKILL/OOM).
  {
    uint8_t rnd[16];
    int ufd = open("/dev/urandom", O_RDONLY);
    if (ufd >= 0 && read(ufd, rnd, sizeof(rnd)) == (ssize_t)sizeof(rnd)) {
      char name[96];
      size_t pos = 0;
      pos += snprintf(name, sizeof(name), "/dev/shm/srt-host-%d-",
                      (int)getpid());
      for (int i = 0; i < 16; i++)
        pos += snprintf(name + pos, sizeof(name) - pos, "%02x", rnd[i]);
      int pfd = open(name, O_CREAT | O_EXCL | O_WRONLY, 0644);
      if (pfd >= 0) {
        close(pfd);
        n->host_proof = name;
      }
    }
    if (ufd >= 0) close(ufd);
  }
  n->loop = std::thread(loop_main, n);
  {
    std::lock_guard<std::mutex> g(n->fw_mu);
    n->file_workers.emplace_back(file_worker_main, n);
    n->file_worker_count.store(1, std::memory_order_release);
  }
  return n;
}

uint16_t srt_node_port(void* np) { return ((Node*)np)->port; }

// -- region registry (ProtectionDomain) ---------------------------------
uint32_t srt_reg(void* np, const void* ptr, uint64_t len) {
  Node* n = (Node*)np;
  std::lock_guard<std::mutex> g(n->reg_mu);
  uint32_t mkey = n->next_mkey++;
  Node::Region r;
  r.ptr = (const uint8_t*)ptr;
  r.len = len;
  n->regions[mkey] = r;
  // plain registrations are caller-writable memory: fixed-buffer
  // candidates for io_uring rings created after this point
  n->plane.add_segment(ptr, len);
  return mkey;
}

// register a region whose bytes are identical to [file_off, file_off+len)
// of the file at `path` (an shm slab or a mapped shuffle file): same-host
// peers may pread it directly instead of streaming through the socket.
// The caller supplies the backing file's identity from fstat of the SAME
// fd that backs the mapping — never from a fresh stat(path), which would
// race a concurrent rewrite of the path (identity would describe the new
// file while the region memory holds the old bytes). size=0 && mtime_ns=0
// declares a MUTABLE backing (shm slab: the file pages ARE the region) —
// identity is then dev/ino only (see READ_FILE wire doc). dev==0 &&
// ino==0 means "no identity": registered as a plain streamed region.
uint32_t srt_reg_file(void* np, const void* ptr, uint64_t len,
                      const char* path, uint64_t file_off,
                      uint64_t dev, uint64_t ino,
                      uint64_t size, uint64_t mtime_ns) {
  Node* n = (Node*)np;
  std::lock_guard<std::mutex> g(n->reg_mu);
  uint32_t mkey = n->next_mkey++;
  Node::Region r;
  r.ptr = (const uint8_t*)ptr;
  r.len = len;
  r.path = path ? path : "";
  r.file_off = file_off;
  r.file_backed = path && path[0] && (dev || ino);
  if (r.file_backed) {
    r.file_dev = dev;
    r.file_ino = ino;
    r.file_size = size;
    r.file_mtime_ns = mtime_ns;
  }
  n->regions[mkey] = r;
  // only MUTABLE backings (shm slabs: the mempool's segments, mapped
  // read-write) are fixed-buffer candidates — immutable spill-file
  // registrations are typically read-only mappings, and one unwritable
  // iovec fails the whole IORING_REGISTER_BUFFERS call
  if (!r.file_backed || (size == 0 && mtime_ns == 0))
    n->plane.add_segment(ptr, len);
  return mkey;
}

int srt_dereg(void* np, uint32_t mkey) {
  Node* n = (Node*)np;
  std::unique_lock<std::mutex> lk(n->reg_mu);
  auto it = n->regions.find(mkey);
  if (it == n->regions.end()) return -1;
  // drop the fixed-buffer candidate NOW (the caller intends to free
  // the memory): bumping seg_dead_gen stops every ring built on an
  // older snapshot from submitting READ_FIXED against it
  n->plane.remove_segment(it->second.ptr);
  if (it->second.pins == 0) {
    n->regions.erase(it);
    return 0;
  }
  // Zero-copy sends are in flight from this memory: block until the
  // loop thread flushes them (caller may free the memory on return —
  // the verbs ibv_dereg_mr contract). A peer that stops draining its
  // socket could hold the pin forever, so after a grace period the
  // offending connections are killed (the QP-error analogue), which
  // releases the pins. Never erase while pinned — that would let the
  // caller unmap memory the loop is still send()ing from.
  it->second.dereg_wanted = true;
  auto gone = [&] { return n->regions.find(mkey) == n->regions.end(); };
  // NOTE: `stopping` is deliberately NOT a wake-to-erase condition —
  // between the flag being set and the loop thread processing STOP,
  // queued zero-copy sends can still flush from this memory. Progress
  // is guaranteed instead: a live loop either drains the pins, or the
  // EVICT below kills the holding conns (unpinning), or STOP's
  // fail-all-conns unpins; each path erases the region and notifies.
  if (!cv_wait_ms(n->reg_cv, lk, 5000, gone)) {
    lk.unlock();
    Command cmd;
    cmd.kind = Command::EVICT_MKEY;
    cmd.req_id = mkey;  // reuse the field; EVICT has no req semantics
    n->enqueue(std::move(cmd));
    lk.lock();
  }
  if (!cv_wait_ms(n->reg_cv, lk, 30000, gone)) {
    // loop thread dead or wedged: leak the region entry rather than
    // risk a use-after-free. dereg_wanted stays set, so no future
    // serve can resolve this mkey.
    return -1;
  }
  return 0;
}

// client-side read-path counters (tests + bench): READs completed via
// the same-host pread fast path vs the streamed socket path
uint64_t srt_stat_file_reads(void* np) {
  return ((Node*)np)->stat_file_reads.load();
}

uint64_t srt_stat_streamed_reads(void* np) {
  return ((Node*)np)->stat_streamed_reads.load();
}

uint64_t srt_stat_block_stripes(void* np) {
  return ((Node*)np)->stat_block_stripes.load();
}
uint64_t srt_stat_split_parts(void* np) {
  return ((Node*)np)->stat_split_parts.load();
}

// -- submission plane ---------------------------------------------------
// read backend knob (tpu.shuffle.native.readBackend): 0 auto (io_uring
// when the kernel has it, else pread), 1 io_uring (degrades to pread
// when unavailable), 2 pread/preadv2, 3 mapped-copy
void srt_set_read_backend(void* np, int b) {
  if (b < RB_AUTO || b > RB_MAPPED) b = RB_AUTO;
  ((Node*)np)->plane.backend.store(b);
}

// 1 when the library was built with io_uring support compiled in
int srt_uring_compiled(void) {
#ifdef SRT_HAVE_IOURING
  return 1;
#else
  return 0;
#endif
}

// the backend buffer-destination reads will actually use right now:
// resolves `auto` and runs the availability probe (1 io_uring, 2
// pread, 3 mapped-copy). The CI no-liburing matrix leg asserts this
// reports the pread fallback.
int srt_read_backend_effective(void* np) {
  Node* n = (Node*)np;
  int want = n->plane.backend.load();
  if (want == RB_PREAD || want == RB_MAPPED) return want;
  return plane_uring_probe(n->plane) ? RB_IOURING : RB_PREAD;
}

// test seam (read:enosys fault kind): make the availability probe
// behave exactly like an ENOSYS kernel. Clearing it un-latches the
// forced state so auto detection can run again.
void srt_sq_force_probe_fail(void* np, int on) {
  Node* n = (Node*)np;
  n->plane.force_probe_fail.store(on ? 1 : 0);
  if (!on) {
    int st = -2;
    n->plane.uring_state.compare_exchange_strong(st, 0);
  }
}

// submission-queue accounting (transport.sq.* metric families)
uint64_t srt_stat_sq_submits(void* np) {
  return ((Node*)np)->plane.sq_submits.load();
}
uint64_t srt_stat_sq_batches(void* np) {
  return ((Node*)np)->plane.sq_batches.load();
}
uint64_t srt_stat_sq_depth_hwm(void* np) {
  return ((Node*)np)->plane.sq_depth_hwm.load();
}
uint64_t srt_stat_sq_completions(void* np) {
  return ((Node*)np)->plane.sq_completions.load();
}
uint64_t srt_stat_sq_backend_fallbacks(void* np) {
  return ((Node*)np)->plane.sq_backend_fallbacks.load();
}

uint64_t srt_region_count(void* np) {
  Node* n = (Node*)np;
  std::lock_guard<std::mutex> g(n->reg_mu);
  return n->regions.size();
}

// -- channels -----------------------------------------------------------
// connect + send the HELLO preamble; blocking in the caller's thread
// (the connect retry/timeout policy lives in the host language, like
// RdmaNode.getRdmaChannel's retry loop)
// kind: 0 = RPC, 1 = DATA (rides the high byte of the hello port word,
// mirroring wire.py pack_hello — reference channel roles,
// RdmaChannel.java:110-154)
uint64_t srt_connect(void* np, const char* host, uint16_t port,
                     uint16_t my_port, const char* my_id, int timeout_ms,
                     int kind) {
  Node* n = (Node*)np;
  int fd = socket(AF_INET, SOCK_STREAM, 0);
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons(port);
  if (inet_pton(AF_INET, host, &addr.sin_addr) != 1) {
    hostent* he = gethostbyname(host);
    if (!he) { close(fd); return 0; }
    memcpy(&addr.sin_addr, he->h_addr, he->h_length);
  }
  timeval tv{timeout_ms / 1000, (timeout_ms % 1000) * 1000};
  setsockopt(fd, SOL_SOCKET, SO_SNDTIMEO, &tv, sizeof(tv));
  if (connect(fd, (sockaddr*)&addr, sizeof(addr)) != 0) {
    close(fd);
    return 0;
  }
  size_t idlen = strlen(my_id);
  std::vector<uint8_t> hello(1 + 4 + 2 + idlen);
  hello[0] = OP_HELLO;
  // kind arrives pre-composed from Python as (kind << 8) | index; the
  // shift lands kind in hello-word byte 3 and the striping index in
  // byte 2 (wire.split_hello_word layout)
  store_be32(&hello[1], ((uint32_t)(kind & 0xffff) << 16) | (my_port & 0xffff));
  hello[5] = idlen >> 8;
  hello[6] = idlen & 0xff;
  memcpy(&hello[7], my_id, idlen);
  size_t off = 0;
  while (off < hello.size()) {
    ssize_t w = send(fd, hello.data() + off, hello.size() - off, MSG_NOSIGNAL);
    if (w <= 0) { close(fd); return 0; }
    off += (size_t)w;
  }
  tune_socket(fd);
  set_nonblock(fd);
  Conn* c = new Conn();
  c->fd = fd;
  c->outbound = true;
  uint64_t id;
  {
    std::lock_guard<std::mutex> g(n->conn_mu);
    id = n->next_conn++;
    c->id = id;
    n->conns[id] = c;
  }
  Command cmd;
  cmd.kind = Command::ADD_CONN;
  cmd.channel = id;
  n->enqueue(std::move(cmd));
  return id;
}

// post one SEND frame; when wr_id != 0 and last != 0, a SEND_DONE
// completion fires once the bytes hit the socket
int srt_post_send(void* np, uint64_t channel, const void* data, uint64_t len,
                  uint64_t wr_id, int last) {
  Node* n = (Node*)np;
  std::vector<uint8_t> frame(1 + 4 + len);
  frame[0] = OP_SEND;
  store_be32(&frame[1], (uint32_t)len);
  memcpy(&frame[5], data, len);
  Command cmd;
  cmd.kind = Command::SEND;
  cmd.channel = channel;
  cmd.data = std::move(frame);
  cmd.wr_id = wr_id;
  cmd.last_of_wr = last != 0;
  n->enqueue(std::move(cmd));
  return 0;
}

// one process-wide READ request-id source shared by both post paths
// (ids must be unique per connection; two counters could collide)
std::atomic<uint64_t> g_next_req{1};

// post a one-sided READ of n_blocks remote (mkey, addr, len) triples;
// bytes stream straight into dst; READ_DONE(wr_id) on completion
int srt_post_read(void* np, uint64_t channel, uint64_t wr_id, void* dst,
                  const uint64_t* blocks, uint32_t n_blocks) {
  Node* n = (Node*)np;
  uint64_t total = 0;
  std::vector<std::array<uint64_t, 3>> blks(n_blocks);
  for (uint32_t i = 0; i < n_blocks; i++) {
    blks[i] = {blocks[i * 3], blocks[i * 3 + 1], blocks[i * 3 + 2]};
    total += blocks[i * 3 + 2];
  }
  uint64_t req_id = g_next_req.fetch_add(1);
  Command cmd;
  cmd.kind = Command::READ;
  cmd.channel = channel;
  cmd.wr_id = wr_id;
  cmd.req_id = req_id;
  cmd.dst = (uint8_t*)dst;
  cmd.expected = total;
  cmd.blocks = std::move(blks);
  n->enqueue(std::move(cmd));
  return 0;
}

// post a one-sided READ with MAPPED delivery: no destination buffer.
// Same-host file-backed blocks complete with aux=1 and a payload of
// n x 32B host-endian records [user_ptr, len, map_base, map_len] — the
// caller reads the bytes in place (zero copies end to end) and MUST
// srt_unmap(map_base, map_len) each record, then srt_free_payload the
// record blob. A streamed answer (remote peer / unbacked region)
// completes with aux=0 and a malloc'd contiguous payload the caller
// frees with srt_free_payload. Mappings outstanding at process exit
// are reclaimed by the OS.
int srt_post_read_mapped(void* np, uint64_t channel, uint64_t wr_id,
                         const uint64_t* blocks, uint32_t n_blocks) {
  Node* n = (Node*)np;
  uint64_t total = 0;
  std::vector<std::array<uint64_t, 3>> blks(n_blocks);
  for (uint32_t i = 0; i < n_blocks; i++) {
    blks[i] = {blocks[i * 3], blocks[i * 3 + 1], blocks[i * 3 + 2]};
    total += blocks[i * 3 + 2];
  }
  uint64_t req_id = g_next_req.fetch_add(1);
  Command cmd;
  cmd.kind = Command::READ;
  cmd.channel = channel;
  cmd.wr_id = wr_id;
  cmd.req_id = req_id;
  cmd.dst = nullptr;
  cmd.expected = total;
  cmd.blocks = std::move(blks);
  cmd.mapped = true;
  n->enqueue(std::move(cmd));
  return 0;
}

void srt_unmap(void* base, uint64_t len) { munmap(base, (size_t)len); }

// 0 forces plain READ_REQ (streamed) for non-mapped reads — bench /
// remote-path-simulation knob; 1 restores the default REQ2 probe
void srt_set_file_fastpath(void* np, int on) {
  ((Node*)np)->file_fastpath.store(on);
}

// serve file-backed regions via sendfile even to loopback peers
// (tests/benches; loopback normally keeps the faster userspace send)
void srt_set_force_sendfile(void* np, int on) {
  ((Node*)np)->force_sendfile.store(on);
}

// grow the file-worker pool to k threads (never shrinks; clamped to
// [1, 16]). Concurrent read groups then overlap their page-cache
// copies — the QP-striping analogue (see Node::file_workers).
void srt_set_file_workers(void* np, int k) {
  Node* n = (Node*)np;
  if (k < 1) k = 1;
  if (k > 16) k = 16;
  // the vector mutates only under fw_mu; the loop thread reads the
  // atomic count (published after each thread is live), so growing
  // after traffic has started is safe
  std::lock_guard<std::mutex> g(n->fw_mu);
  while ((int)n->file_workers.size() < k && !n->stopping.load()) {
    n->file_workers.emplace_back(file_worker_main, n);
    n->file_worker_count.store(n->file_workers.size(),
                               std::memory_order_release);
  }
}

int srt_close_channel(void* np, uint64_t channel) {
  Node* n = (Node*)np;
  Command cmd;
  cmd.kind = Command::CLOSE_CONN;
  cmd.channel = channel;
  n->enqueue(std::move(cmd));
  return 0;
}

// -- completion queue ---------------------------------------------------
int srt_poll_cq(void* np, srt_comp_c* out, int max, int timeout_ms) {
  Node* n = (Node*)np;
  std::unique_lock<std::mutex> lk(n->cq_mu);
  if (n->cq.empty()) {
    cv_wait_ms(n->cq_cv, lk, timeout_ms, [&] { return !n->cq.empty(); });
  }
  int k = 0;
  while (k < max && !n->cq.empty()) {
    Completion c = n->cq.front();
    n->cq.pop_front();
    out[k].kind = c.kind;
    out[k].status = c.status;
    out[k].channel = c.channel;
    out[k].wr_id = c.wr_id;
    out[k].payload = c.payload;
    out[k].payload_len = c.payload_len;
    out[k].aux = c.aux;
    k++;
  }
  return k;
}

void srt_free_payload(void* p) { free(p); }

void srt_node_stop(void* np) {
  Node* n = (Node*)np;
  bool was = n->stopping.exchange(true);
  if (was) return;
  n->reg_cv.notify_all();  // release any dereg waiting on pinned sends
  if (!n->host_proof.empty()) unlink(n->host_proof.c_str());
  Command cmd;
  cmd.kind = Command::STOP;
  n->enqueue(std::move(cmd));
  n->loop.join();
  // the worker drains queued tasks (their destination buffers stay
  // alive until this function returns), then exits on `stopping`
  n->ft_cv.notify_all();
  {
    std::lock_guard<std::mutex> g(n->fw_mu);
    for (auto& w : n->file_workers)
      if (w.joinable()) w.join();
  }
  // commands queued behind STOP (or enqueued by workers finishing
  // after the loop exited) are never drained by the loop; a mapped
  // FILE_DONE among them still owns its page-cache mmaps
  {
    std::lock_guard<std::mutex> g(n->cmd_mu);
    for (auto& cmd : n->cmds)
      if (cmd.kind == Command::FILE_DONE && !cmd.data.empty())
        unmap_mapped_records(cmd.data.data(), cmd.data.size());
    n->cmds.clear();
  }
  close(n->listen_fd);
  {
    std::lock_guard<std::mutex> g(n->conn_mu);
    for (auto& kv : n->conns) {
      if (kv.second->fd >= 0) close(kv.second->fd);
      delete kv.second;
    }
    n->conns.clear();
  }
  close(n->epfd);
  close(n->evfd);
  {
    std::lock_guard<std::mutex> g(n->cq_mu);
    for (auto& c : n->cq) {
      if (c.payload) {
        // an undelivered mapped completion (aux=1) owns the mappings
        // its records describe, not just the record blob
        if (c.aux == 1) unmap_mapped_records(c.payload, c.payload_len);
        free(c.payload);
      }
    }
    n->cq.clear();
  }
  delete n;
}

}  // extern "C"
