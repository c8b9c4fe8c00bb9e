// Host-side buffer utilities of chainermn_tpu_torch — the port's own copy
// of the reference's host library (utils/native.py binds it through ctypes).
//
// ChainerMN's native code staged parameters through pinned host buffers
// (pack_params/unpack_params: gather every parameter into one contiguous
// buffer, scatter back).  Here the device side is PyTorch's, and the
// native seam is the host side of the pipeline, where Python is the
// bottleneck:
//
//   * gatherv/scatterv — pack N (possibly ragged) host buffers into one
//     contiguous buffer and back with a thread pool (batch assembly and
//     payload packing are memcpy-bound, and numpy copies run
//     single-threaded under the GIL; ctypes releases it for the whole
//     call);
//   * crc32c — checksums for parameter digests and the collective-order
//     debug mode (utils/debug.py);
//   * a ring queue — a bounded MPMC byte-buffer queue for byte-level
//     host pipelines.
//
// Built with: g++ -O3 -shared -fPIC -std=c++17 -o libhostbuf.so hostbuf.cpp -lpthread
// (utils/native.py's build line; the SSE4.2 crc path uses a per-function
// target attribute, so no -march flag is needed)

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <functional>
#include <mutex>
#include <queue>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// crc32c (Castagnoli).  Two implementations behind one entry point:
//   * hardware: SSE4.2 CRC32 instruction (8 bytes/op), compiled with a
//     per-function target attribute so the library itself needs no
//     -march flags, selected by a __builtin_cpu_supports("sse4.2")
//     runtime check (x86 only);
//   * software: slicing-by-8 table walk — the portable fallback, and the
//     same table construction utils/native.py's pure-Python fallback
//     mirrors bit-for-bit.
// hostbuf_crc32c_impl() reports which path is active so benchmarks and
// docs can say what was actually measured.
// ---------------------------------------------------------------------------
static uint32_t crc32c_tables[8][256];
static std::atomic<bool> crc_table_ready{false};
static std::mutex crc_table_mu;

static void crc32c_init_table() {
  std::lock_guard<std::mutex> lock(crc_table_mu);
  if (crc_table_ready.load()) return;
  const uint32_t poly = 0x82f63b78u;
  for (uint32_t i = 0; i < 256; i++) {
    uint32_t crc = i;
    for (int j = 0; j < 8; j++)
      crc = (crc >> 1) ^ ((crc & 1) ? poly : 0);
    crc32c_tables[0][i] = crc;
  }
  for (int k = 1; k < 8; k++)
    for (uint32_t i = 0; i < 256; i++)
      crc32c_tables[k][i] = (crc32c_tables[k - 1][i] >> 8) ^
                            crc32c_tables[0][crc32c_tables[k - 1][i] & 0xff];
  crc_table_ready.store(true);
}

static uint32_t crc32c_sw(const uint8_t* data, uint64_t len, uint32_t crc) {
  const uint32_t (*t)[256] = crc32c_tables;
  uint64_t i = 0;
  for (; i + 8 <= len; i += 8) {
    crc ^= (uint32_t)data[i] | ((uint32_t)data[i + 1] << 8) |
           ((uint32_t)data[i + 2] << 16) | ((uint32_t)data[i + 3] << 24);
    crc = t[7][crc & 0xff] ^ t[6][(crc >> 8) & 0xff] ^
          t[5][(crc >> 16) & 0xff] ^ t[4][(crc >> 24) & 0xff] ^
          t[3][data[i + 4]] ^ t[2][data[i + 5]] ^
          t[1][data[i + 6]] ^ t[0][data[i + 7]];
  }
  for (; i < len; i++)
    crc = (crc >> 8) ^ t[0][(crc ^ data[i]) & 0xff];
  return crc;
}

#if defined(__x86_64__) || defined(__i386__)
__attribute__((target("sse4.2")))
static uint32_t crc32c_hw(const uint8_t* data, uint64_t len, uint32_t crc) {
  uint64_t i = 0;
#if defined(__x86_64__)
  uint64_t crc64 = crc;
  for (; i + 8 <= len; i += 8) {
    uint64_t word;
    std::memcpy(&word, data + i, 8);
    crc64 = __builtin_ia32_crc32di(crc64, word);
  }
  crc = (uint32_t)crc64;
#endif
  for (; i < len; i++)
    crc = __builtin_ia32_crc32qi(crc, data[i]);
  return crc;
}

static bool crc32c_have_hw() {
  static const bool have = __builtin_cpu_supports("sse4.2");
  return have;
}
#else
static bool crc32c_have_hw() { return false; }
static uint32_t crc32c_hw(const uint8_t* d, uint64_t l, uint32_t c) {
  return crc32c_sw(d, l, c);
}
#endif

// 1 = hardware CRC32 instruction, 0 = software slicing-by-8.
int hostbuf_crc32c_impl() { return crc32c_have_hw() ? 1 : 0; }

uint32_t hostbuf_crc32c(const uint8_t* data, uint64_t len, uint32_t seed) {
  uint32_t crc = ~seed;
  if (crc32c_have_hw()) {
    crc = crc32c_hw(data, len, crc);
  } else {
    if (!crc_table_ready.load()) crc32c_init_table();
    crc = crc32c_sw(data, len, crc);
  }
  return ~crc;
}

// ---------------------------------------------------------------------------
// gatherv / scatterv: pack N variable-size source buffers into a contiguous
// destination at caller-computed offsets, and the inverse (ChainerMN's
// pack_params/unpack_params on the host): batch assembly (equal sizes) and
// payload packing (ragged sizes) are memcpy-bound, and numpy copies run
// single-threaded under the GIL while ctypes releases it for the whole call.
// ---------------------------------------------------------------------------
static void run_copies(uint64_t n_items, int n_threads,
                       const std::function<void(uint64_t)>& copy_one,
                       uint64_t total_bytes) {
  // Threading only pays past ~1 MiB of copies; below that, pool start-up
  // dominates.
  if (n_threads <= 1 || n_items < 2 || total_bytes < (1u << 20)) {
    for (uint64_t i = 0; i < n_items; i++) copy_one(i);
    return;
  }
  std::vector<std::thread> pool;
  std::atomic<uint64_t> next{0};
  for (int t = 0; t < n_threads; t++) {
    pool.emplace_back([&]() {
      for (;;) {
        uint64_t i = next.fetch_add(1);
        if (i >= n_items) return;
        copy_one(i);
      }
    });
  }
  for (auto& th : pool) th.join();
}

void hostbuf_gatherv(uint8_t* dst, const uint8_t** srcs,
                     const uint64_t* sizes, const uint64_t* offsets,
                     uint64_t n_items, int n_threads) {
  uint64_t total = 0;
  for (uint64_t i = 0; i < n_items; i++) total += sizes[i];
  run_copies(
      n_items, n_threads,
      [&](uint64_t i) { std::memcpy(dst + offsets[i], srcs[i], sizes[i]); },
      total);
}

void hostbuf_scatterv(const uint8_t* src, uint8_t** dsts,
                      const uint64_t* sizes, const uint64_t* offsets,
                      uint64_t n_items, int n_threads) {
  uint64_t total = 0;
  for (uint64_t i = 0; i < n_items; i++) total += sizes[i];
  run_copies(
      n_items, n_threads,
      [&](uint64_t i) { std::memcpy(dsts[i], src + offsets[i], sizes[i]); },
      total);
}

// ---------------------------------------------------------------------------
// Bounded MPMC ring queue of byte buffers (prefetch pipeline)
// ---------------------------------------------------------------------------
struct RingQueue {
  std::queue<std::vector<uint8_t>> q;
  std::mutex mu;
  std::condition_variable not_empty, not_full;
  size_t capacity;
  bool closed = false;
};

void* hostbuf_queue_new(uint64_t capacity) {
  auto* rq = new RingQueue();
  rq->capacity = capacity ? capacity : 1;
  return rq;
}

// Returns 0 on success, -1 if the queue is closed.
int hostbuf_queue_push(void* handle, const uint8_t* data, uint64_t len) {
  auto* rq = static_cast<RingQueue*>(handle);
  std::unique_lock<std::mutex> lock(rq->mu);
  rq->not_full.wait(lock,
                    [&] { return rq->q.size() < rq->capacity || rq->closed; });
  if (rq->closed) return -1;
  rq->q.emplace(data, data + len);
  rq->not_empty.notify_one();
  return 0;
}

// Returns the popped size, 0 if closed-and-empty. Caller provides dst with
// max_len capacity; oversized payloads are truncated (caller sizes buffers).
uint64_t hostbuf_queue_pop(void* handle, uint8_t* dst, uint64_t max_len) {
  auto* rq = static_cast<RingQueue*>(handle);
  std::unique_lock<std::mutex> lock(rq->mu);
  rq->not_empty.wait(lock, [&] { return !rq->q.empty() || rq->closed; });
  if (rq->q.empty()) return 0;
  auto& front = rq->q.front();
  uint64_t n = front.size() < max_len ? front.size() : max_len;
  std::memcpy(dst, front.data(), n);
  rq->q.pop();
  rq->not_full.notify_one();
  return n;
}

uint64_t hostbuf_queue_size(void* handle) {
  auto* rq = static_cast<RingQueue*>(handle);
  std::lock_guard<std::mutex> lock(rq->mu);
  return rq->q.size();
}

void hostbuf_queue_close(void* handle) {
  auto* rq = static_cast<RingQueue*>(handle);
  std::lock_guard<std::mutex> lock(rq->mu);
  rq->closed = true;
  rq->not_empty.notify_all();
  rq->not_full.notify_all();
}

void hostbuf_queue_free(void* handle) {
  delete static_cast<RingQueue*>(handle);
}

}  // extern "C"
