// Threaded batch tensor-payload reader for the host data pipeline.
//
// The Python side indexes each ``.pt`` zip container once (payload offset,
// dtype, shape: the containers are ZIP_STORED, so payloads are raw
// little-endian buffers at a fixed offset) and hands this library a flat
// task list; each task is a single pread() straight into the memory of the
// destination CPU tensor. The GIL is released for the whole call (ctypes
// does this for foreign calls), so reads from many files proceed in
// parallel with Python-side work.
//
// Build: g++ -O3 -shared -fPIC -pthread -std=c++17 io.cpp -o <build>/pdt_io_<hash>.so
// (done lazily by pydrobert_tpu_torch.native on first use, into the
// package's _build/ directory; without a build there is no native
// path, and every caller reads item by item).

#include <atomic>
#include <cerrno>
#include <cstdint>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <unistd.h>

extern "C" {

struct PdtTask {
  const char* path;   // NUL-terminated file path
  int64_t offset;     // byte offset of the payload within the file
  int64_t nbytes;     // payload size in bytes
  void* dst;          // destination buffer (>= nbytes)
};

// Read every task's byte range into its destination buffer using up to
// `nthreads` worker threads. Returns 0 on success or (1 + i) where i is the
// index of the first task that failed (file missing, short read, ...).
int64_t pdt_read_batch(const PdtTask* tasks, int64_t n, int32_t nthreads);

}  // extern "C"

namespace {

bool run_task(const PdtTask& t) {
  int fd = ::open(t.path, O_RDONLY);
  if (fd < 0) return false;
  char* dst = static_cast<char*>(t.dst);
  int64_t remaining = t.nbytes;
  int64_t off = t.offset;
  while (remaining > 0) {
    ssize_t got = ::pread(fd, dst, static_cast<size_t>(remaining), off);
    if (got <= 0) {
      ::close(fd);
      return false;
    }
    dst += got;
    off += got;
    remaining -= got;
  }
  ::close(fd);
  return true;
}

}  // namespace

int64_t pdt_read_batch(const PdtTask* tasks, int64_t n, int32_t nthreads) {
  if (n <= 0) return 0;
  if (nthreads < 1) nthreads = 1;
  if (nthreads > n) nthreads = static_cast<int32_t>(n);
  std::atomic<int64_t> next(0);
  std::atomic<int64_t> fail(0);
  auto worker = [&]() {
    for (;;) {
      if (fail.load(std::memory_order_relaxed) != 0) return;
      int64_t i = next.fetch_add(1, std::memory_order_relaxed);
      if (i >= n) return;
      if (!run_task(tasks[i])) {
        int64_t expect = 0;
        fail.compare_exchange_strong(expect, i + 1);
        return;
      }
    }
  };
  if (nthreads == 1) {
    worker();
  } else {
    std::vector<std::thread> threads;
    threads.reserve(nthreads);
    for (int32_t k = 0; k < nthreads; ++k) threads.emplace_back(worker);
    for (auto& th : threads) th.join();
  }
  return fail.load();
}
