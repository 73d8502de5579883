// Threaded async file I/O for NVMe/disk tensor offload.
//
// A copy of the JAX package's deepspeed_tpu/csrc/aio/aio.cpp (the reference's
// csrc/aio library, deepspeed_aio_thread.cpp / py_ds_aio.cpp): a worker-thread
// pool issues pread/pwrite against host buffers (CPU tensors, pinned or not,
// that the GPU copies to and from).  Requests return at once with an id;
// wait() joins one, wait_all() drains the queue.  C ABI for ctypes binding
// (ops/aio/__init__.py), built with g++ by ops/_build.py.
//
// O_DIRECT mode (dstpu_aio_open_ex(threads, use_odirect=1)): the bulk of each
// transfer goes through an O_DIRECT fd via a 4096-aligned staging buffer
// (bypassing the page cache, as the reference's deepspeed_aio_common.cpp
// does), with the unaligned tail handled on a buffered fd.  Filesystems that
// reject O_DIRECT (tmpfs) fall back to fully buffered I/O per file.

#include <atomic>
#include <cerrno>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <fcntl.h>
#include <mutex>
#include <string>
#include <thread>
#include <unistd.h>
#include <unordered_map>
#include <vector>

namespace {

struct Request {
  int id;
  bool is_write;
  std::string path;
  void* buf;
  size_t nbytes;
};

constexpr size_t kAlign = 4096;           // O_DIRECT block/buffer alignment
constexpr size_t kStageBytes = 16 << 20;  // staging chunk per worker

struct Handle {
  std::vector<std::thread> workers;
  std::deque<Request> queue;
  std::mutex mu;
  std::condition_variable cv;
  std::condition_variable done_cv;
  std::unordered_map<int, long long> results;  // id -> bytes or -errno
  std::atomic<int> next_id{1};
  int in_flight = 0;
  bool shutdown = false;
  bool use_odirect = false;

  explicit Handle(int num_threads, bool odirect = false) : use_odirect(odirect) {
    for (int i = 0; i < num_threads; ++i) {
      workers.emplace_back([this] { this->worker(); });
    }
  }

  void worker() {
    void* stage = nullptr;  // per-worker aligned staging buffer, lazy
    for (;;) {
      Request req;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv.wait(lk, [this] { return shutdown || !queue.empty(); });
        if (shutdown && queue.empty()) break;
        req = queue.front();
        queue.pop_front();
      }
      long long result = -1;
      // zero-byte requests take the buffered path so writes still create the
      // file (O_CREAT|O_TRUNC) and reads of missing files still report ENOENT
      if (use_odirect && req.nbytes > 0) {
        if (stage == nullptr && posix_memalign(&stage, kAlign, kStageBytes) != 0) stage = nullptr;
        result = stage ? run_direct(req, stage) : -ENOMEM;
        if (result == -EINVAL) result = run_buffered(req);  // fs rejects O_DIRECT
      } else {
        result = run_buffered(req);
      }
      {
        std::lock_guard<std::mutex> lk(mu);
        results[req.id] = result;
        --in_flight;
      }
      done_cv.notify_all();
    }
    ::free(stage);
  }

  static long long io_loop(int fd, bool is_write, char* buf, size_t nbytes, size_t file_off) {
    size_t off = 0;
    while (off < nbytes) {
      ssize_t n = is_write ? ::pwrite(fd, buf + off, nbytes - off, file_off + off)
                           : ::pread(fd, buf + off, nbytes - off, file_off + off);
      if (n < 0) return -errno;
      if (n == 0) break;  // EOF on read
      off += static_cast<size_t>(n);
    }
    return static_cast<long long>(off);
  }

  static long long run_buffered(const Request& req) {
    int flags = req.is_write ? (O_WRONLY | O_CREAT | O_TRUNC) : O_RDONLY;
    int fd = ::open(req.path.c_str(), flags, 0644);
    if (fd < 0) return -errno;
    long long n = io_loop(fd, req.is_write, static_cast<char*>(req.buf), req.nbytes, 0);
    ::close(fd);
    return n;
  }

  // Bulk via O_DIRECT + aligned staging copies; sub-block tail via a second
  // buffered fd.  Returns -EINVAL if the filesystem refuses O_DIRECT so the
  // caller can fall back wholesale.
  static long long run_direct(const Request& req, void* stage) {
    const size_t aligned = req.nbytes & ~(kAlign - 1);
    char* user = static_cast<char*>(req.buf);
    long long total = 0;
    if (aligned > 0) {
      int flags = req.is_write ? (O_WRONLY | O_CREAT | O_TRUNC | O_DIRECT)
                               : (O_RDONLY | O_DIRECT);
      int fd = ::open(req.path.c_str(), flags, 0644);
      if (fd < 0) return -errno;
      for (size_t off = 0; off < aligned; off += kStageBytes) {
        size_t chunk = aligned - off < kStageBytes ? aligned - off : kStageBytes;
        if (req.is_write) std::memcpy(stage, user + off, chunk);
        long long n = io_loop(fd, req.is_write, static_cast<char*>(stage), chunk, off);
        if (n < 0) {
          ::close(fd);
          return n;
        }
        // copy only the bytes actually read — a short read must not leak the
        // staging buffer's previous contents past EOF
        if (!req.is_write && n > 0) std::memcpy(user + off, stage, static_cast<size_t>(n));
        total += n;
        if (static_cast<size_t>(n) < chunk) break;  // EOF
      }
      ::close(fd);
    }
    const size_t tail = req.nbytes - aligned;
    if (tail > 0) {
      int flags = req.is_write ? (O_WRONLY | (aligned ? 0 : O_CREAT | O_TRUNC)) : O_RDONLY;
      int fd = ::open(req.path.c_str(), flags, 0644);
      if (fd < 0) return -errno;
      long long n = io_loop(fd, req.is_write, user + aligned, tail, aligned);
      ::close(fd);
      if (n < 0) return n;
      total += n;
    }
    return total;
  }

  int submit(bool is_write, const char* path, void* buf, size_t nbytes) {
    int id = next_id.fetch_add(1);
    {
      std::lock_guard<std::mutex> lk(mu);
      queue.push_back(Request{id, is_write, path, buf, nbytes});
      ++in_flight;
    }
    cv.notify_one();
    return id;
  }

  long long wait(int id) {
    std::unique_lock<std::mutex> lk(mu);
    done_cv.wait(lk, [this, id] { return results.count(id) > 0; });
    long long r = results[id];
    results.erase(id);
    return r;
  }

  int wait_all() {
    std::unique_lock<std::mutex> lk(mu);
    done_cv.wait(lk, [this] { return in_flight == 0; });
    int failures = 0;
    for (auto& kv : results)
      if (kv.second < 0) ++failures;
    results.clear();
    return failures;
  }

  ~Handle() {
    {
      std::lock_guard<std::mutex> lk(mu);
      shutdown = true;
    }
    cv.notify_all();
    for (auto& t : workers) t.join();
  }
};

}  // namespace

extern "C" {

void* dstpu_aio_open(int num_threads) {
  if (num_threads < 1) num_threads = 1;
  return new Handle(num_threads);
}

void* dstpu_aio_open_ex(int num_threads, int use_odirect) {
  if (num_threads < 1) num_threads = 1;
  return new Handle(num_threads, use_odirect != 0);
}

void dstpu_aio_close(void* h) { delete static_cast<Handle*>(h); }

int dstpu_aio_pwrite(void* h, const char* path, void* buf, size_t nbytes) {
  return static_cast<Handle*>(h)->submit(true, path, buf, nbytes);
}

int dstpu_aio_pread(void* h, const char* path, void* buf, size_t nbytes) {
  return static_cast<Handle*>(h)->submit(false, path, buf, nbytes);
}

long long dstpu_aio_wait(void* h, int id) { return static_cast<Handle*>(h)->wait(id); }

int dstpu_aio_wait_all(void* h) { return static_cast<Handle*>(h)->wait_all(); }

}  // extern "C"
