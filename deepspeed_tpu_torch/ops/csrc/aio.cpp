// Async file I/O thread pool — the DeepNVMe/aio analog.
//
// Host C++ of the port (a copy of deepspeed_tpu/native/aio.cpp with its
// two unbounded waits bounded, see UringEngine): a C++ worker pool doing
// chunked pread/pwrite against NVMe-backed files, exposed through a
// plain C ABI consumed via ctypes.  The destination may be any host
// memory, pinned (cudaHostAlloc'd) buffers included: a swap lands where
// the caller's buffer is.
//
// Requests are split into block_size chunks fanned across the pool, so a
// single large tensor read/write saturates multiple NVMe queues exactly
// like the reference's parallel pread/pwrite (csrc/aio/py_lib
// deepspeed_py_aio_handle.cpp).  Each request opens its file once; the
// fds are shared by all of its chunks and closed when the last chunk
// retires.
//
// The reference handle's knobs are consumed with these semantics
// (csrc/aio/py_lib/deepspeed_py_aio_handle.cpp):
//   block_size    — chunk granularity (parallelism unit).
//   queue_depth   — max chunks in flight; submission applies
//                   backpressure beyond it (libaio iodepth analog).
//   single_submit — one op per request instead of chunking (the
//                   reference's non-batched submit mode).
//   overlap_events— when false, each submit drains before returning
//                   (no submit/complete overlap).
//   use_odirect   — page-cache bypass: 4096-aligned spans go through an
//                   O_DIRECT fd via pooled aligned bounce buffers
//                   (numpy callers guarantee no alignment); unaligned
//                   head/tail spans use a buffered fd.  Filesystems
//                   without O_DIRECT (tmpfs) fall back silently;
//                   aio_odirect_ops reports what actually happened.

#ifndef _GNU_SOURCE
#define _GNU_SOURCE  // O_DIRECT
#endif

#include <atomic>
#include <condition_variable>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <fcntl.h>
#include <functional>
#include <memory>
#include <mutex>
#include <poll.h>
#include <sys/eventfd.h>
#include <string>
#include <sys/stat.h>
#include <sys/types.h>
#include <thread>
#include <unistd.h>
#include <vector>

#include "uring.h"

namespace {

constexpr long kAlign = 4096;

// backend-agnostic surface the C ABI dispatches through
class Engine {
public:
  virtual ~Engine() = default;
  virtual void submit(const char *path, char *buf, long nbytes, long offset,
                      bool write, bool trunc = false) = 0;
  virtual int wait() = 0;
  virtual int pending() const = 0;
  virtual long odirect_ops() const = 0;
  virtual long tasks_total() const = 0;
  virtual int backend() const = 0;  // 0 = thread pool, 1 = io_uring
};

struct Chunk {
  long off;
  long len;
  bool direct;
};

// split the file span [offset, offset+nbytes) into an unaligned head,
// an aligned O_DIRECT-eligible body (chunked by block_size) and an
// unaligned tail — shared by both engines
inline std::vector<Chunk> plan_chunks(long offset, long nbytes,
                                      long block_size, bool single_submit,
                                      bool have_direct) {
  std::vector<Chunk> out;
  long end = offset + nbytes;
  if (single_submit) {
    if (nbytes > 0) out.push_back({offset, nbytes, false});
    return out;
  }
  long body_lo = offset, body_hi = end;
  if (have_direct) {
    body_lo = (offset + kAlign - 1) / kAlign * kAlign;
    body_hi = end / kAlign * kAlign;
    if (body_hi <= body_lo) { body_lo = body_hi = offset; }
  } else {
    for (long done = 0; done < nbytes; done += block_size)
      out.push_back({offset + done, std::min(block_size, nbytes - done),
                     false});
    return out;
  }
  if (body_lo > offset) out.push_back({offset, body_lo - offset, false});
  for (long off = body_lo; off < body_hi; off += block_size)
    out.push_back({off, std::min(block_size, body_hi - off), true});
  if (end > body_hi) out.push_back({body_hi, end - body_hi, false});
  return out;
}

// One submitted read/write; owns the fds for all its chunks.
struct Request {
  int fd = -1;         // buffered
  int fd_direct = -1;  // O_DIRECT (or -1: unsupported / disabled)
  Request() = default;
  Request(const Request &) = delete;
  Request &operator=(const Request &) = delete;
  ~Request() {
    if (fd >= 0) close(fd);
    if (fd_direct >= 0) close(fd_direct);
  }
};

struct Task {
  std::shared_ptr<Request> req;
  char *buf;
  long nbytes;
  long offset;
  bool write;
  bool direct;  // aligned span eligible for the O_DIRECT fd
};

// open the buffered (and optionally O_DIRECT) fds for one request and
// apply the trunc-for-full-rewrite policy — shared by both engines
inline std::shared_ptr<Request> make_request(
    const char *path, long nbytes, long offset, bool write, bool trunc,
    bool want_direct, std::atomic<int> &errors) {
  int flags = write ? (O_WRONLY | O_CREAT) : O_RDONLY;
  auto req = std::make_shared<Request>();
  req->fd = open(path, flags, 0644);
  if (req->fd < 0) {
    errors.fetch_add(1);
    return nullptr;
  }
  if (want_direct)
    req->fd_direct = open(path, flags | O_DIRECT, 0644);  // may fail: ok
  // opt-in for full-file rewrites: a smaller rewrite must not leave a
  // stale tail from a previous, larger request
  if (write && trunc) {
    if (ftruncate(req->fd, offset + nbytes) != 0) errors.fetch_add(1);
  }
  return req;
}


class AioPool : public Engine {
public:
  AioPool(int num_threads, long block_size, int queue_depth,
          int single_submit, int overlap_events, int use_odirect)
      : block_size_(block_size), queue_depth_(queue_depth),
        single_submit_(single_submit != 0),
        overlap_events_(overlap_events != 0),
        use_odirect_(use_odirect != 0), stop_(false), pending_(0),
        errors_(0), odirect_ops_(0), tasks_total_(0) {
    if (num_threads < 1) num_threads = 1;
    if (block_size_ < 1) block_size_ = 1 << 20;
    // O_DIRECT chunks must stay 4096-multiples
    if (use_odirect_ && block_size_ % kAlign)
      block_size_ = ((block_size_ / kAlign) + 1) * kAlign;
    if (queue_depth_ < 1) queue_depth_ = 1 << 20;  // effectively unbounded
    for (int i = 0; i < num_threads; ++i)
      workers_.emplace_back([this] { worker(); });
  }

  ~AioPool() {
    {
      std::unique_lock<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_.notify_all();
    for (auto &w : workers_) w.join();
  }

  void submit(const char *path, char *buf, long nbytes, long offset,
              bool write, bool trunc = false) override {
    // single_submit runs each request as ONE buffered op (no chunking);
    // opening a direct fd it can never use would waste a syscall pair
    auto req = make_request(path, nbytes, offset, write, trunc,
                            use_odirect_ && !single_submit_, errors_);
    if (!req) return;
    auto chunks = plan_chunks(offset, nbytes, block_size_, single_submit_,
                              req->fd_direct >= 0);
    std::unique_lock<std::mutex> lk(mu_);
    for (const auto &c : chunks) {
      // queue_depth backpressure (libaio iodepth analog)
      space_cv_.wait(lk, [this] {
        return (long)queue_.size() < queue_depth_;
      });
      queue_.push_back(
          Task{req, buf + (c.off - offset), c.len, c.off, write, c.direct});
      pending_.fetch_add(1);
      tasks_total_.fetch_add(1);
      cv_.notify_one();
    }
    lk.unlock();
    if (!overlap_events_) {
      std::unique_lock<std::mutex> dlk(done_mu_);
      done_cv_.wait(dlk, [this] { return pending_.load() == 0; });
    }
  }

  int wait() override {
    std::unique_lock<std::mutex> lk(done_mu_);
    done_cv_.wait(lk, [this] { return pending_.load() == 0; });
    return errors_.exchange(0);
  }

  int pending() const override { return pending_.load(); }
  long odirect_ops() const override { return odirect_ops_.load(); }
  long tasks_total() const override { return tasks_total_.load(); }
  int backend() const override { return 0; }

private:
  void worker() {
    AlignedBuf bounce;
    for (;;) {
      Task t;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_.wait(lk, [this] { return stop_ || !queue_.empty(); });
        if (stop_ && queue_.empty()) return;
        t = std::move(queue_.front());
        queue_.pop_front();
        space_cv_.notify_one();
      }
      if (!run_one(t, bounce)) errors_.fetch_add(1);
      t.req.reset();  // close fds as soon as the last chunk retires
      if (pending_.fetch_sub(1) == 1) {
        std::unique_lock<std::mutex> lk(done_mu_);
        done_cv_.notify_all();
      }
    }
  }

  // per-worker reusable aligned bounce buffer for O_DIRECT chunks
  struct AlignedBuf {
    char *p = nullptr;
    long cap = 0;
    ~AlignedBuf() { free(p); }
    char *get(long n) {
      if (n > cap) {
        free(p);
        if (posix_memalign(reinterpret_cast<void **>(&p), kAlign, n))
          p = nullptr;
        cap = p ? n : 0;
      }
      return p;
    }
  };

  bool run_one(const Task &t, AlignedBuf &bounce) {
    int fd = t.req->fd;
    char *src = t.buf;
    if (t.direct && t.req->fd_direct >= 0) {
      // aligned file span; the USER buffer may still be unaligned, so
      // stage through the worker's aligned bounce buffer
      char *b = bounce.get(t.nbytes);
      if (b != nullptr) {
        fd = t.req->fd_direct;
        src = b;
        if (t.write) memcpy(b, t.buf, t.nbytes);
        odirect_ops_.fetch_add(1);
      }
    }
    long done = 0;
    while (done < t.nbytes) {
      ssize_t n = t.write
          ? pwrite(fd, src + done, t.nbytes - done, t.offset + done)
          : pread(fd, src + done, t.nbytes - done, t.offset + done);
      if (n <= 0) {
        if (fd == t.req->fd_direct) {
          // e.g. EINVAL from a filesystem that accepted the open but
          // rejects direct I/O — retry the whole chunk buffered
          fd = t.req->fd;
          src = t.buf;
          odirect_ops_.fetch_sub(1);
          done = 0;
          continue;
        }
        return false;
      }
      done += n;
    }
    if (!t.write && src != t.buf) memcpy(t.buf, src, t.nbytes);
    return true;
  }

  long block_size_;
  long queue_depth_;
  bool single_submit_;
  bool overlap_events_;
  bool use_odirect_;
  bool stop_;
  std::vector<std::thread> workers_;
  std::deque<Task> queue_;
  std::mutex mu_;
  std::condition_variable cv_;
  std::condition_variable space_cv_;
  std::mutex done_mu_;
  std::condition_variable done_cv_;
  std::atomic<int> pending_;
  std::atomic<int> errors_;
  std::atomic<long> odirect_ops_;
  std::atomic<long> tasks_total_;
};



// ---------------------------------------------------------------------
// io_uring engine: real kernel queue depth, registered bounce buffers
// (see uring.h for the design notes)
// ---------------------------------------------------------------------
class UringEngine : public Engine {
public:
  UringEngine(long block_size, int queue_depth, int single_submit,
              int overlap_events, int use_odirect, bool *ok)
      : block_size_(block_size), single_submit_(single_submit != 0),
        overlap_events_(overlap_events != 0), use_odirect_(use_odirect != 0),
        pending_(0), errors_(0), odirect_ops_(0), tasks_total_(0) {
    if (block_size_ < 1) block_size_ = 1 << 20;
    if (use_odirect_ && block_size_ % kAlign)
      block_size_ = ((block_size_ / kAlign) + 1) * kAlign;
    if (queue_depth < 2) queue_depth = 2;
    if (queue_depth > 1024) queue_depth = 1024;
    *ok = ring_.init((unsigned)queue_depth);
    if (!*ok) return;
    depth_ = ring_.entries;
    ops_.resize(depth_);
    // descending: free_slots_.back() hands out LOW slots first, which
    // is where the capped pinned bounce pool lives
    for (unsigned i = depth_; i > 0; --i)
      free_slots_.push_back((int)(i - 1));
    if (use_odirect_) {
      // pinned aligned buffers registered once — the fixed-buffer pool
      // O_DIRECT chunks do zero-copy kernel DMA into.  Capped: pinning
      // queue_depth x block_size (up to 1 GB) eagerly would waste pages
      // whenever the filesystem rejects O_DIRECT; chunks landing in
      // slots past the pool simply run buffered
      npinned_ = depth_ < 64 ? depth_ : 64;
      bounce_.resize(npinned_, nullptr);
      std::vector<struct iovec> iov(npinned_);
      bool all = true;
      for (unsigned i = 0; i < npinned_; ++i) {
        if (posix_memalign(reinterpret_cast<void **>(&bounce_[i]), kAlign,
                           block_size_))
          bounce_[i] = nullptr;
        all = all && bounce_[i];
        iov[i].iov_base = bounce_[i];
        iov[i].iov_len = (size_t)block_size_;
      }
      registered_ =
          all && uring::sys_register(ring_.fd, IORING_REGISTER_BUFFERS,
                                     iov.data(), npinned_) == 0;
      if (!registered_) use_odirect_ = false;
    }
    wake_fd_ = eventfd(0, EFD_NONBLOCK | EFD_CLOEXEC);
    reaper_ = std::thread([this] { reap(); });
  }

  ~UringEngine() override {
    // drain in-flight I/O first: the kernel may still be DMA-ing into
    // the registered bounce buffers and the caller's memory (the thread
    // pool likewise completes its queue before destruction)
    if (reaper_.joinable() && !dead_.load()) wait();
    if (reaper_.joinable()) {
      // the reaper waits on the ring fd AND on wake_fd_ (an eventfd), with
      // a bounded timeout, and leaves once stop_ is set and the CQ is
      // empty: shutdown needs no submission to reach the kernel, so a
      // poisoned ring cannot strand join()
      stop_.store(true);
      if (wake_fd_ >= 0) {
        uint64_t one = 1;
        ssize_t w = write(wake_fd_, &one, sizeof(one));
        (void)w;               // the bounded poll is the fallback wake
      }
      reaper_.join();
    }
    if (wake_fd_ >= 0) close(wake_fd_);
    for (char *b : bounce_) free(b);
  }

  void submit(const char *path, char *buf, long nbytes, long offset,
              bool write, bool trunc = false) override {
    if (dead_.load()) {        // ring failed fatally: fail fast, no hang
      errors_.fetch_add(1);
      return;
    }
    auto req = make_request(path, nbytes, offset, write, trunc,
                            use_odirect_ && !single_submit_, errors_);
    if (!req) return;
    auto chunks = plan_chunks(offset, nbytes, block_size_, single_submit_,
                              req->fd_direct >= 0);
    for (const auto &c : chunks) {
      std::unique_lock<std::mutex> lk(mu_);
      slot_cv_.wait(lk, [this] {
        return dead_.load() || !free_slots_.empty();
      });
      if (dead_.load()) {        // ring died mid-request: fail the rest
        errors_.fetch_add(1);
        break;
      }
      int slot = free_slots_.back();
      free_slots_.pop_back();
      UOp &op = ops_[slot];
      op.req = req;
      op.user = buf + (c.off - offset);
      op.len = c.len;
      op.off = c.off;
      op.done = 0;
      op.write = write;
      op.direct = c.direct && registered_ && c.len <= block_size_ &&
                  (unsigned)slot < npinned_;
      pending_.fetch_add(1);
      tasks_total_.fetch_add(1);
      if (op.direct && write) {
        // the slot is exclusively ours: stage the bounce copy OUTSIDE
        // the lock so concurrent submitters/reaper aren't serialized
        // behind a memcpy (op.staging keeps the fatal sweep off it)
        op.staging = true;
        lk.unlock();
        std::memcpy(bounce_[slot], op.user, op.len);
        lk.lock();
        op.staging = false;
      }
      push_locked(slot, lk);
    }
    if (!overlap_events_) {
      std::unique_lock<std::mutex> dlk(done_mu_);
      done_cv_.wait(dlk, [this] { return pending_.load() == 0; });
    }
  }

  int wait() override {
    std::unique_lock<std::mutex> lk(done_mu_);
    done_cv_.wait(lk, [this] { return pending_.load() == 0; });
    return errors_.exchange(0);
  }

  int pending() const override { return pending_.load(); }
  long odirect_ops() const override { return odirect_ops_.load(); }
  long tasks_total() const override { return tasks_total_.load(); }
  int backend() const override { return 1; }

private:
  struct UOp {
    std::shared_ptr<Request> req;
    char *user = nullptr;
    long len = 0, off = 0, done = 0;
    bool write = false;
    bool direct = false;
    bool staging = false;   // claimed, memcpy in progress OUTSIDE mu_ —
  };                        // the fatal sweep must not touch it

  // fill + submit the SQE for ops_[slot]'s remaining span (mu_ held
  // through lk).  Every wait in here is bounded: a transient failure
  // (EINTR/EAGAIN/EBUSY, or a full SQ) waits for completions only when
  // other operations are in flight, and then with a timeout and with
  // mu_ released so the reaper can drain the CQ; when nothing else is in
  // flight no completion can come, so it backs off briefly instead.
  // After kMaxTries the engine is poisoned, never hung.
  void push_locked(int slot, std::unique_lock<std::mutex> &lk) {
    if (dead_.load()) {
      // nothing was pushed for this span yet, so the slot can't see a
      // ghost completion — retire it normally with an error
      retire_locked(slot, true);
      return;
    }
    UOp &op = ops_[slot];
    struct io_uring_sqe sqe;
    std::memset(&sqe, 0, sizeof(sqe));
    if (op.direct) {
      sqe.opcode = op.write ? IORING_OP_WRITE_FIXED : IORING_OP_READ_FIXED;
      sqe.fd = op.req->fd_direct;
      sqe.addr = (unsigned long long)(bounce_[slot] + op.done);
      sqe.buf_index = (unsigned short)slot;
    } else {
      sqe.opcode = op.write ? IORING_OP_WRITE : IORING_OP_READ;
      sqe.fd = op.req->fd;
      sqe.addr = (unsigned long long)(op.user + op.done);
    }
    long remaining = op.len - op.done;
    if (remaining > (1L << 30)) remaining = 1L << 30;  // sqe.len is u32
    sqe.len = (unsigned)remaining;
    sqe.off = (unsigned long long)(op.off + op.done);
    sqe.user_data = (unsigned long long)slot;
    bool pushed = false;
    for (int tries = 0; tries < kMaxTries; ++tries) {
      if (!pushed) pushed = ring_.push(sqe);
      if (pushed) {
        int r = uring::sys_enter(ring_.fd, 1, 0, 0);
        if (r >= 0) return;
        if (errno != EINTR && errno != EAGAIN && errno != EBUSY) break;
      }
      backoff_locked(slot, lk);
      if (dead_.load()) break;
    }
    // fatal: the SQE may or may not ever be consumed later — poison
    // the engine and LEAK the slot (never back on the free list), so
    // a ghost completion can't race a reused slot; account the op as
    // finished so wait() returns with the error, and wake slot
    // waiters so multi-chunk submits observe dead_ instead of
    // blocking forever
    dead_.store(true);
    account_done_locked(slot, true);
    slot_cv_.notify_all();
  }

  // one bounded wait of push_locked.  pending_ counts this op too, so
  // other ops are in flight iff pending_ > 1: then wait up to 50 ms for
  // the CQ, with mu_ released (the slot marked staging, so the reaper's
  // fatal sweep leaves it to us); else a 2 ms back-off.
  void backoff_locked(int slot, std::unique_lock<std::mutex> &lk) {
    bool others = pending_.load() > 1;
    ops_[slot].staging = true;
    lk.unlock();
    if (others) {
      struct pollfd pfd = {ring_.fd, POLLIN, 0};
      poll(&pfd, 1, 50);
    } else {
      poll(nullptr, 0, 2);
    }
    lk.lock();
    ops_[slot].staging = false;
  }

  // completion accounting shared by every finish path (mu_ held)
  void account_done_locked(int slot, bool error) {
    UOp &op = ops_[slot];
    if (error) errors_.fetch_add(1);
    op.req.reset();            // close fds when the last chunk retires
    if (pending_.fetch_sub(1) == 1) {
      std::lock_guard<std::mutex> dlk(done_mu_);
      done_cv_.notify_all();
    }
  }

  void retire_locked(int slot, bool error) {
    UOp &op = ops_[slot];
    if (!error && op.direct) {
      if (!op.write) std::memcpy(op.user, bounce_[slot], op.len);
      odirect_ops_.fetch_add(1);
    }
    account_done_locked(slot, error);
    free_slots_.push_back(slot);
    slot_cv_.notify_one();
  }

  void reap() {
    struct io_uring_cqe cqe[64];
    for (;;) {
      int n;
      {
        std::lock_guard<std::mutex> lk(mu_);
        n = ring_.pop(cqe, 64);
      }
      if (n == 0) {
        if (stop_.load()) return;   // shutdown: set by the destructor,
        // which also signals wake_fd_; no sentinel submit is involved.
        // Bounded wait on the CQ (the ring fd polls readable when
        // completions are pending) and on wake_fd_: a lost wakeup
        // strands this thread for at most one interval
        struct pollfd pfd[2] = {{ring_.fd, POLLIN, 0}, {wake_fd_, POLLIN, 0}};
        int r = poll(pfd, wake_fd_ >= 0 ? 2 : 1, 100);
        if (r > 0 && wake_fd_ >= 0 && (pfd[1].revents & POLLIN)) {
          uint64_t v;
          ssize_t got = read(wake_fd_, &v, sizeof(v));
          (void)got;
        }
        if (r < 0 && errno != EINTR) {
          // ring unusable: poison the engine (submits fail fast) and
          // fail everything still pending so wait() returns
          dead_.store(true);
          std::lock_guard<std::mutex> lk(mu_);
          for (unsigned i = 0; i < depth_; ++i)
            if (ops_[i].req && !ops_[i].staging)
              retire_locked((int)i, true);   // staging slots belong to
          slot_cv_.notify_all();             // their submitter, which
          return;                            // sees dead_ in push_locked
        }
        continue;
      }
      std::vector<int> drained;
      std::unique_lock<std::mutex> lk(mu_);
      for (int i = 0; i < n; ++i) {
        int slot = (int)cqe[i].user_data;
        if (slot < 0 || (unsigned)slot >= depth_) continue;
        UOp &op = ops_[slot];
        if (!op.req) continue;     // ghost CQE for a leaked/fatal slot
        long res = (long)cqe[i].res;
        if (res < 0) {
          if (op.direct) {
            // e.g. -EINVAL: fs accepted the open but rejects direct
            // I/O — retry the whole chunk buffered
            op.direct = false;
            op.done = 0;
            push_locked(slot, lk);
          } else {
            retire_locked(slot, true);
          }
          continue;
        }
        if (res == 0) {             // EOF: no progress is possible —
          retire_locked(slot, true);  // error, like the thread pool
          continue;
        }
        op.done += res;
        if (op.done < op.len) {
          if (op.direct && (op.done % kAlign)) {  // unaligned remainder
            op.direct = false;
            op.done = 0;
          }
          push_locked(slot, lk);                  // short op: resubmit
        } else if (op.direct && !op.write) {
          drained.push_back(slot);   // bounce->user copy happens below,
        } else {                     // outside the lock
          retire_locked(slot, false);
        }
      }
      if (!drained.empty()) {
        lk.unlock();
        for (int slot : drained) {
          UOp &op = ops_[slot];      // slot still owned: safe unlocked
          std::memcpy(op.user, bounce_[slot], op.len);
        }
        lk.lock();
        for (int slot : drained) {
          ops_[slot].direct = false;     // copy already done
          retire_locked(slot, false);
          odirect_ops_.fetch_add(1);     // it DID go through O_DIRECT
        }
      }
    }
  }

  long block_size_;
  bool single_submit_, overlap_events_, use_odirect_;
  bool registered_ = false;
  unsigned depth_ = 0;
  unsigned npinned_ = 0;
  uring::Ring ring_;
  std::vector<UOp> ops_;
  std::vector<char *> bounce_;
  std::vector<int> free_slots_;
  std::thread reaper_;
  std::mutex mu_;
  std::condition_variable slot_cv_;
  std::mutex done_mu_;
  std::condition_variable done_cv_;
  std::atomic<int> pending_;
  std::atomic<int> errors_;
  std::atomic<long> odirect_ops_;
  std::atomic<long> tasks_total_;
  std::atomic<bool> dead_{false};
  std::atomic<bool> stop_{false};   // reaper shutdown flag (dtor sets it)
  int wake_fd_ = -1;                // eventfd: the dtor's wake of the reaper
  static constexpr int kMaxTries = 200;   // push_locked's bound
};

}  // namespace

extern "C" {

void *aio_create(int num_threads, long block_size) {
  return new AioPool(num_threads, block_size, 0, 0, 1, 0);
}

// full-knob constructor (reference: aio_handle ctor py_ds_aio.cpp:15)
void *aio_create2(int num_threads, long block_size, int queue_depth,
                  int single_submit, int overlap_events, int use_odirect) {
  return new AioPool(num_threads, block_size, queue_depth, single_submit,
                     overlap_events, use_odirect);
}

// backend-selecting constructor: use_uring 1 = io_uring (falls back to
// the thread pool when the kernel/sandbox refuses io_uring_setup),
// 0 = thread pool, -1 = auto (io_uring when available)
void *aio_create3(int num_threads, long block_size, int queue_depth,
                  int single_submit, int overlap_events, int use_odirect,
                  int use_uring) {
  bool want = use_uring == 1 || (use_uring == -1 && uring::available());
  if (want) {
    bool ok = false;
    auto *e = new UringEngine(block_size, queue_depth, single_submit,
                              overlap_events, use_odirect, &ok);
    if (ok) return e;
    delete e;
  }
  return new AioPool(num_threads, block_size, queue_depth, single_submit,
                     overlap_events, use_odirect);
}

int aio_backend(void *h) { return static_cast<Engine *>(h)->backend(); }

int aio_uring_available(void) { return uring::available() ? 1 : 0; }

void aio_destroy(void *h) { delete static_cast<Engine *>(h); }

// async chunked read/write; call aio_wait to drain
void aio_pread(void *h, const char *path, void *buf, long nbytes,
               long offset) {
  static_cast<Engine *>(h)->submit(path, static_cast<char *>(buf), nbytes,
                                   offset, false);
}

void aio_pwrite(void *h, const char *path, const void *buf, long nbytes,
                long offset) {
  static_cast<Engine *>(h)->submit(
      path, const_cast<char *>(static_cast<const char *>(buf)), nbytes,
      offset, true);
}

// full-file rewrite: truncates to offset+nbytes before queueing the chunks
void aio_pwrite_trunc(void *h, const char *path, const void *buf, long nbytes,
                      long offset) {
  static_cast<Engine *>(h)->submit(
      path, const_cast<char *>(static_cast<const char *>(buf)), nbytes,
      offset, true, true);
}

int aio_wait(void *h) { return static_cast<Engine *>(h)->wait(); }

int aio_pending(void *h) { return static_cast<Engine *>(h)->pending(); }

// observability: chunks that actually went through O_DIRECT / total chunks
long aio_odirect_ops(void *h) {
  return static_cast<Engine *>(h)->odirect_ops();
}
long aio_tasks_total(void *h) {
  return static_cast<Engine *>(h)->tasks_total();
}

// synchronous helpers (reference: aio_read/aio_write free functions)
int aio_sync_pread(void *h, const char *path, void *buf, long nbytes,
                   long offset) {
  aio_pread(h, path, buf, nbytes, offset);
  return aio_wait(h);
}

int aio_sync_pwrite(void *h, const char *path, const void *buf, long nbytes,
                    long offset) {
  aio_pwrite(h, path, buf, nbytes, offset);
  return aio_wait(h);
}

}  // extern "C"
