// io_uring submission engine for the port's aio library (a copy of
// deepspeed_tpu/native/uring.h) — the DeepNVMe/libaio
// analog with a REAL kernel queue depth (reference:
// csrc/aio/py_lib/deepspeed_aio_thread.cpp drives libaio's
// io_submit/io_getevents; here the same role is played by io_uring,
// which supersedes libaio on modern kernels).
//
// Raw-syscall implementation (no liburing in the image): ring setup +
// mmap, SQE fill, io_uring_enter submit/reap.  Design:
//   * ONE ring of `queue_depth` entries; chunk submission blocks when
//     every kernel slot is in flight — queue_depth is the actual number
//     of I/Os the kernel juggles, not a user-space backpressure couter.
//   * a dedicated reaper thread waits for CQEs, handles short
//     reads/writes by resubmitting the remainder, and retires ops.
//   * O_DIRECT chunks use REGISTERED buffers (IORING_REGISTER_BUFFERS)
//     with IORING_OP_{READ,WRITE}_FIXED — one pinned aligned buffer per
//     ring slot, mapped once at init, the io_uring counterpart of the
//     reference's pinned-tensor pool (deepspeed_pin_tensor.cpp).
//   * filesystems that reject O_DIRECT (tmpfs) fall back per-op to the
//     buffered fd, same policy as the thread-pool engine.

#pragma once

#include <atomic>
#include <condition_variable>
#include <cstring>
#include <fcntl.h>
#include <linux/io_uring.h>
#include <memory>
#include <mutex>
#include <sys/mman.h>
#include <sys/syscall.h>
#include <sys/uio.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace uring {

inline int sys_setup(unsigned entries, struct io_uring_params *p) {
  return (int)syscall(__NR_io_uring_setup, entries, p);
}
inline int sys_enter(int fd, unsigned to_submit, unsigned min_complete,
                     unsigned flags) {
  return (int)syscall(__NR_io_uring_enter, fd, to_submit, min_complete,
                      flags, nullptr, 0);
}
inline int sys_register(int fd, unsigned opcode, const void *arg,
                        unsigned nr_args) {
  return (int)syscall(__NR_io_uring_register, fd, opcode, arg, nr_args);
}

// true iff the kernel/sandbox allows io_uring AND supports the opcodes
// the engine issues (IORING_OP_READ/WRITE and the _FIXED variants are
// 5.6+; io_uring_setup alone succeeds on 5.1-5.5 where they would all
// complete -EINVAL).  IORING_REGISTER_PROBE is itself 5.6+, so probe
// failure means "too old" either way.
inline bool available() {
  struct io_uring_params p;
  std::memset(&p, 0, sizeof(p));
  int fd = sys_setup(2, &p);
  if (fd < 0) return false;
  constexpr unsigned kOps = IORING_OP_WRITE + 1;
  char raw[sizeof(struct io_uring_probe) +
           kOps * sizeof(struct io_uring_probe_op)];
  std::memset(raw, 0, sizeof(raw));
  auto *probe = reinterpret_cast<struct io_uring_probe *>(raw);
  bool ok = sys_register(fd, IORING_REGISTER_PROBE, probe, kOps) == 0 &&
            probe->last_op >= IORING_OP_WRITE;
  if (ok) {
    auto supported = [&](unsigned op) {
      return (probe->ops[op].flags & IO_URING_OP_SUPPORTED) != 0;
    };
    ok = supported(IORING_OP_READ) && supported(IORING_OP_WRITE) &&
         supported(IORING_OP_READ_FIXED) &&
         supported(IORING_OP_WRITE_FIXED) && supported(IORING_OP_NOP);
  }
  close(fd);
  return ok;
}

// mmap'd ring state (raw pointers into the shared kernel mappings)
struct Ring {
  int fd = -1;
  unsigned entries = 0;
  // SQ
  std::atomic<unsigned> *sq_head = nullptr, *sq_tail = nullptr;
  unsigned sq_mask = 0;
  unsigned *sq_array = nullptr;
  struct io_uring_sqe *sqes = nullptr;
  // CQ
  std::atomic<unsigned> *cq_head = nullptr, *cq_tail = nullptr;
  unsigned cq_mask = 0;
  struct io_uring_cqe *cqes = nullptr;
  void *sq_ptr = nullptr, *cq_ptr = nullptr, *sqe_ptr = nullptr;
  size_t sq_sz = 0, cq_sz = 0, sqe_sz = 0;

  bool init(unsigned depth) {
    struct io_uring_params p;
    std::memset(&p, 0, sizeof(p));
    fd = sys_setup(depth, &p);
    if (fd < 0) return false;
    entries = p.sq_entries;
    sq_sz = p.sq_off.array + p.sq_entries * sizeof(unsigned);
    cq_sz = p.cq_off.cqes + p.cq_entries * sizeof(struct io_uring_cqe);
    bool single = p.features & IORING_FEAT_SINGLE_MMAP;
    if (single) sq_sz = cq_sz = (sq_sz > cq_sz ? sq_sz : cq_sz);
    sq_ptr = mmap(nullptr, sq_sz, PROT_READ | PROT_WRITE,
                  MAP_SHARED | MAP_POPULATE, fd, IORING_OFF_SQ_RING);
    if (sq_ptr == MAP_FAILED) return false;
    cq_ptr = single ? sq_ptr
                    : mmap(nullptr, cq_sz, PROT_READ | PROT_WRITE,
                           MAP_SHARED | MAP_POPULATE, fd,
                           IORING_OFF_CQ_RING);
    if (cq_ptr == MAP_FAILED) return false;
    sqe_sz = p.sq_entries * sizeof(struct io_uring_sqe);
    sqe_ptr = mmap(nullptr, sqe_sz, PROT_READ | PROT_WRITE,
                   MAP_SHARED | MAP_POPULATE, fd, IORING_OFF_SQES);
    if (sqe_ptr == MAP_FAILED) return false;
    auto b = static_cast<char *>(sq_ptr);
    sq_head = reinterpret_cast<std::atomic<unsigned> *>(b + p.sq_off.head);
    sq_tail = reinterpret_cast<std::atomic<unsigned> *>(b + p.sq_off.tail);
    sq_mask = *reinterpret_cast<unsigned *>(b + p.sq_off.ring_mask);
    sq_array = reinterpret_cast<unsigned *>(b + p.sq_off.array);
    auto c = static_cast<char *>(cq_ptr);
    cq_head = reinterpret_cast<std::atomic<unsigned> *>(c + p.cq_off.head);
    cq_tail = reinterpret_cast<std::atomic<unsigned> *>(c + p.cq_off.tail);
    cq_mask = *reinterpret_cast<unsigned *>(c + p.cq_off.ring_mask);
    cqes = reinterpret_cast<struct io_uring_cqe *>(c + p.cq_off.cqes);
    sqes = static_cast<struct io_uring_sqe *>(sqe_ptr);
    return true;
  }

  // caller serializes; returns false when the SQ is full
  bool push(const struct io_uring_sqe &sqe) {
    unsigned head = sq_head->load(std::memory_order_acquire);
    unsigned tail = sq_tail->load(std::memory_order_relaxed);
    if (tail - head >= entries) return false;
    unsigned idx = tail & sq_mask;
    sqes[idx] = sqe;
    sq_array[idx] = idx;
    sq_tail->store(tail + 1, std::memory_order_release);
    return true;
  }

  // caller serializes; returns number of CQEs popped into out[]
  int pop(struct io_uring_cqe *out, int max) {
    unsigned head = cq_head->load(std::memory_order_relaxed);
    unsigned tail = cq_tail->load(std::memory_order_acquire);
    int n = 0;
    while (head != tail && n < max) {
      out[n++] = cqes[head & cq_mask];
      ++head;
    }
    cq_head->store(head, std::memory_order_release);
    return n;
  }

  ~Ring() {
    if (sqe_ptr && sqe_ptr != MAP_FAILED) munmap(sqe_ptr, sqe_sz);
    if (cq_ptr && cq_ptr != MAP_FAILED && cq_ptr != sq_ptr)
      munmap(cq_ptr, cq_sz);
    if (sq_ptr && sq_ptr != MAP_FAILED) munmap(sq_ptr, sq_sz);
    if (fd >= 0) close(fd);
  }
};

}  // namespace uring
