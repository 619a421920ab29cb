// Hopper (sm_90a) building blocks in inline PTX: mbarriers, named barriers,
// TMA tile loads and bulk copies, wgmma shared-memory descriptors and
// fences, setmaxnreg, and the host-side encoding of TMA tensor maps.
// Shared by the kernels that use wgmma and TMA (flash_attention_sm90.cuh,
// mixed_gemm.cu); the wgmma instructions themselves are in sm90_wgmma.cuh.
//
// Shared-memory tiles ("boxes"): a tile of R rows x C 16-bit columns is
// held as C / BW boxes of R rows x BW columns, each box R * BW * 2 bytes,
// written by one TMA load with the swizzle of its row width (BW = 64: 128
// bytes, 32: 64 bytes, 16: 32 bytes).  Every head dim the kernels take
// (32, 64, 80, 96, 128) is a whole number of boxes of one width
// (box_width<D>), so one descriptor form serves every D:
//   * K-major operand (the reduction dim along the row): the k-th group of
//     16 columns is box (16 k) / BW at byte offset ((16 k) % BW) * 2 within
//     the row; 8-row groups are SBO = 8 * BW * 2 bytes apart.
//   * MN-major operand (the output dim N along the row, N = C): 16 rows of
//     the reduction dim start at row 16 k; boxes (BW-wide blocks of N) are
//     LBO = R * BW * 2 bytes apart, 8-row groups SBO = 8 * BW * 2.
// Boxes are aligned to 1024 bytes, so every swizzle atom starts aligned
// and the descriptors' base offset is 0.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <cudaTypedefs.h>
#include <stdint.h>

namespace sm90 {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// --- mbarriers ---------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// --- TMA ---------------------------------------------------------------------

// a box of a 3-d tensor map at coordinates (c0 innermost, c1, c2) into
// shared memory; completion counts its bytes on `bar`
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// a box of a 2-d tensor map at coordinates (c0 innermost, c1)
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// `bytes` contiguous bytes (a multiple of 16; both ends 16-byte aligned)
// from global memory; completion counts them on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// this thread's shared-memory writes become visible to the async proxy
// (a wgmma that reads them), once the threads also meet at a barrier
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// --- wgmma -------------------------------------------------------------------

// swizzle of a box BW 16-bit columns wide, in the descriptor's encoding
// (1: 128 bytes, 2: 64, 3: 32) and in the tensor map's
template <int BW>
struct Swizzle;
template <>
struct Swizzle<64> {
  static constexpr uint64_t desc = 1;
  static constexpr CUtensorMapSwizzle map = CU_TENSOR_MAP_SWIZZLE_128B;
};
template <>
struct Swizzle<32> {
  static constexpr uint64_t desc = 2;
  static constexpr CUtensorMapSwizzle map = CU_TENSOR_MAP_SWIZZLE_64B;
};
template <>
struct Swizzle<16> {
  static constexpr uint64_t desc = 3;
  static constexpr CUtensorMapSwizzle map = CU_TENSOR_MAP_SWIZZLE_32B;
};

// the widest box that tiles D: 64 for D % 64 == 0, else 32, else 16
template <int D>
__host__ __device__ constexpr int box_width() {
  return D % 64 == 0 ? 64 : (D % 32 == 0 ? 32 : 16);
}

// a wgmma shared-memory matrix descriptor (start address, leading and
// stride byte offsets, swizzle mode; base offset 0)
template <int BW>
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (Swizzle<BW>::desc << 62);
}

// K-major operand: columns [16 k, 16 k + 16) of rows [row0, row0 + 64 or
// N) of a boxed tile whose boxes are box_bytes apart
template <int BW>
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t tile, int box_bytes,
                                                int row0, int k) {
  const int col = 16 * k;
  const uint32_t a =
      tile + (col / BW) * box_bytes + row0 * BW * 2 + (col % BW) * 2;
  return make_desc<BW>(a, 16, 8 * BW * 2);
}

// MN-major operand: rows [16 k, 16 k + 16) (the reduction dim) of a boxed
// tile, all of its columns (N)
template <int BW>
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t tile, int box_bytes,
                                                 int k) {
  return make_desc<BW>(tile + 16 * k * BW * 2, box_bytes, 8 * BW * 2);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving accesses of accumulator registers across
// the asynchronous wgmma that owns them
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// named barrier `id` (1-15; 0 is __syncthreads) over `threads` threads:
// sync waits for them all, arrive counts this warp and goes on
__device__ __forceinline__ void named_bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void named_bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// --- register allocation ------------------------------------------------------

template <int R>
__device__ __forceinline__ void regs_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void regs_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// --- host: tensor maps ----------------------------------------------------------

// cuTensorMapEncodeTiled, looked up through the CUDA runtime (no link
// against libcuda); null where libcuda lacks it
inline PFN_cuTensorMapEncodeTiled_v12000 encode_fn() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }();
  return fn;
}

// the map of a contiguous 16-bit [planes, rows, cols] tensor, read in boxes
// of box_rows x BW columns (one plane); rows past `rows` read as zeros
template <int BW>
inline cudaError_t make_map_3d(CUtensorMap* map, const void* base, bool fp16,
                               int cols, int rows, int planes, int box_rows) {
  auto fn = encode_fn();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows,
                              (cuuint64_t)planes};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * 2,
                                 (cuuint64_t)cols * rows * 2};
  const cuuint32_t box[3] = {(cuuint32_t)BW, (cuuint32_t)box_rows, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  CUresult r = fn(map,
                  fp16 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                  3, const_cast<void*>(base), dims, strides, box, estr,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, Swizzle<BW>::map,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// the map of a contiguous row-major [rows, cols] tensor of `dtype`
// (elem_bytes each; a row's bytes a multiple of 16), read in boxes of
// box_rows x box_cols with `swizzle`; elements out of bounds read as zeros
inline cudaError_t make_map_2d(CUtensorMap* map, const void* base,
                               CUtensorMapDataType dtype, int elem_bytes,
                               int cols, int rows, int box_cols, int box_rows,
                               CUtensorMapSwizzle swizzle) {
  auto fn = encode_fn();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * elem_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t estr[2] = {1, 1};
  CUresult r = fn(map, dtype, 2, const_cast<void*>(base), dims, strides, box,
                  estr, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace sm90
