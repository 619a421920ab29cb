// Mixed-input GEMM for Hopper (sm_90a): bf16 activations x int8 or packed
// int4 weights, dequantized in shared memory, fp32 accumulation.
//
// Replaces the TPU kernels `_mixed_kernel` (int8, launched by
// `mixed_matmul_2d`, pallas_call at :109) and `_mixed4_kernel` (int4,
// `mixed4_matmul_2d`, :176) of deepspeed_tpu/ops/mixed_gemm.py:
//
//   int8:  out[M, N] = x[M, K] @ (code[K, N] * s[K])
//   int4:  packed[K/2, N] bytes; byte row j holds contraction row j in its
//          low nibble and row j + K/2 in its high nibble (sign-extended
//          4-bit two's complement), so
//          out = x[:, :K/2] @ (lo * s[:K/2]) + x[:, K/2:] @ (hi * s[K/2:])
//
//   x bf16 [M, K] row-major; s fp32 [K] (scales coarser than one per row
//   are expanded to [K] by the wrapper); out bf16 or fp32 [M, N].
//
// Numerics follow the TPU kernel: each weight is dequantized as
// bf16(float(code) * float(bf16(s[k]))) -- the reference multiplies the
// code and the scale in bf16, and the product of an int8 code and a bf16
// scale is exact in fp32, so one rounding gives the same bits -- x is
// bf16, and the dot products accumulate in fp32 on the tensor cores.
//
// What bounds it on an H100 (3.35 TB/s, 989 TFLOP/s bf16 dense):
//   * decode (M = 8): the weight bytes, 1 (int8) or 1/2 (int4) byte per
//     weight; the point of the layout is that only those bytes cross HBM.
//   * prefill (M = 1024): the flops, 2 M K N.
//
// Design (simple first): one block of 128 threads (4 warps) per BM x BN
// output tile; BM from M (16, 32, 64 or 128, so a decode step does not
// spend a 128-row tile on 8 rows), BN = 64 for BM <= 32 and 128 above.
// The block walks K in chunks of 32 weight rows: the x chunk is copied to
// shared memory (16-byte loads), the weight chunk is read with 16-byte
// loads coalesced along N, dequantized by the loading thread and stored
// as bf16 in shared memory; the warps then run WMMA bf16 16x16x16
// products into fp32 fragments (each warp a (BM/WARPS_M) x (BN/WARPS_N)
// sub-tile).  For int4 a chunk is 32 packed rows, i.e. two 32-row
// contraction chunks (one per half) with their own x chunks and scales.
// The epilogue stages each fragment through a per-warp 16x16 fp32 tile
// and writes out_dtype with rows past M masked.
//
// What this design leaves on the table (work for later): no cp.async /
// TMA double buffering of the chunks (loads and products do not overlap),
// no wgmma, no split over K for decode (a decode step of a 1024-wide
// projection launches only 16 blocks on 132 SMs).
//
// Supported: K % 32 == 0 (int8) or K % 64 == 0 (int4), N % 16 == 0,
// 16-byte aligned x, weights and out.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int BK = 32;          // weight rows (bytes rows for int4) per chunk
constexpr int XPAD = 8;         // bf16 padding per shared-memory row
constexpr int WPAD = 8;

template <int BM>
struct Tile {
  static constexpr int BN = BM <= 32 ? 64 : 128;
  static constexpr int WARPS_M = BM >= 32 ? 2 : 1;
  static constexpr int WARPS_N = kWarps / WARPS_M;
  static constexpr int WM = BM / WARPS_M;
  static constexpr int WN = BN / WARPS_N;
  static constexpr int FM = WM / 16;
  static constexpr int FN = WN / 16;
  static_assert(FM >= 1 && FN >= 1, "warp tile below one fragment");
};

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ void store_out(float* dst, float v) { *dst = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* dst, float v) {
  *dst = __float2bfloat16_rn(v);
}

template <int BM, bool INT4, typename OutT>
__global__ void __launch_bounds__(kThreads)
mixed_gemm_kernel(const __nv_bfloat16* __restrict__ x,
                  const int8_t* __restrict__ w, const float* __restrict__ s,
                  OutT* __restrict__ out, int M, int K, int N) {
  using T = Tile<BM>;
  constexpr int BN = T::BN;
  constexpr int NH = INT4 ? 2 : 1;     // contraction halves per chunk
  __shared__ __align__(32) __nv_bfloat16 xs[NH][BM][BK + XPAD];
  __shared__ __align__(32) __nv_bfloat16 ws[NH][BK][BN + WPAD];
  __shared__ float ss[NH][BK];
  __shared__ __align__(32) float cs[kWarps][16 * 16];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int wm = warp / T::WARPS_N;
  const int wn = warp % T::WARPS_N;
  const int Kw = INT4 ? K / 2 : K;     // weight rows in memory
  const int half = K / 2;              // x / s offset of the hi half

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[T::FM][T::FN];
#pragma unroll
  for (int i = 0; i < T::FM; ++i)
#pragma unroll
    for (int j = 0; j < T::FN; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < Kw; k0 += BK) {
    // 1. this chunk's scales (rounded to bf16, as the reference feeds
    //    them) and x rows; rows past M are zero
    for (int i = tid; i < NH * BK; i += kThreads) {
      const int h = i / BK, r = i % BK;
      ss[h][r] = bf16_round(s[h * half + k0 + r]);
    }
    constexpr int XV = BK / 8;         // 16-byte loads per x row
    for (int i = tid; i < NH * BM * XV; i += kThreads) {
      const int h = i / (BM * XV);
      const int rem = i % (BM * XV);
      const int r = rem / XV, c = (rem % XV) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (m0 + r < M)
        v = *reinterpret_cast<const uint4*>(
            x + (size_t)(m0 + r) * K + h * half + k0 + c);
      *reinterpret_cast<uint4*>(&xs[h][r][c]) = v;
    }
    __syncthreads();

    // 2. the weight chunk: 16 codes per thread per load, dequantized into
    //    shared memory as bf16; columns past N are zero
    constexpr int WV = BN / 16;
    for (int i = tid; i < BK * WV; i += kThreads) {
      const int r = i / WV, c = (i % WV) * 16;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (n0 + c < N)
        v = *reinterpret_cast<const uint4*>(w + (size_t)(k0 + r) * N + n0 + c);
      const int8_t* b = reinterpret_cast<const int8_t*>(&v);
      __align__(16) __nv_bfloat16 lo[16];
      if constexpr (INT4) {
        __align__(16) __nv_bfloat16 hi[16];
        const float s_lo = ss[0][r], s_hi = ss[1][r];
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int byte = b[j];
          const int l = (int)((unsigned)byte << 28) >> 28;   // sign-extend
          const int h = byte >> 4;                           // arithmetic
          lo[j] = __float2bfloat16_rn((float)l * s_lo);
          hi[j] = __float2bfloat16_rn((float)h * s_hi);
        }
        uint4* dst = reinterpret_cast<uint4*>(&ws[1][r][c]);
        dst[0] = reinterpret_cast<const uint4*>(hi)[0];
        dst[1] = reinterpret_cast<const uint4*>(hi)[1];
      } else {
        const float sc = ss[0][r];
#pragma unroll
        for (int j = 0; j < 16; ++j)
          lo[j] = __float2bfloat16_rn((float)b[j] * sc);
      }
      uint4* dst = reinterpret_cast<uint4*>(&ws[0][r][c]);
      dst[0] = reinterpret_cast<const uint4*>(lo)[0];
      dst[1] = reinterpret_cast<const uint4*>(lo)[1];
    }
    __syncthreads();

    // 3. tensor-core products of the chunk
#pragma unroll
    for (int h = 0; h < NH; ++h) {
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> a[T::FM];
#pragma unroll
        for (int i = 0; i < T::FM; ++i)
          wmma::load_matrix_sync(a[i], &xs[h][wm * T::WM + i * 16][kk],
                                 BK + XPAD);
#pragma unroll
        for (int j = 0; j < T::FN; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major> bf;
          wmma::load_matrix_sync(bf, &ws[h][kk][wn * T::WN + j * 16],
                                 BN + WPAD);
#pragma unroll
          for (int i = 0; i < T::FM; ++i)
            wmma::mma_sync(acc[i][j], a[i], bf, acc[i][j]);
        }
      }
    }
    __syncthreads();                   // the chunk's tiles are rewritten next
  }

  // epilogue: one fragment at a time through this warp's 16x16 fp32 tile;
  // lane l writes 8 values of row l / 2 (N % 16 == 0: a fragment's columns
  // are all inside N or all outside)
  float* c = cs[warp];
  const int r = lane / 2, cc = (lane % 2) * 8;
#pragma unroll
  for (int i = 0; i < T::FM; ++i) {
#pragma unroll
    for (int j = 0; j < T::FN; ++j) {
      wmma::store_matrix_sync(c, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int gm = m0 + wm * T::WM + i * 16 + r;
      const int gn = n0 + wn * T::WN + j * 16 + cc;
      if (gm < M && gn < N) {
        OutT* dst = out + (size_t)gm * N + gn;
#pragma unroll
        for (int e = 0; e < 8; ++e) store_out(dst + e, c[r * 16 + cc + e]);
      }
      __syncwarp();
    }
  }
}

template <int BM, bool INT4, typename OutT>
cudaError_t launch(const void* x, const void* w, const void* s, void* out,
                   int M, int K, int N, cudaStream_t stream) {
  constexpr int BN = Tile<BM>::BN;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  mixed_gemm_kernel<BM, INT4, OutT><<<grid, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(s), static_cast<OutT*>(out), M, K, N);
  return cudaGetLastError();
}

template <bool INT4, typename OutT>
cudaError_t launch_bm(int block_m, const void* x, const void* w,
                      const void* s, void* out, int M, int K, int N,
                      cudaStream_t stream) {
  switch (block_m) {
    case 16: return launch<16, INT4, OutT>(x, w, s, out, M, K, N, stream);
    case 32: return launch<32, INT4, OutT>(x, w, s, out, M, K, N, stream);
    case 64: return launch<64, INT4, OutT>(x, w, s, out, M, K, N, stream);
    case 128: return launch<128, INT4, OutT>(x, w, s, out, M, K, N, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// out = x @ dequant(w, s).  int4 != 0: w is the packed [K/2, N] layout.
// out_f32 != 0: out is fp32, else bf16.  block_m in {16, 32, 64, 128}.
// Returns cudaGetLastError() after the launch (0 on success); launches on
// `stream` and does not synchronise.
extern "C" int mixed_gemm(const void* x, const void* w, const void* s,
                          void* out, int M, int K, int N, int int4,
                          int out_f32, int block_m, void* stream) {
  if (M == 0 || N == 0) return 0;
  if (M < 0 || K <= 0 || N < 0 || N % 16 != 0 ||
      K % (int4 ? 2 * BK : BK) != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (int4) {
    err = out_f32 ? launch_bm<true, float>(block_m, x, w, s, out, M, K, N, st)
                  : launch_bm<true, __nv_bfloat16>(block_m, x, w, s, out, M,
                                                   K, N, st);
  } else {
    err = out_f32 ? launch_bm<false, float>(block_m, x, w, s, out, M, K, N, st)
                  : launch_bm<false, __nv_bfloat16>(block_m, x, w, s, out, M,
                                                    K, N, st);
  }
  return (int)err;
}
