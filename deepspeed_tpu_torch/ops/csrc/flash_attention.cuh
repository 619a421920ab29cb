// Flash attention forward, dq and dk/dv on the tensor cores, for Hopper
// (sm_90a), templated on the 16-bit element type (bf16 or fp16) and the head
// dim.  flash_attention.cu instantiates the bf16 entry points and
// flash_attention_fp16.cu the fp16 ones (two sources, so that two nvcc
// processes build them side by side); flash_attention_fp32.cu holds the fp32
// kernels, which run on the CUDA cores.
//
// Replaces the three TPU kernels of deepspeed_tpu/ops/flash_attention.py:
//   flash_fwd  <- `_fwd_kernel` (:76, pallas_call in `_fwd` :137)
//   flash_dq   <- `_dq_kernel`  (:173, pallas_call in `_bwd` :283)
//   flash_dkv  <- `_dkv_kernel` (:212, pallas_call in `_bwd` :311)
//
// Which design runs which head dim (a dispatch by D in the entry points):
//   * fwd and dkv at every head dim (32, 64, 80, 96, 128, 256) and dq at
//     D <= 128: the wgmma / TMA / warp-specialised kernels of
//     flash_attention_sm90.cuh (see its note);
//   * dq at D 256: the WMMA kernel below.
// Layouts (all contiguous; T is the element type):
//   q, do, o, dq   [B, H,   S, D] T
//   k, v, dk, dv   [B, Hkv, S, D] T         (GQA: query head h reads KV head
//                                             h / rep, rep = H / Hkv)
//   lse, delta     [B, H,   S]    fp32      (delta = rowsum(dO * O))
//
// Numerics follow the TPU kernels: scores in fp32 (s = q.k * scale), masked
// entries set to -1e30 (causal: key column > query row), an online softmax
// in fp32 with the probabilities rounded to T (round to nearest even:
// __floats2bfloat162_rn / __floats2half2_rn) before the PV product, the
// final division by max(l, 1e-30), lse = m + log(max(l, 1e-30)); in the
// backward P = exp(s - lse), dS = P * (dP - delta) rounded to T before its
// products, dq = scale * dS K, dk = scale * dS^T Q, dv = P^T dO, all
// accumulated in fp32.  In fp16 a large loss scale can round dS (or an
// output) to inf; that is kept, as the TPU kernel keeps it, and the
// engine's overflow check skips the step.
//
// What bounds it on an H100 (3.35 TB/s, 989 TFLOP/s bf16/fp16 dense): at the
// shapes of training (S = 512..4096) the work per byte is ~S/2-fold, so the
// products bound it: fwd 2, dq 3, dkv 4 matrix products of B*H*S*S/2*D
// multiply-adds each (causal).
//
// The WMMA dq (D 256 only; dq at D <= 128 is flash90::dq_kernel): tiles of
// 64 query rows x 64 key rows, 4 warps per block, each warp owning 16 rows
// of the block's dq tile; one block per (q tile, head, batch), the loop
// over KV tiles (up to the diagonal when causal) in place of the TPU's
// sequential grid axis.  S = Q K^T and dP = dO V^T through WMMA (16x16x16,
// fp32 accumulate) into an fp32 tile in shared memory, P and dS on the CUDA
// cores (two lanes a row), dS rounded to T into shared memory, dQ += dS K
// in WMMA fragments (registers); no atomics.  Tiles past S are zero-filled
// and masked.  The wrapper zero-pads any other D <= 256 up to the next
// instantiated head dim.
//
// What bounds it: the products (3 of B*H*S*S/2*D multiply-adds, causal)
// against 989 TFLOP/s; on an H100 it reaches ~6% of that (57 TFLOP/s at
// gptj-6b's training shape, chip_smoke.py phase 3).  What it leaves on the table: no wgmma or TMA, no
// double-buffered K/V loads (a block waits on every tile), WMMA operands
// re-read from shared memory for every product, S and dP round-tripped
// through shared memory, 4 warps a block.  The wgmma dq's design does not
// carry over as it is: at D 256 a thread's dQ over 64 rows is 128 fp32
// registers, beside S and dP.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

#include "flash_attention_sm90.cuh"

namespace flash16 {

using namespace nvcuda;

constexpr int kThreads = 128;   // 4 warps, 16 tile rows each
constexpr int BQ = 64;          // query rows per tile
constexpr int BK = 64;          // key rows per tile
constexpr float kNegInf = -1e30f;

// the 16-bit element type: its pair type and round-to-nearest packing
template <typename T>
struct Elem;

template <>
struct Elem<__nv_bfloat16> {
  typedef __nv_bfloat162 T2;
  static __device__ __forceinline__ T2 pack(float a, float b) {
    return __floats2bfloat162_rn(a, b);
  }
};

template <>
struct Elem<__half> {
  typedef __half2 T2;
  static __device__ __forceinline__ T2 pack(float a, float b) {
    return __floats2half2_rn(a, b);
  }
};

template <typename T>
using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major>;
template <typename T>
using FragBt = wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::col_major>;
template <typename T>
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major>;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

// shared-memory strides (elements) and tile sizes (bytes, multiples of 128)
template <int D>
struct Layout {
  static_assert(D % 16 == 0 && D >= 16 && D <= 256, "head dim");
  static constexpr int LDH = D + 8;    // 16-bit q/k/v/do tile row
  static constexpr int LDS = BK + 4;   // fp32 score tile row (BQ == BK)
  static constexpr int LDP = BK + 8;   // 16-bit probability tile row
  static constexpr int LDO = D + 4;    // fp32 output / staging tile row
  static constexpr int TILE_H = 64 * LDH * 2;
  static constexpr int TILE_S = 64 * LDS * 4;
  static constexpr int TILE_P = 64 * LDP * 2;
  static constexpr int TILE_O = 64 * LDO * 4;
  static constexpr int DQ_SMEM = 4 * TILE_H + TILE_S + TILE_P;
  static_assert(TILE_O <= 2 * TILE_H, "staging must fit in two 16-bit tiles");
  static_assert(DQ_SMEM <= 232448, "shared memory of one block");
};

// 64 rows of D elements from global (row stride D) into shared memory (row
// stride D + 8); rows at or past rows_valid are zero-filled.
template <typename T, int D>
__device__ __forceinline__ void load_tile(T* dst, const T* __restrict__ src,
                                          int rows_valid) {
  constexpr int CH = D / 8;            // 16-byte chunks per row
  constexpr int LDH = Layout<D>::LDH;
  for (int c = threadIdx.x; c < 64 * CH; c += kThreads) {
    const int r = c / CH;
    const int col = (c % CH) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows_valid)
      val = *reinterpret_cast<const uint4*>(src + (size_t)r * D + col);
    *reinterpret_cast<uint4*>(dst + r * LDH + col) = val;
  }
}

// One warp: C[16 x 64] = A[16 x D] * B[64 x D]^T.  A and B are rows in
// shared memory (stride D + 8); C is fp32 in shared memory (stride 68).
template <typename T, int D>
__device__ __forceinline__ void strip_abt(const T* a, const T* b, float* c) {
  constexpr int LDH = Layout<D>::LDH;
  constexpr int LDS = Layout<D>::LDS;
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    FragC acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      FragA<T> fa;
      FragBt<T> fb;
      wmma::load_matrix_sync(fa, a + kk * 16, LDH);
      wmma::load_matrix_sync(fb, b + n * 16 * LDH + kk * 16, LDH);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(c + n * 16, acc, LDS, wmma::mem_row_major);
  }
}

// One warp: acc[16 x D] += P[16 x 64] * V[64 x D].  P (stride 72) and V
// (stride D + 8) are in shared memory.
template <typename T, int D>
__device__ __forceinline__ void strip_ab_acc(const T* p, const T* v,
                                             FragC (&acc)[D / 16]) {
  constexpr int LDH = Layout<D>::LDH;
  constexpr int LDP = Layout<D>::LDP;
  FragA<T> fa[4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wmma::load_matrix_sync(fa[kk], p + kk * 16, LDP);
#pragma unroll
  for (int n = 0; n < D / 16; ++n) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      FragB<T> fb;
      wmma::load_matrix_sync(fb, v + kk * 16 * LDH + n * 16, LDH);
      wmma::mma_sync(acc[n], fa[kk], fb, acc[n]);
    }
  }
}

// ---------------------------------------------------------------------------
// backward: dq
// ---------------------------------------------------------------------------

template <typename T, int D, bool CAUSAL>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                T* __restrict__ dq, int H, int Hkv, int S, float scale) {
  using L = Layout<D>;
  typedef typename Elem<T>::T2 T2;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* dOs = reinterpret_cast<T*>(smem + L::TILE_H);
  T* Ks = reinterpret_cast<T*>(smem + 2 * L::TILE_H);
  T* Vs = reinterpret_cast<T*>(smem + 3 * L::TILE_H);
  float* Ss = reinterpret_cast<float*>(smem + 4 * L::TILE_H);
  T* dSs = reinterpret_cast<T*>(smem + 4 * L::TILE_H + L::TILE_S);

  const int n_q = (S + BQ - 1) / BQ;
  const int n_k = (S + BK - 1) / BK;
  const int i = n_q - 1 - (int)blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / (H / Hkv);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r = warp * 16 + (lane >> 1);
  const int half = lane & 1;
  const int qrow = i * BQ + r;
  const bool row_ok = qrow < S;

  const size_t bh = (size_t)b * H + h;
  const size_t bg = (size_t)b * Hkv + g;
  const T* kb = k + bg * S * D;
  const T* vb = v + bg * S * D;
  const int qrows = min(BQ, S - i * BQ);
  load_tile<T, D>(Qs, q + (bh * S + (size_t)i * BQ) * D, qrows);
  load_tile<T, D>(dOs, dout + (bh * S + (size_t)i * BQ) * D, qrows);
  const float lse_r = row_ok ? lse[bh * S + qrow] : 0.f;
  const float delta_r = row_ok ? delta[bh * S + qrow] : 0.f;

  FragC acc[D / 16];
#pragma unroll
  for (int n = 0; n < D / 16; ++n) wmma::fill_fragment(acc[n], 0.f);

  float* sstrip = Ss + warp * 16 * L::LDS;
  const float* srow = Ss + r * L::LDS + half * 32;
  T* dsrow = dSs + r * L::LDP + half * 32;
  const int j_last = CAUSAL ? min((i * BQ + BQ - 1) / BK, n_k - 1) : n_k - 1;
  for (int j = 0; j <= j_last; ++j) {
    __syncthreads();
    const int rows = min(BK, S - j * BK);
    load_tile<T, D>(Ks, kb + (size_t)j * BK * D, rows);
    load_tile<T, D>(Vs, vb + (size_t)j * BK * D, rows);
    __syncthreads();

    strip_abt<T, D>(Qs + warp * 16 * L::LDH, Ks, sstrip);   // S = Q K^T
    __syncwarp();
    const int col0 = j * BK + half * 32;
    float p[32];
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const int col = col0 + c;
      const bool ok = row_ok && col < S && !(CAUSAL && col > qrow);
      p[c] = ok ? __expf(srow[c] * scale - lse_r) : 0.f;
    }
    __syncwarp();
    strip_abt<T, D>(dOs + warp * 16 * L::LDH, Vs, sstrip);  // dP = dO V^T
    __syncwarp();
#pragma unroll
    for (int c = 0; c < 32; c += 2)
      *reinterpret_cast<T2*>(dsrow + c) = Elem<T>::pack(
          p[c] * (srow[c] - delta_r), p[c + 1] * (srow[c + 1] - delta_r));
    __syncwarp();
    strip_ab_acc<T, D>(dSs + warp * 16 * L::LDP, Ks, acc);   // dQ += dS K
  }

  __syncthreads();                            // K/V tiles become the stage
  float* stage = reinterpret_cast<float*>(Ks);
#pragma unroll
  for (int n = 0; n < D / 16; ++n)
    wmma::store_matrix_sync(stage + warp * 16 * L::LDO + n * 16, acc[n], L::LDO,
                            wmma::mem_row_major);
  __syncwarp();
  if (row_ok) {
    const float* srow_o = stage + r * L::LDO + half * (D / 2);
    T* dg = dq + (bh * S + qrow) * D + half * (D / 2);
#pragma unroll
    for (int d = 0; d < D / 2; d += 2)
      *reinterpret_cast<T2*>(dg + d) =
          Elem<T>::pack(srow_o[d] * scale, srow_o[d + 1] * scale);
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

template <typename T, int D, bool C>
cudaError_t dq_launch(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dq, int B, int H, int Hkv, int S, float scale,
                      cudaStream_t st) {
  static_assert(D == 256, "D <= 128 runs flash90::dq_kernel");
  const int smem = Layout<D>::DQ_SMEM;
  cudaError_t e = cudaFuncSetAttribute(
      flash_dq_kernel<T, D, C>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_dq_kernel<T, D, C><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), H, Hkv, S, scale);
  return cudaGetLastError();
}

inline bool bad_shape(int B, int H, int Hkv, int S) {
  return B < 1 || S < 1 || Hkv < 1 || H < Hkv || H % Hkv != 0 ||
         B > 65535 || H > 65535;
}

// f(std::integral_constant<int, D>{}) for an instantiated head dim
template <typename F>
cudaError_t with_head_dim(int D, F&& f) {
  switch (D) {
    case 32: return f(std::integral_constant<int, 32>{});
    case 64: return f(std::integral_constant<int, 64>{});
    case 80: return f(std::integral_constant<int, 80>{});
    case 96: return f(std::integral_constant<int, 96>{});
    case 128: return f(std::integral_constant<int, 128>{});
    case 256: return f(std::integral_constant<int, 256>{});
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
int fwd_entry(const void* q, const void* k, const void* v, void* o, void* lse,
              int B, int H, int Hkv, int S, int D, float scale, int causal,
              void* stream) {
  if (bad_shape(B, H, Hkv, S)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)with_head_dim(D, [&](auto d) {
    constexpr int DD = decltype(d)::value;
    return causal
        ? flash90::fwd_launch<T, DD, true>(q, k, v, o, lse, B, H, Hkv, S, scale, st)
        : flash90::fwd_launch<T, DD, false>(q, k, v, o, lse, B, H, Hkv, S, scale, st);
  });
}

template <typename T>
int dq_entry(const void* q, const void* k, const void* v, const void* dout,
             const void* lse, const void* delta, void* dq, int B, int H,
             int Hkv, int S, int D, float scale, int causal, void* stream) {
  if (bad_shape(B, H, Hkv, S)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)with_head_dim(D, [&](auto d) {
    constexpr int DD = decltype(d)::value;
    if constexpr (DD == 256)
      return causal
          ? dq_launch<T, DD, true>(q, k, v, dout, lse, delta, dq, B, H, Hkv, S, scale, st)
          : dq_launch<T, DD, false>(q, k, v, dout, lse, delta, dq, B, H, Hkv, S, scale, st);
    else
      return causal
          ? flash90::dq_launch<T, DD, true>(q, k, v, dout, lse, delta, dq, B, H, Hkv,
                                            S, scale, st)
          : flash90::dq_launch<T, DD, false>(q, k, v, dout, lse, delta, dq, B, H, Hkv,
                                             S, scale, st);
  });
}

template <typename T>
int dkv_entry(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dk, void* dv, int B,
              int H, int Hkv, int S, int D, float scale, int causal,
              void* stream) {
  if (bad_shape(B, H, Hkv, S)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)with_head_dim(D, [&](auto d) {
    constexpr int DD = decltype(d)::value;
    return causal
        ? flash90::dkv_launch<T, DD, true>(q, k, v, dout, lse, delta, dk, dv, B, H,
                                           Hkv, S, scale, st)
        : flash90::dkv_launch<T, DD, false>(q, k, v, dout, lse, delta, dk, dv, B, H,
                                            Hkv, S, scale, st);
  });
}

}  // namespace flash16

// The C entry points of one element type: flash_{fwd,dq,dkv}_<tag>.  Each
// returns cudaGetLastError() after its launch (0 on success); they launch on
// `stream` and do not synchronise.
#define FLASH16_ENTRY_POINTS(tag, T)                                          \
  extern "C" int flash_fwd_##tag(const void* q, const void* k, const void* v, \
                                 void* o, void* lse, int B, int H, int Hkv,   \
                                 int S, int D, float scale, int causal,       \
                                 void* stream) {                              \
    return flash16::fwd_entry<T>(q, k, v, o, lse, B, H, Hkv, S, D, scale,     \
                                 causal, stream);                             \
  }                                                                           \
  extern "C" int flash_dq_##tag(const void* q, const void* k, const void* v,  \
                                const void* dout, const void* lse,            \
                                const void* delta, void* dq, int B, int H,    \
                                int Hkv, int S, int D, float scale,           \
                                int causal, void* stream) {                   \
    return flash16::dq_entry<T>(q, k, v, dout, lse, delta, dq, B, H, Hkv, S,  \
                                D, scale, causal, stream);                    \
  }                                                                           \
  extern "C" int flash_dkv_##tag(const void* q, const void* k, const void* v, \
                                 const void* dout, const void* lse,           \
                                 const void* delta, void* dk, void* dv,       \
                                 int B, int H, int Hkv, int S, int D,         \
                                 float scale, int causal, void* stream) {     \
    return flash16::dkv_entry<T>(q, k, v, dout, lse, delta, dk, dv, B, H,     \
                                 Hkv, S, D, scale, causal, stream);           \
  }
