// Flash attention forward, dq and dk/dv in fp32 for Hopper (sm_90a), on the
// CUDA cores.
//
// Replaces the three TPU kernels of deepspeed_tpu/ops/flash_attention.py
// for fp32 inputs (the precision of training with neither bf16 nor fp16):
//   flash_fwd_fp32  <- `_fwd_kernel` (:76, pallas_call in `_fwd` :137)
//   flash_dq_fp32   <- `_dq_kernel`  (:173, pallas_call in `_bwd` :283)
//   flash_dkv_fp32  <- `_dkv_kernel` (:212, pallas_call in `_bwd` :311)
//
// Layouts, masking, the online softmax and the backward's recomputation are
// those of flash_attention.cuh (the tensor-core kernels of bf16 and fp16):
//   q, do, o, dq   [B, H,   S, D] fp32
//   k, v, dk, dv   [B, Hkv, S, D] fp32      (GQA: rep = H / Hkv)
//   lse, delta     [B, H,   S]    fp32
// Every product is fp32 multiply-adds (fmaf), so the result is what the TPU
// kernel (and the plain version) computes in fp32: no TF32, whose 10
// mantissa bits would be another result.  Rounding P and dS "to the input
// dtype" is the identity here.  exp and log are the accurate expf / logf.
//
// What bounds it on an H100: the products, on the CUDA cores (67 TFLOP/s
// fp32 dense, not the tensor cores): fwd 2, dq 3, dkv 4 matrix products of
// B*H*S*S/2*D multiply-adds each (causal), with 4-byte operands.
//
// Design of the forward and dq (simple first): 256 threads a block in a
// 16 x 16 grid (ty, tx).  A block owns BM = 64 query rows and streams K/V
// BN rows at a time (64; 32 at D = 256, where four tiles of 64 rows would
// not fit the shared memory).  Thread (ty, tx) keeps a TM x TN micro-tile of
// the scores in registers (rows ty*TM.., columns tx + 16 n) and a TM x D/16
// micro-tile of its output (columns tx + 16 n), so the accumulators never
// leave the registers; the softmax's row max and sum are reduced over the
// 16 lanes of a half-warp with shuffles.  Tiles sit in shared memory with
// an odd row stride (D + 1): reading a column across 16 rows hits 16 banks.
// The probability (or dS) tile goes through shared memory between the two
// products; the half-warp that writes a row is the one that reads it, so a
// __syncwarp orders them.  Tiles past S are zero-filled and masked.  What
// it leaves on the table: one or two blocks per SM (64-210 KB of shared
// memory), scalar shared-memory loads (0.5-0.75 loads a multiply-add in the
// score products), no double-buffered tile loads.
//
// Design of dk/dv (register-blocked, as a SIMT GEMM is built): 256
// threads in a 16 x 16 grid; a block owns BM keys (K and V resident) and
// streams the GQA group's rep heads x query tiles of BN rows from the
// diagonal down (causal), one block per (key tile, KV head, batch), no
// atomics.  At D <= 80 BM = 128 and each thread owns an 8 x 4 micro-tile of
// the scores (BN 64; 8 x 3 and BN 48 at D 80, so that two stages fit); at
// D >= 96, where dK and dV would not fit the registers, BM = 64 and 4 x 2
// (BN 32).  See struct Rb.
//   * Every tile row is D + 4 floats: 16-byte aligned with an odd number of
//     16-byte chunks, so a float4 read of 8 consecutive rows (or 8
//     consecutive chunks of one row) hits distinct banks.
//   * S^T = K Q^T and dP^T = V dO^T read each thread's key and query rows
//     as float4s along D: 12 float4 loads per 128 multiply-adds (8 x 4),
//     each load shared by the lanes of a warp that need it.
//   * P^T and dS^T go to shared memory as [query][key] (a conflict-free
//     scalar store), so dV += P^T dO and dK += dS^T Q read a thread's keys
//     as float4s (4 keys each) a query row and its D / 16 columns of dO
//     and Q as float4s (64 e + 4 cg; D 80, 96 and 32 add a float or
//     float2): 6 loads per 64 multiply-adds at D 64.  dK and dV stay in
//     registers.
//   * cp.async double-buffers the streamed tiles: the next query tile's
//     Q, dO, lse and delta load while this one computes (one stage at
//     D 256, whose tiles leave room for one: 212 KB).
//   * The key tiles are the slowest grid dimension, so the blocks with the
//     most causal work start first and the shortest fill the tail.
//   * Tiles inside S and below the diagonal skip the mask.
// What it leaves on the table (measured on an H100: ~50% of the CUDA
// cores' rate at D 64): one block an SM (208 KB of shared memory at D 64)
// and 254 registers, so shared-memory latency and the two barriers a tile
// are poorly hidden; the diagonal tiles' masked half (~11% of the work at
// S 1024); the accurate expf (~5%); scalar stores of P^T and dS^T.
//
// Supported: D in {32, 64, 80, 96, 128, 256}, any S >= 1, H % Hkv == 0.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;   // 16 x 16: ty owns rows, tx columns
constexpr float kNegInf = -1e30f;

template <int D>
struct Cfg {
  static_assert(D % 16 == 0 && D >= 16 && D <= 256, "head dim");
  static constexpr int BM = 64;                  // rows a block owns
  static constexpr int BN = D > 128 ? 32 : 64;   // rows streamed per step
  static constexpr int TM = BM / 16;             // micro-tile rows
  static constexpr int TN = BN / 16;             // micro-tile score columns
  static constexpr int TD = D / 16;              // micro-tile output columns
  static constexpr int LD = D + 1;               // q/k/v/do tile row stride
  static constexpr int LP = BN + 1;              // P / dS tile row stride
  static constexpr int FWD_SMEM = 4 * ((BM + 2 * BN) * LD + BM * LP);
  static constexpr int DQ_SMEM = 4 * ((2 * BM + 2 * BN) * LD + BM * LP);
  static_assert(FWD_SMEM <= 232448 && DQ_SMEM <= 232448,
                "shared memory of one block");
};

// `rows` rows of D floats from global (row stride D) into shared memory (row
// stride D + 1); rows at or past rows_valid are zero-filled.
template <int D>
__device__ __forceinline__ void load_rows(float* dst,
                                          const float* __restrict__ src,
                                          int rows, int rows_valid) {
  constexpr int LD = D + 1;
  for (int idx = threadIdx.x; idx < rows * D; idx += kThreads) {
    const int r = idx / D;
    const int c = idx - r * D;
    dst[r * LD + c] = r < rows_valid ? src[idx] : 0.f;
  }
}

// s[i][n] = A[i] . B[16 n] over D: A points at this thread's first row, B at
// its first column's row (both stride D + 1 in shared memory).
template <int D, int TM, int TN>
__device__ __forceinline__ void tile_abt(const float* a, const float* b,
                                         float (&s)[TM][TN]) {
  constexpr int LD = D + 1;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int n = 0; n < TN; ++n) s[i][n] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float av[TM], bv[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) av[i] = a[i * LD + d];
#pragma unroll
    for (int n = 0; n < TN; ++n) bv[n] = b[n * 16 * LD + d];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int n = 0; n < TN; ++n) s[i][n] = fmaf(av[i], bv[n], s[i][n]);
  }
}

// acc[i][n] += sum_c P[i][c] * V[c][16 n] over c < BN: P points at this
// thread's first row (stride BN + 1), V at its first column (stride D + 1).
template <int D, int TM, int BN>
__device__ __forceinline__ void tile_ab_acc(const float* p, const float* v,
                                            float (&acc)[TM][D / 16]) {
  constexpr int LD = D + 1;
  constexpr int LP = BN + 1;
#pragma unroll 2
  for (int c = 0; c < BN; ++c) {
    float pv[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i) pv[i] = p[i * LP + c];
#pragma unroll
    for (int n = 0; n < D / 16; ++n) {
      const float x = v[c * LD + n * 16];
#pragma unroll
      for (int i = 0; i < TM; ++i) acc[i][n] = fmaf(pv[i], x, acc[i][n]);
    }
  }
}

// reduce over the 16 lanes of this half-warp
__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(kThreads)
fwd32_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ o,
             float* __restrict__ lse, int H, int Hkv, int S, float scale) {
  using C = Cfg<D>;
  constexpr int BM = C::BM, BN = C::BN, TM = C::TM, TN = C::TN, TD = C::TD;
  constexpr int LD = C::LD, LP = C::LP;
  extern __shared__ float smem[];
  float* Qs = smem;                 // BM x LD
  float* Ks = Qs + BM * LD;         // BN x LD
  float* Vs = Ks + BN * LD;         // BN x LD
  float* Ps = Vs + BN * LD;         // BM x LP

  const int n_q = (S + BM - 1) / BM;
  const int n_k = (S + BN - 1) / BN;
  const int i = n_q - 1 - (int)blockIdx.x;    // longest causal rows first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / (H / Hkv);
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int row0 = i * BM + ty * TM;          // this thread's first q row

  const size_t bh = (size_t)b * H + h;
  const size_t bg = (size_t)b * Hkv + g;
  const float* kb = k + bg * S * D;
  const float* vb = v + bg * S * D;
  load_rows<D>(Qs, q + (bh * S + (size_t)i * BM) * D, BM, min(BM, S - i * BM));

  float acc[TM][TD];
  float m[TM], l[TM];
#pragma unroll
  for (int r = 0; r < TM; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int n = 0; n < TD; ++n) acc[r][n] = 0.f;
  }

  const int j_last = CAUSAL ? min((i * BM + BM - 1) / BN, n_k - 1) : n_k - 1;
  for (int j = 0; j <= j_last; ++j) {
    __syncthreads();                          // previous K/V tiles consumed
    const int rows = min(BN, S - j * BN);
    load_rows<D>(Ks, kb + (size_t)j * BN * D, BN, rows);
    load_rows<D>(Vs, vb + (size_t)j * BN * D, BN, rows);
    __syncthreads();

    float s[TM][TN];
    tile_abt<D, TM, TN>(Qs + ty * TM * LD, Ks + tx * LD, s);   // S = Q K^T
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      float mx = kNegInf;
#pragma unroll
      for (int n = 0; n < TN; ++n) {
        const int col = j * BN + tx + 16 * n;
        float x = s[r][n] * scale;
        if (col >= S || (CAUSAL && col > row0 + r)) x = kNegInf;
        s[r][n] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[r], half_warp_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < TN; ++n) {
        const float p = expf(s[r][n] - m_new);
        Ps[(ty * TM + r) * LP + tx + 16 * n] = p;
        sum += p;
      }
      const float corr = expf(m[r] - m_new);
      l[r] = l[r] * corr + half_warp_sum(sum);
      m[r] = m_new;
#pragma unroll
      for (int n = 0; n < TD; ++n) acc[r][n] *= corr;
    }
    __syncwarp();
    tile_ab_acc<D, TM, BN>(Ps + ty * TM * LP, Vs + tx, acc);    // O += P V
  }

#pragma unroll
  for (int r = 0; r < TM; ++r) {
    const int row = row0 + r;
    if (row >= S) continue;
    const float lc = fmaxf(l[r], 1e-30f);
    float* og = o + (bh * S + row) * D + tx;
#pragma unroll
    for (int n = 0; n < TD; ++n) og[16 * n] = acc[r][n] / lc;
    if (tx == 0) lse[bh * S + row] = m[r] + logf(lc);
  }
}

// ---------------------------------------------------------------------------
// backward: dq
// ---------------------------------------------------------------------------

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(kThreads)
dq32_kernel(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            float* __restrict__ dq, int H, int Hkv, int S, float scale) {
  using C = Cfg<D>;
  constexpr int BM = C::BM, BN = C::BN, TM = C::TM, TN = C::TN, TD = C::TD;
  constexpr int LD = C::LD, LP = C::LP;
  extern __shared__ float smem[];
  float* Qs = smem;                 // BM x LD
  float* dOs = Qs + BM * LD;        // BM x LD
  float* Ks = dOs + BM * LD;        // BN x LD
  float* Vs = Ks + BN * LD;         // BN x LD
  float* dSs = Vs + BN * LD;        // BM x LP

  const int n_q = (S + BM - 1) / BM;
  const int n_k = (S + BN - 1) / BN;
  const int i = n_q - 1 - (int)blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / (H / Hkv);
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int row0 = i * BM + ty * TM;

  const size_t bh = (size_t)b * H + h;
  const size_t bg = (size_t)b * Hkv + g;
  const float* kb = k + bg * S * D;
  const float* vb = v + bg * S * D;
  const int qrows = min(BM, S - i * BM);
  load_rows<D>(Qs, q + (bh * S + (size_t)i * BM) * D, BM, qrows);
  load_rows<D>(dOs, dout + (bh * S + (size_t)i * BM) * D, BM, qrows);
  float lse_r[TM], delta_r[TM];
  float acc[TM][TD];
#pragma unroll
  for (int r = 0; r < TM; ++r) {
    const bool ok = row0 + r < S;
    lse_r[r] = ok ? lse[bh * S + row0 + r] : 0.f;
    delta_r[r] = ok ? delta[bh * S + row0 + r] : 0.f;
#pragma unroll
    for (int n = 0; n < TD; ++n) acc[r][n] = 0.f;
  }

  const int j_last = CAUSAL ? min((i * BM + BM - 1) / BN, n_k - 1) : n_k - 1;
  for (int j = 0; j <= j_last; ++j) {
    __syncthreads();
    const int rows = min(BN, S - j * BN);
    load_rows<D>(Ks, kb + (size_t)j * BN * D, BN, rows);
    load_rows<D>(Vs, vb + (size_t)j * BN * D, BN, rows);
    __syncthreads();

    float s[TM][TN], dp[TM][TN];
    tile_abt<D, TM, TN>(Qs + ty * TM * LD, Ks + tx * LD, s);    // S = Q K^T
    tile_abt<D, TM, TN>(dOs + ty * TM * LD, Vs + tx * LD, dp);  // dP = dO V^T
#pragma unroll
    for (int r = 0; r < TM; ++r) {
#pragma unroll
      for (int n = 0; n < TN; ++n) {
        const int col = j * BN + tx + 16 * n;
        const int row = row0 + r;
        const bool ok = row < S && col < S && !(CAUSAL && col > row);
        const float p = ok ? expf(s[r][n] * scale - lse_r[r]) : 0.f;
        dSs[(ty * TM + r) * LP + tx + 16 * n] = p * (dp[r][n] - delta_r[r]);
      }
    }
    __syncwarp();
    tile_ab_acc<D, TM, BN>(dSs + ty * TM * LP, Ks + tx, acc);   // dQ += dS K
  }

#pragma unroll
  for (int r = 0; r < TM; ++r) {
    const int row = row0 + r;
    if (row >= S) continue;
    float* dg = dq + (bh * S + row) * D + tx;
#pragma unroll
    for (int n = 0; n < TD; ++n) dg[16 * n] = acc[r][n] * scale;
  }
}

// ---------------------------------------------------------------------------
// backward: dk, dv (register-blocked)
// ---------------------------------------------------------------------------

// cp.async global -> shared of 16 or 4 bytes, zero-filled past src_bytes
// (0: nothing is read, the destination is zeroed)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The register-blocked layout.  256 threads in a 16 x 16 grid (rg, cg); a
// block owns BM = 16 TM keys (K, V resident) and streams BN = 16 TN query
// rows a step (Q, dO, lse, delta; two stages but at D 256, whose tiles
// leave room for one).  Thread (rg, cg) holds the TM x TN scores of keys
// rg + 16 i and queries cg + 16 j, and the TM x D / 16 sums of dK and dV of
// keys 4 rg + 64 h + r (h < TM / 4, r < 4) and the columns of cg.  TM 8 at
// D <= 80 (TN 4, or 3 at D 80 so that two stages fit), else 4 (TN 2): the
// sums of dK and dV take 2 TM D / 16 registers.  Every tile row is D + 4
// floats (16-byte aligned, an odd number of 16-byte chunks), P^T and dS^T
// rows BM + 4.
template <int D>
struct Rb {
  static_assert(D % 16 == 0 && D >= 32 && D <= 256, "head dim");
  static constexpr int TM = D <= 80 ? 8 : 4;
  static constexpr int TN = D == 80 ? 3 : TM / 2;
  static constexpr int BM = 16 * TM;
  static constexpr int BN = 16 * TN;
  static constexpr int STAGES = D > 128 ? 1 : 2;
  static constexpr int LD = D + 4;
  static constexpr int LP = BM + 4;
  static constexpr int STAGE = 2 * BN * LD + 2 * BN;   // Q, dO, lse, delta
  static constexpr int SMEM = 4 * (2 * BM * LD + STAGES * STAGE + 2 * BN * LP);
  // a thread's D / 16 output columns: C4 float4 chunks at 64 e + 4 cg, then
  // CR more (a float2 at 64 C4 + 2 cg, or a float at 64 C4 + cg)
  static constexpr int C4 = D / 64;
  static constexpr int CR = (D % 64) / 16;
  static_assert(SMEM <= 232448, "shared memory of one block");
};

// the thread's output columns of one row (cg: its column thread, 0-15)
template <int D>
__device__ __forceinline__ void rb_load_cols(const float* row, int cg,
                                             float (&x)[D / 16]) {
  using R = Rb<D>;
#pragma unroll
  for (int e = 0; e < R::C4; ++e) {
    const float4 v = *reinterpret_cast<const float4*>(row + 64 * e + 4 * cg);
    x[4 * e] = v.x;
    x[4 * e + 1] = v.y;
    x[4 * e + 2] = v.z;
    x[4 * e + 3] = v.w;
  }
  if constexpr (R::CR == 2) {
    const float2 v = *reinterpret_cast<const float2*>(row + 64 * R::C4 + 2 * cg);
    x[4 * R::C4] = v.x;
    x[4 * R::C4 + 1] = v.y;
  } else if constexpr (R::CR == 1) {
    x[4 * R::C4] = row[64 * R::C4 + cg];
  }
}

template <int D>
__device__ __forceinline__ void rb_store_cols(float* row, int cg,
                                              const float (&x)[D / 16],
                                              float mul) {
  using R = Rb<D>;
#pragma unroll
  for (int e = 0; e < R::C4; ++e)
    *reinterpret_cast<float4*>(row + 64 * e + 4 * cg) =
        make_float4(x[4 * e] * mul, x[4 * e + 1] * mul, x[4 * e + 2] * mul,
                    x[4 * e + 3] * mul);
  if constexpr (R::CR == 2)
    *reinterpret_cast<float2*>(row + 64 * R::C4 + 2 * cg) =
        make_float2(x[4 * R::C4] * mul, x[4 * R::C4 + 1] * mul);
  else if constexpr (R::CR == 1)
    row[64 * R::C4 + cg] = x[4 * R::C4] * mul;
}

// s[i][j] = A[16 i] . B[16 j] over D (rows of stride D + 4 in shared
// memory; `a` and `b` point at the thread's first row of each), read as
// float4s along D: TM + TN loads per 4 TM TN multiply-adds
template <int D, int TM, int TN>
__device__ __forceinline__ void rb_abt(const float* a, const float* b,
                                       float (&s)[TM][TN]) {
  constexpr int LD = D + 4;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) s[i][j] = 0.f;
#pragma unroll
  for (int d = 0; d < D; d += 4) {
    float4 av[TM], bv[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
      av[i] = *reinterpret_cast<const float4*>(a + 16 * i * LD + d);
#pragma unroll
    for (int j = 0; j < TN; ++j)
      bv[j] = *reinterpret_cast<const float4*>(b + 16 * j * LD + d);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        s[i][j] = fmaf(av[i].x, bv[j].x, s[i][j]);
        s[i][j] = fmaf(av[i].y, bv[j].y, s[i][j]);
        s[i][j] = fmaf(av[i].z, bv[j].z, s[i][j]);
        s[i][j] = fmaf(av[i].w, bv[j].w, s[i][j]);
      }
  }
}

// dv[r][x] += sum_c Pt[c][key r] dO[c][col x], dk[r][x] += the same with
// dSt and Q, over the BN query rows c; the thread's keys are TM / 4 runs of
// 4 (64 apart), one float4 of P^T and one of dS^T each
template <int D>
__device__ __forceinline__ void rb_ab_acc2(
    const float* pt, const float* dst, const float* dos, const float* qs,
    int cg, float (&dv)[Rb<D>::TM][D / 16], float (&dk)[Rb<D>::TM][D / 16]) {
  using R = Rb<D>;
  constexpr int TM = R::TM;
#pragma unroll 8
  for (int c = 0; c < R::BN; ++c) {
    float pv[TM], sv[TM];
#pragma unroll
    for (int h = 0; h < TM / 4; ++h) {
      const float4 p4 = *reinterpret_cast<const float4*>(pt + c * R::LP + 64 * h);
      const float4 s4 = *reinterpret_cast<const float4*>(dst + c * R::LP + 64 * h);
      pv[4 * h] = p4.x, pv[4 * h + 1] = p4.y, pv[4 * h + 2] = p4.z, pv[4 * h + 3] = p4.w;
      sv[4 * h] = s4.x, sv[4 * h + 1] = s4.y, sv[4 * h + 2] = s4.z, sv[4 * h + 3] = s4.w;
    }
    float ov[D / 16], qv[D / 16];
    rb_load_cols<D>(dos + c * R::LD, cg, ov);
    rb_load_cols<D>(qs + c * R::LD, cg, qv);
#pragma unroll
    for (int r = 0; r < TM; ++r)
#pragma unroll
      for (int x = 0; x < D / 16; ++x) {
        dv[r][x] = fmaf(pv[r], ov[x], dv[r][x]);
        dk[r][x] = fmaf(sv[r], qv[x], dk[r][x]);
      }
  }
}

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(kThreads, 1)
dkv32_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             float* __restrict__ dk, float* __restrict__ dv, int H, int Hkv,
             int S, float scale) {
  using R = Rb<D>;
  constexpr int TM = R::TM, TN = R::TN, BM = R::BM, BN = R::BN;
  constexpr int LD = R::LD, LP = R::LP;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* Ks = smem;                             // BM x LD (the block's keys)
  float* Vs = Ks + BM * LD;                     // BM x LD
  float* Pt = Vs + BM * LD;                     // BN x LP: P^T, [query][key]
  float* dSt = Pt + BN * LP;                    // BN x LP: dS^T
  float* stages = dSt + BN * LP;                // STAGES x (Q, dO, lse, delta)

  const int n_q = (S + BN - 1) / BN;
  const int g = blockIdx.x;
  const int b = blockIdx.y;
  const int j = blockIdx.z;                     // the causal longest first
  const int rep = H / Hkv;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  // a warp covers 4 row threads x 8 column threads, so a load of one of
  // its instructions reads 4 consecutive key rows or 8 consecutive query
  // rows (distinct banks), each shared by the lanes that need it
  const int rg = (warp / 2) * 4 + lane / 8;
  const int cg = (warp % 2) * 8 + lane % 8;

  const size_t bg = (size_t)b * Hkv + g;
  const int krows = min(BM, S - j * BM);
  {
    const float* kg = k + (bg * S + (size_t)j * BM) * D;
    const float* vg = v + (bg * S + (size_t)j * BM) * D;
    for (int idx = tid; idx < BM * (D / 4); idx += kThreads) {
      const int r = idx / (D / 4);
      const int c = (idx % (D / 4)) * 4;
      const bool ok = r < krows;
      const size_t at = ok ? (size_t)r * D + c : 0;
      cp_async16(Ks + r * LD + c, kg + at, ok ? 16 : 0);
      cp_async16(Vs + r * LD + c, vg + at, ok ? 16 : 0);
    }
  }

  // causal: query tiles that end above this key tile see none of its keys
  const int i_first = CAUSAL ? (j * BM) / BN : 0;
  const int per_head = n_q - i_first;
  const int n_items = rep * per_head;
  // item it: query tile i_first + it % per_head of head g * rep + it / per_head
  auto load_stage = [&](int it, int st) {
    const int i = i_first + it % per_head;
    const size_t bh = (size_t)b * H + (size_t)g * rep + it / per_head;
    float* Qs = stages + st * R::STAGE;
    float* dOs = Qs + BN * LD;
    float* rows = dOs + BN * LD;                // lse, delta
    const int qrows = min(BN, S - i * BN);
    const float* qg = q + (bh * S + (size_t)i * BN) * D;
    const float* dg = dout + (bh * S + (size_t)i * BN) * D;
    for (int idx = tid; idx < BN * (D / 4); idx += kThreads) {
      const int r = idx / (D / 4);
      const int c = (idx % (D / 4)) * 4;
      const bool ok = r < qrows;
      const size_t at = ok ? (size_t)r * D + c : 0;
      cp_async16(Qs + r * LD + c, qg + at, ok ? 16 : 0);
      cp_async16(dOs + r * LD + c, dg + at, ok ? 16 : 0);
    }
    if (tid < 2 * BN) {
      const int t = tid % BN;
      const bool ok = t < qrows;
      const float* src = (tid < BN ? lse : delta) + bh * S + (size_t)i * BN;
      cp_async4(rows + tid, src + (ok ? t : 0), ok ? 4 : 0);
    }
    cp_async_commit();
  };

  float dk_acc[TM][D / 16], dv_acc[TM][D / 16];
#pragma unroll
  for (int r = 0; r < TM; ++r)
#pragma unroll
    for (int x = 0; x < D / 16; ++x) dk_acc[r][x] = dv_acc[r][x] = 0.f;

  if (R::STAGES == 2) load_stage(0, 0);         // with K and V
  for (int it = 0; it < n_items; ++it) {
    const int st = R::STAGES == 2 ? it & 1 : 0;
    if (R::STAGES == 1) {
      __syncthreads();                          // the stage's last readers
      load_stage(it, 0);
    }
    cp_async_wait_all();
    __syncthreads();                            // every thread's copies landed
    if (R::STAGES == 2 && it + 1 < n_items) load_stage(it + 1, st ^ 1);

    const int i = i_first + it % per_head;
    const float* Qs = stages + st * R::STAGE;
    const float* dOs = Qs + BN * LD;
    const float* ls = dOs + BN * LD;
    const float* dl = ls + BN;
    float s[TM][TN], dp[TM][TN];
    rb_abt<D, TM, TN>(Ks + rg * LD, Qs + cg * LD, s);        // S^T = K Q^T
    rb_abt<D, TM, TN>(Vs + rg * LD, dOs + cg * LD, dp);      // dP^T = V dO^T
    // a tile inside S and below the diagonal needs no mask
    const bool masked = (j + 1) * BM > S || (i + 1) * BN > S ||
                        (CAUSAL && (j + 1) * BM - 1 > i * BN);
#pragma unroll
    for (int jj = 0; jj < TN; ++jj) {
      const int c = cg + 16 * jj;
      const int qc = i * BN + c;
#pragma unroll
      for (int ii = 0; ii < TM; ++ii) {
        const int m = rg + 16 * ii;
        const int kr = j * BM + m;
        const bool ok = !masked || (kr < S && qc < S && !(CAUSAL && kr > qc));
        const float p = ok ? expf(s[ii][jj] * scale - ls[c]) : 0.f;
        Pt[c * LP + m] = p;
        dSt[c * LP + m] = p * (dp[ii][jj] - dl[c]);
      }
    }
    __syncthreads();
    rb_ab_acc2<D>(Pt + 4 * rg, dSt + 4 * rg, dOs, Qs, cg, dv_acc, dk_acc);
  }

#pragma unroll
  for (int r = 0; r < TM; ++r) {
    const int kr = j * BM + 4 * rg + 64 * (r / 4) + r % 4;
    if (kr >= S) continue;
    const size_t out = (bg * S + kr) * D;
    rb_store_cols<D>(dk + out, cg, dk_acc[r], scale);
    rb_store_cols<D>(dv + out, cg, dv_acc[r], 1.f);
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

template <typename K>
cudaError_t set_smem(K kernel, int smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem);
}

template <int D, bool C>
cudaError_t fwd_launch(const void* q, const void* k, const void* v, void* o,
                       void* lse, int B, int H, int Hkv, int S, float scale,
                       cudaStream_t st) {
  const int smem = Cfg<D>::FWD_SMEM;
  cudaError_t e = set_smem(fwd32_kernel<D, C>, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((S + Cfg<D>::BM - 1) / Cfg<D>::BM, H, B);
  fwd32_kernel<D, C><<<grid, kThreads, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), H, Hkv, S, scale);
  return cudaGetLastError();
}

template <int D, bool C>
cudaError_t dq_launch(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dq, int B, int H, int Hkv, int S, float scale,
                      cudaStream_t st) {
  const int smem = Cfg<D>::DQ_SMEM;
  cudaError_t e = set_smem(dq32_kernel<D, C>, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((S + Cfg<D>::BM - 1) / Cfg<D>::BM, H, B);
  dq32_kernel<D, C><<<grid, kThreads, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dq), H, Hkv, S, scale);
  return cudaGetLastError();
}

template <int D, bool C>
cudaError_t dkv_launch(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, int B, int H, int Hkv, int S,
                       float scale, cudaStream_t st) {
  const int smem = Rb<D>::SMEM;
  cudaError_t e = set_smem(dkv32_kernel<D, C>, smem);
  if (e != cudaSuccess) return e;
  // key tiles in the slowest grid dimension: the blocks of the first
  // (with the most causal work) start first, the shortest fill the tail
  dim3 grid(Hkv, B, (S + Rb<D>::BM - 1) / Rb<D>::BM);
  dkv32_kernel<D, C><<<grid, kThreads, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dk), static_cast<float*>(dv), H, Hkv, S, scale);
  return cudaGetLastError();
}

bool bad_shape(int B, int H, int Hkv, int S) {
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

}  // namespace

// Each returns cudaGetLastError() after its launch (0 on success); they
// launch on `stream` and do not synchronise.

extern "C" int flash_fwd_fp32(const void* q, const void* k, const void* v,
                              void* o, void* lse, int B, int H, int Hkv,
                              int S, int D, float scale, int causal,
                              void* stream) {
  if (bad_shape(B, H, Hkv, S)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)with_head_dim(D, [&](auto d) {
    constexpr int DD = decltype(d)::value;
    return causal ? fwd_launch<DD, true>(q, k, v, o, lse, B, H, Hkv, S, scale, st)
                  : fwd_launch<DD, false>(q, k, v, o, lse, B, H, Hkv, S, scale, st);
  });
}

extern "C" int flash_dq_fp32(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, void* dq, int B, int H,
                             int Hkv, int S, int D, float scale, int causal,
                             void* stream) {
  if (bad_shape(B, H, Hkv, S)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)with_head_dim(D, [&](auto d) {
    constexpr int DD = decltype(d)::value;
    return causal
        ? dq_launch<DD, true>(q, k, v, dout, lse, delta, dq, B, H, Hkv, S, scale, st)
        : dq_launch<DD, false>(q, k, v, dout, lse, delta, dq, B, H, Hkv, S, scale, st);
  });
}

extern "C" int flash_dkv_fp32(const void* q, const void* k, const void* v,
                              const void* dout, const void* lse,
                              const void* delta, void* dk, void* dv, int B,
                              int H, int Hkv, int S, int D, float scale,
                              int causal, void* stream) {
  if (bad_shape(B, H, Hkv, S)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)with_head_dim(D, [&](auto d) {
    constexpr int DD = decltype(d)::value;
    return causal
        ? dkv_launch<DD, true>(q, k, v, dout, lse, delta, dk, dv, B, H, Hkv, S, scale, st)
        : dkv_launch<DD, false>(q, k, v, dout, lse, delta, dk, dv, B, H, Hkv, S, scale, st);
  });
}
