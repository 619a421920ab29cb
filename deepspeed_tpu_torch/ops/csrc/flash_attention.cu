// Flash attention forward, dq and dk/dv, bf16, for Hopper (sm_90a).
//
// Replaces the three TPU kernels of deepspeed_tpu/ops/flash_attention.py:
//   flash_fwd  <- `_fwd_kernel` (:76, pallas_call in `_fwd` :137)
//   flash_dq   <- `_dq_kernel`  (:173, pallas_call in `_bwd` :283)
//   flash_dkv  <- `_dkv_kernel` (:212, pallas_call in `_bwd` :311)
//
// Layouts (all contiguous):
//   q, do, o, dq   [B, H,   S, D] bf16
//   k, v, dk, dv   [B, Hkv, S, D] bf16      (GQA: query head h reads KV head
//                                             h / rep, rep = H / Hkv)
//   lse, delta     [B, H,   S]    fp32      (delta = rowsum(dO * O))
//
// Numerics follow the TPU kernels: scores in fp32 (s = q.k * scale), masked
// entries set to -1e30 (causal: key column > query row), an online softmax
// in fp32 with the probabilities rounded to bf16 before the PV product, the
// final division by max(l, 1e-30), lse = m + log(max(l, 1e-30)); in the
// backward P = exp(s - lse), dS = P * (dP - delta) rounded to bf16 before
// its products, dq = scale * dS K, dk = scale * dS^T Q, dv = P^T dO, all
// accumulated in fp32.
//
// What bounds it on an H100 (3.35 TB/s, 989 TFLOP/s bf16 dense): at the
// shapes of training (S = 1024..4096, D = 64/128) the work per byte is
// S/2-fold, so the products bound it: fwd 2, dq 3, dkv 4 matrix products of
// B*H*S*S/2*D multiply-adds each (causal).
//
// Design (simple first): tiles of 64 query rows x 64 key rows, 4 warps per
// block, each warp owning 16 rows of the block's output tile.  The matrix
// products run on the tensor cores through WMMA (bf16 16x16x16, fp32
// accumulate); the softmax runs on CUDA cores with two lanes per row.
//   * fwd: one block per (q tile, head, batch); the loop over KV tiles (up
//     to the diagonal when causal) replaces the TPU's sequential grid axis.
//     The O accumulator lives in shared memory (fp32) so that each row can
//     be rescaled by the online-softmax correction between products.
//   * dq: the same grid; dq accumulates in WMMA fragments (registers); no
//     atomics (the two-pass design of the TPU kernels).
//   * dkv: one block per (KV tile, KV head, batch); it streams the GQA
//     group's rep heads x q tiles (from the diagonal down when causal: tiles
//     above it are fully masked and skipped) and accumulates dk and dv in
//     fragments.  It computes S^T = K Q^T directly, so every product's
//     output rows belong to the warp that owns them.
//   * Tiles past S (S not a multiple of 64) are zero-filled and masked.
//
// What this design leaves on the table (work for later): no wgmma/TMA, no
// double-buffered (cp.async) tile loads, WMMA operands re-read from shared
// memory for every product, O round-tripped through shared memory every KV
// tile, and at most two blocks per SM (shared memory 62-110 KB a block).
//
// Supported: D in {64, 128}, any S >= 1, H % Hkv == 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

constexpr int kThreads = 128;   // 4 warps, 16 tile rows each
constexpr int BQ = 64;          // query rows per tile
constexpr int BK = 64;          // key rows per tile
constexpr float kNegInf = -1e30f;

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> FragBt;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragB;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

// shared-memory strides (elements) and tile sizes (bytes, multiples of 128)
template <int D>
struct Layout {
  static constexpr int LDH = D + 8;    // bf16 q/k/v/do tile row
  static constexpr int LDS = BK + 4;   // fp32 score tile row (BQ == BK)
  static constexpr int LDP = BK + 8;   // bf16 probability tile row
  static constexpr int LDO = D + 4;    // fp32 output / staging tile row
  static constexpr int TILE_H = 64 * LDH * 2;
  static constexpr int TILE_S = 64 * LDS * 4;
  static constexpr int TILE_P = 64 * LDP * 2;
  static constexpr int TILE_O = 64 * LDO * 4;
  static constexpr int FWD_SMEM = 3 * TILE_H + TILE_S + TILE_P + TILE_O;
  static constexpr int DQ_SMEM = 4 * TILE_H + TILE_S + TILE_P;
  static constexpr int DKV_SMEM = 4 * TILE_H + TILE_S + 2 * TILE_P + 2 * 64 * 4;
  static_assert(TILE_O <= 2 * TILE_H, "staging must fit in two bf16 tiles");
};

// 64 rows of D bf16 from global (row stride D) into shared memory (row
// stride D + 8); rows at or past rows_valid are zero-filled.
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* __restrict__ src,
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

// One warp: C[16 x 64] = A[16 x D] * B[64 x D]^T.  A and B are bf16 rows in
// shared memory (stride D + 8); C is fp32 in shared memory (stride 68).
template <int D>
__device__ __forceinline__ void strip_abt(const bf16* a, const bf16* b, float* c) {
  constexpr int LDH = Layout<D>::LDH;
  constexpr int LDS = Layout<D>::LDS;
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    FragC acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      FragA fa;
      FragBt fb;
      wmma::load_matrix_sync(fa, a + kk * 16, LDH);
      wmma::load_matrix_sync(fb, b + n * 16 * LDH + kk * 16, LDH);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(c + n * 16, acc, LDS, wmma::mem_row_major);
  }
}

// One warp: acc[16 x D] += P[16 x 64] * V[64 x D].  P is bf16 (stride 72),
// V bf16 rows (stride D + 8), both in shared memory.
template <int D>
__device__ __forceinline__ void strip_ab_acc(const bf16* p, const bf16* v,
                                             FragC (&acc)[D / 16]) {
  constexpr int LDH = Layout<D>::LDH;
  constexpr int LDP = Layout<D>::LDP;
  FragA fa[4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wmma::load_matrix_sync(fa[kk], p + kk * 16, LDP);
#pragma unroll
  for (int n = 0; n < D / 16; ++n) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      FragB fb;
      wmma::load_matrix_sync(fb, v + kk * 16 * LDH + n * 16, LDH);
      wmma::mma_sync(acc[n], fa[kk], fb, acc[n]);
    }
  }
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o,
                 float* __restrict__ lse, int H, int Hkv, int S, float scale) {
  using L = Layout<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = reinterpret_cast<bf16*>(smem + L::TILE_H);
  bf16* Vs = reinterpret_cast<bf16*>(smem + 2 * L::TILE_H);
  float* Ss = reinterpret_cast<float*>(smem + 3 * L::TILE_H);
  bf16* Ps = reinterpret_cast<bf16*>(smem + 3 * L::TILE_H + L::TILE_S);
  float* Os = reinterpret_cast<float*>(smem + 3 * L::TILE_H + L::TILE_S + L::TILE_P);

  const int n_q = (S + BQ - 1) / BQ;
  const int n_k = (S + BK - 1) / BK;
  const int i = n_q - 1 - (int)blockIdx.x;    // longest causal rows first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / (H / Hkv);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r = warp * 16 + (lane >> 1);      // this lane pair's tile row
  const int half = lane & 1;                  // which 32 columns / D/2 dims
  const int qrow = i * BQ + r;

  const size_t bh = (size_t)b * H + h;
  const size_t bg = (size_t)b * Hkv + g;
  const bf16* kb = k + bg * S * D;
  const bf16* vb = v + bg * S * D;
  load_tile<D>(Qs, q + (bh * S + (size_t)i * BQ) * D, min(BQ, S - i * BQ));
  float* orow = Os + r * L::LDO + half * (D / 2);
#pragma unroll
  for (int d = 0; d < D / 2; ++d) orow[d] = 0.f;
  float m = kNegInf;
  float l = 0.f;

  const int j_last = CAUSAL ? min((i * BQ + BQ - 1) / BK, n_k - 1) : n_k - 1;
  for (int j = 0; j <= j_last; ++j) {
    __syncthreads();                          // previous K/V tiles consumed
    const int rows = min(BK, S - j * BK);
    load_tile<D>(Ks, kb + (size_t)j * BK * D, rows);
    load_tile<D>(Vs, vb + (size_t)j * BK * D, rows);
    __syncthreads();

    strip_abt<D>(Qs + warp * 16 * L::LDH, Ks, Ss + warp * 16 * L::LDS);
    __syncwarp();

    const float* srow = Ss + r * L::LDS + half * 32;
    const int col0 = j * BK + half * 32;
    float p[32];
    float mx = kNegInf;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      float s = srow[c] * scale;
      const int col = col0 + c;
      if (col >= S || (CAUSAL && col > qrow)) s = kNegInf;
      p[c] = s;
      mx = fmaxf(mx, s);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m, mx);
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      p[c] = __expf(p[c] - m_new);
      sum += p[c];
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    const float corr = __expf(m - m_new);
    l = l * corr + sum;
    m = m_new;
    bf16* prow = Ps + r * L::LDP + half * 32;
#pragma unroll
    for (int c = 0; c < 32; c += 2)
      *reinterpret_cast<__nv_bfloat162*>(prow + c) =
          __floats2bfloat162_rn(p[c], p[c + 1]);
#pragma unroll
    for (int d = 0; d < D / 2; ++d) orow[d] *= corr;
    __syncwarp();

    FragC acc[D / 16];
    float* ostrip = Os + warp * 16 * L::LDO;
#pragma unroll
    for (int n = 0; n < D / 16; ++n)
      wmma::load_matrix_sync(acc[n], ostrip + n * 16, L::LDO, wmma::mem_row_major);
    strip_ab_acc<D>(Ps + warp * 16 * L::LDP, Vs, acc);
#pragma unroll
    for (int n = 0; n < D / 16; ++n)
      wmma::store_matrix_sync(ostrip + n * 16, acc[n], L::LDO, wmma::mem_row_major);
    __syncwarp();
  }

  if (qrow < S) {
    const float lc = fmaxf(l, 1e-30f);
    bf16* og = o + (bh * S + qrow) * D + half * (D / 2);
#pragma unroll
    for (int d = 0; d < D / 2; d += 2)
      *reinterpret_cast<__nv_bfloat162*>(og + d) =
          __floats2bfloat162_rn(orow[d] / lc, orow[d + 1] / lc);
    if (half == 0) lse[bh * S + qrow] = m + logf(lc);
  }
}

// ---------------------------------------------------------------------------
// backward: dq
// ---------------------------------------------------------------------------

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const bf16* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                bf16* __restrict__ dq, int H, int Hkv, int S, float scale) {
  using L = Layout<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* dOs = reinterpret_cast<bf16*>(smem + L::TILE_H);
  bf16* Ks = reinterpret_cast<bf16*>(smem + 2 * L::TILE_H);
  bf16* Vs = reinterpret_cast<bf16*>(smem + 3 * L::TILE_H);
  float* Ss = reinterpret_cast<float*>(smem + 4 * L::TILE_H);
  bf16* dSs = reinterpret_cast<bf16*>(smem + 4 * L::TILE_H + L::TILE_S);

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
  const bf16* kb = k + bg * S * D;
  const bf16* vb = v + bg * S * D;
  const int qrows = min(BQ, S - i * BQ);
  load_tile<D>(Qs, q + (bh * S + (size_t)i * BQ) * D, qrows);
  load_tile<D>(dOs, dout + (bh * S + (size_t)i * BQ) * D, qrows);
  const float lse_r = row_ok ? lse[bh * S + qrow] : 0.f;
  const float delta_r = row_ok ? delta[bh * S + qrow] : 0.f;

  FragC acc[D / 16];
#pragma unroll
  for (int n = 0; n < D / 16; ++n) wmma::fill_fragment(acc[n], 0.f);

  float* sstrip = Ss + warp * 16 * L::LDS;
  const float* srow = Ss + r * L::LDS + half * 32;
  bf16* dsrow = dSs + r * L::LDP + half * 32;
  const int j_last = CAUSAL ? min((i * BQ + BQ - 1) / BK, n_k - 1) : n_k - 1;
  for (int j = 0; j <= j_last; ++j) {
    __syncthreads();
    const int rows = min(BK, S - j * BK);
    load_tile<D>(Ks, kb + (size_t)j * BK * D, rows);
    load_tile<D>(Vs, vb + (size_t)j * BK * D, rows);
    __syncthreads();

    strip_abt<D>(Qs + warp * 16 * L::LDH, Ks, sstrip);   // S = Q K^T
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
    strip_abt<D>(dOs + warp * 16 * L::LDH, Vs, sstrip);  // dP = dO V^T
    __syncwarp();
#pragma unroll
    for (int c = 0; c < 32; c += 2)
      *reinterpret_cast<__nv_bfloat162*>(dsrow + c) = __floats2bfloat162_rn(
          p[c] * (srow[c] - delta_r), p[c + 1] * (srow[c + 1] - delta_r));
    __syncwarp();
    strip_ab_acc<D>(dSs + warp * 16 * L::LDP, Ks, acc);   // dQ += dS K
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
    bf16* dg = dq + (bh * S + qrow) * D + half * (D / 2);
#pragma unroll
    for (int d = 0; d < D / 2; d += 2)
      *reinterpret_cast<__nv_bfloat162*>(dg + d) =
          __floats2bfloat162_rn(srow_o[d] * scale, srow_o[d + 1] * scale);
  }
}

// ---------------------------------------------------------------------------
// backward: dk, dv
// ---------------------------------------------------------------------------

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(kThreads)
flash_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int Hkv,
                 int S, float scale) {
  using L = Layout<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = reinterpret_cast<bf16*>(smem + L::TILE_H);
  bf16* Qs = reinterpret_cast<bf16*>(smem + 2 * L::TILE_H);
  bf16* dOs = reinterpret_cast<bf16*>(smem + 3 * L::TILE_H);
  float* St = reinterpret_cast<float*>(smem + 4 * L::TILE_H);
  bf16* Pt = reinterpret_cast<bf16*>(smem + 4 * L::TILE_H + L::TILE_S);
  bf16* dSt = reinterpret_cast<bf16*>(smem + 4 * L::TILE_H + L::TILE_S + L::TILE_P);
  float* lse_s = reinterpret_cast<float*>(smem + 4 * L::TILE_H + L::TILE_S + 2 * L::TILE_P);
  float* delta_s = lse_s + 64;

  const int n_q = (S + BQ - 1) / BQ;
  const int j = blockIdx.x;
  const int g = blockIdx.y;
  const int b = blockIdx.z;
  const int rep = H / Hkv;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r = warp * 16 + (lane >> 1);      // this lane pair's KV row
  const int half = lane & 1;                  // which 32 query columns
  const int kr = j * BK + r;

  const size_t bg = (size_t)b * Hkv + g;
  const int krows = min(BK, S - j * BK);
  load_tile<D>(Ks, k + (bg * S + (size_t)j * BK) * D, krows);
  load_tile<D>(Vs, v + (bg * S + (size_t)j * BK) * D, krows);

  FragC dk_acc[D / 16];
  FragC dv_acc[D / 16];
#pragma unroll
  for (int n = 0; n < D / 16; ++n) {
    wmma::fill_fragment(dk_acc[n], 0.f);
    wmma::fill_fragment(dv_acc[n], 0.f);
  }

  float* sstrip = St + warp * 16 * L::LDS;
  const float* srow = St + r * L::LDS + half * 32;
  bf16* prow = Pt + r * L::LDP + half * 32;
  bf16* dsrow = dSt + r * L::LDP + half * 32;
  // causal: query tiles strictly above this KV tile see none of its keys
  const int i_first = CAUSAL ? (j * BK) / BQ : 0;
  for (int rr = 0; rr < rep; ++rr) {
    const size_t bh = (size_t)b * H + (size_t)g * rep + rr;
    for (int i = i_first; i < n_q; ++i) {
      __syncthreads();                        // previous Q/dO tiles consumed
      const int qrows = min(BQ, S - i * BQ);
      load_tile<D>(Qs, q + (bh * S + (size_t)i * BQ) * D, qrows);
      load_tile<D>(dOs, dout + (bh * S + (size_t)i * BQ) * D, qrows);
      {
        const int t = threadIdx.x & 63;
        const bool ok = t < qrows;
        const size_t at = bh * S + (size_t)i * BQ + t;
        if (threadIdx.x < 64) lse_s[t] = ok ? lse[at] : 0.f;
        else delta_s[t] = ok ? delta[at] : 0.f;
      }
      __syncthreads();

      strip_abt<D>(Ks + warp * 16 * L::LDH, Qs, sstrip);  // S^T = K Q^T
      __syncwarp();
      const int c0 = half * 32;
      float p[32];
#pragma unroll
      for (int c = 0; c < 32; ++c) {
        const int qc = i * BQ + c0 + c;
        const bool ok = kr < S && qc < S && !(CAUSAL && kr > qc);
        p[c] = ok ? __expf(srow[c] * scale - lse_s[c0 + c]) : 0.f;
      }
#pragma unroll
      for (int c = 0; c < 32; c += 2)
        *reinterpret_cast<__nv_bfloat162*>(prow + c) =
            __floats2bfloat162_rn(p[c], p[c + 1]);
      __syncwarp();
      strip_abt<D>(Vs + warp * 16 * L::LDH, dOs, sstrip);  // dP^T = V dO^T
      __syncwarp();
#pragma unroll
      for (int c = 0; c < 32; c += 2)
        *reinterpret_cast<__nv_bfloat162*>(dsrow + c) = __floats2bfloat162_rn(
            p[c] * (srow[c] - delta_s[c0 + c]),
            p[c + 1] * (srow[c + 1] - delta_s[c0 + c + 1]));
      __syncwarp();
      strip_ab_acc<D>(Pt + warp * 16 * L::LDP, dOs, dv_acc);   // dV += P^T dO
      strip_ab_acc<D>(dSt + warp * 16 * L::LDP, Qs, dk_acc);   // dK += dS^T Q
    }
  }

  __syncthreads();                            // Q/dO tiles become the stage
  float* stage = reinterpret_cast<float*>(Qs);
  const float* srow_o = stage + r * L::LDO + half * (D / 2);
  const size_t out = (bg * S + kr) * D + half * (D / 2);
#pragma unroll
  for (int n = 0; n < D / 16; ++n)
    wmma::store_matrix_sync(stage + warp * 16 * L::LDO + n * 16, dk_acc[n],
                            L::LDO, wmma::mem_row_major);
  __syncwarp();
  if (kr < S) {
#pragma unroll
    for (int d = 0; d < D / 2; d += 2)
      *reinterpret_cast<__nv_bfloat162*>(dk + out + d) =
          __floats2bfloat162_rn(srow_o[d] * scale, srow_o[d + 1] * scale);
  }
  __syncwarp();
#pragma unroll
  for (int n = 0; n < D / 16; ++n)
    wmma::store_matrix_sync(stage + warp * 16 * L::LDO + n * 16, dv_acc[n],
                            L::LDO, wmma::mem_row_major);
  __syncwarp();
  if (kr < S) {
#pragma unroll
    for (int d = 0; d < D / 2; d += 2)
      *reinterpret_cast<__nv_bfloat162*>(dv + out + d) =
          __floats2bfloat162_rn(srow_o[d], srow_o[d + 1]);
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

template <int D, bool C>
cudaError_t fwd_launch(const void* q, const void* k, const void* v, void* o,
                       void* lse, int B, int H, int Hkv, int S, float scale,
                       cudaStream_t st) {
  const int smem = Layout<D>::FWD_SMEM;
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<D, C>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<D, C><<<grid, kThreads, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o),
      static_cast<float*>(lse), H, Hkv, S, scale);
  return cudaGetLastError();
}

template <int D, bool C>
cudaError_t dq_launch(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dq, int B, int H, int Hkv, int S, float scale,
                      cudaStream_t st) {
  const int smem = Layout<D>::DQ_SMEM;
  cudaError_t e = cudaFuncSetAttribute(
      flash_dq_kernel<D, C>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_dq_kernel<D, C><<<grid, kThreads, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dq), H, Hkv, S, scale);
  return cudaGetLastError();
}

template <int D, bool C>
cudaError_t dkv_launch(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, int B, int H, int Hkv, int S,
                       float scale, cudaStream_t st) {
  const int smem = Layout<D>::DKV_SMEM;
  cudaError_t e = cudaFuncSetAttribute(
      flash_dkv_kernel<D, C>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((S + BK - 1) / BK, Hkv, B);
  flash_dkv_kernel<D, C><<<grid, kThreads, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), H, Hkv, S, scale);
  return cudaGetLastError();
}

bool bad_shape(int B, int H, int Hkv, int S) {
  return B < 1 || S < 1 || Hkv < 1 || H < Hkv || H % Hkv != 0 ||
         B > 65535 || H > 65535;
}

}  // namespace

// Each returns cudaGetLastError() after its launch (0 on success); they
// launch on `stream` and do not synchronise.

extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v,
                              void* o, void* lse, int B, int H, int Hkv,
                              int S, int D, float scale, int causal,
                              void* stream) {
  if (bad_shape(B, H, Hkv, S)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return (int)(causal ? fwd_launch<64, true>(q, k, v, o, lse, B, H, Hkv, S, scale, st)
                        : fwd_launch<64, false>(q, k, v, o, lse, B, H, Hkv, S, scale, st));
  if (D == 128)
    return (int)(causal ? fwd_launch<128, true>(q, k, v, o, lse, B, H, Hkv, S, scale, st)
                        : fwd_launch<128, false>(q, k, v, o, lse, B, H, Hkv, S, scale, st));
  return (int)cudaErrorInvalidValue;
}

extern "C" int flash_dq_bf16(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, void* dq, int B, int H,
                             int Hkv, int S, int D, float scale, int causal,
                             void* stream) {
  if (bad_shape(B, H, Hkv, S)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return (int)(causal
        ? dq_launch<64, true>(q, k, v, dout, lse, delta, dq, B, H, Hkv, S, scale, st)
        : dq_launch<64, false>(q, k, v, dout, lse, delta, dq, B, H, Hkv, S, scale, st));
  if (D == 128)
    return (int)(causal
        ? dq_launch<128, true>(q, k, v, dout, lse, delta, dq, B, H, Hkv, S, scale, st)
        : dq_launch<128, false>(q, k, v, dout, lse, delta, dq, B, H, Hkv, S, scale, st));
  return (int)cudaErrorInvalidValue;
}

extern "C" int flash_dkv_bf16(const void* q, const void* k, const void* v,
                              const void* dout, const void* lse,
                              const void* delta, void* dk, void* dv, int B,
                              int H, int Hkv, int S, int D, float scale,
                              int causal, void* stream) {
  if (bad_shape(B, H, Hkv, S)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return (int)(causal
        ? dkv_launch<64, true>(q, k, v, dout, lse, delta, dk, dv, B, H, Hkv, S, scale, st)
        : dkv_launch<64, false>(q, k, v, dout, lse, delta, dk, dv, B, H, Hkv, S, scale, st));
  if (D == 128)
    return (int)(causal
        ? dkv_launch<128, true>(q, k, v, dout, lse, delta, dk, dv, B, H, Hkv, S, scale, st)
        : dkv_launch<128, false>(q, k, v, dout, lse, delta, dk, dv, B, H, Hkv, S, scale, st));
  return (int)cudaErrorInvalidValue;
}
