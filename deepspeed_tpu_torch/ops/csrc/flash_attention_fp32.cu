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
// Design (simple first): 256 threads a block in a 16 x 16 grid (ty, tx).  A
// block owns BM = 64 rows (query rows for fwd/dq, key rows for dkv) and
// streams the other operand BN rows at a time (64; 32 at D = 256, where four
// tiles of 64 rows would not fit the shared memory).  Thread (ty, tx) keeps a
// TM x TN micro-tile of the scores in registers (rows ty*TM.., columns tx +
// 16 n) and a TM x D/16 micro-tile of its output (columns tx + 16 n), so the
// accumulators never leave the registers; the softmax's row max and sum are
// reduced over the 16 lanes of a half-warp with shuffles.  Tiles sit in
// shared memory with an odd row stride (D + 1): reading a column across 16
// rows hits 16 banks.  The probability (or dS) tile goes through shared
// memory between the two products; the half-warp that writes a row is the one
// that reads it, so a __syncwarp orders them.  Tiles past S are zero-filled
// and masked.
//
// What this design leaves on the table (work for later): one or two blocks
// per SM (64-210 KB of shared memory), scalar shared-memory loads (0.5-0.75
// loads a multiply-add in the score products), no double-buffered tile loads.
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
  static constexpr int DKV_SMEM =
      4 * ((2 * BM + 2 * BN) * LD + 2 * BM * LP + 2 * BN);
  static_assert(FWD_SMEM <= 232448 && DQ_SMEM <= 232448 &&
                DKV_SMEM <= 232448, "shared memory of one block");
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
// backward: dk, dv
// ---------------------------------------------------------------------------

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(kThreads)
dkv32_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             float* __restrict__ dk, float* __restrict__ dv, int H, int Hkv,
             int S, float scale) {
  using C = Cfg<D>;
  constexpr int BM = C::BM, BN = C::BN, TM = C::TM, TN = C::TN, TD = C::TD;
  constexpr int LD = C::LD, LP = C::LP;
  extern __shared__ float smem[];
  float* Ks = smem;                 // BM x LD (the block's key rows)
  float* Vs = Ks + BM * LD;         // BM x LD
  float* Qs = Vs + BM * LD;         // BN x LD (streamed query rows)
  float* dOs = Qs + BN * LD;        // BN x LD
  float* Pt = dOs + BN * LD;        // BM x LP  (P^T)
  float* dSt = Pt + BM * LP;        // BM x LP  (dS^T)
  float* lse_s = dSt + BM * LP;     // BN
  float* delta_s = lse_s + BN;      // BN

  const int n_q = (S + BN - 1) / BN;
  const int j = blockIdx.x;
  const int g = blockIdx.y;
  const int b = blockIdx.z;
  const int rep = H / Hkv;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int kr0 = j * BM + ty * TM;           // this thread's first key row

  const size_t bg = (size_t)b * Hkv + g;
  const int krows = min(BM, S - j * BM);
  load_rows<D>(Ks, k + (bg * S + (size_t)j * BM) * D, BM, krows);
  load_rows<D>(Vs, v + (bg * S + (size_t)j * BM) * D, BM, krows);

  float dk_acc[TM][TD], dv_acc[TM][TD];
#pragma unroll
  for (int r = 0; r < TM; ++r)
#pragma unroll
    for (int n = 0; n < TD; ++n) dk_acc[r][n] = dv_acc[r][n] = 0.f;

  // causal: query tiles strictly above this key tile see none of its keys
  const int i_first = CAUSAL ? (j * BM) / BN : 0;
  for (int rr = 0; rr < rep; ++rr) {
    const size_t bh = (size_t)b * H + (size_t)g * rep + rr;
    for (int i = i_first; i < n_q; ++i) {
      __syncthreads();                        // previous Q/dO tiles consumed
      const int qrows = min(BN, S - i * BN);
      load_rows<D>(Qs, q + (bh * S + (size_t)i * BN) * D, BN, qrows);
      load_rows<D>(dOs, dout + (bh * S + (size_t)i * BN) * D, BN, qrows);
      if (threadIdx.x < BN) {
        const int t = threadIdx.x;
        const size_t at = bh * S + (size_t)i * BN + t;
        lse_s[t] = t < qrows ? lse[at] : 0.f;
        delta_s[t] = t < qrows ? delta[at] : 0.f;
      }
      __syncthreads();

      float st[TM][TN], dpt[TM][TN];
      tile_abt<D, TM, TN>(Ks + ty * TM * LD, Qs + tx * LD, st);    // S^T = K Q^T
      tile_abt<D, TM, TN>(Vs + ty * TM * LD, dOs + tx * LD, dpt);  // dP^T = V dO^T
#pragma unroll
      for (int r = 0; r < TM; ++r) {
#pragma unroll
        for (int n = 0; n < TN; ++n) {
          const int c = tx + 16 * n;
          const int qc = i * BN + c;
          const int kr = kr0 + r;
          const bool ok = kr < S && qc < S && !(CAUSAL && kr > qc);
          const float p = ok ? expf(st[r][n] * scale - lse_s[c]) : 0.f;
          Pt[(ty * TM + r) * LP + c] = p;
          dSt[(ty * TM + r) * LP + c] = p * (dpt[r][n] - delta_s[c]);
        }
      }
      __syncwarp();
      tile_ab_acc<D, TM, BN>(Pt + ty * TM * LP, dOs + tx, dv_acc);   // dV += P^T dO
      tile_ab_acc<D, TM, BN>(dSt + ty * TM * LP, Qs + tx, dk_acc);   // dK += dS^T Q
    }
  }

#pragma unroll
  for (int r = 0; r < TM; ++r) {
    const int kr = kr0 + r;
    if (kr >= S) continue;
    const size_t out = (bg * S + kr) * D + tx;
#pragma unroll
    for (int n = 0; n < TD; ++n) {
      dk[out + 16 * n] = dk_acc[r][n] * scale;
      dv[out + 16 * n] = dv_acc[r][n];
    }
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
  const int smem = Cfg<D>::DKV_SMEM;
  cudaError_t e = set_smem(dkv32_kernel<D, C>, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((S + Cfg<D>::BM - 1) / Cfg<D>::BM, Hkv, B);
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
