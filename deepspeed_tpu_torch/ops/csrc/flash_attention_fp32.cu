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
// No atomics: every output is bitwise deterministic.
//
// What bounds it on an H100: the products, on the CUDA cores (67 TFLOP/s
// fp32 dense, not the tensor cores): fwd 2, dq 3, dkv 4 matrix products of
// B*H*S*S/2*D multiply-adds each (causal), with 4-byte operands.
//
// Design of all three (register-blocked, as a SIMT GEMM is built): 256
// threads a block in a 16 x 16 grid (rg, cg).  A block keeps one side's
// tile resident and streams the other's; each thread holds a TM x TN
// micro-tile of the scores and a TM x D / 16 micro-tile of each output in
// registers, so the accumulators never leave them.
//   * Every tile row is D + 4 floats: 16-byte aligned with an odd number of
//     16-byte chunks, so a float4 read of 8 consecutive rows (or 8
//     consecutive chunks of one row) hits distinct banks.  The score
//     products (rb_abt) read each thread's rows as float4s along D: TM + TN
//     loads per 4 TM TN multiply-adds.
//   * The probabilities (and dS) go through shared memory transposed, so
//     that the second product reads 4 consecutive output rows of a thread
//     as one float4 a streamed row, and its D / 16 output columns of that
//     row as float4s (64 e + 4 cg; D 80, 96 and 32 add a float or float2).
//   * cp.async loads the next streamed tile while this one computes.
//   * The resident tiles are the slowest grid dimension, longest causal
//     work first, so the shortest blocks fill the tail.
//   * Tiles inside S and below the diagonal skip the mask.
//
// Forward and dq (struct Rq): a block owns BM = 16 TM query rows (Q; dq
// also dO, and lse and delta in registers) of one head and streams its KV
// head's keys BN = 16 TN at a time from key 0 to the diagonal (causal).
// Thread (rg, cg) = (tid / 16, tid % 16) holds the scores of the TM
// consecutive queries TM rg + i and of keys cg + 16 j.  The 16 threads of
// a query row are one half-warp, so the online softmax's row max is 4
// shuffles (each thread keeps its part of the row sum, reduced once at the
// end); a quarter-warp shares one row thread, so its float4 reads of Q
// (dO) are one address.  The thread's score rows are its output rows:
// P^T (dS^T) is stored [key][query], 4 of a thread's rows of a key as one
// conflict-free float4, and the softmax's correction exp(m_old - m_new)
// and the final 1 / l scale the thread's own accumulators (no exchange
// through shared memory).  The forward holds one K and one V tile: K_j
// loads while P_{j-1} V_{j-1} computes and V_j while S_j does, which
// leaves room for 8 x 8 micro-tiles (BN 128) at D <= 64; dq, which reads
// K in both phases, double-buffers K and V.  TM 8 (BM 128) to D 128 and 4
// at D 256 (see Rq for TN).
//
// dk/dv (struct Rb): a block owns BM keys (K and V resident) and streams
// the GQA group's rep heads x query tiles of BN rows from the diagonal
// down (causal), one block per (key tile, KV head, batch), two cp.async
// stages (one at D 256).  At D <= 80 BM = 128 and each thread owns an
// 8 x 4 micro-tile of the scores (BN 64; 8 x 3 and BN 48 at D 80, so that
// two stages fit); at D >= 96, where dK and dV would not fit the
// registers, BM = 64 and 4 x 2 (BN 32).  S^T = K Q^T and dP^T = V dO^T;
// P^T and dS^T go to shared memory as [query][key] (a scalar store), dV +=
// P^T dO and dK += dS^T Q.
//
// What it leaves on the table (measured on an H100: 48-57% of the CUDA
// cores' rate at D 64 and 80): shared memory.  A float4 read takes four
// passes of the shared-memory pipe (128 bytes a cycle) whatever lanes
// share an address, so a product reads 1.5 bytes a multiply-add at 8 x 4
// micro-tiles (1 at 8 x 8), where the cores need 1 or less; larger tiles
// run out of registers (254 at D 64) and one block an SM (172-208 KB of
// shared memory at D 64) leaves 8 warps to hide the latency and the
// barriers.
// The diagonal tiles' masked half (~11% of the work at S 1024) and the
// accurate expf stay: skipping the masked keys per warp was slower.
//
// Supported: D in {32, 64, 80, 96, 128, 256}, any S >= 1, H % Hkv == 0.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;   // 16 x 16: rg owns rows, cg columns
constexpr float kNegInf = -1e30f;
constexpr int kMaxSmem = 232448;   // shared memory one block may use

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

// `rows` rows of D floats from global (row stride D) into shared memory
// (row stride D + 4) by cp.async; rows at or past rows_valid are zeroed
template <int D>
__device__ __forceinline__ void cp_async_rows(float* dst,
                                              const float* __restrict__ src,
                                              int rows, int rows_valid) {
  for (int idx = threadIdx.x; idx < rows * (D / 4); idx += kThreads) {
    const int r = idx / (D / 4);
    const int c = (idx % (D / 4)) * 4;
    const bool ok = r < rows_valid;
    cp_async16(dst + r * (D + 4) + c, src + (ok ? (size_t)r * D + c : 0),
               ok ? 16 : 0);
  }
}

// The dk/dv register blocking.  A block owns BM = 16 TM keys (K, V
// resident) and streams BN = 16 TN query rows a step (Q, dO, lse, delta;
// two stages but at D 256, whose tiles leave room for one).  Thread (rg,
// cg) holds the TM x TN scores of keys rg + 16 i and queries cg + 16 j, and
// the TM x D / 16 sums of dK and dV of keys 4 rg + 64 h + r (h < TM / 4,
// r < 4) and the columns of cg.  TM 8 at D <= 80 (TN 4, or 3 at D 80 so
// that two stages fit), else 4 (TN 2): the sums of dK and dV take
// 2 TM D / 16 registers.  Every tile row is D + 4 floats (16-byte aligned,
// an odd number of 16-byte chunks), P^T and dS^T rows BM + 4.
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
  static_assert(SMEM <= kMaxSmem, "shared memory of one block");
};

// The forward's and dq's register blocking, Rb's sibling with queries
// resident.  A block owns BM = 16 TM query rows (Q; dq also dO) and
// streams BN = 16 TN keys a step.  Thread (rg, cg) holds the TM x TN scores
// of queries TM rg + i and keys cg + 16 j, and the TM x D / 16 sums of O
// (dQ) of the same queries.  TM 8 to D 128 (the one accumulator takes
// TM D / 16 registers), 4 at D 256.  The forward streams through one K
// and one V tile: TN 8 at D <= 64, 4 above (8 x 8 runs out of registers at
// D 80); dq through two stages of K and V: TN 4, or 3 and 2 at D 96 and
// D 128 so that two stages fit, and one stage at D 256.  P^T (dS^T) rows
// are BM + 4 floats.
template <int D, bool DQ>
struct Rq {
  static_assert(D % 16 == 0 && D >= 32 && D <= 256, "head dim");
  static constexpr int TM = D > 128 ? 4 : 8;
  static constexpr int TN =
      DQ ? (D >= 128 ? 2 : D == 96 ? 3 : 4) : (D <= 64 ? 8 : 4);
  static constexpr int BM = 16 * TM;
  static constexpr int BN = 16 * TN;
  static constexpr int LD = D + 4;
  static constexpr int LP = BM + 4;
  static constexpr int RES = (DQ ? 2 : 1) * BM * LD;   // Q (and dO)
  static constexpr int STAGE = 2 * BN * LD;            // K, V
  // dq double-buffers K and V where two stages fit (all but D 256); the
  // forward holds one K and one V tile
  static constexpr int STAGES =
      DQ && 4 * (RES + 2 * STAGE + BN * LP) <= kMaxSmem ? 2 : 1;
  static constexpr int SMEM = 4 * (RES + STAGES * STAGE + BN * LP);
  static_assert(TM % 4 == 0 && SMEM <= kMaxSmem, "shared memory of one block");
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

// s[i][j] = A[SA i] . B[16 j] over D (rows of stride D + 4 in shared
// memory; `a` and `b` point at the thread's first row of each), read as
// float4s along D: TM + TN loads per 4 TM TN multiply-adds
template <int D, int TM, int TN, int SA = 16>
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
      av[i] = *reinterpret_cast<const float4*>(a + SA * i * LD + d);
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

// acc[r][x] += sum_c At[c][r] B[c][col x] over the BN rows c of B (row
// stride D + 4): At is [c][output row] with rows of LP floats, `at` points
// at the thread's first row (its TM rows consecutive: TM / 4 float4s)
template <int D, int TM, int BN, int LP>
__device__ __forceinline__ void rb_ab_acc(const float* at, const float* bs,
                                          int cg, float (&acc)[TM][D / 16]) {
#pragma unroll 8
  for (int c = 0; c < BN; ++c) {
    float pv[TM];
#pragma unroll
    for (int h = 0; h < TM / 4; ++h) {
      const float4 p4 = *reinterpret_cast<const float4*>(at + c * LP + 4 * h);
      pv[4 * h] = p4.x, pv[4 * h + 1] = p4.y, pv[4 * h + 2] = p4.z, pv[4 * h + 3] = p4.w;
    }
    float bv[D / 16];
    rb_load_cols<D>(bs + c * (D + 4), cg, bv);
#pragma unroll
    for (int r = 0; r < TM; ++r)
#pragma unroll
      for (int x = 0; x < D / 16; ++x) acc[r][x] = fmaf(pv[r], bv[x], acc[r][x]);
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

// The thread's TM x TN tile of P (or dS) into P^T [key][query] (rows of LP
// floats; `pt` points at the thread's first query): 4 of its consecutive
// rows of a key are one float4
template <int TM, int TN, int LP>
__device__ __forceinline__ void rq_store_pt(float* pt, int cg,
                                            const float (&s)[TM][TN]) {
#pragma unroll
  for (int j = 0; j < TN; ++j)
#pragma unroll
    for (int h = 0; h < TM / 4; ++h)
      *reinterpret_cast<float4*>(pt + (cg + 16 * j) * LP + 4 * h) =
          make_float4(s[4 * h][j], s[4 * h + 1][j], s[4 * h + 2][j],
                      s[4 * h + 3][j]);
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(kThreads, 1)
fwd32_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ o,
             float* __restrict__ lse, int H, int Hkv, int S, float scale) {
  using R = Rq<D, false>;
  constexpr int TM = R::TM, TN = R::TN, BM = R::BM, BN = R::BN;
  constexpr int LD = R::LD, LP = R::LP;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* Qs = smem;                             // BM x LD (the block's rows)
  float* Pt = Qs + R::RES;                      // BN x LP: P^T, [key][query]
  float* stages = Pt + BN * LP;                 // K, V

  const int n_q = (S + BM - 1) / BM;
  const int n_k = (S + BN - 1) / BN;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (n_q - 1 - (int)blockIdx.z) * BM;   // the causal longest first
  const int g = h / (H / Hkv);
  const int rg = threadIdx.x / 16;              // a half-warp shares rows
  const int cg = threadIdx.x % 16;
  const int r0 = q0 + TM * rg;                  // the thread's first row

  const size_t bh = (size_t)b * H + h;
  const size_t bg = (size_t)b * Hkv + g;
  const float* kb = k + bg * S * D;
  const float* vb = v + bg * S * D;
  // one K and one V tile: K_j loads while P_{j-1} V_{j-1} computes, V_j
  // while S_j does
  float* Ks = stages;                           // BN x LD
  float* Vs = Ks + BN * LD;                     // BN x LD
  auto load_rows = [&](float* dst, const float* src, int j) {
    cp_async_rows<D>(dst, src + (size_t)j * BN * D, BN, min(BN, S - j * BN));
    cp_async_commit();
  };
  cp_async_rows<D>(Qs, q + (bh * S + q0) * D, BM, min(BM, S - q0));
  load_rows(Ks, kb, 0);                         // with Q

  // m: the row max so far; l: this thread's part of the row sum
  float acc[TM][D / 16], m[TM], l[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int x = 0; x < D / 16; ++x) acc[i][x] = 0.f;
  }

  const int n_j = CAUSAL ? min((q0 + BM - 1) / BN + 1, n_k) : n_k;
  for (int j = 0; j < n_j; ++j) {
    cp_async_wait_all();
    __syncthreads();              // K_j landed; P_{j-1} V_{j-1} done: Vs, Pt free
    load_rows(Vs, vb, j);
    // a tile inside S and below the diagonal needs no mask
    const bool masked = (j + 1) * BN > S || (CAUSAL && (j + 1) * BN - 1 > q0);
    float s[TM][TN];
    rb_abt<D, TM, TN, 1>(Qs + TM * rg * LD, Ks + cg * LD, s); // S = Q K^T
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int row = r0 + i;
      float mx = kNegInf;
#pragma unroll
      for (int jj = 0; jj < TN; ++jj) {
        const int col = j * BN + cg + 16 * jj;
        float x = s[i][jj] * scale;
        if (masked && (col >= S || (CAUSAL && col > row))) x = kNegInf;
        s[i][jj] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int jj = 0; jj < TN; ++jj) {
        const float p = expf(s[i][jj] - m_new);
        s[i][jj] = p;
        sum += p;
      }
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int x = 0; x < D / 16; ++x) acc[i][x] *= corr;
    }
    rq_store_pt<TM, TN, LP>(Pt + TM * rg, cg, s);
    cp_async_wait_all();
    __syncthreads();              // V_j landed, P^T written; S_j done: Ks free
    if (j + 1 < n_j) load_rows(Ks, kb, j + 1);
    rb_ab_acc<D, TM, BN, LP>(Pt + TM * rg, Vs, cg, acc);      // O += P V
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = r0 + i;
    const float lc = fmaxf(half_warp_sum(l[i]), 1e-30f);
    if (row >= S) continue;
    rb_store_cols<D>(o + (bh * S + row) * D, cg, acc[i], 1.f / lc);
    if (cg == 0) lse[bh * S + row] = m[i] + logf(lc);
  }
}

// ---------------------------------------------------------------------------
// backward: dq
// ---------------------------------------------------------------------------

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(kThreads, 1)
dq32_kernel(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            float* __restrict__ dq, int H, int Hkv, int S, float scale) {
  using R = Rq<D, true>;
  constexpr int TM = R::TM, TN = R::TN, BM = R::BM, BN = R::BN;
  constexpr int LD = R::LD, LP = R::LP;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* Qs = smem;                             // BM x LD (the block's rows)
  float* dOs = Qs + BM * LD;                    // BM x LD
  float* dSt = Qs + R::RES;                     // BN x LP: dS^T, [key][query]
  float* stages = dSt + BN * LP;                // STAGES x (K, V)

  const int n_q = (S + BM - 1) / BM;
  const int n_k = (S + BN - 1) / BN;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (n_q - 1 - (int)blockIdx.z) * BM;   // the causal longest first
  const int g = h / (H / Hkv);
  const int rg = threadIdx.x / 16;
  const int cg = threadIdx.x % 16;
  const int r0 = q0 + TM * rg;

  const size_t bh = (size_t)b * H + h;
  const size_t bg = (size_t)b * Hkv + g;
  const int qrows = min(BM, S - q0);
  cp_async_rows<D>(Qs, q + (bh * S + q0) * D, BM, qrows);
  cp_async_rows<D>(dOs, dout + (bh * S + q0) * D, BM, qrows);
  auto load_stage = [&](int j, int st) {
    float* Ks = stages + st * R::STAGE;
    const int rows = min(BN, S - j * BN);
    cp_async_rows<D>(Ks, k + (bg * S + (size_t)j * BN) * D, BN, rows);
    cp_async_rows<D>(Ks + BN * LD, v + (bg * S + (size_t)j * BN) * D, BN, rows);
    cp_async_commit();
  };

  float lse_r[TM], delta_r[TM], acc[TM][D / 16];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = r0 + i;
    lse_r[i] = row < S ? lse[bh * S + row] : 0.f;
    delta_r[i] = row < S ? delta[bh * S + row] : 0.f;
#pragma unroll
    for (int x = 0; x < D / 16; ++x) acc[i][x] = 0.f;
  }

  const int n_j = CAUSAL ? min((q0 + BM - 1) / BN + 1, n_k) : n_k;
  if (R::STAGES == 2) load_stage(0, 0);         // with Q and dO
  for (int j = 0; j < n_j; ++j) {
    const int st = R::STAGES == 2 ? j & 1 : 0;
    if (R::STAGES == 1) {
      __syncthreads();
      load_stage(j, 0);
    }
    cp_async_wait_all();
    __syncthreads();
    if (R::STAGES == 2 && j + 1 < n_j) load_stage(j + 1, st ^ 1);

    const float* Ks = stages + st * R::STAGE;
    const float* Vs = Ks + BN * LD;
    const bool masked = (j + 1) * BN > S || (CAUSAL && (j + 1) * BN - 1 > q0);
    float s[TM][TN], dp[TM][TN];
    rb_abt<D, TM, TN, 1>(Qs + TM * rg * LD, Ks + cg * LD, s);     // S = Q K^T
    rb_abt<D, TM, TN, 1>(dOs + TM * rg * LD, Vs + cg * LD, dp);   // dP = dO V^T
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int row = r0 + i;
#pragma unroll
      for (int jj = 0; jj < TN; ++jj) {
        const int col = j * BN + cg + 16 * jj;
        const bool ok = !masked || (col < S && !(CAUSAL && col > row));
        const float p = ok ? expf(s[i][jj] * scale - lse_r[i]) : 0.f;
        s[i][jj] = p * (dp[i][jj] - delta_r[i]);               // dS
      }
    }
    rq_store_pt<TM, TN, LP>(dSt + TM * rg, cg, s);
    __syncthreads();
    rb_ab_acc<D, TM, BN, LP>(dSt + TM * rg, Ks, cg, acc);     // dQ += dS K
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = r0 + i;
    if (row < S) rb_store_cols<D>(dq + (bh * S + row) * D, cg, acc[i], scale);
  }
}

// ---------------------------------------------------------------------------
// backward: dk, dv
// ---------------------------------------------------------------------------

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

// The resident tiles (query tiles of the forward and dq, key tiles of
// dk/dv) are the slowest grid dimension: the blocks with the most causal
// work start first, the shortest fill the tail.

template <int D, bool C>
cudaError_t fwd_launch(const void* q, const void* k, const void* v, void* o,
                       void* lse, int B, int H, int Hkv, int S, float scale,
                       cudaStream_t st) {
  using R = Rq<D, false>;
  const int smem = R::SMEM;
  cudaError_t e = set_smem(fwd32_kernel<D, C>, smem);
  if (e != cudaSuccess) return e;
  dim3 grid(H, B, (S + R::BM - 1) / R::BM);
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
  using R = Rq<D, true>;
  const int smem = R::SMEM;
  cudaError_t e = set_smem(dq32_kernel<D, C>, smem);
  if (e != cudaSuccess) return e;
  dim3 grid(H, B, (S + R::BM - 1) / R::BM);
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
  using R = Rb<D>;
  const int smem = R::SMEM;
  cudaError_t e = set_smem(dkv32_kernel<D, C>, smem);
  if (e != cudaSuccess) return e;
  dim3 grid(Hkv, B, (S + R::BM - 1) / R::BM);
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
