// Flash attention forward, dq and dk/dv for Hopper (sm_90a) with wgmma,
// TMA and warp specialisation, templated on the 16-bit element type (bf16
// or fp16) and the head dim D in {32, 64, 80, 96, 128, 256}: the only
// 16-bit flash kernels of the port.  flash_attention.cuh dispatches to
// these from the entry points flash_fwd_<tag>, flash_dq_<tag> and
// flash_dkv_<tag>.
//
// Replaces the three TPU kernels of deepspeed_tpu/ops/flash_attention.py:
//   fwd_kernel  <- `_fwd_kernel` (:76, pallas_call in `_fwd` :137)
//   dq_kernel   <- `_dq_kernel`  (:173, pallas_call in `_bwd` :283)
//   dkv_kernel, dkv_split_kernel (D 256)
//               <- `_dkv_kernel` (:212, pallas_call in `_bwd` :311)
// Numerics follow the TPU kernels: scores in fp32 (s = q.k * scale),
// masked entries at -1e30 (causal: key column > query row), an online
// softmax in fp32 with the probabilities rounded to the element type
// (round to nearest even) before the PV product, the division by max(l,
// 1e-30), lse = m + log(max(l, 1e-30)); in the backward P = exp(s - lse),
// dS = P * (dP - delta) rounded to the element type before its products,
// dq = scale * dS K, dk = scale * dS^T Q, dv = P^T dO, all accumulated in
// fp32.  In fp16 a large loss scale can round dS (or an output) to inf;
// that is kept, as the TPU kernel keeps it, and the engine's overflow
// check skips the step.  No atomics: the result does not depend on the
// order blocks run in.
//
// The bound on an H100 (989 TFLOP/s bf16/fp16 dense, 3.35 TB/s): at the
// training shapes (S = 1024..4096) the work per byte is ~S/2-fold, so the
// tensor cores bound all three: the forward does 2, dq 3 and dk/dv 4
// matrix products of B*H*S*S/2*D multiply-adds each (causal).
//
// What the design does about it:
//   * Every product is a wgmma (64-row warpgroup tiles, fp32 sums in
//     registers): S = Q K^T, dP = dO V^T and dP^T = V dO^T with both
//     operands in shared memory; O += P V, dQ += dS K, dV += P^T dO and
//     dK += dS^T Q with P / dS converted in registers to wgmma's A
//     fragment and the second operand read MN-major (transposed) from
//     shared memory (dq reads one K tile both ways).  Nothing else
//     round-trips through shared memory (but P^T at D 256, below): the
//     online softmax (and the backward's P and dS) runs on the
//     accumulator's own layout (each thread holds 2 rows; a row's values
//     sit in one quad of lanes), and O (fwd) / dQ (dq) / dK, dV (dkv)
//     stay in registers for the whole loop.
//   * Warp specialisation: warpgroup 0 is the producer (one thread issues
//     TMA loads into 2-stage rings, with mbarrier completion; in dq and
//     dkv its first warp also stages lse and delta), warpgroups 1 and 2
//     consume, 64 rows each; setmaxnreg moves registers from the producer
//     (40) to the consumers (232).
//   * fwd: 128 query rows x 128-key tiles (80-key tiles at D 256: a
//     thread's O is 128 fp32 registers there, and 2-stage rings of 128-key
//     K and V tiles would need 256 KB of shared memory); a persistent grid
//     (one block per SM) walks the (q tile, head, batch) work list,
//     longest causal rows first, so the next tile's Q and K/V loads overlap
//     this tile's last products and its epilogue.  K and V have rings of
//     their own: a K slot is released once S is computed, a V slot once PV
//     is.  The two consumer warpgroups take turns to issue their S products
//     (named barriers), so one's softmax overlaps the other's products; at
//     D 256 the first warpgroup skips a diagonal tile whose keys all lie
//     past its rows and only keeps its turn.
//   * dq: 128 query rows x 64-key tiles (S, dP and dQ all live in
//     registers: 128-key tiles spill at D <= 80 and ran slower); 48-key
//     tiles at D 256 (a thread's dQ is 128 fp32 registers there, beside S
//     and dP at 24 each; two stages of 48-key K and V tiles are the most
//     that fit beside Q and dO, and 32-key tiles ran 21% slower); one block
//     per (q tile, head, batch), longest causal rows first (a persistent
//     grid ran slower).  K and V have rings of their own: a V slot is released once
//     dP is computed, a K slot once dQ += dS K is.  The producer warp
//     stages the rows' lse (in log2 units) and delta beside Q and dO.  A
//     warpgroup skips the tiles past its own diagonal.
//   * dkv: 128 keys x 64 query rows; one block per (KV tile, KV head,
//     batch), streaming the GQA group's rep heads x q tiles from the
//     diagonal down (causal).  At D 256 (dkv_split_kernel) a warpgroup
//     cannot hold both dK and dV (256 fp32 registers a thread), so a block
//     takes 64 keys and its warpgroups split the four products: the first
//     computes S^T, P^T and dV += P^T dO, the second dP^T, dS^T (from P^T
//     passed in fp32 through shared memory) and dK += dS^T Q; blocks run
//     the longest causal key tiles first.
//   * Tiles past S come from TMA's out-of-bounds zero fill and are masked
//     in registers, as is the causal diagonal.
//   * Shared-memory layout: each tile is D / BW swizzled boxes of BW
//     columns (BW = 64, 32 or 16 from D; sm90.cuh), so D = 80 needs no
//     padding: five 32-byte boxes.
//   * The softmax works in log2 units: exponentials are ex2 (the
//     instruction behind __expf), and away from the diagonal and the
//     ragged edge the scale scale * log2(e) folds into one fused
//     multiply-add per score (the row max is taken on the raw scores), so
//     each score costs a max, an FMA, an ex2 and an add.
//
// What it leaves on the table: the softmax's per-score ALU work, which
// weighs most at small D; the tensor cores idle while a warpgroup runs
// its softmax unless the other warpgroup has products queued (an
// intra-warpgroup overlap of tile j's softmax with tile j-1's PV product
// ran slower on the card at every shape tried, and was not kept); the
// ping-pong of the two warpgroups orders only the S products (it gains at
// D 128, little at D 64); one block per SM (registers); 2-stage rings;
// the epilogues store from registers (no TMA store); D = 80 loads
// 32-byte boxes (more TMA requests per byte than 128-byte rows); dkv is
// not persistent; dq's two warpgroups take no turns (a ping-pong ran
// slower), and a tile's dQ product is waited for before the next tile's S
// and dP.  At D 256: the forward's 80-key tiles cut the work of each S
// product and add softmax turns a row (and K/V tiles that straddle the
// causal diagonal); dq's 48-key tiles make S and dP m64n48 products, which
// read their 64-row A tile from shared memory for 3/4 of the work of N 64,
// and add barrier turns a row; dk/dv's 64-key blocks
// read every Q and dO tile from L2 twice as often as 128-key blocks
// would, the second warpgroup waits for the first one's P^T every tile
// (one exchange buffer, so the first runs at most one tile ahead), and
// each warpgroup waits for its own products before the next step.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "sm90.cuh"
#include "sm90_wgmma.cuh"

namespace flash90 {

using namespace sm90;

constexpr int kThreads = 384;     // producer warpgroup + 2 consumers
constexpr int kStages = 2;
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// 2^x (the MUFU instruction behind __expf)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <typename T>
__device__ __forceinline__ uint32_t pack2(float a, float b);
template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float a, float b) {
  __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&v);
}
template <>
__device__ __forceinline__ uint32_t pack2<__half>(float a, float b) {
  __half2 v = __floats2half2_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* p) {
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// the m16n8k16 A fragment of k-group kk (16 columns) from a 64 x N
// accumulator of one thread (2 rows, 2 adjacent columns per 8-column block)
template <typename T, int N>
__device__ __forceinline__ void to_a_frag(const float (&p)[N / 2], int kk,
                                          uint32_t (&a)[4]) {
  a[0] = pack2<T>(p[8 * kk + 0], p[8 * kk + 1]);
  a[1] = pack2<T>(p[8 * kk + 2], p[8 * kk + 3]);
  a[2] = pack2<T>(p[8 * kk + 4], p[8 * kk + 5]);
  a[3] = pack2<T>(p[8 * kk + 6], p[8 * kk + 7]);
}

// a 64 x N fp32 accumulator of one warpgroup (times `mul`, rounded to T)
// into rows [row0, row0 + 64) of a [rows_valid, N] row-major matrix
template <typename T, int N>
__device__ __forceinline__ void store_acc(T* __restrict__ out,
                                          const float (&acc)[N / 2], int r,
                                          int cq, int rows_valid, float mul0,
                                          float mul1) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = r + 8 * half;
    if (row >= rows_valid) continue;
    const float mul = half ? mul1 : mul0;
    uint32_t* dst = reinterpret_cast<uint32_t*>(out + (size_t)row * N + cq);
#pragma unroll
    for (int nb = 0; nb < N / 8; ++nb)
      dst[nb * 4] = pack2<T>(acc[nb * 4 + 2 * half] * mul,
                             acc[nb * 4 + 2 * half + 1] * mul);
  }
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

template <int D>
struct FwdLayout {
  static constexpr int BQ = 128;                 // query rows (2 x 64)
  // keys per tile: at D 256 a thread's O (128 fp32) leaves room for 80
  // keys of S (40 fp32), and 2-stage rings of 80-key K and V tiles (4 x
  // 40 KB) fit beside the 64 KB Q tile (64-key tiles ran slower)
  static constexpr int BK = D == 256 ? 80 : 128;
  static constexpr int BW = box_width<D>();
  static constexpr int NB = D / BW;
  static constexpr int Q_BOX = BQ * BW * 2;
  static constexpr int KV_BOX = BK * BW * 2;
  static constexpr int Q_BYTES = NB * Q_BOX;
  static constexpr int KV_BYTES = NB * KV_BOX;   // one K or V tile
  static constexpr int BARS = Q_BYTES + kStages * 2 * KV_BYTES;
  static constexpr int SMEM = 1024 + BARS + 8 * (4 * kStages + 2);
  static_assert(SMEM <= 232448, "shared memory of one block");
};

// the persistent forward's work list: tile t -> (query tile i, head, batch),
// the longest causal rows first (i from the last)
struct FwdTile {
  int i, h, b;
  __device__ __forceinline__ FwdTile(int t, int n_q, int H, int BH) {
    i = n_q - 1 - t / BH;
    h = (t % BH) % H;
    b = (t % BH) / H;
  }
};

// one warpgroup's online-softmax step on a 64 x BK score tile (in place:
// raw scores in, unnormalised probabilities out), in log2 units (scores
// times scale2) and masked when `masked`; returns each row's correction.
// An unmasked tile takes the row max of the raw scores (scale2 > 0 keeps
// the order) and folds the scale into one fused multiply-add per score.
template <int BK, bool CAUSAL>
__device__ __forceinline__ void softmax_step(float (&sc)[BK / 2], float (&m)[2],
                                             float (&l)[2], float (&corr)[2],
                                             float scale2, bool masked,
                                             int key0, int row0, int cq,
                                             int S) {
  float mx[2] = {kNegInf, kNegInf};
  if (masked) {
#pragma unroll
    for (int x = 0; x < BK / 2; ++x) {
      const int col = key0 + (x / 4) * 8 + cq + (x & 1);
      const int row = row0 + ((x & 2) ? 8 : 0);
      sc[x] = (col >= S || (CAUSAL && col > row)) ? kNegInf : sc[x] * scale2;
      mx[(x >> 1) & 1] = fmaxf(mx[(x >> 1) & 1], sc[x]);
    }
  } else {
#pragma unroll
    for (int x = 0; x < BK / 2; ++x)
      mx[(x >> 1) & 1] = fmaxf(mx[(x >> 1) & 1], sc[x]);
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], 1));
    mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], 2));
    const float m_new = fmaxf(m[e], masked ? mx[e] : mx[e] * scale2);
    corr[e] = exp2_approx(m[e] - m_new);
    m[e] = m_new;
  }
  if (masked) {
#pragma unroll
    for (int x = 0; x < BK / 2; ++x) {
      sc[x] = exp2_approx(sc[x] - m[(x >> 1) & 1]);
      sum[(x >> 1) & 1] += sc[x];
    }
  } else {
#pragma unroll
    for (int x = 0; x < BK / 2; ++x) {
      sc[x] = exp2_approx(fmaf(sc[x], scale2, -m[(x >> 1) & 1]));
      sum[(x >> 1) & 1] += sc[x];
    }
  }
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    sum[e] += __shfl_xor_sync(0xffffffffu, sum[e], 1);
    sum[e] += __shfl_xor_sync(0xffffffffu, sum[e], 2);
    l[e] = l[e] * corr[e] + sum[e];
  }
}

// Barriers (shared memory after the tiles): K and V have rings of their own,
// so a K slot is free as soon as its S product is done, a V slot once its
// PV product is
struct FwdBars {
  uint64_t full_k[kStages], empty_k[kStages];
  uint64_t full_v[kStages], empty_v[kStages];
  uint64_t q_full, q_empty;
};

template <typename T, int D, bool CAUSAL>
__global__ void __launch_bounds__(kThreads, 1)
fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
           const __grid_constant__ CUtensorMap tm_k,
           const __grid_constant__ CUtensorMap tm_v, T* __restrict__ o,
           float* __restrict__ lse, int B, int H, int Hkv, int S,
           float scale) {
  using L = FwdLayout<D>;
  constexpr int BQ = L::BQ, BK = L::BK, BW = L::BW;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  FwdBars& bar = *reinterpret_cast<FwdBars*>(smem + L::BARS);
  // K tile of ring slot s, V tile of slot s
  auto k_tile = [&](int s) { return smem + L::Q_BYTES + s * 2 * L::KV_BYTES; };
  auto v_tile = [&](int s) { return k_tile(s) + L::KV_BYTES; };

  const int n_q = (S + BQ - 1) / BQ;
  const int n_k = (S + BK - 1) / BK;
  const int BH = B * H;
  const int n_work = n_q * BH;
  auto kv_tiles = [&](int i) {
    return CAUSAL ? min((i * BQ + BQ - 1) / BK, n_k - 1) + 1 : n_k;
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&bar.full_k[s], 1);
      mbar_init(&bar.full_v[s], 1);
      mbar_init(&bar.empty_k[s], 8);            // one arrive per consumer warp
      mbar_init(&bar.empty_v[s], 8);
    }
    mbar_init(&bar.q_full, 1);
    mbar_init(&bar.q_empty, 8);
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    regs_dealloc<kProducerRegs>();
    if (threadIdx.x != 0) return;
    int kv = 0, n = 0;                          // ring position, tiles done
    for (int t = blockIdx.x; t < n_work; t += gridDim.x, ++n) {
      const FwdTile w(t, n_q, H, BH);
      const int bg = w.b * Hkv + w.h / (H / Hkv);
      mbar_wait(&bar.q_empty, (n & 1) ^ 1);     // the last tile's Q is done
      mbar_arrive_expect_tx(&bar.q_full, L::Q_BYTES);
      for (int nb = 0; nb < L::NB; ++nb)
        tma_load_3d(smem + nb * L::Q_BOX, &tm_q, &bar.q_full, nb * BW,
                    w.i * BQ, w.b * H + w.h);
      const int n_tiles = kv_tiles(w.i);
      for (int j = 0; j < n_tiles; ++j, ++kv) {
        const int s = kv % kStages;
        const uint32_t free_parity = ((kv / kStages) & 1) ^ 1;
        mbar_wait(&bar.empty_k[s], free_parity);
        mbar_arrive_expect_tx(&bar.full_k[s], L::KV_BYTES);
        for (int nb = 0; nb < L::NB; ++nb)
          tma_load_3d(k_tile(s) + nb * L::KV_BOX, &tm_k, &bar.full_k[s],
                      nb * BW, j * BK, bg);
        mbar_wait(&bar.empty_v[s], free_parity);
        mbar_arrive_expect_tx(&bar.full_v[s], L::KV_BYTES);
        for (int nb = 0; nb < L::NB; ++nb)
          tma_load_3d(v_tile(s) + nb * L::KV_BOX, &tm_v, &bar.full_v[s],
                      nb * BW, j * BK, bg);
      }
    }
    return;
  }

  // Consumers: per KV tile, S = Q K^T, the online softmax, O += P V.
  regs_alloc<kConsumerRegs>();
  const int cw = wg - 1;                        // which 64 query rows
  const int lane = threadIdx.x % 32;
  const int r = cw * 64 + (threadIdx.x % 128) / 32 * 16 + lane / 4;  // row in tile
  const int cq = (lane % 4) * 2;                // first column of each block
  const uint32_t q_addr = smem_addr(smem);
  const float scale2 = scale * kLog2e;          // exp(x) = 2^(x log2 e)

  // ping-pong: the two warpgroups take turns to issue their S products
  // (named barrier 1 + cw is this warpgroup's turn), so that one's
  // softmax runs while the other's products keep the tensor cores busy;
  // warpgroup 0 goes first
  if (cw == 1) named_bar_arrive(1, 256);
  int kv = 0, n = 0;
  for (int t = blockIdx.x; t < n_work; t += gridDim.x, ++n) {
    const FwdTile w(t, n_q, H, BH);
    const int n_tiles = kv_tiles(w.i);
    const int row0 = w.i * BQ + r;              // query rows row0, row0 + 8
    const int row_min = w.i * BQ + cw * 64;     // this warpgroup's first row
    float acc[D / 2];
#pragma unroll
    for (int x = 0; x < D / 2; ++x) acc[x] = 0.f;
    float m[2] = {kNegInf, kNegInf};            // row max, log2 units
    float l[2] = {0.f, 0.f};
    float corr[2];
    float sc[BK / 2];
    uint32_t pa[BK / 16][4];

    mbar_wait(&bar.q_full, n & 1);
    for (int j = 0; j < n_tiles; ++j) {
      const int s = (kv + j) % kStages;
      const uint32_t parity = ((kv + j) / kStages) & 1;
      const int key0 = j * BK;
      mbar_wait(&bar.full_k[s], parity);
      if (CAUSAL && BK < BQ && key0 > row_min + 63) {
        // keys past every row of this warpgroup (a diagonal tile at D 256;
        // never with BK == BQ): nothing to add; keep the turns and free
        // the slots (once filled, so that the arrivals count towards this
        // fill's phase)
        named_bar_sync(1 + cw, 256);
        named_bar_arrive(2 - cw, 256);
        mbar_wait(&bar.full_v[s], parity);
        if (lane == 0) {
          mbar_arrive(&bar.empty_k[s]);
          mbar_arrive(&bar.empty_v[s]);
          if (j == n_tiles - 1) mbar_arrive(&bar.q_empty);
        }
        continue;
      }
      const uint32_t k_addr = smem_addr(k_tile(s));
      named_bar_sync(1 + cw, 256);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < D / 16; ++k)
        wgmma_ss<T, BK>(sc, desc_kmajor<BW>(q_addr, L::Q_BOX, cw * 64, k),
                        desc_kmajor<BW>(k_addr, L::KV_BOX, 0, k), k > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      named_bar_arrive(2 - cw, 256);            // the other one's turn
      if (lane == 0) {
        mbar_arrive(&bar.empty_k[s]);
        if (j == n_tiles - 1) mbar_arrive(&bar.q_empty);
      }
      softmax_step<BK, CAUSAL>(
          sc, m, l, corr, scale2,
          key0 + BK > S || (CAUSAL && key0 + BK - 1 > row_min), key0, row0,
          cq, S);
#pragma unroll
      for (int x = 0; x < D / 2; ++x) acc[x] *= corr[(x >> 1) & 1];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) to_a_frag<T, BK>(sc, kk, pa[kk]);

      mbar_wait(&bar.full_v[s], parity);
      const uint32_t v_addr = smem_addr(v_tile(s));
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_rs<T, D>(acc, pa[kk], desc_mnmajor<BW>(v_addr, L::KV_BOX, kk));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      if (lane == 0) mbar_arrive(&bar.empty_v[s]);
    }
    kv += n_tiles;

    const float lc0 = fmaxf(l[0], 1e-30f), lc1 = fmaxf(l[1], 1e-30f);
    const size_t bh = (size_t)w.b * H + w.h;
    store_acc<T, D>(o + (bh * S + (size_t)w.i * BQ) * D, acc, r, cq,
                    S - w.i * BQ, 1.f / lc0, 1.f / lc1);
    if (lane % 4 == 0) {
      if (row0 < S) lse[bh * S + row0] = m[0] * kLn2 + logf(lc0);
      if (row0 + 8 < S) lse[bh * S + row0 + 8] = m[1] * kLn2 + logf(lc1);
    }
  }
}

// ---------------------------------------------------------------------------
// backward: dk, dv
// ---------------------------------------------------------------------------

template <int D>
struct DkvLayout {
  static constexpr int BKV = 128;                // keys (2 x 64)
  static constexpr int BQ = 64;                  // query rows per tile
  static constexpr int BW = box_width<D>();
  static constexpr int NB = D / BW;
  static constexpr int KV_BOX = BKV * BW * 2;
  static constexpr int Q_BOX = BQ * BW * 2;
  static constexpr int KV_BYTES = NB * KV_BOX;   // the K or the V tile
  static constexpr int Q_BYTES = NB * Q_BOX;     // one Q or dO tile
  static constexpr int STAGE = 2 * Q_BYTES + 2 * BQ * 4;   // + lse, delta
  static constexpr int BARS = 2 * KV_BYTES + kStages * STAGE;
  static constexpr int SMEM = 1024 + BARS + 8 * (2 * kStages + 1);
  static_assert(SMEM <= 232448, "shared memory of one block");
  static_assert(STAGE % 1024 == 512, "stages stay 512-byte aligned");
};

// The dk/dv producer warp (both designs): the block's K and V tiles once,
// then, through the 2-stage ring, each item's Q and dO tiles and its rows'
// lse (log2 units) and delta; item it is q tile i_first + it % per_head of
// head bh0 + it / per_head
template <typename L>
__device__ __forceinline__ void dkv_produce(
    unsigned char* smem, uint64_t* full, uint64_t* empty, uint64_t* kvbar,
    const CUtensorMap* tm_q, const CUtensorMap* tm_k, const CUtensorMap* tm_v,
    const CUtensorMap* tm_do, const float* __restrict__ lse,
    const float* __restrict__ delta, int j, int bg, int bh0, int S,
    int i_first, int per_head, int n_items, int lane) {
  constexpr int BQ = L::BQ, BW = L::BW;
  if (lane == 0) {
    mbar_arrive_expect_tx(kvbar, 2 * L::KV_BYTES);
    for (int nb = 0; nb < L::NB; ++nb) {
      tma_load_3d(smem + nb * L::KV_BOX, tm_k, kvbar, nb * BW, j * L::BKV, bg);
      tma_load_3d(smem + L::KV_BYTES + nb * L::KV_BOX, tm_v, kvbar, nb * BW,
                  j * L::BKV, bg);
    }
  }
  for (int it = 0; it < n_items; ++it) {
    const int s = it % kStages;
    const int i = i_first + it % per_head;
    const int bh = bh0 + it / per_head;
    unsigned char* st = smem + 2 * L::KV_BYTES + s * L::STAGE;
    float* ls = reinterpret_cast<float*>(st + 2 * L::Q_BYTES);
    mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
    if (lane == 0) {
      mbar_arrive_expect_tx(&full[s], 2 * L::Q_BYTES);
      for (int nb = 0; nb < L::NB; ++nb) {
        tma_load_3d(st + nb * L::Q_BOX, tm_q, &full[s], nb * BW, i * BQ, bh);
        tma_load_3d(st + L::Q_BYTES + nb * L::Q_BOX, tm_do, &full[s], nb * BW,
                    i * BQ, bh);
      }
    }
    for (int t = lane; t < BQ; t += 32) {
      const int row = i * BQ + t;
      const size_t at = (size_t)bh * S + row;
      ls[t] = row < S ? lse[at] * kLog2e : 0.f;  // log2 units
      ls[BQ + t] = row < S ? delta[at] : 0.f;
    }
    mbar_arrive(&full[s]);                      // this lane's rows are written
  }
}

template <typename T, int D, bool CAUSAL>
__global__ void __launch_bounds__(kThreads, 1)
dkv_kernel(const __grid_constant__ CUtensorMap tm_q,
           const __grid_constant__ CUtensorMap tm_k,
           const __grid_constant__ CUtensorMap tm_v,
           const __grid_constant__ CUtensorMap tm_do,
           const float* __restrict__ lse, const float* __restrict__ delta,
           T* __restrict__ dk, T* __restrict__ dv, int H, int Hkv, int S,
           float scale) {
  using L = DkvLayout<D>;
  constexpr int BKV = L::BKV, BQ = L::BQ, BW = L::BW;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* empty = full + kStages;
  uint64_t* kvbar = empty + kStages;

  const int j = blockIdx.x;
  const int g = blockIdx.y;
  const int b = blockIdx.z;
  const int rep = H / Hkv;
  const int bg = b * Hkv + g;
  const int n_q = (S + BQ - 1) / BQ;
  // causal: query tiles above this KV tile see none of its keys
  const int i_first = CAUSAL ? (j * BKV) / BQ : 0;
  const int per_head = n_q - i_first;
  const int n_items = rep * per_head;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 33);                  // lane 0's expect_tx + 32 lanes
      mbar_init(&empty[s], 8);
    }
    mbar_init(kvbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x % 32;
  if (wg == 0) {
    regs_dealloc<kProducerRegs>();
    if (threadIdx.x >= 32) return;
    dkv_produce<L>(smem, full, empty, kvbar, &tm_q, &tm_k, &tm_v, &tm_do, lse,
                   delta, j, bg, b * H + g * rep, S, i_first, per_head,
                   n_items, lane);
    return;
  }

  regs_alloc<kConsumerRegs>();
  const int cw = wg - 1;                        // which 64 keys
  const int r = cw * 64 + (threadIdx.x % 128) / 32 * 16 + lane / 4;  // key in tile
  const int cq = (lane % 4) * 2;
  const int kr0 = j * BKV + r;                  // keys kr0, kr0 + 8
  const uint32_t k_addr = smem_addr(smem);
  const uint32_t v_addr = k_addr + L::KV_BYTES;
  const float scale2 = scale * kLog2e;          // exp(x) = 2^(x log2 e)

  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int x = 0; x < D / 2; ++x) dk_acc[x] = dv_acc[x] = 0.f;

  mbar_wait(kvbar, 0);
  for (int it = 0; it < n_items; ++it) {
    const int s = it % kStages;
    const int i = i_first + it % per_head;
    const uint32_t q_addr = k_addr + 2 * L::KV_BYTES + s * L::STAGE;
    const uint32_t do_addr = q_addr + L::Q_BYTES;
    const float* ls = reinterpret_cast<const float*>(
        smem + 2 * L::KV_BYTES + s * L::STAGE + 2 * L::Q_BYTES);
    mbar_wait(&full[s], (it / kStages) & 1);

    float st[BQ / 2], dp[BQ / 2];
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < D / 16; ++k)                       // S^T = K Q^T
      wgmma_ss<T, BQ>(st, desc_kmajor<BW>(k_addr, L::KV_BOX, cw * 64, k),
                      desc_kmajor<BW>(q_addr, L::Q_BOX, 0, k), k > 0);
    wgmma_commit();
#pragma unroll
    for (int k = 0; k < D / 16; ++k)                       // dP^T = V dO^T
      wgmma_ss<T, BQ>(dp, desc_kmajor<BW>(v_addr, L::KV_BOX, cw * 64, k),
                      desc_kmajor<BW>(do_addr, L::Q_BOX, 0, k), k > 0);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(st);

    const bool masked = (i + 1) * BQ > S || kr0 - r + BKV > S ||
                        (CAUSAL && j * BKV + cw * 64 + 63 > i * BQ);
#pragma unroll
    for (int x = 0; x < BQ / 2; ++x) {
      const int c = (x / 4) * 8 + cq + (x & 1);             // query in tile
      float p = exp2_approx(fmaf(st[x], scale2, -ls[c]));
      if (masked) {
        const int qc = i * BQ + c;
        const int kr = kr0 + ((x & 2) ? 8 : 0);
        if (kr >= S || qc >= S || (CAUSAL && kr > qc)) p = 0.f;
      }
      st[x] = p;
    }
    uint32_t pa[BQ / 16][4];
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) to_a_frag<T, BQ>(st, kk, pa[kk]);
    wgmma_wait<0>();
    fence_regs(dp);
#pragma unroll
    for (int x = 0; x < BQ / 2; ++x) {
      const int c = (x / 4) * 8 + cq + (x & 1);
      dp[x] = st[x] * (dp[x] - ls[BQ + c]);
    }
    uint32_t da[BQ / 16][4];
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) to_a_frag<T, BQ>(dp, kk, da[kk]);

    fence_regs(dk_acc);
    fence_regs(dv_acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)                   // dV += P^T dO
      wgmma_rs<T, D>(dv_acc, pa[kk], desc_mnmajor<BW>(do_addr, L::Q_BOX, kk));
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)                   // dK += dS^T Q
      wgmma_rs<T, D>(dk_acc, da[kk], desc_mnmajor<BW>(q_addr, L::Q_BOX, kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dk_acc);
    fence_regs(dv_acc);
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  const size_t base = ((size_t)bg * S + (size_t)j * BKV) * D;
  const int rows_valid = S - j * BKV;
  store_acc<T, D>(dk + base, dk_acc, r, cq, rows_valid, scale, scale);
  store_acc<T, D>(dv + base, dv_acc, r, cq, rows_valid, 1.f, 1.f);
}

// dk/dv at D 256: a warpgroup's dK and dV over 64 keys are 256 fp32
// registers a thread, more than it has, so the two consumer warpgroups
// split the four products of one 64-key tile: warpgroup 1 owns dV (S^T =
// K Q^T, P^T, dV += P^T dO), warpgroup 2 owns dK (dP^T = V dO^T, dS^T =
// P^T (dP^T - delta), dK += dS^T Q).  P^T passes from 1 to 2 in fp32
// through shared memory (dS is formed from the unrounded P), each thread
// to the thread of warpgroup 2 that holds the same accumulator entries.
template <int D>
struct DkvSplitLayout {
  static constexpr int BKV = 64;                 // keys
  static constexpr int BQ = 64;                  // query rows per tile
  static constexpr int BW = box_width<D>();
  static constexpr int NB = D / BW;
  static constexpr int KV_BOX = BKV * BW * 2;
  static constexpr int Q_BOX = BQ * BW * 2;
  static constexpr int KV_BYTES = NB * KV_BOX;   // the K or the V tile
  static constexpr int Q_BYTES = NB * Q_BOX;     // one Q or dO tile
  // a stage: Q, dO, then lse and delta (2 * BQ fp32), padded so that the
  // next stage's boxes stay 1024-byte aligned
  static constexpr int STAGE = 2 * Q_BYTES + 1024;
  static constexpr int PT = 2 * KV_BYTES + kStages * STAGE;  // P^T, fp32
  static constexpr int BARS = PT + BKV * BQ * 4;
  static constexpr int SMEM = 1024 + BARS + 8 * (2 * kStages + 1);
  static_assert(2 * BQ * 4 <= 1024 && STAGE % 1024 == 0,
                "the rows fit the padding; stages stay 1024-byte aligned");
  static_assert(SMEM <= 232448, "shared memory of one block");
};

template <typename T, int D, bool CAUSAL>
__global__ void __launch_bounds__(kThreads, 1)
dkv_split_kernel(const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v,
                 const __grid_constant__ CUtensorMap tm_do,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, T* __restrict__ dk,
                 T* __restrict__ dv, int B, int H, int Hkv, int S,
                 float scale) {
  using L = DkvSplitLayout<D>;
  constexpr int BKV = L::BKV, BQ = L::BQ, BW = L::BW;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* empty = full + kStages;
  uint64_t* kvbar = empty + kStages;

  // block -> (KV tile j, KV head g, batch b), the longest causal runs
  // (j from 0) first
  const int j = blockIdx.x / (Hkv * B);
  const int g = blockIdx.x % Hkv;
  const int b = blockIdx.x % (Hkv * B) / Hkv;
  const int rep = H / Hkv;
  const int bg = b * Hkv + g;
  const int n_q = (S + BQ - 1) / BQ;
  // causal: query tiles above this KV tile see none of its keys
  const int i_first = CAUSAL ? (j * BKV) / BQ : 0;
  const int per_head = n_q - i_first;
  const int n_items = rep * per_head;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 33);                  // lane 0's expect_tx + 32 lanes
      mbar_init(&empty[s], 8);                  // both warpgroups' warps
    }
    mbar_init(kvbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x % 32;
  if (wg == 0) {
    regs_dealloc<kProducerRegs>();
    if (threadIdx.x >= 32) return;
    dkv_produce<L>(smem, full, empty, kvbar, &tm_q, &tm_k, &tm_v, &tm_do, lse,
                   delta, j, bg, b * H + g * rep, S, i_first, per_head,
                   n_items, lane);
    return;
  }

  regs_alloc<kConsumerRegs>();
  const int cw = wg - 1;                        // 0: dV, 1: dK
  const int tid = threadIdx.x % 128;
  const int r = tid / 32 * 16 + lane / 4;       // key in tile
  const int cq = (lane % 4) * 2;
  const int kr0 = j * BKV + r;                  // keys kr0, kr0 + 8
  // warpgroup 1 reads K, warpgroup 2 V
  const uint32_t kv_addr = smem_addr(smem) + cw * L::KV_BYTES;
  // P^T as [32 / 4][128 threads] float4: a thread's 32 entries, written by
  // warpgroup 1's thread tid and read by warpgroup 2's (conflict-free)
  float4* pt = reinterpret_cast<float4*>(smem + L::PT) + tid;
  const float scale2 = scale * kLog2e;          // exp(x) = 2^(x log2 e)

  float acc[D / 2];
#pragma unroll
  for (int x = 0; x < D / 2; ++x) acc[x] = 0.f;

  mbar_wait(kvbar, 0);
  for (int it = 0; it < n_items; ++it) {
    const int s = it % kStages;
    const int i = i_first + it % per_head;
    const uint32_t q_addr = smem_addr(smem) + 2 * L::KV_BYTES + s * L::STAGE;
    const uint32_t do_addr = q_addr + L::Q_BYTES;
    const float* ls = reinterpret_cast<const float*>(
        smem + 2 * L::KV_BYTES + s * L::STAGE + 2 * L::Q_BYTES);
    mbar_wait(&full[s], (it / kStages) & 1);

    // warpgroup 1: S^T = K Q^T; warpgroup 2: dP^T = V dO^T
    float sc[BQ / 2];
    const uint32_t rhs = cw ? do_addr : q_addr;
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < D / 16; ++k)
      wgmma_ss<T, BQ>(sc, desc_kmajor<BW>(kv_addr, L::KV_BOX, 0, k),
                      desc_kmajor<BW>(rhs, L::Q_BOX, 0, k), k > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);

    uint32_t a[BQ / 16][4];
    if (cw == 0) {
      const bool masked = (i + 1) * BQ > S || j * BKV + BKV > S ||
                          (CAUSAL && j * BKV + BKV - 1 > i * BQ);
#pragma unroll
      for (int x = 0; x < BQ / 2; ++x) {
        const int c = (x / 4) * 8 + cq + (x & 1);             // query in tile
        float p = exp2_approx(fmaf(sc[x], scale2, -ls[c]));
        if (masked) {
          const int qc = i * BQ + c;
          const int kr = kr0 + ((x & 2) ? 8 : 0);
          if (kr >= S || qc >= S || (CAUSAL && kr > qc)) p = 0.f;
        }
        sc[x] = p;
      }
      if (it > 0) named_bar_sync(2, 256);       // the last P^T has been read
#pragma unroll
      for (int x = 0; x < BQ / 8; ++x)
        pt[x * 128] = make_float4(sc[4 * x], sc[4 * x + 1], sc[4 * x + 2],
                                  sc[4 * x + 3]);
      named_bar_arrive(1, 256);                 // P^T is written
    } else {
      named_bar_sync(1, 256);
#pragma unroll
      for (int x = 0; x < BQ / 8; ++x) {
        const float4 p = pt[x * 128];
        const float pv[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int y = 4 * x + e;
          const int c = (y / 4) * 8 + cq + (y & 1);
          sc[y] = pv[e] * (sc[y] - ls[BQ + c]);
        }
      }
      if (it + 1 < n_items) named_bar_arrive(2, 256);  // P^T's slot is free
    }
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) to_a_frag<T, BQ>(sc, kk, a[kk]);

    // warpgroup 1: dV += P^T dO; warpgroup 2: dK += dS^T Q
    const uint32_t mn = cw ? q_addr : do_addr;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      wgmma_rs<T, D>(acc, a[kk], desc_mnmajor<BW>(mn, L::Q_BOX, kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  const size_t base = ((size_t)bg * S + (size_t)j * BKV) * D;
  const float mul = cw ? scale : 1.f;
  store_acc<T, D>((cw ? dk : dv) + base, acc, r, cq, S - j * BKV, mul, mul);
}

// ---------------------------------------------------------------------------
// backward: dq
// ---------------------------------------------------------------------------

// Barriers of dq (shared memory after the rows): K and V rings as in the
// forward; Q, dO and the rows arrive once
struct DqBars {
  uint64_t full_k[kStages], empty_k[kStages];
  uint64_t full_v[kStages], empty_v[kStages];
  uint64_t q_full;
};

template <int D>
struct DqLayout {
  static constexpr int BQ = 128;                 // query rows (2 x 64)
  // keys per tile: S, dP (BK / 2 fp32 each) and dQ (D / 2) live in
  // registers together; 128 keys spill at D <= 80 and ran slower; at D 256
  // (dQ 128 registers) 48: 2-stage rings of 64-key K and V tiles (128 KB)
  // do not fit beside Q and dO (128 KB), and 32 keys ran 21% slower
  static constexpr int BK = D == 256 ? 48 : 64;
  static constexpr int BW = box_width<D>();
  static constexpr int NB = D / BW;
  static constexpr int Q_BOX = BQ * BW * 2;
  static constexpr int KV_BOX = BK * BW * 2;
  static constexpr int Q_BYTES = NB * Q_BOX;     // the Q or the dO tile
  static constexpr int KV_BYTES = NB * KV_BOX;   // one K or V tile
  static constexpr int ROWS = 2 * Q_BYTES + kStages * 2 * KV_BYTES;  // lse, delta
  static constexpr int BARS = ROWS + 2 * BQ * 4;
  static constexpr int SMEM = 1024 + BARS + sizeof(DqBars);
  static_assert(SMEM <= 232448, "shared memory of one block");
  static_assert(KV_BOX % 1024 == 0, "boxes stay 1024-byte aligned");
};

// dq: one block per (q tile of 128 rows, head, batch), longest causal rows
// first; per KV tile of the GQA head, S = Q K^T and dP = dO V^T from shared
// memory, P and dS on the accumulators' layout, dQ += dS K with dS from
// registers and K read MN-major from the tile the S product read K-major.
// dQ stays in registers for the whole loop.
template <typename T, int D, bool CAUSAL>
__global__ void __launch_bounds__(kThreads, 1)
dq_kernel(const __grid_constant__ CUtensorMap tm_q,
          const __grid_constant__ CUtensorMap tm_k,
          const __grid_constant__ CUtensorMap tm_v,
          const __grid_constant__ CUtensorMap tm_do,
          const float* __restrict__ lse, const float* __restrict__ delta,
          T* __restrict__ dq, int B, int H, int Hkv, int S, float scale) {
  using L = DqLayout<D>;
  constexpr int BQ = L::BQ, BK = L::BK, BW = L::BW;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  DqBars& bar = *reinterpret_cast<DqBars*>(smem + L::BARS);
  float* rows = reinterpret_cast<float*>(smem + L::ROWS);  // lse (log2), delta
  auto k_tile = [&](int s) { return smem + 2 * L::Q_BYTES + s * 2 * L::KV_BYTES; };
  auto v_tile = [&](int s) { return k_tile(s) + L::KV_BYTES; };

  const int n_q = (S + BQ - 1) / BQ;
  const int n_k = (S + BK - 1) / BK;
  const FwdTile w(blockIdx.x, n_q, H, B * H);
  const int bh = w.b * H + w.h;
  // KV tiles up to the diagonal of query rows [row, row + n)
  auto kv_tiles = [&](int row, int n) {
    return CAUSAL ? min((row + n - 1) / BK, n_k - 1) + 1 : n_k;
  };
  const int n_tiles = kv_tiles(w.i * BQ, BQ);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&bar.full_k[s], 1);
      mbar_init(&bar.full_v[s], 1);
      mbar_init(&bar.empty_k[s], 8);            // one arrive per consumer warp
      mbar_init(&bar.empty_v[s], 8);
    }
    // lane 0's expect_tx, then every producer lane once its rows are written
    mbar_init(&bar.q_full, 33);
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x % 32;
  if (wg == 0) {
    regs_dealloc<kProducerRegs>();
    if (threadIdx.x >= 32) return;
    const int bg = w.b * Hkv + w.h / (H / Hkv);
    if (lane == 0) {
      mbar_arrive_expect_tx(&bar.q_full, 2 * L::Q_BYTES);
      for (int nb = 0; nb < L::NB; ++nb) {
        tma_load_3d(smem + nb * L::Q_BOX, &tm_q, &bar.q_full, nb * BW,
                    w.i * BQ, bh);
        tma_load_3d(smem + L::Q_BYTES + nb * L::Q_BOX, &tm_do, &bar.q_full,
                    nb * BW, w.i * BQ, bh);
      }
    }
    for (int x = lane; x < BQ; x += 32) {       // rows past S read as 0
      const int row = w.i * BQ + x;
      const size_t at = (size_t)bh * S + row;
      rows[x] = row < S ? lse[at] * kLog2e : 0.f;   // log2 units
      rows[BQ + x] = row < S ? delta[at] : 0.f;
    }
    mbar_arrive(&bar.q_full);
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % kStages;
      const uint32_t free_parity = ((j / kStages) & 1) ^ 1;
      mbar_wait(&bar.empty_k[s], free_parity);
      if (lane == 0) {
        mbar_arrive_expect_tx(&bar.full_k[s], L::KV_BYTES);
        for (int nb = 0; nb < L::NB; ++nb)
          tma_load_3d(k_tile(s) + nb * L::KV_BOX, &tm_k, &bar.full_k[s],
                      nb * BW, j * BK, bg);
      }
      mbar_wait(&bar.empty_v[s], free_parity);
      if (lane == 0) {
        mbar_arrive_expect_tx(&bar.full_v[s], L::KV_BYTES);
        for (int nb = 0; nb < L::NB; ++nb)
          tma_load_3d(v_tile(s) + nb * L::KV_BOX, &tm_v, &bar.full_v[s],
                      nb * BW, j * BK, bg);
      }
    }
    return;
  }

  // Consumers: per KV tile, S = Q K^T and dP = dO V^T, P and dS, dQ += dS K.
  regs_alloc<kConsumerRegs>();
  const int cw = wg - 1;                        // which 64 query rows
  const int r = cw * 64 + (threadIdx.x % 128) / 32 * 16 + lane / 4;  // row in tile
  const int cq = (lane % 4) * 2;                // first column of each block
  const uint32_t q_addr = smem_addr(smem);
  const uint32_t do_addr = q_addr + L::Q_BYTES;
  const float scale2 = scale * kLog2e;          // exp(x) = 2^(x log2 e)
  const int row_min = w.i * BQ + cw * 64;       // this warpgroup's first row
  // tiles past this warpgroup's diagonal (causal, BK < BQ) are all masked
  const int n_mine = kv_tiles(row_min, 64);
  const int row0 = w.i * BQ + r;                // query rows row0, row0 + 8
  float acc[D / 2];
#pragma unroll
  for (int x = 0; x < D / 2; ++x) acc[x] = 0.f;

  mbar_wait(&bar.q_full, 0);
  const float ls[2] = {rows[r], rows[r + 8]};
  const float dl[2] = {rows[BQ + r], rows[BQ + r + 8]};
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % kStages;
    const uint32_t parity = (j / kStages) & 1;
    mbar_wait(&bar.full_k[s], parity);
    if (j >= n_mine) {                          // nothing to add: free the slots
      mbar_wait(&bar.full_v[s], parity);
      if (lane == 0) {
        mbar_arrive(&bar.empty_k[s]);
        mbar_arrive(&bar.empty_v[s]);
      }
      continue;
    }
    const uint32_t k_addr = smem_addr(k_tile(s));
    const uint32_t v_addr = smem_addr(v_tile(s));
    float sc[BK / 2], dp[BK / 2];
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < D / 16; ++k)                        // S = Q K^T
      wgmma_ss<T, BK>(sc, desc_kmajor<BW>(q_addr, L::Q_BOX, cw * 64, k),
                      desc_kmajor<BW>(k_addr, L::KV_BOX, 0, k), k > 0);
    wgmma_commit();
    mbar_wait(&bar.full_v[s], parity);
#pragma unroll
    for (int k = 0; k < D / 16; ++k)                        // dP = dO V^T
      wgmma_ss<T, BK>(dp, desc_kmajor<BW>(do_addr, L::Q_BOX, cw * 64, k),
                      desc_kmajor<BW>(v_addr, L::KV_BOX, 0, k), k > 0);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(sc);

    const int key0 = j * BK;
    if (key0 + BK > S || (CAUSAL && key0 + BK - 1 > row_min)) {
#pragma unroll
      for (int x = 0; x < BK / 2; ++x) {
        const int col = key0 + (x / 4) * 8 + cq + (x & 1);
        const int row = row0 + ((x & 2) ? 8 : 0);
        sc[x] = (col >= S || (CAUSAL && col > row))
                    ? 0.f
                    : exp2_approx(fmaf(sc[x], scale2, -ls[(x >> 1) & 1]));
      }
    } else {
#pragma unroll
      for (int x = 0; x < BK / 2; ++x)
        sc[x] = exp2_approx(fmaf(sc[x], scale2, -ls[(x >> 1) & 1]));
    }
    wgmma_wait<0>();
    fence_regs(dp);
    if (lane == 0) mbar_arrive(&bar.empty_v[s]);
    uint32_t da[BK / 16][4];
#pragma unroll
    for (int x = 0; x < BK / 2; ++x)
      dp[x] = sc[x] * (dp[x] - dl[(x >> 1) & 1]);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) to_a_frag<T, BK>(dp, kk, da[kk]);

    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)                    // dQ += dS K
      wgmma_rs<T, D>(acc, da[kk], desc_mnmajor<BW>(k_addr, L::KV_BOX, kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    if (lane == 0) mbar_arrive(&bar.empty_k[s]);
  }

  store_acc<T, D>(dq + ((size_t)bh * S + (size_t)w.i * BQ) * D, acc, r, cq,
                  S - w.i * BQ, scale, scale);
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

// the SM count of the current device (the persistent grid's size)
inline cudaError_t num_sms(int* n) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  return cudaDeviceGetAttribute(n, cudaDevAttrMultiProcessorCount, dev);
}

template <typename T>
constexpr bool is_fp16() {
  return std::is_same<T, __half>::value;
}

template <typename T, int D, bool C>
cudaError_t fwd_launch(const void* q, const void* k, const void* v, void* o,
                       void* lse, int B, int H, int Hkv, int S, float scale,
                       cudaStream_t st) {
  using L = FwdLayout<D>;
  CUtensorMap mq, mk, mv;
  cudaError_t e;
  if ((e = make_map_3d<L::BW>(&mq, q, is_fp16<T>(), D, S, B * H, L::BQ)) ||
      (e = make_map_3d<L::BW>(&mk, k, is_fp16<T>(), D, S, B * Hkv, L::BK)) ||
      (e = make_map_3d<L::BW>(&mv, v, is_fp16<T>(), D, S, B * Hkv, L::BK)))
    return e;
  e = cudaFuncSetAttribute(fwd_kernel<T, D, C>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
  if (e != cudaSuccess) return e;
  int sms = 0;
  if ((e = num_sms(&sms)) != cudaSuccess) return e;
  const long n_work = (long)((S + L::BQ - 1) / L::BQ) * B * H;
  const unsigned grid = (unsigned)(n_work < sms ? n_work : sms);
  fwd_kernel<T, D, C><<<grid, kThreads, L::SMEM, st>>>(mq, mk, mv, static_cast<T*>(o),
                              static_cast<float*>(lse), B, H, Hkv, S, scale);
  return cudaGetLastError();
}

template <typename T, int D, bool C>
cudaError_t dq_launch(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dq, int B, int H, int Hkv, int S, float scale,
                      cudaStream_t st) {
  using L = DqLayout<D>;
  CUtensorMap mq, mk, mv, mdo;
  cudaError_t e;
  if ((e = make_map_3d<L::BW>(&mq, q, is_fp16<T>(), D, S, B * H, L::BQ)) ||
      (e = make_map_3d<L::BW>(&mdo, dout, is_fp16<T>(), D, S, B * H, L::BQ)) ||
      (e = make_map_3d<L::BW>(&mk, k, is_fp16<T>(), D, S, B * Hkv, L::BK)) ||
      (e = make_map_3d<L::BW>(&mv, v, is_fp16<T>(), D, S, B * Hkv, L::BK)))
    return e;
  e = cudaFuncSetAttribute(dq_kernel<T, D, C>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
  if (e != cudaSuccess) return e;
  // one block per (q tile, head, batch): it beat a persistent grid;
  // DqLayout<D> picks the tiles (48 keys at D 256)
  const unsigned grid = (unsigned)((S + L::BQ - 1) / L::BQ) * B * H;
  dq_kernel<T, D, C><<<grid, kThreads, L::SMEM, st>>>(
      mq, mk, mv, mdo, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dq), B, H, Hkv, S,
      scale);
  return cudaGetLastError();
}

// D <= 128: dkv_kernel (each warpgroup 64 of 128 keys, all four
// products); D 256: dkv_split_kernel (64 keys, the products split)
template <typename T, int D, bool C>
cudaError_t dkv_launch(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, int B, int H, int Hkv, int S,
                       float scale, cudaStream_t st) {
  constexpr bool split = D > 128;
  using L = typename std::conditional<split, DkvSplitLayout<D>,
                                      DkvLayout<D>>::type;
  CUtensorMap mq, mk, mv, mdo;
  cudaError_t e;
  if ((e = make_map_3d<L::BW>(&mq, q, is_fp16<T>(), D, S, B * H, L::BQ)) ||
      (e = make_map_3d<L::BW>(&mdo, dout, is_fp16<T>(), D, S, B * H, L::BQ)) ||
      (e = make_map_3d<L::BW>(&mk, k, is_fp16<T>(), D, S, B * Hkv, L::BKV)) ||
      (e = make_map_3d<L::BW>(&mv, v, is_fp16<T>(), D, S, B * Hkv, L::BKV)))
    return e;
  const int n_kv = (S + L::BKV - 1) / L::BKV;
  const float* ls = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  if constexpr (split) {
    e = cudaFuncSetAttribute(dkv_split_kernel<T, D, C>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             L::SMEM);
    if (e != cudaSuccess) return e;
    dkv_split_kernel<T, D, C><<<(unsigned)n_kv * Hkv * B, kThreads, L::SMEM,
                                st>>>(mq, mk, mv, mdo, ls, dl,
                                      static_cast<T*>(dk), static_cast<T*>(dv),
                                      B, H, Hkv, S, scale);
  } else {
    e = cudaFuncSetAttribute(dkv_kernel<T, D, C>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             L::SMEM);
    if (e != cudaSuccess) return e;
    dkv_kernel<T, D, C><<<dim3(n_kv, Hkv, B), kThreads, L::SMEM, st>>>(
        mq, mk, mv, mdo, ls, dl, static_cast<T*>(dk), static_cast<T*>(dv), H,
        Hkv, S, scale);
  }
  return cudaGetLastError();
}

}  // namespace flash90
