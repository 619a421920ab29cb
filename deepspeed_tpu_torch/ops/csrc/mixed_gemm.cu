// Mixed-input GEMM for Hopper (sm_90a): bf16 activations x int8 or packed
// int4 weights, dequantized in registers, fp32 accumulation on the tensor
// cores.
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
// Dequantization, a few instructions a weight, exact: an int8 code b
// (stored as the byte b ^ 0x80 = b + 128 after one XOR a word) goes under
// the fp32 2^23 by a byte permute (prmt) and loses 2^23 + 128 in one fp32
// subtraction; its bf16 is the upper half of that fp32 (8 significant
// bits at most), so a second prmt packs two of them into a bf16 pair.  An
// int4 nibble n (XOR 8: n + 8) goes under the bf16 128.0 by a prmt and
// one LOP3 and loses 136.0 in one bf16x2 subtraction.  The pair is then
// multiplied by its bf16 scales in one bf16x2 multiply: one rounding of an
// exact product, the reference's bits.
//
// What bounds it on an H100 (3.35 TB/s, 989 TFLOP/s bf16 dense):
//   * decode (M <= 32): the weight bytes, 1 (int8) or 1/2 (int4) byte per
//     weight; the point of the layout is that only those bytes cross HBM.
//   * prefill (M above): the flops, 2 M K N.
//
// Two designs; the wrapper picks one from M (mixed_gemm.py: design_for,
// threshold DECODE_MAX_M = 32, set by A/B on the card, PERF.md):
//
// A. decode -- split-K weight streaming on mma.sync.  A block owns a strip
//    of 128 output columns and a contiguous range of the code rows; the
//    grid is (strips, split) with the split chosen by the wrapper so that
//    every projection launches at least two blocks an SM.  A producer warp
//    keeps an 8-stage ring of 32-row code tiles (TMA, 128-byte swizzle),
//    their x columns (TMA, rows past M zero-filled) and scales (bulk copy)
//    in flight on mbarriers: 32 KB of codes a block.  Four consumer warps
//    take the stages in turn; each dequantizes its stage in registers and
//    runs m16n8k16 products in the swapped form out^T = W^T x^T, so the
//    weights fill the 16-row side and M (<= 8 a tile, MT tiles) the 8-row
//    side.  A thread reads 16 consecutive codes of a row (one 16-byte
//    load): its A rows g and g + 8 of n-tile j are columns 16 g + 2 j and
//    16 g + 2 j + 1, so its 8 tiles' outputs are 16 consecutive columns.
//    The k slots of a product map to the code rows so that each x fragment
//    is one 32-bit load (int4: slots 0-7 the low nibbles, 8-15 the high
//    ones of 8 byte rows).  The warps' sums meet in shared memory in warp
//    order; with a split, each block writes its partial to an fp32
//    workspace and the last block of a strip to arrive (a counter in the
//    workspace, reset by that block) sums the partials in split order: the
//    output is the same bits from run to run.
// B. prefill -- wgmma with the weights dequantized into shared memory.  A
//    block owns a 128 x 128 or 256 x 128 output tile (the wrapper's
//    prefill_rows: 256 rows where that still leaves a tile for every two
//    SMs); warpgroup 0's first thread keeps a 4-stage ring of x tiles
//    (K-major, TMA), code tiles (TMA) and scales (bulk copy) in flight; the
//    two consumer warpgroups dequantize each code tile into a bf16 B tile
//    (MN-major, 128-byte swizzle; 3 buffers), fence it to the async proxy,
//    meet at a named barrier and run m64n128k16 wgmmas (A and B from shared
//    memory; one or two 64-row products each) into fp32 registers, one
//    stage's products in flight while the next stage dequantizes.
//    int4 dequantizes the low and high nibbles of a 32-row code tile into
//    two B tiles, one against x[:, k] and one against x[:, K/2 + k].  The
//    epilogue writes bf16 or fp32 from registers, rows past M masked.
//
// What it leaves on the table (later work): the decode grid is not
// persistent (a wave's tail); prefill runs one block an SM with no
// persistent tile loop (the epilogue does not overlap the next tile's
// loads), re-dequantizes a code tile once per 128 or 256 rows of M, and
// both warpgroups read the B tile from shared memory (dequantizing into
// registers as wgmma's A operand, out^T = W^T x^T, would not).
//
// Supported: K % 32 == 0 (int8) or K % 64 == 0 (int4), N % 16 == 0,
// 16-byte aligned x, weights, scales and out.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"
#include "sm90_wgmma.cuh"

namespace mixed {

using namespace sm90;

// ---------------------------------------------------------------------------
// dequantization in registers
// ---------------------------------------------------------------------------

constexpr uint32_t kFlip8 = 0x80808080u;     // int8 code b -> byte b + 128
constexpr float kMagic8 = 8388736.f;         // 2^23 + 128
constexpr uint32_t kNib = 0x43084308u;       // bf16 pair (136, 136)

__device__ __forceinline__ uint32_t bf16x2_mul(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ uint32_t bf16x2_sub(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("sub.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
// bf16 pair (lo, hi), each rounded to nearest even
__device__ __forceinline__ uint32_t bf16x2_of(float lo, float hi) {
  uint32_t d;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(d) : "f"(hi), "f"(lo));
  return d;
}

// byte i of a flipped int8 word as an exact fp32
__device__ __forceinline__ float code8(uint32_t flipped, int i) {
  return __uint_as_float(__byte_perm(flipped, 0x4B000000u, 0x7650 | i)) -
         kMagic8;
}

// bf16 pair (code i of flipped word a, code j of flipped word b) x s2
__device__ __forceinline__ uint32_t deq8(uint32_t a, int i, uint32_t b, int j,
                                         uint32_t s2) {
  const uint32_t pair = __byte_perm(__float_as_uint(code8(a, i)),
                                    __float_as_uint(code8(b, j)), 0x7632);
  return bf16x2_mul(pair, s2);
}

// bf16 pair (low nibble of byte i of a, low nibble of byte j of b) x s2;
// the high nibbles: pass a >> 4 and b >> 4
__device__ __forceinline__ uint32_t deq4(uint32_t a, int i, uint32_t b, int j,
                                         uint32_t s2) {
  const uint32_t p = __byte_perm(a, b, ((4 + j) << 8) | i);
  return bf16x2_mul(bf16x2_sub((p & 0x000F000Fu) ^ kNib, kNib), s2);
}

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* p) {
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// four (bf16: an 8-byte store) or two consecutive outputs
__device__ __forceinline__ void store4(float* dst, float4 v) {
  *reinterpret_cast<float4*>(dst) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* dst, float4 v) {
  *reinterpret_cast<uint2*>(dst) =
      make_uint2(bf16x2_of(v.x, v.y), bf16x2_of(v.z, v.w));
}
__device__ __forceinline__ void store2(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* dst, float a, float b) {
  *reinterpret_cast<uint32_t*>(dst) = bf16x2_of(a, b);
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// ---------------------------------------------------------------------------
// A. decode: split-K weight streaming on mma.sync
// ---------------------------------------------------------------------------

namespace dec {
constexpr int kStrip = 128;                  // output columns a block
constexpr int kRows = 32;                    // code rows (bytes) a stage
constexpr int kStages = 8;
constexpr int kWarps = 4;                    // consumers, a stage each in turn
constexpr int kThreads = 32 * (kWarps + 1);  // + the producer warp
constexpr int kCodeBytes = kRows * kStrip;
}  // namespace dec

template <int MT, bool INT4>
struct DecLayout {
  static constexpr int NH = INT4 ? 2 : 1;      // x / scale halves a stage
  static constexpr int XROWS = 8 * MT;
  static constexpr int XBOX = XROWS * 64;      // XROWS x 32 bf16, 64B swizzle
  static constexpr int X = dec::kStages * dec::kCodeBytes;
  static constexpr int RING = X + dec::kStages * NH * XBOX;
  // the warps' sums, [warp][XROWS][128] fp32, over the ring once it is free
  static constexpr int RED = dec::kWarps * XROWS * dec::kStrip * 4;
  static constexpr int SCALES = RING > RED ? RING : RED;
  static constexpr int BARS = SCALES + dec::kStages * NH * dec::kRows * 4;
  static constexpr int SMEM = 1024 + BARS + 8 * 2 * dec::kStages + 16;
  static constexpr uint32_t TX = dec::kCodeBytes + NH * (XBOX + dec::kRows * 4);
  static_assert(XBOX % 512 == 0, "x boxes keep the 64B swizzle's period");
};

// 16 codes of row `row` from byte 16 g of a 128-byte-swizzled code tile
__device__ __forceinline__ uint4 code_row(const unsigned char* tile, int row,
                                          int g) {
  return *reinterpret_cast<const uint4*>(tile + row * 128 +
                                         ((g ^ (row & 7)) << 4));
}

// the bf16 pair at (row, col) of a 64B-swizzled x box (32 bf16 a row)
__device__ __forceinline__ uint32_t x_pair(const unsigned char* box, int row,
                                           int col) {
  const int off = row * 64 + col * 2;
  return *reinterpret_cast<const uint32_t*>(box + (off ^ (((off >> 7) & 3) << 4)));
}

template <int MT, bool INT4, typename OutT>
__global__ void __launch_bounds__(dec::kThreads)
mixed_gemm_decode_kernel(const __grid_constant__ CUtensorMap tm_w,
                         const __grid_constant__ CUtensorMap tm_x,
                         const float* __restrict__ s, OutT* __restrict__ out,
                         float* __restrict__ ws, int* __restrict__ counters,
                         int M, int K, int N, int split) {
  using L = DecLayout<MT, INT4>;
  using namespace dec;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* empty = full + kStages;
  int* last = reinterpret_cast<int*>(empty + kStages);

  const int strip = blockIdx.x, part = blockIdx.y;
  const int n0 = strip * kStrip;
  const int n_stages = (INT4 ? K / 2 : K) / kRows;
  const int st0 = (int)((long)part * n_stages / split);
  const int nb = (int)((long)(part + 1) * n_stages / split) - st0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 1);                 // the one warp that read it
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == kWarps) {                        // producer
    if (lane == 0) {
      for (int i = 0; i < nb; ++i) {
        const int slot = i % kStages;
        mbar_wait(&empty[slot], ((i / kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[slot], L::TX);
        const int r0 = (st0 + i) * kRows;
        tma_load_2d(smem + slot * kCodeBytes, &tm_w, &full[slot], n0, r0);
#pragma unroll
        for (int h = 0; h < L::NH; ++h) {
          const int k0 = r0 + h * (K / 2);
          tma_load_2d(smem + L::X + (slot * L::NH + h) * L::XBOX, &tm_x,
                      &full[slot], k0, 0);
          bulk_load(smem + L::SCALES + (slot * L::NH + h) * kRows * 4, s + k0,
                    kRows * 4, &full[slot]);
        }
      }
    }
    return;
  }

  // consumers
  const int g = lane / 4, t = lane % 4;
  float acc[MT][8][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;

  for (int i = warp; i < nb; i += kWarps) {
    const int slot = i % kStages;
    mbar_wait(&full[slot], (i / kStages) & 1);
    const unsigned char* codes = smem + slot * kCodeBytes;
    const unsigned char* xs = smem + L::X + slot * L::NH * L::XBOX;
    const float* sc =
        reinterpret_cast<const float*>(smem + L::SCALES) + slot * L::NH * kRows;
    if constexpr (!INT4) {
      // k slots 2t, 2t+1, 2t+8, 2t+9 of each 16 rows: rows kk + (same)
#pragma unroll
      for (int kk = 0; kk < kRows; kk += 16) {
        const int ra = kk + 2 * t;
        uint4 w[4] = {code_row(codes, ra, g), code_row(codes, ra + 1, g),
                      code_row(codes, ra + 8, g), code_row(codes, ra + 9, g)};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          w[r].x ^= kFlip8; w[r].y ^= kFlip8; w[r].z ^= kFlip8; w[r].w ^= kFlip8;
        }
        const float2 s01 = *reinterpret_cast<const float2*>(sc + ra);
        const float2 s89 = *reinterpret_cast<const float2*>(sc + ra + 8);
        const uint32_t sa = bf16x2_of(s01.x, s01.y), sb = bf16x2_of(s89.x, s89.y);
        uint32_t b[MT][2];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          b[mt][0] = x_pair(xs, 8 * mt + g, ra);
          b[mt][1] = x_pair(xs, 8 * mt + g, ra + 8);
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int q = j / 2, c = 2 * (j % 2);   // word, byte of column 16g+2j
          const uint32_t w0 = word(w[0], q), w1 = word(w[1], q);
          const uint32_t w2 = word(w[2], q), w3 = word(w[3], q);
          const uint32_t a[4] = {deq8(w0, c, w1, c, sa), deq8(w0, c + 1, w1, c + 1, sa),
                                 deq8(w2, c, w3, c, sb), deq8(w2, c + 1, w3, c + 1, sb)};
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) mma_bf16(acc[mt][j], a, b[mt][0], b[mt][1]);
        }
      }
    } else {
      // per 8 byte rows: k slots 2t, 2t+1 the low nibbles of rows 2t, 2t+1,
      // slots 2t+8, 2t+9 their high nibbles
#pragma unroll
      for (int q8 = 0; q8 < kRows; q8 += 8) {
        const int ra = q8 + 2 * t;
        const uint4 wa = code_row(codes, ra, g), wb = code_row(codes, ra + 1, g);
        const float2 slo = *reinterpret_cast<const float2*>(sc + ra);
        const float2 shi = *reinterpret_cast<const float2*>(sc + kRows + ra);
        const uint32_t sl = bf16x2_of(slo.x, slo.y), sh = bf16x2_of(shi.x, shi.y);
        uint32_t b[MT][2];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          b[mt][0] = x_pair(xs, 8 * mt + g, ra);
          b[mt][1] = x_pair(xs + L::XBOX, 8 * mt + g, ra);
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int q = j / 2, c = 2 * (j % 2);
          const uint32_t w0 = word(wa, q), w1 = word(wb, q);
          const uint32_t h0 = w0 >> 4, h1 = w1 >> 4;
          const uint32_t a[4] = {deq4(w0, c, w1, c, sl), deq4(w0, c + 1, w1, c + 1, sl),
                                 deq4(h0, c, h1, c, sh), deq4(h0, c + 1, h1, c + 1, sh)};
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) mma_bf16(acc[mt][j], a, b[mt][0], b[mt][1]);
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[slot]);
  }

  // the warps' sums meet in shared memory (the ring, free once every warp
  // is past its last stage), [warp][m][128] with the float4 columns of row
  // m XOR-swizzled by (m >> 1) & 7
  constexpr int CT = kWarps * 32;              // consumer threads
  named_bar_sync(1, CT);
  float* red = reinterpret_cast<float*>(smem);
  auto red_at = [&](int w, int m, int c4) {
    return red + ((w * L::XROWS + m) * kStrip + ((c4 ^ ((m >> 1) & 7)) << 2));
  };
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int m = 8 * mt + 2 * t + e;        // c[e]: column 16g+2j, c[2+e]: +1
#pragma unroll
      for (int q = 0; q < 4; ++q)
        *reinterpret_cast<float4*>(red_at(warp, m, 4 * g + q)) =
            make_float4(acc[mt][2 * q][e], acc[mt][2 * q][2 + e],
                        acc[mt][2 * q + 1][e], acc[mt][2 * q + 1][2 + e]);
    }
  named_bar_sync(1, CT);

  const int tid = threadIdx.x;
  const int strips = gridDim.x;
  auto ws_at = [&](int p, int m, int c4) {
    return ws + (((size_t)p * strips + strip) * M + m) * kStrip + 4 * c4;
  };
#pragma unroll
  for (int idx = tid; idx < L::XROWS * 32; idx += CT) {
    const int m = idx / 32, c4 = idx % 32;
    if (m >= M) continue;
    float4 v = *reinterpret_cast<const float4*>(red_at(0, m, c4));
#pragma unroll
    for (int w = 1; w < kWarps; ++w)
      v = add4(v, *reinterpret_cast<const float4*>(red_at(w, m, c4)));
    if (split == 1) {
      if (n0 + 4 * c4 < N) store4(out + (size_t)m * N + n0 + 4 * c4, v);
    } else {
      __stcg(reinterpret_cast<float4*>(ws_at(part, m, c4)), v);
    }
  }
  if (split == 1) return;

  // the last block of the strip sums the partials in split order
  __threadfence();
  named_bar_sync(1, CT);
  if (tid == 0) *last = atomicAdd(&counters[strip], 1) == split - 1;
  named_bar_sync(1, CT);
  if (!*last) return;
  __threadfence();
#pragma unroll
  for (int idx = tid; idx < L::XROWS * 32; idx += CT) {
    const int m = idx / 32, c4 = idx % 32;
    if (m >= M || n0 + 4 * c4 >= N) continue;
    float4 v = __ldcg(reinterpret_cast<const float4*>(ws_at(0, m, c4)));
    for (int p = 1; p < split; ++p)
      v = add4(v, __ldcg(reinterpret_cast<const float4*>(ws_at(p, m, c4))));
    store4(out + (size_t)m * N + n0 + 4 * c4, v);
  }
  if (tid == 0) counters[strip] = 0;           // ready for the next launch
}

// ---------------------------------------------------------------------------
// B. prefill: wgmma, weights dequantized into shared memory
// ---------------------------------------------------------------------------

namespace pre {
constexpr int BN = 128, BK = 64;             // BK: contraction rows a stage
constexpr int kStages = 4;
constexpr int kBufs = 3;                     // B tiles: one being written, two
                                             // that wgmmas may still read
constexpr int kThreads = 384;                // producer warpgroup + 2 consumers
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
}  // namespace pre

// MI: 64-row products a consumer warpgroup, so the tile has BM = 128 MI
// rows and each code tile's dequantization serves 128 MI rows
template <bool INT4, int MI>
struct PreLayout {
  static constexpr int BM = 128 * MI;
  static constexpr int NH = INT4 ? 2 : 1;
  static constexpr int KH = pre::BK / NH;      // rows a half: 64 or 32
  static constexpr int XW = KH;                // x box width, bf16 columns
  static constexpr int X_BOX = BM * XW * 2;
  static constexpr int CODE_BYTES = KH * pre::BN;    // KH code rows x 128
  static constexpr int B_BOX = KH * 64 * 2;    // 64 columns of a B half
  static constexpr int B_HALF = 2 * B_BOX;     // 128 columns
  static constexpr int B_BYTES = NH * B_HALF;
  static constexpr int X = 0;
  static constexpr int B = X + pre::kStages * NH * X_BOX;
  static constexpr int CODES = B + pre::kBufs * B_BYTES;
  static constexpr int SCALES = CODES + pre::kStages * CODE_BYTES;
  static constexpr int BARS = SCALES + pre::kStages * NH * KH * 4;
  static constexpr int SMEM = 1024 + BARS + 8 * 2 * pre::kStages;
  static_assert(SMEM <= 232448, "shared memory of one block");
};

template <bool INT4, int MI, typename OutT>
__global__ void __launch_bounds__(pre::kThreads, 1)
mixed_gemm_prefill_kernel(const __grid_constant__ CUtensorMap tm_w,
                          const __grid_constant__ CUtensorMap tm_x,
                          const float* __restrict__ s, OutT* __restrict__ out,
                          int M, int K, int N) {
  using L = PreLayout<INT4, MI>;
  using namespace pre;
  constexpr int BM = L::BM;
  constexpr int KH = L::KH, NH = L::NH;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* empty = full + kStages;
  auto x_tile = [&](int slot, int h) {
    return smem + L::X + (slot * NH + h) * L::X_BOX;
  };
  auto codes_of = [&](int slot) { return smem + L::CODES + slot * L::CODE_BYTES; };
  auto scales_of = [&](int slot, int h) {
    return reinterpret_cast<float*>(smem + L::SCALES) + (slot * NH + h) * KH;
  };

  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int Kw = INT4 ? K / 2 : K;
  const int n_st = (Kw + KH - 1) / KH;        // int8: the last may be 32 rows
  auto valid_rows = [&](int i) { return min(KH, Kw - i * KH); };

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 2);                // one arrive per consumer warpgroup
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    regs_dealloc<kProducerRegs>();
    if (threadIdx.x != 0) return;
    for (int i = 0; i < n_st; ++i) {
      const int slot = i % kStages;
      mbar_wait(&empty[slot], ((i / kStages) & 1) ^ 1);
      const int r0 = i * KH, valid = valid_rows(i);
      mbar_arrive_expect_tx(&full[slot],
                            NH * L::X_BOX + L::CODE_BYTES + NH * valid * 4);
      tma_load_2d(codes_of(slot), &tm_w, &full[slot], n0, r0);
#pragma unroll
      for (int h = 0; h < NH; ++h) {
        const int k0 = r0 + h * (K / 2);
        tma_load_2d(x_tile(slot, h), &tm_x, &full[slot], k0, m0);
        bulk_load(scales_of(slot, h), s + k0, valid * 4, &full[slot]);
      }
    }
    return;
  }

  regs_alloc<kConsumerRegs>();
  const int cw = wg - 1;                       // which 64 MI rows of the tile
  const int ct = threadIdx.x - 128;            // 0..255
  float acc[MI][BN / 2];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[mi][i] = 0.f;

  // dequantization: thread ct takes 16 codes (columns 16c..16c+15) of rows
  // ct / 8 (+ 32); it writes them as two 16-byte chunks of a B box (64
  // columns, 128-byte swizzle), the odd chunk first in the second box so
  // that the 8 lanes of a row hit 8 distinct bank groups
  const int c = ct % 8, box = c / 4, q0 = 2 * (c % 4);
  auto put = [&](unsigned char* bhalf, int r, const uint32_t (&o)[8]) {
    unsigned char* row = bhalf + box * L::B_BOX + r * 128;
    const uint4 even = make_uint4(o[0], o[1], o[2], o[3]);
    const uint4 odd = make_uint4(o[4], o[5], o[6], o[7]);
    const int first = box ? q0 + 1 : q0;
    *reinterpret_cast<uint4*>(row + ((first ^ (r & 7)) << 4)) = box ? odd : even;
    *reinterpret_cast<uint4*>(row + (((first ^ 1) ^ (r & 7)) << 4)) =
        box ? even : odd;
  };

  for (int i = 0; i < n_st; ++i) {
    const int slot = i % kStages;
    mbar_wait(&full[slot], (i / kStages) & 1);
    unsigned char* bt = smem + L::B + (i % kBufs) * L::B_BYTES;
    const unsigned char* codes = codes_of(slot);
    if constexpr (!INT4) {
      const int valid = valid_rows(i);
      const float* sc = scales_of(slot, 0);
#pragma unroll
      for (int p = 0; p < KH / 32; ++p) {
        const int r = 32 * p + ct / 8;
        uint4 w = *reinterpret_cast<const uint4*>(codes + r * 128 + 16 * c);
        const float sv = r < valid ? sc[r] : 0.f;
        const uint32_t s2 = bf16x2_of(sv, sv);
        uint32_t o[8];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const uint32_t f = word(w, q) ^ kFlip8;
          o[2 * q] = deq8(f, 0, f, 1, s2);
          o[2 * q + 1] = deq8(f, 2, f, 3, s2);
        }
        put(bt, r, o);
      }
    } else {
      const int r = ct / 8;
      const uint4 w = *reinterpret_cast<const uint4*>(codes + r * 128 + 16 * c);
      const float slo = scales_of(slot, 0)[r], shi = scales_of(slot, 1)[r];
      const uint32_t sl = bf16x2_of(slo, slo), sh = bf16x2_of(shi, shi);
      uint32_t lo[8], hi[8];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint32_t v = word(w, q), v4 = v >> 4;
        lo[2 * q] = deq4(v, 0, v, 1, sl);
        lo[2 * q + 1] = deq4(v, 2, v, 3, sl);
        hi[2 * q] = deq4(v4, 0, v4, 1, sh);
        hi[2 * q + 1] = deq4(v4, 2, v4, 3, sh);
      }
      put(bt, r, lo);
      put(bt + L::B_HALF, r, hi);
    }
    fence_proxy_async();
    named_bar_sync(1, 256);                    // the whole B tile is written

#pragma unroll
    for (int mi = 0; mi < MI; ++mi) fence_regs(acc[mi]);
    wgmma_fence();
#pragma unroll
    for (int h = 0; h < NH; ++h) {
      const uint32_t xa = smem_addr(x_tile(slot, h));
      const uint32_t ba = smem_addr(bt + h * L::B_HALF);
#pragma unroll
      for (int k = 0; k < KH / 16; ++k)
#pragma unroll
        for (int mi = 0; mi < MI; ++mi)
          wgmma_ss_mn<__nv_bfloat16, BN>(
              acc[mi], desc_kmajor<L::XW>(xa, L::X_BOX, 64 * (MI * cw + mi), k),
              desc_mnmajor<64>(ba, L::B_BOX, k), 1);
    }
    wgmma_commit();
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) fence_regs(acc[mi]);
    wgmma_wait<1>();                           // the previous stage's are done
    if (i > 0 && threadIdx.x % 128 == 0) mbar_arrive(&empty[(i - 1) % kStages]);
  }
  wgmma_wait<0>();
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) fence_regs(acc[mi]);

  // epilogue: thread (warp wi, lane g*4+t) holds rows 16 wi + g (+8) of
  // each 64 of its warpgroup, columns 8 nb + 2t, +1
  const int lane = threadIdx.x % 32, wi = (threadIdx.x % 128) / 32;
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = m0 + 64 * (MI * cw + mi) + 16 * wi + g + 8 * hr;
      if (row >= M) continue;
#pragma unroll
      for (int nb = 0; nb < BN / 8; ++nb) {
        const int col = n0 + 8 * nb + 2 * t;
        if (col < N)
          store2(out + (size_t)row * N + col, acc[mi][4 * nb + 2 * hr],
                 acc[mi][4 * nb + 2 * hr + 1]);
      }
    }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

template <int MT, bool INT4, typename OutT>
cudaError_t decode_launch(const void* x, const void* w, const void* s,
                          void* out, void* ws, void* counters, int M, int K,
                          int N, int split, cudaStream_t st) {
  using L = DecLayout<MT, INT4>;
  CUtensorMap mw, mx;
  cudaError_t e;
  if ((e = make_map_2d(&mw, w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, N,
                       INT4 ? K / 2 : K, dec::kStrip, dec::kRows,
                       CU_TENSOR_MAP_SWIZZLE_128B)) ||
      (e = make_map_2d(&mx, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, K, M, 32,
                       L::XROWS, CU_TENSOR_MAP_SWIZZLE_64B)))
    return e;
  auto kernel = mixed_gemm_decode_kernel<MT, INT4, OutT>;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           L::SMEM);
  if (e != cudaSuccess) return e;
  dim3 grid((N + dec::kStrip - 1) / dec::kStrip, split);
  kernel<<<grid, dec::kThreads, L::SMEM, st>>>(
      mw, mx, static_cast<const float*>(s), static_cast<OutT*>(out),
      static_cast<float*>(ws), static_cast<int*>(counters), M, K, N, split);
  return cudaGetLastError();
}

template <bool INT4, int MI, typename OutT>
cudaError_t prefill_launch(const void* x, const void* w, const void* s,
                           void* out, int M, int K, int N, cudaStream_t st) {
  using L = PreLayout<INT4, MI>;
  CUtensorMap mw, mx;
  cudaError_t e;
  if ((e = make_map_2d(&mw, w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, N,
                       INT4 ? K / 2 : K, pre::BN, L::KH,
                       CU_TENSOR_MAP_SWIZZLE_NONE)) ||
      (e = make_map_2d(&mx, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, K, M,
                       L::XW, L::BM, Swizzle<L::XW>::map)))
    return e;
  auto kernel = mixed_gemm_prefill_kernel<INT4, MI, OutT>;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           L::SMEM);
  if (e != cudaSuccess) return e;
  // the M tiles of one column tile run side by side: its codes stay in L2
  dim3 grid((M + L::BM - 1) / L::BM, (N + pre::BN - 1) / pre::BN);
  kernel<<<grid, pre::kThreads, L::SMEM, st>>>(
      mw, mx, static_cast<const float*>(s), static_cast<OutT*>(out), M, K, N);
  return cudaGetLastError();
}

template <bool INT4, typename OutT>
cudaError_t launch(const void* x, const void* w, const void* s, void* out,
                   void* ws, void* counters, int M, int K, int N, int design,
                   int split, int tile_m, cudaStream_t st) {
  if (design == 1) {
    if (tile_m == 256)
      return prefill_launch<INT4, 2, OutT>(x, w, s, out, M, K, N, st);
    if (tile_m == 128)
      return prefill_launch<INT4, 1, OutT>(x, w, s, out, M, K, N, st);
    return cudaErrorInvalidValue;
  }
  const int stages = (INT4 ? K / 2 : K) / dec::kRows;
  if (design != 0 || M > 32 || split < 1 || split > stages ||
      (split > 1 && (ws == nullptr || counters == nullptr)))
    return cudaErrorInvalidValue;
  if (M <= 8)
    return decode_launch<1, INT4, OutT>(x, w, s, out, ws, counters, M, K, N,
                                        split, st);
  if (M <= 16)
    return decode_launch<2, INT4, OutT>(x, w, s, out, ws, counters, M, K, N,
                                        split, st);
  return decode_launch<4, INT4, OutT>(x, w, s, out, ws, counters, M, K, N,
                                      split, st);
}

}  // namespace mixed

// out = x @ dequant(w, s).  int4 != 0: w is the packed [K/2, N] layout.
// out_f32 != 0: out is fp32, else bf16.  design 0: decode (M <= 32; split
// blocks along K; with split > 1, ws holds split x ceil(N/128) x M x 128
// fp32 and counters ceil(N/128) ints that are 0), design 1: prefill in
// tiles of tile_m (128 or 256) rows.
// Returns cudaGetLastError() after the launch (0 on success); launches on
// `stream` and does not synchronise.
extern "C" int mixed_gemm(const void* x, const void* w, const void* s,
                          void* out, void* ws, void* counters, int M, int K,
                          int N, int int4, int out_f32, int design, int split,
                          int tile_m, void* stream) {
  if (M == 0 || N == 0) return 0;
  if (M < 0 || K <= 0 || N < 0 || N % 16 != 0 || K % (int4 ? 64 : 32) != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (int4) {
    err = out_f32 ? mixed::launch<true, float>(x, w, s, out, ws, counters, M,
                                               K, N, design, split, tile_m, st)
                  : mixed::launch<true, __nv_bfloat16>(
                        x, w, s, out, ws, counters, M, K, N, design, split,
                        tile_m, st);
  } else {
    err = out_f32 ? mixed::launch<false, float>(x, w, s, out, ws, counters, M,
                                                K, N, design, split, tile_m, st)
                  : mixed::launch<false, __nv_bfloat16>(
                        x, w, s, out, ws, counters, M, K, N, design, split,
                        tile_m, st);
  }
  return (int)err;
}
