// Paged attention over a block table, for Hopper (sm_90a): a bf16 cache,
// or an int8 / fp8 (e4m3) cache of codes with one fp32 scale per K/V row.
//
// Replaces the TPU kernel `_kernel` in deepspeed_tpu/ops/paged_attention.py
// (launched by `paged_attention`, pallas_call at :163).  For each of T
// ragged tokens it computes attention of all H query heads over that
// token's own sequence, read through the sequence's block-table row:
//
//   kv      [nrows, bs, 2, Hkv, D] bf16   (nrows = blocks + 1; the last row
//                                          is the trash block -1 pads map to)
//           or int8 / fp8 codes of that shape with
//   scales  [nrows, bs, 2, Hkv] fp32       (the `kv_quant` variant, :78-82)
//   q / out [T, H, D] bf16
//   seq_slot, positions [T] i32;  block_tables [max_seqs, tbl_stride] i32
//   slopes  [H] fp32 or null               (the `alibi` variant, :86-88)
//
// Numerics follow the TPU kernel: keys past positions[t] are masked with
// -1e30, blocks past positions[t] / bs are never visited, the softmax is
// online in fp32, the final division uses max(l, 1e-30), and query head h
// reads KV head h / rep.  (The TPU kernel rounds the probabilities to the
// value dtype before the PV product; this one keeps them in fp32.)
// ALiBi adds slopes[h] x key position to each score in the TPU kernel's
// order: s * scale, then + slope * position (each product rounded, no
// fused multiply-add), then the mask.  The bias reaches ~1.7e3 at BLOOM's
// first head and position 2047, so a different order would move the low
// bits of large scores.  ALiBi is a template flag: the instantiations
// without it are the kernel as it was.
// Budget-padding tokens (slot 0, position 0) read one block and produce
// finite garbage.  A quantized row is dequantized as bf16(float(code) x
// scale), which is the reference's (codes.astype(f32) * scale).astype(q
// dtype); the rest of the arithmetic is the bf16 kernel's.
//
// What bounds it on an H100 (3.35 TB/s, 989 TFLOP/s bf16 dense):
//   * decode: the KV bytes.  A token reads ctx x Hkv x D x 2 (K and V)
//     x 2 B (1 B + a 4 B scale per row when quantized), and does only ~4
//     flops per byte read.
//   * prefill chunk: the flops, 4 x H x D x sum(ctx), because the chunk's
//     tokens all read the same sequence's KV, which a real kernel would
//     read once and reuse from on-chip memory.
//
// Design (simple first): one thread block of 128 threads per (token, KV
// head).  The block walks its own block-table entries up to pos / bs (the
// loop replaces the TPU's sequential grid dimension).  A group of D / 8
// threads owns one key row at a time, each thread loading 8 elements of K
// and of V (16 bytes of bf16, or 8 bytes of codes plus the row's scale),
// so the `rep` query heads of the GQA group share every K/V row read.  Scores and probabilities of one block live in shared memory;
// the running max and sum per head live in shared memory; the output
// accumulator lives in registers (8 dims x rep heads per thread) and is
// summed across the key groups once at the end.
//
// What this design leaves on the table (work for later):
//   * no tensor cores: the QK and PV products are fp32 FMAs on CUDA cores,
//     so prefill runs far below its flop bound;
//   * no sharing of K/V loads across the query tokens of one prefill chunk:
//     each token re-reads its whole context (the L2 cache absorbs part);
//   * no split over blocks: a decode batch of 8 sequences x 8 KV heads
//     launches only 64 thread blocks on 132 SMs.
//
// Supported: a bf16, int8 or fp8 e4m3 cache, bf16 q and out, D in {64, 128},
// 1 <= rep = H / Hkv <= 8, 1 <= bs <= 256, with or without ALiBi slopes.
// The bias adds no bytes beyond H slopes and two flops per score, so the
// bounds above hold for the ALiBi variant too.

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxRep = 8;
constexpr int kMaxBlockSize = 256;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ void unpack8(const uint4& u, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = __bfloat1622float2(h[i]);
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}

// 8 consecutive cache elements -> fp32.  bf16: one 16-byte load; codes:
// one 8-byte load, each value rounded to bf16 after the scale multiply.
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float,
                                      float* f) {
  unpack8(*reinterpret_cast<const uint4*>(p), f);
}

template <typename CodeT>
__device__ __forceinline__ void load8(const CodeT* p, float scale, float* f) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const CodeT* c = reinterpret_cast<const CodeT*>(&u);
#pragma unroll
  for (int i = 0; i < 8; ++i)
    f[i] = __bfloat162float(__float2bfloat16_rn(static_cast<float>(c[i]) *
                                                scale));
}

template <int D, int REP, typename CodeT, bool ALIBI>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const CodeT* __restrict__ kv,
                       const float* __restrict__ kv_scales,
                       const float* __restrict__ slopes,
                       const __nv_bfloat16* __restrict__ q,
                       const int* __restrict__ seq_slot,
                       const int* __restrict__ positions,
                       const int* __restrict__ block_tables,
                       __nv_bfloat16* __restrict__ out,
                       int Hkv, int bs, int nrows, int tbl_stride, int nb,
                       float scale) {
  constexpr int VEC = 8;               // bf16 per 16-byte load
  constexpr int TPK = D / VEC;         // threads per key row (16 or 8)
  constexpr int NG = kThreads / TPK;   // key rows in flight per block step
  static_assert(32 % TPK == 0, "a key group must sit inside one warp");

  extern __shared__ float smem[];
  float* s_sh = smem;                  // [REP][bs] scores, then probabilities
  float* red = smem + REP * bs;        // [NG][REP][D] partial sums (at the end)
  __shared__ float m_sh[REP], l_sh[REP], corr_sh[REP];

  const int t = blockIdx.x;
  const int g = blockIdx.y;
  const int tid = threadIdx.x;
  const int grp = tid / TPK;
  const int lane = tid % TPK;
  const int H = Hkv * REP;

  const int pos = positions[t];
  const int slot = seq_slot[t];
  int last = pos / bs;
  if (last > nb - 1) last = nb - 1;

  // this thread's 8 dims of each query head of the group, in fp32
  float qf[REP][VEC];
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    const uint4 u = *reinterpret_cast<const uint4*>(
        q + ((size_t)t * H + (size_t)g * REP + r) * D + lane * VEC);
    unpack8(u, qf[r]);
  }
  float acc[REP][VEC];
#pragma unroll
  for (int r = 0; r < REP; ++r)
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[r][i] = 0.f;
  if (tid < REP) {
    m_sh[tid] = kNegInf;
    l_sh[tid] = 0.f;
  }
  // ALiBi: the group's REP slopes, once per thread block
  float sl[REP];
#pragma unroll
  for (int r = 0; r < REP; ++r) sl[r] = ALIBI ? slopes[g * REP + r] : 0.f;

  // elements between consecutive (block, offset) rows; K and V of one row
  // are Hkv * D apart, and head g sits g * D into each
  const size_t row = (size_t)2 * Hkv * D;
  const int* table = block_tables + (size_t)slot * tbl_stride;
  // scales (quantized cache): one per (block, offset, K|V, head)
  constexpr bool quant = !std::is_same<CodeT, __nv_bfloat16>::value;
  const size_t srow = (size_t)2 * Hkv;

  for (int j = 0; j <= last; ++j) {
    int b = table[j];
    if (b < 0 || b >= nrows) b = nrows - 1;          // -1 pad -> trash row
    const CodeT* kbase =
        kv + (size_t)b * bs * row + (size_t)g * D + lane * VEC;
    const CodeT* vbase = kbase + (size_t)Hkv * D;
    const float* ksc = quant ? kv_scales + (size_t)b * bs * srow + g : nullptr;

    // 1. scores of this block's keys for every head of the group
    for (int o0 = 0; o0 < bs; o0 += NG) {
      const int o = o0 + grp;
      float kf[VEC];
      if (o < bs) {
        load8(kbase + (size_t)o * row, quant ? ksc[(size_t)o * srow] : 1.f,
              kf);
      } else {
#pragma unroll
        for (int i = 0; i < VEC; ++i) kf[i] = 0.f;
      }
      float dot[REP];
#pragma unroll
      for (int r = 0; r < REP; ++r) {
        float s = 0.f;
#pragma unroll
        for (int i = 0; i < VEC; ++i) s = fmaf(qf[r][i], kf[i], s);
        dot[r] = s;
      }
      // every lane of the warp shuffles (the loop bounds are uniform)
#pragma unroll
      for (int r = 0; r < REP; ++r)
#pragma unroll
        for (int off = TPK / 2; off > 0; off >>= 1)
          dot[r] += __shfl_xor_sync(0xffffffffu, dot[r], off);
      if (lane == 0 && o < bs) {
        const int key = j * bs + o;
        const bool keep = key <= pos;
#pragma unroll
        for (int r = 0; r < REP; ++r) {
          const float sc =
              ALIBI ? __fadd_rn(__fmul_rn(dot[r], scale),
                                __fmul_rn(sl[r], static_cast<float>(key)))
                    : dot[r] * scale;
          s_sh[r * bs + o] = keep ? sc : kNegInf;
        }
      }
    }
    __syncthreads();

    // 2. online-softmax update, one warp per head row
    const int warp = tid / 32;
    const int wl = tid % 32;
    for (int r = warp; r < REP; r += kThreads / 32) {
      float mx = kNegInf;
      for (int o = wl; o < bs; o += 32) mx = fmaxf(mx, s_sh[r * bs + o]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_sh[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int o = wl; o < bs; o += 32) {
        const float p = __expf(s_sh[r * bs + o] - m_new);
        s_sh[r * bs + o] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (wl == 0) {
        const float c = __expf(m_old - m_new);
        corr_sh[r] = c;
        l_sh[r] = l_sh[r] * c + sum;
        m_sh[r] = m_new;
      }
    }
    __syncthreads();

    // 3. rescale the accumulator and add this block's P V
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      const float c = corr_sh[r];
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[r][i] *= c;
    }
    for (int o = grp; o < bs; o += NG) {
      float vf[VEC];
      load8(vbase + (size_t)o * row,
            quant ? ksc[(size_t)o * srow + Hkv] : 1.f, vf);
#pragma unroll
      for (int r = 0; r < REP; ++r) {
        const float p = s_sh[r * bs + o];
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[r][i] = fmaf(p, vf[i], acc[r][i]);
      }
    }
    __syncthreads();                   // s_sh is rewritten by the next block
  }

  // sum the key groups' partial accumulators and normalise
#pragma unroll
  for (int r = 0; r < REP; ++r)
#pragma unroll
    for (int i = 0; i < VEC; ++i)
      red[((size_t)grp * REP + r) * D + lane * VEC + i] = acc[r][i];
  __syncthreads();
  for (int e = tid; e < REP * D; e += kThreads) {
    const int r = e / D;
    const int d = e % D;
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < NG; ++k) s += red[((size_t)k * REP + r) * D + d];
    const float l = fmaxf(l_sh[r], 1e-30f);
    out[((size_t)t * H + (size_t)g * REP + r) * D + d] =
        __float2bfloat16(s / l);
  }
}

template <int D, int REP, typename CodeT, bool ALIBI>
cudaError_t launch(const void* kv, const void* kv_scales, const void* slopes,
                   const void* q, const void* seq_slot, const void* positions,
                   const void* block_tables, void* out, int T, int Hkv,
                   int bs, int nrows, int tbl_stride, int nb, float scale,
                   cudaStream_t stream) {
  constexpr int NG = kThreads / (D / 8);
  const size_t smem = sizeof(float) * ((size_t)REP * bs + (size_t)NG * REP * D);
  dim3 grid(T, Hkv);
  paged_attention_kernel<D, REP, CodeT, ALIBI>
      <<<grid, kThreads, smem, stream>>>(
      static_cast<const CodeT*>(kv), static_cast<const float*>(kv_scales),
      static_cast<const float*>(slopes), static_cast<const __nv_bfloat16*>(q),
      static_cast<const int*>(seq_slot), static_cast<const int*>(positions),
      static_cast<const int*>(block_tables),
      static_cast<__nv_bfloat16*>(out), Hkv, bs, nrows, tbl_stride, nb, scale);
  return cudaGetLastError();
}

template <typename CodeT, int D, bool ALIBI>
cudaError_t launch_rep(int rep, const void* kv, const void* kv_scales,
                       const void* slopes, const void* q,
                       const void* seq_slot, const void* positions,
                       const void* block_tables, void* out, int T, int Hkv,
                       int bs, int nrows, int tbl_stride, int nb, float scale,
                       cudaStream_t stream) {
#define PA_CASE(R)                                                          \
  case R:                                                                   \
    return launch<D, R, CodeT, ALIBI>(kv, kv_scales, slopes, q, seq_slot,  \
                                      positions, block_tables, out, T,     \
                                      Hkv, bs, nrows, tbl_stride, nb,      \
                                      scale, stream);
  switch (rep) {
    PA_CASE(1) PA_CASE(2) PA_CASE(3) PA_CASE(4)
    PA_CASE(5) PA_CASE(6) PA_CASE(7) PA_CASE(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef PA_CASE
}

template <typename CodeT, bool ALIBI>
cudaError_t launch_alibi(const void* kv, const void* kv_scales,
                         const void* slopes, const void* q,
                         const void* seq_slot, const void* positions,
                         const void* block_tables, void* out, int T, int rep,
                         int Hkv, int D, int bs, int nrows, int tbl_stride,
                         int nb, float scale, cudaStream_t stream) {
  if (D == 128)
    return launch_rep<CodeT, 128, ALIBI>(rep, kv, kv_scales, slopes, q,
                                         seq_slot, positions, block_tables,
                                         out, T, Hkv, bs, nrows, tbl_stride,
                                         nb, scale, stream);
  if (D == 64)
    return launch_rep<CodeT, 64, ALIBI>(rep, kv, kv_scales, slopes, q,
                                        seq_slot, positions, block_tables,
                                        out, T, Hkv, bs, nrows, tbl_stride,
                                        nb, scale, stream);
  return cudaErrorInvalidValue;
}

template <typename CodeT>
cudaError_t launch_d(const void* kv, const void* kv_scales,
                     const void* slopes, const void* q, const void* seq_slot,
                     const void* positions, const void* block_tables,
                     void* out, int T, int H, int Hkv, int D, int bs,
                     int nrows, int tbl_stride, int nb, float scale,
                     cudaStream_t stream) {
  if (T == 0) return cudaSuccess;
  if (Hkv <= 0 || H % Hkv != 0 || bs < 1 || bs > kMaxBlockSize || nb < 1)
    return cudaErrorInvalidValue;
  const int rep = H / Hkv;
  if (rep > kMaxRep) return cudaErrorInvalidValue;
  if (slopes != nullptr)
    return launch_alibi<CodeT, true>(kv, kv_scales, slopes, q, seq_slot,
                                     positions, block_tables, out, T, rep,
                                     Hkv, D, bs, nrows, tbl_stride, nb, scale,
                                     stream);
  return launch_alibi<CodeT, false>(kv, kv_scales, slopes, q, seq_slot,
                                    positions, block_tables, out, T, rep, Hkv,
                                    D, bs, nrows, tbl_stride, nb, scale,
                                    stream);
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success).  Launches on
// `stream` and does not synchronise.  `slopes`: H fp32 ALiBi slopes in
// head order, or null for none.
extern "C" int paged_attention_bf16(const void* kv, const void* slopes,
                                    const void* q, const void* seq_slot,
                                    const void* positions,
                                    const void* block_tables, void* out,
                                    int T, int H, int Hkv, int D, int bs,
                                    int nrows, int tbl_stride, int nb,
                                    float scale, void* stream) {
  return (int)launch_d<__nv_bfloat16>(
      kv, nullptr, slopes, q, seq_slot, positions, block_tables, out, T, H,
      Hkv, D, bs, nrows, tbl_stride, nb, scale,
      static_cast<cudaStream_t>(stream));
}

// The quantized cache: `kv` holds int8 (code_type 0) or fp8 e4m3 (code_type
// 1) codes, `kv_scales` their fp32 scales.  Same contract otherwise.
extern "C" int paged_attention_quant(const void* kv, const void* kv_scales,
                                     const void* slopes,
                                     const void* q, const void* seq_slot,
                                     const void* positions,
                                     const void* block_tables, void* out,
                                     int T, int H, int Hkv, int D, int bs,
                                     int nrows, int tbl_stride, int nb,
                                     float scale, int code_type,
                                     void* stream) {
  if (kv_scales == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (code_type == 0)
    return (int)launch_d<int8_t>(kv, kv_scales, slopes, q, seq_slot,
                                 positions, block_tables, out, T, H, Hkv, D,
                                 bs, nrows, tbl_stride, nb, scale, s);
  if (code_type == 1)
    return (int)launch_d<__nv_fp8_e4m3>(kv, kv_scales, slopes, q, seq_slot,
                                        positions, block_tables, out, T, H,
                                        Hkv, D, bs, nrows, tbl_stride, nb,
                                        scale, s);
  return (int)cudaErrorInvalidValue;
}
