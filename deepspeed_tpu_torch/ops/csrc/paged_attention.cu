// Paged attention over a block table, bf16, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_kernel` in deepspeed_tpu/ops/paged_attention.py
// (launched by `paged_attention`, pallas_call at :163).  For each of T
// ragged tokens it computes attention of all H query heads over that
// token's own sequence, read through the sequence's block-table row:
//
//   kv      [nrows, bs, 2, Hkv, D] bf16   (nrows = blocks + 1; the last row
//                                          is the trash block -1 pads map to)
//   q / out [T, H, D] bf16
//   seq_slot, positions [T] i32;  block_tables [max_seqs, tbl_stride] i32
//
// Numerics follow the TPU kernel: keys past positions[t] are masked with
// -1e30, blocks past positions[t] / bs are never visited, the softmax is
// online in fp32, the final division uses max(l, 1e-30), and query head h
// reads KV head h / rep.  (The TPU kernel rounds the probabilities to the
// value dtype before the PV product; this one keeps them in fp32.)
// Budget-padding tokens (slot 0, position 0) read one block and produce
// finite garbage.
//
// What bounds it on an H100 (3.35 TB/s, 989 TFLOP/s bf16 dense):
//   * decode: the KV bytes.  A token reads ctx x Hkv x D x 2 (K and V)
//     x 2 B, and does only ~4 flops per byte read.
//   * prefill chunk: the flops, 4 x H x D x sum(ctx), because the chunk's
//     tokens all read the same sequence's KV, which a real kernel would
//     read once and reuse from on-chip memory.
//
// Design (simple first): one thread block of 128 threads per (token, KV
// head).  The block walks its own block-table entries up to pos / bs (the
// loop replaces the TPU's sequential grid dimension).  A group of D / 8
// threads owns one key row at a time, each thread loading 16 bytes (8 bf16)
// of K and of V, so the `rep` query heads of the GQA group share every K/V
// row read.  Scores and probabilities of one block live in shared memory;
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
// Supported: D in {64, 128}, 1 <= rep = H / Hkv <= 8, 1 <= bs <= 256.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

template <int D, int REP>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const __nv_bfloat16* __restrict__ kv,
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

  // elements between consecutive (block, offset) rows; K and V of one row
  // are Hkv * D apart, and head g sits g * D into each
  const size_t row = (size_t)2 * Hkv * D;
  const int* table = block_tables + (size_t)slot * tbl_stride;

  for (int j = 0; j <= last; ++j) {
    int b = table[j];
    if (b < 0 || b >= nrows) b = nrows - 1;          // -1 pad -> trash row
    const __nv_bfloat16* kbase =
        kv + (size_t)b * bs * row + (size_t)g * D + lane * VEC;
    const __nv_bfloat16* vbase = kbase + (size_t)Hkv * D;

    // 1. scores of this block's keys for every head of the group
    for (int o0 = 0; o0 < bs; o0 += NG) {
      const int o = o0 + grp;
      float kf[VEC];
      if (o < bs) {
        unpack8(*reinterpret_cast<const uint4*>(kbase + (size_t)o * row), kf);
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
        const bool keep = j * bs + o <= pos;
#pragma unroll
        for (int r = 0; r < REP; ++r)
          s_sh[r * bs + o] = keep ? dot[r] * scale : kNegInf;
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
      unpack8(*reinterpret_cast<const uint4*>(vbase + (size_t)o * row), vf);
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

template <int D, int REP>
cudaError_t launch(const void* kv, const void* q, const void* seq_slot,
                   const void* positions, const void* block_tables, void* out,
                   int T, int Hkv, int bs, int nrows, int tbl_stride, int nb,
                   float scale, cudaStream_t stream) {
  constexpr int NG = kThreads / (D / 8);
  const size_t smem = sizeof(float) * ((size_t)REP * bs + (size_t)NG * REP * D);
  dim3 grid(T, Hkv);
  paged_attention_kernel<D, REP><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(kv),
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const int*>(seq_slot), static_cast<const int*>(positions),
      static_cast<const int*>(block_tables),
      static_cast<__nv_bfloat16*>(out), Hkv, bs, nrows, tbl_stride, nb, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_rep(int rep, const void* kv, const void* q,
                       const void* seq_slot, const void* positions,
                       const void* block_tables, void* out, int T, int Hkv,
                       int bs, int nrows, int tbl_stride, int nb, float scale,
                       cudaStream_t stream) {
#define PA_CASE(R)                                                          \
  case R:                                                                   \
    return launch<D, R>(kv, q, seq_slot, positions, block_tables, out, T,   \
                        Hkv, bs, nrows, tbl_stride, nb, scale, stream);
  switch (rep) {
    PA_CASE(1) PA_CASE(2) PA_CASE(3) PA_CASE(4)
    PA_CASE(5) PA_CASE(6) PA_CASE(7) PA_CASE(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef PA_CASE
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success).  Launches on
// `stream` and does not synchronise.
extern "C" int paged_attention_bf16(const void* kv, const void* q,
                                    const void* seq_slot,
                                    const void* positions,
                                    const void* block_tables, void* out,
                                    int T, int H, int Hkv, int D, int bs,
                                    int nrows, int tbl_stride, int nb,
                                    float scale, void* stream) {
  if (T == 0) return 0;
  if (Hkv <= 0 || H % Hkv != 0 || bs < 1 || bs > kMaxBlockSize || nb < 1)
    return (int)cudaErrorInvalidValue;
  const int rep = H / Hkv;
  if (rep > kMaxRep) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (D == 128) {
    err = launch_rep<128>(rep, kv, q, seq_slot, positions, block_tables, out,
                          T, Hkv, bs, nrows, tbl_stride, nb, scale, s);
  } else if (D == 64) {
    err = launch_rep<64>(rep, kv, q, seq_slot, positions, block_tables, out,
                         T, Hkv, bs, nrows, tbl_stride, nb, scale, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)err;
}
