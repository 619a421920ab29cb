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
// Numerics follow the TPU kernel: token t reads the keys 0 .. positions[t]
// of blocks 0 .. min(positions[t] / bs, nb - 1), keys past positions[t]
// are masked with -1e30 (not -inf), the online softmax keeps m, l and the
// output sums in fp32, the probabilities are rounded to bf16 before the
// PV product while l sums them unrounded (`p.astype(v.dtype)`, :98), the
// output is acc / max(l, 1e-30), and query head h reads KV head h / rep.
// ALiBi adds slopes[h] x key position after the scale and before the mask,
// each product rounded (no fused multiply-add): the bias reaches ~1.7e3 at
// BLOOM's first head and position 2047, so another order would move the
// low bits of large scores.  A quantized row is bf16(float(code) x scale),
// the reference's (codes.astype(f32) * scale).astype(q dtype).  A table
// entry below 0 or past the last row reads the trash row.
//
// What bounds it on an H100 (3.35 TB/s, 989 TFLOP/s bf16 dense):
//   * decode tokens: the KV bytes.  A token reads ctx x Hkv x D x 2 (K and
//     V) x 2 B (1 B plus a 4 B scale a row when quantized) and does ~4 x
//     rep flops a byte: far below the ~295 flops a byte of the tensor
//     cores' ridge.  What matters is enough bytes in flight on every SM.
//   * prefill chunks: the flops, 4 x H x D x sum(ctx), once the chunk's
//     tokens share each K/V row they all read (a 512-token chunk reads
//     each row once, not 512 times).
//
// Two designs behind one launch, and the plan that assigns them.
//
// The plan (paged_attention_plan_kernel, one block) scans the tokens and
// cuts them into runs: tokens adjacent in the batch with the same
// seq_slot and consecutive positions (build_batch lays out each request's
// new tokens so: a prefill chunk, a verify window, a decode token).  A
// run's query rows are its (token, head) pairs of one KV head, flattened
// as token_in_run x rep + r.  A run of at most 16 rows goes to the decode
// design as one tile; a longer run is cut into 64-row chunk tiles.  A tile
// of one token (any decode tile, or the ceil(rep / 64) chunk tiles of a
// single token with rep > 16, e.g. falcon-7b's 71 heads over 1 KV head) may
// be split along its KV blocks: w* = ceil(W / target) blocks a split,
// where W is the batch's KV blocks summed over its tiles and target =
// floor(2 x SMs / Hkv) work items a KV head (two blocks an SM, one wave).
// Splits
// cover blocks b0 .. b1 - 1 in order.  The plan writes the work items
// {t0, n, row0, b0, b1, split, nsplit, slot} to a workspace with their
// count, so the host never reads a device tensor (the step stays
// asynchronous).  The wrapper's plan_plain is its PyTorch twin.  The
// layers of a step pass the same seq_slot and positions, so the wrapper
// runs the plan once a step (`replan`); the work kernel's last block sets
// the item counter back to 0 for the next layer.
//
// The work kernel (paged_attention_kernel<D>, 4 warps) walks the items x
// KV heads from a persistent grid (a CTA's first item is its blockIdx, the
// rest come from an atomic counter the plan zeroes):
//   * The K/V of the item's key range [b0 bs, min(b1 bs, maxpos + 1)) come
//     to shared memory in 64-key tiles, each key row once per tile, through
//     a 2-stage cp.async ring: a key's row is found through the table
//     (any bs from 1 to 256: a tile may span several blocks or part of
//     one), rows past the range are zero-filled.  A quantized tile lands
//     as codes + scales and is dequantized once per tile into a bf16 tile,
//     not once per query token.  Rows are padded by 16 bytes, so ldmatrix
//     reads every head dim (32 .. 256, D / 16 16-byte chunks a row) without
//     bank conflicts and without padding D.
//   * S = Q K^T and O += P V are m16n8k16 bf16 mma.sync products, fp32
//     sums in registers; the online softmax runs on the accumulator layout
//     (a thread holds 2 rows, a row's values sit in one quad of lanes); P
//     goes from the S accumulators to the PV product's A fragments in
//     registers.  Each row is masked by its own token's position.
//   * chunk design (rows > 16): each warp owns 16 of the tile's 64 rows
//     against every key of the tile; a warp skips the key sub-tiles past
//     its rows' deepest position (exact: those keys would add exp(-1e30 -
//     m) = 0), so a causal chunk does about half the products.
//   * decode design (rows <= 16: one m16 tile, padded): the four warps
//     take 16 keys each of every 64-key tile, so all four walk the keys
//     and share each K/V load among the rep query heads of the group;
//     their (m, l, O) meet in shared memory in warp order.
//   * A split tile writes its fp32 (m, l, O) to a workspace slot; the last
//     CTA of the tile to arrive (a counter, reset by that CTA) combines the
//     splits in split order with weights exp(m_split - m_total) -- a split
//     whose keys are all masked for a row keeps m at -1e30 and gets weight
//     0 -- so a second call gives the same bits.
//
// What it leaves on the table (later work): mma.sync, not wgmma/TMA, in
// the chunk design, with 16 rows a warp (each K/V fragment read from
// shared memory serves one m16 tile; a 64-row wgmma tile with a TMA box
// per table block is the next step at large bs); Q fragments are read
// from shared memory for every key sub-tile (holding them in registers
// ran 5% slower on the Llama-3-8B mixed batch and 6% faster on
// falcon-7b's); a quantized tile's dequantization is a pass of its own
// between two barriers, on the critical path; the decode design pads rep
// (1 for BLOOM, 4 for Llama) to 16 rows, so 75-94% of its tensor-core
// work is padding (it is bound by bytes and by the latency of a block's
// first loads: item, positions, table, then the K/V rows); a split chunk
// tile (rep > 16) combines 64 rows of partials a split; the chunk
// design's tiles are not split, so a long-context prefill tile is the
// wave's tail.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;       // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kKeys = 64;           // keys a shared-memory tile
constexpr int kChunkRows = 64;      // query rows of a chunk tile (4 x 16)
constexpr int kDecodeRows = 16;     // query rows of a decode tile (one m16)
constexpr int kMaxBlockSize = 256;
constexpr int kItemInts = 8;        // t0, n, row0, b0, b1, split, nsplit, slot
constexpr int kHeaderInts = 8;      // n_items, next, n_slots, overflow,
                                    // done, 3 spare
constexpr int kPlanThreads = 1024;
constexpr float kNegInf = -1e30f;

// --- PTX helpers ----------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; `bytes` (0 or 16) read, the rest zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

// 4 bytes global -> shared, zero-filled when `bytes` is 0
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a b: m16n8k16, bf16 in, fp32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// --- the plan ---------------------------------------------------------------

// blocks a token at `pos` reads (none at a negative position)
__device__ __forceinline__ int blocks_for(int pos, int bs, int nb) {
  return pos < 0 ? 0 : min(pos / bs + 1, nb);
}

struct Run {
  int t0, n, rows, tiles, nblk;
  bool decode, splittable;
};

__device__ __forceinline__ Run run_at(const int* run_start,
                                      const int* positions, int r, int rep,
                                      int bs, int nb) {
  Run u;
  u.t0 = run_start[r];
  u.n = run_start[r + 1] - u.t0;
  u.rows = u.n * rep;
  u.decode = u.rows <= kDecodeRows;
  u.tiles = u.decode ? 1 : (u.rows + kChunkRows - 1) / kChunkRows;
  u.nblk = blocks_for(positions[u.t0 + u.n - 1], bs, nb);
  u.splittable = u.decode || u.n == 1;
  return u;
}

// splits of a run's tiles at w* blocks a split, and the blocks a split
__device__ __forceinline__ int splits_for(const Run& u, int wstar, int* bps) {
  *bps = u.nblk;
  if (!u.splittable || u.nblk <= wstar) return 1;
  const int want = (u.nblk + wstar - 1) / wstar;
  *bps = (u.nblk + want - 1) / want;
  return (u.nblk + *bps - 1) / *bps;
}

// exclusive prefix sum of v over the block; *total = the sum
template <typename I>
__device__ __forceinline__ I block_scan(I v, I* total, I* sh) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  I x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const I y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) sh[w] = x;
  __syncthreads();
  if (w == 0) {
    I s = lane < nw ? sh[lane] : I(0);
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const I y = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += y;
    }
    sh[lane] = s;
  }
  __syncthreads();
  const I ex = x - v + (w > 0 ? sh[w - 1] : I(0));
  *total = sh[nw - 1];
  __syncthreads();
  return ex;
}

// The plan: one block.  Workspace (int32): header [4], run_start [T + 1],
// item_off [T + 1], slot_off [T + 1], then the items (kItemInts each) at
// items_offset(T).  Up to kPlanSmemTokens tokens the three scratch arrays
// and a copy of seq_slot and positions live in shared memory instead (the
// passes below read them again and again: a round trip to L2 each in
// global memory).
constexpr int kPlanSmemTokens = 8192;

__host__ __device__ __forceinline__ int items_offset(int T) {
  return kHeaderInts + (3 * (T + 1) + 3) / 4 * 4;
}

__host__ __device__ __forceinline__ int plan_smem_bytes(int T) {
  return T <= kPlanSmemTokens ? 5 * (T + 1) * (int)sizeof(int) : 0;
}

__global__ void __launch_bounds__(kPlanThreads)
paged_attention_plan_kernel(const int* __restrict__ seq_slot_g,
                            const int* __restrict__ positions_g,
                            int* __restrict__ plan, int T, int rep, int bs,
                            int nb, int target, int max_items) {
  extern __shared__ int plan_sh[];
  __shared__ long long sh64[32];
  __shared__ int sh32[32];
  const bool in_smem = T <= kPlanSmemTokens;
  int* run_start = in_smem ? plan_sh : plan + kHeaderInts;
  int* item_off = run_start + T + 1;
  int* slot_off = item_off + T + 1;
  int* items = plan + items_offset(T);
  const int tid = threadIdx.x;
  const int* seq_slot = seq_slot_g;
  const int* positions = positions_g;
  if (in_smem) {
    int* sl = slot_off + T + 1;
    int* ps = sl + T + 1;
    for (int t = tid; t < T; t += blockDim.x) {
      sl[t] = seq_slot_g[t];
      ps[t] = positions_g[t];
    }
    seq_slot = sl;
    positions = ps;
    __syncthreads();
  }

  // 1. runs: a token starts one unless it continues the previous token's
  // sequence at the next position
  int R = 0;
  for (int base = 0; base < T; base += blockDim.x) {
    const int t = base + tid;
    int flag = 0;
    if (t < T)
      flag = t == 0 || seq_slot[t] != seq_slot[t - 1] ||
             positions[t] != positions[t - 1] + 1;
    int total;
    const int ex = block_scan<int>(flag, &total, sh32);
    if (flag) run_start[R + ex] = t;
    R += total;
  }
  if (tid == 0) run_start[R] = T;
  __syncthreads();

  // 2. W: the KV blocks the tiles read, each at its run's deepest token
  long long W = 0;
  for (int base = 0; base < R; base += blockDim.x) {
    const int r = base + tid;
    long long w = 0;
    if (r < R) {
      const Run u = run_at(run_start, positions, r, rep, bs, nb);
      w = (long long)u.tiles * u.nblk;
    }
    long long total;
    block_scan<long long>(w, &total, sh64);
    W += total;
  }
  const int wstar = (int)max(1LL, (W + target - 1) / target);

  // 3. items and workspace slots per run
  int n_items = 0, n_slots = 0;
  for (int base = 0; base < R; base += blockDim.x) {
    const int r = base + tid;
    int ni = 0, ns = 0;
    if (r < R) {
      const Run u = run_at(run_start, positions, r, rep, bs, nb);
      int bps;
      const int nsplit = splits_for(u, wstar, &bps);
      ni = u.tiles * nsplit;
      ns = nsplit > 1 ? ni : 0;
    }
    int ti, ts;
    const int ei = block_scan<int>(ni, &ti, sh32);
    const int es = block_scan<int>(ns, &ts, sh32);
    if (r < R) {
      item_off[r] = n_items + ei;
      slot_off[r] = n_slots + es;
    }
    n_items += ti;
    n_slots += ts;
  }
  if (tid == 0) {
    item_off[R] = n_items;
    slot_off[R] = n_slots;
    plan[0] = min(n_items, max_items);
    plan[1] = 0;                       // the work kernel's item counter
    plan[2] = n_slots;
    plan[3] = n_items > max_items;
    plan[4] = 0;                       // its blocks done
  }
  __syncthreads();

  // 4. the items, one a thread: its run by binary search of item_off
  const int count = min(n_items, max_items);
  for (int i = tid; i < count; i += blockDim.x) {
    int lo = 0, hi = R - 1;            // the last r with item_off[r] <= i
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (item_off[mid] <= i) lo = mid; else hi = mid - 1;
    }
    const Run u = run_at(run_start, positions, lo, rep, bs, nb);
    int bps;
    const int nsplit = splits_for(u, wstar, &bps);
    const int local = i - item_off[lo];
    const int k = local / nsplit, s = local % nsplit;
    const int row0 = k * (u.decode ? kDecodeRows : kChunkRows);
    int b0 = 0, b1;
    if (nsplit > 1) {
      b0 = s * bps;
      b1 = min(b0 + bps, u.nblk);
    } else {
      const int rows = min(u.decode ? kDecodeRows : kChunkRows,
                           u.rows - row0);
      const int last = min(u.n - 1, (row0 + rows - 1) / rep);
      b1 = blocks_for(positions[u.t0 + last], bs, nb);
    }
    int* it = items + (size_t)i * kItemInts;
    it[0] = u.t0;
    it[1] = u.n;
    it[2] = row0;
    it[3] = b0;
    it[4] = b1;
    it[5] = s;
    it[6] = nsplit;
    it[7] = nsplit > 1 ? slot_off[lo] + local : -1;
  }
}

// --- the work kernel --------------------------------------------------------

template <int D>
struct Layout {
  static constexpr int ROW = 2 * D + 16;         // a padded bf16 row, bytes
  static constexpr int TILE = kKeys * ROW;       // one K or V bf16 tile
  static constexpr int Q = 0;                    // [64][ROW]
  static constexpr int KV = kChunkRows * ROW;
  // bf16 cache: stage s holds K at KV + 2 s TILE and V one TILE on.
  // Quantized: the bf16 work tiles K, V at KV, then stage s's codes (K
  // [64][D] bytes, V [64][D]) and scales (K [64], V [64] fp32) at STAGE0 +
  // s STAGE
  static constexpr int STAGE = 2 * kKeys * D + 2 * kKeys * 4;
  static constexpr int STAGE0 = KV + 2 * TILE;
  static constexpr int KV_BYTES =
      4 * TILE > 2 * TILE + 2 * STAGE ? 4 * TILE : 2 * TILE + 2 * STAGE;
  static constexpr int BYTES = KV + KV_BYTES;
  // a partial (fp32): O [64][D], m [64], l [64]
  static constexpr int PARTIAL = kChunkRows * (D + 2);
  // the decode design's warp meeting (fp32): O [4][16][D], m, l [4][16]
  static_assert(kWarps * kDecodeRows * (D + 2) * 4 <= KV_BYTES,
                "the decode warps meet in the K/V tiles' shared memory");
  static_assert(BYTES <= 232448, "shared memory of one block");
  static_assert(D % 16 == 0, "ldmatrix takes 16-byte chunks of a row");
};

struct Args {
  const void* kv;
  const float* kv_scales;
  const float* slopes;
  const __nv_bfloat16* q;
  const int* seq_slot;
  const int* positions;
  const int* block_tables;
  __nv_bfloat16* out;
  int* plan;
  int* counters;
  float* partials;
  int T, H, Hkv, bs, nrows, tbl_stride, code_type;
  float scale;
};

// the rows a thread's online softmax masks: its two rows' positions and
// ALiBi slopes, the item's key end
struct Rows {
  int pos[2];
  float slope[2];
  int kend;
  float scale;
  bool alibi;
};

// One warp: its 16 query rows (Q at q_base, rows ROW bytes apart) against
// KS keys (K at k_base, V at v_base) whose first key sits at sequence
// position key0; the online-softmax state (m, l per thread row, O in the
// m16n8 accumulator layout) is the warp's.
template <int D, int KS>
__device__ __forceinline__ void attend(uint32_t q_base, uint32_t k_base,
                                       uint32_t v_base, int key0,
                                       const Rows& rw, float (&acc)[D / 8][4],
                                       float (&m)[2], float (&l)[2]) {
  constexpr int ROW = Layout<D>::ROW;
  const int lane = threadIdx.x & 31;
  float s[KS / 8][4];
#pragma unroll
  for (int nt = 0; nt < KS / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;

  // S = Q K^T: A rows = lane & 15 at column half lane >> 4; B (K rows) =
  // keys (lane >> 4) * 8 + (lane & 7) at column half (lane >> 3) & 1
  const uint32_t qa = q_base + (lane & 15) * ROW + (lane >> 4) * 16;
  const uint32_t ka =
      k_base + ((lane >> 4) * 8 + (lane & 7)) * ROW + ((lane >> 3) & 1) * 16;
#pragma unroll
  for (int kd = 0; kd < D / 16; ++kd) {
    uint32_t a[4];
    ldsm_x4(a, qa + kd * 32);
#pragma unroll
    for (int np = 0; np < KS / 16; ++np) {
      uint32_t b[4];
      ldsm_x4(b, ka + np * 16 * ROW + kd * 32);
      mma_bf16(s[2 * np], a, b[0], b[1]);
      mma_bf16(s[2 * np + 1], a, b[2], b[3]);
    }
  }

  // scale (+ ALiBi), mask, online softmax; a thread's rows are lane / 4
  // (e = 0, 1) and lane / 4 + 8 (e = 2, 3), its keys 2 (lane % 4) + e % 2
  // of each 8-key tile
  const int c2 = (lane & 3) * 2;
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int nt = 0; nt < KS / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = key0 + nt * 8 + c2 + (e & 1);
      const int h = e >> 1;
      float x = rw.alibi ? __fadd_rn(__fmul_rn(s[nt][e], rw.scale),
                                     __fmul_rn(rw.slope[h], (float)key))
                         : s[nt][e] * rw.scale;
      if (key > rw.pos[h] || key >= rw.kend) x = kNegInf;
      s[nt][e] = x;
      mx[h] = fmaxf(mx[h], x);
    }
  float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    const float mn = fmaxf(m[h], mx[h]);
    corr[h] = __expf(m[h] - mn);
    m[h] = mn;
  }
#pragma unroll
  for (int nt = 0; nt < KS / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = __expf(s[nt][e] - m[e >> 1]);
      s[nt][e] = p;
      sum[e >> 1] += p;
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
    l[h] = l[h] * corr[h] + sum[h];
  }
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    acc[dt][0] *= corr[0];
    acc[dt][1] *= corr[0];
    acc[dt][2] *= corr[1];
    acc[dt][3] *= corr[1];
  }

  // O += P V: P (bf16) from the S accumulators; B (V rows, transposed) =
  // keys (lane & 7) + ((lane >> 3) & 1) * 8 at column half lane >> 4
  const uint32_t va =
      v_base + ((lane & 7) + ((lane >> 3) & 1) * 8) * ROW + (lane >> 4) * 16;
#pragma unroll
  for (int kk = 0; kk < KS / 16; ++kk) {
    uint32_t a[4];
    a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
    a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
    a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
    a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t b[4];
      ldsm_x4_t(b, va + kk * 16 * ROW + dp * 32);
      mma_bf16(acc[2 * dp], a, b[0], b[1]);
      mma_bf16(acc[2 * dp + 1], a, b[2], b[3]);
    }
  }
}

// the trash row for -1 pads and entries past the cache
__device__ __forceinline__ int table_row(const int* table, int key, int bs,
                                         int nrows) {
  const int b = table[key / bs];
  return (b < 0 || b >= nrows) ? nrows - 1 : b;
}

// the 4 codes of a 32-bit word as floats, exactly: an int8 code c (its
// byte XOR 0x80 is c + 128) under the fp32 2^23 less 2^23 + 128; fp8 e4m3
// two at a time to f16x2 (every e4m3 value is an fp16 one)
__device__ __forceinline__ void codes4(uint32_t w, int code_type,
                                       float (&f)[4]) {
  if (code_type == 1) {
    const uint32_t x = w ^ 0x80808080u;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      f[i] = __uint_as_float(0x4B000000u | ((x >> (8 * i)) & 0xffu)) -
             8388736.f;
  } else {
    __half2_raw lo = __nv_cvt_fp8x2_to_halfraw2(
        (__nv_fp8x2_storage_t)(w & 0xffffu), __NV_E4M3);
    __half2_raw hi = __nv_cvt_fp8x2_to_halfraw2(
        (__nv_fp8x2_storage_t)(w >> 16), __NV_E4M3);
    const float2 a = __half22float2(*reinterpret_cast<__half2*>(&lo));
    const float2 b = __half22float2(*reinterpret_cast<__half2*>(&hi));
    f[0] = a.x;
    f[1] = a.y;
    f[2] = b.x;
    f[3] = b.y;
  }
}

// one work item (tile `it`, KV head g)
template <int D>
__device__ void run_item(const Args& a, const int* __restrict__ itm, int g,
                         unsigned char* smem, int* pos_s, float* slope_s,
                         float* rowm_s, float* rowl_s, int* last_s) {
  using L = Layout<D>;
  constexpr int ROW = L::ROW;
  constexpr int KSC = D > 128 ? 32 : 64;       // chunk design's key sub-tile
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t0 = itm[0], n = itm[1], row0 = itm[2], b0 = itm[3],
            b1 = itm[4], split = itm[5], nsplit = itm[6], slot = itm[7];
  const int H = a.H, Hkv = a.Hkv, rep = H / Hkv, bs = a.bs;
  const bool decode = n * rep <= kDecodeRows;
  const int tile_rows = decode ? kDecodeRows : kChunkRows;
  const int rows = min(tile_rows, n * rep - row0);
  const bool quant = a.code_type != 0;
  const int* table =
      a.block_tables + (size_t)a.seq_slot[t0] * a.tbl_stride;

  // the tile's rows: position and slope of each
  if (tid < kChunkRows) {
    const int f = row0 + tid;
    const bool ok = tid < rows;
    pos_s[tid] = ok ? a.positions[t0 + f / rep] : -1;
    slope_s[tid] = (ok && a.slopes) ? a.slopes[g * rep + f % rep] : 0.f;
  }
  const int maxpos =
      a.positions[t0 + min(n - 1, (row0 + rows - 1) / rep)];
  const int kstart = b0 * bs;
  const int kend = max(kstart, min(b1 * bs, maxpos + 1));
  const int ntiles = (kend - kstart + kKeys - 1) / kKeys;

  unsigned char* qs = smem + L::Q;
  // Q rows: (token, head) of flat row row0 + i; rows past the tile zero
  for (int c = tid; c < tile_rows * (D / 8); c += kThreads) {
    const int i = c / (D / 8), part = c % (D / 8);
    const int f = row0 + i;
    const bool ok = i < rows;
    const __nv_bfloat16* src =
        ok ? a.q + ((size_t)(t0 + f / rep) * H + g * rep + f % rep) * D +
                 part * 8
           : a.q;
    cp_async16(qs + i * ROW + part * 16, src, ok ? 16 : 0);
  }

  // one 64-key tile of K and V (codes and scales when quantized) into
  // stage st; keys past kend are zeros
  const size_t krow = (size_t)2 * Hkv * D;     // elements from row to row
  auto load_tile = [&](int tile, int st) {
    const int kb = kstart + tile * kKeys;
    if (!quant) {
      const __nv_bfloat16* kv = static_cast<const __nv_bfloat16*>(a.kv);
      unsigned char* kd = smem + L::KV + st * 2 * L::TILE;
      for (int c = tid; c < kKeys * (D / 8); c += kThreads) {
        const int key = c / (D / 8), part = c % (D / 8);
        const int kp = kb + key;
        const bool ok = kp < kend;
        const __nv_bfloat16* src = kv;
        if (ok) {
          const int b = table_row(table, kp, bs, a.nrows);
          src = kv + ((size_t)b * bs + (kp - kp / bs * bs)) * krow +
                (size_t)g * D + part * 8;
        }
        cp_async16(kd + key * ROW + part * 16, src, ok ? 16 : 0);
        cp_async16(kd + L::TILE + key * ROW + part * 16,
                   ok ? src + (size_t)Hkv * D : src, ok ? 16 : 0);
      }
    } else {
      const unsigned char* kv = static_cast<const unsigned char*>(a.kv);
      unsigned char* sd = smem + L::STAGE0 + st * L::STAGE;
      for (int c = tid; c < kKeys * (D / 16); c += kThreads) {
        const int key = c / (D / 16), part = c % (D / 16);
        const int kp = kb + key;
        const bool ok = kp < kend;
        const unsigned char* src = kv;
        if (ok) {
          const int b = table_row(table, kp, bs, a.nrows);
          src = kv + ((size_t)b * bs + (kp - kp / bs * bs)) * krow +
                (size_t)g * D + part * 16;
        }
        cp_async16(sd + key * D + part * 16, src, ok ? 16 : 0);
        cp_async16(sd + kKeys * D + key * D + part * 16,
                   ok ? src + (size_t)Hkv * D : src, ok ? 16 : 0);
      }
      float* sc = reinterpret_cast<float*>(sd + 2 * kKeys * D);
      for (int key = tid; key < kKeys; key += kThreads) {
        const int kp = kb + key;
        const bool ok = kp < kend;
        const float* src = a.kv_scales;
        if (ok) {
          const int b = table_row(table, kp, bs, a.nrows);
          src = a.kv_scales + ((size_t)b * bs + (kp - kp / bs * bs)) * 2 *
                                  Hkv + g;
        }
        cp_async4(sc + key, src, ok ? 4 : 0);
        cp_async4(sc + kKeys + key, ok ? src + Hkv : src, ok ? 4 : 0);
      }
    }
  };

  // codes of stage st -> the bf16 work tiles: bf16(float(code) x scale),
  // 16 codes a step
  auto dequant = [&](int st) {
    const unsigned char* sd = smem + L::STAGE0 + st * L::STAGE;
    const float* sc = reinterpret_cast<const float*>(sd + 2 * kKeys * D);
    for (int c = tid; c < 2 * kKeys * (D / 16); c += kThreads) {
      const int kvi = c / (kKeys * (D / 16));
      const int rem = c % (kKeys * (D / 16));
      const int key = rem / (D / 16), part = rem % (D / 16);
      const uint4 u = *reinterpret_cast<const uint4*>(
          sd + kvi * kKeys * D + key * D + part * 16);
      const float s = sc[kvi * kKeys + key];
      const uint32_t w[4] = {u.x, u.y, u.z, u.w};
      uint32_t o[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float f[4];
        codes4(w[i], a.code_type, f);
        o[2 * i] = pack_bf16(f[0] * s, f[1] * s);
        o[2 * i + 1] = pack_bf16(f[2] * s, f[3] * s);
      }
      uint4* dst = reinterpret_cast<uint4*>(smem + L::KV + kvi * L::TILE +
                                            key * ROW + part * 32);
      dst[0] = make_uint4(o[0], o[1], o[2], o[3]);
      dst[1] = make_uint4(o[4], o[5], o[6], o[7]);
    }
  };

  __syncthreads();                    // pos_s, slope_s written
  if (ntiles > 0) load_tile(0, 0);
  cp_async_commit();                  // Q and tile 0

  // this thread's two rows (of the warp's 16) and the warp's deepest one
  const int wrow0 = decode ? 0 : warp * 16;
  Rows rw;
  rw.kend = kend;
  rw.scale = a.scale;
  rw.alibi = a.slopes != nullptr;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    rw.pos[h] = pos_s[wrow0 + (lane >> 2) + 8 * h];
    rw.slope[h] = slope_s[wrow0 + (lane >> 2) + 8 * h];
  }
  int wmax = pos_s[wrow0 + (lane & 15)];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    wmax = max(wmax, __shfl_xor_sync(0xffffffffu, wmax, o));

  float acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const uint32_t q_base = smem_u32(qs + wrow0 * ROW);

  for (int i = 0; i < ntiles; ++i) {
    if (i + 1 < ntiles) load_tile(i + 1, (i + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int kb = kstart + i * kKeys;
    uint32_t k_base, v_base;
    if (quant) {
      dequant(i & 1);
      __syncthreads();
      k_base = smem_u32(smem + L::KV);
    } else {
      k_base = smem_u32(smem + L::KV + (i & 1) * 2 * L::TILE);
    }
    v_base = k_base + L::TILE;
    if (decode) {
      // the warps take 16 keys each of the tile
      const int k0 = kb + warp * 16;
      if (k0 <= wmax && k0 < kend)
        attend<D, 16>(q_base, k_base + warp * 16 * ROW,
                      v_base + warp * 16 * ROW, k0, rw, acc, m, l);
    } else {
#pragma unroll 1
      for (int j = 0; j < kKeys; j += KSC) {
        const int k0 = kb + j;
        if (k0 <= wmax && k0 < kend)
          attend<D, KSC>(q_base, k_base + j * ROW, v_base + j * ROW, k0, rw,
                         acc, m, l);
      }
    }
    __syncthreads();                  // the stage is free for tile i + 2
  }
  cp_async_wait<0>();
  __syncthreads();

  // the tile's result, per row r < rows: out (no split) or a partial
  const int c2 = (lane & 3) * 2;
  float* part = nsplit > 1
                    ? a.partials + ((size_t)slot * Hkv + g) * L::PARTIAL
                    : nullptr;
  auto out_row = [&](int r) {
    const int f = row0 + r;
    return a.out + ((size_t)(t0 + f / rep) * H + g * rep + f % rep) * D;
  };
  if (decode) {
    // the four warps meet in shared memory, in warp order
    float* wo = reinterpret_cast<float*>(smem + L::KV);   // [4][16][D]
    float* wm = wo + kWarps * kDecodeRows * D;            // [4][16]
    float* wl = wm + kWarps * kDecodeRows;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = (lane >> 2) + 8 * h;
      float* o = wo + (warp * kDecodeRows + r) * D + c2;
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        o[dt * 8] = acc[dt][2 * h];
        o[dt * 8 + 1] = acc[dt][2 * h + 1];
      }
      if ((lane & 3) == 0) {
        wm[warp * kDecodeRows + r] = m[h];
        wl[warp * kDecodeRows + r] = l[h];
      }
    }
    __syncthreads();
    if (tid < rows) {
      float mt = kNegInf;
      for (int w = 0; w < kWarps; ++w)
        mt = fmaxf(mt, wm[w * kDecodeRows + tid]);
      float lt = 0.f;
      for (int w = 0; w < kWarps; ++w)
        lt += wl[w * kDecodeRows + tid] * __expf(wm[w * kDecodeRows + tid] -
                                                 mt);
      rowm_s[tid] = mt;
      rowl_s[tid] = lt;
    }
    __syncthreads();
    for (int e = tid; e < rows * (D / 2); e += kThreads) {
      const int r = e / (D / 2), d = (e % (D / 2)) * 2;
      const float mt = rowm_s[r];
      float o0 = 0.f, o1 = 0.f;
      for (int w = 0; w < kWarps; ++w) {
        const float wt = __expf(wm[w * kDecodeRows + r] - mt);
        o0 += wo[(w * kDecodeRows + r) * D + d] * wt;
        o1 += wo[(w * kDecodeRows + r) * D + d + 1] * wt;
      }
      if (part) {
        part[r * D + d] = o0;
        part[r * D + d + 1] = o1;
        if (d == 0) {
          part[kChunkRows * D + r] = mt;
          part[kChunkRows * D + kChunkRows + r] = rowl_s[r];
        }
      } else {
        const float inv = 1.f / fmaxf(rowl_s[r], 1e-30f);
        *reinterpret_cast<uint32_t*>(out_row(r) + d) =
            pack_bf16(o0 * inv, o1 * inv);
      }
    }
  } else {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wrow0 + (lane >> 2) + 8 * h;
      if (r >= rows) continue;
      if (part) {
        float* o = part + r * D + c2;
#pragma unroll
        for (int dt = 0; dt < D / 8; ++dt) {
          o[dt * 8] = acc[dt][2 * h];
          o[dt * 8 + 1] = acc[dt][2 * h + 1];
        }
        if ((lane & 3) == 0) {
          part[kChunkRows * D + r] = m[h];
          part[kChunkRows * D + kChunkRows + r] = l[h];
        }
      } else {
        const float inv = 1.f / fmaxf(l[h], 1e-30f);
        __nv_bfloat16* o = out_row(r) + c2;
#pragma unroll
        for (int dt = 0; dt < D / 8; ++dt)
          *reinterpret_cast<uint32_t*>(o + dt * 8) =
              pack_bf16(acc[dt][2 * h] * inv, acc[dt][2 * h + 1] * inv);
      }
    }
  }
  if (part == nullptr) return;

  // a split: the last CTA of the tile to arrive combines the splits in
  // split order and resets the tile's counter
  __threadfence();
  __syncthreads();
  int* counter = a.counters + (size_t)(slot - split) * Hkv + g;
  if (tid == 0) *last_s = atomicAdd(counter, 1) == nsplit - 1;
  __syncthreads();
  if (!*last_s) return;
  __threadfence();
  const float* p0 =
      a.partials + ((size_t)(slot - split) * Hkv + g) * L::PARTIAL;
  const size_t pstride = (size_t)Hkv * L::PARTIAL;    // split to split
  if (tid < rows) {
    float mt = kNegInf;
#pragma unroll 8
    for (int s = 0; s < nsplit; ++s)
      mt = fmaxf(mt, __ldcg(p0 + s * pstride + kChunkRows * D + tid));
    float lt = 0.f;
#pragma unroll 8
    for (int s = 0; s < nsplit; ++s) {
      const float* ps = p0 + s * pstride + kChunkRows * D;
      lt += __ldcg(ps + kChunkRows + tid) * __expf(__ldcg(ps + tid) - mt);
    }
    rowm_s[tid] = mt;
    rowl_s[tid] = lt;
  }
  __syncthreads();
  for (int e = tid; e < rows * (D / 2); e += kThreads) {
    const int r = e / (D / 2), d = (e % (D / 2)) * 2;
    const float mt = rowm_s[r];
    float o0 = 0.f, o1 = 0.f;
#pragma unroll 8
    for (int s = 0; s < nsplit; ++s) {
      const float* ps = p0 + s * pstride;
      const float wt = __expf(__ldcg(ps + kChunkRows * D + r) - mt);
      const float2 v = __ldcg(reinterpret_cast<const float2*>(ps + r * D + d));
      o0 += v.x * wt;
      o1 += v.y * wt;
    }
    const float inv = 1.f / fmaxf(rowl_s[r], 1e-30f);
    *reinterpret_cast<uint32_t*>(out_row(r) + d) =
        pack_bf16(o0 * inv, o1 * inv);
  }
  if (tid == 0) *counter = 0;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int pos_s[kChunkRows];
  __shared__ float slope_s[kChunkRows];
  __shared__ float rowm_s[kChunkRows], rowl_s[kChunkRows];
  __shared__ int work_s, last_s;
  const int* items = a.plan + items_offset(a.T);
  const int n_items = a.plan[0];
  const int total = n_items * a.Hkv;
  // the first work unit is the block's own; the rest come from the counter
  // the plan zeroed.  Units run from the last item down: a chunk run's
  // deepest tiles first
  int w = blockIdx.x;
  while (w < total) {
    const int it = n_items - 1 - w / a.Hkv;
    run_item<D>(a, items + (size_t)it * kItemInts, w % a.Hkv, smem, pos_s,
                slope_s, rowm_s, rowl_s, &last_s);
    __syncthreads();
    if (threadIdx.x == 0) work_s = gridDim.x + atomicAdd(a.plan + 1, 1);
    __syncthreads();
    w = work_s;
  }
  // the last block out sets the item counter back to 0, so that the next
  // launch may run on this plan without the plan kernel
  if (threadIdx.x == 0 && atomicAdd(a.plan + 4, 1) == gridDim.x - 1) {
    a.plan[1] = 0;
    a.plan[4] = 0;
  }
}

template <int D>
cudaError_t launch_d(const Args& a, int max_items, int sms,
                     cudaStream_t stream) {
  using L = Layout<D>;
  auto kernel = paged_attention_kernel<D>;
  static int per_sm = 0;               // resident blocks an SM, once
  if (per_sm == 0) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
    if (e != cudaSuccess) return e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, L::BYTES);
    if (e != cudaSuccess) return e;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
  }
  const long long units = (long long)max_items * a.Hkv;
  const int grid = (int)(units < (long long)per_sm * sms
                             ? units
                             : (long long)per_sm * sms);
  kernel<<<grid, kThreads, L::BYTES, stream>>>(a);
  return cudaGetLastError();
}

cudaError_t plan_launch(const int* seq_slot, const int* positions, int* plan,
                        int T, int rep, int bs, int nb, int target,
                        int max_items, cudaStream_t stream) {
  static bool ready = false;
  if (!ready) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_attention_plan_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        plan_smem_bytes(kPlanSmemTokens));
    if (e != cudaSuccess) return e;
    ready = true;
  }
  paged_attention_plan_kernel<<<1, kPlanThreads, plan_smem_bytes(T),
                                stream>>>(seq_slot, positions, plan, T, rep,
                                          bs, nb, target, max_items);
  return cudaGetLastError();
}

cudaError_t launch(Args a, int D, int nb, int max_items, int target, int sms,
                   int replan, cudaStream_t stream) {
  if (a.T == 0) return cudaSuccess;
  if (a.Hkv <= 0 || a.H % a.Hkv != 0 || a.bs < 1 || a.bs > kMaxBlockSize ||
      nb < 1 || target < 1 || max_items < 1 || sms < 1)
    return cudaErrorInvalidValue;
  if (replan) {
    const cudaError_t e =
        plan_launch(a.seq_slot, a.positions, a.plan, a.T, a.H / a.Hkv, a.bs,
                    nb, target, max_items, stream);
    if (e != cudaSuccess) return e;
  }
  switch (D) {
    case 32: return launch_d<32>(a, max_items, sms, stream);
    case 64: return launch_d<64>(a, max_items, sms, stream);
    case 80: return launch_d<80>(a, max_items, sms, stream);
    case 96: return launch_d<96>(a, max_items, sms, stream);
    case 128: return launch_d<128>(a, max_items, sms, stream);
    case 256: return launch_d<256>(a, max_items, sms, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Every entry returns cudaGetLastError() after its launches (0 on success),
// launches on `stream` and does not synchronise.  `plan` is the wrapper's
// int32 workspace (items_offset(T) + 8 max_items ints), `counters` its
// int32 split counters (zero between calls; the kernel leaves them so),
// `partials` its fp32 split partials; `target` the plan's work items a KV
// head, `max_items` a bound on the items the plan writes (the wrapper's
// max_items), `sms` the card's SMs.  `replan` 0 skips the plan kernel: the
// caller vouches that `plan` holds the plan of these very seq_slot and
// positions values and widths.  `slopes`: H fp32 ALiBi slopes in head
// order, or null for none.
extern "C" int paged_attention_bf16(const void* kv, const void* slopes,
                                    const void* q, const void* seq_slot,
                                    const void* positions,
                                    const void* block_tables, void* out,
                                    void* plan, void* counters,
                                    void* partials, int T, int H, int Hkv,
                                    int D, int bs, int nrows, int tbl_stride,
                                    int nb, int max_items, int target,
                                    int sms, int replan, float scale,
                                    void* stream) {
  Args a{kv, nullptr, static_cast<const float*>(slopes),
         static_cast<const __nv_bfloat16*>(q), static_cast<const int*>(seq_slot),
         static_cast<const int*>(positions),
         static_cast<const int*>(block_tables),
         static_cast<__nv_bfloat16*>(out), static_cast<int*>(plan),
         static_cast<int*>(counters), static_cast<float*>(partials),
         T, H, Hkv, bs, nrows, tbl_stride, 0, scale};
  return (int)launch(a, D, nb, max_items, target, sms, replan,
                     static_cast<cudaStream_t>(stream));
}

// The quantized cache: `kv` holds int8 (code_type 0) or fp8 e4m3 (code_type
// 1) codes, `kv_scales` their fp32 scales.  Same contract otherwise.
extern "C" int paged_attention_quant(const void* kv, const void* kv_scales,
                                     const void* slopes, const void* q,
                                     const void* seq_slot,
                                     const void* positions,
                                     const void* block_tables, void* out,
                                     void* plan, void* counters,
                                     void* partials, int T, int H, int Hkv,
                                     int D, int bs, int nrows, int tbl_stride,
                                     int nb, int max_items, int target,
                                     int sms, int replan, float scale,
                                     int code_type, void* stream) {
  if (kv_scales == nullptr || (code_type != 0 && code_type != 1))
    return (int)cudaErrorInvalidValue;
  Args a{kv, static_cast<const float*>(kv_scales),
         static_cast<const float*>(slopes),
         static_cast<const __nv_bfloat16*>(q), static_cast<const int*>(seq_slot),
         static_cast<const int*>(positions),
         static_cast<const int*>(block_tables),
         static_cast<__nv_bfloat16*>(out), static_cast<int*>(plan),
         static_cast<int*>(counters), static_cast<float*>(partials),
         T, H, Hkv, bs, nrows, tbl_stride, code_type + 1, scale};
  return (int)launch(a, D, nb, max_items, target, sms, replan,
                     static_cast<cudaStream_t>(stream));
}

// The plan alone (the work kernel's first launch), for the tests that hold
// it against the wrapper's plan_plain.
extern "C" int paged_attention_plan(const void* seq_slot,
                                    const void* positions, void* plan, int T,
                                    int rep, int bs, int nb, int max_items,
                                    int target, void* stream) {
  if (T < 1 || rep < 1 || bs < 1 || nb < 1 || target < 1 || max_items < 1)
    return (int)cudaErrorInvalidValue;
  return (int)plan_launch(static_cast<const int*>(seq_slot),
                          static_cast<const int*>(positions),
                          static_cast<int*>(plan), T, rep, bs, nb, target,
                          max_items, static_cast<cudaStream_t>(stream));
}
