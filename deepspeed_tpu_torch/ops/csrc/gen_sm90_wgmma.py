"""Write ``sm90_wgmma.cuh``: the ``wgmma.mma_async`` wrappers the Hopper
kernels use (flash attention, the mixed-input GEMM), one inline-PTX
function per (operand kind, N, element type).  A ``wgmma`` lists every accumulator register in its
operand list, so the wrappers are generated rather than written out.

    python deepspeed_tpu_torch/ops/csrc/gen_sm90_wgmma.py

* ``wgmma_ss<T, N>(d, desc_a, desc_b, scale_d)``: D[64 x N] (+)= A B^T
  with A and B in shared memory, both K-major (the K dim contiguous).
* ``wgmma_ss_mn<T, N>(d, desc_a, desc_b, scale_d)``: D[64 x N] (+)= A B
  with A in shared memory K-major and B in shared memory MN-major (N
  contiguous: the transposed-B form that 16-bit types allow).
* ``wgmma_rs<T, N>(d, a, desc_b)``: D[64 x N] += A B with A in registers
  (the m16n8k16 A fragment of each warp's 16 rows, 4 x 32 bits) and B in
  shared memory MN-major (N contiguous: the transposed-B form that 16-bit
  types allow).

``d`` holds the N / 2 fp32 accumulators of each thread, in wgmma's
accumulator layout.
"""

from pathlib import Path

# 48: dq's S = Q K^T and dP = dO V^T over 48-key tiles at D 256; 80: the
# D 256 forward's S = Q K^T over 80-key tiles
SS_N = (48, 64, 80, 128)
RS_N = (32, 64, 80, 96, 128, 256)
# wgmma_ss_mn: the mixed-input GEMM's bf16 m64n128 products
SS_MN = (("__nv_bfloat16", "bf16", 128),)
TYPES = (("__nv_bfloat16", "bf16"), ("__half", "f16"))


def regs(n, first=0):
    return ", ".join(f"%{first + i}" for i in range(n))


def outs(n):
    return ", ".join(f'"+f"(d[{i}])' for i in range(n))


def ss(ctype, ptx, n):
    nd = n // 2
    return f'''template <>
__device__ __forceinline__ void wgmma_ss<{ctype}, {n}>(
    float (&d)[{nd}], uint64_t desc_a, uint64_t desc_b, int scale_d) {{
  asm volatile(
      "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{nd + 2}, 0;\\n"
      "wgmma.mma_async.sync.aligned.m64n{n}k16.f32.{ptx}.{ptx} "
      "{{{regs(nd)}}}, %{nd}, %{nd + 1}, p, 1, 1, 0, 0;\\n}}\\n"
      : {outs(nd)}
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}}
'''


def ss_mn(ctype, ptx, n):
    nd = n // 2
    return f'''template <>
__device__ __forceinline__ void wgmma_ss_mn<{ctype}, {n}>(
    float (&d)[{nd}], uint64_t desc_a, uint64_t desc_b, int scale_d) {{
  asm volatile(
      "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{nd + 2}, 0;\\n"
      "wgmma.mma_async.sync.aligned.m64n{n}k16.f32.{ptx}.{ptx} "
      "{{{regs(nd)}}}, %{nd}, %{nd + 1}, p, 1, 1, 0, 1;\\n}}\\n"
      : {outs(nd)}
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}}
'''


def rs(ctype, ptx, n):
    nd = n // 2
    return f'''template <>
__device__ __forceinline__ void wgmma_rs<{ctype}, {n}>(
    float (&d)[{nd}], const uint32_t (&a)[4], uint64_t desc_b) {{
  asm volatile(
      "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{nd + 5}, 0;\\n"
      "wgmma.mma_async.sync.aligned.m64n{n}k16.f32.{ptx}.{ptx} "
      "{{{regs(nd)}}}, {{{regs(4, nd)}}}, %{nd + 4}, p, 1, 1, 1;\\n}}\\n"
      : {outs(nd)}
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}}
'''


def render():
    """The text of ``sm90_wgmma.cuh``."""
    parts = ['''// Generated by gen_sm90_wgmma.py (same directory); edit that, not this.
// wgmma.mma_async wrappers for sm_90a: see the generator's docstring.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace sm90 {

template <typename T, int N>
__device__ void wgmma_ss(float (&d)[N / 2], uint64_t desc_a, uint64_t desc_b,
                         int scale_d);
template <typename T, int N>
__device__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                         uint64_t desc_b);
''']
    for ctype, ptx in TYPES:
        parts += [ss(ctype, ptx, n) for n in SS_N]
        parts += [rs(ctype, ptx, n) for n in RS_N]
    parts.append('''template <typename T, int N>
__device__ void wgmma_ss_mn(float (&d)[N / 2], uint64_t desc_a,
                            uint64_t desc_b, int scale_d);
''')
    parts += [ss_mn(ctype, ptx, n) for ctype, ptx, n in SS_MN]
    parts.append("}  // namespace sm90\n")
    return "\n".join(parts)


def main():
    out = Path(__file__).resolve().parent / "sm90_wgmma.cuh"
    out.write_text(render())


if __name__ == "__main__":
    main()
