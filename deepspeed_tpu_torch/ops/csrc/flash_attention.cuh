// The C entry points of flash attention's forward, dq and dk/dv for the
// 16-bit element types (bf16, fp16), and their dispatch by head dim.
// flash_attention.cu instantiates the bf16 entry points and
// flash_attention_fp16.cu the fp16 ones (two sources, so that two nvcc
// processes build them side by side); flash_attention_fp32.cu holds the fp32
// kernels, which run on the CUDA cores.
//
// Replaces the three TPU kernels of deepspeed_tpu/ops/flash_attention.py:
//   flash_fwd  <- `_fwd_kernel` (:76, pallas_call in `_fwd` :137)
//   flash_dq   <- `_dq_kernel`  (:173, pallas_call in `_bwd` :283)
//   flash_dkv  <- `_dkv_kernel` (:212, pallas_call in `_bwd` :311)
//
// Their kernels are in flash_attention_sm90.cuh (wgmma, TMA, warp
// specialisation; see its note for the designs, their numerics and what
// bounds them): each entry point sends every instantiated head dim (32, 64,
// 80, 96, 128, 256) to the launcher of its kernel there, which picks the
// tile layout (and at D 256 dk/dv's split kernel) by D.  This file holds no
// kernel.  Layouts (all contiguous; T is the element type):
//   q, do, o, dq   [B, H,   S, D] T
//   k, v, dk, dv   [B, Hkv, S, D] T         (GQA: query head h reads KV head
//                                             h / rep, rep = H / Hkv)
//   lse, delta     [B, H,   S]    fp32      (delta = rowsum(dO * O))
// The wrapper zero-pads any other D <= 256 up to the next instantiated head
// dim.

#pragma once

#include <cuda_runtime.h>

#include <type_traits>

#include "flash_attention_sm90.cuh"

namespace flash16 {

inline bool bad_shape(int B, int H, int Hkv, int S) {
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

template <typename T>
int fwd_entry(const void* q, const void* k, const void* v, void* o, void* lse,
              int B, int H, int Hkv, int S, int D, float scale, int causal,
              void* stream) {
  if (bad_shape(B, H, Hkv, S)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)with_head_dim(D, [&](auto d) {
    constexpr int DD = decltype(d)::value;
    return causal
        ? flash90::fwd_launch<T, DD, true>(q, k, v, o, lse, B, H, Hkv, S, scale, st)
        : flash90::fwd_launch<T, DD, false>(q, k, v, o, lse, B, H, Hkv, S, scale, st);
  });
}

template <typename T>
int dq_entry(const void* q, const void* k, const void* v, const void* dout,
             const void* lse, const void* delta, void* dq, int B, int H,
             int Hkv, int S, int D, float scale, int causal, void* stream) {
  if (bad_shape(B, H, Hkv, S)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)with_head_dim(D, [&](auto d) {
    constexpr int DD = decltype(d)::value;
    return causal
        ? flash90::dq_launch<T, DD, true>(q, k, v, dout, lse, delta, dq, B, H, Hkv,
                                          S, scale, st)
        : flash90::dq_launch<T, DD, false>(q, k, v, dout, lse, delta, dq, B, H, Hkv,
                                           S, scale, st);
  });
}

template <typename T>
int dkv_entry(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dk, void* dv, int B,
              int H, int Hkv, int S, int D, float scale, int causal,
              void* stream) {
  if (bad_shape(B, H, Hkv, S)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)with_head_dim(D, [&](auto d) {
    constexpr int DD = decltype(d)::value;
    return causal
        ? flash90::dkv_launch<T, DD, true>(q, k, v, dout, lse, delta, dk, dv, B, H,
                                           Hkv, S, scale, st)
        : flash90::dkv_launch<T, DD, false>(q, k, v, dout, lse, delta, dk, dv, B, H,
                                            Hkv, S, scale, st);
  });
}

}  // namespace flash16

// The C entry points of one element type: flash_{fwd,dq,dkv}_<tag>.  Each
// returns cudaGetLastError() after its launch (0 on success); they launch on
// `stream` and do not synchronise.
#define FLASH16_ENTRY_POINTS(tag, T)                                          \
  extern "C" int flash_fwd_##tag(const void* q, const void* k, const void* v, \
                                 void* o, void* lse, int B, int H, int Hkv,   \
                                 int S, int D, float scale, int causal,       \
                                 void* stream) {                              \
    return flash16::fwd_entry<T>(q, k, v, o, lse, B, H, Hkv, S, D, scale,     \
                                 causal, stream);                             \
  }                                                                           \
  extern "C" int flash_dq_##tag(const void* q, const void* k, const void* v,  \
                                const void* dout, const void* lse,            \
                                const void* delta, void* dq, int B, int H,    \
                                int Hkv, int S, int D, float scale,           \
                                int causal, void* stream) {                   \
    return flash16::dq_entry<T>(q, k, v, dout, lse, delta, dq, B, H, Hkv, S,  \
                                D, scale, causal, stream);                    \
  }                                                                           \
  extern "C" int flash_dkv_##tag(const void* q, const void* k, const void* v, \
                                 const void* dout, const void* lse,           \
                                 const void* delta, void* dk, void* dv,       \
                                 int B, int H, int Hkv, int S, int D,         \
                                 float scale, int causal, void* stream) {     \
    return flash16::dkv_entry<T>(q, k, v, dout, lse, delta, dk, dv, B, H,     \
                                 Hkv, S, D, scale, causal, stream);           \
  }
