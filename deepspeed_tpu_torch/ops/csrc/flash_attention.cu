// Flash attention forward, dq and dk/dv in bf16 for Hopper (sm_90a): the C
// entry points flash_fwd_bf16, flash_dq_bf16 and flash_dkv_bf16 over the
// templated tensor-core kernels of flash_attention.cuh (see the note at its
// top for what they replace, their numerics, design and bounds).
//
// Supported: D in {32, 64, 80, 96, 128, 256}, any S >= 1, H % Hkv == 0.

#include "flash_attention.cuh"

FLASH16_ENTRY_POINTS(bf16, __nv_bfloat16)
