// Flash attention forward, dq and dk/dv in fp16 for Hopper (sm_90a): the C
// entry points flash_fwd_fp16, flash_dq_fp16 and flash_dkv_fp16 over the
// tensor-core kernels of flash_attention_sm90.cuh, dispatched by head dim in
// flash_attention.cuh (see the notes at their tops for what they replace,
// their numerics, design and bounds).  A source of its own, so that nvcc
// builds it beside the bf16 one.
//
// Supported: D in {32, 64, 80, 96, 128, 256}, any S >= 1, H % Hkv == 0.

#include "flash_attention.cuh"

FLASH16_ENTRY_POINTS(fp16, __half)
