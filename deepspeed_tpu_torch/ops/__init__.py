"""Kernels of the port: each a hand-written Hopper kernel beside its plain
PyTorch version (the CPU path and the reference on the card)."""

from . import flash_attention as _flash_attention
from . import mixed_gemm as _mixed_gemm
from . import paged_attention as _paged_attention
from .builder import BuildError, CUDAOpBuilder, build_all
from .flash_attention import (flash_attention, flash_dkv, flash_dkv_plain,
                              flash_dq, flash_dq_plain, flash_fwd,
                              flash_fwd_plain)
from .mixed_gemm import (mixed4_matmul_2d, mixed4_matmul_2d_plain,
                         mixed_matmul, mixed_matmul_2d,
                         mixed_matmul_2d_plain)
from .paged_attention import paged_attention, paged_attention_plain

# every kernel library of the port (one nvcc each; build_all starts them
# together)
BUILDERS = [_paged_attention.BUILDER, *_flash_attention.BUILDERS,
            _mixed_gemm.BUILDER]

__all__ = ["BUILDERS", "BuildError", "CUDAOpBuilder", "build_all",
           "flash_attention", "flash_dkv", "flash_dkv_plain", "flash_dq",
           "flash_dq_plain", "flash_fwd", "flash_fwd_plain",
           "mixed4_matmul_2d", "mixed4_matmul_2d_plain", "mixed_matmul",
           "mixed_matmul_2d", "mixed_matmul_2d_plain", "paged_attention",
           "paged_attention_plain"]
