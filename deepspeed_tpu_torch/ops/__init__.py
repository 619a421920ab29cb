"""Kernels of the port: each a hand-written Hopper kernel beside its plain
PyTorch version (the CPU path and the reference on the card)."""

from .builder import BuildError, CUDAOpBuilder, build_all
from .flash_attention import (flash_attention, flash_dkv, flash_dkv_plain,
                              flash_dq, flash_dq_plain, flash_fwd,
                              flash_fwd_plain)
from .paged_attention import paged_attention, paged_attention_plain

__all__ = ["BuildError", "CUDAOpBuilder", "build_all", "flash_attention",
           "flash_dkv", "flash_dkv_plain", "flash_dq", "flash_dq_plain",
           "flash_fwd", "flash_fwd_plain", "paged_attention",
           "paged_attention_plain"]
