"""Kernels of the port: each a hand-written Hopper kernel beside its plain
PyTorch version (the CPU path and the reference on the card)."""

from .builder import BuildError, CUDAOpBuilder, build_all
from .paged_attention import paged_attention, paged_attention_plain

__all__ = ["BuildError", "CUDAOpBuilder", "build_all", "paged_attention",
           "paged_attention_plain"]
