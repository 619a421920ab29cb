"""Config-driven model compression (counterpart of
``deepspeed_tpu/compression``)."""

from .compress import (CompressionScheduler, TechniqueSpec,
                       activation_quantization, head_pruning,
                       init_compression, kd_loss, redundancy_clean,
                       row_pruning, sparse_pruning, student_initialization,
                       weight_quantization)

__all__ = ["CompressionScheduler", "TechniqueSpec", "init_compression",
           "redundancy_clean", "weight_quantization",
           "activation_quantization", "sparse_pruning", "row_pruning",
           "head_pruning", "student_initialization", "kd_loss"]
