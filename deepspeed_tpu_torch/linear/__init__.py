"""LoRA adapters over quantized frozen base weights (counterpart of
``deepspeed_tpu/linear``)."""

from .optimized_linear import (LoRAConfig, QuantizationConfig,
                               apply_optimized_linear, base_matmul,
                               init_optimized_linear, merge_lora,
                               quantize_base, trainable_filter)

__all__ = ["LoRAConfig", "QuantizationConfig", "init_optimized_linear",
           "apply_optimized_linear", "merge_lora", "trainable_filter",
           "quantize_base", "base_matmul"]
