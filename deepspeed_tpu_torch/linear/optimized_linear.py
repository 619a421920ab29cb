"""OptimizedLinear: LoRA adapters over a quantized frozen base weight.

Counterpart of ``deepspeed_tpu/linear/optimized_linear.py``.  A layer is a
dict ``{base, lora_a, lora_b}``: ``base`` is frozen and stored quantized
(grouped int8/int4, or fp8 e4m3/e5m2 with per-group scales) and
dequantized on use; only the LoRA factors train.
``y = x @ W + (alpha / r) x A B``.  ``models.params_from_numpy`` carries
such nodes over from the JAX package, quantized bases included.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..ops.quant import (QuantizedTensor, default_groups, dequantize,
                         fp_quantize, quantize)
from ..platform.cuda import resolve_device
from ..utils.prng import normal, split


@dataclass
class LoRAConfig:
    """(reference: linear/config.py LoRAConfig)."""
    lora_r: int = 64
    lora_alpha: float = 16.0
    # the reference shards the frozen base over this many ranks; one
    # device shards nothing (kept for config parity)
    base_weight_sharding: int = 1


@dataclass
class QuantizationConfig:
    """(reference: linear/config.py QuantizationConfig): grouped int8 /
    int4 (``format="int"``, ``q_bits``) or fp8 (``fp8_e4m3`` /
    ``fp8_e5m2``)."""
    q_bits: int = 8
    group_size: int = 512
    format: str = "int"            # int | fp8_e4m3 | fp8_e5m2


def quantize_base(w: torch.Tensor,
                  qcfg: Optional[QuantizationConfig]) -> Any:
    if qcfg is None:
        return w
    if qcfg.format.startswith("fp8"):
        return fp_quantize(w, fmt=qcfg.format)
    return quantize(w, bits=qcfg.q_bits,
                    num_groups=default_groups(w.numel(), qcfg.group_size))


def base_matmul(x: torch.Tensor, base: Any) -> torch.Tensor:
    w = dequantize(base, x.dtype) if isinstance(
        base, QuantizedTensor) else base.to(x.dtype)
    return x @ w


def init_optimized_linear(rng: torch.Tensor, in_dim: int, out_dim: int,
                          lora: Optional[LoRAConfig] = None,
                          quant: Optional[QuantizationConfig] = None,
                          dtype=torch.float32,
                          base_weight: Optional[torch.Tensor] = None,
                          *, device=None) -> Dict[str, Any]:
    """The parameter dict, drawn from the threefry key ``rng`` as the JAX
    package draws it (``split(rng)``: the base's key, then ``lora_a``'s),
    on ``device`` (None = the card).  ``base`` is frozen (quantized when
    ``quant`` says so); ``lora_a`` / ``lora_b`` (zeros) train."""
    dev = resolve_device(device)
    k_base, k_a = split(rng)
    if base_weight is None:
        base_weight = (normal(k_base, (in_dim, out_dim))
                       * float(1.0 / np.sqrt(in_dim))).to(dtype)
    params: Dict[str, Any] = {"base": quantize_base(base_weight.to(dev),
                                                    quant)}
    if lora is not None:
        params["lora_a"] = (normal(k_a, (in_dim, lora.lora_r))
                            * float(1.0 / np.sqrt(in_dim))).to(dev, dtype)
        params["lora_b"] = torch.zeros((lora.lora_r, out_dim), dtype=dtype,
                                       device=dev)
    return params


def apply_optimized_linear(params: Dict[str, Any], x: torch.Tensor,
                           lora: Optional[LoRAConfig] = None
                           ) -> torch.Tensor:
    y = base_matmul(x, params["base"])
    if lora is not None and "lora_a" in params:
        scale = lora.lora_alpha / lora.lora_r
        y = y + scale * ((x @ params["lora_a"]) @ params["lora_b"])
    return y


def trainable_filter(params: Any, _under_base: bool = False) -> Any:
    """True for the leaves that train (the LoRA factors), False under a
    ``base`` key (the frozen, possibly quantized weight)."""
    if isinstance(params, dict):
        return {k: trainable_filter(v, _under_base or k == "base")
                for k, v in params.items()}
    return not _under_base


def merge_lora(params: Dict[str, Any], lora: LoRAConfig) -> torch.Tensor:
    """The adapters fused into one dense weight (for serving)."""
    w = dequantize(params["base"]) if isinstance(
        params["base"], QuantizedTensor) else params["base"]
    if "lora_a" in params:
        scale = lora.lora_alpha / lora.lora_r
        w = w + scale * (params["lora_a"] @ params["lora_b"])
    return w
