"""MoQ: the mixture-of-quantization progressive training quantizer.

Counterpart of ``deepspeed_tpu/runtime/quantize.py``: the bit width
halves each period from ``q_start_bits`` to ``q_target_bits``, optionally
paced by the Hessian eigenvalue (the engine doubles the period when the
curvature grows); the quantization is the grouped fake-quant of
:mod:`..compression`.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from ..compression.compress import weight_quantization
from ..utils.logging import logger
from .runtime_utils import tree_map


class Quantizer:
    """(reference: runtime/quantize.py Quantizer — q_start_bits,
    q_target_bits, q_period, q_groups)."""

    def __init__(self, q_start_bits: int = 16, q_target_bits: int = 8,
                 q_period: int = 1000, q_groups: int = 1,
                 use_quantizer_kernel: bool = False):
        self.start_bits = q_start_bits
        # the grouped int quantizer takes 8- and 4-bit targets; other
        # targets below 16 round up to the next of those
        if q_target_bits not in (4, 8) and q_target_bits < 16:
            rounded = 4 if q_target_bits <= 4 else 8
            logger.warning(
                "MoQ target_bits=%d unsupported (int4/int8 only); "
                "using %d", q_target_bits, rounded)
            q_target_bits = rounded
        self.target_bits = q_target_bits
        self.period = q_period
        self.groups = q_groups
        self.qsteps = 0

    def current_bits(self, step: Optional[int] = None) -> int:
        step = self.qsteps if step is None else step
        bits = self.start_bits
        for _ in range(step // max(1, self.period)):
            if bits <= self.target_bits:
                break
            bits = max(self.target_bits, bits // 2)
        return bits

    def quantize(self, params: Any, step: Optional[int] = None) -> Any:
        bits = self.current_bits(step)
        self.qsteps = (step if step is not None else self.qsteps) + 1
        if bits > 8:            # above int8 there is nothing to fake-quant
            return params
        return tree_map(
            lambda w: weight_quantization(w, bits=bits, groups=self.groups)
            if isinstance(w, torch.Tensor) and w.dim() >= 1
            and w.numel() % 2 == 0 else w, params)
