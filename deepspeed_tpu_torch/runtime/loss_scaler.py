"""Dynamic loss scaling.

Counterpart of ``deepspeed_tpu/runtime/loss_scaler.py`` (``LossScaler``
:28, ``LossScaleState``, ``all_finite`` :91).  The state is three host
numbers: the port's training step reads the overflow flag on the host
once per fp16 step and skips the update there, where the JAX step selects
with ``jnp.where`` inside one compiled program.  bf16 and fp32 training
never read it (the scaler is static and the flag is not computed).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from .runtime_utils import tree_leaves


class LossScaleState(NamedTuple):
    scale: float               # current loss scale
    good_steps: int            # consecutive non-overflow steps
    hysteresis: int            # remaining overflow tolerance


class LossScaler(NamedTuple):
    """Static config; the state travels through the step."""
    dynamic: bool
    init_scale: float
    scale_window: int
    scale_factor: float
    min_scale: float
    max_hysteresis: int
    consecutive_hysteresis: bool

    @classmethod
    def from_config(cls, fp16_cfg) -> "LossScaler":
        if not fp16_cfg.enabled:
            return cls(dynamic=False, init_scale=1.0, scale_window=1000,
                       scale_factor=2.0, min_scale=1.0, max_hysteresis=2,
                       consecutive_hysteresis=False)
        if fp16_cfg.dynamic_loss_scale:
            return cls(dynamic=True,
                       init_scale=float(2.0 ** fp16_cfg.initial_scale_power),
                       scale_window=fp16_cfg.loss_scale_window,
                       scale_factor=2.0,
                       min_scale=fp16_cfg.min_loss_scale,
                       max_hysteresis=fp16_cfg.hysteresis,
                       consecutive_hysteresis=fp16_cfg.consecutive_hysteresis)
        return cls(dynamic=False, init_scale=float(fp16_cfg.loss_scale),
                   scale_window=1000, scale_factor=2.0, min_scale=1.0,
                   max_hysteresis=2, consecutive_hysteresis=False)

    def init(self) -> LossScaleState:
        return LossScaleState(scale=float(self.init_scale), good_steps=0,
                              hysteresis=int(self.max_hysteresis))

    def update(self, state: LossScaleState, overflow: bool) -> LossScaleState:
        """Advance the state given this step's overflow flag."""
        if not self.dynamic:
            return state
        overflow = bool(overflow)
        # overflow: drop the scale once hysteresis is spent, else spend one
        drop = overflow and state.hysteresis <= 1
        hyst = (state.hysteresis - 1 if overflow and state.hysteresis > 1
                else state.hysteresis)
        scale = (max(state.scale / self.scale_factor, self.min_scale)
                 if drop else state.scale)
        good = 0 if overflow else state.good_steps + 1
        grow = (not overflow) and good >= self.scale_window
        if grow:
            scale = scale * self.scale_factor
            good = 0
        # consecutive_hysteresis refills on every good step; otherwise only
        # when the scale grows
        if self.consecutive_hysteresis:
            hyst = self.max_hysteresis if not overflow else hyst
        elif grow:
            hyst = self.max_hysteresis
        return LossScaleState(scale=float(scale), good_steps=int(good),
                              hysteresis=int(hyst))


def all_finite(tree: Any) -> torch.Tensor:
    """One bool tensor: every element of every leaf is finite."""
    leaves = tree_leaves(tree)
    if not leaves:
        return torch.tensor(True)
    return torch.stack([torch.isfinite(x).all() for x in leaves]).all()
