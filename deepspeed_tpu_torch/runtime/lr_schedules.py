"""Learning-rate schedules as plain ``step -> lr`` functions.

Counterpart of ``deepspeed_tpu/runtime/lr_schedules.py``: the same five
schedules plus ``Constant`` and ``build_schedule`` (:127).  The JAX
package traces them into the step in float32; here they are Python
functions of a float step, evaluated on the host (float64), so the step
needs no device scalar.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict

Schedule = Callable[[float], float]


def _clip(x: float, lo: float, hi: float) -> float:
    return min(max(x, lo), hi)


def constant(lr: float) -> Schedule:
    def f(step):
        return float(lr)
    return f


def lr_range_test(lr_range_test_min_lr: float = 1e-3,
                  lr_range_test_step_size: int = 2000,
                  lr_range_test_step_rate: float = 1.0,
                  lr_range_test_staircase: bool = False) -> Schedule:
    def f(step):
        x = step / lr_range_test_step_size
        if lr_range_test_staircase:
            x = math.floor(x)
        return lr_range_test_min_lr * (1.0 + x * lr_range_test_step_rate)
    return f


def one_cycle(cycle_min_lr: float, cycle_max_lr: float,
              cycle_first_step_size: int = 2000,
              cycle_second_step_size: int | None = None,
              decay_step_size: int = 0,
              decay_lr_rate: float = 0.0) -> Schedule:
    up = float(cycle_first_step_size)
    down = float(cycle_second_step_size if cycle_second_step_size else up)
    total = up + down

    def f(step):
        if step <= up:
            tri = cycle_min_lr + (cycle_max_lr - cycle_min_lr) * _clip(
                step / up, 0.0, 1.0)
        else:
            tri = cycle_max_lr - (cycle_max_lr - cycle_min_lr) * _clip(
                (step - up) / down, 0.0, 1.0)
        if decay_step_size > 0 and step > total:
            post = max(step - total, 0.0) / decay_step_size
            tri = cycle_min_lr / (1.0 + post * decay_lr_rate)
        return max(tri, 0.0)
    return f


def _warmup_factor(step: float, warmup_num_steps: int,
                   warmup_type: str) -> float:
    w = max(float(warmup_num_steps), 1.0)
    if warmup_type == "log":
        return 1.0 if step >= w else math.log1p(step) / math.log1p(w)
    return _clip(step / w, 0.0, 1.0)


def warmup_lr(warmup_min_lr: float = 0.0, warmup_max_lr: float = 0.001,
              warmup_num_steps: int = 1000,
              warmup_type: str = "log") -> Schedule:
    def f(step):
        fac = _warmup_factor(step, warmup_num_steps, warmup_type)
        return warmup_min_lr + (warmup_max_lr - warmup_min_lr) * fac
    return f


def warmup_decay_lr(total_num_steps: int, warmup_min_lr: float = 0.0,
                    warmup_max_lr: float = 0.001, warmup_num_steps: int = 1000,
                    warmup_type: str = "log") -> Schedule:
    def f(step):
        if step <= warmup_num_steps:
            fac = _warmup_factor(step, warmup_num_steps, warmup_type)
            return warmup_min_lr + (warmup_max_lr - warmup_min_lr) * fac
        decay = _clip((total_num_steps - step) / max(
            float(total_num_steps - warmup_num_steps), 1.0), 0.0, 1.0)
        return warmup_max_lr * decay
    return f


def warmup_cosine_lr(total_num_steps: int, warmup_min_ratio: float = 0.0,
                     warmup_num_steps: int = 1000, cos_min_ratio: float = 1e-4,
                     warmup_type: str = "linear", lr: float = 1.0) -> Schedule:
    def f(step):
        if step < warmup_num_steps:
            fac = _warmup_factor(step, warmup_num_steps, warmup_type)
            return lr * (warmup_min_ratio + (1.0 - warmup_min_ratio) * fac)
        progress = _clip((step - warmup_num_steps) / max(
            float(total_num_steps - warmup_num_steps), 1.0), 0.0, 1.0)
        return lr * (cos_min_ratio + (1.0 - cos_min_ratio) * 0.5 * (
            1.0 + math.cos(math.pi * progress)))
    return f


SCHEDULES: Dict[str, Callable[..., Schedule]] = {
    "LRRangeTest": lr_range_test,
    "OneCycle": one_cycle,
    "WarmupLR": warmup_lr,
    "WarmupDecayLR": warmup_decay_lr,
    "WarmupCosineLR": warmup_cosine_lr,
    "Constant": constant,
}


def build_schedule(name: str, params: Dict[str, Any] | None = None) -> Schedule:
    if name not in SCHEDULES:
        raise ValueError(f"Unknown scheduler {name!r}; known: {sorted(SCHEDULES)}")
    return SCHEDULES[name](**(params or {}))
