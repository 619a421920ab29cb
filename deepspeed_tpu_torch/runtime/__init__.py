"""Training runtime of the port: one-device engine, optimizers, schedules,
loss scaling and data loading (counterpart of ``deepspeed_tpu/runtime``)."""

from .dataloader import DataLoader, PrefetchingLoader, synthetic_lm_data
from .engine import Engine, TrainState, initialize
from .loss_scaler import LossScaler, LossScaleState, all_finite
from .lr_schedules import build_schedule
from .optimizers import Optimizer, build_optimizer
from .runtime_utils import clip_by_global_norm, global_norm, param_count

__all__ = ["DataLoader", "Engine", "LossScaleState", "LossScaler",
           "Optimizer", "PrefetchingLoader", "TrainState", "all_finite",
           "build_optimizer", "build_schedule", "clip_by_global_norm",
           "global_norm", "initialize", "param_count", "synthetic_lm_data"]
