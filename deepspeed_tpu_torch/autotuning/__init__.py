"""Autotuning: experiment-space search over ZeRO stage, micro-batch,
remat policy and mesh factorization (counterpart of
``deepspeed_tpu/autotuning``; reference: deepspeed/autotuning/)."""

from .autotuner import (Experiment, autotune, build_space,
                        estimate_state_bytes, evaluate,
                        mesh_factorizations, prune_by_memory)
from .tuner import GridTuner, ModelBasedTuner, RandomTuner

__all__ = [
    "Experiment", "autotune", "build_space", "estimate_state_bytes",
    "evaluate", "mesh_factorizations", "prune_by_memory",
    "GridTuner", "ModelBasedTuner", "RandomTuner",
]
