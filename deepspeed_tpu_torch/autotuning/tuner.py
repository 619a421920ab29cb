"""Tuner strategies: grid, random, model-based.

Counterpart of ``deepspeed_tpu/autotuning/tuner.py``, copied (numpy and
the standard library only).  Reference:
``autotuning/tuner/index_based_tuner.py:11,27`` (GridSearch /
RandomTuner over the experiment list) and
``tuner/model_based_tuner.py:19`` + ``cost_model.py:14`` (XGBoost cost
model ranking unmeasured experiments).  Same staged flow here; the cost
model is a numpy ridge regression over step-time features (XGBoost isn't
in the image, and the feature design carries the value)."""

from __future__ import annotations

import random
from typing import Callable, List

import numpy as np

from .autotuner import Experiment


class BaseTuner:
    def __init__(self, space: List[Experiment],
                 run: Callable[[Experiment], Experiment]):
        self.space = list(space)
        self.run = run

    def tune(self, budget: int) -> List[Experiment]:
        raise NotImplementedError


class GridTuner(BaseTuner):
    """Measure the space in order until the budget is exhausted
    (reference: GridSearchTuner)."""

    def tune(self, budget: int) -> List[Experiment]:
        todo = self.space[:budget]
        return [self.run(e) for e in todo]


class RandomTuner(BaseTuner):
    """Uniformly sample the space (reference: RandomTuner)."""

    def __init__(self, space, run, seed: int = 0):
        super().__init__(space, run)
        self.rng = random.Random(seed)

    def tune(self, budget: int) -> List[Experiment]:
        todo = self.space[:]
        self.rng.shuffle(todo)
        return [self.run(e) for e in todo[:budget]]


def _features(e: Experiment) -> np.ndarray:
    o = e.overrides
    mesh = o["mesh"]
    from .autotuner import REMAT_CHOICES
    remat = o.get("remat_policy", "nothing")
    remat_idx = (REMAT_CHOICES.index(remat)
                 if remat in REMAT_CHOICES else len(REMAT_CHOICES))
    return np.array([
        1.0,
        float(o["zero_stage"]),
        np.log2(max(o["micro_batch"], 1)),
        float(remat_idx),
        np.log2(max(mesh.get("data", 1), 1)),
        np.log2(max(mesh.get("fsdp", 1), 1)),
        np.log2(max(mesh.get("tensor", 1), 1)),
    ])


class ModelBasedTuner(BaseTuner):
    """Seed-measure a diverse subset, fit a ridge cost model on step
    time, then spend the rest of the budget on the predicted-fastest
    candidates (reference: ModelBasedTuner.find_estimated_top_configs
    model_based_tuner.py)."""

    def __init__(self, space, run, seed_fraction: float = 0.4,
                 ridge: float = 1e-3, seed: int = 0):
        super().__init__(space, run)
        self.seed_fraction = seed_fraction
        self.ridge = ridge
        self.rng = random.Random(seed)

    def tune(self, budget: int) -> List[Experiment]:
        budget = min(budget, len(self.space))
        n_seed = min(budget, max(2, int(budget * self.seed_fraction)))
        todo = self.space[:]
        self.rng.shuffle(todo)
        measured = [self.run(e) for e in todo[:n_seed]]
        remaining = todo[n_seed:]
        left = budget - n_seed
        good = [e for e in measured if e.ok]
        if left > 0 and remaining:
            if len(good) >= 2:
                X = np.stack([_features(e) for e in good])
                y = np.log(np.array([e.step_time_s for e in good]))
                A = X.T @ X + self.ridge * np.eye(X.shape[1])
                w = np.linalg.solve(A, X.T @ y)
                preds = [(float(_features(e) @ w), e) for e in remaining]
                preds.sort(key=lambda p: p[0])
                chosen = [e for _, e in preds[:left]]
            else:       # not enough signal to fit — fall back to random
                chosen = remaining[:left]
            measured += [self.run(e) for e in chosen]
        return measured
