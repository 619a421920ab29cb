"""Data efficiency: curriculum learning, difficulty sampling, random-LTD.

Counterpart of ``deepspeed_tpu/runtime/data_pipeline.py``: the
curriculum scheduler (fixed_linear / fixed_root / fixed_discrete /
custom), seqlen truncation, the difficulty-indexed sampler, the small
in-memory analyzer, the random-LTD schedule, and the random-LTD token
selection and scatter.  The selection draws its noise with the JAX
package's threefry key (``utils.prng.uniform``) and sorts it with a
stable argsort, as ``jnp.argsort`` does, so one key gives the same kept
positions in both packages, bit for bit.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.prng import uniform


# --------------------------------------------------------------------------
# curriculum scheduler
# --------------------------------------------------------------------------

class CurriculumScheduler:
    """difficulty(step): min_difficulty -> max_difficulty.

    schedule_type: fixed_linear | fixed_root | fixed_discrete | custom.
    """

    def __init__(self, config: Dict):
        self.min = int(config["min_difficulty"])
        self.max = int(config["max_difficulty"])
        self.type = config["schedule_type"]
        cfg = config.get("schedule_config", {})
        self.cfg = cfg
        self.custom_fn: Optional[Callable[[int], int]] = config.get(
            "custom_fn")
        if self.type in ("fixed_linear", "fixed_root"):
            self.total_step = int(cfg["total_curriculum_step"])
            self.diff_step = int(cfg.get("difficulty_step", 1))
            self.root = float(cfg.get("root_degree",
                                      1 if self.type == "fixed_linear"
                                      else 2))
        elif self.type == "fixed_discrete":
            self.difficulties: List[int] = list(cfg["difficulty"])
            self.max_steps: List[int] = list(cfg["max_step"])
            if len(self.difficulties) != len(self.max_steps) + 1:
                raise ValueError("fixed_discrete needs one more difficulty "
                                 "than max_step entries")
        elif self.type == "custom":
            if self.custom_fn is None:
                raise ValueError("a custom schedule needs custom_fn")
        else:
            raise ValueError(f"unknown schedule_type {self.type!r}")

    def get_difficulty(self, step: int) -> int:
        if self.type == "custom":
            return int(self.custom_fn(step))
        if self.type == "fixed_discrete":
            for d, s in zip(self.difficulties, self.max_steps):
                if step <= s:
                    return d
            return self.difficulties[-1]
        frac = min(1.0, max(step, 1) / self.total_step) ** (1.0 / self.root)
        diff = self.min + (self.max - self.min) * frac
        diff = int(diff // self.diff_step) * self.diff_step
        return int(min(self.max, max(self.min, diff)))

    update_difficulty = get_difficulty


def truncate_to_difficulty(batch: Dict[str, Any], difficulty: int,
                           seq_keys: Sequence[str] = ("input_ids", "labels",
                                                      "attention_mask"),
                           pad_to: Optional[int] = None) -> Dict[str, Any]:
    """Seqlen curriculum: truncate the sequence keys to the current
    difficulty (``pad_to`` right-pads back to a fixed length)."""
    out = dict(batch)
    for k in seq_keys:
        if k in out and np.ndim(out[k]) >= 2:
            v = out[k][:, :difficulty]
            if pad_to and pad_to > difficulty:
                pad = [(0, 0), (0, pad_to - difficulty)] + \
                    [(0, 0)] * (np.ndim(v) - 2)
                v = np.pad(np.asarray(v), pad)
            out[k] = v
    return out


# --------------------------------------------------------------------------
# difficulty-indexed sampler
# --------------------------------------------------------------------------

class CurriculumDataSampler:
    """Sample indices whose difficulty metric is within the scheduler's
    current bound (a sorted-metric cursor)."""

    def __init__(self, metric_values: Sequence[float],
                 scheduler: CurriculumScheduler,
                 batch_size: int, seed: int = 0):
        self.metric = np.asarray(metric_values)
        self.order = np.argsort(self.metric, kind="stable")
        self.sched = scheduler
        self.batch_size = batch_size
        self.seed = seed

    @classmethod
    def from_analyzer(cls, save_path: str, metric: str,
                      scheduler: CurriculumScheduler, batch_size: int,
                      seed: int = 0) -> "CurriculumDataSampler":
        """From an offline :class:`~.data_analyzer.DataAnalyzer` save
        directory."""
        from .data_analyzer import load_metric
        idx = load_metric(save_path, metric)
        return cls(np.asarray(idx["sample_to_metric"]), scheduler,
                   batch_size, seed=seed)

    def batch_indices(self, step: int) -> np.ndarray:
        """Stateless in ``step``: the same (seed, step) always gives the
        same batch (epoch replay and resume reproduce the data order)."""
        difficulty = self.sched.get_difficulty(step)
        eligible_n = int(np.searchsorted(
            self.metric[self.order], difficulty, side="right"))
        eligible = self.order[:max(eligible_n, self.batch_size)]
        rng = np.random.RandomState(self.seed + step)
        return rng.choice(eligible, size=self.batch_size,
                          replace=len(eligible) < self.batch_size)


class DataAnalyzer:
    """Single-metric, in-memory analyzer; the map-reduce one over large
    corpora is :class:`~.data_analyzer.DataAnalyzer`."""

    def __init__(self, metric_fn: Callable[[Any], float]):
        self.metric_fn = metric_fn

    def run(self, samples: Sequence[Any],
            save_path: Optional[str] = None) -> np.ndarray:
        vals = np.asarray([self.metric_fn(s) for s in samples], np.float32)
        if save_path:
            np.save(save_path, vals)
        return vals


# --------------------------------------------------------------------------
# random-LTD
# --------------------------------------------------------------------------

class RandomLTDScheduler:
    """Kept-token count: a linear rise from ``start_tokens`` to
    ``max_tokens`` over ``schedule_steps``, in multiples of
    ``step_size``."""

    def __init__(self, total_layers: int, start_tokens: int,
                 max_tokens: int, schedule_steps: int,
                 step_size: int = 16):
        self.total_layers = total_layers
        self.start = start_tokens
        self.max = max_tokens
        self.steps = schedule_steps
        self.step_size = step_size

    def kept_tokens(self, step: int) -> int:
        frac = min(1.0, step / max(1, self.steps))
        k = self.start + (self.max - self.start) * frac
        k = int(k // self.step_size) * self.step_size
        return int(min(self.max, max(self.start, k)))


def _expand(idx: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    B, keep = idx.shape
    return idx.reshape(B, keep, *(1,) * (x.dim() - 2)).expand(
        B, keep, *x.shape[2:])


def random_ltd_select(x: torch.Tensor, keep: int, rng: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sample ``keep`` token positions per batch row (sorted, so the
    causal order survives) and gather them: (gathered [B, keep, ...],
    idx [B, keep] on ``x``'s device).  The noise is drawn on the key's
    device (the host in training) and sorted stably, as ``jnp.argsort``
    sorts."""
    noise = uniform(rng, (x.shape[0], x.shape[1]))
    idx = torch.argsort(noise, dim=1, stable=True)[:, :keep]
    idx = torch.sort(idx, dim=1).values.to(x.device, non_blocking=True)
    return torch.gather(x, 1, _expand(idx, x)), idx


def random_ltd_scatter(full: torch.Tensor, processed: torch.Tensor,
                       idx: torch.Tensor) -> torch.Tensor:
    """Scatter the processed tokens back into the full sequence; dropped
    positions keep their input value (differentiable in both)."""
    return full.scatter(1, _expand(idx, full), processed)
