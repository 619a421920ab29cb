"""Wall-clock and throughput timers.

Counterpart of ``deepspeed_tpu/utils/timer.py``
(``SynchronizedWallClockTimer``, ``ThroughputTimer``).  A ``sync`` start or
stop waits for the card (``torch.cuda.synchronize``) when CUDA is in use
in this process, and is a no-op on the CPU, where work is synchronous.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import torch

from .logging import log_dist


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class _Timer:
    def __init__(self, name: str):
        self.name = name
        self.started = False
        self._start = 0.0
        self._elapsed = 0.0
        self._records: List[float] = []

    def start(self, sync: bool = False) -> None:
        if self.started:
            raise RuntimeError(f"timer {self.name} already started")
        if sync:
            _sync()
        self._start = time.perf_counter()
        self.started = True

    def stop(self, sync: bool = False, record: bool = True) -> None:
        if not self.started:
            raise RuntimeError(f"timer {self.name} not started")
        if sync:
            _sync()
        dt = time.perf_counter() - self._start
        self._elapsed += dt
        if record:
            self._records.append(dt)
        self.started = False

    def reset(self) -> None:
        self.started = False
        self._elapsed = 0.0
        self._records = []

    def elapsed(self, reset: bool = True) -> float:
        """Total accumulated seconds; optionally reset."""
        stopped_mid = False
        if self.started:
            self.stop()
            stopped_mid = True
        out = self._elapsed
        if reset:
            self._elapsed = 0.0
        if stopped_mid:
            self.start()
        return out

    def mean(self) -> float:
        return sum(self._records) / len(self._records) if self._records else 0.0


class SynchronizedWallClockTimer:
    """Group of named timers."""

    def __init__(self):
        self.timers: Dict[str, _Timer] = {}

    def __call__(self, name: str) -> _Timer:
        if name not in self.timers:
            self.timers[name] = _Timer(name)
        return self.timers[name]

    def has(self, name: str) -> bool:
        return name in self.timers

    @staticmethod
    def memory_usage() -> str:
        if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
            return "device mem: unavailable"
        in_use = torch.cuda.memory_allocated() / (1024 ** 3)
        peak = torch.cuda.max_memory_allocated() / (1024 ** 3)
        return f"device mem: in_use={in_use:.2f}GB peak={peak:.2f}GB"

    def log(self, names: Optional[List[str]] = None, normalizer: float = 1.0,
            reset: bool = True, memory_breakdown: bool = False,
            ranks=None) -> None:
        if normalizer <= 0.0:
            raise ValueError("normalizer must be positive")
        names = names if names is not None else list(self.timers)
        parts = []
        for name in names:
            if name in self.timers:
                ms = self.timers[name].elapsed(reset=reset) * 1000.0 / normalizer
                parts.append(f"{name}: {ms:.2f}ms")
        msg = "time (ms) | " + " | ".join(parts)
        if memory_breakdown:
            msg += " | " + self.memory_usage()
        log_dist(msg, ranks=ranks)

    def get_mean(self, names: List[str], normalizer: float = 1.0) -> Dict[str, float]:
        if normalizer <= 0.0:
            raise ValueError("normalizer must be positive")
        return {n: self.timers[n].mean() * 1000.0 / normalizer
                for n in names if n in self.timers}


class ThroughputTimer:
    """Samples/sec tracking across steps (the first ``start_step`` steps
    are not counted)."""

    def __init__(self, batch_size: int, start_step: int = 2,
                 steps_per_output: Optional[int] = None,
                 monitor_memory: bool = False):
        self.batch_size = max(batch_size, 1)
        self.start_step = start_step
        self.steps_per_output = steps_per_output
        self.monitor_memory = monitor_memory
        self.enabled = True
        self.reset()

    def reset(self) -> None:
        self.global_step_count = 0
        self.total_elapsed_time = 0.0
        self.step_elapsed_time = 0.0
        self._start = 0.0

    def start(self) -> None:
        if not self.enabled:
            return
        self._start = time.perf_counter()

    def stop(self, global_step: bool = True, report_speed: bool = True) -> None:
        if not self.enabled or self._start == 0.0:
            return
        duration = time.perf_counter() - self._start
        self._start = 0.0
        self.step_elapsed_time += duration
        if not global_step:
            return
        self.global_step_count += 1
        if self.global_step_count > self.start_step:
            self.total_elapsed_time += self.step_elapsed_time
        if (report_speed and self.steps_per_output
                and self.global_step_count % self.steps_per_output == 0):
            log_dist(
                f"step={self.global_step_count}, "
                f"samples/sec={self.avg_samples_per_sec():.2f}, "
                f"step_time={self.step_elapsed_time:.3f}s")
        self.step_elapsed_time = 0.0

    def avg_samples_per_sec(self) -> float:
        counted = self.global_step_count - self.start_step
        if counted > 0 and self.total_elapsed_time > 0:
            return self.batch_size * counted / self.total_elapsed_time
        return 0.0
