"""Offline map-reduce data analyzer for curriculum learning.

Counterpart of ``deepspeed_tpu/runtime/data_analyzer.py`` (host code,
copied): per-sample metric functions run over a (possibly mmap-backed)
corpus in worker shards (*map*), then the shards merge into per-metric
files (*reduce*):

* ``<metric>/sample_to_metric.npy`` — ``[N]`` metric value per sample;
* ``<metric>/metric_sorted_samples.npy`` — sample ids sorted ascending by
  metric (+ ``metric_sorted_values.npy``), the index the curriculum
  consumes through :func:`samples_up_to_difficulty` /
  :func:`difficulty_buckets`.

The files are those of the JAX package: either package reads the
other's.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict

import numpy as np


class DataAnalyzer:
    def __init__(self, dataset, metric_functions: Dict[str, Callable],
                 save_path: str, num_workers: int = 1, worker_id: int = 0,
                 batch_size: int = 1024):
        self.dataset = dataset
        self.metric_functions = dict(metric_functions)
        self.save_path = save_path
        self.num_workers = num_workers
        self.worker_id = worker_id
        self.batch_size = batch_size
        os.makedirs(save_path, exist_ok=True)

    # ---------------------------------------------------------------- map
    def _shard_range(self):
        n = len(self.dataset)
        per = -(-n // self.num_workers)
        lo = min(n, self.worker_id * per)      # late workers: empty shard
        return lo, min(n, lo + per)

    def _worker_file(self, metric: str, worker: int) -> str:
        return os.path.join(self.save_path,
                            f"{metric}.worker{worker}.npy")

    def run_map(self) -> None:
        """Compute every metric over this worker's contiguous shard and
        save ``(lo, values)``."""
        lo, hi = self._shard_range()
        vals = {m: np.empty(hi - lo, np.float64)
                for m in self.metric_functions}
        for i in range(lo, hi):
            sample = self.dataset[i]
            for m, fn in self.metric_functions.items():
                vals[m][i - lo] = float(fn(sample))
        for m, v in vals.items():
            np.save(self._worker_file(m, self.worker_id),
                    {"lo": lo, "values": v}, allow_pickle=True)

    # ------------------------------------------------------------- reduce
    def run_reduce(self) -> None:
        """Merge all workers' shards into the per-metric index files."""
        n = len(self.dataset)
        for m in self.metric_functions:
            full = np.full(n, np.nan)
            for w in range(self.num_workers):
                d = np.load(self._worker_file(m, w),
                            allow_pickle=True).item()
                full[d["lo"]:d["lo"] + len(d["values"])] = d["values"]
            if np.isnan(full).any():
                raise RuntimeError(
                    f"metric {m!r}: missing worker shards "
                    f"({int(np.isnan(full).sum())} samples uncovered)")
            mdir = os.path.join(self.save_path, m)
            os.makedirs(mdir, exist_ok=True)
            np.save(os.path.join(mdir, "sample_to_metric.npy"), full)
            order = np.argsort(full, kind="stable")
            np.save(os.path.join(mdir, "metric_sorted_samples.npy"), order)
            np.save(os.path.join(mdir, "metric_sorted_values.npy"),
                    full[order])
            with open(os.path.join(mdir, "summary.json"), "w") as f:
                json.dump({"num_samples": int(n),
                           "min": float(full.min()),
                           "max": float(full.max()),
                           "mean": float(full.mean())}, f)

    def run(self) -> None:
        """Single-process convenience: map + reduce."""
        if self.num_workers != 1 or self.worker_id != 0:
            raise ValueError("run() is the single-worker path; use "
                             "run_map() per worker then run_reduce()")
        self.run_map()
        self.run_reduce()


# ----------------------------------------------------------- consumption

def load_metric(save_path: str, metric: str) -> Dict[str, np.ndarray]:
    mdir = os.path.join(save_path, metric)
    return {
        "sample_to_metric": np.load(
            os.path.join(mdir, "sample_to_metric.npy"), mmap_mode="r"),
        "sorted_samples": np.load(
            os.path.join(mdir, "metric_sorted_samples.npy"), mmap_mode="r"),
        "sorted_values": np.load(
            os.path.join(mdir, "metric_sorted_values.npy"), mmap_mode="r"),
    }


def samples_up_to_difficulty(save_path: str, metric: str,
                             max_value: float) -> np.ndarray:
    """Sample ids whose metric <= max_value: the curriculum's per-step
    candidate pool."""
    idx = load_metric(save_path, metric)
    k = int(np.searchsorted(idx["sorted_values"], max_value, side="right"))
    return np.asarray(idx["sorted_samples"][:k])


def difficulty_buckets(save_path: str, metric: str,
                       num_buckets: int) -> list:
    """Equal-count buckets of sample ids, easiest first."""
    idx = load_metric(save_path, metric)
    return [np.asarray(b) for b in
            np.array_split(np.asarray(idx["sorted_samples"]), num_buckets)]
