"""Data loading: deterministic batches for the engine.

Counterpart of ``deepspeed_tpu/runtime/dataloader.py``: ``DataLoader``
(:21), ``PrefetchingLoader`` (:94) over the engine's ``shard_batch`` and
``synthetic_lm_data`` (:132, a copy: the same numpy ``RandomState`` stream
gives the same tokens).  The port trains on one device, so there is one
process and the loader yields whole batches.
"""

from __future__ import annotations

import collections
from typing import Any, Callable, Dict, Iterator, Optional

import numpy as np


class DataLoader:
    """Iterate epoch-shuffled batches from a dict of equal-length arrays."""

    def __init__(self, data: Dict[str, Any], batch_size: int,
                 shuffle: bool = True, seed: int = 0,
                 drop_last: bool = True,
                 batch_fn: Optional[Callable[[Dict, int], Dict]] = None,
                 sampler: Optional[Any] = None):
        self.data = {k: np.asarray(v) for k, v in data.items()}
        sizes = {k: len(v) for k, v in self.data.items()}
        if len(set(sizes.values())) != 1:
            raise ValueError(f"Mismatched field lengths: {sizes}")
        self.n = next(iter(sizes.values()))
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.batch_fn = batch_fn
        # any object with batch_indices(step) -> sample ids overrides the
        # epoch shuffle
        self.sampler = sampler
        self.epoch = 0

    def __len__(self) -> int:
        if self.drop_last:
            return self.n // self.batch_size
        return -(-self.n // self.batch_size)

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        order = None
        if self.sampler is None:
            order = np.arange(self.n)
            if self.shuffle:
                np.random.RandomState(self.seed + self.epoch).shuffle(order)
        for step in range(len(self)):
            if self.sampler is not None:
                sel = np.asarray(self.sampler.batch_indices(
                    step + self.epoch * len(self)))
            else:
                sel = order[step * self.batch_size:
                            (step + 1) * self.batch_size]
            batch = {k: v[sel] for k, v in self.data.items()}
            if self.batch_fn is not None:
                batch = self.batch_fn(batch, step)
            yield batch


class PrefetchingLoader:
    """Stage batch N+1 on the engine's device (``engine.shard_batch``: a
    pinned-host, non-blocking copy) before step N's results are read, so
    the host-to-device copy is enqueued ahead of the step that needs it.

    Usage::

        for dev_batch in PrefetchingLoader(loader, engine):
            engine.train_batch(dev_batch)
    """

    def __init__(self, loader, engine, depth: int = 2):
        self.loader = loader
        self.engine = engine
        self.depth = max(1, depth)

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        q = collections.deque()
        it = iter(self.loader)
        for batch in it:
            q.append(self.engine.shard_batch(batch))
            if len(q) >= self.depth:
                break
        while q:
            out = q.popleft()
            nxt = next(it, None)
            if nxt is not None:
                q.append(self.engine.shard_batch(nxt))
            yield out


def synthetic_lm_data(vocab_size: int, n_samples: int, seq_len: int,
                      seed: int = 0) -> Dict[str, np.ndarray]:
    """Random-token corpus for tests and benchmarks."""
    r = np.random.RandomState(seed)
    return {"input_ids": r.randint(0, vocab_size, (n_samples, seq_len))}
