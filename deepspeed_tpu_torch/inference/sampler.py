"""Token sampling: greedy only, for now.

Counterpart of ``deepspeed_tpu/inference/sampler.py``.  Seeded
(temperature > 0) sampling in the JAX package folds a base key by
(uid, position) with threefry (``row_keys``), so its streams are a pure
function of the key; matching them needs jax's threefry ``fold_in`` and
its bits-to-Gumbel path reproduced bit for bit in PyTorch.  That is a
later item (ROADMAP Queue 1, seeded sampling); until then a temperature
above 0 raises instead of sampling differently.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    temperature: float = 0.0          # 0 => greedy (the only mode ported)
    top_k: int = 0                    # 0 => disabled
    top_p: float = 1.0                # 1.0 => disabled
    max_new_tokens: int = 64
    stop_token: Optional[int] = None

    def __post_init__(self):
        if self.temperature > 0.0:
            raise NotImplementedError(
                "temperature > 0 is not ported yet: seeded sampling needs "
                "the JAX package's threefry fold_in keys reproduced bit "
                "for bit (ROADMAP Queue 1, seeded sampling)")

    @property
    def needs_rng(self) -> bool:
        return self.temperature > 0.0


def sample_rows(logits: torch.Tensor, params: SamplingParams) -> torch.Tensor:
    """logits [S, V] -> token ids [S] int32 (greedy: first maximum, as
    ``jnp.argmax``)."""
    if params.temperature > 0.0:
        raise NotImplementedError("temperature > 0 is not ported yet")
    return torch.argmax(logits, dim=-1).to(torch.int32)
