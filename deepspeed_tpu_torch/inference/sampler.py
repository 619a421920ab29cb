"""Token samplers (greedy / temperature / top-k / top-p) with per-row keys.

Counterpart of ``deepspeed_tpu/inference/sampler.py``.  The keys are
threefry keys of ``utils.prng``, bit for bit the JAX package's: a row
sampled at (base key, uid, position) gets the same Gumbel noise as in the
JAX engine, so seeded streams are a pure function of the key there and
here alike.  The filters follow the JAX function step for step in float32
(top-k by the k-th sorted value, top-p by the cumulative softmax over the
descending logits); a token can differ only where a sum taken in another
order lands on the other side of a top-p cut.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..utils.prng import categorical, fold_in, gumbel


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    temperature: float = 0.0          # 0 => greedy
    top_k: int = 0                    # 0 => disabled
    top_p: float = 1.0                # 1.0 => disabled
    max_new_tokens: int = 64
    stop_token: Optional[int] = None

    @property
    def sampler_key(self) -> tuple:
        """The fields that change the sampling computation
        (``stop_token``/``max_new_tokens`` are host-side loop concerns)."""
        return (self.temperature, self.top_k, self.top_p)

    @property
    def needs_rng(self) -> bool:
        return self.temperature > 0.0


def _filter(logits: torch.Tensor, params: SamplingParams) -> torch.Tensor:
    """Temperature, top-k and top-p over float32 logits [S, V], as the JAX
    ``sample`` applies them; filtered entries become -inf."""
    # a divisor made on the logits' device: true division everywhere (a
    # host scalar divisor becomes a multiply by its reciprocal on the card)
    temp = torch.full((), params.temperature, dtype=torch.float32,
                      device=logits.device)
    logits = logits / temp
    if params.top_k > 0:
        kth = torch.sort(logits, dim=-1).values[:, -params.top_k][:, None]
        logits = torch.where(logits < kth, float("-inf"), logits)
    if params.top_p < 1.0:
        sorted_logits = torch.flip(torch.sort(logits, dim=-1).values, (-1,))
        # jax.nn.softmax: exp(x - max) / sum
        e = torch.exp(sorted_logits - sorted_logits.amax(-1, keepdim=True))
        probs = e / e.sum(-1, keepdim=True)
        cum = torch.cumsum(probs, dim=-1)
        # smallest set with cumulative prob >= top_p; keep at least 1
        cutoff_idx = (cum < params.top_p).sum(-1).clamp(
            max=logits.shape[-1] - 1)
        cutoff = torch.gather(sorted_logits, -1, cutoff_idx[:, None])
        logits = torch.where(logits < cutoff, float("-inf"), logits)
    return logits


def sample(logits: torch.Tensor, params: SamplingParams,
           rng: Optional[torch.Tensor] = None) -> torch.Tensor:
    """logits [S, V] -> token ids [S] int32; one key for the whole array
    (the Gumbel noise has shape [S, V], as the JAX function draws it)."""
    if params.temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    if rng is None:
        raise ValueError("temperature sampling requires an rng key "
                         "(the engine supplies one automatically)")
    return categorical(rng, _filter(logits.float(), params)).to(torch.int32)


def row_keys(rng: torch.Tensor, uids: torch.Tensor,
             context_lens: torch.Tensor) -> torch.Tensor:
    """[max_seqs, 2] per-row sampling keys: ``fold_in(fold_in(rng, uid),
    position)`` where position is the sampled token's index in its
    sequence (= context length after the step).  ``uids`` holds each
    row's uid as uint32 bits in any integer dtype.  A sequence's sampled
    randomness is then a pure function of (base key, uid, position):
    invariant to pipeline depth, chunking and prefix-cache hits."""
    return fold_in(fold_in(rng.to(uids.device), uids), context_lens)


def window_keys(rng: torch.Tensor, uids: torch.Tensor,
                positions: torch.Tensor) -> torch.Tensor:
    """[S, W, 2] keys of a speculative verify window: ``fold_in(fold_in(
    rng, uid), position)`` at every post-token position ``positions[s,
    j]`` — exactly :func:`row_keys`' fold at each drafted position."""
    return fold_in(fold_in(rng.to(uids.device), uids)[:, None, :],
                   positions)


def sample_rows(logits: torch.Tensor, params: SamplingParams,
                keys: Optional[torch.Tensor] = None) -> torch.Tensor:
    """logits [S, V] + per-row keys [S, 2] -> token ids [S] int32.

    Greedy ignores ``keys``.  Otherwise each row samples as the JAX
    package's ``vmap`` of :func:`sample` over rows: row s draws Gumbel
    noise of shape [1, V] from its own key.  The rows share one batched
    draw here (counter j of row s is column j under key s, the same bits
    as S separate draws)."""
    if params.temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    if keys is None:
        raise ValueError("temperature sampling requires per-row keys "
                         "(the engine supplies them automatically)")
    filtered = _filter(logits.float(), params)
    noise = gumbel(keys.to(logits.device), (logits.shape[-1],))   # [S, V]
    return torch.argmax(noise + filtered, dim=-1).to(torch.int32)
