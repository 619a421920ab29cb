"""Block-sparse attention: the sparsity layouts and a static-gather form.

Counterpart of ``deepspeed_tpu/ops/sparse_attention.py``, which runs on
plain XLA ops (no Pallas kernel).  The five layout classes are copied
from it (numpy only; BigBird's random blocks from the same
``RandomState(seed)`` draw, so the layouts are equal as arrays).  The
layout is static: each q-block's active k-blocks become a gather index,
and the whole computation is dense products over ``[.., nQ, A, block,
block]`` (A = the most active blocks of any row), causal inside the
diagonal blocks, the softmax in fp32.  Work and memory scale with the
active blocks.  Autograd gives the gradients; the gathered key and value
blocks' are summed in fp32 (the JAX package's gather transposes to a
scatter-add in the inputs' dtype: the same in fp32, one rounding a
partial in bf16).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

NEG_INF = -1e30


# --------------------------------------------------------------------------
# layouts (the JAX package's :55-150)
# --------------------------------------------------------------------------

@dataclasses.dataclass
class SparsityConfig:
    block: int = 16

    def make_layout(self, num_blocks: int) -> np.ndarray:
        """[nQ, nK] bool, lower-triangular (causal) at block level."""
        raise NotImplementedError

    def _causal(self, layout: np.ndarray) -> np.ndarray:
        return np.tril(layout)


@dataclasses.dataclass
class DenseSparsityConfig(SparsityConfig):
    def make_layout(self, num_blocks: int) -> np.ndarray:
        return self._causal(np.ones((num_blocks, num_blocks), bool))


@dataclasses.dataclass
class FixedSparsityConfig(SparsityConfig):
    num_local_blocks: int = 4
    num_global_blocks: int = 1

    def make_layout(self, n: int) -> np.ndarray:
        lay = np.zeros((n, n), bool)
        L = self.num_local_blocks
        for q in range(n):
            w0 = (q // L) * L
            lay[q, w0:q + 1] = True                 # local window
            # the last num_global_blocks of every earlier window are global
            for base in range(0, w0, L):
                lo = base + L - self.num_global_blocks
                lay[q, max(base, lo):base + L] = True
        return self._causal(lay)


@dataclasses.dataclass
class BSLongformerSparsityConfig(SparsityConfig):
    num_sliding_window_blocks: int = 3
    global_block_indices: Sequence[int] = (0,)

    def make_layout(self, n: int) -> np.ndarray:
        lay = np.zeros((n, n), bool)
        w = self.num_sliding_window_blocks
        for q in range(n):
            lay[q, max(0, q - w + 1):q + 1] = True
        for g in self.global_block_indices:
            if g < n:
                lay[:, g] = True                    # everyone sees global
                lay[g, :] = True                    # global sees everyone
        return self._causal(lay)


@dataclasses.dataclass
class BigBirdSparsityConfig(SparsityConfig):
    num_random_blocks: int = 1
    num_sliding_window_blocks: int = 3
    num_global_blocks: int = 1
    seed: int = 0

    def make_layout(self, n: int) -> np.ndarray:
        lay = np.zeros((n, n), bool)
        w = self.num_sliding_window_blocks
        r = np.random.RandomState(self.seed)
        for q in range(n):
            lay[q, max(0, q - w + 1):q + 1] = True
            if q > 0 and self.num_random_blocks:
                pick = r.choice(q, min(self.num_random_blocks, q),
                                replace=False)
                lay[q, pick] = True
        g = self.num_global_blocks
        lay[:, :g] = True
        lay[:g, :] = True
        return self._causal(lay)


@dataclasses.dataclass
class VariableSparsityConfig(SparsityConfig):
    num_local_blocks: int = 4
    global_block_indices: Sequence[int] = (0,)

    def make_layout(self, n: int) -> np.ndarray:
        lay = np.zeros((n, n), bool)
        L = self.num_local_blocks
        for q in range(n):
            lay[q, max(0, q - L + 1):q + 1] = True
        for g in self.global_block_indices:
            if g < n:
                lay[:, g] = True
                lay[g, :] = True
        return self._causal(lay)


# --------------------------------------------------------------------------
# the static-gather attention
# --------------------------------------------------------------------------

def gather_plan(layout: np.ndarray, block: int
                ) -> Tuple[np.ndarray, np.ndarray]:
    """(idx [n, A] int64: each q-block's active k-blocks, padded with 0;
    keep [n, block, A, block] bool: causal and active)."""
    n = layout.shape[0]
    rows = [np.flatnonzero(layout[i]) for i in range(n)]
    A = max(1, max(len(r) for r in rows))
    idx = np.zeros((n, A), np.int64)
    act = np.zeros((n, A), bool)
    for i, r in enumerate(rows):
        idx[i, :len(r)] = r
        act[i, :len(r)] = True
    grow = np.arange(n)[:, None] * block + np.arange(block)[None, :]
    gcol = idx[:, :, None] * block + np.arange(block)[None, None, :]
    keep = ((gcol[:, None, :, :] <= grow[:, :, None, None])
            & act[:, None, :, None])
    return idx, keep


class _GatherBlocks(torch.autograd.Function):
    """``x[:, idx]`` over key blocks ([B, n, ...] -> [B, n, A, ...]) whose
    backward sums each block's gathered gradients in fp32 (a k-block is
    gathered by every q-block that sees it: in bf16 a scatter-add would
    round once per partial)."""

    @staticmethod
    def forward(ctx, x, idx):
        ctx.save_for_backward(idx)
        ctx.shape = x.shape
        return x[:, idx]

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        acc = g.new_zeros(ctx.shape, dtype=torch.float32)
        acc = acc.index_add(1, idx.reshape(-1),
                            g.float().flatten(1, 2))
        return acc.to(g.dtype), None


def _gathered_attention(q, k, v, idx: torch.Tensor, keep: torch.Tensor,
                        block: int, scale: Optional[float]):
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    n = S // block
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    qb = q.reshape(B, n, block, Hkv, H // Hkv, D)
    # [B, n, A, blk, Hkv, D]
    ks = _GatherBlocks.apply(k.reshape(B, n, block, Hkv, D), idx)
    vs = _GatherBlocks.apply(v.reshape(B, n, block, Hkv, D), idx)
    s = (torch.einsum("bnqhrd,bnakhd->bnhrqak", qb, ks) * scale).float()
    s = torch.where(keep[None, :, None, None], s, NEG_INF)
    p = torch.softmax(s.flatten(-2), dim=-1).to(q.dtype).reshape(s.shape)
    o = torch.einsum("bnhrqak,bnakhd->bnqhrd", p, vs)
    return o.reshape(B, S, H, D)


def block_sparse_attention(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, layout: np.ndarray, block: int,
                           scale: Optional[float] = None) -> torch.Tensor:
    """q: [B, S, H, D]; k/v: [B, S, Hkv, D]; layout: static [nQ, nK] bool
    (block-causal).  Causal masking applies inside diagonal blocks."""
    n = q.shape[1] // block
    if layout.shape != (n, n):
        raise ValueError(f"layout {layout.shape} != ({n}, {n}) blocks")
    idx, keep = gather_plan(layout, block)
    return _gathered_attention(q, k, v, torch.from_numpy(idx).to(q.device),
                               torch.from_numpy(keep).to(q.device), block,
                               scale)


def make_block_sparse_attention(config: SparsityConfig):
    """An ``attention_fn`` for ``Model(attention_fn=...)``: causal only,
    no padding mask, the sequence a multiple of ``config.block``.  Each
    sequence length's gather plan is built once per device and kept."""
    plans: Dict[Tuple[int, str], Tuple[torch.Tensor, torch.Tensor]] = {}

    def attn(q, k, v, mask=None, scale=None, causal=True):
        if mask is not None:
            raise NotImplementedError(
                "block-sparse attention does not support padding masks")
        if not causal:
            raise NotImplementedError(
                "block-sparse attention is causal-only")
        S = q.shape[1]
        if S % config.block:
            raise ValueError(f"sequence {S} not divisible by "
                             f"block {config.block}")
        key = (S, str(q.device))
        if key not in plans:
            idx, keep = gather_plan(config.make_layout(S // config.block),
                                    config.block)
            plans[key] = (torch.from_numpy(idx).to(q.device),
                          torch.from_numpy(keep).to(q.device))
        idx, keep = plans[key]
        return _gathered_attention(q, k, v, idx, keep, config.block, scale)

    return attn


def density(layout: np.ndarray) -> float:
    """Active fraction of the full causal lower triangle."""
    n = layout.shape[0]
    return float(layout.sum()) / (n * (n + 1) / 2)
