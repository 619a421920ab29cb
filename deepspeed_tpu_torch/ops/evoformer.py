"""Evoformer (DS4Science) attention: biased multi-head attention for
AlphaFold-style MSA and pair stacks.

Counterpart of ``deepspeed_tpu/ops/evoformer.py`` (plain XLA ops behind a
``jax.custom_vjp``; no Pallas kernel): over Q/K/V ``[B, N, S, H, D]``,

    softmax(Q K^T / sqrt(D) + bias1 + bias2) V

with up to two additive biases, ``bias1`` ``[B, N, 1, 1, Sk]`` (the mask
bias, broadcast over heads and queries) and ``bias2`` ``[B, 1, H, Sq, Sk]``
(the pair bias, broadcast over N).  :class:`EvoformerAttentionFunction`
saves the LSE and runs the LSE/delta backward (``:70-88``): P recomputed
with one ``exp``, ``delta = rowsum(dO * O)``, and ``db1`` / ``db2`` the
fp32 dS reduced to the biases' broadcast shapes.  As in
``ops/xla_attention.py`` the LSE is an output with a gradient of its own,
so the backward (differentiable ops) is differentiable again.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch


def _check_biases(Q, K, bias1, bias2) -> None:
    B, N, Sq, H, D = Q.shape
    Sk = K.shape[2]
    if bias1 is not None:
        if (bias1.dim() != 5 or tuple(bias1.shape[:2]) != (B, N)
                or tuple(bias1.shape[2:4]) != (1, 1)
                or bias1.shape[4] != Sk):
            raise ValueError(f"bias1 shape {tuple(bias1.shape)} != "
                             f"[B={B}, N={N}, 1, 1, Sk={Sk}]")
    if bias2 is not None:
        if (bias2.dim() != 5 or bias2.shape[0] != B or bias2.shape[1] != 1
                or bias2.shape[2] != H or bias2.shape[3] != Sq
                or bias2.shape[4] != Sk):
            raise ValueError(f"bias2 shape {tuple(bias2.shape)} != "
                             f"[B={B}, 1, H={H}, Sq={Sq}, Sk={Sk}]")


def _logits(Q, K, bias1, bias2, scale):
    """[B, N, Sq, H, D] x [B, N, Sk, H, D] -> fp32 [B, N, H, Sq, Sk], the
    scale applied in fp32 (the JAX package scales in the inputs' dtype:
    the same in fp32, one rounding more in bf16)."""
    s = torch.einsum("bnqhd,bnkhd->bnhqk", Q, K).float() * scale
    if bias1 is not None:
        s = s + bias1.float()
    if bias2 is not None:
        s = s + bias2.float()
    return s


class EvoformerAttentionFunction(torch.autograd.Function):
    """(o, lse) of the biased attention; bias1 / bias2 may be None."""

    @staticmethod
    def forward(ctx, Q, K, V, bias1, bias2):
        scale = 1.0 / math.sqrt(Q.shape[-1])
        s = _logits(Q, K, bias1, bias2, scale)
        lse = torch.logsumexp(s, dim=-1)
        p = torch.exp(s - lse[..., None]).to(Q.dtype)
        o = torch.einsum("bnhqk,bnkhd->bnqhd", p, V)
        ctx.save_for_backward(Q, K, V, bias1, bias2, o, lse)
        ctx.set_materialize_grads(False)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        Q, K, V, bias1, bias2, o, lse = ctx.saved_tensors
        if do is None:
            do = torch.zeros_like(o)
        scale = 1.0 / math.sqrt(Q.shape[-1])
        delta = torch.einsum("bnqhd,bnqhd->bnhq", do.float(), o.float())
        if dlse is not None:
            delta = delta - dlse
        p32 = torch.exp(_logits(Q, K, bias1, bias2, scale) - lse[..., None])
        dv = torch.einsum("bnhqk,bnqhd->bnkhd", p32.to(Q.dtype), do)
        dp = torch.einsum("bnqhd,bnkhd->bnhqk", do, V)
        # dS from the fp32 probabilities: db1 and db2 sum it over heads
        # and queries, or over N, where a bf16-rounded P would add its
        # rounding to every term (the JAX package rounds P first; the same
        # in fp32)
        ds = p32 * (dp.float() - delta[..., None])
        dss = (ds * scale).to(Q.dtype)
        dq = torch.einsum("bnhqk,bnkhd->bnqhd", dss, K)
        dk = torch.einsum("bnhqk,bnqhd->bnkhd", dss, Q)
        db1 = (ds.sum(dim=(2, 3), keepdim=True).to(bias1.dtype)
               if bias1 is not None else None)       # [B, N, 1, 1, Sk]
        db2 = (ds.sum(dim=1, keepdim=True).to(bias2.dtype)
               if bias2 is not None else None)       # [B, 1, H, Sq, Sk]
        return dq, dk, dv, db1, db2


def evoformer_attention(Q: torch.Tensor, K: torch.Tensor, V: torch.Tensor,
                        biases: Optional[Sequence[Optional[torch.Tensor]]]
                        = None) -> torch.Tensor:
    """``DS4Sci_EvoformerAttention(Q, K, V, biases)``: Q/K/V [B, N, S, H,
    D], up to two additive biases told apart by shape (the module
    docstring's)."""
    biases = [b for b in (biases or []) if b is not None]
    if len(biases) > 2:
        raise ValueError("at most two biases")
    b1 = b2 = None
    for b in biases:
        if b.dim() != 5:
            raise ValueError(
                f"bias rank {b.dim()} != 5; expected [B, N, 1, 1, Sk] "
                "(mask bias) or [B, 1, H, Sq, Sk] (pair bias)")
        if b.shape[2] == 1 and b.shape[3] == 1:
            if b1 is not None:
                raise ValueError("two mask-shaped ([B, N, 1, 1, Sk]) "
                                 "biases passed")
            b1 = b
        else:
            if b2 is not None:
                raise ValueError("two pair-shaped biases passed — one "
                                 "must be [B, N, 1, 1, Sk]")
            b2 = b
    _check_biases(Q, K, b1, b2)
    return EvoformerAttentionFunction.apply(Q, K, V, b1, b2)[0]
