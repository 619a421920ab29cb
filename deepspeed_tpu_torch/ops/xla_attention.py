"""Flash-style attention in plain PyTorch ops: a hand-written backward with
an LSE residual, the ``attention_fn`` of ``attention_impl="xla_flash"``.

Counterpart of ``deepspeed_tpu/ops/xla_attention.py`` (the JAX package's
``fused_attention``, a ``jax.custom_vjp`` over XLA ops; no Pallas kernel).
The same function as ``models.layers.causal_attention`` with another
memory schedule:

* the forward saves ``(q, k, v, [mask], o, lse)`` for the backward, O(S)
  beside the inputs, not the O(S^2) probabilities autograd would keep;
* causal self-attention with no mask runs block-causal: the queries split
  into :data:`_NUM_Q_BLOCKS` blocks, each against its visible key prefix
  (``:100-127``), so the upper-triangle quadrants are never computed;
* the backward takes ``delta = rowsum(dO * O)`` in fp32, recomputes P with
  one ``exp`` from the saved LSE, and on the block path runs over (q-block,
  k-block) pairs of :data:`_NUM_BWD_BLOCKS` blocks, accumulating the
  dq/dk/dv partials across pairs in fp32 (``:130-206``).

The backward is written in differentiable ops and the autograd function
returns ``(o, lse)`` with a gradient for both (a ``dlse`` adds ``P * dlse``
to dS), so a Hessian-vector product through it is exact, as JAX's
forward-over-reverse through the custom VJP is.

The forward is the custom op ``torch.ops.deepspeed_tpu_torch.
xla_attention_fwd`` returning ``(o, lse)``: the ``xla_flash`` remat policy
saves its outputs by name, as the JAX policy saves ``attn_out`` and
``attn_lse``, so a checkpointed layer's backward does not replay the
softmax.  It carries a flop formula (the products the block-causal path
computes) for ``torch.utils.flop_counter``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

_NEG_INF = -1e30

# q blocks of the block-causal forward (causal self-attention, no mask)
_NUM_Q_BLOCKS = 8
# the backward's (q-block, k-block) pairs use coarser blocks
_NUM_BWD_BLOCKS = 4


def _group(x: torch.Tensor, Hkv: int) -> torch.Tensor:
    B, S, H, D = x.shape
    return x.reshape(B, S, Hkv, H // Hkv, D)


def _logits(qg, k, scale, mask, causal):
    """[B,Sq,Hkv,r,D] x [B,Sk,Hkv,D] -> fp32 masked logits [B,Hkv,r,Sq,Sk]."""
    logits = (torch.einsum("bqhrd,bkhd->bhrqk", qg, k) * scale).float()
    Sq, Sk = qg.shape[1], k.shape[1]
    if causal:
        keep = torch.ones((Sq, Sk), dtype=torch.bool,
                          device=qg.device).tril(diagonal=Sk - Sq)
        logits = torch.where(keep, logits, _NEG_INF)
    if mask is not None:
        logits = torch.where(mask[:, None, None, None, :], logits, _NEG_INF)
    return logits


def _blocks(Sq: int, Sk: int) -> Optional[int]:
    """Block size of the block-causal path, or None where it does not
    apply (self-attention of equal lengths divisible by the block count)."""
    if Sq != Sk or Sq % _NUM_Q_BLOCKS:
        return None
    return Sq // _NUM_Q_BLOCKS


def _block_logits(qi, kp, i: int, bs: int, scale):
    """fp32 masked logits of q-block ``i`` against a key prefix whose
    visible length is ``i * bs`` plus the diagonal: the forward's and the
    backward's diagonal pairs share it, so their masks agree."""
    logits = (torch.einsum("bqhrd,bkhd->bhrqk", qi, kp) * scale).float()
    keep = torch.ones((bs, kp.shape[1]), dtype=torch.bool,
                      device=qi.device).tril(diagonal=i * bs)
    return torch.where(keep, logits, _NEG_INF)


def _attn_fwd(q, k, v, mask, scale: float, causal: bool):
    """(o [B,S,H,D] in q's dtype, lse [B,Hkv,r,S] fp32)."""
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    qg = _group(q, Hkv)
    bs = _blocks(S, k.shape[1]) if (causal and mask is None) else None
    if bs is None:
        logits = _logits(qg, k, scale, mask, causal)
        lse = torch.logsumexp(logits, dim=-1)
        probs = torch.exp(logits - lse[..., None]).to(q.dtype)
        o = torch.einsum("bhrqk,bkhd->bqhrd", probs, v).reshape(B, S, H, D)
        return o, lse
    o_blocks, lse_blocks = [], []
    for i in range(_NUM_Q_BLOCKS):
        qi = qg[:, i * bs:(i + 1) * bs]
        # one pass over this q-block's visible prefix: the causal mask
        # bites only in the diagonal sub-block
        kp, vp = k[:, :(i + 1) * bs], v[:, :(i + 1) * bs]
        logits = _block_logits(qi, kp, i, bs, scale)
        l_i = torch.logsumexp(logits, dim=-1)
        p_i = torch.exp(logits - l_i[..., None]).to(q.dtype)
        o_blocks.append(torch.einsum("bhrqk,bkhd->bqhrd", p_i, vp))
        lse_blocks.append(l_i)
    o = torch.cat(o_blocks, dim=1).reshape(B, S, H, D)
    return o, torch.cat(lse_blocks, dim=-1)


def _attn_bwd(q, k, v, mask, o, lse, do, dlse, scale: float, causal: bool):
    """(dq, dk, dv) in differentiable ops.  ``dlse`` (None or [B,Hkv,r,S]):
    the gradient of the LSE output, which adds ``P * dlse`` to dS."""
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    qg, dog, og = _group(q, Hkv), _group(do, Hkv), _group(o, Hkv)
    # the softmax-Jacobian row term from O instead of P * dP: O(S*D)
    delta = torch.einsum("bqhrd,bqhrd->bhrq", dog.float(), og.float())
    if dlse is not None:
        delta = delta - dlse
    bs = _blocks(S, k.shape[1]) if (causal and mask is None) else None
    if bs is None:
        logits = _logits(qg, k, scale, mask, causal)
        p = torch.exp(logits - lse[..., None]).to(q.dtype)
        dv = torch.einsum("bhrqk,bqhrd->bkhd", p, dog)
        dp = torch.einsum("bqhrd,bkhd->bhrqk", dog, v)
        ds = (p.float() * (dp.float() - delta[..., None])
              * scale).to(q.dtype)
        dq = torch.einsum("bhrqk,bkhd->bqhrd", ds, k).reshape(B, S, H, D)
        dk = torch.einsum("bhrqk,bqhrd->bkhd", ds, qg)
        return dq, dk, dv

    # (q-block i, k-block j) pairs, i >= j: dk_j / dv_j accumulate
    # block-sized fp32 partials and are written once per key block; only
    # the diagonal pairs are masked
    if S % _NUM_BWD_BLOCKS == 0 and (S // _NUM_BWD_BLOCKS) % bs == 0:
        bs = S // _NUM_BWD_BLOCKS
    nb = S // bs
    dq_acc = [None] * nb
    dk_parts, dv_parts = [], []
    for j in range(nb):
        kj, vj = k[:, j * bs:(j + 1) * bs], v[:, j * bs:(j + 1) * bs]
        dk_j = dv_j = None
        for i in range(j, nb):
            sl = slice(i * bs, (i + 1) * bs)
            qi, doi = qg[:, sl], dog[:, sl]
            li, di = lse[..., sl], delta[..., sl]
            if i == j:
                logits = _block_logits(qi, kj, 0, bs, scale)
            else:
                logits = (torch.einsum("bqhrd,bkhd->bhrqk", qi, kj)
                          * scale).float()
            p = torch.exp(logits - li[..., None]).to(q.dtype)
            pv = torch.einsum("bhrqk,bqhrd->bkhd", p, doi).float()
            dv_j = pv if dv_j is None else dv_j + pv
            dp = torch.einsum("bqhrd,bkhd->bhrqk", doi, vj)
            ds = (p.float() * (dp.float() - di[..., None])
                  * scale).to(q.dtype)
            dq_i = torch.einsum("bhrqk,bkhd->bqhrd", ds, kj).float()
            dq_acc[i] = dq_i if dq_acc[i] is None else dq_acc[i] + dq_i
            sk = torch.einsum("bhrqk,bqhrd->bkhd", ds, qi).float()
            dk_j = sk if dk_j is None else dk_j + sk
        dk_parts.append(dk_j)
        dv_parts.append(dv_j)
    dq = torch.cat(dq_acc, dim=1).reshape(B, S, H, D).to(q.dtype)
    return (dq, torch.cat(dk_parts, dim=1).to(k.dtype),
            torch.cat(dv_parts, dim=1).to(v.dtype))


@torch.library.custom_op(
    "deepspeed_tpu_torch::xla_attention_fwd", mutates_args=(),
    schema="(Tensor q, Tensor k, Tensor v, Tensor? mask, float scale, "
           "bool causal) -> (Tensor, Tensor)")
def xla_attention_fwd(q, k, v, mask, scale, causal):
    """The forward as a dispatcher op, ``(o, lse)``: what the ``xla_flash``
    remat policy saves."""
    return _attn_fwd(q, k, v, mask, scale, causal)


@xla_attention_fwd.register_fake
def _(q, k, v, mask, scale, causal):
    B, S, H, _ = q.shape
    Hkv = k.shape[2]
    return (torch.empty_like(q),
            q.new_empty((B, Hkv, H // Hkv, S), dtype=torch.float32))


def forward_products_flops(q_shape, k_shape, causal: bool,
                           masked: bool) -> int:
    """2 x the multiply-adds of the forward's two products (Q K^T, P V)
    as :func:`_attn_fwd` computes them: q-block i of the block-causal path
    against its prefix of ``(i + 1)`` blocks, else the full Sq x Sk."""
    B, S, H, D = q_shape
    Sk = k_shape[1]
    bs = _blocks(S, Sk) if (causal and not masked) else None
    if bs is None:
        pairs = S * Sk
    else:
        pairs = sum(bs * (i + 1) * bs for i in range(_NUM_Q_BLOCKS))
    return 2 * 2 * B * H * pairs * D


def _register_flop_formula() -> None:
    from torch.utils.flop_counter import register_flop_formula

    @register_flop_formula(torch.ops.deepspeed_tpu_torch.xla_attention_fwd)
    def _(q, k, v, mask, scale, causal, *args, out_shape=None, **kw):
        return forward_products_flops(q, k, bool(causal), mask is not None)


_register_flop_formula()


class XlaAttentionFunction(torch.autograd.Function):
    """(o, lse) = attention(q, k, v); the JAX ``_attn`` / ``_attn_masked``
    custom VJPs, with the LSE an output of its own so that the backward
    is differentiable again."""

    @staticmethod
    def forward(ctx, q, k, v, mask, scale: float, causal: bool):
        o, lse = xla_attention_fwd(q, k, v, mask, scale, causal)
        ctx.save_for_backward(q, k, v, mask, o, lse)
        ctx.scale, ctx.causal = scale, causal
        ctx.set_materialize_grads(False)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, mask, o, lse = ctx.saved_tensors
        if do is None:
            do = torch.zeros_like(o)
        dq, dk, dv = _attn_bwd(q, k, v, mask, o, lse, do, dlse, ctx.scale,
                               ctx.causal)
        return dq, dk, dv, None, None, None


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: Optional[torch.Tensor] = None,
                    scale: Optional[float] = None,
                    causal: bool = True) -> torch.Tensor:
    """Drop-in for ``layers.causal_attention`` with the flash-style
    backward.  q: [B, S, H, D]; k/v: [B, Sk, Hkv, D] (GQA by grouping the
    query heads); mask: optional [B, Sk] padding mask (1 = attend)."""
    D = q.shape[-1]
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(D)
    m = None if mask is None else mask.bool()
    return XlaAttentionFunction.apply(q, k, v, m, scale, bool(causal))[0]
