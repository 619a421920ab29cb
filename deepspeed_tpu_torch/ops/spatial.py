"""Spatial / diffusers inference ops of the Stable-Diffusion UNet family.

Counterpart of ``deepspeed_tpu/ops/spatial.py``, which runs on plain XLA
ops (no Pallas kernel): :func:`opt_bias_add` (the three fused NHWC
bias/add variants), :func:`geglu`, :func:`spatial_attention` (self or
cross attention over H*W latent tokens), :func:`diffusers_transformer_block`
(LN, self-attn, LN, cross-attn, LN, GEGLU feed-forward, residuals) and
:func:`nhwc_group_norm` with its fused bias/residual pre-add.  Here they
are plain PyTorch ops, the latents kept NHWC as in the JAX package; the
parameter dictionaries are the JAX package's.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from ..models import layers as L


def opt_bias_add(x: torch.Tensor, bias: Optional[torch.Tensor] = None,
                 other: Optional[torch.Tensor] = None,
                 other_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x + b``, ``x + b + other`` or ``x + b + other + ob``: the three
    variants of the reference's ``opt_bias_add.cu`` (``:24, 50, 81``)."""
    out = x if bias is None else x + bias
    if other is not None:
        out = out + (other if other_bias is None else other + other_bias)
    return out


def geglu(x: torch.Tensor, w: torch.Tensor,
          bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """GEGLU gate (diffusers' FeedForward): the projection doubles the
    hidden dim; one half gates the other through the exact-erf gelu."""
    h = x @ w
    if bias is not None:
        h = h + bias
    u, g = h.chunk(2, dim=-1)
    return u * F.gelu(g, approximate="none")


def spatial_attention(x: torch.Tensor, params: Dict[str, Any],
                      num_heads: int,
                      context: Optional[torch.Tensor] = None,
                      attention_fn=None) -> torch.Tensor:
    """Self or cross attention over latent tokens (the reference's
    ``DeepSpeedDiffusersAttention``).  ``x``: [B, H, W, C] (NHWC) or
    [B, T, C]; ``context``: optional [B, Tc, Cc] (K and V project from it);
    ``params``: wq, wk, wv, wo (+ bo).  Non-causal; ``attention_fn``
    defaults to ``causal_attention``."""
    spatial = x.dim() == 4
    h = x.reshape(x.shape[0], -1, x.shape[-1]) if spatial else x
    B, T, C = h.shape
    D = C // num_heads
    kv_src = h if context is None else context
    dt = h.dtype
    Tk = kv_src.shape[1]
    q = (h @ params["wq"].to(dt)).reshape(B, T, num_heads, D)
    k = (kv_src @ params["wk"].to(dt)).reshape(B, Tk, num_heads, D)
    v = (kv_src @ params["wv"].to(dt)).reshape(B, Tk, num_heads, D)
    if attention_fn is None:
        attention_fn = L.causal_attention
    o = attention_fn(q, k, v, causal=False)
    o = o.reshape(B, T, C) @ params["wo"].to(dt)
    if "bo" in params:
        o = o + params["bo"].to(dt)
    return o.reshape(x.shape) if spatial else o


def diffusers_transformer_block(x: torch.Tensor, params: Dict[str, Any],
                                num_heads: int,
                                context: Optional[torch.Tensor] = None,
                                eps: float = 1e-5,
                                attention_fn=None) -> torch.Tensor:
    """One diffusers 2D transformer block over NHWC latents (the
    reference's ``DeepSpeedDiffusersTransformerBlock``): LN, self-attn,
    LN, cross-attn (``attn2`` runs with or without a context), LN, GEGLU
    feed-forward, a residual around each.  ``params``: ln1-3, attn1,
    attn2, ff {wi, bi, wo, bo}."""
    B, H, W, C = x.shape
    h = x.reshape(B, H * W, C)

    def ln(p, t):
        return L.layernorm(p, t, eps=eps)

    h = h + spatial_attention(ln(params["ln1"], h), params["attn1"],
                              num_heads, attention_fn=attention_fn)
    if "attn2" in params:
        h = h + spatial_attention(ln(params["ln2"], h), params["attn2"],
                                  num_heads, context=context,
                                  attention_fn=attention_fn)
    ff = params["ff"]
    g = geglu(ln(params["ln3"], h), ff["wi"].to(h.dtype), ff.get("bi"))
    d = g @ ff["wo"].to(h.dtype)
    if "bo" in ff:
        d = d + ff["bo"].to(h.dtype)
    return (h + d).reshape(B, H, W, C)


def nhwc_group_norm(x: torch.Tensor, gamma: torch.Tensor,
                    beta: torch.Tensor, num_groups: int = 32,
                    eps: float = 1e-5, bias: Optional[torch.Tensor] = None,
                    residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """GroupNorm over NHWC latents with the fused bias/residual pre-add:
    statistics in fp32 (population variance), the output in ``x``'s
    dtype as it came in (before the pre-add's promotion)."""
    out_dt = x.dtype
    x = opt_bias_add(x, bias, residual)
    B, H, W, C = x.shape
    g = x.reshape(B, H, W, num_groups, C // num_groups).float()
    var, mean = torch.var_mean(g, dim=(1, 2, 4), keepdim=True,
                               correction=0)
    n = ((g - mean) * torch.rsqrt(var + eps)).reshape(B, H, W, C)
    return (n * gamma + beta).to(out_dt)
