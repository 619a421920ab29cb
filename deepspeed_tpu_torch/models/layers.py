"""Functional layers on plain tensors.

Counterpart of ``deepspeed_tpu/models/layers.py:34-183``: the apply
functions take the same parameter dictionaries (``{"table"}``,
``{"scale", "bias"}``) and the same layouts, so a parameter tree carried
over from the JAX package runs unchanged.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F


def embed(p, ids: torch.Tensor) -> torch.Tensor:
    return p["table"][ids.long()]


def layernorm(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"] + p["bias"]).to(x.dtype)      # promotes to f32


def rmsnorm(p, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    y = x32 * torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + eps)
    return (y * p["scale"]).to(x.dtype)                  # promotes to f32


def alibi_slopes(num_heads: int) -> torch.Tensor:
    """ALiBi needs the paged-attention kernel's slopes operand, which this
    port does not have yet (ROADMAP Queue 2, K2 ALiBi variant)."""
    raise NotImplementedError(
        "position='alibi' is not ported yet: it needs the ALiBi variant of "
        "the paged-attention kernel (ROADMAP Queue 2, K2)")


def rope_freqs(head_dim: int, max_seq: int, theta: float = 10000.0,
               device=None):
    """(cos, sin), each [max_seq, head_dim / 2] float32."""
    inv = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                        device=device) / head_dim))
    t = torch.arange(max_seq, dtype=torch.float32, device=device)
    ang = torch.outer(t, inv)                    # [S, D/2]
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: [B, S, H, D]; cos/sin: [maxS, R/2] with R <= D (partial rotary
    rotates only the first R head dims); positions: [B, S] or None."""
    if positions is None:
        c = cos[: x.shape[1]][None, :, None, :]
        s = sin[: x.shape[1]][None, :, None, :]
    else:
        c = cos[positions.long()][:, :, None, :]
        s = sin[positions.long()][:, :, None, :]
    return rotate(x, c, s)


def rotate(x: torch.Tensor, c: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """The rotary step of :func:`apply_rope` with the cos/sin rows already
    gathered and broadcastable to ``x[..., :R/2]``."""
    rot = 2 * c.shape[-1]
    xr, x_pass = x[..., :rot], x[..., rot:]
    x1, x2 = xr.float().chunk(2, dim=-1)
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return torch.cat([out.to(x.dtype), x_pass], dim=-1)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     mask: Optional[torch.Tensor] = None,
                     scale: Optional[float] = None, causal: bool = True,
                     bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q: [B, S, H, D]; k/v: [B, Sk, Hkv, D].  GQA by grouping the query
    heads (KV never expanded to H heads); softmax in fp32.  ``bias``:
    additive attention bias [H, S|1, Sk]."""
    B, S, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    rep = H // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    qg = q.reshape(B, S, Hkv, rep, D)
    logits = torch.einsum("bqhrd,bkhd->bhrqk", qg, k) * scale
    logits = logits.float()
    if bias is not None:
        logits = logits + bias.float().reshape(
            Hkv, rep, bias.shape[-2], Sk)[None]
    if causal:
        keep = torch.ones((S, Sk), dtype=torch.bool,
                          device=q.device).tril(diagonal=Sk - S)
        logits = torch.where(keep[None, None, None], logits, -1e30)
    if mask is not None:                        # [B, Sk] padding mask
        logits = torch.where(mask[:, None, None, None, :].bool(),
                             logits, -1e30)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bhrqk,bkhd->bqhrd", probs, v)
    return out.reshape(B, S, H, D)


ACTIVATIONS = {
    "gelu": lambda x: F.gelu(x, approximate="none"),
    "gelu_new": lambda x: F.gelu(x, approximate="tanh"),
    "relu": F.relu,
    "silu": F.silu,
    "swish": F.silu,
}
