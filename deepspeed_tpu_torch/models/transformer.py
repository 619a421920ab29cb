"""Decoder-only transformer: config, parameter tree, dense forward.

Counterpart of ``deepspeed_tpu/models/transformer.py``.  The parameter
tree has the JAX package's keys and layouts exactly — per-layer weights
stacked on a leading layer dimension under ``params["blocks"]``,
``wq [dm, H, D]``, ``wk``/``wv [dm, Hkv, D]``, ``wo [H, D, dm]``,
``mlp.wi``/``wg [dm, dff]``, ``mlp.wo [dff, dm]``, ``lm_head.kernel
[dm, vocab]`` — so weights carry over from the JAX package with a plain
tree map (:func:`params_from_numpy`).

The layer stack is a Python loop over views of the stacked weights
(the JAX package's ``lax.scan``).  Forward only: training (loss, remat,
MoE) is not ported yet.
"""

from __future__ import annotations

import dataclasses
import math
from functools import partial
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ..platform.cuda import resolve_device
from . import layers as L


@dataclasses.dataclass
class TransformerConfig:
    vocab_size: int = 50257
    num_layers: int = 12
    d_model: int = 768
    num_heads: int = 12
    num_kv_heads: Optional[int] = None        # None => MHA
    d_ff: Optional[int] = None                # None => 4*d_model (or 8/3 gated)
    max_seq_len: int = 1024
    activation: str = "gelu"
    gated_mlp: bool = False                   # SwiGLU-style (llama)
    norm: str = "layernorm"                   # layernorm | rmsnorm
    position: str = "learned"                 # learned | rope | alibi
    rope_theta: float = 10000.0
    rope_pct: float = 1.0                     # partial rotary (phi: 0.4)
    # bloom: layernorm applied to the word embeddings before the stack
    embed_norm: bool = False
    # parallel residual: x + attn(ln(x)) + mlp(ln(x)), one shared norm
    # (falcon, phi, gpt-j)
    parallel_block: bool = False
    # gpt-neox/pythia: parallel residual but TWO norms — the MLP reads
    # ln2(x) instead of the attention's ln1(x)
    parallel_separate_norms: bool = False
    tie_embeddings: bool = True
    attn_bias: bool = True
    # o-projection bias; None follows attn_bias (qwen2: q/k/v biases
    # but NO o bias)
    attn_out_bias: Optional[bool] = None
    mlp_bias: bool = True
    head_bias: bool = False                   # lm_head bias (phi)
    eps: float = 1e-5
    # training-side fields, kept so configs carry over field for field
    remat: bool = False
    remat_policy: str = "nothing"
    attention_impl: str = "xla_flash"
    scan_unroll: int = 1
    # gpt-neo: attention WITHOUT the 1/sqrt(d) scaling; None = default
    attn_scale: Optional[float] = None
    # --- MoE (not ported yet: num_experts > 1 raises) ---------------------
    num_experts: int = 1
    moe_top_k: int = 2
    moe_shared_ff: Optional[int] = None
    moe_norm_topk: bool = True
    capacity_factor: float = 1.25
    eval_capacity_factor: float = 2.0
    min_capacity: int = 4
    noise_policy: Optional[str] = None
    aux_loss_coef: float = 0.01
    moe_dispatch: str = "scatter"

    def __post_init__(self):
        if self.num_kv_heads is None:
            self.num_kv_heads = self.num_heads
        if self.attn_out_bias is None:
            self.attn_out_bias = self.attn_bias
        if self.d_ff is None:
            if self.gated_mlp:
                # llama sizing: 2/3 * 4d, rounded up to a multiple of 256
                raw = int(8 * self.d_model / 3)
                self.d_ff = 256 * ((raw + 255) // 256)
            else:
                self.d_ff = 4 * self.d_model
        if self.d_model % self.num_heads or self.num_heads % self.num_kv_heads:
            raise ValueError("d_model % num_heads and num_heads % "
                             "num_kv_heads must be 0")

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads

    @property
    def rotary_dim(self) -> int:
        """Head dims receiving rotary embedding (even, <= head_dim)."""
        return (int(self.head_dim * self.rope_pct) // 2) * 2


def _require_supported(cfg: TransformerConfig) -> None:
    if cfg.num_experts > 1:
        raise NotImplementedError(
            "num_experts > 1 (MoE) is not ported yet (ROADMAP Queue 1, "
            "multi-GPU training breadth: parallel/moe.py)")


# --------------------------------------------------------------------------
# parameter trees
# --------------------------------------------------------------------------

def tree_map(fn: Callable, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    return [tree]


def unstack_layers(blocks, num_layers: int):
    """Per-layer weight trees: views into the stacked tensors (one
    ``unbind`` per leaf)."""
    if isinstance(blocks, dict):
        per_key = {k: unstack_layers(v, num_layers) for k, v in blocks.items()}
        return [{k: v[i] for k, v in per_key.items()}
                for i in range(num_layers)]
    return blocks.unbind(0)


def init_params(cfg: TransformerConfig, generator: torch.Generator,
                device, dtype=torch.float32) -> Dict[str, Any]:
    """Random parameters with the JAX package's tree, shapes and init
    scales (``init_params`` there), drawn ON ``device`` from
    ``generator`` (which must live on that device) — a large model's
    random weights never pass through host memory.  The values differ
    from the JAX package's for the same seed."""
    _require_supported(cfg)
    dev = torch.device(device)
    H, D, Hkv = cfg.num_heads, cfg.head_dim, cfg.num_kv_heads
    dm, dff, nl = cfg.d_model, cfg.d_ff, cfg.num_layers
    out_scale = 1.0 / math.sqrt(dm) / math.sqrt(2.0 * nl)   # GPT-2 depth scaling

    def normal(shape, scale):
        x = torch.randn(shape, generator=generator, device=dev, dtype=dtype)
        return x.mul_(scale)

    def zeros(*shape):
        return torch.zeros(shape, device=dev, dtype=dtype)

    def ones(*shape):
        return torch.ones(shape, device=dev, dtype=dtype)

    def norm_init(*lead):
        p = {"scale": ones(*lead, dm)}
        if cfg.norm == "layernorm":
            p["bias"] = zeros(*lead, dm)
        return p

    params: Dict[str, Any] = {"embed": {"table": normal((cfg.vocab_size, dm),
                                                        0.02)}}
    if cfg.position == "learned":
        params["pos_embed"] = {"table": normal((cfg.max_seq_len, dm), 0.01)}
    if cfg.embed_norm:                      # bloom word_embeddings_layernorm
        params["ln_embed"] = norm_init()

    attn = {"wq": normal((nl, dm, H, D), 1.0 / math.sqrt(dm)),
            "wk": normal((nl, dm, Hkv, D), 1.0 / math.sqrt(dm)),
            "wv": normal((nl, dm, Hkv, D), 1.0 / math.sqrt(dm)),
            "wo": normal((nl, H, D, dm), out_scale)}
    if cfg.attn_bias:
        attn["bq"] = zeros(nl, H, D)
        attn["bk"] = zeros(nl, Hkv, D)
        attn["bv"] = zeros(nl, Hkv, D)
    if cfg.attn_out_bias:
        attn["bo"] = zeros(nl, dm)
    mlp = {"wi": normal((nl, dm, dff), 1.0 / math.sqrt(dm))}
    if cfg.gated_mlp:
        mlp["wg"] = normal((nl, dm, dff), 1.0 / math.sqrt(dm))
    mlp["wo"] = normal((nl, dff, dm), out_scale)
    if cfg.mlp_bias:
        mlp["bi"] = zeros(nl, dff)
        mlp["bo"] = zeros(nl, dm)
    blocks = {"attn": attn, "mlp": mlp, "ln1": norm_init(nl)}
    if not cfg.parallel_block or cfg.parallel_separate_norms:
        blocks["ln2"] = norm_init(nl)
    params["blocks"] = blocks
    params["ln_f"] = norm_init()
    if not cfg.tie_embeddings:
        params["lm_head"] = {"kernel": normal((dm, cfg.vocab_size),
                                              1.0 / math.sqrt(dm))}
        if cfg.head_bias:
            params["lm_head"]["bias"] = zeros(cfg.vocab_size)
    return params


def params_from_numpy(tree, device=None, dtype: Optional[torch.dtype] = None):
    """Carry a parameter tree of numpy arrays (e.g. ``np.asarray`` of each
    leaf of a JAX tree) into the port on ``device``.  bf16 arrays (numpy
    dtype ``bfloat16``, which ``torch.from_numpy`` rejects) go through
    float32, which is exact.  ``dtype`` None keeps each leaf's own type."""
    dev = resolve_device(device)

    def conv(a):
        a = np.asarray(a)
        is_bf16 = a.dtype.name == "bfloat16"
        t = torch.from_numpy(np.array(a, np.float32 if is_bf16 else a.dtype))
        target = dtype or (torch.bfloat16 if is_bf16 else t.dtype)
        return t.to(device=dev, dtype=target)

    return tree_map(conv, tree)


# --------------------------------------------------------------------------
# forward
# --------------------------------------------------------------------------

def _norm(cfg: TransformerConfig):
    fn = L.layernorm if cfg.norm == "layernorm" else L.rmsnorm
    return partial(fn, eps=cfg.eps)


def attn_scale(cfg: TransformerConfig) -> float:
    return (cfg.attn_scale if cfg.attn_scale is not None
            else 1.0 / (cfg.head_dim ** 0.5))


def block_apply(cfg: TransformerConfig, lp, x: torch.Tensor, cos, sin,
                mask=None) -> torch.Tensor:
    """One decoder layer.  lp: this layer's params; x: [B, S, dm]."""
    norm = _norm(cfg)
    act = L.ACTIVATIONS[cfg.activation]
    ap = lp["attn"]
    dt = x.dtype
    h = norm(lp["ln1"], x)
    q = torch.einsum("bsd,dhk->bshk", h, ap["wq"].to(dt))
    k = torch.einsum("bsd,dhk->bshk", h, ap["wk"].to(dt))
    v = torch.einsum("bsd,dhk->bshk", h, ap["wv"].to(dt))
    if cfg.attn_bias:
        q = q + ap["bq"].to(dt)
        k = k + ap["bk"].to(dt)
        v = v + ap["bv"].to(dt)
    if cfg.position == "rope":
        q = L.apply_rope(q, cos, sin)
        k = L.apply_rope(k, cos, sin)
    o = L.causal_attention(q, k, v, mask=mask, scale=attn_scale(cfg))
    o = torch.einsum("bshk,hkd->bsd", o, ap["wo"].to(dt))
    if cfg.attn_out_bias:
        o = o + ap["bo"].to(dt)
    if not cfg.parallel_block:
        x = x + o
        h = norm(lp["ln2"], x)
    elif cfg.parallel_separate_norms:
        h = norm(lp["ln2"], x)   # gpt-neox: the MLP norms the original x
    mp = lp["mlp"]
    u = h @ mp["wi"].to(dt)
    if cfg.mlp_bias:
        u = u + mp["bi"].to(dt)
    u = act(h @ mp["wg"].to(dt)) * u if cfg.gated_mlp else act(u)
    d = u @ mp["wo"].to(dt)
    if cfg.mlp_bias:
        d = d + mp["bo"].to(dt)
    if cfg.parallel_block:
        return x + o + d
    return x + d


@torch.no_grad()
def apply(cfg: TransformerConfig, params, input_ids: torch.Tensor,
          mask: Optional[torch.Tensor] = None, dtype=None) -> torch.Tensor:
    """Dense forward -> logits [B, S, vocab] (the JAX ``apply`` without
    its training options)."""
    _require_supported(cfg)
    dt = dtype or params["embed"]["table"].dtype
    x = L.embed(params["embed"], input_ids).to(dt)
    if cfg.embed_norm:
        x = _norm(cfg)(params["ln_embed"], x)
    cos = sin = None
    if cfg.position == "learned":
        S = input_ids.shape[1]
        x = x + params["pos_embed"]["table"][:S].to(dt)
    elif cfg.position == "alibi":
        L.alibi_slopes(cfg.num_heads)            # raises: not ported yet
    else:
        cos, sin = L.rope_freqs(cfg.rotary_dim, cfg.max_seq_len,
                                cfg.rope_theta, device=x.device)
    for lp in unstack_layers(params["blocks"], cfg.num_layers):
        x = block_apply(cfg, lp, x, cos, sin, mask=mask)
    x = _norm(cfg)(params["ln_f"], x)
    if cfg.tie_embeddings:
        return x @ params["embed"]["table"].to(dt).T
    logits = x @ params["lm_head"]["kernel"].to(dt)
    if cfg.head_bias:
        logits = logits + params["lm_head"]["bias"].to(dt)
    return logits


class Model:
    """Config + parameters on one device (``device`` None = the card)."""

    def __init__(self, cfg: TransformerConfig, seed: int = 0, device=None,
                 dtype: torch.dtype = torch.float32):
        dev = resolve_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        self.config = cfg
        self.device = dev
        self.params = init_params(cfg, gen, dev, dtype)

    def apply(self, params, input_ids, **kw):
        return apply(self.config, params, input_ids, **kw)

    @classmethod
    def from_params(cls, cfg: TransformerConfig, params) -> "Model":
        """Wrap EXISTING parameters (no initializer run); the device is
        the one the parameters live on."""
        _require_supported(cfg)
        m = cls.__new__(cls)
        m.config = cfg
        m.params = params
        m.device = tree_leaves(params)[0].device
        return m
