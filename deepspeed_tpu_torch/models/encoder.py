"""BERT-class bidirectional encoder (the embedding / rerank serving class).

Counterpart of ``deepspeed_tpu/models/encoder.py``: word + position +
token-type embeddings, LayerNorm, N post-LN layers ``x = LN(x + Attn(x));
x = LN(x + MLP(x))`` (bidirectional, with a padding mask), an optional
tanh pooler over [CLS].  The parameter tree has the JAX package's keys
and layouts (per-layer weights stacked under ``blocks``), so a JAX tree
carries over with :func:`~.transformer.params_from_numpy`.

:meth:`Encoder.encode_batch` pads requests into power-of-two sequence
buckets from 16 up to ``max_seq_len`` and pools by CLS or masked mean.
The JAX package compiles one program per bucket; here each bucket runs
eagerly (nothing to compile), with the same padding and the same numbers.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from ..platform.cuda import resolve_device
from . import layers as L
from .transformer import unstack_layers


@dataclasses.dataclass
class EncoderConfig:
    vocab_size: int
    d_model: int = 768
    num_layers: int = 12
    num_heads: int = 12
    d_ff: Optional[int] = None            # None => 4*d_model
    max_seq_len: int = 512
    type_vocab_size: int = 2
    activation: str = "gelu"
    eps: float = 1e-12                    # BERT's LayerNorm eps
    pooler: bool = True                   # tanh pooler over [CLS]

    def __post_init__(self):
        if self.d_ff is None:
            self.d_ff = 4 * self.d_model
        if self.d_model % self.num_heads:
            raise ValueError("d_model % num_heads must be 0")

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads


def init_params(cfg: EncoderConfig, generator: torch.Generator, device,
                dtype=torch.float32) -> Dict[str, Any]:
    """Random parameters with the JAX package's tree, shapes and init
    scales, drawn on ``device`` from ``generator``; the values differ from
    the JAX package's for the same seed."""
    dev = torch.device(device)
    dm, H, D, dff, nl = (cfg.d_model, cfg.num_heads, cfg.head_dim, cfg.d_ff,
                         cfg.num_layers)

    def normal(shape, scale):
        x = torch.randn(shape, generator=generator, device=dev, dtype=dtype)
        return x.mul_(scale)

    def zeros(*shape):
        return torch.zeros(shape, device=dev, dtype=dtype)

    def norm(*lead):
        return {"scale": torch.ones((*lead, dm), device=dev, dtype=dtype),
                "bias": zeros(*lead, dm)}

    params: Dict[str, Any] = {
        "embed": {"table": normal((cfg.vocab_size, dm), 0.02)},
        "pos_embed": {"table": normal((cfg.max_seq_len, dm), 0.01)}}
    if cfg.type_vocab_size > 0:           # distilbert: no segment embeds
        params["type_embed"] = {"table": normal((cfg.type_vocab_size, dm),
                                                0.01)}
    params["ln_embed"] = norm()
    params["blocks"] = {
        "attn": {"wq": normal((nl, dm, H, D), 1.0 / math.sqrt(dm)),
                 "wk": normal((nl, dm, H, D), 1.0 / math.sqrt(dm)),
                 "wv": normal((nl, dm, H, D), 1.0 / math.sqrt(dm)),
                 "wo": normal((nl, H, D, dm), 1.0 / math.sqrt(dm)),
                 "bq": zeros(nl, H, D), "bk": zeros(nl, H, D),
                 "bv": zeros(nl, H, D), "bo": zeros(nl, dm)},
        "mlp": {"wi": normal((nl, dm, dff), 1.0 / math.sqrt(dm)),
                "bi": zeros(nl, dff),
                "wo": normal((nl, dff, dm), 1.0 / math.sqrt(dff)),
                "bo": zeros(nl, dm)},
        "ln_attn": norm(nl), "ln_mlp": norm(nl)}
    if cfg.pooler:
        params["pooler"] = {"kernel": normal((dm, dm), 1.0 / math.sqrt(dm)),
                            "bias": zeros(dm)}
    return params


def encode(cfg: EncoderConfig, params, input_ids: torch.Tensor,
           attention_mask: Optional[torch.Tensor] = None,
           token_type_ids: Optional[torch.Tensor] = None,
           dtype=None) -> torch.Tensor:
    """The last hidden state [B, S, dm] (bidirectional, padding-masked)."""
    dt = dtype or params["embed"]["table"].dtype
    S = input_ids.shape[1]
    x = L.embed(params["embed"], input_ids).to(dt)
    x = x + params["pos_embed"]["table"][:S].to(dt)
    if cfg.type_vocab_size > 0:
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        x = x + params["type_embed"]["table"][token_type_ids.long()].to(dt)

    def norm(p, h):
        return L.layernorm(p, h, eps=cfg.eps)

    act = L.ACTIVATIONS[cfg.activation]
    x = norm(params["ln_embed"], x)
    for lp in unstack_layers(params["blocks"], cfg.num_layers):
        ap = lp["attn"]
        q = torch.einsum("bsd,dhk->bshk", x, ap["wq"].to(dt)) + ap["bq"].to(dt)
        k = torch.einsum("bsd,dhk->bshk", x, ap["wk"].to(dt)) + ap["bk"].to(dt)
        v = torch.einsum("bsd,dhk->bshk", x, ap["wv"].to(dt)) + ap["bv"].to(dt)
        o = L.causal_attention(q, k, v, mask=attention_mask, causal=False)
        o = torch.einsum("bshk,hkd->bsd", o, ap["wo"].to(dt)) + ap["bo"].to(dt)
        x = norm(lp["ln_attn"], x + o)                   # post-LN
        mp = lp["mlp"]
        u = act(x @ mp["wi"].to(dt) + mp["bi"].to(dt))
        x = norm(lp["ln_mlp"], x + (u @ mp["wo"].to(dt) + mp["bo"].to(dt)))
    return x


def pooled(cfg: EncoderConfig, params, hidden: torch.Tensor) -> torch.Tensor:
    """BERT's pooler: tanh(dense([CLS])), the sentence embedding."""
    cls = hidden[:, 0]
    p = params["pooler"]
    return torch.tanh(cls @ p["kernel"].to(cls.dtype)
                      + p["bias"].to(cls.dtype))


def bucket(maxlen: int, max_seq_len: int) -> int:
    """The power-of-two bucket (from 16, capped at ``max_seq_len``) a batch
    whose longest request has ``maxlen`` tokens pads to."""
    S = 16
    while S < maxlen:
        S *= 2
    S = min(S, max_seq_len)
    if maxlen > S:
        raise ValueError(f"a request of {maxlen} tokens exceeds "
                         f"max_seq_len {max_seq_len}")
    return S


class Encoder:
    """Encoder model and bucketed batch serving on one device (``device``
    None is the card)."""

    def __init__(self, config: EncoderConfig, seed: int = 0,
                 dtype: torch.dtype = torch.float32, *, device=None):
        dev = resolve_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        self.config = config
        self.device = dev
        self.params = init_params(config, gen, dev, dtype)

    @classmethod
    def from_params(cls, config: EncoderConfig, params) -> "Encoder":
        """Wrap an existing tree (e.g. ``checkpoint.hf.load_hf_bert``'s);
        the device is the one the parameters live on."""
        self = cls.__new__(cls)
        self.config = config
        self.params = params
        self.device = params["embed"]["table"].device
        return self

    @torch.no_grad()
    def run_bucket(self, ids: torch.Tensor, mask: torch.Tensor,
                   types: torch.Tensor):
        """One padded bucket: (hidden [B, S, dm], CLS vector, masked mean)."""
        cfg = self.config
        h = encode(cfg, self.params, ids, attention_mask=mask,
                   token_type_ids=types)
        cls_vec = pooled(cfg, self.params, h) if cfg.pooler else h[:, 0]
        m = mask.to(h.dtype)[..., None]
        mean_vec = (h * m).sum(1) / torch.clamp(m.sum(1), min=1.0)
        return h, cls_vec, mean_vec

    def encode_batch(self, requests: Sequence[Sequence[int]],
                     token_type_ids: Optional[Sequence[Sequence[int]]]
                     = None, pool: str = "cls"
                     ) -> Union[torch.Tensor, List[torch.Tensor]]:
        """[len(requests), d_model] embeddings on the model's device
        (``pool``: "cls" | "mean"), or with "none" each request's hidden
        states [len, d_model]."""
        if pool not in ("cls", "mean", "none"):
            raise ValueError(f"pool {pool!r}: expected 'cls', 'mean' or "
                             "'none'")
        S = bucket(max(len(r) for r in requests), self.config.max_seq_len)
        B = len(requests)
        ids = np.zeros((B, S), np.int64)
        mask = np.zeros((B, S), np.int64)
        types = np.zeros((B, S), np.int64)
        for i, r in enumerate(requests):
            ids[i, :len(r)] = r
            mask[i, :len(r)] = 1
            if token_type_ids is not None:
                types[i, :len(token_type_ids[i])] = token_type_ids[i]
        dev = self.device
        h, cls_vec, mean_vec = self.run_bucket(
            torch.from_numpy(ids).to(dev), torch.from_numpy(mask).to(dev),
            torch.from_numpy(types).to(dev))
        if pool == "cls":
            return cls_vec
        if pool == "mean":
            return mean_vec
        return [h[i, :len(r)] for i, r in enumerate(requests)]
