"""CLIP dual tower: a vision transformer and a causal text transformer.

Counterpart of ``deepspeed_tpu/models/clip.py``: one shared pre-LN
residual block (the CLIPEncoderLayer shape, QuickGELU) over stacked
layer weights, run bidirectionally over patch tokens and a class token
(vision) and causally over BPE tokens (text); each tower pools (class
token / EOT token, the highest id of the sequence) and projects into the
shared embedding space; :func:`similarity` is the logit-scaled cosine.
The parameter tree is the JAX package's (the patch kernel HWIO), so a
JAX tree carries over with :func:`~.transformer.params_from_numpy`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..platform.cuda import resolve_device
from . import layers as L
from .transformer import unstack_layers


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


@dataclasses.dataclass
class CLIPTowerConfig:
    width: int
    num_layers: int
    num_heads: int
    d_ff: Optional[int] = None       # None => 4*width

    def __post_init__(self):
        if self.d_ff is None:
            self.d_ff = 4 * self.width


@dataclasses.dataclass
class CLIPConfig:
    """openai/clip-vit-base-patch32's shape by default."""
    embed_dim: int = 512
    image_size: int = 224
    patch_size: int = 32
    vision: Optional[CLIPTowerConfig] = None
    vocab_size: int = 49408
    max_text_len: int = 77
    text: Optional[CLIPTowerConfig] = None
    eps: float = 1e-5

    def __post_init__(self):
        if self.vision is None:
            self.vision = CLIPTowerConfig(width=768, num_layers=12,
                                          num_heads=12)
        if self.text is None:
            self.text = CLIPTowerConfig(width=512, num_layers=12,
                                        num_heads=8)

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2


def _tower_apply(cfg: CLIPConfig, tw: CLIPTowerConfig, blocks,
                 x: torch.Tensor, causal: bool) -> torch.Tensor:
    """The shared pre-LN stack: x += attn(LN(x)); x += mlp(LN(x))."""
    dt = x.dtype
    for lp in unstack_layers(blocks, tw.num_layers):
        a = L.layernorm(lp["ln1"], x, eps=cfg.eps)
        ap = lp["attn"]
        q = torch.einsum("bsd,dhk->bshk", a, ap["wq"].to(dt)) + ap["bq"].to(dt)
        k = torch.einsum("bsd,dhk->bshk", a, ap["wk"].to(dt)) + ap["bk"].to(dt)
        v = torch.einsum("bsd,dhk->bshk", a, ap["wv"].to(dt)) + ap["bv"].to(dt)
        o = L.causal_attention(q, k, v, causal=causal)
        x = x + (torch.einsum("bshk,hkd->bsd", o, ap["wo"].to(dt))
                 + ap["bo"].to(dt))
        m = L.layernorm(lp["ln2"], x, eps=cfg.eps)
        mp = lp["mlp"]
        u = quick_gelu(m @ mp["wi"].to(dt) + mp["bi"].to(dt))
        x = x + (u @ mp["wo"].to(dt) + mp["bo"].to(dt))
    return x


def _tower_init(tw: CLIPTowerConfig, normal, zeros, ones):
    w, H, dff, nl = tw.width, tw.num_heads, tw.d_ff, tw.num_layers
    D = w // H
    ln = lambda: {"scale": ones(nl, w), "bias": zeros(nl, w)}   # noqa: E731
    return {"ln1": ln(), "ln2": ln(),
            "attn": {"wq": normal((nl, w, H, D), 1.0 / math.sqrt(w)),
                     "wk": normal((nl, w, H, D), 1.0 / math.sqrt(w)),
                     "wv": normal((nl, w, H, D), 1.0 / math.sqrt(w)),
                     "wo": normal((nl, H, D, w), 1.0 / math.sqrt(w)),
                     "bq": zeros(nl, H, D), "bk": zeros(nl, H, D),
                     "bv": zeros(nl, H, D), "bo": zeros(nl, w)},
            "mlp": {"wi": normal((nl, w, dff), 1.0 / math.sqrt(w)),
                    "bi": zeros(nl, dff),
                    "wo": normal((nl, dff, w), 1.0 / math.sqrt(dff)),
                    "bo": zeros(nl, w)}}


def init_params(cfg: CLIPConfig, generator: torch.Generator, device,
                dtype=torch.float32) -> Dict[str, Any]:
    """Random parameters with the JAX package's tree, shapes and init
    scales, drawn on ``device``; ``logit_scale`` is log(1 / 0.07) as
    there.  The values differ from the JAX package's for the same seed."""
    dev = torch.device(device)

    def normal(shape, scale):
        x = torch.randn(shape, generator=generator, device=dev, dtype=dtype)
        return x.mul_(scale)

    def zeros(*shape):
        return torch.zeros(shape, device=dev, dtype=dtype)

    def ones(*shape):
        return torch.ones(shape, device=dev, dtype=dtype)

    vw, tw, P = cfg.vision.width, cfg.text.width, cfg.patch_size
    return {
        "visual": {
            "patch_embed": {"kernel": normal((P, P, 3, vw),
                                             1.0 / math.sqrt(P * P * 3))},
            "class_embed": normal((vw,), 0.02),
            "pos_embed": normal((cfg.num_patches + 1, vw), 0.02),
            "ln_pre": {"scale": ones(vw), "bias": zeros(vw)},
            "blocks": _tower_init(cfg.vision, normal, zeros, ones),
            "ln_post": {"scale": ones(vw), "bias": zeros(vw)},
            "proj": normal((vw, cfg.embed_dim), 1.0 / math.sqrt(vw)),
        },
        "text": {
            "embed": {"table": normal((cfg.vocab_size, tw), 0.02)},
            "pos_embed": normal((cfg.max_text_len, tw), 0.01),
            "blocks": _tower_init(cfg.text, normal, zeros, ones),
            "ln_final": {"scale": ones(tw), "bias": zeros(tw)},
            "proj": normal((tw, cfg.embed_dim), 1.0 / math.sqrt(tw)),
        },
        "logit_scale": torch.tensor(float(np.float32(np.log(1 / 0.07))),
                                    device=dev).to(dtype),
    }


def encode_image(cfg: CLIPConfig, params, images: torch.Tensor
                 ) -> torch.Tensor:
    """images [B, H, W, 3] (NHWC) -> [B, embed_dim] (unnormalized)."""
    vp = params["visual"]
    dt = images.dtype
    P = cfg.patch_size
    x = F.conv2d(images.permute(0, 3, 1, 2),
                 vp["patch_embed"]["kernel"].permute(3, 2, 0, 1).to(dt),
                 stride=P)                               # [B, W, gh, gw]
    B = x.shape[0]
    x = x.permute(0, 2, 3, 1).reshape(B, -1, cfg.vision.width)
    cls = vp["class_embed"].to(dt).expand(B, 1, cfg.vision.width)
    x = torch.cat([cls, x], dim=1)
    x = x + vp["pos_embed"][:x.shape[1]].to(dt)
    x = L.layernorm(vp["ln_pre"], x, eps=cfg.eps)
    x = _tower_apply(cfg, cfg.vision, vp["blocks"], x, causal=False)
    pooled = L.layernorm(vp["ln_post"], x[:, 0], eps=cfg.eps)
    return pooled @ vp["proj"].to(dt)


def encode_text(cfg: CLIPConfig, params, input_ids: torch.Tensor
                ) -> torch.Tensor:
    """input_ids [B, S] -> [B, embed_dim]; pools at the EOT token, in
    CLIP's vocabulary the highest token id of the sequence."""
    tp = params["text"]
    x = L.embed(tp["embed"], input_ids)
    dt = x.dtype
    x = x + tp["pos_embed"][:x.shape[1]].to(dt)
    x = _tower_apply(cfg, cfg.text, tp["blocks"], x, causal=True)
    x = L.layernorm(tp["ln_final"], x, eps=cfg.eps)
    eot = torch.argmax(input_ids, dim=-1)
    pooled = x[torch.arange(x.shape[0], device=x.device), eot]
    return pooled @ tp["proj"].to(dt)


def similarity(cfg: CLIPConfig, params, images: torch.Tensor,
               input_ids: torch.Tensor):
    """(logits_per_image [B_img, B_txt], logits_per_text)."""
    ie = encode_image(cfg, params, images)
    te = encode_text(cfg, params, input_ids)
    ie = ie / torch.linalg.vector_norm(ie, dim=-1, keepdim=True)
    te = te / torch.linalg.vector_norm(te, dim=-1, keepdim=True)
    scale = torch.exp(params["logit_scale"]).to(ie.dtype)
    lpi = scale * ie @ te.T
    return lpi, lpi.T


class CLIP:
    """Model wrapper: the encode / similarity serving surface on one
    device (``device`` None is the card)."""

    def __init__(self, config: Optional[CLIPConfig] = None, seed: int = 0,
                 dtype: torch.dtype = torch.float32, *, device=None):
        dev = resolve_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        self.config = config or CLIPConfig()
        self.device = dev
        self.params = init_params(self.config, gen, dev, dtype)

    @classmethod
    def from_params(cls, config: CLIPConfig, params) -> "CLIP":
        self = cls.__new__(cls)
        self.config = config
        self.params = params
        self.device = params["text"]["embed"]["table"].device
        return self

    @torch.no_grad()
    def encode_image(self, images: torch.Tensor) -> torch.Tensor:
        return encode_image(self.config, self.params, images)

    @torch.no_grad()
    def encode_text(self, input_ids: torch.Tensor) -> torch.Tensor:
        return encode_text(self.config, self.params, input_ids)

    @torch.no_grad()
    def similarity(self, images: torch.Tensor, input_ids: torch.Tensor):
        return similarity(self.config, self.params, images, input_ids)
