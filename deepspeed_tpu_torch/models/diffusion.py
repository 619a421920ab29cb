"""Stable-Diffusion-class UNet and VAE (the diffusers serving family).

Counterpart of ``deepspeed_tpu/models/diffusion.py``: ``UNet2DCondition``
(conv-in, down stages of ResBlocks and spatial transformers, the middle
block, up stages with skip concatenation and 2x nearest upsampling,
GroupNorm/SiLU/conv-out) and ``AutoencoderKL`` (encode to a diagonal
Gaussian posterior, decode), on the spatial ops of ``ops/spatial.py``.
The JAX package runs them on plain XLA ops; here they are plain PyTorch
ops, run eagerly (the JAX package jits each forward).

The parameter tree keeps the JAX package's names and layouts: convolution
kernels HWIO ``[kh, kw, cin, cout]``, activations NHWC, the stage lists as
Python lists, so :func:`~.transformer.params_from_numpy` carries a JAX tree
over bit for bit.  :func:`conv2d` turns the kernel to OIHW and the
activations to a channels-last NCHW view inside the call; XLA's "SAME"
padding (the extra row and column after, at stride 2) is kept.

Weights are drawn from a ``torch.Generator`` on the model's device with
the JAX package's shapes and init scales; the values differ from the JAX
package's for the same seed.  The VAE's sampled posterior draws its noise
with the port's threefry (``utils/prng.normal``), so the same key gives
the JAX package's noise.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from ..ops.spatial import (diffusers_transformer_block, nhwc_group_norm,
                           spatial_attention)
from ..platform.cuda import resolve_device
from ..utils.prng import normal

silu = F.silu


# --------------------------------------------------------------------------
# shared building blocks
# --------------------------------------------------------------------------

def _same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA's "SAME" padding of one spatial dim: (before, after)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv2d(x: torch.Tensor, p, stride: int = 1) -> torch.Tensor:
    """NHWC conv with "SAME" padding, kernel ``[kh, kw, cin, cout]`` (+
    bias ``[cout]``)."""
    w = p["kernel"]
    kh, kw = w.shape[0], w.shape[1]
    ph, pw = _same_pads(x.shape[1], kh, stride), _same_pads(x.shape[2], kw,
                                                            stride)
    xc = x.permute(0, 3, 1, 2)                 # NCHW view, channels last
    if ph[0] != ph[1] or pw[0] != pw[1]:
        xc = F.pad(xc, (pw[0], pw[1], ph[0], ph[1]))
        pad = 0
    else:
        pad = (ph[0], pw[0])
    y = F.conv2d(xc, w.permute(3, 2, 0, 1).to(x.dtype), stride=stride,
                 padding=pad)
    y = y.permute(0, 2, 3, 1)
    return y + p["bias"] if "bias" in p else y


def dense(x: torch.Tensor, p) -> torch.Tensor:
    return x @ p["kernel"].to(x.dtype) + p["bias"].to(x.dtype)


def timestep_embedding(t: torch.Tensor, dim: int,
                       max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal timestep features [B, dim] fp32: cos first, then sin
    (diffusers' ``get_timestep_embedding`` with ``flip_sin_to_cos``)."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    ang = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1)


def resblock(x, p, temb=None, num_groups: int = 32, eps: float = 1e-5):
    """ResnetBlock2D: GN, SiLU, conv, (+ time projection), GN, SiLU,
    conv, residual (a 1x1 shortcut where the channels change)."""
    h = silu(nhwc_group_norm(x, p["gn1"]["scale"], p["gn1"]["bias"],
                             num_groups=num_groups, eps=eps))
    h = conv2d(h, p["conv1"])
    if temb is not None and "time" in p:
        h = h + dense(silu(temb), p["time"])[:, None, None, :]
    h = silu(nhwc_group_norm(h, p["gn2"]["scale"], p["gn2"]["bias"],
                             num_groups=num_groups, eps=eps))
    h = conv2d(h, p["conv2"])
    skip = conv2d(x, p["shortcut"]) if "shortcut" in p else x
    return skip + h


def spatial_transformer(x, p, num_heads: int, context=None,
                        num_groups: int = 32, eps: float = 1e-5):
    """Transformer2DModel: GN, 1x1 proj-in, the GEGLU blocks over H*W
    tokens, 1x1 proj-out, residual."""
    h = nhwc_group_norm(x, p["gn"]["scale"], p["gn"]["bias"],
                        num_groups=num_groups, eps=1e-6)
    h = conv2d(h, p["proj_in"])
    for bp in p["blocks"]:
        h = diffusers_transformer_block(h, bp, num_heads, context=context,
                                        eps=eps)
    h = conv2d(h, p["proj_out"])
    return x + h


def upsample2x(h: torch.Tensor) -> torch.Tensor:
    """2x nearest upsampling of NHWC (``jax.image.resize(..., "nearest")``
    at an exact factor of 2 takes source row i // 2)."""
    return h.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


class _Init:
    """The JAX package's initializers, drawn from one generator."""

    def __init__(self, gen: torch.Generator, device, dtype):
        self.gen, self.device, self.dtype = gen, device, dtype

    def normal(self, shape, scale):
        x = torch.randn(shape, generator=self.gen, device=self.device,
                        dtype=self.dtype)
        return x.mul_(scale)

    def zeros(self, *shape):
        return torch.zeros(shape, device=self.device, dtype=self.dtype)

    def ones(self, *shape):
        return torch.ones(shape, device=self.device, dtype=self.dtype)

    def norm(self, c):
        return {"scale": self.ones(c), "bias": self.zeros(c)}

    def conv(self, kh, kw, cin, cout, scale=None):
        scale = scale if scale is not None else 1.0 / math.sqrt(
            kh * kw * cin)
        return {"kernel": self.normal((kh, kw, cin, cout), scale),
                "bias": self.zeros(cout)}

    def dense(self, cin, cout):
        return {"kernel": self.normal((cin, cout), 1.0 / math.sqrt(cin)),
                "bias": self.zeros(cout)}

    def resblock(self, cin, cout, temb_dim: Optional[int]):
        p = {"gn1": self.norm(cin), "conv1": self.conv(3, 3, cin, cout),
             "gn2": self.norm(cout),
             "conv2": self.conv(3, 3, cout, cout, scale=1e-3)}
        if temb_dim is not None:
            p["time"] = self.dense(temb_dim, cout)
        if cin != cout:
            p["shortcut"] = self.conv(1, 1, cin, cout)
        return p

    def attn(self, c, ctx_dim=None):
        kv = ctx_dim if ctx_dim is not None else c
        return {"wq": self.normal((c, c), 1.0 / math.sqrt(c)),
                "wk": self.normal((kv, c), 1.0 / math.sqrt(kv)),
                "wv": self.normal((kv, c), 1.0 / math.sqrt(kv)),
                "wo": self.normal((c, c), 1.0 / math.sqrt(c)),
                "bo": self.zeros(c)}

    def txblock(self, c, ctx_dim, ff_mult: int = 4):
        return {"ln1": self.norm(c), "ln2": self.norm(c),
                "ln3": self.norm(c), "attn1": self.attn(c),
                "attn2": self.attn(c, ctx_dim),
                "ff": {"wi": self.normal((c, 2 * ff_mult * c),
                                         1.0 / math.sqrt(c)),
                       "bi": self.zeros(2 * ff_mult * c),
                       "wo": self.normal((ff_mult * c, c),
                                         1.0 / math.sqrt(ff_mult * c)),
                       "bo": self.zeros(c)}}

    def spatial_tx(self, c, ctx_dim, depth: int = 1):
        return {"gn": self.norm(c), "proj_in": self.conv(1, 1, c, c),
                "blocks": [self.txblock(c, ctx_dim) for _ in range(depth)],
                "proj_out": self.conv(1, 1, c, c, scale=1e-3)}


def _initializer(seed: int, device, dtype) -> Tuple[_Init, torch.device]:
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return _Init(gen, dev, dtype), dev


# --------------------------------------------------------------------------
# UNet2DCondition (SD-1.x shape)
# --------------------------------------------------------------------------

@dataclasses.dataclass
class UNetConfig:
    """SD-1.x defaults (runwayml/stable-diffusion-v1-5's unet config);
    shrink the channel tuple for tests."""
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    cross_attention_dim: int = 768
    # SD-1.x quirk: diffusers' attention_head_dim=8 acts as the HEAD
    # COUNT (head dim = C/8), constant across stages
    attention_head_dim: int = 8
    num_groups: int = 32
    tx_depth: int = 1

    def heads(self, c: int) -> int:
        n = self.attention_head_dim
        if c % n:
            raise ValueError(f"stage channels {c} must divide by "
                             f"attention_head_dim={n} (SD quirk: that "
                             "field is the HEAD COUNT)")
        return n


class UNet2DCondition:
    """Conditional denoising UNet: ``__call__(latents [B, H, W, Cin],
    timesteps [B], context [B, T, ctx]) -> eps [B, H, W, Cout]``.
    ``device`` None is the card."""

    def __init__(self, config: Optional[UNetConfig] = None, seed: int = 0,
                 dtype: torch.dtype = torch.float32, *, device=None):
        cfg = self.config = config or UNetConfig()
        init, self.device = _initializer(seed, device, dtype)
        ch = cfg.block_out_channels
        for c in ch:                # every stage's width has a transformer
            cfg.heads(c)
        temb = ch[0] * 4
        p: Dict[str, Any] = {
            "time_mlp": [init.dense(ch[0], temb), init.dense(temb, temb)],
            "conv_in": init.conv(3, 3, cfg.in_channels, ch[0]),
        }
        downs: List[Dict] = []
        c = ch[0]
        skip_chs = [c]
        for si, cout in enumerate(ch):
            stage: Dict[str, Any] = {"res": [], "tx": []}
            last = si == len(ch) - 1
            for _ in range(cfg.layers_per_block):
                stage["res"].append(init.resblock(c, cout, temb))
                c = cout
                if not last:        # SD: no attention at the deepest res
                    stage["tx"].append(init.spatial_tx(
                        c, cfg.cross_attention_dim, cfg.tx_depth))
                skip_chs.append(c)
            if not last:
                stage["down"] = init.conv(3, 3, c, c)
                skip_chs.append(c)
            downs.append(stage)
        p["downs"] = downs
        p["mid"] = {"res1": init.resblock(c, c, temb),
                    "tx": init.spatial_tx(c, cfg.cross_attention_dim,
                                          cfg.tx_depth),
                    "res2": init.resblock(c, c, temb)}
        ups: List[Dict] = []
        for si, cout in enumerate(reversed(ch)):
            stage = {"res": [], "tx": []}
            for _ in range(cfg.layers_per_block + 1):
                stage["res"].append(init.resblock(c + skip_chs.pop(), cout,
                                                  temb))
                c = cout
                if si != 0:         # mirrors the down stages
                    stage["tx"].append(init.spatial_tx(
                        c, cfg.cross_attention_dim, cfg.tx_depth))
            if si != len(ch) - 1:
                stage["up"] = init.conv(3, 3, c, c)
            ups.append(stage)
        p["ups"] = ups
        p["gn_out"] = init.norm(c)
        p["conv_out"] = init.conv(3, 3, c, cfg.out_channels, scale=1e-3)
        self.params = p

    @classmethod
    def from_params(cls, config: UNetConfig, params) -> "UNet2DCondition":
        """Wrap an existing tree (e.g. carried from the JAX package); the
        device is the one the parameters live on."""
        self = cls.__new__(cls)
        self.config, self.params = config, params
        self.device = params["conv_in"]["kernel"].device
        return self

    @torch.no_grad()
    def __call__(self, latents: torch.Tensor, timesteps: torch.Tensor,
                 context: torch.Tensor) -> torch.Tensor:
        return unet_forward(self.config, self.params, latents, timesteps,
                            context)


def unet_forward(cfg: UNetConfig, params, latents, timesteps, context):
    g = cfg.num_groups
    temb = timestep_embedding(timesteps, cfg.block_out_channels[0])
    temb = dense(silu(dense(temb.to(latents.dtype), params["time_mlp"][0])),
                 params["time_mlp"][1])
    h = conv2d(latents, params["conv_in"])
    skips = [h]
    for stage in params["downs"]:
        for ri, rp in enumerate(stage["res"]):
            h = resblock(h, rp, temb, g)
            if stage["tx"]:
                h = spatial_transformer(h, stage["tx"][ri],
                                        cfg.heads(h.shape[-1]), context, g)
            skips.append(h)
        if "down" in stage:
            h = conv2d(h, stage["down"], stride=2)
            skips.append(h)
    m = params["mid"]
    h = resblock(h, m["res1"], temb, g)
    h = spatial_transformer(h, m["tx"], cfg.heads(h.shape[-1]), context, g)
    h = resblock(h, m["res2"], temb, g)
    for stage in params["ups"]:
        for ri, rp in enumerate(stage["res"]):
            h = resblock(torch.cat([h, skips.pop()], dim=-1), rp, temb, g)
            if stage["tx"]:
                h = spatial_transformer(h, stage["tx"][ri],
                                        cfg.heads(h.shape[-1]), context, g)
        if "up" in stage:
            h = conv2d(upsample2x(h), stage["up"])
    h = silu(nhwc_group_norm(h, params["gn_out"]["scale"],
                             params["gn_out"]["bias"], num_groups=g))
    return conv2d(h, params["conv_out"])


# --------------------------------------------------------------------------
# AutoencoderKL (VAE)
# --------------------------------------------------------------------------

@dataclasses.dataclass
class VAEConfig:
    """SD-1.x's AutoencoderKL (runwayml/stable-diffusion-v1-5's vae)."""
    in_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    num_groups: int = 32
    scaling_factor: float = 0.18215


def _vae_attn(x, p, num_groups):
    h = nhwc_group_norm(x, p["gn"]["scale"], p["gn"]["bias"],
                        num_groups=num_groups, eps=1e-6)
    return x + spatial_attention(h, p, num_heads=1)


class AutoencoderKL:
    """VAE: ``encode(images [B, H, W, 3], rng=None)`` -> latents [B, H/f,
    W/f, latent_channels] (f = 2^(stages - 1)), the mean, or a posterior
    sample when ``rng`` (a threefry key) is given, times
    ``scaling_factor``; ``decode(latents)`` -> images.  ``device`` None is
    the card."""

    def __init__(self, config: Optional[VAEConfig] = None, seed: int = 0,
                 dtype: torch.dtype = torch.float32, *, device=None):
        cfg = self.config = config or VAEConfig()
        init, self.device = _initializer(seed, device, dtype)
        ch = cfg.block_out_channels

        def mid(c):
            a = init.attn(c)
            a["gn"] = init.norm(c)
            return {"res1": init.resblock(c, c, None), "attn": a,
                    "res2": init.resblock(c, c, None)}

        enc: Dict[str, Any] = {
            "conv_in": init.conv(3, 3, cfg.in_channels, ch[0])}
        c = ch[0]
        stages = []
        for si, cout in enumerate(ch):
            st = {"res": [init.resblock(c if i == 0 else cout, cout, None)
                          for i in range(cfg.layers_per_block)]}
            c = cout
            if si != len(ch) - 1:
                st["down"] = init.conv(3, 3, c, c)
            stages.append(st)
        enc["stages"] = stages
        enc["mid"] = mid(c)
        enc["gn_out"] = init.norm(c)
        enc["conv_out"] = init.conv(3, 3, c, 2 * cfg.latent_channels)
        dec: Dict[str, Any] = {
            "conv_in": init.conv(3, 3, cfg.latent_channels, c),
            "mid": mid(c)}
        dstages = []
        for si, cout in enumerate(reversed(ch)):
            st = {"res": [init.resblock(c if i == 0 else cout, cout, None)
                          for i in range(cfg.layers_per_block + 1)]}
            c = cout
            if si != len(ch) - 1:
                st["up"] = init.conv(3, 3, c, c)
            dstages.append(st)
        dec["stages"] = dstages
        dec["gn_out"] = init.norm(c)
        dec["conv_out"] = init.conv(3, 3, c, cfg.in_channels)
        self.params = {"enc": enc, "dec": dec}

    @classmethod
    def from_params(cls, config: VAEConfig, params) -> "AutoencoderKL":
        self = cls.__new__(cls)
        self.config, self.params = config, params
        self.device = params["enc"]["conv_in"]["kernel"].device
        return self

    def _enc_fwd(self, images):
        g = self.config.num_groups
        e = self.params["enc"]
        h = conv2d(images, e["conv_in"])
        for st in e["stages"]:
            for rp in st["res"]:
                h = resblock(h, rp, None, g)
            if "down" in st:
                h = conv2d(h, st["down"], stride=2)
        m = e["mid"]
        h = resblock(h, m["res1"], None, g)
        h = _vae_attn(h, m["attn"], g)
        h = resblock(h, m["res2"], None, g)
        h = silu(nhwc_group_norm(h, e["gn_out"]["scale"],
                                 e["gn_out"]["bias"], num_groups=g))
        mean, logvar = conv2d(h, e["conv_out"]).chunk(2, dim=-1)
        return mean, logvar

    def _dec_fwd(self, latents):
        g = self.config.num_groups
        d = self.params["dec"]
        h = conv2d(latents, d["conv_in"])
        m = d["mid"]
        h = resblock(h, m["res1"], None, g)
        h = _vae_attn(h, m["attn"], g)
        h = resblock(h, m["res2"], None, g)
        for st in d["stages"]:
            for rp in st["res"]:
                h = resblock(h, rp, None, g)
            if "up" in st:
                h = conv2d(upsample2x(h), st["up"])
        h = silu(nhwc_group_norm(h, d["gn_out"]["scale"],
                                 d["gn_out"]["bias"], num_groups=g))
        return conv2d(h, d["conv_out"])

    @torch.no_grad()
    def encode(self, images: torch.Tensor,
               rng: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The posterior mean, or with ``rng`` (a threefry key,
        ``utils.prng``) ``mean + exp(logvar / 2) * normal(rng)``: the noise
        is drawn in fp32 (``jax.random.normal``'s bits) and cast to the
        latents' dtype."""
        mean, logvar = self._enc_fwd(images)
        z = mean
        if rng is not None:
            eps = normal(rng.to(mean.device), tuple(mean.shape))
            z = mean + torch.exp(0.5 * logvar) * eps.to(mean.dtype)
        return z * self.config.scaling_factor

    @torch.no_grad()
    def decode(self, latents: torch.Tensor) -> torch.Tensor:
        return self._dec_fwd(latents / self.config.scaling_factor)
