"""The model families and attention variants of the port on the card, in
bf16 against their fp32 runs.

Marked ``cuda``: without a CUDA device every test here skips (what is
held is the card's own bf16 arithmetic: its GEMMs, convolutions and
reductions, which the CPU does not run).  At small widths: the BERT-class
encoder's ``encode_batch`` (CLS and mean), CLIP's ``similarity``, the UNet
and the VAE's decode; ``fused_attention``'s, ``evoformer_attention``'s
and ``block_sparse_attention``'s outputs and gradients against autograd
through their plain formulas.  The rule, chip_smoke.py's: the bf16 result
lies within NOISE_FACTOR x the bf16 noise floor of the fp32 result, the
floor being the distance of an independent bf16 evaluation (each sample
alone; the plain formula) from the fp32 one.  This file imports neither
JAX nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_families_cuda.py
"""

import math

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.models import (CLIP, AutoencoderKL, CLIPConfig,
                                        Encoder, EncoderConfig,
                                        UNet2DCondition, UNetConfig,
                                        VAEConfig)
from deepspeed_tpu_torch.models.clip import CLIPTowerConfig
from deepspeed_tpu_torch.models.layers import causal_attention
from deepspeed_tpu_torch.models.transformer import tree_map
from deepspeed_tpu_torch.ops import (BSLongformerSparsityConfig,
                                     evoformer_attention, fused_attention,
                                     make_block_sparse_attention)

NOISE_FACTOR = 2.0


@pytest.fixture(autouse=True)
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the card's bf16 arithmetic)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def within_noise(name, got, ref, wide):
    """max|got - wide| <= NOISE_FACTOR x max|ref - wide| (in fp64)."""
    assert bool(torch.isfinite(got).all()), name
    noise = float((ref.double() - wide.double()).abs().max())
    err = float((got.double() - wide.double()).abs().max())
    assert err <= NOISE_FACTOR * noise, f"{name}: {err} > {NOISE_FACTOR} x " \
        f"{noise}"


def _as(tree, dtype):
    return tree_map(lambda x: x.to(dtype), tree)


@pytest.mark.cuda
def test_encoder_bf16():
    cfg = EncoderConfig(vocab_size=512, d_model=128, num_layers=2,
                        num_heads=4, max_seq_len=128)
    e32 = Encoder(cfg, seed=0, device="cuda")
    e16 = Encoder.from_params(cfg, _as(e32.params, torch.bfloat16))
    r = np.random.RandomState(0)
    reqs = [list(map(int, r.randint(1, 512, n))) for n in (100, 7, 64, 33)]
    for pool in ("cls", "mean"):
        got = e16.encode_batch(reqs, pool=pool)
        ref = torch.cat([e16.encode_batch([q], pool=pool) for q in reqs])
        within_noise(f"encoder {pool}", got, ref,
                     e32.encode_batch(reqs, pool=pool))


@pytest.mark.cuda
def test_clip_bf16():
    tower = CLIPTowerConfig(width=128, num_layers=2, num_heads=4)
    cfg = CLIPConfig(embed_dim=64, image_size=64, patch_size=16,
                     vocab_size=512, max_text_len=16, vision=tower,
                     text=tower)
    m32 = CLIP(cfg, seed=0, device="cuda")
    m16 = CLIP.from_params(cfg, _as(m32.params, torch.bfloat16))
    g = torch.Generator(device="cuda").manual_seed(1)
    imgs = torch.randn((4, 64, 64, 3), generator=g, device="cuda")
    ids = torch.randint(1, 500, (3, 16), generator=g, device="cuda")
    ids[:, -1] = 511
    got, _ = m16.similarity(imgs.bfloat16(), ids)
    ref = torch.cat([m16.similarity(imgs[i:i + 1].bfloat16(), ids)[0]
                     for i in range(4)])
    within_noise("clip", got, ref, m32.similarity(imgs, ids)[0])


@pytest.mark.cuda
def test_unet_and_vae_bf16():
    ucfg = UNetConfig(block_out_channels=(32, 64, 64), layers_per_block=1,
                      cross_attention_dim=48, attention_head_dim=4,
                      num_groups=8)
    u32 = UNet2DCondition(ucfg, seed=0, device="cuda")
    u16 = UNet2DCondition.from_params(ucfg, _as(u32.params, torch.bfloat16))
    g = torch.Generator(device="cuda").manual_seed(2)
    lat = torch.randn((2, 32, 32, 4), generator=g, device="cuda")
    ctx = torch.randn((2, 7, 48), generator=g, device="cuda")
    t = torch.tensor([999, 500], device="cuda")
    got = u16(lat.bfloat16(), t, ctx.bfloat16())
    ref = torch.cat([u16(lat[i:i + 1].bfloat16(), t[i:i + 1],
                         ctx[i:i + 1].bfloat16()) for i in range(2)])
    within_noise("unet", got, ref, u32(lat, t, ctx))
    vcfg = VAEConfig(block_out_channels=(32, 64, 64), layers_per_block=1,
                     num_groups=8)
    v32 = AutoencoderKL(vcfg, seed=0, device="cuda")
    v16 = AutoencoderKL.from_params(vcfg, _as(v32.params, torch.bfloat16))
    z = torch.randn((2, 16, 16, 4), generator=g, device="cuda") * 0.2
    got = v16.decode(z.bfloat16())
    ref = torch.cat([v16.decode(z[i:i + 1].bfloat16()) for i in range(2)])
    within_noise("vae decode", got, ref, v32.decode(z))


def _grads(fn, inputs, do):
    xs = [x.detach().requires_grad_() for x in inputs]
    o = fn(*xs)
    return [o.detach(), *torch.autograd.grad(o, xs, do.to(o.dtype))]


def _check(name, fast, plain, inputs, do):
    """fast in bf16 against plain in bf16 and in fp32 (the bf16 inputs
    widened): output and every gradient."""
    b16 = [x.bfloat16() for x in inputs]
    got = _grads(fast, b16, do)
    ref = _grads(plain, b16, do)
    wide = _grads(plain, [x.float() for x in b16], do)
    for i, (a, b, c) in enumerate(zip(got, ref, wide)):
        within_noise(f"{name}[{i}]", a, b, c)


@pytest.mark.cuda
def test_fused_attention_bf16_gradients():
    g = torch.Generator(device="cuda").manual_seed(3)
    B, S, H, Hkv, D = 2, 256, 8, 2, 64
    q = torch.randn((B, S, H, D), generator=g, device="cuda")
    k, v = (torch.randn((B, S, Hkv, D), generator=g, device="cuda")
            for _ in range(2))
    do = torch.randn((B, S, H, D), generator=g, device="cuda")
    _check("fused_attention", fused_attention, causal_attention, [q, k, v],
           do)


def _evo_plain(Q, K, V, b1, b2):
    s = torch.einsum("bnqhd,bnkhd->bnhqk", Q, K).float() / math.sqrt(
        Q.shape[-1])
    p = torch.softmax(s + b1.float() + b2.float(), -1).to(Q.dtype)
    return torch.einsum("bnhqk,bnkhd->bnqhd", p, V)


@pytest.mark.cuda
def test_evoformer_bf16_gradients():
    g = torch.Generator(device="cuda").manual_seed(4)
    B, N, S, H, D = 1, 8, 64, 4, 32
    Q, K, V = (torch.randn((B, N, S, H, D), generator=g, device="cuda")
               for _ in range(3))
    b1 = torch.where(torch.rand((B, N, 1, 1, S), generator=g,
                                device="cuda") < 0.1, -1e4, 0.0)
    b2 = torch.randn((B, 1, H, S, S), generator=g, device="cuda")
    do = torch.randn((B, N, S, H, D), generator=g, device="cuda")
    _check("evoformer", lambda Q, K, V, b1, b2: evoformer_attention(
        Q, K, V, [b1, b2]), _evo_plain, [Q, K, V, b1, b2], do)


@pytest.mark.cuda
def test_block_sparse_bf16_gradients():
    cfg = BSLongformerSparsityConfig(block=64)
    S = 512
    lay = cfg.make_layout(S // 64)
    token = torch.from_numpy(np.kron(lay, np.ones((64, 64), bool))).cuda()
    bias = torch.where(token, 0.0, -1e30)[None]       # [1, S, S]

    def plain(q, k, v):
        H = q.shape[2]
        return causal_attention(q, k, v, bias=bias.expand(H, S, S))

    g = torch.Generator(device="cuda").manual_seed(5)
    q, k, v, do = (torch.randn((2, S, 4, 64), generator=g, device="cuda")
                   for _ in range(4))
    _check("block_sparse", make_block_sparse_attention(cfg), plain,
           [q, k, v], do)
