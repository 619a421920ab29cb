"""The port's UNet and VAE (``models/diffusion.py``) held against the JAX
package's on the same weights (drawn by the port, carried to the JAX
class through numpy; the tree held against the JAX initializer's key for
key and shape for shape) and the same numpy inputs: ``tests/test_diffusion.py``'s
``tiny_unet`` and its SD-shaped 4-stage variant (the output, and that
context and timestep change it), its three-step classifier-free-guidance
loop, and the VAE at (16, 32, 32) channels: encode (the mean, and a
posterior sampled with the same threefry key) and decode.  And the weight
carrier on the UNet's tree, lists and bf16 leaves included.

Tolerance: a whole model |port - JAX| <= 1e-4 max|JAX| (fp32, the same
convolutions and products in another summation order); the carried tree
bitwise."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models import diffusion as jd
from deepspeed_tpu_torch.models import diffusion as td
from deepspeed_tpu_torch.models import params_from_numpy
from deepspeed_tpu_torch.utils.prng import key_from_numpy
from tests.test_torch_train import one_thread  # noqa: F401 (autouse)

TINY = dict(block_out_channels=(32, 64, 64), layers_per_block=1,
            cross_attention_dim=48, attention_head_dim=4, num_groups=8)
SD_SHAPED = dict(TINY, block_out_channels=(32, 64, 128, 128),
                 layers_per_block=2)
VAE = dict(block_out_channels=(16, 32, 32), layers_per_block=1,
           num_groups=8)


def _close(got, want, rel=1e-4):
    want = np.asarray(want)
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= rel * float(np.abs(want).max()), err


def _numpy(tree):
    return jax.tree.map(lambda t: t.numpy(), tree)


def _pair(jcls, tcls, jcfg_cls, tcfg_cls, over, seed=0):
    """(JAX model, port model) on the same weights: drawn by the port (fp32,
    on the CPU), carried to the JAX class through numpy, its tree held
    against the JAX initializer's, key for key and shape for shape (under
    ``jax.eval_shape``: the JAX initializer runs op by op, ~10 s a model
    on the CPU)."""
    t = tcls(tcfg_cls(**over), seed=seed, device="cpu")
    want = jax.eval_shape(lambda: jcls(jcfg_cls(**over)).params)
    got = jax.tree.map(lambda x: jax.ShapeDtypeStruct(tuple(x.shape),
                                                      jnp.float32),
                       _numpy(t.params))
    assert jax.tree.structure(got) == jax.tree.structure(want)
    assert jax.tree.leaves(got) == jax.tree.leaves(want)
    j = jcls.__new__(jcls)
    j.config = jcfg_cls(**over)
    j.params = jax.tree.map(jnp.asarray, _numpy(t.params))
    if jcls is jd.UNet2DCondition:
        j._step = jax.jit(j._forward)
    else:
        j._encode, j._decode = jax.jit(j._enc_fwd), jax.jit(j._dec_fwd)
    return j, tcls.from_params(tcfg_cls(**over), params_from_numpy(
        _numpy(t.params), device="cpu"))


@pytest.fixture(scope="module")
def unets():
    """(JAX tiny UNet, its port) shared by the module's tests."""
    return _pair(jd.UNet2DCondition, td.UNet2DCondition, jd.UNetConfig,
                 td.UNetConfig, TINY)


def _inputs(seed, hw, ctx_len=5):
    r = np.random.RandomState(seed)
    return (r.randn(1, hw, hw, 4).astype(np.float32),
            r.randn(1, ctx_len, 48).astype(np.float32))


def test_unet_matches_jax_and_is_conditioned(unets):
    j, t = unets
    lat, ctx = _inputs(0, 16)
    ctx2 = np.random.RandomState(9).randn(*ctx.shape).astype(np.float32)
    outs = {}
    for name, steps, c in (("base", 50, ctx), ("ctx", 50, ctx2),
                           ("time", 900, ctx)):
        want = j(jnp.asarray(lat), jnp.asarray([steps]), jnp.asarray(c))
        got = t(torch.from_numpy(lat), torch.tensor([steps]),
                torch.from_numpy(c))
        assert got.shape == lat.shape
        _close(got.numpy(), want)
        outs[name] = got
    # cross attention and the timestep embedding are live
    assert float((outs["base"] - outs["ctx"]).abs().max()) > 1e-6
    assert float((outs["base"] - outs["time"]).abs().max()) > 1e-6


def test_sd_shaped_unet_matches_jax():
    """4 stages, 2 res layers a block, cross-attention transformers at the
    three shallower stages, /8 downsampling (odd sizes pad SAME)."""
    j, t = _pair(jd.UNet2DCondition, td.UNet2DCondition, jd.UNetConfig,
                 td.UNetConfig, SD_SHAPED, seed=1)
    lat, ctx = _inputs(1, 32, ctx_len=7)
    want = j(jnp.asarray(lat), jnp.asarray([10]), jnp.asarray(ctx))
    got = t(torch.from_numpy(lat), torch.tensor([10]), torch.from_numpy(ctx))
    _close(got.numpy(), want)


def test_cfg_denoise_loop_matches_jax(unets):
    """tests/test_diffusion.py's loop: uncond + cond in one batch, guidance
    7.5, a toy update, three steps; each package from the same latents."""
    j, t = unets
    r = np.random.RandomState(3)
    lat = r.randn(1, 16, 16, 4).astype(np.float32)
    cond = r.randn(1, 5, 48).astype(np.float32)
    ctx2 = np.concatenate([np.zeros_like(cond), cond])
    jl, tl = jnp.asarray(lat), torch.from_numpy(lat)
    jc, tc = jnp.asarray(ctx2), torch.from_numpy(ctx2)
    for step in (800, 500, 200):
        e_un, e_c = jnp.split(j(jnp.concatenate([jl, jl]),
                                jnp.full((2,), step), jc), 2)
        jl = jl - 0.1 * (e_un + 7.5 * (e_c - e_un))
        t_un, t_c = t(torch.cat([tl, tl]), torch.full((2,), step),
                      tc).chunk(2)
        tl = tl - 0.1 * (t_un + 7.5 * (t_c - t_un))
        _close(tl.numpy(), jl)


def test_vae_matches_jax():
    jv, tv = _pair(jd.AutoencoderKL, td.AutoencoderKL, jd.VAEConfig,
                   td.VAEConfig, VAE, seed=2)
    img = np.random.RandomState(0).randn(1, 32, 32, 3).astype(np.float32)
    ji, ti = jnp.asarray(img), torch.from_numpy(img)
    jz = jv.encode(ji)
    tz = tv.encode(ti)
    assert tz.shape == (1, 8, 8, 4)
    _close(tz.numpy(), jz)
    key = jax.random.PRNGKey(5)
    js = jv.encode(ji, rng=key)
    ts = tv.encode(ti, rng=key_from_numpy(np.asarray(key)))
    _close(ts.numpy(), js)
    assert float((ts - tz).abs().max()) > 0              # sampled
    _close(tv.decode(tz).numpy(), jv.decode(jz))


def test_params_from_numpy_carries_the_unet_tree_bitwise(unets):
    """The UNet's tree holds lists (``time_mlp``, ``res``, ``tx``,
    ``blocks``, ``downs``, ``ups``): the carrier keeps every container's
    type and every leaf's bits, bf16 leaves included."""
    j, _ = unets
    tree = jax.tree.map(np.asarray, j.params)
    tree["time_mlp"] = tuple(tree["time_mlp"])
    tree["ups"][0]["res"] = [jax.tree.map(
        lambda x: x.astype(jnp.bfloat16), rp) for rp in tree["ups"][0]["res"]]
    got = params_from_numpy(tree, device="cpu")

    def walk(a, b):
        if isinstance(a, (dict, list, tuple)):
            assert type(a) is type(b)
        if isinstance(a, dict):
            assert sorted(a) == sorted(b)
            for k in a:
                walk(a[k], b[k])
        elif isinstance(a, (list, tuple)):
            assert len(a) == len(b)
            for x, y in zip(a, b):
                walk(x, y)
        else:
            n = {"bfloat16": np.uint16, "float32": np.uint32}[a.dtype.name]
            assert b.dtype == {np.uint16: torch.bfloat16,
                               np.uint32: torch.float32}[n]
            np.testing.assert_array_equal(
                b.view({np.uint16: torch.int16,
                        np.uint32: torch.int32}[n]).numpy().view(n),
                a.view(n))

    walk(tree, got)
