"""The port's spatial ops (``ops/spatial.py``) held against the JAX
package's on the same numpy inputs: the three ``opt_bias_add`` variants,
``geglu``, ``nhwc_group_norm`` with its bias and residual pre-add (and
its output dtype), self and cross ``spatial_attention`` over NHWC and
[B, T, C] inputs, and one ``diffusers_transformer_block``.

Tolerance: |port - JAX| <= 2e-5 max|JAX| + 1e-6 (fp32, the same ops in
another summation order); the adds exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops import spatial as js
from deepspeed_tpu_torch.models import params_from_numpy
from deepspeed_tpu_torch.ops import spatial as ts
from tests.test_torch_train import one_thread  # noqa: F401 (autouse)


def _close(got, want, rel=2e-5):
    want = np.asarray(want)
    tol = rel * float(np.abs(want).max()) + 1e-6
    assert float(np.abs(np.asarray(got) - want).max()) <= tol


def _rand(r, *shape):
    return r.randn(*shape).astype(np.float32)


def _attn_params(r, c, kv):
    return {"wq": _rand(r, c, c) / np.sqrt(c), "wk": _rand(r, kv, c) /
            np.sqrt(kv), "wv": _rand(r, kv, c) / np.sqrt(kv),
            "wo": _rand(r, c, c) / np.sqrt(c), "bo": _rand(r, c) * 0.1}


def _both(tree):
    return (jax.tree.map(jnp.asarray, tree),
            params_from_numpy(tree, device="cpu"))


def test_opt_bias_add_variants():
    r = np.random.RandomState(0)
    x, o = _rand(r, 2, 4, 4, 8), _rand(r, 2, 4, 4, 8)
    b, ob = _rand(r, 8), _rand(r, 8)
    T = torch.from_numpy
    for args in ((b,), (b, o), (b, o, ob), (None, o)):
        want = js.opt_bias_add(jnp.asarray(x), *[
            None if a is None else jnp.asarray(a) for a in args])
        got = ts.opt_bias_add(T(x), *[None if a is None else T(a)
                                      for a in args])
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_geglu_exact_erf():
    r = np.random.RandomState(1)
    x, w, b = _rand(r, 2, 6, 8), _rand(r, 8, 32) / 3, _rand(r, 32)
    T = torch.from_numpy
    for bias in (None, b):
        want = js.geglu(jnp.asarray(x), jnp.asarray(w),
                        None if bias is None else jnp.asarray(bias))
        got = ts.geglu(T(x), T(w), None if bias is None else T(bias))
        _close(got.numpy(), want)


@pytest.mark.parametrize("pre_add", ["none", "bias", "bias_residual"])
def test_nhwc_group_norm(pre_add):
    r = np.random.RandomState(2)
    x = _rand(r, 2, 5, 6, 16) * 3 + 1
    gamma, beta = _rand(r, 16), _rand(r, 16)
    bias = _rand(r, 16) if pre_add != "none" else None
    res = _rand(r, 2, 5, 6, 16) if pre_add == "bias_residual" else None
    J = lambda a: None if a is None else jnp.asarray(a)      # noqa: E731
    T = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    want = js.nhwc_group_norm(J(x), J(gamma), J(beta), num_groups=4,
                              bias=J(bias), residual=J(res))
    got = ts.nhwc_group_norm(T(x), T(gamma), T(beta), num_groups=4,
                             bias=T(bias), residual=T(res))
    _close(got.numpy(), want)
    # statistics in fp32, the output in the input's dtype
    xb = T(x).to(torch.bfloat16)
    out = ts.nhwc_group_norm(xb, T(gamma), T(beta), num_groups=4,
                             bias=T(bias), residual=T(res))
    assert out.dtype == torch.bfloat16


@pytest.mark.parametrize("layout, cross", [("nhwc", False), ("nhwc", True),
                                           ("tokens", True)])
def test_spatial_attention(layout, cross):
    r = np.random.RandomState(3)
    C, ctx_dim = 16, 12
    x = _rand(r, 2, 4, 3, C) if layout == "nhwc" else _rand(r, 2, 7, C)
    ctx = _rand(r, 2, 5, ctx_dim) if cross else None
    jp, tp = _both(_attn_params(r, C, ctx_dim if cross else C))
    want = js.spatial_attention(jnp.asarray(x), jp, 4, context=None
                                if ctx is None else jnp.asarray(ctx))
    got = ts.spatial_attention(torch.from_numpy(x), tp, 4, context=None
                               if ctx is None else torch.from_numpy(ctx))
    assert got.shape == x.shape
    _close(got.numpy(), want)


def test_diffusers_transformer_block():
    r = np.random.RandomState(4)
    C, ctx_dim = 16, 12

    def ln():
        return {"scale": 1 + 0.1 * _rand(r, C), "bias": 0.1 * _rand(r, C)}

    tree = {"ln1": ln(), "ln2": ln(), "ln3": ln(),
            "attn1": _attn_params(r, C, C),
            "attn2": _attn_params(r, C, ctx_dim),
            "ff": {"wi": _rand(r, C, 8 * C) / 4, "bi": _rand(r, 8 * C) * .1,
                   "wo": _rand(r, 4 * C, C) / 8, "bo": _rand(r, C) * .1}}
    jp, tp = _both(tree)
    x, ctx = _rand(r, 2, 4, 4, C), _rand(r, 2, 5, ctx_dim)
    want = js.diffusers_transformer_block(jnp.asarray(x), jp, 4,
                                          context=jnp.asarray(ctx))
    got = ts.diffusers_transformer_block(torch.from_numpy(x), tp, 4,
                                         context=torch.from_numpy(ctx))
    _close(got.numpy(), want)
