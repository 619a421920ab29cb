"""The port's block-sparse attention (``ops/sparse_attention.py``) held
against the JAX package's on the same numpy inputs: every layout class
equal to JAX's as arrays (BigBird's random blocks from the same seed),
``density``; ``block_sparse_attention`` outputs and dq/dk/dv under the
Fixed, BSLongformer and BigBird layouts (GQA rep 2); the Dense layout
equal to causal attention; and ``make_block_sparse_attention``'s three
refusals (a padding mask, ``causal=False``, a length the block does not
divide), and a tiny model training through it.

Tolerance: a single op |port - JAX| <= 2e-5 max|JAX| + 1e-6 (fp32, the
same products in another summation order); layouts exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops import sparse_attention as js
from deepspeed_tpu_torch.models import Model, TransformerConfig
from deepspeed_tpu_torch.models.layers import causal_attention
from deepspeed_tpu_torch.ops import sparse_attention as ts
from deepspeed_tpu_torch.runtime.runtime_utils import (tree_leaves,
                                                       tree_unflatten)
from tests.test_torch_train import one_thread  # noqa: F401 (autouse)

LAYOUTS = {
    "dense": dict(),
    "fixed": dict(num_local_blocks=3, num_global_blocks=1),
    "longformer": dict(num_sliding_window_blocks=2,
                       global_block_indices=(0, 5)),
    "bigbird": dict(num_random_blocks=2, num_sliding_window_blocks=2,
                    num_global_blocks=1, seed=3),
    "variable": dict(num_local_blocks=2, global_block_indices=(1,)),
}
CLASSES = {"dense": "DenseSparsityConfig", "fixed": "FixedSparsityConfig",
           "longformer": "BSLongformerSparsityConfig",
           "bigbird": "BigBirdSparsityConfig",
           "variable": "VariableSparsityConfig"}


def _configs(name, block=8):
    cls = CLASSES[name]
    return (getattr(js, cls)(block=block, **LAYOUTS[name]),
            getattr(ts, cls)(block=block, **LAYOUTS[name]))


def _close(got, want, rel=2e-5):
    want = np.asarray(want)
    tol = rel * float(np.abs(want).max()) + 1e-6
    assert float(np.abs(np.asarray(got) - want).max()) <= tol


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_layouts_and_density_equal_jax(name):
    jcfg, tcfg = _configs(name)
    for n in (1, 4, 9, 16):
        want, got = jcfg.make_layout(n), tcfg.make_layout(n)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        assert ts.density(got) == js.density(want)


@pytest.mark.parametrize("name", ["fixed", "longformer", "bigbird"])
def test_block_sparse_matches_jax(name):
    B, S, H, Hkv, D, block = 2, 64, 4, 2, 16, 8
    r = np.random.RandomState(0)
    q = r.randn(B, S, H, D).astype(np.float32)
    k = r.randn(B, S, Hkv, D).astype(np.float32)
    v = r.randn(B, S, Hkv, D).astype(np.float32)
    do = r.randn(B, S, H, D).astype(np.float32)
    jcfg, tcfg = _configs(name, block)
    lay = jcfg.make_layout(S // block)
    assert 0 < js.density(lay) < 1

    @jax.jit
    def jf(q, k, v, do):
        o, vjp = jax.vjp(lambda *a: js.block_sparse_attention(
            *a, lay, block), q, k, v)
        return o, vjp(do)

    jo, jg = jf(*map(jnp.asarray, (q, k, v, do)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    to = ts.make_block_sparse_attention(tcfg)(tq, tk, tv)
    tg = torch.autograd.grad(to, (tq, tk, tv), torch.from_numpy(do))
    _close(to.detach().numpy(), jo)
    for a, b in zip(tg, jg):
        _close(a.numpy(), b)
    direct = ts.block_sparse_attention(tq, tk, tv, lay, block)
    assert torch.equal(direct, to)


def test_dense_layout_is_causal_attention():
    r = np.random.RandomState(1)
    q, k, v = (torch.from_numpy(r.randn(2, 32, 4, 8).astype(np.float32))
               for _ in range(3))
    attn = ts.make_block_sparse_attention(ts.DenseSparsityConfig(block=8))
    _close(attn(q, k, v).numpy(), causal_attention(q, k, v).numpy())


def test_refusals():
    attn = ts.make_block_sparse_attention(ts.FixedSparsityConfig(block=8))
    q = torch.zeros(1, 16, 2, 8)
    with pytest.raises(NotImplementedError, match="padding masks"):
        attn(q, q, q, mask=torch.ones(1, 16))
    with pytest.raises(NotImplementedError, match="causal-only"):
        attn(q, q, q, causal=False)
    with pytest.raises(ValueError, match="not divisible"):
        attn(q[:, :12], q[:, :12], q[:, :12])
    with pytest.raises(ValueError, match="layout"):
        ts.block_sparse_attention(q, q, q, np.ones((3, 3), bool), 8)


def test_model_trains_through_block_sparse_attention():
    cfg = TransformerConfig(vocab_size=128, num_layers=2, d_model=32,
                            num_heads=4, max_seq_len=64)
    m = Model(cfg, seed=0, device="cpu",
              attention_fn=ts.make_block_sparse_attention(
                  ts.BSLongformerSparsityConfig(block=8)))
    ids = torch.from_numpy(np.random.RandomState(2).randint(0, 128, (2, 64)))
    leaves = [x.requires_grad_() for x in tree_leaves(m.params)]
    loss = m.loss_fn(tree_unflatten(m.params, leaves), {"input_ids": ids})
    grads = torch.autograd.grad(loss, leaves)
    assert bool(torch.isfinite(loss))
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    wq = m.params["blocks"]["attn"]["wq"]
    assert float(next(g for x, g in zip(leaves, grads)
                      if x is wq).abs().max()) > 0
