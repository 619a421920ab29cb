"""``moment_dtype`` of the port's AdamW, Adam and Lion held against the
JAX package's on the same numpy inputs.

The reference stores the moments in ``moment_dtype`` and runs the update
in fp32 (``deepspeed_tpu/runtime/optimizers.py:63-93``, ``:118-132``):
``m_.astype(moment_dtype)``.  With bf16 moments, four updates from the
same params and grads must give bf16 moments on both sides and the same
deltas and moments.

Tolerance: the fp32 arithmetic of one update is the same on both sides
up to summation order (rtol 1e-5 in fp32, as tests/test_torch_train.py);
a moment that lands within that of a bf16 rounding half may round to the
neighbouring bf16 value, so moments are held to one bf16 ulp (rtol
2^-8) and the deltas, which divide one moment by the root of the other,
to rtol 2^-7.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu_torch as tds
from deepspeed_tpu.runtime import optimizers as jax_opt
from deepspeed_tpu_torch.models import build_model
from deepspeed_tpu_torch.runtime import optimizers as port_opt
from deepspeed_tpu_torch.runtime.runtime_utils import tree_leaves

BF16_ULP = 2.0 ** -8

CASES = {
    "adamw": {"lr": 1e-2, "weight_decay": 0.1},
    "adam": {"lr": 1e-2, "weight_decay": 0.05, "betas": [0.8, 0.99]},
    "lion": {"lr": 1e-3, "weight_decay": 0.1},
}


def _tree(seed):
    r = np.random.RandomState(seed)
    return {"w": r.randn(16, 12).astype(np.float32),
            "blk": {"b": r.randn(12).astype(np.float32),
                    "s": (r.randn(3, 4, 5) * 1e-3).astype(np.float32)}}


def _to_torch(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor)
                      else jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("spelling", ["dtype", "json"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_bf16_moments_match_jax(name, spelling):
    """``moment_dtype`` as a dtype on the function (``opt.adamw(...,
    moment_dtype=jnp.bfloat16)`` against ``torch.bfloat16``), or as the
    JSON spelling ``"bfloat16"`` through ``build_optimizer`` on both
    sides (the path of a config's ``optimizer.params``)."""
    cfg = dict(CASES[name])
    lr = cfg.pop("lr")
    if spelling == "dtype":
        jo = getattr(jax_opt, name)(lr, moment_dtype=jnp.bfloat16, **{
            k: tuple(v) if k == "betas" else v for k, v in cfg.items()})
        to = getattr(port_opt, name)(lr, moment_dtype=torch.bfloat16, **{
            k: tuple(v) if k == "betas" else v for k, v in cfg.items()})
    else:
        spec = {**cfg, "moment_dtype": "bfloat16"}
        jo = jax_opt.build_optimizer(name, lr, spec)
        to = port_opt.build_optimizer(name, lr, spec)
    jp = jax.tree.map(jnp.asarray, _tree(0))
    tp = _to_torch(_tree(0))
    js, ts = jo.init(jp), to.init(tp)
    for field in ts:
        assert all(x.dtype == torch.bfloat16 for x in tree_leaves(field))
    for field in js:
        assert all(x.dtype == jnp.bfloat16 for x in jax.tree.leaves(field))
    for step in (1, 2, 3, 4):
        g = _tree(step)
        ju, js = jo.update(jax.tree.map(jnp.asarray, g), js, jp,
                           jnp.asarray(step, jnp.int32))
        tu, ts = to.update(_to_torch(g), ts, tp, step)
        for a, b in zip(jax.tree.leaves(ju), tree_leaves(tu)):
            assert b.dtype == torch.float32
            np.testing.assert_allclose(_np(b), _np(a), rtol=2 * BF16_ULP,
                                       atol=1e-8)
        for jf, tf in zip(js, ts):
            for a, b in zip(jax.tree.leaves(jf), tree_leaves(tf)):
                assert b.dtype == torch.bfloat16 and a.dtype == jnp.bfloat16
                np.testing.assert_allclose(_np(b), _np(a), rtol=BF16_ULP,
                                           atol=1e-30)
        jp = jax.tree.map(lambda p, u: p + u, jp, ju)
        tp = jax.tree.map(lambda p, u: p + u, tp, tu)


def test_fp32_moments_stay_the_default():
    """Without ``moment_dtype`` the moments are fp32, as before."""
    for name in sorted(CASES):
        st = port_opt.build_optimizer(name, 1e-3, {}).init(
            _to_torch(_tree(0)))
        assert all(x.dtype == torch.float32
                   for field in st for x in tree_leaves(field))


def test_bad_moment_dtype_raises():
    for bad in ("int8", "no_such_dtype", torch.int32):
        with pytest.raises(ValueError, match="moment_dtype"):
            port_opt.adamw(1e-3, moment_dtype=bad)


def test_engine_takes_moment_dtype_from_the_json_config():
    """``optimizer.params.moment_dtype`` of a config reaches the engine:
    its AdamW state is bf16 and two steps train (finite loss, moments
    still bf16 after the update)."""
    m = build_model("gpt2", num_layers=2, d_model=64, num_heads=2,
                    vocab_size=128, max_seq_len=32, device="cpu")
    eng = tds.initialize(model=m, device="cpu", config={
        "train_micro_batch_size_per_device": 2,
        "optimizer": {"type": "adamw",
                      "params": {"lr": 1e-3, "moment_dtype": "bfloat16"}}})
    ids = torch.from_numpy(
        np.random.RandomState(0).randint(0, 128, (2, 16)).astype(np.int64))
    for _ in range(2):
        out = eng.train_batch({"input_ids": ids})
        assert np.isfinite(float(out["loss"]))
    for field in eng.state.opt_state:
        assert all(x.dtype == torch.bfloat16 for x in tree_leaves(field))
