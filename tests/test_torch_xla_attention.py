"""The port's ``fused_attention`` (``ops/xla_attention.py``, the attention
of ``attention_impl="xla_flash"``) held against the JAX package's on the
same numpy inputs: outputs and dq/dk/dv on the block-causal path (S a
multiple of 8) and the general one (S not a multiple, a padding mask,
``causal=False``), GQA at rep 1 and 4; a Hessian-vector product through
it against JAX's forward-over-reverse; tiny GPT-2 under ``"xla_flash"``:
a 3-step trajectory and the engine's eigenvalue against the JAX engine's,
what the backward keeps (no [S, S] tensor) and the ``xla_flash`` remat
policy (the forward op saved, bitwise no remat).

Tolerances: a single op |port - JAX| <= 2e-5 max|JAX| + 1e-6 (fp32, the
same products in another summation order); the Hessian-vector product
1e-4 max|JAX| (a second derivative of the same sums); the trajectory
rtol 1e-4 and masters atol 1e-4 (tests/test_torch_train_gpt2.py's); the
eigenvalue rtol 1e-3 (tests/test_torch_data_efficiency.py's)."""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.xla_attention import \
    fused_attention as jax_fused_attention
from deepspeed_tpu.runtime.eigenvalue import Eigenvalue as JaxEigenvalue
from deepspeed_tpu_torch.models import Model
from deepspeed_tpu_torch.ops import fused_attention
from deepspeed_tpu_torch.runtime.eigenvalue import Eigenvalue
from deepspeed_tpu_torch.runtime.runtime_utils import (tree_leaves,
                                                       tree_unflatten)
from deepspeed_tpu_torch.utils.prng import key_from_numpy
from tests.test_torch_train import (assert_trajectories_agree,
                                    run_trajectories, tiny_models)
from tests.test_torch_train import one_thread  # noqa: F401 (autouse)

xa = importlib.import_module("deepspeed_tpu_torch.ops.xla_attention")

# (B, S, H, Hkv, D, mask, causal)
CASES = {
    "causal_blocks": (2, 32, 4, 4, 16, False, True),
    "causal_blocks_gqa4": (2, 32, 8, 2, 16, False, True),
    "causal_uneven": (2, 20, 4, 4, 16, False, True),
    "padding_mask": (2, 24, 4, 1, 16, True, True),
    "bidirectional": (2, 16, 4, 4, 16, False, False),
    "bidirectional_gqa4_mask": (2, 16, 4, 1, 16, True, False),
}


def _inputs(B, S, H, Hkv, D, masked, seed=0):
    r = np.random.RandomState(seed)
    q = r.randn(B, S, H, D).astype(np.float32)
    k = r.randn(B, S, Hkv, D).astype(np.float32)
    v = r.randn(B, S, Hkv, D).astype(np.float32)
    do = r.randn(B, S, H, D).astype(np.float32)
    mask = None
    if masked:
        mask = np.ones((B, S), np.int32)
        mask[1, S - 5:] = 0
    return q, k, v, do, mask


def _close(got, want, rel=2e-5, what=""):
    want = np.asarray(want)
    tol = rel * float(np.abs(want).max()) + 1e-6
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= tol, f"{what}: max|d| {err} > {tol}"


@pytest.mark.parametrize("case", sorted(CASES))
def test_outputs_and_gradients_match_jax(case):
    B, S, H, Hkv, D, masked, causal = CASES[case]
    q, k, v, do, mask = _inputs(B, S, H, Hkv, D, masked)
    jm = None if mask is None else jnp.asarray(mask)

    @jax.jit
    def jf(q, k, v, do):
        o, vjp = jax.vjp(lambda *a: jax_fused_attention(
            *a, mask=jm, causal=causal), q, k, v)
        return o, vjp(do)

    jo, jgrads = jf(*map(jnp.asarray, (q, k, v, do)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    tmask = None if mask is None else torch.from_numpy(mask)
    to = fused_attention(tq, tk, tv, mask=tmask, causal=causal)
    tgrads = torch.autograd.grad(to, (tq, tk, tv), torch.from_numpy(do))
    _close(to.detach().numpy(), jo, what="o")
    for name, a, b in zip(("dq", "dk", "dv"), tgrads, jgrads):
        _close(a.numpy(), b, what=name)
    # the block path runs exactly where the JAX package's does
    assert (xa._blocks(S, S) is not None and causal and not masked) == (
        case.startswith("causal_blocks"))


@pytest.mark.parametrize("case", ["causal_blocks_gqa4", "padding_mask"])
def test_hessian_vector_product_matches_jax(case):
    """d/dq of <grad_q f, u> with f = sum(o * w): the port's double
    backward through the autograd function against JAX's jvp of the grad
    through the custom VJP."""
    B, S, H, Hkv, D, masked, causal = CASES[case]
    q, k, v, w, mask = _inputs(B, S, H, Hkv, D, masked, seed=1)
    u = np.random.RandomState(2).randn(*q.shape).astype(np.float32)
    jm = None if mask is None else jnp.asarray(mask)
    jk, jv, jw = jnp.asarray(k), jnp.asarray(v), jnp.asarray(w)

    def jloss(q):
        return jnp.sum(jax_fused_attention(q, jk, jv, mask=jm,
                                           causal=causal) * jw)

    jhvp = jax.jit(lambda q, u: jax.jvp(jax.grad(jloss), (q,), (u,))[1])(
        jnp.asarray(q), jnp.asarray(u))
    tq = torch.from_numpy(q).requires_grad_()
    tmask = None if mask is None else torch.from_numpy(mask)
    loss = (fused_attention(tq, torch.from_numpy(k), torch.from_numpy(v),
                            mask=tmask, causal=causal)
            * torch.from_numpy(w)).sum()
    (g,) = torch.autograd.grad(loss, tq, create_graph=True)
    (thvp,) = torch.autograd.grad(g, tq, torch.from_numpy(u))
    _close(thvp.numpy(), jhvp, rel=1e-4, what="hvp")


def test_xla_flash_resolves_to_fused_attention_and_keeps_no_square():
    """``attention_impl="xla_flash"`` runs ``fused_attention``; its
    backward keeps no [.., S, S] tensor (the saved residuals are q, k, v,
    o and the LSE), which ``"xla"`` (autograd through the plain softmax)
    keeps."""
    _, tm = tiny_models("gpt2", attention_impl="xla_flash")
    assert tm.attention_fn is fused_attention
    S = 64
    ids = torch.from_numpy(np.random.RandomState(0).randint(0, 256, (2, S)))
    squares = {}
    for impl in ("xla_flash", "xla"):
        m = Model.from_params(dataclasses.replace(
            tm.config, attention_impl=impl), tm.params)
        shapes = []

        def pack(t):
            shapes.append(tuple(t.shape))
            return t

        params = [x.detach().requires_grad_() for x in tree_leaves(m.params)]
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            loss = m.loss_fn(tree_unflatten(m.params, params),
                             {"input_ids": ids})
        squares[impl] = sum(sh[-2:] == (S, S) for sh in shapes)
        torch.autograd.grad(loss, params)
    assert squares["xla"] >= tm.config.num_layers
    assert squares["xla_flash"] == 0


def test_xla_flash_remat_saves_the_forward_bitwise(monkeypatch):
    """Under remat policy ``"xla_flash"`` the forward op runs once per
    layer (its (o, lse) saved, as the JAX policy saves attn_out and
    attn_lse), under ``"nothing"`` twice; loss and gradients bitwise
    equal to no remat."""
    calls = [0]
    inner = xa._attn_fwd

    def counting(*args):
        calls[0] += 1
        return inner(*args)

    monkeypatch.setattr(xa, "_attn_fwd", counting)
    _, tm = tiny_models("gpt2", attention_impl="xla_flash")
    ids = torch.from_numpy(np.random.RandomState(3).randint(0, 256, (2, 32)))
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        res = {}
        for policy in (None, "xla_flash", "nothing"):
            cfg = (tm.config if policy is None else dataclasses.replace(
                tm.config, remat=True, remat_policy=policy))
            m = Model.from_params(cfg, tm.params)
            params = [x.detach().requires_grad_()
                      for x in tree_leaves(m.params)]
            calls[0] = 0
            loss = m.loss_fn(tree_unflatten(m.params, params),
                             {"input_ids": ids})
            grads = torch.autograd.grad(loss, params)
            res[policy] = (calls[0], loss.detach(), grads)
    finally:
        torch.use_deterministic_algorithms(before)
    n = tm.config.num_layers
    assert [res[p][0] for p in (None, "xla_flash", "nothing")] == \
        [n, n, 2 * n]
    for p in ("xla_flash", "nothing"):
        assert torch.equal(res[p][1], res[None][1])
        assert all(torch.equal(a, b) for a, b in zip(res[p][2],
                                                     res[None][2]))


def test_gpt2_trajectory_matches_jax():
    """3 AdamW steps of tiny GPT-2 (fp32) under ``"xla_flash"`` in both
    packages: both run their fused attention's backward."""
    assert_trajectories_agree(*run_trajectories(
        "gpt2", 1, steps=3, attention_impl="xla_flash"), rtol=1e-4,
        atol=1e-4)


def test_eigenvalue_matches_jax():
    """The engine's Hessian eigenvalue (two power iterations through
    ``hvp_loss``) on tiny GPT-2 cut to one layer under ``"xla_flash"``:
    forward-over-reverse through the JAX custom VJP against the port's
    double backward through the autograd function."""
    jm, tm = tiny_models("gpt2", attention_impl="xla_flash", spec=(
        "gpt2", dict(vocab_size=128, num_layers=1, d_model=32, num_heads=4,
                     max_seq_len=64)))
    ids = np.random.RandomState(4).randint(0, 128, (2, 32))
    jkey = jax.random.PRNGKey(1)
    tkey = key_from_numpy(np.asarray(jkey))
    jloss = jax.jit(lambda p: jm.loss_fn(p, {"input_ids": jnp.asarray(ids)},
                                         jax.random.PRNGKey(0)))
    jeig, _ = JaxEigenvalue(max_iter=2).compute_eigenvalue(jloss, jm.params,
                                                           jkey)
    teig, _ = Eigenvalue(max_iter=2).compute_eigenvalue(
        lambda p: tm.loss_fn.hvp_loss(p, {"input_ids": torch.from_numpy(
            ids)}, key_from_numpy(np.asarray(jax.random.PRNGKey(0)))),
        tm.params, tkey)
    assert np.isfinite(teig)
    np.testing.assert_allclose(teig, jeig, rtol=1e-3)
