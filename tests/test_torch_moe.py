"""The port's MoE layer (``deepspeed_tpu_torch.parallel.moe``) against
``deepspeed_tpu.parallel.moe`` on the same numpy inputs made from a seed:
the gating functions (dense masks and index form, with capacity drops and
both top-k normalizations), ``capacity_for``, ``experts_apply``,
``_ragged_moe`` and ``moe_ffn`` in its three dispatch modes, forward and
gradient; the two noise policies; and the serving form (``moe_serving``)
against the JAX ``moe_ffn`` on the rows that are real.

Tolerances: gating indices, slots and masks exact; gate weights, aux loss
and float32 outputs rtol 1e-5 / atol 1e-6 (the same float32 arithmetic,
sums in another order); gradients atol 1e-5.  Jitter's uniforms are
jax's bit for bit; RSample's normals within 4 float32 ulps of jax's (the
uniforms are bitwise, the erfinv's log1p is each backend's own)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.parallel import moe as jmoe
from deepspeed_tpu_torch.models import layers as TL
from deepspeed_tpu_torch.parallel import moe as tmoe
from deepspeed_tpu_torch.utils import prng
from tests.test_torch_train import one_thread  # noqa: F401 (autouse)

E, DM, FF = 6, 16, 24


def _rand(seed, *shape, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _experts(seed, gated=True):
    p = {"wi": _rand(seed, E, DM, FF, scale=0.3),
         "wo": _rand(seed + 1, E, FF, DM, scale=0.3)}
    if gated:
        p["wg"] = _rand(seed + 2, E, DM, FF, scale=0.3)
    return p


def _t(tree, grad=False):
    return jax.tree.map(lambda a: torch.tensor(a, requires_grad=grad), tree)


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


@pytest.mark.parametrize("k,cap,norm", [(1, 3, True), (2, 2, True),
                                        (2, 4, False), (3, 100, True)])
def test_gating_matches_jax(k, cap, norm):
    """Dense masks and the index form, with capacity drops (cap 2-4 over
    12 tokens) and without (cap 100), both normalizations."""
    logits = _rand(0, 12, E, scale=2.0)
    jd = jmoe.top_k_gating(jnp.asarray(logits), k, cap, norm_topk=norm)
    td = tmoe.top_k_gating(torch.from_numpy(logits), k, cap, norm_topk=norm)
    np.testing.assert_array_equal(td.dispatch.numpy(), np.asarray(jd.dispatch))
    np.testing.assert_allclose(td.combine.numpy(), np.asarray(jd.combine),
                               rtol=1e-5, atol=1e-6)
    js = jmoe.top_k_gating_sparse(jnp.asarray(logits), k, cap, norm_topk=norm)
    ts = tmoe.top_k_gating_sparse(torch.from_numpy(logits), k, cap,
                                  norm_topk=norm)
    np.testing.assert_array_equal(ts.ids.numpy(), np.asarray(js.ids))
    np.testing.assert_array_equal(ts.pos.numpy(), np.asarray(js.pos))
    for a, b in ((ts.vals, js.vals), (ts.aux_loss, js.aux_loss),
                 (ts.dropped, js.dropped), (td.aux_loss, jd.aux_loss),
                 (td.dropped, jd.dropped)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)
    if cap < 12:
        assert bool((ts.pos == cap).any())    # the case drops choices


@pytest.mark.parametrize("args", [(16, 8, 2, 1.25, 4), (3, 8, 2, 1.0, 4),
                                  (1024, 60, 4, 2.0, 4), (8, 60, 4, 2.0, 4),
                                  (7, 3, 1, 0.5, 1)])
def test_capacity_for_matches_jax(args):
    assert tmoe.capacity_for(*args) == jmoe.capacity_for(*args)


@pytest.mark.parametrize("gated", [False, True])
def test_experts_apply_matches_jax(gated):
    p = _experts(1, gated)
    x = _rand(4, E, 5, DM)
    ref = jmoe.experts_apply(_j(p), jnp.asarray(x), jax.nn.gelu, gated)
    got = tmoe.experts_apply(_t(p), torch.from_numpy(x), tmoe._gelu, gated)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)


def _moe_pair(mode, k, cf, norm=True, noise=None, seed=0, B=3, S=10,
              act=("silu", jax.nn.silu)):
    """(JAX value and grads, port value and grads) of sum(y * w) + aux
    over x, the gate and the experts."""
    gate = {"kernel": _rand(seed + 20, DM, E, scale=0.5)}
    ex = _experts(seed + 30)
    x = _rand(seed + 40, B, S, DM)
    w = _rand(seed + 50, B, S, DM)
    key = jax.random.PRNGKey(seed)

    def jloss(x, gate, ex):
        y, m = jmoe.moe_ffn(gate, ex, x, top_k=k, capacity_factor=cf,
                            activation=act[1], gated=True,
                            rng=key if noise else None, noise_policy=noise,
                            dispatch_mode=mode, norm_topk=norm)
        return (y * w).sum() + m["moe_aux_loss"], (y, m)

    (jl, (jy, jm)), jg = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True))(
        jnp.asarray(x), _j(gate), _j(ex))
    tx, tg, te = torch.tensor(x, requires_grad=True), _t(gate, True), \
        _t(ex, True)
    ty, tm = tmoe.moe_ffn(
        tg, te, tx, top_k=k, capacity_factor=cf,
        activation=TL.ACTIVATIONS[act[0]], gated=True,
        rng=prng.key_from_numpy(np.asarray(key)) if noise else None,
        noise_policy=noise, dispatch_mode=mode, norm_topk=norm)
    tl = (ty * torch.from_numpy(w)).sum() + tm["moe_aux_loss"]
    grads = torch.autograd.grad(tl, [tx, tg["kernel"]] + [te[n] for n in
                                                          sorted(te)])
    jgrads = [jg[0], jg[1]["kernel"]] + [jg[2][n] for n in sorted(te)]
    return (jy, jm, jgrads), (ty, tm, grads)


@pytest.mark.parametrize("mode,k,cf,norm", [
    ("scatter", 2, 1.0, True), ("scatter", 2, 0.5, False),
    ("scatter", 1, 1.25, True), ("einsum", 2, 0.75, True),
    ("einsum", 3, 2.0, False), ("ragged", 2, 1.0, True),
    ("ragged", 3, 1.0, False)])
def test_moe_ffn_matches_jax_forward_and_gradient(mode, k, cf, norm):
    """Every dispatch mode, with drops (capacity factors below 1) and
    without: outputs, metrics and the gradients of x, the gate and the
    experts."""
    (jy, jm, jg), (ty, tm, tg) = _moe_pair(mode, k, cf, norm)
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy),
                               rtol=1e-5, atol=1e-5)
    for name in ("moe_aux_loss", "moe_dropped"):
        np.testing.assert_allclose(float(tm[name].detach()), float(jm[name]),
                                   rtol=1e-5, atol=1e-6)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5,
                                   rtol=1e-4)


def test_ragged_moe_matches_jax():
    """``_ragged_moe`` directly (RSample noise on): dropless output and
    aux loss."""
    ex = _experts(3)
    x = _rand(5, 2, 7, DM)
    logits = _rand(6, 2, 7, E)
    key = jax.random.PRNGKey(9)
    jy, jm = jmoe._ragged_moe(_j(ex), jnp.asarray(x), jnp.asarray(logits),
                              top_k=2, activation=jax.nn.gelu, gated=True,
                              noise_policy="RSample", rng=key,
                              dt=jnp.float32)
    ty, tm = tmoe._ragged_moe(_t(ex), torch.from_numpy(x),
                              torch.from_numpy(logits), top_k=2,
                              activation=tmoe._gelu, gated=True,
                              noise_policy="RSample",
                              rng=prng.key_from_numpy(np.asarray(key)),
                              dt=torch.float32)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(tm["moe_aux_loss"]),
                               float(jm["moe_aux_loss"]), rtol=1e-5)


def test_jitter_is_bitwise_and_rsample_within_ulps():
    """Jitter: the jittered gating input (jax's uniforms) is bitwise the
    JAX one, so the whole MoE output matches; RSample: the normals are
    within 4 float32 ulps of jax's and the noisy gating picks the same
    experts."""
    key = jax.random.PRNGKey(5)
    tkey = prng.key_from_numpy(np.asarray(key))
    j1, j2 = jax.random.split(key)
    t1, t2 = prng.split(tkey)
    np.testing.assert_array_equal(prng.key_to_numpy(t1), np.asarray(j1))
    ju = np.asarray(jax.random.uniform(j1, (3, 10, DM), minval=0.98,
                                       maxval=1.02))
    tu = prng.uniform(t1, (3, 10, DM), minval=0.98, maxval=1.02).numpy()
    np.testing.assert_array_equal(tu, ju)
    jn = np.asarray(jax.random.normal(j2, (64, 500)))
    tn = prng.normal(t2, (64, 500)).numpy()
    np.testing.assert_array_max_ulp(tn, jn, maxulp=4)
    for noise in ("Jitter", "RSample"):
        (jy, jm, _), (ty, tm, _) = _moe_pair("scatter", 2, 1.0, noise=noise,
                                             seed=2)
        np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy),
                                   rtol=1e-5, atol=1e-5, err_msg=noise)


def _serving_case(seed, R, scale=100.0):
    gate = {"kernel": _rand(seed, DM, E, scale=scale)}
    return gate, _experts(seed + 1), _rand(seed + 2, R, DM)


@pytest.mark.parametrize("R,n,tokens,k,cf", [(8, 5, 64, 2, 1.0),
                                             (16, 16, 16, 3, 1.0),
                                             (32, 20, 64, 1, 0.25),
                                             (32, 24, 32, 2, 0.5)])
def test_moe_serving_matches_jax_on_the_real_rows(R, n, tokens, k, cf):
    """The serving form over R rows of which the first n are real, at the
    capacity of ``tokens`` rows: its real rows equal the JAX ``moe_ffn`` on
    the n real rows alone at the same capacity (its capacity factor scaled
    by tokens / n), drops included; padding rows come out zero."""
    gate, ex, x = _serving_case(7, R)
    valid = torch.arange(R) < n
    got = tmoe.moe_serving(_t(gate), _t(ex), torch.from_numpy(x), valid,
                           tokens, top_k=k, capacity_factor=cf,
                           activation=tmoe._gelu, gated=True)
    cf_n = cf * tokens / n
    cap = tmoe.capacity_for(tokens, E, k, cf)
    assert jmoe.capacity_for(n, E, k, cf_n) == cap
    ref, met = jax.jit(lambda g, e, x: jmoe.moe_ffn(
        g, e, x, top_k=k, capacity_factor=cf_n, gated=True))(
        _j(gate), _j(ex), jnp.asarray(x[:n])[None])
    np.testing.assert_allclose(got[:n].numpy(), np.asarray(ref)[0],
                               rtol=1e-5, atol=1e-5)
    assert not got[n:].any()
    if cf < 1:                                   # the case drops choices
        sparse = jmoe.top_k_gating_sparse(
            jnp.asarray(x[:n]) @ gate["kernel"], k, cap)
        assert bool((np.asarray(sparse.pos) == cap).any())
