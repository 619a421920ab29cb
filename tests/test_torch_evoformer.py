"""The port's Evoformer attention (``ops/evoformer.py``) held against the
JAX package's ``custom_vjp`` on the same numpy inputs: outputs and
dQ/dK/dV/db1/db2 with no bias, the mask bias, the pair bias and both
(GQA-free [B, N, S, H, D] as DS4Science's kernel takes them); a second
derivative through it against JAX's forward-over-reverse; and the shape
errors the JAX function raises, raised by the port too.

Tolerance: |port - JAX| <= 2e-5 max|JAX| + 1e-6 per output (fp32, the
same products in another summation order); the second derivative (a
scalar) rtol 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.evoformer import \
    evoformer_attention as jax_evoformer
from deepspeed_tpu_torch.ops import evoformer_attention
from tests.test_torch_train import one_thread  # noqa: F401 (autouse)


def _inputs(B=2, N=3, S=16, H=4, D=8, seed=0):
    r = np.random.RandomState(seed)
    f = lambda *s: r.randn(*s).astype(np.float32)        # noqa: E731
    b1 = np.where(r.rand(B, N, 1, 1, S) < 0.2, -1e4, 0.0).astype(np.float32)
    return f(B, N, S, H, D), f(B, N, S, H, D), f(B, N, S, H, D), b1, \
        f(B, 1, H, S, S), f(B, N, S, H, D)


def _close(got, want, rel=2e-5, what=""):
    want = np.asarray(want)
    tol = rel * float(np.abs(want).max()) + 1e-6
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= tol, f"{what}: {err} > {tol}"


@pytest.mark.parametrize("use1, use2", [(False, False), (True, False),
                                        (False, True), (True, True)])
def test_outputs_and_gradients_match_jax(use1, use2):
    Q, K, V, b1, b2, do = _inputs()
    biases = [b for b, use in ((b1, use1), (b2, use2)) if use]

    @jax.jit
    def jf(args, do):
        o, vjp = jax.vjp(lambda Q, K, V, *bs: jax_evoformer(Q, K, V, list(bs)),
                         *args)
        return o, vjp(do)

    jo, jg = jf(tuple(map(jnp.asarray, (Q, K, V, *biases))), jnp.asarray(do))
    targs = [torch.from_numpy(x).requires_grad_() for x in (Q, K, V,
                                                            *biases)]
    to = evoformer_attention(*targs[:3], targs[3:])
    tg = torch.autograd.grad(to, targs, torch.from_numpy(do))
    _close(to.detach().numpy(), jo, what="o")
    names = ["dQ", "dK", "dV"] + [n for n, use in (("db1", use1),
                                                   ("db2", use2)) if use]
    for name, a, b in zip(names, tg, jg):
        assert a.shape == b.shape
        _close(a.numpy(), b, what=name)


def test_second_derivative_matches_jax():
    """The mixed second derivative u . (d(dL/db2)/dQ) uq of the pair bias's
    gradient (it runs through the LSE): JAX's jvp of the grad through the
    custom VJP (the directional derivative along uq, contracted with u)
    against the port's double backward (the gradient of <dL/db2, u> with
    respect to Q, contracted with uq)."""
    Q, K, V, b1, b2, w = _inputs(S=12, seed=1)
    r = np.random.RandomState(2)
    u = r.randn(*b2.shape).astype(np.float32)
    uq = r.randn(*Q.shape).astype(np.float32)
    jk, jv, jb1, jw = map(jnp.asarray, (K, V, b1, w))

    def jloss(Q, b2):
        return jnp.sum(jax_evoformer(Q, jk, jv, [jb1, b2]) * jw)

    jdir = jax.jit(lambda Q, b2, uq: jax.jvp(
        lambda Q: jax.grad(jloss, argnums=1)(Q, b2), (Q,), (uq,))[1])
    want = float(jnp.sum(jdir(jnp.asarray(Q), jnp.asarray(b2),
                              jnp.asarray(uq)) * jnp.asarray(u)))
    tq = torch.from_numpy(Q).requires_grad_()
    tb2 = torch.from_numpy(b2).requires_grad_()
    loss = (evoformer_attention(tq, torch.from_numpy(K), torch.from_numpy(V),
                                [torch.from_numpy(b1), tb2])
            * torch.from_numpy(w)).sum()
    (gb2,) = torch.autograd.grad(loss, tb2, create_graph=True)
    (gq,) = torch.autograd.grad(gb2, tq, torch.from_numpy(u))
    got = float((gq * torch.from_numpy(uq)).sum())
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_shape_errors_match_jax():
    Q, K, V, b1, b2, _ = _inputs()
    bad = {"rank": [np.ones((2, 16), np.float32)],
           "three": [b1, b2, b1],
           "two_masks": [b1, b1],
           "two_pairs": [b2, b2],
           "bias1_N": [b1[:, :1]],
           "bias2_H": [b2[:, :, :2]]}
    for name, biases in bad.items():
        with pytest.raises(ValueError) as je:
            jax_evoformer(*map(jnp.asarray, (Q, K, V)),
                          [jnp.asarray(b) for b in biases])
        with pytest.raises(ValueError) as te:
            evoformer_attention(*map(torch.from_numpy, (Q, K, V)),
                                [torch.from_numpy(b) for b in biases])
        assert str(te.value) == str(je.value), name
