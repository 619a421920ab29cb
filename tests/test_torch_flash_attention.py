"""The port's flash attention (``deepspeed_tpu_torch.ops.flash_attention``)
held against the JAX package's on the same numpy inputs: each plain
version against its Pallas kernel (interpret mode on the CPU, as
tests/test_flash_attention.py runs it) — ``flash_fwd_plain`` against
``_fwd`` (o and LSE), ``flash_dq_plain`` / ``flash_dkv_plain`` against
``_bwd`` — and the port's autograd through ``flash_attention`` against
``jax.grad`` of the JAX ``flash_attention``.

On the CPU the wrappers run the plain versions; the CUDA kernels are held
against them by tests/test_torch_kernels_cuda.py and chip_smoke.py on the
card.

Tolerances are those of tests/test_flash_attention.py: fp32, atol 2e-5
for outputs and LSE (:27), 1e-4 for gradients (:76) — the same sums in
another order and, in the JAX kernels, a block at a time."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models.layers import causal_attention as jax_causal
from deepspeed_tpu.ops import flash_attention as jax_flash_attention
from deepspeed_tpu.ops.flash_attention import _bwd as jax_bwd
from deepspeed_tpu.ops.flash_attention import _fwd as jax_fwd
from deepspeed_tpu_torch.models.layers import causal_attention
from tests.test_torch_train import one_thread  # noqa: F401 (autouse)

fa = importlib.import_module("deepspeed_tpu_torch.ops.flash_attention")

OUT_ATOL = 2e-5
GRAD_ATOL = 1e-4
CASES = [(2, 256, 4, 4, 64), (2, 256, 4, 2, 64), (1, 256, 8, 2, 32)]
CASE_IDS = ["mha", "gqa2", "gqa4"]


def _inputs(B, S, H, Hkv, D, seed=0):
    """q, k, v, dO as float32 numpy, [B, S, H|Hkv, D]."""
    r = np.random.RandomState(seed)
    return (r.randn(B, S, H, D).astype(np.float32),
            r.randn(B, S, Hkv, D).astype(np.float32),
            r.randn(B, S, Hkv, D).astype(np.float32),
            r.randn(B, S, H, D).astype(np.float32))


def _bhsd(*xs):
    """[B, S, H, D] numpy -> the kernels' [B, H, S, D], for both sides."""
    return ([jnp.asarray(x.transpose(0, 2, 1, 3)) for x in xs],
            [torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 1, 3)))
             for x in xs])


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("B, S, H, Hkv, D", CASES, ids=CASE_IDS)
def test_fwd_plain_matches_pallas_fwd(B, S, H, Hkv, D, causal):
    q, k, v, _ = _inputs(B, S, H, Hkv, D)
    (jq, jk, jv), (tq, tk, tv) = _bhsd(q, k, v)
    scale = D ** -0.5
    jo, jlse = jax_fwd(jq, jk, jv, scale, causal, 128, 128)
    o, lse = fa.flash_fwd_plain(tq, tk, tv, scale, causal)
    assert lse.shape == (B, H, S) and jlse.shape == (B, H, S, 1)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=OUT_ATOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[..., 0],
                               atol=OUT_ATOL)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("B, S, H, Hkv, D", CASES, ids=CASE_IDS)
def test_dq_dkv_plain_match_pallas_bwd(B, S, H, Hkv, D, causal):
    """The same (q, k, v, o, lse, dO) into the JAX ``_bwd`` (dq and dkv
    kernels) and into the port's plain dq and dkv."""
    q, k, v, do = _inputs(B, S, H, Hkv, D, seed=1)
    (jq, jk, jv, jdo), (tq, tk, tv, tdo) = _bhsd(q, k, v, do)
    scale = D ** -0.5
    jo, jlse = jax_fwd(jq, jk, jv, scale, causal, 128, 128)
    jdq, jdk, jdv = jax_bwd(jq, jk, jv, jo, jlse, jdo, scale, causal, 128,
                            128)
    o = torch.from_numpy(np.array(jo))
    lse = torch.from_numpy(np.array(jlse)[..., 0])
    delta = (tdo * o).sum(-1)
    dq = fa.flash_dq_plain(tq, tk, tv, tdo, lse, delta, scale, causal)
    dk, dv = fa.flash_dkv_plain(tq, tk, tv, tdo, lse, delta, scale, causal)
    assert dk.shape == (B, Hkv, S, D)
    for name, got, ref in (("dq", dq, jdq), ("dk", dk, jdk), ("dv", dv, jdv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   atol=GRAD_ATOL, err_msg=name)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("B, S, H, Hkv, D", CASES[:2], ids=CASE_IDS[:2])
def test_autograd_matches_jax_grad(B, S, H, Hkv, D, causal):
    """End to end: the port's ``flash_attention`` (autograd Function over
    the plain versions on the CPU) against ``jax.grad`` of the JAX
    ``flash_attention`` (custom VJP over the Pallas kernels)."""
    q, k, v, do = _inputs(B, S, H, Hkv, D, seed=2)

    def jloss(q_, k_, v_):
        return (jax_flash_attention(q_, k_, v_, causal=causal)
                * jnp.asarray(do)).sum()

    jo = jax_flash_attention(*map(jnp.asarray, (q, k, v)), causal=causal)
    jg = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    fwd_before = fa.flash_attention.fallbacks
    o = fa.flash_attention(tq, tk, tv, causal=causal)
    assert fa.flash_attention.fallbacks == fwd_before
    o.backward(torch.from_numpy(do))
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(jo),
                               atol=OUT_ATOL)
    for name, t, ref in zip("qkv", (tq, tk, tv), jg):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(ref),
                                   atol=GRAD_ATOL, err_msg=f"d{name}")


@pytest.mark.parametrize("case", ["mask", "uneven-tiling", "cross-length"])
def test_routing_to_causal_attention_matches_jax(case):
    """A padding mask, an S the 128-blocks do not tile (S=200) and a k of
    another length leave the kernels on both sides: the result is
    ``causal_attention``'s and the port counts one fallback."""
    S = 200 if case == "uneven-tiling" else 128
    Sk = 64 if case == "cross-length" else S
    r = np.random.RandomState(4)
    q = r.randn(2, S, 4, 32).astype(np.float32)
    k = r.randn(2, Sk, 2, 32).astype(np.float32)
    v = r.randn(2, Sk, 2, 32).astype(np.float32)
    mask = None
    if case == "mask":
        mask = np.ones((2, S), np.float32)
        mask[1, 100:] = 0
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else torch.from_numpy(mask)
    ref = jax_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              mask=jm)
    jax_direct = jax_causal(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            mask=jm)
    np.testing.assert_array_equal(np.asarray(ref), np.asarray(jax_direct))
    before = fa.flash_attention.fallbacks
    got = fa.flash_attention(*map(torch.from_numpy, (q, k, v)), mask=tm)
    assert fa.flash_attention.fallbacks == before + 1
    direct = causal_attention(*map(torch.from_numpy, (q, k, v)), mask=tm)
    torch.testing.assert_close(got, direct, atol=0, rtol=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=OUT_ATOL)


def test_short_sequence_takes_the_kernel_path():
    """S=100: the blocks clamp to min(128, S) = 100, which tiles S, so
    the JAX package runs its Pallas kernels here (not the fallback) and
    so does the port; both agree with causal attention."""
    q, k, v, _ = _inputs(1, 100, 4, 2, 32, seed=5)
    ref = jax_flash_attention(*map(jnp.asarray, (q, k, v)))
    before = fa.flash_attention.fallbacks
    got = fa.flash_attention(*map(torch.from_numpy, (q, k, v)))
    assert fa.flash_attention.fallbacks == before
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=OUT_ATOL)


def test_cpu_tensors_never_touch_the_kernels():
    q, k, v, do = _inputs(1, 128, 2, 2, 64, seed=6)
    (_, (tq, tk, tv, tdo)) = _bhsd(q, k, v, do)
    before = (fa.flash_fwd.launches, fa.flash_dq.launches,
              fa.flash_dkv.launches)
    o, lse = fa.flash_fwd(tq, tk, tv, 0.125)
    delta = (tdo * o).sum(-1)
    fa.flash_dq(tq, tk, tv, tdo, lse, delta, 0.125)
    fa.flash_dkv(tq, tk, tv, tdo, lse, delta, 0.125)
    assert (fa.flash_fwd.launches, fa.flash_dq.launches,
            fa.flash_dkv.launches) == before
