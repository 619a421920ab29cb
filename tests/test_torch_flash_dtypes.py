"""The port's flash attention in fp16 and fp32 at the head dims of the
presets, held against the JAX package's on the same numpy inputs: each
plain version (``flash_fwd_plain``, ``flash_dq_plain``,
``flash_dkv_plain``) against the Pallas kernels ``_fwd`` / ``_bwd`` run in
interpret mode on the CPU (as tests/test_flash_attention.py runs them), at
head dims 32 (the *-tiny presets), 80 (phi-2), 96 (phi3-mini) and 256
(gptj-6b), MHA and GQA; the zero-padding of a head dim the CUDA kernels
are not instantiated for (``at_kernel_head_dim``: D = 48 runs at 64); and
8-step fp16 training with the dynamic loss scaler against the JAX engine
on phi-tiny and the tiny GPT-2 of tests/test_torch_train_gpt2.py.

On the CPU the wrappers run the plain versions; the CUDA kernels are held
against them by tests/test_torch_kernels_cuda.py and chip_smoke.py on the
card.

Tolerances.  fp32: those of tests/test_flash_attention.py, atol 2e-5 for
outputs and LSE, 1e-4 for gradients (the same sums in another order).
fp16: both sides multiply fp16 inputs exactly in fp32, sum in fp32 in
another order and round P, dS and the outputs to fp16.  fp16 keeps 11
significant bits, so one rounding is worth up to 2^-11 (4.9e-4) of the
value, and a sum that lands on the other side of a rounding boundary
moves an output by one fp16 step, 2^-10 of its value; a P or dS rounded
one step apart moves it by less.  The outputs are held at
rtol = atol = 2^-9 (two steps; atol relative to the output's largest
magnitude), the LSE (fp32, from unrounded fp32 scores) at the fp32
bar."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.flash_attention import _bwd as jax_bwd
from deepspeed_tpu.ops.flash_attention import _fwd as jax_fwd
from tests.test_torch_train import NULL_GRAD_LEAVES, run_trajectories

fa = importlib.import_module("deepspeed_tpu_torch.ops.flash_attention")

FP32_OUT_ATOL = 2e-5
FP32_GRAD_ATOL = 1e-4
FP16_TOL = 2.0 ** -9

DTYPES = {"fp16": (np.float16, jnp.float16, torch.float16),
          "fp32": (np.float32, jnp.float32, torch.float32)}
# (B, S, H, Hkv, D): every head dim of the presets but 64/128 (held by
# tests/test_torch_flash_attention.py), MHA and GQA
CASES = [(1, 128, 4, h_kv, D) for D in (32, 80, 96, 256) for h_kv in (4, 2)]
CASE_IDS = [f"d{D}-{'mha' if h_kv == 4 else 'gqa2'}"
            for _, _, _, h_kv, D in CASES]


def _inputs(B, S, H, Hkv, D, dtype, seed):
    """q, k, v, dO as numpy in ``dtype``, [B, H|Hkv, S, D] (the kernels'
    layout), and the same arrays for JAX and the port."""
    r = np.random.RandomState(seed)
    xs = [r.randn(B, h, S, D).astype(dtype) for h in (H, Hkv, Hkv, H)]
    return [jnp.asarray(x) for x in xs], [torch.from_numpy(x) for x in xs]


def _close(got, ref, dtype, grad=False, name=""):
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    if dtype == "fp32":
        np.testing.assert_allclose(
            got, ref, atol=FP32_GRAD_ATOL if grad else FP32_OUT_ATOL,
            err_msg=name)
    else:
        np.testing.assert_allclose(got, ref, rtol=FP16_TOL,
                                   atol=FP16_TOL * np.abs(ref).max(),
                                   err_msg=name)


def _jax_reference(jq, jk, jv, jdo, scale, causal):
    jo, jlse = jax_fwd(jq, jk, jv, scale, causal, 128, 128)
    jdq, jdk, jdv = jax_bwd(jq, jk, jv, jo, jlse, jdo, scale, causal, 128,
                            128)
    return jo, jlse, jdq, jdk, jdv


def _port_backward(fwd, dq_fn, dkv_fn, tq, tk, tv, tdo, scale, causal):
    """The plain versions (or ``at_kernel_head_dim`` around them) in the
    order the autograd seam calls them: fwd, delta = rowsum(dO * O) in
    fp32, dq, dkv."""
    o, lse = fwd(tq, tk, tv, scale=scale, causal=causal)
    delta = (tdo.float() * o.float()).sum(-1)
    dq = dq_fn(tq, tk, tv, tdo, lse, delta, scale=scale, causal=causal)
    dk, dv = dkv_fn(tq, tk, tv, tdo, lse, delta, scale=scale, causal=causal)
    return o, lse, dq, dk, dv


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("B, S, H, Hkv, D", CASES, ids=CASE_IDS)
def test_plain_fwd_dq_dkv_match_pallas(B, S, H, Hkv, D, dtype):
    """The same fp16 / fp32 (q, k, v, dO) into the JAX ``_fwd`` and
    ``_bwd`` and into the port's plain fwd, dq and dkv (causal)."""
    np_dt, _, torch_dt = DTYPES[dtype]
    (jq, jk, jv, jdo), (tq, tk, tv, tdo) = _inputs(B, S, H, Hkv, D, np_dt,
                                                   seed=D + Hkv)
    scale = D ** -0.5
    jo, jlse, jdq, jdk, jdv = _jax_reference(jq, jk, jv, jdo, scale, True)
    o, lse, dq, dk, dv = _port_backward(
        fa.flash_fwd_plain, fa.flash_dq_plain, fa.flash_dkv_plain, tq, tk,
        tv, tdo, scale, True)
    assert o.dtype == dq.dtype == dk.dtype == dv.dtype == torch_dt
    assert lse.dtype == torch.float32 and jo.dtype == jnp.dtype(np_dt)
    _close(o.numpy(), jo, dtype, name="o")
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[..., 0],
                               atol=FP32_OUT_ATOL, err_msg="lse")
    for name, got, ref in (("dq", dq, jdq), ("dk", dk, jdk),
                           ("dv", dv, jdv)):
        _close(got.numpy(), ref, dtype, grad=True, name=name)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_full_attention_at_phi2_head_dim(dtype):
    """Non-causal attention at D = 80 (GQA): the same comparison."""
    np_dt = DTYPES[dtype][0]
    (jq, jk, jv, jdo), (tq, tk, tv, tdo) = _inputs(1, 128, 4, 2, 80, np_dt,
                                                   seed=3)
    scale = 80 ** -0.5
    ref = _jax_reference(jq, jk, jv, jdo, scale, False)
    got = _port_backward(fa.flash_fwd_plain, fa.flash_dq_plain,
                         fa.flash_dkv_plain, tq, tk, tv, tdo, scale, False)
    for name, g, r in zip(("o", "lse", "dq", "dk", "dv"), got, ref):
        if name == "lse":
            np.testing.assert_allclose(g.numpy(), np.asarray(r)[..., 0],
                                       atol=FP32_OUT_ATOL)
        else:
            _close(g.numpy(), r, dtype, grad=name != "o", name=name)


def test_kernel_head_dims():
    """The instantiated head dims, and what any other D runs at."""
    assert fa.HEAD_DIMS == (32, 64, 80, 96, 128, 256)
    assert [fa.kernel_head_dim(d) for d in (1, 32, 33, 48, 64, 72, 80, 96,
                                            100, 200, 256)] == [
        32, 32, 64, 64, 64, 80, 80, 96, 128, 256, 256]
    with pytest.raises(ValueError, match="head_dim 257"):
        fa.kernel_head_dim(257)


def test_launch_counts_by_variant(monkeypatch):
    """A wrapper counts each call of its kernel under the dtype and the
    head dim it ran at, beside its total; ``reset_launches`` zeroes both.
    The kernel entry points are stood in for (no card here), so the call
    goes through ``at_kernel_head_dim`` and the wrapper's count as on the
    card: D = 48 counts as 64."""
    for name in ("flash_fwd", "flash_dq", "flash_dkv"):
        monkeypatch.setattr(getattr(fa, name), "launches", 0)
        monkeypatch.setattr(getattr(fa, name), "variant_launches", {})
    monkeypatch.setattr(fa, "_check_operands", lambda q, k, *a, **kw: (
        q.shape[0], q.shape[1], k.shape[1], q.shape[2], q.shape[3]))
    monkeypatch.setattr(fa, "_kernel_fn",
                        lambda kind, dtype: lambda *args: 0)
    monkeypatch.setattr(fa, "_stream", lambda x: 0)
    for dt, D in ((torch.float16, 80), (torch.float16, 48),
                  (torch.float32, 64), (torch.float16, 80)):
        q = torch.zeros(1, 2, 16, D, dtype=dt)
        fa.at_kernel_head_dim(fa._fwd_launch, q, q, q, scale=0.1,
                              causal=True)
    assert fa.flash_fwd.launches == 4
    assert fa.flash_fwd.variant_launches == {
        ("float16", 80): 2, ("float16", 64): 1, ("float32", 64): 1}
    assert fa.flash_dq.variant_launches == {}
    fa.reset_launches()
    assert [(w.launches, w.variant_launches)
            for w in (fa.flash_fwd, fa.flash_dq, fa.flash_dkv)] == [(0, {})] * 3


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_head_dim_padding_gives_the_unpadded_result(dtype):
    """D = 48 is not instantiated: ``at_kernel_head_dim`` zero-pads the
    operands to 64, runs the function there and slices the outputs back.
    With the plain versions as the function, the result is the JAX
    kernels' at D = 48 (the scale stays 1/sqrt(48))."""
    np_dt = DTYPES[dtype][0]
    (jq, jk, jv, jdo), (tq, tk, tv, tdo) = _inputs(2, 128, 4, 2, 48, np_dt,
                                                   seed=48)
    seen = []

    def spy(fn):
        def run(*args, **kw):
            seen.append(args[0].shape[-1])
            return fn(*args, **kw)
        return run

    padded = [lambda *a, _f=f, **kw: fa.at_kernel_head_dim(spy(_f), *a, **kw)
              for f in (fa.flash_fwd_plain, fa.flash_dq_plain,
                        fa.flash_dkv_plain)]
    scale = 48 ** -0.5
    got = _port_backward(*padded, tq, tk, tv, tdo, scale, True)
    assert seen == [64, 64, 64]
    ref = _jax_reference(jq, jk, jv, jdo, scale, True)
    for name, g, r in zip(("o", "lse", "dq", "dk", "dv"), got, ref):
        if name == "lse":
            np.testing.assert_allclose(g.numpy(), np.asarray(r)[..., 0],
                                       atol=FP32_OUT_ATOL)
        else:
            assert g.shape[-1] == 48 and g.is_contiguous()
            _close(g.numpy(), r, dtype, grad=name != "o", name=name)
    # and exactly the unpadded plain versions' result
    plain = _port_backward(fa.flash_fwd_plain, fa.flash_dq_plain,
                           fa.flash_dkv_plain, tq, tk, tv, tdo, scale, True)
    for g, p in zip(got, plain):
        torch.testing.assert_close(g, p, atol=0, rtol=0)


# fp16 training: 8 AdamW steps at gas 1 with the dynamic loss scaler from
# 2^19 and a window of 2, so that the run overflows (hysteresis spent, then
# the scale halves), skips, applies and grows the scale again.
FP16_SCALER = {"initial_scale_power": 19, "loss_scale_window": 2}
PHI_TINY = ("phi-tiny", dict(vocab_size=256, num_layers=2, d_model=160,
                             num_heads=2, max_seq_len=128))


@pytest.mark.parametrize("model", ["phi-tiny", "gpt2"])
def test_fp16_trajectory_matches_jax(model):
    """phi-tiny (2 heads of 80: partial rotary, parallel block, biased
    head) and the tiny GPT-2, ``attention_impl="flash"``, fp16: the loss
    scale and the skipped steps agree exactly with the JAX engine's; the
    loss at rtol 2^-11 (one fp16 rounding: the forward runs in fp16 on
    both sides, rounded at other places) and the grad norm at 2^-9 on the
    applied steps (the gradients pass through ~10 fp16 roundings each);
    the final fp32 masters agree at 1e-4 on 99% of every leaf's elements:
    a gradient element below fp16's resolution is rounding noise, which
    Adam turns into a full step of either sign (as the null-gradient leaf
    does in fp32, tests/test_torch_train.py), so a few elements differ by
    up to the run's 6 x lr."""
    jtraj, ttraj, jp, tp = run_trajectories(
        "gpt2", 1, spec=PHI_TINY if model == "phi-tiny" else None,
        fp16=FP16_SCALER)
    np.testing.assert_array_equal(ttraj[:, 3], jtraj[:, 3],
                                  err_msg="loss scale")
    np.testing.assert_array_equal(ttraj[:, 4], jtraj[:, 4],
                                  err_msg="overflow (skipped step)")
    assert 0 < jtraj[:, 4].sum() < len(jtraj)       # skips and applies
    assert len(set(jtraj[:, 3])) > 1                # the scale moved
    np.testing.assert_allclose(ttraj[:, 0], jtraj[:, 0], rtol=2.0 ** -11,
                               err_msg="loss")
    applied = jtraj[:, 4] == 0
    np.testing.assert_allclose(ttraj[applied, 1], jtraj[applied, 1],
                               rtol=2.0 ** -9, err_msg="grad_norm")
    np.testing.assert_allclose(ttraj[:, 2], jtraj[:, 2], rtol=1e-6,
                               err_msg="lr")
    assert sorted(jp) == sorted(tp)
    for key in jp:
        if key not in NULL_GRAD_LEAVES:
            d = np.abs(tp[key] - jp[key])
            assert np.quantile(d, 0.99) <= 1e-4, key
