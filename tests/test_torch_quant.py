"""The port's weight and KV quantization (``deepspeed_tpu_torch.ops.quant``,
``inference.quantization``, ``inference.model._quantize_kv``) held against
the JAX package on the same numpy inputs.

Codes and scales must be BITWISE equal (one quantized checkpoint feeds
both packages): the inputs are fp32 and bf16 and hold values that land
exactly on a rounding half after the scale division (round half to even
on both sides).  Dequantization is one multiply per element in the same
dtype on both sides, so it is bitwise equal too."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference import quantization as jq
from deepspeed_tpu.inference.model import _quantize_kv as jax_quantize_kv
from deepspeed_tpu.ops import quant as jquant
from deepspeed_tpu.ops.quant import QuantizedTensor as JaxQT
from deepspeed_tpu_torch.inference import quantization as pq
from deepspeed_tpu_torch.inference.model import _quantize_kv
from deepspeed_tpu_torch.models import (build_model, params_from_numpy,
                                        quant_tree_from_numpy)
from deepspeed_tpu_torch.ops import quant as pquant
from tests.test_inference import tiny_model
from tests.test_torch_train import one_thread  # noqa: F401 (autouse)

DTYPES = {"fp32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _with_halves(shape, qmax, seed, axis_max=-1):
    """Seeded values in (-qmax, qmax) with one |qmax| per row (so the
    scale is exactly 1) and a few exact halves k + 0.5."""
    r = np.random.RandomState(seed)
    x = r.uniform(-qmax, qmax, shape).astype(np.float32)
    x = np.round(x * 4) / 4                  # bf16-exact quarter steps
    x = np.moveaxis(x, axis_max, -1)
    x[..., 0] = qmax
    x[..., 1] = -2.5
    x[..., 2] = 3.5
    x[..., 3] = 0.5
    return np.ascontiguousarray(np.moveaxis(x, -1, axis_max))


def _pair(x, dt):
    jdt, tdt = DTYPES[dt]
    xj = jnp.asarray(x).astype(jdt)
    xt = params_from_numpy({"x": np.asarray(xj)}, device="cpu")["x"]
    assert xt.dtype == tdt
    return xj, xt


def _bits_equal(a_torch, a_jax):
    a = a_torch.numpy() if a_torch.dtype not in (torch.bfloat16,
                                                 torch.float8_e4m3fn) \
        else a_torch.view(torch.uint16 if a_torch.element_size() == 2
                          else torch.uint8).numpy()
    b = np.asarray(a_jax)
    b = b.view(a.dtype) if b.dtype.itemsize == a.dtype.itemsize else b
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


def _same_qt(pt, jt):
    _bits_equal(pt.data, jt.data)
    _bits_equal(pt.scale, jt.scale)
    if jt.zero is None:
        assert pt.zero is None
    else:
        _bits_equal(pt.zero, jt.zero)
    assert (pt.bits, pt.shape, pt.layout) == (jt.bits, jt.shape, jt.layout)


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("shape, lead", [((48, 40), 1), ((3, 24, 40), 2),
                                         ((16, 4, 24), 1)])
def test_rowwise_int8_bitwise(dt, shape, lead):
    x = _with_halves(shape, 127.0, seed=len(shape) + lead)
    xj, xt = _pair(x, dt)
    _same_qt(pquant._quantize_leading(xt, lead),
             jquant._quantize_leading(xj, lead))
    if lead == 1:
        _same_qt(pquant.quantize_rowwise(xt), jquant.quantize_rowwise(xj))


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("shape, cd, lead", [
    ((64, 48), 1, 0), ((4, 16, 48), 2, 0), ((3, 32, 24), 1, 1),
    ((3, 4, 16, 48), 2, 1), ((2, 3, 32, 24), 1, 2)])
def test_rowwise_int4_bitwise_and_dequant(dt, shape, cd, lead):
    x = _with_halves(shape, 7.0, seed=sum(shape))
    xj, xt = _pair(x, dt)
    pt = pquant.quantize_rowwise4(xt, contract_dims=cd, lead_dims=lead)
    jt = jquant.quantize_rowwise4(xj, contract_dims=cd, lead_dims=lead)
    _same_qt(pt, jt)
    assert pquant.is_rowwise_int4(pt) and pquant.is_mixed_gemm_layout(pt)
    for out_dt in ("fp32", "bf16"):
        _bits_equal(pquant.dequantize(pt, DTYPES[out_dt][1]),
                    jquant.dequantize(jt, DTYPES[out_dt][0]))


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("symmetric", [True, False])
def test_grouped_bitwise_and_dequant(bits, symmetric, dt):
    x = _with_halves((32, 96), 127.0 if bits == 8 else 7.0, seed=bits)
    xj, xt = _pair(x, dt)
    pt = pquant.quantize(xt, bits=bits, num_groups=8, symmetric=symmetric)
    jt = jquant.quantize(xj, bits=bits, num_groups=8, symmetric=symmetric)
    _same_qt(pt, jt)
    _bits_equal(pquant.dequantize(pt), jquant.dequantize(jt))
    assert pquant.default_groups(x.size) == jquant.default_groups(x.size)
    lo, hi = pquant.unpack_nibbles(pt.data)
    jlo, jhi = jquant.unpack_nibbles(jt.data)
    _bits_equal(lo, jlo)
    _bits_equal(hi, jhi)


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_rowwise_int8_dequant_bitwise(dt):
    x = _with_halves((3, 24, 40), 127.0, seed=9)
    xj, xt = _pair(x * 0.013, dt)
    pt, jt = pquant._quantize_leading(xt, 2), jquant._quantize_leading(xj, 2)
    for out_dt in ("fp32", "bf16"):
        _bits_equal(pquant.dequantize(pt, DTYPES[out_dt][1]),
                    jquant.dequantize(jt, DTYPES[out_dt][0]))
    assert pquant.is_rowwise_int8(pt)


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("code", ["int8", "fp8"])
def test_quantize_kv_bitwise(dt, code):
    x = _with_halves((5, 2, 2, 16), 127.0, seed=3) * 0.37
    xj, xt = _pair(x, dt)
    qdt_j = {"int8": jnp.int8, "fp8": jnp.float8_e4m3fn}[code]
    qdt_t = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}[code]
    pc, ps = _quantize_kv(xt, qdt_t)
    jc, js = jax_quantize_kv(xj, qdt_j)
    assert pc.dtype == qdt_t
    _bits_equal(pc, jc)
    _bits_equal(ps, js)
    # zero vectors keep the 1e-8 floor
    zc, zs = _quantize_kv(torch.zeros(2, 8), qdt_t)
    assert float(zs.min()) == pytest.approx(1e-8) and not zc.float().any()


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("embed", [False, True])
def test_quantize_model_params_splits_like_jax(bits, embed):
    jm = tiny_model()
    params_np = jax.tree.map(np.asarray, jm.params)
    pparams = params_from_numpy(params_np, device="cpu")
    jd, jqt = jq.quantize_model_params(jm.params, bits=bits,
                                       quantize_embeddings=embed)
    pd, pqt = pq.quantize_model_params(pparams, bits=bits,
                                       quantize_embeddings=embed)

    def keys(tree, pre=""):
        if isinstance(tree, dict):
            return {k2 for k, v in tree.items()
                    for k2 in keys(v, f"{pre}/{k}")}
        return {pre}

    assert keys(pd) == keys(jd)
    assert ("/embed/table" in keys(pd)) is not embed
    jleaves = {}

    def walk(tree, pre=""):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from walk(v, f"{pre}/{k}")
        else:
            yield pre, tree

    for path, jt in walk(jqt):
        jleaves[path] = jt
    pleaves = dict(walk(pqt))
    assert pleaves.keys() == jleaves.keys()
    for path, pt in pleaves.items():
        _same_qt(pt, jleaves[path])
    # the input tree is left whole
    assert "wq" in pparams["blocks"]["attn"]
    # per-layer merge: dequantized and kernel-layout weights; a kernel
    # operand holds the same codes, one scale per contraction row (per
    # head scales of the attention wo expanded) and the same dense value
    for mixed in (False, True):
        plp = pq.merge_layer({}, pqt["blocks"], 1, torch.float32, mixed=mixed)
        jlp = jq.merge_layer({}, jqt["blocks"], 1, jnp.float32, mixed=mixed)
        for g in ("attn", "mlp"):
            for name, w in plp[g].items():
                if not mixed:
                    _bits_equal(w, jlp[g][name])
                    continue
                jt = jlp[g][name]
                _bits_equal(w.data, jt.data)
                assert (w.bits, w.shape, w.layout) == \
                    (jt.bits, jt.shape, jt.layout)
                K = int(np.prod(w.shape[:2 if name == "wo" and g == "attn"
                                       else 1]))
                assert w.scale.numel() == K
                _bits_equal(pquant.dequantize(w, torch.float32),
                            jquant.dequantize(jt, jnp.float32))
    # the operands are built once per stacked weight, not per step
    again = pq.merge_layer({}, pqt["blocks"], 1, torch.float32, mixed=True)
    assert all(again[g][n] is plp[g][n] for g in ("attn", "mlp")
               for n in plp[g])


def test_odd_contraction_falls_back_grouped():
    w = np.random.RandomState(3).randn(2, 7, 32).astype(np.float32)
    pt = pq._quantize_stacked(torch.from_numpy(w), bits=4)
    jt = jq._quantize_stacked(jnp.asarray(w), bits=4)
    assert pt.layout == "grouped" and not pquant.is_mixed_gemm_layout(pt)
    _same_qt(pt, jt)
    _bits_equal(pq.layer_weight(pt, 1, torch.float32),
                jq.layer_weight(jt, 1, jnp.float32))


def test_quant_tree_carries_over_bitwise():
    jm = tiny_model()
    _, jqt = jq.quantize_model_params(
        jax.tree.map(lambda x: x.astype(jnp.bfloat16), jm.params), bits=4,
        quantize_embeddings=True)
    tree_np = jax.tree.map(np.asarray, jqt)     # QuantizedTensor: a pytree
    assert isinstance(tree_np["blocks"]["attn"]["wo"], JaxQT)
    got = quant_tree_from_numpy(tree_np, device="cpu")
    qt = got["blocks"]["attn"]["wo"]
    assert isinstance(qt, pquant.QuantizedTensor) and qt.dtype == torch.bfloat16
    _same_qt(qt, jqt["blocks"]["attn"]["wo"])
    _same_qt(got["embed"]["table"], jqt["embed"]["table"])


def test_unported_layouts_raise():
    x = torch.randn(4, 8)
    with pytest.raises(NotImplementedError, match="stochastic"):
        pquant.quantize(x, stochastic=True)
    with pytest.raises(ValueError, match="even contraction"):
        pquant.quantize_rowwise4(torch.randn(7, 4))


@pytest.mark.parametrize("bits", [6, 12])
def test_minifloat_layouts_are_ported(bits):
    """The fp6/fp12 layouts (once raising here) quantize a model's blocks
    into the packed layout and dequantize through ``dequantize_any``
    within the format's step, bitwise the JAX package's payload."""
    m = build_model("llama-tiny", device="cpu", vocab_size=64, num_layers=1,
                    d_model=32, num_heads=2, num_kv_heads=2, d_ff=64)
    dense, quant = pq.quantize_model_params(m.params, bits=bits)
    w = m.params["blocks"]["mlp"]["wi"]
    qt = quant["blocks"]["mlp"]["wi"]
    assert qt.layout == f"rowwise{bits}" and qt.bits == bits
    assert qt.data.numel() == w.numel() * bits // 8
    got = pquant.dequantize_any(qt, torch.float32)
    # e3m2 keeps 2 mantissa bits (a step of 1/4 of the leading power of
    # two: at most 1/8 of it off), e4m7 keeps 7
    rel = 2.0 ** -(3 if bits == 6 else 8)
    amax = w.abs().amax(dim=tuple(range(2, w.dim())), keepdim=True)
    assert bool(((got - w).abs() <= rel * amax + 1e-7).all())
    want = jq._quantize_stacked(jnp.asarray(w.numpy()), bits)
    assert np.array_equal(qt.data.numpy(), np.asarray(want.data))
