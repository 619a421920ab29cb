"""The port's mixed-input GEMM (``deepspeed_tpu_torch.ops.mixed_gemm``)
held against the JAX package's Pallas kernels in interpret mode (as
tests/test_mixed_gemm.py runs them) on the same numpy inputs.

On the CPU the wrappers run their plain versions; the CUDA kernels are
held against those plain versions by tests/test_torch_kernels_cuda.py
(and by chip_smoke.py) on the card.

Tolerance: 1e-4 relative to the output's largest magnitude.  Both sides
round x and each dequantized weight to bf16 at the same place and
accumulate in fp32, so only the summation order differs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops import mixed_gemm as jmg
from deepspeed_tpu.ops import quant as jquant
from deepspeed_tpu_torch.models import params_from_numpy
from deepspeed_tpu_torch.ops import mixed_gemm as pmg
from deepspeed_tpu_torch.ops import quant as pquant
from tests.test_torch_train import one_thread  # noqa: F401 (autouse)

RTOL = 1e-4


def _t(a):
    return params_from_numpy({"a": np.asarray(a)}, device="cpu")["a"]


def _port_qt(jt):
    return pquant.QuantizedTensor(
        _t(jt.data), _t(jt.scale), None, jt.bits, jt.shape,
        torch.bfloat16 if jt.dtype == jnp.bfloat16 else torch.float32,
        layout=jt.layout)


def _x(M, K, seed):
    return jnp.asarray(np.random.RandomState(seed).randn(M, K),
                       jnp.bfloat16)


def _w(shape, seed):
    return jnp.asarray(np.random.RandomState(seed).randn(*shape),
                       jnp.bfloat16)


def _close(got, want):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    tol = RTOL * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


@pytest.mark.parametrize("M, K, N", [(1, 512, 512), (8, 1024, 512),
                                     (200, 512, 1024)])
def test_int8_plain_matches_jax_kernel(M, K, N):
    jt = jquant.quantize_rowwise(_w((K, N), 0))
    x = _x(M, K, 1)
    want = jmg.mixed_matmul_2d(x, jt.data, jt.scale, interpret=True,
                               out_dtype=jnp.float32)
    before = pmg.mixed_matmul_2d.launches
    got = pmg.mixed_matmul_2d(_t(x), _t(jt.data), _t(jt.scale),
                              out_dtype=torch.float32)
    assert got.dtype == torch.float32
    assert pmg.mixed_matmul_2d.launches == before     # CPU: no launch
    _close(got, want)
    # bf16 out (the serving dtype) rounds the same fp32 sums once
    got16 = pmg.mixed_matmul_2d(_t(x), _t(jt.data), _t(jt.scale))
    assert torch.equal(got16, got.to(torch.bfloat16))


@pytest.mark.parametrize("M, K, N", [(1, 512, 512), (8, 1024, 512),
                                     (200, 512, 1024)])
def test_int4_plain_matches_jax_kernel(M, K, N):
    jt = jquant.quantize_rowwise4(_w((K, N), 2))
    x = _x(M, K, 3)
    want = jmg.mixed4_matmul_2d(x, jt.data, jt.scale, interpret=True,
                                out_dtype=jnp.float32)
    before = pmg.mixed4_matmul_2d.launches
    got = pmg.mixed4_matmul_2d(_t(x), _t(jt.data), _t(jt.scale),
                               out_dtype=torch.float32)
    assert pmg.mixed4_matmul_2d.launches == before
    _close(got, want)


@pytest.mark.parametrize("bits", [8, 4])
def test_trailing_dims_collapse(bits):
    """qkv-style [K, H, Dh] weights consume the row-wise layouts as they
    are."""
    w = _w((256, 4, 64), 4)
    jt = (jquant.quantize_rowwise(w) if bits == 8
          else jquant.quantize_rowwise4(w))
    x = _x(16, 256, 5)
    want = jmg.mixed_matmul(x, jt, interpret=True, out_dtype=jnp.float32)
    got = pmg.mixed_matmul(_t(x), _port_qt(jt), out_dtype=torch.float32)
    assert got.shape == (16, 4, 64)
    _close(got, want)
    if bits == 8:
        ref = jmg.dequant_matmul_reference(x, jt)
        got_ref = pmg.dequant_matmul_reference(_t(x), _port_qt(jt))
        assert got_ref.dtype == torch.bfloat16
        np.testing.assert_allclose(got_ref.float().numpy(),
                                   np.asarray(ref, np.float32),
                                   atol=2e-2 * float(np.abs(ref).max()))


@pytest.mark.parametrize("bits", [8, 4])
def test_contract_two_dims_per_head_scales(bits):
    """The attention output projection [H, Dh, d] contracts (H, Dh) with
    one scale per head, expanded to rows."""
    w = _w((4, 32, 64), 6)
    jt = (jquant._quantize_leading(w, 1) if bits == 8
          else jquant.quantize_rowwise4(w, contract_dims=2))
    assert jt.scale.size == 4                   # per head
    x = _x(7, 128, 7)
    want = jmg.mixed_matmul(x, jt, contract_dims=2, interpret=True,
                            out_dtype=jnp.float32)
    got = pmg.mixed_matmul(_t(x), _port_qt(jt), contract_dims=2,
                           out_dtype=torch.float32)
    assert got.shape == (7, 64)
    _close(got, want)


def test_batched_leading_dims_and_fp32_x():
    jt = jquant.quantize_rowwise(_w((512, 256), 8))
    x = jnp.asarray(np.random.RandomState(9).randn(2, 5, 512), jnp.float32)
    want = jmg.mixed_matmul(x, jt, interpret=True)
    got = pmg.mixed_matmul(_t(x), _port_qt(jt))
    assert got.shape == (2, 5, 256) and got.dtype == torch.float32
    _close(got, want)


def test_rejects_non_rowwise():
    w = torch.randn(256, 256)
    qt = pquant.quantize(w, bits=8, num_groups=16, symmetric=False)
    with pytest.raises(ValueError, match="row-wise"):
        pmg.mixed_matmul(torch.ones(4, 256), qt)


def test_block_divisibility_guard():
    jt = jquant.quantize_rowwise(_w((768, 512), 0))   # 768 % 512 != 0
    with pytest.raises(ValueError, match="divide"):
        pmg.mixed_matmul_2d(torch.ones(4, 768), _t(jt.data), _t(jt.scale))
    jt4 = jquant.quantize_rowwise4(_w((1536, 512), 0))  # K/2 = 768
    with pytest.raises(ValueError, match="divide"):
        pmg.mixed4_matmul_2d(torch.ones(4, 1536), _t(jt4.data),
                             _t(jt4.scale))


@pytest.mark.parametrize("bits, K, N, why", [
    (8, 48, 64, "multiple of 32"), (4, 96, 64, "multiple of 64"),
    (8, 64, 24, "multiple of 16"), (8, 11008, 64, "divide"),
    (8, 64, 11008, "divide")])
def test_kernel_shape_guard_on_every_device(bits, K, N, why):
    """What the CUDA kernel does not take is refused on the CPU too, so a
    CPU run resolves the same shapes to the same path as the card."""
    assert why in pmg.shape_error(K, N, int4=bits == 4)
    w = torch.randn(K, N)
    qt = (pquant.quantize_rowwise(w) if bits == 8
          else pquant.quantize_rowwise4(w))
    with pytest.raises(ValueError, match=why):
        pmg.mixed_matmul(torch.ones(2, K), qt)
    assert pmg.shape_error(4096, 14336, int4=bits == 4) is None


def test_wrong_contraction_split_rejected():
    w = torch.randn(4, 16, 48)
    qt = pquant.quantize_rowwise4(w, contract_dims=2)   # K = 64
    with pytest.raises(ValueError, match="contract"):
        pmg.mixed_matmul(torch.ones(2, 4), qt, contract_dims=1)


def test_other_devices_raise_never_fall_back():
    jt = jquant.quantize_rowwise(_w((64, 64), 0))
    with pytest.raises(ValueError, match="unsupported device"):
        pmg.mixed_matmul_2d(torch.ones(4, 64, device="meta"),
                            _t(jt.data).to("meta"), _t(jt.scale).to("meta"))
